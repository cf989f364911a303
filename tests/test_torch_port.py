"""The PyTorch port held against the JAX package, on the CPU.

Every input is made from a numpy seed and handed to the JAX function and to
its counterpart in ``gpar_at_scale_torch``; data crosses between the two as
numpy arrays.  Tolerances:

* float64 comparisons of the same algebra: rtol 1e-10 (kernels, LGSSMs) or
  1e-9/1e-8 where a recursion over hundreds of steps accumulates rounding
  in another order (filters, smoothers, the DTC algebra).
* the kernels' plain versions against the JAX package's kernel wrappers run
  with ``interpret=True``: float32 with the JAX kernel tests' own tolerances
  (alpha atol 2e-5, ll rtol 2e-5, logdet rtol 1e-6).  The two split the
  series into different numbers of blocks, so the float32 rounding differs.
  The JAX wrappers ``pallas_decorrelate`` and ``pallas_smooth`` are jitted
  with the LGSSM as an argument; their ``pallas_supported`` check then sees
  a traced H and they take the associative-scan engine, which computes the
  same function.  Their Pallas kernels run only when called unjitted
  (``__wrapped__``), as the smoother test does; the suffix scan and the
  column sweep (``pallas_suffix_scan``, ``pallas_whiten_columns``'s sweep)
  always run theirs.
* the whole slice in float32 against the JAX chain: stated in that test.
* gradients (the training slice): stated in each test, with the gap
  measured on a CPU beside it.

On the CPU every kernel wrapper takes its plain version; the CUDA kernels
themselves are checked against the same plain versions by ``chip_smoke.py``
on the card.
"""

import functools
import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpar_at_scale_tpu.kernels as jk
import gpar_at_scale_torch.kernels as tk
from gpar_at_scale_tpu.gp import dtc as jdtc
from gpar_at_scale_tpu.ops.pallas_kalman import pallas_decorrelate
from gpar_at_scale_tpu.ops.pallas_whiten import pallas_whiten_columns
from gpar_at_scale_tpu.ssm import blocked as jblocked
from gpar_at_scale_tpu.ssm import kalman as jkalman
from gpar_at_scale_tpu.ssm import markov as jmarkov
from gpar_at_scale_tpu.ssm import segmented as jseg
from gpar_at_scale_tpu.utils import params as jparams
from gpar_at_scale_tpu.utils import psd as jpsd
from gpar_at_scale_torch import device as tdevice
from gpar_at_scale_torch.data.chain import make_chain_data
from gpar_at_scale_torch.gp import dtc as tdtc
from gpar_at_scale_torch.ops import KERNELS, grad as tops_grad, kalman as tops_kalman
from gpar_at_scale_torch.ops import smoother as tops_smoother, whiten as tops_whiten
from gpar_at_scale_torch.ssm import blocked as tblocked
from gpar_at_scale_torch.ssm import blocked_grad as tblocked_grad
from gpar_at_scale_torch.ssm import kalman as tkalman
from gpar_at_scale_torch.ssm import markov as tmarkov
from gpar_at_scale_torch.ssm import segmented as tseg
from gpar_at_scale_torch.utils import convert, params as tparams, psd as tpsd

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


def _grid(rng, n, span=5.0):
    return np.sort(rng.uniform(0.0, span, n))


def _family(name):
    return getattr(jk, name), getattr(tk, name)


# JAX references computed away from this worker.  The xdist worker that runs
# this file computes the port's side; the heaviest JAX sides run in spawned
# processes started at the file's first case (``_jax_refs_started``), which
# import this file again (``tests/_jax_example_refs.py::test_refs``) and call
# the ``_jref_*`` functions below, whose results are numpy.  A case asks for
# one through ``_jax_ref``, which computes it here when it was not started
# (a case run alone).  Groups: one process each; users: the cases that read
# each reference.
_REF_GROUPS = (
    (("_jax_eeg_chain", ("scaled",)), ("_jref_seg_refs", ()), ("_jref_mixed_refs", ()),
     ("_jref_sample_refs", ())),
    (("_jax_eeg_chain", ("exact",)), ("_jref_carry_case", ()), ("_jref_seg_grad_refs", ()),
     ("_jref_sum_kernel_refs", ())),
    (("_jref_slice", ()), ("_jref_adam_trace", ()), ("_jref_kernel_path_training", ()),
     ("_jref_lbfgs_optimum", ()), ("_jref_dense_dtc_branch", ())),
)
_REF_USERS = {
    "_jax_eeg_chain": ("test_eeg_chain_",), "_jref_seg_refs": ("test_segmented_engine_",),
    "_jref_mixed_refs": ("test_mixed_backward_",),
    "_jref_sample_refs": ("test_segmented_posterior_sample_",),
    "_jref_carry_case": ("test_carry_hooks_",),
    "_jref_seg_grad_refs": ("test_segmented_gradients_",),
    "_jref_sum_kernel_refs": ("test_segmented_sum_kernel_",),
    "_jref_kernel_path_training": ("test_kernel_path_training_",),
    "_jref_adam_trace": ("test_adam_trace_",), "_jref_slice": ("test_slice_matches_",),
    "_jref_lbfgs_optimum": ("test_lbfgs_optimum_",),
    "_jref_dense_dtc_branch": ("test_dense_dtc_branch_",),
}
_JAX_REFS = {}


def _jax_ref(fn, *args):
    """fn(*args): the result of the spawned process that computed it, if one
    was started, else computed here."""
    pending = _JAX_REFS.get((fn.__name__, args))
    return pending.get(timeout=900) if pending is not None else fn(*args)


@pytest.fixture(scope="module", autouse=True)
def _jax_refs_started(request):
    """Start the ``_REF_GROUPS`` jobs that a collected case reads, one
    process per group, at this file's first case."""
    names = [item.name for item in request.session.items]
    groups = [tuple(job for job in group
                    if any(n.startswith(u) for u in _REF_USERS[job[0]] for n in names))
              for group in _REF_GROUPS]
    groups = [g for g in groups if g]
    if not groups:
        yield
        return
    import multiprocessing

    from _jax_example_refs import test_refs

    pool = multiprocessing.get_context("spawn").Pool(len(groups))
    try:
        for group in groups:
            pending = pool.apply_async(test_refs, (group,))
            for job in group:
                _JAX_REFS[job] = _Pick(pending, job)
        yield
    finally:
        _JAX_REFS.clear()
        pool.terminate()
        pool.join()


class _Pick:
    """One job's result out of its group's pending result."""

    def __init__(self, pending, job):
        self.pending, self.job = pending, job

    def get(self, timeout):
        return self.pending.get(timeout=timeout)[self.job]


# ---------------------------------------------------------------------------
# utils/params.py, utils/psd.py
# ---------------------------------------------------------------------------


def test_params_and_psd_match_jax(rng):
    p5 = rng.normal(size=5)
    for junpack, tunpack in [(jparams.unpack_gp, tparams.unpack_gp),
                             (jparams.unpack_gpar, tparams.unpack_gpar)]:
        n = 3 if junpack is jparams.unpack_gp else 5
        for a, b in zip(junpack(jnp.asarray(p5[:n])), tunpack(_t(p5[:n]))):
            _close(b, a)
    p6 = rng.normal(size=6)
    _close(torch.stack(tparams.unpack_gpar6(_t(p6))), jnp.stack(jparams.unpack_gpar6(jnp.asarray(p6))))
    vals = (0.5, 1.0, 1.1, 0.7, 0.2, 0.3)
    _close(tparams.pack_gp(*map(_t, vals[:3])), jparams.pack_gp(*vals[:3]))
    _close(tparams.pack_gpar(*map(_t, vals[:5])), jparams.pack_gpar(*vals[:5]))
    _close(tparams.pack_gpar6(*map(_t, vals)), jparams.pack_gpar6(*vals))
    with pytest.raises(ValueError):
        tparams.unconstrain(_t(1e-3))

    X = rng.normal(size=(6, 6))
    K = X @ X.T + 0.1 * np.eye(6)
    b = rng.normal(size=(6, 2))
    L = tpsd.cholesky_psd(_t(K))
    Lj = jpsd.cholesky_psd(jnp.asarray(K))
    _close(L, Lj)
    _close(tpsd.add_jitter(_t(K)), jpsd.add_jitter(jnp.asarray(K)))
    _close(tpsd.solve_lower(L, _t(b)), jpsd.solve_lower(Lj, jnp.asarray(b)))
    _close(tpsd.solve_upper(L, _t(b[:, 0])), jpsd.solve_upper(Lj, jnp.asarray(b[:, 0])))
    _close(tpsd.cho_solve(L, _t(b)), jpsd.cho_solve(Lj, jnp.asarray(b)))
    _close(tpsd.logdet_from_chol(L), jpsd.logdet_from_chol(Lj))


# ---------------------------------------------------------------------------
# kernels/
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["EQ", "Matern12", "Matern32", "Matern52", "RQ"])
def test_stationary_kernels_match_jax(name, rng):
    jf, tf = _family(name)
    x, z = rng.normal(size=(9, 2)), rng.normal(size=(7, 2))
    kw = dict(lengthscale=0.8, variance=1.7)
    if name == "RQ":
        kw["alpha"] = 2.5
    kj, kt = jf(**kw), tf(**{k: _t(v) for k, v in kw.items()})
    _close(kt(_t(x), _t(z)), kj(jnp.asarray(x), jnp.asarray(z)))
    _close(kt(_t(x)), kj(jnp.asarray(x)))
    _close(kt.diag_part(_t(x)), kj.diag_part(jnp.asarray(x)))


def test_kernel_combinators_match_jax(rng):
    x, z = rng.normal(size=(8, 3)), rng.normal(size=(5, 3))
    Amap = rng.normal(size=(2, 3))
    a = (jk.Matern32(lengthscale=0.9, variance=1.2), tk.Matern32(lengthscale=_t(0.9), variance=_t(1.2)))
    b = (jk.EQ(lengthscale=1.4, variance=0.6), tk.EQ(lengthscale=_t(1.4), variance=_t(0.6)))
    pairs = [
        (a[0] + b[0], a[1] + b[1]),
        (a[0] * b[0], a[1] * b[1]),
        (a[0] * 2.5, a[1] * 2.5),
        (a[0].select((0, 2)), a[1].select((0, 2))),
        (jk.LinearMapKernel(base=b[0], A=jnp.asarray(Amap)), tk.LinearMapKernel(b[1], _t(Amap))),
        (jk.gpar_kernel(jk.Matern52, jk.EQ, 3, 0.7, 1.1, 1.3, 0.9),
         tk.gpar_kernel(tk.Matern52, tk.EQ, 3, *map(_t, (0.7, 1.1, 1.3, 0.9)))),
        (jk.time_kernel_only(jk.Matern12, 0.4, 1.5), tk.time_kernel_only(tk.Matern12, _t(0.4), _t(1.5))),
    ]
    for kj, kt in pairs:
        _close(kt(_t(x), _t(z)), kj(jnp.asarray(x), jnp.asarray(z)))
        _close(kt.diag_part(_t(x)), kj.diag_part(jnp.asarray(x)))
    _close(tk.sq_dist(_t(x), _t(z)), jk.sq_dist(jnp.asarray(x), jnp.asarray(z)))
    with pytest.raises(ValueError):
        tk.gpar_kernel(tk.Matern52, tk.EQ, 1, 1.0, 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# ssm/markov.py, ssm/kalman.py, ssm/blocked.py
# ---------------------------------------------------------------------------


def _kernel_pair(name, l=0.7, s=1.3):
    if name == "Matern12+Matern32":
        return (jk.Matern12(lengthscale=l, variance=s) + jk.Matern32(lengthscale=2 * l, variance=0.5),
                tk.Matern12(lengthscale=_t(l), variance=_t(s)) + tk.Matern32(lengthscale=_t(2 * l), variance=_t(0.5)))
    jf, tf = _family(name)
    return jf(lengthscale=l, variance=s), tf(lengthscale=_t(l), variance=_t(s))


@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52", "Matern12+Matern32"])
def test_lgssm_of_matches_jax(name, rng):
    t = _grid(rng, 30)
    R = rng.uniform(0.05, 0.3, 30)
    R[[4, 17]] = 1e10  # the test-point splice
    kj, kt = _kernel_pair(name)
    lj = jmarkov.lgssm_of(kj, jnp.asarray(t), jnp.asarray(R), jnp.float64)
    lt = tmarkov.lgssm_of(kt, _t(t), _t(R), F64)
    for a, b in [(lt.A, lj.A), (lt.Q, lj.Q), (lt.H, lj.H), (lt.R, lj.R)]:
        _close(a, b, atol=1e-14)
    # H = e1 recorded on the host: the same answer as reading H back, and
    # as the JAX package's kernel-path check
    from gpar_at_scale_tpu.ops.pallas_kalman import pallas_supported as j_supported

    unrecorded = tmarkov.LGSSM(A=lt.A, Q=lt.Q, H=lt.H, R=lt.R)
    assert lt.e1 == tops_kalman.pallas_supported(unrecorded) == j_supported(lj) == ("+" not in name)
    # discretize on a scalar noise, from the SDE
    ld = tmarkov.discretize(tmarkov.to_sde(kt, F64), _t(t), 0.1)
    _close(ld.R, np.full(30, 0.1))
    with pytest.raises(ValueError, match="sorted"):
        tmarkov.discretize(tmarkov.to_sde(kt, F64), _t(t[::-1].copy()), 0.1)
    with pytest.raises(TypeError):
        tmarkov.to_sde(tk.EQ(lengthscale=_t(1.0), variance=_t(1.0)))


@pytest.mark.parametrize("name", ["Matern12", "Matern52"])
def test_kalman_filter_and_rts_smooth_match_jax(name, rng):
    n = 60
    t, Y = _grid(rng, n), rng.normal(size=(n, 2))
    kj, kt = _kernel_pair(name)
    lj = jmarkov.lgssm_of(kj, jnp.asarray(t), 0.1, jnp.float64)
    lt = tmarkov.lgssm_of(kt, _t(t), 0.1, F64)
    fj, ft = jkalman.kalman_filter(lj, jnp.asarray(Y)), tkalman.kalman_filter(lt, _t(Y))
    for a, b in zip(ft, fj):
        _close(a, b, rtol=1e-9, atol=1e-12)
    _close(tkalman.logpdf(lt, _t(Y[:, 0])), jkalman.logpdf(lj, jnp.asarray(Y[:, 0])), rtol=1e-10)
    for a, b in zip(tkalman.decorrelate(lt, _t(Y)), jkalman.decorrelate(lj, jnp.asarray(Y))):
        _close(a, b, rtol=1e-9, atol=1e-12)
    sj, st = jkalman.rts_smooth(lj, jnp.asarray(Y)), tkalman.rts_smooth(lt, _t(Y))
    for a, b in zip(st, sj):
        _close(a, b, rtol=1e-9, atol=1e-12)


def test_filtering_elements_match_jax(rng):
    """The element algebra that the blocked engine and the kernels' plain
    versions fold: per-step elements, the solve-based combine and its
    adjugate twin."""
    from gpar_at_scale_tpu.ssm import pkalman as jp
    from gpar_at_scale_torch.ssm import pkalman as tp

    t, Y = _grid(rng, 12), rng.normal(size=(12, 2))
    kj, kt = _kernel_pair("Matern52")
    ej = jp._filter_elements(jmarkov.lgssm_of(kj, jnp.asarray(t), 0.1, jnp.float64), jnp.asarray(Y))
    et = tp._filter_elements(tmarkov.lgssm_of(kt, _t(t), 0.1, F64), _t(Y))
    for a, b in zip(et, ej):
        _close(a, b, rtol=1e-10, atol=1e-14)
    half = lambda e, sl: tuple(x[sl] for x in e)  # noqa: E731
    cj = jp._combine(half(ej, slice(0, 6)), half(ej, slice(6, 12)))
    for comb in (tp._combine, tblocked._combine_fast):
        for a, b in zip(comb(half(et, slice(0, 6)), half(et, slice(6, 12))), cj):
            _close(a, b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("num_blocks", [None, 7])
def test_blocked_smooth_matches_jax(num_blocks, rng):
    """A ragged block split (173 steps), three columns and two spliced test
    points; the port's block count differs from the JAX default (1024)."""
    n = 173
    t, Y = _grid(rng, n, 8.0), rng.normal(size=(n, 3))
    R = np.full(n, 0.08)
    R[[10, 99]] = 1e10
    kj, kt = _kernel_pair("Matern52", l=0.9)
    lj = jmarkov.lgssm_of(kj, jnp.asarray(t), jnp.asarray(R), jnp.float64)
    lt = tmarkov.lgssm_of(kt, _t(t), _t(R), F64)
    sj = jblocked.blocked_smooth(lj, jnp.asarray(Y))
    st = tblocked.blocked_smooth(lt, _t(Y), num_blocks=num_blocks)
    for a, b in zip(st, sj):
        _close(a, b, rtol=1e-8, atol=1e-10)
    fr = tblocked.blocked_filter(lt, _t(Y), num_blocks=num_blocks)
    for a, b in zip(fr, jkalman.kalman_filter(lj, jnp.asarray(Y))):
        _close(a, b, rtol=1e-8, atol=1e-10)


@jax.jit
def _jax_engines(lj, Yj):
    from gpar_at_scale_tpu.ssm import pkalman as jp

    return (jp.parallel_filter(lj, Yj), jp.parallel_smooth(lj, Yj), jp.parallel_logpdf(lj, Yj[:, 0]),
            jp.parallel_decorrelate(lj, Yj[:, 1]), jkalman.log_det_cov(lj),
            jblocked.blocked_logpdf(lj, Yj), jblocked.blocked_decorrelate(lj, Yj[:, 2]))


@pytest.mark.parametrize("name", ["Matern52", "Matern12+Matern32"])
def test_associative_engines_match_jax(name, rng):
    """The associative-scan filter and smoother (ssm/pkalman.py) against the
    JAX package's at n = 200, float64, three columns: a single Matern block
    (d = 3) and a sum SDE (d = 3, H = [1, 1, 0]).  Measured at most 3e-14 of
    each output's scale, held to rtol 1e-9; the same against the port's
    sequential engine.  log_det_cov, blocked_logpdf and blocked_decorrelate
    beside them."""
    from gpar_at_scale_torch.ssm import pkalman as tp

    n = 200
    t, Y = _grid(rng, n), rng.normal(size=(n, 3))
    kj, kt = _kernel_pair(name)
    lj = jmarkov.lgssm_of(kj, jnp.asarray(t), 0.1, jnp.float64)
    lt = tmarkov.lgssm_of(kt, _t(t), 0.1, F64)
    Yj, Yt = jnp.asarray(Y), _t(Y)
    tol = dict(rtol=1e-9, atol=1e-12)
    fj, sj, llj, decj, ldj, bllj, bdecj = _jax_engines(lj, Yj)  # one JAX compile
    ft, st = tp.parallel_filter(lt, Yt), tp.parallel_smooth(lt, Yt)
    for a, b in zip(ft, fj):
        _close(a, b, **tol)
    for a, b in zip(st, sj):
        _close(a, b, **tol)
    for a, b in zip(st, tkalman.rts_smooth(lt, Yt)):
        _close(a, b, **tol)
    _close(tp.parallel_logpdf(lt, Yt[:, 0]), llj, rtol=1e-10)
    for a, b in zip(tp.parallel_decorrelate(lt, Yt[:, 1]), decj):
        _close(a, b, **tol)
    _close(tkalman.log_det_cov(lt), ldj, rtol=1e-10)
    _close(tblocked.blocked_logpdf(lt, Yt), bllj, rtol=1e-9)
    for a, b in zip(tblocked.blocked_decorrelate(lt, Yt[:, 2], num_blocks=7), bdecj):
        _close(a, b, **tol)


# ---------------------------------------------------------------------------
# gp/dtc.py, dense branch
# ---------------------------------------------------------------------------


def _dtc_problem(rng, n=120, m=9):
    t = _grid(rng, n, 6.0)
    V = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.3 * V[:, 0] + 0.1 * rng.normal(size=n)
    Z = V[:: n // m][:m]
    kw_out, kw_time = (1.1, 0.9), (0.8, 1.3)
    jo, to = jk.Matern52(lengthscale=kw_out[0], variance=kw_out[1]), tk.Matern52(lengthscale=_t(kw_out[0]), variance=_t(kw_out[1]))
    jt, tt = jk.Matern52(lengthscale=kw_time[0], variance=kw_time[1]), tk.Matern52(lengthscale=_t(kw_time[0]), variance=_t(kw_time[1]))
    lj = jmarkov.lgssm_of(jt, jnp.asarray(t), 0.04, jnp.float64)
    lt = tmarkov.lgssm_of(tt, _t(t), 0.04, F64)
    return t, V, y, Z, (jo, jt, lj), (to, tt, lt)


def test_dense_dtc_matches_jax(rng):
    t, V, y, Z, (jo, jt, lj), (to, tt, lt) = _dtc_problem(rng)
    batch = rng.normal(size=(len(t), 4))
    wj, ldj = jdtc.dense_whiten(jt, jnp.asarray(t), 0.04, jnp.asarray(batch))
    wt, ldt = tdtc.dense_whiten(tt, _t(t), _t(0.04), _t(batch))
    _close(wt, wj, rtol=1e-9, atol=1e-12)
    _close(ldt, ldj, rtol=1e-10)
    args_j = (jo, lj, jnp.asarray(V), jnp.asarray(Z), jnp.asarray(y))
    args_t = (to, lt, _t(V), _t(Z), _t(y))
    ctx_j, ctx_t = dict(time_kernel=jt, t=jnp.asarray(t)), dict(time_kernel=tt, t=_t(t))
    _close(tdtc.dtc_objective(*args_t, mean=0.2, **ctx_t),
           jdtc.dtc_objective(*args_j, mean=0.2, **ctx_j), rtol=1e-9)
    # the sequential engine gives the same bound
    _close(tdtc.dtc_objective(*args_t, mean=0.2, filter_fn=tkalman.kalman_filter),
           jdtc.dtc_objective(*args_j, mean=0.2, **ctx_j), rtol=1e-9)
    qj = jdtc.compute_q_u(*args_j, **ctx_j)
    qt = tdtc.compute_q_u(*args_t, **ctx_t)
    for a, b in zip(qt, qj):
        _close(a, b, rtol=1e-8, atol=1e-10)

    t_star = np.sort(rng.uniform(0, 6, 15))
    V_star = rng.normal(size=(15, 2))
    pj = jdtc.predict_scaled(jo, jt, qj, jnp.asarray(V), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(t_star), jnp.asarray(V_star), 0.04, mean=0.2)
    pt = tdtc.predict_scaled(to, tt, qt, _t(V), _t(t), _t(y), _t(t_star), _t(V_star),
                             _t(0.04), mean=0.2)
    for a, b in zip(pt, pj):
        _close(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("branch", ["solves", "inverse-factors"])
def test_monte_carlo_predictive_matches_jax(branch, rng, monkeypatch):
    """predict_scaled(num_samples=S): the JAX package's draw of eps
    (``QU.sample_eps`` from its key) fed to the port's body
    (``_predict_scaled``), against the JAX predictive with the same key,
    float64, N = 120, N* = 15, S = 16.  On the dense branch (triangular
    solves, dense smoother) and, with the port's DENSE_N_MAX cut to 64, on
    its blocked smoother, where it multiplies by inverse factors (the JAX
    package stays dense: the same function).  Held to rtol 1e-9; measured
    4.3e-14 (solves) and 5.2e-13 (inverse factors) of each output's
    scale."""
    t, V, y, Z, (jo, jt, lj), (to, tt, lt) = _dtc_problem(rng)
    if branch == "inverse-factors":
        monkeypatch.setattr(tdtc, "DENSE_N_MAX", 64)
    ctx_j, ctx_t = dict(time_kernel=jt, t=jnp.asarray(t)), dict(time_kernel=tt, t=_t(t))
    qj = jdtc.compute_q_u(jo, lj, jnp.asarray(V), jnp.asarray(Z), jnp.asarray(y), **ctx_j)
    qt = tdtc.compute_q_u(to, lt, _t(V), _t(Z), _t(y), **ctx_t)
    t_star, V_star = np.sort(rng.uniform(0, 6, 15)), rng.normal(size=(15, 2))
    key, S = jax.random.PRNGKey(3), 16
    pj = jdtc.predict_scaled(jo, jt, qj, jnp.asarray(V), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(t_star), jnp.asarray(V_star), 0.04, mean=0.2, key=key,
                             num_samples=S)
    pt = tdtc._predict_scaled(to, tt, qt, _t(V), _t(t), _t(y), _t(t_star), _t(V_star), _t(0.04),
                              mean=0.2, eps=_t(qj.sample_eps(key, S)))
    for a, b in zip(pt, pj):
        _close(a, b, rtol=1e-9, atol=1e-12)


def test_sample_eps_draws_q_u(rng):
    """QU.sample_eps from a torch.Generator: 40000 draws of the M = 9
    pseudo-point weights have the mean m_eps and the covariance D^-1 of
    q(eps) within 5 standard errors, entry by entry; the same seed gives
    the same draws."""
    t, V, y, Z, _, (to, tt, lt) = _dtc_problem(rng)
    qt = tdtc.compute_q_u(to, lt, _t(V), _t(Z), _t(y), time_kernel=tt, t=_t(t))
    S = 40000
    eps = qt.sample_eps(torch.Generator().manual_seed(0), S)
    assert eps.shape == (9, S) and eps.dtype == F64
    again = (qt.sample_eps(torch.Generator().manual_seed(1), 5) for _ in range(2))
    _close(next(again), _np(next(again)), rtol=0, atol=0)
    cov = torch.cholesky_inverse(qt.L_D)  # D^-1
    sd = torch.sqrt(torch.diagonal(cov))
    assert bool(((eps.mean(1) - qt.m_eps).abs() <= 5 * sd / math.sqrt(S)).all())
    se = torch.sqrt((torch.outer(sd**2, sd**2) + cov**2) / S)
    assert bool(((torch.cov(eps) - cov).abs() <= 5 * se).all())


@pytest.mark.parametrize("dtype,mode", [("float64", "off"), ("float32", "interpret")])
def test_sparse_iid_matches_jax(dtype, mode, rng, monkeypatch):
    """The iid-noise sparse GP (dtc_objective_iid, titsias_elbo,
    predict_sparse_iid), N = 40, M = 8, 2-D inputs, 12 test points: float64
    through torch.linalg (rtol 1e-10, the same algebra) and float32 through
    the plain versions of K6a-c against the JAX interpret kernels
    (``GPAR_PALLAS_DENSE_INTERPRET=1``): the predictions at rtol 2e-5,
    atol 2e-5 as in ``test_exact_gp_matches_jax`` (measured 8.1e-7 of their
    scale), the two bounds, which cancel terms as large as
    |y - m|^2 / s2 (about 400), to 2e-5 of that (measured 1.2e-4 absolute,
    1.5% of it).  float64: measured 4.9e-15."""
    from gpar_at_scale_torch.ops import dense as tdense

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    calls = []
    if mode == "interpret":
        monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
        plain = tdense.chol_solve_plain
        monkeypatch.setattr(tdense, "chol_solve_plain", lambda S, B: calls.append(S.shape) or plain(S, B))
    jdt, tdt = (jnp.float64, F64) if dtype == "float64" else (jnp.float32, F32)
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == "float64" else dict(rtol=2e-5, atol=2e-5)
    n = 40
    V, Vs = rng.uniform(0, 3, size=(n, 2)), rng.uniform(0, 3, size=(12, 2))
    y = np.sin(V[:, 0]) + 0.5 * np.cos(V[:, 1]) + 0.1 * rng.normal(size=n)
    Z = V[::5]
    kj = jk.Matern52(lengthscale=0.9, variance=1.2)
    kt = tk.Matern52(lengthscale=_t(0.9, tdt), variance=_t(1.2, tdt))
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: _t(a, tdt)  # noqa: E731
    scale = float(np.sum((y - 0.1) ** 2) / 0.05)
    bound_tol = tol if dtype == "float64" else dict(rtol=0, atol=2e-5 * scale)
    for fj, ft in ((jdtc.dtc_objective_iid, tdtc.dtc_objective_iid),
                   (jdtc.titsias_elbo, tdtc.titsias_elbo)):
        _close(ft(kt, T(V), T(Z), T(y), 0.05, mean=0.1), fj(kj, J(V), J(Z), J(y), 0.05, mean=0.1),
               **bound_tol)
    got = tdtc.predict_sparse_iid(kt, T(V), T(Z), T(y), 0.05, T(Vs), mean=0.1)
    for a, b in zip(got, jdtc.predict_sparse_iid(kj, J(V), J(Z), J(y), 0.05, J(Vs), mean=0.1)):
        assert a.dtype == tdt
        _close(a, b, **tol)
    assert calls == ([(8, 8)] * 4 if mode == "interpret" else [])  # cholesky_psd(K_uu) per call


def test_predict_from_jax_weights(rng):
    """q(u) carried across with ``qu_from_numpy`` predicts as the JAX
    package does with its own q(u)."""
    t, V, y, Z, (jo, jt, lj), (to, tt, lt) = _dtc_problem(rng, n=90, m=6)
    qj = jdtc.compute_q_u(jo, lj, jnp.asarray(V), jnp.asarray(Z), jnp.asarray(y),
                          time_kernel=jt, t=jnp.asarray(t))
    qt = convert.qu_from_numpy(*(np.asarray(f) for f in qj), device=CPU)
    assert all(f.dtype == F64 and f.device.type == "cpu" for f in qt)
    t_star, V_star = np.sort(rng.uniform(0, 6, 11)), rng.normal(size=(11, 2))
    pj = jdtc.predict_scaled(jo, jt, qj, jnp.asarray(V), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(t_star), jnp.asarray(V_star), 0.04)
    pt = tdtc.predict_scaled(to, tt, qt, _t(V), _t(t), _t(y), _t(t_star), _t(V_star), _t(0.04))
    for a, b in zip(pt, pj):
        _close(a, b, rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError):
        convert.qu_from_numpy(np.zeros(3), np.eye(2), np.eye(3), np.zeros((3, 1)), device=CPU)
    with pytest.raises(TypeError):
        convert.qu_from_numpy(list(range(3)), np.eye(3), np.eye(3), np.zeros((3, 1)), device=CPU)


def test_params_from_numpy(rng):
    raw = [np.asarray(jparams.pack_gp(0.5, 1.0, 0.2)),
           np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2)),
           np.asarray(jparams.pack_gpar6(0.5, 1.0, 1.0, 0.7, 0.2, 0.3))]
    got = convert.params_from_numpy(raw, device=CPU, dtype=torch.float32)
    assert [tuple(p.shape) for p in got] == [(3,), (5,), (6,)]
    assert all(p.dtype == torch.float32 for p in got)
    _close(torch.stack(tparams.unpack_gp(got[0].double())), [0.5, 1.0, 0.2], rtol=1e-6)
    _close(torch.stack(tparams.unpack_gpar6(got[2].double())), [0.5, 1.0, 1.0, 0.7, 0.2, 0.3], rtol=1e-6)
    with pytest.raises(ValueError):
        convert.params_from_numpy([np.zeros(5)], device=CPU)


# ---------------------------------------------------------------------------
# ops/: the kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _f32_lgssm(rng, name, n, noise=0.1):
    """One float32 LGSSM for both packages: the kernels get bit-identical
    inputs (``lgssm_of`` itself is held to the JAX one above)."""
    t = np.cumsum(rng.uniform(0.1, 1.0, n)) / 50.0
    kj, _ = _kernel_pair(name, l=1.0, s=1.0)
    lj = jmarkov.lgssm_of(kj, jnp.asarray(t, jnp.float32), noise, jnp.float32)
    f32 = torch.float32
    lt = tmarkov.LGSSM(A=_t(lj.A, f32), Q=_t(lj.Q, f32), H=_t(lj.H, f32), R=_t(lj.R, f32))
    return lj, lt


@pytest.mark.parametrize("name,n,num_blocks", [
    ("Matern12", 2500, None),  # d = 1; 156 blocks of 17 steps, the last ragged
    ("Matern52", 2100, None),  # d = 3
    ("Matern52", 37, 5),  # d = 3; far fewer steps than blocks x steps
    ("Matern32", 100, 16),  # d = 2; 16 blocks of 7 steps: block 14 ragged, block 15 padding only
])
def test_decorrelate_blocked_matches_pallas(name, n, num_blocks, rng):
    lj, lt = _f32_lgssm(rng, name, n)
    y = rng.normal(size=n)
    out_j = pallas_decorrelate(lj, jnp.asarray(y, jnp.float32), interpret=True, return_full=True)
    out_t = tops_kalman.decorrelate_blocked(lt, _t(y, torch.float32), num_blocks=num_blocks,
                                            return_full=True)
    ll, alpha, logdet, S, K, m, P = out_t
    _close(ll, out_j[0], rtol=2e-5)
    _close(alpha, out_j[1], atol=2e-5)
    _close(logdet, out_j[2], rtol=1e-6)
    # per-step moments: float32 recursions, held to 1e-4 of each quantity's
    # scale (the state's higher derivatives are O(lam^2) larger than f)
    for got, want in zip((S, K, m, P), out_j[3:]):
        _close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want)).max()))
    # the lighter contracts return prefixes of the same values
    g = tops_kalman.decorrelate_blocked(lt, _t(y, torch.float32), num_blocks=num_blocks,
                                        return_gains=True)
    mo = tops_kalman.decorrelate_blocked(lt, _t(y, torch.float32), num_blocks=num_blocks,
                                         return_moments=True)
    assert len(g) == 5 and len(mo) == 5
    _close(g[4], K, rtol=0, atol=0)
    _close(mo[4], P, rtol=0, atol=0)


def _k1_affine_fold(A, Q, R, y, nb, T):
    """The per-step recursion of ``csrc/kalman_scan.cu::phase1_kernel``,
    vectorised over the nb time blocks: the filter run through each block
    conditioned on the state entering it (H = e1).  Steps at or past n leave
    the running element as it is."""
    n, d = A.shape[0], A.shape[-1]
    I = torch.eye(d, dtype=A.dtype).expand(nb, d, d)
    Ar, Cr, Jr = I.clone(), torch.zeros(nb, d, d, dtype=A.dtype), torch.zeros(nb, d, d, dtype=A.dtype)
    br, er = torch.zeros(nb, d, dtype=A.dtype), torch.zeros(nb, d, dtype=A.dtype)
    for t in range(T):
        k = torch.arange(nb) * T + t
        live = k < n
        kk = torch.where(live, k, 0)
        Ak, Qk, Rk, yk = A[kk], Q[kk], R[kk], y[kk]
        Ab = Ak @ Ar
        bb = (Ak @ br[:, :, None])[:, :, 0]
        Cb = Ak @ Cr @ Ak.transpose(-1, -2) + Qk
        S = Cb[:, 0, 0] + Rk
        K = Cb[:, :, 0] / S[:, None]
        h = Ab[:, 0, :]
        v = yk - bb[:, 0]
        new = (Ab - K[:, :, None] * h[:, None, :], bb + K * v[:, None],
               Cb - K[:, :, None] * Cb[:, None, 0, :], er + h * (v / S)[:, None],
               Jr + h[:, :, None] * h[:, None, :] / S[:, None, None])
        Ar, br, Cr, er, Jr = (torch.where(live.view((nb,) + (1,) * (x.dim() - 1)), x, old)
                              for x, old in zip(new, (Ar, br, Cr, er, Jr)))
    return Ar, br, Cr, er, Jr


@pytest.mark.parametrize("d,n,nb,T,zero_y", [
    (1, 1000, 70, 15, False),  # ragged block 66, blocks 67-69 padding only
    (2, 100, 16, 7, False),  # block 14 ragged, block 15 padding only
    (3, 100, 16, 7, False),
    (3, 1000, 70, 15, True),  # the gain pass: y = 0
], ids=["d1", "d2", "d3", "d3-y0"])
def test_k1_recursion_matches_phase1_plain(d, n, nb, T, zero_y, rng):
    """K1's inversion-free recursion is the fold of the one-step filtering
    elements: its float64 mirror against ``phase1_plain`` (itself held to
    the JAX kernel by ``test_decorrelate_blocked_matches_pallas``), and the
    phase-2 inits of both."""
    t = np.cumsum(rng.uniform(0.1, 1.0, n)) / 50.0
    kern = getattr(tk, {1: "Matern12", 2: "Matern32", 3: "Matern52"}[d])(
        lengthscale=torch.tensor(0.7, dtype=F64), variance=torch.tensor(1.3, dtype=F64))
    lg = tmarkov.lgssm_of(kern, _t(t), 0.1, F64)
    A, Q = lg.A.contiguous(), lg.Q.contiguous()
    R = lg.R.to(F64).expand(n).contiguous()
    y = torch.zeros(n, dtype=F64) if zero_y else _t(rng.normal(size=n))
    got = _k1_affine_fold(A, Q, R, y, nb, T)
    want = tops_kalman.phase1_plain(A, Q, R, y, nb, T)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-10, atol=1e-10 * float(w.abs().max()))
    if zero_y:  # b and eta are exactly zero on the gain pass
        assert not got[1].any() and not got[3].any() and not want[1].any()
    for g, w in zip(tops_kalman.block_inits(*got), tops_kalman.block_inits(*want)):
        _close(g, w, rtol=1e-10, atol=1e-10 * float(w.abs().max()))


@pytest.mark.parametrize("name,n,B", [
    ("Matern52", 1500, 7),
    ("Matern12", 700, 3),
    ("Matern52", 333, 33),  # the main path's B = M + 1; 20 blocks of 17 steps, the last ragged
])
def test_whiten_columns_matches_pallas(name, n, B, rng):
    lj, lt = _f32_lgssm(rng, name, n)
    Y = rng.normal(size=(n, B))
    ll_j, a_j, ld_j = pallas_whiten_columns(lj, jnp.asarray(Y, jnp.float32), interpret=True)
    ll_t, a_t, ld_t = tops_whiten.whiten_columns(lt, _t(Y, torch.float32))
    _close(a_t, a_j, atol=2e-5)
    _close(ll_t, ll_j, rtol=2e-5)
    _close(ld_t, ld_j, rtol=1e-6)
    # the Gram is formed in float64 from the float32 whitened columns
    G, ld = tops_whiten.whiten_gram(lt, _t(Y, torch.float32))
    assert G.dtype == F64 and ld.dtype == F64
    W = a_t.double()
    _close(G, (W.T @ W).numpy(), rtol=1e-12)
    # the training path's call: the same sweep, plus the moments the backward
    # needs, against the float64 sequential filter on the same LGSSM (float32
    # recursions, held to 1e-4 of each quantity's scale as above)
    ll_a, a_a, ld_a, (e, S, K, m, P) = tops_whiten.whiten_columns(lt, _t(Y, torch.float32),
                                                                   want_aux=True)
    for got, want in ((ll_a, ll_t), (a_a, a_t), (ld_a, ld_t)):
        _close(got, _np(want), rtol=0, atol=0)
    l64 = tmarkov.LGSSM(*(x.double() for x in (lt.A, lt.Q, lt.H, lt.R)))
    ref = tkalman.kalman_filter(l64, _t(Y))
    assert m.shape == ref.m.shape == (n, l64.dim, B)
    for got, want in ((e, ref.v), (S, ref.S), (m, ref.m), (P, ref.P)):
        _close(got, _np(want), rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_whiten_columns_moments_only_for_the_backward(rng, monkeypatch):
    """``whiten_columns`` asks the y = 0 gain pass (K2) for the filtered
    moments only when the backward needs them (``want_aux``); with and
    without them it returns the same ll, alpha and logdet, bit for bit."""
    n, B = 333, 5
    _, lt = _f32_lgssm(rng, "Matern52", n)
    Y = _t(rng.normal(size=(n, B)), torch.float32)
    asked = []
    decorrelate = tops_whiten.decorrelate_blocked

    def spy(*args, **kwargs):
        asked.append((kwargs.get("return_moments", False), kwargs.get("return_full", False)))
        return decorrelate(*args, **kwargs)

    monkeypatch.setattr(tops_whiten, "decorrelate_blocked", spy)
    ll, alpha, logdet = tops_whiten.whiten_columns(lt, Y)
    ll_a, alpha_a, logdet_a, aux = tops_whiten.whiten_columns(lt, Y, want_aux=True)
    assert asked == [(False, False), (True, False)]
    for got, want in ((ll_a, ll), (alpha_a, alpha), (logdet_a, logdet)):
        assert torch.equal(got, want)
    assert aux[4].shape == (n, 3, 3) and torch.isfinite(aux[4]).all()


def test_whiten_sweep_plain_blocking(rng):
    """K3's plain version at an explicit blocking (7 blocks of 48 steps,
    the last ragged) against the same function at ``num_blocks_for(n)``
    (20 blocks of 17): the blocking only re-associates the float32
    recursion.  Measured on a CPU: alpha within 1.5e-7 and the means within
    5.4e-7 of their largest values, ll within 8.7e-8 relative; held to
    2e-6."""
    n, B = 333, 33
    _, lt = _f32_lgssm(rng, "Matern52", n)
    A, _, _, _ = tops_kalman._f32_inputs(lt, torch.zeros(n))
    _, _, _, S, K, _, _ = tops_kalman.decorrelate_blocked(lt, torch.zeros(n), return_full=True)
    gains = tops_whiten.gain_rows(A, S, K)
    Y = _t(rng.normal(size=(n, B)), torch.float32)
    assert tops_kalman.num_blocks_for(n) == 20
    ll, alpha, m = tops_whiten.whiten_sweep_plain(gains, Y, 3, want_means=True)
    ll7, alpha7, m7 = tops_whiten.whiten_sweep(gains, Y, 3, want_means=True, nb=7, T=48)
    assert alpha7.shape == (n, B) and m7.shape == (n, 3, B)
    _close(ll7, _np(ll), rtol=2e-6)
    for got, want in ((alpha7, alpha), (m7, m)):
        _close(got, _np(want), rtol=0, atol=2e-6 * float(want.abs().max()))
    with pytest.raises(ValueError, match="do not tile"):
        tops_whiten.whiten_sweep(gains, Y, 3, nb=7, T=47)


def test_sum_kernel_and_gradients_raise(rng):
    """Sum-kernel SDEs on the kernel path no longer raise: the wrappers send
    them to the associative-scan engine, chosen by ``pallas_supported`` from
    the SDE's shape, and launch nothing.  Matern-5/2 + Matern-1/2 (d = 4),
    n = 300, float32, against the JAX wrappers, which take their
    associative fallback: ``decorrelate_blocked`` and ``pallas_smooth`` on
    bit-identical inputs at the JAX kernel tests' tolerances (alpha and the
    smoothed mean and variance atol 2e-5, ll rtol 2e-5, logdet rtol 1e-6;
    the filtered and smoothed state moments, whose scans combine in another
    order, 2e-5 and 1e-4 of their scale as in
    ``test_pallas_smooth_matches_jax``): measured at most 6.6e-6 of each
    output's scale, the smoothed variance 1.4e-5.  ``logpdf_markov_pallas``'s
    value and lengthscale gradient: the port discretizes in float64, the JAX
    package in float32; measured 2.8e-7 and 3.0e-6 relative, held to 2e-5
    and 1e-3.  A gradient also flows through the kernel path's whitened
    Gram, and agrees with the tensor-code blocked engine's closed form
    (float32, 20 steps: measured 2.1e-7 relative, held to 1e-4)."""
    from gpar_at_scale_tpu.ops.pallas_grad import logpdf_markov_pallas as j_logpdf
    from gpar_at_scale_tpu.ops.pallas_smoother import pallas_smooth as j_smooth

    n, f32 = 300, torch.float32
    ts = np.cumsum(rng.uniform(0.1, 1.0, n)) / 50.0
    y = np.sin(8 * ts) + 0.3 * rng.normal(size=n)

    def kernel_j(l):
        return jk.Matern52(lengthscale=l, variance=1.0) + jk.Matern12(lengthscale=2.0, variance=0.5)

    lj = jmarkov.lgssm_of(kernel_j(0.8), jnp.asarray(ts, jnp.float32), 0.1, jnp.float32)
    lt = tmarkov.LGSSM(A=_t(lj.A, f32), Q=_t(lj.Q, f32), H=_t(lj.H, f32), R=_t(lj.R, f32))
    assert lt.dim == 4 and not tops_kalman.pallas_supported(lt)
    yj, yt = jnp.asarray(y, jnp.float32), _t(y, f32)
    for k in KERNELS:
        k.launches = 0
    out_t = tops_kalman.decorrelate_blocked(lt, yt, return_full=True)
    out_j, sm_j = jax.jit(lambda lg, y_: (pallas_decorrelate(lg, y_, return_full=True),
                                          j_smooth(lg, y_, return_state=True)))(lj, yj)
    assert len(out_t) == 7 and out_t[1].shape == (n,) and out_t[6].shape == (n, 4, 4)
    _close(out_t[0], out_j[0], rtol=2e-5)
    _close(out_t[1], out_j[1], rtol=0, atol=2e-5)
    _close(out_t[2], out_j[2], rtol=1e-6)
    for got, want in zip(out_t[3:], out_j[3:]):  # S, K, m, P
        _close(got, want, rtol=0, atol=2e-5 * float(np.abs(np.asarray(want)).max()))
    sm_t = tops_smoother.pallas_smooth(lt, yt, return_state=True)
    _close(sm_t[2], sm_j[2], rtol=2e-5)
    for i in (0, 1, 5):  # f_mean, f_var, E (zeros on both)
        _close(sm_t[i], sm_j[i], rtol=0, atol=2e-5)
    for i in (3, 4):  # ms, Ps
        _close(sm_t[i], sm_j[i], rtol=0, atol=1e-4 * float(np.abs(np.asarray(sm_j[i])).max()))
    l = _t(0.8, f32).requires_grad_()
    k_t = tk.Matern52(lengthscale=l, variance=_t(1.0, f32)) + tk.Matern12(
        lengthscale=_t(2.0, f32), variance=_t(0.5, f32))
    v_t = tops_grad.logpdf_markov_pallas(k_t, _t(ts, f32), 0.1, yt)
    v_t.backward()
    v_j, g_j = jax.jit(jax.value_and_grad(
        lambda l_: j_logpdf(kernel_j(l_), jnp.asarray(ts, jnp.float32), 0.1, yj)))(jnp.float32(0.8))
    _close(v_t, float(v_j), rtol=2e-5)
    _close(l.grad, float(g_j), rtol=1e-3)
    assert all(k.launches == 0 for k in KERNELS)
    U = _t(np.random.default_rng(1).normal(size=(20, 2)), torch.float32)
    t = _t(np.linspace(0, 1, 20), torch.float32)
    grads = []
    for whiten_gram in (tops_whiten.whiten_gram, tblocked_grad.whiten_gram):
        ls = _t(1.0, torch.float32).requires_grad_()
        lg1 = tmarkov.lgssm_of(tk.Matern52(lengthscale=ls, variance=_t(1.0)), t, 0.1, torch.float32)
        G, ld = whiten_gram(lg1, U)
        (G.sum() + ld).backward()
        grads.append(ls.grad)
    assert bool(torch.isfinite(grads[0])) and float(grads[0]) != 0.0
    _close(grads[0], _np(grads[1]), rtol=1e-4)
    # the forward-only sweep carries no gradient
    _, alpha, _ = tops_whiten.whiten_columns(lg1, U)
    assert not alpha.requires_grad
    # the column sweep and the Gram take one Matern block only; their callers route
    with pytest.raises(ValueError, match="pallas_supported"):
        tops_whiten.whiten_gram(lt, yt[:, None])


# ---------------------------------------------------------------------------
# The whole slice: condition a 3-output chain on given hyperparameters and
# answer a predict request, against the JAX chain.
# ---------------------------------------------------------------------------


def _slice_case():
    t, Y, t_star, lat_star, sn = make_chain_data(2500, 200, 3, np.random.default_rng(3))
    p_first = np.asarray(jparams.pack_gp(0.5, 1.0, 0.2), np.float32)
    p_cond = np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2), np.float32)
    return t, Y, t_star, lat_star, sn, [p_first, p_cond, p_cond]


def _jref_slice():
    """``test_slice_matches_jax_chain``'s JAX side: the chain's predictive
    (mean, var) and every conditional's pseudo-inputs."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.inference.optimize import OptResult

    t, Y, t_star, _, _, init = _slice_case()
    minimize = jgpar._minimize
    jgpar._minimize = lambda cfg, fun, x0: OptResult(params=x0, value=jnp.nan, num_steps=0,
                                                      converged=False)
    try:
        jcfg = jgpar.GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=8,
                                dtype=jnp.float32, max_opt_steps=0)
        jmodel = jgpar.fit_gpar(jax.random.PRNGKey(0), t, Y, jcfg,
                                init_params=[jnp.asarray(p) for p in init])
        mu_j, var_j = jmodel.predict(jnp.asarray(t_star, jnp.float32))
    finally:
        jgpar._minimize = minimize
    return np.asarray(mu_j), np.asarray(var_j), [np.asarray(c.Z) for c in jmodel.conditionals]


def test_slice_matches_jax_chain():
    """N = 2500 (above DENSE_N_MAX, so the kernel path whitens and the
    blocked smoother predicts), M = 8, float32, filter_impl='pallas'.

    The JAX chain runs its own fit_gpar with the optimizer replaced by the
    identity: with max_opt_steps = 0 its L-BFGS returns x0 unchanged, and
    this skips the gradient it would evaluate at x0.  Tolerance: the port
    forms the whitened Gram and the M x M algebra in float64 where the JAX
    package stays in float32, it discretizes the LGSSM in float64 where the
    JAX package's float32 Q carries its cancellation (ROADMAP section 3),
    and the two smooth over different block splits.  Measured on the CPU
    with this data: means (|mu| 3e-3 to 1.3) differ by at most 3.3e-5, held
    to atol 1e-4; the latent variances (3.0e-4 to 1.6e-3, no observation
    noise) by at most 8.0e-7, or 1.7e-3 of the value, held to rtol 2e-3 --
    a zero, halved or doubled variance fails by two orders of magnitude.
    Against the float64 sequential engine the port's float32 chain is far
    closer (chip_smoke.py's reference phase)."""
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y, t_star, lat_star, sn, init = _slice_case()
    mu_j, var_j, Z_j = _jax_ref(_jref_slice)
    for k in KERNELS:
        k.launches = 0
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=8,
                     dtype=torch.float32, max_opt_steps=0)
    model = fit_gpar(None, t, Y, cfg, init_params=convert.params_from_numpy(init, device=CPU),
                     device=CPU)
    mu_t, var_t = model.predict(t_star)
    assert all(k.launches == 0 for k in KERNELS)  # the CPU takes the plain versions
    assert mu_t.shape == (200, 3) and var_t.shape == (200, 3)
    assert mu_t.dtype == torch.float32
    assert bool(torch.isfinite(mu_t).all() and torch.isfinite(var_t).all())
    _close(mu_t, mu_j, rtol=0, atol=1e-4)
    _close(var_t, var_j, rtol=2e-3, atol=0)
    for z_j, ct in zip(Z_j, model.conditionals):
        _close(ct.Z, z_j, rtol=0, atol=0)
    rmse = np.sqrt(np.mean((_np(mu_t) - lat_star) ** 2, axis=0))
    assert np.all(rmse < sn)


@pytest.mark.parametrize("separate_noise", [False, True])
def test_conditional_dense_matches_jax(separate_noise, rng, monkeypatch):
    """One conditional at N = 300 (the dense branch of 'auto'), float64,
    against the JAX fit_conditional with the optimizer replaced by the
    identity, then its predictive (the dense smoother)."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.inference.optimize import OptResult
    from gpar_at_scale_torch.models import GPARConfig, fit_conditional

    monkeypatch.setattr(
        jgpar, "_minimize",
        lambda cfg, fun, x0: OptResult(params=x0, value=jnp.nan, num_steps=0, converged=False),
    )
    n = 300
    t = rng.permutation(_grid(rng, n, 6.0))  # fit sorts by time
    X = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.4 * X[:, 0] + 0.1 * rng.normal(size=n)
    p = rng.normal(scale=0.3, size=6 if separate_noise else 5)
    kw = dict(backend="scaled", num_pseudo_points=12, max_opt_steps=0, separate_noise=separate_noise)
    cj = jgpar.fit_conditional(jax.random.PRNGKey(0), t, X, y, jgpar.GPARConfig(**kw),
                               init_params=jnp.asarray(p))
    ct = fit_conditional(None, t, X, y, GPARConfig(**kw), init_params=p, device=CPU)
    for a, b in zip(ct.qu, cj.qu):
        _close(a, b, rtol=1e-8, atol=1e-10)
    t_star, X_star = np.sort(rng.uniform(0, 6, 20)), rng.normal(size=(20, 2))
    for a, b in zip(ct.predict(t_star, X_star), cj.predict(jnp.asarray(t_star), jnp.asarray(X_star))):
        _close(a, b, rtol=1e-8, atol=1e-10)
    assert ct.hyperparams() == pytest.approx(cj.hyperparams(), rel=1e-12)


# ---------------------------------------------------------------------------
# The training slice: K4's plain path, the smoother, the closed-form VJPs,
# the DTC gradient and the optimizers, against the JAX package.
# ---------------------------------------------------------------------------


def _suffix_elements(rng, n, d, C):
    """Contracting E (as the smoother's and the adjoint's are), symmetric L."""
    E = 0.6 * rng.uniform(-1.0, 1.0, size=(n, d, d)) / d
    X = rng.normal(size=(n, d, d))
    return E, rng.normal(size=(n, d, C)), 0.5 * (X + np.swapaxes(X, 1, 2))


@pytest.mark.parametrize("d,n,C", [(1, 3000, 5), (2, 3000, 5), (3, 3000, 5), (3, 300, 70)],
                         ids=["1", "2", "3", "3-C70"])
def test_suffix_scan_matches_pallas(d, n, C, rng):
    """K4's plain path against the Pallas kernel (interpret) at n = 3000,
    three grid steps of 1024 lanes, one column; with C = 5 columns against
    the JAX blocked suffix scan.  The last case takes C = 70 columns (more
    than one column tile of the card's K4b) at n = 300.  float32 on both
    sides over different block splits: measured at most 1.0e-7 of each
    output's scale, held to 1e-5."""
    from gpar_at_scale_tpu.ops.pallas_smoother import pallas_suffix_scan

    E, g, L = _suffix_elements(rng, n, d, C)
    f32 = np.float32
    Et, gt, Lt = (_t(x, torch.float32) for x in (E, g, L))
    v1, M1 = tops_smoother.suffix_scan(Et, gt[:, :, 0], Lt)
    vj, Mj = pallas_suffix_scan(*(jnp.asarray(x, f32) for x in (E, g[:, :, 0], L)), interpret=True)
    assert v1.shape == (n, d) and M1.shape == (n, d, d)
    for got, want in ((v1, vj), (M1, Mj)):
        _close(got, want, rtol=0, atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    v5, M5 = tops_smoother.suffix_scan(Et, gt, Lt)
    assert v5.shape == (n, d, C)
    _, vb, Mb = jax.jit(jblocked.blocked_suffix_scan)(*(jnp.asarray(x, f32) for x in (E, g, L)))
    for got, want in ((v5, vb), (M5, Mb)):
        _close(got, want, rtol=0, atol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_pallas_smooth_matches_jax(rng):
    """The port's kernel-path smoother against the JAX package's, Matern-5/2
    at n = 2100 with the full state: float32 with the JAX smoother test's
    atol 2e-5 on (mean, var), measured 1.3e-6 and 2.8e-8; the state moments
    and gains within 6.9e-6 of their scale, held to 1e-4.

    The JAX ``pallas_smooth`` is jitted with the LGSSM as an argument, so
    its ``pallas_supported`` check sees a traced H and takes the
    associative-scan smoother (whose gains E come back as zeros); called
    unjitted (``__wrapped__``) it smooths through its Pallas suffix scan
    (interpret), which is the function ported here."""
    from gpar_at_scale_tpu.ops.pallas_smoother import pallas_smooth

    lj, lt = _f32_lgssm(rng, "Matern52", 2100)
    y = np.sin(np.arange(2100) / 50.0) + 0.3 * rng.normal(size=2100)
    out_j = jax.jit(lambda y_: pallas_smooth.__wrapped__(lj, y_, interpret=True, return_state=True))(
        jnp.asarray(y, jnp.float32))
    out_t = tops_smoother.pallas_smooth(lt, _t(y, torch.float32), return_state=True)
    fm, fv, ll, ms, Ps, E = out_t
    _close(fm, out_j[0], rtol=0, atol=2e-5)
    _close(fv, out_j[1], rtol=0, atol=2e-5)
    _close(ll, out_j[2], rtol=2e-5)
    for got, want in zip((ms, Ps, E), out_j[3:]):
        _close(got, want, rtol=0, atol=1e-4 * float(np.abs(np.asarray(want)).max()))
    assert fm.shape == (2100,) and ms.shape == (2100, 3) and E.shape == (2100, 3, 3)


def _sym(M):
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def test_lgssm_loglik_cotangents_match_jax(rng):
    """LgssmLoglik's raw (A, Q, R, y) cotangents against jax.grad of the JAX
    package's lgssm_loglik, n = 300, d = 3, float32; dQ by its symmetric
    part (the upstream dQ is symmetric).  The JAX test's tolerance: atol
    2e-3 of each cotangent's scale; measured 2.0e-6 (ll: 6.9e-8, held to
    rtol 2e-5)."""
    from gpar_at_scale_tpu.ops.pallas_grad import lgssm_loglik

    n = 300
    t = np.cumsum(rng.uniform(0.2, 1.2, n)) / 20.0
    y = np.sin(t) + 0.3 * rng.normal(size=n)
    lj = jmarkov.lgssm_of(jk.Matern52(lengthscale=0.9, variance=0.7), jnp.asarray(t, jnp.float32),
                          0.15, jnp.float32)
    args = (lj.A, lj.Q, lj.R, jnp.asarray(y, jnp.float32))
    g_j = jax.jit(jax.grad(lgssm_loglik, argnums=(0, 1, 2, 3)))(*args)
    leaves = [_t(np.asarray(a), torch.float32).requires_grad_() for a in args]
    ll = tops_grad.lgssm_loglik(*leaves)
    ll.backward()
    _close(ll, lgssm_loglik(*args), rtol=2e-5)
    for i, (x, gj) in enumerate(zip(leaves, g_j)):
        gt, gj = _np(x.grad), np.asarray(gj)
        if i == 1:
            gt, gj = _sym(gt), _sym(gj)
        scale = np.abs(gj).max() + 1e-6
        np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-3)


def _adjoint_inputs(rng, n, d, B, dtype=torch.float32):
    """Random (A, aux = (e, S, K, m, P), r, N) of the adjoint kernels K5a/K5b."""
    A, P, K, e, m, r, N = (_t(rng.normal(size=s), dtype) for s in (
        (n, d, d), (n, d, d), (n, d), (n, B), (n, d, B), (n, d, B), (n, d, d)))
    S = _t(rng.uniform(0.5, 2.0, n), dtype)
    return A, (e, S, K, m, P), r, N


@pytest.mark.parametrize("d,B", [(1, 1), (2, 5), (3, 33)], ids=["d1-B1", "d2-B5", "d3-B33"])
def test_adjoint_wrappers_take_their_plain_versions_on_the_cpu(d, B, rng):
    """K5a/K5b's wrappers on CPU tensors return the tensor code's elements
    and scores (``ssm/blocked_grad.py`` with H = e1) bit for bit, at a
    float64 Gram cotangent and a scalar or 0-dim ct_ld, and launch
    nothing."""
    A, aux, r, N = _adjoint_inputs(rng, 40, d, B)
    H = _t(np.eye(d)[0], torch.float32)
    X = rng.normal(size=(B, B))
    ct_G = _t(X + X.T)
    for k in KERNELS:
        k.launches = 0
    got = tops_grad.adjoint_elements(A, aux)
    want = tblocked_grad.whiten_bwd_elements(A, H, aux)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for ct_ld in (0.3, _t(-0.7)):
        got = tops_grad.adjoint_scores(A, aux, r, N, ct_G, ct_ld)
        want = tblocked_grad.whiten_bwd_scores(A, H, aux, r, N, ct_G, ct_ld)
        assert [g.shape for g in got] == [(40, d, d), (40, d, d), (40,), (40, B)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(k.launches == 0 for k in KERNELS)


@pytest.mark.parametrize("fault", ["d4", "H", "float64", "strided"])
def test_adjoint_wrappers_raise_on_what_the_kernels_do_not_take(fault, rng):
    """K5a and K5b take state dim <= 3, H = e1 and contiguous float32 on one
    device; anything else raises ValueError before any launch, on the CPU
    as on the card."""
    d = 4 if fault == "d4" else 3
    A, aux, r, N = _adjoint_inputs(rng, 20, d, 5, F64 if fault == "float64" else torch.float32)
    H = None
    if fault == "H":
        H = _t([0.0, 1.0, 0.0], torch.float32)
    if fault == "strided":
        e, S, K, m, P = aux
        aux = (_t(rng.normal(size=(20, 10)), torch.float32)[:, ::2], S, K, m, P)
    ct_G = -torch.eye(5)
    with pytest.raises(ValueError):
        tops_grad.adjoint_elements(A, aux, H)
    with pytest.raises(ValueError):
        tops_grad.adjoint_scores(A, aux, r, N, ct_G, 0.0, H)


def test_launch_counts_list_the_adjoint_kernels():
    """``launch_counts()`` reports K5a and K5b beside K1-K4b, K6a-c and K7,
    with the source each is built from."""
    from gpar_at_scale_torch.ops import K5A, K5B, K7, launch_counts
    from gpar_at_scale_torch.ops.build import SOURCES

    names = [k.split()[0] for k in launch_counts()]
    assert names == ["K1", "K2", "K3", "K4a", "K4b", "K5a", "K5b", "K6a", "K6b", "K6c", "K7"]
    assert K5A.source == K5B.source == "gpar_at_scale_torch/csrc/adjoint.cu"
    assert K7.source == "gpar_at_scale_torch/csrc/smoothing.cu"
    assert "adjoint" in SOURCES and "smoothing" in SOURCES


def _names_clear_of_the_scan_kernels(source):
    """The ``__global__`` functions of ``csrc/<source>``, after checking
    that none contains a name fragment of K1-K4b's device kernels."""
    from portbench.roofline.scan import DEVICE_KERNELS

    src = (Path(tops_grad.__file__).resolve().parent.parent / "csrc" / source).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    frags = [frag for parts in DEVICE_KERNELS.values() for frag, _ in parts]
    assert not [(n, f) for n in names for f in frags if f in n]
    return sorted(names)


def test_adjoint_kernel_names_stay_clear_of_the_scan_kernels():
    """The profiler's records of K1-K4b are found by name fragments
    (``portbench/roofline/scan.py::DEVICE_KERNELS``), and the benchmark's
    traced run checks their count against K1-K4b's launch counters: no
    ``__global__`` function of ``csrc/adjoint.cu`` may contain one."""
    names = _names_clear_of_the_scan_kernels("adjoint.cu")
    assert names == ["adjoint_elements_kernel", "adjoint_scores_kernel"]


def test_smoothing_kernel_name_stays_clear_of_the_scan_kernels():
    """Nor may K7's (``csrc/smoothing.cu``), or the batched request's
    ``scan_roofline_pct.serve.n1m`` would count it as a scan kernel."""
    assert _names_clear_of_the_scan_kernels("smoothing.cu") == ["smoothing_elements_kernel"]


@pytest.mark.parametrize("family,rtol", [("Matern12", 1e-4), ("Matern32", 2e-3), ("Matern52", 5e-3)])
def test_logpdf_markov_pallas_gradients_match_jax(family, rtol, rng):
    """Value and hyperparameter gradient of the kernel-path log-likelihood
    against the JAX package's (interpret), n = 700, float32, with the JAX
    test's tolerances (rtol 1e-4 / 2e-3 / 5e-3, atol 1e-3); measured at most
    3.1e-5 relative (the values within 1.1e-7 relative)."""
    from gpar_at_scale_tpu.ops.pallas_grad import logpdf_markov_pallas

    n = 700
    t = np.cumsum(rng.uniform(0.2, 1.2, n)) / 20.0
    y = np.sin(t) + 0.3 * rng.normal(size=n)
    jf, tf = _family(family)
    p0 = np.asarray([0.1, -0.2, -1.0])

    def nll_j(p):
        l, sf, sn = jparams.unpack_gp(p)
        return -logpdf_markov_pallas(jf(lengthscale=l, variance=sf**2),
                                     jnp.asarray(t, jnp.float32), sn**2, jnp.asarray(y, jnp.float32))

    v_j, g_j = jax.jit(jax.value_and_grad(nll_j))(jnp.asarray(p0, jnp.float32))
    p = _t(p0, torch.float32).requires_grad_()
    l, sf, sn = tparams.unpack_gp(p)
    v_t = -tops_grad.logpdf_markov_pallas(tf(lengthscale=l, variance=sf**2), _t(t, torch.float32),
                                          sn**2, _t(y, torch.float32))
    v_t.backward()
    _close(v_t, v_j, rtol=1e-5)
    _close(p.grad, g_j, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("engine", ["pallas", "blocked"])
def test_whiten_gram_gradients_match_jax(engine, rng):
    """Gradient in (A, Q, R, U) of <ct_G, G> + ct_ld logdet, a random
    symmetric ct_G and a scalar ct_ld, against the JAX engine of the same
    name.  'pallas': float32 kernel path (the port forms G in float64, the
    JAX package in float32), n = 220, B = 5; tolerance atol 3e-3 of each
    cotangent's scale as the JAX test's, measured 4.2e-7 (value 5.2e-7,
    held to rtol 1e-5).  'blocked': float64 tensor code both sides, rtol
    1e-8 and atol 1e-10 of the scale; measured 2e-12 relative."""
    from gpar_at_scale_tpu.ops import pallas_grad as jpg
    from gpar_at_scale_tpu.ssm import blocked_grad as jbg

    n, B = 220, 5
    t = np.cumsum(rng.uniform(0.2, 1.2, n)) / 20.0
    U = rng.normal(size=(n, B))
    X = rng.normal(size=(B, B))
    ct_G, ct_ld = X + X.T, 0.7
    if engine == "pallas":
        jdt, tdt, wg_j, wg_t = jnp.float32, torch.float32, jpg.whiten_gram, tops_whiten.whiten_gram
    else:
        jdt, tdt, wg_j, wg_t = jnp.float64, F64, jbg.whiten_gram, tblocked_grad.whiten_gram
    lj = jmarkov.lgssm_of(jk.Matern52(lengthscale=0.9, variance=0.7), jnp.asarray(t, jdt), 0.15, jdt)

    def loss_j(A, Q, R, U_):
        G, ld = wg_j(jmarkov.LGSSM(A=A, Q=Q, H=lj.H, R=R), U_)
        return jnp.sum(G * ct_G) + ct_ld * ld

    args = (lj.A, lj.Q, lj.R, jnp.asarray(U, jdt))
    v_j, g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3)))(*args)
    leaves = [_t(np.asarray(a), tdt).requires_grad_() for a in args]
    G, ld = wg_t(tmarkov.LGSSM(A=leaves[0], Q=leaves[1], H=_t(lj.H, tdt), R=leaves[2]), leaves[3])
    assert G.dtype == F64
    v_t = (G * _t(ct_G)).sum() + ct_ld * ld
    v_t.backward()
    rtol, atol = (1e-5, 3e-3) if engine == "pallas" else (1e-10, 1e-10)
    _close(v_t, v_j, rtol=rtol)
    for i, (x, gj) in enumerate(zip(leaves, g_j)):
        gt, gj = _np(x.grad), np.asarray(gj)
        if i == 1:
            gt, gj = _sym(gt), _sym(gj)
        scale = np.abs(gj).max() + 1e-6
        np.testing.assert_allclose(gt / scale, gj / scale, rtol=0 if engine == "pallas" else 1e-8,
                                   atol=atol)


@pytest.mark.parametrize("separate_noise", [False, True])
def test_dtc_gradient_matches_jax(separate_noise, rng):
    """Value and gradient of the DTC bound in its log-parameters through the
    kernel path ('pallas', float32) against the JAX package's 'pallas'
    engine, and against the port's own float64 sequential autograd.  n =
    150, M = 12.  Against JAX: rtol 1e-4 on the value, rtol 1e-3 and atol
    2e-3 on the gradient (the JAX DTC test's); measured 3.6e-6 on the value,
    2.3e-4 relative and 3.6e-4 absolute on the gradient.  Against float64:
    the same tolerances; measured 3.0e-7, 8.7e-6 and 6.6e-5."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_torch.models.gpar import GPARConfig, _conditional_bound

    n, m = 150, 12
    t = np.cumsum(rng.uniform(0.2, 1.0, n)) / 10.0
    V = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.3 * V[:, 0] + 0.2 * rng.normal(size=n)
    Z = V[:: n // m][:m]
    p0 = np.asarray([0.1, -0.2, 0.3, -0.1, -1.2, -1.0][: 6 if separate_noise else 5])
    jcfg = jgpar.GPARConfig(backend="scaled", separate_noise=separate_noise, dtype=jnp.float32)

    def nlml_j(p):
        tl, ts, ol, osig, ns, tns = jgpar._unpack_cond(jcfg, p)
        tk_ = jk.Matern52(lengthscale=tl, variance=ts**2)
        lg = jmarkov.lgssm_of(tk_, jnp.asarray(t, jnp.float32), tns**2, jnp.float32)
        return -jdtc.dtc_objective(jk.Matern52(lengthscale=ol, variance=osig**2), lg,
                                   jnp.asarray(V, jnp.float32), jnp.asarray(Z, jnp.float32),
                                   jnp.asarray(y, jnp.float32), uu_ridge=ns**2, filter_fn="pallas")

    v_j, g_j = jax.jit(jax.value_and_grad(nlml_j))(jnp.asarray(p0, jnp.float32))
    out = {}
    for impl, dt in (("pallas", torch.float32), ("sequential", F64)):
        cfg = GPARConfig(backend="scaled", filter_impl=impl, separate_noise=separate_noise, dtype=dt)
        at = _conditional_bound(cfg, _t(t, dt), _t(V, dt), _t(y, dt), _t(Z, dt))
        p = _t(p0, dt).requires_grad_()
        v = -at(tdtc.dtc_objective, p)
        v.backward()
        out[impl] = (v.detach(), p.grad)
    v_k, g_k = out["pallas"]
    _close(v_k, v_j, rtol=1e-4)
    _close(g_k, g_j, rtol=1e-3, atol=2e-3)
    _close(v_k, _np(out["sequential"][0]), rtol=1e-4)
    _close(g_k, _np(out["sequential"][1]), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("separate_noise", [False, True])
def test_associative_filter_impl_matches_jax(separate_noise, rng):
    """filter_impl="associative": one conditional's DTC bound and its
    gradient at n = 300, M = 8, float64, against the JAX package's through
    its parallel_filter (both noise packings); and output 1's nll, which the
    JAX package computes with its sequential filter and the port with
    parallel_logpdf (the same function).  Held to rtol 1e-9 (value) and
    1e-8 (gradient); measured at most 1.6e-14 of each output's scale."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.ssm.pkalman import parallel_filter
    from gpar_at_scale_torch.models.gpar import GPARConfig, _conditional_bound, _first_output_nll

    n, m = 300, 8
    t = _grid(rng, n, 6.0)
    X = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.4 * X[:, 0] + 0.1 * rng.normal(size=n)
    Z = X[:: n // m][:m]
    p0 = rng.normal(scale=0.3, size=6 if separate_noise else 5)
    jcfg = jgpar.GPARConfig(backend="scaled", filter_impl="associative", separate_noise=separate_noise)

    def nll_j(p):
        tl, ts, ol, osig, ns, tns = jgpar._unpack_cond(jcfg, p)
        time_k = jk.Matern52(lengthscale=tl, variance=ts**2)
        lg = jmarkov.lgssm_of(time_k, jnp.asarray(t), tns**2, jnp.float64)
        return -jdtc.dtc_objective(jk.Matern52(lengthscale=ol, variance=osig**2), lg, jnp.asarray(X),
                                   jnp.asarray(Z), jnp.asarray(y), uu_ridge=ns**2,
                                   filter_fn=parallel_filter, time_kernel=time_k, t=jnp.asarray(t))

    cfg = GPARConfig(backend="scaled", filter_impl="associative", separate_noise=separate_noise)
    at = _conditional_bound(cfg, _t(t), _t(X), _t(y), _t(Z))
    cases = [(lambda p: -at(tdtc.dtc_objective, p), nll_j, p0)]
    if not separate_noise:
        def nll1_j(p):
            l, ps, ns = jparams.unpack_gp(p)
            lg = jmarkov.lgssm_of(jk.Matern52(lengthscale=l, variance=ps**2), jnp.asarray(t), ns**2)
            return -jkalman.logpdf(lg, jnp.asarray(y))

        cases.append((_first_output_nll(cfg, _t(t), _t(y)), nll1_j, p0[:3]))
    for nll_t, nll_jax, p in cases:
        v_j, g_j = jax.jit(jax.value_and_grad(nll_jax))(jnp.asarray(p))
        pt = _t(p).requires_grad_()
        v_t = nll_t(pt)
        v_t.backward()
        _close(v_t, float(v_j), rtol=1e-9)
        _close(pt.grad, np.asarray(g_j), rtol=1e-8, atol=1e-10)


def _small_chain(n, P):
    t, Y, t_star, _, _ = make_chain_data(n, 50, P, np.random.default_rng(5))
    first = np.asarray(jparams.pack_gp(0.5, 1.0, 0.2))
    cond = np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2))
    return t, Y, t_star, [first] + [cond] * (P - 1)


def test_kernel_path_gradient_matches_float64_on_chain_data():
    """Output 1's log-likelihood and two conditionals' DTC bounds on the
    chain data at N = 2500 (time gaps of about 1e-3), M = 8: the gradient
    in the log-parameters through the kernel path (float32) against float64
    sequential autograd, each component on its own to rtol 1e-3 and atol
    2e-3 (components 4 to 1500).

    The LGSSM is discretized in float64 and then cast (``lgssm_of``), so a
    float32 LGSSM is the float64 one rounded.  Discretized in float32, as
    the JAX package does, Q = Pinf - A Pinf A^T cancels at these gaps (its
    entries were up to 12% off) and the time-variance component of the
    gradient was off by 1.2%, 10 times the tolerance.  Discretized in
    float64, every component is measured within 2.0e-4 of its size."""
    from gpar_at_scale_torch.models.gpar import (
        GPARConfig,
        _conditional_bound,
        _first_output_nll,
        _select_pseudo_points,
    )

    t, Y, _, init = _small_chain(2500, 3)
    k = tk.Matern52(lengthscale=_t(0.5), variance=_t(1.2))
    l32, l64 = (tmarkov.lgssm_of(k, _t(t), 0.04, dt) for dt in (torch.float32, F64))
    for a, b in ((l32.A, l64.A), (l32.Q, l64.Q)):
        _close(a, _np(b.float()), rtol=0, atol=0)
    for i in range(3):
        grads = []
        for impl, dt in (("pallas", torch.float32), ("sequential", F64)):
            cfg = GPARConfig(backend="scaled", filter_impl=impl, num_pseudo_points=8, dtype=dt)
            if i == 0:
                nll = _first_output_nll(cfg, _t(t, dt), _t(Y[:, 0], dt))
            else:
                X = _t(Y[:, :i], dt)
                at = _conditional_bound(cfg, _t(t, dt), X, _t(Y[:, i], dt), _select_pseudo_points(X, 8))
                nll = lambda p, at=at: -at(tdtc.dtc_objective, p)  # noqa: E731
            p = _t(init[i], dt).requires_grad_()
            nll(p).backward()
            grads.append(_np(p.grad).astype(np.float64))
        _close(grads[0], grads[1], rtol=1e-3, atol=2e-3)


def _jref_adam_trace():
    """``test_adam_trace_matches_jax``'s JAX side: every output's trained
    log-parameters and the chain's predictions."""
    import gpar_at_scale_tpu.models.gpar as jgpar

    t, Y, t_star, init = _small_chain(200, 2)
    kw = dict(backend="scaled", num_pseudo_points=8, optimizer="adam", max_opt_steps=3)
    jm = jgpar.fit_gpar(jax.random.PRNGKey(0), t, Y, jgpar.GPARConfig(**kw),
                        init_params=[jnp.asarray(p) for p in init])
    return ([np.asarray(f.params) for f in [jm.first] + jm.conditionals],
            [np.asarray(x) for x in jm.predict(jnp.asarray(t_star))])


def test_adam_trace_matches_jax():
    """fit_gpar with 3 Adam steps per output on a 2-output chain at N = 200,
    float64, through the dense/sequential engines, against the JAX fit_gpar
    with the same config: the same gradients and the same Adam formula, so
    the parameters agree to rtol 1e-8 (measured 3e-13) and the
    predictions to 1e-8 (measured 1.2e-12)."""
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y, t_star, init = _small_chain(200, 2)
    kw = dict(backend="scaled", num_pseudo_points=8, optimizer="adam", max_opt_steps=3)
    j_params, j_pred = _jax_ref(_jref_adam_trace)
    tm = fit_gpar(None, t, Y, GPARConfig(**kw), init_params=init, device=CPU)
    for pj, ft in zip(j_params, [tm.first] + tm.conditionals):
        _close(ft.params, pj, rtol=1e-8, atol=1e-12)
        assert ft.opt.num_steps == 3 and ft.opt.trace.shape == (3,)
    for a, b in zip(tm.predict(t_star), j_pred):
        _close(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("backend", ["scaled", "exact"])
def test_parallel_fit_matches_jax(backend):
    """fit_gpar(parallel=True) on a 4-output chain at N = 40, M = 8, with
    3 Adam steps per output from given parameters, float64: its three
    conditionals against the JAX package's fit_conditionals_parallel, the
    vmapped fit on the zero-padded feature stack.  The port fits each
    conditional on its unpadded features (the same distances and the same
    pseudo-point rows) with the same gradients and the same Adam formula:
    parameters and q(u) to rtol 1e-8 (measured 2.0e-13 of each output's
    scale), Z exactly, predictions to 1e-8."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y, _, init = _small_chain(40, 4)
    t_star = t + 0.01  # beside each training time, with the training outputs as features
    kw = dict(backend=backend, num_pseudo_points=8, optimizer="adam", max_opt_steps=3)
    jconds = jgpar.fit_conditionals_parallel(jax.random.split(jax.random.PRNGKey(0), 3), t, Y,
                                             jgpar.GPARConfig(**kw),
                                             init_params=[jnp.asarray(p) for p in init[1:]])
    tm = fit_gpar(None, t, Y, GPARConfig(**kw), init_params=init, parallel=True, device=CPU)
    for i, (cj, ct) in enumerate(zip(jconds, tm.conditionals)):
        _close(ct.params, cj.params, rtol=1e-8, atol=1e-12)
        assert ct.opt.num_steps == 3 and ct.X_prev.shape == (40, i + 1)
        if backend == "scaled":
            assert ct.Z.shape == (8, i + 1) and ct.qu.Z.shape == (8, i + 1)
            _close(ct.Z, cj.Z, rtol=0, atol=0)
            for a, b in zip(ct.qu[:3], cj.qu[:3]):
                _close(a, b, rtol=1e-8, atol=1e-10)
        X_star = Y[:, :i + 1]
        for a, b in zip(ct.predict(t_star, X_star),
                        cj.predict(jnp.asarray(t_star), jnp.asarray(X_star))):
            _close(a, b, rtol=1e-8, atol=1e-10)


def _jref_kernel_path_training():
    """``test_kernel_path_training_matches_jax``'s JAX side: every output's
    trained log-parameters."""
    import gpar_at_scale_tpu.models.gpar as jgpar

    t, Y, _, init = _small_chain(2500, 2)
    kw = dict(backend="scaled", filter_impl="pallas", num_pseudo_points=8, optimizer="adam",
              max_opt_steps=3)
    jm = jgpar.fit_gpar(jax.random.PRNGKey(0), t, Y, jgpar.GPARConfig(dtype=jnp.float32, **kw),
                        init_params=[jnp.asarray(p, jnp.float32) for p in init])
    return [np.asarray(f.params) for f in [jm.first] + jm.conditionals]


def test_kernel_path_training_matches_jax():
    """The same 3-step Adam in float32 through the kernel path
    ('pallas': K1/K2 + K4 for output 1, K1-K3 + K4 for the conditional) at
    N = 2500, M = 8, P = 2, against the JAX fit_gpar on its Pallas kernels
    (interpret).  The port forms the Gram and the M x M algebra in float64,
    JAX in float32, and the two run the forward filter differently (JAX's
    jitted wrapper takes its associative engine, see the module docstring):
    the trained log-parameters differ by at most 6.1e-5 (measured), held to
    atol 5e-4, 1% of the 5e-2 an Adam step moves them."""
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y, t_star, init = _small_chain(2500, 2)
    kw = dict(backend="scaled", filter_impl="pallas", num_pseudo_points=8, optimizer="adam",
              max_opt_steps=3)
    j_params = _jax_ref(_jref_kernel_path_training)
    for k in KERNELS:
        k.launches = 0
    tm = fit_gpar(None, t, Y, GPARConfig(dtype=torch.float32, **kw),
                  init_params=[np.asarray(p, np.float32) for p in init], device=CPU)
    assert all(k.launches == 0 for k in KERNELS)
    for pj, ft, p0 in zip(j_params, [tm.first] + tm.conditionals, init):
        assert float(np.abs(_np(ft.params) - p0).max()) > 1e-2  # it trained
        _close(ft.params, pj, rtol=0, atol=5e-4)


def _lbfgs_case():
    rng = np.random.default_rng(0)
    n = 80
    t = _grid(rng, n, 6.0)
    X = rng.normal(size=(n, 1))
    y = np.sin(t) + 0.5 * np.tanh(X[:, 0]) + 0.1 * rng.normal(size=n)
    p0 = np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2))
    return t, X, y, p0, dict(backend="scaled", num_pseudo_points=6, max_opt_steps=200)


def _jref_lbfgs_optimum():
    """``test_lbfgs_optimum_matches_jax``'s JAX side: the L-BFGS end point."""
    import gpar_at_scale_tpu.models.gpar as jgpar

    t, X, y, p0, kw = _lbfgs_case()
    cj = jgpar.fit_conditional(jax.random.PRNGKey(0), t, X, y, jgpar.GPARConfig(**kw),
                               init_params=jnp.asarray(p0))
    return np.asarray(cj.params)


def test_lbfgs_optimum_matches_jax():
    """L-BFGS to convergence on a small float64 dense conditional (N = 80,
    M = 6): the port's line search is PyTorch's, not optax's, so the
    iterates differ, but the optimum is the same one: the bound agrees to
    rtol 1e-8 (measured 6.4e-14) and the log-parameters to atol 1e-5
    (measured 3.8e-7)."""
    from gpar_at_scale_torch.models import GPARConfig, fit_conditional
    from gpar_at_scale_torch.models.gpar import _conditional_bound

    t, X, y, p0, kw = _lbfgs_case()
    p_j = _jax_ref(_jref_lbfgs_optimum)
    ct = fit_conditional(None, t, X, y, GPARConfig(**kw), init_params=p0, device=CPU)
    assert ct.opt.converged
    at = _conditional_bound(ct.cfg, ct.t, ct.X_prev, ct.y, ct.Z)
    v_t, v_j = (float(at(tdtc.dtc_objective, _t(np.asarray(p)))) for p in (ct.params, p_j))
    _close(v_t, v_j, rtol=1e-8)
    _close(ct.params, p_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["lbfgs", "adam"])
def test_multi_start_matches_jax(method):
    """multi_start from four starts on a function with two minima (three
    starts end in the higher one) returns the same run as the JAX package's:
    with Adam (200 steps, the same formula) to rounding, measured 0; with
    L-BFGS, whose iterates differ, the value to rtol 1e-10 (measured 3.8e-13)
    and the parameters to atol 1e-5 (measured 3.4e-7)."""
    from gpar_at_scale_tpu.inference import optimize as jopt
    from gpar_at_scale_torch.inference import optimize as topt

    def fun(x):
        return (x[0] ** 2 - 1.0) ** 2 + 0.3 * x[0] + (x[1] - 0.5) ** 2

    x0s = np.asarray([[1.5, 0.0], [-1.5, 1.0], [0.8, -1.0], [3.0, 2.0]])
    kw = {"max_steps": 200} if method == "adam" else {}
    rj = jopt.multi_start(fun, jnp.asarray(x0s), method=method, **kw)
    rt = topt.multi_start(fun, _t(x0s), method=method, **kw)
    assert float(rt.params[0]) < 0.0  # the lower minimum
    _close(rt.value, float(rj.value), rtol=1e-10 if method == "lbfgs" else 1e-14)
    _close(rt.params, np.asarray(rj.params), rtol=0, atol=1e-5 if method == "lbfgs" else 1e-14)
    assert rt.converged == bool(rj.converged)


def test_lbfgs_steps_back_from_a_failed_factorization():
    """An objective whose Cholesky factor fails outside |x_0| < 1, with its
    optimum near that edge and a first L-BFGS step that crosses it: the
    JAX package's cholesky returns NaN there and optax's line search backs
    off; the port's raises, and its L-BFGS tries the step again shorter.
    Both reach the same optimum: the value to rtol 1e-10 (measured 6.6e-12),
    the parameters to atol 1e-5 (measured 7.0e-8)."""
    from gpar_at_scale_tpu.inference import optimize as jopt
    from gpar_at_scale_torch.inference import optimize as topt

    failed = []

    def fun_j(x):
        L = jnp.linalg.cholesky(jnp.eye(2) + x[0] * jnp.array([[0.0, 1.0], [1.0, 0.0]]))
        return (5 * (x[0] - 0.98) ** 2 + 0.1 * (x[1] - 0.3) ** 2
                - 0.002 * jnp.sum(jnp.log(jnp.diagonal(L))))

    def fun_t(x):
        one = torch.ones_like(x[0])
        try:
            L = torch.linalg.cholesky(torch.stack([torch.stack([one, x[0]]), torch.stack([x[0], one])]))
        except torch.linalg.LinAlgError:
            failed.append(float(x[0]))
            raise
        return (5 * (x[0] - 0.98) ** 2 + 0.1 * (x[1] - 0.3) ** 2
                - 0.002 * torch.log(torch.diagonal(L)).sum())

    x0 = np.asarray([0.3, 0.0])
    rj = jopt.minimize_lbfgs(fun_j, jnp.asarray(x0))
    rt = topt.minimize_lbfgs(fun_t, _t(x0))
    assert failed and all(x >= 1.0 for x in failed)
    assert rt.converged and bool(rj.converged)
    _close(rt.value, float(rj.value), rtol=1e-10)
    _close(rt.params, np.asarray(rj.params), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The dense path: K6a/K6b/K6c's plain versions, their VJPs, the dispatch,
# the dense DTC branch, the exact GP and the EEG chain, against the JAX
# package (its Pallas kernels in interpret mode).
# ---------------------------------------------------------------------------

F32 = torch.float32
_DENSE_ENV = ("GPAR_PALLAS_DENSE", "GPAR_PALLAS_DENSE_INTERPRET", "GPAR_NO_PALLAS_DENSE")


def _spd32(rng, n):
    A = rng.normal(size=(n, n))
    return (A @ A.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n,k", [(24, 5), (13, 7), (40, 1), (33, 70)])
def test_dense_plain_versions_match_pallas(n, k, rng):
    """chol_solve, tri_ut and tri_u's plain versions against the JAX
    kernels (interpret) on the same float32 inputs, with the JAX kernel
    tests' tolerances: U rtol = atol = 2e-5, W and X 3e-5, logdet rtol
    1e-5 (n = 13, 33 and 40 are not multiples of the TPU kernels' 8-row
    panels, nor of the port's 16; k = 70 spans several of the triangular
    kernels' column tiles)."""
    from gpar_at_scale_tpu.ops import pallas_dense as jpd
    from gpar_at_scale_torch.ops import dense as tdense

    S, B = _spd32(rng, n), rng.normal(size=(n, k)).astype(np.float32)
    Uj, Wj, ldj = jpd.chol_solve(jnp.asarray(S), jnp.asarray(B), interpret=True)
    Ut, Wt, ldt, info = tdense.chol_solve(_t(S, F32), _t(B, F32))
    assert int(info) == 0 and Ut.dtype == F32
    _close(Ut, Uj, rtol=2e-5, atol=2e-5)
    _close(Wt, Wj, rtol=3e-5, atol=3e-5)
    _close(ldt, ldj, rtol=1e-5)
    U = np.asarray(Uj)
    for jfn, tfn in ((jpd.tri_ut, tdense.tri_ut), (jpd.tri_u, tdense.tri_u)):
        _close(tfn(_t(U, F32), _t(B, F32)), jfn(jnp.asarray(U), jnp.asarray(B), interpret=True),
               rtol=3e-5, atol=3e-5)


def test_dense_plain_versions_batch_and_info(rng):
    """A batch of matrices (the kernels' grid axis) against the JAX kernels
    vmapped, as the parallel conditional fit calls them; and the info word
    of a matrix that is not positive definite, as torch.linalg.cholesky_ex
    gives it."""
    from gpar_at_scale_tpu.ops import pallas_dense as jpd
    from gpar_at_scale_torch.ops import dense as tdense

    n, k, batch = 16, 3, 4
    Ss = np.stack([_spd32(rng, n) for _ in range(batch)])
    Bs = rng.normal(size=(batch, n, k)).astype(np.float32)
    Uj, Wj, ldj = jax.vmap(lambda S, B: jpd.chol_solve(S, B, interpret=True))(
        jnp.asarray(Ss), jnp.asarray(Bs))
    Ut, Wt, ldt, info = tdense.chol_solve(_t(Ss, F32), _t(Bs, F32))
    assert info.tolist() == [0] * batch
    _close(Ut, Uj, rtol=2e-5, atol=2e-5)
    _close(Wt, Wj, rtol=3e-5, atol=3e-5)
    _close(ldt, ldj, rtol=1e-5)
    X = tdense.tri_u(Ut, _t(Bs, F32))
    _close(Ut @ X, Bs, rtol=0, atol=1e-5)
    S = np.eye(20, dtype=np.float32)
    S[11, 11] = -1.0
    want = torch.linalg.cholesky_ex(_t(S, F32)).info
    assert int(tdense.chol_solve(_t(S, F32), torch.zeros(20, 1))[3]) == int(want) == 12
    with pytest.raises(torch.linalg.LinAlgError, match="order 12"):
        tpsd._raise_on_info(tdense.chol_solve(_t(S, F32), torch.zeros(20, 1))[3])


def _vjp_pair(which, n, k):
    """The scalar functions of the JAX kernel tests (test_pallas_dense.py)
    through the port's wrappers and through torch.linalg autograd."""
    from gpar_at_scale_torch.ops import dense as tdense

    def gram(A):
        return A @ A.T + n * torch.eye(n, dtype=A.dtype)

    if which == "chol_solve":
        c = torch.as_tensor(np.random.default_rng(11).normal(size=n)).float()

        def port(A, B):
            U, W, ld, _ = tdense.chol_solve(gram(A), B)
            return (W * W).sum() + 0.7 * ld + (U @ c).sum()

        def linalg(A, B):
            L = torch.linalg.cholesky(gram(A))
            W = torch.linalg.solve_triangular(L, B, upper=False)
            ld = 2.0 * torch.log(torch.diagonal(L)).sum()
            return (W * W).sum() + 0.7 * ld + (L.T @ c).sum()

        return port, linalg, c.numpy()
    port_fn = tdense.tri_ut if which == "ut" else tdense.tri_u

    def port(A, B):
        return torch.cos(port_fn(torch.linalg.cholesky(gram(A)).T, B)).sum()

    def linalg(A, B):
        L = torch.linalg.cholesky(gram(A))
        X = (torch.linalg.solve_triangular(L, B, upper=False) if which == "ut"
             else torch.linalg.solve_triangular(L.T, B, upper=True))
        return torch.cos(X).sum()

    return port, linalg, None


@pytest.mark.parametrize("which", ["chol_solve", "ut", "u"])
def test_dense_vjps_match_jax(which, rng):
    """The three autograd.Functions (ops/dense.py) against the JAX custom
    VJPs (interpret) on the JAX kernel tests' scalar functions, n = 16,
    float32, and against torch autograd through torch.linalg on the same
    function: the JAX tests' tolerance, 2e-4 (values rtol 1e-5)."""
    from gpar_at_scale_tpu.ops import pallas_dense as jpd

    n, k = (16, 4) if which == "chol_solve" else (16, 3)
    A0 = rng.normal(size=(n, n)).astype(np.float32)
    B0 = rng.normal(size=(n, k)).astype(np.float32)
    port, linalg, c = _vjp_pair(which, n, k)

    def gram_j(A):
        return A @ A.T + n * jnp.eye(n, dtype=jnp.float32)

    if which == "chol_solve":
        def scal_j(A, B):
            U, W, ld = jpd.chol_solve(gram_j(A), B, interpret=True)
            return jnp.sum(W * W) + 0.7 * ld + jnp.sum(U @ jnp.asarray(c))
    else:
        jfn = jpd.tri_ut if which == "ut" else jpd.tri_u

        def scal_j(A, B):
            return jnp.sum(jnp.cos(jfn(jnp.linalg.cholesky(gram_j(A)).T, B, interpret=True)))

    v_j = scal_j(jnp.asarray(A0), jnp.asarray(B0))
    g_j = jax.grad(scal_j, argnums=(0, 1))(jnp.asarray(A0), jnp.asarray(B0))
    out = []
    for fn in (port, linalg):
        A, B = _t(A0, F32).requires_grad_(), _t(B0, F32).requires_grad_()
        v = fn(A, B)
        out.append((v.detach(), torch.autograd.grad(v, (A, B))))
    (v_t, g_t), (v_l, g_l) = out
    for want_v, want_g in ((float(v_j), g_j), (float(v_l), g_l)):
        _close(v_t, want_v, rtol=1e-5)
        for a, b in zip(g_t, want_g):
            _close(a, _np(b), rtol=2e-4, atol=2e-4)


def test_pallas_dense_dispatch_modes(rng, monkeypatch):
    """engine.pallas_dense drives utils/psd.py as in the JAX package: "off"
    -> torch.linalg, "on" -> the kernels for CUDA tensors only (these CPU
    tensors stay on torch.linalg), "interpret" -> the plain versions; the
    environment overrides the config with the JAX package's precedence; an
    unknown mode raises.  One configuration (JSON, CLI flags) reads in both
    packages."""
    from gpar_at_scale_tpu import config as jcfg
    from gpar_at_scale_torch import config as tcfg
    from gpar_at_scale_torch.ops import dense as tdense

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    calls = []
    plain = tdense.chol_solve_plain
    monkeypatch.setattr(tdense, "chol_solve_plain", lambda S, B: calls.append(1) or plain(S, B))
    S, b = _t(_spd32(rng, 16), F32), _t(rng.normal(size=(16, 2)), F32)
    cfg = tcfg.Config()
    assert cfg.engine.pallas_dense == "off"
    tcfg.set_config(cfg)
    try:
        assert tpsd.pallas_dense_mode() == "off" and not tpsd._pallas_dense_ok(S, b)
        L_off = tpsd.cholesky_psd(S)
        cfg.engine.pallas_dense = "on"
        assert tpsd.pallas_dense_mode() == "on" and not tpsd._pallas_dense_ok(S, b)
        _close(tpsd.cholesky_psd(S), _np(L_off), rtol=0, atol=0)
        assert calls == []
        cfg.engine.pallas_dense = "interpret"
        assert tpsd._pallas_dense_ok(S, b)
        assert tpsd._pallas_dense_ok(S[None], b[None])  # a leading batch axis, on the grid
        for bad in ((S.double(),), (S[None], b), (S[:7, :7],), (torch.eye(513),)):
            assert not tpsd._pallas_dense_ok(*bad)
        L_int = tpsd.cholesky_psd(S)
        assert calls == [1]
        _close(L_int, _np(L_off), rtol=3e-5, atol=3e-5)
        _close(tpsd.solve_lower(L_int, b), _np(torch.linalg.solve_triangular(L_off, b, upper=False)),
               rtol=3e-5, atol=3e-5)
        _close(tpsd.solve_upper(L_int, b[:, 0]),
               _np(torch.linalg.solve_triangular(L_off.T, b[:, :1], upper=True))[:, 0],
               rtol=3e-5, atol=3e-5)
        with pytest.raises(torch.linalg.LinAlgError):
            tpsd.cholesky_psd(-S)
        assert all(k.launches == 0 for k in KERNELS)
        # the environment outranks the config: off > interpret > on
        cfg.engine.pallas_dense = "off"
        monkeypatch.setenv("GPAR_PALLAS_DENSE", "1")
        assert tpsd.pallas_dense_mode() == "on"
        monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
        assert tpsd.pallas_dense_mode() == "interpret"
        monkeypatch.setenv("GPAR_NO_PALLAS_DENSE", "1")
        assert tpsd.pallas_dense_mode() == "off"
        for v in _DENSE_ENV:
            monkeypatch.delenv(v)
        cfg.engine.pallas_dense = "banana"
        with pytest.raises(ValueError):
            tpsd.pallas_dense_mode()
    finally:
        tcfg.set_config(tcfg.Config())
    # one configuration for both packages
    cfg = tcfg.Config()
    assert cfg.apply_overrides(["--engine.pallas_dense=on", "--optimizer.max_steps=7", "x"]) == ["x"]
    for loaded in (tcfg.Config.from_json(cfg.to_json()), jcfg.Config.from_json(cfg.to_json())):
        assert loaded.engine.pallas_dense == "on" and loaded.optimizer.max_steps == 7
    assert tcfg.kernel_family("Matern52") is tk.Matern52
    with pytest.raises(ValueError):
        tcfg.kernel_family("Nope")


def _dense_branch_case():
    rng = np.random.default_rng(0)
    n = 28
    t = np.sort(rng.uniform(0, 4, n)).astype(np.float32)
    X = rng.normal(size=(n, 2)).astype(np.float32)
    y = (np.sin(t) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return t, X, y, (0.1 * rng.normal(size=5)).astype(np.float32)


def _jref_dense_dtc_branch():
    """``test_dense_dtc_branch_matches_jax``'s JAX side: the value and
    gradient of the dense branch through the interpret kernels."""
    import os

    t, X, y, p0 = _dense_branch_case()

    def obj_j(p):
        tl, ts, ol, osig, ns = jparams.unpack_gpar(p)
        time_k, out_k = jk.Matern52(lengthscale=tl, variance=ts**2), jk.Matern52(lengthscale=ol, variance=osig**2)
        tj = jnp.asarray(t)
        return jdtc.dtc_objective(out_k, jmarkov.lgssm_of(time_k, tj, ns**2, jnp.float32),
                                  jnp.asarray(X), jnp.asarray(X[::2]), jnp.asarray(y),
                                  uu_ridge=ns**2, filter_fn="dense", time_kernel=time_k, t=tj)

    saved = {v: os.environ.pop(v, None) for v in _DENSE_ENV}
    os.environ["GPAR_PALLAS_DENSE_INTERPRET"] = "1"
    try:
        v_j, g_j = jax.value_and_grad(obj_j)(jnp.asarray(p0))
        return float(v_j), np.asarray(g_j)
    finally:
        for v, val in saved.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val


def test_dense_dtc_branch_matches_jax(monkeypatch):
    """The dense branch of dtc_objective (one chol_solve whitening all M + 1
    columns) through the plain kernels against the JAX package's through
    its interpret kernels (``GPAR_PALLAS_DENSE_INTERPRET=1`` drives both),
    N = 28, float32: value rtol 2e-5 and gradient rtol 2e-3, atol 2e-4, the
    JAX dense test's tolerances; and against the port's own torch.linalg
    path.  K6a takes Sigma_y with all M + 1 columns and K_uu alone, as in
    the JAX package."""
    from gpar_at_scale_torch.ops import dense as tdense

    t, X, y, p0 = _dense_branch_case()
    n = t.shape[0]

    def obj_t(p):
        tl, ts, ol, osig, ns = tparams.unpack_gpar(p)
        time_k, out_k = tk.Matern52(lengthscale=tl, variance=ts**2), tk.Matern52(lengthscale=ol, variance=osig**2)
        tt = _t(t, F32)
        return tdtc.dtc_objective(out_k, tmarkov.lgssm_of(time_k, tt, ns**2, F32), _t(X, F32),
                                  _t(X[::2], F32), _t(y, F32), uu_ridge=ns**2, filter_fn="dense",
                                  time_kernel=time_k, t=tt)

    def value_grad_t():
        p = _t(p0, F32).requires_grad_()
        v = obj_t(p)
        return v.detach(), torch.autograd.grad(v, p)[0]

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    v_off, g_off = value_grad_t()
    calls = []
    plain = tdense.chol_solve_plain
    monkeypatch.setattr(tdense, "chol_solve_plain", lambda S, B: calls.append(S.shape) or plain(S, B))
    monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    v_j, g_j = _jax_ref(_jref_dense_dtc_branch)
    v_t, g_t = value_grad_t()
    assert calls == [(n, n), (n // 2, n // 2)]  # Sigma_y, then K_uu
    _close(v_t, v_j, rtol=2e-5)
    _close(g_t, g_j, rtol=2e-3, atol=2e-4)
    _close(v_t, _np(v_off), rtol=2e-5)
    _close(g_t, _np(g_off), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype,mode", [("float64", "off"), ("float32", "interpret")])
def test_exact_gp_matches_jax(dtype, mode, rng, monkeypatch):
    """gp/exact.py against the JAX package's on a 2-D input, N = 30, 12 test
    points: float64 through torch.linalg (rtol 1e-10, the same algebra) and
    float32 through the plain kernels against the JAX interpret kernels
    (rtol 2e-5, atol 2e-5 on values of order 0.05 to 5: measured 2.0e-6
    of |value| + 1)."""
    from gpar_at_scale_tpu.gp import exact as jexact
    from gpar_at_scale_torch.gp import exact as texact

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    if mode == "interpret":
        monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    jdt, tdt = (jnp.float64, F64) if dtype == "float64" else (jnp.float32, F32)
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == "float64" else dict(rtol=2e-5, atol=2e-5)
    n = 30
    x, xs = rng.uniform(0, 3, size=(n, 2)), rng.uniform(0, 3, size=(12, 2))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    kj = jk.gpar_kernel(jk.Matern52, jk.Matern52, 2, 0.8, 1.1, 1.2, 0.9)
    kt = tk.gpar_kernel(tk.Matern52, tk.Matern52, 2, *(_t(v, tdt) for v in (0.8, 1.1, 1.2, 0.9)))
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: _t(a, tdt)  # noqa: E731
    _close(texact.log_marginal_likelihood(kt, T(x), T(y), 0.05, mean=0.1),
           jexact.log_marginal_likelihood(kj, J(x), J(y), 0.05, mean=0.1), **tol)
    _close(texact.nlml(kt, T(x), T(y), T(np.full(n, 0.05))),
           jexact.nlml(kj, J(x), J(y), J(np.full(n, 0.05))), **tol)
    pj, pt = jexact.condition(kj, J(x), J(y), 0.05, mean=0.1), texact.condition(kt, T(x), T(y), 0.05, mean=0.1)
    for diag in (True, False):
        for a, b in zip(pt.predict_f(T(xs), diag=diag), pj.predict_f(J(xs), diag=diag)):
            assert a.dtype == tdt
            _close(a, b, **tol)
    for a, b in zip(pt.predict_y(T(xs), 0.05), pj.predict_y(J(xs), 0.05)):
        _close(a, b, **tol)
    _close(pt.logpdf_train(T(y)), pj.logpdf_train(J(y)), **tol)
    draws = pt.sample_f(torch.Generator().manual_seed(0), T(xs), num_samples=3)
    again = pt.sample_f(torch.Generator().manual_seed(0), T(xs), num_samples=3)
    assert draws.shape == (3, 12) and bool(torch.isfinite(draws).all())
    _close(draws, _np(again), rtol=0, atol=0)


def test_eeg_data_matches_jax(tmp_path):
    """data/eeg.py gives the JAX package's synthetic EEG bit for bit, and
    its CSV loader reads channels by name in any column order."""
    from gpar_at_scale_tpu.data import eeg as jeeg
    from gpar_at_scale_torch.data import eeg as teeg

    for seed in (0, 3):
        dj, dt = jeeg.generate_synthetic_eeg(seed), teeg.generate_synthetic_eeg(seed)
        assert np.array_equal(dj.t, dt.t) and np.array_equal(dj.Y, dt.Y)
        assert tuple(dj.channels) == tuple(dt.channels)
    assert (teeg.CHAIN_ORDER, teeg.TRAIN_POINTS, teeg.NUM_POINTS) == (
        jeeg.CHAIN_ORDER, jeeg.TRAIN_POINTS, jeeg.NUM_POINTS)
    assert np.array_equal(teeg.load_eeg(None, seed=0).Y_test, jeeg.load_eeg(None, seed=0).Y_test)
    order = [6, 2, 0, 5, 1, 4, 3]
    path = tmp_path / "eeg.csv"
    np.savetxt(path, dt.Y[:, order], delimiter=",", fmt="%.17g",
               header=",".join(dt.channels[i] for i in order), comments="")
    loaded = teeg.load_eeg(str(path))
    np.testing.assert_allclose(loaded.Y, dt.Y, rtol=1e-15)
    assert np.array_equal(loaded.t, dt.t)


# The EEG chain cut to a small size: the first 40 training points, M = 20,
# the first two predicted channels (FZ, then F1 over the observed channels
# and FZ), 3 Adam steps from the example's start, 30 test times predicted
# down the chain, float32, dense kernels in interpret mode.
_EEG_N, _EEG_M, _EEG_TEST, _EEG_STEPS = 40, 20, 30, 3
_EEG_START = (0.1, 1.0, 1.0, 1.0, 0.3)


def _eeg_small():
    from gpar_at_scale_torch.data.eeg import generate_synthetic_eeg

    ds = generate_synthetic_eeg(0)
    n = _EEG_N
    t_tr, t_te = ds.t[:n], ds.t[n:n + _EEG_TEST]
    obs = [ds.channels.index(c) for c in ("F3", "F4", "F5", "F6")]
    targets = [ds.channels.index(c) for c in ("FZ", "F1")]
    return ds, t_tr, t_te, obs, targets


@functools.lru_cache(maxsize=None)
def _jax_eeg_chain(backend):
    """The JAX package's fits and chained predictions of the cut EEG chain,
    its dense kernels in interpret mode.  Returns, per channel, (params,
    objective at the trained params, mean, var)."""
    import os

    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.gp import exact as jexact

    ds, t_tr, t_te, obs, targets = _eeg_small()
    saved = {v: os.environ.pop(v, None) for v in _DENSE_ENV}
    os.environ["GPAR_PALLAS_DENSE_INTERPRET"] = "1"
    try:
        f32 = jnp.float32
        cfg = jgpar.GPARConfig(backend=backend, num_pseudo_points=_EEG_M, optimizer="adam",
                               max_opt_steps=_EEG_STEPS, dtype=f32)
        cols_tr = [ds.Y[:_EEG_N, i] for i in obs]
        cols_te = [ds.Y[_EEG_N:_EEG_N + _EEG_TEST, i] for i in obs]
        out = []
        for yi in targets:
            X, y = np.stack(cols_tr, 1), ds.Y[:_EEG_N, yi]
            fit = jgpar.fit_conditional(jax.random.PRNGKey(0), t_tr, X, y, cfg,
                                        init_params=jparams.pack_gpar(*_EEG_START).astype(f32))
            tl, ts, ol, osig, ns = jparams.unpack_gpar(fit.params)
            if backend == "exact":
                k = jk.gpar_kernel(jk.Matern52, jk.Matern52, 1 + X.shape[1], tl, ts, ol, osig)
                F = jnp.concatenate([jnp.asarray(t_tr, f32)[:, None], jnp.asarray(X, f32)], 1)
                value = jexact.nlml(k, F, jnp.asarray(y, f32), ns**2)
            else:
                time_k = jk.Matern52(lengthscale=tl, variance=ts**2)
                tj = jnp.asarray(t_tr, f32)
                value = -jdtc.dtc_objective(
                    jk.Matern52(lengthscale=ol, variance=osig**2),
                    jmarkov.lgssm_of(time_k, tj, ns**2, f32), jnp.asarray(X, f32), fit.Z,
                    jnp.asarray(y, f32), uu_ridge=ns**2, filter_fn="dense", time_kernel=time_k, t=tj)
            mu, var = fit.predict(jnp.asarray(t_te, f32), jnp.asarray(np.stack(cols_te, 1), f32))
            out.append((np.asarray(fit.params), float(value), np.asarray(mu), np.asarray(var)))
            cols_tr.append(y)
            cols_te.append(np.asarray(mu))
        return out
    finally:
        for v, val in saved.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val


def _port_eeg_chain(backend, params=None):
    """The port's side of ``_jax_eeg_chain``: trained from the example's
    start, or, given ``params``, conditioned on them (max_opt_steps = 0).
    Returns, per channel, (fit, objective at its params, mean, var)."""
    from gpar_at_scale_torch.models.gpar import (
        GPARConfig,
        _conditional_bound,
        _exact_kernel,
        fit_conditional,
    )
    from gpar_at_scale_torch.gp import exact as texact

    ds, t_tr, t_te, obs, targets = _eeg_small()
    cfg = GPARConfig(backend=backend, num_pseudo_points=_EEG_M, optimizer="adam", dtype=F32,
                     max_opt_steps=_EEG_STEPS if params is None else 0)
    start = tparams.pack_gpar(*(_t(v) for v in _EEG_START)).float()
    cols_tr = [_t(ds.Y[:_EEG_N, i], F32) for i in obs]
    cols_te = [_t(ds.Y[_EEG_N:_EEG_N + _EEG_TEST, i], F32) for i in obs]
    out = []
    for j, yi in enumerate(targets):
        y = _t(ds.Y[:_EEG_N, yi], F32)
        fit = fit_conditional(None, t_tr, torch.stack(cols_tr, 1), y, cfg, device=CPU,
                              init_params=start if params is None else params[j])
        with torch.no_grad():
            if backend == "exact":
                F = torch.cat([fit.t[:, None], fit.X_prev], 1)
                k, nv = _exact_kernel(cfg, F.shape[1], fit.params)
                value = texact.nlml(k, F, fit.y, nv)
            else:
                at = _conditional_bound(cfg, fit.t, fit.X_prev, fit.y, fit.Z)
                value = -at(tdtc.dtc_objective, fit.params)
            mu, var = fit.predict(t_te, torch.stack(cols_te, 1))
        out.append((fit, float(value), mu, var))
        cols_tr.append(y)
        cols_te.append(mu)
    return out


@pytest.mark.parametrize("backend", ["exact", "scaled"])
def test_eeg_chain_matches_jax(backend, monkeypatch):
    """The EEG chain cut to a small size (40 training points, M = 20, FZ
    then F1, 3 Adam steps, 30 test times down the chain), float32, dense
    kernels in interpret mode on both sides, against the JAX package's
    fit_conditional from the same start.  Both run float32 kernels with
    other summation orders (the port's plain versions factor in 16-row
    panels, the JAX kernels in 8-row ones): measured, the trained
    log-parameters (moved about 0.15 by the 3 steps) within 1.6e-6, the
    objectives (about 35) within 1.6e-6 relative, the predicted means
    (order 1) within 7.8e-6 and the latent variances (0.1 to 2) within
    5.5e-6 relative -- F1's inputs
    carry FZ's prediction, so its gap is the chain's.  Held to atol 1e-5,
    rtol 1e-5, atol 5e-5 and rtol 1e-4.  Every dense call went through the
    plain versions and no kernel launched."""
    from gpar_at_scale_torch.ops import dense as tdense

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    want = _jax_ref(_jax_eeg_chain, backend)
    monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    calls = []
    plain = tdense.chol_solve_plain
    monkeypatch.setattr(tdense, "chol_solve_plain", lambda S, B: calls.append(1) or plain(S, B))
    for k in KERNELS:
        k.launches = 0
    got = _port_eeg_chain(backend)
    assert calls and all(k.launches == 0 for k in KERNELS)
    start = np.asarray(jparams.pack_gpar(*_EEG_START))
    for (fit, value, mu, var), (p_j, v_j, mu_j, var_j) in zip(got, want):
        assert fit.opt.num_steps == _EEG_STEPS and float(np.abs(_np(fit.params) - start).max()) > 0.1
        _close(fit.params, p_j, rtol=0, atol=1e-5)
        _close(value, v_j, rtol=1e-5)
        assert mu.shape == (_EEG_TEST,) and mu.dtype == F32
        _close(mu, mu_j, rtol=0, atol=5e-5)
        _close(var, var_j, rtol=1e-4, atol=0)


@pytest.mark.parametrize("backend", ["exact", "scaled"])
def test_eeg_chain_from_jax_params(backend, monkeypatch):
    """The JAX-fitted log-parameters of the cut EEG chain carried across by
    params_from_numpy: the port conditions on them (q(u) for scaled, the
    exact posterior's factors recomputed from the parameters and the data)
    and predicts as the JAX package does, to the tolerances of the test
    above (measured: objectives within 3.4e-7, means 2.4e-6, variances
    1.6e-6 relative)."""
    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    want = _jax_ref(_jax_eeg_chain, backend)
    monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    params = convert.params_from_numpy([np.zeros(3)] + [w[0] for w in want], device=CPU,
                                       dtype=F32)[1:]
    got = _port_eeg_chain(backend, params=params)
    for (fit, value, mu, var), (p_j, v_j, mu_j, var_j) in zip(got, want):
        assert fit.opt is None
        _close(fit.params, p_j, rtol=0, atol=0)
        _close(value, v_j, rtol=1e-5)
        _close(mu, mu_j, rtol=0, atol=5e-5)
        _close(var, var_j, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gpar_at_scale_tpu)\b", re.M)
    files = sorted((REPO / "gpar_at_scale_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"gpar_at_scale_torch/api.py", "gpar_at_scale_torch/data/toy.py",
            "gpar_at_scale_torch/models/bayes.py", "gpar_at_scale_torch/inference/nuts.py",
            "gpar_at_scale_torch/inference/diagnostics.py",
            "gpar_at_scale_torch/examples/eeg.py", "gpar_at_scale_torch/benchmarks/bench.py"} <= names
    assert {f"gpar_at_scale_torch/benchmarks/{m}.py" for m in (
        "million_dtc", "million_grad", "long_series", "million_smc", "nuts_vs_smc", "pod_scale",
        "scaling")} <= names
    offenders = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda(monkeypatch):
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdevice.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device(None)
    cfg = GPARConfig(backend="scaled", max_opt_steps=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_gpar(None, np.linspace(0, 1, 10), np.zeros((10, 2)), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy([np.zeros(3)])
    from gpar_at_scale_torch import api

    with pytest.raises(RuntimeError, match="CUDA"):
        api.fit_gp(None, np.linspace(0, 1, 10), np.zeros(10), max_opt_steps=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.get_gpar_scaled_predictions(None, np.zeros((10, 1)), np.zeros((3, 1)),
                                        np.linspace(0, 1, 10), np.zeros(10), np.zeros(2),
                                        np.zeros((2, 1)), max_opt_steps=0)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_serving_slice_guards():
    """max_opt_steps > 0 trains; the exact backend fits and predicts (for
    the conditionals and for output 1); parallel=True fits; separate_noise with the
    exact backend raises, sequential or parallel, as in the JAX package; and
    a Monte-Carlo predictive without a generator raises ValueError, as the
    JAX package's does without a key."""
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y = np.linspace(0, 1, 12), np.random.default_rng(2).normal(size=(12, 2))
    model = fit_gpar(None, t, Y, GPARConfig(backend="scaled", max_opt_steps=2, num_pseudo_points=4),
                     device=CPU)
    assert [f.opt.num_steps for f in (model.first, *model.conditionals)] == [2, 2]
    assert model.first.opt.trace.shape == (2,)
    exact = fit_gpar(None, t, Y, GPARConfig(backend="exact", first_output_backend="exact",
                                            max_opt_steps=2), device=CPU)
    assert [f.backend for f in (exact.first, *exact.conditionals)] == ["exact", "exact"]
    mu, var = exact.predict(np.linspace(0, 1.2, 5))
    assert mu.shape == var.shape == (5, 2) and bool(torch.isfinite(mu).all() and (var >= 0).all())
    Y3 = np.random.default_rng(3).normal(size=(12, 3))
    for backend in ("scaled", "exact"):
        par = fit_gpar(None, t, Y3, GPARConfig(backend=backend, max_opt_steps=0, num_pseudo_points=4),
                       parallel=True, device=CPU)
        assert [c.X_prev.shape[1] for c in par.conditionals] == [1, 2]
        mu, var = par.predict(np.linspace(0, 1.2, 5))
        assert mu.shape == (5, 3) and bool(torch.isfinite(mu).all() and (var >= 0).all())
    for parallel in (False, True):
        with pytest.raises(ValueError, match="separate_noise"):
            fit_gpar(None, t, Y3, GPARConfig(backend="exact", separate_noise=True, max_opt_steps=0),
                     parallel=parallel, device=CPU)
    c = model.conditionals[0]
    time_k, out_k, nv = c._kernels()
    with pytest.raises(ValueError, match="Generator"):
        tdtc.predict_scaled(out_k, time_k, c.qu, c.X_prev, c.t, c.y, c.t[:3], c.X_prev[:3], nv,
                            num_samples=10)
    mc = tdtc.predict_scaled(out_k, time_k, c.qu, c.X_prev, c.t, c.y, c.t[:3], c.X_prev[:3], nv,
                             num_samples=10, generator=torch.Generator().manual_seed(0))
    assert mc.mean.shape == mc.var.shape == (3,) and bool(torch.isfinite(mc.mean).all())


def test_toy_data_matches_jax():
    """data/toy.py gives the JAX package's small and big datasets exactly."""
    from gpar_at_scale_tpu.data import toy as jtoy
    from gpar_at_scale_torch.data import toy as ttoy

    for name, kw in (("generate_small_dataset", {}), ("generate_small_dataset", {"seed": 3}),
                     ("generate_big_dataset", {"replicate_reference_noise_bug": True})):
        a, b = getattr(ttoy, name)(**kw), getattr(jtoy, name)(**kw)
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)
    assert ttoy.generate_big_dataset().y_obs.shape == (8496, 3)


def test_api_matches_jax(monkeypatch):
    """The five functions of api.py against the JAX package's at
    max_opt_steps = 0, where both optimizers return their start (the port's
    L-BFGS iterates are not optax's; the JAX optimizer is replaced by the
    identity, which is what its L-BFGS returns at 0 steps, to skip its
    compile), on the small toy dataset, float64:
    fit_gp (exact) and fit_gpar_conditional by their parameters and
    predictions, get_sde_predictions (fit_gp's temporal backend),
    get_optim_scaled_gpar_params and the analytic
    get_gpar_scaled_predictions (rtol 1e-8, measured 2.6e-13 of each
    output's scale; the port whitens densely at this N, the JAX api with
    its sequential filter: the same bound); the
    Monte-Carlo get_gpar_scaled_predictions (400 samples) within 6 standard
    errors of the analytic mean, counted with the predictive's whole
    standard deviation (at least its f_x part's)."""
    from gpar_at_scale_tpu import api as japi
    from gpar_at_scale_torch import api as tapi
    from gpar_at_scale_torch.data.toy import generate_small_dataset

    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.inference import optimize as jopt

    identity = lambda fun, x0, **kw: jopt.OptResult(  # noqa: E731
        params=x0, value=jnp.nan, num_steps=0, converged=False)
    monkeypatch.setattr(jopt, "minimize_lbfgs", identity)
    monkeypatch.setattr(jgpar, "_minimize", lambda cfg, fun, x0: identity(fun, x0))
    ds = generate_small_dataset(seed=0)
    key = jax.random.PRNGKey(0)
    p_gp = np.asarray(jparams.pack_gp(0.3, 1.0, 0.1))
    p_cond = np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 1.0, 0.1))
    x, y1, y2 = ds.x, ds.y_obs[:, 0], ds.y_obs[:, 1]
    grid = ds.x_true[::50]
    tol = dict(rtol=1e-8, atol=1e-10)
    gj = japi.fit_gp(key, x, y1, init_log_params=jnp.asarray(p_gp), max_opt_steps=0)
    gt = tapi.fit_gp(None, x, y1, init_log_params=p_gp, max_opt_steps=0, device=CPU)
    _close(gt.params, gj.params, rtol=0, atol=0)
    for a, b in zip(gt.predict(grid), gj.predict(jnp.asarray(grid))):
        _close(a, b, **tol)
    cj = japi.fit_gpar_conditional(key, x, ds.y_obs[:, :1], y2, init_log_params=jnp.asarray(p_cond),
                                   max_opt_steps=0)
    ct = tapi.fit_gpar_conditional(None, x, ds.y_obs[:, :1], y2, init_log_params=p_cond,
                                   max_opt_steps=0, device=CPU)
    _close(ct.params, cj.params, rtol=0, atol=0)
    for a, b in zip(ct.predict(x, ds.y_obs[:, :1]), cj.predict(jnp.asarray(x), jnp.asarray(ds.y_obs[:, :1]))):
        _close(a, b, **tol)
    for a, b in zip(tapi.get_sde_predictions(None, x, y1, grid, init_log_params=p_gp, max_opt_steps=0,
                                             device=CPU),
                    japi.get_sde_predictions(key, x, y1, grid, init_log_params=jnp.asarray(p_gp),
                                             max_opt_steps=0)):
        _close(a, b, **tol)
    V, Z = ds.y_obs[:, :1], ds.y_obs[::3, :1]
    args = (V, Z, x, y2)
    hj = japi.get_optim_scaled_gpar_params(key, *args, init_log_params=jnp.asarray(p_cond), max_opt_steps=0)
    ht = tapi.get_optim_scaled_gpar_params(None, *args, init_log_params=p_cond, max_opt_steps=0,
                                           device=CPU)
    assert ht == pytest.approx(hj, rel=1e-12)
    pred = (x, V)
    mj, sj = japi.get_gpar_scaled_predictions(key, *args, *pred, init_log_params=jnp.asarray(p_cond),
                                              max_opt_steps=0)
    mt, st = tapi.get_gpar_scaled_predictions(None, *args, *pred, init_log_params=p_cond,
                                              max_opt_steps=0, device=CPU)
    _close(mt, mj, **tol)
    _close(st, sj, **tol)
    S = 400
    mm, sm = tapi.get_gpar_scaled_predictions(torch.Generator().manual_seed(0), *args, *pred,
                                              init_log_params=p_cond, max_opt_steps=0,
                                              num_samples=S, device=CPU)
    assert bool(torch.isfinite(mm).all() and torch.isfinite(sm).all())
    assert float(((mm - mt).abs() / (st / math.sqrt(S))).max()) <= 6.0


def test_cpu_tensors_take_plain_path(rng):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    _, lt = _f32_lgssm(rng, "Matern52", 300)
    y = _t(rng.normal(size=(300, 4)), torch.float32)
    for k in KERNELS:
        k.launches = 0
    ll, alpha, logdet, S, K, m, P = tops_kalman.decorrelate_blocked(lt, y[:, 0], return_full=True)
    nb = tops_kalman.num_blocks_for(300)
    T = math.ceil(300 / nb)
    A, Q, R, y0 = tops_kalman._f32_inputs(lt, y[:, 0])
    m0, P0 = tops_kalman.block_inits(*tops_kalman.phase1_plain(A, Q, R, y0, nb, T))
    plain = tops_kalman.phase3_plain(A, Q, R, y0, m0, P0, nb, T)
    _close(alpha, plain[0], rtol=0, atol=0)
    _close(P, plain[4], rtol=0, atol=0)
    ll_w, a_w, _ = tops_whiten.whiten_columns(lt, y)
    gains = tops_whiten.gain_rows(A, S, K)
    ll_p, a_p = tops_whiten.whiten_sweep_plain(gains, y, 3)
    _close(a_w, a_p, rtol=0, atol=0)
    _close(ll_w, ll_p, rtol=0, atol=0)
    E, g, L = (_t(rng.normal(size=s), torch.float32) for s in ((300, 3, 3), (300, 3, 2), (300, 3, 3)))
    v, M = tops_smoother.suffix_scan(0.3 * E, g, L)
    r1 = tops_smoother.r1_plain(0.3 * E, g, L, nb, T)
    v_p, M_p = tops_smoother.r3_plain(0.3 * E, g, L, *tops_smoother.block_suffix_inits(*r1), nb, T)
    _close(v, v_p, rtol=0, atol=0)
    _close(M, M_p, rtol=0, atol=0)
    from gpar_at_scale_torch.ops import dense as tdense

    S, B = _t(_spd32(rng, 20), F32), _t(rng.normal(size=(20, 3)), F32)
    for got, want in zip(tdense.chol_solve(S, B), tdense.chol_solve_plain(S, B)):
        _close(got, _np(want), rtol=0, atol=0)
    U = tdense.chol_solve(S, B)[0]
    _close(tdense.tri_ut(U, B), _np(tdense.tri_ut_plain(U, B)), rtol=0, atol=0)
    _close(tdense.tri_u(U, B), _np(tdense.tri_u_plain(U, B)), rtol=0, atol=0)
    assert all(k.launches == 0 for k in KERNELS)


# ---------------------------------------------------------------------------
# Samplers and posterior draws: inference/{diagnostics,hmc,nuts,smc,vi}.py,
# ssm FFBS, models/bayes.py.  JAX is called on deterministic functions only
# (the two RNGs differ); the samplers are held to analytic targets.
# ---------------------------------------------------------------------------


def _ar1_chains(rng, C, S, D, rho=0.6):
    x = np.zeros((C, S, D))
    x[:, 0] = rng.normal(size=(C, D))
    for s in range(1, S):
        x[:, s] = rho * x[:, s - 1] + np.sqrt(1 - rho**2) * rng.normal(size=(C, D))
    return x + 0.05 * np.arange(C)[:, None, None]


def test_diagnostics_match_jax(rng):
    """(a) split R-hat, ESS, summarize and the MC-error comparison of the
    numpy copy against the JAX package's, to 1e-12."""
    from gpar_at_scale_tpu.inference import diagnostics as jd
    from gpar_at_scale_torch.inference import diagnostics as td

    a, b = _ar1_chains(rng, 4, 200, 3), _ar1_chains(rng, 3, 150, 3)
    for x in (a, a[..., 0]):
        _close(td.split_rhat(x), jd.split_rhat(x), rtol=1e-12)
        _close(td.ess(x), jd.ess(x), rtol=1e-12)
    for got, want in zip(td.summarize(a), jd.summarize(a)):
        _close(got, want, rtol=1e-12)
    for z in (0.5, 4.0):
        assert td.means_agree_within_mc_error(a, b, z) == jd.means_agree_within_mc_error(a, b, z)


@functools.lru_cache(maxsize=None)
def _jax_hmc_programs():
    """The JAX helpers, one chain and vmapped, jitted once."""
    jh = importlib.import_module("gpar_at_scale_tpu.inference.hmc")
    jn = importlib.import_module("gpar_at_scale_tpu.inference.nuts")
    prec = jnp.asarray([[2.0, -0.9, 0.1], [-0.9, 1.5, 0.0], [0.1, 0.0, 0.7]])
    lg = jax.value_and_grad(lambda q: -0.5 * q @ prec @ q)

    def da_run(eps0, accs):
        return jax.lax.scan(lambda s, a: (jh.da_update(s, a), None), jh.da_init(eps0), accs)[0]

    def wf_run(xs):
        st = jax.lax.scan(lambda s, x: (jh.welford_update(s, x), None), jh.welford_init(3), xs)[0]
        return st, jh.welford_variance(st), jh.welford_variance(st, regularize=False)

    def lf(q, p, eps, inv_mass):
        return jh.leapfrog(lg, q, p, eps, inv_mass, 5)

    one = [jax.jit(f) for f in (da_run, wf_run, lf, jn._is_turning, jh.effective_sample_size)]
    many = [jax.jit(jax.vmap(f)) for f in (da_run, wf_run, lf, jn._is_turning,
                                           jh.effective_sample_size)]
    return np.asarray(prec), one, many


def test_hmc_helpers_match_jax(rng):
    """(b) dual averaging, Welford, leapfrog, the U-turn test and the
    per-chain Geyer ESS against the JAX functions on the same inputs, one
    chain and a (4, ...) batch against JAX's vmap, to 1e-12."""
    th = importlib.import_module("gpar_at_scale_torch.inference.hmc")
    tn = importlib.import_module("gpar_at_scale_torch.inference.nuts")
    prec, one, many = _jax_hmc_programs()
    P = _t(prec)
    lg = th.value_and_grad(lambda q: -0.5 * ((q @ P) * q).sum(-1))
    C = 4
    accs = rng.uniform(size=(C, 20))
    xs = rng.normal(size=(C, 12, 3))
    q, p = rng.normal(size=(C, 3)), rng.normal(size=(C, 3))
    eps, inv_mass = rng.uniform(0.05, 0.3, C), rng.uniform(0.5, 2.0, (C, 3))
    pv = rng.normal(size=(3, C, 3))
    chains = _ar1_chains(rng, C, 300, 2, rho=0.8)

    def port(c):
        batch = slice(None) if c is None else c
        da = th.da_init(_t(np.full(C, 0.1)[batch]))
        for a in (accs[batch].T if c is None else accs[c]):
            da = th.da_update(da, _t(a))
        d = 3
        wf = th.welford_init(d, F64, () if c is not None else (C,))
        for x in (xs[batch].transpose(1, 0, 2) if c is None else xs[c]):
            wf = th.welford_update(wf, _t(x))
        out = [tuple(da), (tuple(wf), th.welford_variance(wf), th.welford_variance(wf, False))]
        out.append(th.leapfrog(lg, _t(q[batch]), _t(p[batch]), _t(eps[batch]), _t(inv_mass[batch]), 5))
        out.append(tn._is_turning(*(_t(v[batch]) for v in pv), _t(inv_mass[batch])))
        out.append(th.effective_sample_size(_t(chains[batch])))
        return out

    def jax_out(fns, c):
        batch = slice(None) if c is None else c
        return [fns[0](jnp.asarray(np.full(C, 0.1)[batch]), jnp.asarray(accs[batch])),
                fns[1](jnp.asarray(xs[batch])),
                fns[2](*(jnp.asarray(v[batch]) for v in (q, p, eps, inv_mass))),
                fns[3](*(jnp.asarray(v[batch]) for v in pv), jnp.asarray(inv_mass[batch])),
                fns[4](jnp.asarray(chains[batch]))]

    for c, fns in ((1, one), (None, many)):
        got = jax.tree_util.tree_leaves([_np(x) for x in jax.tree_util.tree_leaves(
            port(c), is_leaf=torch.is_tensor)])
        want = jax.tree_util.tree_leaves(jax_out(fns, c))
        assert len(got) == len(want) == 16
        for g_, w_ in zip(got, want):
            _close(g_, w_, rtol=1e-12, atol=1e-14)


def _ffbs_case(rng, n, dtype_j=jnp.float64, dtype_t=F64, t=None, nv=0.1):
    """The JAX FFBS test's case (Matern-5/2, lengthscale 0.8, variance 1.2)
    in both packages."""
    t = np.sort(rng.uniform(0, 8, size=n)) if t is None else t
    y = np.sin(2 * t) + rng.normal(size=n) * np.sqrt(nv)
    jl = jmarkov.lgssm_of(jk.Matern52(lengthscale=0.8, variance=1.2), jnp.asarray(t, dtype_j), nv,
                          dtype_j)
    k = tk.Matern52(lengthscale=_t(0.8, dtype_t), variance=_t(1.2, dtype_t))
    tl = tmarkov.lgssm_of(k, _t(t, dtype_t), nv, dtype_t)
    return jl, tl, y


def test_ffbs_matches_jax(rng):
    """(c) FFBS draws against the JAX package's at n = 500, d = 3, S = 3,
    given the same standard normals xi.

    * ``ffbs_draw`` on the JAX package's elements: rtol 1e-9 of the largest
      state (measured 2.7e-11).
    * ``blocked_posterior_sample(xi=...)`` end to end.  Its smoothing
      elements' L_k = P_k - E_k Pp_{k+1} E_k^T cancel to 1e-11 of their
      scale here, so the draw moves with the filter's rounding: the JAX
      package's own draw moves 7.3e-8 between 16 and 31 blocks.  The port
      is held within 2 times that spread of the JAX draw (measured 5.1e-8).
    * float32 at gaps of 5e-5 (1.4e-4 lengthscales), where the raw
      factorization of L_k fails at most steps and ``_chol_floor`` falls
      back: both packages' draws are finite, and the port's (the kernel
      route, plain versions on the CPU) misses the port's float64 draw on
      the same xi by at most 2 times the JAX package's float32 miss.
    * float32 sum-kernel SDE (Matern-5/2 + Matern-1/2, d = 4) at the same
      gaps, on the two routes the kernels do not take: the associative
      filter's and the tensor code's given ``filter_result``.  Both form
      their elements in float64 (``ffbs_elements``) and stay within 1e-2
      smoothed sd of the float64 draw on the same xi (measured 1.7e-4);
      ``ffbs_draw`` on the float32 elements misses by more than 0.1 sd
      (measured 0.69), the cancellation the float64 elements avoid."""
    n, S = 500, 3
    jl, tl, y = _ffbs_case(rng, n)
    xi = rng.normal(size=(n, 3, S))

    @jax.jit
    def jax_draws(y, xi):
        res = jblocked.blocked_filter(jl, y[:, None], num_blocks=16)
        E, g, L = jblocked._smoother_elements_fast(jl, res)
        return (E, g, L, jblocked.ffbs_draw(E, g, L, xi, num_blocks=16),
                *(jblocked.blocked_posterior_sample(None, jl, y, S, num_blocks=B, xi=xi)
                  for B in (16, 31)))

    E, g, L, x_j, f16, f31 = map(np.asarray, jax_draws(jnp.asarray(y), jnp.asarray(xi)))
    x_t = tblocked.ffbs_draw(*(_t(v) for v in (E, g, L)), _t(xi))
    _close(x_t, x_j, rtol=0, atol=1e-9 * np.abs(x_j).max())
    f_t = tblocked.blocked_posterior_sample(None, tl, _t(y), S, xi=_t(xi))
    spread = np.abs(f16 - f31).max()
    assert 0 < spread < 1e-6
    _close(f_t, f16, rtol=0, atol=2 * spread)

    n2 = 1000
    t2 = np.cumsum(rng.uniform(0.5, 1.5, n2)) * 5e-5
    xi2 = rng.normal(size=(n2, 3, S))
    port = {}
    for dj, dt in ((jnp.float32, torch.float32), (jnp.float64, F64)):
        jl2, tl2, y2 = _ffbs_case(np.random.default_rng(1), n2, dj, dt, t=t2, nv=0.09)
        port[dt] = _np(tblocked.blocked_posterior_sample(None, tl2, _t(y2, dt), S, xi=_t(xi2, dt)))
        if dt == torch.float32:
            f_j32 = np.asarray(jax.jit(lambda y, xi: jblocked.blocked_posterior_sample(
                None, jl2, y, S, xi=xi))(jnp.asarray(y2, dj), jnp.asarray(xi2, dj)))
            _, _, _, m, P = tops_kalman.decorrelate_blocked(tl2, _t(y2, dt), return_moments=True)
            L2 = tblocked.smoothing_elements(tl2, m, P, F64)[2]
            raw_bad = int((~torch.isfinite(tblocked._cholesky_small(L2)).all(-1).all(-1)).sum())
            assert raw_bad > n2 // 2, raw_bad
    ref = port[F64]
    assert np.isfinite(f_j32).all() and np.isfinite(port[torch.float32]).all()
    miss_j, miss_t = (np.abs(d - ref).max() for d in (f_j32, port[torch.float32]))
    assert miss_t <= 2 * miss_j, (miss_t, miss_j)

    def sum_lgssm(dt):
        k = (tk.Matern52(lengthscale=_t(0.8, dt), variance=_t(1.2, dt))
             + tk.Matern12(lengthscale=_t(0.5, dt), variance=_t(0.3, dt)))
        return tmarkov.lgssm_of(k, _t(t2, dt), 0.09, dt)

    y3 = np.sin(2e3 * t2) + 0.3 * rng.normal(size=n2)
    xi3 = rng.normal(size=(n2, 4, S))
    l64, l32 = sum_lgssm(F64), sum_lgssm(torch.float32)
    assert not tops_kalman.pallas_supported(l32)
    ref = _np(tblocked.blocked_posterior_sample(None, l64, _t(y3), S, xi=_t(xi3)))
    sd = _np(torch.sqrt(tkalman.rts_smooth(l64, _t(y3)).var))
    y32, xi32 = _t(y3, torch.float32), _t(xi3, torch.float32)
    res32 = tblocked.blocked_filter(l32, y32[:, None])
    for f32_draw in (tblocked.blocked_posterior_sample(None, l32, y32, S, xi=xi32),
                     tblocked.blocked_posterior_sample(None, l32, y32, S, xi=xi32,
                                                       filter_result=res32)):
        assert (np.abs(_np(f32_draw) - ref) / sd).max() <= 1e-2
    raw = torch.einsum("d,nds->sn", l32.H, tblocked.ffbs_draw(
        *tblocked._smoother_elements(l32, res32), xi32))
    assert (np.abs(_np(raw) - ref) / sd).max() > 0.1


def test_ffbs_moments_match_smoother(rng):
    """(d) The port's sequential ``posterior_sample`` and blocked draws
    against the RTS smoother's moments within Monte-Carlo error (the JAX
    FFBS test's bounds: means within 5 and 8 MC standard errors, variances
    within 20%, the lag-1 covariance H E_k Ps_{k+1} H^T within 6 standard
    errors), n = 80, S = 4000."""
    _, tl, y = _ffbs_case(rng, 80)
    S = 4000
    gen = torch.Generator().manual_seed(0)
    f = _np(tblocked.blocked_posterior_sample(gen, tl, _t(y), S))
    sm = tkalman.rts_smooth(tl, _t(y))
    mean, var = _np(sm.mean), _np(sm.var)
    sd = np.sqrt(var)
    np.testing.assert_allclose(f.mean(0), mean, atol=5 * sd.max() / np.sqrt(S))
    np.testing.assert_allclose(f.var(0), var, rtol=0.2, atol=1e-4)
    E = _np(tblocked._smoother_elements(tl, tblocked.blocked_filter(tl, _t(y)))[0])
    H = _np(tl.H)
    cov_theory = np.einsum("i,nij,njk,k->n", H, E[:-1], _np(sm.Ps)[1:], H)
    fc = f - f.mean(0)
    np.testing.assert_allclose((fc[:, :-1] * fc[:, 1:]).mean(0), cov_theory,
                               atol=6 * var.max() / np.sqrt(S))
    f_seq = _np(tkalman.posterior_sample(gen, tl, _t(y), num_samples=S))
    np.testing.assert_allclose(f_seq.mean(0), f.mean(0), atol=8 * sd.max() / np.sqrt(S))
    np.testing.assert_allclose(f_seq.var(0), var, rtol=0.2, atol=1e-4)


def _bayes_data(rng, n=64, m=8):
    t = np.sort(rng.uniform(0, 5, n))
    X = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.3 * X[:, 0] + 0.2 * rng.normal(size=n)
    return t, X, y, X[:: n // m][:m]


@functools.lru_cache(maxsize=None)
def _jax_logposts():
    """The JAX logposts' vmapped values and gradients at three points, and
    the bounded reparameterization's."""
    from gpar_at_scale_tpu.models import bayes as jbayes

    t, X, y, Z = _bayes_data(np.random.default_rng(7))
    P = 0.5 * np.random.default_rng(8).normal(size=(3, 5))
    out = {}
    for name in ("dtc", "exact", "temporal", "bounded"):
        if name == "temporal":
            lp, pts = jbayes.make_temporal_logpost(t, y), P[:, :3]
        else:
            lp = jbayes.make_conditional_logpost(t, X, y, likelihood="exact" if name == "exact"
                                                 else "dtc", Z=Z)
            pts = P
        if name == "bounded":
            lp = jbayes.bounded_reparam(lp, bound=3.0)[0]
            pts = 4.0 * P
        out[name] = (pts, *map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(lp)))(
            jnp.asarray(pts))))
    return (t, X, y, Z), out


def test_bayes_logposts_match_jax(monkeypatch):
    """(e) ``make_conditional_logpost`` (dtc and exact),
    ``make_temporal_logpost`` and ``bounded_reparam``: values and
    gradients of a (3, k) batch against the JAX logposts at the same three
    points, N = 64, M = 8, float64, rtol 1e-8 (measured 3.8e-15 and 1.8e-14
    relative to the largest, dtc).  A batch equals its rows called one by
    one (to 1e-12 relative).  Above DENSE_N_MAX (lowered to 32 here) the
    same functions take the float32 kernel path, each chain on its own:
    values rtol 1e-6, gradients 1e-4 of the largest component against the
    float64 JAX values (measured 3.9e-8 and 2.7e-6 for dtc, 5.2e-8 and
    1.1e-7 for the temporal GP)."""
    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.models import bayes as tbayes

    (t, X, y, Z), want = _jax_logposts()

    def make(name):
        if name == "temporal":
            return tbayes.make_temporal_logpost(t, y, device=CPU)
        lp = tbayes.make_conditional_logpost(t, X, y, likelihood="exact" if name == "exact"
                                             else "dtc", Z=Z, device=CPU)
        return tbayes.bounded_reparam(lp, bound=3.0)[0] if name == "bounded" else lp

    for name, (pts, v_j, g_j) in want.items():
        lp = make(name)
        v, g = value_and_grad(lp)(_t(pts))
        _close(v, v_j, rtol=1e-8)
        _close(g, g_j, rtol=0, atol=1e-8 * np.abs(g_j).max())
        singles = torch.stack([lp(_t(p)) for p in pts])
        _close(singles, _np(v), rtol=1e-12)
    _, constrain = tbayes.bounded_reparam(lambda p: p.sum(-1), bound=3.0)
    _close(constrain(_t(want["bounded"][0])), 3.0 * np.tanh(want["bounded"][0] / 3.0), rtol=1e-14)

    monkeypatch.setattr(tbayes, "DENSE_N_MAX", 32)
    for name in ("dtc", "temporal"):
        pts, v_j, g_j = want[name]
        v, g = value_and_grad(make(name))(_t(pts))
        _close(v, v_j, rtol=1e-6)
        _close(g, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_failed_factorization_is_minus_inf_per_chain(mode, rng, monkeypatch):
    """(h) A float32 DTC logpost whose dense factorization fails for one
    chain of the batch (log-parameters (5, 5, 5, 5, -7): a near-constant
    temporal covariance with noise 1e-6 of its scale) returns -inf and a
    zero gradient for that chain only; the other chains keep the values
    they have alone.  Under "interpret" the info word comes from K6a's
    plain version, under "off" from ``torch.linalg.cholesky_ex``."""
    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.models import bayes as tbayes

    for v in _DENSE_ENV:
        monkeypatch.delenv(v, raising=False)
    if mode == "interpret":
        monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    t, X, y, Z = _bayes_data(rng)
    lp = tbayes.make_conditional_logpost(t, X, y, Z=Z, dtype=torch.float32, device=CPU)
    P = _t(np.vstack([0.5 * rng.normal(size=(2, 5)), [[5.0, 5.0, 5.0, 5.0, -7.0]]]), torch.float32)
    v, g = value_and_grad(lp)(P)
    assert bool(torch.isfinite(v[:2]).all()) and v[2] == -torch.inf
    assert bool(torch.isfinite(g).all()) and bool((g[2] == 0).all()) and bool((g[:2] != 0).any())
    for c in range(2):
        _close(lp(P[c]), _np(v[c]), rtol=1e-6)


def test_predictive_mixture_and_vi_match_jax(rng):
    """(f) ``predictive_mixture_scaled`` against JAX given the same samples
    (2 chains x 10 draws, 4 thetas), N = 64, M = 8, N* = 10: rtol 1e-8.
    (g) ``predict_sparse_vi`` against JAX given the same fitted parameters
    and Z, rtol 1e-8; ``fit_sparse_vi`` from the same ``init_log_params``
    (L-BFGS, Z learned): the end point's ELBO within 1e-4 relative of JAX's
    (the iterates are no parity target)."""
    from gpar_at_scale_tpu.inference import vi as jvi
    from gpar_at_scale_tpu.models import bayes as jbayes
    from gpar_at_scale_torch.inference import vi as tvi
    from gpar_at_scale_torch.models import bayes as tbayes

    t, X, y, Z = _bayes_data(rng)
    samples = 0.3 * rng.normal(size=(2, 10, 5))
    t_star, X_star = rng.uniform(0, 5, 10), rng.normal(size=(10, 2))
    mj, vj = jax.jit(lambda s: jbayes.predictive_mixture_scaled(None, s, t, X, y, Z, t_star, X_star,
                                                                num_theta=4))(jnp.asarray(samples))
    mt, vt = tbayes.predictive_mixture_scaled(None, samples, t, X, y, Z, t_star, X_star, num_theta=4,
                                              device=CPU)
    _close(mt, mj, rtol=1e-8)
    _close(vt, vj, rtol=1e-8)

    x = np.sort(rng.uniform(0, 5, 40))
    yv = np.sin(2 * x) + 0.1 * rng.normal(size=40)
    p0 = np.asarray([-0.5, 0.0, -1.5])
    rj = jvi.fit_sparse_vi(None, jk.Matern52, x, yv, 6, init_log_params=p0, max_steps=100)
    rt = tvi.fit_sparse_vi(None, tk.Matern52, x, yv, 6, init_log_params=p0, max_steps=100, device=CPU)
    _close(rt.elbo, float(rj.elbo), rtol=1e-4)
    x_star = np.linspace(-0.5, 5.5, 7)
    fixed = tvi.SparseVIResult(log_params=_t(rj.log_params), Z=_t(rj.Z), elbo=None, num_steps=0)
    want = jax.jit(lambda lp, Z: jvi.predict_sparse_vi(rj._replace(log_params=lp, Z=Z), jk.Matern52,
                                                       x, yv, x_star))(rj.log_params, rj.Z)
    for got, want in zip(tvi.predict_sparse_vi(fixed, tk.Matern52, x, yv, x_star), want):
        _close(got, want, rtol=1e-8)


def _std_normal(q):
    return -0.5 * (q * q).sum(-1)


def _rho9(q):
    """One (2,) point: the samplers take it through value_and_grad(batched=False)."""
    prec = torch.tensor([[1.0, -0.9], [-0.9, 1.0]], dtype=q.dtype) / (1 - 0.81)
    return -0.5 * q @ prec @ q


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_samplers_hit_gaussian_targets(sampler):
    """(h) HMC and NUTS, 4 chains in lockstep, on the standard normal (the
    JAX sampler tests' bounds: mean within 0.15, variance within 0.2, no
    divergence) and the rho = 0.9 Gaussian (covariance within 0.25), the
    latter written for one point and batched by ``value_and_grad(...,
    batched=False)``; NUTS's 4 chains reach split R-hat < 1.05."""
    from gpar_at_scale_torch.inference import diagnostics as td
    from gpar_at_scale_torch.inference.hmc import hmc, value_and_grad
    from gpar_at_scale_torch.inference.nuts import nuts

    gen = torch.Generator().manual_seed(0)

    def run(fn, x0, S, W):
        lg = value_and_grad(fn, batched=fn is not _rho9)
        if sampler == "hmc":
            return hmc(gen, lg, x0, num_samples=S, num_warmup=W, num_leapfrog=8)
        return nuts(gen, lg, x0, num_samples=S, num_warmup=W, max_depth=6)

    res = run(_std_normal, torch.ones(4, 3, dtype=F64), 400, 200)
    s = _np(res.samples).reshape(-1, 3)
    assert int(res.num_divergent.sum()) == 0
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(s.var(0), 1.0, atol=0.2)
    assert bool(((res.accept_prob > 0.6) & (res.accept_prob <= 1.0)).all())
    if sampler == "nuts":
        assert float(res.mean_tree_depth.min()) >= 1.0
        assert (td.split_rhat(_np(res.samples)) < 1.05).all()
    res = run(_rho9, torch.zeros(4, 2, dtype=F64), 300, 200)
    cov = np.cov(_np(res.samples).reshape(-1, 2).T)
    np.testing.assert_allclose(cov, [[1.0, 0.9], [0.9, 1.0]], atol=0.25)


def test_nuts_nan_region_does_not_poison_stats():
    """(h) A logpost that is NaN outside |q|^2 = 9 (the float32 overflow of
    extreme hyperparameters) registers as divergences with acceptance 0:
    the acceptance, step sizes and draws stay finite (the JAX test's
    bounds), one chain and four in lockstep."""
    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.inference.nuts import nuts

    def lp(q):
        return torch.where((q * q).sum(-1) > 9.0, torch.nan, -0.5 * (q * q).sum(-1))

    for x0 in (torch.full((3,), 0.1), torch.full((4, 3), 0.1)):
        res = nuts(torch.Generator().manual_seed(1), value_and_grad(lp), x0, num_samples=100,
                   num_warmup=100)
        acc = _np(res.accept_prob)
        assert np.isfinite(acc).all() and acc.mean() > 0.3
        assert np.isfinite(_np(res.samples)).all()
        assert bool(torch.isfinite(res.step_size).all() and (res.step_size > 0).all())


def test_smc_gaussian_evidence():
    """(h) ``smc`` (tensors) and ``smc_host`` (numpy bookkeeping) on prior
    N(0, 1), likelihood N(x | 1, 0.5^2) per dimension: posterior mean and
    variance within 0.08 and log-evidence within 0.15 of the closed form
    (the JAX tests' bounds), 2000 particles, 8 mutations."""
    from gpar_at_scale_torch.inference.smc import smc, smc_host

    dim, s2 = 2, 0.25

    def log_prior(x):
        return -0.5 * (x * x).sum(-1) - 0.5 * dim * math.log(2 * math.pi)

    def log_lik(x):
        return -0.5 * ((x - 1.0) ** 2).sum(-1) / s2 - 0.5 * dim * math.log(2 * math.pi * s2)

    post_mean, post_var = 1.0 / (1.0 + s2), s2 / (1.0 + s2)
    logZ = dim * (-0.5 * np.log(2 * np.pi * (1 + s2)) - 0.5 / (1 + s2))
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((2000, dim), generator=gen, dtype=F64)
    res = smc(gen, log_prior, log_lik, x0, num_mutations=8)
    host = smc_host(1, lambda x: _np(log_prior(_t(x))), lambda x: _np(log_lik(_t(x))), _np(x0),
                    num_mutations=8)
    assert float(res.final_beta) == 1.0 and host.final_beta == 1.0
    assert host.num_lik_evals == 2000 * (1 + 8 * host.num_stages)
    for p, z in ((_np(res.particles), float(res.log_evidence)), (host.particles, host.log_evidence)):
        np.testing.assert_allclose(p.mean(0), post_mean, atol=0.08)
        np.testing.assert_allclose(p.var(0), post_var, atol=0.08)
        np.testing.assert_allclose(z, logZ, atol=0.15)


# ---------------------------------------------------------------------------
# Segment carries, ssm/segmented.py and the mixed-column backward.
#
# float64 against the JAX package: 1e-9 of each output's scale, elementwise
# (the seams included); the float32 kernel route (plain versions on the CPU)
# against the JAX package's float64: 2e-5 of each output's scale, as the
# float32 filter checks above, where the measured gap is stated.
# ---------------------------------------------------------------------------


def _near(got, want, tol):
    """Elementwise within ``tol`` of want's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


def _seg_case(name, n, seed=0, columns=None, span=8.0):
    """The JAX segmented tests' case (lengthscale 0.8, variance 1.2, noise
    0.1) in both packages, float64."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n))
    y = np.sin(1.3 * t) + 0.3 * rng.normal(size=n)
    if columns:
        y = np.concatenate([y[:, None], rng.normal(size=(n, columns - 1))], axis=1)
    kj, kt = _kernel_pair(name, l=0.8, s=1.2)
    return t, y, kj, kt, jmarkov.lgssm_of(kj, jnp.asarray(t), 0.1, jnp.float64), \
        tmarkov.lgssm_of(kt, _t(t), 0.1, F64)


def _lg_rows(lt, s, e, dtype=F64):
    return tmarkov.LGSSM(A=lt.A[s:e].to(dtype), Q=lt.Q[s:e].to(dtype), H=lt.H.to(dtype),
                         R=lt.R[s:e].to(dtype), e1=lt.e1)


def _jref_carry_case():
    """An 80-step series cut at step 50, and the JAX package's fused results
    over it (filter, smoother, a suffix scan of random elements, FFBS state
    draws on fixed normals), from which the carries across the cut come;
    and the JAX hooks' own results on the two pieces."""
    n, cut, S = 80, 50, 3
    t, y, _, _, lj, lt = _seg_case("Matern52", n, columns=2)
    rng = np.random.default_rng(1)
    E, g, L = _suffix_elements(rng, n, 3, 2)
    L = np.einsum("nij,nkj->nik", L, L)
    xi = rng.normal(size=(n, 3, S))

    @jax.jit
    def run(Y, E, g, L, xi):
        res = jblocked.blocked_filter(lj, Y, 8)
        sm = jblocked.blocked_smooth(lj, Y, filter_result=res, num_blocks=8)
        scan = jblocked.blocked_suffix_scan(E, g, L, 8)
        res1 = jblocked.blocked_filter(lj, Y[:, :1], 8)
        Ef, gf, Lf = jblocked._smoother_elements_fast(lj, res1)
        x = jblocked.ffbs_draw(Ef, gf, Lf, xi, 8)
        head = jmarkov.LGSSM(A=lj.A[:cut], Q=lj.Q[:cut], H=lj.H, R=lj.R[:cut])
        tail = jmarkov.LGSSM(A=lj.A[cut:], Q=lj.Q[cut:], H=lj.H, R=lj.R[cut:])
        hooks = dict(
            filter=jblocked.blocked_filter(tail, Y[cut:], 8, init=(res.m[cut - 1], res.P[cut - 1])),
            smooth=jblocked.blocked_smooth(
                head, Y[:cut], num_blocks=8,
                filter_result=jkalman.FilterResult(*(f[:cut] for f in res[:6]), res.ll),
                boundary=(lj.A[cut], res.mp[cut], res.Pp[cut], sm.ms[cut], sm.Ps[cut])),
            scan=jblocked.blocked_suffix_scan(E[:cut], g[:cut], L[:cut], 8,
                                              terminal=(scan[1][cut], scan[2][cut])),
        )
        Eh, gh, Lh = jblocked._smoother_elements_fast(
            head, jkalman.FilterResult(*(f[:cut] for f in res1[:6]), res1.ll),
            next_step=(lj.A[cut], res1.mp[cut], res1.Pp[cut]))
        hooks["draw"] = jblocked.ffbs_draw(Eh, gh, Lh, xi[:cut], 8, x_term=x[cut])
        return res, sm, scan, x, hooks

    out = jax.device_get(run(*(jnp.asarray(a) for a in (y, E, g, L, xi))))
    return dict(cut=cut, y=y, lt=lt, E=E, g=g, L=L, xi=xi, fused=out[:4], hooks=out[4])


@pytest.fixture(scope="module")
def carry_case():
    """``_jref_carry_case``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_carry_case)


@pytest.mark.parametrize("route", ["tensor", "kernels"])
def test_carry_hooks_match_jax(route, carry_case):
    """The segment carries of the blocked engine: ``blocked_filter(init=)``
    from the filtered state before the cut, ``blocked_suffix_scan(terminal=)``
    and ``blocked_smooth(boundary=)`` from the step after it, and FFBS's
    ``next_step``/``x_term``, each on one piece of a cut series against the
    JAX package's hook on the same inputs and against its fused pass over the
    whole series.

    * "tensor": float64 tensor code, two columns; 1e-9 of each output's
      scale.  The draws: 1e-9 against the port's fused draw, 1e-6 against
      the JAX package's (measured 2.5e-7): their elements' L_k cancel to a
      small part of P_k, so the port's, formed again from (A, Q), and the
      JAX package's, from its filter's predicted moments, part at that
      level (``test_ffbs_matches_jax``).
    * "kernels": the kernel route's plain versions in float32, one column
      (``decorrelate_blocked(init=)``, ``suffix_scan(terminal)``,
      ``pallas_smooth(boundary=)``, ``pallas_posterior_sample(next_step=,
      x_term=)``) against the JAX package's float64; 2e-5 of each output's
      scale (measured at most 1.1e-6)."""
    c = carry_case
    cut, lt, Y = c["cut"], c["lt"], c["y"]
    res, sm, scan, x = c["fused"]
    hooks = c["hooks"]
    if route == "tensor":
        tol = 1e-9
        head, tail = _lg_rows(lt, 0, cut), _lg_rows(lt, cut, len(Y))
        fr = tblocked.blocked_filter(tail, _t(Y[cut:]), 8, init=(_t(res.m[cut - 1]), _t(res.P[cut - 1])))
        for got, want, hook in zip(fr, res, hooks["filter"]):
            _near(got, want[cut:] if np.ndim(want) and len(want) == len(Y) else hook, tol)
            _near(got, hook, tol)
        _, v, M = tblocked.blocked_suffix_scan(*(_t(a[:cut]) for a in (c["E"], c["g"], c["L"])), 8,
                                               terminal=(_t(scan[1][cut]), _t(scan[2][cut])))
        for got, want, hook in ((v, scan[1], hooks["scan"][1]), (M, scan[2], hooks["scan"][2])):
            _near(got, want[:cut], tol)
            _near(got, hook, tol)
        head_res = tkalman.FilterResult(*(_t(f[:cut]) for f in res[:6]), _t(res.ll))
        st = tblocked.blocked_smooth(head, _t(Y[:cut]), filter_result=head_res, num_blocks=8,
                                     boundary=tuple(_t(a) for a in (lt.A[cut], res.mp[cut], res.Pp[cut],
                                                                    sm.ms[cut], sm.Ps[cut])))
        for name in ("mean", "var", "ms", "Ps"):
            _near(getattr(st, name), getattr(sm, name)[:cut], tol)
            _near(getattr(st, name), getattr(hooks["smooth"], name), tol)
        m1, P1 = res.m[:, :, :1], res.P
        mp1, Pp1 = lt.A[cut] @ _t(m1[cut - 1]), lt.A[cut] @ _t(P1[cut - 1]) @ lt.A[cut].T + lt.Q[cut]
        x_t = tblocked.sample_from_moments(lt, _t(m1[:, :, 0]), _t(P1), _t(c["xi"]), 8)
        xs = tblocked.sample_from_moments(head, _t(m1[:cut, :, 0]), _t(P1[:cut]), _t(c["xi"][:cut]), 8,
                                          next_step=(lt.A[cut], mp1, Pp1), x_term=x_t[cut])
        _near(xs, x_t[:cut], tol)
        for want in (x[:cut], hooks["draw"]):
            _near(xs, want, 1e-6)
        return
    f32, tol = torch.float32, 2e-5
    head, tail = _lg_rows(lt, 0, cut, f32), _lg_rows(lt, cut, len(Y), f32)
    y32 = _t(Y[:, 0], f32)
    init = (_t(res.m[cut - 1, :, 0], f32), _t(res.P[cut - 1], f32))
    out = tops_kalman.decorrelate_blocked(tail, y32[cut:], return_full=True, init=init)
    ll_j = -0.5 * np.sum(np.log(2 * np.pi) + np.log(res.S[cut:]) + res.v[cut:, 0] ** 2 / res.S[cut:])
    _close(out[0], ll_j, rtol=tol)
    for got, want in ((out[1], res.v[cut:, 0] / np.sqrt(res.S[cut:])), (out[5], res.m[cut:, :, 0]),
                      (out[6], res.P[cut:])):
        _near(got, want, tol)
    E32, g32, L32 = (_t(a[:cut], f32) for a in (c["E"], c["g"], c["L"]))
    v, M = tops_smoother.suffix_scan(E32, g32, L32, (_t(scan[1][cut], f32), _t(scan[2][cut], f32)))
    _near(v, scan[1][:cut], tol)
    _near(M, scan[2][:cut], tol)
    boundary = tuple(_t(a, f32) for a in (lt.A[cut], res.mp[cut, :, 0], res.Pp[cut], sm.ms[cut, :, 0],
                                          sm.Ps[cut]))
    fm, fv, _, ms, Ps, _ = tops_smoother.pallas_smooth(head, y32[:cut], return_state=True,
                                                       boundary=boundary)
    _near(fm, sm.mean[:cut, 0], tol)
    _near(fv, sm.var[:cut], tol)
    _near(ms, sm.ms[:cut, :, 0], tol)
    _near(Ps, sm.Ps[:cut], tol)
    mp1 = (lt.A[cut] @ _t(res.m[cut - 1, :, :1]))[:, 0]
    Pp1 = lt.A[cut] @ _t(res.P[cut - 1]) @ lt.A[cut].T + lt.Q[cut]
    f = tops_smoother.pallas_posterior_sample(None, head, y32[:cut], 3, xi=_t(c["xi"][:cut], f32),
                                              next_step=(lt.A[cut], mp1, Pp1), x_term=_t(x[cut], f32))
    _near(f, np.swapaxes(x[:cut, 0, :], 0, 1), tol)


def _seams(n, seg):
    """Rows on both sides of every seam."""
    return sorted({r for s in range(seg, n, seg) for r in (s - 1, s)})


_SEG_CASES = [
    ("Matern52", 120, 40),  # also against the JAX segmented engine
    ("Matern12", 64, 7),  # d = 1; ragged, the last segment of one step
    ("Matern52", 40, 1),  # segments of one step
    ("Matern52", 137, 400),  # one segment longer than the series
]


def _jref_seg_refs():
    """The JAX package's sequential filter and smoother for the cases of
    ``test_segmented_engine_matches_jax``, and its segmented engine on the
    first (120 steps in segments of 40)."""
    refs = {}
    for name, n, _ in _SEG_CASES:
        _, y, _, _, lj, _ = _seg_case(name, n)
        Y3 = np.random.default_rng(3).normal(size=(n, 3))
        refs[name, n] = jax.device_get(jax.jit(lambda y, Y3, lj=lj: (
            jkalman.kalman_filter(lj, y), jkalman.rts_smooth(lj, y),
            jkalman.kalman_filter(lj, Y3)))(jnp.asarray(y), jnp.asarray(Y3)))
    _, y, _, _, lj, _ = _seg_case("Matern52", 120)
    yj = jnp.asarray(y)
    refs["segmented"] = jax.device_get(dict(
        filter=jseg.segmented_filter(lj, yj, 40, 8), logpdf=jseg.segmented_logpdf(lj, yj, 40, 8),
        decorrelate=jseg.segmented_decorrelate(lj, yj, 40, 8),
        smooth=jseg.segmented_smooth(lj, yj, 40, 8)))
    return refs


@pytest.fixture(scope="module")
def seg_refs():
    """``_jref_seg_refs``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_seg_refs)


@pytest.mark.parametrize("name,n,seg", _SEG_CASES)
def test_segmented_engine_matches_jax(name, n, seg, seg_refs):
    """``segmented_filter``, ``segmented_logpdf``, ``segmented_decorrelate``,
    ``segmented_smooth`` (float64, 8 blocks) against the JAX package's
    sequential filter and smoother, and in the first case against its
    segmented engine: 1e-9 of each output's scale everywhere, the seams
    included (measured 2e-15); three columns through the filter."""
    t, y, _, _, lj, lt = _seg_case(name, n)
    kf, rs, kf3 = seg_refs[name, n]
    out = tseg.segmented_filter(lt, _t(y), seg, 8)
    rows = _seams(n, seg)
    for got, want in zip(out, kf):
        _near(got, want, 1e-9)
        if rows and len(want) == n:
            _near(_np(got)[rows], np.asarray(want)[rows], 1e-9)
    _near(tseg.segmented_logpdf(lt, _t(y), seg, 8), kf.ll[0], 1e-12)
    ll, alpha = tseg.segmented_decorrelate(lt, _t(y), seg, 8)
    _near(alpha, kf.v[:, 0] / np.sqrt(kf.S), 1e-9)
    _near(ll, kf.ll[0], 1e-12)
    sm = tseg.segmented_smooth(lt, _t(y), seg, 8)
    for f in ("mean", "var", "ms", "Ps", "ll"):
        _near(getattr(sm, f), getattr(rs, f), 1e-9)
    Y3 = np.random.default_rng(3).normal(size=(n, 3))
    for got, want in zip(tseg.segmented_filter(lt, _t(Y3), seg, 8), kf3):
        _near(got, want, 1e-9)
    if (name, n, seg) == _SEG_CASES[0]:
        js = seg_refs["segmented"]
        for got, want in zip(out, js["filter"]):
            _near(got, want, 1e-9)
        _near(tseg.segmented_logpdf(lt, _t(y), seg, 8), js["logpdf"], 1e-12)
        _near(alpha, js["decorrelate"][1], 1e-9)
        for f in ("mean", "var", "ms", "Ps"):
            _near(getattr(sm, f), getattr(js["smooth"], f), 1e-9)


def _jref_seg_grad_refs():
    """JAX references of the gradient cases at n = 130: the one-shot
    closed-form gradient and the JAX ``make_segmented_nll_grad`` in
    segments of 65."""
    from gpar_at_scale_tpu.ssm import blocked_grad as jbg

    n = 130
    t, y, _, _, lj, _ = _seg_case("Matern52", n)
    p0 = jnp.asarray([0.2, -0.1, -1.5])

    def kernel_fn(p):
        return jk.Matern52(lengthscale=jnp.exp(p[0]), variance=jnp.exp(p[1])), jnp.exp(p[2])

    R = jnp.broadcast_to(lj.R, (n,))

    @jax.jit
    def one_shot(y):
        ll, aux = jbg.loglik_fwd_aux(lj.A, lj.Q, R, lj.H, y, num_blocks=8)
        return ll, jbg.loglik_bwd(lj.A, lj.Q, R, lj.H, aux, num_blocks=8)

    yj = jnp.asarray(y)
    ll, cts = jax.device_get(one_shot(yj))
    return dict(ll=ll, cts=cts, nll_grad=jax.device_get(
        jseg.make_segmented_nll_grad(kernel_fn, jnp.asarray(t), yj, 65, 8)(p0)))


@pytest.fixture(scope="module")
def seg_grad_refs():
    """``_jref_seg_grad_refs``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_seg_grad_refs)


@pytest.mark.parametrize("seg", [41, 65, 1, 400])
def test_segmented_gradients_match_jax(seg, seg_grad_refs):
    """``segmented_loglik_grad`` (ll, dA, dQ, dR, dy) against the JAX
    package's one-shot closed-form gradient, and ``make_segmented_nll_grad``
    (each segment discretized on its own, its pullback by
    ``torch.autograd.grad``) against ``torch.autograd`` of the port's fused
    ``blocked_logpdf`` and, in segments of 65, against the JAX
    ``make_segmented_nll_grad``; n = 130 (segments of 41: ragged), float64,
    8 blocks: 1e-9 of each output's scale (measured 1e-15)."""
    n = 130
    t, y, _, _, _, lt = _seg_case("Matern52", n)
    r = seg_grad_refs
    got = tseg.segmented_loglik_grad(lt, _t(y), seg, 8)
    _near(got[0], r["ll"], 1e-12)
    for a, b in zip(got[1:], r["cts"]):
        _near(a, b, 1e-9)

    def kernel_fn(p):
        return tk.Matern52(lengthscale=torch.exp(p[0]), variance=torch.exp(p[1])), torch.exp(p[2])

    p0 = _t([0.2, -0.1, -1.5])
    ll, g = tseg.make_segmented_nll_grad(kernel_fn, _t(t), _t(y), seg, 8)(p0)
    p = p0.clone().requires_grad_(True)
    k, nv = kernel_fn(p)
    ll_t = tblocked.blocked_logpdf(tmarkov.lgssm_of(k, _t(t), nv), _t(y), 8)
    ll_t.backward()
    wants = [(ll_t.detach(), p.grad)] + ([r["nll_grad"]] if seg == 65 else [])
    for want_ll, want_g in wants:
        _near(ll, want_ll, 1e-12)
        _near(g, want_g, 1e-9)


def test_segmented_t_variants_match_jax():
    """Per-segment discretization from the time grid (``segmented_filter_t``,
    ``segmented_decorrelate_t``, ``segmented_smooth_t``; 120 steps in
    segments of 40, of 43 (the last of 34) and in one segment of 200)
    against the JAX package's sequential filter and smoother on the whole
    series' LGSSM, and in segments of 40 against its ``_t`` variants,
    float64: 1e-9 of each output's scale."""
    n = 120
    t, y, kj, kt, lj, _ = _seg_case("Matern52", n)
    tj, yj = jnp.asarray(t), jnp.asarray(y)
    ref_f, ref_s = jax.device_get(jax.jit(lambda y: (jkalman.kalman_filter(lj, y),
                                                      jkalman.rts_smooth(lj, y)))(yj))
    seg_j = jax.device_get((jseg.segmented_filter_t(kj, tj, 0.1, yj, 40, 8),
                            jseg.segmented_decorrelate_t(kj, tj, 0.1, yj, 40, 8),
                            jseg.segmented_smooth_t(kj, tj, 0.1, yj, 40, 8)))
    fused = (ref_f, (ref_f.ll[0], ref_f.v[:, 0] / np.sqrt(ref_f.S)), ref_s)
    for seg in (40, 43, 200):
        f = tseg.segmented_filter_t(kt, _t(t), 0.1, _t(y), seg, 8)
        ll, alpha = tseg.segmented_decorrelate_t(kt, _t(t), 0.1, _t(y), seg, 8)
        s = tseg.segmented_smooth_t(kt, _t(t), 0.1, _t(y), seg, 8)
        for want_f, want_d, want_s in (fused, seg_j) if seg == 40 else (fused,):
            for a, b in zip(f, want_f):
                _near(a, b, 1e-9)
            _near(ll, want_d[0], 1e-12)
            _near(alpha, want_d[1], 1e-9)
            for name in ("mean", "var", "ms", "Ps"):
                _near(getattr(s, name), getattr(want_s, name), 1e-9)
    assert f.m.shape == (n, 3, 1) and s.mean.shape == (n,)


def _jref_sum_kernel_refs():
    """The JAX package's sequential filter and smoother and one-shot loglik
    gradient of a sum-kernel SDE (Matern-1/2 + Matern-3/2, d = 3,
    H = [1, 1, 0]) over 77 steps."""
    from gpar_at_scale_tpu.ssm import blocked_grad as jbg

    n = 77
    t, y, _, _, lj, lt = _seg_case("Matern12+Matern32", n)
    R = jnp.broadcast_to(lj.R, (n,))

    @jax.jit
    def refs(y):
        _, aux = jbg.loglik_fwd_aux(lj.A, lj.Q, R, lj.H, y)
        return jkalman.kalman_filter(lj, y), jkalman.rts_smooth(lj, y), jbg.loglik_bwd(
            lj.A, lj.Q, R, lj.H, aux)

    return y, lt, jax.device_get(refs(jnp.asarray(y)))


@pytest.fixture(scope="module")
def sum_kernel_refs():
    """``_jref_sum_kernel_refs``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_sum_kernel_refs)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_segmented_sum_kernel_general_H(dtype, sum_kernel_refs, monkeypatch):
    """A sum-kernel SDE in segments of 30 over 77 steps takes the tensor
    code in both precisions: in float32 no scan kernel's wrapper is called
    (they raise here).  Against the JAX package's sequential filter and
    smoother (float64): 1e-9 of each output's scale in float64, 2e-5 in
    float32 (measured 2.2e-7); the loglik gradient against the JAX one-shot
    one, 1e-9 and 1e-4 (float32 measured 4e-6)."""
    y, lt, (kf, rs, cts) = sum_kernel_refs
    dt = getattr(torch, dtype)
    lg = _lg_rows(lt, 0, len(y), dt)
    assert not tops_kalman.pallas_supported(lg)

    def refuse(*_a, **_k):
        raise AssertionError("a scan kernel's wrapper was called")

    for mod, name in ((tops_kalman, "phase1"), (tops_kalman, "phase3"),
                      (tops_smoother, "suffix_reduce"), (tops_smoother, "suffix_replay")):
        monkeypatch.setattr(mod, name, refuse)
    tol = 1e-9 if dtype == "float64" else 2e-5
    out = tseg.segmented_filter(lg, _t(y, dt), 30, 8)
    for f in ("m", "P", "S", "v"):
        _near(getattr(out, f), getattr(kf, f), tol)
    _near(out.ll, kf.ll, tol)
    sm = tseg.segmented_smooth(lg, _t(y, dt), 30, 8)
    _near(sm.mean, rs.mean, tol)
    _near(sm.var, rs.var, tol)
    got = tseg.segmented_loglik_grad(lg, _t(y, dt), 30, 8)
    for a, b in zip(got[1:], cts):
        _near(a, b, 1e-9 if dtype == "float64" else 1e-4)


def _jref_sample_refs():
    """The JAX FFBS test's case (Matern-3/2, n = 60, 4 draws on fixed
    normals): the JAX package's blocked draw, and its segmented draw in
    segments of 20."""
    n, S = 60, 4
    t, y, _, _, _, _ = _seg_case("Matern32", n)
    y = np.sin(2 * t) + np.random.default_rng(5).normal(size=n) * np.sqrt(0.1)
    lj = jmarkov.lgssm_of(jk.Matern32(lengthscale=0.8, variance=1.2), jnp.asarray(t), 0.1)
    xi = np.random.default_rng(6).normal(size=(n, 2, S))
    yj, xij = jnp.asarray(y), jnp.asarray(xi)
    blk = jax.jit(lambda y, xi: jblocked.blocked_posterior_sample(None, lj, y, S, 8, xi=xi))(yj, xij)
    seg = jseg.segmented_posterior_sample(None, lj, yj, S, 20, 8, xi=xij)
    return t, y, xi, np.asarray(blk), np.asarray(seg)


@pytest.fixture(scope="module")
def sample_refs():
    """``_jref_sample_refs``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_sample_refs)


@pytest.mark.parametrize("seg", [17, 20, 60, 1])
def test_segmented_posterior_sample_matches_jax(seg, sample_refs):
    """``segmented_posterior_sample`` given xi against the JAX package's
    blocked draw on the same xi (and its segmented draw at 20): 1e-9 of the
    largest value, as the JAX test holds its own (measured 1e-15); the
    float32 kernel route (K1/K2 and K4a/K4b, plain versions on the CPU, one
    float32 segment's elements formed in float64) within 2e-5 of it
    (measured 1.6e-6)."""
    t, y, xi, blk, seg_j = sample_refs
    kt = tk.Matern32(lengthscale=_t(0.8), variance=_t(1.2))
    lt = tmarkov.lgssm_of(kt, _t(t), 0.1, F64)
    f = tseg.segmented_posterior_sample(None, lt, _t(y), 4, seg, 8, xi=_t(xi))
    assert f.shape == (4, 60)
    _near(f, blk, 1e-9)
    if seg == 20:
        _near(f, seg_j, 1e-9)
    f32 = torch.float32
    f_k = tseg.segmented_posterior_sample(None, _lg_rows(lt, 0, 60, f32), _t(y, f32), 4, seg,
                                          xi=_t(xi, f32))
    _near(f_k, blk, 2e-5)
    with pytest.raises(ValueError, match="one observation column"):
        tseg.segmented_posterior_sample(None, lt, _t(np.stack([y, y], 1)), 4, seg, xi=_t(xi))


def _jref_mixed_refs():
    """The JAX mixed-column test's case (n = 60, here M = 9) at the DTC bound's
    cotangent: the JAX package's direct backward, its cotangent factor and
    its mixed sums in chunks of 5 plus the ld part."""
    from gpar_at_scale_tpu.ssm import blocked_grad as jbg

    rng = np.random.default_rng(0)
    n, m = 60, 9
    t = np.sort(rng.uniform(0, 6, size=n))
    X = rng.normal(size=(n, 2))
    y = np.sin(t) + 0.3 * rng.normal(size=n)
    Z = X[np.linspace(0, n - 1, m).astype(int)]
    out_k = jk.Matern52(lengthscale=0.9, variance=1.2)
    lj = jmarkov.lgssm_of(jk.Matern52(lengthscale=0.7, variance=1.0), jnp.asarray(t), 0.09,
                          jnp.float64)
    U = jnp.concatenate([jnp.asarray(y)[:, None], out_k(jnp.asarray(X), jnp.asarray(Z))], axis=1)
    Kuu = out_k(jnp.asarray(Z), jnp.asarray(Z)) + 0.09 * jnp.eye(m)
    R = jnp.broadcast_to(lj.R, (n,))

    def bound(G, logdet, Kuu):
        g, Gb = G[1:, 0], G[1:, 1:]
        L_uu, L_P = jnp.linalg.cholesky(Kuu), jnp.linalg.cholesky(Gb + Kuu)
        wp = jax.scipy.linalg.solve_triangular(L_P, g, lower=True)
        ld = lambda L: 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))  # noqa: E731
        return -0.5 * (n * 1.8378770664093453 + logdet + ld(L_P) - ld(L_uu) + G[0, 0]
                       - jnp.sum(wp**2))

    @jax.jit
    def direct(U):
        G, logdet, aux = jbg.whiten_fwd_aux(lj.A, lj.Q, R, lj.H, U, num_blocks=8)
        ct_G, ct_ld = jax.grad(bound, argnums=(0, 1))(G, logdet, Kuu)
        return ct_G, ct_ld, jbg.whiten_bwd(lj.A, lj.Q, R, lj.H, aux, ct_G, ct_ld, num_blocks=8)

    ct_G, ct_ld, ref = jax.device_get(direct(U))
    F = jbg.cotangent_factor(ct_G)
    chunk = jax.jit(lambda Fk: jbg.whiten_bwd_mixed_chunk(lj.A, lj.Q, R, lj.H, U, Fk, num_blocks=8))
    ld_part = jax.jit(lambda c: jbg.whiten_bwd_ld_part(lj.A, lj.Q, R, lj.H, c, num_blocks=8))
    sums = list(ld_part(ct_ld)) + [0.0]
    for j in range(0, m + 1, 5):
        sums = [a + b for a, b in zip(sums, chunk(jnp.asarray(F[:, j:j + 5])))]
    return dict(t=t, U=np.asarray(U), ct_G=ct_G, ct_ld=float(ct_ld), ref=ref, F=F,
                sums=jax.device_get(sums))


@pytest.fixture(scope="module")
def mixed_refs():
    """``_jref_mixed_refs``, computed away from this worker (``_jax_ref``)."""
    return _jax_ref(_jref_mixed_refs)


@pytest.mark.parametrize("chunk", [1, 5, 10])
def test_mixed_backward_matches_jax(chunk, mixed_refs):
    """The mixed-column backward: ``cotangent_factor`` against the JAX
    package's (and -F F^T = sym(ct_G), 1e-11 of its scale); the chunks of
    ``whiten_bwd_mixed_chunk`` of widths 1, 5 and M + 1 plus
    ``whiten_bwd_ld_part`` against the port's ``whiten_bwd``, the JAX
    package's and its mixed sums in chunks of 5, float64: 1e-9 of each
    cotangent's scale (measured 5e-12, the factor's ridge).  The kernel
    route (``ops.grad``, float32 plain versions: the gain pass once, K3 and
    a K-column suffix scan per chunk) against the JAX float64 backward
    within 2e-5 of each scale (measured 1.1e-6), and ``MixedWhitenGram``'s
    gradient against ``WhitenGram``'s through the same float32 forward,
    2e-5 (measured 6.5e-7)."""
    r = mixed_refs
    lt = tmarkov.lgssm_of(tk.Matern52(lengthscale=_t(0.7), variance=_t(1.0)), _t(r["t"]), 0.09, F64)
    n = lt.num_steps
    A, Q, R, H, U = lt.A, lt.Q, lt.R.expand(n), lt.H, _t(r["U"])
    F = tblocked_grad.cotangent_factor(r["ct_G"])
    _near(F, r["F"], 1e-12)
    _near(-(F @ F.T), _sym(np.asarray(r["ct_G"])), 1e-11)
    _, _, aux = tblocked_grad.whiten_fwd_aux(A, Q, R, H, U)
    own = tblocked_grad.whiten_bwd(A, H, aux, _t(r["ct_G"]), r["ct_ld"])
    acc = list(tblocked_grad.whiten_bwd_ld_part(A, Q, R, H, r["ct_ld"])) + [torch.zeros_like(U)]
    for j in range(0, F.shape[1], chunk):
        for i, part in enumerate(tblocked_grad.whiten_bwd_mixed_chunk(A, Q, R, H, U,
                                                                      _t(F[:, j:j + chunk]))):
            acc[i] = acc[i] + part
    for got, a, b, c in zip(acc, own, r["ref"], r["sums"]):
        _near(got, a, 1e-9)
        _near(got, b, 1e-9)
        _near(got, c, 1e-9)
    if chunk != 5:
        return
    f32 = torch.float32
    A32, Q32, R32, U32 = (x.to(f32).contiguous() for x in (A, Q, R, U))
    gains = tops_grad.gain_pass(A32, Q32, R32)
    acc = list(tops_grad.whiten_bwd_ld_part(A32, r["ct_ld"], gains)) + [torch.zeros_like(U32)]
    for j in range(0, F.shape[1], chunk):
        for i, part in enumerate(tops_grad.whiten_bwd_mixed_chunk(A32, U32, _t(F[:, j:j + chunk], f32),
                                                                  gains)):
            acc[i] = acc[i] + part
    for got, want in zip(acc, r["ref"]):
        _near(got, want, 2e-5)
    ct_G = _t(r["ct_G"])
    grads = []
    for fn, extra in ((tops_grad.WhitenGram.apply, ()), (tops_grad.MixedWhitenGram.apply, (chunk,))):
        leaves = [x.clone().requires_grad_(True) for x in (A32, Q32, R32, U32)]
        G, logdet = fn(*leaves, *extra)
        ((G * ct_G).sum() + r["ct_ld"] * logdet).backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        _near(a, b, 2e-5)


# ---------------------------------------------------------------------------
# The run-support modules: data/native_io.py, utils/{checkpoint,observability,
# resilience}.py, kernels.scaled
# ---------------------------------------------------------------------------

_BAD_CSVS = {
    # tests/test_vi_native.py's bad cells: an empty and a text cell
    "bad_cells": "x,y\n1.5,2.5\n,3.5\nfoo,4.5\n",
    # an EEG CSV with a text time column, one empty channel cell, a short
    # row, a blank line and quoted header names
    "eeg_text_time": (
        '"time",F3,F4,F5,F6,FZ,F1,F2\n'
        "0:00,1,2,3,4,5,6,7\n"
        "0:01,1.5,,3.5,4.5,5.5,6.5,7.5\n"
        "\n"
        "0:02,2,3,4\n"
    ),
}


@pytest.mark.parametrize("name", sorted(_BAD_CSVS))
def test_read_csv_matches_jax_python_reader(name, tmp_path):
    """data/native_io.py::read_csv against the JAX package's Python reader
    (``_read_csv_python``, not its native parser, which shifts a row after
    a text cell): the same array, NaN where a cell is text or empty or a
    row is short, the same names; the port's load_eeg_csv reads the EEG
    file with NaN in those places instead of raising."""
    from gpar_at_scale_tpu.data.native_io import _read_csv_python
    from gpar_at_scale_torch.data import eeg as teeg
    from gpar_at_scale_torch.data.native_io import native_available, read_csv

    path = tmp_path / f"{name}.csv"
    path.write_text(_BAD_CSVS[name])
    got, names = read_csv(str(path))
    want, want_names = _read_csv_python(str(path))
    assert names == want_names and got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)  # NaN in the same places
    assert not native_available()
    if name == "eeg_text_time":
        assert np.isnan(got[:, 0]).all() and np.isnan(got[1, 2]) and np.isnan(got[2, 5:]).all()
        ds = teeg.load_eeg_csv(str(path))
        assert ds.Y.shape == (3, 7) and np.isnan(ds.Y[1, 1]) and np.isnan(ds.Y[2, 3:]).all()
        np.testing.assert_array_equal(ds.Y[0], np.arange(1.0, 8.0))
        np.testing.assert_array_equal(ds.t, np.arange(1, 4) / 256.0)
    else:
        assert np.isnan(got[1, 0]) and np.isnan(got[2, 0])
        np.testing.assert_array_equal(got[:, 1], [2.5, 3.5, 4.5])


def test_checkpoint_roundtrip_and_latest_step(tmp_path):
    """tests/test_aux.py's round trip on the port: two steps saved,
    ``latest_step`` the higher one, each restored into ``like``'s
    structure (a named tuple too), devices and dtypes; no ``.tmp`` is
    left behind, and a step that exists is not overwritten when asked not
    to be."""
    from gpar_at_scale_torch.inference.optimize import AdamState
    from gpar_at_scale_torch.utils import latest_step, restore_checkpoint, save_checkpoint

    tree = {"params": torch.arange(5.0),
            "opt": AdamState(mu=torch.ones(2, 3), nu=torch.zeros(2, 3), count=torch.tensor(7))}
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    save_checkpoint(d, 3, tree)
    plus = {"params": tree["params"] + 1,
            "opt": AdamState(mu=tree["opt"].mu + 1, nu=tree["opt"].nu, count=tree["opt"].count + 1)}
    path = save_checkpoint(d, 10, plus)
    assert path.endswith("step_0000000010") and latest_step(d) == 10
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "ckpt").iterdir())
    like = {"params": torch.zeros(5, dtype=F64),
            "opt": AdamState(mu=torch.zeros(2, 3), nu=torch.zeros(2, 3), count=torch.tensor(0))}
    restored = restore_checkpoint(d, like=like)
    assert isinstance(restored["opt"], AdamState) and restored["params"].dtype == F64
    _close(restored["params"], np.arange(5.0) + 1, rtol=0)
    assert int(restored["opt"].count) == 8
    _close(restore_checkpoint(d, step=3)["params"], np.arange(5.0), rtol=0)
    with pytest.raises(FileExistsError):
        save_checkpoint(d, 3, tree, overwrite=False)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_metrics_logger_and_stage_timer(tmp_path):
    """tests/test_aux.py's MetricsLogger and stage_timer cases on the port,
    with the same JSONL records; profiler_trace writes a Chrome trace file
    and does nothing without a directory."""
    import json

    from gpar_at_scale_torch.utils import MetricsLogger, profiler_trace, stage_timer

    path = str(tmp_path / "metrics.jsonl")
    log = MetricsLogger(path=path)
    log.record("fit", step=1, nlml=12.5)
    log.record("fit", step=2, nlml=11.0)
    log.close()
    lines = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in lines] == [1, 2] and lines[1]["nlml"] == 11.0
    assert set(lines[0]) == {"event", "time", "step", "nlml"} and lines[0]["event"] == "fit"
    log = MetricsLogger()
    with stage_timer("matmul", logger=log) as h:
        x = torch.ones((200, 200))
        h["sync"] = x @ x
    assert log.records[0]["name"] == "matmul" and log.records[0]["seconds"] > 0
    assert h["seconds"] == log.records[0]["seconds"]
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with profiler_trace(None):
        pass


@pytest.fixture(scope="module")
def spans_of_a_fit_and_a_request():
    """A scaled fit (N = 256, M = 8, 3 Adam steps on the kernel path's
    plain versions) and one batched request (3 parameter sets, 20 + 10
    times), each under torch.profiler with the spans on: {"fit": ..,
    "request": ..} of (the span events, outermost first, each with the
    id of its enclosing span, and the host_syncs counter's delta)."""
    from torch.profiler import ProfilerActivity, profile

    from gpar_at_scale_torch.config import kernel_family
    from gpar_at_scale_torch.models import gpar as tgpar
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.utils import observability as obs

    g = torch.Generator().manual_seed(4)
    t = torch.sort(torch.rand(256, generator=g) * 25.0).values
    X = torch.stack([torch.sin(0.7 * t), torch.cos(0.23 * t)], 1)
    y = torch.sin(2.2 * t) + 0.5 * X[:, 0] + 0.25 * torch.randn(256, generator=g)
    fam = kernel_family("Matern52")
    cfg = tgpar.GPARConfig(time_family=fam, out_family=fam, backend="scaled", filter_impl="pallas",
                           num_pseudo_points=8, dtype=torch.float32, optimizer="adam",
                           max_opt_steps=3)
    x0 = torch.log(torch.tensor([0.5, 1.0, 1.0, 0.7, 0.2]) - 1e-3)
    ts, tq = torch.arange(20.0) / 8, 2.5 + torch.arange(10.0) / 8
    V, Vq = torch.randn(20, 2, generator=g), torch.randn(10, 2, generator=g)
    yv = torch.sin(3 * ts) + 0.1 * torch.randn(20, generator=g)
    tk, ok = fam(lengthscale=0.5, variance=1.0), fam(lengthscale=1.2, variance=0.8)
    qu = tdtc.compute_q_u(ok, lgssm_of(tk, ts, 0.01), V, V, yv, uu_ridge=0.01, filter_fn="dense",
                          time_kernel=tk, t=ts)
    b = torch.tensor([0.9, 1.0, 1.1])
    work = {
        "fit": lambda: tgpar.fit_conditional(None, t, X, y, cfg, init_params=x0, device=CPU),
        "request": lambda: tdtc.predict_scaled_batch(
            fam(lengthscale=1.2 * b, variance=0.8 * b), fam(lengthscale=0.5 * b, variance=b), qu,
            V, ts, yv, tq, Vq, 0.01 * b, dtype=F64),
    }
    out = {}
    for name, fn in work.items():
        before = obs.counts()["host_syncs"]
        with profile(activities=[ProfilerActivity.CPU]) as prof, obs.spans_on():
            fn()
        syncs = obs.counts()["host_syncs"] - before
        events = sorted((ev for ev in prof.events() if ev.name.startswith("gpar.")),
                        key=lambda ev: ev.time_range.start)
        tree = []
        for ev in events:
            up = ev.cpu_parent
            while up is not None and not up.name.startswith("gpar."):
                up = up.cpu_parent
            tree.append((ev.name, ev.id, None if up is None else up.id))
        out[name] = (tree, syncs)
    return out


def test_spans_name_the_stages_of_a_fit_and_a_request(spans_of_a_fit_and_a_request, tmp_path):
    """Off, span() is one shared no-op context and records nothing; under
    the profiler with the spans on, a scaled fit holds one gpar.fit with
    its sort, 3 steps and q(u), each step its six stages (the bound in two
    pieces: the L_uu factor and the bound itself) and the Gram's backward
    inside gpar.backward; a batched request holds gpar.request and its
    five stages.  profiler_trace writes the spans into its trace."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from gpar_at_scale_torch.utils import observability as obs, profiler_trace

    assert obs.span("gpar.a") is obs.span("gpar.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("gpar.a"):
            torch.ones(2) + 1
    assert not [ev for ev in prof.events() if ev.name.startswith("gpar.")]

    tree, _ = spans_of_a_fit_and_a_request["fit"]
    name_of = {i: n for n, i, _ in tree}
    children = {}
    for n, i, up in tree:
        children.setdefault(up, []).append(n)
    (fit_id,) = [i for n, i, _ in tree if n == "gpar.fit"]
    assert children[None] == ["gpar.fit"]
    assert children[fit_id] == ["gpar.fit.sort"] + ["gpar.step"] * 3 + ["gpar.fit.q_u"]
    steps = [i for n, i, up in tree if n == "gpar.step"]
    for i in steps:
        assert children[i] == ["gpar.discretize", "gpar.output_kernel", "gpar.whiten_gram",
                               "gpar.bound", "gpar.bound", "gpar.backward", "gpar.update"]
    inner = [name_of[up] for n, _, up in tree if n == "gpar.whiten_gram.backward"]
    assert inner == ["gpar.backward"] * 3

    tree, _ = spans_of_a_fit_and_a_request["request"]
    assert [(n, up is None) for n, _, up in tree] == [("gpar.request", True)] + [
        (f"gpar.request.{s}", False) for s in ("splice", "kernels", "shared_solves", "condition",
                                                "moments")]

    with profiler_trace(str(tmp_path / "trace")):
        with obs.span("gpar.probe"):
            torch.ones(2) + 1
    assert '"gpar.probe"' in (tmp_path / "trace" / "trace.json").read_text()
    assert obs.span("gpar.a") is obs.span("gpar.b")  # off again after the block


def test_host_syncs_count_the_sites_a_fit_and_a_request_pass(spans_of_a_fit_and_a_request):
    """The host_syncs counter over the fit and the request of the spans'
    test: each Adam step passes the gradient norm's read-back, the sort
    check of the discretization, the time SDE's H row written from the
    host, the info checks of the K_uu and L_P factorizations, H = e1 in the
    Gram's forward (6, as on the card, where K5a/K5b need no H in the
    backward) and the plain K1 and K2's own e1 rows and the e1 row of the
    backward's plain K5a/K5b (3, on the CPU only); the fit adds the
    pseudo-points' indices and q(u)'s SDE row, sort check, e1 rows (3),
    K_uu and chol(Lam) info checks.  The request passes the splice's noise
    copied from the host and the batched factorization's info check."""
    assert spans_of_a_fit_and_a_request["fit"][1] == 3 * 9 + 8
    assert spans_of_a_fit_and_a_request["request"][1] == 2


def test_run_with_checkpointing_resumes(tmp_path):
    """tests/test_aux.py's resume case on the port: 7 steps with a
    checkpoint every 3, then a restart to 12 runs only the 5 left; and 10
    Adam steps interrupted after 5 end where an uninterrupted run does,
    bit for bit."""
    from gpar_at_scale_torch.inference.optimize import adam_init, adam_update
    from gpar_at_scale_torch.utils import run_with_checkpointing

    d = str(tmp_path / "ck")
    init = {"x": torch.tensor(0.0)}
    state, ran = run_with_checkpointing(lambda s, i: {"x": s["x"] + 1.0}, init, 7, d,
                                        checkpoint_every=3)
    assert float(state["x"]) == 7.0 and ran == 7
    state2, ran2 = run_with_checkpointing(lambda s, i: {"x": s["x"] + 1.0}, init, 12, d,
                                          checkpoint_every=3)
    assert float(state2["x"]) == 12.0 and ran2 == 5

    target = torch.tensor([0.3, -1.0, 2.0], dtype=F64)

    def adam_step(s, i):
        p, opt = s
        return adam_update(2.0 * (p - target), opt, p, 0.1)

    start = (torch.zeros(3, dtype=F64), adam_init(torch.zeros(3, dtype=F64)))
    whole, _ = run_with_checkpointing(adam_step, start, 10)
    d2 = str(tmp_path / "adam")
    run_with_checkpointing(adam_step, start, 5, d2, checkpoint_every=5)
    resumed, ran = run_with_checkpointing(adam_step, start, 10, d2, checkpoint_every=5)
    assert ran == 5 and int(resumed[1].count) == 10
    _close(resumed[0], _np(whole[0]), rtol=0)


def test_scaled_matches_jax(rng):
    """kernels.scaled against the JAX function: by sigma and by variance,
    with an extra argument (RQ's alpha)."""
    x, z = rng.normal(size=(6, 2)), rng.normal(size=(5, 2))
    for name, kw in (("Matern52", {}), ("RQ", {"alpha": 2.0})):
        jf, tf = _family(name)
        for args, kwargs in (((0.7, 1.3), {}), ((0.7,), {"variance": 2.1})):
            kj = jk.scaled(jf, *args, **kwargs, **kw)
            kt = tk.scaled(tf, *args, **kwargs, **kw)
            _close(kt(_t(x), _t(z)), kj(jnp.asarray(x), jnp.asarray(z)))


def test_initialize_distributed_without_launcher(monkeypatch):
    """initialize_distributed() with no launcher and no address does
    nothing and returns False, twice."""
    import torch.distributed as dist

    from gpar_at_scale_torch.parallel import initialize_distributed

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed() is False
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# parallel/: the sharded engines over 4 gloo ranks against the JAX package's
# sharded functions on a 4-device mesh.  The ranks run once for every case
# below (``dist_results``; their bodies are tests/_torch_ranks.py), and so
# do the JAX references, in a fresh process of their own
# (tests/_jax_dist_refs.py): this worker already holds the compile state of
# every earlier case, and XLA:CPU crashes at a position in a long process
# (gpar_tpu_testenv.py).
# ---------------------------------------------------------------------------

_SEQ_NS = (37, 130)  # spans of 10/9/9/9 and 33/33/32/32 steps on 4 ranks
_SEQ_PARAMS = (np.log(0.7), np.log(1.3), np.log(0.1))


def _dist_case():
    """The inputs of every parallel case, numpy, from fixed seeds."""
    case = {"seq_ns": _SEQ_NS, "seq_params": np.asarray(_SEQ_PARAMS)}
    for n in _SEQ_NS:
        rng = np.random.default_rng(n)
        case[f"seq_t{n}"] = np.sort(rng.uniform(0.0, 3.0, n))
        case[f"seq_Y{n}"] = rng.normal(size=(n, 3))
    rng = np.random.default_rng(1)  # tests/test_modelshard.py's problem, n = 64, M = 8
    n, m = 64, 8
    t = np.sort(rng.uniform(0, 6, size=n))
    V = rng.normal(size=(n, 2))
    case.update(model_t=t, model_V=V, model_y=np.sin(t) + 0.3 * rng.normal(size=n),
                model_Z=V[np.linspace(0, n - 1, m).astype(int)],
                model_params=_np(tparams.pack_gpar(*map(_t, (0.7, 1.05, 0.9, 1.15, 0.3)))))
    rng = np.random.default_rng(2)  # tests/test_parallel.py's problem, n = 32, M = 6
    X = rng.normal(size=(32, 2))
    case.update(train_t=np.sort(rng.uniform(0, 4, size=32)), train_X=X,
                train_y=rng.normal(size=32), train_Z=X[:6],
                train_params=0.1 * np.random.default_rng(3).normal(size=(8, 5)))
    t_fit, Y_fit, _, _, _ = make_chain_data(40, 50, 5, np.random.default_rng(5))
    case.update(fit_t=t_fit, fit_Y=Y_fit)
    return case


def _dist_compute(store):
    """(case, the 4 gloo ranks' results, the JAX package's references): the
    ranks spawned here, the references in a fresh process beside them."""
    import multiprocessing

    from _jax_dist_refs import references
    from _torch_ranks import body

    from gpar_at_scale_torch.parallel.launch import run_ranks

    case = _dist_case()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(references, (case,))
        ranks = run_ranks(body, 4, case, init_file=str(store), backend="gloo", threads=1)
        refs = pending.get(timeout=600)
    return case, ranks, refs


class _Background:
    """fn(*args) in a thread started now; ``get`` joins it and returns its
    result or raises what it raised."""

    def __init__(self, fn, *args):
        import threading

        self.out = None
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.out = (True, fn(*args))
        except BaseException as exc:  # raised again in get()
            self.out = (False, exc)

    def get(self, timeout):
        self.thread.join(timeout)
        if self.out is None:
            raise TimeoutError(f"no result within {timeout} s")
        ok, value = self.out
        if not ok:
            raise value
        return value


@pytest.fixture(scope="module")
def dist_results(_late):
    """(case, the 4 ranks' results, the JAX package's references), from the
    thread ``_Late`` started."""
    _late.start()
    return _late.ranks.get(timeout=900)


@pytest.mark.parametrize("n", _SEQ_NS)
def test_sharded_filter_matches_jax(n, dist_results):
    """make_sharded_filter over 4 gloo ranks (uneven spans, float64, 3
    columns) against the JAX package's on a 4-device mesh (which pads the
    tail instead): filtered moments, S, innovations and ll within 1e-9 of
    each array's largest magnitude; rank 3 returns rank 0's result."""
    _, ranks, refs = dist_results
    got, want = ranks[0]["seq"][n], refs["seq"][n]
    for key in ("m", "P", "S", "v", "ll"):
        _near(got[key], want[key], 1e-9)
        np.testing.assert_array_equal(ranks[3]["seq"][n][key], got[key])


@pytest.mark.parametrize("n", _SEQ_NS)
def test_sharded_smoother_matches_jax(n, dist_results):
    """make_sharded_smooth over 4 gloo ranks against the JAX package's:
    smoothed mean, variance, state moments and ll within 1e-9 of each
    array's largest magnitude."""
    _, ranks, refs = dist_results
    got, want = ranks[0]["seq"][n], refs["seq"][n]
    for key in ("mean", "var", "ms", "Ps", "sll"):
        _near(got[key], want[key], 1e-9)


@pytest.mark.parametrize("n", _SEQ_NS)
def test_sharded_logpdf_gradient_matches_jax(n, dist_results):
    """make_sharded_logpdf and its gradient in (log l, log variance, log
    noise) over 4 gloo ranks (the closed-form backward with the suffix scan
    split across the ranks) against jax.value_and_grad of the JAX
    package's: 1e-9 relative."""
    _, ranks, refs = dist_results
    got, want = ranks[0]["seq"][n], refs["seq"][n]
    _close(got["lp"], want["lp"], rtol=1e-9)
    _close(got["grad"], want["grad"], rtol=1e-9)
    np.testing.assert_array_equal(ranks[2]["seq"][n]["grad"], got["grad"])


def test_modelsharded_objective_and_gradient_match_jax(dist_results):
    """make_modelsharded_nlml over a 4-rank "model" axis (M = 8, two
    pseudo-points a rank) and its gradient (the mixed-column backward, the
    ranks' columns as chunks) against the JAX package's on a 4-device mesh
    (tests/test_modelshard.py's problem): 1e-8 relative; an M the axis
    does not divide raises ValueError."""
    _, ranks, refs = dist_results
    got = ranks[0]["model"]
    _close(got["value"], refs["model"]["value"], rtol=1e-8)
    _close(got["grad"], refs["model"]["grad"], rtol=1e-8)
    np.testing.assert_array_equal(ranks[1]["model"]["grad"], got["grad"])
    assert all(r["model"]["indivisible_raises"] for r in ranks)


def test_sharded_train_step_matches_jax(dist_results):
    """make_sharded_train_step on a (chain 2, data 2) mesh of 4 gloo ranks
    (each rank 4 chains and half of the time axis: the Gram through the
    time-sharded filter), 2 Adam steps of 8 chains, float64, against the
    JAX package's step on a (2, 2) mesh: every chain's losses and the
    final parameters within 1e-8 relative."""
    _, ranks, refs = dist_results
    got = [r["train"] for r in ranks]
    _close(got[0]["losses"], refs["train"]["losses"], rtol=1e-8)
    params = np.concatenate([got[0]["params"], got[2]["params"]])  # chain ranks 0 and 1
    _close(params, refs["train"]["params"], rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(got[1]["params"], got[0]["params"])  # data ranks agree


def test_fit_gpar_mesh_matches_unsharded(dist_results):
    """fit_gpar(mesh=) with the 4 conditionals of a 5-output chain split
    over a chain axis of 2 ranks (N = 40, M = 8, 3 Adam steps, float64,
    starts drawn from one generator): every rank returns the unsharded
    fit's parameters and q(u), bit for bit (the unsharded fit is held to
    the JAX package by test_parallel_fit_matches_jax)."""
    _, ranks, _ = dist_results
    assert all(r["fit"]["same"] and r["fit"]["count"] == 4 for r in ranks)


_UNSHARDED = ("filter", "smooth", "logpdf", "decorrelate_f32", "smooth_f32", "logpdf_f32",
              "gram_f32", "modelshard")


@pytest.mark.parametrize("name", _UNSHARDED)
def test_sharded_at_mesh_size_one_is_unsharded(name, dist_results):
    """On an axis of one rank each sharded function equals the port's
    unsharded engine bit for bit (ranks of a (chain 4, data 1) mesh): the
    filter, smoother and logpdf with its gradient against the blocked
    engine (float64); decorrelate, smoother, logpdf and the Gram against
    the kernel path's ``decorrelate_blocked``, ``pallas_smooth``,
    ``lgssm_loglik`` and ``whiten_gram`` (float32, plain versions); the
    model-sharded bound against ``dtc_objective``."""
    _, ranks, _ = dist_results
    assert all(r["unsharded"][name] for r in ranks)


def test_sharded_forward_raises_on_grad(dist_results):
    """The sharded filter, decorrelate and smoother on the kernel route
    (float32) raise when an input requires grad: their moments come from
    the kernels and the collectives and have no backward."""
    _, ranks, _ = dist_results
    assert all(r["guard"] for r in ranks)


def test_make_mesh_sizes_must_match_the_world(dist_results):
    """make_mesh over 4 ranks: axis sizes whose product is not the world
    size raise ValueError (as the JAX make_mesh does for its devices)."""
    _, ranks, _ = dist_results
    assert all(r["sizes_raise"] for r in ranks)


# ---------------------------------------------------------------------------
# The drivers: gpar_at_scale_torch/examples/ and gpar_at_scale_torch/benchmarks/
# against the repo's scripts in examples/, benchmarks/ and bench.py.  The JAX
# side runs in 6 fresh processes at once (tests/_jax_example_refs.py; their
# compiles take the time), started when the worker is 40% through the file
# (``_Late``); the port's side runs in this worker, in the module fixture
# ``example_results``.  Steps are cut where the scripts
# fix them: 0 optimizer steps (every fit conditions on the script's starts)
# where the optimizer is L-BFGS, whose iterates are no parity target; 3 Adam
# steps (optax's Adam is the port's) where the script takes Adam.
# ---------------------------------------------------------------------------

_SCRIPT_GROUPS = (("chain",), ("eeg", "dtc"), ("scaled", "toy"), ("plot", "bench", "ess"),
                  ("million_dtc", "long_series"),
                  ("million_grad", "million_smc", "nuts_vs_smc", "pod_scaling"))
_CHAIN_SIZE = dict(N=600, P=3, M=4, steps=2, n_star=50)
# this slice's benchmarks at a cut size (the port's modules and the JAX
# scripts from the same numpy seeds)
_LONG = dict(dtc_N=2000, dtc_M=8, dtc_Nstar=200, grad_N=1500, grad_steps=3, long_N=2000,
             long_segment=700, smc_N=1000, smc_P=16, smc_mutations=2, smc_stages=3, ns_N=1000,
             pod_n=96, pod_outputs=3, weak_per_rank=2048)


def _example_case():
    from gpar_at_scale_torch.benchmarks import bench

    rng = np.random.default_rng(3)
    data = bench.bench_data("cpu", F64)
    return dict(
        toy_steps=0, plot_exact_steps=0, plot_steps=3, scaled_steps=3, bench_steps=3,
        bench_data={k: _np(v) for k, v in zip(("t", "t_star", "X", "X_star", "y"), data)},
        chain_argv=[str(_CHAIN_SIZE["N"]), f"--outputs={_CHAIN_SIZE['P']}",
                    f"--m={_CHAIN_SIZE['M']}", f"--steps={_CHAIN_SIZE['steps']}",
                    f"--nstar={_CHAIN_SIZE['n_star']}"],
        ess_u=0.3 * rng.normal(size=(3, 5)), ess_draws=rng.normal(size=(4, 60, 5)),
        **_LONG, smc_x0=_long_smc_x0(), smc_xs=0.4 * rng.normal(size=(4, 3)),
        ns_q=0.3 * rng.normal(size=(3, 3)), ns_nuts=0.2 * rng.normal(size=(2, 30, 3)),
        ns_smc=0.2 * rng.normal(size=(40, 3)) + 0.05, pod_q=0.3 * rng.normal(size=(3, 5)),
        weak_N=2 * _LONG["weak_per_rank"])


def _long_smc_x0():
    from gpar_at_scale_torch.benchmarks.million_smc import initial_particles

    return initial_particles(_LONG["smc_P"], 0)


def _quiet(fn, *args, **kwargs):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _port_scripts(case, only=None):
    """The port's side of every script case on the CPU (of the names in
    ``only`` if given), each entry the script's results or the exception it
    raised."""
    from gpar_at_scale_torch.benchmarks import bench, chain_scale, ess
    from gpar_at_scale_torch.data.eeg import load_eeg
    from gpar_at_scale_torch.data.toy import generate_small_dataset
    from gpar_at_scale_torch.examples import dtc_example, eeg, plot_examples, scaled_examples
    from gpar_at_scale_torch.examples import toy_example

    cpu = torch.device(CPU)

    def dtc():
        k, d, diff = _quiet(dtc_example.compare_dtc_with_dense, device=cpu)
        return dict(kalman=k, dense=d, diff=diff, dense_1e10=dtc_example.dense_dtc(uu_ridge=1e-10),
                    kalman_f32=dtc_example.kalman_dtc(device=cpu, dtype=torch.float32,
                                                      filter_fn="pallas"),
                    optimum=_quiet(dtc_example.compare_optimum_params, device=cpu, max_opt_steps=3))

    def plot():
        exact = _quiet(plot_examples.exact_example, device=cpu, max_opt_steps=case["plot_exact_steps"])
        temporal = _quiet(plot_examples.temporal_example, device=cpu, max_opt_steps=case["plot_steps"])
        return exact, temporal

    def eeg_chain():
        ds = load_eeg(None, seed=0)
        out = {"IGP": eeg.run_igp(ds, device=cpu, max_opt_steps=0)}
        for backend in ("exact", "scaled"):
            out[backend] = eeg.run(backend, ds, device=cpu, max_opt_steps=0)
        return ds, out

    def bench_run():
        steps = bench.ADAM_STEPS
        bench.ADAM_STEPS = case["bench_steps"]
        try:
            pipeline, _, _ = bench.bench_pipeline(cpu, F64)
            return pipeline()
        finally:
            bench.ADAM_STEPS = steps

    def ess_run():
        depth = ess.MAX_DEPTH
        ess.MAX_DEPTH = 3
        try:
            run = _quiet(ess.run, cpu, chains=2, num_samples=4, num_warmup=3)
        finally:
            ess.MAX_DEPTH = depth
        lp, _ = ess.eeg_logpost(cpu, F64)
        u = _t(case["ess_u"]).requires_grad_(True)
        v = lp(u)
        (g,) = torch.autograd.grad(v.sum(), u)
        return dict(run=run, value=v.detach(), grad=g, diag=ess.diagnostics(case["ess_draws"]))

    def million_dtc():
        from gpar_at_scale_torch.benchmarks import million_dtc as md

        prob = md.problem(case["dtc_N"], case["dtc_M"], case["dtc_Nstar"], cpu)
        p0 = md.start(cpu)
        G, logdet = md.whiten(prob, p0)
        mean, var, qu = md.predict(prob, p0)
        return dict(G=G, logdet=float(logdet), staged=md.staged_value_grad(*prob[:4], p0),
                    fused=md.dtc_value_grad(*prob[:4], p0, 0),
                    mixed=md.dtc_value_grad(*prob[:4], p0, 3), mean=mean, var=var,
                    reference=md.predict_reference(prob, p0, qu), check=md.check(prob),
                    run=_quiet(md.run, case["dtc_N"], case["dtc_M"], 2, case["dtc_Nstar"],
                               device=cpu))

    def million_grad():
        from gpar_at_scale_torch.benchmarks import million_grad as mg

        t_np, y_np = mg.million_grad_data(case["grad_N"])
        t, y = _t(t_np), _t(y_np)
        out = {}
        for route, dt in (("blocked", F64), ("fisher", F64), ("pallas", F32), ("seg-fisher", F64)):
            fn = mg.value_and_grad_fn(route, t, y, dt, segment=600)
            out[route] = fn(mg.start(cpu, dt))
        fn = mg.value_and_grad_fn("blocked", t, y, F64)
        out["adam"] = mg.optimize(fn, mg.start(cpu, F64), case["grad_steps"], case["grad_N"])
        out["run"] = _quiet(mg.run, case["grad_N"], 2, "pallas", device=cpu)
        return out

    def long_series():
        from gpar_at_scale_torch.benchmarks import long_series as ls

        return _quiet(ls.run, case["long_N"], ls.ROWS, device=cpu, reps=1,
                      segment=case["long_segment"])

    def million_smc():
        from gpar_at_scale_torch.benchmarks import million_smc as ms

        t_np, y_np, _ = ms.million_smc_data(case["smc_N"])
        t, y = _t(t_np, F32), _t(y_np, F32)
        run = _quiet(ms.run, case["smc_N"], case["smc_P"], device=cpu, host=True,
                     mutations=case["smc_mutations"], max_stages=case["smc_stages"],
                     dtype=F64, x0=case["smc_x0"], verbose=False)
        bridge = ms.map_bridge(ms.kernel_loglik(t, y, dtype=F64), case["smc_P"])
        return dict(lls32=ms.kernel_loglik(t, y, chunk=3)(case["smc_xs"]),
                    lls64=ms.kernel_loglik(t, y, dtype=F64)(case["smc_xs"]), run=run,
                    pmap=bridge[0], laplace=bridge[1],
                    device_run=_quiet(ms.run, case["smc_N"], 8, device=cpu, mutations=1,
                                      max_stages=2))

    def nuts_vs_smc():
        from gpar_at_scale_torch.benchmarks import nuts_vs_smc as nv
        from gpar_at_scale_torch.benchmarks.million_smc import million_smc_data

        t_np, y_np, _ = million_smc_data(case["ns_N"])
        q = _t(case["ns_q"]).requires_grad_(True)
        v = nv.blocked_temporal_logpost(_t(t_np, F32), _t(y_np, F32))(q)
        (g,) = torch.autograd.grad(v.sum(), q)
        run = _quiet(nv.run, case["ns_N"], 2, 4, 4, 12, device=cpu, smc_stages=2, max_depth=3)
        return dict(value=v.detach(), grad=g, compare=nv.compare(case["ns_nuts"], case["ns_smc"]),
                    run=run)

    def pod_scaling():
        from gpar_at_scale_torch.benchmarks import pod_scale, scaling
        from gpar_at_scale_torch.ops.kalman import decorrelate_blocked

        def at(lp):
            q = _t(case["pod_q"]).requires_grad_(True)
            v = lp(q)
            return v.detach(), torch.autograd.grad(v.sum(), q)[0]

        pod = [at(lp) for lp in pod_scale.conditional_logposts(case["pod_n"],
                                                                case["pod_outputs"], cpu, F64)]
        weak = _quiet(scaling.weak, device=cpu, ranks=2, n_per_device=case["weak_per_rank"])
        unsharded = []
        for _, n, _, _, _ in weak:
            _, y, lg = scaling.weak_series(n, cpu)
            unsharded.append(float(decorrelate_blocked(lg, y)[0]))
        return dict(pod=pod, toy=at(scaling.toy_logpost(cpu, F64)), weak=weak, unsharded=unsharded,
                    pod_run=_quiet(pod_scale.run, device=cpu, outputs=case["pod_outputs"],
                                   chains=4, samples=3, warmup=3, n_long=2000),
                    strong=_quiet(scaling.strong, device=cpu, ranks=1, chains_per_device=2,
                                  samples=3, warmup=3))

    jobs = {
        "million_dtc": million_dtc,
        "million_grad": million_grad,
        "long_series": long_series,
        "million_smc": million_smc,
        "nuts_vs_smc": nuts_vs_smc,
        "pod_scaling": pod_scaling,
        "dtc": dtc,
        "toy": lambda: toy_example.run(device=cpu, max_opt_steps=case["toy_steps"]),
        "plot": plot,
        "scaled": lambda: _quiet(scaled_examples.run, generate_small_dataset(seed=0), 10,
                                 case["scaled_steps"], "small", 3, device=cpu, plot=False),
        "eeg": eeg_chain,
        "bench": bench_run,
        "chain": lambda: _quiet(chain_scale.run, **_CHAIN_SIZE, device=cpu),
        "ess": ess_run,
    }
    out = {}
    for name, job in jobs.items():
        if only is not None and name not in only:
            continue
        try:
            out[name] = job()
        except Exception as exc:  # raised again by the script's test
            out[name] = exc
    return out


class _Late:
    """Work for the file's late cases, started once the worker is
    ``LATE_AT`` of the way through the file's cases (``_late_start``) or
    when a case asks for it: the drivers' JAX references (a pool of
    ``_SCRIPT_GROUPS`` processes) and the parallel cases' ranks
    (``_dist_compute``, in a thread).  Started at the first case, they
    would contend for the host's cores with the early cases' references."""

    LATE_AT = 0.4

    def __init__(self, request):
        items = request.session.items
        self.scripts = any("example_results" in getattr(i, "fixturenames", ()) for i in items)
        self.dist = any("dist_results" in getattr(i, "fixturenames", ()) for i in items)
        self.tmp = request.getfixturevalue("tmp_path_factory")
        self.pool = self.examples = self.ranks = None

    def start(self):
        import multiprocessing

        from _jax_example_refs import references

        if self.scripts and self.pool is None:
            case = _example_case()
            self.pool = multiprocessing.get_context("spawn").Pool(len(_SCRIPT_GROUPS))
            self.examples = case, [self.pool.apply_async(references, (case, names))
                                   for names in _SCRIPT_GROUPS]
        if self.dist and self.ranks is None:
            self.ranks = _Background(_dist_compute, self.tmp.mktemp("gloo") / "store")

    def close(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()


@pytest.fixture(scope="module", autouse=True)
def _late(request):
    late = _Late(request)
    try:
        yield late
    finally:
        late.close()


@pytest.fixture(autouse=True)
def _late_start(request, _late):
    items = [i for i in request.session.items if i.module is request.module]
    if request.node in items and items.index(request.node) >= _Late.LATE_AT * len(items):
        _late.start()


@pytest.fixture(scope="module")
def example_results(_late):
    """{script: (the port's results, the JAX script's references)}."""
    _late.start()
    case, pending = _late.examples
    port = _port_scripts(case)
    refs = {}
    for p in pending:
        refs.update(p.get(timeout=600))
    return {name: (port[name], refs[name]) for name in port}


def _script_results(example_results, name):
    port, ref = example_results[name]
    if isinstance(port, Exception):
        raise port
    return port, ref


def test_dtc_example_matches_jax(example_results):
    """examples/dtc_example.py part (a): the port's Kalman-whitened bound
    (sequential filter, float64) equals the JAX script's within 1e-10
    relative, and the port's dense reference with the JAX script's K_uu
    ridge 1e-10 gives the dense number the JAX script prints (6 decimals:
    atol 1e-6).  That script's own assertion fails (its dense side leaves
    out the noise ridge that dtc_objective's uu_ridge="auto" adds); the
    port's dense side adds it, and the port passes the assertion,
    diff < 1e-5 |dense|, in float64 and on the kernels' plain versions in
    float32 (filter_fn="pallas").  Part (b) runs at 3 L-BFGS steps (its
    iterates are no parity target) to a finite table."""
    port, ref = _script_results(example_results, "dtc")
    assert ref["assertion_held"] is False
    _close(port["kalman"], ref["kalman"], rtol=1e-10)
    _close(port["dense_1e10"], ref["dense"], rtol=0, atol=1e-6)
    assert port["diff"] < 1e-5 * abs(port["dense"])
    assert abs(port["kalman_f32"] - port["dense"]) < 1e-5 * abs(port["dense"])
    fe, fs = port["optimum"]
    assert np.isfinite(fe.hyperparams()).all() and np.isfinite(fs.hyperparams()).all()


def test_toy_example_matches_jax(example_results):
    """examples/toy_example.py with every fit on the script's starts (0
    L-BFGS steps): the IGP and GPAR SMSE table within 1e-9 relative."""
    port, ref = _script_results(example_results, "toy")
    _close(np.asarray(port["smse"]), ref["smse"], rtol=1e-9)
    for fit, want in zip([f for f, _, _ in port["igp"]], ref["igp"]):
        _close(fit.params, want, rtol=1e-12)


def test_plot_examples_match_jax(example_results):
    """examples/plot_examples.py: the exact GP on the script's start (0
    L-BFGS steps), its predictive mean and SMSE within 1e-9 relative; the
    temporal GP on the big set (N = 8496) after 3 Adam steps, the port's
    likelihood on the kernels' float32 plain versions against the JAX
    script's float64 sequential filter: the log-parameters within 1e-5
    (Adam's early steps are near lr * sign(g)), the predictive mean within
    1e-4 of its largest magnitude and the in-range SMSE within 1e-4
    relative."""
    (exact, temporal), ref = _script_results(example_results, "plot")
    _, _, mu_e, _, fit_e = exact
    _close(fit_e.params, ref["exact"], rtol=1e-12)
    _close(mu_e, ref["exact_mu"], rtol=1e-9, atol=1e-12)
    _, _, mu_t, var_t, fit_t, score_t = temporal
    _close(fit_t.params, ref["temporal"], rtol=0, atol=1e-5)
    _near(mu_t, ref["temporal_mu"], 1e-4)
    _close(score_t, ref["temporal_smse"], rtol=1e-4)


def test_scaled_examples_match_jax(example_results):
    """examples/scaled_examples.py on the small set at 3 Adam steps, float64
    on both sides: every output's log-parameters within 1e-8 relative and
    the in-range SMSE of each output within 1e-8 relative."""
    port, ref = _script_results(example_results, "scaled")
    got = [port["model"].first.params] + [c.params for c in port["model"].conditionals]
    for g, w in zip(got, ref["params"]):
        _close(g, w, rtol=1e-8)
    _close(np.asarray(port["smse"]), ref["smse"], rtol=1e-8)


def test_eeg_example_matches_jax(example_results):
    """examples/eeg.py's run_igp and run (exact and scaled) with every fit
    on the script's starts (0 steps): the chain's glue, FZ -> F1 -> F2 with
    the predicted means fed forward.  Each channel's predictive mean and
    variance within 1e-8 of its largest magnitude (the port's IGP predicts
    by dense conditioning where the JAX script runs its RTS smoother)."""
    (ds, port), ref = _script_results(example_results, "eeg")
    for model in ("IGP", "exact", "scaled"):
        for ch in ("FZ", "F1", "F2"):
            mu, var, _ = port[model][ch]
            _near(mu, ref[model][ch][0], 1e-8)
            _near(var, ref[model][ch][1], 1e-8)


def test_bench_matches_jax(example_results):
    """bench.py's pipeline on the port (``benchmarks/bench.py::
    bench_pipeline``) in float64 at 3 Adam steps against the same pipeline
    on the JAX package's functions: the log-parameters and the last loss
    within 1e-9 relative, the predictive mean and variance within 1e-8 of
    their largest magnitudes."""
    (res, _, pred), ref = _script_results(example_results, "bench")
    _close(res.params, ref["params"], rtol=1e-9)
    _close(float(res.value), ref["loss"], rtol=1e-9)
    _near(pred.mean, ref["mean"], 1e-8)
    _near(pred.var, ref["var"], 1e-8)


def test_chain_scale_matches_jax(example_results):
    """benchmarks/chain_scale.py at N = 600, P = 3, M = 4, 2 Adam steps, N* =
    50 (float32 on both sides: the port's kernels' plain versions, the JAX
    script's blocked engine with its host-float64 M x M algebra) against
    the lines the JAX script prints (4 decimals): each output's rmse and
    each conditional's first and last nll/N within 2e-4.  The JAX script's
    coverage cov2s cannot fail (its band holds the observation noise): it is
    1 here; the latent band's share lies in [0, 1]."""
    port, ref = _script_results(example_results, "chain")
    _close(np.asarray(port["rmse"]), ref["rmse"], rtol=0, atol=2e-4)
    nll = [(_np(f.opt.trace)[0] / _CHAIN_SIZE["N"], _np(f.opt.trace)[-1] / _CHAIN_SIZE["N"])
           for f in port["fits"][1:]]
    _close(np.asarray(nll), ref["nll"], rtol=0, atol=2e-4)
    assert all(c == 1.0 for c in port["cov2s"]) and all(0.0 <= c <= 1.0 for c in port["cov2f"])


def test_ess_script_matches_jax(example_results):
    """benchmarks/ess.py: the log-density it samples (the FZ conditional
    through bounded_reparam(3.0), strided pseudo-points, float64) and its
    gradient at 3 points within 1e-9 relative of the JAX script's; the
    script's diagnostics (split R-hat, multi-chain ESS, per-chain Geyer sum)
    on the same draws within 1e-10 relative; and a run of 2 chains of 3 + 4
    transitions (depth cut to 3) with finite draws inside the bound."""
    port, ref = _script_results(example_results, "ess")
    _close(port["value"], ref["value"], rtol=1e-9)
    _close(port["grad"], ref["grad"], rtol=1e-9, atol=1e-9)
    for got, key in zip(port["diag"], ("rhat", "ess", "geyer")):
        _close(got, ref[key], rtol=1e-10)
    run = port["run"]
    assert run["pooled"].shape == (2, 4, 5) and np.isfinite(run["pooled"]).all()
    assert (np.abs(run["pooled"]) < 3.0).all() and run["total"] == 8


def test_million_dtc_matches_jax(example_results):
    """benchmarks/million_dtc.py at N = 2000, M = 8, N* = 200 on the port's
    kernel route (float32 plain versions) against the script's functions in
    float64 (``_jax_example_refs.py::_million_dtc``), at its start point:
    the whitened Gram within 1e-5 of its largest entry and log det within
    1e-6 relative (measured 1.0e-7, 1.5e-8); the bound within 1e-5
    relative (9.7e-7); the staged gradient per component within
    ``chip_smoke.py``'s [grad] bound at N = 2000, 1e-3 |g| + 2e-3 + 8 N
    eps_f32 (measured at most 2.6e-4 absolute); the analytic predictive's
    mean and variance within 1e-4 of their largest values (1.2e-6,
    6.6e-6), and gp/dtc.py's float64 predictive on the same q(u) within
    1e-6 (5.8e-8; the q(u) comes from the float32 Gram).  The staged
    gradient equals the one autograd step (``--fused``, the same float32
    operations: measured equal, held to 1e-9 relative) and the mixed-column
    backward's within the same per-component bound; ``--check`` meets the
    script's bounds; the rows (a) to (c) run end to end at 2 Adam steps
    with nll/N falling."""
    port, ref = _script_results(example_results, "million_dtc")
    _near(port["G"], ref["G"], 1e-5)
    _close(port["logdet"], ref["logdet"], rtol=1e-6)
    value, grad = port["staged"]
    _close(value, ref["value"], rtol=1e-5)
    atol = 2e-3 + 8 * 2.0**-23 * 2000
    _close(grad, ref["grad"], rtol=1e-3, atol=atol)
    _close(port["fused"][0], value, rtol=1e-9)
    _close(port["fused"][1], _np(grad), rtol=1e-9, atol=0)
    _close(port["mixed"][1], _np(grad), rtol=1e-3, atol=atol)
    _near(port["mean"], ref["mean"], 1e-4)
    _near(port["var"], ref["var"], 1e-4)
    _near(port["reference"][0], ref["mean"], 1e-6)
    _near(port["reference"][1], ref["var"], 1e-6)
    dv, _, rg, _, _ = port["check"]
    assert dv < 1e-5 and rg < 1e-4
    run = port["run"]
    assert np.isfinite(run["nll"]).all() and run["nll"][-1] < run["nll"][0]
    assert run["mean"].shape == (200,) and np.isfinite(run["var"]).all() and run["whiten_ms"] > 0


def test_million_grad_matches_jax(example_results):
    """benchmarks/million_grad.py at N = 1500: the NLML and its gradient at
    the script's start through the blocked engine by autograd (the script's
    default), its closed-form gradient (``--fisher``) and the segmented one
    (``--seg-fisher``, segments of 600), float64, against the script's
    float64 default within 1e-10 and 1e-8 relative (measured 1.2e-14 and
    1.3e-9 per component); the kernel route (``--pallas``, float32 plain
    versions) within 1e-5 and 1e-4 (1.6e-7, 3.2e-6); 3 Adam steps of the
    port's ``adam_update`` against optax's: log-parameters within 1e-9
    (1.1e-11) and the nll/N trace within 1e-10 relative (3e-14).  The
    ``--pallas`` run prints its lines and its nll/N falls."""
    port, ref = _script_results(example_results, "million_grad")
    n = 1500
    for route, (rtol_v, rtol_g) in (("blocked", (1e-10, 1e-8)), ("fisher", (1e-10, 1e-8)),
                                    ("seg-fisher", (1e-10, 1e-8)), ("pallas", (1e-5, 1e-4))):
        ll, g = port[route]
        _close(-ll / n, ref["nll"], rtol=rtol_v)
        _close(-_np(g) / n, ref["grad"], rtol=rtol_g)
    params, trace, _ = port["adam"]
    _close(params, ref["params"], rtol=0, atol=1e-9)
    _close(trace, ref["trace"], rtol=1e-10)
    assert port["run"]["nll"][-1] < port["run"]["nll"][0]


def test_long_series_matches_jax(example_results):
    """benchmarks/long_series.py at N = 2000 (segments of 700), every row of
    the port (float32: the tensor-code engines and the kernels' plain
    versions) against the script's row in float64: the filters' ll (filter,
    segfilter, seq, assoc, pallas filter) within 1e-5 relative (measured at
    most 1.6e-7), the smoothers' means (smooth, smooth-split, segsmooth,
    pallas smooth) within 1e-4 of their largest value (4.2e-6); the
    samplers' draws (ffbs, segsample) finite, 4 x 2000."""
    port, ref = _script_results(example_results, "long_series")
    for row, key in (("filter", "filter"), ("segfilter", "segfilter"), ("seq", "seq"),
                     ("assoc", "assoc"), ("pallas filter", "pallas_filter")):
        _close(float(port[row]["out"][0]), float(ref[key]), rtol=1e-5)
        assert port[row]["ll"] == pytest.approx(float(port[row]["out"][0]))
    for row, key in (("smooth", "smooth"), ("smooth-split", "split"), ("segsmooth", "segsmooth"),
                     ("pallas smooth", "pallas_smooth")):
        _near(port[row]["out"][0], ref[key], 1e-4)
    for row in ("ffbs", "segsample"):
        f = port[row]["out"][0]
        assert f.shape == (4, 2000) and bool(torch.isfinite(f).all())


def test_million_smc_matches_jax(example_results):
    """benchmarks/million_smc.py at N = 1000 (the script's float32 times and
    data): one fixed batch of 4 particles' log-likelihoods on the kernel
    route (float32 plain versions, read back every 3 particles) within 1e-6
    relative of the script's float64 blocked engine (measured 3.3e-8), in
    float64 within 1e-12 (3.8e-16); ``--host`` with 16 particles, 2
    mutations and 3 stages in float64 from the same particles: the same
    cloud as the JAX ``smc_host`` (both draw from
    ``np.random.default_rng(0)``; measured equal, held to 1e-12), stages,
    evaluations and log-evidence; ``--map-init``'s Nelder-Mead end point
    within 1e-8 (equal) and its Laplace scale within 1e-6 relative
    (2e-10).  The one-program ``smc`` runs end to end."""
    port, ref = _script_results(example_results, "million_smc")
    _close(port["lls32"], ref["lls"], rtol=1e-6)
    _close(port["lls64"], ref["lls"], rtol=1e-12)
    run = port["run"]
    _close(run["particles"], ref["particles"], rtol=0, atol=1e-12)
    assert (run["result"].num_stages, run["evals"]) == (ref["stages"], ref["evals"])
    _close(run["result"].log_evidence, ref["logZ"], rtol=1e-10)
    _close(port["pmap"], ref["pmap"], rtol=0, atol=1e-8)
    _close(port["laplace"], ref["laplace"], rtol=1e-6)
    dev = port["device_run"]
    assert dev["particles"].shape == (8, 3) and np.isfinite(dev["rmse"])


def test_nuts_vs_smc_matches_jax(example_results):
    """benchmarks/nuts_vs_smc.py at N = 1000: its target (blocked_loglik with
    the prior, float64, the script's float32 times) and its gradient at 3
    points within 1e-10 and 1e-9 relative of the script's (measured 2e-15,
    1.1e-13); the verdict on the same two clouds (means, MC errors within
    1e-12, the same agreement); and a run of 2 chains of 4 + 4 transitions
    (depth 3) against SMC with 12 particles that ends with finite means."""
    port, ref = _script_results(example_results, "nuts_vs_smc")
    _close(port["value"], ref["value"], rtol=1e-10)
    _close(port["grad"], ref["grad"], rtol=1e-9, atol=1e-9)
    d_nuts, d_smc, z, agree = port["compare"]
    for got, key in ((d_nuts.mean, "mean_nuts"), (d_smc.mean, "mean_smc"),
                     (d_nuts.mcse, "mcse_nuts"), (d_smc.mcse, "mcse_smc")):
        _close(got, ref[key], rtol=1e-12)
    assert agree == ref["agree"]
    run = port["run"]
    assert run["nuts"].samples.shape == (2, 4, 3) and np.isfinite(run["d_nuts"].mean).all()
    assert np.isfinite(run["z"]).all() and run["smc"].particles.shape == (12, 3)


def test_pod_scale_matches_jax(example_results):
    """benchmarks/pod_scale.py's phase A targets (n_train = 96, 3 outputs:
    each conditional's DTC logpost, float64) and their gradients at 3
    points within 1e-10 relative of the script's (measured 1.8e-16,
    1.5e-15); both phases run end to end on one rank (4 chains of 3 + 3
    draws; the whitening of 8 columns at N = 2000) with finite numbers."""
    port, ref = _script_results(example_results, "pod_scaling")
    for (v, g), (v_j, g_j) in zip(port["pod"], ref["pod"]):
        _close(v, v_j, rtol=1e-10)
        _close(g, g_j, rtol=1e-10, atol=1e-12)
    (rank,) = port["pod_run"]
    assert np.isfinite(rank["chain_means"]).all() and np.isfinite(rank["seq_ll"]).all()


def test_scaling_matches_jax(example_results):
    """benchmarks/scaling.py's target (the toy small set's output 2 given
    output 1, DTC, float64) and its gradient at 3 points within 1e-10 of
    the script's (measured 1.5e-16, 4e-16); ``--weak`` at 2048 steps per
    rank on 1 rank and on 2 spawned gloo ranks: every rank's ll equals the
    unsharded kernel filter's (float32 plain versions) at the same N
    within 1e-6 relative (measured equal) and the script's float64 blocked
    engine's at N = 4096 within 1e-5 (1.5e-7); the strong runs' draws
    finite."""
    port, ref = _script_results(example_results, "pod_scaling")
    _close(port["toy"][0], ref["toy"][0], rtol=1e-10)
    _close(port["toy"][1], ref["toy"][1], rtol=1e-10, atol=1e-12)
    weak = port["weak"]
    assert [(D, n) for D, n, *_ in weak] == [(1, 2048), (2, 4096)]
    for (_, _, _, lls, _), want in zip(weak, port["unsharded"]):
        _close(np.asarray(lls), want, rtol=1e-6)
    _close(weak[1][3][0], ref["weak_ll"], rtol=1e-5)
    assert all(np.isfinite(r[3]).all() for r in port["strong"])


def test_batched_predictive_matches_sequential(monkeypatch):
    """gp/dtc.py::predict_scaled_batch against B = 6 calls of predict_scaled
    on one cached q(u) (bench.py's request, N = 156, N* = 100, float64):
    means and variances within 1e-12 of their largest magnitudes; under
    "interpret" in float32 (the kernels' plain versions: one batched K6a
    and two K6b calls) within 1e-4 of the float64 result; a kernel that is
    not stationary raises TypeError.  Above DENSE_N_MAX spliced steps the
    scan branch answers (``test_batched_scan_*``)."""
    from gpar_at_scale_torch.benchmarks import bench
    from gpar_at_scale_torch.gp.dtc import predict_scaled_batch

    cpu = torch.device(CPU)
    pipeline, predict, predict_batch = bench.bench_pipeline(cpu, F64)
    monkeypatch.setattr(bench, "ADAM_STEPS", 2)
    res, qu, _ = pipeline()
    P = res.params[None] + _t(0.05 * np.random.default_rng(4).normal(size=(6, 5)))
    got = predict_batch(P, qu)
    assert got.mean.shape == got.var.shape == (6, bench.N_STAR)
    for i in range(6):
        want = predict(P[i], qu)
        _near(got.mean[i], _np(want.mean), 1e-12)
        _near(got.var[i], _np(want.var), 1e-12)
    monkeypatch.setenv("GPAR_PALLAS_DENSE_INTERPRET", "1")
    _, predict32, batch32 = bench.bench_pipeline(cpu, torch.float32)
    qu32 = type(qu)(*(x.float() for x in qu))
    got32 = batch32(P.float(), qu32)
    _near(got32.mean, _np(got.mean), 1e-4)
    _near(got32.var, _np(got.var), 1e-4)
    t, t_star, X, X_star, y = bench.bench_data(cpu, F64)
    k = tk.Matern52(lengthscale=torch.ones(2, dtype=F64), variance=torch.ones(2, dtype=F64))
    with pytest.raises(TypeError, match="stationary"):
        predict_scaled_batch(k + k, k, qu, X, t, y, t_star, X_star, torch.ones(2, dtype=F64))


@pytest.fixture(scope="module")
def scan_batch_case():
    """The long-series predictive at a CPU's size: N = 3000 training and
    N* = 100 held-out times (3100 spliced steps, above DENSE_N_MAX), M = 8,
    q(u) at log-parameters p0 through the kernel path's plain versions
    (float32, as the benchmark's configuration), and B = 3 draws around p0."""
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.utils.params import unpack_gpar

    f32 = torch.float32
    g = torch.Generator().manual_seed(11)
    t = torch.sort(torch.rand(3000, generator=g, dtype=F64) * 3.0).values
    t_star = torch.rand(100, generator=g, dtype=F64) * 3.0
    cols = lambda tv: torch.stack([torch.sin(7.0 * tv), torch.cos(2.3 * tv)], 1)  # noqa: E731
    X, X_star = cols(t), cols(t_star)
    y = torch.sin(5.0 * t) + 0.5 * X[:, 0] + 0.2 * torch.randn(3000, generator=g, dtype=F64)
    t, t_star, X, X_star, y = (a.to(f32) for a in (t, t_star, X, X_star, y))
    Z = X[torch.linspace(0, 2999, 8, dtype=F64).to(torch.int64)]

    def kernels(p):
        tl, ts, ol, osig, ns = unpack_gpar(p)
        return (tk.Matern52(lengthscale=tl, variance=ts**2),
                tk.Matern52(lengthscale=ol, variance=osig**2), ns**2)

    p0 = torch.tensor([-1.0, 0.0, 0.3, -0.2, -1.5])
    time_k, out_k, nv = kernels(p0)
    qu = tdtc.compute_q_u(out_k, lgssm_of(time_k, t, nv, f32), X, Z, y, uu_ridge=nv,
                          filter_fn="pallas")
    P = p0[None] + 0.05 * torch.randn(3, 5, generator=g)
    return dict(t=t, t_star=t_star, X=X, X_star=X_star, y=y, Z=Z, p0=p0, P=P, qu=qu,
                kernels=kernels)


def _scan_request(case, P, dtype):
    time_k, out_k, nv = case["kernels"](P.T.to(dtype))
    return tdtc.predict_scaled_batch(out_k, time_k, case["qu"], case["X"], case["t"], case["y"],
                                     case["t_star"], case["X_star"], nv, dtype=dtype)


def test_batched_scan_branch_matches_sequential(scan_batch_case):
    """Above DENSE_N_MAX, predict_scaled_batch of B = 3 parameter sets
    against 3 calls of predict_scaled on the same q(u), row by row: in
    float64 (the tensor-code blocked smoother over the 3 series laid end to
    end) within 1e-8 of each row's largest magnitude; in float32 (K1-K4b,
    here their plain versions) within 1e-4 of the float64 predictive's sd."""
    c = scan_batch_case
    got64, got32 = _scan_request(c, c["P"], F64), _scan_request(c, c["P"], torch.float32)
    assert got64.mean.shape == got32.var.shape == (3, 100)
    for i in range(3):
        time_k, out_k, nv = c["kernels"](c["P"][i].double())
        want = tdtc.predict_scaled(out_k, time_k, c["qu"], c["X"], c["t"], c["y"], c["t_star"],
                                   c["X_star"], nv, dtype=F64)
        _near(got64.mean[i], _np(want.mean), 1e-8)
        _near(got64.var[i], _np(want.var), 1e-8)
        sd = want.var.sqrt()
        assert float(((got32.mean[i].double() - want.mean) / sd).abs().max()) < 1e-4
        assert float(((got32.var[i].double() - want.var) / want.var).abs().max()) < 1e-4


def test_batched_scan_branch_matches_the_plain_reference(scan_batch_case):
    """portbench/reference/gpar_dtc_m32_serve.py (float64, the held-out
    steps unobserved instead of spliced at 1e10): handed the program's q(u),
    its predictive of the 3 draws equals the float64 batch within 1e-8 of
    its largest magnitudes; with its own q(u) at p0 the float32 batch is
    within the serving cell's kind of limits (1e-4 sd, 1e-3 of the
    variances, q(u) within 1e-3)."""
    from portbench import cells, compare

    c = scan_batch_case
    ref = cells.load_module(REPO / "portbench/reference/gpar_dtc_m32_serve.py")
    inp = ref.Inputs(c["t"], c["X"], c["y"], ref.pseudo_inputs(c["X"], 8), c["t_star"], c["X_star"])
    assert torch.equal(inp.Z, c["Z"])
    qu = c["qu"]
    w = torch.linalg.solve_triangular(qu.L_uu.T, qu.m_eps[:, None], upper=True)[:, 0]
    rm, rv = ref.predict(c["P"], ref.QU(w, qu.L_uu @ qu.L_D, None, None), inp)
    got = _scan_request(c, c["P"], F64)
    _near(got.mean, _np(rm), 1e-8)
    _near(got.var, _np(rv), 1e-8)
    rq = ref.q_u(c["p0"], inp)
    assert compare.qu_gap(*compare.u_posterior(qu.m_eps, qu.L_D, qu.L_uu), rq.u_mean, rq.u_var) < 1e-3
    rm, rv = ref.predict(c["P"], rq, inp)
    got = _scan_request(c, c["P"], torch.float32)
    numbers = compare.serve_numbers(got.mean, got.var, rm, rv)
    assert numbers["mean_rms_gap"] < 1e-4 and numbers["var_gap"] < 1e-3, numbers


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_series_laid_end_to_end_smooth_as_each_alone(dtype):
    """ops/smoother.py::smooth_columns over ssm/markov.py::lgssm_batch_of of
    3 time GPs (one grid, per-series noise, 3 columns) equals
    smooth_columns of each series' own lgssm_of: float32 through K1-K4b's
    plain versions within 1e-5, float64 through the blocked smoother
    within 1e-10, of the largest magnitudes; the batched discretization is
    each series' lgssm_of within 1e-12."""
    from gpar_at_scale_torch.ops.smoother import smooth_columns

    g = torch.Generator().manual_seed(5)
    t = torch.sort(torch.rand(700, generator=g, dtype=F64) * 7.0).values
    ell, var = torch.tensor([0.3, 0.8, 1.5], dtype=F64), torch.tensor([1.0, 0.5, 2.0], dtype=F64)
    noise = torch.tensor([0.05, 0.1, 0.2], dtype=F64)[:, None].expand(3, 700).clone()
    noise[:, ::7] = 1e10  # held-out steps
    U = torch.randn(3, 700, 3, generator=g, dtype=F64).to(dtype)
    lg = tmarkov.lgssm_batch_of(tk.Matern52(lengthscale=ell, variance=var), t, noise, dtype)
    mean, var_b = smooth_columns(lg, U.reshape(2100, 3))
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    for i in range(3):
        one = tmarkov.lgssm_of(tk.Matern52(lengthscale=ell[i], variance=var[i]), t, noise[i], dtype)
        rows = slice(700 * i, 700 * (i + 1))
        for a, b in ((lg.A, one.A), (lg.Q, one.Q), (lg.R, one.R)):
            _near(a[rows], _np(b), 1e-12 if dtype == F64 else 1e-7)
        m1, v1 = smooth_columns(one, U[i].clone())
        _near(mean[rows], _np(m1), tol)
        _near(var_b[rows], _np(v1), tol)


def _column_elements_case(d, n1, C, device="cpu"):
    """Three Matern time GPs of state dim d laid end to end by lgssm_batch_of
    (n1 steps each, float32), their y = 0 filter's covariances P and
    standard normal means m (3 n1, d, C)."""
    g = torch.Generator().manual_seed(d)
    t = torch.sort(torch.rand(n1, generator=g, dtype=F64) * 7.0).values
    ell, var = torch.tensor([0.3, 0.8, 1.5], dtype=F64), torch.tensor([1.0, 0.5, 2.0], dtype=F64)
    noise = torch.tensor([0.05, 0.1, 0.2], dtype=F64)[:, None].expand(3, n1).clone()
    family = (tk.Matern12, tk.Matern32, tk.Matern52)[d - 1]
    lg = tmarkov.lgssm_batch_of(family(lengthscale=ell.to(device), variance=var.to(device)),
                                t.to(device), noise.to(device), torch.float32)
    *_, P = tops_kalman.decorrelate_blocked(lg, torch.zeros(3 * n1, device=device),
                                           return_moments=True)
    m = torch.randn(3 * n1, d, C, generator=g).to(device)
    return lg, P, m


@pytest.mark.parametrize("d", [1, 2, 3])
def test_column_elements_match_a_float64_loop(d):
    """ops/smoother.py::column_elements (K7's wrapper) on CPU tensors: E, L
    and g = m - E A_{k+1} m over C = 5 columns of three series laid end to
    end (300 steps each), against a float64 loop of the formulas step by
    step, each within 2e-5 of its largest magnitude (measured at most
    1.05e-6, at d = 3); the element before each series' first step (A = 0
    there) and after the last step is (0, m, P) exactly; shapes and types
    the kernel does not take raise."""
    lg, P, m = _column_elements_case(d, 300, 5)
    m0 = m.clone()
    E, L = tops_smoother.column_elements(lg, m, P)
    n = m.shape[0]
    A, Q, Pd, md = (_np(x).astype(np.float64) for x in (lg.A, lg.Q, P, m0))
    want = np.zeros((n, d, d)), np.zeros((n, d, d)), np.zeros((n, d, 5))
    for k in range(n):
        A1 = A[k + 1] if k + 1 < n else np.zeros((d, d))
        Pp = A1 @ Pd[k] @ A1.T + (Q[k + 1] if k + 1 < n else np.eye(d))
        Ek = Pd[k] @ A1.T @ np.linalg.inv(Pp)
        want[0][k], want[1][k], want[2][k] = Ek, Pd[k] - Ek @ Pp @ Ek.T, md[k] - Ek @ A1 @ md[k]
    for got, w in zip((E, L, m), want):
        _near(got, w, 2e-5)
    for k in (299, 599, n - 1):
        assert not E[k].any() and torch.equal(L[k], P[k]) and torch.equal(m[k], m0[k])
    for bad in (lambda: tops_smoother.column_elements(lg, m.double(), P),
                lambda: tops_smoother.column_elements(lg, m[:, :, :0].contiguous(), P),
                lambda: tops_smoother.column_elements(lg, m[1:].contiguous(), P)):
        with pytest.raises(ValueError):
            bad()


def test_column_elements_kernel_matches_its_twin_on_the_card():
    """K7 against its plain version on the card: three series of 33,400
    steps end to end (n ~ 1e5), C = 33, E, L and g within 1e-5 of their
    largest magnitudes; one launch.  Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("K7 is a CUDA kernel: needs a CUDA device")
    lg, P, m = _column_elements_case(3, 33_400, 33, device="cuda")
    g_k, g_p = m.clone(), m.clone()
    before = tops_smoother.K7.launches
    got = tops_smoother.column_elements(lg, g_k, P)
    assert tops_smoother.K7.launches == before + 1
    want = tops_smoother.column_elements_plain(lg, g_p, P)
    for a, b in zip(got + (g_k,), want + (g_p,)):
        _near(a, _np(b), 1e-5)


def test_batched_scan_request_costs_do_not_grow_with_b(scan_batch_case, monkeypatch):
    """A float32 scan-branch request calls K1, K2, K3, K7, K4a and K4b once
    each (their wrappers, counted here on their plain versions) and passes the
    same host-sync sites at B = 1 and at B = 3; past SCAN_BATCH_STEPS the
    draws run in chunks, whose answers differ by float32's rounding through
    another time blocking (within 1e-4 of the largest magnitudes)."""
    from gpar_at_scale_torch.utils import observability as obs

    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)

    for module, name in ((tops_kalman, "phase1"), (tops_kalman, "phase3"),
                         (tops_whiten, "whiten_sweep"), (tops_smoother, "column_elements"),
                         (tops_smoother, "suffix_reduce"), (tops_smoother, "suffix_replay")):
        counted(module, name)
    c = scan_batch_case
    seen = []
    for b in (1, 3):
        calls.clear()
        before = obs.counts()["host_syncs"]
        whole = _scan_request(c, c["P"][:b], torch.float32)
        seen.append((dict(calls), obs.counts()["host_syncs"] - before))
    assert seen[0] == seen[1]
    assert seen[0][0] == {"phase1": 1, "phase3": 1, "whiten_sweep": 1, "column_elements": 1,
                          "suffix_reduce": 1, "suffix_replay": 1}
    monkeypatch.setattr(tdtc, "SCAN_BATCH_STEPS", 2 * 3100)
    calls.clear()
    chunked = _scan_request(c, c["P"], torch.float32)
    assert calls["phase1"] == 2
    _near(chunked.mean, _np(whole.mean), 1e-4)
    _near(chunked.var, _np(whole.var), 1e-4)


def test_long_series_predictive_spans(scan_batch_case):
    """With the spans on, a scan-branch request holds gpar.request and its
    stages splice, shared_solves, discretize, kernels, shared_solves,
    smooth and moments; predict_scaled holds gpar.predict with
    gpar.predict.smooth inside."""
    from torch.profiler import ProfilerActivity, profile

    from gpar_at_scale_torch.utils import observability as obs

    c = scan_batch_case
    time_k, out_k, nv = c["kernels"](c["p0"])
    work = {"gpar.request": lambda: _scan_request(c, c["P"], torch.float32),
            "gpar.predict": lambda: tdtc.predict_scaled(out_k, time_k, c["qu"], c["X"], c["t"],
                                                        c["y"], c["t_star"], c["X_star"], nv,
                                                        dtype=torch.float32)}
    names = {}
    for top, fn in work.items():
        with profile(activities=[ProfilerActivity.CPU]) as prof, obs.spans_on():
            fn()
        names[top] = [ev.name for ev in sorted(prof.events(), key=lambda ev: ev.time_range.start)
                      if ev.name.startswith("gpar.")]
    assert names["gpar.request"] == ["gpar.request"] + [
        f"gpar.request.{s}" for s in ("splice", "shared_solves", "discretize", "kernels",
                                      "shared_solves", "smooth", "moments")]
    assert names["gpar.predict"] == ["gpar.predict", "gpar.predict.smooth"]


def test_mfu_small_rows():
    """benchmarks/mfu.py --small on the CPU: its five rows with the flop
    counts of the JAX script by hand (the Gram 2 N (M + 1)^2 at N = 20000,
    M = 64, in float32, float64 and bf16; Cholesky plus solve n^3 / 3 +
    n^2 m at 256; the control 2 k^3 at 512), each share of its precision's
    peak equal to the FLOP/s over it."""
    from gpar_at_scale_torch.benchmarks import mfu

    rows = _quiet(mfu.run, torch.device(CPU), reps=1, small=True)
    want = [2.0 * 20_000 * 65**2] * 3 + [256**3 / 3 + 256**2 * 256, 2.0 * 512**3]
    assert [r["flops"] for r in rows] == want
    assert [r["precision"] for r in rows] == ["f32", "f64", "bf16", "f32", "bf16"]
    for r in rows:
        assert r["ms"] > 0 and math.isclose(r["pct_of_peak"],
                                            100 * r["gflops_per_s"] * 1e9 / mfu.PEAK[r["precision"]])
    src = (REPO / "bench.py").read_text()
    from gpar_at_scale_torch.benchmarks import bench

    assert bench.pipeline_flops() == 3.0 * 50 * (156**3 / 3 + 156**2 * 157 + 2 * 156**3
                                                  + 156**3 / 3 + 2 * 156 * 156 * 3)
    for key in ("metric", "value", "unit", "vs_baseline", "mfu", "gflops_per_s"):
        assert f'"{key}"' in src


_SCRIPT_MODULES = ("examples.dtc_example", "examples.toy_example", "examples.plot_examples",
                   "examples.scaled_examples", "examples.eeg", "benchmarks.bench",
                   "benchmarks.mfu", "benchmarks.chain_scale", "benchmarks.ess",
                   "benchmarks.million_dtc", "benchmarks.million_grad", "benchmarks.long_series",
                   "benchmarks.million_smc", "benchmarks.nuts_vs_smc", "benchmarks.pod_scale",
                   "benchmarks.scaling")


@pytest.mark.parametrize("name", _SCRIPT_MODULES)
def test_scripts_default_to_cuda(name, monkeypatch):
    """Every driver runs on the card unless given --cpu: without a card its
    main raises before any work (device.py::resolve_device)."""
    mod = importlib.import_module(f"gpar_at_scale_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
