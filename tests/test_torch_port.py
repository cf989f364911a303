"""The PyTorch port held against the JAX package, on the CPU.

Every input is made from a numpy seed and handed to the JAX function and to
its counterpart in ``gpar_at_scale_torch``; data crosses between the two as
numpy arrays.  Tolerances:

* float64 comparisons of the same algebra: rtol 1e-10 (kernels, LGSSMs) or
  1e-9/1e-8 where a recursion over hundreds of steps accumulates rounding
  in another order (filters, smoothers, the DTC algebra).
* the kernels' plain versions against the Pallas kernels run with
  ``interpret=True``: float32 with the JAX kernel tests' own tolerances
  (alpha atol 2e-5, ll rtol 2e-5, logdet rtol 1e-6).  The two split the
  series into different numbers of blocks, so the float32 rounding differs.
* the whole slice in float32 against the JAX chain: stated in that test.

On the CPU every kernel wrapper takes its plain version; the CUDA kernels
themselves are checked against the same plain versions by ``chip_smoke.py``
on the card.
"""

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
from gpar_at_scale_tpu.utils import params as jparams
from gpar_at_scale_tpu.utils import psd as jpsd
from gpar_at_scale_torch import device as tdevice
from gpar_at_scale_torch.data.chain import make_chain_data
from gpar_at_scale_torch.gp import dtc as tdtc
from gpar_at_scale_torch.ops import KERNELS, kalman as tops_kalman, whiten as tops_whiten
from gpar_at_scale_torch.ssm import blocked as tblocked
from gpar_at_scale_torch.ssm import kalman as tkalman
from gpar_at_scale_torch.ssm import markov as tmarkov
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


@pytest.mark.parametrize("name,n,B", [("Matern52", 1500, 7), ("Matern12", 700, 3)])
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


def test_sum_kernel_and_gradients_raise():
    t = _t(np.linspace(0, 1, 20), torch.float32)
    k = tk.Matern12(lengthscale=_t(1.0), variance=_t(1.0)) + tk.Matern12(lengthscale=_t(2.0), variance=_t(1.0))
    lg = tmarkov.lgssm_of(k, t, 0.1, torch.float32)
    assert not tops_kalman.pallas_supported(lg)
    with pytest.raises(NotImplementedError, match="P8"):
        tops_kalman.decorrelate_blocked(lg, torch.zeros(20))
    ls = _t(1.0).requires_grad_()
    lg1 = tmarkov.lgssm_of(tk.Matern52(lengthscale=ls, variance=_t(1.0)), t, 0.1, torch.float32)
    with pytest.raises(NotImplementedError, match="training"):
        tops_whiten.whiten_columns(lg1, torch.zeros(20, 2))


# ---------------------------------------------------------------------------
# The whole slice: condition a 3-output chain on given hyperparameters and
# answer a predict request, against the JAX chain.
# ---------------------------------------------------------------------------


def test_slice_matches_jax_chain(rng, monkeypatch):
    """N = 2500 (above DENSE_N_MAX, so the kernel path whitens and the
    blocked smoother predicts), M = 8, float32, filter_impl='pallas'.

    The JAX chain runs its own fit_gpar with the optimizer replaced by the
    identity: with max_opt_steps = 0 its L-BFGS returns x0 unchanged, and
    this skips the gradient it would evaluate at x0.  Tolerance: the port
    forms the whitened Gram and the M x M algebra in float64 where the JAX
    package stays in float32, and the two smooth over different block
    splits.  Measured on the CPU with this data: means (|mu| 3e-3 to 1.3)
    differ by at most 7.4e-6, held to atol 1e-4; the latent variances
    (3.0e-4 to 1.6e-3, no observation noise) by at most 1.5e-7, or 4.3e-4
    of the value, held to rtol 2e-3 -- a zero, halved or doubled variance
    fails by two orders of magnitude."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.inference.optimize import OptResult
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y, t_star, lat_star, sn = make_chain_data(2500, 200, 3, np.random.default_rng(3))
    p_first = np.asarray(jparams.pack_gp(0.5, 1.0, 0.2), np.float32)
    p_cond = np.asarray(jparams.pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2), np.float32)
    init = [p_first, p_cond, p_cond]

    monkeypatch.setattr(
        jgpar, "_minimize",
        lambda cfg, fun, x0: OptResult(params=x0, value=jnp.nan, num_steps=0, converged=False),
    )
    jcfg = jgpar.GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=8,
                            dtype=jnp.float32, max_opt_steps=0)
    jmodel = jgpar.fit_gpar(jax.random.PRNGKey(0), t, Y, jcfg,
                            init_params=[jnp.asarray(p) for p in init])
    mu_j, var_j = jmodel.predict(jnp.asarray(t_star, jnp.float32))

    for k in KERNELS:
        k.launches = 0
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=8,
                     dtype=torch.float32, max_opt_steps=0)
    model = fit_gpar(None, t, Y, cfg, init_params=convert.params_from_numpy(init, device=CPU),
                     device=CPU)
    mu_t, var_t = model.predict(t_star)
    assert [k.launches for k in KERNELS] == [0, 0, 0]  # the CPU takes the plain versions
    assert mu_t.shape == (200, 3) and var_t.shape == (200, 3)
    assert mu_t.dtype == torch.float32
    assert bool(torch.isfinite(mu_t).all() and torch.isfinite(var_t).all())
    _close(mu_t, mu_j, rtol=0, atol=1e-4)
    _close(var_t, var_j, rtol=2e-3, atol=0)
    for cj, ct in zip(jmodel.conditionals, model.conditionals):
        _close(ct.Z, cj.Z, rtol=0, atol=0)
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
# Guards
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gpar_at_scale_tpu)\b", re.M)
    files = sorted((REPO / "gpar_at_scale_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
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
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_serving_slice_guards():
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y = np.linspace(0, 1, 12), np.zeros((12, 2))
    with pytest.raises(NotImplementedError, match="training"):
        fit_gpar(None, t, Y, GPARConfig(backend="scaled"), device=CPU)
    with pytest.raises(NotImplementedError, match="training"):
        fit_gpar(None, t, Y, GPARConfig(backend="scaled", max_opt_steps=0), parallel=True, device=CPU)
    with pytest.raises(NotImplementedError):
        fit_gpar(None, t, Y, GPARConfig(backend="exact", max_opt_steps=0), device=CPU)


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
    assert [k.launches for k in KERNELS] == [0, 0, 0]
