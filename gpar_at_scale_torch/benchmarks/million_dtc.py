"""Scaled-GPAR DTC at N = 1e6 steps: one conditional GP f = f_x (DTC over
M inducing points) + f_t (temporal LGSSM), every Sigma_y^-1/2 solve on the
scan kernels.

Port of ``benchmarks/million_dtc.py``.  Data: its ``make_data`` (:48-69),
copied (numpy seed 0, test times spliced inside the training range);
inducing inputs every N/M-th input (:96); start pack_gpar(0.5, 1, 1, 0.7,
0.2) (:133); Adam 5e-2 on -grad / N.  Rows, as the script's:

  (a) ``whiten``  -- the M + 1 columns [y | K_fu] whitened in one pass:
      the y = 0 gain pass on K1/K2, then K3 over the columns
      (``ops/whiten.py::gram_forward``), the Gram in float64.
  (b) ``train``   -- Adam on the DTC bound, staged as the script's
      dispatches (:9-19): prepare (kernels and discretization, autograd),
      forward whiten (K1/K2, K3 with its filtered means), the bound and its
      Gram cotangents (float64 M x M algebra, autograd), the backward
      adjoint (one (M + 1)-column suffix scan on K4a/K4b,
      ``ops/grad.py``), then the pullback to the 5 log-parameters and the
      Adam step.  ``--fused`` is the one autograd step through
      ``ops/grad.py::WhitenGram``; ``--mixed-bwd=K`` the mixed-column
      backward through ``MixedWhitenGram`` (K1/K2 once, K3 and K4a/K4b per
      chunk of K columns) at any M.
  (c) ``predict`` -- the analytic predictive at N + N* points: q(u) through
      ``gp/dtc.py::compute_q_u(filter_fn="pallas")`` (K1/K2, K3), then the
      (M + 1)-column smoothing stack [y - f_x | G] of the script's
      ``prepare`` (:575-596) smoothed on the kernels by
      ``ops/smoother.py::smooth_columns``: the gain pass on K1/K2, K3 with
      its means, the smoothing elements on K7, one suffix scan over the
      M + 1 columns on K4a/K4b.

``--check``: the staged gradient (float32, the kernels) against autograd of
``gp/dtc.py::dtc_objective(filter_fn="blocked")`` in float64 (the
tensor-code blocked engine, ``ssm/blocked_grad.py``) at the script's check
point (:686), with the script's bounds (bound rel < 1e-5, gradient
rel < 1e-4 of its largest component).  The script checks its staged
gradient against its own one-jit ``jax.grad`` in the same precision.

    python -m gpar_at_scale_torch.benchmarks.million_dtc [N] [--m=32]
        [--steps=20] [--nstar=10000] [--only=whiten|train|predict]
        [--check] [--fused] [--mixed-bwd=K] [--cpu]

The O(N) side is float32 with the times in float64 (``ssm/markov.py::
lgssm_of`` discretizes in float64 from t as given); the Gram and the M x M
algebra are float64 on the device, where the script moves them to host
float64 for ``--mixed-bwd``.  Not ported: ``--fwd-chunk``, ``--chunk-cols``
and ``--bwd-chunk`` (:143-152, :426-437, :611-616), the TPU's column
chunking of the forward filter, the smoother and the suffix scans: the
first fits TPU tile padding of (N, d, d) buffers (its M = 256 forward ran
out of memory there), the others kept programs inside the TPU compile
service's reach; the staged and the mixed paths here run every column in
one sweep.  The script's line of dispatches per step becomes the kernel
launches per step.  Times in its docstring and ``results_r*/`` are the
TPU's.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    device_name,
    int_arg,
    numpy,
    positional,
    synchronize,
    timed,
)
from gpar_at_scale_torch.ops import launch_counts
from gpar_at_scale_torch.ops.smoother import smooth_columns

_LOG_2PI = 1.8378770664093453
F32, F64 = torch.float32, torch.float64
START = (0.5, 1.0, 1.0, 0.7, 0.2)
CHECK_POINT = (0.12, -0.2, 0.3, 0.04, -1.3)
LR = 5e-2
# --check: the script's bounds (:713)
CHECK_VALUE_RTOL, CHECK_GRAD_RTOL = 1e-5, 1e-4


def make_data(N, N_star, rng):
    """Chained-conditional synthetic: y = f_t(t) + f_x(X) + noise, with test
    times spliced inside the training range (``benchmarks/million_dtc.py::
    make_data``).  numpy float64: t, X (N, 2), y, t_star, X_star,
    truth_star, sn."""
    t_all = np.sort(rng.uniform(0.0, N / 1000.0, size=N + N_star))
    idx = rng.permutation(N + N_star)
    test_idx = np.sort(idx[:N_star])
    train_idx = np.sort(idx[N_star:])
    t, t_star = t_all[train_idx], t_all[test_idx]

    def xcols(tv):
        return np.stack([np.sin(0.7 * tv) + 0.1 * np.cos(3.1 * tv), np.cos(0.23 * tv)], axis=1)

    X, X_star = xcols(t), xcols(t_star)
    f_t = lambda tv: 0.8 * np.sin(2.2 * tv) * np.cos(0.31 * tv)  # noqa: E731
    f_x = lambda Xv: 0.6 * np.sin(1.3 * Xv[:, 0]) + 0.4 * Xv[:, 1]  # noqa: E731
    sn = 0.25
    y = f_t(t) + f_x(X) + sn * rng.normal(size=N)
    truth_star = f_t(t_star) + f_x(X_star)
    return t, X, y, t_star, X_star, truth_star, sn


def million_dtc_data(n, n_star, seed):
    """``make_data``'s training part from numpy seed ``seed``: t, X (n, 2),
    y, numpy float64."""
    return make_data(n, n_star, np.random.default_rng(seed))[:3]


class Problem(NamedTuple):
    """The script's inputs on the device: t float64, the rest float32."""

    t: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    Z: torch.Tensor
    t_star: torch.Tensor
    X_star: torch.Tensor
    truth_star: np.ndarray
    sn: float


def inducing(X, M):
    """The script's inducing inputs: every N/M-th input (:96)."""
    return X[:: max(1, X.shape[0] // M)][:M]


def problem(N, M, N_star, device, seed=0) -> Problem:
    t, X, y, t_star, X_star, truth_star, sn = make_data(N, N_star, np.random.default_rng(seed))
    on = lambda a, dt=F32: torch.as_tensor(a).to(device, dt)  # noqa: E731
    X_t = on(X)
    return Problem(on(t, F64), X_t, on(y), inducing(X_t, M), on(t_star, F64), on(X_star),
                   truth_star, sn)


def start(device, values=START):
    from gpar_at_scale_torch.utils.params import pack_gpar

    return pack_gpar(*(torch.tensor(v, dtype=F64) for v in values)).to(device, F32)


def kernels(p):
    """Log-parameters -> (time kernel, output kernel, noise variance)."""
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.utils.params import unpack_gpar

    tl, ts, ol, os_, ns = unpack_gpar(p)
    return Matern52(lengthscale=tl, variance=ts**2), Matern52(lengthscale=ol, variance=os_**2), ns**2


def arrays(p, t, X, y, Z):
    """p -> every input of the staged bound (the script's ``arrays``,
    :109-118): the float32 LGSSM (A, Q, R), the columns U = [y | K_fu] and
    K_uu with the noise ridge; differentiable in p."""
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    time_k, out_k, nv = kernels(p)
    lg = lgssm_of(time_k, t, nv, F32)
    U = torch.cat([y[:, None], out_k(X, Z)], dim=1)
    Kuu = out_k(Z, Z) + nv * torch.eye(Z.shape[0], dtype=F32, device=Z.device)
    return lg.A, lg.Q, lg.R, U, Kuu


def bound_from_gram(G, logdet, Kuu, n):
    """The P-form DTC bound from the whitened Gram (the script's
    ``bound_from_gram``, :120-131), in float64."""
    aa, g, Gb = G[0, 0], G[1:, 0], G[1:, 1:]
    L_uu, L_P = torch.linalg.cholesky(Kuu), torch.linalg.cholesky(Gb + Kuu)
    wp = torch.linalg.solve_triangular(L_P, g[:, None], upper=False)[:, 0]
    ld = lambda L: 2.0 * torch.log(torch.diagonal(L)).sum()  # noqa: E731
    return -0.5 * (n * _LOG_2PI + logdet + ld(L_P) - ld(L_uu) + aa - (wp * wp).sum())


def dtc_value_grad(t, X, y, Z, p, mixed):
    """The P-form DTC bound at log-parameters p and its gradient in one
    autograd step, through ``WhitenGram`` or, ``mixed`` a chunk width,
    ``MixedWhitenGram``.  The O(N) side float32, the bound's M x M algebra
    float64.  Returns (float value, gradient)."""
    from gpar_at_scale_torch.ops.grad import MixedWhitenGram, WhitenGram

    p = p.detach().clone().requires_grad_(True)
    A, Q, R, U, Kuu = arrays(p, t, X, y, Z)
    G, logdet = (MixedWhitenGram.apply(A, Q, R, U, mixed) if mixed
                 else WhitenGram.apply(A, Q, R, U))
    value = bound_from_gram(G, logdet, Kuu.double(), y.shape[0])
    (grad,) = torch.autograd.grad(value, p)
    return float(value.detach()), grad


def staged_value_grad(t, X, y, Z, p):
    """The bound and its gradient in the script's stages (its ``jfwd``,
    ``jbwd`` and ``jpull``): prepare, forward whiten (K1/K2, K3 with
    means), the bound's Gram cotangents, the backward adjoint (K4a/K4b),
    the pullback.  Returns (float value, gradient)."""
    from gpar_at_scale_torch.ops.grad import _bwd
    from gpar_at_scale_torch.ops.whiten import gram_forward

    p = p.detach().clone().requires_grad_(True)
    A, Q, R, U, Kuu = arrays(p, t, X, y, Z)
    G, logdet, aux = gram_forward(*(x.detach().contiguous() for x in (A, Q, R, U)), want_aux=True)
    G, logdet = G.requires_grad_(True), logdet.requires_grad_(True)
    K64 = Kuu.detach().double().requires_grad_(True)
    value = bound_from_gram(G, logdet, K64, y.shape[0])
    ct_G, ct_ld, ct_K = torch.autograd.grad(value, (G, logdet, K64))
    ct_A, ct_Q, ct_R, ct_U = _bwd(A.detach(), aux, ct_G, ct_ld)
    (grad,) = torch.autograd.grad((A, Q, R, U, Kuu), p, (ct_A, ct_Q, ct_R, ct_U, ct_K.to(F32)))
    return float(value.detach()), grad


def whiten(prob: Problem, p):
    """Row (a): (G, logdet) of the M + 1 columns at p, forward only."""
    from gpar_at_scale_torch.ops.whiten import gram_forward

    with torch.no_grad():
        A, Q, R, U, _ = arrays(p, prob.t, prob.X, prob.y, prob.Z)
        G, logdet, _ = gram_forward(A.contiguous(), Q.contiguous(), R.contiguous(), U.contiguous())
    return G, logdet


def train(prob: Problem, p0, steps, *, mixed=0, fused=False):
    """Row (b): ``steps`` Adam steps (5e-2) on -bound / N from p0, staged
    unless ``fused``; ``mixed`` > 0 takes the mixed-column backward in
    chunks of ``mixed`` columns.  Returns (params, nll/N per step)."""
    from gpar_at_scale_torch.inference.optimize import adam_init, adam_update

    n = prob.y.shape[0]
    p, state, trace = p0.detach().clone(), adam_init(p0), []
    for _ in range(steps):
        if mixed or fused:
            value, g = dtc_value_grad(prob.t, prob.X, prob.y, prob.Z, p, mixed)
        else:
            value, g = staged_value_grad(prob.t, prob.X, prob.y, prob.Z, p)
        p, state = adam_update(-g / n, state, p, LR)
        trace.append(-value / n)
    return p, np.asarray(trace)


def q_u(prob: Problem, p):
    """q(u) at p through ``gp/dtc.py::compute_q_u`` on the kernels
    (K1/K2, K3); its factors float64."""
    from gpar_at_scale_torch.gp.dtc import compute_q_u
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    time_k, out_k, nv = kernels(p)
    with torch.no_grad():
        return compute_q_u(out_k, lgssm_of(time_k, prob.t, nv, F32), prob.X, prob.Z, prob.y,
                           uu_ridge="auto", filter_fn="pallas")


def _spliced(prob: Problem, p, qu):
    """The script's ``prepare`` (:575-596): the spliced LGSSM (test points at
    noise 1e10), f_x's mean fx_bar and its factor G = K_*u L_uu^-T L_D^-T
    (products with float64 M x M inverse factors), and the order."""
    from gpar_at_scale_torch.gp.dtc import _tri_inverse, splice
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    time_k, out_k, nv = kernels(p)
    order, inv_order, t_s, noise_s = splice(prob.t, prob.t_star, nv.detach().double(), F64)
    V_s = torch.cat([prob.X, prob.X_star]).double()[order]
    y_s = torch.cat([prob.y.double(), prob.y.new_zeros(prob.t_star.shape[0], dtype=F64)])[order]
    lg = lgssm_of(time_k, t_s, noise_s, F32)
    Phi = out_k(V_s, prob.Z.double()) @ _tri_inverse(qu.L_uu).T
    G = Phi @ _tri_inverse(qu.L_D).T
    fx_bar = Phi @ qu.m_eps.double()
    return lg, y_s, fx_bar, G, inv_order


@torch.no_grad()
def predict(prob: Problem, p, qu=None):
    """Row (c): the analytic predictive at the N* test times, on the
    kernels: E[f*] = fx_bar + S (y - fx_bar), Var[f*] = rowsum(((I - S)
    G)^2) + diag(P_smooth) (the script's ``finish``).  Returns (mean, var)
    (N*,) float64 and q(u)."""
    qu = q_u(prob, p) if qu is None else qu
    lg, y_s, fx_bar, G, inv_order = _spliced(prob, p, qu)
    sm_mean, sm_var = smooth_columns(lg, torch.cat([(y_s - fx_bar)[:, None], G], dim=1).float())
    mean_all = fx_bar + sm_mean[:, 0].double()
    Hm = G - sm_mean[:, 1:].double()
    var_all = (Hm * Hm).sum(1) + sm_var.double()
    n = prob.t.shape[0]
    return mean_all[inv_order][n:], torch.clamp(var_all[inv_order][n:], min=0.0), qu


@torch.no_grad()
def predict_reference(prob: Problem, p, qu):
    """The same predictive on the same q(u) through ``gp/dtc.py::
    predict_scaled`` in float64 (the tensor-code blocked smoother above
    DENSE_N_MAX spliced steps): (mean, var)."""
    from gpar_at_scale_torch.gp.dtc import predict_scaled

    time_k, out_k, nv = kernels(p.double())
    pred = predict_scaled(out_k, time_k, qu, prob.X, prob.t, prob.y, prob.t_star, prob.X_star, nv,
                          dtype=F64)
    return pred.mean, pred.var


def check(prob: Problem, p=None):
    """``--check``: the staged gradient (float32, the kernels) against
    float64 autograd of ``dtc_objective(filter_fn="blocked")``.  Returns
    (bound rel diff, gradient max abs diff, its rel, staged (value, grad),
    reference (value, grad))."""
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    dev = prob.y.device
    p = torch.tensor(CHECK_POINT, dtype=F32, device=dev) if p is None else p
    v_s, g_s = staged_value_grad(prob.t, prob.X, prob.y, prob.Z, p)
    q = p.double().detach().requires_grad_(True)
    time_k, out_k, nv = kernels(q)
    v_f = dtc_objective(out_k, lgssm_of(time_k, prob.t, nv, F64), prob.X.double(),
                        prob.Z.double(), prob.y.double(), uu_ridge="auto", filter_fn="blocked")
    (g_f,) = torch.autograd.grad(v_f, q)
    g_s, g_f = numpy(g_s), numpy(g_f)
    v_f = float(v_f.detach())
    dv = abs(v_s - v_f) / abs(v_f)
    dg = float(np.max(np.abs(g_s - g_f)))
    return dv, dg, dg / float(np.max(np.abs(g_f))), (v_s, g_s), (v_f, g_f)


def run(N=1_000_000, M=32, steps=20, n_star=10_000, *, only=None, mixed=0, fused=False,
        device, seed=0):
    """The script's rows on ``device``; prints its lines.  Returns a dict:
    ``whiten_ms``, ``G``, ``logdet`` (a), ``params``, ``nll`` (per step),
    ``step_ms`` (b), ``mean``, ``var``, ``rmse``, ``coverage``,
    ``predict_s`` (c), for the rows run."""
    device = torch.device(device)
    prob = problem(N, M, n_star, device, seed)
    p0 = start(device)
    cols = prob.Z.shape[0] + 1
    print(f"N={N:,}  M={prob.Z.shape[0]}  N*={n_star:,}  device={device_name(device)}", flush=True)
    out = {}

    if only in (None, "whiten"):
        first, _ = timed(lambda: whiten(prob, p0), device)
        print(f"whiten first call (kernel load included): {first:6.1f}s", flush=True)
        runs = []
        for _ in range(5):
            el, (G, logdet) = timed(lambda: whiten(prob, p0), device)
            runs.append(el)
        el = min(runs)
        out.update(whiten_ms=1e3 * el, G=numpy(G), logdet=float(logdet))
        print(f"(a) batched whiten [{cols} cols x {N:,} steps]: {el * 1e3:9.2f} ms "
              f"({N / el / 1e6:7.2f} M steps/s, {N * cols / el / 1e6:8.1f} M col-steps/s)",
              flush=True)

    if only in (None, "train"):
        kind = f"mixed-bwd, M={cols - 1}, chunk={mixed}" if mixed else (
            f"5 hyperparams, M={cols - 1}" + (", fused" if fused else ""))
        first, _ = timed(lambda: train(prob, p0, 1, mixed=mixed, fused=fused), device)
        print(f"train first step (kernel load included): {first:6.1f}s", flush=True)
        before = sum(launch_counts().values())
        steady, (p, nll) = timed(lambda: train(prob, p0, steps, mixed=mixed, fused=fused), device)
        per_step = (sum(launch_counts().values()) - before) / max(steps, 1)
        tl, tsig, ol, osig, ns = (float(v) for v in np.exp(numpy(p)) + 1e-3)
        out.update(params=numpy(p), nll=nll, step_ms=1e3 * steady / max(steps, 1))
        print(f"(b) DTC train [{kind}]: {steady / max(steps, 1) * 1e3:9.1f} ms/step "
              f"({N * steps / steady / 1e6:7.2f} M filter steps/s fwd+bwd; "
              f"~{per_step:.0f} kernel launches/step)", flush=True)
        print(f"    nll/N trace: {['%.4f' % v for v in nll]}", flush=True)
        print(f"    optimized (tl, ts, ol, os, sn) = ({tl:.3f}, {tsig:.3f}, {ol:.3f}, {osig:.3f}, "
              f"{ns:.3f})  true noise {prob.sn}", flush=True)

    if only in (None, "predict"):
        first, _ = timed(lambda: predict(prob, p0), device)
        print(f"predict first call (kernel load included): {first:6.1f}s", flush=True)
        el, (mu, var, qu) = timed(lambda: predict(prob, p0), device)
        mu_np, var_np = numpy(mu), numpy(var)
        rmse = float(np.sqrt(np.mean((mu_np - prob.truth_star) ** 2)))
        inside = float(np.mean(np.abs(mu_np - prob.truth_star)
                               < 2 * np.sqrt(var_np + prob.sn**2)))
        out.update(mean=mu_np, var=var_np, rmse=rmse, coverage=inside, predict_s=el, qu=qu)
        print(f"(c) predict [{N:,}+{n_star:,} pts, analytic, kernels]: {el:8.2f} s  "
              f"({(N + n_star) / el / 1e6:6.2f} M pts/s)", flush=True)
        print(f"    rmse vs latent truth {rmse:.4f} (obs noise {prob.sn}); "
              f"2-sigma coverage {inside:.3f}", flush=True)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    n = positional(argv)
    N = int(n) if n else 1_000_000
    M = int_arg(argv, "m", 32)
    if "--check" in argv:
        prob = problem(N, M, 0, device)
        dv, dg, rg, _, _ = check(prob)
        synchronize(device)
        print(f"check N={N}: bound rel diff {dv:.2e}; grad max abs diff {dg:.3e} (rel {rg:.2e})")
        if not (dv < CHECK_VALUE_RTOL and rg < CHECK_GRAD_RTOL):
            raise AssertionError("staged gradient mismatch")
        print("staged (float32, kernels) == float64 blocked engine: OK")
        return dict(dv=dv, dg=dg, rg=rg)
    only = next((a.split("=", 1)[1] for a in argv if a.startswith("--only=")), None)
    return run(N, M, int_arg(argv, "steps", 20), int_arg(argv, "nstar", 10_000), only=only,
               mixed=int_arg(argv, "mixed-bwd", 0), fused="--fused" in argv, device=device)


if __name__ == "__main__":
    main()
