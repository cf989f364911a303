"""Gradient-based hyperparameter optimization of a temporal GP at N = 1e6
steps: Adam on the exact Kalman NLML.

Port of ``benchmarks/million_grad.py``.  Data: its series (:43-50), copied
(numpy seed 0; gaps of 0.5e-3 to 1.5e-3, a sine of lengthscale 0.9 and
scale 0.8, noise 0.25); a Matern-5/2 temporal GP from pack_gp(0.3, 1.0,
0.1), Adam 5e-2 (the port's ``inference/optimize.py::adam_update``, which
is optax's) on nll = -ll / N.  Routes, as the script's:

  default       -- autograd through the tensor-code blocked engine
                   (``ssm/blocked.py::blocked_logpdf``), float32;
  ``--fisher``  -- the blocked engine's closed-form disturbance-smoother
                   gradient (``ssm/blocked_grad.py::blocked_loglik``);
  ``--pallas``  -- the kernel path ``ops/grad.py::logpdf_markov_pallas``:
                   K1/K2 forward, K4a/K4b in its VJP;
  ``--seg-fisher`` -- ``ssm/segmented.py::make_segmented_nll_grad`` in
                   segments of ``--segment=S`` (1e6): K1/K2 and K4a/K4b per
                   segment, past one pass's length.

    python -m gpar_at_scale_torch.benchmarks.million_grad [N] [STEPS]
        [--pallas | --fisher | --seg-fisher [--segment=S]] [--cpu]

Every route runs the optimization twice, as the script does (its first run
includes compiles; here the first loads the kernels), and prints its
steady seconds per step, the nll/N trace (a table every STEPS/10 steps for
the fisher routes) and the end point.  The times are taken in float64, as
``ssm/markov.py::lgssm_of`` discretizes them (the script casts them to
float32: near 10^3 a float32 time is spaced 6e-5, 6% of a gap).  Not
ported: ``--split`` (:173-203), one jit per step against the script's
scan over all steps, a staging of the TPU compile service; the port takes
one step per call on every route.  Times in the script's docstring and
``results_r*/`` are the TPU's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    device_name,
    int_arg,
    numpy,
    synchronize,
)

START = (0.3, 1.0, 0.1)
TRUTH = (0.9, 0.8, 0.25)
LR = 5e-2
SEGMENT = 1_000_000
ROUTES = ("blocked", "fisher", "pallas", "seg-fisher")


def million_grad_data(n, seed=0):
    """``benchmarks/million_grad.py``'s series from numpy seed ``seed``:
    (t, y) numpy float64."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 1.5, n)) / 1000.0
    true_l, true_s, true_n = TRUTH
    return t, np.sin(t * (2.0 / true_l)) * true_s + true_n * rng.normal(size=n)


def matern52_gp(p):
    """The script's ``kernel_fn``: log-parameters -> (Matern-5/2 kernel,
    noise variance)."""
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.utils.params import unpack_gp

    l, sf, sn = unpack_gp(p)
    return Matern52(lengthscale=l, variance=sf**2), sn**2


def start(device, dtype=torch.float32):
    from gpar_at_scale_torch.utils.params import pack_gp

    return pack_gp(*(torch.tensor(v, dtype=torch.float64) for v in START)).to(device, dtype)


def fused_grad(t, y, p):
    """(ll, g) of the fused kernel path (``logpdf_markov_pallas``, autograd
    through the discretization) at log-parameters p, numpy float64 g."""
    from gpar_at_scale_torch.ops.grad import logpdf_markov_pallas

    p = p.detach().clone().requires_grad_(True)
    k, nv = matern52_gp(p)
    ll = logpdf_markov_pallas(k, t, nv, y)
    (g,) = torch.autograd.grad(ll, p)
    return float(ll.detach()), g.double().cpu().numpy()


def seg_grad(t, y, p, segment, dtype):
    """(ll, g) of ``make_segmented_nll_grad`` in segments of ``segment``
    steps, the O(N) side in ``dtype``; numpy float64 g."""
    from gpar_at_scale_torch.ssm.segmented import make_segmented_nll_grad

    ll, g = make_segmented_nll_grad(matern52_gp, t, y, segment, dtype=dtype)(p.to(dtype))
    return float(ll), g.double().cpu().numpy()


def value_and_grad_fn(route, t, y, dtype=torch.float32, segment=SEGMENT):
    """``p -> (ll, gradient)`` of one route; ll a float, the gradient a
    tensor in p's dtype.  ``dtype`` is the O(N) side's (the kernel routes
    are float32)."""
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    if route == "seg-fisher":
        from gpar_at_scale_torch.ssm.segmented import make_segmented_nll_grad

        grad_fn = make_segmented_nll_grad(matern52_gp, t, y, segment, dtype=dtype)

        def seg(p):
            ll, g = grad_fn(p.to(dtype))
            return float(ll), g.to(p.dtype)

        return seg
    if route == "blocked":
        from gpar_at_scale_torch.ssm.blocked import blocked_logpdf as loglik_of
    elif route == "fisher":
        from gpar_at_scale_torch.ssm.blocked_grad import blocked_loglik as loglik_of
    elif route != "pallas":
        raise ValueError(f"unknown route {route!r}: one of {ROUTES}")
    yd = y.to(dtype)

    def fn(p):
        q = p.detach().clone().requires_grad_(True)
        k, nv = matern52_gp(q)
        if route == "pallas":
            from gpar_at_scale_torch.ops.grad import logpdf_markov_pallas

            ll = logpdf_markov_pallas(k, t, nv, y)
        else:
            ll = loglik_of(lgssm_of(k, t, nv, dtype), yd)
        (g,) = torch.autograd.grad(ll, q)
        return float(ll.detach()), g

    return fn


def optimize(fn, p0, steps, n):
    """``steps`` Adam steps on -ll / n: (params, nll/N per step, the
    parameters after each step)."""
    from gpar_at_scale_torch.inference.optimize import adam_init, adam_update

    p, state, nll, traj = p0.detach().clone(), adam_init(p0), [], []
    for _ in range(steps):
        ll, g = fn(p)
        p, state = adam_update(-g / n, state, p, LR)
        nll.append(-ll / n)
        traj.append(p)
    return p, np.asarray(nll), torch.stack(traj)


def run(N=1_000_000, steps=30, route="blocked", *, device, segment=SEGMENT,
        dtype=torch.float32, seed=0):
    """The script's run of one route on ``device``; prints its lines.
    Returns a dict: ``params`` (log), ``nll`` (per step), ``first_s``,
    ``steady_s``, ``step_ms``."""
    device = torch.device(device)
    t_np, y_np = million_grad_data(N, seed)
    t = torch.as_tensor(t_np, device=device)
    y = torch.as_tensor(y_np).to(device, dtype)
    print(f"N={N}  steps={steps}  device={device_name(device)}", flush=True)
    fn = value_and_grad_fn(route, t, y, dtype, segment)
    p0 = start(device, dtype)

    def once():
        synchronize(device)
        t0 = time.perf_counter()
        out = optimize(fn, p0, steps, N)
        synchronize(device)
        return time.perf_counter() - t0, out

    first, _ = once()
    steady, (p, nll, traj) = once()
    if route in ("fisher", "seg-fisher"):
        if route == "seg-fisher":
            print(f"segments: {-(-N // segment)} x {segment}")
        tr = np.exp(numpy(traj)) + 1e-3
        print("step |    nll/N |     l    sf    sn")
        stride = max(1, steps // 10)
        for i in list(range(0, steps, stride)) + [steps - 1]:
            print(f"{i:4d} | {nll[i]:.6f} | {tr[i, 0]:5.3f} {tr[i, 1]:5.3f} {tr[i, 2]:5.3f}")
    l, sf, sn = (float(v) for v in np.exp(numpy(p)) + 1e-3)
    kind = "; segmented" if route == "seg-fisher" else ""
    print(f"first call (kernels loaded on first use): {first:.2f} s")
    print(f"steady: {steady:.3f} s for {steps} opt steps -> {steady / steps * 1e3:.1f} ms/step "
          f"({N * steps / steady / 1e6:.2f} M filter-steps/s fwd+bwd{kind})")
    print(f"nll {nll[0]:.4f} -> {nll[-1]:.4f}")
    print(f"optimized (l, sf, sn) = ({l:.3f}, {sf:.3f}, {sn:.3f})  true noise {TRUTH[2]}", flush=True)
    return dict(params=numpy(p), nll=nll, first_s=first, steady_s=steady,
                step_ms=1e3 * steady / steps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    args = [a for a in argv if not a.startswith("--")]
    N = int(args[0]) if args else 1_000_000
    steps = int(args[1]) if len(args) > 1 else 30
    route = next((r for r in ROUTES[1:] if f"--{r}" in argv), "blocked")
    return run(N, steps, route, device=device, segment=int_arg(argv, "segment", SEGMENT))


if __name__ == "__main__":
    main()
