#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--outputs 16]

Phases, each of which fails the run:

1. build  -- compile the CUDA kernels from ``gpar_at_scale_torch/csrc/``
   with nvcc for sm_90a (one process per source, in parallel);
2. kernels -- hold K1, K2, K3 (with and without its filtered means) and the
   suffix-scan kernels K4a/K4b (at C = 1 and C = M + 1 columns) against
   their plain PyTorch versions on the card, at the main path's shapes
   (d = 3, N steps), and time both with CUDA events (a kernel slower than
   its plain version is flagged, not failed);
3. serving -- make the 16-output chain data from the seed
   (``data/chain.py``), condition the chain on fixed log-parameters drawn
   from the seed with ``fit_gpar(..., filter_impl="pallas",
   max_opt_steps=0)`` and answer 3 predict requests; K1-K3 must have
   launched in that run; then one more conditioning and request, traced;
4. reference -- at N = 2500 the same chain through the kernels (float32)
   against the sequential Kalman engine (float64), and predictions within
   the observation noise of the latent truth;
5. grad -- at N = 2500 the gradient of output 1's likelihood and of each
   conditional's DTC bound through the kernels (float32) against float64
   sequential autograd;
6. train (the main path) -- ``fit_gpar(..., filter_impl="pallas",
   optimizer="adam", max_opt_steps=10)`` on the 16-output chain from the
   same log-parameters, then 3 requests from the trained chain; every
   kernel must have launched in the training run; then one conditional
   training step, traced;
7. full-N -- outputs 1 and 2 of that run at N = 1e6 against the float64
   blocked engine on the same inputs: the gradient at the start, and 10
   float64 Adam steps beside the training run's nll/N trace.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# The chain of benchmarks/chain_scale.py: N training steps, N* test times,
# M pseudo-points, 10 Adam steps per output.  Only the chain depth P
# (--outputs) may be cut.
N, N_STAR, M = 1_000_000, 10_000, 32
TRAIN_STEPS = 10

# Least-time model of the card (NVIDIA H100 SXM data sheet): HBM3 bandwidth
# and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Tolerances of the kernel checks, as max |kernel - plain| / max |plain| per
# output.  Both sides run the same float32 recursion; the kernel contracts
# a*b + c into FMAs and keeps the d x d algebra in registers, while the
# plain version rounds every product and sums through batched matmuls, and
# K3's plain version re-associates the time recursion into blocks.  Over
# the 62 steps of a block the relative difference grows to O(1e-5); the
# tolerance leaves a factor of about 10 over that.  K4a/K4b's recursions
# contract (their E are adjoint transitions), so they hold the same bound.
TOL = {"K1": 1e-4, "K2": 1e-4, "K3": 1e-4, "K4a": 1e-4, "K4b": 1e-4}
# Reference phase: float32 kernels and smoother against float64 sequential
# filtering at N = 2500, seed 0.  Means are O(1) and differed by at most
# 5.1e-5 on an H100 (6.1e-5 with the plain versions on a CPU): atol 2e-4.
# The latent variances are 3.1e-4 to 1.5e-3 and differed by at most 9.6e-7
# on the card (1.1e-6 on a CPU, 0.41 of the bound): |d| <= 2e-6 + 2e-3 |var|,
# so a zero, halved or doubled variance fails.
REF_MEAN_ATOL = 2e-4
REF_VAR_ATOL, REF_VAR_RTOL = 2e-6, 2e-3
# Gradient phases: float32 kernels against a float64 engine, each
# log-parameter's component on its own:
# |g - g_ref| <= GRAD_RTOL |g_ref| + GRAD_ATOL + GRAD_ATOL_PER_STEP N.
# The float32 path carries an absolute floor that grows with N on the small
# output-kernel components (sizes 4 to 23; the gradient's largest component
# is about N / 2), most likely through the ill-conditioned Gram of the
# float32 whitened columns (not isolated yet).  Measured with the LGSSM
# discretized in float64 (ssm/markov.py::lgssm_of): 0.55 N eps_f32 on a CPU
# at N = 2500 (this script's [grad] phase run there); on an H100 at
# N = 1e6, 0.57 N eps_f32 with Q formed by batched products and 5.6 N eps_f32
# with Q in closed form -- the same float64 Q to rounding, so the floor
# moves with the rounding of Q's smallest entries.  The bound, 8 N eps_f32
# (0.95 at N = 1e6, 1.4 times the largest seen), fails a 25% error of the
# smallest component at N = 1e6 (13.4) and a 1% one at N = 2500.
GRAD_RTOL, GRAD_ATOL, GRAD_ATOL_PER_STEP = 1e-3, 2e-3, 8 * 2.0**-23
# Full-N phase: 10 float64 Adam steps beside the float32 training trace,
# nll/N held to an absolute 1e-6 (measured 6.8e-8 on an H100).
FULL_TRACE_ATOL = 1e-6


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, reps, warmup=1):
    """Mean milliseconds of fn() on the card: CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def _bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# Floating-point operations per step, counted from csrc/ (d x d products are
# 2 d^3, matrix-vector products 2 d^2, the adjugate inverse 42 at d = 3).
def _k1_flops(d):
    inv = {1: 1, 2: 9, 3: 42}[d]
    element = 6 * d * d + 3 * d + 2
    combine = 10 * 2 * d**3 + 4 * 2 * d * d + 2 * inv + 2 * d
    return element + combine


def _k2_flops(d):
    return 2 * d * d + 2 * 2 * d**3 + d * d + 2 * d * d + 4 * d * d + 4 * d + 12


def _k3_flops(d, B):
    return B * (2 * d + 3 + d * (2 * d + 2) + 5)


def _k4a_flops(d, C):
    return 2 * d * d * C + 6 * d**3  # v += E v per column; E E_s and E L E^T


def _k4b_flops(d, C):
    return 2 * d * d * C + 4 * d**3  # v += E v per column; E M E^T


def _grad_gap(got, want, n):
    """(ok, text): each component of the gradient within the bound of the
    gradient phases at N = n, and the relative gap of every component."""
    import numpy as np

    atol = GRAD_ATOL + GRAD_ATOL_PER_STEP * n
    diff = np.abs(got - want)
    over = float((diff / (atol + GRAD_RTOL * np.abs(want))).max())
    rel = (diff / np.abs(want)).tolist()
    ok_ = bool(np.isfinite(got).all()) and over <= 1.0
    return ok_, (f"per-component rel gap {[f'{x:.2e}' for x in rel]}, {over:.3f} of the "
                 f"bound (rtol {GRAD_RTOL} |g| + atol {atol:.3g})")


def _rel_err(got, want, names):
    """(max |got - want|, max over outputs of that over max |want|, and the
    relative error of each named output)."""
    abs_err, per = 0.0, {}
    for g, w, name in zip(got, want, names):
        e = float((g.double() - w.double()).abs().max())
        s = float(w.abs().max())
        abs_err = max(abs_err, e)
        per[name] = e / s if s > 0 else e
    return abs_err, max(per.values()), per


def check_kernels(t, Y, params, M, failures):
    """Phase 2: each kernel against its plain version on the first
    conditional's inputs.  Returns {kernel name: record}; K4a/K4b are
    recorded at C = M + 1 columns (the conditionals) and printed at C = 1
    (output 1) too."""
    import torch

    from gpar_at_scale_torch.kernels import time_kernel_only
    from gpar_at_scale_torch.models.gpar import GPARConfig, _select_pseudo_points, _unpack_cond
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    f32 = torch.float32
    cfg = GPARConfig(backend="scaled", dtype=f32)
    tl, ts, ol, osig, ns, tns = _unpack_cond(cfg, params[1].to(f32))
    time_k = time_kernel_only(cfg.time_family, tl, ts)
    out_k = cfg.out_family(lengthscale=ol, variance=osig**2)
    lgssm = lgssm_of(time_k, t, tns**2, f32)
    X = Y[:, :1]
    batch = torch.cat([Y[:, 1:2], out_k(X, _select_pseudo_points(X, M))], dim=1).contiguous()
    A, Q, R, y = ok._f32_inputs(lgssm, Y[:, 1])
    n, d = A.shape[0], A.shape[-1]
    nb = ok.num_blocks_for(n)
    T = -(-n // nb)
    _log(f"[kernels] N={n} d={d} blocks={nb} x {T} steps, B={batch.shape[1]} columns")
    records = {}

    def record(kernel, key, got, want, names, ms, plain_ms, nbytes, flops, label=None):
        tol_key = key.split("@")[0]
        abs_err, rel_err, per = _rel_err(got, want, names.split())
        bound, by = _bound_ms(nbytes, flops)
        ok_ = math.isfinite(rel_err) and rel_err <= TOL[tol_key]
        name = kernel.name + (f" ({label})" if label else "")
        _log(
            f"[kernels] {name}: max_abs_err={abs_err:.3e} rel={rel_err:.3e} "
            f"(tol {TOL[tol_key]:.0e}) {'ok' if ok_ else 'FAIL'}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
            + " ".join(f"{k}={v:.1e}" for k, v in per.items())
        )
        if not ok_:
            failures.append(f"{name} disagrees with its plain version: rel {rel_err:.3e}")
        if ms > plain_ms:
            _log(f"[kernels] FLAG: {name} is {ms / plain_ms:.2f}x slower than its "
                 f"plain version (ROADMAP, performance queue)")
        records[key] = dict(
            name=kernel.name, route="cuda", source=kernel.source, replaces=kernel.replaces,
            launches=0, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
        )

    # K1: block elements
    e_k = ok.phase1(A, Q, R, y, nb, T)
    e_p = ok.phase1_plain(A, Q, R, y, nb, T)
    _sync(t.device)
    record(
        ok.K1, "K1", e_k, e_p, "A b C eta J",
        _time_ms(lambda: ok.phase1(A, Q, R, y, nb, T), reps=20),
        _time_ms(lambda: ok.phase1_plain(A, Q, R, y, nb, T), reps=3),
        _nbytes(A, Q, R, y, *e_k), n * _k1_flops(d),
    )

    # K2: replay from the phase-2 inits of the kernel's elements
    m0, P0 = ok.block_inits(*e_k)
    o_k = ok.phase3(A, Q, R, y, m0, P0, nb, T)
    o_p = ok.phase3_plain(A, Q, R, y, m0, P0, nb, T)
    _sync(t.device)
    record(
        ok.K2, "K2", o_k, o_p, "alpha logS K m P ll logdet",
        _time_ms(lambda: ok.phase3(A, Q, R, y, m0, P0, nb, T), reps=20),
        _time_ms(lambda: ok.phase3_plain(A, Q, R, y, m0, P0, nb, T), reps=3),
        _nbytes(A, Q, R, y, m0, P0, *o_k), n * _k2_flops(d),
    )

    # K3: the column sweep over [y | K_fu] with the gains of the y = 0 pass,
    # in both modes: as conditioning and serving call it (no means) and as
    # training calls it (every column's filtered means stored too)
    _, _, _, S, K, _, _ = ok.decorrelate_blocked(lgssm, torch.zeros_like(y), return_full=True)
    gains = ow.gain_rows(A, S, K)
    for want_means, key, names in ((False, "K3", "ll alpha"), (True, "K3@means", "ll alpha m")):
        w_k = ow.whiten_sweep(gains, batch, d, want_means=want_means)
        w_p = ow.whiten_sweep_plain(gains, batch, d, want_means=want_means)
        _sync(t.device)
        record(
            ow.K3, key, w_k, w_p, names,
            _time_ms(lambda: ow.whiten_sweep(gains, batch, d, want_means=want_means), reps=3),
            _time_ms(lambda: ow.whiten_sweep_plain(gains, batch, d, want_means=want_means), reps=3),
            _nbytes(gains, batch, *w_k), n * _k3_flops(d, batch.shape[1]),
            label="with means" if want_means else None,
        )
        del w_k, w_p

    # K4a/K4b: the adjoint elements of the whitened-Gram backward (C = M + 1)
    # and their first column alone (the width of output 1's backward)
    _, _, aux = ow.gram_forward(A, Q, R, batch, want_aux=True)
    E, b, W = whiten_bwd_elements(A, ok._e1(d, A), aux)
    del aux
    for C in (1, batch.shape[1]):
        g = b[:, :, :C].contiguous()
        key = "" if C == batch.shape[1] else f"@{C}"
        r1_k = osm.suffix_reduce(E, g, W, nb, T)
        r1_p = osm.r1_plain(E, g, W, nb, T)
        _sync(t.device)
        record(
            osm.K4A, "K4a" + key, r1_k, r1_p, "E g L",
            _time_ms(lambda: osm.suffix_reduce(E, g, W, nb, T), reps=20),
            _time_ms(lambda: osm.r1_plain(E, g, W, nb, T), reps=3),
            _nbytes(E, g, W, *r1_k), n * _k4a_flops(d, C), label=f"C={C}",
        )
        g0, L0 = osm.block_suffix_inits(*r1_k)
        r3_k = osm.suffix_replay(E, g, W, g0, L0, nb, T)
        r3_p = osm.r3_plain(E, g, W, g0, L0, nb, T)
        _sync(t.device)
        record(
            osm.K4B, "K4b" + key, r3_k, r3_p, "v M",
            _time_ms(lambda: osm.suffix_replay(E, g, W, g0, L0, nb, T), reps=20),
            _time_ms(lambda: osm.r3_plain(E, g, W, g0, L0, nb, T), reps=3),
            _nbytes(E, g, W, g0, L0, *r3_k), n * _k4b_flops(d, C), label=f"C={C}",
        )
        del r1_k, r1_p, r3_k, r3_p
    return records


# Device-kernel names of the port's CUDA kernels, as the profiler reports them.
_PORT_KERNELS = ("phase1_kernel", "phase3_kernel", "whiten_kernel", "suffix_reduce_kernel",
                 "suffix_replay_kernel")


def profile_phase(label, fn):
    """Run fn() once under torch.profiler and print the device's busy share
    (kernel time over wall time; one stream, so kernels do not overlap), the
    six kernels that take the most device time, the port's own kernels
    below those, and the sum of the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the CPU-side aten ops also carry the device
    # time of the kernels they launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    _log(f"[profile] {label}: wall {wall:.3f} s traced, device busy {busy:.3f} s "
         f"({100 * busy / wall:.1f}% of the traced wall), {launches} device kernels and copies")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    ours = [e for e in ranked[6:] if any(k in e.key for k in _PORT_KERNELS)]
    for e in ranked[:6] + ours:
        _log(f"[profile] {label}:   {e.self_device_time_total / 1e3:9.2f} ms  "
             f"x{e.count:<6d} {e.key[:70]}")
    rest = [e for e in ranked[6:] if e not in ours]
    _log(f"[profile] {label}:   {sum(e.self_device_time_total for e in rest) / 1e3:9.2f} ms  "
         f"in the {sum(e.count for e in rest)} launches of the {len(rest)} other device kernels")


def seeded_params(P, seed):
    """Log-parameters of the chain, fixed by the seed: the chain
    benchmark's starting values (l = 0.5, sigma = 1.0, noise 0.2 for output
    1; time l 0.5, time sigma 1.0, out l 1.0, out sigma 0.7, noise 0.2 for
    the conditionals) perturbed by N(0, 0.05^2) per entry."""
    import numpy as np

    from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

    import torch

    rng = np.random.default_rng(seed + 1)
    f64 = torch.float64
    base_gp = pack_gp(*(torch.tensor(v, dtype=f64) for v in (0.5, 1.0, 0.2))).numpy()
    base = pack_gpar(*(torch.tensor(v, dtype=f64) for v in (0.5, 1.0, 1.0, 0.7, 0.2))).numpy()
    return [base_gp + 0.05 * rng.normal(size=3)] + [
        base + 0.05 * rng.normal(size=5) for _ in range(P - 1)
    ]


def run_chain(t, Y, t_star, params, cfg, requests, after_fit=None):
    """Condition the chain and answer ``requests`` predict calls on t's
    device; ``after_fit()`` runs between the two.  Returns (model,
    conditioning seconds, request seconds, last prediction)."""
    from gpar_at_scale_torch.models import fit_gpar

    _sync(t.device)
    t0 = time.perf_counter()
    model = fit_gpar(None, t, Y, cfg, init_params=params, device=t.device)
    _sync(t.device)
    cond_s = time.perf_counter() - t0
    if after_fit is not None:
        after_fit()
    lat, pred = [], None
    for _ in range(requests):
        t0 = time.perf_counter()
        pred = model.predict(t_star)
        _sync(t.device)
        lat.append(time.perf_counter() - t0)
    return model, cond_s, lat, pred


def reference_check(seed, failures, device="cuda"):
    """Phase 4: at N = 2500 (above the dense bound, so the kernels whiten
    and the blocked smoother predicts) the float32 kernel path against the
    float64 sequential Kalman engine, and both against the latent truth."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.models import GPARConfig

    t, Y, t_star, lat, sn = make_chain_data(2500, 200, 3, np.random.default_rng(seed))
    params = [torch.as_tensor(p) for p in seeded_params(3, seed)]
    out = {}
    for name, impl, dtype in (("kernels", "pallas", torch.float32),
                              ("sequential", "sequential", torch.float64)):
        cfg = GPARConfig(backend="scaled", filter_impl=impl, num_pseudo_points=8,
                         dtype=dtype, max_opt_steps=0)
        dev = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
        _, _, _, (mu, var) = run_chain(dev(t), dev(Y), dev(t_star),
                                       [p.to(device, dtype) for p in params], cfg, 1)
        out[name] = (mu.double().cpu().numpy(), var.double().cpu().numpy())
    (mu_k, var_k), (mu_s, var_s) = out["kernels"], out["sequential"]
    d_mu = float(np.abs(mu_k - mu_s).max())
    d_var = float(np.abs(var_k - var_s).max())
    var_over = float((np.abs(var_k - var_s) / (REF_VAR_ATOL + REF_VAR_RTOL * np.abs(var_s))).max())
    rmse = np.sqrt(np.mean((mu_k - lat) ** 2, axis=0))
    ok_ = d_mu <= REF_MEAN_ATOL and var_over <= 1.0 and bool(np.all(rmse < sn))
    _log(
        f"[reference] N=2500 P=3 M=8: |mean - ref| {d_mu:.3e} (atol {REF_MEAN_ATOL}), "
        f"|var - ref| {d_var:.3e}, {var_over:.3f} of its bound (atol {REF_VAR_ATOL} + "
        f"rtol {REF_VAR_RTOL}; var {float(var_s.min()):.3e} to {float(var_s.max()):.3e}), "
        f"rmse {np.round(rmse, 4).tolist()} (< noise {sn}) {'ok' if ok_ else 'FAIL'}"
    )
    if not ok_:
        failures.append("reference check failed")


def grad_check(seed, failures, device="cuda"):
    """Phase 5: at N = 2500, P = 3, M = 8 the gradient in the log-parameters
    of output 1's log-likelihood and of each conditional's DTC bound,
    through the kernels (float32, ``filter_impl="pallas"``) against float64
    autograd through the sequential Kalman filter."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.models.gpar import (
        GPARConfig,
        _conditional_bound,
        _first_output_nll,
        _select_pseudo_points,
    )

    t, Y, _, _, _ = make_chain_data(2500, 200, 3, np.random.default_rng(seed))
    params = seeded_params(3, seed)
    for i in range(3):
        grads = {}
        for impl, dtype in (("pallas", torch.float32), ("sequential", torch.float64)):
            cfg = GPARConfig(backend="scaled", filter_impl=impl, num_pseudo_points=8, dtype=dtype)
            dev = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
            if i == 0:
                nll = _first_output_nll(cfg, dev(t), dev(Y[:, 0]))
            else:
                X = dev(Y[:, :i])
                at = _conditional_bound(cfg, dev(t), X, dev(Y[:, i]), _select_pseudo_points(X, 8))
                nll = lambda p, at=at: -at(dtc_objective, p)  # noqa: E731
            p = dev(params[i]).requires_grad_(True)
            value = nll(p)
            value.backward()
            grads[impl] = (float(value.detach()), p.grad.double().cpu().numpy())
        (v_k, g_k), (v_s, g_s) = grads["pallas"], grads["sequential"]
        ok_, gap = _grad_gap(g_k, g_s, t.shape[0])
        _log(f"[grad] y{i + 1:02d}: nll kernels {v_k:.6f} vs float64 {v_s:.6f}; gradient "
             f"{np.round(g_k, 4).tolist()} vs {np.round(g_s, 4).tolist()}; {gap} "
             f"{'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"gradient of y{i + 1:02d} disagrees with float64 autograd")


def train_chain(t, Y, t_star, lat_star, sn, params, failures):
    """Phase 6, the main path: train the chain with 10 Adam steps per
    output through the kernels, then answer 3 requests.  Returns the
    trained model and every kernel's launches in the training run."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.models import GPARConfig
    from gpar_at_scale_torch.ops import KERNELS

    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M,
                     dtype=torch.float32, optimizer="adam", max_opt_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    train_launches = {}
    model, fit_s, lat, (mu, var) = run_chain(
        t, Y, t_star, params, cfg, requests=3,
        after_fit=lambda: train_launches.update({k.name: k.launches for k in KERNELS}),
    )
    n, P = Y.shape
    outs = [model.first] + model.conditionals
    finite = True
    for i, f in enumerate(outs):
        trace = (f.opt.trace.double() / n).cpu().numpy()
        finite &= bool(np.isfinite(trace).all())
        _log(f"[train] y{i + 1:02d}: {f.opt.num_steps} steps in {f.opt.seconds:.3f} s "
             f"({f.opt.seconds / f.opt.num_steps:.4f} s/step); nll/N "
             f"{[round(float(x), 6) for x in trace]}")
        if trace[-1] > trace[0]:
            _log(f"[train] FLAG: y{i + 1:02d} ends at a higher nll/N than it started")
    step_s = [f.opt.seconds / f.opt.num_steps for f in outs]
    mu_np, var_np = mu.double().cpu().numpy(), var.double().cpu().numpy()
    finite &= bool(np.isfinite(mu_np).all() and np.isfinite(var_np).all() and (var_np >= 0).all())
    rmse = np.sqrt(np.mean((mu_np - lat_star) ** 2, axis=0))
    _log(f"[train] fit_gpar (training and q(u)) {fit_s:.3f} s; s/step output 1 "
         f"{step_s[0]:.4f}, conditionals median {float(np.median(step_s[1:])):.4f} "
         f"(min {min(step_s[1:]):.4f}, max {max(step_s[1:]):.4f}); peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _log(f"[train] requests {[round(x, 4) for x in lat]} s; rmse per output vs latent truth "
         f"{np.round(rmse, 4).tolist()}, mean {rmse.mean():.4f} (obs noise {sn}); finite {finite}")
    _log(f"[train] launches in training ({P * TRAIN_STEPS} Adam steps and {P - 1} q(u)): "
         f"{train_launches}")
    if not (finite and mu_np.shape == (N_STAR, P)):
        failures.append("training produced non-finite values or predictions of the wrong shape")
    for k in KERNELS:
        if train_launches[k.name] == 0:
            failures.append(f"{k.name} was not launched on the training path")
    return model, train_launches


def full_n_check(model, params, failures):
    """Phase 7: output 1 and output 2 of the trained chain at the main
    path's N, through the kernels (float32) and through the float64 blocked
    engine on the same float32 inputs: the gradient at the seeded start,
    component by component, and 10 float64 Adam steps from that start beside
    the float32 training trace."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.inference.optimize import minimize_adam
    from gpar_at_scale_torch.models.gpar import GPARConfig, _conditional_bound, _first_output_nll

    engines = (("pallas", torch.float32), ("blocked", torch.float64))
    for i, fit in enumerate((model.first, model.conditionals[0])):
        n = fit.t.shape[0]
        nlls, grads = {}, {}
        for impl, dtype in engines:
            cfg = GPARConfig(backend="scaled", filter_impl=impl, num_pseudo_points=M, dtype=dtype)
            t_, y_ = fit.t.to(dtype), fit.y.to(dtype)
            if i == 0:
                nlls[impl] = _first_output_nll(cfg, t_, y_)
            else:
                at = _conditional_bound(cfg, t_, fit.X_prev.to(dtype), y_, fit.Z.to(dtype))
                nlls[impl] = lambda p, at=at: -at(dtc_objective, p)  # noqa: E731
            p = params[i].detach().to(dtype).requires_grad_(True)
            value = nlls[impl](p)
            value.backward()
            grads[impl] = (float(value.detach()) / n, p.grad.double().cpu().numpy())
        (v_k, g_k), (v_r, g_r) = grads["pallas"], grads["blocked"]
        ok_, gap = _grad_gap(g_k, g_r, n)
        _log(f"[full-N] y{i + 1:02d} N={n}: nll/N kernels {v_k:.8f} vs float64 blocked {v_r:.8f}; "
             f"gradient {np.round(g_k, 3).tolist()} vs {np.round(g_r, 3).tolist()}; {gap} "
             f"{'ok' if ok_ else 'FAIL'}")
        t0 = time.perf_counter()
        ref = minimize_adam(nlls["blocked"], params[i].double(), max_steps=TRAIN_STEPS)
        tr_k = (fit.opt.trace.double() / n).cpu().numpy()
        tr_r = (ref.trace / n).cpu().numpy()
        d_tr = float(np.abs(tr_k - tr_r).max())
        trace_ok = bool(np.isfinite(tr_r).all()) and d_tr <= FULL_TRACE_ATOL
        _log(f"[full-N] y{i + 1:02d}: float64 Adam nll/N {[round(float(x), 6) for x in tr_r]} "
             f"(minimum at step {int(np.argmin(tr_r)) + 1}; float32 kernels' at step "
             f"{int(np.argmin(tr_k)) + 1}), max |float32 - float64| {d_tr:.3e} "
             f"(atol {FULL_TRACE_ATOL}) {'ok' if trace_ok else 'FAIL'}; "
             f"{time.perf_counter() - t0:.1f} s")
        if not ok_:
            failures.append(f"full-N gradient of y{i + 1:02d} disagrees with the float64 engine")
        if not trace_ok:
            failures.append(f"full-N Adam trace of y{i + 1:02d} disagrees with the float64 engine")


def traced_train_step(model, failures):
    """One Adam step of the last conditional, from its trained parameters,
    under the profiler."""
    import torch

    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.inference.optimize import minimize_adam
    from gpar_at_scale_torch.models.gpar import _conditional_bound

    c = model.conditionals[-1]
    at = _conditional_bound(c.cfg, c.t, c.X_prev, c.y, c.Z)
    res = []
    profile_phase("train step", lambda: res.append(
        minimize_adam(lambda p: -at(dtc_objective, p), c.params, max_steps=1)))
    if not bool(torch.isfinite(res[0].params).all()):
        failures.append("the traced training step gave non-finite parameters")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outputs", type=int, default=16, help="chain depth P (16 in the benchmark)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.models import GPARConfig
    from gpar_at_scale_torch.ops import KERNELS
    from gpar_at_scale_torch.ops.build import build_all

    failures = []
    dev_name = torch.cuda.get_device_name(0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {dev_name}, "
         f"{torch.cuda.device_count()} device(s)")

    # 1. build
    t0 = time.perf_counter()
    built = build_all()
    _log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"[build] {name}: {line.strip()}")

    # data and hyperparameters, made from the seed
    t0 = time.perf_counter()
    P = args.outputs
    rng = np.random.default_rng(args.seed)
    t_np, Y_np, ts_np, lat_star, sn = make_chain_data(N, N_STAR, P, rng)
    f32 = torch.float32
    t = torch.as_tensor(t_np).to("cuda", f32)
    Y = torch.as_tensor(Y_np).to("cuda", f32)
    t_star = torch.as_tensor(ts_np).to("cuda", f32)
    params = [torch.as_tensor(p).to("cuda", f32) for p in seeded_params(P, args.seed)]
    _log(f"[data] P={P} N={N} N*={N_STAR} M={M} seed={args.seed} in {time.perf_counter() - t0:.1f} s"
         + ("" if P == 16 else f"  (chain depth cut from 16 to {P})"))
    for i, p in enumerate(params):
        _log(f"[data] log-params y{i + 1:02d}: {np.round(p.cpu().numpy(), 6).tolist()}")

    # 2. kernels against their plain versions
    records = check_kernels(t, Y, params, M, failures)

    # 3. serving: condition the chain on the seeded parameters, answer 3 requests
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M,
                     dtype=f32, max_opt_steps=0)
    for k in KERNELS:
        k.launches = 0
    cond_launches = {}
    model, cond_s, lat, (mu, var) = run_chain(
        t, Y, t_star, params, cfg, requests=3,
        after_fit=lambda: cond_launches.update({k.name: k.launches for k in KERNELS}),
    )
    launches = {k.name: k.launches for k in KERNELS}
    mu_np, var_np = mu.double().cpu().numpy(), var.double().cpu().numpy()
    finite = bool(np.isfinite(mu_np).all() and np.isfinite(var_np).all() and (var_np >= 0).all())
    shape_ok = mu_np.shape == (N_STAR, P) and var_np.shape == (N_STAR, P)
    rmse = np.sqrt(np.mean((mu_np - lat_star) ** 2, axis=0))
    _log(f"[main] conditioning {cond_s:.3f} s ({N * P / cond_s:.4e} obs/s); "
         f"requests {[round(x, 4) for x in lat]} s ({N_STAR * P / min(lat):.4e} predicted points/s)")
    _log(f"[main] rmse per output vs latent truth: {np.round(rmse, 4).tolist()}; "
         f"mean {rmse.mean():.4f} (obs noise {sn}); finite {finite}; shape {mu_np.shape}")
    _log(f"[main] launches: {launches}, of which conditioning {cond_launches} and "
         f"the 3 requests the rest; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (finite and shape_ok):
        failures.append("main-path predictions are not finite or have the wrong shape")
    for k in KERNELS[:3]:  # K4a/K4b are not on the serving path
        if launches[k.name] == 0:
            failures.append(f"{k.name} was not launched on the serving path")
    # where the time goes: one more conditioning and one more request, traced
    from gpar_at_scale_torch.models import fit_gpar

    profile_phase("conditioning", lambda: fit_gpar(None, t, Y, cfg, init_params=params))
    profile_phase("request", lambda: model.predict(t_star))
    del model

    # 4. reference on a small input
    reference_check(args.seed, failures)

    # 5. gradients on a small input
    grad_check(args.seed, failures)

    # 6. the main path: train the chain, answer 3 requests; one step traced
    model, train_launches = train_chain(t, Y, t_star, lat_star, sn, params, failures)
    for key, k in zip(("K1", "K2", "K3", "K4a", "K4b"), KERNELS):
        records[key]["launches"] = train_launches[k.name]
    traced_train_step(model, failures)
    # 7. the start of the training run again at full N, in float64
    full_n_check(model, params, failures)
    del model

    print(json.dumps({"kernels": [records[k] for k in ("K1", "K2", "K3", "K4a", "K4b")]}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
