#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--outputs 16]

Phases, each of which fails the run:

1. build  -- compile the CUDA kernels from ``gpar_at_scale_torch/csrc/``
   with nvcc for sm_90a (one process per source, in parallel);
2. kernels -- hold K1, K2, K3 (with and without its filtered means, on the
   same time blocking as its plain version), the suffix-scan kernels
   K4a/K4b (at C = 1 and C = M + 1 columns) and the adjoint's elements and
   scores K5a/K5b (B = 1, M + 1, a mixed chunk of 5, M + 1 at 10 N steps,
   257 at N / 10) and the smoothing elements K7 (N + N* spliced steps,
   M + 1 columns; then alone at the batched request's 64 draws end to end,
   against its byte bound) against their plain PyTorch
   versions on the card, at the main path's shapes (d = 3, N steps), and
   time both with CUDA events (a kernel slower than its plain version is
   flagged, not failed); the device kernels one K3 sweep runs, with their
   times; K1, K2, K3, K4b and K6a-c at edge shapes (d = 1, 2, masked
   steps, column tiles, ragged and padding-only blocks, K1 on y = 0, K2
   without gains or moments, K4b at C = 1, 33, 70, inputs off a 16-byte
   boundary; several right-hand-side tiles, a batch, the large-n branch;
   K6b/K6c from n = 1 to 512; K7 at d = 1, 2, 3, C = 1 to 1500, ragged
   tiles, inputs off a 16-byte boundary); K6a-c as below;
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
   float64 Adam steps beside the training run's nll/N trace;
8. eeg (the dense path's main path) -- the EEG example (the port's
   ``gpar_at_scale_torch/examples/eeg.py``, its ``run_igp`` and ``run``,
   data from ``data/eeg.py``, seed 0) in float32 with
   ``engine.pallas_dense = "on"``: IGP, exact and scaled GPAR for FZ, F1,
   F2 (L-BFGS, at most 150 steps, the example's starts), the 100 test times
   predicted down the chain; K6a/K6b/K6c must each launch, in the numbers
   the call sites give (training, q(u), each request); then each
   conditional's objective and gradient at the start against float64
   ``torch.linalg``, and the same fits under "off" (the conditionals in
   float64, the example's own precision), SMSE beside;
9. eeg-bench -- ``bench.py``'s pipeline (the port's
   ``gpar_at_scale_torch/benchmarks/bench.py``: 50 Adam steps on the DTC
   bound, q(u), one predictive of 100 points) under "on" and "off": median
   seconds per pipeline and per request (200 sequential requests), one
   traced pipeline's device busy share each; then the port's bench.py per
   mode, its JSON line, and batched serving (200 requests in one
   ``predict_scaled_batch``, 8 rounds, obs/s) held against the 200
   sequential requests, one K6a launch per batched request under "on";
10. parallel -- ``fit_gpar(parallel=True)`` on the chain with phase 6's
   configuration (the JAX package's vmapped fit; the port fits each
   conditional as the sequential fit does), against phase 6's sequential fit from the same start (log-parameters
   within PAR_ATOL), K1-K4b launched; then the EEG chain's six scaled
   conditionals (F3-F6, FZ, F1, F2 in chain order) with
   ``fit_conditionals_parallel`` under "on" (K6a-c launched) and "off",
   FZ, F1, F2 by their float64 objective at the end point beside phase 8's
   sequential fits; seconds of both fits;
11. api -- the reference-named pipeline on ``generate_big_dataset(seed=0)``
   (N = 8496): ``get_sde_predictions`` for output 1, then
   ``get_gpar_scaled_predictions`` for output 2 given output 1's
   predictions (50 pseudo-inputs, 50 L-BFGS steps, 100 Monte-Carlo
   samples), finite, SMSE against the true curves, K1-K4b launched, and the
   end point's DTC bound by the kernels and by the float64 blocked engine;
12. assoc -- the associative-scan engine (tensor code): ``parallel_filter``
   and ``parallel_smooth`` on the first conditional's series (N = 1e6,
   d = 3, one column and M + 1) against K1/K2, K3 and K4a/K4b; one
   objective and gradient of a sum-kernel conditional (Matern-5/2 +
   Matern-1/2, d = 4) under ``filter_impl="pallas"``, which must launch no
   scan kernel, against the float64 blocked engine; 3 Adam steps under
   ``filter_impl="associative"``; seconds and peak device memory of each.

13. ffbs -- 4 joint posterior draws of the Matern-5/2 temporal GP of
   ``benchmarks/million_smc.py``'s data at N = 1e6 (float32) through
   ``blocked_posterior_sample``: the filter with moments on K1/K2, the
   sampling pass on K4a/K4b with C = 4; the draws standardized by the
   smoothed moments, the kernels' draw against the tensor-code affine scan;
14. smc -- ``benchmarks/million_smc.py --host`` through the port's module:
   ``smc_host`` at N = 1e6 (64 particles, 3 mutations, at most 20 stages),
   each particle's likelihood one call on K1/K2; the posterior median
   within 10% of the truth; the smoothed predictive at it;
15. nuts -- ``benchmarks/ess.py --full`` under "on" through the port's
   ``gpar_at_scale_torch/benchmarks/ess.py::run``: NUTS, 8 chains in
   lockstep, over the EEG FZ conditional (N = M = 156, float32, bounded
   reparameterization), the chains' matrices factored as one batch by K6a;
   R-hat, ESS, divergences; each chain's last draw against float64 "off";
   the float32 type-II algebra's gap to the float64 logpost; the predictive
   mixture's SMSE beside the type-II fit's;
16. nuts-smc -- ``benchmarks/nuts_vs_smc.py --pallas`` at N = 1e5, through
   the port's module: NUTS (2 chains,
   gradients through K1/K2 and K4a/K4b) and ``smc_host`` (64 particles) on
   the same temporal likelihood; posterior means within 4 MC errors; the
   kernel path's value and gradient at the last draws against the float64
   blocked engine;
17. segmented -- ``benchmarks/million_grad.py --seg-fisher``: the segmented
   gradient (``ssm/segmented.py::make_segmented_nll_grad``, float32, K1/K2
   forward and K4a/K4b backward per segment) at the start against the
   float64 blocked engine at N = 1e6 (4 segments) and, with the fused
   kernel path at the largest N that fits, against the float64 segmented
   engine there; 20 Adam steps at N = 1e7 in segments of 1e6, whose nll/N
   must fall and which must launch K1, K2, K4a and K4b; peak memory of the
   fused and the segmented gradient; ``segmented_smooth_t`` at N = 2e6
   against the fused ``pallas_smooth`` and float64; ``long_series.py``'s
   segmented draws (N = 2e6, 4 draws) against ``blocked_posterior_sample``
   on the same normals;
18. mixed-bwd -- ``benchmarks/million_dtc.py --mixed-bwd=8`` at N = 1e6:
   the DTC bound's gradient at M = 128 through chunks of 8 mixed columns
   (``ops/grad.py::MixedWhitenGram``: K1/K2 once, K3 and K4a/K4b per chunk)
   against the plain ``WhitenGram`` backward, with the peak memory of each
   and of the plain backward at M = 256; 10 Adam steps at M = 256 with the
   mixed backward;
19. dist -- the parallel layer (``gpar_at_scale_torch/parallel/``): every
   path over NCCL with one rank in this process (the unsharded engines:
   the references, and the unsharded seconds and peak memory), then over
   gloo with 2 spawned ranks sharing the card: ``benchmarks/pod_scale.py``'s
   phase B at N = 1e6 (8 columns through ``make_sharded_decorrelate``,
   ``make_sharded_smooth`` and the gradient of ``make_sharded_logpdf`` on
   the first column; K1/K2 per column, K4a/K4b), the model-sharded bound
   and gradient at N = 1e6, M = 256 (K3 per slab), ``make_sharded_train_step``
   with 8 chains x 5 Adam steps on (chain 2, data 1) and (chain 1, data 2),
   and ``fit_gpar(mesh=)`` on the EEG chain under "on" (K6a-c); each against
   the unsharded result, with seconds and peak memory per rank;
20. aux -- ``run_with_checkpointing`` stopped after 5 of 10 Adam steps and
   resumed, bit for bit against an uninterrupted run; ``stage_timer``
   around a K3 sweep against CUDA events; ``load_eeg_csv`` on a CSV with a
   text time column and an empty cell; and, first of all phases, a
   ``profiler_trace`` around a K3 sweep that must hold its kernels.
21. scripts (run after phase 9) -- the repo's drivers on the port
   (``gpar_at_scale_torch/examples/``, ``gpar_at_scale_torch/benchmarks/``):
   ``dtc_example`` part (a) in float64 (its assertion) and in float32 on
   K1/K2/K3, part (b); ``toy_example``; ``scaled_examples`` small and
   ``--big`` (K1-K4b); ``plot_examples`` (its temporal GP on K1/K2,
   K4a/K4b); ``chain_scale --outputs=2 --steps=2`` at N = 1e6 (K1-K4b, the
   latent band's coverage near 0.95); ``mfu``'s rows (the Gram at N = 1e6,
   M = 256 in float32, float64 and bf16, the dense whitening at 2048, the
   bf16 control); then, at N = 1e6, M = 32, ``million_dtc`` rows (a), (b)
   (3 Adam steps), (c) with ``--check`` and (c) against gp/dtc.py's float64
   predictive, ``million_grad --pallas``, ``long_series`` (every row, the
   kernel rows too; seq at N = 5e3), ``pod_scale`` phase A (64 chains) and
   ``scaling`` with ``--weak`` at 1 and 2 ranks.  The float64 scripts at
   N <= 2048 are held against the same function on the CPU.  The data and
   functions of the [ffbs], [smc], [nuts-smc], [segmented], [mixed-bwd] and
   [dist] seq paths come from the port's ``benchmarks/`` modules.
22. batch-scan (run before phase 12) -- ``predict_scaled_batch`` above
   DENSE_N_MAX: 64 draws around million_dtc's start at N = 1e6, N* = 1e4,
   M = 32 in one request (the draws' series end to end through K1-K3, K7
   and K4a/K4b once), then one draw; the scan kernels' launches and the
   host syncs of a request must not depend on B; draws 0, 32 and 63 against float64
   ``predict_scaled`` within million_dtc (c)'s bound; the batch's peak
   device memory.

Phase 3 also runs the Monte-Carlo predictive ([mc]): the served chain's
last conditional with ``predict_scaled(num_samples=100, generator=...)``
against its analytic predictive (the mean within 6 standard errors, the
f_x part of the variance within 6 sqrt(2 / 99) relative), with both
requests' seconds.

Phase 2 also holds K6a/K6b/K6c against their plain versions at the EEG
shapes (K6a at 156 x 156 with 157 columns and 256 x 256 with 413, that
shape in a batch of 200 (batched serving), and
each with no right-hand side, the factorization alone; K6b and K6c at
156 x 156 with 256 and 157 columns), timed beside the ``torch.linalg``
call that computes the same function by CUDA events and by the profiler's
device time per call (a kernel slower than that call by either is
flagged), with an empty launch as the floor, and the VJPs through the
kernels against the same VJPs through the plain versions.  Phase 9 also
counts the K6 launches and device copies of each traced pipeline.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
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
# plain version rounds every product and sums through batched matmuls (K3's
# two sides share the time blocking, but not the order of the prefix over
# block maps).  Over the 62 steps of a block the relative difference grows
# to O(1e-5); the tolerance leaves a factor of about 10 over that.
# K4a/K4b's recursions contract (their E are adjoint transitions), so they
# hold the same bound.
# K5a forms C_k's first row as a d-term dot product of A_{k+1} and
# I - K_k e1^T, where the plain version sums the same products through a
# batched matmul, and b, W by the same IEEE divisions: O(1e-7) of C's
# scale, held to 1e-5.  K5b sums B^2 products with ctsym per step, then B
# more for R2, Rm and u ctsym u^T, in another order than cuBLAS's, and
# ct_A and ct_R are differences of such sums (R2 A P + Rm against N A P
# ct_ld, u ctsym u^T against ct_ld D) that cancel to well under their
# terms' size: it holds the scan kernels' bound.
# K7 forms each step's E, L and F = E A_{k+1} in registers by FMAs, where
# the plain version rounds every batched product, and g as m - (E A) m
# against the plain m - E (A m).  L = P - E Pp E^T and g cancel to rounding
# at small gaps, but the element after each series' last step is (0, m, P),
# so their largest magnitudes are P's and m's: O(1e-6) of them, held to
# 1e-5 (float32 against a float64 loop on a CPU: at most 1.05e-6).
TOL = {"K1": 1e-4, "K2": 1e-4, "K3": 1e-4, "K4a": 1e-4, "K4b": 1e-4, "K5a": 1e-5, "K5b": 1e-4,
       "K6a": 1e-4, "K6b": 1e-4, "K6c": 1e-4, "K7": 1e-5}
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
# 2 d^3, matrix-vector products 2 d^2).
def _k1_flops(d):
    # A_k A_r and A_k C_r; A_k b_r and A - K h; the upper triangles of
    # Cb (2d each), J and C (2 each); S, 1/S, v; K, h/S, eta, b
    return 4 * d**3 + 4 * d * d + d * (d + 1) * (d + 2) + 3 + 6 * d


def _k2_flops(d):
    return 2 * d * d + 2 * 2 * d**3 + d * d + 2 * d * d + 4 * d * d + 4 * d + 12


def _k3_flops(d, B):
    return B * (2 * d + 3 + d * (2 * d + 2) + 5)


def _k4a_flops(d, C):
    return 2 * d * d * C + 6 * d**3  # v += E v per column; E E_s and E L E^T


def _k4b_flops(d, C):
    return 2 * d * d * C + 4 * d**3  # v += E v per column; E M E^T


def _k5a_flops(d, B):
    return 2 * d * d + 1 + B  # C_k's first row, 1 / S_k, e_k / S_k


def _k5b_flops(d, B):
    # [r_k; u] ctsym, then R2, Rm and u ctsym u^T; u; A P, R2 A P, N A P;
    # A K, D and the scores' elementwise terms
    return (2 * (d + 1) * B * B + (4 * d * d + 2) * B + 2 * d * B + 6 * d**3
            + 2 * d * d + 2 * d * d + 6 * d * d + 4)


def _k7_flops(d, C):
    # A P A^T + Q, P A^T, E, E Pp, L, F = E A (2 d^3 each, d^2 adds); the
    # adjugate and its d^2 divisions (41 at d = 3); g = m - F m per column
    return 14 * d**3 + 2 * d * d + d**3 + d * d + 5 + (2 * d + 1) * d * C


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


def _record(records, failures, kernel, key, got, want, names, ms, plain_ms, nbytes, flops,
            label=None, library_ms=None, device=None):
    """Print one kernel check, fail the run if it disagrees with its plain
    version beyond TOL, and keep its record for the ``kernels`` line.
    ``device`` is (kernel, library) device ms per call, where measured: a
    kernel slower than its library call by either clock is flagged."""
    tol_key = key.split("@")[0]
    abs_err, rel_err, per = _rel_err(got, want, names.split())
    bound, by = _bound_ms(nbytes, flops)
    ok_ = math.isfinite(rel_err) and rel_err <= TOL[tol_key]
    name = kernel.name + (f" ({label})" if label else "")
    lib = "" if library_ms is None else f"library {library_ms:.4f} ms, "
    dev = "" if device is None else (f"device time per call: kernel {device[0]:.4f} ms, "
                                     f"library {device[1]:.4f} ms; ")
    _log(
        f"[kernels] {name}: max_abs_err={abs_err:.3e} rel={rel_err:.3e} "
        f"(tol {TOL[tol_key]:.0e}) {'ok' if ok_ else 'FAIL'}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {lib}bound {bound:.4f} ms ({by}); {dev}"
        + " ".join(f"{k}={v:.1e}" for k, v in per.items())
    )
    if not ok_:
        failures.append(f"{name} disagrees with its plain version: rel {rel_err:.3e}")
    if ms > plain_ms:
        _log(f"[kernels] FLAG: {name} is {ms / plain_ms:.2f}x slower than its "
             f"plain version (ROADMAP, performance queue)")
    for clock, mine, theirs in (("events", ms, library_ms),
                                ("device time", *(device or (None, None)))):
        if theirs is not None and mine > theirs:
            _log(f"[kernels] FLAG: {name} is {mine / theirs:.2f}x slower than its library "
                 f"call ({clock})")
    records[key] = dict(
        name=kernel.name, route="cuda", source=kernel.source, replaces=kernel.replaces,
        launches=0, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=library_ms,
    )


def scan_inputs(t, Y, params, M):
    """The scan kernels' inputs on the first conditional of the chain, at
    the main path's shapes: a dict of the float32 (A, Q, R, y) of its
    LGSSM, the LGSSM, the M + 1 columns [y | K_fu] it whitens, d, n, the
    time blocking nb x T, and the time kernel and noise variance."""
    import torch

    from gpar_at_scale_torch.kernels import time_kernel_only
    from gpar_at_scale_torch.models.gpar import GPARConfig, _select_pseudo_points, _unpack_cond
    from gpar_at_scale_torch.ops import kalman as ok
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
    return dict(A=A, Q=Q, R=R, y=y, lgssm=lgssm, batch=batch, n=n, d=d, nb=nb, T=-(-n // nb),
                time_k=time_k, noise_var=tns**2)


def adjoint_elements(A, Q, R, batch):
    """K4a/K4b's inputs on the main path: the elements (E, b, W) of the
    whitened-Gram backward over the columns ``batch`` (b carries C = M + 1
    columns)."""
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements

    _, _, aux = ow.gram_forward(A, Q, R, batch, want_aux=True)
    return whiten_bwd_elements(A, ok._e1(A.shape[-1], A), aux)


def check_kernels(t, Y, params, M, failures):
    """Phase 2: each kernel against its plain version on the first
    conditional's inputs.  Returns {kernel name: record}; K4a/K4b are
    recorded at C = M + 1 columns (the conditionals) and printed at C = 1
    (output 1) too."""
    import torch

    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops import whiten as ow

    inp = scan_inputs(t, Y, params, M)
    A, Q, R, y, lgssm, batch = (inp[k] for k in ("A", "Q", "R", "y", "lgssm", "batch"))
    n, d, nb, T = inp["n"], inp["d"], inp["nb"], inp["T"]
    _log(f"[kernels] N={n} d={d} blocks={nb} x {T} steps, B={batch.shape[1]} columns")
    records = {}
    record = functools.partial(_record, records, failures)

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
    # (both sides on the same nb x T time blocking)
    for want_means, key, names in ((False, "K3", "ll alpha"), (True, "K3@means", "ll alpha m")):
        sweep = functools.partial(ow.whiten_sweep, gains, batch, d, want_means, nb, T)
        plain = functools.partial(ow.whiten_sweep_plain, gains, batch, d, want_means, nb, T)
        w_k, w_p = sweep(), plain()
        _sync(t.device)
        record(
            ow.K3, key, w_k, w_p, names, _time_ms(sweep, reps=20), _time_ms(plain, reps=3),
            _nbytes(gains, batch, *w_k), n * _k3_flops(d, batch.shape[1]),
            label="with means" if want_means else None,
        )
        del w_k, w_p
    parts = _device_kernels(sweep)
    _log(f"[kernels] K3: one sweep (with means) runs {sum(c for _, c, _ in parts)} device "
         f"kernels, counted as one launch: "
         + "; ".join(f"{name[:40]} x{c} {ms:.4f} ms" for name, c, ms in parts))

    # K4a/K4b: the adjoint elements of the whitened-Gram backward (C = M + 1)
    # and their first column alone (the width of output 1's backward)
    E, b, W = adjoint_elements(A, Q, R, batch)
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
    del E, b, W
    check_adjoint_kernels(A, Q, R, batch, records, failures)
    return records


# K7's request shapes: the batched long-series request's draws, each
# series N + N* spliced steps, laid end to end ([batch-scan], portbench's
# dtc_m32-serve-b64-n1m).
K7_DRAWS = 64


def check_column_elements(t, Y, t_star, params, records, failures):
    """K7 against its plain version at one draw's shapes in the batched
    long-series request: the first conditional's time GP over its N steps
    with the N* held-out times spliced in (noise 1e10), N + N* = 1.01e6
    steps, its y = 0 filter's P and K3's filtered means of the M + 1
    columns [y | K_fu] (zero at the held-out rows); timed beside the plain
    version and, as ``library``, the g update alone as batched cuBLAS
    products (torch.bmm, torch.baddbmm).  Then K7 alone at the whole
    request's shapes, K7_DRAWS such series end to end (6.46e7 steps),
    against its byte bound."""
    import torch

    from gpar_at_scale_torch.gp.dtc import splice
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of

    f32 = torch.float32
    inp = scan_inputs(t, Y, params, M)
    d, batch = inp["d"], inp["batch"]
    order, _, t_s, noise_s = splice(t, t_star, inp["noise_var"], f32)
    lg = lgssm_of(inp["time_k"], t_s, noise_s, f32)
    cols = torch.cat([batch, batch.new_zeros(t_star.shape[0], batch.shape[1])])[order]
    n, C = cols.shape
    A = lg.A
    _, _, _, S, K, _, P = ok.decorrelate_blocked(lg, cols.new_zeros(n), return_gains=True,
                                                 return_moments=True)
    m = ow.whiten_sweep(ow.gain_rows(A, S, K), cols.contiguous(), d, want_means=True)[2]
    del cols, S, K
    g_k, g_p, work = m.clone(), m.clone(), m.clone()
    E_k, L_k = osm.column_elements(lg, g_k, P)
    E_p, L_p = osm.column_elements_plain(lg, g_p, P)
    _sync(t.device)
    A_next = torch.cat([A[1:], torch.zeros_like(A[:1])])
    record = functools.partial(_record, records, failures)
    record(
        osm.K7, "K7", (E_k, L_k, g_k), (E_p, L_p, g_p), "E L g",
        _time_ms(lambda: osm.column_elements(lg, work, P), reps=20),
        _time_ms(lambda: osm.column_elements_plain(lg, work, P), reps=3),
        _nbytes(A, lg.Q, P, m, E_k, L_k, g_k), n * _k7_flops(d, C), label=f"N={n} C={C}",
        library_ms=_time_ms(lambda: torch.baddbmm(m, E_p, torch.bmm(A_next, m), alpha=-1.0),
                            reps=20),
    )
    del g_k, g_p, work, E_k, L_k, E_p, L_p, A_next
    # the whole request: K7_DRAWS copies of the series end to end (A = 0 at
    # each one's first step, as lgssm_batch_of lays the draws)
    big = LGSSM(A=A.repeat(K7_DRAWS, 1, 1), Q=lg.Q.repeat(K7_DRAWS, 1, 1), H=lg.H,
                R=lg.R.repeat(K7_DRAWS), e1=lg.e1)
    P_big, m_big = P.repeat(K7_DRAWS, 1, 1), m.repeat(K7_DRAWS, 1, 1)
    del A, P, m
    nb = K7_DRAWS * n
    ms = _time_ms(lambda: osm.column_elements(big, m_big, P_big), reps=5)
    nbytes = 4 * nb * (5 * d * d + 2 * d * C)  # A, Q, P, m in; E, L, g out
    bound, by = _bound_ms(nbytes, nb * _k7_flops(d, C))
    records["K7"].update(request_n=nb, request_ms=ms, request_bound_ms=bound)
    _log(f"[kernels] K7 at the request's shapes ({K7_DRAWS} draws end to end, n={nb}, C={C}): "
         f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the bound")
    del big, P_big, m_big
    torch.cuda.empty_cache()


def _adjoint_case(A, aux, ct_G, ct_ld, scan_W, record, key, label, H):
    """K5a and K5b on one set of inputs against their plain versions (the
    tensor code with H = e1): the elements, the suffix scan of the plain
    elements (with W, or with W = 0 as the mixed-column backward scans),
    the scores."""
    import torch

    from gpar_at_scale_torch.ops import grad as og
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements, whiten_bwd_scores

    n, d, B = A.shape[0], A.shape[-1], aux[0].shape[1]
    e, S, K, m, P = aux
    el_k = og.adjoint_elements(A, aux)
    el_p = whiten_bwd_elements(A, H, aux)
    _sync(A.device)
    record(
        og.K5A, "K5a" + key, el_k, el_p, "C b W",
        _time_ms(lambda: og.adjoint_elements(A, aux), reps=20),
        _time_ms(lambda: whiten_bwd_elements(A, H, aux), reps=3),
        _nbytes(A, K, S, e, *el_k), n * _k5a_flops(d, B), label=label,
    )
    C, b, W = el_p
    del el_k, el_p
    r, Nmat = osm.suffix_scan(C, b, W if scan_W else torch.zeros_like(W))
    del C, b, W
    sc_k = og.adjoint_scores(A, aux, r, Nmat, ct_G, ct_ld)
    sc_p = whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld)
    _sync(A.device)
    record(
        og.K5B, "K5b" + key, sc_k, sc_p, "ct_A ct_Q ct_R ct_U",
        _time_ms(lambda: og.adjoint_scores(A, aux, r, Nmat, ct_G, ct_ld), reps=20),
        _time_ms(lambda: whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld), reps=3),
        _nbytes(A, P, K, S, e, m, r, Nmat, *sc_k), n * _k5b_flops(d, B), label=label,
    )


def check_adjoint_kernels(A, Q, R, batch, records, failures):
    """K5a and K5b against their plain versions on the whitened-Gram
    backward's inputs of the first conditional (N steps, d = 3): its B =
    M + 1 columns with a random symmetric Gram cotangent and ct_ld (the
    record); the first column alone with ct_G = ct_ld = -1/2 (the
    likelihood's backward, B = 1); 5 columns with ct_G = -I, ct_ld = 0 and
    W = 0 in the scan (a mixed-column chunk); the same inputs repeated to
    10 N steps (the 10^7 cell's size, B = M + 1); and 257 columns (M =
    256) at N / 10 steps."""
    import torch

    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import whiten as ow

    record = functools.partial(_record, records, failures)
    n, d, B = A.shape[0], A.shape[-1], batch.shape[1]
    H = ok._e1(d, A)
    gen = torch.Generator(device=A.device).manual_seed(5)
    _, _, aux = ow.gram_forward(A, Q, R, batch, want_aux=True)

    def sym_ct(b):
        X = torch.randn((b, b), generator=gen, dtype=torch.float64, device=A.device)
        return X + X.T

    def cols(aux_, c):
        e, S, K, m, P = aux_
        return (e[:, :c].contiguous(), S, K, m[:, :, :c].contiguous(), P)

    half = torch.full((1, 1), -0.5, dtype=torch.float64, device=A.device)
    ct_ld = torch.tensor(0.7, dtype=torch.float64, device=A.device)
    _adjoint_case(A, aux, sym_ct(B), ct_ld, True, record, "", f"N={n} B={B}", H)
    _adjoint_case(A, cols(aux, 1), half, -0.5, True, record, "@1", f"N={n} B=1", H)
    eye = -torch.eye(5, dtype=torch.float32, device=A.device)
    _adjoint_case(A, cols(aux, 5), eye, 0.0, False, record, "@mixed", f"N={n} B=5, W=0, ct_ld=0", H)
    big = tuple(x.repeat((10,) + (1,) * (x.ndim - 1)) for x in (A,) + aux)
    _adjoint_case(big[0], big[1:], sym_ct(B), ct_ld, True, record, "@10N", f"N={10 * n} B={B}", H)
    del big, aux
    n10 = n // 10
    U = torch.randn((n10, 257), generator=gen, dtype=torch.float32, device=A.device)
    A10, Q10, R10 = (x[:n10].contiguous() for x in (A, Q, R))
    _, _, aux = ow.gram_forward(A10, Q10, R10, U, want_aux=True)
    _adjoint_case(A10, aux, sym_ct(257), ct_ld, True, record, "@257", f"N={n10} B=257", H)


def check_kernel_edges(failures):
    """K1, K2, K3, K4b, K6a-c and K7 against their plain versions at shapes the main
    paths do not reach: K1, K2 and K4b at d = 1, 2, 3 with a ragged last block,
    blocks of padding only (n = 1000 in 70 blocks of 15 steps, n = 100 in 16
    of 7), blocks shorter than a stage's chunk or not a multiple of it,
    inputs off a 16-byte boundary, K1 on y = 0 (the gain pass), K2 without
    its gains or moments, K4b at C = 1, 33 and 70 (two column tiles); K3 at
    d = 1, 2, 3 with masked steps, one column, several column
    tiles, a ragged last block and a block of padding only; K6a with no, one
    and several right-hand-side tiles, a batch, and n past the shared-memory
    bound (its L2-resident branch); K6b and K6c from n = 1 to 512 with one,
    several and ragged column tiles and a batch; K7 at d = 1, 2, 3 from one
    step to ragged tiles, C = 1 to 1500, inputs off a 16-byte boundary."""
    import numpy as np
    import torch

    from gpar_at_scale_torch import kernels as gk
    from gpar_at_scale_torch.ops import dense
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    rng = np.random.default_rng(3)
    f32 = torch.float32
    worst = {}
    # K1 and K2: a Matern filter of state dimension d; K1 on its observations
    # and on y = 0, K2 replayed from the phase-2 inits, with and without the
    # gains and the moments
    def off16(x):  # x's values 4 bytes into a buffer: data not on a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    family = {1: gk.Matern12, 2: gk.Matern32, 3: gk.Matern52}
    for d, n, nb, T, gains, moments in ((1, 1000, 70, 15, True, True), (2, 100, 16, 7, True, False),
                                        (3, 1000, 70, 15, False, True), (3, 100, 16, 7, True, True),
                                        (3, 333, 7, 48, False, False), (2, 1990, 40, 50, True, True)):
        t_ = torch.as_tensor(np.cumsum(rng.uniform(0.1, 1.0, n)) / 50.0, device=_DEV)
        kern = family[d](lengthscale=torch.tensor(0.7, device=_DEV),
                         variance=torch.tensor(1.3, device=_DEV))
        A, Q, R, y = ok._f32_inputs(lgssm_of(kern, t_, 0.1, f32),
                                    torch.as_tensor(rng.normal(size=n), device=_DEV))
        if T == 48:  # inputs off the 16-byte boundary the staged kernel copies from
            A, Q, R, y = (off16(x) for x in (A, Q, R, y))
        for y1, what in ((y, ""), (torch.zeros_like(y), " y=0")):
            worst[f"K1 d={d} n={n} {nb}x{T}{what}"] = _rel_err(
                ok.phase1(A, Q, R, y1, nb, T), ok.phase1_plain(A, Q, R, y1, nb, T),
                "A b C eta J".split())[1]
        m0, P0 = ok.block_inits(*ok.phase1_plain(A, Q, R, y, nb, T))
        got = ok.phase3(A, Q, R, y, m0, P0, nb, T, gains, moments)
        want = ok.phase3_plain(A, Q, R, y, m0, P0, nb, T)
        asked = (True, True, gains, moments, moments, True, True)
        if [x is not None for x in got] != list(asked):
            failures.append(f"K2 at d={d} n={n} returned outputs it was not asked for")
        pick = lambda o: [x for x, a in zip(o, asked) if a]  # noqa: E731
        worst[f"K2 d={d} n={n} {nb}x{T} gains={gains} moments={moments}"] = _rel_err(
            pick(got), pick(want), pick("alpha logS K m P ll logdet".split()))[1]
    # K4b: contracting E (as the smoother's and the adjoint's are), symmetric
    # L, from the suffix inits of the plain K4a
    for d, n, nb, T, C in ((1, 1000, 70, 15, 1), (2, 100, 16, 7, 33), (3, 1000, 70, 15, 70),
                           (3, 333, 7, 48, 33), (2, 1990, 40, 50, 70), (3, 100, 16, 7, 1)):
        X = rng.normal(size=(n, d, d))
        E, g, L = (torch.as_tensor(x).to(_DEV, f32).contiguous() for x in (
            0.6 * rng.uniform(-1.0, 1.0, size=(n, d, d)) / d, rng.normal(size=(n, d, C)),
            0.5 * (X + np.swapaxes(X, 1, 2))))
        if T == 48:
            E, g, L = (off16(x) for x in (E, g, L))
        g0, L0 = osm.block_suffix_inits(*osm.r1_plain(E, g, L, nb, T))
        worst[f"K4b d={d} n={n} {nb}x{T} C={C}"] = _rel_err(
            osm.suffix_replay(E, g, L, g0, L0, nb, T), osm.r3_plain(E, g, L, g0, L0, nb, T),
            ["v", "M"])[1]
    # K5a/K5b: random inputs at d = 1, 2, 3; one step, ragged last tiles of
    # K5b's (up to 32 steps, fewer at wide B) and K5a's 128, inputs off a
    # 16-byte boundary, B = 1 to 257 (ctsym staged and read through L2)
    from gpar_at_scale_torch.ops import grad as og
    from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements, whiten_bwd_scores

    for d, n, B, off in ((1, 1, 1, False), (2, 33, 2, True), (3, 100, 7, False),
                         (3, 1000, 33, True), (2, 129, 70, False), (3, 65, 130, False),
                         (1, 300, 257, True)):
        arrays = [torch.as_tensor(rng.normal(size=shape)).to(_DEV, f32).contiguous() for shape in (
            (n, d, d), (n, d, d), (n, d), (n, B), (n, d, B), (n, d, B), (n, d, d))]
        arrays.append(torch.as_tensor(rng.uniform(0.5, 2.0, n)).to(_DEV, f32))
        if off:
            arrays = [off16(x) for x in arrays]
        A, P, K, e, m, r, Nm, S = arrays
        aux, H = (e, S, K, m, P), ok._e1(d, A)
        X = rng.normal(size=(B, B))
        ct_G = torch.as_tensor(X + X.T, device=_DEV)
        worst[f"K5a d={d} n={n} B={B}"] = _rel_err(
            og.adjoint_elements(A, aux), whiten_bwd_elements(A, H, aux), "C b W".split())[1]
        worst[f"K5b d={d} n={n} B={B}"] = _rel_err(
            og.adjoint_scores(A, aux, r, Nm, ct_G, 0.3),
            whiten_bwd_scores(A, H, aux, r, Nm, ct_G, 0.3), "ct_A ct_Q ct_R ct_U".split())[1]
    # K7: d = 1, 2, 3; one step, ragged last tiles (32 steps at C <= 42 where
    # d = 3, 4 at C = 257), inputs off a 16-byte boundary (m copied back)
    from gpar_at_scale_torch.ssm.markov import LGSSM

    for d, n, C, off in ((1, 1, 1, False), (2, 33, 5, True), (3, 1000, 33, False),
                         (3, 333, 257, True), (1, 1001, 1500, False), (2, 4097, 70, False)):
        t_ = torch.as_tensor(np.cumsum(rng.uniform(0.1, 1.0, n)) / 50.0, device=_DEV)
        kern = family[d](lengthscale=torch.tensor(0.7, device=_DEV),
                         variance=torch.tensor(1.3, device=_DEV))
        lg = lgssm_of(kern, t_, 0.1, f32)
        X = rng.normal(size=(n, d, d))
        P = torch.as_tensor(X @ np.swapaxes(X, 1, 2) / d + 0.1 * np.eye(d)).to(_DEV, f32)
        m = torch.as_tensor(rng.normal(size=(n, d, C))).to(_DEV, f32)
        if off:
            lg = LGSSM(A=off16(lg.A), Q=off16(lg.Q), H=lg.H, R=lg.R, e1=lg.e1)
            P, m = off16(P), off16(m)
        g_k, g_p = m.clone(), m.clone()
        if off:
            g_k = off16(g_k)
        got = osm.column_elements(lg, g_k, P)
        worst[f"K7 d={d} n={n} C={C}"] = _rel_err(
            got + (g_k,), osm.column_elements_plain(lg, g_p, P) + (g_p,), "E L g".split())[1]
    for d, n, B, nb, T in ((1, 9, 1, 4, 3), (2, 333, 70, 20, 17), (3, 333, 33, 7, 48),
                           (3, 1000, 5, 62, 17)):
        S = rng.uniform(0.5, 2.0, n)
        mask = (rng.uniform(size=n) > 0.1).astype(np.float64)
        gains = np.concatenate([S[:, None], np.log(S)[:, None], mask[:, None],
                                rng.normal(size=(n, 2 * d)), rng.uniform(-0.6, 0.6, (n, d * d)) / d],
                               axis=1)
        g = torch.as_tensor(gains).to(_DEV, f32).contiguous()
        Y = torch.as_tensor(rng.normal(size=(n, B))).to(_DEV, f32)
        got = ow.whiten_sweep(g, Y, d, True, nb, T)
        want = ow.whiten_sweep_plain(g, Y, d, True, nb, T)
        worst[f"K3 d={d} n={n} B={B} {nb}x{T}"] = _rel_err(got, want, "ll alpha m".split())[1]
    for n, k, batch in ((13, 0, 1), (13, 5, 1), (40, 70, 3), (156, 150, 1), (300, 130, 1),
                        (512, 3, 1), (256, 413, 200)):
        A = torch.as_tensor(rng.normal(size=(batch, n, n))).to(_DEV, f32)
        S = (A @ A.transpose(-1, -2) + n * torch.eye(n, device=_DEV)).contiguous()
        Bm = torch.as_tensor(rng.normal(size=(batch, n, k))).to(_DEV, f32)
        got, want = dense.chol_solve(S, Bm), dense.chol_solve(S, Bm, plain=True)
        names = "U W logdet" if k else "U logdet"
        pick = (lambda o: o[:3]) if k else (lambda o: o[:3:2])
        worst[f"K6a n={n} k={k} batch={batch}"] = _rel_err(pick(got), pick(want), names.split())[1]
        if got[3].tolist() != want[3].tolist():
            failures.append(f"K6a info {got[3].tolist()} != plain {want[3].tolist()} at n={n}")
    # K6b/K6c: one tile, several, ragged ones, a batch, n past 280
    for n, k, batch in ((1, 1, 1), (13, 5, 1), (40, 70, 3), (156, 157, 1), (300, 130, 1),
                        (512, 3, 1), (512, 600, 1), (156, 256 * 200, 1)):
        A = torch.as_tensor(rng.normal(size=(batch, n, n)), device=_DEV)
        L = torch.linalg.cholesky(A @ A.transpose(-1, -2) + n * torch.eye(n, device=_DEV))
        U = L.mT.to(f32).contiguous()
        Bm = torch.as_tensor(rng.normal(size=(batch, n, k))).to(_DEV, f32)
        for name, fn in (("K6b", dense.tri_ut), ("K6c", dense.tri_u)):
            worst[f"{name} n={n} k={k} batch={batch}"] = _rel_err(
                [fn(U, Bm)], [fn(U, Bm, plain=True)], ["X"])[1]
    _sync(_DEV)
    for name, rel in worst.items():
        ok_ = math.isfinite(rel) and rel <= TOL[name.split()[0]]
        _log(f"[kernels] edge {name}: rel {rel:.3e} {'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"edge case {name} disagrees with its plain version: rel {rel:.3e}")


# Device-kernel names of the port's CUDA kernels, as the profiler reports them.
_PORT_KERNELS = ("phase1_kernel", "phase3_kernel", "sweep_kernel", "prefix_kernel",
                 "ll_sum_kernel", "suffix_reduce_kernel", "suffix_replay_kernel",
                 "chol_solve_kernel", "chol_solve_l2_kernel", "tri_kernel",
                 "smoothing_elements_kernel")


def _device_kernels(fn):
    """The device kernels and copies one call of fn() runs (torch.profiler):
    [(name, count, device ms)]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _device_ms(fn, reps=20):
    """Device milliseconds per call of fn(): the device kernels and copies
    of ``reps`` calls after one warm-up call (torch.profiler), summed, over
    ``reps``.  Unlike ``_time_ms`` it does not count the host's time
    between back-to-back calls of a short kernel."""
    fn()
    return sum(ms for _, _, ms in _device_kernels(lambda: [fn() for _ in range(reps)])) / reps


def profile_phase(label, fn):
    """Run fn() once under torch.profiler and print the device's busy share
    (kernel time over wall time; one stream, so kernels do not overlap), the
    six kernels that take the most device time, the port's own kernels
    below those, and the sum of the rest.  Returns every device kernel and
    copy as (name, count, ms)."""
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
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in events]


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


def _scan_kernels():
    """K1-K5b, the kernels of the N = 1e6 chain (K6a-c take the dense
    path, [eeg]; K4a-K5b run in training only)."""
    from gpar_at_scale_torch.ops import K1, K2, K3, K4A, K4B, K5A, K5B

    return (K1, K2, K3, K4A, K4B, K5A, K5B)


def train_chain(t, Y, t_star, lat_star, sn, params, failures):
    """Phase 6, the main path: train the chain with 10 Adam steps per
    output through the kernels, then answer 3 requests.  Returns the
    trained model, every kernel's launches in the training run and the
    training run's seconds."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.models import GPARConfig

    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M,
                     dtype=torch.float32, optimizer="adam", max_opt_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    for k in _scan_kernels():
        k.launches = 0
    train_launches = {}
    model, fit_s, lat, (mu, var) = run_chain(
        t, Y, t_star, params, cfg, requests=3,
        after_fit=lambda: train_launches.update({k.name: k.launches for k in _scan_kernels()}),
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
    for k in _scan_kernels():
        if train_launches[k.name] == 0:
            failures.append(f"{k.name} was not launched on the training path")
    return model, train_launches, fit_s


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

    from gpar_at_scale_torch.ops import launch_counts

    c = model.conditionals[-1]
    at = _conditional_bound(c.cfg, c.t, c.X_prev, c.y, c.Z)
    res = []
    before = launch_counts()
    profile_phase("train step", lambda: res.append(
        minimize_adam(lambda p: -at(dtc_objective, p), c.params, max_steps=1)))
    step = {k.split()[0]: v - before[k] for k, v in launch_counts().items() if v > before[k]}
    _log(f"[profile] train step: launches {step}")
    if not bool(torch.isfinite(res[0].params).all()):
        failures.append("the traced training step gave non-finite parameters")
    if step.get("K5a") != 1 or step.get("K5b") != 1:
        failures.append(f"one Adam step launched K5a/K5b {step.get('K5a')}/{step.get('K5b')} "
                        "times, not once each")


# ---------------------------------------------------------------------------
# The EEG chain on the dense path: kernels K6a/K6b/K6c
# ---------------------------------------------------------------------------

# The EEG example (examples/eeg.py): FZ -> F1 -> F2, each conditioned on the
# observed F3-F6 and the channels before it, 156 training points, 100 test
# times, M = 156 pseudo-points (the training inputs), the example's starts,
# L-BFGS for at most 150 steps.  float32, data from data/eeg.py (seed 0).
EEG_PREDICTED = ("FZ", "F1", "F2")
_DEV = "cuda"  # the card; a rehearsal on the host sets "cpu"
EEG_OBSERVED = ("F3", "F4", "F5", "F6")
EEG_STEPS = 150
EEG_GP_START = (0.05, 1.0, 0.3)  # pack_gp: lengthscale, sigma, noise sigma
EEG_COND_START = (0.1, 1.0, 1.0, 1.0, 0.3)  # pack_gpar
# K6a, K6b, K6c launches at the JAX package's call sites.  One objective and
# gradient evaluation: exact -- cholesky_psd(K + s2 I) and solve_lower(L, y)
# (gp/exact.py:44,46), and the VJPs' three K6c (two for the factorization,
# the JAX package's third solves the zero column it passes, which the port
# does not pass; one for the solve); scaled -- chol_solve(Sigma_y,
# [y | K_fu]) (gp/dtc.py:200-210) and cholesky_psd(K_uu) (:210), then
# solve_lower(L_P, g) (:306; chol(P) itself is jnp.linalg.cholesky there,
# torch.linalg here), and the VJPs' 3 + 2 + 1 K6c.  An evaluation whose
# factorization fails (inference/optimize.py) stops after its K6a launches,
# before the K6b, so training launches evals x eval with a surplus of K6a.
# q(u) (:346-353): the whitening's K6a and cholesky_psd(K_uu), the two
# solves on L_uu of _lam_chol (chol(Lam) is jnp.linalg.cholesky), the solve
# L_uu^-1 g and cho_solve(L_D, .).  A request: scaled -- the smoother's
# chol_solve (:375-381) and the two solves of :478, :482; exact -- condition
# (cholesky_psd, cho_solve; gp/exact.py:112-113) and predict_f's solve
# (:77); IGP -- the port's dense smoother (the JAX package's temporal
# predict runs its sequential RTS smoother instead).
EEG_EXPECT = {
    "IGP": {"eval": (0, 0, 0), "q(u)": (0, 0, 0), "request": (1, 0, 0)},
    "exact": {"eval": (1, 1, 3), "q(u)": (0, 0, 0), "request": (1, 2, 1)},
    "scaled": {"eval": (2, 1, 6), "q(u)": (2, 4, 1), "request": (1, 2, 0)},
}
# K6 gradient check on the card: the VJPs through the kernels against the
# same VJPs through the plain versions, max |kernel - plain| / max |plain|
# per input.
K6_GRAD_TOL = 1e-3
# Requests of bench.py's batched serving (bench.py:178-192): K6a's batch.
BATCH_REQUESTS = 200
# [eeg] start-parameter check, float32 kernels against float64 torch.linalg,
# each component of the gradient on its own:
# |g - g_ref| <= EEG_GRAD_RTOL |g_ref| + EEG_GRAD_ATOL.
# With the plain versions on a CPU the gap was at most 0.02 of a bound of
# 1e-2 |g| + 1e-2 (components 0.9 to 89); the bound set, 1e-3 |g| + 2e-3,
# fails a 0.2% error of the largest component.  The objectives (about 170)
# agreed to 7e-7 relative there: held to 2e-5.
EEG_GRAD_RTOL, EEG_GRAD_ATOL = 1e-3, 2e-3
EEG_VALUE_RTOL = 2e-5


def _dense():
    from gpar_at_scale_torch.ops import K6A, K6B, K6C

    return (K6A, K6B, K6C)


def _dense_counts():
    return tuple(k.launches for k in _dense())


def _minus(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _get_dense_mode():
    from gpar_at_scale_torch.config import get_config

    return get_config().engine.pallas_dense


def _set_dense_mode(mode):
    from gpar_at_scale_torch.config import get_config

    get_config().engine.pallas_dense = mode


def _tensor_params(values, fn, device, dtype):
    import torch

    return fn(*(torch.tensor(v, dtype=torch.float64) for v in values)).to(device, dtype)


def dense_inputs(ds, device):
    """The dense matrices of FZ's scaled conditional at the example's
    start, float32: Sigma_y (156 x 156) with [y | K_fu] (157 columns), the
    spliced smoother's Sigma (256 x 256) with [K | y | K_*u] (413 columns),
    and U = chol(K_uu)^T with K_*u^T (256 columns)."""
    import torch

    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS
    from gpar_at_scale_torch.kernels import Matern52

    f32 = torch.float32
    n = TRAIN_POINTS
    t = torch.as_tensor(ds.t).to(device, f32)
    X = torch.as_tensor(ds.Y[:, [ds.channels.index(c) for c in EEG_OBSERVED]]).to(device, f32)
    y = torch.as_tensor(ds.Y[:n, ds.channels.index("FZ")]).to(device, f32)
    tl, ts, ol, osig, ns = EEG_COND_START
    time_k = Matern52(lengthscale=torch.tensor(tl, device=device),
                      variance=torch.tensor(ts**2, device=device))
    out_k = Matern52(lengthscale=torch.tensor(ol, device=device),
                     variance=torch.tensor(osig**2, device=device))
    eye = torch.eye(n, dtype=f32, device=device)
    Sigma_y = (time_k(t[:n, None], t[:n, None]) + ns**2 * eye).contiguous()
    Kfu = out_k(X[:n], X[:n])
    batch = torch.cat([y[:, None], Kfu], dim=1).contiguous()
    n_all = t.shape[0]
    noise = torch.cat([torch.full((n,), ns**2), torch.full((n_all - n,), 1e10)]).to(device, f32)
    K = time_k(t[:, None], t[:, None])
    Sigma_s = (K + torch.diag(noise)).contiguous()
    y_s = torch.cat([y, y.new_zeros(n_all - n)])
    K_su = out_k(X, X[:n])
    both = torch.cat([K, y_s[:, None], K_su], dim=1).contiguous()
    # test-harness factor (the port never calls torch.linalg on this path)
    L_uu = torch.linalg.cholesky((Kfu + ns**2 * eye).double()).to(f32)
    return dict(Sigma_y=Sigma_y, batch=batch, Sigma_s=Sigma_s, both=both,
                U=L_uu.T.contiguous(), L=L_uu.contiguous(), Kus=K_su.T.contiguous())


def _chol_flops(n, k):
    return n**3 / 3 + n * n * k


def check_dense_kernels(ds, failures):
    """K6a/K6b/K6c against their plain versions on the card at the EEG
    shapes, timed beside the library call that computes the same function
    (``torch.linalg.cholesky_ex`` + ``solve_triangular``, used nowhere in
    the port); then the VJPs through the kernels against the plain
    versions'.  Returns the records of K6a (156, 157), K6b (156, 256) and
    K6c (156, 157), the training, predictive and backward shapes."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.ops import dense

    m = dense_inputs(ds, _DEV)
    records = {}
    record = functools.partial(_record, records, failures)
    for key, S, B in (("K6a", m["Sigma_y"], m["batch"]), ("K6a@256", m["Sigma_s"], m["both"])):
        n, k = B.shape
        got = dense.chol_solve(S, B)
        want = dense.chol_solve(S, B, plain=True)
        _sync(_DEV)
        if int(got[3]) != 0 or int(want[3]) != 0:
            failures.append(f"K6a reports a non-positive pivot at n={n}: {int(got[3])}")

        def library(S=S, B=B):
            L = torch.linalg.cholesky_ex(S).L
            return torch.linalg.solve_triangular(L, B, upper=False)

        record(dense.K6A, key, got[:3], want[:3], "U W logdet",
               _time_ms(lambda: dense.chol_solve(S, B), reps=20),
               _time_ms(lambda: dense.chol_solve(S, B, plain=True), reps=3),
               _nbytes(S, B, *got), _chol_flops(n, k), label=f"n={n} k={k}",
               library_ms=_time_ms(library, reps=20),
               device=(_device_ms(lambda: dense.chol_solve(S, B)), _device_ms(library)))
        # the factorization alone (k = 0, as utils/psd.py calls it)
        empty = B[:, :0].contiguous()
        got0 = dense.chol_solve(S, empty)
        want0 = dense.chol_solve(S, empty, plain=True)
        _sync(_DEV)
        record(dense.K6A, f"{key}@k0", got0[:3:2], want0[:3:2], "U logdet",
               _time_ms(lambda: dense.chol_solve(S, empty), reps=20),
               _time_ms(lambda: dense.chol_solve(S, empty, plain=True), reps=3),
               _nbytes(S, *got0), _chol_flops(n, 0), label=f"n={n} k=0",
               library_ms=_time_ms(lambda: torch.linalg.cholesky_ex(S), reps=20),
               device=(_device_ms(lambda: dense.chol_solve(S, empty)),
                       _device_ms(lambda: torch.linalg.cholesky_ex(S))))
    # the batched predictive's shape (bench.py's 200 requests in one call,
    # gp/dtc.py::predict_scaled_batch): 200 spliced covariances, 413 columns
    S = (m["Sigma_s"][None] * torch.linspace(1.0, 1.2, BATCH_REQUESTS, device=_DEV)[:, None, None]
         ).contiguous()
    B = m["both"][None].expand(BATCH_REQUESTS, -1, -1).contiguous()
    b, n, k = B.shape
    got, want = dense.chol_solve(S, B), dense.chol_solve(S, B, plain=True)
    _sync(_DEV)
    if int(got[3].max()) != 0:
        failures.append(f"K6a reports a non-positive pivot in the batch of {b}")

    def library_batch():
        return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(S).L, B, upper=False)

    record(dense.K6A, f"K6a@b{b}", got[:3], want[:3], "U W logdet",
           _time_ms(lambda: dense.chol_solve(S, B), reps=20),
           _time_ms(lambda: dense.chol_solve(S, B, plain=True), reps=3),
           _nbytes(S, B, *got), b * _chol_flops(n, k), label=f"batch={b} n={n} k={k}",
           library_ms=_time_ms(library_batch, reps=20),
           device=(_device_ms(lambda: dense.chol_solve(S, B)), _device_ms(library_batch)))
    del S, B, got, want
    U, L = m["U"], m["L"]
    for kern, fn, key, lib in (
        (dense.K6B, dense.tri_ut, "K6b", lambda B: torch.linalg.solve_triangular(L, B, upper=False)),
        (dense.K6C, dense.tri_u, "K6c", lambda B: torch.linalg.solve_triangular(U, B, upper=True)),
    ):
        for B in (m["Kus"], m["batch"]):
            k = B.shape[1]
            got = fn(U, B)
            want = fn(U, B, plain=True)
            _sync(_DEV)
            main = (key == "K6b") == (k == m["Kus"].shape[1])
            record(kern, key if main else f"{key}@{k}", [got], [want], "X",
                   _time_ms(lambda: fn(U, B), reps=20),
                   _time_ms(lambda: fn(U, B, plain=True), reps=3),
                   _nbytes(U, B, got), U.shape[0] ** 2 * k, label=f"n={U.shape[0]} k={k}",
                   library_ms=_time_ms(lambda: lib(B), reps=20),
                   device=(_device_ms(lambda: fn(U, B)), _device_ms(lambda: lib(B))))
    # the floor under a short kernel's time: an empty launch, timed the same ways
    _log(f"[kernels] empty launch (torch.cuda._sleep(0)): events "
         f"{_time_ms(lambda: torch.cuda._sleep(0), reps=20):.4f} ms, device time "
         f"{_device_ms(lambda: torch.cuda._sleep(0)):.4f} ms per call")

    # the VJPs (ops/dense.py: CholSolve, TriUT, TriU) through the kernels
    # against the same algebra through the plain versions
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.normal(size=m["Sigma_y"].shape[0])).to(_DEV, torch.float32)

    def grads(f, *xs):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        return torch.autograd.grad(f(*leaves), leaves)

    def chol_scalar(plain):
        def f(S, B):
            U_, W, ld, _ = dense.chol_solve(S, B, plain)
            return (W * W).sum() + 0.7 * ld + (U_ @ c).sum()
        return f

    def tri_scalar(fn, plain):
        return lambda U_, B: torch.cos(fn(U_, B, plain)).sum()

    cases = [("K6a", chol_scalar, (m["Sigma_y"], m["batch"]))]
    cases += [(name, functools.partial(tri_scalar, fn), (U, m["batch"]))
              for name, fn in (("K6b", dense.tri_ut), ("K6c", dense.tri_u))]
    for name, make, args in cases:
        g_k, g_p = grads(make(False), *args), grads(make(True), *args)
        _sync(_DEV)
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p)]
        ok_ = all(math.isfinite(r) and r <= K6_GRAD_TOL for r in rel)
        _log(f"[kernels] {name} VJP through the kernels vs the plain versions: rel "
             f"{[f'{r:.2e}' for r in rel]} (tol {K6_GRAD_TOL:.0e}) {'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"the {name} VJP through the kernels disagrees with the plain versions")
    return records


def _check_eeg_counts(model, ch, train, qu, req, failures):
    """The launches of one fit against the call sites (EEG_EXPECT): q(u)
    and a request exact; training a whole number of evaluations, counted by
    their K6b launches, plus the K6a launches of evaluations that left the
    domain.  Returns (evaluations, K6a launches of those that left it)."""
    want = EEG_EXPECT[model]
    ev = want["eval"]
    if ev[1]:
        evals = train[1] // ev[1]
        ok_ = (evals >= 1 and train[1:] == (evals * ev[1], evals * ev[2])
               and train[0] >= evals * ev[0])
    else:
        evals, ok_ = 0, train == (0, 0, 0)
    if not (ok_ and qu == want["q(u)"] and req == want["request"]):
        failures.append(f"[eeg] {model} {ch}: launches train {train}, q(u) {qu}, request {req} "
                        f"do not match the call sites {want}")
    return evals, train[0] - evals * ev[0]


def _nll64(fit):
    """A conditional's objective at its fitted parameters in float64 with
    ``torch.linalg``: how far the float32 value it ended at is rounding."""
    import dataclasses

    import torch

    from gpar_at_scale_torch.gp import exact as exact_gp
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.models.gpar import _conditional_bound, _exact_kernel

    f64 = torch.float64
    cfg = dataclasses.replace(fit.cfg, dtype=f64)
    t, X, y, p = (a.to(f64) for a in (fit.t, fit.X_prev, fit.y, fit.params))
    mode = _get_dense_mode()
    _set_dense_mode("off")
    try:
        with torch.no_grad():
            if fit.backend == "scaled":
                return -float(_conditional_bound(cfg, t, X, y, fit.Z.to(f64))(dtc_objective, p))
            F = torch.cat([t[:, None], X], dim=1)
            k, nv = _exact_kernel(cfg, F.shape[1], p)
            return float(exact_gp.nlml(k, F, y, nv))
    finally:
        _set_dense_mode(mode)


def eeg_run(ds, mode, failures, dtype=None):
    """The EEG example on the card with ``engine.pallas_dense = mode``,
    through ``gpar_at_scale_torch/examples/eeg.py``'s ``run_igp`` and
    ``run``: IGP, exact and scaled GPAR for FZ, F1, F2, each channel
    predicted from the test-time observed channels and the predicted means
    of those before.  IGP runs in float32 through the scan kernels
    (``filter_impl="pallas"``: the example's "auto" takes the sequential
    filter at this N, a Python loop of 156 steps per evaluation, 1.09 s per
    L-BFGS step on the card), the conditionals in ``dtype`` (float32 by
    default).  The example's ``observe`` hook reads the launch counts and
    the request's time around each fit.  Returns ({model: {channel:
    mean}}, seconds per optimizer step, seconds per request, launches of
    K6a-c in training, q(u) and requests summed over the fits,
    {(backend, channel): the conditional's float64 objective at its end
    point})."""
    import torch

    from gpar_at_scale_torch.examples import eeg as example
    from gpar_at_scale_torch.gp.dtc import compute_q_u
    from gpar_at_scale_torch.models import gpar

    _set_dense_mode(mode)
    f32 = torch.float32
    dtype = dtype or f32
    step_s = {m: [] for m in EEG_EXPECT}
    req_s = {m: [] for m in EEG_EXPECT}
    totals = {part: (0, 0, 0) for part in ("train", "q(u)", "request")}
    ends = {}
    qus = []

    def add(part, c):
        totals[part] = tuple(a + b for a, b in zip(totals[part], c))

    def counted_q_u(*args, **kwargs):
        # the fit's own q(u) at its optimum, with the counts read around it
        before_qu = _dense_counts()
        out = compute_q_u(*args, **kwargs)
        qus.append(_minus(_dense_counts(), before_qu))
        return out

    def observer(model):
        state = {}

        def observe(event, ch, fit):
            _sync(_DEV)
            if event == "start":
                qus.clear()
                state["before"] = _dense_counts()
                return
            if event == "fit":
                state["qu"] = qus[0] if qus else (0, 0, 0)
                state["train"] = _minus(_minus(_dense_counts(), state["before"]), state["qu"])
                state["req"] = _dense_counts()
                state["t0"] = time.perf_counter()
                return
            secs = time.perf_counter() - state["t0"]
            train, qu, req = state["train"], state["qu"], _minus(_dense_counts(), state["req"])
            if model == "IGP":
                if mode == "on":
                    _check_eeg_counts("IGP", ch, train, (0, 0, 0), req, failures)
            else:
                ends[(model, ch)] = _nll64(fit)
                if mode == "on":
                    evals, left = _check_eeg_counts(model, ch, train, qu, req, failures)
                    _log(f"[eeg] {mode} {model} {ch}: {fit.opt.num_steps} L-BFGS steps, {evals} "
                         f"evaluations (+{left} K6a launches of evaluations that left the domain), "
                         f"nll {float(fit.opt.value):.4f} (float64 at these parameters "
                         f"{ends[(model, ch)]:.4f}), {fit.opt.seconds:.3f} s; "
                         f"K6a/K6b/K6c launches: training {train}, q(u) {qu}, request {req}")
                else:
                    _log(f"[eeg] {mode} {model} {ch}: {fit.opt.num_steps} L-BFGS steps, nll "
                         f"{float(fit.opt.value):.4f}, {fit.opt.seconds:.3f} s")
            step_s[model].append(fit.opt.seconds / max(fit.opt.num_steps, 1))
            req_s[model].append(secs)
            add("train", train)
            add("q(u)", qu)
            add("request", req)

        return observe

    gpar.compute_q_u = counted_q_u
    try:
        out = {"IGP": example.run_igp(ds, device=_DEV, max_opt_steps=EEG_STEPS, dtype=f32,
                                      filter_impl="pallas", observe=observer("IGP"))}
        for backend in ("exact", "scaled"):
            out[backend] = example.run(backend, ds, device=_DEV, max_opt_steps=EEG_STEPS,
                                       dtype=dtype, observe=observer(backend))
    finally:
        gpar.compute_q_u = compute_q_u
    preds = {m: {ch: v[0] for ch, v in out[m].items()} for m in out}
    return preds, step_s, req_s, totals, ends


def _smse(pred, truth):
    import numpy as np

    pred = pred.double().cpu().numpy()
    return float(np.mean((pred - truth) ** 2) / np.var(truth))


def eeg_grad_check(ds, failures):
    """At the example's start, each conditional's objective and gradient
    (exact and scaled) through the kernels (float32, "on") against float64
    ``torch.linalg`` ("off"), each component on its own."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS
    from gpar_at_scale_torch.gp import exact as exact_gp
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.models.gpar import GPARConfig, _conditional_bound, _exact_kernel
    from gpar_at_scale_torch.utils.params import pack_gpar

    n = TRAIN_POINTS
    obs = [ds.channels.index(c) for c in EEG_OBSERVED]
    for ci, ch in enumerate(EEG_PREDICTED):
        cols = obs + [ds.channels.index(c) for c in EEG_PREDICTED[:ci]]
        for backend in ("exact", "scaled"):
            out = {}
            for mode, dtype in (("on", torch.float32), ("off", torch.float64)):
                _set_dense_mode(mode)
                dev = lambda a: torch.as_tensor(np.asarray(a)).to(_DEV, dtype)  # noqa: E731
                t, X, y = dev(ds.t[:n]), dev(ds.Y[:n, cols]), dev(ds.Y[:n, ds.channels.index(ch)])
                cfg = GPARConfig(backend=backend, num_pseudo_points=n, dtype=dtype)
                p = _tensor_params(EEG_COND_START, pack_gpar, _DEV, dtype).requires_grad_(True)
                if backend == "scaled":
                    value = -_conditional_bound(cfg, t, X, y, X)(dtc_objective, p)
                else:
                    F = torch.cat([t[:, None], X], dim=1)
                    k, nv = _exact_kernel(cfg, F.shape[1], p)
                    value = exact_gp.nlml(k, F, y, nv)
                value.backward()
                out[mode] = (float(value.detach()), p.grad.double().cpu().numpy())
            (v_k, g_k), (v_r, g_r) = out["on"], out["off"]
            over = float((np.abs(g_k - g_r) / (EEG_GRAD_ATOL + EEG_GRAD_RTOL * np.abs(g_r))).max())
            v_ok = abs(v_k - v_r) <= EEG_VALUE_RTOL * abs(v_r)
            ok_ = bool(np.isfinite(g_k).all()) and over <= 1.0 and v_ok
            _log(f"[eeg] start check {backend} {ch}: nll {v_k:.5f} (kernels, float32) vs "
                 f"{v_r:.5f} (float64); gradient {np.round(g_k, 4).tolist()} vs "
                 f"{np.round(g_r, 4).tolist()}, {over:.3f} of the bound (rtol {EEG_GRAD_RTOL} "
                 f"|g| + atol {EEG_GRAD_ATOL}) {'ok' if ok_ else 'FAIL'}")
            if not ok_:
                failures.append(f"[eeg] start check of {backend} {ch} failed")
    _set_dense_mode("off")


def eeg_phase(failures):
    """The slice's main path: the EEG example under "on" (launch counts
    read around it), its start-parameter gradient check, the same fits
    under "off" with the conditionals in float64 (torch.linalg at the
    example's own precision: in float32 it fails to factor F2's scaled
    q(u) at the optimum its L-BFGS reaches on the card), and SMSE of both.
    Returns K6a-c's launches in the "on" run, {mode: {(backend,
    channel): float64 objective at the conditional's end point}} and the
    SMSE of the scaled FZ fit under "on"."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS, generate_synthetic_eeg

    ds = generate_synthetic_eeg(seed=0)
    n = TRAIN_POINTS
    results = {}
    try:
        for mode in ("on", "off"):
            for k in _dense():
                k.launches = 0
            t0 = time.perf_counter()
            results[mode] = eeg_run(ds, mode, failures, torch.float64 if mode == "off" else None)
            launches = _dense_counts()
            preds, step_s, req_s, totals, _ = results[mode]
            _log(f"[eeg] {mode}: the three models in {time.perf_counter() - t0:.1f} s; s/step "
                 + ", ".join(f"{m} {float(np.median(v)):.4f}" for m, v in step_s.items())
                 + "; s/request " + ", ".join(f"{m} {float(np.median(v)):.4f}" for m, v in req_s.items())
                 + f"; K6a/K6b/K6c launches {launches}: training {totals['train']}, q(u) "
                 f"{totals['q(u)']}, requests {totals['request']}")
            if mode == "on":
                on_launches = launches
                if not all(c > 0 for c in launches):
                    failures.append(f"[eeg] a dense kernel was not launched on the main path: {launches}")
            elif any(launches):
                failures.append(f"[eeg] dense kernels launched under 'off': {launches}")
        eeg_grad_check(ds, failures)
    finally:
        _set_dense_mode("off")
    _log("[eeg] SMSE  channel |   IGP on  off |  exact on  off |  scaled on  off")
    finite = True
    for ch in EEG_PREDICTED:
        truth = ds.Y[n:, ds.channels.index(ch)]
        row = []
        for model in EEG_EXPECT:
            for mode in ("on", "off"):
                mu = results[mode][0][model][ch]
                finite &= bool(torch.isfinite(mu).all()) and mu.shape == (truth.shape[0],)
                row.append(_smse(mu, truth))
        _log(f"[eeg] SMSE  {ch:>7} | " + " | ".join(
            f"{row[i]:.4f} {row[i + 1]:.4f}" for i in range(0, 6, 2)))
    if not finite:
        failures.append("[eeg] predictions are not finite or have the wrong shape")
    smse_fz = _smse(results["on"][0]["scaled"]["FZ"], ds.Y[n:, ds.channels.index("FZ")])
    return on_launches, {mode: results[mode][4] for mode in results}, smse_fz


# [eeg-bench] batched serving: bench.py's 200 requests in one batched
# predictive (gp/dtc.py::predict_scaled_batch) against the 200 sequential
# predicts, float32, max |batched - sequential| / max |sequential| of the
# means and of the variances.  Under "on" both run the same kernels per
# request (the batch rides K6a's grid and the shared q(u) solves' columns);
# under "off" batched and single cuSOLVER factorizations round differently,
# and the spliced covariance (train noise about 1e-3 of the signal) is
# conditioned near 1e4, so float32 rounding may reach 1e-4 there.  1e-3
# still fails a request answered with another row's parameters (O(1)).
BATCH_TOL = 1e-3


def eeg_bench(failures, reps=5, requests=200):
    """bench.py's pipeline (``gpar_at_scale_torch/benchmarks/bench.py``'s
    ``bench_pipeline``) under "on" and "off", in turns (on, off, off, on).
    Prints the median seconds per pipeline and per request (200 sequential
    requests) and one traced pipeline's device busy share per mode, with the
    device copies it ran; then per mode the port's ``bench.py`` itself
    (``measure``: its JSON line, batched serving in obs/s), the 200 batched
    requests held against the 200 sequential ones, and the K6a-c launches
    of one batched request (one K6a expected under "on")."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import bench

    n_star = 100
    pipeline, predict, predict_batch = bench.bench_pipeline(_DEV)

    def timed(fn):
        _sync(_DEV)
        t0 = time.perf_counter()
        out = fn()
        _sync(_DEV)
        return time.perf_counter() - t0, out

    pipe_s = {"on": [], "off": []}
    req_s = {"on": [], "off": []}
    last = {}
    batched = {}
    try:
        for mode in ("on", "off"):  # warm-up
            _set_dense_mode(mode)
            pipeline()
        for mode in ("on", "off", "off", "on"):
            _set_dense_mode(mode)
            for _ in range(reps // 2 + 1):
                secs, (res, qu, pred) = timed(pipeline)
                pipe_s[mode].append(secs)
            last[mode] = (res, pred)
            with torch.no_grad():
                for _ in range(requests // 2):
                    req_s[mode].append(timed(lambda: predict(res.params, qu))[0])
        for mode in ("on", "off"):
            _set_dense_mode(mode)
            before = _dense_counts()
            events = profile_phase(f"eeg-bench pipeline ({mode})", pipeline)
            _log(f"[eeg-bench] traced pipeline ({mode}): K6a/K6b/K6c launches "
                 f"{_minus(_dense_counts(), before)}; "
                 f"{sum(c for k, c, _ in events if 'copy' in k.lower())} device copies")
        for mode in ("on", "off"):
            _set_dense_mode(mode)
            out = bench.measure(_DEV, reps=reps, requests=requests, rounds=bench.ROUNDS)
            qu, P = out["qu"], out["pbatch"]
            with torch.no_grad():
                before = _dense_counts()
                got = predict_batch(P, qu)
                _sync(_DEV)
                one = _minus(_dense_counts(), before)
                seq = [predict(p, qu) for p in P]
            want_mu = torch.stack([r.mean for r in seq])
            want_var = torch.stack([r.var for r in seq])
            rel = (float((got.mean - want_mu).abs().max() / want_mu.abs().max()),
                   float((got.var - want_var).abs().max() / want_var.abs().max()))
            batched[mode] = (out, one, rel)
            ok_ = (all(math.isfinite(r) and r <= BATCH_TOL for r in rel)
                   and got.mean.shape == (requests, n_star)
                   and one == ((1, 2, 0) if mode == "on" else (0, 0, 0)))
            _log(f"[eeg-bench] bench.py ({mode}): pipeline mean "
                 f"{statistics.mean(out['pipeline_s']):.5f} s over {len(out['pipeline_s'])}, "
                 f"request median {statistics.median(out['request_s']):.6f} s, batched serving "
                 f"{out['obs_per_s']:,.0f} obs/s ({bench.ROUNDS} rounds of {requests} requests in "
                 f"{out['batched_s']:.4f} s); one batched request of {requests}: K6a/K6b/K6c "
                 f"launches {one}; batched vs {requests} sequential: mean rel {rel[0]:.2e}, var "
                 f"rel {rel[1]:.2e} (tol {BATCH_TOL:.0e}) {'ok' if ok_ else 'FAIL'}")
            _log(f"[eeg-bench] bench.py JSON ({mode}): " + json.dumps(out["json"]))
            if not ok_:
                failures.append(f"[eeg-bench] batched serving under '{mode}' disagrees with the "
                                f"sequential requests or launched {one}")
    finally:
        _set_dense_mode("off")
    (r_on, p_on), (r_off, p_off) = last["on"], last["off"]
    d_mu = float((p_on.mean - p_off.mean).abs().max())
    finite = all(bool(torch.isfinite(x).all()) for x in (p_on.mean, p_on.var, r_on.params))
    for mode in ("on", "off"):
        _log(f"[eeg-bench] {mode}: pipeline median {float(np.median(pipe_s[mode])):.5f} s over "
             f"{len(pipe_s[mode])} (min {min(pipe_s[mode]):.5f}, max {max(pipe_s[mode]):.5f}); "
             f"request median {float(np.median(req_s[mode])):.6f} s over {len(req_s[mode])} "
             f"(min {min(req_s[mode]):.6f}); final nlml {float(last[mode][0].value):.4f}")
    _log(f"[eeg-bench] on vs off: max |mean difference| {d_mu:.3e}; finite {finite}")
    if not (finite and p_on.mean.shape == (n_star,)):
        failures.append("[eeg-bench] the pipeline's predictions are not finite or of the wrong shape")
    return batched


# ---------------------------------------------------------------------------
# The repo's drivers on the port: gpar_at_scale_torch/examples/ and benchmarks/
# ---------------------------------------------------------------------------

# [scripts] dtc_example part (a) in float32 on the kernels (filter_fn="pallas":
# K1/K2 gain pass, K3 columns) against the float64 dense value: the script's
# own bound, |dtc - dense| < 1e-5 |dense|.  At N = 30 the float32 whitening
# and the float64 Gram after it carry a few float32 roundings of an O(10)
# bound; the kernels' plain versions missed by 9.3e-7 relative on a CPU.
DTC_F32_RTOL = 1e-5
# The float64 scripts at N <= 2048 (dtc_example part (b), toy_example,
# scaled_examples small, plot_examples' exact GP) on the card against the same
# function on the CPU in this process: SMSE and hyperparameters within 1e-2
# relative.  Both run float64 torch.linalg, but cuBLAS/cuSOLVER and the CPU's
# libraries round differently and L-BFGS follows its rounding for up to 150
# steps, so the end points agree only to the optimizer's tolerance; a device
# fault (a wrong path, a mixed-up input) moves them by O(1).
SCRIPT_CPU_RTOL = 1e-2
# chain_scale's latent band: the share of test points within 2 sd of the
# predictive latent variance, near 0.95 (0.92 and 0.96 on a CPU at N = 5e4
# after 2 Adam steps); a variance off by a factor 2 gives 0.84 or 0.995.
CHAIN_COV_BAND = (0.87, 0.99)
# [scripts], this slice's drivers at N = 1e6, M = 32 (benchmarks/ of the JAX
# package; their flags and defaults in each port module's docstring), cut:
#   million_dtc  -- rows (a), (b) at 3 Adam steps (the script's 20) and (c);
#                   --check at the largest N <= 1e6 where the float64 engine
#                   fits, with the script's bounds (bound rel < 1e-5, gradient
#                   rel < 1e-4 of its largest component); (c) on the kernels
#                   held to gp/dtc.py's predict_scaled in float64 on the same
#                   q(u): means within DTC_PRED_SD predictive sd, sd within
#                   DTC_PRED_SD of itself ([segmented]'s smoother bound;
#                   measured 7e-5 and 1.3e-5 on a CPU at N = 2e4);
#   million_grad --pallas at 5 Adam steps (the script's 30): nll/N falls;
#   long_series  -- every row at N = 1e6 (segments of LONG_SEGMENT, 3 timed
#                   calls each) and the seq row with the blocked filter at
#                   LONG_SEQ_N (the port's sequential filter is a loop of N
#                   steps): every filter's ll within ASSOC_LL_RTOL of the
#                   kernel filter's ([assoc]'s bound: float32 recursions in
#                   other orders), every smoother's means and sd within
#                   SEG_SMOOTH_SD of the kernel smoother's in its sd, the draws
#                   of ffbs and segsample standardized by those moments with
#                   |mean| <= LONG_Z_MEAN and |mean square - 1| <= LONG_Z_MS
#                   (4 x 1e6 values correlated over about 200 steps: a
#                   standard error of about 0.01; a draw of the wrong variance
#                   by 20% fails);
#   pod_scale    -- phase A at 64 chains, 3 outputs (the script's 16), 5 + 5
#                   draws (200 + 150), one rank (NCCL); phase B is [dist] seq;
#   scaling      -- 8 chains per rank at 5 + 5 draws, D = 1 (NCCL) and
#                   D = 2 (gloo, sharing the card); --weak at its 65536 steps
#                   per rank, each D's ll against the unsharded kernel filter's
#                   at the same N, [dist]'s bound (FULL_TRACE_ATOL on ll / N).
# million_smc --host is [smc] and nuts_vs_smc is [nuts-smc]: each runs once,
# there, through its module.
DTC_STEPS, DTC_PRED_SD = 3, 1e-2
GRAD_STEPS = 5
LONG_SEGMENT, LONG_SEQ_N, LONG_REPS, LONG_Z_MEAN, LONG_Z_MS = 250_000, 5_000, 3, 0.05, 0.1
POD_OUTPUTS, POD_CHAINS, POD_DRAWS = 3, 64, 5
SCALING_CHAINS, SCALING_DRAWS, SCALING_RANKS, SCALING_WEAK_N = 8, 5, 2, 65536


def _rel(got, want):
    """max |got - want| / max |want|."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _quietly(fn, *args, **kwargs):
    """fn's result, its printed lines kept out of the run's output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _check(tag, ok_, text, failures):
    _log(f"[scripts] {tag}: {text} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append(f"[scripts] {tag}: {text}")


def million_dtc_script(counted, failures):
    """million_dtc rows (a), (b), (c) at N = 1e6, M = 32, then ``--check``
    and (c) against the float64 predictive on the same q(u)."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import million_dtc
    from gpar_at_scale_torch.ops import K1, K2, K3, K4A, K4B

    out = counted("million_dtc (a) (b) (c)", lambda: million_dtc.run(
        N, M, DTC_STEPS, N_STAR, device=_DEV), want=(K1, K2, K3, K4A, K4B))
    nll = out["nll"]
    _check("million_dtc (b)", bool(np.isfinite(nll).all() and nll[-1] < nll[0]
                                   and np.isfinite(out["G"]).all()),
           f"nll/N {np.round(nll, 6).tolist()} falls, the Gram finite", failures)
    prob = million_dtc.problem(N, M, N_STAR, _DEV)
    p0 = million_dtc.start(_DEV)
    mean_r, var_r = million_dtc.predict_reference(prob, p0, out["qu"])
    sd = torch.sqrt(var_r)
    mu, var = (torch.as_tensor(x, device=sd.device) for x in (out["mean"], out["var"]))
    d_mean = float(((mu - mean_r) / sd).abs().max())
    d_sd = float(((torch.sqrt(var) - sd) / sd).abs().max())
    _check("million_dtc (c)", d_mean <= DTC_PRED_SD and d_sd <= DTC_PRED_SD
           and out["rmse"] < prob.sn,
           f"kernels vs float64 predict_scaled on the same q(u): means {d_mean:.2e} sd, sd "
           f"{d_sd:.2e} (<= {DTC_PRED_SD}); rmse vs latent {out['rmse']:.4f} (< noise {prob.sn})",
           failures)
    del prob, mean_r, var_r, sd
    n = N
    while True:
        try:
            _reset_peak()
            dv, dg, rg, _, _ = counted(f"million_dtc --check N={n:,}", lambda: million_dtc.check(
                million_dtc.problem(n, M, 0, _DEV)), want=(K1, K2, K3, K4A, K4B))
            break
        except torch.cuda.OutOfMemoryError:
            _log(f"[scripts] million_dtc --check: the float64 engine at N={n:,} ran out of memory")
            n //= 2
    _check(f"million_dtc --check N={n:,}", dv < million_dtc.CHECK_VALUE_RTOL
           and rg < million_dtc.CHECK_GRAD_RTOL,
           f"staged float32 kernels vs float64 blocked engine: bound rel {dv:.2e} "
           f"(< {million_dtc.CHECK_VALUE_RTOL}), gradient max abs {dg:.3e}, rel {rg:.2e} "
           f"(< {million_dtc.CHECK_GRAD_RTOL}); peak device memory {_peak():.2f} GiB", failures)


def million_grad_script(counted, failures):
    """million_grad --pallas at N = 1e6, GRAD_STEPS Adam steps."""
    import numpy as np

    from gpar_at_scale_torch.benchmarks import million_grad
    from gpar_at_scale_torch.ops import K1, K2, K4A, K4B

    out = counted("million_grad --pallas", lambda: million_grad.run(
        N, GRAD_STEPS, "pallas", device=_DEV), want=(K1, K2, K4A, K4B))
    nll = out["nll"]
    _check("million_grad --pallas", bool(np.isfinite(nll).all() and nll[-1] < nll[0]),
           f"nll/N {np.round(nll, 6).tolist()} falls; {out['step_ms']:.2f} ms/step", failures)


def long_series_script(counted, failures):
    """long_series' rows at N = 1e6 and seq at LONG_SEQ_N, held to each
    other."""
    import torch

    from gpar_at_scale_torch.benchmarks import long_series
    from gpar_at_scale_torch.ops import K1, K2, K4A, K4B

    rows = [r for r in long_series.ROWS if r != "seq"]
    out = counted("long_series --pallas and its rows", lambda: long_series.run(
        N, rows, device=_DEV, reps=LONG_REPS, segment=LONG_SEGMENT), want=(K1, K2, K4A, K4B))
    ll_k = float(out["pallas filter"]["out"][0])
    lls = {r: float(out[r]["out"][0]) for r in ("filter", "segfilter", "assoc")}
    gaps = {r: abs(v - ll_k) / abs(ll_k) for r, v in lls.items()}
    _check("long_series filters", all(g <= ASSOC_LL_RTOL for g in gaps.values()),
           "ll vs the kernel filter's " + ", ".join(f"{r} {g:.2e}" for r, g in gaps.items())
           + f" (rel <= {ASSOC_LL_RTOL})", failures)
    m_k, v_k = (x.double() for x in out["pallas smooth"]["out"])
    sd = torch.sqrt(v_k)
    sm = {}
    for r in ("smooth", "smooth-split", "segsmooth"):
        m, v = (x.double() for x in out[r]["out"])
        sm[r] = (float(((m - m_k) / sd).abs().max()), float(((torch.sqrt(v) - sd) / sd).abs().max()))
    _check("long_series smoothers", all(max(g) <= SEG_SMOOTH_SD for g in sm.values()),
           "vs the kernel smoother, max |mean - .| / sd, max |sd - .| / sd: "
           + ", ".join(f"{r} {a:.2e}, {b:.2e}" for r, (a, b) in sm.items())
           + f" (<= {SEG_SMOOTH_SD})", failures)
    zs = {}
    for r in ("ffbs", "segsample"):
        z = ((out[r]["out"][0].double() - m_k[None]) / sd[None])
        zs[r] = (float(z.mean()), float((z * z).mean()))
    _check("long_series draws", all(abs(a) <= LONG_Z_MEAN and abs(b - 1) <= LONG_Z_MS
                                   for a, b in zs.values()),
           "standardized by the kernel smoother's moments, mean and mean square: "
           + ", ".join(f"{r} {a:.4f}, {b:.4f}" for r, (a, b) in zs.items())
           + f" (|mean| <= {LONG_Z_MEAN}, |ms - 1| <= {LONG_Z_MS})", failures)
    del out, m_k, v_k, sd
    seq = counted(f"long_series seq at N={LONG_SEQ_N:,}", lambda: long_series.run(
        LONG_SEQ_N, ("filter", "seq"), device=_DEV, reps=1))
    g = abs(float(seq["seq"]["out"][0]) - float(seq["filter"]["out"][0])) / LONG_SEQ_N
    _check("long_series seq", g <= FULL_TRACE_ATOL,
           f"the sequential filter's ll vs the blocked filter's at N={LONG_SEQ_N:,}: {g:.2e} per "
           f"step (<= {FULL_TRACE_ATOL})", failures)


def pod_scale_script(counted, failures):
    """pod_scale phase A at POD_CHAINS chains, one rank."""
    import numpy as np

    from gpar_at_scale_torch.benchmarks import pod_scale

    res = counted("pod_scale phase A", lambda: pod_scale.run(
        device=_DEV, ranks=1, outputs=POD_OUTPUTS, chains=POD_CHAINS, samples=POD_DRAWS,
        warmup=POD_DRAWS, phases="A"), none=True)
    means = res[0]["chain_means"]
    _check("pod_scale phase A", bool(np.isfinite(means).all()) and len(means) == POD_OUTPUTS - 1,
           f"{POD_CHAINS} chains x {POD_OUTPUTS - 1} conditionals, {res[0]['chain_sps']:.1f} "
           f"samples/s, draws' means {np.round(means, 4).tolist()} finite", failures)


def scaling_script(counted, failures):
    """scaling and scaling --weak at D = 1 and D = 2."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import scaling
    from gpar_at_scale_torch.ops import K1, K2
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked

    summed = lambda rows: {k: sum(r[-1][k] for r in rows) for k in rows[0][-1]}  # noqa: E731
    strong = counted("scaling", lambda: scaling.strong(
        device=_DEV, ranks=SCALING_RANKS, chains_per_device=SCALING_CHAINS, samples=SCALING_DRAWS,
        warmup=SCALING_DRAWS), none=True, ranks=lambda rows: summed(rows[1:]))
    _check("scaling", all(np.isfinite(r[3]).all() for r in strong),
           "samples/s " + ", ".join(f"D={r[0]} {r[1]:.1f}" for r in strong)
           + " (the ranks share one card and host: no scaling claim); draws finite", failures)
    weak = counted("scaling --weak", lambda: scaling.weak(device=_DEV, ranks=SCALING_RANKS,
                                                          n_per_device=SCALING_WEAK_N),
                   want=(K1, K2), ranks=lambda rows: summed(rows[1:]))
    gaps = []
    for D, n, _, lls, _ in weak:
        _, y, lg = scaling.weak_series(n, _DEV)
        with torch.no_grad():
            ref = float(decorrelate_blocked(lg, y)[0])
        gaps.append(max(abs(v - ref) for v in lls) / n)
    _check("scaling --weak", all(g <= FULL_TRACE_ATOL for g in gaps),
           "ll of every rank vs the unsharded kernel filter's at the same N, per step: "
           + ", ".join(f"D={r[0]} {g:.2e}" for r, g in zip(weak, gaps))
           + f" (<= {FULL_TRACE_ATOL})", failures)


def scripts_phase(failures):
    """[scripts] The repo's drivers on the port, each through its module's
    functions: ``dtc_example`` part (a) in float64 (the script's assertion)
    and in float32 on K1/K2/K3 (``filter_fn="pallas"``), part (b);
    ``toy_example``; ``scaled_examples`` on the small set and with
    ``--big`` (K1-K4b); ``plot_examples`` (the temporal GP on K1/K2 and
    K4a/K4b); ``chain_scale --outputs=2 --steps=2`` at N = 1e6 (K1-K4b);
    ``mfu``'s rows; then ``million_dtc``, ``million_grad --pallas``,
    ``long_series``, ``pod_scale`` phase A and ``scaling`` (``--weak`` too)
    at N = 1e6, M = 32, cut as the constants above say.  The float64
    scripts at N <= 2048 are held against the same function on the CPU.
    Returns the launches of every kernel in the phase."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import chain_scale, mfu
    from gpar_at_scale_torch.data.toy import generate_big_dataset, generate_small_dataset
    from gpar_at_scale_torch.examples import dtc_example, plot_examples, scaled_examples
    from gpar_at_scale_torch.examples import toy_example
    from gpar_at_scale_torch.ops import K1, K2, K3, K4A, K4B

    dev, cpu = torch.device(_DEV), torch.device("cpu")
    total = {k: 0 for k in _all_counts()}
    t_phase = time.perf_counter()

    def counted(tag, fn, want=(), none=False, ranks=None):
        """fn() with the kernels' launches read around it, plus those
        ``ranks(out)`` reports from spawned ranks; every kernel in ``want``
        must launch, none at all with ``none``."""
        before = _all_counts()
        t0 = time.perf_counter()
        out = fn()
        _sync(_DEV)
        secs = time.perf_counter() - t0
        got = {k: c - before[k] for k, c in _all_counts().items()}
        for k, c in (ranks(out) if ranks else {}).items():
            got[k] += c
        for k in got:
            total[k] += got[k]
        ok_ = all(got[k.name] > 0 for k in want) and not (none and any(got.values()))
        _log(f"[scripts] {tag}: {secs:.2f} s; launches "
             + ", ".join(f"{k.split()[0]} {v}" for k, v in got.items() if v)
             + ("" if any(got.values()) else "none") + ("" if ok_ else " FAIL"))
        if not ok_:
            failures.append(f"[scripts] {tag}: kernel launches {got} (expected "
                            f"{'none' if none else [k.name for k in want]})")
        return out

    def hold(tag, got, want):
        rel = _rel(got, want)
        ok_ = math.isfinite(rel) and rel <= SCRIPT_CPU_RTOL
        _log(f"[scripts] {tag} on the card vs the CPU: max rel {rel:.3e} "
             f"(tol {SCRIPT_CPU_RTOL:.0e}) {'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"[scripts] {tag}: the card and the CPU disagree (rel {rel:.3e})")

    # dtc_example: (a) as the script asserts it, float64, sequential whitening
    try:
        k64, dense, diff = counted("dtc_example (a) float64", lambda: _quietly(
            dtc_example.compare_dtc_with_dense, device=dev), none=True)
        _log(f"[scripts] dtc_example (a): Kalman-whitened {k64:.6f}, dense {dense:.6f}, "
             f"difference {diff:.2e} (< 1e-5 |dense| asserted) ok")
    except AssertionError as exc:
        failures.append(f"[scripts] dtc_example (a) failed its assertion: {exc}")
        dense = dtc_example.dense_dtc()
    k32 = counted("dtc_example (a) float32 on the kernels", lambda: dtc_example.kalman_dtc(
        device=dev, dtype=torch.float32, filter_fn="pallas"), want=(K1, K2, K3))
    ok_ = abs(k32 - dense) < DTC_F32_RTOL * abs(dense)
    _log(f"[scripts] dtc_example (a) float32 (K1/K2/K3): {k32:.6f} vs float64 dense {dense:.6f}, "
         f"rel {abs(k32 - dense) / abs(dense):.2e} (tol {DTC_F32_RTOL:.0e}) "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[scripts] dtc_example's float32 kernel route disagrees with the dense bound")
    fits = counted("dtc_example (b)", lambda: dtc_example.compare_optimum_params(device=dev),
                   none=True)
    fits_cpu = _quietly(dtc_example.compare_optimum_params, device=cpu)
    hold("dtc_example (b) hyperparameters", [f.hyperparams() for f in fits],
         [f.hyperparams() for f in fits_cpu])

    # toy_example (float64, dense torch.linalg: no kernel of ours)
    toy = counted("toy_example", lambda: toy_example.run(device=dev), none=True)
    toy_example.report(toy)
    hold("toy_example SMSE", toy["smse"], toy_example.run(device=cpu)["smse"])

    # scaled_examples: small (dense, float64), then --big (the kernels)
    small = counted("scaled_examples small", lambda: scaled_examples.run(
        generate_small_dataset(seed=0), 10, scaled_examples.OPT_STEPS, "small", 3, device=dev,
        plot=False), none=True)
    small_cpu = _quietly(scaled_examples.run, generate_small_dataset(seed=0), 10,
                         scaled_examples.OPT_STEPS, "small", 3, device=cpu, plot=False)
    hold("scaled_examples small SMSE", small["smse"], small_cpu["smse"])
    big = counted("scaled_examples --big", lambda: scaled_examples.run(
        generate_big_dataset(seed=0), 50, scaled_examples.OPT_STEPS, "big", 100, device=dev,
        plot=False), want=(K1, K2, K3, K4A, K4B))

    # plot_examples: the exact GP (float64) and the temporal GP (K1/K2, K4a/K4b)
    exact = counted("plot_examples exact", lambda: plot_examples.exact_example(device=dev),
                    none=True)
    exact_cpu = _quietly(plot_examples.exact_example, device=cpu)
    hold("plot_examples exact mean", exact[2], exact_cpu[2])
    temporal = counted("plot_examples temporal", lambda: plot_examples.temporal_example(device=dev),
                       want=(K1, K2, K4A, K4B))
    finite = all(bool(np.isfinite(x).all()) for x in (
        toy["smse"], small["smse"], big["smse"], big["means"], exact[2], temporal[2], temporal[3]))

    # chain_scale at N = 1e6, two outputs, two Adam steps: the mechanism
    chain = counted("chain_scale --outputs=2 --steps=2", lambda: chain_scale.run(
        N, P=2, M=M, steps=2, n_star=N_STAR, device=dev), want=(K1, K2, K3, K4A, K4B))
    lo, hi = CHAIN_COV_BAND
    cov_ok = all(lo <= c <= hi for c in chain["cov2f"])
    finite &= all(bool(torch.isfinite(m).all()) for m in chain["means"])
    _log(f"[scripts] chain_scale: latent-band coverage {chain['cov2f']} in [{lo}, {hi}] "
         f"{'ok' if cov_ok else 'FAIL'}; cov2s {chain['cov2s']} (cannot fail)")
    if not cov_ok:
        failures.append(f"[scripts] chain_scale's latent-band coverage {chain['cov2f']} is not "
                        f"near 0.95")

    # mfu: the compute-bound stages at the card's sizes
    rows = counted("mfu", lambda: mfu.run(dev, reps=50), none=True)
    finite &= all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    if not finite:
        failures.append("[scripts] a script gave non-finite numbers")

    # this slice's drivers at N = 1e6, M = 32
    million_dtc_script(counted, failures)
    million_grad_script(counted, failures)
    long_series_script(counted, failures)
    pod_scale_script(counted, failures)
    scaling_script(counted, failures)
    _log(f"[scripts] the phase in {time.perf_counter() - t_phase:.1f} s; finite {finite}")
    return total, rows


# ---------------------------------------------------------------------------
# The associative-scan engine, the Monte-Carlo predictive, the reference-named
# api and the parallel fit of the conditionals
# ---------------------------------------------------------------------------

# [assoc] The associative-scan filter and smoother (tensor code) against K1/K2
# and K4a/K4b on the chain's series, float32, as max |assoc - kernels| /
# max |kernels| per output (ll relative): the two combine the same steps in
# another order (log2 N doubling levels against 62-step blocks).
ASSOC_TOL, ASSOC_LL_RTOL = 1e-3, 1e-5
# Adam steps under filter_impl="associative".  Autograd through the doubling
# levels keeps every level's elements (memory grows as N log2 N); at the
# chain's N = 1e6 the sum-kernel gradient peaked at 51.95 GiB and the Adam
# steps at 40.34 GiB on an H100 80GB (tools/assoc_memory.py), so nothing is cut.
ASSOC_STEPS = 3
# [assoc] The associative Adam run's first value (the objective at the seeded
# start) against the kernel path's at the same parameters, nll/N.
ASSOC_VALUE_ATOL = 1e-5
# [mc] The reference's sample count, and the bounds on the Monte-Carlo
# predictive against the analytic one: its mean within MC_Z standard errors
# sqrt(rowsum(H^2) / S) of the analytic mean, and the f_x part of its
# variance within MC_Z * sqrt(2 / (S - 1)) relative of rowsum(H^2).  Beside
# them, the request's draws whitened, xi = L_D^T (eps - m_eps), whose M * S
# entries must read as standard normal: mean within MC_Z / sqrt(M S) of 0,
# mean square within MC_Z * sqrt(2 / (M S)) of 1.  And the body fed 2M
# sigma points eps = m_eps +- sqrt(M) L_D^-T e_j, whose sample mean and
# (biased) covariance are q(eps)'s exactly: its mean and f_x variance must
# equal the analytic ones, to MC_BODY_RTOL of max rowsum(H^2) for the
# variance and of its square root for the mean (float32 smoothing of other
# columns; a body that halved the variance would read 0.5).
MC_SAMPLES, MC_Z, MC_BODY_RTOL = 100, 6.0, 0.05
# [api] get_gpar_scaled_predictions on the reference's big toy dataset: 50
# pseudo-inputs, 50 L-BFGS steps, the test grid of examples/scaled_examples.py
# (every 100th point of the true curve).
API_M, API_STEPS, API_STRIDE = 50, 50, 100
# [parallel] The parallel fit of the chain against the sequential one from
# the same start, float32, per log-parameter (10 Adam steps of 5e-2 each):
# the port fits each conditional the same way under both settings.
PAR_ATOL = 1e-3


def sum_time_family(lengthscale, variance):
    """The time kernel of the sum-kernel conditional: Matern-5/2 plus a
    slower Matern-1/2 tied to its parameters (state dim 4, H = [1, 0, 0, 1])."""
    from gpar_at_scale_torch.kernels import Matern12, Matern52

    return (Matern52(lengthscale=lengthscale, variance=variance)
            + Matern12(lengthscale=4.0 * lengthscale, variance=0.25 * variance))


def _peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def _scaled_rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def assoc_engines(t, Y, params, failures):
    """[assoc] ``parallel_decorrelate``/``parallel_filter`` and
    ``parallel_smooth`` on the first conditional's series (one column, then
    its M + 1 columns [y | K_fu]) against the kernel path on the same
    float32 inputs: K1/K2 (``decorrelate_blocked``) and K1-K3
    (``whiten_columns``) for alpha and ll, K1/K2 + K4a/K4b
    (``pallas_smooth``, column by column) for the smoothed mean and
    variance."""
    import torch

    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ssm import pkalman

    s = scan_inputs(t, Y, params, M)
    lg, U = s["lgssm"], s["batch"]
    for cols in (1, U.shape[1]):
        Uc = U[:, :cols]
        torch.cuda.reset_peak_memory_stats()
        _sync(_DEV)
        t0 = time.perf_counter()
        res = pkalman.parallel_filter(lg, Uc)
        sm = pkalman.parallel_smooth(lg, Uc, res)
        _sync(_DEV)
        secs, peak = time.perf_counter() - t0, _peak_gib()
        alpha, ll = res.v / torch.sqrt(res.S)[:, None], res.ll
        if cols == 1:
            ll_k, alpha_k, _ = ok.decorrelate_blocked(lg, Uc[:, 0])
            ll_k, alpha_k = ll_k[None], alpha_k[:, None]
        else:
            ll_k, alpha_k, _ = ow.whiten_columns(lg, Uc)
        smooth_k = [osm.pallas_smooth(lg, Uc[:, c]) for c in range(cols)]
        mean_k = torch.stack([f[0] for f in smooth_k], 1)
        rel = {"alpha": _scaled_rel(alpha, alpha_k), "mean": _scaled_rel(sm.mean, mean_k),
               "var": _scaled_rel(sm.var, smooth_k[0][1])}
        ll_rel = float(((ll.double() - ll_k.double()) / ll_k.double()).abs().max())
        ok_ = all(math.isfinite(v) and v <= ASSOC_TOL for v in rel.values()) and ll_rel <= ASSOC_LL_RTOL
        _log(f"[assoc] parallel_filter + parallel_smooth, N={s['n']} d={s['d']} {cols} column(s): "
             f"{secs:.3f} s, peak device memory {peak:.2f} GiB; against the kernels: "
             + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
             + f" (tol {ASSOC_TOL:.0e}), ll rel {ll_rel:.2e} (tol {ASSOC_LL_RTOL:.0e}) "
             f"{'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"[assoc] the associative engines disagree with the kernels at {cols} column(s)")


def assoc_sum_conditional(t, Y, params, n, failures):
    """[assoc] One objective and gradient of a sum-kernel conditional
    (``sum_time_family``, d = 4) of the chain under
    ``filter_impl="pallas"`` (float32): the kernels cannot take its SDE, so
    ``gp/dtc.py`` routes it to the associative engine and no scan kernel
    may launch.  Held against the float64 tensor-code blocked engine
    (``filter_impl="blocked"``) on the same inputs."""
    import torch

    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.models.gpar import GPARConfig, _conditional_bound, _select_pseudo_points

    out = {}
    for impl, dtype in (("pallas", torch.float32), ("blocked", torch.float64)):
        cfg = GPARConfig(backend="scaled", filter_impl=impl, num_pseudo_points=M, dtype=dtype,
                         time_family=sum_time_family)
        X = Y[:n, :1].to(dtype)
        at = _conditional_bound(cfg, t[:n].to(dtype), X, Y[:n, 1].to(dtype), _select_pseudo_points(X, M))
        for k in _scan_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        _sync(_DEV)
        t0 = time.perf_counter()
        p = params[1].detach().to(dtype).requires_grad_(True)
        value = -at(dtc_objective, p)
        value.backward()
        _sync(_DEV)
        secs = time.perf_counter() - t0
        launched = {k.name: k.launches for k in _scan_kernels() if k.launches}
        out[impl] = (float(value.detach()) / n, p.grad.double().cpu().numpy(), secs, _peak_gib(),
                     launched)
    (v_k, g_k, s_k, peak, launched), (v_r, g_r, s_r, peak_r, _) = out["pallas"], out["blocked"]
    ok_, gap = _grad_gap(g_k, g_r, n)
    _log(f"[assoc] sum-kernel conditional (Matern-5/2 + Matern-1/2, d=4) N={n} M={M} under "
         f"filter_impl='pallas': nll/N {v_k:.8f} vs float64 blocked {v_r:.8f}; gradient "
         f"{[round(float(x), 3) for x in g_k]} vs {[round(float(x), 3) for x in g_r]}; {gap} "
         f"{'ok' if ok_ else 'FAIL'}; {s_k:.3f} s, peak device memory {peak:.2f} GiB (the "
         f"float64 blocked engine {s_r:.3f} s, {peak_r:.2f} GiB); scan kernels launched: "
         f"{launched or 'none'}")
    if not ok_:
        failures.append("[assoc] the sum-kernel conditional's gradient disagrees with the float64 engine")
    if launched:
        failures.append(f"[assoc] the sum-kernel conditional launched scan kernels: {launched}")


def assoc_adam(t, Y, params, n, failures):
    """[assoc] ASSOC_STEPS Adam steps of the first conditional under
    ``filter_impl="associative"`` (float32, autograd through the doubling
    levels) from the seeded start; its first value is held against the
    kernel path's objective at the same parameters."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.models.gpar import (
        GPARConfig,
        _conditional_bound,
        _select_pseudo_points,
        fit_conditional,
    )

    f32 = torch.float32
    cfg = GPARConfig(backend="scaled", filter_impl="associative", num_pseudo_points=M, dtype=f32,
                     optimizer="adam", max_opt_steps=ASSOC_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _sync(_DEV)
    t0 = time.perf_counter()
    fit = fit_conditional(None, t[:n], Y[:n, :1], Y[:n, 1], cfg, init_params=params[1],
                          device=t.device)
    _sync(_DEV)
    secs, peak = time.perf_counter() - t0, _peak_gib()
    X = Y[:n, :1]
    kcfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M, dtype=f32)
    with torch.no_grad():
        v_k = -float(_conditional_bound(kcfg, t[:n], X, Y[:n, 1], _select_pseudo_points(X, M))(
            dtc_objective, params[1].to(f32))) / n
    trace = (fit.opt.trace.double() / n).cpu().numpy()
    gap = abs(float(trace[0]) - v_k)
    ok_ = bool(np.isfinite(trace).all() and torch.isfinite(fit.params).all()) and gap <= ASSOC_VALUE_ATOL
    _log(f"[assoc] {ASSOC_STEPS} Adam steps under filter_impl='associative', N={n} M={M}: nll/N "
         f"{[round(float(x), 8) for x in trace]}; start vs the kernel path {v_k:.8f}, |diff| "
         f"{gap:.2e} (atol {ASSOC_VALUE_ATOL:.0e}) {'ok' if ok_ else 'FAIL'}; {secs:.3f} s "
         f"(training and q(u); {fit.opt.seconds / fit.opt.num_steps:.3f} s/step), peak device "
         f"memory {peak:.2f} GiB")
    if not ok_:
        failures.append("[assoc] the associative Adam run failed its check")


def assoc_phase(t, Y, params, failures):
    """[assoc]: the engines against the kernels, the sum-kernel conditional,
    the associative Adam steps, all at the chain's N."""
    assoc_engines(t, Y, params, failures)
    assoc_sum_conditional(t, Y, params, t.shape[0], failures)
    assoc_adam(t, Y, params, t.shape[0], failures)


def mc_check(model, t_star, mu, seed, failures):
    """[mc] The Monte-Carlo predictive (``predict_scaled(num_samples=100,
    generator=...)``) of the served chain's last conditional, at the
    request's inputs (the predicted means of the outputs before it), against
    its analytic predictive.  The f_x part of each variance is read off
    against the variance at eps = m_eps (the smoother's own), which both
    share.  Then the request's draws, whitened, and the body at sigma points
    (MC_BODY_RTOL above)."""
    import torch

    from gpar_at_scale_torch.gp.dtc import _predict_scaled, predict_scaled
    from gpar_at_scale_torch.utils.psd import solve_upper

    c = model.conditionals[-1]
    time_k, out_k, nv = c._kernels()
    args = (out_k, time_k, c.qu, c.X_prev, c.t, c.y, t_star, mu[:, :-1].contiguous(), nv)
    dtype = c.cfg.dtype

    def request(**kw):
        torch.cuda.reset_peak_memory_stats()
        _sync(_DEV)
        t0 = time.perf_counter()
        pred = predict_scaled(*args, dtype=dtype, **kw)
        _sync(_DEV)
        return pred, time.perf_counter() - t0, _peak_gib()

    an, s_an, m_an = request()
    mc, s_mc, m_mc = request(num_samples=MC_SAMPLES,
                             generator=torch.Generator(device=_DEV).manual_seed(seed))
    base = _predict_scaled(*args, eps=c.qu.m_eps[:, None], dtype=dtype)
    fx_an = (an.var.double() - base.var.double())
    fx_mc = (mc.var.double() - base.var.double())
    z = float(((mc.mean.double() - an.mean.double()).abs() / torch.sqrt(fx_an / MC_SAMPLES)).max())
    rel = float(((fx_mc - fx_an).abs() / fx_an).max())
    rel_tol = MC_Z * math.sqrt(2.0 / (MC_SAMPLES - 1))
    finite = bool(torch.isfinite(mc.mean).all() and torch.isfinite(mc.var).all())
    ok_ = finite and mc.mean.shape == an.mean.shape and z <= MC_Z and rel <= rel_tol
    _log(f"[mc] last conditional, N={c.t.shape[0]} N*={t_star.shape[0]} M={M} S={MC_SAMPLES} "
         f"({dtype}): request {s_mc:.3f} s, peak {m_mc:.2f} GiB (the analytic request {s_an:.3f} s, "
         f"{m_an:.2f} GiB); max |mean - analytic| / sqrt(rowsum(H^2)/S) {z:.3f} (max {MC_Z}); "
         f"f_x variance {float(fx_mc.mean()):.4e} vs {float(fx_an.mean()):.4e} on average, max rel "
         f"{rel:.3f} (max {rel_tol:.3f}); finite {finite} {'ok' if ok_ else 'FAIL'}")
    # the request's draws (the same generator state), whitened
    eps = c.qu.sample_eps(torch.Generator(device=_DEV).manual_seed(seed), MC_SAMPLES)
    xi = (c.qu.L_D.T @ (eps - c.qu.m_eps[:, None])).double()
    k = xi.numel()
    xi_mean, xi_sq = float(xi.mean()), float((xi * xi).mean())
    draws_ok = (abs(xi_mean) <= MC_Z / math.sqrt(k)
                and abs(xi_sq - 1.0) <= MC_Z * math.sqrt(2.0 / k))
    # the body at sigma points: sample mean m_eps, biased covariance D^-1
    m = c.qu.m_eps.shape[0]
    eye = torch.eye(m, dtype=c.qu.L_D.dtype, device=c.qu.L_D.device)
    sig = c.qu.m_eps[:, None] + math.sqrt(m) * solve_upper(c.qu.L_D, torch.cat([eye, -eye], 1))
    body = _predict_scaled(*args, eps=sig, dtype=dtype)
    fx_max = float(fx_an.max())
    body_var = float((body.var.double() - an.var.double()).abs().max()) / fx_max
    body_mean = float((body.mean.double() - an.mean.double()).abs().max()) / math.sqrt(fx_max)
    body_ok = body_var <= MC_BODY_RTOL and body_mean <= MC_BODY_RTOL
    _log(f"[mc] the request's {m} x {MC_SAMPLES} draws whitened: mean {xi_mean:.4f} (|.| max "
         f"{MC_Z / math.sqrt(k):.4f}), mean square {xi_sq:.4f} (1 +- {MC_Z * math.sqrt(2.0 / k):.4f}); "
         f"the body at {2 * m} sigma points against the analytic predictive: max |var diff| / max "
         f"rowsum(H^2) {body_var:.2e}, max |mean diff| / sqrt(max rowsum(H^2)) {body_mean:.2e} (max "
         f"{MC_BODY_RTOL} each) {'ok' if draws_ok and body_ok else 'FAIL'}")
    if not (ok_ and draws_ok and body_ok):
        failures.append("[mc] the Monte-Carlo predictive disagrees with the analytic one")


def api_phase(seed, failures):
    """[api] The reference-named pipeline on ``generate_big_dataset(seed=0)``
    (8496 observed times, 5 gaps): ``get_sde_predictions`` for its first
    output, then ``get_gpar_scaled_predictions`` for its second given the
    first's predicted means (50 pseudo-inputs, 50 L-BFGS steps, 100
    samples), SMSE against the true curves within the data's range.  Above
    DENSE_N_MAX both whiten on the float32 kernels; the scaled end point's
    objective is printed by the float64 blocked engine beside them."""
    import numpy as np
    import torch

    from gpar_at_scale_torch import api
    from gpar_at_scale_torch.data.toy import generate_big_dataset
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

    ds = generate_big_dataset(seed=0)
    x, y1, y2 = ds.x, ds.y_obs[:, 0], ds.y_obs[:, 1]
    n = x.shape[0]
    grid, truth = ds.x_true[::API_STRIDE], ds.y_true[::API_STRIDE]
    inside = grid <= x.max()
    f64 = torch.float64
    start_gp = pack_gp(*(torch.tensor(v, dtype=f64) for v in (0.3, 1.0, 0.1)))
    start = pack_gpar(*(torch.tensor(v, dtype=f64) for v in (0.5, 1.0, 1.0, 1.0, 0.1)))
    for k in _scan_kernels():
        k.launches = 0
    _sync(_DEV)
    t0 = time.perf_counter()
    mu1, var1 = api.get_sde_predictions(None, x, y1, grid, init_log_params=start_gp,
                                        max_opt_steps=API_STEPS, device=_DEV)
    _sync(_DEV)
    s_sde = time.perf_counter() - t0
    V = y1[:, None]
    Z = V[np.linspace(0, n - 1, API_M).astype(np.int64)]
    ends = []
    optim = api.get_optim_scaled_gpar_params

    def kept(*a, **kw):  # the end point, read around the pipeline's own call
        ends.append(optim(*a, **kw))
        return ends[-1]

    api.get_optim_scaled_gpar_params = kept
    try:
        t0 = time.perf_counter()
        mu2, sd2 = api.get_gpar_scaled_predictions(
            torch.Generator(device=_DEV).manual_seed(seed), V, Z, x, y2, grid, mu1[:, None],
            init_log_params=start, max_opt_steps=API_STEPS, num_samples=MC_SAMPLES, device=_DEV)
        _sync(_DEV)
        s_scaled = time.perf_counter() - t0
    finally:
        api.get_optim_scaled_gpar_params = optim
    launches = {k.name: k.launches for k in _scan_kernels()}
    smse = [float(np.mean((m.double().cpu().numpy()[inside] - truth[inside, i]) ** 2)
                  / np.var(truth[inside, i])) for i, m in enumerate((mu1, mu2))]
    finite = all(bool(torch.isfinite(a).all()) for a in (mu1, var1, mu2, sd2))
    t_s, V_s, y_s, Z_s = api._scaled_data(V, Z, x, y2, _DEV)
    values = {}
    for name, fn in (("kernels", None), ("float64 blocked", "blocked")):
        time_k, out_k, lgssm, nv = api._scaled_model(torch.tensor(ends[0], dtype=f64, device=_DEV),
                                                     t_s, Matern52, Matern52)
        with torch.no_grad():
            values[name] = float(dtc_objective(out_k, lgssm, V_s, Z_s, y_s, uu_ridge=nv, filter_fn=fn,
                                               time_kernel=time_k, t=t_s))
    ok_ = finite and mu2.shape == (grid.shape[0],) and all(v > 0 for v in launches.values())
    _log(f"[api] get_sde_predictions y1 N={n}: {s_sde:.3f} s, SMSE {smse[0]:.4f}; "
         f"get_gpar_scaled_predictions y2 | y1 (M={API_M}, {API_STEPS} L-BFGS steps, "
         f"{MC_SAMPLES} samples): {s_scaled:.3f} s, SMSE {smse[1]:.4f} on {int(inside.sum())} "
         f"test times in the data's range; finite {finite}; end point "
         f"{[round(v, 6) for v in ends[0]]}, DTC bound there: kernels {values['kernels']:.6f}, "
         f"float64 blocked {values['float64 blocked']:.6f}; scan kernel launches {launches} "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[api] the reference-named pipeline failed its check")
    return launches


def parallel_chain(t, Y, params, seq_model, seq_s, failures):
    """[parallel] ``fit_gpar(parallel=True)`` on the chain with the main
    path's configuration (10 Adam steps per output through the kernels),
    against the sequential fit of phase 6 from the same parameters.
    Returns the scan kernels' launches."""
    import torch

    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M,
                     dtype=torch.float32, optimizer="adam", max_opt_steps=TRAIN_STEPS)
    for k in _scan_kernels():
        k.launches = 0
    _sync(_DEV)
    t0 = time.perf_counter()
    par = fit_gpar(None, t, Y, cfg, init_params=params, parallel=True, device=t.device)
    _sync(_DEV)
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _scan_kernels()}
    gaps = [float((a.params - b.params).abs().max())
            for a, b in zip([par.first] + par.conditionals, [seq_model.first] + seq_model.conditionals)]
    widths = [c.Z.shape[1] for c in par.conditionals]
    ok_ = (max(gaps) <= PAR_ATOL and widths == list(range(1, Y.shape[1]))
           and all(v > 0 for v in launches.values()))
    _log(f"[parallel] fit_gpar(parallel=True) P={Y.shape[1]} N={t.shape[0]} M={M}, {TRAIN_STEPS} "
         f"Adam steps per output: {secs:.3f} s (the sequential fit {seq_s:.3f} s); max |log-param "
         f"parallel - sequential| per output {[f'{g:.1e}' for g in gaps]} (atol {PAR_ATOL:.0e}); "
         f"launches {launches} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[parallel] the parallel fit of the chain disagrees with the sequential one")
    return launches


def eeg_parallel(seq_ends, failures, on_ends=None):
    """[parallel] The EEG chain's conditionals fitted with
    ``fit_conditionals_parallel`` on the channels in chain order (F3-F6
    observed, then FZ, F1, F2: six conditionals) under "on" (float32, K6a-c) and "off" (float64), the example's
    starts and L-BFGS; FZ, F1 and F2 by their float64 objective at the end
    point beside the sequential fits' ([eeg]).  Returns K6a-c's launches
    under "on"; ``on_ends`` (a list) receives the float64 objective at the
    six end points under "on"."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS, generate_synthetic_eeg
    from gpar_at_scale_torch.models.gpar import GPARConfig, fit_conditionals_parallel
    from gpar_at_scale_torch.utils.params import pack_gpar

    ds = generate_synthetic_eeg(seed=0)
    n = TRAIN_POINTS
    order = [ds.channels.index(c) for c in EEG_OBSERVED + EEG_PREDICTED]
    on_launches = None
    try:
        for mode, dtype in (("on", torch.float32), ("off", torch.float64)):
            _set_dense_mode(mode)
            for k in _dense():
                k.launches = 0
            as_dev = lambda a: torch.as_tensor(np.asarray(a)).to(_DEV, dtype)  # noqa: E731
            cfg = GPARConfig(backend="scaled", num_pseudo_points=n, max_opt_steps=EEG_STEPS,
                             dtype=dtype)
            start = _tensor_params(EEG_COND_START, pack_gpar, _DEV, dtype)
            _sync(_DEV)
            t0 = time.perf_counter()
            conds = fit_conditionals_parallel(None, as_dev(ds.t[:n]), as_dev(ds.Y[:n, order]), cfg,
                                              init_params=[start] * (len(order) - 1), device=_DEV)
            _sync(_DEV)
            secs = time.perf_counter() - t0
            launches = _dense_counts()
            rows = []
            for ch, fit in zip(EEG_PREDICTED, conds[-len(EEG_PREDICTED):]):
                par, seq = _nll64(fit), seq_ends[mode][("scaled", ch)]
                rows.append(f"{ch} {par:.4f} (sequential {seq:.4f})")
                if not math.isfinite(par):
                    failures.append(f"[parallel] EEG {mode} {ch}: the end point's objective is not finite")
            _log(f"[parallel] EEG scaled conditionals under '{mode}' ({dtype}), six with "
                 f"fit_conditionals_parallel: {secs:.3f} s, K6a/K6b/K6c launches {launches}; float64 objective at the "
                 f"end points: " + ", ".join(rows))
            if mode == "on":
                on_launches = launches
                if on_ends is not None:
                    on_ends.extend(_nll64(fit) for fit in conds)
                if not all(c > 0 for c in launches):
                    failures.append(f"[parallel] EEG under 'on' did not launch every K6 kernel: {launches}")
            elif any(launches):
                failures.append(f"[parallel] dense kernels launched under 'off': {launches}")
    finally:
        _set_dense_mode("off")
    return on_launches


# ---------------------------------------------------------------------------
# Posterior draws and the samplers: [ffbs], [smc], [nuts], [nuts-smc]
# ---------------------------------------------------------------------------

# benchmarks/million_smc.py: N = 1e6 steps of a sine surrogate observed with
# noise 0.3; the truth quoted for (lengthscale, sigma_f, sigma_n).
SMC_N, SMC_TRUTH = 1_000_000, (0.7, 1.2, 0.3)
FFBS_S = 4  # results_r5/ffbs_1m.txt: 4 joint draws
# [ffbs] checks: the draws standardized by the smoothed moments, over all
# S x N values: |mean| <= 0.01, |mean square - 1| <= 0.02.  The standardized
# error is correlated over tau = 191 steps (its autocorrelation summed, on a
# CPU at N = 2e5 with the same step density), so the standard errors over
# 4 x 10^6 values are 0.0069 and 0.0085: the bounds are 1.4 and 2.4 of them,
# tight for a correct sampler, and a wrong variance of 2% fails.  The kernel
# path's draw against the tensor-code affine scan on the same (E, g_s):
# max |diff| / max |x| <= FFBS_SCAN_RTOL; both run the float32 recursion
# over the same 16384 blocks, the kernels with FMAs, as for K4b (TOL).
FFBS_MEAN_ATOL, FFBS_MS_ATOL, FFBS_SCAN_RTOL = 0.01, 0.02, 1e-4
# [smc]: 64 particles, 3 mutations, at most 20 stages from the N(0, 2^2)
# prior's draws 0.5 N(0, 1), as million_smc.py's default host run.  The
# posterior median of (l, sigma_f, sigma_n) within 10% of the truth: the
# data are a sine surrogate, not a Matern-5/2 path, so only sigma_n is the
# generating value; the JAX package's 32-particle run reached (0.646, 1.199,
# 0.301) (results_r3/million_smc_1m_host.txt), 7.7% from l = 0.7.
SMC_PARTICLES, SMC_MUTATIONS, SMC_STAGES, SMC_RTOL = 64, 3, 20, 0.10
# [nuts]: benchmarks/ess.py --full, the EEG FZ conditional on F3-F6 (N =
# M = 156), bounded_reparam(3.0), max_depth 7, float32 under "on".  Cut for
# the run's time: 8 chains x (150 warmup + 250 kept) instead of 32 x (300 +
# 500); a lockstep transition of the 8 chains takes 0.33 to 0.44 s on an
# H100 at 700 W, host-bound (PERF.md).  Checks: divergences below 2%
# (tests/test_bayes.py), every constrained draw finite and inside (-3, 3),
# split R-hat <= 1.1.  At every chain's last draw the float32 "on" logpost
# against the float64 "off" one: values within 1e-3 relative (0.1 nats at
# the logpost's scale of 100), gradients within 1e-2 |g| + 2e-2 per
# component, or, at a draw where float32 itself cannot meet that, within
# twice the miss of the library's float32 ("off" in float32, torch.linalg)
# on the same draw.  The fixed bounds are ten times [eeg]'s start-point
# bounds (2e-5, 1e-3 |g| + 2e-3), which posterior draws failed on an H100
# (3.2e-5, 1.9 of the gradient bound); at 240 posterior draws on a CPU the
# library's float32 gradient missed the wider bound at 12 (up to 2.16 of
# it), as K6a's recursion did (2.19; at most 0.78 of the allowance): the
# float32 rounding of ill-conditioned Sigma_y, not the kernel.
NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES, NUTS_DEPTH = 8, 150, 250, 7
NUTS_DIV_RATE, NUTS_RHAT, NUTS_THETA = 0.02, 1.1, 16
NUTS_VALUE_RTOL, NUTS_GRAD_RTOL, NUTS_GRAD_ATOL = 1e-3, 1e-2, 2e-2
# [nuts]: points at which the float32 type-II algebra is held to the float64
# logpost (f32_algebra_gap), around the posterior and at kept draws.
NUTS_F32_POINTS = 128
# [nuts-smc]: benchmarks/nuts_vs_smc.py at N = 1e5 (results_r5's row): NUTS
# with gradients through the kernel path (K1/K2 forward, K4a/K4b backward),
# max_depth 6; SMC 64 particles on the same likelihood; the constrained
# posterior means agree within z = 4 MC errors, which at this cut is no
# evidence that the sampler is right: two chains of 30 draws do not mix on
# the (l, sigma_f) ridge (R-hat 2 to 3.5 on an H100), so the MC errors are
# wide.  The check that can fail a wrong gradient is the kernel path's value
# and gradient at the chains' last draws against the float64 blocked engine,
# at [full-N]'s bounds (FULL_TRACE_ATOL on the value / N, _grad_gap).  Cut
# for the run's time: 2
# chains x (25 + 30) instead of 4 x (100 + 150): each chain's evaluation is
# 20 to 30 ms of host-bound launches at this N (about 1100 launches, the
# device busy 15%), and a lockstep transition of 2 chains 0.8 to 1.0 s on an H100
# at 700 W (PERF.md).
NS_N, NS_CHAINS, NS_WARMUP, NS_SAMPLES, NS_DEPTH, NS_STAGES = 100_000, 2, 25, 30, 6, 25


# [segmented]: benchmarks/million_grad.py --seg-fisher (its :44-51, :56-110),
# not cut: N = 10^7 steps of million_grad's data from --seed (gaps of 0.5e-3
# to 1.5e-3, a sine of lengthscale 0.9 and scale 0.8, noise 0.25), a
# Matern-5/2 temporal GP from pack_gp(0.3, 1.0, 0.1), segments of 10^6,
# 20 Adam steps at 5e-2 on -grad / N, make_segmented_nll_grad in float32 (the
# times in float64: in float32 a time near 10^4 has a spacing of 1e-3, the
# size of a gap).  Its gradient at the start is held to two references,
# each component within [grad]'s bound at the reference's N (GRAD_RTOL |g|
# + GRAD_ATOL + GRAD_ATOL_PER_STEP N, the float32 floor growing with N, 10x
# at 10^7): the float64 blocked engine (tensor code, autograd through the
# discretization) on the first 10^6 steps, there in 4 segments; and, with
# the fused kernel path (logpdf_markov_pallas) at the largest N that fits,
# both float32 paths against the float64 segmented engine (tensor code) at
# that N.  Smoothing: segmented_smooth_t at N = 2 x 10^6 (2 segments) at the
# trained point against the fused pallas_smooth, and both against float64:
# means within SEG_SMOOTH_SD posterior sd, posterior sd within SEG_SMOOTH_SD
# of itself.  Draws: long_series.py's segsample row (N = 2 x 10^6, segments
# of 10^6, 4 draws; its data from --seed, Matern-5/2 (1, 1), noise 0.09):
# segmented_posterior_sample against blocked_posterior_sample on one xi,
# max |diff| / max |f| <= FFBS_SCAN_RTOL (both float32 on the kernels over
# different blockings).
SEG_N, SEG_SIZE, SEG_STEPS, SEG_LR = 10_000_000, 1_000_000, 20, 5e-2
SEG_START = (0.3, 1.0, 0.1)
SEG_REF_N, SEG_REF_SEGMENTS = 1_000_000, 4
SEG_SMOOTH_N, SEG_SMOOTH_SD = 2_000_000, 1e-2
SEG_SAMPLE_N, SEG_SAMPLE_S = 2_000_000, 4
# [mixed-bwd]: benchmarks/million_dtc.py --mixed-bwd=8 (make_data :48-67,
# Z every N/M-th input :96, start pack_gpar(0.5, 1, 1, 0.7, 0.2), Adam 5e-2
# on -grad / N), N = 10^6, not cut: the DTC bound's gradient at M = 128
# through chunks of 8 mixed columns against the plain WhitenGram backward,
# each component within [grad]'s bound at N; then 10 Adam steps at M = 256
# (the row that ran out of memory on the TPU) with the mixed backward.
MIXED_N, MIXED_N_STAR, MIXED_CHUNK, MIXED_STEPS = 1_000_000, 10_000, 8, 10
MIXED_M_CHECK, MIXED_M_TRAIN = 128, 256
MIXED_START = (0.5, 1.0, 1.0, 0.7, 0.2)


# [batch-scan]: the Bayesian predictive of the long-series conditional
# (portbench's gpar_dtc_m32_serve): predict_scaled_batch of B = 64 draws
# around million_dtc.py's start (sd 0.001) against its q(u), N = 10^6,
# N* = 10^4, M = 32, float32 through the scan branch; 3 of the draws
# against float64 predict_scaled within million_dtc (c)'s sd bound.
BSCAN_N, BSCAN_N_STAR, BSCAN_M, BSCAN_B, BSCAN_DRAW_SD = 1_000_000, 10_000, 32, 64, 1e-3
BSCAN_SCAN_KERNELS = ("K1", "K2", "K3", "K7", "K4a", "K4b")


def _all_counts():
    from gpar_at_scale_torch.ops import launch_counts

    return launch_counts()


def _zero_counts():
    from gpar_at_scale_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0


def _phase_end(tag, t0, launches):
    import torch

    _sync(_DEV)
    secs = time.perf_counter() - t0
    peak = _peak_gib() if torch.device(_DEV).type == "cuda" else float("nan")
    _log(f"[{tag}] {secs:.3f} s, peak device memory {peak:.2f} GiB; launches "
         + ", ".join(f"{k.split()[0]} {v}" for k, v in launches.items()))
    return secs


def ffbs_phase(seed, failures):
    """[ffbs] results_r5/ffbs_1m.txt on the card: S = 4 joint posterior
    draws of the Matern-5/2 temporal GP at million_smc.py's truth, N = 1e6,
    float32, through ``blocked_posterior_sample`` (the filter with moments
    on K1/K2, the sampling pass on K4a/K4b with C = S).  Then, staged, the
    filter's and the sampling pass's seconds; the draws standardized by the
    smoothed moments of ``pallas_smooth``; the kernel path's draw on a fixed
    xi against the tensor-code ``blocked_affine_suffix_scan`` on the card.
    Returns the launches of the entry point's call."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.million_smc import matern_lgssm, million_smc_data
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked
    from gpar_at_scale_torch.ops.smoother import pallas_smooth, suffix_scan
    from gpar_at_scale_torch.ssm.blocked import (
        blocked_affine_suffix_scan,
        blocked_posterior_sample,
        ffbs_elements,
    )
    from gpar_at_scale_torch.utils.params import pack_gp

    t_np, y_np, _ = million_smc_data(SMC_N)
    f32 = torch.float32
    t, y = torch.as_tensor(t_np).to(_DEV, f32), torch.as_tensor(y_np).to(_DEV, f32)
    lg = matern_lgssm(t, pack_gp(*(torch.tensor(v, dtype=torch.float64) for v in SMC_TRUTH)).to(_DEV))
    gen = torch.Generator(device=_DEV).manual_seed(seed)
    if torch.device(_DEV).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _sync(_DEV)
    t0 = time.perf_counter()
    draws = blocked_posterior_sample(gen, lg, y, FFBS_S)
    launches = _all_counts()
    total_s = _phase_end("ffbs", t0, launches)

    # staged: the filter, then the sampling pass on fixed standard normals
    _sync(_DEV)
    t0 = time.perf_counter()
    _, _, _, m, P = decorrelate_blocked(lg, y, return_moments=True)
    _sync(_DEV)
    filter_s = time.perf_counter() - t0
    xi = torch.randn((SMC_N, 3, FFBS_S), generator=gen, dtype=f32, device=_DEV)
    t0 = time.perf_counter()
    E, g_s, L = ffbs_elements(lg, m, P, xi, f32)
    x = suffix_scan(E, g_s, L)[0]
    _sync(_DEV)
    sample_s = time.perf_counter() - t0

    x_t = blocked_affine_suffix_scan(E, g_s)[1]
    scan_rel = float((x - x_t).abs().max() / x_t.abs().max())
    same = float((blocked_posterior_sample(gen, lg, y, FFBS_S, xi=xi) - x[:, 0, :].T).abs().max())
    f_mean, f_var, _ = pallas_smooth(lg, y)
    z = ((draws - f_mean[None]) / torch.sqrt(f_var)[None]).double()
    z_mean, z_ms = float(z.mean()), float((z * z).mean())
    finite = bool(torch.isfinite(draws).all() and torch.isfinite(x).all())
    ok_ = (finite and abs(z_mean) <= FFBS_MEAN_ATOL and abs(z_ms - 1.0) <= FFBS_MS_ATOL
           and scan_rel <= FFBS_SCAN_RTOL and same == 0.0 and draws.shape == (FFBS_S, SMC_N)
           and all(launches[k.name] > 0 for k in _scan_kernels() if not k.name.startswith(("K3", "K5"))))
    _log(f"[ffbs] {FFBS_S} joint draws x {SMC_N:,} steps: blocked_posterior_sample {total_s:.4f} s; "
         f"staged: filter {1e3 * filter_s:.2f} ms + sampling {1e3 * sample_s:.2f} ms "
         f"({FFBS_S * SMC_N / sample_s:.4e} sample-steps/s in the sampling pass); standardized "
         f"draws: mean {z_mean:.5f} (|.| <= {FFBS_MEAN_ATOL}), mean square {z_ms:.5f} "
         f"(1 +- {FFBS_MS_ATOL}); kernels vs tensor-code affine scan on one xi: {scan_rel:.3e} of "
         f"max |x| (<= {FFBS_SCAN_RTOL}), entry point vs staged draw on that xi {same:.1e}; finite {finite}; "
         f"draw sd {float(draws.std()):.4f} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[ffbs] the posterior draws failed a check")
    return launches


def batch_scan_phase(seed, failures):
    """[batch-scan] ``predict_scaled_batch`` above DENSE_N_MAX on the card:
    B = 64 draws at N = 10^6, N* = 10^4 (6.5e7 spliced steps through K1-K3,
    K7 and K4a/K4b once), then B = 1; the scan kernels' launches and the
    host syncs of a request must not depend on B; 3 of the 64 answers against float64
    ``predict_scaled`` (the tensor-code blocked smoother) within
    ``DTC_PRED_SD`` sd; peak device memory of the batch.  Returns the
    launches of the batched request."""
    import torch

    from gpar_at_scale_torch.benchmarks import million_dtc
    from gpar_at_scale_torch.gp.dtc import predict_scaled, predict_scaled_batch
    from gpar_at_scale_torch.utils.observability import counts

    f32 = torch.float32
    prob = million_dtc.problem(BSCAN_N, BSCAN_M, BSCAN_N_STAR, _DEV, seed)
    p0 = million_dtc.start(_DEV)
    qu = million_dtc.q_u(prob, p0)
    gen = torch.Generator(device=_DEV).manual_seed(seed)
    draws = p0[None] + BSCAN_DRAW_SD * torch.randn(BSCAN_B, 5, generator=gen, device=_DEV, dtype=f32)

    def request(P):
        time_k, out_k, nv = million_dtc.kernels(P.T)
        with torch.no_grad():
            return predict_scaled_batch(out_k, time_k, qu, prob.X, prob.t, prob.y, prob.t_star,
                                        prob.X_star, nv, dtype=f32)

    costs = {}
    for b in (BSCAN_B, 1):
        request(draws[:b])  # warm
        _reset_peak()
        _zero_counts()
        syncs = counts()["host_syncs"]
        t0 = time.perf_counter()
        pred = request(draws[:b])
        launches = _all_counts()
        secs = _phase_end(f"batch-scan B={b}", t0, launches)
        costs[b] = ({k.split()[0]: v for k, v in launches.items()
                     if k.split()[0] in BSCAN_SCAN_KERNELS}, counts()["host_syncs"] - syncs, secs)
        if b == BSCAN_B:
            batch, batch_launches, peak = pred, launches, _peak()
    gaps = []
    for i in (0, BSCAN_B // 2, BSCAN_B - 1):
        time_k, out_k, nv = million_dtc.kernels(draws[i].double())
        with torch.no_grad():
            want = predict_scaled(out_k, time_k, qu, prob.X, prob.t, prob.y, prob.t_star,
                                  prob.X_star, nv, dtype=torch.float64)
        sd = want.var.sqrt()
        gaps.append(max(float(((batch.mean[i].double() - want.mean) / sd).abs().max()),
                        float(((batch.var[i].double().sqrt() - sd) / sd).abs().max())))
    (l64, s64, t64), (l1, s1, t1) = costs[BSCAN_B], costs[1]
    ok_ = (l64 == l1 and all(v == 1 for v in l64.values()) and s64 <= s1
           and bool(torch.isfinite(batch.mean).all() and torch.isfinite(batch.var).all())
           and max(gaps) <= DTC_PRED_SD)
    _log(f"[batch-scan] B={BSCAN_B}: {t64:.4f} s a request ({BSCAN_B * BSCAN_N_STAR / t64:.4e} obs/s), "
         f"peak device memory {peak:.2f} GiB; B=1: {t1:.4f} s; scan launches {l64} at B={BSCAN_B}, "
         f"{l1} at B=1; host syncs {s64} and {s1}; draws 0, {BSCAN_B // 2}, {BSCAN_B - 1} against "
         f"float64 predict_scaled: {', '.join(f'{g:.2e}' for g in gaps)} sd (<= {DTC_PRED_SD}) "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[batch-scan] the batched long-series predictive failed a check")
    return batch_launches


def smc_phase(seed, failures):
    """[smc] million_smc.py's host-driven default on the card, through the
    port's ``benchmarks/million_smc.py::run(host=True)``: ``smc_host``
    with 64 particles, 3 mutations, at most 20 stages, each particle's
    likelihood at N = 1e6 one call on the kernel path (K1/K2); then the
    smoothed predictive at the posterior median (K1/K2, K4a/K4b) and its
    rmse against the latent path.  Returns the sampler's launches."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import million_smc

    if torch.device(_DEV).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = million_smc.run(SMC_N, SMC_PARTICLES, device=_DEV, host=True, mutations=SMC_MUTATIONS,
                          max_stages=SMC_STAGES, seed=seed, verbose=False)
    res, launches = out["result"], out["launches"]
    _phase_end("smc", t0, launches)
    secs = out["secs"]
    t_np, y_np, _ = million_smc.million_smc_data(SMC_N)
    t, y = (torch.as_tensor(a).to(_DEV, torch.float32) for a in (t_np, y_np))
    one = million_smc.kernel_loglik(t, y)
    x1 = million_smc.initial_particles(SMC_PARTICLES, seed)[:1]
    _log(f"[smc] one likelihood evaluation alone: {_time_ms(lambda: one(x1), 10):.3f} ms")
    profile_phase("smc likelihood", lambda: one(x1))
    med, rmse, pred_s = out["median"], out["rmse"], out["predict_s"]
    rel = np.abs(med - np.asarray(SMC_TRUTH)) / np.asarray(SMC_TRUTH)
    ok_ = (res.final_beta == 1.0 and bool((rel <= SMC_RTOL).all()) and np.isfinite(rmse)
           and rmse < SMC_TRUTH[2] and all(launches[k.name] > 0 for k in _scan_kernels()[:2]))
    _log(f"[smc] N={SMC_N:,}, {SMC_PARTICLES} particles: {res.num_stages} stages, beta "
         f"{res.final_beta:.4f}, logZ {res.log_evidence:.1f}, accept {res.acceptance:.3f}, "
         f"{res.num_lik_evals} likelihood evaluations in {secs:.3f} s "
         f"({1e3 * secs / res.num_lik_evals:.3f} ms per evaluation); posterior median "
         f"(l, sf, sn) {np.round(med, 4).tolist()} vs truth {list(SMC_TRUTH)}: relative "
         f"{np.round(rel, 4).tolist()} (<= {SMC_RTOL}); smoothed predictive at the median: rmse "
         f"vs latent {rmse:.4f} (noise {SMC_TRUTH[2]}) in {pred_s:.3f} s {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[smc] the SMC posterior failed a check")
    return launches


def nuts_phase(seed, smse_type2, failures):
    """[nuts] benchmarks/ess.py --full on the card under "on": NUTS chains
    in lockstep over the EEG FZ conditional (DTC, Z = X, N = M = 156,
    float32, bounded_reparam(3.0)) through ``sample_conditional_posterior``,
    the chains' Sigma_y factored and their columns whitened as one batch
    by K6a (the VJPs' K6c; the M x M algebra is float64 ``torch.linalg``);
    split R-hat and multi-chain ESS per parameter, ESS/s, samples/s,
    divergences, acceptance.  At every chain's last draw the "on" logpost
    and gradient against the float64 "off" one (beside the library's
    float32), and the float32 type-II algebra's gap (``f32_algebra_gap``).
    Then
    ``predictive_mixture_scaled`` over 16 draws on the 100 test times, its
    SMSE beside the type-II fit's from [eeg].  Returns the launches of the
    sampler and the mixture (K6b launches in the mixture: the sampler's
    M x M algebra is float64, ``models/bayes.py``)."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import ess as ess_bench
    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS, generate_synthetic_eeg
    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.models.bayes import predictive_mixture_scaled

    ds = generate_synthetic_eeg(seed=0)
    n = TRAIN_POINTS
    obs = [ds.channels.index(c) for c in EEG_OBSERVED]
    X, X_te = ds.Y[:n, obs], ds.Y[n:, obs]
    y, truth = ds.Y[:n, ds.channels.index("FZ")], ds.Y[n:, ds.channels.index("FZ")]
    f32, f64 = torch.float32, torch.float64

    def bounded(dtype):
        return ess_bench.eeg_logpost(_DEV, dtype, full=True)

    assert ess_bench.MAX_DEPTH == NUTS_DEPTH
    try:
        _set_dense_mode("on")
        if torch.device(_DEV).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        run = ess_bench.run(_DEV, chains=NUTS_CHAINS, full=True, num_samples=NUTS_SAMPLES,
                            num_warmup=NUTS_WARMUP, seed=seed)
        launches = _all_counts()
        _phase_end("nuts", t0, launches)
        res, logpost_u, constrain, secs = run["res"], run["logpost_u"], run["constrain"], run["secs"]
        st = res.stats
        pooled, rhat, ess_ = run["pooled"], run["rhat"], run["ess"]  # pooled: (C, S, 5)
        n_div, n_tot = run["divergent"], run["total"]
        leaves = st.num_calls
        _log(f"[nuts] EEG FZ | F3-F6 (N = M = {n}, float32, 'on'): {NUTS_CHAINS} chains x "
             f"({NUTS_WARMUP} + {NUTS_SAMPLES}) in {secs:.3f} s; {leaves} batched logpost calls "
             f"({1e3 * secs / leaves:.3f} ms each, {st.num_readbacks} host readbacks); mean tree "
             f"depth {float(st.mean_tree_depth.mean()):.3f}, step sizes "
             f"{np.round(st.step_size.cpu().numpy(), 4).tolist()}")
        _log(f"[nuts] split R-hat {np.round(rhat, 4).tolist()}; multi-chain ESS "
             f"{np.round(ess_, 1).tolist()}; ESS/s (min) {ess_.min() / secs:.3f}; samples/s "
             f"{n_tot / secs:.3f}; divergences {n_div} / {n_tot} ({100.0 * n_div / n_tot:.2f}%); "
             f"mean accept {float(res.accept_prob):.4f}")
        K6A, _, K6C = _dense()
        ok_ = (n_div / n_tot < NUTS_DIV_RATE and bool(np.isfinite(pooled).all())
               and bool((np.abs(pooled) < 3.0).all()) and bool((rhat <= NUTS_RHAT).all())
               and launches[K6A.name] > 0 and launches[K6C.name] > 0)

        # where a call's time goes: one batched value and gradient, alone and traced
        vg, u_last = value_and_grad(logpost_u), res.samples[:, -1]
        _log(f"[nuts] one batched value and gradient of {NUTS_CHAINS} chains alone: "
             f"{_time_ms(lambda: vg(u_last), 10):.3f} ms (inside NUTS {1e3 * secs / leaves:.3f} ms)")
        profile_phase("nuts logpost call", lambda: vg(u_last))

        # every chain's last draw: the "on" float32 logpost against the float64
        # "off" one, beside the library's float32 ("off" in float32)
        u = res.samples[:, -1]
        v_on, g_on = value_and_grad(logpost_u)(u)
        _set_dense_mode("off")
        v_off, g_off = value_and_grad(bounded(f64)[0])(u.double())
        v_lib, g_lib = value_and_grad(bounded(f32)[0])(u)

        def over(v, g):  # each chain's miss of a float32 path, in units of the fixed bounds
            v_over = (v.double() - v_off).abs() / (NUTS_VALUE_RTOL * v_off.abs())
            g_over = ((g.double() - g_off).abs() / (NUTS_GRAD_RTOL * g_off.abs() + NUTS_GRAD_ATOL))
            return v_over.cpu().numpy(), g_over.amax(-1).cpu().numpy()

        (v_k, g_k), (v_l, g_l) = over(v_on, g_on), over(v_lib, g_lib)
        allow_v, allow_g = np.maximum(1.0, 2.0 * v_l), np.maximum(1.0, 2.0 * g_l)
        _log(f"[nuts] the {NUTS_CHAINS} chains' last draws against float64 'off', in units of the "
             f"bounds {NUTS_VALUE_RTOL} |v| and {NUTS_GRAD_RTOL} |g| + {NUTS_GRAD_ATOL}: 'on' values "
             f"{np.round(v_k, 3).tolist()}, gradients {np.round(g_k, 3).tolist()}; the library's "
             f"float32 values {np.round(v_l, 3).tolist()}, gradients {np.round(g_l, 3).tolist()}; "
             f"'on' over its allowance max(1, 2 x library): {float((v_k / allow_v).max()):.3f}, "
             f"{float((g_k / allow_g).max()):.3f}")
        ok_ &= bool((v_k <= allow_v).all() and (g_k <= allow_g).all())
        f32_algebra_gap(ds.t[:n], X, y, pooled, seed)

        _set_dense_mode("on")
        before = _all_counts()
        t0 = time.perf_counter()
        mean, var = predictive_mixture_scaled(None, constrain(res.samples), ds.t[:n], X, y, X,
                                              ds.t[n:], X_te, num_theta=NUTS_THETA, dtype=f32,
                                              device=_DEV)
        _sync(_DEV)
        pm_s = time.perf_counter() - t0
        smse = _smse(mean, truth)
        finite = bool(torch.isfinite(mean).all() and (var >= 0).all())
        mixture = {k: c - before[k] for k, c in _all_counts().items()}
        ok_ &= finite and all(mixture[k.name] > 0 for k in _dense())
        _log(f"[nuts] predictive_mixture_scaled ({NUTS_THETA} draws, {truth.shape[0]} test times): "
             f"{pm_s:.3f} s, SMSE {smse:.4f} (type-II scaled fit in [eeg] 'on': {smse_type2:.4f}); "
             f"K6a/K6b/K6c launches {tuple(mixture[k.name] for k in _dense())}; finite {finite} "
             f"{'ok' if ok_ else 'FAIL'}")
    finally:
        _set_dense_mode("off")
    if not ok_:
        failures.append("[nuts] the EEG posterior failed a check")
    return {k: launches[k] + mixture[k] for k in launches}


def f32_algebra_gap(t, X, y, pooled, seed):
    """Why the sampler's DTC logpost forms its M x M algebra in float64:
    the float32 algebra of the type-II bound, ``gp/dtc.py::dtc_objective``
    under "on" (K6a for Sigma_y and K_uu, the library's float32 factor of
    P = G_b + K_uu, K6b), against the float64 logpost, at NUTS_F32_POINTS
    points around the posterior (its mean plus N(0, 1) per log-parameter,
    within the bound) and at as many kept draws.  Prints the factorizations
    that fail and the gap in nats where none does; a measurement, no check."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.kernels import Matern52, time_kernel_only
    from gpar_at_scale_torch.models.bayes import make_conditional_logpost
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.utils.params import unpack_gpar

    f32, f64 = torch.float32, torch.float64
    t32, X32, y32 = (torch.as_tensor(a).to(_DEV, f32) for a in (t, X, y))
    draws = torch.as_tensor(pooled.reshape(-1, 5))
    around = draws.mean(0) + torch.randn((NUTS_F32_POINTS, 5), generator=torch.Generator()
                                         .manual_seed(seed), dtype=f64)
    picks = np.linspace(0, draws.shape[0] - 1, NUTS_F32_POINTS).astype(np.int64)
    _set_dense_mode("off")
    lp64 = make_conditional_logpost(t, X, y, likelihood="dtc", Z=X, dtype=f64, device=_DEV)
    for label, pts in (("around the posterior", around.clamp(-2.95, 2.95)),
                       ("at kept draws", draws[picks])):
        with torch.no_grad():
            ref = lp64(pts.to(_DEV)).cpu().numpy()
        _set_dense_mode("on")
        gaps, failed = [], 0
        for p, r in zip(pts.to(_DEV, f32), ref):
            tl, ts, ol, osig, ns = unpack_gpar(p)
            time_k = time_kernel_only(Matern52, tl, ts)
            lg = lgssm_of(time_k, t32, ns**2, f32)
            try:
                with torch.no_grad():
                    v = float(dtc_objective(Matern52(lengthscale=ol, variance=osig**2), lg, X32,
                                            X32, y32, uu_ridge=ns**2, time_kernel=time_k, t=t32))
            except torch.linalg.LinAlgError:  # the measured event: a float32 factor failed
                failed += 1
                continue
            gaps.append(abs(v - 0.5 * float((p.double() ** 2).sum()) / 4.0 - r))
        _set_dense_mode("off")
        gaps = np.asarray(gaps)
        _log(f"[nuts] float32 type-II algebra (dtc_objective 'on') vs the float64 logpost, "
             f"{pts.shape[0]} points {label}: {failed} failed factorizations; |gap| median "
             f"{np.median(gaps):.4g}, max {gaps.max():.4g} nats over the {gaps.size} others")


def nuts_smc_phase(seed, failures):
    """[nuts-smc] benchmarks/nuts_vs_smc.py at N = 1e5 through the port's
    ``benchmarks/nuts_vs_smc.py`` (its ``--pallas`` route): NUTS on the
    temporal GP's posterior with gradients through the kernel path
    (``make_temporal_logpost``: K1/K2 forward, K4a/K4b backward, one chain
    per call), and ``smc_host`` on the same likelihood (K1/K2); the
    constrained posterior means must agree within 4 Monte-Carlo errors, and
    the kernel path's value and gradient at the last draws must match the
    float64 blocked engine's (``blocked_temporal_logpost``).
    Returns both samplers' launches."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks import nuts_vs_smc
    from gpar_at_scale_torch.benchmarks.million_smc import million_smc_data
    from gpar_at_scale_torch.inference.hmc import value_and_grad

    t_np, y_np, _ = million_smc_data(NS_N)
    f32 = torch.float32
    t, y = torch.as_tensor(t_np).to(_DEV, f32), torch.as_tensor(y_np).to(_DEV, f32)
    if torch.device(_DEV).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res, logpost, _ = nuts_vs_smc.run_nuts(t, y, NS_CHAINS, NS_SAMPLES, NS_WARMUP, route="pallas",
                                           seed=seed, max_depth=NS_DEPTH)
    nuts_launches = _all_counts()
    nuts_s = _phase_end("nuts-smc", t0, nuts_launches)
    # the kernel path's value and gradient at the last draws against the float64 blocked engine
    q = res.samples[:, -1]
    v_k, g_k = value_and_grad(logpost)(q)
    v_r, g_r = value_and_grad(nuts_vs_smc.blocked_temporal_logpost(t, y))(q.double())
    v_gap = float((v_k.double() - v_r).abs().max()) / NS_N
    grads_ok = [_grad_gap(gk, gr, NS_N) for gk, gr in zip(g_k.double().cpu().numpy(),
                                                          g_r.cpu().numpy())]
    engines_ok = v_gap <= FULL_TRACE_ATOL and all(o for o, _ in grads_ok)
    _log(f"[nuts-smc] the {NS_CHAINS} chains' last draws, kernel path vs float64 blocked engine: "
         f"|value| gap / N {v_gap:.3e} (atol {FULL_TRACE_ATOL}); gradients: "
         + "; ".join(gap for _, gap in grads_ok) + f" {'ok' if engines_ok else 'FAIL'}")
    vg, q1 = value_and_grad(logpost), res.samples[:1, -1]
    _log(f"[nuts-smc] one chain's value and gradient alone: {_time_ms(lambda: vg(q1), 10):.3f} ms")
    profile_phase("nuts-smc logpost call", lambda: vg(q1))
    _zero_counts()
    t0 = time.perf_counter()
    res_s, _ = nuts_vs_smc.run_smc(t, y, SMC_PARTICLES, seed=seed, stages=NS_STAGES,
                                   mutations=SMC_MUTATIONS)
    smc_launches = _all_counts()
    smc_s = _phase_end("nuts-smc", t0, smc_launches)
    chains = np.exp(res.samples.double().cpu().numpy()) + 1e-3
    d_nuts, d_smc, z, agree = nuts_vs_smc.compare(res.samples.double().cpu().numpy(),
                                                  res_s.particles)
    n_div = int(res.num_divergent.sum())
    ok_ = (agree and engines_ok and res_s.final_beta == 1.0 and bool(np.isfinite(chains).all())
           and all(nuts_launches[k.name] > 0 for k in _scan_kernels() if not k.name.startswith("K3")))
    _log(f"[nuts-smc] N={NS_N:,}: NUTS {NS_CHAINS} chains x ({NS_WARMUP} + {NS_SAMPLES}) in "
         f"{nuts_s:.3f} s, {res.num_calls} logpost calls ({1e3 * nuts_s / res.num_calls:.3f} ms "
         f"each, {res.num_readbacks} host readbacks), divergences {n_div}, accept "
         f"{np.round(res.accept_prob.cpu().numpy(), 3).tolist()}, R-hat "
         f"{np.round(d_nuts.rhat, 4).tolist()}, ESS {np.round(d_nuts.ess, 1).tolist()}; SMC "
         f"{SMC_PARTICLES} particles, {res_s.num_stages} stages, {res_s.num_lik_evals} evaluations "
         f"in {smc_s:.3f} s ({1e3 * smc_s / res_s.num_lik_evals:.3f} ms each)")
    _log(f"[nuts-smc] mean (l, sf, sn): NUTS {np.round(d_nuts.mean, 5).tolist()} +- "
         f"{np.round(d_nuts.mcse, 5).tolist()}; SMC {np.round(d_smc.mean, 5).tolist()} +- "
         f"{np.round(d_smc.mcse, 5).tolist()}; |z| {np.round(z, 3).tolist()} (< 4): agree {agree} "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[nuts-smc] NUTS and SMC disagree or a check failed")
    return {k: nuts_launches[k] + smc_launches[k] for k in nuts_launches}


def _reset_peak():
    import torch

    if torch.device(_DEV).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak():
    import torch

    return _peak_gib() if torch.device(_DEV).type == "cuda" else float("nan")


def _grad_line(tag, name, got, want, n, failures):
    ok_, gap = _grad_gap(got, want, n)
    _log(f"[{tag}] {name}: {gap} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append(f"[{tag}] {name} disagrees")


def segmented_grad_checks(t, y, p0, failures):
    """The segmented float32 gradient at the start against the float64
    blocked engine at SEG_REF_N (in SEG_REF_SEGMENTS segments), and with the
    fused kernel path at the largest N of t that fits against the float64
    segmented engine there.  Returns (that N, fused peak GiB, segmented peak
    GiB at that N)."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.million_grad import fused_grad, matern52_gp, seg_grad
    from gpar_at_scale_torch.ssm.blocked_grad import blocked_loglik
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    f32, f64 = torch.float32, torch.float64
    n = SEG_REF_N
    ll_s, g_s = seg_grad(t[:n], y[:n], p0, n // SEG_REF_SEGMENTS, f32)
    p = p0.double().detach().requires_grad_(True)
    k, nv = matern52_gp(p)
    ll_r = blocked_loglik(lgssm_of(k, t[:n], nv, f64), y[:n].double())
    (g_r,) = torch.autograd.grad(ll_r, p)
    _log(f"[segmented] N={n:,}: ll/N segmented float32 ({SEG_REF_SEGMENTS} segments) "
         f"{ll_s / n:.10f} vs float64 blocked engine {float(ll_r.detach()) / n:.10f}")
    _grad_line("segmented", f"gradient at N={n:,}, segmented float32 vs float64 blocked engine",
               g_s, g_r.cpu().numpy(), n, failures)

    n = t.shape[0]
    while True:
        _reset_peak()
        t0 = time.perf_counter()
        try:
            ll_f, g_f = fused_grad(t[:n], y[:n], p0)
            break
        except torch.cuda.OutOfMemoryError:
            _log(f"[segmented] the fused kernel path's gradient at N={n:,} ran out of memory")
            n //= 2
    fused_s, peak_f = time.perf_counter() - t0, _peak()
    _reset_peak()
    t0 = time.perf_counter()
    ll_s, g_s = seg_grad(t[:n], y[:n], p0, SEG_SIZE, f32)
    seg_s, peak_s = time.perf_counter() - t0, _peak()
    ll_r, g_r = seg_grad(t[:n], y[:n], p0, SEG_SIZE, f64)
    _log(f"[segmented] N={n:,} (the largest the fused path fit): ll/N fused float32 {ll_f / n:.10f}, "
         f"segmented float32 {ll_s / n:.10f}, segmented float64 {ll_r / n:.10f}; the gradient "
         f"fused {fused_s:.4f} s at {peak_f:.2f} GiB, segmented (segments of {SEG_SIZE:,}) "
         f"{seg_s:.4f} s at {peak_s:.2f} GiB; gradient "
         f"fused {np.round(g_f, 3).tolist()}, segmented {np.round(g_s, 3).tolist()}, float64 "
         f"{np.round(g_r, 3).tolist()}")
    _grad_line("segmented", f"gradient at N={n:,}, fused kernel path vs float64 segmented",
               g_f, g_r, n, failures)
    _grad_line("segmented", f"gradient at N={n:,}, segmented float32 vs float64 segmented",
               g_s, g_r, n, failures)
    return n, peak_f, peak_s


def _smooth_check(t, y, p, failures):
    """segmented_smooth_t (SEG_SIZE segments) against the fused pallas_smooth
    and both against the float64 segmented smoother, in posterior sd."""
    import torch

    from gpar_at_scale_torch.benchmarks.million_grad import matern52_gp
    from gpar_at_scale_torch.ops.smoother import pallas_smooth
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.ssm.segmented import segmented_smooth_t

    f32 = torch.float32
    k, nv = matern52_gp(p.double())
    _sync(_DEV)
    t0 = time.perf_counter()
    seg = segmented_smooth_t(k, t, nv, y, SEG_SIZE, dtype=f32)
    _sync(_DEV)
    seg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_mean, f_var, _ = pallas_smooth(lgssm_of(k, t, nv, f32), y)
    _sync(_DEV)
    fused_s = time.perf_counter() - t0
    ref = segmented_smooth_t(k, t, nv, y.double(), SEG_SIZE)
    sd = torch.sqrt(ref.var)
    gaps = {}
    for name, mean, var in (("segmented", seg.mean, seg.var), ("fused", f_mean, f_var)):
        gaps[name] = (float(((mean.double() - ref.mean) / sd).abs().max()),
                      float(((torch.sqrt(var.double()) - sd) / sd).abs().max()))
    d_mean = float(((seg.mean.double() - f_mean.double()) / sd).abs().max())
    ok_ = all(max(g) <= SEG_SMOOTH_SD for g in gaps.values()) and d_mean <= SEG_SMOOTH_SD
    _log(f"[segmented] segmented_smooth_t N={t.shape[0]:,} in {t.shape[0] // SEG_SIZE} segments "
         f"{seg_s:.3f} s, fused pallas_smooth {fused_s:.3f} s; max |mean - float64| / sd, max "
         f"|sd - float64 sd| / sd: " + ", ".join(f"{k_} {a:.2e}, {b:.2e}" for k_, (a, b) in gaps.items())
         + f"; segmented vs fused means {d_mean:.2e} sd (<= {SEG_SMOOTH_SD}) {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[segmented] the segmented smoother disagrees")


def _sample_check(seed, failures):
    """long_series.py's segsample row: segmented_posterior_sample against
    blocked_posterior_sample on one xi."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.ssm.blocked import blocked_posterior_sample
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.ssm.segmented import segmented_posterior_sample

    f32, n = torch.float32, SEG_SAMPLE_N
    rng = np.random.default_rng(seed)
    t_np = np.cumsum(rng.uniform(0.5, 1.5, n)) / 1000.0
    y_np = np.sin(t_np * 3) + 0.3 * rng.normal(size=n)
    t, y = torch.as_tensor(t_np, device=_DEV), torch.as_tensor(y_np).to(_DEV, f32)
    one = torch.tensor(1.0, dtype=torch.float64)
    lg = lgssm_of(Matern52(lengthscale=one, variance=one), t, 0.09, f32)
    gen = torch.Generator(device=_DEV).manual_seed(seed)
    xi = torch.randn((n, 3, SEG_SAMPLE_S), generator=gen, dtype=f32, device=_DEV)
    _reset_peak()
    _sync(_DEV)
    t0 = time.perf_counter()
    f_seg = segmented_posterior_sample(gen, lg, y, SEG_SAMPLE_S, SEG_SIZE, xi=xi)
    _sync(_DEV)
    seg_s = time.perf_counter() - t0
    peak = _peak()
    f_blk = blocked_posterior_sample(gen, lg, y, SEG_SAMPLE_S, xi=xi)
    rel = float((f_seg - f_blk).abs().max() / f_blk.abs().max())
    ok_ = bool(torch.isfinite(f_seg).all()) and rel <= FFBS_SCAN_RTOL and f_seg.shape == (SEG_SAMPLE_S, n)
    _log(f"[segmented] segmented_posterior_sample {SEG_SAMPLE_S} draws x {n:,} steps in "
         f"{n // SEG_SIZE} segments: {seg_s:.3f} s ({SEG_SAMPLE_S * n / seg_s:.4e} sample-steps/s, "
         f"the filter included), peak device memory {peak:.2f} GiB; vs blocked_posterior_sample on "
         f"the same xi: {rel:.3e} of max |f| (<= {FFBS_SCAN_RTOL}) {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[segmented] the segmented draws disagree with the blocked ones")


def segmented_phase(seed, failures):
    """[segmented] million_grad.py --seg-fisher on the card: the gradient
    checks at the start (``segmented_grad_checks``), 20 Adam steps of
    ``make_segmented_nll_grad`` (float32, K1/K2 forward and K4a/K4b backward
    per segment) at N = 10^7, then the segmented smoother and draws.
    Returns the launches of the training run."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.million_grad import matern52_gp, million_grad_data
    from gpar_at_scale_torch.ssm.segmented import SEGMENT_SIZE, make_segmented_nll_grad
    from gpar_at_scale_torch.utils.params import pack_gp

    f32 = torch.float32
    t0 = time.perf_counter()
    t_np, y_np = million_grad_data(SEG_N, seed)
    t, y = torch.as_tensor(t_np, device=_DEV), torch.as_tensor(y_np).to(_DEV, f32)
    p0 = pack_gp(*(torch.tensor(v, dtype=torch.float64) for v in SEG_START)).to(_DEV, f32)
    _log(f"[segmented] N={SEG_N:,} million_grad data (seed {seed}) in {time.perf_counter() - t0:.1f} s")
    n_fused, peak_fused, peak_seg_n = segmented_grad_checks(t, y, p0, failures)

    _reset_peak()
    make_segmented_nll_grad(matern52_gp, t[:SEG_SIZE], y[:SEG_SIZE], SEG_SIZE, dtype=f32)(p0)
    peak_one = _peak()
    grad_fn = make_segmented_nll_grad(matern52_gp, t, y, SEG_SIZE, dtype=f32)
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=SEG_LR)
    trace = []
    _reset_peak()
    _zero_counts()
    _sync(_DEV)
    t0 = time.perf_counter()
    for _ in range(SEG_STEPS):
        ll, g = grad_fn(p.detach())
        p.grad = -g / SEG_N
        opt.step()
        trace.append(-float(ll) / SEG_N)
    launches = _all_counts()
    train_s = _phase_end("segmented", t0, launches)
    peak = _peak()
    trace = np.asarray(trace)
    fell = bool(np.isfinite(trace).all() and trace[-1] < trace[0])
    # the segments' backward is the tensor code's (ssm/segmented.py): no K3, K5a/K5b
    launched = all(launches[k.name] > 0 for k in _scan_kernels() if not k.name.startswith(("K3", "K5")))
    _log(f"[segmented] training N={SEG_N:,} in {SEG_N // SEG_SIZE} segments of {SEG_SIZE:,}: "
         f"{SEG_STEPS} Adam steps in {train_s:.3f} s ({train_s / SEG_STEPS:.4f} s/step, "
         f"{SEG_N * SEG_STEPS / train_s:.4e} filter steps/s forward and backward); nll/N "
         f"{[round(float(x), 6) for x in trace]} {'falls' if fell else 'does not fall: FAIL'}; "
         f"end point (l, sf, sn) {np.round((np.exp(p.detach().double().cpu().numpy()) + 1e-3), 4).tolist()}; "
         f"peak device memory {peak:.2f} GiB (one segment of {SEG_SIZE:,} alone {peak_one:.2f} GiB; "
         f"the fused gradient at N={n_fused:,} {peak_fused:.2f} GiB, segmented there "
         f"{peak_seg_n:.2f} GiB); K1/K2/K4a/K4b launched {launched}")
    if not (fell and launched):
        failures.append("[segmented] the training run's nll/N did not fall or a kernel did not launch")
    profile_phase("segmented gradient, N=1e7 in 10 segments", lambda: grad_fn(p.detach()))
    _reset_peak()
    _sync(_DEV)
    t0 = time.perf_counter()
    make_segmented_nll_grad(matern52_gp, t, y, dtype=f32)(p.detach())
    _sync(_DEV)
    _log(f"[segmented] one gradient at N={SEG_N:,} in segments of the default SEGMENT_SIZE "
         f"{SEGMENT_SIZE:,}: {time.perf_counter() - t0:.4f} s, peak device memory {_peak():.2f} GiB")
    _smooth_check(t[:SEG_SMOOTH_N], y[:SEG_SMOOTH_N], p.detach(), failures)
    del t, y
    _sample_check(seed, failures)
    return launches


def mixed_bwd_phase(seed, failures):
    """[mixed-bwd] million_dtc.py --mixed-bwd=8 on the card: the bound's
    gradient at M = 128 through the mixed-column backward against the plain
    WhitenGram backward (peak memory of each), the plain backward's peak at
    M = 256, then 10 Adam steps at M = 256 with the mixed backward.  Returns
    the launches of the training run."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.million_dtc import dtc_value_grad, million_dtc_data
    from gpar_at_scale_torch.utils.params import pack_gpar

    f32 = torch.float32
    t_np, X_np, y_np = million_dtc_data(MIXED_N, MIXED_N_STAR, seed)
    t = torch.as_tensor(t_np, device=_DEV)
    X, y = torch.as_tensor(X_np).to(_DEV, f32), torch.as_tensor(y_np).to(_DEV, f32)
    p0 = pack_gpar(*(torch.tensor(v, dtype=torch.float64) for v in MIXED_START)).to(_DEV, f32)
    peaks, secs = {}, {}
    grads = {}
    for m, mixed in ((MIXED_M_CHECK, 0), (MIXED_M_CHECK, MIXED_CHUNK), (MIXED_M_TRAIN, 0)):
        Z = X[:: max(1, MIXED_N // m)][:m]
        _reset_peak()
        _sync(_DEV)
        t0 = time.perf_counter()
        value, g = dtc_value_grad(t, X, y, Z, p0, mixed)
        _sync(_DEV)
        secs[m, mixed] = time.perf_counter() - t0
        peaks[m, mixed] = _peak()
        grads[m, mixed] = (value, g.double().cpu().numpy())
    (v_p, g_p), (v_m, g_m) = grads[MIXED_M_CHECK, 0], grads[MIXED_M_CHECK, MIXED_CHUNK]
    _log(f"[mixed-bwd] N={MIXED_N:,} M={MIXED_M_CHECK}: bound/N {v_p / MIXED_N:.10f}; gradient "
         f"plain {np.round(g_p, 3).tolist()} in {secs[MIXED_M_CHECK, 0]:.3f} s at "
         f"{peaks[MIXED_M_CHECK, 0]:.2f} GiB, mixed (chunks of {MIXED_CHUNK}) "
         f"{np.round(g_m, 3).tolist()} in {secs[MIXED_M_CHECK, MIXED_CHUNK]:.3f} s at "
         f"{peaks[MIXED_M_CHECK, MIXED_CHUNK]:.2f} GiB; plain at M={MIXED_M_TRAIN} "
         f"{secs[MIXED_M_TRAIN, 0]:.3f} s at {peaks[MIXED_M_TRAIN, 0]:.2f} GiB")
    _grad_line("mixed-bwd", f"gradient at M={MIXED_M_CHECK}, mixed vs plain backward", g_m, g_p,
               MIXED_N, failures)

    Z = X[:: max(1, MIXED_N // MIXED_M_TRAIN)][:MIXED_M_TRAIN]
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=5e-2)
    trace = []
    _reset_peak()
    _zero_counts()
    _sync(_DEV)
    t0 = time.perf_counter()
    for _ in range(MIXED_STEPS):
        value, g = dtc_value_grad(t, X, y, Z, p, MIXED_CHUNK)
        p.grad = -g / MIXED_N
        opt.step()
        trace.append(-value / MIXED_N)
    launches = _all_counts()
    train_s = _phase_end("mixed-bwd", t0, launches)
    peak = _peak()
    trace = np.asarray(trace)
    ok_ = bool(np.isfinite(trace).all() and trace[-1] < trace[0]) and all(
        launches[k.name] > 0 for k in _scan_kernels())
    _log(f"[mixed-bwd] training N={MIXED_N:,} M={MIXED_M_TRAIN}, chunks of {MIXED_CHUNK}: "
         f"{MIXED_STEPS} Adam steps in {train_s:.3f} s ({train_s / MIXED_STEPS:.4f} s/step); nll/N "
         f"{[round(float(x), 6) for x in trace]}; peak device memory {peak:.2f} GiB (the plain "
         f"backward's gradient at M={MIXED_M_TRAIN} {peaks[MIXED_M_TRAIN, 0]:.2f} GiB) "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[mixed-bwd] the M = 256 training run failed a check")
    profile_phase("mixed-bwd gradient, M=256", lambda: dtc_value_grad(t, X, y, Z, p, MIXED_CHUNK))
    return launches


# ---------------------------------------------------------------------------
# The parallel layer ([dist]) and the run-support modules ([aux])
# ---------------------------------------------------------------------------

# [dist]: the parallel layer (gpar_at_scale_torch/parallel/) on one card,
# over NCCL with one rank (every axis of size 1: the unsharded engines, whose
# seconds and peak memory are the unsharded figures and whose results are
# the references) and over gloo with DIST_RANKS ranks that share the card
# (NCCL refuses two ranks on one GPU; the gloo collectives of CUDA tensors
# are staged through the host, parallel/distributed.py).  Its paths:
#   seq   -- benchmarks/pod_scale.py's phase B at its chip default
#            (:95-120, :133): N = 10^6 steps (t = cumsum(U(0.5, 1.5)) / N,
#            numpy seed 1), 8 columns of standard normals, Matern-5/2 at
#            l = 0.5, sigma^2 = 1, noise 0.1, float32, through
#            make_sharded_decorrelate over the "data" axis; then
#            make_sharded_smooth and the gradient of make_sharded_logpdf in
#            (log l, log sigma^2, log noise) on the first column;
#   model -- dtc_objective_modelsharded's nlml and gradient
#            (make_modelsharded_nlml) on million_dtc.py's data at N = 10^6,
#            M = 256 (its --mixed-bwd configuration), start MIXED_START;
#   chain -- make_sharded_train_step, 8 chains of the chain's second output
#            (chain_scale.py's conditional: N = 10^6, M = 32), 5 Adam steps
#            at 1e-2, on a (chain 2, data 1) and a (chain 1, data 2) mesh;
#   fit   -- fit_gpar(mesh=) on the EEG chain (F3-F6, FZ, F1, F2: six
#            conditionals) over a chain axis of 2 ranks under dense mode
#            "on", [eeg]'s starts and L-BFGS.
# Bounds, no looser than [segmented]'s for the same quantities: smoothed
# means within SEG_SMOOTH_SD posterior sd and sd within SEG_SMOOTH_SD of
# itself; gradients within [grad]'s bound at N (_grad_gap); values as nll/N
# (or ll/N) within FULL_TRACE_ATOL; the whitened columns within the K2
# check's tolerance of their largest magnitude (both sides run K1/K2 on
# other blockings).  The fit: each conditional's float64 objective at its
# end point within DIST_FIT_RTOL of [parallel]'s unsharded fit: the same
# computation per conditional, but float32 L-BFGS follows its rounding (on a
# CPU, other thread counts moved the end points' objectives by 1e-4
# relative; a conditional fitted on the wrong columns misses by 2e-2 and
# more).  More ranks than 2, and any
# speed or scaling across cards, cannot be had on one card.
DIST_N, DIST_COLS, DIST_RANKS = 1_000_000, 8, 2
DIST_M_MODEL, DIST_CHAINS, DIST_STEPS, DIST_LR = 256, 8, 5, 1e-2
DIST_FIT_RTOL = 1e-3
_DIST_DIR = "build/dist"


def _timed(fn):
    """(fn(), seconds, peak device GiB) with the device synchronized."""
    import torch

    _reset_peak()
    _sync(_DEV)
    t0 = time.perf_counter()
    out = fn()
    _sync(_DEV)
    return out, time.perf_counter() - t0, _peak()


def _counted(fn):
    """(fn(), seconds, peak GiB, launches of every kernel in fn())."""
    _zero_counts()
    out, secs, peak = _timed(fn)
    return out, secs, peak, _all_counts()


def _dist_seq(mesh):
    """The seq path on ``mesh``'s "data" axis: (outputs, figures)."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.pod_scale import pod_lgssm, pod_scale_data
    from gpar_at_scale_torch.parallel.seqshard import (
        make_sharded_decorrelate,
        make_sharded_logpdf,
        make_sharded_smooth,
    )

    t_np, Y_np = pod_scale_data(DIST_N, DIST_COLS)
    t = torch.as_tensor(t_np, device=_DEV)
    Y = torch.as_tensor(Y_np).to(_DEV, torch.float32)
    p0 = torch.tensor([math.log(0.5), 0.0, math.log(0.1)], dtype=torch.float64, device=_DEV)

    def grad():
        p = p0.clone().requires_grad_(True)
        ll = make_sharded_logpdf(mesh)(pod_lgssm(t, p), Y[:, 0])
        return ll.detach(), torch.autograd.grad(ll, p)[0]

    def run():
        with torch.no_grad():
            lg = pod_lgssm(t, p0)
            dec = make_sharded_decorrelate(mesh)(lg, Y)
            sm = make_sharded_smooth(mesh)(lg, Y[:, 0])
        return dec, sm, grad()

    (dec, sm, (ll, g)), secs, peak, launches = _counted(run)
    _, dec_s, dec_peak = _timed(lambda: make_sharded_decorrelate(mesh)(pod_lgssm(t, p0), Y))
    out = dict(ll=dec[0].double().cpu(), alpha=dec[1].cpu(), mean=sm.mean.cpu(), var=sm.var.cpu(),
               lp=float(ll), grad=g.cpu().numpy())
    figs = dict(secs=secs, peak=peak, dec_secs=dec_s, dec_peak=dec_peak, launches=launches,
                points_per_s=DIST_N * DIST_COLS / dec_s)
    del dec, sm
    return out, figs


def _dist_model_data():
    import torch

    from gpar_at_scale_torch.benchmarks.million_dtc import million_dtc_data
    from gpar_at_scale_torch.utils.params import pack_gpar

    t_np, X_np, y_np = million_dtc_data(DIST_N, MIXED_N_STAR, 0)
    t = torch.as_tensor(t_np, device=_DEV)
    X, y = torch.as_tensor(X_np).to(_DEV, torch.float32), torch.as_tensor(y_np).to(_DEV, torch.float32)
    Z = X[:: max(1, DIST_N // DIST_M_MODEL)][:DIST_M_MODEL]
    p0 = pack_gpar(*(torch.tensor(v, dtype=torch.float64) for v in MIXED_START)).to(_DEV, torch.float32)
    return t, X, y, Z, p0


def _dist_model(mesh):
    """The model path on ``mesh``'s "model" axis: nlml and its gradient."""
    import torch

    from gpar_at_scale_torch.parallel.modelshard import make_modelsharded_nlml, place_modelsharded

    t, X, y, Z, p0 = _dist_model_data()

    def run():
        p = p0.clone().requires_grad_(True)
        v = make_modelsharded_nlml(mesh)(p, t, X, y, place_modelsharded(mesh, Z))
        return float(v.detach()), torch.autograd.grad(v, p)[0].double().cpu().numpy()

    (value, g), secs, peak, launches = _counted(run)
    return dict(value=value, grad=g), dict(secs=secs, peak=peak, launches=launches)


def _dist_chain(mesh, data):
    """The chain path: DIST_STEPS steps of make_sharded_train_step."""
    import torch

    from gpar_at_scale_torch.parallel.sharded import make_sharded_train_step

    init, step, place = make_sharded_train_step(mesh, learning_rate=DIST_LR)
    p, *placed = place(*(data[k].to(_DEV) for k in ("chain_p", "chain_t", "chain_X", "chain_y",
                                                     "chain_Z")))

    def run():
        state, losses = init(p), []
        for _ in range(DIST_STEPS):
            state, loss = step(state, *placed)
            losses.append(loss.double().cpu())
        return torch.stack(losses)

    losses, secs, peak, launches = _counted(run)
    return losses, dict(secs=secs, peak=peak, launches=launches)


def _dist_fit(mesh):
    """The fit path: fit_gpar(mesh=) on the EEG chain under "on"; the
    float64 objective at each conditional's end point."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.eeg import TRAIN_POINTS, generate_synthetic_eeg
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar
    from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

    ds = generate_synthetic_eeg(seed=0)
    n = TRAIN_POINTS
    order = [ds.channels.index(c) for c in EEG_OBSERVED + EEG_PREDICTED]
    f32 = torch.float32
    as_dev = lambda a: torch.as_tensor(np.asarray(a)).to(_DEV, f32)  # noqa: E731
    cfg = GPARConfig(backend="scaled", num_pseudo_points=n, max_opt_steps=EEG_STEPS, dtype=f32)
    starts = [_tensor_params(EEG_GP_START, pack_gp, _DEV, f32)] + [
        _tensor_params(EEG_COND_START, pack_gpar, _DEV, f32)] * (len(order) - 1)
    _set_dense_mode("on")
    try:
        model, secs, peak, launches = _counted(lambda: fit_gpar(
            None, as_dev(ds.t[:n]), as_dev(ds.Y[:n, order]), cfg, init_params=starts, mesh=mesh,
            device=_DEV))
    finally:
        _set_dense_mode("off")
    return [_nll64(c) for c in model.conditionals], dict(secs=secs, peak=peak, launches=launches)


def dist_rank(path):
    """[dist] on one rank of the gloo group: every path over DIST_RANKS
    ranks, compared with the references in ``path``.  Returns numbers."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.parallel import make_mesh

    ref = torch.load(path, weights_only=True)
    out = {}
    seq, figs = _dist_seq(make_mesh(("data",)))
    out["seq"] = dict(figs, alpha_rel=float((seq["alpha"] - ref["alpha"]).abs().max()
                                            / ref["alpha"].abs().max()),
                      ll_gap=float((seq["ll"] - ref["ll"]).abs().max() / DIST_N),
                      mean_sd=float(((seq["mean"].double() - ref["mean"].double())
                                     / ref["var"].double().sqrt()).abs().max()),
                      sd_rel=float(((seq["var"].double().sqrt() - ref["var"].double().sqrt())
                                    / ref["var"].double().sqrt()).abs().max()),
                      lp_gap=abs(seq["lp"] - float(ref["lp"])) / DIST_N, grad=seq["grad"])
    model, figs = _dist_model(make_mesh(("model",)))
    out["model"] = dict(figs, value=model["value"], grad=model["grad"])
    for name, sizes in (("chain21", (DIST_RANKS, 1)), ("chain12", (1, DIST_RANKS))):
        losses, figs = _dist_chain(make_mesh(("chain", "data"), sizes), ref)
        out[name] = dict(figs, gap=float(((losses - ref["chain_losses"]) / DIST_N).abs().max()),
                         equal=bool(torch.equal(losses, ref["chain_losses"])))
    ends, figs = _dist_fit(make_mesh(("chain", "data"), (DIST_RANKS, 1)))
    out["fit"] = dict(figs, ends=np.asarray(ends))
    return out


def _dist_line(tag, figs):
    return (f"{figs['secs']:.3f} s, peak device memory {figs['peak']:.2f} GiB; launches "
            + ", ".join(f"{k.split()[0]} {v}" for k, v in figs["launches"].items() if v))


def dist_phase(t_np, Y_np, params, par_ends, failures):
    """[dist] on the card: every path over NCCL with one rank in this
    process (the references and the unsharded figures), then over gloo with
    DIST_RANKS spawned ranks on the same card (the kernels are built
    already: the ranks load them).  Returns the launches per path, summed
    over the gloo ranks."""
    import os
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from gpar_at_scale_torch.models.gpar import _select_pseudo_points
    from gpar_at_scale_torch.parallel import initialize_distributed, make_mesh
    from gpar_at_scale_torch.parallel.launch import run_ranks

    shutil.rmtree(_DIST_DIR, ignore_errors=True)
    os.makedirs(_DIST_DIR)
    t0 = time.perf_counter()
    initialize_distributed(f"file://{os.path.abspath(_DIST_DIR)}/nccl_store", 1, 0, backend="nccl")
    try:
        seq, seq_figs = _dist_seq(make_mesh(("data",)))
        model, model_figs = _dist_model(make_mesh(("model",)))
        rng = np.random.default_rng(7)
        X = torch.as_tensor(Y_np[:, :1], dtype=torch.float32)
        data = dict(chain_t=torch.as_tensor(t_np), chain_X=X,
                    chain_y=torch.as_tensor(Y_np[:, 1], dtype=torch.float32),
                    chain_Z=_select_pseudo_points(X, M),
                    chain_p=(params[1].double().cpu()[None]
                             + 0.05 * torch.as_tensor(rng.normal(size=(DIST_CHAINS, 5)))).float())
        losses, chain_figs = _dist_chain(make_mesh(("chain", "data"), (1, 1)), data)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    _log(f"[dist] NCCL, 1 rank ({backend}; the unsharded engines): seq (decorrelate {DIST_COLS} "
         f"columns, smoother, logpdf gradient at N={DIST_N:,}) {_dist_line('seq', seq_figs)}; "
         f"decorrelate alone {seq_figs['dec_secs']:.4f} s ({seq_figs['points_per_s']:.4e} points/s) "
         f"at {seq_figs['dec_peak']:.2f} GiB")
    _log(f"[dist] NCCL, 1 rank: model (nlml and gradient, N={DIST_N:,}, M={DIST_M_MODEL}) "
         f"{_dist_line('model', model_figs)}; nll/N {model['value'] / DIST_N:.10f}")
    _log(f"[dist] NCCL, 1 rank: chain ({DIST_CHAINS} chains x {DIST_STEPS} Adam steps, N={DIST_N:,}, "
         f"M={M}) {_dist_line('chain', chain_figs)}")
    path = os.path.join(_DIST_DIR, "references.pt")
    torch.save(dict(alpha=seq["alpha"], ll=seq["ll"], mean=seq["mean"], var=seq["var"],
                    lp=torch.tensor(seq["lp"]), chain_losses=losses, **data), path)
    ranks = run_ranks(dist_rank, DIST_RANKS, path, init_file=os.path.abspath(f"{_DIST_DIR}/gloo_store"),
                      backend="gloo", timeout=900.0)
    _log(f"[dist] gloo, {DIST_RANKS} ranks on one card: spawned, ran and joined in "
         f"{time.perf_counter() - t0:.1f} s since the phase began")
    paths = {}
    for r, res in enumerate(ranks):
        s = res["seq"]
        ok_seq = (s["alpha_rel"] <= TOL["K2"] and s["ll_gap"] <= FULL_TRACE_ATOL
                  and s["mean_sd"] <= SEG_SMOOTH_SD and s["sd_rel"] <= SEG_SMOOTH_SD
                  and s["lp_gap"] <= FULL_TRACE_ATOL)
        ok_g, gap = _grad_gap(s["grad"], seq["grad"], DIST_N)
        _log(f"[dist] gloo rank {r}: seq {_dist_line('seq', s)}; decorrelate alone {s['dec_secs']:.4f} s "
             f"({s['points_per_s']:.4e} points/s) at {s['dec_peak']:.2f} GiB; vs the unsharded: "
             f"alpha {s['alpha_rel']:.2e} of max |alpha| (<= {TOL['K2']}), |ll| / N {s['ll_gap']:.2e}, "
             f"smoothed mean {s['mean_sd']:.2e} sd, sd {s['sd_rel']:.2e} (<= {SEG_SMOOTH_SD}), "
             f"|logpdf| / N {s['lp_gap']:.2e} (<= {FULL_TRACE_ATOL}); gradient {gap} "
             f"{'ok' if ok_seq and ok_g else 'FAIL'}")
        if not (ok_seq and ok_g):
            failures.append(f"[dist] rank {r}: the sequence-sharded engines disagree")
        m = res["model"]
        ok_v = abs(m["value"] - model["value"]) / DIST_N <= FULL_TRACE_ATOL
        ok_g, gap = _grad_gap(m["grad"], model["grad"], DIST_N)
        _log(f"[dist] gloo rank {r}: model {_dist_line('model', m)}; nll/N {m['value'] / DIST_N:.10f} "
             f"(unsharded {model['value'] / DIST_N:.10f}); gradient {gap} "
             f"{'ok' if ok_v and ok_g else 'FAIL'}")
        if not (ok_v and ok_g):
            failures.append(f"[dist] rank {r}: the model-sharded objective disagrees")
        for name in ("chain21", "chain12"):
            c = res[name]
            ok_ = c["gap"] <= FULL_TRACE_ATOL
            _log(f"[dist] gloo rank {r}: chain on (chain {name[5]}, data {name[6]}) "
                 f"{_dist_line(name, c)}; max |loss - unsharded| / N over chains and steps "
                 f"{c['gap']:.2e} (<= {FULL_TRACE_ATOL}), equal bit for bit {c['equal']} "
                 f"{'ok' if ok_ else 'FAIL'}")
            if not ok_:
                failures.append(f"[dist] rank {r}: the sharded train step on {name} disagrees")
        f = res["fit"]
        want = np.asarray(par_ends)
        rel = np.abs(f["ends"] - want) / np.abs(want)
        ok_ = bool(np.isfinite(f["ends"]).all() and rel.max() <= DIST_FIT_RTOL)
        _log(f"[dist] gloo rank {r}: fit_gpar(mesh=) EEG {_dist_line('fit', f)}; float64 objective "
             f"at the six end points {np.round(f['ends'], 4).tolist()} ([parallel] "
             f"{np.round(want, 4).tolist()}), max rel gap {rel.max():.2e} (<= {DIST_FIT_RTOL}) "
             f"{'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"[dist] rank {r}: fit_gpar(mesh=) disagrees with the unsharded fit")
        for name in ("seq", "model", "chain21", "chain12", "fit"):
            acc = paths.setdefault(name, {})
            for k, v in res[name]["launches"].items():
                acc[k] = acc.get(k, 0) + v
    scan = [k.name for k in _scan_kernels()]
    # the time-sharded paths' backward is the tensor code's (parallel/seqshard.py)
    need = {"seq": scan[:2] + scan[3:5], "model": scan, "chain12": scan[:2] + scan[3:5],
            "fit": [k.name for k in _dense()]}
    for name, kernels in need.items():
        if not all(paths[name][k] > 0 for k in kernels):
            failures.append(f"[dist] {name}: a kernel of the path did not launch: {paths[name]}")
    _log(f"[dist] launches over the {DIST_RANKS} gloo ranks: "
         + "; ".join(f"{name} {c}" for name, c in paths.items()))
    return paths


# [aux]: the run-support modules on the card.  run_with_checkpointing on
# AUX_STEPS Adam steps (1e-2) of the chain's second output (the conditional
# of chain_scale.py, N = 10^6, M = 32, float32 on the kernels), a checkpoint
# every AUX_EVERY steps: stopped after AUX_EVERY steps, resumed to
# AUX_STEPS, against an uninterrupted run (bit for bit: the kernels and the
# float64 Gram are deterministic); stage_timer around a K3 sweep queued
# behind three float32 products of AUX_MAT x AUX_MAT, whose seconds must
# cover the block's device time (CUDA events), itself longer than the
# host's time to enqueue it (so a timer that did not wait would fail);
# load_eeg_csv on a CSV of the synthetic EEG set with a text time column and
# one empty cell.  profiler_trace's check runs at the start (trace_check).
AUX_STEPS, AUX_EVERY, AUX_MAT = 10, 5, 8192
_AUX_DIR = "build/aux"


def trace_check(failures):
    """[aux] profiler_trace around one K3 sweep at N = 10^6 (33 columns):
    the Chrome trace must hold its device kernels.  It runs first, before
    any other profiler session: in a long process torch.profiler drops
    device kernel records once earlier sessions have traced a few hundred
    thousand launches (on an H100: 3 of the sweep's 4 kernels after 10^5,
    none after 4 x 10^5; tools/profiler_drop.py), and by [aux] the run has
    traced more."""
    import json
    import os
    import re
    import shutil

    import torch

    from gpar_at_scale_torch.benchmarks.pod_scale import pod_lgssm
    from gpar_at_scale_torch.ops.grad import gain_pass
    from gpar_at_scale_torch.ops.whiten import whiten_sweep
    from gpar_at_scale_torch.utils import profiler_trace

    n = 1_000_000
    t = torch.linspace(0.0, n / 1000.0, n, dtype=torch.float64, device=_DEV)
    lg = pod_lgssm(t, torch.tensor([math.log(0.5), 0.0, math.log(0.1)], dtype=torch.float64,
                                    device=_DEV))
    rows = gain_pass(lg.A, lg.Q, lg.R.expand(n).contiguous())[0]
    U = torch.randn((n, M + 1), generator=torch.Generator(device=_DEV).manual_seed(0),
                    device=_DEV)
    trace_dir = os.path.join("build", "trace_check")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profiler_trace(trace_dir):
        whiten_sweep(rows, U, 3)
        _sync(_DEV)
    path = os.path.join(trace_dir, "trace.json")
    events = json.load(open(path))["traceEvents"] if os.path.exists(path) else []
    kernels = sorted({k for e in events if e.get("cat") == "kernel"
                      for k in re.findall(r"\w+_kernel", e.get("name", ""))})
    ok_ = "sweep_kernel" in kernels
    _log(f"[aux] profiler_trace around a K3 sweep: {path}, {len(events)} events, device kernels "
         f"{kernels} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[aux] profiler_trace wrote no trace of the kernel")


def aux_phase(t_np, Y_np, params, failures):
    """[aux] on the card.  Returns the launches of the checkpointed run."""
    import os
    import shutil

    import numpy as np
    import torch

    from gpar_at_scale_torch.benchmarks.pod_scale import pod_lgssm
    from gpar_at_scale_torch.data.eeg import generate_synthetic_eeg, load_eeg_csv
    from gpar_at_scale_torch.inference.optimize import adam_init, adam_update
    from gpar_at_scale_torch.models.gpar import _select_pseudo_points
    from gpar_at_scale_torch.ops.grad import gain_pass
    from gpar_at_scale_torch.ops.whiten import whiten_sweep
    from gpar_at_scale_torch.parallel.sharded import make_dtc_nlml
    from gpar_at_scale_torch.utils import MetricsLogger, run_with_checkpointing, stage_timer

    shutil.rmtree(_AUX_DIR, ignore_errors=True)
    os.makedirs(_AUX_DIR)
    f32 = torch.float32
    t = torch.as_tensor(t_np, device=_DEV)
    X = torch.as_tensor(Y_np[:, :1]).to(_DEV, f32)
    y = torch.as_tensor(Y_np[:, 1]).to(_DEV, f32)
    Z = _select_pseudo_points(X, M)
    nlml = make_dtc_nlml()

    def step_fn(state, i):
        p = state["p"].detach().requires_grad_(True)
        loss = nlml(p, t, X, y, Z)
        (g,) = torch.autograd.grad(loss, p)
        p, opt = adam_update(g, state["opt"], state["p"], DIST_LR)
        return {"p": p, "opt": opt, "loss": state["loss"].index_fill(0, torch.tensor(i, device=_DEV),
                                                                         loss.detach().double())}

    init = {"p": params[1].clone(), "opt": adam_init(params[1]),
            "loss": torch.zeros(AUX_STEPS, dtype=torch.float64, device=_DEV)}
    _zero_counts()
    ck = os.path.join(_AUX_DIR, "ckpt")
    (first, ran1), s1, _ = _timed(lambda: run_with_checkpointing(step_fn, init, AUX_EVERY, ck,
                                                                 checkpoint_every=AUX_EVERY))
    (resumed, ran2), s2, _ = _timed(lambda: run_with_checkpointing(step_fn, init, AUX_STEPS, ck,
                                                                   checkpoint_every=AUX_EVERY))
    launches = _all_counts()
    whole, _ = run_with_checkpointing(step_fn, init, AUX_STEPS)
    same = all(torch.equal(a, b) for a, b in zip(
        (resumed["p"], resumed["opt"].mu, resumed["opt"].nu, resumed["loss"]),
        (whole["p"], whole["opt"].mu, whole["opt"].nu, whole["loss"])))
    ok_ = same and (ran1, ran2) == (AUX_EVERY, AUX_STEPS - AUX_EVERY) and int(resumed["opt"].count) == AUX_STEPS
    trace = (resumed["loss"] / DIST_N).cpu().numpy()
    _log(f"[aux] run_with_checkpointing: {ran1} Adam steps in {s1:.3f} s, stopped, resumed from "
         f"step {AUX_EVERY} for {ran2} more in {s2:.3f} s; nll/N {np.round(trace, 6).tolist()}; "
         f"equal bit for bit to an uninterrupted run of {AUX_STEPS}: {same} {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[aux] the resumed run differs from the uninterrupted one")

    n = t.shape[0]
    lg = pod_lgssm(t, torch.tensor([math.log(0.5), 0.0, math.log(0.1)], dtype=torch.float64,
                                    device=_DEV))
    rows = gain_pass(lg.A, lg.Q, lg.R.expand(n).contiguous())[0]
    U = torch.cat([y[:, None], X.expand(n, M)], dim=1).contiguous()
    sweep = lambda: whiten_sweep(rows, U, 3)  # noqa: E731
    # the device queue ahead of the sweep (float32 products of AUX_MAT^3,
    # tens of ms) makes the device, not the host's launches, set the time
    big = torch.ones((AUX_MAT, AUX_MAT), dtype=f32, device=_DEV) / AUX_MAT

    def block():
        for _ in range(3):
            big @ big
        return sweep()

    event_ms = _time_ms(block, 1)
    _sync(_DEV)
    t0 = time.perf_counter()
    block()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    _sync(_DEV)
    log = MetricsLogger(path=os.path.join(_AUX_DIR, "metrics.jsonl"))
    with stage_timer("K3 sweep", logger=log) as h:
        h["sync"] = block()
    log.close()
    ok_ = h["seconds"] * 1e3 >= 0.9 * event_ms > enqueue_ms and log.records[0]["name"] == "K3 sweep"
    _log(f"[aux] stage_timer around a K3 sweep ({M + 1} columns, N={n:,}) behind 3 products of "
         f"{AUX_MAT}^2: {h['seconds'] * 1e3:.3f} ms against {event_ms:.3f} ms of CUDA events and "
         f"{enqueue_ms:.3f} ms to enqueue it {'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[aux] stage_timer did not count the device work")

    ds = generate_synthetic_eeg(seed=0)
    csv = os.path.join(_AUX_DIR, "eeg.csv")
    with open(csv, "w") as fh:
        fh.write("time," + ",".join(ds.channels) + "\n")
        for i, row in enumerate(ds.Y):
            cells = [repr(float(v)) for v in row]
            if i == 10:
                cells[5] = ""  # F1 missing at one time point
            fh.write(f"0:00:{i:03d}," + ",".join(cells) + "\n")
    loaded = load_eeg_csv(csv)
    nan = np.isnan(loaded.Y)
    ok_ = (loaded.Y.shape == ds.Y.shape and nan.sum() == 1 and nan[10, 5]
           and np.array_equal(loaded.Y[~nan], ds.Y[~nan]))
    _log(f"[aux] load_eeg_csv on the synthetic EEG set with a text time column and an empty F1 "
         f"cell: shape {loaded.Y.shape}, NaN at {np.argwhere(nan).tolist()}, the rest exact "
         f"{'ok' if ok_ else 'FAIL'}")
    if not ok_:
        failures.append("[aux] load_eeg_csv did not read the CSV with NaN in its empty cell")
    return launches


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
    from gpar_at_scale_torch.data.eeg import generate_synthetic_eeg
    from gpar_at_scale_torch.models import GPARConfig
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

    # [aux]'s trace check, before any other profiler session
    trace_check(failures)
    # 2. kernels against their plain versions
    records = check_kernels(t, Y, params, M, failures)
    check_column_elements(t, Y, t_star, params, records, failures)
    check_kernel_edges(failures)
    records.update(check_dense_kernels(generate_synthetic_eeg(seed=0), failures))

    # 3. serving: condition the chain on the seeded parameters, answer 3 requests
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M,
                     dtype=f32, max_opt_steps=0)
    scan = _scan_kernels()
    for k in scan:
        k.launches = 0
    cond_launches = {}
    model, cond_s, lat, (mu, var) = run_chain(
        t, Y, t_star, params, cfg, requests=3,
        after_fit=lambda: cond_launches.update({k.name: k.launches for k in scan}),
    )
    launches = {k.name: k.launches for k in scan}
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
    for k in scan[:3]:  # K4a-K5b are not on the serving path
        if launches[k.name] == 0:
            failures.append(f"{k.name} was not launched on the serving path")
    # where the time goes: one more conditioning and one more request, traced
    from gpar_at_scale_torch.models import fit_gpar

    profile_phase("conditioning", lambda: fit_gpar(None, t, Y, cfg, init_params=params))
    profile_phase("request", lambda: model.predict(t_star))
    # the Monte-Carlo predictive of the served chain's last conditional
    mc_check(model, t_star, mu, args.seed, failures)
    del model

    # 4. reference on a small input
    reference_check(args.seed, failures)

    # 5. gradients on a small input
    grad_check(args.seed, failures)

    # 6. the main path: train the chain, answer 3 requests; one step traced
    model, train_launches, train_s = train_chain(t, Y, t_star, lat_star, sn, params, failures)
    traced_train_step(model, failures)
    # 7. the start of the training run again at full N, in float64
    full_n_check(model, params, failures)
    # 10. the parallel fit of the chain beside phase 6's sequential one
    par_launches = parallel_chain(t, Y, params, model, train_s, failures)
    del model

    # 8. the dense path's main path: the EEG example through K6a-c
    eeg_launches, seq_ends, eeg_smse_fz = eeg_phase(failures)
    # 10. the EEG chain's conditionals fitted in parallel under "on" and "off"
    par_ends = []
    eeg_par_launches = eeg_parallel(seq_ends, failures, par_ends)
    for key, a, b in zip(("K6a", "K6b", "K6c"), eeg_launches, eeg_par_launches):
        records[key]["launches"] = a
        records[key]["launches_by_path"] = {"eeg": a, "parallel": b}
    # 9. bench.py's pipeline under "on" and "off", with batched serving
    batched = eeg_bench(failures)
    # the repo's drivers on the port
    script_launches, mfu_rows = scripts_phase(failures)
    # 11. the reference-named api on the big toy dataset
    api_launches = api_phase(args.seed, failures)
    for key, k in zip(("K1", "K2", "K3", "K4a", "K4b", "K5a", "K5b"), scan):
        records[key]["launches"] = train_launches[k.name]
        records[key]["launches_by_path"] = {path: counts[k.name] for path, counts in (
            ("train", train_launches), ("parallel", par_launches), ("api", api_launches))}
    # 13-16. posterior draws and the samplers, each through its entry point
    new_paths = (
        ("ffbs", ffbs_phase(args.seed, failures)),
        ("smc", smc_phase(args.seed, failures)),
        ("nuts", nuts_phase(args.seed, eeg_smse_fz, failures)),
        ("nuts-smc", nuts_smc_phase(args.seed, failures)),
        ("segmented", segmented_phase(args.seed, failures)),
        ("mixed-bwd", mixed_bwd_phase(args.seed, failures)),
    )
    # the parallel layer and the run-support modules
    dist = dist_phase(t_np, Y_np, params, par_ends, failures)
    chain = {k: dist["chain21"][k] + dist["chain12"][k] for k in dist["chain21"]}
    new_paths += (("dist-seq", dist["seq"]), ("dist-model", dist["model"]), ("dist-chain", chain),
                  ("dist-fit", dist["fit"]), ("aux", aux_phase(t_np, Y_np, params, failures)),
                  ("scripts", script_launches))
    from gpar_at_scale_torch.ops import KERNELS

    records["K7"]["launches_by_path"] = {}  # the batched long-series request, below
    for k in KERNELS:
        records[k.name.split()[0]]["launches_by_path"].update(
            {path: c[k.name] for path, c in new_paths})
    _log("[kernels] launches on the paths: training " + str(train_launches) + "; parallel fit "
         + str(par_launches) + "; api " + str(api_launches) + "; EEG 'on' K6a/K6b/K6c "
         + f"{eeg_launches}, in parallel {eeg_par_launches}; "
         + "; ".join(f"{path} {c}" for path, c in new_paths))
    # the batched long-series predictive, on an emptied cache: about 60 GiB
    torch.cuda.empty_cache()
    bscan = batch_scan_phase(args.seed, failures)
    _log(f"[kernels] launches of the batched long-series request: {bscan}")
    k7 = bscan["K7 smoothing_elements"]
    records["K7"]["launches"] = records["K7"]["launches_by_path"]["batch-scan"] = k7
    # 12. the associative-scan engine, last: its autograd takes the most memory
    torch.cuda.empty_cache()
    assoc_phase(t, Y, params, failures)

    keys = ("K1", "K2", "K3", "K4a", "K4b", "K5a", "K5b", "K6a", "K6b", "K6c", "K7")
    print(json.dumps({"kernels": [records[k] for k in keys]}), flush=True)
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
