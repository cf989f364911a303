"""Compute-bound stages of the workload: achieved FLOP/s against the card's
peak for the precision each runs in.

Port of ``benchmarks/mfu.py``:

  (a) the DTC Gram G = W^T W over the whitened column stack at N = 1e6,
      M = 256 (the O(N M^2) stage of every large-M DTC bound): float32 with
      TF32 off (the port's policy, ``device.py``), bf16, and float64, the
      precision the port forms its Gram in (``ssm/blocked_grad.py::
      whiten_gram``, ``gp/dtc.py::_scan_gram``), where the JAX mfu timed
      float32;
  (b) the dense whitening at ``DENSE_N_MAX`` = 2048 with a 2048-column
      right-hand side, float32: Cholesky plus triangular solve
      (``torch.linalg``; the hand-written K6a takes n <= 512);
  (c) a square bf16 matmul control, 4096^3.

    python -m gpar_at_scale_torch.benchmarks.mfu [--cpu] [--reps=50] [--small]

Every stage is cuBLAS or cuSOLVER: no Pallas kernel of the JAX package
computes them.  The bf16 rows are measurements only: no path of the port
computes in bf16.  Peaks (NVIDIA H100 SXM data sheet, dense): float32
without tensor cores 67 TFLOP/s, float64 on tensor cores 67 TFLOP/s, bf16
989 TFLOP/s.  Each row is the best of 3 runs of ``reps`` calls between two
synchronizations (CUDA events on the card), per call.  ``--small`` takes
the JAX script's CPU sizes (N = 20000, M = 64; 256 x 256; 512^3).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import device_from_argv, device_name, int_arg, synchronize

PEAK = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}


def time_per_call(fn, reps, device, trials=3):
    """Best over ``trials`` of the mean seconds per call of ``reps``
    calls, after one warm-up call."""
    fn()
    synchronize(device)
    best = float("inf")
    cuda = torch.device(device).type == "cuda"
    for _ in range(trials):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            secs = time.perf_counter() - t0
        best = min(best, secs / reps)
    return best


def report(name, flops, secs, precision):
    """Print one row and return it as a dict."""
    peak = PEAK[precision]
    gfs = flops / secs / 1e9
    pct = 100.0 * flops / secs / peak
    print(f"{name:<50s} {secs * 1e3:9.3f} ms/iter  {gfs:10.1f} GFLOP/s  "
          f"= {pct:6.2f}% of {peak / 1e12:.0f} TF peak ({precision})", flush=True)
    return dict(name=name, ms=secs * 1e3, gflops_per_s=gfs, pct_of_peak=pct, peak=peak,
                precision=precision, flops=flops)


def run(device, reps=50, small=False):
    """The rows of (a), (b) and (c) at the card's sizes (``small``: the
    CPU smoke sizes)."""
    rng = np.random.default_rng(0)
    rows = []

    # (a) the Gram at N = 1e6, M = 256
    N, M = (20_000, 64) if small else (1_000_000, 256)
    W = torch.as_tensor(rng.normal(size=(N, M + 1)), dtype=torch.float32).to(device)
    flops = 2.0 * N * (M + 1) ** 2
    for tag, dt, prec in (("f32, TF32 off", torch.float32, "f32"),
                          ("f64 (the port's Gram)", torch.float64, "f64"),
                          ("bf16", torch.bfloat16, "bf16")):
        Wd = W.to(dt)
        s = time_per_call(lambda Wd=Wd: Wd.T @ Wd, reps, device)
        rows.append(report(f"(a) Gram W^T W ({N:,} x {M + 1}) {tag}", flops, s, prec))
        del Wd
    del W

    # (b) dense whitening at DENSE_N_MAX with a wide right-hand side
    n_d, m_d = (256, 256) if small else (2048, 2048)
    t_d = np.sort(rng.uniform(0, 8, size=n_d))
    Sigma = np.exp(-0.5 * (t_d[:, None] - t_d[None, :]) ** 2 / 0.25) + 0.1 * np.eye(n_d)
    Sigma = torch.as_tensor(Sigma, dtype=torch.float32).to(device)
    B = torch.as_tensor(rng.normal(size=(n_d, m_d)), dtype=torch.float32).to(device)

    def whiten():
        L = torch.linalg.cholesky(Sigma)
        return torch.linalg.solve_triangular(L, B, upper=False)

    s = time_per_call(whiten, max(8, reps // 4), device)
    rows.append(report(f"(b) dense whiten chol+trisolve ({n_d} x {m_d}) f32",
                       n_d**3 / 3.0 + n_d**2 * m_d, s, "f32"))

    # (c) the bf16 square matmul control
    k = 512 if small else 4096
    A1 = torch.as_tensor(rng.normal(size=(k, k))).to(device, torch.bfloat16)
    A2 = torch.as_tensor(rng.normal(size=(k, k))).to(device, torch.bfloat16)
    s = time_per_call(lambda: A1 @ A2, reps, device)
    rows.append(report(f"(c) control bf16 matmul {k}^3", 2.0 * k**3, s, "bf16"))
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    reps = int_arg(argv, "reps", 50)
    print(f"device={device_name(device)}  reps={reps}", flush=True)
    return run(device, reps=reps, small="--small" in argv)


if __name__ == "__main__":
    main()
