"""Chain-parallel NUTS samples/s over ranks, and (``--weak``) time-sharded
whitening at a fixed number of steps per rank.

Port of ``benchmarks/scaling.py``.

  strong (:130-157) -- NUTS on the DTC logpost of the toy small dataset's
      second output given its first (``data/toy.py::generate_small_dataset``
      seed 0, Z every third input, float32), D x ``--chains-per-device``
      chains in lockstep (200 + 150 draws, max depth 6), split over D
      ranks; samples/s and its share of D times one rank's;
  ``--weak`` (:47-117) -- ``parallel/seqshard.py::make_sharded_decorrelate``
      over the "data" axis at N = ``--n-per-device`` x D (long_series'
      series, numpy seed 0; Matern-5/2 (1, 1), noise 0.09, float32), the
      mean of 5 calls after one, beside the bytes each rank receives per
      call and its arithmetic.

    python -m gpar_at_scale_torch.benchmarks.scaling [--ranks=D]
        [--chains-per-device=8] [--samples=200] [--warmup=150]
        [--weak [--n-per-device=65536]] [--cpu]

Rank counts run D = 1, 2, 4, ... up to ``--ranks`` (the script's: every
device of the host).  One rank runs in this process (NCCL on a card),
more are spawned by ``parallel/launch.py::run_world`` (gloo when they
share one card, with its collectives of CUDA tensors staged through the
host).  On one card only the mechanism can be shown: D = 2 ranks share
the card and its host, so no scaling claim follows from this machine.

The communication line is the port's, not the script's: the script
reckons an all_gather of block totals, a ppermute and a psum (:100-111);
the port's decorrelate sends one all-gather of the rank totals
(``seqshard.py::_gather_totals``: (A, C, J) d x d and (b, eta) d x B per
rank, float64), one all-reduce of the ll (B float64), and then gathers the
whitened columns to full length (each rank receives every span's rows,
float32), which grows with N.  Its arithmetic per rank is K1's and K2's per
step, counted from ``csrc/kalman_scan.cu``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import device_from_argv, int_arg, synchronize
from gpar_at_scale_torch.ops import launch_counts
from gpar_at_scale_torch.parallel.launch import rank_device

MAX_DEPTH = 6


def rank_sizes(ranks):
    return [d for d in (1, 2, 4, 8, 16, 32) if d <= ranks]


def toy_logpost(device, dtype=torch.float32):
    """The script's target: the DTC logpost of output 2 given output 1 on
    the small toy dataset, Z = every third input; takes a (C, 5) batch."""
    from gpar_at_scale_torch.data.toy import generate_small_dataset
    from gpar_at_scale_torch.models.bayes import make_conditional_logpost

    ds = generate_small_dataset(seed=0)
    V = ds.y_obs[:, :1]
    return make_conditional_logpost(ds.x, V, ds.y_obs[:, 1], likelihood="dtc", Z=V[::3],
                                    dtype=dtype, device=device)


def _since(before):
    return {k: c - before[k] for k, c in launch_counts().items()}


def strong_rank(cfg):
    """NUTS on this rank's chains (a module-level function for
    ``run_world``): (seconds, the rank's draws (c, S, 5) numpy, its kernel
    launches)."""
    import torch.distributed as dist

    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.inference.nuts import nuts

    device = rank_device(cfg["device"])
    rank, D = dist.get_rank(), dist.get_world_size()
    cpd = cfg["chains_per_device"]
    x0s = 0.3 * torch.randn((cpd * D, 5), generator=torch.Generator().manual_seed(1),
                            dtype=torch.float32)
    logpost = toy_logpost(device)
    gen = torch.Generator(device=device).manual_seed(rank)
    before = launch_counts()
    synchronize(device)
    t0 = time.perf_counter()
    res = nuts(gen, value_and_grad(logpost), x0s[rank * cpd:(rank + 1) * cpd].to(device),
               num_samples=cfg["samples"], num_warmup=cfg["warmup"], max_depth=MAX_DEPTH)
    synchronize(device)
    return (time.perf_counter() - t0, res.samples.double().cpu().numpy(),
            _since(before))


def weak_series(N, device):
    """(t float64, y float32, float32 LGSSM) of long_series' series at N."""
    from gpar_at_scale_torch.benchmarks.long_series import NOISE, kernel, series
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    t_np, y_np = series(N)
    t = torch.as_tensor(t_np, device=device)
    return t, torch.as_tensor(y_np).to(device, torch.float32), lgssm_of(kernel(device), t, NOISE,
                                                                      torch.float32)


def weak_rank(cfg):
    """The time-sharded decorrelate at N = n_per_device x D on this rank (a
    module-level function for ``run_world``): (mean seconds of ``reps``
    calls, ll, the rank's kernel launches)."""
    import torch.distributed as dist

    from gpar_at_scale_torch.parallel import make_mesh
    from gpar_at_scale_torch.parallel.seqshard import make_sharded_decorrelate

    device = rank_device(cfg["device"])
    N = cfg["n_per_device"] * dist.get_world_size()
    _, y, lg = weak_series(N, device)
    before = launch_counts()
    dec = make_sharded_decorrelate(make_mesh(("data",)), "data")
    with torch.no_grad():
        ll = float(dec(lg, y)[0])  # the first call loads the kernels
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(cfg["reps"]):
            ll = float(dec(lg, y)[0])
        synchronize(device)
    return (time.perf_counter() - t0) / cfg["reps"], ll, _since(before)


def _summed(res):
    return {k: sum(r[-1][k] for r in res) for k in res[0][-1]}


def comm_bytes(D, N, d=3, B=1):
    """(carries, outputs): the bytes one rank receives per decorrelate call
    over D ranks: the all-gather of D rank totals (3 d^2 + 2 d B float64
    each) and the all-reduce of the ll (B float64); the whitened columns
    gathered to full length (D spans of the longest span's rows, B float32
    each).  0 on one rank."""
    if D == 1:
        return 0, 0
    return D * (3 * d * d + 2 * d * B) * 8 + B * 8, D * (-(-N // D)) * B * 4


def flops_per_rank(D, N, d=3):
    """K1's and K2's arithmetic per step (``csrc/kalman_scan.cu``: d x d
    products 2 d^3, matrix-vector 2 d^2) over one rank's span."""
    k1 = 4 * d**3 + 4 * d * d + d * (d + 1) * (d + 2) + 3 + 6 * d
    k2 = 2 * d * d + 4 * d**3 + d * d + 2 * d * d + 4 * d * d + 4 * d + 12
    return (N // D) * (k1 + k2)


def strong(*, device, ranks=1, chains_per_device=8, samples=200, warmup=150):
    """samples/s at every D of ``rank_sizes(ranks)``; prints the script's
    lines.  Returns [(D, samples/s, seconds, draws (C, S, 5), kernel
    launches summed over the ranks)]."""
    from gpar_at_scale_torch.parallel.launch import run_world

    cfg = dict(device=torch.device(device).type, chains_per_device=chains_per_device,
               samples=samples, warmup=warmup)
    print(f"devices available: {ranks}; chains/device: {chains_per_device}")
    base, out = None, []
    for D in rank_sizes(ranks):
        res = run_world(strong_rank, D, cfg, name="scaling")
        el = max(r[0] for r in res)
        sps = chains_per_device * D * samples / el
        base = sps if base is None else base
        print(f"{D:3d} devices: {sps:10.1f} samples/s  ({el:.2f}s)  efficiency "
              f"{sps / (base * D) * 100:5.1f}%", flush=True)
        out.append((D, sps, el, np.concatenate([r[1] for r in res]), _summed(res)))
    return out


def weak(*, device, ranks=1, n_per_device=65536, reps=5):
    """The weak-scaling rows at every D of ``rank_sizes(ranks)``; prints the
    script's lines.  Returns [(D, N, seconds, ll of each rank, kernel
    launches summed over the ranks)]."""
    from gpar_at_scale_torch.parallel.launch import run_world

    cfg = dict(device=torch.device(device).type, n_per_device=n_per_device, reps=reps)
    sizes = rank_sizes(ranks)
    print(f"weak scaling: n_per_device={n_per_device}, devices {sizes}")
    base, out = None, []
    for D in sizes:
        N = n_per_device * D
        res = run_world(weak_rank, D, cfg, name="scaling")
        el = max(r[0] for r in res)
        base = el if base is None else base
        carries, rows = comm_bytes(D, N)
        flops = flops_per_rank(D, N)
        print(f"{D:3d} dev  N={N:>9,}  wall {el * 1e3:8.2f} ms  (x{el / base:4.2f} vs 1 dev)  "
              f"comm/call/dev {carries:6d} B carries + {rows} B whitened rows  "
              f"flops/dev ~{flops / 1e6:7.1f} MF  carries/flops {carries / flops:.2e} B/F",
              flush=True)
        out.append((D, N, el, [r[1] for r in res], _summed(res)))
    print("the carries are O(D d^2) bytes per call at any N: at a fixed number of steps per "
          "rank their share of the work falls with N; the whitened rows gathered to full "
          "length grow with N (the script keeps them sharded)")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    ranks = int_arg(argv, "ranks", 1)
    if "--weak" in argv:
        return weak(device=device, ranks=ranks, n_per_device=int_arg(argv, "n-per-device", 65536))
    return strong(device=device, ranks=ranks,
                  chains_per_device=int_arg(argv, "chains-per-device", 8),
                  samples=int_arg(argv, "samples", 200), warmup=int_arg(argv, "warmup", 150))


if __name__ == "__main__":
    main()
