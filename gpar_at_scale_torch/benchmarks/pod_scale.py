"""The pod configuration's two parallel axes, scaled down: chain-parallel
NUTS over the conditionals of a GPAR chain, and time-sharded whitening of a
long series.

Port of ``benchmarks/pod_scale.py``.

  A. (:51-92) for each conditional i = 1 .. P-1 of a P-output chain
     (n_train = 96 steps, the outputs a random walk over a sine, numpy
     seed 0), the DTC logpost over its 5 log-parameters
     (``models/bayes.py::make_conditional_logpost(likelihood="dtc")``, Z
     every n/32-th input, float32) sampled by C NUTS chains
     (``inference/nuts.py::nuts``, in lockstep, max depth 6), the chains
     split over the mesh's "chain" axis, each rank's draws all-gathered;
  B. (:95-119) one pass of ``parallel/seqshard.py::
     make_sharded_decorrelate`` over the "data" axis on an n-step series of
     8 columns (numpy seed 1; Matern-5/2, l = 0.5, sigma^2 = 1, noise 0.1,
     float32): per rank K1 and K2 per column on its span, the carries from
     one all-gather of rank totals.

    python -m gpar_at_scale_torch.benchmarks.pod_scale [--ranks=D]
        [--outputs=P] [--n=N] [--chains=C] [--samples=S] [--warmup=W]
        [--n-train=96] [--cpu]

Prints the script's two JSON lines (``pod_chain_nuts_samples_per_s``,
``pod_seq_whiten_points_per_s``).  Defaults as the script's on a chip
(16 outputs, 64 chains, 200 + 150 draws, N = 10^6) or, with ``--cpu``, on
the host (4 outputs, 2 D chains, 50 + 50, N = 10^5).  Ranks come from
``parallel/launch.py::run_world``: one rank runs here (NCCL on a card),
more are spawned (gloo when they share one card: its collectives of CUDA
tensors go through the host).  The script's mesh is every device of the
host; here ``--ranks`` sets it.  Its phase A times the first call, which
compiles; the port compiles nothing.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import device_from_argv, int_arg, synchronize

M_INDUCE, MAX_DEPTH, COLS = 32, 6, 8
SEQ_PARAMS = (math.log(0.5), 0.0, math.log(0.1))  # log l, log sigma^2, log noise


def chain_data(n_train, outputs):
    """Phase A's data: t (n,) sorted, Y (n, P), numpy float64."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.0, 4.0, size=n_train))
    Y = np.cumsum(rng.normal(size=(n_train, outputs)), axis=1) * 0.3 + np.sin(2.0 * t)[:, None]
    return t, Y


def pod_scale_data(n, cols):
    """Phase B's data: t (n,) float64, Y (n, cols)."""
    rng = np.random.default_rng(1)
    t = np.cumsum(rng.uniform(0.5, 1.5, size=n)) / n
    return t, rng.normal(size=(n, cols))


def pod_lgssm(t, p):
    """Phase B's float32 LGSSM at p = (log l, log sigma^2, log noise)."""
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    l, v, nv = torch.exp(p)
    return lgssm_of(Matern52(lengthscale=l, variance=v), t, nv, torch.float32)


def conditional_logposts(n_train, outputs, device, dtype=torch.float32):
    """[the DTC logpost of conditional i for i = 1 .. P-1] (each takes a
    (C, 5) batch), with their inducing inputs."""
    from gpar_at_scale_torch.models.bayes import make_conditional_logpost

    t, Y = chain_data(n_train, outputs)
    out = []
    for i in range(1, outputs):
        X_prev = Y[:, :i]
        Z = X_prev[:: max(1, n_train // M_INDUCE)][:M_INDUCE]
        out.append(make_conditional_logpost(t, X_prev, Y[:, i], likelihood="dtc", Z=Z,
                                            dtype=dtype, device=device))
    return out


def chain_phase(mesh, outputs, chains, n_train, samples, warmup, device, max_depth=MAX_DEPTH):
    """Phase A on this rank: (samples/s over the chain axis, seconds, the
    mean of every conditional's draws (all chains))."""
    from gpar_at_scale_torch.inference.hmc import value_and_grad
    from gpar_at_scale_torch.inference.nuts import nuts
    from gpar_at_scale_torch.parallel.distributed import all_gather_rows
    from gpar_at_scale_torch.parallel.mesh import axis_group, axis_rank, axis_size, spans

    size, rank = axis_size(mesh, "chain"), axis_rank(mesh, "chain")
    parts = spans(chains, size)
    s, ln = parts[rank]
    logposts = conditional_logposts(n_train, outputs, device)
    synchronize(device)
    t0 = time.perf_counter()
    means = []
    for i, logpost in enumerate(logposts, start=1):
        x0s = 0.3 * torch.randn((chains, 5), generator=torch.Generator().manual_seed(100 + i),
                                dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(1000 * i + rank)
        res = nuts(gen, value_and_grad(logpost), x0s[s:s + ln].to(device), num_samples=samples,
                   num_warmup=warmup, max_depth=max_depth)
        draws = all_gather_rows(res.samples.reshape(ln, -1).contiguous(), [p[1] for p in parts],
                                axis_group(mesh, "chain"))
        means.append(float(draws.double().mean()))
    synchronize(device)
    elapsed = time.perf_counter() - t0
    return chains * samples * len(logposts) / elapsed, elapsed, means


def sequence_phase(mesh, n_long, device, cols=COLS):
    """Phase B on this rank: (points/s, seconds of the timed pass, ll (cols,))."""
    from gpar_at_scale_torch.parallel.seqshard import make_sharded_decorrelate

    t_np, Y_np = pod_scale_data(n_long, cols)
    t = torch.as_tensor(t_np, device=device)
    Y = torch.as_tensor(Y_np).to(device, torch.float32)
    dec = make_sharded_decorrelate(mesh, "data")
    with torch.no_grad():
        lg = pod_lgssm(t, torch.tensor(SEQ_PARAMS, dtype=torch.float64, device=device))
        dec(lg, Y)  # the first call loads the kernels
        synchronize(device)
        t0 = time.perf_counter()
        ll, alpha = dec(lg, Y)
        synchronize(device)
        elapsed = time.perf_counter() - t0
    if not bool(torch.isfinite(alpha[-1]).all()):
        raise AssertionError("the whitened columns are not finite")
    return n_long * cols / elapsed, elapsed, ll.double().cpu().numpy()


def pod_rank(cfg):
    """Both phases on one rank of the world (a module-level function for
    ``run_world``): a dict of numbers, with the rank's kernel launches."""
    import torch.distributed as dist

    from gpar_at_scale_torch.ops import launch_counts
    from gpar_at_scale_torch.parallel import make_mesh
    from gpar_at_scale_torch.parallel.launch import rank_device

    before = launch_counts()
    device = rank_device(cfg["device"])
    out = dict(devices=dist.get_world_size())
    if "A" in cfg["phases"]:
        sps, el, means = chain_phase(make_mesh(("chain",)), cfg["outputs"], cfg["chains"],
                                     cfg["n_train"], cfg["samples"], cfg["warmup"], device)
        out.update(chain_sps=sps, chain_s=el, chain_means=means)
    if "B" in cfg["phases"]:
        pps, el, ll = sequence_phase(make_mesh(("data",)), cfg["n_long"], device)
        out.update(seq_pps=pps, seq_s=el, seq_ll=ll)
    out["launches"] = {k: c - before[k] for k, c in launch_counts().items()}
    return out


def run(*, device, ranks=1, outputs=16, chains=64, n_train=96, n_long=1_000_000, samples=200,
        warmup=150, phases="AB"):
    """The script's phases over ``ranks`` ranks; prints its JSON lines.
    Returns every rank's dict (``pod_rank``)."""
    from gpar_at_scale_torch.parallel.launch import run_world

    cfg = dict(device=torch.device(device).type, outputs=outputs, chains=chains, n_train=n_train,
               n_long=n_long, samples=samples, warmup=warmup, phases=phases)
    res = run_world(pod_rank, ranks, cfg, name="pod_scale")
    if "A" in phases:
        el = max(r["chain_s"] for r in res)
        print(json.dumps({"metric": "pod_chain_nuts_samples_per_s",
                          "value": round(chains * samples * (outputs - 1) / el, 1),
                          "unit": "samples/s", "outputs": outputs, "chains": chains,
                          "devices": ranks, "elapsed_s": round(el, 2)}), flush=True)
    if "B" in phases:
        el = max(r["seq_s"] for r in res)
        print(json.dumps({"metric": "pod_seq_whiten_points_per_s",
                          "value": round(n_long * COLS / el, 1), "unit": "points/s",
                          "n": n_long, "devices": ranks, "elapsed_s": round(el, 4)}), flush=True)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    cpu = device.type == "cpu"
    ranks = int_arg(argv, "ranks", 1)
    return run(device=device, ranks=ranks, outputs=int_arg(argv, "outputs", 4 if cpu else 16),
               chains=int_arg(argv, "chains", 2 * ranks if cpu else 64),
               n_train=int_arg(argv, "n-train", 96),
               n_long=int_arg(argv, "n", 100_000 if cpu else 1_000_000),
               samples=int_arg(argv, "samples", 50 if cpu else 200),
               warmup=int_arg(argv, "warmup", 50 if cpu else 150))


if __name__ == "__main__":
    main()
