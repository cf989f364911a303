"""Serving traffic: batched predictive requests against one cached q(u),
closed loop, one batch in flight.

Set-up makes the data on the device, draws the served log-parameters from
the seed around the configuration's ``params`` (``param_sd`` normal), has
the program compute q(u) there, draws ``draws_per_batch`` hyperparameter
sets around them (``draw_sd`` normal) and answers batch 0, which warms
every shape.  Each request is one ``gp/dtc.py::predict_scaled_batch`` of
the draws, moved by an offset of its own (``batch_offset_sd`` normal,
drawn from the seed when the batch is sent, so that no two batches are
equal), at the held-out times, timed from the call to the synchronize
after it; the next is sent when it returns.  ``obs_per_s`` is the
observations answered over the window's seconds; ``request_p95_ms`` the
95th percentile over every request.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import compare, stats
from portbench.data import eeg_synth

PLAIN_PIECES = 3  # pieces of trace_batches batches timed untraced in the traced run


def _program():
    # looked up at each call, so that a test can break the program underneath
    from gpar_at_scale_torch.gp import dtc

    return dtc


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class State:
    def __init__(self, run):
        from gpar_at_scale_torch.config import get_config, kernel_family
        from gpar_at_scale_torch.ssm.markov import lgssm_of
        from gpar_at_scale_torch.utils.params import unpack_gpar

        cfg, mix = run.cell.config, run.cell.traffic
        self.run, self.cfg, self.mix, self.device = run, cfg, mix, run.device
        get_config().engine.pallas_dense = cfg["pallas_dense"]
        self.dtype = dtype = getattr(torch, cfg["dtype"])
        time_fam, out_fam = kernel_family(cfg["time_kernel"]), kernel_family(cfg["output_kernel"])
        self.gen = gen = torch.Generator(device=run.device).manual_seed(run.seed)
        self.data = d = eeg_synth.make(cfg["n"], cfg["n_star"], cfg["num_inputs"], gen, dtype)

        def kernels(p):
            tl, ts, ol, osig, ns = unpack_gpar(p)
            return (time_fam(lengthscale=tl, variance=ts**2),
                    out_fam(lengthscale=ol, variance=osig**2), ns**2)

        self.kernels = kernels
        self.params = torch.tensor(cfg["params"], dtype=dtype, device=run.device) + cfg["param_sd"] * (
            torch.randn(5, generator=gen, device=run.device, dtype=dtype))
        self.base = self.params[None, :] + mix["draw_sd"] * torch.randn(
            mix["draws_per_batch"], 5, generator=gen, device=run.device, dtype=dtype)
        _sync(self.device)
        self.stages = [("data", time.perf_counter())]
        tk, ok, nv = kernels(self.params)
        with torch.no_grad():
            self.qu = _program().compute_q_u(ok, lgssm_of(tk, d.t, nv, dtype), d.X, d.X, d.y,
                                             uu_ridge=nv, filter_fn="dense", time_kernel=tk, t=d.t)
        _sync(self.device)
        self.stages.append(("q(u)", time.perf_counter()))
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=run.device)
        self.served = 0
        self.pick = random.Random(run.seed)
        self.checked = [self.request()]
        _sync(self.device)
        self.stages.append(("warm-up batch", time.perf_counter()))

    def next_draws(self):
        """The next batch's draws: the shared ones moved by an offset of its own."""
        return self.base + self.mix["batch_offset_sd"] * torch.randn(
            5, generator=self.gen, device=self.device, dtype=self.dtype)

    def request(self):
        """(draws, mean, var) of the next batch."""
        d, draws = self.data, self.next_draws()
        tk, ok, nv = self.kernels(draws.T)
        with torch.no_grad():
            pred = _program().predict_scaled_batch(ok, tk, self.qu, d.X, d.t, d.y, d.t_star, d.X_star,
                                                   nv, dtype=self.dtype)
        return draws, pred.mean, pred.var


def setup(run) -> State:
    return State(run)


def _serve(st: State, stop):
    """Requests until ``stop(count, elapsed)``; (latencies, window
    seconds), with a uniform sample of every answer served since set-up
    kept (a reservoir of ``check_batches`` beside the warm-up batch)."""
    keep = st.mix["check_batches"]
    lat = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        draws, mean, var = st.request()
        _sync(st.device)
        b = time.perf_counter()
        lat.append(b - a)
        st.nonfinite += (~torch.isfinite(mean.sum() + var.sum())).long()
        st.served += 1
        n = st.served
        if n <= keep:
            st.checked.append((draws, mean, var))
        else:
            j = st.pick.randrange(n)
            if j < keep:
                st.checked[1 + j] = (draws, mean, var)
        if stop(len(lat), b - t0):
            return lat, b - t0


def window(run, st: State) -> dict:
    lat, window_s = _serve(st, lambda n, s: s >= run.seconds)
    return _result(st, lat, window_s)


def _result(st, lat, window_s) -> dict:
    n_req = len(lat)
    obs = n_req * st.mix["draws_per_batch"] * st.cfg["n_star"]
    return {"window_s": window_s, "attempted": n_req, "failed": int(st.nonfinite),
            "metrics": {"obs_per_s": stats.rate(obs, window_s),
                        "request_p95_ms": 1e3 * stats.percentile(lat, 95)},
            "notes": f"{n_req} batches, {obs} observations in {window_s:.3f} s, "
                     f"median request {1e3 * stats.percentile(lat, 50):.4f} ms"}


def traced_window(run, st: State, traced) -> dict:
    """``trace_batches`` batches under the profiler, tracing the device
    alone; as many again traced with the host's operations label the idle
    gaps of the breakdown, and ``PLAIN_PIECES`` times as many timed
    untraced before them give the wall time that the idle share and the
    peak's share are taken over."""
    n = st.mix["trace_batches"]
    # untraced first: a profiler that has run slows later launches
    lat_plain, plain_s = _serve(st, lambda c, s: c >= PLAIN_PIECES * n)
    (lat, window_s), tr = traced(lambda: _serve(st, lambda c, s: c >= n))
    (lat_host, host_s), host_tr = traced(lambda: _serve(st, lambda c, s: c >= n), host=True)
    out = _result(st, lat_plain + lat + lat_host, plain_s + window_s + host_s)
    cfg = st.cfg
    out["context"] = {"trace": tr, "host_trace": host_tr, "plain_s": plain_s / PLAIN_PIECES,
                      "batches": len(lat),
                      "b": st.mix["draws_per_batch"], "n": cfg["n"], "n_star": cfg["n_star"],
                      "M": cfg["num_pseudo_points"], "D": cfg["num_inputs"]}
    out["notes"] = (f"traced: {len(lat)} batches in {window_s:.4f} s tracing the device, "
                    f"{len(lat_host)} in {host_s:.4f} s with the host, "
                    f"{len(lat)} in {out['context']['plain_s']:.4f} s untraced")
    return out


def release(st: State):
    pass


def check(run, st: State, ref) -> dict:
    d = st.data
    inp = ref.Inputs(d.t, d.X, d.y, d.t_star, d.X_star)
    rq = ref.q_u(st.params, inp)
    qu = compare.u_posterior(st.qu.m_eps, st.qu.L_D, st.qu.L_uu)
    out = [{"qu_gap": compare.qu_gap(*qu, *compare.u_posterior(*rq))}]
    for draws, mean, var in st.checked:
        rm, rv = ref.predict(draws, rq, inp)
        out.append(compare.serve_numbers(mean, var, rm, rv))
    return compare.worst(out)


def control_numbers(run, st: State, ref) -> dict:
    """The numbers with the reference's control in the program's place: its
    q(u) at the served parameters and its answers to the warm-up batch's
    draws and as many batches more as a run checks."""
    d = st.data
    inp = ref.Inputs(d.t, d.X, d.y, d.t_star, d.X_star)
    rq, cq = ref.q_u(st.params, inp), ref.q_u(st.params, inp, ref.CONTROL)
    out = [{"qu_gap": compare.qu_gap(*compare.u_posterior(*cq), *compare.u_posterior(*rq))}]
    for draws in [st.checked[0][0]] + [st.next_draws() for _ in range(st.mix["check_batches"])]:
        rm, rv = ref.predict(draws, rq, inp)
        cm, cv = ref.predict(draws, cq, inp, ref.CONTROL)
        out.append(compare.serve_numbers(cm, cv, rm, rv))
    return compare.worst(out)
