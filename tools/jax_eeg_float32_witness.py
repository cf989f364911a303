"""The JAX package's float32 dense DTC branch on the EEG chain.

Fits the scaled conditionals FZ -> F1 -> F2 of the EEG example
(``examples/eeg.py``: M = 156 pseudo-points, start pack_gpar(0.1, 1, 1, 1,
0.3), L-BFGS for at most 150 steps) in float32 on the CPU, through
``gpar_at_scale_tpu.models.gpar.fit_conditional``, with the dense switch
"interpret" (the Pallas kernels K6a-c in interpret mode) and "off" (XLA).
Prints, per channel, the objective evaluations and how many were not
finite (a failed factorization returns NaN in JAX, and optax's line search
backs off from it), the objective at the optimum, whether q(u) is finite,
and the SMSE of the 100 test times predicted down the chain.

    JAX_PLATFORMS=cpu python tools/jax_eeg_float32_witness.py [--modes interpret,off]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="interpret,off")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import gpar_at_scale_tpu.models.gpar as G
    from gpar_at_scale_tpu.config import get_config
    from gpar_at_scale_tpu.data.eeg import TRAIN_POINTS, generate_synthetic_eeg
    from gpar_at_scale_tpu.utils.params import pack_gpar

    evals = {"n": 0, "bad": 0}

    def note(v):
        evals["n"] += 1
        evals["bad"] += int(not np.isfinite(v))

    inner = G.dtc_objective

    def counted(*a, **k):
        v = inner(*a, **k)
        jax.debug.callback(note, v)
        return v

    G.dtc_objective = counted
    ds = generate_synthetic_eeg(seed=0)
    n = TRAIN_POINTS
    obs = [ds.channels.index(c) for c in ("F3", "F4", "F5", "F6")]
    f32 = jnp.float32
    for mode in args.modes.split(","):
        get_config().engine.pallas_dense = mode
        cols_tr = [ds.Y[:n, i] for i in obs]
        cols_te = [ds.Y[n:, i] for i in obs]
        for ch in ("FZ", "F1", "F2"):
            yi = ds.channels.index(ch)
            cfg = G.GPARConfig(backend="scaled", num_pseudo_points=n,
                               max_opt_steps=args.steps, dtype=f32)
            evals.update(n=0, bad=0)
            t0 = time.perf_counter()
            fit = G.fit_conditional(
                jax.random.PRNGKey(0), ds.t[:n], np.stack(cols_tr, 1), ds.Y[:n, yi], cfg,
                init_params=pack_gpar(0.1, 1.0, 1.0, 1.0, 0.3))
            mu, _ = fit.predict(jnp.asarray(ds.t[n:], f32), jnp.asarray(np.stack(cols_te, 1), f32))
            mu = np.asarray(mu, np.float64)
            jax.effects_barrier()
            truth = ds.Y[n:, yi]
            smse = float(np.mean((mu - truth) ** 2) / np.var(truth))
            a, k = _args(G, cfg, fit)
            nll = -float(inner(*a, **k))
            print(f"[witness] {mode} scaled {ch}: {evals['n']} evaluations, {evals['bad']} "
                  f"not finite; nll at the optimum {nll:.5f}; qu finite "
                  f"{bool(np.isfinite(np.asarray(fit.qu.L_D)).all())}; SMSE {smse:.4f}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            cols_tr.append(ds.Y[:n, yi])
            cols_te.append(mu)


def _args(G, cfg, fit):
    tl, ts, ol, osig, ns, tns = G._unpack_cond(cfg, fit.params)
    time_k = G.time_kernel_only(cfg.time_family, tl, ts)
    out_k = cfg.out_family(lengthscale=ol, variance=osig**2)
    lgssm = G.lgssm_of(time_k, fit.t, tns**2, cfg.dtype)
    return (out_k, lgssm, fit.X_prev, fit.Z, fit.y), dict(
        uu_ridge=ns**2, time_kernel=time_k, t=fit.t)


if __name__ == "__main__":
    main()
