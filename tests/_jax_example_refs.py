"""The JAX package's example and benchmark scripts on the CPU, for the
scripts' cases of ``tests/test_torch_port.py``.

``references(case)`` runs in a fresh process of its own (the test file
starts it with the ``spawn`` method), as ``tests/_jax_dist_refs.py`` does:
the worker that runs ``tests/test_torch_port.py`` already holds the compile
state of every earlier case, and XLA:CPU crashes at a position in a long
process (``gpar_tpu_testenv.py``).  It imports the scripts of
``examples/`` and ``benchmarks/`` and calls their functions; no file of
theirs is edited.  Where a script fixes its optimizer steps inside a
function, the step count is cut by replacing that module's ``GPARConfig``
name with one that overrides ``max_opt_steps``; the fits and the SMSE
values are recorded by wrapping the module's names for them.  Plots are
switched off (``get_plt``).  Returns numpy arrays and floats.
"""

import contextlib
import io
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _setup_jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    # tests/conftest.py's cache, unless the environment names another
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_cpu")
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    return jax


def _script(name):
    """Import ``examples.<name>`` or ``benchmarks.<name>`` quietly, plots off.
    Their ``setup_jax`` reads the cache directory from the environment:
    keep the one set above."""
    import importlib

    import jax

    cache = jax.config.jax_compilation_cache_dir
    with contextlib.redirect_stdout(io.StringIO()):
        mod = importlib.import_module(name)
    jax.config.update("jax_compilation_cache_dir", cache)
    if hasattr(mod, "get_plt"):
        mod.get_plt = lambda: None
    return mod


def _record(mod, name, store):
    orig = getattr(mod, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        store.append(out)
        return out

    setattr(mod, name, wrapper)


def _cut_steps(mod, steps):
    """The module's fits take ``steps`` optimizer steps.  At 0 both
    optimizers of ``models/gpar.py`` return their start, as the port's fits
    do without evaluating anything; they are replaced by that identity to
    save their compiles."""
    import gpar_at_scale_tpu.models.gpar as jgpar
    from gpar_at_scale_tpu.inference.optimize import OptResult

    from gpar_at_scale_tpu.inference import optimize

    mod.GPARConfig = lambda **kw: jgpar.GPARConfig(**{**kw, "max_opt_steps": steps})
    identity = lambda fun, x0, **kw: OptResult(x0, np.nan, 0, False)  # noqa: E731
    jgpar.minimize_lbfgs = identity if steps == 0 else optimize.minimize_lbfgs
    jgpar.minimize_adam = identity if steps == 0 else optimize.minimize_adam


def _quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _params(fit):
    return np.asarray(fit.params, np.float64)


def _dtc(case):
    """examples/dtc_example.py's part (a) as the script runs it, its
    ``dtc_objective`` under one ``jax.jit`` (the same function, one compile
    instead of its eager ops): the Kalman value recorded at full precision,
    the dense value as printed, whether its own assertion held.  Part (b)
    is two L-BFGS fits, whose iterates are no parity target (the port's
    L-BFGS steps ``torch.optim.LBFGS``), and is not run here."""
    import jax

    m = _script("examples.dtc_example")
    kalman = []
    m.dtc_objective = jax.jit(m.dtc_objective)
    _record(m, "dtc_objective", kalman)
    buf = io.StringIO()
    held = True
    with contextlib.redirect_stdout(buf):
        try:
            m.compare_dtc_with_dense()
        except AssertionError:
            held = False
    dense = float(next(ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("DTC (dense")).split()[-1])
    return dict(kalman=float(kalman[0]), dense=dense, assertion_held=held)


def _toy(case):
    """examples/toy_example.py's main at ``case["toy_steps"]`` L-BFGS steps
    (0: the fits condition on the script's starts)."""
    m = _script("examples.toy_example")
    _cut_steps(m, case["toy_steps"])
    firsts, models, scores = [], [], []
    _record(m, "fit_first_output", firsts)
    _record(m, "fit_gpar", models)
    _record(m, "smse", scores)
    _quiet(m.main)
    model = models[0]
    return dict(igp=[_params(f) for f in firsts[:3]],
                gpar=[_params(model.first)] + [_params(c) for c in model.conditionals],
                smse=np.asarray(scores, np.float64).reshape(3, 2))


def _plot(case):
    """examples/plot_examples.py's two examples: the exact GP (L-BFGS) at
    ``case["plot_exact_steps"]`` steps, the temporal one (Adam) at
    ``case["plot_steps"]``."""
    m = _script("examples.plot_examples")
    fits, scores = [], []
    _record(m, "fit_first_output", fits)
    _record(m, "smse", scores)
    _cut_steps(m, case["plot_exact_steps"])
    (_, _, mu_e, var_e), _ = _quiet(m.exact_example)
    _cut_steps(m, case["plot_steps"])
    (_, _, mu_t, var_t), _ = _quiet(m.temporal_example)
    return dict(exact=_params(fits[0]), exact_mu=np.asarray(mu_e), exact_smse=float(scores[0]),
                temporal=_params(fits[1]), temporal_mu=np.asarray(mu_t),
                temporal_var=np.asarray(var_t), temporal_smse=float(scores[1]))


def _scaled(case):
    """examples/scaled_examples.py's run on the small set at
    ``case["scaled_steps"]`` Adam steps."""
    from gpar_at_scale_tpu.data.toy import generate_small_dataset

    m = _script("examples.scaled_examples")
    models, scores = [], []
    _record(m, "fit_gpar", models)
    _record(m, "smse", scores)
    _quiet(m.run, generate_small_dataset(seed=0), num_pseudo=10, max_steps=case["scaled_steps"],
           tag="small", grid_stride=3)
    model = models[0]
    return dict(params=[_params(model.first)] + [_params(c) for c in model.conditionals],
                smse=np.asarray(scores, np.float64))


def _eeg(case):
    """examples/eeg.py's run_igp and run for both backends with no
    optimizer step: every fit conditions on the script's starts, so this
    holds the chain's glue (inputs, pseudo-points, the predicted means fed
    forward)."""
    import jax

    m = _script("examples.eeg")
    _cut_steps(m, 0)
    ds = m.load_eeg(None, seed=0)
    key = jax.random.PRNGKey(0)
    out = {"IGP": m.run_igp(ds, key)}
    for backend in ("exact", "scaled"):
        out[backend] = m.run(backend, ds, key)
    return {model: {ch: (np.asarray(mu), np.asarray(var)) for ch, (mu, var) in preds.items()}
            for model, preds in out.items()}


def _bench(case):
    """bench.py's pipeline (its ``main`` times it in one function, so the
    pipeline is rebuilt here from the JAX package's functions exactly as
    bench.py:69-146 writes it), float64, ``case["bench_steps"]`` Adam steps
    of optax.adam(5e-2) from zeros; then q(u) and the predictive."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpar_at_scale_tpu.gp.dtc import compute_q_u, dtc_objective, predict_scaled
    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ssm.markov import lgssm_of
    from gpar_at_scale_tpu.utils.params import unpack_gpar

    dt = jnp.float64
    t, t_star, X, X_star, y = (jnp.asarray(case["bench_data"][k], dt)
                               for k in ("t", "t_star", "X", "X_star", "y"))
    Z = X

    def kernels(p):
        tl, ts, ol, osig, ns = unpack_gpar(p)
        return Matern52(lengthscale=tl, variance=ts**2), Matern52(lengthscale=ol, variance=osig**2), ns**2

    def nlml(p):
        time_k, out_k, nv = kernels(p)
        return -dtc_objective(out_k, lgssm_of(time_k, t, nv, dt), X, Z, y, uu_ridge=nv,
                              filter_fn="dense", time_kernel=time_k, t=t)

    opt = optax.adam(5e-2)
    p = jnp.zeros(5, dt)
    state = opt.init(p)
    vg = jax.jit(jax.value_and_grad(nlml))
    for _ in range(case["bench_steps"]):
        loss, g = vg(p)
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)
    time_k, out_k, nv = kernels(p)
    qu = compute_q_u(out_k, lgssm_of(time_k, t, nv, dt), X, Z, y, uu_ridge=nv,
                     filter_fn="dense", time_kernel=time_k, t=t)
    pred = predict_scaled(out_k, time_k, qu, X, t, y, t_star, X_star, nv, dtype=dt,
                          smooth_fn="dense")
    return dict(params=np.asarray(p), loss=float(loss), mean=np.asarray(pred.mean),
                var=np.asarray(pred.var))


def _chain(case):
    """benchmarks/chain_scale.py's main at a cut size (``case["chain_argv"]``),
    its printed lines parsed: per scaled output the nll/N at the first and
    last step, and every output's rmse."""
    m = _script("benchmarks.chain_scale")
    argv = sys.argv
    sys.argv = ["chain_scale.py", *case["chain_argv"]]
    try:
        _, text = _quiet(m.main)
    finally:
        sys.argv = argv
    rmse, nll = [], []
    for ln in text.splitlines():
        if ln.startswith("[y"):
            words = ln.split()
            rmse.append(float(words[words.index("rmse") + 1]))
            if "nll/N" in words:
                a, b = words[words.index("nll/N") + 1].split("->")
                nll.append((float(a), float(b)))
    return dict(rmse=np.asarray(rmse), nll=np.asarray(nll), text=text)


def _ess(case):
    """benchmarks/ess.py's log-density (its FZ conditional through
    ``bounded_reparam(3.0)``, the script's default strided pseudo-points,
    float64) with its gradient at the case's points, and the script's three
    diagnostics on the case's draws."""
    import jax
    import jax.numpy as jnp

    from gpar_at_scale_tpu.data.eeg import TRAIN_POINTS, load_eeg
    from gpar_at_scale_tpu.inference.diagnostics import ess, split_rhat
    from gpar_at_scale_tpu.inference.hmc import effective_sample_size
    from gpar_at_scale_tpu.models.bayes import bounded_reparam, make_conditional_logpost

    ds = load_eeg(None, seed=0)
    n_tr = TRAIN_POINTS
    obs = [ds.channels.index(c) for c in ("F3", "F4", "F5", "F6")]
    X = np.stack([ds.Y[:n_tr, i] for i in obs], axis=1)
    y = ds.Y[:n_tr, ds.channels.index("FZ")]
    logpost = make_conditional_logpost(ds.t[:n_tr], X, y, likelihood="dtc",
                                       Z=X[:: max(1, n_tr // 32)], dtype=jnp.float64)
    logpost_u, _ = bounded_reparam(logpost, bound=3.0)
    v, g = jax.jit(jax.vmap(jax.value_and_grad(logpost_u)))(jnp.asarray(case["ess_u"]))
    pooled = case["ess_draws"]
    ess_1 = jax.jit(effective_sample_size)
    geyer = np.stack([np.asarray(ess_1(jnp.asarray(c))) for c in pooled]).sum(0)
    return dict(value=np.asarray(v), grad=np.asarray(g), rhat=np.atleast_1d(split_rhat(pooled)),
                ess=np.atleast_1d(ess(pooled)), geyer=geyer)


_SCRIPTS = {"dtc": _dtc, "toy": _toy, "plot": _plot, "scaled": _scaled, "eeg": _eeg,
            "bench": _bench, "chain": _chain, "ess": _ess}


# ---------------------------------------------------------------------------
# The long-series and sampler scripts of benchmarks/: their logic lives in
# their main(), so each is rebuilt here from the JAX package's functions as
# the script writes it (the script's lines cited), float64, with the script's
# module-level functions where it has them.
# ---------------------------------------------------------------------------


def _million_dtc(case):
    """benchmarks/million_dtc.py at N = case["dtc_N"], M = case["dtc_M"]:
    its ``make_data``; ``arrays`` and ``bound_from_gram`` (:109-131) and the
    staged gradient of its ``_check`` (:688-697); the analytic predictive
    of row (c) (:552-605, one filter and smoother over the M + 1 columns)
    at the start point (:133)."""
    import jax
    import jax.numpy as jnp

    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ssm.blocked import blocked_filter, blocked_smooth
    from gpar_at_scale_tpu.ssm.blocked_grad import whiten_bwd, whiten_fwd_aux
    from gpar_at_scale_tpu.ssm.markov import lgssm_of
    from gpar_at_scale_tpu.utils.params import pack_gpar, unpack_gpar

    m = _script("benchmarks.million_dtc")
    N, M, N_star = case["dtc_N"], case["dtc_M"], case["dtc_Nstar"]
    t_np, X_np, y_np, ts_np, Xs_np, _, _ = m.make_data(N, N_star, np.random.default_rng(0))
    f = jnp.float64
    t, X, y, t_star, X_star = (jnp.asarray(a, f) for a in (t_np, X_np, y_np, ts_np, Xs_np))
    Z = X[:: max(1, N // M)][:M]

    def build(p):
        tl, tsig, ol, osig, ns = unpack_gpar(p)
        return Matern52(lengthscale=tl, variance=tsig**2), Matern52(lengthscale=ol, variance=osig**2), ns**2

    def arrays(p):
        time_k, out_k, nv = build(p)
        lg = lgssm_of(time_k, t, nv, f)
        U = jnp.concatenate([y[:, None], out_k(X, Z)], axis=1)
        Kuu = out_k(Z, Z) + nv * jnp.eye(Z.shape[0], dtype=f)
        return lg.A, lg.Q, jnp.broadcast_to(lg.R, (N,)), lg.H, U, Kuu

    def bound_from_gram(G, logdet, Kuu):
        aa, g, Gb = G[0, 0], G[1:, 0], G[1:, 1:]
        L_uu, L_P = jnp.linalg.cholesky(Kuu), jnp.linalg.cholesky(Gb + Kuu)
        wp = jax.scipy.linalg.solve_triangular(L_P, g, lower=True)
        ld = lambda L: 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))  # noqa: E731
        return -0.5 * (N * 1.8378770664093453 + logdet + ld(L_P) - ld(L_uu) + aa - jnp.sum(wp**2))

    @jax.jit
    def staged(pp):
        A, Q, R, H, U, Kuu = arrays(pp)
        G, logdet, aux = whiten_fwd_aux(A, Q, R, H, U)
        val, (ct_G, ct_ld, ct_K) = jax.value_and_grad(bound_from_gram, argnums=(0, 1, 2))(
            G, logdet, Kuu)
        ct_A, ct_Q, ct_R, ct_U = whiten_bwd(A, Q, R, H, aux, ct_G, ct_ld)
        _, vjp = jax.vjp(lambda q: tuple(x for i, x in enumerate(arrays(q)) if i != 3), pp)
        (g,) = vjp((ct_A, ct_Q, ct_R, ct_U, ct_K))
        return G, logdet, val, g

    @jax.jit
    def predict(p):
        time_k, out_k, nv = build(p)
        A, Q, R, H, U, Kuu = arrays(p)
        G, _, _ = whiten_fwd_aux(A, Q, R, H, U)
        g, Gb = G[1:, 0], G[1:, 1:]
        L_uu = jnp.linalg.cholesky(Kuu)
        sl = jax.scipy.linalg.solve_triangular
        AAt = sl(L_uu, sl(L_uu, Gb, lower=True).T, lower=True)
        D = AAt + jnp.eye(AAt.shape[0], dtype=f)
        L_D = jnp.linalg.cholesky(0.5 * (D + D.T))
        m_eps = sl(L_D.T, sl(L_D, sl(L_uu, g, lower=True), lower=True), lower=False)
        t_all = jnp.concatenate([t, t_star])
        V_all = jnp.concatenate([X, X_star], axis=0)
        y_all = jnp.concatenate([y, jnp.zeros((N_star,), f)])
        noise_all = jnp.concatenate([jnp.full((N,), nv, f), jnp.full((N_star,), 1e10, f)])
        order = jnp.argsort(t_all)
        lg = lgssm_of(time_k, t_all[order], noise_all[order], f)
        Phi = sl(L_uu, out_k(V_all[order], Z).T, lower=True).T
        fx_bar = Phi @ m_eps
        Gm = sl(L_D, Phi.T, lower=True).T
        cols = jnp.concatenate([(y_all[order] - fx_bar)[:, None], Gm], axis=1)
        sm = blocked_smooth(lg, cols, filter_result=blocked_filter(lg, cols))
        mean_all = fx_bar + sm.mean[:, 0]
        Hm = Gm - sm.mean[:, 1:]
        var_all = jnp.sum(Hm * Hm, axis=1) + sm.var
        inv = jnp.argsort(order)
        return mean_all[inv][N:], jnp.maximum(var_all, 0.0)[inv][N:]

    p0 = jnp.asarray(pack_gpar(0.5, 1.0, 1.0, 0.7, 0.2), f)
    G, logdet, val, g = jax.device_get(staged(p0))
    mean, var = jax.device_get(predict(p0))
    return dict(G=G, logdet=float(logdet), value=float(val), grad=g, mean=mean, var=var)


def _series_of(formula, n, seed=0):
    """(t, y) numpy float64 of the scripts' long series: gaps of 0.5e-3 to
    1.5e-3 from numpy seed ``seed``, then ``formula(t, rng)``."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 1.5, n)) / 1000.0
    return t, formula(t, rng)


def _million_grad(case):
    """benchmarks/million_grad.py's default route (:160-170, :205-220):
    nll = -blocked_logpdf / N of its series (:43-50) and its gradient at
    pack_gp(0.3, 1.0, 0.1), then ``case["grad_steps"]`` steps of
    optax.adam(5e-2), float64."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ssm.blocked import blocked_logpdf
    from gpar_at_scale_tpu.ssm.markov import lgssm_of
    from gpar_at_scale_tpu.utils.params import pack_gp, unpack_gp

    N = case["grad_N"]
    t_np, y_np = _series_of(lambda t, rng: np.sin(t * (2.0 / 0.9)) * 0.8 + 0.25 * rng.normal(size=len(t)), N)
    t, y = jnp.asarray(t_np), jnp.asarray(y_np)

    def nll(p):
        l, sf, sn = unpack_gp(p)
        k = Matern52(lengthscale=l, variance=sf**2)
        return -blocked_logpdf(lgssm_of(k, t, sn**2, jnp.float64), y) / N

    vg = jax.jit(jax.value_and_grad(nll))
    opt = optax.adam(5e-2)
    p = jnp.asarray(pack_gp(0.3, 1.0, 0.1), jnp.float64)
    st = opt.init(p)
    v0, g0 = vg(p)
    trace = []
    for _ in range(case["grad_steps"]):
        v, g = vg(p)
        up, st = opt.update(g, st)
        p = optax.apply_updates(p, up)
        trace.append(float(v))
    return dict(nll=float(v0), grad=np.asarray(g0), params=np.asarray(p), trace=np.asarray(trace))


def _long_series(case):
    """benchmarks/long_series.py's rows (:68-71 its series; Matern-5/2
    (1, 1), noise 0.09) in float64: each row's first output summed, as the
    script prints it, and the smoothers' means."""
    import jax
    import jax.numpy as jnp

    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ops.pallas_kalman import pallas_decorrelate
    from gpar_at_scale_tpu.ops.pallas_smoother import pallas_smooth
    from gpar_at_scale_tpu.ssm.blocked import blocked_decorrelate, blocked_filter, blocked_smooth
    from gpar_at_scale_tpu.ssm.kalman import decorrelate
    from gpar_at_scale_tpu.ssm.markov import lgssm_of
    from gpar_at_scale_tpu.ssm.pkalman import parallel_decorrelate
    from gpar_at_scale_tpu.ssm.segmented import segmented_decorrelate_t, segmented_smooth_t

    N, seg = case["long_N"], case["long_segment"]
    t_np, y_np = _series_of(lambda t, rng: np.sin(t * 3) + 0.3 * rng.normal(size=len(t)), N)
    t, y = jnp.asarray(t_np), jnp.asarray(y_np)
    k = Matern52(lengthscale=1.0, variance=1.0)
    lg = lgssm_of(k, t, 0.09, jnp.float64)

    @jax.jit
    def rows(y):
        fr = blocked_filter(lg, y[:, None])
        return dict(
            filter=blocked_decorrelate(lg, y)[0],
            smooth=blocked_smooth(lg, y).mean,
            split=blocked_smooth(lg, y[:, None], filter_result=fr).mean[:, 0],
            seq=decorrelate(lg, y)[0],
            assoc=parallel_decorrelate(lg, y)[0],
            pallas_filter=pallas_decorrelate(lg, y)[0],
            pallas_smooth=pallas_smooth(lg, y)[0],
        )

    out = jax.device_get(rows(y))
    out["segfilter"] = float(segmented_decorrelate_t(k, t, 0.09, y, seg)[0])
    out["segsmooth"] = np.asarray(segmented_smooth_t(k, t, 0.09, y, seg).mean)
    return out


def _smc_series(n):
    """benchmarks/million_smc.py's series (:69-76), t and y rounded to
    float32 as the script casts them (:72)."""
    t_np, y_np = _series_of(lambda t, rng: 1.2 * np.sin(2 * np.pi * t / 7.0)
                            * np.cos(2 * np.pi * t / 1.3) + 0.3 * rng.normal(size=len(t)), n)
    return t_np.astype(np.float32).astype(np.float64), y_np.astype(np.float32).astype(np.float64)


def _million_smc(case):
    """benchmarks/million_smc.py's host route (:78-92, :170-268) in
    float64: the likelihood of a fixed particle batch (blocked_logpdf), the
    JAX ``smc_host`` from the case's x0, and the ``--map-init`` bridge's
    Nelder-Mead end point and Laplace scale."""
    import jax
    import jax.numpy as jnp
    from scipy.optimize import minimize

    from gpar_at_scale_tpu.inference.smc import smc_host
    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ssm.blocked import blocked_logpdf
    from gpar_at_scale_tpu.ssm.markov import lgssm_of
    from gpar_at_scale_tpu.utils.params import unpack_gp

    t_np, y_np = _smc_series(case["smc_N"])
    t, y = jnp.asarray(t_np), jnp.asarray(y_np)

    @jax.jit
    def loglik(params):
        l, sf, sn = unpack_gp(params)
        return blocked_logpdf(lgssm_of(Matern52(lengthscale=l, variance=sf**2), t, sn**2,
                                       jnp.float64), y)

    def lik_batch(xs):
        return np.array([float(loglik(jnp.asarray(x))) for x in np.asarray(xs)])

    def prior_batch(xs):
        return -0.5 * np.sum(np.asarray(xs) ** 2, axis=1) / 4.0

    res = smc_host(0, prior_batch, lik_batch, case["smc_x0"], num_mutations=case["smc_mutations"],
                   ess_threshold=0.5, max_stages=case["smc_stages"])
    negll = lambda p: -float(loglik(jnp.asarray(p)))  # noqa: E731
    opt = minimize(negll, np.zeros(3), method="Nelder-Mead",
                   options={"maxfev": 80, "xatol": 1e-3, "fatol": 0.5})
    pmap, h, f0 = opt.x, 0.02, -opt.fun
    s = np.empty(3)
    for i in range(3):
        e = np.zeros(3)
        e[i] = h
        s[i] = 1.0 / np.sqrt(max((2 * f0 + negll(pmap + e) + negll(pmap - e)) / h**2, 1e-2))
    return dict(lls=lik_batch(case["smc_xs"]), particles=np.asarray(res.particles),
                logZ=res.log_evidence, stages=res.num_stages, evals=res.num_lik_evals,
                pmap=pmap, laplace=s)


def _nuts_vs_smc(case):
    """benchmarks/nuts_vs_smc.py's target (:64-76): blocked_loglik of the
    million_smc series with the prior, its value and gradient at the case's
    points, float64; and the script's verdict (:121-127) on the case's two
    clouds."""
    import jax
    import jax.numpy as jnp

    from gpar_at_scale_tpu.inference.diagnostics import means_agree_within_mc_error, summarize
    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.ssm.blocked_grad import blocked_loglik
    from gpar_at_scale_tpu.ssm.markov import lgssm_of

    t_np, y_np = _smc_series(case["ns_N"])
    t, y = jnp.asarray(t_np), jnp.asarray(y_np)

    def logpost(params):
        l, sf, sn = (jnp.exp(params[i]) + 1e-3 for i in range(3))
        k = Matern52(lengthscale=l, variance=sf**2)
        return blocked_loglik(lgssm_of(k, t, sn**2, jnp.float64), y) - 0.5 * jnp.sum(params**2) / 4.0

    v, g = jax.jit(jax.vmap(jax.value_and_grad(logpost)))(jnp.asarray(case["ns_q"]))
    chains = np.exp(case["ns_nuts"]) + 1e-3
    cloud = (np.exp(case["ns_smc"]) + 1e-3)[None]
    d_n, d_s = summarize(chains), summarize(cloud)
    return dict(value=np.asarray(v), grad=np.asarray(g), mean_nuts=np.asarray(d_n.mean),
                mean_smc=np.asarray(d_s.mean), mcse_nuts=np.asarray(d_n.mcse),
                mcse_smc=np.asarray(d_s.mcse),
                agree=bool(means_agree_within_mc_error(chains, cloud)))


def _pod_scaling(case):
    """benchmarks/pod_scale.py's phase A targets (:56-71: each conditional's
    DTC logpost) and benchmarks/scaling.py's (:146-150: the toy small set's
    output 2 given output 1), value and gradient at the case's points,
    float64; the unsharded blocked decorrelate of scaling --weak's series."""
    import jax
    import jax.numpy as jnp

    from gpar_at_scale_tpu.data.toy import generate_small_dataset
    from gpar_at_scale_tpu.kernels import Matern52
    from gpar_at_scale_tpu.models.bayes import make_conditional_logpost
    from gpar_at_scale_tpu.ssm.blocked import blocked_decorrelate
    from gpar_at_scale_tpu.ssm.markov import lgssm_of

    n, P = case["pod_n"], case["pod_outputs"]
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.0, 4.0, size=n))
    Y = np.cumsum(rng.normal(size=(n, P)), axis=1) * 0.3 + np.sin(2.0 * t)[:, None]
    q = jnp.asarray(case["pod_q"])
    pod = []
    for i in range(1, P):
        X_prev = Y[:, :i]
        lp = make_conditional_logpost(t, X_prev, Y[:, i], likelihood="dtc",
                                      Z=X_prev[:: max(1, n // 32)][:32], dtype=jnp.float64)
        v, g = jax.vmap(jax.value_and_grad(lp))(q)
        pod.append((np.asarray(v), np.asarray(g)))
    ds = generate_small_dataset(seed=0)
    V = ds.y_obs[:, :1]
    lp = make_conditional_logpost(ds.x, V, ds.y_obs[:, 1], likelihood="dtc", Z=V[::3],
                                  dtype=jnp.float64)
    v, g = jax.vmap(jax.value_and_grad(lp))(q)
    N = case["weak_N"]
    t_np, y_np = _series_of(lambda t, rng: np.sin(t * 3) + 0.3 * rng.normal(size=len(t)), N)
    lg = lgssm_of(Matern52(lengthscale=1.0, variance=1.0), jnp.asarray(t_np), 0.09, jnp.float64)
    ll = float(blocked_decorrelate(lg, jnp.asarray(y_np))[0])
    return dict(pod=pod, toy=(np.asarray(v), np.asarray(g)), weak_ll=ll)


_SCRIPTS.update({"million_dtc": _million_dtc, "million_grad": _million_grad,
                 "long_series": _long_series, "million_smc": _million_smc,
                 "nuts_vs_smc": _nuts_vs_smc, "pod_scaling": _pod_scaling})


def references(case, names):
    """{script: its reference outputs} for the scripts ``names``.  The test
    file runs the scripts in a few processes at once: their compiles, not
    their arithmetic, take the time."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    if "jax" not in sys.modules:  # compiles dominate: XLA's backend optimizations off
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0"
                                   " --xla_llvm_disable_expensive_passes=true").strip()
    _setup_jax()
    return {name: _SCRIPTS[name](case) for name in names}


def test_refs(jobs):
    """{(name, args): name(*args)} of ``tests/test_torch_port.py``'s JAX
    reference functions (its ``_REF_GROUPS``), computed in this process: the
    test file is imported here again."""
    for path in (str(REPO), str(REPO / "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    _setup_jax()
    import torch

    torch.set_num_threads(1)
    import test_torch_port as T

    return {(name, args): getattr(T, name)(*args) for name, args in jobs}
