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
