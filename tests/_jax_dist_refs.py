"""The JAX package's sharded functions on a 4-device CPU mesh, for the
parallel layer's CPU tests (``tests/test_torch_port.py``).

``references(case)`` runs in a fresh process of its own (the test file
starts it with the ``spawn`` method): the xdist worker that runs
``tests/test_torch_port.py`` already holds the compile state of every
earlier case, and XLA:CPU crashes at a position in a long process
(``gpar_tpu_testenv.py``), so these compiles stay out of it.  Returns
numpy arrays.
"""

import os

import numpy as np


def _setup_jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    os.makedirs("/tmp/jax_cache_cpu", exist_ok=True)  # tests/conftest.py's cache
    jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache_cpu")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    return jax


def _seq(jax, case, n, mesh):
    import jax.numpy as jnp

    import gpar_at_scale_tpu.kernels as jk
    from gpar_at_scale_tpu.parallel import seqshard as jseq
    from gpar_at_scale_tpu.ssm import markov as jmarkov

    t, Y = jnp.asarray(case[f"seq_t{n}"]), jnp.asarray(case[f"seq_Y{n}"])

    def lg(p):
        l, v, nv = jnp.exp(p)
        return jmarkov.lgssm_of(jk.Matern52(lengthscale=l, variance=v), t, nv, jnp.float64)

    p0 = jnp.asarray(case["seq_params"])
    f = jseq.make_sharded_filter(mesh)(lg(p0), Y)
    s = jseq.make_sharded_smooth(mesh)(lg(p0), Y)
    lp, g = jax.value_and_grad(lambda p: jseq.make_sharded_logpdf(mesh)(lg(p), Y[:, 0]))(p0)
    return jax.device_get(dict(m=f.m, P=f.P, S=f.S, v=f.v, ll=f.ll, mean=s.mean, var=s.var,
                               ms=s.ms, Ps=s.Ps, sll=s.ll, lp=lp, grad=g))


def _model(jax, case):
    import jax.numpy as jnp

    from gpar_at_scale_tpu.parallel import modelshard as jms
    from gpar_at_scale_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(("model",), (4,), devices=jax.devices()[:4])
    args = [jnp.asarray(case[k]) for k in ("model_t", "model_V", "model_y")]
    Z = jms.place_modelsharded(mesh, jnp.asarray(case["model_Z"]))
    nlml = jms.make_modelsharded_nlml(mesh, dtype=jnp.float64, num_blocks=8)
    v, g = jax.jit(jax.value_and_grad(lambda p: nlml(p, *args, Z)))(jnp.asarray(case["model_params"]))
    return dict(value=float(v), grad=np.asarray(g))


def _train(jax, case):
    import jax.numpy as jnp

    from gpar_at_scale_tpu.parallel.mesh import make_mesh
    from gpar_at_scale_tpu.parallel.sharded import make_sharded_train_step

    mesh = make_mesh(("chain", "data"), (2, 2), devices=jax.devices()[:4])
    init, step, place = make_sharded_train_step(mesh, dtype=jnp.float64, learning_rate=1e-2)
    p, *data = place(*(jnp.asarray(case[k]) for k in
                       ("train_params", "train_t", "train_X", "train_y", "train_Z")))
    state, losses = init(p), []
    for _ in range(2):
        state, loss = step(state, *data)
        losses.append(np.asarray(loss))
    return dict(losses=np.stack(losses), params=np.asarray(state.params))


def references(case):
    """{"seq": {n: ...}, "model": ..., "train": ...} of the JAX package."""
    jax = _setup_jax()
    from gpar_at_scale_tpu.parallel.mesh import make_mesh

    data4 = make_mesh(("data",), (4,), devices=jax.devices()[:4])
    return dict(seq={n: _seq(jax, case, n, data4) for n in case["seq_ns"]},
                model=_model(jax, case), train=_train(jax, case))
