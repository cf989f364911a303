"""Rank bodies of the parallel layer's CPU tests (``tests/test_torch_port.py``).

``run_ranks(body, 4, case, ...)`` runs ``body`` on 4 gloo ranks; it
imports neither jax nor the test file, so each spawned rank imports only
torch and the port.  ``body`` computes every sharded result the tests
check and returns numpy arrays and flags.
"""

import numpy as np
import torch

F64, F32 = torch.float64, torch.float32


def _np(x):
    return x.detach().cpu().numpy()


def _same(a, b):
    """Whether two tensors (or tuples of them) are equal, bit for bit."""
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _lgssm(t, params, dtype):
    """Matern-5/2 LGSSM of log-parameters (log l, log variance, log noise)."""
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    l, v, nv = torch.exp(params)
    return lgssm_of(Matern52(lengthscale=l, variance=v), t, nv, dtype)


def _seq(case, mesh):
    """The time-sharded filter, smoother and logpdf gradient, float64."""
    from gpar_at_scale_torch.parallel.seqshard import (
        make_sharded_filter,
        make_sharded_logpdf,
        make_sharded_smooth,
    )

    out = {}
    for n in case["seq_ns"]:
        t = torch.as_tensor(case[f"seq_t{n}"])
        Y = torch.as_tensor(case[f"seq_Y{n}"])
        p = torch.as_tensor(case["seq_params"]).requires_grad_(True)
        with torch.no_grad():
            lg = _lgssm(t, p, F64)
            f = make_sharded_filter(mesh)(lg, Y)
            s = make_sharded_smooth(mesh)(lg, Y)
        ll = make_sharded_logpdf(mesh)(_lgssm(t, p, F64), Y[:, 0])
        (g,) = torch.autograd.grad(ll, p)
        out[n] = dict(m=_np(f.m), P=_np(f.P), S=_np(f.S), v=_np(f.v), ll=_np(f.ll),
                      mean=_np(s.mean), var=_np(s.var), ms=_np(s.ms), Ps=_np(s.Ps),
                      sll=_np(s.ll), lp=float(ll.detach()), grad=_np(g))
    return out


def _unsharded(case, mesh1):
    """Each sharded function on a time (or model) axis of one rank against
    the port's unsharded engine: {name: equal bit for bit}."""
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.ops.grad import lgssm_loglik
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked
    from gpar_at_scale_torch.ops.smoother import pallas_smooth
    from gpar_at_scale_torch.ops.whiten import whiten_gram
    from gpar_at_scale_torch.parallel.modelshard import dtc_objective_modelsharded
    from gpar_at_scale_torch.parallel.seqshard import ShardedFilter
    from gpar_at_scale_torch.ssm.blocked import blocked_filter, blocked_smooth
    from gpar_at_scale_torch.ssm.blocked_grad import blocked_loglik

    n = case["seq_ns"][-1]
    t = torch.as_tensor(case[f"seq_t{n}"])
    Y = torch.as_tensor(case[f"seq_Y{n}"])
    sf = ShardedFilter(mesh1)
    out = {}
    p0 = torch.as_tensor(case["seq_params"])

    def grads(fn, dtype):
        p = p0.clone().requires_grad_(True)
        ll = fn(_lgssm(t, p, dtype))
        return (ll.detach(),) + torch.autograd.grad(ll, p)

    lg = _lgssm(t, p0, F64)
    out["filter"] = _same(tuple(sf(lg, Y)), tuple(blocked_filter(lg, Y)))
    out["smooth"] = _same(tuple(sf.smooth(lg, Y)), tuple(blocked_smooth(lg, Y)))
    out["logpdf"] = _same(grads(lambda g: sf.logpdf(g, Y[:, 0]), F64),
                          grads(lambda g: blocked_loglik(g, Y[:, 0]), F64))
    lg32, y32 = _lgssm(t, p0, F32), Y[:, 0].float()
    out["decorrelate_f32"] = _same(sf.decorrelate(lg32, y32), decorrelate_blocked(lg32, y32))
    s32 = sf.smooth(lg32, y32)
    ref = pallas_smooth(lg32, y32, return_state=True)
    out["smooth_f32"] = _same((s32.mean, s32.var, s32.ll[0], s32.ms[:, :, 0], s32.Ps), ref[:5])
    out["logpdf_f32"] = _same(
        grads(lambda g: sf.logpdf(g, y32), F32),
        grads(lambda g: lgssm_loglik(g.A, g.Q, g.R.expand(n), y32), F32))
    U = (Y[:, :1] * torch.tensor([1.0, 0.5, -2.0], dtype=F64)).float()
    out["gram_f32"] = _same(sf.gram(lg32, U.contiguous()), whiten_gram(lg32, U.contiguous()))

    tm, V, ym, Z = (torch.as_tensor(case[k]) for k in ("model_t", "model_V", "model_y", "model_Z"))
    lgm = _lgssm(tm, p0, F64)
    ok = torch.tensor(0.9, dtype=F64)
    val = dtc_objective_modelsharded(mesh1, (ok, ok), lgm, V, ym, Z, uu_ridge=0.09, model_axis="data")
    ref = dtc_objective(Matern52(lengthscale=ok, variance=ok**2), lgm, V, Z, ym, uu_ridge=0.09,
                        filter_fn="blocked")
    out["modelshard"] = _same(val, ref)
    return out


def _model(case, mesh):
    """The model-sharded objective and gradient (float64), and the raise
    on an M the axis does not divide."""
    from gpar_at_scale_torch.parallel.modelshard import (
        dtc_objective_modelsharded,
        make_modelsharded_nlml,
        place_modelsharded,
    )

    t, V, y, Z = (torch.as_tensor(case[k]) for k in ("model_t", "model_V", "model_y", "model_Z"))
    p = torch.as_tensor(case["model_params"]).requires_grad_(True)
    val = make_modelsharded_nlml(mesh, dtype=F64)(p, t, V, y, place_modelsharded(mesh, Z))
    (g,) = torch.autograd.grad(val, p)
    try:
        lg = _lgssm(t, torch.zeros(3, dtype=F64), F64)
        dtc_objective_modelsharded(mesh, (0.9, 1.0), lg, V, y, Z[:-2], uu_ridge=0.09)
        raised = False
    except ValueError as e:
        raised = "divide" in str(e)
    return dict(value=float(val), grad=_np(g), indivisible_raises=raised)


def _train(case, mesh):
    """Two steps of the sharded train step on (chain 2, data 2), float64."""
    from gpar_at_scale_torch.parallel.sharded import make_sharded_train_step

    t, X, y, Z = (torch.as_tensor(case[k]) for k in ("train_t", "train_X", "train_y", "train_Z"))
    init, step, place = make_sharded_train_step(mesh, dtype=F64, learning_rate=1e-2)
    p, t_s, X_s, y_s, Z_s = place(case["train_params"], t, X, y, Z)
    state = init(p)
    losses = []
    for _ in range(2):
        state, loss = step(state, t_s, X_s, y_s, Z_s)
        losses.append(_np(loss))
    return dict(losses=np.stack(losses), params=_np(state.params))


def _fit(case, mesh):
    """fit_gpar(mesh=) over the chain axis against the unsharded fit."""
    from gpar_at_scale_torch.models import GPARConfig, fit_gpar

    t, Y = case["fit_t"], case["fit_Y"]
    cfg = GPARConfig(backend="scaled", num_pseudo_points=8, optimizer="adam", max_opt_steps=3,
                     dtype=F64)
    sharded = fit_gpar(torch.Generator().manual_seed(5), t, Y, cfg, mesh=mesh, device="cpu")
    plain = fit_gpar(torch.Generator().manual_seed(5), t, Y, cfg, device="cpu")
    same = all(_same((a.params, a.qu.m_eps, a.qu.L_D), (b.params, b.qu.m_eps, b.qu.L_D))
               for a, b in zip(sharded.conditionals, plain.conditionals))
    return dict(same=same and _same(sharded.first.params, plain.first.params),
                count=len(sharded.conditionals))


def _guard(case, mesh):
    """The forward-only sharded functions raise when an input requires
    grad (the kernel route, float32)."""
    from gpar_at_scale_torch.parallel.seqshard import ShardedFilter

    n = case["seq_ns"][0]
    t, y = torch.as_tensor(case[f"seq_t{n}"]), torch.as_tensor(case[f"seq_Y{n}"])[:, 0].float()
    p = torch.as_tensor(case["seq_params"]).requires_grad_(True)
    lg = _lgssm(t, p, F32)
    sf = ShardedFilter(mesh)
    raised = []
    for fn in (sf, sf.decorrelate, sf.smooth):
        try:
            fn(lg, y)
            raised.append(False)
        except RuntimeError as e:
            raised.append("forward only" in str(e))
    return all(raised)


def body(case):
    """Every parallel-layer result of the CPU tests, on one of 4 ranks."""
    from gpar_at_scale_torch.parallel import make_mesh

    try:
        make_mesh(("chain", "data"), (3, 1))
        sizes_raise = False
    except ValueError as e:
        sizes_raise = "multiply" in str(e)
    data4 = make_mesh(("data",))
    out = dict(seq=_seq(case, data4), model=_model(case, make_mesh(("model",))),
               guard=_guard(case, data4), sizes_raise=sizes_raise)
    grid = make_mesh(("chain", "data"), (2, 2))
    out["train"] = _train(case, grid)
    out["fit"] = _fit(case, grid)
    out["unsharded"] = _unsharded(case, make_mesh(("chain", "data"), (4, 1)))
    return out
