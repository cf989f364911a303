"""Gradient-based type-II maximum likelihood.

Counterpart of ``gpar_at_scale_tpu/inference/optimize.py``: L-BFGS and Adam
over an unconstrained log-parameter vector (``utils/params.py``), driven by
autograd.  Where the JAX package runs the loop under ``jit`` inside one
``lax.while_loop``, the port runs it eagerly on the host; each step reads
the gradient norm back to test for convergence, one synchronisation per
step.

Semantics kept from the JAX package:

* ``minimize_lbfgs`` -- memory 10, a strong-Wolfe line search of at most 30
  function evaluations per step, stop when the global gradient norm is at
  most ``gtol`` or after ``max_steps`` steps.  It steps
  ``torch.optim.LBFGS``; its iterates are not optax's, its optimum is the
  same one.  Where the strong-Wolfe search finds no step (near the optimum
  the decrease sinks into the objective's rounding), the full L-BFGS step
  is taken if it passes the approximate Wolfe test of optax's zoom search;
  without that the loop stalls above ``gtol`` on small float64 problems
  that optax solves.  A point where the objective raises
  ``torch.linalg.LinAlgError`` (a float32 factorization that failed) is
  outside its domain: the step is tried again from the same state with half
  the step length, as optax's zoom search shrinks its step past the NaN the
  JAX package gets there; the loop stops when no step length down to
  2^-29 stays inside.
* ``minimize_adam`` -- optax's Adam (beta 0.9 / 0.999, eps 1e-8 outside the
  square root, bias-corrected; ``torch.optim.Adam`` computes the same
  update); the value returned is the one at the last evaluated point, the
  parameters those after the last update, and ``converged`` tests the last
  evaluated gradient norm.  Each step is the span ``gpar.step`` (with
  ``gpar.backward`` and ``gpar.update`` inside it,
  ``utils/observability.py``).

Each result also carries ``trace``, the objective at every evaluated step
(the accepted iterates for L-BFGS), and the loop's wall ``seconds``.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, NamedTuple

import torch

from gpar_at_scale_torch.utils.observability import host_sync, span

# Most function evaluations of one line search (optax's zoom search, as the
# JAX package configures it), and the approximate Wolfe test optax's search
# falls back on (its approx_dec_rtol; the strong-Wolfe curvature constant).
_LINESEARCH_STEPS = 30
_APPROX_DEC_RTOL, _CURVATURE = 1e-6, 0.9


class OptResult(NamedTuple):
    params: torch.Tensor  # optimized unconstrained parameters
    value: torch.Tensor  # final objective value
    num_steps: int  # steps actually taken
    converged: bool  # grad-norm tolerance reached
    trace: torch.Tensor  # (num_steps,) objective per step
    seconds: float  # wall time of the loop, host clock


def _trace(values, like):
    return torch.stack(values) if values else like.new_zeros((0,))


def minimize_lbfgs(
    fun: Callable,
    x0,
    *,
    max_steps: int = 200,
    gtol: float = 1e-6,
    memory_size: int = 10,
) -> OptResult:
    """Minimize ``fun`` over a 1-D parameter vector with
    ``torch.optim.LBFGS`` and its strong-Wolfe line search, one L-BFGS
    iteration per ``step()``."""
    t0 = time.perf_counter()
    x = torch.as_tensor(x0).detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS(
        [x], lr=1.0, max_iter=1, max_eval=1 + _LINESEARCH_STEPS, tolerance_grad=0.0,
        tolerance_change=0.0, history_size=memory_size, line_search_fn="strong_wolfe",
    )
    last = {}

    def evaluate():
        opt.zero_grad()
        with torch.enable_grad():
            v = fun(x)
            v.backward()
        last.update(x=x.detach().clone(), v=v.detach())
        return last["v"]

    def restore(x_prev, g_prev):
        with torch.no_grad():
            x.copy_(x_prev)
        x.grad = g_prev.clone()

    def step_inside(x_prev, g_prev):
        """One L-BFGS step, halving its length while the line search
        leaves the domain; False if every length left it."""
        state, group = copy.deepcopy(opt.state[x]), opt.param_groups[0]
        try:
            for i in range(_LINESEARCH_STEPS):
                group["lr"] = 0.5**i
                # step() first asks for f(x), whose gradient x.grad holds
                first = [value]
                try:
                    opt.step(lambda: first.pop() if first else evaluate())
                    return True
                except torch.linalg.LinAlgError:
                    restore(x_prev, g_prev)
                    opt.state[x] = copy.deepcopy(state)
            return False
        finally:
            group["lr"] = 1.0

    value, values, step = evaluate(), [], 0
    while step < max_steps and float(x.grad.norm()) > gtol:
        x_prev, g_prev = last["x"], x.grad.clone()
        if not step_inside(x_prev, g_prev):
            break
        if torch.equal(x.detach(), x_prev):
            # No step passed the strong-Wolfe test: near the optimum the
            # decrease sinks into the objective's rounding.  Take the full
            # L-BFGS step if it passes optax's approximate test (f rises by
            # at most 1e-6 |f|; strong curvature condition), else stop.
            d = opt.state[x]["d"]
            with torch.no_grad():
                x.add_(d)
            try:
                evaluate()
                gd0, gd1 = float(g_prev.dot(d)), float(x.grad.dot(d))
                ok = (last["v"] <= value + _APPROX_DEC_RTOL * abs(value) and gd0 < 0
                      and abs(gd1) <= _CURVATURE * abs(gd0))
            except torch.linalg.LinAlgError:
                ok = False
            if not ok:
                restore(x_prev, g_prev)
                break
        elif not torch.equal(last["x"], x.detach()):
            evaluate()  # the line search evaluated last elsewhere
        value = last["v"]
        values.append(value)
        step += 1
    return OptResult(
        params=x.detach(), value=value, num_steps=step,
        converged=float(x.grad.norm()) <= gtol, trace=_trace(values, x.detach()),
        seconds=time.perf_counter() - t0,
    )


def minimize_adam(
    fun: Callable,
    x0,
    *,
    learning_rate: float = 5e-2,
    max_steps: int = 500,
    gtol: float = 1e-6,
) -> OptResult:
    """Adam for objectives where the L-BFGS line search struggles, and the
    fixed-step training of the chain benchmark."""
    t0 = time.perf_counter()
    x = torch.as_tensor(x0).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    value = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    gnorm = float("inf")
    values = []
    step = 0
    while step < max_steps and gnorm > gtol:
        with span("gpar.step"):
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                v = fun(x)
                with span("gpar.backward"):
                    v.backward()
            value = v.detach()
            values.append(value)
            with span("gpar.update"):
                gnorm = float(x.grad.norm())
                host_sync()
                opt.step()
        step += 1
    return OptResult(
        params=x.detach(), value=value, num_steps=step, converged=gnorm <= gtol,
        trace=_trace(values, x.detach()), seconds=time.perf_counter() - t0,
    )


def multi_start(fun: Callable, x0s, *, method: str = "lbfgs", **kwargs) -> OptResult:
    """Run the optimizer from every row of ``x0s`` and return the run with
    the lowest final value (NaN values lose)."""
    minimize = minimize_lbfgs if method == "lbfgs" else minimize_adam
    results = [minimize(fun, x0, **kwargs) for x0 in torch.as_tensor(x0s)]
    finals = torch.stack([r.value.double() for r in results])
    finals = torch.where(torch.isnan(finals), torch.inf, finals)
    return results[int(torch.argmin(finals))]


class AdamState(NamedTuple):
    """Adam's state for a batch of parameter vectors: the moment estimates
    (in the parameters' shape) and the step count."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor  # () int64


def adam_init(params) -> AdamState:
    params = torch.as_tensor(params)
    return AdamState(mu=torch.zeros_like(params), nu=torch.zeros_like(params),
                     count=torch.zeros((), dtype=torch.int64))


def adam_update(grads, state: AdamState, params, learning_rate: float = 1e-2):
    """One Adam step as a function: (new params, new state).  The update of
    ``torch.optim.Adam`` (``minimize_adam``'s optimizer), in its order of
    operations, with optax's defaults (beta 0.9 / 0.999, eps 1e-8);
    elementwise, so a (C, k) batch of parameter vectors steps C independent
    chains."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    count = state.count + 1
    k = int(count)
    mu = state.mu.lerp(grads, 1.0 - b1)
    nu = state.nu * b2 + (1.0 - b2) * grads * grads
    step_size = learning_rate / (1.0 - b1**k)
    denom = nu.sqrt() / (1.0 - b2**k) ** 0.5 + eps
    return params - step_size * (mu / denom), AdamState(mu=mu, nu=nu, count=count)
