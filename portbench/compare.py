"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out from the same inputs.

Training (per checked fit): each of the first steps' loss, the first
gradient as the optimizer got it, and the change of the parameters over
the first steps, the last two by the worst leaf (each log-parameter is a
leaf): the gap between the program's and the reference's magnitude, over
the reference's magnitude of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
q(u) by the posterior of the pseudo-point values u it implies.

Serving (per checked batch): the predictive means in units of the
reference's predictive sd, by their root mean square over the batch (the
widest of them is float32's rounding through the program's splice of the
test times, which the control's TF32 does not exceed), and the variances
relative to the reference's; once per run, the cached q(u) as in training.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=F64), torch.as_tensor(b, dtype=F64)
    return float(((a - b).abs() / b.abs()).max())


def worst_leaf(prog, ref, keep=None) -> float:
    """max over leaves of ||prog_i| - |ref_i|| / max(|ref_i|, median |ref|)."""
    p = torch.as_tensor(prog, dtype=F64).cpu().abs()
    r = torch.as_tensor(ref, dtype=F64).cpu().abs()
    scale = torch.maximum(r, r.median())
    gap = (p - r).abs() / scale
    if keep is not None:
        gap = gap[torch.as_tensor(keep)]
    return float(gap.max()) if gap.numel() else 0.0


def quiet_leaves(grad) -> torch.Tensor:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off)."""
    g = torch.as_tensor(grad, dtype=F64).cpu().abs()
    return g >= 1e-3 * g.median()


def u_posterior(m_eps, L_D, L_uu):
    """(mean, marginal variances) of u = L_uu eps, eps ~ N(m_eps, D^-1),
    D = L_D L_D', from the whitened factors a program reports."""
    m_eps, L_D, L_uu = (x.to(F64) for x in (m_eps, L_D, L_uu))
    B = torch.linalg.solve_triangular(L_D, L_uu.T, upper=False)  # L_D^-1 L_uu'
    return L_uu @ m_eps, (B * B).sum(0)


def train_numbers(losses, grads, params, u_mean, u_var, ref_traj, ref_u, steps: int) -> dict:
    """Gaps of one fit.  ``losses``, ``grads``: the program's at x_0 ..
    x_{steps-1}; ``params``: its x_0 .. x_steps; ``u_mean``, ``u_var``: the
    u posterior of its q(u) at its final parameters; ``ref_traj`` the
    reference's Adam from x_0 and ``ref_u`` its q(u) at those parameters."""
    loss_gap = max(rel(losses[k], ref_traj.losses[k]) for k in range(steps))
    grad_gap = worst_leaf(grads[0], ref_traj.grads[0])
    d_prog = params[steps].double().cpu() - params[0].double().cpu()
    d_ref = ref_traj.params[steps].cpu() - ref_traj.params[0].cpu()
    change_gap = worst_leaf(d_prog, d_ref, quiet_leaves(ref_traj.grads[0]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "qu_gap": qu_gap(u_mean, u_var, *ref_u)}


def qu_gap(u_mean, u_var, ref_mean, ref_var) -> float:
    """q(u) by the posterior of u it implies: the mean by its norm, the
    marginal variances by the worst entry."""
    u_mean, u_var, ref_mean, ref_var = (x.double().cpu() for x in (u_mean, u_var, ref_mean, ref_var))
    return max(float((u_mean - ref_mean).norm() / ref_mean.norm()), rel(u_var, ref_var))


def serve_numbers(mean, var, ref_mean, ref_var) -> dict:
    """One batch (draws, test times): the root mean square of the means'
    gaps in units of the reference's sd, and the variances' widest gap
    relative to the reference's."""
    sd = ref_var.clamp_min(0).sqrt()
    return {"mean_rms_gap": float(((mean.double() - ref_mean) / sd).pow(2).mean().sqrt()),
            "var_gap": float(((var.double() - ref_var).abs() / ref_var.abs()).max())}


def worst(dicts) -> dict:
    """Each number's largest reading over several checked pieces of work
    (NaN wins)."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            cur = out.get(k)
            out[k] = v if cur is None or not (v <= cur) else cur
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is finite and within its limit."""
    return all(numbers.get(k) is not None and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
