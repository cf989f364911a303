"""P-output chained synthetic series, made from a seed with numpy.

A copy of ``make_chain_data`` in ``benchmarks/chain_scale.py`` (the JAX
package's 16-output, N = 1e6 chain benchmark), so that the port makes the
same data without importing the JAX side.  y_1 is purely temporal; output
i >= 2 is a nonlinear function of the previous output and of y_1 plus its own
temporal component.  The latent truth is chained on noise-free values and
every output adds iid observation noise of standard deviation ``sn``.
"""

from __future__ import annotations

import numpy as np


def make_chain_data(N, N_star, P, rng, sn=0.25):
    """Returns (t (N,), Y (N, P), t_star (N*,), latent truth at t_star
    (N*, P), sn).  ``rng`` is a ``numpy.random.Generator``; the draws are
    made in the same order as the JAX benchmark's, so one seed gives the
    same data in both."""
    t_all = np.sort(rng.uniform(0.0, (N + N_star) / 1000.0, size=N + N_star))
    idx = rng.permutation(N + N_star)
    test_idx = np.sort(idx[:N_star])
    train_idx = np.sort(idx[N_star:])
    t, t_star = t_all[train_idx], t_all[test_idx]

    w1 = 1.0 + 0.31 * np.arange(P)
    w2 = 0.17 + 0.059 * np.arange(P)
    amp = 0.8 - 0.3 * np.arange(P) / P

    def f_t(i, tv):
        return amp[i] * np.sin(w1[i] * tv) * np.cos(w2[i] * tv)

    def chain(tv, n_pts, noise):
        lat = np.zeros((n_pts, P))
        obs = np.zeros((n_pts, P))
        lat[:, 0] = f_t(0, tv)
        obs[:, 0] = lat[:, 0] + sn * noise[:, 0]
        for i in range(1, P):
            lat[:, i] = 0.55 * np.tanh(lat[:, i - 1]) + 0.35 * np.sin(1.3 * lat[:, 0]) + f_t(i, tv)
            obs[:, i] = lat[:, i] + sn * noise[:, i]
        return lat, obs

    _, Y = chain(t, N, rng.normal(size=(N, P)))
    lat_star, _ = chain(t_star, N_star, np.zeros((N_star, P)))
    return t, Y, t_star, lat_star, sn
