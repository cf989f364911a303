"""MCMC convergence diagnostics: split R-hat and multi-chain ESS.

A numpy copy of ``gpar_at_scale_tpu/inference/diagnostics.py`` (the port
imports nothing of the JAX package): Gelman's split R-hat (the Vehtari et
al. 2021 formulation) and the multi-chain effective sample size with Geyer's
initial-monotone-positive-sequence truncation, the quantities behind the
ESS/s metric and the Monte-Carlo-error comparisons of posteriors.

Pure numpy on the host: diagnostics are post hoc, never on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _split_chains(chains: np.ndarray) -> np.ndarray:
    """(C, S, ...) -> (2C, S//2, ...): split each chain in half."""
    C, S = chains.shape[:2]
    half = S // 2
    return np.concatenate([chains[:, :half], chains[:, half : 2 * half]], axis=0)


def split_rhat(chains) -> np.ndarray:
    """Split potential-scale-reduction factor.

    chains: (C, S) or (C, S, D).  Returns a scalar or (D,).  Values close to
    1 indicate between-chain and within-chain variances agree; the standard
    convergence bar is R-hat < 1.01.
    """
    x = np.asarray(chains, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    x = _split_chains(x)  # (2C, half, D)
    C, S, D = x.shape
    chain_mean = x.mean(axis=1)  # (2C, D)
    chain_var = x.var(axis=1, ddof=1)  # (2C, D)
    W = chain_var.mean(axis=0)
    B_over_n = chain_mean.var(axis=0, ddof=1)
    var_plus = W * (S - 1) / S + B_over_n
    rhat = np.sqrt(var_plus / np.maximum(W, 1e-300))
    return rhat[0] if squeeze and D == 1 else rhat


def _acov_fft(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance (biased /S) via FFT.  x: (C, S, D)."""
    C, S, D = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * S - 1).bit_length()
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :S].real / S
    return acov


def ess(chains) -> np.ndarray:
    """Multi-chain effective sample size (Vehtari et al. 2021 / Stan).

    chains: (C, S) or (C, S, D) -> scalar or (D,).  Combines within-chain
    autocovariances with the between-chain variance so stuck chains deflate
    the estimate, then truncates with Geyer's initial monotone positive
    sequence.
    """
    x = np.asarray(chains, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    x = _split_chains(x)
    C, S, D = x.shape
    acov = _acov_fft(x)  # (C, S, D)
    chain_var = acov[:, 0] * S / (S - 1)  # (C, D) unbiased
    mean_var = chain_var.mean(axis=0)  # W
    var_plus = mean_var * (S - 1) / S + x.mean(axis=1).var(axis=0, ddof=1)

    rho = 1.0 - (mean_var[None] - acov.mean(axis=0)) / np.maximum(var_plus[None], 1e-300)
    # pairwise sums Gamma_k = rho_{2k} + rho_{2k+1}
    m = S // 2
    gamma = rho[0 : 2 * m : 2] + rho[1 : 2 * m : 2]  # (m, D)
    out = np.empty(D)
    for d in range(D):
        g = gamma[:, d]
        # initial positive sequence
        neg = np.nonzero(g <= 0)[0]
        k = int(neg[0]) if neg.size else m
        g = g[:k]
        # monotone nonincreasing
        g = np.minimum.accumulate(g) if g.size else g
        tau = -1.0 + 2.0 * float(g.sum())
        out[d] = C * S / max(tau, 1.0 / np.log10(max(C * S, 10)))
    out = np.minimum(out, C * S * np.log10(max(C * S, 10)))
    return out[0] if squeeze and D == 1 else out


class Diagnostics(NamedTuple):
    rhat: np.ndarray  # (D,) split R-hat per dimension
    ess: np.ndarray  # (D,) multi-chain ESS per dimension
    mean: np.ndarray  # (D,) posterior mean
    mcse: np.ndarray  # (D,) Monte-Carlo standard error of the mean


def summarize(chains) -> Diagnostics:
    """One-stop convergence summary for (C, S, D) chains."""
    x = np.asarray(chains, np.float64)
    if x.ndim == 2:
        x = x[..., None]
    r = np.atleast_1d(split_rhat(x))
    e = np.atleast_1d(ess(x))
    flat = x.reshape(-1, x.shape[-1])
    sd = flat.std(axis=0, ddof=1)
    return Diagnostics(rhat=r, ess=e, mean=flat.mean(axis=0), mcse=sd / np.sqrt(e))


def means_agree_within_mc_error(chains_a, chains_b, z: float = 4.0) -> bool:
    """North-star check: posterior moments of two samplers/likelihoods agree
    within Monte-Carlo error — |mean_a - mean_b| < z * sqrt(mcse_a^2 +
    mcse_b^2) per dimension (BASELINE.md 'within MC error')."""
    da, db = summarize(chains_a), summarize(chains_b)
    tol = z * np.sqrt(da.mcse**2 + db.mcse**2)
    return bool(np.all(np.abs(da.mean - db.mean) < tol))
