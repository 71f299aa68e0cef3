"""AR(p) calcium-dynamics model estimation and kernel conversions.

Batched JAX equivalents of:
  * ``estimate_time_constant`` (autocovariance Yule-Walker solve with noise
    correction — ``OASIS_matlab/functions/estimate_time_constant.m:36-50``)
  * ``ar2exp`` / ``exp2ar`` / ``exp2kernel`` conversions
    (``OASIS_matlab/functions/ar2exp.m`` etc.)

All functions operate along the last axis and are shape-static; deterministic
root clamping replaces the reference's ``randn`` jitter of unstable roots.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.ops.noise import noise_psd


def autocovariance(y: jnp.ndarray, max_lag: int) -> jnp.ndarray:
    """Biased autocovariance for lags 0..max_lag along the last axis.

    Returns shape ``y.shape[:-1] + (max_lag + 1,)``.
    """
    T = y.shape[-1]
    yc = y - jnp.mean(y, axis=-1, keepdims=True)
    # xc[k] = sum_t yc[t+k] * yc[t] / T  (biased)
    def one_lag(k):
        a = jax.lax.dynamic_slice_in_dim(yc, k, T - max_lag, axis=-1)
        b = jax.lax.dynamic_slice_in_dim(yc, 0, T - max_lag, axis=-1)
        return jnp.sum(a * b, axis=-1) / T

    # static unroll over lags (max_lag is small, typically <= 7)
    xc = jnp.stack([one_lag(k) for k in range(max_lag + 1)], axis=-1)
    return xc


@functools.partial(jax.jit, static_argnames=("p", "lags", "g_range"))
def estimate_time_constant(
    y: jnp.ndarray,
    p: int = 1,
    sn: jnp.ndarray | None = None,
    lags: int = 5,
    fudge_factor: float = 1.0,
    g_range: Tuple[float, float] = (0.05, 0.998),
) -> jnp.ndarray:
    """Estimate AR(p) coefficients ``g`` from a fluorescence trace.

    Batched over leading axes; returns shape ``(..., p)``. Mirrors the
    reference's noise-corrected Yule-Walker solve: build the (lags x p)
    Toeplitz system from the autocovariance, subtract ``sn^2`` on the
    diagonal, least-squares solve, then clamp AR roots into ``g_range``
    (stability guard only — the reference jitters unstable roots with
    randn, ``estimate_time_constant.m:43-50``; the wide default keeps slow
    indicators like GCaMP6s at high frame rates, tau >> 20 frames, intact;
    pass a narrower range to mimic ``deconvolveCa``'s tau_range clamp).
    """
    if sn is None:
        sn = noise_psd(y)
    L = lags + p
    xc = autocovariance(y, L)  # (..., L+1), xc[...,k] = lag k

    # A[i, j] = xc[|i - j|] - sn^2 * (i == j),  i in [0,L), j in [0,p)
    i = np.arange(L)[:, None]
    j = np.arange(p)[None, :]
    lag_idx = np.abs(i - j)  # (L, p)
    A = xc[..., jnp.asarray(lag_idx)]  # (..., L, p)
    eye = jnp.asarray((i == j).astype(np.float32))
    A = A - (sn**2)[..., None, None] * eye
    b = xc[..., 1 : L + 1]  # lags 1..L

    # least squares via p x p normal equations (p <= 2)
    AtA = jnp.einsum("...lp,...lq->...pq", A, A)
    Atb = jnp.einsum("...lp,...l->...p", A, b)
    g = jnp.linalg.solve(AtA + 1e-12 * jnp.eye(p, dtype=y.dtype), Atb[..., None])[..., 0]

    # clamp roots into g_range for stability, then rebuild coefficients
    g_lo, g_hi = g_range
    if p == 1:
        r = jnp.clip(g[..., 0], g_lo, g_hi)
        r = jnp.where(jnp.isfinite(r), r, 0.8)
        return (fudge_factor * r)[..., None]
    elif p == 2:
        g1, g2 = g[..., 0], g[..., 1]
        disc = g1 * g1 + 4.0 * g2
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        r1 = (g1 + sq) / 2.0
        r2 = (g1 - sq) / 2.0
        # complex roots -> use real part (deterministic variant of reference)
        r1 = jnp.where(disc < 0, g1 / 2.0, r1)
        r2 = jnp.where(disc < 0, g1 / 2.0 * 0.5, r2)
        clamp = lambda r: jnp.where(r > 1.0, g_hi, jnp.where(r < 0.0, g_lo, r))
        r1, r2 = clamp(r1), clamp(r2)
        r1 = jnp.where(jnp.isfinite(r1), r1, 0.8)
        r2 = jnp.where(jnp.isfinite(r2), r2, 0.3)
        r1, r2 = fudge_factor * r1, fudge_factor * r2
        return jnp.stack([r1 + r2, -r1 * r2], axis=-1)
    raise NotImplementedError("p must be 1 or 2")


def ar2exp(g: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AR(2) coefficients -> (decay, rise) discrete exponential factors.

    Roots of z^2 - g1 z - g2 (reference: ``ar2exp.m``). Returns (d, r) with
    d >= r.
    """
    g1, g2 = g[..., 0], g[..., 1]
    sq = jnp.sqrt(jnp.maximum(g1 * g1 + 4.0 * g2, 1e-12))
    d = (g1 + sq) / 2.0
    r = (g1 - sq) / 2.0
    return d, r


def exp2ar(d: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """(decay, rise) factors -> AR(2) coefficients [d+r, -d*r]."""
    return jnp.stack([d + r, -d * r], axis=-1)


def ar_kernel(g: jnp.ndarray, T: int) -> jnp.ndarray:
    """Impulse response of the AR model, length T, batched over leading dims.

    AR(1): h[t] = g^t. AR(2): h[t] = (d^(t+1) - r^(t+1)) / (d - r).
    """
    t = jnp.arange(T, dtype=jnp.result_type(g, jnp.float32))
    if g.shape[-1] == 1:
        return g[..., 0:1] ** t
    d, r = ar2exp(g)
    dd = jnp.maximum(d - r, 1e-10)
    return (d[..., None] ** (t + 1) - r[..., None] ** (t + 1)) / dd[..., None]


def exp2kernel(tau_d: jnp.ndarray, tau_r: jnp.ndarray, T: int) -> jnp.ndarray:
    """Difference-of-exponentials kernel from continuous time constants
    (frames), normalized to unit max (reference: ``exp2kernel.m``)."""
    t = jnp.arange(T, dtype=jnp.float32)
    h = jnp.exp(-t / tau_d[..., None]) - jnp.exp(-t / tau_r[..., None])
    return h / jnp.maximum(jnp.max(h, axis=-1, keepdims=True), 1e-12)


def make_G_matrix(T: int, g: jnp.ndarray) -> jnp.ndarray:
    """Sparse AR-difference matrix G with G c = s (reference:
    ``utilities/make_G_matrix.m``): banded lower-triangular with 1 on the
    diagonal and -g_j on the j-th subdiagonal. Returned dense (T, T) —
    only used for small-T solver paths and tests."""
    g = jnp.atleast_1d(jnp.asarray(g))
    G = jnp.eye(T)
    for j in range(g.shape[0]):
        G = G + jnp.diag(jnp.full(T - j - 1, -g[j]), -j - 1)
    return G


def choose_smin(g: jnp.ndarray, sn: jnp.ndarray, prob: float = 0.99999) -> jnp.ndarray:
    """Minimal spike size so pure noise yields a zero solution w.p. ``prob``
    (reference: ``choose_smin.m``): smin = sn / ||h|| * norminv(prob)."""
    # ||h||^2: AR(1): 1/(1-g^2). AR(2): sum of squared kernel (static horizon).
    if g.shape[-1] == 1:
        hnorm = jnp.sqrt(1.0 / jnp.maximum(1.0 - g[..., 0] ** 2, 1e-8))
    else:
        h = ar_kernel(g, 1000)
        hnorm = jnp.sqrt(jnp.sum(h * h, axis=-1))
    # Phi^{-1}(prob) via scipy-free approximation (Acklam) is overkill: use
    # jax.scipy.stats.norm.ppf
    z = jax.scipy.stats.norm.ppf(prob)
    return sn / hnorm * z
