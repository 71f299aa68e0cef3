"""Order-statistic helpers that avoid sorts.

``jnp.median`` lowers to a full XLA sort, which costs far more than the
reductions around it (a (2000, 256, 256) frame-axis median inside
initialization above all). The medians in this codebase are used as
robust centers/thresholds (trace baselines, filtered-movie centering), so a
value-space bisection that converges to the k-th smallest element is exact
for every practical purpose (final bracket width = value range / 2^iters)
and costs only ``iters`` fused compare+count passes — no sort, no data
movement beyond streaming reads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fast_median(x: jnp.ndarray, axis: int = -1, keepdims: bool = False,
                iters: int = 30) -> jnp.ndarray:
    """Median along ``axis`` by value-space bisection.

    Converges to the ceil(n/2)-th smallest element (the lower middle for
    even n — ``jnp.median`` averages the two middles; every use here is a
    robust center/threshold where that distinction is immaterial). The
    result is within (max-min)/2^iters of that order statistic.
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    target = (n + 1) // 2
    lo = jnp.min(x, axis=axis, keepdims=True)
    hi = jnp.max(x, axis=axis, keepdims=True)
    # invariant: count(x <= hi) >= target, count(x <= lo - eps) < target
    lo = lo - jnp.maximum(1e-6, 1e-6 * jnp.abs(lo))

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(x <= mid, axis=axis, keepdims=True)
        ge = cnt >= target
        return (jnp.where(ge, lo, mid), jnp.where(ge, mid, hi))

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    out = hi
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


def submedian_mean(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Mean of the samples strictly below the median — the per-trace
    baseline estimator of ``HALS_temporal.m:79`` — without the sort.

    The set is taken as the ceil(n/2) smallest samples (``x <= hi``,
    which the bisection guarantees holds them), less the largest of them
    when n is odd: as ``x < median`` selects in the reference. Selecting
    ``x < hi`` would depend on where the bisection stops: on a calcium
    trace (sparse transients over a small noise floor, range >> 100x the
    median) it stops a few ulps from the middle sample, and a 1e-6
    relative change of x moved the baseline by up to 1e-3 relative.
    """
    n_all = x.shape[axis]
    med = fast_median(x, axis=axis, keepdims=True)
    sel = x <= med
    s = jnp.sum(jnp.where(sel, x, 0.0), axis=axis)
    n = jnp.sum(sel, axis=axis)
    if n_all % 2:
        s = s - jnp.max(jnp.where(sel, x, -jnp.inf), axis=axis)
        n = n - 1
    return s / jnp.maximum(n, 1)


def fast_median_masked(x: jnp.ndarray, mask: jnp.ndarray, axis: int = -1,
                       iters: int = 20) -> jnp.ndarray:
    """Median of the entries where ``mask`` is True, by value-space
    bisection (no sort). ``mask`` broadcasts against ``x``; rows with no
    selected entries return 0. Used where the reference takes a median
    over a masked pixel subset (``extract_ac.m:37`` background rows) — a
    ``jnp.nanmedian`` there lowers to a full sort per row."""
    x = jnp.asarray(x)
    axis = axis % x.ndim
    mask = jnp.broadcast_to(mask, x.shape)
    n = jnp.sum(mask, axis=axis, keepdims=True)
    target = (n + 1) // 2
    big = jnp.max(jnp.abs(x)) + 1.0
    xm_lo = jnp.where(mask, x, big)
    xm_hi = jnp.where(mask, x, -big)
    lo = jnp.min(xm_lo, axis=axis, keepdims=True)
    hi = jnp.max(xm_hi, axis=axis, keepdims=True)
    lo = lo - jnp.maximum(1e-6, 1e-6 * jnp.abs(lo))

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(mask & (x <= mid), axis=axis, keepdims=True)
        ge = cnt >= target
        return (jnp.where(ge, lo, mid), jnp.where(ge, mid, hi))

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    out = jnp.where(n > 0, hi, 0.0)
    return jnp.squeeze(out, axis=axis)
