"""Ring background model: per-pixel regression on a ring of neighbors.

Reference: ``endoscope/fit_ring_model.m:41-127`` loops over pixels solving a
small ridge regression of each pixel's fluctuating background ``Bf(i, :)``
on the pixels one ring-radius away (``get_nhood.m``: distance in
[radius, radius+1)), plus an intercept, with outlier clamping against the
previous prediction and frame subsampling capped at ``100 * ring_size``.

Batched re-design: every pixel has the SAME ring-offset pattern (out-of-FOV
neighbors are zero-padded, and the ridge term pins their weights to ~0, which
matches the reference's absent sparse entries). So the d independent
(R+1 x R+1) normal-equation solves become one batched pipeline:

  1. gather the ring-neighbor time series per pixel chunk -> (T', P, R)
  2. Gram matrices via one batched matmul: G = X X^T, rhs = X y
  3. batched Cholesky solve of (G + eps*tr(G)*I) w = rhs

``apply_ring`` evaluates W @ X as a sum of R weighted spatial shifts — a
stencil op that XLA SPMD partitions with automatic halo exchange when the
pixel axis is sharded.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def ring_offsets(radius: int) -> np.ndarray:
    """Pixel offsets at euclidean distance in [radius, radius+1).

    Reference: ``get_nhood.m:1-26``. Returns (R, 2) int array of (dy, dx).
    """
    r = int(np.ceil(radius)) + 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    R = np.sqrt(x**2 + y**2)
    sel = (R >= radius) & (R < radius + 1)
    return np.stack([y[sel], x[sel]], axis=1).astype(np.int32)


# ring taps summed per fused pass of apply_ring (timed on an H100)
_RING_GROUP = 8


class RingWeights(NamedTuple):
    """Per-pixel ring weights (d, R) plus intercept (d,), flattened pixels."""
    w: jnp.ndarray       # (H*W, R)
    w0: jnp.ndarray      # (H*W,)


def _neighbor_index(H: int, W: int, offsets: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat gather indices (H*W, R) into a zero-padded (H+2m)*(W+2m) frame,
    and a validity mask (H*W, R) for in-FOV neighbors."""
    m = int(np.abs(offsets).max())
    yy, xx = np.mgrid[0:H, 0:W]
    ny = yy.reshape(-1, 1) + offsets[None, :, 0]          # (d, R)
    nx = xx.reshape(-1, 1) + offsets[None, :, 1]
    valid = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
    flat = (ny + m) * (W + 2 * m) + (nx + m)
    return flat.astype(np.int32), valid


def _pad_flat(X: jnp.ndarray, H: int, W: int, m: int) -> jnp.ndarray:
    """(T, H, W) -> (T, (H+2m)*(W+2m)) zero-padded flat view."""
    Xp = jnp.pad(X, ((0, 0), (m, m), (m, m)))
    return Xp.reshape(X.shape[0], -1)


@functools.partial(jax.jit, static_argnames=("H", "W", "radius", "chunk",
                                              "intercept", "neighbor_cutoff"))
def fit_ring_weights(Bf: jnp.ndarray, H: int, W: int, radius: int,
                     ridge_eps: float = 1e-5, chunk: int = 1024,
                     mask: Optional[jnp.ndarray] = None,
                     intercept: bool = True,
                     neighbor_cutoff: float = 1.0) -> RingWeights:
    """Fit all per-pixel ring regressions. Bf: (T', H, W) (already centered,
    outlier-clamped, frame-subsampled by the caller). Returns RingWeights.

    Ridge: (X X^T + eps * tr(X X^T) * I) w = X y, identical in form to
    ``fit_ring_model.m:104``.

    ``mask``: optional (T', H, W) per-pixel sample weights — frame t
    contributes to pixel p's normal equations with weight mask[t, p]
    (``local_background.m:113-116`` excludes each pixel's own event frames
    from its fit). ``intercept=False`` drops the intercept column
    (``local_background.m`` fits w without one; w0 is returned as 0).
    ``neighbor_cutoff < 1``: keep only neighbors whose marginal slope
    Xy/diag(XX) is below that per-pixel quantile
    (``local_background.m:118-125``).
    """
    T = Bf.shape[0]
    offsets = ring_offsets(radius)
    R = offsets.shape[0]
    m = int(np.abs(offsets).max())
    idx, valid = _neighbor_index(H, W, offsets)
    d = H * W
    pad = (-d) % chunk
    idx_p = np.pad(idx, ((0, pad), (0, 0)))
    valid_p = np.pad(valid, ((0, pad), (0, 0)))
    n_chunks = (d + pad) // chunk

    Bf_flat = _pad_flat(Bf, H, W, m)                  # (T, padded_d)
    y_flat = Bf.reshape(T, -1)                        # (T, d)
    y_pad = jnp.pad(y_flat, ((0, 0), (0, pad)))

    idx_c = jnp.asarray(idx_p.reshape(n_chunks, chunk, R))
    valid_c = jnp.asarray(valid_p.reshape(n_chunks, chunk, R))

    # block the time axis so the gathered (TB, chunk, R) buffer stays small
    TB = min(512, T)
    n_tb = -(-T // TB)
    t_pad = n_tb * TB - T
    Bf_blocks = jnp.pad(Bf_flat, ((0, t_pad), (0, 0))).reshape(
        n_tb, TB, -1)
    y_blocks = jnp.pad(y_pad, ((0, t_pad), (0, 0))).reshape(n_tb, TB, -1)
    if mask is not None:
        m_pad = jnp.pad(mask.astype(Bf.dtype).reshape(T, -1),
                        ((0, 0), (0, pad)))
        m_blocks = jnp.pad(m_pad, ((0, t_pad), (0, 0))).reshape(
            n_tb, TB, -1)
    else:
        m_blocks = None

    def solve_chunk(args):
        # ic/vc: (chunk, R); yc_b (and mc_b): (n_tb, TB, chunk)
        ic, vc, yc_b, mc_b = args
        vcf = vc.astype(Bf.dtype)

        def tb_body(i, acc):
            G, sx, Xy, sy, cnt = acc
            X = Bf_blocks[i][:, ic] * vcf[None]        # (TB, chunk, R)
            yb = yc_b[i]                               # (TB, chunk)
            if mc_b is not None:
                mb = mc_b[i]                           # (TB, chunk)
                X = X * mb[:, :, None]
                yb = yb * mb
                cnt = cnt + jnp.sum(mb, axis=0)
            G = G + jnp.einsum("tpr,tps->prs", X, X,
                               preferred_element_type=jnp.float32)
            sx = sx + jnp.sum(X, axis=0)
            Xy = Xy + jnp.einsum("tpr,tp->pr", X, yb,
                                 preferred_element_type=jnp.float32)
            sy = sy + jnp.sum(yb, axis=0)
            return (G, sx, Xy, sy, cnt)

        G0 = jnp.zeros((chunk, R, R), Bf.dtype)
        sx0 = jnp.zeros((chunk, R), Bf.dtype)
        Xy0 = jnp.zeros((chunk, R), Bf.dtype)
        sy0 = jnp.zeros((chunk,), Bf.dtype)
        cnt0 = (jnp.zeros((chunk,), Bf.dtype) if mc_b is not None
                else jnp.full((chunk,), float(T), Bf.dtype))
        G, sx, Xy, sy, cnt = jax.lax.fori_loop(0, n_tb, tb_body,
                                               (G0, sx0, Xy0, sy0, cnt0))
        if neighbor_cutoff < 1.0:
            # keep neighbors with Xy/diag(XX) below the per-pixel quantile
            # (local_background.m:118-125); excluded neighbors get a unit
            # diagonal and zero rhs so their weight solves to 0.
            diag = jnp.diagonal(G, axis1=1, axis2=2)
            ratio = Xy / jnp.maximum(diag, 1e-12)
            thr = jnp.quantile(ratio, neighbor_cutoff, axis=-1,
                               keepdims=True)
            keep = (ratio <= thr).astype(Bf.dtype)
            G = G * keep[:, :, None] * keep[:, None, :] + \
                jnp.eye(R, dtype=Bf.dtype)[None] * (1.0 - keep)[:, :, None]
            Xy = Xy * keep
            sx = sx * keep
        if intercept:
            # augment with intercept row/col: [[G, sx], [sx^T, n]]
            Gfull = jnp.concatenate([
                jnp.concatenate([G, sx[:, :, None]], axis=2),
                jnp.concatenate([sx[:, None, :],
                                 jnp.maximum(cnt, 1.0)[:, None, None]],
                                axis=2)], axis=1)      # (chunk, R+1, R+1)
            rhs = jnp.concatenate([Xy, sy[:, None]], axis=1)  # (chunk, R+1)
        else:
            Gfull, rhs = G, Xy
        n_sol = Gfull.shape[-1]
        tr = jnp.trace(Gfull, axis1=1, axis2=2)
        reg = (ridge_eps * tr)[:, None, None] * jnp.eye(n_sol, dtype=Bf.dtype)
        sol = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Gfull + reg), rhs[..., None])[..., 0]
        if not intercept:
            sol = jnp.concatenate([sol, jnp.zeros((chunk, 1), Bf.dtype)],
                                  axis=1)
        return sol                                     # (chunk, R+1)

    yc_all = jnp.moveaxis(
        y_blocks.reshape(n_tb, TB, n_chunks, chunk), 2, 0)  # (nc, n_tb, TB, chunk)
    if m_blocks is not None:
        mc_all = jnp.moveaxis(
            m_blocks.reshape(n_tb, TB, n_chunks, chunk), 2, 0)
        sols = jax.lax.map(
            lambda a: solve_chunk((a[0], a[1], a[2], a[3])),
            (idx_c, valid_c, yc_all, mc_all))
    else:
        sols = jax.lax.map(
            lambda a: solve_chunk((a[0], a[1], a[2], None)),
            (idx_c, valid_c, yc_all))
    sols = sols.reshape(n_chunks * chunk, R + 1)[:d]
    valid_j = jnp.asarray(valid)
    w = jnp.where(valid_j, sols[:, :R], 0.0)
    return RingWeights(w=w, w0=sols[:, R])


@functools.partial(jax.jit, static_argnames=("H", "W", "radius",
                                             "include_intercept"))
def apply_ring(weights: RingWeights, X: jnp.ndarray, H: int, W: int,
               radius: int, include_intercept: bool = True) -> jnp.ndarray:
    """Evaluate the ring prediction W @ X (+ w0). X: (T, H, W) -> (T, H, W).

    Implemented as a sum of R weighted spatial shifts (stencil form): when
    H is sharded across the mesh, XLA performs the halo exchange
    automatically. The shifts are summed in groups of ``_RING_GROUP``,
    each group one fused pass over the movie: left to itself XLA splits
    the R-term sum into many fusions with movie-sized intermediates.
    """
    offsets = ring_offsets(radius)
    m = int(np.abs(offsets).max())
    T = X.shape[0]
    Xp = jnp.pad(X, ((0, 0), (m, m), (m, m)))
    w_rhw = weights.w.T.reshape(-1, H, W)              # one plane per tap
    out = jnp.zeros_like(X)
    if include_intercept:
        out = out + weights.w0.reshape(1, H, W)
    for g0 in range(0, len(offsets), _RING_GROUP):
        part = None
        for r in range(g0, min(g0 + _RING_GROUP, len(offsets))):
            dy, dx = int(offsets[r, 0]), int(offsets[r, 1])
            shifted = jax.lax.slice(Xp, (0, m + dy, m + dx),
                                    (T, m + dy + H, m + dx + W))
            term = w_rhw[r][None] * shifted
            part = term if part is None else part + term
        # the barrier closes the group's fusion
        out = jax.lax.optimization_barrier(out + part)
    return out


def fit_ring_model(Y: jnp.ndarray, A: jnp.ndarray, C: jnp.ndarray,
                   radius: int, W_old: Optional[RingWeights] = None,
                   sn: Optional[jnp.ndarray] = None,
                   thresh_outlier: float = 10.0,
                   frame_cap_factor: int = 100,
                   ridge_eps: float = 1e-5,
                   ssub: int = 1
                   ) -> Tuple[RingWeights, jnp.ndarray, jnp.ndarray]:
    """Full ring-background fit (reference: ``fit_ring_model.m:41-127``).

    Y: (T, H, W) raw movie; A: (K, H, W); C: (K, T).
    Returns (weights, b0 (H, W), Bf (T', H, W) subsampled centered residual).

      b0 = mean(Y) - A @ mean(C)                      (fit_ring_model.m:41-44)
      Bf = (Y - mean(Y)) - A (C - mean(C))
      outlier clamp at W_old(Bf) + thresh_outlier*sn  (fit_ring_model.m:50-56)
      frame stride-subsample to 100 * ring size       (fit_ring_model.m:58-91)
    """
    T, H, W = Y.shape
    Ymean = jnp.mean(Y, axis=0)
    Cmean = jnp.mean(C, axis=-1)
    b0 = Ymean - jnp.einsum("khw,k->hw", A, Cmean)
    Cc = C - Cmean[:, None]
    Bf = (Y - Ymean[None]) - jnp.einsum("khw,kt->thw", A, Cc)

    # bg_ssub: fit the ring on a spatially downsampled grid
    # (initComponents_parallel.m:206-276 builds the ring graph at bg_ssub)
    Hs, Ws, radius_s = _ssub_geometry(H, W, radius, ssub)
    if ssub > 1:
        from cnmf_e_tpu.ops.filters import box_downsample
        Bf = box_downsample(Bf, ssub=ssub)

    if W_old is not None and sn is not None and np.isfinite(thresh_outlier):
        sn_s = sn
        if ssub > 1:
            from cnmf_e_tpu.ops.filters import box_downsample
            sn_s = box_downsample(sn[None], ssub=ssub)[0]
        pred = apply_ring(W_old, Bf, Hs, Ws, radius_s,
                          include_intercept=False)
        clamp = Bf > pred + thresh_outlier * sn_s[None]
        Bf = jnp.where(clamp, pred, Bf)

    R = ring_offsets(radius_s).shape[0]
    nmax = frame_cap_factor * R
    if T > nmax:
        stride = int(np.ceil(T / nmax))
        Bf_fit = Bf[::stride]
    else:
        Bf_fit = Bf
    weights = fit_ring_weights(Bf_fit, Hs, Ws, radius_s,
                               ridge_eps=ridge_eps)
    return weights, b0, Bf_fit


def local_background(Y: jnp.ndarray, radius: int,
                     sn: Optional[jnp.ndarray] = None,
                     thresh: float = 3.0, ssub: int = 1,
                     neighbor_cutoff: float = 1.0,
                     ridge_eps: float = 1e-5
                     ) -> Tuple[jnp.ndarray, RingWeights, jnp.ndarray]:
    """Event-masked ring background estimator (reference:
    ``endoscope/local_background.m:66-138``; the ``lle.m:54-90`` variant is
    the same regression without the event mask).

    Unlike :func:`fit_ring_model` this needs NO neuron model (A, C): the
    movie is centered to per-pixel mean 1, samples whose deviation from the
    ring average exceeds ``thresh * sn`` are flagged as calcium events,
    replaced by the ring average AND excluded from that pixel's normal
    equations (``local_background.m:71-75,113-116``), and the per-pixel
    ring regression (no intercept) is fit on the cleaned movie. The fitted
    weights predict the background for all frames; the DC offset is
    restored from the movie mean (``local_background.m:148-150``).

    Y: (T, H, W). Returns (Yest (T, H, W), weights, b0 (H, W)).
    """
    T, H, W = Y.shape
    Ymean = jnp.mean(Y, axis=0)
    Yc = Y - Ymean[None] + 1.0

    Hs, Ws, radius_s = _ssub_geometry(H, W, radius, ssub)
    if ssub > 1:
        from cnmf_e_tpu.ops.filters import box_downsample
        Yc_s = box_downsample(Yc, ssub=ssub)
        sn_s = (box_downsample(sn[None], ssub=ssub)[0]
                if sn is not None else None)
    else:
        Yc_s, sn_s = Yc, sn
    if sn_s is None:
        from cnmf_e_tpu.ops.noise import noise_psd
        from cnmf_e_tpu.ops.noise import noise_psd_frames
        sn_s = noise_psd_frames(Yc_s)

    # ring average via a uniform ring operator (the annulus imfilter,
    # local_background.m:66-70)
    offsets = ring_offsets(radius_s)
    _, valid = _neighbor_index(Hs, Ws, offsets)
    n_valid = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    w_unif = RingWeights(
        w=jnp.asarray(valid / n_valid, Yc_s.dtype),
        w0=jnp.zeros((Hs * Ws,), Yc_s.dtype))
    Yconv = apply_ring(w_unif, Yc_s, Hs, Ws, radius_s,
                       include_intercept=False)
    event = (Yc_s - Yconv) > thresh * sn_s[None]
    Yfit = jnp.where(event, Yconv, Yc_s)

    weights = fit_ring_weights(Yfit, Hs, Ws, radius_s, ridge_eps=ridge_eps,
                               mask=(~event), intercept=False,
                               neighbor_cutoff=neighbor_cutoff)
    Yest_s = apply_ring(weights, Yfit, Hs, Ws, radius_s,
                        include_intercept=False)
    if ssub > 1:
        Yest = jax.image.resize(Yest_s, (T, H, W), method="linear")
    else:
        Yest = Yest_s
    b0 = Ymean - jnp.mean(Yest, axis=0)
    return Yest + b0[None], weights, b0


def _ssub_geometry(H: int, W: int, radius: int, ssub: int):
    if ssub <= 1:
        return H, W, radius
    Hs, Ws = -(-H // ssub), -(-W // ssub)
    return Hs, Ws, max(int(round(radius / ssub)), 1)


def reconstruct_ring_background(weights: RingWeights, Y: jnp.ndarray,
                                A: jnp.ndarray, C: jnp.ndarray,
                                b0: jnp.ndarray, radius: int,
                                ssub: int = 1) -> jnp.ndarray:
    """B = W (Y - b0 - A C) + w0 + b0 (reference:
    ``Sources2D.m:1247-1355`` reconstruct_background; with bg_ssub the
    ring prediction happens on the coarse grid and upsamples bilinearly)."""
    T, H, W = Y.shape
    X = Y - b0[None] - jnp.einsum("khw,kt->thw", A, C)
    if ssub <= 1:
        return apply_ring(weights, X, H, W, radius) + b0[None]
    from cnmf_e_tpu.ops.filters import box_downsample
    Hs, Ws, radius_s = _ssub_geometry(H, W, radius, ssub)
    Xs = box_downsample(X, ssub=ssub)
    Bs = apply_ring(weights, Xs, Hs, Ws, radius_s)
    B = jax.image.resize(Bs, (T, H, W), method="linear")
    return B + b0[None]
