"""Correlation image and peak-to-noise ratio maps.

Reference: ``utilities/correlation_image.m:38-77`` (neighbor-kernel
convolution form) and ``endoscope/correlation_image_endoscope.m:50-96``
(filtered movie + PNR). These are pure stencil + reduction ops on the
``(T, H, W)`` movie: under a pixel-sharded mesh XLA partitions them with
automatic halo exchange; the frame axis reduces with a ``psum`` when T is
sharded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.ops.filters import filter_movie, gaussian_psf, neighbor_kernel
from cnmf_e_tpu.ops.noise import noise_psd_frames
from cnmf_e_tpu.ops.stats import fast_median


def correlation_image(Y: jnp.ndarray, kernel: Optional[np.ndarray] = None,
                      center: bool = True) -> jnp.ndarray:
    """Mean correlation of each pixel with its neighbors. Y: (T, H, W).

    Equivalent to the reference's conv formulation: normalize each pixel
    trace, spatially sum neighbor traces per frame, then average the product
    with the own trace over time and divide by the neighbor count.
    """
    if kernel is None:
        kernel = neighbor_kernel(1.0, 2.0)
    if center:
        Y = Y - jnp.mean(Y, axis=0, keepdims=True)
    denom = jnp.sqrt(jnp.mean(Y * Y, axis=0, keepdims=True))
    X = Y / jnp.maximum(denom, 1e-12)

    # neighbor sum as weighted spatial shifts: the kernel is a tiny 0/1
    # stencil with no channel contraction, and the shift-adds fuse into
    # one elementwise pass
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    T, H, W = X.shape
    Xp = jnp.pad(X, ((0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    Xs = jnp.zeros_like(X)
    for dy, dx in np.argwhere(kernel != 0):
        wgt = float(kernel[dy, dx])
        Xs = Xs + wgt * jax.lax.dynamic_slice(
            Xp, (0, int(dy), int(dx)), (T, H, W))
    # in-FOV neighbor count per pixel (host-side: kernel is static)
    ones = np.zeros((H + kh - 1, W + kw - 1), np.float32)
    ones[ph:ph + H, pw:pw + W] = 1.0
    count = np.zeros((H, W), np.float32)
    for dy, dx in np.argwhere(kernel != 0):
        count += kernel[dy, dx] * ones[dy:dy + H, dx:dx + W]
    return jnp.mean(Xs * X, axis=0) / jnp.asarray(np.maximum(count, 1.0))


def correlation_pnr(Y: jnp.ndarray, gSig: float = 3.0,
                    center_psf: bool = True, noise_thresh_sig: float = 3.0
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Cn, PNR) maps of the filtered movie (reference:
    ``greedyROI_endoscope.m:104-146`` / ``correlation_image_endoscope.m``).

    1. band-pass the movie with the (center-surround) gaussian PSF
    2. median-center per pixel; PNR = max / sigma_noise
    3. zero sub-noise samples (|HY| < sig * sn) and compute the neighbor
       correlation image of the thresholded movie
    """
    psf = gaussian_psf(gSig, center_psf)
    HY = filter_movie(Y, psf)
    HY = HY - fast_median(HY, axis=0, keepdims=True)
    sn = noise_psd_frames(HY)                        # (H, W)
    pnr = jnp.max(HY, axis=0) / jnp.maximum(sn, 1e-12)
    HY_thr = jnp.where(HY >= noise_thresh_sig * sn[None], HY, 0.0)
    cn = correlation_image(HY_thr, center=False)
    cn = jnp.nan_to_num(cn)
    return cn, pnr


def local_correlation_projected(Y: jnp.ndarray, k: int = 1000,
                                key: Optional[jax.Array] = None) -> jnp.ndarray:
    """Fast Cn via random temporal projection (reference option ``K`` in
    ``correlation_image.m:38-44``): project T frames onto k gaussian random
    vectors, then compute the neighbor correlation of the projections."""
    if key is None:
        key = jax.random.PRNGKey(0)
    T = Y.shape[0]
    k = min(k, T)
    R = jax.random.normal(key, (T, k), dtype=Y.dtype) / jnp.sqrt(T)
    Yc = Y - jnp.mean(Y, axis=0, keepdims=True)
    P = jnp.einsum("thw,tk->khw", Yc, R)
    return correlation_image(P, center=False)
