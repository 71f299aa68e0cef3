"""Spatial filtering kernels (gaussian / center-surround PSF).

Reference: ``greedyROI_endoscope.m:104-127`` builds a gaussian PSF
(``fspecial('gaussian', ceil(gSig*4+1), gSig)``); with ``center_psf`` the
PSF is restricted to its central disc and mean-subtracted over that disc
(an annulus-subtracted matched filter that cancels the locally-constant 1p
background). Filtering uses replicate (edge) padding.

Movies are laid out ``(T, H, W)``; the stencil runs as one conv
(:func:`filter_movie`), which SPMD partitions with a halo exchange when H
is sharded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_psf(gSig: float, center_psf: bool = True,
                 size: int | None = None) -> np.ndarray:
    """Build the (possibly center-surround) PSF as a host-side numpy array."""
    if gSig <= 0:
        return np.ones((1, 1), np.float32)
    if size is None:
        size = int(np.ceil(gSig * 4 + 1))
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1][:, :size, :size]
    psf = np.exp(-(x**2 + y**2) / (2.0 * gSig**2))
    psf /= psf.sum()
    if center_psf:
        # central disc = pixels whose value >= the max of the first column
        ind = psf >= psf[:, 0].max()
        psf = psf - psf[ind].mean()
        psf[~ind] = 0.0
    return psf.astype(np.float32)


def filter_movie(Y: jnp.ndarray, psf: np.ndarray) -> jnp.ndarray:
    """2-D filter each frame of ``Y (T, H, W)`` with replicate padding.

    One single-channel conv (CONVOLUTION with ``psf``, i.e. correlation
    with the flipped psf; only visible for asymmetric kernels). On an H100
    at gSig 3 / gSiz 13 over 256x256x2000 the cuDNN conv runs in full f32
    and is faster than separable banded matmuls at the same precision.
    """
    if psf.shape == (1, 1):
        return Y * float(psf[0, 0])
    kh, kw = psf.shape
    ph, pw = kh // 2, kw // 2
    Yp = jnp.pad(Y, ((0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw)),
                 mode="edge")
    lhs = Yp[:, None, :, :]                         # NCHW, C=1
    rhs = jnp.asarray(psf[::-1, ::-1].copy())[None, None]  # OIHW (correlation)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)
    return out[:, 0]


def neighbor_kernel(dmin: float = 1.0, dmax: float = 2.0) -> np.ndarray:
    """Ring-of-neighbors indicator kernel (reference:
    ``correlation_image.m:57-70``): pixels at distance in [dmin, dmax)."""
    r = int(np.ceil(dmax)) - 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    R = np.sqrt(x**2 + y**2)
    return ((R >= dmin) & (R < dmax)).astype(np.float32)


def box_downsample(Y: jnp.ndarray, ssub: int = 1, tsub: int = 1) -> jnp.ndarray:
    """Spatio-temporal box down-sampling of a (T, H, W) movie (reference:
    ``dsData.m:33-43``); trailing remainders are averaged into the last bin."""
    T, H, W = Y.shape
    if ssub > 1:
        Hs, Ws = -(-H // ssub), -(-W // ssub)
        pad_h, pad_w = Hs * ssub - H, Ws * ssub - W
        Yp = jnp.pad(Y, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        Y = Yp.reshape(T, Hs, ssub, Ws, ssub).mean(axis=(2, 4))
    if tsub > 1:
        Ts = T // tsub
        Y = Y[: Ts * tsub].reshape(Ts, tsub, *Y.shape[1:]).mean(axis=1)
    return Y


def spatial_upsample(A: jnp.ndarray, ssub: int, out_hw) -> jnp.ndarray:
    """Nearest/bilinear upsample of footprints (K, Hs, Ws) -> (K, H, W)."""
    if ssub == 1:
        return A
    K = A.shape[0]
    return jax.image.resize(A, (K, out_hw[0], out_hw[1]), method="linear")
