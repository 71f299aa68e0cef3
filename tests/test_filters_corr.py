import numpy as np
import jax.numpy as jnp

from cnmf_e_tpu.ops.corr import correlation_image, correlation_pnr
from cnmf_e_tpu.ops.filters import (box_downsample, filter_movie,
                                    gaussian_psf, neighbor_kernel)
from cnmf_e_tpu.utils.simulate import simulate_movie


def test_gaussian_psf_properties():
    psf = gaussian_psf(3.0, center_psf=False)
    assert psf.shape == (13, 13)
    np.testing.assert_allclose(psf.sum(), 1.0, rtol=1e-5)
    psf_cs = gaussian_psf(3.0, center_psf=True)
    # center-surround: zero mean over its support (background rejection)
    support = psf_cs != 0
    np.testing.assert_allclose(psf_cs[support].mean(), 0.0, atol=1e-7)


def test_filter_movie_constant_invariance():
    # center-surround PSF must cancel a spatially-constant background
    Y = jnp.ones((3, 32, 32)) * 5.0
    out = filter_movie(Y, gaussian_psf(3.0, center_psf=True))
    np.testing.assert_allclose(np.asarray(out[:, 8:-8, 8:-8]), 0.0, atol=1e-5)


def test_neighbor_kernel_8():
    k = neighbor_kernel(1.0, 2.0)
    assert k.shape == (3, 3)
    assert k[1, 1] == 0
    assert k.sum() == 8


def test_correlation_image_detects_coherent_pixels(rng):
    T, H, W = 500, 24, 24
    noise = rng.standard_normal((T, H, W)).astype(np.float32)
    sig = rng.standard_normal(T).astype(np.float32)
    Y = noise.copy()
    # a coherent 4x4 patch
    Y[:, 8:12, 8:12] += 3.0 * sig[:, None, None]
    cn = np.asarray(correlation_image(jnp.asarray(Y)))
    assert cn[9:11, 9:11].min() > 0.5
    assert abs(cn[:4, :4]).max() < 0.25


def test_correlation_pnr_on_synthetic_movie():
    gt = simulate_movie(seed=1, H=48, W=48, T=400, K=6, sn=0.05,
                        bg_strength=0.5)
    cn, pnr = correlation_pnr(jnp.asarray(gt.Y), gSig=3.0, center_psf=True)
    cn, pnr = np.asarray(cn), np.asarray(pnr)
    centers = np.round(gt.centers).astype(int)
    # neuron centers should be local Cn/PNR hotspots vs the median pixel
    cn_at = np.array([cn[r, c] for r, c in centers])
    assert np.median(cn_at) > np.median(cn) + 0.2
    pnr_at = np.array([pnr[r, c] for r, c in centers])
    assert np.median(pnr_at) > 2 * np.median(pnr)


def test_box_downsample():
    Y = jnp.arange(2 * 8 * 8, dtype=jnp.float32).reshape(2, 8, 8)
    out = box_downsample(Y, ssub=2, tsub=2)
    assert out.shape == (1, 4, 4)
    np.testing.assert_allclose(float(out[0, 0, 0]),
                               np.mean([[0, 1], [8, 9]]) + 32.0)


def test_filter_movie_mxu_matches_conv(rng):
    """The conv stencil (the one filter path) equals a float64 per-frame
    convolution with replicate edges, for gaussian, center-surround and
    asymmetric PSFs."""
    from scipy import ndimage
    Y = rng.standard_normal((7, 40, 56)).astype(np.float32)
    asym = rng.standard_normal((5, 7)).astype(np.float32)
    for psf in (gaussian_psf(2.0, False), gaussian_psf(2.5, True), asym):
        ref = np.stack([ndimage.convolve(f.astype(np.float64),
                                         psf.astype(np.float64),
                                         mode="nearest") for f in Y])
        out = np.asarray(filter_movie(jnp.asarray(Y), psf))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
