"""The distributed update step's implicit-background algebra.

The step never materializes Ysig = Y - B; it decomposes both HALS Grams
through the linearity of the ring operator (parallel/step.py). These tests
pin that algebra to the explicit formulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.ops.hals import hals_spatial, hals_temporal
from cnmf_e_tpu.ops.noise import noise_psd
from cnmf_e_tpu.ops.oasis import foopsi_ar1
from cnmf_e_tpu.ops.ring import RingWeights, apply_ring, ring_offsets
from cnmf_e_tpu.parallel.step import StepState, make_update_step


@pytest.fixture(scope="module")
def problem():
    H = W = 32
    T = 96
    K = 8
    radius = 4
    R = ring_offsets(radius).shape[0]
    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.standard_normal((T, H, W)) * 0.1 + 1.0, jnp.float32)
    A = np.zeros((K, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for k in range(K):
        cy, cx = rng.uniform(6, H - 6), rng.uniform(6, W - 6)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
    A[A < 1e-4] = 0
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    w = rng.standard_normal((H * W, R)).astype(np.float32) * 0.01 + 1.0 / R
    st = StepState(
        A=jnp.asarray(A), C=jnp.asarray(C),
        C_raw=jnp.zeros((K, T), jnp.float32),
        S=jnp.zeros((K, T), jnp.float32),
        g=jnp.full((K,), 0.9, jnp.float32),
        b0=jnp.ones((H, W), jnp.float32),
        ring_w=jnp.asarray(w), ring_w0=jnp.zeros((H * W,), jnp.float32))
    return H, W, T, K, radius, Y, st


def _explicit_reference(H, W, T, K, radius, Y, st, mask=None, st_bg=None):
    """The literal formulation: materialize B (frozen at ``st_bg``, default
    ``st`` — the reference's A_prev/C_prev snapshot) and Ysig, then
    HALS+deconv from ``st``."""
    st_bg = st_bg or st
    weights = RingWeights(w=st_bg.ring_w, w0=st_bg.ring_w0)
    X = Y - st_bg.b0[None] - jnp.einsum("khw,kt->thw", st_bg.A, st_bg.C)
    B = apply_ring(weights, X, H, W, radius) + st_bg.b0[None]
    Ysig = Y - B
    Yd = Ysig.reshape(T, H * W).T
    Ad = st.A.reshape(K, H * W).T
    Ad2 = hals_spatial(Yd, Ad, st.C, mask=mask, n_iter=1)
    C_raw, _ = hals_temporal(Yd, Ad2, st.C, n_iter=1)
    from cnmf_e_tpu.ops.stats import submedian_mean
    C_raw = C_raw - submedian_mean(C_raw, axis=-1)[:, None]
    res = foopsi_ar1(C_raw, st.g, smin=-3.0, sn=noise_psd(C_raw),
                     optimize_b=False)
    return Ad2, C_raw, res.c


def test_dense_step_matches_explicit_ysig(problem):
    H, W, T, K, radius, Y, st = problem
    Ad2, C_raw, c = _explicit_reference(H, W, T, K, radius, Y, st)
    step = make_update_step(None, H, W, T, radius=radius, n_hals=1)
    out = step(Y, st)
    np.testing.assert_allclose(out.A.reshape(K, -1).T, Ad2, atol=2e-4)
    np.testing.assert_allclose(out.C_raw, C_raw, atol=2e-3)
    np.testing.assert_allclose(out.C, c, atol=5e-3)


def test_split_projection_iteration_matches_fused(problem):
    """proj + iterate (the amortized pipeline form) == the fused step."""
    from cnmf_e_tpu.parallel.step import (
        make_bg_projection, make_hals_iteration)
    H, W, T, K, radius, Y, st = problem
    fused = make_update_step(None, H, W, T, radius=radius, n_hals=1)
    proj = make_bg_projection(None, H, W, T, radius=radius)
    iterate = make_hals_iteration(None, H, W, T, radius=radius, n_hals=1)
    ref = fused(Y, st)
    Pm = proj(Y, st)
    out = iterate(Pm, st)
    np.testing.assert_allclose(out.A, ref.A, atol=1e-6)
    np.testing.assert_allclose(out.C, ref.C, atol=1e-6)
    # chaining keeps B FROZEN at projection time (the reference's
    # A_prev/C_prev snapshot): a second iterate() on the same projection
    # equals the explicit frozen-B formulation started from `out`
    out2 = iterate(Pm, out)
    Ad_ref, Craw_ref, c_ref = _explicit_reference(
        H, W, T, K, radius, Y, out._replace(), st_bg=st)
    # 4e-3: the step's bf16-emulated Grams + blocked sweep associate
    # differently from the explicit f32 formulation
    np.testing.assert_allclose(out2.C_raw, Craw_ref, atol=4e-3)


def test_chained_block_matches_sequential_calls(problem):
    """chain=N inside one program == N sequential iterate() dispatches."""
    from cnmf_e_tpu.parallel.step import (
        make_bg_projection, make_hals_iteration)
    H, W, T, K, radius, Y, st = problem
    proj = make_bg_projection(None, H, W, T, radius=radius)
    it1 = make_hals_iteration(None, H, W, T, radius=radius, n_hals=1)
    it3 = make_hals_iteration(None, H, W, T, radius=radius, n_hals=1,
                              chain=3)
    Pm = proj(Y, st)
    ref = st
    for _ in range(3):
        ref = it1(Pm, ref)
    out = it3(Pm, st)
    np.testing.assert_allclose(out.A, ref.A, atol=1e-5)
    np.testing.assert_allclose(out.C, ref.C, atol=1e-4)
    np.testing.assert_allclose(out.S, ref.S, atol=1e-4)


def test_bf16_grams_match_f32(problem):
    """gram_dtype='bfloat16' (an explicit opt-in) tracks the f32
    step closely: P is a centered fluctuation movie, so bf16 operands with
    f32 accumulation cost <1% relative error on the HALS updates."""
    H, W, T, K, radius, Y, st = problem
    f32 = make_update_step(None, H, W, T, radius=radius, n_hals=1,
                           gram_dtype="float32")
    bf16 = make_update_step(None, H, W, T, radius=radius, n_hals=1,
                            gram_dtype="bfloat16")
    ref = f32(Y, st)
    out = bf16(Y, st)
    ra = np.asarray(ref.A)
    scale_a = np.abs(ra).max()
    np.testing.assert_allclose(np.asarray(out.A), ra,
                               atol=0.01 * scale_a)
    rc = np.asarray(ref.C_raw)
    np.testing.assert_allclose(np.asarray(out.C_raw), rc,
                               atol=0.02 * np.abs(rc).max())
