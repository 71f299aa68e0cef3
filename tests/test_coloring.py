"""Overlap-graph coloring for the colored HALS update.

The colored update is the reference's independent-set trick
(``utilities/update_order.m:1-21``) recast for the fused sweeps: rows
ordered so pairwise-independent neurons share a sweep step, which then
updates vectorized (the kernel's class schedule is pinned in
tests/test_pallas_hals.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.ops.coloring import (color_order, greedy_color,
                                 overlap_adjacency)
from cnmf_e_tpu.ops.hals import hals_spatial_sweeps


def _compact_problem(seed=0, H=28, W=28, K=21, T=90, rad=3):
    """Footprints with genuinely compact (truncated) support so disjoint
    pairs exist — the structure the colored path exploits."""
    rng = np.random.default_rng(seed)
    d = H * W
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, d), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(3, H - 3), rng.uniform(3, W - 3)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
        blob[(np.abs(yy - cy) > rad) | (np.abs(xx - cx) > rad)] = 0.0
        A[k] = blob.ravel()
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    Y = (A.T @ C + 0.05 * rng.standard_normal((d, T))).astype(np.float32)
    Cc = C - C.mean(1, keepdims=True)
    U = (Cc @ Y.T).astype(np.float32)                  # (K, d) row-major
    V = (Cc @ Cc.T).astype(np.float32)
    return U, V, A, C


def test_greedy_color_is_proper():
    rng = np.random.default_rng(1)
    K = 40
    adj = rng.random((K, K)) < 0.15
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    colors = np.asarray(greedy_color(jnp.asarray(adj)))
    ii, jj = np.nonzero(adj)
    assert np.all(colors[ii] != colors[jj]), "adjacent rows share a color"
    assert colors.max() <= adj.sum(1).max(), "exceeds max_degree + 1 bound"


def test_color_order_roundtrip():
    rng = np.random.default_rng(2)
    adj = rng.random((17, 17)) < 0.2
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    order, inverse = color_order(jnp.asarray(adj))
    x = rng.standard_normal((17, 5)).astype(np.float32)
    xp = np.asarray(jnp.asarray(x)[order])
    np.testing.assert_array_equal(np.asarray(jnp.asarray(xp)[inverse]), x)
    colors = np.asarray(greedy_color(jnp.asarray(adj)))[np.asarray(order)]
    assert np.all(np.diff(colors) >= 0), "order not sorted by color"


def test_overlap_adjacency_matches_supports():
    _, _, A, _ = _compact_problem()
    adj = np.asarray(overlap_adjacency(jnp.asarray(A)))
    S = A > 0
    want = (S @ S.T) > 0
    np.fill_diagonal(want, False)
    np.testing.assert_array_equal(adj, want)
    assert not adj.all(), "compact problem must have non-overlapping pairs"


def test_colored_iteration_matches_explicit():
    """make_hals_iteration(colored=True) == explicit masked sequential
    sweeps over the same (color-sorted) ordering, un-permuted."""
    from cnmf_e_tpu.ops.hals import hals_temporal_sweeps
    from cnmf_e_tpu.ops.morphology import search_locations_dilate
    from cnmf_e_tpu.ops.ring import ring_offsets
    from cnmf_e_tpu.ops.stats import submedian_mean
    from cnmf_e_tpu.parallel.step import (StepState, make_bg_projection,
                                          make_hals_iteration)

    H = W = 32
    T, K, radius = 64, 12, 4
    R = ring_offsets(radius).shape[0]
    rng = np.random.default_rng(5)
    Y = jnp.asarray(rng.standard_normal((T, H, W)) * 0.1 + 1.0, jnp.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(5, H - 5), rng.uniform(5, W - 5)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
        blob[blob < 1e-3] = 0.0
        A[k] = blob
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    st = StepState(
        A=jnp.asarray(A), C=jnp.asarray(C),
        C_raw=jnp.zeros((K, T), jnp.float32),
        S=jnp.zeros((K, T), jnp.float32),
        g=jnp.full((K,), 0.9, jnp.float32),
        b0=jnp.ones((H, W), jnp.float32),
        ring_w=jnp.full((H * W, R), 0.01, jnp.float32),
        ring_w0=jnp.zeros((H * W,), jnp.float32))

    proj = make_bg_projection(None, H, W, T, radius)
    it = make_hals_iteration(None, H, W, T, radius, n_hals=1,
                             colored=True, mask_dilate=2)
    out = it(proj(Y, st), st)

    # explicit reference: same masks, same color order, sequential sweeps
    Ysig = np.asarray(proj(Y, st).P, np.float32).reshape(T, -1)
    M = search_locations_dilate(st.A, radius=2).reshape(K, -1)
    order, inverse = color_order(overlap_adjacency(M))
    order = np.asarray(order)
    Ar = jnp.asarray(A.reshape(K, -1))[order]
    Cp = jnp.asarray(C)[order]
    Mp = M[jnp.asarray(order)]
    Cc = Cp - Cp.mean(1, keepdims=True)
    V = Cc @ Cc.T
    U = Cc @ jnp.asarray(Ysig)
    A2 = hals_spatial_sweeps(U.T, V, Ar.T, mask=Mp.T, n_iter=1,
                             use_pallas=False).T
    Vt = A2 @ A2.T
    Ut = A2 @ jnp.asarray(Ysig).T
    Craw = hals_temporal_sweeps(Ut, Vt, Cp, n_iter=1, use_pallas=False)
    Craw = Craw - submedian_mean(Craw, axis=-1)[:, None]
    inv = np.asarray(inverse)
    np.testing.assert_allclose(np.asarray(out.A).reshape(K, -1),
                               np.asarray(A2)[inv], atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.C_raw),
                               np.asarray(Craw)[inv], atol=2e-3)
