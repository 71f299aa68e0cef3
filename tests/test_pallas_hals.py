"""Fused Pallas HALS sweeps (Triton route, interpret mode) vs the XLA
blocked path and the float64 Gauss-Seidel oracle (HALS_spatial.m:26-46
semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.ops.hals import hals_spatial_sweeps, hals_temporal_sweeps
from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas


def _problem(seed=0, d=400, K=24, T=150):
    rng = np.random.default_rng(seed)
    A = np.maximum(rng.standard_normal((d, K)), 0).astype(np.float32)
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    Y = (A @ C + 0.1 * rng.standard_normal((d, T))).astype(np.float32)
    Cc = C - C.mean(1, keepdims=True)
    U = (Y @ Cc.T).astype(np.float32)
    V = (Cc @ Cc.T).astype(np.float32)
    return U, V, A, C, Y


def _gs_oracle(U, V, A, n_iter, relu=True, mask=None, gate=None):
    """Float64 plain (unblocked) Gauss-Seidel — the fixed-point semantics
    both implementations must track."""
    U = U.astype(np.float64)
    V = V.astype(np.float64)
    A = A.astype(np.float64).copy()
    cc = np.diag(V)
    K = A.shape[1]
    for _ in range(n_iter):
        for k in range(K):
            if gate is not None and not gate[k]:
                continue
            if cc[k] <= 0:
                continue
            r = U[:, k] - A @ V[:, k]
            ak = A[:, k] + r / max(cc[k], 1e-12)
            if relu:
                ak = np.maximum(ak, 0.0)
            if mask is not None:
                ak = np.where(mask[:, k], ak, 0.0)
            A[:, k] = ak
    return A


def test_pallas_spatial_matches_xla_and_oracle():
    U, V, A, _, _ = _problem()
    ref_xla = np.asarray(hals_spatial_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A), n_iter=3))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
        gate=jnp.ones(V.shape[0]), n_iter=3, relu=True,
        interpret=True)).T
    np.testing.assert_allclose(got, ref_xla, rtol=2e-5, atol=2e-5)
    oracle = _gs_oracle(U, V, A, n_iter=3)
    np.testing.assert_allclose(got, oracle, rtol=5e-4, atol=5e-4)


def test_pallas_spatial_with_mask():
    U, V, A, _, _ = _problem(seed=1)
    rng = np.random.default_rng(5)
    mask = rng.random(A.shape) > 0.3
    ref_xla = np.asarray(hals_spatial_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A),
        mask=jnp.asarray(mask), n_iter=2))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
        gate=jnp.ones(V.shape[0]), mask=jnp.asarray(mask.T),
        n_iter=2, relu=True, interpret=True)).T
    np.testing.assert_allclose(got, ref_xla, rtol=2e-5, atol=2e-5)


def test_pallas_temporal_matches_xla():
    rng = np.random.default_rng(2)
    d, K, T = 300, 20, 170
    A = np.maximum(rng.standard_normal((d, K)), 0).astype(np.float32)
    Y = rng.standard_normal((d, T)).astype(np.float32)
    C0 = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    U = (A.T @ Y).astype(np.float32)
    V = (A.T @ A).astype(np.float32)
    active = rng.random(K) > 0.2
    ref = np.asarray(hals_temporal_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0),
        n_iter=3, active=jnp.asarray(active)))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0),
        gate=jnp.asarray(active), n_iter=3, relu=False, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_pallas_ragged_padding():
    """K not a multiple of the block and d not a multiple of the lane
    tile both pad transparently."""
    U, V, A, _, _ = _problem(seed=3, d=333, K=19)
    ref_xla = np.asarray(hals_spatial_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A), n_iter=2))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
        gate=jnp.ones(19), n_iter=2, relu=True, interpret=True)).T
    np.testing.assert_allclose(got, ref_xla, rtol=2e-5, atol=2e-5)


def test_pallas_rss_descent():
    """Each sweep decreases ||Ysig - A C||^2 (the HALS objective)."""
    U, V, A, C, Y = _problem(seed=4)
    Cc = C - C.mean(1, keepdims=True)
    Yc = Y - Y.mean(1, keepdims=True)
    prev = np.inf
    for n in (1, 2, 4):
        out = np.asarray(hals_sweeps_rows_pallas(
            jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
            gate=jnp.ones(V.shape[0]), n_iter=n, relu=True,
            interpret=True)).T
        rss = float(np.sum((Yc - out @ Cc) ** 2))
        assert rss <= prev + 1e-3
        prev = rss


def _clustered_problem(seed=3, d=600, K=40, T=120, n_classes=3):
    """Temporal-style problem whose Gram V has EXACT zero couplings
    between same-class rows (colors sorted): the independence domain of
    the free vectorized step (relu=False, update_order.m semantics)."""
    rng = np.random.default_rng(seed)
    colors = np.sort(rng.integers(0, n_classes, K)).astype(np.int32)
    V = np.abs(rng.standard_normal((K, K))).astype(np.float32)
    V = (V + V.T) / 2 + np.eye(K, dtype=np.float32) * K
    # exact zeros WITHIN each class (same-class rows are independent;
    # cross-class couplings stay dense so the class order matters)
    same = colors[:, None] == colors[None, :]
    V = np.where(same & ~np.eye(K, dtype=bool), 0.0, V)
    U = rng.standard_normal((K, d)).astype(np.float32)
    X = np.abs(rng.standard_normal((K, d))).astype(np.float32)
    return U, V, X, colors


def test_class_schedule_kernel_matches_sequential():
    """The class-aligned step schedule (block-row vectorized steps with
    dynamic row starts + positional end-gating) must equal the
    sequential sweep in colored order."""
    from cnmf_e_tpu.ops.coloring import class_step_schedule

    U, V, X, colors = _clustered_problem()
    K = X.shape[0]
    for B in (16, 32, 64):
        sched = class_step_schedule(jnp.asarray(colors), block=B)
        out_sched = hals_sweeps_rows_pallas(
            jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
            gate=jnp.ones(K, jnp.float32), n_iter=3, block=B, relu=False,
            schedule=sched, interpret=True)
        # sequential reference: the same kernel, block schedule, no
        # free steps (plain blocked Gauss-Seidel)
        out_seq = hals_sweeps_rows_pallas(
            jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
            gate=jnp.ones(K, jnp.float32), n_iter=3, block=16,
            relu=False, interpret=True)
        # the class partition recomputes each step's residual where the
        # plain block path applies a delta correction — mathematically
        # identical Gauss-Seidel, ulp-level fp reassociation difference
        np.testing.assert_allclose(np.asarray(out_sched),
                                   np.asarray(out_seq),
                                   rtol=1e-5, atol=1e-6)


def test_class_schedule_respects_gauss_seidel_order_across_classes():
    """Coupled rows (different classes) must still see each other's
    updates in order — pinned against the float64 sequential oracle."""
    from cnmf_e_tpu.ops.coloring import class_step_schedule

    U, V, X, colors = _clustered_problem(seed=9, n_classes=4)
    K = X.shape[0]
    sched = class_step_schedule(jnp.asarray(colors), block=16)
    out = hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        gate=jnp.ones(K, jnp.float32), n_iter=2, block=16, relu=False,
        schedule=sched, interpret=True)
    oracle = _gs_oracle(U.T, V, X.T, n_iter=2, relu=False)
    np.testing.assert_allclose(np.asarray(out), oracle.T,
                               rtol=2e-4, atol=2e-4)


def test_class_schedule_spatial_masked_matches_sequential():
    """Spatial factor: class-disjoint search masks confine every row's
    update to its own pixels, so the vectorized class step is exact even
    though the trace Gram is dense (determine_search_location.m +
    update_order.m semantics)."""
    from cnmf_e_tpu.ops.coloring import class_step_schedule

    rng = np.random.default_rng(11)
    d, K, n_classes = 512, 30, 3
    colors = np.sort(rng.integers(0, n_classes, K)).astype(np.int32)
    mask = np.zeros((K, d), bool)
    for k in range(K):
        pix = np.arange(colors[k], d, n_classes)
        mask[k, rng.choice(pix, size=40, replace=False)] = True
    X = np.abs(rng.standard_normal((K, d))).astype(np.float32) * mask
    U = rng.standard_normal((K, d)).astype(np.float32)
    V = np.abs(rng.standard_normal((K, K))).astype(np.float32)
    V = (V + V.T) / 2 + np.eye(K, dtype=np.float32) * K   # dense Gram

    sched = class_step_schedule(jnp.asarray(colors), block=16)
    kw = dict(gate=jnp.ones(K, jnp.float32), n_iter=3, relu=True,
              interpret=True)
    out_sched = hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        mask=jnp.asarray(mask), block=16, schedule=sched, **kw)
    out_seq = hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        mask=jnp.asarray(mask), block=16, **kw)
    # fp reassociation (residual recompute vs delta correction) can flip
    # relu clamp decisions for pixels hovering at zero — bound the
    # aggregate effect, then pin quality against the float64 oracle
    diff = np.abs(np.asarray(out_sched) - np.asarray(out_seq))
    assert float(diff.max()) < 2e-3, float(diff.max())
    assert float(np.mean(diff > 1e-5)) < 0.05
    oracle = _gs_oracle(U.T, V, X.T, n_iter=3, relu=True, mask=mask.T)
    err_sched = np.abs(np.asarray(out_sched) - oracle.T).max()
    err_seq = np.abs(np.asarray(out_seq) - oracle.T).max()
    assert err_sched <= err_seq + 2e-3, (err_sched, err_seq)


def test_schedule_overflow_falls_back_to_blocks():
    """More classes than schedule capacity: the fallback block grid with
    sequential (non-free) steps still produces the exact result."""
    from cnmf_e_tpu.ops.coloring import class_step_schedule

    U, V, X, colors = _clustered_problem(seed=5, K=24, n_classes=3)
    K = X.shape[0]
    # force overflow with a tiny capacity (clamped to the block count)
    sched = class_step_schedule(jnp.asarray(colors), block=16, n_cap=1)
    assert sched[0].shape[0] == -(-K // 16)   # capacity clamped
    assert int(sched[3]) == -(-K // 16)       # fallback block count
    out = hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        gate=jnp.ones(K, jnp.float32), n_iter=2, block=16, relu=False,
        schedule=sched, interpret=True)
    out_ref = hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        gate=jnp.ones(K, jnp.float32), n_iter=2, block=16, relu=False,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out_ref))


@pytest.mark.parametrize("tile", [16, 32, 128])
def test_pallas_tile_width_invariant(tile):
    """Programs own disjoint column tiles, so the tile width (and the
    column padding it implies) cannot change the result."""
    U, V, A, _, _ = _problem(seed=6, d=300, K=20)
    ref_xla = np.asarray(hals_spatial_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A), n_iter=2,
        use_pallas=False))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
        gate=jnp.ones(20), n_iter=2, relu=True, tile=tile,
        interpret=True)).T
    np.testing.assert_allclose(got, ref_xla, rtol=2e-5, atol=2e-5)


def test_pallas_large_k_chunks_the_residual_dot():
    """K past one 128-row dot chunk (K = 150 pads to 256, two chunks)
    still tracks the XLA path."""
    U, V, A, _, _ = _problem(seed=7, d=64, K=150, T=200)
    ref_xla = np.asarray(hals_spatial_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A), n_iter=1,
        use_pallas=False))
    got = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U.T), jnp.asarray(V), jnp.asarray(A.T),
        gate=jnp.ones(150), n_iter=1, relu=True, tile=16,
        interpret=True)).T
    np.testing.assert_allclose(got, ref_xla, rtol=1e-4, atol=1e-4)
