import numpy as np
import pytest
import jax.numpy as jnp

from cnmf_e_tpu.config import CNMFEParams, SpatialParams
from cnmf_e_tpu.models.merge import merge_pairs
from cnmf_e_tpu.models.qc import order_neurons
from cnmf_e_tpu.models.state import empty_state
from cnmf_e_tpu.ops.ar import make_G_matrix
from cnmf_e_tpu.ops.lowrank import kmeans_pp, sparse_nmf_init
from cnmf_e_tpu.ops.morphology import (search_locations_ellipse,
                                       threshold_components)
from cnmf_e_tpu.utils.simulate import simulate_movie


def test_make_G_matrix():
    G = np.asarray(make_G_matrix(5, jnp.asarray([0.9])))
    c = np.array([1.0, 0.9, 0.81, 0.729, 2.0])
    s = G @ c
    np.testing.assert_allclose(s[:4], [1, 0, 0, 0], atol=1e-6)
    assert s[4] > 1.0


def test_search_locations_ellipse():
    A = np.zeros((1, 30, 30), np.float32)
    # anisotropic footprint: elongated along rows
    yy, xx = np.mgrid[0:30, 0:30]
    A[0] = np.exp(-((yy - 15) ** 2 / 30.0 + (xx - 15) ** 2 / 6.0))
    masks = np.asarray(search_locations_ellipse(jnp.asarray(A)))
    assert masks[0, 15, 15]
    # mask extends farther along the elongated (row) axis
    row_extent = masks[0, :, 15].sum()
    col_extent = masks[0, 15, :].sum()
    assert row_extent > col_extent


def test_threshold_components():
    A = np.zeros((1, 10, 10), np.float32)
    A[0, 4:6, 4:6] = 1.0
    A[0, 0, 0] = 0.01          # negligible-energy pixel
    out = np.asarray(threshold_components(jnp.asarray(A), 0.99))
    assert out[0, 4, 4] == 1.0
    assert out[0, 0, 0] == 0.0


def test_kmeans_pp(rng):
    X = np.concatenate([rng.normal(0, 0.1, (50, 2)),
                        rng.normal(5, 0.1, (60, 2))]).astype(np.float32)
    centers, labels = kmeans_pp(jnp.asarray(X), 2, seed=1)
    centers = np.asarray(centers)
    dists = np.sort(np.linalg.norm(centers - np.array([0, 0]), axis=1))
    assert dists[0] < 0.5 and abs(dists[1] - np.sqrt(50)) < 1.0


def test_sparse_nmf_init():
    gt = simulate_movie(seed=51, H=32, W=32, T=200, K=4, sn=0.03,
                        bg_strength=0.0, min_dist=10.0, spike_rate=0.06)
    A, C = sparse_nmf_init(jnp.asarray(gt.Y), K=6, seed=0)
    assert A.shape == (6, 32, 32)
    recon = np.einsum("khw,kt->thw", np.asarray(A), np.asarray(C))
    base = np.linalg.norm(gt.Y)
    assert np.linalg.norm(gt.Y - recon) < 0.6 * base


def test_merge_pairs_manual():
    st = empty_state(8, 20, 20, 60)
    a = np.zeros((20, 20), np.float32)
    a[8:12, 8:12] = 1.0
    c = np.abs(np.random.default_rng(0).standard_normal(60)).astype(np.float32)
    st = st.replace(
        A=st.A.at[0].set(jnp.asarray(a)).at[1].set(jnp.asarray(a)),
        C=st.C.at[0].set(jnp.asarray(c)).at[1].set(jnp.asarray(c * 0.5)),
        C_raw=st.C_raw.at[0].set(jnp.asarray(c)).at[1].set(
            jnp.asarray(c * 0.5)),
        active=st.active.at[:2].set(True))
    out, nm = merge_pairs(st, CNMFEParams(), [(0, 1)])
    assert nm == 1
    assert int(out.n_active()) == 1


def test_order_neurons_keys():
    st = empty_state(4, 10, 10, 50)
    st = st.replace(
        active=st.active.at[:3].set(True),
        A=st.A.at[:3, 2:5, 2:5].set(1.0),
        C=st.C.at[0].set(5.0).at[1].set(1.0).at[2].set(3.0),
        C_raw=st.C_raw.at[:3].set(1.0))
    for key in ("snr", "energy", "pnr"):
        order = np.asarray(order_neurons(st, key))
        assert set(order[:3].tolist()) == {0, 1, 2}
        assert order[3] == 3  # inactive slot last


def test_fast_median_matches_order_statistic(rng):
    """fast_median converges to the lower-middle order statistic."""
    import jax.numpy as jnp
    from cnmf_e_tpu.ops.stats import fast_median
    for shape, ax in [((19, 201), -1), ((16, 200), -1), ((60, 7, 5), 0)]:
        x = (rng.standard_normal(shape) * rng.uniform(0.1, 50)
             ).astype(np.float32)
        got = np.asarray(fast_median(jnp.asarray(x), axis=ax))
        k = (shape[ax] + 1) // 2 - 1
        ref = np.sort(x, axis=ax).take(k, axis=ax)
        assert np.abs(got - ref).max() < 1e-4 * (np.abs(ref).max() + 1)


def test_submedian_mean_matches_numpy(rng):
    import jax.numpy as jnp
    from cnmf_e_tpu.ops.stats import submedian_mean
    x = (rng.standard_normal((12, 301)) * 3 + 1).astype(np.float32)
    med = np.sort(x, -1)[:, 150]
    ref = np.array([x[i][x[i] < med[i]].mean() for i in range(12)])
    got = np.asarray(submedian_mean(jnp.asarray(x)))
    assert np.abs(got - ref).max() < 5e-3 * (np.abs(ref).max() + 1)


@pytest.mark.parametrize("n", [300, 301])
def test_submedian_mean_is_the_reference_set(rng, n):
    """Both parities select exactly the reference's x < median(x)."""
    import jax.numpy as jnp
    from cnmf_e_tpu.ops.stats import submedian_mean
    x = (rng.standard_normal((12, n)) * 3 + 1).astype(np.float32)
    ref = np.array([r[r < np.median(r)].mean() for r in x.astype(np.float64)])
    got = np.asarray(submedian_mean(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2000, 2001])
def test_submedian_mean_is_stable_under_last_bit_changes(rng, n):
    """On calcium-like traces (a small noise floor under sparse large
    transients, where the bisection stops short of the middle sample) a
    1e-6 relative change of x moves the baseline by rounding only."""
    import jax.numpy as jnp
    from cnmf_e_tpu.ops.stats import submedian_mean
    x = (np.abs(rng.standard_normal((64, n))) * 0.01
         + (rng.random((64, n)) < 0.02) * 10).astype(np.float32)
    p = (x * (1 + 1e-6 * rng.standard_normal(x.shape))).astype(np.float32)
    a = np.asarray(submedian_mean(jnp.asarray(x)))
    b = np.asarray(submedian_mean(jnp.asarray(p)))
    assert np.abs(a - b).max() < 1e-5 * np.abs(a).max()


def test_fast_median_masked_matches_numpy(rng):
    from cnmf_e_tpu.ops.stats import fast_median_masked
    x = rng.standard_normal((40, 101)).astype(np.float32) * 3.0
    mask = rng.random(101) < 0.4
    out = np.asarray(fast_median_masked(jnp.asarray(x),
                                        jnp.asarray(mask)[None], axis=1))
    for t in range(40):
        sel = np.sort(x[t, mask])
        # lower-middle order statistic (fast_median convention)
        ref = sel[(len(sel) + 1) // 2 - 1]
        assert abs(out[t] - ref) < 1e-3, (t, out[t], ref)
    # empty mask -> 0
    out0 = np.asarray(fast_median_masked(
        jnp.asarray(x), jnp.zeros((1, 101), bool), axis=1))
    assert np.all(out0 == 0.0)
