"""Shard-count invariance: the distributed step must produce the same
numbers on 1 device and on a (4, 2) virtual mesh (SURVEY.md section 4 —
the analog of the reference's parfor/serial equivalence guarantee)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cnmf_e_tpu.ops.ring import RingWeights, fit_ring_weights, ring_offsets
from cnmf_e_tpu.parallel.mesh import make_mesh
from cnmf_e_tpu.parallel.step import StepState, make_update_step


def _mkstate(K, H, W, T, R, rng):
    return StepState(
        A=jnp.asarray(np.abs(rng.standard_normal((K, H, W))), jnp.float32),
        C=jnp.asarray(np.abs(rng.standard_normal((K, T))), jnp.float32),
        C_raw=jnp.zeros((K, T), jnp.float32),
        S=jnp.zeros((K, T), jnp.float32),
        g=jnp.full((K,), 0.9, jnp.float32),
        b0=jnp.zeros((H, W), jnp.float32),
        ring_w=jnp.full((H * W, R), 0.01, jnp.float32),
        ring_w0=jnp.zeros((H * W,), jnp.float32),
    )


def test_step_shard_count_invariance(rng):
    H, W, T, K, radius = 32, 16, 128, 8, 3
    R = ring_offsets(radius).shape[0]
    Y = jnp.asarray(rng.standard_normal((T, H, W)) * 0.1 + 1.0, jnp.float32)
    st = _mkstate(K, H, W, T, R, rng)

    step1 = make_update_step(None, H, W, T, radius=radius, n_hals=1)
    out1 = step1(Y, st)

    mesh = make_mesh(n_patch=4, n_frame=2)
    stepN = make_update_step(mesh, H, W, T, radius=radius, n_hals=1)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    Ys = put(Y, P("frame", "patch", None))
    sts = StepState(
        A=put(st.A, P(None, "patch", None)), C=put(st.C, P(None, "frame")),
        C_raw=put(st.C_raw, P(None, "frame")), S=put(st.S, P(None, "frame")),
        g=put(st.g, P()), b0=put(st.b0, P("patch", None)),
        ring_w=put(st.ring_w, P("patch", None)),
        ring_w0=put(st.ring_w0, P("patch")))
    outN = stepN(Ys, sts)

    np.testing.assert_allclose(np.asarray(out1.A), np.asarray(outN.A),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out1.C), np.asarray(outN.C),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(out1.S), np.asarray(outN.S),
                               atol=2e-3)


def test_colored_step_shard_count_invariance(rng):
    """The colored update (masked spatial + independent-set ordering,
    update_order.m semantics) must also be shard-count invariant: the
    coloring runs on replicated (K, K) data, so 1-device and mesh runs
    use the identical permutation and masks."""
    H, W, T, K, radius = 32, 16, 128, 8, 3
    R = ring_offsets(radius).shape[0]
    Y = jnp.asarray(rng.standard_normal((T, H, W)) * 0.1 + 1.0, jnp.float32)
    st = _mkstate(K, H, W, T, R, rng)
    # compact support so the overlap graph has structure
    st = st._replace(A=jnp.where(st.A > 0.5, st.A, 0.0))

    step1 = make_update_step(None, H, W, T, radius=radius, n_hals=1,
                             colored=True)
    out1 = step1(Y, st)

    mesh = make_mesh(n_patch=4, n_frame=2)
    stepN = make_update_step(mesh, H, W, T, radius=radius, n_hals=1,
                             colored=True)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    Ys = put(Y, P("frame", "patch", None))
    sts = StepState(
        A=put(st.A, P(None, "patch", None)), C=put(st.C, P(None, "frame")),
        C_raw=put(st.C_raw, P(None, "frame")), S=put(st.S, P(None, "frame")),
        g=put(st.g, P()), b0=put(st.b0, P("patch", None)),
        ring_w=put(st.ring_w, P("patch", None)),
        ring_w0=put(st.ring_w0, P("patch")))
    outN = stepN(Ys, sts)

    np.testing.assert_allclose(np.asarray(out1.A), np.asarray(outN.A),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out1.C), np.asarray(outN.C),
                               atol=2e-3)


@pytest.mark.parametrize("n_patch,n_frame", [(4, 1), (2, 2), (1, 4)])
def test_chained_step_matches_one_device_on_planted_neurons(n_patch, n_frame):
    """Ten chained colored iterations with two deconvolutions on a mesh
    stay within 1e-3 floored max-rel of one device in A, C_raw and C —
    the four-card gate of ``chip_smoke.py --multi``, on virtual devices."""
    from cnmf_e_tpu.utils.simulate import update_step_problem
    H, W, T, K = 64, 64, 400, 16
    Y, st = update_step_problem(H, W, T, K=K, radius=13, planted=True)
    kw = dict(radius=13, n_hals=1, chain=10, deconv_every=5, colored=True)
    ref = make_update_step(None, H, W, T, **kw)(Y, st)
    mesh = make_mesh(n_patch=n_patch, n_frame=n_frame)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    sts = StepState(
        A=put(st.A, P(None, "patch", None)), C=put(st.C, P(None, "frame")),
        C_raw=put(st.C_raw, P(None, "frame")), S=put(st.S, P(None, "frame")),
        g=put(st.g, P()), b0=put(st.b0, P("patch", None)),
        ring_w=put(st.ring_w, P("patch", None)),
        ring_w0=put(st.ring_w0, P("patch")))
    out = make_update_step(mesh, H, W, T, **kw)(
        put(Y, P("frame", "patch", None)), sts)
    for f in ("A", "C_raw", "C"):
        x, r = np.asarray(getattr(out, f)), np.asarray(getattr(ref, f))
        scale = np.maximum(np.abs(r), 0.05 * np.abs(r).max())
        assert (np.abs(x - r) / scale).max() <= 1e-3, f


def test_ring_fit_compiles_under_mesh(rng):
    """The gather-heavy ring fit must at least compile+run on a sharded
    input (XLA may insert gathers/all-gathers; exactness is what matters)."""
    H = W = 32
    T = 64
    radius = 4
    Bf = jnp.asarray(rng.standard_normal((T, H, W)), jnp.float32)
    ref = fit_ring_weights(Bf, H, W, radius)

    mesh = make_mesh(n_patch=4, n_frame=2)
    Bfs = jax.device_put(Bf, NamedSharding(mesh, P("frame", "patch", None)))
    out = fit_ring_weights(Bfs, H, W, radius)
    np.testing.assert_allclose(np.asarray(out.w), np.asarray(ref.w),
                               atol=1e-3)


def _mini_params():
    from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams,
                                   InitParams, MergeParams)
    return CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=6, min_corr=0.7, min_pnr=6.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6),
        merge=MergeParams(dmin=4.0))


def _mini_movie():
    from cnmf_e_tpu.utils.simulate import simulate_movie
    return simulate_movie(seed=11, H=32, W=32, T=256, K=5, gSig=2.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.05)


def test_initialize_greedy_shard_invariance():
    """initComponents under a (4, 2) mesh == single device (footprints and
    traces, not just compile)."""
    from cnmf_e_tpu.models.initialize import initialize_greedy
    from cnmf_e_tpu.parallel.mesh import make_mesh
    gt = _mini_movie()
    params = _mini_params()
    st1, _ = initialize_greedy(jnp.asarray(gt.Y), params)

    mesh = make_mesh(n_patch=4, n_frame=2)
    Ys = jax.device_put(jnp.asarray(gt.Y),
                        NamedSharding(mesh, P("frame", "patch", None)))
    stN, _ = initialize_greedy(Ys, params)

    assert int(st1.n_active()) == int(stN.n_active())
    A1, AN = np.asarray(st1.masked_A()), np.asarray(stN.masked_A())
    C1, CN = np.asarray(st1.C), np.asarray(stN.C)
    # same seeds -> same slots; IoU of binarized footprints ~ 1
    inter = np.sum((A1 > 0) & (AN > 0))
    union = max(np.sum((A1 > 0) | (AN > 0)), 1)
    assert inter / union >= 0.99, inter / union
    for k in range(int(st1.n_active())):
        denom = np.linalg.norm(C1[k]) * np.linalg.norm(CN[k])
        if denom > 0:
            corr = float(C1[k] @ CN[k] / denom)
            assert corr >= 0.999, (k, corr)


def test_update_background_shard_invariance():
    """Ring background refit under the mesh == single device (W and b0)."""
    from cnmf_e_tpu.models.background import update_background
    from cnmf_e_tpu.models.initialize import initialize_greedy
    from cnmf_e_tpu.parallel.mesh import make_mesh
    gt = _mini_movie()
    params = _mini_params()
    st, _ = initialize_greedy(jnp.asarray(gt.Y), params)

    out1 = update_background(jnp.asarray(gt.Y), st, params)

    mesh = make_mesh(n_patch=4, n_frame=2)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    Ys = put(jnp.asarray(gt.Y), P("frame", "patch", None))
    stS = st.replace(A=put(st.A, P(None, "patch", None)),
                     C=put(st.C, P(None, "frame")))
    outN = update_background(Ys, stS, params)

    np.testing.assert_allclose(np.asarray(outN.b0), np.asarray(out1.b0),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(outN.W.w), np.asarray(out1.W.w),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.slow
def test_full_fit_shard_invariance():
    """A short CNMFE.fit run on sharded inputs matches the single-device
    run: footprint IoU >= 0.99, trace corr >= 0.999 (the reference's
    parfor/serial equivalence, update_spatial_parallel.m:218-318)."""
    from cnmf_e_tpu.models.pipeline import CNMFE
    from cnmf_e_tpu.parallel.mesh import make_mesh
    gt = _mini_movie()
    params = _mini_params()

    st1 = CNMFE(params).fit(gt.Y, n_outer=1)

    mesh = make_mesh(n_patch=4, n_frame=2)
    Ys = jax.device_put(jnp.asarray(gt.Y),
                        NamedSharding(mesh, P("frame", "patch", None)))
    stN = CNMFE(params).fit(Ys, n_outer=1)

    n1, nN = int(st1.n_active()), int(stN.n_active())
    assert n1 == nN, (n1, nN)
    A1 = np.asarray(st1.masked_A())[:n1]
    AN = np.asarray(stN.masked_A())[:nN]
    inter = np.sum((A1 > 0) & (AN > 0))
    union = max(np.sum((A1 > 0) | (AN > 0)), 1)
    assert inter / union >= 0.99, inter / union
    C1 = np.asarray(st1.C)[:n1]
    CN = np.asarray(stN.C)[:nN]
    for k in range(n1):
        denom = np.linalg.norm(C1[k]) * np.linalg.norm(CN[k])
        if denom > 0:
            assert float(C1[k] @ CN[k] / denom) >= 0.999, k
