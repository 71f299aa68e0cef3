"""Pallas OASIS event-loop kernel vs the exact sample-level solver.

The kernel (ops/pallas_oasis.py, Triton route) runs the whole pool-merge
loop inside one GPU program; in interpret mode it executes the identical
lockstep algorithm on CPU, so these tests pin it against the vmapped
sample-level while_loop (the ground-truth formulation of
``oasisAR1.m:59-109``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.ops.oasis import _oasis_ar1_single
from cnmf_e_tpu.ops.pallas_oasis import oasis_ar1_pallas


def _ar1_traces(K, T, seed, rate=0.05, sn=0.2):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.7, 0.97, K).astype(np.float32)
    s = (rng.random((K, T)) < rate) * rng.exponential(1.0, (K, T))
    c = np.zeros((K, T), np.float32)
    for t in range(1, T):
        c[:, t] = g * c[:, t - 1] + s[:, t]
    y = c + sn * rng.standard_normal((K, T)).astype(np.float32)
    return jnp.asarray(y), jnp.asarray(g)


@pytest.mark.parametrize("lam,smin", [(0.0, 0.0), (0.5, 0.0),
                                      (0.0, 0.3), (0.3, 0.2)])
def test_pallas_oasis_matches_sample_level(lam, smin):
    K, T = 7, 100       # unaligned: exercises both K and T padding
    y, g = _ar1_traces(K, T, seed=hash((lam, smin)) % 2**31)
    lam_v = jnp.full((K,), lam, jnp.float32)
    smin_v = jnp.full((K,), smin, jnp.float32)
    c_ref, s_ref = jax.vmap(_oasis_ar1_single)(y, g, lam_v, smin_v)
    c_pl, s_pl = oasis_ar1_pallas(y, g, lam_v, smin_v, interpret=True)
    np.testing.assert_allclose(c_pl, c_ref, atol=1e-4)
    np.testing.assert_allclose(s_pl, s_ref, atol=1e-4)


def test_pallas_oasis_monotone_increasing_no_merge():
    # strictly increasing trace: every sample is its own pool (max depth)
    T = 64
    y = jnp.asarray(np.linspace(1.0, 10.0, T, dtype=np.float32))[None, :]
    g = jnp.asarray([0.9], jnp.float32)
    z = jnp.zeros((1,), jnp.float32)
    c_ref, s_ref = jax.vmap(_oasis_ar1_single)(y, g, z, z)
    c_pl, s_pl = oasis_ar1_pallas(y, g, z, z, interpret=True)
    np.testing.assert_allclose(c_pl, c_ref, atol=1e-5)


def test_pallas_oasis_decreasing_merges_to_one_pool():
    T = 64
    y = jnp.asarray(np.linspace(10.0, 1.0, T, dtype=np.float32))[None, :]
    g = jnp.asarray([0.99], jnp.float32)
    z = jnp.zeros((1,), jnp.float32)
    c_ref, _ = jax.vmap(_oasis_ar1_single)(y, g, z, z)
    c_pl, s_pl = oasis_ar1_pallas(y, g, z, z, interpret=True)
    np.testing.assert_allclose(c_pl, c_ref, atol=1e-5)
    # decay faster than g forces merges: spikes only at t=0
    assert float(jnp.sum(s_pl[:, 1:])) < 1e-5


class TestLongTraces:
    """Traces long enough for deep pool stacks and long merge cascades."""

    @pytest.mark.parametrize("lam,smin", [(0.0, 0.0), (0.5, 0.0),
                                          (0.0, 0.3), (0.3, 0.2)])
    def test_matches_sample_level(self, lam, smin):
        """The kernel is the sample-level algorithm for every lam/smin —
        including smin > 0, where merge order matters and a chunked
        solve would differ."""
        K, T = 5, 300
        y, g = _ar1_traces(K, T, seed=hash(("long", lam, smin)) % 2**31)
        lam_v = jnp.full((K,), lam, jnp.float32)
        smin_v = jnp.full((K,), smin, jnp.float32)
        c_ref, s_ref = jax.vmap(_oasis_ar1_single)(y, g, lam_v, smin_v)
        c_pl, s_pl = oasis_ar1_pallas(y, g, lam_v, smin_v, lanes=4,
                                      interpret=True)
        np.testing.assert_allclose(c_pl, c_ref, atol=1e-4)
        np.testing.assert_allclose(s_pl, s_ref, atol=1e-4)

    def test_merge_cascade(self):
        # a big pool followed by sub-decay samples: every push merges and
        # triggers the next merge (worst-case cascade)
        T = 256
        t = np.arange(T, dtype=np.float32)
        y = np.where(t < 60, 10.0, 10.0 * 0.5 ** (t - 59)).astype(np.float32)
        y = jnp.asarray(y)[None, :]
        g = jnp.asarray([0.95], jnp.float32)
        z = jnp.zeros((1,), jnp.float32)
        c_ref, _ = jax.vmap(_oasis_ar1_single)(y, g, z, z)
        c_pl, _ = oasis_ar1_pallas(y, g, z, z, interpret=True)
        np.testing.assert_allclose(c_pl, c_ref, atol=1e-4)

    def test_monotone_increasing_max_pools(self):
        # no merging anywhere: the stack reaches its full depth T
        T = 200
        y = jnp.asarray(np.linspace(1.0, 10.0, T, dtype=np.float32))[None, :]
        g = jnp.asarray([0.9], jnp.float32)
        z = jnp.zeros((1,), jnp.float32)
        c_ref, _ = jax.vmap(_oasis_ar1_single)(y, g, z, z)
        c_pl, _ = oasis_ar1_pallas(y, g, z, z, interpret=True)
        np.testing.assert_allclose(c_pl, c_ref, atol=1e-5)


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
def test_lane_width_invariant(lanes):
    """Traces are independent: how many share a program (and the padding
    to a lane multiple) cannot change any trace's result."""
    K, T = 9, 80
    y, g = _ar1_traces(K, T, seed=17)
    z = jnp.zeros((K,), jnp.float32)
    sm = jnp.full((K,), 0.1, jnp.float32)
    c_ref, s_ref = jax.vmap(_oasis_ar1_single)(y, g, z, sm)
    c_pl, s_pl = oasis_ar1_pallas(y, g, z, sm, lanes=lanes, interpret=True)
    np.testing.assert_allclose(c_pl, c_ref, atol=1e-4)
    np.testing.assert_allclose(s_pl, s_ref, atol=1e-4)


def test_kernel_agrees_with_xla_form_when_merging_is_confluent():
    """With smin = 0 pool merging is confluent, so the kernel agrees with
    the XLA form's divide-and-conquer path."""
    from cnmf_e_tpu.ops.oasis import oasis_ar1
    K, T = 6, 150
    y, g = _ar1_traces(K, T, seed=23)
    c_x, _ = oasis_ar1(y, g, 0.1, 0.0, impl="xla")
    c_pl, _ = oasis_ar1_pallas(y, g, jnp.full((K,), 0.1), jnp.zeros(K),
                               interpret=True)
    np.testing.assert_allclose(c_pl, c_x, atol=1e-4)


@pytest.mark.parametrize("smin", [0.3, 0.6])
@pytest.mark.parametrize("traced", [False, True])
def test_xla_form_matches_kernel_with_spike_floor(smin, traced):
    """With smin > 0 merge order matters, so the XLA form runs the
    sample-level loop and agrees with the kernel (a chunked solve would
    not). ``traced`` passes smin as an array, which picks the loop on
    device."""
    from cnmf_e_tpu.ops.oasis import oasis_ar1
    K, T = 6, 300
    y, g = _ar1_traces(K, T, seed=29)
    z = jnp.zeros((K,), jnp.float32)
    sm = jnp.full((K,), smin, jnp.float32)
    c_x, s_x = oasis_ar1(y, g, 0.0, sm if traced else smin, chunk=64,
                         impl="xla")
    c_pl, s_pl = oasis_ar1_pallas(y, g, z, sm, interpret=True)
    np.testing.assert_allclose(c_x, c_pl, atol=1e-4)
    np.testing.assert_allclose(s_x, s_pl, atol=1e-4)
