"""Kernel selection and the Pallas kernels' GPU lowering, on CPU.

``ops/kernels.py::choose`` is the one place that decides between a Pallas
kernel and its XLA form. The kernels themselves are checked in interpret
mode (tests/test_pallas_hals.py, tests/test_pallas_oasis.py); here their
Triton IR is also lowered for CUDA and verified, which catches what the
interpreter cannot (e.g. mistyped loop bounds) without a GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.ops.kernels import PALLAS, XLA, choose, hals_layout


@pytest.mark.parametrize("op", ["hals", "oasis"])
@pytest.mark.parametrize("backend,want", [("gpu", PALLAS), ("cpu", XLA)])
def test_choose_follows_backend(op, backend, want):
    assert choose(op, backend=backend) == want


@pytest.mark.parametrize("op", ["hals", "oasis"])
def test_choose_mesh_takes_xla(op):
    """A pallas_call does not partition: any mesh gets the XLA form, on
    every backend."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("patch",))
    assert choose(op, mesh=mesh, backend="gpu") == XLA


def test_choose_default_backend_here_is_xla():
    assert choose("hals") == XLA          # the tests run on the CPU


def test_choose_rejects_unknown_op():
    with pytest.raises(ValueError):
        choose("ring")


@pytest.mark.parametrize("K,block,want", [
    (1, 16, (16, 16)),           # tiny K pads to one 16-row step
    (19, 16, (32, 32)),          # next power of two
    (40, 64, (64, 64)),          # K below one step pads up to the step
    (192, 64, (128, 256)),       # past 128: multiples of the 128 chunk
    (1024, 16, (128, 1024)),
    (2304, 64, (128, 2304)),
])
def test_hals_layout_pads_k(K, block, want):
    KC, Kp = hals_layout(K, block)
    assert (KC, Kp) == want
    assert Kp >= max(K, block) and Kp % KC == 0


@pytest.mark.parametrize("block", [8, 24, 0])
def test_hals_layout_rejects_bad_block(block):
    with pytest.raises(ValueError):
        hals_layout(64, block)


def _verify_triton(fn, *args):
    """Lower ``fn`` for CUDA on this CPU host and verify every Triton
    module it emits; returns how many were verified."""
    from jax._src.pallas.triton import lowering
    from jax._src.pallas.triton import pallas_call_registration as reg

    seen = []
    orig = lowering.lower_jaxpr_to_triton_module

    def checked(*a, **k):
        res = orig(*a, **k)
        seen.append(res.module.operation.verify())
        return res

    reg.lowering.lower_jaxpr_to_triton_module = checked
    try:
        jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    finally:
        reg.lowering.lower_jaxpr_to_triton_module = orig
    assert seen and all(seen)
    return len(seen)


@pytest.mark.parametrize("relu,schedule", [(True, False), (False, True)])
def test_hals_kernel_lowers_for_cuda(relu, schedule):
    from cnmf_e_tpu.ops.coloring import class_step_schedule
    from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
    K, d = 40, 256
    sched = (class_step_schedule(jnp.zeros(K, jnp.int32), block=16)
             if schedule else None)
    fn = functools.partial(hals_sweeps_rows_pallas, n_iter=2, block=16,
                           relu=relu, schedule=sched)
    assert _verify_triton(fn, jnp.ones((K, d)), jnp.eye(K),
                          jnp.ones((K, d)), jnp.ones(K)) == 1


@pytest.mark.parametrize("lanes", [1, 16])
def test_oasis_kernel_lowers_for_cuda(lanes):
    from cnmf_e_tpu.ops.pallas_oasis import oasis_ar1_pallas
    K, T = 8, 100
    fn = functools.partial(oasis_ar1_pallas, lanes=lanes)
    z = jnp.zeros(K)
    assert _verify_triton(fn, jnp.ones((K, T)), jnp.full((K,), 0.9),
                          z, z) == 1
