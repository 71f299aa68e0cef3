"""Background update dispatch: ring (1p) or low-rank svd/nmf (2p).

Reference orchestration: ``update_background_parallel.m`` (per-patch parfor);
here the fit runs on the full sharded FOV in one jitted program (the ring
stencil and Gram matmuls partition over the mesh automatically).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.models.state import CNMFEState
from cnmf_e_tpu.ops.lowrank import fit_lowrank_model
from cnmf_e_tpu.ops.ring import (fit_ring_model, reconstruct_ring_background)


@functools.partial(jax.jit, static_argnames=("params",))
def update_background(Y: jnp.ndarray, state: CNMFEState, params: CNMFEParams,
                      sn_pix: Optional[jnp.ndarray] = None) -> CNMFEState:
    """Refit the background model given current (A, C). Y: (T, H, W)."""
    bp = params.background
    A = state.masked_A()
    C = state.masked_C()
    if bp.model == "ring":
        weights, b0, _ = fit_ring_model(
            Y, A, C, radius=bp.ring_radius, W_old=state.W, sn=sn_pix,
            thresh_outlier=bp.thresh_outlier,
            frame_cap_factor=bp.frame_cap_factor, ridge_eps=bp.ridge_eps,
            ssub=bp.ssub)
        return state.replace(W=weights, b0=b0)
    if bp.model == "local":
        # event-masked ring regression (reference:
        # endoscope/local_background.m via updateBG). Before a neuron
        # model exists it runs on the raw movie; once neurons are fitted
        # the reference passes Ybg = Y - A*C (Sources2D.m:1717-1733
        # localBG) so neuron transients the event mask misses cannot
        # bias the ring weights.
        from cnmf_e_tpu.ops.ring import local_background
        Ybg = Y - jnp.einsum("khw,kt->thw", A, C)
        _, weights, b0 = local_background(
            Ybg, radius=bp.ring_radius, sn=sn_pix, ssub=bp.ssub,
            ridge_eps=bp.ridge_eps)
        return state.replace(W=weights, b0=b0)
    b, f, b0 = fit_lowrank_model(Y, A, C, rank=bp.rank, mode=bp.model)
    return state.replace(b=b, f=f, b0=b0)


@functools.partial(jax.jit, static_argnames=("params",))
def background_of(Y: jnp.ndarray, state: CNMFEState,
                  params: CNMFEParams) -> jnp.ndarray:
    """Evaluate the current background estimate B (T, H, W)."""
    bp = params.background
    if bp.model == "ring":
        if state.W is None:
            return jnp.broadcast_to(state.b0[None], Y.shape)
        return reconstruct_ring_background(
            state.W, Y, state.masked_A(), state.masked_C(), state.b0,
            radius=bp.ring_radius, ssub=bp.ssub)
    if bp.model == "local":
        # reconstruct from the weights update_background stored (no
        # refit per call — a full local_background here would pay a
        # second ring regression + a separate compile).
        # B = W(Ybg - mean(Ybg) + 1) + b0 with Ybg = Y - A C,
        # mirroring local_background.m:148-150's DC restoration.
        if state.W is None:
            return jnp.broadcast_to(state.b0[None], Y.shape)
        from cnmf_e_tpu.ops.ring import apply_ring, _ssub_geometry
        T, H, W = Y.shape
        Ybg = Y - jnp.einsum("khw,kt->thw", state.masked_A(),
                             state.masked_C())
        Yc = Ybg - jnp.mean(Ybg, axis=0)[None] + 1.0
        Hs, Ws, radius_s = _ssub_geometry(H, W, bp.ring_radius, bp.ssub)
        if bp.ssub > 1:
            from cnmf_e_tpu.ops.filters import box_downsample
            Bs = apply_ring(state.W, box_downsample(Yc, ssub=bp.ssub),
                            Hs, Ws, radius_s, include_intercept=False)
            Yest = jax.image.resize(Bs, (T, H, W), method="linear")
        else:
            Yest = apply_ring(state.W, Yc, H, W, bp.ring_radius,
                              include_intercept=False)
        return Yest + state.b0[None]
    if state.b is None:
        return jnp.broadcast_to(state.b0[None], Y.shape)
    return jnp.einsum("rhw,rt->thw", state.b, state.f) + state.b0[None]


@functools.partial(jax.jit, static_argnames=("params",))
def subtract_background(Y: jnp.ndarray, state: CNMFEState,
                        params: CNMFEParams) -> jnp.ndarray:
    """Ysignal = Y - B, the input to the spatial/temporal factor updates
    (reference: inline bg reconstruction in ``update_spatial_parallel.m:157-188``)."""
    return Y - background_of(Y, state, params)


@functools.partial(jax.jit, static_argnames=("params",))
def residual_movie(Y: jnp.ndarray, state: CNMFEState,
                   params: CNMFEParams) -> jnp.ndarray:
    """Y - B - A C in one program: the input to the residual neuron pick
    (reference: ``initComponents_residual_parallel.m:189-199``)."""
    return (subtract_background(Y, state, params)
            - jnp.einsum("khw,kt->thw", state.masked_A(), state.masked_C()))
