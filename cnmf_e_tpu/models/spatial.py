"""Spatial (A) update.

Reference: ``update_spatial_parallel.m`` — per-patch parfor over pixels with
HALS / thresholded-HALS / NNLS solvers on search-location-masked supports,
then stitching and post-processing. Here: one masked solve over the full
(sharded) FOV; the Grams are dense matmuls and the per-neuron sweeps are
``fori`` loops inside a single jitted program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.models.state import CNMFEState
from cnmf_e_tpu.ops.hals import hals_spatial
from cnmf_e_tpu.ops.morphology import (connectivity_constraint,
                                       circular_constraint,
                                       search_locations_dilate,
                                       search_locations_ellipse)
from cnmf_e_tpu.ops.nnls import nnls_pixels


@functools.partial(jax.jit, static_argnames=("params",))
def update_spatial(Ysignal: jnp.ndarray, state: CNMFEState,
                   params: CNMFEParams,
                   sn_pix: jnp.ndarray | None = None) -> CNMFEState:
    """Update footprints given traces. Ysignal: (T, H, W) = Y - B.

    ``sn_pix``: optional (H, W) per-pixel PSD noise sigma — the
    ``hals_thresh`` / ``lars`` noise floor (``HALS_spatial_thresh.m``;
    sn refresh at ``update_spatial_parallel.m:191-194``). When absent the
    residual std stands in, which over-estimates the floor early in
    fitting (unmodeled signal inflates the residual) and can zero true
    footprint pixels — pipelines that already computed sn should pass it.
    """
    sp = params.spatial
    T, H, W = Ysignal.shape
    K = state.K_max
    A = state.masked_A()
    C = state.masked_C()

    if sp.search_method == "dilate":
        masks = search_locations_dilate(A, radius=sp.dilate_radius)
    elif sp.search_method == "ellipse":
        masks = search_locations_ellipse(A)
    else:
        masks = jnp.ones_like(A, dtype=bool)
    masks = masks & state.active[:, None, None]

    Yd = Ysignal.reshape(T, H * W).T                # (d, T)
    Ad = A.reshape(K, H * W).T                      # (d, K)
    Md = masks.reshape(K, H * W).T                  # (d, K)

    # colored=True: the reference's independent-set ordering
    # (update_order.m:1-21) lets the fused HALS kernel update
    # non-overlapping neurons simultaneously (tests/test_coloring.py)
    if sp.algorithm == "hals":
        Ad = hals_spatial(Yd, Ad, C, mask=Md, n_iter=sp.n_iter,
                          colored=True)
    elif sp.algorithm == "hals_thresh":
        # HALS then zero sub-noise weights (HALS_spatial_thresh.m)
        Ad = hals_spatial(Yd, Ad, C, mask=Md, n_iter=sp.n_iter,
                          colored=True)
        # 3-sigma pixel gate in the reference's exact units
        # (HALS_spatial_thresh.m:37,51: zero a_dk where
        # a_dk * ||C_k - mean||_2 < 3 * sn_d), with sn the stored PSD
        # noise when the pipeline passes it; the residual-std fallback is
        # biased high while signal is unmodeled (it includes the
        # unexplained neurons) and can zero true footprint pixels
        Cc = C - jnp.mean(C, axis=-1, keepdims=True)
        cnorm = jnp.sqrt(jnp.sum(Cc * Cc, axis=-1))        # (K,)
        sn_d = (sn_pix.reshape(-1, 1) if sn_pix is not None
                else jnp.std(Yd - Ad @ C, axis=-1, keepdims=True))
        Ad = jnp.where(Ad * cnorm[None, :] > 3.0 * sn_d, Ad, 0.0)
    elif sp.algorithm == "nnls":
        Ad = nnls_pixels(C, Yd, A0=Ad, mask=Md, n_iter=20 * sp.n_iter)
    elif sp.algorithm == "lars":
        # noise-constrained nonneg lasso (lars_regression_noise role)
        from cnmf_e_tpu.models.cnmf2p import lasso_noise_constrained
        sn_d = (sn_pix.reshape(-1) if sn_pix is not None
                else jnp.std(Yd - Ad @ C, axis=-1))
        Ad = lasso_noise_constrained(C, Yd, sn_d, Md)
    else:
        raise ValueError(f"unknown spatial algorithm {sp.algorithm!r}")

    A_new = Ad.T.reshape(K, H, W)
    A_new = post_process_spatial(A_new, params)
    A_new = A_new * state.active[:, None, None]
    return state.replace(A=A_new)


def post_process_spatial(A: jnp.ndarray, params: CNMFEParams) -> jnp.ndarray:
    """Shape cleanup (reference: ``post_process_spatial.m`` /
    ``trimSpatial``): keep the peak-connected blob; optional circular prior."""
    sp = params.spatial
    if sp.connected:
        A = connectivity_constraint(A, se_size=3)
    if sp.circular:
        A = circular_constraint(A)
    return A
