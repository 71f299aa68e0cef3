"""HALS block-coordinate updates for the spatial (A) and temporal (C) factors.

Reference: ``utilities/HALS_spatial.m:26-46`` and ``utilities/HALS_temporal.m:58-107``.
The per-neuron rank-1 updates are kept exactly (Gauss-Seidel over K neurons,
a ``lax.fori_loop``); the Gram precomputations U = Y C^T, V = C C^T are the
FLOP-heavy part and run as large matmuls. Under a (patch, frame) mesh the
Grams are computed on local shards and reduced with ``psum`` along the frame
axis — the exact version of the reference's energy-weighted patch averaging
(``update_temporal_parallel.m:264-280``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cnmf_e_tpu.ops.kernels import PALLAS, choose


def _kernel_chosen() -> bool:
    return choose("hals") == PALLAS


def _dot(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def hals_spatial_sweeps(U: jnp.ndarray, V: jnp.ndarray, A: jnp.ndarray,
                        mask: Optional[jnp.ndarray] = None,
                        n_iter: int = 5, block: int = 16,
                        use_pallas: Optional[bool] = None,
                        schedule=None) -> jnp.ndarray:
    """Gauss-Seidel spatial sweeps given precomputed Grams.

    Where :func:`cnmf_e_tpu.ops.kernels.choose` picks the kernel, the
    multi-sweep solve runs as the fused Pallas kernel (row-major
    transposes at the boundary); ``use_pallas`` overrides the choice, and
    callers running under a device mesh pass ``use_pallas=False``.

    U = Ysig @ Cc^T (d, K), V = Cc @ Cc^T (K, K). Callers that can express
    Ysig implicitly (e.g. the ring-background step, where
    Ysig = P + (W A) C) build U/V without materializing Ysig.

    The sweep is BLOCKED Gauss-Seidel (exact, same update order): the naive
    per-neuron update reads the full (d, K) A for its residual matvec —
    K reads of A per sweep, all bandwidth-bound. Here the block residual
    R = U_blk - A V_blk is computed once per ``block`` neurons (one read of
    A) and the in-block updates correct it with the (d, block) delta of
    columns updated so far — cutting sweep memory traffic by ~``block`` x.
    Every sweep dot runs at HIGHEST precision.
    """
    d, K = A.shape
    if use_pallas is None:
        use_pallas = _kernel_chosen()
    if use_pallas:
        from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
        out = hals_sweeps_rows_pallas(
            U.T, V, A.T, gate=jnp.ones(K, jnp.float32),
            mask=None if mask is None else mask.T,
            n_iter=n_iter, block=block, relu=True, schedule=schedule)
        return out.T
    cc = jnp.diag(V)
    if mask is not None:
        A = jnp.where(mask, A, 0.0)

    block = max(1, min(block, K))
    Kp = -(-K // block) * block
    if Kp != K:
        # pad with inert neurons: cc = 0 skips their update entirely
        U = jnp.pad(U, ((0, 0), (0, Kp - K)))
        V = jnp.pad(V, ((0, Kp - K), (0, Kp - K)))
        A = jnp.pad(A, ((0, 0), (0, Kp - K)))
        cc = jnp.pad(cc, (0, Kp - K))
        if mask is not None:
            mask = jnp.pad(mask, ((0, 0), (0, Kp - K)))

    def block_update(j, A):
        k0 = j * block
        Vb = jax.lax.dynamic_slice(V, (0, k0), (Kp, block))     # (Kp, b)
        Ub = jax.lax.dynamic_slice(U, (0, k0), (d, block))      # (d, b)
        ccb = jax.lax.dynamic_slice(cc, (k0,), (block,))
        A0 = jax.lax.dynamic_slice(A, (0, k0), (d, block))      # (d, b)
        R = Ub - _dot(A, Vb)                                    # (d, b)
        Vbb = jax.lax.dynamic_slice(Vb, (k0, 0), (block, block))
        mb = (jax.lax.dynamic_slice(mask, (0, k0), (d, block))
              if mask is not None else None)

        def inner(i, Ab):
            r = R[:, i] - _dot(Ab - A0, Vbb[:, i])
            ak = Ab[:, i] + r / jnp.maximum(ccb[i], 1e-12)
            ak = jnp.maximum(ak, 0.0)
            if mb is not None:
                ak = jnp.where(mb[:, i], ak, 0.0)
            ak = jnp.where(ccb[i] > 0, ak, Ab[:, i])
            return Ab.at[:, i].set(ak)

        Ab = jax.lax.fori_loop(0, block, inner, A0)
        return jax.lax.dynamic_update_slice(A, Ab, (0, k0))

    def sweep(_, A):
        return jax.lax.fori_loop(0, Kp // block, block_update, A)

    A = jax.lax.fori_loop(0, n_iter, sweep, A)
    return A[:, :K]


def hals_spatial_sweeps_rows(U: jnp.ndarray, V: jnp.ndarray, A: jnp.ndarray,
                             mask: Optional[jnp.ndarray] = None,
                             n_iter: int = 5, block: int = 16,
                             use_pallas: Optional[bool] = None,
                             schedule=None) -> jnp.ndarray:
    """Row-major spatial sweeps: A, U are (K, d) — the native
    ``A.reshape(K, d)`` layout. With the kernel chosen the whole
    multi-sweep solve runs as ONE fused Pallas kernel over column tiles
    of A; otherwise it runs the blocked XLA path via transposes. Callers
    running under a device mesh pass ``use_pallas=False`` (a pallas_call
    does not partition)."""
    if use_pallas is None:
        use_pallas = _kernel_chosen()
    if use_pallas:
        from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
        return hals_sweeps_rows_pallas(
            U, V, A, gate=jnp.ones(A.shape[0], jnp.float32), mask=mask,
            n_iter=n_iter, block=block, relu=True, schedule=schedule)
    out = hals_spatial_sweeps(U.T, V, A.T,
                              mask=None if mask is None else mask.T,
                              n_iter=n_iter, block=block, use_pallas=False)
    return out.T


@functools.partial(jax.jit, static_argnames=("n_iter", "colored"))
def hals_spatial(Y: jnp.ndarray, A: jnp.ndarray, C: jnp.ndarray,
                 mask: Optional[jnp.ndarray] = None,
                 n_iter: int = 5, colored: bool = False) -> jnp.ndarray:
    """Update A given C:  A <- max(0, A + (U - A V) / diag(V)) per neuron.

    Y: (d, T) background-subtracted data; A: (d, K); C: (K, T);
    mask: (d, K) search-location mask (True = allowed support).
    Means are removed from Y and C first (HALS_spatial.m:28-32).

    ``colored`` (requires ``mask``): order neurons by a greedy coloring
    of the mask-overlap graph so pairwise-independent rows share sweep
    steps, and pass the class step schedule to the fused Pallas kernel —
    the reference's independent-set update
    (``utilities/update_order.m:1-21``) on the masked spatial factor. The
    sweep result equals sequential Gauss-Seidel over the colored ordering
    up to float reassociation.
    """
    T = Y.shape[-1]
    Ymean = jnp.mean(Y, axis=1, keepdims=True)
    Cmean = jnp.mean(C, axis=1, keepdims=True)
    U = (_dot(Y, C.T) - T * (Ymean @ Cmean.T)).astype(A.dtype)  # (d, K)
    V = (_dot(C, C.T) - T * (Cmean @ Cmean.T)).astype(A.dtype)  # (K, K)
    if not (colored and mask is not None):
        return hals_spatial_sweeps(U, V, A, mask=mask, n_iter=n_iter)
    from cnmf_e_tpu.ops.coloring import (class_step_schedule,
                                         greedy_color, overlap_adjacency)
    M = mask.T                                              # (K, d)
    colors = greedy_color(overlap_adjacency(M))
    order = jnp.argsort(colors, stable=True)
    inverse = jnp.argsort(order)
    # class-aligned step schedule: every step updates one color class's
    # rows in a single 32-row vectorized step (update_order.m semantics)
    sched = class_step_schedule(colors[order], block=32)
    out = hals_spatial_sweeps(U[:, order], V[order][:, order],
                              A[:, order], mask=mask[:, order],
                              n_iter=n_iter, block=32, schedule=sched)
    return out[:, inverse]


def hals_temporal_sweeps(U: jnp.ndarray, V: jnp.ndarray, C: jnp.ndarray,
                         n_iter: int = 5,
                         active: Optional[jnp.ndarray] = None,
                         use_pallas: Optional[bool] = None,
                         schedule=None, block: int = 16) -> jnp.ndarray:
    """Gauss-Seidel temporal sweeps given precomputed Grams.

    U = A^T Ysig (K, T), V = A^T A (K, K); U stays fixed across sweeps
    (it is built from the pre-update C, like ``HALS_temporal.m:58-107``).
    With the kernel chosen the sweeps run as the fused Pallas kernel over
    frame tiles (same Gauss-Seidel order; see
    :func:`hals_spatial_sweeps_rows`); mesh callers pass
    ``use_pallas=False``.
    """
    if use_pallas is None:
        use_pallas = _kernel_chosen()
    if use_pallas:
        from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
        gate = (active if active is not None
                else jnp.ones(C.shape[0], jnp.float32))
        return hals_sweeps_rows_pallas(U, V, C, gate=gate,
                                       n_iter=n_iter, block=block,
                                       relu=False, schedule=schedule)
    # blocked Gauss-Seidel (same scheme as the spatial path): the naive
    # per-neuron update reads the full (K, T) C for its residual matvec —
    # K reads of C per sweep (~2 TB/sweep at the 100k-frame scale config,
    # K=2304). The block residual reads C once per ``block`` neurons and
    # the in-block delta correction keeps the update order exact.
    K, T = C.shape
    aa = jnp.diag(V)
    gate = jnp.ones((K,), jnp.float32) if active is None \
        else active.astype(jnp.float32)
    block = max(1, min(16, K))
    Kp = -(-K // block) * block
    if Kp != K:
        U = jnp.pad(U, ((0, Kp - K), (0, 0)))
        V = jnp.pad(V, ((0, Kp - K), (0, Kp - K)))
        C = jnp.pad(C, ((0, Kp - K), (0, 0)))
        aa = jnp.pad(aa, (0, Kp - K))
        gate = jnp.pad(gate, (0, Kp - K))

    def block_update(j, C):
        k0 = j * block
        Vb = jax.lax.dynamic_slice(V, (k0, 0), (block, Kp))     # (b, Kp)
        Ub = jax.lax.dynamic_slice(U, (k0, 0), (block, C.shape[1]))
        aab = jax.lax.dynamic_slice(aa, (k0,), (block,))
        gb = jax.lax.dynamic_slice(gate, (k0,), (block,))
        C0 = jax.lax.dynamic_slice(C, (k0, 0), (block, C.shape[1]))
        R = Ub - _dot(Vb, C)                                    # (b, T)
        Vbb = jax.lax.dynamic_slice(Vb, (0, k0), (block, block))

        def inner(i, Cb):
            r = R[i] - _dot((Cb - C0).T, Vbb[i])
            ck = Cb[i] + r / jnp.maximum(aab[i], 1e-12)
            ck = jnp.where((aab[i] > 0) & (gb[i] > 0), ck, Cb[i])
            return Cb.at[i].set(ck)

        Cb = jax.lax.fori_loop(0, block, inner, C0)
        return jax.lax.dynamic_update_slice(C, Cb, (k0, 0))

    def sweep(_, C):
        return jax.lax.fori_loop(0, Kp // block, block_update, C)

    C = jax.lax.fori_loop(0, n_iter, sweep, C)
    return C[:K]


@functools.partial(jax.jit, static_argnames=("n_iter", "colored"))
def hals_temporal(Y: jnp.ndarray, A: jnp.ndarray, C: jnp.ndarray,
                  n_iter: int = 5,
                  active: Optional[jnp.ndarray] = None,
                  colored: bool = False
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Update C given A:  c_k <- c_k + (U_k - V_k C) / aa_k (no deconvolution).

    Y: (d, T); A: (d, K); C: (K, T). Returns (C_raw, aa) where aa = ||a_k||^2
    (the cross-patch reduction weights of the reference). Deconvolution /
    baseline handling is applied by the caller on C_raw
    (HALS_temporal.m:58-107 folds it per neuron; we batch it over neurons).

    ``colored``: order neurons by a greedy coloring of the footprint
    overlap graph (V = A^T A has EXACT zeros for disjoint footprints) and
    pass the class step schedule to the Pallas kernel's vectorized steps
    (``utilities/update_order.m:1-21`` semantics).
    """
    U = _dot(A.T, Y).astype(C.dtype)       # (K, T)
    V = _dot(A.T, A).astype(C.dtype)       # (K, K)
    if not colored:
        C = hals_temporal_sweeps(U, V, C, n_iter=n_iter, active=active)
        return C, jnp.diag(V)
    from cnmf_e_tpu.ops.coloring import class_step_schedule, greedy_color
    K = V.shape[0]
    adj = (V != 0) & ~jnp.eye(K, dtype=bool)
    colors = greedy_color(adj)
    order = jnp.argsort(colors, stable=True)
    inverse = jnp.argsort(order)
    Vp = V[order][:, order]
    act = None if active is None else active[order]
    sched = class_step_schedule(colors[order], block=32)
    out = hals_temporal_sweeps(U[order], Vp, C[order],
                               n_iter=n_iter, active=act, block=32,
                               schedule=sched)
    return out[inverse], jnp.diag(V)


def hals_nmf(Y: jnp.ndarray, A: jnp.ndarray, C: jnp.ndarray,
             n_iter: int = 10,
             mask: Optional[jnp.ndarray] = None
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Alternate spatial/temporal HALS (used for rank-1 merge refits and the
    simple init refinement, reference: ``merge_neurons_dist_corr.m:180-187``)."""
    for _ in range(n_iter):
        A = hals_spatial(Y, A, C, mask=mask, n_iter=1)
        C, _ = hals_temporal(Y, A, C, n_iter=1)
        C = jnp.maximum(C, 0.0)
    return A, C
