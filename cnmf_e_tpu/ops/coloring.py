"""Overlap-graph coloring for order-free Gauss-Seidel HALS updates.

Reference: ``utilities/update_order.m:1-21`` — the reference partitions
neurons into independent sets (via approximate vertex cover on the
``A'*A > 0`` overlap graph) so ``update_temporal_components.m`` can update
each set simultaneously. This module recasts it as a greedy graph coloring
computed ON DEVICE (a K-step ``fori_loop`` over small vectors, so the
neuron ordering lives inside the jitted update program), plus the
class-aligned step schedule consumed by the fused Pallas HALS kernel's
vectorized steps (:mod:`cnmf_e_tpu.ops.pallas_hals`).

Two exactness facts make the colored update equal the sequential sweep
(``HALS_temporal.m:58-107`` order semantics) up to float reassociation:

* temporal factor: the coupling is V = A A^T, and disjoint footprints
  give V[i, j] = 0 EXACTLY (the Gram sums pixelwise products that are
  each exactly zero), so the sequential correction term vanishes.
* spatial factor: the update is per-pixel; with search-location masks
  (``determine_search_location.m``) a neuron only changes pixels inside
  its own mask, so rows with disjoint masks cannot interact even though
  their trace Gram V = C C^T is dense.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def overlap_adjacency(support: jnp.ndarray) -> jnp.ndarray:
    """Boolean overlap graph of row supports. ``support``: (K, d) — any
    nonneg array whose positive entries mark the support (footprints or
    search masks). Returns (K, K) bool with zero diagonal (the
    reference's ``F = (A'*A>0); F(diag)=0``, update_order.m:4-5)."""
    S = (support > 0).astype(jnp.float32)
    O = S @ S.T
    K = S.shape[0]
    return (O > 0) & ~jnp.eye(K, dtype=bool)


def greedy_color(adj: jnp.ndarray) -> jnp.ndarray:
    """Greedy sequential coloring of an undirected graph, on device.

    adj: (K, K) bool, symmetric, zero diagonal. Returns colors (K,)
    int32 in [0, max_degree]. K sequential steps of O(K) vector work —
    negligible against the movie-sized Grams it reorders."""
    K = adj.shape[0]

    def body(k, colors):
        nbr = adj[k]                                     # (K,) bool
        # mark colors used by (already-colored) neighbors; uncolored
        # rows carry the sentinel K and land in the spill slot
        slot = jnp.where(nbr, colors, K)
        used = jnp.zeros((K + 1,), bool).at[slot].set(True)
        c = jnp.argmin(used[:K]).astype(jnp.int32)       # first unused
        return colors.at[k].set(c)

    return jax.lax.fori_loop(0, K, body, jnp.full((K,), K, jnp.int32))


def color_order(adj: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Permutation putting same-color (pairwise non-overlapping) rows
    contiguous. Returns (order, inverse) index vectors; apply as
    ``X[order]`` before the sweeps and ``X[inverse]`` after."""
    colors = greedy_color(adj)
    order = jnp.argsort(colors, stable=True)
    inverse = jnp.argsort(order)
    return order, inverse


def class_step_schedule(colors: jnp.ndarray, block: int,
                        n_cap: Optional[int] = None
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                   jnp.ndarray]:
    """Class-aligned sweep schedule for the Pallas HALS kernel.

    Assumes rows are already in colored order (``color_order``). Emits
    one step per ``block`` rows of each color class, RESTARTING the
    block grid at every class boundary: step j covers rows
    [starts[j], min(starts[j] + block, ends[j])) where ends[j] is the
    class end — so every step's updated rows are pairwise independent
    (same color) and the kernel applies them in ONE vectorized update
    with a block-row residual matmul (update_order.m:1-21 semantics).

    Dynamic class sizes can overflow the static step capacity
    ``n_cap`` (default ceil(K/block) + 32); the schedule then falls back
    to the plain block grid, each block marked free only if one class
    covers it — the kernel's sequential path keeps correctness.

    Returns (starts, ends, free, n_steps): (n_cap,) int32 x3 + scalar
    int32. Unused slots carry start = end = K (no rows; the kernel's
    traced trip count never reaches them anyway).
    """
    K = colors.shape[0]
    nb_static = -(-K // block)
    if n_cap is None:
        n_cap = nb_static + 32
    # the overflow fallback emits one step per plain block — the
    # capacity must hold at least those (reads past n_cap are out of bounds)
    n_cap = max(n_cap, nb_static)
    counts = jnp.bincount(colors, length=K)                 # per color
    cstart = jnp.cumsum(counts) - counts                    # class starts
    cend = cstart + counts
    r = jnp.arange(K)
    cs = colors  # rows already sorted by color: colors[r] nondecreasing
    # a row opens a new step at the class start, then every `block` rows
    # on the grid anchored at the 8-ALIGNED class start: the kernel
    # slices [align8(start), align8(start) + block) and gates the update
    # to [start, end) — anchoring at align8(cstart) keeps consecutive
    # steps' gated row ranges contiguous
    cs8 = (cstart // 8) * 8
    opens = (r == cstart[cs]) | ((r > cstart[cs])
                                 & ((r - cs8[cs]) % block == 0))
    step_of_open = jnp.cumsum(opens) - 1
    n_steps = jnp.sum(opens).astype(jnp.int32)

    fits = n_steps <= n_cap
    # class-aligned schedule (scatter the opening rows' start/end)
    big = jnp.int32(K)
    starts_cls = jnp.full((n_cap,), big, jnp.int32).at[
        jnp.where(opens, step_of_open, n_cap)].set(
        r.astype(jnp.int32), mode="drop")
    ends_cls = jnp.full((n_cap,), big, jnp.int32).at[
        jnp.where(opens, step_of_open, n_cap)].set(
        cend[cs].astype(jnp.int32), mode="drop")
    free_cls = jnp.ones((n_cap,), jnp.int32)

    # fallback: plain block grid (starts j*B, gated only by K)
    nb = -(-K // block)
    jj = jnp.arange(n_cap)
    starts_blk = jnp.where(jj < nb, jj * block, big).astype(jnp.int32)
    ends_blk = jnp.where(jj < nb, jnp.int32(K), big)
    # a fallback block is free iff no class boundary crosses it: every
    # row in the block shares the color of the block's first row
    first_color = cs[jnp.clip(starts_blk, 0, K - 1)]
    last_row = jnp.clip(jnp.minimum(starts_blk + block, K) - 1, 0, K - 1)
    free_blk = (cs[last_row] == first_color).astype(jnp.int32) \
        * (jj < nb)

    starts = jnp.where(fits, starts_cls, starts_blk)
    ends = jnp.where(fits, ends_cls, ends_blk)
    free = jnp.where(fits, free_cls, free_blk)
    n_used = jnp.where(fits, n_steps, jnp.int32(nb))
    return starts, ends, free, n_used
