"""Immutable model state for the CNMF-E factorization.

Replaces the mutable ``Sources2D`` handle class
(``ca_source_extraction/@Sources2D/Sources2D.m:10-57``) with a frozen pytree:
fixed-capacity neuron slots (``K_max``) with an ``active`` validity mask keep
every shape static under jit; add/delete/merge only toggle masks and the
driver occasionally compacts slots host-side.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.ops.ring import RingWeights


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CNMFEState:
    """Factorization state: Y ~= A C + B, B from ring or low-rank model.

    A frozen dataclass registered as a pytree (every field is data), so it
    passes through ``jit`` and ``tree_map``; ``replace`` returns a copy
    with some fields swapped."""

    A: jnp.ndarray            # (K_max, H, W) spatial footprints (>= 0)
    C: jnp.ndarray            # (K_max, T) denoised traces
    C_raw: jnp.ndarray        # (K_max, T) raw traces (pre-deconvolution)
    S: jnp.ndarray            # (K_max, T) deconvolved spikes
    active: jnp.ndarray       # (K_max,) bool validity mask
    g: jnp.ndarray            # (K_max, p) AR coefficients per neuron
    neuron_sn: jnp.ndarray    # (K_max,) per-trace noise sigma
    b0: jnp.ndarray           # (H, W) constant background
    # ring background (1p): per-pixel ring weights; None for low-rank mode
    W: Optional[RingWeights] = None
    # low-rank background (2p): B = b f
    b: Optional[jnp.ndarray] = None   # (rank, H, W)
    f: Optional[jnp.ndarray] = None   # (rank, T)
    # quality-control bitmask per neuron (Sources2D tag semantics)
    tags: Optional[jnp.ndarray] = None  # (K_max,) int32

    def replace(self, **changes) -> "CNMFEState":
        return dataclasses.replace(self, **changes)

    @property
    def K_max(self) -> int:
        return self.A.shape[0]

    @property
    def shape_hw(self):
        return self.A.shape[1:]

    @property
    def T(self) -> int:
        return self.C.shape[-1]

    def n_active(self) -> jnp.ndarray:
        return jnp.sum(self.active)

    def masked_A(self) -> jnp.ndarray:
        return self.A * self.active[:, None, None]

    def masked_C(self) -> jnp.ndarray:
        return self.C * self.active[:, None]


def empty_state(K_max: int, H: int, W: int, T: int, p: int = 1,
                dtype=jnp.float32) -> CNMFEState:
    return CNMFEState(
        A=jnp.zeros((K_max, H, W), dtype),
        C=jnp.zeros((K_max, T), dtype),
        C_raw=jnp.zeros((K_max, T), dtype),
        S=jnp.zeros((K_max, T), dtype),
        active=jnp.zeros((K_max,), bool),
        g=jnp.full((K_max, p), 0.9, dtype),
        neuron_sn=jnp.zeros((K_max,), dtype),
        b0=jnp.zeros((H, W), dtype),
        tags=jnp.zeros((K_max,), jnp.int32),
    )


def compact(state: CNMFEState) -> CNMFEState:
    """Host-side: move active neurons to the front slots (stable order)."""
    active = np.asarray(state.active)
    order = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
    perm = jnp.asarray(order)
    return state.replace(
        A=state.A[perm], C=state.C[perm], C_raw=state.C_raw[perm],
        S=state.S[perm], active=state.active[perm], g=state.g[perm],
        neuron_sn=state.neuron_sn[perm],
        tags=None if state.tags is None else state.tags[perm])
