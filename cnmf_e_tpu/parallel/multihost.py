"""Multi-host ingest: per-host block loading into a globally sharded movie.

The reference's only "multi-node" story is a blocked HDF5 file on shared
storage read by every parfor worker (``get_patch_data.m:16-31``,
SURVEY.md 2.9 "worker data plane"). Here the data plane is device memory
and the device interconnect; only INGEST touches the filesystem, and each host should read only
the frame blocks its local devices own (DCN/filesystem traffic scales
1/n_hosts). This module provides that path:

  * :func:`init_distributed` — ``jax.distributed.initialize`` wrapper
    (no-op single-process, so the same driver script runs 1..N hosts)
  * :func:`load_sharded_movie` — every process reads its own frame range
    from a :class:`~cnmf_e_tpu.io.store.MovieStore` (chunked npy blocks on
    any filesystem; a shared FS is NOT required — each host may hold a
    copy or an object-store mount) and the pieces assemble into ONE global
    jax.Array via ``jax.make_array_from_process_local_data``, sharded
    (frame over hosts) x (patch within host)

The update step (``parallel/step.py``) then runs unchanged: its Gram
psums reduce over the frame axis across hosts (exact — the reference's
temporal-batch averaging made exact, ``update_spatial_batch.m:20-35``),
and stencil halo exchange stays within each host's patch axis.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cnmf_e_tpu.io.store import MovieStore


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize the JAX distributed runtime. Returns this process's id.

    Single-process (all args None, one host): no-op returning 0 — so
    drivers can call it unconditionally.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return 0
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def frame_range_for_process(T: int, mesh: Mesh) -> tuple[int, int]:
    """The [start, stop) frame range this process's devices own under a
    ``P("frame", "patch", None)`` movie sharding on ``mesh``."""
    n_frame = mesh.shape["frame"]
    per_shard = -(-T // n_frame)
    # which frame-shards live on local devices?
    ax = list(mesh.axis_names).index("frame")
    local_ids = set()
    dev_grid = np.asarray(mesh.devices)
    for idx in np.ndindex(dev_grid.shape):
        if dev_grid[idx].process_index == jax.process_index():
            local_ids.add(idx[ax])
    lo = min(local_ids) * per_shard
    hi = min(max(local_ids) * per_shard + per_shard, T)
    return lo, hi


def load_sharded_movie(store: MovieStore, mesh: Mesh,
                       dtype=jnp.float32) -> jax.Array:
    """Read only this host's frame range from ``store`` and assemble the
    global (T, H, W) movie sharded P("frame", "patch", None) on ``mesh``.

    Works identically single-host (reads everything) and multi-host (each
    process reads 1/n_hosts of the frames).
    """
    T, H, W = store.shape
    n_frame = mesh.shape["frame"]
    T_pad = -(-T // n_frame) * n_frame
    sharding = NamedSharding(mesh, P("frame", "patch", None))

    lo, hi = frame_range_for_process(T, mesh)
    local = store.read_frames(lo, hi - lo).astype(np.float32)
    hi_pad = (T_pad if hi == T else hi)
    if hi_pad > lo + local.shape[0]:   # zero-pad the trailing shard
        local = np.concatenate(
            [local, np.zeros((hi_pad - lo - local.shape[0], H, W),
                             np.float32)], axis=0)

    arr = jax.make_array_from_process_local_data(
        sharding, local, global_shape=(T_pad, H, W))
    return arr.astype(dtype)
