"""Neuron merging.

Reference family (``@Sources2D/merge_neurons_dist_corr.m``,
``merge_high_corr.m``, ``quickMerge.m``): build a candidate graph from
pairwise statistics, cluster with connected components (the C++ MEX), refit
each cluster with a rank-1 alternating LS, re-deconvolve the merged trace.

Structure: ONE jitted program computes every pairwise statistic (K x K
matmuls) and the host fetches only those tiny matrices; the graph
clustering runs host-side through the C++ union-find; then ONE jitted
program applies ALL cluster refits simultaneously (clusters encoded as a
fixed-capacity membership matrix, the alternating rank-1 LS batched over
clusters as masked matmuls); re-deconvolution reuses the standalone
``deconvolve`` program on the full (K_max, T) trace block. Footprints never
round-trip through the host and no program shape depends on how many
clusters merged, so each shape compiles once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.models.state import CNMFEState
from cnmf_e_tpu.native import connected_components
from cnmf_e_tpu.ops.noise import noise_psd
from cnmf_e_tpu.ops.oasis import deconvolve


def decay_times(state: CNMFEState) -> np.ndarray:
    """Per-neuron decay time constant (frames) from the AR coefficients:
    tau_d = -1 / log(d) with d the dominant root (``ar2exp`` of the kernel
    pars, as in ``Sources2D.m:585-596``)."""
    g = np.asarray(state.g)
    if g.shape[1] == 1:
        d = np.clip(g[:, 0], 1e-4, 1 - 1e-6)
    else:
        g1, g2 = g[:, 0], g[:, 1]
        d = (g1 + np.sqrt(np.maximum(g1 * g1 + 4 * g2, 0.0))) / 2.0
        d = np.clip(d, 1e-4, 1 - 1e-6)
    return -1.0 / np.log(d)


@jax.jit
def _merge_stats(state: CNMFEState):
    """All pairwise merge statistics in one program, stacked into a
    single (10, K, K) float32 array — the ONLY device->host fetch a merge
    pass needs (rows: dist_mean, corr_C, cos_A, corr_Craw, corr_S, energy,
    active, g1, g2, dist_max — rows 5-8 broadcast per-neuron vectors; g2
    is zero for AR(1) states). Both center estimators ship in one fetch:
    row 0 = center-of-mass distance (``estCenter``), row 9 = footprint-peak
    distance (``merge_neurons_dist_corr.m:63-66``, method_dist='max')."""
    K = state.K_max
    A3 = state.masked_A()
    H, W = A3.shape[1:]
    mass = jnp.sum(A3, axis=(1, 2)) + 1e-12
    cy = jnp.sum(A3 * jnp.arange(H, dtype=A3.dtype)[None, :, None],
                 axis=(1, 2)) / mass
    cx = jnp.sum(A3 * jnp.arange(W, dtype=A3.dtype)[None, None, :],
                 axis=(1, 2)) / mass

    def pair_dist(cy, cx):
        dy = cy[:, None] - cy[None, :]
        dx = cx[:, None] - cx[None, :]
        return jnp.sqrt(dy * dy + dx * dx)

    dist = pair_dist(cy, cx)
    pk = jnp.argmax(A3.reshape(K, -1), axis=1)
    dist_max = pair_dist((pk // W).astype(A3.dtype),
                         (pk % W).astype(A3.dtype))

    def corr_rows(X):
        Xc = X - jnp.mean(X, axis=1, keepdims=True)
        n = jnp.linalg.norm(Xc, axis=1) + 1e-12
        return (Xc @ Xc.T) / jnp.outer(n, n)

    A = A3.reshape(K, -1)
    na = jnp.linalg.norm(A, axis=1) + 1e-12
    cos_A = (A @ A.T) / jnp.outer(na, na)

    corr_C = corr_rows(state.C)
    corr_Craw = corr_rows(state.C_raw)
    # S from thresholded diff of C_raw when spikes absent
    Sdiff = jnp.maximum(jnp.diff(state.C_raw, axis=1,
                                 prepend=jnp.zeros((K, 1))), 0.0)
    corr_S = jax.lax.cond(jnp.any(state.S != 0),
                          lambda: corr_rows(state.S),
                          lambda: corr_rows(Sdiff))
    # per-neuron energy rides along (broadcast into a K x K row) so the
    # host fetches ONE stacked array — separate np.asarray fetches each
    # pay a device round trip
    energy = (jnp.sum(state.A * state.A, axis=(1, 2))
              * jnp.sum(state.C_raw * state.C_raw, axis=1))
    g1 = state.g[:, 0].astype(jnp.float32)
    g2 = (state.g[:, 1].astype(jnp.float32) if state.g.shape[1] > 1
          else jnp.zeros((K,), jnp.float32))
    return jnp.stack([
        dist, corr_C, cos_A, corr_Craw, corr_S,
        jnp.broadcast_to(energy[None, :], (K, K)),
        jnp.broadcast_to(state.active[None, :].astype(jnp.float32),
                         (K, K)),
        jnp.broadcast_to(g1[None, :], (K, K)),
        jnp.broadcast_to(g2[None, :], (K, K)),
        dist_max])


@functools.partial(jax.jit, static_argnames=("params",))
def _merge_adjacency(state: CNMFEState, params: CNMFEParams) -> jnp.ndarray:
    """All three candidate adjacencies + survivor ranking, ON DEVICE, in
    one (3, K, K) uint8 fetch (~110 KB at K=192, instead of the raw f32
    statistics).

    Planes: 0 = dist_corr (merge_neurons_dist_corr.m:54-82 incl. the
    decay gate), 1 = dist_only (merge_close_neighbors.m), 2 = high_corr
    (merge_high_corr.m:50-83). The always-zero DIAGONALS carry side
    channels: plane0/plane1 diag = energy-rank low/high byte (the
    cluster-survivor ordering), plane2 diag = active flag.
    """
    mp = params.merge
    K = state.K_max
    st = _merge_stats(state)
    dist = st[9] if mp.method_dist == "max" else st[0]
    corr_C, cos_A = st[1], st[2]
    corr_Craw, corr_S, energy = st[3], st[4], st[5][0]
    g1, g2 = st[7][0], st[8][0]
    act2 = jnp.outer(state.active, state.active)
    off_diag = ~jnp.eye(K, dtype=bool)

    adj_dc = (dist <= mp.dmin) & (corr_C >= mp.merge_thr)
    if mp.max_decay_diff is not None:
        d = (g1 + jnp.sqrt(jnp.maximum(g1 * g1 + 4 * g2, 0.0))) / 2.0
        tau = -1.0 / jnp.log(jnp.clip(d, 1e-4, 1 - 1e-6))
        adj_dc &= (jnp.abs(tau[:, None] - tau[None, :])
                   <= mp.max_decay_diff)
    adj_do = dist <= mp.dmin_only
    a_thr, c_thr, s_thr = mp.merge_thr_spatial
    adj_hc = jnp.ones((K, K), bool)
    if a_thr > 0:
        adj_hc &= cos_A >= a_thr
    if c_thr > 0:
        adj_hc &= corr_Craw >= c_thr
    if s_thr > 0:
        adj_hc &= corr_S >= s_thr

    packed = jnp.stack([adj_dc, adj_do, adj_hc]) & (act2 & off_diag)[None]
    packed = packed.astype(jnp.uint8)
    rank = jnp.argsort(jnp.argsort(energy)).astype(jnp.uint32)
    di = jnp.arange(K)
    packed = packed.at[0, di, di].set((rank & 0xFF).astype(jnp.uint8))
    packed = packed.at[1, di, di].set((rank >> 8).astype(jnp.uint8))
    packed = packed.at[2, di, di].set(state.active.astype(jnp.uint8))
    return packed


def merge_candidates_dist_corr(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Adjacency for distance+correlation merging
    (``merge_neurons_dist_corr.m:54-82``), with the optional decay-time
    gate (``:74-81``: skip pairs whose decay constants differ by more than
    ``max_decay_diff`` frames)."""
    st = np.asarray(stats if stats is not None else _merge_stats(state))
    dist = st[9] if params.merge.method_dist == "max" else st[0]
    cc, active = st[1], st[6][0] > 0
    adj = (dist <= params.merge.dmin) & (cc >= params.merge.merge_thr)
    if params.merge.max_decay_diff is not None:
        # decay gate from the fetched g rows (same dominant-root formula
        # as decay_times, but without a second device fetch of state.g)
        g1, g2 = st[7][0], st[8][0]
        d = (g1 + np.sqrt(np.maximum(g1 * g1 + 4 * g2, 0.0))) / 2.0
        d = np.clip(d, 1e-4, 1 - 1e-6)
        tau = -1.0 / np.log(d)
        adj &= (np.abs(tau[:, None] - tau[None, :])
                <= params.merge.max_decay_diff)
    adj &= np.outer(active, active)
    np.fill_diagonal(adj, False)
    return adj


def merge_candidates_high_corr(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Adjacency for the (A overlap, C corr, S corr) triple threshold
    (``merge_high_corr.m:50-83`` / ``quickMerge.m:34-60``)."""
    a_thr, c_thr, s_thr = params.merge.merge_thr_spatial
    st = np.asarray(stats if stats is not None else _merge_stats(state))
    cos_A, corr_Craw, corr_S, active = st[2], st[3], st[4], st[6][0] > 0
    K = len(active)
    adj = np.ones((K, K), bool)
    if a_thr > 0:
        adj &= cos_A >= a_thr
    if c_thr > 0:
        adj &= corr_Craw >= c_thr
    if s_thr > 0:
        adj &= corr_S >= s_thr
    adj &= np.outer(active, active)
    np.fill_diagonal(adj, False)
    return adj


def merge_candidates_dist_only(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Distance-only adjacency (reference ``merge_close_neighbors.m`` /
    ``MergeNeighbors.m`` with dmin_only): any two active neurons whose
    centers are within ``dmin_only`` merge unconditionally."""
    st = np.asarray(stats if stats is not None else _merge_stats(state))
    dist = st[9] if params.merge.method_dist == "max" else st[0]
    active = st[6][0] > 0
    adj = dist <= params.merge.dmin_only
    adj &= np.outer(active, active)
    np.fill_diagonal(adj, False)
    return adj


def merge_pairs(state: CNMFEState, params: CNMFEParams,
                pairs, deconv: bool = True) -> Tuple[CNMFEState, int]:
    """Manually merge the given (i, j) index pairs (reference:
    ``manual_merge`` / ``manual_merge_multi_pairs``) — the automated
    framework's replacement for the interactive flows."""
    K = state.K_max
    adj = np.zeros((K, K), bool)
    for i, j in pairs:
        adj[i, j] = adj[j, i] = True
    return _merge_with_adjacency(state, params, adj, deconv=deconv)


def merge_neurons(state: CNMFEState, params: CNMFEParams,
                  mode: str = "dist_corr",
                  deconv: bool = True) -> Tuple[CNMFEState, int]:
    """Cluster candidates and merge each cluster by rank-1 refit.

    Returns (new_state, n_merged_clusters). The merged component lands in
    the slot of the cluster's highest-energy member; other members
    deactivate (fixed-capacity slot semantics). ``n_merged_clusters`` is
    a DEVICE scalar: formatting or int()-ing it forces the fetch, so a
    non-verbose pipeline never syncs on a merge pass at all (the whole
    merge — candidate graph, connected components, cluster bookkeeping,
    batched rank-1 refits — runs on device; see ``_cluster_device``).

    ``deconv=False`` skips the post-merge re-deconvolution (the reference
    re-deconvolves merged traces, ``merge_neurons_dist_corr.m:193-200``;
    a pipeline whose very next stage is a full temporal update — which
    re-deconvolves every trace anyway — can defer it and save the
    (K_max, T) OASIS pass + a dispatch per merge call).
    """
    plane = {"dist_corr": 0, "dist_only": 1, "high_corr": 2}[mode]
    members, keep, valid, nm = _cluster_device(state, params, plane)
    state2, merged_mask = _merge_apply(
        state, members, keep, valid,
        refit_iters=params.merge.refit_iters)
    if deconv and params.temporal.deconv.enabled:
        sn = noise_psd(state2.C_raw)
        res = deconvolve(state2.C_raw, params.temporal.deconv, sn=sn)
        state2 = _deconv_writeback(state2, merged_mask, res.c, res.s,
                                   res.b, res.g)
    return state2, nm


@functools.partial(jax.jit, static_argnames=("params", "plane"))
def _cluster_device(state: CNMFEState, params: CNMFEParams, plane: int):
    """Connected components + cluster bookkeeping ON DEVICE.

    The host union-find path (``connected_components`` C++) needs a
    ~110 KB adjacency fetch per merge pass — ~6 forced syncs per
    pipeline fit. Here reachability closes by
    ceil(log2 K) boolean matmul squarings of (adj | I) — exact transitive
    closure, a few (K, K) matmuls — and the membership matrix /
    survivor slots / cluster count come out as device arrays feeding
    ``_merge_apply`` directly. Reference semantics:
    ``merge_neurons_dist_corr.m:83-86`` (graph_connected_comp) with the
    survivor = highest-energy member.

    Returns (members (Kc, K) f32, keep (Kc,) i32, valid (Kc,) bool,
    nm scalar i32)."""
    mp = params.merge
    K = state.K_max
    st = _merge_stats(state)
    dist = st[9] if mp.method_dist == "max" else st[0]
    corr_C, cos_A = st[1], st[2]
    corr_Craw, corr_S, energy = st[3], st[4], st[5][0]
    g1, g2 = st[7][0], st[8][0]
    act2 = jnp.outer(state.active, state.active)
    off_diag = ~jnp.eye(K, dtype=bool)

    if plane == 0:
        adj = (dist <= mp.dmin) & (corr_C >= mp.merge_thr)
        if mp.max_decay_diff is not None:
            d = (g1 + jnp.sqrt(jnp.maximum(g1 * g1 + 4 * g2, 0.0))) / 2.0
            tau = -1.0 / jnp.log(jnp.clip(d, 1e-4, 1 - 1e-6))
            adj &= (jnp.abs(tau[:, None] - tau[None, :])
                    <= mp.max_decay_diff)
    elif plane == 1:
        adj = dist <= mp.dmin_only
    else:
        a_thr, c_thr, s_thr = mp.merge_thr_spatial
        adj = jnp.ones((K, K), bool)
        if a_thr > 0:
            adj &= cos_A >= a_thr
        if c_thr > 0:
            adj &= corr_Craw >= c_thr
        if s_thr > 0:
            adj &= corr_S >= s_thr
    adj &= act2 & off_diag

    # transitive closure by squaring: R holds reachability within 2^i hops
    R = (adj | jnp.eye(K, dtype=bool)).astype(jnp.float32)
    n_sq = max(int(np.ceil(np.log2(max(K, 2)))), 1)
    for _ in range(n_sq):
        R = ((R @ R) > 0).astype(jnp.float32)
    Rb = R > 0
    comp_min = jnp.argmax(Rb, axis=1)          # first reachable = root id
    valid_node = jnp.any(adj, axis=1)          # edges pair -> comp size >= 2
    idx = jnp.arange(K)
    root = (comp_min == idx) & valid_node
    slot_at = jnp.cumsum(root.astype(jnp.int32)) - 1   # slot of each root
    slot_of = slot_at[comp_min]                # valid only where valid_node

    Kc = max(K // 2, 1)
    members = ((slot_of[None, :] == jnp.arange(Kc)[:, None])
               & valid_node[None, :]).astype(jnp.float32)
    e_m = jnp.where(members > 0, energy[None, :], -jnp.inf)
    keep = jnp.argmax(e_m, axis=1).astype(jnp.int32)
    valid = jnp.any(members > 0, axis=1)
    nm = jnp.sum(root.astype(jnp.int32))
    return members, keep, valid, nm


def _unpack_adjacency(packed: np.ndarray, mode: str):
    K = packed.shape[-1]
    di = np.arange(K)
    rank = (packed[0, di, di].astype(np.int64)
            | (packed[1, di, di].astype(np.int64) << 8))
    active = packed[2, di, di] > 0
    plane = {"dist_corr": 0, "dist_only": 1, "high_corr": 2}[mode]
    adj = packed[plane].astype(bool).copy()
    adj[di, di] = False
    return adj, rank, active


def merge_neurons_seq(state: CNMFEState, params: CNMFEParams,
                      modes, deconv: bool = True
                      ) -> Tuple[CNMFEState, int]:
    """Run several merge modes back to back on ONE adjacency fetch.

    All three candidate adjacencies come out of the same device program
    (``_merge_adjacency``, a ~110 KB uint8 fetch instead of the ~1.3 MB
    f32 statistics), so consecutive modes (the pipeline's final
    dist_corr + high_corr pass, ``demo_large_data_1p.m:199-213``) share a
    single fetch; a refetch happens only when an earlier mode actually
    merged (state changed). Returns (state, total clusters merged)."""
    packed = None
    total = 0
    for mode in modes:
        if packed is None:
            packed = np.asarray(_merge_adjacency(state, params))
        adj, rank, active = _unpack_adjacency(packed, mode)
        state2, nm = _merge_with_adjacency(state, params, adj, rank=rank,
                                           active=active, deconv=deconv)
        if nm:
            state, packed = state2, None
        total += nm
    return state, total


@functools.partial(jax.jit, static_argnames=("refit_iters",))
def _merge_apply(state: CNMFEState, members: jnp.ndarray, keep: jnp.ndarray,
                 valid: jnp.ndarray, refit_iters: int):
    """Apply all cluster merges in one program.

    members: (Kc, K) float32 membership matrix (1 where neuron k belongs to
    cluster j); keep: (Kc,) int32 surviving slot per cluster; valid: (Kc,)
    bool. Invalid clusters scatter to the out-of-bounds sentinel slot K and
    drop. The rank-1 refit (``merge_neurons_dist_corr.m:180-187``, 10
    alternating LS steps) runs batched over clusters as masked matmuls.

    Returns (state, merged_mask (K,) bool marking slots holding a freshly
    merged trace that still needs re-deconvolution)."""
    K = state.K_max
    A = state.A.reshape(K, -1)                       # (K, d)
    C_raw = state.C_raw                              # (K, T)

    a = members @ A                                  # (Kc, d) union support
    c = C_raw[jnp.clip(keep, 0, K - 1)]              # (Kc, T)

    def body(_, ac):
        a, c = ac
        # a_j = relu( sum_k m_jk (C_raw_k . c_j) A_k ) / (c_j . c_j)
        Wm = members * (C_raw @ c.T).T               # (Kc, K)
        a = jnp.maximum(Wm @ A, 0.0) / \
            jnp.maximum(jnp.sum(c * c, axis=1, keepdims=True), 1e-12)
        # c_j = relu( sum_k m_jk (A_k . a_j) C_raw_k ) / (a_j . a_j)
        Vm = members * (A @ a.T).T                   # (Kc, K)
        c = jnp.maximum(Vm @ C_raw, 0.0) / \
            jnp.maximum(jnp.sum(a * a, axis=1, keepdims=True), 1e-12)
        return a, c

    a, c = jax.lax.fori_loop(0, refit_iters, body, (a, c))

    keep_slot = jnp.where(valid, keep, K)            # sentinel -> dropped
    vm = valid.astype(members.dtype)
    member_of_valid = (vm @ members) > 0             # (K,)
    active = state.active & ~member_of_valid
    active = active.at[keep_slot].set(True, mode="drop")
    merged_mask = jnp.zeros((K,), bool).at[keep_slot].set(True, mode="drop")

    zero = ~member_of_valid[:, None]
    A_new = jnp.where(zero, A, 0.0).at[keep_slot].set(a, mode="drop")
    C_raw_new = jnp.where(zero, C_raw, 0.0).at[keep_slot].set(c, mode="drop")
    C_new = jnp.where(zero, state.C, 0.0).at[keep_slot].set(c, mode="drop")
    # S of deactivated members zeros; the keep slot keeps its stale spikes
    # until the re-deconvolution pass overwrites them
    S_new = state.S * active[:, None]
    state = state.replace(
        A=A_new.reshape(state.A.shape), C=C_new, C_raw=C_raw_new, S=S_new,
        active=active)
    return state, merged_mask


@jax.jit
def _deconv_writeback(state: CNMFEState, merged_mask, c, s, b, g):
    m = merged_mask[:, None]
    return state.replace(
        C=jnp.where(m, c, state.C),
        C_raw=jnp.where(m, state.C_raw - b[:, None], state.C_raw),
        S=jnp.where(m, s, state.S),
        g=jnp.where(m, g[:, :state.g.shape[1]], state.g))


def _merge_with_adjacency(state: CNMFEState, params: CNMFEParams,
                          adj: np.ndarray, stats=None, rank=None,
                          active=None,
                          deconv: bool = True) -> Tuple[CNMFEState, int]:
    if not adj.any():
        return state, 0

    labels, ncomp = connected_components(adj)
    if rank is None or active is None:
        st = np.asarray(stats if stats is not None
                        else _merge_stats(state))
        active = st[6][0] > 0
        rank = st[5][0]          # raw energy orders the same as its rank
    energy = rank

    K = state.K_max
    Kc = max(K // 2, 1)
    members = np.zeros((Kc, K), np.float32)
    keep = np.zeros((Kc,), np.int32)
    valid = np.zeros((Kc,), bool)
    n_merged = 0
    for comp in range(ncomp):
        ids = np.nonzero((labels == comp) & active)[0]
        if len(ids) < 2:
            continue
        # skip clusters that are not actually connected (singleton labels
        # cover all nodes); require at least one edge inside
        if not adj[np.ix_(ids, ids)].any():
            continue
        members[n_merged, ids] = 1.0
        keep[n_merged] = ids[int(np.argmax(energy[ids]))]
        valid[n_merged] = True
        n_merged += 1

    if n_merged == 0:
        return state, 0

    state, merged_mask = _merge_apply(
        state, jnp.asarray(members), jnp.asarray(keep), jnp.asarray(valid),
        refit_iters=params.merge.refit_iters)

    # re-deconvolve: run the standard (K_max, T) deconvolution program (the
    # same compiled program the temporal update uses) and write back only
    # the merged slots
    if deconv and params.temporal.deconv.enabled:
        sn = noise_psd(state.C_raw)
        res = deconvolve(state.C_raw, params.temporal.deconv, sn=sn)
        state = _deconv_writeback(state, merged_mask, res.c, res.s, res.b,
                                  res.g)
    return state, n_merged


