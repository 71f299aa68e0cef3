"""Out-of-core pipeline for movies larger than device memory.

The temporal-batch mode (:mod:`cnmf_e_tpu.models.batch`) mirrors the
reference's approximate batch semantics; this module makes the factor
updates EXACT under streaming by accumulating the frame-axis Gram sums over
blocks (what a frame-sharded mesh would psum):

  spatial:   U = sum_b Ysig_b C_b^T,  V = sum_b C_b C_b^T  -> HALS on (U, V)
  ring fit:  Gram accumulation per pixel is already time-blocked
  temporal:  per-block trace solves are independent given A and the
             background; deconvolution runs on the concatenated traces
             (K x T fits on-device even at 100k frames)

Initialization runs on a temporally decimated in-memory proxy movie (tsub
chosen so it fits the budget) and is refined at full rate by the streaming
updates.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.io.store import MovieStore
from cnmf_e_tpu.models.initialize import initialize_greedy
from cnmf_e_tpu.models.merge import merge_neurons
from cnmf_e_tpu.models.qc import remove_false_positives, tag_neurons
from cnmf_e_tpu.models.state import CNMFEState, compact
from cnmf_e_tpu.ops.kernels import PALLAS, choose
from cnmf_e_tpu.ops.oasis import deconvolve
from cnmf_e_tpu.ops.ring import (apply_ring, fit_ring_weights,
                                 ring_offsets)


def _ring_subtract(Yb, A_dk, C_b, b0, weights, radius, H, W):
    """``A_dk``: footprints in (d, K) layout — the reconstruction
    contraction then has native contracting dims. The former (K, H, W)
    einsum re-laid A out per BLOCK PROGRAM (a 2.4 GB transient at
    config-5 scale, every chunk), which drove a spatial-pass out-of-memory
    on a 16 GB device; the caller materializes the (d, K) copy once per pass instead."""
    T_b = Yb.shape[0]
    recon = jnp.einsum("dk,kt->td", A_dk, C_b).reshape(T_b, H, W)
    X = Yb - b0[None] - recon
    # the weighted-shift stencil fuses into one loop; under a mesh it
    # partitions over the 'patch' axis with automatic halo exchange
    from cnmf_e_tpu.ops.ring import apply_ring
    return Yb - (apply_ring(weights, X, H, W, radius) + b0[None])


# Per-block programs are individually jitted: the streaming loops visit
# 100+ blocks at scale, and every EAGER op in the block body would be its
# own dispatch.


def _prefetch_device_blocks(store: MovieStore, slicer=None,
                            sub_blocks: int = 1, sharding=None):
    """Iterate frame chunks with one-chunk-ahead disk read + device upload.

    Host->device transfer can be the wall of the streaming fit
    (SCALE.md); a worker thread reads chunk i+1 from disk
    and starts its ``jax.device_put`` while the (async-dispatched) chunk-i
    program runs, so transfer and compute overlap. Exactly one extra chunk
    is in flight — bounded device memory. ``slicer(t0, memmap) -> ndarray`` lets a
    pass upload only the frames it needs (the strided ring-Bf fit).
    ``sub_blocks`` splits each stored block into that many chunks: at
    512^2 a 1000-frame block costs ~1 GB as f32 on device and its block
    program another ~3 GB of transients — halving the chunk keeps the
    full-scale peak inside a 16 GB device.

    Yields ``(t0, device_array)`` with t0 the chunk's global start frame.
    Matches the reference's chunked-ingest discipline
    (``distribute_data.m:176``) with the chunk pipeline a worker thread.
    """
    import concurrent.futures as cf

    fpb = store.frames_per_block
    T = store.shape[0]
    jobs = []
    for i in range(store.n_blocks()):
        nb = min(fpb, T - i * fpb)
        step = -(-nb // max(sub_blocks, 1))
        for s0 in range(0, nb, step):
            jobs.append((i, s0, min(step, nb - s0)))

    def load(job):
        i, s0, n = job
        blk = store.read_block(i)[s0:s0 + n]
        chunk = slicer(i * fpb + s0, blk) if slicer is not None \
            else np.asarray(blk)
        # mesh callers pass the movie sharding: the chunk lands sharded
        # (frame, patch) across devices straight from the host buffer
        return jax.device_put(chunk, sharding)

    # BACKPRESSURE: device_put is async and the caller's loop can run far
    # ahead of the host link — without a bound, an
    # entire pass's chunks (26 GB at the full-scale config) queue in host
    # RAM as un-sent transfer buffers (measured ~100 GB RSS). Forcing a
    # one-element fetch of chunk j-LAG before yielding chunk j caps the
    # in-flight window at LAG chunks while still overlapping read,
    # upload, and compute.
    # large chunks (config-5 scale: ~260 MB f16 each, ~1 GB once cast to
    # f32 with program transients) keep a tighter window — 4-deep at that
    # size contributed to a full-scale out-of-memory on a 16 GB device
    itemsize = np.dtype(
        store.manifest.get("source_dtype", "float32")).itemsize
    chunk_bytes = (min(fpb, -(-fpb // max(sub_blocks, 1)))
                   * int(np.prod(store.shape[1:])) * itemsize)
    LAG = 2 if chunk_bytes > (128 << 20) else 4
    inflight = []

    def _force(x):
        np.asarray(jax.device_get(x[(0,) * (x.ndim - 1) + (slice(0, 1),)]))

    with cf.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(load, jobs[0])
        for j, job in enumerate(jobs):
            cur = fut.result()
            if j + 1 < len(jobs):
                fut = ex.submit(load, jobs[j + 1])
            inflight.append(cur)
            if len(inflight) > LAG:
                _force(inflight.pop(0))
            yield job[0] * fpb + job[1], cur


@jax.jit
def _block_temporal_U_raw(Yb, A_dk):
    """First-pass per-block accumulators: raw projection rows A^T Y_b and
    the block pixel-sum. The mean-subtracted projection is separable —
    U[:, t] = A^T (Y_t - Ymean) = (A^T Y_t) - A^T Ymean — so the global
    mean image comes out of the SAME pass and the former dedicated
    mean-accumulation pass (a full movie upload) disappears; the caller
    applies the rank-1 correction once Ymean is known.

    The contraction is written with native contracting dims (einsum, no
    ``.T``): an explicit transpose of the f32-cast block is a second
    0.5 GB transient per chunk at config-5 scale — a full-scale first
    pass ran a 16 GB device out of memory with the ``@ .T`` form."""
    Yb = Yb.astype(jnp.float32)
    Yf = Yb.reshape(Yb.shape[0], -1)                 # (t, d)
    return (jnp.einsum("dk,td->kt", A_dk, Yf),
            jnp.sum(Yb, axis=0))


@functools.partial(jax.jit, static_argnames=("radius", "H", "W"))
def _block_temporal_U_ring(Yb, A_dk, C_blk, b0, weights, radius, H, W):
    Yb = Yb.astype(jnp.float32)
    Ysig = _ring_subtract(Yb, A_dk, C_blk, b0, weights, radius, H, W)
    return jnp.einsum("dk,td->kt", A_dk,
                      Ysig.reshape(Yb.shape[0], -1))


@jax.jit
def _block_Bf(Yb_s, A_dk, Cc_s, Ymean, j0):
    """Ring-fit residual rows for an already host-strided frame subset
    (the fit needs only ~frame_cap_factor x R frames; the host reads just
    those rows from the block memmap instead of uploading whole blocks).
    ``Cc_s`` holds the centered traces on the same global stride grid;
    ``j0`` is this block's first column in it (a traced scalar, so every
    full-size block shares one compiled program)."""
    Yb_s = Yb_s.astype(jnp.float32)
    nb, H, W = Yb_s.shape
    Cc_blk = jax.lax.dynamic_slice(
        Cc_s, (0, j0), (Cc_s.shape[0], Yb_s.shape[0]))
    recon = jnp.einsum("dk,kt->td", A_dk, Cc_blk).reshape(nb, H, W)
    return Yb_s - Ymean[None] - recon


@functools.partial(jax.jit, static_argnames=("n", "stride"))
def _interp_grid_traces(Cg, t0, n, stride):
    """Linearly interpolate stride-grid traces (columns at frames
    0, stride, 2*stride, ...) onto the ``n`` frames starting at ``t0``.

    The bootstrap iteration's C_prev for the streamed ring subtraction:
    the reference freezes A_prev/C_prev at the background stage
    (``update_background_parallel.m:311-317``) and iteration 0 has no
    full-T C yet — the grid solve interpolated (calcium decays over
    ~tau >> 1 frame) is the best available C_prev."""
    j = t0 + jnp.arange(n)
    m = j // stride
    frac = (j % stride).astype(jnp.float32) / float(max(stride, 1))
    ng = Cg.shape[1]
    m0 = jnp.clip(m, 0, ng - 1)
    m1 = jnp.clip(m + 1, 0, ng - 1)
    return Cg[:, m0] * (1.0 - frac)[None] + Cg[:, m1] * frac[None]


@functools.partial(jax.jit, static_argnames=("radius", "H", "W"))
def _block_spatial_U(U, Yb, A_dk, C_blk, b0, weights, radius, H, W):
    Yb = Yb.astype(jnp.float32)
    Ysig = _ring_subtract(Yb, A_dk, C_blk, b0, weights, radius, H, W)
    return U + jnp.einsum("td,kt->dk", Ysig.reshape(Yb.shape[0], -1),
                          C_blk)


def fit_streaming(store: MovieStore, params: Optional[CNMFEParams] = None,
                  n_outer: int = 2, init_budget_frames: int = 4000,
                  verbose: bool = False,
                  snapshot_path: Optional[str] = None,
                  mesh=None) -> CNMFEState:
    """Run CNMF-E streaming frame blocks from a :class:`MovieStore`.

    ``snapshot_path``: optional .npz path — after every outer iteration
    the footprints (float16) + active mask are saved there, so a
    multi-hour full-scale run yields a scoreable artifact even if a later
    iteration is interrupted (the reference's intermediate_results.mat
    discipline, ``update_temporal_parallel.m:300-311``).

    ``mesh``: optional ``jax.sharding.Mesh`` with ("patch", "frame")
    axes — out-of-core x multi-chip composition (BASELINE config 5's
    "patch-sharded across N>=2 hosts"): every streamed chunk is
    ``device_put`` with the (frame, patch) movie sharding, the footprints
    live patch-sharded, and the per-block Gram accumulations run as SPMD
    programs whose contractions reduce over the sharded axes with XLA
    collectives (the psum form of the reference's cross-patch reduce,
    ``update_spatial_batch.m:20-35`` + ``Sources2D.m:268-325``). The ring
    stencil takes the XLA shift form (automatic halo exchange on 'patch');
    solver sweeps and OASIS run the partitionable XLA forms instead of
    the Pallas kernels."""
    params = params or CNMFEParams.preset_1p()
    T, H, W = store.shape
    radius = params.background.ring_radius
    spmd = mesh is not None
    # kernel choice for the solver sweeps and OASIS (XLA under a mesh)
    up = choose("hals", mesh=mesh) == PALLAS
    oasis_impl = choose("oasis", mesh=mesh)
    if spmd:
        from cnmf_e_tpu.parallel.mesh import movie_sharding
        mov_s = movie_sharding(mesh)
    else:
        mov_s = None
    # callable messages are only evaluated when verbose — several embed
    # device scalars (merge counts, n_active) whose formatting forces a
    # host sync in the async dispatch pipeline
    log = (lambda m: print(f"[stream] {m() if callable(m) else m}",
                           flush=True)) if verbose else (lambda m: None)

    # ---- init on a decimated proxy movie --------------------------------
    import os
    state = None
    resume_mid = False
    resume_post_spatial = False
    if snapshot_path is not None and os.path.exists(snapshot_path):
        # resume: a prior (possibly interrupted) run's footprints — the
        # reference's restore-from-LOGS flow
        # (initComponents_parallel.m:56-158), non-interactive
        z = np.load(snapshot_path)
        from cnmf_e_tpu.models.state import empty_state
        A_r = np.asarray(z["A"], np.float32)
        K_cap0 = A_r.shape[0]
        # p (AR order) comes from the saved g when present — resuming an
        # AR(2) configuration with a hard-coded p=1 truncated g and broke
        # the merge decay gate (r4 advisor finding)
        p_ar = (int(z["g"].shape[1]) if "g" in z.files
                else (2 if params.temporal.deconv.model in ("ar2", "exp2")
                      else 1))
        state = empty_state(K_cap0, H, W, 1, p=p_ar).replace(
            A=jnp.asarray(A_r), active=jnp.asarray(z["active"]))
        if "g" in z.files:
            state = state.replace(
                g=jnp.asarray(z["g"], jnp.float32),
                neuron_sn=jnp.asarray(z["neuron_sn"], jnp.float32))
        # mid-iteration resume: a traces snapshot carries the full-T
        # deconvolved C, so the first iteration continues at the RING
        # FIT instead of repaying the full-movie temporal pass; a
        # post-spatial snapshot additionally carries the new A + ring
        # weights and continues at the QC/merge stage
        stage_str = str(z.get("stage", ""))
        resume_post_spatial = (stage_str.endswith("_spatial")
                               and "C" in z.files
                               and z["C"].shape[1] == T)
        resume_mid = resume_post_spatial or (
            stage_str.endswith("_traces")
            and "C" in z.files and z["C"].shape[1] == T)
        if resume_post_spatial:
            from cnmf_e_tpu.ops.ring import RingWeights as _RW
            resume_weights = _RW(
                w=jnp.asarray(z["ring_w"], jnp.float32),
                w0=jnp.asarray(z["ring_w0"], jnp.float32))
            resume_b0 = jnp.asarray(z["b0"], jnp.float32)
            resume_Ymean = jnp.asarray(z["Ymean"], jnp.float32)
        if resume_mid:
            Cj = jnp.asarray(z["C"], jnp.float32)
            # S was not snapshotted; reconstruct it as the inverse AR
            # recurrence of the deconvolved C (exactly the deconvolver's
            # spikes up to clipping) — zeros here would trip the QC
            # no-spikes tag and deactivate every neuron
            g_r = state.g
            s_rec = Cj - g_r[:, :1] * jnp.pad(Cj[:, :-1],
                                              ((0, 0), (1, 0)))
            if p_ar == 2:
                s_rec = s_rec - g_r[:, 1:2] * jnp.pad(
                    Cj[:, :-2], ((0, 0), (2, 0)))
            state = state.replace(
                C=Cj,
                C_raw=jnp.asarray(z["C_raw"], jnp.float32),
                S=jnp.maximum(s_rec, 0.0))
        log(lambda state=state: f"resumed {int(state.n_active())} neurons "
            f"from {snapshot_path} (stage {z.get('stage', '?')}"
            f"{', mid-iteration' if resume_mid else ''})")
    if state is None:
        tsub = max(-(-T // init_budget_frames), 1)
        import dataclasses
        ssub = max(int(params.init.ssub), 1)
        # build the decimated proxy block-by-block (bounded host RAM);
        # the spatial ssub pool also runs HOST-side — it cuts the host
        # upload by ssub^2 and avoids a movie-sized device op (a 6 GB
        # eager box_downsample at 512^2x6000)
        Hs, Ws = H // ssub, W // ssub
        parts = []
        offset = 0
        for Yb in store.iter_blocks_raw():
            first = (-offset) % tsub
            sl = np.asarray(Yb)[first::tsub].astype(np.float32)
            if ssub > 1:
                sl = sl[:, :Hs * ssub, :Ws * ssub].reshape(
                    sl.shape[0], Hs, ssub, Ws, ssub).mean(axis=(2, 4))
            parts.append(sl)
            offset += Yb.shape[0]
        Y_proxy = np.concatenate(parts, axis=0)
        del parts
        ip_init = dataclasses.replace(
            params.init, tsub=1, ssub=1,
            gSig=max(params.init.gSig / ssub, 0.0),
            gSiz=max(int(params.init.gSiz // ssub), 3))
        state, info = initialize_greedy(
            jnp.asarray(Y_proxy), params.replace(init=ip_init),
            verbose=verbose)
        del Y_proxy
        # the proxy-sized residual movie in the init report would
        # otherwise stay live for the whole fit (~1.3 GB at full scale)
        info.pop("residual_Y", None)
        if ssub > 1:
            # upsample footprints to full resolution (greedyROI_endoscope
            # ssub semantics, initialize.py's in-memory path); traces are
            # rebuilt from scratch at full T below, so only A/active/g
            # carry
            from cnmf_e_tpu.models.state import empty_state
            K_cap0 = state.K_max
            A_full = jax.image.resize(state.A, (K_cap0, H, W),
                                      method="linear")
            st_full = empty_state(K_cap0, H, W, 1, p=state.g.shape[1])
            state = st_full.replace(
                A=A_full * state.active[:, None, None],
                active=state.active,
                g=state.g, neuron_sn=state.neuron_sn)
        log(lambda state=state: f"init (tsub={tsub}, ssub={ssub}): "
            f"{int(state.n_active())} neurons")
        if snapshot_path is not None:
            np.savez(snapshot_path, stage="init",
                     A=np.asarray(state.A, np.float16),
                     active=np.asarray(state.active),
                     g=np.asarray(state.g, np.float32),
                     neuron_sn=np.asarray(state.neuron_sn, np.float32))
            log(f"init snapshot -> {snapshot_path}")

    # traces expand to full T at the first temporal solve below; until
    # then carry T=1 placeholders — full-T zero buffers here would sit
    # dead through the peak-memory temporal stage (2.8 GB at config 5,
    # part of an out-of-memory on a 16 GB device). A mid-iteration resume already carries
    # full-T traces and skips straight to the ring fit.
    K_cap = state.K_max
    if not resume_mid:
        state = state.replace(
            C=jnp.zeros((K_cap, 1), jnp.float32),
            C_raw=jnp.zeros((K_cap, 1), jnp.float32),
            S=jnp.zeros((K_cap, 1), jnp.float32))

    fpb = store.frames_per_block

    # ---- pixel noise (cached; reads only the first noise_frame_cap) -----
    sn_pix = store.load_noise()
    if sn_pix is None:
        cap = min(params.noise_frame_cap, T)
        from cnmf_e_tpu.ops.noise import noise_psd_frames
        Yn = store.read_frames(0, cap)
        # row-band chunks: a (3000, 512, 512) f32 upload plus the PSD
        # program's transposed copy is ~7 GB next to the full-T state
        rows = max(1, min(H, int((512 << 20) // max(cap * W * 4, 1))))
        sn_rows = [np.asarray(noise_psd_frames(
            jnp.asarray(Yn[:, h0:h0 + rows])))
            for h0 in range(0, H, rows)]
        sn_pix = np.concatenate(sn_rows, axis=0)
        del Yn, sn_rows
        store.save_noise(sn_pix)
    sn_pix = jnp.asarray(sn_pix)

    # fit_streaming maintains A and C pre-masked (init masks A, every
    # spatial/temporal update re-applies `active`, merges zero dropped
    # slots), so state.A / state.C are used directly below — masked_A()
    # would allocate a second 2.4 GB footprint array at full scale
    # target ~256 MB of f32 frames per chunk: at config-5 scale the
    # former 512 MB chunks (x cast + contraction transients x in-flight
    # window) ran a 16 GB device out of memory at full scale
    sub_blocks = max(1, -(-fpb * H * W * 4 // (256 << 20)))

    weights = None
    Ymean = None

    for it in range(n_outer):
        skip_temporal = resume_mid and it == 0
        skip_ring_spatial = resume_post_spatial and it == 0
        if not skip_ring_spatial:
            # ONE resident footprint copy for the whole iteration: the
            # block programs consume the (d, K) layout (native
            # contracting dims), so A is materialized as A_dk once and
            # the (K, H, W) state slot holds a placeholder until the
            # spatial update writes the new A (2.4 GB each at config 5 —
            # carrying both plus per-program relayout transients ran a
            # 16 GB device out of memory in the spatial pass)
            A_dk = state.A.reshape(K_cap, -1).T
            if spmd:
                from jax.sharding import NamedSharding, \
                    PartitionSpec as P
                A_dk = jax.device_put(
                    A_dk, NamedSharding(mesh, P("patch", None)))
            state = state.replace(
                A=jnp.zeros((K_cap, 1, 1), jnp.float32))
        else:
            # post-spatial snapshot: A (new), C, ring weights, b0 and
            # Ymean all restored — continue at the QC/merge stage
            # (state.A already holds the snapshot's A)
            state = state.replace(b0=resume_b0, W=resume_weights)
            weights = resume_weights
            Ymean = resume_Ymean
            log(f"iter {it}: resumed at QC/merge")
        if skip_temporal and not skip_ring_spatial:
            # resumed from a mid-iteration traces snapshot: C is loaded,
            # so continue at the ring fit. Ymean (lost with the dead
            # process) is re-estimated host-side from the ring-fit
            # stride grid (~1/stride of the frames; SE ~ std/sqrt(n) per
            # pixel — negligible against the b0 scale)
            R0 = ring_offsets(radius).shape[0]
            nmax0 = params.background.frame_cap_factor * R0
            stride0 = max(int(np.ceil(T / nmax0)), 1)
            acc_h = np.zeros((H, W), np.float64)
            n_h = 0
            for bi in range(store.n_blocks()):
                blk = store.read_block(bi)
                off = (-(bi * fpb)) % stride0
                sub = np.asarray(blk[off::stride0], np.float32)
                acc_h += sub.sum(axis=0)
                n_h += sub.shape[0]
            Ymean = jnp.asarray((acc_h / max(n_h, 1)).astype(np.float32))
            del acc_h
            log(f"iter {it}: resumed at ring fit "
                f"(strided Ymean over {n_h} frames)")
        C_boot = None
        stride_boot = 1
        if (not skip_temporal and weights is None
                and params.background.ring_bootstrap):
            # ---- strided ring BOOTSTRAP (round 5) -----------------------
            # Iteration 0 used to solve its full-T temporal pass against
            # the raw movie (mean-subtracted only): with a fluctuating 1p
            # background the traces carry background leakage (measured
            # trace-corr 0.30 vs planted truth at config 5) that only a
            # SECOND outer iteration could wash out. The ring model only
            # needs ~frame_cap_factor*R frames to fit, so fit it FIRST
            # from one ~1/stride strided upload — grid-frame traces are
            # solved from the same cached frames — and iteration 0's full
            # temporal pass already subtracts the ring background (the
            # reference's own stage order: background before temporal,
            # demo_large_data_1p.m:199-209).
            R0 = ring_offsets(radius).shape[0]
            nmax0 = params.background.frame_cap_factor * R0
            stride_boot = max(int(np.ceil(T / nmax0)), 1)

            def grid_slicer(t0, blk):
                off = (-t0) % stride_boot
                return np.ascontiguousarray(blk[off::stride_boot])

            g_parts = [Yb_s for _, Yb_s in _prefetch_device_blocks(
                store, slicer=grid_slicer, sharding=mov_s)]
            Yg = jnp.concatenate(g_parts, axis=0)    # (n_grid, H, W) f16
            del g_parts
            n_grid = int(Yg.shape[0])
            gb = max(fpb // max(stride_boot, 1), 1)
            Ug_parts = []
            acc_g = jnp.zeros((H, W), jnp.float32)
            for g0 in range(0, n_grid, gb):
                Ub, s = _block_temporal_U_raw(Yg[g0:g0 + gb], A_dk)
                Ug_parts.append(Ub)
                acc_g = acc_g + s
            Ymean = acc_g / n_grid
            Vg = jnp.einsum("dk,dl->kl", A_dk, A_dk)
            aag = jnp.diag(Vg)
            Ug = (jnp.concatenate(Ug_parts, axis=1)
                  - jnp.einsum("dk,d->k", A_dk,
                               Ymean.reshape(-1))[:, None])
            del Ug_parts
            from cnmf_e_tpu.ops.hals import hals_temporal_sweeps as _hts
            C0g = jnp.maximum(Ug / jnp.maximum(aag, 1e-12)[:, None], 0.0)
            Cg = _hts(Ug, Vg, C0g, n_iter=params.temporal.n_iter,
                      active=state.active,
                      use_pallas=up)
            del Ug, C0g
            Cg_mean = jnp.mean(Cg, axis=1)
            state = state.replace(
                b0=(Ymean - jnp.einsum("dk,k->d", A_dk,
                                       Cg_mean).reshape(H, W)))
            Ccg = Cg - Cg_mean[:, None]
            Bf_rows = [_block_Bf(Yg[g0:g0 + gb], A_dk, Ccg, Ymean, g0)
                       for g0 in range(0, n_grid, gb)]
            del Yg
            Bf_fit = jnp.concatenate(Bf_rows, axis=0)
            weights = fit_ring_weights(
                Bf_fit, H, W, radius,
                ridge_eps=params.background.ridge_eps)
            state = state.replace(W=weights)
            C_boot = Cg
            del Bf_fit, Bf_rows, Ccg, Cg
            log(f"iter {it}: ring bootstrap fit ({n_grid} strided frames)")
        if not skip_temporal:
            # ---- temporal pass: Gram-accumulated HALS over blocks -------
            # U = A^T Ysig accumulates per block (K x T fits on device
            # even at 100k frames); V = A^T A is frame-independent — so
            # the full cross-term coordinate descent
            # (HALS_temporal.m:58-107) runs EXACTLY as in-memory. A
            # diagonal projection (A Ysig)/||a||^2 would leave
            # overlapping neurons' traces correlated and biased.
            V = jnp.einsum("dk,dl->kl", A_dk, A_dk)          # (K, K)
            aa = jnp.diag(V)   # NOT sum(A*A): that materializes a (K, d)
            #                    temp — 2.4 GB at full scale
            U_parts = []
            if weights is None:
                # first pass doubles as the mean-image accumulation (the
                # mean-subtraction of U is a separable rank-1 correction)
                acc = jnp.zeros((H, W), jnp.float32)
                for t0, Yb in _prefetch_device_blocks(store,
                                                      sub_blocks=sub_blocks,
                                                      sharding=mov_s):
                    Ub, s = _block_temporal_U_raw(Yb, A_dk)
                    U_parts.append(Ub)
                    acc = acc + s
                Ymean = acc / T
                U = (jnp.concatenate(U_parts, axis=1)
                     - jnp.einsum("dk,d->k", A_dk,
                                  Ymean.reshape(-1))[:, None])  # (K, T)
            else:
                for t0, Yb in _prefetch_device_blocks(store,
                                                      sub_blocks=sub_blocks,
                                                      sharding=mov_s):
                    if C_boot is not None:
                        C_blk = _interp_grid_traces(
                            C_boot, t0, Yb.shape[0], stride_boot)
                    else:
                        C_blk = state.C[:, t0:t0 + Yb.shape[0]]
                    U_parts.append(_block_temporal_U_ring(
                        Yb, A_dk, C_blk, state.b0, weights, radius, H, W))
                U = jnp.concatenate(U_parts, axis=1)         # (K, T)
            del U_parts
            from cnmf_e_tpu.ops.hals import hals_temporal_sweeps
            # frame-chunked sweeps: columns are independent given V, so
            # solving T-chunks is EXACT and bounds the live solver buffers
            # (U/C0/C_raw + the fori carry double-buffer are each (K, T) —
            # ~5 GB of full-T f32 at config 5)
            Tc = 25_000
            if T > Tc:
                cparts = []
                for t0b in range(0, T, Tc):
                    sl = slice(t0b, min(t0b + Tc, T))
                    Ub = U[:, sl]
                    C0b = jnp.maximum(
                        Ub / jnp.maximum(aa, 1e-12)[:, None], 0.0)
                    cparts.append(hals_temporal_sweeps(
                        Ub, V, C0b, n_iter=params.temporal.n_iter,
                        active=state.active, use_pallas=up))
                del U
                C_raw = jnp.concatenate(cparts, axis=1)
                del cparts
            else:
                C0 = jnp.maximum(U / jnp.maximum(aa, 1e-12)[:, None], 0.0)
                C_raw = hals_temporal_sweeps(U, V, C0,
                                             n_iter=params.temporal.n_iter,
                                             active=state.active,
                                             use_pallas=up)
                del U, C0
            # neuron-batched baseline + deconvolution: the windowed OASIS at
            # the full population carries several (K, T) live buffers —
            # ~6 GB at (2304, 100k). Rows are independent, so batching is
            # exact; a small fetch drains the async queue so each batch's
            # buffers free before the next dispatches.
            from cnmf_e_tpu.ops.stats import submedian_mean
            act = state.active[:, None]
            if T > Tc:
                # near-equal batches (one program shape; 2304 -> 4 x 576)
                Kb0 = max(64, int((256 << 20) // max(T * 4, 1)) // 64 * 64)
                Kb = -(-K_cap // max(-(-K_cap // Kb0), 1))
            else:
                Kb = K_cap
            C_list, Cr_list, S_list = [], [], []
            for k0 in range(0, K_cap, Kb):
                Cb = C_raw[k0:k0 + Kb]
                Cb = Cb - submedian_mean(Cb, axis=-1)[:, None]
                res = deconvolve(Cb, params.temporal.deconv,
                                 impl=oasis_impl)
                ab = act[k0:k0 + Kb]
                C_list.append(jnp.where(ab, res.c, 0.0))
                Cr_list.append(jnp.where(ab, Cb - res.b[:, None], 0.0))
                S_list.append(jnp.where(ab, res.s, 0.0))
                if K_cap > Kb:
                    float(jnp.sum(C_list[-1][:1, :4]))
            del C_raw
            state = state.replace(
                C=jnp.concatenate(C_list, axis=0),
                C_raw=jnp.concatenate(Cr_list, axis=0),
                S=jnp.concatenate(S_list, axis=0))
            del C_list, Cr_list, S_list
            log(lambda state=state:
                f"iter {it}: traces ({int(state.n_active())} neurons)")
            if snapshot_path is not None:
                # mid-iteration artifact: the temporal pass is the longest
                # transfer-bound stage, and its (deconvolved) traces are the
                # scoreable product — snapshot them before the ring/spatial
                # stages so a wall-clock-bounded run still yields traces.
                # A is unchanged by the temporal stage: reuse the previous
                # snapshot's host copy instead of a multi-GB device fetch
                import os as _os
                A_prev = (np.load(snapshot_path)["A"]
                          if _os.path.exists(snapshot_path)
                          else np.asarray(state.A, np.float16))
                np.savez(snapshot_path, stage=f"iter{it}_traces",
                         A=A_prev,
                         active=np.asarray(state.active),
                         g=np.asarray(state.g, np.float32),
                         neuron_sn=np.asarray(state.neuron_sn, np.float32),
                         C=np.asarray(state.C, np.float16),
                         C_raw=np.asarray(state.C_raw, np.float16))
                log(f"iter {it}: traces snapshot -> {snapshot_path}")

        if not skip_ring_spatial:
            # ---- ring background fit (streamed Bf blocks) -------------------
            Cmean = jnp.mean(state.C, axis=-1)
            b0 = Ymean - jnp.einsum("dk,k->d", A_dk,
                                    Cmean).reshape(H, W)
            state = state.replace(b0=b0)
            R = ring_offsets(radius).shape[0]
            nmax = params.background.frame_cap_factor * R
            stride = max(int(np.ceil(T / nmax)), 1)
            # subsample frames across blocks for the weight fit: the host
            # reads ONLY the stride-grid rows of each block (memmap row
            # gather), so this pass uploads ~1/stride of the movie
            Cc = state.C - Cmean[:, None]
            Cc_s = Cc[:, ::stride]

            def bf_slicer(t0, blk):
                off = (-t0) % stride
                return np.ascontiguousarray(blk[off::stride])

            Bf_rows = []
            for t0, Yb_s in _prefetch_device_blocks(store, slicer=bf_slicer,
                                                    sharding=mov_s):
                j0 = -(-t0 // stride)            # first global grid col here
                Bf_rows.append(_block_Bf(Yb_s, A_dk, Cc_s, Ymean, j0))
            Bf_fit = jnp.concatenate(Bf_rows, axis=0)
            weights = fit_ring_weights(Bf_fit, H, W, radius,
                                       ridge_eps=params.background.ridge_eps)
            state = state.replace(W=weights)
            del Bf_fit, Bf_rows, Cc, Cc_s       # Cc is ~1 GB at config 5
            log(f"iter {it}: ring background fit")

            # ---- spatial: streamed Gram accumulation ------------------------
            C = state.C
            U = jnp.zeros((H * W, K_cap), jnp.float32)
            # the accumulator chain re-allocates the FULL (d, K) U every
            # step (no buffer donation): with async dispatch, every
            # enqueued step holds its own 2.4 GB output at config-5
            # scale, and an unbounded queue ran a 16 GB device out of
            # memory. A 4-element fetch of the
            # freshly produced U drains the chain to at most two live
            # generations; uploads still overlap (the prefetch thread is
            # independent of the U data dependency).
            drain_U = H * W * K_cap * 4 > (1 << 30)
            for t0, Yb in _prefetch_device_blocks(store,
                                                  sub_blocks=sub_blocks,
                                                  sharding=mov_s):
                C_blk = jax.lax.dynamic_slice_in_dim(
                    C, t0, Yb.shape[0], axis=1)
                U = _block_spatial_U(U, Yb, A_dk, C_blk, state.b0, weights,
                                     radius, H, W)
                if drain_U:
                    float(jnp.sum(U[:1, :4]))
            # HALS sweeps on the accumulated Grams — the same blocked
            # Gauss-Seidel program every in-memory spatial update runs
            # (ops/hals.py). A bespoke per-neuron fori_loop here compiled a
            # second, much larger XLA program that (run at the tail of the
            # full CPU test suite) reproducibly segfaulted the XLA:CPU
            # compiler; reusing the shared kernel removed both the crash and
            # the duplicate compile.
            from cnmf_e_tpu.ops.hals import hals_spatial_sweeps
            V = jnp.einsum("kt,lt->kl", C, C)
            Ad = A_dk
            # pixel-chunked sweeps: rows (pixels) are independent given V —
            # chunking is EXACT and bounds the solver's live (d, K) buffers
            # (~3 x 2.4 GB at config 5 next to the accumulated U and the
            # full-T traces; same HBM discipline as the temporal solve)
            dtot = H * W
            Dc = 1 << 16
            if dtot > 2 * Dc:
                a_parts = []
                for d0 in range(0, dtot, Dc):
                    sl = slice(d0, min(d0 + Dc, dtot))
                    a_parts.append(hals_spatial_sweeps(
                        U[sl], V, Ad[sl], n_iter=params.spatial.n_iter,
                        use_pallas=up))
                    float(jnp.sum(a_parts[-1][:1, :4]))
                del U
                Ad = jnp.concatenate(a_parts, axis=0)
                del a_parts
            else:
                Ad = hals_spatial_sweeps(U, V, Ad,
                                         n_iter=params.spatial.n_iter,
                                         use_pallas=up)
            state = state.replace(
                A=Ad.T.reshape(K_cap, H, W) * state.active[:, None, None])
            del Ad, A_dk      # release the (d, K) copy before the QC/merge
            #                   stage peaks (2.4 GB at config 5)
            log(f"iter {it}: spatial")
            if snapshot_path is not None and T > 25_000:
                # post-spatial snapshot: every multi-hour stage has its
                # own resume point (a crash in the QC/merge stage below
                # would otherwise repay the ~2 full-movie passes)
                np.savez(snapshot_path, stage=f"iter{it}_spatial",
                         A=np.asarray(state.A, np.float16),
                         active=np.asarray(state.active),
                         g=np.asarray(state.g, np.float32),
                         neuron_sn=np.asarray(state.neuron_sn,
                                              np.float32),
                         C=np.asarray(state.C, np.float16),
                         C_raw=np.asarray(state.C_raw, np.float16),
                         ring_w=np.asarray(weights.w, np.float16),
                         ring_w0=np.asarray(weights.w0, np.float32),
                         b0=np.asarray(state.b0, np.float32),
                         Ymean=np.asarray(Ymean, np.float32))
                log(f"iter {it}: spatial snapshot -> {snapshot_path}")

        # neuron-batched QC at scale: tag_neurons' Welch PSD frames the
        # full (K, T) C_raw into ~5 GB of gathered windows — rows are
        # independent, so batch the tagging and apply the keep once
        if T > 25_000:
            from cnmf_e_tpu.models.qc import _apply_keep
            KbQ = -(-K_cap // max(-(-K_cap // 640), 1))
            tag_parts = []
            for k0 in range(0, K_cap, KbQ):
                sl = slice(k0, k0 + KbQ)
                sub = state.replace(
                    A=state.A[sl], C=state.C[sl],
                    C_raw=state.C_raw[sl], S=state.S[sl],
                    active=state.active[sl], g=state.g[sl],
                    neuron_sn=state.neuron_sn[sl], tags=state.tags[sl])
                tag_parts.append(tag_neurons(sub, params).tags)
                float(jnp.sum(tag_parts[-1][:1]))
            tags = jnp.concatenate(tag_parts)
            keep = state.active & ~((tags != 0) & state.active)
            state = _apply_keep(state.replace(tags=tags), keep)
            del tag_parts
        else:
            state = remove_false_positives(state, params)
        # deconv=False: the post-merge re-deconvolution is a FULL
        # (K_max, T) OASIS pass — ~6 GB of live trace buffers at config
        # 5 (the r5 solve-stage OOM class). Non-final iterations are
        # re-deconvolved by the next temporal pass anyway (the same
        # deferral the in-memory pipeline uses); on the final iteration
        # the few merged clusters keep their rank-1-refit traces
        state, nm = merge_neurons(state, params, "dist_corr",
                                  deconv=False)
        state, nm2 = merge_neurons(state, params, "dist_only",
                                   deconv=False)
        log(lambda nm=nm, nm2=nm2, state=state:
            f"iter {it}: QC + merges ({int(nm)}+{int(nm2)}), "
            f"{int(state.n_active())} neurons")
        if snapshot_path is not None:
            # traces ride along (float16) so an interrupted multi-hour
            # run still yields trace-scoreable artifacts, and g/sn so an
            # AR(2) resume keeps its model order (r4 advisor finding)
            np.savez(snapshot_path, stage=f"iter{it}",
                     A=np.asarray(state.A, np.float16),
                     active=np.asarray(state.active),
                     g=np.asarray(state.g, np.float32),
                     neuron_sn=np.asarray(state.neuron_sn, np.float32),
                     C=np.asarray(state.C, np.float16),
                     C_raw=np.asarray(state.C_raw, np.float16))
            log(f"iter {it}: snapshot -> {snapshot_path}")

    # final tags, neuron-batched at scale (same Welch-PSD framing peak
    # as the per-iteration QC above)
    if T > 25_000:
        KbQ = -(-K_cap // max(-(-K_cap // 640), 1))
        tag_parts = []
        for k0 in range(0, K_cap, KbQ):
            sl = slice(k0, k0 + KbQ)
            sub = state.replace(
                A=state.A[sl], C=state.C[sl], C_raw=state.C_raw[sl],
                S=state.S[sl], active=state.active[sl], g=state.g[sl],
                neuron_sn=state.neuron_sn[sl], tags=state.tags[sl])
            tag_parts.append(tag_neurons(sub, params).tags)
            float(jnp.sum(tag_parts[-1][:1]))
        state = state.replace(tags=jnp.concatenate(tag_parts))
    else:
        state = tag_neurons(state, params)
    return compact(state)
