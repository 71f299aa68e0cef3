"""Greedy Corr+PNR initialization, batched for an accelerator.

Reference: ``endoscope/greedyROI_endoscope.m`` peels one neuron at a time —
pick the best Cn*PNR local maximum, extract (a_i, c_i) from a box around it
(``extract_ac.m``), subtract, refresh local statistics, repeat. That serial
data-dependent loop maps poorly to an accelerator.

Batched re-design (documented deviation, validated by F1/IoU parity rather than
bitwise identity — see ``tests/test_oracle_greedy_init.py`` for the literal
serial-peel oracle it is held against): peel in ROUNDS. Each round takes
the top-N local maxima of the search image (exact max-filter non-max
suppression at distance gSiz — no sequential NMS loop), extracts all N
neurons with a vmapped ``extract_ac``, deconvolves them as one batch,
subtracts all peeled components at once, and refreshes the band-passed
movie INCREMENTALLY with the filtered footprints (a rank-N update — the
reference refreshes HY locally per peel, ``greedyROI_endoscope.m:375-407``;
a full movie refilter + fresh per-pixel median per round costs far more).

The whole round — seed search, extraction, deconvolution, masked acceptance
into fixed neuron slots, peel, incremental refresh — is ONE jitted program
with fully static shapes (acceptance uses a cumsum-ranked masked scatter
rather than host-side boolean slicing), so the host loop costs one dispatch
plus one small fetch per round and the program compiles exactly once
regardless of how many neurons each round yields. (Fusing ALL rounds into
one while_loop program was tried and reverted — XLA:CPU segfaults past a
program-size threshold; see CLAUDE.md.) The band-pass + median-center +
noise prolog is one jitted program as well, so it costs one dispatch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.ops.corr import correlation_image
from cnmf_e_tpu.ops.filters import filter_movie, gaussian_psf
from cnmf_e_tpu.ops.morphology import (circular_constraint,
                                       connectivity_constraint)
from cnmf_e_tpu.ops.noise import (estimate_baseline_noise, noise_psd,
                                  noise_psd_frames)
from cnmf_e_tpu.ops.oasis import deconvolve
from cnmf_e_tpu.models.state import CNMFEState, empty_state
from cnmf_e_tpu.ops.stats import fast_median


class ExtractResult(NamedTuple):
    a: jnp.ndarray        # (N, B, B) footprint inside the box
    c_raw: jnp.ndarray    # (N, T) baseline-subtracted raw trace
    ok: jnp.ndarray       # (N,) success flag
    sn: jnp.ndarray       # (N,) trace noise


def _box_slice(Mp: jnp.ndarray, r: jnp.ndarray, c: jnp.ndarray, B: int
               ) -> jnp.ndarray:
    """Extract a (T, B, B) box centered at (r, c) from a movie already
    zero-padded by gSiz on each side (so the padded start index is (r, c))."""
    return jax.lax.dynamic_slice(Mp, (0, r, c), (Mp.shape[0], B, B))


@functools.partial(jax.jit, static_argnames=("gSiz", "min_pixel",
                                             "corr_thr", "bg_corr_thr",
                                             "trace_mode"))
def extract_ac_batch(HY: jnp.ndarray, Y: jnp.ndarray, rows: jnp.ndarray,
                     cols: jnp.ndarray, gSiz: int, min_pixel: int = 5,
                     corr_thr: float = 0.9, bg_corr_thr: float = 0.3,
                     trace_mode: str = "corr_mean") -> ExtractResult:
    """Vmapped ``extract_ac`` (reference: ``extract_ac.m:19-95``).

    HY/Y: (T, H, W) filtered / raw movies; rows/cols: (N,) seed centers.
    ``trace_mode``: "corr_mean" averages the >corr_thr pixels (1p,
    ``extract_ac.m:19-27``); "center" uses the seed pixel's trace itself
    (2p variant, ``extract_ac_2p.m:26``).
    Out-of-FOV box pixels are zero traces: their correlation is NaN so they
    drop out of both the in-neuron and background pixel sets, matching the
    reference's shrunken boundary boxes.
    """
    B = 2 * gSiz + 1
    T = Y.shape[0]
    HYp = jnp.pad(HY, ((0, 0), (gSiz, gSiz), (gSiz, gSiz)))
    Yp = jnp.pad(Y, ((0, 0), (gSiz, gSiz), (gSiz, gSiz)))

    def one(r, c):
        hy = _box_slice(HYp, r, c, B).reshape(T, B * B)        # (T, P)
        yy = _box_slice(Yp, r, c, B).reshape(T, B * B)
        y0 = hy[:, gSiz * B + gSiz]                             # center trace

        hy_c = hy - jnp.mean(hy, axis=0, keepdims=True)
        y0_c = y0 - jnp.mean(y0)
        denom = (jnp.linalg.norm(hy_c, axis=0)
                 * jnp.maximum(jnp.linalg.norm(y0_c), 1e-12))
        corr = (hy_c.T @ y0_c) / jnp.where(denom > 0, denom, jnp.nan)  # (P,)

        in_mask = corr > corr_thr
        n_in = jnp.sum(in_mask)
        if trace_mode == "center":
            ci = y0
        else:
            ci = jnp.sum(jnp.where(in_mask[None], hy, 0.0), axis=1) / \
                jnp.maximum(n_in, 1)

        bg_mask = corr < bg_corr_thr
        # masked bisection median (extract_ac.m:37): jnp.nanmedian sorts
        # every (P,) row
        from cnmf_e_tpu.ops.stats import fast_median_masked
        y_bg = fast_median_masked(yy, bg_mask[None], axis=1)

        # per-pixel LS on [1, y_bg, ci] (extract_ac.m:54-58)
        X = jnp.stack([jnp.ones_like(ci), y_bg, ci], axis=1)    # (T, 3)
        G = X.T @ X + 1e-6 * jnp.eye(3, dtype=X.dtype)
        coef = jnp.linalg.solve(G, X.T @ yy)                    # (3, P)
        ai = jnp.maximum(coef[2], 0.0).reshape(B, B)

        ai = circular_constraint(ai)
        ai = connectivity_constraint(ai, se_size=3)

        npix = jnp.sum(ai > 0)
        # baseline + noise cleanup of ci (extract_ac.m:87-95)
        b_hist, sn_hist = estimate_baseline_noise(ci)
        sn_psd = noise_psd(ci)
        med = jnp.median(ci)
        b_sub = jnp.sum(jnp.where(ci < med, ci, 0.0)) / \
            jnp.maximum(jnp.sum(ci < med), 1)
        use_hist = sn_hist <= sn_psd
        ci_out = ci - jnp.where(use_hist, b_hist, b_sub)
        sn = jnp.minimum(sn_hist, sn_psd)

        ok = (npix >= min_pixel) & (jnp.linalg.norm(ci) > 0) & \
            jnp.all(jnp.isfinite(ai)) & jnp.all(jnp.isfinite(ci_out))
        return ai, ci_out, ok, sn

    a, c_raw, ok, sn = jax.vmap(one)(rows, cols)
    return ExtractResult(a=a, c_raw=c_raw, ok=ok, sn=sn)


def _local_maxima_topk(v: jnp.ndarray, n: int, vmin: float,
                       nms_dist: int) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """Top-n local maxima of v (H, W), pairwise > nms_dist apart.

    The reference marks searched pixels and re-runs an order-filter per
    peel (greedyROI_endoscope.m:211-268). Here ONE separable max-filter of
    half-width ``nms_dist`` implements exact non-max suppression without
    any sequential loop: a pixel survives iff it is THE maximum within
    +-nms_dist, so two survivors closer than nms_dist are impossible
    except for exact float ties (the greedy-NMS ``fori_loop`` this
    replaces ran n sequential scalar steps).
    Ties are broken by dropping the lower-ranked member of any close pair
    (a vectorized O(n^2) pass over the n selected seeds).
    """
    H, W = v.shape
    w = 2 * nms_dist + 1
    vmax = jax.lax.reduce_window(
        v, -jnp.inf, jax.lax.max, (w, 1), (1, 1),
        [(nms_dist, nms_dist), (0, 0)])
    vmax = jax.lax.reduce_window(
        vmax, -jnp.inf, jax.lax.max, (1, w), (1, 1),
        [(0, 0), (nms_dist, nms_dist)])
    is_max = (v >= vmax) & (v > vmin)
    score = jnp.where(is_max, v, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(score, n)
    rows, cols = idx // W, idx % W
    valid = vals > -jnp.inf

    # tie cleanup: survivors are window-maxima, so any two within nms_dist
    # must be exact ties — keep the higher-ranked one
    dr = rows[:, None] - rows[None, :]
    dc = cols[:, None] - cols[None, :]
    close = (dr * dr + dc * dc) < nms_dist * nms_dist
    lower = jnp.arange(n)[:, None] > jnp.arange(n)[None, :]
    conflict = jnp.any(close & lower & valid[None, :], axis=1)
    return rows, cols, valid & ~conflict


def _weak_signal_test(HY: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray
                      ) -> jnp.ndarray:
    """Reference check (greedyROI_endoscope.m:286-293): seed trace must have
    max(diff) >= 3 * std(diff)."""
    def one(r, c):
        y0 = HY[:, r, c]
        d = jnp.diff(y0)
        return jnp.max(d) >= 3.0 * jnp.std(d)
    return jax.vmap(one)(rows, cols)


def initialize_greedy(Y: jnp.ndarray, params: CNMFEParams,
                      K_max: Optional[int] = None,
                      state: Optional[CNMFEState] = None,
                      min_corr: Optional[float] = None,
                      min_pnr: Optional[float] = None,
                      verbose: bool = False) -> Tuple[CNMFEState, dict]:
    """Run the full batched greedy init. Y: (T, H, W) movie (raw, or the
    residual Y - AC - B for the residual pick pass,
    ``initComponents_residual_parallel.m``). When ``state`` is given, new
    neurons append into its free slots.

    Returns (state, info) where info holds the final Cn/PNR maps and seed
    log. The host drives rounds; all heavy work is jitted.
    """
    ip = params.init
    T, H, W = Y.shape
    K_max = K_max or ip.max_neurons

    # ssub/tsub: initialize on the downsampled movie, then upsample the
    # results (reference: greedyROI_endoscope.m:464-487)
    if (ip.ssub > 1 or ip.tsub > 1) and state is None:
        from cnmf_e_tpu.ops.filters import box_downsample
        import dataclasses
        Y_ds = box_downsample(jnp.asarray(Y, jnp.float32),
                              ssub=ip.ssub, tsub=ip.tsub)
        ip_ds = dataclasses.replace(
            ip, ssub=1, tsub=1, gSig=max(ip.gSig / ip.ssub, 0.0),
            gSiz=max(int(ip.gSiz // ip.ssub), 3))
        p_ds = params.replace(init=ip_ds)
        st_ds, info = initialize_greedy(Y_ds, p_ds, K_max=K_max,
                                        min_corr=min_corr, min_pnr=min_pnr,
                                        verbose=verbose)
        K_cap = st_ds.K_max
        A_full = jax.image.resize(st_ds.A, (K_cap, H, W), method="linear")
        C_full = jax.image.resize(st_ds.C_raw, (K_cap, T), method="linear")
        st = empty_state(K_cap, H, W, T, p=st_ds.g.shape[1])
        st = st.replace(A=A_full, C=jnp.maximum(C_full, 0.0),
                        C_raw=C_full, active=st_ds.active, g=st_ds.g,
                        neuron_sn=st_ds.neuron_sn)
        # refine traces at full rate with one deconvolution pass
        if ip.deconv_at_init and params.temporal.deconv.enabled:
            dres = deconvolve(st.C_raw, params.temporal.deconv)
            act = st.active[:, None]
            st = st.replace(C=jnp.where(act, dres.c, 0.0),
                            S=jnp.where(act, dres.s, 0.0))
        return st, info

    gSiz = int(ip.gSiz)
    psf = gaussian_psf(ip.gSig, ip.center_psf)
    if min_corr is None:
        min_corr = ip.min_corr
    if min_pnr is None:
        min_pnr = ip.min_pnr

    if state is None:
        # AR order of the trace model decides the g-column capacity
        p_ar = 2 if params.temporal.deconv.model in ("ar2", "exp2") else 1
        state = empty_state(K_max, H, W, T, p=p_ar)
    else:
        K_max = state.K_max
    Y_work = jnp.asarray(Y, jnp.float32)
    if ip.nk > 1:
        # slow-trend removal before seeding (initComponents_parallel.m:341-346)
        from cnmf_e_tpu.ops.detrend import detrend
        Y_work = jnp.moveaxis(
            detrend(jnp.moveaxis(Y_work, 0, -1), ip.nk, ip.detrend_method),
            -1, 0)

    HY, Ysig = _init_prolog(Y_work, ip.gSig, ip.center_psf)

    searched = jnp.zeros((H, W), bool)
    if ip.bd > 0:
        bd_mask = np.zeros((H, W), bool)
        bd_mask[:ip.bd] = bd_mask[-ip.bd:] = True
        bd_mask[:, :ip.bd] = bd_mask[:, -ip.bd:] = True
        searched = searched | jnp.asarray(bd_mask)

    import numpy as _np
    n_found = int(_np.asarray(state.active).sum())
    deconv_cfg = (params.temporal.deconv
                  if ip.deconv_at_init and params.temporal.deconv.enabled
                  else None)
    # NMS spacing: gSiz/2 keeps seeds one box-radius apart — enough for
    # the batched extraction to separate them (the reference's order
    # filter spaces seeds by only ~gSiz/4 and relies on serial peeling,
    # greedyROI_endoscope.m:215; full-gSiz suppression pushed adjacent
    # neurons into ~3 extra 130 ms tail rounds each)
    round_fn = _make_init_round(
        ip.gSig, ip.center_psf, gSiz, ip.seeds_per_round,
        max(ip.min_pixel, 5), ip.corr_pixel_thr, deconv_cfg,
        max(gSiz // 2, 4))

    # Host-driven rounds with SPECULATIVE dispatch: round k+1 only needs
    # round k's device-side state (n_found rides along as a device
    # scalar), so it is dispatched before round k's tiny (N, 4) report is
    # fetched — the fetch round trip hides behind the next round's
    # compute. A speculatively executed post-stop round is semantically
    # just another (empty) round, so using the last dispatched state is
    # always correct. (Fusing ALL rounds into one early-exit while_loop
    # program was tried and reverted: past a size threshold the XLA:CPU
    # compiler segfaults on the fused body — see CLAUDE.md test-gate
    # note.)
    seeds_log = []
    nf_dev = jnp.int32(n_found)
    pending = []          # dispatched, un-fetched reports
    lag = 2
    stop = False
    for rnd in range(ip.max_rounds):
        state, Y_work, HY, searched, report, nf_dev = round_fn(
            state, HY, Y_work, Ysig, searched, nf_dev,
            jnp.float32(min_corr), jnp.float32(min_pnr))
        pending.append((rnd, report))
        while pending and (len(pending) > lag
                           or rnd == ip.max_rounds - 1):
            r, rep = pending.pop(0)
            rep = _np.asarray(rep)
            taken = _np.nonzero(rep[:, 2])[0]
            for i in taken:
                seeds_log.append((r, int(rep[i, 0]), int(rep[i, 1])))
            n_found += len(taken)
            if verbose:
                print(f"init round {r}: +{len(taken)} neurons "
                      f"(total {n_found})")
            # stop when nothing was accepted: the remaining "valid"
            # seeds are the weak tail that failed extraction (the
            # residual pick recovers genuine stragglers)
            if len(taken) == 0 or n_found >= K_max:
                stop = True
                break
        if stop:
            break
    for r, rep in pending:
        rep = _np.asarray(rep)
        for i in _np.nonzero(rep[:, 2])[0]:
            seeds_log.append((r, int(rep[i, 0]), int(rep[i, 1])))
            n_found += 1

    cn, pnr, _ = _search_image(HY, Ysig, jnp.zeros((H, W), bool),
                               min_corr, min_pnr)
    info = {"Cn": cn, "PNR": pnr, "seeds": seeds_log, "n_found": n_found,
            "residual_Y": Y_work}
    return state, info


@functools.lru_cache(maxsize=None)
def _make_init_round(gSig: float, center_psf: bool, gSiz: int,
                     n_seeds: int, min_pixel: int, corr_thr: float,
                     deconv, nms_dist: int,
                     trace_mode: str = "corr_mean"):
    """Build the fused one-round init program (compiled once per config).

    One full greedy-init round as a single jitted program with static
    shapes: seed search -> extraction -> deconvolution -> masked slot
    acceptance -> peel -> incremental band-pass refresh.

    The band-passed movie is refreshed INCREMENTALLY: peeling subtracts
    the rank-N update sum_i filter(a_i) (x) (c_i - median(c_i)) from HY
    instead of re-filtering the whole movie (the reference refreshes HY
    locally around each peeled neuron, ``greedyROI_endoscope.m:375-407``;
    a full refilter + fresh per-pixel median per round moves the whole
    movie twice, the filtered-footprint update only the footprints). The
    median correction uses
    median(c_i) because the per-pixel median of the subtracted component
    sum_i f_i[p] c_i[t] factorizes that way for the sparse, non-negative
    traces being peeled.

    ``n_found``/``min_corr``/``min_pnr`` are traced scalars so every
    round (and the residual pick with relaxed thresholds,
    ``initComponents_residual_parallel.m``) hits the same compiled
    program. The psf stays a concrete numpy closure constant (the conv's
    kernel).

    The returned function maps (state, HY, Y_work, Ysig, searched,
    n_found, min_corr, min_pnr) -> (state, Y_work, HY, searched, report)
    with report (n_seeds, 4) int32 [row, col, taken, valid] — the only
    thing the host loop fetches.
    """
    psf = gaussian_psf(gSig, center_psf)

    def one_round(state: CNMFEState, HY, Y_work, Ysig, searched, n_found,
                  min_corr, min_pnr):
        K_max = state.K_max
        _, _, v = _search_image(HY, Ysig, searched, min_corr, min_pnr)
        rows, cols, valid = _local_maxima_topk(
            v, n_seeds, min_corr * min_pnr, nms_dist=nms_dist)
        valid = valid & _weak_signal_test(HY, rows, cols)

        res = extract_ac_batch(HY, Y_work, rows, cols, gSiz,
                               min_pixel=min_pixel, corr_thr=corr_thr,
                               trace_mode=trace_mode)
        ok = res.ok & valid

        # deconvolve the round's traces as one batch
        if deconv is not None:
            dres = deconvolve(res.c_raw, deconv, sn=res.sn)
            c_use, s_use, g_use = dres.c, dres.s, dres.g
        else:
            c_use = jnp.maximum(res.c_raw, 0.0)
            s_use = jnp.zeros_like(res.c_raw)
            g_use = jnp.full((res.c_raw.shape[0], 1), 0.9, jnp.float32)

        gp = state.g.shape[1]
        if g_use.shape[1] < gp:
            g_use = jnp.pad(g_use, ((0, 0), (0, gp - g_use.shape[1])))

        # masked acceptance into fixed slots: rank accepted seeds by index,
        # assign slots past n_found, drop overflow (slot sentinel = K_max
        # is out of bounds for every scatter below -> mode="drop")
        rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
        slot = n_found + rank
        take = ok & (slot < K_max)
        slots = jnp.where(take, slot, K_max)

        A_new, searched2, full_A = _place_footprints_masked(
            state.A, searched, res.a, rows, cols, slots, take, gSiz)
        state = state.replace(
            A=A_new,
            C=state.C.at[slots].set(c_use, mode="drop"),
            C_raw=state.C_raw.at[slots].set(res.c_raw, mode="drop"),
            S=state.S.at[slots].set(s_use, mode="drop"),
            g=state.g.at[slots].set(g_use[:, :gp], mode="drop"),
            neuron_sn=state.neuron_sn.at[slots].set(res.sn, mode="drop"),
            active=state.active.at[slots].set(True, mode="drop"))

        # peel all accepted components at once; refresh the band-passed
        # movie with the filtered footprints (rank-N update, no refilter)
        c_eff = jnp.where(take[:, None], c_use, 0.0)
        Y_new = Y_work - jnp.einsum("khw,kt->thw", full_A, c_eff)
        fA = filter_movie(full_A, psf)
        c_med = jnp.where(take, fast_median(c_eff, axis=-1), 0.0)
        HY_new = HY - jnp.einsum("khw,kt->thw", fA, c_eff - c_med[:, None])

        searched2 = _mark_searched(searched2, rows, cols, valid)
        report = jnp.stack([rows, cols, take.astype(rows.dtype),
                            valid.astype(rows.dtype)], axis=1)
        n_found_new = n_found + jnp.sum(take.astype(jnp.int32))
        return state, Y_new, HY_new, searched2, report, n_found_new

    return jax.jit(one_round)


@functools.partial(jax.jit, static_argnames=("gSiz",))
def _place_footprints_masked(A, searched, a_boxes, rows, cols, slots, take,
                             gSiz: int):
    """Scatter (N, B, B) boxes into (K_max, H, W) slots (out-of-range slot
    indices drop); mark core pixels of TAKEN seeds as searched (a > 0.5 max,
    reference greedyROI_endoscope.m:375). Also returns the full-FOV
    footprint images (N, H, W) for the peel."""
    K_max, H, W = A.shape
    N = a_boxes.shape[0]

    def body(i, carry):
        A, searched, full_A = carry
        pad_img = jnp.zeros((H + 2 * gSiz, W + 2 * gSiz), A.dtype)
        pad_img = jax.lax.dynamic_update_slice(
            pad_img, a_boxes[i], (rows[i], cols[i]))
        img = pad_img[gSiz:gSiz + H, gSiz:gSiz + W]
        full_A = full_A.at[i].set(img)
        A = A.at[slots[i]].set(img, mode="drop")
        core = (img > 0.5 * jnp.max(img)) & take[i]
        return A, searched | core, full_A

    return jax.lax.fori_loop(
        0, N, body, (A, searched, jnp.zeros((N, H, W), A.dtype)))


@functools.partial(jax.jit, static_argnames=())
def _search_image(HY, Ysig, searched, min_corr, min_pnr):
    """(Cn, PNR, masked search value) of the current filtered residual."""
    pnr = jnp.max(HY, axis=0) / jnp.maximum(Ysig, 1e-12)
    HY_thr = jnp.where(HY >= 3.0 * Ysig[None], HY, 0.0)
    cn = jnp.nan_to_num(correlation_image(HY_thr, center=False))
    v = cn * pnr
    v = jnp.where((cn < min_corr) | (pnr < min_pnr) | searched, 0.0, v)
    return cn, pnr, v


@jax.jit
def _mark_searched(searched, rows, cols, valid):
    H, W = searched.shape
    hit = (jax.nn.one_hot(jnp.where(valid, rows, H), H + 1,
                          dtype=jnp.float32)[:, :H, None]
           * jax.nn.one_hot(jnp.where(valid, cols, W), W + 1,
                            dtype=jnp.float32)[:, None, :W])
    return searched | (jnp.sum(hit, axis=0) > 0)


def refilter(Y: jnp.ndarray, psf: np.ndarray) -> jnp.ndarray:
    HY = filter_movie(Y, psf)
    return HY - fast_median(HY, axis=0, keepdims=True)


@functools.partial(jax.jit, static_argnames=("gSig", "center_psf"))
def _init_prolog(Y_work: jnp.ndarray, gSig: float, center_psf: bool):
    """Band-pass + median-center + per-pixel noise in ONE program.

    Run eagerly these are ~50 separate ops, each its own dispatch."""
    psf = gaussian_psf(gSig, center_psf)
    HY = filter_movie(Y_work, psf)
    HY = HY - fast_median(HY, axis=0, keepdims=True)
    Ysig = noise_psd_frames(HY)
    return HY, Ysig
