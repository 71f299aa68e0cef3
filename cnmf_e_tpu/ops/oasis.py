"""OASIS spike deconvolution for AR(1) calcium dynamics, batched.

Solves, per trace,

    min_c  1/2 ||c - y||^2 + lam * ||s||_1
    s.t.   s_t = c_t - g * c_{t-1}  is 0 or >= smin,   c >= 0

with the pool-merging active-set algorithm of Friedrich et al. (NIPS 2016).
Reference implementation: ``OASIS_matlab/packages/oasis/oasisAR1.m:59-109``
(doubly-linked-list sweep). Here the algorithm is re-designed as a single
bounded ``lax.while_loop`` event loop over a pool *stack* held in fixed-size
arrays — each iteration either pushes one time step as a new pool or merges
the top two pools (<= 2T - 1 iterations total) — which vmaps across
thousands of traces (the per-trace loop is inherently sequential, so
throughput comes from batching, not parallelizing a single trace). On a GPU
the same event loop runs as one Pallas kernel (ops/pallas_oasis.py).

Wrappers mirror the reference method family:
  * :func:`foopsi_ar1`        — ``foopsi_oasisAR1.m`` (optional baseline opt)
  * :func:`constrained_ar1`   — ``constrained_oasisAR1.m`` (lambda search so
                                 RSS == sn^2 T, via monotone bisection)
  * :func:`thresholded_ar1`   — ``thresholded_oasisAR1.m`` (smin search)
  * :func:`deconvolve`        — dispatch like ``deconvolveCa.m:108-197``
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops.ar import choose_smin, estimate_time_constant
from cnmf_e_tpu.ops.kernels import PALLAS, choose
from cnmf_e_tpu.ops.noise import estimate_noise


class DeconvResult(NamedTuple):
    c: jnp.ndarray      # denoised trace(s)
    s: jnp.ndarray      # spike train(s)
    b: jnp.ndarray      # baseline(s)
    g: jnp.ndarray      # AR coefficient(s), shape (..., p)
    lam: jnp.ndarray    # final sparsity penalty
    smin: jnp.ndarray   # final spike-size floor


def _oasis_ar1_single(y: jnp.ndarray, g: jnp.ndarray, lam: jnp.ndarray,
                      smin: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-trace OASIS AR(1). y: (T,). Returns (c, s)."""
    T = y.shape[0]
    dt = y.dtype
    # l1 penalty folded into the pool init values (oasisAR1.m:49-51):
    # v_t = y_t - lam*(1-g) for t < T-1, v_{T-1} = y_{T-1} - lam
    vinit = y - lam * (1.0 - g)
    vinit = vinit.at[T - 1].set(y[T - 1] - lam)

    v0 = jnp.zeros(T, dt)
    w0 = jnp.ones(T, dt)
    t0 = jnp.zeros(T, jnp.int32)
    l0 = jnp.zeros(T, jnp.int32)

    def violated(state):
        v, w, ts, ln, n_pool, tcur = state
        p, q = n_pool - 2, n_pool - 1
        vp = jnp.maximum(v[p] / w[p], 0.0)
        vq = v[q] / w[q]
        gl = jnp.exp(jnp.log(jnp.maximum(g, 1e-10)) * ln[p].astype(dt))
        return (n_pool >= 2) & (vq < vp * gl + smin)

    def cond(state):
        _, _, _, _, n_pool, tcur = state
        return (tcur < T) | violated(state)

    def body(state):
        v, w, ts, ln, n_pool, tcur = state

        def do_merge(st):
            v, w, ts, ln, n_pool, tcur = st
            p, q = n_pool - 2, n_pool - 1
            lp = ln[p].astype(dt)
            gl = jnp.exp(jnp.log(jnp.maximum(g, 1e-10)) * lp)
            v = v.at[p].add(v[q] * gl)
            w = w.at[p].add(w[q] * gl * gl)
            ln = ln.at[p].add(ln[q])
            return (v, w, ts, ln, n_pool - 1, tcur)

        def do_push(st):
            v, w, ts, ln, n_pool, tcur = st
            v = v.at[n_pool].set(vinit[tcur])
            w = w.at[n_pool].set(1.0)
            ts = ts.at[n_pool].set(tcur)
            ln = ln.at[n_pool].set(1)
            return (v, w, ts, ln, n_pool + 1, tcur + 1)

        return jax.lax.cond(violated(state), do_merge, do_push, state)

    v, w, ts, ln, n_pool, _ = jax.lax.while_loop(
        cond, body, (v0, w0, t0, l0, jnp.int32(0), jnp.int32(0)))

    # ---- reconstruct c from the pool stack (vectorized, no loops) ----
    tgrid = jnp.arange(T)
    pool_ids = jnp.arange(T)
    valid = pool_ids < n_pool
    # scatter a 1 at each pool start
    is_start = jnp.zeros(T, jnp.int32).at[jnp.where(valid, ts, 0)].max(
        valid.astype(jnp.int32))
    is_start = is_start.at[0].set(1)
    seg = jnp.cumsum(is_start) - 1                 # pool index per time step
    pool_val = jnp.maximum(v / w, 0.0)             # per-pool amplitude
    c = pool_val[seg] * jnp.exp(
        jnp.log(jnp.maximum(g, 1e-10)) * (tgrid - ts[seg]).astype(dt))
    c_prev = jnp.concatenate([jnp.zeros(1, dt), c[:-1]])
    s = jnp.where((is_start == 1) & (tgrid > 0), c - g * c_prev, 0.0)
    return c, s


def _oasis_pools_single(v0, w0, ts0, l0, n_in, g, smin, T):
    """Pool-granularity OASIS event loop: merge an ordered list of pools.

    Inputs are per-trace pool arrays of capacity T (valid up to ``n_in``),
    with pool values already lambda-adjusted. Returns (c, s) of length T.
    This generalizes the sample-level loop (each event pushes the next
    *pool* instead of the next sample), enabling the divide-and-conquer
    fast path: chunk-local solves shrink T samples to far fewer pools, and
    this loop's trip count scales with the pool count, not T.
    """
    dt = v0.dtype
    v = jnp.zeros(T, dt)
    w = jnp.ones(T, dt)
    ts = jnp.zeros(T, jnp.int32)
    ln = jnp.zeros(T, jnp.int32)
    logg = jnp.log(jnp.maximum(g, 1e-10))

    def violated(state):
        v, w, ts, ln, n_pool, icur = state
        p, q = n_pool - 2, n_pool - 1
        vp = jnp.maximum(v[p] / w[p], 0.0)
        vq = v[q] / w[q]
        gl = jnp.exp(logg * ln[p].astype(dt))
        return (n_pool >= 2) & (vq < vp * gl + smin)

    def cond(state):
        _, _, _, _, n_pool, icur = state
        return (icur < n_in) | violated(state)

    def body(state):
        v, w, ts, ln, n_pool, icur = state

        def do_merge(st):
            v, w, ts, ln, n_pool, icur = st
            p, q = n_pool - 2, n_pool - 1
            gl = jnp.exp(logg * ln[p].astype(dt))
            v = v.at[p].add(v[q] * gl)
            w = w.at[p].add(w[q] * gl * gl)
            ln = ln.at[p].add(ln[q])
            return (v, w, ts, ln, n_pool - 1, icur)

        def do_push(st):
            v, w, ts, ln, n_pool, icur = st
            v = v.at[n_pool].set(v0[icur])
            w = w.at[n_pool].set(w0[icur])
            ts = ts.at[n_pool].set(ts0[icur])
            ln = ln.at[n_pool].set(l0[icur])
            return (v, w, ts, ln, n_pool + 1, icur + 1)

        return jax.lax.cond(violated(state), do_merge, do_push, state)

    v, w, ts, ln, n_pool, _ = jax.lax.while_loop(
        cond, body, (v, w, ts, ln, jnp.int32(0), jnp.int32(0)))

    # reconstruct c from the pool stack (same as the sample-level loop)
    tgrid = jnp.arange(T)
    valid = jnp.arange(T) < n_pool
    is_start = jnp.zeros(T, jnp.int32).at[jnp.where(valid, ts, 0)].max(
        valid.astype(jnp.int32))
    is_start = is_start.at[0].set(1)
    seg = jnp.cumsum(is_start) - 1
    pool_val = jnp.maximum(v / w, 0.0)
    c = pool_val[seg] * jnp.exp(logg * (tgrid - ts[seg]).astype(dt))
    c_prev = jnp.concatenate([jnp.zeros(1, dt), c[:-1]])
    s = jnp.where((is_start == 1) & (tgrid > 0), c - g * c_prev, 0.0)
    return c, s


def _chunk_pools_single(y_adj, g, smin, L):
    """Solve OASIS independently on length-L chunks of one trace and return
    the chunk pools packed in order: (v, w, ts, l, count) of capacity T."""
    T = y_adj.shape[0]
    n_chunks = T // L
    dt = y_adj.dtype
    logg = jnp.log(jnp.maximum(g, 1e-10))

    def chunk(yc, t_off):
        # sample-level stack loop on one chunk
        v = jnp.zeros(L, dt)
        w = jnp.ones(L, dt)
        ln = jnp.zeros(L, jnp.int32)
        ts = jnp.zeros(L, jnp.int32)

        def violated(state):
            v, w, ts, ln, n_pool, tcur = state
            p, q = n_pool - 2, n_pool - 1
            vp = jnp.maximum(v[p] / w[p], 0.0)
            vq = v[q] / w[q]
            gl = jnp.exp(logg * ln[p].astype(dt))
            return (n_pool >= 2) & (vq < vp * gl + smin)

        def cond(state):
            _, _, _, _, n_pool, tcur = state
            return (tcur < L) | violated(state)

        def body(state):
            v, w, ts, ln, n_pool, tcur = state

            def do_merge(st):
                v, w, ts, ln, n_pool, tcur = st
                p, q = n_pool - 2, n_pool - 1
                gl = jnp.exp(logg * ln[p].astype(dt))
                v = v.at[p].add(v[q] * gl)
                w = w.at[p].add(w[q] * gl * gl)
                ln = ln.at[p].add(ln[q])
                return (v, w, ts, ln, n_pool - 1, tcur)

            def do_push(st):
                v, w, ts, ln, n_pool, tcur = st
                v = v.at[n_pool].set(yc[tcur])
                w = w.at[n_pool].set(1.0)
                ts = ts.at[n_pool].set(t_off + tcur)
                ln = ln.at[n_pool].set(1)
                return (v, w, ts, ln, n_pool + 1, tcur + 1)

            return jax.lax.cond(violated(state), do_merge, do_push, state)

        v, w, ts, ln, n_pool, _ = jax.lax.while_loop(
            cond, body, (v, w, ts, ln, jnp.int32(0), jnp.int32(0)))
        return v, w, ts, ln, n_pool

    y_chunks = y_adj.reshape(n_chunks, L)
    offs = jnp.arange(n_chunks, dtype=jnp.int32) * L
    cv, cw, cts, cl, cn = jax.vmap(chunk)(y_chunks, offs)

    # order-preserving packing of valid pools into (T,) arrays; invalid
    # entries scatter to slot T-1, which valid pools never occupy when any
    # merging happened (total < T), and no invalid entries exist otherwise
    slot_valid = jnp.arange(L)[None, :] < cn[:, None]        # (nc, L)
    flat_valid = slot_valid.reshape(-1)
    pos = jnp.cumsum(flat_valid) - 1                         # target index
    idx = jnp.where(flat_valid, pos, T - 1)
    total = jnp.sum(cn)

    def pack(x, fill):
        out = jnp.full((T,), fill, x.reshape(-1).dtype)
        return out.at[idx].set(jnp.where(flat_valid, x.reshape(-1), fill))

    pv = pack(cv, jnp.asarray(0.0, dt))
    pw = pack(cw, jnp.asarray(1.0, dt))
    pts = pack(cts, jnp.asarray(0, jnp.int32))
    pl = pack(cl, jnp.asarray(0, jnp.int32))
    return pv, pw, pts, pl, total


def _oasis_ar1_dc_single(y, g, lam, smin, L, T_real=None):
    """Divide-and-conquer OASIS on one trace: chunk solves + pool merge.

    ``T_real`` marks the last REAL sample (before never-merge padding) so
    the boundary lambda adjustment lands on it (oasisAR1.m:50)."""
    T = y.shape[0]
    last = (T if T_real is None else T_real) - 1
    vinit = y - lam * (1.0 - g)
    vinit = vinit.at[last].set(y[last] - lam)
    pv, pw, pts, pl, n = _chunk_pools_single(vinit, g, smin, L)
    return _oasis_pools_single(pv, pw, pts, pl, n, g, smin, T)


def oasis_ar1(y: jnp.ndarray, g: jnp.ndarray, lam=0.0, smin=0.0,
              chunk: int = 128, impl: Optional[str] = None
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched OASIS AR(1). y: (..., T); g/lam/smin scalars or (...,).

    ``impl``: "pallas-triton" or "xla"; None asks
    :func:`cnmf_e_tpu.ops.kernels.choose`. The Pallas event-loop kernel
    (ops/pallas_oasis.py) runs the whole sequential pool merge inside one
    program — exact sample-level semantics.

    The XLA form uses the divide-and-conquer fast path when every smin is
    0: chunk-local pool solves run in parallel (vmapped, while-loop trip
    count ~2*chunk), then a pool-granularity event loop merges across
    chunk boundaries — its trip count scales with the surviving pool
    count (typically << T). Without a spike floor pool merging is
    confluent (PAVA), so that equals the sequential algorithm. With
    smin > 0 it is not: merge order decides which pools survive, and the
    chunked solve differs from the sequential one on about half of
    realistic traces. Any smin > 0 therefore runs the sample-level loop,
    so both implementations solve the same problem.

    Returns (c, s) with the same shape as y.
    """
    y = jnp.asarray(y)
    batch_shape = y.shape[:-1]
    T = y.shape[-1]
    if impl is None:
        impl = choose("oasis")
    if T > 2304:
        # long recordings: overlap-windowed solve over 2304-sample windows
        # (see _oasis_ar1_windowed); the window length shapes the result
        return _oasis_ar1_windowed(y, g, lam, smin, chunk, impl=impl)
    yf = y.reshape(-1, T)
    bc = lambda x: jnp.broadcast_to(jnp.asarray(x, yf.dtype), batch_shape).reshape(-1)

    if impl == PALLAS:
        from cnmf_e_tpu.ops.pallas_oasis import oasis_ar1_pallas
        c, s = oasis_ar1_pallas(yf, bc(g), bc(lam), bc(smin))
        return c.reshape(y.shape), s.reshape(y.shape)
    args = (yf, bc(g), bc(lam), bc(smin))

    def sample_level(yf, g, lam, smin):
        return jax.vmap(_oasis_ar1_single)(yf, g, lam, smin)

    def divide_and_conquer(yf, g, lam, smin):
        # pad to a chunk multiple with huge values: a sample far above any
        # decayed predecessor never triggers a merge, so the pad pools stay
        # isolated after the real trace and are sliced off below
        Tpad = -(-T // chunk) * chunk
        if Tpad != T:
            big = jnp.max(jnp.abs(yf)) * 2.0 + 1e6
            yf = jnp.concatenate(
                [yf, jnp.full((yf.shape[0], Tpad - T), big, yf.dtype)],
                axis=-1)
        c, s = jax.vmap(
            functools.partial(_oasis_ar1_dc_single, L=chunk, T_real=T))(
                yf, g, lam, smin)
        return c[:, :T], s[:, :T]

    if not (chunk and T > chunk):
        c, s = sample_level(*args)
    elif isinstance(smin, (int, float)):
        c, s = (divide_and_conquer if smin == 0 else sample_level)(*args)
    else:
        c, s = jax.lax.cond(jnp.all(args[3] == 0), divide_and_conquer,
                            sample_level, *args)
    return c.reshape(y.shape), s.reshape(y.shape)


def _oasis_ar1_windowed(y, g, lam, smin, chunk,
                        win: int = 1280, overlap: int = 512,
                        impl: Optional[str] = None
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Overlap-windowed OASIS for long recordings (T > 2304).

    The batched event loops' sequential depth scales with T. AR(1)
    influence decays as g^dt, so the trace splits into ``win``-sample
    windows with ``overlap``-sample context on both sides (the reference
    applies the same windowing to its online solver, ``onnls.m:14-19``,
    with far shorter windows); each (win + 2*overlap = 2304)-sample window
    is solved as its own trace, batched with all others, and only the
    interior ``win`` samples are kept. Window boundary error is bounded
    by g^overlap of a pool crossing the seam (< 0.36 even at g = 0.998,
    < 4e-12 at g = 0.95) and only affects pools spanning a cut.
    """
    batch_shape = y.shape[:-1]
    T = y.shape[-1]
    yf = y.reshape(-1, T)
    K = yf.shape[0]
    n_win = -(-T // win)
    Tp = n_win * win
    yp = jnp.pad(yf, ((0, 0), (overlap, Tp - T + overlap)))
    L = win + 2 * overlap
    idx = (np.arange(n_win) * win)[:, None] + np.arange(L)[None]
    Yw = yp[:, idx].reshape(K * n_win, L)          # (K*n_win, L)

    def rep(x):
        xb = jnp.broadcast_to(jnp.asarray(x, yf.dtype),
                              batch_shape).reshape(-1)
        return jnp.repeat(xb, n_win)

    c, s = oasis_ar1(Yw, rep(g), rep(lam), rep(smin), chunk=chunk,
                     impl=impl)
    c = c.reshape(K, n_win * L)
    s = s.reshape(K, n_win * L)
    keep = (np.arange(n_win) * L)[:, None] + overlap + np.arange(win)[None]
    keep = jnp.asarray(keep.reshape(-1))
    c = c[:, keep][:, :T].reshape(y.shape)
    s = s[:, keep][:, :T].reshape(y.shape)
    return c, s


def _rss(y, c):
    return jnp.sum((y - c) ** 2, axis=-1)


def _g1(g, batch, dtype):
    """Normalize g to shape ``batch`` (scalar AR(1) coefficient per trace)."""
    g = jnp.asarray(g, dtype)
    if g.ndim > len(batch):      # (..., p) from estimate_time_constant
        g = g[..., 0]
    return jnp.broadcast_to(g, batch)


def foopsi_ar1(y: jnp.ndarray, g: jnp.ndarray, lam=0.0, smin=0.0,
               sn: Optional[jnp.ndarray] = None, optimize_b: bool = False,
               max_iter: int = 10, chunk: int = 128,
               impl: Optional[str] = None) -> DeconvResult:
    """FOOPSI via OASIS (reference: ``foopsi_oasisAR1.m``).

    ``smin < 0`` means ``|smin| * sn`` (noise-proportional spike floor,
    foopsi_oasisAR1.m:44-49). With ``optimize_b``, alternates the baseline
    b = mean(y - c) with re-deconvolution (foopsi_oasisAR1.m:91-97).
    """
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g = _g1(g, batch, y.dtype)
    smin_arr = jnp.broadcast_to(jnp.asarray(smin, y.dtype), batch)
    smin_arr = jnp.where(smin_arr < 0, jnp.abs(smin_arr) * sn, smin_arr)
    lam_arr = jnp.broadcast_to(jnp.asarray(lam, y.dtype), batch)

    if not optimize_b:
        c, s = oasis_ar1(y, g, lam_arr, smin_arr, chunk=chunk, impl=impl)
        b = jnp.zeros(batch, y.dtype)
        return DeconvResult(c, s, b, g[..., None], lam_arr, smin_arr)

    b = jnp.quantile(y, 0.15, axis=-1)

    def step(carry, _):
        b, c, s = carry
        c, s = oasis_ar1(y - b[..., None], g, lam_arr, smin_arr, chunk=chunk,
                         impl=impl)
        b = jnp.mean(y - c, axis=-1)
        return (b, c, s), None

    c0 = jnp.zeros_like(y)
    (b, c, s), _ = jax.lax.scan(step, (b, c0, c0), None, length=max_iter)
    return DeconvResult(c, s, b, g[..., None], lam_arr, smin_arr)


def constrained_ar1(y: jnp.ndarray, g: jnp.ndarray,
                    sn: Optional[jnp.ndarray] = None, optimize_b: bool = True,
                    n_bisect: int = 20, chunk: int = 128,
                    impl: Optional[str] = None) -> DeconvResult:
    """Noise-constrained deconvolution: find lambda so RSS ~= sn^2 * T
    (reference: ``constrained_oasisAR1.m:83-113``).

    The reference updates lambda with a local gradient step (``update_phi``);
    RSS(lambda) is monotone nondecreasing, so we use robust bisection on
    lambda in [0, lam_max] — fully batched, fixed iteration count.
    """
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    T = y.shape[-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g = _g1(g, batch, y.dtype)
    thresh = sn * sn * T

    b = jnp.quantile(y, 0.15, axis=-1) if optimize_b else jnp.zeros(batch, y.dtype)

    def rss_of(lam, b):
        c, s = oasis_ar1(y - b[..., None], g, lam, 0.0, chunk=chunk, impl=impl)
        return _rss(y - b[..., None], c), c, s

    # if even lam = 0 exceeds the noise budget, keep lam = 0
    rss0, c0, s0 = rss_of(jnp.zeros(batch, y.dtype), b)
    lam_hi0 = jnp.maximum(jnp.max(jnp.abs(y), axis=-1), 1.0) * 2.0

    def bisect_step(carry, _):
        lo, hi, b = carry
        mid = 0.5 * (lo + hi)
        rss, c, _ = rss_of(mid, b)
        too_smooth = rss > thresh     # lambda too big
        lo = jnp.where(too_smooth, lo, mid)
        hi = jnp.where(too_smooth, mid, hi)
        if optimize_b:
            b = jnp.mean(y - c, axis=-1)
        return (lo, hi, b), None

    lo = jnp.zeros(batch, y.dtype)
    (lo, hi, b), _ = jax.lax.scan(bisect_step, (lo, lam_hi0, b), None,
                                  length=n_bisect)
    lam = lo
    c, s = oasis_ar1(y - b[..., None], g, lam, 0.0, chunk=chunk, impl=impl)
    # traces whose lam=0 solution already exceeds the noise floor keep lam=0
    done0 = rss0 >= thresh
    c = jnp.where(done0[..., None], c0, c)
    s = jnp.where(done0[..., None], s0, s)
    lam = jnp.where(done0, 0.0, lam)
    return DeconvResult(c, s, b, g[..., None], lam, jnp.zeros(batch, y.dtype))


def thresholded_ar1(y: jnp.ndarray, g: jnp.ndarray,
                    sn: Optional[jnp.ndarray] = None,
                    optimize_b: bool = True, thresh_factor: float = 1.0,
                    p_noise: float = 0.9999, n_search: int = 10,
                    chunk: int = 128,
                    impl: Optional[str] = None) -> DeconvResult:
    """Hard-threshold (smin) deconvolution (reference:
    ``thresholded_oasisAR1.m:79-140``): start from the statistically chosen
    smin = choose_smin(g, sn, p_noise), then scale smin by bisection so the
    RSS approaches ``thresh_factor * sn^2 * T``."""
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    T = y.shape[-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g1 = _g1(g, batch, y.dtype)
    thresh = thresh_factor * sn * sn * T
    smin0 = choose_smin(g1[..., None], sn, p_noise)

    b = jnp.quantile(y, 0.15, axis=-1) if optimize_b else jnp.zeros(batch, y.dtype)

    def run(smin, b):
        c, s = oasis_ar1(y - b[..., None], g1, 0.0, smin, chunk=chunk,
                         impl=impl)
        return _rss(y - b[..., None], c), c, s

    # bisection on a multiplier of smin0 in [0.5, 8]
    def step(carry, _):
        lo, hi, b = carry
        mid = 0.5 * (lo + hi)
        rss, c, _ = run(mid * smin0, b)
        too_sparse = rss > thresh
        lo = jnp.where(too_sparse, lo, mid)
        hi = jnp.where(too_sparse, mid, hi)
        if optimize_b:
            b = jnp.mean(y - c, axis=-1)
        return (lo, hi, b), None

    lo = jnp.full(batch, 0.5, y.dtype)
    hi = jnp.full(batch, 8.0, y.dtype)
    (lo, hi, b), _ = jax.lax.scan(step, (lo, hi, b), None, length=n_search)
    smin = lo * smin0
    c, s = oasis_ar1(y - b[..., None], g1, 0.0, smin, chunk=chunk, impl=impl)
    return DeconvResult(c, s, b, g1[..., None], jnp.zeros(batch, y.dtype), smin)


def optimize_g(y: jnp.ndarray, g0: jnp.ndarray, lam=0.0, smin=0.0,
               sn: Optional[jnp.ndarray] = None,
               g_range: Tuple[float, float] = (0.5, 0.99),
               n_iter: int = 12, chunk: int = 128,
               impl: Optional[str] = None
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Optimize the AR(1) coefficient per trace by golden-section search on
    the deconvolution RSS (reference: ``update_g`` inside
    ``foopsi_oasisAR1.m:120-179`` — there a pool-preserving fminbnd; here a
    batched bracket search with full OASIS re-solves, fixed iterations).

    Returns (g, c, s).
    """
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    smin_arr = jnp.broadcast_to(jnp.asarray(smin, y.dtype), batch)
    if sn is not None:
        smin_arr = jnp.where(smin_arr < 0, jnp.abs(smin_arr) * sn, smin_arr)

    phi = 0.6180339887498949

    def rss_at(g):
        c, _ = oasis_ar1(y, g, lam, smin_arr, chunk=chunk, impl=impl)
        return jnp.sum((y - c) ** 2, axis=-1)

    # RSS(g) has kinks/local minima when smin > 0: coarse grid scan first,
    # then golden-section refine inside the best bracket
    n_grid = 13
    grid = jnp.linspace(g_range[0], g_range[1], n_grid)

    def eval_grid(carry, gv):
        return carry, rss_at(jnp.broadcast_to(gv, batch))

    _, rss_grid = jax.lax.scan(eval_grid, None, grid)      # (n_grid, ...)
    best = jnp.argmin(rss_grid, axis=0)
    step = (g_range[1] - g_range[0]) / (n_grid - 1)
    lo = jnp.maximum(grid[0] + (best - 1) * step, g_range[0]).astype(y.dtype)
    hi = jnp.minimum(grid[0] + (best + 1) * step, g_range[1]).astype(y.dtype)
    x1 = hi - phi * (hi - lo)
    x2 = lo + phi * (hi - lo)
    f1, f2 = rss_at(x1), rss_at(x2)

    def body(carry, _):
        lo, hi, x1, x2, f1, f2 = carry
        go_left = f1 < f2
        hi = jnp.where(go_left, x2, hi)
        lo = jnp.where(go_left, lo, x1)
        x1n = hi - phi * (hi - lo)
        x2n = lo + phi * (hi - lo)
        f1n = rss_at(x1n)
        f2n = rss_at(x2n)
        return (lo, hi, x1n, x2n, f1n, f2n), None

    (lo, hi, x1, x2, f1, f2), _ = jax.lax.scan(
        body, (lo, hi, x1, x2, f1, f2), None, length=n_iter)
    g = 0.5 * (lo + hi)
    c, s = oasis_ar1(y, g, lam, smin_arr, chunk=chunk, impl=impl)
    return g, c, s


@functools.partial(jax.jit, static_argnames=("params", "impl"))
def deconvolve(y: jnp.ndarray, params: DeconvParams,
               sn: Optional[jnp.ndarray] = None,
               g: Optional[jnp.ndarray] = None,
               impl: Optional[str] = None) -> DeconvResult:
    """Unified deconvolution entry point (reference: ``deconvolveCa.m``).

    y: (..., T) raw traces. Estimates sn (Welch PSD) and AR coefficients when
    not given, clamps g into ``exp(-1/tau_range)``, then dispatches on
    ``params.method``. AR(2)/exp2 models route through the windowed NNLS
    solver in :mod:`cnmf_e_tpu.ops.onnls`. ``impl`` picks the AR(1) OASIS
    implementation (see :func:`oasis_ar1`); callers under a mesh pass
    ``kernels.choose("oasis", mesh=mesh)``.
    """
    y = jnp.asarray(y)
    if sn is None:
        sn = estimate_noise(y, params.sn_method)
    if params.model in ("ar1", "ar2"):
        p = 1 if params.model == "ar1" else 2
        if g is None:
            g = estimate_time_constant(y, p=p, sn=sn, lags=params.ar_lags,
                                       fudge_factor=params.fudge_factor,
                                       g_range=params.g_range)
        if params.tau_range is not None and p == 1:
            g_lo = jnp.exp(-1.0 / params.tau_range[0])
            g_hi = jnp.exp(-1.0 / params.tau_range[1])
            g = jnp.clip(g, g_lo, g_hi)
    if params.method == "mcem":
        # Monte-Carlo EM with time-constant resampling
        # (utilities/MCEM_foopsi.m via update_temporal_components.m:323-326)
        from cnmf_e_tpu.ops.mcem import mcem_foopsi
        return mcem_foopsi(y, params, sn=sn, g=g)
    if params.model == "ar2" or params.model == "exp2":
        from cnmf_e_tpu.ops.onnls import onnls_deconvolve
        return onnls_deconvolve(y, g, sn, params)
    if params.model == "kernel":
        # arbitrary finite kernel: exact windowed NNLS with residual carry
        # (onnls.py::onnls_kernel — the reference 'kernel' model semantics)
        from cnmf_e_tpu.ops.onnls import causal_conv, onnls_kernel
        assert g is not None, "kernel model requires the kernel via g"
        h = jnp.asarray(g).reshape(-1)
        batch = y.shape[:-1]
        b = jnp.quantile(y, 0.15, axis=-1) if params.optimize_b else \
            jnp.zeros(batch, y.dtype)
        c, s = onnls_kernel(y - b[..., None], h, lam=params.lam)
        if params.optimize_b:
            b = b + jnp.mean(y - b[..., None] - c, axis=-1)
            c, s = onnls_kernel(y - b[..., None], h, lam=params.lam)
        if params.smin != 0:
            floor = (abs(params.smin) * sn)[..., None] if params.smin < 0 \
                else jnp.asarray(params.smin, y.dtype)
            s = jnp.where(s >= floor, s, 0.0)
            c = causal_conv(s, h)
        return DeconvResult(
            c, s, b, h, jnp.broadcast_to(jnp.asarray(params.lam, y.dtype),
                                         batch),
            jnp.broadcast_to(jnp.asarray(params.smin, y.dtype), batch))
    if params.model != "ar1":
        raise NotImplementedError(f"model {params.model!r}")

    ck = params.fast_chunk
    if params.method == "mcmc":
        from cnmf_e_tpu.ops.mcmc import mcmc_spikes
        batch = y.shape[:-1]
        yf = y.reshape((-1, y.shape[-1]))
        res = mcmc_spikes(yf, _g1(g, (yf.shape[0],), y.dtype),
                          sn.reshape(-1))
        return DeconvResult(
            c=res.c_mean.reshape(y.shape), s=res.spike_mean.reshape(y.shape),
            b=res.b_mean.reshape(batch), g=jnp.asarray(g),
            lam=jnp.zeros(batch, y.dtype), smin=jnp.zeros(batch, y.dtype))
    if params.method == "foopsi":
        return foopsi_ar1(y, g, lam=params.lam, smin=params.smin, sn=sn,
                          optimize_b=params.optimize_b,
                          max_iter=params.max_iter, chunk=ck, impl=impl)
    if params.method == "constrained":
        return constrained_ar1(y, g, sn=sn, optimize_b=params.optimize_b,
                               chunk=ck, impl=impl)
    if params.method == "thresholded":
        return thresholded_ar1(y, g, sn=sn, optimize_b=params.optimize_b,
                               thresh_factor=params.thresh_factor,
                               p_noise=params.p_noise, chunk=ck, impl=impl)
    raise ValueError(f"unknown method {params.method!r}")
