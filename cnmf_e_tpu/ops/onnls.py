"""Windowed online NNLS deconvolution for AR(2) / double-exponential kernels.

Reference: ``OASIS_matlab/packages/oasis/onnls.m:1-50`` — slides a window
(win=200, shift=100) over the trace, solving a warm-started active-set NNLS
per window and carrying forward the contribution of committed spikes.

Batched re-design: the kernel is a difference of exponentials
``h[t] = (d^(t+1) - r^(t+1)) / (d - r)``, so the influence of *all* past
spikes on future samples is captured exactly by a 2-dimensional exponential
state ``(z_d, z_r)``. We scan over windows; each step
  1. subtracts the tail predicted by the state,
  2. solves the window NNLS with batched FISTA (fixed iterations),
  3. commits the first ``shift`` spikes and advances the state.
The scan is sequential over ~T/shift windows but fully batched over traces.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops.ar import ar2exp
from cnmf_e_tpu.ops.nnls import nnls_fista


def _kernel_cols(d: jnp.ndarray, r: jnp.ndarray, win: int) -> jnp.ndarray:
    """Lower-triangular Toeplitz kernel matrix H (win, win), batched over
    leading dims of d/r: H[i, j] = h[i - j] for i >= j."""
    t = jnp.arange(win, dtype=d.dtype)
    dd = jnp.maximum(d - r, 1e-6)[..., None]
    h = (d[..., None] ** (t + 1) - r[..., None] ** (t + 1)) / dd  # (..., win)
    i = jnp.arange(win)[:, None]
    j = jnp.arange(win)[None, :]
    lag = i - j
    Hfull = jnp.where(lag >= 0, h[..., jnp.clip(lag, 0, win - 1)], 0.0)
    return Hfull  # (..., win, win)


def onnls(y: jnp.ndarray, d: jnp.ndarray, r: jnp.ndarray, win: int = 200,
          shift: int = 100, fista_iters: int = 60,
          lam: float = 0.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched windowed NNLS deconvolution. y: (..., T); ``lam`` a scalar
    or per-trace (...,). Returns (c, s)."""
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    T = y.shape[-1]
    lam = jnp.broadcast_to(jnp.asarray(lam, y.dtype), batch)[..., None]
    win = min(win, T)
    shift = min(shift, win)
    n_win = max((T - (win - shift) + shift - 1) // shift, 1)
    Tpad = (n_win - 1) * shift + win
    ypad = jnp.concatenate(
        [y, jnp.zeros(batch + (Tpad - T,), y.dtype)], axis=-1)

    H = _kernel_cols(d, r, win)                       # (..., win, win)
    G = jnp.einsum("...ij,...ik->...jk", H, H)        # (..., win, win)
    # the final window may cover `Tpad - T` zero-padded frames; fitting
    # those rows (where y = 0 but the past-spike tail is not) biases
    # end-of-trace spikes toward zero — mask them out of the last
    # window's normal equations (pad < shift, so only the last window is
    # affected; the masked Gram is precomputed since T/win are static)
    n_valid_last = win - (Tpad - T)
    row_ok_last = (jnp.arange(win) < n_valid_last).astype(y.dtype)
    Hm = H * row_ok_last[:, None]
    G_last = jnp.einsum("...ij,...ik->...jk", Hm, Hm)
    # spike decay basis for the state update
    t_idx = jnp.arange(win, dtype=y.dtype)
    dpow = d[..., None] ** t_idx                       # (..., win)
    rpow = r[..., None] ** t_idx
    dd = jnp.maximum(d - r, 1e-6)

    def window(carry, k):
        zd, zr, s_acc, s_warm = carry
        t0 = k * shift
        yw = jax.lax.dynamic_slice_in_dim(ypad, t0, win, axis=-1)
        # tail of past spikes: contribution at t0 + t is
        # (zd * d^(t+1) - zr * r^(t+1)) / (d - r)
        tail = (zd[..., None] * dpow * d[..., None]
                - zr[..., None] * rpow * r[..., None]) / dd[..., None]
        last = k == n_win - 1
        row_ok = jnp.where(last, row_ok_last, jnp.ones(win, y.dtype))
        Gk = jnp.where(last, G_last, G)
        b = jnp.einsum("...ij,...i->...j", H,
                       (yw - tail) * row_ok) - lam
        # warm start from the previous window's overlap (its uncommitted
        # spikes at offsets >= shift are this window's offsets - shift):
        # cuts the FISTA iterations needed for a given accuracy ~3x
        s_w = nnls_fista(Gk, b, x0=s_warm, n_iter=fista_iters)
        # commit the first `shift` spikes (all on the final window)
        commit = jnp.where(k == n_win - 1, win, shift)
        keep_mask = jnp.arange(win) < commit
        s_commit = jnp.where(keep_mask, s_w, 0.0)
        s_acc = jax.lax.dynamic_update_slice_in_dim(
            s_acc, jax.lax.dynamic_slice_in_dim(s_acc, t0, win, axis=-1)
            + s_commit, t0, axis=-1)
        # advance exponential state by `shift` steps incl. committed spikes
        adv_d = d ** jnp.asarray(shift, y.dtype)
        adv_r = r ** jnp.asarray(shift, y.dtype)
        # a committed spike at offset u contributes d^(shift-u) to the state
        # (state convention: zd = sum_{j < t0'} s_j d^(t0' - j))
        u = jnp.arange(win, dtype=y.dtype)
        expo = jnp.maximum(jnp.asarray(shift, y.dtype) - u, 0.0)
        in_commit = jnp.arange(win) < shift
        wd = jnp.where(in_commit, d[..., None] ** expo, 0.0)
        wr = jnp.where(in_commit, r[..., None] ** expo, 0.0)
        zd = zd * adv_d + jnp.sum(wd * s_w, axis=-1)
        zr = zr * adv_r + jnp.sum(wr * s_w, axis=-1)
        # next window's warm start: this window's solution shifted left
        s_next = jnp.concatenate(
            [s_w[..., shift:], jnp.zeros(batch + (shift,), y.dtype)],
            axis=-1)
        return (zd, zr, s_acc, s_next), None

    zd0 = jnp.zeros(batch, y.dtype)
    zr0 = jnp.zeros(batch, y.dtype)
    s0 = jnp.zeros(batch + (Tpad,), y.dtype)
    sw0 = jnp.zeros(batch + (win,), y.dtype)
    (_, _, s, _), _ = jax.lax.scan(window, (zd0, zr0, s0, sw0),
                                   jnp.arange(n_win))
    s = s[..., :T]

    # reconstruct c by the AR(2) recurrence c_t = g1 c_{t-1} + g2 c_{t-2} + s_t
    g1 = d + r
    g2 = -d * r

    def rec(carry, s_t):
        c1, c2 = carry
        c_t = g1 * c1 + g2 * c2 + s_t
        return (c_t, c1), c_t

    s_tfirst = jnp.moveaxis(s, -1, 0)
    _, c_tfirst = jax.lax.scan(rec, (jnp.zeros(batch, y.dtype),
                                     jnp.zeros(batch, y.dtype)), s_tfirst)
    c = jnp.moveaxis(c_tfirst, 0, -1)
    return c, s


def onnls_kernel(y: jnp.ndarray, h: jnp.ndarray, win: int = 200,
                 shift: int = 100, fista_iters: int = 60,
                 lam: float = 0.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed NNLS deconvolution with an ARBITRARY finite kernel.

    Exact counterpart of the reference 'kernel' model (``onnls.m:1-50``
    with a ``create_kernel``-style impulse response): no state-space trick
    exists for a generic kernel, so the scan carries the RESIDUAL trace —
    after committing the first ``shift`` spikes of each window, their full
    kernel contribution is subtracted from the residual, exactly like the
    reference's in-place ``y`` update.

    y: (..., T); h: (Lh,) impulse response (h[0] should be ~1); ``lam`` a
    scalar or per-trace (...,). Returns (c, s) with c = h * s (causal
    convolution).
    """
    y = jnp.asarray(y)
    h = jnp.asarray(h, y.dtype).reshape(-1)
    batch = y.shape[:-1]
    T = y.shape[-1]
    lam = jnp.broadcast_to(jnp.asarray(lam, y.dtype), batch)[..., None]
    Lh = h.shape[0]
    win = min(win, T)
    shift = min(shift, win)
    n_win = max((T - (win - shift) + shift - 1) // shift, 1)
    Tpad = (n_win - 1) * shift + win

    # design matrix on a window: H[i, j] = h[i - j] (lower-tri Toeplitz)
    i = jnp.arange(win)[:, None]
    j = jnp.arange(win)[None, :]
    lag = i - j
    hw = jnp.concatenate([h, jnp.zeros((max(win - Lh, 0),), y.dtype)])[:win]
    H = jnp.where(lag >= 0, hw[jnp.clip(lag, 0, win - 1)], 0.0)
    G = H.T @ H                                       # (win, win)
    # mask zero-padded frames out of the last window's normal equations
    # (same end-of-trace bias fix as the exp2 path above)
    n_valid_last = win - (Tpad - T)
    row_ok_last = (jnp.arange(win) < n_valid_last).astype(y.dtype)
    Hm = H * row_ok_last[:, None]
    G_last = Hm.T @ Hm

    # committed-contribution matrix: spike at offset u spreads h over
    # [u, u + Lh); rows = spike offset, cols = contribution offset
    Lc = win + Lh - 1
    uu = jnp.arange(win)[:, None]
    ll = jnp.arange(Lc)[None, :]
    clag = ll - uu
    Hc = jnp.where((clag >= 0) & (clag < Lh),
                   h[jnp.clip(clag, 0, Lh - 1)], 0.0)  # (win, Lc)

    y_res0 = jnp.concatenate(
        [y, jnp.zeros(batch + (Tpad + Lc - T,), y.dtype)], axis=-1)
    s0 = jnp.zeros(batch + (Tpad,), y.dtype)

    def window(carry, k):
        y_res, s_acc, s_warm = carry
        t0 = k * shift
        yw = jax.lax.dynamic_slice_in_dim(y_res, t0, win, axis=-1)
        last = k == n_win - 1
        row_ok = jnp.where(last, row_ok_last, jnp.ones(win, y.dtype))
        Gk = jnp.where(last, G_last, G)
        b = (yw * row_ok) @ H - lam                   # (..., win)
        s_w = nnls_fista(Gk, b, x0=s_warm, n_iter=fista_iters)
        commit = jnp.where(k == n_win - 1, win, shift)
        s_commit = jnp.where(jnp.arange(win) < commit, s_w, 0.0)
        s_acc = jax.lax.dynamic_update_slice_in_dim(
            s_acc, jax.lax.dynamic_slice_in_dim(s_acc, t0, win, axis=-1)
            + s_commit, t0, axis=-1)
        contrib = s_commit @ Hc                       # (..., Lc)
        seg = jax.lax.dynamic_slice_in_dim(y_res, t0, Lc, axis=-1)
        y_res = jax.lax.dynamic_update_slice_in_dim(
            y_res, seg - contrib, t0, axis=-1)
        s_next = jnp.concatenate(
            [s_w[..., shift:], jnp.zeros(batch + (shift,), y.dtype)],
            axis=-1)
        return (y_res, s_acc, s_next), None

    sw0 = jnp.zeros(batch + (win,), y.dtype)
    (_, s, _), _ = jax.lax.scan(window, (y_res0, s0, sw0),
                                jnp.arange(n_win))
    s = s[..., :T]
    c = causal_conv(s, h)
    return c, s


def causal_conv(s: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """c[t] = sum_l h[l] * s[t - l], batched over leading dims of s."""
    s = jnp.asarray(s)
    h = jnp.asarray(h, s.dtype).reshape(-1)
    batch = s.shape[:-1]
    T = s.shape[-1]
    lhs = s.reshape(-1, 1, T)
    rhs = h[::-1].reshape(1, 1, -1)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[(h.shape[0] - 1, 0)])
    return out.reshape(batch + (T,))


def fit_exp2_to_kernel(h: jnp.ndarray, n_grid: int = 40
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fit (d, r) of a difference-of-exponentials to an arbitrary kernel by
    grid search on the normalized L2 error (reference 'kernel' model via
    ``create_kernel``/``dsKernel``; here the kernel routes through the
    exp2 solver after this projection)."""
    h = jnp.asarray(h, jnp.float32)
    L = h.shape[-1]
    t = jnp.arange(L, dtype=jnp.float32)
    ds = jnp.linspace(0.5, 0.995, n_grid)
    rs = jnp.linspace(0.01, 0.9, n_grid)
    dd, rr = jnp.meshgrid(ds, rs, indexing="ij")
    denom = jnp.maximum(dd - rr, 1e-4)
    basis = (dd[..., None] ** (t + 1) - rr[..., None] ** (t + 1)) \
        / denom[..., None]                          # (n, n, L)
    # optimal scale per candidate, then residual
    hb = jnp.einsum("ijl,l->ij", basis, h)
    bb = jnp.sum(basis * basis, axis=-1)
    scale = hb / jnp.maximum(bb, 1e-12)
    err = jnp.sum(h * h) - scale * hb
    err = jnp.where(dd > rr, err, jnp.inf)
    idx = jnp.argmin(err)
    return dd.reshape(-1)[idx], rr.reshape(-1)[idx]


def ar2_recurrence(s: jnp.ndarray, d: jnp.ndarray, r: jnp.ndarray
                   ) -> jnp.ndarray:
    """c from spikes by the AR(2) recurrence c_t = g1 c_{t-1} + g2 c_{t-2} + s_t
    (batched over leading dims; d/r broadcast over the batch)."""
    batch = s.shape[:-1]
    g1 = d + r
    g2 = -d * r

    def rec(carry, s_t):
        c1, c2 = carry
        c_t = g1 * c1 + g2 * c2 + s_t
        return (c_t, c1), c_t

    _, c_tfirst = jax.lax.scan(
        rec, (jnp.zeros(batch, s.dtype), jnp.zeros(batch, s.dtype)),
        jnp.moveaxis(s, -1, 0))
    return jnp.moveaxis(c_tfirst, 0, -1)


def _apply_smin_floor(s, d, r, floor):
    """Zero sub-floor spikes and rebuild c (AR(2) recurrence)."""
    s = jnp.where(s >= floor, s, 0.0)
    return ar2_recurrence(s, d, r), s


def _rss(y, c):
    return jnp.sum((y - c) ** 2, axis=-1)


def constrained_onnls(y: jnp.ndarray, d: jnp.ndarray, r: jnp.ndarray,
                      sn: jnp.ndarray, optimize_b: bool = True,
                      n_bisect: int = 12, win: int = 200, shift: int = 100,
                      fista_iters: int = 60):
    """Noise-constrained AR(2)/exp2 deconvolution: tune lambda so that
    RSS == sn^2 T (reference: ``constrained_oasisAR2.m:1-60`` updates
    lambda from the dual residual; RSS(lambda) is monotone nondecreasing,
    so we bisect lambda in [0, lam_max] — fully batched, fixed trips, each
    evaluation one windowed-NNLS solve).

    Returns (c, s, b, lam).
    """
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    T = y.shape[-1]
    thresh = sn * sn * T
    b = jnp.quantile(y, 0.15, axis=-1) if optimize_b else \
        jnp.zeros(batch, y.dtype)

    def solve(lam, b):
        c, s = onnls(y - b[..., None], d, r, win=win, shift=shift,
                     fista_iters=fista_iters, lam=lam)
        return c, s, _rss(y - b[..., None], c)

    # lam = 0 branch: if already above the noise budget, keep lam = 0
    c0, s0, rss0 = solve(jnp.zeros(batch, y.dtype), b)
    lam_hi = jnp.maximum(jnp.max(jnp.abs(y), axis=-1), 1.0) * 2.0

    def step(carry, _):
        lo, hi, b = carry
        mid = 0.5 * (lo + hi)
        c, _, rss = solve(mid, b)
        too_smooth = rss > thresh
        lo = jnp.where(too_smooth, lo, mid)
        hi = jnp.where(too_smooth, mid, hi)
        if optimize_b:
            b = jnp.mean(y - c, axis=-1)
        return (lo, hi, b), None

    (lo, hi, b), _ = jax.lax.scan(
        step, (jnp.zeros(batch, y.dtype), lam_hi, b), None, length=n_bisect)
    lam = lo
    c, s, _ = solve(lam, b)
    done0 = rss0 >= thresh
    c = jnp.where(done0[..., None], c0, c)
    s = jnp.where(done0[..., None], s0, s)
    lam = jnp.where(done0, 0.0, lam)
    return c, s, b, lam


def thresholded_onnls(y: jnp.ndarray, d: jnp.ndarray, r: jnp.ndarray,
                      sn: jnp.ndarray, optimize_b: bool = True,
                      thresh_factor: float = 1.0, p_noise: float = 0.9999,
                      n_search: int = 10, win: int = 200, shift: int = 100,
                      fista_iters: int = 60):
    """Hard-threshold (smin) AR(2) deconvolution (reference:
    ``thresholded_oasisAR2.m:79-140``): start from the statistically chosen
    smin (``choose_smin`` with the AR(2) kernel norm), then scale smin by
    bisection so the RSS approaches ``thresh_factor * sn^2 * T``.

    Returns (c, s, b, smin).
    """
    from cnmf_e_tpu.ops.ar import choose_smin, exp2ar

    y = jnp.asarray(y)
    batch = y.shape[:-1]
    T = y.shape[-1]
    thresh = thresh_factor * sn * sn * T
    g2 = exp2ar(jnp.broadcast_to(d, batch), jnp.broadcast_to(r, batch))
    smin0 = choose_smin(g2, sn, p_noise)
    b = jnp.quantile(y, 0.15, axis=-1) if optimize_b else \
        jnp.zeros(batch, y.dtype)

    # one unpenalized solve; the smin search floors + rebuilds (cheap)
    c_raw, s_raw = onnls(y - b[..., None], d, r, win=win, shift=shift,
                         fista_iters=fista_iters, lam=0.0)

    def rss_at(mult, b):
        c, s = _apply_smin_floor(s_raw, d, r, (mult * smin0)[..., None])
        return _rss(y - b[..., None], c), c, s

    def step(carry, _):
        lo, hi, b = carry
        mid = 0.5 * (lo + hi)
        rss, c, _ = rss_at(mid, b)
        too_sparse = rss > thresh
        lo = jnp.where(too_sparse, lo, mid)
        hi = jnp.where(too_sparse, mid, hi)
        if optimize_b:
            b = jnp.mean(y - c, axis=-1)
        return (lo, hi, b), None

    lo = jnp.full(batch, 0.25, y.dtype)
    hi = jnp.full(batch, 8.0, y.dtype)
    (lo, hi, b), _ = jax.lax.scan(step, (lo, hi, b), None, length=n_search)
    smin = lo * smin0
    c, s = _apply_smin_floor(s_raw, d, r, smin[..., None])
    return c, s, b, smin


def optimize_exp2(y: jnp.ndarray, d0: jnp.ndarray, r0: jnp.ndarray,
                  sn: Optional[jnp.ndarray] = None,
                  b: Optional[jnp.ndarray] = None, n_outer: int = 2,
                  n_golden: int = 10, win: int = 200, shift: int = 100,
                  fista_iters: int = 40, p_noise: float = 0.9999):
    """Per-trace (d, r) optimization for the exp2/AR(2) kernel — the role
    of ``update_kernel_exp2.m`` / ``update_tau.m`` and the g-update inside
    ``foopsi_oasisAR2.m``. EM-style alternation, batched over traces:

      E: spikes from a windowed-NNLS solve with the current kernel, floored
         at the noise-aware ``choose_smin`` level (an unpenalized solve
         would let the kernel search collapse to a delta kernel — RSS of
         the re-solve decreases monotonically as d -> 0);
      M: coordinate golden-section on (d, r) of the reconstruction RSS
         with the spike train HELD FIXED (and an optimal global amplitude
         rescale per candidate) — the same fix-the-spikes regression the
         reference's ``update_kernel_exp2`` does.

    Returns (d, r, c, s).
    """
    from cnmf_e_tpu.ops.ar import choose_smin, exp2ar

    y = jnp.asarray(y)
    batch = y.shape[:-1]
    if b is None:
        b = jnp.zeros(batch, y.dtype)
    yb = y - b[..., None]
    if sn is None:
        from cnmf_e_tpu.ops.noise import estimate_noise
        sn = estimate_noise(yb, "psd")
    phi = 0.6180339887498949

    def floor_spikes(s, d, r):
        smin = choose_smin(exp2ar(d, r), sn, p_noise)
        return jnp.where(s >= smin[..., None], s, 0.0)

    def rss_fixed_spikes(s_fix, d, r):
        d = jnp.maximum(d, r + 0.01)
        c = ar2_recurrence(s_fix, d, r)
        # optimal global amplitude per trace (kernel scale changes with d, r)
        num = jnp.sum(yb * c, axis=-1)
        den = jnp.maximum(jnp.sum(c * c, axis=-1), 1e-12)
        alpha = jnp.maximum(num / den, 0.0)
        return _rss(yb, alpha[..., None] * c)

    def golden(f, lo, hi, n):
        x1 = hi - phi * (hi - lo)
        x2 = lo + phi * (hi - lo)
        f1, f2 = f(x1), f(x2)

        def body(carry, _):
            lo, hi, x1, x2, f1, f2 = carry
            go_left = f1 < f2
            hi = jnp.where(go_left, x2, hi)
            lo = jnp.where(go_left, lo, x1)
            x1n = hi - phi * (hi - lo)
            x2n = lo + phi * (hi - lo)
            return (lo, hi, x1n, x2n, f(x1n), f(x2n)), None

        (lo, hi, *_), _ = jax.lax.scan(body, (lo, hi, x1, x2, f1, f2),
                                       None, length=n)
        return 0.5 * (lo + hi)

    d = jnp.broadcast_to(jnp.asarray(d0, y.dtype), batch)
    r = jnp.broadcast_to(jnp.asarray(r0, y.dtype), batch)
    for _ in range(n_outer):
        _, s = onnls(yb, d, r, win=win, shift=shift,
                     fista_iters=fista_iters, lam=0.0)
        s_fix = floor_spikes(s, d, r)
        d = golden(lambda dv: rss_fixed_spikes(s_fix, dv, r),
                   jnp.maximum(r + 0.02, 0.3 * jnp.ones_like(d)),
                   jnp.full(batch, 0.998, y.dtype), n_golden)
        r = golden(lambda rv: rss_fixed_spikes(s_fix, d, rv),
                   jnp.full(batch, 0.005, y.dtype),
                   jnp.minimum(d - 0.02, 0.95 * jnp.ones_like(r)), n_golden)
    c, s = onnls(yb, d, r, win=win, shift=shift, fista_iters=fista_iters,
                 lam=0.0)
    return d, r, c, s


def onnls_deconvolve(y: jnp.ndarray, g: jnp.ndarray, sn: jnp.ndarray,
                     params: DeconvParams):
    """AR(2)/exp2 deconvolution entry used by
    :func:`cnmf_e_tpu.ops.oasis.deconvolve`, dispatching the full method
    family: foopsi (lam fixed), constrained (lambda bisection to
    RSS = sn^2 T, ``constrained_oasisAR2.m``), thresholded (smin search,
    ``thresholded_oasisAR2.m``); ``optimize_g > 0`` additionally optimizes
    (d, r) per trace first (``update_kernel_exp2.m`` role)."""
    from cnmf_e_tpu.ops.ar import exp2ar
    from cnmf_e_tpu.ops.oasis import DeconvResult

    y = jnp.asarray(y)
    batch = y.shape[:-1]
    d, r = ar2exp(g)
    d = jnp.broadcast_to(d, batch)
    r = jnp.broadcast_to(r, batch)

    if params.optimize_g:
        b0 = jnp.quantile(y, 0.15, axis=-1) if params.optimize_b else \
            jnp.zeros(batch, y.dtype)
        d, r, _, _ = optimize_exp2(y, d, r, sn=sn, b=b0,
                                   n_outer=min(int(params.optimize_g), 3))
    g_out = exp2ar(d, r)

    if params.method == "constrained":
        c, s, b, lam = constrained_onnls(y, d, r, sn,
                                         optimize_b=params.optimize_b)
        return DeconvResult(c, s, b, g_out, lam,
                            jnp.zeros(batch, y.dtype))

    if params.method == "thresholded":
        c, s, b, smin = thresholded_onnls(
            y, d, r, sn, optimize_b=params.optimize_b,
            thresh_factor=params.thresh_factor, p_noise=params.p_noise)
        return DeconvResult(c, s, b, g_out,
                            jnp.zeros(batch, y.dtype), smin)

    # ---- foopsi: fixed lambda ---------------------------------------- #
    lam = params.lam
    b = jnp.quantile(y, 0.15, axis=-1) if params.optimize_b else \
        jnp.zeros(batch, y.dtype)
    c, s = onnls(y - b[..., None], d, r, lam=lam)
    if params.optimize_b:
        b = b + jnp.mean(y - b[..., None] - c, axis=-1)
        c, s = onnls(y - b[..., None], d, r, lam=lam)
    # spike-floor thresholding analogous to smin for AR(1)
    if params.smin != 0:
        if params.smin < 0:
            floor = (abs(params.smin) * sn)[..., None]
        else:
            floor = jnp.asarray(params.smin, y.dtype)
        c, s = _apply_smin_floor(s, d, r, floor)
    return DeconvResult(c, s, b, g_out,
                        jnp.broadcast_to(jnp.asarray(lam, y.dtype), batch),
                        jnp.broadcast_to(jnp.asarray(params.smin, y.dtype),
                                         batch))
