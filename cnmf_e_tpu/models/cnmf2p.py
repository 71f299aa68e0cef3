"""Vanilla (2-photon) CNMF pipeline — the reference's legacy path.

Reference layer L3 (SURVEY.md): ``preprocess_data.m`` (NaN interpolation,
saturation detection, noise/AR estimates), ``initialize_components.m`` +
``greedyROI.m`` (gaussian-blob greedy init + HALS refine),
``update_spatial_components.m`` (per-pixel noise-constrained LARS/BPDN),
``update_temporal_components.m`` (block-coordinate descent with
constrained-foopsi), ``merge_components.m``. Driven by ``demo_script.m`` on
``demoMovie.tif`` (BASELINE config 1).

Batched re-design notes:
  * greedyROI peels in conflict-free seed rounds like the 1p initializer,
    with plain gaussian matched filtering and windowed rank-1 refinement
  * the per-pixel LARS lasso path becomes a batched nonneg-lasso solved by
    FISTA with a per-pixel lambda bisection targeting the noise budget
    ||y - Cw||^2 <= sn^2 T (same stopping criterion as
    ``lars_regression_noise.m``, solved for all pixels at once as batched matmuls)
  * temporal update = HALS sweep + batched constrained-foopsi
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import CNMFEParams, DeconvParams, MergeParams
from cnmf_e_tpu.models.merge import merge_neurons
from cnmf_e_tpu.models.state import CNMFEState, compact, empty_state
from cnmf_e_tpu.ops.filters import filter_movie, gaussian_psf
from cnmf_e_tpu.ops.hals import hals_temporal
from cnmf_e_tpu.ops.lowrank import nmf_hals
from cnmf_e_tpu.ops.noise import noise_psd, noise_psd_frames
from cnmf_e_tpu.ops.oasis import deconvolve


# --------------------------------------------------------------------- #
# preprocessing (preprocess_data.m:37-60)
# --------------------------------------------------------------------- #

def interp_missing_data(Y: jnp.ndarray) -> jnp.ndarray:
    """Fill NaNs along the time axis by nearest-valid forward/backward fill
    average (reference: ``interp_missing_data.m`` does 1-D interpolation
    per pixel)."""
    T = Y.shape[0]
    good = jnp.isfinite(Y)
    Yz = jnp.where(good, Y, 0.0)

    def scan_fill(carry, x):
        val, has = carry
        v, g = x
        val = jnp.where(g, v, val)
        has = has | g
        return (val, has), (val, has)

    xs = (Yz, good)
    (_, _), (ffill, fhas) = jax.lax.scan(
        scan_fill, (jnp.zeros_like(Y[0]), jnp.zeros_like(good[0])), xs)
    (_, _), (bfill, bhas) = jax.lax.scan(
        scan_fill, (jnp.zeros_like(Y[0]), jnp.zeros_like(good[0])),
        jax.tree.map(lambda a: a[::-1], xs))
    bfill, bhas = bfill[::-1], bhas[::-1]
    both = fhas & bhas
    fill = jnp.where(both, 0.5 * (ffill + bfill),
                     jnp.where(fhas, ffill, bfill))
    return jnp.where(good, Y, fill)


def find_unsaturated_pixels(Y: jnp.ndarray, frac: float = 0.005
                            ) -> jnp.ndarray:
    """Mask of pixels NOT pinned at the sensor ceiling (reference:
    ``find_unsaturatedPixels.m``): a pixel is saturated when more than
    ``frac`` of its samples equal the global max."""
    vmax = jnp.max(Y)
    pinned = jnp.mean((Y >= vmax).astype(jnp.float32), axis=0)
    return pinned <= frac


def preprocess_data(Y: jnp.ndarray) -> Tuple[jnp.ndarray, dict]:
    """NaN interpolation + saturation mask + per-pixel noise (P struct)."""
    Y = interp_missing_data(Y)
    unsat = find_unsaturated_pixels(Y)
    sn = noise_psd_frames(Y)
    return Y, {"sn_pix": sn, "unsaturated": unsat}


# --------------------------------------------------------------------- #
# classic greedy initialization (greedyROI.m)
# --------------------------------------------------------------------- #

@functools.partial(jax.jit, static_argnames=("gSiz", "gSig", "n_iter"))
def _refine_boxes(Y: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
                  gSiz: int, gSig: float, n_iter: int = 5):
    """Windowed rank-1 (a, c) refinement around each seed
    (greedyROI.m shape-tuning iterations)."""
    B = 2 * gSiz + 1
    T = Y.shape[0]
    Yp = jnp.pad(Y, ((0, 0), (gSiz, gSiz), (gSiz, gSiz)))
    yy, xx = np.mgrid[0:B, 0:B] - gSiz
    gauss = jnp.asarray(np.exp(-(yy**2 + xx**2) / (2.0 * gSig**2)),
                        jnp.float32)

    def one(r, c):
        box = jax.lax.dynamic_slice(Yp, (0, r, c), (T, B, B))
        box = box - jnp.median(box, axis=0, keepdims=True)
        boxf = box.reshape(T, B * B)
        a = gauss.reshape(-1)
        ccur = jnp.zeros(T, Y.dtype)
        def body(_, ac):
            a, ccur = ac
            ccur = (boxf @ a) / jnp.maximum(a @ a, 1e-12)
            ccur = jnp.maximum(ccur, 0.0)
            a = jnp.maximum(boxf.T @ ccur, 0.0) / jnp.maximum(ccur @ ccur,
                                                              1e-12)
            a = a * (gauss.reshape(-1) > np.exp(-2.0))  # confine support
            return (a, ccur)
        a, ccur = jax.lax.fori_loop(0, n_iter, body, (a, ccur))
        return a.reshape(B, B), ccur

    return jax.vmap(one)(rows, cols)


def greedy_roi(Y: jnp.ndarray, K: int, gSig: float = 5.0,
               gSiz: Optional[int] = None, n_iter: int = 5,
               seeds_per_round: int = 16
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Classic greedy init: repeatedly take the brightest gaussian-filtered
    energy peaks, refine rank-1 components in a window, subtract.

    Returns (A (K', H, W), C (K', T), centers (K', 2)); K' <= K.
    """
    T, H, W = Y.shape
    gSiz = gSiz or int(np.ceil(2 * gSig + 1))
    psf = gaussian_psf(gSig, center_psf=False)
    Yw = Y - jnp.median(Y, axis=0, keepdims=True)

    A_list, C_list, ctr_list = [], [], []
    found = 0
    while found < K:
        n = min(seeds_per_round, K - found)
        HY = filter_movie(Yw, psf)
        energy = jnp.sum(jnp.maximum(HY, 0.0) ** 2, axis=0)
        # top-n non-conflicting local maxima
        wnd = max(3, gSiz // 2) | 1
        vmax = jax.lax.reduce_window(
            energy, -jnp.inf, jax.lax.max, (wnd, wnd), (1, 1),
            [(wnd // 2, wnd // 2)] * 2)
        is_max = (energy >= vmax)
        score = jnp.where(is_max, energy, -jnp.inf).reshape(-1)
        vals, idx = jax.lax.top_k(score, n)
        ok = np.asarray(vals > 0)
        if not ok.any():
            break
        rows, cols = np.asarray(idx // W), np.asarray(idx % W)
        rows, cols = rows[ok], cols[ok]
        a_box, c = _refine_boxes(Yw, jnp.asarray(rows), jnp.asarray(cols),
                                 gSiz, gSig, n_iter)
        # scatter boxes to full FOV and subtract
        n_acc = len(rows)
        A_full = np.zeros((n_acc, H, W), np.float32)
        ab = np.asarray(a_box)
        for i, (r, c0) in enumerate(zip(rows, cols)):
            r0, r1 = max(r - gSiz, 0), min(r + gSiz + 1, H)
            c0_, c1 = max(c0 - gSiz, 0), min(c0 + gSiz + 1, W)
            A_full[i, r0:r1, c0_:c1] = ab[i][r0 - (r - gSiz):r1 - (r - gSiz),
                                             c0_ - (c0 - gSiz):c1 - (c0 - gSiz)]
        A_full_j = jnp.asarray(A_full)
        Yw = Yw - jnp.einsum("khw,kt->thw", A_full_j, c)
        A_list.append(A_full_j)
        C_list.append(c)
        ctr_list.append(np.stack([rows, cols], axis=1))
        found += n_acc

    if not A_list:
        return (jnp.zeros((0, H, W)), jnp.zeros((0, T)), np.zeros((0, 2)))
    return (jnp.concatenate(A_list), jnp.concatenate(C_list),
            np.concatenate(ctr_list))


# --------------------------------------------------------------------- #
# noise-constrained spatial lasso (update_spatial_components.m + LARS)
# --------------------------------------------------------------------- #

@functools.partial(jax.jit, static_argnames=("n_bisect", "n_fista"))
def lasso_noise_constrained(C: jnp.ndarray, Y: jnp.ndarray,
                            sn: jnp.ndarray, mask: Optional[jnp.ndarray],
                            n_bisect: int = 12, n_fista: int = 60
                            ) -> jnp.ndarray:
    """Per-pixel nonneg lasso: min ||a||_1 s.t. ||y - C^T a||^2 <= sn^2 T.

    C: (K, T) regressors; Y: (d, T); sn: (d,). Batched over all pixels:
    bisection on lambda (RSS is monotone in lambda) around FISTA solves of
    min 1/2||y - C^T a||^2 + lam ||a||_1, a >= 0. Replaces the serial
    per-pixel LARS path of ``lars_regression_noise.m``.
    """
    K, T = C.shape
    d = Y.shape[0]
    G = (C @ C.T).astype(Y.dtype)                   # (K, K)
    B = (Y @ C.T)                                   # (d, K)
    if mask is not None:
        B = jnp.where(mask, B, 0.0)
    L = jnp.maximum(jnp.max(jnp.sum(jnp.abs(G), axis=-1)), 1e-12)
    step = 1.0 / L
    budget = sn * sn * T                            # (d,)

    def fista(lam):
        x = jnp.zeros_like(B)
        z = x
        t = jnp.asarray(1.0, Y.dtype)

        def body(carry, _):
            x, z, t = carry
            grad = z @ G - B
            x_new = jnp.maximum(z - step * (grad + lam[:, None]), 0.0)
            if mask is not None:
                x_new = jnp.where(mask, x_new, 0.0)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            z = x_new + ((t - 1.0) / t_new) * (x_new - x)
            return (x_new, z, t_new), None

        (x, _, _), _ = jax.lax.scan(body, (x, z, t), None, length=n_fista)
        return x

    def rss_of(x):
        # ||y||^2 - 2 x.B + x G x^T, per pixel
        ynorm = jnp.sum(Y * Y, axis=-1)
        return (ynorm - 2.0 * jnp.sum(x * B, axis=-1)
                + jnp.einsum("dk,kl,dl->d", x, G, x))

    lam_hi0 = jnp.max(jnp.abs(B), axis=-1) + 1e-6   # lam >= max|B| => a = 0

    def bisect(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        x = fista(mid)
        over = rss_of(x) > budget                   # lam too big
        hi = jnp.where(over, mid, hi)
        lo = jnp.where(over, lo, mid)
        return (lo, hi), None

    lo0 = jnp.zeros(d, Y.dtype)
    (lo, hi), _ = jax.lax.scan(bisect, (lo0, lam_hi0), None,
                               length=n_bisect)
    return fista(lo)


# --------------------------------------------------------------------- #
# full pipeline
# --------------------------------------------------------------------- #

class CNMF:
    """Vanilla CNMF for 2p data (the reference's ``demo_script.m`` flow)."""

    def __init__(self, K: int = 30, gSig: float = 5.0, nb: int = 2,
                 merge_thr: float = 0.8,
                 deconv: Optional[DeconvParams] = None,
                 spatial_method: str = "lasso"):
        self.K = K
        self.gSig = gSig
        self.nb = nb
        self.merge_thr = merge_thr
        self.deconv = deconv or DeconvParams(method="constrained",
                                             model="ar1")
        self.spatial_method = spatial_method
        self.state: Optional[CNMFEState] = None
        self.b: Optional[jnp.ndarray] = None   # (nb, H, W)
        self.f: Optional[jnp.ndarray] = None   # (nb, T)

    def fit(self, Y, n_outer: int = 2, verbose: bool = False) -> CNMFEState:
        Y = jnp.asarray(Y, jnp.float32)
        T, H, W = Y.shape
        Y, P = preprocess_data(Y)
        sn_pix = P["sn_pix"]

        # ---- init: greedyROI + rank-nb background + HALS refine ------- #
        A0, C0, centers = greedy_roi(Y, self.K, gSig=self.gSig)
        K_found = A0.shape[0]
        resid = Y - jnp.einsum("khw,kt->thw", A0, C0)
        bW, bH = nmf_hals(jnp.maximum(resid.reshape(T, -1).T, 0.0), self.nb,
                          n_iter=30)
        self.b = bW.T.reshape(self.nb, H, W)
        self.f = bH

        K_cap = int(2 ** np.ceil(np.log2(max(K_found, 4))))
        state = empty_state(K_cap, H, W, T)
        state = state.replace(
            A=state.A.at[:K_found].set(A0),
            C=state.C.at[:K_found].set(jnp.maximum(C0, 0.0)),
            C_raw=state.C_raw.at[:K_found].set(C0),
            active=state.active.at[:K_found].set(True))
        if verbose:
            print(f"[cnmf] init: {K_found} components")

        params = CNMFEParams(merge=MergeParams(merge_thr=self.merge_thr))

        for it in range(n_outer):
            # ---- spatial: noise-constrained lasso on [C; f] ----------- #
            regs = jnp.concatenate([state.masked_C(), self.f], axis=0)
            Yd = Y.reshape(T, -1).T
            if self.spatial_method == "lasso":
                coef = lasso_noise_constrained(
                    regs, Yd, sn_pix.reshape(-1), None)
            else:
                from cnmf_e_tpu.ops.nnls import nnls_pixels
                coef = nnls_pixels(regs, Yd)
            A_new = coef[:, :state.K_max].T.reshape(state.K_max, H, W)
            self.b = coef[:, state.K_max:].T.reshape(self.nb, H, W)
            state = state.replace(A=A_new * state.active[:, None, None])

            # ---- temporal: HALS + constrained foopsi ------------------ #
            Ysig = Y - jnp.einsum("rhw,rt->thw", self.b, self.f)
            Ad = state.masked_A().reshape(state.K_max, -1).T
            C_raw, _ = hals_temporal(Ysig.reshape(T, -1).T, Ad,
                                     state.masked_C(), n_iter=3,
                                     active=state.active)
            res = deconvolve(C_raw, self.deconv)
            state = state.replace(
                C=res.c * state.active[:, None],
                C_raw=(C_raw - res.b[:, None]) * state.active[:, None],
                S=res.s * state.active[:, None],
                g=res.g[:, :state.g.shape[1]])

            # ---- background refresh + merge --------------------------- #
            resid = Y - jnp.einsum("khw,kt->thw", state.masked_A(),
                                   state.masked_C())
            bW, bH = nmf_hals(jnp.maximum(resid.reshape(T, -1).T, 0.0),
                              self.nb, n_iter=20)
            self.b = bW.T.reshape(self.nb, H, W)
            self.f = bH

            state, nm = merge_neurons(state, params, "dist_corr")
            if verbose:
                print(f"[cnmf] iter {it}: merged {nm}, "
                      f"{int(state.n_active())} components")

        self.state = compact(state)
        return self.state
