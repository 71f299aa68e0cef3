"""Reference-semantics oracle: serial greedy Corr+PNR initialization.

ORACLE (test-only, deliberately slow): a literal float64 numpy
transliteration of the reference's serial one-neuron-at-a-time peel —
``endoscope/greedyROI_endoscope.m:211-451`` (seed search with median +
order filters, weak-signal test, local HY/PNR/Cn refresh after each peel)
with ``extract_ac.m:19-95`` (correlation-masked trace, background-median
regressor, 3-column LS, circular + connectivity constraints) — compared
against the batched redesign ``models/initialize.py``.

The redesign peels in conflict-free ROUNDS instead of one neuron at a
time (documented deviation, SURVEY.md section 7 "hard parts"), so parity
is asserted at the F1 / IoU / trace-correlation level on a movie where
the reference semantics find all planted neurons — the validation mode
VERDICT r2 (missing #1) asked for.

Oracle simplifications (noted inline): the trace-baseline branch uses the
sub-median mean (the reference picks between a histogram fit and
``remove_baseline`` by comparing noise estimates, ``extract_ac.m:87-95``
— a scalar offset that does not move footprints or trace shapes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi

from cnmf_e_tpu.config import CNMFEParams, InitParams
from cnmf_e_tpu.models.initialize import initialize_greedy
from cnmf_e_tpu.ops.filters import gaussian_psf
from cnmf_e_tpu.utils.metrics import detection_f1, trace_corr
from cnmf_e_tpu.utils.simulate import simulate_movie


# --------------------------------------------------------------------- #
# numpy transliterations
# --------------------------------------------------------------------- #

def getsn_oracle(y):
    """GetSn.m:33-45 with MATLAB pwelch defaults (hamming, 8 segments,
    50% overlap, nfft = max(256, 2^nextpow2(seg))), logmexp method."""
    y = np.asarray(y, np.float64)
    T = y.shape[-1]
    seg = min(max(int(T // 4.5), 16), T)
    step = max(seg // 2, 1)
    starts = np.arange(0, T - seg + 1, step)
    k = np.arange(seg)
    win = 0.54 - 0.46 * np.cos(2 * np.pi * k / (seg - 1))
    scale = 1.0 / np.sum(win**2)
    nfft = max(256, int(2 ** np.ceil(np.log2(seg))))
    psds = []
    for s in starts:
        spec = np.fft.rfft(y[..., s:s + seg] * win, n=nfft, axis=-1)
        p = np.abs(spec) ** 2 * scale
        p[..., 1:-1] *= 2.0
        psds.append(p)
    psd = np.mean(psds, axis=0)
    ff = np.fft.rfftfreq(nfft, 1.0)
    band = (ff >= 0.25) & (ff <= 0.5)
    return np.sqrt(np.exp(np.mean(np.log(psd[..., band] / 2 + 1e-30),
                                  axis=-1)))


def corr_image_oracle(HY, H, W):
    """correlation_image.m:38-77 — mean correlation with the 8
    neighbors at distance in [1, 2)."""
    X = HY.reshape(H * W, -1).astype(np.float64)
    X = X - X.mean(axis=1, keepdims=True)
    nrm = np.sqrt((X * X).mean(axis=1, keepdims=True))
    X = X / np.maximum(nrm, 1e-12)
    img = X.reshape(H, W, -1)
    acc = np.zeros((H, W))
    cnt = np.zeros((H, W))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ys = slice(max(dy, 0), H + min(dy, 0))
            xs = slice(max(dx, 0), W + min(dx, 0))
            ys2 = slice(max(-dy, 0), H + min(-dy, 0))
            xs2 = slice(max(-dx, 0), W + min(-dx, 0))
            acc[ys2, xs2] += (img[ys, xs] * img[ys2, xs2]).mean(axis=-1)
            cnt[ys2, xs2] += 1
    return acc / np.maximum(cnt, 1)


def circular_constraints_oracle(img):
    """circular_constraints.m:30-41 on the nonzero bounding box."""
    nz = np.argwhere(img > 0)
    if len(nz) == 0:
        return img
    (rmin, cmin), (rmax, cmax) = nz.min(axis=0), nz.max(axis=0)
    if rmax - rmin < 1 or cmax - cmin < 1:
        return img
    sub = img[rmin:rmax + 1, cmin:cmax + 1].copy()
    nr, nc = sub.shape
    ind = np.unravel_index(np.argmax(sub), sub.shape)
    y0, x0 = ind
    fy, fx = np.gradient(sub)
    x, y = np.meshgrid(np.arange(nc), np.arange(nr))
    vmax = sub.max()
    kill = ((fx * (x0 - x) + fy * (y0 - y)) < 0) & (sub < vmax / 3)
    sub[kill] = 0
    lbl, _ = ndi.label(sub > 0, structure=np.array([[0, 1, 0],
                                                    [1, 1, 1],
                                                    [0, 1, 0]]))
    keep = ndi.binary_dilation(lbl == lbl[y0, x0],
                               structure=np.ones((3, 3)))
    sub[~keep] = 0
    sub = ndi.median_filter(sub, size=3, mode='constant')
    out = img.copy()
    out[rmin:rmax + 1, cmin:cmax + 1] = sub
    return out


def connectivity_constraint_oracle(img, thr=0.01, sz=5):
    """connectivity_constraint.m:12-21 — grey open, threshold, keep the
    component containing the peak."""
    ind_max = np.unravel_index(np.argmax(img), img.shape)
    opened = ndi.grey_opening(img, size=(sz, sz), mode='constant')
    lbl, _ = ndi.label(opened > img.max() * thr,
                       structure=np.array([[0, 1, 0], [1, 1, 1],
                                           [0, 1, 0]]))
    out = img.copy()
    out[lbl != lbl[ind_max]] = 0
    return out


def extract_ac_oracle(HY_box, Y_box, ind_ctr, nr, nc):
    """extract_ac.m:19-95 (float64). Returns (ai, ci, ok)."""
    y0 = HY_box[ind_ctr]
    y0c = y0 - y0.mean()
    Xc = HY_box - HY_box.mean(axis=1, keepdims=True)
    denom = np.linalg.norm(Xc, axis=1) * max(np.linalg.norm(y0c), 1e-12)
    with np.errstate(invalid="ignore", divide="ignore"):
        tmp_corr = (Xc @ y0c) / np.where(denom > 0, denom, np.nan)
    data = HY_box[tmp_corr > 0.9]
    if len(data) == 0:
        return None, None, False
    ci = data.mean(axis=0)
    if np.linalg.norm(ci) == 0:
        return None, None, False
    bg_rows = Y_box[np.nan_to_num(tmp_corr) < 0.3]
    y_bg = (np.median(bg_rows, axis=0) if len(bg_rows)
            else np.zeros_like(ci))
    T = len(ci)
    X = np.stack([np.ones(T), y_bg, ci], axis=1)
    coef = np.linalg.lstsq(X, Y_box.T, rcond=None)[0]
    ai = np.maximum(coef[2], 0.0).reshape(nr, nc)
    ai = circular_constraints_oracle(ai)
    ai = connectivity_constraint_oracle(ai)
    if np.sum(ai > 0) < 5:
        return None, None, False
    # baseline (simplified: sub-median mean; see module docstring)
    med = np.median(ci)
    below = ci < med
    if below.any():
        ci = ci - ci[below].mean()
    ok = np.linalg.norm(ai) > 0
    return ai, ci, ok


def greedy_init_oracle(Y, gSig, gSiz, min_corr, min_pnr, K, sig=3.0):
    """greedyROI_endoscope.m:104-451 (no-deconv, serial peel, local
    refresh; float64)."""
    T, H, W = Y.shape
    d = H * W
    Yf = Y.reshape(T, d).T.astype(np.float64).copy()     # (d, T)
    psf = gaussian_psf(gSig, center_psf=True).astype(np.float64)

    def filt(flat):
        img = flat.T.reshape(-1, H, W)
        out = np.stack([ndi.correlate(f, psf, mode="nearest")
                        for f in img])
        return out.reshape(-1, d).T

    HY = filt(Yf)
    HY -= np.median(HY, axis=1, keepdims=True)
    Ysig = getsn_oracle(HY)

    PNR = HY.max(axis=1) / Ysig
    PNR[PNR < min_pnr] = 0
    HY_thr = HY.copy()
    HY_thr[HY_thr < Ysig[:, None] * sig] = 0
    Cn = corr_image_oracle(HY_thr, H, W).reshape(-1)
    Cn[np.isnan(Cn) | (Cn < min_corr)] = 0
    v_search = (Cn * PNR).reshape(H, W)
    ind_search = np.zeros(d, bool)
    min_v = min_corr * min_pnr
    jjg, iig = np.mgrid[1:H + 1, 1:W + 1]
    pixel_v = (iig * 10 + jjg) * 1e-10

    A_out, C_out = [], []
    tmp_d = max(3, round(gSiz / 4))
    while len(A_out) < K:
        v = ndi.median_filter(v_search, size=3, mode="constant") + pixel_v
        v.reshape(-1)[ind_search] = 0
        vmax = ndi.maximum_filter(v, size=tmp_d, mode="constant")
        ind_search[v.reshape(-1) < min_v] = True
        local = np.flatnonzero((v.reshape(-1) == vmax.reshape(-1))
                               & (vmax.reshape(-1) > 0))
        if len(local) == 0:
            break
        local = local[np.argsort(-v.reshape(-1)[local])]
        peeled_any = False
        for p in local:
            ind_search[p] = True
            if v.reshape(-1)[p] < min_v:
                continue
            r, c = divmod(p, W)
            y0 = HY[p]
            dy0 = np.diff(y0)
            if dy0.max() < 3 * dy0.std():
                continue
            rs = slice(max(0, r - gSiz), min(H, r + gSiz + 1))
            cs = slice(max(0, c - gSiz), min(W, c + gSiz + 1))
            rr, cc = np.mgrid[rs, cs]
            box = (rr * W + cc).reshape(-1)
            nr, nc = rr.shape
            ind_ctr = np.flatnonzero(box == p)[0]
            ai, ci, ok = extract_ac_oracle(HY[box], Yf[box], ind_ctr,
                                           nr, nc)
            if not ok:
                continue
            # accept + peel (greedyROI_endoscope.m:375-407)
            afull = np.zeros(d)
            afull[box] = ai.reshape(-1)
            A_out.append(afull)
            C_out.append(ci)
            ind_search[box[ai.reshape(-1) > ai.max() * 0.5]] = True
            Yf[box] -= ai.reshape(-1)[:, None] * ci[None]
            rs2 = slice(max(0, r - 2 * gSiz), min(H, r + 2 * gSiz + 1))
            cs2 = slice(max(0, c - 2 * gSiz), min(W, c + 2 * gSiz + 1))
            rr2, cc2 = np.mgrid[rs2, cs2]
            box2 = (rr2 * W + cc2).reshape(-1)
            nr2, nc2 = rr2.shape
            Hai = ndi.correlate(afull.reshape(H, W)[rs2, cs2], psf,
                                mode="nearest")
            HY[box2] -= Hai.reshape(-1)[:, None] * ci[None]
            # local PNR / Cn / v refresh
            pnr_box = HY[box2].max(axis=1) / Ysig[box2]
            pnr_box[np.isnan(pnr_box) | (pnr_box < min_pnr)] = 0
            PNR[box2] = pnr_box
            thr_box = HY[box2].copy()
            thr_box[thr_box < Ysig[box2][:, None] * sig] = 0
            cn_box = corr_image_oracle(thr_box, nr2, nc2).reshape(-1)
            cn_box[np.isnan(cn_box) | (cn_box < min_corr)] = 0
            Cn[box2] = cn_box
            v_search.reshape(-1)[box2] = Cn[box2] * PNR[box2]
            v_search.reshape(-1)[ind_search] = 0
            peeled_any = True
            if len(A_out) >= K:
                break
        if not peeled_any:
            break
    A = np.stack(A_out).reshape(-1, H, W) if A_out else np.zeros((0, H, W))
    C = np.stack(C_out) if C_out else np.zeros((0, T))
    return A, C


# --------------------------------------------------------------------- #
# parity test
# --------------------------------------------------------------------- #

@pytest.mark.slow
def test_batched_init_matches_serial_reference_oracle():
    """On a movie where the serial reference semantics find all planted
    neurons, the batched init must find the same set (F1), with
    overlapping footprints (IoU) and matching traces."""
    gt = simulate_movie(seed=11, H=48, W=48, T=300, K=6, gSig=2.5,
                        sn=0.06, bg_strength=0.4, min_dist=13.0,
                        spike_rate=0.05)
    gSig, gSiz = 2.5, 8
    min_corr, min_pnr = 0.8, 8.0

    A_ora, C_ora = greedy_init_oracle(gt.Y.astype(np.float64), gSig, gSiz,
                                      min_corr, min_pnr, K=12)
    assert len(A_ora) >= 5, f"oracle found only {len(A_ora)}"

    params = CNMFEParams(
        init=InitParams(gSig=gSig, gSiz=gSiz, min_corr=min_corr,
                        min_pnr=min_pnr, max_neurons=12,
                        seeds_per_round=8, max_rounds=6,
                        deconv_at_init=False))
    state, _ = initialize_greedy(jnp.asarray(gt.Y), params)
    n = int(state.n_active())
    A_est = np.asarray(state.masked_A())[:n]
    C_est = np.asarray(state.C_raw)[:n]

    # same neuron set as the serial oracle
    f1 = detection_f1(A_est, A_ora, iou_thr=0.3)
    assert f1["f1"] >= 0.85, f1
    matched_iou = [f1["iou"][i, j] for i, j in f1["matches"]]
    assert np.mean(matched_iou) >= 0.55, matched_iou
    corrs = trace_corr(C_est, C_ora, f1["matches"])
    assert np.median(corrs) > 0.95, corrs
