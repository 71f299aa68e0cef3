"""Per-substage timing of one initialize_greedy round on the device.

Decomposes the CURRENT fused round (models/initialize.py::_make_init_round)
into its jitted sub-programs and times each with forced completion, to find
where the per-round wall time goes (VERDICT r2 weak #2: init + residual
pick = 60% of the end-to-end pipeline).

Each substage is dispatched separately here (so the sum overcounts the
fused round by one dispatch per extra program), but relative weights
identify the dominant compute.
"""

import sys

from cnmf_e_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    H = W = 256
    T = 2000
    from cnmf_e_tpu.utils.simulate import simulate_movie
    from cnmf_e_tpu.config import CNMFEParams
    from cnmf_e_tpu.models.initialize import (
        _local_maxima_topk, _mark_searched, _place_footprints_masked,
        _search_image, _weak_signal_test, extract_ac_batch)
    from cnmf_e_tpu.models.state import empty_state
    from cnmf_e_tpu.ops.filters import filter_movie, gaussian_psf
    from cnmf_e_tpu.ops.corr import correlation_image
    from cnmf_e_tpu.ops.noise import noise_psd_frames
    from cnmf_e_tpu.ops.oasis import deconvolve
    from cnmf_e_tpu.ops.stats import fast_median
    from cnmf_e_tpu.utils.profiling import StageTimer

    gt = simulate_movie(seed=7, H=H, W=W, T=T, K=100, gSig=3.0, sn=0.08,
                        bg_strength=0.8, min_dist=7.0, spike_rate=0.03)
    p = CNMFEParams.preset_1p()
    ip = p.init
    gSiz = int(ip.gSiz)
    n_seeds = 32
    psf = gaussian_psf(ip.gSig, ip.center_psf)
    tm = StageTimer()

    Y_work = jnp.asarray(gt.Y)
    state = empty_state(ip.max_neurons, H, W, T)
    searched = jnp.zeros((H, W), bool)
    Ysig = None
    for rnd_i in range(3):
        rnd = f"r{rnd_i}:"
        ref = []
        with tm.stage(rnd + "filter_movie", ref):
            HY = filter_movie(Y_work, psf)
            ref.append(HY)
        with tm.stage(rnd + "fast_median_sub", ref):
            HY = HY - fast_median(HY, axis=0, keepdims=True)
            ref.append(HY)
        if Ysig is None:
            with tm.stage(rnd + "noise_psd(HY)", ref):
                Ysig = noise_psd_frames(HY)
                ref.append(Ysig)
        with tm.stage(rnd + "search_image", ref):
            cn, pnr, v = _search_image(HY, Ysig, searched,
                                       ip.min_corr, ip.min_pnr)
            ref.append(v)
        with tm.stage(rnd + "corr_image_only", ref):
            cn2 = correlation_image(
                jnp.where(HY >= 3.0 * Ysig[None], HY, 0.0), center=False)
            ref.append(cn2)
        with tm.stage(rnd + "local_maxima", ref):
            rows, cols, valid = _local_maxima_topk(
                v, n_seeds, ip.min_corr * ip.min_pnr, nms_dist=gSiz)
            ref.append(rows)
        with tm.stage(rnd + "weak_signal", ref):
            valid = valid & _weak_signal_test(HY, rows, cols)
            ref.append(valid)
        with tm.stage(rnd + "extract_ac", ref):
            res = extract_ac_batch(HY, Y_work, rows, cols, gSiz,
                                   min_pixel=max(ip.min_pixel, 5),
                                   corr_thr=ip.corr_pixel_thr)
            ref.append(res.a)
        with tm.stage(rnd + "deconvolve", ref):
            dres = deconvolve(res.c_raw, p.temporal.deconv, sn=res.sn)
            ref.append(dres.c)
        ok = res.ok & valid
        rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
        slot = rank
        take = ok & (slot < state.K_max)
        slots = jnp.where(take, slot, state.K_max)
        with tm.stage(rnd + "place_footprints", ref):
            A_new, searched, full_A = _place_footprints_masked(
                state.A, searched, res.a, rows, cols, slots, take, gSiz)
            ref.append(A_new)
        with tm.stage(rnd + "peel_einsum", ref):
            c_eff = jnp.where(take[:, None], dres.c, 0.0)
            Y_work = Y_work - jnp.einsum("khw,kt->thw", full_A, c_eff)
            ref.append(Y_work)
        with tm.stage(rnd + "mark_searched", ref):
            searched = _mark_searched(searched, rows, cols, valid)
            ref.append(searched)
        print(f"round {rnd_i}: {int(np.asarray(take).sum())} taken",
              flush=True)

    print(tm.report(), flush=True)


if __name__ == "__main__":
    main()
