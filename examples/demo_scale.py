"""Scale demonstration: large-FOV, long-recording streaming run on the GPU.

A scaled instance of BASELINE config 5 (synthetic 512x512, thousands of
frames, hundreds of neurons) through the out-of-core streaming pipeline.
Writes metrics + stage timings to stdout (captured into SCALE.md by the
driver run).
"""

import json
import sys
import time

import numpy as np


def main(H=512, W=512, T=10000, K=400, block=1000):
    from cnmf_e_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams,
                                   InitParams, MergeParams)
    from cnmf_e_tpu.io.store import MovieStore, distribute_movie
    from cnmf_e_tpu.models.streaming import fit_streaming
    from cnmf_e_tpu.utils.metrics import detection_f1, trace_corr
    from cnmf_e_tpu.utils.simulate import simulate_movie
    import os
    import tempfile

    t0 = time.time()
    work = tempfile.mkdtemp(prefix="cnmfe_scale_")
    print(f"[scale] generating {H}x{W}x{T} movie with {K} neurons...",
          flush=True)
    gt = simulate_movie(seed=99, H=H, W=W, T=T, K=K, gSig=3.0, sn=0.08,
                        bg_strength=0.8, min_dist=9.0, spike_rate=0.02)
    src = os.path.join(work, "movie.npy")
    np.save(src, gt.Y)
    Y_shape = gt.Y.shape
    A_true, C_true = gt.A, gt.C
    del gt
    store = distribute_movie(src, os.path.join(work, "store"),
                             frames_per_block=block)
    t_gen = time.time() - t0
    print(f"[scale] movie on disk ({t_gen:.0f}s); starting pipeline",
          flush=True)

    t1 = time.time()
    params = CNMFEParams(
        init=InitParams(gSig=3.0, gSiz=10, min_corr=0.8, min_pnr=8.0,
                        max_neurons=512, seeds_per_round=64, max_rounds=10),
        background=BackgroundParams(model="ring", ring_radius=14, ssub=2),
        merge=MergeParams(dmin=5.0),
    )
    state = fit_streaming(store, params, n_outer=2,
                          init_budget_frames=3000, verbose=True)
    t_fit = time.time() - t1

    n = int(np.asarray(state.active).sum())
    A_est = np.asarray(state.A)[:n]
    C_est = np.asarray(state.C)[:n]
    f1 = detection_f1(A_est, A_true)
    corrs = trace_corr(C_est, C_true, f1["matches"])
    pixel_frames = Y_shape[0] * Y_shape[1] * Y_shape[2]
    result = {
        "shape": list(Y_shape), "K_true": K, "K_found": n,
        "f1": round(f1["f1"], 3), "recall": round(f1["recall"], 3),
        "precision": round(f1["precision"], 3),
        "median_trace_corr": round(float(np.median(corrs)), 3),
        "fit_seconds": round(t_fit, 1),
        "Mpixel_frames_per_s_e2e": round(pixel_frames / t_fit / 1e6, 1),
    }
    print("[scale] RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    kwargs = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kwargs[k] = int(v)
    main(**kwargs)
