"""BASELINE config-5 scale demo: 512x512x100k, 2k neurons, one chip.

Synthesizes the movie block-by-block directly into a float16 MovieStore
(~52 GB on disk; the movie never exists in memory at once), then runs the
exact streaming pipeline (models/streaming.py) on one device,
reporting sustained pixel-frame throughput, stage wall-times, and
device memory stats.

Run:  PYTHONPATH=/root/repo python scripts_dev/scale_demo.py \
          [--store DIR] [--small]

--small runs a 256x256x20k / 500-neuron variant first (shakeout).
"""

import argparse
import json
import sys
import time

import numpy as np


def device_mem():
    import jax
    try:
        s = jax.local_devices()[0].memory_stats()
        return {k: s[k] for k in ("bytes_in_use", "peak_bytes_in_use")
                if k in s}
    except Exception:
        return {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default="/tmp/scale_store")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--n-outer", type=int, default=2)
    ap.add_argument("--init-budget", type=int, default=None,
                    help="proxy init frame budget (default 2000; the full "
                         "config uses 6000 — at half-res ssub=2 the "
                         "bigger proxy fits HBM and keeps the temporal "
                         "decimation near the shakeout's tsub=10 regime)")
    ap.add_argument("--merge-thr", type=float, default=0.65,
                    help="trace-correlation gate for distance merges; "
                         "raise for sparse-activity recordings whose "
                         "traces correlate through shared background")
    args = ap.parse_args()

    from cnmf_e_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import dataclasses
    from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams,
                                   InitParams, MergeParams)
    from cnmf_e_tpu.models.streaming import fit_streaming
    from cnmf_e_tpu.utils.metrics import detection_f1
    from cnmf_e_tpu.utils.simulate import simulate_movie_store

    if args.small:
        H = W = 256
        T, K = 20_000, 500
    else:
        H = W = 512
        T, K = 100_000, 2000

    t0 = time.perf_counter()
    store = simulate_movie_store(args.store, seed=11, H=H, W=W, T=T, K=K,
                                 gSig=3.0, sn=0.08, bg_strength=0.8,
                                 min_dist=7.0, spike_rate=0.01,
                                 frames_per_block=1000)
    t_synth = time.perf_counter() - t0
    print(f"store ready in {t_synth:.0f}s: {store.shape} "
          f"({store.n_blocks()} blocks)", flush=True)

    # full config: init on a half-res proxy (greedyROI_endoscope ssub
    # semantics) — a full-res 512^2 proxy init carries 3 movie copies +
    # 2.4 GB of footprint slots and exhausts the single chip's HBM; the
    # slightly relaxed corr/pnr gates compensate the tsub~20 decimation
    # (QC + peak-distance dedup keep precision)
    params = CNMFEParams(
        init=InitParams(gSig=3.0, gSiz=10,
                        min_corr=0.8 if args.small else 0.75,
                        min_pnr=8.0 if args.small else 7.0,
                        max_neurons=2304 if not args.small else 640,
                        seeds_per_round=256 if args.small else 128,
                        max_rounds=12 if args.small else 24,
                        ssub=1 if args.small else 2),
        background=BackgroundParams(model="ring", ring_radius=9,
                                    frame_cap_factor=25),
        merge=MergeParams(dmin=4.0, merge_thr=args.merge_thr),
    )

    budget = args.init_budget or (2000 if args.small else 5000)
    print("device mem before:", device_mem(), flush=True)
    t0 = time.perf_counter()
    state = fit_streaming(store, params, n_outer=args.n_outer,
                          init_budget_frames=budget, verbose=True,
                          snapshot_path=f"{args.store}/snapshot.npz")
    dt = time.perf_counter() - t0
    n = int(np.asarray(state.active).sum())
    mem = device_mem()
    print("device mem after:", mem, flush=True)

    gt = np.load(f"{args.store}/ground_truth.npz")
    A_est = np.asarray(state.masked_A())[:n]
    f1 = detection_f1(A_est, np.asarray(gt["A"], np.float32))

    # trace fidelity vs planted truth on the stored T//25 decimation grid
    # (simulate_movie_store keeps frames 0, 25, 50, ... of the true C)
    out = {
        "shape": [T, H, W], "K_true": int(gt["A"].shape[0]),
        "neurons_found": n, "recall": round(f1["recall"], 3),
        "precision": round(f1["precision"], 3),
        "f1": round(f1["f1"], 4),
        "wall_seconds": round(dt, 1),
        "sustained_Mpf_per_s": round(H * W * T / dt / 1e6, 1),
        "synth_seconds": round(t_synth, 1),
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
    }
    gtC_path = f"{args.store}/gt_C_decim.npy"
    C_est = np.asarray(state.C)[:n]
    if C_est.shape[1] > 1:
        import os
        from cnmf_e_tpu.utils.metrics import trace_corr
        gtC = np.asarray(np.load(gtC_path), np.float32) \
            if os.path.exists(gtC_path) else None
        if gtC is not None:
            Cd = C_est[:, ::25][:, :gtC.shape[1]]
            tc = trace_corr(Cd, gtC[:, :Cd.shape[1]], f1["matches"])
            out.update(
                trace_corr_mean=round(float(tc.mean()), 4),
                trace_corr_median=round(float(np.median(tc)), 4),
                trace_corr_p10=round(float(np.percentile(tc, 10)), 4),
                n_scored_traces=int(tc.size))
        np.savez(f"{args.store}/final_result.npz",
                 A=A_est.astype(np.float16), C=C_est.astype(np.float16),
                 matches=np.asarray(f1["matches"], np.int32))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
