"""Command-line pipeline runner.

The headless-automation surface of the framework (reference layer L7:
``python_wrapper/run_cnmfe_matlab.py`` shells out to MATLAB per stack; here
the pipeline IS Python, so the CLI runs it directly).

    python -m cnmf_e_tpu.run movie.tif --workdir out/ --preset 1p \
        --gsig 3 --gsiz 13 --min-corr 0.8 --min-pnr 8 --ring-radius 18

Outputs in the run directory: results.npz (+ optional .mat), params.json,
summary.png (Cn + contours + traces), logs.txt, stage snapshots.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def build_params(args):
    from cnmf_e_tpu.config import CNMFEParams

    p = (CNMFEParams.preset_2p() if args.preset == "2p"
         else CNMFEParams.preset_1p())
    init = dataclasses.replace(
        p.init,
        gSig=args.gsig if args.gsig is not None else p.init.gSig,
        gSiz=int(args.gsiz) if args.gsiz is not None else p.init.gSiz,
        min_corr=args.min_corr or p.init.min_corr,
        min_pnr=args.min_pnr or p.init.min_pnr,
        max_neurons=args.max_neurons or p.init.max_neurons,
        nk=args.nk if args.nk is not None else p.init.nk,
    )
    bg = p.background
    if args.bg_model:
        bg = dataclasses.replace(bg, model=args.bg_model)
    if args.ring_radius:
        bg = dataclasses.replace(bg, ring_radius=int(args.ring_radius))
    return dataclasses.replace(p, init=init, background=bg,
                               fs=args.fs or p.fs)


def _have_matplotlib() -> bool:
    """Figures need matplotlib, which the main path does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description="CNMF-E pipeline")
    ap.add_argument("movie", help="input movie (.tif/.h5/.npy)")
    ap.add_argument("--workdir", default=None,
                    help="output directory (default: <movie>_cnmfe)")
    ap.add_argument("--preset", choices=["1p", "2p"], default="1p")
    ap.add_argument("--gsig", type=float, default=None)
    ap.add_argument("--gsiz", type=float, default=None)
    ap.add_argument("--min-corr", type=float, default=None)
    ap.add_argument("--min-pnr", type=float, default=None)
    ap.add_argument("--ring-radius", type=float, default=None)
    ap.add_argument("--bg-model", choices=["ring", "svd", "nmf"],
                    default=None)
    ap.add_argument("--max-neurons", type=int, default=None)
    ap.add_argument("--nk", type=int, default=None,
                    help="detrend knots (1 = off)")
    ap.add_argument("--fs", type=float, default=None, help="frame rate")
    ap.add_argument("--n-outer", type=int, default=2)
    ap.add_argument("--frames", type=int, default=None,
                    help="limit number of frames")
    ap.add_argument("--batch-frames", type=int, default=0,
                    help="temporal batch size (0 = in-memory)")
    ap.add_argument("--save-mat", action="store_true")
    ap.add_argument("--dff", action="store_true",
                    help="also export DF/F traces")
    ap.add_argument("--resume", default=None, metavar="SNAPSHOT_NPZ",
                    help="resume from a previous stage snapshot")
    ap.add_argument("--neuron-panels", action="store_true",
                    help="write per-neuron QC PNGs")
    ap.add_argument("--report", action="store_true",
                    help="write the interactive HTML QC report")
    ap.add_argument("--apply-decisions", default=None, metavar="JSON",
                    help="decisions.json from a report: drop rejected "
                         "neurons before export")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from cnmf_e_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from cnmf_e_tpu.checkpoint import RunLog
    from cnmf_e_tpu.io.export import save_results, save_results_mat
    from cnmf_e_tpu.io.movie import load_movie, probe_movie
    from cnmf_e_tpu.io.store import distribute_movie
    from cnmf_e_tpu.models.pipeline import CNMFE

    if not os.path.exists(args.movie):
        print(f"error: input movie not found: {args.movie}", file=sys.stderr)
        return 2

    params = build_params(args)
    workdir = args.workdir or os.path.splitext(args.movie)[0] + "_cnmfe"
    os.makedirs(workdir, exist_ok=True)
    run_log = RunLog(workdir, params=params)
    verbose = not args.quiet

    shape, dtype = probe_movie(args.movie)
    run_log.log(f"input {args.movie}: shape={shape} dtype={dtype}")

    batch_states = None
    if args.batch_frames > 0:
        from cnmf_e_tpu.models.batch import fit_batches
        store = distribute_movie(args.movie, os.path.join(workdir, "store"),
                                 frames_per_block=args.batch_frames)
        blocks = list(store.iter_blocks())
        state, batch_states = fit_batches(
            blocks, params, n_outer=args.n_outer, verbose=verbose,
            run_log=run_log, resume_from=args.resume)
        model = CNMFE(params)
        model.state = state
    else:
        Y = load_movie(args.movie, 0, args.frames)
        model = CNMFE(params)
        state = model.fit(Y, n_outer=args.n_outer, verbose=verbose,
                          run_log=run_log, resume_from=args.resume)

    if args.apply_decisions:
        from cnmf_e_tpu.models.merge import merge_pairs
        from cnmf_e_tpu.models.qc import delete_neurons
        from cnmf_e_tpu.models.state import compact
        with open(args.apply_decisions) as f:
            dec = json.load(f)
        rejected = dec.get("rejected", [])
        pairs = dec.get("merge", [])
        if pairs:
            # reviewer-marked merge pairs from the report (the reference's
            # manual_merge_multi_pairs flow); ids are slot indices of the
            # reported (compacted) state
            state, nm = merge_pairs(state, params, pairs)
            run_log.log(f"applied decisions: merged {nm} pairs "
                        f"({args.apply_decisions})")
        if rejected:
            state = delete_neurons(state, rejected)
            run_log.log(f"applied decisions: dropped {len(rejected)} "
                        f"neurons ({args.apply_decisions})")
        if pairs or rejected:
            state = compact(state)
            model.state = state

    out_path = save_results(os.path.join(run_log.dir, "results"), state,
                            params=params)
    run_log.log(f"results -> {out_path}")
    if args.save_mat:
        mat_path = save_results_mat(os.path.join(run_log.dir, "results"),
                                    state)
        run_log.log(f"matlab export -> {mat_path}")

    if args.dff:
        if args.batch_frames > 0:
            from cnmf_e_tpu.models.dff import extract_dff_batches
            C_df, C_raw_df, F0 = extract_dff_batches(
                blocks, batch_states, state, params)
        else:
            C_df, C_raw_df, F0 = model.dff(Y)
        np.savez_compressed(os.path.join(run_log.dir, "dff.npz"),
                            C_df=np.asarray(C_df),
                            C_raw_df=np.asarray(C_raw_df),
                            F0=np.asarray(F0))
        run_log.log("dff -> dff.npz")

    n = int(np.asarray(state.active).sum())
    have_mpl = _have_matplotlib()
    if args.neuron_panels and n > 0 and not have_mpl:
        run_log.log("neuron panels skipped: matplotlib is not installed")
    elif args.neuron_panels and n > 0:
        from cnmf_e_tpu.utils.viz import save_neuron_panels
        save_neuron_panels(os.path.join(run_log.dir, "neurons"),
                           np.asarray(state.A)[:n],
                           np.asarray(state.C)[:n],
                           C_raw=np.asarray(state.C_raw)[:n],
                           S=np.asarray(state.S)[:n],
                           fs=params.fs)
        run_log.log("neuron panels -> neurons/")

    # summary figure
    if n > 0 and not have_mpl:
        run_log.log("summary figure skipped: matplotlib is not installed")
    elif n > 0:
        from cnmf_e_tpu.utils.viz import plot_summary
        Cn = np.asarray(model.info.get("Cn", np.zeros(shape[1:])))
        png = plot_summary(os.path.join(run_log.dir, "summary.png"), Cn,
                           np.asarray(state.A)[:n], np.asarray(state.C)[:n])
        run_log.log(f"summary figure -> {png}")

    if args.report and n > 0 and not have_mpl:
        run_log.log("report skipped: matplotlib is not installed")
    elif args.report and n > 0:
        from cnmf_e_tpu.utils.report import generate_html_report
        Cn = np.asarray(model.info.get("Cn", np.zeros(shape[1:])))
        rpt = generate_html_report(
            os.path.join(run_log.dir, "report.html"), Cn,
            np.asarray(state.A)[:n], np.asarray(state.C)[:n],
            C_raw=np.asarray(state.C_raw)[:n], S=np.asarray(state.S)[:n],
            tags=np.asarray(state.tags)[:n], fs=params.fs,
            params={"movie": args.movie, "preset": args.preset},
            title=os.path.basename(args.movie))
        run_log.log(f"interactive report -> {rpt}")

    summary = {"n_neurons": n, "movie": args.movie, "shape": list(shape),
               "run_dir": run_log.dir}
    with open(os.path.join(run_log.dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
