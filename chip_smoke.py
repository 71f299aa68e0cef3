#!/usr/bin/env python3
"""Smoke test of CNMF-E on one GPU: the main path once, at real sizes.

    python chip_smoke.py            # phases 0-3 on one GPU
    python chip_smoke.py --multi    # phase 4 only, on every visible GPU

Phases (any failure raises and exits non-zero):

0. Device: the first JAX device must be a GPU; prints the card's name and
   power limit (nvidia-smi) and the JAX version.
1. Kernels against the plain reference at real widths: the HALS sweeps
   and OASIS (the Pallas kernels the ops choose on a GPU), the ring
   apply and the PSF filter. Prints the implementation taken, both
   times, the error and the precision each side ran at.
2. The chained update step (``make_update_step``, chain 10, deconvolution
   every 5th, colored) at 256x256x2000, K = 192, against the same chain
   with every dot at HIGHEST: the chain-drift gate, max-rel <= 1e-3.
3. End to end through the CLI (``cnmf_e_tpu.run.main``) on a simulated 1p
   movie of 256x256x6000 frames with 150 planted neurons, scored against
   the planted truth (recall >= 0.8, precision >= 0.6, median trace
   correlation > 0.9). Prints cold and warm wall seconds.
4. ``--multi``: the chained update step of phase 2 on (patch, frame) =
   (4, 1) and (2, 2) meshes, the pipeline stages on sharded input and one
   streamed mesh iteration, each against the single-card result: the
   same neurons, and A, C_raw and C within max-rel 1e-3. The step is
   gated on planted neurons; the noise-only bench problem is printed.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "chiprun_out", "smoke_work")
# the sizes the phases run at; a CPU rehearsal may shrink them
S = dict(H=256, W=256, T=2000, K=192, K_big=1024, T_long=6000,
         T_cli=6000, K_cli=150, K_multi=120)


def say(*a):
    print(*a, flush=True)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"FAIL: {msg}")
    say(f"  pass: {msg}")


def timed(fn, *args, reps=3):
    """(best seconds over ``reps`` warm calls, result); compiles first."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def corr(x, ref):
    import numpy as np
    return float(np.corrcoef(np.asarray(x, np.float64).ravel(),
                             np.asarray(ref, np.float64).ravel())[0, 1])


def maxrel(x, ref):
    import numpy as np
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


def phase0():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"FAIL: no GPU (JAX found {dev.platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
        f"{dev.device_kind}")
    from cnmf_e_tpu.utils.cache import enable_compilation_cache
    say(f"compile cache: {enable_compilation_cache()}")
    return dev


# ---------------------------------------------------------------- phase 1


def hals_problem(K, H=None, W=None, T=None, seed=0):
    """Grams of a synthetic (d, T) movie with K compact footprints."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    H, W, T = H or S["H"], W or S["W"], T or S["T"]
    rng = np.random.default_rng(seed)
    d = H * W
    A = np.zeros((K, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for k in range(K):
        cy, cx = rng.uniform(10, H - 10), rng.uniform(10, W - 10)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    A[A < 1e-3] = 0.0
    A = jnp.asarray(A.reshape(K, d))
    C = jnp.asarray(np.abs(rng.standard_normal((K, T))), jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    Y = (jnp.dot(A.T, C, precision=hi)
         + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), (d, T)))
    Cc = C - C.mean(1, keepdims=True)
    return dict(U=jnp.dot(Cc, Y.T, precision=hi),
                V=jnp.dot(Cc, Cc.T, precision=hi), A=A,
                Ut=jnp.dot(A, Y, precision=hi),
                Vt=jnp.dot(A, A.T, precision=hi), C=C)


def phase1_hals(kept):
    import jax
    from cnmf_e_tpu.ops.hals import hals_spatial_sweeps_rows, hals_temporal_sweeps
    from cnmf_e_tpu.ops.kernels import choose
    impl = choose("hals")
    say(f"[hals] implementation: {impl}; reference: XLA blocked "
        f"Gauss-Seidel; both sides HIGHEST-precision dots")
    kept["hals"] = impl
    for K in (S["K"], S["K_big"]):
        p = hals_problem(K)
        for name, fn, args in (
                ("spatial", hals_spatial_sweeps_rows, (p["U"], p["V"],
                                                       p["A"])),
                ("temporal", hals_temporal_sweeps, (p["Ut"], p["Vt"],
                                                    p["C"]))):
            run = jax.jit(lambda *a, f=fn: f(*a, n_iter=5))
            ref_fn = jax.jit(lambda *a, f=fn: f(*a, n_iter=5,
                                                use_pallas=False))
            tk, got = timed(run, *args)
            tx, ref = timed(ref_fn, *args, reps=1)
            err = maxrel(got, ref)
            say(f"[hals] {name} d={S['H'] * S['W']} T={S['T']} K={K} "
                f"n_iter=5: "
                f"{impl} {tk * 1e3:.3f} ms, xla {tx * 1e3:.3f} ms, "
                f"max-rel {err:.2e}")
            check(err <= 1e-4, f"hals {name} K={K} max-rel {err:.2e} "
                  f"<= 1e-4")
        del p


def ar1_traces(K, T, seed, rate=0.05, sn=0.2):
    import numpy as np
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.7, 0.97, K).astype(np.float32)
    s = (rng.random((K, T)) < rate) * rng.exponential(1.0, (K, T))
    c = np.zeros((K, T), np.float32)
    for t in range(1, T):
        c[:, t] = g * c[:, t - 1] + s[:, t]
    return c + sn * rng.standard_normal((K, T)).astype(np.float32), g


def phase1_oasis(kept):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cnmf_e_tpu.ops.kernels import choose
    from cnmf_e_tpu.ops.oasis import oasis_ar1
    impl = choose("oasis")
    kept["oasis"] = impl
    say(f"[oasis] implementation: {impl}; reference: sample-level "
        f"while_loop (_oasis_ar1_single) over the same windows; "
        f"elementwise f32, no dots")
    K = S["K"]
    for T in (S["T"], S["T_long"]):
        y, g = ar1_traces(K, T, seed=T)
        y, g = jnp.asarray(y), jnp.asarray(g)
        for smin in (0.0, 0.3):
            z = jnp.zeros((K,), jnp.float32)
            sm = jnp.full((K,), smin, jnp.float32)
            run = jax.jit(lambda y, g, z, sm: oasis_ar1(y, g, z, sm))
            ref_fn = jax.jit(lambda y, g, z, sm: oasis_ar1(
                y, g, z, sm, chunk=0, impl="xla"))
            xla_fn = jax.jit(lambda y, g, z, sm: oasis_ar1(
                y, g, z, sm, impl="xla"))
            tk, (c, s) = timed(run, y, g, z, sm)
            tr, (cr, sr) = timed(ref_fn, y, g, z, sm, reps=1)
            tx, (cx, _) = timed(xla_fn, y, g, z, sm, reps=1)
            ymax = float(jnp.abs(y).max())
            err = float(jnp.abs(c - cr).max()) / ymax
            errx = float(jnp.abs(cx - cr).max()) / ymax
            cc = corr(c, cr)
            say(f"[oasis] K={K} T={T} smin={smin}: {impl} "
                f"{tk * 1e3:.3f} ms, xla form "
                f"({'divide-and-conquer' if smin == 0 else 'sample-level'})"
                f" {tx * 1e3:.3f} ms, sample-level xla {tr * 1e3:.3f} ms; "
                f"max|dc|/max|y| kernel {err:.2e}, xla form {errx:.2e}; "
                f"kernel corr {cc:.7f}")
            check(max(err, errx) <= 1e-4 and cc > 0.999,
                  f"oasis T={T} smin={smin} kernel and xla form err "
                  f"{max(err, errx):.2e} <= 1e-4, corr > 0.999")


def ring_reference(w, w0, X, radius):
    """Float64 numpy ring apply: sum over taps of w[:, r] * shift_r(X)."""
    import numpy as np
    from cnmf_e_tpu.ops.ring import ring_offsets
    T, H, W = X.shape
    out = np.broadcast_to(w0.reshape(1, H, W), X.shape).copy()
    for r, (dy, dx) in enumerate(ring_offsets(radius)):
        sh = np.zeros_like(X)
        ys, xs = slice(max(0, -dy), min(H, H - dy)), slice(max(0, -dx),
                                                           min(W, W - dx))
        yt, xt = slice(max(0, dy), min(H, H + dy)), slice(max(0, dx),
                                                          min(W, W + dx))
        sh[:, ys, xs] = X[:, yt, xt]
        out += w[:, r].reshape(1, H, W) * sh
    return out


def phase1_ring_filter():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cnmf_e_tpu.ops import filters
    from cnmf_e_tpu.ops.ring import RingWeights, apply_ring, ring_offsets
    H, W, T = S["H"], S["W"], S["T"]
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.standard_normal((T, H, W)), jnp.float32)
    for radius in (13, 18):
        R = ring_offsets(radius).shape[0]
        w = RingWeights(
            w=jnp.asarray(rng.standard_normal((H * W, R)) / R, jnp.float32),
            w0=jnp.asarray(rng.standard_normal(H * W), jnp.float32))
        run = jax.jit(lambda w, X: apply_ring(w, X, H, W, radius))
        t, got = timed(run, w, X)
        with jax.default_matmul_precision("highest"):
            tr, got_hi = timed(jax.jit(
                lambda w, X: apply_ring(w, X, H, W, radius)), w, X, reps=1)
        ref = ring_reference(np.asarray(w.w, np.float64),
                             np.asarray(w.w0, np.float64),
                             np.asarray(X[:8], np.float64), radius)
        err = max(maxrel(got[:8], ref), maxrel(got, got_hi))
        say(f"[ring] apply_ring (xla, grouped shifts) {H}x{W}x{T} "
            f"radius={radius} R={R}: {t * 1e3:.3f} ms (default precision), "
            f"{tr * 1e3:.3f} ms (HIGHEST); max-rel {err:.2e} against a "
            f"float64 shift-sum on 8 frames and the HIGHEST run")
        check(err <= 1e-5, f"ring radius={radius} max-rel {err:.2e} "
              f"<= 1e-5")
    from scipy import ndimage
    psf = filters.gaussian_psf(3.0, center_psf=True, size=13)
    run = jax.jit(lambda Y: filters.filter_movie(Y, psf))
    t, got = timed(run, X)
    with jax.default_matmul_precision("highest"):
        tr, got_hi = timed(jax.jit(lambda Y: filters.filter_movie(Y, psf)),
                           X, reps=1)
    ref = np.stack([ndimage.convolve(f, psf.astype(np.float64),
                                     mode="nearest")
                    for f in np.asarray(X[:8], np.float64)])
    err = max(maxrel(got[:8], ref), maxrel(got, got_hi))
    say(f"[filter] filter_movie (xla conv) gSig=3 gSiz=13 {H}x{W}x{T}: "
        f"{t * 1e3:.3f} ms (default precision), {tr * 1e3:.3f} ms "
        f"(HIGHEST); max-rel {err:.2e} against a float64 convolution on "
        f"8 frames and the HIGHEST run")
    check(err <= 1e-5, f"filter max-rel {err:.2e} <= 1e-5")


# ---------------------------------------------------------------- phase 2


def phase2():
    sys.path.insert(0, os.path.join(HERE, "scripts_dev"))
    from chain_drift import GATE, drift, run_chain
    from cnmf_e_tpu.utils.simulate import update_step_problem
    H, W, T = S["H"], S["W"], S["T"]
    Y, st = update_step_problem(H, W, T, K=S["K"], radius=13)
    t0 = time.perf_counter()
    a, c = run_chain(Y, st, H, W, T)
    t1 = time.perf_counter()
    a_hi, c_hi = run_chain(Y, st, H, W, T, highest=True)
    t2 = time.perf_counter()
    am, _ = drift(a, a_hi)
    cm, _ = drift(c, c_hi)
    say(f"[step] chain=10 deconv_every=5 colored K={S['K']} {H}x{W}x{T}: "
        f"default {t1 - t0:.2f} s, HIGHEST {t2 - t1:.2f} s (both incl. "
        f"compile); A max-rel {am:.2e}, C max-rel {cm:.2e}")
    check(cm <= GATE and am <= GATE,
          f"chain drift A {am:.2e}, C {cm:.2e} <= {GATE:.0e}")
    return Y, st


# ---------------------------------------------------------------- phase 3


def phase3():
    import numpy as np
    from cnmf_e_tpu.io.tiff import write_tiff
    from cnmf_e_tpu.run import main as cli
    from cnmf_e_tpu.utils.metrics import detection_f1, trace_corr
    from cnmf_e_tpu.utils.simulate import simulate_movie

    H, W, T = S["H"], S["W"], S["T_cli"]
    t0 = time.perf_counter()
    gt = simulate_movie(seed=7, H=H, W=W, T=T, K=S["K_cli"], gSig=3.0,
                        sn=0.1, bg_strength=1.0, min_dist=9.0,
                        spike_rate=0.02)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    movie = os.path.join(WORK, "movie.tif")
    write_tiff(movie, gt.Y)
    say(f"[cli] simulated {H}x{W}x{T} movie, {S['K_cli']} neurons, gSig 3: "
        f"{time.perf_counter() - t0:.1f} s")
    args = [movie, "--gsig", "3", "--gsiz", "13", "--max-neurons", "300",
            "--dff", "--quiet"]
    walls = []
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        rc = cli(args + ["--workdir", os.path.join(WORK, run)])
        walls.append(time.perf_counter() - t0)
        check(rc == 0, f"CLI {run} run exit code 0")
    out = os.path.join(WORK, "warm")
    run_dir = sorted(d for d in os.listdir(out) if d.startswith("RUN_"))[-1]
    res = np.load(os.path.join(out, run_dir, "results.npz"))
    A = res["A"].reshape(res["A"].shape[0], H, W)
    C = res["C"]
    f1 = detection_f1(A, gt.A)
    corr = trace_corr(C, gt.C, f1["matches"])
    med = float(np.median(corr)) if len(corr) else 0.0
    say(f"[cli] cold {walls[0]:.2f} s, warm {walls[1]:.2f} s; "
        f"{A.shape[0]} neurons; recall {f1['recall']:.3f} precision "
        f"{f1['precision']:.3f} F1 {f1['f1']:.3f}; median trace corr "
        f"{med:.4f}")
    check(os.path.exists(os.path.join(out, run_dir, "dff.npz")),
          "dff.npz written")
    check(f1["recall"] >= 0.8 and f1["precision"] >= 0.6 and med > 0.9,
          "recall >= 0.8, precision >= 0.6, median trace corr > 0.9")
    shutil.rmtree(WORK, ignore_errors=True)


# ---------------------------------------------------------------- phase 4


def phase4():
    """Meshes over every visible GPU against the single-card results."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cnmf_e_tpu.parallel.mesh import make_mesh
    from cnmf_e_tpu.parallel.step import make_update_step
    from cnmf_e_tpu.utils.simulate import update_step_problem

    n = len(jax.devices())
    check(n == 4, f"{n} devices visible (need 4)")
    sys.path.insert(0, os.path.join(HERE, "scripts_dev"))
    from chain_drift import GATE, drift

    H, W, T, K = S["H"], S["W"], S["T"], S["K"]
    failed = []

    def gate(ok, msg):
        say(f"  {'pass' if ok else 'FAIL'}: {msg}")
        if not ok:
            failed.append(msg)

    def compare(what, out, ref, fields=("A", "C_raw", "C")):
        """Print the floored max-rel of each field and the spike-support
        flips; return the worst max-rel."""
        errs = {f: drift(getattr(out, f), getattr(ref, f))[0]
                for f in fields}
        flips = int(np.sum((np.asarray(out.S) > 0)
                           != (np.asarray(ref.S) > 0)))
        say(f"[multi] {what}: " + ", ".join(
            f"{f} max-rel {e:.2e}" for f, e in errs.items())
            + f"; spike flips {flips} of {int(np.sum(np.asarray(ref.S) > 0))}")
        return max(errs.values())

    # the chained update step, as chip phase 2 runs it; the single card
    # runs the kernels, every mesh the XLA forms (a one-device mesh runs
    # them on the single card)
    kw = dict(radius=13, n_hals=1, chain=10, deconv_every=5, colored=True)
    specs = dict(A=P(None, "patch", None), C=P(None, "frame"),
                 C_raw=P(None, "frame"), S=P(None, "frame"), g=P(),
                 b0=P("patch", None), ring_w=P("patch", None),
                 ring_w0=P("patch"))
    meshes = {(p, f): make_mesh(n_patch=p, n_frame=f)
              for p, f in ((1, 1), (4, 1), (2, 2))}
    steps = {None: make_update_step(None, H, W, T, **kw)}
    steps.update({m: make_update_step(mesh, H, W, T, **kw)
                  for m, mesh in meshes.items()})

    def run_step(m, Y, st):
        if m is not None:
            put = lambda x, spec: jax.device_put(
                x, NamedSharding(meshes[m], spec))
            Y = put(Y, P("frame", "patch", None))
            st = st._replace(**{f: put(getattr(st, f), s)
                                for f, s in specs.items()})
        t0 = time.perf_counter()
        out = jax.block_until_ready(steps[m](Y, st))
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(steps[m](Y, st))
        return out, tc, time.perf_counter() - t0

    # planted neurons (a fitted recording's refinement) are held to the
    # single card's kernels. The noise-only bench problem is printed, not
    # gated: it fits noise and puts OASIS's threshold inside it, so even
    # two implementations on one card part there (spikes flip), and two
    # partitionings of the same XLA forms reach ~1e-3 in A
    for planted in (True, False):
        Y, st = update_step_problem(H, W, T, K=K, radius=13, planted=planted)
        name = "planted" if planted else "noise-only"
        ref, tc, tw = run_step(None, Y, st)
        ref_x, tcx, twx = run_step((1, 1), Y, st)
        say(f"[multi] update step chain=10 deconv_every=5 colored K={K} "
            f"{H}x{W}x{T} ({name}), single card: kernels cold {tc:.2f} s, "
            f"warm {tw * 1e3:.2f} ms; XLA forms cold {tcx:.2f} s, warm "
            f"{twx * 1e3:.2f} ms")
        compare(f"single card, XLA forms vs kernels ({name})", ref_x, ref)
        for m in ((4, 1), (2, 2)):
            out, tc, tw = run_step(m, Y, st)
            say(f"[multi] mesh (patch={m[0]}, frame={m[1]}) {name}: cold "
                f"{tc:.2f} s, warm {tw * 1e3:.2f} ms")
            ek = compare(f"mesh {m} {name} vs single card, kernels", out,
                         ref)
            compare(f"mesh {m} {name} vs single card, XLA forms", out,
                         ref_x)
            if planted:
                gate(ek <= GATE, f"mesh {m} update step ({name}) matches "
                     f"the single card: A, C_raw, C max-rel <= {GATE:.0e}")
        del Y, st

    # pipeline stages and one streamed iteration on sharded input
    from cnmf_e_tpu.config import CNMFEParams
    from cnmf_e_tpu.io.store import distribute_movie
    from cnmf_e_tpu.models.background import (subtract_background,
                                              update_background)
    from cnmf_e_tpu.models.initialize import initialize_greedy
    from cnmf_e_tpu.models.spatial import update_spatial
    from cnmf_e_tpu.models.streaming import fit_streaming
    from cnmf_e_tpu.models.temporal import update_temporal
    from cnmf_e_tpu.utils.metrics import detection_f1
    from cnmf_e_tpu.utils.simulate import simulate_movie

    gt = simulate_movie(seed=7, H=H, W=W, T=T, K=S["K_multi"], gSig=3.0,
                        sn=0.1, bg_strength=1.0, min_dist=9.0,
                        spike_rate=0.02)
    params = CNMFEParams.preset_1p()
    params = params.replace(init=dataclasses.replace(
        params.init, max_neurons=K, seeds_per_round=64, max_rounds=10))
    mesh = meshes[(2, 2)]

    def stages(Yin):
        state, _ = initialize_greedy(Yin, params)
        state = update_background(Yin, state, params)
        Ysig = subtract_background(Yin, state, params)
        state = update_spatial(Ysig, state, params)
        return jax.block_until_ready(update_temporal(Ysig, state, params))

    def compare_states(what, out, ref):
        same = bool(np.array_equal(np.asarray(out.active),
                                   np.asarray(ref.active)))
        f1 = detection_f1(np.asarray(out.masked_A())[np.asarray(out.active)],
                          np.asarray(ref.masked_A())[np.asarray(ref.active)])
        say(f"[multi] {what}: {int(out.n_active())} neurons vs "
            f"{int(ref.n_active())} on the single card, same slots {same}, "
            f"F1 {f1['f1']:.3f}")
        worst = compare(what, out, ref) if same else float("inf")
        gate(same and worst <= GATE, f"{what} matches the single card: same "
             f"neurons, A, C_raw, C max-rel <= {GATE:.0e}")

    Yj = jnp.asarray(gt.Y)
    s1 = stages(Yj)
    s4 = stages(jax.device_put(Yj, NamedSharding(
        mesh, P("frame", "patch", None))))
    compare_states("pipeline stages on a (2, 2) mesh", s4, s1)
    del Yj, s1, s4

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    src = os.path.join(WORK, "movie.npy")
    np.save(src, gt.Y)
    store = distribute_movie(src, os.path.join(WORK, "store"),
                             frames_per_block=T // 4)
    res = {}
    for name, m in (("single card", None), ("(2, 2) mesh", mesh)):
        t0 = time.perf_counter()
        res[name] = jax.block_until_ready(fit_streaming(
            store, params, n_outer=1, init_budget_frames=T, mesh=m))
        say(f"[multi] fit_streaming n_outer=1 on the {name}: "
            f"{time.perf_counter() - t0:.2f} s (incl. compile)")
    compare_states("streamed iteration on a (2, 2) mesh",
                   res["(2, 2) mesh"], res["single card"])
    shutil.rmtree(WORK, ignore_errors=True)
    check(not failed, f"every mesh check passed ({len(failed)} failed)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "cnmf_e_tpu")):
        raise SystemExit("FAIL: run chip_smoke.py from a checkout of the "
                         "repository (package cnmf_e_tpu not found)")
    sys.path.insert(0, HERE)
    dev = phase0()
    t0 = time.perf_counter()
    if args.multi:
        phase4()
    else:
        kept = {}
        phase1_hals(kept)
        phase1_oasis(kept)
        phase1_ring_filter()
        phase2()
        phase3()
        check(all(v == "pallas-triton" for v in kept.values()),
              f"kept kernels taken at the bench shapes: {kept}")
    import jax
    say(f"smoke phases took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
