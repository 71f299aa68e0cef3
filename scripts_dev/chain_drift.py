"""Chained-iteration drift gate for matmul precision.

Runs the chained model-update step (``make_update_step``, 10 chained
iterations, deconvolution every 5th, colored update) at the bench shape
twice: once with every dot at the precision the code sets, once with every
dot forced to HIGHEST (``jax.default_matmul_precision("highest")``). On a
GPU an f32 dot with no precision set may run in TF32, so this measures
what the code's own precision choices cost. It prints the max/rms
relative drift of A and C; the gate is max-rel <= 1e-3.

Run on the device:
  python scripts_dev/chain_drift.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

from cnmf_e_tpu.parallel.step import make_update_step  # noqa: E402
from cnmf_e_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from cnmf_e_tpu.utils.simulate import update_step_problem  # noqa: E402

GATE = 1e-3


def drift(x, ref):
    """(max, rms) relative difference, floored at 5% of the peak."""
    x, ref = np.asarray(x), np.asarray(ref)
    scale = np.maximum(np.abs(ref), 0.05 * np.abs(ref).max())
    rel = np.abs(x - ref) / scale
    return float(rel.max()), float(np.sqrt(np.mean(rel ** 2)))


def run_chain(Y, st, H, W, T, radius=13, highest=False):
    """One 10-iteration chained step; returns (A, C) as numpy."""
    step = make_update_step(None, H, W, T, radius=radius, n_hals=1,
                            chain=10, deconv_every=5, colored=True)
    if highest:
        with jax.default_matmul_precision("highest"):
            out = step(Y, st)
    else:
        out = step(Y, st)
    return np.asarray(out.A), np.asarray(out.C)


def main():
    enable_compilation_cache()
    H = W = 256
    T = 2000
    Y, st = update_step_problem(H, W, T, K=192, radius=13)
    t0 = time.perf_counter()
    a, c = run_chain(Y, st, H, W, T)
    a_ref, c_ref = run_chain(Y, st, H, W, T, highest=True)
    am, ar = drift(a, a_ref)
    cm, cr = drift(c, c_ref)
    verdict = "pass" if max(am, cm) <= GATE else "FAIL"
    print(f"A max-rel {am:.2e} rms {ar:.2e} | C max-rel {cm:.2e} "
          f"rms {cr:.2e} -> {verdict} ({time.perf_counter() - t0:.1f} s "
          f"incl. compile)", flush=True)


if __name__ == "__main__":
    main()
