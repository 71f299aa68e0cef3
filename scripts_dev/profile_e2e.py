"""Profile the END-TO-END pipeline (CNMFE.fit) on the device.

Per-stage wall times come from the verbose fit log (each stage ends with a
host fetch, so host timestamps bound device completion). Prints a stage
table plus the pipeline throughput in Mpixel-frames/s.

Usage: python scripts_dev/profile_e2e.py [H W T K n_outer]
"""

import sys
import time

from cnmf_e_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    args = [int(a) for a in sys.argv[1:]]
    H = args[0] if len(args) > 0 else 256
    W = args[1] if len(args) > 1 else 256
    T = args[2] if len(args) > 2 else 2000
    K = args[3] if len(args) > 3 else 100
    n_outer = args[4] if len(args) > 4 else 2

    from cnmf_e_tpu.utils.simulate import simulate_movie
    from cnmf_e_tpu.models.pipeline import CNMFE
    from cnmf_e_tpu.config import CNMFEParams

    print(f"backend={jax.default_backend()} devices={jax.devices()}",
          flush=True)
    t0 = time.time()
    gt = simulate_movie(seed=7, H=H, W=W, T=T, K=K, gSig=3.0, sn=0.08,
                        bg_strength=0.8, min_dist=7.0, spike_rate=0.03)
    print(f"simulated {H}x{W}x{T} K={K} in {time.time()-t0:.1f}s", flush=True)

    params = CNMFEParams.preset_1p()
    model = CNMFE(params)
    t0 = time.time()
    state = model.fit(gt.Y, n_outer=n_outer, verbose=True)
    wall = time.time() - t0
    from cnmf_e_tpu.utils.metrics import detection_f1
    f1 = detection_f1(np.asarray(state.masked_A()), gt.A)
    mpf = H * W * T / wall / 1e6
    print(f"\nE2E: {wall:.1f}s  -> {mpf:.1f} Mpixel-frames/s  "
          f"K={int(state.n_active())}  F1={f1}", flush=True)


if __name__ == "__main__":
    main()
