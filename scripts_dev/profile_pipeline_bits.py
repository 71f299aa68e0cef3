"""Micro-timing of the remaining pipeline hot spots on the device:
noise_psd_frames, the init prolog, one fused init round, residual_movie,
merge stats fetch. Steady-state (2nd call) wall times with forced sync."""

import time

from cnmf_e_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def force(x):
    return jax.block_until_ready(x)


def tick(name, fn, *a, **k):
    out = fn(*a, **k)
    force(out)
    t0 = time.perf_counter()
    out = fn(*a, **k)
    force(out)
    print(f"  {name:<28s} {time.perf_counter() - t0:8.3f}s", flush=True)
    return out


def main():
    H = W = 256
    T = 2000
    from cnmf_e_tpu.utils.simulate import simulate_movie
    from cnmf_e_tpu.config import CNMFEParams
    from cnmf_e_tpu.models.initialize import (_init_prolog,
                                              _make_init_round)
    from cnmf_e_tpu.models.state import empty_state
    from cnmf_e_tpu.models.merge import _merge_stats
    from cnmf_e_tpu.ops.noise import noise_psd_frames

    gt = simulate_movie(seed=7, H=H, W=W, T=T, K=120, gSig=3.0, sn=0.1,
                        bg_strength=1.0, min_dist=9.0, spike_rate=0.02)
    p = CNMFEParams.preset_1p()
    ip = p.init
    Y = jnp.asarray(gt.Y)

    tick("noise_psd_frames", noise_psd_frames, Y)
    HY, Ysig = tick("init_prolog", _init_prolog, Y, ip.gSig,
                    ip.center_psf)

    state = empty_state(192, H, W, T)
    searched = jnp.zeros((H, W), bool)
    round_fn = _make_init_round(ip.gSig, ip.center_psf, int(ip.gSiz), 64,
                                max(ip.min_pixel, 5), ip.corr_pixel_thr,
                                p.temporal.deconv, int(ip.gSiz))

    def one_round(st, HY, Yw, searched):
        return round_fn(st, HY, Yw, Ysig, searched, jnp.int32(0),
                        jnp.float32(ip.min_corr), jnp.float32(ip.min_pnr))

    out = one_round(state, HY, Y, searched)
    force(out[1])
    t0 = time.perf_counter()
    out = one_round(state, HY, Y, searched)
    force(out[1])
    print(f"  init_round(64 seeds)         "
          f"{time.perf_counter() - t0:8.3f}s", flush=True)

    st2 = out[0]
    tick("merge_stats+fetch",
         lambda s: np.asarray(_merge_stats(s)), st2)

    from cnmf_e_tpu.models.background import (residual_movie,
                                              update_background,
                                              subtract_background)
    sn_pix = noise_psd_frames(Y)
    st3 = tick("update_background", update_background, Y, st2, p,
               sn_pix=sn_pix)
    tick("subtract_background", subtract_background, Y, st3, p)
    tick("residual_movie", residual_movie, Y, st3, p)

    from cnmf_e_tpu.models.spatial import update_spatial
    from cnmf_e_tpu.models.temporal import update_temporal
    Ysig2 = subtract_background(Y, st3, p)
    tick("update_spatial", update_spatial, Ysig2, st3, p)
    tick("update_temporal", update_temporal, Ysig2, st3, p)


if __name__ == "__main__":
    main()
