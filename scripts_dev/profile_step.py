"""Per-piece timing of the HALS iteration on the device (roofline work).

Times each component of parallel/step.py::one_iteration as its own chained
jitted program on the bench shapes (256x256x2000, K=192, radius 13) so we
can see where an iteration's time goes:

  grams   : the two (d,T)x(T,K) P-contractions + KxK terms
  stencil : GA = W(a_k) ring stencil over K footprint images
  hals    : spatial + temporal blocked-GS sweeps (n_hals=1)
  median  : sub-median baseline subtraction
  deconv  : noise_psd + foopsi OASIS over K traces
  full    : the real make_hals_iteration program (reference point)

Run: python scripts_dev/profile_step.py [--bf16]
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def force(x):
    return jax.block_until_ready(x)


def timeit(fn, *args, chain_div=1):
    out = fn(*args)
    force(out)
    t0 = time.perf_counter()
    out = fn(*args)
    force(out)
    return (time.perf_counter() - t0) / chain_div


def main():
    from cnmf_e_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from cnmf_e_tpu.ops.hals import hals_spatial_sweeps, hals_temporal_sweeps
    from cnmf_e_tpu.ops.noise import noise_psd
    from cnmf_e_tpu.ops.oasis import foopsi_ar1
    from cnmf_e_tpu.ops.ring import ring_offsets
    from cnmf_e_tpu.parallel.step import (StepState, make_bg_projection,
                                          make_hals_iteration)

    H = W = 256
    T = 2000
    K = 192
    radius = 13
    CH = 5
    d = H * W
    R = ring_offsets(radius).shape[0]
    rng = np.random.default_rng(0)

    Y = jnp.asarray(rng.standard_normal((T, H, W)) * 0.1 + 1.0, jnp.float32)
    A = np.zeros((K, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for k in range(K):
        cy, cx = rng.uniform(10, H - 10), rng.uniform(10, W - 10)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)

    st = StepState(A=jnp.asarray(A), C=jnp.asarray(C),
                   C_raw=jnp.zeros((K, T), jnp.float32),
                   S=jnp.zeros((K, T), jnp.float32),
                   g=jnp.full((K,), 0.92, jnp.float32),
                   b0=jnp.ones((H, W), jnp.float32),
                   ring_w=jnp.full((H * W, R), 1.0 / R, jnp.float32),
                   ring_w0=jnp.zeros((H * W,), jnp.float32))

    proj = make_bg_projection(None, H, W, T, radius=radius)
    pm = proj(Y, st)
    force(pm.P)

    bf16 = "--bf16" in sys.argv
    gdt = jnp.bfloat16 if bf16 else jnp.float32

    Pd = pm.P.reshape(T, d).T.astype(gdt)     # (d, T)
    Ad = jnp.asarray(A.reshape(K, d).T)       # (d, K)
    Cj = st.C

    t_proj = timeit(lambda Y_: proj(Y_, st), Y)

    @jax.jit
    def grams2(Pd, Ad, C):
        def body(i, carry):
            Ad_, C_ = carry
            Cm = C_ - jnp.mean(C_, axis=1, keepdims=True)
            V = Cm @ Cm.T                                       # (K, K)
            U = (Pd @ Cm.astype(gdt).T).astype(jnp.float32) + Ad_ @ V
            Ut = (Pd.T @ Ad_.astype(gdt)).astype(jnp.float32).T  # (K, T)
            return (Ad_ + 1e-12 * U, C_ + 1e-12 * Ut)
        return jax.lax.fori_loop(0, CH, body, (Ad, C))

    t_grams = timeit(grams2, Pd, Ad, Cj, chain_div=CH)

    @jax.jit
    def tiny(x):
        return x + 1.0

    t_disp = timeit(tiny, jnp.zeros((8,), jnp.float32))

    U0 = np.abs(rng.standard_normal((d, K))).astype(np.float32)
    V0 = np.eye(K, dtype=np.float32) * 5 + 0.1
    Ut0 = np.abs(rng.standard_normal((K, T))).astype(np.float32)

    @jax.jit
    def hals(U, V, Ad_, Ut, C_):
        def body(i, carry):
            Ad_, C_ = carry
            Ad2 = hals_spatial_sweeps(U, V, Ad_, mask=None, n_iter=1)
            C2 = hals_temporal_sweeps(Ut, V, C_, n_iter=1)
            return (Ad2, C2)
        return jax.lax.fori_loop(0, CH, body, (Ad_, C_))

    t_hals = timeit(hals, jnp.asarray(U0), jnp.asarray(V0), Ad,
                    jnp.asarray(Ut0), Cj, chain_div=CH)

    @jax.jit
    def median_base(C_):
        def body(i, C_):
            med = jnp.median(C_, axis=-1, keepdims=True)
            below = C_ < med
            base = jnp.sum(jnp.where(below, C_, 0.0), axis=-1) / \
                jnp.maximum(jnp.sum(below, axis=-1), 1)
            return C_ - 1e-12 * base[:, None]
        return jax.lax.fori_loop(0, CH, body, C_)

    t_median = timeit(median_base, Cj, chain_div=CH)

    @jax.jit
    def deconv(C_, g):
        def body(i, C_):
            sn = noise_psd(C_)
            res = foopsi_ar1(C_, g, smin=-3.0, sn=sn, optimize_b=False)
            return C_ + 1e-12 * res.c
        return jax.lax.fori_loop(0, CH, body, C_)

    t_deconv = timeit(deconv, Cj, st.g, chain_div=CH)

    iterate = make_hals_iteration(None, H, W, T, radius=radius, n_hals=1,
                                  chain=CH)
    t_full = timeit(lambda p, s: iterate(p, s), pm, st, chain_div=CH)

    tot = t_grams + t_hals + t_median + t_deconv
    print(f"dtype for P-grams: {gdt.__name__}")
    print(f"dispatch floor        : {t_disp*1e3:8.2f} ms (subtract from every row; /CH for per-iter rows)")
    print(f"proj (per bg refresh) : {t_proj*1e3:8.2f} ms")
    print(f"grams  (per iter)     : {t_grams*1e3:8.2f} ms")
    print(f"hals   (per iter)     : {t_hals*1e3:8.2f} ms")
    print(f"median (per iter)     : {t_median*1e3:8.2f} ms")
    print(f"deconv (per iter)     : {t_deconv*1e3:8.2f} ms")
    print(f"sum of pieces         : {tot*1e3:8.2f} ms")
    print(f"full iteration        : {t_full*1e3:8.2f} ms")
    print(f"-> full-iter throughput {H*W*T/t_full/1e6:.0f} Mpf/s")


if __name__ == "__main__":
    main()
