"""The distributed model-update step (the framework's "training step").

One full CNMF-E iteration — ring-background subtraction, spatial HALS,
temporal HALS, batched OASIS deconvolution — as a single jitted SPMD program
over the (patch, frame) mesh:

  * the ring stencil partitions over 'patch' with automatic halo exchange
  * Gram contractions (Y C^T over frames, A^T Y over pixels) psum over the
    sharded axis — the exact version of the reference's energy-weighted
    cross-patch trace reduction (``update_temporal_parallel.m:264-280``)
  * deconvolution reshards traces K-over-'patch' (per-trace parallelism,
    SURVEY.md 2.9) and runs the vmapped OASIS while_loop per shard; on a
    single GPU the sweeps and the deconvolution run as the Pallas kernels
    that :func:`cnmf_e_tpu.ops.kernels.choose` picks

FLOP structure (the reference never sees this because its patches are
small; at full-FOV scale the dense contractions dominate):

  * the background is FROZEN between refreshes, exactly like the
    reference's A_prev/C_prev snapshot (``update_background_parallel.m:
    311-317``): ``make_bg_projection`` evaluates Ysig = Y - B once per
    refresh (one movie stencil + one (d, K) x (K, T) reconstruction
    matmul), and every chained HALS iteration then touches only Ysig —
    two movie-sized Gram contractions plus K-sized solver work, no ring
    machinery.
  * the Grams run in float32 unless ``gram_dtype="bfloat16"`` asks for
    bf16 operands with f32 accumulation: they are bandwidth-bound, so
    halving operand bytes can nearly halve their time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops.hals import (hals_spatial_sweeps_rows,
                                 hals_temporal_sweeps)
from cnmf_e_tpu.ops.kernels import PALLAS, choose
from cnmf_e_tpu.ops.noise import noise_psd
from cnmf_e_tpu.ops.oasis import foopsi_ar1
from cnmf_e_tpu.ops.ring import RingWeights, apply_ring
from cnmf_e_tpu.ops.stats import submedian_mean

# every dot of the step runs at HIGHEST: with the movie-sized Grams at
# the GPU's default (TF32) a 10-iteration chain drifts A by 4.4e-2 max-rel
# from the all-HIGHEST chain (H100), past the 1e-3 drift gate
_HI = jax.lax.Precision.HIGHEST


class StepState(NamedTuple):
    """Arrays carried through one model-update iteration."""
    A: jnp.ndarray        # (K, H, W)
    C: jnp.ndarray        # (K, T)
    C_raw: jnp.ndarray    # (K, T)
    S: jnp.ndarray        # (K, T)
    g: jnp.ndarray        # (K,)  AR(1) coefficient per neuron
    b0: jnp.ndarray       # (H, W)
    ring_w: jnp.ndarray   # (H*W, R)
    ring_w0: jnp.ndarray  # (H*W,)


class BgProjection(NamedTuple):
    """Output of ``make_bg_projection``: the background-subtracted movie
    Ysig = Y - B with B frozen at projection time (the reference's
    A_prev/C_prev snapshot semantics). ``bands`` is retained for API
    compatibility and is always None — the iterations no longer run any
    ring stencil."""
    P: jnp.ndarray                   # (T, H, W) — Ysig
    bands: Optional[jnp.ndarray]     # always None


def make_bg_projection(mesh: Optional[Mesh], H: int, W: int, T: int,
                       radius: int, gram_dtype: Optional[str] = None):
    """Build the jitted background projection
    ``proj(Y, state) -> BgProjection``.

    Emits the background-subtracted movie ``Ysig = Y - B`` with
    B = W(Y - b0 - A C) + w0 + b0 FROZEN at the state passed in — exactly
    the reference's semantics: ``update_background_parallel.m:311-317``
    snapshots (A_prev, C_prev) at the background stage and every following
    spatial/temporal update subtracts that fixed B
    (``update_spatial_parallel.m:157-188``). A pipeline therefore computes
    the projection once per background refresh and amortizes the
    movie-sized stencil + reconstruction matmul over every HALS iteration
    in between (see ``make_hals_iteration``) — the iterations themselves
    touch no ring machinery at all.

    ``gram_dtype``: "bfloat16" stores Ysig in bf16 (halves the memory
    traffic of every downstream Gram contraction, with f32 accumulation;
    P is a centered fluctuation movie, so bf16 inputs cost ~0.4% relative
    error on the Grams — see test_step.py::test_bf16_grams_match_f32);
    None or "float32" keeps full precision.
    """
    p_dtype = jnp.bfloat16 if gram_dtype == "bfloat16" else jnp.float32

    def constraint(x, spec):
        if mesh is None:
            return x
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, spec))

    def proj(Y: jnp.ndarray, st: StepState):
        Y = constraint(Y, P("frame", "patch", None))
        weights = RingWeights(w=st.ring_w, w0=st.ring_w0)
        Q = Y - st.b0[None]
        X = Q - jnp.einsum("khw,kt->thw", st.A, st.C,
                           precision=_HI)                  # Y - b0 - AC
        WX = apply_ring(weights, X, H, W, radius)            # W(X) + w0
        Ysig = constraint((Q - WX).astype(p_dtype),
                          P("frame", "patch", None))         # (T, H, W)
        return BgProjection(P=Ysig, bands=None)

    return jax.jit(proj)


def make_hals_iteration(mesh: Optional[Mesh], H: int, W: int, T: int,
                        radius: int, n_hals: int = 2,
                        deconv: Optional[DeconvParams] = None,
                        smin: float = -3.0,
                        chain: int = 1, deconv_every: int = 1,
                        colored: bool = False, mask_dilate: int = 2,
                        color_block: int = 32):
    """Build the jitted HALS iteration ``iterate(proj_out, state) -> state``
    (``proj_out`` from :func:`make_bg_projection`).

    ``chain``: run this many full iterations (HALS sweeps + baseline +
    deconvolution each) inside ONE program via ``lax.fori_loop``, so a
    block of iterations per background refresh costs one dispatch.

    Takes the frozen background-subtracted movie Ysig from
    ``make_bg_projection`` — B stays fixed across the chained iterations
    exactly as the reference holds its A_prev/C_prev background snapshot
    fixed between background updates (``update_background_parallel.m:
    311-317``). The iteration body is then pure HALS + deconvolution: two
    movie-sized Gram contractions and K-sized solver work, no ring
    stencil. All shapes static; K must divide the 'patch' axis size when
    a mesh is given (pad K_max accordingly).

    ``deconv_every``: deconvolve only every Nth chained iteration (plus
    always the last). The reference deconvolves once per temporal update
    (``update_temporal_parallel.m:282-287``); the sequential OASIS scan
    over T can dominate a chained iteration's wall time, so sweeping
    several HALS iterations per deconvolution trades a little denoising
    latency for much of the iteration cost. Skipped iterations carry C = max(C_raw, 0) (the
    reference's no-deconv thresholding, ``HALS_temporal.m:66-68``).

    ``colored``: run the COLORED update — search-location masks on the
    spatial factor (``determine_search_location.m`` 'dilate' branch,
    dilation radius ``mask_dilate``; reference default strel('disk',4),
    ``CNMFSetParms.m:244``) plus a greedy overlap-graph coloring that
    orders neurons so pairwise-independent rows sit in the same sweep
    block (the reference's own independent-set device,
    ``utilities/update_order.m:1-21``). Free steps update vectorized in
    the Pallas kernel — equal to the sequential sweep over the same
    ordering up to float reassociation — collapsing the sequential-update
    latency from K to ~K/block steps. Masks and ordering are frozen per program call
    (the reference likewise recomputes search locations once per spatial
    pass); the returned state is in the caller's original neuron order.
    """
    d = H * W
    # under a mesh the sweeps and OASIS run the XLA forms (a pallas_call
    # does not partition)
    sweeps_pallas = choose("hals", mesh=mesh) == PALLAS
    oasis_impl = choose("oasis", mesh=mesh)

    def constraint(x, spec):
        if mesh is None:
            return x
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, spec))

    def one_iteration(Ysig, st: StepState, do_deconv=True,
                      mask=None, sched=None) -> StepState:
        Ysig = constraint(Ysig, P("frame", "patch", None))
        A = constraint(st.A, P(None, "patch", None))
        C = constraint(st.C, P(None, "frame"))
        K = A.shape[0]

        Pf = Ysig.reshape(T, d)                              # (T, d)
        Ar = A.reshape(K, d)                                 # (K, d) native
        # XLA:CPU's dot thunk lacks BF16 x BF16 -> F32 for these
        # contractions; there, round to bf16 and upcast (same numerics)
        if Pf.dtype == jnp.bfloat16 and jax.default_backend() == "cpu":
            to_gram = lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)
        else:
            to_gram = lambda x: x.astype(Pf.dtype)
        Pg = to_gram(Pf)

        # ---- spatial HALS ------------------------------------------------ #
        # U = Ysig_c @ Cc^T: the movie mean-term vanishes against the
        # centered Cc (HALS_spatial.m:28-32), so no centering pass on Ysig
        Cmean = jnp.mean(C, axis=1, keepdims=True)
        Cc = C - Cmean                                       # (K, T)
        V = jnp.dot(Cc, Cc.T, precision=_HI)                 # (K, K)

        U = jnp.einsum("kt,td->kd", to_gram(Cc), Pg, precision=_HI,
                       preferred_element_type=jnp.float32)
        Ar_new = hals_spatial_sweeps_rows(
            U, V, Ar, mask=mask, n_iter=n_hals,
            use_pallas=sweeps_pallas, schedule=sched,
            block=color_block if sched is not None else 16)
        A_new = Ar_new.reshape(K, H, W)
        A_new = constraint(A_new, P(None, "patch", None))
        Ar_new = A_new.reshape(K, d)

        # ---- temporal HALS ----------------------------------------------- #
        Vt = jnp.dot(Ar_new, Ar_new.T, precision=_HI)        # (K, K)
        Ut = jnp.einsum("kd,td->kt", to_gram(Ar_new), Pg, precision=_HI,
                        preferred_element_type=jnp.float32)
        # footprints stay inside their (disjoint-or-not) masks, so the
        # mask-overlap schedule certifies the temporal Gram's zero
        # structure too — same-color rows have disjoint masks, hence
        # exactly-zero Vt couplings; one schedule serves both factors
        C_raw = hals_temporal_sweeps(
            Ut, Vt, C, n_iter=n_hals, use_pallas=sweeps_pallas,
            schedule=sched,
            block=color_block if sched is not None else 16)

        # baseline: mean of sub-median samples (HALS_temporal.m:79);
        # bisection median — jnp.median's sort costs as much as the Grams
        C_raw = C_raw - submedian_mean(C_raw, axis=-1)[:, None]

        # ---- deconvolution: reshard K over 'patch' --------------------- #
        def _deconv(C_raw):
            C_dec_in = constraint(C_raw, P("patch", None))
            sn = noise_psd(C_dec_in)
            res = foopsi_ar1(C_dec_in, st.g, smin=smin, sn=sn,
                             optimize_b=False, impl=oasis_impl)
            return res.c, res.s

        def _threshold_only(C_raw):
            return jnp.maximum(C_raw, 0.0), st.S

        if isinstance(do_deconv, bool):
            c_s = _deconv(C_raw) if do_deconv else _threshold_only(C_raw)
        else:
            c_s = jax.lax.cond(do_deconv, _deconv, _threshold_only, C_raw)
        C_new = constraint(c_s[0], P(None, "frame"))
        S_new = constraint(c_s[1], P(None, "frame"))
        C_raw_new = constraint(C_raw, P(None, "frame"))

        return StepState(A=A_new, C=C_new, C_raw=C_raw_new, S=S_new,
                         g=st.g, b0=st.b0, ring_w=st.ring_w,
                         ring_w0=st.ring_w0)

    def run_chain(Ysig, st: StepState, mask=None, sched=None
                  ) -> StepState:
        it = lambda s, dd: one_iteration(Ysig, s, do_deconv=dd,
                                         mask=mask, sched=sched)
        if chain == 1:
            return it(st, True)
        if deconv_every <= 1:
            return jax.lax.fori_loop(
                0, chain, lambda _, s: it(s, True), st)
        return jax.lax.fori_loop(
            0, chain,
            lambda i, s: it(s, ((i + 1) % deconv_every == 0)
                            | (i == chain - 1)),
            st)

    def iterate(Ysig, st: StepState) -> StepState:
        if isinstance(Ysig, (BgProjection, tuple)):
            Ysig = Ysig[0]
        if not colored:
            return run_chain(Ysig, st)

        from cnmf_e_tpu.ops.coloring import (class_step_schedule,
                                             greedy_color,
                                             overlap_adjacency)
        from cnmf_e_tpu.ops.morphology import search_locations_dilate
        K = st.A.shape[0]
        M = search_locations_dilate(st.A, radius=mask_dilate)
        Mr = M.reshape(K, d)
        colors = greedy_color(overlap_adjacency(Mr))
        order = jnp.argsort(colors, stable=True)
        inverse = jnp.argsort(order)
        Mp = Mr[order]
        # class-aligned step schedule: one color_block-row vectorized
        # step per block of each color class
        sched = class_step_schedule(colors[order], block=color_block)
        perm = st._replace(A=st.A[order], C=st.C[order],
                           C_raw=st.C_raw[order], S=st.S[order],
                           g=st.g[order])
        out = run_chain(Ysig, perm, mask=Mp, sched=sched)
        return out._replace(A=out.A[inverse], C=out.C[inverse],
                            C_raw=out.C_raw[inverse], S=out.S[inverse],
                            g=st.g)

    # the input state is not donated: callers (the bench loop, the
    # pipeline) read it again after the call
    return jax.jit(iterate)


def make_update_step(mesh: Optional[Mesh], H: int, W: int, T: int,
                     radius: int, n_hals: int = 2,
                     deconv: Optional[DeconvParams] = None,
                     smin: float = -3.0,
                     gram_dtype: Optional[str] = None,
                     chain: int = 1, deconv_every: int = 1,
                     colored: bool = False, mask_dilate: int = 2,
                     color_block: int = 32):
    """Build the fused jitted update step ``step(Y, state) -> state``:
    one background refresh (projection) + ``chain`` HALS iterations
    against the frozen background, all in ONE program — one dispatch per
    refresh block, with the movie-sized projection amortized over the
    chain (the reference's structure: ``update_background_parallel``
    once, then spatial/temporal sweeps against the fixed B,
    ``demo_large_data_1p.m:199-213``)."""
    proj = make_bg_projection(mesh, H, W, T, radius, gram_dtype=gram_dtype)
    iterate = make_hals_iteration(mesh, H, W, T, radius, n_hals=n_hals,
                                  deconv=deconv, smin=smin, chain=chain,
                                  deconv_every=deconv_every,
                                  colored=colored,
                                  mask_dilate=mask_dilate,
                                  color_block=color_block)

    def step(Y: jnp.ndarray, st: StepState) -> StepState:
        return iterate(proj(Y, st), st)

    return jax.jit(step)
