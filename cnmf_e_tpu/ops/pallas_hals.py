"""Fused multi-sweep HALS Gauss-Seidel kernel (Pallas, Triton route).

Reference semantics: ``HALS_spatial.m:26-46`` / ``HALS_temporal.m:58-107``
— sequential per-neuron rank-1 updates given precomputed Grams. The XLA
form (:mod:`cnmf_e_tpu.ops.hals`) runs the blocked sweeps as nested
``fori_loop``s: n_iter x K/16 x 16 dependent steps per factor, each its
own small launch.

Gauss-Seidel over NEURONS is independent across the other axis of the
factor (pixels for A, frames for C): every coupling term goes through the
K x K Gram. So one program owns a tile of ``TD`` columns of the row-major
(K, d) factor and runs ALL sweeps on it; programs share nothing, and the
grid spreads the tiles over the SMs. The output buffer is the working
copy: each program copies its tile in, updates it in place, and never
touches another program's columns.

The sweep walks a STEP SCHEDULE (``ops/coloring.py::class_step_schedule``
— the reference's independent-set trick, ``utilities/update_order.m``):
step j covers up to ``B`` rows of one color class, starting at starts[j]
and gated to [starts[j], ends[j]). Per step the program

  1. forms the block residual R = U[rows] - V[rows, :] @ X[:, tile] as
     ``pl.dot``s over chunks of the K axis (HIGHEST precision, as the
     XLA form);
  2. on a FREE step (all rows one color class: exactly-zero couplings)
     updates every gated row at once — equal to the sequential loop in
     real arithmetic; otherwise (the schedule's overflow fallback, and
     the plain block grid used when no schedule is given) updates the
     rows one by one in registers, correcting R with the block's delta;
  3. writes the block back.

Rows are windows at dynamic offsets (``pl.ds``) of the factor in device
memory, so no padding to the step grid is needed beyond the dot's
power-of-two chunks (:func:`cnmf_e_tpu.ops.kernels.hals_layout`). A block
barrier orders each step's stores before the next step's loads.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cnmf_e_tpu.ops.kernels import hals_layout

_BIG = 1e30


def _hals_kernel(n_iter: int, B: int, KC: int, Kp: int, TD: int,
                 relu: bool, interpret: bool):
    nkc = Kp // KC
    f32 = jnp.float32

    def barrier():
        # orders the block's global stores before its next loads; the
        # interpreter runs one thread and has no barrier
        if not interpret:
            plgpu.debug_barrier()

    def kernel(st_ref, en_ref, fr_ref, ns_ref, V_ref, cc_ref, gate_ref,
               U_ref, X_ref, out_ref):
        cols = pl.ds(pl.program_id(0) * TD, TD)

        def copy_in(c, carry):
            kc = pl.ds(c * KC, KC)
            out_ref[kc, cols] = X_ref[kc, cols]
            return carry

        jax.lax.fori_loop(0, nkc, copy_in, 0)
        barrier()

        rows = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
        bcols = jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)

        def step(j, carry):
            s = st_ref[j]
            e = en_ref[j]
            free = fr_ref[j] > 0
            # window start: the schedule anchors every class's step grid
            # at a multiple of 8 below the class start; clamp into range
            sc = jnp.minimum((s // 8) * 8, Kp - B)
            rb = pl.ds(sc, B)

            def chunk(c, acc):
                kc = pl.ds(c * KC, KC)
                return acc + pl.dot(V_ref[rb, kc], out_ref[kc, cols],
                                    precision=jax.lax.Precision.HIGHEST)

            VX = jax.lax.fori_loop(0, nkc, chunk, jnp.zeros((B, TD), f32))
            R = U_ref[rb, cols] - VX                            # (B, TD)
            X0 = out_ref[rb, cols]
            cc = cc_ref[rb, :]                                  # (B, 1)
            rg = sc + rows
            live = ((gate_ref[rb, :] > 0) & (cc > 0)
                    & (rg >= s) & (rg < e))                     # (B, 1)

            xv = X0 + R / jnp.maximum(cc, 1e-12)
            if relu:
                xv = jnp.maximum(xv, 0.0)
            Xb = jnp.where(live & free, xv, X0)

            Vbb = V_ref[rb, rb]                                 # (B, B)

            def inner(i, Xb):
                sel = rows == i                                 # (B, 1)
                # V is symmetric: column i of the diagonal block is row i
                w = jnp.sum(jnp.where(bcols == i, Vbb, 0.0),
                            axis=1)[:, None]                    # (B, 1)
                r = (jnp.sum(jnp.where(sel, R, 0.0), axis=0)
                     - jnp.sum(w * (Xb - X0), axis=0))[None, :]
                x_cur = jnp.sum(jnp.where(sel, Xb, 0.0),
                                axis=0)[None, :]                # (1, TD)
                cc_i = jnp.sum(jnp.where(sel, cc, 0.0))
                xk = x_cur + r / jnp.maximum(cc_i, 1e-12)
                if relu:
                    xk = jnp.maximum(xk, 0.0)
                return jnp.where(sel & live, xk, Xb)

            # mixed steps run their rows in order via a traced trip count
            n_inner = jnp.where(free, jnp.int32(0), jnp.int32(B))
            Xb = jax.lax.fori_loop(jnp.int32(0), n_inner, inner, Xb)
            barrier()
            out_ref[rb, cols] = Xb
            barrier()
            return carry

        def sweep(_, carry):
            return jax.lax.fori_loop(0, ns_ref[0], step, carry)

        jax.lax.fori_loop(0, n_iter, sweep, 0)

    return kernel


@functools.partial(jax.jit, static_argnames=("n_iter", "block", "relu",
                                             "tile", "interpret"))
def hals_sweeps_rows_pallas(U: jnp.ndarray, V: jnp.ndarray, X: jnp.ndarray,
                            gate: jnp.ndarray,
                            mask: Optional[jnp.ndarray] = None,
                            n_iter: int = 5, block: int = 16,
                            relu: bool = True,
                            schedule: Optional[Tuple] = None,
                            tile: Optional[int] = None,
                            interpret: bool = False) -> jnp.ndarray:
    """Run ``n_iter`` scheduled Gauss-Seidel sweeps on row-major factors.

    X, U: (K, d) — rows are neurons; V: (K, K) symmetric Gram;
    gate: (K,) bool/float — rows with gate == 0 keep their input value
    (covers the XLA path's ``cc > 0`` and ``active`` guards);
    mask: optional (K, d) support mask (spatial search locations; needs
    ``relu``);
    schedule: optional (starts, ends, free, n_steps) from
    ``ops.coloring.class_step_schedule`` built with this ``block`` — rows
    must already be in colored order; without one every step is a plain
    block of ``block`` rows run in order;
    block: rows per step, a power of two >= 16;
    tile: columns per program, a power of two >= 16.

    Returns the updated (K, d) factor. Update order matches
    ``ops.hals.hals_spatial_sweeps`` / ``hals_temporal_sweeps``.

    With a mask the wrapper zeroes masked entries of X and sets U there
    to -BIG: a masked-out entry's update is relu(x + (-BIG - corr)/cc) = 0
    exactly, so the kernel needs no third (K, d) operand.
    """
    K, d = X.shape
    f32 = jnp.float32
    B = block
    KC, Kp = hals_layout(K, block)
    X = X.astype(f32)
    U = U.astype(f32)
    if mask is not None:
        if not relu:
            raise ValueError("a support mask needs relu=True")
        mb = mask if mask.dtype == jnp.bool_ else mask > 0
        X = jnp.where(mb, X, 0.0)
        U = jnp.where(mb, U, -_BIG)

    if schedule is not None:
        starts, ends, free, n_steps = schedule
        # rows past K never update: ends <= K and the gate pads to 0
    else:
        nb = -(-K // B)
        starts = jnp.arange(nb, dtype=jnp.int32) * B
        ends = jnp.full((nb,), K, jnp.int32)
        free = jnp.zeros((nb,), jnp.int32)
        n_steps = nb

    # (B, TD) register tiles: at B * TD >= 4096 a 4-warp program spills
    # and runs ~20x slower (H100 tuning sweep, PERF.md); 64 columns is
    # the fastest tile below that
    TD = tile or min(64, max(16, 2048 // B))
    dp = -(-d // TD) * TD
    U = jnp.pad(U, ((0, Kp - K), (0, dp - d)))
    X = jnp.pad(X, ((0, Kp - K), (0, dp - d)))
    V = jnp.pad(V.astype(f32), ((0, Kp - K), (0, Kp - K)))
    cc = jnp.diag(V)[:, None]
    gate = jnp.pad(gate.astype(f32), (0, Kp - K))[:, None]

    out = pl.pallas_call(
        _hals_kernel(n_iter, B, KC, Kp, TD, relu, interpret),
        grid=(dp // TD,),
        out_shape=jax.ShapeDtypeStruct((Kp, dp), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="hals_sweeps",
    )(starts.astype(jnp.int32), ends.astype(jnp.int32),
      free.astype(jnp.int32), jnp.asarray(n_steps, jnp.int32).reshape(1),
      V, cc, gate, U, X)
    return out[:K, :d]
