"""Monte-Carlo EM deconvolution (time-constant resampling).

Reference: ``ca_source_extraction/utilities/MCEM_foopsi.m`` (the
``'MCEM_foopsi'`` back-end of ``update_temporal_components.m:13,323-326``):
alternate between (E) a Metropolis random walk on the rise/decay time
constants — each proposal re-synthesizes the calcium trace from the CURRENT
spike train under the proposed kernel and accepts on
exp((logC' - logC) / (2 sn^2)) — and (M) a constrained-foopsi refit with g
rebuilt from the mean sampled taus.

Batched re-design: fully batched over traces. The per-proposal trace synthesis
c = (g2 * filt(s, g2) - g1 * filt(s, g1)) / (g2 - g1) (MCEM_foopsi.m:66-73,
the G1/G2 bidiagonal solves) is a pair of truncated-exponential causal
convolutions — one (N, T) conv per proposal instead of MATLAB's per-trace
sparse triangular solves. The inner MH loop runs as ONE jitted block
(``n_inner`` sweeps, keys split inside); the EM outer loop is a short host
loop re-entering the same compiled programs.

Documented deviations: out-of-range tau proposals are REJECTED rather than
re-drawn until valid (keeps the kernel symmetric — the reference's
draw-until-in-range loop is an implicit truncated proposal it never
corrects for); the reference's ``c1 * g^t`` initial-transient term is
absent because this framework's solvers fold initial conditions into s[0].
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cnmf_e_tpu.config import DeconvParams


def _exp_filt(s: jnp.ndarray, g: jnp.ndarray, L: int) -> jnp.ndarray:
    """Causal exponential filter filt[t] = sum_k g^k s[t-k], truncated at
    L taps (the G^-1 bidiagonal solve of MCEM_foopsi.m:68-72)."""
    T = s.shape[-1]
    k = jnp.arange(L, dtype=s.dtype)
    ker = jnp.power(jnp.maximum(g, 1e-6)[..., None], k[None])   # (N, L)
    return jax.vmap(
        lambda sv, kv: jnp.convolve(sv, kv, mode="full")[:T])(s, ker)


def _synth(s, b, tau1, tau2, p, L):
    """Trace from spikes under kernel taus (MCEM_foopsi.m:66-73)."""
    g2 = jnp.exp(-1.0 / jnp.maximum(tau2, 1e-3))
    if p == 1:
        return _exp_filt(s, g2, L) + b[:, None]
    g1 = jnp.exp(-1.0 / jnp.maximum(tau1, 1e-3))
    h = jnp.maximum(g2 - g1, 1e-4)
    c = (g2[:, None] * _exp_filt(s, g2, L)
         - g1[:, None] * _exp_filt(s, g1, L)) / h[:, None]
    return c + b[:, None]


@functools.partial(jax.jit, static_argnames=("p", "n_inner", "L"))
def _mcem_block(y, s, b, tau1, tau2, sn, key, p: int, n_inner: int,
                L: int):
    """One E-step: ``n_inner`` MH sweeps over (tau1, tau2). Returns
    (tau1_mean, tau2_mean, accept_counts)."""
    N = y.shape[0]
    inv = 1.0 / jnp.maximum(2.0 * sn * sn, 1e-12)
    tau_min = jnp.zeros((N,), y.dtype)
    tau_max = 2.0 * tau2

    def neg_rss(t1, t2):
        c = _synth(s, b, t1, t2, p, L)
        r = y - c
        return -jnp.sum(r * r, axis=-1)

    def sweep(carry, key):
        t1, t2, acc = carry
        k1, k2, k3, k4 = jax.random.split(key, 4)
        logC = neg_rss(t1, t2)

        if p >= 2:
            # rise-time move (MCEM_foopsi.m:58-85); std = max(tau1/5, .2)
            std1 = jnp.maximum(t1 / 5.0, 0.2)
            t1p = t1 + std1 * jax.random.normal(k1, (N,), y.dtype)
            ok1 = (t1p > tau_min) & (t1p < t2)
            logC1 = neg_rss(jnp.where(ok1, t1p, t1), t2)
            u1 = jnp.log(jax.random.uniform(k2, (N,), y.dtype) + 1e-12)
            take1 = ok1 & (u1 < (logC1 - logC) * inv)
            t1 = jnp.where(take1, t1p, t1)
            logC = jnp.where(take1, logC1, logC)
            acc = acc + take1
        # decay-time move (MCEM_foopsi.m:90-122); std = min(tau2/10, 2)
        std2 = jnp.minimum(t2 / 10.0, 2.0)
        t2p = t2 + std2 * jax.random.normal(k3, (N,), y.dtype)
        ok2 = (t2p > t1) & (t2p < tau_max)
        logC2 = neg_rss(t1, jnp.where(ok2, t2p, t2))
        u2 = jnp.log(jax.random.uniform(k4, (N,), y.dtype) + 1e-12)
        take2 = ok2 & (u2 < (logC2 - logC) * inv)
        t2 = jnp.where(take2, t2p, t2)
        acc = acc + take2
        return (t1, t2, acc), (t1, t2)

    keys = jax.random.split(key, n_inner)
    (t1, t2, acc), (hist1, hist2) = jax.lax.scan(
        sweep, (tau1, tau2, jnp.zeros((N,), jnp.int32)), keys)
    return jnp.mean(hist1, axis=0), jnp.mean(hist2, axis=0), acc


def mcem_foopsi(y: jnp.ndarray, params: DeconvParams,
                sn: Optional[jnp.ndarray] = None,
                g: Optional[jnp.ndarray] = None,
                key: Optional[jax.Array] = None,
                n_em: int = 4, n_inner: int = 25, L: int = 200):
    """Batched MCEM deconvolution. y: (..., T). Returns a DeconvResult
    whose g holds the EM-refined AR coefficients."""
    from cnmf_e_tpu.ops.ar import ar2exp, exp2ar
    from cnmf_e_tpu.ops.oasis import DeconvResult, deconvolve

    if key is None:
        key = jax.random.PRNGKey(params.__hash__() & 0x7FFFFFFF)
    y = jnp.asarray(y)
    batch = y.shape[:-1]
    yf = y.reshape((-1, y.shape[-1]))
    N, T = yf.shape
    L = min(L, T)
    p = 1 if params.model == "ar1" else 2
    import dataclasses
    inner_params = dataclasses.replace(params, method="constrained")

    res = deconvolve(yf, inner_params, sn=sn, g=g)
    sn_use = jnp.asarray(sn).reshape(-1) if sn is not None else \
        jnp.maximum(jnp.std(yf - res.c, axis=-1), 1e-6)

    for _ in range(n_em):
        gg = res.g
        if p == 1:
            tau2 = -1.0 / jnp.log(jnp.clip(gg[:, 0], 1e-4, 1 - 1e-6))
            tau1 = jnp.zeros_like(tau2)
        else:
            d, r = ar2exp(gg)
            tau2 = -1.0 / jnp.log(jnp.clip(d, 1e-4, 1 - 1e-6))
            tau1 = -1.0 / jnp.log(jnp.clip(r, 1e-4, 1 - 1e-6))
        key, kb = jax.random.split(key)
        t1m, t2m, _ = _mcem_block(yf, res.s, res.b, tau1, tau2, sn_use,
                                  kb, p=p, n_inner=n_inner, L=L)
        # M-step: rebuild g from the mean sampled taus, refit constrained
        if p == 1:
            g_new = jnp.exp(-1.0 / jnp.maximum(t2m, 1e-3))[:, None]
        else:
            g_new = exp2ar(jnp.exp(-1.0 / jnp.maximum(t2m, 1e-3)),
                           jnp.exp(-1.0 / jnp.maximum(t1m, 1e-3)))
        res = deconvolve(yf, inner_params, sn=sn, g=g_new)

    return DeconvResult(
        c=res.c.reshape(y.shape), s=res.s.reshape(y.shape),
        b=res.b.reshape(batch), g=res.g,
        lam=res.lam.reshape(batch) if res.lam.ndim else res.lam,
        smin=res.smin.reshape(batch) if res.smin.ndim else res.smin)
