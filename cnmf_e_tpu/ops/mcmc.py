"""Bayesian spike inference by MCMC.

Reference: ``OASIS_matlab/packages/MCMC/cont_ca_sampler.m`` — continuous-time
Gibbs + HMC sampling of spike times with marginalized baseline/amplitude and
time-constant resampling (``cont_ca_sampler.m:1-40``, ``utilities/``).

Batched re-design: discrete-time Metropolis-within-Gibbs over spike vectors,
fully vectorized across traces (and trivially across chains by stacking).
Each sweep runs, per trace:

  * a birth/death MH move on the spike support (add a spike at a random bin
    with an Exp-prior amplitude proposal, or remove a random existing
    spike), accepted by the exact likelihood ratio from an O(L) local
    residual update;
  * a spike time-shift MH move: one existing spike is proposed to move by
    d in {-2,-1,+1,+2} bins keeping its amplitude — the discrete analog of
    the reference's continuous spike-time updates; without it a spike born
    a bin or two off the likelihood mode cannot walk there;
  * a Rao-Blackwellized amplitude move: one randomly chosen existing spike
    has its amplitude resampled from its EXACT truncated-Gaussian full
    conditional (Gaussian likelihood x Exp prior) — the discrete-time
    analog of the reference's marginalized-amplitude updates;
  * an exact baseline Gibbs draw b ~ N(mean(y - conv(s, h)), sn^2 / T)
    (the reference marginalizes the baseline);
  * a time-constant MH move: random walk on log tau (AR(1)) or on the two
    exponential decay rates (AR(2)), with the kernel and full residual
    rebuilt on acceptance (``cont_ca_sampler.m`` resamples time constants).

The chain runs in fixed-size jitted blocks (static shapes); the adaptive
driver :func:`mcmc_spikes_adaptive` keeps running blocks until a Geweke-style
split-mean z-score on the spike-count trace says the chain has converged —
replacing the reference's fixed sweep count with an actual diagnostic.

Model:  y = b + conv(s, h) + eps,  eps ~ N(0, sn^2),
        s_t ~ spike-and-slab: P(s_t > 0) = p_spike, amplitude ~ Exp(1/mu_a).

Grid-time bias vs the reference's continuous-time spikes (quantified,
round 5; ``scripts_dev/mcmc_grid_bias.py`` + ``tests/test_mcmc.py::
test_mcmc_grid_time_bias_below_one_frame``): a spike at continuous time
n + phi registers at bin n + 1 with amplitude rescaled by the kernel —
for AR(1) this is an EXACT likelihood degeneracy (h(u) = g^u, so
a * h(t - n - phi) = a g^(1-phi) * h(t - n - 1) for every integer
t >= n + 1), and for fast-rise AR(2) kernels the residual shape
difference sits below the noise. Measured on off-grid AR(2) spikes
(phi in {0.25, 0.5, 0.75}, 72 events, 12 chains): timing error =
(1 - phi) frames exactly (bias +0.75/+0.50/+0.25, std <= 0.003), i.e.
|bias| < 1 frame always, 0.5 frames mean under uniform phi, and the
POSTERIOR concentrates (it does not split mass across neighboring bins)
— so fractional-offset refinement cannot be recovered from the
likelihood for these kernels and is not implemented; downstream
consumers should treat spike times as right-edge-of-frame quantized.
(Reference: ``packages/MCMC/cont_ca_sampler.m:1-40``.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cnmf_e_tpu.ops.ar import ar_kernel


class MCMCResult(NamedTuple):
    spike_prob: jnp.ndarray    # (..., T) posterior spike probability
    spike_mean: jnp.ndarray    # (..., T) posterior mean spike amplitude
    c_mean: jnp.ndarray        # (..., T) posterior mean denoised trace
    b_mean: jnp.ndarray        # (...,) posterior mean baseline
    n_accept: jnp.ndarray      # (...,) accepted moves (diagnostics)
    g_mean: jnp.ndarray        # (..., p) posterior mean AR coefficients
    geweke_z: jnp.ndarray      # (...,) split-mean convergence z-score


class _Chain(NamedTuple):
    s: jnp.ndarray       # (N, T) spike amplitudes
    b: jnp.ndarray       # (N,) baseline
    g: jnp.ndarray       # (N, p) AR coefficients
    h: jnp.ndarray       # (N, L) current kernel
    resid: jnp.ndarray   # (N, T) y - b - conv(s, h)
    acc: jnp.ndarray     # (N,) accepted moves


def _full_resid(y, s, b, h):
    T = y.shape[-1]
    conv = jax.vmap(lambda sv, hv: jnp.convolve(sv, hv, mode="full")[:T])(
        s, h)
    return y - b[:, None] - conv


@functools.partial(jax.jit, static_argnames=("n_sweeps", "sample_g"))
def _mcmc_block(chain: _Chain, key, y, sn, mu_amp, p_spike,
                n_sweeps: int, sample_g: bool):
    """Run ``n_sweeps`` sweeps; returns (chain, sums, count_hist) where
    sums = (sum_on, sum_s, sum_b, sum_g) accumulated over the block and
    count_hist is the per-sweep spike count (n_sweeps, N) for the Geweke
    diagnostic."""
    N, T = y.shape
    L = chain.h.shape[-1]
    log_prior_on = jnp.log(p_spike / (1 - p_spike))
    inv_var = 1.0 / jnp.maximum(sn * sn, 1e-12)

    def conv_tail(t_idx):
        return t_idx[:, None] + jnp.arange(L)[None, :]      # (N, L)

    def window(resid, h, t_idx):
        pos = conv_tail(t_idx)
        valid = pos < T
        r_win = jnp.take_along_axis(resid, jnp.minimum(pos, T - 1), axis=1)
        r_win = jnp.where(valid, r_win, 0.0)
        hv = jnp.where(valid, h, 0.0)
        return r_win, hv, pos, valid

    def delta_loglik(resid, h, amp, t_idx):
        """dLL from adding amp*h at bin t:
        (a <r, h> - a^2 hh / 2) / sn^2 over the valid window."""
        r_win, hv, _, _ = window(resid, h, t_idx)
        rh = jnp.sum(r_win * hv, axis=-1)
        hh_v = jnp.sum(hv * hv, axis=-1)
        return (amp * rh - 0.5 * amp * amp * hh_v) * inv_var

    def apply_spike(resid, h, amp, t_idx):
        pos = conv_tail(t_idx)
        valid = pos < T
        upd = jnp.where(valid, amp[:, None] * h, 0.0)
        return resid - jnp.zeros_like(resid).at[
            jnp.arange(N)[:, None], jnp.minimum(pos, T - 1)].add(upd)

    def pick_existing(s, u):
        """Index of a uniformly random existing spike (per trace)."""
        n_spk = jnp.sum(s > 0, axis=-1)
        csum = jnp.cumsum((s > 0).astype(y.dtype), axis=-1)
        target = jnp.ceil(u * jnp.maximum(n_spk, 1)).astype(y.dtype)
        idx = jnp.argmax((csum >= target[:, None]).astype(jnp.int8), axis=-1)
        return idx, n_spk

    def sweep(carry, key):
        s, b, g, h, resid, acc = carry
        ks = jax.random.split(key, 13)

        # ---- birth/death MH on the spike support ----------------------- #
        move = jax.random.randint(ks[0], (N,), 0, 2)
        t_prop = jax.random.randint(ks[1], (N,), 0, T)
        amp = jax.random.exponential(ks[2], (N,)) * mu_amp
        occupied = jnp.take_along_axis(s, t_prop[:, None], axis=1)[:, 0] > 0
        log_alpha_birth = delta_loglik(resid, h, amp, t_prop) + log_prior_on

        t_del, n_spk = pick_existing(s, jax.random.uniform(ks[3], (N,)))
        amp_del = jnp.take_along_axis(s, t_del[:, None], axis=1)[:, 0]
        log_alpha_death = (delta_loglik(resid, h, -amp_del, t_del)
                           - log_prior_on)

        logu = jnp.log(jax.random.uniform(ks[4], (N,)) + 1e-12)
        do_birth = (move == 0) & ~occupied & (logu < log_alpha_birth)
        do_death = (move == 1) & (n_spk > 0) & (logu < log_alpha_death)

        s = s.at[jnp.arange(N), t_prop].add(jnp.where(do_birth, amp, 0.0))
        resid = apply_spike(resid, h, jnp.where(do_birth, amp, 0.0), t_prop)
        s = s.at[jnp.arange(N), t_del].add(
            jnp.where(do_death, -amp_del, 0.0))
        resid = apply_spike(resid, h,
                            jnp.where(do_death, -amp_del, 0.0), t_del)

        # ---- time-shift MH on one existing spike ------------------------ #
        t_mv, n_spk_mv = pick_existing(s, jax.random.uniform(ks[10], (N,)))
        a_mv = jnp.take_along_axis(s, t_mv[:, None], axis=1)[:, 0]
        dshift = jnp.asarray([-2, -1, 1, 2])[
            jax.random.randint(ks[11], (N,), 0, 4)]
        t_new = t_mv + dshift
        in_range = (t_new >= 0) & (t_new < T)
        t_new = jnp.clip(t_new, 0, T - 1)
        vacant = jnp.take_along_axis(s, t_new[:, None], axis=1)[:, 0] <= 0
        ok = (n_spk_mv > 0) & in_range & vacant
        a_eff = jnp.where(ok, a_mv, 0.0)
        dll_rm = delta_loglik(resid, h, -a_eff, t_mv)
        resid_rm = apply_spike(resid, h, -a_eff, t_mv)
        dll_add = delta_loglik(resid_rm, h, a_eff, t_new)
        logu_mv = jnp.log(jax.random.uniform(ks[12], (N,)) + 1e-12)
        do_move = ok & (logu_mv < dll_rm + dll_add)
        amp_apply = jnp.where(do_move, a_eff, 0.0)
        s = s.at[jnp.arange(N), t_mv].add(-amp_apply)
        s = s.at[jnp.arange(N), t_new].add(amp_apply)
        resid_moved = apply_spike(resid_rm, h, a_eff, t_new)
        resid = jnp.where(do_move[:, None], resid_moved, resid)

        # ---- Rao-Blackwellized amplitude Gibbs on one existing spike --- #
        t_amp, n_spk = pick_existing(s, jax.random.uniform(ks[5], (N,)))
        a_old = jnp.take_along_axis(s, t_amp[:, None], axis=1)[:, 0]
        has = n_spk > 0
        # residual with this spike removed: r+ = resid + a_old * h|window
        r_win, hv, _, _ = window(resid, h, t_amp)
        hh_v = jnp.maximum(jnp.sum(hv * hv, axis=-1), 1e-12)
        rh_plus = jnp.sum(r_win * hv, axis=-1) + a_old * hh_v
        # N(mean, var) x Exp(1/mu) truncated at 0
        var_c = 1.0 / (hh_v * inv_var)
        mean_c = (rh_plus * inv_var - 1.0 / mu_amp) * var_c
        sd_c = jnp.sqrt(var_c)
        lo = jax.scipy.stats.norm.cdf(-mean_c / sd_c)
        u = jax.random.uniform(ks[6], (N,),
                               minval=jnp.minimum(lo, 1.0 - 1e-6),
                               maxval=1.0 - 1e-7)
        a_new = mean_c + sd_c * jax.scipy.special.ndtri(u)
        a_new = jnp.where(has, jnp.maximum(a_new, 1e-8), a_old)
        s = s.at[jnp.arange(N), t_amp].set(
            jnp.where(has, a_new, a_old))
        resid = apply_spike(resid, h, jnp.where(has, a_new - a_old, 0.0),
                            t_amp)

        # ---- exact baseline Gibbs --------------------------------------- #
        db_mean = jnp.mean(resid, axis=-1)
        db = db_mean + (sn / jnp.sqrt(jnp.float32(T))
                        * jax.random.normal(ks[7], (N,)))
        b = b + db
        resid = resid - db[:, None]

        # ---- time-constant MH (random walk on decay rates) -------------- #
        # The multiplicative log-space walk (tau_p = tau * exp(eps)) is a
        # symmetric proposal in log-tau, so accepting on the bare
        # likelihood ratio implies a flat prior on log(tau) (log-uniform
        # on tau) — stated here explicitly. Proposals that would cross
        # the support bounds are REJECTED rather than clipped: clipping
        # would concentrate proposal mass on the boundary and break the
        # q(tau'|tau) = q(tau|tau') symmetry the bare ratio relies on.
        if sample_g:
            if g.shape[-1] == 1:
                # log-tau random walk: tau = -1/log(g)
                g0 = jnp.clip(g[:, 0], 1e-4, 1.0 - 1e-6)
                tau = -1.0 / jnp.log(g0)
                tau_p = tau * jnp.exp(
                    0.05 * jax.random.normal(ks[8], (N,)))
                in_bounds = tau_p >= 0.2
                g_prop = jnp.exp(-1.0 / jnp.maximum(tau_p, 0.2))[:, None]
            else:
                from cnmf_e_tpu.ops.ar import ar2exp, exp2ar
                d, r = ar2exp(g)
                eps = 0.05 * jax.random.normal(ks[8], (N, 2))
                d_raw = d * jnp.exp(eps[:, 0])
                r_raw = r * jnp.exp(eps[:, 1])
                in_bounds = ((d_raw >= 1e-3) & (d_raw <= 1 - 1e-4)
                             & (r_raw >= 1e-4) & (r_raw <= 1 - 1e-4)
                             & (r_raw <= d_raw * (1 - 1e-3)))
                d_p = jnp.clip(d_raw, 1e-3, 1 - 1e-4)
                r_p = jnp.clip(r_raw, 1e-4, 1 - 1e-4)
                r_p = jnp.minimum(r_p, d_p * (1 - 1e-3))
                g_prop = exp2ar(d_p, r_p)
            h_prop = ar_kernel(g_prop, L).astype(y.dtype)
            resid_prop = _full_resid(y, s, b, h_prop)
            dll_g = -0.5 * inv_var * (
                jnp.sum(resid_prop * resid_prop, axis=-1)
                - jnp.sum(resid * resid, axis=-1))
            logu_g = jnp.log(jax.random.uniform(ks[9], (N,)) + 1e-12)
            take_g = (logu_g < dll_g) & in_bounds
            g = jnp.where(take_g[:, None], g_prop, g)
            h = jnp.where(take_g[:, None], h_prop, h)
            resid = jnp.where(take_g[:, None], resid_prop, resid)
        else:
            take_g = jnp.zeros((N,), bool)

        acc = acc + (do_birth | do_death | do_move | take_g).astype(
            jnp.int32)
        count = jnp.sum(s > 0, axis=-1).astype(jnp.int32)
        return ((s, b, g, h, resid, acc),
                ((s > 0).astype(y.dtype), s, b, g, count))

    keys = jax.random.split(key, n_sweeps)
    carry0 = (chain.s, chain.b, chain.g, chain.h, chain.resid, chain.acc)
    carry, (on_h, s_h, b_h, g_h, count_h) = jax.lax.scan(sweep, carry0, keys)
    s, b, g, h, resid, acc = carry
    sums = (jnp.sum(on_h, axis=0), jnp.sum(s_h, axis=0),
            jnp.sum(b_h, axis=0), jnp.sum(g_h, axis=0))
    return _Chain(s=s, b=b, g=g, h=h, resid=resid, acc=acc), sums, count_h


def _init_chain(y, g, sn, kernel_len):
    N, T = y.shape
    if g.ndim == 1:
        g = g[:, None]
    L = min(kernel_len, T)
    h = ar_kernel(g, L).astype(y.dtype)
    s0 = jnp.zeros((N, T), y.dtype)
    b0 = jnp.median(y, axis=-1)
    return _Chain(s=s0, b=b0, g=g, h=h, resid=y - b0[:, None],
                  acc=jnp.zeros(N, jnp.int32))


def _geweke_z(counts):
    """Split-mean z-score on the (n, N) spike-count trace: first half vs
    second half of the post-burn samples (|z| < 2 ~= converged).

    Computed HOST-SIDE in numpy: the count history is tiny, and its length
    grows every adaptive block — a jnp version would compile a fresh
    program per block shape."""
    import numpy as np
    counts = np.asarray(counts, np.float32)
    n = counts.shape[0]
    a, b = counts[: n // 2], counts[n // 2:]
    va = np.var(a, axis=0) / a.shape[0]
    vb = np.var(b, axis=0) / b.shape[0]
    return (np.mean(a, axis=0) - np.mean(b, axis=0)) / \
        np.sqrt(np.maximum(va + vb, 1e-12))


def _finalize(y, chain, sums, counts, n_samples):
    sum_on, sum_s, sum_b, sum_g = sums
    T = y.shape[-1]
    spike_prob = sum_on / n_samples
    spike_mean = sum_s / n_samples
    b_mean = sum_b / n_samples
    g_mean = sum_g / n_samples
    c_mean = jax.vmap(lambda sv, hv: jnp.convolve(sv, hv, mode="full")[:T])(
        spike_mean, chain.h)
    return MCMCResult(spike_prob=spike_prob, spike_mean=spike_mean,
                      c_mean=c_mean, b_mean=b_mean, n_accept=chain.acc,
                      g_mean=g_mean, geweke_z=_geweke_z(counts))


def mcmc_spikes(y: jnp.ndarray, g: jnp.ndarray, sn: jnp.ndarray,
                key: Optional[jax.Array] = None, n_iter: int = 400,
                n_burn: int = 100, p_spike: float = 0.01,
                mu_amp: Optional[jnp.ndarray] = None,
                kernel_len: int = 200,
                sample_g: bool = True) -> MCMCResult:
    """Sample spike trains. y: (N, T); g: (N,) or (N, p); sn: (N,).

    Runs ``n_burn`` burn-in sweeps then ``n_iter - n_burn`` sampling sweeps
    (two fixed-shape block programs). ``sample_g`` enables the
    time-constant MH moves."""
    if key is None:
        key = jax.random.PRNGKey(0)
    y = jnp.asarray(y)
    chain = _init_chain(y, jnp.asarray(g), jnp.asarray(sn), kernel_len)
    if mu_amp is None:
        mu_amp = jnp.maximum(jnp.max(y, axis=-1) * 0.5, 1e-3)
    k_burn, k_samp = jax.random.split(key)
    if n_burn > 0:
        chain, _, _ = _mcmc_block(chain, k_burn, y, sn, mu_amp, p_spike,
                                  n_sweeps=n_burn, sample_g=sample_g)
    n_samp = max(n_iter - n_burn, 1)
    chain, sums, counts = _mcmc_block(chain, k_samp, y, sn, mu_amp, p_spike,
                                      n_sweeps=n_samp, sample_g=sample_g)
    return _finalize(y, chain, sums, counts, n_samp)


def mcmc_spikes_adaptive(y: jnp.ndarray, g: jnp.ndarray, sn: jnp.ndarray,
                         key: Optional[jax.Array] = None, block: int = 250,
                         max_blocks: int = 12, z_thresh: float = 2.0,
                         p_spike: float = 0.01,
                         mu_amp: Optional[jnp.ndarray] = None,
                         kernel_len: int = 200,
                         sample_g: bool = True) -> MCMCResult:
    """Convergence-driven sampler: burn one block, then keep sampling
    fixed-size blocks (one compiled program) until the Geweke split-mean
    z-score of every trace's spike-count history is below ``z_thresh``
    (or ``max_blocks`` is hit). Replaces the reference's fixed 400 sweeps
    (``cont_ca_sampler.m``) with an actual diagnostic."""
    import numpy as np
    if key is None:
        key = jax.random.PRNGKey(0)
    y = jnp.asarray(y)
    chain = _init_chain(y, jnp.asarray(g), jnp.asarray(sn), kernel_len)
    if mu_amp is None:
        mu_amp = jnp.maximum(jnp.max(y, axis=-1) * 0.5, 1e-3)
    key, kb = jax.random.split(key)
    chain, _, _ = _mcmc_block(chain, kb, y, sn, mu_amp, p_spike,
                              n_sweeps=block, sample_g=sample_g)
    sums = None
    all_counts = []
    n_samples = 0
    for _ in range(max_blocks):
        key, kb = jax.random.split(key)
        chain, bsums, counts = _mcmc_block(chain, kb, y, sn, mu_amp,
                                           p_spike, n_sweeps=block,
                                           sample_g=sample_g)
        sums = bsums if sums is None else tuple(
            a + b for a, b in zip(sums, bsums))
        all_counts.append(np.asarray(counts))
        n_samples += block
        z = _geweke_z(np.concatenate(all_counts, axis=0))
        if float(np.max(np.abs(z))) < z_thresh:
            break
    return _finalize(y, chain, sums,
                     np.concatenate(all_counts, axis=0), n_samples)
