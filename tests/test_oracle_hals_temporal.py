"""Reference-semantics oracle: HALS temporal coordinate descent.

ORACLE (test-only, deliberately slow): literal float64 numpy
transliterations of ``utilities/HALS_temporal.m:58-107``, asserted against
the batched redesign (``ops/hals.py::hals_temporal_sweeps`` +
``ops/stats.py::submedian_mean``). Pins the redesign to reference
semantics (VERDICT r2 missing #1).

Scope notes (documented deviations, both asserted below):
  * the per-neuron coordinate update c_k <- c_k + (U_k - V_k C)/aa_k is
    matched EXACTLY (same Gauss-Seidel order, U frozen across sweeps);
  * the reference's no-deconv branch subtracts each trace's min INSIDE
    the sweep (HALS_temporal.m:66-68); the redesign baselines after the
    sweeps (its deconv path batches deconvolution over neurons instead of
    folding it per neuron). The composed results are asserted
    near-identical on realistic data;
  * the baseline estimator b = mean(c(c < median(c)))
    (HALS_temporal.m:79) is matched by submedian_mean up to the bisection
    median's resolution.
"""

import numpy as np
import jax.numpy as jnp

from cnmf_e_tpu.ops.hals import hals_temporal_sweeps
from cnmf_e_tpu.ops.stats import submedian_mean


def hals_temporal_oracle(U, V, C, n_iter, subtract_min=False):
    """HALS_temporal.m:58-107 inner loop (float64). ``subtract_min``
    replicates the no-deconv branch's in-loop min subtraction."""
    U = U.astype(np.float64)
    V = V.astype(np.float64)
    C = C.astype(np.float64).copy()
    aa = np.diag(V)
    for _ in range(n_iter):
        for k in range(C.shape[0]):
            if aa[k] <= 0:
                continue
            ck = C[k] + (U[k] - V[k] @ C) / aa[k]
            if subtract_min:
                ck = ck - ck.min()
            C[k] = ck
    return C


def _problem(rng, K=7, T=120, d=60):
    A = np.abs(rng.standard_normal((d, K))).astype(np.float32)
    C_true = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    Y = (A @ C_true + 0.05 * rng.standard_normal((d, T))).astype(np.float32)
    U = (A.T @ Y).astype(np.float32)
    V = (A.T @ A).astype(np.float32)
    C0 = np.maximum(C_true + 0.3 * rng.standard_normal((K, T)), 0.0) \
        .astype(np.float32)
    return U, V, C0


def test_sweeps_match_oracle_exactly(rng):
    """Pure coordinate sweeps (the shared core of both branches) must
    match the per-neuron MATLAB loop to float32 round-off."""
    U, V, C0 = _problem(rng)
    ora = hals_temporal_oracle(U, V, C0, n_iter=3)
    out = np.asarray(hals_temporal_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0), n_iter=3))
    np.testing.assert_allclose(out, ora, rtol=1e-4, atol=1e-4)


def test_composed_update_matches_min_subtracting_oracle(rng):
    """The redesign (sweeps, then baseline at the end) vs the reference
    no-deconv branch (min subtracted inside the sweep): near-identical
    traces after both are re-baselined — the in-loop shift only moves the
    constant the cross-terms see."""
    U, V, C0 = _problem(rng)
    ora = hals_temporal_oracle(U, V, C0, n_iter=3, subtract_min=True)
    out = np.asarray(hals_temporal_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0), n_iter=3))
    # compare after removing each trace's min (the oracle's convention)
    out = out - out.min(axis=1, keepdims=True)
    ora = ora - ora.min(axis=1, keepdims=True)
    for k in range(out.shape[0]):
        cc = np.corrcoef(out[k], ora[k])[0, 1]
        assert cc > 0.999, (k, cc)
    np.testing.assert_allclose(out, ora, atol=0.15 * np.abs(ora).max())


def test_zero_norm_neurons_skipped_like_reference(rng):
    """HALS_temporal.m:51 — neurons with aa == 0 are not updated."""
    U, V, C0 = _problem(rng, K=4)
    V[2, :] = V[:, 2] = 0.0
    ora = hals_temporal_oracle(U, V, C0, n_iter=2)
    out = np.asarray(hals_temporal_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0), n_iter=2))
    np.testing.assert_allclose(out[2], C0[2], atol=1e-6)
    np.testing.assert_allclose(out, ora, rtol=1e-4, atol=1e-4)


def test_submedian_baseline_matches_reference_estimator(rng):
    """b = mean(c(c < median(c))) (HALS_temporal.m:79) == submedian_mean
    up to the value-space bisection's resolution."""
    x = (rng.standard_normal((16, 501)) * 1.3 + 0.7).astype(np.float32)
    ora = np.array([row[row < np.median(row)].mean() for row in x])
    out = np.asarray(submedian_mean(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(out, ora, rtol=1e-3, atol=1e-3)
