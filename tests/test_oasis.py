import numpy as np
import jax.numpy as jnp
import scipy.optimize

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops.oasis import (constrained_ar1, deconvolve, foopsi_ar1,
                                  oasis_ar1, thresholded_ar1)
from tests.oracles import ar1_trace, oasis_ar1_oracle


def test_oasis_matches_oracle(rng):
    g = 0.92
    for lam, smin in [(0.0, 0.0), (0.5, 0.0), (0.0, 0.6), (0.3, 0.4)]:
        y, _, _ = ar1_trace(rng, 400, g=g, sn=0.3)
        c_ref, s_ref = oasis_ar1_oracle(y, g, lam=lam, smin=smin)
        c, s = oasis_ar1(jnp.asarray(y, jnp.float32), g, lam, smin)
        np.testing.assert_allclose(np.asarray(c), c_ref, atol=2e-3,
                                   err_msg=f"lam={lam} smin={smin}")


def test_oasis_divide_and_conquer_matches_sequential(rng):
    """The chunked fast path must agree with the sequential event loop: it
    is exact for smin=0 by PAVA confluence, and smin > 0 runs the
    sequential loop whatever the chunk size."""
    g = 0.93
    y, _, _ = ar1_trace(rng, 1024, g=g, sn=0.25, rate=0.03)
    # smin = 0: exact agreement (convex problem, confluent merging)
    c_ref, _ = oasis_ar1(jnp.asarray(y, jnp.float32), g, 0.1, 0.0, chunk=0)
    c_dc, _ = oasis_ar1(jnp.asarray(y, jnp.float32), g, 0.1, 0.0, chunk=128)
    np.testing.assert_allclose(np.asarray(c_dc), np.asarray(c_ref),
                               atol=2e-3)
    # smin > 0: merge order matters, so both take the sequential loop
    c_ref, _ = oasis_ar1(jnp.asarray(y, jnp.float32), g, 0.0, 0.6, chunk=0)
    c_dc, _ = oasis_ar1(jnp.asarray(y, jnp.float32), g, 0.0, 0.6, chunk=128)
    cc = np.corrcoef(np.asarray(c_dc), np.asarray(c_ref))[0, 1]
    assert cc > 0.995, cc
    np.testing.assert_array_equal(np.asarray(c_dc), np.asarray(c_ref))


def test_oasis_batched_equals_single(rng):
    g = 0.9
    ys = np.stack([ar1_trace(rng, 300, g=g)[0] for _ in range(5)])
    c_b, s_b = oasis_ar1(jnp.asarray(ys, jnp.float32), g, 0.2, 0.0)
    for i in range(5):
        c_i, _ = oasis_ar1(jnp.asarray(ys[i], jnp.float32), g, 0.2, 0.0)
        np.testing.assert_allclose(np.asarray(c_b[i]), np.asarray(c_i),
                                   atol=1e-5)


def test_oasis_is_qp_solution(rng):
    """With smin=0 OASIS solves min 1/2||c-y||^2 + lam*sum(s), s>=0, exactly.

    Check against an L-BFGS-B solve over the spike variables in float64.
    """
    g, lam, T = 0.9, 0.4, 120
    y, _, _ = ar1_trace(rng, T, g=g, sn=0.25)
    c, s = oasis_ar1(jnp.asarray(y, jnp.float32), g, lam, 0.0)

    # parameterize c = H s (H lower-triangular toeplitz of g powers) with the
    # initial value s_0 = c_0 free (>= 0)
    H = np.tril(g ** (np.subtract.outer(np.arange(T), np.arange(T))))

    def obj(svec):
        cc = H @ svec
        # l1 applies to s_1.. (reference folds s_0 too via (1-g); replicate
        # the oasis objective: penalty lam * sum_t (c_t - g c_{t-1}) with
        # c_{-1}=0 equals lam * sum(svec)
        return 0.5 * np.sum((cc - y) ** 2) + lam * np.sum(svec)

    def grad(svec):
        cc = H @ svec
        return H.T @ (cc - y) + lam

    x0 = np.maximum(np.asarray(s, np.float64), 0.0)
    x0[0] = max(float(c[0]), 0.0)
    res = scipy.optimize.minimize(obj, x0, jac=grad, method="L-BFGS-B",
                                  bounds=[(0, None)] * T,
                                  options={"maxiter": 2000, "ftol": 1e-14})
    s_full = np.asarray(s, np.float64).copy()
    s_full[0] = float(c[0])
    np.testing.assert_allclose(obj(s_full), res.fun, rtol=1e-4, atol=1e-3)


def test_foopsi_noise_floor(rng):
    g = 0.95
    ys = np.stack([ar1_trace(rng, 2000, g=g, sn=0.3, baseline=1.0)[0]
                   for _ in range(4)])
    cs = np.stack([ar1_trace(rng, 2000, g=g, sn=0.3, baseline=1.0)[1]
                   for _ in range(4)])
    out = foopsi_ar1(jnp.asarray(ys, jnp.float32), g, smin=-3.0,
                     optimize_b=True)
    assert out.c.shape == ys.shape
    # baseline should be near 1.0 (b = mean(y - c) has a known upward bias
    # from unexplained transients, same as the reference)
    np.testing.assert_allclose(np.asarray(out.b), 1.0, atol=0.4)


def test_foopsi_recovers_trace(rng):
    g = 0.95
    y, c_true, s_true = ar1_trace(rng, 3000, g=g, sn=0.2, rate=0.03)
    out = foopsi_ar1(jnp.asarray(y, jnp.float32), g, smin=-3.0,
                     optimize_b=True)
    c = np.asarray(out.c)
    corr = np.corrcoef(c, c_true)[0, 1]
    assert corr > 0.96, corr


def test_constrained_hits_noise_budget(rng):
    g = 0.9
    y, c_true, _ = ar1_trace(rng, 2000, g=g, sn=0.4, rate=0.03)
    sn = jnp.asarray([0.4], jnp.float32)
    out = constrained_ar1(jnp.asarray(y[None], jnp.float32), g, sn=sn,
                          optimize_b=False)
    rss = float(np.sum((y - np.asarray(out.c[0])) ** 2))
    target = 0.4 ** 2 * 2000
    assert rss < 1.6 * target
    corr = np.corrcoef(np.asarray(out.c[0]), c_true)[0, 1]
    assert corr > 0.94


def test_thresholded_kills_small_noise_spikes(rng):
    g = 0.9
    # pure noise in, almost no spikes out
    y = 0.3 * rng.standard_normal(1500)
    out = thresholded_ar1(jnp.asarray(y[None], jnp.float32), g,
                          sn=jnp.asarray([0.3], jnp.float32),
                          optimize_b=False)
    s = np.asarray(out.s[0])
    assert (s > 0).sum() < 60  # < 4% of bins carry spurious spikes


def test_deconvolve_dispatch(rng):
    y, c_true, _ = ar1_trace(rng, 1500, g=0.93, sn=0.25, baseline=0.5)
    yb = jnp.asarray(np.stack([y, y]), jnp.float32)
    for method in ("foopsi", "constrained", "thresholded"):
        params = DeconvParams(method=method, smin=-2.0)
        out = deconvolve(yb, params)
        c = np.asarray(out.c)
        assert c.shape == yb.shape
        corr = np.corrcoef(c[0], c_true)[0, 1]
        assert corr > 0.9, (method, corr)


def test_optimize_g_recovers_coefficient(rng):
    from cnmf_e_tpu.ops.oasis import optimize_g
    g_true = 0.9
    ys = np.stack([ar1_trace(rng, 1500, g=g_true, sn=0.15, rate=0.04)[0]
                   for _ in range(3)])
    g, c, s = optimize_g(jnp.asarray(ys, jnp.float32),
                         jnp.full((3,), 0.7), smin=0.4)
    np.testing.assert_allclose(np.asarray(g), g_true, atol=0.05)


def test_windowed_long_T_matches_direct(rng):
    """T > 4096 routes through the overlap-windowed solve; it must match
    the direct divide-and-conquer result away from (and at) window seams
    (reference windowing precedent: onnls.m:14-19)."""
    from cnmf_e_tpu.ops.oasis import _oasis_ar1_windowed, oasis_ar1
    K, T, g_true = 3, 9000, 0.95
    C = np.zeros((K, T), np.float32)
    S = (rng.random((K, T)) < 0.02) * rng.uniform(0.5, 1.5, (K, T))
    for t in range(1, T):
        C[:, t] = C[:, t - 1] * g_true + S[:, t]
    y = jnp.asarray(C + 0.1 * rng.standard_normal((K, T)), jnp.float32)
    g = jnp.full((K,), g_true, jnp.float32)
    lam = jnp.full((K,), 0.5, jnp.float32)
    smin = jnp.zeros((K,), jnp.float32)
    cw, sw = _oasis_ar1_windowed(y, g, lam, smin, chunk=128)
    # direct reference: the chunked XLA path on the full trace
    cd, sd = oasis_ar1(y[:, :4096], g, lam, smin, chunk=128)
    np.testing.assert_allclose(np.asarray(cw[:, :3500]),
                               np.asarray(cd[:, :3500]), atol=5e-3)
    # windowed full-length result is finite, nonnegative spikes
    assert bool(jnp.all(jnp.isfinite(cw)))
    assert float(jnp.min(sw)) >= 0.0
    # global fit quality: correlation with ground truth everywhere
    for k in range(K):
        cc = np.corrcoef(np.asarray(cw[k]), C[k])[0, 1]
        assert cc > 0.97, (k, cc)
