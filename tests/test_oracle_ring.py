"""Reference-semantics oracle: per-pixel ring ridge regression.

ORACLE (test-only, deliberately slow): a literal float64 numpy
transliteration of the reference's per-pixel loop in
``endoscope/fit_ring_model.m:92-126`` (ring neighborhood from
``get_nhood.m:1-26``, no-projection branch), asserted near-exactly against
the batched redesign ``ops/ring.py::fit_ring_weights`` /
``fit_ring_model``. This pins the redesign to reference SEMANTICS, not just
to synthetic-ground-truth plausibility (VERDICT r2 missing #1).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cnmf_e_tpu.ops.ring import (RingWeights, apply_ring, fit_ring_model,
                                 fit_ring_weights, ring_offsets)


def _nhood_offsets_oracle(radius):
    """get_nhood.m:1-16 — offsets with euclidean distance in
    [radius, radius+1)."""
    r = radius
    rsub = np.arange(-r - 1, r + 2)
    cind, rind = np.meshgrid(rsub, rsub)
    R = np.sqrt(cind**2 + rind**2)
    sel = (R >= radius) & (R < radius + 1)
    return rind[sel], cind[sel]


def fit_ring_oracle(Bf, radius, ridge_eps=1e-5):
    """fit_ring_model.m:104-126 (else-branch): per-pixel ridge of pixel m's
    Bf row on its in-FOV ring neighbors + an all-ones intercept row,
    ridge = eye * trace(XX') * ridge_eps. Returns (W (d, d), w0 (d,))."""
    T, H, W_ = Bf.shape
    d = H * W_
    B = Bf.reshape(T, d).T.astype(np.float64)          # (d, T) like Bf
    dys, dxs = _nhood_offsets_oracle(radius)
    Wmat = np.zeros((d, d))
    w0 = np.zeros(d)
    for m in range(d):
        y, x = divmod(m, W_)
        ny, nx = y + dys, x + dxs
        ok = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W_)
        ring = (ny[ok] * W_ + nx[ok]).astype(int)
        X = np.concatenate([B[ring], np.ones((1, T))], axis=0)
        XX = X @ X.T
        Xy = X @ B[m]
        w = np.linalg.solve(
            XX + np.eye(len(ring) + 1) * np.trace(XX) * ridge_eps, Xy)
        Wmat[m, ring] = w[:-1]
        w0[m] = w[-1]
    return Wmat, w0


def _dense_from_ringweights(w: RingWeights, H, W_, radius):
    """Expand the (d, R) per-offset weights into a dense (d, d) matrix."""
    offsets = ring_offsets(radius)
    d = H * W_
    dense = np.zeros((d, d))
    wv = np.asarray(w.w)
    for m in range(d):
        y, x = divmod(m, W_)
        for r, (dy, dx) in enumerate(offsets):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W_:
                dense[m, ny * W_ + nx] = wv[m, r]
    return dense


def test_fit_ring_weights_matches_reference_oracle(rng):
    """The batched Cholesky ring fit must reproduce the reference's
    per-pixel ridge solves near-exactly (same ridge scaling, intercept,
    and boundary handling: out-of-FOV neighbors are absent from the
    oracle's solve and ridge-pinned to ~0 in the batched solve — the two
    systems are algebraically identical)."""
    T, H, W_ = 60, 12, 13
    radius = 3
    Bf = rng.standard_normal((T, H, W_)).astype(np.float32) * 0.4
    Bf -= Bf.mean(axis=0, keepdims=True)

    W_ora, w0_ora = fit_ring_oracle(Bf, radius)
    w = fit_ring_weights(jnp.asarray(Bf), H, W_, radius, ridge_eps=1e-5)
    W_jax = _dense_from_ringweights(w, H, W_, radius)

    np.testing.assert_allclose(W_jax, W_ora, atol=2e-4)
    np.testing.assert_allclose(np.asarray(w.w0), w0_ora, atol=2e-4)


def test_fit_ring_model_b0_outlier_clamp_match_oracle(rng):
    """fit_ring_model.m:41-56 — b0 = mean(Y) - A mean(C); Bf centered;
    outliers (Bf > W_old Bf + thresh*sn) replaced by the prediction."""
    T, H, W_ = 50, 10, 11
    radius = 3
    d = H * W_
    K = 2
    Y = (rng.standard_normal((T, H, W_)) * 0.3 + 2.0).astype(np.float32)
    A = np.abs(rng.standard_normal((K, H, W_))).astype(np.float32) * 0.2
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    sn = np.full((H, W_), 0.1, np.float32)

    # previous weights: uniform over in-FOV ring neighbors
    offsets = ring_offsets(radius)
    dys, dxs = offsets[:, 0], offsets[:, 1]
    wv = np.zeros((d, len(offsets)), np.float32)
    for m in range(d):
        y, x = divmod(m, W_)
        ok = ((y + dys >= 0) & (y + dys < H)
              & (x + dxs >= 0) & (x + dxs < W_))
        wv[m, ok] = 1.0 / max(ok.sum(), 1)
    W_old = RingWeights(w=jnp.asarray(wv), w0=jnp.zeros((d,), jnp.float32))

    # oracle (float64): fit_ring_model.m:41-56
    Yd = Y.reshape(T, d).T.astype(np.float64)
    Ad = A.reshape(K, d).T.astype(np.float64)
    Ymean = Yd.mean(axis=1)
    Cmean = C.mean(axis=1).astype(np.float64)
    b0_ora = Ymean - Ad @ Cmean
    Bf = (Yd - Ymean[:, None]) - Ad @ (C.astype(np.float64)
                                       - Cmean[:, None])
    dense_old = _dense_from_ringweights(W_old, H, W_, radius)
    Bf_pred = dense_old @ Bf
    thresh = 10.0
    out = Bf > Bf_pred + thresh * sn.reshape(-1, 1)
    Bf_clamped = np.where(out, Bf_pred, Bf)

    weights, b0, Bf_fit = fit_ring_model(
        jnp.asarray(Y), jnp.asarray(A), jnp.asarray(C), radius=radius,
        W_old=W_old, sn=jnp.asarray(sn), thresh_outlier=thresh,
        frame_cap_factor=100, ridge_eps=1e-5)

    np.testing.assert_allclose(np.asarray(b0).reshape(-1), b0_ora,
                               atol=1e-4)
    # T < 100 * ring size => no frame subsampling: Bf_fit is the clamped
    # centered residual itself
    np.testing.assert_allclose(
        np.asarray(Bf_fit).reshape(T, d).T, Bf_clamped, atol=1e-3)

    # and the fitted weights match an oracle fit of the clamped residual
    W_ora, w0_ora = fit_ring_oracle(
        np.moveaxis(Bf_clamped.reshape(H, W_, T), -1, 0).astype(np.float32),
        radius)
    W_jax = _dense_from_ringweights(weights, H, W_, radius)
    np.testing.assert_allclose(W_jax, W_ora, atol=5e-4)


def test_apply_ring_matches_oracle_dense_product(rng):
    """W @ X evaluated as weighted shifts == dense oracle product."""
    T, H, W_ = 8, 9, 10
    radius = 2
    d = H * W_
    R = ring_offsets(radius).shape[0]
    X = rng.standard_normal((T, H, W_)).astype(np.float32)
    w = RingWeights(
        w=jnp.asarray(rng.standard_normal((d, R)).astype(np.float32) * 0.2),
        w0=jnp.asarray(rng.standard_normal(d).astype(np.float32)))
    # zero the out-of-FOV weights as fit_ring_weights guarantees
    offsets = ring_offsets(radius)
    wv = np.asarray(w.w).copy()
    for m in range(d):
        y, x = divmod(m, W_)
        for r, (dy, dx) in enumerate(offsets):
            if not (0 <= y + dy < H and 0 <= x + dx < W_):
                wv[m, r] = 0.0
    w = RingWeights(w=jnp.asarray(wv), w0=w.w0)

    dense = _dense_from_ringweights(w, H, W_, radius)
    ref = (dense @ X.reshape(T, d).T).T.reshape(T, H, W_) \
        + np.asarray(w.w0).reshape(H, W_)
    out = apply_ring(w, jnp.asarray(X), H, W_, radius)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)


@pytest.mark.parametrize("radius,H,W_", [(1, 7, 5), (2, 9, 13),
                                         (3, 11, 8), (4, 13, 17)])
def test_apply_ring_matches_float64_oracle_ragged(radius, H, W_):
    """apply_ring (the one ring-apply path) against the float64 dense
    ring operator built by the reference's own neighborhood rule
    (get_nhood.m), on odd and ragged fields of view where many ring
    taps fall outside the frame."""
    rng = np.random.default_rng(radius * 100 + H)
    T = 6
    d = H * W_
    dys, dxs = _nhood_offsets_oracle(radius)
    X = rng.standard_normal((T, H, W_))
    Wd = np.zeros((d, d))
    for m in range(d):
        y, x = divmod(m, W_)
        ny, nx = y + dys, x + dxs
        ok = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W_)
        Wd[m, ny[ok] * W_ + nx[ok]] = rng.standard_normal(ok.sum()) * 0.3
    w0 = rng.standard_normal(d)
    ref = (Wd @ X.reshape(T, d).T).T.reshape(T, H, W_) + w0.reshape(H, W_)
    # pack the dense operator into the (d, R) per-offset layout
    offsets = ring_offsets(radius)
    wv = np.zeros((d, offsets.shape[0]), np.float32)
    for m in range(d):
        y, x = divmod(m, W_)
        for r, (dy, dx) in enumerate(offsets):
            if 0 <= y + dy < H and 0 <= x + dx < W_:
                wv[m, r] = Wd[m, (y + dy) * W_ + x + dx]
    w = RingWeights(w=jnp.asarray(wv), w0=jnp.asarray(w0, jnp.float32))
    out = apply_ring(w, jnp.asarray(X, jnp.float32), H, W_, radius)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)
