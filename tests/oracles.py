"""Slow, trusted numpy oracles for unit tests.

Independent float64 implementations of the published algorithms (OASIS
pool merging, Friedrich et al. NIPS 2016; AR kernels) used to validate the
batched kernels. Deliberately simple and loop-based.
"""

import numpy as np


def oasis_ar1_oracle(y, g, lam=0.0, smin=0.0):
    """Stack-based OASIS AR(1) in float64. Returns (c, s)."""
    y = np.asarray(y, dtype=np.float64)
    T = len(y)
    # pools as python lists: value v, weight w, start t, length l
    v, w, t, l = [], [], [], []
    vinit = y - lam * (1.0 - g)
    vinit[-1] = y[-1] - lam

    for ti in range(T):
        v.append(vinit[ti]); w.append(1.0); t.append(ti); l.append(1)
        while len(v) >= 2 and (
            v[-1] / w[-1] < max(v[-2] / w[-2], 0.0) * g ** l[-2] + smin
        ):
            # merge last two pools
            gl = g ** l[-2]
            v[-2] += v[-1] * gl
            w[-2] += w[-1] * gl * gl
            l[-2] += l[-1]
            v.pop(); w.pop(); t.pop(); l.pop()

    c = np.zeros(T)
    for vi, wi, ti, li in zip(v, w, t, l):
        val = max(vi / wi, 0.0)
        c[ti:ti + li] = val * g ** np.arange(li)
    s = np.zeros(T)
    s[1:] = c[1:] - g * c[:-1]
    s[s < 1e-12] = 0.0
    # zero out within-pool "spikes" (decay steps produce s ~ 0 already)
    return c, s


def ar1_trace(rng, T, g=0.95, sn=0.3, rate=0.02, amp=1.0, baseline=0.0):
    """Synthetic AR(1) calcium trace with known ground truth."""
    s = (rng.random(T) < rate).astype(np.float64) * (
        amp * (0.5 + rng.random(T)))
    c = np.zeros(T)
    for i in range(T):
        c[i] = (c[i - 1] * g if i else 0.0) + s[i]
    y = c + baseline + sn * rng.standard_normal(T)
    return y, c, s
