"""cnmf_e_tpu — Constrained NMF for micro-endoscopic calcium imaging.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of zhoupc/CNMF_E
(MATLAB). The movie Y (pixels x frames) is factorized as

    Y ~= A @ C + B + E

with nonnegative, localized spatial footprints ``A``, temporal traces ``C``
(denoised by AR-model spike deconvolution), and a background ``B`` that is
either a ring-weighted local regression (1p data) or a low-rank factor (2p).

Design principles (vs the MATLAB reference, see SURVEY.md):
  * immutable pytree model state + pure update functions (no handle classes)
  * full-FOV arrays sharded over a ``(patch, frame)`` device mesh; XLA SPMD
    inserts halo exchanges for the stencil ops (instead of blocked .mat files
    and parfor patch loops)
  * fixed-capacity neuron slots with validity masks (static shapes under jit)
  * batched solvers: thousands of tiny ridge/NNLS/OASIS problems vectorized
    over pixels / neurons instead of MATLAB per-element loops
"""

__version__ = "0.1.0"

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, DeconvParams,
                               InitParams, MergeParams, SpatialParams,
                               TemporalParams)


def __getattr__(name):
    # lazy imports keep `import cnmf_e_tpu` light (no jax compile at import)
    if name == "CNMFE":
        from cnmf_e_tpu.models.pipeline import CNMFE
        return CNMFE
    if name == "CNMF":
        from cnmf_e_tpu.models.cnmf2p import CNMF
        return CNMF
    if name == "fit_batches":
        from cnmf_e_tpu.models.batch import fit_batches
        return fit_batches
    if name == "fit_streaming":
        from cnmf_e_tpu.models.streaming import fit_streaming
        return fit_streaming
    raise AttributeError(name)


__all__ = [
    "CNMFEParams", "DeconvParams", "InitParams", "BackgroundParams",
    "MergeParams", "SpatialParams", "TemporalParams",
    "CNMFE", "CNMF", "fit_batches", "fit_streaming", "__version__",
]
