"""Typed configuration for the CNMF-E pipeline.

Replaces the flat ~90-parameter options struct of the reference
(``ca_source_extraction/CNMFSetParms.m:9-309`` and the independent parser in
``OASIS_matlab/deconvolveCa.m:208-356``) with per-subsystem frozen dataclasses.
All fields are static (hashable) so a config can be closed over by ``jit``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class DeconvParams:
    """Spike-deconvolution options (reference: ``deconvolveCa.m:108-197``).

    ``model`` in {"ar1", "ar2", "exp2", "kernel"};
    ``method`` in {"foopsi", "constrained", "thresholded"}.
    ``smin < 0`` means the spike-size floor is ``|smin| * sn`` (noise units),
    matching ``foopsi_oasisAR1.m:44-49``.
    """

    enabled: bool = True
    model: str = "ar1"
    method: str = "foopsi"
    smin: float = -5.0
    lam: float = 0.0
    optimize_pars: bool = True
    optimize_b: bool = True
    optimize_g: int = 0
    max_iter: int = 10
    # AR estimation (reference: estimate_time_constant.m)
    ar_lags: int = 5
    fudge_factor: float = 1.0
    # stability clamp on estimated AR roots (wide: slow indicators keep
    # their true decay; the reference only jitters unstable roots)
    g_range: Tuple[float, float] = (0.05, 0.998)
    # bounds on the AR(1) coefficient, exp(-1/tau) with tau in frames
    tau_range: Optional[Tuple[float, float]] = None
    # thresholded-method knobs (thresholded_oasisAR1.m:71-80)
    thresh_factor: float = 1.0
    p_noise: float = 0.9999
    # noise estimation for traces
    sn_method: str = "psd"  # {"psd", "hist", "std"}
    # divide-and-conquer OASIS time-chunk size of the XLA form; 0 = always
    # the sequential event loop. The fast path runs only where smin == 0,
    # where it is exact (PAVA confluence)
    fast_chunk: int = 128


@dataclass(frozen=True)
class InitParams:
    """Greedy Corr+PNR initialization (reference: ``greedyROI_endoscope.m``)."""

    # gaussian width of a typical neuron soma (pixels); 0 disables filtering
    gSig: float = 3.0
    # half-size of the bounding box of one neuron (pixels)
    gSiz: int = 13
    # center-surround (annulus-subtracted) PSF for 1p data
    center_psf: bool = True
    min_corr: float = 0.8
    min_pnr: float = 8.0
    # relaxed thresholds for the residual pick pass (demo_large_data_1p.m)
    min_corr_res: float = 0.7
    min_pnr_res: float = 6.0
    # minimum number of nonzero pixels per neuron
    min_pixel: int = 8
    # boundary width to exclude from seed search
    bd: int = 0
    # spatial / temporal downsampling factors
    ssub: int = 1
    tsub: int = 1
    # max number of neurons (fixed capacity of the state); None = auto
    max_neurons: int = 256
    # seeds extracted per peel round (batched greedy; the reference peels one
    # seed at a time — we take non-conflicting top seeds per round)
    seeds_per_round: int = 32
    max_rounds: int = 16
    # correlation threshold used by extract_ac to pick in-neuron pixels
    corr_pixel_thr: float = 0.9
    # deconvolve traces during initialization
    deconv_at_init: bool = True
    # number of spline knots for detrending (1 = disabled)
    nk: int = 1
    detrend_method: str = "spline"  # {"spline", "local_min"}


@dataclass(frozen=True)
class BackgroundParams:
    """Background model options (reference ring model: ``fit_ring_model.m``;
    low-rank: ``fit_svd_model.m`` / ``fit_nmf_model.m``)."""

    model: str = "ring"  # {"ring", "svd", "nmf", "local"}
    # ring radius in pixels (reference default: gSiz + 1)
    ring_radius: int = 14
    # spatial downsampling for the ring graph (reference: bg_ssub)
    ssub: int = 1
    # rank for svd/nmf background
    rank: int = 1
    # outlier clamp: residuals above thresh_outlier * sn are clipped before
    # the ring fit (fit_ring_model.m:50-56)
    thresh_outlier: float = 10.0
    # cap on frames used in the ring regression: frames <= frame_cap_factor *
    # ring size (fit_ring_model.m:58-91)
    frame_cap_factor: int = 100
    # ridge regularizer added to the ring normal equations
    ridge_eps: float = 1e-5
    # refresh the background model every N outer refinement iterations
    # (reference cadence: every pass, demo_large_data_1p.m:199-201).
    # 0 = amortized schedule (post-init + final only) — the measured
    # default; 1 = the reference's per-iteration refresh
    refresh_every: int = 0
    # streaming only: fit the ring model from a strided frame subset
    # BEFORE iteration 0's full temporal pass (the reference's stage
    # order — background precedes temporal,
    # demo_large_data_1p.m:199-209), so a single outer iteration already
    # yields background-subtracted traces. False restores the raw
    # bootstrap pass (traces then need n_outer >= 2 to converge).
    ring_bootstrap: bool = True


@dataclass(frozen=True)
class SpatialParams:
    """Spatial (A) update options (reference: ``update_spatial_parallel.m``)."""

    algorithm: str = "hals"  # {"hals", "hals_thresh", "nnls"}
    n_iter: int = 10
    # search-location method: {"dilate", "ellipse", "none"}
    search_method: str = "dilate"
    dilate_radius: int = 2
    # post-processing: keep largest connected component, circular prior
    connected: bool = True
    circular: bool = False
    min_pixel: int = 8


@dataclass(frozen=True)
class TemporalParams:
    """Temporal (C) update options (reference: ``update_temporal_parallel.m``)."""

    n_iter: int = 4
    deconv: DeconvParams = field(default_factory=DeconvParams)
    # detrend knots applied to the residual traces
    denoise: bool = True
    # suppress crosstalk spikes dominated by a spatial neighbor at the end
    # of each temporal update (reference: decorrTemporal.m)
    decorrelate: bool = False


@dataclass(frozen=True)
class MergeParams:
    """Merging thresholds (reference: ``merge_neurons_dist_corr.m``,
    ``merge_high_corr.m``)."""

    # temporal correlation threshold for distance-based merge
    merge_thr: float = 0.65
    # center-distance threshold (pixels)
    dmin: float = 5.0
    # spatial-overlap + trace-corr merge ("merge_thr_spatial" triple)
    merge_thr_spatial: Tuple[float, float, float] = (0.8, 0.4, -1.0)
    # distance-only merge radius (reference merge_close_neighbors dmin_only,
    # demo default 2.4 * gSig); folds duplicate/ghost components into their
    # originals regardless of trace correlation
    # (reference demo value: demo_large_data_1p.m:62 dmin_only = 2 —
    # an unconditional distance merge must stay well under typical
    # neuron spacing or it collapses true neighbors in dense fields)
    dmin_only: float = 2.0
    # optional decay-time gate: candidates also need per-neuron decay time
    # constants within max_decay_diff frames of each other
    # (merge_neurons_dist_corr.m:74-81); None disables the gate
    max_decay_diff: Optional[float] = None
    # neuron-center estimator for the distance gates: "max" = location of
    # the footprint peak (the reference demos' default,
    # demo_large_data_1p.m:60 / merge_neurons_dist_corr.m:63-66), "mean" =
    # center of mass (estCenter). Peak centers are robust to the
    # background-contaminated footprint tails that drag centers of mass
    # toward neighbors and over-merge sparse-activity recordings.
    method_dist: str = "max"
    # rank-1 refit iterations after a merge (reference uses 10 alternating LS)
    refit_iters: int = 10


@dataclass(frozen=True)
class QCParams:
    """Quality-control thresholds (reference: ``tag_neurons_parallel``)."""

    min_pixel: int = 8
    # minimum spike count for a neuron to be "active"
    min_spike_count: int = 1
    min_pnr: float = 3.0
    # classify_components energy-on-active-pixels threshold (0 = off);
    # applied by remove_false_positives when an active-pixel mask is given
    classify_cl_thr: float = 0.0


@dataclass(frozen=True)
class PatchParams:
    """Device-mesh / sharding layout. Replaces the reference's patch files +
    parfor (``distribute_data.m``, SURVEY.md section 2.9)."""

    # number of devices along the pixel-row ("patch") mesh axis
    n_patch: int = 1
    # number of devices along the frame ("frame") mesh axis
    n_frame: int = 1
    # frames per streaming block for out-of-core movies
    frames_per_block: int = 1000


@dataclass(frozen=True)
class CNMFEParams:
    """Top-level pipeline configuration (reference: demo scripts +
    ``CNMFSetParms.m``)."""

    # imaging parameters
    fs: float = 10.0  # frame rate (Hz)
    pixel_size: float = 1.0  # micron per pixel

    init: InitParams = field(default_factory=InitParams)
    background: BackgroundParams = field(default_factory=BackgroundParams)
    spatial: SpatialParams = field(default_factory=SpatialParams)
    temporal: TemporalParams = field(default_factory=TemporalParams)
    merge: MergeParams = field(default_factory=MergeParams)
    qc: QCParams = field(default_factory=QCParams)
    patch: PatchParams = field(default_factory=PatchParams)

    # frames used for per-pixel noise estimation. The reference caps at
    # 3000 (Sources2D.m:332-334) purely as a cost bound; a 1024-frame
    # contiguous prefix keeps the Welch spectrum semantics (contiguous,
    # no temporal aliasing) while the per-pixel sigma's standard error
    # (~sn/sqrt(n_indep_segments)) is already far below the 3*sn decision
    # thresholds it feeds. Set to a large value for the reference's
    # exact window.
    noise_frame_cap: int = 1024
    # numeric dtype for the movie on device
    dtype: str = "float32"
    seed: int = 0

    def replace(self, **kw) -> "CNMFEParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, default=str)

    @staticmethod
    def preset_1p(**kw) -> "CNMFEParams":
        """Defaults matching demo_large_data_1p.m:9-120 (1-photon)."""
        p = CNMFEParams(
            init=InitParams(gSig=3.0, gSiz=13, center_psf=True,
                            min_corr=0.8, min_pnr=8.0),
            background=BackgroundParams(model="ring", ring_radius=18, ssub=2),
        )
        return dataclasses.replace(p, **kw) if kw else p

    @staticmethod
    def preset_2p(deconv: str = "ar1_foopsi", **kw) -> "CNMFEParams":
        """Defaults matching demo_large_data_2p.m (2-photon, svd background).

        ``deconv`` selects the deconvolution family (BASELINE config 4 =
        the AR(2) OASIS sweep, ``constrained_oasisAR2.m``):
          * "ar1_foopsi"       — the demo default (demo_large_data_2p.m:36)
          * "ar2_constrained"  — AR(2), lambda tuned to RSS = sn^2 T
          * "ar2_thresholded"  — AR(2), hard smin search
        """
        deconv_presets = {
            "ar1_foopsi": DeconvParams(),
            "ar2_constrained": DeconvParams(model="ar2",
                                            method="constrained"),
            "ar2_thresholded": DeconvParams(model="ar2",
                                            method="thresholded"),
        }
        p = CNMFEParams(
            init=InitParams(gSig=0.0, gSiz=13, center_psf=False,
                            min_corr=0.8, min_pnr=8.0),
            background=BackgroundParams(model="svd", rank=3),
            temporal=TemporalParams(deconv=deconv_presets[deconv]),
        )
        return dataclasses.replace(p, **kw) if kw else p
