"""On-device checks shared by ``bench.py`` and ``chip_smoke.py``.

The flagship workload (M=256, m=4, r=1, 4 channels at 16 kHz, GSC-RLS +
Zelinski with ``pf_min_frames=2``, int16-scale input), the recursion kernel
against the XLA scan end to end, and the near-silent-bin trigger that once
turned an arithmetic blend in a scan kernel into NaN.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = [
    "FS",
    "array_geometry",
    "flagship_config",
    "kernel_vs_xla",
    "nan_trigger",
    "rel_err",
    "scan_route",
    "signals",
]

FS = 16000
C = 4


def flagship_config(**overrides):
    """The flagship `PipelineConfig` (README "Quick start")."""
    from ..models.pipeline import PipelineConfig
    from ..ops.filterbank import FilterbankParams

    cfg = PipelineConfig(
        fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2),
        samplerate=float(FS),
        beamformer="gsc_rls",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    return dataclasses.replace(cfg, **overrides)


def array_geometry(n_chan: int = C):
    """Linear array, 5 cm pitch, source at 60 degrees: ``(mpos, delays)``."""
    from . import geometry as geo

    mpos = np.c_[np.arange(n_chan) * 50.0, np.zeros((n_chan, 2))]
    return mpos, geo.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)


def signals(B: int, secs: float, seed: int = 0, n_chan: int = C) -> np.ndarray:
    """White noise at raw int16 scale (the reference's SampleFeature
    norm=0.0 convention, so the adaptive gates behave as calibrated)."""
    rng = np.random.default_rng(seed)
    T = int(FS * secs)
    return (rng.standard_normal((B, n_chan, T)) * 1500.0).astype(np.float32)


@contextlib.contextmanager
def scan_route(kernel: bool):
    """Pipelines built inside run the recursion as the Pallas kernel
    (``kernel=True``, GPU only) or as the XLA scan."""
    from ..models import pipeline

    old = pipeline.PALLAS_SCAN
    pipeline.PALLAS_SCAN = kernel
    try:
        yield
    finally:
        pipeline.PALLAS_SCAN = old


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got.astype(np.complex128) - want)))
    return err / max(float(np.max(np.abs(want))), 1e-30)


def kernel_vs_xla(x, cfg=None) -> dict:
    """Run ``x [B, C, T]`` through the flagship built with the kernel and
    with the XLA scan; return both outputs' agreement."""
    from ..models.pipeline import build_pipeline, path_flags
    from ..utils.prototypes import load_pair

    cfg = cfg or flagship_config()
    h, g = load_pair(cfg.fb.M, cfg.fb.m, cfg.fb.r)
    mpos, delays = array_geometry(x.shape[1])
    with scan_route(True):
        if not path_flags(cfg, x.shape[1])["scan_kernel"]:
            raise RuntimeError("the recursion kernel runs on a GPU backend only")
        y_k = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))
    with scan_route(False):
        y_x = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))
    return {"rel": rel_err(y_k, y_x), "finite": bool(np.isfinite(y_k).all()),
            "shape": list(y_k.shape)}


def nan_trigger(cfg=None, interpret: bool = False) -> dict:
    """Near-silent top bins: spectra whose top bins are scaled so the first
    adapted frame's ``|wa|^2`` lands in [1.2e-38, 2.9e-37], normal f32 but
    ``max_wa / |wa|^2`` overflows.  A kernel that blends instead of selects
    turns that into NaN.  Returns the kernel's agreement with the XLA scan.
    """
    import jax
    import jax.numpy as jnp

    from ..models.adaptive_gsc import gsc_postfilter_fused, gsc_weights
    from ..models.beamforming import array_manifold, frame_energy_half
    from ..models.scan_kernel import gsc_rls_zelinski
    from .jaxenv import host_device

    cfg = cfg or flagship_config()
    M = cfg.fb.M
    F = M // 2 + 1
    mpos, delays = array_geometry()
    with host_device():
        wqH, BmH = gsc_weights(M, cfg.samplerate, delays, cfg.Nc)
        ta = array_manifold(M, cfg.samplerate, delays)
        wqH, BmH, ta = np.asarray(wqH), np.asarray(BmH), np.asarray(ta)
    Tf, B = 16, 8
    rng = np.random.default_rng(0)
    Yr = (rng.standard_normal((Tf, B, C, 2 * F)) * 100).astype(np.float32)
    Yr[..., F] = 0.0  # Im(DC)
    Yr[..., 2 * F - 1] = 0.0  # Im(Nyquist)
    lo = 3 * M // 8
    Yr[..., lo:F] *= 1.8e-8
    Yr[..., F + lo:] *= 1.8e-8
    rls = dataclasses.replace(cfg.rls, min_frames=2)

    def run(Yr):
        X = jax.lax.complex(Yr[..., :F], Yr[..., F:])  # [Tf, B, C, F]
        e = frame_energy_half(X[:, :, 0], M)
        got = gsc_rls_zelinski(Yr, e, wqH, BmH, ta, rls, cfg.pf_alpha,
                               cfg.pf_type, 0, interpret=interpret)
        want = gsc_postfilter_fused(
            jnp.swapaxes(X, 2, 3), e, jnp.asarray(wqH), jnp.asarray(BmH),
            jnp.asarray(ta), "rls", rls, cfg.pf_alpha, cfg.pf_type, 0)
        return got, want

    got, want = jax.jit(run)(jnp.asarray(Yr))
    got, want = np.asarray(got), np.asarray(want)
    return {"rel": rel_err(got, want), "finite": bool(np.isfinite(got).all()),
            "nan": int(np.isnan(got).sum())}
