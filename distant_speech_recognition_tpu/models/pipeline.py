"""End-to-end enhancement pipelines: analysis -> beamform -> postfilter -> synthesis.

The flagship "model" of the framework: the batched equivalent of the
reference's canonical pull-graph (unit_test/test_online_beamforming.py:82-159:
SampleFeature -> OverSampledDFTAnalysisBank per channel -> beamformer ->
ZelinskiPostFilter -> OverSampledDFTSynthesisBank), expressed as one jittable
function over an utterance batch ``x [B, C, T]``.

Sharding: the batch axis is data-parallel; the beamformer/postfilter stages
operate per frequency bin and carry a sharding constraint on the bin axis so
pjit can split them across chips (see parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import os

from ..ops import dft
from ..utils.jaxenv import host_device
from ..ops.filterbank import (
    FilterbankParams,
    analysis,
    analysis_half,
    analysis_half_real_tm,
    analysis_snapshots_half,
    hermitian_mirror,
    synthesis,
    synthesis_half,
    synthesis_half_real_tm,
    synthesis_half_tm,
)

# With the DFT-as-matmul transforms (ops/dft.py) the half-band path does
# half the transform work and moves half the bytes of the full-M path, so it
# is the default.  Set DSR_HALF_BAND=0 to run full-M complex transforms end
# to end (only useful for debugging the hermitian-mirror algebra).
HALF_BAND = os.environ.get("DSR_HALF_BAND", "1") == "1"
# Time-major fused path: the analysis output stays real [T, B, C, ..] (see
# ops.filterbank.analysis_half_real_tm), the fused adaptive scan runs
# batch-natively over the leading frame axis, and synthesis consumes the scan
# output; no [B, T] <-> [T, B] transposes of the spectrum.  Same math, same
# operands as the per-utterance vmap path.
TIME_MAJOR = os.environ.get("DSR_TIME_MAJOR", "1") == "1"
# The GSC-RLS + Zelinski recursion runs as the Pallas kernel of
# models/scan_kernel.py on a GPU backend (every other backend runs the XLA
# scan).  DSR_PALLAS_SCAN=0 selects the XLA scan on the GPU too, to time the
# two against each other.
PALLAS_SCAN = os.environ.get("DSR_PALLAS_SCAN", "1") == "1"
from . import beamforming as bf
from . import postfilter as pfm
from .adaptive_gsc import GSCLMSConfig, GSCRLSConfig, gsc_lms, gsc_rls, gsc_weights

__all__ = ["PipelineConfig", "build_pipeline", "enhance", "path_flags"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration mirroring the reference's JSON config surface
    (unit_test/confs/*.json: beamformer{type}, postfilter{type,subtype,alpha})."""

    fb: FilterbankParams = FilterbankParams()
    samplerate: float = 16000.0
    beamformer: str = "ds"  # ds | sd_mvdr | lcmv | gsc_lms | gsc_rls
    postfilter: str = "none"  # none | zelinski | mccowan | lefkimmiatis | apab
    pf_alpha: float = 0.6
    pf_type: int = pfm.PostFilterType.ZELINSKI1_REAL
    pf_min_frames: int = 0
    sd_mu: float = 0.01
    Nc: int = 1
    lms: GSCLMSConfig = GSCLMSConfig()
    rls: GSCRLSConfig = GSCRLSConfig()
    # full-chain extensions (BASELINE config 4: AEC -> WPE -> GSC -> postfilter)
    aec: str = "none"  # none | nlms | kalman | block_kalman
    aec_delta: float = 100.0       # nlms delta | kalman beta | block_kalman beta
    aec_epsilon: float = 1.0e-4    # nlms epsilon | (block_)kalman sigma2
    aec_threshold: float = 100.0
    aec_taps: int = 1              # block_kalman sampleN
    wpe: bool = False
    wpe_lower: int = 2
    wpe_upper: int = 6
    wpe_iterations: int = 2
    wpe_band_width: float = 0.0  # >0: reference band limit (dereverberation.h:38)
    # Batched WPE materializes a [bc, C, T, F, C*P] lag tensor; chunking the
    # batch axis (sequential lax.map of vmapped chunks) bounds it to
    # ~chunk x 26 MB at the bench shape instead of B x 26 MB.
    wpe_batch_chunk: int = 64


def path_flags(cfg: "PipelineConfig", n_chan: int) -> dict:
    """The exact route predicates ``build_pipeline`` uses, in one place.

    Returns {"fused", "time_major", "tm_chain", "scan_kernel"} for the
    single-device (unsharded) build.  ``scan_kernel`` is true exactly when
    the GSC-RLS + Zelinski recursion runs as the Pallas kernel
    (models/scan_kernel.py): on a GPU backend only; the steered chain
    (models/steered.py) takes the same flag.  A kernel chosen here that
    fails to compile raises; nothing falls back to the XLA scan.
    """
    fused = cfg.beamformer in ("gsc_lms", "gsc_rls") and cfg.postfilter == "zelinski"
    tm_base = TIME_MAJOR and HALF_BAND and cfg.fb.M <= dft.MATMUL_MAX_M
    # AEC/WPE run on the time-major path too: the AEC scans are
    # shape-generic over [T, B, C, F] (aec._aec_state_shape) and WPE is a
    # dense batched estimate+apply; both slot between analysis and the fused
    # adaptive scan (BASELINE config 4).  block_kalman with >1 tap stays on
    # the vmap path (per-utterance tap stacking).
    tm_full_ok = cfg.aec in ("none", "nlms", "kalman") or (
        cfg.aec == "block_kalman" and cfg.aec_taps == 1
    )
    time_major = tm_base and fused and tm_full_ok
    scan_kernel = (
        time_major
        and PALLAS_SCAN
        and cfg.beamformer == "gsc_rls"
        and n_chan >= 2
        and jax.default_backend() == "gpu"
    )
    return {
        "fused": fused,
        "time_major": time_major,
        "tm_chain": time_major and (cfg.aec != "none" or cfg.wpe),
        "scan_kernel": scan_kernel,
    }


def _tm_shardings(bin_sharding):
    """Derive the time-major layouts ``[Tf, B, F, C]`` / ``[Tf, B, F]`` from
    a caller-supplied bin sharding.

    Accepts either a 4-axis time-major NamedSharding directly, or any
    NamedSharding over a mesh with the standard (batch, freq) axis names
    (parallel/mesh.MESH_AXES), from which the TM specs are rebuilt.  Returns
    ``None`` when the layout cannot be derived (caller falls back to the
    vmap path).
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    if not isinstance(bin_sharding, NamedSharding):
        return None
    mesh = bin_sharding.mesh
    spec = tuple(bin_sharding.spec)
    if len(spec) == 4:  # already a [Tf, B, F, C] spec
        return bin_sharding, NamedSharding(mesh, P(*spec[:3]))
    if {"batch", "freq"} <= set(mesh.axis_names):
        return (
            NamedSharding(mesh, P(None, "batch", "freq", None)),
            NamedSharding(mesh, P(None, "batch", "freq")),
        )
    return None


def _batch_only_mesh(bin_sharding):
    """The mesh, if the given sharding parallelizes over ``batch`` only
    (no ``freq`` axis, or a size-1 one) — the zero-penalty data-parallel
    deployment; ``None`` otherwise."""
    from jax.sharding import NamedSharding

    if not isinstance(bin_sharding, NamedSharding):
        return None
    mesh = bin_sharding.mesh
    shape = dict(mesh.shape)
    if "batch" not in shape or shape.get("batch", 1) < 1:
        return None
    if shape.get("freq", 1) != 1:
        return None
    spec_axes = {a for s in tuple(bin_sharding.spec) if s
                 for a in ((s,) if isinstance(s, str) else tuple(s))}
    # a size-1 mesh axis in the spec splits nothing — without this the
    # standard snapshot_sharding(mesh, ...) spec (which always names
    # "freq") silently routed batch-only meshes down the freq-sharded
    # complex-layout branch
    spec_axes = {a for a in spec_axes if shape.get(a, 1) > 1}
    if spec_axes - {"batch"}:
        return None
    return mesh


def _beamform_one(cfg: PipelineConfig, X, energy, wqH, BmH):
    """Beamform one utterance's snapshots X [T, F, C] -> [T, F]."""
    if cfg.beamformer in ("ds", "sd_mvdr", "lcmv"):
        return bf.apply_weights(wqH, X)
    if cfg.beamformer == "gsc_lms":
        Y, _ = gsc_lms(X, energy, wqH, BmH, cfg.lms)
        return Y
    if cfg.beamformer == "gsc_rls":
        Y, _ = gsc_rls(X, energy, wqH, BmH, cfg.rls)
        return Y
    raise ValueError(f"unknown beamformer {cfg.beamformer!r}")


def _postfilter_one(cfg: PipelineConfig, X, Y, wq_manifold, Gamma):
    if cfg.postfilter == "none":
        return Y
    if cfg.postfilter == "zelinski":
        return pfm.zelinski_postfilter(
            X, Y, wq_manifold, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames
        )
    if cfg.postfilter == "mccowan":
        return pfm.mccowan_postfilter(
            X, Y, wq_manifold, Gamma, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames
        )
    if cfg.postfilter == "lefkimmiatis":
        return pfm.lefkimmiatis_postfilter(
            X, Y, wq_manifold, Gamma, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames
        )
    if cfg.postfilter == "apab":
        return pfm.apab_postfilter(X, Y, wq_manifold)
    raise ValueError(f"unknown postfilter {cfg.postfilter!r}")


def build_pipeline(
    cfg: PipelineConfig,
    mpos,
    delays,
    h: np.ndarray,
    g: np.ndarray,
    bin_sharding=None,
    noise_delays=None,
):
    """Build a jittable ``enhance(x [B, C, T]) -> y [B, T_out]`` closure.

    Weights (manifold, quiescent, blocking matrix, diffuse coherence) are
    computed once at build time, like the reference's out-of-loop
    ``wrapper_weights_calculator`` (test_online_beamforming.py:166-183).
    ``bin_sharding``: optional sharding applied to the bin axis of the
    beamformer-stage tensors (a jax.sharding.NamedSharding for [T, F, C]
    or compatible), letting pjit split bins across chips.
    """
    M = cfg.fb.M
    fs = cfg.samplerate
    delays = np.asarray(delays)

    # Weight-table setup is tiny host-side compute; the tables embed into
    # the jitted program as constants.
    with host_device():
        vs = bf.array_manifold(M, fs, delays)
        # Postfilter alignment vector = the C++ ta_ (BeamformerWeights::
        # setTimeAlignment copies wq_ = e^{-j2pi f tau}/C into ta_,
        # beamformer.cc:960-965); the postfilters conjugate it per channel
        # (time_alignment_, postfilter.cc:30-43).  NOT the conjugated apply
        # weights — verified against the compiled reference
        # (tests/test_cpp_golden.py).
        wq_manifold = np.asarray(vs)
        if cfg.beamformer == "ds":
            wqH = np.conj(wq_manifold)
            BmH = None
        elif cfg.beamformer == "lcmv":
            # null steering: target + jammer manifolds as constraints
            # (calc_gsc_weights_n path, test_online_beamforming.py:170-183)
            njs = [bf.array_manifold(M, fs, np.asarray(d)) for d in (noise_delays or [])]
            constraints = jnp.stack([vs] + njs, axis=1)  # [F, Nc, C]
            gains = np.zeros(1 + len(njs))
            gains[0] = 1.0
            wqH = np.asarray(bf.lcmv_weights(constraints, gains))
            BmH = None
        elif cfg.beamformer == "sd_mvdr":
            wqH = np.asarray(bf.superdirective_weights(mpos, delays, M, fs, mu=cfg.sd_mu))
            BmH = None
        elif cfg.beamformer in ("gsc_lms", "gsc_rls"):
            wqH, BmH = gsc_weights(M, fs, delays, cfg.Nc)
            wqH, BmH = np.asarray(wqH), np.asarray(BmH)
        else:
            raise ValueError(cfg.beamformer)

        if cfg.postfilter in ("mccowan", "lefkimmiatis"):
            Gamma = np.asarray(bf.diffuse_noise_coherence(mpos, M, fs))
        else:
            Gamma = None

    h = jnp.asarray(h, jnp.float32)
    g = jnp.asarray(g, jnp.float32)

    flags = path_flags(cfg, len(delays))
    fused = flags["fused"]

    def _one(x, play=None):
        """x: [C, T] (+ optional far-end playback [T]) -> enhanced [T_out]."""
        # Every stage below reads bins 0..M/2 only; the conjugate mirror is
        # restored at synthesis (beamformer.cc:1142-1152).
        if cfg.aec != "none" or cfg.wpe:
            from .aec import block_kalman_aec, kalman_aec, nlms_aec
            from .dereverberation import wpe_multichannel

            if HALF_BAND:
                subh = analysis_half(x, h, cfg.fb)  # [C, Tf, F]
            else:
                subh = analysis(x, h, cfg.fb)[..., : M // 2 + 1]
            if cfg.aec != "none":
                # far-end reference through the same analysis bank
                # (the echo-canceller features consume subband snapshots of
                # the played signal, aec.cc:41-81 / :118-164 / :244-308)
                if HALF_BAND:
                    Vh = analysis_half(play, h, cfg.fb)
                else:
                    Vh = analysis(play, h, cfg.fb)[..., : M // 2 + 1]
                if cfg.aec == "nlms":
                    cancel = lambda A: nlms_aec(
                        Vh, A, cfg.aec_delta, cfg.aec_epsilon, cfg.aec_threshold
                    )[0]
                elif cfg.aec == "kalman":
                    cancel = lambda A: kalman_aec(
                        Vh, A, cfg.aec_delta, cfg.aec_epsilon, cfg.aec_threshold
                    )[0]
                elif cfg.aec == "block_kalman":
                    cancel = lambda A: block_kalman_aec(
                        Vh, A, cfg.aec_taps, cfg.aec_delta, cfg.aec_epsilon,
                        threshold=cfg.aec_threshold,
                    )[0]
                else:
                    raise ValueError(f"unknown aec {cfg.aec!r}")
                subh = jax.vmap(cancel)(subh)
            if cfg.wpe:
                subh = wpe_multichannel(subh, cfg.wpe_lower, cfg.wpe_upper,
                                        cfg.wpe_iterations,
                                        band_width=cfg.wpe_band_width,
                                        samplerate=cfg.samplerate)
            X = jnp.moveaxis(subh, 0, -1)  # [Tf, F, C]
        elif HALF_BAND:
            # fused analysis + snapshot transpose (real-first: see
            # ops.filterbank.analysis_snapshots_half compile note)
            X = analysis_snapshots_half(x, h, cfg.fb)  # [Tf, F, C]
        else:
            X = jnp.moveaxis(analysis(x, h, cfg.fb)[..., : M // 2 + 1], 0, -1)
        if bin_sharding is not None:
            X = jax.lax.with_sharding_constraint(X, bin_sharding)
        energy = bf.frame_energy_half(X[..., 0], M)  # [Tf] (channel 0)
        if fused:
            # one scan instead of GSC scan + CSD scan (identical outputs,
            # half the sequential steps)
            from .adaptive_gsc import gsc_postfilter_fused

            kind = "lms" if cfg.beamformer == "gsc_lms" else "rls"
            gcfg = cfg.lms if kind == "lms" else cfg.rls
            Y = gsc_postfilter_fused(
                X, energy, jnp.asarray(wqH), jnp.asarray(BmH),
                jnp.asarray(wq_manifold), kind, gcfg,
                cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames,
            )
        else:
            Y = _beamform_one(cfg, X, energy, wqH, BmH)  # [Tf, F]
            Y = _postfilter_one(cfg, X, Y, wq_manifold, Gamma)
        if HALF_BAND:
            return synthesis_half(Y, g, cfg.fb)
        return synthesis(hermitian_mirror(Y, M), g, cfg.fb)

    # Time-major only serves the fused adaptive scans (it removes the
    # [B,T]<->[T,B] transposes vmap-of-scan forces); fixed-weight pipelines
    # keep the vmap layout.
    time_major = flags["time_major"]

    # Batch-only sharding: each device runs the unsharded pipeline on its
    # own batch shard under shard_map, with no collectives (pure data
    # parallelism, the scaling mode for throughput workloads).  A mesh with
    # a ``freq`` axis takes the freq-sharded time-major branch below instead
    # (the model-parallel option for small batches).
    batch_mesh = _batch_only_mesh(bin_sharding) if bin_sharding is not None else None
    if batch_mesh is not None:
        from jax.sharding import PartitionSpec as P

        inner = build_pipeline(cfg, mpos, delays, h, g, bin_sharding=None)
        specs = (P("batch"), P("batch")) if cfg.aec != "none" else P("batch")
        return jax.jit(jax.shard_map(
            inner, mesh=batch_mesh, in_specs=specs, out_specs=P("batch"),
            check_vma=False,
        ))

    tm_shardings = None
    if time_major and bin_sharding is not None:
        tm_shardings = _tm_shardings(bin_sharding)
        if tm_shardings is None:
            time_major = False  # un-derivable layout: fall back to vmap path
    if flags["tm_chain"] and bin_sharding is not None:
        time_major = False  # sharded full chain not yet laid out: vmap path

    if cfg.aec != "none" and not time_major:

        @jax.jit
        def enhance(x, play):
            """x: [B, C, T], play: [B, T] far-end reference -> [B, T_out]."""
            return jax.vmap(_one)(x, play)

    elif time_major and tm_shardings is not None:
        from .adaptive_gsc import gsc_postfilter_fused

        kind = "lms" if cfg.beamformer == "gsc_lms" else "rls"
        gcfg = cfg.lms if kind == "lms" else cfg.rls
        F = M // 2 + 1
        X_sharding, Y_sharding = tm_shardings

        @jax.jit
        def enhance(x):
            """x: [B, C, T] -> [B, T_out] (time-major freq-sharded path)."""
            Yr = analysis_half_real_tm(x, h, cfg.fb, packed=False)  # [Tf,B,C,2F]
            X = jnp.moveaxis(
                jax.lax.complex(Yr[..., :F], Yr[..., F:]), -2, -1
            )  # [Tf, B, F, C]
            X = jax.lax.with_sharding_constraint(X, X_sharding)
            # dense pre-pass (one all-reduce over freq shards) instead of a
            # per-scan-step reduction
            energy = bf.frame_energy_half(X[..., 0], M)  # [Tf, B]
            Y = gsc_postfilter_fused(
                X, energy, jnp.asarray(wqH), jnp.asarray(BmH),
                jnp.asarray(wq_manifold), kind, gcfg,
                cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames,
            )  # [Tf, B, F] complex, freq-sharded
            Y = jax.lax.with_sharding_constraint(Y, Y_sharding)
            return synthesis_half_tm(Y, g, cfg.fb)

    elif time_major:
        from .adaptive_gsc import gsc_postfilter_fused

        kind = "lms" if cfg.beamformer == "gsc_lms" else "rls"
        gcfg = cfg.lms if kind == "lms" else cfg.rls
        F = M // 2 + 1
        scan_kernel = flags["scan_kernel"]
        tm_chain = flags["tm_chain"]

        def _complex(Yr):
            """[.., 2F] [Re | Im] lanes -> complex [.., F]."""
            return jax.lax.complex(Yr[..., :F], Yr[..., F:])

        def _chain(X, play):
            """AEC -> WPE between analysis and the adaptive scan, in the
            time-major layout: complex X [Tf, B, C, F] (config 4; the
            reference chains the same feature nodes per channel,
            aec.cc:41-81 -> dereverberation.cc:214-275)."""
            from .aec import block_kalman_aec, kalman_aec, nlms_aec
            from .dereverberation import wpe_multichannel

            if cfg.aec != "none":
                # far-end reference through the same analysis bank
                V = _complex(analysis_half_real_tm(play[:, None, :], h, cfg.fb))
                if cfg.aec == "nlms":
                    X, _ = nlms_aec(
                        V, X, cfg.aec_delta, cfg.aec_epsilon, cfg.aec_threshold
                    )
                elif cfg.aec == "kalman":
                    X, _ = kalman_aec(
                        V, X, cfg.aec_delta, cfg.aec_epsilon, cfg.aec_threshold
                    )
                else:  # block_kalman, taps == 1 (path_flags gate)
                    X, _ = block_kalman_aec(
                        V, X, cfg.aec_taps, cfg.aec_delta, cfg.aec_epsilon,
                        threshold=cfg.aec_threshold,
                    )
            if cfg.wpe:
                Yb = jnp.moveaxis(X, 0, 2)  # [B, C, Tf, F]
                wpe_fn = lambda yb: wpe_multichannel(
                    yb, cfg.wpe_lower, cfg.wpe_upper, cfg.wpe_iterations,
                    band_width=cfg.wpe_band_width, samplerate=cfg.samplerate,
                )
                Bn = Yb.shape[0]
                bc = max(1, min(cfg.wpe_batch_chunk, Bn))
                if Bn > bc and Bn % bc == 0:
                    Yc = Yb.reshape((Bn // bc, bc) + Yb.shape[1:])
                    Yb = jax.lax.map(jax.vmap(wpe_fn), Yc).reshape(Yb.shape)
                else:
                    Yb = jax.vmap(wpe_fn)(Yb)
                X = jnp.moveaxis(Yb, 2, 0)
            return X

        def _enhance_tm(x, play=None):
            """x: [B, C, T] -> [B, T_out] (time-major path)."""
            if scan_kernel:
                from .scan_kernel import gsc_rls_zelinski

                Yr = analysis_half_real_tm(x, h, cfg.fb)  # [Tf, B, C, 2F]
                if tm_chain:
                    X = _chain(_complex(Yr), play)
                    Yr = jnp.concatenate([jnp.real(X), jnp.imag(X)], axis=-1)
                energy = bf.frame_energy_half(_complex(Yr[:, :, 0]), M)  # [Tf, B]
                Y = gsc_rls_zelinski(
                    Yr, energy, wqH, BmH, wq_manifold, gcfg,
                    cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames,
                )  # [Tf, B, F] complex
                return synthesis_half_tm(Y, g, cfg.fb)
            # Packed real lanes [Re(0..M/2) | Im(1..M/2-1)]: square [M, M]
            # DFT matmuls, and the scan forms each frame's complex snapshot
            # itself (no snapshot transpose of the spectrum)
            Yr = analysis_half_real_tm(x, h, cfg.fb, packed=True)  # [Tf, B, C, M]
            if tm_chain:
                zero = jnp.zeros_like(Yr[..., :1])
                X = _chain(jax.lax.complex(
                    Yr[..., :F], jnp.concatenate([zero, Yr[..., F:], zero], -1)
                ), play)
                Yr = jnp.concatenate([jnp.real(X), jnp.imag(X)[..., 1 : F - 1]], -1)
            # energy=None: the reference-channel frame energy is computed
            # inside each scan step (no separate dense pass over Yr)
            Yp = gsc_postfilter_fused(
                Yr, None, jnp.asarray(wqH), jnp.asarray(BmH),
                jnp.asarray(wq_manifold), kind, gcfg,
                cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames, True,
            )  # [Tf, B, M] packed (True = real_packed, positional arg)
            return synthesis_half_real_tm(Yp, g, cfg.fb)

        if cfg.aec != "none":
            enhance = jax.jit(_enhance_tm)
        else:
            enhance = jax.jit(lambda x: _enhance_tm(x))

    else:

        @jax.jit
        def enhance(x):
            """x: [B, C, T] -> [B, T_out]."""
            return jax.vmap(_one)(x)

    return enhance


def enhance(cfg: PipelineConfig, mpos, delays, h, g, x):
    """One-shot convenience wrapper around `build_pipeline`."""
    return build_pipeline(cfg, mpos, delays, h, g)(x)
