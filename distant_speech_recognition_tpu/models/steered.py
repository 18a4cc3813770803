"""SRP-PHAT-steered adaptive beamforming, fully in-graph.

BASELINE config 5: per utterance, localize the source by SRP-PHAT over a
steering grid, steer a GSC at the estimated direction, and enhance — the
batched equivalent of chaining DOAEstimatorSRPDSBLA (beamformer.cc:2879-3211)
into SubbandGSCRLS steering (set_look_direction -> calc_gsc_weights).

Unlike ``build_pipeline`` (weights fixed at build time), the steering here is
*traced*: the DOA argmax, the array manifold, and the blocking matrix are all
computed inside the jitted graph, so every utterance in the batch gets its own
look direction — and the whole thing shards over (batch, freq) mesh axes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.filterbank import (
    analysis_half_real_tm,
    analysis_snapshots_half,
    synthesis_half,
    synthesis_half_tm,
)
from ..utils.jaxenv import host_device
from . import beamforming as bf
from .localization import srp_dsbla, srp_phat, srp_phat_steering_table

__all__ = ["build_steered_pipeline"]


def build_steered_pipeline(
    cfg,
    mpos,
    h,
    g,
    thetas,
    phis,
    sspeed: float = 343740.0,
    min_bin: int = 1,
    max_bin: int | None = None,
    bin_sharding=None,
    doa_protocol: str = "srp_phat",
    energy_threshold: float = 0.0,
):
    """Build jitted ``enhance(x [B, C, T]) -> (y [B, T_out], doa [B, 2])``.

    ``cfg``: PipelineConfig with beamformer ds | gsc_lms | gsc_rls and
    postfilter none | zelinski.  ``thetas``/``phis``: the polar/azimuth search
    grid (radians).  The per-utterance DOA (theta, phi) is returned alongside
    the enhanced audio.

    ``doa_protocol``: ``"srp_phat"`` (default — whole-utterance PHAT-weighted
    SRP sum, the fast estimator) or ``"dsbla"`` — the reference
    DOAEstimatorSRPDSBLA protocol (models.localization.srp_dsbla): per-frame
    D&S response power, frames below ``energy_threshold`` skipped, argmax of
    the accumulated powers (robust to silence padding;
    beamformer.cc:3125-3197).
    """
    from ..utils.geometry import calc_ca_delays
    from .adaptive_gsc import gsc_postfilter_fused, gsc_lms, gsc_rls

    if cfg.beamformer not in ("ds", "gsc_lms", "gsc_rls"):
        raise ValueError(f"steered pipeline supports ds|gsc_lms|gsc_rls, got {cfg.beamformer}")
    if cfg.postfilter not in ("none", "zelinski"):
        raise ValueError(f"steered pipeline supports none|zelinski, got {cfg.postfilter}")

    M = cfg.fb.M
    fs = cfg.samplerate
    mpos = np.asarray(mpos, np.float64)

    with host_device():
        steering, grid = srp_phat_steering_table(mpos, M, fs, thetas, phis, sspeed)
        delay_table = np.stack(
            [calc_ca_delays(mpos, p, t, sspeed) for t, p in np.asarray(grid)]
        )  # [G, C]
    if doa_protocol not in ("srp_phat", "dsbla"):
        raise ValueError(f"unknown doa_protocol {doa_protocol!r}")
    if doa_protocol == "dsbla":
        with host_device():
            # wq steering table (e^{-j.}/C convention, calcMainlobe)
            wq_table = np.stack(
                [np.asarray(bf.array_manifold(M, fs, d)) for d in delay_table]
            )
        wq_table_j = jnp.asarray(wq_table)
    steering = jnp.asarray(steering)
    grid_j = jnp.asarray(grid)
    delay_table = jnp.asarray(delay_table, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    g = jnp.asarray(g, jnp.float32)

    def _one(x):
        # fused half-band analysis + snapshot transpose (real-first: see
        # ops.filterbank.analysis_snapshots_half compile note)
        X = analysis_snapshots_half(x, h, cfg.fb)  # [Tf, F, C]
        if bin_sharding is not None:
            X = jax.lax.with_sharding_constraint(X, bin_sharding)
        energy = bf.frame_energy_half(X[..., 0], M)

        # --- in-graph DOA estimate ------------------------------------
        if doa_protocol == "dsbla":
            nbest, _, _ = srp_dsbla(
                X, wq_table_j, min_bin, max_bin, energy_threshold, 1
            )
            gidx = nbest[0]
        else:
            srp = srp_phat(X, steering, min_bin, max_bin)  # [Tf, G]
            gidx = jnp.argmax(jnp.sum(srp, axis=0))
        doa = grid_j[gidx]  # (theta, phi)
        delays = delay_table[gidx]  # [C]

        # --- steer the beamformer at the estimate -----------------------
        vs = bf.array_manifold(M, fs, delays)  # [F, C] traced
        wqH = jnp.conj(vs)
        if cfg.beamformer == "ds":
            Y = bf.apply_weights(wqH, X)
            if cfg.postfilter == "zelinski":
                from .postfilter import zelinski_postfilter

                # alignment vector is the manifold vs (the C++ ta_), not the
                # conjugated apply weights (beamformer.cc:960-965)
                Y = zelinski_postfilter(X, Y, vs, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
        else:
            BmH = jnp.swapaxes(bf.blocking_matrix(vs, cfg.Nc), -1, -2)
            kind = "lms" if cfg.beamformer == "gsc_lms" else "rls"
            gcfg = cfg.lms if kind == "lms" else cfg.rls
            if cfg.postfilter == "zelinski":
                # postfilter alignment uses the manifold vs (the C++ ta_),
                # not the conjugated apply weights (beamformer.cc:960-965)
                Y = gsc_postfilter_fused(
                    X, energy, wqH, BmH, vs, kind, gcfg,
                    cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames,
                )
            else:
                run = gsc_lms if kind == "lms" else gsc_rls
                Y, _ = run(X, energy, wqH, BmH, gcfg)

        return synthesis_half(Y, g, cfg.fb), doa

    # On a GPU backend the config-5 chain (gsc_rls + zelinski, srp_phat DOA)
    # runs batched and time-major: XLA analysis, one SRP einsum over the
    # steering table, traced per-utterance steering, and the recursion
    # kernel with per-lane weights (models/scan_kernel.py), wherever
    # `pipeline.path_flags` picks the kernel for the same config.
    from .pipeline import path_flags

    if (
        path_flags(cfg, mpos.shape[0])["scan_kernel"]
        and doa_protocol == "srp_phat"
        and bin_sharding is None
    ):
        return _build_steered_tm(cfg, h, g, steering, grid_j, delay_table, fs,
                                 min_bin, max_bin)

    @jax.jit
    def enhance(x):
        """x: [B, C, T] -> (y [B, T_out], doa [B, 2])."""
        return jax.vmap(_one)(x)

    return enhance


def _build_steered_tm(cfg, h, g, steering, grid_j, delay_table, fs, min_bin,
                      max_bin):
    """Batched time-major steered chain: analysis -> SRP-PHAT DOA -> traced
    per-utterance manifold/blocking weights -> GSC-RLS + Zelinski kernel
    with per-lane weights -> synthesis.  Equal to the vmapped `_one` chain
    (tests/test_routes.py::test_steered_route_matches_vmap_chain)."""
    from .scan_kernel import gsc_rls_zelinski

    M = cfg.fb.M
    F = M // 2 + 1
    hj = jnp.asarray(h, jnp.float32)
    gj = jnp.asarray(g, jnp.float32)

    @jax.jit
    def enhance(x):
        """x: [B, C, T] -> (y [B, T_out], doa [B, 2])."""
        Yr = analysis_half_real_tm(x, hj, cfg.fb)  # [Tf, B, C, 2F]
        X = jax.lax.complex(Yr[..., :F], Yr[..., F:])  # [Tf, B, C, F]
        srp = srp_phat(jnp.moveaxis(jnp.swapaxes(X, 2, 3), 0, 1), steering,
                       min_bin, max_bin)  # [B, Tf, G]
        gidx = jnp.argmax(jnp.sum(srp, axis=1), axis=-1)  # [B]
        delays = delay_table[gidx]  # [B, C]
        vs = jax.vmap(lambda d: bf.array_manifold(M, fs, d))(delays)  # [B, F, C]
        bm_b = jnp.swapaxes(bf.blocking_matrix(vs, cfg.Nc), -1, -2)
        energy = bf.frame_energy_half(X[:, :, 0], M)  # [Tf, B]
        Y = gsc_rls_zelinski(
            Yr, energy, jnp.conj(vs), bm_b, vs, cfg.rls, cfg.pf_alpha,
            cfg.pf_type, cfg.pf_min_frames, per_utterance=True,
        )
        return synthesis_half_tm(Y, gj, cfg.fb), grid_j[gidx]

    return enhance
