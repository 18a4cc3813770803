"""Post-filtering of beamformed subband signals.

Batched reformulation of the reference's postfilter subsystem
(postfilter/postfilter.cc, postfilter/spectralsubtraction.cc): Zelinski and
APAB postfilters, McCowan and Lefkimmiatis coherence-based Wiener variants,
single/multi-channel spectral subtraction, and the two-stream Wiener filter.

The per-frame recursive cross-spectral-density (CSD) estimates become a
`lax.scan` over frames carrying one Hermitian CSD matrix per bin
``[F, C, C]``; every per-bin pair loop becomes a masked reduction batched
over all bins.  Weight conventions (spectral floor 1e-4, unit cap,
min-frames warmup, frame-0 alpha=0) follow the reference exactly.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from ..ops.complex_ops import ceinsum
import numpy as np

SPECTRAL_FLOOR = 1.0e-4  # postfilter.cc:56

__all__ = [
    "PostFilterType",
    "zelinski_postfilter",
    "mccowan_postfilter",
    "lefkimmiatis_postfilter",
    "apab_postfilter",
    "average_noise_psd",
    "spectral_subtract",
    "wiener_filter",
    "high_pass_filter",
    "binary_mask_filter",
]


class PostFilterType:
    """Bit flags per postfilter.h (TYPE_ZELINSKI1_REAL etc.)."""

    ZELINSKI1_REAL = 0x01
    ZELINSKI1_ABS = 0x02
    APAB = 0x04
    ZELINSKI2 = 0x08


def _time_align(wq: jax.Array, X: jax.Array) -> jax.Array:
    """Per-channel delay compensation: ``y_c = conj(wq_c) X_c``
    (time_alignment_, postfilter.cc:30-43).  wq: [F, C], X: [..., T, F, C]."""
    return jnp.conj(wq) * X


def _ema_scan(seq: jax.Array, alpha: float):
    """``s_t = alpha s_{t-1} + (1-alpha) x_t`` over axis 0 with
    ``s_0 = x_0`` AND ``s_1 = x_1``: the reference keeps alpha at 0 for its
    first TWO calls — the ``frame_no_ > 0`` check reads the pre-increment
    counter, which is -1 then 0 (postfilter.cc:424-463).  Verified against
    the compiled reference, which round 3's subband-domain localization
    traced to exactly this off-by-one (tests/test_cpp_golden.py)."""
    if alpha <= 0.0:
        return seq
    if seq.shape[0] <= 2:
        return seq
    # Linear recurrence as an O(log T)-depth associative scan, the same form
    # on every backend.
    from ..ops.recursions import ema

    rest = ema(seq[1:], alpha, axis=0, first_direct=True)
    return jnp.concatenate([seq[:1], rest], axis=0)


def _csd_scan(aligned: jax.Array, alpha: float):
    """Recursive CSD matrices over frames.

    ``aligned``: [T, F, C].  Returns ``Phi [T, F, C, C]`` where
    ``Phi_t = alpha Phi_{t-1} + (1-alpha) y_t y_t^H`` with ``Phi_0 = y_0 y_0^H``
    (calc_CSD_ postfilter.cc:8-21).
    """
    outer = jnp.einsum("tfc,tfd->tfcd", aligned, jnp.conj(aligned))
    return _ema_scan(outer, alpha)


def _pair_mask(C: int) -> np.ndarray:
    return np.triu(np.ones((C, C), bool), k=1)


def zelinski_postfilter(
    X: jax.Array,
    Y: jax.Array,
    wq: jax.Array,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
) -> jax.Array:
    """Zelinski postfilter applied to a beamformed signal.

    ``X``: snapshots [T, F, C]; ``Y``: beamformed [T, F]; ``wq``: [F, C]
    manifold (or the beamformer's weights for TYPE_ZELINSKI2 —
    postfilter.cc:406-411).  Returns filtered [T, F].

    Weight per frame/bin (ZelinskiFilter_f, postfilter.cc:57-148)::

        W = clip( (2/(C-1)) * num / sum_i phi_ii, 1e-4, 1 )
        num = Re( sum_{i<j} Phi_ij )  (clipped at 0)   [REAL]
            | abs( sum_{i<j} Phi_ij )                  [ABS]
    """
    C = X.shape[-1]
    aligned = _time_align(wq, X)
    # The weight reads Phi only through the i<j pair sum and the trace, both
    # linear in Phi, so the reductions commute with the CSD smoothing: smooth
    # the two reduced series instead of the [T, F, C, C] matrices (identical
    # math, C^2/2 x less scan state).
    pairs = [(i, j) for i in range(C) for j in range(C) if i < j]
    pair_seq = sum(aligned[..., i] * jnp.conj(aligned[..., j]) for i, j in pairs)
    diag_seq = jnp.sum(jnp.abs(aligned) ** 2, axis=-1)
    csd_sum = _ema_scan(pair_seq, alpha)  # [T, F]
    if pf_type & PostFilterType.ZELINSKI1_REAL:
        num = jnp.maximum(jnp.real(csd_sum), 0.0)
    else:
        num = jnp.abs(csd_sum)
    den = _ema_scan(diag_seq, alpha)
    # All-zero (digitally silent) frames give den = 0; the reference's 0/0
    # NaN survives its clamps (postfilter.cc:118-121) — floor instead so
    # silence stays silent rather than going NaN.
    ratio = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    W = jnp.clip(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
    # Frame index runs along axis 0 (works for [T, F] and the time-major
    # batched [T, B, F] layout alike).  The reference's NO_USE gate reads
    # the pre-increment frame counter, so the filter engages one frame
    # LATER than min_frames (postfilter.cc:468-473): apply iff t > min.
    t = jnp.arange(W.shape[0]).reshape((-1,) + (1,) * (W.ndim - 1))
    W = jnp.where(t > min_frames, W, 1.0)
    return Y * W.astype(Y.dtype)


def _clamp_Rij_mccowan(Rij: jax.Array, threshold: float) -> jax.Array:
    """McCowan R_ij clamp (postfilter.cc:816-819): if Re > threshold and
    Im <= 0, replace by the real threshold."""
    cond = (jnp.real(Rij) > threshold) & (jnp.imag(Rij) <= 0.0)
    return jnp.where(cond, jnp.asarray(threshold, Rij.dtype), Rij)


def _clamp_Rij_lefk(Rij: jax.Array, threshold: float) -> jax.Array:
    """Lefkimmiatis noise-PSD clamp (postfilter.cc:1082-1087)."""
    out = jnp.where(jnp.real(Rij) > threshold, jnp.asarray(threshold, Rij.dtype), Rij)
    out = jnp.where(jnp.real(Rij) == 1.0, jnp.asarray(0.99, Rij.dtype), out)
    return out


def _avg_pair_psd(Phi: jax.Array, Rij_term, reduce_real: bool) -> jax.Array:
    """Average over mic pairs of (phi_ij combined with R_ij): the shared
    shape of estimate_average_clean/noise_PSD_ (postfilter.cc:798-838,
    1056-1096).  ``Rij_term(phi_ij, phi_ii, phi_jj, R)`` returns the complex
    per-pair summand [T, F, C, C]."""
    C = Phi.shape[-1]
    diag = jnp.real(jnp.diagonal(Phi, axis1=-2, axis2=-1))  # [T, F, C]
    phi_ii = diag[..., :, None]
    phi_jj = diag[..., None, :]
    summand = Rij_term(Phi, phi_ii, phi_jj)
    pair = jnp.asarray(_pair_mask(C))
    s = jnp.sum(jnp.where(pair, summand, 0), axis=(-2, -1))
    avg = jnp.real(s) if reduce_real else jnp.abs(s)
    return 2.0 * avg / (C * (C - 1.0))


def mccowan_postfilter(
    X: jax.Array,
    Y: jax.Array,
    wq: jax.Array,
    Gamma: jax.Array,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
    threshold_Rij: float = 0.99,
) -> jax.Array:
    """McCowan postfilter: Zelinski generalized with a measured/diffuse
    coherence ``Gamma [F, C, C]`` (McCowanPostFilter, postfilter.cc:843-901).

    ``phi_ss = avg_pairs (phi_ij - 0.5 R_ij (phi_ii + phi_jj)) / (1 - R_ij)``,
    weight = clip(phi_ss / (sum_i phi_ii / C), 1e-4, 1).
    """
    aligned = _time_align(wq, X)
    C = X.shape[-1]

    R = _clamp_Rij_mccowan(Gamma, threshold_Rij)

    # The pair sum and trace are LINEAR in the CSD entries, so they commute
    # with the EMA: smooth two reduced [T, F] series instead of the
    # [T, F, C, C] matrices (identical math, C^2/2 x less scan state).
    pairs = [(i, j) for i in range(C) for j in range(C) if i < j]
    d = jnp.abs(aligned) ** 2  # [T, F, C] per-channel PSDs
    nu_seq = sum(
        (aligned[..., i] * jnp.conj(aligned[..., j])
         - 0.5 * R[..., i, j] * (d[..., i] + d[..., j]))
        / (1.0 - R[..., i, j])
        for i, j in pairs
    )
    de_seq = jnp.sum(d, axis=-1) / C
    nu_s = _ema_scan(nu_seq, alpha)
    nu = jnp.real(nu_s) if pf_type & PostFilterType.ZELINSKI1_REAL else jnp.abs(nu_s)
    nu = 2.0 * nu / (C * (C - 1.0))
    de = _ema_scan(de_seq, alpha)
    W = jnp.clip(nu / de, SPECTRAL_FLOOR, 1.0)
    # pre-increment counter gate: apply iff t > min (postfilter.cc:889)
    t = jnp.arange(Y.shape[-2])
    W = jnp.where((t > min_frames)[:, None], W, 1.0)
    return Y * W.astype(Y.dtype)


def lefkimmiatis_postfilter(
    X: jax.Array,
    Y: jax.Array,
    wq: jax.Array,
    Gamma: jax.Array,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
    threshold_Rij: float = 0.99,
    min_sv: float = 1.0e-8,
    fbin_no1: int = 128,
) -> jax.Array:
    """Lefkimmiatis Wiener postfilter with diffuse-field noise PSD estimate
    (LefkimmiatisPostFilter::post_filtering_, postfilter.cc:1098-1161).

    ``phi_vv`` from pair-averaged noise PSD; above bin ``fbin_no1`` the noise
    PSD is scaled by ``1 / Lambda`` with ``Lambda = d^H Gamma^-1 d``.
    """
    from .beamforming import _pinv_hermitian

    aligned = _time_align(wq, X)
    C = X.shape[-1]

    Rc = _clamp_Rij_mccowan(Gamma, threshold_Rij)
    Rn = _clamp_Rij_lefk(Gamma, threshold_Rij)

    # reduced-series EMA (see mccowan_postfilter): both PSD estimates are
    # linear functionals of the CSD matrix
    pairs = [(i, j) for i in range(C) for j in range(C) if i < j]
    d = jnp.abs(aligned) ** 2
    ss_seq = sum(
        (aligned[..., i] * jnp.conj(aligned[..., j])
         - 0.5 * Rc[..., i, j] * (d[..., i] + d[..., j]))
        / (1.0 - Rc[..., i, j])
        for i, j in pairs
    )
    vv_seq = sum(
        (0.5 * (d[..., i] + d[..., j])
         - aligned[..., i] * jnp.conj(aligned[..., j]))
        / (1.0 - Rn[..., i, j])
        for i, j in pairs
    )
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    norm = 2.0 / (C * (C - 1.0))
    ss_s = _ema_scan(ss_seq, alpha)
    vv_s = _ema_scan(vv_seq, alpha)
    phi_ss = (jnp.real(ss_s) if real_mode else jnp.abs(ss_s)) * norm
    phi_vv = (jnp.real(vv_s) if real_mode else jnp.abs(vv_s)) * norm

    invR = _pinv_hermitian(Gamma, min_sv)
    tmp = ceinsum("fji,fj->fi", jnp.conj(invR), wq)
    lam = jnp.sum(jnp.conj(tmp) * wq, axis=-1)  # d^H invR d  [F]
    lam_v = jnp.real(lam) if real_mode else jnp.abs(lam)

    F = Y.shape[-1]
    use_lambda = jnp.arange(F) >= fbin_no1
    phi_nn = jnp.where(use_lambda, phi_vv / lam_v, phi_vv)
    W = jnp.clip(phi_ss / (phi_ss + phi_nn), SPECTRAL_FLOOR, 1.0)
    # pre-increment counter gate: apply iff t > min (postfilter.cc:1148)
    t = jnp.arange(Y.shape[-2])
    W = jnp.where((t > min_frames)[:, None], W, 1.0)
    return Y * W.astype(Y.dtype)


def apab_postfilter(
    X: jax.Array,
    Y: jax.Array,
    wq: jax.Array,
    channel: int = -1,
) -> jax.Array:
    """Adaptive post-filter for arbitrary beamformers (APAB)
    (ApabFilter, postfilter.cc:224-330).

    ``W = clip(|Y|^2 / |x_ref|^2, -1, 1)`` with ``x_ref`` the D&S output
    (channel < 0) or one aligned channel (default C/2 in the reference's
    driver).  The reference computes/applies weights only for bins below
    M/2; the Nyquist bin passes unchanged — replicated here.
    """
    C = X.shape[-1]
    phi_yy = jnp.abs(Y) ** 2
    if channel < 0:
        ref = ceinsum("fc,...tfc->...tf", jnp.conj(wq), X)
    else:
        ref = jnp.conj(wq[:, channel]) * X[..., channel]
    phi_xx = jnp.abs(ref) ** 2
    # zero reference power -> pass through (the reference NaNs on 0/0)
    W = jnp.clip(
        jnp.where(phi_xx > 0, phi_yy / jnp.where(phi_xx > 0, phi_xx, 1.0), 1.0),
        -1.0,
        1.0,
    )
    nyq = jnp.arange(Y.shape[-1]) == Y.shape[-1] - 1
    W = jnp.where(nyq, 1.0, W)
    return Y * W.astype(Y.dtype)


# ---------------------------------------------------------------------------
# spectral subtraction / Wiener
# ---------------------------------------------------------------------------

def average_noise_psd(X: jax.Array, frame_mask=None, alpha: float = -1.0) -> jax.Array:
    """Noise PSD estimate per bin (AveragePSDEstimator,
    spectralsubtraction.cc:52-115): plain average over (masked) frames when
    ``alpha < 0``, else exponential average.  ``X``: [..., T, F] complex."""
    p = jnp.abs(X) ** 2
    if alpha < 0:
        if frame_mask is not None:
            w = jnp.asarray(frame_mask, p.dtype)[..., None]
            return jnp.sum(p * w, axis=-2) / jnp.maximum(jnp.sum(w, axis=-2), 1.0)
        return jnp.mean(p, axis=-2)

    def step(est, pt):
        est = alpha * est + (1.0 - alpha) * pt
        return est, est

    est, _ = jax.lax.scan(step, p[..., 0, :], jnp.moveaxis(p, -2, 0))
    return est


def spectral_subtract(
    X: jax.Array,
    noise_psd: jax.Array,
    ft: float = 1.0,
    flooring: float = 0.001,
) -> jax.Array:
    """Magnitude-domain spectral subtraction keeping the noisy phase
    (SpectralSubtractor::next, spectralsubtraction.cc:216-285).

    ``X``: [..., T, F]; ``noise_psd``: [..., F].  Multi-channel use: apply per
    channel and average the results (the reference averages channels).
    """
    X2 = jnp.abs(X) ** 2
    S2 = jnp.maximum(X2 - ft * noise_psd[..., None, :], flooring)
    mag = jnp.sqrt(S2)
    phase = X / jnp.maximum(jnp.abs(X), 1e-30)
    return (mag * phase).astype(X.dtype)


def wiener_filter(
    St: jax.Array,
    Nt: jax.Array,
    alpha: float = 0.0,
    flooring: float = 1.0e-4,
    beta: float = 1.0,
) -> jax.Array:
    """Two-stream Wiener filter ``H = PSD_s / (PSD_s + beta PSD_n)``
    (WienerFilter::next, spectralsubtraction.cc:314-362).  Bin 0 passes
    unfiltered.  ``St``/``Nt``: [T, F] complex."""
    Ps = jnp.abs(St) ** 2
    Pn = jnp.maximum(jnp.abs(Nt) ** 2, flooring)

    if alpha > 0:

        def step(carry, xs):
            ps_prev, pn_prev = carry
            ps_t, pn_t = xs
            ps = alpha * ps_prev + (1 - alpha) * ps_t
            pn = alpha * pn_prev + (1 - alpha) * pn_t
            return (ps, pn), (ps, pn)

        # smoothing engages on the THIRD frame: the reference's
        # ``frame_no_ > 0`` reads the pre-increment counter
        # (spectralsubtraction.cc:323-326) — round-3 parity fix
        (_, _), (Ps_s, Pn_s) = jax.lax.scan(step, (Ps[1], Pn[1]), (Ps[2:], Pn[2:]))
        Ps = jnp.concatenate([Ps[:2], Ps_s], axis=0)
        Pn = jnp.concatenate([Pn[:2], Pn_s], axis=0)

    H = Ps / (Ps + beta * Pn)
    out = St * H.astype(St.dtype)
    return out.at[..., 0].set(St[..., 0])


def high_pass_filter(Y: jax.Array, cutoff_bin: int) -> jax.Array:
    """Zero bins below the cutoff (HighPassFilter, postfilter.h:207-218).
    ``Y``: [..., T, F] half-band."""
    keep = jnp.arange(Y.shape[-1]) >= cutoff_bin
    return jnp.where(keep, Y, 0.0)


def binary_mask_filter(
    Y_left: jax.Array,
    Y_right: jax.Array,
    estimates: jax.Array,
    threshold: float,
    mu: float = 0.1,
    dial: float = 0.0,
    use_left: bool = True,
) -> jax.Array:
    """Binaural binary masking (BinaryMaskFilter, binauralprocessing.h:27-64):
    keep the chosen channel's bin when the estimate is on the target side of
    the threshold, attenuate by ``mu`` otherwise.

    ``estimates``: [T, F] decision statistic (e.g. ITD per bin).
    ``dial``: comparison direction (> threshold keeps when dial >= 0).
    """
    Y = Y_left if use_left else Y_right
    keep = estimates > threshold if dial >= 0 else estimates < threshold
    return jnp.where(keep, Y, mu * Y)
