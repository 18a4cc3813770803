"""Source localization: GCC-PHAT TDOA estimation and SRP-PHAT DOA search.

Batched reformulation of the reference's TDOA/localization stack
(lib/pytdoa.py, tde/tde.cc, localization/localization.cc,
beamformer/beamformer.cc DOA estimators): all frames and all microphone
pairs are processed at once; the (theta, phi) steering grid of the SRP
search is one einsum over a precomputed manifold table.
"""

from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp
from ..ops.complex_ops import ceinsum
import numpy as np

__all__ = [
    "gcc_phat",
    "tdoa_peaks",
    "tdoa_feature_vectors",
    "pair_tdoa_model",
    "pair_tdoa_jacobian",
    "srp_phat_steering_table",
    "srp_phat",
    "srp_dsbla",
    "snapshot_energy",
    "linear_srp_steering_table",
    "linear_srp_doa",
    "mic_pairs",
    "mcc_localize",
    "mcc_reference_grid",
    "mcc_localize_blocks",
]


def mic_pairs(num_mics: int) -> list[tuple[int, int]]:
    """All unordered microphone pairs, reference ordering
    (make_tdoa_front_end, pytdoa.py:593-632)."""
    return list(itertools.combinations(range(num_mics), 2))


def gcc_phat(
    X1: jax.Array,
    X2: jax.Array,
    fftlen: int,
    energy_threshold: float = 64.0,
) -> jax.Array:
    """PHAT-weighted generalized cross-correlation per frame
    (PHATFeature.next, pytdoa.py:32-55).

    ``X1``/``X2``: half-band spectra ``[..., T, F]`` with ``F = fftlen//2+1``.
    Returns time-domain GCC ``[..., T, fftlen]``.  Frames where *both*
    channels' energy (2 sum |X|^2) is at or below the threshold return zeros.
    """
    cross = X1 * jnp.conj(X2)
    mag = jnp.abs(cross)
    cs = cross / jnp.where(mag > 0, mag, 1.0)
    cc = jnp.fft.irfft(cs, n=fftlen, axis=-1)
    e1 = 2.0 * jnp.sum(jnp.abs(X1) ** 2, axis=-1)
    e2 = 2.0 * jnp.sum(jnp.abs(X2) ** 2, axis=-1)
    active = (e1 > energy_threshold) | (e2 > energy_threshold)
    return jnp.where(active[..., None], cc, 0.0)


def tdoa_peaks(cc: jax.Array, samplerate: float) -> tuple[jax.Array, jax.Array]:
    """Highest |CC| peak per frame -> (delay seconds, peak height)
    (TDOAFeature.next, pytdoa.py:87-114).

    ``cc``: ``[..., T, fftlen]``.  Lags above fftlen/2 wrap to negative
    delays.  Frames with all-zero CC give (0 delay, 0 height).
    """
    fftlen = cc.shape[-1]
    mag = jnp.abs(cc)
    idx = jnp.argmax(mag, axis=-1)
    height = jnp.take_along_axis(mag, idx[..., None], axis=-1)[..., 0]
    lag = jnp.where(idx < fftlen // 2, idx, idx - fftlen)
    delay = lag.astype(jnp.float32) / samplerate
    return delay, height


def tdoa_feature_vectors(
    delays: jax.Array,
    heights: jax.Array,
    threshold: float = 0.12,
    minimum_pairs: int = 2,
):
    """Gate pair TDOAs by CC peak height and the minimum-pair requirement
    (TDOAFeatureVector.next, pytdoa.py:267-288).

    ``delays``/``heights``: ``[..., T, P]`` per mic pair.  Returns
    ``(delays, valid_mask [..., T, P], frame_valid [..., T])`` — a fixed-size
    masked representation of the reference's variable-length observation
    lists (static shapes for jit).
    """
    valid = heights > threshold
    frame_valid = jnp.sum(valid.astype(jnp.int32), axis=-1) >= minimum_pairs
    return delays, valid, frame_valid


def pair_tdoa_model(x, mpos, pairs, c: float = 343000.0):
    """Predicted TDOA for each pair given source position ``x`` (3-vector)
    (TDOAFeatureVector.tdoa, pytdoa.py:213-227).  Returns [P]."""
    mpos = jnp.asarray(mpos, jnp.float32)
    i1 = jnp.asarray([p[0] for p in pairs])
    i2 = jnp.asarray([p[1] for p in pairs])
    d1 = jnp.linalg.norm(x - mpos[i1], axis=-1)
    d2 = jnp.linalg.norm(x - mpos[i2], axis=-1)
    return (d1 - d2) / c


def pair_tdoa_jacobian(x, mpos, pairs, c: float = 343000.0):
    """d tdoa / d x for each pair (TDOAFeatureVector.linearize,
    pytdoa.py:248-264).  Returns [P, 3]."""
    mpos = jnp.asarray(mpos, jnp.float32)
    i1 = jnp.asarray([p[0] for p in pairs])
    i2 = jnp.asarray([p[1] for p in pairs])
    diff1 = x - mpos[i1]
    diff2 = x - mpos[i2]
    D1 = jnp.linalg.norm(diff1, axis=-1, keepdims=True)
    D2 = jnp.linalg.norm(diff2, axis=-1, keepdims=True)
    return (diff1 / D1 - diff2 / D2) / c


def srp_phat_steering_table(
    mpos,
    fftlen: int,
    samplerate: float,
    thetas,
    phis,
    sspeed: float = 343740.0,
):
    """Precompute the D&S steering table over a (theta, phi) grid
    (DOAEstimatorSRPDSBLA steering table; beamformer.cc:2879-3211).

    Returns ``(wqH [G, F, C], grid [G, 2])`` where G = len(thetas)*len(phis).
    """
    from .beamforming import array_manifold
    from ..utils.geometry import calc_ca_delays

    mpos = np.asarray(mpos, dtype=np.float64)
    grid = np.array([(t, p) for t in np.atleast_1d(thetas) for p in np.atleast_1d(phis)])
    tables = []
    for theta, phi in grid:
        delays = calc_ca_delays(mpos, phi, theta, sspeed)
        tables.append(np.conj(np.asarray(array_manifold(fftlen, samplerate, delays))))
    return jnp.asarray(np.stack(tables)), jnp.asarray(grid, jnp.float32)


@partial(jax.jit, static_argnums=())
def srp_phat(
    X: jax.Array,
    steering: jax.Array,
    min_bin: int = 0,
    max_bin: int | None = None,
) -> jax.Array:
    """Steered response power with PHAT weighting over all grid points.

    ``X``: snapshots ``[..., T, F, C]``; ``steering``: ``[G, F, C]``.
    Returns SRP ``[..., T, G]`` — argmax over G gives the DOA estimate.
    PHAT: each bin's snapshot is magnitude-normalized before steering so
    every bin votes equally (getSrpPhat, localization/localization.cc).
    """
    mag = jnp.abs(X)
    Xn = X / jnp.where(mag > 0, mag, 1.0)
    Y = ceinsum("gfc,...tfc->...tgf", steering, Xn)
    p = jnp.abs(Y) ** 2
    F = X.shape[-2]
    lo = min_bin
    hi = F if max_bin is None else max_bin
    mask = (jnp.arange(F) >= lo) & (jnp.arange(F) < hi)
    return jnp.sum(jnp.where(mask, p, 0.0), axis=-1)


def snapshot_energy(X: jax.Array, fbin_min: int, fbin_max: int, fftlen2: int) -> jax.Array:
    """Frame energy used by the SRP energy gate (calc_energy,
    beamformer.cc:3221-3251): per bin the SQUARED total channel power
    (|X^H X|^2), interior bins doubled, normalized by ``2*fftLen2*C``.

    ``X``: snapshots ``[..., T, F, C]`` -> ``[..., T]``.
    """
    C = X.shape[-1]
    F = X.shape[-2]
    p = jnp.sum(jnp.abs(X) ** 2, axis=-1)  # [..., T, F] = zdotc(F, F)
    bins = jnp.arange(F)
    w = jnp.where((bins >= fbin_min) & (bins <= fbin_max),
                  jnp.where(bins < fftlen2, 2.0, 1.0), 0.0)
    return jnp.sum(w * p * p, axis=-1) / (2.0 * fftlen2 * C)


def srp_dsbla(
    X: jax.Array,
    weights: jax.Array,
    fbin_min: int = 1,
    fbin_max: int | None = None,
    energy_threshold: float = 0.0,
    n_best: int = 1,
):
    """The reference DOAEstimatorSRPDSBLA estimation protocol
    (beamformer.cc:3125-3197): per frame, the delay-and-sum response power
    per grid direction — mean over bins ``fbin_min..fbin_max`` with interior
    bins doubled (calc_response_power_, :3093-3123) — accumulated over the
    utterance with frames below the energy threshold skipped entirely
    (:3148-3155); the N-best directions are read from the ACCUMULATED
    response powers (get_nbest_hypotheses_from_accrp_, :2944-2984).

    ``X``: half-band snapshots ``[..., T, F, C]``; ``weights``: steering
    table ``[G, F, C]`` in the wq convention (applied as ``w^H X``).
    Returns ``(nbest_idx [..., n_best], acc_rp [..., G], frame_ok [..., T])``.
    """
    F = X.shape[-2]
    fftlen2 = F - 1
    hi = fftlen2 if fbin_max is None else fbin_max
    Y = ceinsum("gfc,...tfc->...tgf", jnp.conj(weights), X)
    p = jnp.abs(Y) ** 2
    bins = jnp.arange(F)
    w = jnp.where((bins >= fbin_min) & (bins <= hi),
                  jnp.where(bins < fftlen2, 2.0, 1.0), 0.0)
    rp = jnp.sum(w * p, axis=-1) / (hi - fbin_min + 1.0)  # [..., T, G]
    energy = snapshot_energy(X, fbin_min, hi, fftlen2)  # [..., T]
    ok = energy >= energy_threshold
    acc = jnp.sum(jnp.where(ok[..., None], rp, 0.0), axis=-2)  # [..., G]
    _, idx = jax.lax.top_k(acc, n_best)
    return idx, acc, ok


def linear_srp_steering_table(
    mpos_x,
    fftlen: int,
    samplerate: float,
    base_mic: int = -1,
    sspeed: float = 343740.0,
    min_doa: float = -np.pi / 2,
    max_doa: float = np.pi / 2,
):
    """Steering table over a sin(theta) grid for a linear array along x
    (LinearArraySRPDOAEstimator.setXPositionsOfMicrophones +
    calcSteeringMatrix, lib/pylocalizer.py:33-80).

    The grid step is the reference's spatial-aliasing-limited
    ``deltaSin = 0.99 * c / (maxDist * fs)``; phases are taken relative to
    ``base_mic`` (default: the middle element, matching ``baseMicX < 0``)
    and weights are 1/chanN so the steered output is a delay-and-sum.

    Two deliberate fixes of that legacy (python2, never-installed) script:
    its steering phase omits the 1/c conversion of element offsets to
    seconds (pylocalizer.py:64-71 multiplies raw positions by 2 pi fs / N),
    and its grid runs sin(theta) over [-pi/2, pi/2] instead of [-1, 1] —
    here the phase is physical (d / c) and the grid covers sin in [-1, 1]
    with the same step.

    Returns ``(wqH [G, F, C], sin_thetas [G])``.
    """
    xpos = np.asarray(mpos_x, np.float64).reshape(-1)
    C = xpos.shape[0]
    max_dist = np.abs(xpos[0] - xpos).max()
    delta_sin = 0.99 * sspeed / (max_dist * samplerate)
    lo, hi = np.sin(min_doa), np.sin(max_doa)
    sin_thetas = np.arange(lo, hi + 1e-12, min(delta_sin, hi - lo))
    if base_mic < 0:
        base_mic = C // 2
    F = fftlen // 2 + 1
    # steering[f, g, c] = exp(-j 2 pi fs / fftlen * f * d_c * s_g) / C
    d = (xpos - xpos[base_mic]) / sspeed  # extra path length per unit sin
    d[base_mic] = 0.0
    phase = (
        -2j
        * np.pi
        * (samplerate / float(fftlen))
        * np.arange(F)[:, None, None]
        * d[None, None, :]
        * sin_thetas[None, :, None]
    )
    table = np.exp(phase) / C
    return (
        jnp.asarray(np.moveaxis(table, 0, 1).astype(np.complex64)),
        jnp.asarray(sin_thetas, jnp.float32),
    )


def linear_srp_doa(
    X: jax.Array,
    steering: jax.Array,
    sin_thetas: jax.Array,
    min_bin: int = 1,
    max_bin: int | None = None,
):
    """DOA of a linear array by steered-response-power maximization
    (LinearArraySRPDOAEstimator.calcSRP, lib/pylocalizer.py:82-120):
    ``Y2[g] = sum_f |w_g(f)^H X(f)|^2`` over ``[min_bin, max_bin)``
    (defaults 1..fftlen/2+1 like the reference), maximized over the grid.

    ``X``: snapshots ``[..., F, C]`` (no PHAT normalization — the reference
    steers the raw spectra).  Returns ``(doa_radians [...], srp [..., G])``.
    """
    Y = ceinsum("gfc,...fc->...gf", jnp.conj(steering), X)
    p = jnp.abs(Y) ** 2
    F = X.shape[-2]
    hi = F if max_bin is None else max_bin
    mask = (jnp.arange(F) >= min_bin) & (jnp.arange(F) < hi)
    srp = jnp.sum(jnp.where(mask, p, 0.0), axis=-1)
    doa = jnp.arcsin(jnp.clip(sin_thetas[jnp.argmax(srp, axis=-1)], -1.0, 1.0))
    return doa, srp


# ---------------------------------------------------------------------------
# GCC variants with noise-weighting (localization/localization.cc:1200-1392)
# ---------------------------------------------------------------------------

def noise_spectra(X1: jax.Array, X2: jax.Array, noise_mask, alpha: float = 0.95):
    """Recursive noise power/cross spectra over frames flagged as noise
    (NoisePowerSpectrum/NoiseCrossSpectrum, localization.h:72-115).

    ``X1``/``X2``: [T, F]; ``noise_mask``: bool [T].  Returns
    (N1 [F], N2 [F], Gn1n2 [F]) — the final recursive estimates.
    """
    def step(carry, inputs):
        n1, n2, g = carry
        x1, x2, is_noise = inputs
        n1n = alpha * n1 + (1 - alpha) * jnp.abs(x1) ** 2
        n2n = alpha * n2 + (1 - alpha) * jnp.abs(x2) ** 2
        gn = alpha * g + (1 - alpha) * x1 * jnp.conj(x2)
        return (
            jnp.where(is_noise, n1n, n1),
            jnp.where(is_noise, n2n, n2),
            jnp.where(is_noise, gn, g),
        ), None

    F = X1.shape[-1]
    init = (jnp.zeros(F), jnp.zeros(F), jnp.zeros(F, X1.dtype))
    (N1, N2, G), _ = jax.lax.scan(step, init, (X1, X2, jnp.asarray(noise_mask)))
    return N1, N2, G


def gcc_weighted(
    X1: jax.Array,
    X2: jax.Array,
    fftlen: int,
    mode: str = "phat",
    Gn1n2=None,
    N1=None,
    N2=None,
    q: float = 0.3,
    smooth_beta: float = 0.0,
):
    """Generalized cross-correlation with the reference's weighting family
    (GCC{Raw,GnnSub,Phat,GnnSubPhat,MLRRaw,MLRGnnSub}::calcCrossSpectrumValue,
    localization.cc:1322-1392) and optional recursive cross-spectrum
    smoothing (beta recursion, localization.cc:1262-1266).

    ``X1``/``X2``: [T, F] half-band spectra.  Returns time-domain GCC
    [T, fftlen].
    """
    cross = X1 * jnp.conj(X2)
    if mode == "raw":
        G = cross
    elif mode == "gnn_sub":
        if Gn1n2 is None:
            # the reference would dereference NULL here (GCCGnnSub,
            # localization.cc:1328-1332) — fail with a clear message instead
            raise ValueError("mode 'gnn_sub' requires the noise cross spectrum Gn1n2")
        G = cross - Gn1n2
    elif mode == "phat":
        mag = jnp.abs(cross)
        G = cross / jnp.where(mag > 0, mag, 1.0)
    elif mode == "gnn_sub_phat":
        # NULL noise stats fall back to plain PHAT, as in the reference
        # (GCCGnnSubPhat, localization.cc:1346-1355)
        num = cross - (0 if Gn1n2 is None else Gn1n2)
        mag = jnp.abs(num)
        G = num / jnp.where(mag > 0, mag, 1.0)
    elif mode in ("mlr_raw", "mlr_gnn_sub"):
        # q1 = 1 - q, q2 = 2*q (GCC::GCC, localization.cc:1220-1221)
        q1, q2 = 1.0 - q, 2.0 * q
        X12 = jnp.abs(X1) ** 2
        X22 = jnp.abs(X2) ** 2
        if N1 is not None and N2 is not None:
            den = q2 * X12 * X22 + q1 * (N2 * X12 + N1 * X22)
        else:
            den = q2 * X12 * X22
        w = jnp.sqrt(X12 * X22) / jnp.maximum(den, 1e-20)
        num = cross - Gn1n2 if (mode == "mlr_gnn_sub" and Gn1n2 is not None) else cross
        G = num * w
    else:
        raise ValueError(f"unknown GCC mode {mode!r}")

    if smooth_beta > 0:
        def step(g, gt):
            g = smooth_beta * g + (1 - smooth_beta) * gt
            return g, g

        _, G = jax.lax.scan(step, jnp.zeros_like(G[0]), G)
    return jnp.fft.irfft(G, n=fftlen, axis=-1)


def find_cc_peak(
    cc: jax.Array,
    samplerate: float,
    min_delay: float = -jnp.inf,
    max_delay: float = jnp.inf,
    interpolate: bool = True,
):
    """Peak of the cross-correlation restricted to a delay window, with
    parabolic interpolation (GCC::findMaximum, localization.cc:1277-1320).

    ``cc``: [..., fftlen].  Returns (delay_seconds, peak_value).
    """
    fftlen = cc.shape[-1]
    idx = jnp.arange(fftlen)
    lag = jnp.where(idx < fftlen // 2, idx, idx - fftlen)
    delay_s = lag / samplerate
    ok = (delay_s >= min_delay) & (delay_s <= max_delay)
    masked = jnp.where(ok, cc, -jnp.inf)
    k = jnp.argmax(masked, axis=-1)
    peak = jnp.take_along_axis(cc, k[..., None], axis=-1)[..., 0]
    base = lag[k].astype(jnp.float32)
    if interpolate:
        km = (k - 1) % fftlen
        kp = (k + 1) % fftlen
        ym = jnp.take_along_axis(cc, km[..., None], axis=-1)[..., 0]
        yp = jnp.take_along_axis(cc, kp[..., None], axis=-1)[..., 0]
        denom = ym - 2 * peak + yp
        frac = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
        base = base + jnp.clip(frac, -1.0, 1.0)
    return base / samplerate, peak


# ---------------------------------------------------------------------------
# MCC localization (localization/mcc_localizer.h:36-311)
# ---------------------------------------------------------------------------

def linear_array_delay_grid(mpos_1d, num_points: int = 36, samplerate: float = 16000.0,
                            sspeed: float = 343740.0):
    """Far-field azimuth search grid for a linear array -> integer sample
    delays (SGB4LinearArray, mcc_localizer.h:66-80).

    Returns (delays_samples [G, C] int, azimuths [G]).
    """
    from ..utils.geometry import calc_la_delays

    az = np.linspace(0.0, np.pi, num_points)
    mpos = np.asarray(mpos_1d, np.float64).reshape(-1, 1)
    d = np.stack([calc_la_delays(mpos, a, sspeed) for a in az])
    return np.round(d * samplerate).astype(np.int64), az


def mcc_reference_grid(num_chan: int, distance_mm: float,
                       samplerate: float = 16000.0):
    """SGB4LinearArray's far-field search grid, replicated exactly
    (mcc_localizer.cc:44-161): microphones at ``micX * distance`` on the
    y axis, sin-spaced azimuth hypotheses over [0, pi/2] then [3pi/2, 2pi),
    per-hypothesis truncated integer sample delays
    ``tau_c = int(fs * (-dist_c sin(az) / c))``.

    Returns ``(tau [G, C] int32, azimuths [G] float, max_sample_delay)``.
    The float32 sinf/asinf grid arithmetic is reproduced so hypothesis
    boundaries land on the same integers as the compiled reference.
    """
    SSPEED = 343740.0
    const_v = np.float32(0.99 * SSPEED / ((num_chan - 1) * distance_mm * samplerate))
    max_time_delay = (num_chan - 1) * distance_mm / SSPEED
    max_sample_delay = int(samplerate * max_time_delay)
    dist = np.arange(num_chan) * float(distance_mm)

    azs = []
    az = np.float32(0.0)
    while True:
        azs.append(float(az))
        s_ = np.float32(np.sin(az))
        if az < np.float32(np.pi / 2):
            ns = s_ + const_v
            az = np.float32(np.pi / 2) if ns >= 1 else np.float32(np.arcsin(ns))
        elif az < np.float32(3 * np.pi / 2):
            az = np.float32(3 * np.pi / 2)
        else:
            ns = s_ + const_v
            if ns + const_v / 2 >= 0:
                break
            az = np.float32(2 * np.pi + np.arcsin(ns))
    azs = np.asarray(azs)
    delays = -dist[None, :] * np.sin(azs.astype(np.float64))[:, None] / SSPEED
    tau = (samplerate * delays).astype(np.int32)  # C truncation toward zero
    return tau, azs, max_sample_delay


def mcc_localize_blocks(x, block_len: int, tau_grid, max_sample_delay: int,
                        num_best: int = 1, normalize_variance: bool = True):
    """The reference's block-online MCC protocol, exactly
    (MCCLocalizer::next -> calcCovarianceMatrix -> eigen cost,
    mcc_localizer.cc:306-460): per block, an UNCENTERED covariance over
    frames [0, L-maxD); ``calcCovarianceMatrix`` refills the SampleHolder
    with the CURRENT block before its frame loop, so negative lags read
    the block's own tail — a circular wrap, not the previous block.  Cost
    = ``sum log eig(R) - sum log diag(R)``, N-best ascending.

    ``x``: [C, T]; ``tau_grid``: [G, C] ints.  Returns per block
    ``(best_idx [nblocks, num_best], mccc [nblocks, G])``.
    """
    x = np.asarray(x, np.float64)
    C, T = x.shape
    tau = np.asarray(tau_grid)
    G = tau.shape[0]
    maxD = int(max_sample_delay)
    nblocks = T // block_len
    best_all, mccc_all = [], []
    for k in range(nblocks):
        base = x[:, k * block_len : (k + 1) * block_len]
        f = np.arange(0, block_len - maxD)
        # aligned[g, c, n] = base[c, (f_n + tau[g, c]) wrapped]
        idx = (f[None, None, :] + tau[:, :, None]) % block_len
        al = np.take_along_axis(
            np.broadcast_to(base[None], (G, C, base.shape[1])), idx, axis=2
        )
        R = np.einsum("gcn,gdn->gcd", al, al) / len(f)
        ev = np.linalg.eigvalsh(R)
        cost = np.sum(np.log(np.maximum(np.abs(ev), 1e-300)), axis=-1)
        if normalize_variance:
            cost = cost - np.sum(
                np.log(np.maximum(np.diagonal(R, axis1=1, axis2=2), 1e-300)),
                axis=-1,
            )
        order = np.argsort(cost, kind="stable")[:num_best]
        best_all.append(order)
        mccc_all.append(1.0 - np.exp(cost))
    return np.stack(best_all), np.stack(mccc_all)


def mcc_localize(x: jax.Array, delay_grid, num_best: int = 1,
                 normalize_variance: bool = True):
    """Multichannel-cross-correlation localization over a delay grid
    (MCCLocalizer::search + calcObjectiveFunction, mcc_localizer.cc:360-440).

    For each hypothesis, the channels are aligned by the grid's integer
    sample delays and the cost is ``logdet(R) - sum log diag(R)`` of the
    aligned covariance — minimal when the channels are maximally correlated
    (MCCC = 1 - exp(cost)).

    ``x``: time block [C, T]; ``delay_grid``: [G, C] samples.
    Returns (best_indices [num_best], mccc [G]).
    """
    x = jnp.asarray(x)
    C, T = x.shape
    dg = np.asarray(delay_grid)
    G = dg.shape[0]
    max_d = int(np.abs(dg).max())
    xp = jnp.pad(x, ((0, 0), (max_d, max_d)))

    # aligned[g, c, t] = x[c, t + delay[g, c]]
    idx = jnp.arange(T)[None, None, :] + jnp.asarray(dg)[:, :, None] + max_d
    aligned = jnp.take_along_axis(
        jnp.broadcast_to(xp[None], (G, C, xp.shape[-1])), idx, axis=-1
    )
    mean = jnp.mean(aligned, axis=-1, keepdims=True)
    Rc = jnp.einsum("gct,gdt->gcd", aligned - mean, aligned - mean,
                    precision=jax.lax.Precision.HIGHEST) / T
    diag = jnp.diagonal(Rc, axis1=-2, axis2=-1)
    if normalize_variance:
        sign, ldet = jnp.linalg.slogdet(Rc)
        cost = ldet - jnp.sum(jnp.log(jnp.maximum(diag, 1e-20)), axis=-1)
    else:
        sign, cost = jnp.linalg.slogdet(Rc)
    mccc = 1.0 - jnp.exp(cost)
    best = jax.lax.top_k(mccc, num_best)[1]
    return best, mccc
