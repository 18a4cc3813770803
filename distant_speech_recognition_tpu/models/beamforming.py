"""Subband-domain beamforming, batched over all frequency bins.

Batched reformulation of the reference beamformers.  The reference iterates
per frame and per frequency bin (`SubbandDS::next` beamformer.cc:1095-1157,
`SubbandGSCRLSBeamformer.__iter__` pybeamformer.py:816-898); here snapshots
are dense tensors ``X[..., T, F, C]`` (time, frequency bin 0..M/2, channel)
and every per-bin small-matrix operation (covariance, inverse, generalized
eigendecomposition, Gram-Schmidt) is vmapped/batched over all F bins — the
per-bin independence the reference proves by construction is exactly what
shards across devices (see parallel/).

Weight/output conventions follow the reference:
  - manifold  vs[f, c]   = exp(-j 2 pi f_k tau_c) / C      (pybeamformer.py:284-307)
  - quiescent wqH        = conj(vs)                        (pybeamformer.py:744, 888)
  - output    Y[t, f]    = sum_c wqH[f, c] X[t, f, c]      (= w^H X, beamformer.cc:1208-1243)
  - bins 0..M/2 computed, rest conjugate-mirrored          (beamformer.cc:1142-1152)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from ..ops.complex_ops import ceinsum
import numpy as np

__all__ = [
    "snapshots",
    "array_manifold",
    "blocking_matrix",
    "apply_weights",
    "delay_and_sum_weights",
    "lcmv_weights",
    "diffuse_noise_coherence",
    "mvdr_weights",
    "superdirective_weights",
    "accumulate_sos",
    "label_to_frame_mask",
    "improve_matrix_condition",
    "smi_mvdr",
    "blind_mvdr_weights",
    "gev_weights",
    "frame_energy",
]


# ---------------------------------------------------------------------------
# snapshots & manifolds
# ---------------------------------------------------------------------------

def snapshots(subbands: jax.Array) -> jax.Array:
    """Per-channel full-M subband frames -> per-bin snapshot tensor.

    ``subbands``: ``[C, ..., T, M]`` complex (channel-major, as produced by a
    batched analysis bank).  Returns ``X [..., T, F, C]`` with ``F = M//2+1``
    (the reference's ``SnapShotArray::update``, beamformer.cc:62, transposes
    per-channel spectra into per-frequency vectors; only half the band is
    needed by hermitian symmetry).
    """
    M = subbands.shape[-1]
    half = subbands[..., : M // 2 + 1]
    return jnp.moveaxis(half, 0, -1)


def frame_energy(subbands_ch0: jax.Array) -> jax.Array:
    """Per-frame energy of the reference channel's full-M spectrum / M.

    Matches ``MultiChannelSource.update_snapshot_array(chan_no=0) / fftlen``
    (pybeamformer.py:263-276): ``sum_m |X_m|^2 / M``.
    """
    M = subbands_ch0.shape[-1]
    return jnp.sum(jnp.abs(subbands_ch0) ** 2, axis=-1) / M


def frame_energy_half(subbands_half_ch0: jax.Array, M: int) -> jax.Array:
    """`frame_energy` computed from bins ``0..M/2`` only.

    Exact by hermitian symmetry: interior bins count twice, DC and Nyquist
    once — identical to the full-M sum of `frame_energy`.
    """
    p = jnp.abs(subbands_half_ch0) ** 2
    interior = 2.0 * jnp.sum(p[..., 1 : M // 2], axis=-1)
    return (p[..., 0] + p[..., M // 2] + interior) / M


def array_manifold(fftlen: int, samplerate: float, delays, half_band_shift: bool = False) -> jax.Array:
    """Array manifold vectors for bins ``0..M/2``: ``vs [F, C]``.

    ``vs[f] = exp(-j 2 pi f Delta_f tau) / C`` (calc_array_manifold_f,
    pybeamformer.py:284-307; calcMainlobe beamformer.cc:502-565).
    """
    delays = jnp.asarray(delays, jnp.float32)
    C = delays.shape[-1]
    F = fftlen // 2 + 1
    delta_f = samplerate / float(fftlen)
    k = jnp.arange(F, dtype=jnp.float32)
    if half_band_shift:
        k = k + 0.5
    phase = -2.0 * jnp.pi * k[:, None] * delta_f * delays[None, :]
    return jnp.exp(1j * phase.astype(jnp.float32)) / C


def blocking_matrix(vs: jax.Array, Nc: int = 1) -> jax.Array:
    """Blocking matrix ``B [..., C, C-Nc]`` with ``vs^T B = 0``.

    Perpendicular projection + Gram-Schmidt over the first ``C-Nc`` columns
    (calc_blocking_matrix, pybeamformer.py:310-341; the C++ twin is
    calc_blocking_matrix_ beamformer.cc:373-454).  The column loop is a
    static Python loop over at most C-Nc (<= 7) columns; everything is
    batched over leading (frequency) dims.
    """
    vs = jnp.asarray(vs)
    C = vs.shape[-1]
    bsize = C - Nc
    norm_vs = jnp.sum(vs * jnp.conj(vs), axis=-1, keepdims=True)[..., None]
    eye = jnp.eye(C, dtype=vs.dtype)
    # PcPerp[i, j] = I - conj(vs_i) vs_j / ||vs||^2
    pc_perp = eye - jnp.conj(vs)[..., :, None] * vs[..., None, :] / jnp.where(
        jnp.abs(norm_vs) > 0, norm_vs, 1.0
    )
    cols = []
    for idim in range(bsize):
        vec = pc_perp[..., :, idim]
        for prev in cols:
            ip = jnp.sum(jnp.conj(prev) * vec, axis=-1, keepdims=True)
            vec = vec - prev * ip
        nrm = jnp.sqrt(jnp.abs(jnp.sum(jnp.conj(vec) * vec, axis=-1, keepdims=True)))
        cols.append(vec / jnp.where(nrm > 0, nrm, 1.0))
    B = jnp.stack(cols, axis=-1)
    return jnp.where(jnp.abs(norm_vs) > 0, B, jnp.zeros_like(B))


def apply_weights(wqH: jax.Array, X: jax.Array) -> jax.Array:
    """Fixed-weight beamformer output ``Y[..., t, f] = sum_c wqH[f,c] X[...,t,f,c]``."""
    return ceinsum("fc,...tfc->...tf", wqH, X)


def delay_and_sum_weights(fftlen: int, samplerate: float, delays) -> jax.Array:
    """D&S conjugate weights ``wqH [F, C]`` (SubbandDS, beamformer.cc:1095-1157)."""
    return jnp.conj(array_manifold(fftlen, samplerate, delays))


# ---------------------------------------------------------------------------
# LCMV / null-steering
# ---------------------------------------------------------------------------

def lcmv_weights(constraints: jax.Array, gains) -> jax.Array:
    """LCMV quiescent weights ``wq = C (C^H C)^{-1} g`` per bin.

    ``constraints``: ``[..., Nc, C]`` rows are manifold vectors (target first,
    then jammers); ``gains``: ``[Nc]`` (1 for targets, 0 for nulls).
    Reference: calc_null_beamformer_ beamformer.cc:299-363.
    Returns conjugate weights ``wqH [..., C]`` ready for `apply_weights`.
    """
    Ct = jnp.asarray(constraints)
    g = jnp.asarray(gains, Ct.dtype)
    Cm = jnp.swapaxes(Ct, -1, -2)  # [..., C, Nc]
    gram = jnp.conj(Ct) @ Cm  # C^H C  [..., Nc, Nc]
    # Pseudo-inverse solve: the reference falls back to pinv when the Gram is
    # singular (calc_null_beamformer_ -> pseudoinverse, beamformer.cc:330-360)
    # — e.g. at bin 0 where all manifolds coincide.
    inv = _pinv_hermitian(gram, 1.0e-8)
    v = inv @ jnp.broadcast_to(g[..., None], gram.shape[:-1] + (1,))
    wq = (Cm @ v)[..., 0]
    return jnp.conj(wq)


# ---------------------------------------------------------------------------
# MVDR / super-directive
# ---------------------------------------------------------------------------

def diffuse_noise_coherence(mpos, fftlen: int, samplerate: float, sspeed: float = 343740.0) -> jax.Array:
    """Spherically-isotropic (diffuse) noise coherence ``Gamma [F, C, C]``.

    ``Gamma_mn(f) = sinc(2 f d_mn / c)`` with normalized sinc
    (SubbandMVDR::set_diffuse_noise_model, beamformer.cc:2442-2509).
    """
    mpos = np.asarray(mpos, dtype=np.float64)[:, :3]
    d = np.sqrt(((mpos[:, None, :] - mpos[None, :, :]) ** 2).sum(-1))  # [C, C]
    F = fftlen // 2 + 1
    freqs = np.arange(F) * samplerate / float(fftlen)
    gamma = np.sinc(2.0 * freqs[:, None, None] * d[None] / sspeed)
    return jnp.asarray(gamma.astype(np.float32)).astype(jnp.complex64)


def _pinv_hermitian(R: jax.Array, threshold: float) -> jax.Array:
    """Batched pseudo-inverse of Hermitian matrices, zeroing eigenvalues with
    magnitude below ``threshold`` (the reference uses LINPACK csvdc pinv with
    an absolute singular-value threshold, beamformer.cc:232-289)."""
    w, v = jnp.linalg.eigh(R)
    inv_w = jnp.where(jnp.abs(w) > threshold, 1.0 / w, 0.0)
    vw = v * inv_w.astype(v.dtype)[..., None, :]
    return ceinsum("...ij,...kj->...ik", vw, jnp.conj(v))


def mvdr_weights(R: jax.Array, vs: jax.Array, dthreshold: float = 1.0e-8) -> jax.Array:
    """MVDR conjugate weights from noise covariance ``R [F, C, C]`` and
    manifold ``vs [F, C]``.

    Per SubbandMVDR::calc_mvdr_weights (beamformer.cc:2350-2402):
    bin 0 gets all-ones weights; bins >= 1 get
    ``w = R^-1 d / (C d^H R^-1 d)`` with ``d`` the 1/C-scaled manifold
    (the scalings cancel to the standard MVDR solution).
    Returns ``wqH = conj(w) [F, C]``.
    """
    C = vs.shape[-1]
    invR = _pinv_hermitian(R, dthreshold)
    tmp = ceinsum("...ji,...j->...i", jnp.conj(invR), vs)  # invR^H d
    lam = jnp.sum(jnp.conj(tmp) * vs, axis=-1, keepdims=True)  # d^H invR d
    w = tmp / (lam * C)
    w = w.at[..., 0, :].set(jnp.ones((C,), w.dtype))
    return jnp.conj(w)


def superdirective_weights(
    mpos,
    delays,
    fftlen: int,
    samplerate: float,
    sspeed: float = 343740.0,
    mu: float = 0.01,
) -> jax.Array:
    """Super-directive MVDR against the diffuse-noise coherence with absolute
    diagonal loading ``mu`` (SubbandMVDRBeamformer.calc_sd_beamformer_weights,
    pybeamformer.py:561-586; loading per beamformer.cc:2511-2530).
    Returns ``wqH [F, C]``.
    """
    vs = array_manifold(fftlen, samplerate, delays)
    R = diffuse_noise_coherence(mpos, fftlen, samplerate, sspeed)
    C = R.shape[-1]
    R = R + mu * jnp.eye(C, dtype=R.dtype)
    return mvdr_weights(R, vs)


# ---------------------------------------------------------------------------
# second-order-statistics batch beamformers (SMI-MVDR / blind MVDR / GEV)
# ---------------------------------------------------------------------------

def label_to_frame_mask(num_frames: int, shiftlen: int, samplerate: float, target_labs) -> np.ndarray:
    """Time-segment VAD labels -> boolean per-frame target mask.

    ``target_labs``: list of (start_sec, end_sec) pairs, end < 0 = open-ended
    (accu_stats_from_label, pybeamformer.py:948-991).
    """
    t = np.arange(num_frames) * shiftlen / float(samplerate)
    mask = np.zeros(num_frames, dtype=bool)
    for start, end in target_labs:
        if end < 0:
            mask |= t >= start
        else:
            mask |= (t >= start) & (t <= end)
    return mask


def accumulate_sos(X: jax.Array, weights: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Weighted covariance accumulation over time, batched over bins.

    ``X``: ``[..., T, F, C]`` snapshots; ``weights``: ``[..., T]`` (per frame)
    or ``[..., T, F]`` (TF mask) nonnegative weights.
    Returns ``(R [..., F, C, C], counts [..., F])`` — the *sums*, not yet
    normalized (mirrors accu_stats_from_label/tfmask, pybeamformer.py:1048-1165;
    the psum-ready reduction for time-sharded execution).
    """
    if weights.ndim < X.ndim - 1:
        weights = weights[..., None]
    w = jnp.broadcast_to(weights, X.shape[:-1]).astype(jnp.float32)
    Xw = X * w[..., None].astype(X.dtype)
    R = ceinsum("...tfc,...tfd->...fcd", Xw, jnp.conj(X))
    counts = jnp.sum(w, axis=-2)
    return R, counts


def improve_matrix_condition(R: jax.Array, gamma: float = 1.0e-6) -> jax.Array:
    """Trace-scaled diagonal loading (pybeamformer.py:1200-1207, nn-gev style):
    ``(R + gamma tr(R)/C I) / (1 + gamma)``."""
    C = R.shape[-1]
    tr = jnp.trace(R, axis1=-2, axis2=-1)[..., None, None]
    eye = jnp.eye(C, dtype=R.dtype)
    return (R + gamma * tr * eye / C) / (1.0 + gamma)


def smi_mvdr(
    R_noise_sum: jax.Array,
    noise_frames,
    fftlen: int,
    samplerate: float,
    delays,
    mu: float = 1.0e-4,
) -> jax.Array:
    """Sample-matrix-inversion MVDR weights ``wqH [F, C]``.

    Noise covariance = sum / frame count, absolute diagonal loading ``mu``
    (SubbandSMIMVDRBeamformer, pybeamformer.py:931-1024).
    """
    Rn = R_noise_sum / jnp.maximum(jnp.asarray(noise_frames, jnp.float32), 1.0)[..., None, None]
    C = Rn.shape[-1]
    Rn = Rn + mu * jnp.eye(C, dtype=Rn.dtype)
    vs = array_manifold(fftlen, samplerate, delays)
    return mvdr_weights(Rn, vs)


def blind_mvdr_weights(
    R_target: jax.Array,
    R_noise: jax.Array,
    ref_micx: int = 0,
    offset: float = 0.0,
) -> jax.Array:
    """Blind (mask-based) MVDR: ``wqH = conj(Rn^-1 Rt u / (offset + tr(Rn^-1 Rt)))``.

    Inputs are the *normalized, loaded* covariance matrices ``[F, C, C]``
    (SubbandBlindMVDRBeamformer.calc_beamformer_weights, pybeamformer.py:1210-1247).
    """
    C = R_noise.shape[-1]
    no = jnp.linalg.solve(R_noise, R_target)  # Rn^-1 Rt
    u = jnp.zeros((C,), no.dtype).at[ref_micx].set(1.0)
    num = no @ u
    tr = jnp.trace(no, axis1=-2, axis2=-1)[..., None]
    return jnp.conj(num / (offset + tr))


def gev_weights(R_target: jax.Array, R_noise: jax.Array) -> jax.Array:
    """GEV (max-SNR) conjugate weights ``wqH [F, C]``.

    Top generalized eigenvector of ``(Rt, Rn)`` per bin via Cholesky
    whitening (scipy.linalg.eigh(Rt, Rn) in the reference,
    pybeamformer.py:1282-1307), then Paderborn-style cross-bin phase
    alignment — a prefix sum of consecutive inner-product phases, computed
    with cumsum instead of the reference's sequential bin loop
    (pybeamformer.py:1301-1303) — then conjugation.

    Inputs: normalized/loaded covariances ``[F, C, C]`` (Rn additionally
    trace/C-normalized by the caller per pybeamformer.py:1309-1329).
    """
    L = jnp.linalg.cholesky(R_noise)
    Linv = jnp.linalg.inv(L)
    Cw = Linv @ R_target @ jnp.swapaxes(jnp.conj(Linv), -1, -2)
    w, v = jnp.linalg.eigh(Cw)
    top = v[..., :, -1]
    x = jnp.einsum("...ji,...j->...i", jnp.conj(Linv), top)  # L^-H y
    # cross-bin phase alignment: theta_f = cumsum(angle(<x_f, x_{f-1}>_c))
    inner = jnp.sum(x[..., 1:, :] * jnp.conj(x[..., :-1, :]), axis=-1)
    phi = jnp.angle(inner)
    theta = jnp.cumsum(phi, axis=-1)
    corr = jnp.exp(-1j * theta).astype(x.dtype)
    x = jnp.concatenate([x[..., :1, :], x[..., 1:, :] * corr[..., None]], axis=-2)
    return jnp.conj(x)


def weights_to_fir(woH: jax.Array, window_type: int = 1):
    """Export per-channel time-domain FIR filters from subband weights
    (BeamformerWeights::write_fir_coeff, beamformer.cc:775-830): the
    conjugate total weight per bin is linear-phase-shifted by fftLen/2
    (``e^{j pi (f+1)}``), mirrored, inverse-transformed (normalized), and
    windowed.

    ``woH``: [F, C] conjugate weights over bins 0..M/2.  Returns real FIR
    coefficients [C, fftLen].
    """
    from ..ops.filterbank import hermitian_mirror
    from ..ops.windows import get_window

    F, C = woH.shape
    fftlen = 2 * (F - 1)
    k = jnp.arange(F)
    shift = jnp.exp(1j * jnp.pi * (k + 1.0)).astype(woH.dtype)
    half = woH * shift[:, None]  # note: woH is already the conjugate weight
    full = hermitian_mirror(half.T, fftlen)  # [C, fftlen]
    fir = jnp.real(jnp.fft.ifft(full, axis=-1))
    win = jnp.asarray(get_window(window_type, fftlen), fir.dtype)
    return fir * win


def save_weights(path: str, **named_weights) -> None:
    """Persist beamformer weights (SubbandBeamformer.save_active_weights,
    pybeamformer.py:452-460) as a .npz archive."""
    np.savez(path, **{k: np.asarray(v) for k, v in named_weights.items()})


def load_weights(path: str) -> dict:
    """Load weights saved by `save_weights`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
