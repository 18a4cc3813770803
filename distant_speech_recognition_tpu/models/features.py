"""Classic speech front-end feature chain (MFCC pipeline) and helpers.

Batched reformulation of feature/feature.cc: framing, preemphasis, Hamming
windowing, zero-padded real FFT, spectral power, mel filterbank, log,
cosine-transform cepstra, cepstral mean subtraction, frame splicing and
linear (LDA) transforms.  The per-frame pull graph becomes array ops over
``[..., T, dim]`` tensors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "frame_signal",
    "preemphasis",
    "hamming_window",
    "fft_feature",
    "spectral_power",
    "mel_matrix",
    "mel_feature",
    "log_feature",
    "dct_matrix",
    "cepstral_feature",
    "mean_subtraction",
    "adjacent_splice",
    "mfcc",
]


def frame_signal(x: jax.Array, block_len: int, shift_len: int) -> jax.Array:
    """[..., T] -> [..., n_frames, block_len] (SampleFeature framing with
    pad_zeros semantics, feature.cc:605-648)."""
    T = x.shape[-1]
    n = max(-(-T // shift_len), 1)
    pad = (n - 1) * shift_len + block_len - T
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    idx = jnp.arange(n)[:, None] * shift_len + jnp.arange(block_len)[None, :]
    return x[..., idx]


def preemphasis(frames: jax.Array, mu: float = 0.95) -> jax.Array:
    """y[i] = x[i] - mu * x[i-1] with the prior sample carried across frames
    (PreemphasisFeature::next, feature.cc:1128-1145; prior starts at 0)."""
    prior = jnp.concatenate(
        [
            jnp.zeros(frames.shape[:-2] + (1, 1), frames.dtype),
            frames[..., :-1, -1:],
        ],
        axis=-2,
    )
    shifted = jnp.concatenate([prior, frames[..., :-1]], axis=-1)
    return frames - mu * shifted


def hamming_window(frames: jax.Array) -> jax.Array:
    """Hamming windowing (HammingFeature, feature.cc:1177-1202)."""
    n = frames.shape[-1]
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return frames * jnp.asarray(w, frames.dtype)


def fft_feature(frames: jax.Array, fftlen: int) -> jax.Array:
    """Zero-padded real FFT -> full complex spectrum [..., T, fftlen]
    (FFTFeature::next, feature.cc:1234-1259)."""
    half = jnp.fft.rfft(frames, n=fftlen, axis=-1)
    from ..ops.filterbank import hermitian_mirror

    return hermitian_mirror(half, fftlen)


def spectral_power(spec: jax.Array, pow_n: int | None = None) -> jax.Array:
    """|X|^2 over the first pow_n bins (SpectralPowerFeature,
    feature.cc:1289-1310)."""
    p = jnp.abs(spec) ** 2
    if pow_n is not None:
        p = p[..., :pow_n]
    return p


def _mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _hertz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_matrix(
    pow_n: int,
    samplerate: float,
    low: float = 100.0,
    up: float = 6800.0,
    filter_n: int = 30,
) -> np.ndarray:
    """Dense mel filterbank matrix [filter_n, pow_n].

    Transliterates MelFeature::SparseMatrix_::melScaleOrg
    (feature.cc:1904-1965) including its quirks: height normalized to
    2/width, and the frequency grid advanced *before* evaluating each
    coefficient (so bin i uses freq (start+i+1)*df).
    """
    df = samplerate / (4.0 * (pow_n // 2))
    mlow, mup = _mel(low), _mel(up)
    dm = (mup - mlow) / (filter_n + 1)
    M = np.zeros((filter_n, pow_n))
    for x in range(filter_n):
        left = _hertz(x * dm + mlow)
        center = _hertz((x + 1.0) * dm + mlow)
        right = _hertz((x + 2.0) * dm + mlow)
        height = 2.0 / (right - left)
        slope1 = height / (center - left)
        slope2 = height / (center - right)
        start = int(np.ceil(left / df))
        end = int(np.floor(right / df))
        freq = start * df
        for i in range(end - start + 1):
            freq += df
            if start + i >= pow_n:
                break
            M[x, start + i] = slope1 * (freq - left) if freq <= center else slope2 * (freq - right)
    return M


def mel_feature(power: jax.Array, mel_mat) -> jax.Array:
    """Apply the mel filterbank: [..., T, pow_n] -> [..., T, filter_n]."""
    return jnp.einsum("fp,...tp->...tf", jnp.asarray(mel_mat, power.dtype), power,
                      precision=jax.lax.Precision.HIGHEST)


def log_feature(x: jax.Array, m: float = 1.0, a: float = 1.0,
                sphinx_flooring: bool = False) -> jax.Array:
    """``m * log10(x + a)`` with the reference's flooring (LogFeature::next,
    feature.cc:2342-2358): sphinx mode floors the raw value at 1e-5 (no
    offset); otherwise ``x + a <= 0`` is replaced by 1 (log -> 0).

    (Round-3 parity fix: this was previously ``ln(max(x, 1))`` — caught by
    the compiled-golden MFCC test, tests/test_cpp_golden_tail.py.)"""
    if sphinx_flooring:
        val = jnp.maximum(x, 1.0e-5)
    else:
        val = x + a
        val = jnp.where(val <= 0.0, 1.0, val)
    return m * jnp.log10(val)


def dct_matrix(ncep: int, nmel: int, dct_type: int = 1) -> np.ndarray:
    """Cosine transform matrix per gsl_matrix_float_set_cosine
    (matrix/gslmatrix.cc:107-131) plus the Sphinx legacy variant
    (CepstralFeature::sphinxLegacy_, feature.cc:2389-2400).

    type 0: DCT-I-like (endpoint weights 1 / cos(k pi), interior x2)
    type 1: DCT-II     cos(k pi (l+0.5) / nmel)
    type 2: Sphinx legacy (scaled DCT-II / nmel, first column halved)
    """
    C = np.zeros((ncep, nmel))
    if dct_type == 0:
        for k in range(ncep):
            fac = k * np.pi / (nmel - 1)
            C[k, 0] = 1.0
            for l in range(1, nmel - 1):
                C[k, l] = 2.0 * np.cos(fac * l)
            C[k, nmel - 1] = np.cos(k * np.pi)
    elif dct_type == 1:
        for k in range(ncep):
            C[k] = np.cos(k * np.pi * (np.arange(nmel) + 0.5) / nmel)
    elif dct_type == 2:
        for k in range(ncep):
            C[k] = np.cos(np.pi * k * (np.arange(nmel) + 0.5) / nmel) / nmel
        C[:, 0] *= 0.5
    else:
        raise ValueError("DCT type must be 0, 1 or 2")
    return C


def cepstral_feature(log_mel: jax.Array, ncep: int = 13, dct_type: int = 1) -> jax.Array:
    """Log-mel -> cepstra (CepstralFeature, feature.cc:2370-2410)."""
    C = dct_matrix(ncep, log_mel.shape[-1], dct_type)
    return jnp.einsum("cf,...tf->...tc", jnp.asarray(C, log_mel.dtype), log_mel,
                      precision=jax.lax.Precision.HIGHEST)


def mean_subtraction(feat: jax.Array, dev_norm: float = 0.0) -> jax.Array:
    """Batch cepstral mean (and optional variance) normalization
    (MeanSubtractionFeature, feature.cc:2457+, batch mode)."""
    mean = jnp.mean(feat, axis=-2, keepdims=True)
    out = feat - mean
    if dev_norm > 0:
        dev = jnp.std(feat, axis=-2, keepdims=True)
        out = out / (dev_norm * jnp.maximum(dev, 1e-10))
    return out


def adjacent_splice(feat: jax.Array, adjacent_n: int = 4) -> jax.Array:
    """Stack +-adjacent_n context frames, edge-padded
    (AdjacentFeature, feature.h:1100-1130)."""
    T = feat.shape[-2]
    pads = [feat[..., :1, :]] * adjacent_n + [feat] + [feat[..., -1:, :]] * adjacent_n
    padded = jnp.concatenate(pads, axis=-2)
    cols = [
        jax.lax.slice_in_dim(padded, i, i + T, axis=feat.ndim - 2)
        for i in range(2 * adjacent_n + 1)
    ]
    return jnp.concatenate(cols, axis=-1)


def mfcc(
    x: jax.Array,
    samplerate: float = 16000.0,
    block_len: int = 320,
    shift_len: int = 160,
    fftlen: int = 512,
    filter_n: int = 30,
    ncep: int = 13,
    low: float = 100.0,
    up: float = 6800.0,
    mu: float = 0.95,
    cmn: bool = True,
) -> jax.Array:
    """The full MFCC chain as composed by unit_test/mfcc_extractor.py:
    frame -> preemphasis -> Hamming -> FFT -> power -> mel -> log -> DCT
    (-> CMN)."""
    frames = frame_signal(x, block_len, shift_len)
    frames = preemphasis(frames, mu)
    frames = hamming_window(frames)
    spec = jnp.fft.rfft(frames, n=fftlen, axis=-1)
    power = spectral_power(spec, fftlen // 2)
    mel = mel_feature(power, mel_matrix(fftlen // 2, samplerate, low, up, filter_n))
    cep = cepstral_feature(log_feature(mel), ncep)
    if cmn:
        cep = mean_subtraction(cep)
    return cep


def spectral_resampling(power: jax.Array, ratio: float, out_dim: int | None = None) -> jax.Array:
    """Resample a power spectrum by a frequency ratio with linear
    interpolation (SpectralResamplingFeature, feature.h:743-771).

    ``power``: [..., T, D] -> [..., T, out_dim].
    """
    D = power.shape[-1]
    out = out_dim or D
    src = jnp.arange(out) * ratio * (D / out)
    lo = jnp.clip(jnp.floor(src).astype(jnp.int32), 0, D - 1)
    hi = jnp.clip(lo + 1, 0, D - 1)
    frac = src - lo
    return power[..., lo] * (1.0 - frac) + power[..., hi] * frac


def samplerate_conversion(x: jax.Array, source_rate: int, dest_rate: int) -> jax.Array:
    """Sample-rate conversion (SamplerateConversionFeature, feature.h:775-809;
    the reference wraps libsamplerate) via polyphase FFT resampling."""
    from scipy.signal import resample_poly
    import math

    g = math.gcd(int(source_rate), int(dest_rate))
    up, down = dest_rate // g, source_rate // g
    return jnp.asarray(resample_poly(np.asarray(x), up, down, axis=-1).astype(np.float32))


def vtln(power: jax.Array, ratio: float, edge: float = 0.8) -> jax.Array:
    """Piecewise-linear vocal-tract-length normalization of a power spectrum
    (VTLNFeature::nextOrg, feature.cc: two-segment warp with bin-integral
    resampling).  ``power``: [..., T, D]; warp factor ``ratio``."""
    D = power.shape[-1]
    yedge = jnp.minimum(edge / ratio, 1.0)
    b = jnp.where(yedge < 1.0, (1.0 - edge) / jnp.maximum(1.0 - yedge, 1e-9), 0.0)

    Y = jnp.arange(D + 1) / D
    X = jnp.where(Y < yedge, ratio * Y, b * Y + 1.0 - b) * D  # warped bin edges

    # integrate the (piecewise-constant) source spectrum over [X0, X1]
    cum = jnp.cumsum(power, axis=-1)
    cum = jnp.concatenate([jnp.zeros_like(cum[..., :1]), cum], axis=-1)  # [.., D+1]

    def integral(pos):
        p = jnp.clip(pos, 0.0, D)
        lo = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, D - 1)
        frac = p - lo
        return cum[..., lo] + frac * power[..., lo]

    return integral(X[1:]) - integral(X[:-1])


def vtln_ff_matrix(N: int, ratio: float, edge: float = 1.0) -> np.ndarray:
    """Warp matrix of the reference's VERSION-2 VTLN (VTLNFeature::nextFF,
    feature.cc — the variant the reference's MFCC extractor uses): each
    source bin's [s-0.5, s+0.5] interval is warped by a two-segment
    piecewise-linear map with breakpoint ``b = N*edge`` (second slope
    ``(N - ratio*b)/(N - b)`` only when ratio < 1), spread over the
    covered destination bins with endpoint fractions, and each destination
    bin is normalized by its accumulated weight.  Note ratio = 1 is NOT the
    identity: the half-bin endpoints make it a [0.25, 0.5, 0.25] smoother.

    Reference quirk, reproduced exactly (verified vs the compiled C++):
    the gate ``if (i1 <= N-1)`` compares the signed ``i1`` against the
    UNSIGNED ``N-1``, so source bin 0 (whose ``i1 = floor(-0.5*slope)`` is
    -1, wrapping to a huge unsigned) never contributes — destination bin 0
    is pure spill-over from source bin 1.

    Returns ``M`` [N, N] so that ``warped = power @ M.T``.
    """
    # the reference computes the warp in single precision (float locals,
    # feature.cc nextFF) — the floor/ceil boundaries differ from f64 math
    # (e.g. 12.5 * 1.2f = 15.000001 -> ceil 16), so mirror its dtype
    f32 = np.float32
    b = f32(N * edge)
    slope1 = f32(ratio)
    slope2 = slope1 if ratio >= 1.0 else f32((N - slope1 * b) / (N - b))

    def warp(s):
        return f32(s * slope1) if s <= b else f32(b * slope1 + f32(s - b) * slope2)

    M = np.zeros((N, N))
    Wn = np.zeros(N)
    for s in range(N):
        d1, d2 = warp(f32(s - 0.5)), warp(f32(s + 0.5))
        i1, i2 = int(np.floor(d1)), int(np.ceil(d2))
        if i1 > N - 1 or i1 < 0:  # signed-vs-unsigned gate, see docstring
            continue
        a1 = 1.0 - (d1 - i1)
        a2 = i2 - d2
        for j in range(i1, i2 + 1):
            k = max(j, 0)
            if k >= N:
                break
            a = 1.0
            if j == i1:
                a = a1
            if j == i2:
                a = a2
            M[k, s] += a
            Wn[k] += a
    return M / np.where(Wn > 1e-20, Wn, 1.0)[:, None]


def vtln_ff(power: jax.Array, ratio: float, edge: float = 1.0) -> jax.Array:
    """Version-2 VTLN applied over frames: ``power`` [..., T, N] ->
    [..., T, N] via :func:`vtln_ff_matrix`."""
    M = jnp.asarray(vtln_ff_matrix(power.shape[-1], ratio, edge), power.dtype)
    return jnp.matmul(power, M.T, precision=jax.lax.Precision.HIGHEST)


def alog_feature(x: jax.Array, m: float = 1.0, a: float = 4.0,
                 runon: bool = False) -> jax.Array:
    """'ALog' additive-offset log compression (ALogFeature, feature.cc:
    find_min_max_/next): ``out = m * log10(max / 10^a + x)`` with
    non-positive arguments mapped to ``log10(1) = 0``.  In offline mode the
    offset uses the whole-utterance max (the reference's two-pass
    find_min_max_); with ``runon=True`` it is the running max of all frames
    seen so far, as a cummax instead of a stateful loop.

    ``x``: [..., T, n] frames.
    """
    frame_max = jnp.max(x, axis=-1, keepdims=True)  # [..., T, 1]
    if runon:
        mx = jax.lax.cummax(frame_max, axis=frame_max.ndim - 2)
    else:
        mx = jnp.max(frame_max, axis=-2, keepdims=True)
    val = mx / (10.0**a) + x
    val = jnp.where(val <= 0.0, 1.0, val)
    return m * jnp.log10(val)


def norm_feature(x: jax.Array, minval: float = 0.0, maxval: float = 1.0) -> jax.Array:
    """Min/max normalization to [minval, maxval] per utterance
    (NormalizeFeature, feature.cc:1408-1455)."""
    lo = jnp.min(x, axis=tuple(range(x.ndim - 1)), keepdims=True)
    hi = jnp.max(x, axis=tuple(range(x.ndim - 1)), keepdims=True)
    return minval + (x - lo) * (maxval - minval) / jnp.maximum(hi - lo, 1e-20)


def threshold_feature(x: jax.Array, value: float = 0.0, thresh: float = 1.0,
                      mode: str = "upper") -> jax.Array:
    """Clamp values past a threshold (ThresholdFeature, feature.h:700-740):
    'upper' replaces x > thresh, 'lower' replaces x < thresh, 'both' clamps
    symmetrically at +-thresh."""
    if mode == "upper":
        return jnp.where(x > thresh, value, x)
    if mode == "lower":
        return jnp.where(x < thresh, value, x)
    if mode == "both":
        return jnp.where(jnp.abs(x) > thresh, jnp.sign(x) * value, x)
    raise ValueError(mode)
