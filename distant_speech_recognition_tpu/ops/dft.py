"""DFT-as-matmul kernels for the subband transforms.

For the toolkit's subband sizes (M <= 1024; the reference workload is M=256,
unit_test/test_online_beamforming.py:260-262) a frame's length-M DFT is one
row of a dense [T, M] x [M, 2F] matmul, which XLA hands to the BLAS library
of the backend (cuBLAS on a GPU), at full float32 accuracy
(precision=HIGHEST, rel err ~3e-7 vs jnp.fft).  Whether the matmul or
cuFFT is faster on the H100 is not measured yet.

The matrices also *fold in* the filterbank's modulation conventions for free:

- analysis (`OverSampledDFTAnalysisBank::next` applies an unnormalized
  backward DFT to the time-REVERSED polyphase FIR output,
  modulated.cc:384-397).  Reversing the lane (last) dimension costs a
  copy; instead the FIR runs on the unreversed stream ``w`` and the
  reversal becomes a per-bin twiddle absorbed into the DFT matrix:
  ``M*ifft(w[::-1])[f] = e^{-2 pi i f/M} * fft(w)[f]``.
- synthesis (`OverSampledDFTSynthesisBank` takes ``Re(fft(Y))`` of the
  conjugate-mirrored spectrum, modulated.cc:556-563): with only bins
  0..M/2 kept, that is one real [T, 2F] x [2F, M] matmul.

All matrices are built once in numpy (cached) and embedded as jit constants.
Above ``MATMUL_MAX_M`` the callers fall back to jnp.fft.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "MATMUL_MAX_M",
    "analysis_dft",
    "analysis_dft_half",
    "synthesis_dft",
    "synthesis_dft_half",
]

# Largest M for which the O(M^2) matmul is used instead of jnp.fft;
# DSR_DFT_MATMUL=0 forces the fft path everywhere (e.g. for very long
# prototypes on CPU).
MATMUL_MAX_M = 0 if os.environ.get("DSR_DFT_MATMUL", "1") == "0" else 2048

# DFT-matmul precision.  HIGHEST = full f32 (~3e-7 rel err); on a GPU an
# f32 matmul at DEFAULT may run in TF32 (about three decimal digits).
# Override with DSR_DFT_PRECISION={default,high,highest}.
_PREC = {
    "default": lax.Precision.DEFAULT,
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,
}[os.environ.get("DSR_DFT_PRECISION", "highest").lower()]


@lru_cache(maxsize=None)
def _analysis_matrix(M: int, half: bool) -> np.ndarray:
    """[M, 2F] real matrix computing ``e^{-2 pi i f/M} * fft(w)[f]`` (the
    reversed-input backward DFT of the analysis bank) as [Re | Im] columns."""
    F = M // 2 + 1 if half else M
    n = np.arange(M)[:, None]
    f = np.arange(F)[None, :]
    ang = 2.0 * np.pi * f * (n + 1) / M  # (n+1): folded e^{-2 pi i f/M} twiddle
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@lru_cache(maxsize=None)
def _synthesis_half_matrix(M: int) -> np.ndarray:
    """[2F, M] real matrix computing ``M * irfft(conj(Y), n=M)`` — i.e.
    ``Re(fft(mirror(Y)))`` (modulated.cc:556-563) from [Re(Y) | Im(Y)] rows."""
    F = M // 2 + 1
    f = np.arange(F)[:, None]
    n = np.arange(M)[None, :]
    ang = 2.0 * np.pi * f * n / M
    wf = np.full((F, 1), 2.0)
    wf[0] = 1.0
    if M % 2 == 0:
        wf[M // 2] = 1.0
    top = wf * np.cos(ang)   # Re(Y[f]) rows
    bot = wf * np.sin(ang)   # Im(Y[f]) rows (conj folded in)
    return np.concatenate([top, bot], axis=0).astype(np.float32)


@lru_cache(maxsize=None)
def _synthesis_full_matrix(M: int) -> np.ndarray:
    """[2M, M] real matrix computing ``Re(fft(Y))`` for arbitrary complex Y."""
    f = np.arange(M)[:, None]
    n = np.arange(M)[None, :]
    ang = 2.0 * np.pi * f * n / M
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=0).astype(np.float32)


def _split_complex(Y: jax.Array) -> jax.Array:
    return jnp.concatenate([jnp.real(Y), jnp.imag(Y)], axis=-1)


def analysis_dft(w: jax.Array, M: int) -> jax.Array:
    """Backward unnormalized DFT of the time-reversed FIR stream, all M bins:
    ``M * ifft(w[..., ::-1])`` without materializing the reversal."""
    if M <= MATMUL_MAX_M:
        A = jnp.asarray(_analysis_matrix(M, half=False))
        Y = jnp.matmul(w, A, precision=_PREC)
        return lax.complex(Y[..., :M], Y[..., M:])
    tw = np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)
    return jnp.asarray(tw) * jnp.fft.fft(w, axis=-1)


def analysis_dft_half(w: jax.Array, M: int) -> jax.Array:
    """Bins 0..M/2 of :func:`analysis_dft` (the hermitian half the
    beamformers read, beamformer.cc:1142-1152)."""
    F = M // 2 + 1
    if M <= MATMUL_MAX_M:
        A = jnp.asarray(_analysis_matrix(M, half=True))
        Y = jnp.matmul(w, A, precision=_PREC)
        return lax.complex(Y[..., :F], Y[..., F:])
    tw = np.exp(-2j * np.pi * np.arange(F) / M).astype(np.complex64)
    return jnp.asarray(tw) * jnp.fft.rfft(w, axis=-1)


@lru_cache(maxsize=None)
def _analysis_matrix_packed(M: int) -> np.ndarray:
    """[M, M] real matrix: `_analysis_matrix(half=True)` with the two
    identically-zero imaginary columns removed.

    ``Im`` of bins 0 and M/2 are structurally zero (``-sin(2 pi f (n+1)/M)``
    vanishes for f=0 and f=M/2), so the half-band spectrum packs losslessly
    into exactly M lanes ``[Re(0..M/2) | Im(1..M/2-1)]`` — a square matmul
    with no ragged 2F=M+2 lane padding."""
    F = M // 2 + 1
    A = _analysis_matrix(M, half=True)  # [M, 2F]
    return np.ascontiguousarray(np.delete(A, [F, F + M // 2], axis=1))


@lru_cache(maxsize=None)
def _synthesis_half_matrix_packed(M: int) -> np.ndarray:
    """[M, M] real matrix: `_synthesis_half_matrix` with the two
    identically-zero imaginary rows (Im of DC and Nyquist — the parts
    ``Re(fft(mirror(Y)))`` discards) removed, matching the packed
    ``[Re(0..M/2) | Im(1..M/2-1)]`` lane layout."""
    F = M // 2 + 1
    S = _synthesis_half_matrix(M)  # [2F, M]
    return np.ascontiguousarray(np.delete(S, [F, F + M // 2], axis=0))


def synthesis_dft_half_packed(Yp: jax.Array, M: int, perm=None) -> jax.Array:
    """`synthesis_dft_half` consuming the packed real ``[..., M]`` spectrum
    (``[Re(0..M/2) | Im(1..M/2-1)]``) directly — no complex split/concat."""
    S = _synthesis_half_matrix_packed(M)
    if perm is not None:
        S = S[:, list(perm)]
    return jnp.matmul(Yp, jnp.asarray(S), precision=_PREC)


@lru_cache(maxsize=None)
def segment_reversal_perm(M: int, R: int) -> tuple:
    """Column permutation folding the synthesis overlap-add's per-segment
    sample reversal (``seg[..., ::-1]``, modulated.cc:603-606) into the DFT
    matrix: index ``j*D + i -> j*D + (D-1-i)``.  A lane reversal costs a
    copy; permuting the (build-time numpy) matrix columns makes it free."""
    D = M // R
    perm = np.arange(M).reshape(R, D)[:, ::-1].reshape(-1)
    return tuple(perm.tolist())


def synthesis_dft_half(Y_half: jax.Array, M: int, perm=None) -> jax.Array:
    """``M * irfft(conj(Y_half), n=M)`` — the real synthesis pre-image c
    (modulated.cc:556-563) from the half band.  ``perm`` (matmul regime
    only): optional column permutation baked into the matrix — see
    `segment_reversal_perm`."""
    if M <= MATMUL_MAX_M:
        S = _synthesis_half_matrix(M)
        if perm is not None:
            S = S[:, list(perm)]
        return jnp.matmul(_split_complex(Y_half), jnp.asarray(S), precision=_PREC)
    if perm is not None:
        raise ValueError("perm requires the DFT-matmul regime")
    return jnp.fft.irfft(jnp.conj(Y_half), n=M, axis=-1) * M


def synthesis_dft(Y: jax.Array, M: int, perm=None) -> jax.Array:
    """``Re(fft(Y))`` for full-band complex frames (modulated.cc:556-563)."""
    if M <= MATMUL_MAX_M:
        S = _synthesis_full_matrix(M)
        if perm is not None:
            S = S[:, list(perm)]
        return jnp.matmul(_split_complex(Y), jnp.asarray(S), precision=_PREC)
    if perm is not None:
        raise ValueError("perm requires the DFT-matmul regime")
    return jnp.real(jnp.fft.fft(Y, axis=-1))
