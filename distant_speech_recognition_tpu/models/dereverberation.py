"""Subband WPE (weighted prediction error) dereverberation.

Batched reformulation of the reference's single/multi-channel WPE
(dereverberation/dereverberation.cc).  The reference runs, per EM iteration,
a per-subband loop of {variance re-estimation, lag-covariance accumulation,
Cholesky solve} (estimate_Gn_, dereverberation.cc:186-205); here each step is
one einsum/solve batched over all F bins (and all target channels), and the
streaming apply is a dense masked convolution over the lag window.

Conventions (single channel, per bin):
  lags     l_t[p]   = y[t - lowerN - p],  p = 0..P-1,  P = upperN - lowerN + 1
  variance theta_t  = max(|y_t - g^H l_t|, 1e-3)^2     (calc_Thetan_, :146-170)
  normal eq.  R     = sum_{t>=lowerN} l_t l_t^H / theta_t   (calc_Rr_, :96-142)
              r     = sum_{t>=lowerN} conj(y_t) l_t / theta_t
  loading   diag(R) += max(diag(R)) * 10^(load_db/10)       (load_R_, :172-184)
  filter    g       = R^{-1} r   (complex Cholesky solve, :196-197)
  output    out_t   = y_t - (t >= lowerN) * g^H l_t          (next, :227-275)

Multi-channel (MultiChannelWPEDereverberation, :312-733): the lag vector
stacks all channels (``totalPredictionN = C*P``), each target channel gets
its own variance track and filter, and a ``diagonal_bias`` is added to R.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.scipy.linalg
from ..ops.complex_ops import ceinsum

SUBBAND_FLOOR = 1.0e-3  # dereverberation.cc:144

__all__ = [
    "wpe_estimate",
    "wpe_apply",
    "wpe",
    "wpe_multichannel",
    "band_limit_mask",
]


def _hpd_solve(R: jax.Array, r: jax.Array) -> jax.Array:
    """Batched Hermitian positive-definite solve ``R x = r`` by Cholesky
    (the reference's complex Cholesky solve, dereverberation.cc:196-197).
    ``R``: [..., n, n], ``r``: [..., n] -> [..., n]."""
    L = jnp.linalg.cholesky(R)
    return jax.scipy.linalg.cho_solve((L, True), r[..., None])[..., 0]


def band_limit_mask(F: int, band_width: float, samplerate: float):
    """Active-bin mask for the WPE ``bandWidth`` option, or ``None`` for all.

    The reference estimates/applies filters only for bins
    ``<= lower_bandWidthN_`` or ``>= upper_bandWidthN_`` with
    ``lower = (bw / (fs/2)) * (M/2)``, ``upper = M - lower``
    (set_band_width_, dereverberation.cc:278-285; gates at :192 and :262);
    other bins pass through.  ``F = M//2 + 1`` half-band bins.
    """
    if band_width <= 0.0:
        return None
    if band_width > samplerate / 2.0:
        raise ValueError("bandWidth is greater than the Nyquist rate")
    M2 = F - 1
    lower = int((band_width / (samplerate / 2.0)) * M2)
    upper = 2 * M2 - lower
    bins = jnp.arange(F)
    return (bins <= lower) | (bins >= upper)


def _lag_tensor(Y: jax.Array, lowerN: int, P: int) -> jax.Array:
    """Stacked lag windows: ``L[..., t, f, p] = Y[..., t - lowerN - p, f]``
    (zero history), built from P static shifted slices.

    ``Y``: [..., T, F] -> [..., T, F, P].
    """
    T = Y.shape[-2]
    lead = Y.ndim - 2
    pad = [(0, 0)] * lead + [(lowerN + P - 1, 0), (0, 0)]
    Yp = jnp.pad(Y, pad)
    slices = [
        jax.lax.slice_in_dim(Yp, P - 1 - p, P - 1 - p + T, axis=lead)
        for p in range(P)
    ]
    return jnp.stack(slices, axis=-1)


@partial(jax.jit, static_argnums=(1, 2, 3))
def wpe_estimate(
    Y: jax.Array,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = -20.0,
    diagonal_bias: float = 0.0,
):
    """Estimate WPE prediction filters from a buffered utterance.

    ``Y``: subband frames ``[C, T, F]`` (C=1 for single channel; F bins are
    typically M//2+1).  Returns ``G [C, F, C*P]`` — per target channel and
    bin, the conjugate-applied prediction filter over the stacked channel
    lags, exactly as ``estimate_filter`` computes (dereverberation.cc:214-225
    single / 414-433 multi).
    """
    C, T, F = Y.shape
    P = upperN - lowerN + 1
    load = 10.0 ** (load_db / 10.0)

    # Stacked lag tensor over channels: [T, F, C*P].
    L = _lag_tensor(Y, lowerN, P)  # [C, T, F, P]
    L = jnp.moveaxis(L, 0, -2).reshape(T, F, C * P)
    valid = (jnp.arange(T) >= lowerN)[:, None]  # [T, 1]

    eye = jnp.eye(C * P, dtype=Y.dtype)

    def em_iteration(G, _):
        # G: [C, F, C*P]
        pred = ceinsum("cfp,tfp->ctf", jnp.conj(G), L)
        resid = Y - jnp.where(valid, pred, 0.0)
        theta = jnp.maximum(jnp.abs(resid), SUBBAND_FLOOR) ** 2  # [C, T, F]
        w = jnp.where(valid, 1.0 / theta, 0.0)  # masked inverse variance
        Lw = w[..., None].astype(L.dtype) * L[None]
        R = ceinsum("ctfp,tfq->cfpq", Lw, jnp.conj(L))
        r = ceinsum("ctf,tfp->cfp", (w.astype(Y.dtype) * jnp.conj(Y)), L)
        R = R + diagonal_bias * eye
        # max-diagonal loading (load_R_)
        diag = jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))
        max_diag = jnp.max(diag, axis=-1, keepdims=True)
        new_diag = diag + max_diag * load
        R = R * (1.0 - eye) + jnp.einsum(
            "cfp,pq->cfpq", new_diag.astype(R.dtype), eye
        )
        # Hermitian solve per (channel, bin)
        G_new = _hpd_solve(R, r)
        return G_new, None

    G0 = jnp.zeros((C, F, C * P), Y.dtype)
    G, _ = jax.lax.scan(em_iteration, G0, None, length=iterations)
    return G


@partial(jax.jit, static_argnums=(2,))
def wpe_apply(Y: jax.Array, G: jax.Array, lowerN: int) -> jax.Array:
    """Apply estimated filters: ``out_ct = y_ct - g_c^H l_t`` for
    ``t >= lowerN`` (streaming apply of dereverberation.cc:227-275 /
    calc_every_channel_output :445-501).

    Reference quirk, reproduced exactly (verified against the compiled C++,
    tests/test_cpp_golden.py): the streaming apply keeps only ``P``
    (``predictionN_``) frames of history but indexes lags at
    ``yn_[size-1-lowerN-lagX]`` (dereverberation.cc:251-265), so once the
    ring buffer is full the deepest ``lowerN`` taps read zeros — the
    effective apply filter drops taps ``p >= P - lowerN`` (for every frame:
    before the buffer fills, those taps hit the zero history anyway).
    Estimation (`wpe_estimate`) buffers the whole utterance and uses the
    full window, like ``calc_Rr_``.

    ``Y``: [C, T, F]; ``G``: [C, F, C*P].  Returns [C, T, F].
    """
    C, T, F = Y.shape
    P = G.shape[-1] // C
    if lowerN > 0:
        tap_ok = (jnp.arange(P) < P - lowerN)
        G = G * jnp.tile(tap_ok, C).astype(G.dtype)
    L = _lag_tensor(Y, lowerN, P)  # [C, T, F, P]
    L = jnp.moveaxis(L, 0, -2).reshape(T, F, C * P)
    pred = ceinsum("cfp,tfp->ctf", jnp.conj(G), L)
    valid = (jnp.arange(T) >= lowerN)[:, None]
    return Y - jnp.where(valid, pred, 0.0)


def _mask_G(G, F, band_width, samplerate):
    """Zero filters for band-limited-out bins: identical to the reference's
    skip (filters for skipped bins stay 0, so apply passes through)."""
    mask = band_limit_mask(F, band_width, samplerate)
    if mask is None:
        return G
    return G * mask[:, None].astype(G.dtype)


def wpe(
    Y: jax.Array,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = -20.0,
    band_width: float = 0.0,
    samplerate: float = 16000.0,
) -> jax.Array:
    """Single-channel WPE end to end: estimate on the utterance, then apply.

    ``Y``: [T, F] (or [C, T, F] treating each channel independently).
    ``band_width`` > 0 restricts estimation/apply to the reference's
    band-limit bins (`band_limit_mask`); other bins pass through.
    """
    single = Y.ndim == 2
    Yc = Y[None] if single else Y
    F = Y.shape[-1]

    def one(y):
        G = wpe_estimate(y, lowerN, upperN, iterations, load_db)
        return wpe_apply(y, _mask_G(G, F, band_width, samplerate), lowerN)

    if single or Y.shape[0] == 1:
        out = one(Yc)
    else:
        # independent per-channel single-channel WPE
        out = jax.vmap(lambda y: one(y[None])[0])(Yc)
    return out[0] if single else out


def wpe_multichannel(
    Y: jax.Array,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = -20.0,
    diagonal_bias: float = 0.0,
    band_width: float = 0.0,
    samplerate: float = 16000.0,
) -> jax.Array:
    """Joint multi-channel WPE: all channels' lags predict every channel
    (MultiChannelWPEDereverberation).  ``Y``: [C, T, F] -> [C, T, F].
    ``band_width`` > 0 applies the reference's band limit (`band_limit_mask`)."""
    G = wpe_estimate(Y, lowerN, upperN, iterations, load_db, diagonal_bias)
    return wpe_apply(Y, _mask_G(G, Y.shape[-1], band_width, samplerate), lowerN)
