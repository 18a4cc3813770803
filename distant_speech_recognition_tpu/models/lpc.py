"""Linear-prediction spectral envelope estimators.

Batched equivalents of feature/lpc.cc: Levinson-Durbin LPC on (optionally
frequency-warped) autocorrelations, the Burg method, the LPC power spectrum,
and the MVDR spectral envelope (Murthi & Rao) computed from the LP
coefficients — all vmappable over frames.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "autocorrelation",
    "warped_autocorrelation",
    "levinson_durbin",
    "burg",
    "lpc_spectrum",
    "mvdr_envelope",
    "lpc_cepstrum",
    "semnb_deviation_derivative",
]


def semnb_deviation_derivative(P: jax.Array, order: int, fftlen: int) -> jax.Array:
    """Derivative of the LP-envelope *deviation* sigma(m) = sqrt(S_p(m))
    w.r.t. the subband power component P_m at the same bin (the SEMNB
    estimator, feature/spectralestimator.cc:245-460).

    The reference derives the chain rule by hand through an eigendecomposition
    of the autocorrelation matrix (eqns. 8-28 of the SEMNB paper); here the
    identical map is expressed functionally and differentiated with
    ``jax.jacfwd`` — the batched formulation.  The map, matching the
    reference's conventions exactly (including the 2/fftLen factor applied
    to ALL bins, spectralestimator.cc:359-363, 396-405):

        r[k]    = (2/fftLen) sum_{m=0}^{fftLen/2} P[m] cos(2 pi k m / fftLen)
        a       = R^{-1} r         (R Toeplitz from r, lags 0..order-1)
        eps_p   = r[0] - a . r[1:]
        S_p(m)  = eps_p / (|A(m)|^2 + 1e-7),  A = FFT([-1, a, 0...])
        sigma   = sqrt(S_p)

    ``P``: [fftlen//2 + 1] half power spectrum.  Returns [fftlen//2 + 1]:
    d sigma(m) / d P_m (the diagonal of the Jacobian, as
    calcDerivativeOfDeviation returns).
    """
    F2 = fftlen // 2

    def _sigma(Ph):
        k = jnp.arange(order + 1)
        mm = jnp.arange(F2 + 1)
        ct = jnp.cos(2.0 * jnp.pi * jnp.outer(k, mm) / fftlen)  # [order+1, F2+1]
        ac = (2.0 / fftlen) * (ct @ Ph)  # lags 0..order
        idx = jnp.abs(jnp.arange(order)[:, None] - jnp.arange(order)[None, :])
        R = ac[idx]
        r = ac[1:]
        a = jnp.linalg.solve(R, r)
        eps = ac[0] - jnp.dot(a, r)
        A = jnp.fft.rfft(jnp.concatenate([jnp.array([-1.0], Ph.dtype), a]), n=fftlen)
        S = eps / (jnp.abs(A) ** 2 + 1e-7)
        return jnp.sqrt(jnp.maximum(S, 1e-20))

    J = jax.jacfwd(_sigma)(jnp.asarray(P))
    return jnp.diagonal(J)


def autocorrelation(x: jax.Array, order: int) -> jax.Array:
    """Biased autocorrelation r[0..order] of ``x`` [..., N]."""
    N = x.shape[-1]
    X = jnp.fft.rfft(x, n=2 * N, axis=-1)
    r = jnp.fft.irfft(jnp.abs(X) ** 2, n=2 * N, axis=-1)[..., : order + 1]
    return r / N


def warped_autocorrelation(x: jax.Array, order: int, warp: float) -> jax.Array:
    """Autocorrelation of the allpass-warped signal (WarpFeature::
    autoCorrelation, lpc.cc:65-140): the signal is passed through a chain of
    first-order allpass sections ``z^-1 -> (z^-1 - warp)/(1 - warp z^-1)``
    and correlated against the original at each warped lag."""
    N = x.shape[-1]

    def allpass_step(wx_prev, _):
        # one allpass stage applied along time: wx[j] = warp*(wx[j-1]-prev[j]) + prev[j-1]
        def scan_time(carry, inp):
            wx_jm1, prev_jm1 = carry
            prev_j = inp
            wx_j = warp * (wx_jm1 - prev_j) + prev_jm1
            return (wx_j, prev_j), wx_j

        first = -warp * wx_prev[..., 0]
        (_, _), rest = jax.lax.scan(
            scan_time,
            (first, wx_prev[..., 0]),
            jnp.moveaxis(wx_prev[..., 1:], -1, 0),
        )
        wx = jnp.concatenate([first[None], rest], axis=0)
        wx = jnp.moveaxis(wx, 0, -1)
        return wx, jnp.sum(x * wx, axis=-1)

    r0 = jnp.sum(x * x, axis=-1)
    wx, rs = jax.lax.scan(allpass_step, x, None, length=order)
    r = jnp.concatenate([r0[None], rs], axis=0)
    return jnp.moveaxis(r, 0, -1) / N


def levinson_durbin(r: jax.Array, order: int):
    """Levinson-Durbin recursion on autocorrelations ``r [..., order+1]``.

    Returns ``(a [..., order], E)`` with prediction ``x[n] ~ sum a_k x[n-k]``
    (sign convention: error filter is 1 - sum a_k z^-k, as lpc.cc uses).
    """
    a0 = jnp.zeros(r.shape[:-1] + (order,), r.dtype)
    E0 = r[..., 0]

    def step(carry, m):
        a, E = carry
        idx = jnp.arange(order)
        # acc = r[m+1] - sum_{k<m} a_k r[m-k]
        rm = jnp.take_along_axis(
            r, jnp.broadcast_to(m + 1, r.shape[:-1] + (1,)), axis=-1
        )[..., 0]
        rr = jnp.take_along_axis(
            r,
            jnp.broadcast_to(
                jnp.clip(m - idx, 0, r.shape[-1] - 1), r.shape[:-1] + (order,)
            ),
            axis=-1,
        )
        mask = idx < m
        acc = rm - jnp.sum(jnp.where(mask, a * rr, 0.0), axis=-1)
        k = acc / jnp.maximum(E, 1e-20)
        # a'_i = a_i - k a_{m-1-i} for i<m ; a'_m = k
        a_rev = jnp.take_along_axis(
            a,
            jnp.broadcast_to(
                jnp.clip(m - 1 - idx, 0, order - 1), a.shape[:-1] + (order,)
            ),
            axis=-1,
        )
        a_new = jnp.where(mask, a - k[..., None] * a_rev, a)
        a_new = jnp.where(idx == m, k[..., None], a_new)
        E_new = E * (1.0 - k * k)
        return (a_new, E_new), None

    (a, E), _ = jax.lax.scan(step, (a0, E0), jnp.arange(order))
    return a, E


def burg(x: jax.Array, order: int):
    """Burg's method (BurgFeature::autoCorrelation, lpc.cc:142-220).

    Returns ``(a [..., order], E)`` in the same sign convention as
    `levinson_durbin`.
    """
    N = x.shape[-1]
    ef0 = x
    eb0 = x
    a0 = jnp.zeros(x.shape[:-1] + (order,), x.dtype)
    E0 = jnp.sum(x * x, axis=-1) / N
    t = jnp.arange(N)

    def step(carry, m):
        a, E, ef, eb = carry
        # lagged errors: ef[n], eb[n-1] for n = m+1..N-1 (mask others)
        ebs = jnp.concatenate([jnp.zeros_like(eb[..., :1]), eb[..., :-1]], axis=-1)
        valid = t >= (m + 1)
        num = -2.0 * jnp.sum(jnp.where(valid, ef * ebs, 0.0), axis=-1)
        den = jnp.sum(jnp.where(valid, ef * ef + ebs * ebs, 0.0), axis=-1)
        k = -num / jnp.maximum(den, 1e-20)  # reflection coefficient
        ef_new = ef + (-k)[..., None] * ebs
        eb_new = ebs + (-k)[..., None] * ef
        idx = jnp.arange(order)
        a_rev = jnp.take_along_axis(
            a,
            jnp.broadcast_to(jnp.clip(m - 1 - idx, 0, order - 1), a.shape[:-1] + (order,)),
            axis=-1,
        )
        mask = idx < m
        a_new = jnp.where(mask, a - k[..., None] * a_rev, a)
        a_new = jnp.where(idx == m, k[..., None], a_new)
        E_new = E * (1.0 - k * k)
        return (a_new, E_new, ef_new, eb_new), None

    (a, E, _, _), _ = jax.lax.scan(step, (a0, E0, ef0, eb0), jnp.arange(order))
    return a, E


def lpc_spectrum(a: jax.Array, E: jax.Array, fftlen: int) -> jax.Array:
    """All-pole power spectrum ``E / |1 - sum a_k e^{-jwk}|^2``
    (LPCSpectrumEstimator, feature/spectralestimator.h:58-90).
    Returns [..., fftlen//2+1]."""
    order = a.shape[-1]
    coeffs = jnp.concatenate(
        [jnp.ones(a.shape[:-1] + (1,), a.dtype), -a], axis=-1
    )
    A = jnp.fft.rfft(coeffs, n=fftlen, axis=-1)
    return E[..., None] / jnp.maximum(jnp.abs(A) ** 2, 1e-20)


def mvdr_envelope(a: jax.Array, E: jax.Array, fftlen: int) -> jax.Array:
    """MVDR (minimum variance) spectral envelope from LP coefficients
    (MVDRFeature, lpc.h:73-97; Murthi & Rao correlation method):

        S(w) = E / sum_{k=-p}^{p} mu_k e^{-jwk}
        mu_k = sum_{i=0}^{p-k} (p + 1 - k - 2i) b_i b_{i+k},  b = [1, -a]
    """
    p = a.shape[-1]
    b = jnp.concatenate([jnp.ones(a.shape[:-1] + (1,), a.dtype), -a], axis=-1)

    def mu_k(k):
        i = jnp.arange(p + 1)
        valid = i <= p - k
        bi = b[..., : p + 1]
        bik = jnp.take_along_axis(
            b, jnp.broadcast_to(jnp.clip(i + k, 0, p), b.shape[:-1] + (p + 1,)), axis=-1
        )
        w = (p + 1 - k - 2 * i).astype(b.dtype)
        return jnp.sum(jnp.where(valid, w * bi * bik, 0.0), axis=-1)

    mus = jnp.stack([mu_k(k) for k in range(p + 1)], axis=-1)  # [..., p+1]
    # denominator spectrum: mu_0 + 2 sum_k>0 mu_k cos(wk)
    full = jnp.concatenate(
        [mus, jnp.zeros(mus.shape[:-1] + (fftlen - (p + 1),), mus.dtype)], axis=-1
    )
    D = jnp.fft.rfft(full, n=fftlen, axis=-1)
    den = 2.0 * jnp.real(D) - mus[..., :1]
    return E[..., None] / jnp.maximum(jnp.abs(den), 1e-20)


def lpc_cepstrum(a: jax.Array, E: jax.Array, ncep: int) -> jax.Array:
    """LP-derived cepstra via the standard recursion
    (CepstralSpectrumEstimator support, spectralestimator.h:91-147)."""
    p = a.shape[-1]

    def step(carry, n):
        c = carry  # [..., ncep]
        k = jnp.arange(1, ncep + 1)
        prev_c = c
        a_n = jnp.where(n <= p, jnp.take_along_axis(
            jnp.concatenate([a, jnp.zeros_like(a[..., :1])], axis=-1),
            jnp.broadcast_to(jnp.clip(n - 1, 0, p), a.shape[:-1] + (1,)), axis=-1)[..., 0], 0.0)
        i = jnp.arange(1, ncep + 1)
        ai = jnp.take_along_axis(
            jnp.concatenate([a, jnp.zeros(a.shape[:-1] + (ncep,), a.dtype)], axis=-1),
            jnp.broadcast_to(jnp.clip(i - 1, 0, p + ncep - 1), a.shape[:-1] + (ncep,)),
            axis=-1,
        )
        ai = jnp.where(i <= p, ai, 0.0)
        cmi = jnp.take_along_axis(
            prev_c,
            jnp.broadcast_to(jnp.clip(n - i - 1, 0, ncep - 1), prev_c.shape[:-1] + (ncep,)),
            axis=-1,
        )
        summ = jnp.sum(
            jnp.where((i < n), (1.0 - i / n) * ai * cmi, 0.0), axis=-1
        )
        cn = a_n + summ
        c = jnp.where(k == n, cn[..., None], c)
        return c, None

    c0 = jnp.zeros(a.shape[:-1] + (ncep,), a.dtype)
    c, _ = jax.lax.scan(step, c0, jnp.arange(1, ncep + 1))
    return c


def lpc_envelope_frames(frames: jax.Array, order: int, fftlen: int):
    """Per-frame LPC spectral envelopes (LPCSpectrumEstimator,
    feature/spectralestimator.h:58-112): autocorrelation -> Levinson-Durbin
    -> all-pole spectrum, batched over frames.  [..., T, N] -> [..., T, F]."""
    r = autocorrelation(frames, order)
    a, E = levinson_durbin(r, order)
    return lpc_spectrum(a, E, fftlen)


def cepstral_spectrum_estimator(spectra: jax.Array, order: int = 14,
                                log_padding: float = 1.0) -> jax.Array:
    """Smoothed spectral envelope via truncated cepstrum
    (CepstralSpectrumEstimator::next, spectralestimator.cc:210-242,
    verified against the compiled reference): cepstrum of
    ``log(pad + |X|^2)``, lifter keeping indices [0, order] and
    [M-order, M) (the reference zeroes [order+1, M-order)), forward
    transform, then ``exp(|.|)`` of the resulting log-spectrum.
    ``spectra``: [..., T, M] full complex spectra."""
    M = spectra.shape[-1]
    logmag = jnp.log(log_padding + jnp.abs(spectra) ** 2)
    cep = jnp.fft.ifft(logmag.astype(jnp.complex64), axis=-1)
    k = jnp.arange(M)
    lifter = (k <= order) | (k >= M - order)
    cep = jnp.where(lifter, cep, 0.0)
    return jnp.exp(jnp.abs(jnp.fft.fft(cep, axis=-1)))
