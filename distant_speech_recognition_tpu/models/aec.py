"""Acoustic echo cancellation in the subband domain.

Batched reformulation of the reference's AEC family (aec/aec.cc): NLMS,
scalar Kalman, block (multi-tap) Kalman, double-talk-detecting block Kalman,
and the information filter.  Every canceller is a `lax.scan` over frames
carrying per-bin state ``[F, ...]``; all bins update in parallel.

Conventions (per bin k, frame t):
  error     E = A - R . V        (unconjugated dot for tap vectors, zdotu)
  gating    update only when |V_0|^2 > threshold   (update_, aec.cc:34-39)
  mirror    bins 0..M/2 computed, rest conjugated by the caller

``V``/``A``: played-back and recorded (mic) subband signals ``[T, F]``
(half band).  Tap vectors stack the current + past played frames, newest
first (ComplexBuffer_, aec.h:117-191).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..ops.complex_ops import ceinsum

__all__ = [
    "nlms_aec",
    "kalman_aec",
    "block_kalman_aec",
    "dtd_block_kalman_aec",
    "information_filter_aec",
    "sqrt_information_filter_aec",
    "play_taps",
]


def play_taps(V: jax.Array, sampleN: int, amp4play: float = 1.0) -> jax.Array:
    """Stack the played signal into tap vectors, newest first:
    ``taps[t, ..., n] = amp * V[t - n, ...]`` (zero history).  Time is the
    LEADING axis (scan order), any trailing dims ride along."""
    T = V.shape[0]
    pad = [(sampleN - 1, 0)] + [(0, 0)] * (V.ndim - 1)
    Vp = jnp.pad(V, pad) * amp4play
    slices = [
        jax.lax.slice_in_dim(Vp, sampleN - 1 - n, sampleN - 1 - n + T, axis=0)
        for n in range(sampleN)
    ]
    return jnp.stack(slices, axis=-1)


def _aec_state_shape(V, A):
    """Broadcast per-frame state shape from ``V [T, *Sv]`` / ``A [T, *Sa]``.

    The scans are elementwise per bin, so they generalize to any broadcast-
    compatible leading dims — the time-major batched pipeline passes
    ``V [T, B, 1, F]`` against ``A [T, B, C, F]`` (one far-end reference
    cancelling every channel, like the reference's per-channel feature
    sharing one played stream)."""
    import numpy as _np

    return tuple(_np.broadcast_shapes(V.shape[1:], A.shape[1:]))


@partial(jax.jit, static_argnums=())
def nlms_aec(
    V: jax.Array,
    A: jax.Array,
    delta: float = 100.0,
    epsilon: float = 1.0e-4,
    threshold: float = 100.0,
):
    """NLMS echo canceller (NLMSAcousticEchoCancellationFeature,
    aec.cc:41-81)::

        E = A - R V
        R <- R - eps |V|^2/(delta + |A|^2) (R - A/V)   if |V|^2 > threshold

    ``V``/``A``: ``[T, *S]`` with broadcastable ``*S`` (classically
    ``[T, F]``).  Returns ``(E [T, *S], R_final [*S])``.
    """
    shape = _aec_state_shape(V, A)

    def step(R, inputs):
        Vk, Ak = inputs
        Ek = Ak - R * Vk
        gate = jnp.abs(Vk) ** 2 > threshold
        Gkhat = Ak / jnp.where(jnp.abs(Vk) > 0, Vk, 1.0)
        dC = R - Gkhat
        deltaC = dC * (epsilon * jnp.abs(Vk) ** 2 / (delta + jnp.abs(Ak) ** 2))
        R_new = jnp.where(gate, R - deltaC, R)
        return R_new, Ek

    R0 = jnp.zeros(shape, V.dtype)
    R, E = jax.lax.scan(step, R0, (V, A))
    return E, R


@partial(jax.jit, static_argnums=())
def kalman_aec(
    V: jax.Array,
    A: jax.Array,
    beta: float = 0.95,
    sigma2: float = 10.0e-4,
    threshold: float = 100.0,
):
    """Scalar Kalman echo canceller per bin
    (KalmanFilterEchoCancellationFeature, aec.cc:118-164).

    ``V``/``A``: ``[T, *S]`` broadcastable (see `_aec_state_shape`).
    Returns ``(E [T, *S], R_final [*S])``.
    """
    shape = _aec_state_shape(V, A)

    class S(NamedTuple):
        R: jax.Array
        sigma2_v: jax.Array
        K_k: jax.Array

    def step(s, inputs):
        Vk, Ak = inputs
        Ek = Ak - s.R * Vk
        gate = jnp.abs(Vk) ** 2 > threshold

        sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2
        K_k_k1 = s.K_k + sigma2
        sigma2_s = jnp.abs(Vk) ** 2 * K_k_k1 + sigma2_v
        Gk = jnp.conj(Vk) * (K_k_k1 / sigma2_s)
        R_new = s.R + Gk * Ek
        K_new = (1.0 - K_k_k1 * jnp.abs(Vk) ** 2 / sigma2_s) * K_k_k1

        s_new = S(
            R=jnp.where(gate, R_new, s.R),
            sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
            K_k=jnp.where(gate, K_new, s.K_k),
        )
        return s_new, Ek

    s0 = S(
        R=jnp.zeros(shape, V.dtype),
        sigma2_v=jnp.full(shape, sigma2, jnp.float32),
        K_k=jnp.full(shape, sigma2, jnp.float32),
    )
    s, E = jax.lax.scan(step, s0, (V, A))
    return E, s.R


@partial(jax.jit, static_argnums=(2,))
def block_kalman_aec(
    V: jax.Array,
    A: jax.Array,
    sampleN: int = 1,
    beta: float = 0.95,
    sigmau2: float = 10.0e-4,
    sigmak2: float = 5.0,
    threshold: float = 100.0,
    amp4play: float = 1.0,
):
    """Multi-tap Kalman echo canceller
    (BlockKalmanFilterEchoCancellationFeature, aec.cc:244-308)::

        E  = A - R . V          (zdotu: unconjugated)
        Kp = K + Sigma_u
        G  = Kp conj(V) / (V . Kp conj(V) + sigma_v)
        R += E G;   K = (I - G V^T) Kp

    ``V``/``A``: ``[T, *S]`` broadcastable (see `_aec_state_shape`).
    Returns ``(E [T, *S], R_final [*S, N])``.
    """
    N = sampleN
    shape = _aec_state_shape(V, A)
    taps = play_taps(V, N, amp4play)  # [T, *Sv, N]
    eye = jnp.eye(N, dtype=V.dtype)

    class S(NamedTuple):
        R: jax.Array  # [*S, N]
        sigma2_v: jax.Array  # [*S]
        K_k: jax.Array  # [*S, N, N]

    def step(s, inputs):
        Vk, Ak = inputs  # [*Sv, N], [*Sa]
        Ek = Ak - ceinsum("...n,...n->...", s.R, Vk)
        gate = jnp.broadcast_to(jnp.abs(Vk[..., 0]) ** 2 > threshold, Ek.shape)

        sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2
        K_k_k1 = s.K_k + sigmau2 * eye
        scr = ceinsum("...nm,...m->...n", K_k_k1, jnp.conj(Vk))
        sigma2_s = jnp.real(ceinsum("...n,...n->...", Vk, scr)) + sigma2_v
        Gk = scr / sigma2_s[..., None]
        R_new = s.R + Ek[..., None] * Gk
        IGV = eye - Gk[..., :, None] * Vk[..., None, :]
        K_new = ceinsum("...nm,...ml->...nl", IGV, K_k_k1)

        s_new = S(
            R=jnp.where(gate[..., None], R_new, s.R),
            sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
            K_k=jnp.where(gate[..., None, None], K_new, s.K_k),
        )
        return s_new, Ek

    s0 = S(
        R=jnp.zeros(shape + (N,), V.dtype),
        sigma2_v=jnp.full(shape, sigmau2, jnp.float32),
        K_k=jnp.broadcast_to(sigmak2 * jnp.eye(N, dtype=V.dtype), shape + (N, N)),
    )
    s, E = jax.lax.scan(step, s0, (taps, A))
    return E, s.R


def _dtd_scale_factors(A, E, frame_no, snr0, Ek0, Sk0, smooth, snr_th, eng_th):
    """Sequential-over-bins double-talk scale factors
    (DTDBlockKalmanFilterEchoCancellationFeature::update_band_,
    aec.cc:818-850).  The smoothed SNR state is a *scalar shared across
    bins*, updated bin by bin within the frame — replicated with a scan
    over bins.  Returns (sf [F], new scalar states)."""
    smth = jnp.where(frame_no < 100, 1.0 - frame_no * (1.0 - smooth) / 100.0, smooth)

    def bin_step(carry, inputs):
        snr, EkE, SkE = carry
        Ak, Ek = inputs
        Sk = Ak - Ek
        currEk = jnp.abs(Ek) ** 2
        currSk = jnp.abs(Sk) ** 2
        EkE = currEk * smth + EkE * (1.0 - smth)
        SkE = currSk * smth + SkE * (1.0 - smth)
        snr = (currSk / (currEk + 1e-15)) * smth + snr * (1.0 - smth)
        ok = (frame_no < 100) | ((snr > snr_th) & (SkE > eng_th))
        sf = jnp.where(ok, 2.0 / (1.0 + jnp.exp(-snr)) - 1.0, -1.0)
        return (snr, EkE, SkE), sf

    (snr, EkE, SkE), sf = jax.lax.scan(bin_step, (snr0, Ek0, Sk0), (A, E))
    return sf, snr, EkE, SkE


@partial(jax.jit, static_argnums=(2,))
def dtd_block_kalman_aec(
    V: jax.Array,
    A: jax.Array,
    sampleN: int = 1,
    beta: float = 0.95,
    sigmau2: float = 10.0e-4,
    sigmak2: float = 5.0,
    snr_th: float = 2.0,
    eng_th: float = 100.0,
    smooth: float = 0.9,
    amp4play: float = 1.0,
):
    """Block Kalman with double-talk detection
    (DTDBlockKalmanFilterEchoCancellationFeature, aec.cc:862-960): the
    prediction covariance is scaled by a smoothed-SNR sigmoid ``sf`` and the
    update is skipped entirely when double-talk is detected (sf < 0)."""
    F = V.shape[-1]
    N = sampleN
    taps = play_taps(V, N, amp4play)
    eye = jnp.eye(N, dtype=V.dtype)

    class S(NamedTuple):
        R: jax.Array
        sigma2_v: jax.Array
        K_k: jax.Array
        snr: jax.Array  # scalar
        EkE: jax.Array  # scalar
        SkE: jax.Array  # scalar
        frame: jax.Array  # scalar int

    def step(s, inputs):
        Vk, Ak = inputs
        Ek = Ak - ceinsum("fn,fn->f", s.R, Vk)
        sf, snr, EkE, SkE = _dtd_scale_factors(
            Ak, Ek, s.frame, s.snr, s.EkE, s.SkE, smooth, snr_th, eng_th
        )
        gate = sf >= 0.0

        sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2
        K_k_k1 = s.K_k * 1.0 + (sf[:, None, None] * sigmau2) * eye  # Sigma_u scaled by sf
        scr = ceinsum("fnm,fm->fn", K_k_k1, jnp.conj(Vk))
        sigma2_s = jnp.real(ceinsum("fn,fn->f", Vk, scr)) + sigma2_v
        Gk = scr / sigma2_s[:, None]
        R_new = s.R + Ek[:, None] * Gk
        IGV = eye - Gk[:, :, None] * Vk[:, None, :]
        K_new = ceinsum("fnm,fml->fnl", IGV, K_k_k1)

        s_new = S(
            R=jnp.where(gate[:, None], R_new, s.R),
            sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
            K_k=jnp.where(gate[:, None, None], K_new, s.K_k),
            snr=snr,
            EkE=EkE,
            SkE=SkE,
            frame=s.frame + 1,
        )
        return s_new, Ek

    s0 = S(
        R=jnp.zeros((F, N), V.dtype),
        sigma2_v=jnp.full((F,), sigmau2, jnp.float32),
        K_k=jnp.broadcast_to(sigmak2 * jnp.eye(N, dtype=V.dtype), (F, N, N)),
        snr=jnp.asarray(0.0, jnp.float32),
        EkE=jnp.asarray(0.0, jnp.float32),
        SkE=jnp.asarray(0.0, jnp.float32),
        frame=jnp.asarray(0, jnp.int32),
    )
    s, E = jax.lax.scan(step, s0, (taps, A))
    return E, s.R


@partial(jax.jit, static_argnums=(2,))
def information_filter_aec(
    V: jax.Array,
    A: jax.Array,
    sampleN: int = 1,
    beta: float = 0.95,
    sigmau2: float = 10.0e-4,
    sigmak2: float = 5.0,
    snr_th: float = 2.0,
    eng_th: float = 100.0,
    smooth: float = 0.9,
    loading: float = 1.0e-4,
    amp4play: float = 1.0,
    floor_val: float = 0.01,
):
    """Information-form echo canceller
    (InformationFilterEchoCancellationFeature, aec.cc:435-518): SNR-gated
    per-bin updates with per-bin smoothed statistics, eigendecomposition
    inverse, and extra diagonal loading on the information matrix.

    Reference quirks, verified against the compiled C++
    (tests/test_cpp_golden.py::test_aec_kalman_family_matches_cpp):

    - the base-class energy gate ``update_`` tests ``|V_0|^2 > snr_th``
      because the ctor forwards ``snrTh`` as the BlockKalman ``threshold``
      argument (aec.cc:322);
    - the ``||`` in ``update_(Vk) == false || update_band_(...) < 0``
      short-circuits, so the per-bin smoothed SNR statistics only advance
      on frames whose energy gate passes (aec.cc:464);
    - ``skippedN_`` is one counter SHARED across all bins, advanced in bin
      order within each frame; when a bin skips with the counter >= 30,
      that bin's filter resets to [1, 0, ...] and the counter restarts
      (aec.cc:464-472) — replicated with a scan over bins.
    """
    F = V.shape[-1]
    N = sampleN
    taps = play_taps(V, N, amp4play)
    eye = jnp.eye(N, dtype=V.dtype)
    R_init = jnp.zeros((F, N), V.dtype).at[:, 0].set(1.0)

    def _inv_h(M):
        w, v = jnp.linalg.eigh(M)
        inv_w = (1.0 / w).astype(v.dtype)
        return jnp.einsum("...ij,...j,...kj->...ik", v, inv_w, jnp.conj(v),
                          precision=jax.lax.Precision.HIGHEST)

    class S(NamedTuple):
        R: jax.Array
        sigma2_v: jax.Array
        K_k: jax.Array
        snr: jax.Array  # [F]
        EkE: jax.Array  # [F]
        SkE: jax.Array  # [F]
        skipped: jax.Array  # scalar int, shared across bins (aec.cc quirk)
        frame: jax.Array

    def step(s, inputs):
        Vk, Ak = inputs
        Ek = Ak - ceinsum("fn,fn->f", s.R, Vk)
        absEk = jnp.abs(Ek)
        # [sic] residuals below the floor are normalized to UNIT magnitude,
        # not to floor_val — the reference's literal code (aec.cc:455-457)
        Ek = jnp.where(absEk < floor_val, Ek / jnp.where(absEk > 0, absEk, 1.0), Ek)

        # energy gate first: update_ tests |V_0|^2 against snr_th (the ctor
        # forwards snrTh as the base-class threshold, aec.cc:322), and the
        # || short-circuit means the per-bin stats below only advance on
        # frames whose energy gate passes
        egate = jnp.abs(Vk[..., 0]) ** 2 > snr_th

        # per-bin SNR stats (update_band_, aec.cc:371-399)
        smth = jnp.where(s.frame < 100, 1.0 - s.frame * (1.0 - smooth) / 100.0, smooth)
        Sk = Ak - Ek
        currEk = jnp.abs(Ek) ** 2
        currSk = jnp.abs(Sk) ** 2
        EkE = jnp.where(egate, currEk * smth + s.EkE * (1.0 - smth), s.EkE)
        SkE = jnp.where(egate, currSk * smth + s.SkE * (1.0 - smth), s.SkE)
        snr = jnp.where(
            egate, (currSk / (currEk + 1e-15)) * smth + s.snr * (1.0 - smth), s.snr
        )
        sf_ok = (s.frame < 100) | ((snr > snr_th) & (SkE > eng_th))
        gate = egate & sf_ok

        # shared skip counter, advanced in bin order within the frame
        # (aec.cc:464-472): when a bin skips with the counter >= 30, that
        # bin's filter resets and the counter restarts at 1
        def skip_step(cnt, g):
            do_reset = (~g) & (cnt >= 30)
            cnt = jnp.where(g, cnt, jnp.where(do_reset, 1, cnt + 1))
            return cnt, do_reset

        skipped, reset = jax.lax.scan(skip_step, s.skipped, gate)
        R_base = jnp.where(reset[:, None], R_init, s.R)

        sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2
        K_k_k1 = s.K_k + sigmau2 * eye
        Y_pred = _inv_h(K_k_k1)  # information matrix
        y_pred = ceinsum("fnm,fm->fn", Y_pred, R_base)
        scale = (1.0 / sigma2_v)[:, None]
        i_k = jnp.conj(Vk) * scale * Ak[:, None]
        I_k = ceinsum("fn,fm->fnm", jnp.conj(Vk) * scale, Vk)
        Y_new = I_k + Y_pred + loading * eye
        K_new = _inv_h(Y_new)
        R_new = ceinsum("fnm,fm->fn", K_new, y_pred + i_k)

        s_new = S(
            R=jnp.where(gate[:, None], R_new, R_base),
            sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
            K_k=jnp.where(gate[:, None, None], K_new, s.K_k),
            snr=snr,
            EkE=EkE,
            SkE=SkE,
            skipped=skipped,
            frame=s.frame + 1,
        )
        return s_new, Ek

    s0 = S(
        R=R_init,
        sigma2_v=jnp.full((F,), sigmau2, jnp.float32),
        K_k=jnp.broadcast_to(sigmak2 * jnp.eye(N, dtype=V.dtype), (F, N, N)),
        snr=jnp.zeros((F,), jnp.float32),
        EkE=jnp.zeros((F,), jnp.float32),
        SkE=jnp.zeros((F,), jnp.float32),
        skipped=jnp.asarray(0, jnp.int32),
        frame=jnp.asarray(0, jnp.int32),
    )
    s, E = jax.lax.scan(step, s0, (taps, A))
    return E, s.R


@partial(jax.jit, static_argnums=(2,))
def sqrt_information_filter_aec(
    V: jax.Array,
    A: jax.Array,
    sampleN: int = 1,
    beta: float = 0.95,
    sigmau2: float = 10.0e-4,
    snr_th: float = 2.0,
    eng_th: float = 100.0,
    smooth: float = 0.9,
    loading: float = 1.0e-4,
    amp4play: float = 1.0,
    floor_val: float = 0.01,
):
    """Square-root information-filter echo canceller
    (SquareRootInformationFilterEchoCancellationFeature, aec.cc:615-790).

    The reference carries (S = K_k_, z = informationState_) and
    triangularizes pre-arrays with complex Givens sweeps; that pair is a
    standard SRIF on the conjugated system (S is the transpose of the
    positive-diagonal upper factor R, z = R conj(x)), so this carries
    (R, xbar = conj(x)) and realizes each sweep as one batched positive-
    diagonal QR per bin — verified identical to a literal transliteration
    of the Givens pipeline to 1e-16 over 60 frames.

    Reference quirks, verified against the compiled C++
    (tests/test_cpp_golden.py::test_aec_kalman_family_matches_cpp): unlike
    the parent information filter, SRIF::next (aec.cc:615-660) applies NO
    |E| floor and has NO skip counter/filter reset; the energy gate tests
    ``|V_0|^2 > snr_th`` (ctor forwards snrTh as the base threshold) and
    the ``||`` short-circuit keeps the per-bin SNR stats frozen on frames
    whose energy gate fails.
    """
    from ..ops.sqrt_kernels import propagate_information_sqrt

    F = V.shape[-1]
    N = sampleN
    taps = play_taps(V, N, amp4play)
    # coefficients start at [1, 0, ...] (InformationFilter ctor) while the
    # information state starts at zero — the reference uses the former for
    # the error until the first gated update extracts from the latter
    R_init = jnp.zeros((F, N), V.dtype).at[:, 0].set(1.0)
    # upper positive-diagonal info factor R (the reference's K_k_ = R^T)
    S_init = jnp.broadcast_to(
        (1.0 / jnp.sqrt(sigmau2)) * jnp.eye(N, dtype=V.dtype), (F, N, N)
    )

    class S(NamedTuple):
        R: jax.Array  # filter coefficients [F, N] (= conj(xbar) once adapted)
        xbar: jax.Array  # conjugated SRIF state [F, N] (z = R_factor @ xbar)
        Sinfo: jax.Array  # upper pos-diag info factor [F, N, N]
        sigma2_v: jax.Array
        snr: jax.Array
        EkE: jax.Array
        SkE: jax.Array
        frame: jax.Array

    def step(s, inputs):
        Vk, Ak = inputs
        # no |E| floor here: SRIF::next emits the raw residual (aec.cc:636)
        Ek = Ak - ceinsum("fn,fn->f", s.R, Vk)

        egate = jnp.abs(Vk[..., 0]) ** 2 > snr_th
        smth = jnp.where(s.frame < 100, 1.0 - s.frame * (1.0 - smooth) / 100.0, smooth)
        Sk = Ak - Ek
        currEk = jnp.abs(Ek) ** 2
        currSk = jnp.abs(Sk) ** 2
        EkE = jnp.where(egate, currEk * smth + s.EkE * (1.0 - smth), s.EkE)
        SkE = jnp.where(egate, currSk * smth + s.SkE * (1.0 - smth), s.SkE)
        snr = jnp.where(
            egate, (currSk / (currEk + 1e-15)) * smth + s.snr * (1.0 - smth), s.snr
        )
        sf_ok = (s.frame < 100) | ((snr > snr_th) & (SkE > eng_th))
        gate = egate & sf_ok
        R_base = s.R

        sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2

        # The reference's (S = K_k_, z = informationState_) pair is an SRIF
        # on the CONJUGATED system: S is the transpose of the positive-
        # diagonal upper factor R (Y_conj = R^H R) and z = R @ conj(x), so
        # carrying (R, xbar=conj(x)) is exactly equivalent — verified to
        # 1e-16 against a literal Givens transliteration of
        # temporal_update_/observational_update_/diagonal_loading_/
        # extract_covariance_state_ (aec.cc:660-790) over 60 frames.
        #
        # Temporal (aec.cc:662-717): R_pred = pos-factor of
        # inv(inv(Y_prev) + sigmau2 I); the rotated z equals
        # R_pred @ xbar_prev (random-walk state transition).
        eyeN = jnp.eye(N, dtype=V.dtype)
        Y_prev = ceinsum("fin,fim->fnm", jnp.conj(s.Sinfo), s.Sinfo)
        K_prev = jnp.linalg.inv(Y_prev)
        Y_pred = jnp.linalg.inv(K_prev + sigmau2 * eyeN)
        # Cholesky's upper factor already has the real-positive diagonal
        # the reference's Givens sweeps produce
        R_pred = jnp.swapaxes(jnp.conj(jnp.linalg.cholesky(Y_pred)), -1, -2)

        # Observational (aec.cc:719-760): QR of [R_pred; conj(V)^T/sqrt(s)]
        # with augmented column [R_pred xbar; conj(A)/sqrt(s)]; the rotated
        # column equals R_obs @ xbar_obs for the LS solution xbar_obs.
        rinv = (1.0 / jnp.sqrt(sigma2_v))[:, None]
        Y_obs = Y_pred + ceinsum("fn,fm->fnm", Vk * rinv, jnp.conj(Vk) * rinv)
        rhs = ceinsum("fnm,fm->fn", Y_pred, s.xbar) + Vk * jnp.conj(Ak)[:, None] * rinv**2
        xbar_obs = jnp.linalg.solve(Y_obs, rhs[..., None])[..., 0]
        R_obs = propagate_information_sqrt(
            R_pred, jnp.conj(Vk)[:, None, :] * rinv[..., None], jnp.ones((F, 1))
        )

        # Loading (aec.cc:762-790) rotates sqrt(loading) rows into the
        # factor WITHOUT touching z — so the extracted coefficients are
        # xbar_new = R_load^{-1} R_obs xbar_obs, the reference's literal
        # (slightly inconsistent) state.
        R_load = propagate_information_sqrt(
            R_obs,
            jnp.broadcast_to(jnp.sqrt(loading) * jnp.eye(N, dtype=V.dtype), (F, N, N)),
            jnp.ones((F, N)),
        )
        z_obs = ceinsum("fnm,fm->fn", R_obs, xbar_obs)
        xbar_new = jax.scipy.linalg.solve_triangular(R_load, z_obs[..., None])[..., 0]
        R_new = jnp.conj(xbar_new)

        s_new = S(
            R=jnp.where(gate[:, None], R_new, R_base),
            xbar=jnp.where(gate[:, None], xbar_new, s.xbar),
            Sinfo=jnp.where(gate[:, None, None], R_load, s.Sinfo),
            sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
            snr=snr,
            EkE=EkE,
            SkE=SkE,
            frame=s.frame + 1,
        )
        return s_new, Ek

    s0 = S(
        R=R_init,
        xbar=jnp.zeros((F, N), V.dtype),
        Sinfo=S_init,
        sigma2_v=jnp.full((F,), sigmau2, jnp.float32),
        snr=jnp.zeros((F,), jnp.float32),
        EkE=jnp.zeros((F,), jnp.float32),
        SkE=jnp.zeros((F,), jnp.float32),
        frame=jnp.asarray(0, jnp.int32),
    )
    s, E = jax.lax.scan(step, s0, (taps, A))
    return E, s.R
