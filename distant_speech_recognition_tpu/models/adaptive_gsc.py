"""Adaptive GSC beamformers (LMS / RLS active-weight adaptation).

The reference adapts the active weight vector ``wa`` per frame per bin inside
a Python loop (SubbandGSCLMSBeamformer.__iter__ pybeamformer.py:659-762,
SubbandGSCRLSBeamformer.__iter__ pybeamformer.py:816-898).  Here each frame
update is one `lax.scan` step carrying pytrees shaped ``[F, ...]`` — all
frequency bins update in parallel; time is the only sequential
axis.  Throughput comes from F x batch parallelism, matching the reference's
math decision for decision (silence gating, regularization leak, quadratic
constraints, norm capping, min-frame warmup, LMS step-size slowdown).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..ops.complex_ops import ceinsum

from .beamforming import array_manifold, blocking_matrix, frame_energy_half

__all__ = [
    "GSCLMSConfig",
    "GSCRLSConfig",
    "gsc_weights",
    "gsc_lms",
    "gsc_rls",
]

# Unrolling the frame scan amortizes the XLA while-loop trip overhead — the
# per-step tensors ([B, F, C]-sized) are far too small to keep the device
# busy, so the loop is launch-bound.  Semantics are unchanged (pure codegen
# knob); the unroll factor is not tuned on the H100 yet.
SCAN_UNROLL = max(1, int(os.environ.get("DSR_SCAN_UNROLL", "3")))


def gsc_weights(fftlen: int, samplerate: float, delays, Nc: int = 1):
    """Quiescent weights + blocking matrix for a GSC
    (calc_beamformer_weights, pybeamformer.py:739-746 / 882-889).

    Returns ``(wqH [F, C], BmH [F, C-Nc, C])`` with ``BmH = B^T`` (transpose,
    not conjugate — the reference's convention).
    """
    vs = array_manifold(fftlen, samplerate, delays)
    B = blocking_matrix(vs, Nc)
    return jnp.conj(vs), jnp.swapaxes(B, -1, -2)


@dataclasses.dataclass(frozen=True)
class GSCLMSConfig:
    """Defaults per SubbandGSCLMSBeamformer.__init__ (pybeamformer.py:595-607)."""

    beta: float = 0.97
    gamma: float = 0.01
    init_diagonal_load: float = 1.0e6
    regularization_param: float = 1.0e-4
    energy_floor: float = 90.0
    sil_thresh: float = 1.0e8
    max_wa_l2norm: float = 100.0
    min_frames: int = 128
    slowdown_after: int = 4096


@dataclasses.dataclass(frozen=True)
class GSCRLSConfig:
    """Defaults per SubbandGSCRLSBeamformer.__init__ (pybeamformer.py:770-783)."""

    beta: float = 0.97
    gamma: float = 0.04
    mu: float = 0.97
    init_diagonal_load: float = 1.0e6
    regularization_param: float = 1.0e-2
    sil_thresh: float = 1.0e8
    constraint_option: int = 3  # 0: none, 1: quadratic, 2: norm cap, 3: both
    alpha2: float = 10.0
    max_wa_l2norm: float = 100.0
    min_frames: int = 128
    slowdown_after: int = 4096


class _LMSState(NamedTuple):
    waH: jax.Array  # [F, B] conjugate active weights
    subband_energy: jax.Array  # [F]
    energy: jax.Array  # scalar running average power
    gamma: jax.Array  # scalar step size (halved every slowdown_after)
    isamp: jax.Array  # scalar frame counter


class _RLSState(NamedTuple):
    """RLS carry.  ``Pz`` (the [B, B] per-bin precision matrix,
    pybeamformer.py:838-845) is Hermitian throughout — Pz0 = I/delta, every
    update is a Hermitian rank-1 correction, and the constraint reset is
    I/delta — so only the real diagonal and the upper triangle are carried:
    half the scan-state HBM traffic of the full matrix, identical values.
    Triangle order: ``(i, j)`` for i<j, row-major (`_pz_pairs`)."""

    waH: jax.Array  # [F, B]
    pz_diag: jax.Array  # [F, B] real diagonal of Pz
    pz_off: jax.Array  # [F, B*(B-1)//2] upper triangle of Pz
    energy: jax.Array  # scalar
    isamp: jax.Array  # scalar


def _pz_pairs(B: int):
    return [(i, j) for i in range(B) for j in range(B) if i < j]


def rls_init_state(batch: tuple, F: int, B: int, init_diagonal_load: float,
                   cdtype=jnp.complex64) -> _RLSState:
    """Fresh RLS state: wa = 0, Pz = I / delta (pybeamformer.py:795-807)."""
    return _RLSState(
        waH=jnp.zeros(batch + (F, B), cdtype),
        pz_diag=jnp.full(batch + (F, B), 1.0 / init_diagonal_load, jnp.float32),
        pz_off=jnp.zeros(batch + (F, B * (B - 1) // 2), cdtype),
        energy=jnp.full(batch, init_diagonal_load, jnp.float32),
        isamp=jnp.asarray(0, jnp.int32),
    )


@partial(jax.jit, static_argnums=(4,))
def gsc_lms(
    X: jax.Array,
    energy: jax.Array,
    wqH: jax.Array,
    BmH: jax.Array,
    config: GSCLMSConfig = GSCLMSConfig(),
    init_state: _LMSState | None = None,
):
    """Leaky power-normalized LMS GSC over an utterance.

    ``X``: snapshots ``[T, F, C]`` (optional batch dims between T and F:
    ``[T, ..., F, C]``); ``energy``: ``[T, ...]`` reference-channel frame
    energies (`frame_energy`); ``wqH [F, C]``, ``BmH [F, B, C]`` from
    `gsc_weights`.  Returns ``(Y [T, ..., F], final_state)``.
    Replicates pybeamformer.py:659-762 exactly.
    """
    c = config
    F, B = BmH.shape[0], BmH.shape[1]
    batch = X.shape[1:-2]  # () in the per-utterance path
    if init_state is None:
        init_state = _LMSState(
            waH=jnp.zeros(batch + (F, B), X.dtype),
            subband_energy=jnp.full(batch + (F,), c.init_diagonal_load, jnp.float32),
            energy=jnp.full(batch, c.init_diagonal_load, jnp.float32),
            gamma=jnp.asarray(c.gamma, jnp.float32),
            isamp=jnp.asarray(0, jnp.int32),
        )

    final, Y = jax.lax.scan(_lms_step_factory(c, wqH, BmH), init_state, (X, energy.astype(jnp.float32)), unroll=SCAN_UNROLL)
    return Y, final


def _lms_step_factory(c: GSCLMSConfig, wqH, BmH):
    # Shape-generic over leading batch dims: ``Xt [..., F, C]``,
    # ``energy_t [...]`` (scalar in the per-utterance path, ``[B]`` in the
    # time-major batched path) — identical math either way.
    def step(state: _LMSState, inputs):
        Xt, energy_t = inputs  # [..., F, C], [...]
        # Step-size slowdown (pybeamformer.py:669-671).
        slow = (state.isamp > 0) & (state.isamp % c.slowdown_after == 0)
        gamma = jnp.where(slow, state.gamma / 2.0, state.gamma)

        gate = energy_t > state.energy / c.sil_thresh  # [...]

        Z = ceinsum("fbc,...fc->...fb", BmH, Xt)  # blocking-matrix outputs
        Yc = ceinsum("fc,...fc->...f", wqH, Xt)  # upper branch

        xpow = jnp.sum(jnp.abs(Xt) ** 2, axis=-1)  # per-bin cross-channel power
        se = jnp.where(
            state.isamp > 0,
            state.subband_energy * c.beta + (1.0 - c.beta) * xpow,
            xpow,
        )
        se = jnp.maximum(se, c.energy_floor)

        epa = Yc - ceinsum("...fb,...fb->...f", state.waH, Z)
        alpha = gamma / se  # [..., F]
        watH = state.waH + epa[..., None] * jnp.conj(Z) * alpha[..., None]
        if c.regularization_param > 0:
            watH = watH - alpha[..., None] * c.regularization_param * state.waH
        norm = jnp.abs(jnp.sum(watH * jnp.conj(watH), axis=-1))
        scale = jnp.where(norm > c.max_wa_l2norm, jnp.sqrt(c.max_wa_l2norm / norm), 1.0)
        waH_new = watH * scale[..., None]

        waH = jnp.where(gate[..., None, None], waH_new, state.waH)
        subband_energy = jnp.where(gate[..., None], se, state.subband_energy)

        Y = jnp.where(
            state.isamp >= c.min_frames,
            Yc - ceinsum("...fb,...fb->...f", waH, Z),
            Yc,
        )
        new_state = _LMSState(
            waH=waH,
            subband_energy=subband_energy,
            energy=state.energy * c.beta + (1.0 - c.beta) * energy_t,
            gamma=gamma,
            isamp=state.isamp + 1,
        )
        return new_state, Y

    return step


@partial(jax.jit, static_argnums=(4,))
def gsc_rls(
    X: jax.Array,
    energy: jax.Array,
    wqH: jax.Array,
    BmH: jax.Array,
    config: GSCRLSConfig = GSCRLSConfig(),
    init_state: _RLSState | None = None,
):
    """RLS GSC with quadratic constraint over an utterance.

    Same interface as `gsc_lms`.  Replicates pybeamformer.py:816-898
    (Van Trees pp. 766-767 recursions; the C++ twin is
    SubbandGSCRLS::update_active_weight_vector2_, beamformer.cc:1576-1645).
    """
    c = config
    F, B = BmH.shape[0], BmH.shape[1]
    batch = X.shape[1:-2]  # () in the per-utterance path
    if init_state is None:
        init_state = rls_init_state(batch, F, B, c.init_diagonal_load, X.dtype)

    final, Y = jax.lax.scan(_rls_step_factory(c, wqH, BmH), init_state, (X, energy.astype(jnp.float32)), unroll=SCAN_UNROLL)
    return Y, final


def _rls_step_factory(c: GSCRLSConfig, wqH, BmH):
    B = BmH.shape[1]
    pairs = _pz_pairs(B)
    pidx = {p: n for n, p in enumerate(pairs)}

    # Pz is carried compressed (see `_RLSState`); the B x B matvecs unroll
    # over components with the lower triangle reconstructed as conj(upper):
    #   (Pz v)_i = d_i v_i + sum_{j>i} off_ij v_j + sum_{j<i} conj(off_ji) v_j
    def _pz_matvec(d, off, v):
        return [
            d[i] * v[i]
            + sum(off[pidx[(i, j)]] * v[j] for j in range(i + 1, B))
            + sum(jnp.conj(off[pidx[(j, i)]]) * v[j] for j in range(i))
            for i in range(B)
        ]

    # Shape-generic over leading batch dims (see `_lms_step_factory`).
    def step(state: _RLSState, inputs):
        Xt, energy_t = inputs  # [..., F, C], [...]
        gate = energy_t > state.energy / c.sil_thresh  # [...]

        Z = ceinsum("fbc,...fc->...fb", BmH, Xt)
        Yc = ceinsum("fc,...fc->...f", wqH, Xt)
        Zl = [Z[..., i] for i in range(B)]
        d = [state.pz_diag[..., i] for i in range(B)]
        off = [state.pz_off[..., n] for n in range(len(pairs))]
        waH_l = [state.waH[..., i] for i in range(B)]

        # Gain vector & precision matrix update.  The reference's second
        # matvec Z^H Pz (pybeamformer.py:838) equals conj(Pz Z) by
        # hermitianity and is not recomputed.
        PzZ = _pz_matvec(d, off, Zl)
        ip = sum(jnp.conj(Zl[i]) * PzZ[i] for i in range(B))
        den = c.mu + ip
        gz = [PzZ[i] / den for i in range(B)]
        dK = [(d[i] - jnp.real(gz[i] * jnp.conj(PzZ[i]))) / c.mu for i in range(B)]
        offK = [(off[n] - gz[i] * jnp.conj(PzZ[j])) / c.mu for n, (i, j) in enumerate(pairs)]

        # Active weight update.
        ep = Yc - sum(waH_l[i] * Zl[i] for i in range(B))
        waH = [waH_l[i] + c.gamma * jnp.conj(gz[i]) * ep for i in range(B)]
        if c.regularization_param > 0:
            # conj(PzK) matvec on the OLD weights: conj(PzK)_ij = conj(offK_ij)
            # above the diagonal, offK_ji below it.
            reg = [
                dK[i] * waH_l[i]
                + sum(jnp.conj(offK[pidx[(i, j)]]) * waH_l[j] for j in range(i + 1, B))
                + sum(offK[pidx[(j, i)]] * waH_l[j] for j in range(i))
                for i in range(B)
            ]
            waH = [waH[i] - reg[i] * c.regularization_param for i in range(B)]

        if c.constraint_option > 0:
            waK2 = sum(jnp.abs(waH[i]) ** 2 for i in range(B))
            if c.constraint_option in (1, 3):
                # Quadratic constraint (pybeamformer.py:849-861).
                waK = [jnp.conj(waH[i]) for i in range(B)]
                va = _pz_matvec(dK, offK, waK)
                a = sum(jnp.abs(va[i]) ** 2 for i in range(B))
                b = -2.0 * sum(jnp.real(jnp.conj(va[i]) * waK[i]) for i in range(B))
                cc = waK2 - c.alpha2
                arg = b * b - 4.0 * a * cc
                a_safe = jnp.where(a > 0, a, 1.0)
                betaK = jnp.where(
                    arg > 0,
                    -(b + jnp.sqrt(jnp.maximum(arg, 0.0))) / (2.0 * a_safe),
                    -b / (2.0 * a_safe),
                )
                hit = waK2 > c.alpha2
                waH = [
                    jnp.where(hit, waH[i] - betaK * jnp.conj(va[i]), waH[i])
                    for i in range(B)
                ]
                # the norm cap below reuses the pre-constraint waK2, like the
                # reference (it computes waK2 once, pybeamformer.py:849)
            if c.constraint_option >= 2:
                # Norm cap + precision reset (pybeamformer.py:862-865).
                over = waK2 > c.max_wa_l2norm
                scale = jnp.sqrt(c.max_wa_l2norm / waK2)
                waH = [jnp.where(over, waH[i] * scale, waH[i]) for i in range(B)]
                dK = [jnp.where(over, 1.0 / c.init_diagonal_load, dK[i]) for i in range(B)]
                offK = [jnp.where(over, 0.0, offK[n]) for n in range(len(pairs))]

        g = gate[..., None]  # broadcast the per-frame gate over the F axis
        d_new = [jnp.where(g, dK[i], d[i]) for i in range(B)]
        off_new = [jnp.where(g, offK[n], off[n]) for n in range(len(pairs))]
        waH_new = [jnp.where(g, waH[i], waH_l[i]) for i in range(B)]

        Y = jnp.where(
            state.isamp >= c.min_frames,
            Yc - sum(waH_new[i] * Zl[i] for i in range(B)),
            Yc,
        )
        new_state = _RLSState(
            waH=jnp.stack(waH_new, axis=-1),
            pz_diag=jnp.stack(d_new, axis=-1),
            pz_off=(
                jnp.stack(off_new, axis=-1)
                if pairs
                else state.pz_off
            ),
            energy=state.energy * c.beta + (1.0 - c.beta) * energy_t,
            isamp=state.isamp + 1,
        )
        return new_state, Y

    return step


@partial(jax.jit, static_argnums=(5, 6, 8, 9, 10))
def gsc_postfilter_fused(
    X: jax.Array,
    energy: jax.Array,
    wqH: jax.Array,
    BmH: jax.Array,
    wq_manifold: jax.Array,
    kind: str,
    config,
    pf_alpha: float = 0.6,
    pf_type: int = 1,
    pf_min_frames: int = 0,
    real_packed: bool = False,
):
    """Adaptive GSC + Zelinski postfilter in ONE scan over frames.

    Produces outputs identical to ``gsc_{lms,rls}`` followed by
    ``postfilter.zelinski_postfilter`` (the CSD recursion depends only on the
    snapshots, so the states fuse safely), but with half the sequential scan
    steps, the launch-bound cost of an XLA scan.

    ``X``: snapshots ``[T, ..., F, C]`` (optional leading batch dims after
    time — the time-major batched layout of `pipeline.build_pipeline`), with
    ``energy [T, ...]``.  With ``real_packed=True``, ``X`` is instead the raw
    packed real analysis output ``[T, ..., C, M]``
    (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes — the structurally-zero
    Im(DC)/Im(Nyquist) dropped, see `ops.filterbank.analysis_half_real_tm`
    ``packed=True``); the complex snapshot is formed per step inside the
    loop body, so the whole spectrum is never transposed, and the output is
    emitted in the same packed layout ``[T, ..., M]``, ready for
    `ops.filterbank.synthesis_half_real_tm`.

    ``wq_manifold``: [F, C] manifold for the postfilter alignment — the C++
    ``ta_`` in the ``e^{-j2 pi f tau}/C`` convention (beamformer.cc:960-965);
    it is conjugated per channel here like time_alignment_
    (postfilter.cc:30-43).
    Returns ``Y_filtered [T, ..., F]`` complex (packed real when
    ``real_packed``).
    """
    from .postfilter import SPECTRAL_FLOOR

    F, B = BmH.shape[0], BmH.shape[1]
    if real_packed:
        C = X.shape[-2]
        batch = X.shape[1:-2]
        cdtype = jnp.complex64 if X.dtype == jnp.float32 else jnp.complex128
        if X.shape[-1] != 2 * (F - 1):
            raise ValueError(
                f"packed lane dim must be M={2 * (F - 1)}, got {X.shape[-1]}"
            )
    else:
        C = X.shape[-1]
        batch = X.shape[1:-2]
        cdtype = X.dtype
    if kind == "lms":
        gsc_state = _LMSState(
            waH=jnp.zeros(batch + (F, B), cdtype),
            subband_energy=jnp.full(batch + (F,), config.init_diagonal_load, jnp.float32),
            energy=jnp.full(batch, config.init_diagonal_load, jnp.float32),
            gamma=jnp.asarray(config.gamma, jnp.float32),
            isamp=jnp.asarray(0, jnp.int32),
        )
        gsc_step = _lms_step_factory(config, wqH, BmH)
    elif kind == "rls":
        gsc_state = rls_init_state(batch, F, B, config.init_diagonal_load, cdtype)
        gsc_step = _rls_step_factory(config, wqH, BmH)
    else:
        raise ValueError(kind)

    real_mode = bool(pf_type & 0x01)
    pairs = [(i, j) for i in range(C) for j in range(C) if i < j]

    # The Zelinski weight reads the smoothed CSD matrix phi [F, C, C] only
    # through two linear functionals — sum over the i<j pairs and the trace
    # (_pair_mask / diagonal in postfilter.zelinski_postfilter) — and the
    # CSD smoothing is linear, so sums and EMA commute: carry just the two
    # reduced quantities instead of the full C x C matrix.  Identical math,
    # ~10x less postfilter scan state.
    M = 2 * (F - 1)

    def step(carry, inputs):
        gstate, phi_pair, phi_diag, t = carry
        if energy is None:
            (Xt,) = inputs
        else:
            Xt, energy_t = inputs
        if real_packed:
            # [..., C, M] packed real -> [..., F, C] complex snapshot
            # (Im of DC/Nyquist are structurally zero).
            zero = jnp.zeros_like(Xt[..., :1])
            im = jnp.concatenate([zero, Xt[..., F:], zero], axis=-1)
            Xt = jnp.moveaxis(jax.lax.complex(Xt[..., :F], im), -2, -1)
        if energy is None:
            # reference-channel frame energy computed in the step — no separate
            # dense pass over the spectrum (MultiChannelSource semantics,
            # pybeamformer.py:263-276)
            energy_t = frame_energy_half(Xt[..., 0], M)
        gstate, Y = gsc_step(gstate, (Xt, energy_t))

        aligned = jnp.conj(wq_manifold) * Xt  # [..., F, C]
        pair_sum = sum(aligned[..., i] * jnp.conj(aligned[..., j]) for i, j in pairs)
        diag_sum = jnp.sum(jnp.abs(aligned) ** 2, axis=-1)
        # the reference smooths from its THIRD call and applies from
        # min_frames+1 (pre-increment frame_no_ checks, postfilter.cc:
        # 424-473) — round-3 parity fix, verified vs the compiled C++
        phi_pair = jnp.where(t > 1, pf_alpha * phi_pair + (1.0 - pf_alpha) * pair_sum, pair_sum)
        phi_diag = jnp.where(t > 1, pf_alpha * phi_diag + (1.0 - pf_alpha) * diag_sum, diag_sum)

        num = jnp.maximum(jnp.real(phi_pair), 0.0) if real_mode else jnp.abs(phi_pair)
        ratio = jnp.where(phi_diag > 0, num / jnp.where(phi_diag > 0, phi_diag, 1.0), 0.0)
        W = jnp.clip(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
        out = jnp.where(t > pf_min_frames, Y * W.astype(Y.dtype), Y)
        if real_packed:
            # emit the packed real layout (synthesis ignores Im(DC)/Im(Nyq))
            out = jnp.concatenate(
                [jnp.real(out), jnp.imag(out)[..., 1 : F - 1]], axis=-1
            )
        return (gstate, phi_pair, phi_diag, t + 1), out

    init = (
        gsc_state,
        jnp.zeros(batch + (F,), cdtype),
        jnp.zeros(batch + (F,), jnp.float32),
        jnp.asarray(0, jnp.int32),
    )
    xs = (X,) if energy is None else (X, energy.astype(jnp.float32))
    (_, _, _, _), Y = jax.lax.scan(step, init, xs, unroll=SCAN_UNROLL)
    return Y
