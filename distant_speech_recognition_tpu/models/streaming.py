"""Chunked online (streaming) enhancement with explicit carried state.

The reference processes audio strictly online: every stage keeps O(1) state in
ring buffers (`RealBuffer_` modulated.h:56-140, GSC `wa`/`Pz` beamformer.h:
249-262, postfilter CSD recursions) and consumes one D-sample block at a time.
The batch pipeline in models/pipeline.py trades that latency for throughput.

This module restores the online capability: a *chunk* of blocks
is processed per call with all per-stage state carried explicitly as a JAX
pytree — so the chunk function jits once, the hot loop is still dense
vectorized math over the chunk (no per-frame Python), and the carried pytree
doubles as a **checkpoint**: serialize it (utils/checkpoint.py) and a new
process can resume the stream bit-exactly where the old one stopped.

Equivalence: feeding a signal through `StreamingEnhancer` in chunks of any
size yields exactly the same samples as `build_pipeline` on the whole
utterance (see tests/test_streaming.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.filterbank import FilterbankParams, hermitian_mirror
from ..utils.jaxenv import host_device
from . import beamforming as bf
from .adaptive_gsc import (
    _LMSState,
    rls_init_state,
    _lms_step_factory,
    _rls_step_factory,
)
from .postfilter import SPECTRAL_FLOOR, _pair_mask

__all__ = [
    "AnalysisState",
    "SynthesisState",
    "streaming_analysis",
    "streaming_synthesis",
    "analysis_init",
    "synthesis_init",
    "StreamingEnhancer",
]


class AnalysisState(NamedTuple):
    """Sample history: the last ``N - D`` samples seen (zero at stream start),
    the dense equivalent of the analysis ring buffer (modulated.cc:363-373)."""

    hist: jax.Array  # [..., N - D]


class SynthesisState(NamedTuple):
    """The last ``(m-1) R`` DFT'd rows and ``R - 1`` polyphase-FIR rows —
    exactly the reach of the synthesis ring buffers (modulated.cc:594-606) —
    plus the push counter (priming pushes emit no FIR row, cc:574-578)."""

    c_hist: jax.Array  # [..., (m-1)*R, M]
    s_hist: jax.Array  # [..., R-1, M]
    count: jax.Array  # scalar int32: pushes seen so far


from functools import lru_cache


@lru_cache(maxsize=8)
def _idft_mats(M: int):
    """f32 cos/sin matrices for ``X[k] = sum_n v[n] e^{+2 pi i n k / M}``
    (= M * ifft), the DFT as two f32 matmuls like the batch path
    (ops/dft)."""
    n = np.arange(M)
    ang = 2.0 * np.pi * np.outer(n, n) / M
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _mm(a, m):
    """``a @ m`` at full f32 precision (no TF32 on a GPU)."""
    return jnp.matmul(a, jnp.asarray(m), precision=jax.lax.Precision.HIGHEST)


@lru_cache(maxsize=8)
def _dft_real_mats(M: int):
    """f32 matrices for ``c[n] = Re(sum_k Y[k] e^{-2 pi i k n / M})``
    (= real(fft)): c = Yr @ C + Yi @ S."""
    n = np.arange(M)
    ang = 2.0 * np.pi * np.outer(n, n) / M
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def analysis_init(params: FilterbankParams, lead: tuple = (), dtype=jnp.float32) -> AnalysisState:
    return AnalysisState(hist=jnp.zeros(lead + (params.N - params.D,), dtype))


def synthesis_init(params: FilterbankParams, lead: tuple = (), dtype=jnp.float32) -> SynthesisState:
    p = params
    return SynthesisState(
        c_hist=jnp.zeros(lead + ((p.m - 1) * p.R, p.M), dtype),
        s_hist=jnp.zeros(lead + (p.R - 1, p.M), dtype),
        count=jnp.asarray(0, jnp.int32),
    )


@partial(jax.jit, static_argnums=(3,))
def streaming_analysis(state: AnalysisState, x_chunk: jax.Array, h: jax.Array,
                       params: FilterbankParams):
    """Analysis of one chunk with carried sample history.

    ``x_chunk``: ``[..., n_blocks * D]`` samples.  Emits one subband frame per
    D-block: frame for push ``b`` is the window ending at the last sample of
    that block (OverSampledDFTAnalysisBank push semantics, modulated.cc:
    375-409).  Push index ``b`` equals batch-analysis frame ``b - laN``; the
    caller discards the first ``laN`` frames of the stream.

    Returns ``(new_state, frames [..., n_blocks, M] complex64)``.
    """
    D, N, M, m = params.D, params.N, params.M, params.m
    lead = x_chunk.ndim - 1
    xx = jnp.concatenate([state.hist, x_chunk], axis=-1)
    n_blocks = x_chunk.shape[-1] // D
    blocks = xx.reshape(xx.shape[:-1] + (-1, D))
    mR = m * params.R
    segs = [
        jax.lax.slice_in_dim(blocks, i, i + n_blocks, axis=lead) for i in range(mR)
    ]
    windows = jnp.stack(segs, axis=lead + 1).reshape(
        x_chunk.shape[:-1] + (n_blocks, N)
    )
    prod = windows[..., ::-1] * jnp.asarray(h, x_chunk.dtype)
    v = prod.reshape(prod.shape[:-1] + (m, M)).sum(axis=-2)
    # M * ifft as two f32 DFT matmuls at full precision
    Cm, Sm = _idft_mats(M)
    X = jax.lax.complex(_mm(v, Cm), _mm(v, Sm))
    return AnalysisState(hist=xx[..., -(N - D):]), X.astype(jnp.complex64)


@partial(jax.jit, static_argnums=(3,))
def streaming_synthesis(state: SynthesisState, Y_chunk: jax.Array, g: jax.Array,
                        params: FilterbankParams):
    """Synthesis of one chunk of subband frames with carried filter state.

    ``Y_chunk``: ``[..., T, M]`` full-spectrum frames.  Emits one D-sample
    block per frame (the first ``synthesis_delay`` blocks of the stream are
    priming output and must be discarded by the caller, modulated.cc:574-578).

    Returns ``(new_state, samples [..., T * D])``.
    """
    M, m, R, D = params.M, params.m, params.R, params.D
    lead = Y_chunk.ndim - 2
    T = Y_chunk.shape[-2]

    # real(fft) as two f32 DFT matmuls at full precision
    Cm, Sm = _dft_real_mats(M)
    c = (_mm(jnp.real(Y_chunk), Cm)
         + _mm(jnp.imag(Y_chunk), Sm)).astype(state.c_hist.dtype)
    call = jnp.concatenate([state.c_hist, c], axis=lead)  # [(m-1)R + T, M]
    gf = jnp.asarray(g, c.dtype).reshape(m, M)[:, ::-1]
    # s for push q = sum_k gf[k] * c[q - k R]; row (t + k R) of ``call`` is
    # global row (q - (m-1-k) R), so tap k pairs with gf[m-1-k]
    # (modulated.cc:594-598).
    s = sum(
        gf[m - 1 - k] * jax.lax.slice_in_dim(call, k * R, k * R + T, axis=lead)
        for k in range(m)
    )  # [..., T, M]
    # priming pushes produce no FIR row (modulated.cc:574-578)
    q = state.count + jnp.arange(T)
    s = jnp.where((q >= params.synthesis_delay)[:, None], s, 0.0)
    sall = jnp.concatenate([state.s_hist, s], axis=lead)  # [R-1+T, M]
    seg = sall.reshape(sall.shape[:-1] + (R, D))[..., ::-1]
    out = sum(
        jax.lax.slice_in_dim(seg, R - 1 - j, R - 1 - j + T, axis=lead)[..., R - 1 - j, :]
        for j in range(R)
    )  # [..., T, D]
    new = SynthesisState(
        c_hist=jax.lax.slice_in_dim(call, T, T + (m - 1) * R, axis=lead),
        s_hist=jax.lax.slice_in_dim(sall, T, T + R - 1, axis=lead),
        count=state.count + T,
    )
    return new, out.reshape(out.shape[:lead] + (T * D,))


def _dev_make(fn):
    """Build a pytree of state arrays in one jitted program (one dispatch
    instead of one eager op per array)."""
    import jax

    return jax.jit(fn)()


class _CSDState(NamedTuple):
    phi: jax.Array  # [F, C, C]
    t: jax.Array  # scalar int32


class _AECState(NamedTuple):
    """Per-channel NLMS echo-canceller filters (aec.cc:41-81); each recorded
    channel adapts independently against the shared far-end reference."""

    R: jax.Array  # [C, F] complex64


class _KalmanAECState(NamedTuple):
    """Per-channel scalar-Kalman echo-canceller state
    (KalmanFilterEchoCancellationFeature, aec.cc:118-164)."""

    R: jax.Array  # [C, F] complex64
    sigma2_v: jax.Array  # [C, F] float32
    K_k: jax.Array  # [C, F] float32


class _WPEState(NamedTuple):
    """WPE streaming-apply state: the last ``P-1`` input (post-AEC) frames —
    the lag-window reach of the reference's apply ring
    (dereverberation.cc:251-265) — and the global frame counter for the
    ``t >= lowerN`` gate."""

    hist: jax.Array  # [C, P-1, F] complex64, most recent last
    t: jax.Array  # scalar int32


def _zelinski_step_factory(wq_manifold, pf_alpha, pf_type, pf_min_frames):
    C = wq_manifold.shape[-1]
    pair = jnp.asarray(_pair_mask(C))
    real_mode = bool(pf_type & 0x01)

    def step(state: _CSDState, inputs):
        Xt, Y = inputs
        aligned = jnp.conj(wq_manifold) * Xt
        P = aligned[:, :, None] * jnp.conj(aligned)[:, None, :]
        # reference: smoothing from the third call, apply from min+1
        # (pre-increment frame_no_, postfilter.cc:424-473)
        phi = jnp.where(state.t > 1, pf_alpha * state.phi + (1.0 - pf_alpha) * P, P)
        csd_sum = jnp.sum(jnp.where(pair, phi, 0), axis=(-2, -1))
        num = jnp.maximum(jnp.real(csd_sum), 0.0) if real_mode else jnp.abs(csd_sum)
        den = jnp.sum(jnp.real(jnp.diagonal(phi, axis1=-2, axis2=-1)), axis=-1)
        ratio = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
        W = jnp.clip(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
        out = jnp.where(state.t > pf_min_frames, Y * W.astype(Y.dtype), Y)
        return _CSDState(phi=phi, t=state.t + 1), out

    return step


class StreamingEnhancer:
    """Online chunked version of ``build_pipeline``: same config surface,
    same output samples, O(1) carried state, checkpoint/resume.

    Supported: beamformer ds | sd_mvdr | gsc_lms | gsc_rls, postfilter
    none | zelinski.  Feed samples with :meth:`process` (any length), finish
    with :meth:`flush`; both return the enhanced samples ready so far.
    :meth:`checkpoint` / :meth:`restore` snapshot the full pipeline state.
    """

    def __init__(self, cfg, mpos, delays, h, g, frames_per_chunk: int = 64):
        from .pipeline import PipelineConfig  # noqa: F401  (type reference)

        if cfg.postfilter not in ("none", "zelinski"):
            raise ValueError(f"streaming supports none|zelinski, got {cfg.postfilter}")
        if cfg.beamformer not in ("ds", "sd_mvdr", "gsc_lms", "gsc_rls"):
            raise ValueError(f"unsupported streaming beamformer {cfg.beamformer}")
        if cfg.aec not in ("none", "nlms", "kalman"):
            raise ValueError(f"streaming supports aec none|nlms|kalman, got {cfg.aec}")
        self.cfg = cfg
        self.p = cfg.fb
        self.h = np.asarray(h, np.float32)
        self.g = np.asarray(g, np.float32)
        self.Tc = int(frames_per_chunk)
        delays = np.asarray(delays)

        with host_device():
            vs = bf.array_manifold(cfg.fb.M, cfg.samplerate, delays)
            # = the C++ ta_ (beamformer.cc:960-965); _zelinski_step_factory
            # conjugates it per channel like time_alignment_
            # (postfilter.cc:30-43)
            self.wq_manifold = np.asarray(vs)
            if cfg.beamformer == "ds":
                self.wqH, self.BmH = np.conj(self.wq_manifold), None
            elif cfg.beamformer == "sd_mvdr":
                self.wqH = np.asarray(
                    bf.superdirective_weights(mpos, delays, cfg.fb.M, cfg.samplerate, mu=cfg.sd_mu)
                )
                self.BmH = None
            else:
                from .adaptive_gsc import gsc_weights

                wqH, BmH = gsc_weights(cfg.fb.M, cfg.samplerate, delays, cfg.Nc)
                self.wqH, self.BmH = np.asarray(wqH), np.asarray(BmH)

        F = cfg.fb.M // 2 + 1
        C = len(delays)
        self._F, self._C = F, C

        # --- carried state ---------------------------------------------
        self.a_state = analysis_init(self.p, lead=(C,))
        self.s_state = synthesis_init(self.p)
        if cfg.beamformer == "gsc_lms":
            c = cfg.lms
            B = self.BmH.shape[1]
            self.g_state = _dev_make(lambda: _LMSState(
                waH=jnp.zeros((F, B), jnp.complex64),
                subband_energy=jnp.full((F,), c.init_diagonal_load, jnp.float32),
                energy=jnp.asarray(c.init_diagonal_load, jnp.float32),
                gamma=jnp.asarray(c.gamma, jnp.float32),
                isamp=jnp.asarray(0, jnp.int32),
            ))
        elif cfg.beamformer == "gsc_rls":
            c = cfg.rls
            B = self.BmH.shape[1]
            self.g_state = _dev_make(
                lambda: rls_init_state((), F, B, c.init_diagonal_load))
        else:
            self.g_state = None
        self.pf_state = (
            _dev_make(lambda: _CSDState(
                phi=jnp.zeros((F, C, C), jnp.complex64),
                t=jnp.asarray(0, jnp.int32)))
            if cfg.postfilter == "zelinski"
            else None
        )
        if cfg.aec == "nlms":
            self.aec_state = _dev_make(
                lambda: _AECState(R=jnp.zeros((C, F), jnp.complex64)))
        elif cfg.aec == "kalman":
            # (beta, sigma2) ride the same config fields the pipeline maps
            # them to (PipelineConfig.aec_delta / aec_epsilon)
            self.aec_state = _dev_make(lambda: _KalmanAECState(
                R=jnp.zeros((C, F), jnp.complex64),
                sigma2_v=jnp.full((C, F), cfg.aec_epsilon, jnp.float32),
                K_k=jnp.full((C, F), cfg.aec_epsilon, jnp.float32),
            ))
        else:
            self.aec_state = None
        # WPE streaming default is APPLY-ONLY, like the reference: filters
        # estimated beforehand (estimate_filter() protocol,
        # test_subband_dereverberator.py:73-84) and set via set_wpe_filters.
        # enable_wpe_reestimation() adds a block-online upgrade:
        # periodic re-estimation from a carried context of recent frames.
        self._wpe_G = None
        self.wpe_state = None
        self._wpe_reest = None  # (context_frames, every_chunks) when enabled
        self._wpe_ctx = None  # np [C, n, F] recent post-AEC frames
        self._wpe_chunks = 0
        if cfg.wpe:
            P = cfg.wpe_upper - cfg.wpe_lower + 1
            self._wpe_P = P
            self.wpe_state = _dev_make(lambda: _WPEState(
                hist=jnp.zeros((C, max(P - 1, 1), F), jnp.complex64),
                t=jnp.asarray(0, jnp.int32),
            ))
        if cfg.aec in ("nlms", "kalman"):
            self.pa_state = analysis_init(self.p)  # far-end analysis history
            self._psample_buf = np.zeros(0, np.float32)
            self._pframe_buf = None
            self._pskip_frames = self.p.laN

        # --- host-side stream bookkeeping ------------------------------
        self._sample_buf = np.zeros((C, 0), np.float32)
        self._frame_buf = None  # np [C, n, M] pending subband frames
        self._skip_frames = self.p.laN  # frames still to discard at start
        self._skip_blocks = self.p.synthesis_delay  # priming output blocks
        self._flushed = False

        self._mid = self._build_mid()

    # ------------------------------------------------------------------
    def set_wpe_filters(self, G) -> None:
        """Set (or replace) WPE prediction filters ``G [C, F, C*P]``
        (models.dereverberation.wpe_estimate) for the streaming apply.  The
        filters are a traced argument of the jitted chunk function, so
        swapping them (e.g. block-online re-estimation) does NOT recompile."""
        if not self.cfg.wpe:
            raise ValueError("cfg.wpe is off")
        Gn = np.asarray(G, np.complex64)
        C, F, CP = Gn.shape
        if CP != self._C * self._wpe_P or C != self._C or F != self._F:
            raise ValueError(f"expected G [{self._C}, {self._F}, "
                             f"{self._C * self._wpe_P}], got {Gn.shape}")
        # reference apply-ring quirk: taps p >= P - lowerN never contribute
        # (models.dereverberation.wpe_apply)
        lower, P = self.cfg.wpe_lower, self._wpe_P
        if lower > 0:
            tap_ok = np.tile(np.arange(P) < P - lower, self._C)
            Gn = Gn * tap_ok.astype(np.complex64)
        self._wpe_G = jnp.asarray(Gn, jnp.complex64)

    def enable_wpe_reestimation(self, context_frames: int = 512,
                                every_chunks: int = 4) -> None:
        """Block-online WPE (an upgrade over the reference's
        buffer-then-apply design, dereverberation.cc:214-275): every
        ``every_chunks`` chunks, re-estimate the prediction filters from the
        last ``context_frames`` post-AEC subband frames and swap them into
        the (unchanged, already-compiled) apply path.  At a re-estimation
        boundary the new filters equal ``wpe_estimate`` on exactly the
        context window (tests/test_streaming.py)."""
        if not self.cfg.wpe:
            raise ValueError("cfg.wpe is off")
        self._wpe_reest = (int(context_frames), int(every_chunks))
        self._wpe_ctx = np.zeros((self._C, 0, self._F), np.complex64)
        if self._wpe_G is None:
            # start from zero filters (pure passthrough apply) until the
            # first re-estimation boundary
            self._wpe_G = jnp.zeros(
                (self._C, self._F, self._C * self._wpe_P), jnp.complex64
            )

    def _front_steps(self):
        """AEC + WPE half-band stages shared by both mid variants.

        Returns ``front(aec_state, wpe_state, Gq, frames, pframes) ->
        (aec_state, wpe_state, subh [C, T, F])`` where ``subh`` is the
        post-AEC, post-WPE half-band chunk and ``Gq`` the (possibly zero)
        apply filters.
        """
        cfg = self.cfg
        F = self._F
        lower = cfg.wpe_lower
        P = getattr(self, "_wpe_P", 1)

        def front(aec_state, wpe_state, Gq, frames, pframes):
            subh = frames[..., :F]  # [C, T, F]
            if cfg.aec == "nlms":
                Vh = pframes[..., :F]  # [T, F]
                eps, delta, thr = cfg.aec_epsilon, cfg.aec_delta, cfg.aec_threshold

                def step(R, inputs):
                    Vk, Ak = inputs  # [F], [C, F]
                    Ek = Ak - R * Vk
                    gate = jnp.abs(Vk) ** 2 > thr
                    Gkhat = Ak / jnp.where(jnp.abs(Vk) > 0, Vk, 1.0)
                    dC = R - Gkhat
                    deltaC = dC * (eps * jnp.abs(Vk) ** 2 / (delta + jnp.abs(Ak) ** 2))
                    return jnp.where(gate, R - deltaC, R), Ek

                R, E = jax.lax.scan(
                    step, aec_state.R, (Vh, jnp.moveaxis(subh, 1, 0))
                )
                aec_state = _AECState(R=R)
                subh = jnp.moveaxis(E, 0, 1)  # [C, T, F]
            elif cfg.aec == "kalman":
                Vh = pframes[..., :F]  # [T, F]
                beta, sigma2 = cfg.aec_delta, cfg.aec_epsilon
                thr = cfg.aec_threshold

                def kstep(s, inputs):
                    Vk, Ak = inputs  # [F], [C, F]
                    Ek = Ak - s.R * Vk
                    gate = jnp.abs(Vk) ** 2 > thr
                    sigma2_v = beta * s.sigma2_v + (1.0 - beta) * jnp.abs(Ek) ** 2
                    K_k_k1 = s.K_k + sigma2
                    sigma2_s = jnp.abs(Vk) ** 2 * K_k_k1 + sigma2_v
                    Gk = jnp.conj(Vk) * (K_k_k1 / sigma2_s)
                    R_new = s.R + Gk * Ek
                    K_new = (1.0 - K_k_k1 * jnp.abs(Vk) ** 2 / sigma2_s) * K_k_k1
                    s_new = _KalmanAECState(
                        R=jnp.where(gate, R_new, s.R),
                        sigma2_v=jnp.where(gate, sigma2_v, s.sigma2_v),
                        K_k=jnp.where(gate, K_new, s.K_k),
                    )
                    return s_new, Ek

                aec_state, E = jax.lax.scan(
                    kstep, aec_state, (Vh, jnp.moveaxis(subh, 1, 0))
                )
                subh = jnp.moveaxis(E, 0, 1)  # [C, T, F]
            subh_pre = subh  # post-AEC, pre-WPE (the re-estimation context)
            if cfg.wpe:
                C = subh.shape[0]
                T = subh.shape[1]
                yy = jnp.concatenate([wpe_state.hist, subh], axis=1)
                # l_t[p] = y[t - lower - p]: slice offsets relative to the
                # (P-1)-frame history prefix
                slices = []
                for p in range(P):
                    start = (P - 1) + 0 - lower - p  # local index of t=0 lag
                    sl = jax.lax.slice_in_dim(
                        yy, start if start >= 0 else 0, (start if start >= 0 else 0) + T, axis=1
                    )
                    if start < 0:  # lags reaching past the carried history
                        sl = jnp.zeros_like(sl)
                    slices.append(sl)
                L = jnp.stack(slices, axis=-1)  # [C, T, F, P]
                Lf = jnp.moveaxis(L, 0, -2).reshape(T, self._F, C * P)
                pred = jnp.einsum(
                    "cfp,tfp->ctf", jnp.conj(Gq), Lf,
                    precision=jax.lax.Precision.HIGHEST,
                )
                tglob = wpe_state.t + jnp.arange(T)
                subh = subh - jnp.where((tglob >= lower)[None, :, None], pred, 0.0)
                wpe_state = _WPEState(
                    hist=yy[:, -max(P - 1, 1):], t=wpe_state.t + T
                )
            return aec_state, wpe_state, subh, subh_pre

        return front

    def _build_mid(self):
        cfg = self.cfg
        # weight constants as RE/IM f32 numpy closures, combined in-trace
        # (numpy closures embed as constants without a device read)
        wq_np = np.asarray(self.wqH, np.complex64)
        bm_np = None if self.BmH is None else np.asarray(self.BmH, np.complex64)
        ta_np = np.asarray(self.wq_manifold, np.complex64)
        wq_ri = (wq_np.real.copy(), wq_np.imag.copy())
        bm_ri = None if bm_np is None else (bm_np.real.copy(), bm_np.imag.copy())
        ta_ri = (ta_np.real.copy(), ta_np.imag.copy())

        def _trace_c(ri):
            return jax.lax.complex(jnp.asarray(ri[0]), jnp.asarray(ri[1]))

        def _make_pf_step():
            if cfg.postfilter != "zelinski":
                return None
            return _zelinski_step_factory(
                _trace_c(ta_ri), cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)

        M = self.p.M
        front = self._front_steps()
        if cfg.beamformer in ("gsc_lms", "gsc_rls"):

            def mid(g_state, pf_state, s_state, aec_state, wpe_state, Gq,
                    frames, pframes):
                wqH = _trace_c(wq_ri)
                BmH = None if bm_ri is None else _trace_c(bm_ri)
                pf_step = _make_pf_step()
                gsc_step = (
                    _lms_step_factory(cfg.lms, wqH, BmH)
                    if cfg.beamformer == "gsc_lms"
                    else _rls_step_factory(cfg.rls, wqH, BmH)
                )
                # frames: [C, T, M] -> Y blocks [T * D]
                aec_state, wpe_state, subh, subh_pre = front(
                    aec_state, wpe_state, Gq, frames, pframes
                )
                X = jnp.moveaxis(subh, 0, -1)  # [T, F, C]
                energy = bf.frame_energy_half(X[..., 0], M).astype(jnp.float32)

                def step(carry, inputs):
                    gs, ps = carry
                    Xt, et = inputs
                    gs, Y = gsc_step(gs, (Xt, et))
                    if pf_step is not None:
                        ps, Y = pf_step(ps, (Xt, Y))
                    return (gs, ps), Y

                (g_state, pf_state), Y = jax.lax.scan(step, (g_state, pf_state), (X, energy))
                Yfull = hermitian_mirror(Y, M)
                s_state, y = streaming_synthesis(s_state, Yfull, self.g, self.p)
                return g_state, pf_state, s_state, aec_state, wpe_state, y, subh_pre
        else:

            def mid(g_state, pf_state, s_state, aec_state, wpe_state, Gq,
                    frames, pframes):
                wqH = _trace_c(wq_ri)
                pf_step = _make_pf_step()
                aec_state, wpe_state, subh, subh_pre = front(
                    aec_state, wpe_state, Gq, frames, pframes
                )
                X = jnp.moveaxis(subh, 0, -1)  # [T, F, C]
                Y = bf.apply_weights(wqH, X)
                if pf_step is not None:
                    def step(ps, inputs):
                        ps, out = pf_step(ps, inputs)
                        return ps, out

                    pf_state, Y = jax.lax.scan(step, pf_state, (X, Y))
                Yfull = hermitian_mirror(Y, M)
                s_state, y = streaming_synthesis(s_state, Yfull, self.g, self.p)
                return g_state, pf_state, s_state, aec_state, wpe_state, y, subh_pre

        return jax.jit(mid)

    # ------------------------------------------------------------------
    def _run_frames(self, force: bool = False) -> np.ndarray:
        """Run pending frames through the adaptive + synthesis stages in
        fixed-size chunks; with ``force``, zero-pad the final partial chunk
        and keep only the samples from real frames."""
        D = self.p.D
        outs = []
        valid = 0
        use_play = self.cfg.aec in ("nlms", "kalman")
        # wpe off: a scalar dummy keeps the jitted signature stable
        Gq = (self._wpe_G if self.cfg.wpe
              else _dev_make(lambda: jnp.zeros((), jnp.complex64)))

        def run_chunk(chunk, pchunk):
            nonlocal Gq
            (self.g_state, self.pf_state, self.s_state, self.aec_state,
             self.wpe_state, y, subh_pre) = self._mid(
                self.g_state, self.pf_state, self.s_state, self.aec_state,
                self.wpe_state, Gq, chunk, pchunk
            )
            if self._wpe_reest is not None:
                ctx_n, every = self._wpe_reest
                self._wpe_ctx = np.concatenate(
                    [self._wpe_ctx, np.asarray(subh_pre)], axis=1
                )[:, -ctx_n:]
                self._wpe_chunks += 1
                lower = self.cfg.wpe_lower
                if (self._wpe_chunks % every == 0
                        and self._wpe_ctx.shape[1] > 4 * self._wpe_P + lower):
                    from .dereverberation import _mask_G, wpe_estimate

                    G = wpe_estimate(
                        jnp.asarray(self._wpe_ctx), lower, self.cfg.wpe_upper,
                        self.cfg.wpe_iterations,
                    )
                    if self.cfg.wpe_band_width > 0:
                        G = _mask_G(G, self._F, self.cfg.wpe_band_width,
                                    self.cfg.samplerate)
                    self.set_wpe_filters(G)
                    Gq = self._wpe_G
            return y

        def n_ready():
            n = 0 if self._frame_buf is None else self._frame_buf.shape[1]
            if use_play:
                np_ = 0 if self._pframe_buf is None else self._pframe_buf.shape[0]
                n = min(n, np_)
            return n

        def pop(n, pad_to=None):
            chunk = self._frame_buf[:, :n]
            self._frame_buf = self._frame_buf[:, n:]
            if self._frame_buf.shape[1] == 0:
                self._frame_buf = None
            if use_play:
                pchunk = self._pframe_buf[:n]
                self._pframe_buf = self._pframe_buf[n:]
                if self._pframe_buf.shape[0] == 0:
                    self._pframe_buf = None
            else:
                pchunk = np.zeros((n, self.p.M), np.complex64)
            if pad_to and n < pad_to:
                chunk = np.concatenate(
                    [chunk, np.zeros((self._C, pad_to - n, self.p.M), np.complex64)], axis=1
                )
                pchunk = np.concatenate(
                    [pchunk, np.zeros((pad_to - n, self.p.M), np.complex64)], axis=0
                )
            return jnp.asarray(chunk), jnp.asarray(pchunk)

        while n_ready() >= self.Tc:
            chunk, pchunk = pop(self.Tc)
            outs.append(np.asarray(run_chunk(chunk, pchunk)))
            valid += self.Tc * D
        n_left = n_ready()
        if force and n_left:
            chunk, pchunk = pop(n_left, pad_to=self.Tc)
            outs.append(np.asarray(run_chunk(chunk, pchunk)))
            valid += n_left * D
        if not outs:
            return np.zeros(0, np.float32)
        y = np.concatenate(outs)[:valid]
        skip = min(self._skip_blocks * D, valid)
        self._skip_blocks -= skip // D
        return y[skip:]

    def process(self, x: np.ndarray, play: np.ndarray | None = None) -> np.ndarray:
        """Feed ``x [C, T]`` samples (and, with ``cfg.aec != "none"``, the
        same-length far-end reference ``play [T]``); returns enhanced samples
        available so far."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        if self.cfg.wpe and self._wpe_G is None:
            raise RuntimeError(
                "cfg.wpe is on: call set_wpe_filters() first (the reference's "
                "estimate_filter() protocol — streaming WPE is apply-only)"
            )
        x = np.asarray(x, np.float32)
        if self.cfg.aec in ("nlms", "kalman"):
            if play is None:
                raise ValueError(f"cfg.aec={self.cfg.aec!r} requires the far-end `play`")
            play = np.asarray(play, np.float32).ravel()
            if play.shape[0] != x.shape[1]:
                raise ValueError("play must have the same length as x")
            self._psample_buf = np.concatenate([self._psample_buf, play])
        self._sample_buf = np.concatenate([self._sample_buf, x], axis=1)
        D = self.p.D
        n_blocks = self._sample_buf.shape[1] // D
        if n_blocks:
            chunk = self._sample_buf[:, : n_blocks * D]
            self._sample_buf = self._sample_buf[:, n_blocks * D :]
            self.a_state, frames = streaming_analysis(self.a_state, jnp.asarray(chunk), self.h, self.p)
            frames = np.asarray(frames, np.complex64)
            if self._skip_frames:
                k = min(self._skip_frames, frames.shape[1])
                frames = frames[:, k:]
                self._skip_frames -= k
            if frames.shape[1]:
                self._frame_buf = (
                    frames
                    if self._frame_buf is None
                    else np.concatenate([self._frame_buf, frames], axis=1)
                )
            if self.cfg.aec in ("nlms", "kalman"):
                pchunk = self._psample_buf[: n_blocks * D]
                self._psample_buf = self._psample_buf[n_blocks * D :]
                self.pa_state, pframes = streaming_analysis(
                    self.pa_state, jnp.asarray(pchunk), self.h, self.p
                )
                pframes = np.asarray(pframes, np.complex64)
                if self._pskip_frames:
                    k = min(self._pskip_frames, pframes.shape[0])
                    pframes = pframes[k:]
                    self._pskip_frames -= k
                if pframes.shape[0]:
                    self._pframe_buf = (
                        pframes
                        if self._pframe_buf is None
                        else np.concatenate([self._pframe_buf, pframes], axis=0)
                    )
        return self._run_frames()

    def flush(self) -> np.ndarray:
        """End of stream: zero-pad the residual to a whole block, push the
        analysis bank's ``analysis_delay`` flush blocks (modulated.cc:440-466),
        drain all pending frames, and return the tail samples."""
        if self._flushed:
            return np.zeros(0, np.float32)
        D = self.p.D
        resid = self._sample_buf.shape[1]
        pad = (D - resid % D) % D + self.p.analysis_delay * D
        pplay = (np.zeros(pad, np.float32)
                 if self.cfg.aec in ("nlms", "kalman") else None)
        out = self.process(np.zeros((self._C, pad), np.float32), pplay)
        self._flushed = True
        tail = self._run_frames(force=True)
        return np.concatenate([out, tail])

    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot of all carried state + host bookkeeping (a pytree of
        numpy arrays; serialize with utils/checkpoint.save_pytree)."""
        def dev(t):
            return jax.tree.map(np.asarray, t)

        return {
            "a_state": dev(self.a_state),
            "s_state": dev(self.s_state),
            "g_state": dev(self.g_state) if self.g_state is not None else None,
            "pf_state": dev(self.pf_state) if self.pf_state is not None else None,
            "sample_buf": self._sample_buf,
            "frame_buf": self._frame_buf,
            "skip_frames": self._skip_frames,
            "skip_blocks": self._skip_blocks,
            "aec_state": dev(self.aec_state) if self.aec_state is not None else None,
            "wpe_state": dev(self.wpe_state) if self.wpe_state is not None else None,
            "pa_state": dev(self.pa_state) if self.cfg.aec in ("nlms", "kalman") else None,
            "psample_buf": self._psample_buf if self.cfg.aec in ("nlms", "kalman") else None,
            "pframe_buf": self._pframe_buf if self.cfg.aec in ("nlms", "kalman") else None,
            "pskip_frames": self._pskip_frames if self.cfg.aec in ("nlms", "kalman") else None,
            "wpe_G": None if self._wpe_G is None else np.asarray(self._wpe_G),
            "wpe_ctx": self._wpe_ctx,
            "wpe_chunks": self._wpe_chunks,
        }

    def restore(self, snap: dict) -> None:
        self.a_state = AnalysisState(*map(jnp.asarray, snap["a_state"]))
        self.s_state = SynthesisState(*map(jnp.asarray, snap["s_state"]))
        if snap["g_state"] is not None:
            cls = type(self.g_state)
            self.g_state = cls(*map(jnp.asarray, snap["g_state"]))
        if snap["pf_state"] is not None:
            self.pf_state = _CSDState(*map(jnp.asarray, snap["pf_state"]))
        self._sample_buf = np.asarray(snap["sample_buf"])
        fb = snap["frame_buf"]
        self._frame_buf = None if fb is None else np.asarray(fb)
        self._skip_frames = int(snap["skip_frames"])
        self._skip_blocks = int(snap["skip_blocks"])
        if snap.get("aec_state") is not None:
            acls = type(self.aec_state)
            self.aec_state = acls(*map(jnp.asarray, snap["aec_state"]))
        if snap.get("wpe_state") is not None:
            self.wpe_state = _WPEState(*map(jnp.asarray, snap["wpe_state"]))
        if snap.get("pa_state") is not None:
            self.pa_state = AnalysisState(*map(jnp.asarray, snap["pa_state"]))
            self._psample_buf = np.asarray(snap["psample_buf"])
            pf = snap["pframe_buf"]
            self._pframe_buf = None if pf is None else np.asarray(pf)
            self._pskip_frames = int(snap["pskip_frames"])
        if snap.get("wpe_G") is not None:
            self._wpe_G = jnp.asarray(snap["wpe_G"])
        if snap.get("wpe_ctx") is not None:
            self._wpe_ctx = np.asarray(snap["wpe_ctx"])
            self._wpe_chunks = int(snap.get("wpe_chunks", 0))
        self._flushed = False
