"""Oversampled DFT-modulated subband analysis/synthesis filterbanks.

Batched reformulation of the polyphase filterbanks of the reference
(`modulated/modulated.cc`).  The reference processes one frame at a time
through circular ring buffers (`RealBuffer_`, modulated.h:56-140); here the
whole utterance is a dense tensor and every frame is produced at once:

Analysis (reference: ``OverSampledDFTAnalysisBank::next``, modulated.cc:375-409):
  the per-frame state machine (ring buffer of the last ``N = M*m`` samples,
  polyphase FIR ``sum_k h[mi + M k] * buf[R k, mi]``, unnormalized backward
  length-``M`` DFT) reduces algebraically to, for output frame ``t``::

      window_t[j] = x[(t + laN + 1) * D - 1 - j],  j = 0..N-1   (zero history)
      v_t[mi]     = sum_k h[mi + M k] * window_t[mi + M k]
      X_t         = M * ifft(v_t)                  (unnormalized backward DFT)

  i.e. reverse the chronological window, multiply by the prototype, fold the
  length-``N`` product into ``(m, M)`` and sum, then transform.  ``laN``
  (look-ahead skip) and the ``processing_delay`` zero-padding tail replicate
  the delay-compensation modes 0/1/2 of modulated.cc:246-264 and the
  end-of-stream padding protocol of modulated.cc:418-469.

Synthesis (reference: ``OverSampledDFTSynthesisBank::next``, modulated.cc:569-612):
  ``c_t = Re(fft(Y_t))`` (unnormalized forward DFT, modulated.cc:551-567), an
  ``m``-tap FIR over pushed frames with stride ``R`` and flipped polyphase::

      s_t[mi]  = sum_k g[(M-1-mi) + M k] * c_{t'-R k}[mi],   t' = t + pd_s
      out_t[i] = sum_{j=0}^{R-1} s_{t-j}[(R-1-j) * D + (D-1-i)]

  where ``pd_s`` frames of priming replicate modulated.cc:574-578.

Everything is expressed with static slices / reshapes / matmuls / FFTs, so
XLA compiles it as a few dense kernels; no gathers and no per-frame Python.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import dft

__all__ = [
    "FilterbankParams",
    "analysis",
    "analysis_half",
    "analysis_half_real_tm",
    "analysis_snapshots_half",
    "synthesis",
    "synthesis_half",
    "synthesis_half_real_tm",
    "synthesis_half_tm",
    "analysis_frames",
    "num_analysis_frames",
    "stft_analysis",
    "hermitian_mirror",
]


@dataclasses.dataclass(frozen=True)
class FilterbankParams:
    """Static filterbank configuration.

    Mirrors the parameter conventions of ``BaseFilterBank`` (modulated.cc:76-79):
    ``M`` subbands, prototype length ``N = M*m``, decimation ``R = 2**r``,
    frame shift ``D = M / R``.  ``delay_compensation_type`` selects the latency
    bookkeeping of modulated.cc:246-264.
    """

    M: int = 256
    m: int = 4
    r: int = 1
    delay_compensation_type: int = 2

    @property
    def R(self) -> int:
        return 1 << self.r

    @property
    def D(self) -> int:
        return self.M // self.R

    @property
    def N(self) -> int:
        return self.M * self.m

    @property
    def laN(self) -> int:
        """Frames skipped at stream start by the analysis bank (type 2)."""
        if self.delay_compensation_type == 2:
            return self.m * self.R // 2 - 1
        return 0

    @property
    def analysis_delay(self) -> int:
        """Zero frames padded at end of stream by the analysis bank."""
        if self.delay_compensation_type in (1, 2):
            return self.m * self.R - 1
        return 2 * self.m - 1

    @property
    def synthesis_delay(self) -> int:
        """Subband frames consumed to prime the synthesis bank."""
        if self.delay_compensation_type == 1:
            return self.m * self.R - 1
        if self.delay_compensation_type == 2:
            return self.m * self.R // 2
        return 2 * self.m - 1


def num_analysis_frames(params: FilterbankParams, num_samples: int) -> int:
    """Number of subband frames the analysis bank emits for ``num_samples``.

    The reference consumes ``ceil(T/D)`` zero-padded blocks
    (``SampleFeature::next`` pad_zeros branch, feature/feature.cc:626-640),
    skips ``laN`` at start and pads ``analysis_delay`` zero frames at the end
    (modulated.cc:440-466).
    """
    n_blocks = -(-num_samples // params.D)
    return n_blocks - params.laN + params.analysis_delay


def _pad_to_blocks(x: jax.Array, D: int) -> jax.Array:
    """Zero-pad the trailing (time) axis to a whole number of D-blocks."""
    T = x.shape[-1]
    n_blocks = -(-T // D)
    pad = n_blocks * D - T
    if pad:
        cfg = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
        x = jnp.pad(x, cfg)
    return x


def analysis_frames(x: jax.Array, params: FilterbankParams) -> jax.Array:
    """Extract the length-``N`` chronological sample window for every frame.

    ``x``: float array ``[..., T]``.  Returns ``[..., n_frames, N]`` where
    window ``t`` ends at sample ``(t + laN + 1) * D - 1`` of the zero-history
    stream (ring-buffer semantics of modulated.cc:363-373).

    Built from ``R*m`` static shifted slices of the block-reshaped signal —
    no gather, so XLA lowers it to cheap copies.
    """
    D, N = params.D, params.N
    x = _pad_to_blocks(x, D)
    lead = x.ndim - 1
    n_blocks = x.shape[-1] // D
    n_frames = n_blocks - params.laN + params.analysis_delay
    mR = params.m * params.R  # blocks per window

    # Stream with zero history (N - D zeros) and zero tail for padded frames.
    tail = (n_frames - 1 + params.laN) * D + N - (N - D + n_blocks * D)
    cfg = [(0, 0)] * lead + [(N - D, max(tail, 0))]
    xx = jnp.pad(x, cfg)
    blocks = xx.reshape(xx.shape[:-1] + (-1, D))  # [..., n_blocks', D]

    # window t spans blocks [t+laN, t+laN+mR) of xx  (start offset laN).
    segs = [
        jax.lax.slice_in_dim(blocks, params.laN + i, params.laN + i + n_frames, axis=lead)
        for i in range(mR)
    ]
    windows = jnp.stack(segs, axis=lead + 1)  # [..., n_frames, mR, D]
    return windows.reshape(windows.shape[:lead] + (n_frames, N))


@partial(jax.jit, static_argnums=(2,))
def _analysis_from_frames(windows: jax.Array, h: jax.Array, params: FilterbankParams) -> jax.Array:
    m, M = params.m, params.M
    prod = windows[..., ::-1] * h  # reversed window x prototype
    v = prod.reshape(prod.shape[:-1] + (m, M)).sum(axis=-2)
    # Unnormalized backward DFT (FFTW_BACKWARD / gsl radix2_backward,
    # modulated.cc:345-349,393-397).
    return jnp.fft.ifft(v, axis=-1) * M


def analysis(x: jax.Array, h: jax.Array, params: FilterbankParams) -> jax.Array:
    """Oversampled DFT analysis bank over a whole utterance.

    ``x``: float ``[..., T]`` (any leading batch/channel dims).
    ``h``: analysis prototype, float ``[N]``.
    Returns complex64 subband frames ``[..., n_frames, M]`` identical (up to
    float precision) to iterating ``OverSampledDFTAnalysisBank::next``.

    The polyphase FIR is evaluated as ``m`` shifted slices of the compact
    UNreversed push stream ``U [n_pushes, M]`` — O(T) HBM traffic, no
    ``[n_frames, N]`` window tensor and no lane-dimension reversal (an extra
    copy); the reference's time reversal + unnormalized backward
    DFT (modulated.cc:384-397) is folded into the DFT matrix / twiddle of
    `ops.dft.analysis_dft`.  In the matmul-DFT regime the FIR runs on the
    ``R`` block-parity halves of ``U`` separately and each half feeds its
    own slice of the DFT matrix, so ``U`` is never materialized at all.
    """
    if params.M <= dft.MATMUL_MAX_M:
        return _analysis_matmul(x, h, params, half=False)
    w = _polyphase_w(x, h, params)
    return dft.analysis_dft(w, params.M)


def analysis_half(x: jax.Array, h: jax.Array, params: FilterbankParams) -> jax.Array:
    """`analysis` restricted to bins ``0..M/2`` (``[..., n_frames, M//2+1]``).

    The polyphase FIR output is real, so the spectrum is hermitian — half the
    transform work and half the HBM traffic of `analysis` for consumers (all
    beamformers) that only read the lower half band (beamformer.cc:1142-1152).
    """
    if params.M <= dft.MATMUL_MAX_M:
        return _analysis_matmul(x, h, params, half=True)
    w = _polyphase_w(x, h, params)
    return dft.analysis_dft_half(w, params.M)


def _analysis_matmul(x: jax.Array, h: jax.Array, params: FilterbankParams, half: bool) -> jax.Array:
    Y = _analysis_matmul_real(x, h, params, half)
    F = params.M // 2 + 1 if half else params.M
    return jax.lax.complex(Y[..., :F], Y[..., F:])


def analysis_snapshots_half(x: jax.Array, h: jax.Array, params: FilterbankParams) -> jax.Array:
    """Analysis bank + snapshot transpose: ``x [..., C, T]`` ->
    ``X [..., n_frames, F, C]`` (``SnapShotArray::update``, beamformer.cc:62).

    In the matmul-DFT regime the channel->last transpose runs on the REAL
    [Re | Im] matmul output and the complex tensor is formed only at the very
    end, so the transpose moves one real tensor; the values are
    bit-identical to transposing the complex tensor.
    """
    F = params.M // 2 + 1
    if params.M <= dft.MATMUL_MAX_M:
        Yr = _analysis_matmul_real(x, h, params, half=True)  # [..., C, Tf, 2F]
        Yr = jnp.moveaxis(Yr, -3, -1)  # [..., Tf, 2F, C]
        return jax.lax.complex(Yr[..., :F, :], Yr[..., F:, :])
    sub = analysis_half(x, h, params)  # [..., C, Tf, F]
    return jnp.moveaxis(sub, -3, -1)


def _analysis_matmul_real(x: jax.Array, h: jax.Array, params: FilterbankParams, half: bool) -> jax.Array:
    """Analysis bank as block-parity FIRs + DFT matmuls, returning the
    real pair ``[..., n_frames, 2F]`` = ``[Re | Im]``.

    The push stream ``U [n_pushes, M]`` (see `_polyphase_w`) is the
    concatenation of ``R`` consecutive D-blocks, so lane group ``j`` of the
    FIR output depends only on blocks of parity offset ``j``:

        w_j[t] = sum_k h_rev[k, jD:(j+1)D] * blocks[laN + t + (m-1-k)R + j]

    and the DFT matmul splits as ``Y = sum_j w_j @ A[jD:(j+1)D]`` — the
    ``[n_frames, M]`` FIR tensor is never concatenated in HBM.  Same math as
    `_polyphase_w` + `ops.dft.analysis_dft(_half)` (modulated.cc:375-409).
    """
    h = jnp.asarray(h)
    if h.shape != (params.N,):
        raise ValueError(
            f"analysis prototype must have length N=M*m={params.N}, got {h.shape}"
        )
    p = params
    D, M, m, R = p.D, p.M, p.m, p.R
    h_rev = h.astype(x.dtype).reshape(m, M)[:, ::-1]
    A = jnp.asarray(dft._analysis_matrix(M, half=half))

    x = _pad_to_blocks(x, D)
    lead = x.ndim - 1
    n_blocks = x.shape[-1] // D
    n_frames = n_blocks - p.laN + p.analysis_delay
    mR = m * R
    front = mR - 1
    tail = n_frames - 1 + p.laN + mR - (front + n_blocks)
    cfg = [(0, 0)] * lead + [(front * D, max(tail, 0) * D)]
    xx = jnp.pad(x, cfg)
    blocks = xx.reshape(xx.shape[:-1] + (-1, D))  # [..., n_blocks', D]

    Y = None
    for j in range(R):
        w_j = sum(
            h_rev[k, j * D : (j + 1) * D]
            * jax.lax.slice_in_dim(
                blocks,
                p.laN + (m - 1 - k) * R + j,
                p.laN + (m - 1 - k) * R + j + n_frames,
                axis=lead,
            )
            for k in range(m)
        )
        term = jnp.matmul(w_j, A[j * D : (j + 1) * D], precision=dft._PREC)
        Y = term if Y is None else Y + term
    return Y


def analysis_half_real_tm(
    x: jax.Array, h: jax.Array, params: FilterbankParams, packed: bool = False
) -> jax.Array:
    """Time-major half-band analysis, raw real output: ``x [..., T]`` ->
    ``Yr [n_frames, ..., 2F]`` (``[Re | Im]`` lanes, bins 0..M/2).

    Same math as `_analysis_matmul_real` (same operands, same accumulation
    order), but the frame axis leads: the output feeds `lax.scan`-based
    consumers directly, with no ``[.., T, ..]`` -> ``[T, ..]`` transpose in
    HBM (the scan would otherwise materialize one) and no snapshot transpose
    — the per-step complex snapshot is formed by the consumer
    (`models.adaptive_gsc.gsc_postfilter_fused(real_packed=True)`).
    Requires the matmul-DFT regime (``M <= dft.MATMUL_MAX_M``).

    ``packed=True`` drops the structurally-zero Im(DC)/Im(Nyquist) lanes
    (see `ops.dft._analysis_matrix_packed`): output ``[n_frames, ..., M]``
    — a square matmul, no ragged 2F lane padding.  Bit-identical values.
    """
    h = jnp.asarray(h)
    if h.shape != (params.N,):
        raise ValueError(
            f"analysis prototype must have length N=M*m={params.N}, got {h.shape}"
        )
    if params.M > dft.MATMUL_MAX_M:
        raise ValueError("analysis_half_real_tm requires the DFT-matmul regime")
    p = params
    D, M, m, R = p.D, p.M, p.m, p.R
    h_rev = h.astype(x.dtype).reshape(m, M)[:, ::-1]
    A = jnp.asarray(
        dft._analysis_matrix_packed(M) if packed else dft._analysis_matrix(M, half=True)
    )

    x = _pad_to_blocks(x, D)
    n_blocks = x.shape[-1] // D
    n_frames = n_blocks - p.laN + p.analysis_delay
    mR = m * R
    front = mR - 1
    tail = n_frames - 1 + p.laN + mR - (front + n_blocks)
    cfg = [(0, 0)] * (x.ndim - 1) + [(front * D, max(tail, 0) * D)]
    xx = jnp.pad(x, cfg)
    blocks = xx.reshape(xx.shape[:-1] + (-1, D))  # [..., n_blocks', D]
    blocks = jnp.moveaxis(blocks, -2, 0)  # [n_blocks', ..., D] time-major

    Y = None
    for j in range(R):
        w_j = sum(
            h_rev[k, j * D : (j + 1) * D]
            * jax.lax.slice_in_dim(
                blocks,
                p.laN + (m - 1 - k) * R + j,
                p.laN + (m - 1 - k) * R + j + n_frames,
                axis=0,
            )
            for k in range(m)
        )
        term = jnp.matmul(w_j, A[j * D : (j + 1) * D], precision=dft._PREC)
        Y = term if Y is None else Y + term
    return Y  # [n_frames, ..., 2F]


@partial(jax.jit, static_argnums=(2,))
def synthesis_half_tm(Y_half: jax.Array, g: jax.Array, params: FilterbankParams) -> jax.Array:
    """Time-major `synthesis_half`: ``Y_half [T_in, ..., M//2+1]`` complex ->
    samples ``[..., (T_in - synthesis_delay) * D]``.

    Identical math to `synthesis_half` with the frame axis leading — pairs
    with `analysis_half_real_tm` / scan outputs so the whole pipeline stays
    time-major and no ``[T, ..]`` -> ``[.., T]`` transpose of the subband
    tensor is needed (only the final small ``[T_out, ..., D]`` output moves).
    """
    M, R = params.M, params.R
    pre_reversed = M <= dft.MATMUL_MAX_M
    if pre_reversed:
        # segment sample reversal baked into the matrix (no lane shuffle)
        perm = dft.segment_reversal_perm(M, R)
        c = dft.synthesis_dft_half(Y_half, M, perm=perm)  # [T_in, ..., M]
    else:
        c = dft.synthesis_dft_half(Y_half, M)
    return _synthesis_from_c_tm(c, g, params, pre_reversed)


@partial(jax.jit, static_argnums=(2,))
def synthesis_half_real_tm(Yp: jax.Array, g: jax.Array, params: FilterbankParams) -> jax.Array:
    """`synthesis_half_tm` consuming the packed real spectrum
    ``[T_in, ..., M]`` (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes, the layout
    `analysis_half_real_tm(packed=True)` / the fused scans emit).

    No complex split/concat and a square [M, M] matmul; the discarded
    Im(DC)/Im(Nyquist) inputs are exactly the parts ``Re(fft(mirror(Y)))``
    ignores (zero rows of the synthesis matrix) — bit-identical output.
    Requires the matmul-DFT regime.
    """
    M, R = params.M, params.R
    if M > dft.MATMUL_MAX_M:
        raise ValueError("synthesis_half_real_tm requires the DFT-matmul regime")
    perm = dft.segment_reversal_perm(M, R)
    c = dft.synthesis_dft_half_packed(Yp, M, perm=perm)  # [T_in, ..., M]
    return _synthesis_from_c_tm(c, g, params, pre_reversed=True)


def _synthesis_from_c_tm(
    c: jax.Array, g: jax.Array, params: FilterbankParams, pre_reversed: bool
) -> jax.Array:
    """Time-major polyphase + overlap-add tail shared by `synthesis_half_tm`
    and `synthesis_half_real_tm` (see `_synthesis_from_c` for the batch
    layout and the pre_reversed contract)."""
    M, m, R, D = params.M, params.m, params.R, params.D
    pd = params.synthesis_delay
    T_in = c.shape[0]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")

    gf = jnp.asarray(g, c.dtype).reshape(m, M)[:, ::-1]  # [m, M]
    if pre_reversed:
        gf = gf[:, np.asarray(dft.segment_reversal_perm(M, R))]
    cfg = [((m - 1) * R, 0)] + [(0, 0)] * (c.ndim - 1)
    cp = jnp.pad(c, cfg)
    s = sum(
        gf[k] * jax.lax.slice_in_dim(cp, pd + (m - 1 - k) * R, pd + (m - 1 - k) * R + T_out, axis=0)
        for k in range(m)
    )  # [T_out, ..., M]

    cfg = [(R - 1, 0)] + [(0, 0)] * (s.ndim - 1)
    sp = jnp.pad(s, cfg)
    seg = sp.reshape(sp.shape[:-1] + (R, D))
    if not pre_reversed:
        seg = seg[..., ::-1]
    out = sum(
        jax.lax.slice_in_dim(seg, R - 1 - j, R - 1 - j + T_out, axis=0)[..., R - 1 - j, :]
        for j in range(R)
    )  # [T_out, ..., D]
    out = jnp.moveaxis(out, 0, -2)  # [..., T_out, D]
    return out.reshape(out.shape[:-2] + (T_out * D,))


def _polyphase_w(x: jax.Array, h: jax.Array, params: FilterbankParams) -> jax.Array:
    """Polyphase FIR stage of the analysis bank on the unreversed push
    stream: real ``w [..., n_frames, M]`` with ``w[t, i] = v[t, M-1-i]``
    (``v`` being the reference's reversed-window FIR output); the reversal
    is absorbed by `ops.dft.analysis_dft(_half)`."""
    h = jnp.asarray(h)
    if h.shape != (params.N,):
        raise ValueError(
            f"analysis prototype must have length N=M*m={params.N}, got {h.shape}"
        )
    p = params
    D, M, m, R = p.D, p.M, p.m, p.R
    h = h.astype(x.dtype)

    x = _pad_to_blocks(x, D)
    lead = x.ndim - 1
    n_blocks = x.shape[-1] // D
    n_frames = n_blocks - p.laN + p.analysis_delay
    mR = m * R
    front = mR - 1
    tail = n_frames - 1 + p.laN + mR - (front + n_blocks)
    cfg = [(0, 0)] * lead + [(front * D, max(tail, 0) * D)]
    xx = jnp.pad(x, cfg)
    blocks = xx.reshape(xx.shape[:-1] + (-1, D))  # [..., n_blocks', D]

    # Unreversed push stream U[t', i] = xx[t' D + i]; the reference's
    # reversed ring-buffer window is S[t', i] = U[t', M-1-i]
    # (RealBuffer_::nextSampleBlock push semantics, modulated.cc:363-373).
    n = blocks.shape[lead] - (R - 1)
    segs = [jax.lax.slice_in_dim(blocks, j, j + n, axis=lead) for j in range(R)]
    win = jnp.stack(segs, axis=lead + 1)
    U = win.reshape(win.shape[:lead] + (n, M))

    # v[t, mi] = sum_k h[mi + M k] * S[laN + t + (m-1-k) R, mi]
    # (polyphase loop, modulated.cc:384-391); on the unreversed stream this
    # is w[t, i] = sum_k h_rev[k, i] * U[laN + t + (m-1-k) R, i] with
    # h_rev[k, i] = h[(M-1-i) + M k] and w[t] = reverse(v[t]).
    hist = (m - 1) * R
    slab = jax.lax.slice_in_dim(U, p.laN, p.laN + n_frames + hist, axis=lead)
    h_rev = h.reshape(m, M)[:, ::-1]
    return sum(
        h_rev[k]
        * jax.lax.slice_in_dim(
            slab, (m - 1 - k) * R, (m - 1 - k) * R + n_frames, axis=lead
        )
        for k in range(m)
    )


@partial(jax.jit, static_argnums=(2,))
def synthesis(Y: jax.Array, g: jax.Array, params: FilterbankParams) -> jax.Array:
    """Oversampled DFT synthesis bank over a whole utterance.

    ``Y``: complex subband frames ``[..., T_in, M]``.
    ``g``: synthesis prototype, float ``[N]``.
    Returns float samples ``[..., (T_in - synthesis_delay) * D]``, matching
    the stream of ``OverSampledDFTSynthesisBank::next`` outputs (priming per
    modulated.cc:574-578, polyphase + overlap-add per modulated.cc:594-606).
    """
    # Forward unnormalized DFT, real part (modulated.cc:556-563).  In the
    # matmul regime the overlap-add's per-segment sample reversal is baked
    # into the matrix columns (see `_synthesis_from_c`).
    if params.M <= dft.MATMUL_MAX_M:
        perm = dft.segment_reversal_perm(params.M, params.R)
        c = dft.synthesis_dft(Y, params.M, perm=perm)
        return _synthesis_from_c(c, g, params, pre_reversed=True)
    c = dft.synthesis_dft(Y, params.M)  # [..., T_in, M]
    return _synthesis_from_c(c, g, params)


@partial(jax.jit, static_argnums=(2,))
def synthesis_half(Y_half: jax.Array, g: jax.Array, params: FilterbankParams) -> jax.Array:
    """`synthesis` fed with only bins ``0..M/2`` (``[..., T_in, M//2+1]``).

    Equals ``synthesis(hermitian_mirror(Y_half, M), g, params)`` exactly: the
    reference takes ``Re(fft(Y))`` of the conjugate-mirrored spectrum
    (modulated.cc:556-563), which is ``M * irfft(conj(Y_half))`` — half the
    FFT work, and the mirrored full-M spectrum is never materialized.
    (`Re()` drops imaginary DC/Nyquist parts in both formulations.)
    """
    if params.M <= dft.MATMUL_MAX_M:
        perm = dft.segment_reversal_perm(params.M, params.R)
        c = dft.synthesis_dft_half(Y_half, params.M, perm=perm)
        return _synthesis_from_c(c, g, params, pre_reversed=True)
    c = dft.synthesis_dft_half(Y_half, params.M)
    return _synthesis_from_c(c, g, params)


def _synthesis_from_c(
    c: jax.Array, g: jax.Array, params: FilterbankParams, pre_reversed: bool = False
) -> jax.Array:
    """Polyphase + overlap-add stage of the synthesis bank (real ``c [..., T_in, M]``).

    With ``pre_reversed=True``, ``c`` arrives with each D-sample segment
    already sample-reversed (`dft.segment_reversal_perm` baked into the DFT
    matrix) so the overlap-add needs no lane reversal (an extra copy); the
    prototype columns are permuted to match.
    """
    M, m, R, D = params.M, params.m, params.R, params.D
    pd = params.synthesis_delay
    T_in = c.shape[-2]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")
    lead = c.ndim - 2

    # Polyphase FIR over pushed frames: s_t[mi] = sum_k gf[k, mi] * c[t'-Rk, mi]
    # with gf[k, mi] = g[(M-1-mi) + M k]  (modulated.cc:594-598).
    gf = jnp.asarray(g, c.dtype).reshape(m, M)[:, ::-1]  # [m, M]
    if pre_reversed:
        gf = gf[:, np.asarray(dft.segment_reversal_perm(M, R))]
    # Zero history of (m-1)*R pushes (buffer_ starts zeroed).
    cfg = [(0, 0)] * lead + [((m - 1) * R, 0), (0, 0)]
    cp = jnp.pad(c, cfg)
    # Push index of output t is t' = t + pd; in padded coords t' + (m-1)R.
    # s over t = 0..T_out-1 : sum_k gf[k] * cp[t + pd + (m-1)R - Rk]
    s = sum(
        gf[k] * jax.lax.slice_in_dim(cp, pd + (m - 1 - k) * R, pd + (m - 1 - k) * R + T_out, axis=lead)
        for k in range(m)
    )  # [..., T_out, M]

    # Overlap-add of R reversed segments (modulated.cc:603-606):
    # out_t[i] = sum_j s_{t-j}[(R-1-j)*D + (D-1-i)]
    cfg = [(0, 0)] * lead + [(R - 1, 0), (0, 0)]
    sp = jnp.pad(s, cfg)
    seg = sp.reshape(sp.shape[:-1] + (R, D))  # [..., T_out+R-1, R, D]
    if not pre_reversed:
        seg = seg[..., ::-1]  # sample reversal within each segment
    out = sum(
        jax.lax.slice_in_dim(seg, R - 1 - j, R - 1 - j + T_out, axis=lead)[..., R - 1 - j, :]
        for j in range(R)
    )  # [..., T_out, D]
    return out.reshape(out.shape[:lead] + (T_out * D,))


def stft_analysis(x: jax.Array, M: int, r: int = 1, window_type: int = 1) -> jax.Array:
    """Plain windowed STFT as a stream (``NormalFFTAnalysisBank``, modulated.cc:96-227).

    Window types: 0 rect, 1 Hamming, 2 Hann (get_window, modulated.cc:47-72).
    Forward unnormalized DFT of the windowed, time-reversed last-M samples.
    Returns ``[..., n_frames, M]`` complex.
    """
    from .windows import get_window

    params = FilterbankParams(M=M, m=1, r=r, delay_compensation_type=0)
    windows = analysis_frames(x, params)  # [..., n_frames, M] chronological
    win = jnp.asarray(get_window(window_type, M), x.dtype)
    # output_[mi] = win[mi] * buffer(0, M-1-mi): the ring stores the window
    # REVERSED (update_buf_ nextSample(reverse=true), modulated.cc:158-168)
    # and the read index M-1-mi un-reverses it, so the windowed vector is the
    # plain CHRONOLOGICAL last-M samples — verified against the compiled
    # reference (tests/test_cpp_golden.py; round 1 mis-read this as reversed).
    v = windows * win
    return jnp.fft.fft(v, axis=-1)


def hermitian_mirror(half: jax.Array, M: int) -> jax.Array:
    """Expand bins ``0..M/2`` to all ``M`` bins by conjugate symmetry.

    The reference computes beamformer outputs only for bins ``0..M/2`` and
    mirrors the conjugates into ``M/2+1..M-1`` (beamformer.cc:1142-1152).
    ``half``: ``[..., M//2+1]`` complex -> ``[..., M]``.
    """
    mirror = jnp.conj(half[..., 1 : M // 2])[..., ::-1]
    return jnp.concatenate([half, mirror], axis=-1)
