"""Filterbank equivalence + reconstruction tests.

Golden: the frame-by-frame numpy simulator in reference_stream.py, which
replicates modulated/modulated.cc ring-buffer semantics exactly.
"""

import numpy as np
import pytest

from distant_speech_recognition_tpu.ops.filterbank import (
    FilterbankParams,
    analysis,
    synthesis,
    num_analysis_frames,
    stft_analysis,
)
from distant_speech_recognition_tpu.utils.prototypes import load_pair
from distant_speech_recognition_tpu.utils.wavio import read_wav

from reference_stream import StreamAnalysis, StreamSynthesis

CONFIGS = [
    # (M, m, r, delay_comp)
    (8, 4, 1, 2),
    (8, 2, 0, 2),
    (16, 4, 2, 2),
    (8, 4, 1, 1),
    (8, 4, 1, 0),
]


def _rand_proto(M, m, rng):
    return rng.standard_normal(M * m) * 0.1


@pytest.mark.parametrize("M,m,r,dc", CONFIGS)
def test_analysis_matches_stream(M, m, r, dc, rng):
    params = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc)
    h = _rand_proto(M, m, rng)
    T = params.D * 13 + 5  # partial final block exercises zero-padding
    x = rng.standard_normal(T)

    golden = StreamAnalysis(h, M, m, r, dc).run(x)
    ours = np.asarray(analysis(x.astype(np.float32), h, params))

    assert ours.shape == golden.shape, (ours.shape, golden.shape)
    assert golden.shape[0] == num_analysis_frames(params, T)
    np.testing.assert_allclose(ours, golden, atol=5e-5)


@pytest.mark.parametrize("M,m,r,dc", CONFIGS)
def test_synthesis_matches_stream(M, m, r, dc, rng):
    params = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc)
    g = _rand_proto(M, m, rng)
    T_in = 23
    # hermitian-symmetric random subband input (as a real pipeline produces)
    spec = rng.standard_normal((T_in, M)) + 1j * rng.standard_normal((T_in, M))

    golden = StreamSynthesis(g, M, m, r, dc).run(spec)
    ours = np.asarray(synthesis(spec.astype(np.complex64), g, params))

    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, atol=5e-4)


def test_analysis_batched_channels(rng):
    """Leading batch/channel dims vmap-free broadcast."""
    params = FilterbankParams(M=8, m=4, r=1)
    h = _rand_proto(8, 4, rng)
    x = rng.standard_normal((2, 3, 200)).astype(np.float32)
    out = np.asarray(analysis(x, h, params))
    single = np.asarray(analysis(x[1, 2], h, params))
    np.testing.assert_allclose(out[1, 2], single, atol=1e-6)


def test_reconstruction_shipped_prototypes():
    """End-to-end analysis->synthesis with the reference's shipped M=256
    Nyquist prototypes reconstructs real speech nearly perfectly — the
    reference's own acceptance check (tools/filterbank/test_oversampled_dft_filter.py)."""
    M, m, r = 256, 4, 1
    h, g = load_pair(M, m, r)
    params = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)

    x, rate = read_wav("/root/reference/btk20_src/unit_test/data/speech_at_20sec.wav")
    x = x[0, : rate * 2]  # 2 seconds

    Y = analysis(x, h, params)
    y = np.asarray(synthesis(Y, g, params))

    n = min(len(x), len(y))
    # Skip the filter startup/teardown transient (~N samples); steady-state
    # error is the Nyquist(M) design's aliasing floor (~-55 dB).
    seg = slice(2 * params.N, n - 2 * params.N)
    err = y[:n][seg] - x[:n][seg]
    rmse = np.sqrt(np.mean(err**2))
    ref_rms = np.sqrt(np.mean(x[:n][seg] ** 2))
    assert rmse / ref_rms < 5e-3, (rmse, ref_rms)


def test_stft_analysis_shape(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    out = np.asarray(stft_analysis(x, M=64, r=1, window_type=1))
    params = FilterbankParams(M=64, m=1, r=1, delay_compensation_type=0)
    assert out.shape == (num_analysis_frames(params, 1000), 64)
    # hermitian symmetry of a real windowed frame's DFT
    np.testing.assert_allclose(out[5, 1:], np.conj(out[5, 1:][::-1]), atol=1e-3)


@pytest.mark.parametrize("M,m,r,dc", CONFIGS)
def test_analysis_half_matches_full(M, m, r, dc, rng):
    """analysis_half == analysis restricted to bins 0..M/2 (rfft identity)."""
    from distant_speech_recognition_tpu.ops.filterbank import analysis_half

    params = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc)
    h = _rand_proto(M, m, rng)
    x = rng.standard_normal((2, params.D * 11 + 3)).astype(np.float32)
    full = np.asarray(analysis(x, h, params))
    half = np.asarray(analysis_half(x, h, params))
    np.testing.assert_allclose(half, full[..., : M // 2 + 1], atol=1e-5)


@pytest.mark.parametrize("M,m,r,dc", CONFIGS)
def test_synthesis_half_matches_full(M, m, r, dc, rng):
    """synthesis_half(Y_half) == synthesis(hermitian_mirror(Y_half)) including
    complex DC/Nyquist bins (whose imaginary parts both paths drop via Re())."""
    from distant_speech_recognition_tpu.ops.filterbank import (
        hermitian_mirror,
        synthesis_half,
    )

    params = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc)
    g = _rand_proto(M, m, rng)
    T_in = 23
    Yh = (
        rng.standard_normal((T_in, M // 2 + 1))
        + 1j * rng.standard_normal((T_in, M // 2 + 1))
    ).astype(np.complex64)
    want = np.asarray(synthesis(np.asarray(hermitian_mirror(Yh, M)), g, params))
    got = np.asarray(synthesis_half(Yh, g, params))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_frame_energy_half_matches_full(rng):
    from distant_speech_recognition_tpu.models.beamforming import (
        frame_energy,
        frame_energy_half,
    )

    M = 16
    sub = (rng.standard_normal((7, M)) @ np.exp(
        -2j * np.pi * np.outer(np.arange(M), np.arange(M)) / M
    )).astype(np.complex64)  # hermitian spectra of real frames
    want = np.asarray(frame_energy(sub))
    got = np.asarray(frame_energy_half(sub[..., : M // 2 + 1], M))
    np.testing.assert_allclose(got, want, rtol=1e-5)
