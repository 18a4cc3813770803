"""Round-3 compiled-golden tests for the long-tail subsystems.

Same contract as tests/test_cpp_golden.py (allclose vs the UNMODIFIED
reference C++ compiled against the GSL shim), extended to: the MFCC feature
chain (feature/feature.cc), CCTDE (tde/tde.cc), the GCC weighting family
(localization/localization.cc), the spectral-subtraction chain
(postfilter/spectralsubtraction.cc), and OverlapAdd/OverlapSave
(convolution/convolution.cc).

FastBlockLMSFeature (lms/lms.cc) has NO golden here by documented
impossibility: the shipped class segfaults on construction (NULL
impulse-response dereference in OverlapSave's initializer list,
convolution.cc:146-148) — see the note in golden_tail.cc and PARITY.md.
"""

import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/btk20_src"
TBIN = os.path.join(REPO, "reference_golden", "build", "golden_tail")
DATA = os.path.join(REF, "unit_test", "data")

FS = 16000.0

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference tree not available"
)


@pytest.fixture(scope="module")
def tbin():
    if not os.path.exists(TBIN):
        r = subprocess.run(
            [os.path.join(REPO, "reference_golden", "build.sh")],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            pytest.skip(f"golden generator build failed: {r.stderr[-800:]}")
    return TBIN


@pytest.fixture(scope="module")
def speech(tmp_path_factory):
    """First 4 s of the mono speech fixture + f32 dump."""
    from distant_speech_recognition_tpu.utils.wavio import read_wav

    d = tmp_path_factory.mktemp("speech")
    x, _ = read_wav(f"{DATA}/speech_at_20sec.wav")
    # the fixture's speech starts ~20 s in; the head is silence
    x = x[0][20 * 16000 : 24 * 16000].astype(np.float32)
    p = str(d / "speech.f32")
    x.tofile(p)
    return x, p


@pytest.fixture(scope="module")
def cmu2(tmp_path_factory):
    """Two channels of the CMU Kinect utterance (for TDE) + f32 dumps."""
    from distant_speech_recognition_tpu.utils.wavio import read_wav

    d = tmp_path_factory.mktemp("cmu2")
    chans, paths = [], []
    for c in (1, 4):
        x, _ = read_wav(
            f"{DATA}/CMU/R1/M1005/KINECT/RAW/segmented/U1001_1M_16k_b16_c{c}.wav"
        )
        chans.append(x[0][:48000].astype(np.float32))
    T = min(len(c) for c in chans)
    chans = [c[:T] for c in chans]
    for i, c in enumerate(chans):
        p = str(d / f"ch{i}.f32")
        c.tofile(p)
        paths.append(p)
    return chans, paths


def test_mfcc_chain_matches_cpp(tbin, speech, tmp_path):
    """SampleFeature -> Hamming -> FFT -> SpectralPower -> Mel -> Log ->
    Cepstral vs the batched chain (models/features.py)."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat

    x, path = speech
    D, fftlen, ncep, meln = 160, 256, 13, 30
    pown = fftlen // 2 + 1
    low, up = 100.0, 6800.0
    ceps_f = str(tmp_path / "ceps.f32")
    logmel_f = str(tmp_path / "logmel.f32")
    subprocess.run(
        [tbin, "mfcc", str(D), str(fftlen), str(pown), str(meln), str(low),
         str(up), str(ncep), str(int(FS)), path, ceps_f, logmel_f],
        check=True, capture_output=True,
    )
    ceps_cpp = np.fromfile(ceps_f, np.float32).reshape(-1, ncep)
    logmel_cpp = np.fromfile(logmel_f, np.float32).reshape(-1, meln)

    frames = feat.frame_signal(jnp.asarray(x), D, D)
    w = feat.hamming_window(frames)
    spec = jnp.fft.rfft(w, n=fftlen, axis=-1)
    power = feat.spectral_power(spec, pown)
    mel = feat.mel_feature(power, feat.mel_matrix(pown, FS, low, up, meln))
    logmel = feat.log_feature(mel)
    ceps = np.asarray(feat.cepstral_feature(logmel, ncep, dct_type=1))

    n = min(len(ceps), len(ceps_cpp))
    assert n >= len(ceps_cpp) - 1  # reference may emit one fewer tail frame
    scale = np.abs(logmel_cpp).max()
    np.testing.assert_allclose(
        np.asarray(logmel)[:n], logmel_cpp[:n], atol=2e-4 * scale
    )
    scale = np.abs(ceps_cpp).max()
    np.testing.assert_allclose(ceps[:n], ceps_cpp[:n], atol=3e-4 * scale)


def test_cctde_matches_cpp(tbin, cmu2, tmp_path):
    """compat CCTDE per-frame peaks vs the compiled reference."""
    from distant_speech_recognition_tpu.compat.feature import SampleFeature
    from distant_speech_recognition_tpu.compat.tde import CCTDE

    chans, paths = cmu2
    D, nheld = 512, 3
    out = str(tmp_path / "tde.f64")
    subprocess.run(
        [tbin, "cctde", "512", str(nheld), str(D), paths[0], paths[1], out],
        check=True, capture_output=True,
    )
    rows = np.fromfile(out, np.float64).reshape(-1, nheld, 2)

    s1 = SampleFeature(D, D)
    s1.set_samples(chans[0], int(FS))
    s2 = SampleFeature(D, D)
    s2.set_samples(chans[1], int(FS))
    tde = CCTDE(s1, s2, 512, nheld)
    got_delays, got_ccs = [], []
    while True:
        try:
            tde.next()
        except StopIteration:
            break
        got_delays.append(np.array(tde.sample_delays(), np.float64))
        got_ccs.append(np.array(tde.cc_values()))
    got_delays = np.stack(got_delays)
    got_ccs = np.stack(got_ccs)

    n = min(len(rows), len(got_delays))
    assert n >= len(rows) - 1
    np.testing.assert_array_equal(got_delays[:n], rows[:n, :, 0])
    np.testing.assert_allclose(got_ccs[:n], rows[:n, :, 1], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize(
    "kind,mode",
    [
        ("raw", "raw"),
        ("gnnsub", "gnn_sub"),
        ("phat", "phat"),
        ("gnnsubphat", "gnn_sub_phat"),
        ("mlrraw", "mlr_raw"),
        ("mlrgnnsub", "mlr_gnn_sub"),
    ],
)
def test_gcc_family_matches_cpp(tbin, cmu2, kind, mode, tmp_path):
    """GCC weighting family: per-frame [delay, maxcorr] vs compiled C++."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat
    from distant_speech_recognition_tpu.models.localization import (
        find_cc_peak,
        gcc_weighted,
    )

    from distant_speech_recognition_tpu.models.localization import noise_spectra

    chans, paths = cmu2
    fftlen, D = 512, 512
    alpha, beta, q = 0.95, 0.5, 0.3
    # kinds that read the noise statistics need them initialized (the
    # reference NULL-derefs otherwise); train them on the first noiseN frames
    noiseN = 20 if mode in ("gnn_sub", "gnn_sub_phat", "mlr_raw", "mlr_gnn_sub") else 0
    out = str(tmp_path / "gcc.f64")
    subprocess.run(
        [tbin, "gcc", kind, str(fftlen), str(D), str(int(FS)), str(alpha),
         str(beta), str(q), "1", "1", str(noiseN), paths[0], paths[1], out],
        check=True, capture_output=True,
    )
    rows = np.fromfile(out, np.float64).reshape(-1, 3)

    X = []
    for c in chans:
        frames = feat.frame_signal(jnp.asarray(c), D, D)
        w = feat.hamming_window(frames)
        X.append(jnp.fft.rfft(w, n=fftlen, axis=-1))
    kw = {}
    if noiseN:
        # Reference quirk: NoisePowerSpectrum dedupes adds by timestamp and
        # initializes its timestamp to 0.0 (localization.cc:1136-1141), so
        # the frame-0 add (timestamp 0.0) is silently SKIPPED for the power
        # spectra; NoiseCrossSpectrum has no timestamp and keeps frame 0.
        _, _, Gn1n2 = noise_spectra(
            X[0][:noiseN], X[1][:noiseN], np.ones(noiseN, bool), alpha=alpha
        )
        N1, N2, _ = noise_spectra(
            X[0][1:noiseN], X[1][1:noiseN], np.ones(noiseN - 1, bool), alpha=alpha
        )
        if mode in ("gnn_sub", "gnn_sub_phat", "mlr_gnn_sub"):
            kw["Gn1n2"] = Gn1n2
        if mode in ("mlr_raw", "mlr_gnn_sub"):
            kw["N1"] = N1
            kw["N2"] = N2
    Xa, Xb = X[0][noiseN:], X[1][noiseN:]
    cc = gcc_weighted(Xa, Xb, fftlen, mode=mode, q=q, smooth_beta=beta, **kw)
    delay, peak = find_cc_peak(cc, FS, interpolate=True)
    delay, peak = np.asarray(delay, np.float64), np.asarray(peak, np.float64)

    n = min(len(rows), len(delay))
    assert n >= len(rows) - 1
    scale = np.abs(rows[:n, 1]).max()
    # MLR weights form 4th-power products (X1^2 X2^2): a bit more float32
    # rounding than the other kinds — exact semantics verified below in f64
    peak_tol = 2e-3 * scale if mode.startswith("mlr") else 1e-4 * scale
    delay_tol = 1e-5 if mode.startswith("mlr") else 2e-6
    np.testing.assert_allclose(peak[:n], rows[:n, 1], atol=peak_tol)
    # delays: same peak bin required; interpolated offset agrees closely
    np.testing.assert_allclose(delay[:n], rows[:n, 0], atol=delay_tol)

    if mode.startswith("mlr"):
        # float64 semantic check of the same weighting, tight tolerance
        X1 = np.asarray(Xa, np.complex128)
        X2 = np.asarray(Xb, np.complex128)
        cross = X1 * np.conj(X2)
        X12 = np.abs(X1) ** 2
        X22 = np.abs(X2) ** 2
        q1, q2 = 1.0 - q, 2.0 * q
        N1d = np.asarray(kw["N1"], np.float64) if "N1" in kw else 0.0
        N2d = np.asarray(kw["N2"], np.float64) if "N2" in kw else 0.0
        den = q2 * X12 * X22 + q1 * (N2d * X12 + N1d * X22)
        w = np.sqrt(X12 * X22) / np.maximum(den, 1e-300)
        num = cross
        if mode == "mlr_gnn_sub" and "Gn1n2" in kw:
            num = cross - np.asarray(kw["Gn1n2"], np.complex128)
        G = num * w
        sm = np.zeros_like(G[0])
        out64 = np.empty_like(G)
        for t in range(len(G)):
            sm = beta * sm + (1 - beta) * G[t]
            out64[t] = sm
        cc64 = np.fft.irfft(out64, n=fftlen, axis=-1)
        peak64 = cc64.max(axis=-1)
        np.testing.assert_allclose(peak64[:n], rows[:n, 1], rtol=1e-6)


def test_spectral_subtraction_matches_cpp(tbin, speech, tmp_path):
    """Analysis -> SpectralSubtractor (trainN frames of noise stats, then
    subtraction) -> synthesis vs the batched chain."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.postfilter import (
        average_noise_psd,
        spectral_subtract,
    )
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    M, m_, r_, DC = 256, 4, 1, 2
    D = M >> r_
    F = M // 2 + 1
    alpha, floorv, trainN = -1.0, 0.001, 50
    x, path = speech

    h, g = load_pair(M, m_, r_)
    d = tmp_path
    hf, gf = str(d / "h.f64"), str(d / "g.f64")
    np.asarray(h, np.float64).tofile(hf)
    np.asarray(g, np.float64).tofile(gf)
    out = str(d / "ss.f32")
    subprocess.run(
        [tbin, "specsub", hf, gf, str(M), str(m_), str(r_), str(DC),
         str(alpha), str(floorv), str(trainN), path, out],
        check=True, capture_output=True,
    )
    ycpp = np.fromfile(out, np.float32)

    p = ops.FilterbankParams(M=M, m=m_, r=r_, delay_compensation_type=DC)
    Y = ops.analysis(jnp.asarray(x), h, p)  # [T, M] full band
    Yh = Y[:, :F]
    # The driver flips training off after SYNTHESIS frame trainN; by then the
    # subtractor has consumed analysis frames 0..trainN+synthesis_delay
    # (the synthesis bank primes synthesis_delay subband frames,
    # modulated.cc:574-578), so the effective noise-average window is
    # trainN + synthesis_delay + 1 analysis frames.
    trainN_eff = trainN + p.synthesis_delay + 1
    npsd = average_noise_psd(Yh[:trainN_eff], alpha=alpha)
    sub = spectral_subtract(Yh, npsd, ft=1.0, flooring=floorv)
    # training frames pass through unsubtracted (start_noise_subtraction
    # stays false until then)
    Yout_h = jnp.concatenate([Yh[:trainN_eff], sub[trainN_eff:]], axis=0)
    Yfull = ops.hermitian_mirror(Yout_h, M)
    yj = np.asarray(ops.synthesis(Yfull, g, p))

    n = min(len(ycpp), len(yj))
    err = ycpp[:n] - yj[:n]
    snr = 10 * np.log10((ycpp[:n] ** 2).mean() / max((err**2).mean(), 1e-30))
    assert snr > 60, snr


def test_overlap_add_matches_cpp(tbin, speech, tmp_path):
    from distant_speech_recognition_tpu.models.lti import overlap_add_filter
    import jax.numpy as jnp

    x, path = speech
    rng = np.random.default_rng(7)
    P, L, fftlen = 64, 256, 512
    ir = rng.standard_normal(P)
    irf = str(tmp_path / "ir.f64")
    ir.astype(np.float64).tofile(irf)
    out = str(tmp_path / "oa.f32")
    subprocess.run(
        [tbin, "oadd", str(P), str(fftlen), str(L), irf, path, out],
        check=True, capture_output=True,
    )
    ycpp = np.fromfile(out, np.float32)
    yj = np.asarray(
        overlap_add_filter(jnp.asarray(x, jnp.float64), jnp.asarray(ir), fftlen)
    )
    n = min(len(ycpp), len(yj))
    scale = np.abs(ycpp).max()
    np.testing.assert_allclose(yj[:n], ycpp[:n], atol=2e-5 * scale)


def test_overlap_save_matches_cpp(tbin, speech, tmp_path):
    """The reference OverlapSave streams non-overlapping L-blocks and emits
    only outputs P..L-1 of each (convolution.cc:196-227): the head P samples
    of every block are skipped.  Compare against the linear convolution at
    exactly those positions."""
    from distant_speech_recognition_tpu.models.lti import overlap_save_filter
    import jax.numpy as jnp

    x, path = speech
    rng = np.random.default_rng(8)
    P, L = 64, 512
    ir = rng.standard_normal(P)
    irf = str(tmp_path / "ir.f64")
    ir.astype(np.float64).tofile(irf)
    out = str(tmp_path / "os.f32")
    subprocess.run(
        [tbin, "osave", str(P), str(L), irf, path, out],
        check=True, capture_output=True,
    )
    ycpp = np.fromfile(out, np.float32).reshape(-1, L - P)
    yfull = np.asarray(
        overlap_save_filter(jnp.asarray(x, jnp.float64), jnp.asarray(ir))
    )
    scale = np.abs(ycpp).max()
    for j in range(len(ycpp)):
        seg = yfull[j * L + P : (j + 1) * L]
        if len(seg) < L - P:
            break
        np.testing.assert_allclose(ycpp[j], seg, atol=2e-5 * scale)


def test_energy_vad_metric_matches_cpp(tbin, speech, tmp_path):
    """EnergyVADMetric (percentile noise floor + hangover machine,
    sad.cc:301-366, 555-600) vs the compiled reference."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models.sad import energy_vad_metric

    x, path = speech
    D = 160
    initial, thresh, headN, tailN, energiesN = 5.0e7, 0.5, 4, 10, 100
    out = str(tmp_path / "sade.f64")
    subprocess.run(
        [tbin, "sadenergy", str(initial), str(thresh), str(headN), str(tailN),
         str(energiesN), str(D), path, out],
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    T = (len(x) // D) * D
    frames = x[:T].reshape(-1, D)
    mj = np.asarray(energy_vad_metric(
        jnp.asarray(frames), initial, thresh, headN, tailN, energiesN
    ))
    n = min(len(mcpp), len(mj))
    assert n >= len(mcpp) - 1
    np.testing.assert_array_equal(mj[:n], mcpp[:n])


@pytest.mark.parametrize("kind,E0", [("power", 1.2), ("normenergy", 1.0)])
def test_power_spectrum_vad_metric_matches_cpp(tbin, cmu2, kind, E0, tmp_path):
    """PowerSpectrumVADMetric / NormalizedEnergyMetric (sad.cc:665-830) vs
    the compiled reference, over per-channel Hamming+FFT power spectra."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat
    from distant_speech_recognition_tpu.models.sad import power_spectrum_metric

    chans, paths = cmu2
    fftlen, D = 512, 512
    out = str(tmp_path / "sadp.f64")
    subprocess.run(
        [tbin, "sadpower", kind, str(fftlen), str(D), str(int(FS)), "-1", "-1",
         str(E0), out] + paths,
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    P = []
    for c in chans:
        frames = feat.frame_signal(jnp.asarray(c), D, D)
        w = feat.hamming_window(frames)
        spec = jnp.fft.rfft(w, n=fftlen, axis=-1)
        P.append(feat.spectral_power(spec))
    spectra = jnp.stack(P)  # [C, T, F]
    if kind == "normenergy":
        # NormalizedEnergyMetric::next divides by binN (not fftLen) but the
        # ratio cancels the normalization — same decision function with E0=1
        mj = np.asarray(power_spectrum_metric(spectra, fftlen, 0, fftlen // 2, 1.0))
    else:
        mj = np.asarray(power_spectrum_metric(spectra, fftlen, 0, fftlen // 2, E0))
    n = min(len(mcpp), len(mj))
    assert n >= len(mcpp) - 1
    np.testing.assert_array_equal(mj[:n], mcpp[:n])


def test_lpc_spectrum_estimator_matches_cpp(tbin, speech, tmp_path):
    """LPCSpectrumEstimator (autocorrelation -> Levinson-Durbin -> all-pole
    envelope, spectralestimator.cc:84-200) vs the batched LPC chain."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models.lpc import lpc_envelope_frames

    x, path = speech
    order, fftlen, D = 16, 256, 256
    out = str(tmp_path / "lpc.f32")
    subprocess.run(
        [tbin, "lpcspec", str(order), str(fftlen), str(D), path, out],
        check=True, capture_output=True,
    )
    # the reference emits the full symmetric fftLen-wide envelope; ours is
    # one-sided [.., F] — compare the first half (+ pin the symmetry)
    ycpp = np.fromfile(out, np.float32).reshape(-1, fftlen)
    F = fftlen // 2 + 1
    assert np.allclose(ycpp[:, 1 : F - 1], ycpp[:, -1 : F - 1 : -1], rtol=1e-3)

    T = (len(x) // D) * D
    frames = x[:T].reshape(-1, D)
    yj = np.asarray(lpc_envelope_frames(jnp.asarray(frames), order, fftlen))
    n = min(len(ycpp), len(yj))
    assert n >= len(ycpp) - 1
    # float32 autocorrelation + Levinson accumulate a little differently
    # than the reference's float path; bulk agreement is ~1e-5, with a
    # low-energy-frame tail up to ~2%
    np.testing.assert_allclose(yj[:n], ycpp[:n, :F], rtol=3e-2, atol=1e-30)
    med = np.median(yj[:n] / np.maximum(ycpp[:n, :F], 1e-300))
    assert abs(med - 1.0) < 1e-4, med


def test_cepstral_spectrum_estimator_matches_cpp(tbin, speech, tmp_path):
    """CepstralSpectrumEstimator (truncated-cepstrum envelope,
    spectralestimator.cc:210-260) vs the batched implementation."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat
    from distant_speech_recognition_tpu.models.lpc import cepstral_spectrum_estimator

    x, path = speech
    order, fftlen, D, logpad = 14, 256, 160, 1.0
    out = str(tmp_path / "cep.f32")
    subprocess.run(
        [tbin, "cepspec", str(order), str(fftlen), str(logpad), str(D), path, out],
        check=True, capture_output=True,
    )
    ycpp = np.fromfile(out, np.float32).reshape(-1, fftlen)

    T = (len(x) // D) * D
    frames = feat.hamming_window(
        jnp.asarray(x[:T].reshape(-1, D))
    )
    spec = feat.fft_feature(frames, fftlen)
    yj = np.asarray(cepstral_spectrum_estimator(spec, order, logpad))
    n = min(len(ycpp), len(yj))
    assert n >= len(ycpp) - 1
    scale = np.abs(ycpp[:n]).max()
    np.testing.assert_allclose(yj[:n], ycpp[:n], atol=2e-3 * scale, rtol=5e-3)


def test_kim_binary_mask_matches_cpp(tbin, cmu2, tmp_path):
    """KimBinaryMaskFilter (ITD-threshold binary masking,
    binauralprocessing.cc:100-180) vs the batched kernel, subband domain."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.binaural import kim_binary_mask
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    Mb, mb, rb, DCb = 256, 4, 1, 2
    chans, paths = cmu2
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    thresh, alpha, dEta, dpc = 4.0, 0.4, 0.01, 1.0 / 15.0
    out = str(tmp_path / "kim.c128")
    subprocess.run(
        [tbin, "binaural", hf, "0", str(Mb), str(mb), str(rb), str(DCb),
         str(thresh), str(alpha), str(dEta), str(dpc), out,
         paths[0], paths[1]],
        check=True, capture_output=True,
    )
    Ycpp = np.fromfile(out, np.complex128).reshape(-1, Mb)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    XL = ops.analysis_half(jnp.asarray(chans[0]), jnp.asarray(h, jnp.float32), p)
    XR = ops.analysis_half(jnp.asarray(chans[1]), jnp.asarray(h, jnp.float32), p)
    Yj = np.asarray(kim_binary_mask(XL, XR, 0, thresh, alpha, dEta))
    n = min(len(Ycpp), len(Yj))
    ref_h = Ycpp[:n, : Mb // 2 + 1]
    scale = np.abs(ref_h).max()
    # The keep/attenuate decision thresholds the per-bin ITD, whose phase is
    # numerically meaningless on near-silent bins: float32 vs the
    # reference's double flips ~0.5% of decisions there.  Every deviating
    # bin must be near-silent (< 1% of peak magnitude); all others match.
    bad = np.abs(Yj[:n] - ref_h) > 2e-4 * scale
    XLa = np.abs(np.asarray(XL))[:n]
    assert bad.mean() < 0.01, bad.mean()
    if bad.any():
        assert XLa[bad].max() < 0.01 * XLa.max()
    np.testing.assert_allclose(
        np.where(bad, ref_h, Yj[:n]), ref_h, atol=2e-4 * scale
    )


def test_mcc_localizer_matches_cpp(tbin, cmu2, tmp_path):
    """MCCLocalizer block protocol over the SGB4LinearArray far-field grid
    (mcc_localizer.cc:306-460) vs `mcc_localize_blocks` +
    `mcc_reference_grid`: per-frame N-best MCCC values, azimuths, and
    truncated integer sample delays."""
    from distant_speech_recognition_tpu.models.localization import (
        mcc_localize_blocks,
        mcc_reference_grid,
    )

    chans, paths = cmu2
    nbest, dist, blockLen, nframes, C = 3, 80.0, 4096, 4, 2
    out = str(tmp_path / "mcc.f64")
    subprocess.run(
        [tbin, "mcc", str(nbest), str(dist), str(int(FS)), str(blockLen),
         str(nframes), out, paths[0], paths[1]],
        check=True, capture_output=True,
    )
    rows = np.fromfile(out, np.float64).reshape(nframes, nbest, 2 + C)

    tau, azs, maxD = mcc_reference_grid(C, dist, FS)
    x = np.stack(chans)
    best, mccc = mcc_localize_blocks(
        x, blockLen, tau, maxD, num_best=nbest
    )
    for fr in range(nframes):
        for nth in range(nbest):
            g = int(best[fr, nth])
            np.testing.assert_allclose(
                mccc[fr, g], rows[fr, nth, 0], rtol=1e-5, atol=1e-9,
                err_msg=f"mccc frame {fr} nth {nth}",
            )
            np.testing.assert_allclose(
                azs[g], rows[fr, nth, 1], atol=1e-6,
                err_msg=f"azimuth frame {fr} nth {nth}",
            )
            np.testing.assert_array_equal(tau[g], rows[fr, nth, 2:])


def test_negentropy_vad_metric_matches_cpp(tbin, speech, tmp_path):
    """NegentropyVADMetric (per-bin CGGD-vs-Gaussian log-likelihood ratio
    with an LPC spectral envelope, sad.cc:1092-1171) vs the batched
    negentropy_metric.  Our shape convention acts on |X|^2, so
    shape_f = shape_factor_cpp / 2."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.lpc import lpc_envelope_frames
    from distant_speech_recognition_tpu.models.sad import negentropy_metric
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    x, path = speech
    Mb, mb, rb, DCb = 256, 4, 1, 2
    D = Mb >> rb
    F = Mb // 2 + 1
    lpcorder, shape_cpp = 16, 0.8
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    shapedir = tmp_path / "shapes"
    shapedir.mkdir()
    for f in range(F):
        (shapedir / f"_M-{f:04d}").write_text(f"bin {shape_cpp}\n")
    out = str(tmp_path / "neg.f64")
    subprocess.run(
        [tbin, "sadneg", hf, str(Mb), str(mb), str(rb), str(DCb),
         str(int(FS)), str(lpcorder), str(shapedir), "-1", "-1", out, path],
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    X = ops.analysis_half(jnp.asarray(x), jnp.asarray(h, jnp.float32), p)
    # the estimator consumes the SAME framing as the analysis bank's source
    # (two parallel streams over one file): D-sample blocks, no window —
    # but the analysis emits ceil(T/D)+delay frames; align on the shorter
    T = (len(x) // D) * D
    frames = x[:T].reshape(-1, D)
    env = lpc_envelope_frames(jnp.asarray(frames), lpcorder, Mb)  # [T, F]
    n = min(X.shape[0], env.shape[0], len(mcpp))
    _, mj = negentropy_metric(
        X[:n], env[:n], Mb, shape_f=shape_cpp / 2.0, low_x=0, high_x=Mb // 2
    )
    mj = np.asarray(mj)
    # float32 envelope/spectrum vs the reference's double through the
    # CGGD power nonlinearity: bulk agreement ~1e-4 in log-likelihood
    # units, tail to ~3e-3 on a few frames
    np.testing.assert_allclose(mj[:n], mcpp[:n], atol=5e-3, rtol=5e-4)
    assert np.median(np.abs(mj[:n] - mcpp[:n])) < 5e-4


def test_cctde_allsamples_matches_cpp(tbin, cmu2, tmp_path):
    """compat CCTDE.allsamples (whole-utterance mode, tde.cc:70-125) vs the
    compiled reference: same peak indices, cc values to near machine
    precision.  Exercises the data()/samplesN() whole-buffer read — the
    block iterator would drop the final partial block."""
    from distant_speech_recognition_tpu.compat.feature import SampleFeature
    from distant_speech_recognition_tpu.compat.tde import CCTDE

    chans, paths = cmu2
    nheld = 4
    out = str(tmp_path / "tde_all.f64")
    subprocess.run(
        [tbin, "cctde_all", "-1", str(nheld), paths[0], paths[1], out],
        check=True, capture_output=True,
    )
    ref = np.fromfile(out, np.float64).reshape(nheld, 2)

    s1 = SampleFeature(512, 512)
    s1.set_samples(chans[0], int(FS))
    s2 = SampleFeature(512, 512)
    s2.set_samples(chans[1], int(FS))
    tde = CCTDE(s1, s2, 512, nheld)
    tde.allsamples(-1)
    np.testing.assert_array_equal(
        np.asarray(tde.sample_delays(), np.float64), ref[:, 0]
    )
    np.testing.assert_allclose(tde.cc_values(), ref[:, 1], rtol=1e-9, atol=1e-12)


def test_pca_matches_cpp(tbin, tmp_path):
    """models.sad.pca vs the reference PCA::pca_svd (sad/ica.cc:24-36).

    The reference runs a raw SVD of the [N, dim] sample matrix (no
    centering); feeding it pre-centered data maps it onto the covariance
    eigendecomposition: lambda_i == s_i^2 / N and the V columns match the
    eigenvectors up to sign.  whiten == 1/sqrt(s)."""
    from distant_speech_recognition_tpu.models.sad import pca

    rng = np.random.default_rng(3)
    N, dim = 200, 6
    X = rng.standard_normal((N, dim)) @ rng.standard_normal((dim, dim))
    Xc = X - X.mean(0)
    fi, fb, fs, fw = [str(tmp_path / n) for n in ("in.f64", "b.f64", "s.f64", "w.f64")]
    Xc.astype(np.float64).tofile(fi)
    subprocess.run(
        [tbin, "pca", str(N), str(dim), fi, fb, fs, fw],
        check=True, capture_output=True,
    )
    V = np.fromfile(fb, np.float64).reshape(dim, dim)
    sv = np.fromfile(fs, np.float64)
    wh = np.fromfile(fw, np.float64)

    comps, eig, mean = pca(np.asarray(X, np.float32))
    comps = np.asarray(comps, np.float64)
    eig = np.asarray(eig, np.float64)
    lam_ref = sv**2 / N
    # f32 forward pass: small components carry absolute error ~1e-5*max
    np.testing.assert_allclose(eig, lam_ref, atol=2e-4 * lam_ref.max())
    # columns match up to sign
    dots = np.abs(np.sum(V * comps, axis=0))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    np.testing.assert_allclose(wh, 1.0 / np.sqrt(sv), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(mean), X.mean(0), rtol=1e-5)


def test_localization_delay_calculators_match_cpp(tbin, tmp_path):
    """utils.geometry vs the reference free-function delay calculators
    (localization.cc:94-139).  Conventions differ and are mapped explicitly:
    calcDelays is absolute distance/c (mine is ref-mic normalized);
    calcDelaysOfLinearMicrophoneArray uses -|y_i - y_0| sin(az)/c with mic 0
    as reference (mine is -x cos(az)/c, so az maps to az - pi/2);
    calcDelaysOfCircularMicrophoneArray is the same formula (float math)."""
    from distant_speech_recognition_tpu.utils.geometry import (
        calc_ca_delays, calc_la_delays, calc_nf_delays,
    )

    nchan = 4
    geom = np.array([[-500., -60., 0.], [-500., -20., 0.],
                     [-500., 20., 0.], [-500., 60., 0.]])
    fg, fo = str(tmp_path / "g.f64"), str(tmp_path / "o.f64")
    geom.astype(np.float64).tofile(fg)
    az, polar, x, y, z = 0.7, 1.1, 1000, 2000, 0
    subprocess.run(
        [tbin, "locdelays", str(nchan), str(az), str(polar),
         str(x), str(y), str(z), fg, fo],
        check=True, capture_output=True,
    )
    ref = np.fromfile(fo, np.float64).reshape(3, nchan)

    mine_nf = calc_nf_delays(geom, x, y, z, ref_micx=0)
    np.testing.assert_allclose(ref[0] - ref[0][0], mine_nf, atol=1e-12)
    mine_la = calc_la_delays(np.abs(geom[:, 1] - geom[0, 1]), az - np.pi / 2,
                             ref_micx=0)
    np.testing.assert_allclose(ref[1], mine_la, atol=1e-10)
    mine_ca = calc_ca_delays(geom, az, polar)
    np.testing.assert_allclose(ref[2], mine_ca, atol=1e-9)


@pytest.mark.parametrize("seed,true_pos", [(5, (1200, 800)), (11, (800, -300))])
def test_srp_phat_grid_matches_cpp(tbin, seed, true_pos, tmp_path):
    """models.localization.srp_phat vs the reference getSrpPhat
    (localization.cc:20-92) on a nearfield (x, y) grid: same best position.

    Reference quirk, reproduced: getSrpPhat's steering phase e^{+j w
    (d_k - d_l)} REINFORCES the mirrored delay pattern (its sign is
    inverted relative to its own calcDelays), so with a physically
    synthesized source both implementations must use steering
    e^{-j w d_g} to agree — which they do, exactly, on every grid."""
    from distant_speech_recognition_tpu.models.localization import srp_phat

    nchan, fftLen = 4, 256
    fs = 16000.0
    delta_f = fs / fftLen
    geom = np.array([[0., -600., 0.], [0., -200., 0.],
                     [0., 200., 0.], [0., 600., 0.]])
    c = 343740.0
    dists = np.sqrt(((np.array(true_pos + (0,)) - geom) ** 2).sum(1)) / c
    rng = np.random.default_rng(seed)
    F = fftLen // 2 + 1
    S = rng.standard_normal(F) + 1j * rng.standard_normal(F)
    f = np.arange(F) * delta_f
    X_half = S[None] * np.exp(-2j * np.pi * f[None] * dists[:, None])
    X_half += 0.3 * (rng.standard_normal((nchan, F))
                     + 1j * rng.standard_normal((nchan, F)))
    X_full = np.zeros((nchan, fftLen), complex)
    X_full[:, :F] = X_half

    ff, fg, fo = [str(tmp_path / n) for n in ("fr.c128", "g.f64", "o.f64")]
    X_full.astype(np.complex128).tofile(ff)
    geom.astype(np.float64).tofile(fg)
    subprocess.run(
        [tbin, "srpphat", str(delta_f), str(nchan), str(fftLen), "0",
         "400", "2100", "100", "-800", "1700", "100", ff, fg, fo],
        check=True, capture_output=True,
    )
    best_ref = np.fromfile(fo, np.float64)

    xs = np.arange(400, 2100, 100)
    ys = np.arange(-800, 1700, 100)
    grid = [(x, y) for x in xs for y in ys]
    steer = np.zeros((len(grid), F, nchan), complex)
    for g, (x, y) in enumerate(grid):
        dg = np.sqrt(((np.array([x, y, 0.]) - geom) ** 2).sum(1)) / c
        steer[g] = np.exp(-2j * np.pi * f[:, None] * dg[None])
    p = np.asarray(srp_phat(X_half.T[None], steer))[0]
    best_mine = grid[int(np.argmax(p))]
    assert tuple(best_ref) == tuple(map(float, best_mine))


def test_tsps_vad_metric_matches_cpp(tbin, cmu2, tmp_path):
    """TSPSVADMetric (sad.cc:1005-1056) vs models.sad.tsps_metric: the
    target-vs-rest power ratio decision over per-channel Hamming+FFT power
    spectra, exact +1/-1 agreement."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat
    from distant_speech_recognition_tpu.models.sad import tsps_metric

    chans, paths = cmu2
    fftlen, D, E0 = 512, 512, 50000.0
    out = str(tmp_path / "tsps.f64")
    subprocess.run(
        [tbin, "sadpower", "tsps", str(fftlen), str(D), str(int(FS)), "-1",
         "-1", str(E0), out] + paths,
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    P = []
    for c in chans:
        frames = feat.frame_signal(jnp.asarray(c), D, D)
        spec = jnp.fft.rfft(feat.hamming_window(frames), n=fftlen, axis=-1)
        P.append(feat.spectral_power(spec))
    dec, _ = tsps_metric(jnp.stack(P), fftlen, 0, fftlen // 2, E0)
    n = min(len(mcpp), len(np.asarray(dec)))
    assert n >= len(mcpp) - 1
    np.testing.assert_array_equal(np.asarray(dec)[:n], mcpp[:n])


def test_ccc_vad_metric_matches_cpp(tbin, cmu2, tmp_path):
    """CCCVADMetric (sad.cc:832-980) vs models.sad.ccc_metric in
    reference_nbest mode: PHAT cross-correlation candidate quirk (slot-0
    overwrite insertion) and inverted decision replicated exactly."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat
    from distant_speech_recognition_tpu.models.sad import ccc_metric

    chans, paths = cmu2
    fftlen, D, thresh = 512, 512, 0.1
    out = str(tmp_path / "ccc.f64")
    subprocess.run(
        [tbin, "sadccc", str(fftlen), "5", str(D), str(int(FS)), "-1", "-1",
         str(thresh), out] + paths,
        check=True, capture_output=True,
    )
    rows = np.fromfile(out, np.float64).reshape(-1, 2)

    S = []
    for c in chans:
        frames = feat.frame_signal(jnp.asarray(c), D, D)
        S.append(jnp.fft.rfft(feat.hamming_window(frames), n=fftlen, axis=-1))
    dec, metric = ccc_metric(jnp.stack(S), fftlen, threshold=thresh,
                             num_candidates=5, reference_nbest=True)
    n = min(len(rows), len(np.asarray(metric)))
    assert n >= len(rows) - 1
    np.testing.assert_allclose(np.asarray(metric)[:n], rows[:n, 1], atol=1e-5)
    np.testing.assert_array_equal(
        np.where(np.asarray(dec)[:n], 1.0, -1.0), rows[:n, 0]
    )


@pytest.mark.parametrize("version,ratio", [(1, 1.2), (1, 0.85), (2, 1.2),
                                           (2, 0.85), (2, 1.0)])
def test_vtln_matches_cpp(tbin, speech, version, ratio, tmp_path):
    """VTLNFeature both warp versions (feature.cc nextOrg / nextFF) vs
    models.features.vtln / vtln_ff over the Hamming+FFT+power chain.

    Version 2 (the reference MFCC extractor's choice) reproduces two
    reference quirks: the signed-vs-unsigned gate that drops source bin 0,
    and the single-precision warp arithmetic whose floor/ceil boundaries
    differ from f64 (see vtln_ff_matrix)."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models import features as feat

    x, path = speech
    fftlen, D, coeffN, edge = 512, 512, 257, 0.8
    out = str(tmp_path / "vtln.f64")
    subprocess.run(
        [tbin, "vtln", str(version), str(coeffN), str(ratio), str(edge),
         str(fftlen), str(D), path, out],
        check=True, capture_output=True,
    )
    ref = np.fromfile(out, np.float64).reshape(-1, coeffN)

    frames = feat.frame_signal(jnp.asarray(x), D, D)
    spec = jnp.fft.rfft(feat.hamming_window(frames), n=fftlen, axis=-1)
    P = feat.spectral_power(spec)
    mine = np.asarray(feat.vtln(P, ratio, edge) if version == 1
                      else feat.vtln_ff(P, ratio, edge))
    n = min(len(ref), len(mine))
    assert n >= len(ref) - 1
    scale = np.abs(ref[:n]).max()
    np.testing.assert_allclose(mine[:n], ref[:n], atol=2e-6 * scale)


def test_mutual_information_vad_metric_matches_cpp(tbin, cmu2, tmp_path):
    """MutualInformationVADMetric (sad.cc:1379-1560) vs the reference-exact
    oracle: joint CGGD likelihood with the entropy-matching bisection for
    the joint shape factor, the pre-update rho recursion with |rho| clipped
    at 1 - epsilon, and the reference's band weighting/normalization."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.lpc import lpc_envelope_frames
    from distant_speech_recognition_tpu.models.sad import (
        mutual_information_metric_exact,
    )
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    chans, paths = cmu2
    Mb, mb, rb, DCb = 256, 4, 1, 2
    D = Mb >> rb
    lpcorder = 16
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    out = str(tmp_path / "mi.f64")
    subprocess.run(
        [tbin, "sadmi", hf, str(Mb), str(mb), str(rb), str(DCb),
         str(int(FS)), str(lpcorder), "187", "1000", out, paths[0], paths[1]],
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    x1, x2 = chans
    X1 = np.asarray(ops.analysis_half(jnp.asarray(x1), jnp.asarray(h, jnp.float32), p))
    X2 = np.asarray(ops.analysis_half(jnp.asarray(x2), jnp.asarray(h, jnp.float32), p))
    T = (len(x1) // D) * D
    env1 = np.asarray(lpc_envelope_frames(jnp.asarray(x1[:T].reshape(-1, D)), lpcorder, Mb))
    env2 = np.asarray(lpc_envelope_frames(jnp.asarray(x2[:T].reshape(-1, D)), lpcorder, Mb))
    n = min(len(X1), len(env1), len(mcpp))
    mj = mutual_information_metric_exact(
        X1[:n], X2[:n], env1[:n], env2[:n], Mb, FS, 187.0, 1000.0
    )
    scale = np.abs(mcpp[:n]).max()
    np.testing.assert_allclose(mj, mcpp[:n], atol=5e-4 * scale)


def test_likelihood_ratio_vad_metric_matches_cpp(tbin, cmu2, tmp_path):
    """LikelihoodRatioVADMetric (sad.cc:1567-1617) vs the reference-exact
    oracle: marginal CGGD likelihood ratio of the two channels under the
    pooled envelope scale."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.lpc import lpc_envelope_frames
    from distant_speech_recognition_tpu.models.sad import (
        likelihood_ratio_metric_exact,
    )
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    chans, paths = cmu2
    Mb, mb, rb, DCb = 256, 4, 1, 2
    D = Mb >> rb
    lpcorder = 16
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    out = str(tmp_path / "lr.f64")
    subprocess.run(
        [tbin, "sadlr", hf, str(Mb), str(mb), str(rb), str(DCb),
         str(int(FS)), str(lpcorder), "187", "1000", out, paths[0], paths[1]],
        check=True, capture_output=True,
    )
    mcpp = np.fromfile(out, np.float64)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    x1, x2 = chans
    X1 = np.asarray(ops.analysis_half(jnp.asarray(x1), jnp.asarray(h, jnp.float32), p))
    X2 = np.asarray(ops.analysis_half(jnp.asarray(x2), jnp.asarray(h, jnp.float32), p))
    T = (len(x1) // D) * D
    env1 = np.asarray(lpc_envelope_frames(jnp.asarray(x1[:T].reshape(-1, D)), lpcorder, Mb))
    env2 = np.asarray(lpc_envelope_frames(jnp.asarray(x2[:T].reshape(-1, D)), lpcorder, Mb))
    n = min(len(X1), len(env1), len(mcpp))
    mj = likelihood_ratio_metric_exact(
        X1[:n], X2[:n], env1[:n], env2[:n], Mb, FS, 187.0, 1000.0
    )
    scale = np.abs(mcpp[:n]).max()
    np.testing.assert_allclose(mj, mcpp[:n], atol=1e-4 * scale)


def test_low_full_band_energy_ratio_matches_cpp(tbin, speech, tmp_path):
    """LowFullBandEnergyRatioVADMetric (sad.cc:1649-1701) vs the
    reference-exact implementation, including the never-zeroed scratch
    accumulator (dgemv beta=1) that makes the lower-band energy CUMULATIVE
    across frames."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models.sad import (
        low_full_band_energy_ratio_metric,
    )

    x, path = speech
    L, D = 5, 512
    rng = np.random.default_rng(1)
    lp = rng.standard_normal(L)
    flp = str(tmp_path / "lp.f64")
    lp.astype(np.float64).tofile(flp)
    out = str(tmp_path / "lfer.f64")
    subprocess.run(
        [tbin, "sadlfer", str(L), str(D), out, flp, path],
        check=True, capture_output=True,
    )
    ref = np.fromfile(out, np.float64)

    T = len(x) // D
    frames = x[: T * D].reshape(T, D)
    mine = np.asarray(
        low_full_band_energy_ratio_metric(jnp.asarray(frames), jnp.asarray(lp))
    )
    n = min(len(ref), len(mine))
    assert n >= len(ref) - 1
    np.testing.assert_allclose(mine[:n], ref[:n], rtol=1e-5)


@pytest.mark.parametrize("win", [(-1.0, 1.0), (-0.001, 0.001), (0.0, 0.0005)])
def test_windowed_gcc_free_function_matches_cpp(tbin, win, tmp_path):
    """getWindowedGCC free function (localization.cc) vs PHAT cross-spectrum
    + models.localization.find_cc_peak: delay-windowed peak with quadratic
    interpolation, exact on a known-delay synthetic pair."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models.localization import find_cc_peak

    rng = np.random.default_rng(4)
    fftLen, fs = 256, 16000.0
    F = fftLen // 2 + 1
    S = rng.standard_normal(F) + 1j * rng.standard_normal(F)
    f = np.arange(F)
    tau = 3.3 / fs
    X0 = S
    X1 = S * np.exp(-2j * np.pi * f * fs / fftLen * tau) + 0.1 * (
        rng.standard_normal(F) + 1j * rng.standard_normal(F)
    )
    Xfull = np.zeros((2, fftLen), complex)
    Xfull[0, :F] = X0
    Xfull[1, :F] = X1
    ff = str(tmp_path / "fr.c128")
    Xfull.astype(np.complex128).tofile(ff)
    fo = str(tmp_path / "o.f64")
    minD, maxD = win
    subprocess.run(
        [tbin, "wgcc", str(fftLen), str(fs), str(minD), str(maxD), ff, fo],
        check=True, capture_output=True,
    )
    ref = np.fromfile(fo, np.float64)

    cs = X0 * np.conj(X1)
    mag = np.abs(cs)
    cs = np.where(mag > 0, cs / mag, 0.0)
    cc = np.fft.irfft(cs, n=fftLen)
    dly, pk = find_cc_peak(jnp.asarray(cc), fs, minD, maxD)
    np.testing.assert_allclose([float(dly), float(pk)], ref, rtol=1e-6, atol=1e-10)


def test_iid_binary_mask_matches_cpp(tbin, cmu2, tmp_path):
    """IIDBinaryMaskFilter (magnitude-difference binary masking,
    binauralprocessing.cc:438-520) vs the batched kernel."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.binaural import iid_binary_mask
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    Mb, mb, rb, DCb = 256, 4, 1, 2
    chans, paths = cmu2
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    thresh, alpha, dEta = 2.0, 0.4, 0.01
    out = str(tmp_path / "iid.c128")
    subprocess.run(
        [tbin, "iid_mask", hf, "0", str(Mb), str(mb), str(rb), str(DCb),
         str(thresh), str(alpha), str(dEta), out, paths[0], paths[1]],
        check=True, capture_output=True,
    )
    Ycpp = np.fromfile(out, np.complex128).reshape(-1, Mb)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    XL = ops.analysis_half(jnp.asarray(chans[0]), jnp.asarray(h, jnp.float32), p)
    XR = ops.analysis_half(jnp.asarray(chans[1]), jnp.asarray(h, jnp.float32), p)
    Yj = np.asarray(iid_binary_mask(XL, XR, 0, thresh, alpha, dEta))
    n = min(len(Ycpp), len(Yj))
    ref_h = Ycpp[:n, : Mb // 2 + 1]
    scale = np.abs(ref_h).max()
    # same near-silent decision-flip budget as the Kim mask golden
    bad = np.abs(Yj[:n] - ref_h) > 2e-4 * scale
    XLa = np.abs(np.asarray(XL))[:n]
    assert bad.mean() < 0.01, bad.mean()
    if bad.any():
        assert XLa[bad].max() < 0.01 * XLa.max()


def test_iid_threshold_estimator_matches_cpp(tbin, cmu2, tmp_path):
    """IIDThresholdEstimator (joint-kurtosis threshold search over the
    whole utterance, binauralprocessing.cc:524-684): the cost function over
    the candidate grid and the argmin threshold."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.binaural import iid_threshold
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    Mb, mb, rb, DCb = 256, 4, 1, 2
    chans, paths = cmu2
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    minTh, maxTh, width, dEta, dpc = -40.0, 40.0, 2.0, 0.01, 0.5
    out = str(tmp_path / "iidth.f64")
    subprocess.run(
        [tbin, "iid_thresh", hf, str(Mb), str(mb), str(rb), str(DCb),
         str(minTh), str(maxTh), str(width), str(dEta), str(dpc), out,
         paths[0], paths[1]],
        check=True, capture_output=True,
    )
    raw = np.fromfile(out, np.f64 if hasattr(np, "f64") else np.float64)
    th_cpp, cost_cpp = raw[0], raw[1:]

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    XL = ops.analysis_half(jnp.asarray(chans[0]), jnp.asarray(h, jnp.float32), p)
    XR = ops.analysis_half(jnp.asarray(chans[1]), jnp.asarray(h, jnp.float32), p)
    th, cands, negcost = iid_threshold(
        XL, XR, minTh, maxTh, width, d_eta=dEta, power_coeff=dpc, beta=3.0)
    assert len(cands) == len(cost_cpp)
    np.testing.assert_allclose(-negcost, cost_cpp,
                               rtol=2e-4)
    # the argmax can legitimately hop one grid step when the f64 C++ cost
    # surface and the f32 JAX one differ in the last bits near a tie
    assert abs(th - th_cpp) <= width + 1e-9


def test_fdiid_threshold_estimator_matches_cpp(tbin, cmu2, tmp_path):
    """FDIIDThresholdEstimator (per-bin kurtosis threshold search,
    binauralprocessing.cc:700-920).

    Reference quirk: FDIID's ``_beta`` member is NEVER initialized (only
    the parent IIDThresholdEstimator's own _beta(3.0) init exists, and the
    two are distinct members) — in practice the fresh heap reads as 0.0,
    so the compiled cost is E[Y^4] alone; compared with beta=0 and the
    effective beta asserted from the dump itself."""
    import jax.numpy as jnp

    from distant_speech_recognition_tpu import ops
    from distant_speech_recognition_tpu.models.binaural import fd_iid_threshold
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    Mb, mb, rb, DCb = 256, 4, 1, 2
    chans, paths = cmu2
    h, g = load_pair(Mb, mb, rb)
    hf = str(tmp_path / "h.f64")
    np.asarray(h, np.float64).tofile(hf)
    minTh, maxTh, width, dEta, dpc = -40.0, 40.0, 4.0, 0.01, 1.0 / 15.0
    out = str(tmp_path / "fdth.f64")
    subprocess.run(
        [tbin, "fdiid_thresh", hf, str(Mb), str(mb), str(rb), str(DCb),
         str(minTh), str(maxTh), str(width), str(dEta), str(dpc), out,
         paths[0], paths[1]],
        check=True, capture_output=True,
    )
    raw = np.fromfile(out, np.float64)
    F2 = Mb // 2 + 1
    nC = (len(raw) - 1) // F2
    th_cpp = raw[0]
    cost_cpp = raw[1:].reshape(F2, nC)

    p = ops.FilterbankParams(M=Mb, m=mb, r=rb, delay_compensation_type=DCb)
    XL = ops.analysis_half(jnp.asarray(chans[0]), jnp.asarray(h, jnp.float32), p)
    XR = ops.analysis_half(jnp.asarray(chans[1]), jnp.asarray(h, jnp.float32), p)
    # the reference's FDIID `_beta` is uninitialized, so its effective
    # value is allocator-dependent (0.0 from a fresh heap in practice,
    # but nothing guarantees it): derive it from the dump by trying both
    # plausible surfaces (0.0 and the parent's 3.0) and assert the better
    # match — the test then pins the cost computation, not heap contents
    best = None
    for beta_eff in (0.0, 3.0):
        thr, cands, cost = fd_iid_threshold(
            XL, XR, minTh, maxTh, width, d_eta=dEta, power_coeff=dpc,
            beta=beta_eff)
        assert len(cands) == nC
        # bin 0 is never accumulated by the reference (loop starts at 1)
        err = float(np.max(np.abs(cost[1:] - cost_cpp[1:])
                           / np.maximum(np.abs(cost_cpp[1:]), 1e-30)))
        if best is None or err < best[0]:
            best = (err, beta_eff)
    assert best[0] < 2e-3, f"neither beta=0 nor beta=3 matches: {best}"
