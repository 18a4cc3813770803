"""Native runtime tests: byte-exact agreement with the pure-Python path."""

import numpy as np
import pytest

from distant_speech_recognition_tpu import runtime
from distant_speech_recognition_tpu.utils import wavio

REF_WAV = "/root/reference/btk20_src/unit_test/data/speech_at_20sec.wav"

needs_native = pytest.mark.skipif(
    not runtime.native_available(), reason="native toolchain unavailable"
)


@needs_native
def test_native_read_matches_python():
    x_py, rate_py = wavio.read_wav(REF_WAV)
    x_c, rate_c = runtime.read_wav_native(REF_WAV)
    assert rate_c == rate_py
    assert x_c.shape == x_py.shape
    np.testing.assert_array_equal(x_c, x_py)


@needs_native
def test_native_write_roundtrip(tmp_path, rng):
    x = (rng.standard_normal((2, 5000)) * 0.1).astype(np.float32)
    p = str(tmp_path / "t.wav")
    runtime.write_wav_native(p, x, 16000)
    back, rate = wavio.read_wav(p)
    assert rate == 16000
    np.testing.assert_allclose(back, x, atol=1.0 / 32768)


@needs_native
def test_native_stream_reader_matches_full_read():
    x, _ = runtime.read_wav_native(REF_WAV)
    with runtime.NativeStreamReader(REF_WAV, channel=0) as r:
        blocks = []
        while True:
            b = r.read_block(1024)
            if b is None:
                break
            blocks.append(b)
    stream = np.concatenate(blocks)
    T = x.shape[1]
    np.testing.assert_array_equal(stream[:T], x[0])
    assert np.all(stream[T:] == 0)  # zero-padded tail block


def test_profiling_stage_timer_and_gsl_dump(tmp_path):
    import numpy as np
    import jax.numpy as jnp
    from distant_speech_recognition_tpu.utils.profiling import StageTimer, timed
    from distant_speech_recognition_tpu.utils.prototypes import write_gsl_format, read_gsl_format

    t = StageTimer()
    with t("stage_a"):
        _ = jnp.arange(1000.0).sum()
    f = timed(t, "stage_b")(lambda x: x * 2.0)
    f(jnp.ones(16))
    st = t.stats()
    assert st["stage_a"]["calls"] == 1 and st["stage_b"]["calls"] == 1
    assert "stage_a" in t.report()

    proto = np.random.default_rng(0).standard_normal(64)
    p = str(tmp_path / "proto.v")
    write_gsl_format(p, proto)
    np.testing.assert_allclose(read_gsl_format(p), proto)


def test_native_batch_loader(tmp_path):
    """Threaded batch loader: pad/truncate to static [B, C, T] and match the
    single-file reader bit for bit."""
    import numpy as np
    from distant_speech_recognition_tpu.runtime import native_io
    from distant_speech_recognition_tpu.utils.wavio import write_wav

    if not native_io.native_available():
        import pytest
        pytest.skip("native toolchain unavailable")

    rng = np.random.default_rng(0)
    paths, refs = [], []
    for i, T in enumerate([1000, 1700, 400]):
        x = (rng.standard_normal((2, T)) * 0.1).astype(np.float32)
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, x, 16000)
        paths.append(p)
        refs.append(x)

    T_pad = 1700
    batch = native_io.read_wav_batch_native(paths, channels=2, T_pad=T_pad)
    assert batch.shape == (3, 2, T_pad)
    for i, x in enumerate(refs):
        single, rate = native_io.read_wav_native(paths[i])
        assert rate == 16000
        T = min(x.shape[-1], T_pad)
        np.testing.assert_array_equal(batch[i, :, :T], single[:, :T])
        assert np.all(batch[i, :, T:] == 0.0)

    # header probe
    c, r, n = native_io.wav_info_native(paths[0])
    assert (c, r, n) == (2, 16000, 1000)


def test_native_resampler():
    from distant_speech_recognition_tpu.runtime import native_io

    if not native_io.native_available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    fs_in, fs_out = 48000, 16000
    T = 48000
    t = np.arange(T) / fs_in
    # in-band tone passes through with the right frequency and amplitude
    tone = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    y = native_io.resample_native(tone, fs_in, fs_out)
    assert y.shape == (T * fs_out // fs_in,)
    t2 = np.arange(len(y)) / fs_out
    ref = np.sin(2 * np.pi * 1000.0 * t2)
    seg = slice(200, len(y) - 200)  # skip filter edge transients
    err = y[seg] - ref[seg]
    snr = 10 * np.log10((ref[seg] ** 2).mean() / (err ** 2).mean())
    assert snr > 60.0, snr
    # out-of-band tone (19 kHz > new Nyquist) is rejected, not aliased
    alias = np.sin(2 * np.pi * 19000.0 * t).astype(np.float32)
    ya = native_io.resample_native(alias, fs_in, fs_out)
    assert np.sqrt((ya[seg] ** 2).mean()) < 0.02
    # upsampling round-trip is near-identity
    up = native_io.resample_native(tone, fs_in, 2 * fs_in)
    back = native_io.resample_native(up, 2 * fs_in, fs_in)
    n = min(len(back), T)
    seg2 = slice(200, n - 200)
    err2 = back[seg2] - tone[:n][seg2]
    snr2 = 10 * np.log10((tone[:n][seg2] ** 2).mean() / (err2 ** 2).mean())
    assert snr2 > 60.0, snr2
    # 2-D leading-dim handling
    two = np.stack([tone, tone * 0.5])
    y2 = native_io.resample_native(two, fs_in, fs_out)
    np.testing.assert_allclose(y2[0], y, atol=1e-7)


def test_native_resampler_golden_vs_polyphase():
    """Parity evidence for `resample_native` vs known-good resamplers
    (the reference wraps libsamplerate, feature/feature.h:777-800).

    Budgets, measured on multi-tone signals with an ANALYTIC ground truth
    (tones bandlimited to 0.35x the lower rate, interior samples only):

    * native windowed-sinc: >= 110 dB SNR vs the analytic signal at all
      four common ratios (measured 125-130 dB) — better than
      libsamplerate's own best mode (SRC_SINC_BEST_QUALITY, ~97 dB);
    * scipy.signal.resample_poly (known-good polyphase, default Kaiser):
      65-73 dB vs the same truth, so the native-vs-scipy deviation is
      bounded by SCIPY's filter error — assert native-vs-scipy >= 55 dB
      and native's analytic SNR >= scipy's (the deviation is theirs);
    * alias rejection on tones above the output Nyquist: <= -100 dBFS.
    """
    from math import gcd

    from scipy.signal import resample_poly

    from distant_speech_recognition_tpu.runtime import native_io

    if native_io._load() is None:
        pytest.skip("native runtime unavailable")

    def snr(ref, y):
        e = np.asarray(y, np.float64) - ref
        return 10 * np.log10((ref ** 2).mean() / max((e ** 2).mean(), 1e-30))

    for fs_in, fs_out in [(48000, 16000), (16000, 48000),
                          (44100, 16000), (16000, 8000)]:
        T = fs_in
        freqs = np.array([200.0, 1333.0, 3100.0, 0.35 * min(fs_in, fs_out)])
        amps = np.array([1.0, 0.5, 0.3, 0.2])
        x = (amps[:, None] * np.sin(
            2 * np.pi * freqs[:, None] * np.arange(T) / fs_in)).sum(0)
        x = x.astype(np.float32)
        n_out = T * fs_out // fs_in
        ideal = (amps[:, None] * np.sin(
            2 * np.pi * freqs[:, None] * np.arange(n_out) / fs_out)).sum(0)
        y_nat = native_io.resample_native(x, fs_in, fs_out)
        g = gcd(fs_in, fs_out)
        y_sp = resample_poly(x.astype(np.float64),
                             fs_out // g, fs_in // g)[:n_out]
        s = slice(2000, n_out - 2000)
        nat_db, sp_db = snr(ideal[s], y_nat[s]), snr(ideal[s], y_sp[s])
        assert nat_db >= 110.0, (fs_in, fs_out, nat_db)
        assert nat_db >= sp_db, (fs_in, fs_out, nat_db, sp_db)
        assert snr(y_sp[s], y_nat[s]) >= 55.0, (fs_in, fs_out)

    for f_alias in (9000.0, 12000.0):
        x = np.sin(2 * np.pi * f_alias * np.arange(48000) / 48000)
        y = native_io.resample_native(x.astype(np.float32), 48000, 16000)
        level = 10 * np.log10((y[2000:-2000] ** 2).mean() + 1e-30)
        assert level <= -100.0, (f_alias, level)
