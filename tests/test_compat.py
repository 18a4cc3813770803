"""BTK 2.0 compat layer: pull-stream graphs reproduce the batch pipeline.

Builds the reference's canonical graph shapes (test_online_beamforming.py:
82-159) from compat nodes and checks frame-exact agreement with the dense
batched implementations they wrap.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from distant_speech_recognition_tpu import compat
from distant_speech_recognition_tpu.models.pipeline import PipelineConfig, build_pipeline
from distant_speech_recognition_tpu.models.postfilter import PostFilterType
from distant_speech_recognition_tpu.ops.filterbank import (
    FilterbankParams,
    analysis,
    hermitian_mirror,
    num_analysis_frames,
    synthesis,
)
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu.utils.prototypes import load_pair

M, m, r = 32, 2, 1
DC = 2
P = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=DC)
FS = 16000.0


def _protos():
    return load_pair(M, m, r)


def _signal(C=3, T=3000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    clean = np.sin(2 * np.pi * 440 * t) * 2000.0
    x = np.stack(
        [np.roll(clean, k) + 150.0 * rng.standard_normal(T) for k in range(C)]
    ).astype(np.float32)
    return x


def _sample_feat(x1d):
    sf = compat.SampleFeature(block_len=P.D, shift_len=P.D, pad_zeros=True)
    sf.set_samples(x1d, int(FS))
    return sf


def test_sample_feature_framing():
    x = np.arange(50, dtype=np.float32)
    sf = compat.SampleFeature(block_len=16, shift_len=16, pad_zeros=True)
    sf.set_samples(x, 16000)
    blocks = list(sf)
    assert len(blocks) == 4  # ceil(50/16)
    np.testing.assert_array_equal(np.concatenate(blocks)[:50], x)
    assert np.all(np.concatenate(blocks)[50:] == 0)
    assert sf.is_end()
    # cache guard: re-asking for the produced frame returns it unchanged
    sf.reset()
    b0 = sf.next(0)
    np.testing.assert_array_equal(sf.next(0), b0)
    with pytest.raises(ValueError):
        sf.next(5)


@pytest.mark.parametrize("dc", [0, 2])
def test_analysis_stream_matches_batch(dc):
    h, g = _protos()
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc)
    x = _signal(C=1)[0]
    batch = np.asarray(analysis(jnp.asarray(x), jnp.asarray(h), p))

    sf = compat.SampleFeature(block_len=p.D, shift_len=p.D, pad_zeros=True)
    sf.set_samples(x, int(FS))
    afb = compat.OverSampledDFTAnalysisBank(sf, h, M, m, r, delay_compensation_type=dc)
    frames = np.stack(list(afb))
    assert frames.shape[0] == num_analysis_frames(p, len(x)) == batch.shape[0]
    # scale-aware: the streaming bank computes the DFT as f32 cos/sin
    # matmuls while the batch path here uses jnp.fft — pure reassociation
    # noise (~1.5e-7 relative)
    np.testing.assert_allclose(frames, batch,
                               atol=1e-6 * np.abs(batch).max())


def test_synthesis_stream_matches_batch():
    h, g = _protos()
    rng = np.random.default_rng(3)
    T = 40
    half = rng.standard_normal((T, M // 2 + 1)) + 1j * rng.standard_normal((T, M // 2 + 1))
    Y = np.asarray(hermitian_mirror(jnp.asarray(half.astype(np.complex64)), M))
    batch = np.asarray(synthesis(jnp.asarray(Y), jnp.asarray(g), P))

    sfb = compat.OverSampledDFTSynthesisBank(None, g, M, m, r, delay_compensation_type=DC)
    for t in range(T):
        sfb.input_source_vector(Y[t])
    blocks = list(sfb)
    assert len(blocks) == T - P.synthesis_delay
    np.testing.assert_allclose(np.concatenate(blocks), batch, atol=1e-3)


def _compat_chain(x, h, g, beamformer, postfilter, mpos, delays):
    C = x.shape[0]
    sfs = [_sample_feat(x[c]) for c in range(C)]
    afbs = [
        compat.OverSampledDFTAnalysisBank(sf, h, M, m, r, delay_compensation_type=DC)
        for sf in sfs
    ]
    if beamformer == "ds":
        bf = compat.SubbandGSCBeamformer(afbs, Nc=1)
        bf.calc_beamformer_weights(FS, delays)
    elif beamformer == "sd_mvdr":
        bf = compat.SubbandMVDRBeamformer(afbs)
        bf.calc_sd_beamformer_weights(FS, delays, mpos, mu=0.01)
    elif beamformer == "gsc_rls":
        bf = compat.SubbandGSCRLSBeamformer(afbs, sil_thresh=1.0e8, min_frames=8)
        bf.calc_beamformer_weights(FS, delays)
    elif beamformer == "gsc_lms":
        bf = compat.SubbandGSCLMSBeamformer(afbs, min_frames=8)
        bf.calc_beamformer_weights(FS, delays)
    else:
        raise ValueError(beamformer)

    node = compat.PyVectorComplexFeatureStream(bf)  # reference driver shape
    if postfilter == "zelinski":
        pf = compat.ZelinskiPostFilter(node, M, alpha=0.6,
                                       type=PostFilterType.ZELINSKI1_REAL)
        pf.set_beamformer(bf)
        node = pf
    sfb = compat.OverSampledDFTSynthesisBank(node, g, M, m, r,
                                             delay_compensation_type=DC)
    return np.concatenate([np.asarray(b) for b in sfb])


@pytest.mark.parametrize(
    "beamformer,postfilter",
    [("ds", "zelinski"), ("sd_mvdr", "none"), ("gsc_lms", "none"), ("gsc_rls", "zelinski")],
)
def test_full_chain_matches_batch_pipeline(beamformer, postfilter):
    h, g = _protos()
    C = 3
    x = _signal(C=C)
    mpos = np.c_[np.arange(C) * 40.0, np.zeros((C, 2))]
    delays = np.asarray(geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 4))

    cfg = PipelineConfig(
        fb=P,
        samplerate=FS,
        beamformer=beamformer,
        postfilter=postfilter,
        pf_min_frames=0,
        rls=__import__(
            "distant_speech_recognition_tpu.models.adaptive_gsc",
            fromlist=["GSCRLSConfig"],
        ).GSCRLSConfig(sil_thresh=1.0e8, min_frames=8),
        lms=__import__(
            "distant_speech_recognition_tpu.models.adaptive_gsc",
            fromlist=["GSCLMSConfig"],
        ).GSCLMSConfig(min_frames=8),
    )
    fn = build_pipeline(cfg, mpos, delays, h, g)
    y_batch = np.asarray(fn(jnp.asarray(x[None])))[0]

    y_compat = _compat_chain(x, h, g, beamformer, postfilter, mpos, delays)
    assert y_compat.shape == y_batch.shape
    scale = max(1.0, np.max(np.abs(y_batch)))
    np.testing.assert_allclose(y_compat / scale, y_batch / scale, atol=5e-4)


def test_wpe_single_channel_compat():
    h, g = _protos()
    x = _signal(C=1, T=4000, seed=7)[0]
    from distant_speech_recognition_tpu.models.dereverberation import wpe
    from distant_speech_recognition_tpu.ops.filterbank import analysis

    batch_Y = analysis(jnp.asarray(x), jnp.asarray(h), P)  # [T, M]
    F = M // 2 + 1
    exp = np.asarray(
        hermitian_mirror(wpe(batch_Y[:, :F], 1, 4, iterations=2), M)
    )

    sf = _sample_feat(x)
    afb = compat.OverSampledDFTAnalysisBank(sf, h, M, m, r, delay_compensation_type=DC)
    dr = compat.SingleChannelWPEDereverberationFeature(
        afb, lower_num=1, upper_num=4, iterations_num=2)
    n = dr.estimate_filter()
    rows = np.stack(list(dr))
    assert rows.shape[0] == n == exp.shape[0]
    scale = np.abs(exp).max()
    np.testing.assert_allclose(rows / scale, exp / scale, atol=1e-4)


def test_wpe_multi_channel_compat():
    h, g = _protos()
    x = _signal(C=2, T=3000, seed=8)
    from distant_speech_recognition_tpu.models.dereverberation import wpe_multichannel
    from distant_speech_recognition_tpu.ops.filterbank import analysis
    import jax

    F = M // 2 + 1
    batch_Y = jax.vmap(lambda s: analysis(s, jnp.asarray(h), P))(jnp.asarray(x))
    exp = np.asarray(
        hermitian_mirror(wpe_multichannel(batch_Y[..., :F], 1, 3, iterations=1), M)
    )

    pre = compat.MultiChannelWPEDereverberation(
        subbands_num=M, channels_num=2, lower_num=1, upper_num=3, iterations_num=1)
    feats = []
    for c in range(2):
        sf = _sample_feat(x[c])
        afb = compat.OverSampledDFTAnalysisBank(sf, h, M, m, r, delay_compensation_type=DC)
        pre.set_input(afb)
        feats.append(compat.MultiChannelWPEDereverberationFeature(pre, channel_no=c))
    n = pre.estimate_filter()
    scale = np.abs(exp).max()
    for c in range(2):
        rows = np.stack(list(feats[c]))
        assert rows.shape[0] == n
        np.testing.assert_allclose(rows / scale, exp[c] / scale, atol=1e-4)


def test_nlms_aec_compat():
    h, g = _protos()
    rng = np.random.default_rng(9)
    T = 3000
    far = (1000.0 * rng.standard_normal(T)).astype(np.float32)
    near = 0.5 * np.roll(far, 3) + (20.0 * rng.standard_normal(T)).astype(np.float32)
    from distant_speech_recognition_tpu.models.aec import nlms_aec
    from distant_speech_recognition_tpu.ops.filterbank import analysis

    F = M // 2 + 1
    V = analysis(jnp.asarray(far), jnp.asarray(h), P)
    A = analysis(jnp.asarray(near), jnp.asarray(h), P)
    exp = np.asarray(hermitian_mirror(nlms_aec(V[:, :F], A[:, :F])[0], M))

    pafb = compat.OverSampledDFTAnalysisBank(_sample_feat(far), h, M, m, r,
                                             delay_compensation_type=DC)
    rafb = compat.OverSampledDFTAnalysisBank(_sample_feat(near), h, M, m, r,
                                             delay_compensation_type=DC)
    aec = compat.NLMSAcousticEchoCancellationFeature(pafb, rafb)
    rows = np.stack(list(aec))
    scale = np.abs(exp).max()
    np.testing.assert_allclose(rows / scale, exp / scale, atol=1e-4)


def test_mccowan_compat_matches_batch_pipeline():
    h, g = _protos()
    C = 3
    x = _signal(C=C)
    mpos = np.c_[np.arange(C) * 40.0, np.zeros((C, 2))]
    delays = np.asarray(geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 4))

    cfg = PipelineConfig(fb=P, samplerate=FS, beamformer="ds", postfilter="mccowan")
    fn = build_pipeline(cfg, mpos, delays, h, g)
    y_batch = np.asarray(fn(jnp.asarray(x[None])))[0]

    sfs = [_sample_feat(x[c]) for c in range(C)]
    afbs = [compat.OverSampledDFTAnalysisBank(sf, h, M, m, r, delay_compensation_type=DC)
            for sf in sfs]
    bf = compat.SubbandGSCBeamformer(afbs, Nc=1)
    bf.calc_beamformer_weights(FS, delays)
    pf = compat.McCowanPostFilter(bf, M, alpha=0.6, type=PostFilterType.ZELINSKI1_REAL)
    pf.set_beamformer(bf)
    pf.set_diffuse_noise_model(mpos, FS)
    sfb = compat.OverSampledDFTSynthesisBank(pf, g, M, m, r, delay_compensation_type=DC)
    y_compat = np.concatenate([np.asarray(b) for b in sfb])

    assert y_compat.shape == y_batch.shape
    scale = max(1.0, np.max(np.abs(y_batch)))
    # The compat node replicates the reference's warm-up quirk (the upper
    # half of non-applied frames stays zero, postfilter.cc:926-927) which
    # the batch kernel deliberately does not; skip the synthesis reach of
    # the single warm-up frame.
    skip = (1 + P.m * P.R) * P.D
    np.testing.assert_allclose(
        y_compat[skip:] / scale, y_batch[skip:] / scale, atol=5e-4
    )


def test_mfcc_chain_compat():
    from distant_speech_recognition_tpu.models import features as feat

    x = _signal(C=1, T=4000, seed=11)[0]
    block, shift, fft_len, pow_n, nmel, ncep = 320, 160, 512, 257, 30, 13

    sf = compat.SampleFeature(block_len=block, shift_len=shift, pad_zeros=True)
    sf.set_samples(x, 16000)
    chain = compat.feature.PreemphasisFeature(sf, mu=0.95)
    chain = compat.feature.HammingFeature(chain)
    chain = compat.feature.FFTFeature(chain, fft_len=fft_len)
    chain = compat.feature.SpectralPowerFeature(chain, pow_num=pow_n)
    chain = compat.feature.MelFeature(chain, pow_num=pow_n, filter_num=nmel, rate=16000)
    chain = compat.feature.LogFeature(chain)
    chain = compat.feature.CepstralFeature(chain, ncep=ncep)
    store = compat.feature.StorageFeature(chain)
    got = np.stack(list(store))
    np.testing.assert_array_equal(store.frames(), got)

    frames = feat.frame_signal(jnp.asarray(x), block, shift)
    p = feat.preemphasis(frames, 0.95)
    wd = feat.hamming_window(p)
    sp = feat.fft_feature(wd, fft_len)
    pw = feat.spectral_power(sp, pow_n)
    ml = feat.mel_feature(pw, feat.mel_matrix(pow_n, 16000.0, 100.0, 6800.0, nmel))
    lg = feat.log_feature(ml)
    exp = np.asarray(feat.cepstral_feature(lg, ncep, 1))

    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4)
