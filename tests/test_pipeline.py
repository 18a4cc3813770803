"""End-to-end pipeline and sharding tests on the virtual 8-device CPU mesh."""

import glob
import os

import jax
import numpy as np
import pytest

from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu.models.pipeline import PipelineConfig, build_pipeline
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams
from distant_speech_recognition_tpu.parallel import (
    make_mesh,
    shard_batch,
    snapshot_sharding,
)
from distant_speech_recognition_tpu.utils import geometry

M, m_, r_ = 32, 4, 1
C = 4
FS = 16000.0


@pytest.fixture(autouse=True)
def _fresh_compile_caches():
    """This module's tests compile the biggest programs in the suite
    (sharded M=256 pipelines, SRP steered sweeps).  Run ~75% into the
    full suite, those compiles flaked with XLA-CPU compiler segfaults
    under the process's accumulated executable-cache heap (two different
    tests hit it on consecutive full-suite runs; every one passes in a
    fresh process).  Dropping the caches before each test keeps the
    compiler's heap small at the cost of a little recompilation."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def protos():
    return design_nyquist_pair(M, m_, r_)


@pytest.fixture(scope="module")
def array_setup():
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    return mpos, delays


@pytest.mark.parametrize(
    "beamformer,postfilter",
    [
        ("ds", "none"),
        ("sd_mvdr", "zelinski"),
        ("sd_mvdr", "mccowan"),
        ("gsc_lms", "none"),
        ("gsc_rls", "zelinski"),
    ],
)
def test_pipeline_runs_and_is_finite(beamformer, postfilter, protos, array_setup, rng):
    h, g = protos
    mpos, delays = array_setup
    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m_, r=r_, delay_compensation_type=2),
        beamformer=beamformer,
        postfilter=postfilter,
        pf_min_frames=2,
    )
    fn = build_pipeline(cfg, mpos, delays, h, g)
    x = (rng.standard_normal((2, C, 3000)) * 0.1).astype(np.float32)
    y = np.asarray(fn(x))
    assert y.ndim == 2 and y.shape[0] == 2
    assert np.isfinite(y).all()
    assert np.abs(y).max() > 0


def test_pipeline_ds_reconstructs_coherent_signal(protos, array_setup):
    """A signal identical on all channels with zero delays passes D&S ~unchanged."""
    h, g = protos
    mpos, _ = array_setup
    delays = np.zeros(C)
    cfg = PipelineConfig(fb=FilterbankParams(M=M, m=m_, r=r_), beamformer="ds")
    fn = build_pipeline(cfg, mpos, delays, h, g)
    rng = np.random.default_rng(3)
    s = (rng.standard_normal(4000) * 0.1).astype(np.float32)
    x = np.broadcast_to(s, (1, C, 4000)).copy()
    y = np.asarray(fn(x))[0]
    n = min(len(s), len(y))
    seg = slice(2 * M * m_, n - 2 * M * m_)
    err = y[:n][seg] - s[:n][seg]
    snr = 10 * np.log10((s[:n][seg] ** 2).mean() / (err**2).mean())
    assert snr > 35, snr


def test_pipeline_sharded_matches_unsharded(protos, array_setup, rng):
    """Bin-sharded (batch x freq mesh) execution is numerically identical."""
    h, g = protos
    mpos, delays = array_setup
    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m_, r=r_),
        beamformer="sd_mvdr",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    x = (rng.standard_normal((4, C, 2000)) * 0.1).astype(np.float32)

    y_ref = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))

    mesh = make_mesh(batch=4, freq=2)
    fn = build_pipeline(
        cfg, mpos, delays, h, g, bin_sharding=snapshot_sharding(mesh, batched=False)
    )
    with jax.set_mesh(mesh):
        xs = shard_batch(mesh, x)
        y = np.asarray(fn(xs))
    np.testing.assert_allclose(y, y_ref, atol=2e-4)


def test_tm_pipeline_sharded_matches_unsharded(protos, array_setup, rng):
    """The FLAGSHIP time-major fused GSC-RLS+Zelinski path, freq-sharded over
    a (batch x freq) mesh, matches the unsharded packed fast path.

    The sharded variant runs the complex [Tf, B, F, C] snapshot layout with
    the scan state split over ``freq`` (models/pipeline.py freq-sharded TM
    branch); the unsharded variant runs the packed-real lane layout — same
    math, different layouts, so this also cross-checks the packing algebra.
    """
    h, g = protos
    mpos, delays = array_setup
    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m_, r=r_, delay_compensation_type=2),
        beamformer="gsc_rls",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    x = (rng.standard_normal((4, C, 2500)) * 0.1).astype(np.float32)

    y_ref = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))

    from distant_speech_recognition_tpu.parallel import tm_snapshot_sharding

    mesh = make_mesh(batch=4, freq=2)
    fn = build_pipeline(
        cfg, mpos, delays, h, g, bin_sharding=tm_snapshot_sharding(mesh)
    )
    with jax.set_mesh(mesh):
        xs = shard_batch(mesh, x)
        y = np.asarray(fn(xs))
    np.testing.assert_allclose(y, y_ref, atol=2e-4)


def test_tm_pipeline_sharding_derived_from_snapshot_spec(protos, array_setup, rng):
    """A 3-axis [T, F, C] bin sharding is auto-lifted to the TM layout."""
    h, g = protos
    mpos, delays = array_setup
    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m_, r=r_),
        beamformer="gsc_lms",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    x = (rng.standard_normal((2, C, 2000)) * 0.1).astype(np.float32)
    y_ref = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))
    mesh = make_mesh(batch=2, freq=4)
    fn = build_pipeline(
        cfg, mpos, delays, h, g, bin_sharding=snapshot_sharding(mesh, batched=False)
    )
    with jax.set_mesh(mesh):
        y = np.asarray(fn(shard_batch(mesh, x)))
    np.testing.assert_allclose(y, y_ref, atol=2e-4)


def test_graft_entry_contract():
    """Entry points, the multi-device dry run in a fresh process on four
    virtual CPU devices (the four-GPU layout).  Running the M=256
    multi-mesh dryrun inside the long-lived suite process flaked with an
    XLA-CPU compiler segfault under the suite's accumulated heap state; a
    subprocess isolates the crash domain."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    y = fn(*args)
    assert np.isfinite(np.asarray(y)).all()

    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "PYTHONPATH": root,
    })
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as ge; ge.dryrun_multichip(4); print('OK')"],
        env=env, cwd=root, capture_output=True, text=True,
        timeout=900,
    )
    assert r.returncode == 0 and "OK" in r.stdout, (r.returncode, r.stdout[-500:], r.stderr[-2000:])


def test_reference_json_configs_drive_tools(tmp_path):
    """All the reference's shipped unit_test JSON configs drive the
    config-compatible CLI tools to finite output."""
    import json
    import glob

    import distant_speech_recognition_tpu.tools.online_beamforming as ob

    files = sorted(
        glob.glob(
            "/root/reference/btk20_src/unit_test/data/CMU/R1/M1005/KINECT/RAW/segmented/U1001*_c?.wav"
        )
    )
    CONF = "/root/reference/btk20_src/unit_test/confs"
    for conf in ["ds", "sd", "gsclms", "gscrls", "lcmv_and_zelinski",
                 "ds_and_zelinski", "sd_and_mccowan", "sd_and_lefkimmiatis"]:
        with open(f"{CONF}/{conf}.json") as f:
            ap = json.load(f)
        energy, frames = ob.run(
            None, None, 32, 4, 1, files, str(tmp_path / f"{conf}.wav"), ap
        )
        assert np.isfinite(energy) and energy > 0, conf
        assert frames > 0


def test_multihost_runner_single_host_path(tmp_path):
    """enhance_files on the virtual 8-device mesh with freq parallelism."""
    import glob

    from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
    from distant_speech_recognition_tpu.models.pipeline import PipelineConfig
    from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams
    from distant_speech_recognition_tpu.parallel import enhance_files
    from distant_speech_recognition_tpu.utils import geometry

    files = sorted(
        glob.glob(
            "/root/reference/btk20_src/unit_test/data/CMU/R1/M1005/KINECT/RAW/segmented/U1001*_c?.wav"
        )
    )
    # 4 "utterances": reuse the same 4-ch set four times
    mpos = np.c_[np.array([-113.0, 36.0, 76.0, 113.0]), np.zeros((4, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=1.2)
    h, g = design_nyquist_pair(32, 4, 1)
    cfg = PipelineConfig(fb=FilterbankParams(M=32, m=4, r=1), beamformer="sd_mvdr",
                         postfilter="zelinski", pf_min_frames=2)

    # build a little 4-utterance multichannel list by stacking the channels
    from distant_speech_recognition_tpu.utils.wavio import read_wav, write_wav

    x = np.stack([read_wav(f)[0][0] for f in files])
    paths = []
    for i in range(4):
        p = str(tmp_path / f"utt{i}.wav")
        write_wav(p, x[:, : 16000 + 100 * i], 16000)
        paths.append(p)

    outs = enhance_files(cfg, mpos, delays, h, g, paths, str(tmp_path / "out"),
                         freq_parallel=2)
    assert len(outs) == 4
    for o in outs:
        y, rate = read_wav(o)
        assert np.isfinite(y).all() and np.abs(y).max() > 0


def test_multihost_runner_two_process(tmp_path):
    """TRUE multi-process run of parallel/runner.enhance_files: two local
    jax.distributed CPU processes (4 virtual devices each) share one file
    list; each reads only its round-robin shard and writes only its own
    outputs (runner.py make_array_from_process_local_data path).  Outputs
    must match a single-process run of the same pipeline."""
    import socket
    import subprocess
    import sys as _sys

    import jax.numpy as jnp

    from distant_speech_recognition_tpu.utils.wavio import read_wav, write_wav

    # fixtures: 4 two-channel WAVs
    rng = np.random.default_rng(7)
    wav_dir = tmp_path / "in"
    wav_dir.mkdir()
    T = 3000
    for i in range(4):
        x = (rng.standard_normal((2, T)) * 1500).astype(np.float32)
        write_wav(str(wav_dir / f"u{i}.wav"), x, 16000, normalized=False)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    out_dir = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = f"{root}:{env.get('PYTHONPATH', '')}"
    procs = [
        subprocess.Popen(
            [_sys.executable, os.path.join(os.path.dirname(__file__), "_mp_worker.py"),
             str(port), str(pid), "2", str(wav_dir), str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so[-2000:], se[-2000:])
        assert "WORKER_OK" in so, (so, se)

    # every input has an enhanced output, written by exactly one process
    produced = sorted(os.listdir(out_dir))
    assert produced == [f"u{i}_enhanced.wav" for i in range(4)], produced

    # equivalence vs a single-process run of the same pipeline
    h, g = design_nyquist_pair(32, 4, 1)
    mpos = np.c_[np.arange(2) * 50.0, np.zeros((2, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=0.5)
    cfg = PipelineConfig(
        fb=FilterbankParams(M=32, m=4, r=1, delay_compensation_type=2),
        beamformer="ds",
    )
    fn = build_pipeline(cfg, mpos, delays, h, g)
    for i in range(4):
        x, _ = read_wav(str(wav_dir / f"u{i}.wav"), normalize=False)
        want = np.asarray(fn(jnp.asarray(x)[None]))[0]
        got, _ = read_wav(str(out_dir / f"u{i}_enhanced.wav"), normalize=False)
        n = min(len(want), got.shape[-1])
        np.testing.assert_allclose(got[0][:n], want[:n], atol=1.5)  # int16 LSB


def test_full_chain_aec_wpe_gsc(tmp_path):
    """BASELINE config 4: AEC -> WPE -> GSC -> postfilter chained.

    The far-end echo must be suppressed relative to the chain without AEC."""
    import jax.numpy as jnp

    M, m, r = 32, 2, 1
    fb = FilterbankParams(M=M, m=m, r=r)
    from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
    h, g = design_nyquist_pair(M, m, r)
    C, T = 4, 4000
    fs = 16000.0
    rng = np.random.default_rng(7)
    t = np.arange(T) / fs
    target = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    play = (rng.standard_normal(T) * 0.5).astype(np.float32)
    # echo: in-frame delayed playback at each mic
    echo = np.roll(play, 5) * 0.8
    x = np.stack([target + echo + 0.01 * rng.standard_normal(T) for _ in range(C)]).astype(np.float32)

    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = np.zeros(C)

    base = dict(fb=fb, samplerate=fs, beamformer="gsc_rls", postfilter="zelinski")
    cfg_chain = PipelineConfig(**base, aec="nlms", aec_threshold=1e-6,
                               aec_delta=1.0, aec_epsilon=0.5,
                               wpe=True, wpe_lower=2, wpe_upper=4)
    cfg_plain = PipelineConfig(**base, wpe=True, wpe_lower=2, wpe_upper=4)

    y_chain = np.asarray(build_pipeline(cfg_chain, mpos, delays, h, g)(
        jnp.asarray(x[None]), jnp.asarray(play[None])
    ))[0]
    y_plain = np.asarray(build_pipeline(cfg_plain, mpos, delays, h, g)(jnp.asarray(x[None])))[0]

    assert np.isfinite(y_chain).all()
    # measure residual correlation with the playback (echo leakage)
    n = min(len(y_chain), len(y_plain), T) - 600
    sl = slice(500, n)

    def leak(y):
        d = fb.laN * fb.D  # analysis look-ahead alignment
        e = np.roll(play, 5)[sl]
        yy = y[sl]
        return abs(np.corrcoef(yy, e[: len(yy)])[0, 1])

    assert leak(y_chain) < leak(y_plain) * 0.7, (leak(y_chain), leak(y_plain))


@pytest.mark.parametrize("kind,params", [
    ("kalman", dict(aec_delta=0.95, aec_epsilon=1e-3, aec_threshold=1e-8)),
    ("block_kalman", dict(aec_delta=0.95, aec_epsilon=1e-3, aec_threshold=1e-8,
                          aec_taps=2)),
])
def test_full_chain_kalman_aec(kind, params):
    """Config-4 chain with the Kalman-family cancellers wired into the
    pipeline (not just the standalone kernels): echo leakage must drop vs
    the AEC-less chain."""
    import jax.numpy as jnp

    M, m, r = 32, 2, 1
    fb = FilterbankParams(M=M, m=m, r=r)
    h, g = design_nyquist_pair(M, m, r)
    C, T = 4, 4000
    fs = 16000.0
    rng = np.random.default_rng(7)
    t = np.arange(T) / fs
    target = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    play = (rng.standard_normal(T) * 0.5).astype(np.float32)
    echo = np.roll(play, 5) * 0.8
    x = np.stack(
        [target + echo + 0.01 * rng.standard_normal(T) for _ in range(C)]
    ).astype(np.float32)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = np.zeros(C)

    base = dict(fb=fb, samplerate=fs, beamformer="gsc_rls", postfilter="zelinski")
    cfg_chain = PipelineConfig(**base, aec=kind, **params)
    cfg_plain = PipelineConfig(**base)
    y_chain = np.asarray(build_pipeline(cfg_chain, mpos, delays, h, g)(
        jnp.asarray(x[None]), jnp.asarray(play[None])
    ))[0]
    y_plain = np.asarray(build_pipeline(cfg_plain, mpos, delays, h, g)(
        jnp.asarray(x[None])
    ))[0]
    assert np.isfinite(y_chain).all()
    n = min(len(y_chain), len(y_plain), T) - 600
    sl = slice(500, n)

    def leak(y):
        e = np.roll(play, 5)[sl]
        yy = y[sl]
        return abs(np.corrcoef(yy, e[: len(yy)])[0, 1])

    assert leak(y_chain) < leak(y_plain) * 0.7, (kind, leak(y_chain), leak(y_plain))


def test_srp_steered_gsc_pipeline():
    """BASELINE config 5 core: in-graph SRP-PHAT DOA -> steered GSC, with
    per-utterance look directions in one jitted batch."""
    import jax.numpy as jnp
    from distant_speech_recognition_tpu.models.steered import build_steered_pipeline
    from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays

    M, m, r = 32, 2, 1
    fb = FilterbankParams(M=M, m=m, r=r)
    from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
    h, g = design_nyquist_pair(M, m, r)
    Ch, T = 4, 4000
    fs = 16000.0
    # circular array, radius 100 mm
    ang = 2 * np.pi * np.arange(Ch) / Ch
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(Ch)]

    rng = np.random.default_rng(9)
    phis = np.deg2rad(np.arange(0, 360, 30.0))
    true_phis = [np.deg2rad(60.0), np.deg2rad(240.0)]
    utts = []
    for tp in true_phis:
        tau = calc_ca_delays(mpos, tp, np.pi / 2)
        s = rng.standard_normal(T + 128).astype(np.float32)
        # plane wave: x_c(t) = s(t - tau_c), fractional delay via interp
        x = np.stack([
            np.interp(np.arange(T) + 64 - tau_c * fs, np.arange(T + 128), s).astype(np.float32)
            + 0.05 * rng.standard_normal(T).astype(np.float32)
            for tau_c in tau
        ])
        utts.append(x)
    xb = jnp.asarray(np.stack(utts))  # [2, C, T]

    cfg = PipelineConfig(fb=fb, samplerate=fs, beamformer="gsc_rls", postfilter="zelinski")
    enhance = build_steered_pipeline(cfg, mpos, h, g, thetas=[np.pi / 2], phis=phis)
    y, doa = enhance(xb)
    y, doa = np.asarray(y), np.asarray(doa)
    assert np.isfinite(y).all()
    # each utterance localized to its own direction (within one grid cell)
    for i, tp in enumerate(true_phis):
        err = np.abs(np.angle(np.exp(1j * (doa[i, 1] - tp))))
        assert err < np.deg2rad(31.0), (i, np.rad2deg(doa[i]), np.rad2deg(tp), err)
    assert abs(doa[0, 1] - doa[1, 1]) > np.deg2rad(90.0)


def test_srp_steered_pipeline_sharded_batch():
    """Config 5 at scale: the steered pipeline sharded over the (batch, freq)
    device mesh — identical outputs to the unsharded run."""
    import jax.numpy as jnp
    from distant_speech_recognition_tpu.models.steered import build_steered_pipeline

    M, m, r = 32, 2, 1
    fb = FilterbankParams(M=M, m=m, r=r)
    from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
    h, g = design_nyquist_pair(M, m, r)
    Ch, T, B = 4, 2000, 8
    fs = 16000.0
    ang = 2 * np.pi * np.arange(Ch) / Ch
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(Ch)]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, Ch, T)).astype(np.float32) * 0.3

    cfg = PipelineConfig(fb=fb, samplerate=fs, beamformer="gsc_rls", postfilter="zelinski")
    phis = np.deg2rad(np.arange(0, 360, 45.0))
    enhance = build_steered_pipeline(cfg, mpos, h, g, thetas=[np.pi / 2], phis=phis)

    y_ref, doa_ref = enhance(jnp.asarray(x))

    mesh = make_mesh(batch=4, freq=2)
    with jax.set_mesh(mesh):
        xs = shard_batch(mesh, jnp.asarray(x))
        y_sh, doa_sh = enhance(xs)
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref), atol=2e-4)
    np.testing.assert_allclose(np.asarray(doa_sh), np.asarray(doa_ref))


def test_time_major_path_matches_vmap_path(protos, array_setup, rng):
    """The time-major fused fast path (DSR_TIME_MAJOR, the default for
    gsc_*+zelinski) matches the vmap-of-per-utterance path: the step
    functions are the same code, only the layout differs.  (On CPU the BLAS
    accumulation order differs by layout, so compare with a tolerance.)"""
    import distant_speech_recognition_tpu.models.pipeline as pl

    h, g = protos
    mpos, delays = array_setup
    x = (rng.standard_normal((3, C, 5000)) * 1500.0).astype(np.float32)
    for beamformer in ("gsc_rls", "gsc_lms"):
        cfg = PipelineConfig(
            fb=FilterbankParams(M=M, m=m_, r=r_, delay_compensation_type=2),
            beamformer=beamformer,
            postfilter="zelinski",
            pf_min_frames=2,
        )
        assert pl.TIME_MAJOR  # default on
        y_tm = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))
        pl.TIME_MAJOR = False
        try:
            y_vm = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))
        finally:
            pl.TIME_MAJOR = True
        # The adaptive recursion's silence/constraint gates can flip on
        # eps-level matmul-ordering differences (the packed TM matrices sum
        # in a different order), so a handful of frames may deviate visibly;
        # bound the deviation to 0.2% of full scale.
        np.testing.assert_allclose(
            y_tm, y_vm, rtol=0, atol=2e-3 * np.abs(y_vm).max()
        )


def test_pipelined_executor_matches_batch_runner(tmp_path):
    """enhance_files_pipelined (load/compute/write software pipeline) writes
    the same outputs as the one-shot enhance_files batch runner."""
    import glob

    from distant_speech_recognition_tpu.design.nyquist import design_nyquist_pair
    from distant_speech_recognition_tpu.parallel import make_mesh
    from distant_speech_recognition_tpu.parallel.runner import (
        enhance_files,
        enhance_files_pipelined,
    )
    from distant_speech_recognition_tpu.utils.wavio import read_wav, write_wav

    files = sorted(
        glob.glob(
            "/root/reference/btk20_src/unit_test/data/CMU/R1/M1005/KINECT/RAW/segmented/U1001*_c?.wav"
        )
    )
    mpos = np.c_[np.array([-113.0, 36.0, 76.0, 113.0]), np.zeros((4, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=1.2)
    h, g = design_nyquist_pair(32, 4, 1)
    cfg = PipelineConfig(fb=FilterbankParams(M=32, m=4, r=1), beamformer="gsc_rls",
                         postfilter="zelinski", pf_min_frames=2)

    x = np.stack([read_wav(f, normalize=False)[0][0] for f in files])
    paths = []
    for i in range(6):  # 6 utterances, equal length (static chunk shapes)
        p = str(tmp_path / f"utt{i}.wav")
        write_wav(p, x[:, :16000] * (0.5 + 0.1 * i), 16000, normalized=False)
        paths.append(p)

    mesh = make_mesh(devices=jax.devices()[:2], batch=2, freq=1)
    outs_p = enhance_files_pipelined(
        cfg, mpos, delays, h, g, paths, str(tmp_path / "out_p"),
        chunk_size=2, mesh=mesh,
    )
    outs_b = enhance_files(cfg, mpos, delays, h, g, paths, str(tmp_path / "out_b"),
                           mesh=mesh)
    assert len(outs_p) == len(outs_b) == 6
    got = {os.path.basename(o): o for o in outs_p}
    for ob in outs_b:
        op = got[os.path.basename(ob)]
        yb, _ = read_wav(ob, normalize=False)
        yp, _ = read_wav(op, normalize=False)
        np.testing.assert_allclose(yp, yb, atol=2.0)  # int16 write quantization


def test_sos_accumulation_timesharded_psum(rng):
    """Time-sharded covariance accumulation with an explicit shard_map psum
    matches the single-device reduction, and the downstream SOS weights
    (GEV) built from the psum'd sums are identical.

    Exercises the documented scale-out form of the reference's global sums
    (SubbandSOSBatchBeamformer.accu_stats_*, pybeamformer.py:1048-1165) with
    a REAL cross-device collective, not a pjit-implicit one.
    """
    from distant_speech_recognition_tpu.models.beamforming import (
        accumulate_sos,
        gev_weights,
        improve_matrix_condition,
    )
    from distant_speech_recognition_tpu.parallel.mesh import (
        accumulate_sos_timesharded,
    )

    T, F, Ch = 64, 9, 4
    X = (rng.standard_normal((T, F, Ch)) + 1j * rng.standard_normal((T, F, Ch))
         ).astype(np.complex64)
    w_t = (rng.random(T) > 0.4).astype(np.float32)  # VAD-style frame labels

    R_ref, n_ref = accumulate_sos(jax.numpy.asarray(X), jax.numpy.asarray(w_t))

    mesh = make_mesh(batch=4, freq=2)
    R_sh, n_sh = accumulate_sos_timesharded(mesh, X, w_t, time_axis="batch")

    np.testing.assert_allclose(np.asarray(n_sh), np.asarray(n_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(R_sh), np.asarray(R_ref), atol=1e-4)

    # TF-mask weighting path through the same psum reduction
    w_tf = rng.random((T, F)).astype(np.float32)
    Rt_ref, _ = accumulate_sos(jax.numpy.asarray(X), jax.numpy.asarray(w_tf))
    Rt_sh, _ = accumulate_sos_timesharded(mesh, X, w_tf, time_axis="batch")
    np.testing.assert_allclose(np.asarray(Rt_sh), np.asarray(Rt_ref), atol=1e-4)

    # downstream: GEV weights from the sharded vs unsharded sums agree
    Rn = improve_matrix_condition(R_ref / np.maximum(np.asarray(n_ref)[..., None, None], 1))
    wq_ref = np.asarray(gev_weights(Rt_ref / T, Rn))
    wq_sh = np.asarray(gev_weights(Rt_sh / T, Rn))
    np.testing.assert_allclose(wq_sh, wq_ref, atol=1e-4)


def test_time_major_chain_matches_vmap_path(protos, array_setup, rng):
    """Round 3: the full-chain config (AEC -> WPE -> GSC-RLS -> Zelinski,
    BASELINE config 4) now lowers through the time-major packed path; it must
    match the vmap-of-per-utterance path (same step code, different layout)."""
    import distant_speech_recognition_tpu.models.pipeline as pl

    h, g = protos
    mpos, delays = array_setup
    x = (rng.standard_normal((2, C, 5000)) * 1500.0).astype(np.float32)
    play = (rng.standard_normal((2, 5000)) * 1500.0).astype(np.float32)
    for aec, wpe in (("nlms", True), ("kalman", False), ("none", True)):
        cfg = PipelineConfig(
            fb=FilterbankParams(M=M, m=m_, r=r_, delay_compensation_type=2),
            beamformer="gsc_rls",
            postfilter="zelinski",
            pf_min_frames=2,
            aec=aec,
            wpe=wpe,
            wpe_iterations=1,
        )
        from distant_speech_recognition_tpu.models.pipeline import path_flags

        assert path_flags(cfg, C)["tm_chain"], (aec, wpe)
        args = (x, play) if aec != "none" else (x,)
        y_tm = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(*args))
        pl.TIME_MAJOR = False
        try:
            y_vm = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(*args))
        finally:
            pl.TIME_MAJOR = True
        np.testing.assert_allclose(
            y_tm, y_vm, rtol=0, atol=2e-3 * np.abs(y_vm).max(), err_msg=f"{aec},{wpe}"
        )


def test_batch_only_sharded_runs_packed_path(protos, array_setup, rng):
    """Batch-ONLY sharding (freq axis size 1) wraps the full packed fast
    path in shard_map — zero-penalty data parallelism: each device runs
    the unsharded pipeline on its batch shard, and the result equals the
    unsharded run exactly (same kernels, same per-shard math)."""
    from distant_speech_recognition_tpu.parallel.mesh import (
        make_mesh,
        shard_batch,
        snapshot_sharding,
    )

    h, g = protos
    mpos, delays = array_setup
    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m_, r=r_),
        beamformer="gsc_rls",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    x = (rng.standard_normal((8, C, 2000)) * 0.1).astype(np.float32)
    y_ref = np.asarray(build_pipeline(cfg, mpos, delays, h, g)(x))

    mesh = make_mesh(batch=8, freq=1)
    fn = build_pipeline(
        cfg, mpos, delays, h, g,
        bin_sharding=snapshot_sharding(mesh, batched=False),
    )
    with jax.set_mesh(mesh):
        xs = shard_batch(mesh, x)
        y = np.asarray(fn(xs))
    np.testing.assert_allclose(y, y_ref, atol=2e-5)
