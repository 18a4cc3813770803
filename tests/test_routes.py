"""Route selection, the kernel routes' XLA glue, and process setup.

The GSC-RLS + Zelinski recursion runs as the Pallas kernel on a GPU backend
and as the XLA scan on every other backend, with no silent fallback.  Here
the backend is monkeypatched to "gpu" and the kernel runs through the Pallas
interpreter, so the GPU route's layouts, energy pre-pass and per-lane
weights are checked against the XLA route on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distant_speech_recognition_tpu.models import adaptive_gsc as ag
from distant_speech_recognition_tpu.models import pipeline as plm
from distant_speech_recognition_tpu.models import scan_kernel as sk
from distant_speech_recognition_tpu.utils import gpu_checks as gc
from distant_speech_recognition_tpu.utils import jaxenv
from distant_speech_recognition_tpu.utils.prototypes import load_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 64


@pytest.fixture()
def protos():
    return load_pair(M, 4, 1)


@pytest.fixture()
def as_gpu(monkeypatch):
    """Report a GPU backend and run the kernel through the interpreter."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lanes = sk.gsc_rls_zelinski_lanes

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return lanes(*args, **kwargs)

    monkeypatch.setattr(sk, "gsc_rls_zelinski_lanes", interpreted)
    monkeypatch.setattr(ag, "SCAN_UNROLL", 1)


def _cfg(**kw):
    from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams

    return gc.flagship_config(fb=FilterbankParams(M=M, m=4, r=1), **kw)


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False), ("metal", False)])
def test_route_follows_backend(backend, want, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    flags = plm.path_flags(_cfg(), 4)
    assert flags["scan_kernel"] is want
    assert flags["time_major"]


def test_route_opt_out_and_non_rls(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not plm.path_flags(_cfg(beamformer="gsc_lms"), 4)["scan_kernel"]
    assert not plm.path_flags(_cfg(beamformer="ds"), 4)["scan_kernel"]
    monkeypatch.setattr(plm, "PALLAS_SCAN", False)
    assert not plm.path_flags(_cfg(), 4)["scan_kernel"]


def test_kernel_compile_error_raises(monkeypatch, protos):
    """The kernel chosen for a GPU is never swallowed into the XLA scan: on
    a backend that cannot compile it, the pipeline raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    h, g = protos
    mpos, delays = gc.array_geometry()
    fn = plm.build_pipeline(_cfg(), mpos, delays, h, g)
    x = gc.signals(1, 0.2)
    with pytest.raises(ValueError, match="interpret"):
        fn(x)


@pytest.mark.parametrize("chain", [{}, {"aec": "nlms", "wpe": True, "wpe_iterations": 1}])
def test_kernel_route_matches_xla_route(chain, as_gpu, protos):
    """build_pipeline's GPU route (analysis [Re | Im] lanes -> energy pre-pass
    -> kernel -> synthesis) equals its XLA route, plain and for config 4."""
    h, g = protos
    mpos, delays = gc.array_geometry()
    cfg = _cfg(**chain)
    x = gc.signals(2, 0.4)
    args = (x,) if cfg.aec == "none" else (x, gc.signals(2, 0.4, seed=1, n_chan=1)[:, 0])
    assert plm.path_flags(cfg, 4)["scan_kernel"]
    got = np.asarray(plm.build_pipeline(cfg, mpos, delays, h, g)(*args))
    with gc.scan_route(False):
        want = np.asarray(plm.build_pipeline(cfg, mpos, delays, h, g)(*args))
    assert np.isfinite(got).all()
    assert gc.rel_err(got, want) <= 1e-4


def test_steered_route_matches_vmap_chain(as_gpu, protos):
    """Config 5's batched route (SRP-PHAT DOA -> per-utterance weights ->
    kernel) equals the vmapped per-utterance XLA chain, DOA included."""
    from distant_speech_recognition_tpu.models.steered import build_steered_pipeline
    from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays

    h, g = protos
    C, B, T, fs = 4, 3, 6000, 16000.0
    ang = 2 * np.pi * np.arange(C) / C
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    phis = np.deg2rad(np.arange(0.0, 360.0, 30.0))
    rng = np.random.default_rng(3)
    src = rng.standard_normal((B, T + 64)).astype(np.float32) * 1500
    x = np.zeros((B, C, T), np.float32)
    for b in range(B):
        d = calc_ca_delays(mpos, phis[(5 * b) % len(phis)], np.pi / 2)
        for c in range(C):
            off = int(round(float(d[c]) * fs)) + 8
            x[b, c] = src[b, off: off + T]
    cfg = _cfg()
    y, doa = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis)(x)
    with gc.scan_route(False):
        y_ref, doa_ref = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis)(x)
    np.testing.assert_array_equal(np.asarray(doa), np.asarray(doa_ref))
    assert gc.rel_err(y, y_ref) <= 1e-4


def test_nan_trigger_interpreted():
    """The near-silent-bin trigger that bench.py and chip_smoke.py run on
    the card: finite and equal to the XLA scan."""
    r = gc.nan_trigger(interpret=True)
    assert r["finite"] and r["nan"] == 0
    assert r["rel"] <= 1e-4


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("alpha", [0.6, 0.9])
def test_ema_scan_one_form_on_every_backend(backend, alpha, monkeypatch, rng):
    """The CSD EMA is the associative form whatever the backend, and equals
    the sequential recursion (s_0 = x_0, s_1 = x_1, then the EMA)."""
    from distant_speech_recognition_tpu.models.postfilter import _ema_scan

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    want = x.astype(np.float64).copy()
    for t in range(2, len(x)):
        want[t] = alpha * want[t - 1] + (1 - alpha) * x[t]
    got = np.asarray(jax.jit(lambda s: _ema_scan(s, alpha))(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_host_device_on_cpu():
    with jaxenv.host_device():
        y = jnp.ones(3) * 2
    assert y.devices() == {jax.local_devices(backend="cpu")[0]}


def test_host_device_without_cpu_backend(monkeypatch):
    """A platform list without a CPU backend (JAX_PLATFORMS=cuda): the
    tables are computed on the default device at full matmul precision."""

    def no_cpu(*args, **kwargs):
        raise RuntimeError("Unknown backend cpu")

    monkeypatch.setattr(jax, "local_devices", no_cpu)
    with jaxenv.host_device():
        assert jax.config.jax_default_matmul_precision == "highest"
        y = np.asarray(jnp.ones((2, 2)) @ jnp.ones((2, 2)))
    np.testing.assert_array_equal(y, 2.0)


def test_compile_cache_off_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxenv.setup_compile_cache() is None


_CACHE_PROBE = """
import pathlib
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.default_backend = lambda: "gpu"
from distant_speech_recognition_tpu.utils import jaxenv
jaxenv.DEFAULT_CACHE_DIR = pathlib.Path(sys.argv[1])
if len(sys.argv) > 2:
    jaxenv.host_key = lambda: sys.argv[2]
hits = []
jax.monitoring.register_event_listener(
    lambda name, **kw: hits.append(name) if name.endswith("/cache_hits") else None)
print(jaxenv.setup_compile_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(7)).block_until_ready()
print(len(hits))
"""


def _cache_probe(default, *key, env_dir=None):
    """Run the probe in a fresh process: (cache directory, cache hits)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE, str(default), *key], env=env,
                       cwd=str(default.parent), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    path, hits = r.stdout.strip().splitlines()[-2:]
    return path, int(hits)


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(env_set, tmp_path):
    """Unset: programs land in the checkout's default directory.  Set: they
    land in JAX_COMPILATION_CACHE_DIR and nowhere else."""
    default, chosen = tmp_path / "default", tmp_path / "chosen"
    path, _ = _cache_probe(default, env_dir=chosen if env_set else None)
    want, other = (chosen, default) if env_set else (default, chosen)
    assert path == str(want)
    assert any(want.iterdir())
    assert not other.exists()


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_ignores_other_hosts(env_set, tmp_path):
    """A program cached by a host with another CPU is not loaded (XLA:CPU
    code is compiled for the host's instruction set), whichever directory
    holds the cache."""
    default = tmp_path / "default"
    env_dir = tmp_path / "chosen" if env_set else None
    assert _cache_probe(default, "other-host", env_dir=env_dir)[1] == 0
    # the same host finds its entries again
    assert _cache_probe(default, "other-host", env_dir=env_dir)[1] > 0
    assert _cache_probe(default, env_dir=env_dir)[1] == 0


def test_host_key_names_machine_and_is_stable():
    import platform

    key = jaxenv.host_key()
    assert key.startswith(platform.machine() + "-")
    assert key == jaxenv.host_key()


def test_peaks_table_by_device_kind():
    sys.path.insert(0, ROOT)
    import bench

    assert bench.peaks("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError):
        bench.peaks("cpu")


def test_chip_smoke_fails_without_gpu():
    """No accelerator: a non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
