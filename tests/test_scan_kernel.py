"""The GSC-RLS + Zelinski recursion kernel (models/scan_kernel.py) against
the XLA scan (`adaptive_gsc.gsc_postfilter_fused`).

The kernel runs here through the Pallas interpreter (``interpret=True``)
with the same body the Triton route compiles for the GPU; the ``gpu``-marked
test compiles it for the card (chip_smoke.py phase 1 makes the same check at
the flagship width).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distant_speech_recognition_tpu.models import adaptive_gsc as ag
from distant_speech_recognition_tpu.models import scan_kernel as sk
from distant_speech_recognition_tpu.models.beamforming import array_manifold, frame_energy_half

FS = 16000.0


@pytest.fixture(autouse=True)
def _no_unroll(monkeypatch):
    # the reference scan's unroll is a codegen knob (same values); unroll 1
    # keeps its CPU compile short at C=8
    monkeypatch.setattr(ag, "SCAN_UNROLL", 1)


def _weights(M, C, rng, n_utt=None):
    """(wqH, BmH, ta) for a random look direction, or one per utterance."""
    if n_utt is None:
        delays = rng.uniform(-3e-4, 3e-4, C)
        wqH, BmH = ag.gsc_weights(M, FS, delays)
        return np.asarray(wqH), np.asarray(BmH), np.asarray(array_manifold(M, FS, delays))
    ws = [_weights(M, C, rng) for _ in range(n_utt)]
    return tuple(np.stack(w) for w in zip(*ws))


def _spectrum(rng, Tf, B, C, M, scale=100.0):
    """[Tf, B, C, 2F] [Re | Im] lanes with Im(DC) = Im(Nyquist) = 0."""
    F = M // 2 + 1
    Yr = (rng.standard_normal((Tf, B, C, 2 * F)) * scale).astype(np.float32)
    Yr[..., F] = 0.0
    Yr[..., 2 * F - 1] = 0.0
    return Yr


def _energy(Yr, M):
    F = M // 2 + 1
    return frame_energy_half(jax.lax.complex(Yr[:, :, 0, :F], Yr[:, :, 0, F:]), M)


def _snapshots(Yr):
    F = Yr.shape[-1] // 2
    return jnp.swapaxes(jax.lax.complex(Yr[..., :F], Yr[..., F:]), 2, 3)  # [Tf, B, F, C]


# CPU compile options for the interpreted kernel and its reference: the
# kernel body is thousands of per-lane ops and LLVM's optimization passes
# dominate a test's time; the arithmetic does not depend on them.
_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _run(f, *args):
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(f).lower(*args).compile(compiler_options=_FAST)(*args))


def _xla(Yr, weights, cfg, pf, per_utterance=False):
    M = 2 * (Yr.shape[-1] // 2 - 1)
    wqH, BmH, ta = weights

    def one(Xb, eb, w, b, t):
        return ag.gsc_postfilter_fused(Xb[:, None], eb[:, None], w, b, t, "rls", cfg, *pf)[:, 0]

    def f(Yr):
        X, e = _snapshots(Yr), _energy(Yr, M)
        if not per_utterance:
            return ag.gsc_postfilter_fused(X, e, wqH, BmH, ta, "rls", cfg, *pf)
        return jax.vmap(one, in_axes=(1, 1, 0, 0, 0), out_axes=1)(X, e, wqH, BmH, ta)

    return _run(f, Yr)


def _kernel(Yr, weights, cfg, pf, per_utterance=False):
    M = 2 * (Yr.shape[-1] // 2 - 1)
    return _run(lambda Yr: sk.gsc_rls_zelinski(
        Yr, _energy(Yr, M), *weights, cfg, *pf, per_utterance=per_utterance,
        interpret=True), Yr)


def _kernel_lanes(Yr, weights, cfg, pf, block):
    """The lane-level entry point at a given block size."""
    Tf, B, C, F2 = Yr.shape
    F, M = F2 // 2, F2 - 2
    planes = [sk.lane_planes(w, B) for w in weights]

    def f(Yr):
        X = Yr.reshape(Tf, B, C, 2, F).transpose(0, 2, 3, 1, 4).reshape(Tf, C, 2, B * F)
        Y = sk.gsc_rls_zelinski_lanes(X, _energy(Yr, M), *planes, cfg, *pf,
                                      interpret=True, block=block)
        Y = Y.reshape(Tf, 2, B, F)
        return jax.lax.complex(Y[:, 0], Y[:, 1])

    return _run(f, Yr)


def _assert_close(got, want, tol=1e-4):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, err


CFG = dataclasses.replace(ag.GSCRLSConfig(), min_frames=2)


@pytest.mark.parametrize("pf_type", [1, 2])
@pytest.mark.parametrize("pf_min_frames", [0, 2])
@pytest.mark.parametrize("M", [64, 256])
@pytest.mark.parametrize("C", [2, 4])
def test_kernel_matches_xla_scan(C, M, pf_min_frames, pf_type, rng):
    """Fixed-array weights, real and abs Zelinski numerators, with and
    without the postfilter warm-up."""
    Yr = _spectrum(rng, 14, 2, C, M)
    w = _weights(M, C, rng)
    pf = (0.6, pf_type, pf_min_frames)
    _assert_close(_kernel(Yr, w, CFG, pf), _xla(Yr, w, CFG, pf))


@pytest.mark.parametrize("M", [64, 256])
def test_kernel_matches_xla_scan_eight_channels(M, rng):
    """C=8: a 7x7 RLS precision triangle per lane."""
    Yr = _spectrum(rng, 10, 1, 8, M)
    w = _weights(M, 8, rng)
    pf = (0.6, 1, 2)
    _assert_close(_kernel(Yr, w, CFG, pf), _xla(Yr, w, CFG, pf))


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_lane_tail(B, block, rng):
    """Lane counts (B * 33 at M=64) that are not a multiple of the block:
    the masked tail block neither reads nor writes past the lanes."""
    Yr = _spectrum(rng, 12, B, 4, 64)
    w = _weights(64, 4, rng)
    pf = (0.6, 1, 2)
    _assert_close(_kernel_lanes(Yr, w, CFG, pf, block), _xla(Yr, w, CFG, pf))


@pytest.mark.parametrize("pf_min_frames", [0, 2])
@pytest.mark.parametrize("C", [2, 4])
def test_kernel_per_utterance_weights(C, pf_min_frames, rng):
    """Steered chain: each utterance has its own weights (per-lane planes)."""
    B, M = 3, 64
    Yr = _spectrum(rng, 12, B, C, M)
    w = _weights(M, C, rng, n_utt=B)
    pf = (0.6, 1, pf_min_frames)
    _assert_close(_kernel(Yr, w, CFG, pf, per_utterance=True),
                  _xla(Yr, w, CFG, pf, per_utterance=True))


@pytest.mark.parametrize("scale", [1.8e-8, 1e-12, 0.0])
def test_kernel_near_silent_bins(scale, rng):
    """Near-silent (and digitally silent) top bins put |wa|^2 where
    max_wa / |wa|^2 overflows; selects keep the output finite and equal to
    the XLA scan."""
    M = 256
    F = M // 2 + 1
    Yr = _spectrum(rng, 16, 2, 4, M)
    lo = 3 * M // 8
    Yr[..., lo:F] *= scale
    Yr[..., F + lo:] *= scale
    w = _weights(M, 4, rng)
    pf = (0.6, 1, 0)
    _assert_close(_kernel(Yr, w, CFG, pf), _xla(Yr, w, CFG, pf))


@pytest.mark.parametrize("constraint_option,reg", [(0, 1e-2), (1, 1e-2), (2, 1e-2), (3, 1e-2), (3, 0.0)])
def test_kernel_constraint_options(constraint_option, reg, rng):
    """Quadratic constraint, norm cap, both or neither; with and without the
    regularization leak.  A small diagonal load makes the constraints bite."""
    cfg = dataclasses.replace(CFG, constraint_option=constraint_option,
                              regularization_param=reg, init_diagonal_load=1e2,
                              alpha2=1e-2, max_wa_l2norm=1e-2)
    Yr = _spectrum(rng, 14, 2, 4, 64)
    w = _weights(64, 4, rng)
    pf = (0.6, 1, 2)
    _assert_close(_kernel(Yr, w, cfg, pf), _xla(Yr, w, cfg, pf))


@pytest.mark.parametrize("per_utterance", [False, True])
def test_lane_planes_layout(per_utterance, rng):
    """Lane l of the planes holds utterance l // F, bin l % F."""
    B, F, C = 3, 5, 2
    shape = (B, F, C) if per_utterance else (F, C)
    w = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    p = np.asarray(sk.lane_planes(w, B, per_utterance))
    assert p.shape == (C, 2, B * F)
    for lane in range(B * F):
        b, f = divmod(lane, F)
        want = w[b, f] if per_utterance else w[f]
        np.testing.assert_array_equal(p[:, 0, lane], want.real)
        np.testing.assert_array_equal(p[:, 1, lane], want.imag)


@pytest.mark.gpu
def test_kernel_compiled_matches_xla_scan_on_gpu(gpu, rng):
    """The kernel as Triton compiles it for the card, against the XLA scan on
    the same card (2 s of frames, 16 utterances)."""
    M, C = 256, 4
    Yr = _spectrum(rng, 250, 16, C, M)
    w = _weights(M, C, rng)
    pf = (0.6, 1, 2)
    Yj = jnp.asarray(Yr)
    got = np.asarray(jax.jit(lambda Y: sk.gsc_rls_zelinski(Y, _energy(Y, M), *w, CFG, *pf))(Yj))
    _assert_close(got, _xla(Yr, w, CFG, pf))
