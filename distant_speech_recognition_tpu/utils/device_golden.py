"""On-device numerical verification: per-family device-vs-CPU parity.

The test suite (including the compiled-golden tests against the unmodified
reference C++) runs on the CPU backend.  This module runs one small
representative computation per DSP family both on the default device and
on the CPU backend (the golden-anchored side) and reports the per-family
max relative error, so on-device error has per-family attribution.

The families cover the recursion kernel (models/scan_kernel.py, on a GPU
against the XLA scan on the CPU) and the XLA lowerings whose numerics
depend on the backend: DFT matmuls, complex einsums, batched linalg, scans.

Usage: ``python -m distant_speech_recognition_tpu.utils.device_golden`` or
via ``bench.py`` / ``chip_smoke.py`` (the ``device_golden`` key).
"""

from __future__ import annotations

import numpy as np

__all__ = ["run"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = max(float(np.max(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b)) / den)


def _cc(w):
    """Complex weight table as a complex64 array."""
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(w, np.complex64))


def _both(fn, *args):
    """Run ``fn(*args)`` on the default (device) backend and on CPU."""
    import jax

    cpu = jax.local_devices(backend="cpu")[0]
    dev = np.asarray(jax.jit(fn)(*args))
    with jax.default_device(cpu):
        ref = np.asarray(jax.jit(fn)(*[jax.device_put(a, cpu) for a in args]))
    return _rel(dev, ref)


def run(seconds: float = 1.0, B: int = 16, C: int = 4):
    """Returns {family: max_rel_err} + an ``ok`` flag (every family under
    its budget).  Budgets: 1e-4 for single-kernel families, 2e-3 for the
    long adaptive chains (f32 recursion over ~hundreds of frames)."""
    import jax
    import jax.numpy as jnp

    from ..models import beamforming as bf
    from ..models.adaptive_gsc import GSCRLSConfig, gsc_weights
    from ..models.aec import kalman_aec, nlms_aec
    from ..models.dereverberation import wpe_multichannel
    from ..models.features import mfcc
    from ..models.localization import srp_phat, srp_phat_steering_table
    from ..models.lti import overlap_add_filter
    from ..models.adaptive_gsc import gsc_postfilter_fused
    from ..models.scan_kernel import gsc_rls_zelinski
    from ..models.postfilter import zelinski_postfilter
    from ..ops.filterbank import (
        FilterbankParams,
        analysis_half_real_tm,
        synthesis_half_real_tm,
        synthesis_half_tm,
    )
    from .jaxenv import host_device
    from ..utils import geometry
    from ..utils.prototypes import load_pair

    fs = 16000
    T = int(seconds * fs)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, C, T)) * 1500).astype(np.float32)
    h, g = load_pair(256, 4, 1)
    p = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    hj = jnp.asarray(h, jnp.float32)
    gj = jnp.asarray(g, jnp.float32)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    with host_device():
        wqH, BmH = gsc_weights(256, fs, delays, 1)
        wqH, BmH = np.asarray(wqH), np.asarray(BmH)
        ta = np.asarray(bf.array_manifold(256, fs, delays))
        mpos5 = np.c_[100 * np.cos(2 * np.pi * np.arange(C) / C),
                      100 * np.sin(2 * np.pi * np.arange(C) / C), np.zeros(C)]
        steer, _ = srp_phat_steering_table(
            mpos5, 256, fs, [np.pi / 2], np.deg2rad(np.arange(0, 360, 30)))
        steer = np.asarray(steer)

    out = {}
    budgets = {}
    cfg = GSCRLSConfig(min_frames=4)

    def family(name, budget, fn, *args):
        """One family, isolated: a failure records an error string instead
        of killing the whole report."""
        budgets[name] = budget
        try:
            out[name] = fn(*args)
        except Exception as e:  # pragma: no cover - device-dependent
            out[name] = f"error: {type(e).__name__}: {e}"[:160]

    # 1/2: analysis + synthesis filterbanks (XLA matmul-DFT path)
    Yp_host = None

    def _ana(xx):
        return analysis_half_real_tm(xx, hj, p, packed=True)

    family("analysis_fb", 1e-4, _both, _ana, x)
    Yp_host = np.asarray(jax.jit(_ana)(x))

    def _syn(Y):
        return synthesis_half_real_tm(jnp.moveaxis(Y, 0, 0)[:, :, 0, :], gj, p)

    family("synthesis_fb", 1e-4, _both, _syn, Yp_host)

    # 3: the flagship chain: XLA analysis -> GSC-RLS + Zelinski recursion
    # (the Pallas kernel on a GPU, the XLA scan elsewhere) -> XLA synthesis,
    # against the XLA scan on the CPU
    F = p.M // 2 + 1

    def _chain_dev(xx):
        Yr = analysis_half_real_tm(xx, hj, p)
        e = bf.frame_energy_half(jax.lax.complex(Yr[:, :, 0, :F], Yr[:, :, 0, F:]), p.M)
        if jax.default_backend() == "gpu":
            Y = gsc_rls_zelinski(Yr, e, wqH, BmH, ta, cfg, 0.6, 1, 2)
        else:
            X = jnp.moveaxis(jax.lax.complex(Yr[..., :F], Yr[..., F:]), -2, -1)
            Y = gsc_postfilter_fused(X, e, _cc(wqH), _cc(BmH), _cc(ta), "rls",
                                     cfg, 0.6, 1, 2)
        return synthesis_half_tm(Y, gj, p)

    def _chain_xla(xx):
        Yr = analysis_half_real_tm(xx, hj, p, packed=True)
        Y = gsc_postfilter_fused(Yr, None, _cc(wqH), _cc(BmH), _cc(ta), "rls",
                                 cfg, 0.6, 1, 2, True)
        return synthesis_half_real_tm(Y, gj, p)

    def _chain_both():
        dev = np.asarray(jax.jit(_chain_dev)(x))
        cpu0 = jax.local_devices(backend="cpu")[0]
        with jax.default_device(cpu0):
            ref = np.asarray(jax.jit(_chain_xla)(jax.device_put(x, cpu0)))
        return _rel(dev, ref)

    family("gsc_rls_zelinski", 2e-3, _chain_both)

    # 4: Zelinski postfilter (complex einsum path)
    Xc = (rng.standard_normal((200, 129, C)) +
          1j * rng.standard_normal((200, 129, C))).astype(np.complex64)

    def _zel(Xr, Xi):
        X = jax.lax.complex(Xr, Xi)
        Y = jnp.einsum("fc,tfc->tf", jnp.conj(_cc(wqH)), X,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.abs(zelinski_postfilter(X, Y, _cc(ta), 0.6, 2, 2))

    family("zelinski_pf", 2e-3, _both, _zel, Xc.real.copy(), Xc.imag.copy())

    # 5: WPE multichannel (lag covariances + batched Cholesky solve)
    Xw = (rng.standard_normal((C, 150, 129)) +
          1j * rng.standard_normal((C, 150, 129))).astype(np.complex64) * 100

    def _wpe(Xr, Xi):
        return jnp.abs(wpe_multichannel(jax.lax.complex(Xr, Xi), 2, 4, 1))

    family("wpe", 2e-3, _both, _wpe, Xw.real.copy(), Xw.imag.copy())

    # 6/7: AEC scans (NLMS + Kalman)
    Vc = (rng.standard_normal((300, 129)) +
          1j * rng.standard_normal((300, 129))).astype(np.complex64) * 50
    Ac = (0.3 * Vc + 0.1 * (rng.standard_normal((300, 129)) +
          1j * rng.standard_normal((300, 129)))).astype(np.complex64)

    def _nlms(Vr, Vi, Ar, Ai):
        E, _ = nlms_aec(jax.lax.complex(Vr, Vi), jax.lax.complex(Ar, Ai))
        return jnp.abs(E)

    def _kal(Vr, Vi, Ar, Ai):
        E, _ = kalman_aec(jax.lax.complex(Vr, Vi), jax.lax.complex(Ar, Ai))
        return jnp.abs(E)

    aec_args = (Vc.real.copy(), Vc.imag.copy(), Ac.real.copy(), Ac.imag.copy())
    family("aec_nlms", 2e-3, _both, _nlms, *aec_args)
    family("aec_kalman", 2e-3, _both, _kal, *aec_args)

    # 8: SRP-PHAT steering search (einsum over the steering table)
    def _srp(Xr, Xi):
        return srp_phat(jax.lax.complex(Xr, Xi), _cc(steer), 1, None)

    # 2e-3: PHAT normalization divides by per-bin magnitudes
    family("srp_phat", 2e-3, _both, _srp, Xc.real.copy(), Xc.imag.copy())

    # 9: MFCC feature chain (framing, mel filterbank, DCT)
    def _mfcc(xx):
        return mfcc(xx, samplerate=fs)

    # 2e-2: the log of small mel energies amplifies the relative error of
    # the device FFT
    family("mfcc", 2e-2, _both, _mfcc, x[0, 0])

    # 10: overlap-add FIR (FFT path)
    fir = rng.standard_normal(64).astype(np.float32)

    def _ola(xx):
        return overlap_add_filter(xx, jnp.asarray(fir))

    family("overlap_add", 1e-4, _both, _ola, x[0, 0])

    # 11: SOS covariance + MVDR solve (batched hermitian linalg)
    def _mvdr(Xr, Xi):
        X = jax.lax.complex(Xr, Xi)  # [T, F, C]
        R = jnp.einsum("tfc,tfd->fcd", X, jnp.conj(X),
                       precision=jax.lax.Precision.HIGHEST) / X.shape[0]
        R = R + 1e-3 * jnp.trace(R, axis1=-2, axis2=-1)[..., None, None] * (
            jnp.eye(C, dtype=R.dtype))
        w = jnp.linalg.solve(R, _cc(ta)[..., None])[..., 0]
        return jnp.abs(w)

    family("mvdr_solve", 2e-3, _both, _mvdr, Xc.real.copy(), Xc.imag.copy())

    errs = {k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in out.items()}
    ok = all(isinstance(out[k], float) and out[k] <= budgets[k] for k in out)
    return {"ok": ok, "families": errs,
            "budgets": {k: budgets[k] for k in out},
            "note": "device vs CPU per family; the CPU side is anchored by "
                    "the compiled-golden suite (tests/test_cpp_golden*.py)"}


if __name__ == "__main__":
    import json

    print(json.dumps(run()))
