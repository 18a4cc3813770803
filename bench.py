"""Benchmark: audio-seconds/s per device through the enhancement chains.

Runs on one GPU, in one process, and prints one JSON line.  The headline is
the flagship chain (analysis -> GSC-RLS + Zelinski -> synthesis; M=256, m=4,
r=1, 4 channels, 16 kHz, 10 s utterances, B=256 per call).  Sections:

- ``selfcheck``: the recursion kernel against the XLA scan end to end, on
  2 s rows (<= 1e-4) and at the full width (<= 2e-3, the adaptive-chain
  budget: any bit-different f32 implementation of the gated RLS loop drifts
  apart over many frames);
- ``nan_trigger``: near-silent top bins, finite and within 1e-4;
- ``stages``: XLA analysis / recursion (kernel and XLA scan) / XLA synthesis
  device times at the flagship width, each placed against the card's peaks;
- ``flagship_ab``: the flagship end to end with the kernel and with the XLA
  scan, alternating (kernel, xla, xla, kernel);
- the other cells: fixed-weight D&S and SD-MVDR + Zelinski, config 4
  (NLMS-AEC -> WPE -> GSC-RLS -> Zelinski), config 5 (72-point SRP-PHAT ->
  steered GSC-RLS + Zelinski), the batch-sharded mode on a 1-device mesh,
  single-stream streaming, and the per-family device_golden errors.

A section that fails raises, and the run fails with it.  Times are host
clock around work that ends in ``jax.block_until_ready``; every per-call
time is listed, with the compile time of the first call apart.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks by ``device_kind``, dense rates without sparsity, at the
# full power limit (NVIDIA H100 data sheet, SXM part).  The DFT matmuls run
# at precision=HIGHEST, i.e. f32 outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "f32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "source": "NVIDIA H100 data sheet (SXM)",
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table entry for a device; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks recorded for device_kind {device_kind!r}") from None


def card_info() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def timed(fn, *args, iters: int = 5) -> dict:
    """Compile/warm with one call, then ``iters`` calls each synced with
    ``block_until_ready``; seconds per call, unrounded."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    per = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        per.append(time.perf_counter() - t0)
    return {"first_call_s": first, "per_call_s": per,
            "median_s": float(np.median(per))}


def _throughput(B, secs, t):
    return B * secs / t["median_s"]


def main():
    import jax

    from distant_speech_recognition_tpu.utils.jaxenv import setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {jax.default_backend()!r}")

    from distant_speech_recognition_tpu.models.pipeline import build_pipeline, path_flags
    from distant_speech_recognition_tpu.utils import gpu_checks as gc
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    dev = jax.devices()[0]
    kind = dev.device_kind
    pk = peaks(kind)
    B = int(os.environ.get("BENCH_BATCH", "256"))
    secs = float(os.environ.get("BENCH_SECS", "10.0"))
    C = 4

    cfg = gc.flagship_config()
    h, g = load_pair(256, 4, 1)
    mpos, delays = gc.array_geometry(C)
    x = gc.signals(B, secs)
    xd = jax.device_put(x)

    out = {
        "metric": "audio_seconds_per_s_per_device",
        "unit": "audio-s/s/device",
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
        "card": card_info(),
        "peaks": pk,
        "batch": B,
        "secs": secs,
        "route": path_flags(cfg, C),
    }

    # --- selfcheck + NaN trigger ------------------------------------------
    short = gc.kernel_vs_xla(x[:8, :, : 2 * gc.FS], cfg)
    full = gc.kernel_vs_xla(x, cfg)
    out["selfcheck"] = {"rows_2s": short, "full_width": full,
                        "tol_2s": 1e-4, "tol_full": 2e-3}
    if not (short["finite"] and short["rel"] <= 1e-4
            and full["finite"] and full["rel"] <= 2e-3):
        raise AssertionError(f"kernel vs XLA scan: {out['selfcheck']}")
    nt = gc.nan_trigger(cfg)
    out["nan_trigger"] = nt
    if not (nt["finite"] and nt["rel"] <= 1e-4):
        raise AssertionError(f"near-silent-bin trigger: {nt}")

    # --- per-stage device times -------------------------------------------
    out["stages"] = _stages(cfg, h, g, mpos, delays, xd, pk)

    # --- flagship, kernel vs XLA scan, alternating -------------------------
    fns = {}
    for route in ("kernel", "xla"):
        with gc.scan_route(route == "kernel"):
            fns[route] = build_pipeline(cfg, mpos, delays, h, g)
    ab = {"kernel": [], "xla": []}
    for route in ("kernel", "xla", "xla", "kernel"):
        ab[route].append(timed(fns[route], xd, iters=3))
    del fns
    out["flagship_ab"] = {
        r: {"audio_s_per_s": [_throughput(B, secs, t) for t in ts], "runs": ts}
        for r, ts in ab.items()
    }

    # --- headline: the default route ----------------------------------------
    fn = build_pipeline(cfg, mpos, delays, h, g)
    t = timed(fn, xd)
    del fn
    out["value"] = _throughput(B, secs, t)
    out["flagship"] = t

    # --- fixed-weight chains ----------------------------------------------
    out["fixed_weight"] = {}
    for bftype in ("ds", "sd_mvdr"):
        cfgf = dataclasses.replace(cfg, beamformer=bftype)
        t = timed(build_pipeline(cfgf, mpos, delays, h, g), xd, iters=3)
        out["fixed_weight"][bftype] = {"audio_s_per_s": _throughput(B, secs, t), **t}

    # --- config 4: NLMS-AEC -> WPE -> GSC-RLS -> Zelinski -------------------
    B4 = int(os.environ.get("BENCH_CONFIG4_BATCH", "256"))
    cfg4 = dataclasses.replace(cfg, aec="nlms", wpe=True, wpe_iterations=2)
    fn4 = build_pipeline(cfg4, mpos, delays, h, g)
    play = jax.device_put(gc.signals(B4, secs, seed=1, n_chan=1)[:, 0])
    t = timed(fn4, xd[:B4], play, iters=3)
    del fn4, play
    out["config4"] = {"audio_s_per_s": _throughput(B4, secs, t), "batch": B4,
                      "route": path_flags(cfg4, C), **t}

    # --- config 5: SRP-PHAT (72-point grid) -> steered GSC-RLS + Zelinski ---
    from distant_speech_recognition_tpu.models.steered import build_steered_pipeline

    B5 = int(os.environ.get("BENCH_CONFIG5_BATCH", "64"))
    ang = 2 * np.pi * np.arange(C) / C
    mpos5 = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    phis = np.deg2rad(np.arange(0.0, 360.0, 5.0))
    fn5 = build_steered_pipeline(cfg, mpos5, h, g, thetas=[np.pi / 2], phis=phis)
    t = timed(fn5, xd[:B5], iters=3)
    del fn5
    out["config5"] = {"audio_s_per_s": _throughput(B5, secs, t), "batch": B5,
                      "grid": int(len(phis)), **t}

    # --- batch-sharded mode on a 1-device mesh ------------------------------
    from distant_speech_recognition_tpu.parallel import make_mesh, shard_batch, snapshot_sharding

    mesh1 = make_mesh(devices=jax.devices()[:1], batch=1, freq=1)
    fnb = build_pipeline(cfg, mpos, delays, h, g,
                         bin_sharding=snapshot_sharding(mesh1, batched=False))
    with jax.set_mesh(mesh1):
        t = timed(fnb, shard_batch(mesh1, x), iters=3)
    del fnb
    out["batch_sharded"] = {"audio_s_per_s": _throughput(B, secs, t), **t}

    # --- streaming and device goldens ---------------------------------------
    from distant_speech_recognition_tpu.utils import device_golden, streaming_bench

    out["streaming"] = streaming_bench.run()
    dg = device_golden.run()
    out["device_golden"] = dg
    if not dg["ok"]:
        raise AssertionError(f"device_golden over budget: {dg}")
    print(json.dumps(out))


def _stages(cfg, h, g, mpos, delays, xd, pk):
    """Device time of each stage of the flagship split (XLA analysis ->
    recursion -> XLA synthesis), with the analytic minimum bytes and FLOPs
    of each stage placed against the card's peaks (the estimates ignore XLA
    temporaries, so a fraction is a lower bound on achieved utilization)."""
    import jax
    import jax.numpy as jnp

    from distant_speech_recognition_tpu.models.adaptive_gsc import gsc_postfilter_fused, gsc_weights
    from distant_speech_recognition_tpu.models.beamforming import array_manifold, frame_energy_half
    from distant_speech_recognition_tpu.models.scan_kernel import gsc_rls_zelinski
    from distant_speech_recognition_tpu.ops.filterbank import (
        analysis_half_real_tm,
        num_analysis_frames,
        synthesis_half_tm,
    )
    from distant_speech_recognition_tpu.utils.jaxenv import host_device

    fb = cfg.fb
    M, m = fb.M, fb.m
    F = M // 2 + 1
    B, C, T = xd.shape
    with host_device():
        wqH, BmH = gsc_weights(M, cfg.samplerate, delays, cfg.Nc)
        ta = array_manifold(M, cfg.samplerate, delays)
        wqH, BmH, ta = np.asarray(wqH), np.asarray(BmH), np.asarray(ta)
    Bc = BmH.shape[1]
    Tf = num_analysis_frames(fb, T)
    pf = (cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)

    ana = jax.jit(lambda x: analysis_half_real_tm(x, h, fb))

    @jax.jit
    def energy(Yr):
        return frame_energy_half(jax.lax.complex(Yr[:, :, 0, :F], Yr[:, :, 0, F:]), M)

    kern = jax.jit(lambda Yr, e: gsc_rls_zelinski(Yr, e, wqH, BmH, ta, cfg.rls, *pf))

    @jax.jit
    def xla_scan(Yr, e):
        X = jnp.moveaxis(jax.lax.complex(Yr[..., :F], Yr[..., F:]), -2, -1)
        return gsc_postfilter_fused(X, e, jnp.asarray(wqH), jnp.asarray(BmH),
                                    jnp.asarray(ta), "rls", cfg.rls, *pf)

    syn = jax.jit(lambda Y: synthesis_half_tm(Y, g, fb))

    nP = C * (C - 1) // 2
    state = Bc * (Bc + 1) + 2 * Bc + 2 * nP + 2  # f32 per lane: Pz, wa, CSDs
    spec = 4 * Tf * B * C * 2 * F
    est = {
        "analysis": {"bytes": 4 * B * C * T + spec,
                     "flops": Tf * B * C * (2 * M * m + 2 * M * 2 * F)},
        "recursion_kernel": {"bytes": spec + 8 * Tf * B * F,
                             "flops": Tf * B * F * (8 * C + 6 * Bc * Bc + 4 * nP)},
        "synthesis": {"bytes": 8 * Tf * B * F + 4 * B * T,
                      "flops": Tf * B * (2 * 2 * F * M + 2 * M * m)},
    }
    # the XLA scan also reads and writes the adaptive state every frame
    est["recursion_xla_scan"] = {
        "bytes": est["recursion_kernel"]["bytes"] + 8 * Tf * B * F * state,
        "flops": est["recursion_kernel"]["flops"],
    }

    Yr = jax.block_until_ready(ana(xd))
    e = jax.block_until_ready(energy(Yr))
    times = {
        "analysis": timed(ana, xd, iters=3),
        "energy_prepass": timed(energy, Yr, iters=3),
        "recursion_kernel": timed(kern, Yr, e, iters=3),
        "recursion_xla_scan": timed(xla_scan, Yr, e, iters=3),
    }
    Y = jax.block_until_ready(kern(Yr, e))
    del Yr
    times["synthesis"] = timed(syn, Y, iters=3)
    del Y

    out = {"batch": B, "frames": Tf}
    for name, t in times.items():
        row = {"median_ms": t["median_s"] * 1e3, "per_call_s": t["per_call_s"]}
        if name in est:
            gb, gf = est[name]["bytes"] / 1e9, est[name]["flops"] / 1e9
            hbm = gb / t["median_s"] / pk["hbm_gbps"]
            f32 = gf / t["median_s"] / 1e3 / pk["f32_tflops"]
            row.update(est_gb=gb, est_gflop=gf, hbm_frac=hbm, f32_frac=f32,
                       bound="hbm" if hbm >= f32 else "f32")
        out[name] = row
    return out


if __name__ == "__main__":
    sys.exit(main())
