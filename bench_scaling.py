"""Scaling-efficiency benchmark: the flagship pipeline batch-sharded over
1, N/2 and N of the available devices.

On one device this reports the 1-device number; on a multi-GPU host it
measures N-device throughput and efficiency vs linear scaling (BASELINE.json:
"measured scaling efficiency at 1 chip, 1 host, and N>=2 hosts").  Prints one
JSON line per device count.

Usage:  PYTHONPATH=. python bench_scaling.py
        (CPU smoke: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from distant_speech_recognition_tpu.utils.jaxenv import setup_compile_cache

    setup_compile_cache()
    from distant_speech_recognition_tpu.models.pipeline import (
        PipelineConfig,
        build_pipeline,
    )
    from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams
    from distant_speech_recognition_tpu.parallel import (
        make_mesh,
        shard_batch,
        snapshot_sharding,
    )
    from distant_speech_recognition_tpu.utils import geometry
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    M, m, r = 256, 4, 1
    C = 4
    fs = 16000
    secs = float(os.environ.get("BENCH_SECS", "10.0"))
    T = int(fs * secs)
    per_dev_B = int(os.environ.get("BENCH_BATCH_PER_DEV", "384"))

    cfg = PipelineConfig(
        fb=FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2),
        samplerate=float(fs),
        beamformer="gsc_rls",
        postfilter="zelinski",
        pf_min_frames=2,
    )
    h, g = load_pair(M, m, r)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)

    devices = jax.devices()
    counts = sorted({1, max(1, len(devices) // 2), len(devices)})
    base = None
    for n in counts:
        mesh = make_mesh(devices=devices[:n], batch=n, freq=1)
        fn = build_pipeline(cfg, mpos, delays, h, g,
                            bin_sharding=snapshot_sharding(mesh, batched=False))
        B = per_dev_B * n
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32)
        with jax.set_mesh(mesh):
            xs = shard_batch(mesh, x)
            jax.block_until_ready(fn(xs))  # compile + warm
            iters = 3
            t0 = time.perf_counter()
            for _ in range(iters):
                y = fn(xs)
            jax.block_until_ready(y)
            dt = (time.perf_counter() - t0) / iters
        thr = B * secs / dt
        per_chip = thr / n
        if base is None:
            base = per_chip
        print(
            json.dumps(
                {
                    "metric": "scaling_audio_seconds_per_s",
                    "devices": n,
                    "value": round(thr, 2),
                    "per_chip": round(per_chip, 2),
                    "efficiency": round(per_chip / base, 3),
                    "unit": "audio-s/s",
                }
            )
        )


if __name__ == "__main__":
    sys.exit(main())
