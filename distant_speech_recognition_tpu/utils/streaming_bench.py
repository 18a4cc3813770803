"""Streaming-latency micro-benchmark (bench.py `streaming` section).

Run as a module for a JSON line: per-chunk p50/p99 latency and realtime
factor of `models.streaming.StreamingEnhancer` at 16- and 64-frame chunks,
single stream (the B=1 deployment mode; the reference's pull-per-frame
loop, stream/stream.h:16-88).  Latency is host to host: the chunk goes to
the device, the enhanced samples come back to the host.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["run"]


def run(flagship: bool = True):
    from ..models.pipeline import PipelineConfig
    from ..models.streaming import StreamingEnhancer
    from ..utils import geometry
    from ..utils.prototypes import load_pair

    C = 4
    fs = 16000
    h, g = load_pair(256, 4, 1)
    cfg = PipelineConfig(beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    rng = np.random.default_rng(3)
    res = {}
    for fpc in (16, 64):
        enh = StreamingEnhancer(cfg, mpos, delays, h, g,
                                frames_per_chunk=fpc)
        chunk = fpc * cfg.fb.D
        xs = (rng.standard_normal((110, C, chunk)) * 1500).astype(np.float32)
        enh.process(xs[0])  # compile + warm
        lats = []
        t_all0 = time.perf_counter()
        for i in range(1, 110):
            t0 = time.perf_counter()
            y = enh.process(xs[i])
            np.asarray(y)  # the caller gets host samples back
            lats.append(time.perf_counter() - t0)
        dt_all = time.perf_counter() - t_all0
        lats_ms = np.sort(np.array(lats) * 1e3)
        audio_per_chunk = chunk / fs
        res[f"chunk_{fpc}f"] = {
            "chunk_ms": round(audio_per_chunk * 1e3, 2),
            "p50_ms": round(float(lats_ms[len(lats_ms) // 2]), 3),
            "p99_ms": round(float(lats_ms[int(len(lats_ms) * 0.99)]), 3),
            "rtf": round((dt_all / 109) / audio_per_chunk, 4),
        }
    res["note"] = ("host-to-host latency per chunk, including the "
                   "host<->device transfers")
    return res


if __name__ == "__main__":
    import json

    print(json.dumps(run()))
