"""Streaming (online, chunked) beamforming driver.

Same flag/config surface as tools/online_beamforming.py but processes the
input in fixed chunks through models/streaming.StreamingEnhancer — the
low-latency mode, with optional mid-stream checkpoint/resume:

    --chunk N           chunk size in samples (default 4096)
    --checkpoint PATH   write the pipeline state after every chunk
    --resume PATH       restore state before processing (continue a stream)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(analysis_filter_path, synthesis_filter_path, M, m, r,
        input_audio_paths, out_path, ap_conf, samplerate=16000,
        chunk=4096, checkpoint=None, resume=None):
    from ..models.streaming import StreamingEnhancer
    from ..ops.filterbank import FilterbankParams
    from ..utils.checkpoint import load_pytree, save_pytree
    from ..utils.config import parse_ap_conf
    from ..utils.prototypes import load_pair, load_prototype
    from ..utils.wavio import read_wav, write_wav

    if analysis_filter_path and os.path.exists(analysis_filter_path):
        h = load_prototype(analysis_filter_path)
        g = load_prototype(synthesis_filter_path)
    else:
        h, g = load_pair(M, m, r)

    fb = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    cfg, mpos, delays, extra = parse_ap_conf(ap_conf, fb, samplerate)

    x = np.stack([read_wav(p, normalize=False)[0][0] for p in input_audio_paths])  # [C, T]
    se = StreamingEnhancer(cfg, mpos, delays, h, g)
    if resume:
        se.restore(load_pytree(resume))

    outs = []
    for start in range(0, x.shape[1], chunk):
        outs.append(se.process(x[:, start : start + chunk]))
        if checkpoint:
            save_pytree(checkpoint, se.checkpoint())
    outs.append(se.flush())
    y = np.concatenate(outs)

    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        write_wav(out_path, y, samplerate, normalized=False)

    total_energy = float(np.sum(y.astype(np.float64) ** 2))
    frame_no = max(len(y) // fb.D, 1)
    print("Avg. output power: %f" % (total_energy / frame_no))
    print("%d frames processed" % frame_no)
    return total_energy, frame_no


def build_parser():
    parser = argparse.ArgumentParser(description="run streaming subband beamforming (batched JAX)")
    parser.add_argument("-a", dest="analysis_filter_path", default=None)
    parser.add_argument("-s", dest="synthesis_filter_path", default=None)
    parser.add_argument("-M", dest="M", default=256, type=int)
    parser.add_argument("-m", dest="m", default=4, type=int)
    parser.add_argument("-r", dest="r", default=1, type=int)
    parser.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    parser.add_argument("-o", dest="out_path", default="out/beamformed.wav")
    parser.add_argument("-c", dest="ap_conf_path", default=None)
    parser.add_argument("--chunk", dest="chunk", default=4096, type=int)
    parser.add_argument("--checkpoint", dest="checkpoint", default=None)
    parser.add_argument("--resume", dest="resume", default=None)
    return parser


def main():
    setup_compile_cache()
    import json

    args = build_parser().parse_args()
    if args.ap_conf_path:
        with open(args.ap_conf_path) as f:
            ap_conf = json.load(f)
    else:
        ap_conf = {}
    run(args.analysis_filter_path, args.synthesis_filter_path,
        args.M, args.m, args.r, args.input_audio_paths, args.out_path,
        ap_conf, chunk=args.chunk, checkpoint=args.checkpoint,
        resume=args.resume)


if __name__ == "__main__":
    main()
