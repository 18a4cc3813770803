"""Online beamforming driver — CLI-compatible with the reference's
unit_test/test_online_beamforming.py (same -a/-s/-M/-m/-r/-i/-o/-c flags and
the same JSON config schema; prints the same summary line)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(analysis_filter_path, synthesis_filter_path, M, m, r,
        input_audio_paths, out_path, ap_conf, samplerate=16000):
    from ..models.pipeline import build_pipeline
    from ..ops.filterbank import FilterbankParams
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
    fn = build_pipeline(cfg, mpos, delays, h, g,
                        noise_delays=extra.get("noise_delays"))
    y = np.asarray(fn(x[None]))[0]

    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        write_wav(out_path, y, samplerate, normalized=False)

    total_energy = float(np.sum(y.astype(np.float64) ** 2))
    frame_no = len(y) // fb.D
    print("Avg. output power: %f" % (total_energy / frame_no))
    print("%d frames processed" % frame_no)
    return total_energy, frame_no


def build_parser():
    parser = argparse.ArgumentParser(description="run subband beamforming (batched JAX)")
    parser.add_argument("-a", dest="analysis_filter_path", default=None)
    parser.add_argument("-s", dest="synthesis_filter_path", default=None)
    parser.add_argument("-M", dest="M", default=256, type=int)
    parser.add_argument("-m", dest="m", default=4, type=int)
    parser.add_argument("-r", dest="r", default=1, type=int)
    parser.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    parser.add_argument("-o", dest="out_path", default="out/beamformed.wav")
    parser.add_argument("-c", dest="ap_conf_path", default=None)
    return parser


def main():
    setup_compile_cache()
    args = build_parser().parse_args()
    if args.ap_conf_path is None:
        ap_conf = {
            "array_type": "linear",
            "microphone_positions": [[-113.0, 0.0, 2.0], [36.0, 0.0, 2.0],
                                     [76.0, 0.0, 2.0], [113.0, 0.0, 2.0]],
            "target": {"positions": [[0.0, [-1.306379, None, None]]]},
            "beamformer": {"type": "super_directive"},
            "postfilter": {"type": "zelinski", "subtype": 2, "alpha": 0.7},
        }
    else:
        with open(args.ap_conf_path) as f:
            ap_conf = json.load(f)
    print(json.dumps(ap_conf, indent=4))
    run(args.analysis_filter_path, args.synthesis_filter_path,
        args.M, args.m, args.r, args.input_audio_paths, args.out_path, ap_conf)


if __name__ == "__main__":
    main()
