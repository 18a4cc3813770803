"""Subband acoustic echo cancellation driver — mirror of
unit_test/test_subband_aec.py (confs/nlms_aec.json schema)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(M, m, r, played_path, recorded_path, out_path, conf, samplerate=16000):
    from ..models import aec
    from ..ops.filterbank import FilterbankParams, analysis, hermitian_mirror, synthesis
    from ..utils.prototypes import load_pair
    from ..utils.wavio import read_wav, write_wav

    h, g = load_pair(M, m, r)
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    v = read_wav(played_path, normalize=False)[0][0]
    a = read_wav(recorded_path, normalize=False)[0][0]
    n = min(len(v), len(a))
    V = np.asarray(analysis(v[:n], h, p))[..., : M // 2 + 1]
    A = np.asarray(analysis(a[:n], h, p))[..., : M // 2 + 1]

    atype = conf.get("type", "nlms")
    if atype == "nlms":
        E, _ = aec.nlms_aec(V, A, conf.get("delta", 100.0), conf.get("epsilon", 1e-4),
                            conf.get("energy_threshold", 100.0))
    elif atype == "kalman_filter":
        E, _ = aec.kalman_aec(V, A, conf.get("beta", 0.95), conf.get("sigmau2", 1e-3),
                              conf.get("energy_threshold", 100.0))
    elif atype == "block_kalman_filter":
        E, _ = aec.block_kalman_aec(V, A, conf.get("filter_length", 2),
                                    conf.get("beta", 0.95), conf.get("sigmau2", 1e-3),
                                    conf.get("sigmak2", 5.0), conf.get("energy_threshold", 100.0),
                                    conf.get("amp4play", 1.0))
    elif atype == "dtd_block_kalman_filter":
        E, _ = aec.dtd_block_kalman_aec(V, A, conf.get("filter_length", 2))
    elif atype == "information_filter":
        E, _ = aec.information_filter_aec(V, A, conf.get("filter_length", 2))
    elif atype == "square_root_information_filter":
        E, _ = aec.sqrt_information_filter_aec(V, A, conf.get("filter_length", 2))
    else:
        raise KeyError(f"unknown AEC type {atype!r}")

    y = np.asarray(synthesis(hermitian_mirror(np.asarray(E), M), g, p))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_wav(out_path, y, samplerate, normalized=False)
    print("wrote", out_path, "residual power %.4e" % float((y**2).mean()))
    return y


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="subband AEC")
    ap.add_argument("-M", dest="M", default=256, type=int)
    ap.add_argument("-m", dest="m", default=4, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("-p", dest="played", required=True, help="far-end (played) wav")
    ap.add_argument("-i", dest="recorded", required=True, help="mic (recorded) wav")
    ap.add_argument("-o", dest="out_path", default="out/aec.wav")
    ap.add_argument("-c", dest="conf_path", default=None)
    args = ap.parse_args()
    conf = {}
    if args.conf_path:
        with open(args.conf_path) as f:
            conf = json.load(f)
    run(args.M, args.m, args.r, args.played, args.recorded, args.out_path, conf)


if __name__ == "__main__":
    main()
