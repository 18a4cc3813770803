"""Subband WPE dereverberation driver — mirror of
unit_test/test_subband_dereverberator.py (confs/wpe.json schema:
dereverberator{type: wpe|mc_wpe, lower_num, upper_num, iterations_num}).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(M, m, r, input_audio_paths, out_prefix, conf, samplerate=16000):
    from ..models.dereverberation import wpe, wpe_multichannel
    from ..ops.filterbank import FilterbankParams, analysis, hermitian_mirror, synthesis
    from ..utils.prototypes import load_pair
    from ..utils.wavio import read_wav, write_wav

    h, g = load_pair(M, m, r)
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    dv = conf.get("dereverberator", conf)  # confs/wpe.json uses flat keys
    lowerN = dv.get("lower_num", 0)
    upperN = dv.get("upper_num", 32)
    iters = dv.get("iterations_num", 2)
    load_db = dv.get("load_db", -20.0)
    diagonal_bias = dv.get("diagonal_bias", 0.0)
    dtype = dv.get("type", "wpe")

    x = np.stack([read_wav(pth, normalize=False)[0][0] for pth in input_audio_paths])
    Y = np.asarray(analysis(x, h, p))[..., : M // 2 + 1]  # [C, T, F]
    if dtype == "mc_wpe" and Y.shape[0] > 1:
        Z = np.asarray(wpe_multichannel(Y, lowerN, upperN, iters, load_db, diagonal_bias))
    else:
        Z = np.stack([np.asarray(wpe(Y[c], lowerN, upperN, iters, load_db)) for c in range(Y.shape[0])])
    outs = []
    for c in range(Z.shape[0]):
        y = np.asarray(synthesis(hermitian_mirror(Z[c], M), g, p))
        outp = f"{out_prefix}_c{c + 1}.wav" if Z.shape[0] > 1 else f"{out_prefix}.wav"
        d = os.path.dirname(outp)
        if d:
            os.makedirs(d, exist_ok=True)
        write_wav(outp, y, samplerate, normalized=False)
        outs.append(outp)
        print("wrote", outp)
    return outs


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="subband WPE dereverberation")
    ap.add_argument("-M", dest="M", default=256, type=int)
    ap.add_argument("-m", dest="m", default=4, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_prefix", default="out/dereverbed")
    ap.add_argument("-c", dest="conf_path", default=None)
    args = ap.parse_args()
    conf = {}
    if args.conf_path:
        with open(args.conf_path) as f:
            conf = json.load(f)
    run(args.M, args.m, args.r, args.input_audio_paths, args.out_prefix, conf)


if __name__ == "__main__":
    main()
