"""Analysis->synthesis reconstruction check — CLI mirror of
tools/filterbank/test_oversampled_dft_filter.py (prints RMSE and the
amplification ratio)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(analysis_filter_path, synthesis_filter_path, M, m, r, audio_path, out_path,
        samplerate=16000):
    from ..ops.filterbank import FilterbankParams, analysis, synthesis
    from ..utils.prototypes import load_pair, load_prototype
    from ..utils.wavio import read_wav, write_wav

    if analysis_filter_path and os.path.exists(analysis_filter_path):
        h = load_prototype(analysis_filter_path)
        g = load_prototype(synthesis_filter_path)
    else:
        h, g = load_pair(M, m, r)
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    x, rate = read_wav(audio_path)
    x = x[0]
    y = np.asarray(synthesis(analysis(x, h, p), g, p))
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        write_wav(out_path, y, rate)
    n = min(len(x), len(y))
    diff = y[:n] - x[:n]
    rmse = float(np.sqrt(np.inner(diff, diff) / n))
    nz = y[:n] > 0
    ratio = float(np.mean(np.abs(x[:n][nz] / y[:n][nz]))) if nz.any() else float("nan")
    print("RMSE: {}".format(rmse))
    print("Amplification ratio: {}".format(ratio))
    return rmse


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="oversampled DFT filterbank reconstruction test")
    ap.add_argument("-a", dest="analysis_filter_path", default=None)
    ap.add_argument("-s", dest="synthesis_filter_path", default=None)
    ap.add_argument("-M", dest="M", default=64, type=int)
    ap.add_argument("-m", dest="m", default=4, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("-i", dest="audio_path", required=True)
    ap.add_argument("-o", dest="out_path", default=None)
    args = ap.parse_args()
    run(args.analysis_filter_path, args.synthesis_filter_path, args.M, args.m,
        args.r, args.audio_path, args.out_path)


if __name__ == "__main__":
    main()
