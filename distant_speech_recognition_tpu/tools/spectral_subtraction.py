"""Spectral subtraction driver — mirror of src/ss.cc: estimate the noise PSD
from the first seconds (or a noise file) and subtract."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_path, out_path, M=256, m=4, r=1, noise_seconds=1.0,
        ft=1.0, flooring=0.001, samplerate=16000):
    from ..models.postfilter import average_noise_psd, spectral_subtract
    from ..ops.filterbank import FilterbankParams, analysis, hermitian_mirror, synthesis
    from ..utils.prototypes import load_pair
    from ..utils.wavio import read_wav, write_wav

    h, g = load_pair(M, m, r)
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    x, rate = read_wav(input_path, normalize=False)
    X = np.asarray(analysis(x[0], h, p))[..., : M // 2 + 1]
    n_frames = max(int(noise_seconds * rate / p.D), 1)
    npsd = average_noise_psd(X[:n_frames])
    S = np.asarray(spectral_subtract(X, np.asarray(npsd), ft, flooring))
    y = np.asarray(synthesis(hermitian_mirror(S, M), g, p))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_wav(out_path, y, rate, normalized=False)
    print("wrote", out_path)
    return y


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="spectral subtraction")
    ap.add_argument("-i", dest="input_path", required=True)
    ap.add_argument("-o", dest="out_path", default="out/ss.wav")
    ap.add_argument("-M", dest="M", default=256, type=int)
    ap.add_argument("-m", dest="m", default=4, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("--noise-seconds", type=float, default=1.0)
    ap.add_argument("--ft", type=float, default=1.0)
    ap.add_argument("--floor", type=float, default=0.001)
    args = ap.parse_args()
    run(args.input_path, args.out_path, args.M, args.m, args.r,
        args.noise_seconds, args.ft, args.floor)


if __name__ == "__main__":
    main()
