"""Synthesize a multichannel WAV from mono files — mirror of
src/synthMultiChannelWav.cc."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_paths, out_path):
    from ..utils.wavio import read_wav, write_wav

    chans = []
    rate = None
    for p in input_paths:
        x, r = read_wav(p)
        chans.append(x[0])
        rate = r
    n = min(len(c) for c in chans)
    data = np.stack([c[:n] for c in chans])
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_wav(out_path, data, rate)
    print("wrote", out_path, data.shape)


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="merge mono wavs into one multichannel wav")
    ap.add_argument("-i", dest="input_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_path", required=True)
    args = ap.parse_args()
    run(args.input_paths, args.out_path)


if __name__ == "__main__":
    main()
