"""MFCC extraction driver — mirror of unit_test/mfcc_extractor.py:
WAV(s) -> MFCC matrices -> Kaldi feat ark."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_audio_paths, out_ark, samplerate=16000, ncep=13, filter_n=30):
    from ..models.features import mfcc
    from ..utils.kaldi_io import write_feat_ark
    from ..utils.wavio import read_wav

    utts = {}
    for path in input_audio_paths:
        x, rate = read_wav(path, normalize=False)
        cep = np.asarray(mfcc(x[0], samplerate=float(rate), ncep=ncep, filter_n=filter_n))
        uttid = os.path.splitext(os.path.basename(path))[0]
        utts[uttid] = cep
        print(uttid, cep.shape)
    d = os.path.dirname(out_ark)
    if d:
        os.makedirs(d, exist_ok=True)
    write_feat_ark(out_ark, utts)
    print("wrote", out_ark)
    return utts


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="MFCC extraction to Kaldi ark")
    ap.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_ark", default="out/mfcc.feat.ark")
    ap.add_argument("--ncep", type=int, default=13)
    ap.add_argument("--filters", type=int, default=30)
    args = ap.parse_args()
    run(args.input_audio_paths, args.out_ark, ncep=args.ncep, filter_n=args.filters)


if __name__ == "__main__":
    main()
