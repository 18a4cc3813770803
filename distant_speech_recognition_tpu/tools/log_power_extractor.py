"""Log-power feature extractor — mirror of unit_test/log_power_extractor.py
(SampleFeature -> HammingFeature -> FFTFeature -> SpectralPower -> Log,
dumped as the reference's sequence-of-pickled-vectors format)."""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_path, output_path, D=160, fft_len=256, samplerate=None):
    from ..models.features import (
        fft_feature,
        frame_signal,
        hamming_window,
        log_feature,
        spectral_power,
    )
    from ..utils.wavio import read_wav

    x, rate = read_wav(input_path, normalize=False)
    # pad_zeros=False: only whole D-sample blocks (feature.cc:626-640)
    x0 = x[0][: (x.shape[-1] // D) * D]
    frames = frame_signal(x0, D, D)
    windowed = hamming_window(frames)
    spec = fft_feature(windowed, fft_len)
    power = spectral_power(spec, fft_len // 2 + 1)
    logp = np.asarray(log_feature(power))

    if output_path:
        with open(output_path, "wb") as ofp:
            for vec in logp:
                pickle.dump(np.asarray(vec), ofp, protocol=2)
    return logp


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="log power feature extraction")
    ap.add_argument("-i", dest="input_path", required=True)
    ap.add_argument("-o", dest="output_path", default="log_power.pickle")
    ap.add_argument("-D", dest="D", default=160, type=int, help="frame shift")
    ap.add_argument("-f", dest="fft_len", default=256, type=int)
    args = ap.parse_args()
    logp = run(args.input_path, args.output_path, args.D, args.fft_len)
    for frame_no, vec in enumerate(logp):
        print("fr. {}: {}..".format(
            frame_no,
            np.array2string(vec[:10], formatter={"float_kind": lambda v: "%.2f" % v}),
        ))


if __name__ == "__main__":
    main()
