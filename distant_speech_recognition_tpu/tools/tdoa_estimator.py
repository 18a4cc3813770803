"""GCC-PHAT TDOA estimation driver — mirror of unit_test/test_tdoa_estimator.py
(confs/gcc_phat_tdoae.json schema); writes per-frame TDOA JSON trajectories."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_audio_paths, out_path, ap_conf, samplerate=16000):
    from ..models import localization as loc
    from ..ops.filterbank import stft_analysis
    from ..utils.wavio import read_wav

    td = ap_conf["tdoae"]
    fftlen = td.get("fftlen", 16384)
    shiftlen = td.get("shiftlen", fftlen // 2)
    pairs = [tuple(p) for p in td.get("pair_ids")] if td.get("pair_ids") else None
    chans = [read_wav(p, normalize=False)[0][0] for p in input_audio_paths]
    n = min(len(c) for c in chans)
    x = np.stack([c[:n] for c in chans])
    if pairs is None:
        pairs = loc.mic_pairs(x.shape[0])

    # windowed FFT per channel (Hamming, block = shiftlen like the reference's
    # SampleFeature(D=8192) -> Hamming -> FFT(2D) chain)
    from ..models.features import frame_signal, hamming_window

    frames = hamming_window(frame_signal(x, shiftlen, shiftlen))
    X = np.fft.rfft(np.asarray(frames), n=fftlen, axis=-1)

    results = []
    for (i, j) in pairs:
        cc = loc.gcc_phat(X[i].astype(np.complex64), X[j].astype(np.complex64),
                          fftlen, td.get("energy_threshold", 128))
        delays, heights = loc.tdoa_peaks(np.asarray(cc), samplerate)
        results.append({
            "pair": [int(i), int(j)],
            "delays": np.asarray(delays).tolist(),
            "cc": np.asarray(heights).tolist(),
        })
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f)
        print("wrote", out_path)
    return results


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="GCC-PHAT TDOA estimation")
    ap.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_path", default="out/tdoa.json")
    ap.add_argument("-c", dest="conf_path", required=True)
    args = ap.parse_args()
    with open(args.conf_path) as f:
        ap_conf = json.load(f)
    run(args.input_audio_paths, args.out_path, ap_conf)


if __name__ == "__main__":
    main()
