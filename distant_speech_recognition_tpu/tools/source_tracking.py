"""Speaker tracking driver — mirror of unit_test/test_source_tracking.py
(confs/{ekfst,iekfst}.json): GCC-PHAT pair TDOAs -> EKF/IEKF track JSON."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def run(input_audio_paths, out_path, ap_conf, samplerate=16000):
    from ..models import localization as loc
    from ..models import tracking as trk
    from ..models.features import frame_signal, hamming_window
    from ..utils.wavio import read_wav

    tr = ap_conf.get("tracker", {})
    td = ap_conf.get("tdoae", tr)  # ekfst.json nests TDOA params under "tracker"
    fftlen = td.get("fftlen", 16384)
    shiftlen = td.get("shiftlen", fftlen // 2)
    pairs = [tuple(p) for p in td.get("pair_ids")] if td.get("pair_ids") else None
    mpos = np.asarray(ap_conf["microphone_positions"], dtype=np.float64)

    chans = [read_wav(p, normalize=False)[0][0] for p in input_audio_paths]
    n = min(len(c) for c in chans)
    x = np.stack([c[:n] for c in chans])
    if pairs is None:
        pairs = loc.mic_pairs(x.shape[0])

    frames = hamming_window(frame_signal(x, shiftlen, shiftlen))
    X = np.fft.rfft(np.asarray(frames), n=fftlen, axis=-1)

    delays, heights = [], []
    for (i, j) in pairs:
        cc = loc.gcc_phat(X[i].astype(np.complex64), X[j].astype(np.complex64),
                          fftlen, td.get("energy_threshold", 128))
        d, h = loc.tdoa_peaks(np.asarray(cc), samplerate)
        delays.append(np.asarray(d))
        heights.append(np.asarray(h))
    delays = np.stack(delays, axis=-1)  # [T, P]
    heights = np.stack(heights, axis=-1)

    _, mask, frame_valid = loc.tdoa_feature_vectors(
        delays, heights, td.get("cc_threshold", 0.12), td.get("minimum_pairs", 2)
    )

    cfg = trk.TrackerConfig(
        sigmaV2=tr.get("sigmaV2", 1.0e-4),
        sigmaK2=tr.get("sigmaK2", 1.0e-2),
        time_delta=shiftlen / samplerate,
        gate_prob=tr.get("gate_prob", 0.0),
        num_iterations=tr.get("num_iterations", 3 if tr.get("type") == "iekf" else 1),
        adjust_spherical=len(tr.get("initial_estimate", [0, 0, 0])) <= 2,
    )
    x0 = np.asarray(tr.get("initial_estimate", tr.get("initial_position", [1000.0, 1000.0, 0.0])),
                    np.float64)
    D = len(x0)
    F_mat = np.eye(D)
    U = np.eye(D) * tr.get("sigmaU2", tr.get("process_noise", 1.0))
    if D == 1:  # far-field linear-array azimuth tracking
        track = np.asarray(
            trk.fflinear_ekf_track(cfg, F_mat, U, x0, mpos, pairs, delays,
                                   np.asarray(mask), np.asarray(frame_valid))
        )
    else:
        track = np.asarray(
            trk.ekf_track(cfg, F_mat, U, x0, mpos, pairs, delays, np.asarray(mask),
                          np.asarray(frame_valid))
        )
    result = {"positions": track.tolist(),
              "frame_valid": np.asarray(frame_valid).tolist()}
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f)
        print("wrote", out_path)
    return track


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="EKF/IEKF source tracking on TDOAs")
    ap.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_path", default="out/track.json")
    ap.add_argument("-c", dest="conf_path", required=True)
    args = ap.parse_args()
    with open(args.conf_path) as f:
        ap_conf = json.load(f)
    run(args.input_audio_paths, args.out_path, ap_conf)


if __name__ == "__main__":
    main()
