"""Batch SOS beamforming driver — mirror of
unit_test/test_sos_batch_beamforming.py (confs/{smimvdr,bmvdr_*,gev_*}.json):
two-pass processing — accumulate VAD/TF-mask-gated covariances, compute
SMI-MVDR / blind-MVDR / GEV weights, then apply and resynthesize."""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..utils.jaxenv import setup_compile_cache


def _load_tfmask(path):
    """Load a TF-mask file: a SEQUENCE of pickled per-frame band-activity
    vectors until EOF (load_tfmasks, test_sos_batch_beamforming.py:53-74;
    python2 pickles need latin1 — retry the whole stream on decode error)."""
    for encoding in (None, "latin1"):
        frames = []
        kw = {} if encoding is None else {"encoding": encoding}
        try:
            with open(path, "rb") as fp:
                while True:
                    try:
                        frames.append(pickle.load(fp, **kw))
                    except EOFError:
                        break
            return np.array(frames)
        except UnicodeDecodeError:
            continue
    raise IOError(f"cannot decode TF mask pickle stream {path}")


def run(M, m, r, input_audio_paths, out_path, ap_conf, samplerate=16000):
    from ..models import beamforming as bf
    from ..ops.filterbank import FilterbankParams, analysis, hermitian_mirror, synthesis
    from ..utils.config import target_delays
    from ..utils.prototypes import load_pair
    from ..utils.wavio import read_wav, write_wav

    h, g = load_pair(M, m, r)
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=2)
    bf_conf = ap_conf["beamformer"]
    btype = bf_conf["type"]
    energy_threshold = bf_conf.get("energy_threshold", 10)

    x = np.stack([read_wav(pth, normalize=False)[0][0] for pth in input_audio_paths])
    sub = np.asarray(analysis(x, h, p))  # [C, T, M]
    X = np.asarray(bf.snapshots(sub))  # [T, F, C]
    energy = np.asarray(bf.frame_energy(sub[0]))  # [T]
    T = X.shape[0]

    def _fit_mask(mk):
        """Trim/zero-pad a [frames, bands] mask to this run's [T, F] grid
        (frames beyond the mask contribute no statistics)."""
        mk = np.asarray(mk, np.float64)[:T, : M // 2 + 1]
        if mk.shape[0] < T:
            mk = np.pad(mk, ((0, T - mk.shape[0]), (0, 0)))
        if mk.shape[1] < M // 2 + 1:
            mk = np.pad(mk, ((0, 0), (0, M // 2 + 1 - mk.shape[1])))
        return mk

    tgt = ap_conf.get("target", {})
    if "tfmask_path" in tgt:
        mask_t = _fit_mask(_load_tfmask(tgt["tfmask_path"]))
        noise_paths = [n["tfmask_path"] for n in ap_conf.get("noises", [])
                       if "tfmask_path" in n]
        if noise_paths:
            mask_j = _fit_mask(_load_tfmask(noise_paths[0]))
        else:
            mask_j = 1.0 - mask_t
        egate = (energy > energy_threshold)[:, None]
        w_t = mask_t * egate
        w_j = mask_j * egate
    else:
        labs = tgt.get("vad_label", [(0.1, -1)])
        is_target = bf.label_to_frame_mask(T, p.D, samplerate, labs)
        egate = energy > energy_threshold
        w_t = (is_target & egate).astype(np.float64)
        w_j = ((~is_target) & egate).astype(np.float64)

    Rt_sum, ct = [np.asarray(a) for a in bf.accumulate_sos(X, w_t)]
    Rn_sum, cn = [np.asarray(a) for a in bf.accumulate_sos(X, w_j)]

    if btype == "smimvdr":
        delays = target_delays(ap_conf)
        wqH = np.asarray(
            bf.smi_mvdr(Rn_sum, cn, M, samplerate, delays, mu=bf_conf.get("mu", 1e-4))
        )
    elif btype == "bmvdr":
        Rt = Rt_sum / np.maximum(ct, 1)[:, None, None]
        Rn = Rn_sum / np.maximum(cn, 1)[:, None, None]
        Rn = np.asarray(bf.improve_matrix_condition(Rn, bf_conf.get("gamma", 1e-6)))
        wqH = np.asarray(
            bf.blind_mvdr_weights(Rt, Rn, bf_conf.get("ref_micx", 0), bf_conf.get("offset", 0.0))
        )
    elif btype == "gev":
        C = X.shape[-1]
        Rn = Rn_sum / np.maximum(cn, 1)[:, None, None]
        Rn = np.asarray(bf.improve_matrix_condition(Rn, bf_conf.get("gamma", 1e-6)))
        Rn = Rn / (np.real(np.trace(Rn, axis1=-2, axis2=-1))[:, None, None] / C)
        wqH = np.asarray(bf.gev_weights(Rt_sum, Rn))
    else:
        raise KeyError(f"unknown SOS beamformer {btype!r}")

    Y = np.asarray(bf.apply_weights(wqH.astype(np.complex64), X))
    y = np.asarray(synthesis(hermitian_mirror(Y, M), g, p))
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        write_wav(out_path, y, samplerate, normalized=False)
    print("Avg. output power: %f" % float((y.astype(np.float64) ** 2).sum() / max(len(y) // p.D, 1)))
    return y


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="SOS batch beamforming (SMI-MVDR/BMVDR/GEV)")
    ap.add_argument("-M", dest="M", default=256, type=int)
    ap.add_argument("-m", dest="m", default=4, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("-i", dest="input_audio_paths", nargs="+", required=True)
    ap.add_argument("-o", dest="out_path", default="out/sos_beamformed.wav")
    ap.add_argument("-c", dest="conf_path", required=True)
    args = ap.parse_args()
    with open(args.conf_path) as f:
        ap_conf = json.load(f)
    run(args.M, args.m, args.r, args.input_audio_paths, args.out_path, ap_conf)


if __name__ == "__main__":
    main()
