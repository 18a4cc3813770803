"""GSC beamforming with multiple linear constraints (MLC).

CLI mirror of the reference driver ``src/beamformerMLC.cc`` (same
``-A/-P/-C/-O/-S/-M/-i`` flags and the same text-file formats):

* ``-C`` prototype file: whitespace-separated floats, first half the
  analysis prototype, second half the synthesis prototype
  (beamformerMLC.cc:24-72, ``getFilterCoeffs``).
* ``-P`` mic-position file: channel count then one ``x y z`` row (mm)
  per microphone (beamformerMLC.cc:80-117, ``getGeometryOfArray``).
* ``-S`` source-position file: one ``id azimuth elevation`` row per
  source; ``-i`` picks the target, every other source becomes a null
  (linear) constraint (beamformerMLC.cc:120-215, ``calcTimeDelays``).

The chain is ``SubbandGSC`` with quiescent MLC weights (active weights
zero — the driver never adapts them) -> ``ZelinskiPostFilter`` (type 2,
alpha 0.6) -> synthesis bank, and the output is peak-normalized float
WAV at 16 kHz (beamformerMLC.cc:222-322, ``doBeamforming``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..utils.jaxenv import setup_compile_cache

SOUNDSPEED = 343740.0  # mm/s (beamformerMLC.cc:14)


def load_filter_coeffs(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Text prototype file -> (analysis, synthesis) halves
    (getFilterCoeffs, beamformerMLC.cc:24-72)."""
    vals = np.loadtxt(path, dtype=np.float64).ravel()
    n = len(vals) // 2
    return vals[:n].astype(np.float32), vals[n : 2 * n].astype(np.float32)


def load_array_geometry(path: str) -> np.ndarray:
    """Mic-position file -> [C, 3] xyz in mm (getGeometryOfArray,
    beamformerMLC.cc:80-117)."""
    with open(path) as fp:
        toks = fp.read().split()
    c = int(toks[0])
    pos = np.asarray(toks[1 : 1 + 3 * c], np.float64).reshape(c, 3)
    return pos


def load_source_positions(path: str) -> np.ndarray:
    """Source-position file -> [S, 2] (azimuth, elevation) radians
    (beamformerMLC.cc:128-166)."""
    rows = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    return rows[:, 1:3]


def calc_time_delays(target_index: int, mpos: np.ndarray,
                     positions: np.ndarray):
    """Far-field delays for the target and each interferer
    (calcTimeDelays, beamformerMLC.cc:167-215): the propagation vector is
    ``-(sin(el)cos(az), sin(el)sin(az), cos(el))`` — the reference treats
    "elevation" as a polar angle, which is exactly
    `utils.geometry.calc_ca_delays`."""
    from ..utils.geometry import calc_ca_delays

    delays = np.stack([
        calc_ca_delays(mpos, az, el, sspeed=SOUNDSPEED)
        for az, el in positions
    ])
    delaysT = delays[target_index]
    delaysJ = np.delete(delays, target_index, axis=0)
    return delaysT, (delaysJ if len(delaysJ) else None)


def run(audio_list, mic_pos_file, coeff_file, src_pos_file, out_path,
        M=256, m=4, r=1, target_index=0, pf=2, alpha=0.6,
        samplerate=16000.0):
    from ..compat import beamformer as cb
    from ..compat import feature as cf
    from ..compat import modulated as cm
    from ..compat import postfilter as cp
    from ..utils.wavio import write_wav

    h, g = load_filter_coeffs(coeff_file)
    mpos = load_array_geometry(mic_pos_file)
    positions = load_source_positions(src_pos_file)
    delaysT, delaysJ = calc_time_delays(target_index, mpos, positions)

    D = M >> r
    with open(audio_list) as fp:
        paths = fp.read().split()

    bf = cb.SubbandGSC(fftLen=M, halfBandShift=False)
    for fn in paths:
        s = cf.SampleFeature(D, D, pad_zeros=True)
        s.read(fn, int(samplerate))
        a = cm.OverSampledDFTAnalysisBank(s, h, M, m, r,
                                          delay_compensation_type=2)
        bf.set_channel(a)
    if delaysJ is None:
        bf.calc_gsc_weights(samplerate, delaysT)
    else:
        bf.calc_gsc_weights_n(samplerate, delaysT, delaysJ,
                              NC=len(delaysJ) + 1)

    z = cp.ZelinskiPostFilter(bf, M, alpha, pf)
    z.set_beamformer(bf)
    syn = cm.OverSampledDFTSynthesisBank(z, g, M, m, r,
                                         delay_compensation_type=2)
    y = np.concatenate([np.asarray(v, np.float32) for v in syn])

    # peak normalization before the float write (beamformerMLC.cc:279-311)
    peak = float(np.max(np.abs(y))) or 1.0
    y = y / peak
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        # IEEE-float WAV like the reference (SF_FORMAT_FLOAT, :290)
        write_wav(out_path, y, 16000, normalized=True, dtype="float32")
        print(f"output wave file {out_path}", file=sys.stderr)
    return y


def build_parser():
    p = argparse.ArgumentParser(
        description="GSC beamforming with multiple linear constraints "
                    "(batched mirror of beamformerMLC)")
    p.add_argument("-A", "--audioList", default="./testL")
    p.add_argument("-P", "--micPosFile", default="./array.txt")
    p.add_argument("-C", "--coeffFile", default="./M256-m4-r1")
    p.add_argument("-O", "--outputFile", default="./beamformed.wav")
    p.add_argument("-S", "--srcPosFile", default="./source_position.txt")
    p.add_argument("-M", dest="M", type=int, default=256)
    p.add_argument("-i", "--target_index", type=int, default=0)
    return p


def main(argv=None):
    setup_compile_cache()
    a = build_parser().parse_args(argv)
    run(a.audioList, a.micPosFile, a.coeffFile, a.srcPosFile, a.outputFile,
        M=a.M, target_index=a.target_index)


if __name__ == "__main__":
    main()
