"""Objective quality assessment driver — mirror of src/quality_assessment.cc:
print the SNR and the Itakura-Saito distance between an original and an
enhanced (processed) speech file.

Flags follow the reference's getopt surface (quality_assessment.cc:22-36):
``-1`` original file, ``-2`` enhanced file, ``-M`` FFT length, ``-r``
decimation exponent, ``-w`` window type (0 rect / 1 Hamming / 2 Hann),
``-b``/``-e`` sample range, ``-n`` normalization bit flags (1 mean, 2 max
peak, 4 stddev, 8 cross-correlation gain).
"""

from __future__ import annotations

import argparse

from ..utils.jaxenv import setup_compile_cache


def run(original_path, enhanced_path, M=64, r=1, window_type=1,
        begin=0, end=-1, normalization_option=0):
    from ..ops.filterbank import FilterbankParams
    from ..ops.filterbank import stft_analysis
    from ..utils.measures import itakura_saito_frames, segmental_snr, snr
    from ..utils.wavio import read_wav

    x, rate1 = read_wav(original_path)
    y, rate2 = read_wav(enhanced_path)
    if rate1 != rate2:
        raise ValueError(f"sampling rates must match: {rate1} != {rate2}")
    x, y = x[0], y[0]
    if end >= 0:
        x, y = x[: end + 1], y[: end + 1]
    x, y = x[begin:], y[begin:]

    snr_db = snr(x, y, normalization_option=normalization_option)

    # IS distance over NormalFFTAnalysisBank frames; the reference converts
    # the sample range to frame indices with the frame shift D = M / 2**r
    # (quality_assessment.cc:80, ItakuraSaitoMeasurePS::frameShiftLength).
    D = FilterbankParams(M=M, m=1, r=r).D
    S1 = stft_analysis(x, M=M, r=r, window_type=window_type)
    S2 = stft_analysis(y, M=M, r=r, window_type=window_type)
    is_dist = itakura_saito_frames(S1, S2, bframe=0,
                                   eframe=(end // D) if end >= 0 else -1)

    print("SNR %f" % snr_db)
    print("IS  %f" % is_dist)
    print("segSNR %f" % segmental_snr(x, y))
    return snr_db, is_dist


def main():
    setup_compile_cache()
    ap = argparse.ArgumentParser(description="objective quality assessment")
    ap.add_argument("-1", dest="original", required=True)
    ap.add_argument("-2", dest="enhanced", required=True)
    ap.add_argument("-M", dest="M", default=64, type=int)
    ap.add_argument("-r", dest="r", default=1, type=int)
    ap.add_argument("-w", dest="window_type", default=1, type=int)
    ap.add_argument("-b", dest="begin", default=0, type=int)
    ap.add_argument("-e", dest="end", default=-1, type=int)
    ap.add_argument("-n", dest="normalization", default=0, type=int)
    args = ap.parse_args()
    run(args.original, args.enhanced, args.M, args.r, args.window_type,
        args.begin, args.end, args.normalization)


if __name__ == "__main__":
    main()
