"""Batched distant-speech front-end framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of BTK 2.0
(kkumatani/distant_speech_recognition): oversampled DFT-modulated subband
analysis/synthesis filterbanks, subband-domain beamforming (delay-and-sum,
LCMV, super-directive/MVDR, adaptive GSC with LMS/RLS, SMI-MVDR, blind MVDR,
GEV, maximum-kurtosis/negentropy), postfiltering (Zelinski, McCowan,
Lefkimmiatis, spectral subtraction, binaural masking), WPE dereverberation,
NLMS/Kalman acoustic echo cancellation, GCC-PHAT/SRP-PHAT localization with
EKF tracking, voice activity detection, and the MFCC feature chain.

Unlike the single-process C++ reference, everything is formulated as dense
batched tensor programs: per-frequency-bin small-matrix algebra is vmapped
over all bins, temporal recursions are `lax.scan`s, and utterance batches /
frequency bins shard over a `jax.sharding.Mesh` (see `parallel/`).
"""

__version__ = "0.1.0"

from . import ops  # noqa: F401
