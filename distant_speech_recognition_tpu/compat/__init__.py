"""BTK 2.0 compatibility layer: the reference's pull-stream API on the batched kernels.

The reference toolkit (kkumatani/distant_speech_recognition) exposes a
pull-based dataflow graph: every node is a ``FeatureStream`` producing one
frame per ``next()`` call (stream/stream.h:16-88), graphs are built in Python
from SWIG shadow classes named ``*Ptr``, and execution is a pull from the
sink (``for frame_no, buf in enumerate(sfb)``).

This package recreates that API surface 1:1 on top of this framework's
streaming kernels (models/streaming.py), so reference driver scripts port
with an import swap.  Module layout mirrors the reference's ``btk20.*``
SWIG packages:

    compat.stream        <-  btk20.stream    (FeatureStream pull model)
    compat.feature       <-  btk20.feature   (SampleFeature, plumbing nodes)
    compat.modulated     <-  btk20.modulated (oversampled DFT filterbanks)
    compat.beamformer    <-  btk20.beamformer (SubbandDS/GSC/GSCRLS/MVDR/...)
    compat.pybeamformer  <-  lib/pybeamformer.py (subband beamformers)
    compat.postfilter    <-  btk20.postfilter (Zelinski/McCowan postfilters)
    compat.pytdoa        <-  lib/pytdoa.py    (GCC-PHAT TDOA front ends)
    compat.pykalman      <-  lib/pykalman.py  (KF/EKF/IEKF trackers)
    compat.dereverberation / compat.aec  <-  btk20.{dereverberation,aec}
    compat.convolution   <-  btk20.convolution (OverlapAdd/OverlapSave)
    compat.lms           <-  btk20.lms        (FastBlockLMSFeature)
    compat.sad           <-  btk20.sad        (VAD streams, EnergyVADFeature)
    compat.tde           <-  btk20.tde        (CCTDE)
    compat.localization  <-  btk20.localization (GCC family, noise spectra)
    compat.objective_measure <- btk20.objective_measure (SNR/IS measures)

(btk20.{common,matrix,square_root,utils} have no Python-visible DSP
surface to mirror — smart pointers, GSL matrices and Cholesky/Givens
kernels are subsumed by numpy/jax; see PARITY.md section 2.1/2.12.)

Every class is also exported under its SWIG shadow name with the ``Ptr``
suffix (``SampleFeaturePtr`` etc.), matching how the reference drivers
instantiate nodes (unit_test/test_online_beamforming.py:82-88).

Throughput note: the pull model dispatches one jitted step per frame and is
inherently host-loop bound; it exists for API familiarity and incremental
migration.  For production use the batched pipelines (models/pipeline.py,
~1000x faster) or the chunked ``StreamingEnhancer`` (models/streaming.py).
"""

from . import (  # noqa: F401
    aec,
    beamformer,
    convolution,
    dereverberation,
    feature,
    lms,
    localization,
    modulated,
    objective_measure,
    postfilter,
    pybeamformer,
    pykalman,
    pytdoa,
    sad,
    stream,
    tde,
)

from .stream import FeatureStream, PyVectorComplexFeatureStream, PyVectorComplexFeatureStreamPtr  # noqa: F401
from .feature import SampleFeature, SampleFeaturePtr  # noqa: F401
from .modulated import (  # noqa: F401
    OverSampledDFTAnalysisBank,
    OverSampledDFTAnalysisBankPtr,
    OverSampledDFTSynthesisBank,
    OverSampledDFTSynthesisBankPtr,
)
from .pybeamformer import (  # noqa: F401
    SubbandGSCBeamformer,
    SubbandGSCLMSBeamformer,
    SubbandGSCRLSBeamformer,
    SubbandMVDRBeamformer,
)
from .postfilter import (  # noqa: F401
    LefkimmiatisPostFilter,
    LefkimmiatisPostFilterPtr,
    McCowanPostFilter,
    McCowanPostFilterPtr,
    ZelinskiPostFilter,
    ZelinskiPostFilterPtr,
)
from .dereverberation import (  # noqa: F401
    MultiChannelWPEDereverberation,
    MultiChannelWPEDereverberationFeature,
    MultiChannelWPEDereverberationFeaturePtr,
    MultiChannelWPEDereverberationPtr,
    SingleChannelWPEDereverberationFeature,
    SingleChannelWPEDereverberationFeaturePtr,
)
from .aec import (  # noqa: F401
    BlockKalmanFilterEchoCancellationFeature,
    BlockKalmanFilterEchoCancellationFeaturePtr,
    DTDBlockKalmanFilterEchoCancellationFeature,
    DTDBlockKalmanFilterEchoCancellationFeaturePtr,
    InformationFilterEchoCancellationFeature,
    InformationFilterEchoCancellationFeaturePtr,
    KalmanFilterEchoCancellationFeature,
    KalmanFilterEchoCancellationFeaturePtr,
    NLMSAcousticEchoCancellationFeature,
    NLMSAcousticEchoCancellationFeaturePtr,
    SquareRootInformationFilterEchoCancellationFeature,
    SquareRootInformationFilterEchoCancellationFeaturePtr,
)
