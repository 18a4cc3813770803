"""``btk20.beamformer`` compatibility: the C++ subband-beamformer streams.

Mirrors beamformer/beamformer.{h,cc}: the class tower
``SubbandBeamformer -> SubbandDS -> SubbandGSC -> SubbandGSCRLS`` and
``SubbandDS -> SubbandMVDR -> SubbandMVDRGSC`` plus ``SnapShotArray``,
``SubbandOrthogonalizer`` and ``SubbandBlockingMatrix``, with the
reference's method names (beamformer.i), the camelCase legacy aliases
(``ENABLE_LEGACY_BTK_API``) and even its misspellings
(``update_active_weight_vecotrs``, ``set_diagonal_looading``) so reference
driver code ports with an import swap.

All numerics are delegated to the batched kernels in
``models/beamforming.py``; these classes only add the pull-stream state
machine (channel list -> snapshot assembly -> per-bin weights -> hermitian
mirror, SubbandDS::next beamformer.cc:1095-1157).  The per-frame GSC-RLS
adaptation (SubbandGSCRLS::update_active_weight_vector2_,
beamformer.cc:1576-1645) runs as one jitted all-bins step.

Throughput note: like the rest of ``compat``, these nodes dispatch one
step per frame and exist for API familiarity; production code should use
``models/pipeline.py`` / ``models/adaptive_gsc.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models import beamforming as bf
from ..ops.filterbank import hermitian_mirror
from .stream import FeatureStream

__all__ = [
    "SnapShotArray",
    "SnapShotArrayPtr",
    "SubbandBeamformer",
    "SubbandBeamformerPtr",
    "SubbandDS",
    "SubbandDSPtr",
    "SubbandGSC",
    "SubbandGSCPtr",
    "SubbandGSCRLS",
    "SubbandGSCRLSPtr",
    "SubbandMVDR",
    "SubbandMVDRPtr",
    "SubbandMVDRGSC",
    "SubbandMVDRGSCPtr",
    "SubbandOrthogonalizer",
    "SubbandOrthogonalizerPtr",
    "SubbandBlockingMatrix",
    "SubbandBlockingMatrixPtr",
    "NO_QUADRATIC_CONSTRAINT",
    "CONSTANT_NORM",
    "THRESHOLD_LIMITATION",
]

# QuadraticConstraintType (beamformer.h:218-222)
CONSTANT_NORM = 0x01
THRESHOLD_LIMITATION = 0x02
NO_QUADRATIC_CONSTRAINT = 0x00


class SnapShotArray:
    """Per-frequency snapshot container (spectralinfoarray.h:6-38).

    ``set_samples`` stages one channel's full-M spectrum; ``update``
    transposes the staged block into per-bin snapshot vectors X(f) in C^chan
    (SnapShotArray::update, beamformer.cc:62).
    """

    def __init__(self, fftLen: int, chanN: int):
        self._fftLen = int(fftLen)
        self._chanN = int(chanN)
        self._samples = np.zeros((chanN, fftLen), np.complex64)  # staged [C, M]
        self._specs = np.zeros((fftLen, chanN), np.complex64)  # snapshots [M, C]

    def fftLen(self) -> int:
        return self._fftLen

    def chanN(self) -> int:
        return self._chanN

    def set_samples(self, samp, chanX: int) -> None:
        self._samples[chanX] = np.asarray(samp, np.complex64)

    def update(self) -> None:
        self._specs = np.ascontiguousarray(self._samples.T)

    def snapshot(self, fbinX: int) -> np.ndarray:
        return self._specs[fbinX]

    def snapshots(self) -> np.ndarray:
        """All snapshots ``[M, C]`` (batch view; not in the reference API)."""
        return self._specs

    def zero(self) -> None:
        self._samples[:] = 0
        self._specs[:] = 0

    # legacy aliases (spectralinfoarray.h ENABLE_LEGACY_BTK_API)
    def setSamples(self, samp, chanX):
        self.set_samples(samp, chanX)

    def getSnapShot(self, fbinX):
        return self.snapshot(fbinX)


SnapShotArrayPtr = SnapShotArray


def _packed_to_complex(packed) -> np.ndarray:
    """[re0, im0, re1, im1, ...] -> complex (calcSidelobeCancellerP_f,
    beamformer.cc:729-752)."""
    p = np.asarray(packed, np.float64).reshape(-1, 2)
    return (p[:, 0] + 1j * p[:, 1]).astype(np.complex64)


class SubbandBeamformer(FeatureStream):
    """Base stream: channel list + snapshot assembly (beamformer.h:89-125)."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandBeamformer"):
        super().__init__(int(fftLen), nm)
        if halfBandShift:
            # the reference throws "not yet implemented" on this path in
            # every next() (e.g. beamformer.cc:1244) — fail early instead
            raise NotImplementedError("halfBandShift=True is unimplemented in the reference")
        self._fftLen = int(fftLen)
        self._F = self._fftLen // 2 + 1
        self._half_band_shift = bool(halfBandShift)
        self._channels: list = []
        self._snapshot_array: SnapShotArray | None = None
        # postfilter tap points (compat.postfilter.set_beamformer)
        self.last_snapshot: np.ndarray | None = None  # [F, C]
        self.wq_manifold: np.ndarray | None = None  # ta_ [F, C] (e^{-j.} conv.)

    # -- reference API ----------------------------------------------------
    def fftLen(self) -> int:
        return self._fftLen

    def fftLen2(self) -> int:
        return self._fftLen // 2

    def chanN(self) -> int:
        return len(self._channels)

    def dim(self) -> int:
        return self.chanN()

    def set_channel(self, chan) -> None:
        self._channels.append(chan)
        self._snapshot_array = None

    def clear_channel(self) -> None:
        self._channels = []
        self._snapshot_array = None

    def snapshot_array(self) -> SnapShotArray:
        if self._snapshot_array is None:
            self._snapshot_array = SnapShotArray(self._fftLen, self.chanN())
        return self._snapshot_array

    def snapshot_array_f(self, fbinX: int) -> np.ndarray:
        return self.snapshot_array().snapshot(fbinX)

    def beamformer(self):
        """compat postfilters accept the node itself (cf. compat.pybeamformer)."""
        return self

    # -- machinery ---------------------------------------------------------
    def _pull_snapshots(self) -> np.ndarray:
        """Advance every channel one frame and return snapshots ``[F, C]``
        (the SubbandDS::next channel loop, beamformer.cc:1109-1115)."""
        sa = self.snapshot_array()
        for chanX, chan in enumerate(self._channels):
            sa.set_samples(np.asarray(chan.next(self._frame_no + 1)), chanX)
        sa.update()
        X = sa.snapshots()[: self._F].copy()
        self.last_snapshot = X
        return X

    def _produce(self) -> np.ndarray:  # pragma: no cover - abstract in C++ too
        raise NotImplementedError("use a concrete beamformer subclass")

    def _reset(self):
        for chan in self._channels:
            if hasattr(chan, "reset"):
                chan.reset()
        if self._snapshot_array is not None:
            self._snapshot_array.zero()

    # legacy aliases
    def isEnd(self):
        return self.is_end()

    def snapShotArray_f(self, fbinX):
        return self.snapshot_array_f(fbinX)

    def getSnapShotArray(self):
        return self.snapshot_array()

    def setChannel(self, chan):
        self.set_channel(chan)

    def clearChannel(self):
        self.clear_channel()


SubbandBeamformerPtr = SubbandBeamformer


class SubbandDS(SubbandBeamformer):
    """Delay-and-sum: ``Y(f) = wq(f)^H X(f)`` over bins 0..M/2, mirrored
    (SubbandDS::next, beamformer.cc:1095-1157)."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandDS"):
        super().__init__(fftLen, halfBandShift, nm)
        # BeamformerWeights state over bins 0..M/2 (beamformer.h:28-84)
        self._wq: np.ndarray | None = None  # [F, C] quiescent (un-conjugated)
        self._B: np.ndarray | None = None  # [F, C, C-NC] blocking matrices
        self._wa: np.ndarray | None = None  # [F, C-NC] active weights
        self._wl: np.ndarray | None = None  # [F, C] = B wa sidelobe canceller
        self._NC = 1

    # -- weight computation -------------------------------------------------
    def calc_array_manifold_vectors(self, samplerate: float, delays) -> None:
        """D&S manifold ``wq = e^{-j 2 pi f tau} / C`` (calcMainlobe,
        beamformer.cc:502-565)."""
        self._alloc_weights(np.asarray(delays).shape[-1], NC=1)
        vs = np.asarray(bf.array_manifold(self._fftLen, float(samplerate), delays))
        self._wq = vs.astype(np.complex64)
        self.wq_manifold = self._wq  # ta_ = wq_ (setTimeAlignment, beamformer.cc:960-965)

    def calc_array_manifold_vectors_2(self, samplerate: float, delaysT, delaysJ) -> None:
        """Target + one null constraint (calcMainlobe2, beamformer.cc:572-598)."""
        self.calc_array_manifold_vectors_n(samplerate, delaysT, np.atleast_2d(delaysJ), NC=2)

    def calc_array_manifold_vectors_n(self, samplerate: float, delaysT, delaysJ,
                                      NC: int = 2) -> None:
        """LCMV null-steering quiescent ``wq = C (C^H C)^{-1} g``
        (calcMainlobeN, beamformer.cc:600-721)."""
        delaysJ = np.atleast_2d(np.asarray(delaysJ))
        self._alloc_weights(np.asarray(delaysT).shape[-1], NC=int(NC))
        vs_t = bf.array_manifold(self._fftLen, float(samplerate), np.asarray(delaysT))
        cons = [vs_t] + [
            bf.array_manifold(self._fftLen, float(samplerate), d) for d in delaysJ
        ]
        constraints = jnp.stack(cons, axis=-2)  # [F, NC, C]
        gains = jnp.asarray([1.0] + [0.0] * len(delaysJ))
        wqH = np.asarray(bf.lcmv_weights(constraints, gains))
        self._wq = np.conj(wqH).astype(np.complex64)
        self.wq_manifold = self._wq  # ta_ = wq_ (beamformer.cc:960-965)

    def get_weights(self, fbinX: int) -> np.ndarray:
        return self._wq[fbinX]

    # -- machinery ----------------------------------------------------------
    def _alloc_weights(self, chanN: int, NC: int) -> None:
        F, B = self._F, chanN - NC
        self._NC = NC
        self._B = np.zeros((F, chanN, B), np.complex64)
        self._wa = np.zeros((F, B), np.complex64)
        self._wl = np.zeros((F, chanN), np.complex64)

    def _require_weights(self, msg="call calc_array_manifold_vectors_x() once"):
        if self._wq is None:
            raise RuntimeError(msg)

    def _mirror(self, Y_half: np.ndarray) -> np.ndarray:
        return np.asarray(hermitian_mirror(jnp.asarray(Y_half), self._fftLen))

    def _produce(self) -> np.ndarray:
        self._require_weights()
        X = self._pull_snapshots()
        Y = np.einsum("fc,fc->f", np.conj(self._wq), X)
        return self._mirror(Y)

    # legacy aliases
    def getWeights(self, fbinX):
        return self.get_weights(fbinX)

    def calcArrayManifoldVectors(self, sampleRate, delays):
        self.calc_array_manifold_vectors(sampleRate, delays)

    def calcArrayManifoldVectors2(self, sampleRate, delaysT, delaysJ):
        self.calc_array_manifold_vectors_2(sampleRate, delaysT, delaysJ)

    def calcArrayManifoldVectorsN(self, sampleRate, delaysT, delaysJ, NC=2):
        self.calc_array_manifold_vectors_n(sampleRate, delaysT, delaysJ, NC)


SubbandDSPtr = SubbandDS


class SubbandGSC(SubbandDS):
    """GSC with externally set active weights:
    ``Y = (wq - B wa)^H X`` (SubbandGSC::next + calc_gsc_output,
    beamformer.cc:1208-1316)."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandGSC"):
        super().__init__(fftLen, halfBandShift, nm)
        self._normalize_weight = False

    def normalize_weight(self, flag: bool) -> None:
        self._normalize_weight = bool(flag)

    def calc_gsc_weights(self, samplerate: float, delaysT) -> None:
        """Manifold + blocking matrix with NC=1 (calcMainlobe(isGSC=true),
        beamformer.cc:557-565)."""
        self.calc_array_manifold_vectors(samplerate, delaysT)
        self._B = np.asarray(bf.blocking_matrix(jnp.asarray(self._wq), Nc=1))

    def calc_gsc_weights_2(self, samplerate: float, delaysT, delaysJ) -> None:
        self.calc_array_manifold_vectors_2(samplerate, delaysT, delaysJ)
        self._B = np.asarray(bf.blocking_matrix(jnp.asarray(self._wq), Nc=self._NC))

    def calc_gsc_weights_n(self, samplerate: float, delaysT, delaysJ, NC: int = 2) -> None:
        self.calc_array_manifold_vectors_n(samplerate, delaysT, delaysJ, NC)
        self._B = np.asarray(bf.blocking_matrix(jnp.asarray(self._wq), Nc=self._NC))

    def set_quiescent_weights_f(self, fbinX: int, srcWq) -> None:
        """Overwrite wq at one bin and recompute its blocking matrix
        (SubbandGSC::set_quiescent_weights_f, beamformer.cc:1318-1325)."""
        self._require_weights("call calc_gsc_weights_x() once")
        self._wq[fbinX] = np.asarray(srcWq, np.complex64)
        self.wq_manifold = self._wq
        self._B[fbinX] = np.asarray(
            bf.blocking_matrix(jnp.asarray(self._wq[fbinX]), Nc=self._NC)
        )

    def set_active_weights_f(self, fbinX: int, packedWeight) -> None:
        """Packed [re, im, ...] active weights; recompute ``wl = B wa``
        (calcSidelobeCancellerP_f, beamformer.cc:729-752)."""
        self._require_weights("call calc_gsc_weights_x() once")
        wa = _packed_to_complex(packedWeight)
        if wa.shape[0] != self._wa.shape[1]:
            raise ValueError(
                f"active weight size must be {2 * self._wa.shape[1]} floats"
            )
        self._wa[fbinX] = wa
        self._wl[fbinX] = self._B[fbinX] @ wa

    def zero_active_weights(self) -> None:
        self._require_weights("call calc_gsc_weights_x() once")
        self._wa[:] = 0
        self._wl[:] = 0

    def blocking_matrix(self, srcX: int, fbinX: int) -> np.ndarray:
        return self._B[fbinX]

    def write_fir_coeff(self, fn: str, winType: int = 1) -> bool:
        """Export windowed time-domain FIRs of ``wq - B wa``
        (BeamformerWeights::write_fir_coeff, beamformer.cc:775-830)."""
        self._require_weights()
        woH = jnp.asarray(np.conj(self._wq - self._wl))
        fir = np.asarray(bf.weights_to_fir(woH, window_type=int(winType)))
        with open(fn, "w") as fp:
            fp.write(f"{self.chanN()} {self._fftLen}\n")
            for row in fir:
                fp.write(" ".join(f"{c:e}" for c in row) + " \n")
        return True

    def _gsc_output_half(self, X: np.ndarray) -> np.ndarray:
        """(wq - wl)^H X per bin, with the optional total-weight
        normalization ``w / (||w|| chanN)`` (calc_gsc_output,
        beamformer.cc:1208-1243); bin 0 always plain ``wq^H X``."""
        w = self._wq - self._wl  # [F, C]
        if self._normalize_weight:
            nrm = np.linalg.norm(w, axis=-1, keepdims=True)
            w_n = w / (np.where(nrm > 0, nrm, 1.0) * self.chanN())
            w = np.concatenate([w[:1], w_n[1:]], axis=0)
            Y = np.einsum("fc,fc->f", np.conj(w), X)
            Y[0] = np.vdot(self._wq[0], X[0])
            return Y
        Y = np.einsum("fc,fc->f", np.conj(w), X)
        Y[0] = np.vdot(self._wq[0], X[0])
        return Y

    def _produce(self) -> np.ndarray:
        self._require_weights("call calc_gsc_weights_x() once")
        X = self._pull_snapshots()
        return self._mirror(self._gsc_output_half(X))

    # legacy aliases
    def normalizeWeight(self, flag):
        self.normalize_weight(flag)

    def setQuiescentWeights_f(self, fbinX, srcWq):
        self.set_quiescent_weights_f(fbinX, srcWq)

    def setActiveWeights_f(self, fbinX, packedWeight):
        self.set_active_weights_f(fbinX, packedWeight)

    def zeroActiveWeights(self):
        self.zero_active_weights()

    def calcGSCWeights(self, sampleRate, delaysT):
        self.calc_gsc_weights(sampleRate, delaysT)

    def calcGSCWeights2(self, sampleRate, delaysT, delaysJ):
        self.calc_gsc_weights_2(sampleRate, delaysT, delaysJ)

    def calcGSCWeightsN(self, sampleRate, delaysT, delaysJ, NC=2):
        self.calc_gsc_weights_n(sampleRate, delaysT, delaysJ, NC)

    def writeFIRCoeff(self, fn, winType=1):
        return self.write_fir_coeff(fn, winType)

    def getBlockingMatrix(self, srcX, fbinX):
        return self.blocking_matrix(srcX, fbinX)


SubbandGSCPtr = SubbandGSC


def _gscrls_step_factory(mu: float, qctype: int, alpha: float, normalize: bool):
    """One jitted all-bins frame of SubbandGSCRLS: GSC output with the
    previous weights, then the RLS gain / precision / active-weight update
    of beamformer.cc:1576-1645.  Bin 0 state is frozen (the C++ update loop
    runs fbinX = 1..M/2 only)."""

    def step(state, inputs):
        wa, Pz, wq, B, sigma2 = state  # [F,Bc], [F,Bc,Bc], [F,C], [F,C,Bc], [F]
        X, = inputs  # [F, C]
        Bc = wa.shape[-1]

        wl = jnp.einsum("fcb,fb->fc", B, wa)
        w = wq - wl
        if normalize:
            # calc_gsc_output's w / (||w|| chanN) option (beamformer.cc:1230-1238)
            nrm = jnp.linalg.norm(w, axis=-1, keepdims=True)
            w = w / (jnp.where(nrm > 0, nrm, 1.0) * w.shape[-1])
        Y = jnp.einsum("fc,fc->f", jnp.conj(w), X)
        Y = Y.at[0].set(jnp.vdot(wq[0], X[0]))

        # --- update_active_weight_vector2_ ---
        Z = jnp.einsum("fcb,fc->fb", jnp.conj(B), X)  # B^H X
        PzH_Z = jnp.einsum("fij,fi->fj", jnp.conj(Pz), Z)  # Pz^H Z
        de = jnp.einsum("fi,fi->f", jnp.conj(PzH_Z), Z) / mu + 1.0
        gz = (jnp.einsum("fij,fj->fi", Pz, Z) / mu) / de[:, None]
        Pz_new = (Pz - gz[:, :, None] * jnp.conj(PzH_Z)[:, None, :]) / mu

        epA = jnp.conj(Y)
        mat1 = jnp.eye(Bc, dtype=Pz.dtype)[None] - sigma2[:, None, None].astype(Pz.dtype) * Pz_new
        wa_new = jnp.einsum("fij,fj->fi", mat1, wa) + gz * epA[:, None]

        if qctype == CONSTANT_NORM:
            nrm = jnp.linalg.norm(wa_new, axis=-1, keepdims=True)
            wa_new = wa_new * (alpha / jnp.where(nrm > 0, nrm, 1.0))
        elif qctype == THRESHOLD_LIMITATION:
            nrm = jnp.linalg.norm(wa_new, axis=-1, keepdims=True)
            scale = jnp.where(
                nrm * nrm >= alpha, alpha / jnp.where(nrm > 0, nrm, 1.0), 1.0
            )
            wa_new = wa_new * scale

        # freeze bin 0 (update loop starts at fbinX = 1)
        mask = (jnp.arange(wa.shape[0]) > 0)
        wa_new = jnp.where(mask[:, None], wa_new, wa)
        Pz_new = jnp.where(mask[:, None, None], Pz_new, Pz)
        return (wa_new, Pz_new, wq, B, sigma2), Y

    return jax.jit(step)


class SubbandGSCRLS(SubbandGSC):
    """GSC with per-bin RLS adaptation of the active weights
    (SubbandGSCRLS, beamformer.h:224-263 / beamformer.cc:1446-1645; Van
    Trees, Optimum Array Processing pp. 766-767).

    Usage mirrors the reference: ``calc_gsc_weights()`` then
    ``init_precision_matrix()`` (or ``set_precision_matrix``); call
    ``update_active_weight_vecotrs(False)`` to freeze adaptation.
    ``sigma2`` is the weight-decay loading applied as ``(I - sigma2 Pz)``
    in the update — distinct from ``init_precision_matrix``'s sigma2,
    which sets ``Pz = I / sigma2``."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 mu: float = 0.9, sigma2: float = 0.0,
                 nm: str = "SubbandGSCRLS"):
        super().__init__(fftLen, halfBandShift, nm)
        self._mu = float(mu)
        self._diagonal_weights = np.full(self._F, float(sigma2), np.float32)
        self._alpha = -1.0
        self._qctype = NO_QUADRATIC_CONSTRAINT
        self._is_wa_updated = True
        self._Pz: np.ndarray | None = None
        self._step = None

    def init_precision_matrix(self, sigma2: float = 0.01) -> None:
        """Pz(f) = I / sigma2 (beamformer.cc:1476-1487)."""
        self._require_weights("call calc_gsc_weights_x() once")
        Bc = self._wa.shape[1]
        self._Pz = np.broadcast_to(
            np.eye(Bc, dtype=np.complex64) / sigma2, (self._F, Bc, Bc)
        ).copy()
        self._step = None

    def set_precision_matrix(self, fbinX: int, Pz) -> None:
        self._require_weights("call calc_gsc_weights_x() once")
        if self._Pz is None:
            Bc = self._wa.shape[1]
            self._Pz = np.zeros((self._F, Bc, Bc), np.complex64)
        self._Pz[fbinX] = np.asarray(Pz, np.complex64)[: self._Pz.shape[1], : self._Pz.shape[2]]
        self._step = None

    def normalize_weight(self, flag: bool) -> None:
        super().normalize_weight(flag)
        self._step = None

    def update_active_weight_vecotrs(self, flag: bool) -> None:
        """[sic] — the reference misspells this method (beamformer.h:310)."""
        self._is_wa_updated = bool(flag)

    update_active_weight_vectors = update_active_weight_vecotrs

    def set_quadratic_constraint(self, alpha: float, qctype: int = 1) -> None:
        self._alpha = float(alpha)
        self._qctype = int(qctype)
        self._step = None

    def _produce(self) -> np.ndarray:
        self._require_weights("call calc_gsc_weights_x() once")
        if self._Pz is None:
            raise RuntimeError(
                "set the precision matrix with init_precision_matrix() or set_precision_matrix()"
            )
        X = self._pull_snapshots()
        if not self._is_wa_updated:
            return self._mirror(self._gsc_output_half(X))
        if self._step is None:
            self._step = _gscrls_step_factory(
                self._mu, self._qctype, self._alpha, self._normalize_weight
            )
        state = (
            jnp.asarray(self._wa),
            jnp.asarray(self._Pz),
            jnp.asarray(self._wq),
            jnp.asarray(self._B),
            jnp.asarray(self._diagonal_weights),
        )
        state, Y = self._step(state, (jnp.asarray(X),))
        self._wa = np.asarray(state[0])
        self._Pz = np.asarray(state[1])
        self._wl = np.einsum("fcb,fb->fc", self._B, self._wa)
        return self._mirror(np.asarray(Y))

    # legacy aliases
    def initPrecisionMatrix(self, sigma2=0.01):
        self.init_precision_matrix(sigma2)

    def setPrecisionMatrix(self, fbinX, Pz):
        self.set_precision_matrix(fbinX, Pz)

    def updateActiveWeightVecotrs(self, flag):
        self.update_active_weight_vecotrs(flag)

    def setQuadraticConstraint(self, alpha, qctype=1):
        self.set_quadratic_constraint(alpha, qctype)


SubbandGSCRLSPtr = SubbandGSCRLS


class SubbandMVDR(SubbandDS):
    """MVDR with an explicit noise spatial-spectral matrix per bin
    (SubbandMVDR, beamformer.h:333-383 / beamformer.cc:2350-2602).

    Usage: ``set_channel`` -> ``calc_array_manifold_vectors`` ->
    ``set_noise_spatial_spectral_matrix``/``set_diffuse_noise_model``
    (+ optional loading) -> ``calc_mvdr_weights`` -> iterate."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandMVDR"):
        super().__init__(fftLen, halfBandShift, nm)
        self._R: np.ndarray | None = None  # [F, C, C]
        self._wmvdr: np.ndarray | None = None  # [F, C] (C++ convention: applied as w^H X)
        self._mvdr_diagonal_weights = np.zeros(self._F, np.float32)

    # -- noise model --------------------------------------------------------
    def _alloc_R(self, chanN: int) -> None:
        if self._R is None:
            self._R = np.zeros((self._F, chanN, chanN), np.complex64)

    def set_noise_spatial_spectral_matrix(self, fbinX: int, Rnn) -> bool:
        Rnn = np.asarray(Rnn, np.complex64)
        if Rnn.shape != (self.chanN(), self.chanN()):
            return False
        self._alloc_R(self.chanN())
        self._R[fbinX] = Rnn
        return True

    def set_diffuse_noise_model(self, micPositions, samplerate: float,
                                sspeed: float = 343740.0) -> bool:
        """Diffuse-field sinc coherence ``Gamma_mn = sinc(2 f d_mn / c)``
        (beamformer.cc:2442-2509)."""
        mpos = np.asarray(micPositions, np.float64)
        if mpos.shape[0] != self.chanN() or mpos.shape[1] < 3:
            return False
        self._R = np.asarray(
            bf.diffuse_noise_coherence(mpos, self._fftLen, float(samplerate), float(sspeed))
        ).astype(np.complex64)
        return True

    def set_all_diagonal_loading(self, diagonalWeight: float) -> None:
        if self._R is None:
            raise RuntimeError("construct first a noise covariance matrix")
        self._mvdr_diagonal_weights[:] = float(diagonalWeight)
        self._R = self._R + float(diagonalWeight) * np.eye(self._R.shape[-1], dtype=np.complex64)

    def set_diagonal_looading(self, fbinX: int, diagonalWeight: float) -> None:
        """[sic] — reference spelling (beamformer.h:352)."""
        if self._R is None:
            raise RuntimeError("construct first a noise covariance matrix")
        self._mvdr_diagonal_weights[fbinX] = float(diagonalWeight)
        self._R[fbinX] += float(diagonalWeight) * np.eye(self._R.shape[-1], dtype=np.complex64)

    set_diagonal_loading = set_diagonal_looading

    def divide_nondiagonal_elements(self, fbinX: int, mu: float) -> None:
        C = self._R.shape[-1]
        off = ~np.eye(C, dtype=bool)
        Rf = self._R[fbinX].copy()
        Rf[off] /= 1.0 + float(mu)
        self._R[fbinX] = Rf

    def divide_all_nondiagonal_elements(self, mu: float) -> None:
        for fbinX in range(self._F):
            self.divide_nondiagonal_elements(fbinX, mu)

    def noise_spatial_spectral_matrix(self, fbinX: int | None = None):
        return self._R if fbinX is None else self._R[fbinX]

    # -- weights --------------------------------------------------------------
    def calc_mvdr_weights(self, samplerate: float, dThreshold: float = 1.0e-8,
                          calcInverseMatrix: bool = True) -> bool:
        """``w = R^-1 d / (C d^H R^-1 d)``, bin 0 all-ones, pinv fallback to
        identity (calc_mvdr_weights, beamformer.cc:2350-2402)."""
        if self._R is None:
            raise RuntimeError("set a spatial spectral matrix before calc_mvdr_weights()")
        self._require_weights()
        wqH = np.asarray(
            bf.mvdr_weights(jnp.asarray(self._R), jnp.asarray(self._wq), float(dThreshold))
        )
        self._wmvdr = np.conj(wqH).astype(np.complex64)
        self.wq_manifold = self._wmvdr  # stored weights, e^{-j.} convention
        return True

    def mvdr_weights(self, fbinX: int) -> np.ndarray:
        return self._wmvdr[fbinX]

    def _produce(self) -> np.ndarray:
        self._require_weights()
        if self._wmvdr is None:
            raise RuntimeError("call calc_mvdr_weights() once")
        X = self._pull_snapshots()
        Y = np.einsum("fc,fc->f", np.conj(self._wmvdr), X)
        return self._mirror(Y)

    # legacy aliases
    def calcMVDRWeights(self, sampleRate, dThreshold=1.0e-8, calcInverseMatrix=True):
        return self.calc_mvdr_weights(sampleRate, dThreshold, calcInverseMatrix)

    def getMVDRWeights(self, fbinX):
        return self.mvdr_weights(fbinX)

    def getNoiseSpatialSpectralMatrix(self, fbinX=None):
        return self.noise_spatial_spectral_matrix(fbinX)

    def setNoiseSpatialSpectralMatrix(self, fbinX, Rnn):
        return self.set_noise_spatial_spectral_matrix(fbinX, Rnn)

    def setDiffuseNoiseModel(self, micPositions, sampleRate, sspeed=343740.0):
        return self.set_diffuse_noise_model(micPositions, sampleRate, sspeed)

    def setAllLevelsOfDiagonalLoading(self, diagonalWeight):
        self.set_all_diagonal_loading(diagonalWeight)

    def setLevelOfDiagonalLoading(self, fbinX, diagonalWeight):
        self.set_diagonal_looading(fbinX, diagonalWeight)

    def divideAllNonDiagonalElements(self, mu):
        self.divide_all_nondiagonal_elements(mu)

    def divideNonDiagonalElements(self, fbinX, mu):
        self.divide_nondiagonal_elements(fbinX, mu)


SubbandMVDRPtr = SubbandMVDR


class SubbandMVDRGSC(SubbandMVDR):
    """MVDR upper branch + blocking-matrix lower branch
    (SubbandMVDRGSC, beamformer.cc:2604-2775).

    ``calc_blocking_matrix1`` orthogonalizes against the D&S manifold;
    ``calc_blocking_matrix2`` against the MVDR weights themselves;
    ``upgrade_blocking_matrix`` re-orthogonalizes against ``wq - wl``."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandMVDR"):
        # [sic] the default name really is "SubbandMVDR" in the reference
        # (beamformer.h:406)
        super().__init__(fftLen, halfBandShift, nm)
        self._normalize_weight = False

    def normalize_weight(self, flag: bool) -> None:
        self._normalize_weight = bool(flag)

    def set_active_weights_f(self, fbinX: int, packedWeight) -> None:
        if self._B is None:
            raise RuntimeError("set the quiescent vector once")
        wa = _packed_to_complex(packedWeight)
        self._wa[fbinX] = wa
        self._wl[fbinX] = self._B[fbinX] @ wa

    def zero_active_weights(self) -> None:
        self._wa[:] = 0
        self._wl[:] = 0

    def blocking_matrix(self, srcX: int, fbinX: int) -> np.ndarray:
        """B at one bin (BeamformerWeights::B accessor, beamformer.h:60)."""
        return self._B[fbinX]

    def calc_blocking_matrix1(self, samplerate: float, delaysT) -> bool:
        """B orthogonal to the D&S manifold (beamformer.cc:2638-2644)."""
        self.calc_array_manifold_vectors(samplerate, delaysT)
        self._B = np.asarray(bf.blocking_matrix(jnp.asarray(self._wq), Nc=1))
        return True

    def calc_blocking_matrix2(self) -> bool:
        """B orthogonal to the MVDR weights; also copies wmvdr into wq for
        bins 1..M/2 (beamformer.cc:2650-2672)."""
        if self._wmvdr is None:
            return False
        if self._B is None:
            self._alloc_weights(self.chanN(), NC=1)
        self._wq[1:] = self._wmvdr[1:]
        self.wq_manifold = self._wq
        self._B[1:] = np.asarray(
            bf.blocking_matrix(jnp.asarray(self._wq[1:]), Nc=1)
        )
        return True

    def upgrade_blocking_matrix(self) -> None:
        """Re-orthogonalize B against the total weight ``wq - wl``
        (beamformer.cc:2675-2691; bins 1..M/2 here — the C++ touches the
        mirrored upper bins too, but they are never read on the
        halfBandShift=false path)."""
        w = self._wq[1:] - self._wl[1:]
        self._B[1:] = np.asarray(bf.blocking_matrix(jnp.asarray(w), Nc=self._NC))

    def blocking_matrix_output(self, outChanX: int = 0) -> np.ndarray:
        """Column ``outChanX`` of B applied to the current snapshots:
        ``b_i^H X`` over bins 0..M/2 (beamformer.cc:2694-2718).  The C++
        leaves the upper half of its output buffer stale; here it is
        conjugate-mirrored (the only consumer, SubbandOrthogonalizer,
        feeds synthesis banks that expect a hermitian layout)."""
        X = self.last_snapshot
        if X is None:
            X = self._pull_snapshots()
        bi = self._B[:, :, outChanX]  # [F, C]
        Y = np.einsum("fc,fc->f", np.conj(bi), X)
        return self._mirror(Y)

    def _produce(self) -> np.ndarray:
        if self._wmvdr is None:
            raise RuntimeError("call calc_mvdr_weights() once")
        X = self._pull_snapshots()
        w = self._wmvdr - self._wl
        if self._normalize_weight:
            nrm = np.linalg.norm(w, axis=-1, keepdims=True)
            w = w / (np.where(nrm > 0, nrm, 1.0) * self.chanN())
        Y = np.einsum("fc,fc->f", np.conj(w), X)
        Y[0] = np.vdot(self._wmvdr[0], X[0])
        return self._mirror(Y)

    # legacy aliases
    def setActiveWeights_f(self, fbinX, packedWeight):
        self.set_active_weights_f(fbinX, packedWeight)

    def zeroActiveWeights(self):
        self.zero_active_weights()

    def calcBlockingMatrix1(self, sampleRate, delaysT):
        return self.calc_blocking_matrix1(sampleRate, delaysT)

    def calcBlockingMatrix2(self):
        return self.calc_blocking_matrix2()

    def upgradeBlockingMatrix(self):
        self.upgrade_blocking_matrix()

    def blockingMatrixOutput(self, outChanX=0):
        return self.blocking_matrix_output(outChanX)


SubbandMVDRGSCPtr = SubbandMVDRGSC


class SubbandOrthogonalizer(FeatureStream):
    """Expose a SubbandMVDRGSC branch as a stream: ``outChanX <= 0`` is the
    beamformer output, ``outChanX >= 1`` is blocking-matrix column
    ``outChanX - 1`` (SubbandOrthogonalizer::next, beamformer.cc:2781-2806)."""

    def __init__(self, beamformer: SubbandMVDRGSC, outChanX: int = 0,
                 nm: str = "SubbandOrthogonalizer"):
        super().__init__(beamformer.fftLen(), nm)
        self._beamformer = beamformer
        self._outChanX = int(outChanX)

    def _produce(self) -> np.ndarray:
        if self._outChanX <= 0:
            return np.asarray(self._beamformer.next(self._frame_no + 1))
        self._beamformer.next(self._frame_no + 1)
        return np.asarray(self._beamformer.blocking_matrix_output(self._outChanX - 1))

    def _reset(self):
        self._beamformer.reset()


SubbandOrthogonalizerPtr = SubbandOrthogonalizer


class SubbandBlockingMatrix(SubbandGSC):
    """GSC whose next() emits the same (wq - B wa)^H X output — the C++
    implementation is byte-identical to SubbandGSC::next
    (beamformer.cc:2808-2874)."""

    def __init__(self, fftLen: int = 512, halfBandShift: bool = False,
                 nm: str = "SubbandBlockingMatrix"):
        super().__init__(fftLen, halfBandShift, nm)


SubbandBlockingMatrixPtr = SubbandBlockingMatrix
