"""ctypes bindings for the native host runtime (runtime/native/streamio.cc).

The shared library is built on demand with g++ (no pybind11 in this image;
plain C ABI + ctypes).  Falls back cleanly: `native_available()` gates use,
and utils.wavio covers the same surface in pure Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "streamio.cc")
_LIB = os.path.join(_HERE, "native", "libstreamio.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return None
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except Exception as e:  # toolchain missing
        return str(e)
    if r.returncode != 0:
        return r.stderr
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        _build_error = _build()
        if _build_error is not None:
            return None
        lib = ctypes.CDLL(_LIB)
        lib.wav_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_read_planar_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.wav_read_planar_f32.restype = ctypes.c_int
        lib.wav_write_planar_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.wav_write_planar_f32.restype = ctypes.c_int
        lib.frame_blocks_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.frame_blocks_f32.restype = ctypes.c_int64
        lib.batch_read_planar_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.batch_read_planar_f32.restype = ctypes.c_int
        lib.stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.stream_open.restype = ctypes.c_void_p
        lib.stream_read_block.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.stream_read_block.restype = ctypes.c_int64
        lib.stream_close.argtypes = [ctypes.c_void_p]
        lib.stream_close.restype = None
        lib.resample_sinc_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.resample_sinc_f32.restype = ctypes.c_int64
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_wav_native(path: str) -> tuple[np.ndarray, int]:
    """Read a 16-bit WAV -> (float32 [channels, T], samplerate) via the
    native reader."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    c = ctypes.c_int32()
    r = ctypes.c_int32()
    n = ctypes.c_int64()
    rc = lib.wav_info(path.encode(), ctypes.byref(c), ctypes.byref(r), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"wav_info({path}) failed: {rc}")
    out = np.empty((c.value, n.value), np.float32)
    rc = lib.wav_read_planar_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
    )
    if rc != 0:
        raise IOError(f"wav_read_planar_f32({path}) failed: {rc}")
    return out, r.value


def write_wav_native(path: str, data: np.ndarray, samplerate: int) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    data = np.ascontiguousarray(np.atleast_2d(np.asarray(data, np.float32)))
    rc = lib.wav_write_planar_f32(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0],
        data.shape[1],
        samplerate,
    )
    if rc != 0:
        raise IOError(f"wav_write_planar_f32({path}) failed: {rc}")


def wav_info_native(path: str) -> tuple[int, int, int]:
    """Header-only probe -> (channels, samplerate, num_frames)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    c = ctypes.c_int32()
    r = ctypes.c_int32()
    n = ctypes.c_int64()
    rc = lib.wav_info(path.encode(), ctypes.byref(c), ctypes.byref(r), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"wav_info({path}) failed: {rc}")
    return c.value, r.value, n.value


def read_wav_batch_native(paths, channels: int, T_pad: int,
                          num_threads: int = 0,
                          normalize: bool = True) -> np.ndarray:
    """Threaded batch WAV loader -> float32 ``[B, channels, T_pad]``.

    Each file is zero-padded / truncated to ``T_pad`` frames and to
    ``channels`` channels (the static device batch shape).  Files are read
    concurrently by the native thread pool (``num_threads<=0`` = hardware
    concurrency) — the data-loader stage feeding the device.
    ``normalize=False`` returns raw int16-scale floats (the reference's
    SampleFeature norm=0.0 default).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    encoded = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty((len(paths), channels, T_pad), np.float32)
    rc = lib.batch_read_planar_f32(
        arr,
        len(encoded),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        channels,
        T_pad,
        num_threads,
    )
    if rc != 0:
        raise IOError(f"batch_read_planar_f32 failed: {rc}")
    if not normalize:
        out *= 32768.0
    return out


class NativeStreamReader:
    """O(1)-memory incremental block reader (IterativeSingleChannelSample-
    Feature equivalent, feature/feature.h:237-322)."""

    def __init__(self, path: str, channel: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.stream_open(path.encode(), channel)
        if not self._h:
            raise IOError(f"stream_open({path}, ch={channel}) failed")

    def read_block(self, block_len: int) -> np.ndarray | None:
        """Next zero-padded block, or None at end of stream."""
        out = np.empty(block_len, np.float32)
        got = self._lib.stream_read_block(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), block_len
        )
        if got <= 0:
            return None
        return out

    def __iter__(self):
        raise TypeError("use read_block(block_len)")

    def close(self):
        if self._h:
            self._lib.stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def resample_native(x: np.ndarray, src_rate: int, dst_rate: int,
                    half_taps: int = 32, num_threads: int = 0) -> np.ndarray:
    """Windowed-sinc sample-rate conversion on the host
    (SamplerateConversionFeature, feature/feature.h:775-809 — the reference
    wraps libsamplerate; this is the native host equivalent).

    ``x``: float32 ``[..., T]``; returns ``[..., floor(T*dst/src)]``.  The
    Blackman-Harris-windowed sinc doubles as the anti-alias filter on
    downsampling; rows of a 2-D input are converted through the same
    thread pool.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    lead = x.shape[:-1]
    T = x.shape[-1]
    n_out = T * int(dst_rate) // int(src_rate)
    flat = x.reshape(-1, T)
    out = np.empty((flat.shape[0], n_out), np.float32)
    for i in range(flat.shape[0]):
        got = lib.resample_sinc_f32(
            flat[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T,
            int(src_rate),
            int(dst_rate),
            out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_out,
            int(half_taps),
            int(num_threads),
        )
        if got < 0:
            raise RuntimeError(f"resample_sinc_f32 failed: {got}")
    return out.reshape(lead + (n_out,))
