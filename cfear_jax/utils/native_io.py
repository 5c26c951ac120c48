"""ctypes bindings for the native radar data plane (`native/cfear_io.cpp`).

Builds the shared library on demand with g++ (cached next to the source).
Provides:
- `pack_sequence`: PNG directory / ndarray -> packed binary sweep file
- `RadarPack`: mmap reader
- `PrefetchLoader`: background-thread batch prefetcher feeding fixed-size
  uint8 batches, so device transfers overlap disk IO.

Falls back to a NumPy implementation when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "cfear_io.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libcfear_io.so")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", _SRC, "-o", _LIB],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_LIB)
            lib.cfear_pack_create.restype = ctypes.c_void_p
            lib.cfear_pack_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                              ctypes.c_uint64, ctypes.c_uint64]
            lib.cfear_pack_append.restype = ctypes.c_int
            lib.cfear_pack_append.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                              ctypes.c_void_p, ctypes.c_uint64,
                                              ctypes.c_uint64]
            lib.cfear_pack_close_writer.argtypes = [ctypes.c_void_p]
            lib.cfear_pack_open.restype = ctypes.c_void_p
            lib.cfear_pack_open.argtypes = [ctypes.c_char_p]
            lib.cfear_pack_info.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_uint64)] * 3
            lib.cfear_pack_read.restype = ctypes.c_int
            lib.cfear_pack_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                            ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_uint64)]
            lib.cfear_pack_close.argtypes = [ctypes.c_void_p]
            lib.cfear_loader_create.restype = ctypes.c_void_p
            lib.cfear_loader_create.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint64,
                                                ctypes.c_uint64, ctypes.c_int]
            lib.cfear_loader_next.restype = ctypes.c_uint64
            lib.cfear_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_uint64)]
            lib.cfear_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.cfear_filter_frames.restype = None
            lib.cfear_filter_frames.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.cfear_frame_thresholds.restype = None
            lib.cfear_frame_thresholds.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.cfear_filter_frames_z.restype = None
            lib.cfear_filter_frames_z.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.cfear_cfar_filter_frames.restype = None
            lib.cfear_cfar_filter_frames.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.cfear_budget_compact.restype = None
            lib.cfear_budget_compact.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def pack_frames(path: str,
                frames: Iterator[Tuple[float, np.ndarray]],
                n_frames: int) -> None:
    """Write (timestamp_s, (A, R) uint8) frames into a radar pack file."""
    frames = iter(frames)
    first_stamp, first = next(frames)
    a, r = first.shape
    lib = _load_lib()
    if lib is not None:
        h = lib.cfear_pack_create(path.encode(), n_frames, a, r)
        if not h:
            raise OSError(f"cannot create pack '{path}'")

        def append(stamp, img):
            img = np.ascontiguousarray(img, np.uint8)
            lib.cfear_pack_append(h, int(stamp * 1e9),
                                  img.ctypes.data_as(ctypes.c_void_p), a, r)

        append(first_stamp, first)
        for stamp, img in frames:
            append(stamp, img)
        lib.cfear_pack_close_writer(h)
        return
    # numpy fallback: same byte layout
    with open(path, "wb") as f:
        hdr = np.array([0x5241444152504b31, n_frames, a, r], np.uint64)
        f.write(hdr.tobytes())
        f.write(np.uint64(int(first_stamp * 1e9)).tobytes())
        f.write(np.ascontiguousarray(first, np.uint8).tobytes())
        for stamp, img in frames:
            f.write(np.uint64(int(stamp * 1e9)).tobytes())
            f.write(np.ascontiguousarray(img, np.uint8).tobytes())


class RadarPack:
    """mmap reader over a packed sweep file."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = self._lib.cfear_pack_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open pack '{path}'")
            n = ctypes.c_uint64()
            a = ctypes.c_uint64()
            r = ctypes.c_uint64()
            self._lib.cfear_pack_info(self._h, ctypes.byref(n),
                                      ctypes.byref(a), ctypes.byref(r))
            self.n_frames, self.n_azimuths, self.n_bins = (
                n.value, a.value, r.value)
        else:
            self._mm = np.memmap(path, np.uint8, "r")
            hdr = self._mm[:32].view(np.uint64)
            assert hdr[0] == 0x5241444152504b31
            self.n_frames, self.n_azimuths, self.n_bins = (
                int(hdr[1]), int(hdr[2]), int(hdr[3]))
            self._h = None

    def read(self, idx: int) -> Tuple[float, np.ndarray]:
        a, r = self.n_azimuths, self.n_bins
        if self._h is not None:
            out = np.empty((a, r), np.uint8)
            stamp = ctypes.c_uint64()
            rc = self._lib.cfear_pack_read(
                self._h, idx, out.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(stamp))
            if rc != 0:
                raise IndexError(idx)
            return stamp.value * 1e-9, out
        fb = 8 + a * r
        off = 32 + idx * fb
        stamp = self._mm[off:off + 8].view(np.uint64)[0]
        img = self._mm[off + 8:off + fb].reshape(a, r).copy()
        return float(stamp) * 1e-9, img

    def close(self):
        if self._h is not None:
            self._lib.cfear_pack_close(self._h)
            self._h = None


def frame_thresholds_host(images: np.ndarray, q: float, z_min: int,
                          n_threads: int = 8) -> np.ndarray:
    """Per-frame adaptive noise thresholds (host twin of
    `ops/filtering.py:frame_noise_threshold`, exact integer rule):
    out[f] = max(z_min, q_thr + 1), q_thr the smallest uint8 value whose
    frame CDF reaches ceil(q * A * R) pixels."""
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim == 2:
        images = images[None]
    t, a, r = images.shape
    q_count = int(np.ceil(q * a * r))
    out = np.empty((t,), np.int32)
    lib = _load_lib()
    if lib is not None and hasattr(lib, "cfear_frame_thresholds"):
        lib.cfear_frame_thresholds(
            images.ctypes.data_as(ctypes.c_void_p), t, a, r, q_count, z_min,
            out.ctypes.data_as(ctypes.c_void_p), n_threads)
    else:
        for f in range(t):
            hist = np.bincount(images[f].ravel(), minlength=256)
            q_thr = int(np.argmax(np.cumsum(hist) >= q_count))
            out[f] = max(z_min, q_thr + 1)
    return out


def filter_frames_host(images: np.ndarray, k: int, z_min: int,
                       nms_window: int = 3, n_threads: int = 8,
                       z_quantile: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side k-strongest + axial-NMS filter over (T, A, R) uint8 sweeps.

    The data-plane half of the split ingest pipeline: reduces each sweep to
    its (A, K) candidate set (selected range bins, intensities, NMS peak
    flags) before the host->device transfer, ~25x fewer bytes on the link.
    Bit-identical to the on-device filter (`ops/filtering.py`:
    `kstrongest_mask` + `nms_peak_image`; reference semantics
    `radar_filters.cpp:209-298`). Returns (bins (T, A, K) int16 with -1 for
    empty slots, intensities (T, A, K) uint8, peaks (T, A, K) uint8).
    """
    images = np.ascontiguousarray(images, np.uint8)
    squeeze = images.ndim == 2
    if squeeze:
        images = images[None]
    t, a, r = images.shape
    lib = _load_lib()
    bins = np.empty((t, a, k), np.int16)
    intens = np.empty((t, a, k), np.uint8)
    peaks = np.empty((t, a, k), np.uint8)
    z_frames = None
    if z_quantile:
        z_frames = frame_thresholds_host(images, z_quantile, z_min,
                                         n_threads)
    if lib is not None and z_frames is not None             and hasattr(lib, "cfear_filter_frames_z"):
        lib.cfear_filter_frames_z(
            images.ctypes.data_as(ctypes.c_void_p), t, a, r, k,
            z_frames.ctypes.data_as(ctypes.c_void_p),
            nms_window, bins.ctypes.data_as(ctypes.c_void_p),
            intens.ctypes.data_as(ctypes.c_void_p),
            peaks.ctypes.data_as(ctypes.c_void_p), n_threads)
    elif lib is not None and z_frames is None:
        lib.cfear_filter_frames(
            images.ctypes.data_as(ctypes.c_void_p), t, a, r, k, z_min,
            nms_window, bins.ctypes.data_as(ctypes.c_void_p),
            intens.ctypes.data_as(ctypes.c_void_p),
            peaks.ctypes.data_as(ctypes.c_void_p), n_threads)
    elif z_frames is not None:
        for f in range(t):
            _filter_frames_numpy(images[f:f + 1], k, int(z_frames[f]),
                                 nms_window, bins[f:f + 1], intens[f:f + 1],
                                 peaks[f:f + 1])
    else:
        _filter_frames_numpy(images, k, z_min, nms_window, bins, intens,
                             peaks)
    if squeeze:
        return bins[0], intens[0], peaks[0]
    return bins, intens, peaks


def _filter_frames_numpy(images, k, z_min, w, bins, intens, peaks):
    """Vectorized NumPy fallback with identical semantics."""
    t, a, r = images.shape
    shift = 1
    while shift < r:
        shift <<= 1
    img = images.astype(np.int32)
    bidx = np.arange(r, dtype=np.int32)
    # NMS score / windowed max (zero-padded borders)
    pad = np.pad(img, ((0, 0), (0, 0), (w, w)))
    cs = np.pad(np.cumsum(pad, axis=-1), ((0, 0), (0, 0), (1, 0)))
    score = cs[..., 2 * w + 1:] - cs[..., :-(2 * w + 1)]
    winmax = score.copy()
    for s in range(1, w + 1):
        winmax[..., :-s] = np.maximum(winmax[..., :-s], score[..., s:])
        winmax[..., s:] = np.maximum(winmax[..., s:], score[..., :-s])
    interior = (bidx >= w) & (bidx < r - w)
    is_peak = (score >= winmax) & interior
    key = np.where(img >= z_min, img * shift + bidx, -1)
    # top-k per row, descending
    part = np.argpartition(-key, k - 1, axis=-1)[..., :k]
    topv = np.take_along_axis(key, part, axis=-1)
    order = np.argsort(-topv, axis=-1, kind="stable")
    topv = np.take_along_axis(topv, order, axis=-1)
    valid = topv >= 0
    b = np.where(valid, topv % shift, -1)
    bins[...] = b.astype(np.int16)
    intens[...] = np.where(valid, topv // shift, 0).astype(np.uint8)
    peaks[...] = np.where(
        valid, np.take_along_axis(is_peak, np.maximum(b, 0), axis=-1),
        False).astype(np.uint8)


def budget_compact_host(bins: np.ndarray, intens: np.ndarray,
                        peaks: np.ndarray, budget: int, min_bin: int,
                        n_threads: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Compact (T, A, K) candidate sets to exactly `budget` rows per frame.

    Selection and output order: (intensity descending, flat azimuth-major
    index ascending) among candidates passing the `bin > min_bin` range gate
    — the identical set AND order the device-side point_budget compaction
    produces (`ops/features.py`: stable argsort of -intensity over the
    flattened cloud whose validity includes the min-range gate of
    `radar_filters.cpp:324-330`), so downstream results are bit-identical.
    Returns (bins (T, P) int16 with -1 padding, azimuths (T, P) int16,
    intensities (T, P) uint8, peaks (T, P) uint8).
    """
    squeeze = bins.ndim == 2
    if squeeze:
        bins, intens, peaks = bins[None], intens[None], peaks[None]
    t, a, k = bins.shape
    bins = np.ascontiguousarray(bins, np.int16)
    intens = np.ascontiguousarray(intens, np.uint8)
    peaks = np.ascontiguousarray(peaks, np.uint8)
    ob = np.empty((t, budget), np.int16)
    oa = np.empty((t, budget), np.int16)
    oi = np.empty((t, budget), np.uint8)
    op = np.empty((t, budget), np.uint8)
    lib = _load_lib()
    if lib is not None:
        lib.cfear_budget_compact(
            bins.ctypes.data_as(ctypes.c_void_p),
            intens.ctypes.data_as(ctypes.c_void_p),
            peaks.ctypes.data_as(ctypes.c_void_p), t, a, k, budget, min_bin,
            ob.ctypes.data_as(ctypes.c_void_p),
            oa.ctypes.data_as(ctypes.c_void_p),
            oi.ctypes.data_as(ctypes.c_void_p),
            op.ctypes.data_as(ctypes.c_void_p), n_threads)
    else:
        _budget_compact_numpy(bins, intens, peaks, budget, min_bin,
                              ob, oa, oi, op)
    if squeeze:
        return ob[0], oa[0], oi[0], op[0]
    return ob, oa, oi, op


def _budget_compact_numpy(bins, intens, peaks, budget, min_bin,
                          ob, oa, oi, op):
    """Vectorized NumPy fallback with identical selection semantics."""
    t, a, k = bins.shape
    gate = bins > min_bin                        # covers the -1 padding too
    key = np.where(gate, intens.astype(np.int32), -1).reshape(t, a * k)
    order = np.argsort(-key, axis=-1, kind="stable")[:, :budget]
    sel_key = np.take_along_axis(key, order, axis=-1)
    valid = sel_key >= 0
    flat = lambda x: x.reshape(t, a * k)
    ob[...] = np.where(valid, np.take_along_axis(flat(bins), order, -1), -1)
    oa[...] = np.where(valid, (order // k).astype(np.int16), 0)
    oi[...] = np.where(valid, np.take_along_axis(flat(intens), order, -1), 0)
    op[...] = np.where(valid, np.take_along_axis(flat(peaks), order, -1), 0)


def filter_frames_host_compact(images: np.ndarray, k: int, z_min: int,
                               nms_window: int, budget: int, min_bin: int,
                               n_threads: int = 8, z_quantile: float = 0.0
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """k-strongest filter + point-budget compaction in one host pass.

    The production data-plane ingest: (T, A, R) uint8 sweeps -> (T, budget)
    compacted candidate rows (bins, azimuths, intensities, peak flags).
    Removes the device-side argsort compaction and carries ~25% fewer bytes
    over the link than the (A, K) candidate form."""
    bins, intens, peaks = filter_frames_host(images, k, z_min, nms_window,
                                             n_threads,
                                             z_quantile=z_quantile)
    return budget_compact_host(bins, intens, peaks, budget, min_bin,
                               n_threads)


def cfar_filter_frames_host(images: np.ndarray, cfg, n_threads: int = 8
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side exclusive CA-CFAR filter over (T, A, R) uint8 sweeps.

    CFAR twin of `filter_frames_host` for the split-ingest data plane:
    bit-identical to the device filter (`ops/filtering.py`: `cacfar_mask` +
    `cfar_select`; reference semantics `cfar.cpp:35-71` dispatched
    exclusively per `radar_driver.cpp:52-57`). Returns (bins (T, A, Kc)
    int16 with -1 empty, intensities (T, A, Kc) uint8, peaks (T, A, Kc)
    uint8 — all zero: the CFAR path has no peaks cloud)."""
    f, radar = cfg.filter, cfg.radar
    win, guard, kc = f.cfar_window, f.cfar_guard, f.cfar_max_per_azimuth
    alpha = (2 * win) * (f.false_alarm_rate ** (-1.0 / (2 * win)) - 1.0)
    images = np.ascontiguousarray(images, np.uint8)
    squeeze = images.ndim == 2
    if squeeze:
        images = images[None]
    t, a, r = images.shape
    bins = np.empty((t, a, kc), np.int16)
    intens = np.empty((t, a, kc), np.uint8)
    peaks = np.zeros((t, a, kc), np.uint8)
    lib = _load_lib()
    if lib is not None:
        lib.cfear_cfar_filter_frames(
            images.ctypes.data_as(ctypes.c_void_p), t, a, r, kc, win, guard,
            np.float32(alpha), np.float32(radar.range_res),
            np.float32(radar.min_distance), np.float32(f.cfar_max_distance),
            np.float32(f.static_threshold),
            bins.ctypes.data_as(ctypes.c_void_p),
            intens.ctypes.data_as(ctypes.c_void_p),
            peaks.ctypes.data_as(ctypes.c_void_p), n_threads)
    else:
        _cfar_filter_frames_numpy(images, kc, win, guard, alpha, radar,
                                  f, bins, intens)
    if squeeze:
        return bins[0], intens[0], peaks[0]
    return bins, intens, peaks


def _cfar_filter_frames_numpy(images, kc, win, guard, alpha, radar, f,
                              bins_out, intens_out):
    """Vectorized NumPy fallback with identical (f32 cross-multiplied)
    semantics."""
    t, a, r = images.shape
    sq = images.astype(np.int32) ** 2
    prefix = np.concatenate(
        [np.zeros((t, a, 1), np.int32), np.cumsum(sq, axis=-1)], -1)
    b = np.arange(r, dtype=np.int32)
    t_lo = np.clip(b - guard - win, 0, r)
    t_hi = np.clip(b - guard, 0, r)
    f_lo = np.clip(b + guard, 0, r)
    f_hi = np.clip(b + guard + win, 0, r)
    t_cnt, f_cnt = t_hi - t_lo, f_hi - f_lo
    t_sum = prefix[..., t_hi] - prefix[..., t_lo]
    f_sum = prefix[..., f_hi] - prefix[..., f_lo]
    lhs = (2 * sq * t_cnt * f_cnt).astype(np.float32)
    rhs = np.float32(alpha) * (t_sum * f_cnt + f_sum * t_cnt
                               ).astype(np.float32)
    rng = b.astype(np.float32) * np.float32(radar.range_res)
    det = ((rng > np.float32(radar.min_distance))
           & (rng < np.float32(f.cfar_max_distance))
           & (images.astype(np.float32) > np.float32(f.static_threshold))
           & (lhs > rhs) & (t_cnt > 0) & (f_cnt > 0))
    shift = 1
    while shift < r:
        shift <<= 1
    key = np.where(det, images.astype(np.int32) * shift + b, -1)
    part = np.argpartition(-key, kc - 1, axis=-1)[..., :kc]
    topv = np.take_along_axis(key, part, axis=-1)
    order = np.argsort(-topv, axis=-1, kind="stable")
    topv = np.take_along_axis(topv, order, axis=-1)
    valid = topv >= 0
    bins_out[...] = np.where(valid, topv % shift, -1).astype(np.int16)
    intens_out[...] = np.where(valid, topv // shift, 0).astype(np.uint8)


class PrefetchLoader:
    """Background-thread batched prefetch over a RadarPack (native when
    available, Python thread fallback otherwise)."""

    def __init__(self, pack: RadarPack, batch: int, depth: int = 3,
                 loop: bool = False):
        self.pack = pack
        self.batch = batch
        self._lib = _load_lib() if pack._h is not None else None
        if self._lib is not None:
            self._h = self._lib.cfear_loader_create(pack._h, batch, depth,
                                                    1 if loop else 0)
        else:
            self._h = None
            self._idx = 0
            self._loop = loop

    def next(self):
        """Returns (frames (n, A, R) uint8, stamps_s (n,), first_idx) or None
        at end of stream."""
        a, r = self.pack.n_azimuths, self.pack.n_bins
        if self._h is not None:
            data = np.empty((self.batch, a, r), np.uint8)
            stamps = np.empty(self.batch, np.uint64)
            first = ctypes.c_uint64()
            n = self._lib.cfear_loader_next(
                self._h, data.ctypes.data_as(ctypes.c_void_p),
                stamps.ctypes.data_as(ctypes.c_void_p), ctypes.byref(first))
            if n == 0:
                return None
            return data[:n], stamps[:n].astype(np.float64) * 1e-9, first.value
        if self._idx >= self.pack.n_frames:
            return None
        n = min(self.batch, self.pack.n_frames - self._idx)
        data = np.empty((n, a, r), np.uint8)
        stamps = np.empty(n)
        for k in range(n):
            stamps[k], data[k] = self.pack.read(self._idx + k)
        first = self._idx
        self._idx += n
        return data, stamps, first

    def close(self):
        if self._h is not None:
            self._lib.cfear_loader_destroy(self._h)
            self._h = None
