"""ctypes bindings for the native host data path (native/eventpack.cpp).

Everything here has a pure-numpy fallback: the package works without the
compiled .so (`make -C native` builds it).  The native path exists because
per-event Python loops are the one host-side bottleneck between sources and
the [P, T] device lanes — the same role the LMAX Disruptor ring plays in the
reference's @Async junctions (stream/StreamJunction.java:280-316).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "_native.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.assign_rows.restype = ctypes.c_int64
    lib.assign_rows.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                i32p, i32p]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int64
    lib.ring_push.argtypes = [ctypes.c_void_p, f64p, i64p, i32p, i32p,
                              ctypes.c_int64]
    lib.ring_drain.restype = ctypes.c_int64
    lib.ring_drain.argtypes = [ctypes.c_void_p, f64p, i64p, i32p, i32p,
                               ctypes.c_int64]
    lib.ring_size.restype = ctypes.c_int64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_dropped.restype = ctypes.c_int64
    lib.ring_dropped.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def have_native() -> bool:
    return _load() is not None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def assign_rows(pids: np.ndarray,
                n_partitions: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-partition running row index for [P, T] lane packing.

    Returns (rows [n] int32, counts [P] int32, T)."""
    pids = np.ascontiguousarray(pids, np.int32)
    n = len(pids)
    if n and (pids.min() < 0 or pids.max() >= n_partitions):
        # the native path would heap-write out of bounds and the numpy
        # fallback would silently wrap negatives — reject both up front
        raise ValueError(
            f"partition ids must be in [0, {n_partitions}); got range "
            f"[{int(pids.min())}, {int(pids.max())}]")
    rows = np.empty(n, np.int32)
    counts = np.empty(n_partitions, np.int32)
    lib = _load()
    if lib is not None:
        t = lib.assign_rows(_i32p(pids), n, n_partitions, _i32p(rows),
                            _i32p(counts))
        return rows, counts, max(int(t), 1)
    # numpy path: a stable sort groups each partition's events in input
    # order, so an event's row is its rank inside its group
    counts[:] = np.bincount(pids, minlength=n_partitions)
    order = np.argsort(pids, kind="stable")
    starts = np.cumsum(counts) - counts
    rows[order] = np.arange(n, dtype=np.int32) - np.repeat(starts, counts)
    return rows, counts, max(int(counts.max()) if n else 1, 1)


class ColumnarRing:
    """Multi-producer numeric event ring (native when built, else a locked
    numpy deque).  Rows: (values[n_cols] f64, ts i64, stream i32, part i32)."""

    def __init__(self, capacity: int, n_cols: int):
        self.capacity = capacity
        self.n_cols = n_cols
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.ring_create(capacity, n_cols)
            if not self._h:
                raise MemoryError("ring_create failed")
        else:
            import threading
            self._h = None
            self._lock = threading.Lock()
            self._items = []
            self._dropped = 0

    def push(self, values: np.ndarray, ts: np.ndarray,
             stream: np.ndarray, partition: np.ndarray) -> int:
        values = np.ascontiguousarray(values, np.float64).reshape(
            -1, self.n_cols)
        m = len(values)
        ts = np.ascontiguousarray(ts, np.int64)
        stream = np.ascontiguousarray(stream, np.int32)
        partition = np.ascontiguousarray(partition, np.int32)
        if self._lib is not None:
            return int(self._lib.ring_push(
                self._h,
                values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _i32p(stream), _i32p(partition), m))
        with self._lock:
            space = self.capacity - sum(len(v) for v, *_ in self._items)
            take = min(m, max(space, 0))
            if take:
                self._items.append((values[:take].copy(), ts[:take].copy(),
                                    stream[:take].copy(),
                                    partition[:take].copy()))
            self._dropped += m - take
            return take

    def drain(self, max_rows: int):
        """→ (values [m, n_cols], ts [m], stream [m], partition [m])."""
        if self._lib is not None:
            out_v = np.empty((max_rows, self.n_cols), np.float64)
            out_t = np.empty(max_rows, np.int64)
            out_s = np.empty(max_rows, np.int32)
            out_p = np.empty(max_rows, np.int32)
            m = int(self._lib.ring_drain(
                self._h,
                out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _i32p(out_s), _i32p(out_p), max_rows))
            return out_v[:m], out_t[:m], out_s[:m], out_p[:m]
        with self._lock:
            if not self._items:
                z = np.empty((0, self.n_cols), np.float64)
                return (z, np.empty(0, np.int64), np.empty(0, np.int32),
                        np.empty(0, np.int32))
            vs, tss, ss, ps = zip(*self._items)
            self._items.clear()
            v = np.concatenate(vs)
            t = np.concatenate(tss)
            s = np.concatenate(ss)
            p = np.concatenate(ps)
            if len(v) > max_rows:
                self._items.append((v[max_rows:], t[max_rows:],
                                    s[max_rows:], p[max_rows:]))
            return (v[:max_rows], t[:max_rows], s[:max_rows], p[:max_rows])

    def __len__(self):
        if self._lib is not None:
            return int(self._lib.ring_size(self._h))
        with self._lock:
            return sum(len(v) for v, *_ in self._items)

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_dropped(self._h))
        return self._dropped

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.ring_destroy(self._h)
            self._h = None
