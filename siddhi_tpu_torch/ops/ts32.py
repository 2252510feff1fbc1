"""Shared int32 timestamp-offset machinery for device state.

Counterpart of ``siddhi_tpu/ops/ts32.py``.  The JAX package keeps device
timestamps as int32 ms offsets from a host-held base because x64 is off
under jit; the port keeps the same protocol so state crosses between the
two packages unchanged.  After ~24.8 days of stream time the base must
move ("rebase") and every carried timestamp shifts with it.

Functions take and return numpy arrays or torch tensors: a torch input
comes back as a torch tensor on the same device.
"""
from __future__ import annotations

import numpy as np


def safe_max(slack_ms: int) -> int:
    """Largest representable offset, leaving headroom for `offset + slack`
    arithmetic (expiry subtraction, deadline addition) plus a 2^21 guard
    band so a whole ingest block fits past the check."""
    return (1 << 31) - (1 << 21) - (slack_ms + 1)


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):                 # torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _like(arr: np.ndarray, ref):
    """``arr`` as the same kind of array as ``ref`` (torch on ref's
    device, else numpy)."""
    if hasattr(ref, "detach"):
        import torch
        return torch.as_tensor(arr, device=ref.device)
    return arr


def shift_clamped(v, delta: int, lo: int):
    """Shift carried int32 ts offsets down by `delta`, clamping at `lo`
    in int64 so an arbitrarily large delta can't wrap int32 (anything at
    the clamp floor is expired at every future ts)."""
    s = _to_numpy(v).astype(np.int64) - delta
    return _like(np.maximum(s, lo).astype(np.int32), v)


def rebase_offsets(src: np.ndarray, valid: np.ndarray, base,
                   window_ms: int, ring_ts, empty_marker: int,
                   sentinels=None, site: str = "ts32"):
    """Shared i64→i32 offset rebase for time-window device rings.

    src: absolute i64 timestamps for the chunk (all rows); ONLY rows with
    `valid` participate in the base/range decisions — rejected rows may
    carry junk timestamps that must not pin or blow the base.  ring_ts:
    the carry's current i32 ts plane (empty slots == empty_marker), or
    None.  Returns (offsets i32 [n] — invalid rows zeroed, new_base,
    shifted_ring_ts or None).  Raises SiddhiAppRuntimeException on
    chunks that cannot be represented (data errors for the @OnError
    boundary)."""
    from ..utils.errors import SiddhiAppRuntimeException
    src = np.asarray(src, np.int64)
    valid = np.asarray(valid, bool)
    if not valid.any():
        return np.zeros(len(src), np.int32), base, ring_ts
    vsrc = src[valid]
    if base is None:
        base = int(vsrc.min())
    offs = src - base
    mx = int(offs[valid].max())
    safe = safe_max(window_ms)
    if mx <= safe and int(offs[valid].min()) < -safe:
        raise SiddhiAppRuntimeException(
            "time-window device path: an event timestamp is more than "
            "~24 days older than the stream's time base")
    new_ring = ring_ts
    if mx > safe:
        delta = int(offs[valid].min())
        base += delta
        offs = offs - delta
        if int(offs[valid].max()) > safe:
            raise SiddhiAppRuntimeException(
                "time-window device path: a single chunk spans more than "
                "~24 days of stream time; split the replay into smaller "
                "chunks or use @app:engine('host')")
        if ring_ts is not None:
            rts = _to_numpy(ring_ts).astype(np.int64)
            shifted = np.maximum(rts - delta, empty_marker + 1)
            new_ring = _like(np.where(rts == empty_marker, empty_marker,
                                      shifted).astype(np.int32), ring_ts)
        if sentinels is not None:
            # NUMGUARD witness (core/numguard.py): count the rebase and
            # report the horizon headroom left after the shift
            sentinels.note_rebase(site, safe - int(offs[valid].max()))
    return np.where(valid, offs, 0).astype(np.int32), base, new_ring
