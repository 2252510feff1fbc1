"""Sliding length- and time-window aggregation steps (BASELINE config 2).

Counterpart of ``siddhi_tpu/ops/windowed_agg.py``: the length-window
contract of ``build_wagg_step`` (jnp scan, ``:53``) and
``build_wagg_step_pallas`` (the TPU kernel, ``:185``), which the JAX
package documents as identical semantics, and the time-window contract
of ``build_time_wagg_step`` (``:125``; below, after the length half).
The port computes the length window with

  - :func:`wagg_step_plain` — PyTorch over ``[P]`` lanes, a Python loop
    over the block's T events.  Used for CPU tensors and by the checks.
  - the hand-written Hopper kernel ``csrc/wagg_length.cu`` — launched by
    :func:`wagg_step` for CUDA tensors.

State per partition/group lane (the same carry as the JAX package):

    ring   [P, W] f32 — last W accepted values, written round-robin
    pos    [P] i32    — next write slot
    cnt    [P] i32    — entries held (<= W)
    runsum [P] f32    — Kahan-compensated running sum of the live slots
    comp   [P] f32    — its compensation term

After every event the step emits the running sum and count (and, with
``want_minmax``, the min/max over the live slots).  Events with
``accepted=False`` leave the state alone and repeat the previous output.

Evicted value: the slot ``ring[p, pos]`` is read directly, as the Pallas
kernel does.  The JAX package's jnp twin reads it as ``sum(ring * onehot)``,
which turns NaN as soon as any live slot holds ±inf; the two agree on
finite data.

Filter and value projection run OUTSIDE the step (plan/expr_compiler with
the torch namespace): the step consumes ``(values, accepted)`` lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._kernels import load_kernel


class WaggCarry(NamedTuple):
    ring: torch.Tensor      # [P, W] f32
    pos: torch.Tensor       # [P] i32 — next write slot
    cnt: torch.Tensor       # [P] i32 — entries held (<= W)
    runsum: torch.Tensor    # [P] f32
    comp: torch.Tensor      # [P] f32 — Kahan compensation for runsum


CARRY_DTYPES = (torch.float32, torch.int32, torch.int32, torch.float32,
                torch.float32)


def kernel_device(device=None) -> torch.device:
    """The torch device ``device`` names, ``"cuda"`` when it is None.  A
    CUDA device with no CUDA present raises ``RuntimeError`` (never a
    silent CPU run)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device engine on '{dev}' but torch.cuda.is_available() is "
            f"False; pass SiddhiManager(device='cpu') to run the plain "
            f"PyTorch versions, or @app:engine('host')")
    return dev


def make_wagg_carry(n_partitions: int, window: int,
                    device=None) -> WaggCarry:
    """An empty carry on ``device`` (default: the card, see
    :func:`kernel_device`)."""
    z = dict(device=kernel_device(device))
    return WaggCarry(
        ring=torch.zeros((n_partitions, window), dtype=torch.float32, **z),
        pos=torch.zeros((n_partitions,), dtype=torch.int32, **z),
        cnt=torch.zeros((n_partitions,), dtype=torch.int32, **z),
        runsum=torch.zeros((n_partitions,), dtype=torch.float32, **z),
        comp=torch.zeros((n_partitions,), dtype=torch.float32, **z))


def wagg_step_plain(carry: WaggCarry, values: torch.Tensor,
                    accepted: torch.Tensor, want_minmax: bool = False
                    ) -> Tuple[WaggCarry, tuple]:
    """The step in plain PyTorch: ``(carry, values [P,T] f32, accepted
    [P,T] bool) → (new carry, (sums [P,T] f32, counts [P,T] i32[, mins,
    maxs]))``.  Functional: the input carry is not modified."""
    ring = carry.ring.clone()
    pos, cnt, runsum, comp = carry.pos, carry.cnt, carry.runsum, carry.comp
    P, W = ring.shape
    T = values.shape[1]
    dev = ring.device
    lane = torch.arange(P, device=dev)
    slot = torch.arange(W, device=dev, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    sums = torch.empty((P, T), dtype=torch.float32, device=dev)
    counts = torch.empty((P, T), dtype=torch.int32, device=dev)
    if want_minmax:
        mins = torch.empty((P, T), dtype=torch.float32, device=dev)
        maxs = torch.empty((P, T), dtype=torch.float32, device=dev)
    for t in range(T):
        x = values[:, t]
        ok = accepted[:, t]
        old = ring[lane, pos.long()]
        delta = x - torch.where(cnt == W, old, zero)
        # Kahan-compensated add, the JAX package's lines verbatim
        y = delta - comp
        tt = runsum + y
        comp = torch.where(ok, (tt - runsum) - y, comp)
        runsum = torch.where(ok, tt, runsum)
        ring[lane, pos.long()] = torch.where(ok, x, old)
        pos = torch.where(ok, (pos + 1) % W, pos)
        cnt = torch.where(ok, torch.clamp(cnt + 1, max=W), cnt)
        sums[:, t] = runsum
        counts[:, t] = cnt
        if want_minmax:
            # live slots are [0, cnt) in fill order
            valid = slot[None, :] < cnt[:, None]
            mins[:, t] = torch.where(valid, ring, inf).amin(dim=1)
            maxs[:, t] = torch.where(valid, ring, -inf).amax(dim=1)
    outs = (sums, counts) + ((mins, maxs) if want_minmax else ())
    return WaggCarry(ring, pos, cnt, runsum, comp), outs


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"wagg_step: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"wagg_step: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"wagg_step: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wagg_step: {name} is not contiguous")


def wagg_step(carry: WaggCarry, values: torch.Tensor,
              accepted: torch.Tensor, want_minmax: bool = False
              ) -> Tuple[WaggCarry, tuple]:
    """The step on the tensors' own device.

    CPU tensors run :func:`wagg_step_plain`.  CUDA tensors launch the
    ``wagg_length_step`` kernel on the current stream, which updates the
    carry IN PLACE (the JAX package donates it instead) and returns the
    same carry object; a failed build, load or launch raises — there is
    no fallback to the plain version.  Where a lane's working set does
    not fit in shared memory (large W or T) the kernel works from device
    scratch allocated here.  The kernel's min/max path takes the carry
    invariant every step keeps: ``pos == cnt`` while ``cnt < W``."""
    dev = values.device
    if dev.type == "cpu":
        return wagg_step_plain(carry, values, accepted, want_minmax)
    if dev.type != "cuda":
        raise RuntimeError(f"wagg_step: no kernel for device {dev}")
    P, W = carry.ring.shape
    T = values.shape[1] if values.dim() == 2 else -1
    _check("values", values, torch.float32, (P, T), dev)
    _check("accepted", accepted, torch.bool, (P, T), dev)
    for name, leaf, dt in zip(WaggCarry._fields, carry, CARRY_DTYPES):
        _check(name, leaf, dt, (P, W) if name == "ring" else (P,), dev)
    lib = load_kernel("wagg_length")
    nscratch = lib.wagg_length_scratch_bytes(P, T, W, int(want_minmax))
    scratch = (torch.empty(nscratch, dtype=torch.uint8, device=dev)
               if nscratch else None)
    sums = torch.empty((P, T), dtype=torch.float32, device=dev)
    counts = torch.empty((P, T), dtype=torch.int32, device=dev)
    mins: Optional[torch.Tensor] = None
    maxs: Optional[torch.Tensor] = None
    if want_minmax:
        mins = torch.empty((P, T), dtype=torch.float32, device=dev)
        maxs = torch.empty((P, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wagg_length_step(
        values.data_ptr(), accepted.data_ptr(), carry.ring.data_ptr(),
        carry.pos.data_ptr(), carry.cnt.data_ptr(),
        carry.runsum.data_ptr(), carry.comp.data_ptr(),
        sums.data_ptr(), counts.data_ptr(),
        mins.data_ptr() if want_minmax else None,
        maxs.data_ptr() if want_minmax else None,
        P, T, W, int(want_minmax),
        scratch.data_ptr() if scratch is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"wagg_length_step: launch failed with CUDA "
                           f"error {rc}")
    wagg_step.launches += 1
    outs = (sums, counts) + ((mins, maxs) if want_minmax else ())
    return carry, outs


#: launches of the CUDA kernel since the last reset (plain runs excluded)
wagg_step.launches = 0


def build_wagg_step(window: int, want_minmax: bool = False):
    """The JAX package's builder signature: ``fn(carry, values, accepted)
    → (carry, outs)``, :func:`wagg_step` on the tensors' device (the
    window is the carry's)."""
    def step(carry: WaggCarry, values, accepted):
        return wagg_step(carry, values, accepted, want_minmax)
    return step


def build_wagg_step_pallas(window: int, t_per_block: int,
                           want_minmax: bool = False):
    """The JAX package's Pallas builder: its port is the hand kernel
    behind :func:`wagg_step` (``csrc/wagg_length.cu``), which takes any
    T, so this is :func:`build_wagg_step`."""
    return build_wagg_step(window, want_minmax)


# ------------------------------------------------------------- time windows

#: empty-slot timestamp marker of the time ring (the JAX package's)
TS_EMPTY = int(np.iinfo(np.int32).min)


class TimeWaggCarry(NamedTuple):
    """The JAX package's time-window carry, leaf for leaf."""
    ring: torch.Tensor      # [P, C] f32 — the last C accepted values
    ring_ts: torch.Tensor   # [P, C] i32 — their ts offsets (TS_EMPTY: empty)
    pos: torch.Tensor       # [P] i32 — next write slot
    cnt: torch.Tensor       # [P] i32 — entries written (<= C)
    last_ts: torch.Tensor   # [P] i32 — most recent accepted ts offset
    overflow: torch.Tensor  # [P] bool — sticky: a still-in-window entry was
    #                         evicted (the caller grows C and replays)


TIME_CARRY_DTYPES = (torch.float32, torch.int32, torch.int32, torch.int32,
                     torch.int32, torch.bool)


def make_time_wagg_carry(n_partitions: int, capacity: int,
                         device=None) -> TimeWaggCarry:
    """An empty time carry on ``device`` (default: the card)."""
    z = dict(device=kernel_device(device))
    return TimeWaggCarry(
        ring=torch.zeros((n_partitions, capacity), dtype=torch.float32, **z),
        ring_ts=torch.full((n_partitions, capacity), TS_EMPTY,
                           dtype=torch.int32, **z),
        pos=torch.zeros((n_partitions,), dtype=torch.int32, **z),
        cnt=torch.zeros((n_partitions,), dtype=torch.int32, **z),
        last_ts=torch.zeros((n_partitions,), dtype=torch.int32, **z),
        overflow=torch.zeros((n_partitions,), dtype=torch.bool, **z))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (jnp's int32 arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def pair_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by the pairwise tree of the time kernel: the
    row padded with ``+0.0`` to a power of two, then adjacent pairs
    (``x[2i] + x[2i + 1]``) level by level."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (width - n,))], -1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def time_wagg_step_plain(window_ms: int, carry: TimeWaggCarry,
                         values: torch.Tensor, ts: torch.Tensor,
                         accepted: torch.Tensor, want_minmax: bool = False
                         ) -> Tuple[TimeWaggCarry, tuple]:
    """The time step in plain PyTorch, vectorised over P with a Python loop
    over T: ``(carry, values [P,T] f32, ts [P,T] i32 offsets, accepted
    [P,T] bool) → (new carry, (sums, counts[, mins, maxs]))``.

    Per event, as ``build_time_wagg_step``'s lane step: the event's slot
    sets the sticky overflow when it still holds an entry inside the
    window (ring full and its ts > t - window_ms), an accepted event
    overwrites it, then the outputs are a fresh masked reduction over the
    slots ``[0, cnt)`` with ts > t - window_ms — also for a rejected
    event, against its own ts.  The sum is :func:`pair_tree_sum` (the
    kernel's order; the JAX package's XLA reduction may order it
    otherwise); min/max are IEEE (NaN propagates, -0.0 < +0.0).
    Functional: the input carry is not modified."""
    from .grouped_agg import _masked_extreme
    ring = carry.ring.clone()
    rts = carry.ring_ts.clone()
    pos, cnt, last, ovf = carry.pos, carry.cnt, carry.last_ts, \
        carry.overflow
    P, C = ring.shape
    T = values.shape[1]
    dev = ring.device
    lane = torch.arange(P, device=dev)
    slot = torch.arange(C, device=dev, dtype=torch.int32)
    sums = torch.empty((P, T), dtype=torch.float32, device=dev)
    counts = torch.empty((P, T), dtype=torch.int32, device=dev)
    if want_minmax:
        mins = torch.empty((P, T), dtype=torch.float32, device=dev)
        maxs = torch.empty((P, T), dtype=torch.float32, device=dev)
    for t in range(T):
        x, tt, ok = values[:, t], ts[:, t], accepted[:, t]
        cut = _wrap32(tt.long() - window_ms)
        at = pos.long()
        old_ts = rts[lane, at]
        ovf = ovf | (ok & (cnt == C) & (old_ts > cut))
        ring[lane, at] = torch.where(ok, x, ring[lane, at])
        rts[lane, at] = torch.where(ok, tt, old_ts)
        pos = torch.where(ok, (pos + 1) % C, pos)
        cnt = torch.where(ok, torch.clamp(cnt + 1, max=C), cnt)
        last = torch.where(ok, tt, last)
        valid = (slot[None, :] < cnt[:, None]) & (rts > cut[:, None])
        sums[:, t] = pair_tree_sum(torch.where(valid, ring,
                                               torch.zeros_like(ring)))
        counts[:, t] = valid.sum(dim=1, dtype=torch.int32)
        if want_minmax:
            mins[:, t] = _masked_extreme(ring, valid, 1, True)
            maxs[:, t] = _masked_extreme(ring, valid, 1, False)
    outs = (sums, counts) + ((mins, maxs) if want_minmax else ())
    return TimeWaggCarry(ring, rts, pos.to(torch.int32),
                         cnt.to(torch.int32), last, ovf), outs


def time_wagg_step(window_ms: int, carry: TimeWaggCarry,
                   values: torch.Tensor, ts: torch.Tensor,
                   accepted: torch.Tensor, want_minmax: bool = False
                   ) -> Tuple[TimeWaggCarry, tuple]:
    """The time step on the tensors' own device.

    CPU tensors run :func:`time_wagg_step_plain`.  CUDA tensors launch
    ``csrc/wagg_time.cu`` on the current stream, which writes a FRESH
    carry: the caller replays a block from the carry it passed in when
    the step reports an overflow (the JAX package does not donate it
    either).  A failed build, load or launch raises — there is no
    fallback to the plain version."""
    dev = values.device
    if dev.type == "cpu":
        return time_wagg_step_plain(window_ms, carry, values, ts, accepted,
                                    want_minmax)
    if dev.type != "cuda":
        raise RuntimeError(f"time_wagg_step: no kernel for device {dev}")
    P, C = carry.ring.shape
    T = values.shape[1] if values.dim() == 2 else -1
    _check("values", values, torch.float32, (P, T), dev)
    _check("ts", ts, torch.int32, (P, T), dev)
    _check("accepted", accepted, torch.bool, (P, T), dev)
    for name, leaf, dt in zip(TimeWaggCarry._fields, carry,
                              TIME_CARRY_DTYPES):
        _check(name, leaf, dt, (P, C) if name.startswith("ring") else (P,),
               dev)
    new, outs = time_wagg_launch(load_kernel("wagg_time"), window_ms, carry,
                                 values, ts, accepted, want_minmax,
                                 torch.cuda.current_stream(dev).cuda_stream)
    time_wagg_step.launches += 1
    return new, outs


def time_wagg_launch(lib, window_ms: int, carry: TimeWaggCarry,
                     values: torch.Tensor, ts: torch.Tensor,
                     accepted: torch.Tensor, want_minmax: bool, stream
                     ) -> Tuple[TimeWaggCarry, tuple]:
    """Allocate the fresh carry, the output planes and the scratch
    (``lib.wagg_time_scratch_bytes``) on the inputs' device and call
    ``lib.wagg_time_step`` (the loaded kernel) on ``stream``; raises on a
    non-zero CUDA error."""
    P, C = carry.ring.shape
    T = values.shape[1]
    dev = values.device
    nscratch = int(lib.wagg_time_scratch_bytes(P, T, C))
    scratch = torch.empty((max(nscratch, 1),), dtype=torch.uint8,
                          device=dev)
    new = TimeWaggCarry(*[torch.empty_like(a) for a in carry])
    sums = torch.empty((P, T), dtype=torch.float32, device=dev)
    counts = torch.empty((P, T), dtype=torch.int32, device=dev)
    mins = maxs = None
    if want_minmax:
        mins = torch.empty((P, T), dtype=torch.float32, device=dev)
        maxs = torch.empty((P, T), dtype=torch.float32, device=dev)
    rc = lib.wagg_time_step(
        values.data_ptr(), ts.data_ptr(), accepted.data_ptr(),
        *[a.data_ptr() for a in carry], *[a.data_ptr() for a in new],
        sums.data_ptr(), counts.data_ptr(),
        mins.data_ptr() if want_minmax else None,
        maxs.data_ptr() if want_minmax else None,
        scratch.data_ptr(), nscratch, P, T, C, int(window_ms),
        int(want_minmax), stream)
    if rc != 0:
        raise RuntimeError(f"wagg_time_step: launch failed with CUDA error "
                           f"{rc}")
    outs = (sums, counts) + ((mins, maxs) if want_minmax else ())
    return new, outs


#: launches of the CUDA kernel since the last reset (plain runs excluded)
time_wagg_step.launches = 0

#: events a CTA of csrc/wagg_time.cu's events pass takes (kChunk)
TIME_CHUNK = 64


def time_split_model(window_ms: int, carry: TimeWaggCarry,
                     values: torch.Tensor, ts: torch.Tensor,
                     accepted: torch.Tensor, want_minmax: bool = False,
                     chunk: int = TIME_CHUNK
                     ) -> Tuple[TimeWaggCarry, tuple]:
    """The CPU model of ``csrc/wagg_time.cu``, pass for pass, on CPU
    tensors (:func:`time_wagg_step_plain`'s contract):

      prep    per lane, A_t (accepted events up to and including event
              t) and X, the lane's entries in write order: the carry's
              slot (pos0 + j) % C at j < C, the a-th accepted event at
              C + a; the overflow (the a-th accepted event, with cnt0 + a
              >= C, evicts X[a] while X[a].ts > its ts - window_ms), the
              ring at A_T and the carry's scalars;
      events  per event, slot s holds X[A_t + ((s - pos0 - A_t) mod C)],
              read from the window [A_e0, A_e1 + C) its CTA of ``chunk``
              events holds (asserted); the masked leaves summed by the
              pairwise tree over the C slots padded to a power of two,
              the count and the IEEE min / max."""
    from .grouped_agg import _masked_extreme
    P, C = carry.ring.shape
    T = values.shape[1]
    pos0 = carry.pos.numpy().astype(np.int64)
    cnt0 = carry.cnt.numpy().astype(np.int64)
    ok = accepted.numpy().astype(bool)
    vbits = values.numpy().view(np.int32)
    tsn = ts.numpy().astype(np.int64)

    def wrap(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    # prep
    acnt = np.cumsum(ok, axis=1, dtype=np.int64)
    n = acnt[:, -1] if T else np.zeros(P, np.int64)
    rot = (pos0[:, None] + np.arange(C)[None, :]) % C
    xv = np.zeros((P, C + T), np.int32)
    xt = np.zeros((P, C + T), np.int64)
    xv[:, :C] = np.take_along_axis(carry.ring.numpy().view(np.int32), rot, 1)
    xt[:, :C] = np.take_along_axis(carry.ring_ts.numpy(), rot, 1)
    ovf = carry.overflow.numpy().copy()
    last = carry.last_ts.numpy().copy()
    for p in range(P):
        k = int(n[p])
        xv[p, C:C + k] = vbits[p, ok[p]]
        xt[p, C:C + k] = tsn[p, ok[p]]
        a = np.arange(k)
        ovf[p] |= bool(((cnt0[p] + a >= C) &
                        (xt[p, a] > wrap(xt[p, C + a] - window_ms))).any())
        if k:
            last[p] = xt[p, C + k - 1]
    slot = np.arange(C)[None, :]
    j_end = n[:, None] + (slot - pos0[:, None] - n[:, None]) % C
    new = TimeWaggCarry(
        torch.from_numpy(np.take_along_axis(xv, j_end, 1).view(np.float32)),
        torch.from_numpy(np.take_along_axis(xt, j_end, 1).astype(np.int32)),
        torch.from_numpy(((pos0 + n) % C).astype(np.int32)),
        torch.from_numpy(np.minimum(cnt0 + n, C).astype(np.int32)),
        torch.from_numpy(last.astype(np.int32)), torch.from_numpy(ovf))
    # events
    t = np.arange(T)
    e0 = (t // chunk) * chunk
    e1 = np.minimum(e0 + chunk, T)
    A = acnt[:, :, None]                                    # [P, T, 1]
    jj = A + (slot[None] - pos0[:, None, None] - A) % C     # [P, T, C]
    lo = acnt[:, e0][:, :, None]
    hi = acnt[:, e1 - 1][:, :, None] + C
    assert ((jj >= lo) & (jj < hi)).all(), "a leaf outside its window"
    lane = np.arange(P)[:, None, None]
    leaf = torch.from_numpy(xv[lane, jj].view(np.float32))
    cnt_t = np.minimum(cnt0[:, None] + acnt, C)[:, :, None]
    cut = wrap(tsn - window_ms)[:, :, None]
    valid = torch.from_numpy((slot[None] < cnt_t) & (xt[lane, jj] > cut))
    sums = pair_tree_sum(torch.where(valid, leaf, torch.zeros_like(leaf)))
    outs = (sums, valid.sum(dim=2, dtype=torch.int32))
    if want_minmax:
        outs += (_masked_extreme(leaf, valid, 2, True),
                 _masked_extreme(leaf, valid, 2, False))
    return new, outs


def build_time_wagg_step(window_ms: int, capacity: int,
                         want_minmax: bool = False):
    """The JAX package's builder signature: ``fn(carry, values, ts,
    accepted) → (carry, outs)``, :func:`time_wagg_step` on the tensors'
    device (the capacity is the carry's)."""
    def step(carry: TimeWaggCarry, values, ts, accepted):
        return time_wagg_step(window_ms, carry, values, ts, accepted,
                              want_minmax)
    return step
