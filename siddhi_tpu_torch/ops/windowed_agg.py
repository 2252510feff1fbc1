"""Sliding length-window aggregation step (BASELINE config 2 path).

Counterpart of ``siddhi_tpu/ops/windowed_agg.py``: the length-window
contract of ``build_wagg_step`` (jnp scan, ``:53``) and
``build_wagg_step_pallas`` (the TPU kernel, ``:185``), which the JAX
package documents as identical semantics.  The port computes it with

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
