"""The join probe (K11): the fused probe and the mask route's compaction.

Counterpart of the JAX package's ``probe`` closure
(``siddhi_tpu/core/join.py:367``, ``:384-390``): the on-condition over the
cross product of an arriving chunk (rows, padded to a power of two, nl2)
and the opposite buffer (columns, padded likewise, nr2), AND the valid
rows and columns (``i < nl``, ``j < nr``), as the first ``cap`` matching
flat row-major indices (``i * nr2 + j``, the host's emission order),
int32 with fill -1, and the exact count, int32.

Two routes, chosen per join at build (``core/join.py``):

- **fused**: the condition lowered to a :class:`~siddhi_tpu_torch.plan.
  join_program.ProbeProgram`.  :func:`probe_fused_plain` interprets it
  with torch ops over the broadcast lanes, then compacts with
  :func:`probe_compact_plain`; :func:`probe_fused` runs it on CUDA
  tensors as one kernel (``csrc/join_probe.cu probe_fused``) that never
  writes a mask.
- **mask**: a condition outside the program's class runs as a torch
  program that writes the ``[nl2, nr2]`` mask; :func:`probe_compact`
  compacts it (CUDA: ``csrc/join_probe.cu probe_compact``), and
  :func:`probe_compact_plain` is its twin (``nonzero_static`` and a sum,
  as the JAX package's ``jnp.nonzero(size=cap, fill_value=-1)`` and
  ``jnp.sum``).

On CPU tensors each entry runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..plan import join_program as jp
from ._kernels import load_kernel

#: flat indices are int32, as in the JAX package (``core/join.py`` runs a
#: larger probe in blocks of rows)
MAX_CELLS = (1 << 31) - 1


def _bounds(mask, nl: int, nr: int, fn: str) -> Tuple[int, int]:
    if mask.dim() != 2:
        raise ValueError(f"{fn}: mask must be 2-D, got {tuple(mask.shape)}")
    nl2, nr2 = mask.shape
    if not (0 <= nl <= nl2 and 0 <= nr <= nr2):
        raise ValueError(f"{fn}: valid bounds ({nl}, {nr}) outside the "
                         f"mask's shape ({nl2}, {nr2})")
    if nl2 * nr2 > MAX_CELLS:
        raise ValueError(f"{fn}: {nl2} x {nr2} cells exceed int32 indices")
    return nl2, nr2


def probe_compact_plain(mask, nl: int, nr: int, cap: int):
    """(idx [cap] int32, count [] int32): the first ``cap`` flat indices
    of the valid set cells of ``mask``, row-major, -1 past the count;
    the count is exact even above ``cap``."""
    nl2, nr2 = _bounds(mask, nl, nr, "probe_compact_plain")
    dev = mask.device
    m = mask.to(torch.bool) \
        & (torch.arange(nl2, device=dev) < nl)[:, None] \
        & (torch.arange(nr2, device=dev) < nr)[None, :]
    flat = m.reshape(-1)
    idx = torch.nonzero_static(flat, size=cap, fill_value=-1)
    return idx.reshape(-1).to(torch.int32), flat.sum(dtype=torch.int32)


def probe_compact(mask, nl: int, nr: int, cap: int):
    """The compaction on the mask's own device: a CPU mask runs
    :func:`probe_compact_plain`; a CUDA mask (bool or uint8, contiguous)
    launches the kernel on the current stream and counts the launch in
    ``probe_compact.launches``.  A failed build, load or launch raises:
    there is no fallback to the twin."""
    dev = mask.device
    if dev.type == "cpu":
        return probe_compact_plain(mask, nl, nr, cap)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_compact: no kernel for device {dev}")
    nl2, nr2 = _bounds(mask, nl, nr, "probe_compact")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"probe_compact: mask is {mask.dtype}, expected "
                        f"bool or uint8")
    if not mask.is_contiguous():
        raise ValueError("probe_compact: mask is not contiguous")
    if cap < 0:
        raise ValueError(f"probe_compact: cap {cap} < 0")
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = load_kernel("join_probe")
    nbytes = lib.probe_scratch_bytes(nl2, nr2)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.probe_compact(mask.data_ptr(), nl, nr, nl2, nr2, cap,
                           idx.data_ptr(), count.data_ptr(),
                           scratch.data_ptr(), nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"probe_compact: launch failed with CUDA error "
                           f"{rc}")
    probe_compact.launches += 1
    return idx, count


#: launches of the CUDA kernel since the last reset (twin runs excluded)
probe_compact.launches = 0


# ------------------------------------------------------------ fused route

def _cells(nl, nr, nl2, nr2, fn):
    if not (0 <= nl <= nl2 and 0 <= nr <= nr2):
        raise ValueError(f"{fn}: valid bounds ({nl}, {nr}) outside the "
                         f"padded shape ({nl2}, {nr2})")
    if nl2 * nr2 > MAX_CELLS:
        raise ValueError(f"{fn}: {nl2} x {nr2} cells exceed int32 indices")


def _lanes(prog, lanes_l, lanes_r, nl2, nr2, fn):
    for side, got, n in ((0, lanes_l, nl2), (1, lanes_r, nr2)):
        want = prog.lanes[side]
        if len(got) != len(want):
            raise ValueError(f"{fn}: {len(got)} lanes on side {side}, the "
                             f"program reads {len(want)}")
        for name, t in zip(want, got):
            dt = torch.int32 if name.startswith("__") else torch.float32
            if t.dtype != dt or t.shape != (n,):
                raise ValueError(f"{fn}: lane {name} is {t.dtype} "
                                 f"{tuple(t.shape)}, expected {dt} ({n},)")


def _run_code(code, consts, lanes, slots):
    """Interpret a side's postfix ``code`` with torch ops.  Every value is
    an int32 tensor of bit patterns (f32 values viewed as int32;
    conditions 0/1), as the kernel's 32-bit words; STORE fills
    ``slots``."""
    f32, i32 = torch.float32, torch.int32
    st = []
    for w in code:
        op, arg = int(w) & 0xff, int(w) >> 8
        if op == jp.OP_LANE:
            st.append(lanes[arg])
        elif op == jp.OP_CONST:
            st.append(consts[arg])
        elif op == jp.OP_I2F:
            st.append(st.pop().to(f32).view(i32))
        elif op == jp.OP_NOT:
            st.append((st.pop() == 0).to(i32))
        elif op == jp.OP_STORE:
            slots[arg] = st.pop()
        else:
            b, a = st.pop(), st.pop()
            if op in (jp.OP_ADD, jp.OP_SUB, jp.OP_MUL, jp.OP_DIV):
                a, b = a.view(f32), b.view(f32)
                r = (a + b if op == jp.OP_ADD else a - b if op == jp.OP_SUB
                     else a * b if op == jp.OP_MUL else a / b)
                st.append(r.view(i32))
            elif op in (jp.OP_CMPF, jp.OP_CMPI):
                if op == jp.OP_CMPF:
                    a, b = a.view(f32), b.view(f32)
                st.append(_compare(arg, a, b).to(i32))
            elif op == jp.OP_AND:
                st.append(((a != 0) & (b != 0)).to(i32))
            elif op == jp.OP_OR:
                st.append(((a != 0) | (b != 0)).to(i32))
            else:
                raise ValueError(f"join program: opcode {op}")


def _compare(c, a, b):
    return (a < b if c == jp.CMP_LT else a <= b if c == jp.CMP_LE
            else a > b if c == jp.CMP_GT else a >= b if c == jp.CMP_GE
            else a == b if c == jp.CMP_EQ else a != b)


def _device_of(lanes_l, lanes_r, device):
    lanes = list(lanes_l) + list(lanes_r)
    return lanes[0].device if lanes else torch.device(device)


def probe_fused_plain(prog, lanes_l: Sequence, lanes_r: Sequence, nl: int,
                      nr: int, nl2: int, nr2: int, cap: int,
                      device="cpu"):
    """(idx [cap] int32, count [] int32) of the program's condition over
    the ``[nl2, nr2]`` cross product of ``lanes_l`` ([nl2] each, in
    ``prog.lanes[0]`` order) and ``lanes_r`` ([nr2] each): the side
    programs, the atoms over the broadcast slots, the and/or/not tree,
    then :func:`probe_compact_plain`.  ``device`` places a program that reads
    no lane."""
    _cells(nl, nr, nl2, nr2, "probe_fused_plain")
    _lanes(prog, lanes_l, lanes_r, nl2, nr2, "probe_fused_plain")
    dev = _device_of(lanes_l, lanes_r, device)
    i32 = torch.int32
    consts = [torch.tensor(int(np.int32(np.uint32(c).view(np.int32))),
                           dtype=i32, device=dev) for c in prog.consts]
    code = prog.code
    L, R = prog.left_len, prog.right_len
    lslots, rslots = {}, {}
    _run_code(code[:L], consts, [t.view(i32) for t in lanes_l], lslots)
    _run_code(code[L:L + R], consts, [t.view(i32) for t in lanes_r], rslots)
    operands = {jp.K_LSLOT: {k: v[:, None] for k, v in lslots.items()},
                jp.K_RSLOT: {k: v[None, :] for k, v in rslots.items()},
                jp.K_CONST: consts}
    vals = []
    for op, is_i, xk, xa, yk, ya in prog.atoms.tolist():
        x, y = operands[xk][xa], operands[yk][ya]
        if not is_i:
            x, y = x.view(torch.float32), y.view(torch.float32)
        vals.append(_compare(op, x, y))
    st = []
    for w in prog.tree.tolist():
        op, arg = w & 0xff, w >> 8
        if op == jp.T_ATOM:
            st.append(vals[arg])
        elif op in (jp.T_TRUE, jp.T_FALSE):
            st.append(torch.tensor(op == jp.T_TRUE, device=dev))
        elif op == jp.T_NOT:
            st.append(~st.pop())
        else:
            b, a = st.pop(), st.pop()
            st.append(a & b if op == jp.T_AND else a | b)
    mask = torch.broadcast_to(st[0], (nl2, nr2))
    return probe_compact_plain(mask, nl, nr, cap)


#: the host block of a fused launch (csrc/join_probe.cu kHdr...): header
#: ints, then code, constants, atoms and tree at fixed offsets
HDR = 16
CODE_AT = HDR
CONSTS_AT = CODE_AT + jp.MAX_CODE
ATOMS_AT = CONSTS_AT + jp.MAX_CONSTS
TREE_AT = ATOMS_AT + 6 * jp.MAX_ATOMS
BLOCK_INTS = TREE_AT + jp.MAX_TREE


def kernel_block(prog, nl: int, nr: int, nl2: int, nr2: int,
                 cap: int) -> np.ndarray:
    """The int32 block ``probe_fused`` reads: header (code lengths, counts,
    the bounds and cap, the tree's length), code, constants, atoms,
    tree."""
    blk = np.zeros(BLOCK_INTS, np.int32)
    blk[:15] = [prog.left_len, prog.right_len, len(prog.code),
                len(prog.consts), prog.n_atoms, prog.n_slots[0],
                prog.n_slots[1], len(prog.lanes[0]), len(prog.lanes[1]),
                nl, nr, nl2, nr2, cap, len(prog.tree)]
    blk[CODE_AT:CODE_AT + len(prog.code)] = prog.code
    blk[CONSTS_AT:CONSTS_AT + len(prog.consts)] = \
        prog.consts.view(np.int32)
    blk[ATOMS_AT:ATOMS_AT + prog.atoms.size] = prog.atoms.reshape(-1)
    blk[TREE_AT:TREE_AT + len(prog.tree)] = prog.tree
    return blk


def probe_fused(prog, lanes_l: Sequence, lanes_r: Sequence, nl: int,
                nr: int, nl2: int, nr2: int, cap: int, device="cuda"):
    """The fused probe on the lanes' device (``device`` for a program
    that reads no lane): CPU lanes run :func:`probe_fused_plain`; CUDA
    lanes (contiguous) launch ``probe_fused`` on the current stream and
    count the launch in ``probe_fused.launches``.  A failed build, load
    or launch raises: there is no fallback to the plain version or the
    mask route."""
    lanes = list(lanes_l) + list(lanes_r)
    dev = _device_of(lanes_l, lanes_r, device)
    if dev.type == "cpu":
        return probe_fused_plain(prog, lanes_l, lanes_r, nl, nr, nl2, nr2,
                                 cap, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_fused: no kernel for device {dev}")
    import ctypes
    _cells(nl, nr, nl2, nr2, "probe_fused")
    _lanes(prog, lanes_l, lanes_r, nl2, nr2, "probe_fused")
    if cap < 0:
        raise ValueError(f"probe_fused: cap {cap} < 0")
    for t in lanes:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("probe_fused: lanes must be contiguous on one "
                             "device")
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = load_kernel("join_probe")
    blk = kernel_block(prog, nl, nr, nl2, nr2, cap)
    cblk = blk.ctypes.data_as(ctypes.c_void_p)
    ptrs = (ctypes.c_void_p * (2 * jp.MAX_LANES))()
    for k, t in enumerate(lanes_l):
        ptrs[k] = t.data_ptr()
    for k, t in enumerate(lanes_r):
        ptrs[jp.MAX_LANES + k] = t.data_ptr()
    nbytes = lib.probe_fused_scratch_bytes(cblk)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.probe_fused(cblk, ptrs, idx.data_ptr(), count.data_ptr(),
                         scratch.data_ptr(), nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"probe_fused: launch failed with CUDA error "
                           f"{rc}")
    probe_fused.launches += 1
    return idx, count


#: launches of the CUDA kernel since the last reset (plain runs excluded)
probe_fused.launches = 0
