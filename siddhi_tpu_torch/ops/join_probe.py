"""The join probe's compaction (K11).

Counterpart of the compaction inside the JAX package's ``probe`` closure
(``siddhi_tpu/core/join.py:367``, ``:384-390``): the on-condition's
``[nl2, nr2]`` mask over an arriving chunk (rows, padded to a power of
two) and the opposite buffer (columns, padded likewise) becomes the
first ``cap`` matching flat row-major indices (``i * nr2 + j``, the
host's emission order), int32 with fill -1, and the exact count, int32.
Only the valid rows and columns (``i < nl``, ``j < nr``) count.  The
condition's mask itself is a torch program (``core/join.py``).

:func:`probe_compact_plain` is the PyTorch twin (``nonzero_static`` and
a sum, as the JAX package's ``jnp.nonzero(size=cap, fill_value=-1)``
and ``jnp.sum``); :func:`probe_compact` the entry: CPU tensors run the
twin, CUDA tensors launch ``probe_compact`` (``csrc/join_probe.cu``), an
order-preserving compaction written by hand.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
