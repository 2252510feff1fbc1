"""Shared ingest pipelining and fused egress for device runtimes.

Counterpart of ``siddhi_tpu/plan/pipeline.py``.  A device runtime
dispatches each chunk's work at once and decodes its outputs up to
``depth`` chunks later, so the device→host read of chunk N overlaps the
dispatch of chunks N+1..N+D (≙ the ingest/compute overlap of the
reference's @Async disruptor junction, stream/StreamJunction.java:280-316).

Contract for subclasses:
  - call ``_init_pipeline(app, stream_ids)`` after ``self.qr`` is set;
  - dispatch device work in ``ingest`` and hand the un-read handles to
    ``_submit(work)``;
  - implement ``_retire(work)`` — wait for the handles, decode, emit
    (data errors raised there surface at the caller's @OnError
    boundary: a later ingest's submit or a junction flush);
  - any operation that mutates shared device state out-of-band (lane
    growth, snapshot, restore) must ``flush()`` first.

Depth resolution matches the JAX package: pipelining auto-enables iff
every input junction is @Async; ``@app:pipeline('D')`` forces a depth.

Device→host reads: :class:`HostCopy` starts a ``non_blocking`` copy of
device tensors into pinned host memory and records a CUDA event after it;
``wait()`` blocks on that event only.  CPU tensors need no copy.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..core.ledger import ledger as _ledger
from ..query_api.annotation import find_annotation

DEFAULT_DEPTH = 4

#: Fused per-app egress: every device runtime's output buffers for one
#: ingest block concatenate into ONE int32 slab read back with a single
#: D2H.  ``=0``/``off`` restores the per-runtime reads.
EGRESS_FUSE_ENV = "SIDDHI_TPU_EGRESS_FUSE"


def resolve_egress_fuse(fuse: Optional[bool] = None) -> bool:
    if fuse is None:
        raw = os.environ.get(EGRESS_FUSE_ENV, "").strip().lower()
        return raw not in ("0", "false", "off", "no")
    return bool(fuse)


def resolve_depth(app, junctions: Iterable[Any]) -> int:
    ann = find_annotation(app.annotations, "app:pipeline") or \
        find_annotation(app.annotations, "pipeline")
    if ann is not None:
        pos = ann.positional()
        return int(pos[0] if pos else ann.get("depth", str(DEFAULT_DEPTH)))
    if all(j.is_async for j in junctions):
        return DEFAULT_DEPTH
    return 0


class HostCopy:
    """Asynchronous device→host copy of a list of tensors: ``wait()``
    returns them as numpy arrays.  On CUDA each tensor is copied
    ``non_blocking`` into pinned memory on the current stream, and a CUDA
    event recorded after the copies is what ``wait()`` blocks on."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors: List[Any]):
        import torch
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach() for t in tensors]

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class PipelinedDeviceIngest:
    """In-flight chunk queue: dispatch now, read/decode ``depth`` chunks
    later (FIFO, so emission order is preserved)."""

    def _init_pipeline(self, app, stream_ids: Iterable[str]) -> None:
        self._inflight: "deque" = deque()
        self.pipeline_depth = resolve_depth(
            app.app, [app.junction_of(sid) for sid in stream_ids])
        # dispatch-storm watchdog (core/overload.py): every device
        # submission counts as ingest progress
        self._watchdog = getattr(app.app_ctx, "watchdog", None)

    def _submit(self, work: Dict[str, Any]) -> None:
        if self._watchdog is not None:
            self._watchdog.note_progress()
        self._inflight.append(work)
        while len(self._inflight) > self.pipeline_depth:
            with _ledger().span("decode"):
                self._retire(self._inflight.popleft())

    def flush(self) -> None:
        """Retire every in-flight chunk: called on idle/drain by the
        async junction and before any state read.  Takes the query lock
        (re-entrant) — state reads can race the junction worker."""
        with self.qr.lock:
            while self._inflight:
                with _ledger().span("decode"):
                    self._retire(self._inflight.popleft())

    def _retire(self, work: Dict[str, Any]) -> None:
        raise NotImplementedError


class _FuseToken:
    """One runtime's registration in a fuse group: fetch() returns the
    registered buffers as host ndarrays, decoded from the group's slab."""

    __slots__ = ("group", "index")

    def __init__(self, group: "_FuseGroup", index: int):
        self.group = group
        self.index = index

    def fetch(self) -> List[Any]:
        return self.group.fetch(self.index)


class _FuseGroup:
    """The buffers every device runtime registered during ONE ingest
    block.  seal() packs them into a single int32 slab on the device
    (float32 reinterpreted with ``view(torch.int32)``, bools widened) and
    starts its async D2H; the first fetch() waits for that one transfer
    and serves per-registration host views."""

    __slots__ = ("fuser", "entries", "owners", "sealed", "_copy", "_host")

    def __init__(self, fuser: "EgressFuser"):
        self.fuser = fuser
        self.entries: List[List[Any]] = []   # per-registration buffer list
        self.owners: set = set()
        self.sealed = False
        self._copy: Optional[HostCopy] = None
        self._host = None

    def seal(self) -> None:
        if self.sealed:
            return
        self.sealed = True
        import torch
        pieces = []
        for bufs in self.entries:
            for b in bufs:
                dt = str(b.dtype)
                if dt == "torch.float32":
                    pieces.append(b.reshape(-1).view(torch.int32))
                elif dt == "torch.int32":
                    pieces.append(b.reshape(-1))
                elif dt == "torch.bool":
                    pieces.append(b.reshape(-1).to(torch.int32))
        if pieces:
            # one registered buffer (a packed bucket's, plan/xtenant.py)
            # is read as it is: no concatenation
            self._copy = HostCopy([pieces[0] if len(pieces) == 1
                                   else torch.cat(pieces)])

    def fetch(self, index: int) -> List[Any]:
        with self.fuser._lock:
            if self is self.fuser._current:
                # a retire caught up with the open block (depth-0 lag):
                # close it so the slab covers what was registered
                self.fuser._rotate()
            self.seal()
            if self._host is None and self._copy is not None:
                with _ledger().span("egress_d2h"):
                    self._host = self._copy.wait()[0]      # the ONE D2H
                self.fuser.d2h_count += 1
                self.fuser.last_slab_bytes = self._host.nbytes
                from ..core.profiling import profiler
                profiler().record_d2h("egress.fuse", self._host.nbytes)
            out: List[Any] = []
            off = 0
            host = self._host
            for ri, bufs in enumerate(self.entries):
                for b in bufs:
                    dt = str(b.dtype)
                    shape = tuple(b.shape)
                    n = b.numel()
                    if dt in ("torch.float32", "torch.int32"):
                        view = host[off:off + n].view(
                            np.float32 if dt == "torch.float32"
                            else np.int32).reshape(shape)
                        off += n
                    elif dt == "torch.bool":
                        view = host[off:off + n].astype(bool).reshape(shape)
                        off += n
                    else:
                        # no 4-byte view: read separately
                        view = HostCopy([b]).wait()[0]
                    if ri == index:
                        out.append(view)
            return out


class EgressFuser:
    """Per-app egress consolidation: device runtimes register the un-read
    output buffers of each dispatched block; registrations between block
    boundaries form a group, and each group is read back as one slab.

    A runtime registers exactly once per ingest block, so a repeat
    registration by the same owner IS the next block — the open group
    seals (slab concat + async D2H start, overlapping later dispatches)
    and a fresh one opens.  With pipelining depth 0 a runtime retires
    inside its own ingest and groups degenerate to singletons."""

    def __init__(self, name: str = "app"):
        self.name = name
        self._lock = threading.RLock()
        self._current = _FuseGroup(self)
        self.d2h_count = 0
        self.blocks = 0
        #: size of the most recent fused slab read (flight ring)
        self.last_slab_bytes = 0

    def _rotate(self) -> None:
        grp = self._current
        self._current = _FuseGroup(self)
        self.blocks += 1
        grp.seal()

    def register(self, owner: Any, buffers: List[Any]) -> _FuseToken:
        with self._lock:
            if id(owner) in self._current.owners:
                self._rotate()
            grp = self._current
            grp.owners.add(id(owner))
            grp.entries.append(list(buffers))
            return _FuseToken(grp, len(grp.entries) - 1)


    def seal_block(self) -> None:
        """Close the open group explicitly.  The cross-tenant packer
        (plan/xtenant.py) registers a gang flush's bucket buffer and knows
        the block boundary exactly — sealing here starts the slab's D2H
        at once instead of at the next repeat registration."""
        with self._lock:
            if self._current.entries:
                self._rotate()


def egress_fuser_for(app) -> Optional[EgressFuser]:
    """The app runtime's shared fuser (lazily created), or None when
    EGRESS_FUSE_ENV disables fusion."""
    if app is None or not resolve_egress_fuse():
        return None
    fuser = getattr(app, "_egress_fuser", None)
    if fuser is None:
        fuser = EgressFuser(getattr(app, "name", None) or "app")
        app._egress_fuser = fuser
    return fuser
