"""Snapshot service + persistence stores.

(reference: util/snapshot/SnapshotService.java — full/incremental snapshots of
every registered Snapshotable under the ThreadBarrier; util/persistence/
{InMemory,FileSystem,IncrementalFileSystem}PersistenceStore.java.)

State here is JSON-serialisable dicts of columnar buffers (no Java object
serialisation): each stateful element exposes current_state()/restore_state().
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Dict, Optional


def _loads(snapshot: bytes):
    """Unpickle snapshot bytes; torn/corrupt bytes surface as a typed
    CannotRestoreStateError instead of a raw pickle exception."""
    from ..utils.errors import CannotRestoreStateError
    try:
        return pickle.loads(snapshot)
    except CannotRestoreStateError:
        raise
    except Exception as e:      # noqa: BLE001 — any unpickle failure
        raise CannotRestoreStateError(
            f"snapshot bytes are corrupt or truncated: "
            f"{type(e).__name__}: {e}") from e


def _rev_key(revision: str):
    """Numeric-aware revision sort key: revisions are
    ``{millis}_{app}_{full|inc}`` — order by the leading integer, then
    the string, so ordering survives millis-width changes (lexicographic
    sorting would put 999... after 1000...)."""
    head, _, _ = revision.partition("_")
    try:
        return (0, int(head), revision)
    except ValueError:
        return (1, 0, revision)


class PersistenceStore:
    def save(self, app_name: str, revision: str, snapshot: bytes):
        raise NotImplementedError

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        raise NotImplementedError

    def last_revision(self, app_name: str) -> Optional[str]:
        raise NotImplementedError

    def revisions(self, app_name: str) -> list:
        raise NotImplementedError

    def clear_all_revisions(self, app_name: str):
        raise NotImplementedError


class InMemoryPersistenceStore(PersistenceStore):
    def __init__(self):
        self._data: Dict[str, Dict[str, bytes]] = {}

    def save(self, app_name, revision, snapshot):
        self._data.setdefault(app_name, {})[revision] = snapshot

    def load(self, app_name, revision):
        return self._data.get(app_name, {}).get(revision)

    def last_revision(self, app_name):
        revs = self.revisions(app_name)
        return revs[-1] if revs else None

    def revisions(self, app_name):
        return sorted(self._data.get(app_name, {}).keys(), key=_rev_key)

    def clear_all_revisions(self, app_name):
        self._data.pop(app_name, None)


class FileSystemPersistenceStore(PersistenceStore):
    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def _dir(self, app_name):
        d = os.path.join(self.base_dir, app_name)
        os.makedirs(d, exist_ok=True)
        return d

    def save(self, app_name, revision, snapshot):
        # crash-safe: write to a temp file in the same directory, then
        # os.replace (atomic on POSIX) — a kill mid-write leaves either
        # the old revision set or the new one, never a torn file
        d = self._dir(app_name)
        tmp = os.path.join(d, f".{revision}.tmp")
        final = os.path.join(d, revision)
        with open(tmp, "wb") as f:
            f.write(snapshot)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def load(self, app_name, revision):
        p = os.path.join(self._dir(app_name), revision)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def last_revision(self, app_name):
        revs = self.revisions(app_name)
        return revs[-1] if revs else None

    def revisions(self, app_name):
        return sorted((f for f in os.listdir(self._dir(app_name))
                       if not f.startswith(".")), key=_rev_key)

    def clear_all_revisions(self, app_name):
        d = self._dir(app_name)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))


class SnapshotService:
    """Registry of stateful elements; produces/consumes revisions."""

    def __init__(self, app_ctx):
        self.app_ctx = app_ctx
        self._elements: Dict[str, object] = {}
        # ONE lock serializes every persist: external persist() callers,
        # worker-callback persists, and the periodic CheckpointScheduler
        # all funnel through it.  Re-entrant so a persist triggered from
        # inside another persist's flush cannot self-deadlock.
        self._lock = threading.RLock()
        self._persist_owner = None   # thread ident of the in-flight persist
        self._active_revision = None
        self._last_rev_ms = 0
        # set by SiddhiAppRuntime: drains async junction queues + retires
        # pipelined device work so a snapshot deterministically includes
        # every event sent before persist() was called
        self.pre_snapshot = None
        # incremental bookkeeping: per-element digest of the last persisted
        # state (reference separates incrementalSnapshotable op-logs from
        # periodic base state, SnapshotService.java:159-205; a content
        # digest over the columnar state plays the role of the op-log)
        self._last_digest: Dict[str, bytes] = {}
        # last revision saved per app: each incremental envelope records
        # the revision it was built on top of, so restore can detect a
        # chain gap (SC006) instead of replaying over it
        self._last_saved: Dict[str, str] = {}

    def register(self, element_id: str, element):
        self._elements[element_id] = element

    def deregister(self, element_id: str):
        self._elements.pop(element_id, None)

    # ------------------------------------------------------------ snapshot

    def _routing(self):
        """The pinned FNV-1a routing digest carried in every envelope —
        per-shard sections only restore under the same key→shard map."""
        try:
            from ..parallel.shards import routing_digest
            return routing_digest()
        except Exception:    # noqa: BLE001 — envelope metadata only
            return None

    def _describe(self, eid: str, state):
        from .stateschema import describe_element
        el = self._elements.get(eid)
        return None if el is None else describe_element(el, state)

    def _verify(self, snap_descs, snap_routing, incremental: bool):
        """Diff the snapshot's embedded schema against the live runtime
        and raise a typed SC0xx error BEFORE any restore_state runs.
        Caller holds the thread barrier."""
        from ..utils.errors import CannotRestoreStateError
        from .stateschema import describe_element, verify_compat
        live = {}
        for eid, el in self._elements.items():
            if incremental and eid not in snap_descs:
                continue       # increments only carry changed elements
            s = el.current_state()
            if s is None:
                continue
            d = describe_element(el, s)
            if d is not None:
                live[eid] = d
        findings = verify_compat(
            snap_descs, live, incremental=incremental,
            snap_routing=snap_routing,
            live_routing=self._routing() if snap_routing else None)
        if findings:
            raise CannotRestoreStateError.from_findings(findings)

    def full_snapshot(self, flush: bool = True) -> bytes:
        """ThreadBarrier-locked capture of every element's state
        (reference SnapshotService.fullSnapshot:97-158), wrapped in the
        v2 envelope: per-element schema descriptions + routing digest
        ride next to the state so restore can verify compatibility
        before touching any carry."""
        from .stateschema import build_envelope
        if flush and self.pre_snapshot is not None:
            self.pre_snapshot()
        barrier = self.app_ctx.thread_barrier
        barrier.lock()
        try:
            state, descs = {}, {}
            for eid, el in self._elements.items():
                s = el.current_state()
                if s is not None:
                    state[eid] = s
                    d = self._describe(eid, s)
                    if d is not None:
                        descs[eid] = d
            env = build_envelope(state, descs, self._routing())
            return pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL)
        finally:
            barrier.unlock()

    def restore(self, snapshot: bytes):
        from .stateschema import parse_envelope
        state, descs, routing, incremental, _prev = parse_envelope(
            _loads(snapshot))
        barrier = self.app_ctx.thread_barrier
        barrier.lock()
        try:
            if descs is not None:       # legacy pre-schema snapshots skip
                self._verify(descs, routing, incremental)
            for eid, s in state.items():
                el = self._elements.get(eid)
                if el is not None:
                    el.restore_state(s)
        finally:
            barrier.unlock()

    def incremental_snapshot(self, flush: bool = True,
                             prev: Optional[str] = None) -> bytes:
        """Only elements whose state changed since the last persisted
        snapshot (full or incremental).  ``prev`` records the revision
        this delta was built on top of — the restore chain walker
        verifies the links and fails typed (SC006) on a gap."""
        import hashlib

        from .stateschema import build_envelope
        if flush and self.pre_snapshot is not None:
            self.pre_snapshot()
        barrier = self.app_ctx.thread_barrier
        barrier.lock()
        try:
            changed, descs = {}, {}
            for eid, el in self._elements.items():
                s = el.current_state()
                if s is None:
                    continue
                blob = pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL)
                digest = hashlib.sha256(blob).digest()
                if self._last_digest.get(eid) != digest:
                    changed[eid] = s
                    self._last_digest[eid] = digest
                    d = self._describe(eid, s)
                    if d is not None:
                        descs[eid] = d
            env = build_envelope(changed, descs, self._routing(),
                                 incremental=True, prev=prev)
            return pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL)
        finally:
            barrier.unlock()

    def _mark_digests(self, snapshot: bytes):
        import hashlib

        from .stateschema import parse_envelope
        state, _descs, _routing, _inc, _prev = parse_envelope(
            pickle.loads(snapshot))
        for eid, s in state.items():
            blob = pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL)
            self._last_digest[eid] = hashlib.sha256(blob).digest()

    # ------------------------------------------------------------ revisions

    def persist(self, app_name: str, store: PersistenceStore,
                incremental: bool = False) -> str:
        """Full revisions end `_full`; incremental deltas end `_inc` and are
        replayed on top of the latest full base at restore (reference
        IncrementalFileSystemPersistenceStore revision chains)."""
        # Re-entrant persist: capturing a snapshot can retire pipelined
        # device output, which delivers events synchronously — and a
        # callback on that path may call persist() again on this very
        # thread.  The in-flight snapshot already covers that state;
        # flushing here would deadlock (the junction worker is parked on
        # the thread barrier the outer capture holds, and the nested
        # flush would wait on that worker forever).
        if self._persist_owner == threading.get_ident():
            return self._active_revision
        # Flush BEFORE taking the lock: pre_snapshot waits on junction
        # flush barriers, and a worker-callback persist() blocked on the
        # lock would never consume its barrier copy (deadlock cycle:
        # lock-holder waits on worker, worker waits on lock).
        if self.pre_snapshot is not None:
            self.pre_snapshot()
        with self._lock:      # serialize concurrent persist callers
            # strictly-monotonic revision stamp: two persists inside the
            # same millisecond must not collide on the same revision name
            now = max(int(time.time() * 1000), self._last_rev_ms + 1)
            self._last_rev_ms = now
            self._persist_owner = threading.get_ident()
            try:
                if incremental and self._last_digest:
                    revision = f"{now}_{app_name}_inc"
                    self._active_revision = revision
                    store.save(app_name, revision, self.incremental_snapshot(
                        flush=False, prev=self._last_saved.get(app_name)))
                else:
                    revision = f"{now}_{app_name}_full"
                    self._active_revision = revision
                    snap = self.full_snapshot(flush=False)
                    self._mark_digests(snap)
                    store.save(app_name, revision, snap)
                self._last_saved[app_name] = revision
                return revision
            finally:
                self._persist_owner = None

    def restore_revision(self, app_name: str, store: PersistenceStore,
                         revision: str):
        from ..utils.errors import CannotRestoreStateError
        from .stateschema import parse_envelope
        snap = store.load(app_name, revision)
        if snap is None:
            raise CannotRestoreStateError(f"No revision {revision}")
        _state, _descs, _routing, incremental, _prev = parse_envelope(
            _loads(snap))
        if not incremental:
            self.restore(snap)
            return
        # replay: latest full base before this revision, then every
        # increment up to and including it (numeric-aware ordering)
        rk = _rev_key(revision)
        revisions = sorted((r for r in store.revisions(app_name)
                            if _rev_key(r) <= rk), key=_rev_key)
        base = None
        for r in revisions:
            if r.endswith("_full"):
                base = r
        bk = _rev_key(base) if base is not None else None
        chain = [r for r in revisions
                 if bk is None or _rev_key(r) >= bk]
        # Load and link-check the WHOLE chain before applying anything:
        # each increment records the revision it was built on top of, so
        # a deleted intermediate (which simply vanishes from the
        # revisions() listing) is a typed SC006 gap instead of a silent
        # replay of stale state.
        links, prev_link = [], None
        for r in chain:
            blob = store.load(app_name, r)
            if blob is None:
                raise CannotRestoreStateError(
                    f"incremental restore chain for {revision} is "
                    f"broken: revision {r} vanished from the store "
                    f"between listing and load", code="SC006")
            st, descs_r, routing_r, inc_r, prev_r = parse_envelope(
                _loads(blob))
            if inc_r and prev_r is not None and prev_r != prev_link:
                raise CannotRestoreStateError(
                    f"incremental restore chain for {revision} is "
                    f"broken: {r} was built on top of revision {prev_r} "
                    f"but the previous intact link is "
                    f"{prev_link or '<no full base>'} — an intermediate "
                    f"revision is missing, and replaying over the gap "
                    f"would restore stale state", code="SC006")
            links.append((st, descs_r, routing_r, inc_r))
            prev_link = r
        barrier = self.app_ctx.thread_barrier
        barrier.lock()
        try:
            # every link's schema header verifies against the live
            # runtime before ANY link's state is applied
            for _st, descs_r, routing_r, inc_r in links:
                if descs_r is not None:
                    self._verify(descs_r, routing_r, inc_r)
            for st, _descs_r, _routing_r, _inc_r in links:
                for eid, s in st.items():
                    el = self._elements.get(eid)
                    if el is not None:
                        el.restore_state(s)
        finally:
            barrier.unlock()

    def restore_last_revision(self, app_name: str,
                              store: PersistenceStore) -> Optional[str]:
        rev = store.last_revision(app_name)
        if rev is not None:
            self.restore_revision(app_name, store, rev)
        return rev
