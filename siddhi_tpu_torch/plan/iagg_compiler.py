"""Device-backed incremental aggregation runtime.

Counterpart of ``siddhi_tpu/plan/iagg_compiler.py``.  Routes `define
aggregation` ingest through the slab fold (``ops/incremental_agg.py``,
K10 on the card) instead of the host's per-event bucket dict loop
(core/aggregation.py receive_chunk ≙ reference
aggregation/IncrementalExecutor.java:45-180).

Division of labor per micro-batch:
  host   — filters + expression eval (numpy), bucket-floor per duration
           (vector int math), (bucket, key) → slot-id factorization over
           the batch's UNIQUE pairs only
  device — one fold of the whole batch into each duration's slab

Query/persist/purge sides stay on the host cascade: the slabs are lazily
materialised back into the `buckets` dict (one device-to-host read per
duration and query, not per event) so `find_chunk` / store queries /
snapshots behave identically to the host runtime.  The slabs live on the
app's device (``SiddhiManager(device=...)``, the card by default): a
missing CUDA device raises ``RuntimeError`` from the constructor, which
the app runtime does not turn into a host run."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.aggregation import AggregationRuntime
from ..core.event import EventChunk
from ..core.stateschema import MapOf, Struct, persistent_schema
from ..ops.incremental_agg import init_row, slab_update
from ..query_api.definition import DURATION_MS


class _Slab:
    """One duration's device bucket store.  ``compensated=True`` adds a
    TwoSum error lane per base column (the @numeric(sum='compensated')
    NS003 remediation — ops/incremental_agg.slab_update)."""

    def __init__(self, base_fns, device, cap=2048, compensated=False):
        self.base_fns = tuple(base_fns)
        self.device = device
        self.cap = cap
        self.slot_of: Dict[Tuple[int, Tuple], int] = {}
        self.pair_of: List[Tuple[int, Tuple]] = []
        self.vals = self._identity(cap)
        self.cnt = torch.zeros((cap,), dtype=torch.int32, device=device)
        self.comp = torch.zeros_like(self.vals) if compensated else None

    def _identity(self, rows: int) -> torch.Tensor:
        row = torch.as_tensor(init_row(self.base_fns), device=self.device)
        return row.reshape(1, -1).expand(
            rows, max(len(self.base_fns), 1)).contiguous()

    def grow(self):
        self.vals = torch.cat([self.vals, self._identity(self.cap)])
        self.cnt = torch.cat([self.cnt, torch.zeros_like(self.cnt)])
        if self.comp is not None:
            self.comp = torch.cat([self.comp, torch.zeros_like(self.comp)])
        self.cap *= 2


@persistent_schema(
    "aggregation", version=1,
    schema=Struct(buckets=MapOf("bucket-store")),
    doc="same name/version/schema as the host AggregationRuntime ON "
        "PURPOSE: _sync() makes the device slab persist the host-format "
        "bucket payload, so host and device snapshots are mutually "
        "restorable")
class DeviceAggregationRuntime(AggregationRuntime):
    """AggregationRuntime with slab-tensor ingest."""

    def __init__(self, ad, app_runtime):
        super().__init__(ad, app_runtime)
        try:
            from ..query_api.definition import AttrType
            for fn, arg in zip(self.base_fns, self.base_args):
                if fn == "count":
                    continue
                if fn not in ("sum", "sumsq", "min", "max", "last"):
                    raise TypeError(
                        f"base '{fn}' has no slab lane: host cascade only")
                if arg is not None and arg.type in (AttrType.STRING,
                                                    AttrType.OBJECT):
                    raise TypeError(
                        "non-numeric base lane: host cascade only")
            from ..analysis.ranges import compensated_sum_declared
            from ..core.numguard import (numeric_sentinels,
                                         numguard_enabled)
            from ..ops.incremental_agg import MAX_BASES
            from ..ops.windowed_agg import kernel_device
            if len(self.base_fns) > MAX_BASES:
                raise TypeError(f"{len(self.base_fns)} base lanes: the slab "
                                f"kernel takes {MAX_BASES}")
            self.device = kernel_device(
                app_runtime.app_ctx.siddhi_context.device)
            self._compensated = compensated_sum_declared(ad)
            self._slabs: Dict[str, _Slab] = {
                d: _Slab(self.base_fns, self.device,
                         compensated=self._compensated)
                for d in self.durations}
            self.sentinels = numeric_sentinels(app_runtime.name) \
                if numguard_enabled() else None
            self._dirty = False
        except Exception:
            # undo the junction subscription super() made, then let the
            # caller fall back to the host runtime (a shape rejection) or
            # fail (a device error)
            app_runtime.junction_of(self.stream_id).unsubscribe(self)
            raise

    # ------------------------------------------------------------ ingest

    def receive_chunk(self, chunk: EventChunk):
        prep = self._prepare_chunk(chunk)
        if prep is None:
            return
        ts_col, key_cols, base_vals, n = prep
        # base value matrix [n, B] (count lanes ride zeros)
        B = max(len(self.base_fns), 1)
        bv = np.zeros((n, B), np.float32)
        for b, v in enumerate(base_vals):
            if v is not None:
                bv[:, b] = np.asarray(v, np.float32)
        # group keys → small int ids (unique-only host work)
        if key_cols:
            if len(key_cols) == 1:
                key_obj = key_cols[0]
            else:
                key_obj = np.empty(n, object)
                for i in range(n):
                    key_obj[i] = tuple(k[i] for k in key_cols)
            uniq, key_ids = np.unique(key_obj, return_inverse=True)
            keys_py = [(k if isinstance(k, tuple) else (k,)) for k in uniq]
            keys_py = [tuple(x.item() if hasattr(x, "item") else x
                             for x in k) for k in keys_py]
        else:
            uniq = np.asarray([0])
            key_ids = np.zeros(n, np.int64)
            keys_py = [()]
        bv_dev = torch.from_numpy(bv).to(self.device)
        for dur in self.durations:
            step = DURATION_MS[dur]
            slab = self._slabs[dur]
            bucket = ts_col - ts_col % step
            # (bucket, key) → slot: factorize over unique pairs only
            pair_code = (bucket // step) * len(uniq) + key_ids
            codes, seg_local = np.unique(pair_code, return_inverse=True)
            slots = np.empty(len(codes), np.int64)
            for j, code in enumerate(codes):
                b_ts = int(code // len(uniq)) * step
                key = keys_py[int(code % len(uniq))]
                slot = slab.slot_of.get((b_ts, key))
                if slot is None:
                    slot = len(slab.pair_of)
                    while slot >= slab.cap:
                        slab.grow()
                    slab.slot_of[(b_ts, key)] = slot
                    slab.pair_of.append((b_ts, key))
                slots[j] = slot
            seg = torch.from_numpy(
                slots[seg_local].astype(np.int32)).to(self.device)
            if slab.comp is not None:
                slab.vals, slab.comp, slab.cnt = slab_update(
                    self.base_fns, slab.vals, slab.cnt, seg, bv_dev,
                    slab.comp)
            else:
                slab.vals, slab.cnt = slab_update(
                    self.base_fns, slab.vals, slab.cnt, seg, bv_dev)
        self._dirty = True

    # ------------------------------------------------------------ sync

    @staticmethod
    def _fetch(slab: _Slab, used: int):
        """The used rows of vals, cnt (and comp) in one device-to-host
        read: the three packed into one float32 buffer on the device."""
        parts = [slab.vals[:used].reshape(-1),
                 slab.cnt[:used].view(torch.float32)]
        if slab.comp is not None:
            parts.append(slab.comp[:used].reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        nv = slab.vals.shape[1] * used
        vals = host[:nv].reshape(used, -1)
        cnt = host[nv:nv + used].view(np.int32)
        comp = (host[nv + used:].reshape(used, -1)
                if slab.comp is not None else None)
        return vals, cnt, comp

    def _sync(self):
        """Materialise device slabs back into the host bucket dicts (the
        query/persist/purge sides read those)."""
        if not self._dirty:
            return
        for dur in self.durations:
            slab = self._slabs[dur]
            used = len(slab.pair_of)
            if not used:
                self.buckets[dur] = {}
                continue
            vals, cnt, comp = self._fetch(slab, used)
            if self.sentinels is not None:
                # NUMGUARD witness over the slab this sync already
                # fetched: non-finite accumulators always; the 2^24
                # precision budget only on NAIVE sum lanes — this is the
                # live NS003 cross-validation
                self.sentinels.observe_floats(f"iagg.{dur}", vals)
                self.sentinels.observe_counts(f"iagg.{dur}", cnt)
                if comp is None:
                    sums = [b for b, fn in enumerate(self.base_fns)
                            if fn in ("sum", "sumsq")]
                    if sums:
                        self.sentinels.observe_precision(
                            f"iagg.{dur}", vals[:, sums])
            store: Dict[Tuple[int, Tuple], List[Any]] = {}
            for s, (b_ts, key) in enumerate(slab.pair_of):
                row = []
                for b, fn in enumerate(self.base_fns):
                    if fn == "count":
                        row.append(int(cnt[s]))
                    elif fn in ("min", "max") and not np.isfinite(
                            vals[s, b]):
                        row.append(None)       # untouched identity
                    elif comp is not None and fn in ("sum", "sumsq"):
                        # compensated lanes: the f64 hi+err sum is the
                        # true total past the f32 2^24 cliff
                        row.append(float(np.float64(vals[s, b]) +
                                         np.float64(comp[s, b])))
                    else:
                        row.append(float(vals[s, b]))
                store[(b_ts, key)] = row
            self.buckets[dur] = store
        self._dirty = False

    def _rebuild_slabs(self):
        """Repopulate slabs from the host dicts (after purge / restore)."""
        for dur in self.durations:
            slab = _Slab(self.base_fns, self.device,
                         cap=max(2048, 1 << (len(self.buckets[dur]) or 1)
                                 .bit_length()),
                         compensated=self._compensated)
            vals = slab.vals.cpu().numpy().copy()   # mutable host copies
            cnt = np.zeros(slab.cap, np.int32)
            comp = (np.zeros_like(vals) if slab.comp is not None else None)
            for (b_ts, key), row in self.buckets[dur].items():
                slot = len(slab.pair_of)
                slab.slot_of[(b_ts, key)] = slot
                slab.pair_of.append((b_ts, key))
                for b, fn in enumerate(self.base_fns):
                    v = row[b]
                    if fn == "count":
                        cnt[slot] = int(v or 0)
                    elif v is not None:
                        vals[slot, b] = np.float32(v)
                        if comp is not None and fn in ("sum", "sumsq"):
                            # bank the f32 rounding residual so a
                            # restore round-trip keeps compensated
                            # precision
                            comp[slot, b] = np.float32(
                                np.float64(v) -
                                np.float64(vals[slot, b]))
            slab.vals = torch.from_numpy(vals).to(self.device)
            slab.cnt = torch.from_numpy(cnt).to(self.device)
            if comp is not None:
                slab.comp = torch.from_numpy(comp).to(self.device)
            self._slabs[dur] = slab
        self._dirty = False

    # ------------------------------------------------------------ reads

    def find_chunk(self, within, per, probe_chunk=None) -> EventChunk:
        self._sync()
        return super().find_chunk(within, per, probe_chunk)

    def purge(self, now: int):
        self._sync()
        super().purge(now)
        self._rebuild_slabs()

    def current_state(self):
        self._sync()
        return super().current_state()

    def restore_state(self, s):
        super().restore_state(s)
        self._rebuild_slabs()
