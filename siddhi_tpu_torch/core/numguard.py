"""Runtime numeric sentinels — the live half of the NS0xx verifier.

The static pass (analysis/ranges.py) predicts where arithmetic can go
wrong; this module watches whether it actually does.  When armed via
``SIDDHI_TPU_NUMGUARD=1``, the aggregation compilers check the arrays
they ALREADY fetch at the host rim (gagg/wagg retire paths, the iagg
slab sync) for non-finite values, exact-int magnitudes nearing the
2^31 overflow ceiling and count lanes nearing int32 saturation, and
``ops/ts32.rebase_offsets`` reports horizon headroom.  The grouped-agg
device step additionally emits a tiny sentinel plane — flags folded
from the ``gsum``/``gcnt`` planes the step already produces, so match
outputs stay bit-identical with the guard on or off (asserted by
tests/test_numguard.py).

Trips surface three ways:

* ``siddhi_numeric_*`` Prometheus series (core/statistics exposition)
* ``NS101`` incident bundles on the flight-recorder bus
  (``SIDDHI_TPU_FLIGHT``), rate-limited per site
* the ``numguard`` section of GET /stats

Off by default and zero-cost when off: every hook checks
:func:`numguard_enabled` before touching an array.  Mirrors the
lock-witness pattern (core/lockwitness.py): static verdict, runtime
witness, same catalog family.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

NUMGUARD_ENV = "SIDDHI_TPU_NUMGUARD"

#: magnitude fraction of a ceiling that counts as "near" — trips fire
#: BEFORE the wrap so an operator gets warning, not wreckage
NEAR_FRACTION = 0.9

#: exact-int ceiling of the gagg split-accumulator lanes
#: (ops/grouped_agg.INT_EXACT_MAX) and the int32 count planes
INT_CEIL = float(1 << 31)

#: f32 exact-integer cliff — the iagg naive-slab precision budget the
#: static NS003 verdict bounds statically
F32_EXACT = float(1 << 24)

#: max NS101 flight incidents per (site, kind) — sentinels keep
#: counting after that, the bus stays quiet
MAX_INCIDENTS_PER_SITE = 3

NUMERIC_TYPES = [
    ("siddhi_numeric_nonfinite_total", "counter",
     "Non-finite values caught by NUMGUARD in float accumulator lanes"),
    ("siddhi_numeric_int_near_overflow_total", "counter",
     "Exact-int accumulator magnitudes past 90% of the 2^31 ceiling"),
    ("siddhi_numeric_count_near_saturation_total", "counter",
     "int32 count-lane values past 90% of the 2^31 ceiling"),
    ("siddhi_numeric_precision_exceeded_total", "counter",
     "Naive-f32 slab sums past the 2^24 exact-integer budget (NS003 "
     "witnessed live)"),
    ("siddhi_numeric_ts_rebase_total", "counter",
     "ts32 horizon rebase events observed by NUMGUARD"),
    ("siddhi_numeric_ts_headroom_ms", "gauge",
     "Remaining int32-ms horizon headroom at the last ts32 rebase"),
    ("siddhi_numeric_sentinel_trips_total", "counter",
     "NS101 sentinel trips (per site and kind)"),
]


def numguard_enabled() -> bool:
    """Env opt-in, read per call (cheap) so tests can flip it."""
    return os.environ.get(NUMGUARD_ENV, "").strip().lower() in (
        "1", "true", "on", "yes")


class NumericSentinels:
    """Per-app trip counters.  Thread-safe; hooks run at the host rim
    (outside the jit) so everything here is plain numpy + a lock, the
    DeviceTelemetry bookkeeping pattern."""

    def __init__(self, app_name: str):
        self.app_name = app_name
        self._lock = threading.Lock()
        #: (site, kind) -> trip count
        self._trips: Dict[tuple, int] = {}
        #: (site, kind) -> NS101 incidents already emitted
        self._incidents: Dict[tuple, int] = {}
        self._rebase_total = 0
        self._headroom_ms: Optional[int] = None

    # ------------------------------------------------------------ hooks

    def observe_floats(self, site: str, arr) -> int:
        """Count non-finite entries in a float accumulator plane the
        caller already fetched.  Returns the trip count."""
        import numpy as np
        a = np.asarray(arr)
        if a.size == 0 or a.dtype.kind not in "fc":
            return 0
        n = int(np.count_nonzero(~np.isfinite(a)))
        if n:
            self._trip(site, "nonfinite", n,
                       {"values_nonfinite": n, "plane_size": int(a.size)})
        return n

    def observe_ints(self, site: str, arr,
                     ceil: float = INT_CEIL) -> int:
        """Exact-int accumulator magnitudes nearing their ceiling."""
        import numpy as np
        a = np.asarray(arr)
        if a.size == 0:
            return 0
        n = int(np.count_nonzero(np.abs(a.astype(np.float64))
                                 >= NEAR_FRACTION * ceil))
        if n:
            self._trip(site, "int_near_overflow", n,
                       {"lanes_near_ceiling": n, "ceiling": ceil})
        return n

    def observe_counts(self, site: str, arr) -> int:
        """int32 count lanes nearing 2^31 saturation."""
        import numpy as np
        a = np.asarray(arr)
        if a.size == 0:
            return 0
        n = int(np.count_nonzero(a.astype(np.float64)
                                 >= NEAR_FRACTION * INT_CEIL))
        if n:
            self._trip(site, "count_near_saturation", n,
                       {"lanes_near_ceiling": n})
        return n

    def observe_precision(self, site: str, arr,
                          budget: float = F32_EXACT) -> int:
        """Naive-f32 slab sums past the exact-integer budget — the live
        witness for the static NS003 verdict."""
        import numpy as np
        a = np.asarray(arr)
        if a.size == 0:
            return 0
        finite = np.abs(np.where(np.isfinite(
            a.astype(np.float64)), a, 0.0).astype(np.float64))
        n = int(np.count_nonzero(finite > budget))
        if n:
            self._trip(site, "precision_exceeded", n,
                       {"lanes_past_budget": n, "budget": budget})
        return n

    def observe_sentinel_plane(self, site: str, plane) -> int:
        """Fold a device-computed sentinel plane (the [3] int32 flag
        counts from ops/grouped_agg.sentinel_plane: int near-overflow,
        count near-saturation, non-finite float lanes)."""
        import numpy as np
        a = np.asarray(plane).reshape(-1)
        if a.size < 3:
            return 0
        near_int, near_cnt, nonfin = int(a[0]), int(a[1]), int(a[2])
        if near_int:
            self._trip(site, "int_near_overflow", near_int,
                       {"lanes_near_ceiling": near_int,
                        "source": "device_plane"})
        if near_cnt:
            self._trip(site, "count_near_saturation", near_cnt,
                       {"lanes_near_ceiling": near_cnt,
                        "source": "device_plane"})
        if nonfin:
            self._trip(site, "nonfinite", nonfin,
                       {"values_nonfinite": nonfin,
                        "source": "device_plane"})
        return near_int + near_cnt + nonfin

    def note_rebase(self, site: str, headroom_ms: int) -> None:
        """ts32 rebase observed; ``headroom_ms`` is the remaining
        horizon after the shift."""
        with self._lock:
            self._rebase_total += 1
            self._headroom_ms = int(headroom_ms)
        if headroom_ms <= 0:
            self._trip(site, "ts_horizon_exhausted", 1,
                       {"headroom_ms": int(headroom_ms)})

    # ------------------------------------------------------- internals

    def _trip(self, site: str, kind: str, n: int,
              detail: Dict[str, Any]) -> None:
        key = (site, kind)
        with self._lock:
            self._trips[key] = self._trips.get(key, 0) + n
            emitted = self._incidents.get(key, 0)
            emit = emitted < MAX_INCIDENTS_PER_SITE
            if emit:
                self._incidents[key] = emitted + 1
        if emit:
            try:
                from .flight import flight
                flight().emit("numeric_sentinel", app=self.app_name,
                              detail={"code": "NS101", "site": site,
                                      "kind": kind, "trips": n,
                                      **detail})
            except Exception:   # noqa: BLE001 — sentinel reporting must
                pass            # never make a numeric fault worse

    # -------------------------------------------------------- surfaces

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            trips = {f"{site}:{kind}": n
                     for (site, kind), n in sorted(self._trips.items())}
            return {"app": self.app_name,
                    "armed": numguard_enabled(),
                    "trips": trips,
                    "trips_total": sum(self._trips.values()),
                    "ts_rebase_total": self._rebase_total,
                    "ts_headroom_ms": self._headroom_ms}

    def prometheus_lines(self) -> List[str]:
        _KIND_SERIES = {
            "nonfinite": "siddhi_numeric_nonfinite_total",
            "int_near_overflow": "siddhi_numeric_int_near_overflow_total",
            "count_near_saturation":
                "siddhi_numeric_count_near_saturation_total",
            "precision_exceeded":
                "siddhi_numeric_precision_exceeded_total",
        }
        out: List[str] = []
        with self._lock:
            items = sorted(self._trips.items())
            rebase, headroom = self._rebase_total, self._headroom_ms
        from .statistics import _fmt_labels
        by_series: Dict[tuple, int] = {}
        for (site, kind), n in items:
            series = _KIND_SERIES.get(kind)
            if series:
                by_series[(series, site)] = \
                    by_series.get((series, site), 0) + n
            out.append(
                "siddhi_numeric_sentinel_trips_total"
                f"{_fmt_labels({'app': self.app_name, 'site': site, 'kind': kind})}"
                f" {n}")
        for (series, site), n in sorted(by_series.items()):
            out.append(
                f"{series}"
                f"{_fmt_labels({'app': self.app_name, 'site': site})} {n}")
        if rebase:
            out.append("siddhi_numeric_ts_rebase_total"
                       f"{_fmt_labels({'app': self.app_name})} {rebase}")
        if headroom is not None:
            out.append("siddhi_numeric_ts_headroom_ms"
                       f"{_fmt_labels({'app': self.app_name})} {headroom}")
        return out

    def reset(self) -> None:
        with self._lock:
            self._trips.clear()
            self._incidents.clear()
            self._rebase_total = 0
            self._headroom_ms = None


# ------------------------------------------------------------- registry

_REGISTRY: Dict[str, NumericSentinels] = {}
_REG_LOCK = threading.Lock()


def numeric_sentinels(app_name: str,
                      create: bool = True) -> Optional[NumericSentinels]:
    """Per-app sentinel holder; process-global like the flight recorder
    so rim hooks and the REST surface resolve the same instance."""
    with _REG_LOCK:
        s = _REGISTRY.get(app_name)
        if s is None and create:
            s = _REGISTRY[app_name] = NumericSentinels(app_name)
        return s


def all_numeric_sentinels() -> List[NumericSentinels]:
    with _REG_LOCK:
        return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def reset_numguard() -> None:
    """Test hook: drop every per-app holder."""
    with _REG_LOCK:
        _REGISTRY.clear()
