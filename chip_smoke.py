#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siddhi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--chunks N] [--queries Q] [--pattern-chunks M]
                          [--seed S]

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA.  Phases, in order; any failure
raises, so the script exits non-zero and prints no ``ok`` line:

  1. device line: the card, its power limit, and the build of every
     kernel in siddhi_tpu_torch/csrc (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and others (T >= W, a ring or block above shared
     memory, the planner's all-rejected warm block, a +-inf/NaN feed, a
     partly filled carry; outputs and carry must be equal), then both
     timed with CUDA events, K1 on its min/max and sum-only paths;
  3. the main path at full width — BASELINE config 2: one app of Q
     partitioned length(1000) filter+groupBy aggregations over 1024
     string keys, fed N chunks of 262,144 events through the public API
     on the device engine; every query must run on the device, every
     kernel must have been launched, and the rows of the first and last
     query are held against a float64 numpy sliding-window reference;
  4. engine parity on the card: a small app through the device engine on
     CUDA, on the CPU (plain versions) and through the host engine;
  5. the fused NFA step (the step kernel, then the compaction kernel)
     against the plain composition (plain step, then the plain
     compaction) on the card, exactly (every carry leaf; the egress
     slab's rows up to the count, column 0 of the padding rows, the tail
     row), at the pattern cell's shape and on a forced-drop ring, K above
     one warp, K above the register instances, a 3-unit chain, a non-every chain, two streams, no
     `within`, an all-invalid block, a forced scratch-segment overflow, a
     cap below the count and one skewed lane with T = 4096; the
     compaction kernel against numpy; all timed, with the split between
     the two kernels;
  6. the pattern cell at full width — __graft_entry__.PARTITIONED_APP
     over 10,000 integer keys (BASELINE config 3's keyed stream, one
     pattern), M chunks of 262,144 events through the public API on the
     device engine; the query must run on the NFA kernels, every match
     row is held against an independent per-key reference; the cell's own
     peak device memory;
  7. engine parity for the pattern app: CUDA kernel, CPU plain, host;
  8. one JSON line per the kernel table, the nvidia-smi line, and the
     last line ``{"ok": true, "device": {...}}``.

Without CUDA, or without the siddhi_tpu_torch package beside this file,
it exits with code 2 and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float ops of one accepted event's sum/count update (select, 5 Kahan
# lines, pos and cnt), and the amortized compares per accepted event of a
# monotonic-deque sliding min (or max): at most one failing and one
# popping compare per push, plus the front's expiry check
KAHAN_OPS = 8
EXTREMUM_COMPARES = 3

N_KEYS = 1024
CHUNK = 262_144
WINDOW = 1000
TIMED_LAUNCHES = 20
SLEEP_CYCLES = 2_000_000                  # ~1 ms at the H100's clock


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 1

def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_kernels():
    from siddhi_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    logs = _kernels.build_all(verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}.cu] {line.strip()}")
    return secs


# ------------------------------------------------------------------ phase 2

def _equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def _abs_err(a, b) -> float:
    import torch
    if not a.is_floating_point():
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = (a == b) | both_nan           # covers equal infinities
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def _feed(rng, P, T, dens, feed, dev):
    import torch
    v = rng.uniform(0, 100, (P, T)).astype(np.float32)
    if feed == "nonfinite":
        v[rng.random((P, T)) < 0.05] = np.inf
        v[rng.random((P, T)) < 0.05] = -np.inf
        v[rng.random((P, T)) < 0.02] = np.nan
    return (torch.tensor(v, device=dev),
            torch.tensor(rng.random((P, T)) < dens, device=dev))


def check_wagg(cases, dev, rng):
    """K1 vs wagg_step_plain, both paths, over chained blocks per case:
    a case is (P, W, T) or a dict with P, W, T and optionally densities,
    blocks, feed ("uniform" or "nonfinite") and fill (accepted events
    run through both from a fresh carry first: a partly filled ring)."""
    import torch
    from siddhi_tpu_torch.ops.windowed_agg import (make_wagg_carry,
                                                   wagg_step,
                                                   wagg_step_plain)
    worst = 0.0
    for case in cases:
        if not isinstance(case, dict):
            case = dict(zip("PWT", case))
        P, W, T = case["P"], case["W"], case["T"]
        fill = case.get("fill", 0)
        feed = case.get("feed", "uniform")
        for minmax in (False, True):
            for dens in case.get("densities", (0.0, 0.6, 1.0)):
                ck = make_wagg_carry(P, W, dev)
                cp = make_wagg_carry(P, W, dev)
                steps = [(fill, 1.0)] if fill else []
                steps += [(T, dens)] * case.get("blocks", 3)
                for t, d in steps:
                    v, a = _feed(rng, P, t, d, feed, dev)
                    ck, ok_ = wagg_step(ck, v, a, minmax)
                    cp, op_ = wagg_step_plain(cp, v, a, minmax)
                    torch.cuda.synchronize()
                    for x, y in list(zip(ok_, op_)) + list(zip(ck, cp)):
                        worst = max(worst, _abs_err(x, y))
                        if not _equal(x, y):
                            raise AssertionError(
                                f"wagg_length_step != plain at P={P} W={W} "
                                f"T={t} minmax={minmax} density={d} "
                                f"feed={feed} fill={fill}")
                log(f"  wagg_length_step == plain  P={P} W={W} T={T} "
                    f"minmax={int(minmax)} density={dens} feed={feed} "
                    f"fill={fill}")
    return worst


def median_ms(fn, dev, n=TIMED_LAUNCHES, sleep_cycles=SLEEP_CYCLES):
    """Median ms of n runs of fn between CUDA events, the 50 MB L2
    flushed before each run and the card asleep while the host enqueues
    it (so the events time the device work, not the wrapper's host
    work, as long as the enqueue takes less than the sleep)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def time_wagg(P, W, T, dev, rng, minmax):
    """Median ms of TIMED_LAUNCHES launches of the kernel and of the plain
    version, on a carry in steady state (full windows), L2 flushed before
    each launch; plus the bound for that launch's work."""
    import torch
    from siddhi_tpu_torch.ops.windowed_agg import (make_wagg_carry,
                                                   wagg_step,
                                                   wagg_step_plain)
    carry = make_wagg_carry(P, W, dev)
    warm = torch.tensor(rng.uniform(0, 100, (P, W)).astype(np.float32),
                        device=dev)
    carry, _ = wagg_step(carry, warm, torch.ones_like(warm, dtype=bool),
                         False)
    v = torch.tensor(rng.uniform(0, 100, (P, T)).astype(np.float32),
                     device=dev)
    a = v > 25.0                          # the density of a mid query
    launches0 = wagg_step.launches
    ms = median_ms(lambda: wagg_step(carry, v, a, minmax), dev)
    plain_ms = median_ms(lambda: wagg_step_plain(carry, v, a, minmax), dev)
    wagg_step.launches = launches0        # timing launches are not the path
    # bound: bytes each input read once / output written once, and the
    # operations this data needs.  Sum/count: values, ok, sums, counts,
    # the per-lane carry read and written, and per lane the min(a, W)
    # ring slots that change (the evicted value read, the new one
    # written); Kahan update per accepted event.  With min/max also mins,
    # maxs, the whole ring read (every live slot is in some window) but
    # only the changed slots written, and an incremental extremum's
    # amortized compares for each of min and max (a monotonic deque)
    accepted = float(a.sum())
    changed = float(a.sum(dim=1).clamp(max=W).sum())
    if minmax:
        nbytes = (P * T * (4 + 1 + 4 + 4 + 4 + 4) + P * W * 4 + changed * 4
                  + 2 * P * 16)
        ops = accepted * (KAHAN_OPS + 2 * EXTREMUM_COMPARES)
    else:
        nbytes = P * T * (4 + 1 + 4 + 4) + changed * 8 + 2 * P * 16
        ops = accepted * KAHAN_OPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return ms, plain_ms, max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 3

def main_app(n_queries: int) -> str:
    qs = "\n".join(
        f"@info(name='q{i}')\n"
        f"from S[price > {0.5 * i}]#window.length({WINDOW})\n"
        f"select sym, sum(price) as s, count() as n, avg(price) as a, "
        f"min(price) as lo, max(price) as hi\n"
        f"group by sym insert into Out_{i};"
        for i in range(n_queries))
    return (f"@app:name('config2')\n@app:playback\n"
            f"@app:lanes('{N_KEYS}')\n"
            f"@Async(buffer.size='64', batch.size.max='{CHUNK}')\n"
            f"define stream S (sym string, price float, kind int);\n"
            f"partition with (sym of S) begin\n{qs}\nend;\n")


def make_chunks(seed: int, n_chunks: int):
    """(key names [N_KEYS], chunks [(columns, timestamps, key index)]):
    1024 string keys drawn uniformly, prices uniform in [0, 100)."""
    rng = np.random.default_rng(seed)
    names = np.asarray([f"sym-{i:04d}-{rng.integers(1 << 30):x}"
                        for i in range(N_KEYS)], object)
    out = []
    for c in range(n_chunks):
        ki = rng.integers(0, N_KEYS, CHUNK)
        out.append(({"sym": names[ki],
                     "price": rng.uniform(0, 100, CHUNK).astype(np.float32),
                     "kind": rng.integers(0, 4, CHUNK).astype(np.int32)},
                    1_000_000 + c * CHUNK + np.arange(CHUNK, dtype=np.int64),
                    ki))
    return names, out


def _window_extreme(x: np.ndarray, w: int, fn, fill) -> np.ndarray:
    """out[i] = fn over x[max(0, i-w+1) .. i] (van Herk / Gil-Werman:
    prefix and suffix extremes inside blocks of w)."""
    m = len(x)
    y = np.concatenate([np.full(w - 1, fill), x])
    pad = (-len(y)) % w
    y = np.concatenate([y, np.full(pad, fill)]).reshape(-1, w)
    pre = fn.accumulate(y, axis=1).reshape(-1)
    suf = fn.accumulate(y[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    i = np.arange(m)
    return fn(suf[i], pre[i + w - 1])


def reference_rows(chunks, threshold: float):
    """float64 sliding-window reference, per accepted event in arrival
    order: (key index, sum, count, min, max)."""
    ki = np.concatenate([c[2] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks]).astype(
        np.float64)
    acc = price > np.float32(threshold)
    ki, price = ki[acc], price[acc]
    n = len(ki)
    s = np.empty(n)
    cnt = np.empty(n, np.int64)
    lo = np.empty(n)
    hi = np.empty(n)
    order = np.argsort(ki, kind="stable")
    bounds = np.searchsorted(ki[order], np.arange(N_KEYS + 1))
    for k in range(N_KEYS):
        idx = order[bounds[k]:bounds[k + 1]]
        if not len(idx):
            continue
        x = price[idx]
        j = np.arange(len(x))
        c = np.concatenate([[0.0], np.cumsum(x)])
        start = np.maximum(j + 1 - WINDOW, 0)
        s[idx] = c[j + 1] - c[start]
        cnt[idx] = j + 1 - start
        lo[idx] = _window_extreme(x, WINDOW, np.minimum, np.inf)
        hi[idx] = _window_extreme(x, WINDOW, np.maximum, -np.inf)
    return ki, s, cnt, lo, hi


def check_rows(name, got, ref, names):
    ki, s, cnt, lo, hi = ref
    cols = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
    if len(cols["n"]) != len(cnt):
        raise AssertionError(f"{name}: {len(cols['n'])} rows, reference "
                             f"{len(cnt)}")
    if not (cols["sym"] == names[ki]).all():
        raise AssertionError(f"{name}: key column differs")
    if not (cols["n"] == cnt).all():
        raise AssertionError(f"{name}: counts differ")
    if not ((cols["lo"] == lo).all() and (cols["hi"] == hi).all()):
        raise AssertionError(f"{name}: min/max differ")
    for col, want in (("s", s), ("a", s / cnt)):
        err = np.abs(cols[col] - want) / np.maximum(np.abs(want), 1e-30)
        if not (err <= 1e-5).all():
            raise AssertionError(f"{name}: {col} rel err {err.max():.3g} "
                                 f"> 1e-5")
    log(f"  {name}: {len(cnt)} rows == float64 reference (counts, keys, "
        f"min/max exact; sum/avg rel <= 1e-5)")


def profile_device(fn):
    """Run fn under torch.profiler (CUDA activity only) and return
    (fn's result, {kernel name: device us}, total device us), or
    (result, None, None) when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as e:   # noqa: BLE001 — measurement only
        log(f"  torch.profiler unavailable ({type(e).__name__}: {e})")
        return fn(), None, None
    try:
        res = fn()
    finally:
        prof.__exit__(None, None, None)
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            per[ev.key] = per.get(ev.key, 0.0) + float(us)
    if not per:
        return res, None, None
    return res, per, sum(per.values())


def run_main_path(n_queries, names, chunks, dev):
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    from siddhi_tpu_torch.ops.windowed_agg import wagg_step

    n_chunks = len(chunks)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(main_app(n_queries))
    log(f"  app built in {time.perf_counter() - t0:.3f} s")
    pr = rt.partition_runtimes[0]
    if not pr.device_mode:
        raise AssertionError(f"partition fell back to host: "
                             f"{pr.fallback_reason}")
    for qname, qr in pr.device_query_runtimes.items():
        if qr.backend != "device" or \
                type(qr.device_runtime).__name__ != \
                "DeviceWindowedAggRuntime":
            raise AssertionError(f"{qname} is not on the device wagg path")
    keep = {0, n_queries - 1}
    rows = {i: 0 for i in range(n_queries)}
    kept = {i: [] for i in keep}

    def sink(i):
        def fn(chunk):
            rows[i] += len(chunk)
            if i in kept:
                kept[i].append({k: np.array(chunk.columns[k])
                                for k in ("sym", "s", "n", "a", "lo",
                                          "hi")})
        return fn

    for i in range(n_queries):
        rt.add_callback(f"Out_{i}", ColumnarStreamCallback(sink(i)))
    rt.start()
    h = rt.get_input_handler("S")

    def drive():
        t = time.perf_counter()
        for cols, ts, _ki in chunks:
            h.send_batch(cols, timestamps=ts)
        rt.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    from siddhi_tpu_torch.core.ledger import ledger
    stage0 = dict(ledger().snapshot()["stage_seconds"])
    wagg_step.launches = 0                # counts start here
    wall, per_kernel, dev_us = profile_device(drive)
    launches = wagg_step.launches
    stage1 = ledger().snapshot()["stage_seconds"]
    rt.shutdown()
    n_events = n_chunks * CHUNK
    log(f"  main path: {n_queries} queries x {n_events} events "
        f"({n_chunks} chunks of {CHUNK}), {wall:.3f} s wall")
    log(f"  events/s (all queries see every event): {n_events / wall:.1f}; "
        f"ms per chunk: {wall / n_chunks * 1e3:.3f}")
    log(f"  query-events/s: {n_events * n_queries / wall:.1f}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    # host-side stage split (core/ledger.py exclusive-time spans, summed
    # over the ingest worker and the caller)
    log("  host stages (s): " + ", ".join(
        f"{k} {stage1[k] - stage0.get(k, 0.0):.3f}" for k in stage1))
    if per_kernel is not None:
        k1_us = sum(us for k, us in per_kernel.items() if "wagg_" in k)
        log(f"  K1 device time {k1_us / 1e3:.3f} ms = "
            f"{k1_us / 1e6 / wall * 100:.3f}% of wall; all device time "
            f"{dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall * 100:.3f}% of "
            f"wall (idle share {100 - dev_us / 1e6 / wall * 100:.3f}%)")
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        for k, us in top:
            log(f"    device {us / 1e3:10.3f} ms  {k[:90]}")
    else:
        log("  torch.profiler recorded no device time: K1 share not "
            "measured")
    if launches < n_queries * n_chunks:
        raise AssertionError(f"wagg_length_step launched {launches} times, "
                             f"expected >= {n_queries * n_chunks}")
    # every query's row count, and the first/last query's rows in full
    price = np.concatenate([c[0]["price"] for c in chunks])
    for i in range(n_queries):
        want = int((price > np.float32(0.5 * i)).sum())
        if rows[i] != want:
            raise AssertionError(f"Out_{i}: {rows[i]} rows, expected {want}")
    log(f"  every query's row count matches its filter")
    for i in sorted(keep):
        check_rows(f"Out_{i}", kept[i], reference_rows(chunks, 0.5 * i),
                   names)
    return launches, wall


# ------------------------------------------------------------------ phase 4

PARITY_APP = """
@app:playback
define stream S (sym string, price float, kind int);
partition with (sym of S) begin
@info(name='p0')
from S[price > 20.0]#window.length(5)
select sym, sum(price) as s, count() as n, min(price) as lo,
       max(price) as hi group by sym insert into P0;
@info(name='p1')
from S[kind != 1]#window.length(5)
select sym, avg(price) as a, count() as n group by sym insert into P1;
end;
"""


def engine_parity(dev, seed):
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    rng = np.random.default_rng(seed + 1)
    keys = np.asarray([f"k{i}" for i in range(8)], object)
    feed = []
    for c in range(4):
        n = 500
        feed.append(({"sym": keys[rng.integers(0, 8, n)],
                      "price": rng.uniform(0, 100, n).astype(np.float32),
                      "kind": rng.integers(0, 3, n).astype(np.int32)},
                     10_000 + c * n + np.arange(n, dtype=np.int64)))

    def run(device, engine):
        text = (f"@app:engine('{engine}')\n" + PARITY_APP)
        rt = SiddhiManager(device=device).create_siddhi_app_runtime(text)
        out = {"P0": [], "P1": []}
        for sid in out:
            rt.add_callback(sid, StreamCallback(
                lambda evs, sid=sid: out[sid].extend(
                    [e.timestamp] + list(e.data) for e in evs)))
        rt.start()
        h = rt.get_input_handler("S")
        for cols, ts in feed:
            h.send_batch(cols, timestamps=ts)
        backend = rt.partition_runtimes[0].device_mode
        rt.shutdown()
        return out, backend

    cuda_rows, on_dev = run(dev, "device")
    cpu_rows, _ = run("cpu", "device")
    host_rows, on_host_dev = run(dev, "host")
    if not on_dev or on_host_dev:
        raise AssertionError("engine selection did not hold")
    for sid in ("P0", "P1"):
        if cuda_rows[sid] != cpu_rows[sid]:
            raise AssertionError(f"{sid}: CUDA rows != CPU plain rows")
        hd = sorted(host_rows[sid], key=lambda r: r[0])
        dd = sorted(cuda_rows[sid], key=lambda r: r[0])
        if len(hd) != len(dd):
            raise AssertionError(f"{sid}: host {len(hd)} rows, device "
                                 f"{len(dd)}")
        for rh, rd in zip(hd, dd):
            for j, (x, y) in enumerate(zip(rh, rd)):
                if j == 2:
                    # P0's sum / P1's avg: float32 Kahan vs host float64
                    if abs(x - y) > 1e-5 * abs(x):
                        raise AssertionError(f"{sid}: {rh} vs {rd}")
                elif x != y:
                    raise AssertionError(f"{sid}: {rh} vs {rd}")
        log(f"  {sid}: {len(dd)} rows; CUDA == CPU plain exactly; == host "
            f"engine (sum/avg rel <= 1e-5, rest exact)")


# ------------------------------------------------------------------ phase 5

#: __graft_entry__.PARTITIONED_APP, verbatim (BASELINE config 1's pattern
#: on the partitioned stream); tests/test_torch_engine_pattern.py holds the
#: two texts equal
PARTITIONED_APP = """
@app:playback
define stream S (partition int, price float, kind int);
partition with (partition of S) begin
@info(name='q')
from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 and price > e1.price]
    within 10 sec
select e1.price as p1, e2.price as p2
insert into Out;
end;
"""

N_PATTERN_KEYS = 10_000
PATTERN_LANES = 16_384                    # @app:lanes('10000') rounds up
PATTERN_SLOTS = 8
WITHIN_MS = 10_000
PATTERN_BASE_TS = 1_000_000

#: phase-5 pattern shapes beyond the main path's
NFA_CASES = {
    "rare_close": (
        "define stream S (partition int, price float, kind int);\n"
        "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > 99.0 "
        "and price > e1.price] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;"),
    "chain3": (
        "define stream S (partition int, price float, kind int);\n"
        "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and price > e1.price] -> e3=S[kind == 0 and price < e2.price "
        "and price != e1.price] within 10 sec select e1.price as p1, "
        "e2.price as p2, e3.price as p3 insert into Out;"),
    "no_every": (
        "define stream S (partition int, price float, kind int);\n"
        "from e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 and "
        "price > e1.price] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;"),
    "two_streams": (
        "define stream S (partition int, price float, kind int);\n"
        "define stream Q (partition int, price float, qty int);\n"
        "from every e1=S[kind == 0 and price > 50.0] -> e2=Q[price > "
        "e1.price and qty >= 2] within 10 sec select e1.price as p1, "
        "e2.qty as q insert into Out;"),
    "no_within": (
        "define stream S (partition int, price float, kind int);\n"
        "from every e1=S[kind == 0 and price > 90.0] -> e2=S[kind == 1 "
        "and price > e1.price] select e1.price as p1, e2.price as p2 "
        "insert into Out;"),
}


def pattern_query(app_text: str) -> str:
    """The pattern query of a partitioned app, as a plain app (the NFA
    engine's own input)."""
    head, body = app_text.split("partition with", 1)
    query = body.split("begin", 1)[1].rsplit("end;", 1)[0]
    return head.replace("@app:playback", "") + query


def make_pattern_chunks(seed: int, n_chunks: int, n_keys=N_PATTERN_KEYS,
                        chunk=CHUNK):
    """The pattern cell's feed: per chunk (columns, timestamps) with
    integer keys drawn uniformly, price uniform in [0, 100), kind
    uniform in {0, 1}, timestamps 1 ms apart from 1,000,000."""
    rng = np.random.default_rng(seed + 2)
    out = []
    for c in range(n_chunks):
        out.append(({"partition": rng.integers(0, n_keys, chunk)
                     .astype(np.int32),
                     "price": rng.uniform(0, 100, chunk).astype(np.float32),
                     "kind": rng.integers(0, 2, chunk).astype(np.int32)},
                    PATTERN_BASE_TS + c * chunk +
                    np.arange(chunk, dtype=np.int64)))
    return out


def pattern_reference(chunks):
    """Independent reference of PARTITIONED_APP, per key in numpy/Python:
    each `kind == 0 and price > 50` event opens a partial (p1, ts1); a
    later same-key `kind == 1` event with price > p1 closes every such
    open partial, emitting (p1, p2) in arm order; a partial older than
    `within` (ts - ts1 > 10000) dies first.  Returns rows (ts, p1, p2)
    in emission order: by ts, then by arm time."""
    keys = np.concatenate([c[0]["partition"] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks])
    kind = np.concatenate([c[0]["kind"] for c in chunks])
    ts = np.concatenate([c[1] for c in chunks])
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(keys.max() + 2))
    rows = []
    for k in range(len(bounds) - 1):
        idx = order[bounds[k]:bounds[k + 1]]
        open_ = []                       # (ts1, p1), in arm order
        for t, p, kd in zip(ts[idx].tolist(), price[idx].tolist(),
                            kind[idx].tolist()):
            open_ = [o for o in open_ if t - o[0] <= WITHIN_MS]
            if kd == 1 and open_:
                # float32 values compare exactly as Python floats
                keep = []
                for o in open_:
                    if p > o[1]:
                        rows.append((t, o[0], o[1], p))
                    else:
                        keep.append(o)
                open_ = keep
            if kd == 0 and p > 50.0:
                open_.append((t, p))
    rows.sort(key=lambda r: (r[0], r[1]))
    return ([r[0] for r in rows], np.asarray([r[2] for r in rows],
                                             np.float32),
            np.asarray([r[3] for r in rows], np.float32))


def _nfa_blocks(nfa, P, T, n_blocks, seed, dev, valid=True, gap=1000,
                nan=False, skew=False):
    """n_blocks chained [P, T] blocks of random events on `dev` (T events
    per lane, every stream of the spec, the kernel's dtypes), `gap` ms
    apart in each lane; with `nan`, 5% of prices are NaN; with `skew`,
    only lane 0 has events past the first 64 (one hot key sets T)."""
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        blk = {}
        for a in nfa.attr_names:
            if a in ("kind", "qty"):
                v = rng.integers(0, 3 if a == "qty" else 2, (P, T))
            else:
                v = rng.uniform(0, 100, (P, T))
                if nan:
                    v[rng.random((P, T)) < 0.05] = np.nan
            blk[a] = torch.tensor(v.astype(np.float32), device=dev)
        base = b * T * gap
        blk["__ts"] = torch.tensor(
            (base + np.arange(T)[None, :] * gap +
             rng.integers(0, gap, (P, 1)))
            .astype(np.int32), device=dev)
        blk["__stream"] = torch.tensor(
            rng.integers(0, len(nfa.stream_codes), (P, T)).astype(np.int32),
            device=dev)
        vmask = rng.random((P, T)) < 0.9 if valid else np.zeros((P, T), bool)
        if skew:
            vmask[1:, 64:] = False
            vmask[0] = True
        blk["__valid"] = torch.tensor(vmask, device=dev)
        out.append(blk)
    return out


def _same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return bool((a.view(torch.int32) == b.view(torch.int32)).all())
    return bool((a == b).all())


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _slab_equal(got, want, cap) -> bool:
    """The egress contract: rows up to the count, column 0 of the padding
    rows, the tail row (both [cap + 1 (+ status), W] int32)."""
    count = int(want[cap, 0])
    n = min(count, cap)
    return bool(torch_equal(got[:n], want[:n]) and
                torch_equal(got[n:cap, 0], want[n:cap, 0]) and
                torch_equal(got[cap], want[cap]))


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def check_nfa(t_main, dev, seed):
    """The fused step (nfa_step_egress on the card: the step kernel, then
    the compaction kernel) vs the plain composition (nfa_block_step_plain,
    then egress_pack_plain) on the card, over chained blocks per case:
    every carry leaf bit for bit and the egress slab by its contract.  A
    full scratch segment is re-run with segments that fit, and a count
    above cap re-runs the compaction alone, as the engine does; both are
    checked.  Returns the number of cases and the worst absolute
    difference (0.0 when equal)."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (egress_pack_plain,
                                          nfa_block_step_plain, nfa_compact,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    main = pattern_query(PARTITIONED_APP)
    cases = [  # (name, app, P, T, K, blocks, valid, gap ms, options)
        ("main", main, PATTERN_LANES, t_main, PATTERN_SLOTS, 2, True, 1000,
         {}),
        ("K=1 drops", main, 4096, 64, 1, 2, True, 1000, {}),
        # rare completions: partials pile up past one warp's 32 slots
        ("K=40", NFA_CASES["rare_close"], 1024, 200, 40, 2, True, 10, {}),
        # more than 128 live partials in a lane: the wide-ring instance
        ("K=160 wide ring", NFA_CASES["rare_close"], 256, 600, 160, 1,
         True, 10, {"time": True}),
        ("warm all-invalid", main, PATTERN_LANES, 1, PATTERN_SLOTS, 1,
         False, 1000, {}),
    ] + [(n, a, 2048, 64, 8, 2, True, 1000, {})
         for n, a in NFA_CASES.items() if n != "rare_close"] + [
        ("forced scratch overflow", main, PATTERN_LANES, t_main,
         PATTERN_SLOTS, 2, True, 1000, {"seg": 1}),
        ("cap below count", main, PATTERN_LANES, t_main, PATTERN_SLOTS, 2,
         True, 1000, {"cap": "half"}),
        ("skewed lane", main, 2048, 4096, PATTERN_SLOTS, 1, True, 1,
         {"skew": True}),
    ]
    nan_cases = {"chain3"}      # NaN prices through gates and compares
    worst = 0.0
    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    for i, (name, app, P, T, K, n_blocks, valid, gap, opt) in \
            enumerate(cases):
        nfa = CompiledPatternNFA(app, n_partitions=P, n_slots=K, device=dev)
        ck = cp = nfa.carry
        matches = hi = reruns = repacks = hot = 0
        for blk in _nfa_blocks(nfa, P, T, n_blocks, seed + i, dev, valid,
                               gap, nan=name in nan_cases,
                               skew=opt.get("skew", False)):
            new_p, outs = nfa_block_step_plain(nfa.spec, cp, blk)
            count = int(outs[0].sum())
            cap = max(count // 2, 1) if opt.get("cap") == "half" else 1024
            new_k, eg = nfa_step_egress(nfa.spec, ck, blk, nfa.kprog, cap,
                                        opt.get("seg"))
            buf = eg.buf
            if int(buf[-1, 0]) > int(buf[-1, 1]):   # a full segment
                reruns += 1
                _, eg = nfa_step_egress(nfa.spec, ck, blk, nfa.kprog, cap,
                                        _next_pow2(int(buf[-1, 0])))
                buf = eg.buf
            torch.cuda.synchronize()
            for k in new_p:
                if not _same_bits(new_k[k], new_p[k]):
                    x, y = new_k[k], new_p[k]
                    if x.dtype == y.dtype and x.shape == y.shape:
                        worst = max(worst, float(
                            (x.double() - y.double()).abs().max()))
                    raise AssertionError(
                        f"nfa_step != plain: {name} carry.{k} (P={P} T={T} "
                        f"K={K})")
            caps = [cap] + ([_next_pow2(count)] if count > cap else [])
            for c in caps:
                got = buf if c == cap else eg.repack(c)
                repacks += c != cap
                want = egress_pack_plain(nfa.spec, *outs, new_p["dropped"],
                                         cap=c)
                if int(got[-2, 0]) != count or not _slab_equal(got, want, c):
                    raise AssertionError(
                        f"nfa_step egress != plain: {name} cap {c} (P={P} "
                        f"T={T} K={K})")
            matches += count
            hot += int(outs[0][0].sum())
            hi = max(hi, int((new_p["slot_state"] >= 0).sum(dim=1).max()))
            if opt.get("time"):
                ms = median_ms(lambda: nfa_step_egress(
                    nfa.spec, ck, blk, nfa.kprog, max(cap, _next_pow2(count)),
                    _next_pow2(max(int(buf[-1, 0]), 1))), dev,
                    sleep_cycles=5 * SLEEP_CYCLES)
                log(f"  fused step, {name}: {ms:.4f} ms at P={P} T={T} "
                    f"K={K}")
            ck, cp = new_k, new_p
        dropped = int(cp["dropped"].sum())
        if name == "K=1 drops" and dropped == 0:
            raise AssertionError("K=1 case dropped nothing")
        if name == "K=40" and hi <= 32:
            raise AssertionError(f"K=40 case held at most {hi} partials in "
                                 f"a lane (needs > 32)")
        if name == "K=160 wide ring" and hi <= 128:
            raise AssertionError(f"K=160 case held at most {hi} partials in "
                                 f"a lane (needs > 128)")
        if name == "forced scratch overflow" and reruns == 0:
            raise AssertionError("no scratch segment overflowed")
        if name == "cap below count" and repacks == 0:
            raise AssertionError("no block's count passed its cap")
        if name == "skewed lane" and hot < 200:
            raise AssertionError(f"skewed lane: {hot} matches in lane 0")
        tag = " (NaN prices)" if name in nan_cases else ""
        log(f"  nfa_step+compact == plain  {name}{tag}: P={P} T={T} K={K} "
            f"blocks={n_blocks} matches={matches} dropped={dropped} most "
            f"live in a lane={hi} (lane 0: {hot} matches) segment re-runs="
            f"{reruns} re-packs={repacks}")
    # checks are not the main path
    nfa_step_egress.launches, nfa_compact.launches = launches0
    return len(cases), worst


def nfa_bound(P, T, K, spec, kprog, cond_cmps, count, cap):
    """(bound ms, bound_by) of one fused step: the bytes the function must
    move — the block's inputs read once, the carry read once and written
    once, the egress slab written once (the matched rows, column 0 of the
    rows past the count, the tail and status rows) — over HBM3's rate,
    against its compares (within check, state, stream, gate and each
    table compare per event and slot) over the float32 peak."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    W = 4 + R * C
    n_lanes = len(kprog.kern_attrs)
    n_gates = len(spec.cond_fns)
    inputs = P * T * (4 * n_lanes + 4 + 4 + 1 + n_gates)
    carry = P * K * (4 * 4 + 4 * R * C) + P * 4 * (2 + int(spec.arm_once))
    slab = min(count, cap) * W * 4 + max(cap - count, 0) * 4 + 2 * W * 4
    nbytes = inputs + 2 * carry + slab
    ops = P * T * K * (4 + cond_cmps)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compact_bound(P, n_cta, count, cap, W):
    """(bound ms, "bytes") of the compaction alone: the lane counts, the
    dropped column, the CTA fills and the scratch rows (W + 2 words each)
    read once, the slab written once."""
    nbytes = (2 * P * 4 + n_cta * 4 + count * (W + 2) * 4 +
              min(count, cap) * W * 4 + max(cap - count, 0) * 4 + 2 * W * 4)
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def device_split(fn, n=5):
    """ms of device time per call of fn, by kernel (the step, the
    compaction, the rest), from torch.profiler over n calls; each sum is
    divided by the calls the profiler recorded (it may drop the first),
    counted by the step kernel's launches.  None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except Exception as e:   # noqa: BLE001 — measurement only
        log(f"  torch.profiler unavailable ({type(e).__name__}: {e})")
        return None
    split = {"step_ms": 0.0, "compact_ms": 0.0, "other_ms": 0.0}
    calls = {"step_ms": 0, "compact_ms": 0}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if not us:
            continue
        key = ("step_ms" if "nfa_step_kernel" in ev.key else
               "compact_ms" if "nfa_compact_kernel" in ev.key else
               "other_ms")
        split[key] += us / 1e3
        if key in calls:
            calls[key] += ev.count
    if not any(split.values()):
        return None
    rec = calls["step_ms"]
    for key, c in calls.items():
        split[key] = split[key] / c if c else None
    split["other_ms"] = split["other_ms"] / rec if rec else None
    split["calls_recorded"] = rec
    return split


def time_nfa(t_main, dev, seed):
    """Median ms of the fused step (both launches and the gate word), of
    the compaction kernel alone, and of the plain composition and the
    plain compaction alone, at the main path's shape on a carry in steady
    state, with the cap and segments the engine settles on; each
    kernel's device time from the profiler; and the bounds."""
    from siddhi_tpu_torch.ops.nfa import (egress_pack_plain, kernel_geometry,
                                          nfa_block_step_plain, nfa_compact,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    P, T, K = PATTERN_LANES, t_main, PATTERN_SLOTS
    nfa = CompiledPatternNFA(pattern_query(PARTITIONED_APP), n_partitions=P,
                             n_slots=K, device=dev)
    spec, kp = nfa.spec, nfa.kprog
    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    warm, blk = _nfa_blocks(nfa, P, T, 2, seed, dev)
    carry, _ = nfa_step_egress(spec, nfa.carry, warm, kp)
    _, eg = nfa_step_egress(spec, carry, blk, kp)
    count = int(eg.buf[-2, 0])
    cap = _next_pow2(count)
    G, L = kernel_geometry(K)
    seg = max(eg.seg, _next_pow2(int(eg.buf[-1, 0])))
    _, eg = nfa_step_egress(spec, carry, blk, kp, cap, seg)
    # the fused call enqueues a dozen torch ops and two kernels: a longer
    # sleep keeps its host work off the events' clock
    ms = median_ms(lambda: nfa_step_egress(spec, carry, blk, kp, cap, seg),
                   dev, sleep_cycles=5 * SLEEP_CYCLES)
    compact_ms = median_ms(lambda: eg.repack(cap), dev)
    _, outs = nfa_block_step_plain(spec, carry, blk)
    plain_compact_ms = median_ms(
        lambda: egress_pack_plain(spec, *outs, carry["dropped"], cap=cap),
        dev)
    plain_ms = median_ms(lambda: egress_pack_plain(
        spec, *nfa_block_step_plain(spec, carry, blk)[1], carry["dropped"],
        cap=cap), dev, n=5)
    split = device_split(
        lambda: nfa_step_egress(spec, carry, blk, kp, cap, seg))
    nfa_step_egress.launches, nfa_compact.launches = launches0
    cmps = max(len(c) for c in kp.cmp)
    bound_ms, bound_by = nfa_bound(P, T, K, spec, kp, cmps, count, cap)
    W = 4 + max(spec.n_rows, 1) * max(spec.n_caps, 1)
    cb_ms, cb_by = compact_bound(P, -(-P // L), count, cap, W)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "compact_ms": compact_ms,
            "plain_compact_ms": plain_compact_ms, "compact_bound_ms": cb_ms,
            "compact_bound_by": cb_by, "split": split, "count": count,
            "cap": cap, "seg": seg, "G": G, "L": L}


def check_compaction(t_main, dev, seed):
    """The compaction kernel on the card against a numpy compaction of
    the plain step's dense outputs for the same block, at a cap above the
    count and one below it."""
    from siddhi_tpu_torch.ops.nfa import (nfa_block_step_plain, nfa_compact,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    P, T, K = PATTERN_LANES, t_main, PATTERN_SLOTS
    nfa = CompiledPatternNFA(pattern_query(PARTITIONED_APP), n_partitions=P,
                             n_slots=K, device=dev)
    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    warm, blk = _nfa_blocks(nfa, P, T, 2, seed, dev)
    carry, _ = nfa_step_egress(nfa.spec, nfa.carry, warm, nfa.kprog)
    new, outs = nfa_block_step_plain(nfa.spec, carry, blk)
    _, eg = nfa_step_egress(nfa.spec, carry, blk, nfa.kprog,
                            seg=1 << 16)          # no segment fills up
    mask, caps, ts, enter, seq = [o.cpu().numpy() for o in outs]
    idx = np.flatnonzero(mask.reshape(-1))
    R, C = caps.shape[-2], caps.shape[-1]
    want = np.concatenate([
        idx.astype(np.int32)[:, None], ts.reshape(-1)[idx][:, None],
        enter.reshape(-1)[idx][:, None], seq.reshape(-1)[idx][:, None],
        caps.reshape(-1, R * C)[idx].view(np.int32)], axis=1)
    dropped = int(new["dropped"].sum())
    for cap in (len(idx) + 7, max(len(idx) // 2, 1)):
        buf = eg.repack(cap).cpu().numpy()
        n = min(cap, len(idx))
        if not (np.array_equal(buf[:n], want[:n]) and
                (buf[n:cap, 0] == -1).all() and
                int(buf[cap, 0]) == len(idx) and
                int(buf[cap, 1]) == dropped):
            raise AssertionError(f"compaction kernel != numpy (cap {cap})")
    nfa_step_egress.launches, nfa_compact.launches = launches0
    log(f"  nfa_compact == numpy: {len(idx)} matched slots of {mask.size}, "
        f"caps {len(idx) + 7} and {max(len(idx) // 2, 1)}")


# ------------------------------------------------------------------ phase 6

def pattern_app() -> str:
    """The pattern cell's app: PARTITIONED_APP with @app:lanes and the
    @Async input junction of the config-2 app."""
    return ("@app:name('pattern')\n"
            f"@app:lanes('{N_PATTERN_KEYS}')\n" +
            PARTITIONED_APP.replace(
                "define stream",
                f"@Async(buffer.size='64', batch.size.max='{CHUNK}')\n"
                "define stream", 1))


def run_pattern_path(chunks, dev):
    import torch
    import gc

    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    from siddhi_tpu_torch.ops.nfa import nfa_compact, nfa_step_egress

    n_chunks = len(chunks)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(pattern_app())
    log(f"  app built in {time.perf_counter() - t0:.3f} s")
    pr = rt.partition_runtimes[0]
    if not pr.device_mode:
        raise AssertionError(f"partition fell back to host: "
                             f"{pr.fallback_reason}")
    runtimes = []
    for qname, qr in pr.device_query_runtimes.items():
        if qr.backend != "device" or \
                type(qr.device_runtime).__name__ != "DevicePatternRuntime":
            raise AssertionError(f"{qname} is not on the device pattern path")
        runtimes.append(qr.device_runtime)
    got = {"ts": [], "p1": [], "p2": []}

    def sink(chunk):
        got["ts"].append(np.array(chunk.timestamps))
        got["p1"].append(np.array(chunk.columns["p1"]))
        got["p2"].append(np.array(chunk.columns["p2"]))
    rt.add_callback("Out", ColumnarStreamCallback(sink))
    rt.start()
    h = rt.get_input_handler("S")

    def drive():
        t = time.perf_counter()
        for cols, ts in chunks:
            h.send_batch(cols, timestamps=ts)
        rt.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    from siddhi_tpu_torch.core.ledger import ledger
    stage0 = dict(ledger().snapshot()["stage_seconds"])
    nfa_step_egress.launches = 0          # counts start here
    nfa_compact.launches = 0
    wall, per_kernel, dev_us = profile_device(drive)
    launches = (nfa_step_egress.launches, nfa_compact.launches)
    stage1 = ledger().snapshot()["stage_seconds"]
    grows = sum(r.slot_grows for r in runtimes)
    replays = sum(r.replays for r in runtimes)
    k_final = runtimes[0].nfa.spec.n_slots
    rt.shutdown()
    n_events = n_chunks * CHUNK
    cols = {k: np.concatenate(v) if v else np.zeros(0)
            for k, v in got.items()}
    log(f"  pattern path: {n_events} events ({n_chunks} chunks of "
        f"{CHUNK}), {N_PATTERN_KEYS} keys, {wall:.3f} s wall")
    log(f"  events/s: {n_events / wall:.1f}; ms per chunk: "
        f"{wall / n_chunks * 1e3:.3f}; matches: {len(cols['ts'])}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated: {peak} B ({peak - mem0} B above the "
        f"{mem0} B allocated before the cell)")
    log(f"  slot grows {grows}, replays {replays}, final K {k_final}")
    log("  host stages (s): " + ", ".join(
        f"{k} {stage1[k] - stage0.get(k, 0.0):.3f}" for k in stage1))
    if per_kernel is not None:
        step_us = sum(us for k, us in per_kernel.items()
                      if "nfa_step_kernel" in k)
        comp_us = sum(us for k, us in per_kernel.items()
                      if "nfa_compact_kernel" in k)
        nfa_us = step_us + comp_us
        log(f"  nfa_step device time {step_us / 1e3:.3f} ms over "
            f"{launches[0]} launches, nfa_compact {comp_us / 1e3:.3f} ms over "
            f"{launches[1]} launches = {nfa_us / 1e6 / wall * 100:.3f}% of "
            f"wall; all "
            f"device time {dev_us / 1e3:.3f} ms = "
            f"{dev_us / 1e6 / wall * 100:.3f}% of wall (idle share "
            f"{100 - dev_us / 1e6 / wall * 100:.3f}%)")
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        for k, us in top:
            log(f"    device {us / 1e3:10.3f} ms  {k[:90]}")
    else:
        log("  torch.profiler recorded no device time: nfa_step share not "
            "measured")
    if min(launches) < n_chunks:
        raise AssertionError(f"nfa_step / nfa_compact launched {launches} "
                             f"times, expected >= {n_chunks} each")
    t_ref = time.perf_counter()
    rts, rp1, rp2 = pattern_reference(chunks)
    if len(rts) != len(cols["ts"]):
        raise AssertionError(f"pattern path: {len(cols['ts'])} rows, "
                             f"reference {len(rts)}")
    if not (np.array_equal(cols["ts"], np.asarray(rts, np.int64)) and
            np.array_equal(cols["p1"].astype(np.float32), rp1) and
            np.array_equal(cols["p2"].astype(np.float32), rp2)):
        raise AssertionError("pattern path rows != reference")
    log(f"  all {len(rts)} match rows == the per-key reference, in order "
        f"and exactly (reference {time.perf_counter() - t_ref:.1f} s)")
    return launches, wall


# ------------------------------------------------------------------ phase 7

def pattern_parity(dev, seed):
    """A small feed through the pattern app on CUDA (kernel), on the CPU
    (plain step) and through the host engine: the same rows."""
    import torch
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.ops.nfa import nfa_compact, nfa_step_egress
    feed = make_pattern_chunks(seed + 5, 4, n_keys=16, chunk=500)

    def run(device, engine):
        text = f"@app:engine('{engine}')\n" + PARTITIONED_APP
        rt = SiddhiManager(device=device).create_siddhi_app_runtime(text)
        out = []
        rt.add_callback("Out", StreamCallback(
            lambda evs: out.extend([e.timestamp] + list(e.data)
                                   for e in evs)))
        rt.start()
        h = rt.get_input_handler("S")
        for cols, ts in feed:
            h.send_batch(cols, timestamps=ts)
        mode = rt.partition_runtimes[0].device_mode
        rt.shutdown()
        return out, mode

    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    cuda_rows, on_dev = run(dev, "device")
    if nfa_step_egress.launches == launches0[0] or \
            nfa_compact.launches == launches0[1]:
        raise AssertionError("pattern parity: the CUDA run launched no "
                             "nfa_step or no nfa_compact")
    nfa_step_egress.launches, nfa_compact.launches = launches0
    torch.cuda.synchronize()
    cpu_rows, _ = run("cpu", "device")
    host_rows, on_host_dev = run(dev, "host")
    if not on_dev or on_host_dev:
        raise AssertionError("engine selection did not hold")
    if cuda_rows != cpu_rows:
        raise AssertionError("pattern: CUDA rows != CPU plain rows")
    if sorted(cuda_rows) != sorted(host_rows):
        raise AssertionError(f"pattern: device {len(cuda_rows)} rows != host "
                             f"{len(host_rows)} rows")
    log(f"  pattern: {len(cuda_rows)} rows; CUDA == CPU plain (in order) == "
        f"host engine (sorted), exactly")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--pattern-chunks", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "siddhi_tpu_torch")):
        print("chip_smoke: siddhi_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = "cuda"
    t_start = time.perf_counter()

    log("== phase 1: device and kernel build")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"  device: {kind} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    build_s = build_kernels()
    log(f"  kernels built in {build_s:.3f} s")

    log("== phase 2: kernels vs plain versions on the card")
    rng = np.random.default_rng(args.seed + 1)
    names, chunks = make_chunks(args.seed, args.chunks)
    # the main path's widest block: events of the busiest key in a chunk
    # (ops/pack.pack_blocks)
    t_main = max(int(np.bincount(c[2], minlength=N_KEYS).max())
                 for c in chunks)
    cases = [
        (N_KEYS, WINDOW, 256), (N_KEYS, WINDOW, t_main), (1000, 5, 1),
        (33, 1, 64),
        (N_KEYS, 64, t_main),                       # T >= W, a > W
        dict(P=64, W=65536, T=300),                 # ring above smem
        dict(P=2, W=4, T=20_000, densities=(0.6,), blocks=2),  # T above
        dict(P=N_KEYS, W=WINDOW, T=1, densities=(0.0,), blocks=1),  # warm
        dict(P=N_KEYS, W=WINDOW, T=t_main, densities=(0.6,),
             feed="nonfinite"),                     # +-inf / NaN feed
        dict(P=256, W=16, T=40, feed="nonfinite"),
        dict(P=N_KEYS, W=WINDOW, T=t_main, densities=(0.6, 1.0),
             fill=WINDOW // 2 + 7),                 # partly filled carry
    ]
    max_err = check_wagg(cases, dev, rng)
    timed = {}
    for minmax in (True, False):
        timed[minmax] = time_wagg(N_KEYS, WINDOW, t_main, dev, rng, minmax)
        ms, plain_ms, bound_ms, bound_by = timed[minmax]
        log(f"  wagg_length_step at P={N_KEYS} W={WINDOW} T={t_main} "
            f"{'min/max' if minmax else 'sum-only'}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{bound_ms / ms * 100:.2f}% of the bound reached); max abs err "
            f"{max_err}")

    log("== phase 3: main path (BASELINE config 2) on the device engine")
    launches, wall = run_main_path(args.queries, names, chunks, dev)
    if args.chunks < 16 or args.queries < 100:
        log(f"CUT: {args.queries} queries x {args.chunks} chunks (full "
            f"size is 100 x 16)")

    log("== phase 4: engine parity on the card")
    engine_parity(dev, args.seed)

    log("== phase 5: fused NFA step (step + compaction kernels) vs plain "
        "composition on the card")
    pchunks = make_pattern_chunks(args.seed, args.pattern_chunks)
    # the pattern cell's widest block: events of the busiest key in a chunk
    t_pat = max(int(np.bincount(c[0]["partition"],
                                minlength=N_PATTERN_KEYS).max())
                for c in pchunks)
    n_cases, nfa_err = check_nfa(t_pat, dev, args.seed)
    check_compaction(t_pat, dev, args.seed)
    nt = time_nfa(t_pat, dev, args.seed)
    log(f"  fused step at P={PATTERN_LANES} T={t_pat} K={PATTERN_SLOTS} "
        f"(G={nt['G']}, {nt['L']} lanes per CTA, {nt['count']} matches, "
        f"cap {nt['cap']}, seg {nt['seg']}): {nt['ms']:.4f} ms (plain "
        f"composition {nt['plain_ms']:.4f} ms, bound {nt['bound_ms']:.6f} "
        f"ms by {nt['bound_by']}, {nt['bound_ms'] / nt['ms'] * 100:.2f}% of "
        f"the bound reached); {n_cases} cases equal, max abs err {nfa_err}")
    log(f"  compaction alone: {nt['compact_ms']:.4f} ms (plain "
        f"{nt['plain_compact_ms']:.4f} ms, bound "
        f"{nt['compact_bound_ms']:.6f} ms by {nt['compact_bound_by']})")
    log(f"  device split of the fused call (profiler, ms per call): "
        f"{nt['split']}")

    log("== phase 6: pattern cell (PARTITIONED_APP, 10,000 keys) on the "
        "device engine")
    (nfa_launches, compact_launches), _pwall = run_pattern_path(pchunks, dev)
    if args.pattern_chunks < 16:
        log(f"CUT: pattern cell at {args.pattern_chunks} chunks (full size "
            f"is 16)")

    log("== phase 7: engine parity for the pattern app on the card")
    pattern_parity(dev, args.seed)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")

    def timing(minmax):
        ms, plain_ms, bound_ms, bound_by = timed[minmax]
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "shape": {"P": N_KEYS, "W": WINDOW, "T": t_main,
                          "minmax": minmax}}

    # one kernel (one entry point); the main path runs its min/max path,
    # and its sum-only path (queries without min/max) is timed beside it
    kernels = [{
        "name": "wagg_length_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/wagg_length.cu",
        "replaces": "siddhi_tpu/ops/windowed_agg.py:185",
        "checked": True, "launches": launches, "max_abs_err": max_err,
        **timing(True), "sum_only": timing(False)}, {
        # the fused call: the step, then the compaction, and their gate
        # word; its bound is the fused function's
        "name": "nfa_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_step.cu",
        "replaces": "siddhi_tpu/ops/nfa.py:579",
        "checked": True, "launches": nfa_launches, "max_abs_err": nfa_err,
        "ms": nt["ms"], "plain_ms": nt["plain_ms"],
        "bound_ms": nt["bound_ms"], "bound_by": nt["bound_by"],
        "library_ms": None, "split": nt["split"],
        "shape": {"P": PATTERN_LANES, "T": t_pat, "K": PATTERN_SLOTS,
                  "matches": nt["count"], "cap": nt["cap"],
                  "seg": nt["seg"]}}, {
        "name": "nfa_compact", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_step.cu",
        "replaces": "siddhi_tpu/plan/nfa_compiler.py:1837",
        "checked": True, "launches": compact_launches,
        "max_abs_err": nfa_err, "ms": nt["compact_ms"],
        "plain_ms": nt["plain_compact_ms"],
        "bound_ms": nt["compact_bound_ms"],
        "bound_by": nt["compact_bound_by"], "library_ms": None,
        "shape": {"P": PATTERN_LANES, "matches": nt["count"],
                  "cap": nt["cap"]}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
