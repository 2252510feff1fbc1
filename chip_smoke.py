#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siddhi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--chunks N] [--queries Q] [--seed S]

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
  5. one JSON line per the kernel table, the nvidia-smi line, and the
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def median_ms(fn):
        times = []
        for _ in range(TIMED_LAUNCHES):
            flush.zero_()
            # the card waits while the host enqueues the launch, so the
            # events time the kernel and not the wrapper's host work
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    launches0 = wagg_step.launches
    ms = median_ms(lambda: wagg_step(carry, v, a, minmax))
    plain_ms = median_ms(lambda: wagg_step_plain(carry, v, a, minmax))
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


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--queries", type=int, default=100)
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
        **timing(True), "sum_only": timing(False)}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
