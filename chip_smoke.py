#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siddhi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--chunks N] [--queries Q] [--pattern-chunks M]
                          [--fleet-blocks B] [--latency-blocks L]
                          [--count-chunks C] [--absent-blocks A]
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
     row, its earliest absent deadline included), at the pattern cell's
     shape and on a forced-drop ring, K above one warp, K above the
     register instances, a 3-unit chain, a non-every chain, two streams,
     no `within`, an all-invalid block, a forced scratch-segment overflow,
     a cap below the count and one skewed lane with T = 4096, and on the
     widened class (WIDE_CASES: kleene counts mid-chain and leading, e[k]
     and e[last-j] banks, min == max, an unbounded max, trailing, min-0
     after a unit; absent units mid-chain, trailing, chained, with
     `within`; TIMER blocks between blocks; 2 and 4 slots a thread and
     the wide ring; P = 2047; a cap below the count; a full segment), and
     on the JAX step's whole structural class on the widened template
     instance (CLASS_CASES: logical `and` / `or` units, leading too;
     SEQUENCE with simple, count, logical and absent units; an `every`
     group; mid-chain and trailing `every`; leading min-0 counts, with
     SEQUENCE's every-min-0 seed; a leading absent unit; telemetry;
     `<capture> <cmp> <constant>` compares and the string null guard;
     TIMER blocks between blocks; the logical, mid-chain `every` and
     SEQUENCE kinds also at 2 and 4 slots a thread and on the wide
     ring), and on condition programs (CLASS_CASES "program: ...": the
     Quick start ratio, an offset, % and /, unary minus, abs, floor,
     ceil, sqrt, round, maximum, minimum, or and not around a capture
     compare, a nullable row after `or`, a kleene count's own [last],
     SEQUENCE, a program in unit 0; those the simple instances take
     also forced onto the widened one; NaN prices in three), each class
     case timed beside its bound on its instance; the compaction
     kernel against numpy; all timed, with the split between the two
     kernels;
  6. the pattern cell at full width — __graft_entry__.PARTITIONED_APP
     over 10,000 integer keys (BASELINE config 3's keyed stream, one
     pattern), M chunks of 262,144 events through the public API on the
     device engine, twice: on the default dispatch (the query a
     cross-tenant bucket of one on phase 26's gang kernels: the cell's
     main path) and with SIDDHI_TPU_XTENANT=0 (the step and compaction
     kernels per app); each run must launch its pair of kernels, the two
     runs' rows must be equal and every match row is held against an
     independent per-key reference; each run's wall, device split and
     peak device memory;
  7. engine parity for the pattern apps: CUDA kernel, CPU plain, host
     (PARTITIONED_APP, BASELINE config 4's count app; config 3's absent
     app, whose engine TIMER rows run on the card, CUDA against CPU);
  8. the fleet cell at full size — bench.py's headline bank (BASELINE's
     "1k patterns x 10k partitions": 1000 threshold patterns, 10,000
     round-robin lanes, K = 8, T = 64, 5 stacked chunks of 200, ring 32),
     B pre-staged blocks through CompiledPatternBank.process_block on the
     two bank kernels, ending with one device-to-host read and the ring
     decode; every pattern's count is held against an independent numpy
     reference and every decoded ring row must be one of its matches;
     then the kernels against the plain bank step bit for bit (the cell's
     next block in place, a matchy-band block, stacked vs sequential, a
     replayable bank growing from K = 1, K = 160 in place and not, a
     one-unit chain, a chain without `every`), the ring kernel alone
     against the plain ring bit for bit on synthetic counts (ties
     straddling the ring-th count, ring 0, ring = P, rows not a multiple
     of 32, int32 extremes, counts to 1,000,000, rows longer than one
     shared-memory tile), the widened banks (absent units on the thread
     instance, alert and matchy bands, T = 64 and 4, in place and not;
     count banks on the thread instance, and one at K = 24 on the group
     instance; a K = 24 leading count on the group instance over a
     ragged block, T = 61 at B = 4, whose padding rows' `within` pass
     expires partials; every WIDE_BANK_APPS kind — logical, SEQUENCE,
     the `every` forms, leading min-0 and absence, telemetry, a capture
     compare or program in the first condition — on the bank step's
     widened thread instance at K = 8, and `or` at K = 24 on its
     widened group instance, N = 40, P = 2,048, T = 64 and 4, in place
     and not), and
     each kernel timed (the ring on the alert and matchy blocks and at
     T = 4); then the host's enqueue of one process_block split by part;
  9. the fleet latency cell (bench.py's bench_lat: T = 4 blocks);
 10. the count cell — BASELINE config 4 (`every e1=S[kind == 0]<3:10> ->
     e2=S[kind == 1 and price > e1[last].price] within 10 sec`) over
     100,000 string keys, C chunks of 262,144 events through the public
     API on the NFA kernels, packed and with SIDDHI_TPU_XTENANT=0 as in
     phase 6; the two runs' rows equal, and every row against an
     independent per-key reference, the CPU plain composition and (the
     first 1,000 keys) the host engine;
 11. the absent fleet cell — BASELINE config 3: phase 8's bank with a
     trailing `not S[kind == 0 and price > e2.price] for 3 sec`, A blocks
     on the bank step's thread instance and the ring; every pattern's
     count per block against an independent reference, one block against
     the plain bank bit for bit, every ring row a reference match; then
     config 4 as a 100-pattern bank and the README's Quick start as one
     (`price > e1.price * ratio`, ratios 1.00 to 1.10: a condition
     program reading a pattern constant), each on the thread instance,
     every block against the plain bank bit for bit, then the step alone
     on each instance (the group instance: the parent design's figure);
     then three full-width banks on the bank step's widened thread
     instance (100 patterns x 10,000 lanes, T = 64, kinds 0..2: SEQUENCE,
     `e1 -> e2 or e3`, phase 8's bank with telemetry), 8 blocks each, the
     first 2 against the plain bank bit for bit, the step timed beside
     its bound and the widened group instance on the same block (the
     telemetry bank also beside phase 8's bank on the thread
     instance);
 12. the grouped-aggregation kernels (csrc/grouped_agg.cu: K7a gagg_step,
     K7b gagg_time_step) against their plain twins, bit for bit on every
     output plane and carry leaf (NaN payloads aside), over chained
     blocks: the cells' shapes (the plain twin at a cut T: 1,024 at
     P = 1), T >= W,
     group growth, evictions in the arriving group, a +-inf/NaN/-0.0
     feed, ints near 2^31, a ring overflow, partly filled carries,
     rejected rows, P = 1 and 1,024, numguard, rings above shared memory,
     short and long group ranges in one lane, timestamps out of order,
     one group holding a whole T = 2,048 lane, T not a multiple of the
     passes' tile and below one tile, in-place steps whose evictions
     cross a tile boundary, tiles doubled past the count budget (a CTA
     walking two blocks of items); then both timed at the cells' shapes
     with their bounds, each pass's share, and the one-chain and skewed
     lanes (the walk's serial floor);
 13. the grouped cell: config 2's queries (GQ of its 100) as an
     unpartitioned group-by — one global length(1000) window, 1,024
     string keys as groups, P = 1 — GC chunks of 262,144 events through
     the public API on DeviceGroupedAggRuntime; the first and last
     query's rows against a float64 reference;
 14. the keyed cell: the same queries inside `partition with (sym of S)`
     grouped by sym, kind (K1 refuses it): P = 1,024 lanes, 4 groups a
     lane; same reference rule;
 15. the time cell: `#window.time(1 sec)` with `having t > 20.0 order by
     t desc` and an exact long sum, TC chunks 1 ms apart (the ring grows
     64 -> 1,024 by replay), on K7b and the selection step; every row,
     its order and its exact sum against a reference;
 16. the filter cell: `S[price > 50.0 and sym != key]` with a projection,
     phase 3's chunks, the string compare on code lanes; rows against numpy;
 17. small apps of the JAX suites' shapes through CUDA, the CPU plain
     steps and the host engine;
 18. K6 (csrc/wagg_time.cu) against its plain twin, bit for bit on every
     output plane and carry leaf (NaN payloads aside) over chained
     blocks: the K6 cell's shape (and T >= C), C not a power of two,
     T < 32, an overflow grown and replayed, a ring above shared memory,
     timestamps out of order, a +-inf/NaN/-0.0 feed, rejected rows, P = 1
     and 1,024; then timed at the cell's shape against its bound;
 19. K9 (csrc/dwin_step.cu) against its plain twin, bit for bit on the
     egress rows up to the count, the telemetry row, the tail and every
     carry leaf, over chained steps of all twelve kinds (timer steps
     without events, grow-and-replay, telemetry, externalTime out of
     order, sort ties and LONG hi/lo keys, NaN and +-0.0 sort keys at
     the first and a later key, keyed, keyless and many-key sessions,
     hopping flush and append steps) and on pools above one CTA; then,
     at the window cell's shape, time and timeBatch held against the twin
     (two steps each, the scan across 2,048 CTAs), sort and session
     against an independent numpy reference (heapq under the greedy rule
     of Siddhi's SortWindowProcessor; a per-key max), all four timed;
 20. the K6 cell: `partition with (sym of T)` `#window.time(1 sec)`
     sum/count/avg/min/max grouped by the key, 1,024 string keys, 256
     events a ms, WAGG_CHUNKS chunks of 262,144 events on
     DeviceWindowedAggRuntime
     (window_kind "time"); every row against a float64 reference;
 21. the window cell: `#window.timeBatch(1 sec)` per-symbol totals on the
     device window path (DeviceWindowProcessor on K9, host selector),
     WINDOW_CHUNKS chunks of phase 20's feed; each flush against a numpy reference of
     the batches, the first flush against the host engine;
 22. K10 (csrc/iagg_fold.cu) against its plain twin run on a CPU copy
     of the same inputs (torch's CUDA scatter-add is atomic), bit for bit
     on vals, cnt and comp (NaN by position), both modes: each base alone
     and all six, n from 1 to 262,144, S up to the aggregation cell's sec
     slab, masked rows, one slot holding the batch, NaN/+-inf/+-0.0 in
     the feed and the slab, chained folds, an integer feed past 2^24 in
     compensated mode (exact); then timed at the cell's sec slab and at
     one slot holding the whole batch (the walk's serial floor);
 23. the aggregation cell: samples/incremental_agg_performance.py's
     TradeAgg (`every sec ... hour`), 1,024 symbols, IAGG_CHUNKS chunks
     of 262,144 events by send_batch on DeviceAggregationRuntime, then a
     `per 'seconds'` query inside the clock; every row of it and of a
     `per 'hours'` query against a float64 numpy reference;
 24. K11 (csrc/join_probe.cu) against its plain twin bit for bit (mask
     densities 0, sparse, 50% and 100%, shapes [1, 1] to [16,384,
     16,384], valid bounds not powers of 2, cap below the count); then
     timed at the join cell's shape beside nonzero_static and the sum;
 25. the join cell: samples/tpu_join_performance.py's range stream-table
     join at its own sizes (a 10,000-row table, 16,384-event chunks, 2
     warm-up and JOIN_CHUNKS timed) on the device probe; every chunk's
     pairs in order against a numpy reference;
 26. the cross-tenant gang (K12: csrc/nfa_gang.cu's nfa_gang_step and
     nfa_gang_compact through ops/nfa.nfa_gang_step_egress) against its
     plain twin and against each tenant stepped alone (nfa_step_egress),
     bit for bit on every carry leaf and egress row, over chained flushes
     of two buckets: thresholds, T and `within` differing, the simple
     and absent template instances in one flush, kleene counts, a tenant
     whose ring overflows, one without a pending block, a full scratch
     segment and a cap below the count; a bucket of condition programs
     (the gang's build variant with them); and a bucket of 32 of the
     service's unkeyed apps at its shape (P = 1, T = 8); the gang at the
     keyed cell's shape (32 tenants, P = 1,024) held against the twin bit
     for bit and timed against the tenants' summed K2 + K4 bounds; then
     bench.py's _mtenant_app service: 100 apps (4 buckets of 32), 8
     events a tenant a round, and the same apps in `partition with (k of
     S)`, 1,024 keys and 16,384 events a tenant a round, 8 rounds; each
     packed and with SIDDHI_TPU_XTENANT=0 in turns, every tenant's rows
     equal, gang launches, device operations and D2H reads a flush and
     the wall a round printed;
 27. partition shard-out with SIDDHI_TPU_SHARDS=4 (every shard on
     cuda:0): the pattern cell's app, config 2's keyed wagg (4 queries)
     and phase 14's keyed gagg, each over a few chunks: unsharded, then
     sharded in two runtimes (persist after the first half, restore into
     a new runtime for the second); the rows equal as multisets, the
     /stats shard rows hold every key and event once;
 28. the widened class and condition programs at full width: three
     queries on the pattern cell's stream and partition (CLASS_APPS:
     SEQUENCE; a logical `or` then a trailing `every`; the Quick start's
     `price > e1.price * 1.05`) over its 10,000 keys and 16,384 lanes,
     8 chunks of 262,144 events with kinds 0..2, on the default dispatch (K12)
     and with SIDDHI_TPU_XTENANT=0 (K2 + K4): every query on the device
     pattern path, both runs' rows equal, the first 2 chunks' rows equal
     the port's CPU run (the plain steps), events/s, device ms and
     launches printed; then phase 6's app with
     @app:statistics(telemetry='true') over 2 chunks: its rows equal the
     per-key reference, its last_telemetry the CPU run's; then the
     README's Quick start and the temperature rule, verbatim, built under
     @app:engine('device') and their rows equal to the CPU run's;
  then one JSON line per the kernel table, the nvidia-smi line, and the
  last line ``{"ok": true, "device": {...}}``.

Without CUDA, or without the siddhi_tpu_torch package beside this file,
it exits with code 2 and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# the same units counted in instructions: the data sheet's rate counts an
# FMA as two operations; a compare, a conversion or a bitwise operation
# is one instruction a lane a clock, at half that rate
PEAK_F32_INSTR_PER_S = PEAK_F32_OPS_PER_S / 2
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
            if "registers" in line or "spill" in line or \
                    "entry function" in line:
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


def is_kernel(key: str, name: str) -> bool:
    """True when a profiler key (a demangled kernel signature such as
    ``void (anonymous namespace)::nfa_step_kernel<1>(...)``) names exactly
    the kernel ``name``."""
    return re.search(r"(?<![\w])" + re.escape(name) + r"[<(]", key) \
        is not None


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


_S3 = "define stream S (partition int, price float, kind int);\n"

#: phase-5 shapes of the widened class: kleene counts <m:n> and absent
#: units `not ... for t` (BASELINE configs 3 and 4 among them)
WIDE_CASES = {
    "count mid-chain": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and price > e1.price]<1:3> -> e3=S[kind == 0 and price < "
        "e2[last].price] within 10 sec select e1.price as p1, e2[0].price "
        "as f2, e2[last].price as l2, e3.price as p3 insert into Out;"),
    "count leading (config 4)": (
        _S3 + "from every e1=S[kind == 0]<3:10> -> e2=S[kind == 1 and price "
        "> e1[last].price] within 10 sec select e1[0].price as p0, "
        "e1[last].price as pl, e2.price as p2 insert into Out;"),
    "count leading, min 1": (
        _S3 + "from e1=S[kind == 0 and price > 30.0]<1:4> -> e2=S[kind == 1 "
        "and price > e1[last].price] within 10 sec select e1[0].price as "
        "p0, e1[last].price as pl, e2.price as p2 insert into Out;"),
    "count e[k] and e[last-j] banks": (
        _S3 + "from every e1=S[kind == 0 and price > 60.0] -> e2=S[kind == 1]"
        "<2:5> -> e3=S[kind == 0 and price > e2[last].price] within 10 sec "
        "select e2[0].price as f, e2[1].price as i1, e2[last].price as l, "
        "e2[last-1].price as m1, e3.price as p3 insert into Out;"),
    "count min == max": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1]"
        "<2:2> -> e3=S[kind == 0] within 10 sec select e1.price as p1, "
        "e2[last].price as l2, e3.price as p3 insert into Out;"),
    "count max COUNT_INF": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1]"
        "<2:> -> e3=S[kind == 0 and price > 90.0] within 10 sec select "
        "e1.price as p1, e2[last].price as l2 insert into Out;"),
    "count trailing": (
        _S3 + "from every e1=S[kind == 0 and price > 70.0] -> e2=S[kind == 1 "
        "and price > e1.price]<2:3> within 10 sec select e1.price as p1, "
        "e2[last].price as l2 insert into Out;"),
    "min-0 count after a unit": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and price < 30.0]<0:3> -> e3=S[kind == 1 and price > 80.0] within "
        "10 sec select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;"),
    "min-0 count after an absent": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> not S[kind == 1 "
        "and price > 90.0] for 2 sec -> e2=S[kind == 0 and price < 30.0]"
        "<0:2> -> e3=S[kind == 1 and price > 60.0] within 10 sec select "
        "e1.price as p1, e3.price as p3 insert into Out;"),
    "absent mid-chain": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> not S[kind == 1 "
        "and price > e1.price] for 2 sec -> e3=S[kind == 0 and price < "
        "e1.price] within 10 sec select e1.price as p1, e3.price as p3 "
        "insert into Out;"),
    "absent trailing (config 3)": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and price > e1.price and price > 60.0] -> not S[kind == 0 and price "
        "> e2.price] for 3 sec within 40000 milliseconds select e1.price as "
        "p1, e2.price as p2 insert into Out;"),
    "absent chain": (
        _S3 + "from every e1=S[kind == 0 and price > 70.0] -> not S[kind == 1 "
        "and price > 80.0] for 1500 milliseconds -> not S[kind == 0 and "
        "price < 10.0] for 1 sec select e1.price as p1 insert into Out;"),
    "absent + within": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and price > e1.price] -> not S[kind == 0 and price > 95.0] for "
        "3 sec within 4 sec select e1.price as p1, e2.price as p2 insert "
        "into Out;"),
    # rare completions: partials pile up past 32, 64 and 128 a lane
    "count, rare": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > 99.0 "
        "and price > e1.price]<2:3> within 10 sec select e1.price as p1, "
        "e2[0].price as f2, e2[last].price as l2 insert into Out;"),
    "absent, rare": (
        _S3 + "from every e1=S[kind == 0] -> not S[kind == 1 and price > 99.5]"
        " for 5 sec within 10 sec select e1.price as p1 insert into Out;"),
}


#: phase-5 shapes of the JAX step's whole structural class, on the
#: widened template instance (kinds 0..2 in their blocks): logical units,
#: SEQUENCE, the `every` forms, leading min-0 counts and absences,
#: telemetry (CLASS_TELEMETRY) and `<capture> <cmp> <constant>` compares
CLASS_CASES = {
    "logical and": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind == "
        "1 and price > e1.price] and e3=S[kind == 2]) -> e4=S[kind == 0 and "
        "price < e1.price] within 10 sec select e1.price as p1, e2.price as "
        "p2, e3.price as p3, e4.price as p4 insert into Out;"),
    "logical or": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind == "
        "1 and price > e1.price] or e3=S[kind == 2 and price < e1.price]) "
        "select e1.price as p1, e2.price as p2, e3.price as p3 insert into "
        "Out;"),
    "logical leading": (
        _S3 + "from every (e1=S[kind == 0 and price > 50.0] and e2=S[kind == "
        "1]) -> e3=S[kind == 2 and price > e1.price] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;"),
    "sequence": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0], e2=S[kind == 1 "
        "and price > e1.price], e3=S[kind == 2] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;"),
    "sequence count": (
        _S3 + "from every e1=S[kind == 0], e2=S[kind == 1]<1:3>, e3=S[kind "
        "== 2] select e1.price as p1, e2[last].price as l2, e3.price as p3 "
        "insert into Out;"),
    "sequence logical": (
        _S3 + "from every e1=S[kind == 0], (e2=S[kind == 1] or e3=S[kind == "
        "2]) select e1.price as p1, e2.price as p2, e3.price as p3 insert "
        "into Out;"),
    "sequence absent": (
        _S3 + "from every e1=S[kind == 0 and price > 30.0], not S[kind == 1] "
        "for 2 sec select e1.price as p1 insert into Out;"),
    "every group": (
        _S3 + "from every (e1=S[kind == 0 and price > 50.0] -> e2=S[kind == "
        "1]) -> e3=S[kind == 2 and price > e1.price] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;"),
    "mid every": (
        _S3 + "from e1=S[kind == 0] -> every e2=S[kind == 1 and price > "
        "e1.price] -> e3=S[kind == 2] within 10 sec select e1.price as p1, "
        "e2.price as p2, e3.price as p3 insert into Out;"),
    "mid every group": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> every (e2=S["
        "kind == 1] -> e3=S[kind == 2]) -> e4=S[kind == 0 and price > "
        "e1.price] within 10 sec select e1.price as p1, e3.price as p3, "
        "e4.price as p4 insert into Out;"),
    "trailing every, logical": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind == "
        "1 and price > e1.price] or e3=S[kind == 2 and price < e1.price]) "
        "-> every e4=S[kind == 1 and price > 80.0] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3, e4.price as p4 "
        "insert into Out;"),
    "leading min-0 count": (
        _S3 + "from e1=S[kind == 0]<0:3> -> e2=S[kind == 1 and price > 50.0] "
        "within 10 sec select e1[0].price as f1, e1[last].price as l1, "
        "e2.price as p2 insert into Out;"),
    "leading min-0 count, every": (
        _S3 + "from every e1=S[kind == 0]<0:2> -> e2=S[kind == 1 and price > "
        "30.0] within 10 sec select e1[last].price as l1, e2.price as p2 "
        "insert into Out;"),
    "sequence min-0 count, every": (
        _S3 + "from every e1=S[kind == 0]<0:3>, e2=S[kind == 1] select "
        "e1[0].price as f1, e2.price as p2 insert into Out;"),
    "leading absent, every": (
        _S3 + "from every not S[kind == 1 and price > 50.0] for 2 sec -> "
        "e2=S[kind == 0] -> e3=S[kind == 2] within 10 sec select e2.price "
        "as p2, e3.price as p3 insert into Out;"),
    "capture to constant": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and e1.price > "
        "40.0 and price > e1.price] -> e3=S[kind == 2 and 70.0 >= e2.price] "
        "within 10 sec select e1.price as p1, e2.price as p2, e3.price as "
        "p3 insert into Out;"),
    "string null guard": (
        "define stream S (partition int, sym string, price float, kind "
        "int);\nfrom every e1=S[kind == 0] -> e2=S[kind == 1 and sym == "
        "e1.sym] within 10 sec select e1.price as p1, e2.price as p2 insert "
        "into Out;"),
    # condition programs (plan/nfa_program.py), one case a form: the
    # simple instance takes a program outside unit 0 (PROGRAM_WIDE below
    # holds those on the widened instance too)
    "program: ratio (Quick start)": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == "
        "1 and price > e1.price * 1.05] within 10 sec select e1.price as "
        "p1, e2.price as p2 insert into Out;"),
    "program: offset": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and (e1.price + "
        "5.0) <= price] within 10 sec select e1.price as p1, e2.price as p2 "
        "insert into Out;"),
    "program: % and /": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and price % 7.0 "
        "> e1.price % 5.0 and price / e1.price > 1.1] within 10 sec select "
        "e1.price as p1, e2.price as p2 insert into Out;"),
    "program: unary minus, a constant over a lane": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and -price < "
        "-e1.price and 100.0 / price < e1.price] within 10 sec select "
        "e1.price as p1, e2.price as p2 insert into Out;"),
    "program: abs, floor, ceil": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
        "math:abs(price - 50.0) < e1.price * 0.5 and math:floor(price / "
        "10.0) * 10.0 > e1.price - 30.0 and math:ceil(price) != e1.price] "
        "within 10 sec select e1.price as p1, e2.price as p2 insert into "
        "Out;"),
    "program: sqrt, round, maximum, minimum": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
        "math:sqrt(price) * 10.0 > e1.price and math:round(price) != "
        "e1.price and maximum(price, 40.0) > e1.price and minimum(price, "
        "90.0) < e1.price + 30.0] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;"),
    "program: or, not": (
        _S3 + "from every e1=S[kind == 0] -> e2=S[kind != 0 and (price > "
        "e1.price * 1.1 or kind == 2) and not (price < e1.price * 0.5)] "
        "within 10 sec select e1.price as p1, e2.price as p2 insert into "
        "Out;"),
    "program: nullable row after or": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind == "
        "1] or e3=S[kind == 2]) -> e4=S[kind == 0 and price > e2.price] "
        "within 10 sec select e1.price as p1, e2.price as p2, e3.price as "
        "p3, e4.price as p4 insert into Out;"),
    "program: own [last]": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 "
        "and (e2[last].price is null or price > e2[last].price)]<1:3> -> "
        "e3=S[kind == 2] within 10 sec select e1.price as p1, "
        "e2[last].price as l2, e3.price as p3 insert into Out;"),
    "program: SEQUENCE ratio": (
        _S3 + "from every e1=S[kind == 0 and price > 50.0], e2=S[kind == 1 "
        "and price > e1.price * 1.05] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;"),
    "program: unit 0 (widened)": (
        _S3 + "from every e1=S[kind == 0 and (e1[last].price is null or "
        "price < e1[last].price)]<1:3> -> e2=S[kind == 1 and price > "
        "e1[last].price] within 10 sec select e1[0].price as f1, "
        "e1[last].price as l1, e2.price as p2 insert into Out;"),
}
#: the program cases the simple instances take, held on the widened
#: instance as well (forced_wide)
PROGRAM_WIDE = ("program: ratio (Quick start)", "program: offset",
                "program: % and /",
                "program: unary minus, a constant over a lane",
                "program: abs, floor, ceil",
                "program: sqrt, round, maximum, minimum",
                "program: or, not", "program: own [last]")
#: program cases fed 5% NaN prices
PROGRAM_NAN = ("program: % and /", "program: sqrt, round, maximum, minimum",
               "program: unary minus, a constant over a lane")
#: CLASS_CASES whose fused call phase 5 splits by kernel (profiler)
CLASS_SPLIT = ("sequence", "logical and")
#: CLASS_CASES also run with the telemetry leaf
CLASS_TELEMETRY = ("logical or", "sequence", "every group",
                   "trailing every, logical", "mid every",
                   "leading absent, every")


@contextlib.contextmanager
def forced_wide():
    """ops/nfa's instance choice forced to the widened instance, which
    takes every spec of the class: the step runs csrc/nfa_wide.cu and the
    program table's `wide` word is set with it (the table cache emptied
    on the way in and out)."""
    from siddhi_tpu_torch.ops import nfa as nfa_ops
    real = nfa_ops.kernel_wide
    nfa_ops._PROG_CACHE.clear()
    nfa_ops.kernel_wide = lambda spec, kprog: True
    try:
        yield
    finally:
        nfa_ops.kernel_wide = real
        nfa_ops._PROG_CACHE.clear()


def pattern_query(app_text: str) -> str:
    """The pattern query of a partitioned app, as a plain app (the NFA
    engine's own input)."""
    head, body = app_text.split("partition with", 1)
    query = body.split("begin", 1)[1].rsplit("end;", 1)[0]
    return head.replace("@app:playback", "") + query


def make_pattern_chunks(seed: int, n_chunks: int, n_keys=N_PATTERN_KEYS,
                        chunk=CHUNK, kinds=2):
    """The pattern cell's feed: per chunk (columns, timestamps) with
    integer keys drawn uniformly, price uniform in [0, 100), kind
    uniform in {0, .., kinds - 1} ({0, 1} for the pattern cell),
    timestamps 1 ms apart from 1,000,000."""
    rng = np.random.default_rng(seed + 2)
    out = []
    for c in range(n_chunks):
        out.append(({"partition": rng.integers(0, n_keys, chunk)
                     .astype(np.int32),
                     "price": rng.uniform(0, 100, chunk).astype(np.float32),
                     "kind": rng.integers(0, kinds, chunk).astype(np.int32)},
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
                nan=False, skew=False, hi=100.0, kinds=2):
    """n_blocks chained [P, T] blocks of random events on `dev` (T events
    per lane, every stream of the spec, the kernel's dtypes, values
    uniform in [0, hi), `kind` uniform in 0..kinds-1, a string's code
    lane `sym` in 0..3 with 0 its null), `gap` ms apart in each lane;
    with `nan`, 5% of prices are NaN; with `skew`, only lane 0 has events
    past the first 64 (one hot key sets T)."""
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        blk = {}
        for a in nfa.attr_names:
            if a in ("kind", "qty", "sym"):
                v = rng.integers(0, {"qty": 3, "sym": 4}.get(a, kinds),
                                 (P, T))
            else:
                v = rng.uniform(0, hi, (P, T))
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
                                          make_timer_block,
                                          nfa_block_step_plain, nfa_compact,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    main = pattern_query(PARTITIONED_APP)
    wide = WIDE_CASES
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
    ] + [(n, a, 2048, 64, 8, 2, True, 1000, {"timer": True})
         for n, a in wide.items() if "rare" not in n] + [
        # the widened kinds in every slot instance: 2 and 4 slots a
        # thread, and the wide ring (K > 128)
        ("count, rare K=40", wide["count, rare"], 1024, 200, 40, 2, True,
         10, {"live": 32}),
        ("absent, rare K=100", wide["absent, rare"], 512, 300, 100, 2, True,
         10, {"timer": True, "live": 64}),
        ("count, rare K=160 wide ring", wide["count, rare"], 256, 600, 160,
         1, True, 10, {"live": 128}),
        ("absent, rare K=160 wide ring", wide["absent, rare"], 256, 900, 160,
         1, True, 10, {"timer": True, "live": 128}),
        ("absent trailing K=160 wide ring", wide["absent trailing (config 3)"],
         256, 600, 160, 1, True, 10, {"timer": True}),
        ("count banks K=40", wide["count e[k] and e[last-j] banks"], 1024,
         200, 40, 2, True, 10, {}),
        # P not a multiple of a CTA's lanes; a cap below the count (the
        # compaction re-run, the tail's deadline with it); a full scratch
        # segment; the TIMER block alone
        ("absent trailing P=2047, cap below count",
         wide["absent trailing (config 3)"], 2047, 64, 8, 2, True, 1000,
         {"cap": "half", "timer": True}),
        ("count leading P=2047, scratch overflow",
         wide["count leading (config 4)"], 2047, 64, 8, 2, True, 1000,
         {"seg": 1}),
        ("absent mid-chain, matchy (gap 300 ms)", wide["absent mid-chain"],
         2048, 128, 16, 2, True, 300, {"timer": True}),
    ] + [(n, a, 2048, 64, 8, 2, True, 1000,
          {"timer": True, "kinds": 3, "telemetry": n in CLASS_TELEMETRY})
         for n, a in CLASS_CASES.items()] + [
        # the logical, mid-chain `every` and SEQUENCE kinds in the 2- and
        # 4-slot instances and the wide ring (K > 128)
        (f"{n} K={K}", CLASS_CASES[n], P, T, K, 1, True, 100,
         {"timer": True, "kinds": 3})
        for n in ("logical or", "mid every", "sequence")
        for K, P, T in ((64, 1024, 200), (128, 512, 200), (160, 256, 300))
    ] + [(f"{n} (widened)", CLASS_CASES[n], 2048, 64, 8, 2, True, 1000,
          {"timer": True, "kinds": 3, "wide": True}) for n in PROGRAM_WIDE]
    nan_cases = {"chain3", "count mid-chain", "absent mid-chain"} | \
        set(PROGRAM_NAN) | {f"{n} (widened)" for n in PROGRAM_NAN
                            if n in PROGRAM_WIDE}
    worst = 0.0
    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    for i, (name, app, P, T, K, n_blocks, valid, gap, opt) in \
            enumerate(cases):
        nfa = CompiledPatternNFA(app, n_partitions=P, n_slots=K, device=dev,
                                 telemetry=opt.get("telemetry", False))
        if nfa.kprog.reason is not None:
            raise AssertionError(f"{name}: outside the kernel's class: "
                                 f"{nfa.kprog.reason}")
        force = contextlib.ExitStack()
        if opt.get("wide"):
            force.enter_context(forced_wide())
        ck = cp = nfa.carry
        matches = hi = reruns = repacks = hot = 0
        feed = []
        for b, blk in enumerate(_nfa_blocks(nfa, P, T, n_blocks, seed + i,
                                            dev, valid, gap,
                                            nan=name in nan_cases,
                                            skew=opt.get("skew", False),
                                            kinds=opt.get("kinds", 2))):
            feed.append(blk)
            if opt.get("timer"):        # a TIMER row a lane (T = 1)
                tb = make_timer_block(P, (b + 1) * T * gap - 1,
                                      nfa.attr_names)
                feed.append(nfa.to_device(tb))
        absent = "deadline" in nfa.carry
        for blk in feed:
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
                want = egress_pack_plain(
                    nfa.spec, *outs, new_p["dropped"],
                    new_p["slot_state"] if absent else None,
                    new_p["deadline"] if absent else None, cap=c)
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
        force.close()
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
        if hi <= opt.get("live", -1):
            raise AssertionError(f"{name}: at most {hi} partials in a lane "
                                 f"(needs > {opt['live']})")
        if (name in WIDE_CASES or name in CLASS_CASES or
                opt.get("wide")) and matches == 0:
            raise AssertionError(f"{name}: no match")
        tag = " (NaN prices)" if name in nan_cases else ""
        tag += " (+ TIMER blocks)" if opt.get("timer") else ""
        log(f"  nfa_step+compact == plain  {name}{tag}: P={P} T={T} K={K} "
            f"blocks={n_blocks} matches={matches} dropped={dropped} most "
            f"live in a lane={hi} (lane 0: {hot} matches) segment re-runs="
            f"{reruns} re-packs={repacks}")
    # checks are not the main path
    nfa_step_egress.launches, nfa_compact.launches = launches0
    return len(cases), worst


def time_class(dev, seed, P=2048, T=64, K=8):
    """Each CLASS_CASES shape on its instance (the widened one but for a
    program case the simple instance takes) at phase 5's shape
    ([P, T], K, kinds 0..2, gap 1000 ms, the telemetry leaf where
    CLASS_TELEMETRY names it), on a carry in steady state (one warm
    block) at the cap and segment the engine settles on: the fused
    call's median ms and its bound, and for CLASS_SPLIT the device split
    (profiler).  Returns {name: numbers}."""
    from siddhi_tpu_torch.ops.nfa import (kernel_wide, nfa_compact,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    launches0 = (nfa_step_egress.launches, nfa_compact.launches)
    out = {}
    for i, (name, app) in enumerate(CLASS_CASES.items()):
        nfa = CompiledPatternNFA(app, n_partitions=P, n_slots=K, device=dev,
                                 telemetry=name in CLASS_TELEMETRY)
        spec, kp = nfa.spec, nfa.kprog
        warm, blk = _nfa_blocks(nfa, P, T, 2, seed + i, dev, kinds=3)
        carry, _ = nfa_step_egress(spec, nfa.carry, warm, kp)
        _, eg = nfa_step_egress(spec, carry, blk, kp)
        count = int(eg.buf[-2, 0])
        cap = _next_pow2(count)
        seg = max(eg.seg, _next_pow2(int(eg.buf[-1, 0])))

        def call():
            return nfa_step_egress(spec, carry, blk, kp, cap, seg)
        ms = median_ms(call, dev, sleep_cycles=5 * SLEEP_CYCLES)
        split = device_split(call) if name in CLASS_SPLIT else None
        # a table compare or a program word: one operation an event and slot
        cmps = max(len(x) + len(y) + len(z) for x, y, z in
                   zip(kp.cmp, kp.ccmp or [()] * len(kp.cmp),
                       kp.prog or [()] * len(kp.cmp)))
        b_ms, b_by = nfa_bound(P, T, K, spec, kp, cmps, count, cap)
        inst = "widened" if kernel_wide(spec, kp) else "simple"
        out[name] = {"ms": ms, "step_ms": (split or {}).get("step_ms"),
                     "bound_ms": b_ms, "bound_by": b_by, "instance": inst,
                     "shape": {"P": P, "T": T, "K": K, "matches": count}}
        log(f"  {inst} step, {name}: {ms:.4f} ms a fused call at P={P} "
            f"T={T} K={K}, {count} matches; bound {b_ms:.6f} ms by {b_by}" +
            (f"; device split {split}" if split else ""))
    nfa_step_egress.launches, nfa_compact.launches = launches0
    return out


def slot_words(spec) -> int:
    """int32 words of one slot's carry besides its captures: state,
    start, enter, seq, and cnt_cur and cnt_prev with count units, the
    deadline with absent units and the side mask with logical units."""
    kinds = {u.kind for u in spec.units}
    return 4 + 2 * ("count" in kinds) + ("absent" in kinds) + \
        ("logical" in kinds)


def nfa_bound(P, T, K, spec, kprog, cond_cmps, count, cap):
    """(bound ms, bound_by) of one fused step: the bytes the function must
    move — the block's inputs read once, the carry read once and written
    once (every leaf: count and deadline words included), the egress slab
    written once (the matched rows, column 0 of the rows past the count,
    the tail and status rows) and, with absent units, the tail's earliest
    deadline reduced through one word a CTA written and read — over
    HBM3's rate, against its compares (within check, state, stream, gate
    and each table compare per event and slot) over the float32 peak."""
    from siddhi_tpu_torch.ops.nfa import kernel_geometry
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    W = 4 + R * C
    n_lanes = len(kprog.kern_attrs)
    n_gates = len(spec.cond_fns)
    inputs = P * T * (4 * n_lanes + 4 + 4 + 1 + n_gates)
    carry = P * K * 4 * (slot_words(spec) + R * C) + \
        P * 4 * (2 + int(spec.arm_once) +
                 int(spec.eps_start and spec.is_sequence) +
                 (3 * len(spec.units) + 1 if spec.telemetry else 0))
    slab = min(count, cap) * W * 4 + max(cap - count, 0) * 4 + 2 * W * 4
    if any(u.kind == "absent" for u in spec.units):
        slab += 2 * 4 * -(-P // kernel_geometry(K)[1])
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
        key = ("step_ms" if is_kernel(ev.key, "nfa_step_kernel") else
               "compact_ms" if is_kernel(ev.key, "nfa_compact_kernel") else
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
    from siddhi_tpu_torch.ops.nfa import (egress_pack_plain, kernel_gate_word,
                                          kernel_geometry,
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
    # K5 alone: the block's gate word (the torch condition programs); its
    # bound: each attribute lane read once, the word written once
    gate_ms = median_ms(lambda: kernel_gate_word(spec, kp, blk), dev)
    gate_bound = P * T * 4 * (len(spec.attr_names) + 1) / \
        PEAK_BYTES_PER_S * 1e3
    nfa_step_egress.launches, nfa_compact.launches = launches0
    cmps = max(len(c) for c in kp.cmp)
    bound_ms, bound_by = nfa_bound(P, T, K, spec, kp, cmps, count, cap)
    W = 4 + max(spec.n_rows, 1) * max(spec.n_caps, 1)
    cb_ms, cb_by = compact_bound(P, -(-P // L), count, cap, W)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "compact_ms": compact_ms,
            "plain_compact_ms": plain_compact_ms, "compact_bound_ms": cb_ms,
            "compact_bound_by": cb_by, "split": split, "count": count,
            "cap": cap, "seg": seg, "G": G, "L": L, "gate_ms": gate_ms,
            "gate_bound_ms": gate_bound}


def torch_op_bounds() -> dict:
    """Bounds by bytes, at a stated shape, of the JAX package's device
    programs the port keeps as torch ops with no caller on the cells:
    K10b ``reset_slots`` (a batch of 262,144 slots of a slab with 4 value
    lanes: each slot id read, its value row and count written) and K14
    ``shift_clamped`` (a rebase of the pattern cell's carry: its
    slot_start and slot_enter planes read once and written once)."""
    n, V = 262_144, 4
    k10b = n * (4 + 4 * V + 4) / PEAK_BYTES_PER_S * 1e3
    k14 = 2 * 2 * PATTERN_LANES * PATTERN_SLOTS * 4 / PEAK_BYTES_PER_S * 1e3
    return {"reset_slots": {"bound_ms": k10b, "bound_by": "bytes",
                            "shape": {"slots": n, "value_lanes": V}},
            "shift_clamped": {"bound_ms": k14, "bound_by": "bytes",
                              "shape": {"P": PATTERN_LANES,
                                        "K": PATTERN_SLOTS, "planes": 2}}}


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

def app_runtime(dev, text, packed):
    """The runtime of `text`.  packed: the dispatch users get by default,
    where each unsharded pattern query joins the cross-tenant packer and
    steps as a bucket (of one, alone) through nfa_gang_step /
    nfa_gang_compact; otherwise SIDDHI_TPU_XTENANT=0 while it is built,
    and its pattern queries step through nfa_step / nfa_compact."""
    from siddhi_tpu_torch import SiddhiManager
    prev = os.environ.pop("SIDDHI_TPU_XTENANT", None)
    if not packed:
        os.environ["SIDDHI_TPU_XTENANT"] = "0"
    try:
        return SiddhiManager(device=dev).create_siddhi_app_runtime(text)
    finally:
        os.environ.pop("SIDDHI_TPU_XTENANT", None)
        if prev is not None:
            os.environ["SIDDHI_TPU_XTENANT"] = prev


#: the NFA kernels a pattern cell can launch, in _gang_launches' order:
#: the gang's on the default (packed) dispatch, the per-app pair with
#: SIDDHI_TPU_XTENANT=0 (and for a packed tenant's replays)
NFA_CELL_KERNELS = ("nfa_gang_step_kernel", "nfa_gang_compact_kernel",
                    "nfa_step_kernel", "nfa_compact_kernel")


def drive_nfa_cell(dev, text, chunks, columns, packed):
    """One run of a pattern cell through the public API: `text` built by
    app_runtime, every query on the device pattern path, `chunks`
    ((columns, timestamps, ...)) sent to S and Out collected by a
    columnar callback, under the profiler; the four NFA kernels' counts
    set to 0 just before the chunks and read just after.  Returns a dict
    of the run: got (column: arrays), wall, per_kernel, dev_us,
    launches (gang step, gang compaction, nfa_step, nfa_compact), host
    stage seconds, slot grows, replays, final K, lanes, carry bytes,
    dropped partials, peak above the memory allocated before it."""
    import gc

    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback
    from siddhi_tpu_torch.core.ledger import ledger

    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = app_runtime(dev, text, packed)
    build_s = time.perf_counter() - t0
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
    got = {c: [] for c in ("ts",) + tuple(columns)}

    def sink(chunk):
        got["ts"].append(np.array(chunk.timestamps))
        for c in columns:
            got[c].append(np.array(chunk.columns[c]))
    rt.add_callback("Out", ColumnarStreamCallback(sink))
    rt.start()
    h = rt.get_input_handler("S")

    def drive():
        t = time.perf_counter()
        for c in chunks:
            h.send_batch(c[0], timestamps=c[1])
        rt.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    stage0 = dict(ledger().snapshot()["stage_seconds"])
    _set_gang_launches()                  # counts start here
    wall, per_kernel, dev_us = profile_device(drive)
    launches = _gang_launches()
    stage1 = ledger().snapshot()["stage_seconds"]
    nfa = runtimes[0].nfa
    tel = getattr(nfa, "last_telemetry", None)
    res = {"got": got, "wall": wall, "per_kernel": per_kernel,
           "telemetry": None if tel is None else np.array(tel),
           "dev_us": dev_us, "launches": launches, "build_s": build_s,
           "stages": {k: stage1[k] - stage0.get(k, 0.0) for k in stage1},
           "grows": sum(r.slot_grows for r in runtimes),
           "replays": sum(r.replays for r in runtimes),
           "k_final": nfa.spec.n_slots, "lanes": nfa.n_partitions,
           "carry_bytes": sum(v.numel() * v.element_size()
                              for v in nfa.carry.values()),
           "dropped": sum(int(r.nfa.carry["dropped"].sum())
                          for r in runtimes)}
    rt.shutdown()
    res["peak"] = torch.cuda.max_memory_allocated() - mem0
    res["mem0"] = mem0
    return res


def report_nfa_cell(name, r, n_events, n_chunks, packed):
    """Log one drive_nfa_cell run (events/s, ms per chunk, peak, host
    stages, each NFA kernel's device time and launches, the idle share)
    and check that its dispatch's pair of kernels ran once a chunk at
    least, and the other dispatch's gang not at all.  Returns the run's
    numbers for the kernels line."""
    wall = r["wall"]
    route = ("default dispatch: a cross-tenant bucket of one" if packed
             else "SIDDHI_TPU_XTENANT=0: per-app dispatch")
    out = {"wall": wall, "events_per_s": n_events / wall,
           "ms_per_chunk": wall / n_chunks * 1e3,
           "launches": list(r["launches"]), "peak": r["peak"],
           "lanes": r["lanes"], "build_s": r["build_s"],
           "kernel_ms": None, "device_ms": None, "idle_share": None}
    log(f"  {name} ({route}): {n_events} events ({n_chunks} chunks), "
        f"{r['lanes']} lanes, K={r['k_final']}, carry {r['carry_bytes']} B; "
        f"{wall:.3f} s wall (app built in {r['build_s']:.3f} s)")
    log(f"    events/s: {out['events_per_s']:.1f}; ms per chunk: "
        f"{out['ms_per_chunk']:.3f}")
    log(f"    max_memory_allocated: {r['peak']} B above the {r['mem0']} B "
        f"allocated before the run; slot grows {r['grows']}, replays "
        f"{r['replays']}, dropped {r['dropped']}")
    log("    host stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["stages"].items()))
    per_kernel = r["per_kernel"]
    if per_kernel is not None:
        dev_us = r["dev_us"]
        ms = {k: sum(us for key, us in per_kernel.items()
                     if is_kernel(key, k)) / 1e3 for k in NFA_CELL_KERNELS}
        out.update(kernel_ms=ms, device_ms=dev_us / 1e3,
                   idle_share=100 - dev_us / 1e6 / wall * 100)
        log("    device time (ms) / launches: " + ", ".join(
            f"{k} {ms[k]:.3f} / {n}"
            for k, n in zip(NFA_CELL_KERNELS, r["launches"])) +
            f"; all device time {dev_us / 1e3:.3f} ms = "
            f"{dev_us / 1e6 / wall * 100:.3f}% of wall (idle share "
            f"{out['idle_share']:.3f}%)")
        for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log(f"      device {us / 1e3:10.3f} ms  {k[:90]}")
    else:
        log("    torch.profiler recorded no device time: the kernels' "
            "share not measured")
    g_step, g_comp, step, comp = r["launches"]
    ran = (g_step, g_comp) if packed else (step, comp)
    stray = 0 if packed else g_step + g_comp
    if min(ran) < n_chunks or stray:
        raise AssertionError(f"{name} ({route}): launches (gang step, gang "
                             f"compaction, nfa_step, nfa_compact) "
                             f"{r['launches']}, expected >= {n_chunks} of "
                             f"the dispatch's pair")
    if r["dropped"]:
        raise AssertionError(f"{name} ({route}) dropped {r['dropped']} "
                             f"partials")
    return out


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
    """Phase 6: the pattern cell on the default dispatch (its main path:
    the query is a cross-tenant bucket of one on K12), then with
    SIDDHI_TPU_XTENANT=0 (K2 + K4 per app); both runs' rows equal, in
    order, and equal the independent per-key reference.  Returns
    {"packed": numbers, "per_app": numbers}."""
    n_chunks = len(chunks)
    n_events = sum(len(c[1]) for c in chunks)
    runs, cols = {}, {}
    for key, packed in (("packed", True), ("per_app", False)):
        r = drive_nfa_cell(dev, pattern_app(), chunks, ("p1", "p2"), packed)
        cols[key] = {k: np.concatenate(v) if v else np.zeros(0)
                     for k, v in r["got"].items()}
        runs[key] = report_nfa_cell("pattern cell", r, n_events, n_chunks,
                                    packed)
        runs[key]["matches"] = len(cols[key]["ts"])
    a, b = cols["packed"], cols["per_app"]
    if not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("pattern cell: packed rows != "
                             "SIDDHI_TPU_XTENANT=0 rows")
    t_ref = time.perf_counter()
    rts, rp1, rp2 = pattern_reference(chunks)
    if len(rts) != len(a["ts"]):
        raise AssertionError(f"pattern path: {len(a['ts'])} rows, "
                             f"reference {len(rts)}")
    if not (np.array_equal(a["ts"], np.asarray(rts, np.int64)) and
            np.array_equal(a["p1"].astype(np.float32), rp1) and
            np.array_equal(a["p2"].astype(np.float32), rp2)):
        raise AssertionError("pattern path rows != reference")
    log(f"  all {len(rts)} match rows of both runs equal, in order, and "
        f"== the per-key reference, exactly (reference "
        f"{time.perf_counter() - t_ref:.1f} s)")
    return runs


# ------------------------------------------------------------------ phase 7

#: phase 7's absent app: config 3's pattern as one partitioned query (the
#: engine's TIMER rows complete what no later event of a key does)
ABSENT_PARITY_APP = """
@app:playback
define stream S (partition int, price float, kind int);
partition with (partition of S) begin
@info(name='q')
from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 and price > e1.price and price > 60.0]
    -> not S[kind == 0 and price > e2.price] for 3 sec
    within 40000 milliseconds
select e1.price as p1, e2.price as p2
insert into Out;
end;
"""


def pattern_parity(dev, seed):
    """Small feeds through the pattern apps on CUDA (kernels), on the CPU
    (plain step) and through the host engine: PARTITIONED_APP and
    BASELINE config 4's count app give the same rows on all three; config
    3's absent app (whose matches the engine's TIMER rows complete on the
    card) the same rows on CUDA and the CPU, in order.  (The reference's
    host engine is no oracle for absent units: the JAX package's host and
    device engines disagree on them.)"""
    import torch
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.ops.nfa import nfa_compact, nfa_step_egress
    rng = np.random.default_rng(seed + 6)
    spaced = []
    for c in range(4):                    # 97 ms apart: the waits elapse
        spaced.append(({"partition": rng.integers(0, 16, 500).astype(np.int32),
                        "price": rng.uniform(0, 100, 500).astype(np.float32),
                        "kind": rng.integers(0, 2, 500).astype(np.int32)},
                       PATTERN_BASE_TS + (c * 500 + np.arange(500)) * 97))
    apps = [("pattern", PARTITIONED_APP,
             make_pattern_chunks(seed + 5, 4, n_keys=16, chunk=500), True),
            ("count (config 4)", COUNT_APP,
             [c[:2] for c in make_count_chunks(seed + 5, 4, n_keys=16,
                                               chunk=500)], True),
            ("absent (config 3)", ABSENT_PARITY_APP, spaced, False)]

    def run(text, feed, device, engine):
        text = f"@app:engine('{engine}')\n" + text
        rt = SiddhiManager(device=device).create_siddhi_app_runtime(text)
        out = []
        rt.add_callback("Out", StreamCallback(
            lambda evs: out.extend([e.timestamp] + list(e.data)
                                   for e in evs)))
        rt.start()
        h = rt.get_input_handler("S")
        for cols, ts in feed:
            h.send_batch(cols, timestamps=ts)
        pr = rt.partition_runtimes[0]
        on_dev = pr.device_mode and all(
            q.backend == "device" for q in pr.device_query_runtimes.values())
        rt.shutdown()
        return out, on_dev

    for name, text, feed, with_host in apps:
        launches0 = (nfa_step_egress.launches, nfa_compact.launches)
        cuda_rows, on_dev = run(text, feed, dev, "device")
        if nfa_step_egress.launches == launches0[0] or \
                nfa_compact.launches == launches0[1]:
            raise AssertionError(f"{name} parity: the CUDA run launched no "
                                 f"nfa_step or no nfa_compact")
        nfa_step_egress.launches, nfa_compact.launches = launches0
        torch.cuda.synchronize()
        cpu_rows, _ = run(text, feed, "cpu", "device")
        if not on_dev:
            raise AssertionError(f"{name}: not on the device engine")
        if cuda_rows != cpu_rows or not cuda_rows:
            raise AssertionError(f"{name}: CUDA {len(cuda_rows)} rows != "
                                 f"CPU plain {len(cpu_rows)} rows")
        tail = "in order"
        if with_host:
            host_rows, on_host_dev = run(text, feed, dev, "host")
            if on_host_dev:
                raise AssertionError("engine selection did not hold")
            if sorted(cuda_rows) != sorted(host_rows):
                raise AssertionError(f"{name}: device {len(cuda_rows)} rows "
                                     f"!= host {len(host_rows)} rows")
            tail += " == host engine (sorted)"
        log(f"  {name}: {len(cuda_rows)} rows; CUDA == CPU plain ({tail}), "
            f"exactly")


# ------------------------------------------------------------------ phase 8

#: bench.py's headline configuration (BASELINE.json metric "events/sec +
#: p99 match latency (1k patterns x 10k partitions)"), verbatim
N_BANK = 1000
BANK_P = 10_000
BANK_K = 8
BANK_T = 64
BANK_CHUNK = 200
BANK_RING = 32
BANK_WITHIN_MS = 40_000
BANK_GAP_MS = BANK_P                      # round-robin: per-lane gap P ms
BANK_FLOOR = 99.9
BANK_BASE_TS = 1_000_000
#: the fleet cell's timed window is repeated this many times from the same
#: carry (over 0.5 s of wall at ≈ 1.5 ms a block on an H100, 700 W): median
#: and spread (cut from 24 to keep the script within its time limit)
FLEET_REPEATS = 12


def bank_app(thr, floor=BANK_FLOOR, within_ms=BANK_WITHIN_MS) -> str:
    """bench.py app_for, verbatim."""
    return f"""
    define stream S (partition int, price float, kind int);
    @info(name='q')
    from every e1=S[kind == 0 and price > {thr}] -> e2=S[kind == 1 and price > e1.price and price > {floor}]
        within {within_ms} milliseconds
    select e1.price as p1, e2.price as p2
    insert into Out;
    """


#: BASELINE.json config 3 ("1k compiled `every A -> B -> not C within t`
#: NFAs, shared 10k-key partitioned stream"): bench.py's bank pattern with a
#: trailing absent unit, its wait bench.py's engine absent row's
#: (bench_engine_absent, `for 3 sec`)
ABSENT_WAIT_MS = 3_000


def absent_bank_app(thr, floor=BANK_FLOOR, within_ms=BANK_WITHIN_MS,
                    wait_ms=ABSENT_WAIT_MS) -> str:
    """bench.py app_for with config 3's trailing `not C for t`."""
    return f"""
    define stream S (partition int, price float, kind int);
    @info(name='q')
    from every e1=S[kind == 0 and price > {thr}] -> e2=S[kind == 1 and price > e1.price and price > {floor}]
        -> not S[kind == 0 and price > e2.price] for {wait_ms} milliseconds
        within {within_ms} milliseconds
    select e1.price as p1, e2.price as p2
    insert into Out;
    """


def count_bank_app(thr, within_ms=BANK_WITHIN_MS) -> str:
    """A kleene count bank (the thread instance's count template):
    bench.py's pattern with e2 a count of 2..3 events reading e1's capture, and e3
    its [last] bank."""
    return f"""
    define stream S (partition int, price float, kind int);
    @info(name='q')
    from every e1=S[kind == 0 and price > {thr}] -> e2=S[kind == 1 and price > e1.price]<2:3>
        -> e3=S[kind == 0 and price < e2[last].price]
        within {within_ms} milliseconds
    select e1.price as p1, e2[last].price as p2
    insert into Out;
    """


def bank_blocks(rng, n_blocks, P=BANK_P, T=BANK_T, gap=BANK_GAP_MS,
                first=0, kinds=2):
    """bench.py gen_flat + gen_block: per block b (counted from `first`),
    event (i, j) of lane i at BASE + (b * T + j) * gap + i * (gap // P),
    price U[0, 100), kind U{0, .., kinds - 1}, packed into [P, T] lanes
    by the port's pack_blocks."""
    from siddhi_tpu_torch.ops.pack import pack_blocks
    out = []
    for b in range(first, first + n_blocks):
        n = P * T
        j = np.repeat(np.arange(T, dtype=np.int64), P)
        i = np.tile(np.arange(P, dtype=np.int64), T)
        ts = BANK_BASE_TS + (b * T + j) * gap + i * (gap // P)
        cols = {"partition": i.astype(np.float32),
                "price": rng.uniform(0.0, 100.0, n).astype(np.float32),
                "kind": rng.integers(0, kinds, n).astype(np.float32)}
        out.append(pack_blocks(i, cols, ts, np.zeros(n, np.int32), P,
                               base_ts=BANK_BASE_TS))
    return out


def bank_block_reference(blocks, thrs, floor=BANK_FLOOR, gap=BANK_GAP_MS,
                         within_ms=BANK_WITHIN_MS):
    """Independent reference of the bank over the lane streams, per
    block: an arm is a `kind == 0` event; it is a match of pattern i when
    its price is above float32(thr_i) and a later event of its lane
    within `within` (here the next within // gap events) has kind 1 and
    a price above both its own and float32(floor); the match lands in
    the block of the first such event.  → (matches [blocks, patterns],
    per-lane price and kind [P, events])."""
    price = np.concatenate([b["price"] for b in blocks], axis=1)
    kind = np.concatenate([b["kind"] for b in blocks], axis=1)
    T = blocks[0]["price"].shape[1]
    lo = np.maximum(price, np.float32(floor))
    done = np.full(price.shape, -1, np.int64)   # the completing event
    for d in range(1, within_ms // gap + 1):
        hit = (kind[:, d:] == 1) & (price[:, d:] > lo[:, :-d])
        first = hit & (done[:, :-d] < 0)
        done[:, :-d][first] = np.nonzero(first)[1] + d
    arm = (kind == 0) & (done >= 0)
    p1, blk = price[arm], done[arm] // T
    t32 = np.asarray(thrs, np.float32)
    counts = np.zeros((len(blocks), len(t32)), np.int64)
    for b in range(len(blocks)):
        x = np.sort(p1[blk == b])
        counts[b] = len(x) - np.searchsorted(x, t32, side="right")
    return counts, price, kind


def absent_block_reference(blocks, thrs, floor=BANK_FLOOR, gap=BANK_GAP_MS,
                           within_ms=BANK_WITHIN_MS,
                           wait_ms=ABSENT_WAIT_MS):
    """Independent reference of the absent bank (:func:`absent_bank_app`)
    over the lane streams, per block: an arm (a `kind == 0` event) takes
    the first later event of its lane within `within` with kind 1 and a
    price above both its own and float32(floor) as its e2, as in
    :func:`bank_block_reference`; it then waits `wait` from e2's ts.  An
    event of the lane before the wait ends, or the first one at or after
    it, with kind 0 and a price above e2's kills it; the first event at or
    after the wait completes it (the match lands in that event's block)
    unless it is more than `within` after the arm or kills it.  A match
    of pattern i when the arm's price is above float32(thr_i).  → (matches
    [blocks, patterns], per-lane price and kind [P, events], the
    completing event of each arm [P, events] (-1: none))."""
    price = np.concatenate([b["price"] for b in blocks], axis=1)
    kind = np.concatenate([b["kind"] for b in blocks], axis=1)
    T = blocks[0]["price"].shape[1]
    n = price.shape[1]
    lo = np.maximum(price, np.float32(floor))
    e2 = np.full(price.shape, -1, np.int64)     # each arm's e2
    for d in range(1, within_ms // gap + 1):
        hit = (kind[:, d:] == 1) & (price[:, d:] > lo[:, :-d])
        first = hit & (e2[:, :-d] < 0)
        e2[:, :-d][first] = np.nonzero(first)[1] + d
    done = np.full(price.shape, -1, np.int64)   # the completing event
    arm = (kind == 0) & (e2 >= 0)
    lane, j1 = np.nonzero(arm)
    j2 = e2[lane, j1]
    wait_ev = -(-wait_ms // gap)                # events until the wait ends
    alive = np.ones(len(lane), bool)
    for d in range(1, wait_ev + 1):
        e = j2 + d
        ok = e < n
        ec = np.minimum(e, n - 1)
        alive &= ok & ((ec - j1) * gap <= within_ms)
        alive &= ~((kind[lane, ec] == 0) &
                   (price[lane, ec] > price[lane, j2]))
    done[lane[alive], j1[alive]] = (j2 + wait_ev)[alive]
    p1, blk = price[done >= 0], done[done >= 0] // T
    t32 = np.asarray(thrs, np.float32)
    counts = np.zeros((len(blocks), len(t32)), np.int64)
    for b in range(len(blocks)):
        x = np.sort(p1[blk == b])
        counts[b] = len(x) - np.searchsorted(x, t32, side="right")
    return counts, price, kind, done


def bank_reference(blocks, thrs, floor=BANK_FLOOR, gap=BANK_GAP_MS,
                   within_ms=BANK_WITHIN_MS):
    """:func:`bank_block_reference` summed over the blocks → (matches per
    pattern, per-lane price and kind [P, events])."""
    counts, price, kind = bank_block_reference(blocks, thrs, floor, gap,
                                               within_ms)
    return counts.sum(axis=0), price, kind


def check_ring_rows(dec, price, kind, thrs, floor=BANK_FLOOR,
                    gap=BANK_GAP_MS, within_ms=BANK_WITHIN_MS) -> int:
    """Every decoded ring row (pattern, partition, ts, p1, p2) is a match
    of the reference: its e2 is an event of its lane at ts with kind 1
    and price p2, and an arm of that pattern precedes it within `within`
    with price p1 < p2."""
    lane = dec["partition"].astype(np.int64)
    j2 = (dec["ts"] - BANK_BASE_TS - lane * (gap // price.shape[0])) // gap
    p1 = dec["p1"].astype(np.float32)
    p2 = dec["p2"].astype(np.float32)
    thr = np.asarray(thrs, np.float32)[dec["pattern"]]
    ok = (j2 >= 0) & (j2 < price.shape[1])
    j2c = np.clip(j2, 0, price.shape[1] - 1)
    ok &= (kind[lane, j2c] == 1) & (price[lane, j2c] == p2)
    ok &= (p2 > p1) & (p2 > np.float32(floor)) & (p1 > thr)
    arm = np.zeros(len(lane), bool)
    for d in range(1, within_ms // gap + 1):
        j1 = np.clip(j2c - d, 0, None)
        arm |= (j2c - d >= 0) & (kind[lane, j1] == 0) & \
            (price[lane, j1] == p1)
    bad = ~(ok & arm)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise AssertionError(
            f"ring row is no match: pattern {dec['pattern'][i]} lane "
            f"{lane[i]} ts {dec['ts'][i]} p1 {p1[i]} p2 {p2[i]}")
    return len(lane)


def _max_abs_diff(a, b) -> float:
    """The largest |a - b| over two tensors of one dtype and shape (NaN
    against NaN and equal infinities count as 0), taken a slice of the
    leading axis at a time so a 2 GB carry leaf needs no copy of itself."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    if a.dim() == 0:
        return _abs_err(a.reshape(1), b.reshape(1))
    step = max(1, (1 << 26) // max(a[0].numel(), 1))
    return max(_abs_err(a[i:i + step], b[i:i + step])
               for i in range(0, a.shape[0], step))


def _bank_outputs_equal(name, got, want, new_k, new_p) -> float:
    """The six raw outputs (or the counts) and every carry leaf, bit for
    bit; → the largest absolute difference measured over all of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    names = ("counts", "ring_cnt", "ring_pid", "ring_caps", "ring_ts",
             "ring_ok")
    worst = 0.0
    for x, y, n in zip(got, want, names):
        worst = max(worst, _max_abs_diff(x, y))
        if not _same_bits(x, y):
            raise AssertionError(f"bank kernels != plain: {name} {n} (max "
                                 f"abs diff {worst})")
    for k in new_p:
        worst = max(worst, _max_abs_diff(new_k[k], new_p[k]))
        if not _same_bits(new_k[k], new_p[k]):
            raise AssertionError(f"bank kernels != plain: {name} carry.{k} "
                                 f"(max abs diff {worst})")
    return worst


def _bank_plain(bank, carry, block):
    from siddhi_tpu_torch.ops.nfa import nfa_bank_step_plain
    params = bank._stack_params if bank.stacked else bank.params[0]
    return nfa_bank_step_plain(bank.nfa.spec, carry, block, params,
                               bank.ring)


def _snapshot(bank):
    c = bank._stack_carry if bank.stacked else bank._carries[0]
    return {k: v.clone() for k, v in c.items()}


def _carry(bank):
    return bank._stack_carry if bank.stacked else bank._carries[0]


def bank_launches():
    """(bank step launches, of them the thread instance's and the group
    instance's, ring launches, and of the step's the widened group
    instance's and the widened thread instance's) since the counters'
    last reset."""
    from siddhi_tpu_torch.ops.nfa import nfa_bank_ring, nfa_bank_step
    return (nfa_bank_step.launches, nfa_bank_step.thread_launches,
            nfa_bank_step.group_launches, nfa_bank_ring.launches,
            nfa_bank_step.wide_launches, nfa_bank_step.wide_thread_launches)


def set_bank_launches(v=(0, 0, 0, 0, 0, 0)):
    from siddhi_tpu_torch.ops.nfa import nfa_bank_ring, nfa_bank_step
    (nfa_bank_step.launches, nfa_bank_step.thread_launches,
     nfa_bank_step.group_launches, nfa_bank_ring.launches,
     nfa_bank_step.wide_launches, nfa_bank_step.wide_thread_launches) = v


@contextlib.contextmanager
def forced_wide_group():
    """ops/nfa's bank instance choice forced to the widened group
    instance (csrc/nfa_wide.cu) for a widened program that the widened
    thread instance would take: the parent's instance, timed on the same
    block."""
    from siddhi_tpu_torch.ops import nfa as nfa_ops
    real = nfa_ops.bank_geometry

    def group(*a, **k):
        g = real(*a, **k)
        return nfa_ops.BankGeometry("wide", 0, 0) \
            if g.instance == "wide_thread" else g
    nfa_ops.bank_geometry = group
    try:
        yield
    finally:
        nfa_ops.bank_geometry = real


def check_bank(dev, seed, main_bank, main_block):
    """The bank kernels (the bank step, then the ring) against the plain
    bank step on the card, bit for bit: counts, the six raw ring outputs
    and every carry leaf.  Cases: the fleet cell's own next block (alert
    band, stacked, carry updated in place); a full-size block in the
    matchy band (thresholds 5..95, floor 0: rings filled through ties);
    stacked vs sequential over the matchy blocks; a replayable bank from
    K = 1 that grows and replays (the thread instance up to K = 16, the
    group instance above); K = 160 (the wide-ring instance), in place and
    not; a one-unit chain; a chain without `every`; then the widened
    banks (check_widened_banks).  → (cases, the fleet block's outputs,
    the largest absolute difference measured between the kernels and the
    plain step over every output and carry leaf compared, the stacked
    matchy bank and its last block, for timing)."""
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import (CompiledPatternBank,
                                                    _widen_slots)
    launches0 = bank_launches()
    cases = 0
    # (a) the fleet cell's bank on its next block, in place
    pre = _snapshot(main_bank)
    got = main_bank.process_block(main_block)
    new_p, want = _bank_plain(main_bank, pre, main_block)
    torch.cuda.synchronize()
    worst = _bank_outputs_equal("alert band (in place)", got, want,
                                _carry(main_bank), new_p)
    log(f"  bank == plain  alert band, stacked, in place: "
        f"{N_BANK} x {BANK_P} x T={BANK_T}, {int(want[0].sum())} matches, "
        f"{int((want[1] == 0).sum())} zero ring rows")
    cases += 1
    main_out = got
    del pre, new_p, want
    # (b) the matchy band, full size; (c) stacked vs sequential on it
    rng = np.random.default_rng(seed + 8)
    mblocks = bank_blocks(rng, 2)
    apps = [bank_app(t, floor=0.0) for t in np.linspace(5.0, 95.0, N_BANK)]
    stk = CompiledPatternBank(apps, n_partitions=BANK_P, n_slots=BANK_K,
                              pattern_chunk=BANK_CHUNK, ring=BANK_RING,
                              device=dev)
    seq = CompiledPatternBank(apps, n_partitions=BANK_P, n_slots=BANK_K,
                              pattern_chunk=BANK_CHUNK, ring=BANK_RING,
                              stack=False, device=dev)
    assert stk.stacked and not seq.stacked and seq.n_chunks == \
        N_BANK // BANK_CHUNK
    for b, raw in enumerate(mblocks):
        blk = stk.nfa.to_device(raw)
        pre = _snapshot(stk) if b else None
        got = stk.process_block(blk)
        got_seq = seq.process_block(blk)
        torch.cuda.synchronize()
        for x, y in zip(got, got_seq):
            if not _same_bits(x, y):
                raise AssertionError("bank: stacked != sequential outputs")
        for ci, (cs, cq) in enumerate(zip(stk.carries, seq.carries)):
            for k in cs:
                if not _same_bits(cs[k], cq[k]):
                    raise AssertionError(f"bank: stacked != sequential "
                                         f"carry.{k} chunk {ci}")
        if pre is not None:
            new_p, want = _bank_plain(stk, pre, blk)
            torch.cuda.synchronize()
            worst = max(worst, _bank_outputs_equal(
                "matchy band", got, want, _carry(stk), new_p))
            rc = want[1]
            ties = int((rc[:, 1:] == rc[:, :-1]).sum())
            log(f"  bank == plain  matchy band (5..95, floor 0), stacked: "
                f"{int(want[0].sum())} matches, ring ties {ties}; stacked "
                f"== sequential on both blocks")
            del pre, new_p, want
    cases += 2
    del seq
    mblk = blk
    # (d) replayable, K = 1: grows and replays (not in place)
    rp = CompiledPatternBank(apps[::25], n_partitions=2048, n_slots=1,
                             pattern_chunk=20, ring=BANK_RING,
                             replayable=True, device=dev)
    grown = 0
    for raw in bank_blocks(np.random.default_rng(seed + 9), 3, P=2048,
                           gap=2048):
        blk = rp.nfa.to_device(raw)
        pre = _snapshot(rp)
        k0 = rp.nfa.spec.n_slots
        got = rp.process_block_replayed(blk)
        k1 = rp.nfa.spec.n_slots
        grown += k1 > k0
        R, C = max(rp.nfa.spec.n_rows, 1), max(rp.nfa.spec.n_caps, 1)
        if k1 > k0:
            pre = _widen_slots(pre, 3 if rp.stacked else 2, k1 - k0, R, C)
        new_p, want = _bank_plain(rp, pre, blk)
        torch.cuda.synchronize()
        worst = max(worst, _bank_outputs_equal(
            f"replayable K {k0}->{k1}", got, want, _carry(rp), new_p))
    if not grown or rp.total_dropped():
        raise AssertionError(f"replay case: grew {grown} times, dropped "
                             f"{rp.total_dropped()}")
    log(f"  bank == plain  replayable from K=1: grew to K="
        f"{rp.nfa.spec.n_slots} over 3 blocks (N=40 P=2048), dropped 0")
    cases += 1
    del rp
    # (e) K = 160: the wide-ring instance, in place and not
    wide_apps = [bank_app(t) for t in np.linspace(5.0, 50.0, 8)]
    raw = bank_blocks(np.random.default_rng(seed + 10), 1, P=256, T=600,
                      gap=10)[0]
    for replayable in (False, True):
        wb = CompiledPatternBank(wide_apps, n_partitions=256, n_slots=160,
                                 pattern_chunk=4, ring=BANK_RING,
                                 replayable=replayable, device=dev)
        blk = wb.nfa.to_device(raw)
        pre = _snapshot(wb)
        got = wb.process_block(blk)
        new_p, want = _bank_plain(wb, pre, blk)
        torch.cuda.synchronize()
        mode = "not in place" if replayable else "in place"
        worst = max(worst, _bank_outputs_equal(
            f"K=160 {mode}", got, want, _carry(wb), new_p))
        hi = int((new_p["slot_state"] >= 0).sum(dim=-1).max())
        if hi <= 128:
            raise AssertionError(f"K=160 case held at most {hi} partials")
        log(f"  bank == plain  K=160 wide ring, {mode}: P=256 T=600, "
            f"{int(want[0].sum())} matches, most live in a lane {hi}, "
            f"dropped {int(new_p['dropped'].sum())}")
        cases += 1
    # (f) other shapes of the kernel's class, two chained blocks each: a
    # one-unit chain (arming completes the match) and a chain without
    # `every` (single-shot arming)
    stream = "define stream S (partition int, price float, kind int);\n"
    shapes = {
        "one unit": [stream + f"from every e1=S[price > {t} and kind == 0] "
                     "select e1.price as p1 insert into Out;"
                     for t in np.linspace(50.0, 99.0, 8)],
        "no every": [stream + f"from e1=S[kind == 0 and price > {t}] -> "
                     "e2=S[kind == 1 and price > e1.price] select e1.price "
                     "as p1, e2.price as p2 insert into Out;"
                     for t in np.linspace(5.0, 95.0, 8)]}
    for name, sapps in shapes.items():
        sb = CompiledPatternBank(sapps, n_partitions=1024, n_slots=BANK_K,
                                 pattern_chunk=4, ring=BANK_RING, device=dev)
        matches = 0
        for raw in bank_blocks(np.random.default_rng(seed + 11), 2, P=1024,
                               gap=1024):
            blk = sb.nfa.to_device(raw)
            pre = _snapshot(sb)
            got = sb.process_block(blk)
            new_p, want = _bank_plain(sb, pre, blk)
            torch.cuda.synchronize()
            worst = max(worst, _bank_outputs_equal(
                name, got, want, _carry(sb), new_p))
            matches += int(want[0].sum())
        if not matches:
            raise AssertionError(f"{name} case matched nothing")
        log(f"  bank == plain  {name}: N=8 P=1024 T=64, {matches} matches")
        cases += 1
    used = bank_launches()
    log(f"  bank step launches in the checks: thread instance "
        f"{used[1] - launches0[1]}, group instance {used[2] - launches0[2]}")
    if used[1] == launches0[1] or used[2] == launches0[2]:
        raise AssertionError("bank checks did not run both instances")
    n, w = check_widened_banks(dev, seed)
    set_bank_launches(launches0)
    return cases + n, main_out, max(worst, w), stk, mblk


#: the widened bank kinds over {t} (a pattern constant), fed kinds 0..2:
#: {name: (app, telemetry)}.  ops/nfa.kernel_wide's programs run the bank
#: step's widened instance; in a bank every numeric constant is a pattern
#: constant, so `<capture> <cmp> <constant>` becomes a condition program
#: comparing the capture with the pattern's constant (the thread instance,
#: as before)
WIDE_BANK_APPS = {
    "logical and": (
        "from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 and "
        "price > e1.price] and e3=S[kind == 2] within 20 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;",
        False),
    "logical or": (
        "from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 and "
        "price > e1.price] or e3=S[kind == 2 and price < e1.price] within "
        "10 sec select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;", False),
    "sequence": (
        "from every e1=S[kind == 0 and price > {t}], e2=S[kind == 1 and "
        "price > e1.price] within 10 sec select e1.price as p1, e2.price "
        "as p2 insert into Out;", False),
    "every group": (
        "from every (e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1]) "
        "-> e3=S[kind == 2 and price > e1.price] within 10 sec select "
        "e1.price as p1, e3.price as p3 insert into Out;", False),
    "mid every": (
        "from e1=S[kind == 0 and price > {t}] -> every e2=S[kind == 1 and "
        "price > e1.price] -> e3=S[kind == 2] within 10 sec select "
        "e1.price as p1, e3.price as p3 insert into Out;", False),
    "tail every": (
        "from e1=S[kind == 0 and price > {t}] -> every e2=S[kind == 1 and "
        "price > e1.price] within 20 sec select e1.price as p1, e2.price "
        "as p2 insert into Out;", False),
    "leading min-0": (
        "from e1=S[kind == 0 and price > {t}]<0:3> -> e2=S[kind == 1] "
        "within 10 sec select e1[last].price as l1, e2.price as p2 insert "
        "into Out;", False),
    "leading absent": (
        "from every not S[kind == 1 and price > {t}] for 3 sec -> "
        "e2=S[kind == 0] within 10 sec select e2.price as p2 insert into "
        "Out;", False),
    "telemetry": (
        "from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 and "
        "price > e1.price] within 10 sec select e1.price as p1, e2.price "
        "as p2 insert into Out;", True),
    "capture constant": (
        "from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 and "
        "e1.price < 90.0 and price > e1.price] within 10 sec select "
        "e1.price as p1, e2.price as p2 insert into Out;", False),
    "first capture": (
        "from every e1=S[kind == 0 and price > {t} and price > "
        "e1[last].price]<1:3> -> e2=S[kind == 1] within 10 sec select "
        "e1[last].price as l1, e2.price as p2 insert into Out;", False),
    "first program": (
        "from every e1=S[kind == 0 and price * 2.0 > {t}] -> e2=S[kind == 1 "
        "and price > e1.price] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;", False),
}


def wide_bank(name, thrs, **kw):
    """A CompiledPatternBank of WIDE_BANK_APPS[name] over thresholds
    `thrs` (its telemetry flag included); kw: the bank's other
    arguments."""
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    text, tel = WIDE_BANK_APPS[name]
    return CompiledPatternBank(
        [_S3 + text.format(t=round(float(t), 3)) for t in thrs],
        telemetry=tel, **kw)


def check_widened_banks(dev, seed):
    """The bank kernels against the plain bank step bit for bit on the
    widened class: the absent bank (absent_bank_app) on the thread
    instance, alert and matchy bands, T = 64 and T = 4, in place and not;
    count banks (count_bank_app, and config 4's leading count) on the
    thread instance, and count_bank_app at K = 24 on the group instance;
    a K = 24 leading count on the group instance over a ragged block
    (_check_ragged_group_bank); every WIDE_BANK_APPS kind
    (_check_wide_kinds).  Each instance's launch counter must rise where
    its banks run and stay flat elsewhere.  → (cases, the largest
    absolute difference measured)."""
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    worst, cases = 0.0, 0
    P = 2048
    before = bank_launches()
    for band, lo, hi, floor in (("alert", 99.8, 99.997, BANK_FLOOR),
                                ("matchy", 5.0, 95.0, 0.0)):
        apps = [absent_bank_app(t, floor=floor)
                for t in np.linspace(lo, hi, 40)]
        for replayable in (False, True):
            for T_, n_blocks in ((BANK_T, 3), (4, 12)):
                ab = CompiledPatternBank(apps, n_partitions=P,
                                         n_slots=BANK_K, pattern_chunk=20,
                                         ring=BANK_RING,
                                         replayable=replayable, device=dev)
                rng = np.random.default_rng(seed + 30 + T_)
                matches = 0
                for raw in bank_blocks(rng, n_blocks, P=P, T=T_, gap=P):
                    blk = ab.nfa.to_device(raw)
                    pre = _snapshot(ab)
                    got = ab.process_block(blk)
                    new_p, want = _bank_plain(ab, pre, blk)
                    torch.cuda.synchronize()
                    worst = max(worst, _bank_outputs_equal(
                        f"absent {band} T={T_}", got, want, _carry(ab),
                        new_p))
                    matches += int(want[0].sum())
                mode = "not in place" if replayable else "in place"
                log(f"  bank == plain  absent units, {band} band, T={T_}, "
                    f"{mode}: N=40 P={P} x {n_blocks} blocks, {matches} "
                    f"matches, dropped {ab.total_dropped()}")
                if band == "matchy" and not matches:
                    raise AssertionError("absent matchy bank matched nothing")
                cases += 1
    mid = bank_launches()
    count_apps = {
        "count mid-chain": [count_bank_app(t)
                            for t in np.linspace(5.0, 95.0, 8)],
        "count leading (config 4)": [
            _S3 + f"from every e1=S[kind == 0 and price > {t}]<3:10> -> "
            "e2=S[kind == 1 and price > e1[last].price] within 10 sec "
            "select e1[0].price as p0, e1[last].price as pl, e2.price as p2 "
            "insert into Out;" for t in np.linspace(5.0, 60.0, 8)]}
    count_apps["count mid-chain K=24"] = count_apps["count mid-chain"]
    for name, apps in count_apps.items():
        if name == "count mid-chain K=24":
            mid2 = bank_launches()
        K = 24 if name.endswith("K=24") else BANK_K
        cb = CompiledPatternBank(apps, n_partitions=1024, n_slots=K,
                                 pattern_chunk=4, ring=BANK_RING, device=dev)
        matches = 0
        for raw in bank_blocks(np.random.default_rng(seed + 40), 3, P=1024,
                               gap=1024):
            blk = cb.nfa.to_device(raw)
            pre = _snapshot(cb)
            got = cb.process_block(blk)
            new_p, want = _bank_plain(cb, pre, blk)
            torch.cuda.synchronize()
            worst = max(worst, _bank_outputs_equal(
                name, got, want, _carry(cb), new_p))
            matches += int(want[0].sum())
        if not matches:
            raise AssertionError(f"{name} bank matched nothing")
        inst = "group" if K > 16 else "thread"
        log(f"  bank == plain  {name} ({inst} instance): N=8 P=1024 T=64 x "
            f"3 blocks, {matches} matches")
        cases += 1
    end = bank_launches()
    if mid[1] == before[1] or mid[2] != before[2] or \
            mid2[1] == mid[1] or mid2[2] != mid[2] or \
            end[2] == mid2[2] or end[1] != mid2[1]:
        raise AssertionError(f"widened bank checks: thread instance "
                             f"{mid[1] - before[1]} launches for absent and "
                             f"{mid2[1] - mid[1]} for counts, group "
                             f"{mid[2] - before[2]} and {mid2[2] - mid[2]} "
                             f"(each 0), group {end[2] - mid2[2]} for the "
                             f"K = 24 count (> 0, thread "
                             f"{end[1] - mid2[1]})")
    if any(x != y for x, y in zip(before[4:] + mid[4:] + mid2[4:],
                                  mid[4:] + mid2[4:] + end[4:])):
        raise AssertionError("widened bank checks: the widened instance "
                             "ran for a thread or group instance bank")
    n, w = _check_ragged_group_bank(dev, seed)
    cases, worst = cases + n, max(worst, w)
    n, w = _check_wide_kinds(dev, seed)
    return cases + n, max(worst, w)


#: the group instance's ragged case: a leading count whose one chain a
#: lane (an `every` leading count arms once) leaves the count near the
#: 61st event, so on the ragged block the plain step's padding rows expire
#: the chains that left it at the last event with a start past `within`
RAGGED_COUNT_APP = (
    "from every e1=S[kind == 0 and price > {t}]<30:40> -> e2=S[kind == 1 "
    "and price > e1[last].price] within 60 sec select e1[0].price as p0, "
    "e1[last].price as pl, e2.price as p2 insert into Out;")


def _check_ragged_group_bank(dev, seed):
    """The group instance's padding rows' `within` pass: the K = 24
    leading count bank (RAGGED_COUNT_APP, N = 8, P = 1,024) over a ragged
    block (T = 61 at B = 4), then two of T = 64, each bit for bit against
    the plain bank step, in place; the plain step's padding rows must
    expire partials on the ragged block (the plain step at B = 1 on the
    same block keeps them), and only the group instance runs.  →
    (cases, the largest absolute difference)."""
    import torch
    from siddhi_tpu_torch.ops.nfa import bank_lanes_plain
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    P = 1024
    apps = [_S3 + RAGGED_COUNT_APP.format(t=round(float(t), 3))
            for t in np.linspace(0.0, 10.0, 8)]
    rb = CompiledPatternBank(apps, n_partitions=P, n_slots=24,
                             pattern_chunk=4, ring=BANK_RING, device=dev)
    raws = bank_blocks(np.random.default_rng(seed + 41), 3, P=P, gap=P)
    raws[0] = {k: v[:, :61] for k, v in raws[0].items()}
    l0 = bank_launches()
    worst, matches, expired = 0.0, 0, 0
    for i, raw in enumerate(raws):
        blk = rb.nfa.to_device(raw)
        pre = _snapshot(rb)
        got = rb.process_block(blk)
        new_p, want = _bank_plain(rb, pre, blk)
        if i == 0:
            unpadded = bank_lanes_plain(rb.nfa.spec, pre, blk,
                                        rb._stack_params, 1)[0]
            expired = int((unpadded["slot_state"] !=
                           new_p["slot_state"]).sum())
            del unpadded
        torch.cuda.synchronize()
        worst = max(worst, _bank_outputs_equal(
            f"ragged count K=24 block {i}", got, want, _carry(rb), new_p))
        matches += int(want[0].sum())
        del pre, new_p, want
    l1 = bank_launches()
    if not expired or not matches or l1[2] - l0[2] != len(raws) or \
            l1[1] != l0[1] or l1[4:] != l0[4:]:
        raise AssertionError(f"ragged K=24 count bank: {expired} partials "
                             f"expired by the padding rows, {matches} "
                             f"matches, launches {l0} -> {l1}: expected "
                             f"both above 0 and the group instance alone")
    log(f"  bank == plain  leading count K=24 (group instance), ragged "
        f"block T=61 at B=4 then 2 x T=64, in place: N=8 P={P}, {matches} "
        f"matches, {expired} partials expired by the padding rows' "
        f"`within` pass")
    return 1, worst


#: the widened case that stays on the widened group instance: a ring of
#: 24 slots (the thread instances take 16)
WIDE_GROUP_CASES = {"logical or K=24": ("logical or", 24)}


def _check_wide_kinds(dev, seed):
    """Every WIDE_BANK_APPS kind against the plain bank step bit for bit
    (every carry leaf, counts and the ring): N = 40, P = 2,048, three
    chunks of the feed's kinds 0..2 at T = 64 (2 blocks) and T = 4 (4
    blocks), in place and not, at K = 8; and WIDE_GROUP_CASES at K = 24.
    Each widened kind at K = 8 raises the widened thread instance's
    counter by a launch a block, at K = 24 the widened group instance's,
    and the other instances' stay flat; the capture-to-constant bank runs
    the thread instance.  → (cases, the largest absolute difference)."""
    import torch
    worst, cases = 0.0, 0
    n_patterns, P = 40, 2048
    thrs = np.linspace(5.0, 95.0, n_patterns)
    kinds = {name: (name, BANK_K) for name in WIDE_BANK_APPS}
    kinds.update(WIDE_GROUP_CASES)
    for name, (kind, K) in kinds.items():
        widened = kind != "capture constant"
        inst = "thread" if not widened else \
            "widened thread" if K <= 16 else "widened group"
        for replayable in (False, True):
            for T_, n_blocks in ((BANK_T, 2), (4, 4)):
                wb = wide_bank(kind, thrs, n_partitions=P, n_slots=K,
                               pattern_chunk=20, ring=BANK_RING,
                               replayable=replayable, device=dev)
                rng = np.random.default_rng(seed + 60 + T_)
                matches = 0
                l0 = bank_launches()
                for raw in bank_blocks(rng, n_blocks, P=P, T=T_, gap=P,
                                       kinds=3):
                    blk = wb.nfa.to_device(raw)
                    pre = _snapshot(wb)
                    got = wb.process_block(blk)
                    new_p, want = _bank_plain(wb, pre, blk)
                    torch.cuda.synchronize()
                    worst = max(worst, _bank_outputs_equal(
                        f"{name} T={T_}", got, want, _carry(wb), new_p))
                    matches += int(want[0].sum())
                    del pre, new_p, want
                l1 = bank_launches()
                rose = tuple(l1[i] - l0[i] for i in (5, 4, 1, 2))
                expect = {"widened thread": (n_blocks, 0, 0, 0),
                          "widened group": (0, n_blocks, 0, 0),
                          "thread": (0, 0, n_blocks, 0)}[inst]
                if rose != expect:
                    raise AssertionError(
                        f"{name}: launches (widened thread, widened group, "
                        f"thread, group) {rose} over {n_blocks} blocks, "
                        f"expected {expect}")
                mode = "not in place" if replayable else "in place"
                log(f"  bank == plain  {name} ({inst} instance), "
                    f"T={T_}, {mode}: N={n_patterns} P={P} K={K} x "
                    f"{n_blocks} blocks, {matches} matches, dropped "
                    f"{wb.total_dropped()}")
                if not matches and kind != "first capture":
                    raise AssertionError(f"{name} bank matched nothing")
                cases += 1
                del wb
    return cases, worst


def bank_step_bound(bank, P, T):
    """(bound ms, bound_by) of one bank step launch: the block's inputs
    read once (attribute lanes, ts, stream, valid, a gate byte per
    condition), the pattern constants read once, the carry read once and
    written once (every leaf: the widened ones too), count / lmt / lmk
    written once; against its compares (within, state, stream, gate,
    each table compare per event and slot) over the float32 peak."""
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    K, CN = spec.n_slots, bank.n_patterns
    carry = CN * (P * K * 4 * (slot_words(spec) + R * C) +
                  P * 4 * (2 + int(spec.arm_once) +
                           int(spec.eps_start and spec.is_sequence) +
                           (3 * len(spec.units) + 1 if spec.telemetry
                            else 0)))
    nbytes = _bank_input_bytes(bank, P, T) + 2 * carry + 3 * CN * P * 4
    cmps = max(len(c) + len(q) for c, q in zip(kp.cmp, kp.pcmp))
    ops = CN * P * T * K * (4 + cmps)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _bank_input_bytes(bank, P, T):
    """Bytes of one bank step's inputs, each read once: the block's
    attribute lanes, ts, stream, valid and a gate byte per condition, and
    the pattern constants."""
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    return P * T * (4 * len(kp.kern_attrs) + 4 + 4 + 1 +
                    len(spec.cond_fns)) + \
        bank.n_patterns * len(kp.param_names) * 4


def bank_inplace_bound(bank, pre, post, block):
    """(bound ms, "bytes") of one in-place bank step launch over `block`
    that took the carry from `pre` to `post`, counting what each lane
    needs at least: the inputs read once; every slot state read (it
    decides expiry); the starts of each lane that held a partial (the
    `within` check); per slot armed or advanced here (its start, enter,
    seq or captures changed) its state, start, enter, seq and captures
    written, and its captures read if it held a partial (a capture
    compare reads them); per slot whose state alone changed (expired or
    completed) its state written; each lane scalar (arm_seq, dropped,
    armed_total) that changed read and written; count / lmt / lmk
    written.  A lane that armed from empty reads none of its cold words;
    one that only expired writes only its states.  With absent units,
    every slot waiting at one reads its deadline (the deadline pass), and
    every deadline set here is written."""
    import torch
    spec = bank.nfa.spec
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    K, CN = spec.n_slots, bank.n_patterns
    P, T = (int(x) for x in block["__ts"].shape)
    lanes = CN * P

    def diff(k, words):
        a, b = pre[k], post[k]
        if a.dtype == torch.float32:          # bits, not values (NaN)
            a, b = a.view(torch.int32), b.view(torch.int32)
        return (a != b).reshape(lanes * words, -1).any(dim=1).reshape(
            lanes, words)
    live = (pre["slot_state"] >= 1).reshape(lanes, K)
    rewritten = diff("slot_start", K) | diff("slot_enter", K) | \
        diff("slot_seq", K) | diff("captures", K)
    expired = diff("slot_state", K) & ~rewritten
    scalars = sum(int(diff(k, 1).sum()) for k in
                  ("arm_seq", "dropped", "armed_total") if k in pre)
    nbytes = _bank_input_bytes(bank, P, T) + lanes * K * 4 + \
        int(live.any(dim=1).sum()) * K * 4 + \
        int(rewritten.sum()) * (4 * 4 + 4 * R * C) + \
        int((rewritten & live).sum()) * 4 * R * C + \
        int(expired.sum()) * 4 + scalars * 8 + 3 * lanes * 4
    for k in ("cnt_cur", "cnt_prev", "deadline"):
        if k in pre:
            nbytes += int(diff(k, K).sum()) * 4
    if "deadline" in pre:
        absent = torch.tensor([u.kind == "absent" for u in spec.units] +
                              [False], device=pre["slot_state"].device)
        st = pre["slot_state"]
        nbytes += int((absent[st.clamp(0, len(spec.units)).long()] &
                       (st >= 0)).sum()) * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def bank_ring_bound(CN, P, ring, RC):
    """(bound ms, "bytes") of one ring launch: the lane counts read once,
    per ring row its lane's lmt, lmk, slot start and captures read once,
    the totals and the ring rows written once."""
    nbytes = CN * P * 4 + CN * ring * (12 + RC * 4) + CN * 4 + \
        CN * ring * (12 + RC * 4 + 1)
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


#: the ring-only checks on the card: (name, patterns, lanes, ring, counts
#: generator over (rng, shape)); the fleet's CN x P unless named, and two
#: rows above the single-tile size (csrc walks them in tiles)
RING_CASES = [
    ("alert-like (v = 0, ties)", N_BANK, BANK_P, BANK_RING,
     lambda r, s: (r.random(s) < 0.003) * r.integers(1, 4, s)),
    ("counts to 512, ties straddling v", N_BANK, BANK_P, BANK_RING,
     lambda r, s: r.integers(0, 513, s)),
    ("narrow band, heavy ties", N_BANK, BANK_P, BANK_RING,
     lambda r, s: r.integers(200, 204, s)),
    ("all zero", N_BANK, BANK_P, BANK_RING, lambda r, s: np.zeros(s)),
    ("ring = P", N_BANK, BANK_P, BANK_P, lambda r, s: r.integers(0, 64, s)),
    ("ring = 0", N_BANK, BANK_P, 0, lambda r, s: r.integers(0, 513, s)),
    ("P not a multiple of 32 (rows not 16-byte aligned)", N_BANK,
     BANK_P - 1, BANK_RING, lambda r, s: r.integers(0, 513, s)),
    ("int32 extremes", N_BANK, BANK_P, BANK_RING, lambda r, s: r.choice(
        np.array([-2**31, -7, 0, 1, 2**31 - 1]), s) + r.integers(0, 2, s)
     * (r.integers(-2**31, 2**31 - 1, s) // 2)),
    ("counts to 1,000,000 (20 bisection steps)", N_BANK, BANK_P,
     BANK_RING, lambda r, s: r.integers(0, 1_000_000, s)),
    ("tiled: P = 60,000", 16, 60_000, BANK_RING,
     lambda r, s: r.integers(0, 513, s)),
    ("tiled: P = 150,001, ring 1000", 8, 150_001, 1000,
     lambda r, s: r.integers(0, 64, s)),
]


def check_ring(dev, seed):
    """The ring kernel alone against the plain ring on the card, bit for
    bit, on synthetic counts and final carries (K = 8, R x C = 2 x 1,
    lmk any slot, slot starts around each lane's ts): RING_CASES.  → (cases,
    the largest absolute difference measured over every output)."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (bank_ring_plain, nfa_bank_ring,
                                          ring_geometry)
    launches0 = bank_launches()
    rng = np.random.default_rng(seed + 14)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    worst = 0.0
    names = ("total", "ring_cnt", "ring_pid", "ring_caps", "ring_ts",
             "ring_ok")
    carries = {}
    for name, CN, P, ring, counts in RING_CASES:
        if (CN, P) not in carries:
            carries.clear()
            torch.cuda.empty_cache()
            i32 = dict(dtype=torch.int32, device=dev)
            lmt = torch.randint(0, 1 << 20, (CN, P), generator=gen, **i32)
            carries[CN, P] = (
                {"slot_state": torch.zeros((CN, P, BANK_K), **i32),
                 "slot_start": lmt[:, :, None] + torch.randint(
                     -4, 4, (CN, P, BANK_K), generator=gen, **i32),
                 "captures": torch.randn((CN, P, BANK_K, 2, 1),
                                         generator=gen, device=dev)},
                lmt, torch.randint(0, BANK_K, (CN, P), generator=gen, **i32))
        carry, lmt, lmk = carries[CN, P]
        cnt = torch.from_numpy(counts(rng, (CN, P)).astype(np.int32)).to(dev)
        got = nfa_bank_ring(carry, cnt, lmt, lmk, ring)
        want = bank_ring_plain(carry, cnt, lmt, lmk, ring)
        torch.cuda.synchronize()
        for x, y, nm in zip(got, want, names):
            worst = max(worst, _max_abs_diff(x, y))
            if not _same_bits(x, y):
                raise AssertionError(f"nfa_bank_ring != plain: {name} {nm} "
                                     f"(max abs diff {worst})")
        tile = ring_geometry(P, ring).tile
        if name.startswith("tiled") and tile >= P:
            raise AssertionError(f"{name}: one tile of {tile} lanes")
        log(f"  nfa_bank_ring == plain  {name}: {CN} x {P}, ring {ring}, "
            f"{-(-P // tile)} tile(s) of {tile} lanes")
    del carries
    set_bank_launches(launches0)
    return len(RING_CASES), worst


def _step_split(fn, n=3):
    """ms of device time per call of fn by kernel (the bank step's two
    instances, the ring, the rest), from torch.profiler over n calls, each
    sum divided by the calls it recorded (it may drop the first); None
    when the profiler records no device time."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except Exception as e:   # noqa: BLE001 — measurement only
        log(f"  torch.profiler unavailable ({type(e).__name__}: {e})")
        return None
    names = {"thread_ms": "nfa_bank_thread_kernel",
             "group_ms": "nfa_bank_step_kernel",
             "ring_ms": "nfa_bank_ring_kernel"}
    split = dict.fromkeys(list(names) + ["other_ms"], 0.0)
    calls = dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if not us:
            continue
        key = next((k for k, nm in names.items() if is_kernel(ev.key, nm)),
                   "other_ms")
        split[key] += us / 1e3
        if key in calls:
            calls[key] += ev.count
    if not any(split.values()):
        return None
    rec = max(calls.values())
    split = {k: (v / (calls.get(k) or rec) if (calls.get(k) or rec)
                 else None) for k, v in split.items()}
    split["calls_recorded"] = rec
    return split


def time_bank(bank, block, dev, matchy, fresh, fresh4):
    """Median ms of each kernel's wrapper at the fleet shape: the bank
    step with its gate word on the steady-state carry and the next block
    of its stream, not in place (the kernel line's time); in place on a
    copy of that carry over the fresh blocks that continue its stream,
    one a launch (the fleet path), at
    T = 64 and at T = 4 (bench.py's latency shape); on the matchy bank's
    block; the ring on its outputs; the plain versions; torch.sort(stable=True) over the same
    counts (the ring's nearest library call); the device split by kernel;
    and the bounds (in place: what the first fresh block's launch
    needed)."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (bank_lanes_plain, bank_ring_plain,
                                          nfa_bank_lanes, nfa_bank_ring)
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carry = bank._stack_carry
    launches0 = bank_launches()

    def step(c=carry, b=block, **kw):
        return nfa_bank_lanes(spec, c, b, prm, kp, **kw)

    def timed(fn, n=TIMED_LAUNCHES):
        return median_ms(fn, dev, n=n, sleep_cycles=5 * SLEEP_CYCLES)
    new, cnt, lmt, lmk = step()
    mb = matchy[0]
    mspec, mkp, mprm = mb.nfa.spec, mb.nfa.kprog, mb._stack_params
    mcarry, mblock = mb._stack_carry, matchy[1]
    res = {"step_ms": timed(step)}
    P = int(block["__ts"].shape[0])
    work = {k: v.clone() for k, v in carry.items()}
    pre = {k: v.clone() for k, v in carry.items()}
    step(c=work, b=fresh[0], inplace=True)
    res["step_inplace_bound_ms"], _by = bank_inplace_bound(bank, pre, work,
                                                           fresh[0])
    del pre
    for name, blocks in (("step_inplace_ms", fresh[1:]),
                         ("step_t4_inplace_ms", fresh4)):
        it = iter(blocks)
        res[name] = timed(lambda: step(c=work, b=next(it), inplace=True),
                          n=len(blocks))
    del work
    res["step_matchy_ms"] = timed(lambda: nfa_bank_lanes(
        mspec, mcarry, mblock, mprm, mkp))
    res["step_t4_ms"] = timed(lambda: step(b=fresh4[0]))
    res["ring_ms"] = median_ms(lambda: nfa_bank_ring(new, cnt, lmt, lmk,
                                                     bank.ring), dev)
    # ring 0 (the totals alone): the staging and the tile's sum, max, min
    res["ring_totals_ms"] = median_ms(lambda: nfa_bank_ring(
        new, cnt, lmt, lmk, 0), dev)
    for name, out in (("matchy", nfa_bank_lanes(mspec, mcarry, mblock, mprm,
                                                mkp)),
                      ("t4", step(b=fresh4[0]))):
        res[f"ring_{name}_ms"] = median_ms(
            lambda: nfa_bank_ring(*out, bank.ring), dev)
        res[f"ring_{name}_max_count"] = int(out[1].max())
        del out
    res["ring_alert_max_count"] = int(cnt.max())
    res["ring_library_ms"] = median_ms(lambda: torch.sort(
        cnt, dim=1, descending=True, stable=True), dev)
    res["step_plain_ms"] = median_ms(lambda: bank_lanes_plain(
        spec, carry, block, prm), dev, n=3)
    res["ring_plain_ms"] = median_ms(lambda: bank_ring_plain(
        new, cnt, lmt, lmk, bank.ring), dev)
    res["split"] = _step_split(lambda: (step(), nfa_bank_ring(
        new, cnt, lmt, lmk, bank.ring)))
    res["split_matchy"] = _step_split(lambda: nfa_bank_lanes(
        mspec, mcarry, mblock, mprm, mkp))
    set_bank_launches(launches0)
    T = int(block["__ts"].shape[1])
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    res["step_bound_ms"], res["step_bound_by"] = bank_step_bound(bank, P, T)
    res["step_t4_bound_ms"], _by = bank_step_bound(bank, P, 4)
    res["ring_bound_ms"], res["ring_bound_by"] = bank_ring_bound(
        bank.n_patterns, P, bank.ring, R * C)
    return res


#: the host split: rounds of calls per part, each round enqueued while the
#: card sleeps (~20 ms at the H100's clock, longer than a round's enqueue)
SPLIT_ROUNDS = 10
SPLIT_CALLS = 20
SPLIT_SLEEP_CYCLES = 20 * SLEEP_CYCLES


def host_split(bank, block, dev):
    """Host time to enqueue one fleet ``process_block``, by part, in us a
    call (median over SPLIT_ROUNDS rounds of SPLIT_CALLS calls): the gate
    word and its ``where``; the bank step's wrapper and launch (the gate
    word included, in place, as the fleet path runs it); the ring's
    wrapper and launch; the fleet cell's packing of one block's ring
    (``run_fleet_cell``'s ``torch.cat`` into the read buffer); the whole
    ``process_block`` (with the bank's dispatch wrappers).  Each round is
    enqueued while the card sleeps, so no part waits on the device; an
    event recorded after each round must still be pending when the
    round's clock stops, or the split raises.  Moves the bank's carry."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (_VALID_BIT, kernel_gate_word,
                                          nfa_bank_lanes, nfa_bank_ring)
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carry = bank._stack_carry
    new, cnt, lmt, lmk = nfa_bank_lanes(spec, carry, block, prm, kp)
    counts, rcnt, rpid, rcaps, rts, rok = nfa_bank_ring(new, cnt, lmt, lmk,
                                                        bank.ring)
    buf = torch.zeros((2, bank.n_patterns, 1 + 4 * bank.ring + rcaps[0]
                       .numel()), dtype=torch.int32, device=dev)

    def gate():
        g = kernel_gate_word(spec, kp, block)
        return torch.where(block["__valid"], g | _VALID_BIT, g)

    def pack():
        buf[1] = torch.cat(
            [counts[:, None], rcnt, rpid, rts, rok.to(torch.int32),
             rcaps.view(torch.int32).reshape(bank.n_patterns, -1)], dim=1)
    parts = {
        "gate_word_and_where": gate,
        "step_wrapper_and_launch": lambda: nfa_bank_lanes(
            spec, carry, block, prm, kp, inplace=True),
        "ring_wrapper_and_launch": lambda: nfa_bank_ring(
            new, cnt, lmt, lmk, bank.ring),
        "ring_packing": pack,
        "process_block": lambda: bank.process_block(block)}
    out = {}
    for name, fn in parts.items():
        fn()                                  # warm
        torch.cuda.synchronize()
        us = []
        for _ in range(SPLIT_ROUNDS):
            torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(SPLIT_CALLS):
                fn()
            t1 = time.perf_counter()
            done = torch.cuda.Event()
            done.record()
            if done.query():
                raise AssertionError(f"host split: the card finished before "
                                     f"{name}'s round was enqueued")
            torch.cuda.synchronize()
            us.append((t1 - t0) / SPLIT_CALLS * 1e6)
        out[name] = float(np.median(us))
    out["step_without_gate_word"] = out["step_wrapper_and_launch"] - \
        out["gate_word_and_where"]
    out["bank_dispatch"] = out["process_block"] - \
        out["step_wrapper_and_launch"] - out["ring_wrapper_and_launch"]
    out["process_block_and_packing"] = out["process_block"] + \
        out["ring_packing"]
    del new, cnt, lmt, lmk, buf
    return out


def fleet_window(bank, staged, n_blocks, repeats):
    """A fleet cell's timed window over ``staged`` blocks 1..n_blocks (0
    is the warm-up, already run): each block through
    CompiledPatternBank.process_block, its ring packed into one buffer,
    then the one device-to-host read of every block's packed ring and
    decode_ring, as bench.py's throughput phase does.  The window runs
    ``repeats`` times without the profiler, each from the same carry and
    each equal to the first bit for bit (the launch counts from the
    first), then once under the profiler.  → {walls, host (the packed
    rings read), payloads (decoded), launches, peak (device memory of
    the first run), wall_p, per_kernel, dev_us (the profiled pass)}."""
    import torch
    spec = bank.nfa.spec
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    r = bank.ring
    N = bank.n_patterns
    W = 1 + 4 * r + r * R * C
    buf = torch.zeros((n_blocks, N, W), dtype=torch.int32,
                      device=staged[0]["__ts"].device)
    torch.cuda.synchronize()

    def drive():
        payloads = []
        start = time.perf_counter()
        for i in range(1, n_blocks + 1):
            counts, rcnt, rpid, rcaps, rts, rok = bank.process_block(
                staged[i])
            buf[i - 1] = torch.cat(
                [counts[:, None], rcnt, rpid, rts, rok.to(torch.int32),
                 rcaps.view(torch.int32).reshape(N, -1)], dim=1)
        host = buf.cpu().numpy()              # the one D2H, a barrier
        for b in range(n_blocks):
            h = host[b]
            payloads.append(bank.decode_ring(
                h[:, 1:1 + r], h[:, 1 + r:1 + 2 * r],
                h[:, 1 + 4 * r:].view(np.float32).reshape(N, r, R, C),
                h[:, 1 + 2 * r:1 + 3 * r], h[:, 1 + 3 * r:1 + 4 * r] != 0))
        return time.perf_counter() - start, host, payloads

    # the timed runs go without the profiler; each repeat and the
    # profiled pass replay the same blocks from the same carry (kept on
    # the host, so the cell's peak device memory holds no copy of it) and
    # must give the same bits
    assert bank.stacked
    pre = {k: v.cpu().pin_memory() for k, v in bank._stack_carry.items()}

    def replay(fn, what):
        for k, v in bank._stack_carry.items():
            v.copy_(pre[k])
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
        got = res[0] if isinstance(res[0], tuple) else res
        if not np.array_equal(got[1], host) or not all(
                _same_bits(bank._stack_carry[k], post[k]) for k in post):
            raise AssertionError(f"fleet cell: {what} over the same blocks "
                                 f"differs from the first timed run")
        return res
    set_bank_launches()                       # counts start here
    wall, host, payloads = drive()
    launches = bank_launches()
    peak = torch.cuda.max_memory_allocated()
    post = {k: v.clone() for k, v in bank._stack_carry.items()}
    walls = [wall] + [replay(drive, f"timed run {i + 2}")[0]
                      for i in range(repeats - 1)]
    (wall_p, _, _), per_kernel, dev_us = replay(
        lambda: profile_device(drive), "the profiled pass")
    del pre, post, buf
    return {"walls": walls, "host": host, "payloads": payloads,
            "launches": launches, "peak": peak, "wall_p": wall_p,
            "per_kernel": per_kernel, "dev_us": dev_us}


def run_fleet_cell(dev, seed, n_blocks):
    """The fleet cell: bench.py's headline bank (1000 patterns x 10,000
    partitions, K = 8, T = 64, chunks of 200 stacked, ring 32) through
    CompiledPatternBank.process_block over pre-staged device blocks; the
    timed window ends with the one device-to-host read of every block's
    packed ring and decode_ring, as bench.py's throughput phase does.  The
    timed window runs FLEET_REPEATS times without the profiler, each
    from the same carry and each equal to the first bit for bit (events/s
    from the median wall; the launch counts from the first); one more
    pass over the same blocks runs under the profiler for the device
    split, and the idle share is given against both walls."""
    import gc

    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    thrs = np.linspace(99.8, 99.997, N_BANK)
    t0 = time.perf_counter()
    bank = CompiledPatternBank([bank_app(t) for t in thrs],
                               n_partitions=BANK_P, n_slots=BANK_K,
                               pattern_chunk=BANK_CHUNK, ring=BANK_RING,
                               device=dev)
    bank.base_ts = BANK_BASE_TS
    torch.cuda.synchronize()
    carry_bytes = sum(v.numel() * v.element_size()
                      for v in bank._stack_carry.values())
    log(f"  bank built in {time.perf_counter() - t0:.3f} s: C={bank.n_chunks} "
        f"x {bank.chunk} patterns, stacked={bank.stacked}, carry "
        f"{carry_bytes} B; kernel class: {bank.nfa.kprog.reason or 'inside'}")
    t0 = time.perf_counter()
    # warm-up, the timed blocks, and one block checked against the plain
    # step after the timed run
    raw = bank_blocks(np.random.default_rng(seed + 7), n_blocks + 2)
    staged = [bank.nfa.to_device(b) for b in raw]
    torch.cuda.synchronize()
    log(f"  {n_blocks + 2} blocks made and staged in "
        f"{time.perf_counter() - t0:.3f} s")
    out0 = bank.process_block(staged[0])      # warm-up
    counts_total = out0[0].long().cpu().numpy()
    fw = fleet_window(bank, staged, n_blocks, FLEET_REPEATS)
    walls, host, payloads = fw["walls"], fw["host"], fw["payloads"]
    launches, peak_cell = fw["launches"], fw["peak"]
    wall_p, per_kernel, dev_us = fw["wall_p"], fw["per_kernel"], fw["dev_us"]
    wall = float(np.median(walls))
    counts_total += host[:, :, 0].astype(np.int64).sum(axis=0)
    n_events = n_blocks * BANK_P * BANK_T
    matches = int(host[:, :, 0].sum())
    n_payloads = sum(len(d["pattern"]) for d in payloads)
    log(f"  fleet cell: {N_BANK} patterns x {BANK_P} partitions, "
        f"{n_blocks} blocks of {BANK_P * BANK_T} events, timed "
        f"{FLEET_REPEATS} times from the same carry: median wall "
        f"{wall:.6f} s, min {min(walls):.6f} s, max {max(walls):.6f} s "
        f"(sum {sum(walls):.3f} s); every repeat's outputs and carry equal "
        f"to the first's")
    log(f"  events/s: {n_events / wall:.1f} (median; "
        f"{n_events / max(walls):.1f} to {n_events / min(walls):.1f}); ms "
        f"per block: {wall / n_blocks * 1e3:.3f}; matches {matches}, "
        f"payloads decoded {n_payloads} (shortfall {matches - n_payloads})")
    log(f"  profiled pass over the same blocks from the same carry: "
        f"{wall_p:.6f} s wall ({(wall_p / wall - 1) * 100:.3f}% above the "
        f"median timed run), outputs and carry equal to the timed run's")
    if per_kernel is not None:
        def kern_us(name):
            return sum(us for k, us in per_kernel.items()
                       if is_kernel(k, name))
        thread_us = kern_us("nfa_bank_thread_kernel")
        group_us = kern_us("nfa_bank_step_kernel")
        ring_us = kern_us("nfa_bank_ring_kernel")
        log(f"  nfa_bank_step device time: thread instance "
            f"{thread_us / 1e3:.3f} ms over {launches[1]} launches, group "
            f"instance {group_us / 1e3:.3f} ms over {launches[2]} launches; "
            f"nfa_bank_ring {ring_us / 1e3:.3f} ms over {launches[3]} "
            f"launches; all device time "
            f"{dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall_p * 100:.3f}% "
            f"of the profiled pass's wall (idle share "
            f"{100 - dev_us / 1e6 / wall_p * 100:.3f}%), "
            f"{dev_us / 1e6 / wall * 100:.3f}% of the median timed wall "
            f"(idle share {100 - dev_us / 1e6 / wall * 100:.3f}%)")
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        for k, us in top:
            log(f"    device {us / 1e3:10.3f} ms  {k[:90]}")
    else:
        log("  torch.profiler recorded no device time: idle share not "
            "measured")
    if launches[1] < n_blocks or launches[3] < n_blocks or \
            launches[4] or launches[5]:
        raise AssertionError(f"bank launches (step, thread instance, group "
                             f"instance, ring, widened instance) "
                             f"{launches}: expected >= {n_blocks} of the "
                             f"thread instance and the ring, none of the "
                             f"widened instance")
    # the kernels against the plain bank step, on the next block first
    n_cases, next_out, bank_err, matchy_bank, matchy_block = check_bank(
        dev, seed, bank, staged[n_blocks + 1])
    counts_total += next_out[0].long().cpu().numpy()
    if bank.total_dropped() != 0:
        raise AssertionError(f"fleet cell dropped {bank.total_dropped()} "
                             f"partials")
    peak = torch.cuda.max_memory_allocated()
    t_ref = time.perf_counter()
    want, price, kind = bank_reference(raw, thrs)
    if not np.array_equal(counts_total, want):
        bad = int(np.nonzero(counts_total != want)[0][0])
        raise AssertionError(f"fleet cell: pattern {bad} counted "
                             f"{counts_total[bad]}, reference {want[bad]}")
    rows = sum(check_ring_rows(d, price, kind, thrs) for d in payloads)
    log(f"  bank kernels == plain bank step on {n_cases} cases, max abs "
        f"diff over every output and carry leaf {bank_err}")
    log(f"  every pattern's count over {n_blocks + 2} blocks == the "
        f"reference ({int(want.sum())} matches); {rows} decoded ring rows "
        f"are reference matches; total_dropped() == 0 (reference "
        f"{time.perf_counter() - t_ref:.1f} s)")
    log(f"  max_memory_allocated: {peak_cell} B over the timed run "
        f"({peak_cell - mem0} B above the {mem0} B allocated before the "
        f"cell: the carry, the {n_blocks + 2} staged blocks, the outputs); "
        f"{peak} B with the checks' plain steps")
    # blocks continuing the stream after the cell's: T = 64, then T = 4
    del staged
    fresh = [bank.nfa.to_device(b) for b in bank_blocks(
        np.random.default_rng(seed + 12), TIMED_LAUNCHES + 1,
        first=n_blocks + 2)]
    fresh4 = [bank.nfa.to_device(b) for b in bank_blocks(
        np.random.default_rng(seed + 13), TIMED_LAUNCHES, T=4,
        first=(n_blocks + 3 + TIMED_LAUNCHES) * BANK_T // 4)]
    tb = time_bank(bank, fresh[0], dev, (matchy_bank, matchy_block), fresh,
                   fresh4)
    split_block = fresh[1]
    del matchy_bank, matchy_block, fresh, fresh4
    log(f"  nfa_bank_step at N={N_BANK} P={BANK_P} T={BANK_T} K={BANK_K} "
        f"(thread instance, a warp over 32 lanes of one pattern): "
        f"{tb['step_ms']:.4f} ms (plain {tb['step_plain_ms']:.4f} ms, bound "
        f"{tb['step_bound_ms']:.6f} ms by {tb['step_bound_by']}, "
        f"{tb['step_bound_ms'] / tb['step_ms'] * 100:.2f}% of the bound "
        f"reached); in place over fresh blocks {tb['step_inplace_ms']:.4f} "
        f"ms (in-place bound "
        f"{tb['step_inplace_bound_ms']:.6f} ms, "
        f"{tb['step_inplace_bound_ms'] / tb['step_inplace_ms'] * 100:.2f}%)")
    log(f"  nfa_bank_step on the matchy block (5..95, floor 0): "
        f"{tb['step_matchy_ms']:.4f} ms; split "
        f"{tb['split_matchy']}")
    log(f"  nfa_bank_step at T=4: {tb['step_t4_ms']:.4f} ms (bound "
        f"{tb['step_t4_bound_ms']:.6f} ms, "
        f"{tb['step_t4_bound_ms'] / tb['step_t4_ms'] * 100:.2f}% of it); in "
        f"place over fresh blocks {tb['step_t4_inplace_ms']:.4f} ms")
    log(f"  nfa_bank_ring at ring={BANK_RING}: {tb['ring_ms']:.4f} ms "
        f"(plain {tb['ring_plain_ms']:.4f} ms, torch.sort stable "
        f"{tb['ring_library_ms']:.4f} ms, bound {tb['ring_bound_ms']:.6f} "
        f"ms by {tb['ring_bound_by']})")
    log(f"  nfa_bank_ring on the matchy block: {tb['ring_matchy_ms']:.4f} "
        f"ms (max count {tb['ring_matchy_max_count']}); at T=4: "
        f"{tb['ring_t4_ms']:.4f} ms (max count {tb['ring_t4_max_count']}); "
        f"alert block max count {tb['ring_alert_max_count']}; ring 0 (the "
        f"totals: staging and the tile's sum, max, min) "
        f"{tb['ring_totals_ms']:.4f} ms; "
        f"{tb['ring_bound_ms'] / tb['ring_ms'] * 100:.2f}% of the bound "
        f"reached on the alert block")
    log(f"  device split per step + ring (profiler, ms): {tb['split']}")
    split = host_split(bank, split_block, dev)
    log(f"  host enqueue of one fleet process_block by part, us a call "
        f"(median of {SPLIT_ROUNDS} rounds of {SPLIT_CALLS}, the card "
        f"asleep throughout): " + ", ".join(
            f"{k} {v:.1f}" for k, v in split.items()))
    return {"host_split": split, "launches": launches, "wall": wall,
            "walls": walls,
            "cases": n_cases,
            "max_abs_err": bank_err,
            "events_per_s": n_events / wall, "peak": peak_cell - mem0, **tb}


# ------------------------------------------------------------------ phase 9

#: bench.py's latency phase (bench_lat): T_LAT_BLOCK events a lane a
#: block, LAT_BLOCKS per-block synchronous blocks, trains of PIPE_DEPTH
LAT_T = 4
LAT_BLOCKS = 200
LAT_TRAINS = 40
LAT_DEPTH = 8


def run_latency_cell(dev, seed, n_blocks=LAT_BLOCKS):
    """bench.py bench_lat on the port: the fleet cell's bank (1000
    patterns x 10,000 lanes, K = 8, ring 32, from an empty carry) fed
    blocks of T = 4 events a lane, continuing one stream.  Each of
    n_blocks blocks after a warm-up block is timed alone: its clock runs
    from process_block to the device-to-host read of its per-pattern
    counts; p50 and p99 over them.  Then the compute-only estimate:
    trains of 8 blocks ending in one read of the last block's counts, the
    per-block mean of each train, median and MAD over 40 trains.  Every
    block's counts (a train's after its clock stops) must equal the
    per-block numpy reference, and the bank kernels must have run."""
    import gc

    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    gc.collect()
    torch.cuda.empty_cache()
    thrs = np.linspace(99.8, 99.997, N_BANK)
    bank = CompiledPatternBank([bank_app(t) for t in thrs],
                               n_partitions=BANK_P, n_slots=BANK_K,
                               pattern_chunk=BANK_CHUNK, ring=BANK_RING,
                               device=dev)
    bank.base_ts = BANK_BASE_TS
    n_train = LAT_TRAINS * LAT_DEPTH
    t0 = time.perf_counter()
    raw = bank_blocks(np.random.default_rng(seed + 13),
                      1 + n_blocks + n_train, T=LAT_T)
    staged = [bank.nfa.to_device(b) for b in raw]
    torch.cuda.synchronize()
    want, _price, _kind = bank_block_reference(raw, thrs)
    log(f"  {len(raw)} blocks of T={LAT_T} ({BANK_P * LAT_T} events each) "
        f"made, staged and referenced in {time.perf_counter() - t0:.3f} s")
    got = np.zeros_like(want)
    got[0] = bank.process_block(staged[0])[0].cpu().numpy()   # warm-up
    set_bank_launches()                       # counts start here
    times = []
    for i in range(1, n_blocks + 1):
        t1 = time.perf_counter()
        counts = bank.process_block(staged[i])[0].cpu()   # reaches the host
        times.append(time.perf_counter() - t1)
        got[i] = counts.numpy()
    trains = []
    for tr in range(LAT_TRAINS):
        first = 1 + n_blocks + tr * LAT_DEPTH
        outs = []
        t1 = time.perf_counter()
        for i in range(first, first + LAT_DEPTH):
            outs.append(bank.process_block(staged[i])[0])
        outs[-1].cpu()                        # one closing barrier
        trains.append((time.perf_counter() - t1) / LAT_DEPTH)
        got[first:first + LAT_DEPTH] = torch.stack(outs).cpu().numpy()
    launches = bank_launches()
    n_run = n_blocks + n_train
    if launches[1] < n_run or launches[3] < n_run or launches[4] or \
            launches[5]:
        raise AssertionError(f"latency cell: bank launches (step, thread "
                             f"instance, group instance, ring, widened "
                             f"instance) {launches}, expected >= {n_run} of "
                             f"the thread instance and the ring, none of "
                             f"the widened instance")
    bad = np.nonzero((got != want).any(axis=1))[0]
    if len(bad):
        b = int(bad[0])
        n = int(np.nonzero(got[b] != want[b])[0][0])
        raise AssertionError(f"latency cell: block {b} pattern {n} counted "
                             f"{got[b, n]}, reference {want[b, n]}")
    if bank.total_dropped() != 0:
        raise AssertionError(f"latency cell dropped {bank.total_dropped()}")
    bt = np.asarray(times) * 1e3
    tm = np.asarray(trains) * 1e3
    med = float(np.median(tm))
    res = {"p50_ms": float(np.percentile(bt, 50)),
           "p99_ms": float(np.percentile(bt, 99)),
           "compute_only_median_ms": med,
           "compute_only_mad_ms": float(np.median(np.abs(tm - med))),
           "blocks": n_blocks, "trains": LAT_TRAINS, "depth": LAT_DEPTH,
           "matches": int(want.sum()), "launches": launches}
    log(f"  per-block synchronous, {n_blocks} blocks of T={LAT_T}: p50 "
        f"{res['p50_ms']:.4f} ms, p99 {res['p99_ms']:.4f} ms (max "
        f"{bt.max():.4f} ms); compute-only (trains of {LAT_DEPTH}, one read "
        f"each): median {med:.4f} ms, MAD {res['compute_only_mad_ms']:.4f} "
        f"ms over {LAT_TRAINS} trains")
    log(f"  every block's counts == the per-block reference ({len(raw)} "
        f"blocks, {res['matches']} matches); dropped 0; launches (step, "
        f"thread instance, group instance, ring) {launches}")
    return res


# ------------------------------------------------------------------ phase 10

#: BASELINE.json config 4 ("Kleene-closure pattern `A[3:10] -> B` with
#: per-partition counter state, 100k keys") as a partitioned app
COUNT_APP = """
@app:playback
define stream S (sym string, price float, kind int);
partition with (sym of S) begin
@info(name='q')
from every e1=S[kind == 0]<3:10> -> e2=S[kind == 1 and price > e1[last].price] within 10 sec
select e1[0].price as p0, e1[last].price as pl, e2.price as p2 insert into Out;
end;
"""
N_COUNT_KEYS = 100_000
COUNT_MIN, COUNT_MAX, COUNT_WITHIN_MS = 3, 10, 10_000
#: the count cell's stream: 100 events a ms (100,000 events/s), so each
#: of the 100,000 keys sees about an event a second and a chain of 3..10
#: A and a B fits in `within 10 sec` (1 ms apart, a key's events would be
#: 100 s apart and every chain would expire)
COUNT_EVENTS_PER_MS = 100
#: keys whose rows are held against the host engine
COUNT_HOST_KEYS = 1_000
#: the count cell's chunks held against SiddhiManager(device="cpu")
COUNT_CPU_CHUNKS = 4


def count_app(app_text=COUNT_APP) -> str:
    """The count cell's app: COUNT_APP with @app:lanes and the @Async
    input junction of the pattern cell."""
    return ("@app:name('count')\n"
            f"@app:lanes('{N_COUNT_KEYS}')\n" +
            app_text.replace(
                "define stream",
                f"@Async(buffer.size='64', batch.size.max='{CHUNK}')\n"
                "define stream", 1))


def make_count_chunks(seed: int, n_chunks: int, n_keys=N_COUNT_KEYS,
                      chunk=CHUNK):
    """The count cell's feed, the pattern cell's shape: per chunk
    (columns, timestamps, key index) with string keys drawn uniformly
    from n_keys, price uniform in [0, 100), kind uniform in {0, 1},
    COUNT_EVENTS_PER_MS events a ms from 1,000,000."""
    rng = np.random.default_rng(seed + 20)
    names = np.asarray([f"k{i:06d}" for i in range(n_keys)], object)
    out = []
    for c in range(n_chunks):
        ki = rng.integers(0, n_keys, chunk)
        out.append(({"sym": names[ki],
                     "price": rng.uniform(0, 100, chunk).astype(np.float32),
                     "kind": rng.integers(0, 2, chunk).astype(np.int32)},
                    PATTERN_BASE_TS + (c * chunk + np.arange(
                        chunk, dtype=np.int64)) // COUNT_EVENTS_PER_MS, ki))
    return out


def count_reference(chunks, lo=COUNT_MIN, hi=COUNT_MAX,
                    within_ms=COUNT_WITHIN_MS):
    """Independent reference of COUNT_APP, per key in Python: the key's
    first `kind == 0` event arms its one chain (a leading `every` count
    arms once a partition); each later `kind == 0` event appends until
    `lo` events, when the chain waits for B with the count forwarded; while
    it waits, a `kind == 0` event appends up to `hi` events (the last
    price moves), and the first `kind == 1` event with a price above the
    last appended price completes it — unless it comes more than `within`
    after the arm, which ends the chain.  → rows (ts, p0, pl, p2), one at
    most a key, sorted."""
    keys = np.concatenate([c[2] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks])
    kind = np.concatenate([c[0]["kind"] for c in chunks])
    ts = np.concatenate([c[1] for c in chunks])
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(keys.max() + 2))
    rows = []
    for k in range(len(bounds) - 1):
        idx = order[bounds[k]:bounds[k + 1]]
        n = t0 = first = last = None
        for t, p, kd in zip(ts[idx].tolist(), price[idx].tolist(),
                            kind[idx].tolist()):
            if n is None:                   # not armed yet
                if kd == 0:
                    n, t0, first, last = 1, t, p, p
                continue
            if n < lo:                      # accumulating: no `within`
                if kd == 0:
                    n, last = n + 1, p
                continue
            if t - t0 > within_ms:          # expired while waiting for B
                break
            if kd == 1 and p > last:
                rows.append((t, first, last, p))
                break
            if kd == 0 and n < hi:
                n, last = n + 1, p
    return sorted(rows)


def _rows_of(got, names=("p0", "pl", "p2")):
    """Collected (ts, p0, pl, p2) rows, sorted (float32 values)."""
    cols = {k: np.concatenate(v) if v else np.zeros(0)
            for k, v in got.items()}
    return sorted(zip(cols["ts"].astype(np.int64).tolist(),
                      *[cols[n].astype(np.float32).astype(float).tolist()
                        for n in names]))


def run_count_app(text, chunks, device, engine="device"):
    """One run of a count app through the public API on ``device``: →
    (rows sorted, the runtime's device query runtimes' dropped total or
    None on the host)."""
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    text = f"@app:engine('{engine}')\n" + text
    rt = SiddhiManager(device=device).create_siddhi_app_runtime(text)
    got = {"ts": [], "p0": [], "pl": [], "p2": []}

    def sink(chunk):
        got["ts"].append(np.array(chunk.timestamps))
        for k in ("p0", "pl", "p2"):
            got[k].append(np.array(chunk.columns[k]))
    rt.add_callback("Out", ColumnarStreamCallback(sink))
    rt.start()
    h = rt.get_input_handler("S")
    for cols, ts, _ki in chunks:
        h.send_batch(cols, timestamps=ts)
    rt.flush()
    pr = rt.partition_runtimes[0]
    dropped = None
    if pr.device_mode:
        dropped = sum(int(q.device_runtime.nfa.carry["dropped"].sum())
                      for q in pr.device_query_runtimes.values())
    rt.shutdown()
    return _rows_of(got), dropped


def run_count_path(chunks, dev):
    """Phase 10: BASELINE config 4 on the card through the public API —
    the count app over 100,000 string keys, the chunks through the @Async
    junction and the device engine (K2 + K4 with kleene count units): on
    the default dispatch (its main path: a cross-tenant bucket of one on
    K12), then with SIDDHI_TPU_XTENANT=0 (K2 + K4 per app).  Each run's
    events/s, ms per chunk, device split by exact kernel name, idle share
    and peak.  The two runs' rows must be equal, and equal, as multisets,
    the independent per-key reference, the same chunks through
    SiddhiManager(device="cpu") (the plain composition), and for the
    first COUNT_HOST_KEYS keys the port's host engine; nothing dropped.
    Returns {"packed": numbers, "per_app": numbers}."""
    n_chunks = len(chunks)
    n_events = sum(len(c[1]) for c in chunks)
    runs, rows = {}, {}
    for key, packed in (("packed", True), ("per_app", False)):
        r = drive_nfa_cell(dev, count_app(), chunks, ("p0", "pl", "p2"),
                           packed)
        rows[key] = _rows_of(r["got"])
        runs[key] = report_nfa_cell("count cell", r, n_events, n_chunks,
                                    packed)
        runs[key]["rows"] = len(rows[key])
    rows, other = rows["packed"], rows["per_app"]
    if rows != other:
        raise AssertionError(f"count cell: {len(rows)} packed rows != "
                             f"{len(other)} SIDDHI_TPU_XTENANT=0 rows")
    t1 = time.perf_counter()
    want = count_reference(chunks)
    if rows != want:
        raise AssertionError(f"count path: {len(rows)} rows, reference "
                             f"{len(want)} (or values differ)")
    log(f"  all {len(rows)} rows of both runs equal, and == the per-key "
        f"reference, as multisets and exactly "
        f"({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    # rows before the first event of the first chunk left out: completed
    # by the events of the chunks the CPU run takes
    h = min(COUNT_CPU_CHUNKS, n_chunks)
    end = int(chunks[h][1][0]) if h < n_chunks else None
    plain, _d = run_count_app(count_app(), chunks[:h], "cpu")
    if end is not None:
        plain = [r for r in plain if r[0] < end]
    head = [r for r in rows if end is None or r[0] < end]
    if plain != head:
        raise AssertionError(f"count path: {len(head)} rows of the first "
                             f"{h} chunks, the plain composition (CPU) "
                             f"{len(plain)}")
    log(f"  the first {h} chunks' {len(head)} rows == SiddhiManager("
        f"device='cpu') (plain step and compaction), as multisets "
        f"({time.perf_counter() - t1:.1f} s)")
    if h < n_chunks:
        log(f"CUT: the count cell's CPU comparison at its first {h} of "
            f"{n_chunks} chunks (the device runs and the reference keep "
            f"all {n_chunks})")
    t1 = time.perf_counter()
    few = []
    for cols, ts, ki in chunks:
        m = ki < COUNT_HOST_KEYS
        few.append(({k: v[m] for k, v in cols.items()}, ts[m], ki[m]))
    host, _d = run_count_app(COUNT_APP, few, dev, engine="host")
    first = set(f"k{i:06d}" for i in range(COUNT_HOST_KEYS))
    mine = sorted(r for r, key in zip(
        rows, _row_keys(rows, chunks)) if key in first)
    if host != mine:
        raise AssertionError(f"count path: the first {COUNT_HOST_KEYS} keys "
                             f"gave {len(mine)} rows, the host engine "
                             f"{len(host)}")
    log(f"  the first {COUNT_HOST_KEYS} keys' {len(host)} rows == the host "
        f"engine's, as multisets ({time.perf_counter() - t1:.1f} s)")
    return runs


def _row_keys(rows, chunks):
    """The key of each row: its e2 event's, the event at the row's ts
    with kind 1 and the row's price p2."""
    ts = np.concatenate([c[1] for c in chunks])
    syms = np.concatenate([c[0]["sym"] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks])
    kind = np.concatenate([c[0]["kind"] for c in chunks])
    out = []
    for r in rows:
        lo, hi = np.searchsorted(ts, [r[0], r[0] + 1])
        at = lo + np.nonzero((kind[lo:hi] == 1) &
                             (price[lo:hi] == np.float32(r[3])))[0]
        if len(at) != 1:
            raise AssertionError(f"count path: row {r} has {len(at)} "
                                 f"candidate e2 events")
        out.append(syms[at[0]])
    return out


# ------------------------------------------------------------------ phase 11

#: repeats of phase 11's timed window (phase 8's: FLEET_REPEATS)
ABSENT_REPEATS = 8


def check_absent_ring_rows(dec, price, kind, done, thrs, gap=BANK_GAP_MS,
                           wait_ms=ABSENT_WAIT_MS) -> int:
    """Every decoded ring row (pattern, partition, ts, p1, p2) of the
    absent bank is a match of the reference: ts is the completing event's
    (the JAX bank's rule: the triggering event, not the deadline), an arm
    of its lane with price p1 above the pattern's threshold completes
    there, and its e2 (the event the wait started at) has price p2."""
    lane = dec["partition"].astype(np.int64)
    j = (dec["ts"] - BANK_BASE_TS - lane * (gap // price.shape[0])) // gap
    p1 = dec["p1"].astype(np.float32)
    p2 = dec["p2"].astype(np.float32)
    thr = np.asarray(thrs, np.float32)[dec["pattern"]]
    jc = np.clip(j, 0, price.shape[1] - 1)
    ok = (j >= 0) & (j < price.shape[1]) & (p1 > thr)
    j2 = np.clip(jc - -(-wait_ms // gap), 0, None)
    ok &= (kind[lane, j2] == 1) & (price[lane, j2] == p2)
    arm = np.zeros(len(lane), bool)
    for d in range(1, BANK_WITHIN_MS // gap + 1):
        j1 = np.clip(j2 - d, 0, None)
        arm |= (j2 - d >= 0) & (done[lane, j1] == jc) & \
            (price[lane, j1] == p1)
    bad = ~(ok & arm)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise AssertionError(
            f"absent ring row is no match: pattern {dec['pattern'][i]} lane "
            f"{lane[i]} ts {dec['ts'][i]} p1 {p1[i]} p2 {p2[i]}")
    return len(lane)


def run_absent_fleet_cell(dev, seed, n_blocks):
    """Phase 11: BASELINE config 3 on the card — the fleet cell's bank
    (1000 patterns x 10,000 lanes, T = 64, K = 8, chunks of 200, ring 32,
    the alert thresholds, phase 8's blocks) with the trailing `not S[kind
    == 0 and price > e2.price] for 3 sec`, on the bank step's thread
    instance and the ring.  The window of phase 8 (fleet_window),
    ABSENT_REPEATS times; events/s, ms per block, the device split and
    the idle share.  Checks: every pattern's count per block equals the
    independent reference (absent_block_reference) over every pattern;
    one block in place equals the plain bank bit for bit; every decoded
    ring row is a reference match; total_dropped() == 0; the thread
    instance ran every launch.  Then the bank step timed (not in place,
    in place over fresh blocks) with its bounds."""
    import gc

    import torch
    from siddhi_tpu_torch.ops.nfa import bank_lanes_plain, nfa_bank_lanes
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    thrs = np.linspace(99.8, 99.997, N_BANK)
    t0 = time.perf_counter()
    bank = CompiledPatternBank([absent_bank_app(t) for t in thrs],
                               n_partitions=BANK_P, n_slots=BANK_K,
                               pattern_chunk=BANK_CHUNK, ring=BANK_RING,
                               device=dev)
    bank.base_ts = BANK_BASE_TS
    torch.cuda.synchronize()
    carry_bytes = sum(v.numel() * v.element_size()
                      for v in bank._stack_carry.values())
    log(f"  bank built in {time.perf_counter() - t0:.3f} s: C={bank.n_chunks} "
        f"x {bank.chunk} patterns, carry {carry_bytes} B (deadline leaf "
        f"{bank._stack_carry['deadline'].numel() * 4} B); kernel class: "
        f"{bank.nfa.kprog.reason or 'inside'}")
    raw = bank_blocks(np.random.default_rng(seed + 7), n_blocks + 2)
    staged = [bank.nfa.to_device(b) for b in raw]
    out0 = bank.process_block(staged[0])      # warm-up
    per_block = [out0[0].long().cpu().numpy()]
    fw = fleet_window(bank, staged, n_blocks, ABSENT_REPEATS)
    host, launches = fw["host"], fw["launches"]
    walls = fw["walls"]
    wall = float(np.median(walls))
    per_block += [host[b, :, 0].astype(np.int64) for b in range(n_blocks)]
    n_events = n_blocks * BANK_P * BANK_T
    n_payloads = sum(len(d["pattern"]) for d in fw["payloads"])
    res = {"wall": wall, "walls": walls, "events_per_s": n_events / wall,
           "ms_per_block": wall / n_blocks * 1e3, "launches": launches,
           "peak": fw["peak"] - mem0, "repeats": ABSENT_REPEATS}
    log(f"  absent fleet cell: {N_BANK} patterns x {BANK_P} partitions, "
        f"{n_blocks} blocks of {BANK_P * BANK_T} events, timed "
        f"{ABSENT_REPEATS} times from the same carry: median wall "
        f"{wall:.6f} s (min {min(walls):.6f}, max {max(walls):.6f})")
    log(f"  events/s: {n_events / wall:.1f} (median; "
        f"{n_events / max(walls):.1f} to {n_events / min(walls):.1f}); ms "
        f"per block: {res['ms_per_block']:.3f}; matches "
        f"{int(host[:, :, 0].sum())}, payloads decoded {n_payloads}")
    per_kernel, dev_us, wall_p = fw["per_kernel"], fw["dev_us"], fw["wall_p"]
    if per_kernel is not None:
        def kern_us(name):
            return sum(us for k, us in per_kernel.items()
                       if is_kernel(k, name))
        res.update(thread_ms=kern_us("nfa_bank_thread_kernel") / 1e3,
                   ring_ms_total=kern_us("nfa_bank_ring_kernel") / 1e3,
                   device_ms=dev_us / 1e3,
                   idle_share=100 - dev_us / 1e6 / wall * 100,
                   idle_share_profiled=100 - dev_us / 1e6 / wall_p * 100)
        log(f"  nfa_bank_step device time: thread instance "
            f"{res['thread_ms']:.3f} ms over {launches[1]} launches, group "
            f"instance over {launches[2]}; nfa_bank_ring "
            f"{res['ring_ms_total']:.3f} ms over {launches[3]}; all device "
            f"time {dev_us / 1e3:.3f} ms (idle share "
            f"{res['idle_share_profiled']:.3f}% of the profiled pass's wall "
            f"{wall_p:.6f} s, {res['idle_share']:.3f}% of the median timed "
            f"wall)")
    else:
        log("  torch.profiler recorded no device time: idle share not "
            "measured")
    if launches[1] < n_blocks or launches[2] or launches[3] < n_blocks or \
            launches[4] or launches[5]:
        raise AssertionError(f"absent bank launches (step, thread instance, "
                             f"group instance, ring, widened instance) "
                             f"{launches}: expected >= {n_blocks} of the "
                             f"thread instance and the ring, none of the "
                             f"group or widened instance")
    # one block in place against the plain bank
    pre = _snapshot(bank)
    got = bank.process_block(staged[n_blocks + 1])
    new_p, want = _bank_plain(bank, pre, staged[n_blocks + 1])
    torch.cuda.synchronize()
    res["max_abs_err"] = _bank_outputs_equal(
        "absent bank (in place)", got, want, _carry(bank), new_p)
    per_block.append(got[0].long().cpu().numpy())
    del pre, new_p, want
    if bank.total_dropped() != 0:
        raise AssertionError(f"absent fleet cell dropped "
                             f"{bank.total_dropped()}")
    t1 = time.perf_counter()
    ref, price, kind, done = absent_block_reference(raw, thrs)
    got_counts = np.stack(per_block)
    if not np.array_equal(got_counts, ref):
        b, n = (int(x[0]) for x in np.nonzero(got_counts != ref))
        raise AssertionError(f"absent fleet cell: block {b} pattern {n} "
                             f"counted {got_counts[b, n]}, reference "
                             f"{ref[b, n]}")
    rows = sum(check_absent_ring_rows(d, price, kind, done, thrs)
               for d in fw["payloads"])
    log(f"  every pattern's count in each of {n_blocks + 2} blocks == the "
        f"reference ({int(ref.sum())} matches); the next block in place == "
        f"the plain bank bit for bit (max abs diff {res['max_abs_err']}); "
        f"{rows} decoded ring rows are reference matches; dropped 0 "
        f"(reference {time.perf_counter() - t1:.1f} s)")
    # the bank step alone: not in place on the steady carry, in place over
    # fresh blocks, and the bounds
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carry = bank._stack_carry
    fresh = [bank.nfa.to_device(b) for b in bank_blocks(
        np.random.default_rng(seed + 12), TIMED_LAUNCHES + 1,
        first=n_blocks + 2)]
    launches0 = bank_launches()
    res["step_ms"] = median_ms(lambda: nfa_bank_lanes(
        spec, carry, fresh[0], prm, kp), dev, sleep_cycles=5 * SLEEP_CYCLES)
    work = {k: v.clone() for k, v in carry.items()}
    pre = {k: v.clone() for k, v in carry.items()}
    nfa_bank_lanes(spec, work, fresh[0], prm, kp, inplace=True)
    res["step_inplace_bound_ms"], _by = bank_inplace_bound(bank, pre, work,
                                                           fresh[0])
    del pre
    it = iter(fresh[1:])
    res["step_inplace_ms"] = median_ms(lambda: nfa_bank_lanes(
        spec, work, next(it), prm, kp, inplace=True), dev,
        n=TIMED_LAUNCHES, sleep_cycles=5 * SLEEP_CYCLES)
    del work
    res["step_plain_ms"] = median_ms(lambda: bank_lanes_plain(
        spec, carry, fresh[0], prm), dev, n=1)
    set_bank_launches(launches0)
    res["step_bound_ms"], res["step_bound_by"] = bank_step_bound(
        bank, BANK_P, BANK_T)
    log(f"  nfa_bank_step (thread instance, absent units) at N={N_BANK} "
        f"P={BANK_P} T={BANK_T} K={BANK_K}: {res['step_ms']:.4f} ms (plain "
        f"{res['step_plain_ms']:.4f} ms, bound {res['step_bound_ms']:.6f} ms "
        f"by {res['step_bound_by']}, "
        f"{res['step_bound_ms'] / res['step_ms'] * 100:.2f}% of the bound); "
        f"in place over fresh blocks {res['step_inplace_ms']:.4f} ms "
        f"(in-place bound {res['step_inplace_bound_ms']:.6f} ms)")
    del fresh, staged, bank
    res["count_bank"] = run_count_bank(dev, seed)
    res["ratio_bank"] = run_ratio_bank(dev, seed)
    res["wide_banks"] = run_wide_banks(dev, seed)
    res["max_abs_err"] = max(res["max_abs_err"],
                             res["count_bank"]["max_abs_err"],
                             res["ratio_bank"]["max_abs_err"],
                             *(v["max_abs_err"]
                               for v in res["wide_banks"].values()))
    return res


#: phase 11's full-width widened banks: patterns, blocks driven, of them
#: the first held against the plain bank step
WIDE_FLEET_N = 100
WIDE_FLEET_BLOCKS = 8
WIDE_FLEET_CHECKED = 2


def wide_fleet_banks():
    """{name: (WIDE_BANK_APPS kind or None for phase 8's app, thresholds)}:
    the SEQUENCE bank and the logical bank over the matchy band, phase 8's
    alert bank (bench.py's app, the alert band) with telemetry."""
    matchy = np.linspace(5.0, 95.0, WIDE_FLEET_N)
    return {"sequence": ("sequence", matchy),
            "logical": ("logical or", matchy),
            "telemetry alert": (None,
                                np.linspace(99.8, 99.997, WIDE_FLEET_N))}


def run_wide_banks(dev, seed):
    """The bank step's widened thread instance at full width: each of
    wide_fleet_banks' banks, WIDE_FLEET_N patterns x 10,000 lanes, T =
    64, K = 8, ring 32, chunks of 20 stacked, over WIDE_FLEET_BLOCKS
    blocks of the feed's kinds 0..2 (phase 8's lanes and gaps), in place
    through process_block: the launch counters set to 0 just before and
    read just after (the widened thread instance and the ring every
    block, no other instance), the first WIDE_FLEET_CHECKED blocks bit
    for bit against the plain bank step (every carry leaf, counts and
    the ring).  Then the step alone (nfa_bank_lanes, not in place, L2
    flushed) on the next block of the stream beside its bound
    (bank_step_bound), the plain version's time and the widened group
    instance's (the parent's instance, forced) on the same block; for
    the telemetry alert bank also phase 8's
    bank without telemetry (the thread instance) over the same blocks and
    its step on the same next block, and the ratio of the two.  → {name:
    {ms, plain_ms, bound_ms, bound_by, launches, group_ms, max_abs_err,
    matches, ...}}."""
    import gc

    import torch
    from siddhi_tpu_torch.ops import nfa as ops
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    out = {}
    for name, (kind, thrs) in wide_fleet_banks().items():
        gc.collect()
        torch.cuda.empty_cache()
        kw = dict(n_partitions=BANK_P, n_slots=BANK_K, pattern_chunk=20,
                  ring=BANK_RING, device=dev)
        if kind is None:
            apps = [bank_app(t) for t in thrs]
            bank = CompiledPatternBank(apps, telemetry=True, **kw)
        else:
            bank = wide_bank(kind, thrs, **kw)
        spec, kp = bank.nfa.spec, bank.nfa.kprog
        if not ops.kernel_wide(spec, kp):
            raise AssertionError(f"{name} bank is no widened program")
        raws = bank_blocks(np.random.default_rng(seed + 70),
                           WIDE_FLEET_BLOCKS + 1, kinds=3)
        staged = [bank.nfa.to_device(b) for b in raws]
        worst, matches = 0.0, 0
        set_bank_launches()                   # counts start here
        t0 = time.perf_counter()
        for i, blk in enumerate(staged[:WIDE_FLEET_BLOCKS]):
            pre = _snapshot(bank) if i < WIDE_FLEET_CHECKED else None
            got = bank.process_block(blk)
            if pre is not None:
                new_p, want = _bank_plain(bank, pre, blk)
                torch.cuda.synchronize()
                worst = max(worst, _bank_outputs_equal(
                    f"{name} bank block {i}", got, want, _carry(bank),
                    new_p))
                del pre, new_p, want
            matches += int(got[0].sum())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bank_launches()
        nb = WIDE_FLEET_BLOCKS
        if launches[5] != nb or launches[3] != nb or launches[1] or \
                launches[2] or launches[4]:
            raise AssertionError(f"{name} bank launches (step, thread, "
                                 f"group, ring, widened group, widened "
                                 f"thread) {launches}: expected the "
                                 f"widened thread instance and the ring "
                                 f"every block, nothing else")
        if not matches:
            raise AssertionError(f"{name} bank matched nothing")
        if spec.telemetry and not int(_carry(bank)["telem"].sum()):
            raise AssertionError(f"{name} bank: telemetry counted nothing")
        carry, prm = bank._stack_carry, bank._stack_params
        nxt = staged[WIDE_FLEET_BLOCKS]
        launches0 = bank_launches()
        res = {"launches": launches[5], "ring_launches": launches[3],
               "max_abs_err": worst, "matches": matches,
               "dropped": bank.total_dropped(),
               "ms_per_block": wall / nb * 1e3,
               "ms": median_ms(lambda: ops.nfa_bank_lanes(
                   spec, carry, nxt, prm, kp), dev,
                   sleep_cycles=5 * SLEEP_CYCLES),
               "plain_ms": median_ms(lambda: ops.bank_lanes_plain(
                   spec, carry, nxt, prm), dev, n=1),
               "library_ms": None}
        with forced_wide_group():
            res["group_ms"] = median_ms(lambda: ops.nfa_bank_lanes(
                spec, carry, nxt, prm, kp), dev,
                sleep_cycles=5 * SLEEP_CYCLES)
        res["speedup_over_group"] = res["group_ms"] / res["ms"]
        res["bound_ms"], res["bound_by"] = bank_step_bound(bank, BANK_P,
                                                           BANK_T)
        if kind is None:
            # phase 8's bank (the thread instance) over the same blocks
            del bank, carry
            gc.collect()
            torch.cuda.empty_cache()
            tb = CompiledPatternBank(apps, **kw)
            for blk in staged[:WIDE_FLEET_BLOCKS]:
                tb.process_block(blk)
            tspec, tkp = tb.nfa.spec, tb.nfa.kprog
            tcarry, tprm = tb._stack_carry, tb._stack_params
            res["thread_ms"] = median_ms(lambda: ops.nfa_bank_lanes(
                tspec, tcarry, nxt, tprm, tkp), dev,
                sleep_cycles=5 * SLEEP_CYCLES)
            res["thread_bound_ms"], _by = bank_step_bound(tb, BANK_P,
                                                          BANK_T)
            res["ratio_to_thread"] = res["ms"] / res["thread_ms"]
            del tb, tcarry
        set_bank_launches(launches0)
        out[name] = res
        log(f"  {name} bank (widened thread instance): {WIDE_FLEET_N} "
            f"patterns x "
            f"{BANK_P} lanes, T={BANK_T} K={BANK_K}, {nb} blocks in place "
            f"({res['ms_per_block']:.3f} ms a block with the ring and the "
            f"first {WIDE_FLEET_CHECKED} blocks' plain checks), "
            f"{matches} matches, dropped {res['dropped']}, the first "
            f"{WIDE_FLEET_CHECKED} == the plain bank bit for bit; step "
            f"{res['ms']:.4f} ms (plain {res['plain_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.6f} ms by {res['bound_by']}, "
            f"{res['bound_ms'] / res['ms'] * 100:.2f}% of the bound; the "
            f"widened group instance "
            f"{res['group_ms']:.4f} ms on the same block, "
            f"{res['speedup_over_group']:.2f}x)"
            + (f"; phase 8's bank without telemetry (thread instance) "
               f"{res['thread_ms']:.4f} ms on the same block, ratio "
               f"{res['ratio_to_thread']:.2f}" if kind is None else ""))
        del staged
    return out


#: phase 11's count bank: config 4's pattern as a bank of this many
#: patterns over the fleet's lanes, for this many blocks
COUNT_BANK_N = 100
COUNT_BANK_BLOCKS = 3


def _bank_cell(name, apps, n_blocks, block_seed, dev, drops=False):
    """A bank of `apps` (kleene counts or a condition program) over the
    fleet's 10,000 lanes (20 patterns a chunk, ring 32), on the bank
    step's thread instance: every block in place against the plain bank
    bit for bit (drops included), the thread instance's launch counter
    rising every block and the group instance's flat, a match, and no
    dropped partial unless `drops`.  Then the step alone
    (``nfa_bank_lanes``): not in place on the cell's carry and the next
    block of its stream, and in place over fresh blocks that continue it
    (TIMED_LAUNCHES, one a launch), each beside its bound (bank_step_
    bound; bank_inplace_bound of the first fresh block's launch); the
    same two on the group instance (the parent design's figure: the
    instance forced as tools/bank_probe.py forces it); the plain version
    on one block.  → {ms a block (step and ring), the step's times and
    bounds, max_abs_err, launches, matches, dropped}."""
    import torch
    from siddhi_tpu_torch.ops import nfa as ops
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    bank = CompiledPatternBank(apps, n_partitions=BANK_P, n_slots=BANK_K,
                               pattern_chunk=20, ring=BANK_RING, device=dev)
    blocks = [bank.nfa.to_device(b) for b in bank_blocks(
        np.random.default_rng(block_seed), n_blocks, gap=1_000)]
    set_bank_launches()                       # counts start here
    worst, matches, times = 0.0, 0, []
    for blk in blocks:
        pre = _snapshot(bank)
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        got = bank.process_block(blk)
        s1.record()
        new_p, want = _bank_plain(bank, pre, blk)
        torch.cuda.synchronize()
        times.append(s0.elapsed_time(s1))
        worst = max(worst, _bank_outputs_equal(
            f"{name} (thread instance)", got, want, _carry(bank), new_p))
        matches += int(want[0].sum())
        del pre, new_p, want
    launches = bank_launches()
    if launches[1] < len(blocks) or launches[2] or launches[4] or \
            launches[5]:
        raise AssertionError(f"{name} launches (step, thread instance, "
                             f"group instance, ring, widened instance) "
                             f"{launches}: expected the thread instance "
                             f"every block")
    dropped = bank.total_dropped()
    if not matches or (dropped and not drops):
        raise AssertionError(f"{name}: {matches} matches, dropped {dropped}")
    res = {"ms_per_block": float(np.median(times)), "max_abs_err": worst,
           "launches": launches, "matches": matches, "dropped": dropped}
    log(f"  {name} ({len(apps)} patterns x {BANK_P} lanes, thread "
        f"instance): {len(blocks)} blocks in place == the plain bank bit "
        f"for bit, {matches} matches, dropped {dropped}; "
        f"{res['ms_per_block']:.3f} ms a block (step and ring, median)")
    # the step alone, each instance: not in place on the cell's carry and
    # the next block, in place over fresh blocks from a copy of the carry
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carry = bank._stack_carry
    fresh = [bank.nfa.to_device(b) for b in bank_blocks(
        np.random.default_rng(block_seed + 1), TIMED_LAUNCHES + 1,
        gap=1_000, first=n_blocks)]
    launches0 = bank_launches()
    geometry = ops.bank_geometry

    def step_times():
        out = {"ms": median_ms(lambda: ops.nfa_bank_lanes(
            spec, carry, fresh[0], prm, kp), dev,
            sleep_cycles=5 * SLEEP_CYCLES)}
        work = {k: v.clone() for k, v in carry.items()}
        it = iter(fresh[1:])
        out["inplace_ms"] = median_ms(lambda: ops.nfa_bank_lanes(
            spec, work, next(it), prm, kp, inplace=True), dev,
            n=TIMED_LAUNCHES, sleep_cycles=5 * SLEEP_CYCLES)
        return out
    try:
        thread = step_times()
        ops.bank_geometry = lambda *a, **k: ops.BankGeometry("group", 0, 0)
        group = step_times()
    finally:
        ops.bank_geometry = geometry
    work = {k: v.clone() for k, v in carry.items()}
    pre = {k: v.clone() for k, v in carry.items()}
    ops.nfa_bank_lanes(spec, work, fresh[1], prm, kp, inplace=True)
    res["step_inplace_bound_ms"], _by = bank_inplace_bound(bank, pre, work,
                                                           fresh[1])
    del work, pre
    res["step_plain_ms"] = median_ms(lambda: ops.bank_lanes_plain(
        spec, carry, fresh[0], prm), dev, n=1)
    used = bank_launches()
    set_bank_launches(launches0)
    if used[1] == launches0[1] or used[2] == launches0[2]:
        raise AssertionError(f"{name}: the timed steps did not run both "
                             f"instances")
    res["step_bound_ms"], res["step_bound_by"] = bank_step_bound(
        bank, BANK_P, BANK_T)
    res.update(step_ms=thread["ms"], step_inplace_ms=thread["inplace_ms"],
               group_step_ms=group["ms"],
               group_step_inplace_ms=group["inplace_ms"])
    log(f"  {name}: nfa_bank_step at N={len(apps)} P={BANK_P} T={BANK_T} "
        f"K={BANK_K}: thread instance {res['step_ms']:.4f} ms (group "
        f"instance {res['group_step_ms']:.4f} ms, plain "
        f"{res['step_plain_ms']:.4f} ms, bound {res['step_bound_ms']:.6f} "
        f"ms by {res['step_bound_by']}); in place over fresh blocks "
        f"{res['step_inplace_ms']:.4f} ms (group instance "
        f"{res['group_step_inplace_ms']:.4f} ms, in-place bound "
        f"{res['step_inplace_bound_ms']:.6f} ms)")
    return res


def count_bank_apps(n=COUNT_BANK_N):
    """Config 4's kleene count as a bank: n patterns `every e1=S[kind ==
    0 and price > thr]<3:10> -> e2=S[kind == 1 and price > e1[last].price]
    within 10 sec`, thresholds 0 to 99."""
    return [_S3 + f"from every e1=S[kind == 0 and price > {t}]<3:10> -> "
            "e2=S[kind == 1 and price > e1[last].price] within 10 sec "
            "select e1[0].price as p0, e1[last].price as pl, e2.price as "
            "p2 insert into Out;" for t in np.linspace(0.0, 99.0, n)]


def run_count_bank(dev, seed):
    """Config 4's count bank (count_bank_apps, COUNT_BANK_N patterns) on
    the thread instance (_bank_cell)."""
    return _bank_cell("count bank (config 4)", count_bank_apps(),
                      COUNT_BANK_BLOCKS, seed + 50, dev)


#: phase 11's ratio bank: the README's Quick start (`price > e1.price *
#: ratio`, a condition program reading a pattern constant) as a bank of
#: this many patterns over the fleet's lanes, for this many blocks
RATIO_BANK_N = 100
RATIO_BANK_BLOCKS = 8


def ratio_bank_app(thr, ratio) -> str:
    """The Quick start's spike rule on the fleet's stream: arm above
    `thr`, close on a price `ratio` times the armed one."""
    return (_S3 + f"from every e1=S[kind == 0 and price > {thr}] -> "
            f"e2=S[kind == 1 and price > e1.price * {ratio}] within 10 sec "
            "select e1.price as p1, e2.price as p2 insert into Out;")


def ratio_bank_apps(n=RATIO_BANK_N):
    """The Quick start as a bank of n patterns, thresholds 5 to 95,
    ratios 1.00 to 1.10."""
    return [ratio_bank_app(round(float(t), 3), round(float(r), 4))
            for t, r in zip(np.linspace(5.0, 95.0, n),
                            np.linspace(1.0, 1.1, n))]


def run_ratio_bank(dev, seed):
    """The Quick start's ratio bank (ratio_bank_apps) on the thread
    instance of the build variant with condition programs (_bank_cell;
    its K = 8 ring may drop)."""
    return _bank_cell("ratio bank (the Quick start, a condition "
                      "program)", ratio_bank_apps(), RATIO_BANK_BLOCKS,
                      seed + 60, dev, drops=True)


# ------------------------------------------------------------------ phase 12

#: phase 12's K7 cases: kernel == plain twin bit for bit on every output
#: plane and carry leaf, over chained blocks.  kind "length" (K7a; W = 0 is
#: the running mode) or "time" (K7b; W is the ring's capacity, ms its
#: window); T of each block; fill: accepted events run through both first
#: (a partly filled carry); grow: the group slabs widened to this G before
#: the last block (new gids up to it); dens: accepted share per block;
#: gids "skew": half the events in group 0; ts "jitter": out of order
#: the P = 1 cases' T (the plain twin is a Python loop over events, 2-3
#: ms an event at G = 1,024 on the card; cut from 4,096 to keep the
#: script within its time limit) and the one-chain case's
GAGG_PLAIN_T = 1024
GAGG_CHAIN_T = 2048
GAGG_CASES = [
    # the grouped cell's shape, T cut for the plain twin (a Python loop)
    dict(kind="length", P=1, W=1000, G=1024, VF=1, VI=0,
         T=(GAGG_PLAIN_T, GAGG_PLAIN_T // 2), minmax=True, inplace=True),
    # the keyed cell's shape: 1,024 lanes, G = 4, T >= W after the fill
    dict(kind="length", P=1024, W=1000, G=4, VF=1, VI=0, T=(1024, 512),
         minmax=True, inplace=True),
    dict(kind="length", P=16, W=8, G=3, VF=2, VI=2, T=(64, 40),
         minmax=True, forever=True),                        # T >= W
    dict(kind="length", P=7, W=5, G=1, VF=1, VI=1, T=(32, 32),
         minmax=True),                      # every eviction its own group
    dict(kind="length", P=9, W=6, G=4, VF=2, VI=1, T=(48, 48), grow=16,
         minmax=True, forever=True),                   # group growth
    dict(kind="length", P=33, W=16, G=5, VF=2, VI=0, T=(64, 64),
         minmax=True, forever=True, feed="nonfinite"),  # +-inf, NaN, -0.0
    dict(kind="length", P=12, W=4, G=3, VF=1, VI=2, T=(40, 40),
         minmax=True, feed="int_edges"),               # ints near 2^31
    dict(kind="length", P=64, W=1000, G=8, VF=1, VI=1, T=(300, 300),
         fill=507, minmax=True),                       # partly filled
    dict(kind="length", P=64, W=0, G=6, VF=2, VI=2, T=(64, 64),
         minmax=True, forever=True),                   # running mode
    dict(kind="length", P=64, W=0, G=6, VF=1, VI=1, T=(64, 64),
         forever=True, feed="nonfinite"),
    dict(kind="length", P=20, W=10, G=4, VF=1, VI=1, T=(32, 32),
         numguard=True, feed="int_edges"),             # numguard on
    dict(kind="length", P=1024, W=32, G=4, VF=1, VI=0, T=(64, 1),
         dens=(0.6, 0.0), minmax=True, inplace=True),  # all rejected
    dict(kind="length", P=3, W=40000, G=2, VF=2, VI=1, T=(64, 64),
         minmax=True),                                 # ring above smem
    # K7b: the time cell's shape, T cut for the plain twin
    dict(kind="time", P=1, W=1024, ms=1000, G=1024, VF=1, VI=1,
         T=(GAGG_PLAIN_T, GAGG_PLAIN_T // 2)),
    dict(kind="time", P=16, W=8, ms=6, G=3, VF=2, VI=2, T=(64, 40),
         forever=True),
    dict(kind="time", P=8, W=8, ms=1000, G=3, VF=1, VI=1,
         T=(32, 32)),                                  # ring overflow
    dict(kind="time", P=33, W=16, ms=12, G=5, VF=2, VI=1, T=(64, 64),
         forever=True, feed="nonfinite"),
    dict(kind="time", P=12, W=4, ms=5, G=2, VF=1, VI=2, T=(40, 40),
         feed="int_edges"),
    dict(kind="time", P=1024, W=64, ms=40, G=4, VF=1, VI=1, T=(128, 64),
         fill=37, grow=8, forever=True),               # partly filled
    dict(kind="time", P=2, W=32768, ms=100000, G=2, VF=1, VI=1,
         T=(300, 1), dens=(1.0, 0.0)),                 # ring above smem
    dict(kind="time", P=5, W=1, ms=3, G=2, VF=1, VI=1, T=(16, 16)),
    # group lists short and long in one lane (half the events in group
    # 0): the list walk and the pass over the ring side by side
    dict(kind="length", P=8, W=256, G=64, VF=2, VI=1, T=(512, 300),
         minmax=True, forever=True, feed="nonfinite", gids="skew"),
    dict(kind="time", P=8, W=256, ms=200, G=64, VF=2, VI=2, T=(512, 300),
         forever=True, feed="nonfinite", gids="skew"),
    # timestamps out of order within a lane
    dict(kind="time", P=16, W=64, ms=30, G=40, VF=1, VI=1, T=(128, 128),
         feed="nonfinite", ts="jitter"),
    # one group holds the lane: the walk's one chain of T events and as
    # many evictions, every range the warp's
    dict(kind="length", P=1, W=1000, G=1, VF=1, VI=1,
         T=(GAGG_CHAIN_T, GAGG_CHAIN_T), minmax=True, forever=True,
         inplace=True),
    dict(kind="time", P=1, W=1024, ms=1000, G=1, VF=1, VI=1,
         T=(GAGG_PLAIN_T,), forever=True),
    # T not a multiple of the passes' tile (256 events), and below one
    dict(kind="length", P=5, W=300, G=16, VF=2, VI=1, T=(1000, 777),
         minmax=True, forever=True),
    dict(kind="time", P=5, W=512, ms=300, G=16, VF=1, VI=2, T=(1000, 777),
         forever=True, gids="skew"),
    dict(kind="length", P=9, W=50, G=4, VF=1, VI=1, T=(100, 37),
         minmax=True),
    # in place, the ring wider than a tile: evictions of carry entries
    # and of the block's own cross tile boundaries
    dict(kind="length", P=3, W=600, G=8, VF=1, VI=1, T=(700, 900),
         fill=450, minmax=True, inplace=True, feed="nonfinite"),
    # count matrices over split_tile's budget: the tile doubles to 512,
    # so a CTA walks two blocks of 256 items (events, and the carry's
    # entries) and carries its ranks and group counts across them
    dict(kind="length", P=256, W=300, G=16384, VF=1, VI=1, T=(400, 512),
         fill=280, minmax=True, forever=True, inplace=True),
    dict(kind="time", P=256, W=512, ms=200, G=16384, VF=1, VI=1,
         T=(400, 512), fill=280, forever=True),
]


def _gagg_feed(rng, case, T, dens, t0):
    """One block of the case: (vals_f, vals_i, gids, ts, accepted) numpy
    planes, ts 0-3 ms apart from t0 (time cases)."""
    P, G, VF, VI = case["P"], case["G"], case["VF"], case["VI"]
    vf = rng.uniform(-100, 100, (P, T, VF)).astype(np.float32)
    vi = rng.integers(-5000, 5000, (P, T, VI)).astype(np.int32)
    feed = case.get("feed", "uniform")
    if feed == "nonfinite":
        r = rng.random((P, T, VF))
        vf[r < 0.05] = np.inf
        vf[(r >= 0.05) & (r < 0.1)] = -np.inf
        vf[(r >= 0.1) & (r < 0.13)] = np.nan
        vf[(r >= 0.13) & (r < 0.25)] = -0.0
        vf[(r >= 0.25) & (r < 0.35)] = 0.0
    if feed == "int_edges":
        r = rng.random((P, T, VI))
        vi[r < 0.3] = (1 << 31) - 1
        vi[r > 0.7] = -((1 << 31) - 1)
    gids = rng.integers(0, G, (P, T)).astype(np.int32)
    if case.get("gids") == "skew":
        gids[rng.random((P, T)) < 0.5] = 0
    ts = (t0 + np.cumsum(rng.integers(0, 4, (P, T)), axis=1)).astype(
        np.int32)
    if case.get("ts") == "jitter":
        ts = (ts + rng.integers(0, 20, (P, T))).astype(np.int32)
    ok = rng.random((P, T)) < dens
    return vf, vi, gids, ts, ok


def _nan_equal(a, b) -> bool:
    """Bit equality, every NaN equal to every NaN (payloads are not part
    of the contract: the card's arithmetic makes its own)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb) and
                    (a.view(torch.int32)[~na] ==
                     b.view(torch.int32)[~nb]).all())
    return bool(torch.equal(a, b))


def _gagg_grow(carry, G2, dev):
    """The group slabs widened to G2, as plan/gagg_compiler._grow_groups
    does (fresh sentinel slabs appended on the group axis)."""
    import torch
    from siddhi_tpu_torch.ops import grouped_agg as ga
    P, W = carry.ring_gid.shape
    VF, VI = carry.ring_f.shape[2], carry.ring_i.shape[2]
    G = carry.fmin_f.shape[1]
    time = isinstance(carry, ga.GroupedTimeCarry)
    pad = (ga.make_grouped_time_carry if time else ga.make_grouped_carry)(
        P, W, G2 - G, VF, VI, dev)
    fields = ("fmin_f", "fmax_f", "fmin_i", "fmax_i")
    if not time:
        fields += ("fsum_hi", "fsum_lo", "isum_hi", "isum_lo", "gcnt")
    return carry._replace(**{
        f: torch.cat([getattr(carry, f), getattr(pad, f)], dim=1)
        .contiguous() for f in fields})


def _gagg_steps(case, G):
    """(kernel step, plain step, carry maker) of a case at G groups."""
    from siddhi_tpu_torch.ops import grouped_agg as ga
    if case["kind"] == "time":
        args = (case["ms"], case["W"], case.get("forever", False))
        return (ga.grouped_time_step(*args), ga.grouped_time_step_plain(*args),
                lambda dev: ga.make_grouped_time_carry(
                    case["P"], case["W"], G, case["VF"], case["VI"], dev))
    args = (case["W"], case.get("minmax", False), case.get("forever", False),
            case.get("numguard", False))
    return (ga.grouped_step(*args, inplace=case.get("inplace", False)),
            ga.grouped_step_plain(*args),
            lambda dev: ga.make_grouped_carry(
                case["P"], case["W"], G, case["VF"], case["VI"], dev))


def check_gagg(dev, seed):
    """K7a and K7b against their plain twins on the card, bit for bit on
    every output plane and every carry leaf (NaN payloads aside), over
    the chained blocks of GAGG_CASES.  Returns {kind: {"cases": n,
    "max_abs_err": x}} for kind "length" (K7a) and "time" (K7b)."""
    import torch
    from siddhi_tpu_torch.ops import grouped_agg as ga
    rng = np.random.default_rng(seed + 12)
    res = {k: {"cases": 0, "max_abs_err": 0.0} for k in ("length", "time")}
    n0 = (ga.grouped_step.launches, ga.grouped_time_step.launches)
    for ci, case in enumerate(GAGG_CASES):
        G = case["G"]
        kstep, pstep, make = _gagg_steps(case, G)
        ck = make(dev)
        cp = make(dev)
        dens = case.get("dens", (0.7,) * len(case["T"]))
        blocks = list(zip(case["T"], dens))
        if case.get("fill"):
            blocks.insert(0, (case["fill"], 1.0))
        t0 = 0
        for bi, (T, d) in enumerate(blocks):
            if case.get("grow") and bi == len(blocks) - 1:
                G = case["grow"]
                ck, cp = _gagg_grow(ck, G, dev), _gagg_grow(cp, G, dev)
                kstep, pstep, _ = _gagg_steps(case, G)
                case = dict(case, G=G)
            vf, vi, gids, ts, ok = _gagg_feed(rng, case, T, d, t0)
            t0 = int(ts.max()) + 1
            ev = [torch.tensor(a, device=dev) for a in (vf, vi, gids)]
            okt = torch.tensor(ok, device=dev)
            if case["kind"] == "time":
                tst = torch.tensor(ts, device=dev)
                old, pre = ck, [a.clone() for a in ck]
                ck, ok_ = kstep(ck, *ev, tst, okt)
                cp, op_ = pstep(cp, *ev, tst, okt)
                if not all(_nan_equal(a, b) for a, b in zip(old, pre)):
                    raise AssertionError(
                        f"K7b changed its input carry in case {ci}")
            else:
                old = ck
                pre = (None if case.get("inplace") else
                       [a.clone() for a in old])
                ck, ok_ = kstep(ck, *ev, okt)
                cp, op_ = pstep(cp, *ev, okt)
                if pre is not None and not all(
                        _nan_equal(a, b) for a, b in zip(old, pre)):
                    raise AssertionError(
                        f"K7a changed its input carry in case {ci}")
            torch.cuda.synchronize()
            kres = res[case["kind"]]
            for x, y in list(zip(ok_, op_)) + list(zip(ck, cp)):
                kres["max_abs_err"] = max(
                    kres["max_abs_err"], _abs_err(x, y) if x.numel() else 0.0)
                if not _nan_equal(x, y):
                    raise AssertionError(
                        f"K7 {case['kind']} kernel != plain in case {ci} "
                        f"({case}), block {bi} (T={T}, density {d})")
        res[case["kind"]]["cases"] += 1
        log(f"  K7 {case['kind']:6s} == plain  case {ci}: P={case['P']} "
            f"W={case['W']} G={G} VF={case['VF']} VI={case['VI']} T="
            f"{'/'.join(str(b[0]) for b in blocks)} "
            f"feed={case.get('feed', 'uniform')}"
            + (f" overflow lanes {int(ck.overflow.sum())}"
               if case["kind"] == "time" else ""))
    launched = (ga.grouped_step.launches - n0[0],
                ga.grouped_time_step.launches - n0[1])
    ga.grouped_step.launches, ga.grouped_time_step.launches = n0
    if min(launched) == 0:
        raise AssertionError(f"K7 checks launched {launched} kernels")
    return res


def _gagg_launches():
    from siddhi_tpu_torch.ops import grouped_agg as ga
    return ga.grouped_step.launches, ga.grouped_time_step.launches


def _set_gagg_launches(v=(0, 0)):
    from siddhi_tpu_torch.ops import grouped_agg as ga
    ga.grouped_step.launches, ga.grouped_time_step.launches = v


def gagg_bound(P, T, W, G, VF, VI, accepted, minmax, time_window):
    """(bound ms, "bytes" or "operations") of one K7 launch: each input
    byte read once (values, gids, accepted flags, ts; the carry) and each
    output byte written once (the 13 planes; the carry), against the
    operations these events need: a two-float add (10 float ops) for the
    arriving and for the leaving entry of each float lane, 4 int ops for
    each int lane, and with min/max an incremental extremum's amortized
    compares for each of min and max (a monotonic deque)."""
    ev_in = 4 * VF + 4 * VI + 4 + 1 + (4 if time_window else 0)
    ev_out = 4 * (6 * VF + 6 * VI) + 4
    ring = W * (4 * VF + 4 * VI + 4 + (4 if time_window else 0))
    groups = G * (4 * (2 * VF + 2 * VI) if time_window else
                  4 * (4 * VF + 4 * VI + 1))
    nbytes = P * T * (ev_in + ev_out) + 2 * P * (ring + groups + 12)
    ops = accepted * (20 * VF + 4 * VI +
                      (2 * EXTREMUM_COMPARES * (VF + VI) if minmax else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


#: phase 12's timed shapes: the three cells' steps (kind, P, T, W, G, VF,
#: VI, window ms); T_PLAIN is the cut T the plain twin (a Python loop over
#: events) is timed at, the kernel timed there too
GAGG_TIMED = {
    "grouped_cell": ("length", 1, CHUNK, WINDOW, N_KEYS, 1, 0, 0),
    "keyed_cell": ("length", N_KEYS, 512, WINDOW, 8, 1, 0, 0),
    "time_cell": ("time", 1, CHUNK, 1024, N_KEYS, 1, 1, 1000),
}
T_PLAIN = GAGG_PLAIN_T
#: the walk's serial floor at the grouped cell's shape: one group holding
#: the lane, and half the events in group 0 ((shape), gids feed)
GAGG_FLOORS = {
    "one_chain": (("length", 1, CHUNK, WINDOW, 1, 1, 0, 0), "uniform"),
    "skew": (("length", 1, CHUNK, WINDOW, N_KEYS, 1, 0, 0), "skew"),
}
#: the step's kernels (csrc/grouped_agg.cu), in launch order; K7a and K7b
#: share them
GAGG_PASSES = ("gagg_count_kernel", "gagg_scan_groups_kernel",
               "gagg_scan_lane_kernel", "gagg_scatter_kernel",
               "gagg_walk_kernel", "gagg_windows_kernel", "gagg_ring_kernel")
#: the spans between gagg_time_passes' events
GAGG_SPANS = ("count", "scan", "scatter", "walk", "windows", "ring")


def gagg_split(step, args, dev, n=3, sleep_cycles=SLEEP_CYCLES):
    """Median device ms of each pass of one K7 step (GAGG_SPANS), from
    CUDA events the C entry records between its launches
    (gagg_time_passes), the L2 flushed before each run."""
    import ctypes

    import torch
    from siddhi_tpu_torch.ops import grouped_agg as ga
    lib = ga.load_kernel("grouped_agg")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    for ev in evs:                           # created on first record
        ev.record()
    handles = (ctypes.c_void_p * 7)(*[ev.cuda_event for ev in evs])
    runs = []
    lib.gagg_time_passes(handles, 7)
    try:
        for _ in range(n):
            flush.zero_()
            torch.cuda._sleep(sleep_cycles)
            step(*args)
            torch.cuda.synchronize()
            runs.append([evs[k].elapsed_time(evs[k + 1]) for k in range(6)])
    finally:
        lib.gagg_time_passes(None, 0)
    return dict(zip(GAGG_SPANS, (float(x) for x in np.median(runs, 0))))


def time_gagg(dev, seed, sleep_cycles=SLEEP_CYCLES):
    """K7a and K7b timed with CUDA events at each cell's shape (median
    of runs, L2 flushed; a carry in steady state: a full window first)
    and split by pass, the plain twin at the keyed cell's full shape and
    at T = T_PLAIN for the unkeyed ones (the kernel timed there too), each
    launch's bound; then K7a at GAGG_FLOORS' lanes (the walk's floor).
    Returns {cell or floor: dict}."""
    import torch
    rng = np.random.default_rng(seed + 13)
    res = {}
    n0 = _gagg_launches()
    shapes = [(name, shape, "uniform", True)
              for name, shape in GAGG_TIMED.items()]
    shapes += [(name, shape, gids, False)
               for name, (shape, gids) in GAGG_FLOORS.items()]
    for name, (kind, P, T, W, G, VF, VI, ms), gids, plain in shapes:
        case = dict(kind=kind, P=P, W=W, G=G, VF=VF, VI=VI, ms=ms,
                    minmax=True, inplace=(kind == "length"), gids=gids)
        kstep, pstep, make = _gagg_steps(case, G)

        def feed(t, t0):
            vf, vi, g, ts, ok = _gagg_feed(rng, case, t, 0.75, t0)
            ts = (t0 + np.arange(t, dtype=np.int32))[None, :].repeat(P, 0)
            args = [torch.tensor(a, device=dev) for a in (vf, vi, g)]
            if kind == "time":
                args.append(torch.tensor(ts, device=dev))
            return args + [torch.tensor(ok, device=dev)], int(ok.sum())

        carry = make(dev)
        warm, _ = feed(max(W, 1) + 7, 0)
        carry, _ = kstep(carry, *warm)
        args, acc = feed(T, W + 7)
        runs = 3 if T > 4096 else TIMED_LAUNCHES
        # K7a updates in place (the cell's donated carry): each timed
        # launch steps the same carry on; K7b writes a fresh one
        ms_k = median_ms(lambda: kstep(carry, *args), dev, n=runs,
                         sleep_cycles=sleep_cycles)
        split = gagg_split(kstep, [carry] + args, dev,
                           sleep_cycles=sleep_cycles)
        bound, by = gagg_bound(P, T, W, G, VF, VI, acc, True,
                               kind == "time")
        res[name] = {"kind": kind, "ms": ms_k, "bound_ms": bound,
                     "bound_by": by, "split": split, "gids": gids,
                     "shape": {"P": P, "T": T, "W": W, "G": G, "VF": VF,
                               "VI": VI, "window_ms": ms}}
        line = (f"  K7{'b' if kind == 'time' else 'a'} {name} P={P} T={T} "
                f"W={W} G={G} gids={gids}: {ms_k:.4f} ms (median of {runs}; "
                f"{ms_k / T * 1e3:.6f} us an event a lane)")
        if plain:
            cut, _ = feed(min(T, T_PLAIN), W + 7)
            ms_cut = median_ms(lambda: kstep(carry, *cut), dev, n=runs,
                               sleep_cycles=sleep_cycles)
            plain_args = args if T <= T_PLAIN else cut
            ms_plain = median_ms(lambda: pstep(carry, *plain_args), dev,
                                 n=1, sleep_cycles=sleep_cycles)
            res[name].update(ms_at_plain_T=ms_cut, plain_ms=ms_plain,
                             plain_T=min(T, T_PLAIN))
            line += (f", at T={min(T, T_PLAIN)} {ms_cut:.4f} ms vs plain "
                     f"{ms_plain:.4f} ms")
        log(line + f"; bound {bound:.6f} ms by {by}")
        log("    passes (ms): " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in split.items()))
    _set_gagg_launches(n0)                # timing launches are not a path
    return res


# ------------------------------------------------------------------ phase 13

#: queries of the grouped cells (phase 13 unkeyed, phase 14 keyed): config
#: 2's threshold ladder, the first GAGG_QUERIES of it (config 2 has 100)
GAGG_QUERIES = 4
GAGG_CHUNKS = 4


def gagg_app(n_queries, keyed):
    """BASELINE config 2's queries as Siddhi writes a group-by without a
    partition block (keyed=False: one global length(1000) window, groups
    by sym), or inside `partition with (sym of S)` grouped by sym, kind
    (keyed=True: a window per key, groups per (key, kind))."""
    group = "sym, kind" if keyed else "sym"
    qs = "\n".join(
        f"@info(name='q{i}')\n"
        f"from S[price > {0.5 * i}]#window.length({WINDOW})\n"
        f"select sym, sum(price) as s, count() as n, avg(price) as a, "
        f"min(price) as lo, max(price) as hi\n"
        f"group by {group} insert into Out_{i};"
        for i in range(n_queries))
    if keyed:
        qs = f"partition with (sym of S) begin\n{qs}\nend;"
    return (f"@app:name('{'keyed' if keyed else 'grouped'}')\n"
            f"@app:playback\n@app:lanes('{N_KEYS}')\n"
            f"@Async(buffer.size='64', batch.size.max='{CHUNK}')\n"
            f"define stream S (sym string, price float, kind int);\n{qs}\n")


def _range_extreme(x, start, end, fn):
    """fn over x[start[i] .. end[i]] (inclusive) for every i, by a sparse
    table (levels up to the longest range)."""
    n = len(x)
    if n == 0:
        return x.copy()
    L = end - start + 1
    levels = [x]
    while (1 << len(levels)) <= int(L.max()):
        prev, h = levels[-1], 1 << (len(levels) - 1)
        nxt = prev.copy()
        nxt[:n - h] = fn(prev[:n - h], prev[h:])
        levels.append(nxt)
    k = np.floor(np.log2(L)).astype(np.int64)
    out = np.empty(n, x.dtype)
    for lv in range(len(levels)):
        m = k == lv
        if m.any():
            out[m] = fn(levels[lv][start[m]],
                        levels[lv][end[m] - (1 << lv) + 1])
    return out


def window_group_reference(wkey, gkey, x, window):
    """float64 reference of a grouped length window, per event in arrival
    order: the window is the last `window` events of the event's window
    partition (wkey), the aggregate its events of the same group (gkey).
    Returns (sum, count, min, max)."""
    n = len(x)
    order_w = np.argsort(wkey, kind="stable")
    pos_w = np.empty(n, np.int64)
    wk_sorted = wkey[order_w]
    first = np.searchsorted(wk_sorted, wk_sorted, side="left")
    pos_w[order_w] = np.arange(n) - first
    order = np.lexsort((np.arange(n), gkey))       # by group, then arrival
    g_sorted = gkey[order].astype(np.int64)
    key = g_sorted * (1 << 32) + pos_w[order]
    start = np.searchsorted(key, key - window + 1, side="left")
    xs = x[order].astype(np.float64)
    c = np.concatenate([[0.0], np.cumsum(xs)])
    idx = np.arange(n)
    s = np.empty(n)
    cnt = np.empty(n, np.int64)
    lo = np.empty(n, np.float32)
    hi = np.empty(n, np.float32)
    s[order] = c[idx + 1] - c[start]
    cnt[order] = idx + 1 - start
    lo[order] = _range_extreme(x[order], start, idx, np.minimum)
    hi[order] = _range_extreme(x[order], start, idx, np.maximum)
    return s, cnt, lo, hi


def check_gagg_rows(name, got, chunks, threshold, keyed, names):
    """A grouped cell's rows (arrival order) against the float64
    reference: keys, counts, min and max exact; sum and avg rel <= 1e-5."""
    ki = np.concatenate([c[2] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks])
    kind = np.concatenate([c[0]["kind"] for c in chunks])
    acc = price > np.float32(threshold)
    ki, price, kind = ki[acc], price[acc], kind[acc]
    wkey = ki if keyed else np.zeros_like(ki)
    gkey = ki * 4 + kind if keyed else ki
    s, cnt, lo, hi = window_group_reference(wkey, gkey, price, WINDOW)
    cols = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
    if keyed:
        # partitions emit per block in lane order: compare keyed by ts
        order = np.argsort(cols["ts"], kind="stable")
        cols = {k: v[order] for k, v in cols.items()}
        ts = np.concatenate([c[1] for c in chunks])[acc]
        if not (cols["ts"] == ts).all():
            raise AssertionError(f"{name}: row timestamps differ")
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
    log(f"  {name}: {len(cnt)} rows == float64 reference (keys, counts, "
        f"min/max exact; sum/avg rel <= 1e-5)")


def _drive_cell(rt, stream, chunks, launches_of, reset=None):
    """Send every chunk through the public API, flush, synchronize, under
    torch.profiler: (wall s, per-kernel device us, device us, ledger
    stage seconds of the run, launches in the run).  The launch counts
    are set to 0 just before (``reset``, default K7's) and read just
    after."""
    import torch
    from siddhi_tpu_torch.core.ledger import ledger
    h = rt.get_input_handler(stream)

    def drive():
        t = time.perf_counter()
        for cols, ts in chunks:
            h.send_batch(cols, timestamps=ts)
        rt.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    stage0 = dict(ledger().snapshot()["stage_seconds"])
    (reset or _set_gagg_launches)()       # counts start here
    wall, per_kernel, dev_us = profile_device(drive)
    launches = launches_of()
    stage1 = ledger().snapshot()["stage_seconds"]
    stages = {k: stage1[k] - stage0.get(k, 0.0) for k in stage1}
    return wall, per_kernel, dev_us, stages, launches


def _cell_report(name, n_events, n_chunks, wall, per_kernel, dev_us, stages,
                 launches, kernels):
    res = {"wall": wall, "events_per_s": n_events / wall,
           "ms_per_chunk": wall / n_chunks * 1e3, "launches": launches,
           "dispatch_s": stages.get("dispatch"),
           "device_s": stages.get("device"), "decode_s": stages.get("decode"),
           "stages": stages}
    log(f"  {name}: {n_events} events ({n_chunks} chunks), {wall:.3f} s "
        f"wall; events/s {res['events_per_s']:.1f}; ms per chunk "
        f"{res['ms_per_chunk']:.3f}; launches {launches}")
    log("  host stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    if per_kernel is not None:
        k_us = {kn: sum(us for k, us in per_kernel.items()
                        if is_kernel(k, kn)) for kn in kernels}
        res.update(device_ms=dev_us / 1e3,
                   idle_share=100 - dev_us / 1e6 / wall * 100,
                   kernel_ms={kn: us / 1e3 for kn, us in k_us.items()})
        log(f"  device time {dev_us / 1e3:.3f} ms = "
            f"{dev_us / 1e6 / wall * 100:.3f}% of wall (idle share "
            f"{res['idle_share']:.3f}%); " + ", ".join(
                f"{kn} {us / 1e3:.3f} ms" for kn, us in k_us.items()))
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        for k, us in top:
            log(f"    device {us / 1e3:10.3f} ms  {k[:90]}")
    else:
        log("  torch.profiler recorded no device time: device share not "
            "measured")
    return res


def _device_queries(rt, runtime, partitioned):
    if partitioned:
        pr = rt.partition_runtimes[0]
        if not pr.device_mode:
            raise AssertionError(f"partition fell back to host: "
                                 f"{pr.fallback_reason}")
        qrs = pr.device_query_runtimes
    else:
        qrs = rt.query_runtimes
    for qname, qr in qrs.items():
        if qr.backend != "device" or \
                type(qr.device_runtime).__name__ != runtime:
            raise AssertionError(f"{qname}: backend {qr.backend}, "
                                 f"{type(qr.device_runtime).__name__} "
                                 f"({qr.backend_reason}), not {runtime}")
    return qrs


def run_gagg_cell(names, chunks, dev, n_queries, keyed):
    """Phase 13 (keyed=False) and 14 (keyed=True): config 2's queries on
    the grouped-aggregation runtime through the public API; every query
    on DeviceGroupedAggRuntime, K7a launched; the first and last query's
    rows against the float64 reference."""
    import gc

    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
        gagg_app(n_queries, keyed))
    log(f"  app built in {time.perf_counter() - t0:.3f} s")
    qrs = _device_queries(rt, "DeviceGroupedAggRuntime", keyed)
    keep = {0, n_queries - 1}
    kept = {i: [] for i in keep}

    def sink(i):
        def fn(chunk):
            kept[i].append({k: np.array(chunk.columns[k])
                            for k in ("sym", "s", "n", "a", "lo", "hi")}
                           | {"ts": np.array(chunk.timestamps)})
        return fn

    for i in keep:
        rt.add_callback(f"Out_{i}", ColumnarStreamCallback(sink(i)))
    rt.start()
    feed = [(cols, ts) for cols, ts, _ki in chunks]
    wall, per_kernel, dev_us, stages, launches = _drive_cell(
        rt, "S", feed, _gagg_launches)
    cga = next(iter(qrs.values())).device_runtime.cga
    lanes, groups = cga.n_lanes, cga.n_groups
    rt.shutdown()
    name = "keyed cell" if keyed else "grouped cell"
    res = _cell_report(name, len(chunks) * CHUNK, len(chunks),
                       wall, per_kernel, dev_us, stages, launches,
                       list(GAGG_PASSES))
    res.update(lanes=lanes, groups=groups, queries=n_queries,
               query_events_per_s=res["events_per_s"] * n_queries,
               peak=torch.cuda.max_memory_allocated() - mem0)
    log(f"  {n_queries} queries (every query sees every event): "
        f"query-events/s {res['query_events_per_s']:.1f}; P = {lanes} "
        f"lanes, G = {groups} group slots a lane; peak {res['peak']} B "
        f"above the {mem0} B allocated before the cell")
    if launches[0] < n_queries * len(chunks):
        raise AssertionError(f"K7a launched {launches[0]} times, expected "
                             f">= {n_queries * len(chunks)}")
    for i in sorted(keep):
        check_gagg_rows(f"{name} Out_{i}", kept[i], chunks, 0.5 * i, keyed,
                        names)
    return res


# ------------------------------------------------------------------ phase 15

TIME_APP = f"""
@app:name('timecell')
@app:playback
@app:pipeline('2')
define stream T (sym string, price float, vol long);
@info(name='t')
from T#window.time(1 sec)
select sym, sum(price) as t, sum(vol) as sv, count() as n
group by sym having t > 20.0 order by t desc insert into TOut;
"""
TIME_CHUNKS = 4


def make_time_chunks(chunks, seed):
    """The time cell's stream T: phase 3's keys, prices and 1 ms spaced
    timestamps, with a long volume in [0, 10^6) made from the seed."""
    rng = np.random.default_rng(seed + 15)
    return [({"sym": cols["sym"], "price": cols["price"],
              "vol": rng.integers(0, 1_000_000, CHUNK).astype(np.int64)},
             ts, ki) for cols, ts, ki in chunks]


def time_reference(tchunks):
    """Per chunk, the time cell's rows in emission order: every event's
    group in the window (ts - 1000, ts] (float64 price sum, exact int64
    vol sum, count), kept where t > 20.0, ordered by t descending as the
    selection does it (a stable ascending sort, reversed)."""
    ki = np.concatenate([c[2] for c in tchunks])
    ts = np.concatenate([c[1] for c in tchunks])
    price = np.concatenate([c[0]["price"] for c in tchunks]).astype(
        np.float64)
    vol = np.concatenate([c[0]["vol"] for c in tchunks])
    n = len(ki)
    order = np.lexsort((np.arange(n), ki))
    ks, tss = ki[order], ts[order]
    start = np.searchsorted(ks.astype(np.int64) * (1 << 40) + tss,
                            ks.astype(np.int64) * (1 << 40) + tss - 999,
                            side="left")
    idx = np.arange(n)
    L = idx - start + 1
    t = np.zeros(n)
    sv = np.zeros(n, np.int64)
    ps, vs = price[order], vol[order]
    for d in range(int(L.max())):           # windows hold a few events
        m = d < L
        t[m] += ps[idx[m] - d]
        sv[m] += vs[idx[m] - d]
    T_ = np.empty(n)
    SV = np.empty(n, np.int64)
    N = np.empty(n, np.int64)
    T_[order], SV[order], N[order] = t, sv, L
    out = []
    off = 0
    for cols, _ts, _ki in tchunks:
        m = len(_ts)
        tc, keep = T_[off:off + m], T_[off:off + m] > 20.0
        perm = np.argsort(tc, kind="stable")[::-1]
        perm = perm[keep[perm]]
        out.append((perm + off, tc[perm], SV[off:off + m][perm],
                    N[off:off + m][perm]))
        off += m
    return out


def time_select(cga, n, dev):
    """K8 (ops/select.py, torch ops) alone at the time cell's shape: the
    cell's own compiled selection over 13 planes of one lane and n rows
    (sums and counts from a seeded generator, three quarters of the rows
    accepted), median ms of TIMED_LAUNCHES runs, L2 flushed; its bound:
    the rows' 13 plane values and gather vectors read once, the
    permutation, meta and gathered rows written once (the sorts' compares,
    a few per row and pass, bound nothing at 67 TFLOP/s)."""
    import torch
    from siddhi_tpu_torch.ops.select import build_select_step
    VF, VI = cga._n_float, cga._n_int
    g = torch.Generator(device=dev).manual_seed(15)

    def f(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 100.0

    def i(*shape):
        return torch.randint(0, 1000, shape, generator=g, device=dev,
                             dtype=torch.int32)
    planes = (f(1, n, VF), f(1, n, VF) * 1e-9, i(1, n, VI), i(1, n, VI),
              i(1, n), f(1, n, VF), f(1, n, VF), i(1, n, VI), i(1, n, VI),
              f(1, n, VF), f(1, n, VF), i(1, n, VI), i(1, n, VI))
    lanes = torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    okm = torch.rand(n, generator=g, device=dev) < 0.75
    step = build_select_step(cga.selection)
    ms = median_ms(lambda: step(*planes, lanes, rows, okm), dev)
    row_bytes = (6 * VF + 6 * VI + 1) * 4
    nbytes = n * (row_bytes + 4 + 4 + 1) + n * (4 + row_bytes) + 8
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"  K8 selection step alone at n = {n} rows (VF={VF}, VI={VI}): "
        f"{ms:.4f} ms (median of {TIMED_LAUNCHES}; bound {bound:.6f} ms "
        f"by bytes)")
    return {"ms": ms, "bound_ms": bound, "bound_by": "bytes", "rows": n}


def run_time_cell(names, tchunks, dev):
    """Phase 15: the time window with a selection tail and an exact long
    sum through the public API: DeviceGroupedAggRuntime with the
    selection on the device; K7b launched (the ring grows from 64 by
    rewind-and-replay); rows against time_reference."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(TIME_APP)
    qrs = _device_queries(rt, "DeviceGroupedAggRuntime", False)
    route = qrs["t"].selection_route
    if not route or route.get("backend") != "device":
        raise AssertionError(f"time cell: selection route {route}")
    got = []
    rt.add_callback("TOut", ColumnarStreamCallback(
        lambda c: got.append({k: np.array(c.columns[k])
                              for k in ("sym", "t", "sv", "n")} |
                             {"ts": np.array(c.timestamps)})))
    rt.start()
    feed = [(cols, ts) for cols, ts, _ki in tchunks]
    wall, per_kernel, dev_us, stages, launches = _drive_cell(
        rt, "T", feed, _gagg_launches)
    cga = qrs["t"].device_runtime.cga
    capacity = cga.window
    sel = time_select(cga, CHUNK, dev)
    rt.shutdown()
    res = _cell_report("time cell", len(tchunks) * CHUNK, len(tchunks),
                       wall, per_kernel, dev_us, stages, launches,
                       list(GAGG_PASSES))
    res.update(capacity=capacity, route=route, select=sel)
    log(f"  ring capacity {capacity} after growth; selection route {route}")
    if launches[1] < len(tchunks):
        raise AssertionError(f"K7b launched {launches[1]} times")
    ref = time_reference(tchunks)
    ts_all = np.concatenate([c[1] for c in tchunks])
    ki_all = np.concatenate([c[2] for c in tchunks])
    if len(got) != len(ref):
        raise AssertionError(f"time cell: {len(got)} emissions, reference "
                             f"{len(ref)}")
    rows = 0
    for g, (rows_i, t, sv, n) in zip(got, ref):
        if not ((g["ts"] == ts_all[rows_i]).all() and
                (g["sym"] == names[ki_all[rows_i]]).all() and
                (g["sv"] == sv).all() and (g["n"] == n).all()):
            raise AssertionError("time cell: rows, order, keys, sv or "
                                 "counts differ from the reference")
        err = np.abs(g["t"] - t) / np.maximum(np.abs(t), 1e-30)
        if not (err <= 1e-5).all():
            raise AssertionError(f"time cell: t rel err {err.max():.3g}")
        rows += len(t)
    log(f"  time cell: {rows} rows == reference in emission order (keys, "
        f"order, sv and counts exact; t rel <= 1e-5)")
    res["rows"] = rows
    return res


# ------------------------------------------------------------------ phase 16

def filter_app(key):
    return (f"@app:name('filtercell')\n@app:playback\n"
            f"@Async(buffer.size='64', batch.size.max='{CHUNK}')\n"
            f"define stream S (sym string, price float, kind int);\n"
            f"@info(name='f')\n"
            f"from S[price > 50.0 and sym != '{key}']\n"
            f"select sym, price, price * 2.0 as p2 insert into FOut;\n")


def run_filter_cell(names, chunks, dev):
    """Phase 16: a stateless filter with a string compare on the code
    lanes through the public API (DeviceFilterRuntime, torch programs on
    the card); rows against numpy."""
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    key = names[0]
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
        filter_app(key))
    qrs = _device_queries(rt, "DeviceFilterRuntime", False)
    if qrs["f"].device_runtime.device.type != "cuda":
        raise AssertionError("filter cell: program not on the card")
    got = []
    rt.add_callback("FOut", ColumnarStreamCallback(
        lambda c: got.append({k: np.array(c.columns[k])
                              for k in ("sym", "price", "p2")})))
    rt.start()
    feed = [(cols, ts) for cols, ts, _ki in chunks]
    wall, per_kernel, dev_us, stages, launches = _drive_cell(
        rt, "S", feed, _gagg_launches)
    rt.shutdown()
    res = _cell_report("filter cell", len(chunks) * CHUNK, len(chunks), wall,
                       per_kernel, dev_us, stages, launches, [])
    if dev_us is not None and dev_us <= 0:
        raise AssertionError("filter cell: no device time")
    cols = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
    sym = np.concatenate([c[0]["sym"] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks])
    m = (price > np.float32(50.0)) & (sym != key)
    if not ((cols["sym"] == sym[m]).all() and
            (cols["price"] == price[m]).all() and
            (cols["p2"] == (price[m] * np.float32(2.0)).astype(
                np.float64)).all()):
        raise AssertionError("filter cell: rows differ from numpy")
    log(f"  filter cell: {int(m.sum())} rows == numpy exactly")
    res["rows"] = int(m.sum())
    return res


# ------------------------------------------------------------------ phase 17

GAGG_PARITY_STREAM = ("define stream S (sym string, user string, price "
                      "float, volume long);\n")
#: small apps of the JAX suites' shapes (tests/test_device_grouped_agg.py,
#: tests/test_select_device.py, filters); True: held against the host
#: engine too (the time window's host batches expire per chunk, not per
#: event, in both packages)
GAGG_PARITY_APPS = {
    "length_groupby": ("""
        @info(name='q') from S[price > 20.0]#window.length(5)
        select sym, sum(price) as s, count() as n, avg(price) as a,
               min(price) as lo, max(price) as hi, sum(volume) as sv
        group by sym insert into Out;""", True),
    "running_having_order_limit": ("""
        @info(name='q') from S
        select sym, user, sum(price) as t, count() as n, max(price) as hi,
               min(volume) as lo
        group by sym, user having n >= 2 order by n asc, t desc
        limit 3 offset 1 insert into Out;""", True),
    "windowed_having_order": ("""
        @info(name='q') from S#window.length(4)
        select sym, sum(price) as t, max(price) as hi, count() as n
        group by sym having not (t < 10.0)
        order by hi desc, t asc insert into Out;""", True),
    "partition_finer_groupby": ("""
        partition with (sym of S) begin
        @info(name='q') from S#window.length(3)
        select sym, user, sum(price) as s, count() as n, max(volume) as mv,
               minForever(price) as mf
        group by sym, user insert into Out; end;""", True),
    "time_having_order": ("""
        @info(name='q') from S#window.time(1 sec)
        select sym, sum(price) as t, sum(volume) as sv, count() as n
        group by sym having t > 20.0 order by t desc insert into Out;""",
                          False),
    "filter_string_lanes": ("""
        @info(name='q') from S[price > 50.0 and sym != 's1']
        select sym, price, price * 2.0 as p2, volume + 1 as v1
        insert into Out;""", True),
}


def gagg_parity(dev, seed):
    """Phase 17: each app through the device engine on the card, on the
    CPU (the plain steps) and through the host engine: CUDA == CPU
    exactly; == host as sorted payloads with floats through float32
    (the JAX suites' convention)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    rng = np.random.default_rng(seed + 17)
    batches, t0, v0 = [], 1_000_000, 0
    for _ in range(4):
        n = 400
        vol = v0 + np.cumsum(rng.integers(0, 9, n))
        batches.append(({
            "sym": np.asarray([f"s{i}" for i in rng.integers(0, 3, n)],
                              object),
            "user": np.asarray([f"u{i}" for i in rng.integers(0, 4, n)],
                               object),
            "price": rng.integers(1, 100, n).astype(np.float32),
            "volume": vol.astype(np.int64)},
            t0 + np.cumsum(rng.integers(10, 90, n))))
        v0, t0 = int(vol[-1]), int(batches[-1][1][-1])
    n0 = _gagg_launches()

    def run(text, device, engine):
        rt = SiddhiManager(device=device).create_siddhi_app_runtime(
            f"@app:playback\n@app:engine('{engine}')\n" + GAGG_PARITY_STREAM
            + text)
        rows = []
        rt.add_callback("Out", StreamCallback(lambda evs: rows.extend(
            (e.timestamp,) + tuple(e.data) for e in evs)))
        rt.start()
        h = rt.get_input_handler("S")
        for cols, ts in batches:
            h.send_batch(cols, timestamps=ts)
        rt.shutdown()
        return rows

    def f32(rows):
        return sorted((tuple(float(np.float32(v)) if isinstance(
            v, (float, np.floating)) else v for v in r) for r in rows),
            key=repr)

    for name, (text, with_host) in GAGG_PARITY_APPS.items():
        cuda_rows = run(text, dev, "device")
        cpu_rows = run(text, "cpu", "device")
        if cuda_rows != cpu_rows:
            raise AssertionError(f"{name}: CUDA rows != CPU plain rows")
        msg = f"  {name}: {len(cuda_rows)} rows; CUDA == CPU plain exactly"
        if with_host:
            host = run(text, dev, "host")
            if f32(host) != f32(cuda_rows):
                raise AssertionError(f"{name}: host rows != device rows")
            msg += "; == host engine (sorted, floats through float32)"
        log(msg)
    if _gagg_launches() == n0:
        raise AssertionError("phase 17 launched no K7 kernel")


# ------------------------------------------------------------------ phase 18

#: the K6 cell's shape (phase 20): 1,024 lanes, ~256 events a lane a chunk,
#: the ring grown to 512 slots by replays
K6_P, K6_T, K6_C = N_KEYS, 256, 512
#: K6's kernels (one launch of time_wagg_step runs both)
K6_KERNELS = ["wagg_time_prep", "wagg_time_events"]
WIN_EVENTS_PER_MS = 256                   # phases 20-21's feed rate
WAGG_CHUNKS = 4                           # phase 20
#: phase 21's chunks.  Each flush after the first runs 524,288 rows (the
#: expired batch and the new one) through the host selector's
#: row-at-a-time pass, ~22 s on the card's host: 8 chunks took the four
#: new phases past 120 s; cut from 4 to pay for the condition programs'
#: checks
WINDOW_CHUNKS = 2


def _time_feed(rng, P, T, kind, t0, dev):
    """One K6 block on the card: (values, ts offsets, accepted, last ts)."""
    import torch
    v = rng.uniform(0, 100, (P, T)).astype(np.float32)
    if kind == "nonfinite":
        m = rng.random((P, T))
        v[m < 0.05] = np.inf
        v[(m >= 0.05) & (m < 0.08)] = -np.inf
        v[(m >= 0.08) & (m < 0.1)] = np.nan
        v[(m >= 0.1) & (m < 0.3)] = -0.0
    ts = t0 + np.cumsum(rng.integers(0, 8, (P, T)), axis=1)
    if kind == "out_of_order":
        ts = t0 + rng.integers(0, 2000, (P, T))
    dens = {"rejected": 0.5, "none": 0.0}.get(kind, 0.9)
    ok = rng.random((P, T)) < dens
    return (torch.tensor(v, device=dev),
            torch.tensor(ts.astype(np.int32), device=dev),
            torch.tensor(ok, device=dev), int(ts.max()))


def grow_time_carry(carry, new_c):
    """The compiler's grow_capacity on a bare carry: entries kept in ts
    order (stable), empty slots dropped, pos = cnt."""
    import torch
    from siddhi_tpu_torch.ops.windowed_agg import TS_EMPTY, TimeWaggCarry
    ring = carry.ring.cpu().numpy()
    rts = carry.ring_ts.cpu().numpy()
    P = ring.shape[0]
    nr = np.zeros((P, new_c), np.float32)
    nts = np.full((P, new_c), TS_EMPTY, np.int32)
    cnt = np.zeros(P, np.int32)
    order = np.argsort(rts, axis=1, kind="stable")
    keep = np.take_along_axis(rts, order, 1) != TS_EMPTY
    for p in range(P):
        sel = order[p][keep[p]]
        nr[p, :len(sel)] = ring[p, sel]
        nts[p, :len(sel)] = rts[p, sel]
        cnt[p] = len(sel)
    dev = carry.ring.device
    return TimeWaggCarry(torch.tensor(nr, device=dev),
                         torch.tensor(nts, device=dev),
                         torch.tensor(cnt % new_c, device=dev),
                         torch.tensor(cnt, device=dev), carry.last_ts,
                         torch.zeros(P, dtype=torch.bool, device=dev))


#: phase 18's K6 cases: (name, P, T, C, window ms, feed, blocks)
K6_CASES = [
    ("cell shape, T >= C", K6_P, 300, 256, 1000, "uniform", 3),
    ("cell shape", K6_P, K6_T, K6_C, 1000, "uniform", 3),
    ("C not a power of two", 256, 128, 100, 500, "uniform", 3),
    ("T < 32", 256, 20, 64, 1000, "uniform", 3),
    ("overflow, grown and replayed", 64, 200, 16, 1000, "uniform", 3),
    ("ring above shared memory", 4, 64, 32768, 1000, "uniform", 2),
    ("timestamps out of order", 256, 128, 64, 500, "out_of_order", 3),
    ("+-inf / NaN / -0.0 feed", 256, 128, 128, 1000, "nonfinite", 3),
    ("rejected rows", 256, 128, 128, 1000, "rejected", 3),
    ("all rejected", 256, 16, 64, 1000, "none", 2),
    ("P = 1", 1, 700, 1024, 1000, "uniform", 3),
]


def check_wagg_time(dev, seed):
    """K6 (csrc/wagg_time.cu) against time_wagg_step_plain on the card, bit
    for bit on every output plane and carry leaf (NaN payloads aside),
    over chained blocks, min/max on and off; an overflowing block is
    rewound, its ring doubled and the block replayed on both sides."""
    import torch
    from siddhi_tpu_torch.ops.windowed_agg import (make_time_wagg_carry,
                                                   time_wagg_step,
                                                   time_wagg_step_plain)
    rng = np.random.default_rng(seed + 18)
    n = 0
    worst = 0.0
    for name, P, T, C, span, feed, blocks in K6_CASES:
        for minmax in (True, False):
            ck = make_time_wagg_carry(P, C, dev)
            cp = make_time_wagg_carry(P, C, dev)
            t0 = 0
            replays = 0
            for _ in range(blocks):
                v, ts, ok, t0 = _time_feed(rng, P, T, feed, t0, dev)
                while True:
                    nk, ok_ = time_wagg_step(span, ck, v, ts, ok, minmax)
                    np_, op_ = time_wagg_step_plain(span, cp, v, ts, ok,
                                                    minmax)
                    torch.cuda.synchronize()
                    for x, y in list(zip(ok_, op_)) + list(zip(nk, np_)):
                        worst = max(worst, _abs_err(x, y))
                        if not _nan_equal(x, y):
                            raise AssertionError(
                                f"wagg_time_step != plain: {name}, "
                                f"minmax={minmax}")
                    if not bool(np_.overflow.any()):
                        break
                    replays += 1
                    C2 = ck.ring.shape[1] * 2
                    ck, cp = grow_time_carry(ck, C2), grow_time_carry(cp, C2)
                ck, cp = nk, np_
            n += 1
            log(f"  wagg_time_step == plain: {name} (P={P} T={T} C={C}, "
                f"minmax={int(minmax)}, replays {replays})")
            if name.startswith("overflow") and not replays:
                raise AssertionError("the overflow case did not overflow")
    return {"cases": n, "max_abs_err": worst}


def time_wagg_bound(P, T, C, minmax):
    """(bound ms, by): the launch's inputs (values, ts, ok; the carry)
    read once and its outputs (sums, counts[, mins, maxs]; the fresh
    carry) written once over HBM3's rate, against P*T*C masked adds
    over the float32 peak."""
    carry = P * (C * 8 + 13)
    nbytes = P * T * (4 + 4 + 1) + P * T * (16 if minmax else 8) + 2 * carry
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = P * T * C / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def time_wagg_time(dev, seed):
    """K6 and its plain twin timed at the K6 cell's shape on a full ring
    (the window holds ~256 of its 512 slots), min/max on (the cell's)."""
    import torch
    from siddhi_tpu_torch.ops.windowed_agg import (make_time_wagg_carry,
                                                   time_wagg_step,
                                                   time_wagg_step_plain)
    rng = np.random.default_rng(seed + 181)
    carry = make_time_wagg_carry(K6_P, K6_C, dev)
    t0 = 0
    for _ in range(2):
        v, ts, ok, t0 = _time_feed(rng, K6_P, K6_T, "uniform", t0, dev)
        carry, _ = time_wagg_step(1000, carry, v, ts, ok, True)
    v, ts, ok, t0 = _time_feed(rng, K6_P, K6_T, "uniform", t0, dev)
    n0 = time_wagg_step.launches
    ms = median_ms(lambda: time_wagg_step(1000, carry, v, ts, ok, True), dev)
    plain_ms = median_ms(
        lambda: time_wagg_step_plain(1000, carry, v, ts, ok, True), dev, n=5)
    time_wagg_step.launches = n0          # timing launches are not the path
    bound, by = time_wagg_bound(K6_P, K6_T, K6_C, True)
    log(f"  wagg_time_step at P={K6_P} T={K6_T} C={K6_C} min/max: {ms:.4f} "
        f"ms (plain {plain_ms:.4f} ms, bound {bound:.6f} ms by {by}, "
        f"{bound / ms * 100:.2f}% of the bound reached)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "shape": {"P": K6_P, "T": K6_T, "C": K6_C, "minmax": True}}


# ------------------------------------------------------------------ phase 19

#: phase 19's K9 specs (ops/dwin.DwinSpec fields): every kind, with
#: variants for each kind's corner cases
DWIN_SPECS = {
    "length": ("length", 8, 1, 2, 0, 3),
    "time": ("time", 8, 1, 2, 100, 0),
    "time_telemetry_overflow": ("time", 4, 1, 1, 400, 0, (), -1, True),
    "externalTime_out_of_order": ("externalTime", 8, 1, 2, 100, 0),
    "timeLength": ("timeLength", 8, 2, 1, 100, 3),
    "delay": ("delay", 8, 1, 1, 100, 0),
    "lengthBatch": ("lengthBatch", 8, 1, 1, 0, 3),
    "timeBatch_telemetry": ("timeBatch", 8, 1, 1, 1000, 0, (), -1, True),
    "externalTimeBatch": ("externalTimeBatch", 8, 1, 3, 500, 0),
    "batch": ("batch", 8, 1, 1, 0, 0),
    "sort_ties": ("sort", 8, 1, 2, 0, 3, ((0, 0, True),)),
    "sort_long_hi_lo_desc": ("sort", 8, 1, 3, 0, 4,
                             ((1, 1, False), (1, 2, False), (0, 0, True))),
    "session_keyed": ("session", 8, 1, 2, 300, 0, (), 1),
    "session_keyless": ("session", 8, 1, 1, 300, 0, (), 0),
    "hopping": ("hopping", 8, 1, 1, 300, 0, (), -1, False, 100),
    "sort_nan_zero_first_key": ("sort", 8, 1, 1, 0, 3, ((0, 0, True),)),
    "sort_nan_zero_later_key_desc": ("sort", 8, 2, 1, 0, 3,
                                     ((1, 0, True), (0, 1, False))),
    "sort_nan_zero_three_keys": ("sort", 8, 3, 1, 0, 4,
                                 ((0, 0, False), (0, 1, True),
                                  (0, 2, False))),
    "session_many_keys": ("session", 8, 1, 2, 300, 0, (), 1),
}
#: the feeds of the specs that need their own (_dwin_steps)
DWIN_FEEDS = {"sort_nan_zero_first_key": "nan",
              "sort_nan_zero_later_key_desc": "nan",
              "sort_nan_zero_three_keys": "nan",
              "session_many_keys": "many_keys"}
#: the same kinds on pools above one CTA (capacity 300, chunks to 400)
DWIN_BIG = ("length", "time", "externalTime_out_of_order", "timeLength",
            "lengthBatch", "timeBatch_telemetry", "externalTimeBatch",
            "batch", "sort_long_hi_lo_desc", "session_keyed", "hopping",
            "delay", "sort_nan_zero_first_key", "sort_nan_zero_three_keys",
            "session_many_keys")
#: float sort keys of the "nan" feed
DWIN_SPECIAL = np.asarray([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf,
                          1.0, -1.0], np.float32)


def _dwin_steps(spec, rng, n_steps, sizes, dev, feed=None):
    """Chained K9 step inputs on the card (the CPU tests' generator):
    timer steps with no valid row, integer-valued payloads (sort ties),
    out-of-order externalTime stamps, flush ids and hopping flags; feed
    "nan": half the float lanes NaN, +-0.0, +-inf or +-1; "many_keys":
    session keys from 0..999."""
    import torch
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    t0 = 1000
    for _ in range(n_steps):
        T = int(rng.choice(sizes))
        ev_f = rng.integers(0, 4, (1, T, F)).astype(np.float32)
        if rng.random() < 0.3:
            ev_f = rng.normal(size=(1, T, F)).astype(np.float32)
        if feed == "nan":
            m = rng.random((1, T, F)) < 0.5
            ev_f[m] = rng.choice(DWIN_SPECIAL, int(m.sum()))
        ev_i = rng.integers(-2, 3, (1, T, I)).astype(np.int32)
        if feed == "many_keys":
            ev_i[0, :, spec.skey_lane] = rng.integers(0, 1000, T)
        ts = t0 + np.cumsum(rng.integers(0, 40, T))
        if spec.kind == "externalTime" and rng.random() < 0.5:
            ts = t0 + rng.integers(0, 300, T)
        valid = np.ones((1, T), bool)
        if rng.random() < 0.2:
            valid[:] = False
        t0 = int(ts.max()) + 1
        now = np.asarray([t0 + int(rng.integers(-50, 800))], np.int32)
        directive = np.zeros((1, T), np.int32)
        if spec.kind in ("timeBatch", "externalTimeBatch"):
            n_done = int(rng.integers(0, 3))
            directive[0] = np.sort(rng.integers(0, n_done + 1, T))
            now = np.asarray([n_done], np.int32)
        if spec.kind == "hopping":
            directive[0, 0] = int(rng.random() < 0.5)
        yield [torch.tensor(a, device=dev) for a in
               (ev_f, ev_i, ts[None].astype(np.int32), valid, now,
                directive)]


def grow_dwin_carry(carry, new_cap):
    """The compiler's _grow on a bare carry: zero payload slots and
    TS_NONE timestamps appended."""
    import torch
    from siddhi_tpu_torch.ops.dwin import TS_NONE
    c = dict(carry)
    for k in ("ring_f", "ring_i", "exp_f", "exp_i"):
        if k in c:
            pad = new_cap - c[k].shape[1]
            c[k] = torch.cat([c[k], c[k].new_zeros(
                (1, pad) + tuple(c[k].shape[2:]))], dim=1)
    for k in ("ring_ts", "exp_ts"):
        if k in c:
            c[k] = torch.cat([c[k], c[k].new_full(
                (1, new_cap - c[k].shape[1]), TS_NONE)], dim=1)
    return c


def _dwin_equal(spec, cap, kb, pb, kc, pc) -> bool:
    n = min(int(pb[-1, 0]), cap)
    return bool(torch_equal(kb[:n], pb[:n]) and
                torch_equal(kb[cap:], pb[cap:]) and
                all(_same_bits(kc[k], pc[k]) for k in pc))


def check_dwin(dev, seed):
    """K9 (csrc/dwin_step.cu) against dwin_step_plain on the card, bit for
    bit on the egress rows up to the count, the telemetry row, the tail
    and every carry leaf, over chained steps of every kind (and on pools
    above one CTA); an overflowing step is rewound, the ring doubled and
    the step replayed on both sides, as the compiler does."""
    import torch
    from siddhi_tpu_torch.ops.dwin import (DwinSpec, dwin_step,
                                           dwin_step_plain, make_dwin_carry)
    rng = np.random.default_rng(seed + 19)
    n = replays = 0
    runs = [(name, 8, 10, (1, 4, 11)) for name in DWIN_SPECS] + \
        [(name, 300, 4, (1, 150, 400)) for name in DWIN_BIG]
    for name, cap0, n_steps, sizes in runs:
        spec = DwinSpec(*DWIN_SPECS[name])._replace(capacity=cap0)
        kc = make_dwin_carry(spec, 1, dev)
        pc = make_dwin_carry(spec, 1, dev)
        for inp in _dwin_steps(spec, rng, n_steps, sizes, dev,
                               DWIN_FEEDS.get(name)):
            while True:
                cap = 2 * spec.capacity + inp[2].shape[1]
                nk, kb = dwin_step(spec, kc, *inp, cap)
                npc, pb = dwin_step_plain(spec, pc, *inp, cap)
                torch.cuda.synchronize()
                n += 1
                if not _dwin_equal(spec, cap, kb, pb, nk, npc):
                    raise AssertionError(f"dwin_step != plain: {name}, "
                                         f"capacity {spec.capacity}")
                if not int(pb[-1, 4]):
                    break
                replays += 1
                spec = spec._replace(capacity=spec.capacity * 2)
                kc = grow_dwin_carry(kc, spec.capacity)
                pc = grow_dwin_carry(pc, spec.capacity)
            kc, pc = nk, npc
        log(f"  dwin_step == plain: {name} (capacity {cap0} -> "
            f"{spec.capacity}, {n_steps} steps)")
    if not replays:
        raise AssertionError("phase 19 replayed no overflowing step")
    log(f"  {n} K9 steps equal bit for bit, {replays} grow-and-replays")
    return {"cases": n, "replays": replays, "max_abs_err": 0.0}


def dwin_bound(spec, T, count):
    """(bound ms, "bytes"): the carry read and written once (ring and,
    for the batch kinds and hopping, the exp plane: (F+I+1) words a
    slot), the chunk read once (payload, ts, valid, directive) and the
    step's emitted rows and tail written once."""
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    planes = 2 if spec.kind in ("lengthBatch", "timeBatch",
                                "externalTimeBatch", "batch",
                                "hopping") else 1
    carry = planes * spec.capacity * (F + I + 1) * 4 + 16
    chunk = T * ((F + I + 1) * 4 + 1 + 4)
    rows = (count + 1 + int(spec.telemetry)) * (4 + F + I) * 4
    return (2 * carry + chunk + rows) / PEAK_BYTES_PER_S * 1e3, "bytes"


def _dwin_pool(spec, carry, inp):
    """The step's pool on the host: payload bits, ts, liveness, ranks."""
    from siddhi_tpu_torch.ops.dwin import TS_NONE
    C = spec.capacity
    ev_f, ev_i, ev_ts, ev_valid = [a.cpu().numpy() for a in inp[:4]]
    fill = int(carry["fill"][0])
    nv = int(ev_valid.sum())
    pf = np.concatenate([carry["ring_f"][0].cpu().numpy(), ev_f[0]])
    pi = np.concatenate([carry["ring_i"][0].cpu().numpy(), ev_i[0]])
    pts = np.concatenate([carry["ring_ts"][0].cpu().numpy(),
                          np.where(ev_valid[0], ev_ts[0], TS_NONE)])
    x = np.arange(len(pts))
    live = np.where(x < C, x < fill, x - C < nv)
    rank = np.where(x < C, x, fill + x - C)
    return pf, pi, pts.astype(np.int64), live, rank, fill, nv


def _dwin_reference_out(spec, pf, pi, pts, live, keep, emit, evict_t,
                        cause, live_min):
    """Rows, tail and carry a step must give for these keep and emit
    masks: the new ring is the kept entries in pool order, then the rest
    in pool order, cut at C (ts TS_NONE past the fill); the rows the
    emitted entries in pool order."""
    from siddhi_tpu_torch.ops.dwin import TS_NONE
    C = spec.capacity
    order = np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)])
    K = int(keep.sum())
    nfill = min(K, C)
    sel = order[:C]
    ts = np.where(np.arange(C) < nfill, pts[sel], TS_NONE)
    carry = {"ring_f": pf[sel][None], "ring_i": pi[sel][None],
             "ring_ts": ts[None].astype(np.int32),
             "fill": np.asarray([nfill], np.int32)}
    e = np.flatnonzero(emit)
    rows = np.concatenate([
        np.stack([e, evict_t[e], cause[e], pts[e]], 1).astype(np.int64),
        pf[e].view(np.int32).astype(np.int64), pi[e].astype(np.int64)],
        1).astype(np.int32)
    tail = np.zeros(rows.shape[1], np.int32)
    tail[:5] = (len(e), nfill, 0, live_min, int(K > C))
    return rows, tail, carry


def dwin_sort_reference(spec, carry, inp):
    """The sort kind's step by Siddhi's SortWindowProcessor rule: the
    carry's live entries, then each valid chunk row in order, enter a
    heap; past n entries the current lex-max (ties: the newest) is
    evicted, at that row's chunk index.  Finite keys only (the greedy
    rule needs a total order)."""
    import heapq
    from siddhi_tpu_torch.ops.dwin import C_LEN, TS_NONE
    pf, pi, pts, live, rank, fill, nv = _dwin_pool(spec, carry, inp)
    C, n = spec.capacity, spec.length
    cols = []
    for bank, lane, asc in spec.sort_keys:
        v = (pf[:, lane].astype(np.float64) if bank == 0
             else pi[:, lane].astype(np.float64))
        if not np.isfinite(v[live]).all():
            raise AssertionError("sort reference: a non-finite key")
        cols.append(v if asc else -v)
    keyed = np.stack(cols, 1).tolist()
    heap, evict_t = [], np.zeros(len(pts), np.int64)
    emit = np.zeros(len(pts), bool)
    if fill > n:
        raise AssertionError("sort reference: a carry above n entries")
    for x in np.flatnonzero(live):         # pool order is rank order
        heapq.heappush(heap, ([-k for k in keyed[x]], -int(rank[x]),
                              int(x)))
        if len(heap) > n:
            y = heapq.heappop(heap)[2]
            emit[y] = True
            evict_t[y] = int(x) - C
    keep = live & ~emit
    return _dwin_reference_out(spec, pf, pi, pts, live, keep, emit,
                               evict_t, np.full(len(pts), C_LEN),
                               TS_NONE)


def dwin_session_reference(spec, carry, inp):
    """The session kind's step: a carried live entry expires when its
    key's last activity over the carried live entries (a per-key max,
    floored at NEG) + the gap <= now; the tail's minimum is each kept
    entry's key's last activity in the new ring (floored at NEG unless
    the key holds all C slots)."""
    from siddhi_tpu_torch.ops.dwin import C_TIME, NEG, TS_NONE
    pf, pi, pts, live, rank, fill, nv = _dwin_pool(spec, carry, inp)
    C = spec.capacity
    now = int(inp[4][0])
    key = pi[:, spec.skey_lane].astype(np.int64)
    _, kid = np.unique(key, return_inverse=True)
    carried = live & (np.arange(len(pts)) < C)
    last = np.full(kid.max() + 1, NEG, np.int64)
    np.maximum.at(last, kid[carried], pts[carried])
    ev = last[kid] + spec.window_ms
    ev = (ev + (1 << 31)) % (1 << 32) - (1 << 31)
    emit = carried & (ev <= now)
    keep = live & ~emit
    ring = np.flatnonzero(keep)[:C]
    live_min = TS_NONE
    if len(ring):
        mx = np.full(kid.max() + 1, np.iinfo(np.int64).min, np.int64)
        np.maximum.at(mx, kid[ring], pts[ring])
        n_of = np.bincount(kid[ring], minlength=len(mx))
        per = np.where(n_of[kid[ring]] >= C, mx[kid[ring]],
                       np.maximum(mx[kid[ring]], NEG))
        live_min = int(per.min())
    return _dwin_reference_out(spec, pf, pi, pts, live, keep, emit, ev,
                               np.full(len(pts), C_TIME), live_min)


def _dwin_reference_equal(cap, kb, kc, ref) -> bool:
    """Kernel step == reference: the count, every emitted row, the tail
    and every carry leaf, bit for bit."""
    rows, tail, carry = ref
    got = kb.cpu().numpy()
    n = len(rows)

    def bits(a):
        return a.view(np.int32) if a.dtype == np.float32 else a
    return bool(int(got[-1, 0]) == n and n <= cap and
                np.array_equal(got[:n], rows) and
                np.array_equal(got[cap], tail) and
                all(np.array_equal(bits(kc[k].cpu().numpy()), bits(v))
                    for k, v in carry.items()))


#: phase 19's timed kinds, one of each family, at the window cell's shape
DWIN_TIMED = {
    "time": ("time", 0, 1, 1, 1000, 0),
    "timeBatch": ("timeBatch", 0, 1, 1, 1000, 0),
    "sort": ("sort", 0, 1, 1, 0, 1024, ((0, 0, True),)),
    "session": ("session", 0, 1, 2, 1000, 0, (), 1),
}
DWIN_TIMED_C = 1 << 18                    # the window cell's ring, at least
DWIN_PLAIN_C = 2048                       # sort's and session's plain shape


def _dwin_timed_inputs(spec, chunk, step, dev):
    """One step's device inputs from a window-cell chunk (price lane,
    sym code lane, ts offsets): `step` 0 fills the ring, 1 is timed."""
    import torch
    cols, ts, ki = chunk
    T = len(ts)
    ev_f = torch.tensor(cols["price"].reshape(1, T, 1), device=dev)
    codes = (ki + 1).astype(np.int32)
    I = max(spec.n_i, 1)
    ev_i = torch.tensor(np.repeat(codes[None, :, None], I, axis=2),
                        device=dev)
    off = (ts - ts[0] + step * 1100).astype(np.int32)
    directive = np.full((1, T), step, np.int32)
    now = {"timeBatch": step}.get(spec.kind, int(off[-1]))
    return [ev_f, ev_i, torch.tensor(off[None], device=dev),
            torch.ones((1, T), dtype=torch.bool, device=dev),
            torch.tensor([now], dtype=torch.int32, device=dev),
            torch.tensor(directive, device=dev)]


def time_dwin(dev, wchunks):
    """K9 timed at the window cell's shape (ring C = 2^18, a chunk of
    262,144 events) for one kind of each family: a carry filled by one
    step, then the next chunk's step; median of TIMED_LAUNCHES launches,
    L2 flushed; the plain twin at the same shape for time and timeBatch,
    and for sort and session (whose twin materialises [M, M] masks) at
    C = T = 2,048, with the kernel at that shape beside it.  Wherever the
    twin runs, both steps are held against it bit for bit first (at the
    cell's shape the pool is 2,048 CTAs, so the scan carries totals
    across its 1,024-CTA chunks); at the cell's shape both sort and
    session steps are held against dwin_sort_reference /
    dwin_session_reference: every emitted row, the tail and every carry
    leaf.  ({kind: timings}, steps held)."""
    import torch
    from siddhi_tpu_torch.ops.dwin import (DwinSpec, dwin_step,
                                           dwin_step_plain, make_dwin_carry)
    out = {}
    held = 0
    n0 = dwin_step.launches
    for name, fields in DWIN_TIMED.items():
        quad = name in ("sort", "session")
        res = {}
        for C, T in ((DWIN_TIMED_C, CHUNK),) + \
                (((DWIN_PLAIN_C, DWIN_PLAIN_C),) if quad else ()):
            spec = DwinSpec(*fields)._replace(capacity=C)
            ch = [(c[0], c[1], c[2]) for c in wchunks[:2]]
            ch = [({k: v[:T] for k, v in c[0].items()}, c[1][:T], c[2][:T])
                  for c in ch]
            carry0 = make_dwin_carry(spec, 1, dev)
            cap = 2 * C + T
            inp0 = _dwin_timed_inputs(spec, ch[0], 0, dev)
            carry, buf0 = dwin_step(spec, carry0, *inp0, cap)
            inp = _dwin_timed_inputs(spec, ch[1], 1, dev)
            new, buf = dwin_step(spec, carry, *inp, cap)
            count = int(buf[-1, 0])
            reps = TIMED_LAUNCHES
            if quad and C == DWIN_TIMED_C:
                ref = (dwin_sort_reference if name == "sort"
                       else dwin_session_reference)
                for c_in, i_in, kc, kb in ((carry0, inp0, carry, buf0),
                                           (carry, inp, new, buf)):
                    if not _dwin_reference_equal(cap, kb, kc,
                                                 ref(spec, c_in, i_in)):
                        raise AssertionError(
                            f"dwin_step != numpy reference: {name} at "
                            f"C={C} T={T}")
                    held += 1
            ms = median_ms(lambda: dwin_step(spec, carry, *inp, cap), dev,
                           n=reps)
            bound, by = dwin_bound(spec, T, count)
            row = {"ms": ms, "bound_ms": bound, "bound_by": by,
                   "emitted": count, "launches_timed": reps,
                   "shape": {"C": C, "T": T, "F": spec.n_f, "I": spec.n_i}}
            twin = not quad or C == DWIN_PLAIN_C
            row["held_against"] = "plain" if twin else "numpy reference"
            if twin:
                row["plain_ms"] = median_ms(
                    lambda: dwin_step_plain(spec, carry, *inp, cap), dev,
                    n=5)
                for c_in, i_in, kc, kb in ((carry0, inp0, carry, buf0),
                                           (carry, inp, new, buf)):
                    pc, pb = dwin_step_plain(spec, c_in, *i_in, cap)
                    if not _dwin_equal(spec, cap, kb, pb, kc, pc):
                        raise AssertionError(
                            f"dwin_step != plain: {name} at C={C} T={T}")
                    held += 1
                del pc, pb
            del new, buf0
            res["cell" if C == DWIN_TIMED_C else "plain_shape"] = row
            log(f"  dwin_step {name} at C={C} T={T}: {ms:.4f} ms "
                f"(median of {reps}; plain "
                f"{row.get('plain_ms', float('nan')):.4f} ms; bound "
                f"{bound:.6f} ms by bytes; {count} rows emitted"
                f"; both steps == {row['held_against']})")
        out[name] = res
    dwin_step.launches = n0               # timing launches are not the path
    return out, held


# ------------------------------------------------------------------ phase 20

K6_APP = """
@app:name('k6cell')
@app:playback
define stream T (sym string, price float);
partition with (sym of T) begin
@info(name='q')
from T#window.time(1 sec)
select sym, sum(price) as t, count() as n, avg(price) as a, min(price) as lo,
       max(price) as hi
group by sym insert into Out;
end;
"""


def make_window_chunks(seed, n_chunks):
    """Phases 20-21's feed: 1,024 string keys drawn uniformly, prices
    uniform in [0, 100), 256 events a millisecond, 262,144 events a chunk
    (1,024 ms).  (names, [(columns, timestamps, key index)])."""
    rng = np.random.default_rng(seed + 20)
    names = np.asarray([f"w{i:04d}-{rng.integers(1 << 30):x}"
                        for i in range(N_KEYS)], object)
    out = []
    for c in range(n_chunks):
        ki = rng.integers(0, N_KEYS, CHUNK)
        idx = c * CHUNK + np.arange(CHUNK, dtype=np.int64)
        out.append(({"sym": names[ki],
                     "price": rng.uniform(0, 100, CHUNK).astype(np.float32)},
                    1_000_000 + idx // WIN_EVENTS_PER_MS, ki))
    return names, out


def k6_reference(chunks):
    """Every event's window in float64: its key's events that arrived no
    later than it with ts > its ts - 1000 (a contiguous range in (key,
    arrival) order): sum, count, min, max, in input order."""
    ki = np.concatenate([c[2] for c in chunks]).astype(np.int64)
    ts = np.concatenate([c[1] for c in chunks])
    price = np.concatenate([c[0]["price"] for c in chunks]).astype(
        np.float64)
    n = len(ki)
    order = np.lexsort((np.arange(n), ki))
    ks, tss, ps = ki[order], ts[order], price[order]
    key = ks * (1 << 40) + tss
    start = np.searchsorted(key, ks * (1 << 40) + tss - 999, side="left")
    idx = np.arange(n)
    L = idx - start + 1
    s = np.zeros(n)
    lo = np.full(n, np.inf)
    hi = np.full(n, -np.inf)
    for d in range(int(L.max())):
        m = d < L
        x = ps[idx[m] - d]
        s[m] += x
        lo[m] = np.minimum(lo[m], x)
        hi[m] = np.maximum(hi[m], x)
    S, N, LO, HI = (np.empty(n), np.empty(n, np.int64), np.empty(n),
                    np.empty(n))
    S[order], N[order], LO[order], HI[order] = s, L, lo, hi
    return S, N, LO, HI


def _peak_reset(dev):
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)


def run_k6_cell(names, chunks, dev):
    """Phase 20: the K6 cell through the public API — a partitioned
    #window.time(1 sec) grouped by its key is a DeviceWindowedAggRuntime
    with window_kind "time" on K6; every row against k6_reference."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    from siddhi_tpu_torch.ops import windowed_agg as wa
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(K6_APP)
    qrs = _device_queries(rt, "DeviceWindowedAggRuntime", True)
    cwa = qrs["q"].device_runtime.cwa
    if cwa.window_kind != "time":
        raise AssertionError(f"K6 cell: window kind {cwa.window_kind}")
    got = []
    rt.add_callback("Out", ColumnarStreamCallback(
        lambda c: got.append({k: np.array(c.columns[k])
                              for k in ("sym", "t", "n", "a", "lo", "hi")}
                             | {"ts": np.array(c.timestamps)})))
    rt.start()
    _peak_reset(dev)
    wall, per_kernel, dev_us, stages, launches = _drive_cell(
        rt, "T", [(c, ts) for c, ts, _ in chunks],
        lambda: wa.time_wagg_step.launches,
        reset=lambda: setattr(wa.time_wagg_step, "launches", 0))
    peak = torch.cuda.max_memory_allocated(dev)
    capacity = cwa.window
    rt.shutdown()
    res = _cell_report("K6 cell", len(chunks) * CHUNK, len(chunks), wall,
                       per_kernel, dev_us, stages, launches,
                       K6_KERNELS)
    res.update(peak=peak, capacity=capacity)
    log(f"  ring capacity {capacity} after growth by replay; peak device "
        f"memory {peak} B")
    if launches < len(chunks):
        raise AssertionError(f"K6 launched {launches} times")
    S, N, LO, HI = k6_reference(chunks)
    g = {k: np.concatenate([x[k] for x in got]) for k in got[0]}
    ts_all = np.concatenate([c[1] for c in chunks])
    ki_all = np.concatenate([c[2] for c in chunks])
    if len(g["n"]) != len(N) or not (
            (g["ts"] == ts_all).all() and (g["sym"] == names[ki_all]).all()
            and (g["n"] == N).all() and (g["lo"] == LO).all()
            and (g["hi"] == HI).all()):
        raise AssertionError("K6 cell: rows, keys, counts or min/max differ "
                             "from the reference")
    for col, want in (("t", S), ("a", S / N)):
        err = np.abs(g[col] - want) / np.maximum(np.abs(want), 1e-30)
        if not (err <= 1e-5).all():
            raise AssertionError(f"K6 cell: {col} rel err {err.max():.3g}")
    log(f"  K6 cell: {len(N)} rows == float64 reference (keys, counts, "
        f"min/max exact; sum/avg rel <= 1e-5)")
    res["rows"] = len(N)
    return res


# ------------------------------------------------------------------ phase 21

WINDOW_APP = """
@app:name('wincell')
@app:playback
define stream S (sym string, price float);
@info(name='q')
from S#window.timeBatch(1 sec)
select sym, sum(price) as t, count() as n
group by sym insert into Out;
"""


def window_reference(chunks, window_ms=1000):
    """The time batches as the reference's TimeBatchWindowProcessor forms
    them from chunked input: the first batch ends 1 s after the first
    event; a chunk whose last event reaches the batch end flushes the
    events buffered before it (each elapsed boundary once), then joins
    the buffer.  Per flush, per key: (last event ts, float64 price sum,
    count), sorted by key index."""
    flushes = []
    buf = []
    next_emit = int(chunks[0][1][0]) + window_ms
    for cols, ts, ki in chunks:
        while int(ts[-1]) >= next_emit:
            if buf:
                k = np.concatenate([b[2] for b in buf])
                t = np.concatenate([b[1] for b in buf])
                p = np.concatenate([b[0]["price"] for b in buf]).astype(
                    np.float64)
                keys = np.unique(k)
                last = np.zeros(N_KEYS, np.int64)
                np.maximum.at(last, k, t)     # ts rise with arrival
                flushes.append((keys, last[keys],
                                np.bincount(k, p, N_KEYS)[keys],
                                np.bincount(k, minlength=N_KEYS)[keys]))
            buf = []
            next_emit += window_ms
        buf.append((cols, ts, ki))
    return flushes


def run_window_cell(names, chunks, dev):
    """Phase 21: the window cell through the public API — timeBatch(1 sec)
    per-symbol totals (gagg refuses batch windows, so the window runs on
    the device window path: DeviceWindowProcessor on K9, the selector on
    the host); each flush's rows against window_reference, the first
    flush against the port's host engine."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    from siddhi_tpu_torch.ops import dwin

    def build(engine):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
            (f"@app:engine('{engine}')\n" if engine else "") + WINDOW_APP)
        got = []
        rt.add_callback("Out", ColumnarStreamCallback(
            lambda c: got.append({k: np.array(c.columns[k])
                                  for k in ("sym", "t", "n")}
                                 | {"ts": np.array(c.timestamps)})))
        rt.start()
        return rt, got

    rt, got = build(None)
    qr = rt.query_runtimes["q"]
    (w,) = qr.windows
    if type(w).__name__ != "DeviceWindowProcessor" or \
            qr.backend != "device":
        raise AssertionError(f"window cell: {type(w).__name__} "
                             f"({qr.backend}: {qr.backend_reason})")
    _peak_reset(dev)
    wall, per_kernel, dev_us, stages, launches = _drive_cell(
        rt, "S", [(c, ts) for c, ts, _ in chunks],
        lambda: dwin.dwin_step.launches,
        reset=lambda: setattr(dwin.dwin_step, "launches", 0))
    peak = torch.cuda.max_memory_allocated(dev)
    capacity = w.capacity
    rt.shutdown()
    res = _cell_report("window cell", len(chunks) * CHUNK, len(chunks), wall,
                       per_kernel, dev_us, stages, launches,
                       ["dwin_prep", "dwin_decide", "dwin_scan",
                        "dwin_scatter"])
    F, I = max(w.n_f, 1), max(w.n_i, 1)
    egress = (2 * capacity + CHUNK + 1) * (4 + F + I) * 4
    res.update(peak=peak, capacity=capacity, egress_bytes_per_step=egress)
    log(f"  ring capacity {capacity} after growth; egress read per step "
        f"{egress} B (cap + 1 rows of {4 + F + I} int32); peak device "
        f"memory {peak} B")
    if launches < len(chunks) or capacity < DWIN_TIMED_C:
        raise AssertionError(f"K9 launched {launches} times, capacity "
                             f"{capacity}")
    ref = window_reference(chunks)
    if len(got) != len(ref):
        raise AssertionError(f"window cell: {len(got)} flushes, reference "
                             f"{len(ref)}")
    rows = 0
    code = {nm: i for i, nm in enumerate(names)}
    for g, (keys, last, s, n) in zip(got, ref):
        ki = np.asarray([code[x] for x in g["sym"]])
        o = np.argsort(ki)
        if not (np.array_equal(ki[o], keys) and
                np.array_equal(g["ts"][o], last) and
                np.array_equal(g["n"][o], n)):
            raise AssertionError("window cell: a flush's keys, timestamps or "
                                 "counts differ from the reference")
        err = np.abs(g["t"][o] - s) / np.maximum(np.abs(s), 1e-30)
        if not (err <= 1e-5).all():
            raise AssertionError(f"window cell: t rel err {err.max():.3g}")
        rows += len(keys)
    log(f"  window cell: {len(ref)} flushes, {rows} rows == reference "
        f"(keys, timestamps, counts exact; t rel <= 1e-5)")
    host, hgot = build("host")
    h = host.get_input_handler("S")
    for cols, ts, _ in chunks[:2]:
        h.send_batch(cols, timestamps=ts)
    host.shutdown()
    if not hgot or any(not np.array_equal(hgot[0][k], got[0][k])
                       for k in ("sym", "ts", "n", "t")):
        raise AssertionError("window cell: the first flush differs from the "
                             "host engine's")
    log(f"  window cell: the first flush ({len(got[0]['n'])} rows) == the "
        f"host engine's, in order")
    res["rows"] = rows
    return res


# ------------------------------------------------------------------ phase 22

IAGG_FNS = ("sum", "sumsq", "min", "max", "count", "last")
#: TradeAgg's bases (avg, sum, count: sum and count lanes)
IAGG_CELL_FNS = ("sum", "count", "sum", "count")
IAGG_SYMBOLS = 1024
IAGG_CHUNKS = 4
IAGG_BASE_TS = 1_496_289_950_000
IAGG_HOUR_MS = 3_600_000
IAGG_SEC_SLAB = 1 << 20           # the cell's sec slab after its 4 chunks
IAGG_SPECIAL = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0],
                          np.float32)


def _iagg_slab(rng, S, fns, special):
    """A slab state: identities, random rows and (special) NaN, +-inf and
    -0.0 in values and error lanes; counts up to 2^31 - 1."""
    from siddhi_tpu_torch.ops.incremental_agg import init_row
    B = len(fns)
    vals = np.tile(init_row(fns), (S, 1))
    half = S // 2
    vals[:half] = rng.standard_normal((half, B)).astype(np.float32) * 100
    comp = (rng.standard_normal((S, B)) * 1e-5).astype(np.float32)
    cnt = rng.integers(0, 1000, S).astype(np.int32)
    cnt[:min(S, 3)] = np.int32(2**31 - 2)         # the count lane wraps
    if special:
        for a in (vals, comp):
            m = rng.random(a.shape) < 0.02
            a[m] = rng.choice(IAGG_SPECIAL, int(m.sum()))
    return vals, cnt, comp


def _iagg_feed(rng, n, S, B, seg_kind, feed):
    if seg_kind == "one":
        seg = np.full(n, min(5, S - 1), np.int32)
    elif seg_kind == "masked":
        seg = rng.integers(0, S, n).astype(np.int32)
        seg[rng.random(n) < 0.9] = -1
    else:
        seg = rng.integers(0, S, n).astype(np.int32)
        seg[rng.random(n) < 0.1] = -1
        seg[rng.random(n) < 0.01] = S + 3             # past the slab: masked
    if feed == "int":
        bv = rng.integers(1, 10, (n, B)).astype(np.float32)
    else:
        bv = (rng.standard_normal((n, B)) * 100).astype(np.float32)
        if feed == "special":
            m = rng.random((n, B)) < 0.02
            bv[m] = rng.choice(IAGG_SPECIAL, int(m.sum()))
    return seg, bv


IAGG_CASES = (
    [dict(fns=(fn,), n=4096, S=2048, comp=c, feed="special")
     for fn in IAGG_FNS for c in (False, True)] +
    [dict(fns=IAGG_FNS, n=n, S=2048, comp=c, feed="special")
     for n in (1, 7, 1000, 65_536, 262_144) for c in (False, True)] +
    [dict(fns=IAGG_FNS, n=262_144, S=IAGG_SEC_SLAB, comp=c,
          feed="special") for c in (False, True)] +
    # ~57 rows a slot: runs on both sides of the warp walk's threshold
    [dict(fns=IAGG_FNS, n=262_144, S=4096, comp=c, feed="special")
     for c in (False, True)] +
    [dict(fns=IAGG_FNS, n=262_144, S=2048, comp=c, feed="special",
          seg="one") for c in (False, True)] +
    [dict(fns=IAGG_FNS, n=65_536, S=4096, comp=c, feed="special",
          seg="masked", steps=3) for c in (False, True)] +
    [dict(fns=IAGG_CELL_FNS, n=262_144, S=IAGG_SEC_SLAB, comp=False,
          feed="uniform", steps=2),
     # an integer-valued feed past 2^24: the error lanes keep it exact
     dict(fns=("sum", "count", "sumsq"), n=262_144, S=2048, comp=True,
          feed="int", seg="one", steps=3, start=float(1 << 25))] +
    # S at the radix sort's 8-bit digit boundaries (keys in [0, S]: one
    # pass to 255, two to 65,535, three past), n not a multiple of a pass
    # tile (2,048 rows)
    [dict(fns=IAGG_FNS, n=n, S=S, comp=c, feed="special", seg=sk)
     for S, n, sk in ((255, 100_003, "uniform"), (256, 4097, "masked"),
                      (65_535, 65_537, "uniform"),
                      (65_536, 100_003, "masked"),
                      (1 << 20, 262_143, "uniform"))
     for c in (False, True)] +
    [dict(fns=("sum", "min", "last"), n=262_144, S=(1 << 24) - 1, comp=c,
          feed="special") for c in (False, True)])
#: K10's times before its 8-bit sort (run F13b: chip_smoke.py on an H100
#: 80GB HBM3 at 700 W), printed beside this run's
IAGG_WAS_MS = {"cell": 0.1232, "one_slot": 3.0983}


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (-0.0 is not +0.0), a NaN matching a NaN at the
    same position whatever its payload."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return bool(((a.view(torch.int32) == b.view(torch.int32)) |
                     (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def device_ops(fn, calls=4):
    """Device operations (kernels, memsets, copies) one call of fn
    enqueues, from torch.profiler over `calls` calls (it may drop the
    first event of a trace: the count is rounded up), or None when it
    records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            n += ev.count
    return -(-n // calls) or None


def check_iagg(dev, seed):
    """Phase 22: K10 (iagg_fold) against slab_update_plain run on a CPU
    copy of the same inputs (torch's CUDA index_add_ adds with atomics),
    bit for bit on vals, cnt and comp (-0.0 apart from +0.0; NaN compared
    by position), over chained folds."""
    import torch
    from siddhi_tpu_torch.ops.incremental_agg import (slab_update,
                                                      slab_update_plain)
    rng = np.random.default_rng(seed + 221)
    worst = 0.0
    n_cases = 0
    for case in IAGG_CASES:
        fns, n, S = case["fns"], case["n"], case["S"]
        B = len(fns)
        comp_on = case["comp"]
        vals, cnt, comp = _iagg_slab(rng, S, fns, case["feed"] == "special")
        if "start" in case:
            vals[:] = case["start"]
            comp[:] = 0.0
        kc = [torch.tensor(vals, device=dev), torch.tensor(cnt, device=dev),
              torch.tensor(comp, device=dev) if comp_on else None]
        pc = [torch.tensor(vals), torch.tensor(cnt),
              torch.tensor(comp) if comp_on else None]
        exact = np.zeros(S, np.int64)
        for _ in range(case.get("steps", 1)):
            seg, bv = _iagg_feed(rng, n, S, B, case.get("seg", "uniform"),
                                 case["feed"])
            segd, bvd = torch.tensor(seg, device=dev), torch.tensor(
                bv, device=dev)
            ko = slab_update(fns, kc[0], kc[1], segd, bvd, kc[2])
            po = slab_update_plain(fns, pc[0], pc[1], torch.tensor(seg),
                                   torch.tensor(bv), pc[2])
            torch.cuda.synchronize()
            kc = [ko[0], ko[-1], ko[1] if comp_on else None]
            pc = [po[0], po[-1], po[1] if comp_on else None]
            for x, y in zip(ko, po):
                y = y.to(dev)
                worst = max(worst, _abs_err(x, y))
                if not _bits_equal(x, y):
                    raise AssertionError(
                        f"iagg_fold != slab_update_plain: fns={fns} n={n} "
                        f"S={S} comp={comp_on} feed={case['feed']} "
                        f"seg={case.get('seg', 'uniform')}")
            if case["feed"] == "int":
                ok = (seg >= 0) & (seg < S)
                np.add.at(exact, seg[ok], bv[ok, 0].astype(np.int64))
            n_cases += 1
        if "start" in case:
            s = int(seg[0])
            got = np.float64(kc[0][s, 0].item()) + np.float64(
                kc[2][s, 0].item())
            if got != case["start"] + exact[s]:
                raise AssertionError(f"iagg_fold: compensated sum {got} != "
                                     f"{case['start'] + exact[s]}")
        log(f"  iagg_fold == slab_update_plain  fns={','.join(fns)} n={n} "
            f"S={S} compensated={int(comp_on)} feed={case['feed']} "
            f"seg={case.get('seg', 'uniform')} steps={case.get('steps', 1)}")
    return {"cases": n_cases, "max_abs_err": worst}


def iagg_bound(n, B, touched, comp):
    """Bytes the fold must move: the rows (seg and B values each) read
    once, the touched slots' vals, cnt (and comp) read and written."""
    row = 4 * B + 4 + (4 * B if comp else 0)
    return (n * (4 * B + 4) + 2 * touched * row) / PEAK_BYTES_PER_S * 1e3


def _iagg_cell_seg(rng, n, S):
    """The sec slab's segments for one of the cell's chunks: the pairs
    (second, symbol) of uniform timestamps over an hour, as slots."""
    sec = rng.integers(0, IAGG_HOUR_MS, n) // 1000
    sym = rng.integers(0, IAGG_SYMBOLS, n)
    code = sec * IAGG_SYMBOLS + sym
    _, inv = np.unique(code, return_inverse=True)
    slots = rng.permutation(S)[:inv.max() + 1]
    return slots[inv].astype(np.int32), int(inv.max() + 1)


def _iagg_timed_inputs(rng, name, dev):
    """The timed folds' inputs: the cell's sec slab (the cell's bases, a
    chunk's ~250,000 touched slots of 2^20) or one slot holding the
    batch: (S, touched, vals, cnt, seg, base values) on the card."""
    import torch
    n, B = CHUNK, len(IAGG_CELL_FNS)
    if name == "cell":
        S = IAGG_SEC_SLAB
        seg, touched = _iagg_cell_seg(rng, n, S)
    else:
        S = 2048
        seg, touched = np.full(n, 5, np.int32), 1
    bv = rng.uniform(1, 100, (n, B)).astype(np.float32)
    return (S, touched, torch.zeros((S, B), dtype=torch.float32, device=dev),
            torch.zeros((S,), dtype=torch.int32, device=dev),
            torch.tensor(seg, device=dev), torch.tensor(bv, device=dev))


def count_device_ops(dev, seed):
    """Device operations (kernels, memsets) one K10 fold (the cell's sec
    slab, one slot) and one fused K11 probe (the join cell's shape)
    enqueue, from torch.profiler; run first, before any other profiler
    session (later ones lose events)."""
    from siddhi_tpu_torch.ops.incremental_agg import slab_update
    from siddhi_tpu_torch.ops.join_probe import probe_fused
    rng = np.random.default_rng(seed + 227)
    n0 = (slab_update.launches, probe_fused.launches)
    out = {}
    for name in ("cell", "one_slot"):
        _S, _t, vals, cnt, segd, bvd = _iagg_timed_inputs(rng, name, dev)
        out[name] = device_ops(lambda: slab_update(IAGG_CELL_FNS, vals, cnt,
                                                   segd, bvd))
    left, right = _timed_lanes(dev, seed)
    prog = fused_program(FUSED_CONDS["cell"])
    ll = [left[a] for a in prog.lanes[0]]
    rl = [right[a] for a in prog.lanes[1]]
    nl2, nr2 = JOIN_CELL_SHAPE
    out["probe_fused"] = device_ops(lambda: probe_fused(
        prog, ll, rl, JOIN_CHUNK, JOIN_TABLE, nl2, nr2, 1 << 17))
    slab_update.launches, probe_fused.launches = n0
    log(f"  device operations: a K10 fold {out['cell']} (sec slab), "
        f"{out['one_slot']} (one slot); a fused K11 probe "
        f"{out['probe_fused']}")
    return out


def time_iagg(dev, seed, ops):
    """K10 timed at the aggregation cell's sec slab and at one slot
    holding the whole batch (the walk's serial floor), in one call; the
    twin on the card beside (index_add_ with atomics: the same function,
    its order free), the sort's yardstick (torch.sort(stable=True) of the
    masked keys alone), the times before the 8-bit sort, and `ops`
    (count_device_ops)."""
    import torch
    from siddhi_tpu_torch.ops.incremental_agg import (slab_update,
                                                      slab_update_plain)
    rng = np.random.default_rng(seed + 227)
    fns = IAGG_CELL_FNS
    B = len(fns)
    out = {}
    n = CHUNK
    for name in ("cell", "one_slot"):
        S, touched, vals, cnt, segd, bvd = _iagg_timed_inputs(rng, name, dev)
        n0 = slab_update.launches
        ms = median_ms(lambda: slab_update(fns, vals, cnt, segd, bvd), dev,
                       n=TIMED_LAUNCHES if name == "cell" else 3)
        slab_update.launches = n0        # timing launches are not the path
        plain_ms = median_ms(
            lambda: slab_update_plain(fns, vals, cnt, segd, bvd), dev, n=5)
        keys = torch.where((segd >= 0) & (segd < S), segd,
                           torch.full_like(segd, S))
        sort_ms = median_ms(lambda: torch.sort(keys, stable=True), dev)
        bound = iagg_bound(n, B, touched, False)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "sort_library_ms": sort_ms,
                     "device_ops": ops[name],
                     "shape": {"n": n, "S": S, "B": B, "touched": touched}}
        log(f"  iagg_fold at n={n} S={S} B={B} ({touched} touched slots, "
            f"{name}): {ms:.4f} ms (was {IAGG_WAS_MS[name]} ms, run F13b; "
            f"plain twin on the card {plain_ms:.4f} ms; the sort's "
            f"yardstick torch.sort(stable=True) {sort_ms:.4f} ms; bound "
            f"{bound:.6f} ms by bytes, {bound / ms * 100:.2f}% of the bound "
            f"reached); {ops[name]} device operations a fold")
    if out["one_slot"]["ms"] > 1.03 * IAGG_WAS_MS["one_slot"]:
        log(f"  NOTE: one slot {out['one_slot']['ms']:.4f} ms is more than "
            f"3% above run F13b's {IAGG_WAS_MS['one_slot']} ms")
    return out


# ------------------------------------------------------------------ phase 23

IAGG_APP = """
define stream TradeStream (symbol string, price double, volume long, ts long);
define aggregation TradeAgg
from TradeStream
select symbol, avg(price) as avgPrice, sum(price) as total, count() as n
group by symbol
aggregate by ts every sec ... hour;
"""
IAGG_QUERY = ("from TradeAgg within 1496289000000, 1496296000000 per "
              "'{per}' select AGG_TIMESTAMP, symbol, avgPrice, total, n")


def make_iagg_chunks(seed, n_chunks, n=CHUNK):
    """samples/incremental_agg_performance.py's feed at the cell's size:
    1,024 symbols, prices uniform in [1, 100), volumes in [1, 10),
    timestamps uniform over one hour."""
    rng = np.random.default_rng(seed + 23)
    names = np.asarray([f"k{i}" for i in range(IAGG_SYMBOLS)], object)
    chunks = []
    for _ in range(n_chunks):
        ki = rng.integers(0, IAGG_SYMBOLS, n)
        price = rng.uniform(1.0, 100.0, n)
        ts = IAGG_BASE_TS + rng.integers(0, IAGG_HOUR_MS, n)
        chunks.append(({"symbol": names[ki], "price": price,
                        "volume": rng.integers(1, 10, n), "ts": ts}, ki))
    return names, chunks


def iagg_reference(chunks, step_ms):
    """(bucket ts, symbol index, count, sum) per bucket in float64, sorted
    by bucket then symbol."""
    ts = np.concatenate([c["ts"] for c, _ in chunks])
    ki = np.concatenate([k for _, k in chunks])
    price = np.concatenate([c["price"] for c, _ in chunks])
    code = (ts // step_ms) * IAGG_SYMBOLS + ki
    u, inv = np.unique(code, return_inverse=True)
    cnt = np.bincount(inv)
    s = np.bincount(inv, weights=price)
    return (u // IAGG_SYMBOLS) * step_ms, u % IAGG_SYMBOLS, cnt, s


def run_iagg_cell(dev, seed):
    """Phase 23: the aggregation cell through the public API — TradeAgg
    on DeviceAggregationRuntime, IAGG_CHUNKS chunks of 262,144 events by
    send_batch, then one `per 'seconds'` query inside the clock; every
    row of that query and of a `per 'hours'` one against iagg_reference
    (keys, buckets and counts exact; sums and averages rel <= 1e-5)."""
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.ledger import ledger
    from siddhi_tpu_torch.ops import incremental_agg as ia
    names, chunks = make_iagg_chunks(seed, IAGG_CHUNKS)
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(IAGG_APP)
    agg = rt.aggregations["TradeAgg"]
    if type(agg).__name__ != "DeviceAggregationRuntime":
        raise AssertionError(f"aggregation cell: {type(agg).__name__}")
    rt.start()
    h = rt.get_input_handler("TradeStream")

    def drive():
        t = time.perf_counter()
        for cols, _ki in chunks:
            h.send_batch(cols)
        rows = rt.query(IAGG_QUERY.format(per="seconds"))
        torch.cuda.synchronize()
        return time.perf_counter() - t, rows

    _peak_reset(dev)
    stage0 = dict(ledger().snapshot()["stage_seconds"])
    ia.slab_update.launches = 0           # counts start here
    (wall, rows), per_kernel, dev_us = profile_device(drive)
    launches = ia.slab_update.launches
    stage1 = ledger().snapshot()["stage_seconds"]
    stages = {k: stage1[k] - stage0.get(k, 0.0) for k in stage1}
    peak = torch.cuda.max_memory_allocated(dev)
    hours = rt.query(IAGG_QUERY.format(per="hours"))
    slots = {d: len(agg._slabs[d].pair_of) for d in agg.durations}
    caps = {d: agg._slabs[d].cap for d in agg.durations}
    rt.shutdown()
    n_events = len(chunks) * CHUNK
    res = _cell_report("aggregation cell", n_events, len(chunks), wall,
                       per_kernel, dev_us, stages, launches, IAGG_KERNELS)
    res.update(peak=peak, slots=slots, caps=caps)
    log(f"  slots per duration {slots} (caps {caps}); peak device memory "
        f"{peak} B")
    if launches < len(chunks) * len(slots):
        raise AssertionError(f"K10 launched {launches} times")
    code = {nm: i for i, nm in enumerate(names)}
    for per, got, step in (("seconds", rows, 1000),
                           ("hours", hours, IAGG_HOUR_MS)):
        b, k, c, s = iagg_reference(chunks, step)
        g = np.asarray([(e.data[0], code[e.data[1]]) for e in got], np.int64)
        o = np.lexsort((g[:, 1], g[:, 0])) if len(g) else np.zeros(0, int)
        gv = np.asarray([e.data[2:] for e in got], np.float64)[o]
        if len(g) != len(b) or not (np.array_equal(g[o, 0], b) and
                                    np.array_equal(g[o, 1], k) and
                                    np.array_equal(gv[:, 2], c)):
            raise AssertionError(f"aggregation cell: per '{per}' rows, "
                                 f"buckets, keys or counts differ from the "
                                 f"reference ({len(g)} rows, reference "
                                 f"{len(b)})")
        for j, want in ((1, s), (0, s / c)):
            err = np.abs(gv[:, j] - want) / np.abs(want)
            if not (err <= 1e-5).all():
                raise AssertionError(f"aggregation cell: per '{per}' rel "
                                     f"err {err.max():.3g}")
        log(f"  aggregation cell: per '{per}' {len(b)} rows == float64 "
            f"reference (buckets, keys, counts exact; sums and averages rel "
            f"<= 1e-5)")
        res[f"rows_{per}"] = len(b)
    return res


IAGG_KERNELS = ["iagg_prep", "iagg_pass", "iagg_walk", "iagg_walk_long"]


# ------------------------------------------------------------------ phase 24

JOIN_TABLE = 10_000
JOIN_CHUNK = 16_384
JOIN_WARM = 2
JOIN_CHUNKS = 16
JOIN_CELL_SHAPE = (JOIN_CHUNK, 1 << 14)       # pow2 of the table's 10,000

PROBE_CASES = [
    # (nl2, nr2, nl, nr, density, cap)
    (1, 1, 1, 1, 1.0, 4), (1, 1, 0, 0, 1.0, 4), (1, 1, 1, 1, 0.0, 0),
    (7, 13, 5, 11, 0.5, 64), (8, 16, 8, 16, 1.0, 100),
    (16, 8, 13, 7, 0.5, 50), (32, 48, 20, 33, 0.7, 10_000),
    (64, 64, 33, 50, 0.5, 4096), (1024, 1000, 1000, 999, 0.001, 4096),
    (1024, 1024, 1000, 1000, 0.5, 4096), (2048, 2048, 2047, 1999, 1.0, 4096),
    (4096, 8192, 4000, 8000, 0.0, 4096), (1, 100_000, 1, 99_999, 0.3, 4096),
    (100_000, 1, 99_999, 1, 0.3, 4096),
    (JOIN_CHUNK, 1 << 14, JOIN_CHUNK, JOIN_TABLE, 0.000625, 131_072),
    (JOIN_CHUNK, 1 << 14, JOIN_CHUNK, JOIN_TABLE, 0.000625, 4096),
    (JOIN_CHUNK, 1 << 14, 12_345, 9_999, 0.5, 1 << 20),
    (JOIN_CHUNK, 1 << 14, JOIN_CHUNK, JOIN_TABLE, 1.0, 1 << 16),
]


def check_probe(dev, seed):
    """Phase 24: K11 (probe_compact) against probe_compact_plain on the
    same mask, bit for bit on the indices and the count."""
    import torch
    from siddhi_tpu_torch.ops.join_probe import (probe_compact,
                                                 probe_compact_plain)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 241)
    n_cases = 0
    for nl2, nr2, nl, nr, dens, cap in PROBE_CASES:
        layouts = [torch.bool, torch.uint8]
        if nl2 * nr2 <= 1 << 22:
            layouts.append("unaligned")   # storage one byte past 16
        for dtype in layouts:
            mask = (torch.rand((nl2, nr2), generator=g, device=dev) < dens)
            if dtype == "unaligned":
                store = torch.zeros(nl2 * nr2 + 1, dtype=torch.uint8,
                                    device=dev)
                mask = store[1:].view(nl2, nr2).copy_(mask)
            else:
                mask = mask.to(dtype)
            n_cases += 1
            ki, kc = probe_compact(mask, nl, nr, cap)
            pi, pcnt = probe_compact_plain(mask, nl, nr, cap)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and int(kc) == int(pcnt)
                    and ki.dtype == torch.int32 and kc.dtype == torch.int32):
                raise AssertionError(
                    f"probe_compact != plain at [{nl2}, {nr2}] valid "
                    f"({nl}, {nr}) density {dens} cap {cap} {dtype}: count "
                    f"{int(kc)} vs {int(pcnt)}")
        log(f"  probe_compact == plain  [{nl2}, {nr2}] valid ({nl}, {nr}) "
            f"density {dens} cap {cap}: count {int(kc)}")
    return {"cases": n_cases, "max_abs_err": 0.0}


def join_cell_arrays(rng):
    """samples/tpu_join_performance.py's table: thresholds uniform in [99,
    100), bands 0-7."""
    thr = rng.uniform(99, 100, JOIN_TABLE).astype(np.float32)
    band = rng.integers(0, 8, JOIN_TABLE).astype(np.int64)
    return thr, band


def time_probe(dev, seed):
    """K11 at the join cell's shape on the cell's own mask (a chunk's
    prices against the table), its twin, and the library calls alone
    (nonzero_static and the sum over the valid mask)."""
    import torch
    from siddhi_tpu_torch.ops.join_probe import (probe_compact,
                                                 probe_compact_plain)
    rng = np.random.default_rng(seed + 243)
    thr, band = join_cell_arrays(rng)
    price = rng.uniform(0, 100, JOIN_CHUNK).astype(np.float32)
    nl2, nr2 = JOIN_CELL_SHAPE
    t = torch.zeros(nr2, dtype=torch.float32, device=dev)
    t[:JOIN_TABLE] = torch.tensor(thr, device=dev)
    bd = torch.zeros(nr2, dtype=torch.float32, device=dev)
    bd[:JOIN_TABLE] = torch.tensor(band.astype(np.float32), device=dev)
    p = torch.tensor(price, device=dev)
    mask = ((p[:, None] > t[None, :]) & (bd[None, :] == 3.0)).contiguous()
    _, count = probe_compact_plain(mask, JOIN_CHUNK, JOIN_TABLE, 1)
    count = int(count)
    cap = 4096
    while cap < count:
        cap *= 2
    valid = mask.clone()
    valid[:, JOIN_TABLE:] = False
    flat = valid.reshape(-1)
    n0 = probe_compact.launches
    ms = median_ms(lambda: probe_compact(mask, JOIN_CHUNK, JOIN_TABLE, cap),
                   dev)
    probe_compact.launches = n0
    plain_ms = median_ms(
        lambda: probe_compact_plain(mask, JOIN_CHUNK, JOIN_TABLE, cap), dev)
    lib_ms = median_ms(
        lambda: (torch.nonzero_static(flat, size=cap, fill_value=-1),
                 flat.sum(dtype=torch.int32)), dev)
    # the valid cells read once (the padded columns need not be), the
    # indices written once
    bound = (JOIN_CHUNK * JOIN_TABLE + 4 * min(count, cap)) \
        / PEAK_BYTES_PER_S * 1e3
    log(f"  probe_compact at [{nl2}, {nr2}] valid ({JOIN_CHUNK}, "
        f"{JOIN_TABLE}), {count} matches, cap {cap}: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms; nonzero_static + sum {lib_ms:.4f} ms; bound "
        f"{bound:.6f} ms by bytes, {bound / ms * 100:.2f}% of the bound "
        f"reached)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "shape": {"nl2": nl2, "nr2": nr2, "nl": JOIN_CHUNK,
                      "nr": JOIN_TABLE, "count": count, "cap": cap}}


#: conditions of the fused route's checks (the join cell's first): the
#: string compares and double compares run on i32 lanes
FUSED_STREAMS = """
define stream L (id int, price float, sym string, d double);
define stream R (id int, threshold float, sym string, d double);
"""
FUSED_CONDS = {
    "cell": "L.price > R.threshold and R.id == 3",
    "range": "L.price > R.threshold and L.id == R.id",
    "string_and_double_lanes": "L.sym == R.sym and L.d < R.d",
    "right_arrivals": "L.price < R.threshold and L.sym != R.sym",
    "or_across": "L.price > R.threshold or L.id != R.id",
    "not_across": "not (L.price <= R.threshold) and not (R.id == L.id)",
    "f32_arith": "(L.price + 1.5) * 0.5 > R.threshold / 4.0 or "
                 "L.price / (L.price - 50.0) < -R.threshold or "
                 "L.price - 2.0 >= R.threshold * R.threshold",
    "unary_minus": "-L.price > R.threshold - 100.0",
    "string_consts": "L.sym > 'a' and R.sym <= L.sym and R.sym != 'c'",
    "double_consts": "L.d >= 0.25 and R.d != L.d or R.d < 0.5",
    "deep": "((L.price > R.threshold or L.id == R.id) and "
            "(L.price < R.threshold + 10.0 or L.id > R.id)) or "
            "(not (L.id == 2) and R.threshold >= 50.0 and L.price < 60.0)",
}
FUSED_F32 = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 3.0, 25.0,
                        50.0, -1.5, 99.5, 100.0, 1e-30, -1e30], np.float32)
FUSED_CASES = [
    # (nl2, nr2, nl, nr, cap, row offset): lanes of nl2 rows taken at the
    # offset of a longer lane, as a probe's row blocks are
    (1, 1, 1, 1, 4, 0), (1, 1, 0, 0, 4, 0), (1, 1, 1, 1, 0, 0),
    (8, 16, 5, 16, 7, 0), (64, 32, 61, 29, 10, 0),
    (4, 128, 4, 100, 4096, 12), (1024, 1000, 1000, 999, 4096, 0),
    (2048, 2048, 2047, 1999, 1 << 22, 0), (33, 4096, 33, 4096, 100, 0),
    # a row wider than one tile's words: column tiles
    (3, 1 << 20, 3, 600_000, 1 << 21, 0),
]


def join_runtime_for(cond, device):
    """The join runtime of a join on ``cond`` over FUSED_STREAMS, built on
    ``device`` (its app shut down; its probes stay callable)."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager(device=device).create_siddhi_app_runtime(
        FUSED_STREAMS + f"""
        @info(name='q')
        from L#window.length(5) join R#window.length(5) on {cond}
        select L.id as lid, R.id as rid insert into Out;""")
    jr = rt.query_runtimes["q"].join_runtime
    rt.shutdown()
    return jr


def fused_program(cond):
    """The port's lowered program for a join on ``cond`` (built on the
    CPU: the program does not depend on the device)."""
    jr = join_runtime_for(cond, "cpu")
    if jr.probe_route != "fused":
        raise AssertionError(f"fused route expected for {cond!r}: "
                             f"{jr.probe_route} ({jr.probe_route_reason})")
    return jr.probe_program


def _fused_lane(rng, name, n):
    if name.startswith("__dk"):                   # double key halves
        pool = np.asarray([-2**31, -7, 0, 1, 5, 2**31 - 1], np.int64)
        v = np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                     rng.integers(-2**31, 2**31, n))
        return v.astype(np.int32)
    if name.startswith("__"):                     # string ranks
        return rng.integers(0, 5, n).astype(np.int32)
    if name == "id":
        return rng.integers(0, 5, n).astype(np.float32)
    return np.where(rng.random(n) < 0.6, rng.choice(FUSED_F32, n),
                    rng.uniform(-10, 110, n)).astype(np.float32)


def fused_bound(prog, nl, nr, count, cap):
    """(ms, by): the lanes read once and the indices written, against the
    instructions the cells need at the card's FP32 instruction rate: a
    compare a cell for each atom on a left slot; for an atom that reads
    no left slot, a compare a column for 32 rows (1/32 a cell); the
    and/or/not tree once a 32 cells (an instruction a node)."""
    from siddhi_tpu_torch.plan import join_program as jpg
    nbytes = 4 * (nl * len(prog.lanes[0]) + nr * len(prog.lanes[1])) \
        + 4 * min(count, cap)
    on_left = int((prog.atoms[:, 2] == jpg.K_LSLOT).sum())
    cell_ops = on_left + (prog.n_atoms - on_left + len(prog.tree)) / 32
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nl * nr * cell_ops / PEAK_F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fused(dev, seed):
    """Phase 24: the fused probe (probe_fused) against probe_fused_plain
    on the same CUDA lanes, bit for bit on idx and count: every condition
    of FUSED_CONDS on every case of FUSED_CASES (NaN, +-inf, +-0.0 and
    ties in the lanes; counts past cap; nr not a multiple of 32; row
    blocks; column tiles), and the cell's shape for three of them."""
    import torch
    from siddhi_tpu_torch.ops.join_probe import (probe_fused,
                                                 probe_fused_plain)
    rng = np.random.default_rng(seed + 245)
    n_cases = 0
    cases = list(FUSED_CASES)
    for name, cond in FUSED_CONDS.items():
        prog = fused_program(cond)
        mine = cases + ([(JOIN_CHUNK, 1 << 14, JOIN_CHUNK, JOIN_TABLE,
                          131_072, 0)]
                        if name in ("cell", "f32_arith", "deep") else [])
        for nl2, nr2, nl, nr, cap, off in mine:
            ll = [torch.tensor(_fused_lane(rng, a, nl2 + off),
                               device=dev)[off:] for a in prog.lanes[0]]
            rl = [torch.tensor(_fused_lane(rng, a, nr2), device=dev)
                  for a in prog.lanes[1]]
            ki, kc = probe_fused(prog, ll, rl, nl, nr, nl2, nr2, cap)
            pi, pc = probe_fused_plain(prog, ll, rl, nl, nr, nl2, nr2, cap)
            torch.cuda.synchronize()
            n_cases += 1
            if not (torch.equal(ki, pi) and int(kc) == int(pc) and
                    ki.dtype == torch.int32 and kc.dtype == torch.int32):
                raise AssertionError(
                    f"probe_fused != plain for {name} at [{nl2}, {nr2}] "
                    f"valid ({nl}, {nr}) cap {cap} offset {off}: count "
                    f"{int(kc)} vs {int(pc)}")
        log(f"  probe_fused == plain  {name}: {len(mine)} cases (last "
            f"count {int(kc)})")
    return {"cases": n_cases, "max_abs_err": 0.0}


#: conditions timed at the join cell's shape on the cell's data, each on
#: the route its runtime chose and on the mask route (the runtime's own
#: torch program, then probe_compact); the cell's first.  Arithmetic that
#: reads both sides is outside the fused class: the mask route only
TIMED_CONDS = {
    "cell": FUSED_CONDS["cell"],
    "deep": FUSED_CONDS["deep"],
    "cross_arith": "(L.price + R.threshold) * 0.5 > 25.0 or "
                   "L.price / R.threshold < -1.0 or "
                   "L.price - R.threshold >= 1.0",
}


def _timed_lanes(dev, seed):
    """The join cell's data as lanes at its shape: a chunk's prices and
    ids 0-4 (left); the table's thresholds and bands as R.id (right),
    padded with zeros."""
    import torch
    rng = np.random.default_rng(seed + 243)
    thr, band = join_cell_arrays(rng)
    price = rng.uniform(0, 100, JOIN_CHUNK).astype(np.float32)
    ids = rng.integers(0, 5, JOIN_CHUNK).astype(np.float32)
    left = {"price": torch.tensor(price, device=dev),
            "id": torch.tensor(ids, device=dev)}
    right = {}
    for name, v in (("threshold", thr), ("id", band.astype(np.float32))):
        t = torch.zeros(JOIN_CELL_SHAPE[1], dtype=torch.float32, device=dev)
        t[:JOIN_TABLE] = torch.tensor(v, device=dev)
        right[name] = t
    return left, right


def time_fused(dev, seed, ops):
    """The fused probe at the join cell's shape on the cell's data, beside
    the mask route on the same inputs, for each of TIMED_CONDS: both
    through the join runtime's own probes (``device_probe`` on its route,
    ``mask_probe``), bit for bit against each other where the route is
    fused, at the cap the runtime grows to for the count; the cell's
    plain version; `ops` from count_device_ops."""
    import torch
    from siddhi_tpu_torch.ops.join_probe import (probe_compact, probe_fused,
                                                 probe_fused_plain)
    left, right = _timed_lanes(dev, seed)
    nl2, nr2 = JOIN_CELL_SHAPE
    shape = (JOIN_CHUNK, JOIN_TABLE, nl2, nr2)
    n0 = (probe_fused.launches, probe_compact.launches)
    by_cond = {}
    for name, cond in TIMED_CONDS.items():
        jr = join_runtime_for(cond, dev)
        count = int(jr.mask_probe(left, right, *shape, 1)[1])
        cap = 4096
        while cap < count:
            cap *= 2
        row = {"route": jr.probe_route, "count": count, "cap": cap}
        if jr.probe_route == "fused":
            ki, kc = jr.device_probe(left, right, *shape, cap)
            mi, mc = jr.mask_probe(left, right, *shape, cap)
            torch.cuda.synchronize()
            if not (torch.equal(ki, mi) and int(kc) == int(mc) == count):
                raise AssertionError(f"probe_fused != the mask route for "
                                     f"{name} at the cell's shape")
            row["ms"] = median_ms(
                lambda: jr.device_probe(left, right, *shape, cap), dev)
            row["bound_ms"], row["bound_by"] = fused_bound(
                jr.probe_program, JOIN_CHUNK, JOIN_TABLE, count, cap)
            row["atoms"] = jr.probe_program.n_atoms
        row["mask_route_ms"] = median_ms(
            lambda: jr.mask_probe(left, right, *shape, cap), dev)
        by_cond[name] = row
        fused = (f"fused {row['ms']:.4f} ms (bound {row['bound_ms']:.6f} "
                 f"ms by {row['bound_by']}, "
                 f"{row['bound_ms'] / row['ms'] * 100:.2f}% of it reached)"
                 if "ms" in row else f"route {jr.probe_route} "
                 f"({jr.probe_route_reason})")
        log(f"  {name} at [{nl2}, {nr2}] valid ({JOIN_CHUNK}, {JOIN_TABLE})"
            f", {count} matches, cap {cap}: {fused}; the mask route "
            f"(its torch program + probe_compact) "
            f"{row['mask_route_ms']:.4f} ms")
    cell = by_cond["cell"]
    prog = fused_program(FUSED_CONDS["cell"])
    ll = [left[a] for a in prog.lanes[0]]
    rl = [right[a] for a in prog.lanes[1]]
    probe_fused.launches, probe_compact.launches = n0
    plain_ms = median_ms(lambda: probe_fused_plain(
        prog, ll, rl, *shape, cell["cap"]), dev, n=5)
    ops = ops["probe_fused"]
    log(f"  probe_fused plain version at the cell: {plain_ms:.4f} ms; "
        f"{ops} device operations a probe")
    return {"ms": cell["ms"], "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
            "mask_route_ms": cell["mask_route_ms"], "device_ops": ops,
            "by_condition": by_cond,
            "shape": {"nl2": nl2, "nr2": nr2, "nl": JOIN_CHUNK,
                      "nr": JOIN_TABLE, "count": cell["count"],
                      "cap": cell["cap"], "atoms": cell["atoms"]}}


# ------------------------------------------------------------------ phase 25

JOIN_APP = """
@app:playback
define stream L (id int, price float);
define table T (tid int, threshold float, band int);
define stream Fill (tid int, threshold float, band int);
from Fill insert into T;
@info(name='q')
from L join T on L.price > T.threshold and T.band == 3
select L.id as lid, T.tid as tid
insert into Out;
"""
#: the same join with the condition outside the fused class (price is in
#: [0, 100), so the same pairs): the mask route's main path
JOIN_MASK_APP = JOIN_APP.replace("on L.price > T.threshold",
                                 "on L.price % 100.0 > T.threshold")
JOIN_MASK_CHUNKS = 4
JOIN_KERNELS = {"fused": ["probe_fused_kernel"],
                "mask": ["probe_count", "probe_scan", "probe_scatter"]}


def run_join_cell(dev, seed, route="fused"):
    """Phase 25: samples/tpu_join_performance.py's app at its own sizes
    through the public API — a 10,000-row table, L chunks of 16,384
    events, JOIN_WARM warm-up chunks then JOIN_CHUNKS timed; the query on
    the device probe's fused route; every chunk's output pairs against a
    numpy reference in order (float32 compares, L-major).  With route
    "mask", JOIN_MASK_APP for JOIN_MASK_CHUNKS chunks on the mask route."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    from siddhi_tpu_torch.core.ledger import ledger
    from siddhi_tpu_torch.ops import join_probe as jp
    rng = np.random.default_rng(seed + 25)
    thr, band = join_cell_arrays(rng)
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
        JOIN_APP if route == "fused" else JOIN_MASK_APP)
    qr = rt.query_runtimes["q"]
    jr = qr.join_runtime
    if qr.backend != "device" or jr.device_probe is None:
        raise AssertionError(f"join cell: backend {qr.backend} "
                             f"({qr.backend_reason})")
    if jr.probe_route != route:
        raise AssertionError(f"join cell: route {jr.probe_route} "
                             f"({jr.probe_route_reason}), expected {route}")
    log(f"  route {jr.probe_route}: {jr.probe_route_reason}")
    counter = jp.probe_fused if route == "fused" else jp.probe_compact
    n_chunks = JOIN_CHUNKS if route == "fused" else JOIN_MASK_CHUNKS
    got = []
    rt.add_callback("Out", ColumnarStreamCallback(
        lambda c: got.append((np.array(c.columns["lid"]),
                              np.array(c.columns["tid"])))))
    rt.start()
    rt.get_input_handler("Fill").send_batch(
        {"tid": np.arange(JOIN_TABLE, dtype=np.int64), "threshold": thr,
         "band": band}, timestamps=np.full(JOIN_TABLE, 1_000_000, np.int64))
    h = rt.get_input_handler("L")
    chunks = []
    for ci in range(JOIN_WARM + n_chunks):
        chunks.append({"id": ci * JOIN_CHUNK + np.arange(JOIN_CHUNK,
                                                         dtype=np.int64),
                       "price": rng.uniform(0, 100, JOIN_CHUNK)
                       .astype(np.float32)})
    for ci, cols in enumerate(chunks[:JOIN_WARM]):
        h.send_batch(cols, timestamps=np.full(JOIN_CHUNK, 1_001_000 + ci,
                                              np.int64))
    timed = chunks[JOIN_WARM:]

    def drive():
        t = time.perf_counter()
        for ci, cols in enumerate(timed):
            h.send_batch(cols, timestamps=np.full(
                JOIN_CHUNK, 1_002_000 + ci, np.int64))
        rt.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    _peak_reset(dev)
    stage0 = dict(ledger().snapshot()["stage_seconds"])
    n_warm_out = len(got)
    jp.probe_fused.launches = jp.probe_compact.launches = 0  # counts start
    wall, per_kernel, dev_us = profile_device(drive)
    launches = counter.launches
    other = (jp.probe_compact if route == "fused" else jp.probe_fused) \
        .launches
    stage1 = ledger().snapshot()["stage_seconds"]
    stages = {k: stage1[k] - stage0.get(k, 0.0) for k in stage1}
    peak = torch.cuda.max_memory_allocated(dev)
    cap = jr._probe_cap
    rt.shutdown()
    n_events = len(timed) * JOIN_CHUNK
    res = _cell_report(f"join cell ({route} route)", n_events, len(timed),
                       wall, per_kernel, dev_us, stages, launches,
                       JOIN_KERNELS[route])
    res.update(peak=peak, cap=cap, probes_per_s=launches / wall,
               pairs_per_s=n_events * JOIN_TABLE / wall, route=route)
    log(f"  {launches} probes, {launches / wall:.1f} probes/s "
        f"({n_events * JOIN_TABLE / wall:.4g} pairs/s); cap grew to {cap}; "
        f"peak device memory {peak} B")
    if launches < len(timed) or other:
        raise AssertionError(f"K11 ({route}) launched {launches} times, the "
                             f"other route {other}")
    # every chunk's pairs in order: a chunk's output may arrive in more
    # than one callback, so the rows are joined and cut per chunk
    lid = np.concatenate([a for a, _ in got]) if got else np.zeros(0)
    tid = np.concatenate([b for _, b in got]) if got else np.zeros(0)
    sel = band == 3
    pos = 0
    rows = 0
    for ci, cols in enumerate(chunks):
        m = (cols["price"][:, None] > thr[None, :]) & sel[None, :]
        i, j = np.nonzero(m)
        k = len(i)
        if not (np.array_equal(lid[pos:pos + k], cols["id"][i]) and
                np.array_equal(tid[pos:pos + k], j)):
            raise AssertionError(f"join cell: chunk {ci}'s {k} pairs differ "
                                 f"from the reference")
        pos += k
        rows += k if ci >= JOIN_WARM else 0
    if pos != len(lid):
        raise AssertionError(f"join cell: {len(lid)} rows, reference {pos}")
    log(f"  join cell: {JOIN_WARM + JOIN_CHUNKS} chunks' {pos} pairs == "
        f"numpy reference in order ({n_warm_out} warm-up callbacks)")
    res["rows"] = rows
    return res


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ phase 26

GANG_P = 2048
GANG_K = 8
GANG_BLOCKS = 3


def _gang_simple(thr, within=" within 10 sec"):
    return (_S3 + f"from every e1=S[kind == 0 and price > {thr}] -> "
            f"e2=S[kind == 1 and price > e1.price]{within} select "
            f"e1.price as p1, e2.price as p2 insert into Out;")


#: the gang checks' buckets (name: app, T): tenants of one K and one
#: egress width; thresholds, T and `within` differ.  The first mixes the
#: simple units' template instance with the absent units' (one step
#: launch each); one tenant never closes its partials (its ring
#: overflows), one has no pending block in the second flush, one runs
#: with one scratch row a CTA (a full segment) and one with a cap below
#: its count
GANG_BUCKETS = {
    "simple + absent (two instances)": {
        "thr 20": (_gang_simple(20.0), 48),
        "thr 50, cap below count": (_gang_simple(50.0), 64),
        "thr 80, no within": (_gang_simple(80.0, ""), 17),
        "overflow": (_S3 + "from every e1=S[price > 0.0] -> e2=S[kind == 1 "
                     "and price > 99.9] select e1.price as p1, e2.price as "
                     "p2 insert into Out;", 64),
        "absent trailing, one scratch row": (
            WIDE_CASES["absent trailing (config 3)"], 32),
        "absent trailing thr 80": (
            WIDE_CASES["absent trailing (config 3)"].replace(
                "price > 50.0", "price > 80.0", 1), 40),
    },
    "kleene counts": {
        "count thr 50": (WIDE_CASES["count mid-chain"], 40),
        "count thr 30": (WIDE_CASES["count mid-chain"].replace(
            "price > 50.0", "price > 30.0", 1), 64),
        "count thr 70": (WIDE_CASES["count mid-chain"].replace(
            "price > 50.0", "price > 70.0", 1), 23),
    },
    # the widened template instance beside the simple units' one, and a
    # bucket of widened tenants alone (a tenant named "telemetry" carries
    # the telem leaf)
    "simple + widened (two instances)": {
        "thr 20": (_gang_simple(20.0), 48),
        "sequence": (
            _S3 + "from every e1=S[kind == 0 and price > 50.0], e2=S[kind "
            "== 1 and price > e1.price] within 10 sec select e1.price as "
            "p1, e2.price as p2 insert into Out;", 64),
        "trailing every": (
            _S3 + "from every e1=S[kind == 0 and price > 60.0] -> every "
            "e2=S[kind == 1 and price > e1.price] within 5 sec select "
            "e1.price as p1, e2.price as p2 insert into Out;", 40),
        "leading absent, cap below count": (
            _S3 + "from every not S[kind == 1 and price > 90.0] for 2 sec -> "
            "e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 and price > "
            "e1.price] within 10 sec select e1.price as p1, e2.price as p2 "
            "insert into Out;", 64),
        "telemetry thr 50": (_gang_simple(50.0), 33),
    },
    "widened alone": {
        "sequence 3": (
            _S3 + "from every e1=S[kind == 0 and price > 50.0], e2=S[kind "
            "== 1 and price > e1.price], e3=S[kind == 0] within 10 sec "
            "select e1.price as p1, e2.price as p2, e3.price as p3 insert "
            "into Out;", 64),
        "every group": (
            _S3 + "from every (e1=S[kind == 0 and price > 50.0] -> e2=S["
            "kind == 1]) -> e3=S[kind == 0 and price > e1.price] within 10 "
            "sec select e1.price as p1, e2.price as p2, e3.price as p3 "
            "insert into Out;", 48),
        "mid every, one scratch row": (
            _S3 + "from e1=S[kind == 0] -> every e2=S[kind == 1 and price > "
            "e1.price] -> e3=S[kind == 0 and price < e2.price] within 10 "
            "sec select e1.price as p1, e2.price as p2, e3.price as p3 "
            "insert into Out;", 64),
        "capture to constant": (
            _S3 + "from every e1=S[kind == 0] -> e2=S[kind == 1 and e1.price "
            "> 40.0 and price > e1.price] -> e3=S[kind == 0 and 70.0 >= "
            "e2.price] within 10 sec select e1.price as p1, e2.price as p2, "
            "e3.price as p3 insert into Out;", 40),
    },
    # condition programs ride each tenant's static table: tenants of the
    # simple instance (programs outside unit 0) beside a widened one
    "condition programs": {
        "ratio 1.05": (CLASS_CASES["program: ratio (Quick start)"], 48),
        "ratio 1.02, cap below count": (
            CLASS_CASES["program: ratio (Quick start)"].replace(
                "1.05", "1.02"), 64),
        "offset": (CLASS_CASES["program: offset"], 40),
        "a constant over a lane, one scratch row": (
            CLASS_CASES["program: unary minus, a constant over a lane"], 33),
        "SEQUENCE ratio": (CLASS_CASES["program: SEQUENCE ratio"], 64),
    },
}
GANG_IDLE = {"thr 80, no within", "count thr 30",   # idle in flush 1
             "trailing every", "every group"}


def _gang_launches():
    from siddhi_tpu_torch.ops.nfa import (nfa_compact, nfa_gang_compact,
                                          nfa_gang_step_egress,
                                          nfa_step_egress)
    return (nfa_gang_step_egress.launches, nfa_gang_compact.launches,
            nfa_step_egress.launches, nfa_compact.launches)


def _set_gang_launches(v=(0, 0, 0, 0)):
    from siddhi_tpu_torch.ops.nfa import (nfa_compact, nfa_gang_compact,
                                          nfa_gang_step_egress,
                                          nfa_step_egress)
    (nfa_gang_step_egress.launches, nfa_gang_compact.launches,
     nfa_step_egress.launches, nfa_compact.launches) = v


def _slab_err(got, want, cap) -> float:
    """The largest absolute difference over what _slab_equal compares
    (int32 words)."""
    n = min(int(want[cap, 0]), cap)
    return max(_abs_err(got[:n], want[:n]),
               _abs_err(got[n:cap, 0], want[n:cap, 0]),
               _abs_err(got[cap], want[cap]))


def _carry_err(got, want, what) -> float:
    """Every leaf of `want` bit for bit in `got` (else AssertionError
    naming `what` and the leaf); returns the largest absolute difference
    over the leaves."""
    err = 0.0
    for leaf in want:
        if not _same_bits(got[leaf], want[leaf]):
            raise AssertionError(f"{what}: carry.{leaf} differs")
        err = max(err, _abs_err(got[leaf], want[leaf]))
    return err


def gang_buckets():
    """check_gang's buckets: (name, P, value range, {tenant: (app, T)});
    GANG_BUCKETS at P = GANG_P, then the unkeyed service cell's bucket
    shape: 32 of its apps (thresholds 0.0 to 0.45) at P = 1 and T =
    TENANT_EVENTS[False], values in [0, 1) as the cell feeds them."""
    out = [(g, GANG_P, 100.0, m) for g, m in GANG_BUCKETS.items()]
    out.append(("unkeyed service (32 tenants, P = 1)", 1, 1.0,
                {f"mt{i}": (mtenant_app(i, False), TENANT_EVENTS[False])
                 for i in range(32)}))
    return out


def check_gang(dev, seed):
    """The gang kernels (nfa_gang_step + nfa_gang_compact through
    ops/nfa.nfa_gang_step_egress) against the plain twin
    (nfa_gang_step_egress_plain) and against each tenant stepped alone
    through nfa_step_egress, on the card, over GANG_BLOCKS chained
    flushes per bucket: every carry leaf bit for bit, each tenant's egress
    by the slab contract and its status row; a full scratch segment is
    re-run alone with segments that fit and a count above cap re-packed
    alone, as the engine does.  Returns (flushes checked, step launches
    of each flush, the largest absolute difference over every carry leaf
    and slab compared)."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (GangTenant, nfa_gang_step_egress,
                                          nfa_gang_step_egress_plain,
                                          nfa_step_egress)
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    saved = _gang_launches()
    flushes, per_flush, err = 0, [], 0.0
    for gi, (gname, P, hi, members) in enumerate(gang_buckets()):
        nfas, feeds = {}, {}
        for i, (name, (app, T)) in enumerate(members.items()):
            nfa = CompiledPatternNFA(app, n_partitions=P, n_slots=GANG_K,
                                     device=dev,
                                     telemetry=name.startswith("telemetry"))
            nfas[name] = nfa
            feeds[name] = _nfa_blocks(nfa, P, T, GANG_BLOCKS,
                                      seed + 31 * gi + i, dev, gap=300,
                                      hi=hi)
        carries = {n: nfas[n].carry for n in members}
        stats = {n: [0, 0, 0, 0] for n in members}  # matches, reruns,
        for b in range(GANG_BLOCKS):                # repacks, dropped
            live = [n for n in members if not (b == 1 and n in GANG_IDLE)]
            # caps from the counts of the plain composition (a cap below
            # the count for one tenant; 1024 for the rest)
            probe = [GangTenant(nfas[n].spec, carries[n], feeds[n][b],
                                nfas[n].kprog, 1 << 20) for n in live]
            p_news, p_ge = nfa_gang_step_egress_plain(probe)
            counts = {n: int(p_ge.egress[j].buf[-2, 0])
                      for j, n in enumerate(live)}
            caps = {n: (max(counts[n] // 2, 1) if "cap below" in n
                        else 1024) for n in live}
            tenants = [GangTenant(nfas[n].spec, carries[n], feeds[n][b],
                                  nfas[n].kprog, caps[n],
                                  1 if "scratch" in n else None)
                       for n in live]
            l0 = _gang_launches()[0]
            news, ge = nfa_gang_step_egress(tenants)
            per_flush.append(_gang_launches()[0] - l0)
            _, pg = nfa_gang_step_egress_plain(tenants)
            torch.cuda.synchronize()
            for j, (n, t) in enumerate(zip(live, tenants)):
                one_new, one = nfa_step_egress(t.spec, t.carry, t.block,
                                               t.kprog, t.cap, t.seg)
                for got, who in ((news[j], "gang"), (one_new, "alone")):
                    err = max(err, _carry_err(
                        got, p_news[j], f"gang {who} != plain: {gname} / "
                        f"{n} (flush {b})"))
                gbuf = ge.egress[j].buf
                if not torch_equal(gbuf[-1], one.buf[-1]):
                    raise AssertionError(f"gang status row != alone: {n}")
                err = max(err, _abs_err(gbuf[-1], one.buf[-1]))
                if int(gbuf[-1, 0]) > int(gbuf[-1, 1]):
                    # a full segment: the engine re-runs this tenant alone
                    stats[n][1] += 1
                    _, re = nfa_step_egress(t.spec, t.carry, t.block,
                                            t.kprog, t.cap,
                                            _next_pow2(int(gbuf[-1, 0])))
                    gbuf = re.buf
                    repack = re.repack
                else:
                    repack = ge.egress[j].repack
                    if not _slab_equal(gbuf, one.buf, t.cap):
                        raise AssertionError(f"gang slab != alone: {n}")
                    err = max(err, _slab_err(gbuf, one.buf, t.cap))
                want = pg.egress[j]
                if not _slab_equal(gbuf, want.buf, t.cap) or \
                        int(gbuf[t.cap, 0]) != counts[n]:
                    raise AssertionError(f"gang slab != plain: {gname} / "
                                         f"{n} (flush {b})")
                err = max(err, _slab_err(gbuf, want.buf, t.cap))
                if counts[n] > t.cap:
                    c = _next_pow2(counts[n])
                    stats[n][2] += 1
                    got, ref = repack(c), want.repack(c)
                    if not _slab_equal(got, ref, c):
                        raise AssertionError(f"gang repack != plain: {n}")
                    err = max(err, _slab_err(got, ref, c))
                stats[n][0] += counts[n]
                carries[n] = news[j]
            flushes += 1
        for n, (m, reruns, repacks, _d) in stats.items():
            dropped = int(carries[n]["dropped"].sum())
            if n == "overflow" and dropped == 0:
                raise AssertionError("the overflow tenant dropped nothing")
            if dev == "cuda" and "scratch" in n and reruns == 0:
                raise AssertionError(f"{n}: no segment filled up")
            if "cap below" in n and repacks == 0:
                raise AssertionError(f"{n}: no count passed its cap")
            if m == 0:
                raise AssertionError(f"{gname} / {n}: no match")
        if len(members) > 8:
            log(f"  gang == plain == alone  {gname}: {len(members)} tenants, "
                f"P={P} K={GANG_K} T={sorted({v[1] for v in members.values()})}"
                f" matches={sum(v[0] for v in stats.values())}")
            continue
        for n, (m, reruns, repacks, _d) in stats.items():
            log(f"  gang == plain == alone  {gname} / {n}: P={P} "
                f"K={GANG_K} T={members[n][1]} matches={m} dropped="
                f"{int(carries[n]['dropped'].sum())} segment re-runs="
                f"{reruns} re-packs={repacks}")
    _set_gang_launches(saved)
    log(f"  step launches a flush: {per_flush} (one a template instance "
        f"present); largest abs difference {err}")
    return flushes, per_flush, err


def mtenant_app(i: int, keyed: bool) -> str:
    """bench.py's _mtenant_app (`:1153-1166`): one tiny tenant, its own
    threshold; keyed: the same query in `partition with (k of S)` with
    TENANT_KEYS lanes declared."""
    thr = round(0.05 * (i % 10), 2)
    q = (f"@info(name='q') from every e1=S[v > {thr}] -> e2=S[v > e1.v] "
         "select e1.v as a, e2.v as b insert into Out;")
    if keyed:
        return (f"@app:name('mt{i}') @app:pipeline('4') "
                f"@app:lanes('{TENANT_KEYS}') "
                "define stream S (k int, v double); "
                f"partition with (k of S) begin {q} end;")
    return (f"@app:name('mt{i}') @app:pipeline('4') "
            f"define stream S (k int, v double); {q}")


N_TENANTS = 100
TENANT_KEYS = 1024
TENANT_EVENTS = {False: 8, True: 16_384}    # events a tenant a round
#: rounds a cell (the keyed cell's cut from 8 to pay for the condition
#: programs' checks)
TENANT_ROUNDS = {False: 4, True: 4}


def profile_ops(fn):
    """fn under torch.profiler: (result, {kernel or copy: (device us,
    count)}), or (result, None) when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as e:   # noqa: BLE001 — measurement only
        log(f"  torch.profiler unavailable ({type(e).__name__}: {e})")
        return fn(), None
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
            a, c = per.get(ev.key, (0.0, 0))
            per[ev.key] = (a + float(us), c + ev.count)
    return res, (per or None)


def _packer_rows():
    from siddhi_tpu_torch.plan.xtenant import tenant_packer
    return [b for b in tenant_packer().snapshot()["buckets"]
            if any(t.startswith("mt") for t in b["tenants"])]


def run_tenant_service(dev, seed, keyed, packed):
    """N_TENANTS tenant apps through the public API, round-robin: one
    warm round, then `rounds` measured rounds of one block a tenant
    (the last profiled).  Returns rows per tenant (ts, a, b sorted),
    the wall per measured round, and the counters of the measured
    rounds: gang step and compaction launches (one compaction a bucket
    flush), per-tenant step launches, and the last round's device
    operations by kind (the D2H reads among them)."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    rounds = TENANT_ROUNDS[keyed]
    events = TENANT_EVENTS[keyed]
    prev = os.environ.get("SIDDHI_TPU_XTENANT")
    os.environ["SIDDHI_TPU_XTENANT"] = "1" if packed else "0"
    try:
        mgr = SiddhiManager(device=dev)
        got = [{"ts": [], "a": [], "b": []} for _ in range(N_TENANTS)]
        rts = []
        t_build = time.perf_counter()
        for i in range(N_TENANTS):
            rt = mgr.create_siddhi_app_runtime(mtenant_app(i, keyed))

            def sink(chunk, _g=got[i]):
                _g["ts"].append(np.array(chunk.timestamps))
                _g["a"].append(np.array(chunk.columns["a"]))
                _g["b"].append(np.array(chunk.columns["b"]))
            rt.add_callback("Out", ColumnarStreamCallback(sink))
            rt.start()
            rts.append(rt)
        t_build = time.perf_counter() - t_build
        handlers = [rt.get_input_handler("S") for rt in rts]
        rng = np.random.default_rng(seed + 11)
        t = [1_000_000]

        def feed(n_rounds):
            for _ in range(n_rounds):
                for h in handlers:
                    k = (rng.integers(0, TENANT_KEYS, events) if keyed
                         else np.arange(events) % 4).astype(np.int64)
                    h.send_batch({"k": k, "v": rng.uniform(0.0, 1.0,
                                                           events)},
                                 timestamps=t[0] + np.arange(
                                     events, dtype=np.int64))
                t[0] += events

        feed(1)                                   # fills the pipelines
        for rt in rts:
            rt.flush()
        torch.cuda.synchronize()
        _set_gang_launches()
        t0 = time.perf_counter()
        feed(rounds - 1)
        _, per = profile_ops(lambda: feed(1))
        for rt in rts:
            rt.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _gang_launches()
        labels = sorted({b["bucket"] for b in _packer_rows()})
        mgr.shutdown()
    finally:
        if prev is None:
            os.environ.pop("SIDDHI_TPU_XTENANT", None)
        else:
            os.environ["SIDDHI_TPU_XTENANT"] = prev
    rows = []
    for g in got:
        if not g["ts"]:
            rows.append(np.zeros((0, 3)))
            continue
        r = np.stack([np.concatenate(g["ts"]).astype(np.float64),
                      np.concatenate(g["a"]), np.concatenate(g["b"])], 1)
        rows.append(r[np.lexsort(r.T[::-1])])
    ops = None
    if per is not None:
        ops = {"kernels": sum(c for k, (_u, c) in per.items()
                              if "Memcpy" not in k and "Memset" not in k),
               "h2d": sum(c for k, (_u, c) in per.items() if "HtoD" in k),
               "d2h": sum(c for k, (_u, c) in per.items() if "DtoH" in k),
               "other": sum(c for k, (_u, c) in per.items()
                            if "Memset" in k or "DtoD" in k),
               "device_ms": sum(u for u, _c in per.values()) / 1e3,
               "gang_ms": sum(u for k, (u, _c) in per.items()
                              if is_kernel(k, "nfa_gang_step_kernel") or
                              is_kernel(k, "nfa_gang_compact_kernel"))
               / 1e3,
               "flushes": sum(c for k, (_u, c) in per.items()
                              if is_kernel(k, "nfa_gang_compact_kernel"))}
    return {"rows": rows, "wall_per_round": wall / rounds,
            "build_s": t_build, "launches": launches,
            "flushes": launches[1], "buckets": labels,
            "ops_last_round": ops,
            "matches": int(sum(len(r) for r in rows))}


def _rows_equal(x, y) -> bool:
    return len(x) == len(y) and all(
        a.shape == b.shape and np.array_equal(a, b) for a, b in zip(x, y))


def run_tenant_cell(dev, seed, keyed):
    """The service cell packed and with SIDDHI_TPU_XTENANT=0, in turns
    (packed, unpacked, unpacked, packed): every tenant's rows equal as
    multisets across all four; the packed runs' counters per flush."""
    name = "keyed" if keyed else "unkeyed"
    runs = [run_tenant_service(dev, seed, keyed, p)
            for p in (True, False, False, True)]
    for r in runs[1:]:
        if not _rows_equal(r["rows"], runs[0]["rows"]):
            raise AssertionError(f"tenant cell ({name}): packed rows != "
                                 f"SIDDHI_TPU_XTENANT=0 rows")
    if runs[0]["matches"] == 0:
        raise AssertionError(f"tenant cell ({name}): no match")
    p, u = runs[0], runs[1]
    g_launch, g_compact, t_launch, t_compact = p["launches"]
    if dev == "cuda" and (g_launch == 0 or g_compact == 0):
        raise AssertionError(f"tenant cell ({name}): the gang kernels were "
                             f"not launched on the main path")
    if u["launches"][0] or (dev == "cuda" and u["launches"][2] == 0):
        raise AssertionError(f"tenant cell ({name}): the unpacked run "
                             f"did not step per tenant")
    fl = max(p["flushes"], 1)
    ops = p["ops_last_round"]
    lf = max(ops["flushes"], 1) if ops else 1
    out = {"tenants": N_TENANTS, "events_per_tenant_round":
           TENANT_EVENTS[keyed], "rounds": TENANT_ROUNDS[keyed],
           "buckets": p["buckets"], "matches": p["matches"],
           "flushes": p["flushes"],
           "gang_step_launches_per_flush": g_launch / fl,
           "gang_compact_launches_per_flush": g_compact / fl,
           "tenant_step_launches_packed": t_launch,
           "d2h_per_flush": ops["d2h"] / lf if ops else None,
           "device_ops_per_flush": ({k: ops[k] / lf for k in
                                     ("kernels", "h2d", "d2h", "other")}
                                    if ops else None),
           "wall_per_round_s": {"packed": [runs[0]["wall_per_round"],
                                           runs[3]["wall_per_round"]],
                                "unpacked": [runs[1]["wall_per_round"],
                                             runs[2]["wall_per_round"]]},
           "ops_last_round": {"packed": p["ops_last_round"],
                              "unpacked": u["ops_last_round"]},
           "launches": g_launch, "compact_launches": g_compact}
    log(f"  {name} tenant cell: {N_TENANTS} apps x "
        f"{TENANT_EVENTS[keyed]} events a round, buckets "
        f"{p['buckets']}, {p['matches']} matches, rows equal packed == "
        f"unpacked (4 runs in turns)")
    log(f"    per flush: {out['gang_step_launches_per_flush']:.3f} gang "
        f"step launches, {out['gang_compact_launches_per_flush']:.3f} "
        f"compaction launches ({p['flushes']} flushes; {t_launch} "
        f"per-tenant step launches packed: grow-and-replay and segment "
        f"re-runs); device operations a flush (last round) "
        f"{out['device_ops_per_flush']}, D2H reads a flush "
        f"{out['d2h_per_flush']}")
    log(f"    last round's device operations, packed: {ops}; unpacked: "
        f"{u['ops_last_round']}")
    log(f"    wall per round (s): packed {out['wall_per_round_s']['packed']}"
        f", unpacked {out['wall_per_round_s']['unpacked']}; apps built in "
        f"{p['build_s']:.2f} s")
    return out


def time_gang(dev, seed):
    """The gang at the keyed cell's shape: one bucket of 32 tenants (the
    cell's apps, P = TENANT_KEYS, a block of TENANT_EVENTS[True] events a
    tenant on a carry in steady state, caps and segments the engine
    settles on).  Median ms of the gang call (gate words, descriptor
    copy, step, compaction) by CUDA events, of the compaction alone, of
    the plain twin and the plain compaction; the device split by kernel;
    the host's enqueue split; the bounds: the sum of the tenants' fused
    step (K2 + K4) bounds, and of their compaction bounds."""
    import torch
    from siddhi_tpu_torch.ops.nfa import (GangTenant, egress_pack_plain,
                                          kernel_gate_word, kernel_geometry,
                                          nfa_block_step_plain,
                                          nfa_gang_step_egress,
                                          nfa_gang_step_egress_plain)
    from siddhi_tpu_torch.ops.pack import pack_blocks
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    saved = _gang_launches()
    P, K, n_t = TENANT_KEYS, GANG_K, 32
    rng = np.random.default_rng(seed + 5)
    nfas = [CompiledPatternNFA(mtenant_app(i, False), n_partitions=P,
                               n_slots=K, device=dev) for i in range(n_t)]

    def block(nfa, t0):
        n = TENANT_EVENTS[True]
        pids = rng.integers(0, P, n)
        cols = {"v": rng.uniform(0.0, 1.0, n), "k": pids.astype(np.float64)}
        return nfa.to_device(pack_blocks(
            pids, {a: cols[a] for a in nfa.attr_names},
            t0 + np.arange(n, dtype=np.int64), np.zeros(n, np.int32), P,
            base_ts=0))

    warm = [block(n, 0) for n in nfas]
    blks = [block(n, TENANT_EVENTS[True]) for n in nfas]
    carries, _ = nfa_gang_step_egress(
        [GangTenant(n.spec, n.carry, b, n.kprog) for n, b in
         zip(nfas, warm)])
    _, ge = nfa_gang_step_egress(
        [GangTenant(n.spec, c, b, n.kprog) for n, c, b in
         zip(nfas, carries, blks)])
    counts = [int(e.buf[-2, 0]) for e in ge.egress]
    caps = [_next_pow2(c) for c in counts]
    segs = [max(e.seg, _next_pow2(int(e.buf[-1, 0]))) for e in ge.egress]
    tenants = [GangTenant(n.spec, c, b, n.kprog, cap, seg) for
               n, c, b, cap, seg in zip(nfas, carries, blks, caps, segs)]
    news, ge = nfa_gang_step_egress(tenants)
    plain = []
    plain_ms = median_ms(
        lambda: plain.append(nfa_gang_step_egress_plain(tenants)), dev, n=1)
    # the timed call held against the plain twin: every tenant's carry
    # leaves bit for bit, its slab by the egress contract
    p_news, p_ge = plain[-1]
    err = 0.0
    for j, t in enumerate(tenants):
        err = max(err, _carry_err(news[j], p_news[j],
                                  f"gang at the keyed shape, tenant {j}"))
        gbuf, want = ge.egress[j].buf, p_ge.egress[j].buf
        if int(gbuf[-1, 0]) > int(gbuf[-1, 1]) or \
                not _slab_equal(gbuf, want, t.cap):
            raise AssertionError(f"gang at the keyed shape, tenant {j}: "
                                 f"slab != plain (status {gbuf[-1].tolist()})")
        err = max(err, _slab_err(gbuf, want, t.cap))
    del plain, p_news, p_ge
    log(f"  gang == plain at the keyed cell's shape: {n_t} tenants' carries "
        f"and slabs, largest abs difference {err}")
    # the gang's host enqueue (tens of torch ops a tenant): a long sleep
    # keeps it off the events' clock
    ms = median_ms(lambda: nfa_gang_step_egress(tenants), dev,
                   sleep_cycles=40 * SLEEP_CYCLES)
    compact_ms = median_ms(ge.compact, dev)
    outs = [nfa_block_step_plain(t.spec, t.carry, t.block) for t in tenants]

    def plain_compact():
        return torch.cat([egress_pack_plain(
            t.spec, *o[1], o[0]["dropped"], cap=t.cap)
            for t, o in zip(tenants, outs)])
    plain_compact_ms = median_ms(plain_compact, dev, n=5)
    _, per = profile_ops(lambda: [nfa_gang_step_egress(tenants)
                                  for _ in range(5)])
    split = None
    if per is not None:
        step = sum(u for k, (u, c) in per.items()
                   if is_kernel(k, "nfa_gang_step_kernel")) / 5e3
        comp = sum(u for k, (u, c) in per.items()
                   if is_kernel(k, "nfa_gang_compact_kernel")) / 5e3
        rest = sum(u for u, c in per.values()) / 5e3 - step - comp
        split = {"step_ms": step, "compact_ms": comp, "other_ms": rest,
                 "ops_a_call": {k[:60]: c / 5 for k, (u, c) in
                                per.items()}}
    # the host's enqueue of one gang call, the card asleep: the tenants'
    # gate words alone, then the whole call
    torch.cuda.synchronize()
    torch.cuda._sleep(200 * SLEEP_CYCLES)
    h0 = time.perf_counter()
    for t in tenants:
        kernel_gate_word(t.spec, t.kprog, t.block)
    h1 = time.perf_counter()
    nfa_gang_step_egress(tenants)
    h2 = time.perf_counter()
    torch.cuda.synchronize()
    bound = sum(nfa_bound(P, int(t.block["__ts"].shape[1]), K, t.spec,
                          t.kprog, max(len(c) for c in t.kprog.cmp), cnt,
                          t.cap)[0] for t, cnt in zip(tenants, counts))
    W = 4 + max(nfas[0].spec.n_rows, 1) * max(nfas[0].spec.n_caps, 1)
    L = kernel_geometry(K)[1]
    cbound = sum(compact_bound(P, -(-P // L), cnt, t.cap, W)[0]
                 for t, cnt in zip(tenants, counts))
    _set_gang_launches(saved)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "max_abs_err": err, "compact_ms": compact_ms,
            "plain_compact_ms": plain_compact_ms,
            "compact_bound_ms": cbound, "split": split,
            "host_ms": {"gate_words": (h1 - h0) * 1e3,
                        "gang_call": (h2 - h1) * 1e3},
            "shape": {"tenants": n_t, "P": P, "K": K,
                      "T": [int(t.block["__ts"].shape[1])
                            for t in tenants][:4],
                      "matches": sum(counts), "caps": sorted(set(caps))}}


# ------------------------------------------------------------------ phase 27

SHARD_N = 4
SHARD_PATTERN_CHUNKS = 4
SHARD_WAGG_QUERIES = 4
SHARD_CHUNKS = 2


def _canon(cols: dict) -> dict:
    """One output stream's rows in a canonical order (lexsort over its
    numeric columns, the timestamp last), as arrays."""
    num = [k for k, v in cols.items() if v.dtype != object and k != "ts"]
    order = np.lexsort([cols[k] for k in reversed(num)] + [cols["ts"]])
    return {k: v[order] for k, v in cols.items()}


def _shard_drive(app, chunks, dev, shards, store=None, restore=False):
    """Run `app` over `chunks` with SIDDHI_TPU_SHARDS=shards; returns
    ({stream: canonical rows}, runtime statistics' shard rows, wall s,
    kernel launches).  With a store: persist at the end (restore=False)
    or restore the last revision first (restore=True)."""
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    os.environ["SIDDHI_TPU_SHARDS"] = str(shards)
    try:
        mgr = SiddhiManager(device=dev)
        if store is not None:
            mgr.set_persistence_store(store)
        rt = mgr.create_siddhi_app_runtime(app)
        got = {}

        def sink(sid):
            def fn(chunk):
                d = got.setdefault(sid, {"ts": []})
                d["ts"].append(np.array(chunk.timestamps))
                for k, v in chunk.columns.items():
                    d.setdefault(k, []).append(np.array(v))
            return fn
        for sid in list(rt.junctions):
            if sid.startswith("Out"):
                rt.add_callback(sid, ColumnarStreamCallback(sink(sid)))
        rt.start()
        if restore:
            rt.restore_last_revision()
        h = rt.get_input_handler("S")
        from siddhi_tpu_torch.ops.grouped_agg import grouped_step
        from siddhi_tpu_torch.ops.nfa import nfa_step_egress
        from siddhi_tpu_torch.ops.windowed_agg import wagg_step
        l0 = (nfa_step_egress.launches, wagg_step.launches,
              grouped_step.launches)
        t0 = time.perf_counter()
        for c in chunks:
            h.send_batch(c[0], timestamps=c[1])
        rt.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(b - a for a, b in zip(l0, (
            nfa_step_egress.launches, wagg_step.launches,
            grouped_step.launches)))
        stats = rt.statistics.get("shards")
        if store is not None and not restore:
            rt.persist()
        mgr.shutdown()
    finally:
        os.environ.pop("SIDDHI_TPU_SHARDS", None)
    rows = {sid: {k: np.concatenate(v) for k, v in d.items()}
            for sid, d in got.items()}
    return rows, stats, wall, launches


def run_shard_cell(name, app, chunks, dev, key_col):
    """The app unsharded, then with SHARD_N shards in two runtimes: the
    first half of the chunks, persist, shut down; a new runtime restores
    and takes the second half.  The sharded rows (both halves) must equal
    the unsharded rows as multisets; the /stats shard rows must hold
    SHARD_N shards on the card, every key of the first half once, every
    event once; the kernels of the path must have run."""
    from siddhi_tpu_torch.core.snapshot import InMemoryPersistenceStore
    h = len(chunks) // 2
    mono, _s, wall0, _l = _shard_drive(app, chunks, dev, 0)
    store = InMemoryPersistenceStore()
    a, stats, wall_a, la = _shard_drive(app, chunks[:h], dev, SHARD_N,
                                        store)
    b, _s2, wall_b, lb = _shard_drive(app, chunks[h:], dev, SHARD_N, store,
                                      restore=True)
    if not stats:
        raise AssertionError(f"shard cell {name}: no shard rows in /stats")
    keys = len(np.unique(np.concatenate(
        [np.asarray(c[0][key_col]).astype(str) for c in chunks[:h]])))
    n_ev = sum(len(c[1]) for c in chunks[:h])
    want_dev = ({"cuda:0"} if dev == "cuda" else
                {f"cpu:{i}" for i in range(SHARD_N)})
    for label, rows in stats.items():
        if len(rows) != SHARD_N or \
                {r["device"] for r in rows} != want_dev or \
                sum(r["keys"] for r in rows) != keys or \
                sum(r["events"] for r in rows) != n_ev or \
                min(r["keys"] for r in rows) == 0:
            raise AssertionError(f"shard cell {name}: /stats rows of "
                                 f"{label} wrong: {rows}")
    if dev == "cuda" and (not any(la) or not any(lb)):
        raise AssertionError(f"shard cell {name}: no kernel launched "
                             f"({la}, {lb})")
    n_rows = 0
    for sid, want in mono.items():
        got = {k: np.concatenate([a.get(sid, {}).get(k, v[:0]),
                                  b.get(sid, {}).get(k, v[:0])])
               for k, v in want.items()}
        x, y = _canon(got), _canon(want)
        for k in want:
            eq = (np.array_equal(x[k], y[k], equal_nan=True)
                  if y[k].dtype != object else
                  bool((x[k] == y[k]).all()) and len(x[k]) == len(y[k]))
            if not eq:
                raise AssertionError(f"shard cell {name}: {sid}.{k} "
                                     f"sharded != unsharded")
        n_rows += len(want["ts"])
    if n_rows == 0:
        raise AssertionError(f"shard cell {name}: no rows")
    log(f"  shard cell {name}: {SHARD_N} shards on {sorted(want_dev)}, "
        f"{n_rows} rows "
        f"over {len(mono)} streams equal the unsharded run's as multisets "
        f"across a persist/restore after chunk {h} of {len(chunks)}; "
        f"/stats rows {[(r['shard'], r['keys'], r['events']) for r in next(iter(stats.values()))]}; "
        f"wall {wall0:.3f} s unsharded, {wall_a + wall_b:.3f} s sharded "
        f"(launches nfa/wagg/gagg {tuple(x + y for x, y in zip(la, lb))})")
    return {"rows": n_rows, "wall_unsharded_s": wall0,
            "wall_sharded_s": wall_a + wall_b, "stats": stats}



# ------------------------------------------------------------------ phase 28

#: phase 28's queries on the pattern cell's stream and partition: each a
#: widened kind of the NFA step's class, (query, output columns)
CLASS_APPS = {
    "sequence": (
        "from every e1=S[kind == 0 and price > 50.0], e2=S[kind == 1 and "
        "price > e1.price], e3=S[kind == 2] within 10 sec select e1.price "
        "as p1, e2.price as p2, e3.price as p3 insert into Out;",
        ("p1", "p2", "p3")),
    "logical, trailing every": (
        "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind == 1 and "
        "price > e1.price] or e3=S[kind == 2 and price < e1.price]) -> "
        "every e4=S[kind == 1 and price > 80.0] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3, e4.price as p4 "
        "insert into Out;",
        ("p1", "p2", "p3", "p4")),
    # the README's Quick start on the cell's stream: a condition program
    # (price > e1.price * 1.05) on the simple instance
    "quick start": (
        "from every e1=S[kind == 0 and price > 50.0] -> e2=S[kind == 1 and "
        "price > e1.price * 1.05] within 10 sec select e1.price as p1, "
        "e2.price as p2 insert into Out;",
        ("p1", "p2")),
}
#: the cell's chunks (8 of the pattern cell's 16 of 262,144 events: cut
#: to pay for the Quick start cell), the chunks held against the CPU run,
#: the kinds of the feed (0..2: every unit of the apps sees its stream),
#: and the telemetry run's chunks
CLASS_CHUNKS = 8
CLASS_CPU_CHUNKS = 2
CLASS_KINDS = 3


def class_app(query: str, name: str, telemetry: bool = False) -> str:
    """pattern_app() with its query replaced by `query` (optionally with
    @app:statistics(telemetry='true'))."""
    head = pattern_app().split("@info(name='q')", 1)[0]
    head = head.replace("@app:name('pattern')", f"@app:name('{name}')")
    if telemetry:
        head = "@app:statistics(telemetry='true')\n" + head
    return head + "@info(name='q')\n" + query + "\nend;\n"


def _cols(got) -> dict:
    return {k: np.concatenate(v) if v else np.zeros(0)
            for k, v in got.items()}


def _cols_equal(a: dict, b: dict) -> bool:
    """Two runs' rows, in order, bit for bit (NaN for a null payload)."""
    return set(a) == set(b) and all(
        a[k].shape == b[k].shape and
        np.array_equal(np.asarray(a[k], np.float64),
                       np.asarray(b[k], np.float64), equal_nan=True)
        for k in a)


def _prefix(cols: dict, end_ts: int) -> dict:
    keep = cols["ts"] < end_ts
    return {k: v[keep] for k, v in cols.items()}


def run_cpu_app(text, chunks, columns):
    """`text` through SiddhiManager(device="cpu") (the plain steps) over
    `chunks`: (rows, last_telemetry of query q or None)."""
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
    got = {c: [] for c in ("ts",) + tuple(columns)}

    def sink(chunk):
        got["ts"].append(np.array(chunk.timestamps))
        for c in columns:
            got[c].append(np.array(chunk.columns[c]))
    rt.add_callback("Out", ColumnarStreamCallback(sink))
    rt.start()
    h = rt.get_input_handler("S")
    for c in chunks:
        h.send_batch(c[0], timestamps=c[1])
    rt.flush()
    nfa = rt.partition_runtimes[0].device_query_runtimes["q"] \
        .device_runtime.nfa
    tel = None if nfa.last_telemetry is None else \
        np.array(nfa.last_telemetry)
    rt.shutdown()
    return _cols(got), tel


#: the README's Quick start, verbatim, and the temperature rule of the
#: Siddhi guide: conditions the CUDA step takes as programs
README_APPS = {
    "quick start": (
        "Trades", "spikes", """
    define stream Trades (symbol string, price float, volume long);
    @info(name='spikes')
    from every e1=Trades[price > 100.0] -> e2=Trades[price > e1.price * 1.05]
        within 10 sec
    select e1.symbol as symbol, e1.price as p1, e2.price as p2
    insert into Alerts;
"""),
    "temperature": (
        "Temp", "rise", """
    define stream Temp (room int, temp double);
    @info(name='rise')
    from every e1=Temp -> e2=Temp[e1.room == room and (e1.temp + 5.0) <= temp]
        within 1 min
    select e1.room as room, e1.temp as t1, e2.temp as t2
    insert into Alerts;
"""),
}


def readme_apps(dev, seed, n=2_000):
    """Each README_APPS app under @app:engine('device') on `dev`: built
    with no SiddhiAppCreationError, its query on the device pattern path
    with the step's kernel program inside the class, its rows over `n`
    events equal to SiddhiManager(device="cpu")'s in order.  → {name:
    rows}."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    rng = np.random.default_rng(seed + 70)
    ts = 1_000 + np.cumsum(rng.integers(0, 2_000, n)).astype(np.int64)
    feeds = {
        "Trades": {"symbol": np.asarray([f"S{i}" for i in
                                         rng.integers(0, 8, n)], object),
                   "price": rng.uniform(80, 130, n).astype(np.float32),
                   "volume": rng.integers(1, 100, n).astype(np.int64)},
        "Temp": {"room": rng.integers(0, 16, n).astype(np.int32),
                 "temp": rng.uniform(10, 40, n)}}
    out = {}
    for name, (stream, q, text) in README_APPS.items():
        rows = {}
        for d in (dev, "cpu"):
            rt = SiddhiManager(device=d).create_siddhi_app_runtime(
                "@app:playback @app:engine('device')" + text)
            got = []
            rt.add_callback("Alerts", StreamCallback(
                lambda evs, _g=got: _g.extend(
                    (e.timestamp,) + tuple(e.data) for e in evs)))
            rt.start()
            rt.get_input_handler(stream).send_batch(feeds[stream],
                                                    timestamps=ts)
            rt.flush()
            qr = rt.query_runtimes[q]
            if qr.backend != "device":
                raise AssertionError(f"{name} on {d}: backend {qr.backend} "
                                     f"({qr.backend_reason})")
            reason = qr.device_runtime.nfa.kprog.reason
            rt.shutdown()
            if reason is not None:
                raise AssertionError(f"{name}: {reason}")
            rows[d] = got
        if not rows[dev] or rows[dev] != rows["cpu"]:
            raise AssertionError(f"{name}: {len(rows[dev])} rows on {dev} "
                                 f"!= {len(rows['cpu'])} on the CPU")
        out[name] = len(rows[dev])
        log(f"  README {name}: built on {dev} under @app:engine('device'), "
            f"{out[name]} rows == the CPU run's in order")
    return out


def run_class_cells(dev, seed, n_chunks=CLASS_CHUNKS,
                    cpu_chunks=CLASS_CPU_CHUNKS):
    """Phase 28: each CLASS_APPS query over the pattern cell's feed (kinds
    0..2) on the device engine, on the default dispatch (K12) and with
    SIDDHI_TPU_XTENANT=0 (K2 + K4): every query on the device pattern
    path, the two runs' rows equal in order, and the rows of the first
    `cpu_chunks` chunks equal the port's CPU run of the same app on those
    chunks.  Then phase 6's app with telemetry on the default dispatch
    over `cpu_chunks` chunks: its rows equal the per-key reference's
    (phase 6's), its last_telemetry the CPU run's.  Returns {name:
    {"packed": numbers, "per_app": numbers}} and the telemetry run's."""
    chunks = make_pattern_chunks(seed, n_chunks, kinds=CLASS_KINDS)
    n_events = sum(len(c[1]) for c in chunks)
    end_ts = PATTERN_BASE_TS + cpu_chunks * CHUNK
    out = {}
    for name, (query, columns) in CLASS_APPS.items():
        text = class_app(query, name.split(",")[0])
        runs, cols = {}, {}
        for key, packed in (("packed", True), ("per_app", False)):
            r = drive_nfa_cell(dev, text, chunks, columns, packed)
            cols[key] = _cols(r["got"])
            runs[key] = report_nfa_cell(f"{name} cell", r, n_events,
                                        n_chunks, packed)
            runs[key]["matches"] = len(cols[key]["ts"])
        if not _cols_equal(cols["packed"], cols["per_app"]):
            raise AssertionError(f"{name} cell: packed rows != "
                                 f"SIDDHI_TPU_XTENANT=0 rows")
        t_cpu = time.perf_counter()
        want, _tel = run_cpu_app(text, chunks[:cpu_chunks], columns)
        got = _prefix(cols["packed"], end_ts)
        if len(want["ts"]) == 0 or not _cols_equal(got, want):
            raise AssertionError(f"{name} cell: the first {cpu_chunks} "
                                 f"chunks' rows ({len(got['ts'])}) != the "
                                 f"CPU run's ({len(want['ts'])})")
        log(f"  {name} cell: {len(cols['packed']['ts'])} rows, K12 == K2 + "
            f"K4 in order; the first {cpu_chunks} chunks' "
            f"{len(want['ts'])} rows == the CPU run's (plain steps, "
            f"{time.perf_counter() - t_cpu:.1f} s)")
        out[name] = runs
    # phase 6's app with on-device telemetry (the widened instance)
    pchunks = make_pattern_chunks(seed, cpu_chunks)
    text = class_app(PARTITIONED_APP.split("@info(name='q')\n", 1)[1]
                     .rsplit("end;", 1)[0], "pattern_telemetry",
                     telemetry=True)
    r = drive_nfa_cell(dev, text, pchunks, ("p1", "p2"), True)
    n_ev = sum(len(c[1]) for c in pchunks)
    tel = report_nfa_cell("pattern cell, telemetry", r, n_ev, cpu_chunks,
                          True)
    got = _cols(r["got"])
    rts, rp1, rp2 = pattern_reference(pchunks)
    if not (np.array_equal(got["ts"], np.asarray(rts, np.int64)) and
            np.array_equal(got["p1"].astype(np.float32), rp1) and
            np.array_equal(got["p2"].astype(np.float32), rp2)):
        raise AssertionError("pattern cell with telemetry: rows != the "
                             "per-key reference")
    want_rows, want_tel = run_cpu_app(text, pchunks, ("p1", "p2"))
    if not _cols_equal(got, want_rows):
        raise AssertionError("pattern cell with telemetry: rows != CPU")
    gpu_tel = r.get("telemetry")
    if gpu_tel is None or want_tel is None or \
            not np.array_equal(gpu_tel, want_tel):
        raise AssertionError("pattern cell with telemetry: last_telemetry "
                             "!= the CPU run's")
    tel["telemetry_sum"] = [int(x) for x in gpu_tel.sum(axis=0)]
    log(f"  pattern cell with telemetry: {len(rts)} rows == the per-key "
        f"reference and the CPU run; last_telemetry [{gpu_tel.shape[0]}, "
        f"{gpu_tel.shape[1]}] == the CPU run's (summed over lanes: "
        f"{tel['telemetry_sum']})")
    return out, tel

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--pattern-chunks", type=int, default=16)
    ap.add_argument("--fleet-blocks", type=int, default=32)
    ap.add_argument("--latency-blocks", type=int, default=LAT_BLOCKS)
    ap.add_argument("--count-chunks", type=int, default=16)
    ap.add_argument("--absent-blocks", type=int, default=32)
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
    ops0 = count_device_ops(dev, args.seed)

    log("== phase 2: kernels vs plain versions on the card")
    rng = np.random.default_rng(args.seed + 1)
    # config 2's chunks: the main path's first N, and at least the grouped
    # cells' (phases 13-14) and the filter cell's
    names, chunks = make_chunks(args.seed, max(args.chunks, GAGG_CHUNKS))
    main_chunks = chunks[:args.chunks]
    # the main path's widest block: events of the busiest key in a chunk
    # (ops/pack.pack_blocks)
    t_main = max(int(np.bincount(c[2], minlength=N_KEYS).max())
                 for c in main_chunks)
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
    launches, wall = run_main_path(args.queries, names, main_chunks, dev)
    if args.chunks < 16 or args.queries < 100:
        log(f"CUT: {args.queries} queries x {args.chunks} chunks (from 8) "
            f"(config "
            f"2's cell is 100 x 16)")

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
    class_timed = time_class(dev, args.seed)
    log(f"  compaction alone: {nt['compact_ms']:.4f} ms (plain "
        f"{nt['plain_compact_ms']:.4f} ms, bound "
        f"{nt['compact_bound_ms']:.6f} ms by {nt['compact_bound_by']})")
    log(f"  device split of the fused call (profiler, ms per call): "
        f"{nt['split']}")
    log(f"  K5 alone, the block's gate word (torch programs): "
        f"{nt['gate_ms']:.4f} ms (bound {nt['gate_bound_ms']:.6f} ms by "
        f"bytes)")
    tob = torch_op_bounds()
    log(f"  torch ops without a caller on the cells, bounds by bytes: "
        f"K10b reset_slots {tob['reset_slots']['bound_ms']:.6f} ms at "
        f"{tob['reset_slots']['shape']}, K14 shift_clamped "
        f"{tob['shift_clamped']['bound_ms']:.6f} ms at "
        f"{tob['shift_clamped']['shape']}")

    log("== phase 6: pattern cell (PARTITIONED_APP, 10,000 keys) on the "
        "device engine, packed (K12) and with SIDDHI_TPU_XTENANT=0 (K2 + K4)")
    t6 = time.perf_counter()
    pc = run_pattern_path(pchunks, dev)
    log(f"  phase 6 took {time.perf_counter() - t6:.1f} s")
    if args.pattern_chunks < 16:
        log(f"CUT: pattern cell at {args.pattern_chunks} chunks (full size "
            f"is 16)")

    log("== phase 7: engine parity for the pattern app on the card")
    pattern_parity(dev, args.seed)

    log("== phase 8: fleet cell (bench.py's bank: 1000 patterns x 10,000 "
        "partitions) on the bank kernels")
    t8 = time.perf_counter()
    ring_cases, ring_err = check_ring(dev, args.seed)
    fc = run_fleet_cell(dev, args.seed, args.fleet_blocks)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")
    if args.fleet_blocks < 32:
        log(f"CUT: fleet cell at {args.fleet_blocks} blocks (full size is "
            f"32)")
    log(f"CUT: the fleet cell's timed window repeated {FLEET_REPEATS} times "
        f"(from 24)")

    log("== phase 9: fleet latency (bench.py's bench_lat: the same bank, "
        f"T={LAT_T} blocks, per-block synchronous)")
    t9 = time.perf_counter()
    lat = run_latency_cell(dev, args.seed, args.latency_blocks)
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
    if args.latency_blocks < LAT_BLOCKS:
        log(f"CUT: latency cell at {args.latency_blocks} blocks (full size "
            f"is {LAT_BLOCKS})")

    log("== phase 10: count cell (BASELINE config 4: A[3:10] -> B, 100,000 "
        "keys) on the device engine, packed (K12) and with "
        "SIDDHI_TPU_XTENANT=0 (K2 + K4)")
    t10 = time.perf_counter()
    cc = run_count_path(make_count_chunks(args.seed, args.count_chunks), dev)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
    if args.count_chunks < 16:
        log(f"CUT: count cell at {args.count_chunks} chunks (full size is "
            f"16)")

    log("== phase 11: absent fleet cell (BASELINE config 3: 1000 `every A "
        "-> B -> not C for 3 sec within 40 sec` x 10,000 lanes) on the bank "
        "kernels")
    t11 = time.perf_counter()
    ac = run_absent_fleet_cell(dev, args.seed, args.absent_blocks)
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
    if args.absent_blocks < 32:
        log(f"CUT: absent fleet cell at {args.absent_blocks} blocks (full "
            f"size is 32)")

    log("== phase 12: K7 kernels (grouped_agg.cu) vs plain twins on the card")
    t12 = time.perf_counter()
    gchk = check_gagg(dev, args.seed)
    gt = time_gagg(dev, args.seed)
    log(f"CUT: phase 12's plain twins at T = {GAGG_PLAIN_T} for the P = 1 "
        f"cells' shapes (two checked cases and the timed plain, from 4096) "
        f"and {GAGG_CHAIN_T} for the one-chain lane (from 4096)")
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s; bit for bit: "
        + "; ".join(f"{k} {v['cases']} cases, max abs err {v['max_abs_err']}"
                    for k, v in gchk.items()))

    log("== phase 13: grouped cell (config 2's queries unpartitioned, "
        "group by sym: one global length(1000) window) on K7a")
    t13 = time.perf_counter()
    gc13 = run_gagg_cell(names, chunks[:GAGG_CHUNKS], dev, GAGG_QUERIES,
                         keyed=False)
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")
    log(f"CUT: grouped cells at {GAGG_QUERIES} of config 2's 100 queries x "
        f"{min(GAGG_CHUNKS, len(chunks))} chunks")

    log("== phase 14: keyed cell (the same queries inside partition with "
        "(sym of S), group by sym, kind) on K7a")
    t14 = time.perf_counter()
    kc14 = run_gagg_cell(names, chunks[:GAGG_CHUNKS], dev, GAGG_QUERIES,
                         keyed=True)
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    log("== phase 15: time cell (#window.time(1 sec), having, order by, an "
        "exact long sum) on K7b and the selection step")
    t15 = time.perf_counter()
    tc15 = run_time_cell(names, make_time_chunks(chunks[:TIME_CHUNKS],
                                                 args.seed), dev)
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    log("== phase 16: filter cell (a string compare on code lanes) on the "
        "torch programs")
    t16 = time.perf_counter()
    fc16 = run_filter_cell(names, chunks, dev)
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

    log("== phase 17: engine parity for grouped aggregation, selection "
        "tails and filters on the card")
    gagg_parity(dev, args.seed)

    log("== phase 18: K6 (wagg_time.cu) vs its plain twin on the card")
    t18 = time.perf_counter()
    k6chk = check_wagg_time(dev, args.seed)
    k6t = time_wagg_time(dev, args.seed)
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s; "
        f"{k6chk['cases']} cases bit for bit, max abs err "
        f"{k6chk['max_abs_err']}")

    log("== phase 19: K9 (dwin_step.cu) vs its plain twin on the card, all "
        "twelve kinds")
    t19 = time.perf_counter()
    k9chk = check_dwin(dev, args.seed)
    wnames, wchunks = make_window_chunks(args.seed,
                                         max(WAGG_CHUNKS, WINDOW_CHUNKS))
    k9t, held = time_dwin(dev, wchunks)
    k9chk["cases"] += held
    log(f"  {held} K9 steps at the timed shapes equal bit for bit")
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    log("== phase 20: K6 cell (partitioned #window.time(1 sec) grouped by "
        "its key, 1,024 keys) on the device engine")
    t20 = time.perf_counter()
    k6c = run_k6_cell(wnames, wchunks[:WAGG_CHUNKS], dev)
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    log("== phase 21: window cell (timeBatch(1 sec) per-symbol totals) on "
        "the device window path")
    t21 = time.perf_counter()
    wc = run_window_cell(wnames, wchunks[:WINDOW_CHUNKS], dev)
    log(f"CUT: window cell at {WINDOW_CHUNKS} chunks (from 4)")
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s")

    log("== phase 22: K10 (iagg_fold.cu) vs its plain twin on the card")
    t22 = time.perf_counter()
    k10chk = check_iagg(dev, args.seed)
    k10t = time_iagg(dev, args.seed, ops0)
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s; "
        f"{k10chk['cases']} folds bit for bit, max abs err "
        f"{k10chk['max_abs_err']}")

    log("== phase 23: aggregation cell (TradeAgg, sec ... hour, 1,024 "
        "symbols) on DeviceAggregationRuntime")
    t23 = time.perf_counter()
    ac23 = run_iagg_cell(dev, args.seed)
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s")

    log("== phase 24: K11 (join_probe.cu: the fused probe and the mask "
        "route's compaction) vs their plain versions on the card")
    t24 = time.perf_counter()
    k11chk = check_probe(dev, args.seed)
    k11t = time_probe(dev, args.seed)
    fchk = check_fused(dev, args.seed)
    ft = time_fused(dev, args.seed, ops0)
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s; "
        f"{k11chk['cases']} compaction cases and {fchk['cases']} fused "
        f"cases bit for bit")

    log("== phase 25: join cell (a range stream-table join, 10,000 rows, "
        "16,384-event chunks) on the fused probe, then on the mask route")
    t25 = time.perf_counter()
    jc25 = run_join_cell(dev, args.seed, "fused")
    jm25 = run_join_cell(dev, args.seed, "mask")
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s")

    log("== phase 26: the cross-tenant gang (K12: nfa_gang_step + "
        "nfa_gang_compact) vs its plain twin and per-tenant steps; "
        f"{N_TENANTS} tenant apps packed and unpacked")
    t26 = time.perf_counter()
    g_flushes, g_instances, g_err = check_gang(dev, args.seed)
    gg = time_gang(dev, args.seed)
    g_err = max(g_err, gg["max_abs_err"])
    log(f"  gang at the keyed cell's shape ({gg['shape']}): {gg['ms']:.4f} "
        f"ms a call (plain twin {gg['plain_ms']:.4f} ms, bound "
        f"{gg['bound_ms']:.6f} ms by bytes: the tenants' K2 + K4 bounds "
        f"summed); compaction alone {gg['compact_ms']:.4f} ms (plain "
        f"{gg['plain_compact_ms']:.4f}, bound {gg['compact_bound_ms']:.6f})")
    log(f"  device split a call: {gg['split']}")
    log(f"  host enqueue a call (the card asleep): {gg['host_ms']}")
    tc26 = run_tenant_cell(dev, args.seed, keyed=False)
    tk26 = run_tenant_cell(dev, args.seed, keyed=True)
    log(f"CUT: the keyed tenant cell at {TENANT_ROUNDS[True]} rounds (from "
        f"8)")
    log(f"  phase 26 took {time.perf_counter() - t26:.1f} s")

    log(f"== phase 27: partition shard-out, SIDDHI_TPU_SHARDS={SHARD_N} "
        "(every shard on cuda:0)")
    t27 = time.perf_counter()
    sc = SHARD_CHUNKS
    sh27 = {
        "pattern_cell": run_shard_cell(
            "pattern (PARTITIONED_APP, 10,000 keys)", pattern_app(),
            make_pattern_chunks(args.seed, SHARD_PATTERN_CHUNKS), dev,
            "partition"),
        "config2_wagg": run_shard_cell(
            f"config 2 ({SHARD_WAGG_QUERIES} queries, K1)",
            main_app(SHARD_WAGG_QUERIES), chunks[:sc], dev, "sym"),
        "keyed_gagg": run_shard_cell(
            f"keyed gagg (phase 14's {GAGG_QUERIES} queries, K7a)",
            gagg_app(GAGG_QUERIES, keyed=True), chunks[:sc], dev, "sym")}
    log(f"CUT: shard cells at {SHARD_PATTERN_CHUNKS} of the pattern cell's "
        f"16 chunks, config 2 at {SHARD_WAGG_QUERIES} of 100 queries x {sc} "
        f"chunks, the keyed gagg cell at {sc} of its {GAGG_CHUNKS} chunks")
    log(f"  phase 27 took {time.perf_counter() - t27:.1f} s")

    log("== phase 28: the widened class at full width (SEQUENCE; logical "
        "then trailing `every`), packed (K12) and with SIDDHI_TPU_XTENANT=0 "
        "(K2 + K4); phase 6's app with telemetry")
    t28 = time.perf_counter()
    cl28, tel28 = run_class_cells(dev, args.seed)
    readme28 = readme_apps(dev, args.seed)
    log(f"CUT: phase 28's class cells at {CLASS_CHUNKS} of the pattern "
        f"cell's 16 chunks, their CPU comparison and the telemetry run at "
        f"{CLASS_CPU_CHUNKS} (from 4)")
    log(f"  phase 28 took {time.perf_counter() - t28:.1f} s")
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
        # its path: the pattern cell with SIDDHI_TPU_XTENANT=0; on the
        # default dispatch a cell's query steps through K12 (its launches
        # there are replays)
        "checked": True,
        "launches": pc["per_app"]["launches"][2] + sum(
            v["per_app"]["launches"][2] for v in cl28.values()),
        "max_abs_err": nfa_err,
        "launches_by_path": {
            "pattern_cell_xtenant0": pc["per_app"]["launches"][2],
            "count_cell_xtenant0": cc["per_app"]["launches"][2],
            "pattern_cell": pc["packed"]["launches"][2],
            "count_cell": cc["packed"]["launches"][2]} | {
            f"class_cell {k} xtenant0": v["per_app"]["launches"][2]
            for k, v in cl28.items()},
        "pattern_cell": pc, "count_cell": cc, "class_cells": cl28,
        "telemetry_cell": tel28, "widened": class_timed,
        "readme_apps": readme28,
        "ms": nt["ms"], "plain_ms": nt["plain_ms"],
        "bound_ms": nt["bound_ms"], "bound_by": nt["bound_by"],
        "library_ms": None, "split": nt["split"],
        "gate_word": {"ms": nt["gate_ms"], "bound_ms": nt["gate_bound_ms"],
                      "bound_by": "bytes"},
        "torch_op_bounds": tob,
        "shape": {"P": PATTERN_LANES, "T": t_pat, "K": PATTERN_SLOTS,
                  "matches": nt["count"], "cap": nt["cap"],
                  "seg": nt["seg"]}}, {
        "name": "nfa_compact", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_step.cu",
        "replaces": "siddhi_tpu/plan/nfa_compiler.py:1837",
        "checked": True,
        "launches": pc["per_app"]["launches"][3] + sum(
            v["per_app"]["launches"][3] for v in cl28.values()),
        "launches_by_path": {
            "pattern_cell_xtenant0": pc["per_app"]["launches"][3],
            "count_cell_xtenant0": cc["per_app"]["launches"][3],
            "pattern_cell": pc["packed"]["launches"][3],
            "count_cell": cc["packed"]["launches"][3]} | {
            f"class_cell {k} xtenant0": v["per_app"]["launches"][3]
            for k, v in cl28.items()},
        "max_abs_err": nfa_err, "ms": nt["compact_ms"],
        "plain_ms": nt["plain_compact_ms"],
        "bound_ms": nt["compact_bound_ms"],
        "bound_by": nt["compact_bound_by"], "library_ms": None,
        "shape": {"P": PATTERN_LANES, "matches": nt["count"],
                  "cap": nt["cap"]}}, {
        # the bank step with its gate word, not in place: the thread
        # instance (nfa_bank_thread_kernel) on every main path (the fleet,
        # the absent fleet, the count and ratio banks); the group instance
        # (nfa_bank_step_kernel: K > 16, more than 8 constant compares, a
        # column past shared memory) is held bit for bit in phase 8's
        # checks and timed on the count and ratio banks' blocks; the
        # widened instance is the next entry
        "name": "nfa_bank_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_step.cu",
        "replaces": "siddhi_tpu/ops/nfa.py:1167",
        "checked": True, "launches": fc["launches"][0],
        "launches_by_instance": {"thread": fc["launches"][1],
                                 "group": fc["launches"][2],
                                 "wide": fc["launches"][4]},
        "instances": {
            "thread": {"source": "siddhi_tpu_torch/csrc/nfa_step.cu",
                       "kernel": "nfa_bank_thread_kernel",
                       "launches": fc["launches"][1] + ac["launches"][1] +
                       ac["count_bank"]["launches"][1] +
                       ac["ratio_bank"]["launches"][1]},
            "group": {"source": "siddhi_tpu_torch/csrc/nfa_step.cu",
                      "kernel": "nfa_bank_step_kernel",
                      "launches": fc["launches"][2] + ac["launches"][2] +
                      ac["count_bank"]["launches"][2] +
                      ac["ratio_bank"]["launches"][2],
                      "count_bank_ms": ac["count_bank"]["group_step_ms"],
                      "ratio_bank_ms": ac["ratio_bank"]["group_step_ms"]}},
        "launches_by_path": {"fleet_cell": fc["launches"][0],
                             "absent_fleet_cell": ac["launches"][0],
                             "count_bank": ac["count_bank"]["launches"][0],
                             "ratio_bank": ac["ratio_bank"]["launches"][0]},
        "count_bank": ac["count_bank"], "ratio_bank": ac["ratio_bank"],
        "max_abs_err": max(fc["max_abs_err"], ac["max_abs_err"]),
        "absent_cell": {k: ac.get(k) for k in (
            "events_per_s", "ms_per_block", "thread_ms", "device_ms",
            "idle_share", "idle_share_profiled", "step_ms", "step_plain_ms",
            "step_bound_ms", "step_bound_by", "step_inplace_ms",
            "step_inplace_bound_ms", "peak", "repeats", "launches")},
        "ms": fc["step_ms"], "plain_ms": fc["step_plain_ms"],
        "bound_ms": fc["step_bound_ms"], "bound_by": fc["step_bound_by"],
        "library_ms": None, "split": fc["split"],
        "inplace_ms": fc["step_inplace_ms"],
        "inplace_bound_ms": fc["step_inplace_bound_ms"],
        "matchy_ms": fc["step_matchy_ms"],
        "t4_ms": fc["step_t4_ms"], "t4_bound_ms": fc["step_t4_bound_ms"],
        "t4_inplace_ms": fc["step_t4_inplace_ms"],
        "latency": {k: lat[k] for k in (
            "p50_ms", "p99_ms", "compute_only_median_ms",
            "compute_only_mad_ms", "launches")},
        "shape": {"patterns": N_BANK, "P": BANK_P, "T": BANK_T,
                  "K": BANK_K, "chunks": N_BANK // BANK_CHUNK}}, {
        # the bank step for widened programs: the widened thread instance
        # (csrc/nfa_bank_wide.cu's nfa_bank_wide_kernel, one thread per
        # (pattern, lane) on Wide::event's thread policy), counted in
        # nfa_bank_step.wide_thread_launches, on phase 11's full-width
        # widened banks (the fleet cells launch the thread instance
        # alone); the widened group instance (csrc/nfa_wide.cu's
        # nfa_bank_step_kernel: K > 16, more than 8 constant compares, a
        # column past shared memory; nfa_bank_step.wide_launches) is held
        # bit for bit in phase 8's checks and timed on phase 11's blocks;
        # ms is the SEQUENCE bank's
        "name": "nfa_bank_step_wide", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_bank_wide.cu",
        "replaces": "siddhi_tpu/ops/nfa.py:1167",
        "checked": True,
        "launches": sum(v["launches"] for v in ac["wide_banks"].values()),
        "launches_by_path": {f"{k} bank": v["launches"]
                             for k, v in ac["wide_banks"].items()},
        "launches_by_instance": {
            "wide_thread": sum(v["launches"]
                               for v in ac["wide_banks"].values()),
            "wide_group": 0},
        "instances": {
            "wide_thread": {
                "source": "siddhi_tpu_torch/csrc/nfa_bank_wide.cu",
                "kernel": "nfa_bank_wide_kernel",
                "ms_by_bank": {k: v["ms"]
                               for k, v in ac["wide_banks"].items()}},
            "wide_group": {
                "source": "siddhi_tpu_torch/csrc/nfa_wide.cu",
                "kernel": "nfa_bank_step_kernel", "launches": 0,
                "ms_by_bank": {k: v["group_ms"]
                               for k, v in ac["wide_banks"].items()}}},
        "max_abs_err": max(v["max_abs_err"]
                           for v in ac["wide_banks"].values()),
        **{k: ac["wide_banks"]["sequence"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "banks": ac["wide_banks"],
        "shape": {"patterns": WIDE_FLEET_N, "P": BANK_P, "T": BANK_T,
                  "K": BANK_K, "chunks": WIDE_FLEET_N // 20}}, {
        "name": "nfa_bank_ring", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_step.cu",
        "replaces": "siddhi_tpu/ops/nfa.py:1250",
        "checked": True, "launches": fc["launches"][3],
        "launches_by_path": {"fleet_cell": fc["launches"][3],
                             "absent_fleet_cell": ac["launches"][3]} | {
            f"{k} bank": v["ring_launches"]
            for k, v in ac["wide_banks"].items()},
        "max_abs_err": max(fc["max_abs_err"], ac["max_abs_err"], ring_err),
        "ring_only_cases": ring_cases,
        "ms": fc["ring_ms"], "plain_ms": fc["ring_plain_ms"],
        "bound_ms": fc["ring_bound_ms"], "bound_by": fc["ring_bound_by"],
        "library_ms": fc["ring_library_ms"],
        "matchy_ms": fc["ring_matchy_ms"], "t4_ms": fc["ring_t4_ms"],
        "totals_only_ms": fc["ring_totals_ms"],
        "shape": {"patterns": N_BANK, "P": BANK_P, "ring": BANK_RING}}]

    def cell(c, kernels=()):
        """A cell's numbers; kernel_ms sums the named kernels' device
        time (a K7 step's passes), kernel_ms_by_name splits it."""
        got = c.get("kernel_ms") or {}
        by = {k: got[k] for k in kernels if k in got}
        return {k: c.get(k) for k in (
            "events_per_s", "query_events_per_s", "ms_per_chunk",
            "dispatch_s", "device_s", "decode_s", "device_ms", "idle_share",
            "launches")} | {
            "kernel_ms": sum(by.values()) if by else None,
            "kernel_ms_by_name": by or None}

    def k7(timed):
        return {k: timed[k] for k in (
            "ms", "plain_ms", "plain_T", "ms_at_plain_T", "bound_ms",
            "bound_by", "shape", "split")}

    def floor(timed):
        return {k: timed[k] for k in ("ms", "bound_ms", "bound_by",
                                      "gids", "shape", "split")}

    kernels += [{
        # K7a: the grouped cell (phase 13) is its main path; the keyed
        # cell (phase 14) runs it at P = 1,024.  A launch is one step:
        # the seven kernels of GAGG_PASSES on one stream
        "name": "gagg_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/grouped_agg.cu",
        "replaces": "siddhi_tpu/ops/grouped_agg.py:119",
        "checked": True, "launches": gc13["launches"][0],
        "launches_by_path": {"grouped_cell": gc13["launches"][0],
                             "keyed_cell": kc14["launches"][0]},
        **gchk["length"], **k7(gt["grouped_cell"]), "library_ms": None,
        "keyed_shape": k7(gt["keyed_cell"]),
        "chain_floor": {k: floor(gt[k]) for k in GAGG_FLOORS},
        "grouped_cell": cell(gc13, GAGG_PASSES),
        "keyed_cell": cell(kc14, GAGG_PASSES)}, {
        "name": "gagg_time_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/grouped_agg.cu",
        "replaces": "siddhi_tpu/ops/grouped_agg.py:283",
        "checked": True, "launches": tc15["launches"][1],
        **gchk["time"], **k7(gt["time_cell"]), "library_ms": None,
        "time_cell": cell(tc15, GAGG_PASSES) | {
            "capacity": tc15["capacity"], "rows": tc15["rows"],
            "select_step": tc15["select"]}}]
    def cell_k(c, names):
        return cell(c, names) | {k: c.get(k) for k in (
            "peak", "capacity", "rows", "egress_bytes_per_step")
            if k in c}

    kernels += [{
        # K6: the K6 cell (phase 20) is its main path
        "name": "wagg_time_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/wagg_time.cu",
        "replaces": "siddhi_tpu/ops/windowed_agg.py:125",
        "checked": True, "launches": k6c["launches"], **k6chk,
        **{k: k6t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "shape")},
        "library_ms": None,
        "k6_cell": cell_k(k6c, K6_KERNELS)}, {
        # K9: the window cell (phase 21) is its main path; a launch is one
        # step, four kernels on one stream
        "name": "dwin_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/dwin_step.cu",
        "replaces": "siddhi_tpu/ops/dwin.py:177",
        "checked": True, "launches": wc["launches"], **k9chk,
        "ms": k9t["timeBatch"]["cell"]["ms"],
        "plain_ms": k9t["timeBatch"]["cell"]["plain_ms"],
        "bound_ms": k9t["timeBatch"]["cell"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": k9t["timeBatch"]["cell"]["shape"] | {"kind": "timeBatch"},
        "by_kind": k9t,
        "window_cell": cell_k(wc, ["dwin_prep", "dwin_decide", "dwin_scan",
                                   "dwin_scatter"])}]
    kernels += [{
        # K10: the aggregation cell (phase 23) is its main path; a launch
        # is one fold: prep (digit counts, settle), the radix passes, the
        # walks
        "name": "iagg_fold", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/iagg_fold.cu",
        "replaces": "siddhi_tpu/ops/incremental_agg.py:64",
        "checked": True, "launches": ac23["launches"], **k10chk,
        **{k: k10t["cell"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "sort_library_ms",
                                        "device_ops",
                                        "shape")},
        "library_ms": None, "one_slot": k10t["one_slot"],
        "aggregation_cell": cell_k(ac23, IAGG_KERNELS) | {
            k: ac23.get(k) for k in ("slots", "rows_seconds",
                                     "rows_hours")}}, {
        # K11, fused: the join cell (phase 25) is its main path; a launch
        # is one probe, one kernel (after a memset of its look-back words)
        "name": "probe_fused", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/join_probe.cu",
        "replaces": "siddhi_tpu/core/join.py:367",
        "checked": True, "launches": jc25["launches"], **fchk,
        **{k: ft[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "mask_route_ms", "device_ops",
                              "shape", "by_condition")},
        "join_cell": cell_k(jc25, JOIN_KERNELS["fused"]) | {
            k: jc25.get(k) for k in ("cap", "probes_per_s",
                                     "pairs_per_s")}}, {
        # K11, the mask route's compaction: the join cell's app with its
        # condition outside the fused class (phase 25) is its main path;
        # a launch is one compaction, three kernels on one stream
        "name": "probe_compact", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/join_probe.cu",
        "replaces": "siddhi_tpu/core/join.py:367",
        "checked": True, "launches": jm25["launches"], **k11chk,
        **{k: k11t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "shape")},
        "join_mask_cell": cell_k(jm25, JOIN_KERNELS["mask"]) | {
            k: jm25.get(k) for k in ("cap", "probes_per_s",
                                     "pairs_per_s")}}]
    kernels += [{
        # K12: the keyed tenant cell (phase 26, packed) is its main path;
        # a launch is one step launch (one a template instance present in
        # a flush); ms is the whole gang call at the cell's shape (gate
        # words, the descriptor copy, step, compaction)
        "name": "nfa_gang_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_gang.cu",
        "replaces": "siddhi_tpu/plan/xtenant.py:95",
        "checked": True,
        "launches": tk26["launches"] + sum(
            v["packed"]["launches"][0] for v in cl28.values()) +
        tel28["launches"][0],
        "max_abs_err": g_err, "flushes_checked": g_flushes,
        "launches_a_flush": g_instances,
        "launches_by_path": {"keyed_tenant_cell": tk26["launches"],
                             "tenant_cell": tc26["launches"],
                             "pattern_cell": pc["packed"]["launches"][0],
                             "count_cell": cc["packed"]["launches"][0],
                             "telemetry_cell": tel28["launches"][0]} | {
            f"class_cell {k}": v["packed"]["launches"][0]
            for k, v in cl28.items()},
        "ms": gg["ms"], "plain_ms": gg["plain_ms"],
        "bound_ms": gg["bound_ms"], "bound_by": gg["bound_by"],
        "library_ms": None, "split": gg["split"], "host_ms": gg["host_ms"],
        "shape": gg["shape"],
        "keyed_tenant_cell": {k: v for k, v in tk26.items()
                              if k != "launches"},
        "tenant_cell": {k: v for k, v in tc26.items() if k != "launches"}},
        {
        "name": "nfa_gang_compact", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_gang.cu",
        "replaces": "siddhi_tpu/plan/xtenant.py:95",
        "checked": True,
        "launches": tk26["compact_launches"] + sum(
            v["packed"]["launches"][1] for v in cl28.values()) +
        tel28["launches"][1],
        "launches_by_path": {"keyed_tenant_cell": tk26["compact_launches"],
                             "tenant_cell": tc26["compact_launches"],
                             "pattern_cell": pc["packed"]["launches"][1],
                             "count_cell": cc["packed"]["launches"][1],
                             "telemetry_cell": tel28["launches"][1]} | {
            f"class_cell {k}": v["packed"]["launches"][1]
            for k, v in cl28.items()},
        "max_abs_err": g_err, "ms": gg["compact_ms"],
        "plain_ms": gg["plain_compact_ms"],
        "bound_ms": gg["compact_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": gg["shape"]}]
    # the filter cell runs no hand kernel (torch programs): a cell of the
    # line of its own
    print(json.dumps({"kernels": kernels,
                      "cells": {"filter_cell": cell(fc16),
                                "shards": {k: {x: y for x, y in v.items()
                                               if x != "stats"}
                                           for k, v in sh27.items()}}}),
          flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
