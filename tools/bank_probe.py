#!/usr/bin/env python3
"""Probe the pattern bank's step kernel on one GPU: hold it against the
plain bank step on small shapes, then split its time at the fleet shape.

    python3 tools/bank_probe.py [--seed S] [--cells]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.

1. Checks: banks of 16 patterns over 1000 lanes (K = 1, 5, 8, 16 and 32,
   the last on the group instance; T = 1, 3, 4, 7 and 300; a one-unit
   chain, a chain without `every`, a 3-unit chain with `<=`, `>=`, `!=`
   and a constant on the left), two chained blocks each through
   ``CompiledPatternBank.process_block`` (in place), every output and
   carry leaf equal to the plain bank step's bit for bit.
2. Times at the fleet shape (``chip_smoke.py`` phase 8's bank: 1000
   patterns x 10,000 lanes, K = 8, T = 64, alert band), median of 20
   launches, L2 flushed: the bank step not in place, and in the group
   instance (forced; the kernel the fleet path ran before the thread
   instance); in place over fresh blocks that
   continue the stream, at T = 64 and T = 4, also with one pattern group
   a CTA over tiles of 16 events (forced; the walk over several groups
   is the default when one tile holds the block); the same on the
   matchy band (5..95, floor 0).  Then two builds of the same source:
   with the other thread mapping (``kBankLanes = 8``: a warp over 32
   patterns of one lane), not in place at T = 64 and T = 4, its outputs
   equal to the default's bit for bit; and without the thread instance's
   event walk (every event left undone: the results are wrong, the time
   is that of everything else — staging, the CTA's candidate marks, the
   carry), in place at T = 64 and T = 4.
3. The match ring on each band's step outputs (T = 64 and T = 4): ring
   32, ring 0 (staging and stats alone), ``torch.sum`` over the same
   counts (each also with the L2 flushed by a read), and builds that
   find the ring-th count from per-warp histograms of 16 and 128 bins
   before bisection (RING_HISTOGRAM), held bit for bit against the
   default.

4. The count and program banks (``chip_smoke.py`` phase 11's count bank,
   config 4 as 100 patterns, and ratio bank, the Quick start as 100
   patterns; 10,000 lanes, T = 64, K = 8) on both thread mappings: the
   default and a build with ``kBankLanes = 8`` of each library they run
   from (``nfa_step``; ``nfa_prog`` for the ratio bank's program), the
   step not in place and in place over fresh blocks (median ms, L2
   flushed), the outputs of the two mappings equal bit for bit.
   ``--cells`` runs this part alone.

Prints one line ``BANKPROBE {json}`` with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the thread instance's walk over its lane's events, as the source has it
EVENT_WALK = "for (int wd = 0; on && wd < ((tn + 31) >> 5); ++wd) {"
#: the thread instance's mapping: lanes a tile (ops/nfa.BANK_LANES)
BANK_LANES = "constexpr int kBankLanes = 32;"
#: the ring kernel's threshold search by a histogram before bisection:
#: each warp bins max - count for its range over BINS bins (counts at the
#: row's min held in a register), every warp scans the summed bins for
#: the ring-th count, and bisection runs only where it lies BINS or more
#: below the max.  Edits to csrc/nfa_step.cu: the bins' shared memory,
#: then the search.
RING_BISECTION_START = """\
    int g_lo = max(0, min(4 * c_hi, nl) - 4 * c_lo), g_hi = 0;
    long long lo = mn, hi = static_cast<long long>(mx) + 1;
"""
RING_HISTOGRAM = [
    ("constexpr int kRingRed = 2 * kRingWarps * 3;  // two reduction "
     "buffers\n",
     "constexpr int kRingRed = 2 * kRingWarps * 3;\n"
     "constexpr int kRingBins = BINS;\n"),
    ("  return kRingRed + ring_region_ints(ring, tile) +",
     "  return kRingRed + kRingWarps * kRingBins + "
     "ring_region_ints(ring, tile) +"),
    ("  int* tl = red + kRingRed;                             // the tile",
     "  int* hist = red + kRingRed;\n"
     "  int* tl = hist + kRingWarps * kRingBins;"),
    (RING_BISECTION_START, """\
    int* hw = hist + w * kRingBins;
    for (int i = wl; i < kRingBins; i += 32) hw[i] = 0;
    __syncwarp();
    int at_min = 0;
    for (int c = c_lo + wl; c < c_hi; c += 32) {
      const int4 v4 = tl4[c];
      const int m = nl - 4 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = lane4(v4, e);
        if (e >= m) break;
        if (x == mn) {
          ++at_min;
        } else {
          const unsigned d =
              static_cast<unsigned>(mx) - static_cast<unsigned>(x);
          if (d < kRingBins) atomicAdd(hw + d, 1);
        }
      }
    }
    at_min = __reduce_add_sync(kFull, at_min);
    const unsigned span =
        static_cast<unsigned>(mx) - static_cast<unsigned>(mn);
    __syncwarp();
    if (wl == 0 && span < kRingBins) hw[span] += at_min;
    __syncthreads();                    // every warp's histogram is in
    // every warp finds d*: lane l holds bins [4l, 4l + 4) of the row
    constexpr int kLaneBins = (kRingBins + 31) / 32;
    int bin[kLaneBins] = {};
    int mine = 0, all = 0;              // this warp's, every warp's
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j) {
#pragma unroll
      for (int i = 0; i < kRingWarps; ++i)
        bin[j] += kLaneBins * wl + j < kRingBins
                      ? hist[i * kRingBins + kLaneBins * wl + j] : 0;
      all += bin[j];
    }
    int cum = all;                      // inclusive scan over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, cum, o);
      if (wl >= o) cum += y;
    }
    const unsigned hit = __ballot_sync(kFull, cum >= k);
    int dstar = kRingBins;              // none: bisection below
    if (hit) {
      const int src = __ffs(static_cast<int>(hit)) - 1;
      int c = cum - all, d = kLaneBins * wl + kLaneBins - 1;
      bool done = false;
#pragma unroll
      for (int j = 0; j < kLaneBins; ++j) {
        c += bin[j];
        if (!done && c >= k) {
          d = kLaneBins * wl + j;
          done = true;
        }
      }
      dstar = __shfl_sync(kFull, d, src);
    }
    // this warp's counts above max - d*, and at it
    int at = 0;
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j) {
      const int dd = kLaneBins * wl + j;
      const int y = dd < kRingBins ? hw[dd] : 0;
      mine += dd < dstar ? y : 0;
      at += dd == dstar ? y : 0;
    }
    int g_hi = __reduce_add_sync(kFull, mine);
    int g_lo = g_hi + __reduce_add_sync(kFull, at);
    long long lo, hi;
    if (hit) {
      lo = static_cast<long long>(mx) - dstar;
      hi = lo + 1;
    } else {
      lo = mn;
      hi = static_cast<long long>(mx) - kRingBins + 1;
      g_lo = max(0, min(4 * c_hi, nl) - 4 * c_lo);
    }
""")]


def ring_histogram(bins):
    """RING_HISTOGRAM's edits with `bins` bins a warp, and the shared
    memory they add a CTA."""
    return [(old, new.replace("BINS", str(bins)))
            for old, new in RING_HISTOGRAM], 8 * bins * 4


def build_variant(kernels, tag, edits, lib="nfa_step") -> ctypes.CDLL:
    """csrc/nfa_step.cu, with the thread instances' header
    (csrc/nfa_bank.cuh) written into it, with each text `old` of the
    (old, new) edits made `new`, built with library `lib`'s flags
    (ops/_kernels.VARIANTS) into the checkout's build directory and bound
    like that library."""
    src = open(os.path.join(kernels.CSRC, "nfa_step.cu")).read()
    src = src.replace('#include "nfa_bank.cuh"\n', open(
        os.path.join(kernels.CSRC, "nfa_bank.cuh")).read())
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"nfa_step.cu: {old!r} is not where this "
                               f"probe expects it")
        src = src.replace(old, new)
    os.makedirs(kernels.BUILD, exist_ok=True)
    cu = os.path.join(kernels.BUILD, f"nfa_step_{tag}.cu")
    so = os.path.join(kernels.BUILD, f"nfa_step_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    flags = kernels.VARIANTS.get(lib, (lib, []))[1]
    subprocess.run([kernels.nvcc_path()] + kernels.NVCC_FLAGS + flags +
                   ["-I", kernels.CSRC, "-o", so, cu], check=True)
    out = ctypes.CDLL(so)
    for fn, (restype, argtypes) in kernels.SIGNATURES[lib].items():
        f = getattr(out, fn)
        f.argtypes = argtypes
        f.restype = restype
    return out


def check(cs, bank, blocks) -> int:
    """Blocks through the bank (in place), each against the plain bank
    step from the same carry, bit for bit → matches."""
    import torch
    matches = 0
    for raw in blocks:
        blk = bank.nfa.to_device(raw)
        pre = cs._snapshot(bank)
        got = bank.process_block(blk)
        new_p, want = cs._bank_plain(bank, pre, blk)
        torch.cuda.synchronize()
        cs._bank_outputs_equal("probe", got, want, cs._carry(bank), new_p)
        matches += int(want[0].sum())
    return matches


def run_checks(cs, dev, seed) -> dict:
    import numpy as np
    from siddhi_tpu_torch.ops.nfa import nfa_bank_step
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    stream = "define stream S (partition int, price float, kind int);\n"
    cases = {}
    matchy = [cs.bank_app(t, floor=0.0) for t in np.linspace(5.0, 95.0, 16)]
    for K in (1, 5, 8, 16, 32):
        b = CompiledPatternBank(matchy, n_partitions=1000, n_slots=K,
                                pattern_chunk=8, ring=8, device=dev)
        cases[f"K={K}"] = check(cs, b, cs.bank_blocks(
            np.random.default_rng(seed + K), 2, P=1000, gap=1000))
    short = [cs.bank_app(t, floor=0.0, within_ms=4000)
             for t in np.linspace(5.0, 95.0, 16)]
    for T in (1, 3, 4, 7, 300):
        b = CompiledPatternBank(short, n_partitions=1000, n_slots=8,
                                pattern_chunk=8, ring=8, device=dev)
        cases[f"T={T}"] = check(cs, b, cs.bank_blocks(
            np.random.default_rng(seed + T), 2, P=1000, T=T, gap=1000))
    shapes = {
        "one unit": [stream + f"from every e1=S[price > {t} and kind == 0] "
                     "select e1.price as p1 insert into Out;"
                     for t in np.linspace(50.0, 99.0, 8)],
        "no every": [stream + f"from e1=S[kind == 0 and price > {t}] -> "
                     "e2=S[kind == 1 and price > e1.price] select e1.price "
                     "as p1, e2.price as p2 insert into Out;"
                     for t in np.linspace(5.0, 95.0, 8)],
        "chain3": [stream + f"from every e1=S[{t} <= price and kind != 1] -> "
                   "e2=S[kind == 1 and price >= e1.price] -> e3=S[price < "
                   f"{80 - t / 2} and price < e2.price] within 9 sec select "
                   "e1.price as p1, e3.price as p3 insert into Out;"
                   for t in np.linspace(10, 60, 8)]}
    for name, apps in shapes.items():
        for K in (3, 8):
            b = CompiledPatternBank(apps, n_partitions=1024, n_slots=K,
                                    pattern_chunk=4, ring=8, device=dev)
            cases[f"{name} K={K}"] = check(cs, b, cs.bank_blocks(
                np.random.default_rng(seed + 11), 2, P=1024, gap=1024))
    return {"matches": cases, "thread_launches": nfa_bank_step.thread_launches,
            "group_launches": nfa_bank_step.group_launches}


def time_band(cs, ops, dev, seed, floor, thrs, variants) -> dict:
    """The bank step's times on one band at the fleet shape."""
    import numpy as np
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    n = cs.TIMED_LAUNCHES
    bank = CompiledPatternBank([cs.bank_app(t, floor=floor) for t in thrs],
                               n_partitions=cs.BANK_P, n_slots=cs.BANK_K,
                               pattern_chunk=cs.BANK_CHUNK,
                               ring=cs.BANK_RING, device=dev)
    rng = np.random.default_rng(seed)
    first = [bank.nfa.to_device(b) for b in cs.bank_blocks(rng, 2 + n)]
    fresh4 = [bank.nfa.to_device(b) for b in cs.bank_blocks(
        rng, n, T=4, first=(2 + n) * cs.BANK_T // 4)]
    bank.process_block(first[0])
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carry, block = bank._stack_carry, first[1]
    geometry, load = ops.bank_geometry, ops.load_kernel

    def timed(fn):
        return cs.median_ms(fn, dev, n=n, sleep_cycles=5 * cs.SLEEP_CYCLES)

    def step(c=carry, b=block, **kw):
        return ops.nfa_bank_lanes(spec, c, b, prm, kp, **kw)

    def in_place(blocks):
        work = {k: v.clone() for k, v in carry.items()}
        it = iter(blocks)
        ms = timed(lambda: step(c=work, b=next(it), inplace=True))
        del work
        return ms
    res = {"thread_ms": timed(step),
           "t4_ms": timed(lambda: step(b=fresh4[0])),
           "inplace_ms": in_place(first[2:]),
           "t4_inplace_ms": in_place(fresh4)}
    res["ring"] = time_ring(cs, ops, dev, step(), step(b=fresh4[0]),
                            variants)
    want = [step(), step(b=fresh4[0])]
    try:
        ops.load_kernel = lambda name: variants["patterns"]
        ops.BANK_LANES = 8
        got = [step(), step(b=fresh4[0])]
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            for k in w[0]:
                if not cs._same_bits(w[0][k], g[0][k]):
                    raise AssertionError(f"thread mappings differ: carry.{k}")
            if not all(cs._same_bits(x, y) for x, y in zip(w[1:], g[1:])):
                raise AssertionError("thread mappings differ: outputs")
        del want, got
        res["warp_patterns_ms"] = timed(step)
        res["warp_patterns_t4_ms"] = timed(lambda: step(b=fresh4[0]))
        ops.BANK_LANES = 32
        ops.load_kernel = lambda name: variants["nowalk"]
        res["nowalk_inplace_ms"] = in_place(first[2:])
        res["nowalk_t4_inplace_ms"] = in_place(fresh4)
        ops.load_kernel = load
        ops.bank_geometry = lambda *a, **k: geometry(*a, **k)._replace(
            TT=min(geometry(*a, **k).TT, 16), groups=1)
        res["one_group_inplace_ms"] = in_place(first[2:])
        res["one_group_t4_inplace_ms"] = in_place(fresh4)
        ops.bank_geometry = lambda *a, **k: ops.BankGeometry("group", 0, 0)
        res["group_ms"] = cs.median_ms(step, dev, n=5,
                                       sleep_cycles=5 * cs.SLEEP_CYCLES)
    finally:
        ops.bank_geometry, ops.load_kernel = geometry, load
        ops.BANK_LANES = 32
    del bank, carry, block, first, fresh4
    torch.cuda.empty_cache()
    return res


def median_read_flushed(cs, fn, dev, n=20):
    """cs.median_ms with the L2 flushed by a read of 64 MB instead of a
    write (no dirty lines left for the timed launch to write back)."""
    import numpy as np
    import torch
    flush = torch.ones(16 << 20, dtype=torch.int32, device=dev)
    times = []
    for _ in range(n):
        flush.sum()
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def time_ring(cs, ops, dev, out, out4, variants) -> dict:
    """The ring kernel on one band's step outputs at the fleet shape,
    median of 20 launches, L2 flushed: ring 32 (T = 64 and T = 4), ring 0
    (the totals: staging and the tile's stats alone), the same counts
    summed per pattern by ``torch.sum`` (a library read of the same
    bytes), the first three again with the L2 flushed by a read, and
    the builds that find the ring-th count from per-warp histograms of
    16 and of 128 bins before bisection (RING_HISTOGRAM), their outputs
    equal to the default's bit for bit."""
    import torch
    ring, load, geometry = cs.BANK_RING, ops.load_kernel, ops.ring_geometry

    def ring_of(o, r=ring):
        return lambda: ops.nfa_bank_ring(*o, r)
    total = lambda: out[1].sum(dim=1, dtype=torch.int32)  # noqa: E731
    res = {"max_count": int(out[1].max()),
           "ms": cs.median_ms(ring_of(out), dev),
           "t4_ms": cs.median_ms(ring_of(out4), dev),
           "totals_ms": cs.median_ms(ring_of(out, 0), dev),
           "torch_sum_ms": cs.median_ms(total, dev),
           "read_flushed_ms": median_read_flushed(cs, ring_of(out), dev),
           "read_flushed_totals_ms": median_read_flushed(
               cs, ring_of(out, 0), dev),
           "read_flushed_torch_sum_ms": median_read_flushed(cs, total, dev)}
    want = ops.nfa_bank_ring(*out, ring)
    try:
        for bins in (16, 128):
            ops.load_kernel = lambda name, b=bins: variants[f"histogram{b}"]
            ops.ring_geometry = lambda *a, b=bins: geometry(*a)._replace(
                smem=geometry(*a).smem + ring_histogram(b)[1])
            got = ops.nfa_bank_ring(*out, ring)
            torch.cuda.synchronize()
            if not all(cs._same_bits(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"ring: histogram {bins} differs")
            res[f"histogram{bins}_ms"] = cs.median_ms(ring_of(out), dev)
            res[f"histogram{bins}_t4_ms"] = cs.median_ms(ring_of(out4), dev)
    finally:
        ops.load_kernel, ops.ring_geometry = load, geometry
    return res


def time_cells(cs, ops, dev, seed, variants) -> dict:
    """Part 4: the count and ratio banks' step on both thread mappings."""
    import numpy as np
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    n = cs.TIMED_LAUNCHES
    load = ops.load_kernel
    out = {}
    for name, apps, warm in (("count_bank", cs.count_bank_apps(),
                              cs.COUNT_BANK_BLOCKS),
                             ("ratio_bank", cs.ratio_bank_apps(),
                              cs.RATIO_BANK_BLOCKS)):
        bank = CompiledPatternBank(apps, n_partitions=cs.BANK_P,
                                   n_slots=cs.BANK_K, pattern_chunk=20,
                                   ring=cs.BANK_RING, device=dev)
        blocks = [bank.nfa.to_device(b) for b in cs.bank_blocks(
            np.random.default_rng(seed + len(name)), warm + 2 + n,
            gap=1_000)]
        for b in blocks[:warm]:
            bank.process_block(b)
        spec, kp = bank.nfa.spec, bank.nfa.kprog
        carry, prm = bank._stack_carry, bank._stack_params

        def step(c=carry, b=blocks[warm], **kw):
            return ops.nfa_bank_lanes(spec, c, b, prm, kp, **kw)

        def times():
            work = {k: v.clone() for k, v in carry.items()}
            it = iter(blocks[warm + 1:])
            return {"ms": cs.median_ms(step, dev,
                                       sleep_cycles=5 * cs.SLEEP_CYCLES),
                    "inplace_ms": cs.median_ms(
                        lambda: step(c=work, b=next(it), inplace=True), dev,
                        n=n, sleep_cycles=5 * cs.SLEEP_CYCLES)}
        t0 = ops.nfa_bank_step.thread_launches
        res = {"default": times()}
        want = step()
        try:
            ops.load_kernel = lambda lib: variants[f"patterns_{lib}"]
            ops.BANK_LANES = 8
            got = step()
            torch.cuda.synchronize()
            for k in want[0]:
                if not cs._same_bits(want[0][k], got[0][k]):
                    raise AssertionError(f"{name}: thread mappings differ: "
                                         f"carry.{k}")
            if not all(cs._same_bits(x, y)
                       for x, y in zip(want[1:], got[1:])):
                raise AssertionError(f"{name}: thread mappings differ: "
                                     f"outputs")
            res["warp_patterns"] = times()
        finally:
            ops.load_kernel = load
            ops.BANK_LANES = 32
        res["thread_launches"] = ops.nfa_bank_step.thread_launches - t0
        res["matches"] = int(want[1].sum())
        out[name] = res
        del bank, carry, blocks, want, got
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", action="store_true",
                    help="only part 4: the count and ratio banks")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bank_probe: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from siddhi_tpu_torch.ops import _kernels
    from siddhi_tpu_torch.ops import nfa as ops
    dev = "cuda"
    _kernels.build_all()
    mapping = [(BANK_LANES, BANK_LANES.replace("32", "8"))]
    cells = {f"patterns_{lib}": build_variant(_kernels, f"patterns_{lib}",
                                              mapping, lib)
             for lib in ("nfa_step", "nfa_prog")}
    if args.cells:
        out = {"device": torch.cuda.get_device_name(0),
               "nvidia_smi": cs.nvidia_smi_line(),
               "cells": time_cells(cs, ops, dev, args.seed, cells)}
        print("BANKPROBE " + json.dumps(out), flush=True)
        return 0
    variants = {
        "nowalk": build_variant(_kernels, "nowalk", [(EVENT_WALK, EVENT_WALK.
                                replace("on &&", "false && on &&"))]),
        "patterns": build_variant(_kernels, "patterns", [(
            BANK_LANES, BANK_LANES.replace("32", "8"))]),
        "histogram16": build_variant(_kernels, "histogram16",
                                     ring_histogram(16)[0]),
        "histogram128": build_variant(_kernels, "histogram128",
                                      ring_histogram(128)[0])}
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(),
           "checks": run_checks(cs, dev, args.seed)}
    out["alert"] = time_band(cs, ops, dev, args.seed + 7, cs.BANK_FLOOR,
                             np.linspace(99.8, 99.997, cs.N_BANK), variants)
    out["matchy"] = time_band(cs, ops, dev, args.seed + 8, 0.0,
                              np.linspace(5.0, 95.0, cs.N_BANK), variants)
    out["cells"] = time_cells(cs, ops, dev, args.seed, cells)
    print("BANKPROBE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
