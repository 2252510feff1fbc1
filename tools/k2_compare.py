#!/usr/bin/env python3
"""Time the pattern path's NFA kernels, the pattern cell, the pattern
bank's step and the fleet cell in several checkouts of the port, one
fresh process per checkout, on one GPU.

    python3 tools/k2_compare.py DIR [DIR ...] [--pattern-chunks N]
                                [--fleet-blocks B] [--no-pattern]
                                [--bank-cells] [--seed S]

Each DIR is the root of a checkout (its ``chip_smoke.py`` and
``siddhi_tpu_torch/``); list the trees in turns (parent, change, change,
parent) to compare them on one card.  Per tree, at the pattern cell's
shape (``chip_smoke.py`` phase 5: P = 16384 lanes, T = the busiest key's
events in a chunk, K = 8):

  - a tree with the fused step (``ops.nfa.nfa_step_egress``): that
    tree's ``chip_smoke.time_nfa`` (the fused call, the compaction alone,
    the device split, the bounds);
  - a tree with the dense-output step (``ops.nfa.nfa_block_step``): its
    ``time_nfa`` (the step alone), its egress compaction (``torch.
    nonzero_static`` and gathers) alone, and the two in sequence;

then the pattern cell alone (``chip_smoke.run_pattern_path``, N chunks
of 262,144 events, every row held against the reference): wall,
events/s, ms per chunk and the peak device memory above what the
process held before it (``--no-pattern`` leaves these out).

Per tree with the pattern bank (``ops.nfa.nfa_bank_lanes``), at the fleet
shape (1000 patterns x 10,000 lanes, T = 64, K = 8, 5 stacked chunks of
200): the bank step's median ms over 20 launches (not in place, after a
warm-up block) on an alert-band block (``chip_smoke.py`` phase 8's
thresholds) and on a matchy-band block (5..95, floor 0), and the match
ring's (``ops.nfa.nfa_bank_ring``, ring 32) on each block's outputs;
then the fleet cell (``chip_smoke.run_fleet_cell``, B blocks, its
checks included): events/s and ms per block; then the latency cell
(``chip_smoke.run_latency_cell``, T = 4): p50, p99, compute-only.
Each tree prints one line ``K2COMPARE {json}``.  Needs CUDA and nvcc;
builds each tree's kernels in that tree.

With ``--bank-cells`` a tree runs this instead: every NFA library
(``nfa_step``, ``nfa_wide``, ``nfa_bank_wide``, ``nfa_gang`` and their
condition-program builds, those the tree has) built with ``-Xptxas -v``,
each kernel instance's register count and spill bytes (the first time
the tree's libraries are built: a tree listed twice reuses them); then
the bank step (``ops.nfa.nfa_bank_lanes``) on seven banks at the fleet's
lanes (10,000, T = 64, K = 8): phase 8's fleet (1000 patterns, alert
band), phase 11's absent fleet (config 3, 1000 patterns), its count bank
(config 4, 100 patterns), its ratio bank (the Quick start, 100
patterns) and its three widened banks (100 patterns over the feed's
kinds 0..2: SEQUENCE and logical `or` in the matchy band, phase 8's
alert bank with telemetry).  Per bank, after warm blocks through
``process_block``: the step not in place on the next block and in place
over TIMED_LAUNCHES fresh blocks from a copy of the carry (median ms, L2
flushed), and the instance each ran on.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys


def time_bank_step(cs, ops, floor, thrs, seed, dev) -> dict:
    """Median ms of the tree's bank step (its wrapper, not in place) at the
    fleet shape on the second of two blocks of the given band."""
    import numpy as np
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank
    bank = CompiledPatternBank([cs.bank_app(t, floor=floor) for t in thrs],
                               n_partitions=cs.BANK_P, n_slots=cs.BANK_K,
                               pattern_chunk=cs.BANK_CHUNK,
                               ring=cs.BANK_RING, device=dev)
    raw = cs.bank_blocks(np.random.default_rng(seed), 2)
    bank.process_block(bank.nfa.to_device(raw[0]))
    block = bank.nfa.to_device(raw[1])
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    carry, prm = bank._stack_carry, bank._stack_params
    ms = cs.median_ms(lambda: ops.nfa_bank_lanes(spec, carry, block, prm,
                                                 kp),
                      dev, sleep_cycles=5 * cs.SLEEP_CYCLES)
    out = ops.nfa_bank_lanes(spec, carry, block, prm, kp)
    ring_ms = cs.median_ms(lambda: ops.nfa_bank_ring(*out, cs.BANK_RING),
                           dev)
    del bank, carry, block, out
    torch.cuda.empty_cache()
    return {"ms": ms, "ring_ms": ring_ms,
            "band": [float(thrs[0]), float(thrs[-1])], "floor": floor}


#: --bank-cells' banks: (patterns, pattern chunk, warm blocks, block gap
#: in ms); the app texts are written here so that a tree's chip_smoke.py
#: need not have them
BANK_CELLS = {"fleet": (1000, 200, 2, 10_000),
              "absent_fleet": (1000, 200, 2, 10_000),
              "count_bank": (100, 20, 3, 1_000),
              "ratio_bank": (100, 20, 8, 1_000),
              "wide_sequence": (100, 20, 2, 10_000),
              "wide_logical": (100, 20, 2, 10_000),
              "wide_telemetry_alert": (100, 20, 2, 10_000)}
#: the widened banks' queries (chip_smoke.py WIDE_BANK_APPS' SEQUENCE
#: and `or` kinds), over the matchy band
WIDE_CELL_QUERIES = {
    "wide_sequence": (
        "from every e1=S[kind == 0 and price > {t}], e2=S[kind == 1 and "
        "price > e1.price] within 10 sec select e1.price as p1, e2.price "
        "as p2 insert into Out;"),
    "wide_logical": (
        "from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 and "
        "price > e1.price] or e3=S[kind == 2 and price < e1.price] within "
        "10 sec select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;")}


def bank_cell_apps(cs, name):
    """The bank cell's apps (chip_smoke.py phases 8 and 11)."""
    import numpy as np
    if name == "fleet":
        return [cs.bank_app(t) for t in np.linspace(99.8, 99.997, 1000)]
    if name == "absent_fleet":
        return [cs.absent_bank_app(t)
                for t in np.linspace(99.8, 99.997, 1000)]
    if name in WIDE_CELL_QUERIES:
        return [cs._S3 + WIDE_CELL_QUERIES[name].format(t=round(float(t), 3))
                for t in np.linspace(5.0, 95.0, 100)]
    if name == "wide_telemetry_alert":
        return [cs.bank_app(t) for t in np.linspace(99.8, 99.997, 100)]
    if name == "count_bank":
        return [cs._S3 + f"from every e1=S[kind == 0 and price > {t}]"
                "<3:10> -> e2=S[kind == 1 and price > e1[last].price] "
                "within 10 sec select e1[0].price as p0, e1[last].price as "
                "pl, e2.price as p2 insert into Out;"
                for t in np.linspace(0.0, 99.0, 100)]
    return [cs._S3 + f"from every e1=S[kind == 0 and price > "
            f"{round(float(t), 3)}] -> e2=S[kind == 1 and price > e1.price "
            f"* {round(float(r), 4)}] within 10 sec select e1.price as p1, "
            "e2.price as p2 insert into Out;"
            for t, r in zip(np.linspace(5.0, 95.0, 100),
                            np.linspace(1.0, 1.1, 100))]


def _instance_name(mangled: str) -> str:
    """A kernel's mangled name as ``base<args>`` (template arguments)."""
    import re
    k = re.search(r"(nfa_[a-z_]+_kernel)(I.*?EE)?", mangled)
    if not k:
        return mangled
    args = re.findall(r"L[ib](-?\d+)E", k.group(2) or "")
    return f"{k.group(1)}<{','.join(args)}>" if args else k.group(1)


def ptxas_info(logs):
    """({library: {kernel instance: registers}}, {library: {kernel
    instance: [spill store bytes, spill load bytes]}}) from ``-Xptxas
    -v`` output (mangled names, e.g. ``nfa_bank_thread_kernel<8,0,1>``
    for ``_Z...nfa_bank_thread_kernelILi8ELb0ELb1EE...``; the spills from
    the line after the kernel's "Function properties for" line)."""
    import re
    out, out_spill = {}, {}
    for lib, log in logs.items():
        regs, spill, name, prop = {}, {}, None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = _instance_name(m.group(1))
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                prop = _instance_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and prop:
                spill[prop] = [int(m.group(1)), int(m.group(2))]
                prop = None
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name] = int(m.group(1))
                name = None
        out[lib] = regs
        out_spill[lib] = {k: v for k, v in spill.items() if k in regs}
    return out, out_spill


def run_bank_cells(tree: str, seed: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from siddhi_tpu_torch.ops import _kernels
    from siddhi_tpu_torch.ops import nfa as ops
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternBank

    dev = "cuda"
    libs = [n for n in ("nfa_step", "nfa_prog", "nfa_wide", "nfa_wide_prog",
                        "nfa_bank_wide", "nfa_bank_wide_prog", "nfa_gang",
                        "nfa_gang_prog")
            if n in _kernels.SIGNATURES]
    logs = _kernels.build_all(libs, verbose=True)
    registers, spills = ptxas_info(logs)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(), "registers": registers,
           "spills": spills}
    n = cs.TIMED_LAUNCHES
    for name, (n_pat, chunk, warm, gap) in BANK_CELLS.items():
        wide = name.startswith("wide_")
        bank = CompiledPatternBank(bank_cell_apps(cs, name),
                                   n_partitions=cs.BANK_P,
                                   n_slots=cs.BANK_K, pattern_chunk=chunk,
                                   ring=cs.BANK_RING, device=dev,
                                   telemetry=name == "wide_telemetry_alert")
        rng = np.random.default_rng(seed + len(name))
        blocks = [bank.nfa.to_device(b) for b in cs.bank_blocks(
            rng, warm + 2 + n, gap=gap, **({"kinds": 3} if wide else {}))]
        for b in blocks[:warm]:
            bank.process_block(b)
        spec, kp = bank.nfa.spec, bank.nfa.kprog
        carry, prm = bank._stack_carry, bank._stack_params
        t0, g0, w0, x0 = (
            ops.nfa_bank_step.thread_launches,
            ops.nfa_bank_step.group_launches,
            getattr(ops.nfa_bank_step, "wide_launches", 0),
            getattr(ops.nfa_bank_step, "wide_thread_launches", 0))
        res = {"patterns": n_pat, "ms": cs.median_ms(
            lambda: ops.nfa_bank_lanes(spec, carry, blocks[warm], prm, kp),
            dev, sleep_cycles=5 * cs.SLEEP_CYCLES)}
        work = {k: v.clone() for k, v in carry.items()}
        it = iter(blocks[warm + 1:])
        res["inplace_ms"] = cs.median_ms(lambda: ops.nfa_bank_lanes(
            spec, work, next(it), prm, kp, inplace=True), dev, n=n,
            sleep_cycles=5 * cs.SLEEP_CYCLES)
        res["instance"] = {
            "thread": ops.nfa_bank_step.thread_launches - t0,
            "group": ops.nfa_bank_step.group_launches - g0,
            "wide": getattr(ops.nfa_bank_step, "wide_launches", 0) - w0,
            "wide_thread": getattr(ops.nfa_bank_step, "wide_thread_launches",
                                   0) - x0}
        out[name] = res
        del bank, carry, work, blocks
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_tree(tree: str, n_chunks: int, seed: int, fleet_blocks: int,
             pattern: bool) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from siddhi_tpu_torch.ops import _kernels
    from siddhi_tpu_torch.ops import nfa as ops
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA

    dev = "cuda"
    _kernels.build_all()
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line()}
    if hasattr(ops, "nfa_bank_lanes"):
        out["bank_alert"] = time_bank_step(
            cs, ops, cs.BANK_FLOOR, np.linspace(99.8, 99.997, cs.N_BANK),
            seed + 7, dev)
        out["bank_matchy"] = time_bank_step(
            cs, ops, 0.0, np.linspace(5.0, 95.0, cs.N_BANK), seed + 8, dev)
        fc = cs.run_fleet_cell(dev, seed, fleet_blocks)
        out["fleet"] = {"events_per_s": fc["events_per_s"],
                        "ms_per_block": fc["wall"] / fleet_blocks * 1e3,
                        "wall_s": fc["wall"], "walls_s": fc.get("walls"),
                        "blocks": fleet_blocks,
                        "step_ms": fc["step_ms"], "ring_ms": fc["ring_ms"]}
        del fc
        gc.collect()
        torch.cuda.empty_cache()
        lat = cs.run_latency_cell(dev, seed)
        out["latency"] = {k: lat[k] for k in (
            "p50_ms", "p99_ms", "compute_only_median_ms",
            "compute_only_mad_ms")}
        gc.collect()
        torch.cuda.empty_cache()
    if not pattern:
        return out
    pchunks = cs.make_pattern_chunks(seed, n_chunks)
    t_pat = max(int(np.bincount(c[0]["partition"],
                                minlength=cs.N_PATTERN_KEYS).max())
                for c in pchunks)
    out["T"] = t_pat
    if hasattr(ops, "nfa_step_egress"):
        out["fused"] = cs.time_nfa(t_pat, dev, seed)
    else:
        ms, _plain, bound, by = cs.time_nfa(t_pat, dev, seed)
        P, K = cs.PATTERN_LANES, cs.PATTERN_SLOTS
        nfa = CompiledPatternNFA(cs.pattern_query(cs.PARTITIONED_APP),
                                 n_partitions=P, n_slots=K, device=dev)
        spec, kp = nfa.spec, nfa.kprog
        warm, blk = cs._nfa_blocks(nfa, P, t_pat, 2, seed, dev)
        carry, _ = ops.nfa_block_step(spec, nfa.carry, warm, kp)
        _, outs = ops.nfa_block_step(spec, carry, blk, kp)
        count = int(outs[0].sum())
        cap = 1 << max(count - 1, 0).bit_length()
        pack = nfa._egress_pack_fn()
        k4_ms = cs.median_ms(
            lambda: pack(*outs, carry["dropped"], None, None, cap), dev)
        both_ms = cs.median_ms(lambda: pack(
            *ops.nfa_block_step(spec, carry, blk, kp)[1], carry["dropped"],
            None, None, cap), dev)
        out["dense"] = {"step_ms": ms, "bound_ms": bound, "bound_by": by,
                        "k4_ms": k4_ms, "step_plus_k4_ms": both_ms,
                        "count": count, "cap": cap}
        del nfa, warm, blk, carry, outs
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _launches, wall = cs.run_pattern_path(pchunks, dev)
    n_events = n_chunks * cs.CHUNK
    out["pattern"] = {"wall_s": wall, "events_per_s": n_events / wall,
                      "ms_per_chunk": wall / n_chunks * 1e3,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "held_before_bytes": mem0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--pattern-chunks", type=int, default=16)
    ap.add_argument("--fleet-blocks", type=int, default=32)
    ap.add_argument("--no-pattern", action="store_true")
    ap.add_argument("--bank-cells", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        tree = os.path.abspath(args.trees[0])
        res = run_bank_cells(tree, args.seed) if args.bank_cells else \
            run_tree(tree, args.pattern_chunks, args.seed,
                     args.fleet_blocks, not args.no_pattern)
        print("K2COMPARE " + json.dumps(res), flush=True)
        return 0
    rc = 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--child",
             "--pattern-chunks", str(args.pattern_chunks),
             "--fleet-blocks", str(args.fleet_blocks),
             "--seed", str(args.seed)] +
            (["--no-pattern"] if args.no_pattern else []) +
            (["--bank-cells"] if args.bank_cells else []), cwd=tree)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
