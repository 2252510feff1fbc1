#!/usr/bin/env python3
"""Time the NFA step (K2 + K4: ``nfa_step_egress``) and the gang (K12:
``nfa_gang_step_egress`` over one tenant) at the pattern and count cells'
shapes in several checkouts of the port, one fresh process per checkout,
on one GPU.

    python3 tools/nfa_step_compare.py DIR [DIR ...] [--seed S] [--n N]

Each DIR is the root of a checkout (its ``chip_smoke.py`` and
``siddhi_tpu_torch/``); list the trees in turns (parent, change, change,
parent) to compare them on one card.  Per tree and cell, on a carry in
steady state (one warm block stepped first) at the cap and scratch
segment the engine settles on:

  - pattern cell: ``chip_smoke.PARTITIONED_APP``'s query, P = 16,384
    lanes, K = 8, T = the busiest of 10,000 keys in a chunk of 262,144
    events (``chip_smoke.make_pattern_chunks``);
  - count cell: ``chip_smoke.COUNT_APP``'s query (BASELINE config 4),
    P = 131,072 lanes (100,000 keys), K = 8, T = the busiest key in a
    chunk (``chip_smoke.make_count_chunks``);

the median ms of N calls (``chip_smoke.median_ms``, CUDA events) of the
fused step and of the gang call, and each result held equal to the other
(carry and slab).  Each tree prints one line ``NFACOMPARE {json}``.
Needs CUDA and nvcc; builds each tree's kernels in that tree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def cell_times(cs, ops, dev, app, P, T, seed, n):
    """(K2 ms, K12 ms, matches) of one cell's query at [P, T], K = 8."""
    import torch
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    nfa = CompiledPatternNFA(app, n_partitions=P, n_slots=8, device=dev)
    spec, kp = nfa.spec, nfa.kprog
    warm, blk = cs._nfa_blocks(nfa, P, T, 2, seed, dev)
    carry, _ = ops.nfa_step_egress(spec, nfa.carry, warm, kp)
    _, eg = ops.nfa_step_egress(spec, carry, blk, kp)
    count = int(eg.buf[-2, 0])
    cap = 1 << max(count - 1, 0).bit_length()
    seg = max(eg.seg, 1 << max(int(eg.buf[-1, 0]) - 1, 0).bit_length())
    new1, e1 = ops.nfa_step_egress(spec, carry, blk, kp, cap, seg)
    tenant = [ops.GangTenant(spec, carry, blk, kp, cap, seg)]
    new2, e2 = ops.nfa_gang_step_egress(tenant)
    torch.cuda.synchronize()
    for k in new1:
        if not torch.equal(new1[k].view(torch.int32) if new1[k].dtype ==
                           torch.float32 else new1[k],
                           new2[0][k].view(torch.int32) if new2[0][k].dtype
                           == torch.float32 else new2[0][k]):
            raise AssertionError(f"gang carry.{k} != the step's")
    n_rows = min(count, cap)
    if not torch.equal(e1.buf[:n_rows], e2.egress[0].buf[:n_rows]):
        raise AssertionError("gang slab != the step's")
    k2 = cs.median_ms(lambda: ops.nfa_step_egress(spec, carry, blk, kp, cap,
                                                  seg),
                      dev, n=n, sleep_cycles=5 * cs.SLEEP_CYCLES)
    k12 = cs.median_ms(lambda: ops.nfa_gang_step_egress(tenant), dev, n=n,
                       sleep_cycles=5 * cs.SLEEP_CYCLES)
    return k2, k12, count


def run_tree(tree: str, seed: int, n: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from siddhi_tpu_torch.ops import _kernels
    from siddhi_tpu_torch.ops import nfa as ops

    dev = "cuda"
    _kernels.build_all(["nfa_step", "nfa_gang"])
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line()}
    pchunks = cs.make_pattern_chunks(seed, 2)
    t_pat = max(int(np.bincount(c[0]["partition"],
                                minlength=cs.N_PATTERN_KEYS).max())
                for c in pchunks)
    cchunks = cs.make_count_chunks(seed, 2)
    t_cnt = max(int(np.bincount(c[2], minlength=cs.N_COUNT_KEYS).max())
                for c in cchunks)
    count_q = cs.pattern_query(cs.COUNT_APP)
    cells = {"pattern": (cs.pattern_query(cs.PARTITIONED_APP),
                         cs.PATTERN_LANES, t_pat),
             "count": (count_q, 1 << (cs.N_COUNT_KEYS - 1).bit_length(),
                       t_cnt)}
    for name, (app, P, T) in cells.items():
        k2, k12, count = cell_times(cs, ops, dev, app, P, T, seed, n)
        out[name] = {"P": P, "T": T, "K": 8, "matches": count,
                     "k2_ms": k2, "k12_ms": k12}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--one", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        res = run_tree(os.path.abspath(args.trees[0]), args.seed, args.n)
        print("NFACOMPARE " + json.dumps(res, sort_keys=True), flush=True)
        return 0
    rc = 0
    for tree in args.trees:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", "--seed", str(args.seed), "--n",
                            str(args.n), os.path.abspath(tree)],
                           cwd=os.path.abspath(tree))
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
