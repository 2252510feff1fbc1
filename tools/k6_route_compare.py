#!/usr/bin/env python3
"""Drive the K6 cell's app (``chip_smoke.py`` phase 20: a partitioned
``#window.time(1 sec)`` grouped by its key, sum/count/avg/min/max over
1,024 string keys, 256 events a ms) in several checkouts of the port, one
fresh process per checkout, on one GPU.

    python3 tools/k6_route_compare.py DIR [DIR ...] [--chunks N] [--reps R]
                                      [--seed S]

Each DIR is the root of a checkout (its ``siddhi_tpu_torch/``); list the
trees in turns (parent, change, change, parent) to compare them on one
card.  The feed, the app and the float64 reference are this checkout's
(``chip_smoke.make_window_chunks``, ``K6_APP``, ``k6_reference``); only
the engine is the tree's.  Per tree: one untimed run of a chunk (it
builds the kernel the query runs), then R runs of N chunks, each on a
fresh app runtime, through the public API on the device engine under
torch.profiler (``chip_smoke._drive_cell``).  A run reports the query's
runtime (``DeviceWindowedAggRuntime`` with window kind "time" on K6, or
``DeviceGroupedAggRuntime`` on K7b), wall, events/s, ms per chunk, the
ledger stages, device ms and idle share, the device ms of K6's and K7's
kernels and the launches of each.  Every row is held against the
reference, in (ts, key, arrival) order since a partitioned runtime may
emit a block's rows lane by lane: keys, counts, min/max exact, sum/avg
rel <= 1e-5.  Each tree prints one line ``K6ROUTE {json}``.  Needs CUDA
and nvcc; builds each tree's kernels in that tree.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    """This checkout's chip_smoke.py as a module of another name, so that
    its lazy ``siddhi_tpu_torch`` imports resolve to the tree on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "k6_route_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counters():
    """{name: counted entry point} of the kernels the tree has."""
    from siddhi_tpu_torch.ops import grouped_agg as ga
    from siddhi_tpu_torch.ops import windowed_agg as wa
    out = {"K7a": ga.grouped_step, "K7b": ga.grouped_time_step}
    if hasattr(wa, "time_wagg_step"):
        out["K6"] = wa.time_wagg_step
    return out


def check_rows(names, chunks, got, ref):
    """Every row against the float64 reference, order-free across lanes."""
    import numpy as np
    S, N, LO, HI = ref
    code = {n: i for i, n in enumerate(names)}
    g = {k: np.concatenate([x[k] for x in got]) for k in got[0]}
    if len(g["n"]) != len(N):
        raise AssertionError(f"{len(g['n'])} rows, reference {len(N)}")
    gk = np.fromiter((code[s] for s in g["sym"]), np.int64, len(g["sym"]))
    go = np.lexsort((np.arange(len(gk)), gk, g["ts"]))
    ki = np.concatenate([c[2] for c in chunks]).astype(np.int64)
    ts = np.concatenate([c[1] for c in chunks])
    ro = np.lexsort((np.arange(len(ki)), ki, ts))
    if not ((g["ts"][go] == ts[ro]).all() and (gk[go] == ki[ro]).all()
            and (g["n"][go] == N[ro]).all() and (g["lo"][go] == LO[ro]).all()
            and (g["hi"][go] == HI[ro]).all()):
        raise AssertionError("rows, keys, counts or min/max differ from the "
                             "reference")
    worst = 0.0
    for col, want in (("t", S), ("a", S / N)):
        w = want[ro]
        err = np.abs(g[col][go] - w) / np.maximum(np.abs(w), 1e-30)
        worst = max(worst, float(err.max()))
        if not (err <= 1e-5).all():
            raise AssertionError(f"{col} rel err {err.max():.3g}")
    return worst


def run_once(cs, names, chunks, dev, ref):
    import numpy as np
    import torch
    from siddhi_tpu_torch import ColumnarStreamCallback, SiddhiManager
    counters = _counters()
    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(cs.K6_APP)
    pr = rt.partition_runtimes[0]
    if not pr.device_mode:
        raise AssertionError(f"partition on the host: {pr.fallback_reason}")
    qr = pr.device_query_runtimes["q"]
    drt = qr.device_runtime
    route = {"backend": qr.backend, "runtime": type(drt).__name__,
             "window_kind": getattr(getattr(drt, "cwa", None),
                                    "window_kind", None)}
    got = []
    rt.add_callback("Out", ColumnarStreamCallback(
        lambda c: got.append({k: np.array(c.columns[k])
                              for k in ("sym", "t", "n", "a", "lo", "hi")}
                             | {"ts": np.array(c.timestamps)})))
    rt.start()

    def reset():
        for f in counters.values():
            f.launches = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    wall, per_kernel, dev_us, stages, launches = cs._drive_cell(
        rt, "T", [(c, ts) for c, ts, _ in chunks],
        lambda: {k: f.launches for k, f in counters.items()}, reset=reset)
    peak = torch.cuda.max_memory_allocated(dev)
    rt.shutdown()
    n_events = len(chunks) * cs.CHUNK
    res = {"route": route, "wall_s": wall, "events_per_s": n_events / wall,
           "ms_per_chunk": wall / len(chunks) * 1e3, "launches": launches,
           "stages_s": stages, "peak_bytes": peak}
    if per_kernel is not None:
        res.update(device_ms=dev_us / 1e3,
                   idle_share=100 - dev_us / 1e6 / wall * 100,
                   k6_ms=sum(us for k, us in per_kernel.items()
                             if "wagg_time" in k) / 1e3,
                   k7_ms=sum(us for k, us in per_kernel.items()
                             if "gagg_" in k) / 1e3)
    if ref is not None:
        res["max_rel_err"] = check_rows(names, chunks, got, ref)
        res["rows"] = len(ref[1])
    return res


def run_tree(tree: str, n_chunks: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, tree)
    import torch
    cs = _load_smoke()
    import siddhi_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(siddhi_tpu_torch.__file__))) != tree:
        raise AssertionError(f"imported {siddhi_tpu_torch.__file__}")
    dev = "cuda"
    names, chunks = cs.make_window_chunks(seed, n_chunks)
    ref = cs.k6_reference(chunks)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(), "chunks": n_chunks,
           "warm": run_once(cs, names, chunks[:1], dev, None)}
    out["runs"] = [run_once(cs, names, chunks, dev, ref)
                   for _ in range(reps)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        res = run_tree(os.path.abspath(args.trees[0]), args.chunks,
                       args.reps, args.seed)
        print("K6ROUTE " + json.dumps(res), flush=True)
        return 0
    rc = 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--child",
             "--chunks", str(args.chunks), "--reps", str(args.reps),
             "--seed", str(args.seed)], cwd=tree)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
