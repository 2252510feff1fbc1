#!/usr/bin/env python3
"""A/B of the grouped-aggregation kernels on one GPU: the split design
against its all-warp variant and, optionally, another source.

    python3 tools/gagg_probe.py [--seed S] [--parent PATH]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.

``csrc/grouped_agg.cu`` reduces a group's live range of at most ``kShort``
entries on one thread (K7b: the pairwise tree over its live slots) and a
longer one on the warp (K7a: down the chain 32 entries a step; K7b: the
dense tree over the ring's slots).  This probe builds the same source a
second time with ``kShort = 0``: every non-empty range goes to the warp.
``--parent PATH`` builds a third library from another ``grouped_agg.cu``
with the same C entry points (e.g. an earlier commit's, unpacked with
``git archive``; one that takes no scratch is given none).

At each launch shape of ``chip_smoke.py`` phase 12 (``GAGG_TIMED``: the
grouped, keyed and time cells' K7 launches, a carry with a full window
first, the same random feed), every build steps the same carry on the same
events, not in place; every output plane and carry leaf must be equal bit
for bit (NaN payloads aside).  Then each build is timed with CUDA events
(``chip_smoke.median_ms``: the L2 flushed before each run), in the order
split, warp, parent, parent, warp, split.

Prints one line ``GAGGPROBE {json}`` with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the short-range limit, as the source has it
SHORT = "constexpr int kShort = 32;"


def build_variant(kernels, tag, src_path, edits=()):
    """The source at src_path with each text `old` of the (old, new) edits
    made `new`, built into the checkout's build directory and bound like
    the real one.  A source without gagg_scratch_words (an earlier design)
    is bound with a stand-in that asks for no scratch."""
    src = open(src_path).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{src_path}: {old!r} is not where this "
                               f"probe expects it")
        src = src.replace(old, new)
    os.makedirs(kernels.BUILD, exist_ok=True)
    cu = os.path.join(kernels.BUILD, f"grouped_agg_{tag}.cu")
    so = os.path.join(kernels.BUILD, f"grouped_agg_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
                   ["-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    bound = types.SimpleNamespace()
    for fn, (restype, argtypes) in kernels.SIGNATURES["grouped_agg"].items():
        if not hasattr(lib, fn):
            continue
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
        setattr(bound, fn, f)
    if not hasattr(bound, "gagg_scratch_words"):
        bound.gagg_scratch_words = lambda *dims: 0
    return bound


def ab_shape(cs, ga, libs, name, seed, dev) -> dict:
    """One GAGG_TIMED shape: every build's outputs compared, then timed in
    turns → {tag: [ms, ms], ...}."""
    import numpy as np
    import torch
    kind, P, T, W, G, VF, VI, ms = cs.GAGG_TIMED[name]
    case = dict(kind=kind, P=P, W=W, G=G, VF=VF, VI=VI, ms=ms, minmax=True)
    kstep, _, make = cs._gagg_steps(case, G)
    rng = np.random.default_rng(seed + 13)

    def feed(t, t0):
        vf, vi, g, _, ok = cs._gagg_feed(rng, case, t, 0.75, t0)
        ts = (t0 + np.arange(t, dtype=np.int32))[None, :].repeat(P, 0)
        args = [torch.tensor(a, device=dev) for a in (vf, vi, g)]
        if kind == "time":
            args.append(torch.tensor(ts, device=dev))
        return args + [torch.tensor(ok, device=dev)]

    def use(tag):
        ga.load_kernel = lambda _name, lib=libs[tag]: lib

    use("split")
    carry, _ = kstep(make(dev), *feed(max(W, 1) + 7, 0))
    args = feed(T, W + 7)
    got = {}
    for tag in libs:
        use(tag)
        nc, outs = kstep(carry, *args)
        torch.cuda.synchronize()
        got[tag] = list(outs) + list(nc)
    for tag in libs:
        for i, (x, y) in enumerate(zip(got["split"], got[tag])):
            if not cs._nan_equal(x, y):
                raise AssertionError(f"{name}: build {tag} differs from "
                                     f"the split build on leaf {i}")
    runs = 3 if T > 4096 else cs.TIMED_LAUNCHES
    res = {"kind": kind, "shape": {"P": P, "T": T, "W": W, "G": G,
                                   "VF": VF, "VI": VI, "window_ms": ms},
           "runs": runs} | {tag: [] for tag in libs}
    order = [t for t in ("split", "warp", "parent") if t in libs]
    for tag in order + order[::-1]:
        use(tag)
        res[tag].append(cs.median_ms(lambda: kstep(carry, *args), dev,
                                     n=runs))
    print(f"  {name}: " + ", ".join(f"{t} {res[t]} ms" for t in order),
          file=sys.stderr, flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="another grouped_agg.cu to build and time")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("gagg_probe: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from siddhi_tpu_torch.ops import _kernels
    from siddhi_tpu_torch.ops import grouped_agg as ga
    dev = "cuda"
    _kernels.build_all(["grouped_agg"])
    load = ga.load_kernel
    src = os.path.join(_kernels.CSRC, "grouped_agg.cu")
    libs = {"split": _kernels.load_kernel("grouped_agg"),
            "warp": build_variant(_kernels, "warp", src,
                                  [(SHORT, SHORT.replace("32", "0"))])}
    if args.parent:
        libs["parent"] = build_variant(_kernels, "parent", args.parent)
    launches = cs._gagg_launches()
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(), "parent": args.parent}
    try:
        for name in cs.GAGG_TIMED:
            out[name] = ab_shape(cs, ga, libs, name, args.seed, dev)
    finally:
        ga.load_kernel = load
        cs._set_gagg_launches(launches)
    print("GAGGPROBE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
