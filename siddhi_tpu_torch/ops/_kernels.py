"""Build and bind the port's CUDA kernels (``siddhi_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``.  Libraries land in ``siddhi_tpu_torch/_build/`` named by a
hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused within a checkout.  No PyTorch headers are involved: a build
takes seconds, not minutes.

:func:`build_all` starts one ``nvcc`` per source at once (used by
``chip_smoke.py``); :func:`load_kernel` builds (if needed) and loads one.
A build or load failure raises ``RuntimeError``: no caller falls back to
a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "_build")

#: Hopper only; no --use_fast_math (the Kahan lines must not be
#: re-associated) and no FMA contraction, so the kernels compute the
#: plain versions' float32 operations one for one.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: C entry points, per source file: (return type, argument types)
SIGNATURES: Dict[str, Dict[str, Tuple[type, list]]] = {
    "wagg_length": {
        # values, ok_u8, ring, pos, cnt, runsum, comp, sums, counts,
        # mins, maxs, P, T, W, want_minmax, scratch, stream
        "wagg_length_step": (_I, [_VP] * 11 + [_I, _I, _I, _I, _VP, _VP]),
        # P, T, W, want_minmax -> bytes of device scratch the step needs
        "wagg_length_scratch_bytes": (_LL, [_I, _I, _I, _I]),
    },
    "wagg_time": {
        # values, ts, ok, carry in (ring, ring_ts, pos, cnt, last_ts,
        # overflow), carry out (the same six), sums, counts, mins, maxs,
        # scratch, scratch bytes, P, T, C, window_ms, want_minmax, stream
        "wagg_time_step": (_I, [_VP] * 20 + [_LL] + [_I] * 5 + [_VP]),
        # P, T, C -> bytes of device scratch the step needs
        "wagg_time_scratch_bytes": (_LL, [_I, _I, _I]),
    },
    "dwin_step": {
        # header ints (ops/dwin.kernel_header), device pointers
        # (ops/dwin.dwin_launch order), scratch bytes, stream
        "dwin_step": (_I, [_VP, _VP, _LL, _VP]),
        # header ints -> bytes of device scratch a step needs
        "dwin_scratch_bytes": (_LL, [_VP]),
    },
    "grouped_agg": {
        # pointers (events, carry in, carry out, 13 output planes, the
        # scratch, in ops/grouped_agg._launch order), dims, stream
        "gagg_step": (_I, [_VP, _VP, _VP]),
        "gagg_time_step": (_I, [_VP, _VP, _VP]),
        # P, T, W, G, VF, VI, time -> int32 words of scratch a step needs
        "gagg_scratch_words": (_LL, [_I] * 7),
        # cudaEvent_t handles recorded at the passes' boundaries, count
        "gagg_time_passes": (_I, [_VP, _I]),
    },
    "iagg_fold": {
        # base_vals, seg, vals, comp (or null), cnt, fns (host ints), n, S,
        # B, scratch, scratch bytes, stream
        "iagg_fold": (_I, [_VP] * 6 + [_I] * 3 + [_VP, _LL, _VP]),
        # n, S -> bytes of device scratch a fold needs
        "iagg_scratch_bytes": (_LL, [_I, _I]),
    },
    "join_probe": {
        # mask (u8), nl, nr, nl2, nr2, cap, idx out, count out, scratch,
        # scratch bytes, stream
        "probe_compact": (_I, [_VP] + [_I] * 5 + [_VP] * 3 + [_LL, _VP]),
        # nl2, nr2 -> bytes of device scratch a compaction needs
        "probe_scratch_bytes": (_LL, [_I, _I]),
    },
    "nfa_step": {
        # attrs, ts, stream, gates, prog, prog_len,
        # carry in (ops/nfa.KERNEL_CARRY: st, start, enter, seq, arm_seq,
        # caps, dropped, armed, cnt_cur, cnt_prev, deadline), carry out
        # (the same eleven), rows, lane_count, fill, dl_min,
        # P, T, K, G, seg, A, RC, stream
        "nfa_step": (_I, [_VP] * 5 + [_I] + [_VP] * 26 + [_I] * 7 + [_VP]),
        # rows, lane_count, fill, dropped, dl_min, slab, P, L, seg, n_cta,
        # cap, W, stream
        "nfa_compact": (_I, [_VP] * 6 + [_I] * 6 + [_VP]),
        # attrs, ts, stream, gates, prog, prog_len, params, n_params,
        # carry in (eleven), carry out (eleven), count, lmt, lmk,
        # CN, P, T, K, G, A, RC, stream
        "nfa_bank_step": (_I, [_VP] * 5 + [_I] + [_VP] + [_I] +
                          [_VP] * 25 + [_I] * 7 + [_VP]),
        # the same, with TT for G, and smem, groups and n_cond after RC
        "nfa_bank_thread": (_I, [_VP] * 5 + [_I] + [_VP] + [_I] +
                            [_VP] * 25 + [_I] * 10 + [_VP]),
        # count, lmt, lmk, caps, slot_start, total, ring_cnt, ring_pid,
        # ring_caps, ring_ts, ring_ok, CN, P, K, RC, ring, tile, smem,
        # stream
        "nfa_bank_ring": (_I, [_VP] * 11 + [_I] * 7 + [_VP]),
    },
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                           "siddhi_tpu_torch/csrc kernels)")
    return p


def _lib_path(name: str) -> str:
    # the shared headers (csrc/*.cuh) are hashed with every source, so an
    # edit to one rebuilds the sources that include it
    srcs = [os.path.join(CSRC, name + ".cu")] + sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith(".cuh"))
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc_cmd(name: str, out: str, verbose: bool) -> List[str]:
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", out,
                                        os.path.join(CSRC, name + ".cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(names: Optional[List[str]] = None,
              verbose: bool = False) -> Dict[str, str]:
    """Build every named source (default: all in SIGNATURES) that has no
    up-to-date library, one ``nvcc`` process per source, all started
    together.  Returns {name: compiler output} for the sources built."""
    names = list(SIGNATURES) if names is None else names
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        logs[name] = log
        if p.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LOADED[name] = lib
    return lib
