#!/usr/bin/env python3
"""Count the pattern compiles of the reference's pattern and NFA suites
that the CUDA NFA kernel would refuse, by reason.

    python3 tools/nfa_class_probe.py [ROOT] [--json OUT]

ROOT is the root of a checkout of the port (default: this one).  The
seventeen suite files of ``tests/test_torch_conformance_patterns.py``
and ``tests/test_torch_conformance_nfa.py`` run in one pytest
subprocess under that checkout's conformance plugin
(``tests/test_torch_conformance.py``: ``siddhi_tpu`` aliased to the
port, the compilers on the CPU), with ``CompiledPatternNFA.
_kernel_program`` wrapped to log each compile's ``kprog.reason`` and,
for a parameterized compile (a pattern bank's template), its
``ops/nfa.bank_class_reason`` (the bank kernels' class, the step's).  A
compile counts once, under its first reason; ``None`` is a compile the
kernel takes.  Prints one line per reason, then the bank templates'
reasons, and a ``PROBE {json}`` line.  Runs on the CPU (~3 min); suite
failures are reported, not fatal.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile

SUITE_FILES = ("tests/test_torch_conformance_patterns.py",
               "tests/test_torch_conformance_nfa.py")

HOOK = '''

import siddhi_tpu_torch.plan.nfa_compiler as _probe_nc  # noqa: E402
from siddhi_tpu_torch.ops.nfa import \\
    bank_class_reason as _probe_bank  # noqa: E402

_probe_real = _probe_nc.CompiledPatternNFA._kernel_program


def _probe_kernel_program(self, kern_conds):
    kp = _probe_real(self, kern_conds)
    bank = getattr(self, "_parameterize", False)
    with open(%r, "a") as f:
        f.write(json.dumps({"reason": kp.reason, "bank": bank,
                            "bank_reason": _probe_bank(self.spec, kp)
                            if bank else None}) + "\\n")
    return kp


_probe_nc.CompiledPatternNFA._kernel_program = _probe_kernel_program
'''


def suites(root):
    """The suite file lists of the two conformance files, read by text
    (the files import pytest and the plugin module)."""
    out = []
    for rel in SUITE_FILES:
        src = open(os.path.join(root, rel)).read()
        body = src.split("SUITES = [", 1)[1].split("]", 1)[0]
        out += [s.strip().strip('"') for s in body.split(",") if s.strip()]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_conformance as conf
    files = suites(root)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "reasons.jsonl")
        session = os.path.join(tmp, "session.json")
        plugin = conf.PLUGIN % (json.dumps({}), session) + HOOK % log
        with open(os.path.join(tmp, "port_as_reference.py"), "w") as f:
            f.write(plugin)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = os.pathsep.join([tmp, root])
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "--noconftest",
             "-p", "port_as_reference", "-p", "no:cacheprovider",
             "-p", "no:randomly", "-p", "no:xdist", "-o", "addopts=",
             "-m", "not slow", "--continue-on-collection-errors",
             "--rootdir", root] + files,
            cwd=root, env=env, capture_output=True, text=True, timeout=1800)
        tail = [ln for ln in r.stdout.splitlines() if ln.strip()][-1:]
        rows = [json.loads(ln) for ln in open(log)] \
            if os.path.exists(log) else []
    reasons = [r["reason"] for r in rows]
    counts = collections.Counter(reasons)
    for reason, n in counts.most_common():
        print(f"{n:6d}  {reason}")
    refused = sum(n for k, n in counts.items() if k is not None)
    banks = collections.Counter(r["bank_reason"] for r in rows if r["bank"])
    for reason, n in banks.most_common():
        print(f"{n:6d}  bank template: {reason}")
    res = {"root": root, "compiles": len(reasons), "refused": refused,
           "by_reason": {str(k): n for k, n in counts.most_common()},
           "bank_templates": sum(banks.values()),
           "bank_refused": sum(n for k, n in banks.items() if k is not None),
           "bank_by_reason": {str(k): n for k, n in banks.most_common()},
           "pytest": tail[0] if tail else "", "files": len(files)}
    print(f"{refused} of {len(reasons)} compiles refused; bank templates "
          f"{res['bank_refused']} of {res['bank_templates']} refused; "
          f"pytest: {res['pytest']}")
    print("PROBE " + json.dumps(res, sort_keys=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
