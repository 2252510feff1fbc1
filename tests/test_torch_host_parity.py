"""Host-engine parity: the torch port's copied host stack vs the JAX
package's.

Each app runs under ``@app:engine('host')`` through both packages, fed
the same events (made from a seed with numpy) one at a time with
explicit timestamps under ``@app:playback``; every output stream must
receive exactly the same rows in the same order.  The host stack of the
port is a copy with only import paths and device seams changed, so any
difference here is a porting fault.
"""
import zlib

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch

HEAD = ("@app:name('parity')\n@app:playback\n@app:engine('host')\n"
        "define stream S (sym string, price float, qty int);\n"
        "define stream T (sym string, qty int);\n")

APPS = {
    "filter": """
        from S[price > 50.0 and qty != 3]
        select sym, price * 2.0 as p, qty + 1 as q insert into Out;""",
    "length_window": """
        from S#window.length(3)
        select sym, sum(price) as s, count() as n insert into Out;""",
    "length_batch": """
        from S#window.lengthBatch(4)
        select sym, avg(price) as a, max(qty) as m insert into Out;""",
    "time_window": """
        from S#window.time(100 millisec)
        select sym, sum(price) as s, count() as n insert into Out;""",
    "group_having_order": """
        from S#window.lengthBatch(6)
        select sym, sum(price) as s group by sym having s > 60.0
        order by s desc insert into Out;""",
    "every_within": """
        from every e1=S[price > 60.0] -> e2=S[price < e1.price]
            within 200 millisec
        select e1.sym as a, e2.sym as b, e1.price - e2.price as d
        insert into Out;""",
    "partition": """
        partition with (sym of S) begin
        from S#window.length(2)
        select sym, avg(price) as a, count() as n insert into Out;
        end;""",
    "partition_pattern": """
        partition with (sym of S) begin
        from every e1=S[qty > 3] -> e2=S[qty < e1.qty]
        select e1.sym as s, e1.qty as q1, e2.qty as q2 insert into Out;
        end;""",
    "join": """
        from S#window.length(5) join T#window.length(5)
            on S.sym == T.sym
        select S.sym as sym, S.price as price, T.qty as tq
        insert into Out;""",
    "table": """
        define table Tab (sym string, qty int);
        from T insert into Tab;
        from S join Tab on S.sym == Tab.sym
        select S.sym as sym, S.price as price, Tab.qty as tq
        insert into Out;""",
}


def events(seed: int, n: int = 120):
    rng = np.random.default_rng(seed)
    syms = ["a", "b", "c", "d"]
    out = []
    t = 1_000_000
    for _ in range(n):
        t += int(rng.integers(1, 40))
        sym = syms[int(rng.integers(0, len(syms)))]
        if rng.random() < 0.7:
            out.append(("S", [sym, float(np.float32(rng.uniform(0, 100))),
                              int(rng.integers(0, 6))], t))
        else:
            out.append(("T", [sym, int(rng.integers(0, 6))], t))
    return out


def run(pkg, body: str, evs, **mgr_kw):
    mgr = pkg.SiddhiManager(**mgr_kw)
    rt = mgr.create_siddhi_app_runtime(HEAD + body)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda es: rows.extend([e.timestamp] + list(e.data) for e in es)))
    rt.start()
    try:
        handlers = {s: rt.get_input_handler(s) for s in ("S", "T")}
        for sid, data, ts in evs:
            handlers[sid].send(data, timestamp=ts)
    finally:
        rt.shutdown()
    return rows


@pytest.mark.parametrize("name", sorted(APPS))
def test_host_rows_equal(name):
    evs = events(zlib.crc32(name.encode()))
    ref = run(siddhi_tpu, APPS[name], evs)
    got = run(siddhi_tpu_torch, APPS[name], evs, device="cpu")
    assert ref, f"{name}: the JAX package emitted nothing"
    assert got == ref
