"""Documentation generator: built-in + registered extension reference docs.

(reference: modules/siddhi-doc-gen — maven mojos rendering @Extension
annotation metadata to mkdocs markdown.  Here the metadata sources are the
built-in factories themselves — window registry, aggregator table, expression
compiler builtins — plus any ExtensionRegistry entries; output is one
markdown document.)

CLI: ``python -m siddhi_tpu_torch.tools.docgen [out.md]``
"""
from __future__ import annotations

import inspect
from typing import List, Optional


def _first_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    return doc.split("\n")[0] if doc else ""


def generate_markdown(extension_registry=None) -> str:
    from ..core import aggregator, window

    lines: List[str] = ["# siddhi_tpu_torch built-in reference", ""]

    lines += ["## Windows (`#window.<name>(...)`)", ""]
    win = [
        ("length(n)", window.LengthWindowProcessor),
        ("lengthBatch(n)", window.LengthBatchWindowProcessor),
        ("time(t)", window.TimeWindowProcessor),
        ("timeBatch(t[, start])", window.TimeBatchWindowProcessor),
        ("timeLength(t, n)", window.TimeLengthWindowProcessor),
        ("externalTime(tsAttr, t)", window.ExternalTimeWindowProcessor),
        ("externalTimeBatch(tsAttr, t[, start])",
         window.ExternalTimeBatchWindowProcessor),
        ("batch()", window.BatchWindowProcessor),
        ("hoping(t, hop) / hopping", window.HopingWindowProcessor),
        ("session(gap[, key])", window.SessionWindowProcessor),
        ("sort(n, attr [, 'asc'|'desc']...)", window.SortWindowProcessor),
        ("frequent(n[, attrs...])", window.FrequentWindowProcessor),
        ("lossyFrequent(support[, error][, attrs...])",
         window.LossyFrequentWindowProcessor),
        ("delay(t)", window.DelayWindowProcessor),
        ("cron(expr)", window.CronWindowProcessor),
    ]
    for sig, cls in win:
        lines.append(f"- `{sig}` — {_first_line(cls)}")
    lines.append("")

    lines += ["## Attribute aggregators", ""]
    for name, cls in sorted(aggregator.AGGREGATORS.items()):
        lines.append(f"- `{name}(...)` — {_first_line(cls)}")
    lines.append("")

    lines += ["## Built-in scalar functions", "",
              "`coalesce, ifThenElse, cast, convert, instanceOf*, UUID, "
              "currentTimeMillis, eventTimestamp, maximum, minimum, default, "
              "createSet, sizeOfSet`, `math:{abs,ceil,floor,sqrt,log,log10,"
              "exp,sin,cos,tan,round,power}`, `str:{concat,length,upper,"
              "lower,trim,reverse,contains}`", ""]

    lines += ["## Incremental aggregation",
              "",
              "`define aggregation A from S select g, avg(x) as a, ... "
              "group by g aggregate [by tsAttr] every sec ... year;` — "
              "queried with `from A [on cond] within <from>, <to> per "
              "'<duration>'` in store queries and joins.", ""]

    # @extension-decorated classes: full metadata render (≙ the reference
    # doc-gen mojos consuming @Extension/@Parameter/@Example annotations)
    from ..utils.extension import EXTENSION_METADATA
    seen = set()
    metas = list(EXTENSION_METADATA.values())
    if extension_registry is not None:
        for _n, impl in sorted(getattr(extension_registry,
                                       "_by_name", {}).items()):
            m = getattr(impl, "__extension_meta__", None)
            if m is not None and m.key not in EXTENSION_METADATA:
                metas.append(m)
    if metas:
        lines += ["## Registered extensions", ""]
        for m in metas:
            if m.key in seen:
                continue
            seen.add(m.key)
            lines.append(f"### `{m.key}`")
            lines.append("")
            if m.description:
                lines.append(m.description)
                lines.append("")
            if m.parameters:
                lines.append("| parameter | type | description |")
                lines.append("|---|---|---|")
                for pname, ptype, pdesc in m.parameters:
                    lines.append(f"| `{pname}` | {ptype} | {pdesc} |")
                lines.append("")
            if m.returns:
                lines.append(f"**Returns:** `{m.returns}`")
                lines.append("")
            for ex in m.examples:
                lines.append(f"```\n{ex}\n```")
                lines.append("")
    if extension_registry is not None:
        plain = [(n, impl) for n, impl in
                 sorted(getattr(extension_registry, "_by_name", {}).items())
                 if getattr(impl, "__extension_meta__", None) is None]
        if plain:
            lines += ["## Extensions without metadata", ""]
            for n, impl in plain:
                lines.append(f"- `{n}` — {_first_line(impl)}")
            lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    md = generate_markdown()
    if argv:
        with open(argv[0], "w") as f:
            f.write(md)
    else:
        print(md)


if __name__ == "__main__":
    main()
