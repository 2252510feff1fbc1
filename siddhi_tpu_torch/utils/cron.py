"""Minimal Quartz-style cron schedule: `sec min hour dom mon dow [year]`.

(reference dependency: Quartz scheduler used by CronWindowProcessor and
CronTrigger — siddhi-core pom.xml.)  Supports `*`, `?`, single values, lists
`a,b,c`, ranges `a-b` and steps `*/n` on the second/minute/hour fields, which
covers the expressions used across the reference test-suite.
"""
from __future__ import annotations

import time
from typing import Optional, Set


def _parse_field(spec: str, lo: int, hi: int) -> Optional[Set[int]]:
    """None = every value."""
    if spec in ("*", "?"):
        return None
    out: Set[int] = set()
    for part in spec.split(","):
        if part.startswith("*/"):
            step = int(part[2:])
            out.update(range(lo, hi + 1, step))
        elif "-" in part:
            a, b = part.split("-")
            out.update(range(int(a), int(b) + 1))
        else:
            out.add(int(part))
    return out


class CronSchedule:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) < 6:
            raise ValueError(f"Bad cron expression {expr!r}")
        self.sec = _parse_field(fields[0], 0, 59)
        self.minute = _parse_field(fields[1], 0, 59)
        self.hour = _parse_field(fields[2], 0, 23)
        self.dom = _parse_field(fields[3], 1, 31)
        self.month = _parse_field(fields[4], 1, 12)
        self.dow = _parse_field(fields[5], 0, 7)

    def _matches(self, t: time.struct_time) -> bool:
        if self.sec is not None and t.tm_sec not in self.sec:
            return False
        if self.minute is not None and t.tm_min not in self.minute:
            return False
        if self.hour is not None and t.tm_hour not in self.hour:
            return False
        if self.dom is not None and t.tm_mday not in self.dom:
            return False
        if self.month is not None and t.tm_mon not in self.month:
            return False
        if self.dow is not None:
            # cron dow: 0/7 = sunday; struct_time: 0 = monday
            dow = (t.tm_wday + 1) % 7
            if dow not in self.dow and not (dow == 0 and 7 in self.dow):
                return False
        return True

    def next_after(self, now_ms: int) -> int:
        """Next fire time strictly after now (ms).  Seconds resolution."""
        t = now_ms // 1000 + 1
        for _ in range(366 * 24 * 3600):   # bounded search
            if self._matches(time.localtime(t)):
                return t * 1000
            t += 1
        raise ValueError("cron: no fire time within one year")
