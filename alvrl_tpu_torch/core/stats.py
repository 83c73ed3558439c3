"""Performance counters and phase timing.

Copy of alvrl_tpu/core/stats.py, the counterpart of the reference's
StatsCounter/Statistics registry
(include/mitsuba/core/statistics.h:55-106,339-351) and the
cpu_timer phase timing around prepass/render (integrator.cpp:401-425).

Counters are plain host-side accumulators fed by device scalars the
driver pulls once per pass (never per-sample — that would sync the
device); `Statistics.format_table()` prints the end-of-job table the
reference emits from Statistics::printStats().
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Counter:
    category: str
    name: str
    value: float = 0.0
    base: float = 0.0  # for percentages/averages

    def add(self, v, base=0.0):
        self.value += float(v)
        self.base += float(base)


class Statistics:
    """Process-wide counter registry (singleton by convention)."""

    def __init__(self):
        self.counters: "OrderedDict[tuple, Counter]" = OrderedDict()
        self.timings: "OrderedDict[str, list]" = OrderedDict()

    def counter(self, category: str, name: str) -> Counter:
        key = (category, name)
        if key not in self.counters:
            self.counters[key] = Counter(category, name)
        return self.counters[key]

    @contextmanager
    def timed(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings.setdefault(phase, []).append(
                time.perf_counter() - t0
            )

    def format_table(self) -> str:
        lines = ["  * Statistics:"]
        cat = None
        for c in self.counters.values():
            if c.category != cat:
                cat = c.category
                lines.append(f"    - {cat}:")
            if c.base:
                lines.append(
                    f"        {c.name}: {c.value:.4g} / {c.base:.4g}"
                    f" ({100.0 * c.value / c.base:.2f}%)"
                )
            else:
                lines.append(f"        {c.name}: {c.value:.4g}")
        if self.timings:
            lines.append("    - Timings (wall):")
            for phase, ts in self.timings.items():
                lines.append(
                    f"        {phase}: total {sum(ts):.3f}s over "
                    f"{len(ts)} run(s)"
                )
        return "\n".join(lines)

    def reset(self):
        self.counters.clear()
        self.timings.clear()


STATS = Statistics()
