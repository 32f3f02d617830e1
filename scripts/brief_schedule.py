#!/usr/bin/env python3
"""Print kernel B's comparison schedule, the ``LVT_BRIEF_SCHEDULE`` X-macro
of ``lvt_tpu_torch/csrc/brief_pattern.cuh``.

    python3 scripts/brief_schedule.py

Kernel B compares 64 pool samples in 256 pairs per pixel. Loading all 64
first keeps them all live in registers; here the samples are loaded one at
a time, and each comparison follows right after the load of the later of
its two samples, so a sample dies after its last comparison. The load
order is chosen greedily: next comes the sample that leaves the fewest
samples live, ties to the one that completes the most comparisons, then
to the lowest index. Any order gives the same bits; this one keeps at
most ``max_live`` samples live (printed to stderr).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lvt_tpu_torch.ops import brief  # noqa: E402


def schedule():
    """[("load", k) | ("bit", bit, i, j)] in kernel order, and the most
    samples live at once."""
    pairs = [tuple(int(v) for v in p) for p in brief.pair_indices()]
    uses = {k: {b for b, p in enumerate(pairs) if k in p}
            for k in range(brief.POOL_SIZE)}
    loaded, done, steps, max_live, live = set(), set(), [], 0, 0

    def after(k):
        got = loaded | {k}
        new = {b for b in uses[k] if set(pairs[b]) <= got}
        live = sum(1 for s in got if uses[s] - done - new)
        return live, -len(new), k

    while len(loaded) < brief.POOL_SIZE:
        k = min((k for k in range(brief.POOL_SIZE) if k not in loaded),
                key=after)
        # between its load and its comparisons the new sample is live too
        max_live = max(max_live, live + 1)
        live = after(k)[0]
        loaded.add(k)
        steps.append(("load", k))
        for b in sorted(uses[k]):
            if set(pairs[b]) <= loaded and b not in done:
                done.add(b)
                steps.append(("bit", b, *pairs[b]))
    return steps, max_live


def macro() -> str:
    pool = brief.sample_pool()
    steps, _ = schedule()
    items = [f"L({s[1]}, {pool[s[1]][0]}, {pool[s[1]][1]})" if s[0] == "load"
             else f"X({s[1]}, {s[2]}, {s[3]})" for s in steps]
    lines, line = [], "  "
    for it in items:
        if len(line) + len(it) + 1 > 78:
            lines.append(line.rstrip() + " \\")
            line = "  "
        line += it + " "
    lines.append(line.rstrip())
    return "#define LVT_BRIEF_SCHEDULE(L, X) \\\n" + "\n".join(lines)


if __name__ == "__main__":
    print(macro())
    print(f"max live samples: {schedule()[1]}", file=sys.stderr)
