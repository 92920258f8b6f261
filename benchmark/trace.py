"""Reduction of a torch.profiler trace (its Chrome-trace export) to what
the per-layer metrics read: the device's kernels, the device time of the
kernels launched inside a named host range, the busy time and the idle
gaps of the traced window, and the breakdown that a result line carries."""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.window"  # the host range around the traced iterations
CONSTRAINTS = "bench.constraints"  # the host range around constraint_fn there


def short_name(name: str) -> str:
    """A kernel's name without its parameters and template arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "{anonymous}")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip() or name[:80]
    return short.replace("{anonymous}", "(anonymous namespace)")


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """The events of one exported trace; times in seconds."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.launch_at = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch_at[corr] = (e["tid"], e["ts"])
        win = [e for e in self.host if e["name"] == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} range")
        self.t0, self.t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.main_tid = win[0]["tid"]
        self.kernels = [e for e in self.kernels if self.t0 <= e["ts"] <= self.t1]
        self.device = [e for e in self.device if self.t0 <= e["ts"] <= self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                      for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def matching(self, patterns) -> list:
        """(name, seconds) of every kernel whose name matches a pattern."""
        rx = [re.compile(p) for p in patterns]
        return [(e["name"], e["dur"] * 1e-6) for e in self.kernels
                if any(r.search(e["name"]) for r in rx)]

    def in_range(self, range_name: str) -> list:
        """(name, seconds) of every kernel launched from the host while a
        range of that name was open on the launching thread."""
        spans = defaultdict(list)
        for e in self.host:
            if e["name"] == range_name:
                spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        for tid in spans:
            spans[tid] = _union(spans[tid])
        out = []
        for e in self.kernels:
            at = self.launch_at.get((e.get("args") or {}).get("correlation"))
            if at is None or at[0] not in spans:
                continue
            ivs = spans[at[0]]
            i = bisect.bisect_right([a for a, _ in ivs], at[1]) - 1
            if i >= 0 and at[1] <= ivs[i][1]:
                out.append((e["name"], e["dur"] * 1e-6))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window, grouped by the innermost host range open on the
        main thread at the gap's middle."""
        ops = defaultdict(float)
        for e in self.device:
            ops[short_name(e["name"])] += e["dur"] * 1e-6
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        main = sorted((e for e in self.host if e["tid"] == self.main_tid),
                      key=lambda e: (e["ts"], -e["dur"]))
        starts = [e["ts"] for e in main]
        parent, stack = [], []
        for i, e in enumerate(main):
            while stack and main[stack[-1]]["ts"] + main[stack[-1]]["dur"] < e["ts"]:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            # ranges nest: the innermost range open at the middle is the
            # last one opened before it, or one of that range's parents
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and main[i]["ts"] + main[i]["dur"] < mid:
                i = parent[i]
            by[main[i]["name"] if i >= 0 else "host outside any range"] += (b - a) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(by)}
