"""Finding a cell's files by the names in BENCHMARK.json: its entry, its
configuration (configs/<config>.json), its traffic (traffic/<traffic>.json),
the limits of its comparison (limits/<cell>.json), the metrics it reports,
each per-layer metric's reader (metrics/<metric>.py) and each kernel
layer's name patterns (the union of layers/<layer>/*.txt)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    """BENCHMARK.json at ``root`` and the benchmark's files beside it."""

    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.dir = self.root / "benchmark"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, *parts) -> dict:
        return json.loads(self.dir.joinpath(*parts).read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    @staticmethod
    def _in(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def reader(self, metric: str):
        """The ``read(records)`` function of metrics/<metric>.py."""
        path = self.dir / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read

    def layer_patterns(self, layer: str) -> list:
        """The kernel-name patterns of a layer: every line of every
        layers/<layer>/*.txt that is neither blank nor a comment."""
        out = []
        for path in sorted((self.dir / "layers" / layer).glob("*.txt")):
            out += [s.strip() for s in path.read_text().splitlines()
                    if s.strip() and not s.strip().startswith("#")]
        return out
