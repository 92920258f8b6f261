"""A cell, a per-layer metric and a kernel layer's pattern file added to a
copy of the benchmark are found by name, with no existing file edited
(BENCHMARK.json gains entries)."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark.reference import compare
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_added_files_are_found_and_nothing_is_edited(copy):
    before = digest(copy)
    b = copy / "benchmark"
    (b / "traffic" / "b16.json").write_text(json.dumps(
        {"params": {"recon_params": {"BATCH_SIZE": {"size": 16}}}}))
    (b / "limits" / "pso.b16.json").write_text(json.dumps({"loss": 1, "grad1": 1, "change": 1}))
    (b / "metrics" / "extra_ms.py").write_text("def read(rec):\n    return 1.5\n")
    (b / "layers" / "fused" / "extra.txt").write_text("# a new kernel\n\\bnew_kernel\\b\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "pso.b16", "config": "pso", "traffic": "b16",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "extra_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "kernels, fused",
                               "moves": "patterns_per_s", "workloads": ["pso.b16"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(copy)
    assert spec.cell("pso.b16")["traffic"] == "b16"
    assert spec.traffic("b16")["params"]["recon_params"]["BATCH_SIZE"]["size"] == 16
    assert spec.config("pso")["name"] == "pso"
    assert spec.limits("pso.b16") == {"loss": 1, "grad1": 1, "change": 1}
    names = [m["name"] for m in spec.per_layer("pso.b16")]
    assert "extra_ms" in names and "step_mfu" in names and "fused_roofline" not in names
    assert "extra_ms" not in [m["name"] for m in spec.per_layer("pso.b32")]
    assert spec.reader("extra_ms")(None) == 1.5
    assert r"\bnew_kernel\b" in spec.layer_patterns("fused")
    after = digest(copy)
    assert all(after[k] == v for k, v in before.items())


def test_every_named_file_exists():
    spec = Spec(ROOT)
    for cell in spec.bench["workloads"]:
        assert spec.config(cell["config"])["name"] == cell["config"]
        spec.traffic(cell["traffic"])
        assert set(spec.limits(cell["name"])) == {k.replace("_gap", "") for k in compare.NAMES}
    for c in spec.bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for layer in ("fused", "chain", "patches"):
        assert spec.layer_patterns(layer)


def test_end_to_end_metrics_follow_their_lists():
    spec = Spec(ROOT)
    for cell in ("pso.b32", "tbl_wse2.b256"):
        assert [m["name"] for m in spec.end_to_end(cell)] == [
            "patterns_per_s", "peak_mem_gib", "setup_s"]
    assert "fused_roofline" in [m["name"] for m in spec.per_layer("tbl_wse2.b256")]
    assert "fused_roofline" not in [m["name"] for m in spec.per_layer("pso.b32")]
