"""The comparison that decides ``correct`` on a run driven end to end on
the CPU at a small size (the harness's look for a card skipped): sound runs
pass under pso.b32's limits; the control (the program's bfloat16 policy)
and the planted faults fail. A card-only test does the same on pso.b32 at
its own size."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import run as R
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with one more cell: PSO's configuration at
    48^2 (a 24^2 crop padded on the fly), 2 probe modes, 3 slices, an 8 x 8
    scan and batches of 8, held to pso.b32's limits."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/pso.json").read_text())
    cfg.update(name="tiny", ref_block=4, sim_batch=16)
    cfg["physics"].update(npix=48, dx=0.6, n_scan=[8, 8], step_ang=1.2, pmode=2, nz=3,
                          crop=[12, 36], pad_target=48)
    b = root / "benchmark"
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    (b / "traffic/b8.json").write_text(json.dumps(
        {"params": {"recon_params": {"BATCH_SIZE": {"size": 8}}}}))
    shutil.copy(b / "limits/pso.b32.json", b / "limits/tiny.b8.json")
    bench["workloads"].append({"name": "tiny.b8", "config": "tiny", "traffic": "b8",
                               "chips": 1, "why": "a test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_sound_runs_are_correct(tiny, seed):
    res = R.run_cell("tiny.b8", seed, 0.2, False, "cpu", spec=tiny)
    assert res["correct"], res["checks"]
    assert res["metrics"]["patterns_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("variant", ["bf16", "half_batch", "no_step"])
def test_the_control_and_the_faults_are_not_correct(tiny, variant):
    res = R.run_cell("tiny.b8", 7, 0.2, False, "cpu", variant=variant, spec=tiny)
    assert not res["correct"], res["checks"]


def test_a_seed_gives_the_same_inputs(tiny):
    a = R.Run(tiny, "tiny.b8", 5, "cpu")
    b = R.Run(tiny, "tiny.b8", 5, "cpu")
    from benchmark import data

    pa, ia = data.make_inputs(a.config, a.traffic, 5, "cpu")
    pb, ib = data.make_inputs(b.config, b.traffic, 5, "cpu")
    assert pa == pb
    for k in ("obj", "probe", "measurements", "crop_pos", "probe_pos_shifts"):
        assert (ia[k] == ib[k]).all(), k
    _, ic = data.make_inputs(a.config, a.traffic, 6, "cpu")
    assert ic["measurements"].shape == ia["measurements"].shape
    assert not (ic["obj"] == ia["obj"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,correct", [("program", True), ("bf16", False),
                                             ("half_batch", False)])
def test_pso_on_the_card(card, variant, correct):
    run = R.Run(Spec(ROOT), "pso.b32", 424242, card, variant)
    run.setup(warm=False)
    run.free()
    ok, checks, _ = run.compare()
    assert ok == correct, checks


def test_a_traced_run_reads_its_layers(tiny):
    """A --trace 1 run through the same set-up: the per-layer readers run
    on its trace (the CPU has no kernels, so the kernel layers read
    nothing and are left out), and the comparison still decides."""
    res = R.run_cell("tiny.b8", 9, 0.2, True, "cpu", spec=tiny)
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    assert {"solver_init_s", "warmup_s", "step_mfu", "device_idle_share"} <= names
    assert not names & {"patches_roofline", "launches_per_step", "patterns_per_s"}
    assert res["device"]["window_s"] > 0 and res["attempted"] == 8
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
