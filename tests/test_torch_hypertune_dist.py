"""Hypertune over ranks (ptyrad_tpu_torch.engine.hypertune with a group):
gloo ranks on the CPU against the one-process study and the JAX package's
canvas study on make_mesh(2).

The ranks run tests/torch_hypertune_worker.py's cases, every case of a
world from one start of its ranks, on tests/test_torch_hypertune.py's
study problem (16 patterns of 32² simulated into a .raw; 2-iteration
trials tuning the objp rate, scale and rotation; RandomSampler(seed=0)),
each rank's Initializer seeded alike. Rank 0 alone holds the study; every
rank runs every trial, the store split over the ranks.

- A 3-trial Adam study on 2 ranks and a 2-trial one on 4: the one-process
  study's trial params and states, the values at rtol 1e-5 (the ranks
  reduce the batch sums in another order); every rank ran every trial and
  saw rank 0's losses bit for bit.
- A MedianPruner study: the same trials pruned at the same steps.
- A diverging trial (SGD at a rate of 1e22): FAILED on rank 0, given up
  on every rank, and the study goes on.
- shard_canvas: a 2-trial canvas study (a pruner reading the loss every
  iteration, collated objp files of whole canvases) at rtol 1e-4 of the
  JAX package's canvas study, trial params equal (the rtol of
  tests/test_torch_hypertune.py's studies against the JAX package); and
  one whose contrast metric the pruner reads every iteration, equal to the
  JAX objp_contrast of each trial's final whole objp.
- ``python -m ptyrad_tpu_torch run --device cpu --n_devices 2`` on a params
  file with if_hypertune: exit 0, one study of n_trials trials, one log.
"""

import copy
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ptyrad_tpu.engine import hypertune as jax_ht
from ptyrad_tpu_torch.engine import hypertune as ht
from ptyrad_tpu_torch.engine import tuner
from test_torch_hypertune import _tune, study_cfg
from torch_port_helpers import SOLVER_SEED, free_port, rank_env, recon_params_file, spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 240
VALUE_RTOL = 1e-5
CANVAS_RTOL = 1e-4


def write_cfg(tmp: Path, name: str, cfg: dict) -> str:
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg, default=str))
    return str(path)


def with_storage(cfg: dict, tmp: Path, name: str) -> dict:
    """cfg with its own sqlite file and output folder under tmp."""
    c = copy.deepcopy(cfg)
    c["hypertune_params"]["storage_path"] = str(tmp / f"{name}.db")
    c["recon_params"]["output_dir"] = str(tmp / f"{name}_out")
    return c


def adam_cfg(tmp: Path, n_trials: int) -> dict:
    cfg = study_cfg(tmp, "Adam")
    cfg["hypertune_params"]["n_trials"] = n_trials
    return cfg


def pruned_cfg(tmp: Path) -> dict:
    """4 trials under MedianPruner after one finished trial: trials whose
    error at an iteration is above the median of the earlier ones there are
    pruned."""
    cfg = study_cfg(tmp, "Adam")
    cfg["hypertune_params"].update(
        n_trials=4, pruner_params={"name": "MedianPruner",
                                   "configs": {"n_startup_trials": 1, "n_warmup_steps": 0}})
    return cfg


def diverging_cfg(tmp: Path) -> dict:
    """SGD on obja at a rate of 1e22 or 1e-4: the first diverges."""
    cfg = study_cfg(tmp, "SGD")
    cfg["hypertune_params"]["n_trials"] = 4
    cfg["hypertune_params"]["tune_params"]["oalr"] = _tune("cat", choices=[1e22, 1e-4])
    cfg["model_params"]["update_params"]["obja"]["start_iter"] = 1
    return cfg


def canvas_cfg(tmp: Path, error_metric: str = "loss") -> dict:
    """The study problem on a raster 8 Ang apart, whose canvas splits into
    two slabs taller than the probe; shard_canvas, a MedianPruner that reads
    the error every iteration (it prunes nothing before 5 finished trials),
    objp collated."""
    from ptyrad_tpu_torch.load import load_params

    cfg = load_params(str(recon_params_file(tmp, "canvas.json",
                                            init_over={"pos_scan_step_size": 8.0})))
    cfg["init_params"]["meas_params"]["path"] = str(cfg["init_params"]["meas_params"]["path"])
    base = study_cfg(tmp, "Adam", error_metric=error_metric)
    cfg["recon_params"].update(NITER=2, shard_canvas=True, save_result=["objp"])
    cfg["hypertune_params"] = base["hypertune_params"]
    cfg["hypertune_params"].update(
        n_trials=2, collate_results=True,
        pruner_params={"name": "MedianPruner", "configs": {"n_startup_trials": 5}})
    cfg["hypertune_params"]["tune_params"]["scale"] = _tune("float", low=0.98, high=1.02,
                                                            step=0.02)
    return cfg


def run_ranks(tmp: Path, world: int, cases: list) -> list:
    """Start ``world`` ranks running ``cases``; outs[case][rank]."""
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, str(TESTS / "torch_hypertune_worker.py"), str(r),
                           str(world), str(port), str(tmp), json.dumps(cases)],
                world, tmp, RANK_TIMEOUT_S, f"{world} hypertune ranks")
    outs = []
    for i in range(len(cases)):
        outs.append([{k: json.loads(str(v)) for k, v in np.load(tmp / f"case{i}_{r}.npz").items()}
                     for r in range(world)])
    return outs


CASES = {2: {"adam": lambda t: adam_cfg(t, 3), "pruned": pruned_cfg,
             "diverging": diverging_cfg, "canvas": canvas_cfg,
             "canvas_contrast": lambda t: canvas_cfg(t, "contrast")},
         4: {"adam": lambda t: adam_cfg(t, 2)}}


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """Every study of each world from one start of its ranks, and the cfgs
    they ran (for the references)."""
    out = {}

    def get(world: int) -> dict:
        if world not in out:
            tmp = tmp_path_factory.mktemp(f"ht{world}")
            cfgs = {name: with_storage(make(tmp), tmp, f"ranks_{name}")
                    for name, make in CASES[world].items()}
            cases = [["study", {"cfg": write_cfg(tmp, name, cfg), "seed": SOLVER_SEED,
                                "keep_objp": name == "canvas_contrast"}]
                     for name, cfg in cfgs.items()]
            outs = run_ranks(tmp, world, cases)
            out[world] = {name: (cfgs[name], tmp, o) for name, o in zip(cfgs, outs)}
        return out[world]

    return get


def one_process(cfg: dict, tmp: Path, name: str):
    return ht.run_hypertune(with_storage(cfg, tmp, name), use_optuna=False, device="cpu",
                            init_rng=np.random.RandomState(SOLVER_SEED))


def assert_followers_ran_every_trial(outs: list) -> None:
    trials = outs[0]["trials"]
    for r, o in enumerate(outs):
        assert o["trials"] is None if r else o["trials"] is not None
        assert [t["number"] for t in o["ran"]] == [t["number"] for t in trials], f"rank {r}"
        for a, b in zip(o["ran"], outs[0]["ran"]):
            assert a["params"] == b["params"] and a["diverged"] == b["diverged"]
            assert a.get("losses") == b.get("losses"), f"rank {r}: losses part from rank 0's"


def assert_same_study(ranks: list, ref: list, rtol: float) -> None:
    assert len(ranks) == len(ref)
    for a, b in zip(ranks, ref):
        assert a["params"] == b["params"]
        assert a["state"] == b["state"], (a, b)
        assert sorted(a["reports"]) == sorted(b["reports"])
        if b["value"] is None:
            assert a["value"] is None
        else:
            np.testing.assert_allclose(a["value"], b["value"], rtol=rtol)


@pytest.mark.parametrize("world", [2, 4])
def test_adam_study_on_ranks_is_the_one_process_study(studies, world):
    cfg, tmp, outs = studies(world)["adam"]
    ref = one_process(cfg, tmp, "one_adam").trials
    assert_followers_ran_every_trial(outs)
    assert [t["state"] for t in ref] == ["COMPLETE"] * cfg["hypertune_params"]["n_trials"]
    assert_same_study(outs[0]["trials"], ref, VALUE_RTOL)
    assert len({t["value"] for t in ref}) == len(ref)


def test_pruned_trials_are_the_one_process_studys(studies):
    cfg, tmp, outs = studies(2)["pruned"]
    ref = one_process(cfg, tmp, "one_pruned").trials
    assert "PRUNED" in [t["state"] for t in ref], ref
    assert_followers_ran_every_trial(outs)
    assert_same_study(outs[0]["trials"], ref, VALUE_RTOL)
    for o in outs:
        assert [t["pruned"] for t in o["ran"]] == [t["state"] == "PRUNED" for t in ref]


def test_diverging_trial_fails_on_every_rank_and_the_study_goes_on(studies):
    cfg, tmp, outs = studies(2)["diverging"]
    trials = outs[0]["trials"]
    assert [t["state"] for t in trials] == [
        "FAILED" if t["params"]["oalr"] == 1e22 else "COMPLETE" for t in trials]
    assert {"FAILED", "COMPLETE"} <= {t["state"] for t in trials}, trials
    assert_followers_ran_every_trial(outs)
    for o in outs:
        assert [t["diverged"] for t in o["ran"]] == [t["state"] == "FAILED" for t in trials]
    assert_same_study(trials, one_process(cfg, tmp, "one_diverging").trials, VALUE_RTOL)


def test_canvas_study_on_ranks_matches_the_jax_canvas_study(studies):
    """Each trial's solver on the two ranks is canvas-sharded; its error (the
    contrast) reads whole canvases every iteration (the pruner's report)
    and collation writes whole canvases, as the JAX study on make_mesh(2)."""
    from ptyrad_tpu.parallel.mesh import make_mesh

    cfg, tmp, outs = studies(2)["canvas"]
    c = with_storage(cfg, tmp, "jax_canvas")
    np.random.seed(SOLVER_SEED)
    ref = jax_ht.run_hypertune(c, mesh=make_mesh(2), use_optuna=False).trials
    assert [t["state"] for t in ref] == ["COMPLETE", "COMPLETE"]
    assert_followers_ran_every_trial(outs)
    assert_same_study(outs[0]["trials"], ref, CANVAS_RTOL)
    for o in outs:
        # whole canvases after each trial, on every rank
        assert all(t["objp_shape"] == t["obj_shape"] for t in o["ran"])
    names = sorted(os.path.basename(f) for f in glob.glob(str(tmp / "ranks_canvas_out" / "objp*")))
    ref_names = sorted(os.path.basename(f)
                       for f in glob.glob(str(tmp / "jax_canvas_out" / "objp*")))
    assert len(names) == len(ref_names) == 4, (names, ref_names)
    assert [n.split("_t000")[1] for n in names] == [n.split("_t000")[1] for n in ref_names]


def test_canvas_contrast_reads_whole_canvases(studies):
    """The contrast metric of a canvas trial, which the pruner reads every
    iteration (each rank gathering the canvases), is minus the JAX
    objp_contrast of the trial's final whole objp at rtol 1e-6. (The
    contrast of a 2-iteration objp magnifies the two packages' float32
    differences: their canvas studies part by about 6e-3 in it, so the
    comparison with the JAX study above runs on the loss.)"""
    from ptyrad_tpu.losses import objp_contrast as jax_contrast

    cfg, tmp, outs = studies(2)["canvas_contrast"]
    assert_followers_ran_every_trial(outs)
    trials = outs[0]["trials"]
    assert [t["state"] for t in trials] == ["COMPLETE", "COMPLETE"]
    for t, ran in zip(trials, outs[0]["ran"]):
        assert sorted(t["reports"]) == ["1", "2"]
        objp = np.asarray(ran["objp"], np.float32)
        assert list(objp.shape) == ran["obj_shape"]
        want = -jax_contrast(objp, np.asarray(ran["crop_pos"], np.int32),
                             tuple(ran["probe_shape"]), np.asarray(ran["indices"]))
        np.testing.assert_allclose(t["value"], want, rtol=1e-6)
        assert t["reports"]["2"] == t["value"]


def test_cli_n_devices_runs_the_study_on_ranks(tmp_path):
    """``run --device cpu --n_devices 2`` with if_hypertune: exit 0, the
    study's two trials written once (rank 0), one log file."""
    path = recon_params_file(tmp_path, "p.json", NITER=2, save_result=["objp"])
    d = json.loads(Path(path).read_text())
    d["hypertune_params"] = {"if_hypertune": True, "n_trials": 2,
                             "storage_path": str(tmp_path / "ht.db"), "study_name": "ranks",
                             "sampler_params": {"name": "RandomSampler", "configs": {"seed": 0}}}
    Path(path).write_text(json.dumps(d))
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "run", "--params_path",
                          str(path), "--device", "cpu", "--n_devices", "2"],
                         cwd=ROOT, env=rank_env(), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Starting hypertune: 2 trials, engine=builtin, every trial on 2 "
                            "ranks") == 1, out.stdout
    trials = tuner.create_study("ranks", str(tmp_path / "ht.db")).trials
    assert [(t["number"], t["state"]) for t in trials] == [(0, "COMPLETE"), (1, "COMPLETE")]
    logs = [f for f in os.listdir(tmp_path / "out") if f.endswith("ptyrad_tpu_torch_log.txt")]
    assert len(logs) == 1, os.listdir(tmp_path / "out")
