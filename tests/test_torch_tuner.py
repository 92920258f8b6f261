"""ptyrad_tpu_torch.engine.tuner (the built-in hyperparameter engine) against
ptyrad_tpu.engine.tuner, on the CPU, in one process.

Both engines are driven by the same pure-Python objective and seeds: every
sampler (Random, Grid over linear, log and int-log axes, TPE past its
startup) under every pruner (Median, Hyperband) gives the same params,
values, states and reports per trial, bit for bit (tolerance 0). A study that
one package's Storage started, the other's continues on the same sqlite file
without a gap in the trial numbers. Then the JAX package's own tuner cases
(TestTunerCore, TestTunerReviewFixesR3, TestTunerReviewFixesR5 of
tests/test_hypertune_viz.py) run against the port's module.
"""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ptyrad_tpu.engine import tuner as jax_tuner
from ptyrad_tpu_torch.engine import tuner

ROOT = Path(__file__).resolve().parent.parent

TPE_STARTUP = 3
SAMPLERS = {
    "random": {"name": "RandomSampler", "configs": {"seed": 3}},
    "grid": {"name": "GridSampler", "configs": {}},
    # the demo's TPE configs: optuna's multivariate/group/constant_liar are
    # accepted and ignored by the built-in engine
    "tpe": {"name": "TPESampler", "configs": {"seed": 3, "n_startup_trials": TPE_STARTUP,
                                              "multivariate": True, "group": True,
                                              "constant_liar": True}},
}
PRUNERS = {
    "median": {"name": "MedianPruner", "configs": {"n_startup_trials": 2}},
    "hyperband": {"name": "HyperbandPruner",
                  "configs": {"min_resource": 1, "reduction_factor": 2, "n_startup_trials": 2}},
}
N_TRIALS = 14


def make_objective(mod):
    """A float axis with a step (the grid's linear axis), a log float, an
    int-log axis and a categorical; four reports with pruning; trial 4
    fails."""

    def objective(trial):
        x = trial.suggest_float("x", -1.0, 1.0, step=0.25)
        lr = trial.suggest_float("lr", 1e-4, 1e-1, log=True)
        n = trial.suggest_int("n", 1, 64, log=True)
        c = trial.suggest_categorical("c", ["a", "b", "c"])
        if trial.number == 4:
            raise RuntimeError("boom")
        value = (x - 0.3) ** 2 + (np.log10(lr) + 2.5) ** 2 / 10 + abs(n - 8) / 64 \
            + {"a": 0.0, "b": 0.05, "c": 0.1}[c]
        for step in range(1, 5):
            trial.report(value + 1.0 / step, step)
            if trial.should_prune():
                raise mod.TrialPruned()
        return value

    return objective


def run_study(mod, path, sampler, pruner):
    study = mod.create_study("s", storage_path=str(path), sampler_params=SAMPLERS[sampler],
                             pruner_params=PRUNERS[pruner])
    study.optimize(make_objective(mod), n_trials=N_TRIALS)
    return study.trials


@pytest.mark.parametrize("pruner", sorted(PRUNERS))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_same_trials_bit_for_bit(tmp_path, sampler, pruner):
    ours = run_study(tuner, tmp_path / "torch.db", sampler, pruner)
    ref = run_study(jax_tuner, tmp_path / "jax.db", sampler, pruner)
    assert ours == ref
    states = {t["state"] for t in ours}
    assert {"COMPLETE", "FAILED"} <= states
    assert "PRUNED" in states, states
    if sampler == "tpe":  # the trials after the startup ones take the TPE branch
        done = np.cumsum([t["state"] == "COMPLETE" for t in ours])
        assert done[N_TRIALS - 3] >= TPE_STARTUP, done


def _schema(path):
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT sql FROM sqlite_master WHERE name='trials'").fetchone()


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_shared_study_continues_across_packages(tmp_path, first):
    """A study started by one package's engine, continued by the other's on
    the same sqlite file: the trial numbers continue without a gap, both
    read every trial, and the two schemas are the same."""
    db = str(tmp_path / "shared.db")
    a, b = (jax_tuner, tuner) if first == "jax" else (tuner, jax_tuner)
    s1 = a.create_study("shared", storage_path=db,
                        sampler_params={"name": "RandomSampler", "configs": {"seed": 0}})
    s1.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
    s2 = b.create_study("shared", storage_path=db,
                        sampler_params={"name": "RandomSampler", "configs": {"seed": 1}})
    assert len(s2.trials) == 3
    s2.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
    assert [t["number"] for t in s1.trials] == list(range(6))
    assert s1.trials == s2.trials
    assert all(t["state"] == "COMPLETE" for t in s2.trials)
    other = str(tmp_path / "other.db")
    b.create_study("x", storage_path=other)
    assert _schema(db) == _schema(other)


# -- the JAX package's own cases, on the port's module -------------------------

class TestTunerCore:
    def test_random_sampler_bounds(self):
        s = tuner.RandomSampler(seed=0)
        for _ in range(50):
            v = s.sample("x", {"kind": "float", "low": 1.0, "high": 2.0}, [])
            assert 1.0 <= v <= 2.0
        v = s.sample("n", {"kind": "int", "low": 2, "high": 5}, [])
        assert isinstance(v, int) and 2 <= v <= 5
        v = s.sample("c", {"kind": "cat", "choices": ["a", "b"]}, [])
        assert v in ("a", "b")

    def test_log_scale_sampling(self):
        s = tuner.RandomSampler(seed=0)
        vals = [s.sample("lr", {"kind": "float", "low": 1e-5, "high": 1e-1, "log": True}, [])
                for _ in range(200)]
        frac_low = np.mean([v < 1e-3 for v in vals])
        assert 0.3 < frac_low < 0.7

    def test_grid_sampler_cycles(self):
        s = tuner.GridSampler()
        spec = {"kind": "cat", "choices": ["a", "b", "c"]}
        hist, out = [], []
        for _ in range(6):
            v = s.sample("c", spec, hist)
            out.append(v)
            hist.append({"state": "COMPLETE", "value": 0.0, "params": {"c": v}, "reports": {}})
        assert out == ["a", "b", "c", "a", "b", "c"]

    def test_study_minimizes_quadratic(self):
        study = tuner.create_study("quad", sampler_params={
            "name": "TPESampler", "configs": {"seed": 0, "n_startup_trials": 8}})

        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            return (x - 0.7) ** 2

        study.optimize(objective, n_trials=40)
        best = study.best_trial
        assert best is not None
        assert abs(best["params"]["x"] - 0.7) < 0.15
        xs = [t["params"]["x"] for t in study.trials if t["state"] == "COMPLETE"]
        assert np.mean(np.abs(np.array(xs[20:]) - 0.7)) < 0.25

    def test_tpe_beats_random_on_toy_objective(self):
        def objective(trial):
            x = trial.suggest_float("x", -1.0, 1.0)
            y = trial.suggest_float("y", -1.0, 1.0)
            return (x - 0.3) ** 2 + (y + 0.2) ** 2

        def best_after(sampler_name, seed):
            study = tuner.create_study(f"{sampler_name}_{seed}", sampler_params={
                "name": sampler_name, "configs": {"seed": seed, "n_startup_trials": 10}})
            study.optimize(objective, n_trials=40)
            return study.best_trial["value"]

        tpe = np.mean([best_after("TPESampler", s) for s in range(5)])
        rnd = np.mean([best_after("RandomSampler", s) for s in range(5)])
        assert tpe < rnd, (tpe, rnd)
        assert tpe < 0.025

    def test_sqlite_storage_shared(self, tmp_path):
        db = str(tmp_path / "study.db")
        s1 = tuner.create_study("shared", storage_path=db)
        s1.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=5)
        s2 = tuner.create_study("shared", storage_path=db)
        assert len(s2.trials) == 5
        s2.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
        assert len(s1.trials) == 8

    def test_concurrent_workers_share_study(self, tmp_path):
        """Two live processes racing on one sqlite study through the port's
        engine: no lost or duplicated trial numbers, every trial terminal
        with its params and reports."""
        db = str(tmp_path / "study.db")
        n_per_worker = 6
        child_src = r"""
import random
import sys
import time

sys.path.insert(0, sys.argv[3])
from ptyrad_tpu_torch.engine.tuner import RandomSampler, Study

db, seed = sys.argv[1], int(sys.argv[2])
study = Study("shared", db, sampler=RandomSampler(seed))

def objective(trial):
    x = trial.suggest_float("x", -1.0, 1.0)
    for step in range(1, 4):
        trial.report(abs(x) + 1.0 / step, step)
        time.sleep(random.random() * 0.02)  # interleave the two writers
    return (x - 0.2) ** 2

study.optimize(objective, n_trials=%d)
print("worker done", len(study.trials))
""" % n_per_worker
        procs = [subprocess.Popen([sys.executable, "-c", child_src, db, str(seed), str(ROOT)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for seed in (0, 1)]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        merged = tuner.create_study("shared", storage_path=db)
        trials = merged.trials
        assert len(trials) == 2 * n_per_worker
        numbers = [t["number"] for t in trials]
        assert len(set(numbers)) == len(numbers), numbers
        assert all(t["state"] == "COMPLETE" for t in trials)
        assert all("x" in t["params"] and len(t["reports"]) == 3 for t in trials)
        assert merged.best_trial["value"] <= min(t["value"] for t in trials) + 1e-12

    def test_grid_sampler_covers_cartesian_product(self):
        s = tuner.GridSampler()
        spec_a = {"kind": "cat", "choices": ["x", "y"]}
        spec_b = {"kind": "int", "low": 0, "high": 2, "step": 1}
        history, seen = [], set()
        for _ in range(6):
            a = s.sample("a", spec_a, history)
            b = s.sample("b", spec_b, history)
            seen.add((a, b))
            history.append({"params": {"a": a, "b": b}, "state": "COMPLETE", "value": 0.0})
        assert seen == {(a, b) for a in ["x", "y"] for b in [0, 1, 2]}

    def test_hyperband_rejects_degenerate_configs(self):
        with pytest.raises(ValueError):
            tuner.HyperbandPruner(reduction_factor=1)
        with pytest.raises(ValueError):
            tuner.HyperbandPruner(min_resource=0)

    def test_median_pruner(self):
        study = tuner.Study(sampler=tuner.RandomSampler(seed=1),
                            pruner=tuner.MedianPruner(n_startup_trials=2))

        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            for step in range(1, 6):
                trial.report(x * step, step)
                if trial.should_prune():
                    raise tuner.TrialPruned()
            return x * 5

        study.optimize(objective, n_trials=20)
        states = [t["state"] for t in study.trials]
        assert "PRUNED" in states and "COMPLETE" in states

    def test_failed_trial_does_not_kill_study(self):
        study = tuner.Study(sampler=tuner.RandomSampler(seed=0))

        def objective(trial):
            x = trial.suggest_float("x", 0, 1)
            if trial.number == 1:
                raise RuntimeError("boom")
            return x

        study.optimize(objective, n_trials=4)
        states = [t["state"] for t in study.trials]
        assert states.count("FAILED") == 1 and states.count("COMPLETE") == 3

    def test_unknown_sampler_pruner(self):
        with pytest.raises(ValueError):
            tuner.create_study("s", sampler_params={"name": "Bogus"})
        with pytest.raises(ValueError):
            tuner.create_study("s", pruner_params={"name": "Bogus"})


@pytest.fixture
def fake_optuna(monkeypatch):
    """tests/fake_optuna.py installed as ``optuna`` (optuna is not installed
    here), as tests/test_hypertune_viz.py's fixture installs it."""
    import fake_optuna as fo

    fo._STUDIES.clear()
    mod = fo.make_module()
    monkeypatch.setitem(sys.modules, "optuna", mod)
    monkeypatch.setitem(sys.modules, "optuna.samplers", mod.samplers)
    monkeypatch.setitem(sys.modules, "optuna.pruners", mod.pruners)
    monkeypatch.setitem(sys.modules, "optuna.exceptions", mod.exceptions)
    return mod


class TestTunerReviewFixesR3:
    def test_builtin_study_catches_optuna_pruned(self, fake_optuna):
        def objective(trial):
            trial.report(1.0, 1)
            raise fake_optuna.exceptions.TrialPruned()

        study = tuner.Study(sampler=tuner.RandomSampler(seed=0))
        study.optimize(objective, n_trials=2)
        assert [t["state"] for t in study.trials] == ["PRUNED", "PRUNED"]
        assert all(t["value"] == 1.0 for t in study.trials)

    def test_random_step_snap_clamped(self):
        s = tuner.RandomSampler(seed=0)
        spec = {"kind": "float", "low": 0.0, "high": 1.0, "step": 0.6}
        assert all(0.0 <= s.sample("x", spec, []) <= 1.0 for _ in range(200))

    def test_grid_axis_respects_bounds_and_log(self):
        g = tuner.GridSampler()
        lin = g._axis("a", {"kind": "float", "low": 0.0, "high": 1.0, "step": 0.6})
        assert max(lin) <= 1.0 + 1e-12
        lg = g._axis("b", {"kind": "float", "low": 1e-5, "high": 1e-1, "log": True})
        assert min(lg) == pytest.approx(1e-5) and max(lg) == pytest.approx(1e-1)
        assert sum(v < 1e-3 for v in lg) == 5

    def test_load_if_exists_false_clears_only_this_study(self, tmp_path):
        db = str(tmp_path / "shared.db")
        a = tuner.create_study("A", db)
        a.storage.create_trial()
        tuner.create_study("B", db, load_if_exists=False)
        assert len(a.storage.all_trials()) == 1
        b2 = tuner.create_study("B", db, load_if_exists=False)
        assert len(b2.storage.all_trials()) == 0

    def test_grid_int_log_axis_yields_deduped_ints(self):
        ax = tuner.GridSampler()._axis("n", {"kind": "int", "low": 1, "high": 64, "log": True})
        assert all(isinstance(v, int) for v in ax)
        assert len(set(ax)) == len(ax) and ax == sorted(ax)
        assert ax[0] == 1 and ax[-1] == 64

    def test_storage_path_none_means_in_memory(self):
        from ptyrad_tpu_torch.params.schema import HypertuneParams

        assert HypertuneParams(storage_path=None).storage_path is None
        assert tuner.create_study("mem", None).storage.path is None

    def test_log_space_low_zero_rejected(self):
        study = tuner.Study(sampler=tuner.RandomSampler(seed=0))
        trial = tuner.Trial(study, study.storage.create_trial())
        with pytest.raises(ValueError, match="low > 0"):
            trial.suggest_float("dz", 0.0, 2.0, log=True)


class TestTunerReviewFixesR5:
    def test_suggest_int_log_requires_positive_low(self):
        study = tuner.Study(sampler=tuner.RandomSampler(seed=0))
        study.optimize(lambda trial: float(trial.suggest_int("n", 0, 64, log=True)), n_trials=1)
        (t,) = study.trials
        assert t["state"] == "FAILED"
        trial = tuner.Trial(study, study.storage.create_trial())
        with pytest.raises(ValueError, match="requires low > 0"):
            trial.suggest_int("n", 0, 64, log=True)

    def test_grid_endpoint_survives_large_magnitude_axes(self):
        ax = tuner.GridSampler()._axis("x", {"kind": "float", "low": 0.0, "high": 1e6})
        assert len(ax) == 10 and ax[-1] == 1e6
        assert all(v <= 1e6 for v in ax)


def test_storage_accepts_optuna_uri(tmp_path):
    """The demo's storage_path is an optuna URI (sqlite:///file)."""
    path = tmp_path / "h.sqlite3"
    study = tuner.create_study("uri", storage_path=f"sqlite:///{path}")
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2)
    assert os.path.exists(path) and len(tuner.create_study("uri", str(path)).trials) == 2
