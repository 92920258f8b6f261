"""ptyrad_tpu_torch.engine.hypertune against ptyrad_tpu.engine.hypertune on
the CPU, in one process, on the same seeded inputs.

- The staged re-init (dz, dx, Nlayer, the learning rates, the batch size and
  optimizer, affine with the identity after a scaled trial, tilts, the probe
  fields): the port's init_variables equal the JAX package's at rtol 1e-6
  (both Initializers seeded alike: np.random.seed(s) there,
  RandomState(s) here), and so do the trial params dicts.
- A 3-trial run_hypertune with RandomSampler(seed=0), Adam, and the same
  study with LBFGS (its first trial; all 3 under -m slow): the same params
  per trial and each trial's error at rtol
  1e-4 of the JAX package's, and for LBFGS the same line-search steps.
  These studies run on the initializer test's problem (16 patterns of 32²
  simulated through forward() into a .raw, a probe defocused by 200 Ang;
  tests/torch_port_helpers.recon_params_file), whose 2-iteration solver
  runs the two packages agree on at rtol 1e-4. hypertune_cfg's own problem
  (a synthetic disk stack, a focused probe) parts the two packages' plain
  solver runs by up to 6e-4 in the second iteration: Adam's first step is
  lr·sign(g) on pixels whose gradients are float32 rounding.
- The contrast metric against the JAX objp_contrast at rtol 1e-6.
- A diverging trial is FAILED while the study goes on (the built-in engine
  and the optuna branch, through tests/fake_optuna.py); collation names; the
  h5py check; the previous trial's solver is not kept alive.
"""

import copy
import gc
import glob
import os
import re
import sys
import weakref

import numpy as np
import pytest

from ptyrad_tpu.engine import hypertune as jax_ht
from ptyrad_tpu.engine import tuner as jax_tuner
from ptyrad_tpu.initialization import Initializer as JaxInitializer
from ptyrad_tpu_torch.engine import hypertune as ht
from ptyrad_tpu_torch.engine import tuner
from ptyrad_tpu_torch.initialization import Initializer
from torch_port_helpers import SOLVER_SEED, recon_params_file

INIT_SEED = 3


# -- hypertune_cfg's small problem (tests/test_init_io.py:22-62 and
#    tests/test_hypertune_viz.py:226-253, copied) --------------------------------

def synth_meas(rng, n_scans=16, npix=32):
    y, x = np.mgrid[:npix, :npix] - npix // 2
    disk = (np.hypot(y, x) < npix // 5).astype(np.float32)
    meas = disk[None] * (1 + 0.05 * rng.standard_normal((n_scans, npix, npix)).astype(np.float32))
    return np.clip(meas, 0, None) + 1e-4


def base_init_params(rng, n_scans=16, npix=32, **over):
    side = int(np.sqrt(n_scans))
    p = {
        "probe_illum_type": "electron", "probe_kv": 80.0, "probe_conv_angle": 24.9,
        "meas_Npix": npix, "pos_N_scans": n_scans, "pos_N_scan_slow": side,
        "pos_N_scan_fast": side, "pos_scan_step_size": 0.43,
        "meas_calibration": {"mode": "dx", "value": 0.15}, "probe_pmode_max": 2,
        "probe_pmode_init_pows": [0.05], "obj_omode_max": 1,
        "obj_omode_init_occu": {"occu_type": "uniform"}, "obj_Nlayer": 2,
        "obj_slice_thickness": 2.0, "meas_source": "custom",
        "meas_params": synth_meas(rng, n_scans, npix), "probe_source": "simu",
        "probe_params": None, "pos_source": "simu", "pos_params": None, "obj_source": "simu",
        "obj_params": None, "tilt_source": "simu",
        "tilt_params": {"tilt_type": "all", "init_tilts": [[0, 0]]}, "pos_scan_rand_std": None,
    }
    p.update(over)
    return p


TUNE_NAMES = ["optimizer", "batch_size", "plr", "oalr", "oplr", "slr", "tlr", "dzlr", "dx",
              "pmode_max", "conv_angle", "defocus", "c3", "c5", "Nlayer", "dz", "scale",
              "asymmetry", "rotation", "shear", "tilt_y", "tilt_x"]


def hypertune_cfg(rng, tmp_path, n_trials=3, niter=2, tune_over=None):
    tune = {name: {"state": False, "suggest": "float", "kwargs": {"low": 0, "high": 1}}
            for name in TUNE_NAMES}
    tune.update(tune_over or {})
    return {
        "init_params": base_init_params(rng),
        "model_params": {
            "optimizer_params": {"name": "Adam"},
            "update_params": {"objp": {"lr": 2e-3, "start_iter": 1}},
        },
        "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}},
        "recon_params": {
            "NITER": niter, "BATCH_SIZE": {"size": 8}, "SAVE_ITERS": None,
            "output_dir": str(tmp_path / "ht_out"),
        },
        "hypertune_params": {
            "if_hypertune": True, "collate_results": False, "append_params": True,
            "sampler_params": {"name": "RandomSampler", "configs": {"seed": 0}},
            "pruner_params": None, "n_trials": n_trials, "timeout": None,
            "error_metric": "loss",
            "storage_path": str(tmp_path / "ht.db"), "study_name": "test",
            "tune_params": tune,
        },
    }


def _tune(suggest, **kwargs):
    return {"state": True, "suggest": suggest, "kwargs": kwargs}


# -- the staged re-init ----------------------------------------------------------

REINIT_CASES = {
    "dz": {"dz": _tune("float", low=3.0, high=5.0, step=0.5)},
    "dx": {"dx": _tune("float", low=0.14, high=0.16, step=0.005)},
    "Nlayer": {"Nlayer": _tune("int", low=1, high=4, step=1)},
    "learning_rates": {"oplr": _tune("cat", choices=[7e-3, 1e-3]),
                       "plr": _tune("float", low=1e-4, high=1e-2, log=True),
                       "slr": _tune("float", low=1e-4, high=1e-2, log=True),
                       "tlr": _tune("float", low=1e-4, high=1e-2, log=True),
                       "dzlr": _tune("float", low=1e-4, high=1e-2, log=True)},
    "batch_and_optimizer": {"batch_size": _tune("int", low=2, high=16, log=True),
                            "optimizer": _tune("cat", choices=["Adam", "SGD"],
                                               optim_configs={"SGD": {"momentum": 0.9}})},
    "affine": {"scale": _tune("cat", choices=[1.5, 1.0]),
               "asymmetry": _tune("float", low=-0.1, high=0.1, step=0.05),
               "rotation": _tune("float", low=-4, high=4, step=0.5),
               "shear": _tune("float", low=-2, high=2, step=0.5)},
    "tilts": {"tilt_y": _tune("float", low=-5, high=5, step=0.5),
              "tilt_x": _tune("float", low=-5, high=5, step=0.5)},
    "probe_fields": {"pmode_max": _tune("int", low=1, high=4, step=1),
                     "conv_angle": _tune("float", low=20, high=26, step=1),
                     "defocus": _tune("float", low=-50, high=50, step=0.1),
                     "c3": _tune("float", low=4000, high=10000, step=100),
                     "c5": _tune("float", low=50000, high=100000, step=5000)},
}


def assert_init_equal(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, want in ref.items():
        got = ours[k]
        if isinstance(want, np.ndarray):
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
        elif isinstance(want, (float, np.floating)):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
        else:
            assert got == want, k


def without_meas(params: dict) -> dict:
    """A params dict without its in-memory measurements (an array)."""
    return {**params, "init_params": {k: v for k, v in params["init_params"].items()
                                      if k != "meas_params"}}


@pytest.mark.parametrize("case", sorted(REINIT_CASES))
def test_staged_reinit_matches_jax(tmp_path, case):
    """Three trials of one RandomSampler(seed=0) study per package on one
    pair of Initializers: after each, the init_variables and the trial's
    params dict are the JAX package's."""
    cfg = hypertune_cfg(np.random.default_rng(42), tmp_path, tune_over=REINIT_CASES[case])
    np.random.seed(INIT_SEED)
    ji = JaxInitializer(cfg["init_params"], verbose=False).init_all()
    ti = Initializer(cfg["init_params"], verbose=False,
                     rng=np.random.RandomState(INIT_SEED)).init_all()
    assert_init_equal(ti.init_variables, ji.init_variables)
    js = jax_tuner.Study(sampler=jax_tuner.RandomSampler(seed=0))
    ts = tuner.Study(sampler=tuner.RandomSampler(seed=0))
    before = copy.deepcopy(ti.init_variables)
    for _ in range(3):
        jt = jax_tuner.Trial(js, js.storage.create_trial())
        tt = tuner.Trial(ts, ts.storage.create_trial())
        jp = jax_ht.apply_trial_params(jt, cfg, ji)
        tp = ht.apply_trial_params(tt, cfg, ti)
        assert tt.params == jt.params
        assert without_meas(tp) == without_meas(jp)
        assert_init_equal(ti.init_variables, ji.init_variables)
    changed = [k for k in before if isinstance(before[k], np.ndarray)
               and (before[k].shape != ti.init_variables[k].shape
                    or not np.array_equal(before[k], ti.init_variables[k]))]
    if case not in ("learning_rates", "batch_and_optimizer"):
        assert changed, f"{case}: no init variable was re-made"


def test_identity_affine_trial_resets_previous_trial_state(tmp_path):
    """A trial that samples the identity affine after a scaled one puts the
    positions back (the JAX package's review r3 case), in both packages."""
    rng = np.random.default_rng(42)
    init_params = base_init_params(rng)
    np.random.seed(INIT_SEED)
    ji = JaxInitializer(init_params, verbose=False).init_all()
    ti = Initializer(init_params, verbose=False, rng=np.random.RandomState(INIT_SEED)).init_all()
    baseline = ti.init_variables["crop_pos"].copy()
    for choice in (1.5, 1.0):
        cfg = hypertune_cfg(rng, tmp_path, tune_over={"scale": _tune("cat", choices=[choice])})
        for mod, tun, init in ((ht, tuner, ti), (jax_ht, jax_tuner, ji)):
            study = tun.Study(sampler=tun.RandomSampler(seed=0))
            mod.apply_trial_params(tun.Trial(study, study.storage.create_trial()), cfg, init)
        assert_init_equal(ti.init_variables, ji.init_variables)
        if choice == 1.5:
            assert not np.array_equal(ti.init_variables["crop_pos"], baseline)
    np.testing.assert_array_equal(ti.init_variables["crop_pos"], baseline)


# -- whole studies against the JAX package ----------------------------------------

def study_cfg(tmp_path, optimizer, error_metric="loss"):
    """The initializer test's validated params (a .raw of simulated patterns)
    with hypertune_cfg's hypertune section: 3 trials of 2 iterations tuning
    the objp rate, scale and rotation, RandomSampler(seed=0), no pruner."""
    from ptyrad_tpu_torch.load import load_params

    cfg = load_params(str(recon_params_file(tmp_path, "p.json")))
    meas_params = cfg["init_params"]["meas_params"]
    meas_params["path"] = str(meas_params["path"])  # the JAX package's reader takes a str
    cfg["recon_params"]["NITER"] = 2
    cfg["model_params"]["optimizer_params"] = {"name": optimizer}
    cfg["hypertune_params"] = hypertune_cfg(np.random.default_rng(42), tmp_path, tune_over={
        "oplr": _tune("cat", choices=[2.5e-4, 5e-4, 1e-3]),
        "scale": _tune("float", low=0.9, high=1.1, step=0.02),
        "rotation": _tune("float", low=-4, high=4, step=0.5),
    })["hypertune_params"]
    cfg["hypertune_params"]["error_metric"] = error_metric
    return cfg


def run_both(tmp_path, cfg):
    """(JAX study, port study) of one params dict, each on its own sqlite
    file and output folder, the Initializers seeded alike."""
    runs = []
    for name, run in (("jax", jax_ht.run_hypertune), ("torch", ht.run_hypertune)):
        c = copy.deepcopy(cfg)
        c["hypertune_params"]["storage_path"] = str(tmp_path / f"{name}.db")
        c["recon_params"]["output_dir"] = str(tmp_path / f"{name}_out")
        if name == "jax":
            np.random.seed(SOLVER_SEED)
            runs.append(run(c, use_optuna=False))
        else:
            runs.append(run(c, use_optuna=False, device="cpu",
                            init_rng=np.random.RandomState(SOLVER_SEED)))
    return runs


def assert_studies_match(js, ts, n_trials=3):
    assert len(ts.trials) == len(js.trials) == n_trials
    for a, b in zip(ts.trials, js.trials):
        assert a["params"] == b["params"]
        assert a["state"] == b["state"] == "COMPLETE"
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)


def test_adam_study_matches_jax(tmp_path):
    js, ts = run_both(tmp_path, study_cfg(tmp_path, "Adam"))
    assert_studies_match(js, ts)
    assert len({t["value"] for t in ts.trials}) == 3


@pytest.mark.parametrize("n_trials", [1, pytest.param(3, marks=pytest.mark.slow)])
def test_lbfgs_study_matches_jax(tmp_path, monkeypatch, n_trials):
    """LBFGS trials: the errors at rtol 1e-4 and the same line-search steps
    in every iteration of every trial (the JAX trial passes its lbfgs_step
    the permuted batches of the iteration; the port's _lbfgs_loop(permute=True)
    does the same). Each JAX trial compiles its own LBFGS step (about 14 s
    here), so the whole 3-trial study is marked slow and the first trial
    alone runs in the fast suite."""
    import ptyrad_tpu.engine.solver as jax_solver

    j_steps, t_steps = [], []
    build = jax_solver.build_lbfgs_step

    def recording_build(*a, **k):
        step = build(*a, **k)

        def recorded(params, opt_state, idx, mask, niter=1):
            out = step(params, opt_state, idx, mask, niter)
            j_steps.append(int(out[1][1][2].info.num_linesearch_steps))
            return out
        return recorded

    monkeypatch.setattr(jax_solver, "build_lbfgs_step", recording_build)
    run_loop = ht._run_trial_loop

    def recording_loop(*a, **k):
        out = run_loop(*a, **k)
        t_steps.extend(s for _, s, _ in out[0].history.linesearch)
        return out

    monkeypatch.setattr(ht, "_run_trial_loop", recording_loop)
    cfg = study_cfg(tmp_path, "LBFGS")
    cfg["hypertune_params"]["n_trials"] = n_trials
    js, ts = run_both(tmp_path, cfg)
    assert_studies_match(js, ts, n_trials=n_trials)
    assert len(t_steps) == 2 * n_trials and t_steps == j_steps


def test_collated_files_match_jax_names(tmp_path):
    """collate_results with save_result [objp] and selected_figs [loss,
    forward]: the same files per trial as the JAX package's, the error in
    the name aside (it agrees at rtol 1e-4, not to its fifth decimal)."""
    cfg = study_cfg(tmp_path, "Adam")
    cfg["hypertune_params"].update(collate_results=True, n_trials=2)
    cfg["recon_params"].update(save_result=["objp"], selected_figs=["loss", "forward"],
                               result_modes={"obj_dim": [2], "FOV": ["crop"], "bit": ["8"]})
    js, ts = run_both(tmp_path, cfg)
    assert_studies_match(js, ts, n_trials=2)

    def names(folder):
        return sorted(re.sub(r"_error_[0-9.]+_", "_error_E_", f)
                      for f in os.listdir(tmp_path / folder))

    ours = names("torch_out")
    assert ours == names("jax_out")
    assert any(f.startswith("summary_forward_error_E_t0001") for f in ours), ours
    assert any(f.startswith("objp_zsum") and "_t0000_oplr_" in f for f in ours), ours


def test_contrast_metric_matches_jax():
    """objp_contrast on the same arrays, one and two object modes, the whole
    scan and a subset: rtol 1e-6."""
    from ptyrad_tpu.losses import objp_contrast as jax_contrast
    from ptyrad_tpu_torch.losses import objp_contrast

    rng = np.random.default_rng(0)
    pos = rng.integers(0, 40, size=(30, 2)).astype(np.int32)
    for omode in (1, 2):
        objp = rng.standard_normal((omode, 3, 80, 80)).astype(np.float32)
        for idx in (None, np.arange(5, 25)):
            np.testing.assert_allclose(objp_contrast(objp, pos, (32, 32), idx),
                                       jax_contrast(objp, pos, (32, 32), idx), rtol=1e-6)


def test_contrast_study_runs(tmp_path, monkeypatch):
    """error_metric 'contrast': each trial's error is minus the port's
    objp_contrast of its final object, within the metric's range, at rtol
    1e-6 of the JAX objp_contrast of the same object."""
    from ptyrad_tpu.losses import objp_contrast as jax_contrast

    cfg = study_cfg(tmp_path, "Adam", error_metric="contrast")
    cfg["hypertune_params"]["n_trials"] = 2
    seen = []
    run_loop = ht._run_trial_loop

    def recording_loop(*a, **k):
        solver, error, pruned = run_loop(*a, **k)
        seen.append((error, solver.params.objp.detach().numpy(),
                     solver.buffers.crop_pos.numpy(), solver.geom.probe_shape, solver.indices))
        return solver, error, pruned

    monkeypatch.setattr(ht, "_run_trial_loop", recording_loop)
    study = ht.run_hypertune(cfg, use_optuna=False, device="cpu",
                             init_rng=np.random.RandomState(SOLVER_SEED))
    assert [t["state"] for t in study.trials] == ["COMPLETE", "COMPLETE"]
    for (error, objp, pos, shape, idx), t in zip(seen, study.trials):
        assert t["value"] == error < 0
        np.testing.assert_allclose(error, -jax_contrast(objp, pos, shape, idx), rtol=1e-6)


# -- failures, the optuna branch, memory ------------------------------------------

def diverging_cfg(tmp_path):
    """SGD on obja with a rate of 1e22 in one of two choices: that trial's
    loss goes non-finite (tests/test_hypertune_viz.py:560)."""
    cfg = hypertune_cfg(np.random.default_rng(42), tmp_path, n_trials=4, niter=3, tune_over={
        "oalr": _tune("cat", choices=[1e22, 1e-4])})
    cfg["model_params"]["optimizer_params"] = {"name": "SGD"}
    return cfg


def test_diverging_trial_is_failed_and_the_study_goes_on(tmp_path):
    study = ht.run_hypertune(diverging_cfg(tmp_path), use_optuna=False, device="cpu",
                             init_rng=np.random.RandomState(INIT_SEED))
    states = [t["state"] for t in study.trials]
    assert len(states) == 4 and "FAILED" in states and "COMPLETE" in states, states
    for t in study.trials:
        assert (t["state"] == "FAILED") == (t["params"]["oalr"] == 1e22)


def test_non_finite_loss_raises_before_any_report(tmp_path):
    cfg = diverging_cfg(tmp_path)
    cfg["hypertune_params"]["pruner_params"] = {"name": "MedianPruner", "configs": {}}
    cfg["hypertune_params"]["tune_params"]["oalr"] = _tune("cat", choices=[1e22])
    init = Initializer(cfg["init_params"], verbose=False,
                       rng=np.random.RandomState(INIT_SEED)).init_all()
    study = tuner.Study(sampler=tuner.RandomSampler(seed=0))
    trial = tuner.Trial(study, study.storage.create_trial())
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        ht.hypertune_objective(trial, cfg, init, device="cpu")
    assert all(np.isfinite(v) for v in trial._reports.values())


@pytest.fixture
def fake_optuna(monkeypatch):
    """tests/fake_optuna.py installed as ``optuna`` (optuna is not installed
    here), as tests/test_hypertune_viz.py:510 installs it."""
    import fake_optuna as fo

    fo._STUDIES.clear()
    mod = fo.make_module()
    monkeypatch.setitem(sys.modules, "optuna", mod)
    monkeypatch.setitem(sys.modules, "optuna.samplers", mod.samplers)
    monkeypatch.setitem(sys.modules, "optuna.pruners", mod.pruners)
    monkeypatch.setitem(sys.modules, "optuna.exceptions", mod.exceptions)
    return mod


class TestOptunaBranch:
    def test_run_hypertune_optuna_end_to_end(self, tmp_path, fake_optuna):
        cfg = hypertune_cfg(np.random.default_rng(42), tmp_path, tune_over={
            "oplr": _tune("float", low=1e-3, high=1e-2, log=True)})
        cfg["hypertune_params"]["sampler_params"] = {
            "name": "TPESampler", "configs": {"seed": 0, "multivariate": True}}
        study = ht.run_hypertune(cfg, use_optuna=True, device="cpu")
        assert isinstance(study, fake_optuna.Study)
        assert study.storage.startswith("sqlite:///")
        assert [t.state for t in study.trials] == ["COMPLETE"] * 3
        assert all(1e-3 <= t.params["oplr"] <= 1e-2 for t in study.trials)
        assert np.isfinite(study.best_trial.value)

    def test_optuna_pruner_reports_intermediates(self, tmp_path, fake_optuna):
        cfg = hypertune_cfg(np.random.default_rng(42), tmp_path, n_trials=2, niter=3,
                            tune_over={"oplr": _tune("float", low=1e-3, high=1e-2, log=True)})
        cfg["hypertune_params"]["pruner_params"] = {
            "name": "MedianPruner", "configs": {"n_startup_trials": 5}}
        study = ht.run_hypertune(cfg, use_optuna=True, device="cpu")
        for t in study.trials:
            assert set(t.intermediate_values) == {1, 2, 3}

    def test_diverging_trial_does_not_kill_optuna_study(self, tmp_path, fake_optuna):
        study = ht.run_hypertune(diverging_cfg(tmp_path), use_optuna=True, device="cpu",
                                 init_rng=np.random.RandomState(INIT_SEED))
        states = [t.state for t in study.trials]
        assert len(states) == 4 and "FAIL" in states and "COMPLETE" in states, states


def test_collating_a_checkpoint_without_h5py_stops_before_the_first_trial(tmp_path,
                                                                           monkeypatch):
    cfg = hypertune_cfg(np.random.default_rng(42), tmp_path)
    cfg["hypertune_params"]["collate_results"] = True
    cfg["recon_params"]["save_result"] = ["model", "objp"]
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(ht, "Initializer", None)  # never reached
    with pytest.raises(ImportError, match="h5py"):
        ht.run_hypertune(cfg, use_optuna=False, device="cpu")
    assert not os.path.exists(tmp_path / "ht.db")


def test_previous_trial_is_not_kept_alive(tmp_path, monkeypatch):
    """Once a trial has ended (complete, pruned or failed) nothing holds its
    solver: the next trial starts with the last one's tensors freed."""
    refs = []
    run_loop = ht._run_trial_loop

    def recording_loop(*a, **k):
        out = run_loop(*a, **k)
        refs.append(weakref.ref(out[0]))
        return out

    monkeypatch.setattr(ht, "_run_trial_loop", recording_loop)
    cfg = hypertune_cfg(np.random.default_rng(42), tmp_path, n_trials=3, tune_over={
        "oplr": _tune("float", low=1e-3, high=1e-2, log=True)})
    cfg["hypertune_params"]["pruner_params"] = {"name": "MedianPruner",
                                                "configs": {"n_startup_trials": 1}}
    cfg["hypertune_params"]["collate_results"] = True
    cfg["recon_params"]["save_result"] = ["objp"]
    cfg["recon_params"]["selected_figs"] = ["loss"]
    study = ht.run_hypertune(cfg, use_optuna=False, device="cpu",
                             init_rng=np.random.RandomState(INIT_SEED))
    assert len(refs) == 3 and {t["state"] for t in study.trials} <= {"COMPLETE", "PRUNED"}
    alive = [r() is not None for r in refs]
    gc.collect()
    assert alive == [False] * 3, "a trial's solver outlived its trial without a gc pass"
    assert glob.glob(str(tmp_path / "ht_out" / "summary_loss_error_*_t0000_oplr_*_iter0002.png"))
