"""The command line: ptyrad_tpu_torch's cli.py against ptyrad_tpu's, on the
CPU at a small size, and the port's logger.

``run --device cpu`` on a yml writes the output folder (named as the JAX
CLI names it for the same yml), the checkpoint, the log and the params
copy; validate-params and export-meas-init behave as the JAX commands do;
the flags that ask for what is not ported (several devices, a distributed
launch, bfloat16) refuse; a params file with if_hypertune runs its study,
its log file named with the --jobid prefix; a run without CUDA and without
``--device cpu`` stops with resolve_device's message; a run that would save
a checkpoint without h5py stops before the Initializer; CustomLogger keeps
the JAX logger's flush semantics (tests/test_logging_system.py).
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from ptyrad_tpu.cli import main as j_main
from ptyrad_tpu_torch.cli import main
from ptyrad_tpu_torch.load import load_ptyrad
from ptyrad_tpu_torch.utils.logging import CustomLogger, vprint
from test_torch_initializer import synth_meas

ROOT = Path(__file__).resolve().parent.parent


def recon_yml(tmp_path, name, out, **recon_over):
    """test_init_io.py's CLI run: 16 patterns of 32² from a .npy, 2 probe
    modes, 1 slice, 3 iterations saved every 2, as a yml."""
    meas_path = tmp_path / "meas.npy"
    if not meas_path.exists():
        np.save(meas_path, synth_meas(seed=1, n=16))
    params = {
        "init_params": {
            "probe_kv": 80.0, "probe_conv_angle": 24.9, "meas_Npix": 32,
            "pos_N_scan_slow": 4, "pos_N_scan_fast": 4, "pos_scan_step_size": 0.43,
            "meas_calibration": {"mode": "dx", "value": 0.15}, "probe_pmode_max": 2,
            "obj_Nlayer": 1, "obj_slice_thickness": 2.0, "meas_source": "file",
            "meas_params": {"path": str(meas_path)}, "pos_scan_rand_std": 0.0,
        },
        "model_params": {"update_params": {
            "obja": {"start_iter": 1, "lr": 1e-3}, "objp": {"start_iter": 1, "lr": 1e-3},
            "probe": {"start_iter": 1, "lr": 1e-4}}},
        "recon_params": {
            "NITER": 3, "SAVE_ITERS": 2, "BATCH_SIZE": {"size": 8}, "output_dir": str(out),
            "save_result": ["model", "objp", "obja", "probe"],
            "result_modes": {"obj_dim": [2], "FOV": ["full"], "bit": ["raw"]},
            "selected_figs": [], **recon_over,
        },
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(params))
    return str(path)


@pytest.fixture()
def no_loggers():
    yield
    for name in ("ptyrad_tpu", "ptyrad_tpu_torch"):
        logging.getLogger(name).handlers.clear()


def test_run_writes_what_the_jax_cli_writes(tmp_path, no_loggers):
    """One output folder, named as the JAX CLI names it, holding the
    checkpoints of iterations 2 and 3, the images, the params copy and the
    log; the checkpoint reads back."""
    ours = recon_yml(tmp_path, "ours.yml", tmp_path / "out_torch", prefix_time="date")
    theirs = recon_yml(tmp_path, "theirs.yml", tmp_path / "out_jax", prefix_time="date")
    assert main(["run", "--params_path", ours, "--device", "cpu"]) == 0
    assert not logging.getLogger("ptyrad_tpu_torch").handlers  # the run closes its log
    assert j_main(["run", "--params_path", theirs]) == 0
    (folder,) = os.listdir(tmp_path / "out_torch")
    assert os.listdir(tmp_path / "out_jax") == [folder]
    files = set(os.listdir(tmp_path / "out_torch" / folder))
    jax_files = set(os.listdir(tmp_path / "out_jax" / folder))
    date = folder.split("_")[0]
    assert f"{date}_ptyrad_tpu_torch_log.txt" in files and "ours.yml" in files
    assert files - {f"{date}_ptyrad_tpu_torch_log.txt", "ours.yml"} == \
        jax_files - {f"{date}_ptyrad_tpu_log.txt", "theirs.yml"}
    assert {"model_iter0002.hdf5", "model_iter0003.hdf5", "objp_iter0003.tif",
            "probe_amp_iter0002.tif"} <= files
    log = (tmp_path / "out_torch" / folder / f"{date}_ptyrad_tpu_torch_log.txt").read_text()
    assert "### System information ###" in log and "Iter: 3, Total Loss" in log
    ckpt = load_ptyrad(str(tmp_path / "out_torch" / folder / "model_iter0003.hdf5"))
    assert ckpt["optimizable_tensors"]["probe"].shape == (2, 32, 32)
    assert ckpt["niter"] == 3 and ckpt["model_attributes"]["dx"] == pytest.approx(0.15)


def bad_key(d):
    d["init_params"]["bogus_field"] = 1


def bad_type(d):
    d["recon_params"]["NITER"] = "many"


def missing_required(d):
    del d["init_params"]["probe_kv"]


def bad_affixes(d):
    d["recon_params"]["result_modes"]["FOV"] = ["wide"]


@pytest.mark.parametrize("spoil", [None, bad_key, bad_type, missing_required, bad_affixes],
                         ids=lambda f: "valid" if f is None else f.__name__)
def test_validate_params_exit_codes_match_jax(tmp_path, spoil, capsys):
    path = recon_yml(tmp_path, "p.yml", tmp_path / "out")
    if spoil is not None:
        d = yaml.safe_load(open(path))
        spoil(d)
        Path(path).write_text(yaml.safe_dump(d))
    rc = main(["validate-params", "--params_path", path])
    assert rc == j_main(["validate-params", "--params_path", path])
    assert rc == (0 if spoil is None else 1)
    out = capsys.readouterr().out
    assert ("is valid" in out) == (spoil is None)


@pytest.mark.parametrize("extra", [[], ["--reshape", "4", "4", "32", "32"],
                                   ["--reshape", "4", "4", "32", "32", "--append"],
                                   ["--append"]],
                         ids=["plain", "reshape", "reshape_append", "append"])
def test_export_meas_init_writes_what_the_jax_command_writes(tmp_path, extra):
    path = recon_yml(tmp_path, "p.yml", tmp_path / "out")
    for side, fn in (("torch", main), ("jax", j_main)):
        out = tmp_path / side / "exported.npy"
        assert fn(["export-meas-init", "--params_path", path, "--output", str(out), *extra]) == 0
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 1
    a, b = (np.load(tmp_path / side / names[0]) for side in ("jax", "torch"))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert a.shape == ((4, 4, 32, 32) if "--reshape" in extra else (16, 32, 32))


# Since the ranks are ported (tests/test_torch_dist.py runs them), each
# flag here is given in a form that cannot start a run, which refuses before
# anything is read or written.
FLAG_CASES = {
    "distributed_flag_alone": (["--coordinator_address", "localhost:1234"], SystemExit,
                               "--multihost"),
    "multihost": (["--multihost"], ValueError, "torchrun's environment lacks"),
    "multihost_with_flags": (["--multihost", "--num_processes", "2", "--process_id", "0"],
                             ValueError, "together"),
    "n_devices": (["--n_devices", "0"], ValueError, "at least 1"),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flags_for_what_is_not_ported_refuse(tmp_path, case, no_loggers):
    args, error, match = FLAG_CASES[case]
    path = recon_yml(tmp_path, "p.yml", tmp_path / "out")
    with pytest.raises(error, match=match):
        main(["run", "--params_path", path, "--device", "cpu", *args])
    assert not (tmp_path / "out").exists()


def test_run_mixed_precision_takes_the_bf16_policy(tmp_path, no_loggers):
    """--mixed_precision sets model_params compute_dtype and matmul_dtype to
    bfloat16, as the JAX CLI does (ptyrad_tpu/cli.py:32-33); ``run
    --mixed_precision --device cpu`` takes one iteration, exits 0, and the
    log names the policy."""
    from types import SimpleNamespace

    from ptyrad_tpu.cli import _apply_common_overrides as j_overrides
    from ptyrad_tpu_torch.cli import _apply_common_overrides

    set_by = []
    for fn in (_apply_common_overrides, j_overrides):
        params = {"model_params": {"compute_dtype": "float32"}}
        fn(params, SimpleNamespace(mixed_precision=True))
        set_by.append(params["model_params"])
    assert set_by[0] == set_by[1] == {"compute_dtype": "bfloat16", "matmul_dtype": "bfloat16"}

    out = tmp_path / "out"
    path = recon_yml(tmp_path, "p.yml", out, NITER=1, SAVE_ITERS=1)
    assert main(["run", "--params_path", path, "--device", "cpu", "--mixed_precision"]) == 0
    (folder,) = os.listdir(out)
    (log_name,) = [f for f in os.listdir(out / folder) if f.endswith("ptyrad_tpu_torch_log.txt")]
    log = (out / folder / log_name).read_text()
    assert "Compute policy: compute_dtype=bfloat16, transform operands bfloat16" in log
    assert "Iter: 1, Total Loss" in log and "Iter: 2," not in log


def test_run_with_if_hypertune_runs_the_study(tmp_path, no_loggers):
    """``run --device cpu --jobid 3`` on a params file with if_hypertune: two
    trials of the schema's default search (scale and rotation) through the
    built-in engine into the sqlite file, the collated results in
    output_dir, and the log there as <date>_3_ptyrad_tpu_torch_log.txt."""
    from ptyrad_tpu_torch.engine import tuner

    out = tmp_path / "out"
    path = recon_yml(tmp_path, "p.yml", out, NITER=2, save_result=["objp"])
    d = yaml.safe_load(open(path))
    d["hypertune_params"] = {"if_hypertune": True, "n_trials": 2,
                             "storage_path": str(tmp_path / "ht.db"), "study_name": "cli",
                             "sampler_params": {"name": "RandomSampler", "configs": {"seed": 0}}}
    Path(path).write_text(yaml.safe_dump(d))
    assert main(["run", "--params_path", path, "--device", "cpu", "--jobid", "3"]) == 0
    trials = tuner.create_study("cli", str(tmp_path / "ht.db")).trials
    assert [t["number"] for t in trials] == [0, 1]
    assert all(t["state"] == "COMPLETE" and set(t["params"]) == {"scale", "rotation"}
               and set(t["reports"]) == {"1", "2"} for t in trials)
    files = os.listdir(out)
    for n in (0, 1):
        assert any(f.startswith("objp_") and f"_t{n:04d}_scale_" in f for f in files), files
    logs = [f for f in files if f.endswith("_3_ptyrad_tpu_torch_log.txt")]
    assert len(logs) == 1, files
    log = open(out / logs[0]).read()
    assert "Starting hypertune: 2 trials, engine=builtin" in log and "Best trial: #" in log


def test_run_without_cuda_stops_with_resolve_devices_message(tmp_path):
    """The default device is CUDA: with no CUDA device visible the run
    stops before reading anything, with a nonzero exit."""
    path = recon_yml(tmp_path, "p.yml", tmp_path / "out")
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "run", "--params_path", path],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA is not available on this host; pass device='cpu'" in out.stderr
    assert not (tmp_path / "out").exists()


def test_missing_h5py_stops_the_run_before_it_starts(tmp_path, monkeypatch, capsys, no_loggers):
    """save_result with 'model' and no h5py: the run stops before the
    Initializer, naming h5py, where the JAX package fails at its first save."""
    import ptyrad_tpu_torch.engine.workflow as wf

    path = recon_yml(tmp_path, "p.yml", tmp_path / "out")
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(wf, "PtyRADSolver", None)  # never reached
    with pytest.raises(ImportError, match="h5py"):
        main(["run", "--params_path", path, "--device", "cpu"])
    assert "Iter:" not in capsys.readouterr().out


def test_help_check_gpu_and_system_info(capsys):
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "check-gpu" in out.stdout and "bench" not in out.stdout
    import torch

    cuda = torch.cuda.is_available()
    assert main(["check-gpu"]) == (0 if cuda else 1)
    assert ("CUDA            : not available" in capsys.readouterr().out) != cuda
    assert main(["print-system-info"]) == 0
    out = capsys.readouterr().out
    assert "### System information ###" in out and "torch" in out


class TestCustomLogger:
    """tests/test_logging_system.py's flush semantics, on the port's logger."""

    def teardown_method(self):
        logging.getLogger("ptyrad_tpu_torch").handlers.clear()

    def test_buffered_flush_preserves_prefolder_logs(self, tmp_path):
        logger = CustomLogger(log_file="test_log.txt", prefix_jobid="7", prefix_date=False,
                              show_timestamp=False)
        vprint("before folder exists")
        out_dir = str(tmp_path / "run_output")
        assert logger.flush_to_dir(out_dir) == os.path.join(out_dir, "7_test_log.txt")
        vprint("after flush")
        logger.close()
        content = open(os.path.join(out_dir, "7_test_log.txt")).read()
        assert "before folder exists" in content and "after flush" in content

    def test_double_flush_no_replay_no_crosstalk(self, tmp_path):
        logger = CustomLogger(log_file="t.txt", prefix_date=False, show_timestamp=False)
        vprint("early line")
        d1, d2 = str(tmp_path / "trial1"), str(tmp_path / "trial2")
        logger.flush_to_dir(d1)
        vprint("trial1 line")
        logger.flush_to_dir(d2)
        vprint("trial2 line")
        logger.close()
        c1 = open(os.path.join(d1, "t.txt")).read()
        c2 = open(os.path.join(d2, "t.txt")).read()
        assert "early line" in c1 and "trial1 line" in c1
        assert "early line" not in c2
        assert "trial1 line" in c2 and "trial2 line" in c2
        assert "trial2 line" not in c1

    def test_vprint_respects_verbose_and_prints_after_close(self, tmp_path, capsys):
        vprint("visible", verbose=True)
        vprint("hidden", verbose=False)
        out = capsys.readouterr().out
        assert "visible" in out and "hidden" not in out
        logger = CustomLogger(log_file="t.txt", prefix_date=True, show_timestamp=True)
        vprint("a", "b", sep="-")
        path = logger.flush_to_dir(str(tmp_path))
        logger.close()
        assert os.path.basename(path).endswith("_t.txt") and " | a-b" in open(path).read()
        vprint("plain again")
        assert "plain again" in capsys.readouterr().out


def test_main_module_and_console_script_name_the_cli():
    """python -m ptyrad_tpu_torch and the pyproject script both reach
    cli.main."""
    text = (ROOT / "pyproject.toml").read_text()
    assert 'ptyrad-tpu-torch = "ptyrad_tpu_torch.cli:main"' in text
    src = (ROOT / "ptyrad_tpu_torch" / "__main__.py").read_text()
    assert "from ptyrad_tpu_torch.cli import main" in src
