"""Canvas sharding over ranks (ptyrad_tpu_torch.parallel.canvas): gloo ranks
on the CPU against the port's one-process replicated run.

The ranks run tests/torch_canvas_worker.py's cases, every case of a world
in one start of its ranks (a tcp://127.0.0.1 rendezvous on a free port).
The replicated reference runs the same problem in this process on the
batches the ranks draw together (parallel.global_batches): the loss of a
canvas-sharded batch is the replicated loss of the union of the ranks'
slots, with the padding slots at mask 0.

Tolerances are the JAX package's TestCanvasSharding's
(tests/test_engine.py:1063-2114): the loss at rtol 1e-5; the gradients of
obja and objp at atol 1e-5, of the probe at 1e-5 of its largest entry, of
the position shifts at 1e-7; a multi-iteration run's losses at rtol 2e-5
and its objp at atol 1e-4 (every other tensor and the optimizer state
likewise); under compute_dtype bfloat16, where float32 differences turn
into whole bfloat16 steps, its bf16 test's correlation above 0.99 and objp
within 2e-2; dz's gradient, a cancellation, at its tilt test's rtol
1e-2 (dz's Adam moments). The halo's patches equal the whole canvas's bit
for bit, the gathered adjoint within 1e-6; the ranks' replicated tensors and gathered
canvases bit for bit after every iteration; checkpoints across the modes
bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_canvas_worker import (NITER, VARIANTS, flat_state, replicated_grads,
                                 replicated_train, resume_case, save_run)
from torch_port_helpers import free_port, rank_env, spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 240
GRAD_ATOL = {"obja": 1e-5, "objp": 1e-5, "probe_pos_shifts": 1e-7}
PROBE_RTOL = 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-4
BF16_CORR, BF16_ATOL = 0.99, 2e-2
DZ_RTOL = 1e-2


def run_ranks(tmp: Path, world: int, cases: list, worker: str = "torch_canvas_worker.py"):
    """Start ``world`` ranks running ``cases`` ([name, args] pairs); returns
    outs[case][rank], each the dict the case wrote."""
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, str(TESTS / worker), str(r), str(world), str(port),
                           str(tmp), json.dumps(cases)], world, tmp, RANK_TIMEOUT_S,
                f"{world} ({worker})")
    return [[dict(np.load(tmp / f"case{i}_{r}.npz")) for r in range(world)]
            for i in range(len(cases))]


ROUTES = ("fused", "forward")
TRAIN_2 = tuple(VARIANTS)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every case of the 2-rank world, from one start of the ranks: the
    gradients of both routes, the halo, each training variant, the gated
    callback, the checkpoint written in canvas mode and the refusals."""
    tmp = tmp_path_factory.mktemp("canvas2")
    save_dir = tmp / "saved"
    cases = ([["grads", {"route": r}] for r in ROUTES] + [["halo", {}]]
             + [["train", {"name": n}] for n in TRAIN_2]
             + [["train", {"name": "adam", "gated": True}],
                ["save", {"save_dir": str(save_dir)}], ["refusals", {}]])
    outs = run_ranks(tmp, 2, cases)
    names = ([("grads", r) for r in ROUTES] + [("halo", None)]
             + [("train", n) for n in TRAIN_2] + [("gated", None), ("save", None),
                                                   ("refusals", None)])
    return dict(zip(names, outs))


@pytest.fixture(scope="module")
def replicated_file(tmp_path_factory):
    """model_iter0002.hdf5 of the replicated run (optimizer state in
    upstream's torch layout)."""
    save_dir = tmp_path_factory.mktemp("replicated_saved")
    return str(save_run(str(save_dir), None)["path"])


@pytest.fixture(scope="module")
def four(tmp_path_factory, two, replicated_file):
    """The 4-rank world: both routes' gradients, the halo, Adam training,
    and the resumes of the 2-rank canvas checkpoint and the replicated
    one."""
    tmp = tmp_path_factory.mktemp("canvas4")
    canvas_file = str(two[("save", None)][0]["path"])
    cases = ([["grads", {"route": r}] for r in ROUTES] + [["halo", {}]]
             + [["train", {"name": "adam"}], ["resume", {"load_state": canvas_file}],
                ["resume", {"load_state": replicated_file}]])
    outs = run_ranks(tmp, 4, cases)
    names = ([("grads", r) for r in ROUTES] + [("halo", None), ("train", "adam"),
                                              ("resume", "canvas"), ("resume", "replicated")])
    return dict(zip(names, outs))


def world_outs(two, four, world):
    return two if world == 2 else four


CASES = [(r, n) for n in (2, 4) for r in ROUTES]


@pytest.mark.parametrize("route,world", CASES, ids=[f"{r}-{n}" for r, n in CASES])
def test_canvas_loss_and_gradients_match_replicated(two, four, route, world):
    """Every position in one batch: the loss, its terms and every gradient
    (the canvases gathered whole) on each rank against the replicated
    loss of the same padded batch."""
    ref = replicated_grads(route, world)
    for r, out in enumerate(world_outs(two, four, world)[("grads", route)]):
        np.testing.assert_allclose(out["total"], ref["total"], rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["terms"], ref["terms"], rtol=1e-5, atol=1e-12)
        for name, atol in GRAD_ATOL.items():
            np.testing.assert_allclose(out[name], ref[name], rtol=0, atol=atol,
                                       err_msg=f"rank {r} of {world}: {name}")
        np.testing.assert_allclose(out["probe"], ref["probe"], rtol=0,
                                   atol=PROBE_RTOL * np.abs(ref["probe"]).max())
        assert out["pad_grad_max"] == 0.0, "a padding row took a gradient"


@pytest.mark.parametrize("world", [2, 4])
def test_rank_keeps_its_slab_and_reduces_the_replicated_tensors_only(two, four, world):
    """obja/objp are the rank's padded slab, the store its slab's rows (the
    whole store's rows of its positions), and the gradient all-reduce moves
    the probe's and the shifts' bytes alone."""
    outs = world_outs(two, four, world)[("grads", "fused")]
    from torch_canvas_worker import canvas_init

    meas = canvas_init()["measurements"]
    for r, out in enumerate(outs):
        cap = out["pos_index"].shape[0] // world
        rows = -(-80 // world)
        assert tuple(out["slab_shape"]) == (1, 2, rows, 70)
        assert tuple(out["store_shape"]) == (cap, 16, 16)
        np.testing.assert_array_equal(out["store_gid"], out["pos_index"][r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(out["store_meas"], meas[out["store_gid"]])
        probe_bytes, shift_bytes = 2 * 16 * 16 * 8, 143 * 2 * 4
        assert int(out["bytes"]) == probe_bytes + shift_bytes


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_and_its_adjoint_match_the_whole_canvas(two, four, world):
    """Patches from each rank's halo-extended slab at its rebased corners
    equal the whole canvas's patches bit for bit, those crossing into the
    next slab included; a padding slot (position 0, rebased to a negative
    row on every rank but the first) reads the extended slab's clamped top
    window; the adjoint through the exchange, gathered whole, equals the
    whole canvas's scatter of the same cotangents, and no padding row takes
    a gradient."""
    from ptyrad_tpu_torch.ops.patches import extract_patch_pair, gather_plain
    from torch_canvas_worker import NPIX, canvas_init, halo_cotangents

    init = canvas_init()
    obja = torch.tensor(np.abs(init["obj"]).astype(np.float32))
    objp = torch.tensor(np.angle(init["obj"]).astype(np.float32))
    a, p = obja.clone().requires_grad_(True), objp.clone().requires_grad_(True)
    crossed = negative = 0
    cot_total = []
    outs = world_outs(two, four, world)[("halo", None)]
    for r, out in enumerate(outs):
        real = out["mask"] > 0
        gid = out["gid"][real]
        pos = torch.as_tensor(init["crop_pos"][gid])
        wa = gather_plain(obja, pos, (NPIX, NPIX))
        wp = gather_plain(objp, pos, (NPIX, NPIX))
        np.testing.assert_array_equal(out["patches_a"][real], wa.numpy())
        np.testing.assert_array_equal(out["patches_p"][real], wp.numpy())
        rows = out["ext_a"].shape[-2] - NPIX
        crossed += int(((out["store_pos"][real, 0] + NPIX) > rows).sum())
        pad = ~real
        negative += int((out["store_pos"][pad, 0] < 0).sum())
        if pad.any():
            top = gather_plain(torch.as_tensor(out["ext_a"]),
                               torch.as_tensor(out["store_pos"][pad]), (NPIX, NPIX))
            np.testing.assert_array_equal(out["patches_a"][pad], top.numpy())
        cot_total.append((pos, halo_cotangents(obja.shape, gid)))
        assert out["pad_grad"].sum() == 0.0
    assert crossed > 0 and negative > 0, (crossed, negative)
    loss = 0
    for pos, cot in cot_total:
        pa, pp = extract_patch_pair(a, p, pos, (NPIX, NPIX))
        loss = loss + (pa * cot[0]).sum() + (pp * cot[1]).sum()
    loss.backward()
    for out in outs:
        np.testing.assert_allclose(out["grad_a"], a.grad.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["grad_p"], p.grad.numpy(), rtol=0, atol=1e-6)


def assert_trajectory(outs, ref, name):
    for r, out in enumerate(outs):
        if name == "bf16":
            d_ref = ref["param_objp"].ravel()
            d_out = out["param_objp"].ravel()
            assert np.corrcoef(d_ref, d_out)[0, 1] > BF16_CORR
            np.testing.assert_allclose(out["param_objp"], ref["param_objp"], rtol=0,
                                       atol=BF16_ATOL)
            assert np.all(np.isfinite(out["losses"]))
            continue
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=TRAIN_RTOL,
                                   err_msg=f"{name} rank {r}")
        for key in ref:
            if key.startswith("param_"):
                np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=TRAIN_ATOL,
                                           err_msg=f"{name} rank {r}: {key}")
        state = [k for k in ref if k.startswith("state_")]
        assert state and set(state) == {k for k in out if k.startswith("state_")}
        for key in state:
            assert out[key].shape == ref[key].shape, key
            if name == "tilt_dz" and "/exp_avg" in key and ref[key].ndim == 0:
                # dz's moments: its gradient is a cancellation (JAX's
                # test_tilts_and_dz_optimization_match_replicated, rtol 1e-2)
                np.testing.assert_allclose(out[key], ref[key], rtol=DZ_RTOL)
                continue
            scale = max(float(np.abs(ref[key]).max()), 1e-30)
            np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=TRAIN_RTOL * scale,
                                       err_msg=f"{name} rank {r}: {key}")


@pytest.mark.parametrize("name", TRAIN_2)
def test_two_ranks_follow_the_replicated_trajectory(two, name):
    """NITER iterations of each variant (Adam; two object modes through
    forward(); bfloat16; grad_accumulation 2; LBFGS; a global tilt with
    optimizable dz; per-position tilts; AdamW, whose decay moves the
    padding rows; Adafactor factored along either axis and unfactored;
    Muon), constraints included (obj_rblur needs the whole canvas), against
    the replicated run of the same batches: losses, every tensor, the
    optimizer state gathered whole; the ranks' replicated tensors and
    gathered canvases bit for bit after every iteration; the canvas-shaped
    state the rank keeps has the slab's rows."""
    outs = two[("train", name)]
    assert_trajectory(outs, replicated_train(name, 2), name)
    for out in outs:
        np.testing.assert_array_equal(out["digests"], outs[0]["digests"])
        assert len(out["digests"]) == 2 * NITER
        np.testing.assert_array_equal(out["seen"][:, 0], np.arange(1, NITER + 1))
        assert set(out["canvas_state_rows"].tolist()) <= {int(out["slab_rows"])}


def test_four_ranks_follow_the_replicated_trajectory(four):
    outs = four[("train", "adam")]
    assert_trajectory(outs, replicated_train("adam", 4), "adam")
    for out in outs:
        np.testing.assert_array_equal(out["digests"], outs[0]["digests"])
        assert set(out["canvas_state_rows"].tolist()) == {20}


def test_callback_fires_on_canvas_save_iters_only(two):
    """A callback with canvas_save_iters = 2 fires at iteration 2 alone,
    with whole canvases (80 rows); without the attribute it fires every
    iteration."""
    for out in two[("gated", None)]:
        np.testing.assert_array_equal(out["seen"], [[2, 80, 80]])
    for out in two[("train", "adam")]:
        np.testing.assert_array_equal(out["seen"][:, 1:], 80)


def saved_state(path) -> dict:
    from ptyrad_tpu_torch.load import load_hdf5

    return flat_state(load_hdf5(path, key="optim_state_dict"))


def assert_resumed(out: dict, saved: dict, what: str):
    keys = [k for k in saved if k.startswith("state/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(out[f"state_{k}"], saved[k], err_msg=f"{what}: {k}")
    assert np.all(np.isfinite(out["losses"]))


def test_canvas_checkpoint_resumes_the_replicated_path(two):
    """The 2-rank run's model_iter0002.hdf5 (saved through the callback, the
    state gathered whole: the replicated layout, canvases 80 rows) loads
    into a replicated solver bit for bit and trains on."""
    path = str(two[("save", None)][0]["path"])
    saved = saved_state(path)
    assert saved["state/0/exp_avg"].shape == (1, 2, 80, 70)
    assert_resumed(resume_case(path, None), saved, "canvas file, replicated")


def test_canvas_checkpoint_resumes_another_rank_count(four, two):
    path = str(two[("save", None)][0]["path"])
    for r, out in enumerate(four[("resume", "canvas")]):
        assert_resumed(out, saved_state(path), f"canvas file, rank {r} of 4")


def test_replicated_checkpoint_resumes_the_canvas_path(four, replicated_file):
    for r, out in enumerate(four[("resume", "replicated")]):
        assert_resumed(out, saved_state(replicated_file), f"replicated file, rank {r} of 4")


def test_canvas_lbfgs_refuses_a_load_state(two):
    for out in two[("refusals", None)]:
        assert "shard_canvas + LBFGS cannot resume" in str(out["lbfgs_load_state"])


def test_plan_rejects_too_many_ranks():
    from ptyrad_tpu_torch.parallel import plan_canvas_sharding

    pos = np.array([[0, 0], [40, 0]])
    with pytest.raises(ValueError,
                       match=r"patches would span >2 slabs; use fewer devices \(<= 5\)"):
        plan_canvas_sharding(pos, 80, 16, 6)
    assert plan_canvas_sharding(pos, 80, 16, 5).rows_local == 16


def test_batch_count_is_capped_at_the_busiest_slab(capsys):
    from ptyrad_tpu_torch.parallel import plan_canvas
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count
    from torch_canvas_worker import canvas_init

    init = canvas_init()
    plan = plan_canvas(init["crop_pos"], np.arange(143), 80, 16, 4)
    assert canvas_batch_count(plan, 143, 60) == 3
    assert canvas_batch_count(plan, 143, 1) == 44
    assert "caps the batch count at 44" in capsys.readouterr().out


def test_one_rank_warns_and_runs_replicated(capsys):
    """shard_canvas without ranks: the replicated path, with a warning."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from torch_canvas_worker import variant

    params, init = variant("adam")
    solver = PtyRADSolver(params, init_variables=init, device="cpu", verbose=True)
    solver.prepare()
    solver._build()
    assert solver._canvas is None and solver.train_epoch is not None
    assert "shard_canvas requires more than one rank" in capsys.readouterr().out


# -- from a params file: the workflow and the CLI ---------------------------------

def canvas_params_file(tmp: Path) -> Path:
    """A params .json through the Initializer: 12 x 12 scans of 16^2 noise
    patterns (a .npy) 5 px apart, whose 86-row canvas splits over 2 or 4
    ranks; shard_canvas on, 2 iterations saved each with the optimizer
    state."""
    from test_torch_initializer import solver_params

    side = 12
    meas_path = tmp / "m.npy"
    np.save(meas_path, np.random.default_rng(0).random((side * side, 16, 16))
            .astype(np.float32))
    d = solver_params(str(meas_path))
    d["init_params"].update(meas_Npix=16, pos_N_scans=side * side, pos_N_scan_slow=side,
                            pos_N_scan_fast=side, pos_scan_step_size=1.5, meas_flipT=None,
                            meas_calibration={"mode": "dx", "value": 0.3}, probe_defocus=0.0)
    d["constraint_params"]["ortho_pmode"] = {"freq": None}
    d["recon_params"].update(NITER=2, SAVE_ITERS=1, BATCH_SIZE={"size": 40}, shard_canvas=True,
                             output_dir=str(tmp / "out"), prefix_time=False, selected_figs=[],
                             save_result=["model", "objp", "optim_state"])
    path = tmp / "canvas.json"
    path.write_text(json.dumps(d))
    return path


def test_two_rank_workflow_writes_whole_canvases(tmp_path):
    """run_reconstruction on 2 ranks (tests/torch_dist_worker.py's workflow
    case; the ranks' Initializers draw other position jitter, rank 0's
    wins): one folder and log, a checkpoint per iteration whose objp and
    Adam moments have the whole canvas's 86 rows, the ranks equal; the
    losses those of the replicated run of the same batches within 2e-5."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, recon_loop
    from ptyrad_tpu_torch.load import load_hdf5, load_params
    from ptyrad_tpu_torch.parallel import global_batches, plan_canvas
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count
    from torch_port_helpers import SOLVER_SEED

    path = canvas_params_file(tmp_path)
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, str(TESTS / "torch_dist_worker.py"), "workflow",
                           str(r), "2", str(port), str(tmp_path),
                           json.dumps({"params_path": str(path)})],
                2, tmp_path, RANK_TIMEOUT_S, "the workflow")
    res = [dict(np.load(tmp_path / f"workflow_{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    assert str(res[0]["digest"]) == str(res[1]["digest"])
    (folder,) = os.listdir(tmp_path / "out")
    files = os.listdir(tmp_path / "out" / folder)
    assert {"model_iter0001.hdf5", "model_iter0002.hdf5", "canvas.json"} <= set(files), files
    log = [f for f in files if f.endswith("_log.txt")]
    assert len(log) == 1
    assert "Canvas sharding: 2 ranks over gloo" in (tmp_path / "out" / folder / log[0]).read_text()
    ckpt = tmp_path / "out" / folder / "model_iter0002.hdf5"
    assert load_hdf5(str(ckpt), key="optimizable_tensors")["objp"].shape == (1, 2, 86, 86)
    assert saved_state(str(ckpt))["state/0/exp_avg"].shape == (1, 2, 86, 86)

    params = load_params(str(path))
    params["recon_params"]["shard_canvas"] = False
    solver = PtyRADSolver(params, device="cpu", verbose=False,
                          init_rng=np.random.RandomState(SOLVER_SEED))
    solver.prepare()
    solver._build()
    plan = plan_canvas(solver.buffers.crop_pos.numpy(), solver.indices, 86, 16, 2)
    n_batches = canvas_batch_count(plan, len(solver.indices), 40, verbose=False)
    recon_loop(solver.train_epoch, solver.params,
               lambda niter: global_batches(plan, n_batches, niter), None, 2,
               solver.constraint_fn, solver.buffers, history=solver.history, verbose=False)
    np.testing.assert_allclose(res[0]["losses"], [v for _, v in solver.history.loss_iters],
                               rtol=TRAIN_RTOL)


def test_cli_n_devices_runs_the_canvas_path(tmp_path):
    """``python -m ptyrad_tpu_torch run --device cpu --n_devices 2`` on a
    params file with shard_canvas: exit 0, the canvas line and each
    iteration printed once (rank 0), one output folder."""
    path = canvas_params_file(tmp_path)
    out = subprocess.run([sys.executable, "-m", "ptyrad_tpu_torch", "run", "--params_path",
                          str(path), "--device", "cpu", "--n_devices", "2"],
                         cwd=ROOT, env=rank_env(), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Canvas sharding: 2 ranks over gloo") == 1
    iters = [line for line in out.stdout.splitlines() if "Total Loss" in line]
    assert len(iters) == 2 and all(np.isfinite(float(line.split("Total Loss: ")[1].split(",")[0]))
                                   for line in iters), out.stdout
    (folder,) = os.listdir(tmp_path / "out")
    assert "model_iter0002.hdf5" in os.listdir(tmp_path / "out" / folder)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["float32", "float16", "bfloat16"])
def test_state_gather_and_cut_keep_the_moment_dtype(dtype):
    """CanvasShard.gather_state and cut_state on a state whose moments are
    stored in ``dtype`` (optim's host arrays: a bfloat16 one as its bits):
    a slab-shaped moment gathered from two ranks' slabs and a whole one cut
    to a rank's padded rows keep their dtype and bits, the padding rows
    zero; other arrays pass as they are. A stand-in shard holds the two
    ranks' slabs."""
    from types import SimpleNamespace

    from ptyrad_tpu_torch.optim import _host
    from ptyrad_tpu_torch.parallel.canvas import CanvasShard, slab_rows

    rows, noy, nox = 3, 5, 4
    whole = torch.randn(1, 2, noy, nox).to(dtype)
    plan = SimpleNamespace(rows_local=rows)
    slabs = [slab_rows(whole, plan, r, 0.0) for r in range(2)]
    shard = SimpleNamespace(
        params=SimpleNamespace(obja=whole), slab_shape=(1, 2, rows, nox),
        whole_shape=(1, 2, noy, nox),
        gather=lambda t: torch.cat([s.view(t.dtype) for s in slabs], dim=-2)[..., :noy, :],
        own_rows=lambda w, value: slab_rows(w, plan, 1, value))
    shard._walk = lambda v, fn: CanvasShard._walk(shard, v, fn)
    count = np.int32(7)
    gathered = CanvasShard.gather_state(shard, {"mu": _host(slabs[1]), "count": count})
    assert gathered["count"] is count
    assert gathered["mu"].dtype == _host(whole).dtype
    assert gathered["mu"].tobytes() == _host(whole).tobytes()
    cut = CanvasShard.cut_state(shard, {"mu": _host(whole)})["mu"]
    assert cut.dtype == _host(whole).dtype and cut.tobytes() == _host(slabs[1]).tobytes()
    assert not _host(slabs[1])[..., noy - rows:, :].view(np.uint8).any()
