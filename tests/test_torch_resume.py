"""Resume: the optimizer state in a checkpoint, read and written by
ptyrad_tpu_torch and ptyrad_tpu, on the CPU at a small size.

The run is tests/test_torch_initializer.py's solver test (16 scans of 32²
from a .raw, 2 probe modes, 2 slices, batch 4, the tBL yml's Adam rates),
without ortho_pmode, whose eigh gauge parts the two packages after the first
constraint pass. Cross-resume, both ways: one package trains 2 iterations
and writes model.hdf5 with its optimizer state, then both resume from that
file through the Initializer's PtyRAD sources and
``optimizer_params.load_state`` and train 2 more; the two resumed loss
trajectories agree at rtol 1e-4 (the solver tests' tolerance). The port's
own resume is exact: ``recon_loop(start_niter=3)`` after a reload gives the
uninterrupted run's iteration 3 at rtol 1e-6. Also: the group order when
update_params lists objp before obja, a structural mismatch raises, a
missing file or a moment of the wrong size warns and starts fresh, a
non-HDF5 load_state raises.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ptyrad_tpu.models.state import make_model as j_make_model
from ptyrad_tpu.optim import convert_torch_optim_state
from ptyrad_tpu.optim import create_optimizer as j_create_optimizer
from ptyrad_tpu.save import save_dict_to_hdf5 as j_save_dict_to_hdf5
from ptyrad_tpu.save import save_results as j_save_results
from ptyrad_tpu_torch import optim as O
from ptyrad_tpu_torch.load import load_ptyrad
from ptyrad_tpu_torch.models import make_model
from ptyrad_tpu_torch.save import make_save_dict, save_results
from torch_port_helpers import CPU, jax_solver, np_, recon_params_file, toy_init, torch_solver

SAVE = ["model", "optim_state"]


def losses(solver):
    return [v for _, v in solver.history.loss_iters]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    return tmp, recon_params_file(tmp, "fresh.json", NITER=2, save_result=SAVE)


@pytest.fixture(scope="module")
def jax_checkpoint(case):
    tmp, path = case
    solver, params = jax_solver(path)
    solver.run()
    j_save_results(str(tmp / "jax"), solver.params, solver.buffers, solver.geom, params,
                   solver.opt_state, solver.history, 2, solver.indices,
                   lr_dict=solver.lr_dict, start_dict=solver.start_dict)
    return str(tmp / "jax" / "model_iter0002.hdf5")


@pytest.fixture(scope="module")
def torch_checkpoint(case):
    tmp, path = case
    solver = torch_solver(path)
    solver.run()
    save_results(str(tmp / "torch"), solver.params, solver.buffers, solver.geom,
                 solver.params_dict, solver.optimizer, solver.history, 2, solver.indices,
                 lr_dict=solver.lr_dict, start_dict=solver.start_dict)
    return str(tmp / "torch" / "model_iter0002.hdf5"), solver


def resumed_params_file(tmp, ckpt, name):
    """The same run from a checkpoint: object, probe and positions from its
    PtyRAD sources, the optimizer state from optimizer_params.load_state."""
    return recon_params_file(
        tmp, name, NITER=2,
        init_over={"obj_source": "PtyRAD", "obj_params": ckpt, "probe_source": "PtyRAD",
                   "probe_params": ckpt, "pos_source": "PtyRAD", "pos_params": ckpt},
        optimizer_params={"name": "Adam", "load_state": ckpt})


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_resume(case, jax_checkpoint, torch_checkpoint, writer):
    """Both packages resume from one package's model.hdf5 (both ways) and
    train the same two iterations; the port's optimizer holds the
    checkpoint's 8 steps before its first."""
    tmp, _ = case
    ckpt = jax_checkpoint if writer == "jax" else torch_checkpoint[0]
    path = resumed_params_file(tmp, ckpt, f"from_{writer}.json")
    ours = torch_solver(path)
    ours.prepare()
    ours._build()
    steps = {g["name"]: float(ours.optimizer.state[g["params"][0]]["step"])
             for g in ours.optimizer.param_groups}
    assert steps == {"obja": 8.0, "objp": 8.0, "probe": 8.0, "probe_pos_shifts": 8.0}
    ours.run()
    theirs, _ = jax_solver(path)
    theirs.run()
    resumed = [losses(s) for s in (ours, theirs)]
    assert len(resumed[0]) == 2 and np.isfinite(resumed[0]).all()
    np.testing.assert_allclose(resumed[0], resumed[1], rtol=1e-4)
    fresh = losses(torch_checkpoint[1])
    assert resumed[0][0] < fresh[0]  # a resume, not a fresh start


@pytest.mark.parametrize("route", ["dict", "file"])
def test_resume_repeats_the_uninterrupted_iteration(case, torch_checkpoint, route):
    """make_save_dict's dict, or load_ptyrad's of model_iter0002.hdf5, into
    chip_smoke.resume_from, then recon_loop(start_niter=3): iteration 3 of
    the uninterrupted 3-iteration run at rtol 1e-6."""
    tmp, _ = case
    three = torch_solver(recon_params_file(tmp, "three.json", NITER=3, save_result=SAVE))
    three.run()
    path, two = torch_checkpoint
    np.testing.assert_allclose(losses(two), losses(three)[:2], rtol=1e-6)
    if route == "dict":
        ckpt = make_save_dict("", two.params, two.buffers, two.geom, two.params_dict,
                              two.optimizer, two.history, 2, two.indices)
    else:
        ckpt = load_ptyrad(path)
    resumed = chip_smoke.resume_from(ckpt, two.params_dict, two.init_variables, CPU)
    history = chip_smoke.resume_step(resumed, 3)
    np.testing.assert_allclose(history.loss_iters[-1][1], losses(three)[2], rtol=1e-6)
    np.testing.assert_allclose(chip_smoke.batch_totals(history),
                               chip_smoke.batch_totals(three.history), rtol=1e-6)


OBJP_FIRST = {"objp": {"start_iter": 1, "lr": 2e-3}, "obja": {"start_iter": 1, "lr": 5e-4},
              "probe": {"start_iter": 1, "lr": 1e-4}}


def test_objp_before_obja_round_trips():
    """update_params listing objp before obja: group i is the i-th listed
    tensor (upstream's layout), so the JAX package's reader puts each
    moment on its own tensor, and the port reads back what it wrote. The
    two object moments have one shape, so a swap would raise nothing."""
    iv = toy_init(np.random.default_rng(3))
    mp = {"update_params": OBJP_FIRST}
    params, buffers, geom = make_model(iv, mp, device=CPU)
    opt, _, _ = O.create_optimizer(None, OBJP_FIRST, params)
    assert [g["name"] for g in opt.param_groups] == ["objp", "obja", "probe"]
    for t in (params.obja, params.objp, params.probe):
        t.grad = torch.randn_like(t)
    opt.step()
    written = O.torch_optim_state(opt)

    keystr = convert_torch_optim_state(written, OBJP_FIRST)
    for name in ("obja", "objp"):
        np.testing.assert_array_equal(keystr[f".inner_states['{name}'].inner_state[0].mu.{name}"],
                                      np_(opt.state[getattr(params, name)]["exp_avg"]))
    mu = np_(opt.state[params.probe]["exp_avg"])
    np.testing.assert_array_equal(keystr[".inner_states['probe'].inner_state[0].mu.probe.im"],
                                  mu.imag)
    jp, _, _ = j_make_model(iv, mp)
    _, j_state, _, _ = j_create_optimizer(None, OBJP_FIRST, jp)  # the JAX reader's template
    from ptyrad_tpu.optim import _apply_keystr_dict

    restored = _apply_keystr_dict(j_state, keystr)
    np.testing.assert_array_equal(np.asarray(restored.inner_states["objp"].inner_state[0].nu.objp),
                                  np_(opt.state[params.objp]["exp_avg_sq"]))

    params2, _, _ = make_model(iv, mp, device=CPU)
    opt2, _, _ = O.create_optimizer(None, OBJP_FIRST, params2)
    O.load_opt_state_values(opt2, written)
    for name in ("obja", "objp", "probe"):
        a, b = opt.state[getattr(params, name)], opt2.state[getattr(params2, name)]
        assert b["step"].device.type == "cpu" and b["exp_avg"].dtype == a["exp_avg"].dtype
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)


@pytest.mark.parametrize("paths", ["as_written", "renamed"])
def test_keystr_layout_reads_back_into_the_port(paths):
    """The JAX package's own layout (make_save_dict's keystr dict) of a
    JAX optimizer state sets the port's moments to the same values, also
    when optax's wrapper names in the paths differ (another optax version;
    matched by their tokens as the JAX reader does)."""
    iv = toy_init(np.random.default_rng(4))
    up = {"obja": {"start_iter": 1, "lr": 1e-3}, "objp": {"start_iter": 1, "lr": 1e-3},
          "probe": {"start_iter": 1, "lr": 1e-4}}
    jp, _, _ = j_make_model(iv, {"update_params": up})
    _, j_state, _, _ = j_create_optimizer(None, up, jp)
    import jax

    rng = np.random.default_rng(0)
    j_state = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.standard_normal(x.shape), x.dtype) if x.ndim else x + 3, j_state)
    flat, _ = jax.tree_util.tree_flatten_with_path(j_state)
    values = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat if hasattr(v, "shape")}
    if paths == "renamed":
        values = {k.replace("inner_states", "states").replace(".inner_state[0]", "[0]"): v
                  for k, v in values.items()}
    params, _, _ = make_model(iv, {"update_params": up}, device=CPU)
    opt, _, _ = O.create_optimizer(None, up, params)
    O.load_opt_state_values(opt, values)
    probe_nu = j_state.inner_states["probe"].inner_state[0].nu.probe
    np.testing.assert_array_equal(np_(opt.state[params.probe]["exp_avg_sq"]),
                                  np.asarray(probe_nu.re) + 1j * np.asarray(probe_nu.im))
    assert float(opt.state[params.obja]["step"]) == 3.0


def test_structural_mismatch_raises(case, tmp_path):
    """A checkpoint of an optimizer with gradient accumulation (optax's
    MultiSteps wraps every path): no entry matches, so the solver raises
    instead of starting fresh."""
    iv = toy_init(np.random.default_rng(5))
    up = {"obja": {"start_iter": 1, "lr": 1e-3}, "objp": {"start_iter": 1, "lr": 1e-3}}
    jp, _, _ = j_make_model(iv, {"update_params": up})
    _, j_state, _, _ = j_create_optimizer(None, up, jp, grad_accumulation=2)
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(j_state)
    values = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat if hasattr(v, "shape")}
    params, _, _ = make_model(iv, {"update_params": up}, device=CPU)
    opt, _, _ = O.create_optimizer(None, up, params)
    with pytest.raises(O.OptStateMismatchError, match="no checkpoint entry matches"):
        O.load_opt_state_values(opt, values)

    ckpt = str(tmp_path / "multisteps.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": values}, ckpt)
    path = recon_params_file(tmp_path, "p.json", NITER=1,
                             optimizer_params={"name": "Adam", "load_state": ckpt})
    solver = torch_solver(path)
    solver.prepare()
    with pytest.raises(O.OptStateMismatchError):
        solver._build()


def test_missing_file_or_wrong_size_warns_and_starts_fresh(case, torch_checkpoint, tmp_path,
                                                           capsys):
    """An I/O-level failure (no such file) or a moment whose size differs
    warns and leaves the optimizer fresh, as the JAX solver does."""
    missing = str(tmp_path / "nothing.hdf5")
    path = recon_params_file(tmp_path, "p.json", NITER=1,
                             optimizer_params={"name": "Adam", "load_state": missing})
    solver = torch_solver(path)
    solver.prepare()
    solver._build()
    assert not solver.optimizer.state
    assert "WARNING: failed to restore optimizer state" in capsys.readouterr().out

    ckpt = load_ptyrad(torch_checkpoint[0])["optim_state_dict"]
    ckpt["state"]["3"]["exp_avg"] = ckpt["state"]["3"]["exp_avg"][..., :-1]
    bad = str(tmp_path / "bad.hdf5")
    j_save_dict_to_hdf5({"optim_state_dict": ckpt}, bad)
    path = recon_params_file(tmp_path, "q.json", NITER=1,
                             optimizer_params={"name": "Adam", "load_state": bad})
    solver = torch_solver(path)
    solver.prepare()
    solver._build()
    assert "WARNING: failed to restore optimizer state" in capsys.readouterr().out
    assert not solver.optimizer.state  # the last group failed: none is restored


def test_orbax_directory_is_refused(tmp_path):
    """load_state naming anything but a .hdf5/.h5 (the JAX package's orbax
    directory) raises, naming the format."""
    path = recon_params_file(tmp_path, "p.json", NITER=1,
                             optimizer_params={"name": "Adam",
                                               "load_state": str(tmp_path / "optim_state")})
    solver = torch_solver(path)
    solver.prepare()
    with pytest.raises(NotImplementedError, match="orbax"):
        solver._build()


def test_amsgrad_state_is_a_mismatch(capsys):
    """amsgrad is a torch-only config: optax.adam has none, so both packages
    drop it with a warning and the optimizer never keeps max_exp_avg_sq; a
    checkpoint with no entry for the optimizer's state is a mismatch."""
    iv = toy_init(np.random.default_rng(6))
    up = {"obja": {"start_iter": 1, "lr": 1e-3}}
    params, _, _ = make_model(iv, {"update_params": up}, device=CPU)
    opt, _, _ = O.create_optimizer({"name": "Adam", "configs": {"amsgrad": True}}, up, params)
    assert "does not support config 'amsgrad'" in capsys.readouterr().out
    assert not opt.param_groups[0]["amsgrad"]
    with pytest.raises(O.OptStateMismatchError, match="no checkpoint entry matches"):
        O.load_opt_state_values(opt, {"state": {}, "param_groups": []})


def test_callback_gets_the_live_optimizer(case):
    """A callback that declares ``optimizer`` gets the solver's optimizer,
    with the step count of the iterations so far."""
    _, path = case
    seen = []
    solver = torch_solver(path)
    solver.run(callback=lambda niter, p, h, optimizer=None: seen.append(
        (niter, optimizer is solver.optimizer,
         float(optimizer.state[p.obja]["step"]))))
    assert seen == [(1, True, 4.0), (2, True, 8.0)]
    plain = []
    torch_solver(path).run(callback=lambda niter, p, h: plain.append(niter))
    assert plain == [1, 2]
    assert solver.indices.tolist() == list(range(16))
