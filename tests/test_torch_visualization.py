"""ptyrad_tpu_torch.visualization and the workflow's figures against
ptyrad_tpu's, on the CPU, on the same seeded models.

- forward_panels: the five panel arrays of the "forward" figure (probe
  intensity, object amplitude and phase patches weighted by omode_occu, the
  forward() pattern, the measured one) against the arrays the JAX package's
  plot_forward_pass draws, at rtol 1e-4 (atol 1e-6 of each panel's largest
  value: a pattern's dark pixels are float32 rounding).
- plot_summary with 'all' and with 'slice_thickness' writes the JAX
  package's file names for the same collate_str and iteration.
- run_reconstruction with selected_figs writes summary_grouping.png and the
  per-save PNGs the JAX package's run writes.
- A failed drawing only warns; a failed forward_panels raises; without
  matplotlib the figures are skipped with a warning.
"""

import os
import sys

import numpy as np
import pytest

import ptyrad_tpu.visualization as jviz
import ptyrad_tpu_torch.visualization as viz
from torch_port_helpers import (SOLVER_SEED, both_solvers, jax_params_numpy, recon_params_file,
                                small_dataset, small_params, toy_init)

CASES = ("shifted_probes", "shared_probe_two_modes")


def solvers(case):
    """(JAX solver, port solver) after 2 iterations of the small tBL run
    (shifted probes: probe_pos_shifts optimizable), or of a toy model with a
    shared probe and two object modes."""
    if case == "shifted_probes":
        params = small_params({"name": "Adam"}, niter=2,
                              update={"probe_pos_shifts": {"start_iter": 1, "lr": 1e-4}})
        init = small_dataset()
    else:
        params = small_params({"name": "Adam"}, niter=2,
                              update={"probe_pos_shifts": {"start_iter": None, "lr": 0}})
        init = toy_init(np.random.default_rng(3), n_scans=11, omode=2, nz=2, pmode=2)
    js, ts = both_solvers(params, init)
    js.run()
    ts.run()
    return js, ts


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    return request.param, solvers(request.param)


def jax_panels(js, idx):
    """The arrays the JAX package's plot_forward_pass draws (its jitted
    panel function, run by the call that draws them)."""
    import jax.numpy as jnp
    import matplotlib.pyplot as plt

    plt.close(jviz.plot_forward_pass(js.params, js.buffers, js.geom, idx))
    probe_int, dp, obja, objp, meas = (np.asarray(a) for a in jviz._FWD_PANEL_JIT(
        js.params, js.buffers, js.geom, jnp.asarray(idx)))
    if probe_int.shape[0] == 1:
        probe_int = np.broadcast_to(probe_int, (len(idx), *probe_int.shape[-2:]))
    return {"probe_int": probe_int, "obja": obja, "objp": objp, "model_dp": dp,
            "meas_dp": meas}


def test_forward_panels_match_jax(runs):
    """On the same model: the port's parameters are the JAX solver's after
    its 2 iterations."""
    from ptyrad_tpu_torch.models.state import params_from_numpy

    case, (js, ts) = runs
    assert ts.geom.shift_probes == (case == "shifted_probes")
    idx = np.asarray(ts.indices)[:2]
    same = params_from_numpy(jax_params_numpy(js.params), "cpu")
    ours = viz.forward_panels(same, ts.buffers, ts.geom, idx)
    ref = jax_panels(js, idx)
    assert set(ours) == set(ref)
    for k, want in ref.items():
        assert ours[k].shape == want.shape, k
        np.testing.assert_allclose(ours[k], want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    assert all(isinstance(v, np.ndarray) for v in ours.values())


@pytest.mark.parametrize("figs", [["all"], ["slice_thickness"], ["loss", "forward", "pos"]])
def test_plot_summary_writes_the_jax_file_names(runs, tmp_path, figs):
    _, (js, ts) = runs
    collate = "_error_0.12345_t0003_oplr_0.001"
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jviz.plot_summary(str(out_j), js.params, js.buffers, js.geom, js.history, 2, js.indices,
                      selected_figs=figs, init_variables=js.init_variables, collate_str=collate)
    saved = viz.plot_summary(str(out_t), ts.params, ts.buffers, ts.geom, ts.history, 2,
                             ts.indices, selected_figs=figs, init_variables=ts.init_variables,
                             collate_str=collate)
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j))
    assert len(names) == len(saved) > 0
    assert all(n.startswith("summary_") and n.endswith(f"{collate}_iter0002.png") for n in names)
    if figs == ["slice_thickness"]:
        assert names == [f"summary_dz{collate}_iter0002.png"]


def test_run_reconstruction_writes_the_jax_figures(tmp_path):
    """Two iterations saved every iteration with selected_figs [loss,
    forward, probe_r_amp, pos, group]: summary_grouping.png once and each
    figure at each save, the same PNG names as the JAX package's run."""
    from ptyrad_tpu.engine.workflow import run_reconstruction as jax_run
    from ptyrad_tpu_torch.engine.workflow import run_reconstruction
    from ptyrad_tpu.load import load_params as jax_load_params
    from ptyrad_tpu_torch.load import load_params

    figs = ["loss", "forward", "probe_r_amp", "pos", "group"]
    pngs = {}
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        path = recon_params_file(tmp_path / name, "p.json", SAVE_ITERS=1, selected_figs=figs,
                                 save_result=["objp"])
        if name == "jax":
            params = jax_load_params(str(path))
            meas_params = params["init_params"]["meas_params"]
            meas_params["path"] = str(meas_params["path"])  # its C reader takes a str
            np.random.seed(SOLVER_SEED)
            solver = jax_run(params, verbose=False)
        else:
            solver = run_reconstruction(load_params(str(path)), device="cpu", verbose=False,
                                        init_rng=np.random.RandomState(SOLVER_SEED))
        pngs[name] = sorted(f for f in os.listdir(solver.output_path) if f.endswith(".png"))
    assert pngs["torch"] == pngs["jax"]
    want = {"summary_grouping.png"} | {f"summary_{f}_iter{i:04d}.png"
                                       for f in figs[:-1] for i in (1, 2)}
    assert set(pngs["torch"]) == want


def test_a_failed_drawing_only_warns(runs, tmp_path, monkeypatch, capsys):
    _, (_, ts) = runs

    def broken(*a, **k):
        raise RuntimeError("drawing broke")

    monkeypatch.setattr(viz, "plot_loss_curves", broken)
    saved = viz.plot_summary(str(tmp_path), ts.params, ts.buffers, ts.geom, ts.history, 2,
                             ts.indices, selected_figs=["forward", "loss", "pos"])
    assert saved == ["forward"] or saved == []
    assert "WARNING: plot_summary failed at iter 2" in capsys.readouterr().out


def test_a_failed_forward_panels_raises(runs, tmp_path, monkeypatch):
    """The device work of the forward figure sits outside the guard: a
    kernel that fails there ends the run."""
    _, (_, ts) = runs

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(viz, "forward_panels", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        viz.plot_summary(str(tmp_path), ts.params, ts.buffers, ts.geom, ts.history, 2,
                         ts.indices, selected_figs=["loss", "forward"])


def test_without_matplotlib_the_panels_still_run(runs, tmp_path, monkeypatch, capsys):
    _, (_, ts) = runs
    calls = []
    panels = viz.forward_panels
    monkeypatch.setattr(viz, "forward_panels", lambda *a: calls.append(1) or panels(*a))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    saved = viz.plot_summary(str(tmp_path), ts.params, ts.buffers, ts.geom, ts.history, 2,
                             ts.indices, selected_figs=["loss", "forward"])
    assert saved == [] and calls == [1]
    assert "WARNING: plot_summary failed" in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_individual_plots():
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(42)
    panels = {"probe_int": rng.random((2, 8, 8)), "obja": rng.random((2, 3, 8, 8)),
              "objp": rng.random((2, 3, 8, 8)), "model_dp": rng.random((2, 8, 8)),
              "meas_dp": rng.random((2, 8, 8))}
    figs = [
        viz.plot_loss_curves([(i, 1.0 / (i + 1)) for i in range(20)]),
        viz.plot_scan_positions(rng.random((16, 2)) * 10, init_pos=rng.random((16, 2)) * 10),
        viz.plot_obj_tilts(rng.random((16, 2)) * 10, rng.standard_normal((16, 2))),
        viz.plot_affine_transformation(1.1, 0.05, 3.0, 1.0),
        viz.plot_pos_grouping(rng.random((32, 2)) * 10, [np.arange(8), np.arange(8, 16)]),
        viz.plot_sigmoid_mask(32, 0.5, 0.05, img=rng.random((32, 32)), show_circles=True),
        viz.plot_slice_thickness([(i, 2.0 + 0.01 * i) for i in range(12)]),
        viz.plot_obj_tilts_avg([(i, np.array([0.1 * i, -0.1 * i])) for i in range(4)]),
        viz.plot_probe_modes(rng.random((3, 8, 8)) * np.exp(1j * rng.random((3, 8, 8))),
                             "phase", "fourier"),
        viz.draw_forward_pass(panels, [4, 7]),
    ]
    for f in figs:
        assert f is not None
        plt.close(f)


def test_grouping_figure_failure_only_warns(tmp_path, capsys):
    assert not viz.save_grouping_figure(str(tmp_path / "missing" / "dir"), np.zeros((4, 2)),
                                        np.zeros((1, 4), np.int64), np.ones((1, 4)))
    assert "WARNING: grouping figure failed" in capsys.readouterr().out
    assert viz.save_grouping_figure(str(tmp_path), np.random.default_rng(0).random((8, 2)),
                                    np.arange(8).reshape(2, 4), np.ones((2, 4)))
    assert os.listdir(tmp_path) == ["summary_grouping.png"]

