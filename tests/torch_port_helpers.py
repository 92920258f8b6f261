"""Shared inputs for the tests that hold ptyrad_tpu_torch against ptyrad_tpu.

Every input is made with numpy from a seed and handed to both packages, so
the two compute the same thing; results come back as numpy arrays.
"""

from __future__ import annotations

import os
import socket
import subprocess
from pathlib import Path

import numpy as np
import torch

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """The environment of a rank process: no launcher variables, one OpenMP
    thread, the repository on the path."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                                            "MASTER_PORT", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def spawn_ranks(argv_of, world: int, cwd, timeout: float, what: str) -> None:
    """Start ``world`` processes, rank r running argv_of(r) in cwd, wait for
    them (each killed once ``timeout`` seconds pass) and assert that each
    exited 0."""
    procs = [subprocess.Popen(argv_of(r), cwd=cwd, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"rank {r} of {what} exited {p.returncode}:\n{out[-4000:]}\n{err[-4000:]}"


def toy_init(rng, n_scans=12, npix=16, omode=1, nz=3, pmode=2, canvas=32):
    """A small init_variables dict (random probe, weak phase object)."""
    from ptyrad_tpu_torch.physics.propagator import near_field_evolution

    probe = (rng.standard_normal((pmode, npix, npix))
             + 1j * rng.standard_normal((pmode, npix, npix))).astype(np.complex64)
    probe /= np.sqrt((np.abs(probe) ** 2).sum())
    obj = (1.0 + 0.05 * rng.standard_normal((omode, nz, canvas, canvas))) * np.exp(
        1j * 0.1 * rng.standard_normal((omode, nz, canvas, canvas)))
    crop_pos = rng.integers(0, canvas - npix, size=(n_scans, 2)).astype(np.int32)
    lambd, dx, dz = 0.0417, 0.15, 2.0
    meas = np.abs(rng.standard_normal((n_scans, npix, npix))).astype(np.float32) * 1e-2
    occu = np.ones(omode, np.float32) / omode
    return {
        "obj": obj.astype(np.complex64),
        "probe": probe,
        "probe_pos_shifts": np.zeros((n_scans, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": dz,
        "H": near_field_evolution((npix, npix), dx, dz, lambd),
        "measurements": meas,
        "crop_pos": crop_pos,
        "omode_occu": occu,
        "dx": dx,
        "lambd": lambd,
        "N_scan_slow": n_scans,
        "N_scan_fast": 1,
    }


def jax_params_numpy(p) -> dict:
    """The JAX package's PtychoParams as numpy arrays (probe complex64)."""
    return {
        "obja": np.asarray(p.obja),
        "objp": np.asarray(p.objp),
        "probe": (np.asarray(p.probe.re) + 1j * np.asarray(p.probe.im)).astype(np.complex64),
        "probe_pos_shifts": np.asarray(p.probe_pos_shifts),
        "obj_tilts": np.asarray(p.obj_tilts),
        "slice_thickness": np.asarray(p.slice_thickness),
    }


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def cplx_np(c) -> np.ndarray:
    """A JAX Cplx pair as a complex numpy array."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def assert_grad_close(actual, expected, name, atol_scale=2e-5, rtol=1e-3):
    """Gradient agreement as tests/test_forward.py:356-372 states it: atol
    2e-5 of the largest reference entry (float32 transforms through two
    FFT implementations) and rtol 1e-3."""
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(actual), expected, atol=atol_scale * scale, rtol=rtol,
                               err_msg=f"gradient mismatch: {name}")


_PATTERNS = {}


def recon_params_file(tmp, name, init_over=None, optimizer_params=None, **recon_over):
    """A params .json in ``tmp`` for tests/test_torch_initializer.py's solver
    run (16 scans of 32² simulated through the port's forward() and stored
    as a flipped .raw, 2 probe modes, 2 slices, batch 4, the tBL yml's Adam
    rates) without ortho_pmode, with no figures, no time prefix, its
    output_dir ``tmp``/out, and the given init_params, optimizer_params and
    recon_params entries; returns its path."""
    import json

    from test_torch_initializer import simulated_patterns, solver_params, write_raw

    raw = tmp / "m.raw"
    if not raw.exists():
        if "meas" not in _PATTERNS:
            _PATTERNS["meas"] = simulated_patterns()
        write_raw(raw, np.ascontiguousarray(np.flip(_PATTERNS["meas"], axis=1)))
    d = solver_params(str(raw))
    d["constraint_params"]["ortho_pmode"] = {"freq": None}
    d["init_params"].update(init_over or {})
    if optimizer_params is not None:
        d["model_params"]["optimizer_params"] = optimizer_params
    d["recon_params"].update({"output_dir": str(tmp / "out"), "prefix_time": False,
                              "selected_figs": [], **recon_over})
    path = tmp / name
    path.write_text(json.dumps(d))
    return path


SOLVER_SEED = 5


def jax_solver(path):
    """The JAX package's solver of a params file, seeded like torch_solver's
    (its Initializer draws from NumPy's global state); validation leaves
    meas_params.path a pathlib.Path, which its C reader refuses. Returns
    (solver, params)."""
    from ptyrad_tpu.engine.solver import PtyRADSolver
    from ptyrad_tpu.load import load_params

    params = load_params(str(path))
    meas_params = params["init_params"]["meas_params"]
    if isinstance(meas_params, dict) and meas_params.get("path") is not None:
        meas_params["path"] = str(meas_params["path"])
    np.random.seed(SOLVER_SEED)
    return PtyRADSolver(params, verbose=False), params


def torch_solver(path):
    """The port's solver of a params file on the CPU."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.load import load_params

    return PtyRADSolver(load_params(str(path)), device="cpu", verbose=False,
                        init_rng=np.random.RandomState(SOLVER_SEED))


# The solver runs of the optimizer tests (tests/test_torch_optim.py,
# test_torch_optim_resume.py, test_torch_lbfgs.py): tests/test_torch_solver.py's
# small tBL run (16^2 patterns, 2 probe modes, 3 slices, 11 scans in batches
# of 4, 4 and 3) without ortho_pmode, whose eigh gauge parts the packages.
SMALL_LR = {"obja": 5.0e-4, "objp": 5.0e-4, "probe": 1.0e-4, "probe_pos_shifts": 1.0e-4}
SMALL_CONSTRAINTS = {
    "fix_probe_int": {"freq": 1},
    "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
    "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
    "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
}


def small_dataset():
    """init_variables of the small run: measurements simulated through the
    port's forward() from a weak phase object, then a flat object."""
    from ptyrad_tpu_torch.models import forward, make_model

    init = toy_init(np.random.default_rng(7), n_scans=11, npix=16, nz=3, pmode=2, canvas=32)
    params, buffers, geom = make_model(init, None, device=CPU)
    with torch.no_grad():
        dp, _ = forward(params, buffers, geom, torch.arange(11))
    init["measurements"] = np_(dp)
    init["obj"] = np.ones_like(init["obj"])
    return init


def small_params(optimizer_params, niter=3, grad_accumulation=1, lr_scale=1.0, update=None):
    """The small run's sections with the given optimizer (its lrs times
    lr_scale; update entries replace update_params' own)."""
    up = {name: {"start_iter": 1, "lr": lr * lr_scale} for name, lr in SMALL_LR.items()}
    up["probe_pos_shifts"]["start_iter"] = 3
    up["obj_tilts"] = {"start_iter": None, "lr": 0}
    up["slice_thickness"] = {"start_iter": None, "lr": 0}
    up.update(update or {})
    return {
        "model_params": {"optimizer_params": optimizer_params, "update_params": up},
        "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
                        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
        "constraint_params": dict(SMALL_CONSTRAINTS),
        "recon_params": {"NITER": niter, "GROUP_MODE": "random", "GROUP_MODE_SEED": 0,
                         "BATCH_SIZE": {"size": 3, "grad_accumulation": grad_accumulation}},
    }


def both_solvers(params, init):
    """(JAX solver, port solver on the CPU) of the same sections and
    init_variables, neither run yet."""
    import copy

    from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    return (JaxSolver(copy.deepcopy(params), init_variables=copy.deepcopy(init), verbose=False),
            PtyRADSolver(copy.deepcopy(params), init_variables=copy.deepcopy(init), device="cpu",
                         verbose=False))


def losses(solver) -> np.ndarray:
    return np.array([v for _, v in solver.history.loss_iters])
