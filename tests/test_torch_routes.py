"""The forward routes and the launch guard of ptyrad_tpu_torch, on the CPU.

- Every shape has a route on every device: the fused kernels (B4) and the
  chain kernels (B5/B6) at their shapes, else the plain torch.fft chain,
  the counterpart of the JAX package's XLA path (a meta model stands for a
  CUDA one: the route is chosen from the static shapes before any work).
- ``model_params.fwd_fused: false`` routes every shape to the plain chain
  and turns the loss-folded chain off, as in the JAX package; a 2-iteration
  solver run with it matches the JAX package's run with the same setting
  at rtol 1e-4. The JAX package's TPU-only keys fwd_remat and matmul_dtype
  are accepted and warn once each.
- Every kernel launch goes through ``ops._build.launch``, which makes the
  operand's device current around the call. The wrappers reach it only
  with CUDA tensors, so here the guard itself is shown with a stand-in
  library, and the sources are shown to have no other way to a launcher;
  the card-only suite runs the wrappers.
"""

import copy
import re
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ptyrad_tpu.engine.solver import PtyRADSolver as JaxSolver
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu_torch.engine.solver import PtyRADSolver
from ptyrad_tpu_torch.models import forward, forward_route, fused_loss_terms, make_model
from ptyrad_tpu_torch.models import state as S
from ptyrad_tpu_torch.models.state import Geometry, PtychoParams
from ptyrad_tpu_torch.ops import _build
from torch_port_helpers import CPU, toy_init

LOSS_SINGLE = {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}}


def _meta_route(n, fwd_fused=True, pmode=2):
    meta = torch.empty((pmode, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    geom = Geometry(probe_shape=(n, n), obj_shape=(1, 2, 700, 700), n_scan_slow=3,
                    n_scan_fast=1, dx=0.1, lambd=0.02, fwd_fused=fwd_fused)
    return forward_route(params, geom, torch.arange(3, device="meta"))


@pytest.mark.parametrize("n,route", [(8, "fused"), (128, "fused"), (256, "chain"),
                                     (512, "chain"), (96, "plain"), (120, "plain"),
                                     (124, "plain"), (192, "plain"), (640, "plain")])
def test_every_shape_has_a_route_off_the_cpu(n, route):
    assert _meta_route(n) == route


@pytest.mark.parametrize("n", [8, 96, 256])
def test_fwd_fused_false_routes_plain_off_the_cpu(n):
    assert _meta_route(n, fwd_fused=False) == "plain"


def test_non_square_patches_route_plain():
    meta = torch.empty((2, 8, 8), device="meta")
    params = PtychoParams(meta, meta, meta, meta, meta, meta)
    geom = Geometry(probe_shape=(128, 96), obj_shape=(1, 2, 300, 300), n_scan_slow=3,
                    n_scan_fast=1, dx=0.1, lambd=0.02)
    assert forward_route(params, geom, torch.arange(3, device="meta")) == "plain"


@pytest.mark.parametrize("value,expected", [(None, True), (True, True), (False, False)])
def test_make_model_reads_fwd_fused(rng, value, expected):
    """As ptyrad_tpu/models/state.py:315-316: None (auto) and True are on."""
    init = toy_init(rng)
    mp = {} if value is None else {"fwd_fused": value}
    geom = make_model(init, mp, device=CPU)[2]
    assert geom.fwd_fused is expected
    assert j_make_model(init, mp)[2].fwd_fused is expected


@pytest.mark.parametrize("fwd_fused", [True, False])
def test_cpu_routes_and_fused_loss_terms(rng, fwd_fused):
    """On the CPU: N = 16 takes the fused route with fwd_fused on and the
    plain one (counted in forward.launches_plain) with it off;
    fused_loss_terms declines with it off."""
    init = toy_init(rng)
    params, buffers, geom = make_model(init, {"fwd_fused": fwd_fused}, device=CPU)
    idx = torch.arange(4)
    before = forward.launches_plain
    dp, _ = forward(params, buffers, geom, idx)
    assert forward_route(params, geom, idx) == ("fused" if fwd_fused else "plain")
    assert forward.launches_plain - before == (0 if fwd_fused else 1)
    assert dp.shape == (4, 16, 16) and bool(torch.isfinite(dp).all())
    out = fused_loss_terms(params, buffers, geom, idx, None, LOSS_SINGLE)
    assert (out is None) == (not fwd_fused)


@pytest.mark.parametrize("n", [12, 24])
def test_cpu_forward_at_any_n_is_the_plain_route(rng, n):
    init = toy_init(rng, npix=n, canvas=2 * n)
    params, buffers, geom = make_model(init, None, device=CPU)
    before = forward.launches_plain
    dp, _ = forward(params, buffers, geom, torch.arange(3))
    assert forward.launches_plain - before == 1
    assert dp.shape == (3, n, n) and bool(torch.isfinite(dp).all())


def test_tpu_only_keys_warn_once(rng, monkeypatch):
    monkeypatch.setattr(S, "_WARNED_TPU_ONLY", set())
    init = toy_init(rng)
    mp = {"fwd_remat": True, "matmul_dtype": "bfloat16"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make_model(init, mp, device=CPU)
        make_model(init, mp, device=CPU)
        make_model(init, {"fwd_remat": False, "matmul_dtype": None}, device=CPU)
    texts = [str(w.message) for w in caught if "does nothing" in str(w.message)]
    assert len(texts) == 2
    assert any("fwd_remat" in t for t in texts) and any("matmul_dtype" in t for t in texts)


def _plain_params():
    update = {name: {"start_iter": 1, "lr": lr} for name, lr in
              (("obja", 5e-4), ("objp", 5e-4), ("probe", 1e-4))}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update,
                         "fwd_fused": False},
        "loss_params": {**LOSS_SINGLE, "loss_sparse": {"state": True, "weight": 0.1,
                                                        "ln_order": 1}},
        "constraint_params": {"obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 4}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


def test_fwd_fused_false_solver_matches_jax(rng):
    """A 2-iteration run with fwd_fused: false through the plain chain, every
    step counted in forward.launches_plain, against the JAX package's run
    with the same setting (its XLA path): losses at rtol 1e-4."""
    init = toy_init(rng, n_scans=10)
    js = JaxSolver(_plain_params(), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(_plain_params(), init_variables=copy.deepcopy(init), device="cpu",
                      verbose=False)
    before = forward.launches_plain
    ts.run()
    assert forward.launches_plain - before == 2 * ts.batch_idx.shape[0]
    ours = [v for _, v in ts.history.loss_iters]
    ref = [v for _, v in js.history.loss_iters]
    assert len(ours) == len(ref) == 2
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_launch_makes_the_operand_device_current(monkeypatch):
    """_build.launch calls the launcher with the operand's device current:
    inside torch.cuda.device(index) when another device is current, directly
    when it already is. It hands the launcher the current stream of that
    device last (none with stream=False) and raises on an error code."""
    events = []
    current = {"index": 0}

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    class Stream:
        cuda_stream = 1234

    class Lib:
        def ptyrad_fake(self, *args):
            events.append(("launch", args))
            return 0

        def ptyrad_fails(self, *args):
            return 1

        def ptyrad_error_string(self, err):
            return b"cudaErrorInvalidValue"

    def current_stream(device=None):
        events.append(("stream", device))
        return Stream()

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "lib", lambda: Lib())
    t = SimpleNamespace(device=torch.device("cuda", 1))
    _build.launch("ptyrad_fake", t, 7, 8)
    assert events == [("enter", 1), ("stream", 1), ("launch", (7, 8, 1234)), ("exit", 1)]
    events.clear()
    current["index"] = 1
    _build.launch("ptyrad_fake", t, 7, 8)
    assert events == [("stream", 1), ("launch", (7, 8, 1234))]
    events.clear()
    _build.launch("ptyrad_fake", t, 9, stream=False)
    assert events == [("launch", (9,))]
    with pytest.raises(RuntimeError, match="ptyrad_fails: CUDA error 1"):
        _build.launch("ptyrad_fails", t)


def test_every_launcher_goes_through_the_guard():
    """The wrapper modules reach the library only through _build.launch: no
    other lib() call, one launch per kernel wrapper, and each launcher of
    _build.SIGNATURES (but the two plan queries) is named at one launch site."""
    ops = Path(_build.__file__).parent
    sites = {}
    for name in ("patches.py", "fused_multislice.py", "chain.py"):
        src = (ops / name).read_text()
        assert "lib()" not in src, f"{name} calls the library outside _build.launch"
        for launcher in re.findall(r'_build\.launch\(\s*"(\w+)"', src):
            sites[launcher] = sites.get(launcher, 0) + 1
    launchers = set(_build.SIGNATURES) - {"ptyrad_chain_plan", "ptyrad_fused_plan"}
    assert sites == {name: 1 for name in launchers}
