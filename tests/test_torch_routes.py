"""The forward routes and the launch guard of ptyrad_tpu_torch, on the CPU.

- Every shape has a route on every device: the fused kernels (B4, every
  square N up to 128) and the chain kernels (B5/B6, powers of two up to
  512) at their shapes, else the plain torch.fft chain,
  the counterpart of the JAX package's XLA path (a meta model stands for a
  CUDA one: the route is chosen from the static shapes before any work).
- ``model_params.fwd_fused: false`` routes every shape to the plain chain
  and turns the loss-folded chain off, as in the JAX package; a 2-iteration
  solver run with it matches the JAX package's run with the same setting
  at rtol 1e-4, and so does one with fwd_remat, which checkpoints the
  plain chain's slice steps in both packages. No model_params key warns
  as TPU-only: fwd_remat reaches Geometry, matmul_dtype is the bfloat16
  policy.
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
                                     (512, "chain"), (96, "fused"), (120, "fused"),
                                     (124, "fused"), (192, "chain"), (640, "plain"),
                                     (100, "fused"), (127, "fused")])
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
    """At N that is not a power of two the CPU runs plain PyTorch on either
    route: the fused route (the rule takes every N up to 128) runs the
    fused chain's plain version, equal to the plain route's torch.fft
    chain (counted in forward.launches_plain) at rtol 1e-5."""
    init = toy_init(rng, npix=n, canvas=2 * n)
    idx = torch.arange(3)
    out = {}
    for fwd_fused in (True, False):
        params, buffers, geom = make_model(init, {"fwd_fused": fwd_fused}, device=CPU)
        before = forward.launches_plain
        dp, _ = forward(params, buffers, geom, idx)
        assert forward_route(params, geom, idx) == ("fused" if fwd_fused else "plain")
        assert forward.launches_plain - before == (0 if fwd_fused else 1)
        assert dp.shape == (3, n, n) and bool(torch.isfinite(dp).all())
        out[fwd_fused] = dp
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [130, 144])
def test_cpu_forward_at_mixed_n_above_128_is_the_chain_route(rng, n):
    """Above 128 at N that is not a power of two the chain rule applies (its
    mixed-radix build on the card): on the CPU its plain versions, equal to
    the plain route's torch.fft chain (fwd_fused: false, counted in
    forward.launches_plain) at rtol 1e-5."""
    init = toy_init(rng, npix=n, canvas=n + 8, nz=2, pmode=1, n_scans=2)
    idx = torch.arange(2)
    out = {}
    for fwd_fused in (True, False):
        params, buffers, geom = make_model(init, {"fwd_fused": fwd_fused}, device=CPU)
        before = forward.launches_plain
        dp, _ = forward(params, buffers, geom, idx)
        assert forward_route(params, geom, idx) == ("chain" if fwd_fused else "plain")
        assert forward.launches_plain - before == (0 if fwd_fused else 1)
        assert dp.shape == (2, n, n) and bool(torch.isfinite(dp).all())
        out[fwd_fused] = dp
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [520, 640])
def test_cpu_forward_beyond_the_kernels_is_the_plain_route(rng, n):
    """Above 512 no kernel rule applies: the plain route, counted in
    forward.launches_plain."""
    init = toy_init(rng, npix=n, canvas=n + 8, nz=2, pmode=1, n_scans=2)
    params, buffers, geom = make_model(init, None, device=CPU)
    idx = torch.arange(2)
    before = forward.launches_plain
    dp, _ = forward(params, buffers, geom, idx)
    assert forward_route(params, geom, idx) == "plain"
    assert forward.launches_plain - before == 1
    assert dp.shape == (2, n, n) and bool(torch.isfinite(dp).all())


def test_tpu_only_keys_warn_once(rng):
    """No key of the JAX package's model_params is TPU-only in the port, so
    none warns: fwd_remat reaches Geometry.fwd_remat (the plain route's
    checkpointed slice loop), and matmul_dtype is the bfloat16 compute
    policy's key: bfloat16 operands."""
    init = toy_init(rng)
    mp = {"fwd_remat": True, "matmul_dtype": "bfloat16"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, geom = make_model(init, mp, device=CPU)
        _, _, off = make_model(init, {"fwd_remat": False, "matmul_dtype": None}, device=CPU)
    assert not caught, [str(w.message) for w in caught]
    assert geom.fwd_remat and not off.fwd_remat
    assert geom.bf16_operands and geom.compute_dtype == "float32"
    assert not off.bf16_operands


def _plain_params(fwd_remat=False):
    update = {name: {"start_iter": 1, "lr": lr} for name, lr in
              (("obja", 5e-4), ("objp", 5e-4), ("probe", 1e-4))}
    return {
        "model_params": {"optimizer_params": {"name": "Adam"}, "update_params": update,
                         "fwd_fused": False, "fwd_remat": fwd_remat},
        "loss_params": {**LOSS_SINGLE, "loss_sparse": {"state": True, "weight": 0.1,
                                                        "ln_order": 1}},
        "constraint_params": {"obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 4}, "GROUP_MODE": "random",
                         "GROUP_MODE_SEED": 0},
    }


@pytest.mark.parametrize("fwd_remat", [False, True], ids=["stored", "remat"])
def test_fwd_fused_false_solver_matches_jax(rng, fwd_remat):
    """A 2-iteration run with fwd_fused: false through the plain chain, every
    step counted in forward.launches_plain, against the JAX package's run
    with the same setting (its XLA path), with and without fwd_remat (each
    slice step checkpointed in both packages): losses at rtol 1e-4."""
    init = toy_init(rng, n_scans=10)
    js = JaxSolver(_plain_params(fwd_remat), init_variables=copy.deepcopy(init), verbose=False)
    js.run()
    ts = PtyRADSolver(_plain_params(fwd_remat), init_variables=copy.deepcopy(init),
                      device="cpu", verbose=False)
    assert ts.geom.fwd_remat == fwd_remat
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


def test_mixed_twins_are_libraries_of_their_own(monkeypatch, tmp_path):
    """At N that is not a power of two, launch takes the float32 kernels
    from mixed_lib(N) and the _bf16 twins from mixed_lib(N, True): two
    libraries, a generated source and a path each. build() starts the main
    library, the float32 libraries of extra_n and the twins' of bf16_n, and
    no other, so a run that rounds no operand at N compiles no twin."""
    picked = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: picked.append((name, args)) or 0

    monkeypatch.setattr(_build, "mixed_lib",
                        lambda n, bf16=False: picked.append((n, bf16)) or Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=5))
    t = SimpleNamespace(device=torch.device("cuda", 0))
    _build.launch("ptyrad_loss_fwd", t, 1, n=127)
    _build.launch("ptyrad_loss_fwd", t, 2, n=127, bf16_operands=True)
    assert picked == [(127, False), ("ptyrad_loss_fwd", (1, 5)),
                      (127, True), ("ptyrad_loss_fwd_bf16", (2, 5))]
    for n, stem in ((127, "multislice_n127"), (254, "chain_n254")):
        assert list(_build._mixed_sources(n)) == [f"{stem}.cu", f"{stem}_bf16.cu"]
        assert list(_build._mixed_sources(n, (True,))) == [f"{stem}_bf16.cu"]
        assert _build._mixed_path(n).name != _build._mixed_path(n, True).name

    started = []

    class Job:
        def __init__(self, out, sources=_build.SOURCES, generated=None, nice=0):
            started.append((out.name.split("_")[1], tuple(generated or sources)))

        def compiled(self):
            return True

        def finish(self):
            return 0.0

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_Job", Job)
    monkeypatch.setattr(_build, "BUILD_SECONDS", None)
    monkeypatch.setattr(_build, "MIXED_BUILD_SECONDS", {})
    _build.build(extra_n=(120, 254), bf16_n=(120,))
    assert started == [("kernels", _build.SOURCES), ("fused", ("multislice_n120.cu",)),
                       ("chain", ("chain_n254.cu",)), ("fused", ("multislice_n120_bf16.cu",))]
    assert _build.MIXED_BUILD_SECONDS == {120: 0.0, 254: 0.0, "120_bf16": 0.0}
