"""The CUDA kernels against their plain PyTorch versions on the card, over the
edge cases that chip_smoke.py's tBL and PSO shapes do not reach: small and
odd patch sizes, B1/B2 at 1024^2 windows (the plain route's shapes), one
slice, one mode, every probe layout, other loss powers, a masked sample,
the whole loss-folded path, the plain fused chain (B4) and forward()
through it with two object modes and detector blur, the fused pairs at N
that is not a power of two (6, 96, 100, 120: the mixed-radix pair; 11, 22,
110, 124, 127: the Bluestein line), the segmented chain (B5/B6) with `last`
/ `last_mega` both ways and the grad-off route, its mixed-radix build at N
in (128, 512] that is not a power of two (one N of each plan kind, and the
compiled plans against ops/chain_plan.py's), B5 with the far-field exit
(set_far_field) and the route through it, and short tBL-like, low-dose and
PSO-like solver runs, with optimizable slice thickness and tilts too, and
one from a params file and a .raw through the Initializer. Every kernel
test runs on a shared and a per-position H, each with and without its
gradient (need_dh): with it, the propagator cotangent dH of the backward
(B3b, B4b, B5b, B6b) is compared as well.

Marked ``cuda``: skipped without a GPU. On a machine with one (and no JAX,
which tests/conftest.py imports) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: the gather copies values and the scatter sums each canvas
element over its windows in batch order, as scatter_add_plain does on the
CPU: both exact (tolerance 0; the scatter against the CPU, since
index_add_ on the card sums with atomics), one or two canvases a launch,
and the scatter repeats bit for bit. B3 transforms with a different FFT
than torch.fft and sums in another order: 1e-4 relative for s1/s2 and
1e-4 of each cotangent's largest entry.
B4 is held the same way: dp at 1e-4 of its largest value, each cotangent at
1e-4 of its largest entry. B3a/B4a and B3b/B4b sum modes and samples in a
fixed order (the backwards through csrc/dt_reduce.cuh) and repeat bit for
bit.
B5/B6 sum over modes without atomics and repeat bit for bit; they are held
at 1e-4 of the largest entry of each output or cotangent. dH is summed in a
fixed order by every kernel (no atomics) and repeats bit for bit; it is held
at 1e-4 of its largest entry.
"""

import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module docstring)")
    from ptyrad_tpu_torch.device import pin_fp32

    pin_fp32()
    return torch.device("cuda")


@pytest.fixture()
def gen(dev):
    return torch.Generator(device=dev).manual_seed(1234)


@pytest.mark.parametrize("lead,hw,patch", [((6,), (520, 520), (128, 128)),
                                           ((1, 2), (40, 33), (16, 9)),
                                           ((3,), (16, 16), (16, 16))])
def test_gather_and_scatter(dev, gen, lead, hw, patch):
    from ptyrad_tpu_torch.ops import patches as P

    h, w = hw
    canvas = torch.randn((*lead, h, w), generator=gen, device=dev)
    pos = torch.randint(-3, max(h, w), (9, 2), generator=gen, device=dev, dtype=torch.int32)
    pos[1] = pos[0]
    out_k = P.gather_cuda(canvas, pos, patch)
    torch.testing.assert_close(out_k, P.gather_plain(canvas, pos, patch), rtol=0, atol=0)
    g = torch.randn(out_k.shape, generator=gen, device=dev)
    ref = P.scatter_add_plain(canvas.shape, g.cpu(), pos.cpu())
    out = P.scatter_add_cuda(canvas.shape, g, pos)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


# (lead, (H, W), patch, B): the PSO and tBL shapes, N = 96 and 120 with W no
# multiple of 4, a width of 9 or 33 (B1's scalar path), B = 1 with L = 1, and
# more windows than a B2 block holds at once (kChunk = 1024)
PAIR_CASES = [((1, 21), (436, 436), (256, 256), 32),
              ((1, 6), (520, 520), (128, 128), 32),
              ((1, 3), (200, 201), (96, 96), 7),
              ((2,), (150, 163), (120, 120), 5),
              ((1,), (37, 41), (9, 33), 1),
              ((2,), (300, 302), (64, 64), 2100)]


@pytest.mark.parametrize("lead,hw,patch,b", PAIR_CASES)
@pytest.mark.parametrize("frozen", [None, "obja", "objp"])
def test_patch_pair_matches_cpu(dev, gen, lead, hw, patch, b, frozen):
    """extract_patch_pair on the card against the CPU, patches and both
    canvas gradients at tolerance 0: one B1 launch forward, one B2 launch
    backward for the canvases that need a gradient (none for a frozen one)."""
    from ptyrad_tpu_torch.ops import patches as P

    h, w = hw
    canvases = [torch.rand((*lead, h, w), generator=gen, device=dev) for _ in range(2)]
    pos = torch.randint(-5, max(h, w), (b, 2), generator=gen, device=dev, dtype=torch.int32)
    pos[b // 2] = pos[0]
    weights = [torch.randn((b, *lead, *patch), generator=gen, device=dev) for _ in range(2)]

    def run(where):
        a, p = (c.to(where, copy=True).requires_grad_(name != frozen)
                for c, name in zip(canvases, ("obja", "objp")))
        oa, op = P.extract_patch_pair(a, p, pos.to(where), patch)
        ((oa * weights[0].to(where)).sum() + (op * weights[1].to(where)).sum()).backward()
        return [t.detach().cpu() if t is not None else None for t in (oa, op, a.grad, p.grad)]

    before = P.gather_cuda.launches, P.scatter_add_cuda.launches
    card = run(dev)
    assert (P.gather_cuda.launches - before[0], P.scatter_add_cuda.launches - before[1]) == (1, 1)
    for got, want in zip(card, run(torch.device("cpu"))):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_patch_pair_unused_output(dev, gen):
    """Only obja's patches reach the loss: objp's gradient is zero and obja's
    is the scatter of its cotangent alone, in one single-canvas launch."""
    from ptyrad_tpu_torch.ops import patches as P

    a, p = (torch.rand((1, 4, 90, 91), generator=gen, device=dev).requires_grad_(True)
            for _ in range(2))
    pos = torch.randint(0, 60, (6, 2), generator=gen, device=dev, dtype=torch.int32)
    oa, _ = P.extract_patch_pair(a, p, pos, (32, 32))
    wa = torch.randn(oa.shape, generator=gen, device=dev)
    (oa * wa).sum().backward()
    assert torch.equal(p.grad, torch.zeros_like(p))
    torch.testing.assert_close(a.grad.cpu(), P.scatter_add_plain(a.shape, wa.cpu(), pos.cpu()),
                               rtol=0, atol=0)


def test_scatter_repeats_bit_for_bit(dev, gen):
    """B2 at the PSO shapes, duplicate windows included, gives the same bits
    on every run, one canvas or two a launch."""
    from ptyrad_tpu_torch.ops import patches as P

    shape = (1, 21, 436, 436)
    pos = torch.randint(0, 181, (32, 2), generator=gen, device=dev, dtype=torch.int32)
    pos[5:9] = pos[4]
    g = [torch.randn((32, 1, 21, 256, 256), generator=gen, device=dev) for _ in range(2)]
    first = P.scatter_add_pair_cuda(shape, g[0], g[1], pos)
    for _ in range(3):
        again = P.scatter_add_pair_cuda(shape, g[0], g[1], pos)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert torch.equal(first[0], P.scatter_add_cuda(shape, g[0], pos))


def test_patch_pair_at_1024_windows(dev, gen):
    """B1 and B2 at the shapes of PSO padded on the fly to 1024^2 (the plain
    route's only kernels): 32 windows of 21 x 1024^2, 704 M floats a stack
    and byte offsets past 2^31, on a 21 x 1,721^2 canvas, clamped corners
    and a duplicate window among them. One canvas and two a launch (the
    pair: 64 windows through the gather's grid z-loop) against the plain
    versions at tolerance 0, the scatter against the CPU's index_add_."""
    from ptyrad_tpu_torch.ops import patches as P

    shape, patch, b = (1, 21, 1721, 1721), (1024, 1024), 32
    canvases = [torch.rand(shape, generator=gen, device=dev) for _ in range(2)]
    pos = torch.randint(-4, 1721 - 1024 + 8, (b, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[3] = pos[2]
    pair = P.gather_pair_cuda(canvases[0], canvases[1], pos, patch)
    for canvas, out in zip(canvases, pair):
        assert torch.equal(out, P.gather_plain(canvas, pos, patch))
    assert torch.equal(P.gather_cuda(canvases[1], pos, patch), pair[1])
    del pair, canvases
    g = [torch.randn((b, 1, 21, *patch), generator=gen, device=dev) for _ in range(2)]
    pair = P.scatter_add_pair_cuda(shape, g[0], g[1], pos)
    for grads, out in zip(g, pair):
        want = P.scatter_add_plain(shape, grads.cpu(), pos.cpu())
        torch.testing.assert_close(out.cpu(), want, rtol=0, atol=0)
    assert torch.equal(P.scatter_add_cuda(shape, g[0], pos), pair[0])


def _chain_inputs(dev, gen, b, pmode, nz, n, probe_layout):
    obja = 1.0 + 0.05 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    objp = 0.2 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    pb = 1 if probe_layout.startswith("shared") else b
    probe = torch.complex(torch.randn((pb, pmode, n, n), generator=gen, device=dev),
                          torch.randn((pb, pmode, n, n), generator=gen, device=dev)) / n
    h = torch.exp(1j * torch.rand((1, n, n), generator=gen, device=dev) * 6.0).to(torch.complex64)
    meas = torch.rand((b, n, n), generator=gen, device=dev) * 2.0 / (n * n)
    mask = torch.ones(b, device=dev)
    mask[-1] = 0.0
    return obja, objp, probe, h, meas, mask


# H cases of every kernel test: shared (1, N, N) or per position (B, N, N),
# and with "_dh" H wants a gradient, so the backward computes dH (need_dh)
H_CASES = ["shared", "each", "shared_dh", "each_dh"]


def _h_case(dev, gen, h, b, n, h_case):
    """(H, need_dh) of an H case; h is the shared H."""
    if h_case.startswith("each"):
        h = torch.exp(1j * torch.rand((b, n, n), generator=gen, device=dev) * 6.0).to(
            torch.complex64)
    return h, h_case.endswith("_dh")


def _grad(t):
    """t's gradient; zero where autograd gave none (an H that no propagation
    uses, with a single slice: the kernels return zero there)."""
    return t.grad if t.grad is not None else torch.zeros_like(t)


@pytest.mark.parametrize("b,pmode,nz,n", [(3, 2, 1, 16), (2, 1, 2, 2), (4, 3, 6, 64),
                                          (2, 6, 6, 128), (3, 8, 3, 4), (5, 8, 2, 8),
                                          (3, 8, 4, 32), (3, 2, 3, 6), (2, 4, 3, 96),
                                          (2, 3, 2, 100), (2, 4, 3, 120), (2, 2, 2, 127),
                                          (2, 3, 2, 124), (2, 2, 2, 110), (3, 2, 3, 11),
                                          (2, 3, 2, 22)])
@pytest.mark.parametrize("probe_layout", ["shared", "shared_kspace", "each", "each_kspace"])
@pytest.mark.parametrize("p", [0.5, 1.0, 0.3])
@pytest.mark.parametrize("h_case", H_CASES)
def test_loss_chain_kernels(dev, gen, b, pmode, nz, n, probe_layout, p, h_case):
    """B3a, then B3b through autograd, against loss_sums_plain; with "_dh"
    dH too, which repeats bit for bit (a fixed-order sum)."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    kspace = probe_layout.endswith("kspace")
    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, b, pmode, nz, n, probe_layout)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    eps = 1e-10
    bwd = M.loss_sums_bwd_cuda
    launches = M.loss_sums_fwd_cuda.launches, bwd.launches, bwd.launches_dh

    def run(fused):
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
        leaves.append(h.clone().requires_grad_(need_dh))
        if fused:
            s1, s2 = M.multislice_loss_sums_fused(*leaves, meas, mask, p, eps,
                                                  probe_kspace=kspace)
        else:
            s1, s2 = M.loss_sums_plain(*leaves, meas, mask, p, eps, kspace)
        (0.7 * s1).backward()
        return s1.detach(), s2, leaves

    s1k, s2k, leaves_k = run(True)
    s1p, s2p, leaves_p = run(False)
    torch.testing.assert_close(s1k, s1p, rtol=1e-4, atol=0)
    torch.testing.assert_close(s2k, s2p, rtol=1e-4, atol=0)
    assert (M.loss_sums_fwd_cuda.launches, bwd.launches, bwd.launches_dh) == (
        launches[0] + 1, launches[1] + 1, launches[2] + need_dh)
    names = ("obja", "objp", "probe", "h")[:3 + need_dh]
    for name, a, r in zip(names, leaves_k, leaves_p):
        scale = float(_grad(r).abs().max())
        torch.testing.assert_close(a.grad, _grad(r), rtol=0, atol=1e-4 * scale,
                                   msg=lambda m, name=name: f"d {name}: {m}")
    assert float(leaves_k[0].grad[-1].abs().max()) == 0.0  # the masked sample
    if need_dh:
        assert leaves_k[3].grad.shape == h.shape
        torch.testing.assert_close(run(True)[2][3].grad, leaves_k[3].grad, rtol=0, atol=0)


def test_loss_forward_repeats_bit_for_bit(dev, gen):
    """B3a sums modes and samples in a fixed order, without atomics: s1, s2
    and dp repeat bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, 5, 6, 6, 128, "each_kspace")
    first = M.loss_sums_fwd_cuda(obja, objp, probe, h, meas, mask, 0.5, 1e-10, True)
    again = M.loss_sums_fwd_cuda(obja, objp, probe, h, meas, mask, 0.5, 1e-10, True)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("probe_layout", ["shared", "each_kspace"])
def test_backwards_repeat_bit_for_bit(dev, gen, probe_layout):
    """B3b and B4b sum each mode's dT and a shared probe's samples in a
    fixed order, without atomics: every cotangent repeats bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, 5, 6, 6, 128, probe_layout)
    kspace = probe_layout.endswith("kspace")
    _, _, dp = M.loss_sums_fwd_cuda(obja, objp, probe, h, meas, mask, 0.5, 1e-10, kspace)
    c = torch.tensor(0.7, device=dev)
    g = torch.randn(dp.shape, generator=gen, device=dev)
    runs = [lambda: M.loss_sums_bwd_cuda(obja, objp, probe, h, meas, mask, dp, c, 0.5, 1e-10,
                                         kspace)[:3],
            lambda: M.dp_bwd_cuda(obja, objp, probe, h, g, kspace)[:3]]
    for run in runs:
        for a, b in zip(run(), run()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_kernel_plans_match_fused_plan(dev):
    """The plan multislice.cu compiled for every N (ptyrad_fused_plan) is the
    one tests/test_torch_fused_plan.py's fused_plan describes and emulates on
    the CPU."""
    import ctypes

    from test_torch_fused_plan import fused_plan

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops import fused_plan as FP

    ns = [1 << logn for logn in range(1, 8)] + [6, 96, 100, 120, 127, 124, 110, 11, 22]
    _build.build(extra_n=ns[7:])  # the libraries of every N at once
    for n in ns:
        M.prepare(dev, n)  # the explicit warm-up (and, not a power of two, the build)
        out = (ctypes.c_int * 19)()
        lib = _build.lib() if n & (n - 1) == 0 else _build.mixed_lib(n)
        _build.check(lib.ptyrad_fused_plan(n, out), "ptyrad_fused_plan")
        plan = fused_plan(n)
        assert list(out)[:14] == [plan.n, plan.elems, plan.line_threads, plan.line,
                                  plan.pad_shift, plan.threads, plan.row_sweeps, plan.col_sweeps,
                                  plan.bwd_threads, plan.bwd_row_sweeps, plan.bwd_col_sweeps,
                                  plan.group_threads, plan.smem, plan.chunks]
        if n & (n - 1):
            assert tuple(out) == FP.reported(n)


def test_unsupported_cases_raise(dev, gen):
    """N beyond 128 raises instead of falling back."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    _, _, probe, h, meas, mask = _chain_inputs(dev, gen, 2, 2, 2, 16, "each")
    big = torch.ones((2, 1, 1, 256, 256), device=dev)
    with pytest.raises(ValueError, match="2 <= N <= 128"):
        M.multislice_loss_sums_fused(big, big, probe, h, meas, mask, 0.5, 1e-10)


def _small_init(seed=3, n_scans=20, npix=32, pmode=3, nz=3, canvas=64):
    from ptyrad_tpu_torch.physics.propagator import near_field_evolution

    rng = np.random.default_rng(seed)
    probe = (rng.standard_normal((pmode, npix, npix))
             + 1j * rng.standard_normal((pmode, npix, npix))).astype(np.complex64)
    probe /= np.sqrt((np.abs(probe) ** 2).sum())
    return {
        "obj": np.exp(1j * 0.1 * rng.standard_normal((1, nz, canvas, canvas))).astype(np.complex64),
        "probe": probe,
        "probe_pos_shifts": (0.3 * rng.standard_normal((n_scans, 2))).astype(np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": 2.0,
        "H": near_field_evolution((npix, npix), 0.15, 2.0, 0.0417),
        "measurements": np.abs(rng.standard_normal((n_scans, npix, npix))).astype(np.float32) * 1e-3,
        "crop_pos": rng.integers(0, canvas - npix, size=(n_scans, 2)).astype(np.int32),
        "omode_occu": np.array([0.9], np.float32),
        "dx": 0.15, "lambd": 0.0417, "N_scan_slow": n_scans, "N_scan_fast": 1,
    }


SOLVER_PARAMS = {
    "model_params": {"update_params": {
        "obja": {"lr": 5e-4}, "objp": {"lr": 5e-4}, "probe": {"lr": 1e-4},
        "probe_pos_shifts": {"lr": 1e-4, "start_iter": 2}}},
    "loss_params": {"loss_single": {"state": True, "dp_pow": 0.5},
                    "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
    "constraint_params": {"fix_probe_int": {"freq": 1}, "obja_thresh": {"freq": 1},
                          "objp_postiv": {"freq": 1}},
    "recon_params": {"NITER": 3, "BATCH_SIZE": {"size": 6}, "GROUP_MODE_SEED": 0},
}


def test_fused_loss_terms_cuda_matches_cpu(dev):
    """The whole loss-folded path (B1, B3a, then B3b and B2 through
    autograd) against the same path on the CPU."""
    from ptyrad_tpu_torch.models import fused_loss_terms, make_model
    from ptyrad_tpu_torch.optim import create_optimizer

    init = _small_init()
    mp = SOLVER_PARAMS["model_params"]
    grads = {}
    for d in ("cpu", dev):
        params, buffers, geom = make_model(init, mp, device=d)
        create_optimizer(None, mp["update_params"], params)
        idx = torch.arange(8, device=d)
        mask = torch.ones(8, device=d)
        mask[7] = 0.0
        total, _ = fused_loss_terms(params, buffers, geom, idx, mask,
                                    SOLVER_PARAMS["loss_params"])
        total.backward()
        grads[str(d)] = (float(total.detach()), {n: t.grad.cpu() for n, t in params.named()
                                        if t.grad is not None})
    (t_cpu, g_cpu), (t_gpu, g_gpu) = grads["cpu"], grads[str(dev)]
    np.testing.assert_allclose(t_gpu, t_cpu, rtol=1e-4)
    assert set(g_cpu) == set(g_gpu) == {"obja", "objp", "probe", "probe_pos_shifts"}
    for name in g_cpu:
        scale = float(g_cpu[name].abs().max())
        torch.testing.assert_close(g_gpu[name], g_cpu[name], rtol=1e-3, atol=1e-4 * scale)


def test_solver_cuda_matches_cpu(dev):
    """Three iterations on the card against the CPU: losses at rtol 1e-4,
    the same padded batch plan, and forward() of a batch on CUDA (B4a)
    against the CPU's on the same parameters at 1e-4 of the largest value."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.models import forward, params_from_numpy

    runs = {}
    for d in ("cpu", None):  # None: the default device, CUDA
        s = PtyRADSolver(SOLVER_PARAMS, init_variables=_small_init(), device=d, verbose=False)
        s.run()
        runs[d] = s
    cpu, gpu = runs["cpu"], runs[None]
    assert gpu.device.type == "cuda"
    np.testing.assert_array_equal(gpu.batch_idx, cpu.batch_idx)
    np.testing.assert_allclose([v for _, v in gpu.history.loss_iters],
                               [v for _, v in cpu.history.loss_iters], rtol=1e-4)
    with torch.no_grad():
        dp_gpu, _ = forward(gpu.params, gpu.buffers, gpu.geom, torch.arange(4, device=gpu.device))
        same = params_from_numpy({n: t.detach().cpu().numpy() for n, t in gpu.params.named()},
                                 device="cpu")
        dp_cpu, _ = forward(same, cpu.buffers, cpu.geom, torch.arange(4))
    _assert_rel(dp_gpu.cpu(), dp_cpu, "forward() dp")


# -- B4: the plain fused chain ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 6, 96, 120, 127, 124, 11])
@pytest.mark.parametrize("pmode", [1, 6, 8])
@pytest.mark.parametrize("nz", [1, 6])
@pytest.mark.parametrize("probe_layout", ["shared", "shared_kspace", "each", "each_kspace"])
@pytest.mark.parametrize("h_case", H_CASES)
def test_dp_chain_kernels(dev, gen, n, pmode, nz, probe_layout, h_case):
    """multislice_dp_fused (B4a, then B4b through autograd) against
    multislice_dp_plain on the same CUDA tensors; with "_dh" dH too, which
    repeats bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    b = 3
    kspace = probe_layout.endswith("kspace")
    obja, objp, probe, h, _, _ = _chain_inputs(dev, gen, b, pmode, nz, n, probe_layout)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    g = torch.randn((b, n, n), generator=gen, device=dev)
    bwd = M.dp_bwd_cuda
    launches = M.dp_fwd_cuda.launches, bwd.launches, bwd.launches_dh

    def run(fused):
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
        leaves.append(h.clone().requires_grad_(need_dh))
        dp = (M.multislice_dp_fused(*leaves, probe_kspace=kspace) if fused
              else M.multislice_dp_plain(*leaves, kspace))
        dp.backward(g)
        return dp.detach(), leaves

    dp_k, leaves_k = run(True)
    dp_p, leaves_p = run(False)
    _assert_rel(dp_k, dp_p, "B4a dp")
    assert (M.dp_fwd_cuda.launches, bwd.launches, bwd.launches_dh) == (
        launches[0] + 1, launches[1] + 1, launches[2] + need_dh)
    for name, a, r in zip(("obja", "objp", "probe", "h")[:3 + need_dh], leaves_k, leaves_p):
        _assert_rel(a.grad, _grad(r), f"B4b d {name}")
    if need_dh:
        assert leaves_k[3].grad.shape == h.shape
        torch.testing.assert_close(run(True)[1][3].grad, leaves_k[3].grad, rtol=0, atol=0)


def test_dp_chain_unsupported_cases_raise(dev, gen):
    """N beyond 128 raises: multislice_dp_fused does not fall back."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    _, _, probe, h, _, _ = _chain_inputs(dev, gen, 2, 2, 2, 16, "each")
    big = torch.ones((2, 1, 1, 256, 256), device=dev)
    with pytest.raises(ValueError, match="2 <= N <= 128"):
        M.multislice_dp_fused(big, big, probe, h)


def test_forward_cuda_omode2_blur_matches_cpu(dev):
    """forward() with two object modes, shifted probes and detector blur:
    B4a per object mode and B4b under autograd on the card, against the
    same forward() on the CPU (the plain version); values and gradients."""
    from ptyrad_tpu_torch.models import forward, forward_route, make_model

    init = _small_init()
    rng = np.random.default_rng(8)
    init["obj"] = np.exp(1j * 0.1 * rng.standard_normal((2, *init["obj"].shape[1:]))
                         ).astype(np.complex64)
    init["omode_occu"] = np.array([0.7, 0.3], np.float32)
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}, "detector_blur_std": 0.7}
    w = torch.from_numpy(rng.random((6, 32, 32)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        params, buffers, geom = make_model(init, mp, device=d)
        for _, t in params.named():
            t.requires_grad_(True)
        idx = torch.arange(6, device=d)
        assert forward_route(params, geom, idx) == "fused"
        dp, _ = forward(params, buffers, geom, idx)
        (w.to(d) * dp).sum().backward()
        out[str(d)] = (dp.detach().cpu(), {n: t.grad.cpu() for n, t in params.named()
                                           if t.grad is not None})
    (dp_cpu, g_cpu), (dp_gpu, g_gpu) = out["cpu"], out[str(dev)]
    _assert_rel(dp_gpu, dp_cpu, "dp")
    assert set(g_cpu) == set(g_gpu) == {"obja", "objp", "probe", "probe_pos_shifts"}
    for name in g_cpu:
        _assert_rel(g_gpu[name], g_cpu[name], f"d {name}")


@pytest.mark.parametrize("npix,fwd_fused", [(96, True), (120, True), (32, False), (96, False),
                                            (192, True)])
def test_forward_plain_route_cuda_matches_cpu(dev, npix, fwd_fused):
    """forward() where the fused kernels take N = 96 and 120 (their
    mixed-radix pair, B4a/B4b), where the chain takes N = 192 (its
    mixed-radix build, B5/B6) or with fwd_fused off (the plain torch.fft
    chain on the card, counted in forward.launches_plain); the patches
    through B1/B2; against the CPU, values and gradients at 1e-4 of the
    largest entry."""
    from ptyrad_tpu_torch.models import forward, forward_route, make_model
    from ptyrad_tpu_torch.ops import patches as P

    init = _small_init(npix=npix, canvas=npix + 32)
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}, "fwd_fused": fwd_fused}
    w = torch.from_numpy(np.random.default_rng(9).random((6, npix, npix)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        params, buffers, geom = make_model(init, mp, device=d)
        for _, t in params.named():
            t.requires_grad_(True)
        idx = torch.arange(6, device=d)
        route = ("fused" if npix <= 128 else "chain") if fwd_fused else "plain"
        assert forward_route(params, geom, idx) == route
        before = forward.launches_plain, P.gather_cuda.launches, P.scatter_add_cuda.launches
        dp, _ = forward(params, buffers, geom, idx)
        (w.to(d) * dp).sum().backward()
        after = forward.launches_plain, P.gather_cuda.launches, P.scatter_add_cuda.launches
        assert after[0] - before[0] == (route == "plain")
        assert (after[1] > before[1] and after[2] > before[2]) == (d != "cpu")
        out[str(d)] = (dp.detach().cpu(), {n: t.grad.cpu() for n, t in params.named()
                                           if t.grad is not None})
    (dp_cpu, g_cpu), (dp_gpu, g_gpu) = out["cpu"], out[str(dev)]
    _assert_rel(dp_gpu, dp_cpu, "dp")
    assert set(g_cpu) == set(g_gpu) == {"obja", "objp", "probe", "probe_pos_shifts"}
    for name in g_cpu:
        _assert_rel(g_gpu[name], g_cpu[name], f"d {name}")


LOW_DOSE_PARAMS = {
    **SOLVER_PARAMS,
    "loss_params": {"loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
                    "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
                    "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1}},
}


def test_low_dose_solver_cuda_matches_cpu(dev):
    """Three iterations with the low-dose loss mix (forward() + combined_loss:
    B1, B4a, then B4b and B2 through autograd) on the card against the CPU:
    losses at rtol 1e-4, B4 launched once per step each and B3 not."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.ops import fused_multislice as M

    counters = (M.loss_sums_fwd_cuda, M.loss_sums_bwd_cuda, M.dp_fwd_cuda, M.dp_bwd_cuda)
    for fn in counters:
        fn.launches = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=_small_init(), device=d, verbose=False)
        s.run()
        runs[d] = s
    np.testing.assert_allclose([v for _, v in runs[None].history.loss_iters],
                               [v for _, v in runs["cpu"].history.loss_iters], rtol=1e-4)
    steps = 3 * runs[None].batch_idx.shape[0]
    assert [fn.launches for fn in counters] == [0, 0, steps, steps]


# -- B5 and B6: the segmented chain ------------------------------------------
# Tolerance: 1e-4 of the largest entry of each output or cotangent, as for
# B3 (float32 chains through the kernels' register radix passes against
# torch.fft). d a and d phi are summed over modes in one thread in a fixed
# order.

def _seg_inputs(dev, gen, b, pmode, nz, n, h_b=1):
    psi = torch.complex(torch.randn((b, pmode, n, n), generator=gen, device=dev),
                        torch.randn((b, pmode, n, n), generator=gen, device=dev)) / n
    # a view into a (B, omode=2, nz + 1, N, N) patch tensor, as multislice_dp_chain passes
    base_a = 1.0 + 0.05 * torch.randn((b, 2, nz + 1, n, n), generator=gen, device=dev)
    base_p = 0.3 * torch.randn((b, 2, nz + 1, n, n), generator=gen, device=dev)
    a, p = base_a[:, 1, 1:], base_p[:, 1, 1:]
    h = torch.exp(1j * torch.rand((h_b, n, n), generator=gen, device=dev) * 6.0)
    return psi, a, p, h.to(torch.complex64)


def _assert_rel(actual, ref, what):
    actual, ref = actual.detach(), ref.detach()
    scale = float(ref.abs().max())
    err = float((actual - ref).abs().max())
    assert err <= 1e-4 * scale, f"{what}: max abs err {err} > 1e-4 x {scale}"


def _vjp_plain(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    # materialize_grads: an H that no propagation uses has a zero gradient
    return out.detach(), torch.autograd.grad(out, leaves, grad_outputs=g, materialize_grads=True)


def _chain_grads(out, h_case, plain, inputs, bwd):
    """The backward of a chain kernel against the plain chain's VJP: every
    cotangent, dH with "_dh" (then also bit for bit on a second launch, a
    fixed-order sum, and counted in launches_dh). plain takes (psi, a, phi,
    h); bwd(g, h, need_dh) launches the kernel."""
    psi, a, p, h = inputs
    need_dh = h_case.endswith("_dh")
    g = torch.randn_like(out)
    ref, g_p = _vjp_plain(plain if need_dh else lambda x, y, z: plain(x, y, z, h),
                          inputs if need_dh else inputs[:3], g)
    _assert_rel(out, ref, "exit")
    g_k = bwd(g, h, need_dh)
    assert (g_k[3] is not None) == need_dh
    for name, x, y in zip(("psi", "a", "phi", "h"), g_k, g_p):
        _assert_rel(x, y, f"d {name}")
    return g, g_k


@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("pmode", [1, 4])
@pytest.mark.parametrize("sg", [1, 4, 5])
@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("h_case", H_CASES)
def test_chain_segment_kernels(dev, gen, n, pmode, sg, last, h_case):
    """B5a, and B5b against the plain chain's VJP."""
    from ptyrad_tpu_torch.ops import chain as C

    b = 3
    psi, a, p, h = _seg_inputs(dev, gen, b, pmode, sg, n)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    out = C.segment_fwd_cuda(psi, a, p, h, last)
    launches = C.segment_bwd_cuda.launches_dh
    g, g_k = _chain_grads(
        out, h_case, lambda x, y, z, w: C.chain_segment_plain(x, y, z, w, last),
        (psi, a, p, h), lambda g, w, dh: C.segment_bwd_cuda(g, psi, a, p, w, last, need_dh=dh))
    assert C.segment_bwd_cuda.launches_dh == launches + need_dh
    if need_dh:
        assert g_k[3].shape == h.shape
        torch.testing.assert_close(C.segment_bwd_cuda(g, psi, a, p, h, last, need_dh=True)[3],
                                   g_k[3], rtol=0, atol=0)


@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("pmode", [1, 4])
@pytest.mark.parametrize("n_seg,sg", [(2, 8), (3, 1), (2, 2)])
@pytest.mark.parametrize("last_mega", [True, False])
@pytest.mark.parametrize("h_case", H_CASES)
def test_chain_stack_kernels(dev, gen, n, pmode, n_seg, sg, last_mega, h_case):
    """B6a and its stack, and B6b against the plain chain's VJP (with
    last_mega False, the exit's propagation is undone after the last
    segment's rebuild, which also gives its K); B6b repeats bit for bit."""
    from ptyrad_tpu_torch.ops import chain as C

    b = 2
    psi, a, p, h = _seg_inputs(dev, gen, b, pmode, n_seg * sg, n)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    out, stack = C.stack_fwd_cuda(psi, a, p, h, sg, last_mega)
    assert stack.shape == (b, n_seg, pmode, n, n)
    torch.testing.assert_close(stack[:, 0], psi, rtol=0, atol=0)
    if n_seg > 1:  # entry 1 is the state after the first segment, propagated
        _assert_rel(stack[:, 1], C.chain_segment_plain(psi, a[:, :sg], p[:, :sg], h, False),
                    "B6a stack entry 1")
    launches = C.stack_bwd_cuda.launches_dh

    def bwd(g, w, dh):
        return C.stack_bwd_cuda(g, stack, a, p, w, sg, last_mega, need_dh=dh)

    g, g_k = _chain_grads(
        out, h_case, lambda x, y, z, w: C.chain_stack_plain(x, y, z, w, sg, last_mega),
        (psi, a, p, h), bwd)
    assert C.stack_bwd_cuda.launches_dh == launches + need_dh
    d_again = bwd(g, h, need_dh)
    for x, y in zip(g_k[:3 + need_dh], d_again):
        torch.testing.assert_close(x, y, rtol=0, atol=0)  # no atomics: deterministic


@pytest.mark.parametrize("nz,n,pmode", [(1, 64, 4), (4, 64, 1), (21, 256, 4), (21, 64, 4)])
@pytest.mark.parametrize("need_dh", [False, True])
def test_multislice_dp_chain_cuda(dev, gen, nz, n, pmode, need_dh):
    """multislice_dp_chain against the plain multislice_dp on the same CUDA tensors,
    values and gradients (H's too with need_dh); sg = 4 divides nz = 4,
    sg = 8 leaves a tail at 21. The grad-off route (B5a only) gives the same
    dp as the grad route."""
    from ptyrad_tpu_torch.models import multislice_dp
    from ptyrad_tpu_torch.ops import chain as C

    b = 4
    obja = 1.0 + 0.05 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    objp = 0.3 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    probe = torch.complex(torch.randn((b, pmode, n, n), generator=gen, device=dev),
                          torch.randn((b, pmode, n, n), generator=gen, device=dev)) / n
    h = torch.exp(1j * torch.rand((1, n, n), generator=gen, device=dev) * 6.0).to(torch.complex64)
    occu = torch.ones(1, device=dev)
    counters = (C.segment_fwd_cuda, C.segment_bwd_cuda, C.stack_fwd_cuda, C.stack_bwd_cuda)
    for fn in counters:
        fn.launches = 0
    with torch.no_grad():
        dp_off = C.multislice_dp_chain(obja, objp, probe, h, occu, 1e-10)
    assert [fn.launches for fn in counters] == [len(range(0, nz, C.best_sg(nz))), 0, 0, 0]
    for fn in counters:
        fn.launches = 0
    leaves_k = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    leaves_p = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    h_k, h_p = h.clone().requires_grad_(need_dh), h.clone().requires_grad_(need_dh)
    dp_k = C.multislice_dp_chain(*leaves_k, h_k, occu, 1e-10)
    dp_p = multislice_dp(*leaves_p, h_p, occu, 1e-10)
    _assert_rel(dp_k, dp_p, "dp")
    torch.testing.assert_close(dp_off, dp_k.detach(), rtol=0, atol=0)
    w = torch.rand(dp_k.shape, generator=gen, device=dev)
    (w * dp_k).sum().backward()
    (w * dp_p).sum().backward()
    names = ("obja", "objp", "probe", "h")[:3 + need_dh]
    for name, x, y in zip(names, leaves_k + [h_k], leaves_p + [h_p]):
        _assert_rel(_grad(x), _grad(y), f"d {name}")
    if nz == 21:  # B6 over 16 slices, B5 over the 5-slice tail
        assert [fn.launches for fn in counters] == [1, 1, 1, 1]


def test_chain_kernel_plans_match_pass_plan(dev):
    """The plan chain.cu compiled for every N (ptyrad_chain_plan) is the one
    tests/test_torch_chain_plan.py's pass_plan describes and emulates on the
    CPU."""
    import ctypes

    from test_torch_chain_plan import pass_plan

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C

    for logn, pmode in ((logn, pmode) for logn in range(1, 10) for pmode in (1, 3, 4, 8)):
        C.prepare(dev, 1 << logn)  # the explicit warm-up, at every N
        out = (ctypes.c_int * 13)()
        _build.check(_build.lib().ptyrad_chain_plan(1 << logn, pmode, out), "ptyrad_chain_plan")
        plan = pass_plan(1 << logn, pmode)
        radices = tuple(r for r in out[4:7] if r)
        assert list(out[:4]) == [plan.n, plan.elems, plan.line_threads, len(plan.radices)]
        assert radices == plan.radices
        assert list(out[7:]) == [plan.rows, plan.cols, plan.row_threads, plan.col_threads,
                                 plan.row_smem, plan.col_smem]


@pytest.mark.parametrize("n", [32, 128, 512])
@pytest.mark.parametrize("pmode", [1, 8])
@pytest.mark.parametrize("h_case", H_CASES)
def test_chain_kernels_on_each_plan(dev, gen, n, pmode, h_case):
    """B5 and B6 at the sizes whose plans end in a short radix pass (N = 32:
    16 x 2, N = 128: 16 x 8, N = 512: 16 x 16 x 2), odd B, one and eight
    probe modes, a shared and a per-position H (h_b = B), with and without
    dH: each output and cotangent against the plain chain."""
    from ptyrad_tpu_torch.ops import chain as C

    b, sg = 3, 2
    psi, a, p, h = _seg_inputs(dev, gen, b, pmode, 2 * sg, n)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    out = C.segment_fwd_cuda(psi, a[:, :sg], p[:, :sg], h, False)
    _chain_grads(out, h_case, lambda x, y, z, w: C.chain_segment_plain(x, y, z, w, False),
                 (psi, a[:, :sg], p[:, :sg], h),
                 lambda g, w, dh: C.segment_bwd_cuda(g, psi, a[:, :sg], p[:, :sg], w, False,
                                                     need_dh=dh))
    out, stack = C.stack_fwd_cuda(psi, a, p, h, sg, True)
    _chain_grads(out, h_case, lambda x, y, z, w: C.chain_stack_plain(x, y, z, w, sg, True),
                 (psi, a, p, h),
                 lambda g, w, dh: C.stack_bwd_cuda(g, stack, a, p, w, sg, True, need_dh=dh))


# N of each kind of mixed plan (ops/chain_plan.py): two register passes
# (135, 192, 240), three (384), a Bluestein line over three register passes
# (136 = 8 x 17 over 280 points, 176 = 16 x 11 over 360, 254 = 2 x 127 over
# 512) and over two (385 = 5 x 7 x 11 over 784, 509, prime, over 1,024):
# every N with a prime above 7 takes it
MIXED_NS = [135, 136, 176, 192, 240, 254, 384, 385, 509]


def test_chain_mixed_plans_match_chain_plan(dev):
    """The plan each mixed library compiled (ptyrad_chain_plan) is
    ops/chain_plan.py's, which tests/test_torch_chain_mixed_plan.py
    emulates on the CPU."""
    import ctypes

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.chain_plan import chain_plan

    _build.build(extra_n=MIXED_NS)  # the libraries of every N at once
    for n in MIXED_NS:
        C.prepare(dev, n)  # N's library loaded and warmed up
        for pmode in (1, 3, 4, 8):
            out = (ctypes.c_int * 14)()
            _build.check(_build.mixed_lib(n).ptyrad_chain_plan(n, pmode, out), "ptyrad_chain_plan")
            assert tuple(out) == chain_plan(n).reported(pmode)


@pytest.mark.parametrize("n", MIXED_NS)
@pytest.mark.parametrize("h_case", H_CASES)
def test_chain_kernels_at_mixed_n(dev, gen, n, h_case):
    """B5 (last both ways, and with the far-field exit) and B6 (last_mega
    both ways) of N's mixed build through chain_segment / chain_stack
    against the plain chain: kernel_h's gather runs under autograd, so dH
    comes back in natural order and is compared as it is. Every launch is
    counted at N (launches_n<N>), and the backwards repeat bit for bit."""
    from ptyrad_tpu_torch.ops import chain as C

    b, pmode, sg = 3, 2, 2
    psi, a, p, h = _seg_inputs(dev, gen, b, pmode, 2 * sg, n)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    before = getattr(C.segment_fwd_cuda, f"launches_n{n}", 0)
    cases = [(lambda x, y, z, w, last=last, ff=ff: C.chain_segment(x, y[:, :sg + 1],
                                                                   z[:, :sg + 1], w, last, ff),
              lambda x, y, z, w, last=last, ff=ff: C.chain_segment_plain(
                  x, y[:, :sg + 1], z[:, :sg + 1], w, last, ff))
             for last, ff in ((True, False), (False, False), (True, True))]
    cases += [(lambda x, y, z, w, lm=lm: C.chain_stack(x, y, z, w, sg, lm),
               lambda x, y, z, w, lm=lm: C.chain_stack_plain(x, y, z, w, sg, lm))
              for lm in (True, False)]
    for kern, plain in cases:
        g = None
        grads = []
        for _ in range(2):
            leaves = [t.detach().clone().requires_grad_(True) for t in (psi, a, p, h)]
            leaves[3].requires_grad_(need_dh)
            out = kern(*leaves)
            g = torch.randn_like(out) if g is None else g
            grads.append(torch.autograd.grad(out, leaves[:3 + need_dh], grad_outputs=g,
                                             materialize_grads=True))
        for x, y in zip(*grads):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        if need_dh:
            ref, g_p = _vjp_plain(plain, (psi, a, p, h), g)
        else:
            ref, g_p = _vjp_plain(lambda x, y, z: plain(x, y, z, h), (psi, a, p), g)
        _assert_rel(out, ref, f"exit (N={n})")
        for name, x, y in zip(("psi", "a", "phi", "h"), grads[0], g_p):
            _assert_rel(x, y, f"d {name} (N={n})")
    assert getattr(C.segment_fwd_cuda, f"launches_n{n}") == before + 6


@pytest.mark.parametrize("n,nz", [(192, 21), (254, 21), (509, 3)])
@pytest.mark.parametrize("need_dh", [False, True])
def test_multislice_dp_chain_cuda_at_mixed_n(dev, gen, n, nz, need_dh):
    """multislice_dp_chain at a mixed N (B6 over the uniform segments, B5
    over the tail) against the plain multislice_dp on the same CUDA
    tensors, values and gradients, H's too with need_dh."""
    from ptyrad_tpu_torch.models import multislice_dp
    from ptyrad_tpu_torch.ops import chain as C

    b, pmode = 2, 2
    obja = 1.0 + 0.05 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    objp = 0.3 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
    probe = torch.complex(torch.randn((b, pmode, n, n), generator=gen, device=dev),
                          torch.randn((b, pmode, n, n), generator=gen, device=dev)) / n
    h = torch.exp(1j * torch.rand((1, n, n), generator=gen, device=dev) * 6.0).to(torch.complex64)
    occu = torch.ones(1, device=dev)
    leaves_k = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    leaves_p = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    h_k, h_p = h.clone().requires_grad_(need_dh), h.clone().requires_grad_(need_dh)
    before = getattr(C.stack_bwd_cuda, f"launches_n{n}", 0)
    dp_k = C.multislice_dp_chain(*leaves_k, h_k, occu, 1e-10)
    dp_p = multislice_dp(*leaves_p, h_p, occu, 1e-10)
    _assert_rel(dp_k, dp_p, "dp")
    w = torch.rand(dp_k.shape, generator=gen, device=dev)
    (w * dp_k).sum().backward()
    (w * dp_p).sum().backward()
    names = ("obja", "objp", "probe", "h")[:3 + need_dh]
    for name, x, y in zip(names, leaves_k + [h_k], leaves_p + [h_p]):
        _assert_rel(_grad(x), _grad(y), f"d {name}")
    assert getattr(C.stack_bwd_cuda, f"launches_n{n}", 0) == before + (nz >= 2 * C.best_sg(nz))


def test_chain_unsupported_cases_raise(dev, gen):
    """N beyond the kernels' plans (N > 512) raises instead of falling back."""
    from ptyrad_tpu_torch.ops import chain as C

    psi, a, p, h = _seg_inputs(dev, gen, 1, 1, 1, 1024)
    with pytest.raises(ValueError, match="power of two"):
        C.segment_fwd_cuda(psi, a, p, h, True)


def _pso_like_init(seed=5, n_scans=6, npix=256, crop=64, pmode=2, nz=17, canvas=288):
    """Small PSO-like data: 64^2 crops padded on the fly to 256^2."""
    from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly
    from ptyrad_tpu_torch.physics.propagator import near_field_evolution

    rng = np.random.default_rng(seed)
    init = _small_init(seed, n_scans, npix, pmode, nz, canvas)
    lo = (npix - crop) // 2
    crops = np.abs(rng.standard_normal((n_scans, crop, crop))).astype(np.float32) * 1e-3
    padded, idx = meas_pad_on_the_fly(crops, "power", npix, 70)
    init.update(measurements=crops, on_the_fly_meas_padded=padded,
                on_the_fly_meas_padded_idx=idx, omode_occu=np.ones(1, np.float32),
                H=near_field_evolution((npix, npix), 0.15, 10.0, 0.0197))
    assert idx == [lo, lo + crop, lo, lo + crop]
    return init


def test_pso_solver_cuda_matches_cpu(dev):
    """Two iterations of a PSO-like run (N = 256, 17 slices: B6 over two
    8-slice segments, B5 over the tail) on the card against the CPU: losses
    at rtol 1e-4, all four chain kernels launched and B3 not. The
    yml's constraints without ortho_pmode: cuSOLVER's eigh picks other
    eigenvector phases than LAPACK's, and Adam's elementwise steps then part
    the two trajectories legitimately (tests/test_torch_solver.py)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M

    params = {
        "model_params": {"update_params": {
            "obja": {"lr": 5e-4}, "objp": {"lr": 5e-4}, "probe": {"lr": 1e-4},
            "probe_pos_shifts": {"lr": 1e-4}}},
        "loss_params": {"loss_single": {"state": True, "dp_pow": 0.5}},
        "constraint_params": {"fix_probe_int": {"freq": 1},
                              "kz_filter": {"freq": 1, "obj_type": "both"},
                              "obja_thresh": {"freq": 1}, "objp_postiv": {"freq": 1}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 2}, "GROUP_MODE_SEED": 0},
    }
    counters = (M.loss_sums_fwd_cuda, M.loss_sums_bwd_cuda, C.segment_fwd_cuda,
                C.segment_bwd_cuda, C.stack_fwd_cuda, C.stack_bwd_cuda)
    for fn in counters:
        fn.launches = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(params, init_variables=_pso_like_init(), device=d, verbose=False)
        s.run()
        runs[d] = s
    np.testing.assert_allclose([v for _, v in runs[None].history.loss_iters],
                               [v for _, v in runs["cpu"].history.loss_iters], rtol=1e-4)
    steps = 2 * runs[None].batch_idx.shape[0]
    assert [fn.launches for fn in counters] == [0, 0] + [steps] * 4


# -- B5's far-field exit (set_far_field) ------------------------------------------

@pytest.fixture()
def exit_on():
    from ptyrad_tpu_torch.ops import chain as C

    C.set_far_field(True)
    try:
        yield
    finally:
        C.set_far_field(False)


@pytest.mark.parametrize("n", [2, 16, 64, 256, 512])
@pytest.mark.parametrize("pmode", [1, 4])
@pytest.mark.parametrize("sg", [1, 5])
@pytest.mark.parametrize("h_case", H_CASES)
def test_chain_segment_far_field_kernels(dev, gen, n, pmode, sg, h_case):
    """B5a with the exit against fftshift(fft2(.)) of the plain segment, and
    B5b with its adjoint against the plain VJP; counted in launches_ff (and
    launches_ff_dh), bit for bit on a second launch."""
    from ptyrad_tpu_torch.ops import chain as C

    b = 3 if n < 512 else 2
    psi, a, p, h = _seg_inputs(dev, gen, b, pmode, sg, n)
    h, need_dh = _h_case(dev, gen, h, b, n, h_case)
    before = (C.segment_fwd_cuda.launches_ff, C.segment_bwd_cuda.launches_ff,
              C.segment_bwd_cuda.launches_ff_dh)
    out = C.segment_fwd_cuda(psi, a, p, h, True, far_field=True)
    g, g_k = _chain_grads(
        out, h_case, lambda x, y, z, w: C.chain_segment_plain(x, y, z, w, True, far_field=True),
        (psi, a, p, h),
        lambda g, w, dh: C.segment_bwd_cuda(g, psi, a, p, w, True, need_dh=dh, far_field=True))
    after = (C.segment_fwd_cuda.launches_ff, C.segment_bwd_cuda.launches_ff,
             C.segment_bwd_cuda.launches_ff_dh)
    assert [y - x for x, y in zip(before, after)] == [1, 1, int(need_dh)]
    again = C.segment_bwd_cuda(g, psi, a, p, h, True, need_dh=need_dh, far_field=True)
    for x, y in zip(g_k[:3 + need_dh], again):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    if need_dh and sg == 1:  # nothing propagates: the exit adds nothing to dH
        assert not bool(g_k[3].any())


def test_far_field_without_last_raises_on_cuda(dev, gen):
    from ptyrad_tpu_torch.ops import chain as C

    psi, a, p, h = _seg_inputs(dev, gen, 1, 1, 2, 16)
    for call in (lambda: C.chain_segment(psi, a, p, h, False, far_field=True),
                 lambda: C.segment_fwd_cuda(psi, a, p, h, False, far_field=True),
                 lambda: C.segment_bwd_cuda(psi, psi, a, p, h, False, far_field=True)):
        with pytest.raises(ValueError, match="far_field requires last"):
            call()


@pytest.mark.parametrize("nz,n,pmode", [(1, 64, 4), (16, 64, 2), (8, 256, 2), (21, 256, 4)])
@pytest.mark.parametrize("need_dh", [False, True])
def test_multislice_dp_chain_far_field_cuda(dev, gen, exit_on, nz, n, pmode, need_dh):
    """multislice_dp_chain with the exit on against the plain multislice_dp
    on the same CUDA tensors, values and gradients; at nz = 16 and 8 (multiples
    of sg = 8) a full tail is carved off B6, which runs one segment or none."""
    from ptyrad_tpu_torch.models import multislice_dp
    from ptyrad_tpu_torch.ops import chain as C

    b = 4
    obja = 1.0 + 0.05 * torch.randn((b, 2, nz, n, n), generator=gen, device=dev)
    objp = 0.3 * torch.randn((b, 2, nz, n, n), generator=gen, device=dev)
    probe = torch.complex(torch.randn((1, pmode, n, n), generator=gen, device=dev),
                          torch.randn((1, pmode, n, n), generator=gen, device=dev)) / n
    h = torch.exp(1j * torch.rand((1, n, n), generator=gen, device=dev) * 6.0).to(torch.complex64)
    occu = torch.tensor([0.7, 0.3], device=dev)
    counters = (C.segment_fwd_cuda, C.segment_bwd_cuda, C.stack_fwd_cuda, C.stack_bwd_cuda)
    for fn in counters:
        fn.launches = fn.launches_ff = 0
    leaves_k = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    leaves_p = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    h_k, h_p = h.clone().requires_grad_(need_dh), h.clone().requires_grad_(need_dh)
    dp_k = C.multislice_dp_chain(*leaves_k, h_k, occu, 1e-10)
    dp_p = multislice_dp(*leaves_p, h_p, occu, 1e-10)
    _assert_rel(dp_k, dp_p, "dp")
    w = torch.rand(dp_k.shape, generator=gen, device=dev)
    (w * dp_k).sum().backward()
    (w * dp_p).sum().backward()
    names = ("obja", "objp", "probe", "h")[:3 + (need_dh and nz > 1)]
    for name, x, y in zip(names, leaves_k + [h_k], leaves_p + [h_p]):
        _assert_rel(_grad(x), _grad(y), f"d {name}")
    n_stack = {1: 0, 8: 0, 16: 1, 21: 1}[nz]  # per object mode
    assert [fn.launches for fn in counters] == [2, 2, 2 * n_stack, 2 * n_stack]
    assert (C.segment_fwd_cuda.launches_ff, C.segment_bwd_cuda.launches_ff) == (2, 2)
    with torch.no_grad():  # the grad-off route: B5 segment by segment, the last with the exit
        dp_off = C.multislice_dp_chain(obja, objp, probe, h, occu, 1e-10)
    torch.testing.assert_close(dp_off, dp_k.detach(), rtol=0, atol=0)


def test_pso_ff_solver_cuda_matches_cpu(dev, exit_on):
    """The PSO-like run of test_pso_solver_cuda_matches_cpu with the exit on,
    on the card against the CPU (its plain exit): losses at rtol 1e-4, every
    B5 launch through the exit."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.ops import chain as C

    params = {
        "model_params": {"update_params": {
            "obja": {"lr": 5e-4}, "objp": {"lr": 5e-4}, "probe": {"lr": 1e-4},
            "probe_pos_shifts": {"lr": 1e-4}}},
        "loss_params": {"loss_single": {"state": True, "dp_pow": 0.5}},
        "constraint_params": {"fix_probe_int": {"freq": 1},
                              "kz_filter": {"freq": 1, "obj_type": "both"},
                              "obja_thresh": {"freq": 1}, "objp_postiv": {"freq": 1}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 2}, "GROUP_MODE_SEED": 0},
    }
    for fn in (C.segment_fwd_cuda, C.segment_bwd_cuda):
        fn.launches = fn.launches_ff = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(params, init_variables=_pso_like_init(), device=d, verbose=False)
        s.run()
        runs[d] = s
    np.testing.assert_allclose([v for _, v in runs[None].history.loss_iters],
                               [v for _, v in runs["cpu"].history.loss_iters], rtol=1e-4)
    steps = 2 * runs[None].batch_idx.shape[0]
    assert (C.segment_fwd_cuda.launches, C.segment_fwd_cuda.launches_ff) == (steps, steps)
    assert (C.segment_bwd_cuda.launches, C.segment_bwd_cuda.launches_ff) == (steps, steps)


def test_meas_store_and_constraints_cuda_match_cpu(dev):
    """A bfloat16 store with the (2, 2) on-the-fly resample, and all twelve
    constraints without ortho_pmode (cuSOLVER's eigenvector phases differ
    from LAPACK's), on the card against the CPU."""
    from ptyrad_tpu_torch.constraints import DEFAULT_CONSTRAINT_PARAMS, ConstraintScheduler
    from ptyrad_tpu_torch.models import get_measurements, make_model

    init = _small_init(n_scans=21)
    rng = np.random.default_rng(9)
    init.update(measurements=np.abs(rng.standard_normal((21, 16, 16))).astype(np.float32),
                on_the_fly_meas_scale_factors=[2.0, 2.0],
                obj_tilts=rng.standard_normal((21, 2)).astype(np.float32),
                N_scan_slow=7, N_scan_fast=3)
    cfg = {k: {"freq": 1} for k in DEFAULT_CONSTRAINT_PARAMS if k != "ortho_pmode"}
    got = {}
    for d in ("cpu", None):
        params, buffers, geom = make_model(init, {"meas_dtype": "bfloat16"}, d)
        assert buffers.measurements.dtype == torch.bfloat16
        idx = torch.tensor([3, 0, 20], device=params.obja.device)
        ConstraintScheduler(cfg, geom)(params, buffers, 1)
        got[d] = [get_measurements(buffers, geom, idx).cpu()] + [t.detach().cpu()
                                                                 for _, t in params.named()]
    assert got[None][0].shape == (3, 32, 32)
    for name, x, y in zip(["measurements"] + [n for n, _ in params.named()], got[None],
                          got["cpu"]):
        if bool(y.any()):
            _assert_rel(x, y, name)
        else:  # probe_pos_shifts stay as they were on both devices
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# -- optimizable slice thickness and tilts (need_dh) ------------------------------

TILT_PARAMS = {
    **SOLVER_PARAMS,
    "model_params": {"update_params": {
        **SOLVER_PARAMS["model_params"]["update_params"],
        "obj_tilts": {"lr": 1e-4, "start_iter": 1},
        "slice_thickness": {"lr": 1e-4, "start_iter": 1}}},
    "constraint_params": {**SOLVER_PARAMS["constraint_params"],
                          "tilt_smooth": {"freq": 1, "std": 2.0}},
}


@pytest.mark.parametrize("tilt_each", [True, False])
def test_tilt_solver_cuda_matches_cpu(dev, tilt_each):
    """Three iterations with optimizable slice thickness and tilts (per
    position with tilt_smooth over a 4 x 5 grid, or one global tilt) on the
    card against the CPU: losses at rtol 1e-4, dz and the mean tilt at 2.5
    lr (Adam's steps are about lr; a near-zero gradient may take either
    sign), and B3b computing dH in every step."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.ops import fused_multislice as M

    init = _small_init()
    init.update(N_scan_slow=4, N_scan_fast=5,
                obj_tilts=np.zeros((20 if tilt_each else 1, 2), np.float32))
    M.loss_sums_bwd_cuda.launches_dh = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(TILT_PARAMS, init_variables=copy.deepcopy(init), device=d,
                         verbose=False)
        s.run()
        runs[d] = s
    cpu, gpu = runs["cpu"], runs[None]
    assert gpu.geom.global_tilt is not tilt_each
    np.testing.assert_allclose([v for _, v in gpu.history.loss_iters],
                               [v for _, v in cpu.history.loss_iters], rtol=1e-4)
    np.testing.assert_allclose([v for _, v in gpu.history.dz_iters],
                               [v for _, v in cpu.history.dz_iters], rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(np.array([v for _, v in gpu.history.avg_tilt_iters]),
                               np.array([v for _, v in cpu.history.avg_tilt_iters]),
                               rtol=0, atol=2.5e-4)
    assert M.loss_sums_bwd_cuda.launches_dh == 3 * gpu.batch_idx.shape[0]


def test_pso_tilt_solver_cuda_matches_cpu(dev):
    """The PSO-like run of test_pso_solver_cuda_matches_cpu with a global
    tilt and dz optimizable: losses at rtol 1e-4, dz at 2.5 lr, and B5b and
    B6b computing dH in every step."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.ops import chain as C

    params = {
        "model_params": {"update_params": {
            "obja": {"lr": 5e-4}, "objp": {"lr": 5e-4}, "probe": {"lr": 1e-4},
            "obj_tilts": {"lr": 1e-4}, "slice_thickness": {"lr": 1e-4}}},
        "loss_params": {"loss_single": {"state": True, "dp_pow": 0.5}},
        "constraint_params": {"fix_probe_int": {"freq": 1}, "obja_thresh": {"freq": 1}},
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 2}, "GROUP_MODE_SEED": 0},
    }
    init = _pso_like_init()
    init["obj_tilts"] = np.array([[0.5, -0.3]], np.float32)
    for fn in (C.segment_bwd_cuda, C.stack_bwd_cuda):
        fn.launches_dh = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(params, init_variables=copy.deepcopy(init), device=d, verbose=False)
        s.run()
        runs[d] = s
    np.testing.assert_allclose([v for _, v in runs[None].history.loss_iters],
                               [v for _, v in runs["cpu"].history.loss_iters], rtol=1e-4)
    np.testing.assert_allclose([v for _, v in runs[None].history.dz_iters],
                               [v for _, v in runs["cpu"].history.dz_iters], rtol=0, atol=2.5e-4)
    steps = 2 * runs[None].batch_idx.shape[0]
    assert [C.segment_bwd_cuda.launches_dh, C.stack_bwd_cuda.launches_dh] == [steps, steps]


# -- the params-file entry: Initializer -> solver -----------------------------

def _raw_params(raw_path, n_side=4, npix=32):
    """A params dict for patterns in an EMPAD .raw, every key the Initializer
    and the solver read written out (load_params(validate=False) on the
    card's machine, which may lack pydantic): fitRBF, max_at_one, flipT,
    seeded jitter, a simulated probe defocused by 200 Ang (it lights the
    whole window, see tests/test_torch_initializer.py::solver_params),
    positions, object and tilt."""
    return {
        "init_params": {
            "probe_illum_type": "electron", "probe_kv": 80.0, "probe_conv_angle": 24.9,
            "probe_defocus": 200.0, "probe_c3": 0.0, "probe_c5": 0.0, "meas_Npix": npix,
            "pos_N_scans": n_side * n_side, "pos_N_scan_slow": n_side,
            "pos_N_scan_fast": n_side, "pos_scan_step_size": 0.43,
            "meas_calibration": {"mode": "fitRBF", "value": None, "thresh": 0.5},
            "probe_pmode_max": 2, "probe_pmode_init_pows": [0.02], "obj_omode_max": 1,
            "obj_omode_init_occu": {"occu_type": "uniform", "init_occu": None},
            "obj_Nlayer": 2, "obj_slice_thickness": 2.0, "meas_flipT": [1, 0, 0],
            "meas_remove_neg_values": {"mode": "clip_neg", "value": None, "force": False},
            "meas_normalization": {"mode": "max_at_one", "value": None},
            "pos_scan_rand_std": 0.15, "meas_source": "file",
            "meas_params": {"path": raw_path, "key": None, "shape": None, "offset": None,
                            "gap": None},
            "probe_source": "simu", "probe_params": None, "pos_source": "simu",
            "pos_params": None, "obj_source": "simu", "obj_params": None,
            "tilt_source": "simu", "tilt_params": {"tilt_type": "all", "init_tilts": [[0.0, 0.0]]},
        },
        "model_params": SOLVER_PARAMS["model_params"],
        "loss_params": SOLVER_PARAMS["loss_params"],
        "constraint_params": SOLVER_PARAMS["constraint_params"],
        "recon_params": {"NITER": 2, "BATCH_SIZE": {"size": 4}, "GROUP_MODE_SEED": 0},
    }


def test_solver_from_raw_params_cuda_matches_cpu(dev, tmp_path):
    """load_params -> PtyRADSolver(params) with no init_variables, on a small
    .raw of patterns simulated from a weak phase object (flipped as
    meas_flipT undoes): the card's run against the CPU's, both from
    RandomState(0), equal init_variables and losses at rtol 1e-4; the .raw
    read by the native reader; B3 launched on the card."""
    import json

    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.initialization import Initializer
    from ptyrad_tpu_torch.models import forward, make_model
    from ptyrad_tpu_torch.ops import fused_multislice as M

    raw = tmp_path / "m.raw"
    ip = {**_raw_params(str(raw))["init_params"], "meas_source": "custom",
          "meas_params": np.ones((16, 32, 32), np.float32), "pos_scan_rand_std": None,
          "meas_calibration": {"mode": "dx", "value": 0.3}, "meas_flipT": None}
    iv = Initializer(ip, verbose=False, rng=np.random.RandomState(0)).init_all().init_variables
    iv["obj"] = np.exp(0.3j * np.random.default_rng(11).random(iv["obj"].shape))
    params, buffers, geom = make_model(iv, None, device="cpu")
    with torch.no_grad():
        dp = forward(params, buffers, geom, torch.arange(16))[0].numpy()
    with open(raw, "wb") as f:
        for frame in np.flip(dp, axis=1):
            f.write(np.ascontiguousarray(frame).tobytes())
            f.write(b"\x00" * 1024)
    path = tmp_path / "params.json"
    path.write_text(json.dumps(_raw_params(str(raw))))

    M.loss_sums_fwd_cuda.launches = 0
    runs = {}
    for d in ("cpu", None):
        s = PtyRADSolver(L.load_params(str(path), validate=False), device=d, verbose=False,
                         init_rng=np.random.RandomState(0))
        assert L.LAST_RAW_READ["reader"] == "native"
        s.run()
        runs[d] = s
    cpu, gpu = runs["cpu"], runs[None]
    for key, value in cpu.init_variables.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(gpu.init_variables[key], value, err_msg=key)
    losses = [[v for _, v in s.history.loss_iters] for s in (gpu, cpu)]
    assert losses[0][-1] < losses[0][0]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    assert M.loss_sums_fwd_cuda.launches == 2 * gpu.batch_idx.shape[0]


# -- the bfloat16 compute policy: the _bf16 kernels -------------------------------
#
# Bfloat16 rounding turns float32 differences between a kernel and its
# torch.fft twin into whole bfloat16 steps that later passes spread
# (tests/test_torch_bf16.py test_rounding_amplifies_float32_differences), so
# a kernel is held against its twin bit-near only at two passes: there the
# kernel is within a tenth of its own bfloat16 error (L2) of its twin.
# Deeper chains are held by chip_smoke.py's rows (the two errors' ratio).


def _l2(t):
    return float(torch.linalg.vector_norm(t.detach().to(torch.complex128)))


def _within_tenth(k16, k32, t16, what):
    """|K16 - T16| <= 0.1 |K16 - K32|, the kernel rounding (K16 != K32)."""
    e_k = _l2(k16 - k32)
    assert e_k > 0, f"{what}: the kernel did not round"
    assert _l2(k16 - t16) <= 0.1 * e_k, f"{what}: {_l2(k16 - t16)} from its twin, e_K {e_k}"


@pytest.mark.parametrize("n", [2, 16, 64, 128])
@pytest.mark.parametrize("pmode", [1, 6])
def test_bf16_dp_forward_at_two_passes(dev, gen, n, pmode):
    """B4a's bf16 entry point at one slice on a shared real-space probe (the
    far field's two passes) against multislice_dp_plain(bf16_operands=True),
    counted in launches_bf16."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    obja, objp, probe, h, _, _ = _chain_inputs(dev, gen, 3, pmode, 1, n, "shared")
    before = M.dp_fwd_cuda.launches_bf16
    k16, k32 = (M.dp_fwd_cuda(obja, objp, probe, h, False, bf) for bf in (True, False))
    assert M.dp_fwd_cuda.launches_bf16 == before + 1
    with torch.no_grad():
        t16 = M.multislice_dp_plain(obja, objp, probe, h, False, bf16_operands=True)
    _within_tenth(k16, k32, t16, f"B4a bf16 N={n}")


@pytest.mark.parametrize("n", [16, 64, 256, 512])
def test_bf16_far_field_exit_at_two_passes(dev, gen, n):
    """B5a and B5b's bf16 entry points at one slice with the far-field exit
    (two passes each way) against chain_segment_plain(bf16_operands=True)
    and its VJP, counted in launches_ff_bf16 and launches_bf16."""
    from ptyrad_tpu_torch.ops import chain as C

    psi, a, p, h = _seg_inputs(dev, gen, 2, 4, 1, n)
    fwd, bwd = C.segment_fwd_cuda, C.segment_bwd_cuda
    before = fwd.launches_ff_bf16, bwd.launches_bf16
    k16, k32 = (fwd(psi, a, p, h, True, True, bf) for bf in (True, False))
    g = torch.randn_like(k16)
    gk16, gk32 = (bwd(g, psi, a, p, h, True, far_field=True, bf16_operands=bf)[:3]
                  for bf in (True, False))
    assert (fwd.launches_ff_bf16, bwd.launches_bf16) == (before[0] + 1, before[1] + 1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (psi, a, p)]
    t16 = C.chain_segment_plain(*leaves, h, True, True, bf16_operands=True)
    gt16 = torch.autograd.grad(t16, leaves, grad_outputs=g)
    _within_tenth(k16, k32, t16, f"B5a bf16 exit N={n}")
    for name, x, y, z in zip(("psi", "a", "phi"), gk16, gk32, gt16):
        _within_tenth(x, y, z, f"B5b bf16 exit d {name} N={n}")


@pytest.mark.parametrize("probe_layout", ["shared", "each_kspace"])
def test_bf16_backwards_repeat_bit_for_bit(dev, gen, probe_layout):
    """B3b and B4b's bf16 entry points sum in the float32 kernels' fixed
    order: every cotangent, dH included, repeats bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, 5, 6, 6, 128, probe_layout)
    kspace = probe_layout.endswith("kspace")
    dp = M.loss_sums_fwd_cuda(obja, objp, probe, h, meas, mask, 0.5, 1e-10, kspace,
                              bf16_operands=True)[2]
    c = torch.tensor(0.7, device=dev)
    g = torch.randn(dp.shape, generator=gen, device=dev)
    runs = [lambda: M.loss_sums_bwd_cuda(obja, objp, probe, h, meas, mask, dp, c, 0.5, 1e-10,
                                         kspace, need_dh=True, bf16_operands=True),
            lambda: M.dp_bwd_cuda(obja, objp, probe, h, g, kspace, need_dh=True,
                                  bf16_operands=True)]
    for run in runs:
        for a, b in zip(run(), run()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
