"""The CUDA kernels against their plain PyTorch versions on the card, over
the edge cases that chip_smoke.py's tBL shapes do not reach: small and odd
patch sizes, one slice, one mode, every probe layout, other loss powers, a
masked sample, the whole loss-folded path and a short solver run.

Marked ``cuda``: skipped without a GPU. On a machine with one (and no JAX,
which tests/conftest.py imports) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: the gather copies values (exact); the scatter and the B3
cotangents sum with atomics in a run-dependent order, and B3 transforms with
a different FFT than torch.fft: rtol 1e-5 of the largest sum for the
scatter, 1e-4 relative for s1/s2 and 1e-4 of each cotangent's largest entry.
"""

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
    ref = P.scatter_add_plain(canvas.shape, g, pos)
    out = P.scatter_add_cuda(canvas.shape, g, pos)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


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


@pytest.mark.parametrize("b,pmode,nz,n", [(3, 2, 1, 16), (2, 1, 2, 2), (4, 3, 6, 64),
                                          (2, 6, 6, 128)])
@pytest.mark.parametrize("probe_layout", ["shared", "shared_kspace", "each", "each_kspace"])
@pytest.mark.parametrize("p", [0.5, 1.0, 0.3])
def test_loss_chain_kernels(dev, gen, b, pmode, nz, n, probe_layout, p):
    from ptyrad_tpu_torch.ops import fused_multislice as M

    kspace = probe_layout.endswith("kspace")
    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, b, pmode, nz, n, probe_layout)
    eps = 1e-10
    leaves_k = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    leaves_p = [t.clone().requires_grad_(True) for t in (obja, objp, probe)]
    launches = M.loss_sums_fwd_cuda.launches, M.loss_sums_bwd_cuda.launches
    s1k, s2k = M.multislice_loss_sums_fused(*leaves_k, h, meas, mask, p, eps,
                                            probe_kspace=kspace)
    s1p, s2p = M.loss_sums_plain(*leaves_p, h, meas, mask, p, eps, kspace)
    torch.testing.assert_close(s1k, s1p, rtol=1e-4, atol=0)
    torch.testing.assert_close(s2k, s2p, rtol=1e-4, atol=0)
    (0.7 * s1k).backward()
    (0.7 * s1p).backward()
    assert (M.loss_sums_fwd_cuda.launches, M.loss_sums_bwd_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    for name, a, r in zip(("obja", "objp", "probe"), leaves_k, leaves_p):
        scale = float(r.grad.abs().max())
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=1e-4 * scale,
                                   msg=lambda m, name=name: f"d {name}: {m}")
    assert float(leaves_k[0].grad[-1].abs().max()) == 0.0  # the masked sample


def test_unsupported_cases_raise(dev, gen):
    from ptyrad_tpu_torch.ops import fused_multislice as M

    obja, objp, probe, h, meas, mask = _chain_inputs(dev, gen, 2, 2, 2, 16, "each")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.multislice_loss_sums_fused(obja, objp, probe, h, meas, mask, 0.5, 1e-10, need_dh=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.multislice_loss_sums_fused(obja, objp, probe, h.expand(2, 16, 16), meas, mask, 0.5,
                                     1e-10)
    big = torch.ones((2, 1, 1, 256, 256), device=dev)
    with pytest.raises(ValueError, match="power of two"):
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
    the same padded batch plan, and forward() raising on CUDA."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.models import forward

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
    with pytest.raises(NotImplementedError, match="B4"):
        forward(gpu.params, gpu.buffers, gpu.geom, torch.arange(4, device=gpu.device))
