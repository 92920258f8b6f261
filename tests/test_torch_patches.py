"""Patch gather (B1) and scatter-add (B2): the port's plain versions against
ptyrad_tpu's XLA path (_extract_impl / scatter_add_patches) and its Pallas
kernels in interpret mode, with clamped corners and duplicate windows.

Corners past the last window clamp to it in both JAX paths. A negative
corner clamps to 0 in the Pallas kernels and in the port, while
lax.dynamic_slice first wraps it like a Python index (-3 -> H-3); callers
never pass one (extract_patches' contract), so the XLA-path comparisons use
non-negative corners and the Pallas comparison covers negative ones.

Gathers copy values, so they agree exactly. Scatter-adds sum overlapping
windows in different orders: rtol 1e-6 with an atol of 1e-6 of the largest
sum (float32 rounding of a few additions). The CUDA kernels themselves are
held against these plain versions by chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.ops import patches as jpatches
from ptyrad_tpu_torch.ops import patches as tpatches
from torch_port_helpers import np_

PATCH = (16, 16)


def corners(rng, canvas, negative=False):
    pos = rng.integers(0, canvas - PATCH[0] + 1, size=(6, 2)).astype(np.int32)
    pos[1] = pos[0]                                       # duplicate window
    pos[2] = [canvas - PATCH[0] + 5, canvas - PATCH[1] + 2]  # past the last corner
    pos[3] = [canvas - PATCH[0] + 1, canvas + 30]          # past it on both axes
    if negative:
        pos[4] = [-3, 4]
    return pos


def sum_close(actual, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=1e-6,
                               atol=1e-6 * float(np.abs(expected).max()))


@pytest.mark.parametrize("lead", [(3,), (1, 3), (2, 2)])
def test_gather_matches_xla_path(rng, lead):
    canvas = rng.standard_normal((*lead, 32, 40)).astype(np.float32)
    pos = corners(rng, 32)
    ref = jpatches._extract_impl(jnp.asarray(canvas), jnp.asarray(pos), PATCH)
    out = tpatches.gather_patches(torch.from_numpy(canvas), torch.from_numpy(pos), PATCH)
    np.testing.assert_array_equal(np_(out), np.asarray(ref))


@pytest.mark.parametrize("lead", [(3,), (1, 3)])
def test_scatter_matches_xla_path(rng, lead):
    shape = (*lead, 32, 40)
    pos = corners(rng, 32)
    g = rng.standard_normal((6, *lead, *PATCH)).astype(np.float32)
    ref = jpatches.scatter_add_patches(shape, jnp.asarray(g), jnp.asarray(pos))
    out = tpatches.scatter_add_patches(shape, torch.from_numpy(g), torch.from_numpy(pos))
    sum_close(np_(out), ref)


def test_against_pallas_kernels_interpret(rng):
    canvas = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    pos = corners(rng, 32, negative=True)
    ref = jpatches.pallas_gather(jnp.asarray(canvas), jnp.asarray(pos), PATCH, interpret=True)
    out = tpatches.gather_plain(torch.from_numpy(canvas), torch.from_numpy(pos), PATCH)
    np.testing.assert_array_equal(np_(out), np.asarray(ref))

    g = rng.standard_normal((6, 2, 3, *PATCH)).astype(np.float32)
    ref = jpatches.pallas_scatter_add(canvas.shape, jnp.asarray(g), jnp.asarray(pos),
                                      interpret=True)
    out = tpatches.scatter_add_plain(canvas.shape, torch.from_numpy(g), torch.from_numpy(pos))
    sum_close(np_(out), ref)


def test_adjoint_dot_product(rng):
    """<gather(x), y> == <x, scatter(y)>, with the scatter reached as the
    gradient of the autograd.Function (float64 so the identity is sharp)."""
    x = torch.from_numpy(rng.standard_normal((1, 3, 32, 32))).requires_grad_(True)
    pos = torch.from_numpy(corners(rng, 32))
    y = torch.from_numpy(rng.standard_normal((6, 1, 3, *PATCH)))
    patches = tpatches.extract_patches(x, pos, PATCH)
    (patches * y).sum().backward()
    lhs = float((patches.detach() * y).sum())
    rhs = float((x.detach() * x.grad).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
    np.testing.assert_allclose(np_(x.grad), np_(tpatches.scatter_add_patches(x.shape, y, pos)),
                               rtol=0, atol=1e-12)


def test_extract_gradient_matches_jax(rng):
    import jax

    canvas = rng.standard_normal((1, 2, 32, 32)).astype(np.float32)
    pos = corners(rng, 32)
    w = rng.standard_normal((6, 1, 2, *PATCH)).astype(np.float32)
    g_ref = jax.grad(lambda c: jnp.sum(jpatches.extract_patches(c, jnp.asarray(pos), PATCH)
                                       * w))(jnp.asarray(canvas))
    x = torch.from_numpy(canvas).requires_grad_(True)
    (tpatches.extract_patches(x, torch.from_numpy(pos), PATCH) * torch.from_numpy(w)).sum().backward()
    sum_close(np_(x.grad), g_ref)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel launchers take CUDA tensors only; the dispatching wrappers
    send CPU tensors to the plain versions."""
    canvas = torch.zeros((3, 32, 32))
    pos = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpatches.gather_cuda(canvas, pos, PATCH)
    with pytest.raises(ValueError, match="CUDA"):
        tpatches.scatter_add_cuda((3, 32, 32), torch.zeros((2, 3, *PATCH)), pos)
