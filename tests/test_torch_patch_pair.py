"""The patch pair (``extract_patch_pair``) and the plans of B1 and B2
(``csrc/patches.cu``), checked on the CPU.

``extract_patch_pair`` gathers obja and objp at the same corners (one B1
launch on the card) and scatters the cotangents of the canvases that need a
gradient (one B2 launch). On the CPU it runs the plain versions; here it is
held against the JAX package's ``extract_patches`` applied to each canvas,
on the XLA path and with the Pallas kernels in interpret mode, values and
vjp, for both canvases and for one. Both JAX paths sum each canvas element
over its windows in batch order from zero, as the port does, so everything
agrees bit for bit. The XLA path wraps a negative corner where the Pallas
kernels and the port clamp it (``tests/test_torch_patches.py``), so only
the interpret-mode cases have one.

The second half restates the kernels' plans from the constants of
``csrc/patches.cu`` (read from the source, so the two cannot drift) and
emulates them block by block in NumPy: B1's grid of whole output rows (a
warp a row, 16 bytes a lane on the vector path, 4 bytes on the scalar
path) and B2's owner-computes tiles (corners of a chunk in shared memory,
the overlapping windows compacted in ascending order by a ballot a warp,
then walked in that order into a thread's register sums). Over seeded
shapes (tBL, PSO, N = 96 and 120, widths that are no multiple of 4, B = 1,
L = 1, clamped, negative and duplicate corners, more windows than a chunk,
one canvas and two) every output and canvas element is written by exactly
one thread, every patch element is read exactly once, each block walks its
windows in ascending b, the emulated gather equals ``gather_plain`` and the
emulated scatter equals ``scatter_add_plain`` bit for bit. Nothing here
runs CUDA: the card-only suite holds the kernels themselves against these
plain versions at tolerance 0.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.ops import patches as jpatches
from ptyrad_tpu_torch.ops import patches as tpatches
from torch_port_helpers import np_

SOURCE = Path(tpatches.__file__).resolve().parent.parent / "csrc" / "patches.cu"


def _constants() -> dict:
    """The literal plan constants of csrc/patches.cu, and the derived ones
    checked against their definitions there."""
    text = SOURCE.read_text()
    k = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    for line in ("constexpr int kWarps = kThreads / 32;",
                 "constexpr int kRowSums = kTileRows / kWarps;",
                 "constexpr int kColSums = kTileCols / 32;"):
        assert line in text, f"csrc/patches.cu no longer defines: {line}"
    k["kWarps"] = k["kThreads"] // 32
    k["kRowSums"] = k["kTileRows"] // k["kWarps"]
    k["kColSums"] = k["kTileCols"] // 32
    return k


K = _constants()


# -- extract_patch_pair against the JAX package -------------------------------

def _pair_inputs(rng, negative: bool):
    lead, hw, patch, b = (1, 3), (40, 37), (16, 9), 7
    canvases = [rng.standard_normal((*lead, *hw)).astype(np.float32) for _ in range(2)]
    pos = np.stack([rng.integers(0, hw[0] - patch[0] + 1, b),
                    rng.integers(0, hw[1] - patch[1] + 1, b)], -1).astype(np.int32)
    pos[1] = pos[0]                                           # duplicate window
    pos[2] = [hw[0] - patch[0] + 4, hw[1] + 3]                # past the last corner
    if negative:
        pos[3] = [-2, 5]
    weights = [rng.standard_normal((b, *lead, *patch)).astype(np.float32) for _ in range(2)]
    return canvases, pos, patch, weights


def _jax_pair(canvases, pos, patch, weights, need):
    """The JAX package's extract_patches on each canvas, and the vjp of
    sum(w_a * patches_a) + sum(w_p * patches_p) for the canvases in `need`."""
    def loss(a, p):
        pa = jpatches.extract_patches(a, jnp.asarray(pos), patch)
        pp = jpatches.extract_patches(p, jnp.asarray(pos), patch)
        return jnp.sum(pa * weights[0]) + jnp.sum(pp * weights[1]), (pa, pp)

    argnums = tuple(i for i, n in enumerate(need) if n)
    grads, (pa, pp) = jax.grad(loss, argnums=argnums, has_aux=True)(*map(jnp.asarray, canvases))
    full = [None, None]
    for i, g in zip(argnums, grads):
        full[i] = np.asarray(g)
    return np.asarray(pa), np.asarray(pp), full


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_path(request):
    jpatches.set_interpret(request.param == "pallas_interpret")
    yield request.param
    jpatches.set_interpret(False)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "objp_frozen", "obja_frozen"])
def test_pair_matches_jax(rng, jax_path, need):
    canvases, pos, patch, weights = _pair_inputs(rng, negative=jax_path == "pallas_interpret")
    ref_a, ref_p, ref_grads = _jax_pair(canvases, pos, patch, weights, need)
    a, p = (torch.from_numpy(c).requires_grad_(n) for c, n in zip(canvases, need))
    oa, op = tpatches.extract_patch_pair(a, p, torch.from_numpy(pos), patch)
    np.testing.assert_array_equal(np_(oa), ref_a)
    np.testing.assert_array_equal(np_(op), ref_p)
    ((oa * torch.from_numpy(weights[0])).sum()
     + (op * torch.from_numpy(weights[1])).sum()).backward()
    for t, ref in zip((a, p), ref_grads):
        if ref is None:
            assert t.grad is None
        else:
            np.testing.assert_array_equal(np_(t.grad), ref)


def test_pair_equals_two_single_extracts(rng):
    """Values and gradients of the pair equal extract_patches per canvas."""
    canvases, pos, patch, weights = _pair_inputs(rng, negative=True)
    pos_t = torch.from_numpy(pos)
    w = [torch.from_numpy(x) for x in weights]
    pair = [torch.from_numpy(c).requires_grad_(True) for c in canvases]
    single = [torch.from_numpy(c).requires_grad_(True) for c in canvases]
    out_pair = tpatches.extract_patch_pair(*pair, pos_t, patch)
    out_single = [tpatches.extract_patches(c, pos_t, patch) for c in single]
    sum(((o * wi).sum() for o, wi in zip(out_pair, w)), torch.zeros(())).backward()
    sum(((o * wi).sum() for o, wi in zip(out_single, w)), torch.zeros(())).backward()
    for x, y in zip(out_pair + tuple(pair), out_single + single):
        np.testing.assert_array_equal(np_(x), np_(y))
    for x, y in zip(pair, single):
        np.testing.assert_array_equal(np_(x.grad), np_(y.grad))


@pytest.mark.parametrize("zero", [False, True], ids=["unused", "zero"])
def test_pair_with_one_cotangent_unused_or_zero(rng, zero):
    """objp's patches unused (cotangent None) or multiplied by zero: objp's
    gradient is zero and obja's is the scatter of its cotangent alone."""
    canvases, pos, patch, weights = _pair_inputs(rng, negative=False)
    a, p = (torch.from_numpy(c).requires_grad_(True) for c in canvases)
    oa, op = tpatches.extract_patch_pair(a, p, torch.from_numpy(pos), patch)
    loss = (oa * torch.from_numpy(weights[0])).sum()
    if zero:
        loss = loss + (op * 0.0).sum()
    loss.backward()
    np.testing.assert_array_equal(np_(p.grad), np.zeros_like(canvases[1]))
    np.testing.assert_array_equal(
        np_(a.grad), np_(tpatches.scatter_add_plain(a.shape, torch.from_numpy(weights[0]),
                                                    torch.from_numpy(pos))))


def test_pair_rejects_canvases_of_two_shapes():
    with pytest.raises(ValueError, match="differ"):
        tpatches.extract_patch_pair(torch.zeros((2, 20, 20)), torch.zeros((3, 20, 20)),
                                    torch.zeros((1, 2), dtype=torch.int32), (8, 8))


def test_get_obj_patches_uses_the_pair(monkeypatch, rng):
    """The forward model gathers obja and objp through one pair call."""
    from ptyrad_tpu_torch.models import make_model
    from torch_port_helpers import toy_init

    forward = importlib.import_module("ptyrad_tpu_torch.models.forward")

    calls = []
    real = forward.extract_patch_pair
    monkeypatch.setattr(forward, "extract_patch_pair",
                        lambda *args: calls.append(args) or real(*args))
    params, buffers, geom = make_model(toy_init(rng), {}, torch.device("cpu"))
    obja, objp = forward.get_obj_patches(params, buffers, geom, torch.arange(4))
    assert len(calls) == 1 and calls[0][0] is params.obja and calls[0][1] is params.objp
    assert obja.shape == objp.shape == (4, *params.obja.shape[:-2], *geom.probe_shape)


# -- the kernels' plans, emulated block by block -----------------------------

def _clamped(pos, h, w, ny, nx):
    return np.minimum(np.maximum(pos, 0), [h - ny, w - nx])


def emulate_gather(canvases, pos, ny, nx, vec_aligned=True, max_grid_z=None):
    """B1: grid (ceil(ny / kGatherRows), L, min(B * n_canvas, kMaxGridZ)); the
    block strides over (canvas, b) by gridDim.z; warp w writes rows w, w + 8,
    ... of its group; on the vector path (nx % 4 == 0, aligned outputs) lane
    t writes columns 4v .. 4v + 3 for v = t, t + 32, ..., else columns t,
    t + 32, .... Returns the outputs and how often each element was written."""
    n_c = len(canvases)
    lmodes, h, w = canvases[0].shape
    b_count = pos.shape[0]
    corners = _clamped(pos, h, w, ny, nx)
    grid = (-(-ny // K["kGatherRows"]), lmodes,
            min(b_count * n_c, max_grid_z or K["kMaxGridZ"]))
    assert grid[1] <= 65535
    vec = nx % 4 == 0 and vec_aligned
    if vec:
        lane_cols = [np.concatenate([4 * v + np.arange(4) for v in range(t, nx // 4, 32)]
                                    or [np.zeros(0, int)]) for t in range(32)]
    else:
        lane_cols = [np.arange(t, nx, 32) for t in range(32)]
    cols = np.concatenate(lane_cols).astype(int)
    assert len(set(cols)) == len(cols)  # no two lanes write one column
    outs = [np.full((b_count, lmodes, ny, nx), np.nan, np.float32) for _ in range(n_c)]
    writes = np.zeros((n_c, b_count, lmodes, ny, nx), np.int32)
    for gx in range(grid[0]):
        row0 = gx * K["kGatherRows"]
        n_rows = min(K["kGatherRows"], ny - row0)
        rows = row0 + np.concatenate([np.arange(wp, n_rows, K["kWarps"])
                                      for wp in range(K["kWarps"])]).astype(int)
        assert len(set(rows)) == len(rows)  # no two warps write one row
        for l in range(grid[1]):
            for gz in range(grid[2]):
                for bc in range(gz, b_count * n_c, grid[2]):
                    c, b = divmod(bc, b_count)
                    y0, x0 = corners[b]
                    outs[c][b, l][np.ix_(rows, cols)] = canvases[c][l][np.ix_(y0 + rows,
                                                                              x0 + cols)]
                    writes[c, b, l][np.ix_(rows, cols)] += 1
    return outs, writes


def _thread_map():
    """Tile-relative (y, x) of each register sum (warp, lane, r, j) of a B2
    thread: rows warp + kWarps r, columns lane + 32 j."""
    wp, ln, r, j = np.meshgrid(np.arange(K["kWarps"]), np.arange(32), np.arange(K["kRowSums"]),
                               np.arange(K["kColSums"]), indexing="ij")
    return wp + K["kWarps"] * r, ln + 32 * j


def _compact(over):
    """The block's ordered compaction of one pass: a ballot a warp, the warps'
    counts in shared memory, slot = hits so far + counts of the warps before
    + set bits of the lanes before. Returns {slot: pass index}."""
    ballots = over.reshape(K["kWarps"], 32)
    counts = ballots.sum(1)
    slots = {}
    for wp in range(K["kWarps"]):
        before = counts[:wp].sum()
        for ln in np.flatnonzero(ballots[wp]):
            slots[int(before + ballots[wp, :ln].sum())] = wp * 32 + ln
    return slots, int(counts.sum())


def emulate_scatter(canvas_shape, stacks, pos):
    """B2: grid (ceil(W / kTileCols), ceil(H / kTileRows), L * n_canvas); a
    block clamps up to kChunk corners a chunk, compacts the windows over its
    tile in ascending order and walks them into register sums (every sum
    takes every walked window: +0.0 where the window does not reach it, as
    in the kernel), then writes its tile. Returns the canvases, how often each canvas element was
    written and each patch element read, and each block's walk order."""
    lmodes, h, w = canvas_shape
    n_c = len(stacks)
    b_count, _, ny, nx = stacks[0].shape
    grid = (-(-w // K["kTileCols"]), -(-h // K["kTileRows"]), lmodes * n_c)
    assert grid[2] <= 65535
    assert K["kChunk"] * 12 + K["kWarps"] * 4 <= 48 * 1024  # static shared memory
    ty_map, tx_map = _thread_map()
    canvases = [np.full(canvas_shape, np.nan, np.float32) for _ in range(n_c)]
    writes = np.zeros((n_c, *canvas_shape), np.int32)
    reads = np.zeros((n_c, b_count, lmodes, ny, nx), np.int32)
    orders = []
    for gx in range(grid[0]):
        for gy in range(grid[1]):
            for gz in range(grid[2]):
                c, l = divmod(gz, lmodes)
                ty0, tx0 = gy * K["kTileRows"], gx * K["kTileCols"]
                sums = np.zeros(ty_map.shape, np.float32)
                walked = []
                for base in range(0, b_count, K["kChunk"]):
                    n = min(K["kChunk"], b_count - base)
                    corner = _clamped(pos[base:base + n], h, w, ny, nx)
                    hits, n_hits = {}, 0
                    for i0 in range(0, n, K["kThreads"]):
                        idx = i0 + np.arange(K["kThreads"])
                        over = np.zeros(K["kThreads"], bool)
                        ok = idx < n
                        y0, x0 = corner[idx[ok]].T
                        over[ok] = ((y0 < ty0 + K["kTileRows"]) & (y0 + ny > ty0)
                                    & (x0 < tx0 + K["kTileCols"]) & (x0 + nx > tx0))
                        slots, count = _compact(over)
                        hits.update({n_hits + s: i0 + t for s, t in slots.items()})
                        n_hits += count
                    assert sorted(hits) == list(range(n_hits))
                    for k in range(n_hits):
                        i = hits[k]
                        y0, x0 = corner[i]
                        py, px = ty0 + ty_map - y0, tx0 + tx_map - x0
                        inside = (py >= 0) & (py < ny) & (px >= 0) & (px < nx)
                        vals = np.zeros(sums.shape, np.float32)  # +0.0 outside the window
                        vals[inside] = stacks[c][base + i, l, py[inside], px[inside]]
                        sums += vals
                        reads[c, base + i, l, py[inside], px[inside]] += 1
                        walked.append(base + i)
                orders.append(walked)
                y, x = ty0 + ty_map, tx0 + tx_map
                keep = (y < h) & (x < w)
                canvases[c][l, y[keep], x[keep]] = sums[keep]
                writes[c, l, y[keep], x[keep]] += 1  # one (y, x) a thread sum
    return canvases, writes, reads, orders


# (lead, H, W, N_y, N_x, B, n_canvas)
PLAN_CASES = {
    "tBL": ((1, 6), 520, 520, 128, 128, 32, 1),
    "PSO": ((1, 21), 436, 436, 256, 256, 32, 1),
    "N96_W_odd": ((1, 2), 150, 159, 96, 96, 9, 2),
    "N120_W_odd": ((2,), 181, 163, 120, 120, 6, 2),
    "scalar_path": ((3,), 41, 37, 9, 33, 5, 2),
    "B1_L1": ((1,), 70, 66, 64, 64, 1, 2),
    "chunks": ((1,), 90, 93, 24, 20, 2 * K["kChunk"] + 37, 2),
    "whole_canvas": ((2,), 48, 64, 48, 64, 3, 1),
}


def _plan_inputs(name):
    lead, h, w, ny, nx, b, n_c = PLAN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lmodes = int(np.prod(lead))
    canvases = [rng.standard_normal((lmodes, h, w)).astype(np.float32) for _ in range(n_c)]
    stacks = [(rng.standard_normal((b, lmodes, ny, nx))
               * 10.0 ** rng.integers(-3, 4, (b, 1, 1, 1))).astype(np.float32)
              for _ in range(n_c)]
    pos = np.stack([rng.integers(-6, h - ny + 8, b), rng.integers(-6, w - nx + 8, b)],
                   -1).astype(np.int32)
    pos[min(1, b - 1)] = pos[0]                   # duplicate windows
    if b > 2:
        pos[-1] = [h - ny + 9, w - nx + 3]        # past the last corner
    return lead, canvases, stacks, pos


def test_scatter_threads_own_their_tile_once():
    """A B2 thread's register sums, over the block, cover the tile once."""
    ty, tx = _thread_map()
    owned = np.zeros((K["kTileRows"], K["kTileCols"]), int)
    np.add.at(owned, (ty, tx), 1)
    assert (owned == 1).all()


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_gather_plan_covers_each_output_once(name):
    lead, canvases, _, pos = _plan_inputs(name)
    ny, nx = PLAN_CASES[name][3:5]
    outs, writes = emulate_gather(canvases, pos, ny, nx)
    assert (writes == 1).all()
    for c, out in zip(canvases, outs):
        ref = tpatches.gather_plain(torch.from_numpy(c.reshape(*lead, *c.shape[-2:])),
                                    torch.from_numpy(pos), (ny, nx))
        np.testing.assert_array_equal(out.reshape(ref.shape), np_(ref))


def test_gather_plan_strides_over_windows_past_the_grid():
    """More (canvas, window) pairs than grid z: each block strides on, and
    every output is still written once (emulated with grid z cut to 7)."""
    _, canvases, _, pos = _plan_inputs("N96_W_odd")
    outs, writes = emulate_gather(canvases, pos, 96, 96, max_grid_z=7)
    assert (writes == 1).all()
    outs_unaligned, _ = emulate_gather(canvases, pos, 96, 96, vec_aligned=False)
    for x, y in zip(outs, outs_unaligned):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_scatter_plan_is_the_batch_order_sum(name):
    lead, canvases, stacks, pos = _plan_inputs(name)
    shape = canvases[0].shape
    out, writes, reads, orders = emulate_scatter(shape, stacks, pos)
    assert (writes == 1).all(), "a canvas element is written by no thread or by two"
    assert (reads == 1).all(), "a patch element is read by no thread or by two"
    assert all(np.all(np.diff(o) > 0) for o in orders), "a block walks its windows out of order"
    for stack, got in zip(stacks, out):
        ref = tpatches.scatter_add_plain((*lead, *shape[-2:]),
                                         torch.from_numpy(stack.reshape(stack.shape[0], *lead,
                                                                        *stack.shape[-2:])),
                                         torch.from_numpy(pos))
        np.testing.assert_array_equal(got.reshape(ref.shape).view(np.uint32),
                                      np_(ref).view(np.uint32))


def test_scatter_plain_is_a_batch_order_loop():
    """scatter_add_plain on the CPU is the sequential loop over b from a zero
    canvas, bit for bit (magnitudes 1e-3 to 1e3, duplicate and clamped
    windows): the sum B2 computes and the TPU kernel computed."""
    _, canvases, stacks, pos = _plan_inputs("N120_W_odd")
    lmodes, h, w = canvases[0].shape
    b, _, ny, nx = stacks[0].shape
    loop = np.zeros((lmodes, h, w), np.float32)
    for i, (y0, x0) in enumerate(_clamped(pos, h, w, ny, nx)):
        loop[:, y0:y0 + ny, x0:x0 + nx] += stacks[0][i]
    got = tpatches.scatter_add_plain((lmodes, h, w), torch.from_numpy(stacks[0]),
                                     torch.from_numpy(pos))
    np.testing.assert_array_equal(np_(got).view(np.uint32), loop.view(np.uint32))
