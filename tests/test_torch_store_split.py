"""The measurement store split over ranks (recon_params.shard_measurements,
ptyrad_tpu_torch.parallel.mesh): gloo ranks on the CPU.

The ranks run tests/torch_split_worker.py's cases, every case of a world
from one start of its ranks. Each rank keeps rows [r M/n, (r+1) M/n) of the
store zero-padded to M = n ceil(N/n) rows, and one all_to_all_single per
batch gives it the rows of its slice. Held here:

- the exchange equals the whole store's rows of the rank's slice
  (store[idx][rank_slice]), bit for bit, for random index patterns,
  repeated indices, padded slots and a batch from one rank's block, for a
  store that splits evenly, one that does not and one smaller than a
  batch, in each store type; each block holds ceil(N/n) rows;
- a 3-iteration Adam run and a 2-iteration LBFGS run, and Adam with the
  on-the-fly pad and with a bfloat16 store, are the replicated store's run
  of the same ranks bit for bit (losses, parameters after every
  iteration);
- the first batch's loss and gradients on 2 ranks against the JAX
  package's split store on make_mesh(2) (shard_model(...,
  shard_measurements=True)): the loss at rtol 1e-5 and the gradients at
  the JAX mesh tests' tolerances (tests/test_engine.py:816-921), as
  tests/test_torch_dist.py holds the replicated store.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptyrad_tpu.losses import combined_loss as j_combined_loss
from ptyrad_tpu.models import forward as j_forward
from ptyrad_tpu.models import get_measurements as j_get_measurements
from ptyrad_tpu.models import make_model as j_make_model
from ptyrad_tpu.parallel.mesh import data_sharding, make_mesh
from ptyrad_tpu.parallel.mesh import shard_model as j_shard_model
from torch_dist_worker import GRAD_NAMES, grads_problem
from torch_port_helpers import free_port, spawn_ranks
from torch_split_worker import EXCHANGE_PATTERNS, EXCHANGE_SHAPES, VARIANTS

TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 180
GRAD_ATOL = {"obja": 1e-5, "objp": 1e-5, "probe": 5e-5, "probe_pos_shifts": 1e-7}
DTYPES = ("bfloat16", "float16", "float32")
WORLDS = (2, 4)


def run_ranks(tmp: Path, world: int, cases: list) -> list:
    """Start ``world`` ranks running ``cases``; outs[case][rank]."""
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, str(TESTS / "torch_split_worker.py"), str(r),
                           str(world), str(port), str(tmp), json.dumps(cases)],
                world, tmp, RANK_TIMEOUT_S, f"{world} split-store ranks")
    return [[dict(np.load(tmp / f"case{i}_{r}.npz")) for r in range(world)]
            for i in range(len(cases))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case of each world from one start of its ranks: the exchange
    cases, each training variant and (2 ranks) the JAX comparison's batch."""
    out = {}

    def get(world: int) -> dict:
        if world not in out:
            cases = ([["exchange", {}]] + [["train", {"name": v}] for v in VARIANTS]
                     + ([["grads", {"route": "fused", "batch": 0}]] if world == 2 else []))
            outs = run_ranks(tmp_path_factory.mktemp(f"split{world}"), world, cases)
            names = ["exchange", *VARIANTS] + (["grads"] if world == 2 else [])
            out[world] = dict(zip(names, outs))
        return out[world]

    return get


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", EXCHANGE_PATTERNS)
@pytest.mark.parametrize("shape", EXCHANGE_SHAPES, ids=[f"N{n}-per{p}" for n, p in EXCHANGE_SHAPES])
def test_exchange_gives_the_whole_stores_rows_of_the_slice(worlds, world, dtype, pattern, shape):
    key = f"{shape[0]}_{pattern}_{dtype}"
    for r, out in enumerate(worlds(world)["exchange"]):
        assert str(out[f"dtype_{key}"]) == f"torch.{dtype}"
        assert out[f"got_{key}"].shape == (shape[1], 4, 3)
        np.testing.assert_array_equal(out[f"got_{key}"], out[f"want_{key}"],
                                      err_msg=f"rank {r} of {world}, {key}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_rows", [n for n, _ in EXCHANGE_SHAPES])
def test_each_block_holds_ceil_n_over_world_rows(worlds, world, n_rows):
    for out in worlds(world)["exchange"]:
        for dtype in DTYPES:
            assert int(out[f"block_rows_{n_rows}_{dtype}"]) == -(-n_rows // world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", VARIANTS)
def test_split_store_run_is_the_replicated_run_bit_for_bit(worlds, world, name):
    outs = worlds(world)[name]
    niter = 2 if name == "lbfgs" else 3
    for r, out in enumerate(outs):
        # 11 patterns: ceil(11 / n) rows a rank, against all 11 replicated
        assert int(out["split_store_rows"]) == -(-11 // world)
        assert int(out["replicated_store_rows"]) == 11
        want = "torch.bfloat16" if name == "bf16" else "torch.float32"
        assert str(out["split_store_dtype"]) == str(out["replicated_store_dtype"]) == want
        assert len(out["split_losses"]) == niter and np.all(np.isfinite(out["split_losses"]))
        np.testing.assert_array_equal(out["split_losses"], out["replicated_losses"],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["split_digests"], out["replicated_digests"],
                                      err_msg=f"rank {r}")
        for pname in ("obja", "objp", "probe", "probe_pos_shifts"):
            np.testing.assert_array_equal(out[f"split_{pname}"], out[f"replicated_{pname}"])
        np.testing.assert_array_equal(out["split_digests"], outs[0]["split_digests"])


def jax_split_store_grads(idx: np.ndarray, mask: np.ndarray) -> dict:
    """jax.value_and_grad of forward + combined_loss on make_mesh(2), the
    store split over the devices (shard_model(shard_measurements=True):
    zero-padded to a multiple of 2, sharded along the scan axis)."""
    init, params = grads_problem("fused")
    jp, jb, jg = j_make_model(init, params["model_params"])
    mesh = make_mesh(2)
    jp, jb = j_shard_model(jp, jb, mesh, shard_measurements=True)
    assert jb.measurements.shape[0] % 2 == 0
    idx_s = jax.device_put(jnp.asarray(idx), data_sharding(mesh))
    mask_s = jax.device_put(jnp.asarray(mask), data_sharding(mesh))

    def loss(p):
        dp, (oa, op) = j_forward(p, jb, jg, idx_s)
        meas = j_get_measurements(jb, jg, idx_s)
        total, _ = j_combined_loss(dp, meas, oa, op, jb.omode_occu, params["loss_params"], mask_s)
        return total

    total, g = jax.jit(jax.value_and_grad(loss))(jp)
    return {"total": float(total), "obja": np.asarray(g.obja), "objp": np.asarray(g.objp),
            "probe": np.stack([np.asarray(g.probe.re), np.asarray(g.probe.im)], -1),
            "probe_pos_shifts": np.asarray(g.probe_pos_shifts)}


def test_first_batch_matches_the_jax_split_store(worlds):
    """37 patterns split 19 + 19 (one padding row); the first padded batch
    of 14 on 2 ranks, each fetching its 7 rows."""
    outs = worlds(2)["grads"]
    ref = jax_split_store_grads(outs[0]["idx"], outs[0]["mask"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["total"], ref["total"], rtol=1e-5, err_msg=f"rank {r}")
        got = {**out, "probe": np.stack([out["probe"].real, out["probe"].imag], -1)}
        for name in GRAD_NAMES:
            np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=GRAD_ATOL[name],
                                       err_msg=f"rank {r}: gradient of {name}")


def test_a_split_store_refuses_a_read_without_its_rows():
    """get_measurements on a rank's block without the exchanged rows would
    read other rows silently; it raises instead."""
    import dataclasses

    from ptyrad_tpu_torch.models import get_measurements, make_model
    from ptyrad_tpu_torch.parallel import StoreSplit
    from torch_port_helpers import small_dataset

    _, buffers, geom = make_model(small_dataset(), None, device="cpu")
    split = dataclasses.replace(buffers, store_split=StoreSplit(rank=1, world=2, rows=6,
                                                                n_rows=11))
    with pytest.raises(ValueError, match="split over ranks"):
        get_measurements(split, geom, torch.arange(3))
    rows = buffers.measurements[torch.arange(3)]
    np.testing.assert_array_equal(get_measurements(split, geom, torch.arange(3), rows).numpy(),
                                  get_measurements(buffers, geom, torch.arange(3)).numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_store_rows_convert_as_the_split_store(dtype):
    """The rows a figure reads from the Initializer's whole store equal the
    split store's rows of the same indices, in its type (float16 clipped
    alike)."""
    from ptyrad_tpu_torch.parallel import StoreSplit, split_store, store_rows

    meas = np.random.default_rng(0).standard_normal((9, 4, 3)).astype(np.float32) * 4e4
    split = StoreSplit(rank=1, world=2, rows=5, n_rows=9)
    block = split_store(meas, split, torch.device("cpu"), dtype)
    idx = np.array([5, 8, 6])
    for store in (meas, torch.as_tensor(meas)):
        rows = store_rows(store, idx, block)
        assert rows.dtype == block.dtype
        np.testing.assert_array_equal(rows.float().numpy(), block[idx - 5].float().numpy())
    assert not block[4:].float().any()  # the padding row
