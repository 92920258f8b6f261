"""compact and sparse grouping (engine/batching.make_batches): the port's
copy of the JAX package's, MiniBatchKMeans of scikit-learn imported when
asked for. For the same seed the batches equal the JAX package's exactly
(index for index, in order), and they keep the contract of
tests/test_engine.py:90-160: every index in exactly one batch, no batch
empty (degenerate positions included), compact batches tighter than random
ones and sparse ones wider than compact ones. Then the solver with each
grouping against the JAX package's.
"""

import numpy as np
import pytest

from ptyrad_tpu.engine.batching import make_batches as j_make_batches
from ptyrad_tpu_torch.engine.batching import make_batches, pad_batches
from torch_port_helpers import both_solvers, losses, small_dataset, small_params


def positions(seed, n=128):
    return np.random.default_rng(seed).random((n, 2)) * 100


@pytest.mark.parametrize("mode", ["compact", "sparse"])
@pytest.mark.parametrize("seed, n, batch, subset", [(0, 64, 8, False), (1, 128, 16, False),
                                                    (2, 100, 7, True), (3, 200, 32, True)])
def test_batches_equal_jax(mode, seed, n, batch, subset):
    pos = positions(seed, n)
    indices = np.sort(np.random.default_rng(seed).choice(n, n * 3 // 4, replace=False)) \
        if subset else np.arange(n)
    ours = make_batches(indices, pos, batch, mode=mode, seed=seed)
    ref = j_make_batches(indices, pos, batch, mode=mode, seed=seed)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    flat = np.sort(np.concatenate(ours))
    np.testing.assert_array_equal(flat, np.sort(indices))
    assert all(len(b) for b in ours)


@pytest.mark.parametrize("mode", ["compact", "sparse"])
def test_degenerate_positions_no_empty_batches(mode):
    """All positions equal: k-means collapses its clusters; compact drops
    the empty ones, sparse still seeds every batch with its own index."""
    batches = make_batches(np.arange(16), np.zeros((16, 2)), 4, mode=mode, seed=0)
    assert all(len(b) for b in batches)
    np.testing.assert_array_equal(np.sort(np.concatenate(batches)), np.arange(16))
    idx, _ = pad_batches(batches)
    assert np.isfinite(idx).all()


def test_compact_is_tight_and_sparse_is_spread():
    pos = positions(5)
    indices = np.arange(128)

    def mean_spread(batches):
        return np.mean([np.linalg.norm(pos[b] - pos[b].mean(0), axis=1).mean() for b in batches])

    def min_intra_dist(batches):
        vals = []
        for b in batches:
            if len(b) > 1:
                d = np.linalg.norm(pos[b][:, None] - pos[b][None], axis=-1)
                np.fill_diagonal(d, np.inf)
                vals.append(d.min())
        return np.mean(vals)

    compact = make_batches(indices, pos, 16, mode="compact", seed=0)
    random_b = make_batches(indices, pos, 16, mode="random", seed=0)
    sparse = make_batches(indices, pos, 16, mode="sparse", seed=0)
    assert mean_spread(compact) < 0.6 * mean_spread(random_b)
    assert min_intra_dist(sparse) > min_intra_dist(compact)
    assert mean_spread(sparse) > mean_spread(compact)


@pytest.mark.parametrize("mode", ["compact", "sparse"])
def test_solver_with_grouping_matches_jax(mode):
    """The small tBL run grouped by each mode: the same batches and the
    losses of 2 iterations at rtol 1e-4 against the JAX package's."""
    params = small_params({"name": "Adam"}, niter=2)
    params["recon_params"]["GROUP_MODE"] = mode
    js, ts = both_solvers(params, small_dataset())
    js.run()
    ts.run()
    np.testing.assert_array_equal(ts.batch_idx, js.batch_idx)
    np.testing.assert_allclose(losses(ts), losses(js), rtol=1e-4)
