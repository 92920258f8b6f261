"""Scan-index selection and mini-batch grouping (host-side NumPy).

A copy of ptyrad_tpu/engine/batching.py, so a seeded batch plan is identical
in both packages: 'random' (a seeded shuffle split), 'compact' (scikit-learn's
MiniBatchKMeans over the scan positions, imported when asked for, empty
clusters dropped) and 'sparse' (the incremental max-min assignment seeded
at the compact centroids).

``pad_batches`` pads every batch to one length with repeated indices plus a
0/1 sample mask, so padded samples weigh nothing in the loss.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def select_scan_indices(
    n_scan_slow: int,
    n_scan_fast: int,
    subscan_slow: Optional[int] = None,
    subscan_fast: Optional[int] = None,
    mode: str = "full",
) -> np.ndarray:
    """Flattened scan indices for the chosen field of view."""
    n_scans = n_scan_slow * n_scan_fast
    if mode == "full":
        return np.arange(n_scans)

    if subscan_slow is None:
        subscan_slow = n_scan_slow // 2
    if subscan_fast is None:
        subscan_fast = n_scan_fast // 2

    if mode == "center":
        r0 = (n_scan_slow - subscan_slow) // 2
        c0 = (n_scan_fast - subscan_fast) // 2
        rows = np.arange(r0, r0 + subscan_slow)
        cols = np.arange(c0, c0 + subscan_fast)
        return (rows[:, None] * n_scan_fast + cols[None, :]).reshape(-1)

    if mode == "sub":
        full = np.arange(n_scans).reshape(n_scan_slow, n_scan_fast)
        rid = np.linspace(0, n_scan_slow - 1, num=subscan_slow, dtype=int)
        cid = np.linspace(0, n_scan_fast - 1, num=subscan_fast, dtype=int)
        rg, cg = np.meshgrid(rid, cid, indexing="ij")
        return full[rg, cg].reshape(-1)

    raise ValueError(f"Unknown indices mode '{mode}'; use 'full', 'center', or 'sub'")


def make_batches(
    indices: np.ndarray,
    pos: np.ndarray,
    batch_size: int,
    mode: str = "random",
    seed: Optional[int] = None,
) -> List[np.ndarray]:
    """Group `indices` into mini-batches of ~batch_size.

    pos: (N, 2) scan positions for ALL indices (used by compact/sparse).
    Every input index appears in exactly one batch.
    """
    indices = np.asarray(indices)
    if len(indices) > len(pos):
        raise ValueError(f"len(indices)={len(indices)} exceeds total positions {len(pos)}")
    if indices.max() >= len(pos):
        raise ValueError(f"Max index {indices.max()} out of range for {len(pos)} positions")

    num_batch = max(1, len(indices) // batch_size)

    if mode == "random":
        rng = np.random.default_rng(seed)
        shuffled = rng.permutation(indices)
        return list(np.array_split(shuffled, num_batch))

    if mode not in ("compact", "sparse"):
        raise ValueError(f"Unknown grouping mode '{mode}'; use 'random', 'compact', or 'sparse'")

    from sklearn.cluster import MiniBatchKMeans

    pos_s = np.asarray(pos)[indices]
    kmeans = MiniBatchKMeans(
        init="k-means++", n_init=10, n_clusters=num_batch, max_iter=10,
        batch_size=3072, random_state=seed,
    )
    kmeans.fit(pos_s)
    labels = kmeans.labels_
    compact = [indices[np.where(labels == b)[0]] for b in range(num_batch)]

    if mode == "compact":
        # k-means can leave clusters empty; pad_batches cannot handle a
        # zero-length batch (it replicates the first element) — drop them
        return [c for c in compact if len(c)]

    # 'sparse': greedy max-min-distance assignment seeded at compact centroids.
    # Complexity note: the straightforward version (reference
    # reconstruction.py:546-580) recomputes per-batch minima from an N x N
    # distance matrix inside a Python loop — >1 min at 128x128 scans. Here a
    # (num_batch, N) running min-distance table is updated incrementally on
    # each assignment, so every step is one vectorized argmax + one minimum.
    fallback = pos_s.mean(axis=0)  # k-means can leave clusters empty
    centroids = np.array(
        [np.mean(pos[c], axis=0) if len(c) else fallback for c in compact]
    )
    pos_all = np.asarray(pos, dtype=np.float32)

    def dist_row(i):
        return np.linalg.norm(pos_all - pos_all[i], axis=1)

    batches: List[List[int]] = []
    used = []
    mind = np.full((num_batch, len(pos_all)), np.inf, dtype=np.float32)
    # two centroids can resolve to the same nearest scan position; mask
    # already-claimed positions so every batch gets a distinct seed
    seed_dist = np.linalg.norm(pos_s[None] - centroids[:, None], axis=2)
    for b in range(num_batch):
        seed_pos = int(np.argmin(seed_dist[b]))
        seed_dist[:, seed_pos] = np.inf
        seed_idx = int(indices[seed_pos])
        batches.append([seed_idx])
        used.append(seed_pos)
        mind[b] = dist_row(seed_idx)
    remaining = np.delete(indices.copy(), used)

    for idx in remaining:
        b = int(np.argmax(mind[:, idx]))
        batches[b].append(int(idx))
        np.minimum(mind[b], dist_row(idx), out=mind[b])

    flat = np.sort(np.concatenate([np.asarray(b) for b in batches]))
    assert np.array_equal(flat, np.sort(indices)), "sparse grouping lost indices"
    return [np.asarray(b) for b in batches]


def pad_batches(
    batches: List[np.ndarray], multiple_of: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad every batch to one uniform length; return (indices, mask) arrays:
    idx (num_batch, L) int32 padded with each batch's first index, mask
    (num_batch, L) float32 with 1 for real samples and 0 for padding."""
    L = max(len(b) for b in batches)
    if multiple_of > 1:
        L = ((L + multiple_of - 1) // multiple_of) * multiple_of
    idx = np.zeros((len(batches), L), np.int32)
    mask = np.zeros((len(batches), L), np.float32)
    for i, b in enumerate(batches):
        idx[i, : len(b)] = b
        idx[i, len(b):] = b[0]
        mask[i, : len(b)] = 1.0
    return idx, mask
