"""Scan-index selection and mini-batch grouping (host-side NumPy).

A copy of ptyrad_tpu/engine/batching.py, so a seeded batch plan is identical
in both packages. Grouping mode 'random' is ported; 'compact' and 'sparse'
(k-means based) wait for ROADMAP queue A.

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
    """Group `indices` into mini-batches of ~batch_size (shuffle-split).
    Every input index appears in exactly one batch."""
    indices = np.asarray(indices)
    if len(indices) > len(pos):
        raise ValueError(f"len(indices)={len(indices)} exceeds total positions {len(pos)}")
    if indices.max() >= len(pos):
        raise ValueError(f"Max index {indices.max()} out of range for {len(pos)} positions")
    if mode in ("compact", "sparse"):
        raise NotImplementedError(
            f"grouping mode '{mode}' waits for ROADMAP queue A; use 'random'")
    if mode != "random":
        raise ValueError(f"Unknown grouping mode '{mode}'; use 'random', 'compact', or 'sparse'")

    num_batch = max(1, len(indices) // batch_size)
    rng = np.random.default_rng(seed)
    shuffled = rng.permutation(indices)
    return list(np.array_split(shuffled, num_batch))


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
