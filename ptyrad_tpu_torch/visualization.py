"""Plotting: loss curves, forward-pass panels, probe modes, positions, tilts
(counterpart of ptyrad_tpu/visualization.py).

Feature parity with reference src/ptyrad/visualization.py (526 LoC):
plot_summary dispatches the selected figures, saved as PNG every SAVE_ITERS
with the JAX package's file names. The device work of the "forward" figure
is ``forward_panels`` (forward() takes its normal route, B4 at N <= 128 on
the card) and runs outside the guard that keeps a failed drawing from
ending a run; every drawing function takes NumPy arrays only. matplotlib is
imported inside the drawing functions with the Agg backend (headless-safe),
so importing this module does not load it.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.parallel.mesh import store_rows
from ptyrad_tpu_torch.utils.logging import vprint


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_sigmoid_mask(npix: int, relative_radius: float, relative_width: float, img=None, show_circles: bool = False):
    """Sigmoid-mask diagnostic: overlay + radial line profile (reference 14-41).
    The mask is ops/masks.make_sigmoid_mask's formula, in NumPy."""
    plt = _pyplot()
    gy, gx = np.mgrid[0:npix, 0:npix].astype(np.float64)
    kr = np.hypot(gy - npix // 2, gx - npix // 2)
    offset = npix * relative_radius / 2.0
    scale = relative_width * npix
    mask = 1.0 / (1.0 + np.exp((kr - offset) / scale * 10.0))
    base = np.ones((npix, npix)) if img is None else np.asarray(img) / np.max(img)
    masked = mask * base
    fig, axs = plt.subplots(1, 2, figsize=(13, 6))
    fig.suptitle(f"Sigmoid mask: radius={relative_radius}, width={relative_width}")
    im = axs[0].imshow(masked)
    axs[0].axhline(y=npix // 2, xmin=0.5, c="r", linestyle="--")
    axs[1].plot(mask[npix // 2, npix // 2:], c="r", label="mask")
    if img is not None:
        axs[1].plot(base[npix // 2, npix // 2:], label="image")
        axs[1].plot(masked[npix // 2, npix // 2:], label="masked")
    if show_circles:
        for rr in (relative_radius - relative_width, relative_radius + relative_width):
            axs[0].add_artist(plt.Circle((npix // 2, npix // 2), rr * npix / 2, color="k", fill=False, linestyle="--"))
            axs[1].axvline(x=rr * npix / 2, color="k", linestyle="--")
    fig.colorbar(im, shrink=0.7)
    axs[1].legend()
    return fig


def forward_panels(params, buffers, geom, indices, rows=None) -> dict:
    """The device work of the "forward" figure for a few scan indices, as
    NumPy arrays: ``probe_int`` (n, Ny, Nx) the probe intensity summed over
    modes, ``obja``/``objp`` (n, Nz, Ny, Nx) the object patches weighted by
    omode_occu and summed over object modes, ``model_dp`` (n, Ky, Kx) the
    forward() pattern and ``meas_dp`` the measured one (the JAX package's
    plot_forward_pass panels). No gradient is recorded. ``rows``: the
    indices' store rows, which a store split over ranks needs
    (get_measurements)."""
    from ptyrad_tpu_torch.models.forward import (forward, get_measurements, get_obj_patches,
                                                 get_probes)

    idx = torch.as_tensor(np.asarray(indices), device=params.obja.device)
    with torch.no_grad():
        probes = get_probes(params, geom, idx)
        probes_int = (probes.real ** 2 + probes.imag ** 2).sum(-3)
        dp, _ = forward(params, buffers, geom, idx)
        obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
        occu = buffers.omode_occu[:, None, None, None]
        obja_roi = (obja_p * occu).sum(1)
        objp_roi = (objp_p * occu).sum(1)
        meas = get_measurements(buffers, geom, idx, rows)
    probes_int = probes_int.cpu().numpy()
    if probes_int.shape[0] == 1:
        probes_int = np.broadcast_to(probes_int, (len(idx), *probes_int.shape[-2:]))
    return {"probe_int": probes_int, "obja": obja_roi.cpu().numpy(),
            "objp": objp_roi.cpu().numpy(), "model_dp": dp.cpu().numpy(),
            "meas_dp": meas.cpu().numpy()}


def draw_forward_pass(panels: dict, indices, dp_power: float = 0.5):
    """Panel of probe intensity / object amp / object phase / model DP / data
    DP per index (reference 43-96) from forward_panels' arrays."""
    plt = _pyplot()
    n = len(indices)
    fig, axs = plt.subplots(n, 5, figsize=(24, 5 * n), squeeze=False)
    fig.suptitle("Forward pass", fontsize=24)
    for i, index in enumerate(np.asarray(indices)):
        images = [
            (panels["probe_int"][i], f"Probe intensity idx{index}"),
            (panels["obja"][i].prod(0), f"Object amp (zprod) idx{index}"),
            (panels["objp"][i].sum(0), f"Object phase (zsum) idx{index}"),
            (panels["model_dp"][i] ** dp_power, f"Model DP^{dp_power} idx{index}"),
            (panels["meas_dp"][i] ** dp_power, f"Data DP^{dp_power} idx{index}"),
        ]
        for j, (img, title) in enumerate(images):
            im = axs[i, j].imshow(img)
            axs[i, j].set_title(title, fontsize=14)
            fig.colorbar(im, ax=axs[i, j], shrink=0.6)
    fig.tight_layout()
    return fig


def plot_forward_pass(params, buffers, geom, indices, dp_power: float = 0.5):
    """forward_panels, then draw_forward_pass."""
    return draw_forward_pass(forward_panels(params, buffers, geom, indices), indices, dp_power)


def plot_loss_curves(loss_iters, last_n_iters: int = 10):
    """Loss vs iteration with a zoomed inset of the last N iters (reference 294-326)."""
    plt = _pyplot()
    iters = np.array([n for n, _ in loss_iters])
    losses = np.array([v for _, v in loss_iters])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(iters, losses, "-o", ms=3)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Loss")
    ax.set_title("Loss curve")
    if len(iters) > last_n_iters > 1:
        inset = ax.inset_axes([0.45, 0.45, 0.5, 0.5])
        inset.plot(iters[-last_n_iters:], losses[-last_n_iters:], "-o", ms=3, color="tab:orange")
        inset.set_title(f"Last {last_n_iters} iters", fontsize=9)
    return fig


def plot_slice_thickness(dz_iters, last_n_iters: int = 10):
    """Optimized slice thickness vs iteration (reference 328-361)."""
    plt = _pyplot()
    iters = np.array([n for n, _ in dz_iters])
    dz = np.array([v for _, v in dz_iters])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(iters, dz, "-o", ms=3)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Slice thickness (Ang)")
    ax.set_title(f"Slice thickness (final: {dz[-1]:.4f} Ang)")
    if len(iters) > last_n_iters > 1:
        inset = ax.inset_axes([0.45, 0.45, 0.5, 0.5])
        inset.plot(iters[-last_n_iters:], dz[-last_n_iters:], "-o", ms=3, color="tab:orange")
    return fig


def plot_obj_tilts_avg(avg_tilt_iters, last_n_iters: int = 2):
    """Mean crystal tilt trajectory vs iteration (reference 98-144)."""
    plt = _pyplot()
    iters = np.array([n for n, _ in avg_tilt_iters])
    tilts = np.array([np.asarray(t).reshape(2) for _, t in avg_tilt_iters])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(iters, tilts[:, 0], "-o", ms=3, label="tilt_y")
    ax.plot(iters, tilts[:, 1], "-o", ms=3, label="tilt_x")
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Mean tilt (mrad)")
    ax.set_title(f"Mean object tilts (final: {tilts[-1].round(3)})")
    ax.legend()
    return fig


def plot_obj_tilts(pos, tilts, figsize=(16, 16)):
    """Quiver map of per-position tilts over the scan (reference 146-177)."""
    plt = _pyplot()
    pos = np.asarray(pos)
    tilts = np.asarray(tilts)
    fig, ax = plt.subplots(figsize=figsize)
    if tilts.shape[0] == 1:
        tilts = np.broadcast_to(tilts, (pos.shape[0], 2))
    ax.quiver(pos[:, 1], pos[:, 0], tilts[:, 1], tilts[:, 0], np.hypot(tilts[:, 0], tilts[:, 1]))
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_title("Per-position object tilts (mrad)")
    ax.set_xlabel("x (px)")
    ax.set_ylabel("y (px)")
    return fig


def plot_scan_positions(pos, init_pos=None, figsize=(16, 16), dot_scale=1.0, show_arrow=True):
    """Initial vs optimized scan positions (reference 179-217)."""
    plt = _pyplot()
    pos = np.asarray(pos)
    fig, ax = plt.subplots(figsize=figsize)
    if init_pos is not None:
        init_pos = np.asarray(init_pos)
        ax.scatter(init_pos[:, 1], init_pos[:, 0], s=10 * dot_scale, c="tab:gray", label="initial")
        if show_arrow:
            d = pos - init_pos
            ax.quiver(init_pos[:, 1], init_pos[:, 0], d[:, 1], d[:, 0],
                      angles="xy", scale_units="xy", scale=1, width=0.002, color="tab:red")
    ax.scatter(pos[:, 1], pos[:, 0], s=10 * dot_scale, c="tab:blue", label="optimized")
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("Scan positions")
    return fig


def plot_affine_transformation(scale, asymmetry, rotation, shear, n=8):
    """Visualize a scan-affine on a unit grid (reference 219-252)."""
    from ptyrad_tpu_torch.ops.affine import compose_affine_matrix

    plt = _pyplot()
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    grid = np.stack([ys.ravel(), xs.ravel()], 1).astype(float)
    grid -= grid.mean(0)
    out = grid @ compose_affine_matrix(scale, asymmetry, rotation, shear)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(grid[:, 1], grid[:, 0], c="tab:gray", label="original")
    ax.scatter(out[:, 1], out[:, 0], c="tab:blue", label="transformed")
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(f"Affine: scale={scale}, asym={asymmetry}, rot={rotation}, shear={shear}")
    return fig


def plot_pos_grouping(pos, batches, figsize=(16, 8), dot_scale=1.0):
    """Scan positions colored by batch for the first/last batch (reference 254-292)."""
    plt = _pyplot()
    pos = np.asarray(pos)
    fig, axs = plt.subplots(1, 2, figsize=figsize)
    for ax, b_idx, title in ((axs[0], 0, "first batch"), (axs[1], len(batches) - 1, "last batch")):
        ax.scatter(pos[:, 1], pos[:, 0], s=8 * dot_scale, c="lightgray")
        batch = np.asarray(batches[b_idx])
        ax.scatter(pos[batch, 1], pos[batch, 0], s=12 * dot_scale, c="tab:red")
        ax.invert_yaxis()
        ax.set_aspect("equal")
        ax.set_title(f"Grouping: {title} ({len(batch)} positions)")
    return fig


def plot_probe_modes(probe_np: np.ndarray, amp_or_phase: str = "amplitude", real_or_fourier: str = "real"):
    """Probe modes in real or Fourier space, amplitude or phase, with relative
    powers in the titles (reference 363-421)."""
    plt = _pyplot()
    probe = np.asarray(probe_np)
    if real_or_fourier == "fourier":
        probe = np.fft.fftshift(
            np.fft.fft2(np.fft.ifftshift(probe, axes=(-2, -1)), norm="ortho"),
            axes=(-2, -1),
        )
    if amp_or_phase == "amplitude":
        data = np.abs(probe)
    else:
        # reference convention (visualization.py:388-391): negative sign for
        # consistency with chi(k) (psi = exp(-i*chi); overfocus gives a
        # positive phase shift near the aperture edge), amplitude-weighted so
        # the meaningless random phases where |probe|~0 don't dominate
        data = -np.angle(probe) * np.abs(probe)
    powers = np.sum(np.abs(probe) ** 2, axis=(-2, -1))
    powers = powers / powers.sum()
    n = probe.shape[0]
    ncol = min(n, 4)
    nrow = (n + ncol - 1) // ncol
    fig, axs = plt.subplots(nrow, ncol, figsize=(5 * ncol, 5 * nrow), squeeze=False)
    cmap = "twilight" if amp_or_phase == "phase" else "viridis"
    for i in range(nrow * ncol):
        ax = axs[i // ncol, i % ncol]
        if i < n:
            im = ax.imshow(data[i], cmap=cmap)
            ax.set_title(f"mode {i}: {powers[i]:.1%}")
            fig.colorbar(im, ax=ax, shrink=0.7)
        else:
            ax.axis("off")
    fig.suptitle(f"Probe modes ({real_or_fourier} {amp_or_phase})", fontsize=18)
    return fig


ALL_FIGS = ["loss", "forward", "probe_r_amp", "probe_r_phase", "probe_k_amp", "probe_k_phase",
            "pos", "tilt", "tilt_avg", "dz"]
PROBE_FIGS = {"probe_r_amp": ("amplitude", "real"), "probe_r_phase": ("phase", "real"),
              "probe_k_amp": ("amplitude", "fourier"), "probe_k_phase": ("phase", "fourier")}


def plot_summary(
    output_path: str, params, buffers, geom, history, niter: int, indices,
    selected_figs: Optional[List[str]] = None, init_variables: Optional[dict] = None,
    collate_str: str = "", save_fig: bool = True,
) -> list:
    """Save the selected figures as summary_{name}{collate_str}_iterNNNN.png
    (reference 423-526); returns the names saved.

    selected_figs options: 'loss', 'forward', 'probe_r_amp', 'probe_r_phase',
    'probe_k_amp', 'probe_k_phase', 'pos', 'tilt', 'tilt_avg', 'dz'; 'all'
    enables every one and 'slice_thickness' names 'dz' (reference
    visualization.py:438-518). ('group' is a preparation-time figure saved
    once by the workflow, not a per-iteration summary.) The "forward"
    figure's forward_panels runs first, outside the guard: a failure there
    raises. A failure while drawing or saving (matplotlib missing, say) only
    warns: plotting never ends a run. When the store is split over ranks
    (buffers.store_split), the figure's measured patterns are read from
    init_variables' whole store, which is then required.
    """
    selected = list(selected_figs or ["loss", "forward", "probe_r_amp", "pos"])
    if "all" in selected:
        selected = list(ALL_FIGS)
    selected = ["dz" if s == "slice_thickness" else s for s in selected]
    iter_str = f"_iter{str(niter).zfill(4)}"
    show_idx = np.asarray(indices)[:2]
    panels = None
    if "forward" in selected:
        rows = None
        if buffers.store_split is not None:
            if init_variables is None:
                raise ValueError("plot_summary: the measurement store is split over ranks; "
                                 "pass init_variables, whose store the forward figure reads")
            rows = store_rows(init_variables["measurements"], show_idx, buffers.measurements)
        panels = forward_panels(params, buffers, geom, show_idx, rows)
    probe_np = params.probe.detach().cpu().numpy()
    pos_now = buffers.crop_pos.cpu().numpy() + params.probe_pos_shifts.detach().cpu().numpy()
    tilts = params.obj_tilts.detach().cpu().numpy()

    saved = []
    try:
        plt = _pyplot()
        os.makedirs(output_path, exist_ok=True)

        def save(fig, name):
            if save_fig:
                fig.savefig(os.path.join(output_path, f"summary_{name}{collate_str}{iter_str}.png"), dpi=100)
            plt.close(fig)
            saved.append(name)

        if "loss" in selected and history.loss_iters:
            save(plot_loss_curves(history.loss_iters), "loss")
        if panels is not None:
            save(draw_forward_pass(panels, show_idx), "forward")
        for key, (aop, rof) in PROBE_FIGS.items():
            if key in selected:
                save(plot_probe_modes(probe_np, aop, rof), key)
        if "pos" in selected:
            init_pos = None
            if init_variables is not None:
                init_pos = np.asarray(init_variables["crop_pos"]) + np.asarray(init_variables["probe_pos_shifts"])
            save(plot_scan_positions(pos_now, init_pos=init_pos), "pos")
        if "tilt" in selected and tilts.shape[0] > 1:
            save(plot_obj_tilts(pos_now, tilts), "tilt")
        if "tilt_avg" in selected and history.avg_tilt_iters:
            save(plot_obj_tilts_avg(history.avg_tilt_iters), "tilt_avg")
        if "dz" in selected and history.dz_iters:
            save(plot_slice_thickness(history.dz_iters), "dz")
    except Exception as e:  # noqa: BLE001 — plotting must never kill a run
        vprint(f"WARNING: plot_summary failed at iter {niter} after {saved}: {e}")
        return saved
    skipped = [s for s in selected if s not in saved]
    vprint(f"Saved summary figures {saved} at iter {niter}"
           + (f" (no data / not applicable: {skipped})" if skipped else ""))
    return saved


def save_grouping_figure(output_path: str, pos, batch_idx, batch_mask) -> bool:
    """summary_grouping.png in output_path: the first and last batch of the
    padded plan (reference prepare_recon -> plot_pos_grouping,
    reconstruction.py:430-437). A failure only warns; returns whether the
    file was written."""
    try:
        plt = _pyplot()
        batches = [row[m > 0] for row, m in zip(batch_idx, batch_mask)]
        fig = plot_pos_grouping(np.asarray(pos), batches)
        fig.savefig(os.path.join(output_path, "summary_grouping.png"), dpi=100)
        plt.close(fig)
        return True
    except Exception as e:  # noqa: BLE001 — plotting must never kill a run
        vprint(f"WARNING: grouping figure failed: {e}")
        return False
