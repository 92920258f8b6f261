"""The general generator: a configuration and a traffic file, with a seed,
become the program's params and its init_variables.

The measured patterns are simulated by the reference's own model from a
seeded ground-truth phase object and the configuration's probe at the
scan's jittered positions, cropped and normalised to a maximum of one as
the configuration states; the background of an on-the-fly pad is fitted
here. The object the reconstruction starts from is seeded too. Every random
draw is made on ``device`` by one ``torch.Generator`` in a few large calls,
so one seed gives the same inputs, and every seed the same sizes.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from benchmark.reference import model, physics

SEED_SALT = 0x5EED  # the batches' seed is the run's seed xor this


def _smooth_field(gen, shape, sigma_px: float, device) -> torch.Tensor:
    """Gaussian-filtered white noise of unit standard deviation."""
    noise = torch.randn(shape, generator=gen, device=device)
    fy = torch.fft.fftfreq(shape[-2], device=device)[:, None]
    fx = torch.fft.fftfreq(shape[-1], device=device)[None, :]
    filt = torch.exp(-2.0 * math.pi ** 2 * sigma_px ** 2 * (fy ** 2 + fx ** 2))
    field = torch.fft.ifft2(torch.fft.fft2(noise) * filt).real
    return field / field.std()


def scan(phys: dict, dx: float, jitter_ang: torch.Tensor):
    """(corners (S, 2) int32, shifts (S, 2) float32, canvas side) of the
    raster at pixel dx with the given jitter [Ang], 4 px from the edge."""
    ns, nf = phys["n_scan"]
    ys, xs = np.meshgrid(np.arange(ns), np.arange(nf), indexing="ij")
    ang = np.stack([ys.ravel(), xs.ravel()], -1) * float(phys["step_ang"]) + jitter_ang
    pos = (ang - ang.min(0)) / dx + 4.0
    corners = np.round(pos).astype(np.int32)
    side = int(corners.max()) + 1 + int(phys["npix"] * phys["dx"] / dx) + 8
    return corners, (pos - corners).astype(np.float32), side


def used_positions(phys: dict, recon: dict) -> np.ndarray:
    """The scan indices the run trains on (INDICES_MODE full or center)."""
    ns, nf = phys["n_scan"]
    im = recon.get("INDICES_MODE") or {"mode": "full"}
    if im.get("mode", "full") == "full":
        return np.arange(ns * nf)
    if im["mode"] != "center":
        raise NotImplementedError(f"INDICES_MODE {im['mode']}")
    s, f = int(im["subscan_slow"]), int(im["subscan_fast"])
    r0, c0 = (ns - s) // 2, (nf - f) // 2
    return ((np.arange(r0, r0 + s)[:, None] * nf) + np.arange(c0, c0 + f)[None, :]).ravel()


def make_inputs(config: dict, traffic: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, init_variables) of one run: the configuration's params with
    the traffic's changes to them, and the inputs drawn from ``seed``."""
    dev = torch.device(device)
    phys = config["physics"]
    params = copy.deepcopy(config["params"])
    for section, values in traffic.get("params", {}).items():
        params.setdefault(section, {}).update(copy.deepcopy(values))
    params["recon_params"]["GROUP_MODE_SEED"] = int(seed) ^ SEED_SALT
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    n_sim, dx_sim = int(phys["npix"]), float(phys["dx"])
    n = int(phys.get("pad_target") or n_sim)
    dx = dx_sim * n_sim / n
    lam = physics.wavelength(float(phys["kv"]))
    n_scans = int(np.prod(phys["n_scan"]))
    jitter = (torch.randn((n_scans, 2), generator=gen, device=dev)
              * float(phys["pos_rand_std_px"]) * dx).double().cpu().numpy()
    corners_sim, shifts_sim, side_sim = scan(phys, dx_sim, jitter)
    corners, shifts, side = scan(phys, dx, jitter)

    # the ground truth, a phase object at the simulation's pixel
    truth = config["truth"]
    nz = int(phys["nz"])
    layers = 1 if truth.get("columnar") else nz
    phase = float(truth["phase_rad"]) * _smooth_field(
        gen, (layers, side_sim, side_sim), float(truth["sigma_px"]), dev).abs()
    phase = phase.expand(nz, side_sim, side_sim)[None]
    amp = torch.ones_like(phase)
    probe_sim = torch.as_tensor(physics.mixed_probe(
        physics.stem_probe(phys["kv"], phys["conv_angle"], n_sim, dx_sim, phys["defocus"]),
        int(phys["pmode"]), phys["pmode_pows"]), device=dev)
    h_sim = torch.as_tensor(physics.propagator(n_sim, dx_sim, float(phys["dz"]), lam),
                            device=dev)
    used = used_positions(phys, params["recon_params"])
    crop = phys.get("crop")
    lo, hi = (crop if crop else (0, n_sim))
    meas = np.zeros((n_scans, hi - lo, hi - lo), np.float32)
    occu = torch.ones(1, device=dev)
    step = int(config.get("sim_batch", 256))
    with torch.no_grad():
        for i in range(0, len(used), step):
            rows = torch.as_tensor(used[i:i + step], device=dev)
            at = torch.as_tensor(corners_sim, device=dev)[rows]
            dp = model.far_field(model.gather(amp, at, n_sim), model.gather(phase, at, n_sim),
                                 model.shifted_probes(probe_sim, torch.as_tensor(
                                     shifts_sim, device=dev)[rows]), h_sim, occu, 0.0)
            meas[used[i:i + step]] = dp[:, lo:hi, lo:hi].cpu().numpy()
    meas /= meas.max()

    init = {"measurements": meas}
    avg_sum = float(meas[used].mean(0).sum())
    if n != hi - lo:
        bg, idx = physics.pad_background(meas[used], n, float(phys["pad_threshold"]))
        init.update(on_the_fly_meas_padded=bg, on_the_fly_meas_padded_idx=idx)
        avg_sum += float(bg.sum())
    probe = physics.mixed_probe(
        physics.stem_probe(phys["kv"], phys["conv_angle"], n, dx, phys["defocus"]),
        int(phys["pmode"]), phys["pmode_pows"])
    probe = (probe * np.sqrt(avg_sum / np.sum(np.abs(probe) ** 2))).astype(np.complex64)

    start = config["start_object"]
    shape = (1, nz, side, side)
    a0 = 1.0 + float(start["amp_std"]) * torch.randn(shape, generator=gen, device=dev)
    p0 = float(start["phase_std"]) * torch.randn(shape, generator=gen, device=dev)
    obj = torch.polar(a0, p0).cpu().numpy()
    init.update(
        obj=obj, probe=probe, probe_pos_shifts=shifts, obj_tilts=np.zeros((1, 2), np.float32),
        slice_thickness=float(phys["dz"]), crop_pos=corners,
        omode_occu=np.ones(1, np.float32), dx=dx, lambd=lam,
        N_scan_slow=int(phys["n_scan"][0]), N_scan_fast=int(phys["n_scan"][1]))
    return params, init
