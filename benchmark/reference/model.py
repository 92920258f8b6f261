"""The plain reference of a training step: mixed-state multislice
ptychography in plain PyTorch, as the published model states it.

Each scan position crops a probe-sized window out of the object canvases
(amplitude and phase, (omode, nz, H, W)) at its integer corner; the probe
modes are shifted by the position's sub-pixel shift with a Fourier ramp;
the wave crosses each slice (times a exp(i phi)) and propagates between
slices by the angular-spectrum propagator; the exit wave goes to the
detector by an orthonormal 2-D FFT, and the modes add in intensity. The
loss is loss_single (NRMSE of dp^p against the measurement, with the
measurement padded on the fly into a fitted background) plus, where the
configuration states it, loss_sparse (the mean of |phi|^n over the batch's
patches, to the 1/n). Adam updates the tensors with a nonzero learning rate
once their start iteration has come, then the configuration's constraints
run in the published order.

``run_steps`` follows a program through its first steps on the same
inputs and batches, numbered from a given iteration, and gives each step's
loss, the first step's gradient norms, the parameters' change norms and
the probe's change by two readings that no mixing of its modes moves
(``probe_readings``). A batch is computed in blocks of
rows: a first pass without gradients gives loss_single's sums over the
whole batch, a second pass back-propagates each block with the factor that
those sums fix, so a block's graph is all that is alive at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import physics

LEAVES = ("obja", "objp", "probe", "probe_pos_shifts")
CONSTRAINT_ORDER = ("ortho_pmode", "probe_mask_k", "fix_probe_int", "obj_rblur", "obj_zblur",
                    "kr_filter", "kz_filter", "complex_ratio", "mirrored_amp", "obja_thresh",
                    "objp_postiv", "tilt_smooth")


def norm(x: torch.Tensor) -> float:
    """The 2-norm summed in float64 (a float32 sum over tens of millions of
    elements drifts by parts in a thousand)."""
    return float(torch.linalg.vector_norm(x.to(torch.complex128 if x.is_complex()
                                                else torch.float64)))


def expi(phi: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(phi), torch.sin(phi))


def gather(canvas: torch.Tensor, corners: torch.Tensor, n: int) -> torch.Tensor:
    """(B, omode, nz, n, n) windows of an (omode, nz, H, W) canvas at the
    (B, 2) corners, each clamped into the canvas."""
    h, w = canvas.shape[-2:]
    y = corners[:, 0].long().clamp(0, h - n)
    x = corners[:, 1].long().clamp(0, w - n)
    ar = torch.arange(n, device=canvas.device)
    iy = (y[:, None] + ar)[:, :, None]
    ix = (x[:, None] + ar)[:, None, :]
    return canvas[:, :, iy, ix].movedim(2, 0)


def shifted_probes(probe: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(B, pmode, n, n): the probe modes moved by (B, 2) sub-pixel shifts
    (y, x) [px] with the ramp exp(-2 pi i (sy fy + sx fx))."""
    n = probe.shape[-1]
    f = torch.fft.fftfreq(n, device=probe.device, dtype=torch.float32)
    ramp = -2.0 * math.pi * (shifts[:, 0, None, None] * f[:, None]
                             + shifts[:, 1, None, None] * f[None, :])
    return torch.fft.ifft2(torch.fft.fft2(probe)[None] * expi(ramp)[:, None])


def far_field(obja_p, objp_p, probes, h, occu, eps: float) -> torch.Tensor:
    """(B, n, n) pattern: the multislice exit waves of every probe and
    object mode, to the detector, summed in intensity, plus eps."""
    psi = probes[:, :, None]                      # (B, pmode, 1, n, n)
    nz = obja_p.shape[2]
    for z in range(nz):
        psi = psi * torch.complex(obja_p[:, :, z] * torch.cos(objp_p[:, :, z]),
                                  obja_p[:, :, z] * torch.sin(objp_p[:, :, z]))[:, None]
        if z < nz - 1:
            psi = torch.fft.ifft2(h * torch.fft.fft2(psi))
    psi_k = torch.fft.fftshift(torch.fft.fft2(psi, norm="ortho"), dim=(-2, -1))
    inten = psi_k.real ** 2 + psi_k.imag ** 2     # (B, pmode, omode, n, n)
    return (inten * occu[:, None, None]).sum(dim=(1, 2)) + eps


def probe_readings(probe: torch.Tensor) -> dict:
    """Readings of a (pmode, n, n) mixed-state probe that a unitary mixing
    of its modes leaves as they are: the intensity map sum_k |P_k|^2, and
    each mode's power, largest first (after ortho_pmode the eigenvalues of
    the modes' Gram matrix), in float64 on the host."""
    pr = probe.detach().to(torch.complex128)
    inten = pr.real ** 2 + pr.imag ** 2
    return {"intensity": inten.sum(0).cpu(),
            "powers": torch.sort(inten.sum(dim=(1, 2)), descending=True).values.cpu()}


def probe_change(before: dict, after: dict) -> dict:
    """The norms of the change of each of ``probe_readings``."""
    return {f"probe.{k}": float(torch.linalg.vector_norm(after[k] - before[k]))
            for k in before}


class Reference:
    """The model's inputs on ``device`` and the configuration's loss,
    optimizer and constraints; ``run_steps`` trains a copy of the inputs."""

    def __init__(self, inputs: dict, params: dict, device, block: int):
        self.dev = torch.device(device)
        self.block = int(block)
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=self.dev)  # noqa: E731
        obj = np.asarray(inputs["obj"])
        self.init = {"obja": t(np.abs(obj)), "objp": t(np.angle(obj)),
                     "probe": t(inputs["probe"], torch.complex64),
                     "probe_pos_shifts": t(inputs["probe_pos_shifts"])}
        self.corners = torch.as_tensor(np.asarray(inputs["crop_pos"]), device=self.dev)
        self.occu = t(inputs["omode_occu"])
        self.n = int(self.init["probe"].shape[-1])
        lam, dx = float(inputs["lambd"]), float(inputs["dx"])
        self.h = t(physics.propagator(self.n, dx, float(inputs["slice_thickness"]), lam),
                   torch.complex64)
        self.meas = inputs["measurements"]
        pad = inputs.get("on_the_fly_meas_padded")
        self.pad = None if pad is None else (t(pad), [int(i) for i in
                                                       inputs["on_the_fly_meas_padded_idx"]])
        self.eps = 1e-10
        mp = params.get("model_params", {}) or {}
        self.update = {k: dict(v or {}) for k, v in (mp.get("update_params") or {}).items()}
        opt = mp.get("optimizer_params", {}) or {}
        if opt.get("name", "Adam") != "Adam":
            raise NotImplementedError(f"the reference runs Adam, not {opt.get('name')}")
        cfg = opt.get("configs", {}) or {}
        self.betas = (float(cfg.get("b1", 0.9)), float(cfg.get("b2", 0.999)))
        self.adam_eps = float(cfg.get("eps", 1e-8))
        lp = params.get("loss_params", {}) or {}
        for name, term in lp.items():
            if term.get("state") and name not in ("loss_single", "loss_sparse"):
                raise NotImplementedError(f"the reference has no {name}")
        self.single = lp.get("loss_single", {"state": True, "weight": 1.0, "dp_pow": 0.5})
        self.sparse = lp.get("loss_sparse") or {"state": False}
        self.constraints = {k: dict(v or {}) for k, v in
                            (params.get("constraint_params") or {}).items()
                            if (v or {}).get("freq") is not None}
        unknown = set(self.constraints) - set(CONSTRAINT_ORDER)
        if unknown:
            raise NotImplementedError(f"unknown constraints {sorted(unknown)}")

    # -- the loss --------------------------------------------------------

    def lr(self, name: str) -> float:
        return float(self.update.get(name, {}).get("lr", 0) or 0)

    def started(self, name: str, niter: int) -> bool:
        start = self.update.get(name, {}).get("start_iter")
        return self.lr(name) != 0 and start is not None and niter >= int(start)

    def measured(self, idx: torch.Tensor) -> torch.Tensor:
        rows = torch.as_tensor(self.meas[idx.cpu().numpy()], dtype=torch.float32,
                               device=self.dev)
        if self.pad is None:
            return rows
        bg, (h1, h2, w1, w2) = self.pad
        out = bg.expand(rows.shape[0], *bg.shape).clone()
        out[:, h1:h2, w1:w2] = rows
        return out

    def block_sums(self, p: dict, idx: torch.Tensor, mask: torch.Tensor):
        """The block's sums: (sum of mask (dp^q - m^q)^2, sum of mask m^q,
        per object mode the sum of mask |phi|^order over the patches)."""
        q = float(self.single.get("dp_pow", 0.5))
        obja_p = gather(p["obja"], self.corners[idx], self.n)
        objp_p = gather(p["objp"], self.corners[idx], self.n)
        probes = shifted_probes(p["probe"], p["probe_pos_shifts"][idx])
        dp = far_field(obja_p, objp_p, probes, self.h, self.occu, self.eps)
        meas = self.measured(idx)
        w = mask[:, None, None]
        s1 = ((dp ** q - meas ** q) ** 2 * w).sum()
        s2 = (meas ** q * w).sum()
        if self.sparse.get("state"):
            order = float(self.sparse.get("ln_order", 1))
            absn = torch.where(objp_p >= 0, objp_p, -objp_p) ** order
            sp = (absn * mask[:, None, None, None, None]).sum(dim=(0, 2, 3, 4))
        else:
            sp = None
        return s1, s2, sp

    def loss_and_grads(self, p: dict, idx: torch.Tensor, mask: torch.Tensor):
        """(loss, {leaf: gradient}) of one batch, in blocks of rows."""
        blocks = [(idx[i:i + self.block], mask[i:i + self.block])
                  for i in range(0, len(idx), self.block)]
        s1 = s2 = 0.0
        sp = None
        with torch.no_grad():
            for bi, bm in blocks:
                a, b, c = self.block_sums(p, bi, bm)
                s1, s2 = s1 + a, s2 + b
                sp = c if sp is None else sp + c
        count = mask.sum()
        pix = count * self.n * self.n
        w1 = float(self.single.get("weight", 1.0))
        loss = w1 * torch.sqrt(s1 / pix) / (s2 / pix)
        c1 = w1 / (2.0 * torch.sqrt(s1 / pix) * (s2 / pix) * pix)
        if sp is not None:
            order = float(self.sparse.get("ln_order", 1))
            ws = float(self.sparse.get("weight", 0.1))
            vox = count * p["objp"].shape[1] * self.n * self.n
            mean = sp / vox
            loss = loss + ws * (mean ** (1.0 / order) * self.occu).sum()
            csp = ws * self.occu * (1.0 / order) * mean ** (1.0 / order - 1.0) / vox
        live = [k for k in LEAVES if self.lr(k) != 0]
        for k in live:
            p[k].requires_grad_(True)
            p[k].grad = None
        for bi, bm in blocks:
            a, _, c = self.block_sums(p, bi, bm)
            surrogate = c1 * a
            if c is not None:
                surrogate = surrogate + (csp * c).sum()
            surrogate.backward()
        grads = {k: p[k].grad for k in live}
        for k in live:
            p[k].requires_grad_(False)
            p[k].grad = None
        return float(loss), grads

    # -- Adam and the constraints ---------------------------------------------

    def adam(self, p: dict, grads: dict, state: dict, t: int) -> None:
        b1, b2 = self.betas
        with torch.no_grad():
            for k, g in grads.items():
                if k not in state:
                    state[k] = (torch.zeros_like(g), torch.zeros_like(g))
                m, v = state[k]
                rp, rg = p[k], g
                rm, rv = m, v
                if rp.is_complex():
                    rp, rg = torch.view_as_real(rp), torch.view_as_real(rg)
                    rm, rv = torch.view_as_real(m), torch.view_as_real(v)
                rm.mul_(b1).add_(rg, alpha=1 - b1)
                rv.mul_(b2).add_(rg * rg, alpha=1 - b2)
                denom = rv.sqrt() / math.sqrt(1 - b2 ** t) + self.adam_eps
                rp.sub_(self.lr(k) / (1 - b1 ** t) * rm / denom)

    def constrain(self, p: dict, niter: int) -> None:
        with torch.no_grad():
            for name in CONSTRAINT_ORDER:
                cfg = self.constraints.get(name)
                if cfg is None or niter % int(cfg["freq"]) != 0:
                    continue
                fn = getattr(self, "c_" + name, None)
                if fn is None:
                    raise NotImplementedError(f"the reference has no constraint {name}")
                fn(p, cfg)

    def c_ortho_pmode(self, p, cfg):
        pr = p["probe"]
        flat = pr.reshape(pr.shape[0], -1)
        _, vecs = torch.linalg.eigh(flat @ flat.conj().T)
        modes = (vecs.conj().T @ flat).reshape(pr.shape)
        power = (modes.real ** 2 + modes.imag ** 2).sum(dim=(1, 2))
        p["probe"] = modes[torch.argsort(-power)]

    def c_fix_probe_int(self, p, cfg):
        pr = p["probe"]
        p["probe"] = pr * torch.sqrt(self.probe_int / (pr.real ** 2 + pr.imag ** 2).sum())

    @staticmethod
    def _blur_last(x: torch.Tensor, size: int, std: float, mode: str) -> torch.Tensor:
        r = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
        k = torch.exp(-0.5 * (r / std) ** 2)
        k = (k / k.sum()).to(torch.float32).tolist()
        lo = (size - 1) // 2
        flat = x.reshape(-1, 1, x.shape[-1])
        padded = F.pad(flat, (lo, size - 1 - lo), mode=mode)
        out = sum(kj * padded[..., j:j + x.shape[-1]] for j, kj in enumerate(k))
        return out.reshape(x.shape)

    def c_obj_rblur(self, p, cfg):
        size, std = int(cfg.get("kernel_size", 5)), float(cfg.get("std", 0.5))
        for k in self._objs(cfg):
            o = self._blur_last(p[k], size, std, "reflect")
            p[k] = self._blur_last(o.transpose(-1, -2), size, std, "reflect").transpose(-1, -2)

    def c_obj_zblur(self, p, cfg):
        size, std = int(cfg.get("kernel_size", 5)), float(cfg.get("std", 1.0))
        for k in self._objs(cfg):
            p[k] = self._blur_last(p[k].movedim(1, -1), size, std, "replicate").movedim(-1, 1)

    def c_kz_filter(self, p, cfg):
        beta, alpha = float(cfg.get("beta", 1.0)), float(cfg.get("alpha", 1.0))
        nz, ny, nx = p["obja"].shape[-3:]
        kz, ky, kx = (torch.fft.fftfreq(m, device=self.dev, dtype=torch.float32)
                      for m in (nz, ny, nx))
        gz, gy, gx = torch.meshgrid(kz, ky, kx, indexing="ij")
        wgt = 1.0 - torch.arctan((beta * gz.abs() / torch.sqrt(gx ** 2 + gy ** 2 + 1e-3)) ** 2) \
            / (math.pi / 2)
        wgt = wgt * torch.exp(-alpha * (gx ** 2 + gy ** 2))
        for k in self._objs(cfg):
            f = torch.fft.ifftn(torch.fft.fftn(p[k], dim=(-3, -2, -1)) * wgt,
                                dim=(-3, -2, -1)).real
            p[k] = 1.0 + 0.9 * (f - 1.0) if k == "obja" else f

    def c_obja_thresh(self, p, cfg):
        lo, hi = cfg.get("thresh", (0.98, 1.02))
        relax = float(cfg.get("relax", 0.0))
        p["obja"] = relax * p["obja"] + (1.0 - relax) * p["obja"].clamp(float(lo), float(hi))

    def c_objp_postiv(self, p, cfg):
        if cfg.get("mode", "clip_neg") != "clip_neg":
            raise NotImplementedError("objp_postiv: the reference clips negative phases")
        relax = float(cfg.get("relax", 0.0))
        p["objp"] = relax * p["objp"] + (1.0 - relax) * p["objp"].clamp(min=0.0)

    @staticmethod
    def _objs(cfg):
        kind = cfg.get("obj_type", "both")
        return [k for k, t in (("obja", "amplitude"), ("objp", "phase")) if kind in (t, "both")]

    # -- the steps ----------------------------------------------------------

    def run_steps(self, batches, start_niter: int = 1) -> dict:
        """Train a copy of the inputs through ``batches`` ((idx, mask) host
        arrays), one step an iteration numbered from ``start_niter`` (the
        start iterations and the constraints' schedule follow the number,
        Adam's count from 1), the constraints at each iteration's end.
        Returns each step's loss, the first step's gradient norm of each
        optimized leaf as Adam gets it (zero before its start iteration),
        each leaf's change norm after the last step, and the probe's change
        by ``probe_readings``."""
        p = {k: v.clone() for k, v in self.init.items()}
        pr = p["probe"]
        self.probe_int = (pr.real.double() ** 2 + pr.imag.double() ** 2).sum().float()
        state, losses, grad1 = {}, [], {}
        for t, (idx, mask) in enumerate(batches, start=1):
            niter = start_niter + t - 1
            idx_t = torch.as_tensor(np.asarray(idx), device=self.dev).long()
            mask_t = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=self.dev)
            loss, grads = self.loss_and_grads(p, idx_t, mask_t)
            grads = {k: (g if self.started(k, niter) else torch.zeros_like(g))
                     for k, g in grads.items()}
            if t == 1:
                grad1 = {k: norm(g) for k, g in grads.items()}
            self.adam(p, grads, state, t)
            self.constrain(p, niter)
            losses.append(loss)
        change = {k: norm(p[k] - self.init[k]) for k in grad1}
        probe = probe_change(probe_readings(self.init["probe"]), probe_readings(p["probe"]))
        return {"losses": losses, "grad1": grad1, "change": change, "probe": probe}
