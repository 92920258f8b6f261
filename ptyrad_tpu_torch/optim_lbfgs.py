"""LBFGS as the JAX package runs it: optax.lbfgs over every optimized tensor.

optax.lbfgs is the two-loop recursion (optax._src.transform.scale_by_lbfgs,
with the initial Hessian scaled by <s, y> / <y, y>), the global learning
rate, and the zoom line search (scale_by_zoom_linesearch with 20 steps at
most and an initial guess of 1; the strong-Wolfe zoom of Nocedal and
Wright, optax._src.linesearch.zoom_linesearch). It is not
torch.optim.LBFGS, which runs inner iterations and another line search.
``LBFGS.step(objective)`` takes one optax step:

  - value and gradient come from the line search's state (the accepted
    point of the previous step, before the constraints moved it), or from
    the objective when the state holds none (the first step);
  - tensors with lr 0 take a zero gradient into the recursion
    (optax.set_to_zero ahead of it) and so a zero direction; a
    ``weight_decay`` config is optax.add_decayed_weights between the two,
    as the JAX package chains it, which adds wd x to every tensor's
    gradient (lr 0 and not started included) and moves them all;
  - the memories take params - previous params (after the constraints
    moved them) and gradient - previous gradient;
  - inner products are taken leaf by leaf, the complex probe as its
    (re, im) pair, as optax's vdot over the JAX package's leaves; the
    line search's scalars are float32, as optax's; under canvas sharding
    (``slab``) the canvases' products are summed over the ranks' real rows,
    and the memories are the rank's slabs.

The objective is the solver's: the mean over all batches of the batch
losses at the live parameters (engine/solver.py builds it, one batch's
graph alive at a time, the start_iter gate applied to its gradient).
The state is every tensor's, in the JAX package's keystr layout under
``[1][0]`` (scale_by_lbfgs) and ``[1][2]`` (the line search), ``[1][1][0]``
and ``[1][1][2]`` with weight_decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams
from ptyrad_tpu_torch.optim import _coerce, _host, leaf_keys, leaves

F32 = np.float32
Tree = Dict[str, torch.Tensor]

# optax.lbfgs's default line search: scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy="one") and its defaults
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = F32(1e-4), F32(0.9), F32(1e-6)
INCREASE_FACTOR, TOL, INTERVAL_THRESHOLD = F32(2.0), F32(0.0), F32(1e-5)


def vdot(a: Tree, b: Tree, slab=None) -> torch.Tensor:
    """optax.tree.vdot: the sum over leaves of each leaf's dot product, a
    float32 scalar on the device. With ``slab`` (a parallel.canvas.
    CanvasShard) obja and objp are the rank's slabs: their products over
    the real rows are summed over the ranks first, as optax's vdot of the
    row-sharded canvases in the JAX package."""
    out = None
    if slab is not None:
        part = sum(torch.sum(slab.rows(x) * slab.rows(y)) for name in slab.canvas_names
                   for x, y in zip(leaves(a[name]), leaves(b[name])))
        out = slab.sum(part)
    for name in PARAM_NAMES:
        if slab is not None and name in slab.canvas_names:
            continue
        for x, y in zip(leaves(a[name]), leaves(b[name])):
            d = torch.sum(x * y)
            out = d if out is None else out + d
    return out


def _f(x) -> np.float32:
    """A device scalar (or number) as a float32 host scalar."""
    return F32(x.item() if isinstance(x, torch.Tensor) else x)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin in float32: the minimiser of the cubic through
    (a, fa) with slope fpa, (b, fb) and (c, fc)."""
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        x, y = fb - fa - C * db, fc - fa - C * dc
        A = (dc ** 2 * x + (-db ** 2) * y) / denom
        B = ((-dc ** 3) * x + db ** 3 * y) / denom
        radical = B * B - F32(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's _quadmin in float32."""
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / db ** 2
        return a - fpa / (F32(2.0) * B)


def _nan_to_inf(x):
    return F32(np.inf) if np.isnan(x) else x


class ZoomLinesearch:
    """One run of optax's zoom line search from (value, grad) at x0 along
    the direction u. ``evaluate(stepsize)`` gives (value, grad) of the
    objective at x0 + stepsize u. run() returns (stepsize, value, grad,
    steps, decrease_error, curvature_error)."""

    def __init__(self, x0: Tree, u: Tree, value, grad: Tree,
                 evaluate: Callable[[np.float32], Tuple[np.float32, Tree]], slab=None):
        self.evaluate = evaluate
        self.u = u
        self.slab = slab
        slope = _f(vdot(u, grad, slab))
        v = F32(value)
        self.s = dict(count=0, stepsize=F32(0), value=v, grad=grad, slope=slope, value_init=v,
                      slope_init=slope, decrease_error=F32(np.inf),
                      curvature_error=F32(np.inf), error=F32(np.inf), interval_found=False,
                      done=False, failed=False, low=F32(0), value_low=v, slope_low=slope,
                      high=F32(0), value_high=v, slope_high=slope, cubic_ref=F32(0),
                      value_cubic_ref=v, safe_stepsize=F32(0), safe_value=v, safe_grad=grad)

    def _on_line(self, stepsize):
        value, grad = self.evaluate(stepsize)
        return F32(value), grad, _f(vdot(grad, self.u, self.slab))

    def _decrease_error(self, stepsize, value, slope):
        s = self.s
        with np.errstate(all="ignore"):
            err = value - s["value_init"] - SLOPE_RTOL * stepsize * s["slope_init"]
            approx = slope - (F32(2) * SLOPE_RTOL - F32(1.0)) * s["slope_init"]
            delta = value - s["value_init"] - APPROX_DEC_RTOL * np.abs(s["value_init"])
            err = np.minimum(np.maximum(approx, delta), err)
            return _nan_to_inf(F32(np.maximum(err, F32(0.0))))

    def _curvature_error(self, slope):
        with np.errstate(all="ignore"):
            err = np.abs(slope) - CURV_RTOL * np.abs(self.s["slope_init"])
            return _nan_to_inf(F32(np.maximum(err, F32(0.0))))

    def _search_interval(self):
        s = self.s
        n = s["count"]
        prev_step, prev_value, prev_slope = s["stepsize"], s["value"], s["slope"]
        step = F32(1.0) if n == 0 else INCREASE_FACTOR * prev_step
        value, grad, slope = self._on_line(step)
        dec = self._decrease_error(step, value, slope)
        curv = self._curvature_error(slope)
        err = F32(np.maximum(dec, curv))
        if dec <= TOL:
            s.update(safe_stepsize=step, safe_value=value, safe_grad=grad)
        set_high = bool(dec > 0.0) or (bool(value >= prev_value) and n > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            low = (step, value, slope)
            high = (prev_step, prev_value, prev_slope)
        else:
            low = (prev_step, prev_value, prev_slope)
            high = (step, value, slope)
        interval_found = set_high or set_low or bool(err <= TOL)
        done = bool(err <= TOL)
        s.update(count=n + 1, stepsize=step, value=value, grad=grad, slope=slope,
                 decrease_error=dec, curvature_error=curv, error=err,
                 interval_found=interval_found, done=done,
                 failed=(n + 1 >= MAX_LINESEARCH_STEPS) and not done,
                 low=low[0], value_low=low[1], slope_low=low[2],
                 high=high[0], value_high=high[1], slope_high=high[2],
                 cubic_ref=low[0], value_cubic_ref=low[1])

    def _zoom_into_interval(self):
        s = self.s
        n = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = s["high"], s["value_high"], s["slope_high"]
        delta = F32(np.abs(high - low))
        left, right = F32(np.minimum(high, low)), F32(np.maximum(high, low))
        cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
        too_small = bool(delta <= INTERVAL_THRESHOLD)
        cubic = F32(_cubicmin(low, value_low, slope_low, high, value_high, s["cubic_ref"],
                              s["value_cubic_ref"]))
        use_cubic = bool(cubic > left + cubic_chk) and bool(cubic < right - cubic_chk)
        quad = F32(_quadmin(low, value_low, slope_low, high, value_high))
        use_quad = not use_cubic and bool(quad > left + quad_chk) and bool(quad < right - quad_chk)
        if use_cubic:
            middle = cubic
        elif use_quad:
            middle = quad
        else:
            middle = (low + high) / F32(2.0)
        value, grad, slope = self._on_line(middle)
        dec = self._decrease_error(middle, value, slope)
        curv = self._curvature_error(slope)
        err = F32(np.maximum(dec, curv))
        if bool(dec <= TOL) and bool(value < s["safe_value"]):
            s.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = bool(err <= TOL)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        set_low_to_middle = not set_high_to_middle
        new_high = (middle, value, slope) if set_high_to_middle else (high, value_high, slope_high)
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = (middle, value, slope) if set_low_to_middle else (low, value_low, slope_low)
        if set_high_to_middle or set_high_to_low:
            cubic_ref = (high, value_high)
        else:
            cubic_ref = (low, value_low)
        presumably_failed = (n + 1 >= MAX_LINESEARCH_STEPS) or (
            too_small and bool(s["safe_stepsize"] > 0.0))
        s.update(count=n + 1, stepsize=middle, value=value, grad=grad, slope=slope,
                 decrease_error=dec, curvature_error=curv, error=err, done=done,
                 failed=presumably_failed and not done,
                 low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                 cubic_ref=cubic_ref[0], value_cubic_ref=cubic_ref[1])

    def _try_safe_step(self):
        s = self.s
        if bool(s["safe_stepsize"] > 0.0) or bool(np.isinf(s["decrease_error"])):
            s.update(stepsize=s["safe_stepsize"], value=s["safe_value"], grad=s["safe_grad"])

    def run(self):
        s = self.s
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if s["failed"]:
                self._try_safe_step()
        return (s["stepsize"], s["value"], s["grad"], s["count"], s["decrease_error"],
                s["curvature_error"])


class LBFGS:
    """optax.lbfgs over the six tensors of PtychoParams (PARAM_NAMES order),
    those with lr 0 held still unless ``coupled_wd``; see the module
    docstring. ``param_groups`` names the tensors with a nonzero lr."""

    def __init__(self, params: PtychoParams, lr_dict: Dict[str, float], learning_rate: float,
                 memory_size: int = 10, scale_init_precond: bool = True,
                 coupled_wd: float = 0.0, slab=None):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.params = params
        self.learning_rate = float(learning_rate)
        self.memory_size = int(memory_size)
        self.scale_init_precond = bool(scale_init_precond)
        self.active = {name: lr_dict[name] != 0 for name in PARAM_NAMES}
        self.coupled_wd = float(coupled_wd)
        self.moving = [k for k in PARAM_NAMES if self.active[k] or self.coupled_wd]
        # chain(add_decayed_weights, lbfgs) nests the state one level deeper
        self.prefix = "[1][1]" if self.coupled_wd else "[1]"
        self.param_groups = [{"name": name, "params": [getattr(params, name)],
                              "lr": self.learning_rate}
                             for name in PARAM_NAMES if self.active[name]]
        live = dict(params.named())
        z = {k: torch.zeros_like(v, requires_grad=False) for k, v in live.items()}
        stack = {k: torch.zeros((self.memory_size,) + tuple(v.shape), dtype=v.dtype,
                                device=v.device) for k, v in live.items()}
        dev = params.obja.device
        # scale_by_lbfgs
        self.count = 0
        self.prev_params = z
        self.prev_updates = {k: v.clone() for k, v in z.items()}
        self.diff_params_memory = stack
        self.diff_updates_memory = {k: v.clone() for k, v in stack.items()}
        self.weights_memory = torch.zeros(self.memory_size, dtype=torch.float32, device=dev)
        # scale_by_zoom_linesearch
        self.ls_learning_rate = F32(1.0)
        self.value = F32(np.inf)
        self.grad = {k: v.clone() for k, v in z.items()}
        self.info = {"num_linesearch_steps": 0, "decrease_error": F32(np.inf),
                     "curvature_error": F32(np.inf)}
        self.evaluations = 0  # objective evaluations of the last step
        self.slab = slab  # a parallel.canvas.CanvasShard under canvas sharding (vdot)

    @property
    def state(self):
        return {}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, t in self.params.named():
            t.grad = None

    def _precondition(self, updates: Tree, identity_scale, memory_idx: int) -> Tree:
        """optax's _precondition_by_lbfgs: the two-loop recursion over the
        memory slots from memory_idx on, the latest last."""
        m = self.memory_size
        order = [(memory_idx + i) % m for i in range(m)]
        rhos = self.weights_memory
        dw, du = self.diff_params_memory, self.diff_updates_memory
        vec = dict(updates)
        alphas = {}
        for idx in reversed(order):
            alpha = rhos[idx] * vdot({k: dw[k][idx] for k in PARAM_NAMES}, vec, self.slab)
            vec = {k: vec[k] + (-alpha) * du[k][idx] for k in PARAM_NAMES}
            alphas[idx] = alpha
        vec = {k: identity_scale * v for k, v in vec.items()}
        for idx in order:
            beta = rhos[idx] * vdot({k: du[k][idx] for k in PARAM_NAMES}, vec, self.slab)
            vec = {k: vec[k] + (alphas[idx] - beta) * dw[k][idx] for k in PARAM_NAMES}
        return vec

    def _scale_by_lbfgs(self, updates: Tree, params: Tree) -> Tree:
        m = self.memory_size
        memory_idx = self.count % m
        prev_idx = (self.count - 1) % m
        diff_params = {k: params[k] - self.prev_params[k] for k in PARAM_NAMES}
        diff_updates = {k: updates[k] - self.prev_updates[k] for k in PARAM_NAMES}
        dot = vdot(diff_updates, diff_params, self.slab)
        weight = torch.where(dot == 0.0, torch.zeros_like(dot), 1.0 / dot)
        if self.count == 0:
            diff_params = {k: torch.zeros_like(v) for k, v in diff_params.items()}
            diff_updates = {k: torch.zeros_like(v) for k, v in diff_updates.items()}
            weight = torch.zeros_like(weight)
        for k in PARAM_NAMES:
            self.diff_params_memory[k][prev_idx] = diff_params[k]
            self.diff_updates_memory[k][prev_idx] = diff_updates[k]
        self.weights_memory[prev_idx] = weight
        if self.scale_init_precond:
            if self.count > 0:
                num = vdot(diff_updates, diff_params, self.slab)
                den = vdot(diff_updates, diff_updates, self.slab)
                scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
            else:
                norm = torch.sqrt(vdot(updates, updates, self.slab))
                scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        else:
            scale = 1.0
        out = self._precondition(updates, scale, memory_idx)
        self.count += 1
        self.prev_params = params
        self.prev_updates = updates
        return out

    @torch.no_grad()
    def step(self, objective: Callable[[], Tuple[torch.Tensor, Tree]]) -> np.float32:
        """One optax.lbfgs step. ``objective()`` gives (value, {name:
        gradient}) at the live parameters, whose values this method sets.
        Returns the objective's value at the parameters the step starts
        from."""
        live = dict(self.params.named())
        x0 = {k: v.detach().clone() for k, v in live.items()}
        self.evaluations = 0

        def evaluate(stepsize):
            for k in self.moving:
                live[k].copy_(x0[k] + float(stepsize) * u[k])
            self.evaluations += 1
            with torch.enable_grad():
                value, grad = objective()
            return _f(value), {k: g.detach() for k, g in grad.items()}

        if np.isfinite(self.value):
            value, grad = self.value, self.grad
        else:
            self.evaluations += 1
            with torch.enable_grad():
                v, g = objective()
            value, grad = _f(v), {k: t.detach() for k, t in g.items()}
        masked = {k: grad[k] if self.active[k] else torch.zeros_like(grad[k])
                  for k in PARAM_NAMES}
        if self.coupled_wd:
            masked = {k: g + self.coupled_wd * x0[k] for k, g in masked.items()}
        direction = self._scale_by_lbfgs(masked, x0)
        u = {k: -self.learning_rate * d for k, d in direction.items()}
        search = ZoomLinesearch(x0, u, value, grad, evaluate, self.slab)
        stepsize, new_value, new_grad, steps, dec, curv = search.run()
        for k in self.moving:
            live[k].copy_(x0[k] + float(stepsize) * u[k])
        self.ls_learning_rate = stepsize
        self.value, self.grad = new_value, new_grad
        self.info = {"num_linesearch_steps": steps, "decrease_error": dec,
                     "curvature_error": curv}
        return value

    def keyed_arrays(self) -> list:
        """(key, getter, setter) of every array of the state, in the JAX
        package's keystr layout (optax's leaf order)."""
        out = [(f"{self.prefix}[0].count", lambda: np.int32(self.count),
                lambda a: setattr(self, "count", int(a)))]
        live = dict(self.params.named())

        def tree(field, attr):
            for k in PARAM_NAMES:
                for j, suffix in enumerate(leaf_keys(k, live[k])):
                    def get(attr=attr, k=k, j=j):
                        return _host(leaves(getattr(self, attr)[k])[j])

                    def put(a, attr=attr, k=k, j=j):
                        leaf = leaves(getattr(self, attr)[k])[j]
                        leaf.copy_(_coerce(a, leaf))
                    out.append((f"{field}{suffix}", get, put))

        tree(f"{self.prefix}[0].params", "prev_params")
        tree(f"{self.prefix}[0].updates", "prev_updates")
        tree(f"{self.prefix}[0].diff_params_memory", "diff_params_memory")
        tree(f"{self.prefix}[0].diff_updates_memory", "diff_updates_memory")
        out.append((f"{self.prefix}[0].weights_memory", lambda: _host(self.weights_memory),
                    lambda a: self.weights_memory.copy_(_coerce(a, self.weights_memory))))
        out.append((f"{self.prefix}[2].learning_rate", lambda: F32(self.ls_learning_rate),
                    lambda a: setattr(self, "ls_learning_rate", F32(a))))
        out.append((f"{self.prefix}[2].value", lambda: F32(self.value),
                    lambda a: setattr(self, "value", F32(a))))
        tree(f"{self.prefix}[2].grad", "grad")
        for key, cast in (("num_linesearch_steps", np.int32), ("decrease_error", F32),
                          ("curvature_error", F32)):
            out.append((f"{self.prefix}[2].info.{key}", lambda key=key, cast=cast: cast(self.info[key]),
                        lambda a, key=key, cast=cast: self.info.__setitem__(key, cast(a))))
        return out
