"""Hyperparameter tuning engine with optuna's surface (a copy of
ptyrad_tpu/engine/tuner.py, standard library plus numpy).

The reference delegates HPO to Optuna with a shared sqlite storage so N
independent single-GPU workers cooperate on one study (reference
reconstruction.py:145-240, demo/scripts/LoopSubmit.sh). This module provides
the same capability without the optuna dependency:

  - Trial.suggest_float / suggest_int / suggest_categorical, report,
    should_prune; TrialPruned exception
  - Samplers: RandomSampler, GridSampler, and TPESampler — a lightweight
    Tree-structured Parzen Estimator: split completed trials at the gamma
    quantile into good/bad sets, score candidates by the ratio of Gaussian
    KDEs l(x)/g(x), pick the argmax over a candidate pool
  - Pruners: MedianPruner (prune when the intermediate value is worse than
    the median of completed trials at the same step); HyperbandPruner maps to
    MedianPruner semantics with interval-of-report gating
  - Study with sqlite storage (shared file => multi-worker cooperation,
    load_if_exists semantics) or in-memory storage

The arithmetic, the order of the random draws (random.Random(seed)) and the
sqlite schema are the JAX package's, so a seeded study draws the same values
in either package and a worker of either package joins a study the other
started. Sampler and pruner configs the engine does not model (optuna's
multivariate, group, constant_liar, ...) are accepted and ignored.

When optuna is installed, ptyrad_tpu_torch.engine.hypertune uses it directly;
this engine is the fallback and the default in minimal environments.
"""

from __future__ import annotations

import json
import math
import os
import random
import sqlite3
import time
from typing import Any, Callable, Dict, List, Optional

from ptyrad_tpu_torch.utils.logging import vprint

RUNNING, COMPLETE, PRUNED, FAILED = "RUNNING", "COMPLETE", "PRUNED", "FAILED"


class TrialPruned(Exception):
    """Raised inside an objective to stop an unpromising trial."""


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

class Storage:
    """Trial store; sqlite-backed when a path is given (shared across worker
    processes), in-memory otherwise."""

    def __init__(self, path: Optional[str] = None, study_name: str = "study"):
        if path and path.startswith("sqlite:///"):
            path = path[len("sqlite:///"):]  # accept optuna storage URIs
        self.path = path
        self.study_name = study_name
        if path:
            self._conn = sqlite3.connect(path, timeout=60)
            # Concurrent-worker hardening (the reference's Slurm pattern runs
            # N processes on ONE sqlite study, LoopSubmit.sh): WAL lets
            # readers proceed under a writer; busy_timeout makes writer-vs-
            # writer contention block instead of raising 'database is locked'.
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
            except sqlite3.OperationalError:
                pass  # e.g. network filesystems; rollback journal still works
            self._conn.execute("PRAGMA busy_timeout=60000")
            self._execute_retry(
                """CREATE TABLE IF NOT EXISTS trials (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    study TEXT, state TEXT, value REAL,
                    params TEXT, reports TEXT, created REAL)"""
            )
        else:
            self._trials: List[dict] = []

    def _execute_retry(self, sql, args=(), tries: int = 6):
        """execute+commit with bounded retry on transient lock errors (a
        writer holding the lock past busy_timeout, or WAL checkpoint races)."""
        delay = 0.05
        for attempt in range(tries):
            try:
                cur = self._conn.execute(sql, args)
                self._conn.commit()
                return cur
            except sqlite3.OperationalError as e:
                # roll back BEFORE retrying: under the rollback-journal
                # fallback a lock error can hit the COMMIT after the
                # statement already ran inside the open transaction, and
                # re-executing an INSERT there would persist BOTH rows once
                # the commit finally succeeds (phantom RUNNING trials)
                try:
                    self._conn.rollback()
                except sqlite3.OperationalError:
                    pass
                if "locked" not in str(e) and "busy" not in str(e):
                    raise
                if attempt == tries - 1:
                    raise
                time.sleep(delay)
                delay *= 2

    def create_trial(self) -> int:
        if self.path:
            cur = self._execute_retry(
                "INSERT INTO trials (study, state, value, params, reports, created) VALUES (?,?,?,?,?,?)",
                (self.study_name, RUNNING, None, "{}", "{}", time.time()),
            )
            return cur.lastrowid - 1
        self._trials.append({"state": RUNNING, "value": None, "params": {}, "reports": {}})
        return len(self._trials) - 1

    def update_trial(self, number: int, state=None, value=None, params=None, reports=None):
        if self.path:
            if state is value is params is reports is None:
                return  # nothing to update; bare SET would be malformed SQL
            sets, vals = [], []
            if state is not None:
                sets.append("state=?"); vals.append(state)
            if value is not None:
                sets.append("value=?"); vals.append(float(value))
            if params is not None:
                sets.append("params=?"); vals.append(json.dumps(params))
            if reports is not None:
                sets.append("reports=?"); vals.append(json.dumps(reports))
            vals.extend([self.study_name, number + 1])
            self._execute_retry(
                f"UPDATE trials SET {', '.join(sets)} WHERE study=? AND id=?", vals)
        else:
            t = self._trials[number]
            if state is not None:
                t["state"] = state
            if value is not None:
                t["value"] = float(value)
            if params is not None:
                t["params"] = dict(params)
            if reports is not None:
                t["reports"] = dict(reports)

    def all_trials(self) -> List[dict]:
        if self.path:
            rows = self._execute_retry(
                "SELECT id, state, value, params, reports FROM trials WHERE study=? ORDER BY id",
                (self.study_name,),
            ).fetchall()
            return [
                {"number": r[0] - 1, "state": r[1], "value": r[2],
                 "params": json.loads(r[3]), "reports": json.loads(r[4])}
                for r in rows
            ]
        return [
            {"number": i, **t} for i, t in enumerate(self._trials)
        ]


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

class RandomSampler:
    def __init__(self, seed: Optional[int] = None, **_):
        self.rng = random.Random(seed)

    def sample(self, name, spec, history):
        kind = spec["kind"]
        if kind == "cat":
            return self.rng.choice(spec["choices"])
        low, high = spec["low"], spec["high"]
        if spec.get("log"):
            val = math.exp(self.rng.uniform(math.log(low), math.log(high)))
        else:
            val = self.rng.uniform(low, high)
        if spec.get("step"):
            val = low + round((val - low) / spec["step"]) * spec["step"]
            val = min(max(val, low), high)  # snap can overshoot when (high-low) % step != 0
        if kind == "int":
            return int(round(val))
        return float(val)


class GridSampler:
    """Cycles the cartesian grid defined by step/choices in trial order."""

    def __init__(self, seed: Optional[int] = None, **_):
        self._axes: Dict[str, list] = {}

    def _axis(self, name, spec):
        if name not in self._axes:
            if spec["kind"] == "cat":
                self._axes[name] = list(spec["choices"])
            elif spec.get("log"):
                # geometric spacing: linear steps on a log-scale axis would
                # put every grid point except the first in the top decade
                lo, hi = math.log(spec["low"]), math.log(spec["high"])
                vals = [math.exp(lo + i * (hi - lo) / 9) for i in range(10)]
                if spec["kind"] == "int":
                    # round like the linear branch so suggest_int(log=True)
                    # records the int actually used, deduped (review r4)
                    vals = sorted({int(round(v)) for v in vals})
                self._axes[name] = vals
            else:
                step = spec.get("step") or (spec["high"] - spec["low"]) / 9
                n = int(round((spec["high"] - spec["low"]) / step)) + 1
                vals = [spec["low"] + i * step for i in range(n)]
                # RELATIVE endpoint tolerance: low + (n-1)*step can land an
                # ulp above high for large-magnitude axes (|high| ~ 1e6 makes
                # one ulp >> any absolute 1e-12), which would silently drop
                # the grid's maximum; clamp near-endpoint values to high
                tol = 1e-9 * max(abs(spec["high"]), abs(spec["low"]), 1.0)
                vals = [min(v, spec["high"]) for v in vals if v <= spec["high"] + tol]
                self._axes[name] = [int(round(v)) for v in vals] if spec["kind"] == "int" else vals
        return self._axes[name]

    def sample(self, name, spec, history):
        axis = self._axis(name, spec)
        n_done = len([t for t in history if name in t["params"]])
        # cartesian product, not lockstep: each axis advances with a stride
        # equal to the product of the lengths of the axes registered AFTER
        # it (every trial samples every axis, so a shared n_done index would
        # only ever visit the grid's diagonal)
        later = list(self._axes)[list(self._axes).index(name) + 1:]
        stride = 1
        for other in later:
            stride *= len(self._axes[other])
        return axis[(n_done // stride) % len(axis)]


class TPESampler:
    """Lightweight Tree-structured Parzen Estimator.

    After n_startup random trials: split completed trials at the gamma
    quantile by objective value; model good (l) and bad (g) sets with
    Gaussian KDEs (Scott bandwidth); draw candidates from l and return the
    candidate maximizing l(x)/g(x). Categorical uses smoothed frequency
    ratios.

    Approximation note: each parameter is modeled with an independent 1D KDE
    (optuna's multivariate=False default has the same structure, but optuna
    additionally uses truncated kernels and per-component bandwidths). Three
    optuna mechanisms proved load-bearing and are replicated: the 10% good/bad
    split (gamma), the wide prior component in both KDEs (consider_prior),
    and the bandwidth floor ('magic clip' — without it, duplicates of the
    incumbent collapse the candidate pool to a delta and the sampler freezes).
    Characterized in the JAX package's tests (test_hypertune_viz.py::
    test_tpe_beats_random_on_toy_objective): on a seeded 2D quadratic it beats
    RandomSampler on 9/10 seeds within a 40-trial budget (mean best 0.011 vs
    0.037).
    """

    def __init__(self, seed: Optional[int] = None, n_startup_trials: int = 10,
                 gamma: float = 0.1, n_candidates: int = 24, **_):
        self.rng = random.Random(seed)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._random = RandomSampler(seed)

    def sample(self, name, spec, history):
        done = [t for t in history if t["state"] == COMPLETE and name in t["params"]
                and t["value"] is not None and math.isfinite(t["value"])]
        if len(done) < self.n_startup:
            return self._random.sample(name, spec, history)
        done.sort(key=lambda t: t["value"])
        n_good = max(1, int(self.gamma * len(done)))
        good = [t["params"][name] for t in done[:n_good]]
        bad = [t["params"][name] for t in done[n_good:]] or good

        if spec["kind"] == "cat":
            choices = spec["choices"]

            def score(c):
                lg = (good.count(c) + 1) / (len(good) + len(choices))
                bg = (bad.count(c) + 1) / (len(bad) + len(choices))
                return lg / bg

            return max(choices, key=score)

        import numpy as np

        low, high = spec["low"], spec["high"]
        log = spec.get("log", False)

        def to_u(v):
            return math.log(v) if log else v

        def from_u(u):
            return math.exp(u) if log else u

        g_arr = np.asarray([to_u(v) for v in good], dtype=float)
        b_arr = np.asarray([to_u(v) for v in bad], dtype=float)

        lo_u, hi_u = to_u(low), to_u(high)
        span = hi_u - lo_u

        def bandwidth(arr):
            """Scott's rule with optuna's 'magic clip' floor: duplicates of
            the incumbent drive the empirical std to ~0, and an unclipped
            KDE bandwidth collapses the candidate pool to a delta at the
            incumbent (observed mode collapse). The floor shrinks as
            evidence accumulates, so resolution still refines over time."""
            floor = span / min(100.0, 1.0 + len(arr) * 4.0)
            if len(arr) < 2 or arr.std() == 0:
                return max(span / 10, floor, 1e-12)
            return max(1.06 * arr.std() * len(arr) ** -0.2, floor, 1e-12)

        def kde(arr, x):
            """Gaussian KDE with optuna's consider_prior: a wide N(mid, span)
            component in the mixture keeps density (and hence the l/g ratio)
            informative away from observed points, preventing the sampler
            from locking onto an early lucky cluster."""
            bw = bandwidth(arr)
            norm = math.sqrt(2.0 * math.pi)
            comp = np.exp(-0.5 * ((x[:, None] - arr[None, :]) / bw) ** 2).sum(1) / (bw * norm)
            prior = np.exp(-0.5 * ((x - (lo_u + hi_u) / 2) / span) ** 2) / (span * norm)
            return (comp + prior) / (len(arr) + 1)

        # candidates ARE draws from l(x) (gaussian around a random good point
        # at the KDE bandwidth — proper TPE), plus uniform prior draws
        bw_good = bandwidth(g_arr)
        cands = []
        for _ in range(self.n_candidates):
            if self.rng.random() < 0.75 and len(g_arr):
                center = self.rng.choice(list(g_arr))
                cands.append(min(max(self.rng.gauss(center, bw_good), lo_u), hi_u))
            else:
                cands.append(self.rng.uniform(lo_u, hi_u))
        x = np.asarray(cands)
        ratio = kde(g_arr, x) / (kde(b_arr, x) + 1e-12)
        val = from_u(float(x[int(ratio.argmax())]))
        if spec.get("step"):
            val = low + round((val - low) / spec["step"]) * spec["step"]
        val = min(max(val, low), high)
        return int(round(val)) if spec["kind"] == "int" else float(val)


class MedianPruner:
    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0, interval_steps: int = 1, **_):
        self.n_startup = n_startup_trials
        self.n_warmup = n_warmup_steps
        self.interval = max(1, interval_steps)

    def should_prune(self, trial_reports: Dict[int, float], step: int, history: List[dict]) -> bool:
        if step <= self.n_warmup or step % self.interval != 0:
            return False
        finished = [t for t in history if t["state"] == COMPLETE and t["reports"]]
        if len(finished) < self.n_startup:
            return False
        peers = [t["reports"].get(str(step)) for t in finished]
        peers = [v for v in peers if v is not None]
        if not peers:
            return False
        import statistics

        return trial_reports[step] > statistics.median(peers)


class HyperbandPruner(MedianPruner):
    """Median-rule approximation of Hyperband's successive halving: prunes at
    exponentially spaced rungs."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3, **kw):
        super().__init__(
            n_startup_trials=kw.get("n_startup_trials", 3),
            n_warmup_steps=kw.get("n_warmup_steps", 0),
            interval_steps=kw.get("interval_steps", 1),
        )
        if reduction_factor <= 1:
            raise ValueError(f"reduction_factor must be > 1, got {reduction_factor}")
        if min_resource < 1:
            raise ValueError(f"min_resource must be >= 1, got {min_resource}")
        self.min_resource = min_resource
        self.eta = reduction_factor

    def should_prune(self, trial_reports, step, history):
        rung = self.min_resource
        rungs = set()
        while rung <= step:
            rungs.add(rung)
            rung *= self.eta
        if step not in rungs:
            return False
        return MedianPruner.should_prune(self, trial_reports, step, history)


SAMPLER_REGISTRY = {
    "RandomSampler": RandomSampler,
    "GridSampler": GridSampler,
    "TPESampler": TPESampler,
}
PRUNER_REGISTRY = {
    "MedianPruner": MedianPruner,
    "HyperbandPruner": HyperbandPruner,
}


# ---------------------------------------------------------------------------
# Trial / Study
# ---------------------------------------------------------------------------

class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self._reports: Dict[int, float] = {}

    def _suggest(self, name, spec):
        val = self.study.sampler.sample(name, spec, self.study.storage.all_trials())
        self.params[name] = val
        self.study.storage.update_trial(self.number, params=self.params)
        return val

    def suggest_float(self, name, low, high, step=None, log=False):
        if log and low <= 0:
            raise ValueError(f"suggest_float('{name}', log=True) requires low > 0, got {low}")
        return self._suggest(name, {"kind": "float", "low": low, "high": high, "step": step, "log": log})

    def suggest_int(self, name, low, high, step=1, log=False):
        if log and low <= 0:
            # same guard as suggest_float: without it the sampler dies in
            # math.log and the whole study burns its budget on FAILED trials
            raise ValueError(f"suggest_int('{name}', log=True) requires low > 0, got {low}")
        return int(self._suggest(name, {"kind": "int", "low": low, "high": high, "step": step, "log": log}))

    def suggest_categorical(self, name, choices):
        return self._suggest(name, {"kind": "cat", "choices": list(choices)})

    def report(self, value: float, step: int):
        self._reports[step] = float(value)
        self.study.storage.update_trial(
            self.number, reports={str(k): v for k, v in self._reports.items()}
        )

    def should_prune(self) -> bool:
        if self.study.pruner is None or not self._reports:
            return False
        step = max(self._reports)
        return self.study.pruner.should_prune(self._reports, step, self.study.storage.all_trials())


def _pruned_exception_types():
    """TrialPruned classes the builtin Study must recognize: its own, plus
    optuna's when optuna is importable — the objective picks its exception by
    availability, and a pruned trial recorded as FAILED would lose its
    intermediate value and starve the pruner/sampler history."""
    try:
        import optuna

        return (TrialPruned, optuna.exceptions.TrialPruned)
    except ImportError:
        return (TrialPruned,)


class Study:
    """Minimize-direction study over a shared storage."""

    def __init__(self, study_name="study", storage_path: Optional[str] = None,
                 sampler=None, pruner=None):
        self.storage = Storage(storage_path, study_name)
        self.sampler = sampler or TPESampler()
        self.pruner = pruner

    def optimize(self, objective: Callable[[Trial], float], n_trials: int,
                 timeout: Optional[float] = None):
        t0 = time.time()
        for _ in range(n_trials):
            if timeout is not None and time.time() - t0 > timeout:
                vprint("Hypertune timeout reached")
                break
            number = self.storage.create_trial()
            trial = Trial(self, number)
            try:
                value = objective(trial)
                self.storage.update_trial(number, state=COMPLETE, value=value, params=trial.params)
                vprint(f"Trial {number} COMPLETE value={value:.6g} params={trial.params}")
            except _pruned_exception_types():
                last = trial._reports[max(trial._reports)] if trial._reports else None
                self.storage.update_trial(number, state=PRUNED, value=last, params=trial.params)
                vprint(f"Trial {number} PRUNED at step {max(trial._reports) if trial._reports else '?'}")
            except Exception as e:  # noqa: BLE001 — a failed trial must not kill the study
                self.storage.update_trial(number, state=FAILED, params=trial.params)
                vprint(f"Trial {number} FAILED: {e}")

    @property
    def trials(self) -> List[dict]:
        return self.storage.all_trials()

    @property
    def best_trial(self) -> Optional[dict]:
        done = [t for t in self.trials if t["state"] == COMPLETE and t["value"] is not None]
        return min(done, key=lambda t: t["value"]) if done else None


def create_study(study_name: str, storage_path: Optional[str] = None,
                 sampler_params: Optional[dict] = None,
                 pruner_params: Optional[dict] = None,
                 load_if_exists: bool = True) -> Study:
    """Build a Study from the params-file schema (sampler/pruner name+configs)."""
    sp = sampler_params or {}
    name = sp.get("name", "TPESampler")
    if name not in SAMPLER_REGISTRY:
        raise ValueError(f"Sampler '{name}' not supported; choose from {sorted(SAMPLER_REGISTRY)}")
    sampler = SAMPLER_REGISTRY[name](**(sp.get("configs") or {}))

    pruner = None
    if pruner_params is not None:
        pname = pruner_params.get("name", "MedianPruner")
        if pname not in PRUNER_REGISTRY:
            raise ValueError(f"Pruner '{pname}' not supported; choose from {sorted(PRUNER_REGISTRY)}")
        pruner = PRUNER_REGISTRY[pname](**(pruner_params.get("configs") or {}))

    study = Study(study_name, storage_path, sampler, pruner)
    if storage_path and not load_if_exists and study.storage.path:
        # clear only THIS study's rows: deleting the file would destroy
        # co-hosted studies and split-brain workers holding the old inode
        study.storage._execute_retry(
            "DELETE FROM trials WHERE study=?", (study.storage.study_name,)
        )
    return study
