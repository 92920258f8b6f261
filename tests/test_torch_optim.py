"""The optimizers: every name of the registry computes what the JAX
package's optax rule computes, with torch-named configs translated as the
JAX package translates them (betas, etas, step_sizes, weight_decay coupled
where optax's constructor lacks it) and torch-only configs dropped with the
same warning (tests/test_torch_optim_solver.py runs them in the solver,
tests/test_torch_optim_resume.py resumes their checkpoints).

(a) feeds the same seeded NumPy gradients for 5 steps to the JAX package's
create_optimizer transform (its update, the start-iter mask of gradients
and updates, optax.apply_updates) and to the port's optimizer (the solver's
gradient mask, step and update mask), on parameters of the six tensors'
kinds: rtol 1e-6 on the parameters (float32 rules in two orders of
rounding), and the port's checkpoint state under the JAX package's keys,
equal key for key at rtol 1e-5 (atol 1e-5 of each array's largest entry).
A moment stored in a 2-byte type (mu_dtype, accumulator_dtype,
dtype_momentum) is held in that type, at one step of it: rtol its
machine epsilon (2^-7 for bfloat16, 2^-10 for float16), atol that of the
array's largest entry. The parameters stay at rtol 1e-6: the port rounds
as optax's eager update does. LBFGS takes value functions, not gradients:
tests/test_torch_lbfgs.py.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from ptyrad_tpu.models.state import PtychoParams as JaxParams
from ptyrad_tpu.ops.cplx import Cplx
from ptyrad_tpu.optim import OPTIMIZER_REGISTRY as JAX_REGISTRY
from ptyrad_tpu.optim import create_optimizer as j_create_optimizer
from ptyrad_tpu.optim import mask_unstarted_grads as j_mask
from ptyrad_tpu_torch import optim as O
from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams
from torch_port_helpers import np_

# obja's second-largest axis reaches Adafactor's min_dim_size_to_factor
# (128), so obja is factored and the others are not; probe_pos_shifts and
# obj_tilts are 2-D (Muon's Newton-Schulz leaves)
SHAPES = {"obja": (1, 2, 130, 9), "objp": (1, 2, 6, 9), "probe": (2, 6, 6),
          "probe_pos_shifts": (7, 2), "obj_tilts": (7, 2), "slice_thickness": ()}
UPDATE = {"obja": {"lr": 1e-3, "start_iter": 1}, "objp": {"lr": 2e-3, "start_iter": 3},
          "probe": {"lr": 1e-4}, "probe_pos_shifts": {"lr": 1e-2},
          "obj_tilts": {"lr": 1e-2}, "slice_thickness": {"lr": 1e-3}}
STEPS = 5

CASES = [
    ("Adam", {}), ("Adam", {"betas": (0.8, 0.99), "eps": 1e-6, "weight_decay": 0.1}),
    ("adam", {"amsgrad": True}), ("SparseAdam", {}),
    ("AdamW", {}), ("AdamW", {"weight_decay": 0.1}), ("adamw", {"betas": (0.85, 0.995)}),
    ("SGD", {}), ("SGD", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01, "dampening": 0}),
    ("RMSprop", {}), ("rmsprop", {"alpha": 0.99, "momentum": 0.5, "centered": True}),
    ("RMSprop", {"weight_decay": 0.01, "eps_in_sqrt": False, "bias_correction": True}),
    ("Adagrad", {}), ("Adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}),
    ("Adamax", {}), ("Adamax", {"betas": (0.8, 0.99)}),
    ("NAdam", {}), ("NAdam", {"weight_decay": 0.01, "momentum_decay": 4e-3}),
    ("RAdam", {}), ("RAdam", {"threshold": 4.5, "eps": 1e-6}),
    ("Adadelta", {}), ("Adadelta", {"rho": 0.8, "weight_decay": 0.01}),
    ("Rprop", {}), ("Rprop", {"etas": (0.4, 1.3), "step_sizes": (1e-5, 10)}),
    ("ASGD", {}), ("ASGD", {"lambd": 1e-3, "weight_decay": 0.01}),
    ("Adafactor", {}), ("Adafactor", {"momentum": 0.9, "weight_decay_rate": 0.01}),
    ("Muon", {}), ("Muon", {"weight_decay": 0.01, "momentum": 0.9}),
    # the optax configs a params file can spell beyond the torch names
    ("Adam", {"nesterov": True, "eps_root": 1e-8}), ("Adam", {"mu_dtype": "bfloat16"}),
    ("Adam", {"mu_dtype": "float16"}), ("NAdam", {"mu_dtype": "bfloat16"}),
    ("Muon", {"mu_dtype": "bfloat16"}),
    ("SGD", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
    ("Adafactor", {"momentum": 0.9, "dtype_momentum": "bfloat16"}),
    ("AdamW", {"weight_decay": 0.1, "mask": False}),
    ("AdamW", {"weight_decay": 0.1, "mask": True}),
    ("Adadelta", {"weight_decay": 0.01, "weight_decay_mask": False}),
    ("Adafactor", {"weight_decay_rate": 0.01, "weight_decay_mask": False}),
    ("Muon", {"weight_decay": 0.01, "weight_decay_mask": False}),
]
# the values of these configs are part of a case's id
_VALUED = ("mu_dtype", "accumulator_dtype", "dtype_momentum", "mask", "weight_decay_mask")


def case_id(name, configs) -> str:
    keys = [f"{k}={v}" if k in _VALUED else k for k, v in configs.items()]
    return f"{name}-{'-'.join(keys) or 'defaults'}"


def values(rng) -> dict:
    """One seeded value per tensor, away from zero (relative comparisons)."""
    out = {}
    for name, shape in SHAPES.items():
        a = rng.uniform(0.5, 1.5, shape) * rng.choice([-1, 1], shape)
        if name == "probe":
            out[name] = (a + 1j * rng.uniform(0.5, 1.5, shape)).astype(np.complex64)
        else:
            out[name] = np.asarray(a, np.float32)
    return out


def jax_params(v):
    return JaxParams(**{k: jnp.asarray(a) for k, a in v.items() if k != "probe"},
                     probe=Cplx(re=jnp.asarray(v["probe"].real), im=jnp.asarray(v["probe"].imag)))


def jax_numpy(p) -> dict:
    out = {k: np.asarray(getattr(p, k)) for k in PARAM_NAMES if k != "probe"}
    out["probe"] = np.asarray(p.probe.re) + 1j * np.asarray(p.probe.im)
    return out


def torch_step(opt, params, grads, niter, start):
    """The solver's step on given gradients (build_train_epoch's order)."""
    for name, t in params.named():
        t.grad = torch.tensor(grads[name]) if t.requires_grad else None
    O.mask_unstarted_grads(params, niter, start)
    frozen = O.unstarted_tensors(params, niter, start)
    kept = [t.detach().clone() for t in frozen]
    opt.step()
    with torch.no_grad():
        for t, k in zip(frozen, kept):
            t.copy_(k)


def run_both(name, configs, grad_accumulation=1, steps=STEPS):
    rng = np.random.default_rng(0)
    v = values(rng)
    grads = [values(rng) for _ in range(steps)]
    cfg = {"name": name, "configs": dict(configs)}
    jp = jax_params(v)
    tx, state, _, start = j_create_optimizer(cfg, UPDATE, jp, grad_accumulation=grad_accumulation)
    params = PtychoParams(**{k: torch.tensor(a) for k, a in v.items()})
    opt, _, start_t = O.create_optimizer(cfg, UPDATE, params, grad_accumulation=grad_accumulation)
    assert start_t == start
    for i, g in enumerate(grads):
        niter = jnp.int32(i + 1)
        updates, state = tx.update(j_mask(jax_params(g), niter, start), state, jp)
        jp = optax.apply_updates(jp, j_mask(updates, niter, start))
        torch_step(opt, params, g, i + 1, start)
    return jp, state, params, opt


def jax_state_values(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat if hasattr(x, "shape")}


def as_float(a) -> np.ndarray:
    """A state array in float64: the port's bfloat16 bits (an opaque 2-byte
    array) and JAX's bfloat16 (ml_dtypes) widened exactly."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.names is None and a.dtype.str == "|V2":
        a = O._widened(a)
    return np.asarray(a.astype(np.float32) if a.dtype.itemsize == 2 else a, np.float64)


# the relative size of one step of a 2-byte storage type (its machine epsilon)
STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def assert_state_equal(opt, state):
    ours = O.optim_state_values(opt)
    if "state" in ours:  # Adam: upstream's torch layout
        ours = O.torch_layout_to_keystr(ours, [g["name"] for g in opt.param_groups])
        ref = {O._canonical_key(k): v for k, v in jax_state_values(state).items()}
        ours = {O._canonical_key(k): v for k, v in ours.items()}
    else:
        ref = jax_state_values(state)
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        mine = np.asarray(ours[key])
        assert mine.dtype.itemsize == want.dtype.itemsize, (key, mine.dtype, want.dtype)
        rtol = STEP[want.dtype.name] if want.dtype.name in STEP else 1e-5
        got, want = as_float(mine), as_float(want)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * float(np.abs(want).max(initial=0.0)),
                                   err_msg=str(key))


@pytest.mark.parametrize("name, configs", CASES, ids=[case_id(n, c) for n, c in CASES])
def test_rule_matches_optax(name, configs):
    jp, state, params, opt = run_both(name, configs)
    ref = jax_numpy(jp)
    for key, t in params.named():
        np.testing.assert_allclose(np_(t), ref[key], rtol=1e-6, err_msg=key)
    assert_state_equal(opt, state)


def test_every_registry_name_builds():
    """The registry's names are the JAX package's, and each builds (LBFGS
    unwrapped even with grad_accumulation, as the JAX package's)."""
    assert sorted(O.OPTIMIZER_REGISTRY) == sorted(JAX_REGISTRY)
    for name in O.OPTIMIZER_REGISTRY_NAMES:
        params = PtychoParams(**{k: torch.tensor(a) for k, a in values(
            np.random.default_rng(1)).items()})
        opt, _, _ = O.create_optimizer({"name": name}, UPDATE, params, grad_accumulation=2)
        assert isinstance(opt, O.MultiSteps) != O.is_lbfgs(name)


@pytest.mark.parametrize("name, key", [("Adam", "amsgrad"), ("RMSprop", "alpha"),
                                       ("SGD", "dampening"), ("LBFGS", "max_iter")])
def test_dropped_torch_only_config_warns_in_both(name, key, capsys, monkeypatch):
    """A torch-only key is dropped with the same warning in both packages,
    and not switched on in the port (amsgrad stays off). Each package's
    vprint prints to this test's stdout only while its logger has no
    handler: a CustomLogger that an earlier test in the process installed
    writes to that test's captured stdout, so both loggers are emptied here."""
    for logger in ("ptyrad_tpu", "ptyrad_tpu_torch"):
        monkeypatch.setattr(logging.getLogger(logger), "handlers", [])
    params = PtychoParams(**{k: torch.tensor(a) for k, a in values(
        np.random.default_rng(2)).items()})
    cfg = {"name": name, "configs": {key: 1}}
    opt, _, _ = O.create_optimizer(cfg, UPDATE, params)
    ours = capsys.readouterr().out
    j_create_optimizer(cfg, UPDATE, jax_params(values(np.random.default_rng(2))))
    theirs = capsys.readouterr().out
    warning = f"WARNING: optimizer '{name}' does not support config '{key}'"
    assert warning in ours and warning in theirs
    if name == "Adam":
        assert not opt.param_groups[0]["amsgrad"]


def test_unknown_name_raises_the_same_value_error():
    params = PtychoParams(**{k: torch.tensor(a) for k, a in values(
        np.random.default_rng(3)).items()})
    with pytest.raises(ValueError) as ours:
        O.create_optimizer({"name": "Lion"}, UPDATE, params)
    with pytest.raises(ValueError) as theirs:
        j_create_optimizer({"name": "Lion"}, UPDATE, jax_params(values(np.random.default_rng(3))))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name, key, value, jax_error", [
    ("Muon", "muon_weight_dimension_numbers", [0, 1], ValueError),
    ("Muon", "muon_weight_dimension_numbers", {"reduction_axis": 0, "output_axis": 1},
     ValueError),
    ("LBFGS", "linesearch", "zoom", AttributeError), ("AdamW", "mask", [True], ValueError),
    ("Adafactor", "weight_decay_mask", {"obja": False}, None)],
    ids=["muon_dims-list", "muon_dims-dict", "lbfgs-linesearch", "adamw-mask-list",
         "adafactor-mask-dict"])
def test_unspellable_config_raises(name, key, value, jax_error):
    """The optax configs that take objects no params file can hold stay
    refused with the decision's reason. The JAX package cannot build them
    either (a ValueError for Muon's dimension numbers as a list or dict, or
    for a list mask), except a tree mask that optax never reads (Adafactor
    without weight_decay_rate), which the port refuses all the same."""
    v = values(np.random.default_rng(4))
    cfg = {"name": name, "configs": {key: value}}
    params = PtychoParams(**{k: torch.tensor(a) for k, a in v.items()})
    with pytest.raises(NotImplementedError, match=f"'{key}'.*(not ported|true, false or null)"):
        O.create_optimizer(cfg, UPDATE, params)
    if jax_error is not None:
        with pytest.raises(jax_error):
            j_create_optimizer(cfg, UPDATE, jax_params(v))


@pytest.mark.parametrize("value", ["bfloat16", "float16", "float32", "float64", "half", "float",
                                   "double", "single", "f2", np.float16, None])
def test_storage_dtype_reads_as_optax(value):
    """A dtype config names the storage type optax.utils.canonicalize_dtype
    gives it (64-bit types off: float64 is float32)."""
    ours = O.storage_dtype(value)
    theirs = optax._src.utils.canonicalize_dtype(value)
    assert (ours is None and theirs is None) or str(ours) == f"torch.{jnp.dtype(theirs).name}"


def test_storage_dtype_refuses_a_non_float():
    with pytest.raises(ValueError, match="not a floating type"):
        O.storage_dtype("int8")


@pytest.mark.parametrize("name, configs", [("Adam", {"mu_dtype": "bfloat16"}),
                                           ("SGD", {"momentum": 0.9,
                                                    "accumulator_dtype": "bfloat16"})],
                         ids=["Adam-mu_dtype", "SGD-accumulator_dtype"])
def test_jitted_update_stays_within_two_bf16_steps(name, configs, capsys):
    """The port holds optax's eager update bit for bit in a bfloat16 moment.
    Under jax.jit, XLA may skip the bfloat16 rounding of b1 * mu (it keeps
    the product in float32 for the sum), so the JAX package's jitted solver
    step parts from the eager rule in the last bfloat16 bit of some entries,
    which then evolve apart: after 5 steps the stored moment stays within
    two bfloat16 steps (2 x 2^-7) of its largest entry. Prints how many
    entries differ and by how much, step by step."""
    rng = np.random.default_rng(0)
    v = values(rng)
    grads = [values(rng) for _ in range(STEPS)]
    jp = jax_params(v)
    tx, eager, _, start = j_create_optimizer({"name": name, "configs": configs}, UPDATE, jp)
    jitted, update = eager, jax.jit(tx.update)
    _, _, _, opt = run_both(name, configs)
    report = []
    for i, g in enumerate(grads):
        g = j_mask(jax_params(g), jnp.int32(i + 1), start)  # run_both's gradients
        _, eager = tx.update(g, eager, jp)
        _, jitted = update(g, jitted, jp)
        a, b = jax_state_values(eager), jax_state_values(jitted)
        two = [k for k in a if a[k].dtype.itemsize == 2]
        worst = max(float(np.abs(as_float(a[k]) - as_float(b[k])).max())
                    / max(float(np.abs(as_float(a[k])).max()), 1e-30) for k in two)
        worst /= STEP["bfloat16"]
        report.append((i + 1, sum(int((as_float(a[k]) != as_float(b[k])).sum()) for k in two),
                       sum(a[k].size for k in two), worst))
        assert worst <= 2.0, report
    ours = O.optim_state_values(opt)
    for k in two:
        np.testing.assert_array_equal(as_float(ours[k]), as_float(a[k]), err_msg=k)
    with capsys.disabled():
        print(f"\n{name} {configs}: jitted against eager (step, differing entries, of, "
              f"largest difference in bfloat16 steps of the largest entry): {report}")
