"""The port's optimizers, learning-rate schedulers, regularizers and
gradient clips against the JAX package's, on the CPU.

Each case builds the same parameters (a [4, 3] matrix and a [3] vector,
from a seeded numpy draw) on both sides, hands both optimizers the same
gradients step after step (assigned to ``.grad``; no model), and holds
the port's parameters (and, under ``multi_precision``, its fp32 masters)
to JAX's: fp32 within TOLERANCES["optimizer_fp32"], bf16 parameters
within ["optimizer_bf16_params"]. The JAX optimizers run their per
parameter loop (``PADDLE_TPU_FUSE_EAGER_STEP=0``), the same arithmetic as
their fused program without its compile per case; one case runs the
fused program.

Covered: every optimizer of JAX's ``optimizer/__init__.py`` with and
without ``multi_precision``; L2 / L1 decay objects, a callable and a
number as ``weight_decay``, and a parameter's own regularizer and lr
scale; the 17 schedulers over 30 steps and ``state_dict`` round trips,
and one inside an optimizer; the three clips; ``state_dict`` /
``set_state_dict``; ``optimizer_state_from_jax`` (k JAX steps, then one
step on each side); ``minimize``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import regularizer as jreg
from paddle_tpu.tensor.tensor import Parameter as JaxParameter
from paddle_tpu.tensor.tensor import Tensor as JaxTensor
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.nn.utils_ import ParamAttr
from paddle_tpu_torch.weights import optimizer_state_from_jax

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["optimizer_fp32"]
TOL_BF16 = TOLERANCES["optimizer_bf16_params"]
SHAPES = ((4, 3), (3,))

# name -> the constructor's keyword arguments, in a setting where every
# branch of its update runs within STEPS steps
OPTIMIZERS = {
    "SGD": {"learning_rate": 0.1},
    "Momentum": {"learning_rate": 0.1, "momentum": 0.9},
    "Momentum-nesterov": {"learning_rate": 0.1, "use_nesterov": True},
    "Adam": {"learning_rate": 0.01},
    "AdamW": {"learning_rate": 0.01, "weight_decay": 0.1},
    "Adafactor": {"learning_rate": 0.01},
    "Adafactor-beta1": {"learning_rate": 0.01, "beta1": 0.9,
                        "scale_parameter": False},
    "Adagrad": {"learning_rate": 0.1, "initial_accumulator_value": 0.1},
    "Adadelta": {"learning_rate": 1.0},
    "RMSProp": {"learning_rate": 0.01},
    "RMSProp-centered": {"learning_rate": 0.01, "momentum": 0.9,
                         "centered": True},
    "Lamb": {"learning_rate": 0.01},
    "Adamax": {"learning_rate": 0.01},
    "NAdam": {"learning_rate": 0.01},
    "RAdam": {"learning_rate": 0.01},
    "ASGD": {"learning_rate": 0.1, "batch_num": 3},
    "Rprop": {"learning_rate": 0.01},
}
# RAdam takes its rectified branch from step 6 at beta2 0.999
STEPS = 8
# the optimizers that fold a weight_decay into the gradient (_decayed)
DECAYED = ("SGD", "Momentum", "Adam", "Adafactor", "Adagrad", "Adadelta",
           "RMSProp", "Adamax", "NAdam", "RAdam", "ASGD")


@pytest.fixture(autouse=True)
def _per_parameter_loop(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSE_EAGER_STEP", "0")


def _draws(seed, steps):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return ws, grads


class Pair:
    """The same parameters and optimizer on both sides."""

    def __init__(self, name, seed=0, mp=False, steps=STEPS, sched=None,
                 **kw):
        self.ws, self.grads = _draws(seed, steps)
        self.jdt = jnp.bfloat16 if mp else jnp.float32
        self.tdt = torch.bfloat16 if mp else torch.float32
        self.jps = [JaxParameter(jnp.asarray(w).astype(self.jdt))
                    for w in self.ws]
        self.tps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(
            self.tdt)) for w in self.ws]
        cls = name.split("-")[0]
        args = {**OPTIMIZERS.get(name, {}), **kw}
        if mp:
            args["multi_precision"] = True
        jargs = dict(args)
        if sched:
            self.js, self.ts = _schedulers(sched)
            jargs["learning_rate"], args["learning_rate"] = self.js, self.ts
        self.jopt = getattr(joptim, cls)(parameters=self.jps, **jargs)
        self.topt = getattr(toptim, cls)(parameters=self.tps, **args)

    def step(self, gs):
        for jp, tp, g in zip(self.jps, self.tps, gs):
            jp.grad = JaxTensor(jnp.asarray(g).astype(self.jdt))
            tp.grad = torch.from_numpy(g.copy()).to(self.tdt)
        self.jopt.step()
        self.topt.step()

    def run(self, steps=None):
        for gs in self.grads[:steps]:
            self.step(gs)
        return self

    def check(self, what=""):
        for i, (jp, tp) in enumerate(zip(self.jps, self.tps)):
            want = np.asarray(jp._data.astype(jnp.float32))
            got = tp.detach().float().numpy()
            np.testing.assert_allclose(
                got, want, **(TOL if self.tdt == torch.float32 else TOL_BF16),
                err_msg=f"{what} parameter {i}")
            if self.tdt != torch.float32:
                np.testing.assert_allclose(
                    self.topt._master_weights[id(tp)].numpy(),
                    np.asarray(self.jopt._master_weights[id(jp)]._data),
                    **TOL, err_msg=f"{what} master {i}")


@pytest.mark.parametrize("mp", [False, True], ids=["fp32", "bf16-mp"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, mp):
    """STEPS updates; the parameters (and masters) after each."""
    pair = Pair(name, mp=mp)
    for i, gs in enumerate(pair.grads):
        pair.step(gs)
        pair.check(f"{name} step {i + 1}")


def _decays():
    """weight_decay values that JAX and the port read alike, as (JAX's,
    the port's)."""
    return {"number": (0.05, 0.05),
            "l2decay": (jreg.L2Decay(0.1), treg.L2Decay(0.1)),
            "l1decay": (jreg.L1Decay(0.1), treg.L1Decay(0.1)),
            "callable": ((lambda g, w: g + 0.1 * w * w),
                         (lambda g, w: g + 0.1 * w * w))}


@pytest.mark.parametrize("kind", ["number", "l2decay", "l1decay",
                                  "callable"])
def test_weight_decay_matches_jax(kind):
    """Each optimizer that folds a decay into its gradient, with
    ``weight_decay`` a number, an L2Decay, an L1Decay or a callable."""
    jdecay, tdecay = _decays()[kind]
    for name in DECAYED:
        pair = Pair(name, steps=3)
        for opt, d in ((pair.jopt, jdecay), (pair.topt, tdecay)):
            opt._weight_decay = d
        pair.run().check(f"{name} weight_decay={kind}")


def test_parameter_regularizer_and_lr_scale():
    """A parameter's own regularizer comes before the optimizer's
    weight_decay, and its ``optimize_attr`` scales its learning rate;
    the other parameter keeps the optimizer's decay and rate. Under
    AdamW the own regularizer is folded in only where the decoupled
    decay is off (apply_decay_param_fun), as in JAX."""
    for name, kw in (("SGD", {"weight_decay": 0.05}),
                     ("Adam", {"weight_decay": 0.05}),
                     ("RMSProp", {"weight_decay": 0.05}),
                     ("AdamW", {"apply_decay_param_fun":
                                lambda n: n.endswith("1")})):
        pair = Pair(name, steps=3, **kw)
        for jp, tp, (jr, tr) in zip(pair.jps, pair.tps, (
                (jreg.L1Decay(0.2), treg.L1Decay(0.2)),
                (jreg.L2Decay(0.3), treg.L2Decay(0.3)))):
            jp.regularizer, tp.regularizer = jr, tr
        pair.jps[0].optimize_attr = {"learning_rate": 0.5}
        pair.tps[0].optimize_attr = {"learning_rate": 0.5}
        if name == "AdamW":
            # JAX hands apply_decay_param_fun the parameter's name;
            # the port its name in the optimizer (param_<i> here)
            for jp, i in zip(pair.jps, (0, 1)):
                jp.name = f"param_{i}"
        pair.run().check(f"{name} with its own regularizer")


def test_param_attr_sets_the_optimizer_attributes():
    """``Linear``'s ``ParamAttr`` puts its lr scale, regularizer,
    ``need_clip`` and ``trainable`` on the parameters."""
    reg = treg.L2Decay(0.5)
    lin = Linear(3, 2, ParamAttr(learning_rate=0.25, regularizer=reg,
                                 need_clip=False),
                 ParamAttr(trainable=False), device="cpu", trainable=True,
                 generator=torch.Generator().manual_seed(0))
    assert lin.weight.optimize_attr == {"learning_rate": 0.25}
    assert lin.weight.regularizer is reg and lin.weight.need_clip is False
    assert lin.weight.requires_grad and not lin.bias.requires_grad


SCHEDULERS = {
    "NoamDecay": ((128, 10), {"learning_rate": 1.0}),
    "ExponentialDecay": ((0.1, 0.9), {}),
    "NaturalExpDecay": ((0.1, 0.1), {}),
    "InverseTimeDecay": ((0.1, 0.5), {}),
    "PolynomialDecay": ((0.1, 20), {"end_lr": 0.01, "power": 2.0}),
    "PolynomialDecay-cycle": ((0.1, 7), {"cycle": True}),
    "LinearWarmup": ((0.1, 5, 0.0, 0.1), {}),
    "PiecewiseDecay": (([5, 12], [0.1, 0.05, 0.01]), {}),
    "CosineAnnealingDecay": ((0.1, 10), {"eta_min": 0.001}),
    "MultiStepDecay": ((0.1, [4, 9, 20]), {"gamma": 0.5}),
    "StepDecay": ((0.1, 4), {"gamma": 0.5}),
    "LambdaDecay": ((0.1, lambda e: 0.95 ** e), {}),
    "ReduceOnPlateau": ((0.1,), {"patience": 2, "cooldown": 1}),
    "OneCycleLR": ((0.1, 30), {}),
    "CyclicLR": ((0.01, 0.1, 4), {"step_size_down": 6,
                                  "mode": "triangular2"}),
    "LinearLR": ((0.1, 20), {}),
    "CosineAnnealingWarmRestarts": ((0.1, 5), {"T_mult": 2}),
}


def _schedulers(name):
    cls = name.split("-")[0]
    args, kw = SCHEDULERS[name]
    if cls == "LinearWarmup":      # wrapping another scheduler
        return tuple(getattr(mod, cls)(
            mod.PolynomialDecay(0.1, 10, end_lr=0.0), *args[1:], **kw)
            for mod in (joptim.lr, toptim.lr))
    return tuple(getattr(mod, cls)(*args, **kw)
                 for mod in (joptim.lr, toptim.lr))


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax(name):
    """30 steps, the rate after each (ReduceOnPlateau fed a metric that
    stalls); then a ``state_dict`` round trip into a fresh scheduler of
    the port continues alike."""
    js, ts = _schedulers(name)
    metrics = np.concatenate([np.linspace(5, 3, 10), np.full(20, 3.0)])
    for i in range(30):
        assert ts() == pytest.approx(js(), rel=1e-12, abs=1e-15), i
        if name == "ReduceOnPlateau":
            js.step(metrics[i])
            ts.step(torch.tensor(metrics[i]))
        else:
            js.step()
            ts.step()
    fresh = _schedulers(name)[1]
    fresh.set_state_dict(ts.state_dict())
    for _ in range(3):
        assert fresh() == pytest.approx(ts(), rel=1e-12, abs=1e-15)
        for s in (fresh, ts):
            s.step(1.0) if name == "ReduceOnPlateau" else s.step()


def test_scheduler_inside_an_optimizer():
    """``Momentum`` under ``LinearWarmup(PolynomialDecay)``, the
    scheduler advanced after each step: the rates and parameters equal
    JAX's; ``set_lr`` refuses under a scheduler."""
    pair = Pair("Momentum", sched="LinearWarmup")
    js, ts = pair.js, pair.ts
    for gs in pair.grads:
        assert pair.topt.get_lr() == pytest.approx(pair.jopt.get_lr())
        pair.step(gs)
        js.step()
        ts.step()
    pair.check("under a scheduler")
    with pytest.raises(RuntimeError):
        pair.topt.set_lr(0.1)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clip_matches_jax(clip):
    """Each clip in an SGD step at lr 1 (so the parameters move by the
    clipped gradients), gradients large enough that it bites; and the
    clip alone on the pairs."""
    jclip, tclip = {
        "value": (jnn.ClipGradByValue(0.5), tnn.ClipGradByValue(0.5)),
        "norm": (jnn.ClipGradByNorm(1.0), tnn.ClipGradByNorm(1.0)),
        "global_norm": (jnn.ClipGradByGlobalNorm(1.0),
                        tnn.ClipGradByGlobalNorm(1.0))}[clip]
    pair = Pair("SGD", steps=3, learning_rate=1.0)
    pair.jopt._grad_clip, pair.topt._grad_clip = jclip, tclip
    pair.run().check(clip)
    gs = [torch.from_numpy(g * 3) for g in pair.grads[0]]
    got = tclip(list(zip(pair.tps, gs)))
    want = jclip([(p, JaxTensor(jnp.asarray(g.numpy())))
                  for p, g in zip(pair.jps, gs)])
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), **TOL)


def test_global_norm_clip_skips_need_clip_false():
    """A parameter with ``need_clip=False`` keeps its gradient and adds
    nothing to the global norm."""
    a, b = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(
        torch.zeros(2))
    b.need_clip = False
    out = tnn.ClipGradByGlobalNorm(1.0)([(a, torch.tensor([3.0, 4.0])),
                                         (b, torch.tensor([30.0, 40.0]))])
    torch.testing.assert_close(out[0][1], torch.tensor([0.6, 0.8]))
    torch.testing.assert_close(out[1][1], torch.tensor([30.0, 40.0]))


STATE_CASES = ("Adam", "AdamW", "Adafactor", "NAdam", "RAdam", "ASGD",
               "Rprop", "Adadelta")


def _suffixes(sd, names):
    out = {}
    for k, v in sd.items():
        owner = next((n for n in names if k.startswith(n + "_")), None)
        if owner is not None:
            out[(names.index(owner), k[len(owner) + 1:])] = v
    return out


@pytest.mark.parametrize("name", STATE_CASES)
def test_state_dict_round_trip(name):
    """k steps; the port's ``state_dict`` holds JAX's slots by suffix
    with JAX's values, and loaded into a fresh optimizer over copies of
    the parameters it continues exactly as the first."""
    pair = Pair(name, mp=name == "Adam", steps=5).run(4)
    tsd = pair.topt.state_dict()
    jsd = pair.jopt.state_dict()
    assert tsd["@step"] == jsd["@step"] == 4
    got = _suffixes(tsd, [f"param_{i}" for i in range(2)])
    want = _suffixes(jsd, [p.name for p in pair.jps])
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(
            np.asarray(got[key].numpy() if torch.is_tensor(got[key])
                       else got[key]), np.asarray(v._data), **TOL,
            err_msg=str(key))
    copies = [torch.nn.Parameter(p.detach().clone()) for p in pair.tps]
    opt2 = getattr(toptim, name)(parameters=copies,
                                 multi_precision=name == "Adam",
                                 **OPTIMIZERS[name])
    opt2.set_state_dict(tsd)
    for p, q, g in zip(pair.tps, copies, pair.grads[4]):
        p.grad = torch.from_numpy(g.copy()).to(p.dtype)
        q.grad = torch.from_numpy(g.copy()).to(q.dtype)
    pair.topt.step()
    opt2.step()
    for p, q in zip(pair.tps, copies):
        assert torch.equal(p, q)


@pytest.mark.parametrize("name", ["AdamW-sched", "Adam-mp", "Momentum",
                                  "Adafactor", "NAdam", "RAdam", "ASGD",
                                  "Rprop", "Lamb"])
def test_optimizer_state_from_jax(name):
    """k JAX steps; the port's optimizer over the JAX parameters' values
    loads JAX's state (``optimizer_state_from_jax``, by parameter order),
    then one step on each side gives the same parameters."""
    k, mp, cls = 5, name == "Adam-mp", name.split("-")[0]
    sched = "LinearWarmup" if name == "AdamW-sched" else None
    pair = Pair(cls, mp=mp, steps=k + 1, sched=sched)
    for gs in pair.grads[:k]:
        for jp, g in zip(pair.jps, gs):
            jp.grad = JaxTensor(jnp.asarray(g).astype(pair.jdt))
        pair.jopt.step()
        if sched:
            pair.js.step()
    tps = [torch.nn.Parameter(torch.from_numpy(np.asarray(
        jp._data.astype(jnp.float32))).to(pair.tdt)) for jp in pair.jps]
    kw = {"learning_rate": _schedulers(sched)[1]} if sched else {}
    opt = getattr(toptim, cls)(parameters=tps, multi_precision=mp,
                               **{**OPTIMIZERS[cls], **kw})
    optimizer_state_from_jax(pair.jopt.state_dict(), pair.jps, opt)
    assert opt._step_count == k
    pair.tps, pair.topt = tps, opt
    pair.step(pair.grads[k])
    pair.check(f"{name} after JAX's state")


def test_fused_jax_step_and_minimize(monkeypatch):
    """JAX's fused eager step (its default) under AdamW with a global
    norm clip and a scheduler against the port; then ``minimize`` on a
    quadratic loss on both sides."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_EAGER_STEP", "1")
    pair = Pair("AdamW", steps=4, sched="LinearWarmup")
    js, ts = pair.js, pair.ts
    pair.jopt._grad_clip = jnn.ClipGradByGlobalNorm(1.0)
    pair.topt._grad_clip = tnn.ClipGradByGlobalNorm(1.0)
    for gs in pair.grads:
        pair.step(gs)
        js.step()
        ts.step()
    pair.check("fused AdamW")
    jl = (pair.jps[0] * pair.jps[0]).sum() + pair.jps[1].sum()
    tl = (pair.tps[0] * pair.tps[0]).sum() + pair.tps[1].sum()
    assert pair.jopt.minimize(jl) == pair.topt.minimize(tl) == (None, None)
    pair.check("after minimize")
    assert all(p.grad is None for p in pair.tps)


def test_optimizer_exports_match_jax():
    """The optimizer namespace exports what JAX's does."""
    want = {n for n in dir(joptim) if not n.startswith("_")}
    got = {n for n in dir(toptim) if not n.startswith("_")}
    assert want - {"optimizer"} <= got
