"""GPT-2 training in the port against the JAX package.

The JAX ``gpt2_tiny(dropout=0.0)`` (E=64, L=2, H=2, V=1024), fp32, is
built from ``paddle.seed(0)`` and its ``state_dict()`` moved into the port
with ``weights.gpt_from_jax_state``. The same numpy batch (B=2, S=32) then
goes through both: the logits, and 3 AdamW steps (lr 1e-3, weight_decay
0.01) — the loss of each step, every gradient of step 1 and every
parameter after step 3 — held to ``TOLERANCES["logits_fp32"]``,
``["train_loss_fp32"]``, ``["train_grads_fp32"]`` and
``["train_params_fp32"]``. The JAX side runs three ways: through its
composites; with ``PADDLE_TPU_FORCE_PALLAS=1`` (its flash attention and
LayerNorm Pallas kernels in interpret mode); and with
``PADDLE_TPU_FUSED_FFN=1`` and ``PADDLE_TPU_FUSED_FFN_BWD=1`` on the same
model at hidden 128 (FF 512), where JAX's fused FFN gate holds (K and F
multiples of 128, B * S a multiple of 8) and its fused FFN forward and
backward kernels run (``gpt2_tiny``'s hidden 64 would send it to the
composite). The port runs on the CPU under the same flags, where
attention, LayerNorm and the fused FFN take their kernels' plain
versions.
"""
import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import fused_ffn as jax_ffn
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, gpt2_tiny
from paddle_tpu_torch.ops import fused_ffn as ffn
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.weights import gpt_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, S, STEPS, LR, WD = 2, 32, 3, 1e-3, 0.01
TINY = {"vocab_size": 1024, "hidden_size": 64, "num_layers": 2,
        "num_heads": 2, "max_position": 128}
# each run: the model's configuration and the flags both sides run under
RUNS = {"composite": (TINY, {}),
        "pallas": (TINY, {"PADDLE_TPU_FORCE_PALLAS": "1"}),
        "fused_ffn": ({**TINY, "hidden_size": 128},
                      {"PADDLE_TPU_FUSED_FFN": "1",
                       "PADDLE_TPU_FUSED_FFN_BWD": "1"})}
FUSED_FFN_NAMES = ("fused_ffn_fwd", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw")


@contextlib.contextmanager
def _environ(flags):
    old = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _counting(module, names):
    """Count the calls of ``module``'s functions ``names`` inside."""
    counts = dict.fromkeys(names, 0)
    real = {n: getattr(module, n) for n in names}

    def spy(name):
        def call(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return call
    for n in names:
        setattr(module, n, spy(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(module, n, real[n])


def _batch(vocab=TINY["vocab_size"]):
    ids = np.random.default_rng(0).integers(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _jax_run(mode):
    """(state, logits, losses, step-1 grads, final params, JAX fused FFN
    kernel calls) of the JAX model, as numpy."""
    cfg, flags = RUNS[mode]
    with _environ(flags), _counting(jax_ffn, ("_fwd_kernel_call",
                                              "_bwd_kernel_calls")) as calls:
        paddle.seed(0)
        m = JaxGPT(JaxGPTConfig(**cfg, dropout=0.0))
        state = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
        x, y = (paddle.to_tensor(a.astype(np.int32)) for a in _batch())
        logits = m(x).numpy()
        opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                     parameters=m.parameters())
        losses, grads = [], None
        for i in range(STEPS):
            loss = m(x, labels=y)
            loss.backward()
            if i == 0:
                grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        params = {n: p.numpy() for n, p in m.named_parameters()}
    return state, logits, losses, grads, params, dict(calls)


def _port_run(state, mode):
    """(logits, losses, step-1 grads, final params, fused FFN calls)."""
    cfg, flags = RUNS[mode]
    model = gpt_from_jax_state(state, GPTConfig(**cfg, dropout=0.0),
                               device="cpu")
    x, y = (torch.from_numpy(a) for a in _batch())
    with _environ(flags), _counting(ffn, FUSED_FFN_NAMES) as calls:
        with torch.no_grad():
            logits = model(x).numpy()
        opt = AdamW(LR, parameters=model.named_parameters(), weight_decay=WD)
        losses, grads = [], None
        for i in range(STEPS):
            loss = model(x, labels=y)
            loss.backward()
            if i == 0:
                grads = {n: p.grad.clone().numpy()
                         for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return logits, losses, grads, params, dict(calls)


@functools.lru_cache(maxsize=None)
def _results(mode):
    """Both sides' runs under ``mode``, computed once per module."""
    jax_out = _jax_run(mode)
    return jax_out[1:], _port_run(jax_out[0], mode)


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    jax_out, port_out = _results(request.param)
    return jax_out[:4], port_out[:4]


@pytest.fixture(scope="module")
def fused_calls():
    """The fused FFN calls counted in both sides' ``fused_ffn`` runs."""
    jax_out, port_out = _results("fused_ffn")
    return jax_out[4], port_out[4]


def test_state_names_and_shapes(runs, request):
    """The port's GPT has the JAX model's parameter names and shapes."""
    (*_, want), _ = runs
    cfg, _ = RUNS[request.node.callspec.params["runs"]]
    port = GPTForCausalLM(GPTConfig(**cfg, dropout=0.0), device="cpu")
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} \
        == {n: w.shape for n, w in want.items()}
    assert all(p.requires_grad for p in port.parameters())


def test_logits(runs):
    (want, *_), (got, *_) = runs
    assert got.shape == (B, S, TINY["vocab_size"])
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])


def test_losses(runs):
    (_, want, *_), (_, got, *_) = runs
    np.testing.assert_allclose(got, want, **TOLERANCES["train_loss_fp32"])
    assert got[-1] < got[0]


def test_grads_after_step_1(runs):
    (*_, want, _), (*_, got, _) = runs
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOLERANCES["train_grads_fp32"])


def test_params_after_step_3(runs):
    (*_, want), (*_, got) = runs
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOLERANCES["train_params_fp32"])


def test_tied_head_collects_both_grads():
    """The head is wte transposed, not a copy: wte's gradient equals the
    sum of the embedding's and the head's, each taken alone."""
    torch.manual_seed(0)
    model = gpt2_tiny(dropout=0.0, device="cpu", seed=1)
    x, y = (torch.from_numpy(a) for a in _batch())
    model(x, labels=y).backward()
    both = model.gpt.wte.weight.grad.clone()
    head_only = torch.autograd.grad(
        torch.nn.functional.cross_entropy(
            (model.gpt(x).detach() @ model.gpt.wte.weight.t()).reshape(
                -1, TINY["vocab_size"]), y.reshape(-1)),
        model.gpt.wte.weight)[0]
    assert not torch.allclose(both, head_only)
    emb_only = both - head_only
    # the rows of tokens absent from the batch get only the head's part
    absent = torch.ones(TINY["vocab_size"], dtype=torch.bool)
    absent[x.reshape(-1)] = False
    assert torch.all(emb_only[absent].abs() < 1e-6)
    assert emb_only[~absent].abs().sum() > 0


def test_fused_ffn_flag_takes_the_fused_ffn(fused_calls):
    """Under PADDLE_TPU_FUSED_FFN=1 (and _BWD=1) at hidden 128 both sides
    run their fused FFN: JAX its Pallas forward and backward kernels, the
    port fused_ffn's forward, dx and dW plain versions, once per layer
    and pass (the logits, then 3 steps)."""
    jax_calls, port_calls = fused_calls
    assert jax_calls["_fwd_kernel_call"] > 0
    assert jax_calls["_bwd_kernel_calls"] > 0
    n = TINY["num_layers"]
    assert port_calls == {"fused_ffn_fwd": n * (1 + STEPS),
                          "fused_ffn_bwd_dx": n * STEPS,
                          "fused_ffn_bwd_dw": n * STEPS}


def test_dropout_training_is_seeded():
    """dropout 0.1 (attention and residual) on the CPU: finite losses,
    the same for the same seed, different for another, and inference
    (eval) deterministic."""
    x, y = (torch.from_numpy(a) for a in _batch())
    losses = [gpt2_tiny(device="cpu", seed=s)(x, labels=y).item()
              for s in (3, 3, 4)]
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
    model = gpt2_tiny(device="cpu", seed=3).eval()
    with torch.no_grad():
        assert torch.equal(model(x), model(x))


def _numpy_adam(w, grads, lr, wd=0.0, l2=0.0, b1=0.9, b2=0.999, eps=1e-8):
    """Paddle's Adam update in numpy fp32 for one parameter: ``l2`` folded
    into the gradient (Adam's weight_decay), ``wd`` decoupled (AdamW's)."""
    f = np.float32
    m = np.zeros_like(w)
    v = np.zeros_like(w)
    b1p = b2p = f(1)
    for g in grads:
        g = g + f(l2) * w
        b1p, b2p = f(b1p * f(b1)), f(b2p * f(b2))
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * g * g
        w = w - f(lr) * ((m / (f(1) - b1p)) / (np.sqrt(v / (f(1) - b2p))
                                                + f(eps)) + f(wd) * w)
    return w


@pytest.mark.parametrize("decay", [True, False])
def test_adamw_update_and_options(decay):
    """AdamW against Paddle's formula in numpy over 4 steps;
    apply_decay_param_fun sees the parameter's name and lr_ratio scales
    its rate."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(4)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    seen = []
    opt = AdamW(0.01, parameters=[("w", p)], weight_decay=0.1,
                apply_decay_param_fun=lambda n: seen.append(n) or decay,
                lr_ratio=lambda _: 0.5)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_grad()
        assert p.grad is None
    assert seen == ["w"] * 4
    want = _numpy_adam(w0, grads, 0.005, wd=0.1 if decay else 0.0)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_adam_folds_l2_decay_into_the_gradient():
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((4, 4)).astype(np.float32)
    grads = [rng.standard_normal((4, 4)).astype(np.float32)
             for _ in range(3)]
    q = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    adam = Adam(0.01, parameters=[q], weight_decay=0.1)
    for g in grads:
        q.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(q.detach().numpy(),
                               _numpy_adam(w0, grads, 0.01, l2=0.1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opt_cls", [Adam, AdamW])
@pytest.mark.parametrize("decay", ["l2decay", "callable"])
def test_weight_decay_objects_are_refused(opt_cls, decay, monkeypatch):
    """A weight_decay that is an ``L2Decay`` or a callable, refused
    before the regularizers were ported, now gives JAX's update: 3 steps
    of ``Adam`` (the decay folded into the gradient) and ``AdamW``
    (decoupled: the object's ``_coeff``, and JAX's 0.01 for a callable)
    on one parameter, against the JAX optimizer of the same name, within
    TOLERANCES["optimizer_fp32"]."""
    import jax.numpy as jnp
    from paddle_tpu.regularizer import L2Decay as JaxL2Decay
    from paddle_tpu.tensor.tensor import Parameter as JaxParameter
    from paddle_tpu.tensor.tensor import Tensor as JaxTensor
    from paddle_tpu_torch.regularizer import L2Decay
    monkeypatch.setenv("PADDLE_TPU_FUSE_EAGER_STEP", "0")
    jdecay, tdecay = {"l2decay": (JaxL2Decay(0.1), L2Decay(0.1)),
                      "callable": ((lambda g, w: g + 0.1 * w),
                                   (lambda g, w: g + 0.1 * w))}[decay]
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    jp = JaxParameter(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jopt = getattr(paddle.optimizer, opt_cls.__name__)(
        0.01, parameters=[jp], weight_decay=jdecay)
    opt = opt_cls(0.01, parameters=[p], weight_decay=tdecay)
    for _ in range(3):
        g = rng.standard_normal((3, 2)).astype(np.float32)
        jp.grad = JaxTensor(jnp.asarray(g))
        p.grad = torch.from_numpy(g)
        jopt.step()
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp._data),
                               **TOLERANCES["optimizer_fp32"])


def test_multi_precision_keeps_fp32_masters():
    """bf16 parameters with multi_precision: the update runs on fp32
    masters, which the bf16 parameters are rounded from after each step
    (small steps that a bf16 weight alone would lose accumulate)."""
    p = torch.nn.Parameter(torch.ones(64, dtype=torch.bfloat16))
    opt = AdamW(1e-4, parameters=[p], weight_decay=0.0,
                multi_precision=True)
    for _ in range(3):
        p.grad = torch.ones(64, dtype=torch.bfloat16)
        opt.step()
    master = opt._master_weights[id(p)]
    assert master.dtype == torch.float32 and p.dtype == torch.bfloat16
    np.testing.assert_allclose(master.numpy(), 1 - 3e-4, rtol=1e-5)
    assert torch.equal(p, master.to(torch.bfloat16))
