"""The port's layer constructors and two functional signatures against the
JAX package's, on the CPU: each builds the JAX object and the port's from
the same arguments, in JAX's positional order where the port once took
its own, and compares the parameters and the output.

- ``incubate.nn.FusedMultiTransformer``: JAX's parameters and defaults
  (``dropout_rate`` second after ``dim_feedforward``, ``num_layers=-1``
  meaning one layer), its layer count and its output through the JAX
  state;
- ``nn.Linear``, ``nn.Embedding``, ``nn.LayerNorm``, ``nn.RMSNorm``:
  JAX's order, ``bias_attr=False`` / ``weight_attr=False`` dropping the
  parameter, ``padding_idx`` zeroing its row and its ids' outputs;
- ``FusedDecoder``'s ``rope_base`` (sixth, as in JAX), ``F.linear`` and
  ``F.layer_norm`` with ``name=``.

Arguments that the port has not ported (``sparse=True``, ``*_attrs``)
raise NotImplementedError naming ROADMAP item 10(e); an initializer in a
``ParamAttr`` draws the parameter (a ``Constant`` equal to JAX's).
Values at TOLERANCES["logits_fp32"].

Then ROADMAP Queue 3's D-I, each a case that fails on the port before
their repair: ``FusedFeedForward``'s ``*_attr``, ``nranks``, ``ring_id``
and ``name`` (D); ``ServingEngine.submit``'s ``repetition_penalty,
deadline_s, trace_id, attempt, priority`` (E); ``LlamaForCausalLM(c)``
(F); ``Dropout``'s ``name`` and ``Embedding.forward(x)`` (G); the
optimizers' ``name``, ``lazy_mode`` and ``use_multi_tensor`` and
``clear_grad(set_to_zero)`` (H); and a sweep over every public callable
of the port with a JAX counterpart of the same dotted name (I): JAX's
parameters with JAX's names, order, kinds and defaults, the port's
extras keyword-only, and a written list of documented exceptions.
"""
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import common as jcommon
from paddle_tpu.nn.layer import norm as jnorm
from paddle_tpu.nn.utils_ import ParamAttr
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import FusedDecoder
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Embedding, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm
from paddle_tpu_torch.weights import from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["logits_fp32"]


def _state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _load(tlayer, state):
    tlayer.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()})


def _redraw(jlayer, seed):
    """Every parameter of the JAX layer redrawn from numpy (nonzero
    biases, scales near 1), so a dropped or misplaced parameter shows."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jlayer.state_dict().items():
        z = rng.standard_normal(tuple(v.shape))
        sd[k] = ((1 + 0.1 * z) if "scale" in k else 0.1 * z
                 if "bias" in k else z / np.sqrt(v.shape[-1])).astype(
            np.float32)
    jlayer.set_state_dict(sd)
    return sd


@pytest.mark.parametrize("args, kwargs", [
    ((64, 4, 256), {}),
    ((64, 4, 256), {"num_layers": -1}),
    ((64, 4, 256, 0.0, "gelu"), {}),
    ((64, 4, 256, 0.0, "gelu", False), {"epsilon": 1e-6}),
    ((64, 4, 256), {"dropout_rate": 0.0, "num_layers": 2, "nranks": 1,
                    "trans_qkvw": True, "ring_id": -1, "name": "fmt"}),
])
def test_fused_multi_transformer_matches_jax(args, kwargs):
    """The layer count, activation, normalize_before and epsilon JAX's
    arguments give, and the output of the port's layer holding JAX's
    state (a forward without caches)."""
    paddle.seed(0)
    jmod = JaxFMT(*args, **kwargs)
    tmod = FusedMultiTransformer(*args, **kwargs, device="cpu")
    assert tmod.num_layers == jmod.num_layers >= 1
    assert len(tmod.qkv_weights) == len(jmod.qkv_weights)
    for attr in ("activation", "normalize_before", "epsilon"):
        assert getattr(tmod, attr) == getattr(jmod, attr), attr
    state = _redraw(jmod, 1)
    jmod.eval()
    _load(tmod, state)
    tmod.eval()
    xs = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jmod(paddle.to_tensor(xs)).numpy()
    got = tmod(torch.from_numpy(xs)).numpy()
    assert not np.allclose(got, xs)               # the layers ran
    np.testing.assert_allclose(got, want, **TOL)
    # the bridge builds the same stack from the state alone
    bridged = from_jax_state(state, {"weight": np.zeros((8, 64), np.float32)},
                             {"weight": np.zeros((64, 8), np.float32)},
                             activation=jmod.activation,
                             normalize_before=jmod.normalize_before,
                             epsilon=jmod.epsilon, device="cpu")[0]
    np.testing.assert_allclose(bridged(torch.from_numpy(xs)).numpy(), want,
                               **TOL)


def test_fused_multi_transformer_refuses_attrs():
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        FusedMultiTransformer(64, 4, 256, qkv_weight_attrs=[None, None],
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ffn2_bias_attrs"):
        FusedMultiTransformer(64, 4, 256, 0.0, "gelu", True, *[None] * 11,
                              [ParamAttr()], device="cpu")


@pytest.mark.parametrize("args, kwargs", [
    ((4, 8, None, False), {}),
    ((4, 8), {"weight_attr": None}),
    ((4, 8, None, None, "fc"), {}),
    ((4, 8), {"bias_attr": ParamAttr(name="b")}),
])
def test_linear_matches_jax(args, kwargs):
    paddle.seed(0)
    jl = jcommon.Linear(*args, **kwargs)
    tl = Linear(*args, **kwargs, device="cpu")
    assert (tl.bias is None) == (jl.bias is None)
    state = _redraw(jl, 3)
    assert set(dict(tl.named_parameters())) == set(state)
    _load(tl, state)
    x = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


@pytest.mark.parametrize("args, kwargs", [
    ((8,), {"bias_attr": False}),
    ((8, 1e-5, None, False), {}),
    ((8, 1e-5, False), {}),
    ((8, 1e-6, None, None, "ln"), {}),
])
def test_layer_norm_matches_jax(args, kwargs):
    """Fresh parameters (ones, zeros, or none) equal JAX's, and so does
    the output."""
    jl = jnorm.LayerNorm(*args, **kwargs)
    tl = LayerNorm(*args, **kwargs, device="cpu")
    for name in ("weight", "bias"):
        jp, tp = getattr(jl, name), getattr(tl, name)
        assert (tp is None) == (jp is None), name
        if tp is not None:
            np.testing.assert_array_equal(tp.detach().numpy(),
                                          np.asarray(jp._data))
    x = np.random.default_rng(5).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


def test_rms_norm_matches_jax():
    jl = jnorm.RMSNorm(8, 1e-5, "rms")
    tl = RMSNorm(8, 1e-5, "rms", device="cpu")
    assert tl.epsilon == jl.epsilon
    x = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


@pytest.mark.parametrize("padding_idx", [None, 0, 7])
def test_embedding_matches_jax(padding_idx):
    """The padding row starts at zero, and its ids give zeros even where
    the row holds values (JAX masks the lookup); in JAX's order."""
    paddle.seed(0)
    jl = jcommon.Embedding(10, 4, padding_idx)
    tl = Embedding(10, 4, padding_idx, False, None, "emb", device="cpu")
    assert tl.padding_idx == jl.padding_idx
    if padding_idx is not None:
        assert not np.asarray(jl.weight._data)[padding_idx].any()
        assert not tl.weight[padding_idx].any()
    state = {"weight": np.random.default_rng(7).standard_normal(
        (10, 4)).astype(np.float32)}
    jl.set_state_dict(state)
    _load(tl, state)
    ids = np.array([[0, 3, 7], [7, 9, 0]], np.int64)
    want = jl(paddle.to_tensor(ids)).numpy()
    got = tl(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if padding_idx is not None:
        assert not got[ids == padding_idx].any()


def test_unported_arguments_raise():
    """``sparse=True`` is still refused, naming ROADMAP item 10(e). A
    ``ParamAttr`` with an initializer, refused before the training
    surface was ported, now draws the parameter from it: a ``Constant``
    gives JAX's values exactly, on the weight, the bias and an
    embedding."""
    from paddle_tpu.nn.initializer import Constant as JaxConstant
    from paddle_tpu_torch.nn.initializer import Constant
    from paddle_tpu_torch.nn.utils_ import ParamAttr as TorchParamAttr
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        Embedding(10, 4, None, True, device="cpu")
    jinit = ParamAttr(initializer=JaxConstant(0.5))
    tinit = TorchParamAttr(initializer=Constant(0.5))
    for jbuild, tbuild in (
            (lambda: jcommon.Linear(4, 8, jinit),
             lambda: Linear(4, 8, tinit, device="cpu")),
            (lambda: jcommon.Linear(4, 8, None, jinit),
             lambda: Linear(4, 8, None, tinit, device="cpu",
                            generator=torch.Generator().manual_seed(0))),
            (lambda: jcommon.Embedding(10, 4, weight_attr=jinit),
             lambda: Embedding(10, 4, weight_attr=tinit, device="cpu"))):
        paddle.seed(0)
        jl, tl = jbuild(), tbuild()
        jstate = {k: np.asarray(v._data) for k, v in jl.state_dict().items()}
        tstate = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
        assert set(tstate) == set(jstate)
        for k, v in jstate.items():
            if np.all(v == 0.5):
                np.testing.assert_array_equal(tstate[k], v, err_msg=k)
        if isinstance(tl, Linear) and tl.bias is not None \
                and np.all(jstate["bias"] == 0.5):
            assert not tl.weight.requires_grad      # trainable=False


def test_functional_name_arguments():
    rng = np.random.default_rng(8)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((3, 4), (4, 5)))
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        F.linear(*map(torch.from_numpy, (x, w, b)), name="fc").numpy(),
        JF.linear(*map(paddle.to_tensor, (x, w, b)), name="fc").numpy(),
        **TOL)
    g, beta = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        F.layer_norm(torch.from_numpy(x), 4, torch.from_numpy(g),
                     torch.from_numpy(beta), 1e-5, name="ln").numpy(),
        JF.layer_norm(paddle.to_tensor(x), 4, paddle.to_tensor(g),
                      paddle.to_tensor(beta), 1e-5, name="ln").numpy(),
        **TOL)


def test_fused_decoder_takes_rope_base_sixth():
    """JAX's (fmt, embed, head, max_seq_len, use_rotary, rope_base,
    weight_quant, kv_quant): the seventh positional is weight_quant on
    both sides, and the stacked weights are bit-equal."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    paddle.seed(0)
    jmods = (JaxFMT(64, 4, 128, num_layers=2), jcommon.Embedding(32, 64),
             jcommon.Linear(64, 32, bias_attr=False))
    for i, m in enumerate(jmods):
        _redraw(m, 10 + i)
    tmods = from_jax_state(*(_state(m) for m in jmods), device="cpu")
    for quant in (None, "int8"):
        jdec = JaxDecoder(*jmods, 128, False, 10000.0, quant)
        tdec = FusedDecoder(*tmods, 128, False, 10000.0, quant,
                            device="cpu")
        assert tdec._weight_quant_mode() == jdec._weight_quant_mode()
        want = jdec._stacked()
        got = tdec._stacked()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    # rotary at another base: JAX's refusal, on both sides
    with pytest.raises(NotImplementedError, match="rotary base"):
        JaxDecoder(*jmods, 128, True, 500000.0)
    with pytest.raises(NotImplementedError, match="rotary base"):
        FusedDecoder(*tmods, 128, True, 500000.0, device="cpu")


# ---------------------------------------------------------------------------
# The signatures of ROADMAP Queue 3 D-I: a JAX-style call binds to the same
# parameters in the port, or raises NotImplementedError naming its item.

def test_fused_feedforward_takes_jax_parameters():
    """D: JAX's eight ``*_attr``, ``nranks``, ``ring_id`` and ``name``
    after ``normalize_before``, so ``name=`` builds and a positional
    ``*_attr`` never lands in the port's ``dtype``; a non-None ``*_attr``
    raises naming 10(e), and so does a model-parallel ``nranks`` /
    ``ring_id`` (training's tensor parallelism, fleet's layers);
    ``dtype``, ``device`` and ``seed`` are keyword-only."""
    from paddle_tpu.incubate.nn import FusedFeedForward as JaxFFN
    from paddle_tpu_torch.incubate.nn import FusedFeedForward
    args = (16, 32, 0.0, 1e-5, "gelu", None, True, *[None] * 8, 1, -1, "ffn")
    jl = JaxFFN(*args)
    tl = FusedFeedForward(*args, device="cpu")
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    for attr in ("normalize_before", "activation", "epsilon",
                 "dropout_rate", "act_dropout_rate"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    FusedFeedForward(16, 32, name="ffn", device="cpu")
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        FusedFeedForward(16, 32, 0.0, 1e-5, "gelu", None, True,
                         ParamAttr(), device="cpu")
    with pytest.raises(NotImplementedError, match="ln2_bias_attr"):
        FusedFeedForward(16, 32, ln2_bias_attr=ParamAttr(), device="cpu")
    for kw in ({"nranks": 2}, {"ring_id": 0}):
        with pytest.raises(NotImplementedError, match="10\\(e\\)"):
            FusedFeedForward(16, 32, device="cpu", **kw)


def _toy_engine():
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.weights import random_state
    mods = from_jax_state(*random_state(np.random.default_rng(0), 16, 2, 32,
                                        1, 32), device="cpu")
    return ServingEngine(*mods, num_slots=2, max_seq_len=32, device="cpu")


def test_submit_takes_jax_parameters():
    """E: ``submit``'s ``repetition_penalty, deadline_s, trace_id,
    attempt, priority`` in JAX's order. JAX's ValueErrors for a penalty
    without ``enable_repetition_penalty``, ``attempt < 1`` and an unknown
    class; a deadline and a non-default class are accepted and kept on
    the request; the trace id and attempt stay on the request; the tokens
    are those of a plain submit."""
    eng = _toy_engine()
    prompt = [1, 2, 3]
    rid = eng.submit(prompt, 4, None, 0, 1.0, None, "trace-7", 2, "normal")
    req = eng._req_index[rid]
    assert (req.rid, req.trace_id, req.attempt, req.priority,
            req.repetition_penalty, req.deadline_s) == \
        (rid, "trace-7", 2, "normal", 1.0, None)
    plain = eng.submit(prompt, 4)
    eng.run()
    np.testing.assert_array_equal(eng.results[rid]["tokens"],
                                  eng.results[plain]["tokens"])
    for kw, err, match in (
            ({"repetition_penalty": 1.2}, ValueError,
             "enable_repetition_penalty"),
            ({"attempt": 0}, ValueError, "attempt"),
            ({"priority": "urgent"}, ValueError, "priority")):
        with pytest.raises(err, match=match):
            eng.submit(prompt, 4, **kw)
    assert not eng.queue_depth
    late = eng.submit(prompt, 4, deadline_s=1.0)
    high = eng.submit(prompt, 4, priority="high")
    assert eng._req_index[late].deadline_s == 1.0
    assert eng.queue_depths() == {"high": 1, "normal": 1, "low": 0}
    assert eng._req_index[high].priority == "high"


def test_llama_takes_c():
    """F: JAX names the config ``c``; ``device``, ``dtype`` and ``seed``
    are the port's, keyword-only."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1,
                      num_heads=2, intermediate_size=32, max_position=16)
    model = LlamaForCausalLM(c=cfg, device="meta")
    assert model.config is cfg
    with pytest.raises(TypeError):
        LlamaForCausalLM(cfg, "meta")


def test_dropout_name_and_embedding_x():
    """G: ``Dropout(p, axis, mode, name)`` with the port's ``generator``
    keyword-only (a fourth positional was taken as the generator), and
    ``Embedding.forward(x)``."""
    from paddle_tpu_torch.nn.layer.common import Dropout
    d = Dropout(0.1, None, "upscale_in_train", "d")
    assert d.generator is None and d.p == 0.1
    Dropout(0.1, name="d")
    with pytest.raises(TypeError):
        Dropout(0.1, None, "upscale_in_train", "d", torch.Generator())
    emb = Embedding(10, 4, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1, 2]])
    assert torch.equal(emb(x=ids), emb(ids))


def test_optimizers_take_jax_parameters():
    """H: ``Optimizer``'s ``name`` fifth, ``Adam``'s ``lazy_mode`` before
    ``multi_precision`` then ``use_multi_tensor`` and ``name``,
    ``AdamW``'s ``lazy_mode`` before ``multi_precision`` then ``name``:
    a positional call sets the same ``multi_precision`` as in JAX, and the
    ignored arguments change no update. ``clear_grad(set_to_zero=True)``
    zeroes the gradients, as JAX's does."""
    from paddle_tpu_torch.optimizer import Adam, AdamW, Optimizer
    w = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    params = [("w", w)]
    assert not AdamW(1e-3, 0.9, 0.999, 1e-8, params, 0.01, None, None,
                     None, True)._multi_precision
    assert AdamW(1e-3, 0.9, 0.999, 1e-8, params, 0.01, None, None, None,
                 False, True)._multi_precision
    assert not Optimizer(0.1, params, None, None, "opt")._multi_precision
    assert Adam(1e-3, 0.9, 0.999, 1e-8, params, None, None, True, True,
                True, "a")._multi_precision
    AdamW(parameters=params, name="o")
    got = []
    for kw in ({}, {"lazy_mode": True, "name": "o"}):
        p = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
        opt = AdamW(0.1, parameters=[("p", p)], **kw)
        p.grad = torch.tensor([0.5, 0.5, -1.0])
        opt.step()
        got.append(p.detach().clone())
        opt.clear_grad(set_to_zero=True)
        assert torch.equal(p.grad, torch.zeros(3))
        opt.clear_grad()
        assert p.grad is None
    assert torch.equal(*got)


# ---------------------------------------------------------------------------
# I: every public callable of the port that has a JAX counterpart of the
# same dotted name takes JAX's parameters (name, order, kind, default) and
# its own extras keyword-only.

PORT = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"
PORT_MODULES = sorted(
    ".".join(("paddle_tpu_torch", *p.relative_to(PORT).with_suffix("").parts))
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _group(mod_name):
    """A sweep case: the port's subpackage holding the module, or
    ``top`` for the package's own modules."""
    sub = mod_name.split(".")[1:2]
    return sub[0] if sub and (PORT / sub[0]).is_dir() else "top"


PORT_GROUPS = sorted({_group(m) for m in PORT_MODULES})
# documented exceptions: dotted name -> reason (none since the request
# spans gave Telemetry.req_done JAX's signature)
SIGNATURE_EXCEPTIONS = {}
_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD,
        inspect.Parameter.VAR_POSITIONAL)


def _public_pairs(mod_name):
    """(dotted name, port callable, JAX callable) for every public
    function or class defined in the port module ``mod_name`` whose JAX
    module has a callable of the same name, and their shared public
    methods."""
    tm = importlib.import_module(mod_name)
    try:
        jm = importlib.import_module(
            "paddle_tpu" + mod_name[len("paddle_tpu_torch"):])
    except ImportError:
        return []
    pairs = []
    for attr, obj in vars(tm).items():
        jobj = getattr(jm, attr, None)
        if attr.startswith("_") or not callable(obj) or not callable(jobj) \
                or getattr(obj, "__module__", None) != mod_name:
            continue
        pairs.append((f"{mod_name}.{attr}", obj, jobj))
        if inspect.isclass(obj) and inspect.isclass(jobj):
            pairs += [(f"{mod_name}.{attr}.{m}", f, getattr(jobj, m))
                      for m, f in vars(obj).items()
                      if not m.startswith("_") and callable(f)
                      and callable(getattr(jobj, m, None))]
    return pairs


def _same_default(a, b):
    try:
        return a is b or bool(a == b)
    except Exception:                 # noqa: BLE001 - arrays, tensors
        return False


def signature_faults(port_obj, jax_obj):
    """How the port's signature departs from JAX's: its positional
    parameters must be JAX's (names, order, kinds, defaults), JAX's
    keyword-only ones and ``**kw`` present alike, and every extra of the
    port keyword-only."""
    try:
        ts, js = inspect.signature(port_obj), inspect.signature(jax_obj)
    except (TypeError, ValueError):
        return []
    tp, jp = list(ts.parameters.values()), list(js.parameters.values())
    faults = []
    tpos = [(p.name, p.kind) for p in tp if p.kind in _POS]
    jpos = [(p.name, p.kind) for p in jp if p.kind in _POS]
    if tpos != jpos:
        faults.append(f"positional {tpos} != JAX's {jpos}")
    tby = {p.name: p for p in tp}
    for p in jp:
        q = tby.get(p.name)
        if q is None:
            faults.append(f"no {p.name}")
        elif q.kind != p.kind:
            faults.append(f"{p.name} is {q.kind}, JAX's {p.kind}")
        elif p.default is not inspect.Parameter.empty \
                and not _same_default(q.default, p.default):
            faults.append(f"{p.name}={q.default!r}, JAX's {p.default!r}")
    jnames = {p.name for p in jp}
    faults += [f"extra {p.name} is {p.kind}" for p in tp
               if p.name not in jnames
               and p.kind != inspect.Parameter.KEYWORD_ONLY]
    return faults


@pytest.mark.parametrize("group", PORT_GROUPS)
def test_signatures_follow_jax(group):
    """Any later drift of a public signature from JAX's fails here (the
    port's modules under ``group``)."""
    mods = [m for m in PORT_MODULES if _group(m) == group]
    faults = {name: f for m in mods for name, t, j in _public_pairs(m)
              if name not in SIGNATURE_EXCEPTIONS
              and (f := signature_faults(t, j))}
    assert not faults, faults


def test_signature_sweep_sees_the_port():
    """The sweep compares well over a hundred callables, the checker
    flags what Queue 3 D-I were, and every documented exception still
    departs from JAX (else it goes off the list)."""
    pairs = [p for m in PORT_MODULES for p in _public_pairs(m)]
    assert len(pairs) > 100
    def before(a, b=1, c=None, *, device=None): ...  # noqa: E704
    def jax(a, b=1, name=None): ...                  # noqa: E704
    def extra(a, b=1, device=None): ...              # noqa: E704
    assert signature_faults(before, jax) and signature_faults(extra, jax)
    assert not signature_faults(jax, jax)
    byname = {name: (t, j) for name, t, j in pairs}
    for name in SIGNATURE_EXCEPTIONS:
        assert signature_faults(*byname[name]), name
