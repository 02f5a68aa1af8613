"""The port's ServingEngine against the JAX package's, on the CPU.

Same bridged weights, same requests (prompts longer than the C=16 budget
columns, so prefill spans several dispatches), greedy: the tokens must be
identical to the JAX engine's under each of the port's three schedulers
— the default row-layout token budget, the flat token budget
(``flat_budget=True``, whose budget counters and step kinds must equal
JAX's too) and the phase scheduler (``token_budget=0``, bulk prefill).
Also: the metric reconciliations of check_serving_metrics, the
constructor's refusals of paths outside the slice, the default device,
and that the port never imports JAX or paddle_tpu.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.weights import from_jax_state

E, H, FF, L, V = 64, 4, 128, 2, 256
PKG = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"


def _models():
    """The bench toy model with every parameter redrawn from numpy."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    embed = Embedding(V, E)
    fmt = FusedMultiTransformer(E, H, FF, num_layers=L,
                                normalize_before=True)
    head = Linear(E, V, bias_attr=False)
    rng = np.random.default_rng(0)
    for lay in (fmt, embed, head):
        sd = {}
        for k, v in lay.state_dict().items():
            shape = tuple(v.shape)
            z = rng.standard_normal(shape)
            a = (1 + 0.1 * z if "scales" in k else 0.1 * z if "biases" in k
                 else z if lay is embed else z / np.sqrt(shape[-2]))
            sd[k] = a.astype(np.float32)
        lay.set_state_dict(sd)
    fmt.eval()
    states = [{k: np.asarray(v._data) for k, v in lay.state_dict().items()}
              for lay in (fmt, embed, head)]
    return (fmt, embed, head), from_jax_state(*states, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _requests():
    rng = np.random.default_rng(11)
    # (prompt length, max_new_tokens, eos, min_length)
    spec = [(5, 6, None, 0), (20, 8, None, 0), (40, 5, None, 0),
            (3, 10, None, 0), (33, 7, None, 0), (70, 9, None, 0),
            (17, 12, 144, 0), (9, 12, 144, 12)]
    return [(rng.integers(0, V, n), m, eos, ml) for n, m, eos, ml in spec]


def _serve(eng, reqs):
    rids = [eng.submit(p, max_new_tokens=m, eos_token_id=eos, min_length=ml)
            for p, m, eos, ml in reqs]
    eng.run()
    return [eng.results[r]["tokens"].tolist() for r in rids]


def test_greedy_tokens_match_jax(models, serving_metrics_ok):
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    reqs = _requests()
    want = _serve(JaxEngine(*jmods, num_slots=4, max_seq_len=128), reqs)
    eng = ServingEngine(*tmods, num_slots=4, max_seq_len=128, device="cpu")
    got = _serve(eng, reqs)
    assert got == want
    # the streams are not degenerate, and every request ran to its budget
    # or to eos (the min_length request may not stop early)
    assert len({t for toks in got for t in toks}) > 20
    assert len(got[-1]) == 12
    m = serving_metrics_ok(eng)
    assert m["requests_finished"] == len(reqs)
    assert m["budget_steps"] > 0 and m["budget_prefill_tokens"] == sum(
        len(p) for p, *_ in reqs)
    assert m["kv_blocks_used"] == 0          # every slot freed its blocks


@pytest.fixture(scope="module")
def row_tokens(models):
    """The port's default (row-layout) engine on the shared requests."""
    _, tmods = models
    return _serve(ServingEngine(*tmods, num_slots=4, max_seq_len=128,
                                device="cpu"), _requests())


BUDGET_COUNTERS = ("budget_steps", "budget_tokens_used",
                   "budget_prefill_tokens", "budget_decode_tokens",
                   "budget_padding_tokens", "decode_steps",
                   "tokens_emitted", "requests_finished")


@pytest.mark.parametrize("kwargs", [
    {"flat_budget": True, "prefill_cap": 16},   # the flat kernel's path
    {"token_budget": 0},                        # phase mode, bulk prefill
], ids=["flat", "phase"])
def test_scheduler_matches_jax_and_row(models, row_tokens, kwargs,
                                       serving_metrics_ok):
    """The same requests through the JAX engine and the port's engine
    with the same scheduler option: identical greedy tokens, equal to the
    port's row engine too; identical budget counters and step kinds."""
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    reqs = _requests()[:5] + _requests()[6:]
    jeng = JaxEngine(*jmods, num_slots=4, max_seq_len=128, **kwargs)
    want = _serve(jeng, reqs)
    eng = ServingEngine(*tmods, num_slots=4, max_seq_len=128, device="cpu",
                        **kwargs)
    got = _serve(eng, reqs)
    assert got == want
    assert got == row_tokens[:5] + row_tokens[6:]
    m, jm = serving_metrics_ok(eng), jeng.metrics()
    assert {k: m[k] for k in BUDGET_COUNTERS} == \
        {k: jm[k] for k in BUDGET_COUNTERS}
    assert [st["kind"] for st in eng.telemetry.steps] == \
        [st["kind"] for st in jeng.telemetry.steps]
    assert m["kv_blocks_used"] == 0
    if kwargs.get("flat_budget"):
        # the flat stream packs prompts without a column cap
        assert m["budget_padding_tokens"] < m["budget_tokens_used"]
    else:
        assert m["budget_steps"] == 0


def test_phase_first_step_emits(models, serving_metrics_ok):
    """token_budget=0: admission prefills and samples the first token in
    the same step."""
    _, tmods = models
    eng = ServingEngine(*tmods, num_slots=1, max_seq_len=128, device="cpu",
                        token_budget=0)
    p, *_ = _requests()[1]
    eng.submit(p, max_new_tokens=4)
    assert eng.step() >= 1
    eng.run()
    assert serving_metrics_ok(eng)["requests_finished"] == 1


def test_flat_budget_needs_a_token_budget(models):
    _, tmods = models
    with pytest.raises(ValueError, match="token_budget"):
        ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                      flat_budget=True, token_budget=0)


def test_pool_accounting_midflight(models, serving_metrics_ok):
    _, tmods = models
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128,
                        device="cpu")
    for p, m, *_ in _requests()[:4]:
        eng.submit(p, max_new_tokens=m)
    for _ in range(3):
        eng.step()
        m = serving_metrics_ok(eng)
        assert m["kv_blocks_used"] > 0
        assert 0 < eng.occupancy <= 1.0
    eng.run()
    assert serving_metrics_ok(eng)["requests_finished"] == 4


def test_slo_verdicts_reconcile(models, serving_metrics_ok):
    from paddle_tpu_torch.inference.telemetry import SloPolicy
    _, tmods = models
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                        slo=SloPolicy(e2e_s=1e-9))
    _serve(eng, _requests()[:3])
    m = serving_metrics_ok(eng)
    assert m["slo_ok"] == 0
    assert m["slo_violated_queue"] + m["slo_violated_service"] == 3


@pytest.mark.parametrize("kwargs", [
    {"kv_pool_blocks": 64}, {"max_pending": 4}, {"kv_pool": object()},
    {"role": "prefill"}])
def test_out_of_slice_options_raise(models, kwargs):
    _, tmods = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                      **kwargs)


def _odd_model():
    """E = 33 (3 heads of 11) and FF = 65: every contracted axis that
    int4 packs is odd."""
    from paddle_tpu_torch.weights import random_state
    return from_jax_state(*random_state(np.random.default_rng(4), 33, 3, 65,
                                        1, 40), device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    ({"weight_quant": "int2"}, "weight_quant"),
    ({"kv_quant": "fp8"}, "kv_quant"),
    ({"kv_quant": "int4"}, "kv_quant"),
    ({"weight_quant": "int4", "odd": True}, "even"),
], ids=["int2_weights", "fp8_kv", "int4_kv", "int4_odd_axes"])
def test_quant_options_fail_at_construction(models, kwargs, match):
    """As the JAX engine does: unknown modes, an int4 KV pool and int4
    weights whose contracted axes cannot pack raise ValueError in the
    constructor."""
    kwargs = dict(kwargs)
    tmods = _odd_model() if kwargs.pop("odd", False) else models[1]
    with pytest.raises(ValueError, match=match):
        ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                      **kwargs)


def test_in_slice_spellings_are_accepted(models):
    _, tmods = models
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                        paged=True, spec_k=0, flat_budget=False,
                        role="mixed", weight_quant="none", kv_quant="none")
    assert eng.token_budget == 2 * 16 and eng._budget_cols == 16


def test_default_device_needs_a_card(models, monkeypatch):
    _, tmods = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(*tmods, num_slots=2, max_seq_len=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_state({}, {}, {})


def test_submit_validation(models):
    _, tmods = models
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu")
    with pytest.raises(ValueError, match="Smax"):
        eng.submit(np.zeros(100, np.int64), max_new_tokens=29)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.array([V]), max_new_tokens=2)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int64))


def test_port_never_imports_jax_or_paddle_tpu():
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        for bad in ("import jax", "from jax", "paddle_tpu.",
                    "import paddle_tpu\n", "from paddle_tpu "):
            assert bad not in src, f"{path}: {bad!r}"
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.weights, paddle_tpu_torch.ops._build, "
            "paddle_tpu_torch.ops.flash_attention; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PKG.parent)
