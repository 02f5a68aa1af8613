"""The port's slot migration against the JAX package's engine, on the CPU.

A migration state (``export_slot``, JAX's ``paddle-slot-v1`` dict: the
request, its decode vectors and its KV blocks as host numpy) crosses the
frameworks both ways, and decoding continues token-identically: a JAX
engine's state imported by the port and the port's by JAX, mid-decode,
each equal to the run that never migrated (the JAX engine's own); the
two states of the same script equal field for field, their KV within
``TOLERANCES["logits_fp32"]``. The streamed handoff (``role="prefill"``
holding the prompt-complete slot, ``export_kv_prefix`` ->
``stage_kv_blocks`` while the prompt streams, ``export_slot(skip_blocks=)``
-> ``import_slot(staged=)``) runs from a JAX prefill engine into a port
decode engine and from a port prefill engine into a JAX decode engine:
tokens equal to the unmigrated run, and each side's counters equal to
the same side's in the other direction.

JAX's engine-level migration cases on port engines: mid-stream parity
with the source and target pools' accounting, a mid-prefill export under
a small token budget, a queued export re-queued on the target, an import
shed when the target has no slot (leaking nothing) and then taken
elsewhere, and the layout checks (another prefill_cap, a foreign fmt, a
lens past the request's budget, an int8 state into an fp pool, a dense
engine).

Sampled with kv_quant="int8" and weight_quant="int4" over an explicitly
sized pool: one script on the JAX engine and the port's (both key streams
seeded alike before each submit) preempts and resumes, exports and
imports, forks (the twins diverge: the child draws its own seed) and
sheds at the kv gate, then recovers; the tokens and counters equal
JAX's, each disturbed stream equals the undisturbed one, and an int8
state crosses the frameworks both ways.

The bench toy model (E=64, H=4, FF=128, L=2, V=256, fp32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.serving import AdmissionFull
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
BASE = dict(num_slots=2, max_seq_len=128, prefill_cap=8)
X = np.random.default_rng(50).integers(0, V, 12)    # mid-decode moves
Y = np.random.default_rng(51).integers(0, V, 40)    # prefill handoffs
COUNTERS = ("requests_finished", "requests_admitted", "requests_forked",
            "requests_rejected", "requests_migrated_in",
            "requests_migrated_out", "requests_preempted",
            "requests_resumed", "requests_parked", "kv_blocks_shipped",
            "kv_blocks_adopted", "kv_blocks_used", "kv_cow_copies",
            "tokens_emitted", "decode_steps", "budget_steps",
            "budget_prefill_tokens")


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(4), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


@pytest.fixture(scope="module")
def jax_decode(models):
    """One JAX decode-role engine for the module, and the tokens of X and
    Y that never migrated."""
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    eng = JaxEngine(*models[0], role="decode", **BASE)
    want = {}
    for name, prompt, n in (("X", X, 20), ("Y", Y, 10)):
        rid = eng.submit(prompt, max_new_tokens=n)
        eng.run()
        want[name] = eng.results[rid]["tokens"].tolist()
    return eng, want


def _tokens(eng, rid):
    return eng.results[rid]["tokens"].tolist()


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS}


def _mid_decode(eng, prompt, n, at=5):
    """Submit, step until ``at`` tokens are out, export."""
    rid = eng.submit(prompt, max_new_tokens=n)
    while eng.poll(rid)["n_tokens"] < at:
        eng.step()
    return eng.export_slot(rid)


def _same_state(a, b):
    """Two migration states of one script: equal fields, the KV of the
    written positions (below lens; a block's tail is stale) close."""
    assert set(a) == set(b)
    for k in a:
        if k == "kv":
            assert len(a[k]) == len(b[k])
            for j, (x, y) in enumerate(zip(a[k], b[k])):
                assert set(x) == set(y)
                n = a["lens"] - j * a["prefill_cap"]
                for part in x:
                    assert x[part].shape == y[part].shape
                    assert x[part].dtype == y[part].dtype
                    if x[part].dtype.kind == "f":
                        sl = np.s_[..., :n, :] if part == "kv" else \
                            np.s_[..., :n]
                        np.testing.assert_allclose(
                            x[part][sl], y[part][sl],
                            **TOLERANCES["logits_fp32"])
        elif k == "prompt":
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _handoff(src, dst, prompt, n, tag="h"):
    """The streamed handoff of one request from a prefill engine to a
    decode engine; returns the decode engine's rid."""
    rid = src.submit(prompt, max_new_tokens=n)
    dst.stage_kv_blocks(tag, [])
    cursor = 0
    while src.poll(rid)["state"] != "prefilled":
        src.step()
        blocks, n_full = src.export_kv_prefix(rid, cursor)
        if blocks:
            assert dst.stage_kv_blocks(tag, blocks) == n_full
            cursor = n_full
    assert cursor > 0
    state = src.export_slot(rid, skip_blocks=cursor)
    assert state["kv_skip"] == cursor and state["active"]
    return dst.import_slot(state, staged=tag)


def test_state_crosses_frameworks(models, jax_decode, serving_metrics_ok):
    """JAX's mid-decode state into the port and the port's into JAX, both
    finishing as the unmigrated run; the two states agree."""
    jmods, tmods = models
    jeng, want = jax_decode
    jstate = _mid_decode(jeng, X, 20)
    port = ServingEngine(*tmods, device="cpu", **BASE)
    rid = port.import_slot(jstate)
    port.run()
    assert _tokens(port, rid) == want["X"]
    m = serving_metrics_ok(port)
    assert (m["requests_migrated_in"], m["requests_admitted"]) == (1, 0)
    assert m["kv_blocks_adopted"] == len(jstate["kv"]) == \
        -(-jstate["lens"] // 8)
    assert port._prefill_tokens_computed == 0 and port.pool.used == 0
    src = ServingEngine(*tmods, device="cpu", **BASE)
    tstate = _mid_decode(src, X, 20)
    _same_state(tstate, jstate)
    assert src.pool.used == 0 and src._kv_committed == 0
    jeng.reset_metrics()
    rid = jeng.import_slot(tstate)
    jeng.run()
    assert _tokens(jeng, rid) == want["X"]
    assert _counters(jeng) == _counters(port)


def test_streamed_handoff_between_frameworks(models, jax_decode,
                                             serving_metrics_ok):
    """A JAX prefill engine hands Y to a port decode engine, a port
    prefill engine hands it to the JAX decode engine: the streamed
    prefix plus the tail, tokens equal to the unmigrated run, each
    source's and each target's counters equal across the directions."""
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    jeng, want = jax_decode
    jpre = JaxEngine(*jmods, role="prefill", **BASE)
    tdec = ServingEngine(*tmods, role="decode", device="cpu", **BASE)
    rid = _handoff(jpre, tdec, Y, 10)
    tdec.run()
    assert _tokens(tdec, rid) == want["Y"]
    tpre = ServingEngine(*tmods, role="prefill", device="cpu", **BASE)
    jeng.reset_metrics()
    rid = _handoff(tpre, jeng, Y, 10)
    jeng.run()
    assert _tokens(jeng, rid) == want["Y"]
    assert _counters(tpre) == _counters(jpre)
    assert _counters(tdec) == _counters(jeng)
    for eng in (tpre, tdec):
        m = serving_metrics_ok(eng)
        assert m["role"] in ("prefill", "decode")
    m = tpre.metrics()
    assert m["kv_blocks_shipped"] == tdec.metrics()["kv_blocks_adopted"] > 0
    assert m["requests_migrated_out"] == 1
    assert not tpre.has_work and tpre.pool.used == 0


def test_engine_migration_cases(models, jax_decode, serving_metrics_ok):
    """JAX's engine-level cases on port engines, tokens against the JAX
    engine's unmigrated runs."""
    _, tmods = models
    _, want = jax_decode

    def mk(**kw):
        return ServingEngine(*tmods, device="cpu", **dict(BASE, **kw))
    # mid-stream parity and both pools' accounting
    a, b = mk(), mk()
    state = _mid_decode(a, X, 20)
    assert a.pool.used == 0 and a._kv_reserved == a._kv_committed == 0
    assert len(state["kv"]) == -(-state["lens"] // a.prefill_cap)
    rid = b.import_slot(state)
    b.run()
    assert _tokens(b, rid) == want["X"]
    ma, mb = serving_metrics_ok(a), serving_metrics_ok(b)
    assert (ma["requests_migrated_out"], ma["requests_finished"]) == (1, 0)
    assert (mb["requests_migrated_in"], mb["requests_admitted"]) == (1, 0)
    assert b._prefill_tokens_computed == 0 and b.pool.used == 0
    # mid-prefill under a small token budget
    a, b = mk(token_budget=8), mk(token_budget=8)
    rid = a.submit(Y, max_new_tokens=10)
    a.step()
    assert a._pf_left[a._req_index[rid].slot] > 0
    state = a.export_slot(rid)
    assert state["pf_left"] > 0 and not state["tokens"]
    rid = b.import_slot(state)
    b.run()
    assert _tokens(b, rid) == want["Y"]
    serving_metrics_ok(a)
    serving_metrics_ok(b)
    # a queued export re-queues on the target and is admitted there
    a, b = mk(), mk()
    for seed in (1, 2):
        a.submit(np.random.default_rng(seed).integers(0, V, 8),
                 max_new_tokens=4)
    rid = a.submit(X, max_new_tokens=20)
    state = a.export_slot(rid)
    assert state["kv"] == [] and state["lens"] == 0
    rid = b.import_slot(state)
    assert b.queue_depth == 1
    a.run()
    b.run()
    assert _tokens(b, rid) == want["X"]
    assert serving_metrics_ok(a)["requests_migrated_out"] == 1
    mb = serving_metrics_ok(b)
    assert (mb["requests_migrated_in"], mb["requests_admitted"]) == (1, 1)
    # an import with no free slot sheds and leaks nothing
    a, b = mk(), mk(num_slots=1)
    b.submit(np.random.default_rng(2).integers(0, V, 8), max_new_tokens=60)
    b.step()
    state = _mid_decode(a, X, 20, at=1)
    used = b.pool.used
    with pytest.raises(AdmissionFull):
        b.import_slot(state)
    assert b.pool.used == used and b.metrics()["requests_rejected"] == 1
    serving_metrics_ok(b)
    c = mk()
    rid = c.import_slot(state)
    c.run()
    assert _tokens(c, rid) == want["X"]
    serving_metrics_ok(c)
    # the layout checks
    for eng, bad, match in (
            (mk(prefill_cap=16), state, "prefill_cap"),
            (mk(), {"fmt": "nonsense"}, "migration state"),
            (mk(), dict(state, lens=X.size + 21), "budget"),
            (mk(kv_quant="int8"), state, "flavor"),
            (mk(paged=False), state, "paged")):
        with pytest.raises(ValueError, match=match):
            eng.import_slot(bad)
    with pytest.raises(ValueError, match="paged"):
        mk(paged=False).export_slot(0)


SAMPLED = dict(num_slots=3, max_seq_len=128, prefill_cap=8, do_sample=True,
               top_k=20, top_p=0.9, temperature=0.8, kv_quant="int8",
               weight_quant="int4", kv_pool_blocks=12)


def sampled_script(eng, seed, shed_error):
    """The sampled script: a request undisturbed, then the same request
    (same seed) preempted, exported and re-imported; a fork; the kv
    gate. Returns what it saw and the state it exported."""
    seen = []

    def until(rid, n):
        while eng.poll(rid)["n_tokens"] < n:
            eng.step()

    seed(7)
    rid = eng.submit(X, max_new_tokens=16)
    eng.run()
    seen.append(("plain", _tokens(eng, rid)))
    seed(7)
    rid = eng.submit(X, max_new_tokens=16)
    until(rid, 4)
    eng.preempt_to_host(rid)
    eng.run()
    seen.append(("preempted", _tokens(eng, rid)))
    seed(7)
    rid = eng.submit(X, max_new_tokens=16)
    until(rid, 6)
    state = eng.export_slot(rid)
    rid = eng.import_slot(state)
    eng.run()
    seen.append(("migrated", _tokens(eng, rid)))
    seed(9)
    rid = eng.submit(Y[:12], max_new_tokens=20)
    until(rid, 2)
    child = eng.fork_slot(rid)
    eng.run()
    seen.append(("fork", _tokens(eng, rid), _tokens(eng, child)))
    rids = [eng.submit(X, max_new_tokens=16) for _ in range(3)]
    try:
        eng.submit(X, max_new_tokens=16)
        seen.append(("shed", False))
    except shed_error:
        seen.append(("shed", True))
    eng.run()
    rids.append(eng.submit(X, max_new_tokens=16))
    eng.run()
    seen.append(("gate", [_tokens(eng, r) for r in rids]))
    seen.append(("counters", _counters(eng)))
    return seen, state


def test_sampled_kv8_matches_jax(models, serving_metrics_ok):
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import AdmissionFull as JaxFull
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    jeng = JaxEngine(*jmods, **SAMPLED)
    want, jstate = sampled_script(jeng, paddle.seed, JaxFull)
    eng = ServingEngine(*tmods, device="cpu", **SAMPLED)
    got, tstate = sampled_script(eng, trng.seed, AdmissionFull)
    assert got == want
    m = serving_metrics_ok(eng)
    seen = dict((s[0], s[1:]) for s in got)
    plain = seen["plain"][0]
    assert seen["preempted"][0] == seen["migrated"][0] == plain
    parent, child = seen["fork"]
    assert parent[:2] == child[:2] and parent != child
    assert seen["shed"] == (True,)
    assert (m["requests_preempted"], m["requests_resumed"],
            m["requests_forked"], m["requests_rejected"]) == (1, 1, 1, 1)
    assert m["kv_cow_copies"] >= 1 and m["kv_blocks_used"] == 0
    # an int8 state crosses the frameworks both ways
    assert set(tstate["kv"][0]) == {"kv", "sc"}
    assert tstate["kv"][0]["kv"].dtype == np.int8
    _same_state({k: v for k, v in tstate.items() if k != "kv"},
                {k: v for k, v in jstate.items() if k != "kv"})
    rid = eng.import_slot(jstate)
    eng.run()
    assert _tokens(eng, rid) == plain
    rid = jeng.import_slot(tstate)
    jeng.run()
    assert _tokens(jeng, rid) == plain
    serving_metrics_ok(eng)
