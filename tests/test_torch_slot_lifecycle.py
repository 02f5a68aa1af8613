"""The port's slot lifecycle against the JAX package's engine, on the CPU.

One scripted run per scheduler (the row budget, the flat budget with
speculative decoding at K=2 and the phase scheduler, greedy over the
paged pool, fp32) goes through the JAX
engine and the port's from the same bridged weights, prompts and fake
clock: a preemption to the host mid-prefill (the budget schedulers) and
its resume; a copy-on-write fork (``fork_slot``) whose twins write into
the blocks they share; a high-class request that preempts the youngest
low-class one and the resumes after it; ``max_pending`` shedding; a
queued request exported and imported back (re-queued), a running one
exported and imported into a free slot; deadlines that expire a queued,
a parked and a running request; a streaming reader across the fork and
the preemptions. After every phase the lifecycle counters, the pool's
blocks in use and each request's state must equal JAX's, and at the end
every request's tokens and ``expired`` flag; the port passes the metric
reconciliations at every phase. The rids are equal too: both engines
number forks and imports as they come.

Then JAX's own cases that need no engine run: the weighted-fair prefill
split (``_prefill_allocations``) against JAX's on the same fabricated
rows, ``_parse_qos_shares``, the default pool that never sheds, and the
ValueErrors of a dense engine and of a caller's ``kv_pool``.

The bench toy model (E=64, H=4, FF=128, L=2, V=256, fp32).
"""
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import BlockPool, ServingEngine
from paddle_tpu_torch.inference.serving import AdmissionFull
from paddle_tpu_torch.inference.telemetry import DEFAULT_QOS_SHARES
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SCHEDULERS = {"row": {}, "flat_spec": {"flat_budget": True, "spec_k": 2},
              "phase": {"token_budget": 0}}
COUNTERS = ("requests_finished", "requests_admitted", "requests_forked",
            "requests_rejected", "requests_expired", "requests_migrated_in",
            "requests_migrated_out", "requests_preempted",
            "requests_resumed", "requests_parked", "kv_blocks_shipped",
            "kv_blocks_adopted", "kv_cow_copies", "kv_blocks_used",
            "tokens_emitted", "decode_steps", "budget_steps",
            "budget_prefill_tokens", "draft_proposed", "draft_accepted",
            "queue_depth",
            "requests_admitted_high", "requests_admitted_normal",
            "requests_admitted_low", "tokens_emitted_high",
            "tokens_emitted_normal", "tokens_emitted_low")


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


class Clock:
    """Moves 0.1 ms a call, and as far as a test jumps it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t


PROMPTS = [np.random.default_rng(30 + i).integers(0, V, n)
           for i, n in enumerate((14, 30, 9, 7, 11, 5, 14, 6))]


def lifecycle(eng, clock, shed_error, check=lambda eng: None):
    """The scripted run; returns what it saw, phase by phase. Each
    operation that needs a state asks for it first, so both engines take
    the same branch only if they agree."""
    seen = []

    def phase(tag, *rids):
        check(eng)
        m = eng.metrics()
        seen.append((tag, {k: m[k] for k in COUNTERS},
                     [(eng.poll(r) or {}).get("state") for r in rids]))

    def running(rid):
        return (eng.poll(rid) or {}).get("state") == "running"

    stream, done = [], False

    def harvest():
        nonlocal done
        if not done:
            new, done, _ = eng.harvest_new_tokens(a)
            stream.extend(new)

    a = eng.submit(PROMPTS[0], 40, priority="low")
    b = eng.submit(PROMPTS[1], 30, priority="low", deadline_s=50.0)
    eng.track(a)
    eng.step()
    harvest()
    if running(b):
        eng.preempt_to_host(b)        # mid-prefill under a token budget
    phase("preempt", a, b)
    eng.step()                        # the QoS pass resumes it
    eng.step()
    c = eng.fork_slot(a, max_new_tokens=44) if running(a) else None
    phase("fork", a, b, c)
    eng.step()                        # the twins write: copy-on-write
    eng.step()
    harvest()
    phase("cow", a, b, c)
    h = eng.submit(PROMPTS[2], 8, priority="high")
    eng.step()                        # the youngest low request parks
    phase("qos", a, b, c, h)
    q = [eng.submit(PROMPTS[3 + i], 40 if i == 1 else 6,
                    deadline_s={0: 2.0, 1: 100.0}.get(i)) for i in range(4)]
    try:
        eng.submit(PROMPTS[7], 6)
        seen.append(("shed", False))
    except shed_error:
        seen.append(("shed", True))
    st = eng.export_slot(q[3])        # queued: re-queued on import
    seen.append(("queued export", st["lens"], len(st["kv"]),
                 st["pf_left"]))
    q3 = eng.import_slot(st)
    clock.t += 10.0                   # q[0] expires in the queue
    eng.step()                        # and b parks for the normal head
    phase("expire queued", a, b, c, h, *q, q3)
    eng.step()
    harvest()
    moved = next((r for r in (h, q[1], q[2], q3) if running(r)), None)
    if moved is not None:
        st = eng.export_slot(moved)
        seen.append(("export", moved, st["lens"], st["nt"], st["tok"],
                     st["active"], st["pf_left"], len(st["kv"]),
                     list(st["tokens"])))
        seen.append(("import", eng.import_slot(st)))
    if running(b):
        eng.preempt_to_host(b)
    clock.t += 60.0                   # b (deadline 50) expires parked
    eng.step()
    phase("expire b", a, b, c, h, *q)
    eng.step()
    clock.t += 100.0                  # q[1] (deadline 100) expires
    eng.step()
    phase("expire q1", *q)
    eng.run()
    harvest()
    seen.append(("stream", stream == eng.results[a]["tokens"].tolist(),
                 done))
    phase("end")
    seen.append(("results", {r: (v["tokens"].tolist(), v["expired"])
                             for r, v in eng.results.items()}))
    return seen


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_lifecycle_matches_jax(models, sched, serving_metrics_ok):
    from paddle_tpu.inference.serving import AdmissionFull as JaxFull
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    kw = dict(num_slots=3, max_seq_len=128, prefill_cap=8, max_pending=4,
              **SCHEDULERS[sched])
    jclock = Clock()
    want = lifecycle(JaxEngine(*jmods, clock=jclock, **kw), jclock,
                     JaxFull)
    tclock = Clock()
    eng = ServingEngine(*tmods, clock=tclock, device="cpu", **kw)
    got = lifecycle(eng, tclock, AdmissionFull, check=serving_metrics_ok)
    assert got == want
    # every piece of the lifecycle happened
    m = serving_metrics_ok(eng)
    tags = {s[0]: s for s in got}
    assert tags["shed"] == ("shed", True)
    assert tags["stream"] == ("stream", True, True)
    assert m["requests_preempted"] >= 2 and m["requests_resumed"] >= 1
    assert m["requests_forked"] == 1 and m["kv_cow_copies"] >= 1
    assert m["requests_expired"] == 3 and m["requests_rejected"] == 1
    assert m["requests_migrated_out"] == m["requests_migrated_in"] == 2
    assert m["kv_blocks_shipped"] == m["kv_blocks_adopted"] > 0
    assert m["requests_parked"] == 0 and m["kv_blocks_used"] == 0
    assert eng._kv_committed == 0 and eng._kv_reserved == 0
    expired = [r for r, (_, x) in tags["results"][1].items() if x]
    assert len(expired) == 3


def test_prefill_allocations_match_jax():
    """The weighted-fair split on fabricated rows of three classes: JAX's
    method and the port's on the same state, with shares, a collapsed
    demand spilling, a column cap, and one class (first come first
    served)."""
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    reqs = [types.SimpleNamespace(rid=r, priority=p)
            for r, p in ((5, "low"), (1, "high"), (3, "normal"),
                         (4, "high"), (2, "low"))]
    for shares in ("", "high=1,normal=3,low=2"):
        for pf in ([100] * 5, [2, 100, 100, 1, 100], [3, 3, 40, 9, 7]):
            for budget, cap in ((14, None), (14, 3), (40, None), (5, 4)):
                for rows in ([0, 1, 2, 3, 4], [0, 4], [2]):
                    me = types.SimpleNamespace(
                        _slot_req=reqs, _pf_left=np.array(pf, np.int64),
                        qos_shares=ServingEngine._parse_qos_shares(shares))
                    assert ServingEngine._prefill_allocations(
                        me, rows, budget, cap) == \
                        JaxEngine._prefill_allocations(me, rows, budget,
                                                       cap)


def test_parse_qos_shares_matches_jax():
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    for spec in ("", "high=8,low=3", " normal = 5 ", "low=1,high=1"):
        got = ServingEngine._parse_qos_shares(spec.replace(" ", ""))
        assert got == JaxEngine._parse_qos_shares(spec.replace(" ", ""))
    assert ServingEngine._parse_qos_shares("") == DEFAULT_QOS_SHARES
    for bad, match in (("urgent=2", "unknown class"), ("high=0", ">= 1")):
        with pytest.raises(ValueError, match=match):
            ServingEngine._parse_qos_shares(bad)
        with pytest.raises(ValueError, match=match):
            JaxEngine._parse_qos_shares(bad)


def test_pool_options_and_dense_refusals(models):
    """The default pool never sheds (no kv gate, any burst queues); an
    explicit budget gates; a caller's pool with another block size or
    with blocks in use, a budget on a dense engine, an unknown role, and
    the lifecycle calls of a dense engine raise JAX's ValueErrors;
    qos_shares takes JAX's string."""
    _, tmods = models
    kw = dict(num_slots=2, max_seq_len=64, device="cpu")
    eng = ServingEngine(*tmods, **kw)
    assert not eng._kv_gate and eng.max_pending == 0
    for i in range(40):
        eng.submit(PROMPTS[i % 8], 20)
    assert eng.queue_depth == 40 and eng.metrics()["requests_rejected"] == 0
    assert ServingEngine(*tmods, kv_pool_blocks=5, **kw)._kv_gate
    pool = BlockPool(9, 64, 128)
    gated = ServingEngine(*tmods, kv_pool=pool, **kw)
    assert gated.pool is pool and gated._kv_gate
    assert gated.metrics()["kv_blocks_total"] == 9
    assert ServingEngine(*tmods, qos_shares="high=9", **kw).qos_shares == \
        {"high": 9, "normal": 2, "low": 1}
    used = BlockPool(9, 64, 128)
    used.alloc(1)
    for bad, match in (({"kv_pool": BlockPool(8, 32, 128)}, "block_tokens"),
                       ({"kv_pool": used}, "already has allocated"),
                       ({"kv_pool_blocks": 8, "paged": False}, "DENSE"),
                       ({"role": "router"}, "role")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(*tmods, **kw, **bad)
    dense = ServingEngine(*tmods, paged=False, **kw)
    rid = dense.submit(PROMPTS[0], 4)
    for call in (lambda: dense.fork_slot(rid),
                 lambda: dense.export_slot(rid),
                 lambda: dense.import_slot({}),
                 lambda: dense.preempt_to_host(rid)):
        with pytest.raises(ValueError, match="paged"):
            call()
