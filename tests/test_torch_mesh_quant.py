"""The port's mp=2 engine against the JAX package's mp=2 engine in the
flavors ``test_torch_mesh_serving.py`` leaves to this file (greedy
without a prefix cache, int4 weights under the row budget, int4 with an
int8 pool under the flat budget, the phase scheduler with a prefix
cache), and the slot lifecycle over the head-sharded pool: fork (COW),
export / import and preemption under eviction churn on a tight pool give
the single-device engine's tokens, fp and with an int8 pool.
"""
import numpy as np
import pytest
import torch

from test_torch_mesh_serving import (GAUGES, V, _kwargs, _port_fleet,  # noqa: F401
                                     _port_run, run_jax)

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

JAX_CASES = ("row-greedy", "row-int4", "flat-int4-kv8", "phase-prefix")


@pytest.fixture(scope="module")
def jax_runs():
    return run_jax(JAX_CASES)


@pytest.fixture(scope="module")
def tmods():
    from test_torch_mesh_serving import _state
    from paddle_tpu_torch.weights import from_jax_state
    return from_jax_state(*_state(), device="cpu")


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_matches_jax(tmods, jax_runs, case, serving_metrics_ok):
    """Tokens and shard gauges equal the JAX mp=2 engine's; int4's
    row-parallel partials are nibble-split dots summed across the shards
    before the scale, as JAX's are."""
    want, jgauges = jax_runs[case]
    got, eng = _port_run(tmods, 2, **_kwargs(case))
    assert got == want
    m = serving_metrics_ok(eng)
    assert {k: m[k] for k in GAUGES} == jgauges
    if "int4" in case:
        assert eng.dec._weight_quant_mode() == "int4"
        assert eng.dec._weight_shard_mesh() is not None


def _churn(eng):
    """Fork, export / import, preemption to the host and eviction pressure
    on a tight pool, the same script on every engine; all tokens."""
    rng = np.random.RandomState(5)
    out = []
    p0 = rng.randint(1, V, (24,)).astype(np.int32)
    r0 = eng.submit(p0, max_new_tokens=6)
    eng.run()
    out.append(eng.results[r0]["tokens"].tolist())
    r1 = eng.submit(p0, max_new_tokens=8)
    eng.step()
    eng.step()
    rf = eng.fork_slot(r1, max_new_tokens=6)
    eng.run()
    out += [eng.results[r]["tokens"].tolist() for r in (r1, rf)]
    r2 = eng.submit(rng.randint(1, V, (17,)).astype(np.int32),
                    max_new_tokens=6)
    eng.step()
    eng.step()
    r3 = eng.import_slot(eng.export_slot(r2))
    eng.run()
    out.append(eng.results[r3]["tokens"].tolist())
    r4 = eng.submit(rng.randint(1, V, (13,)).astype(np.int32),
                    max_new_tokens=7)
    eng.step()
    eng.step()
    eng.preempt_to_host(r4)
    eng.resume_from_host(r4)
    eng.run()
    out.append(eng.results[r4]["tokens"].tolist())
    for _ in range(4):
        rids = [eng.submit(rng.randint(1, V, (12,)).astype(np.int32),
                           max_new_tokens=5) for _ in range(2)]
        eng.run()
        out += [eng.results[r]["tokens"].tolist() for r in rids]
    return out


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp", "kv8"])
def test_fork_migration_preemption_under_churn(tmods, kv,
                                               serving_metrics_ok):
    """Every pool transfer (the COW copy, the block read and write of an
    export / import and of a preemption) acts on both shards; the tokens
    are the single-device engine's and the block accounting holds."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.parallel import init_serving_mesh
    from test_torch_mesh_serving import BASE, CPU8, _reset_port_fleet
    kw = dict(BASE, max_seq_len=64, kv_pool_blocks=18, kv_quant=kv)
    outs, engs = [], []
    for mp in (1, 2):
        _reset_port_fleet()
        if mp > 1:
            init_serving_mesh(mp, devices=CPU8)
        eng = ServingEngine(*tmods, device="cpu", **kw)
        outs.append(_churn(eng))
        engs.append(eng)
    assert outs[1] == outs[0]
    m = serving_metrics_ok(engs[1])
    assert m["kv_cow_copies"] == engs[0].metrics()["kv_cow_copies"]
    assert m["requests_forked"] == m["requests_migrated_in"] == 1
    assert m["kv_blocks_used"] + m["kv_blocks_free"] == m["kv_blocks_total"]
    assert (m["requests_preempted"], m["requests_resumed"]) == (1, 1)


def test_weight_gauges_count_the_int8_head(tmods, monkeypatch):
    """ROADMAP Queue 3 fault L: the weight gauges count the arrays the
    head step reads, so under head_quant="int8" (JAX:
    PADDLE_TPU_DECODE_INT8_HEAD=1) the int8 head and its scales, not the
    fp weight; with and without the mesh, equal to JAX's engine."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu.nn.layer.common import Embedding, Linear
    from paddle_tpu.parallel import init_serving_mesh as jax_mesh
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.parallel import init_serving_mesh
    from test_torch_mesh_serving import (BASE, CPU8, E, FF, H, L,
                                         _reset_jax_fleet, _reset_port_fleet,
                                         _state)
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    for lay, sd in zip(jmods, _state()):
        lay.set_state_dict(sd)
    monkeypatch.setenv("PADDLE_TPU_DECODE_INT8_HEAD", "1")
    keys = ("weight_shard_count", "weight_bytes_per_device",
            "weight_bytes_replicated")
    for mp in (1, 2):
        _reset_jax_fleet()
        _reset_port_fleet()
        try:
            if mp > 1:
                jax_mesh(2)
                init_serving_mesh(2, devices=CPU8)
            jm = JaxEngine(*jmods, **BASE).metrics()
        finally:
            _reset_jax_fleet()
        m = ServingEngine(*tmods, device="cpu", head_quant="int8",
                          **BASE).metrics()
        assert {k: m[k] for k in keys} == {k: jm[k] for k in keys}, mp
