"""The port's BERT against the JAX package's, on the CPU.

One JAX ``BertForPretraining(bert_tiny(dropout=0.0))`` (E=64, 2 layers,
2 heads, V=1024) per module; its ``state_dict()`` goes through
``weights.bert_from_jax_state`` into the port's model, and both take the
same batch, bench_bert's CPU shape (B=2, S=64, ids below 1024, 15% MLM
labels, NSP labels). Held in fp32:

- the pretraining loss with the masked-position gather on (K = 15 of
  64), off (``PADDLE_TPU_MLM_GATHER=0``) and falling back to the full
  sequence, with its one warning, when a row has more than K labels;
  the MLM and NSP logits without labels; ``BertModel``'s outputs under a
  padding mask (the composite attention) — TOLERANCES["logits_fp32"]
  and ["train_loss_fp32"];
- the step-1 gradients (["train_grads_fp32"]) and the parameters after
  3 AdamW steps under ``LinearWarmup(PolynomialDecay)`` with
  ``ClipGradByGlobalNorm(1.0)`` (["train_params_fp32"]);
- ``BertForSequenceClassification``'s logits and loss.

Then the AMP O2 step of bench_bert: both models cast by
``amp.decorate(level="O2")`` with fp32 masters, 3 steps under
``auto_cast(level="O2")``: the bf16 losses within
TOLERANCES["bert_o2_loss_bf16"].
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import TOLERANCES, amp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.profile_train import bert_batch
from paddle_tpu_torch.weights import bert_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, S, LR, STEPS = 2, 64, 1e-3, 3


def _config():
    return dict(dropout=0.0)


def _state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _batch(seed=0):
    """(ids, mlm labels, nsp labels) as numpy, every row within the
    gather's budget."""
    ids, y = bert_batch(seed, B, S, 1024, "cpu")
    return (ids.numpy(), y["masked_lm_labels"].numpy(),
            y["next_sentence_labels"].numpy())


def _jax(arrays):
    return [paddle.to_tensor(a.astype(np.int32)) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _schedule(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(LR, 10, end_lr=0.0), 2, 0.0,
                            LR)


@pytest.fixture(scope="module")
def runs():
    """The JAX run and the port's: first forward's losses and logits,
    step-1 gradients, losses and parameters after 3 steps."""
    paddle.seed(0)
    jm = jbert.BertForPretraining(jbert.bert_tiny(**_config()))
    state = _state(jm)
    tm = bert_from_jax_state(state, tbert.bert_tiny(**_config()),
                             device="cpu")
    ids, lab, nsp = _batch()
    out = {"state": state}
    jsched, tsched = _schedule(paddle.optimizer.lr), _schedule(tlr)
    jopt = paddle.optimizer.AdamW(
        jsched, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = AdamW(tsched, parameters=tm.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    for side, model, opt, sched, conv in (("jax", jm, jopt, jsched, _jax),
                                          ("port", tm, topt, tsched,
                                           _torch)):
        x, y, z = conv((ids, lab, nsp))
        losses, grads = [], None
        for i in range(STEPS):
            loss = model(x, masked_lm_labels=y, next_sentence_labels=z)
            loss.backward()
            if i == 0:
                grads = {n: (p.grad.numpy() if side == "port"
                             else np.asarray(p.grad._data))
                         for n, p in model.named_parameters()
                         if p.grad is not None}
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.numpy()) if side == "jax"
                          else loss.item())
        params = {n: (p.detach().numpy() if side == "port"
                      else np.asarray(p._data))
                  for n, p in model.named_parameters()}
        out[side] = {"losses": losses, "grads": grads, "params": params}
    return out


def test_state_names_and_shapes(runs):
    tm = bert_from_jax_state(runs["state"], tbert.bert_tiny(**_config()),
                             device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: v.shape for n, v in runs["state"].items()}
    assert list(dict(tm.named_parameters()))[0] == "mlm_bias"


def test_losses(runs):
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"],
                               **TOLERANCES["train_loss_fp32"])
    assert runs["port"]["losses"][-1] < runs["port"]["losses"][0]


def test_grads_after_step_1(runs):
    got, want = runs["port"]["grads"], runs["jax"]["grads"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n],
                                   **TOLERANCES["train_grads_fp32"],
                                   err_msg=n)


def test_params_after_step_3(runs):
    got, want = runs["port"]["params"], runs["jax"]["params"]
    for n in want:
        np.testing.assert_allclose(got[n], want[n],
                                   **TOLERANCES["train_params_fp32"],
                                   err_msg=n)


@pytest.fixture(scope="module")
def models(runs):
    """Fresh JAX and port models holding the initial state."""
    jm = jbert.BertForPretraining(jbert.bert_tiny(**_config()))
    jm.set_state_dict(runs["state"])
    tm = bert_from_jax_state(runs["state"], tbert.bert_tiny(**_config()),
                             device="cpu")
    return jm, tm


def test_logits_without_labels(models):
    jm, tm = models
    ids, _, _ = _batch()
    jmlm, jnsp = jm(*_jax([ids]))
    with torch.no_grad():
        tmlm, tnsp = tm(*_torch([ids]))
    for got, want in ((tmlm, jmlm), (tnsp, jnsp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **TOLERANCES["logits_fp32"])


@pytest.mark.parametrize("case", ["gather_off", "dense_row"])
def test_loss_without_the_gather(models, case, monkeypatch):
    """The full-sequence head: by ``PADDLE_TPU_MLM_GATHER=0``, or where a
    row has more labels than K (then with one warning, on each side)."""
    jm, tm = models
    ids, lab, nsp = _batch()
    if case == "gather_off":
        monkeypatch.setenv("PADDLE_TPU_MLM_GATHER", "0")
    else:
        lab[1, :40] = ids[1, :40]
        for cls in (jbert.BertForPretraining, tbert.BertForPretraining):
            monkeypatch.setattr(cls, "_warned_dense_mlm", False,
                                raising=False)
    with _warns(case == "dense_row"):
        want = jm(*_jax((ids,)), masked_lm_labels=_jax((lab,))[0],
                  next_sentence_labels=_jax((nsp,))[0])
    with _warns(case == "dense_row"), torch.no_grad():
        got = tm(*_torch((ids,)), masked_lm_labels=_torch((lab,))[0],
                 next_sentence_labels=_torch((nsp,))[0])
    np.testing.assert_allclose(got.item(), float(want.numpy()),
                               **TOLERANCES["train_loss_fp32"])


def _warns(expected):
    import contextlib
    return (pytest.warns(UserWarning, match="gather budget") if expected
            else contextlib.nullcontext())


def test_bert_model_with_a_padding_mask(runs):
    """``BertModel`` with token types and an attention mask (the
    composite attention), sequence and pooled outputs."""
    paddle.seed(1)
    jm = jbert.BertModel(jbert.bert_tiny(**_config()))
    tm = bert_from_jax_state(_state(jm), tbert.bert_tiny(**_config()),
                             device="cpu")
    ids, _, _ = _batch(1)
    types = (np.arange(S) >= S // 2).astype(np.int64)[None].repeat(B, 0)
    mask = np.ones((B, S), np.int64)
    mask[0, -7:] = 0
    want = jm(*_jax((ids, types, mask)))
    with torch.no_grad():
        got = tm(*_torch((ids, types, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   **TOLERANCES["logits_fp32"])


def test_sequence_classification():
    paddle.seed(2)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**_config()),
                                             num_classes=3)
    jm.eval()
    tm = bert_from_jax_state(_state(jm), tbert.bert_tiny(**_config()),
                             device="cpu")
    tm.eval()
    assert tm.classifier.weight.shape == (64, 3)
    ids, _, _ = _batch(2)
    labels = np.array([0, 2])
    np.testing.assert_allclose(
        tm(*_torch((ids,))).detach().numpy(), jm(*_jax((ids,))).numpy(),
        **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(
        tm(*_torch((ids,)), labels=_torch((labels,))[0]).item(),
        float(jm(*_jax((ids,)), labels=_jax((labels,))[0]).numpy()),
        **TOLERANCES["train_loss_fp32"])


def test_o2_bf16_losses_match_jax(runs):
    """bench_bert's step at the tiny shape: ``amp.decorate(level="O2")``
    (bf16 parameters, fp32 AdamW masters), forward under
    ``auto_cast(level="O2")``, 3 steps; the losses on both sides."""
    jm = jbert.BertForPretraining(jbert.bert_tiny(**_config()))
    jm.set_state_dict(runs["state"])
    tm = bert_from_jax_state(runs["state"], tbert.bert_tiny(**_config()),
                             device="cpu")
    jopt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    topt = AdamW(LR, parameters=tm.named_parameters())
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tm, topt = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    ids, lab, nsp = _batch()
    losses = {}
    for side, model, opt, conv, ctx in (
            ("jax", jm, jopt, _jax, paddle.amp.auto_cast),
            ("port", tm, topt, _torch, amp.auto_cast)):
        x, y, z = conv((ids, lab, nsp))
        losses[side] = []
        for _ in range(STEPS):
            with ctx(level="O2", dtype="bfloat16"):
                loss = model(x, masked_lm_labels=y, next_sentence_labels=z)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[side].append(float(np.asarray(
                loss.numpy() if side == "jax" else loss.detach().numpy())))
    assert tm.mlm_bias.dtype == torch.bfloat16
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               **TOLERANCES["bert_o2_loss_bf16"])
