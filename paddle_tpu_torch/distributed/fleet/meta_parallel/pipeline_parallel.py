"""Pipeline-parallel execution. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``:
``PipelineParallel`` and ``PipelineParallelWithInterleave``.

JAX compiles the schedule into one ``shard_map`` of ``ppermute``s, for
which it stacks the stages' bodies (``_find_body`` / ``_param_sig`` /
``_substitute``); where it cannot, it runs a micro-batch loop. Here each
stage is a process holding only its layers (``PipelineLayer``), so
nothing is stacked and those helpers have no counterpart: the schedule
is Paddle's, run eagerly, and the activations and their gradients move
between neighbouring stages by point-to-point calls over the pipe group
(``communication.ops.batch_isend_irecv``).

``train_batch`` cuts the batch into ``pp_configs["accumulate_steps"]``
(M) micro-batches and runs Paddle's 1F1B order on stage s of P: min(P -
s - 1, M) warm-up forwards, then one forward and one backward in turn,
then the cool-down backwards; a send and the receive it waits on go in
one ``batch_isend_irecv`` where both are due (Megatron's pairing), in
the same order on both sides. Each micro-batch's loss is scaled by 1/M
(and by the scaler) before its backward, so the gradients accumulate to
the mean's; then the shared weights' gradients are summed over their
stages, the optimizer steps once and the gradients are cleared. The
returned loss is the mean of the micro-batches' losses, broadcast from
the last stage over the pipe group, so every rank returns it. Each
micro-batch averages its own tokens, so that mean equals the whole
batch's only where every micro-batch holds the same number of labelled
tokens, as in JAX's loop (``pipeline_parallel.py:372-390``); the tests
use fully labelled LM losses or MSE. At pp 1 the same code runs the
micro-batch loop, with no point-to-point call.

``PipelineParallelWithInterleave`` runs v chunks a stage
(``PipelineLayer``'s round-robin ``chunk_parts``) in a fill-drain order:
every micro-batch's forward through chunk 0, then chunk 1, ..., the
last stage's output of chunk c entering stage 0's chunk c + 1; then the
backwards in the reverse order. Its sends are started without waiting
(each finished before the step ends) and its receives wait.

Shapes are static for a step: the first time a batch shape and dtype is
seen, each sender announces every activation's shape and dtype to its
receiver (one 16-integer message a link and a chunk, Paddle's
``SendRecvMeta``); later steps of that batch reuse them, and a sender
whose activation departs from what it announced raises ``ValueError``
before sending.

Calls a step on stage s of P (``COLLECTIVES``; M micro-batches, v
chunks): ``batch_isend_irecv`` counts one a send or a receive, 2 (a + r)
where a = vM - M [s = P - 1] activations are sent and r = vM - M [s = 0]
received (each with its gradient the other way: at v = 1, 4M on a middle
stage, 2M at either end, none at pp 1); plus, at a new batch shape, one
announcement sent a chunk whose output goes on and one received a chunk
whose input comes in. One ``broadcast`` of the loss over the pipe group
(none at pp 1), one ``all_reduce`` a shared parameter on the stages that
share it, and what the stages' layers issue (``mp_layers``, the
GroupSharded stages), per micro-batch.
"""
from __future__ import annotations

import torch

from ...communication.group import as_group
from ...communication.ops import (P2POp, _broadcast, batch_isend_irecv,
                                  broadcast_object_list, irecv, isend)
from .parallel_layers import MetaParallelBase
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META = 16


class _Links:
    """This stage's point-to-point calls over the pipe group, and the
    shapes announced per (batch key, chunk)."""

    def __init__(self, hcg, device):
        self.group = as_group(hcg.get_pipe_parallel_group())
        self.hcg = hcg
        self.device = device
        self.sent = {}          # key -> (shape, dtype) announced
        self.received = {}      # key -> (shape, dtype) learnt
        self.pending = []

    def rank(self, stage):
        return self.hcg.get_rank_from_stage(stage)

    def _batch(self, ops, wait=True):
        tasks = batch_isend_irecv([P2POp(op, t, peer, self.group)
                                   for op, t, peer in ops])
        if wait:
            for t in tasks:
                t.wait()
        else:
            self.pending.append((tasks, [t for _, t, _ in ops]))

    def flush(self):
        for tasks, _ in self.pending:
            for t in tasks:
                t.wait()
        self.pending.clear()

    # -- the announcements (SendRecvMeta)
    def check(self, key, t):
        """Raise where ``t`` departs from the shape and dtype announced
        for ``key``."""
        want = self.sent[key]
        if (tuple(t.shape), t.dtype) != want:
            raise ValueError(
                f"pipeline: an activation of shape {tuple(t.shape)} "
                f"{t.dtype} where {want[0]} {want[1]} was announced for "
                "this batch shape; activation shapes must be static for a "
                "step")

    def announce(self, key, t, peer):
        """Send ``t``'s shape and dtype once per ``key``."""
        if key in self.sent:
            self.check(key, t)
            return
        self.sent[key] = (tuple(t.shape), t.dtype)
        if t.dim() > _META - 2:
            raise ValueError(f"pipeline: activations of {t.dim()} dims")
        m = torch.zeros(_META, dtype=torch.int64, device=self.device)
        m[0], m[1] = t.dim(), _DTYPES.index(t.dtype)
        m[2:2 + t.dim()] = torch.tensor(t.shape)
        self._batch([(isend, m, peer)])

    def learn(self, key, peer):
        """The shape and dtype announced for ``key`` (received once)."""
        if key not in self.received:
            m = torch.empty(_META, dtype=torch.int64, device=self.device)
            self._batch([(irecv, m, peer)])
            m = m.tolist()
            self.received[key] = (tuple(m[2:2 + m[0]]), _DTYPES[m[1]])
        return self.received[key]

    def empty(self, key):
        shape, dtype = self.received[key]
        return torch.empty(shape, dtype=dtype, device=self.device)


def _split(data, n):
    """``data`` (a tensor or a list / tuple of them) cut into ``n`` equal
    micro-batches along dim 0."""
    if isinstance(data, (list, tuple)):
        return list(zip(*(_split(d, n) for d in data)))
    b = data.shape[0]
    if b % n:
        raise ValueError(f"pipeline: batch {b} is not divisible by "
                         f"accumulate_steps {n}")
    return list(data.split(b // n))


def _key(data):
    items = data if isinstance(data, (list, tuple)) else [data]
    return tuple((tuple(t.shape), t.dtype) for t in items)


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        pp_cfg = (strategy.hybrid_configs.get("pp_configs", {})
                  if strategy else {})
        self.accumulate_steps = pp_cfg.get("accumulate_steps", 1)
        self.micro_batch_size = pp_cfg.get("micro_batch_size", 1)
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.num_virtual = 1
        self.total_loss = None
        self._links = None

    def _prepare_for_model(self):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters)
        broadcast_mp_parameters(self._layers, self._hcg)
        broadcast_dp_parameters(self._layers, self._hcg)

    def is_pipeline_first_stage(self):
        return self.stage_id == 0

    def is_pipeline_last_stage(self):
        return self.stage_id == self.num_stages - 1

    # ---------------------------------------------------------- helpers
    def _get_links(self):
        if self._links is None:
            p = next(self._layers.parameters(), None)
            dev = p.device if p is not None else torch.device("cpu")
            self._links = _Links(self._hcg, dev)
        return self._links

    def _run(self, x, chunk=None):
        """This stage's layers (chunk ``chunk``) on ``x``, under stage 3's
        forward context where a GroupSharded stage 3 wraps them."""
        from .sharding.group_sharded import stage3_forward
        with stage3_forward(getattr(self._layers, "_stage3_state", None)):
            if isinstance(self._layers, PipelineLayer):
                return self._layers(x, chunk=chunk)
            return self._layers(x)

    def _loss(self, out, label):
        if isinstance(self._layers, PipelineLayer):
            return self._layers.loss(out, label)
        return out

    def _mean_loss(self, losses):
        """The mean of the last stage's micro-batch losses, on every rank
        of the pipe group."""
        total = (torch.stack(losses).float().mean() if losses else
                 torch.zeros((), device=self._get_links().device))
        if self.num_stages > 1:
            links = self._get_links()
            _broadcast(total, links.rank(self.num_stages - 1), links.group)
        return total

    @staticmethod
    def _backward(x_in, out, grad):
        if grad is None:
            out.backward()
        else:
            torch.autograd.backward(out, grad)
        return None if x_in is None else x_in.grad

    # ---------------------------------------------------------- 1F1B
    def forward_backward_pipeline(self, data, scaler=None):
        """Forward and backward over the micro-batches of ``data`` (``[x,
        label]``, or ``x`` alone when the model's output is the loss);
        the gradients accumulate, nothing steps. Returns the mean loss."""
        micro = _split(data, self.accumulate_steps)
        m, p, s = len(micro), self.num_stages, self.stage_id
        first, last = s == 0, s == p - 1
        key = _key(data)
        links = self._get_links()
        prev, nxt = (links.rank(s - 1) if not first else None,
                     links.rank(s + 1) if not last else None)
        losses = []

        def mb(j):
            return micro[j] if isinstance(micro[j], tuple) else (micro[j],)

        def recv_forward():
            if first:
                return None
            links.learn(key, prev)
            buf = links.empty(key)
            links._batch([(irecv, buf, prev)])
            return buf.requires_grad_()

        def forward(j, x_in):
            out = self._run(mb(j)[0] if first else x_in)
            if not last:
                return out
            loss = self._loss(out, mb(j)[1] if len(mb(j)) > 1 else None)
            losses.append(loss.detach())
            loss = loss / m
            return scaler.scale(loss) if scaler is not None else loss

        def send_forward(out):
            if not last:
                links.announce(key, out, nxt)
                links._batch([(isend, out.detach().contiguous(), nxt)])

        def send_forward_recv_backward(out):
            if last:
                return None
            links.check(key, out)
            grad = torch.empty_like(out)
            links._batch([(isend, out.detach().contiguous(), nxt),
                          (irecv, grad, nxt)])
            return grad

        def send_backward(g):
            if not first:
                links._batch([(isend, g.contiguous(), prev)])

        def send_backward_recv_forward(g):
            if first:
                return None
            buf = links.empty(key)
            links._batch([(isend, g.contiguous(), prev),
                          (irecv, buf, prev)])
            return buf.requires_grad_()

        def recv_backward(out):
            if last:
                return None
            grad = torch.empty_like(out)
            links._batch([(irecv, grad, nxt)])
            return grad

        warm = min(p - s - 1, m)
        rest = m - warm
        held = []
        for j in range(warm):
            x_in = recv_forward()
            out = forward(j, x_in)
            send_forward(out)
            held.append((x_in, out))
        x_in = recv_forward() if rest else None
        for i in range(rest):
            out = forward(warm + i, x_in)
            grad = send_forward_recv_backward(out)
            held.append((x_in, out))
            g_in = self._backward(*held.pop(0), grad)
            if i == rest - 1:
                send_backward(g_in)
            else:
                x_in = send_backward_recv_forward(g_in)
        for _ in range(warm):
            x_old, out = held.pop(0)
            grad = recv_backward(out)
            send_backward(self._backward(x_old, out, grad))
        self.total_loss = self._mean_loss(losses)
        return self.total_loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if isinstance(self._layers, PipelineLayer):
            self._layers.allreduce_shared_weight_gradients()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward pipeline alone, through every chunk in the
        interleaved class's order: the mean over the micro-batches of the
        loss (``compute_loss``) or of the last stage's output, on every
        rank of the pipe group."""
        self._layers.eval()
        micro = _split(data, self.accumulate_steps)
        p, s = self.num_stages, self.stage_id
        v = (self._layers.chunk_count()
             if isinstance(self._layers, PipelineLayer) else 1)
        key = ("eval", _key(data))
        links = self._get_links()
        prev, nxt = links.rank((s - 1) % p), links.rank((s + 1) % p)
        results = []
        for c in range(v):
            for item in micro:
                item = item if isinstance(item, tuple) else (item,)
                if s == 0 and c == 0:
                    x = item[0]
                else:
                    ck = (key, c - (s == 0))
                    links.learn(ck, prev)
                    x = links.empty(ck)
                    links._batch([(irecv, x, prev)])
                out = self._run(x, chunk=c)
                if s == p - 1 and c == v - 1:
                    results.append(self._loss(out, item[1] if len(item) > 1
                                              else None)
                                   if compute_loss else out)
                else:
                    links.announce((key, c), out, nxt)
                    links._batch([(isend, out.contiguous(), nxt)],
                                 wait=False)
        links.flush()
        if compute_loss:
            return self._mean_loss(results)
        out = [torch.stack(results).mean(0).cpu() if results else None]
        if p > 1:
            broadcast_object_list(out, links.rank(p - 1), links.group)
        return out[0]


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved schedule: v chunks a stage (``PipelineLayer``'s
    ``num_virtual_pipeline_stages``, default 2), fill-drain over the
    chunks (the module docstring)."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        self.num_virtual = max(
            int(getattr(layers, "_num_virtual_pipeline_stages", None) or 2), 1)

    def forward_backward_pipeline(self, data, scaler=None):
        micro = _split(data, self.accumulate_steps)
        m, p, s, v = (len(micro), self.num_stages, self.stage_id,
                      self._layers.chunk_count())
        key = _key(data)
        links = self._get_links()
        prev, nxt = links.rank((s - 1) % p), links.rank((s + 1) % p)
        order = [(c, j) for c in range(v) for j in range(m)]
        losses, held = [], {}

        def is_start(c):
            return s == 0 and c == 0

        def is_end(c):
            return s == p - 1 and c == v - 1

        for c, j in order:
            item = micro[j] if isinstance(micro[j], tuple) else (micro[j],)
            if is_start(c):
                x_in = None
                out = self._run(item[0], chunk=c)
            else:
                ck = (key, c - (s == 0))
                links.learn(ck, prev)
                x_in = links.empty(ck)
                links._batch([(irecv, x_in, prev)])
                out = self._run(x_in.requires_grad_(), chunk=c)
            if is_end(c):
                loss = self._loss(out, item[1] if len(item) > 1 else None)
                losses.append(loss.detach())
                out = loss / m
                out = scaler.scale(out) if scaler is not None else out
            else:
                links.announce((key, c), out, nxt)
                links._batch([(isend, out.detach().contiguous(), nxt)],
                             wait=False)
            held[c, j] = (x_in, out)
        for c, j in reversed(order):
            x_in, out = held.pop((c, j))
            grad = None
            if not is_end(c):
                grad = torch.empty_like(out)
                links._batch([(irecv, grad, nxt)])
            g_in = self._backward(x_in, out, grad)
            if not is_start(c):
                links._batch([(isend, g_in.contiguous(), prev)], wait=False)
        links.flush()
        self.total_loss = self._mean_loss(losses)
        return self.total_loss
