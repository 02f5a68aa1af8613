"""Speculative decoding: model-free n-gram drafting and acceptance.

Counterpart of ``paddle_tpu/inference/spec_decode.py`` (numpy only, a
copy). The drafter is prompt lookup: the continuation of the most recent
earlier occurrence of the context's suffix n-gram (prompt plus generated
tokens) is proposed as up to K draft tokens. One verify pass scores the
row's input token and its drafts (``FusedDecoder._build_verify_core``,
or the budget cores' chain mode); acceptance runs here on the host:

- greedy: accept the longest draft prefix equal to the verify pass's
  argmax chain, then emit the first disagreeing argmax (the bonus token),
  so the tokens equal spec-off greedy decoding;
- sampled: accept draft d_j with probability p_j(d_j); on the first
  rejection resample from p_j with d_j zeroed; if every draft survives,
  the bonus token samples from the last position's p. The emitted
  marginal is p at every position.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NGramDrafter", "greedy_accept", "rejection_sample",
           "filtered_probs", "truncate_emitted", "validate_spec_k",
           "propose_claims"]


def propose_claims(drafters, rows, k, remaining, col_cap=None):
    """The schedulers' draft claims: for each slot in ``rows`` up to
    ``k`` draft tokens, capped at its remaining budget minus one (the
    bonus token always ships, which also keeps every landed draft write
    below prompt + max_new <= Smax) and, with ``col_cap``, at the
    dispatch's column capacity minus one. remaining: [B] ints. Returns
    (drafts [B, max(k, 1)] int32, dlen [B] int32)."""
    b = len(drafters)
    drafts = np.zeros((b, max(int(k), 1)), np.int32)
    dlen = np.zeros(b, np.int32)
    if not k:
        return drafts, dlen
    for s in rows:
        d = drafters[s].propose()
        m = min(int(d.size), int(remaining[s]) - 1)
        if col_cap is not None:
            m = min(m, int(col_cap) - 1)
        if m > 0:
            drafts[s, :m] = d[:m]
            dlen[s] = m
    return drafts, dlen


def truncate_emitted(kept, remaining, eos):
    """An accepted chain cut at the row's eos or after ``remaining``
    tokens. Returns (emitted, hit_eos)."""
    emitted = []
    hit_eos = False
    for t in kept:
        emitted.append(int(t))
        if eos is not None and int(t) == eos:
            hit_eos = True
            break
        if len(emitted) >= remaining:
            break
    return emitted, hit_eos


def validate_spec_k(k):
    """0 (off) or a power of two, as JAX requires (K sets the verify
    pass's K+1 positions)."""
    k = int(k)
    if k < 0 or (k and k & (k - 1)):
        raise ValueError(
            f"spec_k must be 0 (disabled) or a power of two, got {k} "
            "(K is baked into the ONE compiled verify step — the pow-2 "
            "rule keeps the executable set bounded, like prefill_cap)")
    return k


class NGramDrafter:
    """Suffix maps over one request's context. ``maps[n]`` holds, for
    every n-gram that has a continuation, the start of its most recent
    occurrence; ``propose`` tries n from ``max_ngram`` down to
    ``min_ngram`` and returns up to K tokens after the first match
    (empty when none)."""

    def __init__(self, k, max_ngram=3, min_ngram=1):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"NGramDrafter needs k >= 1, got {k}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        self._toks = []
        self._maps = {}
        # lifetime counters: reset() starts a new context, not a window
        self.propose_calls = 0
        self.propose_hits = 0
        self.reset(())

    def reset(self, prompt):
        """A fresh context (the slot's next request)."""
        self._toks = []
        self._maps = {n: {} for n in
                      range(self.min_ngram, self.max_ngram + 1)}
        self.update(prompt)

    def update(self, accepted):
        """Append accepted tokens; each n-gram ending just before a new
        token is (re)indexed at its start."""
        toks = self._toks
        for t in accepted:
            i = len(toks)
            toks.append(int(t))
            for n, m in self._maps.items():
                j = i - n
                if j >= 0:
                    m[tuple(toks[j:i])] = j

    def propose(self):
        toks = self._toks
        length = len(toks)
        self.propose_calls += 1
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if length < n:
                continue
            j = self._maps[n].get(tuple(toks[-n:]))
            if j is None:
                continue
            self.propose_hits += 1
            return np.asarray(toks[j + n: j + n + self.k], np.int32)
        return np.zeros((0,), np.int32)

    @property
    def context_len(self):
        return len(self._toks)


def greedy_accept(draft, greedy_tokens):
    """draft [m]; greedy_tokens [>= m + 1], the verify pass's argmax at
    positions 0..m. Returns (the accepted prefix plus the bonus token,
    n_accepted)."""
    draft = np.asarray(draft)
    a = 0
    while a < draft.size and int(draft[a]) == int(greedy_tokens[a]):
        a += 1
    return [int(t) for t in draft[:a]] + [int(greedy_tokens[a])], a


def filtered_probs(logits, top_k=0, top_p=1.0, temperature=1.0):
    """Temperature, top-k floor and nucleus cut, then the softmax, in
    float64: logits [P, V] -> [P, V] probabilities, the target
    distributions of ``rejection_sample``."""
    lg = np.asarray(logits, np.float64) / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = np.sort(lg, axis=-1)[:, -top_k][:, None]
        lg = np.where(lg < kth, -1e30, lg)
    if top_p and top_p < 1.0:
        srt = np.sort(lg, axis=-1)[:, ::-1]
        e = np.exp(srt - srt.max(-1, keepdims=True))
        cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
        cutoff_idx = np.sum(cum < top_p, axis=-1, keepdims=True)
        kth = np.take_along_axis(srt, cutoff_idx, axis=-1)
        lg = np.where(lg < kth, -1e30, lg)
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def rejection_sample(draft, probs, rng):
    """Rejection sampling for a point-mass drafter: draft [m], probs [m
    + 1, V], rng a np.random.RandomState. Returns (tokens_out,
    n_accepted)."""
    probs = np.asarray(probs, np.float64)
    out = []
    for j, d in enumerate(np.asarray(draft, np.int64)):
        p = probs[j]
        if rng.uniform() < p[d]:
            out.append(int(d))
            continue
        r = p.copy()
        r[d] = 0.0
        s = float(r.sum())
        if s <= 0.0:
            # p is the point mass on d: accepted up to round-off
            out.append(int(d))
        else:
            out.append(int(rng.choice(r.size, p=r / s)))
        return out, j
    m = len(out)
    p = probs[m]
    out.append(int(rng.choice(p.size, p=p / p.sum())))
    return out, m
