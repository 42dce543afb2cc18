"""Beam search decode in PyTorch (chat parity: beams=3, T=0; the eval
scripts' 3 beams).

Counterpart of rlaifv_tpu/genai/beam.py::beam_search, as an eager loop:

- the caller prefills and hands over the cache already tiled to B*K rows
  (row b*K + k is beam k of prompt b; `DecodeEngine.generate_beam` prefills
  straight into that layout), with cache_mask and prompt_len tiled alike;
- each step (`beam_step`) decodes every beam's last token through the
  model-step callable, takes the fp32 log-softmax (warped first in
  beam+sample mode), lets a finished beam continue only with PAD at its
  frozen score, picks K of the K*V candidates of each row and reorders the
  cache rows by the chosen parents;
- a step feeds the sequences' token t - 1 at cache column Lp + t - 1 and
  rope position prompt_len + t - 1, as the greedy loop does, so one beam
  is greedy decoding token for token. The JAX function feeds it one
  column later (Lp + t, position prompt_len + t: the column Lp stays
  masked and every generated position is one too far); the port does not
  carry that over (a deliberate difference, pinned in
  tests/test_torch_beam.py);
- the step's parents, tokens and done flags come to the host in one
  transfer, its one sync. The reorder (`reorder_rows`) copies only the
  rows whose parent is another row, and of them only the live columns
  [0, Lp + t): the columns past them are zero in every row, so the cache
  holds what the JAX package's full gather gives;
- once every beam of every row is done, the model is not called again:
  the remaining steps only permute frozen beams by score (what the JAX
  scan computes there), which reaches a fixed point within two steps; the
  tail is padded out to max_new_tokens with PAD and unchanged parents;
- the sequences are backtracked on the host, and the best beam of a row is
  the first maximum of scores / lengths ** length_penalty.

Ties: `jax.lax.top_k` puts the lower index first among equal values, and
`torch.topk` promises no order among ties, so the picks go through a
stable descending sort (`top_k_stable`).

Beam+sample mode (`sampling` with do_sample, the 12B chat config): each
beam's logits are warped in HF beam_sample order (repetition penalty over
its own prefix, temperature, top-k, top-p) with the port's
genai/sampling.py, and the K successors are drawn from the flattened K*V
candidate scores by Gumbel top-k (multinomial sampling without
replacement); entries that continue a finished beam get no noise, so
finished hypotheses never drop out. The draws come from a
`torch.Generator`: JAX and torch give different bits for one seed, so the
two packages agree on the procedure, not on sampled tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from rlaifv_tpu_torch.genai.sampling import (
    apply_repetition_penalty,
    apply_top_k,
    apply_top_p,
)

NEG_INF = -1e9

# (tok (N,), cache_mask (N, max_len), positions (N,), cache, cache_index)
#   -> (logits (N, V), cache): `DecodeEngine._step`'s signature
StepFn = Callable


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, the
    lower index first among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class BeamState:
    cache: list  # per-layer dicts of (B*K, max_len, ...) tensors
    cache_mask: torch.Tensor  # (B*K, max_len) int32
    prompt_len: torch.Tensor  # (B*K,)
    scores: torch.Tensor  # (B, K) fp32 running log-probs
    last_tok: torch.Tensor  # (B, K) int64
    done: torch.Tensor  # (B, K) bool
    lengths: torch.Tensor  # (B, K) int32
    seen: Optional[torch.Tensor]  # (B, K, V) int32 with the repetition penalty
    vocab: int
    all_done: bool = False  # every beam of every row finished (host copy)


def warp(logits: torch.Tensor, seen: Optional[torch.Tensor], sampling) -> torch.Tensor:
    """Per-beam logits warping, HF beam_sample order: repetition penalty,
    temperature, top-k, top-p."""
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, sampling.repetition_penalty)
    if sampling.temperature not in (0.0, 1.0):
        logits = logits / sampling.temperature
    logits = apply_top_k(logits, sampling.top_k)
    return apply_top_p(logits, sampling.top_p)


def pick(flat: torch.Tensor, frozen_mask: torch.Tensor, K: int, do_sample: bool,
         generator: Optional[torch.Generator]):
    """(B, K*V) candidate scores -> the K kept (scores, flat indices).
    Deterministic: the top K. Sampling: Gumbel top-k over softmax(flat),
    with no noise on entries that continue a frozen beam or sit at NEG_INF."""
    if not do_sample:
        return top_k_stable(flat, K)
    u = torch.rand(flat.shape, generator=generator, device=flat.device,
                   dtype=torch.float32).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    noisy = torch.where(frozen_mask | (flat <= NEG_INF), flat, flat + gumbel)
    _, idx = top_k_stable(noisy, K)
    return torch.gather(flat, -1, idx), idx


def _wide(c: torch.Tensor) -> torch.Tensor:
    """A cache tensor (rows, columns, ...) viewed as 8-byte elements along
    its last axis where that axis allows it: the index kernels move a
    quarter of the elements of a bf16 cache."""
    if c.dim() >= 3 and c.stride(-1) == 1 and (c.shape[-1] * c.element_size()) % 8 == 0:
        return c.view(torch.int64)
    return c


def reorder_rows(cache: list, cache_mask: torch.Tensor, src: np.ndarray,
                 live: int) -> int:
    """Row i of every cache tensor (its columns [0, live)) and of cache_mask
    becomes row src[i]; rows with src[i] == i are not touched. Returns the
    number of rows copied. The moved rows' live columns are gathered into
    one temporary per tensor, then copied into place."""
    dst = np.flatnonzero(src != np.arange(len(src)))
    if not len(dst):
        return 0
    dev = cache_mask.device
    d = torch.from_numpy(dst).to(dev)
    s = torch.from_numpy(src[dst]).to(dev)
    for layer in cache:
        for c in layer.values():
            w = _wide(c)[:, :live]
            w.index_copy_(0, d, w[s])
    cache_mask[d] = cache_mask[s]
    return len(dst)


def beam_step(step_fn: StepFn, state: BeamState, t: int, *, Lp: int, eos_id: int,
              pad_id: int, sampling=None, generator: Optional[torch.Generator] = None,
              forced=None):
    """Beam step t (1 <= t < max_new_tokens), in place on `state`.

    Decodes the beams' last tokens (the sequences' token t - 1) at cache
    column Lp + t - 1 and rope position prompt_len + t - 1, as the greedy
    loop does, takes the fp32 log-softmax (B*K, V), applies the
    frozen-beam rule, picks K of the K*V candidates of every row (or takes
    `forced` = (parent, tok) host arrays (B, K), to replay a recorded run)
    and reorders the cache.
    Returns (parent, tok) as host arrays (B, K) and the step's log-probs
    (B*K, V) (None once every beam is done: the model is not called)."""
    B, K = state.scores.shape
    do_sample = sampling is not None and sampling.do_sample
    dev = state.scores.device
    logp = None
    if state.all_done:
        # every beam is frozen: the model's output would never be read
        lp = torch.full((B, K, state.vocab), NEG_INF, device=dev)
        lp[..., pad_id] = 0.0
    else:
        ci = Lp + t - 1
        state.cache_mask[:, ci] = 1
        logits, state.cache = step_fn(
            state.last_tok.reshape(B * K).clamp(min=0), state.cache_mask,
            state.prompt_len + (t - 1), state.cache, ci)
        step_logits = logits.float()
        if do_sample:
            step_logits = warp(step_logits, state.seen.reshape(B * K, -1)
                               if state.seen is not None else None, sampling)
        logp = torch.log_softmax(step_logits, dim=-1)
        V = logp.shape[-1]
        frozen = torch.full((V,), NEG_INF, device=dev)
        frozen[pad_id] = 0.0
        lp = torch.where(state.done[..., None], frozen, logp.reshape(B, K, V))
    V = lp.shape[-1]
    flat = (state.scores[..., None] + lp).reshape(B, K * V)
    if forced is not None:
        parent_h, tok_h = (np.asarray(a, np.int64) for a in forced)
        idx = torch.from_numpy(parent_h * V + tok_h).to(dev)
        new_scores = torch.gather(flat, -1, idx)
    else:
        frozen_mask = state.done[..., None].expand(B, K, V).reshape(B, K * V)
        new_scores, idx = pick(flat, frozen_mask, K, do_sample, generator)
    parent = torch.div(idx, V, rounding_mode="floor")
    tok = idx % V
    parent_done = torch.gather(state.done, 1, parent)
    new_done = parent_done | (tok == eos_id)
    state.lengths = torch.gather(state.lengths, 1, parent) + (~parent_done).to(torch.int32)
    if state.seen is not None:
        seen = torch.gather(state.seen, 1, parent[..., None].expand(B, K, V))
        seen.scatter_add_(2, tok[..., None], (~parent_done).to(torch.int32)[..., None])
        state.seen = seen
    # the step's one sync: parents, tokens and done flags to the host
    host = torch.cat([parent.reshape(-1), tok.reshape(-1),
                      new_done.reshape(-1).long()]).cpu().numpy()
    parent_h = host[:B * K].reshape(B, K)
    tok_h = host[B * K:2 * B * K].reshape(B, K)
    if not state.all_done:
        src = (np.arange(B)[:, None] * K + parent_h).reshape(-1)
        reorder_rows(state.cache, state.cache_mask, src, Lp + t)
    state.scores, state.last_tok, state.done = new_scores, tok, new_done
    state.all_done = bool(host[2 * B * K:].all())
    return parent_h, tok_h, logp


def backtrack(toks: np.ndarray, parents: np.ndarray, first: np.ndarray) -> np.ndarray:
    """(T, B, K) step tokens and parents and (B, K) first tokens -> (B, K,
    T + 1) sequences, each beam's chain walked back from the last step."""
    T, (B, K) = toks.shape[0], first.shape
    seqs = np.zeros((B, K, T + 1), np.int64)
    rows = np.arange(B)[:, None]
    beam = np.broadcast_to(np.arange(K), (B, K)).copy()
    for t in range(T - 1, -1, -1):
        seqs[:, :, t + 1] = toks[t, rows, beam]
        beam = parents[t, rows, beam]
    seqs[:, :, 0] = first[rows, beam]
    return seqs


def beam_start(prefill_logits: torch.Tensor, cache: list, cache_mask: torch.Tensor,
               prompt_len: torch.Tensor, *, num_beams: int, eos_id: int,
               sampling=None, generator: Optional[torch.Generator] = None,
               token_seen: Optional[torch.Tensor] = None):
    """The first token of every beam from the prefill logits (B, V): beam 0
    expanded into its top (or sampled) K tokens -> (BeamState, first tokens
    (B, K) on the host, the log-probs (B, V))."""
    B, V = prefill_logits.shape
    K = num_beams
    dev = prefill_logits.device
    do_sample = sampling is not None and sampling.do_sample
    use_rep = sampling is not None and sampling.repetition_penalty != 1.0
    logits0 = prefill_logits.float()
    if use_rep and token_seen is None:
        token_seen = torch.zeros((B, V), dtype=torch.int32, device=dev)
    if do_sample:
        logits0 = warp(logits0, token_seen if use_rep else None, sampling)
    logp0 = torch.log_softmax(logits0, dim=-1)
    if do_sample:
        scores, tokens0 = pick(logp0, torch.zeros((B, V), dtype=torch.bool, device=dev),
                               K, True, generator)
    else:
        scores, tokens0 = top_k_stable(logp0, K)
    seen = None
    if use_rep:
        seen = token_seen.repeat_interleave(K, dim=0).reshape(B, K, V).clone()
        seen.scatter_add_(2, tokens0[..., None], torch.ones_like(tokens0[..., None],
                                                                  dtype=torch.int32))
    state = BeamState(cache=cache, cache_mask=cache_mask, prompt_len=prompt_len,
                      scores=scores, last_tok=tokens0, done=tokens0 == eos_id,
                      lengths=torch.ones((B, K), dtype=torch.int32, device=dev),
                      seen=seen, vocab=V)
    state.all_done = bool(state.done.all())
    return state, tokens0.cpu().numpy(), logp0


def beam_search(
    step_fn: StepFn,
    prefill_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    cache: list,  # prefill cache, tiled to B*K rows (row b*K + k)
    cache_mask: torch.Tensor,  # (B*K, max_len)
    prompt_len: torch.Tensor,  # (B*K,)
    Lp: int,
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    length_penalty: float = 1.0,
    sampling=None,  # SamplingParams with do_sample => beam-sample mode
    generator: Optional[torch.Generator] = None,
    token_seen: Optional[torch.Tensor] = None,  # (B, V) prompt-token table
):
    """-> (best sequences (B, max_new_tokens) int64, best length-normalised
    scores (B,) fp32), numpy on the host."""
    if sampling is not None and sampling.do_sample and generator is None:
        generator = torch.Generator(device=prefill_logits.device).manual_seed(0)
    state, first, _ = beam_start(prefill_logits, cache, cache_mask, prompt_len,
                                 num_beams=num_beams, eos_id=eos_id, sampling=sampling,
                                 generator=generator, token_seen=token_seen)
    B, K = first.shape
    T = max_new_tokens - 1
    toks = np.full((T, B, K), pad_id, np.int64)
    parents = np.broadcast_to(np.arange(K), (T, B, K)).copy()
    for t in range(1, max_new_tokens):
        parent, tok, _ = beam_step(step_fn, state, t, Lp=Lp, eos_id=eos_id, pad_id=pad_id,
                                   sampling=sampling, generator=generator)
        toks[t - 1], parents[t - 1] = tok, parent
        # frozen beams sorted by score stay put from here on: the rest of
        # the run would repeat this step (PAD tokens, unchanged parents)
        if state.all_done and (tok == pad_id).all() and \
                (parent == np.arange(K)).all():
            break
    seqs = backtrack(toks, parents, first)
    norm = state.scores / state.lengths.float() ** length_penalty
    norm_h = norm.cpu().numpy()
    best = np.argmax(norm_h, axis=1)
    rows = np.arange(B)
    return seqs[rows, best], norm_h[rows, best]
