"""Prompt-lookup speculative decoding: exact greedy, fewer decode steps.

Counterpart of rlaifv_tpu/genai/lookup_decode.py. A draft of `draft_len`
tokens is looked up by matching the last `ngram` tokens (the history's
last n - 1 and the pending token) against the tokens seen so far (prompt
and generated, the latest match wins), and one (k + 1)-token window
forward verifies it: greedy output is token for token the engine's greedy
decode, and sampled output (speculative sampling over point-mass drafts,
`_spec_accept_resample`) is distributed as plain `sample_token` decoding.

The JAX function is one jitted while_loop; the port runs an eager loop
with the same state:

- the prompt prefills through the engine's own prefill (`_prefill`: square
  over the prompt columns, the flash kernel on the card), unpadded, into a
  per-layer cache of max_len = Lp + max_new + k + 2 rounded up to 64;
- each window writes its k + 1 columns at `cur` and the cache advances by
  1 + accepted; rejected columns stay stale until the next window
  overwrites them, and validity is the single watermark cur + k + 1;
- the window's 9 query rows (k = 8) at a Python-int q_offset take the
  dense attention path (ops/attention.py: flash needs Lq >= 128); every
  projection of a quantised model runs at M = k + 1 rows;
- the token history and the draft lookup live on the host: one host read
  a window (the verified tokens, greedy; the accepted count and the next
  pending token, sampled) advances `cur` and the history;
- the sampled path draws from an explicit `torch.Generator` (seed), so it
  matches the JAX function in distribution, not token for token.

Single-stream (B = 1), on the per-layer bf16 cache path: a fused engine or
an int8 cache raises ValueError (the int8 branch's window attends only over
its fresh columns).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rlaifv_tpu_torch.genai.sampling import NEG_INF, SamplingParams, filtered_logits
from rlaifv_tpu_torch.utils.device import to_device


def _spec_accept_resample(generator: Optional[torch.Generator], fl: torch.Tensor,
                          draft: torch.Tensor, eos_id: int) -> tuple:
    """Exact speculative sampling over point-mass drafts.

    fl: (..., k+1, V) filtered logits (softmax = the target distribution
    p_j after position j); draft: (..., k) proposed tokens (-1 = no
    proposal); leading dimensions are independent draws. Returns (a,
    new_pending), each (...) on fl's device:

      - draft j is accepted with probability p_j[draft[j]] (the
        Leviathan/Chen rule with a point-mass proposal);
      - a = the length of the leading accepted run (an accepted EOS ends
        it);
      - new_pending ~ p_a with the rejected proposal masked (the residual
        renormalised), or plain p_a when there was no proposal or all k
        drafts were accepted."""
    k, V = draft.shape[-1], fl.shape[-1]
    fl = fl.float()
    probs = torch.softmax(fl, dim=-1)
    pd = probs[..., :k, :].gather(-1, draft.clamp(min=0)[..., None])[..., 0] * (draft >= 0)
    u = torch.rand(draft.shape, generator=generator, device=fl.device)
    run_ok = torch.cumprod((u < pd).long(), -1)
    not_eos = torch.cumprod((draft != eos_id).long(), -1)
    pre_eos = torch.cat([torch.ones_like(not_eos[..., :1]), not_eos[..., :-1]], -1)
    a = (run_ok * pre_eos).sum(-1)
    l_sel = fl.gather(-2, a[..., None, None].expand(*a.shape, 1, V))[..., 0, :]
    d_at = torch.where(a < k, draft.gather(-1, a.clamp(max=k - 1)[..., None])[..., 0], -1)
    iota = torch.arange(V, device=fl.device)
    l_sel = torch.where((iota == d_at[..., None]) & (d_at[..., None] >= 0), NEG_INF, l_sel)
    # torch.multinomial's draw (an exponential race), no host read
    race = torch.empty_like(l_sel).exponential_(1.0, generator=generator)
    return a, torch.argmax(torch.softmax(l_sel, dim=-1) / race, dim=-1)


@dataclasses.dataclass
class LookupResult:
    tokens: list          # emitted ids (cut after EOS, EOS included: the
                          # engine's GenerateResult convention)
    n_steps: int          # window forwards run
    n_emitted: int        # tokens emitted
    tokens_per_step: float


def _find_draft(hist: np.ndarray, hlen: int, pending: int, n: int, k: int) -> np.ndarray:
    """The k tokens after the latest position p where the n-gram
    [hist[hlen-n+1 : hlen], pending] ends (p < hlen - 1), or k -1s."""
    size = hist.shape[0]
    pos = np.arange(size)
    ok = np.ones(size, bool)
    for j in range(n):  # gram position j aligns at p - (n - 1) + j
        g = pending if j == n - 1 else hist[max(hlen - n + 1 + j, 0)]
        ok &= hist[np.clip(pos - (n - 1) + j, 0, size - 1)] == g
    ok &= (pos >= n - 1) & (pos < hlen - 1)
    if not ok.any():
        return np.full(k, -1, np.int64)
    p = int(np.argmax(pos * ok))
    return hist[p + 1:p + 1 + k].copy()


@torch.inference_mode()
def lookup_generate(engine, prompt_ids, *, max_new_tokens: int = 128, draft_len: int = 8,
                    ngram: int = 2, images=None, image_starts=None, span_features=None,
                    span_starts=None, eos_id: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None, seed: int = 0) -> LookupResult:
    """Generation with prompt-lookup speculation. sampling=None (default):
    greedy, token for token `DecodeEngine.generate`'s greedy decode;
    sampling=SamplingParams(...): exact speculative sampling (see
    `_spec_accept_resample`); repetition_penalty is not supported. One
    prompt (a list of ids, image sentinels expanded); the media keywords are
    the engine's generate()'s for one row."""
    if engine.fused_decode:
        raise ValueError("lookup decode runs the per-layer path; build the engine with "
                         "fused_decode=False")
    if engine.llm.cfg.kv_cache_dtype == "int8":
        raise ValueError("lookup decode needs the bf16 KV cache: the int8 cache's windows "
                         "attend only over their fresh columns")
    if sampling is not None and not sampling.do_sample:
        sampling = None  # greedy parameters: the greedy path
    if sampling is not None and sampling.repetition_penalty != 1.0:
        raise ValueError("lookup decode does not support repetition_penalty")
    eos = engine.eos_id if eos_id is None else eos_id
    k, n = draft_len, ngram
    ids = np.asarray(prompt_ids, np.int64)[None]
    Lp = ids.shape[1]
    max_len = int(np.ceil((Lp + max_new_tokens + k + 2) / 64) * 64)
    dev = engine.device
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if sampling is not None else None)

    # prefill: the engine's own, square over the prompt columns
    ids_t = torch.from_numpy(ids).to(dev)
    mask = torch.ones((1, Lp), dtype=torch.int32, device=dev)
    starts = None if image_starts is None else np.asarray(image_starts, np.int64)
    logits, cache, _ = engine._prefill(
        ids_t, mask, engine._device_images(images), starts, max_len,
        spans=engine._spans(span_features, span_starts, [0]))
    if sampling is None:
        pending = int(torch.argmax(logits[0].float()))
    else:
        fl = filtered_logits(logits[0], sampling)
        race = torch.empty_like(fl).exponential_(1.0, generator=generator)
        pending = int(torch.argmax(torch.softmax(fl, dim=-1) / race))

    # the token history drives the lookup; sentinel ids (the -200 image
    # slot) clamp to 0, as in the JAX function
    hist = np.zeros(max_len + k + 1, np.int64)
    hist[:Lp] = np.maximum(ids[0], 0)
    cols = torch.arange(max_len, device=dev)
    cur = hlen = Lp
    done, out_n, steps = False, 0, 0
    while not done and out_n < max_new_tokens and cur + k + 1 <= max_len:
        draft = _find_draft(hist, hlen, pending, n, k)
        window = np.concatenate([[pending], np.maximum(draft, 0)])[None]
        logits, cache = engine.llm(
            input_ids=to_device(window, dev), attention_mask=(cols < cur + k + 1).int()[None],
            position_ids=torch.arange(cur, cur + k + 1, device=dev)[None], cache=cache,
            cache_index=cur)
        if sampling is None:
            nxt = torch.argmax(logits[0].float(), dim=-1).cpu().numpy()  # the window's read
            run_ok = np.cumprod(draft == nxt[:k])
            not_eos = np.cumprod(draft != eos)
            a = int((run_ok * np.concatenate([[1], not_eos[:-1]])).sum())
            new_pending = int(nxt[a])
        else:
            a_t, p_t = _spec_accept_resample(generator, filtered_logits(logits[0], sampling),
                                             to_device(draft, dev), eos)
            a, new_pending = torch.stack([a_t, p_t]).tolist()  # the window's read
        emitted = np.concatenate([[pending], draft])
        hist[hlen:hlen + k + 1] = emitted
        hit_eos = pending == eos or bool(((np.arange(k + 1) <= a) & (emitted == eos)).any())
        cur, hlen, out_n, steps = cur + 1 + a, hlen + 1 + a, out_n + 1 + a, steps + 1
        pending, done = new_pending, done or hit_eos
    # the pending token was produced but its KV never written; emit it if
    # the loop ended with room (plain greedy's last token)
    if not done and out_n < max_new_tokens:
        hist[hlen] = pending
        out_n += 1
    toks = hist[Lp:Lp + max_new_tokens + k + 1][:out_n][:max_new_tokens]
    if (toks == eos).any():
        toks = toks[:int(np.argmax(toks == eos)) + 1]
    return LookupResult(tokens=[int(t) for t in toks], n_steps=steps, n_emitted=len(toks),
                        tokens_per_step=round(len(toks) / max(steps, 1), 3))
