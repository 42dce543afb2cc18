"""Batched KV-cache decode engine (prefill + eager decode loop) in PyTorch.

Counterpart of rlaifv_tpu/genai/engine.py::DecodeEngine on its per-layer
cache path (bf16 or int8, as the model's kv_cache_dtype says), with the
same conventions. It serves a LLaVA or OmniLMM model (images spliced into
the prompt embeddings), a MiniCPM-V model (models/minicpmv.py: pre-encoded
`span_features` spliced at several `span_starts` of each row) or, as the
JAX engine's bare-LM mode, a text-only LlamaForCausalLM (models/llama.py;
`images` must be None), such as the divide-and-conquer stage's Llama3-8B.
Span features splice into the LM's own token embeddings whatever the
model, as the JAX engine's `_embed_spliced` does:

- prompts are LEFT-padded to a bucket of 64, so every row's last prompt
  token sits at one index and one host-int cache_index drives the decode
  loop; positions are cumsum(mask) - 1 and image and span starts shift by
  each row's pad offset (-1 stays -1);
- max_len = prompt bucket + max_new rounded up to 128, so decode steps
  take the prefix decode-attention kernel;
- the prompt prefill runs over views of the cache's first Lp columns, so
  its attention is square and takes the flash kernel (the JAX engine's
  prefill attends over all max_len columns, the ones past Lp masked: the
  same values);
- decoding stops once every row has emitted EOS;
- `generate_beam` prefills at B rows straight into a cache of B * K rows
  and runs genai/beam.py's eager beam loop (one sync a step, the cache
  rows reordered by the chosen parents);
- `generate_many` runs length-sorted batches through `generate` (no span
  features, as in the JAX engine);
  `generate_continuous` runs genai/continuous.py's slot-refill continuous
  batching (one sync a chunk of decode steps), on every engine kind;
- shared-prefix scoring prefills the prefix once into a cache of exactly
  P columns (square, so the flash kernel serves it) and runs the suffixes
  in buckets of 32 over a copy of that cache;
- both scoring paths (shared prefix, win||rej pairs) use a bf16 cache
  whatever the serving cache type (`_fp_cache`): the int8 branch's prefill
  attends only over its fresh window, so it cannot see a live prefix;
- win||rej pair scoring (the ref-logp precompute) prefills each pair's
  left-padded prefix once at exactly Pmax columns and runs both answer
  suffixes at q_offset = Pmax over the tiled KV: both phases take the
  flash kernel.

Each decode step reads `done.all()` on the host: one device sync per step
in eager mode, which a CUDA-graph decode loop would remove.

`fused_decode=True` (a model with int8 or int4 weights, `fuse_proj` and an
int8 KV cache; else ValueError, as the JAX engine) serves through
ops/fused_decode.py: the LLM's weights are stacked at construction (in
place, the per-layer buffers freed), `generate` prefills through
`stacked_prefill_tower` into a stacked h-major cache, and each decode step
is the token's embedding in fp32, one `fused_decode_step` (kernel #16 on the
card), `scatter_new_kv` (in place) and the head on the fp32 result cast to
the model's dtype. `generate_repeated`, `generate_beam` and the scoring
paths need the per-layer weights and raise ValueError on a fused engine
(the JAX engine's `generate_beam` has no such guard; its fused engine keeps
nothing to run a beam with either).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from rlaifv_tpu_torch.constants import IGNORE_INDEX
from rlaifv_tpu_torch.genai.sampling import SamplingParams, sample_token
from rlaifv_tpu_torch.models.llama import llama_init_cache
from rlaifv_tpu_torch.models.minicpmv import splice_multi_span
from rlaifv_tpu_torch.ops.fused_decode import (
    default_dims,
    fused_decode_step,
    init_stacked_cache,
    scatter_new_kv,
    stack_llama_params,
    stacked_prefill_tower,
)
from rlaifv_tpu_torch.utils.device import to_device


def left_pad_batch(seqs, pad_id: int, length: Optional[int] = None):
    """List of 1-D int arrays -> (ids (B, L), mask (B, L)) left-padded."""
    L = length or max(len(s) for s in seqs)
    B = len(seqs)
    ids = np.full((B, L), pad_id, np.int32)
    mask = np.zeros((B, L), np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)[-L:]
        ids[i, L - len(s):] = s
        mask[i, L - len(s):] = 1
    return ids, mask


def group_consecutive(items, *, with_question: bool = False):
    """Indices of items sharing an image (and optionally the question),
    grouped over the whole list in first-seen key order, original order
    inside each group. Logs one line when non-consecutive rows were
    regrouped."""
    groups: dict = {}
    for i, item in enumerate(items):
        img = item.get("image_bytes") or item.get("image")
        if isinstance(img, np.ndarray):
            img = img.tobytes()
        key = (item["question"] if with_question else None, img,
               item.get("image_path"))
        try:
            hash(key)
        except TypeError:  # e.g. parquet-style {"bytes": ...} image dicts
            key = repr(key)
        groups.setdefault(key, []).append(i)
    out = list(groups.values())
    n_regrouped = sum(1 for g in out for a, b in zip(g, g[1:]) if b != a + 1)
    if n_regrouped:
        logging.getLogger(__name__).info(
            "group_consecutive: regrouped %d non-consecutive shared rows "
            "(shuffled input; shared-prefix fast path preserved)",
            n_regrouped,
        )
    return out


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray  # (B, max_new) generated ids, pad after EOS
    lengths: np.ndarray  # (B,) #generated incl. EOS
    first_logits: np.ndarray  # (B, V) logits of the first generated position


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DecodeEngine:
    """Wraps a LLaVA model (models/llava.py) or a bare LlamaForCausalLM
    (models/llama.py) for batched generation. The model holds its own
    weights and device."""

    def __init__(self, model, *, eos_id: int = 2, pad_id: int = 0,
                 vocab_size: Optional[int] = None, fused_decode: bool = False):
        self.model = model
        self._multimodal = hasattr(model.cfg, "llm")  # wrapped LM vs bare LM
        self.llm = model.llm if self._multimodal else model
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.vocab_size = vocab_size or self.llm.cfg.vocab_size
        self.fused_decode = fused_decode
        self._fused_stacked = None
        if fused_decode:
            cfg = self.llm.cfg
            if not (cfg.quantize and cfg.fuse_proj and cfg.kv_cache_dtype == "int8"
                    and cfg.num_heads % cfg.num_kv_heads == 0):
                raise ValueError(
                    "fused_decode requires quantize + fuse_proj + int8 KV "
                    "cache (num_heads must be a multiple of num_kv_heads)"
                )
            # the per-layer weights move into the stacked arrays and are
            # freed: the model then serves only through this engine
            self._fused_stacked = stack_llama_params(model, cfg)

    @property
    def device(self) -> torch.device:
        return self.llm.model.tok_embed.weight.device

    def _embeds(self, ids, images, image_starts, spans=None) -> torch.Tensor:
        """Prompt embeddings: the span splice (`spans` = (features (B, S, Q,
        D) on the device, starts (B, S) host ints in padded coordinates)),
        the LLaVA splice, or a bare LM's token embeddings (image sentinels
        < 0 map to id 0 either way)."""
        if spans is not None:
            if images is not None:
                raise ValueError("pass images or span features, not both")
            return splice_multi_span(self.llm.embed(ids.clamp(min=0)), *spans)
        if self._multimodal:
            return self.model.build_embeds(ids, images, image_starts)
        if images is not None:
            raise ValueError("a bare language model takes no images")
        return self.llm.embed(ids.clamp(min=0))

    def _device_images(self, images):
        """uint8 pixels ship as they are and are normalised on the device
        (encode_images); float pixels are cast by the vision tower."""
        if images is None:
            return None
        return to_device(np.asarray(images), self.device)

    def _spans(self, span_features, span_starts, offs):
        """(features on the device, starts shifted by each row's left-pad
        offset `offs` (B,), -1 kept) or None without span features."""
        if span_features is None:
            return None
        feats = (span_features.to(self.device) if torch.is_tensor(span_features)
                 else to_device(np.asarray(span_features), self.device))
        st = np.asarray(span_starts, np.int64)
        return feats, np.where(st < 0, -1, st + np.asarray(offs, np.int64)[:, None])

    def _need_per_layer(self, name: str) -> None:
        if self.fused_decode:
            raise ValueError(f"{name} needs the per-layer path; construct the engine "
                             "with fused_decode=False")

    def _fp_cache(self, B: int, S: int) -> list:
        """A bf16 (cfg.dtype) cache of exactly (B, S), whatever the model's
        kv_cache_dtype: the scoring paths keep the prefix exact (the int8
        branch's prefill attends only over the fresh window, so it cannot
        see a live prefix; the float branch can)."""
        cfg = dataclasses.replace(self.llm.cfg, kv_cache_dtype="fp")
        return llama_init_cache(cfg, B, S, self.device)

    def _prefill(self, ids, mask, images, image_starts, max_len, beams: int = 1,
                 spans=None):
        """Prompt pass at B rows into a fresh (B * beams, max_len) cache ->
        (last-position logits (B, V), cache, cache_mask (B * beams,
        max_len)).

        The pass runs over views of the cache's first Lp columns (of rows
        b * beams), so its attention is square (Lq == Lk == Lp) and takes the
        flash kernel; with beams > 1 the prompt columns are then copied to
        the other rows of each prompt (row b * beams + k is beam k)."""
        B, Lp = ids.shape
        pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        cache = self.llm.init_cache(B * beams, max_len)
        views = [{name: c.view(B, beams, *c.shape[1:])[:, 0, :Lp]
                  for name, c in layer.items()} for layer in cache]
        embeds = self._embeds(ids, images, image_starts, spans)
        logits, _ = self.llm(inputs_embeds=embeds, attention_mask=mask,
                             position_ids=pos, cache=views, cache_index=0)
        if beams > 1:
            for layer in cache:
                for c in layer.values():
                    rows = c.view(B, beams, *c.shape[1:])
                    rows[:, 1:, :Lp] = rows[:, :1, :Lp]
        cache_mask = torch.zeros((B * beams, max_len), dtype=torch.int32,
                                 device=self.device)
        cache_mask[:, :Lp] = mask.repeat_interleave(beams, dim=0)
        return logits[:, -1, :], cache, cache_mask

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """ln_f and the head on post-stack hidden states (B, D) -> (B, V)."""
        h = x[:, None].to(self.llm.cfg.dtype)
        return self.llm.logits(self.llm.model.ln_f(h))[:, 0]

    def _fused_prefill(self, ids, mask, images, image_starts, max_len, spans=None):
        """The write-through prefill into a fresh stacked int8 cache ->
        (last-position logits (B, V), stacked cache, cache_mask)."""
        B, Lp = ids.shape
        cfg = self.llm.cfg
        pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        cache_mask = torch.zeros((B, max_len), dtype=torch.int32, device=self.device)
        cache_mask[:, :Lp] = mask
        embeds = self._embeds(ids, images, image_starts, spans)
        x, cache = stacked_prefill_tower(
            self._fused_stacked, init_stacked_cache(cfg, B, max_len, self.device),
            embeds, mask, pos, cfg)
        return self._head(x[:, -1]), cache, cache_mask

    def _step(self, tok, cache_mask, positions, cache, cache_index: int):
        """One decode step of tokens (B,) at rope positions (B,) -> ((B, V)
        logits, cache): the per-layer model, or embed (fp32) -> kernel #16
        -> the fresh k/v scattered into the stacked cache -> the head."""
        if not self.fused_decode:
            logits, cache = self.llm(input_ids=tok[:, None], attention_mask=cache_mask,
                                     position_ids=positions[:, None], cache=cache,
                                     cache_index=cache_index)
            return logits[:, 0], cache
        cfg = self.llm.cfg
        x = self.llm.embed(tok[:, None])[:, 0].float()
        x_out, new_kv = fused_decode_step(
            self._fused_stacked, cache, x, cache_mask, positions, cache_index,
            default_dims(cfg, cache_mask.shape[1]), rope_theta=cfg.rope_theta)
        return self._head(x_out), scatter_new_kv(cache, new_kv, cache_index)

    def _decode(self, first_logits, cache, cache_mask, prompt_len, ids, mask,
                sp: SamplingParams, max_new: int, seed: int):
        """Sample max_new tokens (or until every row emitted EOS) ->
        (B, max_new) int64 tokens on the host."""
        B, Lp = ids.shape[0], mask.shape[1]
        dev = self.device
        generator = torch.Generator(device=dev).manual_seed(seed)
        use_rep = sp.repetition_penalty != 1.0
        token_seen = None
        if use_rep:
            token_seen = torch.zeros((B, self.vocab_size), dtype=torch.int32, device=dev)
            token_seen.scatter_add_(1, ids.clamp(min=0).long(), mask)
        rows = torch.arange(B, device=dev)
        tokens = torch.full((max_new, B), self.pad_id, dtype=torch.int64, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        last = first_logits
        for t in range(max_new):
            tok = sample_token(generator, last, sp, token_seen)
            tok = torch.where(done, self.pad_id, tok)
            tokens[t] = tok
            live = (~done).to(torch.int32)
            done = done | (tok == self.eos_id)
            # the logits of a step past the last are never read
            if t == max_new - 1 or bool(done.all()):
                break
            cache_mask[:, Lp + t] = live
            last, cache = self._step(tok, cache_mask, prompt_len + t, cache, Lp + t)
            if use_rep:
                token_seen[rows, tok] += live
        return tokens.T.cpu().numpy()

    def _trim(self, tokens: np.ndarray) -> np.ndarray:
        """Lengths (through the first EOS) of each row; the tokens after it
        become PAD, in place."""
        lengths = np.zeros(tokens.shape[0], np.int64)
        for i, row in enumerate(tokens):
            eos = np.where(row == self.eos_id)[0]
            lengths[i] = (eos[0] + 1) if len(eos) else len(row)
            tokens[i, lengths[i]:] = self.pad_id
        return lengths

    def _finish(self, tokens: np.ndarray, first_logits) -> GenerateResult:
        return GenerateResult(tokens, self._trim(tokens),
                              first_logits.float().cpu().numpy())

    def _batch(self, prompts, images, image_starts, prompt_bucket: int, max_new: int,
               span_features=None, span_starts=None):
        """Left-pad the prompts to their bucket -> (ids, mask (B, Lp) on the
        device, image starts shifted by each row's padding or None, the
        spans (`_spans`) or None, max_len = Lp + max_new rounded up to
        128)."""
        Lp = _round_up(max(len(p) for p in prompts), prompt_bucket)
        ids_np, mask_np = left_pad_batch(prompts, self.pad_id, Lp)
        offs = Lp - np.asarray([len(p) for p in prompts])
        starts = None
        if images is not None:
            starts = np.asarray(image_starts, np.int64) + offs
            starts = np.where(np.asarray(image_starts) < 0, -1, starts)
        return (torch.from_numpy(ids_np).to(self.device),
                torch.from_numpy(mask_np).to(self.device), starts,
                self._spans(span_features, span_starts, offs),
                _round_up(Lp + max_new, 128))

    # -------------------------------------------------- public API

    @torch.inference_mode()
    def generate(self, prompts, *, images=None, image_starts=None, span_features=None,
                 span_starts=None, sampling: SamplingParams = SamplingParams.greedy(),
                 max_new_tokens: int = 512, seed: int = 0,
                 prompt_bucket: int = 64) -> GenerateResult:
        """prompts: token-id sequences with image sentinels pre-expanded;
        images (B, H, W, 3); image_starts relative to each prompt;
        span_features (B, S, Q, D) pre-encoded features (numpy or a tensor)
        and span_starts (B, S) relative to each prompt, -1 inactive."""
        ids, mask, starts, spans, max_len = self._batch(
            prompts, images, image_starts, prompt_bucket, max_new_tokens, span_features,
            span_starts)
        prefill = self._fused_prefill if self.fused_decode else self._prefill
        first, cache, cache_mask = prefill(
            ids, mask, self._device_images(images), starts, max_len, spans=spans)
        tokens = self._decode(first, cache, cache_mask, mask.sum(dim=1), ids,
                              mask, sampling, max_new_tokens, seed)
        return self._finish(tokens, first)

    @torch.inference_mode()
    def generate_repeated(self, prompt, *, n: int, image=None,
                          image_start: int = -1, span_features=None, span_starts=None,
                          sampling: SamplingParams = SamplingParams.greedy(),
                          max_new_tokens: int = 512, seed: int = 0,
                          prompt_bucket: int = 64) -> GenerateResult:
        """n sampled continuations of ONE prompt with one prefill and one
        vision encode: prefill at B=1, copy the cache to n rows, decode.
        span_features (S, Q, D) and span_starts (S,) are one prompt's
        group."""
        self._need_per_layer("generate_repeated")
        Lp = _round_up(len(prompt), prompt_bucket)
        ids_np, mask_np = left_pad_batch([prompt], self.pad_id, Lp)
        off = Lp - len(prompt)
        max_len = _round_up(Lp + max_new_tokens, 128)
        ids = torch.from_numpy(ids_np).to(self.device)
        mask = torch.from_numpy(mask_np).to(self.device)
        images = (self._device_images(np.asarray(image)[None])
                  if image is not None else None)
        starts = [image_start + off if image_start >= 0 else -1]
        spans = None
        if span_features is not None:
            feats = (span_features[None] if torch.is_tensor(span_features)
                     else np.asarray(span_features)[None])
            spans = self._spans(feats, np.asarray(span_starts)[None], [off])
        # n real rows, not expand(): the decode writes each row's new k/v
        # in place and the decode kernels index rows densely (an int8
        # cache's scales are 3-D)
        first, cache, cache_mask = self._prefill(ids, mask, images, starts, max_len,
                                                 beams=n, spans=spans)
        prompt_len = mask.sum(dim=1).expand(n)
        tokens = self._decode(first.expand(n, -1), cache, cache_mask, prompt_len,
                              ids.expand(n, -1), mask.expand(n, -1), sampling,
                              max_new_tokens, seed)
        return self._finish(tokens, first.expand(n, -1))

    @torch.inference_mode()
    def generate_many(self, prompts, *, images=None, image_starts=None,
                      batch_size: int = 8,
                      sampling: SamplingParams = SamplingParams.greedy(),
                      max_new_tokens: int = 512, seed: int = 0,
                      prompt_bucket: int = 64) -> GenerateResult:
        """Queue-mode generation: the prompts sorted by length, so each
        batch shares a tight padding bucket and its rows tend to finish
        together, then `generate` batch by batch (seed + the batch's start);
        rows come back in the caller's order."""
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        tokens = [None] * len(prompts)
        lengths = np.zeros(len(prompts), np.int64)
        first_logits = [None] * len(prompts)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            res = self.generate(
                [prompts[i] for i in idx],
                images=np.asarray(images)[idx] if images is not None else None,
                image_starts=([image_starts[i] for i in idx]
                              if image_starts is not None else None),
                sampling=sampling, max_new_tokens=max_new_tokens, seed=seed + start,
                prompt_bucket=prompt_bucket)
            for row, i in enumerate(idx):
                tokens[i] = res.tokens[row]
                lengths[i] = res.lengths[row]
                first_logits[i] = res.first_logits[row]
        out = np.full((len(prompts), max(t.shape[0] for t in tokens)), self.pad_id,
                      tokens[0].dtype)
        for i, t in enumerate(tokens):
            out[i, :t.shape[0]] = t
        return GenerateResult(out, lengths, np.stack(first_logits))

    @torch.inference_mode()
    def generate_continuous(self, prompts, *, images=None, image_starts=None,
                            span_features=None, span_starts=None, slots: int = 8,
                            sampling: SamplingParams = SamplingParams.greedy(),
                            max_new_tokens: int = 512, seed: int = 0, chunk: int = 32,
                            prompt_bucket: int = 64, collect_first_logits: bool = False,
                            max_new_per_prompt=None, share_keys=None) -> GenerateResult:
        """Slot-refill continuous batching (genai/continuous.py): a finished
        row's slot takes the next prompt of the queue at once instead of
        waiting for its batch's slowest row. Greedy tokens equal generate's.
        share_keys (one hashable per prompt, equal key == identical prompt
        and image) lets the refills of repeat-expanded prompts share one
        prefill and vision encode per distinct key."""
        from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator

        gen = ContinuousGenerator(self, slots=slots, chunk=chunk,
                                  max_new_tokens=max_new_tokens, sampling=sampling,
                                  prompt_bucket=prompt_bucket)
        return gen.run(
            prompts, images=np.asarray(images) if images is not None else None,
            image_starts=image_starts, span_features=span_features,
            span_starts=span_starts, seed=seed, collect_first_logits=collect_first_logits,
            max_new_per_prompt=max_new_per_prompt, share_keys=share_keys)

    @torch.inference_mode()
    def generate_beam(self, prompts, *, images=None, image_starts=None,
                      span_features=None, span_starts=None,
                      num_beams: int = 3, max_new_tokens: int = 512,
                      length_penalty: float = 1.0, prompt_bucket: int = 64,
                      sampling: Optional[SamplingParams] = None,
                      seed: int = 0) -> GenerateResult:
        """Beam decode (genai/beam.py). Deterministic by default (7B chat
        and eval parity); `sampling=SamplingParams.chat_12b()` gives the
        combined beam+sample mode. The prompts prefill once at B rows,
        straight into a cache of B * num_beams rows; the result's third
        field holds each row's best length-normalised score, as in the JAX
        engine."""
        from rlaifv_tpu_torch.genai.beam import beam_search

        self._need_per_layer("generate_beam")
        B, K = len(prompts), num_beams
        ids, mask, starts, spans, max_len = self._batch(
            prompts, images, image_starts, prompt_bucket, max_new_tokens, span_features,
            span_starts)
        Lp = ids.shape[1]
        first, cache, cache_mask = self._prefill(
            ids, mask, self._device_images(images), starts, max_len, beams=K, spans=spans)
        token_seen = None
        if sampling is not None and sampling.repetition_penalty != 1.0:
            # prompt tokens count toward the penalty (HF: the sequence so far)
            token_seen = torch.zeros((B, first.shape[-1]), dtype=torch.int32,
                                     device=self.device)
            token_seen.scatter_reduce_(1, ids.clamp(min=0).long(), mask, reduce="amax")
        generator = None
        if sampling is not None and sampling.do_sample:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        seqs, scores = beam_search(
            self._step, first, cache, cache_mask,
            mask.sum(dim=1).repeat_interleave(K), Lp, num_beams=K,
            max_new_tokens=max_new_tokens, eos_id=self.eos_id, pad_id=self.pad_id,
            length_penalty=length_penalty, sampling=sampling, generator=generator,
            token_seen=token_seen)
        return GenerateResult(seqs, self._trim(seqs), scores)

    @staticmethod
    def longest_common_prefix_len(seqs) -> int:
        """Length of the longest common prefix of token-id sequences, capped
        at min_len - 1 so every row keeps at least one suffix token. Any
        split at or below it is exact: each row's full tokenisation is
        sliced, never re-tokenised, so prefix + suffix == the full ids."""
        first = seqs[0]
        P = min(len(s) for s in seqs) - 1
        for s in seqs[1:]:
            i = 0
            while i < P and s[i] == first[i]:
                i += 1
            P = i
            if P == 0:
                break
        return max(P, 0)

    @torch.inference_mode()
    def score_shared_prefix(self, prefix_ids, suffixes, *, image=None,
                            image_start: int = -1, span_features=None, span_starts=None,
                            batch_size: int = 16, suffix_bucket: int = 32) -> np.ndarray:
        """Last-position fp32 logits (N, V) for N prompts sharing one prefix:
        the prefix KV is computed once (one vision encode, one prefill) and
        only the suffixes run per row - exactly
        `generate(..., max_new_tokens=1).first_logits`. span_features
        (S, Q, D) and span_starts (S,) are the prefix's span group, every
        span inside the prefix."""
        self._need_per_layer("score_shared_prefix")
        if any(len(s) < 1 for s in suffixes):
            raise ValueError("score_shared_prefix: every suffix must carry "
                             "at least one token past the shared prefix")
        dev = self.device
        P = len(prefix_ids)

        # prefix: a cache of exactly P columns at cache_index 0 makes the
        # attention square (Lq == Lk == P), which takes the flash kernel
        ids = torch.as_tensor([prefix_ids], dtype=torch.int64, device=dev)
        images = (self._device_images(np.asarray(image)[None])
                  if image is not None else None)
        spans = None
        if span_features is not None:
            feats = (span_features[None] if torch.is_tensor(span_features)
                     else np.asarray(span_features)[None])
            spans = self._spans(feats, np.asarray(span_starts)[None], [0])
        _, pcache = self.llm(
            inputs_embeds=self._embeds(ids, images, [image_start], spans),
            attention_mask=torch.ones((1, P), dtype=torch.int32, device=dev),
            position_ids=torch.arange(P, device=dev)[None],
            cache=self._fp_cache(1, P), cache_index=0,
        )

        N = len(suffixes)
        W = _round_up(max(len(s) for s in suffixes), suffix_bucket)
        B = batch_size
        # one (B, P+W) cache for every chunk: the prefix columns are copied
        # once, and each chunk's suffix pass rewrites all of [P, P+W)
        cache = [{name: torch.cat([c.expand(B, -1, -1, -1),
                                   c.new_zeros((B, W) + c.shape[2:])], dim=1)
                  for name, c in layer.items()} for layer in pcache]
        del pcache

        out = np.zeros((N, self.vocab_size), np.float32)
        for c0 in range(0, N, B):
            chunk = suffixes[c0:c0 + B]
            sids = np.zeros((B, W), np.int64)
            smask = np.zeros((B, W), np.int32)
            for r, s in enumerate(chunk):
                sids[r, :len(s)] = s
                smask[r, :len(s)] = 1
            for r in range(len(chunk), B):  # pad rows: repeat row 0
                sids[r], smask[r] = sids[0], smask[0]
            sids_t = torch.from_numpy(sids).to(dev)
            smask_t = torch.from_numpy(smask).to(dev)
            cmask = torch.ones((B, P + W), dtype=torch.int32, device=dev)
            cmask[:, P:] = smask_t
            pos = (P + torch.cumsum(smask_t, dim=1) - 1).clamp(min=0)
            logits, _ = self.llm(
                input_ids=sids_t.clamp(min=0), attention_mask=cmask,
                position_ids=pos, cache=cache, cache_index=P,
            )
            last = (smask_t.sum(dim=1) - 1).clamp(min=0)
            rows = logits[torch.arange(B, device=dev), last].float().cpu().numpy()
            out[c0:c0 + len(chunk)] = rows[:len(chunk)]
        return out

    def _pair_scores(self, pids, pmask, images, starts, sids, smask, slabels):
        """Two-phase scorer of one chunk: B left-padded prefixes (B, Pmax)
        prefill once into a cache of exactly Pmax columns at cache_index 0
        (square: the flash kernel); their KV is tiled to the 2B win||rej rows
        with W empty columns, and the suffixes (2B, W) run at cache_index
        Pmax (q_offset + Lq == Lk: the flash kernel again) -> (sums (2B,),
        means (2B,), per_token (2B, W)) in fp32."""
        B, Pmax = pids.shape
        W = sids.shape[1]
        ppos = (torch.cumsum(pmask, dim=1) - 1).clamp(min=0)
        embeds = self._embeds(pids, images, starts)
        _, pcache = self.llm(inputs_embeds=embeds, attention_mask=pmask,
                             position_ids=ppos, cache=self._fp_cache(B, Pmax),
                             cache_index=0)
        # win rows 0..B-1 and rej rows B..2B-1 share prefix i
        cache = [{name: torch.cat([torch.cat([c, c]),
                                   c.new_zeros((2 * B, W) + c.shape[2:])], dim=1)
                  for name, c in layer.items()} for layer in pcache]
        del pcache
        pmask2 = torch.cat([pmask, pmask])
        cmask = torch.cat([pmask2, smask], dim=1)
        spos = (pmask2.sum(dim=1, keepdim=True) + torch.cumsum(smask, dim=1) - 1).clamp(min=0)
        logits, _ = self.llm(input_ids=sids.clamp(min=0), attention_mask=cmask,
                             position_ids=spos, cache=cache, cache_index=Pmax)
        # the label's logit minus the fp32 logsumexp: log_softmax at the
        # label without a normalised (2B, W, V) tensor
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        tok = torch.gather(logits32, -1, slabels.clamp(min=0)[..., None])[..., 0] - lse
        m = ((slabels != IGNORE_INDEX) & (smask == 1)).float()
        per_token = tok * m
        sums = per_token.sum(dim=1)
        return sums, sums / m.sum(dim=1).clamp(min=1.0), per_token

    @torch.inference_mode()
    def score_pair_logps(self, prefixes, suffixes, suffix_labels, *, images=None,
                         image_starts=None, pair_batch: int = 8,
                         prefix_bucket: int = 128, suffix_bucket: int = 64):
        """Shared-prefix win||rej scoring, the ref-logp precompute's fast
        path: each pair's prompt prefix (system, image tokens, question)
        prefills once and only the two answer suffixes run again. Exact,
        because causal attention gives every row of a pair the same prefix
        KV.

        prefixes: B token lists; suffixes and suffix_labels: 2B lists (win
        rows 0..B-1, rej rows B..2B-1), entry j of a label list the label of
        the token predicted at suffix position j (-100 masked); images
        (B, H, W, 3) or None; image_starts (B,) in unpadded prefix
        coordinates (-1 none). Returns (sums (2B,), means (2B,), per_token:
        2B fp32 arrays cut to each suffix's length)."""
        self._need_per_layer("score_pair_logps")
        B_total = len(prefixes)
        if not len(suffixes) == 2 * B_total == len(suffix_labels):
            raise ValueError("score_pair_logps: need 2B suffixes and label lists")
        if any(len(s) < 1 for s in suffixes):
            raise ValueError("score_pair_logps: empty suffix")
        dev = self.device
        sums = np.zeros(2 * B_total, np.float32)
        means = np.zeros(2 * B_total, np.float32)
        per_token = [None] * (2 * B_total)
        for c0 in range(0, B_total, pair_batch):
            pc = prefixes[c0:c0 + pair_batch]
            n = len(pc)
            B = pair_batch if B_total > pair_batch else n
            rows = list(range(c0, c0 + n))
            sfx = [suffixes[i] for i in rows] + [suffixes[B_total + i] for i in rows]
            lab = [suffix_labels[i] for i in rows] + \
                  [suffix_labels[B_total + i] for i in rows]
            Pmax = _round_up(max(len(p) for p in pc), prefix_bucket)
            W = _round_up(max(len(s) for s in sfx), suffix_bucket)

            pids = np.zeros((B, Pmax), np.int64)
            pmask = np.zeros((B, Pmax), np.int32)
            starts = np.full((B,), -1, np.int64)
            for r, p in enumerate(pc):
                off = Pmax - len(p)
                pids[r, off:] = p
                pmask[r, off:] = 1
                if image_starts is not None and image_starts[c0 + r] >= 0:
                    starts[r] = image_starts[c0 + r] + off
            imgs = None
            if images is not None:
                sel = np.asarray(images[c0:c0 + n])
                if n < B:  # pad pairs: repeat pair 0
                    sel = np.concatenate([sel, np.repeat(sel[:1], B - n, axis=0)])
                imgs = self._device_images(sel)
            if n < B:
                pids[n:], pmask[n:], starts[n:] = pids[0], pmask[0], starts[0]

            sids = np.zeros((2 * B, W), np.int64)
            smask = np.zeros((2 * B, W), np.int32)
            slab = np.full((2 * B, W), IGNORE_INDEX, np.int64)
            for r in range(n):
                for half, src_row in ((0, r), (B, n + r)):
                    s, lb = sfx[src_row], lab[src_row]
                    sids[half + r, :len(s)] = s
                    smask[half + r, :len(s)] = 1
                    slab[half + r, :len(lb)] = lb
            for r in range(n, B):  # pad rows mirror row 0
                sids[r], smask[r], slab[r] = sids[0], smask[0], slab[0]
                sids[B + r], smask[B + r], slab[B + r] = sids[B], smask[B], slab[B]

            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            s_d, m_d, pt_d = self._pair_scores(
                t(pids), t(pmask), imgs, starts if images is not None else None,
                t(sids), t(smask), t(slab))
            s_h, m_h, pt_h = (a.cpu().numpy() for a in (s_d, m_d, pt_d))
            for r in range(n):
                for dst, src in ((c0 + r, r), (B_total + c0 + r, B + r)):
                    sums[dst] = s_h[src]
                    means[dst] = m_h[src]
                    per_token[dst] = pt_h[src][:len(suffixes[dst])]
        return sums, means, per_token
