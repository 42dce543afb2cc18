"""Batched KV-cache decode engine (prefill + eager decode loop) in PyTorch.

Counterpart of rlaifv_tpu/genai/engine.py::DecodeEngine on its per-layer
bf16-cache path, with the same conventions:

- prompts are LEFT-padded to a bucket of 64, so every row's last prompt
  token sits at one index and one host-int cache_index drives the decode
  loop; positions are cumsum(mask) - 1 and image starts shift by each
  row's pad offset;
- max_len = prompt bucket + max_new rounded up to 128, so decode steps
  take the prefix decode-attention kernel;
- decoding stops once every row has emitted EOS;
- shared-prefix scoring prefills the prefix once into a cache of exactly
  P columns (square, so the flash kernel serves it) and runs the suffixes
  in buckets of 32 over a copy of that cache.

Each decode step reads `done.all()` on the host: one device sync per step
in eager mode, which a CUDA-graph decode loop would remove.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from rlaifv_tpu_torch.genai.sampling import SamplingParams, sample_token


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
    """Wraps a LLaVA model (models/llava.py) for batched generation. The
    model holds its own weights and device."""

    def __init__(self, model, *, eos_id: int = 2, pad_id: int = 0,
                 vocab_size: Optional[int] = None, fused_decode: bool = False):
        if fused_decode:
            raise NotImplementedError(
                "fused_decode is not ported to rlaifv_tpu_torch yet: "
                "ROADMAP.md 'Modules to port' #6 (fused decode kernel)"
            )
        self.model = model
        self.llm = model.llm
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.vocab_size = vocab_size or model.cfg.llm.vocab_size

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _device_images(self, images):
        """uint8 pixels ship as they are and are normalised on the device
        (encode_images); float pixels are cast by the vision tower."""
        if images is None:
            return None
        return torch.from_numpy(np.asarray(images)).to(self.device)

    def _prefill(self, ids, mask, images, image_starts, max_len):
        """Prompt pass into a fresh (B, max_len) cache at cache_index 0 ->
        (last-position logits (B, V), cache, cache_mask (B, max_len))."""
        B, Lp = ids.shape
        pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        cache_mask = torch.zeros((B, max_len), dtype=torch.int32, device=self.device)
        cache_mask[:, :Lp] = mask
        embeds = self.model.build_embeds(ids, images, image_starts)
        logits, cache = self.llm(inputs_embeds=embeds, attention_mask=cache_mask,
                                 position_ids=pos, cache=self.llm.init_cache(B, max_len),
                                 cache_index=0)
        return logits[:, -1, :], cache, cache_mask

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
            step_logits, cache = self.llm(
                input_ids=tok[:, None], attention_mask=cache_mask,
                position_ids=(prompt_len + t)[:, None], cache=cache,
                cache_index=Lp + t,
            )
            last = step_logits[:, 0]
            if use_rep:
                token_seen[rows, tok] += live
        return tokens.T.cpu().numpy()

    def _finish(self, tokens: np.ndarray, first_logits) -> GenerateResult:
        lengths = np.zeros(tokens.shape[0], np.int64)
        for i, row in enumerate(tokens):
            eos = np.where(row == self.eos_id)[0]
            lengths[i] = (eos[0] + 1) if len(eos) else len(row)
            tokens[i, lengths[i]:] = self.pad_id
        return GenerateResult(tokens, lengths,
                              first_logits.float().cpu().numpy())

    # -------------------------------------------------- public API

    @torch.inference_mode()
    def generate(self, prompts, *, images=None, image_starts=None,
                 sampling: SamplingParams = SamplingParams.greedy(),
                 max_new_tokens: int = 512, seed: int = 0,
                 prompt_bucket: int = 64) -> GenerateResult:
        """prompts: token-id sequences with image sentinels pre-expanded;
        images (B, H, W, 3); image_starts relative to each prompt."""
        Lp = _round_up(max(len(p) for p in prompts), prompt_bucket)
        ids_np, mask_np = left_pad_batch(prompts, self.pad_id, Lp)
        offs = Lp - np.asarray([len(p) for p in prompts])
        starts = None
        if images is not None:
            starts = np.asarray(image_starts, np.int64) + offs
            starts = np.where(np.asarray(image_starts) < 0, -1, starts)
        max_len = _round_up(Lp + max_new_tokens, 128)
        ids = torch.from_numpy(ids_np).to(self.device)
        mask = torch.from_numpy(mask_np).to(self.device)
        first, cache, cache_mask = self._prefill(
            ids, mask, self._device_images(images), starts, max_len)
        tokens = self._decode(first, cache, cache_mask, mask.sum(dim=1), ids,
                              mask, sampling, max_new_tokens, seed)
        return self._finish(tokens, first)

    @torch.inference_mode()
    def generate_repeated(self, prompt, *, n: int, image=None,
                          image_start: int = -1,
                          sampling: SamplingParams = SamplingParams.greedy(),
                          max_new_tokens: int = 512, seed: int = 0,
                          prompt_bucket: int = 64) -> GenerateResult:
        """n sampled continuations of ONE prompt with one prefill and one
        vision encode: prefill at B=1, copy the cache to n rows, decode."""
        Lp = _round_up(len(prompt), prompt_bucket)
        ids_np, mask_np = left_pad_batch([prompt], self.pad_id, Lp)
        off = Lp - len(prompt)
        max_len = _round_up(Lp + max_new_tokens, 128)
        ids = torch.from_numpy(ids_np).to(self.device)
        mask = torch.from_numpy(mask_np).to(self.device)
        images = (self._device_images(np.asarray(image)[None])
                  if image is not None else None)
        starts = [image_start + off if image_start >= 0 else -1]
        first, cache, cache_mask = self._prefill(ids, mask, images, starts, max_len)
        # a real copy per row, not expand(): the decode writes each row's
        # new k/v in place and the decode kernel indexes rows densely
        cache = [{name: c.repeat(n, 1, 1, 1) for name, c in layer.items()}
                 for layer in cache]
        cache_mask = cache_mask.repeat(n, 1)
        prompt_len = mask.sum(dim=1).expand(n)
        tokens = self._decode(first.expand(n, -1), cache, cache_mask, prompt_len,
                              ids.expand(n, -1), mask.expand(n, -1), sampling,
                              max_new_tokens, seed)
        return self._finish(tokens, first.expand(n, -1))

    @torch.inference_mode()
    def score_shared_prefix(self, prefix_ids, suffixes, *, image=None,
                            image_start: int = -1, batch_size: int = 16,
                            suffix_bucket: int = 32) -> np.ndarray:
        """Last-position fp32 logits (N, V) for N prompts sharing one prefix:
        the prefix KV is computed once (one vision encode, one prefill) and
        only the suffixes run per row - exactly
        `generate(..., max_new_tokens=1).first_logits`."""
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
        _, pcache = self.llm(
            inputs_embeds=self.model.build_embeds(ids, images, [image_start]),
            attention_mask=torch.ones((1, P), dtype=torch.int32, device=dev),
            position_ids=torch.arange(P, device=dev)[None],
            cache=self.llm.init_cache(1, P), cache_index=0,
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
