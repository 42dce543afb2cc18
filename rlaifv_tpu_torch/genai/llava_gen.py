"""LLaVA-1.5 diverse generation + yes/no autocheck scoring in PyTorch.

Counterpart of rlaifv_tpu/genai/llava_gen.py over the eager decode engine:

- diverse_gen: N samples per question at T=0.7; consecutive identical
  (question, image) items share one prefill through
  `DecodeEngine.generate_repeated`, the rest run as plain batches;
- greedy_gen: deterministic decoding: greedy at num_beams=1, beam search
  (`DecodeEngine.generate_beam`) above, as the eval scripts' 3 beams;
- autocheck: 1-token greedy prefill, softmax mass on the
  {yes, Yes, no, No} token ids, with the shared-prefix fast path
  (`DecodeEngine.score_shared_prefix`) for facts about one image.

Output rows keep the JAX package's (and the reference's) field names;
`run(...)` shards a GenDataset by rank and writes them as jsonl. The three
modes take any model the engine takes: bf16 or int8/int4 weights, fused
projections, a bf16 or an int8 KV cache (the JAX package's headline serving
configuration: int8 weights, `fuse_proj`, `kv_cache_dtype="int8"`).
`fused_decode=True` serves that configuration (int8 or int4 weights)
through the fused engine (kernel #16 on every decode step): diverse_gen
then skips `share_repeats` and autocheck the shared prefix, and both take
the batch `generate` path, as in the JAX package (the fused engine has no
per-layer weights for `generate_repeated` or `score_shared_prefix`); beam
search raises there. `continuous=True` runs diverse_gen (with `share_keys`
from the repeat groups) and one-beam greedy_gen through the engine's
slot-refill `generate_continuous` (genai/continuous.py), `batch_size`
slots, on every engine kind.
"""
from __future__ import annotations

from typing import List

import numpy as np

from rlaifv_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from rlaifv_tpu_torch.data import conversation as conversation_lib
from rlaifv_tpu_torch.data.datasets import GenDataset, shard_indices
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor, decode_image
from rlaifv_tpu_torch.data.multimodal import expand_image_sentinels, tokenizer_image_token
from rlaifv_tpu_torch.genai.engine import DecodeEngine, group_consecutive
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.utils.file_io import write_jsonlines


def wrap_question_for_llava15(question: str, tokenizer,
                              mm_use_im_start_end: bool = False,
                              conv_mode: str = "llava_v1") -> List[int]:
    """Prompt build + image-token splice."""
    qs = question.replace(DEFAULT_IMAGE_TOKEN, "")
    if mm_use_im_start_end:
        qs = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
              + DEFAULT_IM_END_TOKEN + "\n" + qs)
    else:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    conv = conversation_lib.conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return tokenizer_image_token(conv.get_prompt(), tokenizer)


def yesno_token_ids(tokenizer) -> dict:
    """Token ids for {yes,Yes,no,No} following '<s> '."""
    return {word: tokenizer.encode(f"<s> {word}")[-1]
            for word in ("yes", "Yes", "no", "No")}


class Llava15Generator:
    """Batched generation over a LLaVA-1.5 model that holds its weights."""

    def __init__(self, model, tokenizer, num_patches: int,
                 image_size: int = 336, checkpoint_name: str = "",
                 fused_decode: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.num_patches = num_patches
        self.processor = ClipImageProcessor(image_size=image_size)
        self.engine = DecodeEngine(
            model, eos_id=tokenizer.eos_token_id,
            pad_id=tokenizer.pad_token_id or 0, fused_decode=fused_decode,
        )
        self.checkpoint_name = checkpoint_name

    # ------------------------------------------------------------ helpers

    def _prepare(self, items: List[dict]):
        prompts, starts, images = [], [], []
        for item in items:
            ids = wrap_question_for_llava15(item["question"], self.tokenizer)
            ex = expand_image_sentinels(ids, None, self.num_patches)
            prompts.append(ex["input_ids"].tolist())
            starts.append(int(ex["image_start"]))
            # resize-only uint8: normalisation happens on the device
            images.append(self.processor.resize_uint8(decode_image(
                item.get("image_bytes") or item.get("image")
            )))
        return prompts, np.asarray(starts), np.stack(images)

    def _meta_row(self, item: dict, **fields) -> dict:
        meta = item.get("metainfos", item.get("metainfo", {}))
        if (isinstance(meta, dict) and "image_path" not in meta
                and item.get("image_path")):
            meta = {**meta, "image_path": item["image_path"]}
        row = {"question_id": item.get("question_id")}
        if isinstance(meta, dict) and "ds_question_id" in meta:
            row["ds_question_id"] = meta["ds_question_id"]
        elif "ds_question_id" in item:
            row["ds_question_id"] = item["ds_question_id"]
        row["raw_question"] = item["question"]
        row.update(fields)
        row["metainfos"] = meta
        row["model_path"] = self.checkpoint_name
        return row

    def _answer_rows(self, items, res) -> List[dict]:
        return [
            self._meta_row(item, answer=self.tokenizer.decode(
                res.tokens[b][: res.lengths[b]], skip_special_tokens=True
            ).strip())
            for b, item in enumerate(items)
        ]

    # ------------------------------------------------------------ modes

    def diverse_gen(self, items: List[dict], *, temperature: float = 0.7,
                    max_new_tokens: int = 512, batch_size: int = 8,
                    seed: int = 0, continuous: bool = False,
                    share_repeats: bool = True) -> List[dict]:
        """Sampled answers. share_repeats: runs of identical
        (question, image) items - the repeat_time expansion - take ONE
        prefill and vision encode each through generate_repeated.
        continuous: slot-refill continuous batching over all the items
        (`batch_size` slots), share_repeats then naming the repeat groups as
        share_keys: one prefill and vision encode a group and refill wave."""
        sp = SamplingParams(temperature=temperature, do_sample=True)
        if continuous:
            prompts, starts, images = self._prepare(items)
            share_keys = None
            if share_repeats:
                share_keys = [None] * len(items)
                for g, idxs in enumerate(group_consecutive(items, with_question=True)):
                    for i in idxs:
                        share_keys[i] = g
            res = self.engine.generate_continuous(
                prompts, images=images, image_starts=starts, slots=batch_size, sampling=sp,
                max_new_tokens=max_new_tokens, seed=seed, share_keys=share_keys)
            return self._answer_rows(items, res)
        out: List[dict] = [None] * len(items)
        singles = list(range(len(items)))
        if share_repeats and not self.engine.fused_decode:
            groups = group_consecutive(items, with_question=True)
            singles = [i for g in groups if len(g) < 2 for i in g]
            cap = max(batch_size, 16)
            for group in (g for g in groups if len(g) >= 2):
                prompts, starts, images = self._prepare([items[group[0]]])
                for c0 in range(0, len(group), cap):
                    sub = group[c0:c0 + cap]
                    res = self.engine.generate_repeated(
                        prompts[0], n=len(sub), image=images[0],
                        image_start=int(starts[0]), sampling=sp,
                        max_new_tokens=max_new_tokens, seed=seed + sub[0],
                    )
                    for i, row in zip(sub, self._answer_rows(
                            [items[i] for i in sub], res)):
                        out[i] = row
        for s0 in range(0, len(singles), batch_size):
            sub = singles[s0:s0 + batch_size]
            chunk = [items[i] for i in sub]
            prompts, starts, images = self._prepare(chunk)
            res = self.engine.generate(
                prompts, images=images, image_starts=starts, sampling=sp,
                max_new_tokens=max_new_tokens, seed=seed + s0,
            )
            for i, row in zip(sub, self._answer_rows(chunk, res)):
                out[i] = row
        return out

    def greedy_gen(self, items: List[dict], *, max_new_tokens: int = 1024,
                   batch_size: int = 8, num_beams: int = 1,
                   continuous: bool = False) -> List[dict]:
        """Deterministic benchmark decoding: greedy at num_beams=1, the
        KV-cached beam search above (the eval scripts pass 3 beams). As in
        the JAX package, `continuous` (slot-refill continuous batching,
        `batch_size` slots) applies to greedy decoding only."""
        if continuous and num_beams == 1:
            prompts, starts, images = self._prepare(items)
            res = self.engine.generate_continuous(
                prompts, images=images, image_starts=starts, slots=batch_size,
                sampling=SamplingParams.greedy(), max_new_tokens=max_new_tokens)
            return self._answer_rows(items, res)
        out = []
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            prompts, starts, images = self._prepare(chunk)
            if num_beams > 1:
                res = self.engine.generate_beam(
                    prompts, images=images, image_starts=starts,
                    num_beams=num_beams, max_new_tokens=max_new_tokens,
                )
            else:
                res = self.engine.generate(
                    prompts, images=images, image_starts=starts,
                    sampling=SamplingParams.greedy(), max_new_tokens=max_new_tokens,
                )
            out.extend(self._answer_rows(chunk, res))
        return out

    def _score_rows(self, items, logits, ids) -> List[dict]:
        """First-position logits (N, V) -> rows with yes/no scores (softmax
        over the full vocab) and the 1-token greedy answer text."""
        logits = np.asarray(logits, np.float64)
        logits -= logits.max(axis=-1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=-1, keepdims=True)
        out = []
        for b, item in enumerate(items):
            text = self.tokenizer.decode(
                [int(logits[b].argmax())], skip_special_tokens=True
            ).strip()
            scores = {w: float(probs[b, t]) for w, t in ids.items()}
            out.append(self._meta_row(item, answer=text, scores=scores))
        return out

    def autocheck(self, items: List[dict], *, batch_size: int = 8,
                  shared_prefix: bool = True) -> List[dict]:
        """1-token reward scoring: p(yes/Yes/no/No) at the first position.

        shared_prefix: items about one image share everything up to the
        last image token; that prefix is prefilled once and only the
        question suffixes run per fact (engine.score_shared_prefix)."""
        ids = yesno_token_ids(self.tokenizer)
        if not shared_prefix or self.engine.fused_decode:
            out = []
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                prompts, starts, images = self._prepare(chunk)
                res = self.engine.generate(
                    prompts, images=images, image_starts=starts,
                    sampling=SamplingParams.greedy(), max_new_tokens=1,
                )
                out.extend(self._score_rows(chunk, res.first_logits, ids))
            return out

        out: List[dict] = [None] * len(items)
        for group in group_consecutive(items):
            chunk = [items[i] for i in group]
            prompts, starts, images = self._prepare(chunk)
            P = int(starts[0]) + self.num_patches
            prefixes = [p[:P] for p in prompts]
            same = all(s == starts[0] and pre == prefixes[0]
                       for s, pre in zip(starts, prefixes))
            if not same or len(group) < 2:
                # heterogeneous templates (or a lone row): plain path
                res = self.engine.generate(
                    prompts, images=images, image_starts=starts,
                    sampling=SamplingParams.greedy(), max_new_tokens=1,
                )
                rows = self._score_rows(chunk, res.first_logits, ids)
            else:
                logits = self.engine.score_shared_prefix(
                    prefixes[0], [p[P:] for p in prompts], image=images[0],
                    image_start=int(starts[0]), batch_size=batch_size,
                )
                rows = self._score_rows(chunk, logits, ids)
            for j, i in enumerate(group):
                out[i] = rows[j]
        return out


def run(generator: Llava15Generator, ds: GenDataset, answer_file: str, *,
        is_yesno: bool = False, batch_size: int = 8, temperature: float = 0.7,
        max_tokens: int = 512, rank: int = 0, world_size: int = 1) -> List[dict]:
    """Shard -> generate (or autocheck) -> write `answer_file`, or
    `{answer_file}.rank{r}` when world_size > 1 (merge with cat)."""
    local = [ds[i] for i in shard_indices(len(ds), world_size, rank)]
    if is_yesno:
        rows = generator.autocheck(local, batch_size=batch_size)
    else:
        rows = generator.diverse_gen(
            local, temperature=temperature, max_new_tokens=max_tokens,
            batch_size=batch_size, seed=rank,
        )
    path = answer_file if world_size == 1 else f"{answer_file}.rank{rank}"
    write_jsonlines(path, rows)
    return rows
