"""OmniLMM-12B generation and yes/no autocheck, and its chat, in PyTorch.

Counterpart of rlaifv_tpu/genai/omni_gen.py over the eager decode engine.
Prompts: the `<image>` marker (or a prepended one) expands to the literal
`<im_start><im_patch>*N<im_end>` span, the zephyr chat template renders
through `omni_preprocess(generation=True)`, and the image goes through
the plain bicubic resize and CLIP normalisation (no pad). The yes/no ids
are the last token of '\\n<|assistant|>\\n' + word.

- diverse_gen: repeat groups (consecutive identical question and image)
  share one prefill and one EVA02 encode through
  `DecodeEngine.generate_repeated`; `continuous=True` runs all the items
  through `generate_continuous` (`batch_size` slots); the rest run as
  plain batches;
- generate_beam: beams combined with sampling (the 12B chat mode);
- autocheck: the first position's softmax mass on the yes/no ids; facts
  about one image share the template and image prefix (it ends right
  after `<im_end>`: start + num_query + 1 tokens), prefilled once through
  `DecodeEngine.score_shared_prefix`.

A fused engine (`fused_decode=True`) has no per-layer weights for
`generate_repeated` or `score_shared_prefix`: there diverse_gen and
autocheck take the batch `generate` path, as the port's
Llava15Generator does (the JAX generator raises from the engine instead).

`OmniLMMChat` loads a checkpoint (bf16 on the card, fp32 on the CPU) and
chats with 3 beams and T 0.6 / top-k 30 / top-p 0.9 / repetition 1.1:
`int8` quantises both towers to int8 in place (LM head left float) with
an int8 KV cache, `int4` the same with int4 group quantisation,
`fused_decode` serves the int8 (or int4) model through kernel #16 (it
implies int8 unless int4 is chosen; its chat raises ValueError, since beam
search needs the per-layer weights the fused engine frees, and the JAX
fused engine keeps none to run a beam with either). `int4_smooth` smooths
the LM first (models/quant_smooth.py, alpha 0.5), calibrated with the
tokenizer passed in, or the JAX package's id ramp without one; the towers
keep plain group int4.
"""
from __future__ import annotations

from typing import List

import numpy as np

from rlaifv_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor, decode_image
from rlaifv_tpu_torch.data.preprocess import omni_preprocess
from rlaifv_tpu_torch.genai.engine import DecodeEngine, group_consecutive
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.omnilmm import find_image_start


def expand_question_multimodal(turns: List[dict], image_token_len: int) -> List[dict]:
    """Place the literal image-token span into the first turn."""
    span = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_PATCH_TOKEN * image_token_len
            + DEFAULT_IM_END_TOKEN)
    turns = [dict(t) for t in turns]
    if DEFAULT_IMAGE_TOKEN in turns[0]["content"]:
        turns[0]["content"] = turns[0]["content"].replace(DEFAULT_IMAGE_TOKEN, span)
    else:
        turns[0]["content"] = span + "\n" + turns[0]["content"]
    return turns


def wrap_question_for_omni_lmm(question, image_token_len: int, tokenizer) -> dict:
    """question (str or chat turns) -> dict(input_ids, labels)."""
    if isinstance(question, str):
        question = [{"role": "user", "content": question}]
    turns = expand_question_multimodal(question, image_token_len)
    out = omni_preprocess([turns], tokenizer, generation=True)
    return {"input_ids": out["input_ids"][0], "labels": out["labels"][0]}


def omni_yesno_ids(tokenizer) -> dict:
    return {w: tokenizer.encode(f"\n<|assistant|>\n{w}")[-1]
            for w in ("yes", "Yes", "no", "No")}


class OmniLMMGenerator:
    """Batched generation over an OmniLMM-12B model that holds its weights."""

    def __init__(self, model, tokenizer, *, image_size: int = 448,
                 checkpoint_name: str = "", fused_decode: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.num_query = model.cfg.num_query
        self.im_patch_id = tokenizer.convert_tokens_to_ids(DEFAULT_IMAGE_PATCH_TOKEN)
        # eval transform: plain bicubic resize + CLIP normalisation, no pad
        self.processor = ClipImageProcessor(image_size=image_size, aspect_ratio="square")
        self.engine = DecodeEngine(model, eos_id=tokenizer.eos_token_id,
                                   pad_id=tokenizer.pad_token_id or 0,
                                   fused_decode=fused_decode)
        self.checkpoint_name = checkpoint_name

    def _prepare(self, items: List[dict]):
        prompts, starts, images = [], [], []
        for item in items:
            ids = wrap_question_for_omni_lmm(item["question"], self.num_query,
                                             self.tokenizer)["input_ids"].tolist()
            prompts.append(ids)
            starts.append(find_image_start(ids, self.im_patch_id))
            images.append(self.processor(decode_image(
                item.get("image_bytes") or item.get("image"))))
        return prompts, np.asarray(starts, np.int32), np.stack(images)

    def _text(self, res, b: int) -> str:
        return self.tokenizer.decode(res.tokens[b][: res.lengths[b]],
                                     skip_special_tokens=True).strip()

    def generate(self, items: List[dict], *, sampling: SamplingParams,
                 max_new_tokens: int, batch_size: int = 8, seed: int = 0):
        """-> [(item, answer text, first logits (V,))] in batches."""
        rows = []
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            prompts, starts, images = self._prepare(chunk)
            res = self.engine.generate(prompts, images=images, image_starts=starts,
                                       sampling=sampling, max_new_tokens=max_new_tokens,
                                       seed=seed + i)
            rows.extend((item, self._text(res, b), res.first_logits[b])
                        for b, item in enumerate(chunk))
        return rows

    def generate_beam(self, items: List[dict], *, num_beams: int = 3,
                      sampling: SamplingParams = None, max_new_tokens: int = 512,
                      seed: int = 0):
        """Beam decode, optionally combined with sampling (the 12B chat's
        beams 3 with T 0.6 / top-k 30 / top-p 0.9 / repetition 1.1)."""
        prompts, starts, images = self._prepare(items)
        res = self.engine.generate_beam(prompts, images=images, image_starts=starts,
                                        num_beams=num_beams, sampling=sampling,
                                        max_new_tokens=max_new_tokens, seed=seed)
        return [(item, self._text(res, b)) for b, item in enumerate(items)]

    def diverse_gen(self, items, *, temperature=0.7, max_new_tokens=512, batch_size=8,
                    seed=0, continuous=False, share_repeats: bool = True) -> List[dict]:
        sp = SamplingParams(temperature=temperature, do_sample=True)
        if not continuous and share_repeats and not self.engine.fused_decode:
            rows = self._diverse_gen_shared(items, sp, max_new_tokens, batch_size, seed)
            if rows is not None:
                return rows
        if continuous:
            prompts, starts, images = self._prepare(items)
            res = self.engine.generate_continuous(
                prompts, images=images, image_starts=starts, slots=batch_size,
                sampling=sp, max_new_tokens=max_new_tokens, seed=seed)
            return [self._row(item, answer=self._text(res, b))
                    for b, item in enumerate(items)]
        return [self._row(item, answer=text) for item, text, _ in self.generate(
            items, sampling=sp, max_new_tokens=max_new_tokens, batch_size=batch_size,
            seed=seed)]

    def _score_row(self, item, logits, ids) -> dict:
        logits = np.asarray(logits, np.float64)
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        text = self.tokenizer.decode([int(logits.argmax())],
                                     skip_special_tokens=True).strip()
        return self._row(item, answer=text,
                         scores={w: float(probs[t]) for w, t in ids.items()})

    def _diverse_gen_shared(self, items, sp, max_new_tokens, batch_size, seed):
        """One prefill and one EVA02 encode a repeat group
        (engine.generate_repeated); None when no group has two items."""
        groups = group_consecutive(items, with_question=True)
        if not any(len(g) >= 2 for g in groups):
            return None
        out: List[dict] = [None] * len(items)
        singles: List[int] = []
        cap = max(batch_size, 16)
        for group in groups:
            if len(group) < 2:
                singles.extend(group)
                continue
            prompts, starts, images = self._prepare([items[group[0]]])
            for c0 in range(0, len(group), cap):
                sub = group[c0:c0 + cap]
                res = self.engine.generate_repeated(
                    prompts[0], n=len(sub), image=images[0], image_start=int(starts[0]),
                    sampling=sp, max_new_tokens=max_new_tokens, seed=seed + sub[0])
                for b, i in enumerate(sub):
                    out[i] = self._row(items[i], answer=self._text(res, b))
        if singles:
            for j, (item, text, _) in enumerate(self.generate(
                    [items[i] for i in singles], sampling=sp,
                    max_new_tokens=max_new_tokens, batch_size=batch_size, seed=seed)):
                out[singles[j]] = self._row(item, answer=text)
        return out

    def autocheck(self, items, *, batch_size=8, shared_prefix: bool = True) -> List[dict]:
        """Yes/no scores of each fact question. shared_prefix: questions
        about one image share the template and image prefix (the question
        comes after <im_end>), so its KV, the EVA02 + resampler encode
        included, is computed once an image; each item's own tokenisation
        is sliced, never re-tokenised, so the scores equal the plain
        path's."""
        ids = omni_yesno_ids(self.tokenizer)
        greedy = SamplingParams.greedy()
        if not shared_prefix or self.engine.fused_decode:
            return [self._score_row(item, logits, ids) for item, _, logits in self.generate(
                items, sampling=greedy, max_new_tokens=1, batch_size=batch_size)]

        out: List[dict] = [None] * len(items)
        for group in group_consecutive(items):
            chunk = [items[i] for i in group]
            prompts, starts, images = self._prepare(chunk)
            # the prefix ends right after <im_end>
            P = int(starts[0]) + self.num_query + 1
            prefixes = [p[:P] for p in prompts]
            same = all(s == starts[0] and pre == prefixes[0]
                       for s, pre in zip(starts, prefixes))
            if not same or len(group) < 2:
                for j, (item, _, logits) in enumerate(self.generate(
                        chunk, sampling=greedy, max_new_tokens=1, batch_size=batch_size)):
                    out[group[j]] = self._score_row(item, logits, ids)
                continue
            logits = self.engine.score_shared_prefix(
                prefixes[0], [p[P:] for p in prompts], image=images[0],
                image_start=int(starts[0]), batch_size=batch_size)
            for j, i in enumerate(group):
                out[i] = self._score_row(chunk[j], logits[j], ids)
        return out

    def _row(self, item: dict, **fields) -> dict:
        meta = item.get("metainfos", item.get("metainfo", {}))
        if (isinstance(meta, dict) and "image_path" not in meta
                and item.get("image_path")):
            # the reference folds a top-level image_path into metainfos
            meta = {**meta, "image_path": item["image_path"]}
        row = {"question_id": item.get("question_id")}
        if isinstance(meta, dict) and "ds_question_id" in meta:
            row["ds_question_id"] = meta["ds_question_id"]
        row["raw_question"] = item["question"]
        row.update(fields)
        row["metainfos"] = meta
        row["model_path"] = self.checkpoint_name
        return row


class OmniLMMChat:
    """The root chat.py's RLAIFV12B on the port: 3 beams combined with
    sampling (T 0.6 / top-k 30 / top-p 0.9 / repetition 1.1), 1024 new
    tokens at most."""

    def __init__(self, model_path: str, *, tokenizer=None, max_new_tokens: int = 1024,
                 image_size: int = 448, int8: bool = False, int4: bool = False,
                 int4_smooth: bool = False, fused_decode: bool = False, device="cuda"):
        import torch

        from rlaifv_tpu_torch.models.convert import (
            convert_omnilmm,
            fuse_llm_projections_,
            load_jax_params,
            load_state_dict_dir,
            omnilmm_config_from_hf,
            quantize_llm_int4,
            quantize_llm_int8,
            quantize_vision_int4,
            quantize_vision_int8,
            set_llm_config,
        )
        from rlaifv_tpu_torch.models.omnilmm import OmniLMMForCausalLM
        from rlaifv_tpu_torch.models.quant_smooth import smooth_quantize_for_serving

        if fused_decode and not (int8 or int4):
            int8 = True
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        dt = dict(dtype=dtype, param_dtype=dtype)
        cfg = omnilmm_config_from_hf(model_path, llm=dt, vision=dt)
        model = OmniLMMForCausalLM(cfg, device="meta").to_empty(device=device)
        load_jax_params(model, convert_omnilmm(load_state_dict_dir(model_path)))
        # the float weights load first, then quantise in place on the device
        if int4:
            # int4_smooth: AWQ-style smoothing of the LM (alpha 0.5),
            # calibrated with the tokenizer given here (the id ramp without
            # one, as the JAX package); the towers keep plain group int4
            if int4_smooth:
                smooth_quantize_for_serving(cfg.llm, model, tokenizer)
            else:
                quantize_llm_int4(model, include_lm_head=False)
            quantize_vision_int4(model)
        elif int8:
            quantize_llm_int8(model, include_lm_head=False)
            quantize_vision_int8(model)
        if int4 or int8:
            set_llm_config(model, kv_cache_dtype="int8")
        if fused_decode:
            fuse_llm_projections_(model)
        model.eval()
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.gen = OmniLMMGenerator(model, tokenizer, image_size=image_size,
                                    checkpoint_name=model_path, fused_decode=fused_decode)
        self.max_new_tokens = max_new_tokens

    def chat(self, input: dict) -> str:
        rows = self.gen.generate_beam(
            [{"question": input["question"], "image": input["image"], "question_id": 0}],
            num_beams=3, sampling=SamplingParams.chat_12b(),
            max_new_tokens=self.max_new_tokens)
        return rows[0][1]
