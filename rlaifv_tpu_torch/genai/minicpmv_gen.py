"""MiniCPM-Llama3-V 2.5 generation and yes/no autocheck, and its chat, in
PyTorch.

Counterpart of rlaifv_tpu/genai/minicpmv_gen.py over the eager decode
engine. Prompts: the image is sliced (data/minicpmv_slicing.py: the source
resized to the 448 budget plus a grid of refined slices), its placeholder
(`<image><unk>*96</image>` and one `<slice><unk>*96</slice>` a cell) leads
the question, the tokenizer's chat template renders the turn, and the
`<unk>` runs of exactly query_num are the spans (`find_unk_spans`). The
slices are normalised on the host in fp32 (OPENAI_CLIP_MEAN / STD, no
resize: the plan sized them) and encoded on the model's device once for
each (H, W) bucket (`encode_slices`: SigLIP, then the resampler at that
slice's grid); the features stay on the device as (B, S, Q, D) span groups
with (B, S) starts, -1 inactive. The yes/no ids are the last token of
bos + word.

- diverse_gen: repeat groups (consecutive identical question and image)
  share one slice encode and one prefill through
  `DecodeEngine.generate_repeated`; `continuous=True` runs all the items
  through `generate_continuous` (`batch_size` slots, the "spans" refill
  mode); the rest run as plain batches; T 0.7, repetition 1.05;
- autocheck: the first position's softmax mass on the yes/no ids; facts
  about one image share their longest common token prefix (each row's
  own tokenisation sliced, never re-tokenised), prefilled once with one
  slice encode through `DecodeEngine.score_shared_prefix`, unless the
  last span ends past that prefix (then plain batches);
- chat: T 0.7, top-p 0.8, repetition 1.05 through `generate`.

A fused engine (`fused_decode=True`) has no per-layer weights for
`generate_repeated` or `score_shared_prefix`: there diverse_gen and
autocheck take the batch `generate` path, as the port's Llava15Generator
and OmniLMMGenerator do (the JAX generator calls them and its engine
raises).

`MiniCPMVChat` loads a checkpoint (bf16 on the card, fp32 on the CPU):
`int8` quantises the LLM's projections to int8 in place (the head and the
SigLIP tower float) with an int8 KV cache, `int4` the same with int4 group
quantisation, `fused_decode` serves the int8 (or int4) model through
kernel #16 (it implies int8 unless int4 is chosen). `int4_smooth` smooths
the LLM first (models/quant_smooth.py, alpha 0.5), calibrated with the
tokenizer passed in, or the JAX package's id ramp without one.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from rlaifv_tpu_torch.constants import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from rlaifv_tpu_torch.data.image_processing import decode_image
from rlaifv_tpu_torch.data.minicpmv_slicing import get_image_placeholder, slice_image
from rlaifv_tpu_torch.genai.engine import DecodeEngine, group_consecutive
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.minicpmv import find_unk_spans
from rlaifv_tpu_torch.utils.device import to_device


class MiniCPMVGenerator:
    """Batched generation over a MiniCPM-V model that holds its weights."""

    def __init__(self, model, tokenizer, *, checkpoint_name: str = "",
                 fused_decode: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.unk_id = tokenizer.convert_tokens_to_ids("<unk>")
        self._mean = np.asarray(OPENAI_CLIP_MEAN, np.float32)
        self._std = np.asarray(OPENAI_CLIP_STD, np.float32)
        self.engine = DecodeEngine(model, eos_id=tokenizer.eos_token_id,
                                   pad_id=tokenizer.pad_token_id or 0,
                                   fused_decode=fused_decode)
        self.checkpoint_name = checkpoint_name

    # ---------------------------------------------------------- prompts

    def _build_prompt(self, item: dict):
        """-> (ids, span starts, slice images (PIL))."""
        image = decode_image(item.get("image_bytes") or item.get("image"))
        if self.cfg.slice_mode:
            source, patches, grid = slice_image(image, self.cfg.max_slice_nums,
                                                self.cfg.scale_resolution, self.cfg.patch_size)
            slices = [source] + patches
            placeholder = get_image_placeholder(grid, self.cfg.query_num)
        else:
            slices = [image]
            placeholder = get_image_placeholder(None, self.cfg.query_num)
        msgs = [{"role": "user", "content": placeholder + "\n" + item["question"]}]
        ids = self.tokenizer.apply_chat_template(msgs, tokenize=True,
                                                 add_generation_prompt=True)
        return ids, find_unk_spans(ids, self.unk_id, self.cfg.query_num), slices

    def _normalize(self, arr: np.ndarray) -> np.ndarray:
        """ToTensor + Normalize only: the plan already sized the slices."""
        return ((arr.astype(np.float32) / 255.0) - self._mean) / self._std

    @torch.inference_mode()
    def _prepare(self, items: List[dict]):
        """-> (prompts, span features (B, S, Q, D) on the model's device,
        span starts (B, S) host ints, -1 inactive)."""
        prompts, all_starts, slice_arrays, slice_counts = [], [], [], []
        for item in items:
            ids, starts, slices = self._build_prompt(item)
            prompts.append(ids)
            all_starts.append(starts)
            slice_counts.append(len(slices))
            slice_arrays.extend(np.asarray(s, np.uint8) for s in slices)

        # one encode for each (H, W) bucket of slices
        dev = self.model.device
        groups: dict = {}
        for i, arr in enumerate(slice_arrays):
            groups.setdefault(arr.shape[:2], []).append(i)
        order, encoded = [], []
        for idxs in groups.values():
            batch = np.stack([self._normalize(slice_arrays[i]) for i in idxs])
            encoded.append(self.model.encode_slices(to_device(batch, dev)))
            order.extend(idxs)
        feats = torch.cat(encoded)  # (total slices, Q, D), bucket order
        row_of = np.empty(len(order), np.int64)
        row_of[np.asarray(order)] = np.arange(len(order))

        B, S = len(items), max(len(s) for s in all_starts)
        span_features = feats.new_zeros((B, S) + tuple(feats.shape[1:]))
        span_starts = np.full((B, S), -1, np.int32)
        dst, src = [], []
        cursor = 0
        for b in range(B):
            n = slice_counts[b]
            for si, st in enumerate(all_starts[b][:n]):
                dst.append(b * S + si)
                src.append(row_of[cursor + si])
                span_starts[b, si] = st
            cursor += n
        if dst:
            flat = span_features.view(B * S, *feats.shape[1:])
            flat.index_copy_(0, to_device(np.asarray(dst, np.int64), dev),
                             feats.index_select(0, to_device(np.asarray(src, np.int64), dev)))
        return prompts, span_features, span_starts

    def _text(self, res, b: int) -> str:
        return self.tokenizer.decode(res.tokens[b][: res.lengths[b]],
                                     skip_special_tokens=True).strip()

    # ---------------------------------------------------------- modes

    def diverse_gen(self, items, *, temperature=0.7, max_new_tokens=512, batch_size=4,
                    seed=0, continuous=False, share_repeats: bool = True) -> List[dict]:
        sp = SamplingParams(temperature=temperature, do_sample=True, repetition_penalty=1.05)
        if not continuous and share_repeats and not self.engine.fused_decode:
            rows = self._diverse_gen_shared(items, sp, max_new_tokens, batch_size, seed)
            if rows is not None:
                return rows
        if continuous:
            prompts, feats, starts = self._prepare(items)
            res = self.engine.generate_continuous(
                prompts, span_features=feats, span_starts=starts, slots=batch_size,
                sampling=sp, max_new_tokens=max_new_tokens, seed=seed)
            return [self._row(item, answer=self._text(res, b)) for b, item in enumerate(items)]
        out = []
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            prompts, feats, starts = self._prepare(chunk)
            res = self.engine.generate(prompts, span_features=feats, span_starts=starts,
                                       sampling=sp, max_new_tokens=max_new_tokens, seed=seed + i)
            out.extend(self._row(item, answer=self._text(res, b)) for b, item in enumerate(chunk))
        return out

    def _diverse_gen_shared(self, items, sp, max_new_tokens, batch_size, seed):
        """One slice encode and one prefill a repeat group
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
            prompts, feats, starts = self._prepare([items[group[0]]])
            active = int((starts[0] >= 0).sum())
            for c0 in range(0, len(group), cap):
                sub = group[c0:c0 + cap]
                res = self.engine.generate_repeated(
                    prompts[0], n=len(sub), span_features=feats[0][:active],
                    span_starts=starts[0][:active], sampling=sp,
                    max_new_tokens=max_new_tokens, seed=seed + sub[0])
                for b, i in enumerate(sub):
                    out[i] = self._row(items[i], answer=self._text(res, b))
        for s0 in range(0, len(singles), batch_size):
            sub = singles[s0:s0 + batch_size]
            chunk = [items[i] for i in sub]
            prompts, feats, starts = self._prepare(chunk)
            res = self.engine.generate(prompts, span_features=feats, span_starts=starts,
                                       sampling=sp, max_new_tokens=max_new_tokens,
                                       seed=seed + s0)
            for b, i in enumerate(sub):
                out[i] = self._row(chunk[b], answer=self._text(res, b))
        return out

    def _yesno_ids(self) -> dict:
        return {w: self.tokenizer.encode(f"{self.tokenizer.bos_token}{w}")[-1]
                for w in ("yes", "Yes", "no", "No")}

    def _score_row(self, item, logits, ids) -> dict:
        logits = np.asarray(logits, np.float64)
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        text = self.tokenizer.decode([int(logits.argmax())], skip_special_tokens=True).strip()
        return self._row(item, answer=text, scores={w: float(probs[t]) for w, t in ids.items()})

    def _score_plain(self, chunk, ids) -> List[dict]:
        prompts, feats, starts = self._prepare(chunk)
        res = self.engine.generate(prompts, span_features=feats, span_starts=starts,
                                   sampling=SamplingParams.greedy(), max_new_tokens=1)
        return [self._score_row(item, res.first_logits[b], ids) for b, item in enumerate(chunk)]

    def autocheck(self, items, *, batch_size=1, shared_prefix: bool = True) -> List[dict]:
        """Yes/no scores of each fact question. shared_prefix: the facts
        about one image share the sliced-image prefix (every slice's SigLIP
        encode and its prefill), computed once an image; only the question
        suffixes prefill a fact. The split is the group's longest common
        token prefix, decided from tokenisation alone before any encode;
        a group whose last span ends past it takes the plain path."""
        ids = self._yesno_ids()
        if not shared_prefix or self.engine.fused_decode:
            out = []
            for i in range(0, len(items), batch_size):
                out.extend(self._score_plain(items[i:i + batch_size], ids))
            return out

        out: List[dict] = [None] * len(items)
        sb = max(batch_size, 4)  # suffix rows are short: not one at a time
        for group in group_consecutive(items):
            chunk = [items[i] for i in group]
            built = [self._build_prompt(it) for it in chunk]
            prompts = [b[0] for b in built]
            P = self.engine.longest_common_prefix_len(prompts)
            active = [int(s) for s in built[0][1]]
            last_span_end = (max(active) + self.cfg.query_num) if active else 0
            if len(group) < 2 or last_span_end > P:
                for i0 in range(0, len(chunk), batch_size):
                    for j, row in enumerate(self._score_plain(chunk[i0:i0 + batch_size], ids)):
                        out[group[i0 + j]] = row
                continue
            # the shared path: one representative encode a group
            _, feats, starts = self._prepare(chunk[:1])
            logits = self.engine.score_shared_prefix(
                prompts[0][:P], [p[P:] for p in prompts], span_features=feats[0],
                span_starts=starts[0], batch_size=sb)
            for j, i in enumerate(group):
                out[i] = self._score_row(chunk[j], logits[j], ids)
        return out

    def chat(self, question: str, image, *, max_new_tokens: int = 1024, seed: int = 0) -> str:
        """Single-image QA through the sliced path, with the reference's
        chat sampling (T 0.7, top-p 0.8, repetition 1.05)."""
        prompts, feats, starts = self._prepare(
            [{"question": question, "image": image, "question_id": 0}])
        sp = SamplingParams(temperature=0.7, top_p=0.8, do_sample=True, repetition_penalty=1.05)
        res = self.engine.generate(prompts, span_features=feats, span_starts=starts,
                                   sampling=sp, max_new_tokens=max_new_tokens, seed=seed)
        return self._text(res, 0)

    def _row(self, item, **fields):
        meta = item.get("metainfos", item.get("metainfo", {}))
        if (isinstance(meta, dict) and "image_path" not in meta
                and item.get("image_path")):
            # the reference folds a top-level image_path into metainfos
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


class MiniCPMVChat:
    """MiniCPM-Llama3-V 2.5 chat from a checkpoint directory (the JAX
    package's MiniCPMVChat: the reference's chat.py covers 7B and 12B and
    drives MiniCPM-V through remote code)."""

    def __init__(self, model_path: str, *, tokenizer=None, max_new_tokens: int = 1024,
                 int8: bool = False, int4: bool = False, int4_smooth: bool = False,
                 fused_decode: bool = False, device="cuda"):
        from rlaifv_tpu_torch.models.convert import (
            convert_minicpmv,
            fuse_llm_projections_,
            load_jax_params,
            load_state_dict_dir,
            minicpmv_config_from_hf,
            quantize_llm_int4,
            quantize_llm_int8,
            set_llm_config,
        )
        from rlaifv_tpu_torch.models.minicpmv import MiniCPMVForCausalLM
        from rlaifv_tpu_torch.models.quant_smooth import smooth_quantize_for_serving

        if fused_decode and not (int8 or int4):
            int8 = True
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        dt = dict(dtype=dtype, param_dtype=dtype)
        cfg = minicpmv_config_from_hf(model_path, llm=dt, vision=dt)
        model = MiniCPMVForCausalLM(cfg, device="meta").to_empty(device=device)
        load_jax_params(model, convert_minicpmv(load_state_dict_dir(model_path)))
        # the float weights load first, then the LLM is quantised in place
        # on the device; the SigLIP tower stays float
        if int4 and int4_smooth:
            # AWQ-style smoothing of the LLM (alpha 0.5), calibrated with the
            # tokenizer given here (the id ramp without one, as the JAX
            # package)
            smooth_quantize_for_serving(cfg.llm, model, tokenizer)
        elif int4:
            quantize_llm_int4(model, include_lm_head=False)
        elif int8:
            quantize_llm_int8(model, include_lm_head=False)
        if int4 or int8:
            set_llm_config(model, kv_cache_dtype="int8")
        if fused_decode:
            fuse_llm_projections_(model)
        model.eval()
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.gen = MiniCPMVGenerator(model, tokenizer, checkpoint_name=model_path,
                                     fused_decode=fused_decode)
        self.max_new_tokens = max_new_tokens

    def chat(self, input: dict) -> str:
        return self.gen.chat(input["question"], input["image"],
                             max_new_tokens=self.max_new_tokens)
