"""Single-image chat with LLaVA-1.5 / LLaVA-1.6, OmniLMM-12B or MiniCPM-Llama3-V
2.5 on the port.

    python -m rlaifv_tpu_torch.chat --model-path <ckpt> [--image img.jpg]
        [--question "..."] [--kv-int8] [--load-8bit] [--load-4bit]
        [--lookup-decode] [--device cpu]

Counterpart of the root chat.py (ref chat.py:143-241): `RLAIFV7B.chat`
builds an llava_v1 prompt, splices the image sentinel, resizes the image
(normalised on the device) and decodes with 3 beams, T 0, 1024 new tokens
at most, through `DecodeEngine.generate_beam`; the model is picked by path
substring as there. The checkpoint's config.json gives the model
(`llava_config_from_hf`, full, LoRA-over-base or projector-delta layouts
through `load_pretrained_llava`), in bf16 on the card (the default; no
visible card is an error) or in fp32 on the CPU with `--device cpu`.

- `--load-8bit`: weight-only int8 LLM projections (kernels #9/#7 on the
  card); `--kv-int8`: an int8 decode cache (kernel #5).
- `--load-4bit`: weight-only group int4 LLM projections (kernel #11), the
  head float; with RLAIFV_INT4_SMOOTH=1 the float model is loaded,
  calibrated on one sentence and smoothed with the per-layer alpha search
  before quantising (models/quant_smooth.py).
- `--lookup-decode`: prompt-lookup greedy decoding (genai/lookup_decode.py)
  in place of the 3 beams: the greedy tokens in fewer forwards; it needs
  the bf16 cache (with `--kv-int8`: ValueError).
- An anyres checkpoint (LLaVA-1.6: image_aspect_ratio "anyres") reads the
  checkpoint's `image_newline`, encodes the image's grid views and merges
  them (models/anyres.py `encode_anyres`), and beam-decodes with the
  merged features spliced as one span.

A path holding "12B" loads OmniLMM-12B (genai/omni_gen.py `OmniLMMChat`, as
the root chat.py: 3 beams combined with sampling): `--load-8bit` quantises
both towers to int8 with an int8 KV cache, `--load-4bit` to int4 (plain
group quantisation); `--kv-int8` and `--lookup-decode` do not apply there.
A path holding "minicpm" (any case) loads MiniCPM-Llama3-V 2.5
(genai/minicpmv_gen.py `MiniCPMVChat`, as the JAX package's chat CLI:
sampled T 0.7 / top-p 0.8 / repetition 1.05): `--load-8bit` quantises the
LLM to int8 with an int8 KV cache, `--load-4bit` to int4, the SigLIP tower
left float.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

# the root chat.py's calibration sentence for RLAIFV_INT4_SMOOTH=1
CALIBRATION_TEXT = ("A chat between a curious human and an artificial intelligence "
                    "assistant. The assistant gives helpful, detailed, and polite answers "
                    "to the human's questions.")


class RLAIFV7B:
    """LLaVA-1.5-7B (CLIP-L/14-336 + Vicuna-7B) chat on the port, and
    LLaVA-1.6 (anyres) checkpoints."""

    def __init__(self, model_path: str, model_base: Optional[str] = None,
                 max_new_tokens: int = 1024, load_8bit: bool = False,
                 load_4bit: bool = False, kv_int8: bool = False,
                 lookup_decode: bool = False, device="cuda", tokenizer=None):
        import numpy as np
        import torch

        from rlaifv_tpu_torch.models.convert import (
            llava_config_from_hf,
            load_image_newline,
            load_jax_params,
            load_pretrained_llava,
        )
        from rlaifv_tpu_torch.models.llava import LlavaForCausalLM
        from rlaifv_tpu_torch.models.quant_smooth import quantize_llm_int4_smooth

        int4_smooth = load_4bit and os.environ.get("RLAIFV_INT4_SMOOTH") == "1"
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        dt = dict(dtype=dtype, param_dtype=dtype)
        llm = dict(dt, **({"kv_cache_dtype": "int8"} if kv_int8 else {}))
        if load_4bit and not int4_smooth:
            llm.update(quantize=True, quantize_bits=4, quantize_lm_head=False)
        elif load_8bit and not load_4bit:
            llm["quantize"] = True
        cfg = llava_config_from_hf(model_base or model_path, llm=llm, vision=dt)
        model = LlavaForCausalLM(cfg, device="meta").to_empty(device=device)
        # full / LoRA-over-base / projector-delta checkpoints, as the
        # reference's loader reads them; the smoothed int4 path loads float
        load_jax_params(model, load_pretrained_llava(
            model_path, model_base=model_base, vision_layers_to_run=cfg.vision.layers_to_run,
            quantize_llm=(False if int4_smooth else "int4" if load_4bit else load_8bit)))
        model.eval()
        if tokenizer is None:
            from transformers import AutoTokenizer

            try:  # the slow tokenizer, for llama tokenization parity
                tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=False)
            except (ValueError, OSError):
                tokenizer = AutoTokenizer.from_pretrained(model_path)
        if int4_smooth:
            # AWQ-style smoothing before int4 (the root chat.py's
            # RLAIFV_INT4_SMOOTH=1): one calibration forward, the per-layer
            # alpha search, then group int4 in place
            calib = np.asarray(tokenizer(CALIBRATION_TEXT).input_ids, np.int32)[None]
            quantize_llm_int4_smooth(model, calib)
        image_newline = (load_image_newline(model_path)
                         if cfg.image_aspect_ratio == "anyres" else None)
        self._setup(model, tokenizer, max_new_tokens, lookup_decode, image_newline)

    @classmethod
    def from_model(cls, model, tokenizer, *, max_new_tokens: int = 1024,
                   lookup_decode: bool = False, image_newline=None) -> "RLAIFV7B":
        """The chat over a model already built (on its device), as the
        constructor leaves it after loading a checkpoint; image_newline (D,)
        for an anyres model."""
        self = cls.__new__(cls)
        self._setup(model, tokenizer, max_new_tokens, lookup_decode, image_newline)
        return self

    def _setup(self, model, tokenizer, max_new_tokens, lookup_decode, image_newline):
        from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor
        from rlaifv_tpu_torch.genai.engine import DecodeEngine

        if lookup_decode and model.cfg.llm.kv_cache_dtype == "int8":
            raise ValueError("--lookup-decode needs the bf16 KV cache (drop --kv-int8)")
        self.model, self.cfg, self.tokenizer = model, model.cfg, tokenizer
        self.image_processor = ClipImageProcessor(image_size=self.cfg.vision.image_size)
        self.engine = DecodeEngine(model, eos_id=tokenizer.eos_token_id,
                                   pad_id=tokenizer.pad_token_id or 0)
        self.max_new_tokens = max_new_tokens
        self.lookup_decode = lookup_decode
        self.image_newline = image_newline

    def prompt(self, question: str, n_image_tokens: Optional[int] = None) -> dict:
        """The llava_v1 prompt of `question` with the image sentinel spliced
        -> {"input_ids", "image_start"} (image slots expanded to
        n_image_tokens, the config's by default)."""
        from rlaifv_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
        from rlaifv_tpu_torch.data import conversation as conversation_lib
        from rlaifv_tpu_torch.data.multimodal import expand_image_sentinels, tokenizer_image_token

        conv = conversation_lib.conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        return expand_image_sentinels(ids, None, n_image_tokens or self.cfg.num_image_tokens)

    def chat(self, input: dict) -> str:
        from rlaifv_tpu_torch.data.image_processing import decode_image

        if self.cfg.image_aspect_ratio == "anyres":
            # LLaVA-1.6: the merged grid features (T varies with the image)
            # ride the span splice as one span (ref llava_arch.py:158-205)
            from rlaifv_tpu_torch.models.anyres import encode_anyres

            merged = encode_anyres(self.model, self.image_processor, self.cfg, input["image"],
                                   image_newline=self.image_newline)
            ex = self.prompt(input["question"], merged.shape[0])
            res = self.engine.generate_beam(
                [ex["input_ids"].tolist()], span_features=merged[None, None],
                span_starts=[[int(ex["image_start"])]], num_beams=3,
                max_new_tokens=self.max_new_tokens)
            return self._text(res.tokens[0][:res.lengths[0]])
        ex = self.prompt(input["question"])
        # resize-only uint8, normalised on the device
        image = self.image_processor.resize_uint8(decode_image(input["image"]))
        if self.lookup_decode:
            from rlaifv_tpu_torch.genai.lookup_decode import lookup_generate

            res = lookup_generate(self.engine, ex["input_ids"].tolist(), images=image[None],
                                  image_starts=[int(ex["image_start"])],
                                  max_new_tokens=self.max_new_tokens)
            return self._text(res.tokens)
        # ref chat.py:169-178: do_sample=False, num_beams=3
        res = self.engine.generate_beam(
            [ex["input_ids"].tolist()], images=image[None],
            image_starts=[int(ex["image_start"])], num_beams=3,
            max_new_tokens=self.max_new_tokens)
        return self._text(res.tokens[0][:res.lengths[0]])

    def _text(self, tokens) -> str:
        return self.tokenizer.decode(tokens, skip_special_tokens=True).strip()


class RLAIFVChat:
    """Pick the model family by path substring (ref chat.py:221-228)."""

    def __init__(self, model_path: str, load_8bit: bool = False, load_4bit: bool = False,
                 kv_int8: bool = False, lookup_decode: bool = False, device="cuda",
                 max_new_tokens: int = 1024, tokenizer=None):
        if "12B" in model_path:
            from rlaifv_tpu_torch.genai.omni_gen import OmniLMMChat

            # --load-8bit: the one-card 12B configuration (int8 on both
            # towers, int8 KV cache); --load-4bit: int4 group quantisation
            self.model = OmniLMMChat(model_path, int8=load_8bit, int4=load_4bit,
                                     device=device, max_new_tokens=max_new_tokens,
                                     tokenizer=tokenizer)
        elif "minicpm" in model_path.lower():
            from rlaifv_tpu_torch.genai.minicpmv_gen import MiniCPMVChat

            # --load-8bit / --load-4bit: the one-card configuration (int8 or
            # int4 LLM, int8 KV cache, the SigLIP tower float)
            self.model = MiniCPMVChat(model_path, int8=load_8bit, int4=load_4bit,
                                      device=device, max_new_tokens=max_new_tokens,
                                      tokenizer=tokenizer)
        else:
            base = None
            if "lora" in model_path.lower():
                # ref chat.py:228: LoRA checkpoints load over the llava base
                base = os.environ.get("RLAIFV_MODEL_BASE", "liuhaotian/llava-v1.5-7b")
            self.model = RLAIFV7B(model_path, model_base=base, max_new_tokens=max_new_tokens,
                                  load_8bit=load_8bit, load_4bit=load_4bit, kv_int8=kv_int8,
                                  lookup_decode=lookup_decode, device=device,
                                  tokenizer=tokenizer)

    def chat(self, input: dict) -> str:
        return self.model.chat(input)


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-image chat with the port")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--image", default="./examples/test.jpeg")
    ap.add_argument("--question", default="Why did the car in the picture stop?")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 decode KV cache (half the cache memory)")
    ap.add_argument("--load-8bit", action="store_true",
                    help="weight-only int8 LLM projections")
    ap.add_argument("--load-4bit", action="store_true",
                    help="weight-only group int4 LLM (RLAIFV_INT4_SMOOTH=1: AWQ-style "
                         "smoothing first, 7B)")
    ap.add_argument("--lookup-decode", action="store_true",
                    help="7B only: prompt-lookup greedy decoding instead of 3 beams")
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; no visible card is an error) or cpu")
    args = ap.parse_args(argv)

    from rlaifv_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device, "rlaifv_tpu_torch.chat")
    chat_model = RLAIFVChat(args.model_path, load_8bit=args.load_8bit,
                            load_4bit=args.load_4bit, kv_int8=args.kv_int8,
                            lookup_decode=args.lookup_decode, device=device,
                            max_new_tokens=args.max_new_tokens)
    print(chat_model.chat({"image": args.image, "question": args.question}))


if __name__ == "__main__":
    main()
