"""DPO training entry point of the PyTorch port.

    python -m rlaifv_tpu_torch.train --config cfg.json   # run from a checkpoint
    python -m rlaifv_tpu_torch.train --demo              # tiny synthetic run

Counterpart of train.py for the llava15 and omnilmm families on one device:
the card (`--device cuda`, the default; without a visible card the run
stops with an error) or the CPU when asked (`--device cpu`). `--config`
builds the family's model (`MODEL_BUILDERS`: LLaVA-1.5-7B, or OmniLMM-12B =
EVA02-enormous + resampler + Mistral-7B), loads its HF checkpoint through
the port's numpy converters and the bridge (`load_base`, which quantises
the base through `quantize_base`), then follows
train.py: when the dataset directory holds no `*logp*.parquet`, the frozen
starting policy scores its raw parquet rows first (train/ref_logp.py, with
the train step's head), and DPO trains against those reference logps
through the family's adapter.

`training.use_lora` trains LoRA adapters (train/lora.py, seeded from
`training.seed`) on the LLM's projections over the frozen model;
`model.quantize` (which needs use_lora, as in train.py) first quantises the
base on the device, the head kept bf16 (QLoRA): the LLM's projections to
int8, or with `model.quantize_bits` 4 to nibble-packed int4 with group-128
scales (the original QLoRA recipe), and for OmniLMM at 4 bits the EVA02
tower too (at 8 bits it stays bf16, as in train.py). The reference logps
are then scored on that quantised base.
"""
from __future__ import annotations

import argparse
import os

import torch

from rlaifv_tpu_torch.train.family import get_family


def resolve_device(name: str, prog: str = "rlaifv_tpu_torch.train") -> torch.device:
    """"cuda" (the default) needs a visible card; "cpu" only when asked."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is visible; "
                         "pass --device cpu to run on the CPU")
    return torch.device(name)


def build_llava(config, device):
    """Config -> (LlavaConfig, LlavaForCausalLM built on `device`,
    parameters uninitialised)."""
    from rlaifv_tpu_torch.core.config import resolve_dtype
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

    m = config.model
    dtype, pdtype = resolve_dtype(m.dtype), resolve_dtype(m.param_dtype)
    # built in float: run_config quantises the loaded weights in place
    cfg = LlavaConfig(
        llm=LlamaConfig.vicuna_7b(dtype=dtype, param_dtype=pdtype, remat=m.remat),
        vision=CLIPVisionConfig.clip_l_336(dtype=dtype, param_dtype=pdtype),
        projector_type=m.mm_projector_type,
    )
    return cfg, LlavaForCausalLM(cfg, device="meta").to_empty(device=device)


def build_omnilmm(config, device):
    """Config -> (OmniLMMConfig, OmniLMMForCausalLM built on `device`,
    parameters uninitialised): EVA02-enormous, 64 resampler queries and
    Mistral-7B, the presets train.py builds (not the checkpoint's
    config.json)."""
    from rlaifv_tpu_torch.core.config import resolve_dtype
    from rlaifv_tpu_torch.models.eva02 import EvaConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.omnilmm import OmniLMMConfig, OmniLMMForCausalLM

    m = config.model
    dtype, pdtype = resolve_dtype(m.dtype), resolve_dtype(m.param_dtype)
    # built in float: load_base quantises the loaded weights in place
    cfg = OmniLMMConfig(
        llm=LlamaConfig.mistral_7b(dtype=dtype, param_dtype=pdtype, remat=m.remat),
        vision=EvaConfig.enormous(dtype=dtype, param_dtype=pdtype),
        num_query=64,
    )
    return cfg, OmniLMMForCausalLM(cfg, device="meta").to_empty(device=device)


# config -> (model config, model) by family
MODEL_BUILDERS = {"llava15": build_llava, "omnilmm": build_omnilmm}


def load_base(config, model):
    """train.py's `load_params` on a built model, in place: the family's
    HF checkpoint at model.model_name_or_path, then `quantize_base`."""
    import numpy as np

    from rlaifv_tpu_torch.models import convert

    path = config.model.model_name_or_path
    print(f"[train] loading checkpoint {path}", flush=True)
    if config.model.model_family == "llava15":
        tree = convert.load_llava_checkpoint(
            path, dtype=np.float32, vision_layers_to_run=model.cfg.vision.layers_to_run)
    else:
        tree = convert.convert_omnilmm(convert.load_state_dict_dir(path), dtype=np.float32)
    convert.load_jax_params(model, tree)
    del tree
    return quantize_base(config, model)


def quantize_base(config, model):
    """With model.quantize, the frozen base quantised in place on the
    model's device, the head kept float. 8 bits: the LLM's projections to
    int8 (OmniLMM's EVA02 tower stays bf16); 4 bits: the projections to
    packed int4, and OmniLMM's tower too."""
    from rlaifv_tpu_torch.models import convert

    if config.model.quantize:
        if config.model.quantize_bits == 4:
            convert.quantize_llm_int4(model)
            if config.model.model_family != "llava15":
                convert.quantize_vision_int4(model)
        else:
            convert.quantize_llm_int8(model, include_lm_head=False)
    return model


def check_quantize(config) -> None:
    """train.py's rule: a quantised base trains nothing by itself; and the
    bit width is 8 or 4."""
    m = config.model
    if not m.quantize:
        return
    if not config.training.use_lora:
        raise AssertionError(
            "model.quantize trains nothing by itself — the quantized base "
            "is frozen; combine with training.use_lora (QLoRA)")
    from rlaifv_tpu_torch.models.llama import LlamaConfig, check_supported

    check_supported(LlamaConfig(quantize=True, quantize_bits=m.quantize_bits))


def run_config(config, device) -> int:
    family = config.model.model_family
    spec = get_family(family)  # an unknown family raises before any load
    from transformers import AutoTokenizer

    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.data.datasets import DPODataset
    from rlaifv_tpu_torch.train.ref_logp import inference_logp
    from rlaifv_tpu_torch.train.trainer import DPOTrainer, precompute_head

    check_quantize(config)
    cfg, model = MODEL_BUILDERS[family](config, device)
    cfg = load_base(config, model).cfg
    tokenizer = AutoTokenizer.from_pretrained(config.model.model_name_or_path,
                                              use_fast=(family != "llava15"))
    tokenizer.model_max_length = config.data.max_len
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.unk_token
    proc = spec.image_processor(cfg.vision.image_size)
    mm_cfg = spec.mm_cfg(proc, cfg.num_image_tokens)
    mm_cfg["is_multimodal"] = config.data.is_multimodal

    def score_fn(data_dir):
        # lazy reference-logp precompute on the frozen starting policy
        import pyarrow.parquet as pq

        raw = [f for f in os.listdir(data_dir)
               if f.endswith(".parquet") and "logp" not in f]
        if not raw:
            raise FileNotFoundError(f"no raw parquet rows in {data_dir} to score")
        rows = []
        for f in sorted(raw):
            rows.extend(pq.read_table(os.path.join(data_dir, f)).to_pylist())
        # train.py's head: the train step's at compact_len 0, which keeps
        # policy == reference => loss = ln 2 exact
        inference_logp(rows, model, tokenizer, data_dir, max_len=config.data.max_len,
                       num_patches=cfg.num_image_tokens, image_processor=proc,
                       lm_head_impl=precompute_head(config.training, cfg.llm.hidden_size,
                                                    cfg.llm.dtype),
                       family=family)

    dataset = DPODataset(tokenizer, config.data.data_dir, mm_cfg, score_fn=score_fn,
                         preprocess_func=spec.preprocess_func)
    collator = DPOCollator(
        pad_token_id=tokenizer.pad_token_id, max_len=config.data.max_len,
        num_patches=cfg.num_image_tokens, beta=config.training.dpo_beta,
        mod_token_weight=config.training.dpo_token_weight,
        task=config.training.task, **spec.collator_kwargs(tokenizer),
    )
    steps = DPOTrainer(config, model, dataset, collator, adapter=spec.adapter(model),
                       **lora_kwargs(config, model, device)).train()
    print("[train] done", flush=True)
    return steps


def lora_kwargs(config, model, device) -> dict:
    """DPOTrainer's LoRA arguments: adapters on every LLM projection, drawn
    from training.seed, when training.use_lora (train.py's order)."""
    t = config.training
    if not t.use_lora:
        return {}
    from rlaifv_tpu_torch.train.lora import lora_init

    if t.lora_dropout:
        # the adapters add (x @ a) @ b to each projection with no dropout
        # branch (ref peft drops the adapter input; default 0.05)
        print("[train] lora_dropout is ignored by the folded-merge "
              "LoRA design", flush=True)
    lora = lora_init(torch.Generator(device=device).manual_seed(t.seed), model,
                     r=t.lora_r)
    return dict(lora=lora, lora_alpha=t.lora_alpha)


def run_demo(config, device) -> int:
    """Tiny synthetic end-to-end run (random weights, seed 0) of
    model.model_family (llava15 or omnilmm)."""
    family = config.model.model_family
    spec = get_family(family)
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.train.trainer import DPOTrainer

    gen = torch.Generator(device=device).manual_seed(0)
    if family == "omnilmm":
        from rlaifv_tpu_torch.models.omnilmm import (
            OmniLMMConfig,
            OmniLMMForCausalLM,
            init_omnilmm_weights_,
        )
        from rlaifv_tpu_torch.utils.synth import synth_omni_preference_pairs

        cfg = OmniLMMConfig.tiny()
        pairs = synth_omni_preference_pairs(cfg, 16, answer_len=12, question_len=8)
        model = init_omnilmm_weights_(OmniLMMForCausalLM(cfg, device=device), gen)
        collator_kw = {"expand_images": False, "image_patch_id": 250}
    else:
        from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
        from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

        cfg = LlavaConfig.tiny()
        pairs = synth_preference_pairs(cfg, 16, answer_len=12, question_len=8)
        model = init_weights_(LlavaForCausalLM(cfg, device=device), gen)
        collator_kw = {}
    config.training.max_steps = min(config.training.max_steps, 8)
    config.training.learning_rate = 1e-3
    config.training.save_steps = 4
    if config.training.output_dir == "./output":
        # one directory a family: a demo checkpoint of one family must not
        # auto-resume into the other's tree
        config.training.output_dir = f"./output/demo_{family}_torch"
    collator = DPOCollator(pad_token_id=0, max_len=64, num_patches=cfg.num_image_tokens,
                           **collator_kw)
    steps = DPOTrainer(config, model, pairs, collator, adapter=spec.adapter(model)).train()
    print(f"[demo:{family}] finished at step {steps} on {device}", flush=True)
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rlaifv_tpu_torch.train")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--demo", action="store_true",
                    help="tiny synthetic end-to-end run (no checkpoint needed)")
    ap.add_argument("--family", type=str, default=None,
                    help="override model.model_family (llava15|omnilmm)")
    ap.add_argument("--output-dir", type=str, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or, when asked, the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from rlaifv_tpu_torch.core.config import Config

    config = Config.from_json(args.config) if args.config else Config()
    if args.family:
        config.model.model_family = args.family
    if args.output_dir:
        config.training.output_dir = args.output_dir
    if args.max_steps:
        config.training.max_steps = args.max_steps
    return run_demo(config, device) if args.demo else run_config(config, device)


if __name__ == "__main__":
    main()
