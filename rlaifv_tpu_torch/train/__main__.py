"""DPO training entry point of the PyTorch port.

    python -m rlaifv_tpu_torch.train --config cfg.json   # run from a checkpoint
    python -m rlaifv_tpu_torch.train --demo              # tiny synthetic run

Counterpart of train.py for the llava15 family on one device (CUDA when
available, else the CPU). `--config` loads the HF checkpoint through the
JAX package's numpy converter (rlaifv_tpu/models/convert.py, no jax) and
bridges it with `llava_params_from_jax`. The dataset directory must
already hold the reference-logp parquet files: their precompute is not
ported yet (ROADMAP.md #4), so a directory without them raises.
"""
from __future__ import annotations

import argparse
import os

import torch


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def build_llava(config, device):
    """Config -> (LlavaConfig, LlavaForCausalLM built on `device`,
    parameters uninitialised)."""
    from rlaifv_tpu_torch.core.config import resolve_dtype
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

    m = config.model
    dtype, pdtype = resolve_dtype(m.dtype), resolve_dtype(m.param_dtype)
    cfg = LlavaConfig(
        llm=LlamaConfig.vicuna_7b(dtype=dtype, param_dtype=pdtype, remat=m.remat,
                                  quantize=m.quantize, quantize_lm_head=False,
                                  quantize_bits=m.quantize_bits),
        vision=CLIPVisionConfig.clip_l_336(dtype=dtype, param_dtype=pdtype),
        projector_type=m.mm_projector_type,
    )
    return cfg, LlavaForCausalLM(cfg, device="meta").to_empty(device=device)


def _require_logps(data_dir: str) -> None:
    have = os.path.isdir(data_dir) and any(
        f.endswith(".parquet") and "logp" in f for f in os.listdir(data_dir))
    if not have:
        raise NotImplementedError(
            f"{data_dir!r} holds no '*logp*.parquet' files and the reference-"
            "logp precompute is not ported to rlaifv_tpu_torch yet: ROADMAP.md "
            "'Modules to port' #4 (train/ref_logp.py); run it with the JAX "
            "package first (train.py)"
        )


def run_config(config) -> int:
    _require_logps(config.data.data_dir)
    import numpy as np
    from transformers import AutoTokenizer

    from rlaifv_tpu.data.collator import DPOCollator
    from rlaifv_tpu.data.datasets import DPODataset
    from rlaifv_tpu.models.convert import load_llava_checkpoint
    from rlaifv_tpu.train.family import get_family
    from rlaifv_tpu_torch.models.convert import load_jax_params
    from rlaifv_tpu_torch.train.trainer import DPOTrainer

    family = config.model.model_family
    if family != "llava15":
        raise NotImplementedError(
            f"model_family={family!r} is not ported to rlaifv_tpu_torch yet: "
            "ROADMAP.md 'Modules to port' #9 (OmniLMM-12B family)")
    cfg, model = build_llava(config, _device())
    spec = get_family(family)
    print(f"[train] loading checkpoint {config.model.model_name_or_path}", flush=True)
    load_jax_params(model, load_llava_checkpoint(
        config.model.model_name_or_path, dtype=np.float32,
        vision_layers_to_run=cfg.vision.layers_to_run))
    tokenizer = AutoTokenizer.from_pretrained(config.model.model_name_or_path,
                                              use_fast=False)
    tokenizer.model_max_length = config.data.max_len
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.unk_token
    proc = spec.image_processor(cfg.vision.image_size)
    mm_cfg = spec.mm_cfg(proc, cfg.num_image_tokens)
    mm_cfg["is_multimodal"] = config.data.is_multimodal
    dataset = DPODataset(tokenizer, config.data.data_dir, mm_cfg,
                         preprocess_func=spec.preprocess_func)
    collator = DPOCollator(
        pad_token_id=tokenizer.pad_token_id, max_len=config.data.max_len,
        num_patches=cfg.num_image_tokens, beta=config.training.dpo_beta,
        mod_token_weight=config.training.dpo_token_weight,
        task=config.training.task, **spec.collator_kwargs(tokenizer),
    )
    steps = DPOTrainer(config, model, dataset, collator).train()
    print("[train] done", flush=True)
    return steps


def run_demo(config) -> int:
    """Tiny synthetic end-to-end run (random weights, seed 0)."""
    from rlaifv_tpu.data.collator import DPOCollator
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from rlaifv_tpu_torch.train.trainer import DPOTrainer
    from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

    cfg = LlavaConfig.tiny()
    pairs = synth_preference_pairs(cfg, 16, answer_len=12, question_len=8)
    device = _device()
    model = init_weights_(LlavaForCausalLM(cfg, device=device),
                          torch.Generator(device=device).manual_seed(0))
    config.training.max_steps = min(config.training.max_steps, 8)
    config.training.learning_rate = 1e-3
    config.training.save_steps = 4
    if config.training.output_dir == "./output":
        config.training.output_dir = "./output/demo_llava15_torch"
    collator = DPOCollator(pad_token_id=0, max_len=64,
                           num_patches=cfg.num_image_tokens)
    steps = DPOTrainer(config, model, pairs, collator).train()
    print(f"[demo:llava15] finished at step {steps} on {device}", flush=True)
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rlaifv_tpu_torch.train")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--demo", action="store_true",
                    help="tiny synthetic end-to-end run (no checkpoint needed)")
    ap.add_argument("--output-dir", type=str, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args(argv)

    from rlaifv_tpu_torch.core.config import Config

    config = Config.from_json(args.config) if args.config else Config()
    if args.output_dir:
        config.training.output_dir = args.output_dir
    if args.max_steps:
        config.training.max_steps = args.max_steps
    return run_demo(config) if args.demo else run_config(config)


if __name__ == "__main__":
    main()
