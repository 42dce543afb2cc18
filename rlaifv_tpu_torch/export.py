"""Export a training run of the port back to a reference/HF-loadable
checkpoint dir.

    python -m rlaifv_tpu_torch.export --config cfg.json \
        --out output/run1_hf [--train-dir output/run1] [--step N]

Counterpart of scripts/export_hf.py, with its flags. It restores the
trainer's step checkpoint (core/checkpoint.py) and decides by what the
checkpoint holds, not by the config (a `--demo` run trains the full model
under any config):

- LoRA/QLoRA runs (the adapters by flax path) -> adapter_model.bin +
  adapter_config.json (peft layout; load with
  `load_pretrained_llava(adapter_dir, base_dir)` or the reference's
  --model-base path);
- full runs (the model's state dict) -> pytorch_model.bin + config.json (+
  tokenizer files and the dead final ViT block passed through from the
  base checkpoint when model_name_or_path is a directory). The model is
  built from the config the checkpoint carries (the trainer writes its
  model's class and config beside the weights): LLaVA-1.5-7B for a
  `--config` run, the tiny LLaVA for a `--demo` one.

Export is host-side conversion: it runs on the CPU and never touches a
card.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _is_lora_state(params: dict) -> bool:
    """A LoRA checkpoint holds the adapters by flax path (.../q_proj/a)."""
    return any(k.rsplit("/", 1)[-1] in ("a", "b") for k in params)


def _lora_tree(params: dict) -> dict:
    tree: dict = {}
    for path, value in params.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def llava_config(d: dict):
    """The LlavaConfig a checkpoint's `model.config` dict describes (the
    trainer writes `dataclasses.asdict` of its model's config)."""
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig

    return LlavaConfig(**{**d, "llm": LlamaConfig(**d["llm"]),
                          "vision": CLIPVisionConfig(**d["vision"])})


def full_model(state: dict):
    """The LLaVA the checkpoint `state` was trained on, built from the
    config it carries, its tensors assigned from the state's params (no
    copy)."""
    from rlaifv_tpu_torch.models.llava import LlavaForCausalLM

    if state["model"]["class"] != "LlavaForCausalLM":
        raise ValueError(f"full-model export writes LLaVA checkpoints; the run trained "
                         f"{state['model']['class']} (its LoRA adapters export)")
    cfg = llava_config(state["model"]["config"])
    model = LlavaForCausalLM(cfg, device="meta")
    model.load_state_dict(state["params"], assign=True)
    return cfg, model


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rlaifv_tpu_torch.export")
    ap.add_argument("--config", required=True,
                    help="the training config json of the run")
    ap.add_argument("--train-dir", default=None,
                    help="training output dir (default: config output_dir)")
    ap.add_argument("--out", required=True, help="export directory")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    args = ap.parse_args(argv)

    from rlaifv_tpu_torch.core.checkpoint import CheckpointManager
    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.models.export import (
        export_llava_hf,
        export_peft_lora,
        lora_params,
        params_from_model,
    )

    config = Config.from_json(args.config)
    t = config.training
    train_dir = args.train_dir or t.output_dir
    ckpt = CheckpointManager(os.path.join(train_dir, "checkpoints"))
    step = args.step if args.step is not None else ckpt.latest_step()
    print(f"[export] restoring step {step} from {train_dir}")
    state = ckpt.restore(step)
    params = state["params"]

    if _is_lora_state(params):
        out = export_peft_lora(
            lora_params(_lora_tree(params)), args.out,
            alpha=float(getattr(t, "lora_alpha", 16.0)),
            r=int(getattr(t, "lora_r", 64)),
            base_model_name=config.model.model_name_or_path,
        )
        print(f"[export] peft adapter dir: {out} "
              f"(load with model_base={config.model.model_name_or_path})")
    else:
        cfg, model = full_model(state)
        base = config.model.model_name_or_path
        with torch.no_grad():
            tree = params_from_model(model)
        out = export_llava_hf(
            tree, args.out, cfg=cfg,
            base_dir=base if base and os.path.isdir(base) else None,
            dtype=np.float16,
        )
        print(f"[export] full checkpoint dir: {out}")
    return out


if __name__ == "__main__":
    main()
