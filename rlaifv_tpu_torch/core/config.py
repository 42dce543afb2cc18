"""Configuration tree, jax-free: the same dataclasses as
rlaifv_tpu/core/config.py, so `configs/*.json` load unchanged, with
`resolve_dtype` giving torch dtypes.

Every field loads and is read: the mesh fields `training.mesh_dp /
mesh_fsdp / mesh_tp` by the trainer (parallel/sharding.py's mesh over the
processes, one device each; fsdp null takes the processes dp x tp leaves).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class ModelArguments:
    model_name_or_path: str = ""
    model_family: str = "llava15"  # llava15 | omnilmm | minicpmv
    vision_tower: str = "openai/clip-vit-large-patch14-336"
    mm_projector_type: str = "mlp2x_gelu"
    mm_vision_select_layer: int = -2
    image_aspect_ratio: str = "pad"  # ref llava15_train.sh:37
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    # weight-only quantised frozen LLM base (the reference loader's 8-bit
    # and 4-bit options), quantised on the device after loading. With
    # training.use_lora this is QLoRA. The LM head stays bf16.
    quantize: bool = False
    # 8 or 4: bit width of the frozen base when quantize=true. 4 = nibble-
    # packed int4 + group-128 scales (ops/int4_matmul.py), half the int8
    # base's bytes again; quantize_bits=4 + use_lora is the original QLoRA
    # recipe (4-bit base, adapters beside it).
    quantize_bits: int = 8


@dataclasses.dataclass
class DataArguments:
    data_dir: str = ""
    dataset_name: str = "openbmb/RLAIF-V-Dataset"  # ref datasets.py:43 (now a knob)
    max_len: int = 2048  # ref llava15_train.sh:38
    is_multimodal: bool = True
    num_workers: int = 8


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "./output"
    task: str = "DPO"
    learning_rate: float = 5e-7  # ref llava15_train.sh:31
    weight_decay: float = 0.01
    warmup_ratio: float = 0.05
    lr_schedule: str = "cosine"
    max_steps: int = 2672  # ref llava15_train.sh:30
    per_device_batch_pairs: int = 1  # ref bs 1/gpu (llava15_train.sh:21)
    gradient_accumulation: int = 1
    save_steps: int = 167  # ref llava15_train.sh:26
    save_total_limit: int = 50
    logging_steps: int = 1
    seed: int = 0
    max_grad_norm: float = 1.0
    # DPO knobs (ref train_llava15.py:66-67,95-96)
    dpo_beta: float = 0.1
    dpo_token_weight: float = 1.0
    dpo_use_average: bool = False
    dpo_token_weighted: bool = False
    sft_weight: float = 0.0
    dpo_weight: float = 1.0
    # "xla" | "fused" | "auto": fused = Pallas fused LM-head (no (2B,L,V)
    # logits); auto picks fused for hidden_size >= 2048 (7B+), xla below.
    lm_head_impl: str = "auto"
    # static per-row bound on loss-carrying label positions; >0 enables the
    # compact head (head computed only at answer positions) when
    # lm_head_impl is "compact" or "auto"
    compact_len: int = 0
    # >0: win/rej rows share the first shared_prefix_len tokens; the pair's
    # prompt prefix runs ONCE per step (train/paired_forward.py). Safe value
    # for LLaVA-1.5: system + image span (the trainer validates every batch
    # and hard-fails on violation). -1: derive from the first batch via the
    # image-end rule (train_step.derive_shared_prefix_len). 0 = plain
    # concatenated forward.
    shared_prefix_len: int = 0
    # with shared_prefix_len > 0: carry only the first shared_suffix_len
    # tokens after the prefix (multiple of 128; 0 = all). Exact as long as
    # every supervised label fits in prefix+suffix — the trainer hard-fails
    # otherwise. The padded tail past prompt+answer is dead weight: at
    # max_length 2048 with ~256-token answers this cuts suffix compute ~4x.
    shared_suffix_len: int = 0
    # LoRA (ref train_llava15_lora.py:112-117)
    use_lora: bool = False
    lora_r: int = 64
    lora_alpha: int = 16
    lora_dropout: float = 0.05
    # mesh
    mesh_dp: int = 1
    mesh_fsdp: Optional[int] = None
    mesh_tp: int = 1


@dataclasses.dataclass
class Config:
    model: ModelArguments = dataclasses.field(default_factory=ModelArguments)
    data: DataArguments = dataclasses.field(default_factory=DataArguments)
    training: TrainingArguments = dataclasses.field(default_factory=TrainingArguments)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        return Config(
            model=ModelArguments(**d.get("model", {})),
            data=DataArguments(**d.get("data", {})),
            training=TrainingArguments(**d.get("training", {})),
        )

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def resolve_dtype(name: str) -> torch.dtype:
    return {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
    }[name]
