"""Training loop: batches over the preference dataset, the DPO train step,
checkpoints, metric logging.

Counterpart of rlaifv_tpu/train/trainer.py on one card: the same batch
order (a seeded permutation, reshuffled when exhausted), the same
`shared_prefix_len = -1` derive-and-re-derive logic, gradient accumulation
matching optax.MultiSteps, the non-finite-loss tripwire, the compact-head
overflow check, and checkpoint save and auto-resume. The model trains in
place; with a LoRA adapter tree (the JAX trainer's `base_params` mode) the
adapters train and the model is the frozen base, and a checkpoint holds the
adapters and their optimizer state, not the base. The mesh fields of the
config are not read (one card, no mesh).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Dict, Iterator

import numpy as np
import torch

from rlaifv_tpu_torch.utils.prefetch import prefetch_iterator
from rlaifv_tpu_torch.core.checkpoint import CheckpointManager, has_resumable_checkpoint
from rlaifv_tpu_torch.core.config import Config
from rlaifv_tpu_torch.train.train_step import (
    DPOHparams,
    LlavaDPOAdapter,
    MultiSteps,
    batch_to_device,
    derive_shared_prefix_len,
    make_dpo_train_step,
    make_lora_dpo_train_step,
    make_optimizer,
    named_tensors,
    validate_shared_prefix,
)


class MetricLogger:
    """JSONL metrics sink (stdout + file); wandb-compatible dict shape."""

    def __init__(self, output_dir: str, also_print: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.also_print = also_print
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict):
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                pass
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.also_print:
            brief = {k: round(v, 4) for k, v in rec.items()
                     if k in ("step", "loss", "rewards_train/accuracies",
                              "grad_norm")}
            print(f"[train] {brief}", flush=True)


def precompute_head(training, hidden_size: int, dtype: torch.dtype) -> str:
    """The reference-logp precompute's head, train.py's rule: lm_head_impl,
    with "auto" read as "fused" at hidden_size >= 2048 and "xla" below. No
    compact_len reaches the precompute, so "auto" never picks the compact
    head there (an explicit "compact" raises, as in the JAX package). The
    fused head's kernels take bf16 only, so "auto" also reads "xla" for a
    model of another dtype (the JAX package runs fp32 through its TPU
    kernels; ROADMAP.md section 3)."""
    head = getattr(training, "lm_head_impl", "auto")
    if head == "auto":
        head = "fused" if hidden_size >= 2048 and dtype == torch.bfloat16 else "xla"
    return head


def resolve_head(training, hidden_size: int, dtype: torch.dtype) -> str:
    """The train step's head, the JAX trainer's rule: "auto" is "compact"
    when compact_len > 0, else `precompute_head`'s choice."""
    if getattr(training, "lm_head_impl", "auto") == "auto" and \
            int(getattr(training, "compact_len", 0)) > 0:
        return "compact"
    return precompute_head(training, hidden_size, dtype)


class DPOTrainer:
    def __init__(self, config: Config, model, dataset, collator, *,
                 adapter=None, lora=None, lora_alpha: float = 16.0):
        """model: a LlavaForCausalLM or OmniLMMForCausalLM (trained in
        place, on its own device; with `lora`, the frozen base, quantised or
        not); adapter: its family's (`FamilySpec.adapter`, LLaVA's by
        default); dataset: indexable -> (rej_dict, win_dict); collator:
        DPOCollator; lora: an adapter tree (train/lora.py) on the model's
        device, trained in place."""
        t = config.training
        self.config = config
        self.model = model
        self.dataset = dataset
        self.collator = collator
        self.adapter = adapter or LlavaDPOAdapter(model)
        self.device = model.device
        self.lora, self._lora_alpha = lora, lora_alpha
        self.use_lora = lora is not None
        hp = DPOHparams(
            beta=t.dpo_beta,
            dpo_use_average=t.dpo_use_average,
            dpo_token_weighted=t.dpo_token_weighted,
            sft_weight=t.sft_weight,
            dpo_weight=t.dpo_weight,
            lm_head_impl=resolve_head(t, model.cfg.llm.hidden_size, model.cfg.llm.dtype),
            compact_len=int(t.compact_len),
            shared_prefix_len=int(t.shared_prefix_len),
            shared_suffix_len=int(t.shared_suffix_len),
        )
        # -1 = derive P from data; remembered so that a later batch with a
        # shorter common prefix re-derives instead of failing (an explicit
        # P keeps the hard-fail contract)
        self._auto_prefix = hp.shared_prefix_len < 0
        self._num_patches = getattr(model.cfg, "num_image_tokens", 0) or 0
        self.optimizer = make_optimizer(
            lora if self.use_lora else model, t.learning_rate, total_steps=t.max_steps,
            warmup_ratio=t.warmup_ratio, weight_decay=t.weight_decay,
            max_grad_norm=t.max_grad_norm, schedule=t.lr_schedule,
        )
        self.grad_accum = max(int(t.gradient_accumulation), 1)
        if self.grad_accum > 1:
            # k micro-batches average into one update; max_steps counts
            # updates (the schedule sees applies), as with optax.MultiSteps
            self.optimizer = MultiSteps(self.optimizer, self.grad_accum)
        self.step = 0  # micro-steps taken, the JAX state.step
        self._build_step(hp)

        self.logger = MetricLogger(t.output_dir)
        self.ckpt = CheckpointManager(os.path.join(t.output_dir, "checkpoints"),
                                      t.save_total_limit)
        self.start_step = 0
        if has_resumable_checkpoint(self.ckpt.directory):
            restored = self.ckpt.restore()
            with torch.no_grad():
                for name, p in self._train_tensors().items():
                    p.copy_(restored["params"][name])
            self.optimizer.load_state_dict(restored["opt_state"])
            self.step = self.start_step = int(restored["step"])
            print(f"[train] resumed from step {self.start_step}", flush=True)

    def _train_tensors(self) -> Dict:
        """What trains: the adapters (by flax path) or the model's state."""
        if self.use_lora:
            return {n: t.detach() for n, t in named_tensors(self.lora)}
        return self.model.state_dict()

    def _state_tree(self) -> Dict:
        return {"step": self.step, "params": self._train_tensors(),
                "opt_state": self.optimizer.state_dict()}

    def _batches(self, seed: int) -> Iterator:
        n_pairs = self.config.training.per_device_batch_pairs
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.dataset))
        pos = 0
        while True:
            if pos + n_pairs > len(order):
                order = rng.permutation(len(self.dataset))
                pos = 0
            idx = order[pos:pos + n_pairs]
            pos += n_pairs
            yield self.collator([self.dataset[int(i)] for i in idx])

    def _check_overflow(self, step: int, overflow) -> None:
        """Hard-fail when the compact head dropped loss tokens."""
        n = int(overflow)
        if n > 0:
            raise ValueError(
                f"compact head overflow at step {step}: a row has "
                f"{self.hp.compact_len + n} loss positions but compact_len="
                f"{self.hp.compact_len}; raise training.compact_len or set "
                f"training.lm_head_impl='xla'"
            )

    def _build_step(self, hp: DPOHparams) -> None:
        self.hp = hp
        if self.use_lora:
            self._step = make_lora_dpo_train_step(self.adapter, self.optimizer, hp,
                                                  self.lora, lora_alpha=self._lora_alpha)
        else:
            self._step = make_dpo_train_step(self.adapter, self.optimizer, hp)

    def _set_prefix(self, step: int, batch) -> None:
        """Derive P from `batch` and rebuild the step (0 = plain path)."""
        P = derive_shared_prefix_len(batch, self._num_patches)
        self.logger.log(step, {"derived_shared_prefix_len": P})
        self._build_step(dataclasses.replace(self.hp, shared_prefix_len=P))

    def _check_prefix(self, step: int, batch) -> None:
        """Exactness guard for the paired forward; in derived-P mode a batch
        with a shorter common prefix re-derives P instead of failing."""
        try:
            validate_shared_prefix(batch, self.hp.shared_prefix_len,
                                   self._num_patches,
                                   suffix_len=self.hp.shared_suffix_len)
        except ValueError:
            if not self._auto_prefix:
                raise  # explicit config P: wrong data
            old = self.hp.shared_prefix_len
            self._set_prefix(step, batch)
            P = self.hp.shared_prefix_len
            warnings.warn(
                f"batch at step {step} breaks the derived shared prefix P={old}; "
                f"re-deriving P={P} " + ("(plain path)" if P == 0 else "(rebuilt)"),
                stacklevel=3,
            )
            if P > 0:
                validate_shared_prefix(batch, P, self._num_patches,
                                       suffix_len=self.hp.shared_suffix_len)

    def train(self) -> int:
        """Run to max_steps optimizer updates; returns the micro-step count."""
        t = self.config.training
        batches = prefetch_iterator(self._batches(t.seed), depth=2)
        step = self.start_step
        t0 = time.time()
        micro_total = t.max_steps * self.grad_accum
        self.model.train()
        for batch in batches:
            if step >= micro_total:
                break
            if self.hp.shared_prefix_len < 0:
                self._set_prefix(step, batch)
            if self.hp.shared_prefix_len > 0:
                self._check_prefix(step, batch)
            metrics = self._step(batch_to_device(batch, self.device))
            step += 1
            self.step += 1
            if "compact_overflow" in metrics:
                self._check_overflow(step, metrics["compact_overflow"])
            if step % t.logging_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(m["loss"]):
                    self.logger.log(step, m)
                    raise FloatingPointError(f"non-finite loss at step {step}: {m['loss']}")
                m["steps_per_sec"] = t.logging_steps / max(time.time() - t0, 1e-9)
                t0 = time.time()
                self.logger.log(step, m)
            if step % t.save_steps == 0:
                self.ckpt.save(step, self._state_tree())
        if self.ckpt.latest_step() != step:
            self.ckpt.save(step, self._state_tree())
        return self.step
