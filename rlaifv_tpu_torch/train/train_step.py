"""DPO train step in PyTorch: policy (win||rej) logps -> DPO loss against
cached reference logps -> gradients -> AdamW update.

Counterpart of rlaifv_tpu/train/train_step.py, on one device or over a
mesh (parallel/sharding.py; a rank trains on its pairs, see
`make_dpo_train_step`): the same
`DPOHparams`, the same host-side shared-prefix helpers, the same forward
variants (plain concatenated, shared-prefix paired, KTO, text-only; the
"xla", "compact" and "fused" heads) and an optimizer that reproduces optax's
`chain(clip_by_global_norm, adamw(mask=wd_mask))` update for update.

The vision tower runs once per image (B) and its features are tiled over
the 2B rows. Parameters live in the `nn.Module`; the functions take the
model (through `LlavaDPOAdapter`, or `OmnilmmDPOAdapter` for OmniLMM-12B)
instead of a parameter tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rlaifv_tpu_torch.constants import IGNORE_INDEX
from rlaifv_tpu_torch.models.convert import flax_leaf_names
from rlaifv_tpu_torch.models.llava import splice_image_features
from rlaifv_tpu_torch.parallel.sharding import (
    global_norm,
    local_shard,
    mesh_plan,
    run_as_forward,
)
from rlaifv_tpu_torch.train.dpo import (
    compute_weighted_logp,
    dpo_loss,
    dpo_metrics,
    get_batch_logps,
    get_batch_logps_compact,
    get_batch_logps_from_hidden,
)
from rlaifv_tpu_torch.train.lora import _flatten as named_tensors  # [(path, leaf)]
from rlaifv_tpu_torch.train.paired_forward import merge_paired_hidden, paired_hidden


@dataclasses.dataclass(frozen=True)
class DPOHparams:
    beta: float = 0.1
    dpo_use_average: bool = False
    dpo_token_weighted: bool = False
    sft_weight: float = 0.0
    dpo_weight: float = 1.0
    logp_shift: bool = True  # False for the MiniCPM label alignment
    # "xla": logits then the logp math; "compact": the head only on the
    # <= compact_len loss positions; "fused": the fused head kernels
    # (ops/fused_head.py), no (2B, L, V) logits
    lm_head_impl: str = "xla"
    compact_len: int = 0
    # > 0: win/rej share the first shared_prefix_len tokens, and the prefix
    # runs once per pair (train/paired_forward.py), padded to a multiple of
    # 128 (masked rows); 0: the plain concatenated forward
    shared_prefix_len: int = 0
    # with shared_prefix_len > 0: carry only this many suffix tokens (0 =
    # all L - P); exact while no supervised label lies past P + W
    shared_suffix_len: int = 0


def derive_shared_prefix_len(batch, num_patches: int = 0) -> int:
    """Safe static shared_prefix_len from one batch (host, numpy): the
    image-end rule P = max(image_start) + num_patches for multimodal
    batches, else this batch's minimum pair-common prefix; 0 when no paired
    speedup is expressible. (A copy of the JAX package's helper, whose
    module imports jax.)"""
    ids = np.asarray(batch["input_ids"])
    B, L = ids.shape[0] // 2, ids.shape[1]
    eq = ids[:B] == ids[B:]
    full = eq.all(axis=1)
    common = int(np.where(full, L, np.argmin(eq, axis=1)).min())
    if num_patches and "images" in batch:
        starts = np.asarray(batch["image_starts"])
        real = starts[starts >= 0]
        if real.size:
            P = int(real.max()) + num_patches
            return P if P <= common and 0 < P < L else 0
    return common if 0 < common < L else 0


def validate_shared_prefix(batch, P: int, num_patches: int = 0,
                           suffix_len: int = 0) -> None:
    """Host-side guard for the paired forward (numpy): raise ValueError
    unless (a) win row i and rej row i agree on [0, P), (b) every image
    span ends at or before P and (c) with suffix trimming no supervised
    label lies at or past P + suffix_len. (A copy of the JAX helper.)"""
    ids = np.asarray(batch["input_ids"])
    B = ids.shape[0] // 2
    diverge = (ids[:B, :P] != ids[B:, :P]).any(axis=1)
    if diverge.any():
        i = int(np.argmax(diverge))
        j = int(np.argmax(ids[i, :P] != ids[B + i, :P]))
        raise ValueError(
            f"shared_prefix_len={P} but pair {i} diverges at token {j}; "
            f"lower training.shared_prefix_len (or set 0 for the plain path)"
        )
    if num_patches and "images" in batch:
        starts = np.asarray(batch["image_starts"])
        bad = (starts >= 0) & (starts + num_patches > P)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"shared_prefix_len={P} cuts the image span of row {i} "
                f"(start {int(starts[i])} + {num_patches} patches > {P})"
            )
    if suffix_len > 0 and "labels" in batch:
        labels = np.asarray(batch["labels"])
        if labels.shape[1] > P + suffix_len:
            tail = labels[:, P + suffix_len:] != IGNORE_INDEX
            if tail.any():
                rows = np.where(tail.any(axis=1))[0]
                last = int(np.max(np.where(tail[rows[0]])[0])) + P + suffix_len
                raise ValueError(
                    f"shared_suffix_len={suffix_len} drops supervised labels "
                    f"(row {int(rows[0])} has a label at {last} >= "
                    f"P+W={P + suffix_len}); raise training.shared_suffix_len"
                )


def batch_to_device(batch: Dict, device) -> Dict:
    """Collator output (numpy) -> tensors on `device`. Token ids and labels
    become int64 (gather indices); image_starts stay host ints (the splice
    reads them on the host); the scalar beta is dropped (DPOHparams.beta
    is what the loss reads)."""
    out = {}
    for key, val in batch.items():
        if key == "image_starts":
            out[key] = np.asarray(val)
        elif key != "beta":
            t = torch.from_numpy(np.asarray(val))
            if key in ("input_ids", "labels", "win_labels", "rej_labels"):
                t = t.long()
            out[key] = t.to(device)
    return out


class LlavaDPOAdapter:
    """The train step's view of a LlavaForCausalLM."""

    def __init__(self, module):
        self.module = module

    def encode_images_fn(self, images):
        return self.module.encode_images(images)

    def forward_with_features(self, input_ids, feats, starts, mask):
        return self.module.forward_with_features(input_ids, feats, starts, mask)

    def forward_text(self, input_ids, mask):
        return self.module.forward_text(input_ids, mask)

    def hidden_with_features(self, input_ids, feats, starts, mask):
        return self.module.hidden_with_features(input_ids, feats, starts, mask)

    def hidden_text(self, input_ids, mask):
        return self.module.hidden_text(input_ids, mask)

    def lm_head_weight(self) -> torch.Tensor:
        """(V, H) head weight (tied embeddings when there is no head); over
        a tp mesh gathered whole from the vocabulary slices, differentiably
        (the fused and compact heads take the whole matrix)."""
        llm = self.module.llm
        head = llm.lm_head if llm.lm_head is not None else llm.model.tok_embed
        tp = getattr(head, "tp", None)
        return head.weight if tp is None else tp.gather_weight(head.weight)

    def embed_ids(self, input_ids):
        return self.module.llm.embed(input_ids.clamp(min=0))

    def logits_from_hidden(self, hidden):
        return self.module.llm.logits(hidden)

    def splice_features(self, embeds, feats, starts):
        return splice_image_features(embeds, feats, starts)

    def paired_hidden(self, prefix_embeds, suffix_embeds, prefix_mask,
                      suffix_mask, suffix_pos_start=None):
        return paired_hidden(self.module.llm.model, prefix_embeds, suffix_embeds,
                             prefix_mask, suffix_mask, suffix_pos_start)


class OmnilmmDPOAdapter(LlavaDPOAdapter):
    """The train step's view of an OmniLMMForCausalLM. Its prompt already
    holds the literal <im_start><im_patch>*N<im_end> tokens, and the
    resampled EVA02 features overwrite that span (`splice_image_features`
    with start = the first <im_patch>), so the LLaVA methods serve it
    unchanged: `encode_images` runs the tower and the resampler,
    `hidden_with_features` / `forward_text` the Mistral LM, whose untied
    `llm.lm_head` is the head, and `paired_hidden` runs over `llm.model`.
    The class names the family at the call sites."""


def paired_masks(attention_mask: torch.Tensor, P: int, W: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key masks of the paired forward from the (2B, L) batch mask: prefix
    (B, Pa), the real prefix padded with masked rows to Pa, a multiple of
    128; suffix (2B, Pa + W), that prefix tiled over win and rej ahead of
    each row's own suffix [P, P + W)."""
    B = attention_mask.shape[0] // 2
    pmask = F.pad(attention_mask[:B, :P], (0, -(-P // 128) * 128 - P))
    smask = torch.cat([torch.cat([pmask, pmask]), attention_mask[:, P:P + W]], dim=1)
    return pmask, smask


def dpo_forward_logps(model: LlavaDPOAdapter, batch: Dict, hp: DPOHparams
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Policy win/rej sequence logps from one concatenated (or paired)
    forward. batch (win rows then rej rows): input_ids/labels/
    attention_mask (2B, L) tensors, images (B, S, S, 3) or absent,
    image_starts (2B,) host ints, win/rej_token_weight (B, L-1) when
    token-weighted."""
    input_ids, labels = batch["input_ids"], batch["labels"]
    B = input_ids.shape[0] // 2
    fused = hp.lm_head_impl == "fused"
    compact = hp.lm_head_impl == "compact"
    if compact and hp.compact_len <= 0:
        raise ValueError("lm_head_impl='compact' requires compact_len > 0")
    use_hidden = fused or compact
    fwd_feats = model.hidden_with_features if use_hidden else model.forward_with_features
    fwd_text = model.hidden_text if use_hidden else model.forward_text

    images = batch.get("images")
    if hp.shared_prefix_len > 0 and "win_images" not in batch:
        P = hp.shared_prefix_len
        L = input_ids.shape[1]
        if not 0 < P < L:
            raise ValueError(f"shared_prefix_len {P} outside (0, {L})")
        W = hp.shared_suffix_len or (L - P)
        if not 0 < W <= L - P:
            raise ValueError(f"shared_suffix_len {W} outside (0, {L - P}] at P={P}")
        pmask, smask = paired_masks(batch["attention_mask"], P, W)
        prefix_embeds = model.embed_ids(F.pad(input_ids[:B, :P], (0, pmask.shape[1] - P)))
        if images is not None:
            feats = model.encode_images_fn(images)
            prefix_embeds = model.splice_features(prefix_embeds, feats,
                                                  batch["image_starts"][:B])
        suffix_embeds = model.embed_ids(input_ids[:, P:P + W])
        hp_hidden, hs_hidden = model.paired_hidden(
            prefix_embeds, suffix_embeds, pmask, smask, suffix_pos_start=P)
        out = merge_paired_hidden(hp_hidden, hs_hidden, real_prefix_len=P)
        if not use_hidden:
            out = model.logits_from_hidden(out)
        if W < L - P:
            labels = labels[:, :P + W]
    elif "win_images" in batch:
        # KTO: win/rej rows carry their own images (the prefix is not shared)
        both = torch.cat([batch["win_images"], batch["rej_images"]])
        out = fwd_feats(input_ids, model.encode_images_fn(both),
                        batch["image_starts"], batch["attention_mask"])
    elif images is not None:
        feats = model.encode_images_fn(images)  # once per pair
        out = fwd_feats(input_ids, torch.cat([feats, feats]),
                        batch["image_starts"], batch["attention_mask"])
    else:
        out = fwd_text(input_ids, batch["attention_mask"])

    aux: Dict = {}
    if compact:
        lp = get_batch_logps_compact(out, model.lm_head_weight(), labels,
                                     n_pos=hp.compact_len, shift=hp.logp_shift)
        aux["compact_overflow"] = lp.overflow.max()
    elif fused:
        lp = get_batch_logps_from_hidden(out, model.lm_head_weight(), labels,
                                         shift=hp.logp_shift)
    else:
        lp = get_batch_logps(out, labels, shift=hp.logp_shift)

    if hp.dpo_token_weighted:
        token_weight = torch.cat([batch["win_token_weight"],
                                  batch["rej_token_weight"]])[:, :labels.shape[1] - 1]
        if compact:
            ctw = torch.gather(token_weight, -1, lp.pos) * lp.mask
            seq_logp = (lp.per_token * ctw).sum(-1)
            if hp.dpo_use_average:
                seq_logp = seq_logp / ctw.sum(-1)
        else:
            seq_logp = compute_weighted_logp(lp.per_token, labels, token_weight,
                                             hp.dpo_use_average)
    else:
        seq_logp = lp.mean if hp.dpo_use_average else lp.sum
    aux["per_token"] = lp.per_token
    return seq_logp[:B], seq_logp[B:], aux


def dpo_loss_from_batch(model: LlavaDPOAdapter, batch: Dict, hp: DPOHparams
                        ) -> Tuple[torch.Tensor, Dict]:
    policy_win_logp, policy_rej_logp, aux = dpo_forward_logps(model, batch, hp)
    if hp.dpo_token_weighted:
        ref_win_logp = compute_weighted_logp(
            batch["ref_win_per_token_logp"], batch["win_labels"],
            batch["win_token_weight"], hp.dpo_use_average)
        ref_rej_logp = compute_weighted_logp(
            batch["ref_rej_per_token_logp"], batch["rej_labels"],
            batch["rej_token_weight"], hp.dpo_use_average)
    elif hp.dpo_use_average:
        ref_win_logp, ref_rej_logp = batch["ref_win_avg_logp"], batch["ref_rej_avg_logp"]
    else:
        ref_win_logp, ref_rej_logp = batch["ref_win_logp"], batch["ref_rej_logp"]

    losses, chosen_rewards, rejected_rewards = dpo_loss(
        policy_win_logp, policy_rej_logp, ref_win_logp, ref_rej_logp, hp.beta)
    loss = hp.dpo_weight * losses.mean() - hp.sft_weight * policy_win_logp.mean()
    metrics = dpo_metrics("train", chosen_rewards, rejected_rewards,
                          policy_win_logp, policy_rej_logp, ref_win_logp,
                          ref_rej_logp)
    metrics["loss"] = loss.detach()
    if "compact_overflow" in aux:
        metrics["compact_overflow"] = aux["compact_overflow"]
    return loss, metrics


# ------------------------------------------------------------- optimizer


def lr_schedule(learning_rate: float, *, total_steps: int,
                warmup_ratio: float = 0.05,
                schedule: str = "cosine") -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), 0)` ("cosine") or linear warmup then constant
    ("constant"), with warmup = int(total_steps * warmup_ratio). The count
    is the number of updates already applied: with warmup > 0 the first
    update gets lr 0, with warmup = 0 it gets the peak."""
    warmup = int(total_steps * warmup_ratio)
    decay_steps = max(total_steps, warmup + 1) - warmup
    if schedule not in ("cosine", "constant"):
        raise ValueError(schedule)

    def lr(count: int) -> float:
        if count < warmup:  # optax's linear_schedule(0, lr, warmup)
            return learning_rate * count / warmup
        if schedule == "constant":
            return learning_rate
        c = min(count - warmup, decay_steps)
        return learning_rate * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return lr


class AdamW:
    """optax `chain(clip_by_global_norm(max_grad_norm), adamw(lr, b1, b2,
    eps, weight_decay, mask))` over a model's parameters, step for step:

    - clip: g * (max_norm / norm), computed as (g / norm) * max_norm, only
      when norm >= max_norm (no epsilon);
    - moments in the parameter dtype, mu = (1 - b1) g + b1 mu and
      nu = (1 - b2) g^2 + b2 nu; bias correction by 1 - b^count (count
      after the increment); u = mu_hat / (sqrt(nu_hat) + eps);
    - decoupled decay u + wd * p where the mask says so, then u * -lr(count
      before the increment), then p + u.

    The update runs one parameter at a time (no foreach over the whole
    model: a 7B model's temporaries would double the moments' memory), on
    the shard this rank holds when the model is sharded (the update is
    elementwise; the moments are shaped like the parameters' DTensors).
    A parameter whose .grad is None counts as a zero gradient, as every
    leaf has a gradient in JAX. The global norm sums in fp32 (optax sums
    in the gradient dtype); over a sharded model (`plan`, the model's
    MeshPlan) it is the norm over the whole mesh.
    """

    def __init__(self, named_params, lr: Callable[[int], float], *,
                 decay: Dict[str, bool], b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=1.0, plan=None):
        self.named_params = list(named_params)
        self.plan = plan
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.decay = decay
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.named_params}
        self.nu = {n: torch.zeros_like(p) for n, p in self.named_params}

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for _, p in self.named_params]

    @torch.no_grad()
    def step(self, grads=None, grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = self.grads() if grads is None else grads
        if grad_norm is None:
            grad_norm = global_norm(zip((n for n, _ in self.named_params), grads),
                                    self.plan)
        norm = float(grad_norm)
        grads = [local_shard(g) for g in grads]
        count = self.count + 1
        # optax evaluates b ** count in fp32
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        step_size = -self.lr(self.count)
        for (name, p), g in zip(self.named_params, grads):
            p, mu_old, nu_old = local_shard(p), local_shard(self.mu[name]), local_shard(self.nu[name])
            if not norm < self.max_grad_norm:
                g = (g / torch.tensor(norm, dtype=g.dtype, device=g.device)) \
                    * self.max_grad_norm
            mu = (1 - self.b1) * g + self.b1 * mu_old
            nu = (1 - self.b2) * g ** 2 + self.b2 * nu_old
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decay[name]:
                u = u + self.weight_decay * p
            p.copy_(p + u * step_size)
            mu_old.copy_(mu)
            nu_old.copy_(nu)
        self.count = count

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, t in getattr(self, key).items():
                local_shard(t).copy_(state[key][name])


class MultiSteps:
    """optax.MultiSteps(opt, every_k_schedule=k): each call folds the
    gradients into a running mean, acc + (g - acc) / (n + 1); the k-th call
    applies the inner optimizer to the mean and resets it (clipped by the
    mean's norm, over the whole mesh on a sharded model)."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in inner.named_params}

    @torch.no_grad()
    def step(self, grads=None, grad_norm=None) -> None:
        del grad_norm  # the inner step clips by the norm of the mean
        grads = self.inner.grads() if grads is None else grads
        for (name, _), g in zip(self.inner.named_params, grads):
            acc, g = local_shard(self.acc[name]), local_shard(g)
            acc.copy_(acc + (g - acc) / (self.mini_step + 1))
        if self.mini_step == self.every_k - 1:
            self.inner.step([self.acc[n] for n, _ in self.inner.named_params])
            for acc in self.acc.values():
                acc.zero_()
            self.mini_step = 0
        else:
            self.mini_step += 1

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for name, t in self.acc.items():
            local_shard(t).copy_(state["acc"][name])


def weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """The JAX wd_mask: no decay on leaves whose flax name is `bias` or
    `scale` (HF Trainer's convention), read through the converter's name
    map. Norm scales are `.weight` in torch and are not decayed; CLIP's
    cls_token and pos_embed are."""
    return {name: leaf not in ("bias", "scale")
            for name, leaf in flax_leaf_names(model).items()}


def make_optimizer(params, learning_rate: float, *,
                   total_steps: int, warmup_ratio: float = 0.05,
                   weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   schedule: str = "cosine") -> AdamW:
    """The JAX make_optimizer's update over every parameter of a model, or
    over the tensors of a LoRA adapter tree (decayed, as wd_mask decays
    every leaf not named `bias` or `scale`). A model sharded by
    parallel/sharding.py clips by the norm over its whole mesh; an adapter
    tree is whole on every rank, its gradients reduced before the step."""
    plan = None
    if isinstance(params, torch.nn.Module):
        named, decay = list(params.named_parameters()), weight_decay_mask(params)
        plan = mesh_plan(params)
    else:
        named = named_tensors(params)
        decay = {n: n.rsplit("/", 1)[-1] not in ("bias", "scale") for n, _ in named}
    return AdamW(
        named,
        lr_schedule(learning_rate, total_steps=total_steps,
                    warmup_ratio=warmup_ratio, schedule=schedule),
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm, decay=decay, plan=plan,
    )


def make_dpo_train_step(model: LlavaDPOAdapter, optimizer, hp: DPOHparams
                        ) -> Callable[[Dict], Dict]:
    """train_step(batch) -> metrics: zeroed grads, loss, backward, the
    update; metrics["grad_norm"] is the global norm of this batch's grads.

    On a model sharded by parallel/sharding.py the batch is this rank's
    pairs: FSDP averages the gradients over the data ranks, the norm is
    taken over the whole mesh, and the metrics are the global batch's
    means."""

    def train_step(batch: Dict) -> Dict:
        module = model.module
        plan = mesh_plan(module)
        # sharded: FSDP hands each shard its reduce-scatter output as the
        # gradient; into an existing gradient it would add it, holding a
        # second copy of every shard until the backward ends
        module.zero_grad(set_to_none=plan is not None)
        loss, metrics = run_as_forward(module, lambda: dpo_loss_from_batch(model, batch, hp))
        loss.backward()
        named = [(n, p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in module.named_parameters()]
        if plan is not None:
            metrics = plan.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(named, plan)
        optimizer.step([g for _, g in named], metrics["grad_norm"])
        return metrics

    return train_step


def make_lora_dpo_train_step(model: LlavaDPOAdapter, optimizer, hp: DPOHparams,
                             lora, *, lora_alpha: float = 16.0
                             ) -> Callable[[Dict], Dict]:
    """LoRA variant (the JAX make_lora_dpo_train_step): the adapter tree
    `lora` trains, through `optimizer` (made over that tree), and the base
    is frozen: its parameters stop requiring grad here (the JAX
    stop_gradient) and int8 buffers never do. Each step attaches
    lora_scaled(lora) to the projections for the forward and the backward
    (a remat recompute reads them), then detaches them before the update;
    metrics["grad_norm"] is the adapters' global norm. On a sharded base
    (parallel/sharding.py) the adapters stay whole on every rank, and their
    gradients are reduced over the mesh before the norm and the update."""
    from rlaifv_tpu_torch.train.lora import attach_lora, lora_scaled

    model.module.requires_grad_(False)
    leaves = [t for _, t in named_tensors(lora)]
    for t in leaves:
        t.requires_grad_(True)

    def train_step(batch: Dict) -> Dict:
        module = model.module
        for t in leaves:
            t.grad = None
        attach_lora(module, lora_scaled(lora, alpha=lora_alpha))
        try:
            loss, metrics = run_as_forward(module,
                                           lambda: dpo_loss_from_batch(model, batch, hp))
            loss.backward()
        finally:
            attach_lora(module, None)
        named = [(n, t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in named_tensors(lora)]
        grads = [g for _, g in named]
        plan = mesh_plan(module)
        if plan is not None:
            plan.reduce_lora_grads(named)
            metrics = plan.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(named)  # the adapters: whole on every rank
        optimizer.step(grads, metrics["grad_norm"])
        return metrics

    return train_step
