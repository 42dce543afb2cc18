"""DPO loss and batch log-probability math in PyTorch.

Counterpart of rlaifv_tpu/train/dpo.py, function for function: the
logsumexp and the target gather run in fp32 whatever the activation dtype,
and `.detach()` stands where JAX uses `stop_gradient`. Everything is
mask-based: the -100 ignore positions are masked, never dropped.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rlaifv_tpu_torch.constants import IGNORE_INDEX


class BatchLogps(NamedTuple):
    per_token: torch.Tensor  # (B, L-1) log p of each target token (0 at masked)
    sum: torch.Tensor  # (B,) masked sum
    mean: torch.Tensor  # (B,) masked mean


def _targets(labels: torch.Tensor, shift: bool):
    tgt = labels[:, 1:] if shift else labels[:, :-1]
    mask = tgt != IGNORE_INDEX
    return torch.where(mask, tgt, 0).long(), mask


def get_batch_logps(logits: torch.Tensor, labels: torch.Tensor, *,
                    shift: bool = True) -> BatchLogps:
    """Log-probabilities of `labels` under `logits`, ignoring -100 positions.

    shift=True: position t's logits predict labels[t+1]; shift=False: the
    MiniCPM alignment, labels[:, :-1] scored by logits[:, :-1]. per_token
    has length L-1 in both modes. logp = logit[y] - logsumexp(logits), in
    fp32, without a (B, L, V) log-prob tensor.
    """
    safe_tgt, mask = _targets(labels, shift)
    lgt = logits[:, :-1, :]
    lse = torch.logsumexp(lgt.float(), dim=-1)
    tgt_logit = torch.gather(lgt, -1, safe_tgt[..., None])[..., 0]
    per_token = (tgt_logit.float() - lse) * mask
    total = per_token.sum(-1)
    return BatchLogps(per_token, total, total / mask.sum(-1))


def get_batch_logps_from_hidden(hidden: torch.Tensor, lm_head_weight: torch.Tensor,
                                labels: torch.Tensor, *,
                                shift: bool = True) -> BatchLogps:
    """get_batch_logps from the pre-head hidden states through the fused
    head (ops/fused_head.py; the CUDA kernels on the card): the (B, L, V)
    logits are never materialised. lm_head_weight is the torch (V, H)
    weight. Same contract and outputs as get_batch_logps(logits, labels)."""
    from rlaifv_tpu_torch.ops.fused_head import fused_target_logp

    safe_tgt, mask = _targets(labels, shift)
    per_token = fused_target_logp(hidden[:, :-1, :], lm_head_weight, safe_tgt) * mask
    total = per_token.sum(-1)
    return BatchLogps(per_token, total, total / mask.sum(-1))


class CompactLogps(NamedTuple):
    per_token: torch.Tensor  # (B, A) log p of each valid target (0 at masked)
    pos: torch.Tensor  # (B, A) indices into the L-1 target axis
    mask: torch.Tensor  # (B, A) bool: slot holds a real (non-ignored) target
    sum: torch.Tensor  # (B,) masked sum
    mean: torch.Tensor  # (B,) masked mean
    overflow: torch.Tensor  # (B,) valid targets that did NOT fit in A (want 0)


def get_batch_logps_compact(hidden: torch.Tensor, lm_head_weight: torch.Tensor,
                            labels: torch.Tensor, *, n_pos: int,
                            shift: bool = True) -> CompactLogps:
    """get_batch_logps computed only at the <= n_pos label positions that
    carry loss: the head runs on the gathered hidden rows alone.
    lm_head_weight is the torch (V, H) weight. Rows with more valid targets
    than n_pos report the excess in `overflow`."""
    tgt = labels[:, 1:] if shift else labels[:, :-1]
    hid = hidden[:, :-1, :]
    n_pos = min(int(n_pos), tgt.shape[1])
    mask = tgt != IGNORE_INDEX
    # a stable sort on ~mask lists the valid positions first, in order
    pos = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[:, :n_pos]
    cmask = torch.gather(mask, -1, pos)
    ctgt = torch.where(cmask, torch.gather(tgt, -1, pos), 0).long()
    chid = torch.gather(hid, 1, pos[..., None].expand(-1, -1, hid.shape[-1]))
    logits = chid @ lm_head_weight.to(chid.dtype).T
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt_logit = torch.gather(logits, -1, ctgt[..., None])[..., 0]
    per_token = (tgt_logit.float() - lse) * cmask
    total = per_token.sum(-1)
    overflow = torch.clamp(mask.sum(-1) - n_pos, min=0)
    return CompactLogps(per_token, pos, cmask, total, total / cmask.sum(-1), overflow)


def dpo_loss(policy_chosen_logps, policy_rejected_logps,
             reference_chosen_logps, reference_rejected_logps, beta,
             reference_free: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-example DPO losses and (detached) rewards:
    loss = -logsigmoid(beta * ((pi_w - pi_l) - (ref_w - ref_l)))."""
    pi_logratios = policy_chosen_logps - policy_rejected_logps
    ref_logratios = reference_chosen_logps - reference_rejected_logps
    if reference_free:
        ref_logratios = torch.zeros_like(ref_logratios)
    losses = -F.logsigmoid(beta * (pi_logratios - ref_logratios))
    chosen = (beta * (policy_chosen_logps - reference_chosen_logps)).detach()
    rejected = (beta * (policy_rejected_logps - reference_rejected_logps)).detach()
    return losses, chosen, rejected


def compute_weighted_logp(per_token_logp, labels, token_weight,
                          use_average: bool) -> torch.Tensor:
    """Token-weighted sequence logp (RLHF-V fine-grained weighting);
    per_token_logp (B, L-1) is aligned to labels[:, 1:]."""
    loss_mask = (labels[:, 1:] != IGNORE_INDEX).to(per_token_logp.dtype)
    weighted_mask = token_weight * loss_mask
    logp = (per_token_logp * weighted_mask).sum(-1)
    if use_average:
        return logp / weighted_mask.sum(-1)
    return logp


def dpo_metrics(task: str, chosen_rewards, rejected_rewards, policy_win_logp,
                policy_rej_logp, ref_win_logp, ref_rej_logp) -> dict:
    """Scalar metric dict with the reference's key names."""
    t = task
    m = {
        f"rewards_{t}/chosen": chosen_rewards.mean(),
        f"rewards_{t}/rejected": rejected_rewards.mean(),
        f"logps_{t}/chosen": policy_win_logp.mean(),
        f"logps_{t}/rejected": policy_rej_logp.mean(),
        f"logps_{t}/ref_chosen": ref_win_logp.mean(),
        f"logps_{t}/ref_rejected": ref_rej_logp.mean(),
        f"rewards_{t}/accuracies": (chosen_rewards > rejected_rewards).float().mean(),
    }
    m[f"rewards_{t}/margins"] = m[f"rewards_{t}/chosen"] - m[f"rewards_{t}/rejected"]
    return {k: v.detach() for k, v in m.items()}
