"""Shared-prefix paired forward for DPO training.

Counterpart of rlaifv_tpu/train/paired_forward.py. Win and rej rows of a
pair share the prompt (system + image + question) and differ only in the
answer suffix, so the prompt runs once per pair:

  prefix (B, Pa):  causal self-attention, one row per pair, at the array
                   length Pa (the caller pads the real prefix P to a
                   multiple of 128 with masked rows);
  suffix (2B, W):  queries attend over [tiled prefix KV ; own suffix KV]
                   with q_offset = Pa, the suffix's first ARRAY position.

RoPE takes REAL positions (prefix arange(Pa), suffix P + arange(W)) while
the attention masks run on array positions; mixing the two would shift
every suffix logp. Both functions run over the blocks and parameters of
the model's own `LlamaModel` (each block's `forward_paired`, which an FSDP
unit gathers its weights around): there is no second parameter tree.

With `cfg.remat` the checkpoint unit is the PAIR: one checkpoint per block
over (xp, xs), so the merged (2B, Pa+W) KV exists only inside it. Separate
checkpoints for the two streams would keep every layer's merged KV for
the backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rlaifv_tpu_torch.models.llama import LlamaModel, rope_cos_sin


def paired_hidden(
    model: LlamaModel,
    prefix_embeds: torch.Tensor,  # (B, Pa, D), vision already spliced
    suffix_embeds: torch.Tensor,  # (2B, W, D)
    prefix_mask: Optional[torch.Tensor] = None,  # (B, Pa) key validity
    suffix_mask: Optional[torch.Tensor] = None,  # (2B, Pa + W) key validity
    suffix_pos_start: Optional[int] = None,  # REAL position of suffix token 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paired forward over `model`'s blocks -> (prefix_hidden (B, Pa, D),
    suffix_hidden (2B, W, D)), both after ln_f. suffix_pos_start defaults
    to Pa (an unpadded prefix)."""
    cfg = model.cfg
    B, P, _ = prefix_embeds.shape
    S, W, _ = suffix_embeds.shape
    if S != 2 * B:
        raise ValueError(f"suffix rows ({S}) must be 2x prefix rows ({B})")
    pos0 = P if suffix_pos_start is None else int(suffix_pos_start)
    dev = prefix_embeds.device
    pos_p = torch.arange(P, device=dev)[None].expand(B, P)
    pos_s = (pos0 + torch.arange(W, device=dev))[None].expand(S, W)
    cosp, sinp = rope_cos_sin(pos_p, cfg.head_size, cfg.rope_theta, cfg.dtype)
    coss, sins = rope_cos_sin(pos_s, cfg.head_size, cfg.rope_theta, cfg.dtype)

    xp, xs = prefix_embeds, suffix_embeds
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.layers:
        args = (xp, xs, cosp, sinp, coss, sins, prefix_mask, suffix_mask)
        if remat:
            xp, xs = checkpoint(blk.forward_paired, *args, use_reentrant=False)
        else:
            xp, xs = blk.forward_paired(*args)
    return model.ln_f(xp), model.ln_f(xs)


def merge_paired_hidden(prefix_hidden: torch.Tensor, suffix_hidden: torch.Tensor,
                        real_prefix_len: int = 0) -> torch.Tensor:
    """(B, Pa, D) + (2B, W, D) -> the (2B, P + W, D) layout the logp code
    expects (win rows then rej rows, prefix tiled); real_prefix_len drops
    the alignment-pad prefix rows first."""
    if real_prefix_len and real_prefix_len != prefix_hidden.shape[1]:
        prefix_hidden = prefix_hidden[:, :real_prefix_len]
    tiled = torch.cat([prefix_hidden, prefix_hidden])
    return torch.cat([tiled, suffix_hidden], dim=1)
