"""Logits processing for the decode loop.

Counterpart of rlaifv_tpu/genai/sampling.py with the same presets and
transforms (temperature, top-k, top-p as sort + mask, HF repetition
penalty). Draws use an explicit `torch.Generator`; JAX and torch give
different random bits for one seed, so the two packages agree on the
filtered distribution (`filtered_logits`), not on sampled tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e10


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    do_sample: bool = True  # False = greedy

    @staticmethod
    def greedy() -> "SamplingParams":
        return SamplingParams(do_sample=False)

    @staticmethod
    def chat_12b() -> "SamplingParams":  # ref chat.py:103-111
        return SamplingParams(0.6, 30, 0.9, 1.1, True)

    @staticmethod
    def diverse_gen() -> "SamplingParams":  # ref llava15_diverse_gen.sh:30
        return SamplingParams(temperature=0.7, do_sample=True)


def apply_repetition_penalty(logits: torch.Tensor, token_seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF semantics: seen tokens' logits are divided by the penalty if
    positive, multiplied if negative. token_seen: (B, V) bool/int."""
    if penalty == 1.0:
        return logits
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_seen.bool(), scaled, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the first)
    keep = torch.roll(cum < p, 1, dims=-1)
    keep[..., 0] = True
    kth = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < kth, NEG_INF, logits)


def filtered_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature + top-k + top-p filtered fp32 logits: softmax of this is
    the distribution `sample_token` draws from."""
    logits = logits.float()
    if params.temperature != 1.0:
        logits = logits / max(params.temperature, 1e-6)
    logits = apply_top_k(logits, params.top_k)
    return apply_top_p(logits, params.top_p)


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 params: SamplingParams,
                 token_seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) next token ids (int64)."""
    logits = logits.float()
    if token_seen is not None:
        logits = apply_repetition_penalty(logits, token_seen,
                                          params.repetition_penalty)
    if not params.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def yesno_probs(logits: torch.Tensor, yes_ids, no_ids) -> dict:
    """First-token softmax mass on {yes,Yes} vs {no,No} ids."""
    probs = torch.softmax(logits.float(), dim=-1)
    return {"yes": sum(probs[..., i] for i in yes_ids),
            "no": sum(probs[..., i] for i in no_ids)}
