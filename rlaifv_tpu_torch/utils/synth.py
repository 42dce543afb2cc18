"""Synthetic preference pairs for demos, smoke runs and tests (jax-free).

`synth_preference_pairs` is rlaifv_tpu/utils/synth.py's function, copied
because that module imports the JAX model package. The same seed gives the
same pairs in both packages.
"""
from __future__ import annotations

import numpy as np

from rlaifv_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


def synth_preference_pairs(cfg, n_pairs: int, *, answer_len: int = 96,
                           question_len: int = 24, seed: int = 0):
    """Random (rej, win) pairs shaped like real RLAIF-V rows, for a config
    with `llm.vocab_size` and `vision.image_size` (either package's)."""
    rng = np.random.default_rng(seed)
    vocab = cfg.llm.vocab_size
    size = cfg.vision.image_size
    pairs = []
    for _ in range(n_pairs):
        q = rng.integers(5, vocab, size=question_len).tolist()
        image = rng.normal(size=(size, size, 3)).astype(np.float32)

        def side(ans_len):
            ans = rng.integers(5, vocab, size=ans_len).tolist()
            ids = [1, *q[:4], IMAGE_TOKEN_INDEX, *q[4:], *ans, 2]
            labels = [IGNORE_INDEX] * (len(ids) - len(ans) - 1) + ans + [2]
            return {
                "input_ids": np.asarray(ids, np.int64),
                "labels": np.asarray(labels, np.int64),
                "image": image,
            }

        win = side(answer_len)
        jitter = int(rng.integers(-16, 16))
        rej = side(max(4, answer_len + jitter))
        win.update(ref_win_logp=float(rng.normal(-200, 20)),
                   ref_win_avg_logp=float(rng.normal(-2, 0.2)))
        rej.update(ref_rej_logp=float(rng.normal(-210, 20)),
                   ref_rej_avg_logp=float(rng.normal(-2.2, 0.2)))
        pairs.append((rej, win))
    return pairs


def quotient_ties(M: int, N: int, J: int = 1, *, seed: int = 0):
    """Rows and column scales whose per-row quantisation lands on and next
    to half-integers, for the int8 and int4 dx kernels' rounding: numpy
    (dy (M, N) fp32 holding bf16 values, gs (J, N) fp32). For every row m
    and group j, v = dy[m] * gs[j] has its largest |v| in column 0 (dy 1,
    gs[j, 0] = 381 2^e_j), so sy = max|v| / 127 = 3 2^e_j exactly, whose
    reciprocal is inexact. Half of the other columns hold dy = +-3 (2k + 1)
    / 2 against gs[j, n] = 2^e_j, so v / sy = +-(k + 1/2) exactly; a quarter
    move gs one ulp off 2^e_j (quotients within an ulp of a half-integer);
    a quarter are Gaussian (|dy| <= 100, bf16)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-12, 1, size=(J, 1)).astype(np.float32)
    kind = rng.integers(0, 4, size=N)
    kind[0] = -1
    gs = np.where(kind == 2, np.where(rng.integers(0, 2, size=N) == 1,
                                      np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -24)),
                  np.float32(1)).astype(np.float32) * np.exp2(e)
    gs[:, 0] = 381 * np.exp2(e[:, 0])
    half = 3 * (2 * rng.integers(0, 43, size=(M, N)) + 1) / 2
    half *= np.where(rng.integers(0, 2, size=(M, N)) == 1, 1, -1)
    gauss = np.clip(rng.normal(scale=30.0, size=(M, N)), -100, 100)
    gauss = (gauss.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)
    dy = np.where(kind[None] == 3, gauss, half).astype(np.float32)
    dy[:, 0] = 1
    return dy, gs.astype(np.float32)


def continuous_mask(B: int, L: int, gt: int, *, seed: int = 0, shift: int = 0,
                    empty=(1,)) -> np.ndarray:
    """A (B, L) int32 cache mask as continuous batching (genai/continuous.py)
    leaves it at a decode step writing column gt: an active row's live window
    starts anywhere and ends at gt (the fresh column included), a finished
    row's window ends before gt (its column gt masked), the rows `empty`
    are masked everywhere (slots never filled); with `shift`, the windows
    were laid out at write column gt + shift and rolled left by `shift`, as
    a compaction rolls them, the columns from gt on cleared. Every third
    row from row 0 is finished; the decode kernels read valid_len gt + 1."""
    rng = np.random.default_rng(seed)
    top = gt + shift
    if not (0 < gt and top < L):
        raise ValueError(f"continuous_mask: need 0 < gt and gt + shift < L; got {gt}, {shift}")
    mask = np.zeros((B, L), np.int32)
    active = []
    for b in range(B):
        if b in empty:
            continue
        stop = top
        if b % 3 == 0:
            stop = top - int(rng.integers(1, max(2, top // 4)))
        else:
            active.append(b)
        mask[b, stop - int(rng.integers(1, stop + 1)):stop] = 1
    if shift:
        mask = np.roll(mask, -shift, axis=1)
        mask[:, gt:] = 0
    mask[active, gt] = 1
    return mask
