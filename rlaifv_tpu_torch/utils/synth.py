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
