# A copy of rlaifv_tpu/data/collator.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""DPO batch collation -> fixed-shape numpy arrays for the jitted train step.

Rebuild of the reference collators
(ref: muffin/train/train_muffin.py:38-112 `DataCollatorForDPODataset`,
muffin/eval/muffin_inference_logp.py:180-208 `concate_pad`/
`preference_collator_fn`). Differences, by TPU design:

- sequences are host-expanded (image sentinel -> patch span) BEFORE batching
  (data/multimodal.py), so the device program is static-shape;
- everything pads to one fixed `max_len` (single compiled program) instead
  of the batch max;
- images appear once per pair (B rows); the model tiles features to win‖rej.

Token weights replicate the RLHF-V scheme: tokens in replaced spans get
`mod_token_weight` (diff over ids[1:], min match 3 — train_muffin.py:86-95).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rlaifv_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from rlaifv_tpu_torch.data.diff_lib import get_diff_ids
from rlaifv_tpu_torch.data.multimodal import expand_image_sentinels


def _pad_to(arr: np.ndarray, length: int, value) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad = np.full((length - arr.shape[0],) + arr.shape[1:], value, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclasses.dataclass
class DPOCollator:
    pad_token_id: int
    max_len: int
    num_patches: int
    beta: float = 0.1
    mod_token_weight: float = 1.0  # train default (llava15_train.sh passes 1.0)
    expand_images: bool = True  # False when ids are already text-expanded
    # With expand_images=False and a token id set here, image_start is
    # located as the first occurrence of this id in each row (the OmniLMM
    # convention: the prompt carries literal <im_patch>*N tokens, ref
    # omnilmm/model/omnilmm.py:183-265 splices at those positions).
    image_patch_id: Optional[int] = None
    # "DPO": one image per pair (win's). "KTO": each side carries its own
    # image -> win_images/rej_images (ref trainers.py:188-196 is_kto branch).
    task: str = "DPO"
    # Bucketed padding: pad to the batch max rounded up to a multiple of
    # `bucket` (capped at max_len) instead of always max_len. Typical
    # RLAIF-V rows are ~700-900 tokens after image expansion, so this cuts
    # most of the 2048-pad compute; XLA compiles one program per bucket
    # (a handful in practice). None = fixed max_len (one program).
    bucket: Optional[int] = 256

    def _encode_side(self, inst: dict, L: int) -> Dict[str, np.ndarray]:
        ids = np.asarray(inst["input_ids"])
        labels = np.asarray(inst["labels"])
        if self.expand_images:
            ex = expand_image_sentinels(ids, labels, self.num_patches, L)
        else:
            start = -1
            if self.image_patch_id is not None:
                hits = np.where(ids[:L] == self.image_patch_id)[0]
                if len(hits):
                    start = int(hits[0])
            ex = {
                "input_ids": ids[:L].astype(np.int32),
                "labels": labels[:L].astype(np.int32),
                "image_start": np.int32(start),
            }
        length = len(ex["input_ids"])
        return {
            "input_ids": _pad_to(ex["input_ids"], L, self.pad_token_id),
            "labels": _pad_to(ex["labels"], L, IGNORE_INDEX),
            "attention_mask": _pad_to(np.ones(length, dtype=np.int32), L, 0),
            "image_start": ex["image_start"],
        }

    def _expanded_len(self, inst: dict) -> int:
        ids = np.asarray(inst["input_ids"])
        if not self.expand_images:
            return len(ids)
        n_images = int((ids == IMAGE_TOKEN_INDEX).sum())
        return len(ids) + n_images * (self.num_patches - 1)

    def _batch_len(self, instances) -> int:
        if self.bucket is None:
            return self.max_len
        longest = max(
            self._expanded_len(x) for pair in instances for x in pair
        )
        b = self.bucket
        return min(self.max_len, max(b, ((longest + b - 1) // b) * b))

    def __call__(self, instances: Sequence[Tuple[dict, dict]]) -> Dict[str, np.ndarray]:
        rej_instances, win_instances = zip(*instances)
        B = len(instances)
        L = self._batch_len(instances)

        win = [self._encode_side(x, L) for x in win_instances]
        rej = [self._encode_side(x, L) for x in rej_instances]

        def stack(side, key):
            return np.stack([s[key] for s in side])

        win_ids, rej_ids = stack(win, "input_ids"), stack(rej, "input_ids")
        win_labels, rej_labels = stack(win, "labels"), stack(rej, "labels")

        batch: Dict[str, np.ndarray] = {
            "input_ids": np.concatenate([win_ids, rej_ids]),
            "labels": np.concatenate([win_labels, rej_labels]),
            "attention_mask": np.concatenate(
                [stack(win, "attention_mask"), stack(rej, "attention_mask")]
            ),
            "image_starts": np.concatenate(
                [stack(win, "image_start"), stack(rej, "image_start")]
            ),
            "win_labels": win_labels,
            "rej_labels": rej_labels,
            "beta": np.float32(self.beta),
        }

        images = [x.get("image") for x in win_instances]
        if self.task.upper() == "KTO" and images[0] is not None:
            rej_images = [
                r.get("image") if r.get("image") is not None else w
                for r, w in zip(rej_instances, images)
            ]
            batch["win_images"] = np.stack(images).astype(np.float32)
            batch["rej_images"] = np.stack(rej_images).astype(np.float32)
        elif images[0] is not None:
            batch["images"] = np.stack(images).astype(np.float32)

        for name, side in (("win", win_instances), ("rej", rej_instances)):
            for field in ("logp", "avg_logp"):
                key = f"ref_{name}_{field}"
                if key in side[0]:
                    batch[key] = np.asarray(
                        [x[key] for x in side], dtype=np.float32
                    )
            pt_key = f"ref_{name}_per_token_logp"
            if pt_key in side[0]:
                batch[pt_key] = np.stack(
                    [
                        _pad_to(np.asarray(x[pt_key], np.float32), L - 1, 0.0)
                        for x in side
                    ]
                )

        # RLHF-V fine-grained token weights over ids[1:] (train_muffin.py:86-95)
        win_w = np.ones((B, L - 1), dtype=np.float32)
        rej_w = np.ones((B, L - 1), dtype=np.float32)
        for i in range(B):
            # reference diffs the padded rows as-is (train_muffin.py:90-91);
            # trailing pad runs match as a block and are never marked.
            r_mod, w_mod = get_diff_ids(
                rej_ids[i][1:].tolist(), win_ids[i][1:].tolist(), min_match_size=3
            )
            win_w[i, w_mod] = self.mod_token_weight
            rej_w[i, r_mod] = self.mod_token_weight
        batch["win_token_weight"] = win_w
        batch["rej_token_weight"] = rej_w
        return batch
