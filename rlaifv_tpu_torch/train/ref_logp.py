"""Reference-logp precompute: the frozen starting policy scores every
preference pair once.

Counterpart of rlaifv_tpu/train/ref_logp.py on one process: win||rej pairs
run through one forward a batch (the vision tower once per image), or, by
default, through the shared-prefix scorer (`DecodeEngine.score_pair_logps`:
the prompt prefix prefills once a pair and only the two answers run
again); results go out in the reference's chunked-parquet contract
(data/datasets.py `write_logp_parquet`), which is also the restart
checkpoint. Each row gets [win_logp, win_avg, win_per_token, rej_logp,
rej_avg, rej_per_token]. Rows are sharded by process as in the JAX package;
the gather across processes waits for `core/distributed.py`, ROADMAP.md
'Modules to port' #11, so more than one process raises.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from rlaifv_tpu_torch.constants import IGNORE_INDEX
from rlaifv_tpu_torch.data.collator import DPOCollator
from rlaifv_tpu_torch.data.datasets import shard_indices, write_logp_parquet
from rlaifv_tpu_torch.data.preprocess import encode_preference_sample, preprocess_v1
from rlaifv_tpu_torch.train.dpo import (
    get_batch_logps,
    get_batch_logps_compact,
    get_batch_logps_from_hidden,
)
from rlaifv_tpu_torch.train.train_step import batch_to_device


def make_score_fn(model, *, lm_head_impl: str = "xla", compact_len: int = 0,
                  family: Optional[str] = None):
    """(collated numpy batch) -> (sum, avg, per_token) fp32 tensors for the
    concatenated win||rej rows, under inference mode, through the family's
    train-step adapter (`FamilySpec.adapter`; llava15 by default).

    "fused" runs the fused head (no (2B, L, V) logits: at 7B that tensor is
    the scoring pass's peak activation); "compact" (compact_len > 0) runs
    the head only on the <= compact_len loss positions of a row and
    scatters the per-token logps back to (2B, L-1), so the parquet contract
    is unchanged. Keep the train step's head: both are the same math, and
    matching them keeps the policy == reference => loss = ln 2 cancellation
    exact."""
    fused = lm_head_impl == "fused"
    compact = lm_head_impl == "compact"
    if compact and compact_len <= 0:
        raise ValueError("lm_head_impl='compact' requires compact_len > 0")
    use_hidden = fused or compact
    from rlaifv_tpu_torch.train.family import get_family

    adapter = get_family(family or "llava15").adapter(model)

    @torch.inference_mode()
    def score(batch_np):
        batch = batch_to_device(batch_np, model.device)
        fwd_feats = adapter.hidden_with_features if use_hidden else \
            adapter.forward_with_features
        fwd_text = adapter.hidden_text if use_hidden else adapter.forward_text
        images = batch.get("images")
        if images is not None:
            feats = adapter.encode_images_fn(images)
            out = fwd_feats(batch["input_ids"], torch.cat([feats, feats]),
                            batch["image_starts"], batch["attention_mask"])
        else:
            out = fwd_text(batch["input_ids"], batch["attention_mask"])
        labels = batch["labels"]
        if compact:
            lp = get_batch_logps_compact(out, adapter.lm_head_weight(), labels,
                                         n_pos=compact_len)
            per_token = torch.zeros((labels.shape[0], labels.shape[1] - 1),
                                    dtype=torch.float32, device=out.device)
            per_token.scatter_add_(1, lp.pos, lp.per_token * lp.mask)
            return lp.sum, lp.mean, per_token
        if fused:
            lp = get_batch_logps_from_hidden(out, adapter.lm_head_weight(), labels)
        else:
            lp = get_batch_logps(out, labels)
        return lp.sum, lp.mean, lp.per_token

    return score


def _encode_rows(rows, tokenizer, mm_cfg, preprocess_func=None):
    if preprocess_func is None:
        # llava15: has_image tokenisation with the kept <image> tag
        preprocess_func = partial(preprocess_v1, has_image=True)
    encoded = []
    for row in rows:
        # raw parquet columns as conversation turns
        src = {
            "question": {"from": "human", "value": f"<image>\n{row['question']}"},
            "chosen": {"from": "gpt", "value": row["chosen"]},
            "rejected": {"from": "gpt", "value": row["rejected"]},
        }
        if "image_bytes" in row or "image" in row:
            src["image"] = row.get("image_bytes", row.get("image"))
        encoded.append(encode_preference_sample(
            src, tokenizer, mm_cfg, preprocess_func=preprocess_func))
    return encoded


def _shared_split(ex_w, ex_r, num_patches: int):
    """Split one expanded pair at its longest shared prompt prefix ->
    (S, prefix, sfx_w, sfx_r, lab_w, lab_r), or None when the pair cannot
    share (no common prefix before the first label, or the image span
    crosses the split)."""
    w_ids, w_lab = ex_w["input_ids"], ex_w["labels"]
    r_ids, r_lab = ex_r["input_ids"], ex_r["labels"]
    start = int(ex_w["image_start"])
    if start != int(ex_r["image_start"]):
        return None
    n = min(len(w_ids), len(r_ids))
    neq = np.nonzero(w_ids[:n] != r_ids[:n])[0]
    common = int(neq[0]) if len(neq) else n
    firsts = [int(np.nonzero(lab != IGNORE_INDEX)[0][0])
              for lab in (w_lab, r_lab) if (lab != IGNORE_INDEX).any()]
    if len(firsts) < 2:
        return None
    S = min(common, *firsts) - 1
    if S < 1 or (start >= 0 and start + num_patches > S):
        return None

    def side(ids, lab):
        # suffix position j predicts token S+j+1 (shift-1 layout)
        sl = np.full(len(ids) - S, IGNORE_INDEX, np.int32)
        sl[: len(lab) - S - 1] = lab[S + 1:]
        return ids[S:].tolist(), sl.tolist()

    sfx_w, lab_w = side(w_ids, w_lab)
    sfx_r, lab_r = side(r_ids, r_lab)
    return S, w_ids[:S].tolist(), sfx_w, sfx_r, lab_w, lab_r


def _score_rows_shared(rows, model, tokenizer, *, max_len, num_patches,
                       batch_pairs, mm_cfg, progress, lm_head_impl="xla",
                       compact_len=0, family=None):
    """Shared-prefix variant of score_preference_rows: the prompt prefix
    (system, image tokens, question) prefills once a pair and only the two
    answer suffixes run the second forward (engine.score_pair_logps). Same
    outputs as the plain path; pairs that cannot share (the image span
    crosses the split, no labels, no image) fall back to the plain scorer
    with the given head (the JAX package's fallback takes its default
    "xla" head; at 7B the fused head keeps the (2B, L, V) logits out of
    memory there)."""
    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.train.family import get_family

    spec = get_family(family or "llava15")
    encoded = _encode_rows(rows, tokenizer, mm_cfg, spec.preprocess_func)
    prefixes, sfx_w, sfx_r, lab_w, lab_r = [], [], [], [], []
    images, starts, order, fallback = [], [], [], []
    meta = []  # (S, win length, rej length)
    for i, (rej, win) in enumerate(encoded):
        ex_w = spec.expand_inst(win, num_patches, max_len, tokenizer)
        ex_r = spec.expand_inst(rej, num_patches, max_len, tokenizer)
        split = _shared_split(ex_w, ex_r, num_patches)
        if split is None or win.get("image") is None:
            fallback.append(i)
            continue
        S, prefix, sw, sr, lw, lr = split
        order.append(i)
        prefixes.append(prefix)
        sfx_w.append(sw)
        sfx_r.append(sr)
        lab_w.append(lw)
        lab_r.append(lr)
        images.append(win["image"])
        starts.append(int(ex_w["image_start"]))
        meta.append((S, len(ex_w["input_ids"]), len(ex_r["input_ids"])))

    out: List[Optional[list]] = [None] * len(rows)
    if order:
        engine = DecodeEngine(model, eos_id=getattr(tokenizer, "eos_token_id", 2) or 2,
                              pad_id=tokenizer.pad_token_id or 0)
        it = range(0, len(order), batch_pairs)
        if progress:
            import tqdm

            it = tqdm.tqdm(it, desc="ref-logp(shared)")
        for c0 in it:
            rows_c = slice(c0, c0 + batch_pairs)
            idxs = order[rows_c]
            n = len(idxs)
            sums, means, per_tok = engine.score_pair_logps(
                prefixes[rows_c], sfx_w[rows_c] + sfx_r[rows_c],
                lab_w[rows_c] + lab_r[rows_c],
                images=np.stack(images[rows_c]).astype(np.float32),
                image_starts=starts[rows_c], pair_batch=batch_pairs)
            for j, i in enumerate(idxs):
                S, w_len, r_len = meta[c0 + j]

                def full(pt, L_valid):
                    arr = np.zeros(L_valid - 1, np.float32)
                    arr[S:L_valid - 1] = pt[:L_valid - 1 - S]
                    return arr.tolist()

                out[i] = [float(sums[j]), float(means[j]), full(per_tok[j], w_len),
                          float(sums[n + j]), float(means[n + j]),
                          full(per_tok[n + j], r_len)]
    if fallback:
        plain = score_preference_rows(
            [rows[i] for i in fallback], model, tokenizer, max_len=max_len,
            num_patches=num_patches, batch_pairs=batch_pairs, multimodal_cfg=mm_cfg,
            progress=False, lm_head_impl=lm_head_impl, compact_len=compact_len,
            shared_prefix=False, family=family)
        for i, res in zip(fallback, plain):
            out[i] = res
    return out


def score_preference_rows(
    rows: Sequence[dict],
    model,
    tokenizer,
    *,
    max_len: int = 2048,
    num_patches: int = 576,
    batch_pairs: int = 8,
    image_processor: Optional[Callable] = None,
    multimodal_cfg: Optional[dict] = None,
    progress: bool = True,
    lm_head_impl: str = "xla",
    compact_len: int = 0,
    shared_prefix: bool = False,
    family: Optional[str] = None,
) -> List[list]:
    """Per-row [win_logp, win_avg, win_per_token, rej_logp, rej_avg,
    rej_per_token] (the reference's 'logps' order) from the model, which
    holds its own weights and device.

    shared_prefix=True prefills each pair's shared prompt prefix once and
    scores only the answer suffixes (the suffix logits are answers only, so
    lm_head_impl serves only the rows that cannot share, which go through
    the plain scorer). lm_head_impl "compact" needs a
    compact_len that bounds every row's loss positions, checked on the host
    per batch."""
    from rlaifv_tpu_torch.train.family import get_family

    spec = get_family(family or "llava15")
    image_processor = image_processor or spec.image_processor()
    mm_cfg = multimodal_cfg or spec.mm_cfg(image_processor, num_patches)
    if shared_prefix:
        return _score_rows_shared(
            rows, model, tokenizer, max_len=max_len, num_patches=num_patches,
            batch_pairs=batch_pairs, mm_cfg=mm_cfg, progress=progress,
            lm_head_impl=lm_head_impl, compact_len=compact_len, family=family)
    collator = DPOCollator(pad_token_id=tokenizer.pad_token_id, max_len=max_len,
                           num_patches=num_patches, **spec.collator_kwargs(tokenizer))
    score = make_score_fn(model, lm_head_impl=lm_head_impl, compact_len=compact_len,
                          family=family)

    out: List[list] = []
    it = range(0, len(rows), batch_pairs)
    if progress:
        import tqdm

        it = tqdm.tqdm(it, desc="ref-logp")
    for start in it:
        chunk = rows[start:start + batch_pairs]
        batch = collator(_encode_rows(chunk, tokenizer, mm_cfg, spec.preprocess_func))
        if lm_head_impl == "compact":
            # a bound too small would silently zero dropped tokens in the cache
            n_valid = int((batch["labels"][:, 1:] != IGNORE_INDEX).sum(-1).max())
            if n_valid > compact_len:
                raise ValueError(
                    f"compact_len={compact_len} < {n_valid} loss positions in this "
                    "batch; raise compact_len or use lm_head_impl='xla'/'fused'")
        sums, avgs, per_tok = (t.float().cpu().numpy() for t in score(batch))

        B = len(chunk)
        for i in range(B):
            # per-token logps over the valid (non-pad) prefix
            win_valid = int(batch["attention_mask"][i].sum()) - 1
            rej_valid = int(batch["attention_mask"][B + i].sum()) - 1
            out.append([float(sums[i]), float(avgs[i]), per_tok[i][:win_valid].tolist(),
                        float(sums[B + i]), float(avgs[B + i]),
                        per_tok[B + i][:rej_valid].tolist()])
    return out


def inference_logp(
    rows: Sequence[dict],
    model,
    tokenizer,
    out_dir: str,
    *,
    max_len: int = 2048,
    num_patches: int = 576,
    batch_pairs: int = 8,
    image_processor: Optional[Callable] = None,
    lm_head_impl: str = "xla",
    compact_len: int = 0,
    shared_prefix: bool = True,
    family: Optional[str] = None,
) -> None:
    """Score all rows and write the logp parquet cache into out_dir.

    shared_prefix=True (the default): each pair's prompt prefix prefills
    once and only the two answer suffixes run again, the same values for a
    fraction of the work."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1:
        raise NotImplementedError(
            "the reference-logp precompute over more than one process needs the "
            "cross-process gather, which is not ported to rlaifv_tpu_torch yet: "
            "ROADMAP.md 'Modules to port' #11 (core/distributed.py)")
    local = shard_indices(len(rows), world, 0)
    logps = score_preference_rows(
        [rows[i] for i in local], model, tokenizer, max_len=max_len,
        num_patches=num_patches, batch_pairs=batch_pairs,
        image_processor=image_processor, lm_head_impl=lm_head_impl,
        compact_len=compact_len, shared_prefix=shared_prefix, family=family)
    write_logp_parquet(rows, out_dir, logps)
