"""Continuous batching for the decode engine: slot-refill generation.

Counterpart of rlaifv_tpu/genai/continuous.py with the same names and the
same design. The fixed-batch path waits for the slowest row of its batch;
here B cache slots decode together, and whenever a slot finishes its
sequence a pending prompt is prefilled into that slot while the others keep
decoding:

- one global KV cache (B slots, `max_len` rounded up to 128) with a single
  shared write column `gt` that advances once a decode step (every row
  writes the same column);
- a refilled prompt is placed so it ends at the current `gt`: it is
  prefilled in its own (R, Lp_r) window (square, so its attention takes the
  flash kernel on the card) and the window's K/V is scattered into columns
  [gt - Lp_r, gt) of the freed slots, whose whole mask row is cleared
  first. RoPE positions are content-relative (`cur_pos`, the per-row count
  of live tokens), so cache columns carry only masking, never positions;
- every row's live window is therefore contiguous and ends at `gt`, so
  compaction (reclaiming the dead prefix when `gt + T` would pass max_len)
  rolls every column left by `gt - max(cur_pos of the active rows)`;
- sampling state (repetition-penalty counts), positions, the emitted
  count, the per-prompt budget and `done` reset per slot at a refill; the
  queue runs longest prompt first.

The chunk of T decode steps is T eager steps whose state stays on the
device: `gt` is a host int that advances by one a step, and the host reads
the chunk's tokens, `done` and `cur_pos` once, packed into one tensor, so a
chunk costs one host sync, not one a step. A refill wave adds none: its
host arrays (prompt ids and masks, slot ids, budgets, pixels) reach the
card by non-blocking copies from pinned memory (utils/device.py), and
each wave builds its slot index once. The JAX chunk (a while loop)
leaves early once every row is done; this one always runs its T steps
(finished rows emit PAD and write masked columns, so the tokens are the
same; ROADMAP.md section 3). The logits of finished and empty slots are
zeroed before the draw, so every row's draw stays finite.

`share_keys` (one hashable per prompt; equal key == identical prompt and
image): a refill wave prefills each distinct key once at B=1
(`_window_prefill`) and broadcast-scatters that window into all of the
key's freed slots (`_scatter_refill`); the last window stays on the device, so
stragglers of the same key refill with no forward pass. Keys seen once fall
through to the batched refill. A fused engine ignores share_keys, as the
JAX module's docstring says (the stacked write-through prefill keeps no
per-layer window).

Modes: "text", "images" (the LLaVA / OmniLMM splice through the engine's
`_embeds`) and "spans" (MiniCPM-V's pre-encoded span groups, (N, S, Q, D)
numpy or a tensor on the card, with (N, S) starts relative to each prompt,
-1 inactive: a refill takes its prompts' groups and shifts their starts by
the window's left padding; padding rows take the first prompt's group with
every start -1). The per-layer engine (bf16 or int8 KV cache) scatters into its per-layer cache; the fused
engine prefills through `stacked_prefill_tower(col_start=, slot_ids=)`
straight into the stacked cache and compacts with `compact_stacked`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from rlaifv_tpu_torch.genai.sampling import SamplingParams, sample_token
from rlaifv_tpu_torch.ops.fused_decode import (
    compact_stacked,
    init_stacked_cache,
    stacked_prefill_tower,
)
from rlaifv_tpu_torch.parallel.sharding import serving
from rlaifv_tpu_torch.utils.device import to_device


def _bucket(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _pow2_at_least(n: int, cap: int) -> int:
    r = 1
    while r < n:
        r *= 2
    return min(r, cap)


@dataclasses.dataclass
class _Slots:
    """The B slots' device state (the JAX chunk's loop carry)."""
    cache: object  # per-layer list of dicts, or the stacked dict (fused)
    cache_mask: torch.Tensor  # (B, max_len) int32
    token_seen: Optional[torch.Tensor]  # (B, V) int32, with a repetition penalty
    last_logits: torch.Tensor  # (B, V) in the model's dtype
    cur_pos: torch.Tensor  # (B,) int64: live tokens of the row = next rope position
    emitted: torch.Tensor  # (B,) int64
    done: torch.Tensor  # (B,) bool
    budget: torch.Tensor  # (B,) int64


class ContinuousGenerator:
    """Drives a DecodeEngine's model with slot-refill continuous batching.

    `stats` counts what a run did: refill waves, batched refill prefills,
    window prefills and scatter refills (share_keys), compactions, chunks
    and decode steps."""

    def __init__(self, engine, *, slots: int = 8, chunk: int = 32,
                 max_new_tokens: int = 512,
                 sampling: SamplingParams = SamplingParams.greedy(),
                 prompt_bucket: int = 64, headroom: Optional[int] = None):
        self.engine = engine
        self.B = slots
        self.T = chunk
        self.max_new = max_new_tokens
        self.sp = sampling
        self.prompt_bucket = prompt_bucket
        self.headroom = headroom or max(2 * chunk, 128)
        self.use_rep = sampling.repetition_penalty != 1.0
        # fused multi-layer decode (ops/fused_decode.py): the global cache
        # lives in the kernel's stacked h-major layout the whole run
        self.fused = engine.fused_decode
        self.stats = dict.fromkeys(("refill_waves", "prefills", "window_prefills",
                                    "scatter_refills", "compactions", "chunks", "steps"), 0)

    # ------------------------------------------------------------ device steps

    def _init_slots(self, max_len: int) -> _Slots:
        eng, B, dev = self.engine, self.B, self.engine.device
        cfg = eng.llm.cfg
        cache = (init_stacked_cache(cfg, B, max_len, dev) if self.fused
                 else eng.llm.init_cache(B, max_len))
        V = eng.vocab_size
        return _Slots(
            cache=cache,
            cache_mask=torch.zeros((B, max_len), dtype=torch.int32, device=dev),
            token_seen=(torch.zeros((B, V), dtype=torch.int32, device=dev)
                        if self.use_rep else None),
            last_logits=torch.zeros((B, V), dtype=cfg.dtype, device=dev),
            cur_pos=torch.zeros(B, dtype=torch.int64, device=dev),
            emitted=torch.zeros(B, dtype=torch.int64, device=dev),
            done=torch.ones(B, dtype=torch.bool, device=dev),
            budget=torch.full((B,), self.max_new, dtype=torch.int64, device=dev),
        )

    def _reset_slots(self, st: _Slots, idx, ids, mask, first, gt: int,
                     budgets) -> None:
        """Per-slot state of the refilled slots `idx` (a device index;
        row r of ids/mask/first/budgets is slot idx[r], or one row broadcast
        to all): the mask row cleared, then the window's mask at [gt - Lp,
        gt); the prompt's token counts; the first logits; positions,
        emitted, done and budget."""
        dev = st.cache_mask.device
        n, Lp = idx.numel(), mask.shape[1]
        # index_fill_ takes its scalar as an argument: `x[idx] = 0` would
        # upload the scalar from pageable memory, a host sync
        st.cache_mask.index_fill_(0, idx, 0)
        st.cache_mask[idx, gt - Lp:gt] = mask[:n]
        if st.token_seen is not None:
            seen = torch.zeros((mask.shape[0], st.token_seen.shape[1]), dtype=torch.int32,
                               device=dev)
            seen.scatter_add_(1, ids.clamp(min=0).long(), mask)
            st.token_seen[idx] = seen[:n]
        st.last_logits[idx] = first[:n].to(st.last_logits.dtype)
        st.cur_pos[idx] = mask[:n].sum(dim=1)
        st.emitted.index_fill_(0, idx, 0)
        st.done.index_fill_(0, idx, False)
        st.budget[idx] = to_device(np.asarray(budgets[:n], np.int64), dev)

    def _put(self, st: _Slots, window, idx, gt: int) -> None:
        """Per-layer cache: rows of `window` (a per-layer cache of Lp
        columns; one row broadcasts) into columns [gt - Lp, gt) of the
        slots `idx` (a device index)."""
        for layer, sub in zip(st.cache, window):
            for key, glob in layer.items():
                w = sub[key]
                glob[idx, gt - w.shape[1]:gt] = w[:idx.numel()].to(glob.dtype)

    def _prefill_window(self, ids, mask, images, starts, cache, spans=None):
        """A left-padded window (R, Lp) through the per-layer model into
        `cache` (R rows of exactly Lp columns: square attention) -> the
        last position's logits (R, V)."""
        eng = self.engine
        pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        logits, _ = eng.llm(inputs_embeds=eng._embeds(ids, images, starts, spans),
                            attention_mask=mask, position_ids=pos, cache=cache,
                            cache_index=0)
        return logits[:, -1]

    def _refill(self, st: _Slots, ids, mask, slot_ids, gt: int, images, starts,
                budgets_r, spans=None):
        """Prefill R prompts in their own (R, Lp_r) window and scatter it
        into columns [gt - Lp_r, gt) of the slots `slot_ids` (a host array;
        ids >= B are padding rows, dropped) -> first logits (R, V)."""
        eng, B = self.engine, self.B
        R, Lp = ids.shape
        idx = to_device(np.asarray([s for s in slot_ids if s < B], np.int64), eng.device)
        if self.fused:
            cfg = eng.llm.cfg
            pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
            x, _ = stacked_prefill_tower(
                eng._fused_stacked, st.cache, eng._embeds(ids, images, starts, spans), mask,
                pos,
                cfg, col_start=gt - Lp, slot_ids=slot_ids, n_slots=B)
            first = eng._head(x[:, -1])
        else:
            window = eng.llm.init_cache(R, Lp)
            first = self._prefill_window(ids, mask, images, starts, window, spans)
            self._put(st, window, idx, gt)
        self._reset_slots(st, idx, ids, mask, first, gt, budgets_r)
        self.stats["prefills"] += 1
        return first

    def _window_prefill(self, ids, mask, images, starts, spans=None):
        """Prefill ONE prompt into a standalone (1, Lp) window cache in the
        serving cache type -> (window, first logits (1, V)). The window is
        position-independent (content-relative RoPE), so it can be
        scattered into any slots at any gt, any number of times."""
        window = self.engine.llm.init_cache(1, ids.shape[1])
        first = self._prefill_window(ids, mask, images, starts, window, spans)
        self.stats["window_prefills"] += 1
        return window, first

    def _scatter_refill(self, st: _Slots, window, first, ids, mask, slots, gt: int,
                        budgets_r) -> None:
        """Refill `slots` from a saved (1, Lp) window: broadcast-scatter its
        K/V into columns [gt - Lp, gt) and reset the slots' state, with no
        forward pass."""
        n = len(slots)
        idx = to_device(np.asarray(slots, np.int64), self.engine.device)
        self._put(st, [{k: c.expand(n, *c.shape[1:]) for k, c in layer.items()}
                       for layer in window], idx, gt)
        self._reset_slots(st, idx, ids.expand(n, -1), mask.expand(n, -1),
                          first.expand(n, -1), gt, budgets_r)
        self.stats["scatter_refills"] += 1

    def _chunk(self, st: _Slots, gt: int, generator) -> np.ndarray:
        """T decode steps from write column gt, all state on the device ->
        the host copy of (T + 2, B) int64: the T steps' tokens (PAD for a
        done row), then done, then cur_pos: the chunk's one sync."""
        eng, T = self.engine, self.T
        pad_id, eos_id = eng.pad_id, eng.eos_id
        buf = torch.full((T, self.B), pad_id, dtype=torch.int64, device=st.done.device)
        for t in range(T):
            # finished and empty slots draw from zeros: finite whatever their
            # (masked or stale) attention gave
            logits = torch.where(st.done[:, None], 0, st.last_logits)
            tok = sample_token(generator, logits, self.sp, st.token_seen)
            tok = torch.where(st.done, pad_id, tok)
            live = ~st.done
            st.emitted += live
            new_done = st.done | (tok == eos_id) | (st.emitted >= st.budget)
            buf[t] = tok
            st.cache_mask[:, gt + t] = live.to(torch.int32)
            st.last_logits, st.cache = eng._step(tok, st.cache_mask, st.cur_pos, st.cache,
                                                 gt + t)
            if st.token_seen is not None:
                st.token_seen.scatter_add_(1, tok[:, None], live[:, None].to(torch.int32))
            st.cur_pos += live
            st.done = new_done
        self.stats["chunks"] += 1
        self.stats["steps"] += T
        return torch.cat([buf, st.done[None].long(), st.cur_pos[None]]).cpu().numpy()

    def _compact(self, st: _Slots, gt: int, shift: int) -> None:
        """Roll every cache column left by `shift` (one layer tensor at a
        time) and mask the columns from gt - shift on."""
        if self.fused:
            compact_stacked(st.cache, shift)
        else:
            for layer in st.cache:
                for c in layer.values():
                    c.copy_(torch.roll(c, -shift, dims=1))
        st.cache_mask.copy_(torch.roll(st.cache_mask, -shift, dims=1))
        st.cache_mask[:, gt - shift:] = 0
        self.stats["compactions"] += 1

    # ------------------------------------------------------------ host

    @serving
    def run(self, prompts, *, images: Optional[np.ndarray] = None, image_starts=None,
            span_features=None, span_starts=None, seed: int = 0,
            collect_first_logits: bool = False, max_new_per_prompt=None,
            share_keys=None):
        """Generate for every prompt -> GenerateResult (tokens padded to
        max_new_tokens, lengths incl. EOS, first_logits only when
        collect_first_logits)."""
        from rlaifv_tpu_torch.genai.engine import GenerateResult, left_pad_batch

        eng, B, T = self.engine, self.B, self.T
        dev = eng.device
        N = len(prompts)
        if N == 0:
            return GenerateResult(np.zeros((0, 0), np.int32), np.zeros(0, np.int64),
                                  np.zeros((0, eng.vocab_size), np.float32))

        # longest first: every refill prompt fits left of gt (the classic
        # makespan heuristic); with share_keys, same-key prompts stay
        # adjacent (equal keys imply equal lengths) so a wave sees whole runs
        share = share_keys is not None and not self.fused
        if share:
            rank: dict = {}
            for i in range(N):
                rank.setdefault(share_keys[i], len(rank))
            queue = deque(sorted(range(N),
                                 key=lambda i: (-len(prompts[i]), rank[share_keys[i]], i)))
        else:
            queue = deque(sorted(range(N), key=lambda i: -len(prompts[i])))
        saved = None  # the last window: dict(key, Lp, window, first, ids, mask)
        Lp0 = _bucket(len(prompts[queue[0]]), self.prompt_bucket)
        # 128-aligned: the decode kernels (#4, #5, #16) take 128-multiples
        max_len = _bucket(Lp0 + self.max_new + self.headroom, 128)
        st = self._init_slots(max_len)
        budgets = (np.minimum(np.asarray(max_new_per_prompt, np.int64), self.max_new)
                   if max_new_per_prompt is not None
                   else np.full(N, self.max_new, np.int64))
        generator = torch.Generator(device=dev).manual_seed(seed)

        owner = [-1] * B
        chunks_per_slot = [[] for _ in range(B)]
        out_tokens = [None] * N
        first_logits = [None] * N
        host_done = np.ones(B, bool)
        gt = Lp0
        mode = ("images" if images is not None
                else "spans" if span_features is not None else "text")

        def spans_of(ps, Lp_r, R):
            """The span groups of prompts `ps` in a window of Lp_r columns and
            R rows: (features (R, S, Q, D) on the device, starts (R, S)
            shifted by each prompt's left padding; padding rows repeat the
            first group with every start -1)."""
            rows = list(ps) + [ps[0]] * (R - len(ps))
            if torch.is_tensor(span_features):
                feats = span_features.index_select(
                    0, to_device(np.asarray(rows, np.int64), span_features.device)).to(dev)
            else:
                feats = to_device(np.asarray(span_features)[rows], dev)
            sts = np.full((R, np.shape(span_starts)[1]), -1, np.int64)
            for r, p in enumerate(ps):
                st = np.asarray(span_starts[p], np.int64)
                sts[r] = np.where(st < 0, -1, st + Lp_r - len(prompts[p]))
            return feats, sts

        def harvest(s):
            p = owner[s]
            if p < 0:
                return
            out_tokens[p] = (np.concatenate(chunks_per_slot[s]) if chunks_per_slot[s]
                             else np.zeros(0, np.int64))
            owner[s] = -1
            chunks_per_slot[s] = []

        def refill_shared_run(key_r, ps, run_slots):
            """Refill len(ps) slots with ONE identical prompt: prefill its
            window once per distinct key (or reuse the saved one), then
            broadcast-scatter it."""
            nonlocal saved
            p0 = ps[0]
            Lp_r = _bucket(len(prompts[p0]), self.prompt_bucket)
            if not (saved and saved["key"] == key_r and saved["Lp"] == Lp_r):
                ids, mask = left_pad_batch([prompts[p0]], eng.pad_id, Lp_r)
                ids, mask = to_device(ids, dev), to_device(mask, dev)
                media, starts, spans = None, None, None
                if mode == "images":
                    st0 = int(image_starts[p0])
                    media = eng._device_images(images[p0][None])
                    starts = [st0 + Lp_r - len(prompts[p0]) if st0 >= 0 else -1]
                elif mode == "spans":
                    spans = spans_of([p0], Lp_r, 1)
                window, first = self._window_prefill(ids, mask, media, starts, spans)
                saved = dict(key=key_r, Lp=Lp_r, window=window, first=first, ids=ids,
                             mask=mask)
            self._scatter_refill(st, saved["window"], saved["first"], saved["ids"],
                                 saved["mask"], list(run_slots), gt, budgets[ps])
            for s, p in zip(run_slots, ps):
                owner[s] = p
                host_done[s] = False
            if collect_first_logits:
                fl = saved["first"][0].float().cpu().numpy()
                for p in ps:
                    first_logits[p] = fl

        def refill():
            nonlocal gt
            free = [s for s in range(B) if host_done[s]]
            take = min(len(free), len(queue))
            if take == 0:
                return
            self.stats["refill_waves"] += 1
            popped = [queue.popleft() for _ in range(take)]
            for s in free[:take]:
                harvest(s)

            # same-key runs of >= 2, a key matching the saved window, or a
            # singleton whose key recurs later in the queue (its window is
            # saved for those) refill by broadcast-scatter; the rest batch
            shared_runs, group = [], []
            if share:
                runs = []
                for p in popped:
                    k = share_keys[p]
                    if runs and runs[-1][0] == k:
                        runs[-1][1].append(p)
                    else:
                        runs.append((k, [p]))
                pending = {share_keys[q] for q in queue}
                for k, ps in runs:
                    skey = saved["key"] if saved else object()
                    if len(ps) >= 2 or k == skey or k in pending:
                        shared_runs.append((k, ps))
                    else:
                        group.extend(ps)
            else:
                group = popped

            # advance the shared write column once so every window of this
            # wave fits left of it (the skipped columns are masked;
            # longest-first bounds every Lp_r by Lp0)
            lp_need = max((_bucket(len(prompts[ps[0]]), self.prompt_bucket)
                           for _, ps in shared_runs), default=0)
            if group:
                lp_need = max(lp_need, _bucket(max(len(prompts[p]) for p in group),
                                               self.prompt_bucket))
            gt = max(gt, lp_need)

            slot_iter = iter(free[:take])
            for k, ps in shared_runs:
                refill_shared_run(k, ps, [next(slot_iter) for _ in ps])
            if not group:
                return
            free_rest = list(slot_iter)
            take = len(group)
            Lp_r = _bucket(max(len(prompts[p]) for p in group), self.prompt_bucket)
            R = _pow2_at_least(take, B)
            ids, mask = left_pad_batch([prompts[p] for p in group], eng.pad_id, Lp_r)
            if take < R:  # padding rows: PAD ids, masked, dropped at the scatter
                ids = np.concatenate([ids, np.full((R - take, Lp_r), eng.pad_id, np.int32)])
                mask = np.concatenate([mask, np.zeros((R - take, Lp_r), np.int32)])
            slot_ids = np.full(R, B, np.int64)
            slot_ids[:take] = free_rest[:take]
            media = starts = spans = None
            if mode == "spans":
                spans = spans_of(group, Lp_r, R)
            if mode == "images":
                offs = Lp_r - np.asarray([len(prompts[p]) for p in group])
                media = np.zeros((R,) + images.shape[1:], images.dtype)
                media[:take] = images[group]
                st_r = np.asarray([image_starts[p] for p in group], np.int64)
                starts = np.zeros(R, np.int64)
                starts[:take] = np.where(st_r < 0, -1, st_r + offs)
                media = eng._device_images(media)
            budgets_r = np.full(R, self.max_new, np.int64)
            budgets_r[:take] = budgets[group]
            first = self._refill(st, to_device(ids, dev), to_device(mask, dev), slot_ids, gt,
                                 media, starts, budgets_r, spans)
            for s, p in zip(free_rest[:take], group):
                owner[s] = p
                host_done[s] = False
            if collect_first_logits:
                fl = first.float().cpu().numpy()
                for r, p in enumerate(group):
                    first_logits[p] = fl[r]

        refill()
        cur_host = np.zeros(B, np.int64)
        while queue or not host_done.all():
            if gt + T > max_len:
                # reclaim the dead prefix: every active row's window is its
                # trailing cur_pos columns before gt (finished rows' tokens
                # are on the host already)
                active = cur_host[~host_done]
                shift = gt - (int(active.max()) if active.size else 0)
                self._compact(st, gt, shift)
                gt -= shift
            packed = self._chunk(st, gt, generator)
            gt += T
            buf_h = packed[:T]
            host_done = packed[T].astype(bool)
            cur_host = packed[T + 1]
            for s in range(B):
                if owner[s] >= 0:
                    chunks_per_slot[s].append(buf_h[:, s])
            refill()

        for s in range(B):
            harvest(s)
        lengths = np.zeros(N, np.int64)
        out = np.full((N, max(self.max_new, 1)), eng.pad_id, np.int32)
        for p in range(N):
            row = out_tokens[p]
            eos = np.where(row == eng.eos_id)[0]
            n = int(eos[0]) + 1 if len(eos) else len(row)
            n = min(n, int(budgets[p]))
            lengths[p] = n
            out[p, :n] = row[:n]
        fl = np.stack(first_logits) if collect_first_logits else None
        return GenerateResult(out, lengths, fl)
