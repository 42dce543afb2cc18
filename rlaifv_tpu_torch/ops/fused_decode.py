"""Fused decode: one kernel launch per generated token walks every layer.

Counterpart of rlaifv_tpu/ops/fused_decode.py (TPU kernel #16,
`fused_decode_step`) for a model with int8 (or nibble-packed int4) weights,
fused q/k/v and gate/up projections and an int8 KV cache, with the JAX
package's names and public layouts:

- the stacked weights (`stack_llama_params`): (n_layers, K, N) int8 (int4:
  (n_layers, K/2, N) packed bytes), int8 scales with a leading 1
  ((n_layers, 1, N)), int4 group scales (n_layers, K/G, N); the MLP padded
  from I to Ip (`_pick_intermediate`) with zero columns (rows for down),
  which add exact zeros; the norms as fp32 (n_layers, 2, D);
- the cache, h-major: (n_layers, KVH, B, L, Dh) int8 values and
  (n_layers, KVH, B, L) fp32 scales (`init_stacked_cache`, `stack_cache`).

`fused_decode_step` computes one decode step through every layer with the
residual in fp32 -> (x_out (B, D) fp32, the fresh k/v of every layer), the
function of the TPU kernel `_kernel` phase by phase: rms norm without a
cast; every activation quantised per row to int8 (x over D; q, k, v and the
attention output over Dh; silu(gate) * up per row AND per I-block of bi
columns, `_quant_rows`); the fresh column in fp32 from the unquantised q, k
and v; the cache in blocks of `bl` keys, each block's probabilities
quantised after folding in the v scales; the o projection scaled per
(head, row) before the head sum; the down product added to x I-block by
I-block, in order. On a CUDA tensor it launches the hand-written kernel in
csrc/fused_decode.cu (one cooperative launch a token) or raises; on a CPU
tensor it runs the plain twin `fused_decode_step_ref`. The caller writes
the fresh k/v into the cache (`scatter_new_kv`) and runs ln_f and the head
on x_out.

The kernel cuts each (row, kv head)'s live cache blocks into
`fused_attention_plan` splits and merges them (`fused_decode_step_ref(...,
attn_splits=)` is its reference; one split is the sequential function),
and slices the int8 qkv and gate/up contractions by
`fused_product_slices` (exact int32 partials: the same function).

`stacked_prefill_tower` is the write-through prefill over the stacked
weights: the per-layer products (QuantDense's), attention and rope of the
model, each layer's int8 k/v written straight into the stacked cache, at a
column offset and, for continuous batching (genai/continuous.py), into the
slots `slot_ids` of the batch (`write_prefill_window`). `compact_stacked`
rolls the cache's columns left one layer at a time (continuous batching's
compaction).

Deliberate differences from the JAX module:
- no `sdown` banding: the int4 down scales stay (n_layers, Ip/G, D); the
  JAX package pads each I-block's scale rows to a multiple of 8 for a
  Mosaic layout rule, which this port does not carry;
- stacking, the fresh k/v scatter and the prefill's cache writes are in
  place: `stack_llama_params` copies one weight kind at a time into its
  stacked tensor and frees each layer's buffer as it goes (always the JAX
  `consume=True` donation), so the two layouts of a weight never coexist
  beyond one stacked array; so is `compact_stacked`, through one
  layer-sized temporary (the JAX function rolls each layer into a new
  slice).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rlaifv_tpu_torch.ops.int4_matmul import int4_product_plain, pick_int4_group, unpack_int4
from rlaifv_tpu_torch.ops.quant_matmul import _int_product, int8_matmul_prequant_plain, quantize_rows
from rlaifv_tpu_torch.utils.device import to_device

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class FusedDecodeDims:
    n_layers: int
    D: int          # hidden
    H: int          # query heads
    KVH: int        # kv heads (a divisor of H)
    Dh: int         # head dim
    I: int          # true intermediate (model config)
    Ip: int         # padded intermediate (zero columns are exact)
    L: int          # cache max length
    eps: float      # rms norm epsilon
    bn_qkv: int
    bl: int         # cache key block: part of the function (p is quantised per block)
    bn_o: int
    bi: int         # I-block: part of the function (the activation is quantised per block)
    w4: bool = False   # nibble-packed int4 weights with group scales
    g_d: int = 128     # group along D (qkv + gate/up contractions)
    g_o: int = 128     # group along H*Dh (o contraction; % Dh == 0)
    g_down: int = 128  # group along I/Ip (down contraction)

    @property
    def gpb_down(self) -> int:
        """down-projection quantisation groups per bi block."""
        return self.bi // self.g_down

    @property
    def Nq(self) -> int:
        return (self.H + 2 * self.KVH) * self.Dh

    @property
    def nq(self) -> int:
        return self.Nq // self.bn_qkv

    @property
    def natt(self) -> int:
        return self.L // self.bl

    @property
    def no(self) -> int:
        return self.D // self.bn_o

    @property
    def nI(self) -> int:
        return self.Ip // self.bi

    @property
    def att_prep(self) -> int:
        return self.nq

    @property
    def att0(self) -> int:
        return self.nq + 1

    @property
    def att_fin(self) -> int:
        return self.att0 + self.natt

    @property
    def o0(self) -> int:
        return self.att_fin + 1

    @property
    def m0(self) -> int:
        return self.o0 + self.no

    @property
    def phases(self) -> int:
        return self.m0 + 3 * self.nI


def _pick_block(n: int, targets) -> int:
    for t in targets:
        if n % t == 0:
            return t
    raise ValueError(f"no block divides {n} among {targets}")


def _pick_intermediate(I: int):
    """(Ip, bi): I padded up to a multiple of 128 that admits a block of 512
    to 2048 columns (Vicuna-7B's 11008 -> 11264 = 8 x 1408). The JAX rule,
    kept because bi is part of the function."""
    base = -(-I // 128) * 128
    lo = min(512, base)
    for pad in range(0, 9):
        Ip = base + pad * 128
        for t in range(min(2048, Ip), lo - 1, -128):
            if Ip % t == 0:
                return Ip, t
    return base, 128


def default_dims(cfg, L: int) -> FusedDecodeDims:
    D, H, KVH, Dh = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_size)
    Nq = (H + 2 * KVH) * Dh
    qkv_targets = [t for t in (2048, 1024, 512, 256, 128, Dh)
                   if H * Dh % t == 0 and KVH * Dh % t == 0 and Nq % t == 0]
    Ip, bi = _pick_intermediate(cfg.intermediate_size)
    w4 = getattr(cfg, "quantize_bits", 8) == 4
    g_d = g_o = g_down = 128
    if w4:
        g_d = pick_int4_group(D)
        g_o = pick_int4_group(H * Dh)
        g_down = pick_int4_group(cfg.intermediate_size)
        assert g_o % Dh == 0, (
            f"int4 o-projection needs whole heads per group (g_o={g_o}, Dh={Dh})")
        assert bi % g_down == 0 and Ip % g_down == 0, (
            f"int4 mlp tiling: g_down={g_down} must divide bi={bi} and Ip={Ip}")
    return FusedDecodeDims(
        n_layers=cfg.num_layers, D=D, H=H, KVH=KVH, Dh=Dh,
        I=cfg.intermediate_size, Ip=Ip, L=L, eps=cfg.rms_norm_eps,
        bn_qkv=qkv_targets[0],
        bl=_pick_block(L, (128, 256, L)),
        bn_o=_pick_block(D, (2048, 1024, 512, 256, 128, D)),
        bi=bi, w4=w4, g_d=g_d, g_o=g_o, g_down=g_down,
    )


# ------------------------------------------------------------ layouts

_KERNEL_PATHS = (("attn", "qkv_proj"), ("attn", "o_proj"),
                 ("mlp", "gate_up_proj"), ("mlp", "down_proj"))
_STACKED_NAMES = (("wqkv", "sqkv"), ("wo", "so"), ("wgu", "sgu"), ("wdown", "sdown"))


def _llm(model):
    """The LlamaForCausalLM of a LlavaForCausalLM, or the model itself."""
    return getattr(model, "llm", model)


def _layers(model):
    return _llm(model).model.layers


def _pad_cols(a: torch.Tensor, I: int, Ip: int) -> torch.Tensor:
    """(..., 2I) gate|up columns -> (..., 2Ip) with zero columns after each half."""
    if Ip == I:
        return a
    z = a.new_zeros(a.shape[:-1] + (Ip - I,))
    return torch.cat([a[..., :I], z, a[..., I:], z], dim=-1)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """(r, N) -> (rows, N) with zero rows after."""
    if a.shape[0] == rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])])


@torch.no_grad()
def stack_llama_params(model, cfg=None) -> dict:
    """The LLM's per-layer QuantDense buffers (quantize + fuse_proj) -> the
    stacked arrays of the module docstring, in place: one weight kind at a
    time, each layer's weight is copied into the preallocated stacked tensor
    and that layer's `q` buffer is then freed, so a weight's two layouts
    never coexist beyond one stacked array (the JAX `consume=True`
    donation). The model keeps its scales and norms and serves only through
    the stacked arrays afterwards."""
    cfg = cfg or _llm(model).cfg
    layers = _layers(model)
    n, I = cfg.num_layers, cfg.intermediate_size
    Ip, _ = _pick_intermediate(I)
    w4 = cfg.quantize_bits == 4
    out = {}
    for (grp, name), (wkey, skey) in zip(_KERNEL_PATHS, _STACKED_NAMES):
        mods = [getattr(getattr(layers[i], grp), name) for i in range(n)]
        if wkey == "wgu":
            wfix = sfix = lambda a: _pad_cols(a, I, Ip)  # noqa: E731
        elif wkey == "wdown":
            wfix = lambda a: _pad_rows(a, Ip // 2 if w4 else Ip)  # noqa: E731
            sfix = (lambda a: _pad_rows(a, Ip // (I // a.shape[0]))) if w4 \
                else (lambda a: a)  # noqa: E731
        else:
            wfix = sfix = lambda a: a  # noqa: E731
        w0 = wfix(mods[0].q)
        wst = torch.empty((n,) + tuple(w0.shape), dtype=w0.dtype, device=w0.device)
        for i, mod in enumerate(mods):
            wst[i] = wfix(mod.q)
            mod.q = mod.q.new_empty(0)
        scales = [sfix(mod.scale if w4 else mod.scale[None]) for mod in mods]
        out[wkey], out[skey] = wst, torch.stack(scales).float().contiguous()
    out["ln"] = torch.stack([torch.stack([layers[i].ln_attn.weight, layers[i].ln_mlp.weight])
                             for i in range(n)]).float()
    return out


def init_stacked_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """A fresh all-zero stacked h-major int8 cache."""
    n, KVH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_size
    shape = (n, KVH, batch, max_len)
    return {"k": torch.zeros(shape + (Dh,), dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape + (Dh,), dtype=torch.int8, device=device),
            "v_scale": torch.zeros(shape, dtype=torch.float32, device=device)}


def stack_cache(cache_list) -> dict:
    """Per-layer int8 caches (B, L, KVH[, Dh]) -> the stacked h-major layout."""
    def st(key, perm):
        return torch.stack([c[key] for c in cache_list]).permute(perm).contiguous()

    return {"k": st("k", (0, 3, 1, 2, 4)), "k_scale": st("k_scale", (0, 3, 1, 2)),
            "v": st("v", (0, 3, 1, 2, 4)), "v_scale": st("v_scale", (0, 3, 1, 2))}


def unstack_cache(stacked: dict) -> list:
    """The stacked h-major cache -> per-layer (B, L, KVH[, Dh]) views."""
    return [{"k": stacked["k"][i].permute(1, 2, 0, 3),
             "k_scale": stacked["k_scale"][i].permute(1, 2, 0),
             "v": stacked["v"][i].permute(1, 2, 0, 3),
             "v_scale": stacked["v_scale"][i].permute(1, 2, 0)}
            for i in range(stacked["k"].shape[0])]


def write_prefill_window(scache: dict, i: int, mini: dict, col_start: int = 0,
                         slot_ids=None, n_slots: int = 0) -> dict:
    """Write layer i's prefill window cache (model layout (R, Lp, KVH[, Dh]))
    into the stacked cache at columns [col_start, col_start + Lp), in place.

    slot_ids None: the window's rows are the batch's rows (R == B).
    Otherwise row r goes to slot slot_ids[r] of the n_slots-row batch, and
    rows whose id is n_slots or more are dropped (continuous batching's
    padding rows); slot_ids is a host sequence of ints."""
    return _write_window(scache, i, mini, col_start,
                         _slot_rows(slot_ids, n_slots, scache["k"].device))


def _slot_rows(slot_ids, n_slots: int, device):
    """The window rows kept and their slots, as two device indices (built
    once for all layers, uploaded without a host sync), or None for the
    identity (slot_ids None); rows with an id >= n_slots are dropped."""
    if slot_ids is None:
        return None
    keep = [(r, int(s)) for r, s in enumerate(slot_ids) if 0 <= int(s) < n_slots]
    return to_device(np.asarray(keep, np.int64).reshape(-1, 2).T, device)


def _write_window(scache: dict, i: int, mini: dict, col_start: int, rows_slots) -> dict:
    """write_prefill_window with the slot indices of _slot_rows."""
    if rows_slots is not None and rows_slots.shape[1] == 0:
        return scache
    for key, sub in mini.items():
        glob = scache[key]
        sub = sub.transpose(0, 2).transpose(1, 2).to(glob.dtype)  # (KVH, R, Lp[, Dh])
        cols = slice(col_start, col_start + sub.shape[2])
        if rows_slots is None:
            glob[i, :, :, cols] = sub
        else:
            glob[i, :, :, cols].index_copy_(1, rows_slots[1],
                                            sub.index_select(1, rows_slots[0]))
    return scache


def compact_stacked(scache: dict, shift: int) -> dict:
    """Roll every layer's cache columns left by `shift` (continuous
    batching's compaction), in place, one layer at a time through one
    layer-sized temporary: a roll of the whole stacked cache would need a
    second cache."""
    for a in scache.values():
        for layer in a:
            layer.copy_(torch.roll(layer, -int(shift), dims=2))
    return scache


def scatter_new_kv(cache: dict, new_kv: dict, cache_index: int) -> dict:
    """Write the step's fresh per-layer k/v ((n_layers, KVH, B[, Dh])) into
    the stacked cache at column `cache_index`, in place (the JAX package's
    dynamic_update_slice into a new array)."""
    for key, val in new_kv.items():
        cache[key][:, :, :, cache_index] = val.to(cache[key].dtype)
    return cache


# ------------------------------------------------------------ prefill


def _rms_like_model(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """models/llama.py's RMSNorm (fp32 inside, cast back to x's type)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def stacked_prefill_tower(stacked: dict, scache: dict, embeds: torch.Tensor,
                          mask: torch.Tensor, pos: torch.Tensor, cfg, col_start: int = 0,
                          slot_ids=None, n_slots: int = 0):
    """A prompt window (R, Lp) through the whole layer stack on the stacked
    weights, each layer's int8 k/v written into the stacked cache at columns
    [col_start, col_start + Lp) (the write-through prefill), of slots
    `slot_ids` of an n_slots-row cache if given (`write_prefill_window`;
    ids >= n_slots drop). The products
    are QuantDense's (`quant_product`: the int8/int4 kernels on the card),
    attention the model's over the fresh window (`multi_head_attention`:
    flash at Lq >= 128 on the card), and the zero-padded MLP columns are
    exact, so this equals the per-layer prefill. -> (final hidden states
    (R, Lp, D) before ln_f, scache)."""
    from rlaifv_tpu_torch.models.llama import apply_rope, quant_product, rope_cos_sin
    from rlaifv_tpu_torch.ops.attention import multi_head_attention
    from rlaifv_tpu_torch.ops.decode_attention import quantize_kv

    R, Lp = mask.shape
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    bits = cfg.quantize_bits
    Ip, _ = _pick_intermediate(cfg.intermediate_size)
    cos, sin = rope_cos_sin(pos, Dh, cfg.rope_theta, cfg.dtype)

    def mm(x, w, s):  # int8 stacked scales carry a leading 1
        return quant_product(x.to(cfg.dtype), w, s if bits == 4 else s[0], bits)

    rows_slots = _slot_rows(slot_ids, n_slots, scache["k"].device)
    x = embeds
    for i in range(cfg.num_layers):
        xn = _rms_like_model(x, stacked["ln"][i, 0], cfg.rms_norm_eps)
        q, k, v = mm(xn, stacked["wqkv"][i], stacked["sqkv"][i]).split(
            [H * Dh, KVH * Dh, KVH * Dh], dim=-1)
        q = apply_rope(q.reshape(R, Lp, H, Dh), cos, sin)
        k = apply_rope(k.reshape(R, Lp, KVH, Dh), cos, sin)
        v = v.reshape(R, Lp, KVH, Dh)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        out = multi_head_attention(q, k, v, attention_mask=mask, causal=True,
                                   q_offset=None, impl=cfg.attn_impl)
        x = x + mm(out.reshape(R, Lp, H * Dh), stacked["wo"][i], stacked["so"][i])
        xn2 = _rms_like_model(x, stacked["ln"][i, 1], cfg.rms_norm_eps)
        gu = mm(xn2, stacked["wgu"][i], stacked["sgu"][i])
        act = F.silu(gu[..., :Ip]) * gu[..., Ip:]
        x = x + mm(act, stacked["wdown"][i], stacked["sdown"][i])
        _write_window(scache, i, {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs},
                      col_start, rows_slots)
    return x, scache


# ------------------------------------------------------------ decode step


def rope_tables(positions: torch.Tensor, Dh: int, theta: float) -> torch.Tensor:
    """(2, B, Dh) fp32 cos and sin of the fresh token's positions, the HF
    duplicated-half layout, built in fp32 (not in the model's dtype)."""
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                        device=positions.device) / Dh))
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.stack([torch.cos(ang), torch.sin(ang)])


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's rms norm: fp32 in and out, no cast."""
    r = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * r * scale


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, heads, Dh) fp32, cos/sin (B, Dh): x cos + rotate_half(x) sin."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _product(x8, sx, w, s, w4: bool) -> torch.Tensor:
    """The kernel's weight product on quantised rows -> fp32: int8 (float(acc)
    * sx) * s; int4 the group sums in order, times sx."""
    if w4:
        return int4_product_plain(x8, sx, w, s)
    return int8_matmul_prequant_plain(x8, sx, w, s[0])


def _fresh_column(qg, k, v, scale: float):
    """The online softmax's state after the always-live fresh column, from
    the unquantised qg (B, KVH, n_rep, Dh), k and v (B, KVH, Dh): m = (q .
    k) scale, l = 1, acc = v."""
    m = (qg * k[:, :, None, :]).sum(dim=-1, keepdim=True) * scale
    return m, torch.ones_like(m), v[:, :, None, :].expand(qg.shape).clone()


def _blocks(q8, qs, m, l, acc, cache, layer: int, live_all, j0: int, j1: int,
            d: FusedDecodeDims):
    """The online softmax's state (m, l, acc) carried over the cache blocks
    [j0, j1), q8/qs quantised per (head, row), each block's v-scaled
    probabilities quantised per row."""
    scale = 1.0 / (d.Dh ** 0.5)
    for j in range(j0, j1):
        cols = slice(j * d.bl, (j + 1) * d.bl)
        kb = cache["k"][layer][:, :, cols].permute(1, 0, 3, 2)  # (B, KVH, Dh, bl)
        vb = cache["v"][layer][:, :, cols].permute(1, 0, 2, 3)  # (B, KVH, bl, Dh)
        ks = cache["k_scale"][layer][:, :, cols].permute(1, 0, 2)[:, :, None, :]
        vs = cache["v_scale"][layer][:, :, cols].permute(1, 0, 2)[:, :, None, :]
        s = _int_product(q8, kb) * qs * ks * scale
        s = torch.where(live_all[:, None, None, cols], s, NEG_INF)
        m_new = torch.maximum(m, torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF / 2))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p8, ps = quantize_rows(p * vs)
        acc = acc * corr + _int_product(p8, vb) * ps
        m = m_new
    return m, l, acc


def fused_split_blocks(n_blocks: int, splits: int) -> list:
    """The cache blocks [j0, j1) of each split, as the kernel cuts them."""
    return [(s * n_blocks // splits, (s + 1) * n_blocks // splits) for s in range(splits)]


def _attention(q, k, v, cache, layer: int, mask, cache_index: int, d: FusedDecodeDims,
               splits: int = 1):
    """q (B, H, Dh), k/v (B, KVH, Dh) roped fp32 -> (B, H, Dh) fp32: the
    fresh column from the unquantised q, k, v, then the live cache blocks
    with q quantised per (head, row) and each block's v-scaled
    probabilities quantised per row. With `splits` > 1 the blocks are cut
    as the kernel cuts them (`fused_split_blocks`): split 0 carries on from
    the fresh column, every other split starts from m = -1e30, l = 0, acc =
    0, and the splits merge in order: M = max m_s, out = (sum acc_s e^(m_s
    - M)) / max(sum l_s e^(m_s - M), 1e-30)."""
    B = q.shape[0]
    scale = 1.0 / (d.Dh ** 0.5)
    qg = q.reshape(B, d.KVH, d.H // d.KVH, d.Dh)
    q8, qs = quantize_rows(qg)
    m, l, acc = _fresh_column(qg, k, v, scale)
    live_col = torch.arange(d.L, device=q.device) < cache_index
    live_all = (mask != 0) & live_col[None, :]
    n_blocks = max(-(-cache_index // d.bl), 0)
    if splits == 1:
        m, l, acc = _blocks(q8, qs, m, l, acc, cache, layer, live_all, 0, n_blocks, d)
        return (acc / torch.clamp_min(l, 1e-30)).reshape(B, d.H, d.Dh)
    states = []
    for s, (j0, j1) in enumerate(fused_split_blocks(n_blocks, splits)):
        if s:
            m, l, acc = torch.full_like(m, NEG_INF), torch.zeros_like(l), torch.zeros_like(acc)
        states.append(_blocks(q8, qs, m, l, acc, cache, layer, live_all, j0, j1, d))
    mx = torch.stack([ms for ms, _, _ in states]).amax(dim=0)
    num, den = 0.0, 0.0
    for ms, ls, accs in states:
        w = torch.exp(ms - mx)
        num, den = num + accs * w, den + ls * w
    return (num / torch.clamp_min(den, 1e-30)).reshape(B, d.H, d.Dh)


O_CHUNK = 8  # heads of one partial sum of the o projection (one o item of the kernel)


def _o_projection(ao8, aos, wo, so, d: FusedDecodeDims) -> torch.Tensor:
    """ao8 (B, H, Dh) int8, aos (B, H, 1) -> (B, D) fp32: each head's exact
    int32 partial scaled by its (head, row) activation scale (int4: and the
    head's group scale) before the head sum; the heads summed in order
    within chunks of O_CHUNK, the chunks in order; int8 then times the
    column scales."""
    w = unpack_int4(wo, d.g_o) if d.w4 else wo
    y = None
    for c0 in range(0, d.H, O_CHUNK):
        yc = None
        for h in range(c0, min(c0 + O_CHUNK, d.H)):
            part = _int_product(ao8[:, h], w[h * d.Dh:(h + 1) * d.Dh]) * aos[:, h]
            if d.w4:
                part = part * so[h * d.Dh // d.g_o]
            yc = part if yc is None else yc + part
        y = yc if y is None else y + yc
    return y if d.w4 else y * so[0]


def _act_quant(gu: torch.Tensor, d: FusedDecodeDims) -> list:
    """gate|up (B, 2Ip) -> [(a8, sa)] per I-block: a = (g sigmoid(g)) u,
    quantised per row and I-block."""
    out = []
    for blk in range(d.nI):
        g = gu[:, blk * d.bi:(blk + 1) * d.bi]
        u = gu[:, d.Ip + blk * d.bi:d.Ip + (blk + 1) * d.bi]
        out.append(quantize_rows((g * torch.sigmoid(g)) * u))
    return out


def _down(a8, sa, wdown, sdown, blk: int, d: FusedDecodeDims) -> torch.Tensor:
    """One I-block's down product on its quantised activations -> (B, D) fp32."""
    rows = slice(blk * d.bi, (blk + 1) * d.bi)
    if d.w4:
        packed = wdown[blk * d.bi // 2:(blk + 1) * d.bi // 2]
        groups = sdown[blk * d.gpb_down:(blk + 1) * d.gpb_down]
        return int4_product_plain(a8, sa, packed, groups)
    return _int_product(a8, wdown[rows]) * sa * sdown[0]


def fused_decode_step_ref(stacked: dict, cache: dict, x: torch.Tensor, mask: torch.Tensor,
                          positions: torch.Tensor, cache_index: int, dims: FusedDecodeDims,
                          *, rope_theta: float = 10000.0, attn_splits=None):
    """The plain twin of kernel #16, phase by phase in fp32 (module
    docstring) -> (x_out (B, D) fp32, new_kv): {"k", "v"} (n_layers, KVH,
    B, Dh) int8 and {"k_scale", "v_scale"} (n_layers, KVH, B) fp32. The
    integer sums are exact (`_int_product`) and every quantisation divides
    in IEEE fp32, as the kernel does. attn_splits: the cache blocks of each
    (row, kv head) cut into that many splits and merged (`_attention`), as
    the kernel's plan cuts them (`fused_plan(...).attn_splits`); None or 1:
    the sequential function (the JAX package's)."""
    d = dims
    if d.H % d.KVH:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    cache_index = int(cache_index)
    splits = int(attn_splits or 1)
    if not 1 <= splits <= max(-(-cache_index // d.bl), 1):
        raise ValueError(f"attn_splits must be in [1, max(live blocks, 1)]; got {attn_splits}")
    B = x.shape[0]
    cos, sin = rope_tables(positions, d.Dh, rope_theta)
    xs = x.float().clone()
    new = {key: [] for key in ("k", "k_scale", "v", "v_scale")}
    for i in range(d.n_layers):
        x8, sx = quantize_rows(_rms(xs, stacked["ln"][i, 0], d.eps))
        q, k, v = _product(x8, sx, stacked["wqkv"][i], stacked["sqkv"][i], d.w4).split(
            [d.H * d.Dh, d.KVH * d.Dh, d.KVH * d.Dh], dim=-1)
        q = _rope(q.reshape(B, d.H, d.Dh), cos, sin)
        k = _rope(k.reshape(B, d.KVH, d.Dh), cos, sin)
        v = v.reshape(B, d.KVH, d.Dh)
        for key, t in (("k", k), ("v", v)):
            t8, ts = quantize_rows(t.transpose(0, 1))
            new[key].append(t8)
            new[f"{key}_scale"].append(ts[..., 0])
        out = _attention(q, k, v, cache, i, mask, cache_index, d, splits)
        ao8, aos = quantize_rows(out)
        xs = xs + _o_projection(ao8, aos, stacked["wo"][i], stacked["so"][i], d)
        x8, sx = quantize_rows(_rms(xs, stacked["ln"][i, 1], d.eps))
        gu = _product(x8, sx, stacked["wgu"][i], stacked["sgu"][i], d.w4)
        for blk, (a8, sa) in enumerate(_act_quant(gu, d)):
            xs = xs + _down(a8, sa, stacked["wdown"][i], stacked["sdown"][i], blk, d)
    return xs, {key: torch.stack(vals) for key, vals in new.items()}


# kernel #16's CTAs a streaming multiprocessor: ~111 KB of shared memory a
# CTA (csrc/fused_decode.cu), two on the H100's 228 KB
FUSED_CTAS_PER_SM = 2
KERNEL_TN = 128  # output columns of a product item
KERNEL_TK = 128  # contraction rows of a chunk


def fused_attention_plan(B: int, KVH: int, n_blocks: int, ctas: int, n_rep: int = 1) -> int:
    """The splits of each (row, kv head)'s live cache blocks in kernel #16's
    attention phase: as many as bring the B x KVH items up to one wave of
    the grid's `ctas` CTAs, at most one a block, at least one; one split
    once B x KVH fills a wave. A CTA serves all n_rep (1, 2, 4 or 8) query
    heads of its group, so n_rep does not change the plan. Splits fall on
    block boundaries (p is quantised per block). Llama3-8B's step (B 8,
    KVH 8, 18 live blocks) takes 4 splits on 264 CTAs; batch 24 (768 items)
    one (`ops/decode_attention.py:prefix_int8_plan`'s rule)."""
    if n_rep not in (1, 2, 4, 8):
        raise ValueError(f"fused_attention_plan: n_rep must be 1, 2, 4 or 8; got {n_rep}")
    if B * KVH >= ctas:
        return 1
    return max(1, min(n_blocks, ctas // (B * KVH)))


FUSED_MAX_SLICES = 8  # the kernel sums at most this many int32 partials of a value


def fused_product_slices(tiles: int, chunks: int, ctas: int) -> int:
    """The slices of an int8 contraction of `chunks` 128-row chunks whose
    `tiles` column tiles kernel #16 covers: items (tile, slice) are dealt to
    the `ctas` CTAs in turn, so a CTA takes ceil(tiles S / ctas) of them,
    each ceil(chunks / S) chunks plus about one chunk's worth of fixed cost
    (the slice's int32 partial out, its first load in). -> the S in [1,
    min(chunks, FUSED_MAX_SLICES)] with the least such cost, the smallest on
    a tie. The partials are exact, so S does not change the function. 7B
    qkv at any B (96 tiles of 32 chunks) takes 8 on 264 CTAs, gate/up (176
    tiles) 3."""
    def cost(s: int) -> int:
        return -(-tiles * s // ctas) * (-(-chunks // s) + 1)

    return min(range(1, min(chunks, FUSED_MAX_SLICES) + 1), key=lambda s: (cost(s), s))


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How kernel #16 cuts its work at one step's shape."""
    attn_splits: int  # cache-block splits of a (row, kv head)
    qkv_slices: int   # contraction slices of the qkv product (int8; int4: 1)
    gu_slices: int    # ... of the gate/up product


def _ctas(device) -> int:
    index = torch.device(device).index or 0 if device is not None else 0
    return FUSED_CTAS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count


def fused_plan(d: FusedDecodeDims, B: int, cache_index: int, ctas: int = None,
               device=None) -> FusedPlan:
    """Kernel #16's plan at this step: the attention's splits
    (`fused_attention_plan`) and the int8 contraction slices
    (`fused_product_slices`; int4 sums its groups in order, one slice).
    ctas: the kernel's grid (default FUSED_CTAS_PER_SM on each of the
    card's multiprocessors)."""
    ctas = ctas or _ctas(device)
    n_blocks = max(-(-int(cache_index) // d.bl), 0)
    attn = fused_attention_plan(B, d.KVH, n_blocks, ctas, d.H // d.KVH)
    if d.w4:
        return FusedPlan(attn, 1, 1)
    C = d.D // KERNEL_TK
    return FusedPlan(attn, fused_product_slices(d.Nq // KERNEL_TN, C, ctas),
                     fused_product_slices(2 * d.Ip // KERNEL_TN, C, ctas))


# every tensor the kernel takes, in the C entry point's order
# (csrc/fused_decode.cu, fused_decode_step_cuda)
_TENSORS = ("cossin", "mask", "ln", "wqkv", "sqkv", "k", "k_scale", "v", "v_scale",
            "wo", "so", "wgu", "sgu", "wdown", "sdown", "x", "nk", "nks", "nv", "nvs",
            "x8", "xs", "pqkv", "ao8", "aos", "pgu", "a8", "as", "po", "pdown", "patt", "cnt",
            "rowp")
_INTS = ("B", "n_layers", "D", "H", "KVH", "Ip", "bi", "L", "cache_index", "valid_blocks",
         "attn_splits", "qkv_slices", "gu_slices")
KERNEL_DH = 128  # the head dim the kernel is built for (every model the package serves)
KERNEL_MAX_B = 32  # rows one mma tile pair covers
KERNEL_MAX_D = 4096  # the hidden width a row phase keeps in registers


def _stacked_shapes(d: FusedDecodeDims) -> dict:
    n, D, HD = d.n_layers, d.D, d.H * d.Dh
    if d.w4:
        return {"wqkv": (n, D // 2, d.Nq), "sqkv": (n, D // d.g_d, d.Nq),
                "wo": (n, HD // 2, D), "so": (n, HD // d.g_o, D),
                "wgu": (n, D // 2, 2 * d.Ip), "sgu": (n, D // d.g_d, 2 * d.Ip),
                "wdown": (n, d.Ip // 2, D), "sdown": (n, d.Ip // d.g_down, D),
                "ln": (n, 2, D)}
    return {"wqkv": (n, D, d.Nq), "sqkv": (n, 1, d.Nq), "wo": (n, HD, D), "so": (n, 1, D),
            "wgu": (n, D, 2 * d.Ip), "sgu": (n, 1, 2 * d.Ip), "wdown": (n, d.Ip, D),
            "sdown": (n, 1, D), "ln": (n, 2, D)}


def _check_kernel_args(stacked, cache, x, mask, cache_index, d: FusedDecodeDims) -> None:
    """Raise for anything the kernel does not take."""
    B = x.shape[0]
    n_rep = d.H // d.KVH if d.KVH and d.H % d.KVH == 0 else 0
    if d.Dh != KERNEL_DH or n_rep not in (1, 2, 4, 8) or not 1 <= B <= KERNEL_MAX_B:
        raise ValueError(f"fused_decode_step kernel: Dh {KERNEL_DH}, n_rep in (1, 2, 4, 8) and "
                         f"1 <= B <= {KERNEL_MAX_B}; got Dh={d.Dh} H={d.H} KVH={d.KVH} B={B}")
    if d.bl != 128 or d.L % 128 or d.D % 128 or d.bi % 128 or d.Ip % d.bi \
            or max(d.nI, -(-d.H // O_CHUNK)) > 8 or d.D > KERNEL_MAX_D or d.bi > 2048:
        raise ValueError(f"fused_decode_step kernel: L, D and bi multiples of 128 (block 128), "
                         f"D <= {KERNEL_MAX_D}, bi <= 2048, at most 8 I-blocks and 8 head "
                         f"chunks; got L={d.L} D={d.D} bi={d.bi} bl={d.bl} nI={d.nI} H={d.H}")
    if d.w4 and (d.g_d, d.g_o, d.g_down) != (128, 128, 128):
        raise ValueError(f"fused_decode_step kernel: int4 groups of 128; got "
                         f"{(d.g_d, d.g_o, d.g_down)}")
    if not isinstance(cache_index, int) or not 0 <= cache_index < d.L:
        raise ValueError(f"cache_index must be an int in [0, {d.L}); got {cache_index!r}")
    want = {k: (v, torch.int8 if k.startswith("w") else torch.float32)
            for k, v in _stacked_shapes(d).items()}
    shape = (d.n_layers, d.KVH, B, d.L)
    want.update(k=(shape + (d.Dh,), torch.int8), v=(shape + (d.Dh,), torch.int8),
                k_scale=(shape, torch.float32), v_scale=(shape, torch.float32))
    for key, (shp, dtype) in want.items():
        t = cache[key] if key in cache else stacked[key]
        if tuple(t.shape) != shp or t.dtype != dtype or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"fused_decode_step kernel: {key} must be {shp} {dtype}, "
                             f"contiguous on {x.device}; got {tuple(t.shape)} {t.dtype}")
    if tuple(x.shape) != (B, d.D) or tuple(mask.shape) != (B, d.L):
        raise ValueError(f"fused_decode_step kernel: x ({B}, {d.D}) and mask ({B}, {d.L}); "
                         f"got {tuple(x.shape)}, {tuple(mask.shape)}")


def _kernel(stacked, cache, x, mask, positions, cache_index, d: FusedDecodeDims,
            rope_theta: float):
    from rlaifv_tpu_torch.ops import _build

    _check_kernel_args(stacked, cache, x, mask, cache_index, d)
    B, dev = x.shape[0], x.device
    f32, i8 = torch.float32, torch.int8

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    kv = (d.n_layers, d.KVH, B)
    plan = fused_plan(d, B, cache_index, device=dev)
    # the products' outputs: int8 the slices' exact int32 partials, int4 fp32
    part = torch.int32 if not d.w4 else f32
    t = dict(stacked, **cache)
    t.update(
        cossin=rope_tables(positions.to(dev), d.Dh, rope_theta).contiguous(),
        mask=mask.to(torch.int32).contiguous(),
        x=x.to(f32).clone(memory_format=torch.contiguous_format),
        nk=empty(*kv, d.Dh, dtype=i8), nks=empty(*kv), nv=empty(*kv, d.Dh, dtype=i8),
        nvs=empty(*kv), x8=empty(B, d.D, dtype=i8), xs=empty(B),
        pqkv=empty(plan.qkv_slices, B, d.Nq, dtype=part),
        ao8=empty(B, d.H * d.Dh, dtype=i8), aos=empty(d.H, 32),
        pgu=empty(plan.gu_slices, B, 2 * d.Ip, dtype=part),
        a8=empty(B, d.Ip, dtype=i8), **{"as": empty(B, d.nI)},
        po=empty(-(-d.H // O_CHUNK), B, d.D),
        pdown=empty(d.nI, B, d.D),
        patt=empty(B, d.H, plan.attn_splits, d.Dh + 4),
        # a (row, kv head)'s split arrivals, a row's part arrivals, the grid
        # barrier's 2 words, then CTAs an SM id (1024) and a rank (2)
        cnt=torch.zeros(B * d.KVH + B + 2 + 1026, dtype=torch.int32, device=dev),
        rowp=empty(2, B, 8),
    )
    ints = dict(B=B, n_layers=d.n_layers, D=d.D, H=d.H, KVH=d.KVH, Ip=d.Ip, bi=d.bi, L=d.L,
                cache_index=cache_index, valid_blocks=-(-cache_index // d.bl),
                **dataclasses.asdict(plan))
    args = [t[k].data_ptr() for k in _TENSORS] + [ints[k] for k in _INTS]
    packed = (ctypes.c_longlong * len(args))(*args)
    err = _build.load_kernels().fused_decode_step_cuda(
        packed, len(args), d.eps, 1.0 / d.Dh ** 0.5, int(d.w4),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decode_step_cuda")
    fused_decode_step.launches += 1
    return t["x"], {"k": t["nk"], "k_scale": t["nks"], "v": t["nv"], "v_scale": t["nvs"]}


def fused_decode_step(stacked: dict, cache: dict, x: torch.Tensor, mask: torch.Tensor,
                      positions: torch.Tensor, cache_index: int, dims: FusedDecodeDims,
                      *, rope_theta: float = 10000.0):
    """One decode step through every layer -> (x_out (B, D) fp32, new_kv).

    x (B, D): the fresh token's embedding; mask (B, L): cache-column
    validity; positions (B,): the fresh token's rope positions; cache_index:
    a host int, the cache column the fresh k/v belong to (columns below it
    are the live prefix). A CUDA tensor launches kernel #16 (Dh 128, n_rep in
    1/2/4/8, B <= 32, 128-multiples, D <= 4096; int4 groups of 128;
    anything else raises) with `fused_plan`'s splits; a CPU tensor runs
    `fused_decode_step_ref` at one split."""
    if x.is_cuda:
        return _kernel(stacked, cache, x, mask, positions, cache_index, dims, rope_theta)
    return fused_decode_step_ref(stacked, cache, x, mask, positions, cache_index, dims,
                                 rope_theta=rope_theta)


fused_decode_step.launches = 0  # kernel #16 launches (CUDA tensors only)
