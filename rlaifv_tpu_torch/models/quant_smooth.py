"""Activation-aware smoothing for int4 quantisation (AWQ / SmoothQuant).

Counterpart of rlaifv_tpu/models/quant_smooth.py. A per-in-channel scale s
moves the difficulty of rare large activation channels into the weights
before group-128 int4 quantisation:

    y = (x / s) @ (W * s[:, None])

and the division by s folds exactly into the producer of x:

  - q/k/v_proj and gate/up_proj read an RMSNorm output: gamma' = gamma / s;
  - down_proj reads silu(gate) * up, linear in up: up_proj's output
    columns are divided by s, which up's own per-(group, column) scales
    absorb;
  - o_proj is left unsmoothed, as in the JAX package.

s_k = amax_x(k)^alpha / amax_w(k)^(1 - alpha), normalised to a geometric
mean of 1. alpha=None searches `_ALPHAS` per producer group for the s with
the least summed output error under both error sources of the runtime
(group-int4 weights and row-wise int8 activations); alpha 0 (s = 1) is a
candidate, so the search never does worse than plain quantisation on the
calibration batch.

The port works on a model (LlamaForCausalLM, or a composite model whose
`llm` is one) in place, one layer at a time on the model's device:

- `collect_llm_act_stats` records the producers' outputs (ln_attn, ln_mlp,
  gate_proj and up_proj, or gate_up_proj) with forward hooks on a float
  model, the first `max_rows` flattened rows of each, as fp32 tensors;
- the alpha search runs the JAX numpy arithmetic in fp32 torch on the
  device (plain products outside any kernel); `_smooth_scale` stays the
  JAX numpy function on the host (vectors of K entries), so s is the JAX
  package's bit for bit for the same statistics and alpha;
- `smooth_llm_for_int4(..., quantize=True)` quantises each smoothed kernel
  from its fp32 value (never rounded to the model's dtype first), so the
  int4 integers and group scales are those of the JAX
  `quantize_llm_int4(smooth_llm_for_int4(...))`; without `quantize` the
  folded weights are written back in the model's parameter dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_CAPTURE = ("ln_attn", "ln_mlp", "gate_proj", "up_proj", "gate_up_proj")
_ALPHAS = (0.0, 0.25, 0.5, 0.75)
CALIBRATION_TEXT = ("A chat between a curious user and an artificial intelligence "
                    "assistant. The assistant gives helpful answers to the user's questions.")


def _lm(model):
    """The LlamaForCausalLM of a bare or composite model."""
    return getattr(model, "llm", model)


@torch.no_grad()
def collect_llm_act_stats(model, ids, max_rows: int = 256) -> dict:
    """Calibration activations for the smoothable projections: up to
    `max_rows` token rows of each producer's output, flattened to (T, K),
    fp32 on the model's device.

    Runs the language model of `model` (a float model: quantised layers
    raise) over `ids` (B, L). Returns {"layer_i": {"attn_in": (T, D),
    "mlp_in": (T, D), "down_in": (T, I)}}."""
    llm = _lm(model)
    if llm.cfg.quantize:
        raise ValueError("collect_llm_act_stats: calibrate the float model (quantize=False)")
    captured, hooks = [], []

    def keep(store, name):
        def hook(mod, args, out):
            store[name] = out.detach().reshape(-1, out.shape[-1])[:max_rows].float()
        return hook

    for blk in llm.model.layers:
        store = {}
        captured.append(store)
        mods = {"ln_attn": blk.ln_attn, "ln_mlp": blk.ln_mlp}
        mods.update((n, getattr(blk.mlp, n)) for n in _CAPTURE[2:] if hasattr(blk.mlp, n))
        hooks += [m.register_forward_hook(keep(store, n)) for n, m in mods.items()]
    ids = ids if torch.is_tensor(ids) else torch.from_numpy(np.asarray(ids, np.int64))
    try:
        llm(ids.to(device=llm.model.tok_embed.weight.device, dtype=torch.long))
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for i, store in enumerate(captured):
        if "gate_up_proj" in store:
            gu = store["gate_up_proj"]
            I = gu.shape[-1] // 2
            down_in = F.silu(gu[:, :I]) * gu[:, I:]
        else:
            down_in = F.silu(store["gate_proj"]) * store["up_proj"]
        out[f"layer_{i}"] = {"attn_in": store["ln_attn"], "mlp_in": store["ln_mlp"],
                             "down_in": down_in}
    return out


def collect_llm_act_amax(model, ids) -> dict:
    """Per-channel |activation| maxima (see collect_llm_act_stats)."""
    stats = collect_llm_act_stats(model, ids)
    return {ln: {k: v.abs().amax(dim=0) for k, v in rec.items()} for ln, rec in stats.items()}


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d as an IEEE division by a tensor (torch multiplies by the
    reciprocal of a Python-scalar divisor; numpy divides)."""
    return a / torch.full_like(a, d)


def _quant_dequant(w: torch.Tensor) -> torch.Tensor:
    """Group int4 quantise -> dequantise of an fp32 (K, N) kernel (the
    weight half of the search's error model): groups of 128 rows where 128
    divides K, else one group of K."""
    K, N = w.shape
    g = 128 if K % 128 == 0 else K
    wg = w.reshape(K // g, g, N)
    scale = _div(torch.clamp_min(wg.abs().amax(dim=1), 1e-8), 7.0)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return (q * scale[:, None, :]).reshape(K, N)


def _act_quant(x: torch.Tensor) -> torch.Tensor:
    """Row-wise symmetric int8 quantise -> dequantise: the kernels'
    activation rule, whose error x / s changes too."""
    s = _div(torch.clamp_min(x.abs().amax(dim=1, keepdim=True), 1e-20), 127.0)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def _smooth_scale(act_amax, w_amax, alpha: float) -> np.ndarray:
    """The JAX package's formula in host numpy (float64, cast to fp32)."""
    a = np.maximum(np.asarray(act_amax, np.float64), 1e-8)
    w = np.maximum(np.asarray(w_amax, np.float64), 1e-8)
    s = a ** alpha / w ** (1.0 - alpha)
    s = s / np.exp(np.mean(np.log(s)))  # geometric mean 1: pure migration
    return np.clip(s, 1e-3, 1e3).astype(np.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _w_amax(kernels) -> torch.Tensor:
    return torch.stack([w.abs().amax(dim=1) for w in kernels]).amax(dim=0)


def _search_scale(x: torch.Tensor, kernels, alpha) -> tuple:
    """s for one producer group -> (s (K,) fp32 on x's device, the alpha
    taken, each candidate's summed output error or None). alpha=None: the
    first of `_ALPHAS` with the least error of the group's kernels on the
    calibration rows x (T, K), both operands quantised as the runtime
    quantises them; a float alpha pins the formula."""
    act_amax, w_amax = _host(x.abs().amax(dim=0)), _host(_w_amax(kernels))

    def scale(a):
        return torch.from_numpy(_smooth_scale(act_amax, w_amax, a)).to(x.device)

    if alpha is not None:
        return scale(alpha), alpha, None
    refs = [x @ w for w in kernels]
    errs = []
    for a in _ALPHAS:
        s = scale(a)
        xs = _act_quant(x / s[None, :])
        err = torch.zeros((), dtype=torch.float64, device=x.device)
        for w, ref in zip(kernels, refs):
            got = xs @ _quant_dequant(w * s[:, None])
            err += ((got - ref) ** 2).mean().double()
        errs.append(err)
    errs = torch.stack(errs).tolist()  # one host read a group
    best = min(range(len(_ALPHAS)), key=lambda i: (errs[i], i))
    return scale(_ALPHAS[best]), _ALPHAS[best], errs


def _kernel(mod) -> torch.Tensor:
    """A float projection's (in, out) kernel in fp32."""
    if not hasattr(mod, "weight"):
        raise ValueError("smooth_llm_for_int4: the projections must be float (smooth "
                         "before quantising)")
    return mod.weight.detach().float().T


@torch.no_grad()
def smooth_llm_for_int4(model, act_stats: dict, alpha=None, *, quantize: bool = False,
                        log: Optional[dict] = None):
    """The smoothing folds applied to `model`'s language model in place,
    layer by layer on its device -> model. Outputs are unchanged up to the
    rounding of the folded weights.

    act_stats: collect_llm_act_stats (activation rows: the per-group alpha
    search, the default) or collect_llm_act_amax (amax vectors: the fixed
    formula, alpha 0.5 unless given); numpy arrays or tensors.
    quantize=True replaces each smoothed projection by an int4 QuantDense
    quantised from its fp32 smoothed kernel (group `pick_int4_group(in)`);
    the model is left partly quantised (o_proj and the head untouched):
    `quantize_llm_int4_smooth` finishes it. `log`, when given, receives
    {"layer_i": {"attn_in" | "mlp_in" | "down_in": (alpha, errors)}}."""
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch
    from rlaifv_tpu_torch.models.llama import QuantDense
    from rlaifv_tpu_torch.ops.int4_matmul import pick_int4_group

    llm = _lm(model)
    dev = llm.model.tok_embed.weight.device

    def write(owner, name, kernel):
        mod = getattr(owner, name)
        if not quantize:
            mod.weight.copy_(kernel.T)
            return
        q, scale = quantize_int4_torch(kernel, pick_int4_group(kernel.shape[0]))
        quant = QuantDense(mod.in_features, mod.out_features, dtype=mod.compute_dtype,
                           bits=4, device="meta")
        quant.q, quant.scale = q, scale
        setattr(owner, name, quant)

    for lname, stats in act_stats.items():
        blk = llm.model.layers[int(lname.split("_")[1])]
        attn, mlp = blk.attn, blk.mlp
        record = {}

        def scale_for(key, kernels):
            a = stats[key]
            a = (a.to(dev, torch.float32) if torch.is_tensor(a)
                 else torch.tensor(np.asarray(a, np.float32), device=dev))
            if a.dim() == 1:  # amax-only statistics: the fixed formula
                a_fixed = 0.5 if alpha is None else alpha
                s = _smooth_scale(_host(a), _host(_w_amax(kernels)), a_fixed)
                record[key] = (a_fixed, None)
                return torch.from_numpy(s).to(dev)
            s, chosen, errs = _search_scale(a, kernels, alpha)
            record[key] = (chosen, errs)
            return s

        # every scale of the layer from the unsmoothed kernels, as the JAX
        # function reads them, then each kernel folded once from fp32
        qkv = ["qkv_proj"] if hasattr(attn, "qkv_proj") else ["q_proj", "k_proj", "v_proj"]
        gu = ["gate_up_proj"] if hasattr(mlp, "gate_up_proj") else ["gate_proj", "up_proj"]
        s_attn = scale_for("attn_in", [_kernel(getattr(attn, n)) for n in qkv])
        s_mlp = scale_for("mlp_in", [_kernel(getattr(mlp, n)) for n in gu])
        s_down = scale_for("down_in", [_kernel(mlp.down_proj)])
        if log is not None:
            log[lname] = record

        for norm, s in ((blk.ln_attn, s_attn), (blk.ln_mlp, s_mlp)):
            norm.weight.copy_(norm.weight.float() / s)
        for n in qkv:
            write(attn, n, _kernel(getattr(attn, n)) * s_attn[:, None])
        for n in gu:
            k = _kernel(getattr(mlp, n)) * s_mlp[:, None]
            if n == "up_proj":
                k = k / s_down[None, :]
            elif n == "gate_up_proj":
                I = k.shape[1] // 2
                k = torch.cat([k[:, :I], k[:, I:] / s_down[None, :]], dim=1)
            write(mlp, n, k)
        write(mlp, "down_proj", _kernel(mlp.down_proj) * s_down[:, None])
    return model


@torch.no_grad()
def quantize_llm_int4_smooth(model, calib_ids, alpha=None, act_amax: Optional[dict] = None,
                             *, log: Optional[dict] = None):
    """Calibrate (one forward over calib_ids) -> smooth (the per-layer alpha
    search by default) -> group int4 (convert.quantize_llm_int4's layout,
    the head left float), in place -> model. `act_amax` (amax vectors or
    activation rows) reuses recorded statistics instead of calibrating."""
    from rlaifv_tpu_torch.models.convert import quantize_llm_int4

    if act_amax is None:
        act_amax = collect_llm_act_stats(model, calib_ids)
    smooth_llm_for_int4(model, act_amax, alpha, quantize=True, log=log)
    return quantize_llm_int4(model)  # o_proj; the smoothed layers are QuantDense already


def calibration_ids(llm_cfg, tokenizer=None) -> np.ndarray:
    """The serving loaders' calibration ids (1, L): CALIBRATION_TEXT through
    the tokenizer when it returns a dict or ids, else a deterministic id
    ramp of 48 (the JAX package's rule, kept as it is), clipped to the
    vocabulary."""
    ids = None
    if tokenizer is not None:
        try:
            enc = tokenizer(CALIBRATION_TEXT)
            raw = enc["input_ids"] if isinstance(enc, dict) else enc
            arr = np.asarray(raw, np.int32)
            ids = arr[None] if arr.ndim == 1 else arr
        except Exception:  # any encoding the rule cannot read: the ramp, as in JAX
            ids = None
    if ids is None:
        ids = (np.arange(48, dtype=np.int32)[None] % max(llm_cfg.vocab_size - 2, 2)) + 1
    return np.clip(ids, 0, llm_cfg.vocab_size - 1)


def smooth_quantize_for_serving(llm_cfg, model, tokenizer=None, alpha: float = 0.5,
                                *, log: Optional[dict] = None):
    """Serving-loader convenience: a float model's language model smoothed
    and quantised to group int4 in place at a fixed alpha (0.5), calibrated
    on `calibration_ids(llm_cfg, tokenizer)` -> model. `llm_cfg` is the
    serving config (its quantize and fuse flags play no part)."""
    cfg_f = dataclasses.replace(llm_cfg, quantize=False, fuse_proj=False)
    return quantize_llm_int4_smooth(model, calibration_ids(cfg_f, tokenizer), alpha, log=log)
