"""The port's AWQ-style smoothing (models/quant_smooth.py) against the JAX
package's, on the CPU at fp32.

- The error model's pieces (`_quant_dequant`, `_act_quant`) equal the JAX
  numpy functions bit for bit (IEEE divisions, round half to even), and
  `_smooth_scale` is the JAX function's code.
- `collect_llm_act_stats` (forward hooks) against the JAX
  `capture_intermediates`, unfused and fused models: within 1e-5 of each
  producer's max|activation| (fp32 sums in another order).
- `smooth_llm_for_int4` on the same statistics (the JAX ones, so the inputs
  are equal), at alpha 0.5 and with the alpha search, unfused and fused: the
  float folds equal the JAX tree exactly; `quantize_llm_int4_smooth` gives
  the JAX `quantize_llm_int4(smooth_llm_for_int4(...))`'s packed int4
  integers and group scales bit for bit. The search's choice per group is
  the JAX one; where the JAX errors of the two choices lie within 1e-6
  relative of each other either passes (the sums run in another order),
  and that group's kernels are then not compared.
- The exact-fold property (tests/test_quant_smooth.py:59): the smoothed
  float model's logits equal the unsmoothed ones within 2e-4.
- `smooth_quantize_for_serving` (fixed alpha 0.5, calibrated by the
  port's own forward) and the quantised model's logits against the JAX
  QuantDense model on the JAX tree (atol 1e-4).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import quant_smooth as jqs
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import quant_smooth as tqs
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, QuantDense
from tests.fake_tokenizer import FakeTokenizer
from tests.test_quant_smooth import _structured_params

# K = 128 for q/k/v and gate/up, 256 for down: groups of 128 in both rules
TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=2, max_position_embeddings=128)
STATS_RTOL = 1e-5
TIE_RTOL = 1e-6
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jmodel, params = _structured_params(JLlamaConfig(**TINY), seed=9)
    ids = np.random.default_rng(13).integers(5, 500, size=(2, 16)).astype(np.int32)
    stats = jqs.collect_llm_act_stats(jmodel, params, jnp.asarray(ids))
    return jmodel, params, ids, stats


def _port(params, fused=False):
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    tconvert.load_jax_params(model, params).eval()
    return tconvert.fuse_llm_projections_(model) if fused else model


def _jax_tree(params, fused):
    return jconvert.fuse_llm_projections(copy.deepcopy(params)) if fused else params


def _jax_int4(tree):
    """The JAX package's int4 tree of a smoothed float tree:
    `quantize_llm_int4`, and the fused projections (which its walk leaves
    float: the JAX serving loaders quantise before fusing) by the same
    numpy quantiser, `ops/int4_matmul.py:quantize_int4`."""
    from rlaifv_tpu.ops.int4_matmul import pick_int4_group, quantize_int4

    out = jconvert.quantize_llm_int4(copy.deepcopy(tree))
    for lname, layer in out["model"].items():
        for blk, name in (("attn", "qkv_proj"), ("mlp", "gate_up_proj")):
            mod = layer[blk].get(name) if lname.startswith("layer_") else None
            if mod is not None and "scale" not in mod:
                kernel = np.asarray(mod["kernel"], np.float32)
                q, scale = quantize_int4(kernel, pick_int4_group(kernel.shape[0]))
                layer[blk][name] = {"kernel": q, "scale": scale}
    return out


def _flat(tree) -> dict:
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in tconvert._flatten(tree)}


def test_error_model_pieces_match_jax():
    rng = np.random.default_rng(0)
    for K, N in ((256, 96), (96, 40)):  # groups of 128; one group of K
        w = (rng.normal(size=(K, N)) * np.exp(rng.normal(0, 0.5, (K, 1)))).astype(np.float32)
        np.testing.assert_array_equal(tqs._quant_dequant(torch.from_numpy(w)).numpy(),
                                      jqs._quant_dequant(w))
    x = (rng.normal(size=(33, 128)) * 3).astype(np.float32)
    x[4] = 0.0  # a zero row: the 1e-20 floor
    np.testing.assert_array_equal(tqs._act_quant(torch.from_numpy(x)).numpy(), jqs._act_quant(x))
    a, w = np.abs(x).max(axis=0), np.abs(rng.normal(size=128)).astype(np.float32)
    for alpha in jqs._ALPHAS:
        np.testing.assert_array_equal(tqs._smooth_scale(a, w, alpha),
                                      jqs._smooth_scale(a, w, alpha))
    assert tqs._ALPHAS == jqs._ALPHAS


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_act_stats_match_jax(setup, fused):
    jmodel, params, ids, _ = setup
    if fused:
        jmodel = JLlama(JLlamaConfig(**TINY, fuse_proj=True))
    want = jqs.collect_llm_act_stats(jmodel, _jax_tree(params, fused), jnp.asarray(ids))
    got = tqs.collect_llm_act_stats(_port(params, fused), ids)
    assert set(got) == set(want) == {"layer_0", "layer_1"}
    for lname, rec in want.items():
        assert set(got[lname]) == set(rec) == {"attn_in", "mlp_in", "down_in"}
        for key, ref in rec.items():
            out = got[lname][key].numpy()
            assert out.shape == ref.shape == (32, ref.shape[1])
            np.testing.assert_allclose(out, ref, rtol=0,
                                       atol=STATS_RTOL * float(np.abs(ref).max()))
    amax = tqs.collect_llm_act_amax(_port(params, fused), ids)
    np.testing.assert_allclose(amax["layer_1"]["down_in"].numpy(),
                               np.abs(want["layer_1"]["down_in"]).max(axis=0), rtol=STATS_RTOL)


def _jax_errors(params, stats, fused):
    """The JAX search's error of every alpha for each (layer, group), by the
    JAX numpy helpers (the computation of `_search_scale`, deterministic),
    with its choice checked against `_search_scale` itself."""
    tree = _jax_tree(params, fused)["model"]
    out = {}
    for lname, rec in stats.items():
        attn, mlp = tree[lname]["attn"], tree[lname]["mlp"]
        groups = {
            "attn_in": [attn[m]["kernel"] for m in (["qkv_proj"] if fused
                                                   else ["q_proj", "k_proj", "v_proj"])],
            "mlp_in": [mlp[m]["kernel"] for m in (["gate_up_proj"] if fused
                                                 else ["gate_proj", "up_proj"])],
            "down_in": [mlp["down_proj"]["kernel"]],
        }
        for key, kernels in groups.items():
            x = rec[key]
            kernels = [np.asarray(w, np.float32) for w in kernels]
            act, wmax = np.abs(x).max(axis=0), np.max(np.stack(
                [np.abs(w).max(axis=1) for w in kernels]), axis=0)
            errs = []
            for a in jqs._ALPHAS:
                s = jqs._smooth_scale(act, wmax, a)
                xs = jqs._act_quant(x / s[None, :])
                errs.append(sum(float(((xs @ jqs._quant_dequant(w * s[:, None]) - x @ w) ** 2)
                                      .mean()) for w in kernels))
            best = int(np.argmin(errs))
            np.testing.assert_array_equal(jqs._search_scale(x, kernels, None),
                                          jqs._smooth_scale(act, wmax, jqs._ALPHAS[best]))
            out[(lname, key)] = errs
    return out


_GROUP_OF = {"q_proj": "attn_in", "k_proj": "attn_in", "v_proj": "attn_in",
             "qkv_proj": "attn_in", "gate_proj": "mlp_in", "gate_up_proj": "mlp_in",
             "up_proj": "mlp_in", "down_proj": "down_in", "ln_attn": "attn_in",
             "ln_mlp": "mlp_in"}


def _tied_groups(log, errs) -> set:
    """The (layer, group)s whose chosen alpha differs from the JAX one,
    each asserted to be a near-tie of the JAX errors."""
    tied = set()
    for lname, rec in log.items():
        for key, (alpha, _) in rec.items():
            e = errs[(lname, key)]
            jbest = int(np.argmin(e))
            got = jqs._ALPHAS.index(alpha)
            if got != jbest:
                assert abs(e[got] - e[jbest]) <= TIE_RTOL * e[jbest], (lname, key, e)
                tied.add((lname, key))
    return tied


def _skip(path: str, tied: set) -> bool:
    """A leaf of a tied group, or up_proj's columns folded by a tied down
    group."""
    parts = path.split(".")
    lname = next((p for p in parts if p.startswith("layer_")), None)
    mod = parts[-2]
    keys = {_GROUP_OF.get(mod)} | ({"down_in"} if mod in ("up_proj", "gate_up_proj") else set())
    return any((lname, k) in tied for k in keys)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("alpha", [0.5, None], ids=["alpha0.5", "search"])
def test_smoothed_int4_tree_matches_jax(setup, alpha, fused):
    _, params, _, stats = setup
    jtree = _jax_tree(params, fused)
    want_f = jqs.smooth_llm_for_int4(jtree, stats, alpha)
    want_q = _jax_int4(want_f)
    log_f, log_q = {}, {}
    smoothed = tqs.smooth_llm_for_int4(_port(params, fused), stats, alpha, log=log_f)
    quant = tqs.quantize_llm_int4_smooth(_port(params, fused), None, alpha, act_amax=stats,
                                         log=log_q)
    assert log_f == log_q and set(log_q) == set(stats)
    tied = set()
    if alpha is None:
        tied = _tied_groups(log_q, _jax_errors(params, stats, fused))
        assert all(e is not None and len(e) == 4 for r in log_q.values() for _, e in r.values())
    else:
        assert all(r == {k: (0.5, None) for k in r} for r in log_q.values())
    cfg = quant.cfg
    assert (cfg.quantize, cfg.quantize_bits, cfg.quantize_lm_head) == (True, 4, False)
    assert isinstance(quant.model.layers[0].attn.o_proj, QuantDense)
    assert quant.lm_head.weight.dtype == torch.float32
    for got, want in ((_flat(tconvert.flax_tree(smoothed)), _flat(want_f)),
                      (_flat(tconvert.flax_tree(quant)), _flat(want_q))):
        assert got.keys() == want.keys()
        compared = 0
        for path, ref in want.items():
            if _skip(path, tied):
                continue
            np.testing.assert_array_equal(got[path], ref, err_msg=path)
            compared += 1
        assert compared >= len(want) - 8 * len(tied)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_smoothing_is_exact_fold(setup, fused):
    _, params, ids, stats = setup
    model = _port(params, fused)
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        want = model(ids_t)[0]
        tqs.smooth_llm_for_int4(model, tqs.collect_llm_act_stats(model, ids), alpha=0.5)
        got = model(ids_t)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    assert not torch.equal(model.model.layers[0].ln_attn.weight,
                           torch.ones_like(model.model.layers[0].ln_attn.weight))


def test_serving_smoothing_and_model_match_jax(setup):
    """smooth_quantize_for_serving with the fake tokenizer (whose encoding is
    neither a dict nor ids: the JAX rule's id ramp) on the port's own
    calibration forward: the int4 model's logits equal the JAX QuantDense
    model's on the JAX tree, and the alpha is fixed at 0.5."""
    _, params, ids, _ = setup
    tok = FakeTokenizer()
    jcfg = JLlamaConfig(**TINY, quantize=True, quantize_bits=4, quantize_lm_head=False)
    jtree = jqs.smooth_quantize_for_serving(jcfg, params, tok)
    ramp = tqs.calibration_ids(LlamaConfig(**TINY), tok)
    assert ramp.shape == (1, 48) and ramp[0, 0] == 1
    log = {}
    model = tqs.smooth_quantize_for_serving(LlamaConfig(**TINY), _port(params), tok, log=log)
    assert {a for r in log.values() for a, _ in r.values()} == {0.5}
    want = np.asarray(JLlama(jcfg).apply({"params": jtree}, jnp.asarray(ids))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="float"):
        tqs.collect_llm_act_stats(model, ids)
