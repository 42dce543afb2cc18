"""The port's SigLIP tower (models/siglip.py) against the JAX package's, on
the CPU.

A flax SigLIP tree (tiny widths, fp32) is bridged into the torch tower with
`load_jax_params`; the same numpy-seeded slices go through both:

- at the table's grid (28 px, 4 x 4 patches: no re-grid) and on
  non-square (gh, gw) grids, shrinking and stretching the position table
  (jax.image.resize's bicubic, one weight matrix an axis), within 1e-5
  absolute;
- `regrid_pos` alone against jax.image.resize on a so400m-sized 70 x 70
  table cut to MiniCPM-V slice grids, within 1e-5 of a unit-normal table;
- `convert_siglip` on a tiny HF-layout state dict (and under an extra
  `vision_model.` nesting), equal to the JAX converter's tree, and the
  converted tower's features equal to the JAX tower's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import siglip as jsig
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import siglip as tsig

ATOL = 1e-5


@pytest.fixture(scope="module")
def towers():
    cfg = jsig.SiglipVisionConfig.tiny()
    jmod = jsig.SiglipVisionTower(cfg)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))["params"]
    # norms and biases off their init values, the table well away from 0
    params = jax.tree.map(lambda a: np.asarray(a + 0.1 * jnp.sin(
        jnp.arange(a.size).reshape(a.shape))), params)
    params["pos_embed"] = np.random.default_rng(3).standard_normal(
        params["pos_embed"].shape).astype(np.float32)
    tmod = tconvert.load_jax_params(tsig.SiglipVisionTower(tsig.SiglipVisionConfig.tiny()),
                                    params).eval()
    return jmod, params, tmod


# (H, W) in pixels at patch 7: the table's own 4 x 4 grid, then re-grids
@pytest.mark.parametrize("hw", [(28, 28), (21, 35), (42, 14), (56, 56)])
def test_tower_matches_jax(towers, hw):
    jmod, params, tmod = towers
    img = np.random.default_rng(hw[0] * 100 + hw[1]).standard_normal(
        (2, hw[0], hw[1], 3)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(img)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(img)).numpy()
    assert got.shape == (2, (hw[0] // 7) * (hw[1] // 7), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_block_count_and_presets():
    tower = tsig.SiglipVisionTower(tsig.SiglipVisionConfig.tiny(num_layers=3))
    assert len(tower.layers) == 3 and tower.pos_embed.shape == (16, 32)
    t, j = tsig.SiglipVisionConfig.so400m(), jsig.SiglipVisionConfig.so400m()
    for f in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "layer_norm_eps"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.grid == 70 and t.hidden_size // t.num_heads == 72


# MiniCPM-V 2.5 slice grids at 448 px budget: (32, 32) for a square slice,
# the source of examples/test.jpeg and two slices of a 2 x 2 grid
@pytest.mark.parametrize("gh,gw", [(32, 32), (26, 40), (34, 20), (70, 35)])
def test_regrid_pos_matches_jax_resize(gh, gw):
    table = np.random.default_rng(gh * 100 + gw).standard_normal((70 * 70, 16))
    table = table.astype(np.float32)
    want = jax.image.resize(jnp.asarray(table).reshape(1, 70, 70, 16), (1, gh, gw, 16),
                            method="bicubic").reshape(gh * gw, 16)
    got = tsig.regrid_pos(torch.from_numpy(table), gh, gw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    half = tsig.regrid_pos(torch.from_numpy(table).to(torch.bfloat16), gh, gw)
    assert half.dtype == torch.bfloat16


def _hf_siglip_sd(prefix: str) -> dict:
    """A tiny HF-layout SigLIP state dict (numpy, from a seed)."""
    rng = np.random.default_rng(5)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa: E731
    D, I, P = 32, 64, 7
    sd = {"embeddings.patch_embedding.weight": r(D, 3, P, P),
          "embeddings.patch_embedding.bias": r(D),
          "embeddings.position_embedding.weight": r(16, D),
          "post_layernorm.weight": 1 + r(D), "post_layernorm.bias": r(D)}
    for i in range(2):
        p = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{name}.weight"] = r(D, D)
            sd[p + f"self_attn.{name}.bias"] = r(D)
        sd.update({p + "layer_norm1.weight": 1 + r(D), p + "layer_norm1.bias": r(D),
                   p + "layer_norm2.weight": 1 + r(D), p + "layer_norm2.bias": r(D),
                   p + "mlp.fc1.weight": r(I, D), p + "mlp.fc1.bias": r(I),
                   p + "mlp.fc2.weight": r(D, I), p + "mlp.fc2.bias": r(D)})
    return {prefix + k: v for k, v in sd.items()}


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("prefix", ["vpm.", "vpm.vision_model."])
def test_convert_siglip_equals_jax(prefix):
    sd = _hf_siglip_sd(prefix)
    got, want = tconvert.convert_siglip(sd), jconvert.convert_siglip(sd)
    _assert_trees_equal(got, want)
    assert set(got) == {"patch_embed", "pos_embed", "layer_0", "layer_1", "post_ln"}
    tmod = tconvert.load_jax_params(tsig.SiglipVisionTower(tsig.SiglipVisionConfig.tiny()),
                                    got).eval()
    img = np.random.default_rng(6).standard_normal((1, 21, 35, 3)).astype(np.float32)
    ref = jsig.SiglipVisionTower(jsig.SiglipVisionConfig.tiny()).apply(
        {"params": want}, jnp.asarray(img))
    with torch.no_grad():
        out = tmod(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=ATOL)
