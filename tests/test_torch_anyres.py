"""The port's anyres merge (models/anyres.py, LLaVA-1.6 grids) against the
JAX package's, on the CPU.

- `merge_anyres_features` and `unpad_grid` (numpy copies, also pinned in
  tests/test_torch_data_copies.py) equal the JAX functions on every merge
  type and on wide, tall and square sources.
- The device merge (`merge_anyres_device`: one gather by `merge_index`,
  the newline rows filled) equals the numpy merge bit for bit, fp32 and
  bf16.
- `encode_anyres` on a tiny anyres LLaVA (the views through the port's
  `encode_images` in one batch, merged on the device) against the JAX
  `encode_anyres` on the same weights: atol 1e-5 x max(1, max|ref|) (fp32
  sums in another order); the grid picked and T follow the JAX geometry.
- An anyres configuration builds the model (the constructor's raise is
  lifted; the JAX model computes the same for any aspect ratio).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.data.image_processing import ClipImageProcessor as JProcessor
from rlaifv_tpu.models import anyres as janyres
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor
from rlaifv_tpu_torch.models import anyres as tanyres
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

ENCODE_ATOL = 1e-5


def _anyres(S):
    """LLaVA-1.6's grid settings at a view side of S pixels."""
    pins = [[S, S], [S, 2 * S], [2 * S, S], [2 * S, 2 * S]]
    return dict(image_aspect_ratio="anyres", image_grid_pinpoints=pins,
                mm_patch_merge_type="spatial_unpad")


# (views, grid (nw, nh), merge type, original size (w, h))
CASES = [
    (5, (2, 2), "spatial_unpad", (80, 60)),   # wide: rows cropped
    (3, (1, 2), "spatial_unpad", (300, 900)),  # tall: columns cropped
    (5, (2, 2), "spatial_unpad", (500, 500)),  # square: nothing cropped
    (7, (3, 2), "spatial", None),
    (3, (2, 1), "flat", None),
]


def _views(n, side=3, D=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, side * side, D)).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[2]}-{c[1]}-{c[3]}" for c in CASES])
def test_merge_matches_jax_and_the_device_merge(case):
    n, grid, merge_type, size = case
    views = _views(n)
    newline = np.full(4, 7.0, np.float32)
    kw = dict(merge_type=merge_type, original_size=size, image_newline=newline)
    want = janyres.merge_anyres_features(views, grid, **kw)
    np.testing.assert_array_equal(tanyres.merge_anyres_features(views, grid, **kw), want)
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.from_numpy(views).to(dtype)
        got = tanyres.merge_anyres_device(feats, grid, **kw)
        ref = tanyres.merge_anyres_features(feats.float().numpy(), grid, **kw)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), ref)
    if merge_type == "spatial_unpad":
        grid_img = np.arange(8 * 12).reshape(8, 12, 1).astype(np.float32)
        np.testing.assert_array_equal(tanyres.unpad_grid(grid_img, size),
                                      janyres.unpad_grid(grid_img, size))


@pytest.mark.parametrize("size", [(80, 60), (30, 70)], ids=["wide", "tall"])
def test_encode_anyres_matches_jax(size):
    jcfg = JLlavaConfig.tiny()
    jcfg = JLlavaConfig(llm=jcfg.llm, vision=jcfg.vision, **_anyres(jcfg.vision.image_size))
    P, S = jcfg.num_image_tokens, jcfg.vision.image_size
    jmodel = JLlava(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
                         images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))["params"]
    tcfg = LlavaConfig.tiny()
    tcfg = LlavaConfig(llm=tcfg.llm, vision=tcfg.vision, **_anyres(S))
    model = load_jax_params(LlavaForCausalLM(tcfg), params).eval()
    image = np.random.default_rng(1).integers(0, 255, size=(size[1], size[0], 3),
                                              dtype=np.uint8)
    newline = np.random.default_rng(2).normal(size=tcfg.llm.hidden_size).astype(np.float32)
    want = janyres.encode_anyres(jmodel, params, JProcessor(image_size=S), jcfg, image,
                                 image_newline=newline)
    got = tanyres.encode_anyres(model, ClipImageProcessor(image_size=S), tcfg, image,
                                image_newline=newline)
    assert got.shape == want.shape and want.shape[0] > P
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ENCODE_ATOL * max(1.0, float(np.abs(want).max())))
    assert (got.numpy() == newline).all(axis=1).sum() == (want == newline).all(axis=1).sum() > 0
    with pytest.raises(ValueError, match="image_newline"):
        tanyres.encode_anyres(model, ClipImageProcessor(image_size=S), tcfg, image)
