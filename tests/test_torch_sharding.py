"""rlaifv_tpu_torch/parallel/sharding.py against rlaifv_tpu/parallel/sharding.py.

No processes: the spec functions take the mesh's axis sizes, so the port's
`param_specs` of the tiny LLaVA and the tiny OmniLMM (CLIP and EVA02 rules
included) is held, parameter by parameter, to the JAX `param_specs` of the
JAX model's init tree on the 8-device virtual CPU mesh, translated from the
flax layout ((in, out) kernels, the 4-D patch conv) to the torch one. At
(1, 3, 2) `_shrink_spec` drops the fsdp axis, which divides none of the
tiny models' widths. `mesh_shape` repeats the JAX `create_mesh`
arithmetic and assertions; `create_mesh` refuses a mesh smaller than the
world. `shard_batch` gives each rank the JAX addressable shard of the
device at its mesh position, a leaf that does not divide kept whole.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlaifv_tpu.models import omnilmm as jomni
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.parallel import sharding as jsh
from rlaifv_tpu_torch.core import distributed as tdist
from rlaifv_tpu_torch.data.collator import DPOCollator
from rlaifv_tpu_torch.models.convert import _torch_name
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.models.omnilmm import OmniLMMConfig, OmniLMMForCausalLM
from rlaifv_tpu_torch.parallel import sharding as tsh
from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

MESHES = [(1, 8, 1), (1, 4, 2), (2, 2, 2), (1, 2, 2), (1, 3, 2)]


def _jax_llava():
    """The JAX init tree's shapes (the rules read shapes only)."""
    cfg = JLlavaConfig.tiny()
    S = cfg.vision.image_size
    params = jax.eval_shape(
        JLlava(cfg).init, jax.random.PRNGKey(0),
        jnp.ones((1, cfg.num_image_tokens + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))["params"]
    return params, LlavaForCausalLM(LlavaConfig.tiny())


def _jax_omnilmm():
    cfg = jomni.OmniLMMConfig.tiny()
    S = cfg.vision.image_size
    params = jax.eval_shape(
        jomni.OmniLMMForCausalLM(cfg).init, jax.random.PRNGKey(0),
        jnp.ones((1, cfg.num_query + 8), jnp.int32), images=jnp.zeros((1, S, S, 3)),
        image_starts=jnp.asarray([1]))["params"]
    return params, OmniLMMForCausalLM(OmniLMMConfig.tiny())


@pytest.fixture(scope="module", params=["llava15", "omnilmm"])
def models(request):
    return {"llava15": _jax_llava, "omnilmm": _jax_omnilmm}[request.param]()


def _to_torch(spec, leaf: str, ndim: int):
    """A flax-layout JAX spec in the torch layout (written out here, not
    the port's function under test)."""
    spec = tuple(spec)
    if leaf != "kernel" or not spec:
        return spec
    if ndim == 4:  # (kh, kw, 3, C) conv -> the (C, kh*kw*3) Dense
        assert spec[:3] == (None, None, None)
        return (spec[3], None)
    return spec[::-1]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_param_specs_match_jax(models, mesh):
    params, model = models
    jmesh = jsh.create_mesh(*mesh)
    jspecs = jsh.param_specs(params, jmesh)
    want = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        keys = [k.key for k in path]
        leaf = jax.tree_util.keystr(path)  # for messages
        shape = np.shape(params_at(params, keys))
        want[_torch_name(".".join(keys))] = (_to_torch(spec, keys[-1], len(shape)), leaf)
    got = tsh.param_specs(model, dict(zip(tsh.MESH_AXES, mesh)))
    assert set(got) <= set(want)
    for name, spec in got.items():
        assert spec == want[name][0], (name, want[name][1], spec, want[name][0])
    # fsdp 3 divides none of the tiny widths: _shrink_spec drops it
    kept = sum(a is not None for s in got.values() for a in s)
    ruled = sum(a is not None for s in tsh.param_specs(model, (1, 1, 1)).values() for a in s)
    assert (kept < ruled) == (mesh[1] == 3), (kept, ruled)


def params_at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_param_specs_cover_big_axes():
    """The JAX test_param_shardings_cover_big_axes on the port: gate_proj's
    (out, in) weight splits tp on out, fsdp on in; the embedding tp on the
    vocabulary."""
    specs = tsh.param_specs(LlavaForCausalLM(LlavaConfig.tiny()), (1, 4, 2))
    assert specs["llm.model.layers.0.mlp.gate_proj.weight"] == ("tp", "fsdp")
    assert specs["llm.model.layers.0.mlp.down_proj.weight"] == ("fsdp", "tp")
    assert specs["llm.model.tok_embed.weight"] == ("tp", "fsdp")
    assert specs["llm.model.ln_f.weight"] == ()


@pytest.mark.parametrize("dp,fsdp,tp,n", [
    (1, None, 1, 8), (2, None, 2, 8), (1, 2, 2, 8), (2, 2, 2, 8), (1, None, 1, 1),
    (1, None, 3, 8), (2, 4, 2, 8), (3, None, 1, 8)])
def test_mesh_shape_repeats_the_jax_arithmetic(dp, fsdp, tp, n):
    devices = jax.devices()[:n]
    try:
        want = tuple(jsh.create_mesh(dp, fsdp, tp, devices=devices).devices.shape)
    except AssertionError:
        with pytest.raises(AssertionError):
            tsh.mesh_shape(dp, fsdp, tp, n)
        return
    assert tsh.mesh_shape(dp, fsdp, tp, n) == want


def test_create_mesh_refuses_a_mesh_smaller_than_the_world(monkeypatch):
    """Deliberate: JAX would run such a mesh on the first devices; the port
    has a process a device, each of which must be in the mesh."""
    monkeypatch.setattr(tdist, "process_count", lambda: 2)
    with pytest.raises(ValueError, match=r"training.mesh_fsdp=1.*2 processes"):
        tsh.create_mesh(1, 1, 1, device_type="cpu")


def _batch():
    cfg = LlavaConfig.tiny()
    coll = DPOCollator(pad_token_id=0, max_len=64, num_patches=cfg.num_image_tokens)
    batch = coll(synth_preference_pairs(cfg, 4, answer_len=6, question_len=4))
    batch["odd"] = np.arange(15, dtype=np.float32).reshape(3, 5)  # 3 rows: kept whole
    return batch


@pytest.mark.parametrize("mesh", [(1, 4, 1), (2, 2, 1), (1, 2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_shard_batch_is_the_jax_addressable_shard(mesh):
    batch = _batch()
    jmesh = jsh.create_mesh(*mesh)
    sharded = jsh.shard_batch(batch, jmesh)
    devices = list(jmesh.devices.flat)
    for rank, device in enumerate(devices):
        got = tsh.shard_batch(batch, dict(zip(tsh.MESH_AXES, mesh)), rank=rank)
        assert set(got) == set(batch)
        for key, arr in sharded.items():
            want = next(s.data for s in arr.addressable_shards if s.device == device)
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want), err_msg=key)


@pytest.mark.parametrize("mesh", [(1, 2, 1), (2, 2, 1), (1, 2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_shard_pairs_keeps_each_pair_on_one_rank(mesh):
    """The trainer's split: every pair on exactly one data index, its win
    and rej rows together, the tp ranks of one data index alike."""
    batch = _batch()
    B = batch["input_ids"].shape[0] // 2
    sizes = dict(zip(tsh.MESH_AXES, mesh))
    seen = []
    for rank in range(int(np.prod(mesh))):
        got = tsh.shard_pairs(batch, sizes, rank=rank)
        b = got["input_ids"].shape[0] // 2
        rows = [int(np.where((batch["input_ids"][:B] == r).all(1))[0][0])
                for r in got["input_ids"][:b]]
        np.testing.assert_array_equal(got["input_ids"][b:], batch["input_ids"][B:][rows])
        np.testing.assert_array_equal(got["images"], batch["images"][rows])
        np.testing.assert_array_equal(got["odd"], batch["odd"])
        assert got["beta"] == batch["beta"]
        if rank % mesh[2] == 0:
            seen += rows
    assert sorted(seen) == list(range(B))
