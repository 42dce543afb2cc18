"""The bytes one rank holds for a full fine-tune over a (dp, fsdp, tp) mesh,
from the sharding rules alone (parallel/sharding.py): no weights, no
process group, no card.

For each config (configs/llava15_dpo.json's LLaVA-1.5-7B and
configs/omnilmm_dpo.json's OmniLMM-12B by default) the model is built on
the meta device by the entry point's builder, and for each mesh every
parameter's local size is read off `param_specs`: a tp axis divides its
dim, and the fsdp axis divides the dim its rule names, or dim 0 (rounded
up) where the rule replicates the leaf, since FSDP2 splits every
parameter of a unit. It prints, a line a mesh, the GiB a rank holds for
the parameters, the gradients and the two AdamW moments (all in the
parameter dtype, as train/train_step.py keeps them) and their sum, and
the working set gathered whole during a step: the root unit (everything
outside the decoder and vision blocks: the embedding, the head, the
projector or resampler, the towers' stems) and the largest block, each
with its gradients. The first line of each config gives the same sums at
one device.

    python3 tools/shard_bytes.py [--config CFG ...] [--mesh DP,FSDP,TP ...]
"""
import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GIB = 2 ** 30


def local_numel(shape, spec, sizes) -> int:
    """Elements of one rank's shard: tp divides its dim exactly (the rules
    checked it), fsdp its dim or dim 0, rounded up."""
    from rlaifv_tpu_torch.parallel.sharding import spec_dim

    dims = list(shape)
    t = spec_dim(spec, "tp")
    if t is not None:
        dims[t] //= sizes["tp"]
    if dims:
        f = spec_dim(spec, "fsdp")
        f = 0 if f is None else f
        dims[f] = math.ceil(dims[f] / sizes["fsdp"])
    return math.prod(dims)


def report(config_path: str, meshes) -> None:
    import torch

    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.parallel.sharding import _unit_modules, param_specs
    from rlaifv_tpu_torch.train.__main__ import MODEL_BUILDERS

    config = Config.from_json(config_path)
    _, model = MODEL_BUILDERS[config.model.model_family](config, torch.device("meta"))
    params = dict(model.named_parameters())
    units = [{id(p) for p in u.parameters()} for u in _unit_modules(model)]
    in_units = set().union(*units)

    specs_at = {}

    def gib(names, sizes, fsdp: bool = True) -> float:
        """GiB of these parameters on one rank (fsdp=False: gathered whole
        over the data axes, still tp slices)."""
        key = tuple(sizes.values())
        if key not in specs_at:
            specs_at[key] = param_specs(model, sizes)
        specs = specs_at[key]
        s = dict(sizes, fsdp=sizes["fsdp"] if fsdp else 1)
        return sum(local_numel(params[n].shape, specs[n], s) * params[n].element_size()
                   for n in names) / GIB

    everything = list(params)
    root = [n for n in params if id(params[n]) not in in_units]
    blocks = [[n for n in params if id(params[n]) in u] for u in units]
    name = Path(config_path).name
    one = gib(everything, dict(dp=1, fsdp=1, tp=1))
    print(f"{name}: {type(model).__name__}, {sum(p.numel() for p in params.values()) / 1e9:.3f}"
          f" B parameters ({config.model.param_dtype}); one device: parameters {one:.2f} GiB, "
          f"gradients {one:.2f}, AdamW moments {2 * one:.2f}, sum {4 * one:.2f} GiB")
    for mesh in meshes:
        sizes = dict(zip(("dp", "fsdp", "tp"), mesh))
        local = gib(everything, sizes)
        whole = gib(root, sizes, False) + max(gib(b, sizes, False) for b in blocks)
        print(f"{name} at (dp, fsdp, tp) = {mesh}: a rank holds parameters {local:.2f} GiB, "
              f"gradients {local:.2f}, AdamW moments {2 * local:.2f}, sum {4 * local:.2f} GiB; "
              f"gathered whole during a step, with their gradients: the root unit "
              f"{2 * gib(root, sizes, False):.2f} GiB and the largest block "
              f"{2 * max(gib(b, sizes, False) for b in blocks):.2f}; in all "
              f"{4 * local + 2 * whole:.2f} GiB before activations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append",
                    default=None, help="a training config (repeatable)")
    ap.add_argument("--mesh", action="append", default=None,
                    help="DP,FSDP,TP (repeatable; default 1,4,1 and 1,2,2)")
    args = ap.parse_args()
    configs = args.config or [str(ROOT / "configs" / "llava15_dpo.json"),
                              str(ROOT / "configs" / "omnilmm_dpo.json")]
    meshes = [tuple(int(x) for x in m.split(",")) for m in (args.mesh or ["1,4,1", "1,2,2"])]
    for c in configs:
        report(c, meshes)


if __name__ == "__main__":
    main()
