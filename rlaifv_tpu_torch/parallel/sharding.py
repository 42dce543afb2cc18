"""Device mesh and parameter sharding rules on torch.distributed.

Counterpart of rlaifv_tpu/parallel/sharding.py. The JAX package runs one
controller over a (dp, fsdp, tp) device mesh and lets GSPMD place every
leaf by PARAM_RULES; the port runs one process per device (torchrun) and
applies the same rules by hand:

- `create_mesh` builds a `DeviceMesh` named ("dp", "fsdp", "tp") over the
  processes, row-major as the JAX `reshape(dp, fsdp, tp)`; its axis groups
  use NCCL on the card and gloo on the CPU (core/distributed.py).
- `PARAM_RULES`, `spec_for_path`, `_shrink_spec` and `param_specs` are the
  JAX functions over a parameter's flax path (models/convert.py's naming),
  its shape and the mesh's axis sizes, with the spec translated to the
  torch layout: a flax (in, out) kernel is a torch (out, in) weight, and
  the (kh, kw, 3, C) patch conv is the towers' 2-D (C, kh*kw*3) Dense.
- `shard_params` applies them. The tp axis is Megatron's tensor
  parallelism on plain tensors: a Dense whose weight is split on its
  output dim is column-parallel, on its input dim row-parallel (its partial
  products summed over tp), the embedding is vocabulary-parallel. Where the
  consumer takes the local slice (attention over its local heads, the MLP's
  down projection) nothing is gathered; elsewhere a column-parallel output
  is all-gathered and a row-parallel input sliced, which is the placement
  GSPMD chooses for such a leaf. A weight-only quantised projection
  (QuantDense) splits its flax-layout `q`/`scale` buffers the same way and
  computes through the int8/int4 kernels at its local N or K. The data axes are FSDP2 (`fully_shard`,
  ZeRO-3): one unit per decoder and vision block and the root for the rest,
  each parameter split on the dim its rule gives fsdp (`shard_placement_fn`),
  replicated over dp (HSDP). `MeshPlan` keeps what was done, for the
  global norm (`global_norm`), metric means, LoRA gradients and checkpoints.
- `serving_call` runs a serving entry point (genai/engine.py; `serving`
  decorates them) on a sharded model: one forward of the root unit, each
  unit gathered once.
- `shard_batch` is the JAX function over host arrays: the rows of this
  rank's data index (rank // tp) as a contiguous block, a leaf whose leading
  dim does not divide replicated. `shard_pairs` applies it to each half of a
  collated DPO batch (win rows, rej rows), so a rank keeps whole pairs.

Deliberate differences from the JAX module: every process must be in the
mesh (a mesh smaller than the world raises ValueError, where JAX would use
the first devices only); a leaf the rules replicate is still split on dim 0
inside its FSDP unit (FSDP2 has no replicated leaf; the math is the same);
a column-parallel projection whose consumer takes the local slice stores its
bias as its tp slice; a fused qkv/gate_up projection splits each of its
parts over tp (its rule's contiguous split would cut across q, k and v);
the fused head gathers the head weight over tp before its kernels (GSPMD
does the same around a custom call); the embedding, the head and the
projector stay in the root unit, whole for the length of a step, since the
lookup and the fused head read their weights outside a module's forward.
`pin_batch_activation` has no counterpart: a rank computes on its own rows
only, so there is no activation layout to pin. A QuantDense holds its
tp slice of the integers and scales quantised from the whole kernel; an
int4 projection splits on K only where its groups divide over tp
(`(K / G) % tp == 0`: the packed layout is group-local, so a row slice is
a K slice only in whole groups), else it stays whole and its pair is not
local, where the JAX package splits through the groups. FSDP2 leaves
buffers whole, so the `q`/`scale` buffers are not split over the data
axes.
"""
from __future__ import annotations

import re
import types
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MESH_AXES = ("dp", "fsdp", "tp")

Spec = Tuple[Any, ...]  # a PartitionSpec as a tuple: axis name, tuple of names, or None

# (pattern, spec), first match wins; the JAX PARAM_RULES, flax layout
PARAM_RULES: List[Tuple[str, Spec]] = [
    (r"tok_embed/embedding$", ("tp", "fsdp")),
    (r"attn/(q_proj|k_proj|v_proj|qkv_proj)/kernel$", ("fsdp", "tp")),
    (r"attn/(o_proj|out_proj)/kernel$", ("tp", "fsdp")),
    (r"mlp/(gate_proj|up_proj|gate_up_proj)/kernel$", ("fsdp", "tp")),
    (r"mlp/down_proj/kernel$", ("tp", "fsdp")),
    (r"lm_head/kernel$", ("fsdp", "tp")),
    (r"(fc1|fc\d+)/kernel$", ("fsdp", "tp")),
    (r"fc2/kernel$", ("tp", "fsdp")),
    (r"patch_embed/kernel$", (None, None, None, "fsdp")),
    (r"pos_embed$", (None, "fsdp")),
    (r"(bias|scale|cls_token)$", ()),
]

# activation sharding: batch over (dp, fsdp), the ZeRO data axis
BATCH_SPEC: Spec = (("dp", "fsdp"),)

MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", Mapping[str, int], Sequence[int]]


# ------------------------------------------------------------------ mesh


def mesh_shape(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
               n: int = 1) -> Tuple[int, int, int]:
    """The JAX create_mesh's arithmetic over n devices: fsdp=None absorbs
    the devices dp*tp leaves, and the mesh may not exceed n."""
    if fsdp is None:
        assert n % (dp * tp) == 0, f"{n} devices not divisible by dp*tp={dp * tp}"
        fsdp = n // (dp * tp)
    need = dp * fsdp * tp
    assert need <= n, f"mesh dp*fsdp*tp={need} exceeds {n} devices"
    return dp, fsdp, tp


def create_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
                device_type: str = "cuda", backend: Optional[str] = None):
    """A (dp, fsdp, tp) DeviceMesh over every process of the group (one
    device each): rank r sits at the row-major position r of (dp, fsdp, tp);
    its groups NCCL on "cuda", gloo on "cpu" or as `backend` says. A mesh
    smaller than the world raises ValueError (deliberate: JAX would leave
    the other devices idle, here they would be processes outside every
    collective)."""
    from rlaifv_tpu_torch.core import distributed as dist

    n = dist.process_count()
    shape = mesh_shape(dp, fsdp, tp, n)
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"the mesh dp*fsdp*tp = {'*'.join(map(str, shape))} = {int(np.prod(shape))} "
            f"(training.mesh_dp={dp}, training.mesh_fsdp={fsdp}, training.mesh_tp={tp}) "
            f"does not cover the {n} processes: the port runs one process a device and "
            f"every process must be in the mesh; set training.mesh_fsdp to null to take "
            f"them all, or launch {int(np.prod(shape))} processes")
    return dist.device_mesh(shape, MESH_AXES, device_type, backend)


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{"dp": .., "fsdp": .., "tp": ..} of a DeviceMesh, a mapping or a
    (dp, fsdp, tp) tuple: the spec functions need nothing else."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh[a]) for a in MESH_AXES}
    if isinstance(mesh, (tuple, list)):
        return dict(zip(MESH_AXES, map(int, mesh)))
    return dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))


# ------------------------------------------------------------------ specs


def spec_for_path(path: str, rules=None) -> Spec:
    for pat, spec in rules or PARAM_RULES:
        if re.search(pat, path):
            return spec
    return ()


def _shrink_spec(spec: Spec, shape, mesh: MeshLike) -> Spec:
    """Drop axes that don't divide the dim (tiny test models, odd vocab)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        size = int(np.prod([sizes[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
        out.append(axis if shape[i] % size == 0 else None)
    return tuple(out)


def torch_layout(spec: Spec, kind: str, ndim: int) -> Spec:
    """A flax-layout spec in the torch parameter's layout: a Dense kernel
    (in, out) is the weight (out, in); the 4-D (kh, kw, 3, C) patch conv is
    the 2-D (C, kh*kw*3) weight (its rule splits only C)."""
    if kind != "kernel" or not spec:
        return tuple(spec)
    if len(spec) == 4:
        if any(a is not None for a in spec[:3]):
            raise ValueError(f"a conv kernel spec {spec} splits a flattened dim")
        return (spec[3], None)
    if len(spec) == 2 and ndim == 2:
        return (spec[1], spec[0])
    return tuple(spec)


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """torch parameter name -> (its flax path, its flax leaf name)."""
    from rlaifv_tpu_torch.models.convert import _flax_module_path, flax_leaf_names

    out = {}
    for name, leaf in flax_leaf_names(model).items():
        module = name.rsplit(".", 1)[0] if "." in name else ""
        prefix = _flax_module_path(module) + "/" if module else ""
        out[name] = (prefix + leaf, leaf)
    return out


def quant_buffer_paths(model: nn.Module) -> Dict[str, Tuple[str, torch.Tensor]]:
    """torch buffer name -> (its flax path, the buffer) for every QuantDense
    buffer: `q` is the flax `kernel`, `scale` and `bias` keep their names.
    Both are already in the flax layout."""
    from rlaifv_tpu_torch.models.convert import _flax_module_path
    from rlaifv_tpu_torch.models.llama import QuantDense

    out = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, QuantDense):
            continue
        for b_name, buf in mod.named_buffers(recurse=False):
            leaf = "kernel" if b_name == "q" else b_name
            out[f"{name}.{b_name}"] = (f"{_flax_module_path(name)}/{leaf}", buf)
    return out


def param_specs(model: nn.Module, mesh: MeshLike, rules=None) -> Dict[str, Spec]:
    """torch parameter (and QuantDense buffer) name -> its spec in the torch
    layout, divisibility checked: the JAX `param_specs` of the bridged tree,
    transposed where the layouts differ (a QuantDense `q` is a flax
    kernel already)."""
    shapes = dict(model.named_parameters())
    out = {}
    for name, (path, leaf) in flax_paths(model).items():
        shape = tuple(shapes[name].shape)
        spec = torch_layout(spec_for_path(path, rules), leaf, len(shape))
        out[name] = _shrink_spec(spec, shape, mesh)
    for name, (path, buf) in quant_buffer_paths(model).items():
        out[name] = _shrink_spec(spec_for_path(path, rules), tuple(buf.shape), mesh)
    return out


def spec_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim of `spec` that `axis` splits, or None."""
    for i, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return i
    return None


# ------------------------------------------------------------------ batch


def data_index(mesh: MeshLike, rank: int) -> int:
    """A rank's position on the (dp, fsdp) data axes: rank // tp."""
    return rank // axis_sizes(mesh)["tp"]


def _rank(rank: Optional[int]) -> int:
    if rank is not None:
        return rank
    from rlaifv_tpu_torch.core import distributed as dist

    return dist.process_index()


def shard_batch(batch: Any, mesh: MeshLike, rank: Optional[int] = None) -> Any:
    """Every leaf's rows for this rank: its leading dim split over (dp,
    fsdp) in contiguous blocks, block `data_index(mesh, rank)`; a 0-d leaf
    or one whose leading dim does not divide is kept whole (replicated).
    This is the shard the JAX `shard_batch` gives the device at the rank's
    mesh position. Dicts, lists and tuples are walked."""
    sizes = axis_sizes(mesh)
    n = int(np.prod([sizes[a] for a in BATCH_SPEC[0]]))
    i = data_index(sizes, _rank(rank))

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        a = np.asarray(x)
        if a.ndim == 0 or a.shape[0] % n:
            return x
        m = a.shape[0] // n
        return x[i * m:(i + 1) * m]

    return one(batch)


def shard_pairs(batch: Dict[str, Any], mesh: MeshLike, rank: Optional[int] = None
                ) -> Dict[str, Any]:
    """A collated DPO batch's pairs for this rank. The (2B, ...) leaves hold
    the win rows then the rej rows; each half is `shard_batch`-ed on its
    own, so the rank keeps win row i and rej row i together. The (B, ...)
    leaves are `shard_batch`-ed, scalars kept."""
    B = np.asarray(batch["input_ids"]).shape[0] // 2
    out = {}
    for key, x in batch.items():
        a = np.asarray(x)
        if a.ndim and a.shape[0] == 2 * B:
            out[key] = np.concatenate([shard_batch(a[:B], mesh, rank),
                                       shard_batch(a[B:], mesh, rank)])
        else:
            out[key] = shard_batch(x, mesh, rank)
    return out


# --------------------------------------------------- tensor parallelism


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over tp (the input of a
    column-parallel product feeds every rank's slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Partial products summed over tp; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """Each rank's slices, laid out in `tp.parts` order along `dim`; the
    gradient keeps this rank's slices (every rank holds the same whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.local(g, ctx.dim), None, None


class _ScatterToTP(torch.autograd.Function):
    """This rank's slices along `dim`; the gradient gathered back."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.local(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather(g.contiguous(), ctx.dim), None, None


class TensorParallel:
    """How one Dense or Embedding is split over the tp group.

    dim 0: the weight's rows (a Dense's outputs, the vocabulary); dim 1:
    its inputs. `parts` are the sizes of the fused pieces along the split
    dim (q, k, v of a qkv_proj; gate, up of a gate_up_proj), each split over
    tp on its own; one part otherwise. `local`: the consumer (producer, for
    dim 1) works on this rank's slice, so nothing is gathered (sliced)."""

    def __init__(self, group, rank: int, size: int, dim: int, parts: Sequence[int],
                 local: bool):
        if any(p % size for p in parts):
            raise ValueError(f"parts {list(parts)} do not split over tp={size}")
        self.group, self.rank, self.size = group, rank, size
        self.dim, self.parts, self.local_io = dim, list(parts), local

    # --- layout
    def _parts(self, n: int) -> List[int]:
        """The parts in the units of a whole axis of n elements: a
        QuantDense's packed int4 rows (K/2) and group scales (K/G) scale
        the parts of its K inputs down."""
        total = sum(self.parts)
        sizes = [p * n // total for p in self.parts]
        if sum(sizes) != n or any(p % self.size for p in sizes):
            raise ValueError(f"an axis of {n} does not hold parts {self.parts} over "
                             f"tp={self.size}")
        return sizes

    def local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slices of a whole tensor along `dim`."""
        pieces, off = [], 0
        for p in self._parts(full.shape[dim]):
            n = p // self.size
            pieces.append(full.narrow(dim, off + self.rank * n, n))
            off += p
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's slices along `dim`."""
        bufs = [torch.empty_like(x) for _ in range(self.size)]
        torch.distributed.all_gather(bufs, x.contiguous(), group=self.group)
        if len(self.parts) == 1:
            return torch.cat(bufs, dim)
        out, off = [], 0
        for p in self._parts(x.shape[dim] * self.size):
            n = p // self.size
            out.extend(b.narrow(dim, off, n) for b in bufs)
            off += n
        return torch.cat(out, dim)

    def gather_weight(self, w: torch.Tensor) -> torch.Tensor:
        """The whole weight, differentiable (the fused head's operand)."""
        return _GatherFromTP.apply(w, self, self.dim)

    # --- products
    def _product(self, mod, x: torch.Tensor, bias: Optional[torch.Tensor],
                 partial: bool = False) -> torch.Tensor:
        """x @ this rank's slice of `mod`'s weight (+ bias): F.linear for a
        Dense; for a QuantDense `quant_product` on its local q/scale, so the
        int8/int4 kernels run at the local N or K on the card (each row
        quantised against its max |x| over the rank's K slice). A `partial`
        product comes back in fp32: a Dense's from fp32 accumulators
        (torch.mm's out_dtype on the card), a QuantDense's kernel output
        widened."""
        if hasattr(mod, "q"):
            from rlaifv_tpu_torch.models.llama import quant_product

            y = quant_product(x, mod.q, mod.scale, mod.bits)
            y = y.float() if partial else y
            return y if bias is None else y + bias
        w = mod.weight.to(x.dtype)
        if not partial or x.dtype == torch.float32:
            y = F.linear(x, w, bias)
            return y.float() if partial else y
        x2 = x.reshape(-1, x.shape[-1])
        y = (torch.mm(x2, w.T, out_dtype=torch.float32) if x.is_cuda
             else x2.float() @ w.float().T)
        return y.reshape(*x.shape[:-1], w.shape[0])

    def linear(self, mod, x: torch.Tensor) -> torch.Tensor:
        """`mod` (a Dense or QuantDense holding its slice) on x in its
        compute dtype: a column-parallel product adds the bias to its slice
        before its one rounding (gathered after); a row-parallel one sums its
        partials over tp and adds the bias, serving in fp32 rounded once to
        the compute dtype, as one process rounds it, training in the compute
        dtype."""
        dt = mod.compute_dtype
        bias = mod.bias.to(dt) if mod.bias is not None else None
        lora = mod.lora
        if self.dim == 0:  # column-parallel
            x = _CopyToTP.apply(x, self.group)
            if bias is not None and not self.local_io:  # whole: this rank's slice of it
                bias = _ScatterToTP.apply(bias, self, 0)
            y = self._product(mod, x, bias)
            if lora is not None:
                a, b = lora
                y = y + (x @ a.to(dt)) @ self.local(b.to(dt), 1)
            if not self.local_io:
                y = _GatherFromTP.apply(y, self, y.dim() - 1)
            return y
        if not self.local_io:  # row-parallel
            x = _ScatterToTP.apply(x, self, x.dim() - 1)
        # serving sums fp32 partials and rounds once, where one process rounds
        # the whole sum once; training sums its partials in the compute type,
        # half the bytes a step all-reduces (fp32 ones read slower over gloo)
        y = self._product(mod, x, None, partial=not torch.is_grad_enabled())
        if lora is not None:
            a, b = lora
            y = y + (x @ self.local(a.to(dt), 0)) @ b.to(dt)
        y = _ReduceFromTP.apply(y, self.group)
        return (y if bias is None else y + bias).to(dt)

    def embedding(self, ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Vocabulary-parallel lookup: this rank's rows, zeros elsewhere,
        summed over tp."""
        n = w.shape[0]
        local = ids - self.rank * n
        outside = (local < 0) | (local >= n)
        e = F.embedding(local.masked_fill(outside, 0), w)
        return _ReduceFromTP.apply(e.masked_fill(outside[..., None], 0), self.group)

    def vocab_logits(self, hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A tied head over the vocabulary-parallel embedding `w` (this
        rank's rows): hidden @ w^T, the vocabulary slices gathered."""
        y = _CopyToTP.apply(hidden, self.group) @ w.T
        return _GatherFromTP.apply(y, self, y.dim() - 1)


# ------------------------------------------------------------ the plan


def local_shard(t):
    """The part of `t` this rank holds: a DTensor's local tensor (a view,
    writes reach the DTensor), any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(named_grads, plan: Optional["MeshPlan"] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element, accumulated in
    fp32 one tensor at a time in order. `named_grads`: (parameter name,
    gradient) pairs. On a model sharded by `shard_params` (`plan`, its
    MeshPlan) each rank sums the squares of the shards it counts, one
    all-reduce adds the ranks' sums over the mesh, then the root; at one
    device that is the unsharded value bit for bit."""
    named_grads = list(named_grads)
    sq = sum(torch.linalg.vector_norm(local_shard(g), dtype=torch.float32) ** 2
             for name, g in named_grads if plan is None or plan.counted(name))
    if plan is None:
        return torch.sqrt(sq)
    if not torch.is_tensor(sq):  # this rank counts none of its shards
        sq = torch.zeros((), dtype=torch.float32,
                         device=local_shard(named_grads[0][1]).device)
    return torch.sqrt(plan.all_reduce(sq))


class MeshPlan:
    """What `shard_params` did to a model, for the code around its step.

    tp_dims: parameter name -> (TensorParallel, the dim it splits) for the
    parameters held as a tp slice. Every parameter is also an FSDP2 DTensor
    over the (dp, fsdp) sub-mesh."""

    def __init__(self, mesh, rank: int):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        t = self.sizes["tp"]
        self.coord = {"dp": rank // (self.sizes["fsdp"] * t),
                      "fsdp": rank // t % self.sizes["fsdp"], "tp": rank % t}
        self.n_data = self.sizes["dp"] * self.sizes["fsdp"]
        self.tp_dims: Dict[str, Tuple[TensorParallel, int]] = {}
        self.tp_modules: Dict[str, TensorParallel] = {}

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str] = MESH_AXES,
                   op=None) -> torch.Tensor:
        """x summed (or `op`) over the named axes, one axis at a time."""
        op = op if op is not None else torch.distributed.ReduceOp.SUM
        for axis in axes:
            torch.distributed.all_reduce(x, op=op, group=self.group(axis))
        return x

    def counted(self, name: str) -> bool:
        """Does this rank's shard of `name` count toward a global sum?
        FSDP shards are distinct over fsdp; copies over dp, and over tp for
        a parameter held whole there, count once."""
        return self.coord["dp"] == 0 and (name in self.tp_dims or self.coord["tp"] == 0)

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-rank metrics (means over the rank's pairs) -> the means over
        the global batch; `compact_overflow` -> its maximum."""
        out = {}
        for k, v in metrics.items():
            v = v.detach().clone()
            if k == "compact_overflow":
                out[k] = self.all_reduce(v, ("dp", "fsdp"), torch.distributed.ReduceOp.MAX)
                continue
            v = self.all_reduce(v, ("dp", "fsdp"))
            out[k] = v / self.n_data if self.n_data > 1 else v
        return out

    def reduce_lora_grads(self, named_grads: Sequence[Tuple[str, torch.Tensor]]) -> None:
        """Adapter gradients (replicated adapters) in place: summed over tp
        where their projection is a tp slice (each rank holds a partial
        gradient there), then averaged over the data ranks."""
        from rlaifv_tpu_torch.models.convert import torch_module_name

        for path, g in named_grads:
            module = torch_module_name(path.rsplit("/", 1)[0])
            if module in self.tp_modules and self.sizes["tp"] > 1:
                self.all_reduce(g, ("tp",))
            self.all_reduce(g, ("dp", "fsdp"))
            if self.n_data > 1:
                g.div_(self.n_data)

    def full_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter `name` (or of state shaped like
        it) from this rank's shard: gathered over the data axes, then over
        tp. A collective: every rank calls it, in the same order."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.full_tensor()
        if name in self.tp_dims:
            tp, dim = self.tp_dims[name]
            t = tp.gather(t, dim)
        return t

    def shard_of(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor of parameter `name`, in the
        layout of `like` (the parameter, or state shaped like it)."""
        from torch.distributed.tensor import DTensor, Shard

        if name in self.tp_dims:
            tp, dim = self.tp_dims[name]
            full = tp.local(full, dim)
        if isinstance(like, DTensor):
            coord = like.device_mesh.get_coordinate()
            for i, pl in enumerate(like.placements):
                if isinstance(pl, Shard):
                    chunks = full.chunk(like.device_mesh.size(i), pl.dim)
                    j = coord[i]
                    full = chunks[j] if j < len(chunks) else full.narrow(pl.dim, 0, 0)
        return full


def mesh_plan(module: nn.Module) -> Optional[MeshPlan]:
    """The plan `shard_params` left on `module` (None: not sharded)."""
    return getattr(module, "mesh_plan", None)


def run_as_forward(module: nn.Module, fn):
    """fn() as `module`'s forward. On a sharded model this is the root
    FSDP unit's forward: its parameters are gathered for the length of fn,
    and the block units nest inside it as they must; otherwise fn()."""
    call = getattr(module, "mesh_forward", None)
    return fn() if call is None else call(fn)


def serving_call(module: nn.Module, fn):
    """fn() for serving a sharded model (genai/engine.py's entry points):
    every FSDP unit gathered once up front (under no_grad: FSDP2 cannot
    gather inside torch.inference_mode, which fn may enter) and kept whole
    to the end of fn, then all resharded: one gather a unit a call, not one
    a decode step. fn runs as one forward of the root unit
    (`run_as_forward`), so the engine may call the embedding, the vision
    tower and the head directly. A call inside another joins it. On a
    model that is not sharded, fn()."""
    from torch.distributed.fsdp import FSDPModule

    if mesh_plan(module) is None or getattr(module, "serving", False):
        return fn()
    units = [m for m in module.modules() if isinstance(m, FSDPModule)]
    module.serving = True
    try:
        with torch.no_grad():
            for u in units:
                u.set_reshard_after_forward(False, recurse=False)
                u.unshard()
        return run_as_forward(module, fn)
    finally:
        module.serving = False
        for u in units:  # FSDP2's own setting again: the root keeps its weights
            u.reshard()
            u.set_reshard_after_forward(u is not module, recurse=False)


def serving(fn):
    """A serving entry point: a DecodeEngine method, a method of an object
    holding its engine as `engine`, or a function of the engine. It runs
    under torch.inference_mode, inside one `serving_call` of the engine's
    model."""
    import functools

    @functools.wraps(fn)
    def call(obj, *args, **kwargs):
        def run():
            with torch.inference_mode():
                return fn(obj, *args, **kwargs)

        return serving_call(getattr(getattr(obj, "engine", obj), "model", None), run)

    return call


def _call(self, fn, *args, **kwargs):
    return fn(*args, **kwargs)


# ------------------------------------------------------------ shard_params

_LOCAL_PAIRS = (
    # (module class, its column-parallel children, its row-parallel
    # children, whether its heads must split over tp): split together, the
    # columns' output stays local
    ("LlamaAttention", ("q_proj", "k_proj", "v_proj", "qkv_proj"), ("o_proj",), True),
    ("CLIPAttention", ("q_proj", "k_proj", "v_proj"), ("out_proj",), True),
    ("LlamaMLP", ("gate_proj", "up_proj", "gate_up_proj"), ("down_proj",), False),
)


def _heads_split(mod, tp: int) -> bool:
    cfg = mod.cfg
    return all(h % tp == 0 for h in (cfg.num_heads, getattr(cfg, "num_kv_heads",
                                                            cfg.num_heads)))


def int4_splits_on_k(mod, tp: int) -> bool:
    """May the int4 QuantDense `mod` split its K rows over tp? Only in whole
    groups, (K / G) % tp == 0: byte r of group i packs rows i G + r and
    i G + G/2 + r (ops/int4_matmul.py:pack_int4), so a slice of the packed
    rows is a contiguous K slice only at group boundaries."""
    return mod.scale.shape[0] % tp == 0


def _tp_modules(model: nn.Module, specs: Dict[str, Spec], tp: int
                ) -> Dict[str, Tuple[int, bool, List[int]]]:
    """module name -> (split dim, local, parts) for every Dense, QuantDense
    and Embedding whose weight the rules split over tp. The dim is the
    torch weight's: 0 the outputs (column-parallel), 1 the inputs
    (row-parallel); a QuantDense's flax-layout `q` splits the other one."""
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import QuantDense

    out = {}
    for name, mod in model.named_modules():
        quant = isinstance(mod, QuantDense)
        key = f"{name}.q" if quant else f"{name}.weight"
        if not (quant or isinstance(mod, (Dense, nn.Embedding))) or key not in specs:
            continue
        dim = spec_dim(specs[key], "tp")
        if dim is None:
            continue
        if quant:
            dim = 1 - dim
            if dim == 1 and mod.bits == 4 and not int4_splits_on_k(mod, tp):
                continue  # kept whole: its pair is not local
            parts = [mod.out_features if dim == 0 else mod.in_features]
        else:
            parts = [mod.weight.shape[dim]]
        leaf = name.rsplit(".", 1)[-1]
        if dim == 0 and leaf == "gate_up_proj":
            parts = [parts[0] // 2] * 2
        out[name] = [dim, False, parts]
    mods = dict(model.named_modules())
    for name, mod in mods.items():
        for cls, cols, rows, heads in _LOCAL_PAIRS:
            if type(mod).__name__ != cls:
                continue
            kids = [f"{name}.{c}" for c in cols + rows if f"{name}.{c}" in mods]
            if not all(k in out for k in kids) or (heads and not _heads_split(mod, tp)):
                continue
            for k in kids:
                out[k][1] = True
            qkv = f"{name}.qkv_proj"
            if qkv in out:
                cfg, D = mod.cfg, mod.cfg.head_size
                out[qkv][2] = [cfg.num_heads * D, cfg.num_kv_heads * D, cfg.num_kv_heads * D]
    return {k: tuple(v) for k, v in out.items()}


def _unit_modules(model: nn.Module) -> List[nn.Module]:
    """The FSDP units below the root: every decoder and vision block."""
    from rlaifv_tpu_torch.models.clip_vit import CLIPBlock
    from rlaifv_tpu_torch.models.eva02 import EvaBlock
    from rlaifv_tpu_torch.models.llama import LlamaBlock

    return [m for m in model.modules() if isinstance(m, (LlamaBlock, CLIPBlock, EvaBlock))]


def _split_quant(mod, t: TensorParallel, name: str, plan: MeshPlan) -> None:
    """A QuantDense's buffers to their tp slices, in place: column-parallel
    (t.dim 0) splits the outputs, dim 1 of `q` and the last dim of `scale`;
    row-parallel splits dim 0 of `q` (int4: the packed K/2 rows) and, for
    int4, the (K/G, N) group scales with them; the int8 per-column scale
    stays whole."""
    qdim = 1 - t.dim
    mod.q = t.local(mod.q, qdim).clone()
    plan.tp_dims[f"{name}.q"] = (t, qdim)
    sdim = mod.scale.dim() - 1 if t.dim == 0 else (0 if mod.bits == 4 else None)
    if sdim is not None:
        mod.scale = t.local(mod.scale, sdim).clone()
        plan.tp_dims[f"{name}.scale"] = (t, sdim)
    if t.dim == 0:
        mod.out_features //= t.size
    else:
        mod.in_features //= t.size


def shard_params(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Place a built model (its whole weights on this rank's device) onto
    the mesh by the rules, in place: tp slices first, then FSDP2 over the
    data axes. Leaves `model.mesh_plan` and returns the model. Apply it
    once, before the optimizer is made (the optimizer holds the shards).
    A quantised model is quantised whole first (models/convert.py): its
    QuantDense layers keep their tp slices of those integers and scales."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    from rlaifv_tpu_torch.core import distributed as dist
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import LlamaBlock, QuantDense

    if mesh_plan(model) is not None:
        raise ValueError("shard_params: the model is already sharded")
    sizes = axis_sizes(mesh)
    specs = param_specs(model, sizes, rules)
    plan = MeshPlan(mesh, dist.process_index())
    tp = sizes["tp"]
    if tp > 1:
        group = plan.group("tp")
        for name, (dim, local, parts) in _tp_modules(model, specs, tp).items():
            mod = model.get_submodule(name)
            t = TensorParallel(group, plan.coord["tp"], tp, dim, parts, local)
            with torch.no_grad():
                if isinstance(mod, QuantDense):
                    _split_quant(mod, t, name, plan)
                else:
                    mod.weight = nn.Parameter(t.local(mod.weight.data, dim).clone(),
                                              requires_grad=mod.weight.requires_grad)
                    plan.tp_dims[f"{name}.weight"] = (t, dim)
                if getattr(mod, "bias", None) is not None and dim == 0 and local:
                    bias = t.local(mod.bias.data, 0).clone()
                    mod.bias = (bias if isinstance(mod, QuantDense) else
                                nn.Parameter(bias, requires_grad=mod.bias.requires_grad))
                    plan.tp_dims[f"{name}.bias"] = (t, 0)
            if isinstance(mod, Dense):
                mod.out_features, mod.in_features = mod.weight.shape
            mod.tp = t
            plan.tp_modules[name] = t

    names = {id(p): n for n, p in model.named_parameters()}

    def placement(p):
        d = spec_dim(specs[names[id(p)]], "fsdp")
        return Shard(d if d is not None else 0)

    data_mesh = mesh["dp", "fsdp"]
    for unit in _unit_modules(model):
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement)
        if isinstance(unit, LlamaBlock):
            register_fsdp_forward_method(unit, "forward_paired")
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement)
    model.mesh_forward = types.MethodType(_call, model)
    register_fsdp_forward_method(model, "mesh_forward")
    model.mesh_plan = plan
    return model
