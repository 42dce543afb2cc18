"""Multi-process runtime init, host-object collectives and the device
groups of a mesh.

Counterpart of rlaifv_tpu/core/distributed.py on torch.distributed. The
launcher is torchrun (or anything that sets its variables): `initialize`
reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK where the JAX package
reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, and
does nothing when they are absent (one process) or when a process group
already exists.

Host objects travel over the default group, gloo over CPU tensors
(`dist.all_gather_object`), as the JAX gather is host-side: no NCCL
communicator is made for them, so two processes may share one card (a
second NCCL rank on the same device is refused). Used by the ref-logp
precompute to gather its ragged per-row logps
(ref muffin/eval/muffin_inference_logp.py:331 `all_gather_object`).

Device tensors travel over the axis groups of a mesh (`device_mesh`,
called by parallel/sharding.py's `create_mesh` when the trainer shards a
model): NCCL groups for a mesh on the card, gloo ones for a mesh on the
CPU. They are made there and only there, never by `initialize`. NCCL over
more than one process needs one card a process; on a one-card machine a
mesh runs at one process.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, List, Optional

import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Idempotent multi-process init; a no-op for one process.

    coordinator: "host:port" (default MASTER_ADDR:MASTER_PORT from the
    environment); num_processes / process_id default to WORLD_SIZE / RANK.
    The group is gloo: it carries host objects only."""
    if dist.is_initialized():
        return  # already initialized by the launcher
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator is None:
        return  # single-process run
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes or int(os.environ.get("WORLD_SIZE", "1")),
        rank=process_id if process_id is not None else int(os.environ.get("RANK", "0")),
        timeout=TIMEOUT,
    )


def device_mesh(shape, names, device_type: str, backend: Optional[str] = None):
    """A DeviceMesh of `shape` over every process (row-major by rank), its
    axes named `names`; each axis group NCCL when device_type is "cuda",
    gloo when "cpu", or `backend` (gloo carries CUDA tensors too, so two
    processes may share one card). Collective over the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    backend = backend or {"cuda": "nccl", "cpu": "gloo"}[device_type]
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names),
                            backend_override={i: backend for i in range(len(shape))})


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def all_gather_objects(obj: Any) -> List[Any]:
    """Gather an arbitrary (pickle-able) object from every process, in
    rank order: ragged payloads (the ref-logp per-token lists) included."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier(name: str = "barrier") -> None:
    """Host barrier over the group (no-op for one process)."""
    if process_count() == 1:
        return
    dist.barrier()


def assert_consistent(value: Any, name: str = "value") -> None:
    """Debug guard: every process must hold an identical `value`.

    Divergent host state (config, RNG seed, dataset shard math) is the
    classic cause of silent multi-process corruption. Enable via
    RLAIFV_DISTRIBUTED_DEBUG=1; no-op single-process or when the flag is
    off (zero cost in production)."""
    if process_count() == 1:
        return
    if os.environ.get("RLAIFV_DISTRIBUTED_DEBUG", "0") != "1":
        return
    try:
        blob = json.dumps(value, sort_keys=True, default=repr)
    except TypeError:
        blob = repr(value)
    gathered = all_gather_objects(blob)
    if any(g != gathered[0] for g in gathered):
        detail = "\n".join(
            f"  process {i}: {g[:200]}" for i, g in enumerate(gathered)
        )
        raise AssertionError(
            f"[distributed-debug] '{name}' differs across processes:\n"
            f"{detail}"
        )
