"""Processes, the device mesh and the model's data-parallel wrapper
(``hulc2_tpu/parallel/mesh.py``).

One process per rank, as ``torchrun`` starts them: ``initialize_distributed``
starts the default process group from torchrun's environment (``nccl`` on
the card, ``gloo`` on the CPU) and binds the process to ``cuda:LOCAL_RANK``.
A world of one under torchrun starts its group too, so that the path runs
as it would on more cards. ``make_mesh(dp, fsdp)`` is a ``DeviceMesh`` with
the JAX mesh's axis names; ``wrap_model`` gives DDP over the processes when
``fsdp`` is 1, and otherwise FSDP2's ``fully_shard`` over the mesh (the dp
axis replicates, the fsdp axis shards). ``shard_dim`` is the JAX package's
rule for which axis of a parameter ``fsdp`` shards (``:62-78``): a tensor of
2 or more axes and at least 2^20 elements, on its largest axis that the
fsdp size divides. FSDP2 cannot leave a parameter of one or more axes
whole, so the others are sharded on their first axis, which changes where
they live and not what the step computes; it refuses 0-d ones, which stay
whole with their gradients averaged over the ranks. The trainer, as JAX's (``hulc2_tpu/train/trainer.py:46``),
only uses fsdp 1; FSDP's all-gather and reduce-scatter need a backend that
runs them on the tensors' device, which ``gloo`` does for CPU tensors only.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

logger = logging.getLogger(__name__)

FSDP_MIN_NUMEL = 1 << 20


def launched_by_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device=None) -> bool:
    """Start the default process group from torchrun's environment: ``nccl``
    when ``device`` is the card (default), ``gloo`` on the CPU. Binds the
    process to ``cuda:LOCAL_RANK``. Returns whether a group is up; outside
    torchrun nothing is started."""
    if dist.is_initialized():
        return True
    if not launched_by_torchrun():
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    logger.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
                dist.get_backend())
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, device_type: Optional[str] = None):
    """A (dp, fsdp) ``DeviceMesh`` over the process group's ranks; ``dp``
    defaults to the ranks that ``fsdp`` leaves. Needs a started group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under torchrun, or call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if dp is None:
        if n % fsdp:
            raise ValueError(f"fsdp {fsdp} does not divide the {n} ranks")
        dp = n // fsdp
    if dp * fsdp != n:
        raise ValueError(f"mesh {dp} x {fsdp} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, fsdp), mesh_dim_names=("dp", "fsdp"))


def shard_dim(shape, fsdp: int) -> Optional[int]:
    """The axis that ``fsdp`` shards a parameter of ``shape`` on under the JAX
    rule, or None for a tensor the rule replicates."""
    if fsdp == 1 or len(shape) < 2 or int(np.prod(shape)) < FSDP_MIN_NUMEL:
        return None
    for i in np.argsort([-s for s in shape], kind="stable"):
        if shape[i] % fsdp == 0:
            return int(i)
    return None


def wrap_model(model: nn.Module, mesh=None) -> nn.Module:
    """The model as the train step drives it: itself without a mesh; DDP over
    the mesh's ranks at fsdp 1; FSDP2 over the (dp, fsdp) mesh otherwise.
    DDP looks for the parameters a step leaves without a gradient (GCBC's
    plan heads, a frozen trunk that runs without a graph), which the
    optimizer may then fill with zeros."""
    if mesh is None:
        return model
    if mesh["fsdp"].size() == 1:
        from torch.nn.parallel import DistributedDataParallel

        # no device_ids: the batches are on the model's device already, and
        # DDP then leaves the step's inputs as they are
        return DistributedDataParallel(model, process_group=mesh["dp"].get_group(),
                                       find_unused_parameters=True)
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    fsdp = mesh["fsdp"].size()

    def placement(p: nn.Parameter):
        d = shard_dim(tuple(p.shape), fsdp)
        return Shard(0 if d is None else d)

    # FSDP2 refuses 0-d parameters (the CLIP loss's temperature): they stay
    # whole on every rank, their gradients averaged as DDP would
    scalars = {p for p in model.parameters() if p.ndim == 0}

    def average(p: torch.Tensor) -> None:  # the mesh spans every rank
        dist.all_reduce(p.grad)
        p.grad /= dist.get_world_size()

    for p in scalars:
        p.register_post_accumulate_grad_hook(average)
    return fully_shard(model, mesh=mesh, shard_placement_fn=placement, ignored_params=scalars)


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a DDP wrapper (FSDP2 shards the module in place)."""
    return getattr(model, "module", model)
