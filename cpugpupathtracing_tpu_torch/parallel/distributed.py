"""Multi-process bring-up over torch.distributed (the JAX package's
parallel/distributed.py): the process group, the primary process, this
rank's place in the group and the gather that puts the ranks' slices
together.

PyTorch runs one process per card (what `torchrun` launches) with
collectives over a process group, where JAX runs one controller over
many chips.  Launch lines, one process per card:

    CPUGPU_DISTRIBUTED=1 torchrun --nproc-per-node 4 \
        -m cpugpupathtracing_tpu_torch.cli ...

or, without torchrun, one command per process:

    CPUGPU_COORDINATOR=<host0>:29500 CPUGPU_NUM_PROCESSES=4 \
    CPUGPU_PROCESS_ID=<0..3> LOCAL_RANK=<card> \
        python -m cpugpupathtracing_tpu_torch.cli ...

A single-process run (the common case) is a strict no-op: nothing here
needs more than one card.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.log import log_info

# the device of this rank, set by maybe_initialize_distributed
_device: torch.device | None = None


class RankMesh(NamedTuple):
    """The port's counterpart of the JAX package's device mesh: the
    ranks of the process group (one card each) and this rank's place and
    device."""

    size: int
    rank: int
    device: torch.device


def maybe_initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Bring up the process group, or do nothing.

    Resolution order (the JAX package's): explicit arguments, then
    CPUGPU_COORDINATOR / CPUGPU_NUM_PROCESSES / CPUGPU_PROCESS_ID, then
    CPUGPU_DISTRIBUTED=1, which reads torchrun's variables
    (init_method="env://": MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
    where JAX autodetects a Cloud TPU.  coordinator is "host:port" (a TCP
    rendezvous) or a URL such as "file:///shared/path".  Without a
    coordinator and without CPUGPU_DISTRIBUTED=1, or with num_processes
    <= 1 and without it, this returns False and dials nothing.

    The backend is NCCL for the card and gloo for device="cpu"; on the
    card the rank's device is cuda:LOCAL_RANK when LOCAL_RANK is set.
    Returns True when more than one process is up.  Idempotent: a later
    call returns the first call's answer."""
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1

    coordinator = coordinator or os.environ.get("CPUGPU_COORDINATOR")
    if num_processes is None and os.environ.get("CPUGPU_NUM_PROCESSES"):
        num_processes = int(os.environ["CPUGPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("CPUGPU_PROCESS_ID"):
        process_id = int(os.environ["CPUGPU_PROCESS_ID"])
    autodetect = os.environ.get("CPUGPU_DISTRIBUTED") == "1"

    if coordinator is None and not autodetect:
        return False  # a plain single-process run
    if num_processes is not None and num_processes <= 1 and not autodetect:
        log_info("Distributed", "num_processes=1: no process group")
        return False

    dev = torch.device(device)
    if dev.type == "cuda":
        if os.environ.get("LOCAL_RANK") is not None and dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    _device = dev
    log_info("Distributed", "process {}/{} up on {} ({})", dist.get_rank(),
             dist.get_world_size(), dev, backend)
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that writes files and serves the viewer
    (rank 0; the reference's single main thread, Source/Main.cpp:825), and
    in a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(device="cuda") -> RankMesh:
    """Every rank of the process group and this rank's device (the one
    maybe_initialize_distributed chose); without a group, one rank on
    `device`."""
    if dist.is_initialized():
        return RankMesh(dist.get_world_size(), dist.get_rank(),
                        _device if _device is not None
                        else resolve_device(device))
    return RankMesh(1, 0, resolve_device(device))


def gather_image_to_host(shard: torch.Tensor) -> np.ndarray:
    """Every rank's `shard` put together in rank order, as numpy on every
    rank (an all_gather; one process: the local tensor).  The order of
    the lanes inside each shard is the caller's
    (parallel/sharding.gather_frame unblocks a pixels-mode frame)."""
    shard = shard.contiguous()
    if dist.is_initialized() and dist.get_world_size() > 1:
        parts = [torch.empty_like(shard)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, shard)
        shard = torch.cat(parts)
    return shard.cpu().numpy()
