"""Multi-process start-up and mesh construction. Port of
``multiview_tpu/parallel/distributed.py``.

The reference is single-node shared memory (SURVEY.md 2.3). Here each
process (one a host, or one a group of cards) joins a ``torch.distributed``
process group; a mesh spans this process's cards and the group, and the
solver's cross-shard sums become one all-reduce each (NCCL between CUDA
processes, gloo on the CPU).

    from multiview_tpu_torch.parallel import distributed as pdist
    pdist.initialize()           # no-op in one process; env-driven under torchrun
    mesh = pdist.global_mesh()   # 1-D mesh over every card of every process
    ... shard_observations(obs, mesh) ...

Each process shards over the CUDA cards it sees; give each process its
own cards with ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from multiview_tpu_torch.parallel.sharding import OBS_AXIS, ShardMesh
from multiview_tpu_torch.utils.device import resolve_device

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join (or create) the process group. Returns True when it has more
    than one process.

    Safe to call unconditionally: with no coordinator given and no
    ``torchrun`` environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) it
    does nothing, and a second call changes nothing. ``coordinator_address``
    is ``host:port`` of rank 0; the backend is NCCL where CUDA is available
    and gloo otherwise unless ``backend`` names one. A join that fails
    raises: there is no quiet fallback to one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = all(k in os.environ for k in _ENV)
    if coordinator_address is None and not (num_processes or 0) > 1 and not env:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices(device=None) -> List[torch.device]:
    """This process's devices of ``device``'s kind: every visible CUDA card
    (the first CUDA card when None, which raises where there is none), or
    the CPU when it is named."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _group():
    return dist.group.WORLD if process_count() > 1 else None


def global_mesh(axis: str = OBS_AXIS, device=None) -> ShardMesh:
    """1-D mesh over every card of every process: this process's cards, and
    the process group when there is more than one process (rank r holds
    shards r * cards ...)."""
    return ShardMesh(tuple(local_devices(device)), (axis,), (), _group())


def host_chip_mesh(host_axis: str = "host", chip_axis: str = OBS_AXIS,
                   device=None) -> ShardMesh:
    """2-D (processes x local cards) mesh, for layouts that want the split
    between hosts and cards explicit (TSDF blocks over hosts and cards)."""
    devs = tuple(local_devices(device))
    return ShardMesh(devs, (host_axis, chip_axis), (process_count(), len(devs)), _group())


def process_slice(n_rows: int) -> Tuple[int, int]:
    """[start, stop) of the rows this process owns when each process reads
    only its share (keyframes, clouds)."""
    p, n = process_index(), process_count()
    per = -(-n_rows // n)
    return min(p * per, n_rows), min((p + 1) * per, n_rows)
