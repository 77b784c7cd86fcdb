"""Multi-process initialization and the ('dcn', 'rays') mesh (port of
dfanerf_tpu/parallel/distributed.py) over torch.distributed.

- ``initialize()`` starts the process group from torchrun's environment
  (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
  LOCAL_WORLD_SIZE) or from explicit arguments, which override it. Without
  an address and a world size there is no job: it returns False and does
  nothing, so every entry point can call it. The backend follows the
  device: NCCL on CUDA (each rank on ``cuda:LOCAL_RANK``), gloo on the CPU.
  Unlike the reference, a world of one with an address is initialized: a
  torch mesh is made of the process group, even over one rank.
- ``make_pod_mesh()`` lays the ranks out as ('dcn', 'rays'): each 'rays'
  row holds one node's local ranks (torchrun numbers a node's ranks
  contiguously), so a collective over 'rays' stays inside a node and only
  the 'dcn' hop crosses nodes. With one node it is the flat ('rays',) mesh.
- ``shard_index`` and ``hierarchical_all_reduce`` are the counterpart of
  the reference's ``hierarchical_pspec`` P(('dcn', 'rays')): a rank's shard
  of a batch split over both axes, and a sum over 'rays' first and one
  'dcn' hop last.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from dfanerf_torch.device import resolve_device

_LOCAL_WORLD_SIZE: Optional[int] = None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None, device=None) -> bool:
    """Start the process group of a multi-process job; False (and nothing
    done) when neither the arguments nor the environment describe one.

    init_method: 'tcp://host:port' (default from MASTER_ADDR / MASTER_PORT).
    device: 'cuda' (default; NCCL, which must be available) or 'cpu' (gloo).
    """
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if not init_method or not world_size:
        return False
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA job needs NCCL, and this torch has none")
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size,
                                rank=rank, device_id=torch.device("cuda", local_rank))
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size,
                                rank=rank)
    else:
        raise ValueError(f"initialize: device {dev} is neither cuda nor cpu")
    global _LOCAL_WORLD_SIZE
    _LOCAL_WORLD_SIZE = local_world_size
    return True


def mesh_device_type() -> str:
    """The device type of the process group's meshes: 'cuda' under NCCL."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_pod_mesh(dcn_axis_size: Optional[int] = None, ici_axis: str = "rays"):
    """The ('dcn', 'rays') mesh over every rank; ``dcn_axis_size`` defaults
    to the number of nodes, WORLD_SIZE / LOCAL_WORLD_SIZE. With a 'dcn' of
    one it is the flat (ici_axis,) mesh of parallel/mesh.py make_mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if dcn_axis_size is None:
        local = _LOCAL_WORLD_SIZE or int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dcn_axis_size = world // local
    if dcn_axis_size <= 1:
        return init_device_mesh(mesh_device_type(), (world,), mesh_dim_names=(ici_axis,))
    if world % dcn_axis_size:
        raise ValueError(f"{world} ranks do not divide over dcn={dcn_axis_size}")
    return init_device_mesh(mesh_device_type(), (dcn_axis_size, world // dcn_axis_size),
                            mesh_dim_names=("dcn", ici_axis))


def shard_index(mesh) -> Tuple[int, int]:
    """(this rank's shard, the number of shards) of a batch split over every
    axis of ``mesh``, 'dcn' major: the reference's P(('dcn', 'rays'))."""
    index, count = 0, 1
    for dim in range(mesh.ndim):
        size = mesh.size(dim)
        index, count = index * size + mesh.get_local_rank(dim), count * size
    return index, count


def hierarchical_all_reduce(tensor: torch.Tensor, mesh, ici_axis: str = "rays") -> torch.Tensor:
    """Sum ``tensor`` over every rank of ``mesh`` in place: over ``ici_axis``
    inside each node first, then one hop over 'dcn' where the mesh has it."""
    dist.all_reduce(tensor, group=mesh.get_group(ici_axis))
    if "dcn" in (mesh.mesh_dim_names or ()):
        dist.all_reduce(tensor, group=mesh.get_group("dcn"))
    return tensor
