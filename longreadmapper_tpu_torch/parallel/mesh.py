"""The ('data', 'model') process mesh (port of
longreadmapper_tpu/parallel/mesh.py over torch.distributed).

One device per rank: rank r is mesh coordinate (r // n_model, r %
n_model), as JAX's make_mesh reshapes its device list.  Reads are split
over 'data' (each data index maps its own contiguous rows of a chunk);
the index's gather tables are replicated, or row-sharded over 'model'
(parallel/dist.ShardedRows).  A rank reads its place from the mesh
(`mesh.get_coordinate()`, `mesh["data"].size()`, `mesh.get_group("model")`),
which stands for JAX's three shardings: a data-sharded batch is each data
index's contiguous rows, a model-sharded table each model index's row
block, a replicated array a plain tensor on every rank.

Every subgroup carries the timeout PG_TIMEOUT_S (launch.init_distributed
gives the default group the same) instead of the backend's default, so
a rank that stops answering fails its peers' collectives within it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PG_TIMEOUT_S = 300          # every process group's collective timeout


def _group_options(backend: str, timeout_s: float):
    """Backend options carrying the collective timeout of a subgroup."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    elif backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
    else:
        raise ValueError(f"unsupported backend {backend}")
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    return opts


def make_mesh(n_data: int, n_model: int, device_type: str,
              timeout_s: float = PG_TIMEOUT_S) -> DeviceMesh:
    """The ('data', 'model') mesh over every rank of the default process
    group (launch.init_distributed makes it); n_data * n_model must be the
    world size."""
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh data={n_data} x model={n_model} != world "
                         f"size {world}")
    backend = dist.get_backend()
    opts = (backend, _group_options(backend, timeout_s))
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"),
                            backend_override={"data": opts, "model": opts})


def rank_device(device) -> torch.device:
    """This rank's device: cuda:<LOCAL_RANK> for a CUDA request, else the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev
