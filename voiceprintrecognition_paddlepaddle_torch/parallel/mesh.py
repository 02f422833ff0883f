"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
``parallel/mesh.py``).

The JAX package runs data parallelism as one program over a 1-D device
mesh: parameters replicated, batches sharded on axis 0, and ``jit``
computes the BatchNorm statistics and the loss over the global batch and
all-reduces the gradients. The port takes PyTorch's own idiom: one process
per device, joined in one process group, with

- ``DistributedDataParallel`` for the gradient all-reduce (``trainer.py``);
- ``models/layers.BatchNorm``, whose train-mode statistics are those of
  the global batch (the JAX mesh's) whenever the group has more than one
  rank;
- ``TripletAngularMarginLoss`` mining over the global batch
  (``all_gather_with_grad``);
- rank-sharded evaluation joined by ``allgather_ragged``.

``maybe_initialize_distributed`` joins the group from the same variables as
JAX: ``VPR_COORDINATOR`` (``host:port`` of rank 0), ``VPR_NUM_PROCESSES``
and ``VPR_PROCESS_ID``; or ``VPR_AUTO_DISTRIBUTED=1``, which maps to
torch's ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` as a cluster runner sets them). ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` place the ranks of one host on its cards; the port's
``launch_multihost`` sets all of these.

Where the port departs from JAX on purpose:

- **The backend follows from the layout.** NCCL when each rank of a host
  has a card of its own; gloo with CUDA tensors when ranks share a card
  (NCCL refuses two ranks on one device), which is logged; gloo on the
  CPU. A rank asked for ``cuda`` never runs on the CPU.
- **Gathers are the backends' own.** ``all_gather_stacked`` is
  ``dist.all_gather`` into the rows of one buffer, and
  ``all_gather_with_grad`` is ``torch.distributed.nn.functional.all_gather``
  (its backward a reduce-scatter on NCCL, scatters on gloo). Gloo takes
  CUDA tensors by copying them to the host, exchanging them there and
  copying the result back; NCCL exchanges them on the cards. The buffers
  are small (BatchNorm statistics, embeddings, the triplet loss's
  features); the gradient all-reduce is DDP's own.
"""

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from ..utils.logger import logger

__all__ = ["maybe_initialize_distributed", "local_process_info",
           "is_distributed", "rank_device", "backend_for",
           "all_gather_stacked", "all_gather_with_grad", "all_reduce_sum",
           "allgather_ragged"]

# how long a rank waits in a collective for the others before it raises
COLLECTIVE_TIMEOUT = timedelta(seconds=600)


def _env_int(name, default):
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _local_rank():
    """This process's rank among the ranks of its host (``LOCAL_RANK``,
    else its global rank: one host)."""
    return _env_int("LOCAL_RANK", local_process_info()[0])


def backend_for(device_type, local_world, n_cards):
    """The backend for ``local_world`` ranks of a host with ``n_cards``
    CUDA devices, asked for ``device_type``: ``"nccl"`` when each rank has
    a card, ``"gloo"`` when ranks share one or run on the CPU."""
    if device_type == "cuda":
        if n_cards < 1:
            raise RuntimeError("a CUDA process group needs a CUDA device")
        return "nccl" if local_world <= n_cards else "gloo"
    return "gloo"


def maybe_initialize_distributed(device="cuda"):
    """Join the process group the environment describes, once; a process
    with none of the variables set is left alone (one rank). ``device``
    is the device the caller asked for (``"cuda"`` or ``"cpu"``): it picks
    the backend (``backend_for``). Returns whether a group is up."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("VPR_COORDINATOR")
    if coord:
        init = dict(init_method=f"tcp://{coord}",
                    world_size=int(os.environ["VPR_NUM_PROCESSES"]),
                    rank=int(os.environ["VPR_PROCESS_ID"]))
    elif os.environ.get("VPR_AUTO_DISTRIBUTED"):
        init = dict(init_method="env://")
    else:
        return False
    world = init.get("world_size") or _env_int("WORLD_SIZE", 1)
    rank = init.get("rank", _env_int("RANK", 0))
    device_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    backend = backend_for(device_type, local_world, n_cards)
    if device_type == "cuda":
        torch.cuda.set_device(_env_int("LOCAL_RANK", rank) % n_cards)
        if backend == "gloo":
            logger.info(f"{local_world} ranks share {n_cards} CUDA "
                        f"device(s): gloo with CUDA tensors (NCCL takes one "
                        f"rank per device)")
    dist.init_process_group(backend=backend, timeout=COLLECTIVE_TIMEOUT,
                            **init)
    logger.info(f"process group: rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, backend {backend}")
    return True


def local_process_info():
    """``(rank, world_size)``; ``(0, 1)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_distributed():
    """A process group of more than one rank is up."""
    return local_process_info()[1] > 1


def rank_device(device):
    """The device this rank computes on: ``cuda:<local rank>`` (modulo the
    host's cards) when the caller asked for ``"cuda"`` without an index;
    any other device as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    if not dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def _comm_device(device):
    """Where a tensor of ``device`` travels for a collective: NCCL takes
    CUDA tensors only; gloo takes both."""
    if dist.get_backend() == "nccl" and device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def all_reduce_sum(x):
    """The elementwise sum of ``x`` over the ranks (a new tensor)."""
    dev = _comm_device(x.device)
    buf = x.detach().to(dev, copy=True)
    dist.all_reduce(buf)
    return buf.to(x.device)


def all_gather_stacked(x):
    """``(world, *x.shape)``: every rank's ``x`` (equal shapes), in rank
    order (``dist.all_gather`` into the rows of one buffer). No
    autograd."""
    world = local_process_info()[1]
    dev = _comm_device(x.device)
    out = torch.empty((world,) + tuple(x.shape), dtype=x.dtype, device=dev)
    dist.all_gather(list(out.unbind(0)), x.detach().to(dev).contiguous())
    return out.to(x.device)


def all_gather_with_grad(x):
    """``(world * n, ...)``: every rank's ``x`` (the same ``n`` rows on
    every rank, else ``ValueError``), rank-major, with a backward that
    hands each rank the gradient of its own rows summed over the ranks
    (``torch.distributed.nn.functional.all_gather``)."""
    counts = all_gather_stacked(torch.tensor([x.shape[0]], device=x.device))
    if bool((counts != x.shape[0]).any()):
        raise ValueError(f"the ranks hold different batch sizes "
                         f"{counts.flatten().tolist()}; a global batch "
                         f"needs the same size on every rank")
    return torch.cat(dist_nn.all_gather(x))


def allgather_ragged(*arrays):
    """Gather per-rank arrays whose leading sizes differ across ranks
    (each rank's shard of an unevenly split list): pad to the largest
    count, gather, trim, and concatenate in rank order, as JAX
    ``allgather_ragged`` (``mesh.py:96-119``). Takes numpy arrays or
    tensors and returns the same kinds. Collective: every rank calls it
    with its shard, also an empty one; without a group of more than one
    rank the arrays come back as they are."""
    if not is_distributed():
        return tuple(arrays)
    tensors = [torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else a for a in arrays]
    n = tensors[0].shape[0]
    counts = all_gather_stacked(torch.tensor([n], dtype=torch.int64))
    counts = [int(c) for c in counts.flatten()]
    n_max = max(counts)
    out = []
    for a, t in zip(arrays, tensors):
        pad = torch.zeros((n_max - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        g = all_gather_stacked(torch.cat([t, pad]))
        g = torch.cat([g[r, :c] for r, c in enumerate(counts)])
        out.append(g.numpy() if isinstance(a, np.ndarray) else g)
    return tuple(out)
