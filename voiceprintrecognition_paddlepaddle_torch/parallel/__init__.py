"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
``parallel/``)."""

from .mesh import (all_gather_stacked, all_gather_with_grad, all_reduce_sum,
                   allgather_ragged, backend_for, is_distributed,
                   local_process_info, maybe_initialize_distributed,
                   rank_device)

__all__ = ["maybe_initialize_distributed", "local_process_info",
           "is_distributed", "rank_device", "backend_for",
           "all_gather_stacked", "all_gather_with_grad", "all_reduce_sum",
           "allgather_ragged"]
