"""Data parallelism over ranks (counterpart of ptyrad_tpu/parallel/)."""

from ptyrad_tpu_torch.parallel.mesh import (DataGroup, all_reduce_grads, all_reduce_sum,
                                            broadcast_str, init_multihost, is_main_process,
                                            process_index, rank_slice, shard_model, world_size)

__all__ = ["DataGroup", "all_reduce_grads", "all_reduce_sum", "broadcast_str", "init_multihost",
           "is_main_process", "process_index", "rank_slice", "shard_model", "world_size"]
