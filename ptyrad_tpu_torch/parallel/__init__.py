"""Data parallelism and canvas sharding over ranks (counterpart of
ptyrad_tpu/parallel/)."""

from ptyrad_tpu_torch.parallel.canvas import (CanvasPlan, CanvasShard, canvas_iteration_batches,
                                              global_batches, halo_extend, plan_canvas,
                                              plan_canvas_sharding, slab_local_positions)
from ptyrad_tpu_torch.parallel.mesh import (DataGroup, ExchangePlan, StoreSplit,
                                            all_gather_rows, all_reduce_grads, all_reduce_sum,
                                            broadcast_object, broadcast_str, exchange_plan,
                                            exchange_rows, init_multihost,
                                            is_main_process, process_index, rank_slice,
                                            shard_model, split_store, store_rows, store_split,
                                            world_size)

__all__ = ["CanvasPlan", "CanvasShard", "DataGroup", "ExchangePlan", "StoreSplit",
           "all_gather_rows", "all_reduce_grads", "all_reduce_sum", "broadcast_object",
           "broadcast_str", "canvas_iteration_batches", "exchange_plan", "exchange_rows",
           "global_batches", "halo_extend", "init_multihost", "is_main_process",
           "plan_canvas", "plan_canvas_sharding", "process_index", "rank_slice", "shard_model",
           "slab_local_positions", "split_store", "store_rows", "store_split", "world_size"]
