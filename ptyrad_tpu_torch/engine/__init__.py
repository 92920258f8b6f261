from ptyrad_tpu_torch.engine.batching import make_batches, pad_batches, select_scan_indices

__all__ = ["select_scan_indices", "make_batches", "pad_batches"]
