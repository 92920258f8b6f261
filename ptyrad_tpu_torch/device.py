"""Device resolution for the port's entry points.

The entry points run on CUDA unless the caller asks for the CPU. A host
without CUDA raises instead of carrying on quietly on the CPU, so a run that
was meant for the card never reports CPU numbers.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Keep float32 products and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions (the blurs, ops/blur.py) in TF32 by
    default, which keeps about three decimal digits; the JAX reference is
    float32 throughout.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises RuntimeError for CUDA on a host
    without it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ptyrad_tpu_torch runs on CUDA by default, but CUDA is not "
                "available on this host; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        pin_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
