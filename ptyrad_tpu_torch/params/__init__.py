"""The params-file schema (pydantic; imported on use, see load.load_params)."""

from ptyrad_tpu_torch.params.schema import (
    ConstraintParams,
    HypertuneParams,
    InitParams,
    LossParams,
    ModelParams,
    PtyRADParams,
    ReconParams,
)

__all__ = [
    "PtyRADParams",
    "InitParams",
    "ModelParams",
    "LossParams",
    "ConstraintParams",
    "ReconParams",
    "HypertuneParams",
]
