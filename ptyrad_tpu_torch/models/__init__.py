from ptyrad_tpu_torch.models.state import (
    Buffers,
    Geometry,
    PtychoParams,
    make_model,
    params_from_numpy,
)
from ptyrad_tpu_torch.models.forward import (
    compute_propagators,
    forward,
    forward_route,
    fused_loss_terms,
    get_measurements,
    get_obj_patches,
    get_probes,
    multislice_dp,
)

__all__ = [
    "PtychoParams",
    "Buffers",
    "Geometry",
    "make_model",
    "params_from_numpy",
    "forward",
    "forward_route",
    "fused_loss_terms",
    "multislice_dp",
    "compute_propagators",
    "get_obj_patches",
    "get_probes",
    "get_measurements",
]
