from ptyrad_tpu_torch.physics.constants import electron_wavelength
from ptyrad_tpu_torch.physics.probe import hermite_like_basis, make_mixed_probe, make_stem_probe
from ptyrad_tpu_torch.physics.propagator import near_field_evolution, propagator_kgrid

__all__ = [
    "electron_wavelength",
    "make_stem_probe",
    "make_mixed_probe",
    "hermite_like_basis",
    "near_field_evolution",
    "propagator_kgrid",
]
