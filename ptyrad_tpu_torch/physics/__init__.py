from ptyrad_tpu_torch.physics.constants import (complex_object_interp3d, electron_wavelength,
                                                get_em_constants, infer_dx, xray_wavelength)
from ptyrad_tpu_torch.physics.probe import (hermite_like_basis, make_fzp_probe, make_mixed_probe,
                                            make_stem_probe)
from ptyrad_tpu_torch.physics.propagator import near_field_evolution, propagator_kgrid

__all__ = [
    "electron_wavelength",
    "get_em_constants",
    "xray_wavelength",
    "infer_dx",
    "complex_object_interp3d",
    "make_stem_probe",
    "make_fzp_probe",
    "make_mixed_probe",
    "hermite_like_basis",
    "near_field_evolution",
    "propagator_kgrid",
]
