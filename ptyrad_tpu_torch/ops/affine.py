"""Affine transforms for scan-position grids (host-side NumPy).

The port's own copy of ptyrad_tpu/ops/affine.py: the scan affine is composed
as scale @ asymmetry @ rotation @ shear and applied to (N, 2) position
arrays; decomposition fits the four components back from a matrix.
"""

from __future__ import annotations

import numpy as np


def compose_affine_matrix(scale: float, asymmetry: float, rotation: float, shear: float) -> np.ndarray:
    """Compose a 2x2 affine from scale, asymmetry, rotation [deg], shear [deg]."""
    rot = np.radians(rotation)
    shr = np.radians(shear)
    a1 = np.array([[scale, 0.0], [0.0, scale]])
    a2 = np.array([[1.0 + asymmetry / 2.0, 0.0], [0.0, 1.0 - asymmetry / 2.0]])
    a3 = np.array([[np.cos(rot), np.sin(rot)], [-np.sin(rot), np.cos(rot)]])
    a4 = np.array([[1.0, 0.0], [np.tan(shr), 1.0]])
    return a1 @ a2 @ a3 @ a4


def decompose_affine_matrix(mat: np.ndarray):
    """Least-squares fit (scale, asymmetry, rotation, shear) from a 2x2 matrix."""
    from scipy.optimize import least_squares

    def err(x):
        return (mat - compose_affine_matrix(*x)).ravel()

    res = least_squares(err, np.array([1.0, 0.0, 0.0, 0.0]))
    return tuple(res.x)


def fit_affine_from_bases(input_basis: np.ndarray, output_basis: np.ndarray):
    """Fit (scale, asymmetry, rotation, shear) F minimizing ||B - F @ A||.

    Used to estimate the scan-affine correction from measured against ideal
    lattice vectors.
    """
    from scipy.optimize import minimize

    def objective(x):
        return np.linalg.norm(output_basis - compose_affine_matrix(*x) @ input_basis)

    res = minimize(objective, [1.0, 0.0, 0.0, 0.0], method="L-BFGS-B")
    if not res.success:
        raise ValueError("Affine fit failed to converge")
    return tuple(res.x)
