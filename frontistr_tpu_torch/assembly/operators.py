"""Dirichlet helpers shared by the operators (torch port of
``frontistr_tpu/assembly/operators.py``: ``make_free_mask``,
``full_fixed_vector``).

Dirichlet conditions use the projection form of the reference's
row/column elimination (hecmw_mat_ass.f90:292-429):
    A_c x = P A P x + (I-P) x,   b_c = P (b - A u_fix) + u_fix
where P zeroes fixed dofs.
"""

from __future__ import annotations

import numpy as np


def make_free_mask(n_dof: int, fixed_dofs: np.ndarray) -> np.ndarray:
    mask = np.ones(n_dof)
    if len(fixed_dofs):
        mask[fixed_dofs] = 0.0
    return mask


def full_fixed_vector(n_dof: int, fixed_dofs: np.ndarray,
                      fixed_vals: np.ndarray) -> np.ndarray:
    u = np.zeros(n_dof)
    if len(fixed_dofs):
        u[fixed_dofs] = fixed_vals
    return u
