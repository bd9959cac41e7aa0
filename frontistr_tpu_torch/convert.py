"""Carry a model built elsewhere into the port.

``model_from_numpy`` takes the numpy fields of a model of the JAX
package (``frontistr_tpu.assembly.model.StructModel``: coords, block
connectivity, dofs and elastic matrices, Dirichlet dofs and values,
external force) and builds the port's ``StructModel`` on a device, plus
the element matrices as device tensors when given.  It reads attributes
only and imports nothing of JAX, so the parity tests can feed both
packages identical inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.assembly.model import KBlock, StructModel
from frontistr_tpu_torch.fem import material as mat


def model_from_numpy(src, device="cpu",
                     kes: Optional[Sequence[np.ndarray]] = None):
    """Port ``StructModel`` on ``device`` from ``src``'s numpy fields.

    Returns the model, or ``(model, kes)`` with the element matrices as
    float64 tensors on ``device`` when ``kes`` is given."""
    dev = torch.device(device)
    blocks = []
    for b in src.blocks:
        m = mat.Material(b.material.name, youngs=b.material.youngs,
                         poisson=b.material.poisson,
                         density=b.material.density)
        blocks.append(KBlock(
            int(b.etype), np.asarray(b.elem_ids),
            np.asarray(b.conn, np.int32), np.asarray(b.dofs, np.int32),
            np.asarray(b.D, np.float64), float(b.thick), int(b.iset),
            np.asarray(b.density, np.float64), m, int(b.sect_id),
            formulation=b.formulation, kind=b.kind))
    model = StructModel(
        mesh=src.mesh, cfg=src.cfg, ndof=int(src.ndof), dim=int(src.dim),
        n_node=int(src.n_node),
        coords=np.asarray(src.coords, np.float64), blocks=blocks,
        fixed_dofs=np.asarray(src.fixed_dofs, np.int64),
        fixed_vals=np.asarray(src.fixed_vals, np.float64),
        f_ext=np.asarray(src.f_ext, np.float64), device=dev,
        nlgeom=bool(src.nlgeom))
    if kes is None:
        return model
    return model, [torch.tensor(np.asarray(k, np.float64), device=dev)
                   for k in kes]
