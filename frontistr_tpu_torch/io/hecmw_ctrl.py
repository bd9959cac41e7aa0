"""Reader for ``hecmw_ctrl.dat`` — the top-level file-binding control file.

Replicates the subset of hecmw1/src/common/hecmw_control.c that binds names
to files: ``!MESH`` (TYPE=HECMW-ENTIRE|HECMW-DIST|ABAQUS...), ``!CONTROL``,
``!RESULT`` (IO=IN|OUT), ``!RESTART``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass
class FileBinding:
    name: str
    kind: str          # MESH / CONTROL / RESULT / RESTART
    path: str
    params: Dict[str, str]


@dataclasses.dataclass
class HecmwCtrl:
    bindings: Dict[str, FileBinding]
    base_dir: str

    def mesh(self, name: str = "fstrMSH") -> FileBinding:
        return self.bindings[name]

    def control(self, name: str = "fstrCNT") -> FileBinding:
        return self.bindings[name]

    def result(self, name: str = "fstrRES") -> Optional[FileBinding]:
        return self.bindings.get(name)

    def restart(self, name: str = "restart") -> Optional[FileBinding]:
        for b in self.bindings.values():
            if b.kind == "RESTART":
                return b
        return None

    def path(self, binding: FileBinding) -> str:
        return os.path.join(self.base_dir, binding.path)


def _parse_header(line: str):
    body = line.lstrip()[1:]
    parts = [p.strip() for p in body.split(",")]
    card = parts[0].upper()
    params = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            params[k.strip().upper()] = v.strip()
        elif p:
            params[p.upper()] = "1"
    return card, params


def read_hecmw_ctrl(path: str) -> HecmwCtrl:
    base_dir = os.path.dirname(os.path.abspath(path))
    bindings: Dict[str, FileBinding] = {}
    card, params = None, None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("!!"):
                continue
            if line.startswith("!"):
                card, params = _parse_header(line)
                continue
            if card in ("MESH", "CONTROL", "RESULT", "RESTART"):
                name = params.get("NAME", card)
                bindings[name] = FileBinding(name, card, line.strip(), params)
                card = None
    return HecmwCtrl(bindings, base_dir)
