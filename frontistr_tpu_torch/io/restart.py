"""Checkpoint / restart in one ``.npz`` (copied from the JAX package's
``frontistr_tpu/io/restart.py``; host numpy, no torch).

The counterpart of the reference's per-rank binary restart blobs
(hecmw1/src/common/hecmw_restart.c + fistr1/src/analysis/static/
fstr_Restart.f90: step counters, unode, QFORCE, gauss status, contact
state): the analysis state is a nested dict/list of numpy arrays
flattened to one compressed ``.npz``.  The flat keys are the JAX
package's, so a file either package writes loads in the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

FORMAT_VERSION = 1


def _flatten(prefix: str, obj, out: Dict[str, np.ndarray]):
    if isinstance(obj, dict):
        if not obj:
            # sentinel: without it, empty containers (e.g. stateless
            # shell/beam blocks' gauss state) vanish from the flat keyset and
            # load_restart reconstructs a truncated/misaligned structure
            out[f"{prefix}#emptydict"] = np.zeros(0)
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}", v, out)
    elif isinstance(obj, (list, tuple)):
        if not obj:
            out[f"{prefix}#emptylist"] = np.zeros(0)
        for i, v in enumerate(obj):
            _flatten(f"{prefix}[{i}]", v, out)
    elif obj is None:
        out[f"{prefix}#none"] = np.zeros(0)
    else:
        out[prefix] = np.asarray(obj)


def save_restart(path: str, payload: Dict[str, Any]):
    """payload: nested dict/list of arrays + scalars."""
    flat: Dict[str, np.ndarray] = {"__version__": np.asarray(FORMAT_VERSION)}
    _flatten("r", payload, flat)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **flat)
    os.replace(tmp, path)


def load_restart(path: str) -> Dict[str, Any]:
    data = np.load(path, allow_pickle=False)
    root: Dict[str, Any] = {}

    def insert(container, keys, value):
        k = keys[0]
        if len(keys) == 1:
            if isinstance(container, list):
                container.extend([None] * (int(k) + 1 - len(container)))
                container[int(k)] = value
            else:
                container[k] = value
            return
        nxt_is_list = keys[1].isdigit()
        if isinstance(container, list):
            idx = int(k)
            container.extend([None] * (idx + 1 - len(container)))
            if container[idx] is None:
                container[idx] = [] if nxt_is_list else {}
            insert(container[idx], keys[1:], value)
        else:
            if k not in container:
                container[k] = [] if nxt_is_list else {}
            insert(container[k], keys[1:], value)

    for key in data.files:
        if key == "__version__":
            continue
        arr = data[key]
        if key.endswith("#none"):
            key = key[:-len("#none")]
            arr = None
        elif key.endswith("#emptydict"):
            key = key[:-len("#emptydict")]
            arr = {}
        elif key.endswith("#emptylist"):
            key = key[:-len("#emptylist")]
            arr = []
        parts = []
        for tok in key.split(".")[1:] if key.startswith("r.") else \
                [key[2:]] if key.startswith("r[") else key.split(".")[1:]:
            parts.append(tok)
        # normalize "name[3]" tokens
        norm: List[str] = []
        head = key[2:] if key.startswith("r.") else key[1:]
        for tok in head.replace("]", "").replace("[", ".").split("."):
            if tok != "":
                norm.append(tok)
        insert(root, norm, arr)
    return root
