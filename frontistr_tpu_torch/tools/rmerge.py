"""rmerge / rconv — result-file tools (host code copied from
``frontistr_tpu/tools/rmerge.py``; only the imports differ).

- merge_results: combine per-rank result files onto the entire mesh
  (fstr_rmerge, hecmw1/tools/result_file_merger/fstr_rmerge.c:242) — per-rank
  node/element global IDs key the merge.
- convert_result: text <-> npz-binary result conversion (rconv,
  hecmw1/tools/result_type_converter).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.io.resfile import read_result, write_result


def merge_results(paths: List[str], out_path: str):
    """Merge per-rank text result files (global-ID keyed union)."""
    parts = [read_result(p) for p in paths]
    header = parts[0]["header"]

    def merge_section(key_ids, key_comps):
        all_ids: Dict[int, int] = {}
        for p in parts:
            for gid in p[key_ids]:
                all_ids.setdefault(int(gid), len(all_ids))
        ids_sorted = np.asarray(sorted(all_ids), dtype=np.int64)
        remap = {int(g): i for i, g in enumerate(ids_sorted)}
        comps = []
        if parts[0][key_comps]:
            for ci, (label, arr0) in enumerate(parts[0][key_comps]):
                out = np.zeros((len(ids_sorted), arr0.shape[1]))
                for p in parts:
                    ids = p[key_ids]
                    arr = p[key_comps][ci][1]
                    for k, gid in enumerate(ids):
                        out[remap[int(gid)]] = arr[k]
                comps.append((label, out))
        return ids_sorted, comps

    node_ids, node_comps = merge_section("node_ids", "node_comps")
    elem_ids, elem_comps = merge_section("elem_ids", "elem_comps")
    write_result(out_path, header, node_ids, elem_ids, node_comps,
                 elem_comps)


def convert_result(in_path: str, out_path: str, to: str = "binary"):
    """Result conversion: text <-> reference HECMW binary <-> npz.

    to="binary": write the reference HECMW_BINARY_RESULT format
    (hecmw_bin_io.c); to="npz": compressed numpy archive; to="text":
    reference text.  Input format is auto-detected (magic / npz / text).
    """
    from frontistr_tpu_torch.io.resfile import (read_result_any,
                                          write_result_bin)
    if in_path.endswith(".npz"):
        z = np.load(in_path, allow_pickle=False)
        node_comps, elem_comps = [], []
        for k in sorted(z.files):
            if k.startswith("n") and ":" in k:
                node_comps.append((k.split(":", 1)[1], z[k]))
            elif k.startswith("e") and ":" in k:
                elem_comps.append((k.split(":", 1)[1], z[k]))
        data = dict(header=str(z["header"]), node_ids=z["node_ids"],
                    elem_ids=z["elem_ids"], node_comps=node_comps,
                    elem_comps=elem_comps)
    else:
        data = read_result_any(in_path)
    if to == "npz":
        flat = {"header": np.asarray(data["header"]),
                "node_ids": data["node_ids"], "elem_ids": data["elem_ids"]}
        for i, (lab, arr) in enumerate(data["node_comps"]):
            flat[f"n{i}:{lab}"] = arr
        for i, (lab, arr) in enumerate(data["elem_comps"]):
            flat[f"e{i}:{lab}"] = arr
        np.savez_compressed(out_path, **flat)
    else:
        w = write_result_bin if to == "binary" else write_result
        w(out_path, data["header"], data["node_ids"], data["elem_ids"],
          data["node_comps"], data["elem_comps"])
