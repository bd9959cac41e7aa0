"""Command-line tool entry points (the reference's file-based workflow).

Reference tool surfaces:
- ``fistr-torch-part``     -> hecmw_part1 (hecmw1/tools/partitioner/
  hecmw_partition.c): entire mesh -> per-rank HECMW-DIST files.
- ``fistr-torch-rmerge``   -> fstr_rmerge (hecmw1/tools/result_file_merger/
  fstr_rmerge.c:242): per-rank result files -> whole-model result file.
- ``fistr-torch-rconv``    -> rconv (hecmw1/tools/result_type_converter):
  text <-> HECMW binary <-> npz result conversion.
- ``fistr-torch-neu2fstr`` -> neu2fstr (fistr1/tools/neu2fstr/neu2fstr.cpp:359):
  FEMAP neutral file -> native .msh.

- ``fistr-torch-rebalance`` -> hecmw_dlb: repartition a HECMW-DIST
  work directory in place, optionally after adaptive refinement.

Each wraps a library function of the port; the CLI adds argument
parsing, format auto-detection, and progress prints only.  Options and
messages are those of ``frontistr_tpu/tools/cli.py``.
"""

from __future__ import annotations

import argparse
import sys


def _read_any_mesh(path: str):
    """Mesh reader with format auto-detection by extension (the ctrl-file
    TYPE= dispatch in run.py:28-48, keyed by filename instead)."""
    low = path.lower()
    if low.endswith((".inp",)):
        from frontistr_tpu_torch.io.abaqusio import read_abaqus
        return read_abaqus(path)
    if low.endswith((".nas", ".bdf", ".dat")):
        from frontistr_tpu_torch.io.nastranio import read_nastran
        return read_nastran(path)
    if low.endswith(".neu"):
        from frontistr_tpu_torch.io.neu import read_neu
        return read_neu(path)
    from frontistr_tpu_torch.io.meshio import read_mesh
    return read_mesh(path)


def part_main(argv=None):
    """hecmw_part1 equivalent: entire mesh -> '<out>.<rank>' DIST files."""
    ap = argparse.ArgumentParser(
        prog="fistr-torch-part",
        description="Partition an entire mesh into per-rank HECMW-DIST "
                    "files (hecmw_part1 equivalent).")
    ap.add_argument("mesh", help="entire mesh (.msh/.inp/.nas/.neu)")
    ap.add_argument("-n", "--n-parts", type=int, required=True,
                    help="number of subdomains")
    ap.add_argument("-o", "--out", required=True,
                    help="output base; writes '<out>.<rank>'")
    ap.add_argument("-m", "--method", default="RCB",
                    choices=["RCB", "BLOCK", "KMETIS"],
                    help="partitioning method (KMETIS = spectral graph "
                         "K-way, the METIS-quality option)")
    ap.add_argument("--check-mesh", action="store_true",
                    help="also write '<out>.check.inp': an AVS UCD dump "
                         "of the whole mesh with per-element/per-node "
                         "rank ids (the reference partitioner's UCD "
                         "check-mesh output)")
    a = ap.parse_args(argv)
    from frontistr_tpu_torch.parallel.partition import partition_to_files
    mesh = _read_any_mesh(a.mesh)
    print(f"### partitioning {a.mesh}: {mesh.n_node} nodes, "
          f"{mesh.n_elem} elements -> {a.n_parts} subdomains ({a.method})")
    paths = partition_to_files(mesh, a.n_parts, a.out, method=a.method)
    for p in paths:
        print(f"  wrote {p}")
    if a.check_mesh:
        import numpy as np
        from frontistr_tpu_torch.io.ucd import write_ucd
        from frontistr_tpu_torch.io.distio import read_dist
        nrank = np.zeros(mesh.n_node)
        erank_map = {}
        for r, p in enumerate(paths):
            dm = read_dist(p)
            own = np.asarray(dm.node_ID).reshape(-1, 2)[:, 1] == r
            for g in np.asarray(dm.global_node_ID)[own]:
                nrank[mesh.id2idx[int(g)]] = r
            eint = np.asarray(dm.elem_internal_list) - 1 \
                if dm.elem_internal_list is not None else \
                np.arange(dm.n_elem_gross)
            for ge in np.asarray(dm.global_elem_ID)[eint]:
                erank_map.setdefault(int(ge), float(r))
        erank = np.concatenate([
            [erank_map.get(int(e), 0.0) for e in b.elem_ids]
            for b in mesh.blocks])
        cp = a.out + ".check.inp"
        write_ucd(mesh, cp, node_data=[("NODE_RANK", nrank)],
                  elem_data=[("ELEM_RANK", np.asarray(erank, float))])
        print(f"  wrote {cp}")
    return 0


def rmerge_main(argv=None):
    """fstr_rmerge equivalent: per-rank result files -> one whole file."""
    ap = argparse.ArgumentParser(
        prog="fistr-torch-rmerge",
        description="Merge per-rank result files onto the entire model "
                    "(fstr_rmerge equivalent).")
    ap.add_argument("inputs", nargs="+", help="per-rank result files")
    ap.add_argument("-o", "--out", required=True,
                    help="merged whole-model result file")
    a = ap.parse_args(argv)
    from frontistr_tpu_torch.tools.rmerge import merge_results
    merge_results(a.inputs, a.out)
    print(f"### merged {len(a.inputs)} rank files -> {a.out}")
    return 0


def rconv_main(argv=None):
    """rconv equivalent: result file format conversion."""
    ap = argparse.ArgumentParser(
        prog="fistr-torch-rconv",
        description="Convert result files between text, HECMW binary, "
                    "and npz (rconv equivalent).")
    ap.add_argument("input", help="input result file (format auto)")
    ap.add_argument("output", help="output path")
    ap.add_argument("-t", "--to", default="binary",
                    choices=["text", "binary", "npz"],
                    help="output format (default: binary)")
    a = ap.parse_args(argv)
    from frontistr_tpu_torch.tools.rmerge import convert_result
    convert_result(a.input, a.output, to=a.to)
    print(f"### converted {a.input} -> {a.output} ({a.to})")
    return 0


def neu2fstr_main(argv=None):
    """neu2fstr equivalent: FEMAP neutral -> native .msh."""
    ap = argparse.ArgumentParser(
        prog="fistr-torch-neu2fstr",
        description="Convert a FEMAP neutral file to a native mesh "
                    "(neu2fstr equivalent).")
    ap.add_argument("input", help="FEMAP .neu file")
    ap.add_argument("output", help="output .msh path")
    ap.add_argument("cnt", nargs="?", default=None,
                    help="optional output .cnt carrying the converted "
                         "506/507 constraints and loads")
    a = ap.parse_args(argv)
    from frontistr_tpu_torch.io.neu import neu2fstr
    mesh = neu2fstr(a.input, a.output, cnt_path=a.cnt)
    print(f"### {a.input}: {mesh.n_node} nodes, {mesh.n_elem} elements "
          f"-> {a.output}")
    return 0


def rebalance_main(argv=None):
    """hecmw_dlb equivalent: repartition a DIST workdir in place."""
    ap = argparse.ArgumentParser(
        prog="fistr-torch-rebalance",
        description="Dynamic load balancing: reassemble a partitioned "
                    "'<base>.<rank>' workdir, optionally refine marked "
                    "elements, and re-partition it balanced in place "
                    "(hecmw_dlb equivalent).")
    ap.add_argument("base", help="DIST base path; reads '<base>.<rank>'")
    ap.add_argument("-n", "--n-parts", type=int, default=None,
                    help="new subdomain count (default: keep current)")
    ap.add_argument("-m", "--method", default="RCB",
                    choices=["RCB", "BLOCK", "KMETIS"])
    ap.add_argument("--refine", default=None,
                    help="comma-separated global element ids to refine "
                         "before repartitioning (adaptation+DLB pipeline)")
    a = ap.parse_args(argv)
    from frontistr_tpu_torch.parallel.rebalance import rebalance_workdir
    marked = [int(t) for t in a.refine.split(",")] if a.refine else None
    rebalance_workdir(a.base, n_parts=a.n_parts, method=a.method,
                      marked_eids=marked, verbose=True)
    return 0


if __name__ == "__main__":   # python -m frontistr_tpu_torch.tools.cli <tool>
    tool = sys.argv[1] if len(sys.argv) > 1 else ""
    fn = {"part": part_main, "rmerge": rmerge_main, "rconv": rconv_main,
          "neu2fstr": neu2fstr_main, "rebalance": rebalance_main}.get(tool)
    if fn is None:
        print("usage: python -m frontistr_tpu_torch.tools.cli "
              "{part|rmerge|rconv|neu2fstr|rebalance} ...", file=sys.stderr)
        sys.exit(2)
    sys.exit(fn(sys.argv[2:]))
