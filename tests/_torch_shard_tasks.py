"""Tasks the sharded tests run on every rank of a ``RankPool`` (the port
only: the ranks import no JAX), and the pools themselves."""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from frontistr_tpu_torch.parallel import dist


@contextlib.contextmanager
def pools(*sizes):
    """One ``RankPool`` per size on the CPU, started together."""
    ps = {n: dist.RankPool(n, "cpu") for n in sizes}
    try:
        yield ps
    finally:
        for p in ps.values():
            p.close()


@contextlib.contextmanager
def _env(env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def summary(out) -> dict:
    """The numbers a test holds of a ``run_directory`` output."""
    got = {"node_ids": np.asarray(out["mesh"].node_ids)}
    res = out.get("static")
    if res is not None:
        got["u"] = np.asarray(res.u).reshape(-1)
        got["iters"] = int(res.iters)
        got["passes"] = int(res.passes or 0)
        if res.newton is not None:
            got["cg"] = [h["cg_iters"] for h in res.newton.history]
            got["yielded"] = [h["yielded"] for h in res.newton.history]
        for k in ("nodal_stress", "elem_stress", "node_count"):
            got[k] = np.asarray(getattr(res, k))
    dr = out.get("dynamic")
    if dr is not None:
        got.update(u=_host(dr.u).reshape(-1), vel=_host(dr.vel).reshape(-1),
                   cg=[list(h["cg"]) for h in dr.history],
                   newton=[h["newton"] for h in dr.history])
    er = out.get("eigen")
    if er is not None:
        got.update(eigenvalues=np.asarray(er.eigenvalues),
                   vectors=np.asarray(er.eigenvectors),
                   cg=[h["cg"] for h in er.history])
    hr = out.get("heat")
    if hr is not None:
        got.update(T=_host(hr.T).reshape(-1),
                   cg=[list(h["cg"]) for h in hr.history])
    return got


def run(workdir: str, env: dict = None) -> dict:
    """A rank's run of the work directory, ``env`` set around it; the
    rank, its K1 launches and ``summary`` of its output."""
    from frontistr_tpu_torch.assembly import segsum
    from frontistr_tpu_torch.run import run_rank
    k0 = segsum.segsum.launches + segsum.segsum_planes.launches
    with _env(env or {}):
        out = run_rank(workdir)
    got = summary(out)
    got.update(rank=dist.current().rank,
               k1=segsum.segsum.launches + segsum.segsum_planes.launches
               - k0)
    return got


def one_run(workdir: str, env: dict = None) -> dict:
    """``summary`` of the port's single-device CPU run of a copy of the
    work directory."""
    import shutil
    from frontistr_tpu_torch.run import run_directory
    wd = workdir.rstrip("/") + "_one"
    shutil.copytree(workdir, wd)
    with _env(env or {}):
        return summary(run_directory(wd, device="cpu"))


def jax_run(workdir: str, env: dict = None) -> dict:
    """The JAX package's single-device output of a copy of the work
    directory (imported here: the ranks never call it)."""
    import shutil
    import frontistr_tpu.run as jrun
    wj = workdir.rstrip("/") + "_jax"
    shutil.copytree(workdir, wj)
    with _env(env or {}):
        return jrun.run_directory(wj)


_REFS: dict = {}


def references(key, workdir: str, env: dict = None):
    """(the JAX package's output, ``one_run``) of a deck, run once per
    ``key`` in this process: the tests of one deck on 2 and on 3 ranks
    share them (each writes the same deck)."""
    if key not in _REFS:
        _REFS[key] = (jax_run(workdir, env), one_run(workdir, env))
    return _REFS[key]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def whole_arrays(workdir: str, env: dict = None) -> dict:
    """Run the work directory with ``BlockPrograms`` watched: the largest
    element count any of this rank's element programs saw."""
    from frontistr_tpu_torch.analysis import nonlinear as nl
    seen = []
    orig = nl.BlockPrograms.__init__

    def spy(self, model, block):
        seen.append(int(block.conn.shape[0]))
        orig(self, model, block)

    nl.BlockPrograms.__init__ = spy
    try:
        got = run(workdir, env)
    finally:
        nl.BlockPrograms.__init__ = orig
    got["seen"] = seen
    return got


def profiles(cache_dir: str, n: tuple) -> dict:
    """Build a box's ELL and cluster profiles with the profile cache at
    ``cache_dir`` (rank 0 first, the others behind the barrier); their
    arrays and whether this rank found them on disk."""
    from frontistr_tpu_torch.assembly import bell, ell, profcache
    from frontistr_tpu_torch.meshgen import box_tet4
    mesh = box_tet4(*n)
    conns = [b.conn for b in mesh.blocks]
    with _env({"FRONTISTR_TPU_CACHE_DIR": cache_dir}):
        key = profcache.conn_key(conns, mesh.n_node, 3, tag="torch-ell")
        with profcache.rank_zero_first():
            found = profcache.load(key) is not None
            ell._PROFILE_CACHE.clear()
            bell._CPROFILE_CACHE.clear()
            model = type("M", (), dict(blocks=mesh.blocks,
                                       n_node=mesh.n_node, ndof=3))()
            prof = ell.profile_from_model(model)
            cprof = bell.cluster_profile_from_model(model, scalar=prof)
    arrays = {f"ell.{f.name}": np.asarray(getattr(prof, f.name))
              for f in dataclasses.fields(prof)
              if isinstance(getattr(prof, f.name), np.ndarray)}
    arrays.update({f"bell.{f.name}": np.asarray(getattr(cprof, f.name))
                   for f in dataclasses.fields(cprof)
                   if isinstance(getattr(cprof, f.name), np.ndarray)})
    return dict(found=found, arrays=arrays)


def sharded_step(n: tuple, cg_iters: int, tol: float) -> np.ndarray:
    """``spmd.make_sharded_newton_step`` on a box_hex8 cantilever in this
    rank's group; the whole displacement."""
    from frontistr_tpu_torch.fem.material import D3, elastic_D
    from frontistr_tpu_torch.meshgen import box_hex8
    from frontistr_tpu_torch.parallel.spmd import make_sharded_newton_step
    mesh = box_hex8(*n)
    conn = mesh.blocks[0].conn
    D1 = elastic_D(210e3, 0.3, D3)
    fixed = (mesh.node_groups["X0"][:, None] * 3 +
             np.arange(3)[None, :]).reshape(-1)
    f = np.zeros(mesh.n_node * 3)
    f[mesh.node_groups["X1"] * 3 + 2] = -1.0
    step, info = make_sharded_newton_step(361, conn, mesh.n_node, 3, D1,
                                          fixed, cg_iters=cg_iters, tol=tol)
    return step(mesh.coords, f).cpu().numpy()


def adapted_static() -> np.ndarray:
    """``tests/test_adapt.py::test_adapt_then_sharded_solve_matches`` in
    the port: a corner-loaded box_tet4(3) solved, adapted by its ZZ error
    (``adapt.adapt_by_error``, 20 %), rebuilt and solved again, in this
    process's group (sharded) or alone; the second displacement."""
    from frontistr_tpu_torch.adapt import adapt_by_error
    from frontistr_tpu_torch.analysis.static import run_linear_static
    from frontistr_tpu_torch.assembly.model import build_struct_model
    from frontistr_tpu_torch.io.ctrlio import AnalysisConfig, Card, StepInfo
    from frontistr_tpu_torch.meshgen import box_tet4
    m = box_tet4(3, 3, 3)
    cfg = AnalysisConfig()
    cfg.solution_type = "STATIC"
    cfg.steps = [StepInfo()]
    cfg.boundaries = [Card("BOUNDARY", {}, [["Z0", "1", "3", "0.0"]])]
    corner = int(np.argmin(((m.coords - 1.0) ** 2).sum(1)))
    cfg.cloads = [Card("CLOAD", {}, [[str(corner + 1), "3", "-1000.0"]])]
    with _env({"FRONTISTR_TPU_CACHE_DIR": "0",
               "FRONTISTR_TPU_PRECISION": "f64"}):
        res = run_linear_static(build_struct_model(m, cfg, device="cpu"))
        m2 = adapt_by_error(m, res, 0.2)
        assert m2.n_elem > m.n_elem
        return np.asarray(run_linear_static(
            build_struct_model(m2, cfg, device="cpu")).u)


def _short_group(timeout_s):
    import datetime
    return torch.distributed.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))


def slow_reduce(sleep_s, timeout_s):
    """Sleep past the collective timeout of a new group, then sum one
    over it: no collective waits, so the task ends."""
    import time
    g = _short_group(timeout_s)
    time.sleep(sleep_s)
    x = torch.ones(1)
    torch.distributed.all_reduce(x, group=g)
    return float(x)


def hung_reduce(timeout_s):
    """Rank 1 alone enters a sum: its collective times out."""
    g = _short_group(timeout_s)
    if dist.current().rank == 1:
        torch.distributed.all_reduce(torch.ones(1), group=g)
    return 0.0


def amg_gap(m: int) -> dict:
    """The one-device AMG preconditioner and operator against the
    sharded ones of this rank (``RowSolver.cluster``) on the rank's rows,
    for a random vector: the tangent of a RCM-ordered box_tet4(m) at a
    small random displacement (nodes padded when (m+1)^3 is not a
    multiple of 8 ranks).  Returns the max relative gaps."""
    import tempfile
    from frontistr_tpu_torch import ordering
    from frontistr_tpu_torch.analysis import nonlinear as nl
    from frontistr_tpu_torch.analysis import static as st
    from frontistr_tpu_torch.assembly import operators as old_ops
    from frontistr_tpu_torch.assembly.model import build_struct_model
    from frontistr_tpu_torch.io.ctrlio import read_cnt
    from frontistr_tpu_torch.meshgen import box_tet4
    from frontistr_tpu_torch.parallel.shard import (RowSolver, local_model,
                                                    row_split)
    comm = dist.current()
    mesh = box_tet4(m, m, m)
    mesh = ordering.permute_mesh(mesh, ordering.rcm_order(
        [b.conn for b in mesh.blocks], mesh.n_node))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "case.cnt")
        with open(path, "w") as f:
            f.write(deck_nlstatic())
        model = build_struct_model(mesh, read_cnt(path), device="cpu")
    n, nn = model.n_dof_total, model.n_node
    free = torch.as_tensor(old_ops.make_free_mask(n, model.fixed_dofs),
                           dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    u = 1e-3 * torch.randn(n, generator=g, dtype=torch.float64)
    z = torch.zeros(n, dtype=torch.float64)
    kes = []
    for b in model.blocks:
        p = nl.BlockPrograms(model, b)
        kes.append(p.tangent(nl._element_values(u, p, nn, 3),
                             nl._element_values(z, p, nn, 3),
                             nl.init_block_state(b, p.table, "cpu")))
    A1, M1 = st.cluster_operator(st.cluster_setup(model, {}, policy="amg"),
                                 model, kes, free, torch.float64, {})
    split = row_split(comm, nn, 3)
    rs = RowSolver(model, local_model(model, split), split, free, False,
                   {}, policy="amg", select=True)
    A2, M2 = rs.cluster(rs.local_kes(kes), torch.float64)
    r = torch.randn(n, generator=g, dtype=torch.float64)

    def gap(a, b):
        return float((a - b).abs().max() / a.abs().max())
    return dict(n_pad=split.n_pad, A=gap(split.own(A1(r)), A2(split.own(r))),
                M=gap(split.own(M1(r)), M2(split.own(r))))


def deck_nlstatic() -> str:
    return ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n"
            " X0, 1, 3, 0.0\n!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n"
            "!ELASTIC\n 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n"
            " LOAD, 1\n!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n"
            "!END\n")
