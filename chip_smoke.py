"""Smoke run of the PyTorch/CUDA port on one card: builds the kernels,
holds each against its plain PyTorch version, drives the main paths
once, checks the answers and prints the result.

    python3 chip_smoke.py [--n N] [--krylov-n K] [--ssor-n S] [--hex H]
                          [--newton-n M] [--plastic P]
                          [--dyn-n D] [--dyn-steps S] [--dyn-hex X]
                          [--dyn-hex-steps T] [--heat-n H] [--heat-steps S]
                          [--eigen-n E] [--hex20-n H] [--direct-n D]
                          [--plane-n P] [--hyper-n H] [--hyper-substeps S]
                          [--contact-n C] [--shell-n S] [--flow-n F]
                          [--flow-steps F]

- The nonlinear static (Newton) tet path through
  ``frontistr_tpu_torch.run.run_directory`` (the function behind
  ``python -m frontistr_tpu_torch``): the deck of ``bench.py:83-88``
  (NLSTATIC, total Lagrange) on a shuffled ``box_tet4(m, m, m)``,
  3*(m+1)^3 dofs and 6*m^3 tets (default m=69: 1,029,000 dofs, 1,971,054
  tets), one K1 assembly per Newton iteration.  Then the profile cache
  (``assembly/profcache.py``) at that mesh: the ELL and cluster profiles
  built and saved cold into a fresh directory under ``build/``, then
  loaded warm, bit-equal; every other phase runs with
  FRONTISTR_TPU_CACHE_DIR=0.
- The linear-static tet path through ``run_directory``: the STATIC deck
  on a shuffled ``box_tet4(n, n, n)`` (default n=40: 206,763 dofs).
- The solver menu: the STATIC tet deck with METHOD=BICGSTAB (RESID
  1e-9) on a shuffled ``box_tet4(k)`` (default k=32;
  69 is the newton cell's box)
  through ``run_directory``, the scalar block-ELL operator whose blocks
  K1 sums once at the ELL profile's plan; GMRES(30) and GPBiCG through
  ``solve_linear`` on the same model; the CG/AMG answer beside them;
  GMRES held at ``box_tet4(n)`` when it stops at NIER at k.  Then K1 at
  that plan.  The Newton deck with PRECOND=10 (multicolor block SSOR)
  on a shuffled ``box_tet4(s)`` (default s=32; 69 for timing).
- The structured hex8 path through the library entry points
  ``build_struct_model`` + ``run_linear_static``: ``box_hex8(h, h, h)``
  (default h=69: 1,029,000 dofs, 328,509 elements), stencil operator
  with its element products through K2, in float32 and float64.  Then
  the box arm of ``bench.py`` (``microbench/box_twogrid.py``) on
  ``box_hex8(69)`` (``BOX_N``, never cut): f32 two-grid PCG on the
  dof-major stencil operator (K2 on every fine product, E = 328,509,
  and every coarse one, E = 12,167), refined in f64 to a true relres of
  1e-8 by the one-element ``ConstD`` operator and checked again by the
  node-major f64 operator; K2 at the coarse shape.
- The elastoplastic path through ``run_directory``: NLSTATIC on a
  shuffled ``box_hex8(p, p, p)`` (default p=48: 352,947 dofs, 110,592
  B-bar elements), !PLASTIC Mises, a follower pressure of 56 on the
  top faces of the top element layer, 2 substeps (no gauss point
  yields in the first, some in the second), !WRITE, RESULT read back;
  one K1 assembly per Newton iteration.  Then the same deck interrupted
  after substep 1 and resumed by !RESTART, bit-equal to it, and K1 at
  m = 30 (tet10).
- The gather microbenchmark ``frontistr_tpu_torch.microbench.gather``
  (K3-K6 on the shapes of ``scripts/microbench_pallas_gather.py``).
- Small decks on the card and on the CPU: tet AMG, hex8 stencil, the
  NLSTATIC tet deck, and the slice's hex8 B-bar and F-bar plastic,
  tet10 Drucker-Prager and STATIC DLOAD + TEMPERATURE decks.
- The dynamics paths through ``run_directory``: explicit central
  difference on a shuffled ``box_tet4(d, d, d)`` (default d=40), dt half
  the smallest element's critical step, S steps (300), the equation of
  motion checked at the last step; implicit Newmark on a shuffled
  ``box_hex8(x, x, x)`` (40), IC, Rayleigh damping, T steps (10), every
  solve's true relres checked; then small dynamics decks on the card
  and on the CPU.  These paths launch one kernel, K1's planes entry,
  once each, in the final nodal smoothing.
- The heat, eigen and frequency-response paths (no kernel), then small
  decks of those families on the card and on the CPU.
- The hex20_mpc path through ``run_directory``: NLSTATIC on a shuffled
  hex20 box of h (default 24: 181,875 dofs, 13,824 elements of type
  362), X1's u_z tied by
  !EQUATION to one master node, the load and a
  !SPRING on the master; K1 once per Newton iteration at m = 60 beside
  the spring block, its planes entry in the AMG setups, the nodal
  smoothing and every reduction of the elimination.  Then K1 at m = 60
  against its plain version and index_add_; METHOD=DIRECT on a shuffled
  box_hex8(d) (default 12), STATIC and NLSTATIC, against the CG path;
  the slice's small decks (prisms, hex20, !EQUATION, !SPRING,
  ROT_CENTER, DIRECT, ESTCOND, DUMPTYPE) on the card and on the CPU.
- The plane path through ``run_directory``: NLSTATIC on a shuffled
  plane-strain quad8 (242) box of p x p (default 300: 542,402 dofs,
  90,000 elements; 408 gives 1,002,050 dofs), the AMG at
  nd = 2; K1's nd = 2 element entry once
  per Newton iteration.  Then K1 at nd = 2 against its plain version and
  index_add_; the hex20_mpc deck with a NEOHOOKE material at its full
  load on a box of h (default 20); small decks of the
  2-D solids and the hyperelastic, viscoelastic (!TRS), creep,
  orthotropic, E(T) and user materials on the card and on the CPU.
- The contact path through ``run_directory``: the flat punch of n
  (default 48: a 48 x 48 x 24 hex8 base over 1 x 1 x 0.5 under a 46 x 46
  x 23 punch over 0.9 x 0.9 x 0.45, the meshes not matching; 339,123
  dofs, 2,209 slave nodes; 72 gives 1,135,947),
  SLAGRANGE, frictionless, NLSTATIC in two
  substeps; K1's planes entry in every reduction T^T of the elimination
  and the nodal smoothing.  Then the planes entry at its slot plan
  against its plain version and index_add_; small contact decks of
  every arm (ALAGRANGE, friction by BiCGSTAB, SLAGRANGE, the saddle
  system by MINRES, DIRECT, !EQUATION ties, implicit dynamics) on the
  card and on the CPU.
- Small decks of the solver menu (the methods and ids on the ELL and
  stencil arms, !EQUATION, Chebyshev, SSOR), of !RESTART (NLSTATIC in
  both formats, the contact drop, transient heat) and of !ECHO on the
  card and on the CPU.
- The shell path through ``run_directory``: linear STATIC of a shuffled
  square MITC4 (741) plate of s x s (default 300: 90,601 nodes,
  543,606 dofs; 408 gives 1,003,686), a = 1000 mm,
  thickness 50 mm (a/t = 20), clamped
  on its four edges, a uniform pressure on every element, once in the
  mixed and once in the f64 policy; K1's nd = 6 element entry once a
  run, its planes entry once in the shells' nodal sums.  Then K1 at
  nd = 6 against its plain version and index_add_ (f64 and f32); small
  shell, solid-shell and beam decks on the card and on the CPU.
- The band Cholesky (FRONTISTR_TPU_DIRECT=band with METHOD=DIRECT):
  EIGEN on the eigen path's cube against its CG answer, Newmark on a
  box_hex8 of the same size against the CG arm, and the direct path's
  box in EIGEN and DYNAMIC against host SuperLU.
- The flow path through ``run_directory``: the lid-driven cavity at
  Re = 100 on a shuffled ``box_tet4(f, f, f)`` unit cube made 3414
  (default f = 62: 250,047 nodes, 1,000,188 dofs, 1,429,968 elements),
  dt = 1/f, F steps (2) of the SUPG/PSPG stepper; K1's nd = 4 element
  entry and its planes entry (the right-hand side) once a step.  Then
  K1 at nd = 4 against its plain version and index_add_ (f64 and f32);
  small flow, band and PRECHECK/NZPROF decks on the card and on the CPU.
- The visual path through ``run_directory``: a shuffled ``box_tet4(v, v,
  v)`` (default v = 34: 235,824 tets) written as an ABAQUS ``.inp`` and
  refined once on load (``!MESH, TYPE=ABAQUS, REFINE=1``: 328,509 nodes,
  985,527 dofs, 1,886,592 tets), linear STATIC with the tet cell's
  CG/AMG card (K1's element entry once, its planes entry in the AMG
  setup and the nodal smoothing), ``!WRITE, VISUAL`` with the PVR volume
  rendered on the card, then the PSR surface of the same result on the
  host; small decks of the ABAQUS, NASTRAN, GEOFEM and HECMW-DIST
  readers, REFINE, per-interval pictures of heat and dynamics, the AVS
  output, FSTR.dbg.0 and FRONTISTR_TPU_PROFILE on the card and on the
  CPU.
- Small decks of the tools on the card and on the CPU: ``part`` of a
  box into 4 HECMW-DIST ranks, its run through ``run_directory``,
  ``rmerge``, ``rconv`` and VTK; ``rebalance`` with adaptive refinement
  and its run; ``!COUPLE`` in implicit and explicit dynamics with a peer
  process (the port's ``FileCoupler``); the staggered heat -> stress
  transfer; the box solve at n = 9.
- Several devices (``parallel/dist.py``, ``parallel/shard.py``): the
  shard ranks (the card count on NCCL with two or more cards, else two
  ranks sharing the card over gloo, then one rank on NCCL, one group
  after the other) run a copy of the Newton path's work directory
  through ``run_rank``, the rank entry of ``FRONTISTR_TPU_SHARDS``, cut
  in depth to CONVERG ``SHARD_CONVERG``: u within 1e-8 of the
  one-device run's u after as many Newton iterations, Newton iterations
  equal, CG within 2 a solve, K1 launched on every rank once a Newton
  iteration, 0.log, FSTR.sta and the result written once and
  FSTR.dbg.<rank> by every rank; then small decks of every sharded
  family (linear STATIC f64 and mixed, NLSTATIC AMG, implicit dynamics,
  EIGEN, heat, SLAGRANGE contact) against one card.

The run needs a CUDA card and exits non-zero without one, or when any
phase fails.  Work directories and the kernel build go under ``build/``
of the checkout.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels (time, plain time, one library call
for the same function, launches on the main path, the least time the
card could take), the line before that the card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")
# the deck of bench.py:83-88 (NLSTATIC: total Lagrange, Newton to 1e-6)
NLCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
         "!CLOAD\n X1, 3, {load}\n!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
         "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-8, 1.0, 0.0\n!END\n")
# the elastoplastic deck: NLSTATIC (hex8 in B-bar), a follower pressure
# on the top faces of the top element layer, !PLASTIC Mises with linear
# hardening (yield 250, H 1000), !WRITE, RESULT
PLCNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
         "{loads}!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n{plastic}"
         "{extra}!STEP, SUBSTEPS={sub}\n BOUNDARY, 1\n LOAD, 1\n"
         "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-8, 1.0, 0.0\n!WRITE, RESULT\n!END\n")
MISES = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"
# the follower pressure of the elastoplastic path: at box_hex8(48) no
# gauss point yields at half of it (substep 1), some do at all of it
PLASTIC_PRESSURE = 56.0
F32_TOL, F64_TOL = 1e-4, 1e-12      # x max|plain|
# K1 planes launches of one AMG setup (solver/amg.py coarse_levels: the
# level-1 blocks, then the dense level 2); a nodal smoothing makes one
PLANES_PER_AMG_SETUP = 2
# the SSOR Newton path's default box: its run at the newton cell's 69
# (PERF.md) would push the smoke past its time (--ssor-n 69 restores it)
SSOR_N = 32
# the depth of shard_main_path: the newton deck's !STEP CONVERG there,
# held to newton_main_path's u after as many Newton iterations.  At m = 69
# rres is 0.59 after the first: one iteration, which keeps the phase near
# the 150 s it may take (PERF.md: a second, on the stressed tangent, took
# 85 s more on 2 gloo ranks, and its CG count moves by up to 44 with the
# rounding of equal operators)
SHARD_CONVERG = 0.7
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; non-tensor-core flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    HBM rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tol_for(dtype) -> float:
    return F32_TOL if dtype == torch.float32 else F64_TOL


def check_same(name: str, got, again, want, dtype, label: str) -> float:
    """Kernel output against the plain version's; a relaunch must be
    bit-equal.  Returns max |kernel - plain|."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = tol_for(dtype) * float(want.abs().max())
    log(f"  {name} {label} {str(dtype)[6:]}: max_abs_err={err!r} "
        f"(tol {tol!r}), bit-equal relaunch={torch.equal(got, again)}")
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label})")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} relaunch not bit-equal ({label})")
    return err


def check_k1(sm, plan, kes, nns, dtype, label: str, nd: int = 3) -> float:
    kes = [k.to(dtype) for k in kes]
    return check_same("K1", sm.segsum(plan, kes, nns, nd),
                      sm.segsum(plan, kes, nns, nd),
                      sm.segsum_reference(plan, kes, nns, nd), dtype, label)


def check_planes(sm, plan, values, dtype, label: str) -> float:
    values = values.to(dtype)
    return check_same("K1 planes", sm.segsum_planes(values, plan),
                      sm.segsum_planes(values, plan),
                      sm.segsum_planes_reference(values, plan), dtype,
                      label)


def check_k2(em, keT, xeT, label: str) -> float:
    return check_same("K2", em.element_matvec_soa(keT, xeT),
                      em.element_matvec_soa(keT, xeT),
                      em.element_matvec_soa_reference(keT, xeT), keT.dtype,
                      label)


def tet10_mesh(mods, dims):
    """``box_tet4(*dims)`` raised to tet10 (342) by one node at the
    middle of every edge (no package has a tet10 generator)."""
    m = mods["box_tet4"](*dims)
    conn4 = m.blocks[0].conn.astype(np.int64)
    # the six edges in the order of 342's mid-edge nodes 4..9
    edges = np.stack([np.sort(conn4[:, list(e)], axis=1) for e in
                      ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))], 1)
    uniq, inv = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
    coords = np.concatenate([m.coords, m.coords[uniq].mean(axis=1)])
    conn = np.concatenate([conn4, m.n_node + inv.reshape(-1, 6)],
                          axis=1).astype(np.int32)
    hecmw = np.empty_like(conn)          # fstr[k] = hecmw[TABLE[k] - 1]
    hecmw[:, np.asarray(mods["hecmw2fstr"][342]) - 1] = conn
    m.coords = coords
    m.node_ids = np.arange(1, len(coords) + 1, dtype=np.int64)
    m.id2idx = {int(g): int(g) - 1 for g in m.node_ids}
    for g in ("X0", "X1", "Y0", "Y1", "Z0", "Z1"):
        x = coords[:, "XYZ".index(g[0])]
        m.node_groups[g] = np.flatnonzero(np.isclose(
            x, x.max() if g[1] == "1" else x.min())).astype(np.int64)
    m.node_groups["ALL"] = np.arange(len(coords), dtype=np.int64)
    m.blocks = [mods["ElemBlock"](342, m.blocks[0].elem_ids, conn, hecmw,
                                  0)]
    return m


def top_faces(mods, mesh):
    """(n, 2) rows (element id, face number) of the faces on the box's
    top side (z = max)."""
    b = mesh.blocks[0]
    top = np.isclose(mesh.coords[:, 2], mesh.coords[:, 2].max())
    nc = 3 if b.etype in (341, 342) else 4
    rows = [(int(e), f) for f, (_, ln) in
            enumerate(mods["face_tables"][b.etype], start=1)
            for e in b.elem_ids[top[b.conn[:, ln[:nc]]].all(axis=1)]]
    return np.asarray(rows, np.int64)


def write_plastic_workdir(path, mods, mesh, cnt):
    """The deck in ``path``, nodes shuffled (the RCM reorder then runs
    as on the tet path); element group TOP (the top element layer) and
    surface group STOP (its top faces)."""
    rows = top_faces(mods, mesh)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    mods["write_static_workdir"](
        path, mods["ordering"].permute_mesh(mesh, order), cnt,
        ngroups=("X0", "X1", "Z0", "Z1"),
        egroups={"TOP": np.unique(rows[:, 0])}, sgroups={"STOP": rows})
    return mesh.n_node * 3


def phase_k1_check(sm, bell, box_tet4, box_hex8, tet10, hex20):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # random sorted segments: empty slots and segments past 1024 entries
    n_slots = 50000
    seg = np.sort(np.r_[rng.integers(0, n_slots, 200000),
                        np.full(3000, 17), np.full(1500, 40000)])
    seg = seg[(seg < 1000) | (seg > 2000)].astype(np.int32)  # empty run
    P = len(seg)
    plan = sm.make_plan(rng.permutation(P).astype(np.int32), seg, n_slots,
                        (P,), dev)
    ke = torch.as_tensor(rng.standard_normal((P, 3, 3)), device=dev)
    values = torch.as_tensor(rng.standard_normal((13, P)), device=dev)
    for dt in (torch.float32, torch.float64):
        check_k1(sm, plan, [ke], [1], dt, "random segments")
        check_planes(sm, plan, values, dt, "random segments")
    # nd = 4 (the u-p flow element): random matrices with no symmetry on
    # a tet cluster profile, so a swap of i and j or of a and b shows
    mesh = box_tet4(16, 16, 16)
    conn = mesh.blocks[0].conn
    plan = bell.build_cluster_profile([conn], mesh.n_node, 4).plan(dev)
    ke = torch.as_tensor(rng.standard_normal((conn.shape[0], 16, 16)),
                         device=dev)
    for dt in (torch.float32, torch.float64):
        check_k1(sm, plan, [ke], [4], dt,
                 "nd = 4, box_tet4(16) cluster, not symmetric", nd=4)
    for label, mesh, nn in (("box_tet4(20) cluster", box_tet4(20, 20, 20), 4),
                            ("box_hex8(20) cluster", box_hex8(20, 20, 20),
                             8),
                            ("tet10 of box_tet4(12) cluster",
                             tet10((12, 12, 12)), 10),
                            ("hex20 of box_hex8(8) cluster",
                             hex20((8, 8, 8)), 20)):
        conn = mesh.blocks[0].conn
        cprof = bell.build_cluster_profile([conn], mesh.n_node, 3)
        m = 3 * nn
        kes = [torch.as_tensor(rng.standard_normal((conn.shape[0], m, m)),
                               device=dev)]
        for dt in (torch.float32, torch.float64):
            check_k1(sm, cprof.plan(dev), kes, [nn], dt, label)


def phase_k2_check(em):
    """Random inputs with E = 100,003 (no multiple of any block size)."""
    rng = np.random.default_rng(1)
    E = 100003
    keT = torch.as_tensor(rng.standard_normal((24, 24, E)), device="cuda")
    xeT = torch.as_tensor(rng.standard_normal((24, E)), device="cuda")
    for dt in (torch.float32, torch.float64):
        check_k2(em, keT.to(dt), xeT.to(dt), f"random E={E}")


def write_workdir(path: str, dims, ordering, box_tet4, write_workdir_fn,
                  cnt: str = CNT):
    mesh = box_tet4(*dims)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_workdir_fn(path, ordering.permute_mesh(mesh, order), cnt)
    return mesh.n_node * 3


def constrained_relres(model, kes, f, u_fix, free, x, gfac=0.0) -> float:
    """||b_c - A_c x|| / ||b_c|| of the system P K P x + (I-P) x =
    P (f - K u_fix) + (I-P) u_fix, with K applied by scattering the
    element matrices and the model's spring blocks with index_add_
    (independent of the cluster, stencil and incidence operators).  With
    !EQUATION, of the eliminated system: T^T (b_c - A_c x) over
    T^T (b_c - A_c g), g the equations' constants times ``gfac`` on the
    dependent dofs, T^T applied by index_add_ from the mesh's equations.
    f, u_fix, free, x: float64 device vectors."""
    dev = kes[0].device
    n = model.n_dof_total
    _, ex_dofs, ex_kes, _ = model.extras
    pairs = [(b.dofs, ke) for b, ke in zip(model.blocks, kes)] + \
        list(zip(ex_dofs, ex_kes))

    def K(v):
        y = torch.zeros(n, dtype=torch.float64, device=dev)
        for d, ke in pairs:
            d = torch.as_tensor(d, dtype=torch.int64, device=dev)
            ke = torch.as_tensor(ke, dtype=torch.float64, device=dev)
            y.index_add_(0, d.reshape(-1),
                         torch.einsum("eij,ej->ei", ke, v[d]).reshape(-1))
        return y

    def A_c(v):
        return K(v * free) * free + v * (1 - free)
    b_c = (f - K(u_fix)) * free + u_fix * (1 - free)
    r = b_c - A_c(x)
    if not model.mesh.equations:
        return float(torch.linalg.norm(r) / torch.linalg.norm(b_c))
    eqs = model.mesh.equations
    dep = torch.as_tensor([int(e.nodes[0]) * 3 + int(e.dofs[0]) - 1
                           for e in eqs], device=dev)
    mast = torch.as_tensor([int(nd) * 3 + int(d) - 1 for e in eqs
                            for nd, d in zip(e.nodes[1:], e.dofs[1:])],
                           device=dev)
    coef = torch.as_tensor([-float(c) / float(e.coefs[0]) for e in eqs
                            for c in e.coefs[1:]], dtype=torch.float64,
                           device=dev)
    rows = torch.as_tensor([k for k, e in enumerate(eqs)
                            for _ in e.nodes[1:]], device=dev)
    keep = torch.ones(n, dtype=torch.float64, device=dev)
    keep[dep] = 0.0

    def Tt(y):
        return (y.index_add(0, mast, coef * y[dep][rows])) * keep
    g = torch.zeros(n, dtype=torch.float64, device=dev)
    g[dep] = torch.as_tensor([float(e.const) / float(e.coefs[0])
                              for e in eqs], dtype=torch.float64,
                             device=dev) * gfac
    return float(torch.linalg.norm(Tt(r)) /
                 torch.linalg.norm(Tt(b_c - A_c(g))))


def true_relres(model, u: np.ndarray, kes) -> float:
    """The linear static solution's relres (``constrained_relres``)."""
    dev = kes[0].device
    n = model.n_dof_total
    fixed = torch.as_tensor(model.fixed_dofs, device=dev)
    free = torch.ones(n, dtype=torch.float64, device=dev)
    free[fixed] = 0.0
    u_fix = torch.zeros(n, dtype=torch.float64, device=dev)
    u_fix[fixed] = torch.as_tensor(model.fixed_vals, device=dev)
    return constrained_relres(model, kes,
                              torch.as_tensor(model.f_ext, device=dev),
                              u_fix, free,
                              torch.as_tensor(u.reshape(-1), device=dev))


def check_result(res, model, kes, policy="mixed") -> float:
    """Policy, finite displacements of the right shape, solver relres and
    independent true relres <= 1e-8.  Returns the true relres."""
    if res.policy != policy:
        raise AssertionError(f"policy {res.policy}, expected {policy}")
    if not (res.u.shape == (model.n_node, 3) and np.isfinite(res.u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    rr = true_relres(model, res.u, kes)
    log(f"  true f64 relres (index_add_ residual) = {rr!r}")
    if not (res.relres <= 1e-8 and rr <= 1e-8):
        raise AssertionError("relative residual above 1e-8")
    return rr


def phase_tet_main_path(args, mods):
    """The tet deck through run_directory; returns (model, K1 launches)."""
    sm, stmod = mods["segsum"], mods["static"]
    wd = os.path.join(ROOT, "build", "smoke", f"tet{args.n}")
    t0 = time.perf_counter()
    ndof = write_workdir(wd, (args.n,) * 3, mods["ordering"],
                         mods["box_tet4"], mods["write_static_workdir"])
    log(f"phase workdir: box_tet4({args.n}) shuffled, {ndof} dofs, "
        f"written in {time.perf_counter() - t0:.2f} s")
    sm.segsum.launches = 0
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = sm.segsum.launches
    res, model = out["static"], out["model"]
    times = " ".join(f"{k}={v:.3f}" for k, v in res.timings.items())
    log(f"phase main_path: {wall:.2f} s; {times}")
    log(f"  policy={res.policy} cg_iters={res.iters} "
        f"refine_passes={res.passes} relres={res.relres!r} "
        f"K1 launches={launches}")
    if launches < 1:
        raise AssertionError("the tet main path did not launch K1")
    check_result(res, model, stmod.compute_element_stiffness(model))
    with open(os.path.join(wd, "0.log")) as fh:
        if "Global Summary" not in fh.read():
            raise AssertionError("0.log holds no Global Summary")
    return model, launches


def phase_newton_main_path(args, mods, ref=None):
    """The NLSTATIC bench deck through run_directory in the float64
    policy (FRONTISTR_TPU_PRECISION=f64): at m=69 the mixed policy's
    float32 CG stalls on the stressed tangents of Newton iterations 2 and
    later (PERF.md, ``microbench/newton_trace.py``).  Every linear
    solve's answer is held to an independent index_add_ residual.  Into
    ``ref`` go the work directory, its input files and the run's, and
    what shard_main_path holds to: the Newton iterations a CONVERG of
    ``SHARD_CONVERG`` takes and u after them (the solves' answers summed
    as the Newton loop sums them).
    Returns (model, K1 element launches, K1 planes launches)."""
    nl, sm = mods["nonlinear"], mods["segsum"]
    m = args.newton_n
    wd = os.path.join(ROOT, "build", "smoke", f"newton{m}")
    t0 = time.perf_counter()
    ndof = write_workdir(wd, (m,) * 3, mods["ordering"], mods["box_tet4"],
                         mods["write_static_workdir"],
                         NLCNT.format(load=-1.0))
    inputs = sorted(os.listdir(wd))
    log(f"phase newton_workdir: box_tet4({m}) shuffled, NLSTATIC, {ndof} "
        f"dofs, written in {time.perf_counter() - t0:.2f} s")
    solves, calls = [], {}
    answers = [] if ref is not None else None
    real = nl.make_constrained_solver
    nl.make_constrained_solver = spy_solves(nl, solves, answers)
    restore = counting(mods, calls)
    sm.segsum.launches = 0
    sm.segsum_planes.launches = 0
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: mods["run_directory"](wd, device="cuda"))
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver = real
        restore()
    launches = sm.segsum.launches
    planes = sm.segsum_planes.launches
    res, model = out["static"], out["model"]
    nw = res.newton
    tm = res.timings
    once = " ".join(f"{k}={tm.get(k, 0.0):.3f}"
                    for k in ("read", "reorder", "model", "profile", "post"))
    log(f"phase newton_main_path: {wall:.2f} s; once: {once}")
    log(f"  policy={res.policy} substeps={nw.substeps} "
        f"newton_iters={nw.total_iters} cutbacks={nw.cutbacks} "
        f"K1 launches={launches} (element assembly), K1 planes "
        f"launches={planes} ({calls['setup_amg']} AMG setups x "
        f"{PLANES_PER_AMG_SETUP} + {calls['smooth']} nodal smoothings)")
    keys = ("tangent", "assembly", "amg_setup", "solve", "update")
    for h, sv in zip(nw.history, solves):
        step = sum(h[k] for k in keys[:4])
        log(f"  step {h['step']} substep {h['substep']} it {h['iter']}: "
            f"rres={h['rres']!r} rxnrm={h['rxnrm']!r} "
            f"cg_iters={sv['cg_iters']} passes={sv['passes']} "
            f"relres={sv['relres']!r} true_relres={sv['true_relres']!r}; "
            + " ".join(f"{k}={h[k]:.3f}" for k in keys)
            + f" newton_step={step:.3f}")
    if len(solves) != len(nw.history) or not solves:
        raise AssertionError("newton_main_path: solves and iterations "
                             "do not pair up")
    steps = [sum(h[k] for k in keys[:4]) for h in nw.history]
    log(f"  newton step (tangent + assembly + amg_setup + solve) over "
        f"{len(steps)} iterations: median={float(np.median(steps)):.3f} "
        f"min={min(steps):.3f} max={max(steps):.3f} s")
    if res.policy != "f64":
        raise AssertionError(f"policy {res.policy}, expected f64")
    last = nw.history[-1]
    if nw.cutbacks or min(last["rres"], last["rxnrm"]) >= 1e-6:
        raise AssertionError("newton_main_path: Newton did not converge "
                             "without cutbacks")
    if launches != nw.total_iters:
        raise AssertionError(f"K1 launches {launches} != Newton "
                             f"iterations {nw.total_iters}")
    if calls["setup_amg"] < 1 or planes != (
            PLANES_PER_AMG_SETUP * calls["setup_amg"] + calls["smooth"]):
        raise AssertionError(f"K1 planes launches {planes} != "
                             f"{PLANES_PER_AMG_SETUP} x {calls['setup_amg']}"
                             f" AMG setups + {calls['smooth']} smoothings")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    if not (res.u.shape == (model.n_node, 3) and np.isfinite(res.u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    with open(os.path.join(wd, "0.log")) as fh:
        if "Global Summary" not in fh.read():
            raise AssertionError("0.log holds no Global Summary")
    with open(os.path.join(wd, "FSTR.sta")) as fh:
        if "HAS COMPLETED SUCCESSFULLY" not in fh.read():
            raise AssertionError("FSTR.sta does not report success")
    if ref is not None:
        ref.update(newton_depth(nw.history, answers, res.u),
                   wd=wd, inputs=inputs,
                   outputs=sorted(set(os.listdir(wd)) - set(inputs)),
                   node_ids=np.asarray(out["mesh"].node_ids),
                   cg=[sv["cg_iters"] for sv in solves])
    return model, launches, planes


def newton_depth(history, answers, u) -> dict:
    """The iterations a CONVERG of SHARD_CONVERG takes (the Newton
    loop's test on this run's rres and rxnrm) and u after them: the
    first substep's solve answers summed in the loop's order (du = 0 +
    dx_1 + dx_2 ...).  All of them summed must give the run's u."""
    if len({(h["step"], h["substep"]) for h in history}) != 1:
        raise AssertionError("newton_depth: one substep expected")
    k = next((h["iter"] for h in history if h["rres"] < SHARD_CONVERG
              or h["rxnrm"] < SHARD_CONVERG), None)
    if k is None or len(answers) != len(history):
        raise AssertionError("newton_depth: no iteration meets "
                             f"CONVERG {SHARD_CONVERG!r}")
    sums = [torch.zeros_like(answers[0])]
    for x in answers:
        sums.append(sums[-1] + x)
    u = np.asarray(u).reshape(-1)
    off = float(np.abs(sums[-1].numpy() - u).max() / np.abs(u).max())
    log(f"  shard depth: CONVERG {SHARD_CONVERG!r} stops after iteration "
        f"{k} (rres {history[k - 1]['rres']!r}, rxnrm "
        f"{history[k - 1]['rxnrm']!r}); the answers summed against u "
        f"{off!r}")
    if not off <= 1e-12:
        raise AssertionError("newton_depth: the solves' answers do not sum "
                             "to u")
    return dict(iters=k, u=sums[k].numpy())


def phase_k1_time(sm, mbs, bell, stmod, model, launches) -> dict:
    """K1 at the Newton main path's shapes, in float64 (the type its f64
    policy assembles in) and float32 (the mixed policy's).  Also timed:
    the kernel's two passes apart (torch.profiler: pass 1 the sums, pass
    2 the planes)."""
    kes = stmod.compute_element_stiffness(model)
    plan = bell.cluster_profile_from_model(model).plan("cuda")
    nns = [b.conn.shape[1] for b in model.blocks]
    P = plan.perm.numel()
    seg = plan.seg_sorted.long()
    row = {"name": "segsum", "route": "cuda",
           "source": "frontistr_tpu_torch/csrc/segsum.cu",
           "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
           "launches": launches}
    for dt in (torch.float32, torch.float64):
        kd = [k.to(dt) for k in kes]
        err = check_k1(sm, plan, kd, nns, dt, "main path")
        ms = cuda_ms(lambda: sm.segsum(plan, kd, nns, 3))
        passes = mbs.kernel_split(lambda: sm.segsum(plan, kd, nns, 3), 5)
        plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, nns, 3))
        # one library call: index_add_ of the entries already in slot order
        ent = sm.entry_planes(kd, nns, 3)[:, plan.perm.long()]
        out = torch.zeros((9, plan.n_slots), dtype=dt, device="cuda")
        library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
        del ent, out
        isz = kd[0].element_size()
        nbytes = (sum(k.numel() for k in kd) * isz + P * 4
                  + (plan.n_slots + 1) * 4 + 9 * plan.n_slots * isz)
        bound_ms, bound_by = bound(nbytes, 9 * P, dt)
        passes_ms = {name: t for k, t in passes.items()
                     for name in ("sums", "planes_out")
                     if f"{name}_kernel" in k}
        log(f"phase k1_time: P={P} pairs, n_slots={plan.n_slots} "
            f"{str(dt)[6:]}: kernel {ms:.3f} ms (passes {passes_ms}), "
            f"plain {plain_ms:.3f} ms, "
            f"index_add_ {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({nbytes / 1e9:.3f} GB)")
        if len(passes_ms) != 2:
            raise AssertionError(f"K1's two passes not traced: {passes}")
        nums = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "passes_ms": passes_ms}
        if dt == torch.float64:
            row.update(nums)                 # the Newton path's type
        else:
            row["f32"] = nums                # the mixed policy's
        del kd
    return row


def phase_amg_repeat(mods, model, planes_launches) -> dict:
    """The AMG setup twice on the same tangent (the linear one) at the
    Newton path's shapes: bit-equal coarse levels (level-1 blocks, their
    inverses, the dense level 2 and its inverse) and a bit-equal V-cycle
    on a fixed vector.  Logged: the first setup's peak of allocated
    device memory, and the peak of the level-1 block inverses alone
    (``amg._block_inv``, a batched ``eigh``, on blocks of the same
    shape).  Then K1's planes entry is held to its plain version at
    its three shapes on the Newton path, on random values: the level-1
    and level-2 Galerkin sums (their plans, nv*nv planes) and the nodal
    smoothing (the mesh's node plan, 2*6 + 1 planes), and timed at the
    level-1 shapes; returns those numbers."""
    sm, stmod, bell, amg = (mods["segsum"], mods["static"], mods["bell"],
                            mods["amg"])
    kes = stmod.compute_element_stiffness(model)
    setup = stmod.cluster_setup(model, {})
    if setup.amaps is None:
        raise AssertionError("amg_repeat: the deck does not take the AMG")
    cop, sb = bell.from_model(model, kes, dtype=torch.float64,
                              profile=setup.cprof, want_scalar=True,
                              scalar=setup.prof)
    del kes
    free = torch.as_tensor(mods["make_free_mask"](model.n_dof_total,
                                                  model.fixed_dofs),
                           device="cuda")
    cop = dataclasses.replace(cop, free_mask=free)
    args = (setup.amaps, sb, setup.cols, setup.coords, free)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lv = amg.coarse_levels(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    again = amg.coarse_levels(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = {k: torch.equal(getattr(lv, k), getattr(again, k))
            for k in ("blocks1", "Dinv1", "dense2", "A2inv")}
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(
        model.n_dof_total), device="cuda")
    y = [amg.setup_amg(*args, cop.apply_constrained, cop.block_jacobi())(r)
         for _ in range(2)]
    same["vcycle"] = torch.equal(y[0], y[1])
    log(f"phase amg_repeat: coarse_levels {t1 - t0:.3f} s and "
        f"{t2 - t1:.3f} s, peak {peak_gb:.3f} GB allocated above the "
        f"{held / 1e9:.3f} GB held before, blocks1 "
        f"{tuple(lv.blocks1.shape)}, dense2 {tuple(lv.dense2.shape)}; "
        f"bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError(f"amg_repeat: two setups differ: {same}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    amg._block_inv(lv.Dinv1)
    log(f"  the block inverses {tuple(lv.Dinv1.shape)} alone: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")
    del lv, again, y, cop, sb
    gen = torch.Generator("cuda").manual_seed(5)
    err = max(check_path_planes(mods, model, setup.amaps, gen).values())
    # the level-1 sum's plan, on values of its shape
    plan = setup.amaps.plans("cuda")[0]
    nvv = setup.amaps.nv ** 2
    values = torch.randn((nvv, plan.perm.numel()), dtype=torch.float64,
                         device="cuda", generator=gen)
    dt = values.dtype
    ms = cuda_ms(lambda: sm.segsum_planes(values, plan))
    plain_ms = cuda_ms(lambda: sm.segsum_planes_reference(values, plan))
    ent = values[:, plan.perm.long()]
    out = values.new_zeros((values.shape[0], plan.n_slots))
    seg = plan.seg_sorted.long()
    library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
    del ent, out
    V, R = values.shape
    isz = values.element_size()
    nbytes = (V * R * isz + plan.perm.numel() * 4 + (plan.n_slots + 1) * 4
              + V * plan.n_slots * isz)
    bound_ms, bound_by = bound(nbytes, V * plan.perm.numel(), dt)
    log(f"phase planes_time: V={V} planes, R={R} entries, n_slots="
        f"{plan.n_slots} {str(dt)[6:]}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB)")
    return {"launches": planes_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_path_planes(mods, model, amaps, gen) -> dict:
    """K1's planes entry held to its plain version, on random float64
    values, at its three shapes on a main path: the AMG level-1 and
    level-2 Galerkin sums (their plans, nv*nv planes) and the nodal
    smoothing (the mesh's node plan, 2*6 + 1 planes in 3-D, 2*3 + 1 in
    2-D).  Returns {shape: max_abs_err}."""
    sm = mods["segsum"]
    conn = np.concatenate([np.asarray(b.conn, np.int64).reshape(-1)
                           for b in model.blocks])
    plan1, plan2 = amaps.plans("cuda")
    shapes = (("AMG level 1", plan1, amaps.nv ** 2),
              ("AMG level 2", plan2, amaps.nv ** 2),
              ("nodal smoothing",
               mods["nodal"].node_plan(conn, model.n_node, "cuda"),
               13 if model.dim == 3 else 7))
    return {label: check_planes(sm, p, torch.randn(
                (V, p.perm.numel()), dtype=torch.float64, device="cuda",
                generator=gen), torch.float64, label)
            for label, p, V in shapes}


def hex_model(mods, dims, device):
    path = os.path.join(ROOT, "build", "smoke", "hex.cnt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(CNT)
    return mods["build_struct_model"](mods["box_hex8"](*dims),
                                      mods["read_cnt"](path), device=device)


def phase_hex_main_path(args, mods):
    """box_hex8(h) through build_struct_model + run_linear_static;
    returns (model, result, K2 launches)."""
    em, stmod = mods["element_mv"], mods["static"]
    t0 = time.perf_counter()
    model = hex_model(mods, (args.hex,) * 3, "cuda")
    t_model = time.perf_counter() - t0
    if not stmod.is_structured(model):
        raise AssertionError("the hex model does not take the stencil arm")
    em.element_matvec_soa.launches = 0
    t0 = time.perf_counter()
    res = stmod.run_linear_static(model)
    wall = time.perf_counter() - t0
    launches = em.element_matvec_soa.launches
    times = " ".join(f"{k}={v:.3f}" for k, v in res.timings.items())
    log(f"phase hex_main_path: box_hex8({args.hex}) {model.n_dof_total} "
        f"dofs, {model.blocks[0].conn.shape[0]} elements, "
        f"formulation={model.blocks[0].formulation}: model {t_model:.3f} s, "
        f"run_linear_static {wall:.2f} s; {times}")
    log(f"  policy={res.policy} cg_iters={res.iters} "
        f"refine_passes={res.passes} relres={res.relres!r} "
        f"K2 launches={launches}")
    if launches < 1:
        raise AssertionError("the hex main path did not launch K2")
    check_result(res, model, stmod.compute_element_stiffness(model))
    return model, res, launches


def phase_k2_time(mods, model, res, launches) -> dict:
    """K2 at the hex main path's shapes, float32 and float64, on the
    element values of its solution."""
    em, stmod = mods["element_mv"], mods["static"]
    st = mods["structured"]
    ke = stmod.compute_element_stiffness(model)[0]
    sop = st.StructuredHexOperator(*model.mesh.structured,
                                   st.soa_from_blocks(ke),
                                   torch.ones(model.n_dof_total,
                                              dtype=torch.float64,
                                              device="cuda"))
    del ke
    xe64 = sop._gather_stencil(torch.as_tensor(res.u.reshape(-1),
                                               device="cuda"))
    E = xe64.shape[1]
    row = {"name": "element_mv", "route": "cuda",
           "source": "frontistr_tpu_torch/csrc/element_mv.cu",
           "replaces": "frontistr_tpu/ops/pallas_mv.py:18",
           "launches": launches}
    for dt in (torch.float64, torch.float32):
        keT = sop.keT.to(dt)
        xeT = xe64.to(dt)
        err = check_k2(em, keT, xeT, "main path")
        ms = cuda_ms(lambda: em.element_matvec_soa(keT, xeT))
        plain_ms = cuda_ms(
            lambda: em.element_matvec_soa_reference(keT, xeT))
        keB = keT.permute(2, 0, 1)
        xeB = xeT.t()[:, :, None]
        library_ms = cuda_ms(lambda: torch.bmm(keB, xeB))
        isz = keT.element_size()
        nbytes = (24 * 24 + 2 * 24) * E * isz
        bound_ms, bound_by = bound(nbytes, 2 * 24 * 24 * E, dt)
        log(f"phase k2_time: E={E} {str(dt)[6:]}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bmm {library_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB)")
        nums = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
        if dt == torch.float32:
            row.update(nums)                 # the CG hot loop's type
        else:
            row["f64"] = nums                # the refinement residuals
        del keT, xeT, keB, xeB
    return row


GATHER_NAMES = {"K3": "gather_rows", "K4": "gather_cols",
                "K5": "window_gather", "K6": "window_gather_tiled"}
GATHER_SOURCE = "frontistr_tpu_torch/csrc/gather.cu"
GATHER_REPLACES = {"K3": "scripts/microbench_pallas_gather.py:44",
                   "K4": "scripts/microbench_pallas_gather.py:65",
                   "K5": "scripts/microbench_pallas_gather.py:84",
                   "K6": "scripts/microbench_pallas_gather.py:114"}


def phase_gather_check(g, mb, device="cuda") -> dict:
    """K3-K6 against their plain versions on the card: the script's
    inputs, ragged shapes (K6 at 1 and 3 tiles and a ragged last tile),
    indices out of range (NaN) and out of the window (0), and K5/K6 on
    the microbenchmark's ``window_checks`` (tile_rows 1, 37, 256; 1, 3
    and 4 window blocks of 8 and 64 rows; 999 and 70,001 rows).  A
    gather copies values, so both outputs and a relaunch must be
    bit-equal.  Returns max |kernel - plain| by kernel id (finite
    entries)."""
    dev = torch.device(device)
    rng = np.random.default_rng(2)
    data = mb.inputs(dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def win(S, rows):
        return (i32(rng.integers(-24, rows + 24, (S, 128))),
                i32(rng.integers(-140, 140, (S, 128))))

    tiled = dict(tile_rows=256, win_rows=64)
    cases = [
        ("K3", "G1", g.gather_rows, g.gather_rows_reference, data["G1"],
         {}),
        ("K3", "out of range", g.gather_rows, g.gather_rows_reference,
         (f32((8, 1000)), i32(rng.integers(-12, 12, (9, 1000)))), {}),
        ("K4", "G2", g.gather_cols, g.gather_cols_reference, data["G2"],
         {}),
        ("K4", "G3", g.gather_cols, g.gather_cols_reference, data["G3"],
         {}),
        ("K4", "out of range", g.gather_cols, g.gather_cols_reference,
         (f32((5, 300)), i32(rng.integers(-330, 330, (5, 700)))), {}),
        ("K5", "G4", g.window_gather, g.window_gather_reference,
         data["G4"], {}),
        ("K5", "out of window", g.window_gather, g.window_gather_reference,
         (f32((64, 128)),) + win(8, 64), {}),
        ("K6", "G5", g.window_gather_tiled, g.window_gather_tiled_reference,
         data["G5"], tiled)]
    for S in (256, 768, 700):
        cases.append(("K6", f"S={S} out of window", g.window_gather_tiled,
                      g.window_gather_tiled_reference,
                      (f32((256, 128)),) + win(S, 64), tiled))
    for label, kern, plain, args, kw in mb.window_checks(dev):
        cases.append((label[:2], label[3:] + " out of window", kern, plain,
                      args, kw))
    errs = {}
    for kid, label, kern, plain, args, kw in cases:
        got = kern(*args, **kw)
        again = kern(*args, **kw)
        want = plain(*args, *kw.values())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = got.shape == want.shape and torch.equal(
            got.view(torch.int32), want.view(torch.int32))
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() \
            else 0.0
        n_nan = int((~fin).sum())
        n_zero = int((want == 0).sum())
        log(f"  {kid} {label} {tuple(want.shape)}: bit-equal={same}, "
            f"relaunch bit-equal="
            f"{torch.equal(got.view(torch.int32), again.view(torch.int32))}"
            f", NaN entries {n_nan}, zero entries {n_zero}")
        if not same or not torch.equal(got.view(torch.int32),
                                       again.view(torch.int32)):
            raise AssertionError(f"{kid} ({label}) is not bit-equal to its "
                                 "plain version")
        if "window" in label and n_zero == 0:
            raise AssertionError(f"{kid} ({label}): no out-of-window entry")
        errs[kid] = max(errs.get(kid, 0.0), err)
    return errs


def phase_gather_time(g, mb, errs) -> list:
    """The microbenchmark's rows (its run is the gathers' main path:
    launch counts set to 0 before, read after); returns the K3-K6 rows of
    the kernels line."""
    wrappers = {"K3": g.gather_rows, "K4": g.gather_cols,
                "K5": g.window_gather, "K6": g.window_gather_tiled}
    for w in wrappers.values():
        w.launches = 0
    rows = mb.run("cuda")
    counts = {k: w.launches for k, w in wrappers.items()}
    log("phase gather_time: " + json.dumps(rows))
    log(f"  launches: {counts}")
    out = {}
    for r in rows:
        nums = {"ms": r["ms"], "graph_ms": r["graph_ms"],
                **({"cold_ms": r["cold_ms"]} if "cold_ms" in r else {}),
                "host_us": r["host_us"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": r["library_ms"],
                "library_graph_ms": r["library_graph_ms"],
                "library_host_us": r["library_host_us"]}
        if r["kernel"] in out:                 # K4's second row (G3)
            out[r["kernel"]][r["row"]] = nums
            continue
        out[r["kernel"]] = {
            "name": GATHER_NAMES[r["kernel"]], "route": "cuda",
            "source": GATHER_SOURCE,
            "replaces": GATHER_REPLACES[r["kernel"]],
            "launches": counts[r["kernel"]],
            "max_abs_err": errs[r["kernel"]], **nums}
    if any(c < 1 for c in counts.values()):
        raise AssertionError(f"a gather kernel was not launched: {counts}")
    return [out[k] for k in ("K3", "K4", "K5", "K6")]


def phase_k1_m30_time(mods, n: int) -> dict:
    """K1 at m = 30 (tet10) on the cluster profile of tet10 of
    box_tet4(n), random float64 element matrices: held to its plain
    version and timed with it and with one index_add_."""
    sm, bell = mods["segsum"], mods["bell"]
    mesh = tet10_mesh(mods, (n, n, n))
    conn = mesh.blocks[0].conn
    plan = bell.build_cluster_profile([conn], mesh.n_node, 3).plan("cuda")
    gen = torch.Generator("cuda").manual_seed(6)
    kes = [torch.randn((conn.shape[0], 30, 30), dtype=torch.float64,
                       device="cuda", generator=gen)]
    err = check_k1(sm, plan, kes, [10], torch.float64, f"tet10 box_tet4({n})")
    ms = cuda_ms(lambda: sm.segsum(plan, kes, [10], 3))
    plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kes, [10], 3))
    ent = sm.entry_planes(kes, [10], 3)[:, plan.perm.long()]
    out = torch.zeros((9, plan.n_slots), dtype=torch.float64, device="cuda")
    seg = plan.seg_sorted.long()
    library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
    P = plan.perm.numel()
    nbytes = (kes[0].numel() * 8 + P * 4 + (plan.n_slots + 1) * 4
              + 9 * plan.n_slots * 8)
    bound_ms, bound_by = bound(nbytes, 9 * P, torch.float64)
    log(f"phase k1_m30_time: tet10 box_tet4({n}) {conn.shape[0]} elements, "
        f"P={P} pairs, n_slots={plan.n_slots} float64: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB)")
    return {"elements": int(conn.shape[0]), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def spy_solves(nl, solves: list, answers: list = None):
    """A ``make_constrained_solver`` whose every solve also appends its
    counts and an independent index_add_ true relres to ``solves`` (and
    a host copy of its answer to ``answers``)."""
    real = nl.make_constrained_solver

    def checked_solver(model, free, gather, mixed, timings=None, **kw):
        solve = real(model, free, gather, mixed, timings, **kw)

        def checked(kes, B, dirichlet_inc, gfac=0.0):
            x = solve(kes, B, dirichlet_inc, gfac)
            for k in ("last_iters", "last_passes", "last_relres"):
                setattr(checked, k, getattr(solve, k))
            if answers is not None:
                answers.append(x.detach().to("cpu", torch.float64))
            solves.append(dict(
                cg_iters=solve.last_iters, passes=solve.last_passes,
                relres=solve.last_relres,
                true_relres=constrained_relres(model, kes, B, dirichlet_inc,
                                               free, x, gfac)))
            return x
        checked.mpc = solve.mpc
        return checked
    return checked_solver


def counting(mods, calls: dict):
    """Wrap amg.setup_amg, nodal.smooth and extras.mpc_Tt to count their
    calls into ``calls`` (from 0); returns the function that restores
    them."""
    amg, nodal, ex = mods["amg"], mods["nodal"], mods["extras"]
    real = (amg.setup_amg, nodal.smooth, ex.mpc_Tt)
    calls.update(setup_amg=0, smooth=0, mpc_Tt=0)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    amg.setup_amg = counted("setup_amg", real[0])
    nodal.smooth = counted("smooth", real[1])
    ex.mpc_Tt = counted("mpc_Tt", real[2])

    def restore():
        amg.setup_amg, nodal.smooth, ex.mpc_Tt = real
    return restore


def keep_first_solver(nl, solves: list, first: dict):
    """``spy_solves`` that also keeps the first solve's inputs, solver
    and answer in ``first`` (to repeat it) and logs every solve."""
    spy = spy_solves(nl, solves)

    def make(model, free, gather, mixed, timings=None, **kw):
        solve = spy(model, free, gather, mixed, timings, **kw)

        def call(kes, B, dirichlet_inc, gfac=0.0):
            if not first:
                first.update(kes=kes, B=B, dinc=dirichlet_inc, gfac=gfac,
                             solve=solve)
            t0 = time.perf_counter()
            x = solve(kes, B, dirichlet_inc, gfac)
            torch.cuda.synchronize()
            log(f"  solve {len(solves)}: cg {solves[-1]['cg_iters']}, "
                f"true relres {solves[-1]['true_relres']!r}, "
                f"{time.perf_counter() - t0:.2f} s")
            call.last_iters, call.last_passes, call.last_relres = \
                solve.last_iters, solve.last_passes, solve.last_relres
            if "x" not in first:
                first.update(x=x.clone(), iters=solve.last_iters)
            return x
        call.mpc = solve.mpc
        return call
    return make


def repeat_first(first: dict, label: str) -> None:
    """The first solve again on the same system: the same CG count and a
    bit-equal answer."""
    again = first["solve"](first["kes"], first["B"], first["dinc"],
                           first["gfac"])
    same = torch.equal(again, first["x"])
    log(f"  first solve repeated: cg {first['iters']} then "
        f"{first['solve'].last_iters}, bit-equal answer {same}")
    if first["solve"].last_iters != first["iters"] or not same:
        raise AssertionError(f"{label}: a repeated solve differs")


def phase_plastic_main_path(args, mods, keep=None) -> dict:
    """The elastoplastic NLSTATIC deck (``PLCNT``) on a shuffled
    box_hex8(p) through run_directory under the port's default policy on
    CUDA (float64): hex8 B-bar, Mises return mapping, the follower
    pressure re-assembled on the card every iteration, 2 substeps, the
    ``.res`` file.  Held to: every linear solve's index_add_ true relres
    <= 1e-8, no yielded gauss point at the end of substep 1 and some in
    substep 2, K1 element launches = Newton iterations, the ``.res``
    read back equal to the returned displacements.  Then K1 is held to
    its plain version at this path's shapes: the element entry (m = 24)
    on the run's cluster profile with the first Newton tangent, the
    planes entry at the run's AMG level-1 and level-2 plans and its
    nodal-smoothing plan.  Returns the K1 counts of the run and the
    largest max_abs_err of those checks; ``keep`` (a dict) gets the
    run's displacements under "u"."""
    nl, sm = mods["nonlinear"], mods["segsum"]
    p = args.plastic
    wd = os.path.join(ROOT, "build", "smoke", f"plastic{p}")
    cnt = PLCNT.format(sol="NLSTATIC", loads="!DLOAD\n TOP, P2, "
                       f"{PLASTIC_PRESSURE!r}\n", plastic=MISES, extra="",
                       sub=2)
    t0 = time.perf_counter()
    ndof = write_plastic_workdir(wd, mods, mods["box_hex8"](p, p, p), cnt)
    log(f"phase plastic_workdir: box_hex8({p}) shuffled, NLSTATIC !PLASTIC "
        f"Mises, follower P2={PLASTIC_PRESSURE!r} on the top layer, 2 "
        f"substeps, {ndof} dofs, {p ** 3} elements, written in "
        f"{time.perf_counter() - t0:.2f} s")
    solves = []
    real = nl.make_constrained_solver
    nl.make_constrained_solver = spy_solves(nl, solves)
    sm.segsum.launches = 0
    sm.segsum_planes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = mods["run_directory"](wd, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver = real
    launches = sm.segsum.launches
    planes = sm.segsum_planes.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model = out["static"], out["model"]
    if keep is not None:
        keep["u"] = res.u
    nw, tm = res.newton, res.timings
    keys = ("tangent", "update", "assembly", "amg_setup", "solve",
            "follower_load")
    log(f"phase plastic_main_path: {wall:.2f} s; formulation="
        f"{model.blocks[0].formulation} policy={res.policy} substeps="
        f"{nw.substeps} newton_iters={nw.total_iters} cutbacks="
        f"{nw.cutbacks} cg_iters={sum(h['cg_iters'] for h in nw.history)} "
        f"K1 launches={launches} (element assembly), K1 planes "
        f"launches={planes}, peak device memory {peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(f"{k}={tm.get(k, 0.0):.3f}" for k in
                                       keys + ("read", "reorder", "model",
                                               "profile", "post",
                                               "result")))
    for h, sv in zip(nw.history, solves):
        log(f"  step {h['step']} substep {h['substep']} it {h['iter']}: "
            f"rres={h['rres']!r} rxnrm={h['rxnrm']!r} "
            f"cg_iters={sv['cg_iters']} passes={sv['passes']} "
            f"relres={sv['relres']!r} true_relres={sv['true_relres']!r} "
            f"yielded={h['yielded']}; "
            + " ".join(f"{k}={h[k]:.3f}" for k in keys))
    if len(solves) != len(nw.history) or not solves:
        raise AssertionError("plastic_main_path: solves and iterations do "
                             "not pair up")
    if res.policy != "f64" or model.blocks[0].formulation != "BBAR":
        raise AssertionError("plastic_main_path: not the f64 policy on "
                             "B-bar hex8")
    last = {}
    for h in nw.history:
        last[h["substep"]] = h
    if nw.cutbacks or sorted(last) != [1, 2] or \
            last[1]["yielded"] != 0 or last[2]["yielded"] <= 0:
        raise AssertionError("plastic_main_path: not yield-free in "
                             "substep 1 and yielding in substep 2 "
                             f"without cutbacks: {last}")
    if launches != nw.total_iters:
        raise AssertionError(f"K1 launches {launches} != Newton "
                             f"iterations {nw.total_iters}")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    if not (res.u.shape == (model.n_node, 3) and np.isfinite(res.u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    path = os.path.join(wd, "mesh.res.0.1")
    t0 = time.perf_counter()
    back = mods["read_result"](path)
    u_res = dict(back["node_comps"])["DISPLACEMENT"]
    rel = float(np.abs(u_res - res.u).max() / np.abs(res.u).max())
    log(f"  {os.path.relpath(path, ROOT)}: {os.path.getsize(path)} bytes, "
        f"read back in {time.perf_counter() - t0:.2f} s, labels "
        f"{[n for n, _ in back['node_comps'] + back['elem_comps']]}, "
        f"DISPLACEMENT vs the returned u: max rel diff {rel!r}")
    if not (np.array_equal(back["node_ids"], model.mesh.node_ids)
            and rel <= 1e-15):
        raise AssertionError("the .res displacements differ from the run's")
    with open(os.path.join(wd, "FSTR.sta")) as fh:
        if "HAS COMPLETED SUCCESSFULLY" not in fh.read():
            raise AssertionError("FSTR.sta does not report success")
    # K1 at this path's shapes (after the counts were read)
    setup = mods["static"].cluster_setup(model, {})
    if setup.amaps is None:
        raise AssertionError("plastic_main_path: the deck does not take "
                             "the AMG")
    progs = [nl.BlockPrograms(model, b) for b in model.blocks]
    kes = []
    for b, pg in zip(model.blocks, progs):
        z = torch.zeros((len(b.elem_ids), b.conn.shape[1], 3),
                        dtype=torch.float64, device="cuda")
        kes.append(pg.tangent(z, z, nl.init_block_state(b, pg.table,
                                                        "cuda")))
    errs = {"element": check_k1(
        sm, setup.cprof.plan("cuda"), kes, [b.conn.shape[1] for b in
                                            model.blocks],
        torch.float64, f"plastic path, first tangent m = {kes[0].shape[1]}")}
    del kes, progs
    errs.update(check_path_planes(mods, model, setup.amaps,
                                  torch.Generator("cuda").manual_seed(7)))
    return {"launches": launches, "planes_launches": planes,
            "newton_iters": nw.total_iters, "max_abs_err": max(errs.values())}


def phase_plastic_small_reference(mods):
    """The small decks of the slice on the card and on the CPU (which
    the CPU tests hold to the JAX package), float64 policy: hex8 B-bar
    Mises and hex8 F-bar multilinear at box_hex8(6, 5, 4) under a
    follower P2, tet10 Drucker-Prager under a follower S, and a STATIC
    tet4 deck with a dead DLOAD and a !TEMPERATURE field.  Displacements
    within 1e-8 of max|u|, the same Newton iterations in each substep,
    the same committed yielded sets, each solve's CG count within one
    (the card's and the CPU's float64 reductions sum in other orders,
    and a solve whose residual lands at the 1e-8 bar stops one
    iteration apart)."""
    nl, run = mods["nonlinear"], mods["run_directory"]
    decks = [
        ("hex8 B-bar Mises", mods["box_hex8"](6, 5, 4), "NLSTATIC",
         "!DLOAD\n TOP, P2, 120.0\n", MISES, ""),
        ("hex8 F-bar multilinear", mods["box_hex8"](6, 5, 4), "NLSTATIC",
         "!DLOAD\n TOP, P2, 120.0\n", "!PLASTIC, YIELD=MISES, HARDEN="
         "MULTILINEAR\n 250.0, 0.0\n 300.0, 0.01\n 320.0, 0.05\n",
         "!ELEMOPT, 361=4\n"),
        ("tet10 Drucker-Prager", tet10_mesh(mods, (3, 2, 2)), "NLSTATIC",
         "!DLOAD\n STOP, S, 15.0\n", "!PLASTIC, YIELD=DRUCKER-PRAGER\n"
         " 40.0, 30.0, 500.0\n", ""),
        ("STATIC DLOAD + TEMPERATURE", mods["box_tet4"](4, 3, 3), "STATIC",
         "!DLOAD\n ALL, BX, 3.0\n TOP, P2, 5.0\n!REFTEMP\n 20.0\n"
         "!TEMPERATURE\n Z1, 120.0\n Z0, 60.0\n", "",
         "!EXPANSION_COEFF\n 1.2e-5\n")]
    real = nl._commit_state
    for k, (label, mesh, sol, loads, plastic, extra) in enumerate(decks):
        wd = os.path.join(ROOT, "build", "smoke", f"plastic_small{k}")
        write_plastic_workdir(wd, mods, mesh, PLCNT.format(
            sol=sol, loads=loads, plastic=plastic, extra=extra,
            sub=2 if sol == "NLSTATIC" else 1))
        runs = []
        for dev in ("cuda", "cpu"):
            seen = []
            nl._commit_state = lambda st: seen.append(real(st)) or seen[-1]
            try:
                r = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                             lambda: run(wd, device=dev)["static"])
            finally:
                nl._commit_state = real
            hist = r.newton.history if r.newton is not None else []
            cg = [h["cg_iters"] for h in hist] if hist else [r.iters]
            # Newton iterations per (step, substep), in the run's order
            subs = [(h["step"], h["substep"]) for h in hist]
            per_sub = [(k, subs.count(k)) for k in dict.fromkeys(subs)]
            yld = [s["yielded"].cpu().numpy() for s in seen[-len(
                mesh.blocks):]] if seen else []
            runs.append((r, cg, yld, per_sub))
        (rg, cgg, yg, sg), (rc, cgc, yc, sc) = runs
        rel = float(np.abs(rg.u - rc.u).max() / np.abs(rc.u).max())
        ny = [int(sum(y.sum() for y in ys)) for ys in (yg, yc)]
        log(f"phase plastic_small_reference: {label}, cuda vs cpu max rel "
            f"diff {rel!r}, newton iterations {rg.iters} vs {rc.iters} "
            f"(per substep {sg} vs {sc}), cg {cgg} vs {cgc}, yielded "
            f"{ny[0]} vs {ny[1]}")
        if not (rel <= 1e-8 and rg.iters == rc.iters and sg == sc
                and len(cgg) == len(cgc)
                and all(abs(a - b) <= 1 for a, b in zip(cgg, cgc))
                and len(yg) == len(yc)
                and all(np.array_equal(a, b) for a, b in zip(yg, yc))):
            raise AssertionError(f"plastic_small_reference: {label}: cuda "
                                 "and cpu runs differ")
        if plastic and ny[0] == 0:
            raise AssertionError(f"plastic_small_reference: {label} did "
                                 "not yield")


# the DYNAMIC deck of the dynamics phases: X0 fixed, X1 loaded -1 in z
# under !AMPLITUDE RAMP, steel in N, mm, s; {eqa} 11 explicit, 1 Newmark
DYNCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC{typ}\n {eqa}, 1\n"
          " 0.0, {t_end!r}, {n_step}, {dt!r}\n 0.5, 0.25\n"
          " 1, 1, {ray_m!r}, {ray_k!r}\n 10, {monit}, {every}\n"
          "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}"
          "!STEP, SUBSTEPS=1, CONVERG=1.0e-6\n"
          "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n{plastic}!DENSITY\n"
          " 7.85e-9\n!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
          " 10000, 1\n {resid}, 1.0, 0.0\n{write}!END\n")
DYN_RHO, DYN_E, DYN_NU = 7.85e-9, 210000.0, 0.3


def dyn_cnt(eqa, n_step, dt, monit=0, every=1, ray_m=0.0, ray_k=0.0,
            loads="!CLOAD, AMP=RAMP\n X1, 3, -1.0\n", typ="", plastic="",
            resid="1.0e-8", write=""):
    return DYNCNT.format(eqa=eqa, t_end=n_step * dt, n_step=n_step, dt=dt,
                         monit=monit, every=every, ray_m=ray_m, ray_k=ray_k,
                         loads=loads, typ=typ, plastic=plastic, resid=resid,
                         write=write)


def critical_step(mesh) -> float:
    """The explicit critical step of the mesh's smallest element: its
    characteristic length over the dilatational wave speed
    sqrt(E (1 - nu) / (rho (1 + nu) (1 - 2 nu))).  Length: a tet's
    smallest altitude (3 V / its largest face area), a hex8's shortest
    edge."""
    c = np.sqrt(DYN_E * (1 - DYN_NU) /
                (DYN_RHO * (1 + DYN_NU) * (1 - 2 * DYN_NU)))
    b = mesh.blocks[0]
    x = mesh.coords[b.conn[:, :8 if b.etype == 361 else 4]]
    if b.etype == 361:
        edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                 (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
        h = min(np.linalg.norm(x[:, i] - x[:, j], axis=1).min()
                for i, j in edges)
    else:
        vol = np.abs(np.einsum("ei,ei->e", np.cross(x[:, 1] - x[:, 0],
                                                    x[:, 2] - x[:, 0]),
                               x[:, 3] - x[:, 0])) / 6.0
        area = np.max([0.5 * np.linalg.norm(np.cross(
            x[:, j] - x[:, i], x[:, k] - x[:, i]), axis=1)
            for i, j, k in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))],
            axis=0)
        h = float((3.0 * vol / area).min())
    return float(h / c)


def write_dyn_workdir(path, mods, mesh, t_end, cnt_for):
    """The dynamics deck ``cnt_for(monitor node id)`` in ``path``, nodes
    shuffled (seed 3, the RCM reorder then runs), with !AMPLITUDE RAMP
    ramping 0 -> 1 over the first 10% of the run (``t_end``) and
    holding; the monitor is X1's corner node at y = z = max.  Returns
    the monitor's global id."""
    order = np.random.default_rng(3).permutation(mesh.n_node)
    pm = mods["ordering"].permute_mesh(mesh, order)
    x1 = pm.node_groups["X1"]
    monit = int(pm.node_ids[x1[np.argmax(pm.coords[x1, 1] +
                                         pm.coords[x1, 2])]])
    mods["write_static_workdir"](
        path, pm, cnt_for(monit), ngroups=("X0", "X1", "Z1"),
        amplitudes={"RAMP": [(0.0, 0.0), (0.1 * t_end, 1.0),
                             (t_end, 1.0)]})
    return monit


def kernel_launch_counts(mods) -> dict:
    sm, em, g = mods["segsum"], mods["element_mv"], mods["gather"]
    fns = {"K1": sm.segsum, "K1 planes": sm.segsum_planes,
           "K2": em.element_matvec_soa, "K3": g.gather_rows,
           "K4": g.gather_cols, "K5": g.window_gather,
           "K6": g.window_gather_tiled}
    return {k: f.launches for k, f in fns.items()}


def reset_kernel_launches(mods):
    sm, em, g = mods["segsum"], mods["element_mv"], mods["gather"]
    for f in (sm.segsum, sm.segsum_planes, em.element_matvec_soa,
              g.gather_rows, g.gather_cols, g.window_gather,
              g.window_gather_tiled):
        f.launches = 0


def element_force(model, kes, v):
    """K v by index_add_ of the element products (independent of the
    incidence gather-sum of ``femop``)."""
    y = torch.zeros_like(v)
    for b, ke in zip(model.blocks, kes):
        d = torch.as_tensor(b.dofs, dtype=torch.int64, device=v.device)
        y.index_add_(0, d.reshape(-1),
                     torch.einsum("eij,ej->ei", ke, v[d]).reshape(-1))
    return y


def check_dyn_launches(label, mods, model, launches) -> float:
    """The dynamics paths launch one kernel: K1's planes entry, once, in
    the nodal smoothing of the final 0.log.  Holds that entry to its
    plain version at the path's node plan; returns the error."""
    want = dict.fromkeys(launches, 0)
    want["K1 planes"] = 1
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    conn = np.concatenate([np.asarray(b.conn, np.int64).reshape(-1)
                           for b in model.blocks])
    plan = mods["nodal"].node_plan(conn, model.n_node, "cuda")
    gen = torch.Generator("cuda").manual_seed(11)
    return check_planes(mods["segsum"], plan, torch.randn(
        (13, plan.perm.numel()), dtype=torch.float64, device="cuda",
        generator=gen), torch.float64, f"{label} nodal smoothing")


def dyn_phases(dr) -> str:
    tm = dr.timings
    return " ".join(f"{k}={tm.get(k, 0.0):.3f}" for k in
                    ("read", "reorder", "model", "mass", "steps", "post"))


def phase_dynamic_explicit_main_path(args, mods) -> dict:
    """Explicit central difference through run_directory on a shuffled
    box_tet4(m) (default m=69: 1,029,000 dofs): dt half the critical
    step of the smallest element, ``--dyn-steps`` steps (300), X1's
    load ramped over the first 10% of the run, a monitor at X1's corner
    every 10 steps.  Holds the last step to the equation of motion
    M a_n = f(t_n) - K u_n on the free dofs, K u_n by an index_add_ of
    element forces, u_n = u_{n+1} - dt v - dt^2 a / 2 from the returned
    fields (v = (u_{n+1} - u_{n-1}) / 2 dt, a = (u_{n+1} - 2 u_n +
    u_{n-1}) / dt^2): relative error <= 1e-10."""
    m, n_step = args.dyn_n, args.dyn_steps
    mesh = mods["box_tet4"](m, m, m)
    dt = 0.5 * critical_step(mesh)
    wd = os.path.join(ROOT, "build", "smoke", f"dyn_explicit{m}")
    t0 = time.perf_counter()
    monit = write_dyn_workdir(
        wd, mods, mesh, n_step * dt,
        lambda m: dyn_cnt(11, n_step, dt, monit=m, every=10))
    log(f"phase dynamic_explicit_workdir: box_tet4({m}) shuffled, "
        f"{3 * mesh.n_node} dofs, {len(mesh.blocks[0].elem_ids)} tets, "
        f"dt = {dt!r} s (half the critical step), {n_step} steps, monitor "
        f"node {monit}; written in {time.perf_counter() - t0:.2f} s")
    del mesh
    reset_kernel_launches(mods)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = kernel_launch_counts(mods)
    dr, model = out["dynamic"], out["model"]
    blk = dr.timings["block_ms"]
    log(f"phase dynamic_explicit_main_path: {wall:.2f} s; {dyn_phases(dr)}; "
        f"arm={dr.arm}")
    log(f"  ms per step over {len(blk)} blocks of "
        f"{n_step // max(len(blk), 1)} steps: median="
        f"{float(np.median(blk)):.4f} min={min(blk):.4f} max={max(blk):.4f}; "
        f"peak device memory {peak:.3f} GB above {base / 1e9:.3f} GB; "
        f"kernel launches {launches}")
    mon = dr.monitors
    log(f"  monitor last row: step {int(mon['step'][-1])} t "
        f"{float(mon['time'][-1])!r} u {mon['disp'][-1].tolist()} v "
        f"{mon['velo'][-1].tolist()} a {mon['acce'][-1].tolist()}")
    if dr.arm != "explicit" or dr.steps != n_step or \
            len(mon["step"]) != n_step // 10:
        raise AssertionError("dynamic_explicit_main_path: wrong arm, steps "
                             "or monitor rows")
    for f in (dr.u, dr.vel, dr.acc):
        if not (f.shape == (model.n_node, 3) and np.isfinite(f).all()):
            raise AssertionError("dynamic_explicit_main_path: fields not "
                                 "finite / wrong shape")
    planes_err = check_dyn_launches("dynamic_explicit_main_path", mods,
                                    model, launches)
    # the equation of motion at the last step
    dev = torch.device("cuda")
    dyn, stmod = mods["dynamic"], mods["static"]

    def t(a):
        return torch.as_tensor(np.asarray(a).reshape(-1), device=dev)
    u1, v, a = t(dr.u), t(dr.vel), t(dr.acc)
    un = u1 - dt * v - 0.5 * dt * dt * a
    mass = dyn.lumped_mass_vector(model)
    f = torch.zeros_like(un)
    f[torch.as_tensor(model.mesh.node_groups["X1"], device=dev) * 3 + 2] = \
        -1.0          # the ramp holds at t_n
    free = torch.as_tensor(mods["make_free_mask"](model.n_dof_total,
                                                  model.fixed_dofs),
                           device=dev)
    rhs = (f - element_force(model, stmod.compute_element_stiffness(model),
                             un)) * free
    err = float(torch.linalg.norm(mass * a * free - rhs) /
                torch.linalg.norm(rhs))
    log(f"  equation of motion at step {n_step}: |M a - (f - K u_n)| / "
        f"|f - K u_n| = {err!r} (free dofs; bar 1e-10)")
    if not err <= 1e-10:
        raise AssertionError("dynamic_explicit_main_path: the equation of "
                             "motion does not hold")
    return {"planes_launches": launches["K1 planes"],
            "max_abs_err": planes_err, "ms_per_step": float(np.median(blk)),
            "peak_gb": peak, "eom_err": err}


def spy_effective_solves(dyn, solves: list):
    """A ``make_effective_solver`` whose every solve also records its
    CG count, seconds and (B, dirichlet increment, answer, c1, c2,
    mass, free) for an independent residual after the run."""
    real = dyn.make_effective_solver

    def spied(model, free, gather, mass, c1, c2):
        solve = real(model, free, gather, mass, c1, c2)

        def checked(kes, B, dirichlet_inc, prepared=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = solve(kes, B, dirichlet_inc, prepared)
            torch.cuda.synchronize()
            solves.append(dict(cg=solve.last_iters, s=time.perf_counter()
                               - t0, relres=solve.last_relres,
                               data=(B.clone(), dirichlet_inc.clone(),
                                     x.clone(), c1, c2, mass, free)))
            checked.last_iters = solve.last_iters
            checked.last_relres = solve.last_relres
            return x
        checked.operator, checked.prepare = solve.operator, solve.prepare
        return checked
    return spied


def effective_relres(model, kes, data) -> float:
    """||b_c - A_c x|| / ||b_c|| of P A P x + (I-P) x = (B - A d) P +
    d (I-P), A = c1 K + c2 M, K by index_add_ of element products."""
    B, d, x, c1, c2, mass, free = data

    def A(v):
        return c1 * element_force(model, kes, v) + c2 * mass * v
    b_c = (B - A(d)) * free + d * (1 - free)
    r = b_c - (A(x * free) * free + x * (1 - free))
    return float(torch.linalg.norm(r) / torch.linalg.norm(b_c))


def phase_dynamic_implicit_main_path(args, mods) -> dict:
    """Implicit Newmark (beta 0.25, gamma 0.5, Rayleigh ray_m and ray_k)
    through run_directory on a shuffled box_hex8(h) (default h=69:
    1,029,000 dofs, 328,509 IC elements, the linear default), dt 20x the
    explicit critical step, ``--dyn-hex-steps`` steps (10), RESID 1e-8:
    the linear step-train arm, one block-Jacobi CG solve a step on the
    matrix-free operator.  Every solve's true relative residual of the
    effective system (index_add_ element products plus the mass term)
    must be <= 1e-8."""
    h, n_step = args.dyn_hex, args.dyn_hex_steps
    mesh = mods["box_hex8"](h, h, h)
    dt_c = critical_step(mesh)
    dt = 20.0 * dt_c
    wd = os.path.join(ROOT, "build", "smoke", f"dyn_implicit{h}")
    t0 = time.perf_counter()
    write_dyn_workdir(wd, mods, mesh, n_step * dt, lambda m: dyn_cnt(
        1, n_step, dt, ray_m=1.0e3, ray_k=1.0e-9))
    log(f"phase dynamic_implicit_workdir: box_hex8({h}) shuffled, "
        f"{3 * mesh.n_node} dofs, {len(mesh.blocks[0].elem_ids)} elements,"
        f" dt = {dt!r} s (20 x the critical step {dt_c!r}), {n_step} "
        f"steps; written in {time.perf_counter() - t0:.2f} s")
    del mesh
    dyn = mods["dynamic"]
    solves = []
    real = dyn.make_effective_solver
    dyn.make_effective_solver = spy_effective_solves(dyn, solves)
    reset_kernel_launches(mods)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        out = mods["run_directory"](wd, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        dyn.make_effective_solver = real
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = kernel_launch_counts(mods)
    dr, model = out["dynamic"], out["model"]
    log(f"phase dynamic_implicit_main_path: {wall:.2f} s; {dyn_phases(dr)};"
        f" arm={dr.arm}, formulation={model.blocks[0].formulation}, peak "
        f"device memory {peak:.3f} GB above {base / 1e9:.3f} GB; kernel "
        f"launches {launches}")
    kes = mods["static"].compute_element_stiffness(model)
    rel = []
    for i, sv in enumerate(solves, start=1):
        rel.append(effective_relres(model, kes, sv["data"]))
        log(f"  step {i}: cg_iters={sv['cg']} solve={sv['s']:.3f} s "
            f"({1e3 * sv['s'] / max(sv['cg'], 1):.3f} ms per CG "
            f"iteration) relres={sv['relres']!r} true_relres={rel[-1]!r}")
        sv["data"] = None
    del kes
    if dr.arm != "linear" or len(solves) != n_step or \
            model.blocks[0].formulation != "IC":
        raise AssertionError("dynamic_implicit_main_path: not the linear "
                             "step train of hex8 IC, one solve a step")
    for f in (dr.u, dr.vel, dr.acc):
        if not (f.shape == (model.n_node, 3) and np.isfinite(f).all()):
            raise AssertionError("dynamic_implicit_main_path: fields not "
                                 "finite / wrong shape")
    if not all(r <= 1e-8 for r in rel):
        raise AssertionError("a Newmark solve's true relres is above 1e-8")
    planes_err = check_dyn_launches("dynamic_implicit_main_path", mods,
                                    model, launches)
    cg = [sv["cg"] for sv in solves]
    ms = [1e3 * sv["s"] / max(sv["cg"], 1) for sv in solves]
    return {"planes_launches": launches["K1 planes"],
            "max_abs_err": planes_err, "cg": cg,
            "ms_per_cg": float(np.median(ms)), "peak_gb": peak}


def read_table(path):
    with open(path) as fh:
        return np.asarray([[float(v) for v in ln.split()] for ln in fh
                           if ln.strip()])


def phase_dynamic_small_reference(mods):
    """Small dynamics decks on the card and on the CPU (which the CPU
    tests hold to the JAX package): explicit tet4 with initial and
    prescribed !VELOCITY; implicit linear hex8 IC with Rayleigh (the
    step train); implicit TYPE=NONLINEAR tet10 under !PLASTIC, 3 steps;
    an implicit deck with !WRITE, RESULT, FREQUENCY=2 (the Newton loop).
    u, v and a within 1e-12 of each field's largest magnitude, Newton
    iterations per step equal, each solve's CG count within one, the
    dyna_*.out files and the .res snapshots equal after parsing to 1e-10
    of each column's largest value.  The implicit decks solve to RESID
    1e-14, so a CG count one apart moves the answer below the bar (at
    RESID 1e-12 one step's extra iteration moved the card's answer by
    1.2e-12)."""
    dt4 = 0.2 * critical_step(mods["box_tet4"](6, 5, 4))
    decks = [   # (label, mesh, n_step, dt, dyn_cnt keyword arguments)
        ("explicit tet4 !VELOCITY", mods["box_tet4"](6, 5, 4), 40, dt4,
         dict(eqa=11, every=5, loads="!CLOAD, AMP=RAMP\n X1, 3, -1.0\n"
              "!VELOCITY, TYPE=INITIAL\n ALL, 3, 3, -2.0\n!VELOCITY, "
              "AMP=RAMP\n Z1, 1, 1, 0.5\n")),
        ("implicit hex8 IC Rayleigh", mods["box_hex8"](6, 5, 4), 5, 1.0e-7,
         dict(eqa=1, ray_m=1.0e4, ray_k=1.0e-8, resid="1.0e-14")),
        ("implicit nonlinear tet10 plastic", tet10_mesh(mods, (3, 2, 2)), 3,
         1.0e-7, dict(eqa=1, typ=", TYPE=NONLINEAR", plastic=MISES,
                      loads="!CLOAD, AMP=RAMP\n X1, 3, -5.0\n",
                      resid="1.0e-14")),
        ("implicit tet4 !WRITE, RESULT every 2", mods["box_tet4"](6, 5, 4),
         6, 1.0e-7, dict(eqa=1, every=2, resid="1.0e-14",
                         write="!WRITE, RESULT, FREQUENCY=2\n")),
    ]
    run = mods["run_directory"]
    for k, (label, mesh, n_step, dt, kw) in enumerate(decks):
        runs = []
        for dev in ("cuda", "cpu"):
            wd = os.path.join(ROOT, "build", "smoke", f"dyn_small{k}{dev}")
            write_dyn_workdir(wd, mods, mesh, n_step * dt,
                              lambda m: dyn_cnt(n_step=n_step, dt=dt,
                                                monit=m, **kw))
            runs.append((run(wd, device=dev), wd))
        (og, wg), (oc, wc) = runs
        g, c = og["dynamic"], oc["dynamic"]
        rel = max(float(np.abs(getattr(g, f) - getattr(c, f)).max() /
                        max(np.abs(getattr(c, f)).max(), 1e-300))
                  for f in ("u", "vel", "acc"))
        newton = [[h["newton"] for h in r.history] for r in (g, c)]
        cg = [[x for h in r.history for x in h["cg"]] for r in (g, c)]
        files = sorted(f for f in os.listdir(wc) if f.startswith("dyna_")
                       or f.startswith("mesh.res."))
        ferr = 0.0
        for f in files:
            if f.startswith("dyna_"):
                a, b = (read_table(os.path.join(w, f)) for w in (wg, wc))
                if a.shape != b.shape or not np.array_equal(a[:, [0, 2]],
                                                             b[:, [0, 2]]):
                    raise AssertionError(f"{label}: {f} rows differ")
                pairs = [(a[:, j], b[:, j]) for j in range(1, a.shape[1])]
            else:
                ra, rb = (mods["read_result"](os.path.join(w, f))
                          for w in (wg, wc))
                pairs = [(np.asarray(x[1]), np.asarray(y[1])) for x, y in
                         zip(ra["node_comps"], rb["node_comps"])]
            for a, b in pairs:
                ferr = max(ferr, float(np.abs(a - b).max() /
                                       max(np.abs(b).max(), 1e-300)))
        log(f"phase dynamic_small_reference: {label}, arm {g.arm}, cuda vs "
            f"cpu max rel diff {rel!r}, newton per step {newton[0]} vs "
            f"{newton[1]}, cg {cg[0]} vs {cg[1]}, files {files} max rel "
            f"diff {ferr!r}")
        if not (rel <= 1e-12 and newton[0] == newton[1]
                and len(cg[0]) == len(cg[1])
                and all(abs(a - b) <= 1 for a, b in zip(*cg))
                and ferr <= 1e-10 and files and sorted(
                    f for f in os.listdir(wg) if f.startswith("dyna_")
                    or f.startswith("mesh.res.")) == files):
            raise AssertionError(f"dynamic_small_reference: {label}: cuda "
                                 "and cpu runs differ")


# ---- heat, eigen, frequency response, STATICEIGEN ---------------------
# the heat material: steel-like, a conductivity that falls with T (two
# rows: the fixed-point loop runs more than once a step)
HEAT_ITEMS = {1: [[7.8e-6]], 2: [[460.0]], 3: [[50.0, 0.0], [35.0, 500.0]]}
HEATCNT = ("!SOLUTION, TYPE=HEAT\n!HEAT\n {heat}\n!FIXTEMP\n X0, {fix!r}\n"
           "{loads}!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n {nier}, 1\n"
           " {resid}, 1.0, 0.0\n{write}!END\n")
EIGCNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!EIGEN\n {nget}, 1.0e-8, 60\n"
          "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
          " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n{step}"
          "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
          " {nier}, 1\n 1.0e-10, 1.0, 0.0\n!WRITE, RESULT\n!END\n")
FREQCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 11, 2\n"
           " {f0!r}, {f1!r}, {nf}, 1.0\n 0.5, 0.25\n 1, 1, {ray_m!r}, 0.0\n"
           "!EIGENREAD\n eigen.log\n 1, {nmode}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
           "{loads}!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!DENSITY\n"
           " 7.85e-9\n!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
           " 10000, 1\n 1.0e-10, 1.0, 0.0\n!END\n")
READCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
           "!TEMPERATURE, READRESULT=1, SSTEP=1\n!REFTEMP\n 20.0\n"
           "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!EXPANSION_COEFF\n"
           " 1.2e-5\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
           " 1.0e-10, 1.0, 0.0\n!END\n")


def side_faces(mods, mesh, axis, block=0):
    """(n, 2) rows (element id, face number) of the faces of block
    ``block`` on the side where coordinate ``axis`` is largest."""
    b = mesh.blocks[block]
    x = mesh.coords[:, axis]
    on_side = np.isclose(x, x.max())
    ncorner = {111: 2, 112: 2, 231: 3, 232: 3, 241: 4, 242: 4}
    rows = [(int(e), f) for f, (ft, ln) in
            enumerate(mods["face_tables"][b.etype], start=1)
            for e in b.elem_ids[on_side[b.conn[:, ln[:ncorner[ft]]]]
                                .all(axis=1)]]
    return np.asarray(rows, np.int64)


def heat_material(mesh, T0=20.0, items=HEAT_ITEMS):
    """The heat material on ``mesh``, !ZERO -273.15 and the initial
    temperature T0 on every node."""
    mesh.materials["M1"].items = {k: [list(r) for r in v]
                                  for k, v in items.items()}
    mesh.zero_temp = -273.15
    mesh.initial_conditions = {"TEMPERATURE": np.stack(
        [np.arange(mesh.n_node), np.full(mesh.n_node, T0)], 1)}
    return mesh


def write_shuffled(path, mods, mesh, cnt, sgroups=None, egroups=None,
                   ngroups=("X0", "X1")):
    """``cnt`` in ``path`` with the mesh's nodes shuffled (seed 3; the
    RCM reorder then runs)."""
    order = np.random.default_rng(3).permutation(mesh.n_node)
    mods["write_static_workdir"](
        path, mods["ordering"].permute_mesh(mesh, order), cnt,
        ngroups=ngroups, egroups=egroups, sgroups=sgroups)
    return str(path)


def heat_relres(last) -> float:
    """||b - A x|| / ||b|| of a heat solve's constrained system
    A x = P (K + C/dt) P x + (I - P) x, with K applied by scattering the
    element matrices with index_add_ (independent of the incidence
    gather-sum)."""
    x, free, dtc = last["x"], last["free"], last["dt_inv_C"]
    xf = x * free
    y = torch.zeros_like(x)
    for ke, d in zip(last["kes"], last["dofs"]):
        y.index_add_(0, d.reshape(-1),
                     torch.einsum("eij,ej->ei", ke, xf[d]).reshape(-1))
    r = last["b"] - ((y + dtc * xf) * free + x * (1.0 - free))
    return float(torch.linalg.norm(r) / torch.linalg.norm(last["b"]))


def phase_heat_main_path(args, mods) -> dict:
    """Transient heat through run_directory on a shuffled box_hex8(h)
    (default h=32: 35,937 temperature dofs, 32,768 hex8; 100 gives
    1,030,301): rho
    7.8e-6, c 460 and a conductivity falling from 50 at 0 to 35 at 500;
    X0 fixed at 200 from an initial 20 on every node, !SFILM on X1 and
    !SRADIATE on the top face (!ZERO -273.15), a !DFLUX body flux;
    ``--heat-steps`` backward-Euler steps (20) of dt = 10 h^2 / alpha
    (alpha = k / (rho c) at 50), ITMAX 20, EPS 1e-3, RESID 1e-10,
    !WRITE, RESULT every 20 steps.  Held to: the last solve's true relres
    (``heat_relres``) <= 1e-7, the fixed-point loop taking more than one
    iteration in some step, finite temperatures within [20, 200] plus
    the body heating, no kernel launched (the path runs the matrix-free
    operator and the incidence gather-sum, plain torch), the last .res
    read back equal to the returned T.  Then times ``conduct_ke`` and
    the heat CG's matrix-free product at the run's shapes."""
    heat = mods["heat"]
    h, n_step = args.heat_n, args.heat_steps
    mesh = heat_material(mods["box_hex8"](h, h, h))
    alpha = 50.0 / (7.8e-6 * 460.0)
    dt = 10.0 * (1.0 / h) ** 2 / alpha
    loads = ("!DFLUX\n ALL, BF, 5.0e3\n!SFILM\n SX1, 0.05, 20.0\n"
             "!SRADIATE\n SZ1, 5.67e-11, 20.0\n")
    cnt = HEATCNT.format(heat=f"{dt!r}, {n_step * dt!r}, 0.0, 0.0, 20, "
                         "1.0e-3", fix=200.0, loads=loads, nier=100000,
                         resid="1.0e-10",
                         write=f"!WRITE, RESULT, FREQUENCY={n_step}\n")
    wd = os.path.join(ROOT, "build", "smoke", f"heat{h}")
    t0 = time.perf_counter()
    write_shuffled(wd, mods, mesh, cnt, sgroups={
        "SX1": side_faces(mods, mesh, 0), "SZ1": side_faces(mods, mesh, 2)})
    log(f"phase heat_workdir: box_hex8({h}) shuffled, HEAT transient, "
        f"{mesh.n_node} dofs, {h ** 3} hex8, dt={dt!r} (alpha dt / h^2 = "
        f"10), {n_step} steps, written in {time.perf_counter() - t0:.2f} s")
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hr = out["heat"]
    tm = out["timings"]
    cg_all = [x for r in hr.history for x in r["cg"]]
    s_all = [x for r in hr.history for x in r["solve_s"]]
    log(f"phase heat_main_path: {wall:.2f} s; steps={hr.steps} "
        f"fixed_point_iters={hr.iters} cg_iters={sum(cg_all)}; peak device "
        f"memory {peak_gb:.3f} GB; kernel launches {launches}")
    log("  phase seconds: " + " ".join(
        f"{k}={tm.get(k, 0.0):.3f}" for k in
        ("read", "reorder", "model", "elements", "solve", "log", "result")))
    for k, r in enumerate(hr.history, start=1):
        ms = [1e3 * s / max(c, 1) for s, c in zip(r["solve_s"], r["cg"])]
        log(f"  step {k}: fixed_point={r['fp']} cg={r['cg']} ms/cg_iter="
            f"{[round(v, 4) for v in ms]}")
    rr = heat_relres(hr.solver.last)
    T = hr.T
    log(f"  last solve true relres (index_add_) = {rr!r}; T in "
        f"[{T.min()!r}, {T.max()!r}]")
    if any(launches.values()):
        raise AssertionError(f"heat_main_path launched kernels {launches}")
    if not rr <= 1e-7:
        raise AssertionError("heat_main_path: last solve relres above 1e-7")
    if hr.steps != n_step or max(r["fp"] for r in hr.history) < 2:
        raise AssertionError("heat_main_path: wrong step count, or the "
                             "fixed-point loop never iterated")
    if not (np.isfinite(T).all() and T.min() >= 20.0 - 1e-3
            and T.max() <= 250.0):
        raise AssertionError("heat_main_path: temperatures out of range")
    back = mods["read_result"](os.path.join(wd, f"mesh.res.0.{n_step}"))
    if not (np.array_equal(back["node_ids"], out["mesh"].node_ids) and
            np.array_equal(np.asarray(back["node_comps"][0][1]).reshape(-1),
                           T)):
        raise AssertionError("heat_main_path: the .res differs from T")
    # the element routine and the CG's product alone, at the run's shapes
    sv = hr.solver
    b, conn, ce, tabs = sv.vol[0]
    Tt = torch.as_tensor(T, device="cuda")
    table = mods["get_table"](b.etype)
    ke_ms = cuda_ms(lambda: heat.conduct_ke(table, ce, Tt[conn], tabs[0],
                                             b.thick, 3), reps=3, warmup=1)
    op = mods["femop"].FEOperator(sv.last["kes"], sv.dofs, sv.gather,
                                  sv.model.n_node, 1, sv.free)
    mv_ms = cuda_ms(lambda: op.matvec(Tt), reps=10)
    E, m = sv.last["kes"][0].shape[:2]
    nbytes = 8 * (E * m * m + 2 * E * m + T.size * 2)
    mv_bound, _ = bound(nbytes, 2 * E * m * m, torch.float64)
    cg_ms = 1e3 * sum(s_all) / max(sum(cg_all), 1)
    log(f"  conduct_ke at E={E}: {ke_ms:.3f} ms; heat CG {cg_ms:.4f} ms an "
        f"iteration (solve seconds over CG iterations); its matvec alone "
        f"{mv_ms:.4f} ms, bytes bound of the (E, {m}, {m}) product "
        f"{mv_bound:.4f} ms")
    return dict(ke_ms=ke_ms, cg_ms=cg_ms, mv_ms=mv_ms, mv_bound=mv_bound,
                peak_gb=peak_gb)


def phase_eigen_main_path(args, mods) -> tuple:
    """EIGEN through run_directory on a shuffled box_hex8(e), a 100 mm
    cube (default e=24: 46,875 dofs, 13,824 hex8 IC; on a 1 mm cube
    the Lanczos breakdown test beta < 1e-14, absolute, as in the JAX
    package, stops at the first step), E 210000, nu 0.3, rho 7.85e-9,
    X0 clamped, !EIGEN 10, 1e-8, 60, NIER 20000 (the shift-invert CG is
    block-Jacobi to 1e-10), !WRITE, RESULT.  Held to, with K applied by
    an index_add_ of the element matrices: each pair's
    ||K phi - lambda M phi|| / ||K phi|| <= 1e-6 on the free dofs, and
    max |Phi^T M Phi - I| <= 1e-8; no kernel launched.  Returns (the
    work directory, the mesh, the result)."""
    e = args.eigen_n
    mesh = mods["box_hex8"](e, e, e, lx=100.0, ly=100.0, lz=100.0)
    wd = os.path.join(ROOT, "build", "smoke", f"eigen{e}")
    t0 = time.perf_counter()
    write_shuffled(wd, mods, mesh, EIGCNT.format(
        sol="EIGEN", nget=10, loads="", step="", nier=20000))
    log(f"phase eigen_workdir: box_hex8({e}) shuffled, EIGEN 10 modes, "
        f"{3 * mesh.n_node} dofs, {e ** 3} hex8, written in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    er, model = out["eigen"], out["model"]
    cg = [hh["cg"] for hh in er.history]
    secs = [hh["s"] for hh in er.history]
    log(f"phase eigen_main_path: {wall:.2f} s; formulation="
        f"{model.blocks[0].formulation}, lanczos_iters={er.iters}, "
        f"applies={len(cg)}, cg per apply {cg}, s per apply "
        f"{[round(s, 3) for s in secs]} (mean {np.mean(secs):.3f} s, "
        f"{1e3 * sum(secs) / max(sum(cg), 1):.4f} ms a CG iteration); "
        f"peak device memory {peak_gb:.3f} GB; kernel launches {launches}")
    log(f"  frequencies (Hz): {[float(f) for f in er.freq]}")
    kes = mods["static"].compute_element_stiffness(model)
    mass = mods["dynamic"].lumped_mass_vector(model)
    free = torch.ones(model.n_dof_total, dtype=torch.float64, device="cuda")
    free[torch.as_tensor(model.fixed_dofs, device="cuda")] = 0.0
    phi = torch.as_tensor(er.eigenvectors, device="cuda")
    res = []
    for k in range(phi.shape[1]):
        kp = element_force(model, kes, phi[:, k]) * free
        r = kp - float(er.eigenvalues[k]) * mass * phi[:, k] * free
        res.append(float(torch.linalg.norm(r) / torch.linalg.norm(kp)))
    orth = float((phi.T @ (mass[:, None] * phi) - torch.eye(
        phi.shape[1], dtype=torch.float64, device="cuda")).abs().max())
    log(f"  ||K phi - lambda M phi|| / ||K phi|| (index_add_) = {res}; "
        f"max |Phi^T M Phi - I| = {orth!r}")
    if any(launches.values()):
        raise AssertionError(f"eigen_main_path launched kernels {launches}")
    if len(res) != 10 or not max(res) <= 1e-6 or not orth <= 1e-8:
        raise AssertionError("eigen_main_path: eigenpairs fail their gates")
    return wd, mesh, er


def phase_freq_main_path(mods, wd, mesh, er, nf=200):
    """A !DYNAMIC idx_resp = 2 deck on the eigen path's work directory:
    !EIGENREAD of its 0.log and .res modes, !FLOAD in z at X1's corner
    (y = z = max), ``nf`` frequencies from 0.8 f1 to 1.1 f3, light
    Rayleigh damping (ray_m = 0.01 omega1).  Held to: the displacement
    amplitude has a local maximum within one frequency step of each of
    the first three eigenfrequencies whose mode the load excites
    (|phi^T F| >= 1e-3 of the largest)."""
    x1 = mesh.node_groups["X1"]
    corner = int(mesh.node_ids[x1[np.argmax(mesh.coords[x1, 1] +
                                            mesh.coords[x1, 2])]])
    f = er.freq
    f0, f1 = 0.8 * float(f[0]), 1.1 * float(f[2])
    shutil.copy(os.path.join(wd, "0.log"), os.path.join(wd, "eigen.log"))
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(FREQCNT.format(
            f0=f0, f1=f1, nf=nf, ray_m=0.01 * 2 * np.pi * float(f[0]),
            nmode=len(f), loads=f"!FLOAD, LOAD CASE=1\n {corner}, 3, 1.0\n"))
    reset_kernel_launches(mods)
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts(mods)
    fr, model = out["freq"], out["model"]
    amp = fr.disp_amp_max
    F = np.zeros(model.n_dof_total)
    F[model.mesh.id2idx[corner] * 3 + 2] = 1.0
    pf = np.abs(fr.eigen.eigenvectors.T @ F)
    df = fr.freqs[1] - fr.freqs[0]
    peaks = [i for i in range(1, len(amp) - 1)
             if amp[i] >= amp[i - 1] and amp[i] >= amp[i + 1]]
    log(f"phase freq_main_path: {wall:.2f} s; {len(fr.freqs)} frequencies "
        f"{f0!r}..{f1!r} Hz, !EIGENREAD of {len(pf)} modes; |phi^T F| of "
        f"the first three {[float(v) for v in pf[:3]]}; amplitude peaks at "
        f"{[float(fr.freqs[i]) for i in peaks]} Hz; kernel launches "
        f"{launches}")
    if any(launches.values()):
        raise AssertionError(f"freq_main_path launched kernels {launches}")
    if not np.isfinite(amp).all() or amp.shape != (nf,):
        raise AssertionError("freq_main_path: amplitudes not finite")
    for k in range(3):
        if pf[k] >= 1e-3 * pf.max() and not any(
                abs(fr.freqs[i] - f[k]) <= df for i in peaks):
            raise AssertionError(f"freq_main_path: no amplitude peak at "
                                 f"mode {k + 1} ({f[k]!r} Hz)")


def small_heat_mesh(mods, kind):
    """The small heat decks' meshes with the heat material (T-dependent
    specific heat and conductivity), !ZERO and an initial 20, interior
    nodes moved by a seeded draw (no ties by symmetry)."""
    mg = mods["meshgen"]
    if isinstance(kind, int):          # a 3-D solid type
        mesh = solid_mesh(mods, kind, (3, 2, 2), lx=3.0, ly=1.0, lz=0.7)
    else:
        mesh = {"hex8": lambda: mg.box_hex8(4, 3, 2, lx=4.0, ly=1.0,
                                            lz=0.7),
                "tet10": lambda: tet10_mesh(mods, (2, 2, 1)),
                "quad": lambda: mg.box_plane(4, 3, lx=2.0),
                "iface": lambda: mg.hex8_pair_541(2)}[kind]()
    heat_material(mesh, items={1: [[7.8e-6]], 2: [[460.0, 0.0],
                                                  [520.0, 400.0]],
                               3: [[50.0, 0.0], [42.0, 150.0],
                                   [30.0, 400.0]]})
    c = mesh.coords
    side = np.zeros(mesh.n_node, bool)
    for ax in range(3):
        if np.ptp(c[:, ax]):
            side |= np.isclose(c[:, ax], c[:, ax].min()) | \
                np.isclose(c[:, ax], c[:, ax].max())
    side |= np.isclose(c[:, 0], 1.0) & (kind == "iface")
    jit = np.random.default_rng(5).uniform(-0.0025, 0.0025, c.shape)
    jit[side] = 0.0
    jit[:, np.ptp(c, axis=0) == 0] = 0.0
    mesh.coords = c + jit
    return mesh


def small_heat_deck(mods, kind, transient, path, mesh=None, method="CG"):
    mesh = small_heat_mesh(mods, kind) if mesh is None else mesh
    egrp = "SOLID" if kind == "iface" else "ALL"
    loads = (f"!CFLUX\n {int(mesh.node_ids[-1])}, 2.0\n!DFLUX\n {egrp}, BF, "
             "0.5\n!SFILM\n SHI, 0.02, 20.0\n!SRADIATE\n SHI, 5.67e-11, "
             "300.0\n")
    if kind == "hex8" and transient:
        loads += ("!WELD_LINE\n 120.0, 10.0, 0.5, 1.0\n ALL, 1, 0.0, 4.0, "
                  "0.7, 0.0\n")
    steps = "1.0e-4, 3.0e-4" if transient else "0.0, 0.0"
    cnt = HEATCNT.format(heat=steps + ", 0.0, 0.0, 20, 1.0e-6", fix=100.0,
                         loads=loads, nier=2000, resid="1.0e-12",
                         write="!WRITE, RESULT\n")
    shi = side_faces(mods, mesh, 1, block=1 if kind == "iface" else 0)
    return write_shuffled(path, mods, mesh, cnt.replace(
        "METHOD=CG", f"METHOD={method}"), sgroups={"SHI": shi})


def rel_diff(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cg_close(a, b) -> bool:
    return len(a) == len(b) and all(abs(x - y) <= 1 for x, y in zip(a, b))


def phase_heat_eigen_small_reference(mods) -> dict:
    """Small decks through run_directory on the card and on the CPU
    (which the CPU tests hold to the JAX package): steady and transient
    heat on hex8 (the transient with a weld line), tet10 and a 2-D quad
    and a transient on the 541 pair, all with film and radiation; EIGEN
    on tet4 and hex8; frequency response by !EIGENREAD of the hex8 run;
    STATICEIGEN on tet4; a heat result read by a STATIC deck's
    !TEMPERATURE, READRESULT.  Temperatures, eigenvalues and amplitudes
    within 1e-10 of the largest, displacements within 1e-8; fixed-point,
    Lanczos and Newton iterations equal; CG within one per solve.
    STATICEIGEN's K1 element launches = its Newton iterations, and K1 is
    held to its plain version at that run's cluster plan with the
    converged tangent, its planes entry at the run's nodal-smoothing
    plan.  Returns the K1 entry of the kernels line."""
    run = mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "heat_eigen_small")

    def both(label, write):
        outs = [run(write(os.path.join(base, label.replace(" ", "_"), d)),
                    device=d) for d in ("cuda", "cpu")]
        return outs

    for kind, transient in (("hex8", False), ("hex8", True),
                            ("tet10", False), ("tet10", True),
                            ("quad", False), ("quad", True),
                            ("iface", True)):
        label = f"heat {kind} {'transient' if transient else 'steady'}"
        g, c = both(label, lambda p: small_heat_deck(mods, kind, transient,
                                                     p))
        hg, hc = g["heat"], c["heat"]
        rel = rel_diff(hg.T, hc.T)
        fp = [[r["fp"] for r in h.history] for h in (hg, hc)]
        cg = [[x for r in h.history for x in r["cg"]] for h in (hg, hc)]
        log(f"phase heat_eigen_small_reference: {label}, cuda vs cpu max "
            f"rel diff {rel!r}, fixed point {fp[0]} vs {fp[1]}, cg {cg[0]} "
            f"vs {cg[1]}")
        if not (rel <= 1e-10 and fp[0] == fp[1] and cg_close(*cg)):
            raise AssertionError(f"heat_eigen_small_reference: {label}")
    mg = mods["meshgen"]
    eig = EIGCNT.format(sol="EIGEN", nget=5, loads="", step="", nier=10000)
    for name in ("box_tet4", "box_hex8"):
        mesh = getattr(mg, name)(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
        g, c = both(f"eigen {name}", lambda p: write_shuffled(p, mods, mesh,
                                                               eig))
        eg, ec = g["eigen"], c["eigen"]
        rel = rel_diff(eg.eigenvalues, ec.eigenvalues)
        cg = [[h["cg"] for h in e.history] for e in (eg, ec)]
        log(f"phase heat_eigen_small_reference: eigen {name}, lanczos "
            f"{eg.iters} vs {ec.iters}, eigenvalues max rel diff {rel!r}, cg "
            f"{cg[0]} vs {cg[1]}")
        if not (eg.iters == ec.iters and rel <= 1e-10 and cg_close(*cg)):
            raise AssertionError(f"heat_eigen_small_reference: eigen {name}")
    # frequency response from the hex8 eigen run's files (CPU-written)
    fq = c["eigen"].freq
    amps = []
    for d in ("cuda", "cpu"):
        wd = os.path.join(base, "freq", d)
        shutil.rmtree(wd, ignore_errors=True)
        shutil.copytree(os.path.join(base, "eigen_box_hex8", "cpu"), wd)
        shutil.copy(os.path.join(wd, "0.log"), os.path.join(wd, "eigen.log"))
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(FREQCNT.format(
                f0=0.5 * float(fq[0]), f1=1.5 * float(fq[2]), nf=30,
                ray_m=3.0, nmode=5, loads="!FLOAD, LOAD CASE=1\n X1, 3, "
                "1.0\n!FLOAD, LOAD CASE=2\n X1, 2, 0.5\n"))
        amps.append(run(wd, device=d)["freq"])
    rel = max(rel_diff(getattr(amps[0], f), getattr(amps[1], f)) for f in
              ("disp_amp_max", "vel_amp_max", "acc_amp_max", "disp_re",
               "disp_im"))
    log(f"phase heat_eigen_small_reference: frequency response !EIGENREAD, "
        f"cuda vs cpu max rel diff {rel!r}")
    if not rel <= 1e-10:
        raise AssertionError("heat_eigen_small_reference: frequency response")
    # STATICEIGEN: K1 once per Newton iteration
    mesh = mg.box_tet4(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    se = EIGCNT.format(sol="STATICEIGEN", nget=5, nier=10000,
                       loads="!CLOAD\n X1, 3, -20.0\n",
                       step="!STEP, SUBSTEPS=2, CONVERG=1.0e-8\n")
    reset_kernel_launches(mods)
    g = run(write_shuffled(os.path.join(base, "staticeigen", "cuda"), mods,
                           mesh, se), device="cuda")
    launches = kernel_launch_counts(mods)
    c = run(write_shuffled(os.path.join(base, "staticeigen", "cpu"), mods,
                           mesh, se), device="cpu")
    nw = [o["static"].newton for o in (g, c)]
    its = [[h["iter"] for h in n.history] for n in nw]
    relu = rel_diff(g["static"].u, c["static"].u)
    rel = rel_diff(g["eigen"].eigenvalues, c["eigen"].eigenvalues)
    log(f"phase heat_eigen_small_reference: STATICEIGEN box_tet4, newton "
        f"{its[0]} vs {its[1]}, u max rel diff {relu!r}, lanczos "
        f"{g['eigen'].iters} vs {c['eigen'].iters}, eigenvalues max rel "
        f"diff {rel!r}; kernel launches {launches}")
    if not (its[0] == its[1] and relu <= 1e-8 and rel <= 1e-10 and
            g["eigen"].iters == c["eigen"].iters):
        raise AssertionError("heat_eigen_small_reference: STATICEIGEN")
    if launches["K1"] != nw[0].total_iters or launches["K1 planes"] < 1:
        raise AssertionError(f"STATICEIGEN: K1 launches {launches}, Newton "
                             f"iterations {nw[0].total_iters}")
    model, nl = g["model"], mods["nonlinear"]
    u = torch.as_tensor(np.asarray(g["static"].u).reshape(-1), device="cuda")
    kes = []
    for b in model.blocks:
        p = nl.BlockPrograms(model, b)
        u_e = nl._element_values(u, p, model.n_node, model.ndof)
        s, _ = p.update(u_e * 0.0, u_e, nl.init_block_state(b, p.table,
                                                            "cuda"))
        kes.append(p.tangent(u_e, u_e * 0.0, s))
    setup = mods["static"].cluster_setup(model, {})
    err = check_k1(mods["segsum"], setup.cprof.plan("cuda"), kes,
                   [b.conn.shape[1] for b in model.blocks], torch.float64,
                   "STATICEIGEN converged tangent")
    conn = np.concatenate([np.asarray(b.conn, np.int64).reshape(-1)
                           for b in model.blocks])
    plan = mods["nodal"].node_plan(conn, model.n_node, "cuda")
    err = max(err, check_planes(mods["segsum"], plan, torch.randn(
        (13, plan.perm.numel()), dtype=torch.float64, device="cuda",
        generator=torch.Generator("cuda").manual_seed(13)), torch.float64,
        "STATICEIGEN nodal smoothing"))
    # a heat result read by a STATIC deck (!TEMPERATURE, READRESULT)
    def readresult(p):
        wd = small_heat_deck(mods, "hex8", False, p)
        run(wd, device="cpu")
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(READCNT)
        with open(os.path.join(wd, "hecmw_ctrl.dat"), "a") as fh:
            fh.write("!RESULT, NAME=fstrTEMP, IO=IN\n mesh.res\n")
        return wd
    g, c = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                    lambda: both("readresult", readresult))
    relu = rel_diff(g["static"].u, c["static"].u)
    log(f"phase heat_eigen_small_reference: heat -> !TEMPERATURE, "
        f"READRESULT static hex8, T max {g['model'].temperature.max()!r}, "
        f"u max rel diff {relu!r}")
    if not (relu <= 1e-8 and g["model"].temperature.max() > 90.0):
        raise AssertionError("heat_eigen_small_reference: READRESULT")
    return {"launches": launches["K1"], "planes_launches":
            launches["K1 planes"], "newton_iters": nw[0].total_iters,
            "max_abs_err": err}


def with_env(env: dict, fn):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_small_reference(mods):
    """A small deck through the AMG arm in the mixed policy, on the card
    and on the CPU (which the CPU tests hold to the JAX package).  In
    box_tet4(30, 30, 2), shuffled and RCM-ordered, one level-1 AMG block
    is singular up to rounding, the case that once broke the V-cycle on
    the card; a V-cycle that differs shows in the CG iteration count."""
    small = os.path.join(ROOT, "build", "smoke", "tet30x30x2")
    write_workdir(small, (30, 30, 2), mods["ordering"], mods["box_tet4"],
                  mods["write_static_workdir"])
    run = mods["run_directory"]
    r_gpu, r_cpu = with_env(
        {"FRONTISTR_TPU_PRECOND": "amg", "FRONTISTR_TPU_PRECISION": "mixed"},
        lambda: (run(small, device="cuda")["static"],
                 run(small, device="cpu")["static"]))
    compare_runs("small_reference", "box_tet4(30,30,2) AMG mixed", r_gpu,
                 r_cpu)


def phase_hex_small_reference(mods):
    """box_hex8(8, 6, 5) through the stencil arm in the mixed policy, on
    the card (K2) and on the CPU (its plain version)."""
    stmod = mods["static"]

    def run():
        return [stmod.run_linear_static(hex_model(mods, (8, 6, 5), dev))
                for dev in ("cuda", "cpu")]
    r_gpu, r_cpu = with_env({"FRONTISTR_TPU_PRECISION": "mixed"}, run)
    compare_runs("hex_small_reference", "box_hex8(8,6,5) stencil mixed",
                 r_gpu, r_cpu)


def phase_newton_small_reference(mods):
    """A small NLSTATIC deck (shuffled box_tet4(10, 8, 6), a load that
    takes several Newton iterations) through the AMG in the mixed
    policy, on the card and on the CPU: the same Newton iterations, and
    displacements within 1e-8 of max|u|."""
    small = os.path.join(ROOT, "build", "smoke", "newton10x8x6")
    write_workdir(small, (10, 8, 6), mods["ordering"], mods["box_tet4"],
                  mods["write_static_workdir"], NLCNT.format(load=-100.0))
    run = mods["run_directory"]
    r_gpu, r_cpu = with_env(
        {"FRONTISTR_TPU_PRECOND": "amg", "FRONTISTR_TPU_PRECISION": "mixed"},
        lambda: (run(small, device="cuda")["static"],
                 run(small, device="cpu")["static"]))
    rel = float(np.abs(r_gpu.u - r_cpu.u).max() / np.abs(r_cpu.u).max())
    its = [[h["iter"] for h in r.newton.history] for r in (r_gpu, r_cpu)]
    cg = [[h["cg_iters"] for h in r.newton.history] for r in (r_gpu, r_cpu)]
    log(f"phase newton_small_reference: box_tet4(10,8,6) NLSTATIC AMG "
        f"mixed, newton iterations {r_gpu.iters} vs {r_cpu.iters}, cg "
        f"{cg[0]} vs {cg[1]}, cuda vs cpu max rel diff {rel!r}")
    if r_gpu.iters < 3 or its[0] != its[1]:
        raise AssertionError("newton_small_reference: Newton iterations "
                             "differ (or fewer than 3)")
    if not rel <= 1e-8:
        raise AssertionError("newton_small_reference: cuda and cpu "
                             "displacements disagree")


def compare_runs(phase: str, label: str, r_gpu, r_cpu):
    rel = float(np.abs(r_gpu.u - r_cpu.u).max() / np.abs(r_cpu.u).max())
    log(f"phase {phase}: {label}, cuda vs cpu max rel diff {rel!r}, "
        f"cg_iters {r_gpu.iters} vs {r_cpu.iters}")
    if not (r_gpu.relres <= 1e-8 and r_cpu.relres <= 1e-8):
        raise AssertionError(f"{phase}: a run did not converge")
    if not rel <= 1e-6:
        raise AssertionError(f"{phase}: cuda and cpu runs disagree")
    if not abs(r_gpu.iters - r_cpu.iters) <= 2 + 0.05 * r_cpu.iters:
        raise AssertionError(f"{phase}: cuda and cpu solves take "
                             "different paths")


# ---- PR: direct solves, MPC / springs, 3-D prisms and hex20 ----------------
HEX20_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7))
PRISM15_EDGES = ((0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (0, 3),
                 (1, 4), (2, 5))


def regroup(mesh):
    """The box's face node groups X0..Z1 and ALL from its coordinates."""
    c = mesh.coords
    for g in ("X0", "X1", "Y0", "Y1", "Z0", "Z1"):
        x = c[:, "XYZ".index(g[0])]
        mesh.node_groups[g] = np.flatnonzero(np.isclose(
            x, x.max() if g[1] == "1" else x.min())).astype(np.int64)
    mesh.node_groups["ALL"] = np.arange(len(c), dtype=np.int64)
    mesh.node_ids = np.arange(1, len(c) + 1, dtype=np.int64)
    mesh.id2idx = {int(g): int(g) - 1 for g in mesh.node_ids}
    mesh.structured = None
    return mesh


def prism6_mesh(mods, dims, **kw):
    """``box_hex8(*dims)`` with every hex split into two 351 prisms."""
    m = mods["box_hex8"](*dims, **kw)
    h = m.blocks[0].conn
    conn = np.concatenate([h[:, [0, 1, 2, 4, 5, 6]],
                           h[:, [0, 2, 3, 4, 6, 7]]]).astype(np.int32)
    ids = np.arange(1, len(conn) + 1, dtype=np.int64)
    m.blocks = [mods["ElemBlock"](351, ids, conn, conn.copy(), 0)]
    m.elem_groups = {"ALL": ids}
    return regroup(m)


def raise_order(mods, m, etype):
    """A 351 or 361 mesh raised to 352 or 362 by mid-edge nodes."""
    lin = m.blocks[0].conn.astype(np.int64)
    edges = np.stack([np.sort(lin[:, list(e)], axis=1) for e in
                      (HEX20_EDGES if etype == 362 else PRISM15_EDGES)], 1)
    uniq, inv = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
    conn = np.concatenate([lin, m.n_node + inv.reshape(len(lin), -1)],
                          axis=1).astype(np.int32)
    m.coords = np.concatenate([m.coords, m.coords[uniq].mean(axis=1)])
    hecmw = conn.copy()                  # fstr[k] = hecmw[TABLE[k] - 1]
    if etype in mods["hecmw2fstr"]:
        hecmw[:, np.asarray(mods["hecmw2fstr"][etype]) - 1] = conn
    m.blocks = [mods["ElemBlock"](etype, m.blocks[0].elem_ids, conn, hecmw,
                                  0)]
    return regroup(m)


def hex20_mesh(mods, dims, **kw):
    """``box_hex8(*dims)`` raised to hex20 (362): (n+1)^3 corners and
    3 n (n+1)^2 edge midpoints on a cube of n."""
    return raise_order(mods, mods["box_hex8"](*dims, **kw), 362)


def solid_mesh(mods, etype, dims, **kw):
    return {341: lambda: mods["box_tet4"](*dims, **kw),
            342: lambda: tet10_mesh(mods, dims),
            351: lambda: prism6_mesh(mods, dims, **kw),
            352: lambda: raise_order(mods, prism6_mesh(mods, dims, **kw),
                                     352),
            361: lambda: mods["box_hex8"](*dims, **kw),
            362: lambda: hex20_mesh(mods, dims, **kw)}[etype]()


def tie_face(mods, mesh, group="X1", dof=3, master=None):
    """Tie ``dof`` of every node of ``group`` to one master node of it
    (by default its first) by 1:-1 !EQUATIONs; returns the master."""
    nodes = mesh.node_groups[group]
    m = int(nodes[0]) if master is None else int(master)
    mesh.equations = [mods["Equation"](np.asarray([int(k), m]),
                                       np.asarray([dof, dof]),
                                       np.asarray([1.0, -1.0]), 0.0)
                      for k in nodes if int(k) != m]
    return m


# the hex20_mpc deck: the Newton cell's NLSTATIC deck with X1's u_z tied
# to one master node (a rigid end plate), the load on the master, and a
# spring from the master to the ground; f64 policy as the Newton cell
MPCCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
          "!CLOAD\n {mast}, 3, {load!r}\n!SPRING\n {mast}, 3, {k!r}\n"
          "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!STEP, SUBSTEPS=1\n"
          " BOUNDARY, 1\n LOAD, 1\n!SOLVER, METHOD={method}, ITERLOG=NO, "
          "TIMELOG=NO\n 10000, 1\n {resid}, 1.0, 0.0\n!END\n")


def phase_hex20_mpc_main_path(args, mods) -> dict:
    """The hex20_mpc cell through run_directory: NLSTATIC (total
    Lagrange) in the f64 policy on a shuffled hex20 box of n (default
    24: 60,625 nodes, 181,875 dofs, 13,824 elements of type 362), X0
    fixed, every X1 node's u_z tied by !EQUATION to the node at X1's
    middle, a !CLOAD of -(X1's node count)/2 in z there and a !SPRING to
    the ground in z of 1e-3 E A / L.  (At the full -(X1's node count),
    -5,985, Newton fails on this box: the St. Venant-Kirchhoff material
    collapses in compression where the stress is singular, a smallest
    principal stretch of 0.113 already on a box of 32;
    ``python -m frontistr_tpu_torch.microbench.hex20_load``, PERF.md
    §6.)  Per
    Newton iteration: rres/rxnrm, CG, passes, the solver's relres and an
    independent index_add_ true relres of the eliminated system (<=
    1e-8).  At the end max |u_z(dep) - u_z(master)| <= 1e-10 max|u|; K1
    element launches = Newton iterations; K1 planes launches = 2 per AMG
    setup + 1 per nodal smoothing + 1 per reduction T^T (``mpc_Tt``).
    The first solve is then repeated on the same system: the same CG
    count and a bit-equal answer.  Returns the counts, the model and
    the first tangent's K1 inputs."""
    nl, sm, ex = mods["nonlinear"], mods["segsum"], mods["extras"]
    n = args.hex20_n
    wd = os.path.join(ROOT, "build", "smoke", f"hex20_mpc{n}")
    t0 = time.perf_counter()
    mesh = hex20_mesh(mods, (n, n, n))
    x1 = mesh.node_groups["X1"]
    mid = x1[np.argmin(np.linalg.norm(mesh.coords[x1] - [1.0, 0.5, 0.5],
                                      axis=1))]
    mast = tie_face(mods, mesh, master=mid)
    k = 1e-3 * 210000.0 * 1.0 / 1.0               # 1e-3 E A / L
    cnt = MPCCNT.format(mast=int(mesh.node_ids[mast]),
                        load=-0.5 * len(x1), k=k, method="CG",
                        resid="1.0e-8")
    write_shuffled(wd, mods, mesh, cnt)
    log(f"phase hex20_mpc_workdir: hex20 box of {n} shuffled, "
        f"{mesh.n_node} nodes, {3 * mesh.n_node} dofs, "
        f"{len(mesh.blocks[0].elem_ids)} elements of type 362, "
        f"{len(mesh.equations)} equations on one master, spring k={k!r}, "
        f"written in {time.perf_counter() - t0:.2f} s")
    del mesh
    solves, first, calls = [], {}, {}
    real = nl.make_constrained_solver
    nl.make_constrained_solver = keep_first_solver(nl, solves, first)
    restore = counting(mods, calls)
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: mods["run_directory"](wd, device="cuda"))
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver = real
        restore()
    launches = kernel_launch_counts(mods)
    reductions = calls["mpc_Tt"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model = out["static"], out["model"]
    nw, tm = res.newton, res.timings
    keys = ("tangent", "assembly", "amg_setup", "solve", "update")
    log(f"phase hex20_mpc_main_path: {wall:.2f} s; policy={res.policy} "
        f"newton_iters={nw.total_iters} cutbacks={nw.cutbacks} "
        f"cg_iters={[s['cg_iters'] for s in solves]} K1 launches="
        f"{launches['K1']} (element), K1 planes launches="
        f"{launches['K1 planes']} ({calls['setup_amg']} AMG setups x "
        f"{PLANES_PER_AMG_SETUP} + {calls['smooth']} nodal smoothings + "
        f"{reductions} reductions T^T), peak device memory {peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(
        f"{k}={tm.get(k, 0.0):.3f}" for k in
        keys + ("read", "reorder", "model", "profile", "post")))
    for h, sv in zip(nw.history, solves):
        log(f"  step {h['step']} substep {h['substep']} it {h['iter']}: "
            f"rres={h['rres']!r} rxnrm={h['rxnrm']!r} "
            f"cg_iters={sv['cg_iters']} passes={sv['passes']} "
            f"relres={sv['relres']!r} true_relres={sv['true_relres']!r}; "
            + " ".join(f"{k}={h[k]:.3f}" for k in keys))
    if len(solves) != len(nw.history) or not solves:
        raise AssertionError("hex20_mpc_main_path: solves and iterations "
                             "do not pair up")
    last = nw.history[-1]
    if res.policy != "f64" or nw.cutbacks or \
            min(last["rres"], last["rxnrm"]) >= 1e-6:
        raise AssertionError("hex20_mpc_main_path: Newton did not converge "
                             "without cutbacks in the f64 policy")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    u = res.u
    if not (u.shape == (model.n_node, 3) and np.isfinite(u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    eqs = model.mesh.equations
    dep = np.asarray([int(e.nodes[0]) for e in eqs])
    mst = np.asarray([int(e.nodes[1]) for e in eqs])
    tie = float(np.abs(u[dep, 2] - u[mst, 2]).max())
    log(f"  max |u_z(dep) - u_z(master)| = {tie!r}, max|u| = "
        f"{float(np.abs(u).max())!r}")
    if not tie <= 1e-10 * np.abs(u).max():
        raise AssertionError("hex20_mpc_main_path: the tie does not hold")
    if launches["K1"] != nw.total_iters:
        raise AssertionError(f"K1 launches {launches['K1']} != Newton "
                             f"iterations {nw.total_iters}")
    if calls["setup_amg"] < 1 or reductions < 1 or \
            launches["K1 planes"] != PLANES_PER_AMG_SETUP * \
            calls["setup_amg"] + calls["smooth"] + reductions:
        raise AssertionError(f"K1 planes launches {launches['K1 planes']} "
                             f"do not add up: {calls}")
    with open(os.path.join(wd, "FSTR.sta")) as fh:
        if "HAS COMPLETED SUCCESSFULLY" not in fh.read():
            raise AssertionError("FSTR.sta does not report success")
    cg_iters = [sv["cg_iters"] for sv in solves]
    repeat_first(first, "hex20_mpc_main_path")
    return {"launches": launches["K1"], "planes_launches":
            launches["K1 planes"], "newton_iters": nw.total_iters,
            "cg_iters": cg_iters, "reductions": reductions, "wall_s": wall, "peak_gb": peak_gb,
            "model": model, "kes": first["kes"]}


def phase_k1_m60_time(mods, model, kes, launches) -> dict:
    """K1 at m = 60 on the hex20_mpc cell's cluster profile (the hex20
    block and the one-node spring block) with the cell's first tangent,
    float64: held to its plain version, timed with it and with one
    index_add_ of the entries in slot order.  Then the planes entry at
    the cell's AMG level-1 and level-2 plans and nodal smoothing, and
    the MPC reduction T^T twice on the card (bit-equal) and against the
    CPU.  Returns the kernels-line row."""
    sm, bell, ex = mods["segsum"], mods["bell"], mods["extras"]
    plan = bell.cluster_profile_from_model(model).plan("cuda")
    ex_kes = ex.extra_tensors(model, "cuda")[0]
    kd = [k.contiguous() for k in list(kes) + ex_kes]
    nns = [b.conn.shape[1] for b in model.blocks] + list(model.extras[3])
    err = check_k1(sm, plan, kd, nns, torch.float64,
                   "hex20_mpc first tangent m = 60 + springs")
    ms = cuda_ms(lambda: sm.segsum(plan, kd, nns, 3))
    plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, nns, 3))
    ent = sm.entry_planes(kd, nns, 3)[:, plan.perm.long()]
    out = torch.zeros((9, plan.n_slots), dtype=torch.float64, device="cuda")
    seg = plan.seg_sorted.long()
    library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
    del ent, out
    P = plan.perm.numel()
    nbytes = (sum(k.numel() for k in kd) * 8 + P * 4
              + (plan.n_slots + 1) * 4 + 9 * plan.n_slots * 8)
    bound_ms, bound_by = bound(nbytes, 9 * P, torch.float64)
    log(f"phase k1_m60_time: {kd[0].shape[0]} hex20 + {kd[-1].shape[0]} "
        f"spring blocks, P={P} pairs, n_slots={plan.n_slots} float64: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, index_add_ "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({nbytes / 1e9:.3f} GB)")
    setup = mods["static"].cluster_setup(model, {})
    errs = check_path_planes(mods, model, setup.amaps,
                             torch.Generator("cuda").manual_seed(8))
    m = ex.mpc_arrays(model.mesh, 3, model.n_dof_total, "cuda")
    y = torch.randn(model.n_dof_total, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(9))
    a, b = ex.mpc_Tt(m, y), ex.mpc_Tt(m, y)
    mc = ex.mpc_arrays(model.mesh, 3, model.n_dof_total, "cpu")
    want = ex.mpc_Tt(mc, y.cpu())
    e_tt = float((a.cpu() - want).abs().max())
    log(f"  MPC reduction T^T through the planes entry "
        f"({m.add.targets.numel()} "
        f"master slots, {m.src_k.numel()} terms): bit-equal relaunch "
        f"{torch.equal(a, b)}, against the CPU plain version "
        f"max_abs_err={e_tt!r}")
    if not (torch.equal(a, b) and e_tt <= F64_TOL * float(want.abs().max())):
        raise AssertionError("the MPC reduction does not repeat or "
                             "disagrees with its plain version")
    return {"name": "segsum_m60", "entry": "element, m = 60 (hex20_mpc)",
            "route": "cuda", "source": "frontistr_tpu_torch/csrc/segsum.cu",
            "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "planes_max_abs_err": max(errs.values()),
            "mpc_reduction_max_abs_err": e_tt}


def phase_direct(args, mods) -> dict:
    """METHOD=DIRECT on a shuffled box_hex8(d) (default 20: 27,783 dofs),
    STATIC and NLSTATIC (one substep) through run_directory on the card: the element
    matrices on the card, one host SuperLU factor a solve (the JAX
    package's semantics).  Logged: the factor and the back-substitution
    seconds.  u held to the CG path's answer (f64 policy, RESID 1e-12)
    within 1e-8 of max|u|.  Then one torch.linalg.cholesky of the dense
    constrained K at that size, timed as a yardstick only."""
    direct = mods["direct"]
    d = args.direct_n
    mesh = mods["box_hex8"](d, d, d)
    out = {}
    for sol in ("STATIC", "NLSTATIC"):
        runs = {}
        for method, resid in (("DIRECT", "1.0e-8"), ("CG", "1.0e-12")):
            cnt = EXTRA_CNT.format(sol=sol, head="", bc="",
                                   loads="!CLOAD\n X1, 3, -1.0\n",
                                   method=method, opt="", resid=resid
                                   ).replace("SUBSTEPS=2", "SUBSTEPS=1")
            wd = os.path.join(ROOT, "build", "smoke", "direct",
                              f"{sol}_{method}")
            write_shuffled(wd, mods, mesh, cnt)
            secs = {"factor": 0.0, "n": 0}
            real = direct.factor

            def timed(A, real=real):
                t0 = time.perf_counter()
                lu = real(A)
                secs["factor"] += time.perf_counter() - t0
                secs["n"] += 1
                return lu
            direct.factor = timed
            try:
                t0 = time.perf_counter()
                o = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                             lambda: mods["run_directory"](wd,
                                                           device="cuda"))
                wall = time.perf_counter() - t0
            finally:
                direct.factor = real
            runs[method] = (o, wall, secs)
        (od, wall, secs), (oc, wall_cg, _) = runs["DIRECT"], runs["CG"]
        u, uc = od["static"].u, oc["static"].u
        rel = rel_diff(u, uc)
        solve_s = od["static"].timings.get("solve", 0.0)
        log(f"phase direct: {sol} box_hex8({d}) {3 * mesh.n_node} dofs: "
            f"{wall:.2f} s ({secs['n']} factors {secs['factor']:.3f} s, "
            f"solve phase {solve_s:.3f} s, so back-substitution and "
            f"assembly {solve_s - secs['factor']:.3f} s); the CG path "
            f"{wall_cg:.2f} s; u against CG max rel diff {rel!r}")
        if not (secs["n"] >= 1 and rel <= 1e-8 and np.isfinite(u).all()):
            raise AssertionError(f"direct: {sol} disagrees with the CG path")
        out[sol] = {"wall_s": wall, "factors": secs["n"],
                    "factor_s": secs["factor"], "rel_to_cg": rel}
    # the yardstick: one dense Cholesky of the constrained K
    model = od["model"]
    kes = mods["static"].compute_element_stiffness(model)
    n = model.n_dof_total
    A = torch.zeros((n, n), dtype=torch.float64, device="cuda")
    for b, ke in zip(model.blocks, kes):
        dd = torch.as_tensor(b.dofs, dtype=torch.int64, device="cuda")
        A.index_put_((dd[:, :, None].expand(-1, -1, dd.shape[1]),
                      dd[:, None, :].expand(-1, dd.shape[1], -1)), ke,
                     accumulate=True)
    free = torch.ones(n, dtype=torch.float64, device="cuda")
    free[torch.as_tensor(model.fixed_dofs, device="cuda")] = 0.0
    A = A * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    chol_ms = cuda_ms(lambda: torch.linalg.cholesky(A), reps=2, warmup=1)
    log(f"  torch.linalg.cholesky of the dense constrained K ({n} x {n}, "
        f"{n * n * 8 / 1e9:.3f} GB): {chol_ms:.3f} ms (a yardstick, not "
        f"a path)")
    del A
    torch.cuda.empty_cache()
    out["cholesky_ms"] = chol_ms
    return out


EXTRA_CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n{head}!BOUNDARY\n"
             " X0, 1, 3, 0.0\n{bc}{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
             " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n!STEP, SUBSTEPS=2\n"
             " BOUNDARY, 1\n LOAD, 1\n!SOLVER, METHOD={method}, ITERLOG=NO, "
             "TIMELOG=NO{opt}\n 10000, 1\n {resid}, 1.0, 0.0\n!END\n")


def phase_extras_small_reference(mods) -> None:
    """Small decks through run_directory on the card and on the CPU
    (which the CPU tests hold to the JAX package): the prisms 351/352
    and hex20 362 in STATIC, NLSTATIC, implicit DYNAMIC, EIGEN and HEAT;
    !EQUATION (an X1 face tied in z) with a !SPRING in STATIC and
    NLSTATIC, !EQUATION in DYNAMIC, EIGEN and HEAT; ROT_CENTER
    (rotational !BOUNDARY under NLSTATIC, a torque !CLOAD); METHOD=DIRECT
    in each family; ESTCOND.  Fields within 1e-8 of the largest
    (temperatures and eigenvalues 1e-10), Newton, Lanczos and
    fixed-point counts equal, CG within one a solve."""
    run = mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "extras_small")
    dyn = ("!DYNAMIC\n 1, 1\n 0.0, 4.0e-6, 4, 1.0e-6\n 0.5, 0.25\n"
           " 1, 1, 1000.0, 1.0e-9\n 10, 0, 1\n")
    eig = "!EIGEN\n 3, 1.0e-8, 60\n"

    def deck(sol, head="", bc="", loads="!CLOAD\n X1, 3, -50.0\n",
             method="CG", opt="", resid="1.0e-10"):
        return EXTRA_CNT.format(sol=sol, head=head, bc=bc, loads=loads,
                                method=method, opt=opt, resid=resid)

    def center(mesh, side):
        c = mesh.coords
        x = c[:, 0].max() if side == "X1" else c[:, 0].min()
        mesh.node_groups["CEN"] = np.asarray([np.argmin(np.linalg.norm(
            c - [x, c[:, 1].mean(), c[:, 2].mean()], axis=1))], np.int64)
        return mesh

    def compare(label, make, kind, env=None):
        outs = []
        for d in ("cuda", "cpu"):
            wd = os.path.join(base, label.replace(" ", "_"), d)
            outs.append(with_env(env or {"FRONTISTR_TPU_PRECISION": "f64"},
                                 lambda: run(make(wd), device=d)))
        g, c = outs
        if kind == "static":
            a, b = g["static"], c["static"]
            rel = rel_diff(a.u, b.u)
            cnt = ([h["iter"] for h in a.newton.history],
                   [h["iter"] for h in b.newton.history]) \
                if a.newton is not None else (a.iters, b.iters)
            ok = rel <= 1e-8 and (cnt[0] == cnt[1] if a.newton is not None
                                  else abs(a.iters - b.iters) <= 1)
        elif kind == "dynamic":
            a, b = g["dynamic"], c["dynamic"]
            rel = max(rel_diff(getattr(a, f), getattr(b, f))
                      for f in ("u", "vel", "acc"))
            cnt = ([len(h["cg"]) for h in a.history],
                   [len(h["cg"]) for h in b.history])
            ok = rel <= 1e-8 and cnt[0] == cnt[1]
        elif kind == "eigen":
            a, b = g["eigen"], c["eigen"]
            rel = rel_diff(a.eigenvalues, b.eigenvalues)
            cnt = (a.iters, b.iters)
            ok = rel <= 1e-10 and cnt[0] == cnt[1]
        else:
            a, b = g["heat"], c["heat"]
            rel = rel_diff(a.T, b.T)
            cnt = ([r["fp"] for r in a.history], [r["fp"] for r in b.history])
            ok = rel <= 1e-10 and cnt[0] == cnt[1]
        log(f"phase extras_small_reference: {label}, cuda vs cpu max rel "
            f"diff {rel!r}, counts {cnt[0]} vs {cnt[1]}")
        if not ok:
            raise AssertionError(f"extras_small_reference: {label}")

    def shuffled(mesh, cnt, ngroups=("X0", "X1")):
        return lambda wd: write_shuffled(wd, mods, mesh, cnt,
                                         ngroups=ngroups)

    for et in (351, 352, 362):
        dims = (3, 2, 2) if et != 362 else (2, 2, 1)
        m = solid_mesh(mods, et, dims)
        compare(f"{et} STATIC", shuffled(m, deck("STATIC")), "static")
        compare(f"{et} NLSTATIC", shuffled(m, deck("NLSTATIC",
                loads="!CLOAD\n X1, 3, -300.0\n")), "static")
        compare(f"{et} DYNAMIC", shuffled(m, deck("DYNAMIC", head=dyn,
                loads="!CLOAD\n X1, 3, -1.0\n")), "dynamic")
        big = solid_mesh(mods, et, (3, 2, 1), lx=300.0, ly=200.0, lz=100.0)
        compare(f"{et} EIGEN", shuffled(big, deck("EIGEN", head=eig)),
                "eigen")
        compare(f"{et} HEAT", lambda wd, et=et: small_heat_deck(
            mods, et, True, wd), "heat")
    # !EQUATION and !SPRING
    for et, sol in ((341, "STATIC"), (362, "STATIC"), (341, "NLSTATIC")):
        m = solid_mesh(mods, et, (3, 2, 2) if et != 362 else (2, 2, 1))
        mid = int(m.node_ids[tie_face(mods, m)])
        compare(f"MPC spring {et} {sol}", shuffled(m, deck(
            sol, loads=f"!CLOAD\n {mid}, 3, -20.0\n!SPRING\n {mid}, 3, "
            "50.0\n")), "static")
    m = solid_mesh(mods, 361, (3, 2, 2))
    mid = int(m.node_ids[tie_face(mods, m)])
    compare("MPC DYNAMIC", shuffled(m, deck("DYNAMIC", head=dyn,
            loads=f"!CLOAD\n {mid}, 3, -5.0\n")), "dynamic")
    m = solid_mesh(mods, 361, (4, 2, 2), lx=400.0, ly=100.0, lz=100.0)
    tie_face(mods, m)
    compare("MPC EIGEN", shuffled(m, deck("EIGEN", head=eig, loads="")),
            "eigen")

    def heat_tied(wd):
        hm = small_heat_mesh(mods, "hex8")
        tie_face(mods, hm, dof=1)
        return small_heat_deck(mods, "hex8", True, wd, mesh=hm)
    compare("MPC HEAT", heat_tied, "heat")
    # ROT_CENTER
    m = center(solid_mesh(mods, 361, (3, 2, 2)), "X1")
    compare("ROT_CENTER boundary NLSTATIC", shuffled(m, deck(
        "NLSTATIC", bc="!BOUNDARY, ROT_CENTER=CEN\n X1, 1, 1, 0.2\n",
        loads=""), ("X0", "X1", "CEN")), "static")
    m = center(solid_mesh(mods, 361, (3, 2, 2)), "X0")
    compare("ROT_CENTER torque STATIC", shuffled(m, deck(
        "STATIC", loads="!CLOAD, ROT_CENTER=CEN\n X1, 3, 7.0\n"),
        ("X0", "X1", "CEN")), "static")
    # METHOD=DIRECT in each family, ESTCOND
    m = solid_mesh(mods, 342, (3, 2, 2))
    for sol in ("STATIC", "NLSTATIC"):
        compare(f"DIRECT {sol}", shuffled(m, deck(
            sol, method="DIRECT", loads="!CLOAD\n X1, 3, -300.0\n")),
            "static")
    m = solid_mesh(mods, 361, (3, 2, 2))
    compare("DIRECT DYNAMIC", shuffled(m, deck("DYNAMIC", head=dyn,
            method="DIRECT", loads="!CLOAD\n X1, 3, -1.0\n")), "dynamic")
    m = solid_mesh(mods, 361, (4, 2, 2), lx=400.0, ly=100.0, lz=100.0)
    compare("DIRECT EIGEN", shuffled(m, deck("EIGEN", head=eig, loads="",
                                             method="DIRECT")), "eigen")
    compare("DIRECT HEAT", lambda wd: small_heat_deck(
        mods, "hex8", True, wd, method="DIRECT"), "heat")
    compare("ESTCOND STATIC", shuffled(solid_mesh(mods, 341, (3, 2, 2)),
                                       deck("STATIC", opt=", ESTCOND=1")),
            "static")
    # DUMPTYPE=MM (set on the deck's solver record: no .cnt parser of
    # either package reads it): the files of the two devices
    dumps = []
    for d in ("cuda", "cpu"):
        wd = os.path.join(base, "dump", d)
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(deck("STATIC").replace("!SOLVER", "!SPRING\n 1, 2, "
                                            "40.0\n!SOLVER"))
        cfg = mods["read_cnt"](os.path.join(wd, "case.cnt"))
        cfg.solver.dumptype = "MM"
        model = mods["build_struct_model"](
            solid_mesh(mods, 341, (2, 2, 2)), cfg, device=d)
        cwd = os.getcwd()
        os.chdir(wd)
        try:
            mods["static"].solve_linear(
                model, mods["static"].compute_element_stiffness(model))
        finally:
            os.chdir(cwd)
        name, = [f for f in os.listdir(wd) if f.startswith("dump_matrix")]
        with open(os.path.join(wd, name)) as fh:
            dumps.append(fh.read().splitlines())
    vals = [np.asarray([float(ln.split()[2]) for ln in dd[2:]])
            for dd in dumps]
    same = [[ln.split()[:2] for ln in dd] for dd in dumps]
    rel = rel_diff(*vals) if same[0] == same[1] else float("inf")
    log(f"phase extras_small_reference: DUMPTYPE=MM tet4 with a spring, "
        f"{len(vals[0])} entries, cuda vs cpu max rel diff {rel!r}, "
        f"byte-equal {dumps[0] == dumps[1]}")
    if not rel <= 1e-12:
        raise AssertionError("extras_small_reference: DUMPTYPE")


# ---- PR: the 2-D solids through K1's nd = 2 entry, the other materials ----
PLANECNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n"
            " X0, 1, 2, 0.0\n!CLOAD\n X1, 2, -1.0\n!MATERIAL, NAME=M1\n"
            "!ELASTIC\n 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n"
            " LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n"
            " 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


def phase_plane_main_path(args, mods) -> dict:
    """The plane cell through run_directory: NLSTATIC (total Lagrange) in
    the f64 policy on a shuffled plane-strain quad8 (242) box of n x n
    (default 300: 271,201 nodes, 542,402 dofs, 90,000 elements; 408
    gives 1,002,050 dofs),
    section thickness 1, X0 fixed, X1 loaded -1 in y per node, the AMG
    at nd = 2 (three rigid modes).  Per Newton iteration rres/rxnrm, CG,
    an independent index_add_ true relres (<= 1e-8); the phase split, ms
    a CG iteration and the peak memory; K1 element launches (the nd = 2
    entry) = Newton iterations, planes launches = 2 per AMG setup + 1
    per nodal smoothing.  The first solve is repeated: the same CG count
    and a bit-equal answer.  Returns the counts, the model and the first
    tangent."""
    nl = mods["nonlinear"]
    n = args.plane_n
    wd = os.path.join(ROOT, "build", "smoke", f"plane{n}")
    t0 = time.perf_counter()
    mesh = mods["meshgen"].box_plane(n, n, etype=242, thick=1.0, opt=1)
    write_shuffled(wd, mods, mesh, PLANECNT)
    log(f"phase plane_workdir: quad8 box of {n} x {n} shuffled, "
        f"{mesh.n_node} nodes, {2 * mesh.n_node} dofs, "
        f"{len(mesh.blocks[0].elem_ids)} elements of type 242, plane "
        f"strain, written in {time.perf_counter() - t0:.2f} s")
    del mesh
    solves, first, calls = [], {}, {}
    real = nl.make_constrained_solver
    nl.make_constrained_solver = keep_first_solver(nl, solves, first)
    restore = counting(mods, calls)
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: mods["run_directory"](wd, device="cuda"))
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver = real
        restore()
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model = out["static"], out["model"]
    nw, tm = res.newton, res.timings
    cg = [sv["cg_iters"] for sv in solves]
    ms_cg = 1e3 * tm.get("solve", 0.0) / max(sum(cg), 1)
    keys = ("tangent", "assembly", "amg_setup", "solve", "update")
    log(f"phase plane_main_path: {wall:.2f} s; policy={res.policy} "
        f"newton_iters={nw.total_iters} cutbacks={nw.cutbacks} "
        f"cg_iters={cg} ({ms_cg:.3f} ms a CG iteration) K1 launches="
        f"{launches['K1']} (element, nd = 2), K1 planes launches="
        f"{launches['K1 planes']} ({calls['setup_amg']} AMG setups "
        f"x {PLANES_PER_AMG_SETUP} + {calls['smooth']} nodal "
        f"smoothings), peak device memory {peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(
        f"{k}={tm.get(k, 0.0):.3f}" for k in
        ("read", "reorder", "model", "profile") + keys + ("post",)))
    for h, sv in zip(nw.history, solves):
        log(f"  step {h['step']} substep {h['substep']} it {h['iter']}: "
            f"rres={h['rres']!r} rxnrm={h['rxnrm']!r} "
            f"cg_iters={sv['cg_iters']} relres={sv['relres']!r} "
            f"true_relres={sv['true_relres']!r}; "
            + " ".join(f"{k}={h[k]:.3f}" for k in keys))
    if len(solves) != len(nw.history) or not solves:
        raise AssertionError("plane_main_path: solves and iterations do "
                             "not pair up")
    last = nw.history[-1]
    if res.policy != "f64" or nw.cutbacks or \
            min(last["rres"], last["rxnrm"]) >= 1e-6:
        raise AssertionError("plane_main_path: Newton did not converge "
                             "without cutbacks in the f64 policy")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    if not (model.dim == 2 and res.u.shape == (model.n_node, 2)
            and np.isfinite(res.u).all() and res.u[:, 1].min() < 0):
        raise AssertionError("plane_main_path: displacements not finite, "
                             "of the wrong shape or not downwards")
    if launches["K1"] != nw.total_iters:
        raise AssertionError(f"K1 launches {launches['K1']} != Newton "
                             f"iterations {nw.total_iters}")
    if calls["setup_amg"] < 1 or launches["K1 planes"] != \
            PLANES_PER_AMG_SETUP * calls["setup_amg"] + calls["smooth"]:
        raise AssertionError(f"K1 planes launches {launches['K1 planes']} "
                             f"do not add up: {calls}")
    repeat_first(first, "plane_main_path")
    return {"launches": launches["K1"], "planes_launches":
            launches["K1 planes"], "newton_iters": nw.total_iters,
            "cg_iters": cg, "ms_per_cg_iter": ms_cg, "wall_s": wall,
            "peak_gb": peak_gb,
            "phase_s": {k: tm.get(k, 0.0) for k in
                        ("read", "reorder", "model", "profile") + keys
                        + ("post",)},
            "model": model, "kes": first["kes"]}


def phase_k1_nd2_time(mods, model, kes, cell) -> list:
    """K1's nd = 2 element entry on the plane cell's cluster profile
    (m = 16) with its first tangent, float64: held to its plain version,
    timed with it and with one index_add_ of the entries in slot order,
    against its bytes bound.  Then the planes entry at the cell's 2-D
    AMG level-1 and level-2 plans and nodal smoothing (held to the plain
    version), timed at the level-1 shapes.  Returns two kernels-line
    rows."""
    sm, bell = mods["segsum"], mods["bell"]
    plan = bell.cluster_profile_from_model(model).plan("cuda")
    kd = [k.contiguous() for k in kes]
    nns = [b.conn.shape[1] for b in model.blocks]
    err = check_k1(sm, plan, kd, nns, torch.float64,
                   "plane quad8 first tangent m = 16", nd=2)
    check_k1(sm, plan, kd, nns, torch.float32,
             "plane quad8 first tangent m = 16", nd=2)
    ms = cuda_ms(lambda: sm.segsum(plan, kd, nns, 2))
    plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, nns, 2))
    ent = sm.entry_planes(kd, nns, 2)[:, plan.perm.long()]
    out = torch.zeros((4, plan.n_slots), dtype=torch.float64, device="cuda")
    seg = plan.seg_sorted.long()
    library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
    del ent, out
    P = plan.perm.numel()
    nbytes = (sum(k.numel() for k in kd) * 8 + P * 4
              + (plan.n_slots + 1) * 4 + 4 * plan.n_slots * 8)
    bound_ms, bound_by = bound(nbytes, 4 * P, torch.float64)
    log(f"phase k1_nd2_time: {kd[0].shape[0]} quad8 elements, P={P} "
        f"pairs, n_slots={plan.n_slots} float64: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB)")
    setup = mods["static"].cluster_setup(model, {})
    if setup.amaps is None or setup.amaps.nd != 2:
        raise AssertionError("k1_nd2_time: the plane deck takes no 2-D AMG")
    errs = check_path_planes(mods, model, setup.amaps,
                             torch.Generator("cuda").manual_seed(12))
    plan1, _ = setup.amaps.plans("cuda")
    V = setup.amaps.nv ** 2
    vals = torch.randn((V, plan1.perm.numel()), dtype=torch.float64,
                       device="cuda",
                       generator=torch.Generator("cuda").manual_seed(13))
    p_ms = cuda_ms(lambda: sm.segsum_planes(vals, plan1))
    p_plain = cuda_ms(lambda: sm.segsum_planes_reference(vals, plan1))
    p_out = torch.zeros((V, plan1.n_slots), dtype=torch.float64,
                        device="cuda")
    g_vals, g_seg = vals[:, plan1.perm.long()], plan1.seg_sorted.long()
    p_lib = cuda_ms(lambda: p_out.index_add_(1, g_seg, g_vals))
    R = plan1.perm.numel()
    p_bytes = V * R * 8 + R * 4 + (plan1.n_slots + 1) * 4 + \
        V * plan1.n_slots * 8
    p_bound, p_by = bound(p_bytes, V * R, torch.float64)
    log(f"  planes entry at the 2-D AMG level 1: V={V}, R={R}, "
        f"n_slots={plan1.n_slots}: kernel {p_ms:.3f} ms, plain "
        f"{p_plain:.3f} ms, index_add_ {p_lib:.3f} ms, bound "
        f"{p_bound:.3f} ms")
    common = {"route": "cuda", "source": "frontistr_tpu_torch/csrc/segsum.cu",
              "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121"}
    return [dict(common, name="segsum_nd2",
                 entry="element, nd = 2, m = 16 (plane quad8)",
                 launches=cell["launches"], max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms,
                 plane_main_path={k: v for k, v in cell.items()
                                  if k not in ("model", "kes")}),
            dict(common, name="segsum_planes_nd2",
                 entry="planes, the 2-D AMG (nv = 3) and nodal smoothing",
                 launches=cell["planes_launches"],
                 max_abs_err=max(errs.values()), ms=p_ms,
                 plain_ms=p_plain, bound_ms=p_bound, bound_by=p_by,
                 library_ms=p_lib)]


HYPER_LAW = "!HYPERELASTIC, TYPE=NEOHOOKE\n 1.0, 1.0\n"


def phase_hyper_main_path(args, mods) -> dict:
    """The hex20_mpc deck (``phase_hex20_mpc_main_path``) on a shuffled
    hex20 box of n (default 20: 35,721 nodes, 107,163 dofs) at its
    specified total load, -(X1's node count on the box of 44) = -5,985
    at the master, with !HYPERELASTIC, TYPE=NEOHOOKE (the (E, nu) law
    of ``fem/hyper.py``, S and D by torch.func per gauss point) in
    ``--hyper-substeps`` substeps, f64 policy.  Logged: Newton
    iterations per substep, cutbacks, the smallest principal stretch
    over the integration points after every substep, the wall.  Checks:
    Newton converges, every solve's true relres <= 1e-8, the tie within
    1e-10 max|u|, K1 element launches = Newton iterations."""
    nl = mods["nonlinear"]
    from frontistr_tpu_torch.microbench.hex20_load import (CELL_LOAD,
                                                           stretches)
    n = args.hyper_n
    wd = os.path.join(ROOT, "build", "smoke", f"hyper{n}")
    mesh = hex20_mesh(mods, (n, n, n))
    x1 = mesh.node_groups["X1"]
    mid = x1[np.argmin(np.linalg.norm(mesh.coords[x1] - [1.0, 0.5, 0.5],
                                      axis=1))]
    mast = tie_face(mods, mesh, master=mid)
    cnt = MPCCNT.format(mast=int(mesh.node_ids[mast]), load=-CELL_LOAD,
                        k=210.0, method="CG", resid="1.0e-8").replace(
        "!STEP, SUBSTEPS=1\n",
        HYPER_LAW + f"!STEP, SUBSTEPS={args.hyper_substeps}\n")
    write_shuffled(wd, mods, mesh, cnt)
    log(f"phase hyper_workdir: hex20 box of {n} shuffled, {mesh.n_node} "
        f"nodes, {3 * mesh.n_node} dofs, NEOHOOKE, total load "
        f"{-CELL_LOAD!r} at the master, {args.hyper_substeps} substeps")
    del mesh
    solves, subs = [], []
    real_solver, real_sub = nl.make_constrained_solver, nl._newton_substep
    nl.make_constrained_solver = spy_solves(nl, solves)

    def substep(model, programs, states, u, *a, **kw):
        out = real_sub(model, programs, states, u, *a, **kw)
        lo, hi = stretches(model, u + out[1])
        subs.append(dict(tag=kw.get("tag"), converged=out[0],
                         iters=out[3], stretch_min=lo, stretch_max=hi))
        log(f"  substep {kw.get('tag')}: converged={out[0]} "
            f"iterations={out[3]} stretch min={lo!r} max={hi!r}")
        return out
    nl._newton_substep = substep
    calls = {}
    restore = counting(mods, calls)
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: mods["run_directory"](wd, device="cuda"))
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver, nl._newton_substep = real_solver, \
            real_sub
        restore()
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model = out["static"], out["model"]
    nw = res.newton
    u = res.u
    eqs = model.mesh.equations
    dep = np.asarray([int(e.nodes[0]) for e in eqs])
    mst = np.asarray([int(e.nodes[1]) for e in eqs])
    tie = float(np.abs(u[dep, 2] - u[mst, 2]).max())
    log(f"phase hyper_main_path: {wall:.2f} s; newton_iters="
        f"{nw.total_iters} cutbacks={nw.cutbacks} cg_iters="
        f"{[s['cg_iters'] for s in solves]} K1 launches={launches['K1']}, "
        f"K1 planes launches={launches['K1 planes']} ({calls['setup_amg']} "
        f"AMG setups x {PLANES_PER_AMG_SETUP} + {calls['smooth']} nodal "
        f"smoothings + {calls['mpc_Tt']} reductions T^T); smallest "
        f"stretch {min(s['stretch_min'] for s in subs)!r}; "
        f"u_z at the master {float(u[mst[0], 2])!r}; tie {tie!r}; peak "
        f"device memory {peak_gb:.3f} GB; tangent "
        f"{res.timings.get('tangent', 0.0):.3f} s, update "
        f"{res.timings.get('update', 0.0):.3f} s")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    if not (np.isfinite(u).all() and tie <= 1e-10 * np.abs(u).max()):
        raise AssertionError("hyper_main_path: displacements not finite "
                             "or the tie does not hold")
    if launches["K1"] != nw.total_iters:
        raise AssertionError(f"K1 launches {launches['K1']} != Newton "
                             f"iterations {nw.total_iters}")
    if launches["K1 planes"] != PLANES_PER_AMG_SETUP * calls["setup_amg"] \
            + calls["smooth"] + calls["mpc_Tt"]:
        raise AssertionError(f"K1 planes launches {launches['K1 planes']} "
                             f"do not add up: {calls}")
    return {"newton_iters": nw.total_iters, "cutbacks": nw.cutbacks,
            "substeps": [{k: v for k, v in s.items() if k != "tag"}
                         for s in subs],
            "wall_s": wall, "peak_gb": peak_gb, "launches": launches["K1"],
            "planes_launches": launches["K1 planes"]}


MAT_CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n{head}!BOUNDARY\n"
           " X0, 1, 3, 0.0\n{bc}{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
           " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n{mat}{step}"
           "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
           " 1.0e-10, 1.0, 0.0\n!END\n")
STEP2 = "!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n"
VISCO_STEP = ("!STEP, TYPE=VISCO, SUBSTEPS=4, CONVERG=1.0e-8\n 0.25, 1.0\n"
              " BOUNDARY, 1\n LOAD, 1\n")


def _register_umat(mods):
    """Isotropic elasticity scaled by the card's constant, as a umat of
    the port's registry (``frontistr_tpu_torch.user``)."""
    from frontistr_tpu_torch import user
    E_, nu = 210000.0, 0.3
    lam = E_ * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E_ / (2 * (1 + nu))
    D6 = np.zeros((6, 6))
    D6[:3, :3] = lam
    D6[np.arange(3), np.arange(3)] += 2 * mu
    D6[np.arange(3, 6), np.arange(3, 6)] = mu

    @user.register_umat("M1")
    def umat(matl, strain, stress, fstat, dtime, ttime):
        D = torch.as_tensor(D6, dtype=strain.dtype,
                            device=strain.device) * matl[0]
        return (D.expand(strain.shape + (6,)),
                torch.einsum("kl,...l->...k", D, strain), fstat + 1.0)
    return user


def phase_materials_small_reference(mods) -> None:
    """Small decks through run_directory on the card and on the CPU
    (which the CPU tests hold to the JAX package): each 2-D type x
    sect_opt in NLSTATIC; MOONEY-RIVLIN and ARRUDA-BOYCE; viscoelastic
    with !TRS under a temperature field; Norton creep; orthotropic in an
    !ORIENTATION frame; temperature-dependent !ELASTIC; a !USER_MATERIAL
    through a registered umat; implicit DYNAMIC and EIGEN on a 2-D mesh.
    Fields within 1e-8 of the largest (eigenvalues 1e-10), Newton and
    Lanczos counts equal."""
    run = mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "materials_small")
    box_plane = mods["meshgen"].box_plane

    def deck(sol="NLSTATIC", head="", bc="", loads="!CLOAD\n X1, 3, -300.0\n",
             mat="", step=STEP2):
        return MAT_CNT.format(sol=sol, head=head, bc=bc, loads=loads,
                              mat=mat, step=step)

    def compare(label, mesh, cnt, kind="static"):
        outs = []
        for d in ("cuda", "cpu"):
            wd = os.path.join(base, label.replace(" ", "_"), d)
            write_shuffled(wd, mods, mesh, cnt)
            outs.append(with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                                 lambda: run(wd, device=d)))
        g, c = outs
        if kind == "static":
            a, b = g["static"], c["static"]
            rel = rel_diff(a.u, b.u)
            cnt_ = ([h["iter"] for h in a.newton.history],
                    [h["iter"] for h in b.newton.history])
        elif kind == "dynamic":
            a, b = g["dynamic"], c["dynamic"]
            rel = max(rel_diff(getattr(a, f), getattr(b, f))
                      for f in ("u", "vel", "acc"))
            cnt_ = ([len(h["cg"]) for h in a.history],
                    [len(h["cg"]) for h in b.history])
        else:
            a, b = g["eigen"], c["eigen"]
            rel = rel_diff(a.eigenvalues, b.eigenvalues)
            cnt_ = (a.iters, b.iters)
        log(f"phase materials_small_reference: {label}, cuda vs cpu max "
            f"rel diff {rel!r}, counts {cnt_[0]} vs {cnt_[1]}")
        if not (rel <= (1e-10 if kind == "eigen" else 1e-8)
                and cnt_[0] == cnt_[1]):
            raise AssertionError(f"materials_small_reference: {label}")

    plane_loads = "!CLOAD\n X1, 2, -300.0\n"
    for et in (231, 232, 241, 242):
        for opt in (0, 1, 2):
            compare(f"{et} sect_opt {opt} NLSTATIC",
                    box_plane(4, 2, lx=2.0, etype=et, thick=0.5, opt=opt),
                    deck(loads=plane_loads))
    hexm = mods["box_hex8"](3, 2, 2)
    compare("MOONEY-RIVLIN", hexm, deck(
        mat="!HYPERELASTIC, TYPE=MOONEY-RIVLIN\n 40000.0, 5000.0, 1.2e-5\n"))
    compare("ARRUDA-BOYCE", hexm, deck(
        mat="!HYPERELASTIC, TYPE=ARRUDA-BOYCE\n 80000.0, 2.5, 1.2e-5\n"))
    compare("VISCOELASTIC TRS", hexm, deck(
        bc=" X1, 1, 1, 0.002\n", loads="!TEMPERATURE\n ALL, 35.0\n"
        " X1, 50.0\n", step=VISCO_STEP,
        mat="!VISCOELASTIC\n 0.3, 0.5\n 0.3, 2.0\n!TRS, DEFINITION=WLF\n"
        " 20.0, 8.86, 101.6\n"))
    compare("CREEP", hexm, deck(loads="!CLOAD\n X1, 1, 400.0\n",
                                step=VISCO_STEP,
                                mat="!CREEP, TYPE=NORTON\n 1.0e-12, 3.0, "
                                    "0.0\n"))
    compare("ORTHOTROPIC ORIENTATION", hexm, deck(
        mat="!ELASTIC, TYPE=ORTHOTROPIC\n 200000., 100000., 50000., 0.3, "
            "0.2, 0.25, 40000., 30000., 20000.\n!SECTION, SECNUM=1, "
            "ORIENTATION=OR1\n!ORIENTATION, NAME=OR1, DEFINITION="
            "COORDINATES\n 0.6, 0.8, 0.0, -0.8, 0.6, 0.5, 0.0, 0.0, 0.0\n"))
    compare("ELASTIC(T)", hexm, deck(
        head="!REFTEMP\n 0.0\n", loads="!CLOAD\n X1, 3, -300.0\n"
        "!TEMPERATURE\n ALL, 50.0\n X1, 250.0\n",
        mat="!ELASTIC\n 210000.0, 0.30, 0.0\n 150000.0, 0.28, 100.0\n"
            " 90000.0, 0.25, 300.0\n!EXPANSION_COEFF\n 1.2e-5\n"))
    user = _register_umat(mods)
    try:
        compare("USER_MATERIAL", hexm, deck(
            mat="!USER_MATERIAL, NSTATUS=1, INFINITE\n 1.5\n"))
    finally:
        user.clear()
    dyn = ("!DYNAMIC\n 1, 1\n 0.0, 4.0e-6, 4, 1.0e-6\n 0.5, 0.25\n"
           " 1, 1, 1000.0, 1.0e-9\n 10, 0, 1\n")
    compare("242 DYNAMIC", box_plane(4, 2, lx=2.0, etype=242, thick=0.5,
                                     opt=1),
            deck("DYNAMIC", head=dyn, loads="!CLOAD\n X1, 2, -1.0\n"),
            "dynamic")
    compare("232 EIGEN", box_plane(4, 2, lx=300.0, ly=100.0, etype=232,
                                   thick=10.0),
            deck("EIGEN", head="!EIGEN\n 3, 1.0e-8, 60\n", loads=""),
            "eigen")


# ---- PR: node-to-surface contact -------------------------------------------
# the flat punch: SLAGRANGE (FrontISTR's default algorithm), frictionless,
# NLSTATIC in two substeps; BOT held in z, X0 and Y0 symmetry planes, the
# punch's top pushed 1e-3 down
CONTACTCNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY, GRPID=1\n"
              "{bc}{loads}!CONTACT_ALGO, TYPE={algo}\n!CONTACT, GRPID=1\n"
              " CP1, {mu}\n!STEP, SUBSTEPS={sub}, CONVERG={conv}\n"
              " BOUNDARY, 1\n LOAD, 1\n CONTACT, 1\n!MATERIAL, NAME=M1\n"
              "!ELASTIC\n {E}, {nu}\n!DENSITY\n 1.0\n!SOLVER, METHOD={method},"
              " PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
              " {resid}, 1.0, 0.0\n!END\n")
PUNCH_BC = (" BOT, 3, 3, 0.0\n X0, 1, 1, 0.0\n Y0, 2, 2, 0.0\n"
            " TOP, 3, 3, {uz}\n")
CONTACT_GROUPS = ("ALL", "LOW", "BOT", "TOP", "SLAVE", "X0", "Y0")


def contact_cnt(algo="SLAGRANGE", sol="NLSTATIC", bc=None, loads="",
                mu="0.0", sub=2, conv="1.0e-6", method="CG",
                resid="1.0e-8", E="210000.0", nu="0.3", uz="-1.0e-3"):
    return CONTACTCNT.format(
        sol=sol, bc=bc if bc is not None else PUNCH_BC.format(uz=uz),
        loads=loads, algo=algo, mu=mu, sub=sub, conv=conv, E=E, nu=nu,
        method=method, resid=resid)


def punch_mesh(mods, n: int):
    """The flat punch of ``n`` (default 56): the lower (master) box of n x
    n x n/2 hex8 over 1 x 1 x 0.5, the upper (slave) box of m x m x m/2,
    m = 70 n / 72, over 0.9 x 0.9 x 0.45 standing on it; the meshes do
    not match."""
    m = n * 70 // 72
    return mods["meshgen"].contact_pair(
        (n, n, n // 2), (m, m, m // 2), (1.0, 1.0, 0.5), (0.9, 0.9, 0.45))


def write_contact_workdir(path, mods, mesh, cnt, seed=3):
    """``cnt`` in ``path``, the mesh's nodes shuffled by ``seed`` (None:
    not), its contact pair, node groups and master surface."""
    if seed is not None:
        order = np.random.default_rng(seed).permutation(mesh.n_node)
        mesh = mods["ordering"].permute_mesh(mesh, order)
    mods["write_static_workdir"](
        path, mesh, cnt,
        ngroups=[g for g in CONTACT_GROUPS if g in mesh.node_groups],
        sgroups={"MAST": mesh.surf_groups["MAST"]})
    return str(path)


def contact_relres(model, kes, B, dinc, free, x, cn) -> float:
    """The true relres of a SLAGRANGE solve's eliminated system,
    ||T^T (b_c - A_c x)|| / ||T^T (b_c - A_c g)||: A_c = P K P + (I - P)
    with K applied by scattering the element matrices with index_add_,
    b_c = P (B - K d) + (I - P) d (d the Dirichlet increment), T^T by
    index_add_ from the slots' tables, g the slots' constants
    (independent of the FE operator and of K1)."""
    dev = B.device
    n = model.n_dof_total
    pairs = [(torch.as_tensor(b.dofs, dtype=torch.int64, device=dev), ke)
             for b, ke in zip(model.blocks, kes)]

    def K(v):
        y = torch.zeros(n, dtype=torch.float64, device=dev)
        for d, ke in pairs:
            y.index_add_(0, d.reshape(-1),
                         torch.einsum("eij,ej->ei", ke, v[d]).reshape(-1))
        return y

    def A_c(v):
        return K(v * free) * free + v * (1 - free)

    def Tt(y):
        add = cn.coef * (y[cn.dep] * cn.act)[:, None]
        return y.index_add(0, cn.mast.reshape(-1), add.reshape(-1)) * \
            cn.mask
    b_c = (B - K(dinc)) * free + dinc * (1 - free)
    return float(torch.linalg.norm(Tt(b_c - A_c(x))) /
                 torch.linalg.norm(Tt(b_c - A_c(cn.g0))))


def spy_contact(mods, solves: list, first: dict, state: dict):
    """Wrap the SLAGRANGE arm's factory (every solve logged with its CG
    count, seconds and an independent ``contact_relres``; the first
    solve's inputs, solver and answer kept in ``first``), the contact
    state's constructor (kept in ``state``), the eliminator's T^T and
    the nodal smoothing (counted in ``state``).  Returns the function
    that restores them."""
    cmod, nl, nodal = mods["contact"], mods["nonlinear"], mods["nodal"]
    elim_cls = mods["slag"].ContactEliminator
    real = (cmod.make_slag_contact_solver, nl.ContactState.make,
            elim_cls.Tt, nodal.smooth)
    state.update(Tt=0, smooth=0)

    def make_solver(model, free, gather, **kw):
        solve, elim = real[0](model, free, gather, **kw)

        def call(kes, B, dinc, cn, gfac=0.0):
            if not first:
                first.update(kes=kes, B=B, dinc=dinc, cn=cn, gfac=gfac,
                             solve=solve)
            t0 = time.perf_counter()
            x = solve(kes, B, dinc, cn, gfac)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rr = contact_relres(model, kes, B, dinc, free, x, cn)
            solves.append(dict(cg_iters=solve.last_iters,
                               relres=solve.last_relres, true_relres=rr,
                               s=sec, active=int(cn.act.sum())))
            log(f"  solve {len(solves)}: cg {solve.last_iters}, true relres "
                f"{rr!r}, {sec:.2f} s, {solves[-1]['active']} active slots")
            for k in ("last_iters", "last_passes", "last_relres"):
                setattr(call, k, getattr(solve, k))
            if "x" not in first:
                first.update(x=x.clone(), iters=solve.last_iters)
            return x
        call.mpc = solve.mpc
        call.last_iters = call.last_passes = 0
        call.last_relres = float("nan")
        return call, elim

    def make_state(*a, **kw):
        st = real[1](*a, **kw)
        state["contact"] = st
        return st

    def Tt(self, cn, y):
        state["Tt"] += 1
        return real[2](self, cn, y)

    def smooth(*a, **kw):
        state["smooth"] += 1
        return real[3](*a, **kw)
    cmod.make_slag_contact_solver = make_solver
    nl.ContactState.make = make_state
    elim_cls.Tt = Tt
    nodal.smooth = smooth

    def restore():
        (cmod.make_slag_contact_solver, nl.ContactState.make, elim_cls.Tt,
         nodal.smooth) = real
    return restore


def phase_contact_main_path(args, mods) -> dict:
    """The flat punch through run_directory on the card (``punch_mesh``,
    default n = 48: 113,041 nodes, 339,123 dofs, 103,964 hex8, 2,209
    slave nodes over 2,304 master faces; shuffled), SLAGRANGE,
    frictionless, NLSTATIC in two substeps.  Per solve: CG, seconds and
    an independent index_add_ true relres of the eliminated system (<=
    1e-8); per substep the Newton iterations of each contact pass and the
    active slots; the phase seconds (contact_search among them) and the
    peak device memory.  At the end: the largest penetration over the
    active slots <= 1e-8 x the model's size; the z force through the
    slaves equal to the z reaction on z = 0 within 1e-6; K1 planes
    launches = one per T^T (CG iterations + 2 per solve + 1 per Newton
    residual) + one per nodal smoothing; the first solve repeated: the
    same CG count, bit-equal.  Returns the cell's counts."""
    n = args.contact_n
    wd = os.path.join(ROOT, "build", "smoke", f"contact{n}")
    t0 = time.perf_counter()
    mesh = punch_mesh(mods, n)
    write_contact_workdir(wd, mods, mesh, contact_cnt())
    n_slave = len(mesh.node_groups["SLAVE"])
    n_face = len(mesh.surf_groups["MAST"])
    log(f"phase contact_workdir: flat punch of {n} shuffled, {mesh.n_node} "
        f"nodes, {3 * mesh.n_node} dofs, {len(mesh.blocks[0].elem_ids)} "
        f"hex8, {n_slave} slave nodes over {n_face} master faces, "
        f"SLAGRANGE, NLSTATIC 2 substeps, written in "
        f"{time.perf_counter() - t0:.2f} s")
    del mesh
    solves, first, state = [], {}, {}
    restore = spy_contact(mods, solves, first, state)
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = mods["run_directory"](wd, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model, st = out["static"], out["model"], state["contact"]
    nw, tm = res.newton, res.timings
    cg = [s["cg_iters"] for s in solves]
    solve_s = sum(s["s"] for s in solves)
    ms_cg = 1e3 * solve_s / max(sum(cg), 1)
    keys = ("read", "reorder", "model", "contact_search", "tangent",
            "solve", "update", "post")
    log(f"phase contact_main_path: {wall:.2f} s; arm={st.arm} newton_iters="
        f"{nw.total_iters} cutbacks={nw.cutbacks} cg_iters={cg} "
        f"({ms_cg:.3f} ms a CG iteration) K1 launches={launches['K1']}, K1 "
        f"planes launches={launches['K1 planes']} ({state['Tt']} T^T + "
        f"{state['smooth']} nodal smoothings), peak device memory "
        f"{peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(f"{k}={tm.get(k, 0.0):.3f}"
                                       for k in keys))
    for c in nw.contact:
        log(f"  substep ({c['step']}, {c['substep']}): Newton iterations "
            f"per contact pass {c['passes']}, {int(c['active'].sum())} "
            f"active slots")
    for h in nw.history:
        log(f"  step {h['step']} substep {h['substep']} pass "
            f"{h['contact_pass']} it {h['iter']}: rres={h['rres']!r} "
            f"rxnrm={h['rxnrm']!r} cg_iters={h['cg_iters']} active="
            f"{h['active']}; contact_search={h['contact_search']:.3f} "
            f"solve={h['solve']:.3f}")
    if st.arm != "slag" or not solves or len(solves) != len(nw.history):
        raise AssertionError("contact_main_path: not the SLAGRANGE arm, or "
                             "solves and iterations do not pair up")
    last = nw.history[-1]
    if nw.cutbacks or min(last["rres"], last["rxnrm"]) >= 1e-6:
        raise AssertionError("contact_main_path: Newton did not converge "
                             "without cutbacks")
    if not all(s["true_relres"] <= 1e-8 for s in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    u = res.u
    if not (u.shape == (model.n_node, 3) and np.isfinite(u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    # the gap over the final active set, and the interface equilibrium
    cm = st.cm
    proj = cm.search(model.coords + u)
    act = st.active_set()
    size = float(np.abs(model.coords).max())
    pen = float(np.maximum(-proj["gap"][act], 0.0).max())
    groups = model.mesh.node_groups
    f_slave = float(res.reaction[groups["SLAVE"], 2].sum())
    f_bot = float(res.reaction[groups["BOT"], 2].sum())
    equil = abs(abs(f_slave) - abs(f_bot)) / abs(f_bot)
    log(f"  {int(act.sum())} active slots of {len(act)}: largest "
        f"penetration {pen!r} (size {size!r}); z force through the slaves "
        f"{f_slave!r}, z reaction on z = 0 {f_bot!r}, relative difference "
        f"{equil!r}; u_z range [{float(u[:, 2].min())!r}, "
        f"{float(u[:, 2].max())!r}]")
    if not (act.sum() > 0 and pen <= 1e-8 * size):
        raise AssertionError("contact_main_path: the active slots "
                             "penetrate")
    if not (abs(f_bot) > 0 and equil <= 1e-6):
        raise AssertionError("contact_main_path: the interface is not in "
                             "equilibrium")
    if launches["K1 planes"] != state["Tt"] + state["smooth"] or \
            state["Tt"] < sum(cg):
        raise AssertionError(f"K1 planes launches {launches['K1 planes']} "
                             f"do not add up: {state}")
    with open(os.path.join(wd, "FSTR.sta")) as fh:
        if "HAS COMPLETED SUCCESSFULLY" not in fh.read():
            raise AssertionError("FSTR.sta does not report success")
    again = first["solve"](first["kes"], first["B"], first["dinc"],
                           first["cn"], first["gfac"])
    same = torch.equal(again, first["x"])
    log(f"  first solve repeated: cg {first['iters']} then "
        f"{first['solve'].last_iters}, bit-equal answer {same}")
    if first["solve"].last_iters != first["iters"] or not same:
        raise AssertionError("contact_main_path: a repeated solve differs")
    return {"launches": launches["K1 planes"], "element_launches":
            launches["K1"], "newton_iters": nw.total_iters,
            "passes": [c["passes"] for c in nw.contact], "cg_iters": cg,
            "ms_per_cg": ms_cg, "active": int(act.sum()),
            "penetration": pen, "equilibrium": equil, "wall_s": wall,
            "peak_gb": peak_gb,
            "seconds": {k: tm.get(k, 0.0) for k in keys},
            "cn": first["cn"]}


def phase_contact_planes_time(mods, cell) -> dict:
    """K1's planes entry at the contact path's slot plan (the SLAGRANGE
    reduction T^T of the first solve's slots): held to its plain version,
    bit-equal on relaunch, timed with it and with one index_add_ of the
    same entries, against its bytes bound.  Returns the kernels-line
    row."""
    sm = mods["segsum"]
    cn = cell.pop("cn")
    plan = cn.add.plan
    R = plan.perm.numel()
    vals = torch.randn((1, R), dtype=torch.float64, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(21))
    err = check_planes(sm, plan, vals, torch.float64,
                       "the contact reduction T^T")
    ms = cuda_ms(lambda: sm.segsum_planes(vals, plan))
    plain_ms = cuda_ms(lambda: sm.segsum_planes_reference(vals, plan))
    out = torch.zeros((1, plan.n_slots), dtype=torch.float64, device="cuda")
    g_vals, g_seg = vals[:, plan.perm.long()], plan.seg_sorted.long()
    library_ms = cuda_ms(lambda: out.index_add_(1, g_seg, g_vals))
    nbytes = R * 8 + R * 4 + (plan.n_slots + 1) * 4 + plan.n_slots * 8
    bound_ms, bound_by = bound(nbytes, R, torch.float64)
    log(f"phase contact_planes_time: R={R} entries, n_slots={plan.n_slots}"
        f" float64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_"
        f" {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} B)")
    return {"name": "segsum_planes_contact",
            "entry": "planes, the SLAGRANGE reduction T^T and the nodal "
                     "smoothing (contact punch)",
            "route": "cuda", "source": "frontistr_tpu_torch/csrc/segsum.cu",
            "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
            "launches": cell["launches"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "contact_main_path": cell}


def phase_contact_small_reference(mods) -> None:
    """Small contact decks on the card and on the CPU (f64): the
    augmented-Lagrange arm (STATIC, the punch boxes of 3 and 2), friction
    sticking and slipping (BiCGSTAB), SLAGRANGE, the saddle arm forced
    and by an equation on the contact surface, METHOD=DIRECT with both
    algorithms, a redundant tie on each iterative arm, and implicit
    dynamics (the drop impact, AL; a loaded column, SLAGRANGE).
    Displacements within 1e-8 x max|u|, the Newton iterations of every
    contact pass equal (every step's passes in dynamics), CG within 1
    per solve (BiCGSTAB: the run's total within 10%); the DIRECT arms
    never fall back on the iterative one."""
    Equation, nl = mods["Equation"], mods["nonlinear"]
    cp = mods["meshgen"].contact_pair
    meshes = {
        "cubes": lambda: cp((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                            (1.0, 1.0, 1.0)),
        "gap": lambda: cp((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                          (1.0, 1.0, 1.0), gap=0.05),
        "block2": lambda: cp((1, 1, 2), (1, 1, 2), (1.0, 1.0, 1.0),
                             (1.0, 1.0, 1.0)),
        "punch": lambda: cp((3, 3, 2), (2, 2, 2), (1.0, 1.0, 0.5),
                            (0.9, 0.9, 0.45))}

    def tie(mesh, where):
        nodes = mesh.node_groups["SLAVE"] if where == "slave" else \
            [k for k in mesh.node_groups["LOW"]
             if np.isclose(mesh.coords[k, 2], 0.5)]
        mesh.equations = [Equation(np.asarray([nodes[0], nodes[-1]]),
                                   np.asarray([3, 3]),
                                   np.asarray([1.0, -1.0]), 0.0)]
        return mesh

    base = dict(E="1000.0", nu="0.0", resid="1.0e-12", conv="1.0e-7",
                uz="-0.01")
    shear = (" BOT, 1, 3, 0.0\n TOP, 3, 3, -0.01\n TOP, 1, 1, 1.0e-3\n"
             " TOP, 2, 2, 0.0\n")
    held = " BOT, 3, 3, 0.0\n ALL, 1, 2, 0.0\n"
    load = "!CLOAD, GRPID=1\n TOP, 3, -2.0\n"
    dyn = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 1, 1\n"
           " 0.0, {t}, 60, {dt}\n 0.75, 0.390625\n 1, 1, {ray}, 0.0\n 10\n"
           "!BOUNDARY, GRPID=1\n" + held + load +
           "!CONTACT_ALGO, TYPE={algo}\n!CONTACT, GRPID=1\n CP1, 0.0\n"
           "!STEP, SUBSTEPS=1, CONVERG=1.0e-7\n BOUNDARY, 1\n LOAD, 1\n"
           " CONTACT, 1\n!MATERIAL, NAME=M1\n!ELASTIC\n 1000.0, 0.0\n"
           "!DENSITY\n 1.0\n!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, "
           "TIMELOG=NO\n 10000, 1\n 1.0e-12, 1.0, 0.0\n!END\n")
    cases = [
        ("ALAGRANGE STATIC punch", "punch", None, contact_cnt(
            "ALAGRANGE", sol="STATIC", **dict(base, nu="0.3")), {}),
        ("friction stick (BiCGSTAB)", "punch", None, contact_cnt(
            "ALAGRANGE", bc=shear, mu="100.0, 1.0e+4",
            **dict(base, conv="1.0e-6")), {}),
        ("friction slip (BiCGSTAB)", "punch", None, contact_cnt(
            "ALAGRANGE", bc=shear, mu="0.01, 1.0e+4", sub=5,
            **dict(base, conv="1.0e-6")), {}),
        ("SLAGRANGE", "block2", None, contact_cnt(**base), {}),
        ("saddle forced", "block2", None, contact_cnt(
            **dict(base, conv="1.0e-9")),
         {"FRONTISTR_TPU_CONTACT_SOLVE": "saddle"}),
        ("saddle by an equation on the surface", "block2", "slave",
         contact_cnt(**dict(base, conv="1.0e-9")), {}),
        ("DIRECT SLAGRANGE", "cubes", None, contact_cnt(
            bc=held, loads=load, method="DIRECT", **base), {}),
        ("DIRECT ALAGRANGE", "cubes", None, contact_cnt(
            "ALAGRANGE", bc=held, loads=load, method="DIRECT", **base), {}),
        ("redundant tie ALAGRANGE", "block2", "mid", contact_cnt(
            "ALAGRANGE", **dict(base, conv="1.0e-9")), {}),
        ("redundant tie SLAGRANGE", "block2", "mid", contact_cnt(
            **dict(base, conv="1.0e-9")), {}),
        ("dynamics drop impact ALAGRANGE", "gap", None, dyn.format(
            t=0.6, dt=0.01, ray=0.5, algo="ALAGRANGE"), {}),
        ("dynamics column SLAGRANGE", "cubes", None, dyn.format(
            t=1.2, dt=0.02, ray=4.0, algo="SLAGRANGE"), {})]
    for label, kind, where, cnt, env in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            mesh = meshes[kind]()
            if where is not None:
                tie(mesh, where)
            wd = os.path.join(ROOT, "build", "smoke", "contact_small",
                              f"{label.replace(' ', '_')}_{dev}")
            shutil.rmtree(wd, ignore_errors=True)
            write_contact_workdir(wd, mods, mesh, cnt, seed=5)
            states = []
            real = nl.ContactState.make

            def make(*a, **kw):
                st = real(*a, **kw)
                states.append(st)
                return st
            nl.ContactState.make = make
            try:
                o = with_env(dict(env, FRONTISTR_TPU_PRECISION="f64"),
                             lambda: mods["run_directory"](wd, device=dev))
            finally:
                nl.ContactState.make = real
            r = o.get("dynamic") or o["static"]
            if "dynamic" in o:
                counts = [h["passes"] for h in r.history]
                cg = [c for h in r.history for c in h["cg"]]
            else:
                counts = [c["passes"] for c in r.newton.contact]
                cg = [h["cg_iters"] for h in r.newton.history]
            outs[dev] = (r.u, counts, cg, states[0])
        (ug, cg_, gg, sg), (uc, cc, gc, sc) = outs["cuda"], outs["cpu"]
        rel = rel_diff(ug, uc)

        def brief(v):
            return v if len(v) <= 12 else \
                f"{len(v)} entries, sum {sum(map(np.sum, v))}"
        # BiCGSTAB (the friction arm): a single solve's count moves by
        # tens of iterations under a load changed by 1e-13, in the JAX
        # package too and at relres 1e-8 as at 1e-12, while the run's
        # total stays within 10%
        # (tests/test_torch_contact_friction.py), so the total is held
        worst = max((abs(a - b) for a, b in zip(gg, gc)), default=0)
        counts_ok = len(gg) == len(gc) and (
            abs(sum(gg) - sum(gc)) <= 0.1 * sum(gc) if sg.cm.has_friction
            else worst <= 1)
        log(f"phase contact_small_reference: {label} (arm {sg.arm}), cuda "
            f"vs cpu max rel diff {rel!r}, passes {brief(cg_)} vs "
            f"{brief(cc)}, cg {brief(gg)} vs {brief(gc)} (largest "
            f"difference a solve {worst})")
        if not (rel <= 1e-8 and cg_ == cc and counts_ok):
            raise AssertionError(f"contact_small_reference: {label}: cuda "
                                 "and cpu runs disagree")
        if sg.retries or sc.retries:
            raise AssertionError(f"contact_small_reference: {label}: the "
                                 "DIRECT arm fell back on the iterative one")


# ---- the solver menu (the scalar-ELL operator through K1, SSOR,
# ---- Chebyshev) and !RESTART -------------------------------------------
# the STATIC tet deck for the Krylov menu: RESID 1e-9, so every method's
# own residual (BiCGSTAB's and GPBiCG's a recurrence) leaves room under
# the 1e-8 bar on the independent index_add_ residual
KRYCNT = CNT.replace("METHOD=CG", "METHOD={method}").replace(
    " 1.0e-8, 1.0, 0.0", " 1.0e-9, 1.0, 0.0")
KRYLOV_METHODS = ("BICGSTAB", "GMRES", "GPBICG")


def tet_workdir(mods, wd, dims, cnt) -> str:
    """``write_workdir`` of a shuffled box_tet4(*dims); returns ``wd``."""
    write_workdir(wd, dims, mods["ordering"], mods["box_tet4"],
                  mods["write_static_workdir"], cnt)
    return wd


def tet_deck_like_newton(mods, args, wd, m, cnt) -> int:
    """``cnt`` on the shuffled box_tet4(m) in ``wd``: the newton cell's
    mesh file copied when m is its box (the same mesh, seed 3), else
    written.  Returns the dofs."""
    src = os.path.join(ROOT, "build", "smoke", f"newton{m}")
    if m != args.newton_n or not os.path.isdir(src):
        return write_workdir(wd, (m,) * 3, mods["ordering"],
                             mods["box_tet4"], mods["write_static_workdir"],
                             cnt)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    for name in ("mesh.msh", "hecmw_ctrl.dat"):
        shutil.copy(os.path.join(src, name), wd)
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(cnt)
    return 3 * (m + 1) ** 3


def krylov_solve(mods, model, kes, method, resid=None):
    """``static.solve_linear`` of ``model`` by ``method`` (its profile and
    element matrices reused); returns (LinearSolve, solve s, peak GB)."""
    sv = model.cfg.solver
    saved = (sv.method, sv.resid)
    sv.method = method
    if resid is not None:
        sv.resid = resid
    tm = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        sol = mods["static"].solve_linear(model, kes, tm)
    finally:
        sv.method, sv.resid = saved
    return sol, tm["solve"], torch.cuda.max_memory_allocated() / 1e9


def krylov_row(method, iters, relres, solve_s, peak_gb, true_rr, u, u_cg):
    dev_cg = rel_diff(u, u_cg)
    ms_it = 1e3 * solve_s / max(iters, 1)
    log(f"  {method}: iterations={iters} relres={relres!r} solve "
        f"{solve_s:.3f} s ({ms_it:.3f} ms an iteration), peak device "
        f"memory {peak_gb:.3f} GB, true f64 relres (index_add_) "
        f"{true_rr!r}, max|u - u_CG|/max|u| = {dev_cg!r}")
    return dict(iters=iters, relres=relres, solve_s=solve_s,
                ms_per_iter=ms_it, peak_gb=peak_gb, true_relres=true_rr,
                vs_cg=dev_cg)


def phase_krylov_main_path(args, mods, tet_model) -> dict:
    """The STATIC tet deck with METHOD=BICGSTAB on a shuffled
    box_tet4(m) through run_directory: the scalar block-ELL operator (its
    blocks summed by K1 at the ELL profile's plan, once) with
    block-Jacobi.  Then GMRES(30) and GPBiCG through ``solve_linear`` on
    the same model and element matrices (the input and the profile paid
    once), and the card's CG/AMG answer (mixed policy) as the yardstick.
    Each method's true f64 relres by an independent index_add_ residual
    must be <= 1e-8.  GMRES that does not reach the tolerance within
    the deck's NIER at this width is recorded and then held at the tet
    path's box_tet4(n) (``tet_model``).  Returns the counts, the model
    and its element matrices."""
    sm, stmod = mods["segsum"], mods["static"]
    m = args.krylov_n
    wd = os.path.join(ROOT, "build", "smoke", f"krylov{m}")
    t0 = time.perf_counter()
    ndof = tet_deck_like_newton(mods, args, wd, m,
                                KRYCNT.format(method="BICGSTAB"))
    log(f"phase krylov_workdir: box_tet4({m}) shuffled, STATIC "
        f"METHOD=BICGSTAB, {ndof} dofs, written in "
        f"{time.perf_counter() - t0:.2f} s")
    sm.segsum.launches = 0
    sm.segsum_planes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches, planes = sm.segsum.launches, sm.segsum_planes.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model = out["static"], out["model"]
    tm = res.timings
    log(f"phase krylov_main_path: {wall:.2f} s; " + " ".join(
        f"{k}={v:.3f}" for k, v in tm.items()))
    log(f"  K1 launches={launches} (the scalar-ELL blocks), K1 planes "
        f"launches={planes} (the nodal smoothing)")
    if launches != 1:
        raise AssertionError(f"krylov_main_path: K1 launched {launches} "
                             "times, expected once at the ELL plan")
    kes = stmod.compute_element_stiffness(model)
    sol_cg, cg_s, cg_peak = with_env(
        {"FRONTISTR_TPU_PRECISION": "f64"},
        lambda: krylov_solve(mods, model, kes, "CG"))
    u_cg = sol_cg.x
    log(f"  CG/AMG yardstick ({sol_cg.policy}): {sol_cg.iters} CG, "
        f"{sol_cg.passes} passes, solve {cg_s:.3f} s, peak {cg_peak:.3f} "
        "GB")
    rows = {"BICGSTAB": krylov_row(
        "BICGSTAB", res.iters, res.relres, tm["solve"], peak_gb,
        true_relres(model, res.u, kes), res.u.reshape(-1), u_cg)}
    resid = model.cfg.solver.resid
    for method in KRYLOV_METHODS[1:]:
        sol, s, peak = krylov_solve(mods, model, kes, method)
        rows[method] = krylov_row(method, sol.iters, sol.relres, s, peak,
                                  true_relres(model, sol.x, kes), sol.x,
                                  u_cg)
    g = rows["GMRES"]
    if g["relres"] > resid:
        log(f"  GMRES(30) with block-Jacobi stops at NIER "
            f"({g['iters']} iterations, relres {g['relres']!r}) at this "
            f"width; held at the tet path's box_tet4({args.n}) instead")
        kt = stmod.compute_element_stiffness(tet_model)
        sol, s, peak = krylov_solve(mods, tet_model, kt, "GMRES", resid)
        cg40, _, _ = krylov_solve(mods, tet_model, kt, "CG", resid)
        rows[f"GMRES_n{args.n}"] = krylov_row(
            f"GMRES at box_tet4({args.n})", sol.iters, sol.relres, s, peak,
            true_relres(tet_model, sol.x, kt), sol.x, cg40.x)
        del kt
    for method, r in rows.items():
        if method == "GMRES" and f"GMRES_n{args.n}" in rows:
            continue
        if not (r["relres"] <= resid and r["true_relres"] <= 1e-8):
            raise AssertionError(f"krylov_main_path: {method} did not "
                                 "converge to a true relres <= 1e-8")
    if not (res.u.shape == (model.n_node, 3) and np.isfinite(res.u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    with open(os.path.join(wd, "0.log")) as fh:
        if "Global Summary" not in fh.read():
            raise AssertionError("0.log holds no Global Summary")
    return dict(rows=rows, launches=launches, model=model, kes=kes)


def phase_k1_ell_time(mods, model, kes, launches) -> dict:
    """K1's element entry at the Krylov path's scalar-ELL plan (9 planes
    of N*W slots, tet4 m = 12) and first tangent, float64 (the type the
    path assembles in) and float32: against its plain version,
    index_add_ of the entries in slot order, and its bytes bound."""
    sm = mods["segsum"]
    prof = mods["ell"].profile_from_model(model)
    plan = prof.plan("cuda")
    nns = [b.conn.shape[1] for b in model.blocks]
    P = plan.perm.numel()
    seg = plan.seg_sorted.long()
    row = {"name": "segsum_ell", "route": "cuda",
           "entry": "element, scalar-ELL plan (krylov_main_path)",
           "source": "frontistr_tpu_torch/csrc/segsum.cu",
           "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
           "launches": launches}
    for dt in (torch.float32, torch.float64):
        kd = [k.to(dt) for k in kes]
        err = check_k1(sm, plan, kd, nns, dt, "scalar-ELL plan")
        ms = cuda_ms(lambda: sm.segsum(plan, kd, nns, 3))
        plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, nns, 3))
        ent = sm.entry_planes(kd, nns, 3)[:, plan.perm.long()]
        out = torch.zeros((9, plan.n_slots), dtype=dt, device="cuda")
        library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
        del ent, out
        isz = kd[0].element_size()
        nbytes = (sum(k.numel() for k in kd) * isz + P * 4
                  + (plan.n_slots + 1) * 4 + 9 * plan.n_slots * isz)
        bound_ms, bound_by = bound(nbytes, 9 * P, dt)
        log(f"phase k1_ell_time: P={P} pairs, n_slots={plan.n_slots} "
            f"(N={prof.n_node}, W={prof.W}) {str(dt)[6:]}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, index_add_ "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({nbytes / 1e9:.3f} GB)")
        nums = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
        if dt == torch.float64:
            row.update(nums)
        else:
            row["f32"] = nums
        del kd
    return row


def phase_ssor_main_path(args, mods, amg_newton=None) -> dict:
    """The NLSTATIC bench deck with !SOLVER, METHOD=CG, PRECOND=10 on a
    shuffled box_tet4(s) through run_directory, f64 policy: the Newton
    driver's CG preconditioned by multicolor block SSOR (one forward and
    one backward sweep over the colors).  Held to: every solve's
    index_add_ true relres <= 1e-8, K1 element launches = Newton
    iterations, and the Newton count of the AMG: ``amg_newton`` (the
    newton cell's, when the box is its), else an AMG run on the same
    model.  The SSOR apply and the cluster product timed alone on the
    first tangent."""
    nl, sm, stmod = mods["nonlinear"], mods["segsum"], mods["static"]
    s = args.ssor_n
    wd = os.path.join(ROOT, "build", "smoke", f"ssor{s}")
    t0 = time.perf_counter()
    ndof = tet_deck_like_newton(mods, args, wd, s, NLCNT.format(
        load=-1.0).replace("METHOD=CG,", "METHOD=CG, PRECOND=10,"))
    log(f"phase ssor_workdir: box_tet4({s}) shuffled, NLSTATIC PRECOND=10, "
        f"{ndof} dofs, written in {time.perf_counter() - t0:.2f} s")
    solves = []
    real = nl.make_constrained_solver
    nl.make_constrained_solver = spy_solves(nl, solves)
    sm.segsum.launches = 0
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: mods["run_directory"](wd, device="cuda"))
        wall = time.perf_counter() - t0
    finally:
        nl.make_constrained_solver = real
    launches = sm.segsum.launches
    res, model = out["static"], out["model"]
    nw = res.newton
    maps = mods["ssor"].eligible_maps(mods["ell"].profile_from_model(model),
                                      "ssor")
    sizes = [len(r) for r in maps.colors("cpu")]
    log(f"phase ssor_main_path: {wall:.2f} s; {maps.ncol} colors "
        f"(nodes a color {min(sizes)}..{max(sizes)}), newton_iters="
        f"{nw.total_iters}, K1 launches={launches}; " + " ".join(
            f"{k}={res.timings.get(k, 0.0):.3f}" for k in
            ("read", "reorder", "profile", "tangent", "assembly",
             "amg_setup", "solve")))
    for h, sv in zip(nw.history, solves):
        log(f"  it {h['iter']}: cg_iters={sv['cg_iters']} solve "
            f"{h['solve']:.3f} s ({1e3 * h['solve'] / max(sv['cg_iters'], 1):.3f}"
            f" ms a CG iteration), relres={sv['relres']!r} true_relres="
            f"{sv['true_relres']!r}")
    if len(solves) != len(nw.history) or not solves:
        raise AssertionError("ssor_main_path: solves and iterations do "
                             "not pair up")
    if launches != nw.total_iters:
        raise AssertionError(f"K1 launches {launches} != Newton "
                             f"iterations {nw.total_iters}")
    if not all(sv["true_relres"] <= 1e-8 for sv in solves):
        raise AssertionError("a linear solve's true relres is above 1e-8")
    # the SSOR apply and the product alone, on the first tangent
    kes = stmod.compute_element_stiffness(model)
    setup = stmod.cluster_setup(model, {}, policy="ssor")
    free = torch.as_tensor(mods["make_free_mask"](model.n_dof_total,
                                                  model.fixed_dofs),
                           device="cuda")
    A, M = stmod.cluster_operator(setup, model, kes, free, torch.float64,
                                  {})
    r = torch.randn(model.n_dof_total, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    sweep_ms = cuda_ms(lambda: M(r), reps=5)
    mv_ms = cuda_ms(lambda: A(r), reps=5)
    log(f"  SSOR apply (forward + backward sweep, {maps.ncol} colors) "
        f"{sweep_ms:.3f} ms, cluster product {mv_ms:.3f} ms")
    del kes, setup, A, M
    # the AMG's Newton count on this box
    cg_amg = None
    if amg_newton is None:
        model.cfg.solver.precond = 1
        amg_res = with_env({"FRONTISTR_TPU_PRECISION": "f64",
                            "FRONTISTR_TPU_PRECOND": "amg"},
                           lambda: nl.run_nonlinear_static(model))
        amg_newton = amg_res.newton.total_iters
        cg_amg = [h["cg_iters"] for h in amg_res.newton.history]
        log(f"  AMG on the same model: newton_iters={amg_newton}, cg "
            f"{cg_amg}, solve {amg_res.timings.get('solve', 0.0):.3f} s")
    if amg_newton != nw.total_iters:
        raise AssertionError(f"ssor_main_path: {nw.total_iters} Newton "
                             f"iterations, the AMG's {amg_newton}")
    return dict(colors=maps.ncol, newton=nw.total_iters,
                cg=[sv["cg_iters"] for sv in solves], cg_amg=cg_amg,
                sweep_ms=sweep_ms, matvec_ms=mv_ms, wall=wall)


class Committed:
    """Keeps the states of the last ``nonlinear._commit_state`` calls
    of a run (the committed gauss states of its last substep)."""

    def __init__(self, nl):
        self.nl, self.real, self.states = nl, nl._commit_state, []

    def __enter__(self):
        def keep(s):
            out = self.real(s)
            self.states.append(out)
            return out
        self.nl._commit_state = keep
        return self

    def __exit__(self, *exc):
        self.nl._commit_state = self.real

    def last(self, n_blocks):
        return self.states[-n_blocks:]


def phase_restart_main_path(args, mods, plastic) -> dict:
    """!RESTART on the plastic cell's deck: the run interrupted after
    substep 1 (the pressure and the step time halved, so its one substep
    is the full run's first, bit for bit), FREQUENCY=1, then the full
    deck resumed from its checkpoint with FREQUENCY=-1.  Held to: the
    resumed u and every committed gauss state (strain, stress,
    equivalent plastic strain, yield flags) bit-equal to
    plastic_main_path's uninterrupted run.  Prints the checkpoint's bytes
    and its write and read seconds."""
    nl = mods["nonlinear"]
    p = args.plastic
    src = os.path.join(ROOT, "build", "smoke", f"plastic{p}")
    wd = os.path.join(ROOT, "build", "smoke", f"restart{p}")
    shutil.rmtree(wd, ignore_errors=True)
    shutil.copytree(src, wd)
    # no !WRITE, RESULT: the .res of the cell is plastic_main_path's
    half = PLCNT.format(sol="NLSTATIC", loads="!DLOAD\n TOP, P2, "
                        f"{PLASTIC_PRESSURE / 2!r}\n", plastic=MISES,
                        extra="!RESTART, FREQUENCY=1\n",
                        sub="2\n 0.5, 0.5").replace("!WRITE, RESULT\n", "")
    full = PLCNT.format(sol="NLSTATIC", loads="!DLOAD\n TOP, P2, "
                        f"{PLASTIC_PRESSURE!r}\n", plastic=MISES,
                        extra="!RESTART, FREQUENCY=-1\n",
                        sub=2).replace("!WRITE, RESULT\n", "")
    ck = os.path.join(wd, "restart.npz")
    outs = []
    for cnt in (half, full):
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(cnt)
        t0 = time.perf_counter()
        with Committed(nl) as kept:
            o = mods["run_directory"](wd, device="cuda")
        outs.append((o, time.perf_counter() - t0, kept,
                     os.path.getsize(ck)))
    (o1, w1, _, b1), (o2, w2, kept, b2) = outs
    r1, r2 = o1["static"], o2["static"]
    log(f"phase restart_main_path: interrupted run {w1:.2f} s "
        f"({r1.newton.substeps} substep, {r1.iters} Newton iterations, "
        f"checkpoint {b1} bytes written in "
        f"{r1.timings['restart_save']:.3f} s); resumed run {w2:.2f} s "
        f"(read in {r2.timings['restart_load']:.3f} s, {r2.newton.substeps}"
        f" substep, {r2.iters} Newton iterations, its checkpoint {b2} "
        f"bytes in {r2.timings['restart_save']:.3f} s)")
    n_b = len(o2["model"].blocks)
    same_u = np.array_equal(r2.u, plastic["u"])
    st_got = kept.last(n_b)
    same_st = all(
        torch.equal(a[k], b[k]) for a, b in zip(st_got, plastic["states"])
        for k in ("strain", "stress", "pstrain", "yielded"))
    yielded = sum(int(s["yielded"].sum()) for s in st_got)
    log(f"  resumed vs plastic_main_path: u bit-equal {same_u} (max rel "
        f"diff {rel_diff(r2.u, plastic['u'])!r}), committed states "
        f"(strain, stress, pstrain, yielded) bit-equal {same_st}, "
        f"{yielded} yielded gauss points")
    if r1.newton.substeps != 1 or r2.newton.substeps != 1:
        raise AssertionError("restart_main_path: not one substep each")
    if not (same_u and same_st and yielded > 0):
        raise AssertionError("restart_main_path: the resumed run differs "
                             "from the uninterrupted one")
    return dict(bytes=b1, write_s=r1.timings["restart_save"],
                read_s=r2.timings["restart_load"], interrupted_s=w1,
                resumed_s=w2)


DYN_CONTACT = (
    "!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 1, 1\n"
    " 0.0, {t!r}, {n}, 0.01\n 0.75, 0.390625\n 1, 1, 0.5, 0.0\n 10\n"
    "!BOUNDARY, GRPID=1\n BOT, 3, 3, 0.0\n ALL, 1, 2, 0.0\n"
    "!CLOAD, GRPID=1\n TOP, 3, -2.0\n!CONTACT_ALGO, TYPE=ALAGRANGE\n"
    "!CONTACT, GRPID=1\n CP1, 0.0\n!STEP, SUBSTEPS=1, CONVERG=1.0e-7\n"
    " BOUNDARY, 1\n LOAD, 1\n CONTACT, 1\n!MATERIAL, NAME=M1\n!ELASTIC\n"
    " 1000.0, 0.0\n!DENSITY\n 1.0\n!SOLVER, METHOD=CG, PRECOND=1, "
    "ITERLOG=NO, TIMELOG=NO\n 10000, 1\n 1.0e-12, 1.0, 0.0\n{restart}"
    "!END\n")


def phase_solvers_small_reference(mods) -> None:
    """Small decks of this slice on the card and on the CPU (which the
    CPU tests hold to the JAX package), f64: linear STATIC by BiCGSTAB,
    GMRES, GPBiCG and the ids 2-4 on a shuffled tet box (K1 once at the
    ELL plan) and on a structured hex8 box (K2 launches counted),
    BiCGSTAB with !EQUATION, CG with FRONTISTR_TPU_PRECOND=cheby, SSOR
    (PRECOND=10) in NLSTATIC on tet4 and hex8; !RESTART of NLSTATIC in
    both formats, of the implicit contact drop (ALAGRANGE, its
    multipliers and released slots carried) and of transient heat, each
    resumed run bit-equal to the uninterrupted one on its device; an
    !ECHO deck's echo block.  Bars: u within 1e-8 of max|u| (T 1e-10),
    Newton and fixed-point counts equal, Krylov counts as
    ``krylov_close`` says (CG within 1)."""
    run, sm, em = mods["run_directory"], mods["segsum"], mods["element_mv"]
    base = os.path.join(ROOT, "build", "smoke", "solvers_small")
    box_tet4, box_hex8 = mods["box_tet4"], mods["box_hex8"]
    f64 = {"FRONTISTR_TPU_PRECISION": "f64"}

    def both(label, make, env=None):
        """``make(wd, dev)`` on the card and on the CPU; the outputs by
        device, and under "k" the (K1, K2) launches of each run."""
        outs = {"k": {}}
        for dev in ("cuda", "cpu"):
            wd = os.path.join(base, label.replace(" ", "_"), dev)
            shutil.rmtree(wd, ignore_errors=True)
            k1, k2 = sm.segsum.launches, em.element_matvec_soa.launches
            outs[dev] = with_env(dict(f64, **(env or {})),
                                 lambda: make(wd, dev))
            outs["k"][dev] = (sm.segsum.launches - k1,
                              em.element_matvec_soa.launches - k2)
        return outs

    def krylov_close(method, a, b):
        """Krylov counts of one solve, card against CPU: within 1 for
        CG, within 2 under the Chebyshev polynomial (ROADMAP queue 3's
        caveat), one restart cycle for GMRES(30), 10% for BiCGSTAB and
        GPBiCG (their residuals are not monotone: 84 against 80 on the
        tet box, measured on one H100)."""
        slack = {"CG": 1, "1": 1, "cheby": 2, "GMRES": 30, "3": 30}.get(
            method, max(1, 0.1 * b))
        return abs(a - b) <= slack

    def judge(label, rel, cnt_g, cnt_c, ok, bar=1e-8, extra=""):
        log(f"phase solvers_small_reference: {label}, cuda vs cpu max rel "
            f"diff {rel!r}, counts {cnt_g} vs {cnt_c}{extra}")
        if not (rel <= bar and ok):
            raise AssertionError(f"solvers_small_reference: {label}")

    # linear STATIC: the methods on the tet box (the ELL arm) and on the
    # structured hex8 box (the stencil arm)
    for method in ("BICGSTAB", "GMRES", "GPBICG", "2", "3", "4"):
        o = both(f"tet {method}", lambda wd, dev: run(tet_workdir(
            mods, wd, (6, 5, 4), KRYCNT.format(method=method)),
            device=dev)["static"])
        (g, c), k1 = (o["cuda"], o["cpu"]), o["k"]["cuda"][0]
        judge(f"STATIC tet {method}", rel_diff(g.u, c.u), g.iters, c.iters,
              krylov_close(method, g.iters, c.iters) and k1 == 1,
              extra=f", K1 launches {k1}")
    for method in ("BICGSTAB", "GMRES", "GPBICG"):
        def hex_run(wd, dev):
            model = hex_model(mods, (8, 6, 5), dev)
            model.cfg.solver.method = method
            return mods["static"].run_linear_static(model)
        o = both(f"hex {method}", hex_run)
        (g, c), k2 = (o["cuda"], o["cpu"]), o["k"]["cuda"][1]
        judge(f"STATIC structured hex8 {method}", rel_diff(g.u, c.u),
              g.iters, c.iters, krylov_close(method, g.iters, c.iters)
              and k2 > 0,
              extra=f", K2 launches {k2}")
    # BiCGSTAB with !EQUATION (X1's u_z tied to its first node)
    def eq_run(wd, dev):
        mesh = box_hex8(3, 2, 2)
        mast = tie_face(mods, mesh)
        cnt = KRYCNT.format(method="BICGSTAB").replace(
            " X1, 3, -1.0", f" {int(mesh.node_ids[mast])}, 3, -20.0")
        return run(write_shuffled(wd, mods, mesh, cnt), device=dev)["static"]
    o = both("equation BICGSTAB", eq_run)
    g, c = o["cuda"], o["cpu"]
    judge("STATIC BiCGSTAB with !EQUATION", rel_diff(g.u, c.u), g.iters,
          c.iters, krylov_close("BICGSTAB", g.iters, c.iters))
    # the Chebyshev preconditioner
    o = both("cheby", lambda wd, dev: run(tet_workdir(
        mods, wd, (6, 5, 4), KRYCNT.format(method="CG")),
        device=dev)["static"], {"FRONTISTR_TPU_PRECOND": "cheby"})
    g, c = o["cuda"], o["cpu"]
    judge("STATIC CG with FRONTISTR_TPU_PRECOND=cheby", rel_diff(g.u, c.u),
          g.iters, c.iters, krylov_close("cheby", g.iters, c.iters))
    # SSOR in NLSTATIC
    for kind in ("tet4", "hex8"):
        mesh_fn = (lambda: box_tet4(6, 5, 4)) if kind == "tet4" else \
            (lambda: box_hex8(6, 5, 4))
        o = both(f"ssor {kind}", lambda wd, dev: run(write_shuffled(
            wd, mods, mesh_fn(), NLCNT.format(load=-100.0).replace(
                "METHOD=CG,", "METHOD=CG, PRECOND=10,")),
            device=dev)["static"])
        g, c = o["cuda"], o["cpu"]
        cg = [[h["cg_iters"] for h in r.newton.history] for r in (g, c)]
        judge(f"NLSTATIC SSOR (PRECOND=10) {kind}", rel_diff(g.u, c.u),
              cg[0], cg[1], g.iters == c.iters >= 2 and cg_close(*cg)
              and o["k"]["cuda"][0] == g.iters)
    # !RESTART: NLSTATIC (both formats), the contact drop, transient heat
    plastic = PLCNT.format(sol="NLSTATIC", loads="!DLOAD\n TOP, P2, 120.0\n",
                           plastic=MISES, extra="{restart}", sub="{sub}")

    def nl_deck(half, restart):
        return plastic.replace("120.0", "60.0" if half else "120.0").format(
            restart=restart, sub="2\n 0.5, 0.5" if half else "2")

    def resumed(wd, dev, decks, write, key):
        """The uninterrupted deck, then the interrupted one and the full
        deck resumed in a second directory; returns (once, resumed)."""
        once = run(write(wd + "_once", decks[0]), device=dev)[key]
        d = write(wd, decks[1])
        run(d, device=dev)
        with open(os.path.join(d, "case.cnt"), "w") as fh:
            fh.write(decks[2])
        return once, run(d, device=dev)[key]

    def plastic_write(wd, cnt):
        write_plastic_workdir(wd, mods, box_hex8(4, 3, 3), cnt)
        return wd
    for fmt in ("npz", "hecmw"):
        env = {"FRONTISTR_TPU_RESTART_FORMAT": fmt}
        decks = (nl_deck(False, ""), nl_deck(True, "!RESTART, FREQUENCY=1\n"),
                 nl_deck(False, "!RESTART, FREQUENCY=-1\n"))
        o = both(f"restart nlstatic {fmt}", lambda wd, dev: resumed(
            wd, dev, decks, plastic_write, "static"), env)
        (go, gr), (co, cr) = o["cuda"], o["cpu"]
        bit = np.array_equal(go.u, gr.u) and np.array_equal(co.u, cr.u)
        judge(f"NLSTATIC !RESTART ({fmt}) resumed", rel_diff(gr.u, cr.u),
              gr.iters, cr.iters, bit and gr.iters == cr.iters,
              extra=f", resumed = uninterrupted bit for bit {bit}")
    cp = mods["meshgen"].contact_pair

    def drop_write(wd, cnt):
        return write_contact_workdir(
            wd, mods, cp((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                         (1.0, 1.0, 1.0), gap=0.02), cnt, seed=5)
    decks = tuple(DYN_CONTACT.format(t=n * 0.01, n=n, restart=r) for n, r in
                  ((8, ""), (4, "!RESTART, FREQUENCY=4\n"),
                   (8, "!RESTART, FREQUENCY=-4\n")))
    o = both("restart drop", lambda wd, dev: resumed(wd, dev, decks,
                                                     drop_write, "dynamic"))
    (go, gr), (co, cr) = o["cuda"], o["cpu"]
    bit = all(np.array_equal(getattr(a, f), getattr(b, f))
              for a, b in ((go, gr), (co, cr)) for f in ("u", "vel", "acc"))
    active = any(h["active"].any() for h in gr.history)
    cnt = [[h["passes"] for h in r.history] for r in (gr, cr)]
    judge("implicit dynamics contact drop !RESTART (ALAGRANGE) resumed",
          max(rel_diff(getattr(gr, f), getattr(cr, f))
              for f in ("u", "vel", "acc")), cnt[0], cnt[1],
          bit and active and cnt[0] == cnt[1],
          extra=f", resumed = uninterrupted bit for bit {bit}, "
          f"contact active {active}")

    def heat_write(wd, cnt):
        small_heat_deck(mods, "hex8", True, wd)
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(cnt)
        return wd
    hd = os.path.join(base, "heat_template")
    small_heat_deck(mods, "hex8", True, hd)
    with open(os.path.join(hd, "case.cnt")) as fh:
        heat = fh.read()
    half = heat.replace("1.0e-4, 3.0e-4,", "1.0e-4, 2.0e-4,")
    decks = (heat, half.replace("!END", "!RESTART, FREQUENCY=2\n!END"),
             heat.replace("!END", "!RESTART, FREQUENCY=-2\n!END"))
    o = both("restart heat", lambda wd, dev: resumed(wd, dev, decks,
                                                     heat_write, "heat"))
    (go, gr), (co, cr) = o["cuda"], o["cpu"]
    bit = np.array_equal(go.T, gr.T) and np.array_equal(co.T, cr.T)
    cnt = [[h["fp"] for h in r.history] for r in (gr, cr)]
    judge("transient HEAT !RESTART resumed", rel_diff(gr.T, cr.T), cnt[0],
          cnt[1], bit and cnt[0] == cnt[1] and gr.steps == 3, bar=1e-10,
          extra=f", resumed = uninterrupted bit for bit {bit}")
    # !ECHO
    o = both("echo", lambda wd, dev: run(tet_workdir(
        mods, wd, (3, 2, 2), CNT.replace("!BOUNDARY", "!ECHO\n!BOUNDARY")),
        device=dev))
    texts = []
    for dev in ("cuda", "cpu"):
        with open(o[dev]["log_path"]) as fh:
            texts.append(fh.read())
    echo = mods["echo"].echo_text(o["cpu"]["mesh"], o["cpu"]["cfg"])
    ok = all(t.startswith(echo) for t in texts)
    judge("!ECHO", rel_diff(o["cuda"]["static"].u, o["cpu"]["static"].u),
          len(echo), len(echo), ok,
          extra=f", the echo block ({echo.count(chr(10))} lines) at the top "
          f"of both logs {ok}")


# ---- shells, solid-shells and beams (K1's nd = 6 entry) -------------------
SHELL_A, SHELL_Q, SHELL_E, SHELL_NU = 1000.0, 0.01, 210e3, 0.3
SHELL_T = 50.0      # a/t = 20: sized from the CG counts (PERF.md §6)
SHELL_RESID = "1.0e-9"
SHELL_SOLVER = ("!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
                " 20000, 1\n {resid}, 1.0, 0.0\n")


def shell_cnt(sol="STATIC", bc=" EDGE, 1, 6, 0.0\n",
              loads=f"!DLOAD\n ALL, P0, {SHELL_Q!r}\n", extra="",
              resid="1.0e-8", write="!WRITE, RESULT\n"):
    """A shell or beam deck: the !BOUNDARY rows, the loads, more cards,
    CG with block-Jacobi at ``resid``."""
    return ("!VERSION\n 3\n!SOLUTION, TYPE=" + sol + "\n!BOUNDARY\n" + bc
            + loads + extra + SHELL_SOLVER.format(resid=resid) + write
            + "!END\n")


def phase_k1_nd6_check(sm, bell, meshgen) -> float:
    """K1's nd = 6 element entry against its plain version on cluster
    profiles of element width m = 12 (611 beam line), 18 (731), 24 (741)
    and 54 (743 plate), random element matrices, float32 and float64,
    each launched twice (bit-equal)."""
    err = 0.0
    for m, mesh in ((12, meshgen.beam_line(611, ne=3000)),
                    (18, meshgen.plate_shell(60, etype=731)),
                    (24, meshgen.plate_shell(80, etype=741)),
                    (54, meshgen.plate_shell(40, etype=743))):
        conn = mesh.blocks[0].conn
        plan = bell.build_cluster_profile([conn], mesh.n_node, 6).plan(
            "cuda")
        ke = torch.randn((len(conn), m, m), dtype=torch.float64,
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(m))
        for dt in (torch.float64, torch.float32):
            e = check_k1(sm, plan, [ke], [conn.shape[1]], dt,
                         f"nd = 6, m = {m} ({len(conn)} elements)", nd=6)
            if dt == torch.float64:
                err = max(err, e)
    return err


def plate_center(model) -> int:
    """The node at the plate's centre."""
    return int(np.argmin(np.linalg.norm(
        model.coords[:, :2] - 0.5 * SHELL_A, axis=1)))


def phase_shell_main_path(args, mods, t=SHELL_T,
                          resid=SHELL_RESID) -> dict:
    """The shell cell through run_directory: linear STATIC of a shuffled
    square MITC4 (741) plate of n x n (default 300: 90,601 nodes,
    543,606 dofs, 90,000 elements; 408 gives 1,003,686), a = 1000 mm,
    thickness t (default
    50 mm), E 210 GPa, nu 0.3, clamped on all four edges (all six dofs),
    a uniform pressure q = 0.01 MPa on every element (!DLOAD P0, the
    shell_dload arm); CG with block-Jacobi at nd = 6 to RESID 1e-9 (room
    under the 1e-8 gate for the f64 CG's recurrence residual, which
    drifts from the true one over thousands of iterations), once in the
    CUDA default policy (mixed: f32 cluster CG + f64 refinement; no
    result file) and once in the f64 policy (with !WRITE, RESULT).  Per
    run: CG count, refinement passes, solve s and
    ms a CG iteration, the phase split, peak memory, an independent
    index_add_ true relres (<= 1e-8), the support z reactions against
    q a^2 (1e-8), the centre deflection against the clamped thin-plate
    value 0.00126 q a^4 / D; K1 element launches (nd = 6) = 1, planes
    launches = 1 (the shell's nodal sums).  Returns the cell with the
    model and its element matrices."""
    n = args.shell_n
    wd = os.path.join(ROOT, "build", "smoke", f"shell{n}")
    t0 = time.perf_counter()
    mesh = mods["meshgen"].plate_shell(n, etype=741, a=SHELL_A, thick=t,
                                       youngs=SHELL_E, poisson=SHELL_NU)
    write_shuffled(wd, mods, mesh, shell_cnt(resid=resid),
                   ngroups=("EDGE",))
    log(f"phase shell_workdir: MITC4 plate of {n} x {n} shuffled, "
        f"{mesh.n_node} nodes, {6 * mesh.n_node} dofs, "
        f"{len(mesh.blocks[0].elem_ids)} elements of type 741, a = "
        f"{SHELL_A} mm, t = {t} mm (a/t = {SHELL_A / t:g}), RESID "
        f"{resid}, written in {time.perf_counter() - t0:.2f} s")
    del mesh
    D = SHELL_E * t ** 3 / (12.0 * (1.0 - SHELL_NU ** 2))
    w_ref = 0.00126 * SHELL_Q * SHELL_A ** 4 / D
    load = SHELL_Q * SHELL_A ** 2
    cell = {"n": n, "t": t}
    keys = ("read", "reorder", "model", "element_stiffness", "profile",
            "assembly", "amg_setup", "solve", "stress", "result")
    kes = None
    for policy in ("mixed", "f64"):
        with open(os.path.join(wd, "case.cnt"), "w") as fh:
            fh.write(shell_cnt(resid=resid, write="" if policy == "mixed"
                               else "!WRITE, RESULT\n"))
        calls = {}
        restore = counting(mods, calls)
        reset_kernel_launches(mods)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            out = with_env({"FRONTISTR_TPU_PRECISION": policy},
                           lambda: mods["run_directory"](wd, device="cuda"))
            wall = time.perf_counter() - t0
        finally:
            restore()
        launches = kernel_launch_counts(mods)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res, model = out["static"], out["model"]
        tm = res.timings
        ms_cg = 1e3 * tm.get("solve", 0.0) / max(res.iters, 1)
        if kes is None:
            kes = mods["static"].compute_element_stiffness(model)
        rr = true_relres(model, res.u, kes)
        fz = [d for d in model.fixed_dofs if d % 6 == 2]
        rz = float(res.reaction.reshape(-1)[fz].sum())
        w_c = float(res.u[plate_center(model), 2])
        log(f"phase shell_main_path ({policy}): {wall:.2f} s; policy="
            f"{res.policy} cg_iters={res.iters} passes={res.passes} "
            f"relres={res.relres!r} true_relres={rr!r} ({ms_cg:.3f} ms a "
            f"CG iteration) K1 launches={launches['K1']} (element, "
            f"nd = 6), K1 planes launches={launches['K1 planes']}, peak "
            f"device memory {peak_gb:.3f} GB")
        log("  phase seconds: " + " ".join(f"{k}={tm.get(k, 0.0):.3f}"
                                           for k in keys))
        log(f"  support z reactions {rz!r} against the load q a^2 = "
            f"{load!r} (rel {abs(rz + load) / load!r}); centre deflection "
            f"{w_c!r} mm, clamped thin plate 0.00126 q a^4/D = {w_ref!r} "
            f"(gap {w_c / w_ref - 1.0:+.4%})")
        if res.policy != policy:
            raise AssertionError(f"shell_main_path: policy {res.policy}")
        if not (res.u.shape == (model.n_node, 6) and
                np.isfinite(res.u).all()):
            raise AssertionError("shell_main_path: displacements not "
                                 "finite or of the wrong shape")
        if not (res.relres <= 1e-8 and rr <= 1e-8):
            raise AssertionError(f"shell_main_path ({policy}): relres "
                                 "above 1e-8")
        if not abs(rz + load) <= 1e-8 * load:
            raise AssertionError("shell_main_path: the support reactions "
                                 "do not balance the load")
        if SHELL_A / t >= 100 and not abs(w_c / w_ref - 1.0) <= 0.02:
            raise AssertionError("shell_main_path: centre deflection off "
                                 "the thin-plate value by more than 2%")
        if launches["K1"] != 1 or launches["K1 planes"] != 1:
            raise AssertionError(f"shell_main_path: kernel launches "
                                 f"{launches}, expected K1 1 and K1 "
                                 "planes 1")
        cell[policy] = {"launches": launches["K1"],
                        "planes_launches": launches["K1 planes"],
                        "cg_iters": res.iters, "passes": res.passes,
                        "ms_per_cg_iter": ms_cg, "wall_s": wall,
                        "peak_gb": peak_gb, "true_relres": rr,
                        "support_rz": rz, "w_center": w_c,
                        "w_thin_plate": w_ref,
                        "phase_s": {k: tm.get(k, 0.0) for k in keys}}
        del out, res
    cell.update(model=model, kes=kes)
    return cell


def phase_k1_nd6_time(mods, model, kes, cell) -> dict:
    """K1's nd = 6 element entry on the shell cell's cluster profile
    (m = 24) with its element matrices, float64 and float32: held to its
    plain version, timed with it and with one index_add_ of the entries
    in slot order, against its bytes bound (pairs x 36 values read once,
    slots x 36 written once, the pair and slot indices read once).
    Returns the kernels-line row."""
    sm, bell = mods["segsum"], mods["bell"]
    plan = bell.cluster_profile_from_model(model).plan("cuda")
    nns = [b.conn.shape[1] for b in model.blocks]
    P, S = plan.perm.numel(), plan.n_slots
    row = {}
    for dt in (torch.float64, torch.float32):
        kd = [k.to(dt).contiguous() for k in kes]
        err = check_k1(sm, plan, kd, nns, dt, "shell cell m = 24", nd=6)
        ms = cuda_ms(lambda: sm.segsum(plan, kd, nns, 6))
        plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, nns, 6))
        ent = sm.entry_planes(kd, nns, 6)[:, plan.perm.long()]
        out = torch.zeros((36, S), dtype=dt, device="cuda")
        seg = plan.seg_sorted.long()
        library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
        del ent, out, kd
        isz = 8 if dt == torch.float64 else 4
        nbytes = P * 36 * isz + S * 36 * isz + P * 4 + (S + 1) * 4
        bound_ms, bound_by = bound(nbytes, 36 * P, dt)
        log(f"phase k1_nd6_time: {kes[0].shape[0]} MITC4 elements, "
            f"P={P} pairs, n_slots={S} {str(dt)[6:]}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB: {P} x 36 "
            f"read + {S} x 36 written + indices)")
        row[str(dt)[6:]] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms,
                                bound_by=bound_by, bytes=nbytes)
    f64 = row["float64"]
    return {"name": "segsum_nd6",
            "entry": "element, nd = 6, m = 24 (MITC4 plate)",
            "route": "cuda", "source": "frontistr_tpu_torch/csrc/segsum.cu",
            "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
            "launches": cell["mixed"]["launches"],
            "max_abs_err": f64["max_abs_err"], "ms": f64["ms"],
            "plain_ms": f64["plain_ms"], "bound_ms": f64["bound_ms"],
            "bound_by": f64["bound_by"], "library_ms": f64["library_ms"],
            "float32": row["float32"],
            "shell_main_path": {k: v for k, v in cell.items()
                                if k not in ("model", "kes")}}


def phase_shell_small_reference(mods) -> None:
    """Small shell, solid-shell and beam decks on the card and on the CPU
    (which the CPU tests hold to the JAX package), f64 policy: warped
    731 and 741 plates in STATIC under pressure and a body force; a 743
    plate's STATIC solve through the library (its stress recovery is
    refused, as the JAX package's fails); the 761 and 781 cantilevers;
    a 611 beam under a tip load, an axial force and a torque; a 641
    cantilever's fiber stresses; the shell strip in NLSTATIC (2
    substeps), EIGEN and implicit DYNAMIC.  Each: fields within 1e-10 of
    the largest, counts equal (the solid-shells' CG within 2)."""
    mg, run = mods["meshgen"], mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "shell_small")
    strip = mg.plate_shell(8, 1, etype=741, a=2.0, b=0.25, thick=0.1,
                           youngs=1.0e6, poisson=0.0, density=1.0)
    r, area = 0.05, np.pi * 0.05 ** 2
    iy = np.pi * r ** 4 / 4.0
    fiber = mg.beam_line(641, 4, 1.0, (0.0, 0.0, 1.0, area, iy, iy, 2 * iy),
                         (210e9, 0.3, r, 0.0, 90.0, 180.0, 270.0, 45.0,
                          135.0), density=7.8e3)
    dyn = ("!DYNAMIC\n 1, 1\n 0.0, 0.01, 20, 5.0e-4\n 0.5, 0.25\n"
           " 1, 1, 0.0, 0.0\n 10, 0, 1\n")
    p_loads = f"!DLOAD\n ALL, P0, {SHELL_Q!r}\n ALL, BX, 0.001\n"
    cases = [
        ("plate731", mg.plate_shell(6, etype=731, a=SHELL_A, thick=50.0,
                                    warp=0.15), ("EDGE",),
         shell_cnt(loads=p_loads), "static", 0),
        ("plate741", mg.plate_shell(6, etype=741, a=SHELL_A, thick=50.0,
                                    warp=0.15), ("EDGE",),
         shell_cnt(loads=p_loads), "static", 0),
        ("ss761", mg.solid_shell_strip(761), ("FIX", "TIP"),
         shell_cnt(bc=" FIX, 1, 3, 0.0\n", loads="!CLOAD\n TIP, 3, -0.5\n",
                   resid="1.0e-10"), "static", 2),
        ("ss781", mg.solid_shell_strip(781), ("FIX", "TIP"),
         shell_cnt(bc=" FIX, 1, 3, 0.0\n", loads="!CLOAD\n TIP, 3, -0.5\n",
                   resid="1.0e-10"), "static", 2),
        ("beam611", mg.beam_line(611), ("FIX", "TIP"),
         shell_cnt(bc=" FIX, 1, 6, 0.0\n", loads="!CLOAD\n TIP, 3, -1.0\n"
                   " TIP, 1, 5.0\n TIP, 4, 2.0\n", resid="1.0e-12"),
         "static", 0),
        ("beam641", fiber, ("FIX", "TIP"),
         shell_cnt(bc=" FIX, 1, 3, 0.0\n", loads="!CLOAD\n TIP, 2, "
                   "-100.0\n", resid="1.0e-12"), "static", 0),
        ("strip_nlstatic", strip, ("X0", "X1"),
         shell_cnt("NLSTATIC", " X0, 1, 6, 0.0\n", "!CLOAD\n X1, 3, -0.05\n"
                   " X1, 1, 0.2\n", "!STEP, SUBSTEPS=2\n",
                   resid="1.0e-10"), "static", 0),
        ("strip_eigen", strip, ("X0", "X1"),
         shell_cnt("EIGEN", " X0, 1, 6, 0.0\n", "",
                   "!EIGEN\n 3, 1.0e-8, 60\n", resid="1.0e-10"), "eigen", 0),
        ("strip_dynamic", strip, ("X0", "X1"),
         shell_cnt("DYNAMIC", " X0, 1, 6, 0.0\n", "!CLOAD\n X1, 3, -5.0\n",
                   dyn, resid="1.0e-14"), "dynamic", 0),
    ]
    for name, mesh, groups, cnt, key, slack in cases:
        wd = write_shuffled(os.path.join(base, name), mods, mesh, cnt,
                            ngroups=groups)
        n0 = mods["segsum"].segsum.launches
        got = with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                       lambda: [run(wd, device=d)[key]
                                for d in ("cuda", "cpu")])
        k1 = mods["segsum"].segsum.launches - n0
        a, b = got
        if key == "eigen":
            fields = {"eigenvalues": (a.eigenvalues, b.eigenvalues)}
            counts = (a.iters, b.iters)
        elif key == "dynamic":
            fields = {k: (getattr(a, k), getattr(b, k))
                      for k in ("u", "vel", "acc")}
            counts = tuple(sum(sum(h["cg"]) for h in r.history)
                           for r in (a, b))
        else:
            fields = {k: (getattr(a, k), getattr(b, k))
                      for k in ("u", "nodal_stress", "elem_stress")}
            counts = (a.iters, b.iters)
        diffs = {k: rel_diff(x, y) for k, (x, y) in fields.items()}
        log(f"phase shell_small_reference: {name} {key}, cuda vs cpu "
            + " ".join(f"{k} {v!r}" for k, v in diffs.items())
            + f", counts {counts[0]} vs {counts[1]}, K1 launches {k1}")
        if not all(v <= 1e-10 for v in diffs.values()):
            raise AssertionError(f"shell_small_reference: {name} fields "
                                 "differ")
        if abs(counts[0] - counts[1]) > slack:
            raise AssertionError(f"shell_small_reference: {name} counts "
                                 "differ")
        if key == "static" and name != "strip_nlstatic" and k1 < 1:
            raise AssertionError(f"shell_small_reference: {name} did not "
                                 "launch K1")
    # the MITC9 plate: run_directory refuses its stress recovery by name;
    # its STATIC solve through the library on both devices
    wd = write_shuffled(os.path.join(base, "plate743"), mods,
                        mg.plate_shell(4, etype=743, a=SHELL_A, thick=50.0,
                                       warp=0.15), shell_cnt(),
                        ngroups=("EDGE",))
    try:
        run(wd, device="cuda")
        raise AssertionError("shell_small_reference: the 743 STATIC run "
                             "was not refused")
    except NotImplementedError as e:
        log(f"  plate743 run_directory refused: {e}")
    sols = []
    for dev in ("cuda", "cpu"):
        mesh = mods["read_mesh"](os.path.join(wd, "mesh.msh"))
        model = mods["build_struct_model"](
            mesh, mods["read_cnt"](os.path.join(wd, "case.cnt")), device=dev)
        kes = mods["static"].compute_element_stiffness(model)
        sols.append(with_env({"FRONTISTR_TPU_PRECISION": "f64"},
                             lambda: mods["static"].solve_linear(model, kes)))
    d = rel_diff(sols[0].x, sols[1].x)
    log(f"phase shell_small_reference: plate743 solve_linear, cuda vs cpu "
        f"u {d!r}, cg {sols[0].iters} vs {sols[1].iters}")
    if not (d <= 1e-10 and sols[0].iters == sols[1].iters):
        raise AssertionError("shell_small_reference: plate743 differs")


# ---- the u-p flow (3414, K1 at nd = 4), the band Cholesky, PRECHECK -------
# the lid-driven cavity at Re = 100 (Ghia, Ghia & Shin 1982): every wall
# no-slip, the lid Z1 sliding at v_x = 1 (its rows last), rho 1, mu 0.01
FLOW_WALLS = ("X0", "X1", "Y0", "Y1", "Z0", "Z1")
FLOWCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC, TYPE=NONLINEAR\n"
           " 1, 1\n 0.0, {t_end!r}, {n_step}, {dt!r}\n 0.5, 0.25\n"
           " 1, 1, 0.0, 0.0\n 1, 0, 1\n!BOUNDARY\n X0, 1, 3, 0.0\n"
           " X1, 1, 3, 0.0\n Y0, 1, 3, 0.0\n Y1, 1, 3, 0.0\n Z0, 1, 3, 0.0\n"
           " Z1, 1, 1, 1.0\n Z1, 2, 3, 0.0\n!MATERIAL, NAME=M1\n"
           "!FLUID, TYPE=INCOMP_NEWTONIAN\n {mu!r}\n!DENSITY\n 1.0\n"
           "!SOLVER, METHOD=BICGSTAB, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
           " 20000, 1\n {resid}, 1.0, 0.0\n{write}!END\n")
FLOW_MU = 0.01
FLOW_CONVERG = 1.0e-8    # !STEP's default CONVERG, which the deck keeps


def flow_mesh(mods, n):
    """``box_tet4(n, n, n)`` on the unit cube, its block made 3414."""
    m = mods["box_tet4"](n, n, n)
    m.blocks = [dataclasses.replace(m.blocks[0], etype=3414)]
    return m


def flow_cnt(n_step, dt, mu=FLOW_MU, resid="1.0e-8", write=True):
    return FLOWCNT.format(t_end=n_step * dt, n_step=n_step, dt=dt, mu=mu,
                          resid=resid,
                          write="!WRITE, RESULT\n" if write else "")


def flow_divergence(mesh, fr) -> tuple:
    """(sum of div v . volume, sum of |div v| . volume) over the elements,
    div v the trace of each element's strain rate (constant on a P1
    tet), the volumes from the coordinates."""
    conn = torch.as_tensor(np.asarray(mesh.blocks[0].conn, np.int64),
                           device="cuda")
    x = torch.as_tensor(mesh.coords, dtype=torch.float64, device="cuda")[conn]
    vol = torch.linalg.det(x[:, 1:] - x[:, :1]).abs() / 6.0
    div = torch.as_tensor(fr.strain[:, :3].sum(axis=1), device="cuda")
    return float((div * vol).sum()), float((div.abs() * vol).sum())


def phase_flow_main_path(args, mods) -> dict:
    """The flow cell through run_directory: the lid-driven cavity at
    Re = 100 on a shuffled box_tet4(n) unit cube made 3414 (default
    n = 62: 250,047 nodes, 1,000,188 dofs, 1,429,968 elements), dt = h/U
    = 1/n, ``--flow-steps`` steps (2) of !DYNAMIC, BiCGSTAB with
    block-Jacobi to RESID 1e-8, !WRITE, RESULT.  Per step: the BiCGSTAB
    count and ms an iteration of every solve, the final residual; the
    phase split and peak memory.  Held to: the lid exact, every step's
    final residual <= CONVERG (1e-8) and finite fields, global mass
    conserved (sum div v . vol <= 1e-10 of sum |div v| . vol); K1's
    element entry (nd = 4) once a step, its planes entry (the
    right-hand side) once a step.  Returns the cell with the first
    step's profile and element matrices."""
    n, steps = args.flow_n, args.flow_steps
    dt = 1.0 / n
    wd = os.path.join(ROOT, "build", "smoke", f"flow{n}")
    t0 = time.perf_counter()
    mesh = flow_mesh(mods, n)
    write_shuffled(wd, mods, mesh, flow_cnt(steps, dt), ngroups=FLOW_WALLS)
    log(f"phase flow_workdir: box_tet4({n}) shuffled, {mesh.n_node} nodes, "
        f"{4 * mesh.n_node} dofs, {len(mesh.blocks[0].elem_ids)} elements "
        f"of type 3414, Re = {1.0 / FLOW_MU:g}, dt = {dt!r}, {steps} steps;"
        f" written in {time.perf_counter() - t0:.2f} s")
    del mesh
    ell = mods["ell"]
    first = {}
    real = ell.from_blocks

    def spied(profile, kes, nns, free):
        if not first:
            first.update(profile=profile, K=kes[0])
        return real(profile, kes, nns, free)
    ell.from_blocks = spied
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = mods["run_directory"](wd, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        ell.from_blocks = real
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fr, rmesh = out["flow"], out["mesh"]
    tm = out["timings"]
    keys = ("read", "reorder", "profile", "element", "assembly", "rhs",
            "solve", "stress", "result")
    log(f"phase flow_main_path: {wall:.2f} s; {fr.steps} steps, {fr.iters} "
        f"linear solves; K1 launches={launches['K1']} (element, nd = 4), "
        f"K1 planes launches={launches['K1 planes']}; peak device memory "
        f"{peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(f"{k}={tm.get(k, 0.0):.3f}"
                                       for k in keys))
    rows = []
    for h in fr.history:
        ms = [1e3 * s / max(c, 1) for c, s in zip(h["bicgstab"],
                                                  h["solve_s"])]
        log(f"  step {h['step']}: bicgstab {h['bicgstab']} in "
            f"{[round(s, 3) for s in h['solve_s']]} s ("
            f"{[round(v, 3) for v in ms]} ms an iteration), final residual "
            f"{h['resid']!r}")
        rows.append({"bicgstab": h["bicgstab"], "solve_s": h["solve_s"],
                     "ms_per_iter": ms, "resid": h["resid"]})
    lid = rmesh.node_groups["Z1"]
    lid_ok = bool(np.all(fr.v[lid, 0] == 1.0) and
                  np.all(fr.v[lid, 1:3] == 0.0))
    net, total = flow_divergence(rmesh, fr)
    log(f"  lid exact: {lid_ok}; sum div v . vol = {net!r}, sum |div v| . "
        f"vol = {total!r} (ratio {abs(net) / total!r}); max |v| "
        f"{float(np.abs(fr.v[:, :3]).max())!r}, pressure range "
        f"[{float(fr.v[:, 3].min())!r}, {float(fr.v[:, 3].max())!r}]")
    for f in (fr.v, fr.strain, fr.stress):
        if not np.isfinite(f).all():
            raise AssertionError("flow_main_path: fields not finite")
    if fr.v.shape != (rmesh.n_node, 4) or fr.steps != steps:
        raise AssertionError("flow_main_path: wrong shape or step count")
    if not lid_ok:
        raise AssertionError("flow_main_path: the lid condition does not "
                             "hold exactly")
    if not all(h["resid"] <= FLOW_CONVERG for h in fr.history):
        raise AssertionError("flow_main_path: a step ends above CONVERG")
    if not abs(net) <= 1e-10 * total:
        raise AssertionError("flow_main_path: global mass not conserved")
    if launches["K1"] != steps or launches["K1 planes"] != steps:
        raise AssertionError(f"flow_main_path: kernel launches {launches}, "
                             f"expected K1 {steps} and K1 planes {steps}")
    # the element routine alone: its peak above what the run left
    # allocated, at the cell's shapes (a field at rest moves the same
    # bytes)
    fluid = mods["fluid"]
    xyz = torch.as_tensor(rmesh.coords, dtype=torch.float64, device="cuda")
    conn = torch.as_tensor(np.asarray(rmesh.blocks[0].conn, np.int64),
                           device="cuda")
    vn = xyz.new_zeros((rmesh.n_node, 4))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    K, b = fluid.element_system(mods["get_table"](3414), xyz, conn, vn,
                                FLOW_MU, 1.0, dt)
    torch.cuda.synchronize()
    elem_s = time.perf_counter() - t0
    elem_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    out_gb = (K.numel() + b.numel()) * 8 / 1e9
    del K, b, xyz, conn, vn
    log(f"  element routine alone: {elem_s:.3f} s, peak {elem_gb:.3f} GB "
        f"above the run's leftovers, {out_gb:.3f} GB of it K and b "
        f"(chunks of {fluid.CHUNK} elements)")
    return {"n": n, "steps": steps, "wall_s": wall, "peak_gb": peak_gb,
            "element_s": elem_s, "element_peak_gb": elem_gb,
            "launches": launches["K1"],
            "planes_launches": launches["K1 planes"], "step_rows": rows,
            "phase_s": {k: tm.get(k, 0.0) for k in keys},
            "mass_ratio": abs(net) / total, **first}


def phase_k1_nd4_time(mods, cell) -> dict:
    """K1's nd = 4 element entry at the flow cell's scalar-ELL plan with
    its first step's element matrices (not symmetric), float64 and
    float32: held to its plain version, a relaunch bit-equal, timed with
    it and with one index_add_ of the entries in slot order, against its
    bytes bound (the pairs' 16 values read once, the slots' 16 written
    once, the pair and slot indices read once).  Returns the
    kernels-line row."""
    sm = mods["segsum"]
    plan = cell["profile"].plan("cuda")
    P, S = plan.perm.numel(), plan.n_slots
    row = {}
    for dt in (torch.float64, torch.float32):
        kd = [cell["K"].to(dt).contiguous()]
        err = check_k1(sm, plan, kd, [4], dt, "flow cell", nd=4)
        ms = cuda_ms(lambda: sm.segsum(plan, kd, [4], 4))
        plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, kd, [4], 4))
        ent = sm.entry_planes(kd, [4], 4)[:, plan.perm.long()]
        out = torch.zeros((16, S), dtype=dt, device="cuda")
        seg = plan.seg_sorted.long()
        library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent))
        del ent, out, kd
        isz = 8 if dt == torch.float64 else 4
        nbytes = P * 16 * isz + S * 16 * isz + P * 4 + (S + 1) * 4
        bound_ms, bound_by = bound(nbytes, 16 * P, dt)
        log(f"phase k1_nd4_time: {cell['K'].shape[0]} 3414 elements, P={P} "
            f"pairs, n_slots={S} {str(dt)[6:]}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB: {P} x 16 read + "
            f"{S} x 16 written + indices)")
        row[str(dt)[6:]] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms,
                                bound_by=bound_by, bytes=nbytes)
    f64 = row["float64"]
    return {"name": "segsum_nd4",
            "entry": "element, nd = 4, m = 16 (u-p flow 3414, scalar ELL)",
            "route": "cuda", "source": "frontistr_tpu_torch/csrc/segsum.cu",
            "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
            "launches": cell["launches"],
            "max_abs_err": f64["max_abs_err"], "ms": f64["ms"],
            "plain_ms": f64["plain_ms"], "bound_ms": f64["bound_ms"],
            "bound_by": f64["bound_by"], "library_ms": f64["library_ms"],
            "float32": row["float32"],
            "flow_main_path": {k: v for k, v in cell.items()
                               if k not in ("profile", "K")}}


def spy_band(mods, made: list):
    """Make the band factor of dynamics and eigen record, a dict per
    factor in ``made``: its stats and the seconds of each solve.
    Returns the undo."""
    real = mods["band"].BandCholesky

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rec = {"stats": self.stats(), "blocks": self.nblk,
                        "solve_s": []}
            made.append(self.rec)

        def solve(self, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = super().solve(b)
            torch.cuda.synchronize()
            self.rec["solve_s"].append(time.perf_counter() - t0)
            return x
    for m in (mods["dynamic"], mods["eigen"]):
        m.BandCholesky = Recorded

    def undo():
        for m in (mods["dynamic"], mods["eigen"]):
            m.BandCholesky = real
    return undo


def band_run(mods, wd, device="cuda"):
    """run_directory with FRONTISTR_TPU_DIRECT=band, the factors
    recorded; (output, [factor records], wall s, peak GB)."""
    made = []
    undo = spy_band(mods, made)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = with_env({"FRONTISTR_TPU_DIRECT": "band"},
                       lambda: mods["run_directory"](wd, device=device))
        wall = time.perf_counter() - t0
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else 0.0
    return out, made, wall, peak


def log_band(label, made, wall, peak, n_dof) -> dict:
    st = made[0]["stats"]
    solve = made[0]["solve_s"]
    nblk = made[0]["blocks"]
    reckoned = n_dof * (st["band"] // st["nb"] + 1) * st["nb"] * 8
    log(f"  {label}: {wall:.2f} s; factor {st['factor_s']:.3f} s, "
        f"{len(solve)} solves at {1e3 * float(np.mean(solve)):.3f} ms (two "
        f"sweeps of {nblk} block steps), band {st['band']} dofs, nb = "
        f"{st['nb']}, stored {st['bytes'] / 1e9:.3f} GB (N B nb 8 = "
        f"{reckoned / 1e9:.3f} GB), peak device memory {peak:.3f} GB")
    return {"wall_s": wall, "factor_s": st["factor_s"],
            "solve_ms": 1e3 * float(np.mean(solve)), "solves": len(solve),
            "band": st["band"], "nb": st["nb"], "bytes": st["bytes"],
            "blocks": nblk, "peak_gb": peak, "factors": len(made)}


def phase_band(args, mods, eigen_wd, er_cg) -> dict:
    """FRONTISTR_TPU_DIRECT=band on the card: (1) EIGEN on the eigen
    cell's work directory (the 100 mm box_hex8(e) cube) with
    METHOD=DIRECT, its eigenvalues against the CG arm's (``er_cg``)
    within 1e-8; (2) implicit Newmark on a shuffled box_hex8(e) (the
    eigen cell's box), 3 steps of 20 x the critical step, METHOD=DIRECT
    band against the CG arm at RESID 1e-12 within 1e-8; (3) the direct
    cell's box_hex8(d) in EIGEN and DYNAMIC, band against host SuperLU
    within 1e-8.  Each: factor s, solve ms, band width, bytes, peak
    memory."""
    rows = {}
    with open(os.path.join(eigen_wd, "case.cnt"), "w") as fh:
        fh.write(EIGCNT.format(sol="EIGEN", nget=10, loads="", step="",
                               nier=20000).replace("METHOD=CG",
                                                   "METHOD=DIRECT"))
    out, made, wall, peak = band_run(mods, eigen_wd)
    er = out["eigen"]
    rel = float(np.abs(er.eigenvalues - er_cg.eigenvalues).max() /
                np.abs(er_cg.eigenvalues).max())
    log(f"phase band (eigen, box_hex8({args.eigen_n}), "
        f"{out['model'].n_dof_total} dofs): lanczos_iters={er.iters} "
        f"(CG arm {er_cg.iters}), eigenvalues against the CG arm's {rel!r}")
    rows["eigen"] = log_band("eigen", made, wall, peak,
                             out["model"].n_dof_total)
    rows["eigen"]["rel_eigenvalues"] = rel
    del out, er, made
    torch.cuda.empty_cache()
    if not rel <= 1e-8:
        raise AssertionError("band: eigenvalues off the CG arm's")

    h = args.eigen_n
    mesh = mods["box_hex8"](h, h, h)
    dt = 20.0 * critical_step(mesh)
    wd = os.path.join(ROOT, "build", "smoke", f"band_dyn{h}")
    write_dyn_workdir(wd, mods, mesh, 3 * dt, lambda m: dyn_cnt(
        1, 3, dt, ray_m=1.0e3, ray_k=1.0e-9, resid="1.0e-12"))
    n_dof = 3 * mesh.n_node
    del mesh
    t0 = time.perf_counter()
    dc = mods["run_directory"](wd, device="cuda")["dynamic"]
    wall_cg = time.perf_counter() - t0
    cnt_path = os.path.join(wd, "case.cnt")
    with open(cnt_path) as fh:
        cnt = fh.read()
    with open(cnt_path, "w") as fh:
        fh.write(cnt.replace("METHOD=CG", "METHOD=DIRECT"))
    out, made, wall, peak = band_run(mods, wd)
    db = out["dynamic"]
    rel = max(rel_diff(getattr(db, k), getattr(dc, k))
              for k in ("u", "vel", "acc"))
    log(f"phase band (implicit dynamics, box_hex8({h}), {n_dof} dofs, 3 "
        f"steps): CG arm {wall_cg:.2f} s ({[sum(x['cg']) for x in dc.history]}"
        f" CG a step); band arm against it {rel!r}")
    rows["dynamic"] = log_band("dynamic", made, wall, peak, n_dof)
    rows["dynamic"]["rel_cg"] = rel
    del out, db, dc, made
    torch.cuda.empty_cache()
    if not rel <= 1e-8:
        raise AssertionError("band: implicit dynamics off the CG arm")

    d = args.direct_n
    base = os.path.join(ROOT, "build", "smoke", f"band_direct{d}")
    mesh = mods["box_hex8"](d, d, d, lx=100.0, ly=100.0, lz=100.0)
    dt = 20.0 * critical_step(mesh)
    decks = {"eigen": EIGCNT.format(sol="EIGEN", nget=5, loads="", step="",
                                    nier=20000),
             "dynamic": dyn_cnt(1, 3, dt, ray_m=1.0e3, ray_k=1.0e-9)}
    for key, cnt in decks.items():
        wd = os.path.join(base, key)
        if key == "eigen":
            write_shuffled(wd, mods, mesh, cnt.replace("METHOD=CG",
                                                       "METHOD=DIRECT"))
        else:
            write_dyn_workdir(wd, mods, mesh, 3 * dt, lambda m: cnt.replace(
                "METHOD=CG", "METHOD=DIRECT"))
        a, made, wall, peak = band_run(mods, wd)
        b = mods["run_directory"](wd, device="cuda")
        if key == "eigen":
            rel = rel_diff(a["eigen"].eigenvalues, b["eigen"].eigenvalues)
        else:
            rel = max(rel_diff(getattr(a["dynamic"], k),
                               getattr(b["dynamic"], k))
                      for k in ("u", "vel", "acc"))
        log(f"phase band (direct cell box_hex8({d}), {key}): band against "
            f"SuperLU {rel!r}")
        rows[f"direct_{key}"] = log_band(key, made, wall, peak,
                                         3 * mesh.n_node)
        rows[f"direct_{key}"]["rel_superlu"] = rel
        if not rel <= 1e-8:
            raise AssertionError(f"band: {key} off SuperLU at the direct "
                                 "cell")
    return rows


def phase_flow_band_small_reference(mods) -> None:
    """Small decks on the card and on the CPU (which the CPU tests hold
    to the JAX package): the cavity on box_tet4(4) made 3414 (2 steps,
    mu 0.01), band EIGEN on a 400 x 100 x 70 hex8 beam and band Newmark
    on box_hex8(3, 2, 2), PRECHECK and NZPROF on a tet box.  Fields
    within 1e-8, counts equal (BiCGSTAB within 10% + 2), the PRECHECK
    0.log and the NZPROF files equal."""
    run = mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "flow_band_small")
    wd = write_shuffled(os.path.join(base, "cavity"), mods,
                        flow_mesh(mods, 4), flow_cnt(2, 0.25),
                        ngroups=FLOW_WALLS)
    a, b = (run(wd, device=dev)["flow"] for dev in ("cuda", "cpu"))
    d = max(rel_diff(x, y) for x, y in ((a.v, b.v), (a.strain, b.strain),
                                        (a.stress, b.stress)))
    ca = [c for h in a.history for c in h["bicgstab"]]
    cb = [c for h in b.history for c in h["bicgstab"]]
    log(f"phase flow_band_small_reference: cavity, cuda vs cpu {d!r}, "
        f"bicgstab {ca} vs {cb}")
    if not (d <= 1e-8 and len(ca) == len(cb) and
            all(abs(p - q) <= 0.1 * q + 2 for p, q in zip(ca, cb))):
        raise AssertionError("flow_band_small_reference: cavity differs")
    beam = mods["box_hex8"](4, 2, 2, lx=400.0, ly=100.0, lz=70.0)
    wd = write_shuffled(os.path.join(base, "eigen"), mods, beam,
                        EIGCNT.format(sol="EIGEN", nget=3, loads="", step="",
                                      nier=20000).replace("METHOD=CG",
                                                          "METHOD=DIRECT"))
    ea, eb = (band_run(mods, wd, dev)[0]["eigen"] for dev in ("cuda", "cpu"))
    d = rel_diff(ea.eigenvalues, eb.eigenvalues)
    log(f"phase flow_band_small_reference: band eigen, cuda vs cpu {d!r}, "
        f"lanczos {ea.iters} vs {eb.iters}")
    if not (d <= 1e-8 and ea.iters == eb.iters):
        raise AssertionError("flow_band_small_reference: band eigen differs")
    small = mods["box_hex8"](3, 2, 2)
    dt = 20.0 * critical_step(small)
    wd = os.path.join(base, "dynamic")
    write_dyn_workdir(wd, mods, small, 4 * dt, lambda m: dyn_cnt(
        1, 4, dt, ray_m=1.0e3, ray_k=1.0e-9).replace("METHOD=CG",
                                                     "METHOD=DIRECT"))
    da, db = (band_run(mods, wd, dev)[0]["dynamic"] for dev in ("cuda", "cpu"))
    d = max(rel_diff(getattr(da, k), getattr(db, k))
            for k in ("u", "vel", "acc"))
    log(f"phase flow_band_small_reference: band dynamics, cuda vs cpu {d!r}")
    if not d <= 1e-8:
        raise AssertionError("flow_band_small_reference: band dynamics "
                             "differs")
    for sol in ("PRECHECK", "NZPROF"):
        files = {}
        for dev in ("cuda", "cpu"):
            wd = write_shuffled(os.path.join(base, f"{sol}_{dev}"), mods,
                                mods["box_tet4"](4, 3, 2),
                                f"!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!END\n")
            run(wd, device=dev)
            files[dev] = {}
            for name in ("0.log", "nonzero.dat.000", "nonzero.plt.000"):
                if os.path.exists(os.path.join(wd, name)):
                    with open(os.path.join(wd, name), "rb") as fh:
                        files[dev][name] = fh.read()
        log(f"phase flow_band_small_reference: {sol}, files "
            f"{sorted(files['cuda'])}, cuda = cpu: "
            f"{files['cuda'] == files['cpu']}")
        if files["cuda"] != files["cpu"] or "0.log" not in files["cuda"] or \
                (sol == "NZPROF") != ("nonzero.dat.000" in files["cuda"]):
            raise AssertionError(f"flow_band_small_reference: {sol} differs")


# ---- PR: input formats, refinement, HECMW-DIST and pictures ----------------
# the visual cell's deck: the tet cell's STATIC deck and solver card, the
# PVR volume of the result on the card (500 x 500, res 96, 160 slices)
VISCNT = CNT.replace("!END\n", "!WRITE, VISUAL\n!VISUAL, METHOD=PVR\n!END\n")
VISUAL_N = 34
# the NASTRAN bulk data of tests/test_nastran.py (a unit cube, CHEXA with a
# continuation line, MAT1 with a NASTRAN exponent)
NASTRAN_BULK = ("$ cube under uniaxial load\nBEGIN BULK\nGRID,1,,0.0,0.0,0.0\n"
                "GRID,2,,1.0,0.0,0.0\nGRID,3,,1.0,1.0,0.0\n"
                "GRID,4,,0.0,1.0,0.0\n"
                "GRID    5               0.0     0.0     1.0\n"
                "GRID    6               1.0     0.0     1.0\n"
                "GRID    7               1.0     1.0     1.0\n"
                "GRID    8               0.0     1.0     1.0\n"
                "CHEXA,1,10,1,2,3,4,5,6,\n+,7,8\nPSOLID,10,100\n"
                "MAT1,100,210000.,,0.3,7.85-9\nENDDATA\n")
NASTRAN_CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n"
               " 1, 1, 3, 0.0\n 2, 2, 3, 0.0\n 3, 3, 3, 0.0\n 4, 3, 3, 0.0\n"
               "!CLOAD\n"
               " 5, 3, 25.0\n 6, 3, 25.0\n 7, 3, 25.0\n 8, 3, 25.0\n"
               "!SOLVER,METHOD=CG,PRECOND=1\n 10000, 1\n 1.0e-12, 1.0, 0.0\n"
               "!END\n")


def write_abaqus(path, mesh, name):
    """``mesh`` (one solid block) as an ABAQUS ``.inp``: *NODE, *ELEMENT
    of type ``name`` (rows in the HEC-MW node order, which ABAQUS shares
    for C3D4, C3D8 and C3D10), *NSET X0 and X1, *SOLID SECTION,
    *MATERIAL with *ELASTIC 210000, 0.3."""
    b = mesh.blocks[0]
    conn = b.conn_hecmw if b.conn_hecmw is not None else b.conn
    ids = np.asarray(mesh.node_ids)
    rows = np.concatenate([np.asarray(b.elem_ids, np.int64)[:, None],
                           ids[np.asarray(conn, np.int64)]], axis=1)
    with open(path, "w") as f:
        f.write("*HEADING\n generated box\n*NODE\n")
        f.writelines(f"{int(g)}, {x!r}, {y!r}, {z!r}\n" for g, (x, y, z)
                     in zip(ids, mesh.coords.tolist()))
        f.write(f"*ELEMENT, TYPE={name}, ELSET=EALL\n")
        f.writelines(", ".join(map(str, r)) + "\n" for r in rows.tolist())
        for g in ("X0", "X1"):
            f.write(f"*NSET, NSET={g}\n")
            sel = ids[np.sort(mesh.node_groups[g])]
            for k in range(0, len(sel), 16):
                f.write(", ".join(str(int(v)) for v in sel[k:k + 16]) + "\n")
        f.write("*SOLID SECTION, ELSET=EALL, MATERIAL=M1\n"
                "*MATERIAL, NAME=M1\n*ELASTIC\n 210000., 0.3\n")


def write_geofem(path, mesh):
    """A single-PE GEOFEM grid of a ``box_tet4`` mesh (tet4 as 311) with
    its X0 and X1 node groups (the writer of tests/test_geofem.py)."""
    with open(path, "w") as f:
        f.write(f"0 0\n\n{mesh.n_node} {mesh.n_node}\n")
        for g, (x, y, z) in zip(mesh.node_ids, mesh.coords.tolist()):
            f.write(f"{int(g)} {x!r} {y!r} {z!r}\n")
        conn = mesh.blocks[0].conn
        f.write(f"{len(conn)}\n" + " ".join(["311"] * len(conn)) + "\n")
        for e, row in enumerate(conn):
            f.write(f"{e + 1} " + " ".join(str(int(mesh.node_ids[n]))
                                           for n in row) + "\n")
        f.write("\n\n2\n")
        n0, n1 = (len(mesh.node_groups[g]) for g in ("X0", "X1"))
        f.write(f"{n0} {n0 + n1}\n")
        for g in ("X0", "X1"):
            f.write(g + "\n" + " ".join(str(int(mesh.node_ids[n])) for n
                                        in mesh.node_groups[g]) + "\n")
        f.write("0\n0\n")


def set_mesh_entry(wd, mesh_file, mtype, refine=0):
    """Point ``wd/hecmw_ctrl.dat``'s !MESH at ``mesh_file`` of TYPE
    ``mtype``, refined ``refine`` times."""
    path = os.path.join(wd, "hecmw_ctrl.dat")
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = f"!MESH, NAME=fstrMSH, TYPE={mtype}" + \
        (f", REFINE={refine}" if refine else "")
    lines[0:2] = [head, f" {mesh_file}"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def abaqus_workdir(path, mods, mesh, cnt, refine=0):
    """``cnt`` in ``path`` with ``mesh`` as an ABAQUS ``mesh.inp``, the
    nodes and the element rows shuffled (seed 3), REFINE=``refine``."""
    rng = np.random.default_rng(3)
    m = mods["ordering"].permute_mesh(mesh, rng.permutation(mesh.n_node))
    b = m.blocks[0]
    eo = rng.permutation(len(b.elem_ids))
    m.blocks = [dataclasses.replace(
        b, elem_ids=b.elem_ids[eo], conn=b.conn[eo],
        conn_hecmw=None if b.conn_hecmw is None else b.conn_hecmw[eo])]
    mods["write_static_workdir"](path, m, cnt)
    os.remove(os.path.join(path, "mesh.msh"))
    name = {341: "C3D4", 342: "C3D10", 361: "C3D8"}[b.etype]
    write_abaqus(os.path.join(path, "mesh.inp"), m, name)
    set_mesh_entry(path, "mesh.inp", "ABAQUS", refine)
    return str(path)


def check_picture(label, path, size=None, min_drawn=0.2) -> dict:
    """A BMP decodes (at ``size``), more than ``min_drawn`` of its pixels
    are not white (20%: tests/test_visualizer.py's bar) and it has more
    than 10 colours."""
    from frontistr_tpu_torch.vis import psf
    st = psf.bmp_stats(path)
    h, w = st["shape"]
    log(f"  {label}: {os.path.basename(path)} {w} x {h}, {st['drawn']:.3f} "
        f"of the pixels drawn, {st['colours']} colours")
    if (size is not None and st["shape"] != size) or not \
            (st["drawn"] > min_drawn and st["colours"] > 10):
        raise AssertionError(f"{label}: {path} is not the picture expected")
    return {"drawn": st["drawn"], "colours": st["colours"]}


def pictures_close(label, a, b) -> None:
    """The same picture from two runs: every byte within one level
    (quantised float images 1e-12 apart) and at most 0.1% of the pixels
    further apart (PSR: z-buffer ties broken the other way)."""
    from frontistr_tpu_torch.vis import psf
    d = psf.bmp_diff(a, b)
    log(f"  {label}: {os.path.basename(a)} cuda vs cpu: {d['differ']} "
        f"pixels differ, {d['far']} by more than one level")
    if d["far"] > 1e-3 * d["pixels"]:
        raise AssertionError(f"{label}: the pictures differ")


def phase_visual_main_path(mods, n=VISUAL_N) -> dict:
    """The visual cell through run_directory: the port's box_tet4(n)
    (VISUAL_N = 34: 42,875 nodes, 235,824 tets), nodes and elements
    shuffled, as an ABAQUS .inp, refined once on load (``REFINE=1``:
    328,509 nodes, 985,527 dofs, 1,886,592 tets, the lattice of
    box_tet4(2n)), linear STATIC with the tet cell's CG/AMG card, then
    !WRITE, VISUAL with !VISUAL, METHOD=PVR on the card.  Then the PSR
    surface of the same result on the host.  Held to: the refined
    counts; the true f64 relres <= 1e-8 (``check_result``); both BMPs
    decode at 500 x 500, more than 20% drawn, more than 10 colours; the
    PVR float image recomputed on the card (its BMP the run's byte for
    byte) within 1e-12 of the composite of the same voxel grid on the
    CPU; the picture not skipped.  K1's element entry once,
    its planes entry in the AMG setup and the nodal smoothing.  Returns
    the cell for the kernels line."""
    import copy
    psf, pvr = mods["psf"], mods["pvr"]
    wd = os.path.join(ROOT, "build", "smoke", f"visual{n}")
    t0 = time.perf_counter()
    mesh = mods["box_tet4"](n, n, n)
    n_elem = len(mesh.blocks[0].elem_ids)
    abaqus_workdir(wd, mods, mesh, VISCNT, refine=1)
    log(f"phase visual_workdir: box_tet4({n}) shuffled, {mesh.n_node} "
        f"nodes, {n_elem} tets as ABAQUS C3D4, REFINE=1; written in "
        f"{time.perf_counter() - t0:.2f} s")
    del mesh
    want = ((2 * n + 1) ** 3, 8 * n_elem)
    reset_kernel_launches(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mods["run_directory"](wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, model, rmesh, cfg = out["static"], out["model"], out["mesh"], \
        out["cfg"]
    tm = out["timings"]
    log(f"phase visual_main_path: {wall:.2f} s; {rmesh.n_node} nodes, "
        f"{3 * rmesh.n_node} dofs, {rmesh.n_elem} tets; policy={res.policy} "
        f"cg_iters={res.iters} refine_passes={res.passes} relres="
        f"{res.relres!r}; K1 launches={launches['K1']} (element), K1 planes "
        f"launches={launches['K1 planes']}; peak device memory "
        f"{peak_gb:.3f} GB")
    log("  phase seconds: " + " ".join(f"{k}={v:.3f}" for k, v in tm.items()))
    if (rmesh.n_node, rmesh.n_elem) != want:
        raise AssertionError(f"visual_main_path: refined mesh "
                             f"{rmesh.n_node}, {rmesh.n_elem}, expected "
                             f"{want}")
    if out["visual"] is None:
        raise AssertionError("visual_main_path: the picture was skipped")
    if launches["K1"] != 1 or launches["K1 planes"] < 1:
        raise AssertionError(f"visual_main_path: kernel launches {launches}")
    rr = check_result(res, model,
                      mods["static"].compute_element_stiffness(model))
    pvr_pic = check_picture("pvr", out["visual"], (500, 500))
    # the PVR image again on the card (render_image's stages), and on the
    # CPU from the same voxel grid
    coords, vals = psf.visual_field(rmesh, res, cfg.visual, "DISPLACEMENT", 1)
    grid, mask, _, _ = pvr.voxelize(coords, vals, device="cuda")
    starts, step = pvr.camera(grid.shape[0], 500, 500, (1.0, -2.0, 1.0), 160)
    starts, step = torch.as_tensor(starts), torch.as_tensor(step)
    vmin, vmax = float(vals.min()), float(vals.max())
    img = pvr.composite(grid, mask, starts.cuda(), step.cuda(), 160, vmin,
                        vmax, 0.08)
    again = os.path.join(wd, "again.bmp")
    psf.write_bmp(again, img.cpu().numpy())
    with open(again, "rb") as fa, open(out["visual"], "rb") as fb:
        same_bmp = fa.read() == fb.read()
    t0 = time.perf_counter()
    cpu = pvr.composite(grid.cpu(), mask.cpu(), starts, step, 160, vmin,
                        vmax, 0.08)
    cpu_s = time.perf_counter() - t0
    err = float((img.cpu() - cpu).abs().max())
    log(f"  pvr: card vs CPU composite from the same grid max abs diff "
        f"{err!r} (the CPU's {cpu_s:.2f} s); the BMP again on the card "
        f"byte-equal: {same_bmp}")
    if not (err <= 1e-12 and same_bmp):
        raise AssertionError("visual_main_path: the PVR image differs")
    # the PSR surface of the same result (host)
    cfg_psr = copy.copy(cfg)
    cfg_psr.visual = dict(cfg.visual, method="PSR")
    t_psr = {}
    t0 = time.perf_counter()
    psr = psf.visualize(rmesh, model, res, wd, cfg_psr, basename="result_psr",
                        device="cuda", timings=t_psr)
    psr_s = time.perf_counter() - t0
    psr_pic = check_picture("psr", psr, (500, 500))
    keys = ("read", "refine", "reorder", "model", "element_stiffness",
            "profile", "assembly", "amg_setup", "solve", "stress",
            "pvr_splat", "pvr_sweeps", "pvr_composite")
    phase_s = {k: tm.get(k, 0.0) for k in keys}
    phase_s.update(t_psr)
    log(f"  psr: {psr_s:.2f} s (extract_surface {t_psr['psr_extract']:.3f} s,"
        f" render {t_psr['psr_render']:.3f} s)")
    return {"n": n, "nodes": rmesh.n_node, "dofs": 3 * rmesh.n_node,
            "tets": rmesh.n_elem, "wall_s": wall, "peak_gb": peak_gb,
            "cg_iters": res.iters, "passes": res.passes, "true_relres": rr,
            "launches": launches["K1"],
            "planes_launches": launches["K1 planes"], "phase_s": phase_s,
            "psr_s": psr_s, "pvr_cpu_composite_s": cpu_s,
            "pvr_card_vs_cpu": err, "pvr": pvr_pic, "psr": psr_pic}


def phase_visual_small_reference(mods) -> None:
    """Small decks on the card and on the CPU (which the CPU tests hold to
    the JAX package): ABAQUS C3D8 and C3D10, NASTRAN and GEOFEM decks in
    STATIC; REFINE=1 and 2 of hex8, tet4 and a 741 plate; a 4-rank
    HECMW-DIST deck written by the port's partitioner (RCB and KMETIS),
    its u within 1e-8 of the ENTIRE deck's and its per-rank .res files
    card = CPU (ids and components equal, values within 1e-8 of each
    component's largest); transient heat and implicit dynamics with
    !WRITE, VISUAL, FREQUENCY=2 in PSR and PVR (the same files, the
    pictures within one level a byte, 0.1% of the pixels further); the
    AVS UCD output; FSTR.dbg.0; FRONTISTR_TPU_PROFILE on the card, its
    trace naming K1's kernel.  Displacements within 1e-8 of the largest,
    temperatures within 1e-10."""
    import glob
    run, mg = mods["run_directory"], mods["meshgen"]
    base = os.path.join(ROOT, "build", "smoke", "visual_small")
    shutil.rmtree(base, ignore_errors=True)

    def both(label, wd, key="static", field="u", bar=1e-8):
        wc = wd + "_cpu"
        shutil.copytree(wd, wc)
        a, b = run(wd, device="cuda"), run(wc, device="cpu")
        d = rel_diff(getattr(a[key], field), getattr(b[key], field))
        log(f"phase visual_small_reference: {label}, cuda vs cpu {d!r}")
        if not d <= bar:
            raise AssertionError(f"visual_small_reference: {label} differs")
        return a, b, wd, wc

    cnt = CNT.replace("1.0e-8, 1.0", "1.0e-10, 1.0")
    both("ABAQUS C3D8", abaqus_workdir(os.path.join(base, "c3d8"), mods,
                                       mg.box_hex8(4, 3, 2), cnt))
    both("ABAQUS C3D10", abaqus_workdir(os.path.join(base, "c3d10"), mods,
                                        tet10_mesh(mods, (3, 2, 2)), cnt))
    wd = os.path.join(base, "nastran")
    os.makedirs(wd)
    with open(os.path.join(wd, "mesh.nas"), "w") as fh:
        fh.write(NASTRAN_BULK)
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(NASTRAN_CNT)
    with open(os.path.join(wd, "hecmw_ctrl.dat"), "w") as fh:
        fh.write("!MESH, NAME=fstrMSH, TYPE=NASTRAN\n mesh.nas\n"
                 "!CONTROL, NAME=fstrCNT\n case.cnt\n")
    both("NASTRAN", wd)
    wd = write_shuffled(os.path.join(base, "geofem"), mods,
                        mg.box_tet4(3, 3, 3), cnt)
    write_geofem(os.path.join(wd, "mesh.grd"), mg.box_tet4(3, 3, 3))
    set_mesh_entry(wd, "mesh.grd", "GEOFEM")
    both("GEOFEM", wd)
    # refinement at load time
    plate = mg.plate_shell(4, 3, etype=741, a=SHELL_A, thick=50.0)
    for kind, mesh, groups, deck in (
            ("hex8", mg.box_hex8(3, 2, 2), ("X0", "X1"), cnt),
            ("tet4", mg.box_tet4(3, 2, 2), ("X0", "X1"), cnt),
            ("plate741", plate, ("EDGE",),
             shell_cnt(loads=f"!DLOAD\n ALL, P0, {SHELL_Q!r}\n",
                       resid="1.0e-10"))):
        for level in (1, 2):
            wd = write_shuffled(os.path.join(base, f"{kind}_refine{level}"),
                                mods, mesh, deck, ngroups=groups)
            set_mesh_entry(wd, "mesh.msh", "HECMW-ENTIRE", level)
            a, _, _, _ = both(f"{kind} REFINE={level}", wd)
            if a["mesh"].n_elem != mesh.n_elem * (4 if kind == "plate741"
                                                  else 8) ** level:
                raise AssertionError("visual_small_reference: refined "
                                     f"{kind} has {a['mesh'].n_elem} "
                                     "elements")
    # HECMW-DIST: 4 ranks from the port's partitioner
    box = mg.box_tet4(4, 3, 2)
    whole = write_shuffled(os.path.join(base, "entire"), mods, box, cnt)
    u_whole = run(whole, device="cuda")
    for method in ("RCB", "KMETIS"):
        wd = write_shuffled(os.path.join(base, f"dist_{method}"), mods, box,
                            cnt.replace("!END", "!WRITE, RESULT\n!END"))
        os.remove(os.path.join(wd, "mesh.msh"))
        mods["partition"].partition_to_files(
            box, 4, os.path.join(wd, "mesh.dist"), method)
        set_mesh_entry(wd, "mesh.dist", "HECMW-DIST")
        a, b, wa, wb = both(f"HECMW-DIST {method} 4 ranks", wd)
        d = rel_diff(by_id(a), by_id(u_whole))
        files = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(wa, "mesh.res.*")))
        log(f"  ranks {a['partition']['n_ranks']}, u against the ENTIRE "
            f"deck {d!r}, result files {files}")
        if not (d <= 1e-8 and files == [f"mesh.res.{r}.1" for r in
                                        range(4)]):
            raise AssertionError(f"visual_small_reference: {method} deck")
        res_close(f"HECMW-DIST {method}", [os.path.join(wa, f) for f in files],
                  [os.path.join(wb, f) for f in files], mods["read_result"])
    # per-interval pictures of heat and implicit dynamics, PSR and PVR
    for method in ("PSR", "PVR"):
        vis = (f"!WRITE, VISUAL, FREQUENCY=2\n!VISUAL, METHOD={method}\n"
               "!x_resolution = 160\n!y_resolution = 120\n")
        wd = small_heat_deck(mods, "hex8", True,
                             os.path.join(base, f"heat_{method}"))
        add_cards(wd, vis)
        a, b, wa, wb = both(f"heat {method}", wd, "heat", "T", 1e-10)
        same_pictures(f"heat {method}", wa, wb, ["result.2.bmp"])
        small = mg.box_hex8(3, 2, 2)
        dt = 20.0 * critical_step(small)
        wd = os.path.join(base, f"dynamic_{method}")
        write_dyn_workdir(wd, mods, small, 4 * dt, lambda m: dyn_cnt(
            1, 4, dt, ray_m=1.0e3, ray_k=1.0e-9, write=vis))
        a, b, wa, wb = both(f"implicit dynamics {method}", wd, "dynamic")
        same_pictures(f"dynamics {method}", wa, wb,
                      ["result.2.bmp", "result.4.bmp"])
    # AVS UCD output and FSTR.dbg.0
    wd = write_shuffled(os.path.join(base, "avs"), mods, mg.box_hex8(4, 3, 2),
                        cnt.replace("!END", "!WRITE, VISUAL\n!VISUAL, "
                                    "METHOD=PSR\n!output_type = COMPLETE_AVS"
                                    "\n!END"))
    a, b, wa, wb = both("AVS UCD", wd)
    ucd_close(os.path.join(wa, "result.inp"), os.path.join(wb, "result.inp"))
    with open(os.path.join(wa, "FSTR.dbg.0")) as fh:
        dbg = [ln[10:] for ln in fh.read().splitlines()]
    log(f"  FSTR.dbg.0: {dbg}")
    if not (len(dbg) == 4 and dbg[0] == "FSTR debug log opened" and
            dbg[1].startswith("mesh read: 60 nodes, 24 elements") and
            dbg[3].startswith("analysis completed")):
        raise AssertionError("visual_small_reference: FSTR.dbg.0")
    # the profiler on the card: the trace names K1's kernel
    prof = os.path.join(base, "profile")
    wd = write_shuffled(os.path.join(base, "profiled"), mods,
                        mg.box_tet4(6, 5, 4), CNT)
    with_env({"FRONTISTR_TPU_PROFILE": prof},
             lambda: run(wd, device="cuda"))
    with open(os.path.join(prof, "trace.json")) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]
             if e.get("cat") == "kernel"}
    k1 = sorted(n for n in names if "sums_kernel" in n)
    log(f"  FRONTISTR_TPU_PROFILE: {len(trace['traceEvents'])} events, "
        f"{len(names)} kernel names, K1's: {k1[:2]}")
    if not k1:
        raise AssertionError("visual_small_reference: the profiler's trace "
                             "names no K1 kernel")


def by_id(out):
    """A static run's displacements sorted by node id."""
    return out["static"].u[np.argsort(out["mesh"].node_ids)]


def add_cards(wd, cards):
    """Put ``cards`` before the !END of ``wd/case.cnt``."""
    path = os.path.join(wd, "case.cnt")
    with open(path) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(text.replace("!END", cards + "!END"))


def same_pictures(label, wa, wb, names) -> None:
    """Both runs wrote the pictures ``names`` and no other, each pair
    within ``pictures_close``'s bar."""
    got = [sorted(f for f in os.listdir(w) if f.endswith(".bmp"))
           for w in (wa, wb)]
    if not got[0] == got[1] == sorted(names):
        raise AssertionError(f"{label}: pictures {got}, expected {names}")
    for f in names:
        pictures_close(label, os.path.join(wa, f), os.path.join(wb, f))
        check_picture(label, os.path.join(wa, f), min_drawn=0.05)


def res_close(label, paths_a, paths_b, read_result) -> None:
    """The .res files of two runs (one a rank): the same ids and
    components, values within 1e-8 of each component's largest over
    every file (a rank without supports holds reactions of rounding
    size)."""
    xs = [read_result(p) for p in paths_a]
    ys = [read_result(p) for p in paths_b]
    for x, y in zip(xs, ys):
        for k in ("node_ids", "elem_ids"):
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{label}: {k} differ")
        for k in ("node_comps", "elem_comps"):
            if [c for c, _ in x[k]] != [c for c, _ in y[k]]:
                raise AssertionError(f"{label}: components differ")
    for k in ("node_comps", "elem_comps"):
        for i, (c, _) in enumerate(ys[0][k]):
            big = max(np.abs(y[k][i][1]).max() for y in ys)
            d = max(np.abs(np.asarray(x[k][i][1]) - y[k][i][1]).max()
                    for x, y in zip(xs, ys))
            if not d <= 1e-8 * max(big, 1e-300):
                raise AssertionError(f"{label}: {c} differs")


def ucd_close(a, b) -> None:
    """Two UCD files of one deck: the header, nodes, cells and labels
    equal, the data rows within 1e-8 of each column's largest."""
    with open(a) as fa, open(b) as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    n_node, n_elem = (int(v) for v in la[5].split())
    head = 6 + n_node + n_elem + 4
    x = np.asarray([[float(v) for v in r.split()] for r in la[head:]])
    y = np.asarray([[float(v) for v in r.split()] for r in lb[head:]])
    ok = len(la) == len(lb) and la[:head] == lb[:head] and \
        (np.abs(x - y) <= 1e-8 * np.abs(y).max(axis=0)).all()
    log(f"  AVS UCD: {len(la)} lines, {n_node} nodes, {n_elem} cells; "
        f"cuda vs cpu equal within 1e-8: {ok}")
    if not ok:
        raise AssertionError("visual_small_reference: the UCD files differ")


# ---- PR: the box arm (two-grid), the profile cache, coupling, adapt, tools --
BOX_N = 69


def phase_box_main_path(mods, n=BOX_N) -> dict:
    """The box arm's solve (``microbench/box_twogrid.py``, the solve of
    ``bench.py:195-404``) on box_hex8(n): f32 two-grid PCG on the
    dof-major stencil operator, every fine and coarse product through
    K2, refined in f64 to a true relres <= 1e-8 by the one-element
    ``ConstD`` operator and again by the node-major f64
    ``StructuredHexOperator`` (every element, K2).  K2's launches are
    counted by element count and held to the PCG's arithmetic: 3 fine
    and 20 coarse a preconditioned residual, 15 coarse in the power
    iteration.  Then ``box_twogrid.split``: host wall, device time and
    launches of a CG iteration and of its parts, and K2's share; then K2
    at the coarse shape against its bound."""
    em, bt = mods["element_mv"], mods["box_twogrid"]
    fine = bt.make_box(n)
    reset_kernel_launches(mods)
    em.element_matvec_soa.launches_by_e.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = bt.solve(n, "cuda", fine=fine)
    wall = time.perf_counter() - t0
    counts = kernel_launch_counts(mods)
    by_e = dict(em.element_matvec_soa.launches_by_e)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    rr_node = bt.node_major_relres(fine, res.x)
    t_node = time.perf_counter() - t0
    E, Ec = res.n_elem, res.n_elem_coarse
    calls = sum(res.chunks_per_pass) + res.cg_iters
    cg_s = sum(v for k, v in res.timings.items() if k.startswith("cg_pass"))
    ms_cg = 1e3 * cg_s / max(res.cg_iters, 1)
    log(f"phase box_main_path: box_hex8({n}) {res.n_dof} dofs, {E} "
        f"elements, coarse box_hex8({n // 3}) {Ec} elements: {wall:.2f} s; "
        + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items()))
    log(f"  cg_iters={res.cg_iters} per pass {res.cg_per_pass} (PCG calls "
        f"{res.chunks_per_pass}), {ms_cg:.3f} ms a CG iteration, "
        f"lmax_c={res.lmax_c!r}; relres ConstD={res.relres!r}, node-major "
        f"K2 f64={rr_node!r} ({t_node:.2f} s); peak {peak:.3f} GB; K2 "
        f"launches fine={by_e.get(E, 0)} coarse={by_e.get(Ec, 0)}; "
        f"all launches {counts}")
    if not (by_e.get(E, 0) == 3 * calls and
            by_e.get(Ec, 0) == 20 * calls + 15 and set(by_e) == {E, Ec}
            and counts["K2"] == by_e[E] + by_e[Ec]):
        raise AssertionError(f"box_main_path: K2 launches {by_e}, expected "
                             f"{3 * calls} fine and {20 * calls + 15} coarse")
    if any(v for k, v in counts.items() if k != "K2"):
        raise AssertionError(f"box_main_path: other kernels ran {counts}")
    if not (res.relres <= 1e-8 and rr_node <= 1e-8 and
            bool(torch.isfinite(res.x).all())):
        raise AssertionError("box_main_path: relres above 1e-8")
    # where a CG iteration goes (host wall, device, K2; torch.profiler)
    split = bt.split(res)
    for k, v in split.items():
        log(f"  split {k}: " + (f"{v:.4f} ms" if isinstance(v, float) else
                                " ".join(f"{a}={b:.4f}"
                                         for a, b in v.items())))
    # K2 at the coarse shape (float32, the Chebyshev coarse solve's type)
    keT = bt.assemble_soa(bt.make_box(n // 3), torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xeT = torch.randn((24, Ec), generator=gen, device="cuda")
    err = check_k2(em, keT, xeT, f"coarse E={Ec}")
    ms = cuda_ms(lambda: em.element_matvec_soa(keT, xeT), reps=50)
    plain_ms = cuda_ms(lambda: em.element_matvec_soa_reference(keT, xeT),
                       reps=50)
    keB, xeB = keT.permute(2, 0, 1), xeT.t()[:, :, None]
    library_ms = cuda_ms(lambda: torch.bmm(keB, xeB), reps=50)
    nbytes = (24 * 24 + 2 * 24) * Ec * 4
    bound_ms, bound_by = bound(nbytes, 2 * 24 * 24 * Ec, torch.float32)
    log(f"phase k2_coarse_time: E={Ec} float32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bmm {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({nbytes} B)")
    return {"n": n, "dofs": res.n_dof, "wall_s": wall, "peak_gb": peak,
            "cg_iters": res.cg_iters, "cg_per_pass": res.cg_per_pass,
            "pcg_calls": res.chunks_per_pass, "ms_per_cg": ms_cg,
            "relres": res.relres, "relres_node_major": rr_node,
            "phase_s": res.timings, "split": split,
            "launches_fine": by_e[E],
            "launches_coarse": by_e[Ec],
            "coarse": {"elements": Ec, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}}


def phase_cache(mods, model) -> dict:
    """The profile cache (``assembly/profcache.py``) at the newton cell's
    mesh: the ELL and cluster profiles built and saved into a fresh
    directory under ``build/`` (cold), then loaded with the memory cache
    cleared (warm); both bit-equal to the profiles the newton run built,
    every field and dtype."""
    ell, bell, pc = mods["ell"], mods["bell"], mods["profcache"]
    built = (ell.profile_from_model(model),
             bell.cluster_profile_from_model(model))
    d = os.path.join(ROOT, "build", "smoke", "profcache")
    shutil.rmtree(d, ignore_errors=True)
    times = {}

    def both(tag):
        ell._PROFILE_CACHE.clear()
        bell._CPROFILE_CACHE.clear()
        t0 = time.perf_counter()
        p = ell.profile_from_model(model)
        times[f"{tag}_ell"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = bell.cluster_profile_from_model(model, scalar=p)
        times[f"{tag}_bell"] = time.perf_counter() - t0
        return p, c

    # cold: each profile built and saved by its own call; warm: loaded
    cold, warm = with_env({"FRONTISTR_TPU_CACHE_DIR": d},
                          lambda: (both("cold"), both("warm")))
    files = sorted(os.listdir(d))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in files)
    fields = {0: ("n_node", "ndof", "W", "cols", "diag_slot", "perm",
                  "seg_sorted", "pair_counts"),
              1: ("n_node", "ndof", "G", "C", "Wc", "ccols", "diag_wc",
                  "perm", "seg_sorted", "scal_src", "pair_counts")}
    same = all(
        all((np.array_equal(getattr(a, f), getattr(b, f)) and
             getattr(a, f).dtype == getattr(b, f).dtype)
            if isinstance(getattr(b, f), np.ndarray)
            else getattr(a, f) == getattr(b, f) for f in fields[i])
        for i in (0, 1) for a in (cold[i], warm[i]) for b in (built[i],))
    log(f"phase cache: {model.n_node * model.ndof} dofs, {len(files)} "
        f"entries, {nbytes} bytes; " + " ".join(
            f"{k}={v:.3f}" for k, v in times.items())
        + f" s; cold and warm bit-equal to the run's profiles: {same}")
    shutil.rmtree(d, ignore_errors=True)
    ell._PROFILE_CACHE.clear()
    bell._CPROFILE_CACHE.clear()
    if not (same and len(files) == 2 and warm[0] is not cold[0]):
        raise AssertionError("cache: a loaded profile differs")
    return {"bytes": nbytes, **{k + "_s": v for k, v in times.items()}}


COUPLE_PEER = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from frontistr_tpu_torch.couple.rcap import FileCoupler
d, n_step, px = sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
ep = FileCoupler(d, role="fluid", peer="solid", timeout=300.0)
ids = ep.peer_interface()["node_ids"]
got = {}
for i in range(1, n_step + 1):
    tr = np.zeros((len(ids), 3))
    tr[:, 0] = px * i / n_step
    ep.send(i, node_ids=ids, trac=tr)
    for k, v in ep.get(i).items():
        got[f"{k}.{i}"] = v
np.savez(d + "/peer_log.npz", **got)
"""
COUPLECNT = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n {eqa}, 1\n"
             " 0.0, {t_end!r}, {n_step}, {dt!r}\n 0.5, 0.25\n"
             " 1, 1, 0.0, 0.0\n 10\n!BOUNDARY\n X0, 1, 3, 0.0\n"
             "!COUPLE, TYPE=1\n WET\n!STEP, SUBSTEPS=1, CONVERG=1.0e-8\n"
             "!MATERIAL, NAME=M1\n!ELASTIC\n 1000.0, 0.0\n!DENSITY\n 1.0\n"
             "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
             " 10000, 1\n 1.0e-12, 1.0, 0.0\n!END\n")


def coupled_run(mods, wd, device, n_step):
    """``wd`` through run_directory on ``device`` coupled to a peer
    process (``COUPLE_PEER``: the port's FileCoupler as the fluid code,
    a +x traction growing each step); returns (the run, the states the
    peer read).  The peer is stopped whatever happens."""
    d = os.path.join(wd, "couple")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    peer = subprocess.Popen([sys.executable, "-c", COUPLE_PEER, ROOT, d,
                             str(n_step), "3.0"])
    try:
        out = with_env({"FRONTISTR_TPU_COUPLE_DIR": d,
                        "FRONTISTR_TPU_COUPLE_TIMEOUT": "300"},
                       lambda: mods["run_directory"](wd, device=device))
        rc = peer.wait(timeout=300)
    finally:
        if peer.poll() is None:
            peer.kill()
            peer.wait()
    if rc != 0:
        raise AssertionError(f"couple: the peer process exited {rc}")
    with np.load(os.path.join(d, "peer_log.npz")) as z:
        return out, {k: z[k] for k in z.files}


def phase_couple_small_reference(mods) -> None:
    """!COUPLE through FRONTISTR_TPU_COUPLE_DIR with a peer process, in
    implicit (Newmark) and explicit dynamics, on the card and on the
    CPU: every state the peer read within 1e-10 of the largest, u too;
    then the staggered heat -> stress transfer (``couple/mapping.py``)
    and its thermal STATIC run in the f64 policy, card vs CPU within
    1e-8."""
    mg = mods["meshgen"]
    base = os.path.join(ROOT, "build", "smoke", "couple_small")
    shutil.rmtree(base, ignore_errors=True)
    mesh = mg.box_hex8(4, 2, 2)
    ftab = mods["face_tables"][361]
    blk = mesh.blocks[0]
    rows = [(int(blk.elem_ids[e]), f)
            for e in range(len(blk.elem_ids))
            for f, (_, ln) in enumerate(ftab, 1)
            if np.allclose(mesh.coords[blk.conn[e][np.asarray(ln)], 0], 1.0)]
    n_step = 4
    for eqa, dt, label in ((1, 0.01, "implicit"), (11, 0.002, "explicit")):
        wd = os.path.join(base, label)
        mods["write_static_workdir"](
            wd, mesh, COUPLECNT.format(eqa=eqa, t_end=n_step * dt,
                                       n_step=n_step, dt=dt),
            ngroups=("X0",), sgroups={"WET": rows})
        wc = wd + "_cpu"
        shutil.copytree(wd, wc)
        t0 = time.perf_counter()
        a, pa = coupled_run(mods, wd, "cuda", n_step)
        b, pb = coupled_run(mods, wc, "cpu", n_step)
        wall = time.perf_counter() - t0
        keys = sorted(pb)
        d = max(rel_diff(pa[k], pb[k]) for k in keys if
                not k.startswith("node_ids"))
        du = rel_diff(a["dynamic"].u, b["dynamic"].u)
        ux = float(np.asarray(a["dynamic"].u)[:, 0].max())
        log(f"phase couple_small_reference: {label} dynamics box_hex8(4,2,2)"
            f", {len(rows)} WET faces, {n_step} steps, a peer process: "
            f"{len(keys)} arrays read by the peer, cuda vs cpu {d!r}, u "
            f"{du!r}, max u_x {ux!r} ({wall:.2f} s both)")
        if not (sorted(pa) == keys and len(keys) == 4 * n_step and
                d <= 1e-10 and du <= 1e-10 and ux > 0):
            raise AssertionError(f"couple_small_reference: {label}")
    # the staggered heat -> stress transfer and its thermal STATIC run
    path = os.path.join(base, "thermal.cnt")
    with open(path, "w") as fh:
        fh.write(CNT.replace("!CLOAD\n X1, 3, -1.0\n", "").replace(
            "!BOUNDARY\n X0, 1, 3, 0.0\n", "!BOUNDARY\n X0, 1, 1, 0.0\n"
            " Y0, 2, 2, 0.0\n Z0, 3, 3, 0.0\n").replace(
            "!SOLVER", "!EXPANSION_COEFF\n 1.0e-5\n!SOLVER").replace(
            "1.0e-8, 1.0", "1.0e-10, 1.0"))
    cfg = mods["read_cnt"](path)
    src, dst = mg.box_hex8(4, 4, 4), mg.box_hex8(6, 6, 6)
    T = mods["mapping"].StaggeredCoupling(src, dst).transfer(
        100.0 * src.coords[:, 0])
    us = []
    for dev in ("cuda", "cpu"):
        model = mods["build_struct_model"](dst, cfg, device=dev)
        model.temperature = T
        model.f_ext = model.f_ext + mods["thermal_load"](model, T)
        us.append(with_env({"FRONTISTR_TPU_PRECISION": "f64"}, lambda: mods[
            "static"].run_linear_static(model).u))
    dT = float(np.abs(T - 100.0 * dst.coords[:, 0]).max())
    d = rel_diff(us[0], us[1])
    log(f"phase couple_small_reference: staggered heat -> stress, "
        f"box_hex8(4) -> box_hex8(6): T error {dT!r}, cuda vs cpu u {d!r}")
    if not (dT <= 1e-10 and d <= 1e-8 and np.abs(us[1]).max() > 1e-5):
        raise AssertionError("couple_small_reference: staggered run")


def vtk_close(label, a, b) -> None:
    """Two legacy VTK files of one deck: the same words, the numbers
    within 1e-8 of the file's largest."""
    with open(a) as fa, open(b) as fb:
        wa, wb = fa.read().split(), fb.read().split()

    def num(w):
        try:
            return float(w)
        except ValueError:
            return None
    xa, xb = [num(w) for w in wa], [num(w) for w in wb]
    same_words = len(wa) == len(wb) and all(
        (x is None) == (y is None) and (x is not None or p == q)
        for x, y, p, q in zip(xa, xb, wa, wb))
    na = np.asarray([x for x in xa if x is not None])
    nb = np.asarray([y for y in xb if y is not None])
    ok = same_words and len(na) == len(nb) and \
        np.abs(na - nb).max() <= 1e-8 * np.abs(nb).max()
    log(f"  {label}: {len(wa)} words, cuda vs cpu within 1e-8: {ok}")
    if not ok:
        raise AssertionError(f"{label}: the VTK files differ")


def phase_tools_small_reference(mods) -> None:
    """The tools on the card and the CPU: ``fistr-torch-part`` (RCB, with
    --check-mesh) of a shuffled box_tet4(8, 6, 5) into 4 HECMW-DIST
    ranks, that work directory through run_directory (the per-rank
    .res), ``rmerge`` of the ranks, ``rconv`` to binary, back to text
    (byte-equal to the merged file) and to npz, and ``write_static_vtk``;
    then ``fistr-torch-rebalance --refine`` (adaptive refinement of a
    corner, then a fresh 4-rank RCB split) of a 4-rank box_tet4(6) and
    its run.  Card vs CPU: the merged results within 1e-8 of each
    component's largest, the VTK numbers within 1e-8, u within 1e-8."""
    import glob
    cli, mg = mods["cli"], mods["meshgen"]
    run = mods["run_directory"]
    base = os.path.join(ROOT, "build", "smoke", "tools_small")
    shutil.rmtree(base, ignore_errors=True)
    cnt = CNT.replace("1.0e-8, 1.0", "1.0e-10, 1.0").replace(
        "!END", "!WRITE, RESULT\n!END")
    wd = write_shuffled(os.path.join(base, "part"), mods,
                        mg.box_tet4(8, 6, 5), cnt)
    msh = os.path.join(wd, "mesh.msh")
    if cli.part_main([msh, "-n", "4", "-o", os.path.join(wd, "mesh.dist"),
                      "--check-mesh"]) != 0:
        raise AssertionError("tools_small_reference: part")
    os.remove(msh)
    set_mesh_entry(wd, "mesh.dist", "HECMW-DIST")
    wc = wd + "_cpu"
    shutil.copytree(wd, wc)
    merged = []
    for w, dev in ((wd, "cuda"), (wc, "cpu")):
        out = run(w, device=dev)
        ranks = sorted(glob.glob(os.path.join(w, "mesh.res.*.1")))
        m = os.path.join(w, "merged.res")
        if not (len(ranks) == 4 and cli.rmerge_main(ranks + ["-o", m]) == 0
                and cli.rconv_main([m, m + ".bin", "-t", "binary"]) == 0
                and cli.rconv_main([m + ".bin", m + ".txt", "-t",
                                    "text"]) == 0
                and cli.rconv_main([m, m + ".npz", "-t", "npz"]) == 0):
            raise AssertionError("tools_small_reference: rmerge / rconv")
        with open(m, "rb") as fa, open(m + ".txt", "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("tools_small_reference: text -> binary "
                                     "-> text is not byte-equal")
        mods["vtk"].write_static_vtk(os.path.join(w, "result.vtk"),
                                     out["mesh"], out["static"])
        merged.append((out, m))
    res_close("tools_small_reference merged", [merged[0][1]],
              [merged[1][1]], mods["read_result"])
    mres = mods["read_result"](merged[0][1])
    if sorted(mres["node_ids"]) != sorted(merged[0][0]["mesh"].node_ids):
        raise AssertionError("tools_small_reference: the merged file "
                             "misses nodes")
    log(f"phase tools_small_reference: part (RCB, 4 ranks, check mesh "
        f"{os.path.getsize(os.path.join(wd, 'mesh.dist.check.inp'))} B) -> "
        f"run_directory -> rmerge ({len(mres['node_ids'])} nodes) -> rconv "
        f"-> VTK; cuda vs cpu u {rel_diff(by_id(merged[0][0]), by_id(merged[1][0]))!r}")
    vtk_close("VTK", os.path.join(wd, "result.vtk"),
              os.path.join(wc, "result.vtk"))
    # rebalance with adaptive refinement of a corner
    mesh = mg.box_tet4(6, 6, 6)
    rb = os.path.join(base, "rebalance")
    os.makedirs(rb)
    mods["partition"].partition_to_files(mesh, 4,
                                         os.path.join(rb, "box.dist"))
    with open(os.path.join(rb, "box.cnt"), "w") as fh:
        fh.write(cnt)
    with open(os.path.join(rb, "hecmw_ctrl.dat"), "w") as fh:
        fh.write("!MESH, NAME=fstrMSH, TYPE=HECMW-DIST\n box.dist\n"
                 "!CONTROL, NAME=fstrCNT\n box.cnt\n"
                 "!RESULT, NAME=fstrRES, IO=OUT\n box.res\n")
    b = mesh.blocks[0]
    hit = (mesh.coords[b.conn].mean(axis=1) < 1.0 / 3.0).all(axis=1)
    marks = ",".join(str(int(e)) for e in b.elem_ids[hit])
    if cli.rebalance_main([os.path.join(rb, "box.dist"), "--refine",
                           marks]) != 0:
        raise AssertionError("tools_small_reference: rebalance")
    rc = rb + "_cpu"
    shutil.copytree(rb, rc)
    a, c = run(rb, device="cuda"), run(rc, device="cpu")
    d = rel_diff(by_id(a), by_id(c))
    log(f"phase tools_small_reference: rebalance --refine ({hit.sum()} "
        f"marked of {mesh.n_elem}) -> {a['mesh'].n_elem} elements on "
        f"{a['partition']['n_ranks']} ranks; cuda vs cpu u {d!r}")
    if not (d <= 1e-8 and a["mesh"].n_elem > mesh.n_elem and
            a["partition"]["n_ranks"] == 4 and
            a["static"].relres <= 1e-8):
        raise AssertionError("tools_small_reference: the rebalanced run")


def phase_box_small_reference(mods) -> None:
    """The box solve at n = 9 on the card and on the CPU with one start
    vector: CG within 2 + 10%, x within 1e-6 of the largest."""
    bt = mods["box_twogrid"]
    v0 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        3 * 4 ** 3), dtype=torch.float32)
    g, c = bt.solve(9, "cuda", v0=v0), bt.solve(9, "cpu", v0=v0)
    d = rel_diff(g.x.cpu().numpy(), c.x.numpy())
    log(f"phase box_small_reference: box_hex8(9) two-grid, cg {g.cg_iters} "
        f"{g.cg_per_pass} vs {c.cg_iters} {c.cg_per_pass}, relres "
        f"{g.relres!r} vs {c.relres!r}, x cuda vs cpu {d!r}")
    if not (g.relres <= 1e-8 and c.relres <= 1e-8 and d <= 1e-6 and
            abs(g.cg_iters - c.cg_iters) <= 2 + 0.1 * c.cg_iters):
        raise AssertionError("box_small_reference: card and CPU differ")


# ---- PR: several devices (torch.distributed ranks, row-sharded solves) ----
# the small decks of shard_small_reference: (label, deck, mesh dims, env)
SHARD_DYN = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 1, 1\n"
             " 0.0, 0.03, 3, 0.01\n 0.5, 0.25\n 1, 1, 0.5, 0.0\n 10\n"
             "!BOUNDARY, GRPID=1\n X0, 1, 3, 0.0\n!CLOAD, GRPID=1\n"
             " X1, 3, -1.5\n!STEP, SUBSTEPS=1, CONVERG=1.0e-8\n"
             " BOUNDARY, 1\n LOAD, 1\n!MATERIAL, NAME=M1\n!ELASTIC\n"
             " 500.0, 0.3\n!DENSITY\n 2.0\n!SOLVER,METHOD=CG,PRECOND=1,"
             "ITERLOG=NO,TIMELOG=NO\n 10000, 1\n 1.0e-12, 1.0, 0.0\n!END\n")
SHARD_EIG = ("!VERSION\n 3\n!SOLUTION, TYPE=EIGEN\n!EIGEN\n 4, 1.0e-10, 60\n"
             "!BOUNDARY\n X0, 1, 3, 0.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
             " 1000.0, 0.3\n!DENSITY\n 1.0\n!SOLVER,METHOD=CG,ITERLOG=NO,"
             "TIMELOG=NO\n 10000, 1\n 1.0e-10, 1.0, 0.0\n!END\n")


def shard_sizes() -> list:
    """The group sizes of the shard phases: the card count on NCCL where
    there are two or more cards, else 2 ranks sharing the card (gloo)
    and 1 rank (NCCL)."""
    n = torch.cuda.device_count()
    return [n] if n >= 2 else [2, 1]


def start_shard_pools(mods) -> dict:
    """The ranks of the shard phases, started now (they come up while
    the other phases run) and closed at the end."""
    dist = mods["dist"]
    store = os.path.join(ROOT, "build", "smoke")
    os.makedirs(store, exist_ok=True)
    return {n: dist.RankPool(n, "cuda", store) for n in shard_sizes()}


def shard_rank_run(wd: str, env: dict) -> dict:
    """One rank's run of a work directory in its group (the task of the
    spawned ranks): its backend, device, rows, the K1 launches of this
    run (the counts set to 0 just before it), peak memory, the Newton
    and CG counts with the seconds of each solve, and the answer."""
    sys.path.insert(0, ROOT)
    from frontistr_tpu_torch.assembly import segsum as sm
    from frontistr_tpu_torch.parallel import dist
    from frontistr_tpu_torch.parallel.shard import row_split
    from frontistr_tpu_torch.run import run_rank
    comm = dist.current()
    torch.cuda.reset_peak_memory_stats(comm.device)
    sm.segsum.launches = 0
    sm.segsum_planes.launches = 0
    t0 = time.perf_counter()
    out = with_env(env, lambda: run_rank(wd))
    wall = time.perf_counter() - t0
    got = dict(rank=comm.rank, size=comm.size, backend=comm.backend,
               device=str(comm.device), wall=wall,
               k1=sm.segsum.launches, planes=sm.segsum_planes.launches,
               peak_gb=torch.cuda.max_memory_allocated(comm.device) / 1e9,
               node_ids=np.asarray(out["mesh"].node_ids),
               timings=dict(out["timings"]))
    got.update(shard_summary(out))
    sp = row_split(comm, out["mesh"].n_node, 3)
    got["rows"] = (sp.n0, sp.n1, sp.n_pad)
    if comm.rank:
        got.pop("u", None)
    return got


def shard_summary(out) -> dict:
    """The numbers the shard phases hold of a run_directory output."""
    got = {}
    res = out.get("static")
    if res is not None:
        got.update(u=np.asarray(res.u).reshape(-1), iters=int(res.iters))
        if res.newton is not None:
            got["cg"] = [h["cg_iters"] for h in res.newton.history]
            got["solve_s"] = [h["solve"] for h in res.newton.history]
    for key, field in (("dynamic", "u"), ("heat", "T")):
        r = out.get(key)
        if r is not None:
            v = getattr(r, field)
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            got["u"] = np.asarray(v).reshape(-1)
            got["cg"] = sum((list(h["cg"]) for h in r.history), [])
    er = out.get("eigen")
    if er is not None:
        got.update(u=np.asarray(er.eigenvalues),
                   cg=[h["cg"] for h in er.history])
    return got


def copy_inputs(src: str, names, dst: str, converg=None) -> str:
    """A fresh work directory ``dst`` holding the input files ``names``
    of ``src``; with ``converg``, the .cnt's !STEP given that CONVERG."""
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for f in names:
        shutil.copy(os.path.join(src, f), dst)
        if converg is not None and f.endswith(".cnt"):
            path = os.path.join(dst, f)
            with open(path) as fh:
                text = fh.read()
            if text.count("!STEP, SUBSTEPS=1\n") != 1:
                raise AssertionError(f"{path}: no single !STEP to cut")
            with open(path, "w") as fh:
                fh.write(text.replace("!STEP, SUBSTEPS=1\n",
                                      f"!STEP, SUBSTEPS=1, "
                                      f"CONVERG={converg!r}\n"))
    return dst


def check_rank_files(wd: str, inputs, outputs, n: int, label: str) -> None:
    """The files a group of ``n`` ranks wrote into ``wd``: the one-device
    run's ``outputs`` (0.log and, as the analysis writes them, FSTR.sta,
    FSTR.msg and results: rank 0 alone) and FSTR.dbg.<rank> for each
    rank, nothing else."""
    made = set(os.listdir(wd)) - set(inputs)
    dbg = {f for f in made if f.startswith("FSTR.dbg")}
    want = {f for f in outputs if not f.startswith("FSTR.dbg")}
    if dbg != {f"FSTR.dbg.{r}" for r in range(n)} or made - dbg != want \
            or "0.log" not in want:
        raise AssertionError(f"{label}: {n} ranks wrote {sorted(made)}, "
                             f"expected {sorted(want)} and FSTR.dbg.0-"
                             f"{n - 1}")


def by_node_id(u, ids, nd=3):
    return np.asarray(u).reshape(len(ids), -1)[np.argsort(ids)]


def phase_shard_main_path(args, mods, pools, ref, smi) -> dict:
    """The newton cell's deck (shuffled box_tet4(69), 1,029,000 dofs,
    NLSTATIC, f64, AMG) under FRONTISTR_TPU_SHARDS' ranks, one group
    after the other, each in a copy of newton_main_path's work directory
    cut to CONVERG ``SHARD_CONVERG``: u within 1e-8 of newton_main_path's
    u after as many iterations, Newton iterations equal, CG within 2 a
    solve, K1 launched on every rank (element = Newton iterations), the
    run's files written once and FSTR.dbg.<rank> by every rank."""
    want = by_node_id(ref["u"], ref["node_ids"])
    row = {}
    for n in shard_sizes():
        wd = copy_inputs(ref["wd"], ref["inputs"], os.path.join(
            ROOT, "build", "smoke", f"shard_newton_r{n}"), SHARD_CONVERG)
        t0 = time.perf_counter()
        ranks = pools[n].run(shard_rank_run, wd,
                             {"FRONTISTR_TPU_PRECISION": "f64"})
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        rel = float(np.abs(by_node_id(r0["u"], r0["node_ids"]) - want)
                    .max() / np.abs(want).max())
        cg_ref = ref["cg"][:ref["iters"]]
        log(f"phase shard_main_path: {n} rank(s), backend {r0['backend']}, "
            f"max rel diff to the one-device run {rel!r}; newton "
            f"{r0['iters']} vs {ref['iters']}, cg {r0['cg']} vs {cg_ref}; "
            f"the group's task {wall:.2f} s; {smi}")
        for g in ranks:
            tm = g["timings"]
            host = " ".join(f"{k}={tm.get(k, 0.0):.2f}" for k in
                            ("read", "reorder", "model", "profile"))
            ms = 1e3 * sum(g["solve_s"]) / max(sum(g["cg"]), 1)
            log(f"  rank {g['rank']}/{g['size']} {g['backend']} "
                f"{g['device']}: rows {g['rows'][0]}-{g['rows'][1]} of "
                f"{g['rows'][2]} nodes, K1 element {g['k1']} planes "
                f"{g['planes']}, peak {g['peak_gb']:.3f} GB, cg {g['cg']}, "
                f"solve s {[round(x, 3) for x in g['solve_s']]}, ms a CG "
                f"iteration {ms:.2f}, wall {g['wall']:.2f} s ({host}); "
                f"{smi}")
            if g["k1"] != r0["iters"] or g["k1"] < 1:
                raise AssertionError(f"shard_main_path: rank {g['rank']} of "
                                     f"{n} launched K1 {g['k1']} times for "
                                     f"{r0['iters']} Newton iterations")
        if not rel <= 1e-8:
            raise AssertionError(f"shard_main_path: {n} ranks: u off the "
                                 f"one-device run by {rel!r}")
        if r0["iters"] != ref["iters"] or len(r0["cg"]) != len(cg_ref) \
                or any(abs(a - b) > 2 for a, b in zip(r0["cg"], cg_ref)):
            raise AssertionError(f"shard_main_path: {n} ranks: Newton or CG "
                                 "counts off the one-device run")
        check_rank_files(wd, ref["inputs"], ref["outputs"], n,
                         "shard_main_path")
        row[f"ranks{n}"] = dict(
            backend=r0["backend"], rel=rel, cg=r0["cg"],
            k1=[g["k1"] for g in ranks],
            peak_gb=[g["peak_gb"] for g in ranks],
            solve_s=[sum(g["solve_s"]) for g in ranks],
            wall_s=[g["wall"] for g in ranks], task_s=wall)
    return row


def phase_shard_small_reference(mods, pools) -> None:
    """Small decks of every sharded family on one card, then under each
    group of shard ranks in a copy of the deck's work directory: linear
    STATIC in f64 and mixed, NLSTATIC through the AMG, implicit
    dynamics, EIGEN, transient HEAT and SLAGRANGE contact (the punch of
    6); answers within 1e-8 of the one-card run (eigenvalues and
    temperatures too), CG within 2 a solve (mixed: 2 + 10 %), the run's
    files written once and FSTR.dbg.<rank> by every rank."""
    base = os.path.join(ROOT, "build", "smoke", "shard")
    f64 = {"FRONTISTR_TPU_PRECISION": "f64"}

    def tet(cnt, dims):
        return lambda wd: write_workdir(wd, dims, mods["ordering"],
                                        mods["box_tet4"],
                                        mods["write_static_workdir"], cnt)
    decks = [("static f64", tet(CNT, (8, 6, 5)), f64),
             ("static mixed", tet(CNT, (8, 6, 5)),
              {"FRONTISTR_TPU_PRECISION": "mixed"}),
             ("nlstatic amg", tet(NLCNT.format(load=-100.0), (10, 8, 6)),
              dict(f64, FRONTISTR_TPU_PRECOND="amg")),
             ("dynamic implicit", tet(SHARD_DYN, (6, 5, 4)), f64),
             ("eigen", tet(SHARD_EIG, (6, 5, 4)), {}),
             ("heat", lambda wd: small_heat_deck(mods, "hex8", True, wd),
              {}),
             ("contact slagrange", lambda wd: write_contact_workdir(
                 wd, mods, punch_mesh(mods, 6), contact_cnt()), f64)]
    for i, (label, write, env) in enumerate(decks):
        wd = os.path.join(base, f"d{i}")
        shutil.rmtree(wd, ignore_errors=True)
        write(wd)
        inputs = sorted(os.listdir(wd))
        one = shard_summary(with_env(env, lambda: mods["run_directory"](
            wd, device="cuda")))
        outputs = sorted(set(os.listdir(wd)) - set(inputs))
        slack = (lambda k: 2 + 0.1 * k) if "mixed" in label else \
            (lambda k: 2)
        for n in shard_sizes():
            wdn = copy_inputs(wd, inputs, f"{wd}_r{n}")
            ranks = pools[n].run(shard_rank_run, wdn, env)
            r0 = ranks[0]
            rel = float(np.abs(r0["u"] - one["u"]).max()
                        / np.abs(one["u"]).max())
            cg, cg1 = (np.ravel(r0.get("cg", [r0.get("iters", 0)])),
                       np.ravel(one.get("cg", [one.get("iters", 0)])))
            log(f"phase shard_small_reference: {label}, {n} rank(s) "
                f"{r0['backend']}: max rel diff {rel!r}, cg {cg.tolist()} "
                f"vs {cg1.tolist()}, K1 element {[g['k1'] for g in ranks]}")
            if not rel <= 1e-8:
                raise AssertionError(f"shard_small_reference: {label}, {n} "
                                     f"ranks off the one-card run")
            if cg.shape != cg1.shape or np.any(
                    np.abs(cg - cg1) > slack(cg1.max())):
                raise AssertionError(f"shard_small_reference: {label}, {n} "
                                     "ranks: CG counts off")
            check_rank_files(wdn, inputs, outputs, n,
                             f"shard_small_reference: {label}")


def load_mods() -> dict:
    """The port's modules the phases use, by name."""
    sys.path.insert(0, ROOT)
    from frontistr_tpu_torch import kernels, meshgen, ordering
    from frontistr_tpu_torch.analysis import dynamic, eigen, heat, nonlinear
    from frontistr_tpu_torch.analysis import contact
    from frontistr_tpu_torch.analysis import static as stmod
    from frontistr_tpu_torch.contact import slag
    from frontistr_tpu_torch.assembly import bell, ell, extras, femop
    from frontistr_tpu_torch.assembly import structured
    from frontistr_tpu_torch.assembly import segsum as sm
    from frontistr_tpu_torch.assembly.loads import FACE_TABLES
    from frontistr_tpu_torch.assembly.model import build_struct_model
    from frontistr_tpu_torch.fem import fluid
    from frontistr_tpu_torch.elements.tables import (HECMW2FSTR_ORDER,
                                                     get_table)
    from frontistr_tpu_torch.io.meshio import ElemBlock, Equation
    from frontistr_tpu_torch.io.meshio import read_mesh
    from frontistr_tpu_torch.io.resfile import read_result
    from frontistr_tpu_torch.assembly.operators import make_free_mask
    from frontistr_tpu_torch.io import echo
    from frontistr_tpu_torch.io.ctrlio import read_cnt
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
    from frontistr_tpu_torch.microbench import gather as mb
    from frontistr_tpu_torch.microbench import segsum as mbs
    from frontistr_tpu_torch.ops import element_mv as em
    from frontistr_tpu_torch.ops import gather as g
    from frontistr_tpu_torch.post import nodal
    from frontistr_tpu_torch.run import run_directory
    from frontistr_tpu_torch.solver import amg, band, direct, ssor
    from frontistr_tpu_torch.parallel import dist, partition
    from frontistr_tpu_torch.vis import psf, pvr
    from frontistr_tpu_torch.assembly import profcache
    from frontistr_tpu_torch.assembly.loads import thermal_load
    from frontistr_tpu_torch.couple import mapping
    from frontistr_tpu_torch.io import vtk
    from frontistr_tpu_torch.microbench import box_twogrid
    from frontistr_tpu_torch.tools import cli
    return dict(psf=psf, pvr=pvr, partition=partition, dist=dist,
                profcache=profcache, thermal_load=thermal_load,
                mapping=mapping, vtk=vtk, box_twogrid=box_twogrid, cli=cli,
                extras=extras, direct=direct, Equation=Equation, ell=ell,
                band=band, eigen=eigen, fluid=fluid,
                ssor=ssor, echo=echo,
                segsum=sm, element_mv=em, static=stmod, bell=bell,
                structured=structured, ordering=ordering,
                nonlinear=nonlinear, box_tet4=box_tet4, box_hex8=box_hex8,
                build_struct_model=build_struct_model, read_cnt=read_cnt,
                write_static_workdir=write_static_workdir,
                run_directory=run_directory, amg=amg, nodal=nodal,
                make_free_mask=make_free_mask, face_tables=FACE_TABLES,
                hecmw2fstr=HECMW2FSTR_ORDER, ElemBlock=ElemBlock,
                read_result=read_result, dynamic=dynamic, gather=g,
                heat=heat, femop=femop, get_table=get_table,
                meshgen=meshgen, kernels=kernels, microbench_gather=mb,
                microbench_segsum=mbs, contact=contact, slag=slag,
                read_mesh=read_mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=40,
                    help="box_tet4(n, n, n) for the linear static tet path "
                         "(default 40)")
    ap.add_argument("--krylov-n", type=int, default=32,
                    help="box_tet4(k, k, k) for the Krylov menu's path "
                         "(default 32: 107,811 dofs; 69 is the newton "
                         "cell's 1,029,000)")
    ap.add_argument("--ssor-n", type=int, default=SSOR_N,
                    help=f"box_tet4(s, s, s) for the SSOR Newton path "
                         f"(default {SSOR_N}; 69 is the newton cell's)")
    ap.add_argument("--hex", type=int, default=69,
                    help="box_hex8(h, h, h) for the hex path (default 69)")
    ap.add_argument("--newton-n", type=int, default=69,
                    help="box_tet4(m, m, m) for the Newton path "
                         "(default 69)")
    ap.add_argument("--plastic", type=int, default=48,
                    help="box_hex8(p, p, p) for the elastoplastic path "
                         "(default 48)")
    ap.add_argument("--dyn-n", type=int, default=40,
                    help="box_tet4(m, m, m) for the explicit dynamics path "
                         "(default 40)")
    ap.add_argument("--dyn-steps", type=int, default=300,
                    help="explicit time steps (default 300)")
    ap.add_argument("--dyn-hex", type=int, default=40,
                    help="box_hex8(h, h, h) for the implicit dynamics path "
                         "(default 40)")
    ap.add_argument("--dyn-hex-steps", type=int, default=10,
                    help="implicit time steps (default 10)")
    ap.add_argument("--heat-n", type=int, default=50,
                    help="box_hex8(h, h, h) for the heat path (default 50: "
                         "132,651 dofs; 100 gives 1,030,301)")
    ap.add_argument("--heat-steps", type=int, default=20,
                    help="heat time steps (default 20)")
    ap.add_argument("--eigen-n", type=int, default=32,
                    help="box_hex8(e, e, e) for the eigen and frequency "
                         "response paths (default 32: 107,811 dofs)")
    ap.add_argument("--hex20-n", type=int, default=24,
                    help="the hex20 box of the hex20_mpc path (default 24: "
                         "181,875 dofs; 36 gives 595,515)")
    ap.add_argument("--direct-n", type=int, default=12,
                    help="box_hex8(d, d, d) for the METHOD=DIRECT path "
                         "(default 12: 6,591 dofs)")
    ap.add_argument("--plane-n", type=int, default=300,
                    help="the quad8 box of the plane path (default 300: "
                         "542,402 dofs; 408 gives 1,002,050)")
    ap.add_argument("--hyper-n", type=int, default=20,
                    help="the hex20 box of the hyperelastic path "
                         "(default 20: 107,163 dofs)")
    ap.add_argument("--hyper-substeps", type=int, default=4,
                    help="substeps of the hyperelastic path (default 4)")
    ap.add_argument("--contact-n", type=int, default=48,
                    help="the lower box of the contact punch path, n x n x "
                         "n/2 (default 48: 339,123 dofs; 72 gives "
                         "1,135,947)")
    ap.add_argument("--flow-n", type=int, default=62,
                    help="the box_tet4 cube of the flow path, made 3414 "
                         "(default 62: 1,000,188 dofs)")
    ap.add_argument("--flow-steps", type=int, default=2,
                    help="time steps of the flow path (default 2)")
    ap.add_argument("--shell-n", type=int, default=300,
                    help="the MITC4 plate of the shell path, n x n "
                         "(default 300: 543,606 dofs; 408 gives "
                         "1,003,686)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    mods = load_mods()
    # the profile cache is on by default; only the cache phase writes one
    os.environ["FRONTISTR_TPU_CACHE_DIR"] = "0"
    sm, em, g = mods["segsum"], mods["element_mv"], mods["gather"]
    bell, stmod = mods["bell"], mods["static"]
    box_tet4, box_hex8 = mods["box_tet4"], mods["box_hex8"]
    mb, mbs = mods["microbench_gather"], mods["microbench_segsum"]
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"phase device: torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), {kind}, {torch.cuda.device_count()} "
        f"device(s); {smi}")

    # 2. build: one nvcc per kernel source, all at once
    t0 = time.perf_counter()
    libs = mods["kernels"].build(verbose=True)
    log(f"phase build: {', '.join(os.path.relpath(p, ROOT) for p in libs.values())} "
        f"in {time.perf_counter() - t0:.2f} s")

    # the shard phases' ranks come up while the other phases run
    shard_pools = start_shard_pools(mods)

    # 3. each kernel against its plain version
    log("phase k1_check:")
    phase_k1_check(sm, bell, box_tet4, box_hex8,
                   lambda dims: tet10_mesh(mods, dims),
                   lambda dims: hex20_mesh(mods, dims))
    log("phase k1_nd6_check:")
    phase_k1_nd6_check(sm, bell, mods["meshgen"])
    log("phase k2_check:")
    phase_k2_check(em)
    log("phase gather_check:")
    gather_errs = phase_gather_check(g, mb)

    # 4. the Newton tet path (K1 once per Newton iteration, its planes
    #    entry twice per AMG setup and once per nodal smoothing), then the
    #    AMG setup twice and K1 at the path's shapes (after the counts)
    newton_ref = {}
    model, k1_launches, planes_launches = phase_newton_main_path(
        args, mods, newton_ref)
    planes = phase_amg_repeat(mods, model, planes_launches)
    k1_row = phase_k1_time(sm, mbs, bell, stmod, model, k1_launches)
    k1_row["planes"] = planes
    # the profile cache at that mesh: cold build and save, then load
    k1_row["cache"] = phase_cache(mods, model)
    del model
    torch.cuda.empty_cache()
    # 4b. the same deck on the shard ranks (K1 on every rank), cut to
    #     CONVERG SHARD_CONVERG, held to newton_main_path at that depth
    k1_row["shard_main_path"] = phase_shard_main_path(args, mods, shard_pools,
                                                      newton_ref, smi)
    del newton_ref
    torch.cuda.empty_cache()
    # the ranks' cached device memory (15-25 GB each) back to the card:
    # fresh ranks for the small decks come up while the other phases run
    for pool in shard_pools.values():
        pool.close()
    shard_pools = start_shard_pools(mods)

    # 5. the linear static tet path (K1); the Krylov menu on the newton
    #    cell's mesh (K1 once at the scalar-ELL plan), then K1 at that
    #    plan; the Newton path with PRECOND=10 (SSOR)
    model, _ = phase_tet_main_path(args, mods)
    torch.cuda.empty_cache()
    kry = phase_krylov_main_path(args, mods, model)
    del model
    ell_row = phase_k1_ell_time(mods, kry.pop("model"), kry.pop("kes"),
                                kry["launches"])
    ell_row["krylov_main_path"] = kry["rows"]
    del kry
    torch.cuda.empty_cache()
    k1_row["ssor_main_path"] = phase_ssor_main_path(
        args, mods, k1_launches if args.ssor_n == args.newton_n else None)
    torch.cuda.empty_cache()

    # 6. the hex path (K2), then K2 at its shapes (after the counts)
    model, res, k2_launches = phase_hex_main_path(args, mods)
    k2_row = phase_k2_time(mods, model, res, k2_launches)
    del model, res
    torch.cuda.empty_cache()
    # 6b. the box arm's two-grid solve (K2 on every fine and coarse
    #     product), then K2 at the coarse shape
    k2_row["twogrid_main_path"] = phase_box_main_path(mods)
    torch.cuda.empty_cache()

    # 7. the elastoplastic path (K1 once per Newton iteration), then K1
    #    at m = 30 (tet10)
    plastic = {}
    with Committed(mods["nonlinear"]) as kept:
        k1_row["plastic_main_path"] = phase_plastic_main_path(args, mods,
                                                              plastic)
    plastic["states"] = kept.last(1)
    del kept
    k1_row["restart_main_path"] = phase_restart_main_path(args, mods,
                                                          plastic)
    del plastic
    torch.cuda.empty_cache()
    k1_row["m30"] = phase_k1_m30_time(mods, 24)
    torch.cuda.empty_cache()

    # 8. the gather microbenchmark (K3-K6)
    gather_rows = phase_gather_time(g, mb, gather_errs)

    # 9. small decks on the card and on the CPU
    phase_small_reference(mods)
    phase_hex_small_reference(mods)
    phase_newton_small_reference(mods)
    phase_plastic_small_reference(mods)

    # 10. the dynamics paths (the matrix-free operator and the incidence
    #     gather-sum; K1's planes entry once, in the final nodal
    #     smoothing), then small decks on the card and on the CPU
    torch.cuda.empty_cache()
    k1_row["dynamic_explicit_main_path"] = \
        phase_dynamic_explicit_main_path(args, mods)
    torch.cuda.empty_cache()
    k1_row["dynamic_implicit_main_path"] = \
        phase_dynamic_implicit_main_path(args, mods)
    torch.cuda.empty_cache()
    phase_dynamic_small_reference(mods)

    # 11. the heat path, the eigen path and the frequency response from
    #     its files (the matrix-free operator and the incidence
    #     gather-sum, no kernel), then small decks on the card and on the
    #     CPU, STATICEIGEN's K1 launches among them
    torch.cuda.empty_cache()
    phase_heat_main_path(args, mods)
    torch.cuda.empty_cache()
    wd, mesh, er = phase_eigen_main_path(args, mods)
    phase_freq_main_path(mods, wd, mesh, er)
    del mesh
    torch.cuda.empty_cache()
    # the band Cholesky (FRONTISTR_TPU_DIRECT=band) on that cube, in
    # Newmark on its box and at the direct cell
    band_rows = phase_band(args, mods, wd, er)
    del er
    torch.cuda.empty_cache()
    k1_row["staticeigen_small_reference"] = \
        phase_heat_eigen_small_reference(mods)

    # 12. the hex20_mpc path (K1 once per Newton iteration at m = 60 with
    #     the spring block, its planes entry in the AMG setups, the nodal
    #     smoothing and every MPC reduction), then K1 at its shapes;
    #     METHOD=DIRECT; small decks of this slice on the card and the CPU
    torch.cuda.empty_cache()
    cell = phase_hex20_mpc_main_path(args, mods)
    k1_m60_row = phase_k1_m60_time(mods, cell.pop("model"), cell.pop("kes"),
                                   cell["launches"])
    k1_m60_row["hex20_mpc_main_path"] = cell
    torch.cuda.empty_cache()
    k1_m60_row["direct"] = phase_direct(args, mods)
    torch.cuda.empty_cache()
    phase_extras_small_reference(mods)

    # 13. the plane path (K1's nd = 2 element entry once per Newton
    #     iteration, its planes entry in the 2-D AMG setups and the nodal
    #     smoothing), then K1 at nd = 2 at its shapes; the NEOHOOKE
    #     hex20_mpc deck; small decks of this slice on the card and the
    #     CPU
    torch.cuda.empty_cache()
    cell = phase_plane_main_path(args, mods)
    nd2_rows = phase_k1_nd2_time(mods, cell.pop("model"), cell.pop("kes"),
                                 cell)
    del cell
    torch.cuda.empty_cache()
    k1_m60_row["hyper_main_path"] = phase_hyper_main_path(args, mods)
    torch.cuda.empty_cache()
    phase_materials_small_reference(mods)

    # 14. the contact punch (K1's planes entry in every SLAGRANGE
    #     reduction T^T and the nodal smoothing), then the planes entry at
    #     its slot plan; small contact decks on the card and the CPU
    torch.cuda.empty_cache()
    contact_row = phase_contact_planes_time(
        mods, phase_contact_main_path(args, mods))
    torch.cuda.empty_cache()
    phase_contact_small_reference(mods)

    # 15. the small decks of the solver menu and !RESTART on the card and
    #     the CPU
    torch.cuda.empty_cache()
    phase_solvers_small_reference(mods)

    # 16. the shell plate (K1's nd = 6 element entry once per run, its
    #     planes entry once in the shells' nodal sums), then K1 at nd = 6
    #     at its shapes; small shell, solid-shell and beam decks on the
    #     card and the CPU
    torch.cuda.empty_cache()
    cell = phase_shell_main_path(args, mods)
    nd6_row = phase_k1_nd6_time(mods, cell.pop("model"), cell.pop("kes"),
                                cell)
    del cell
    torch.cuda.empty_cache()
    phase_shell_small_reference(mods)

    # 17. the lid-driven cavity (K1's nd = 4 element entry and its planes
    #     entry once a step), then K1 at nd = 4 at its shapes; small flow,
    #     band and PRECHECK decks on the card and the CPU
    torch.cuda.empty_cache()
    cell = phase_flow_main_path(args, mods)
    nd4_row = phase_k1_nd4_time(mods, cell)
    nd4_row["band"] = band_rows
    del cell
    torch.cuda.empty_cache()
    phase_flow_band_small_reference(mods)

    # 18. the visual cell: an ABAQUS box refined on load, STATIC (K1's
    #     element entry once, its planes entry in the AMG setup and the
    #     nodal smoothing), the PVR volume on the card and the PSR surface
    #     on the host; small decks of the readers, REFINE, HECMW-DIST and
    #     the pictures on the card and the CPU
    torch.cuda.empty_cache()
    k1_row["visual_main_path"] = phase_visual_main_path(mods)
    torch.cuda.empty_cache()
    phase_visual_small_reference(mods)

    # 19. small decks of the tools (part, rmerge, rconv, VTK, rebalance
    #     with adaptive refinement), of coupling (a peer process, the
    #     staggered transfer) and of the box solve on the card and the CPU
    torch.cuda.empty_cache()
    phase_tools_small_reference(mods)
    phase_couple_small_reference(mods)
    phase_box_small_reference(mods)

    # 20. small decks of every sharded family on the shard ranks and on
    #     one card; the ranks are stopped
    torch.cuda.empty_cache()
    phase_shard_small_reference(mods, shard_pools)
    for pool in shard_pools.values():
        pool.close()

    log(f"phase total: {time.perf_counter() - t_start:.2f} s")
    log(smi)
    log(json.dumps({"kernels": [k1_row, ell_row, k1_m60_row] + nd2_rows
                    + [nd6_row, nd4_row, contact_row, k2_row]
                    + gather_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
