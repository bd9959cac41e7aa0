"""Contact deck helpers of the port's contact parity tests: two boxes in
node-to-surface contact from ``meshgen.contact_pair`` written to a work
directory, the decks of the JAX package's contact tests
(``tests/test_contact.py``, ``test_contact_mpc.py``,
``test_dynamic_contact.py``) as ``.cnt`` text, and ``run_both``, which
runs one deck through both packages' ``run_directory`` on the CPU and
records, in each, every contact pass's Newton iterations and active set
and the count of contact searches."""

import shutil

import numpy as np

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.meshio import Equation
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import contact_pair

GROUPS = ("ALL", "LOW", "BOT", "TOP", "SLAVE", "X0", "Y0")


def pair_mesh(kind: str):
    """"cubes": two stacked unit cubes of one hex8 each (the JAX
    package's two-block decks); "block2": two unit cubes of two hex8
    each, stacked (``test_contact_mpc._two_block``); "punch": a 3 x 3 x 2
    lower box of 1 x 1 x 0.5 under a 2 x 2 x 2 upper box of 0.9 x 0.9 x
    0.45 (meshes that do not match); "punch6": the full-width flat punch
    cut to n = 6 (``chip_smoke.punch_mesh``: 6 x 6 x 3 under 5 x 5 x 2
    over the same sizes); "gap": "cubes" with the upper one 0.05 above
    the lower."""
    if kind == "cubes":
        return contact_pair((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                            (1.0, 1.0, 1.0))
    if kind == "gap":
        return contact_pair((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                            (1.0, 1.0, 1.0), gap=0.05)
    if kind == "block2":
        return contact_pair((1, 1, 2), (1, 1, 2), (1.0, 1.0, 1.0),
                            (1.0, 1.0, 1.0))
    if kind == "punch":
        return contact_pair((3, 3, 2), (2, 2, 2), (1.0, 1.0, 0.5),
                            (0.9, 0.9, 0.45))
    if kind == "punch6":
        return contact_pair((6, 6, 3), (5, 5, 2), (1.0, 1.0, 0.5),
                            (0.9, 0.9, 0.45))
    raise ValueError(kind)


def tie(mesh, where: str = "mid"):
    """A redundant !EQUATION u3(a) = u3(b): "mid" two nodes of the lower
    box's middle layer (z = 0.5, disjoint from the contact surfaces),
    "slave" two slave nodes (on the contact surface).  Returns (a, b)."""
    if where == "slave":
        nodes = mesh.node_groups["SLAVE"]
    else:
        low = mesh.node_groups["LOW"]
        nodes = low[np.isclose(mesh.coords[low, 2], 0.5)]
    a, b = int(nodes[0]), int(nodes[-1])
    mesh.equations = [Equation(np.asarray([a, b]), np.asarray([3, 3]),
                               np.asarray([1.0, -1.0]), 0.0)]
    return a, b


def write_deck(path, mesh, cnt, seed=None) -> str:
    """The deck in ``path``: node groups ``GROUPS``, surface group MAST,
    the contact pair; the nodes shuffled when ``seed`` is given."""
    if seed is not None:
        order = np.random.default_rng(seed).permutation(mesh.n_node)
        mesh = ordering.permute_mesh(mesh, order)
    write_static_workdir(str(path), mesh, cnt,
                         ngroups=[g for g in GROUPS if g in mesh.node_groups],
                         sgroups={"MAST": mesh.surf_groups["MAST"]})
    return str(path)


def static_cnt(algo="SLAGRANGE", sol="NLSTATIC", bc=None, mu="0.0",
               sub=2, conv="1.0e-7", method="CG", resid="1.0e-12",
               loads="", nu="0.0", step_extra=""):
    """A static contact deck: by default BOT fixed in z, X0 in x, Y0 in
    y, TOP pushed 0.01 down (``test_contact.test_two_block_compression``),
    E = 1000."""
    if bc is None:
        bc = (" BOT, 3, 3, 0.0\n X0, 1, 1, 0.0\n Y0, 2, 2, 0.0\n"
              " TOP, 3, 3, -0.01\n")
    return (f"!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY, GRPID=1\n"
            f"{bc}{loads}!CONTACT_ALGO, TYPE={algo}\n!CONTACT, GRPID=1\n"
            f" CP1, {mu}\n!STEP, SUBSTEPS={sub}, CONVERG={conv}\n"
            f" BOUNDARY, 1\n LOAD, 1\n CONTACT, 1\n{step_extra}"
            f"!MATERIAL, NAME=M1\n!ELASTIC\n 1000.0, {nu}\n!DENSITY\n 1.0\n"
            f"!SOLVER, METHOD={method}, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
            f" 10000, 1\n {resid}, 1.0, 0.0\n!END\n")


def dyn_cnt(n_step, dt, algo="ALAGRANGE", ray_m=2.0, fz=-2.0, gamma=0.5,
            beta=0.25, bc=" BOT, 3, 3, 0.0\n ALL, 1, 2, 0.0\n",
            eqa=1, resid="1.0e-12", conv="1.0e-7"):
    """An implicit DYNAMIC contact deck (``test_dynamic_contact._cnt``):
    the upper box's top loaded ``fz`` a node, rho = 1, E = 1000."""
    return (f"!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n {eqa}, 1\n"
            f" 0.0, {n_step * dt}, {n_step}, {dt}\n {gamma}, {beta}\n"
            f" 1, 1, {ray_m}, 0.0\n 10\n!BOUNDARY, GRPID=1\n{bc}"
            f"!CLOAD, GRPID=1\n TOP, 3, {fz}\n!CONTACT_ALGO, TYPE={algo}\n"
            f"!CONTACT, GRPID=1\n CP1, 0.0\n!STEP, SUBSTEPS=1, "
            f"CONVERG={conv}\n BOUNDARY, 1\n LOAD, 1\n CONTACT, 1\n"
            f"!MATERIAL, NAME=M1\n!ELASTIC\n 1000.0, 0.0\n!DENSITY\n 1.0\n"
            f"!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
            f" 10000, 1\n {resid}, 1.0, 0.0\n!END\n")


def _trace(monkeypatch, nl_mod, cm_cls, passes, counts, port: bool):
    """Record every contact pass (Newton iterations, converged, active
    set) of ``nl_mod._newton_substep`` and count ``cm_cls.search``."""
    real_sub, real_search = nl_mod._newton_substep, cm_cls.search

    def substep(*a, **kw):
        out = real_sub(*a, **kw)
        if port:
            c = kw.get("contact")
            cm = None if c is None else c.cm
            slag = c is not None and c.slag is not None
        else:
            cm = kw.get("cm")
            slag = kw.get("slag") is not None
        if cm is not None:
            act = cm._last_cact if slag else cm.lam > 0
            passes.append((out[3], bool(out[0]),
                           np.flatnonzero(np.asarray(act)).tolist()))
        return out

    def search(self, *a, **kw):
        counts["search"] = counts.get("search", 0) + 1
        return real_search(self, *a, **kw)
    monkeypatch.setattr(nl_mod, "_newton_substep", substep)
    monkeypatch.setattr(cm_cls, "search", search)


def run_both(tmp_path, mesh, cnt, monkeypatch, seed=3, jcnt=None):
    """The deck through the port (``device="cpu"``) and the JAX package,
    each in its own copy of the work directory (the JAX package's copy
    with the control file ``jcnt`` when given).  Returns (port output,
    JAX output, port trace, JAX trace); a trace holds "passes" (per
    contact pass: Newton iterations, converged, active slots) and
    "search" (the count of contact searches)."""
    import frontistr_tpu.analysis.nonlinear as jnl
    import frontistr_tpu.contact.ntos as jntos
    import frontistr_tpu.run as jrun
    from frontistr_tpu_torch.analysis import nonlinear as nl
    from frontistr_tpu_torch.contact import ntos
    from frontistr_tpu_torch.run import run_directory
    wd = write_deck(tmp_path / "port", mesh, cnt, seed)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    if jcnt is not None:
        with open(f"{wj}/case.cnt", "w") as f:
            f.write(jcnt)
    tp, tj = dict(passes=[]), dict(passes=[])
    _trace(monkeypatch, nl, ntos.ContactManager, tp["passes"], tp, True)
    _trace(monkeypatch, jnl, jntos.ContactManager, tj["passes"], tj, False)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    return ot, oj, tp, tj


def close(a, b, rel=1e-8):
    """``a`` within ``rel`` x max|b| of ``b``, finite, the same shape."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    err = np.abs(a - b).max()
    assert err <= rel * np.abs(b).max(), (err, np.abs(b).max())
