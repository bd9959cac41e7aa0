"""The contact building blocks of the port against the JAX package on the
CPU: the ``!CONTACT PAIR`` parse, ``ContactManager``'s search, penalty
blocks (with the Coulomb return map) and AL update on two boxes whose
meshes do not match, ``ContactEliminator``'s T, T^T, wrap, recovery,
reduction and pressure, ``bicgstab`` and ``minres``, and the two
deliberate deviations of the SLAGRANGE arm (ROADMAP queue 3): the
preconditioner restricted to the reduced space (fault 5) and no
Dirichlet-fixed dof as a master of a slot (fault 6).

Bars: the search, the blocks and the AL update are the same numpy in
both packages, so they are bit-equal; the eliminator's products within
1e-12 x their largest; the Krylov iterates within 1e-12 (MINRES's
converged answer within 1e-8) and their counts equal.  Inputs come
from ``numpy.random.default_rng`` seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.contact import ntos as jntos
from frontistr_tpu.contact.slag import ContactEliminator as JElim
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.meshio import read_mesh as jread_mesh
from frontistr_tpu.solver import cg as jcg
from frontistr_tpu.solver.minres import minres as jminres
from frontistr_tpu_torch.analysis.static import compute_element_stiffness
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.contact import ntos
from frontistr_tpu_torch.assembly.segsum import IndexAdd
from frontistr_tpu_torch.contact.slag import ContactEliminator
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.meshio import read_mesh
from frontistr_tpu_torch.solver import direct
from frontistr_tpu_torch.solver.cg import bicgstab, pcg
from frontistr_tpu_torch.solver.minres import minres

from _torch_contact_decks import pair_mesh, static_cnt, write_deck


def _models(tmp_path, mu="0.3", kind="punch"):
    """Both packages' models of the deck read from one work directory."""
    wd = write_deck(tmp_path / "wd", pair_mesh(kind),
                    static_cnt("ALAGRANGE", mu=mu), seed=7)
    msh, cnt = f"{wd}/mesh.msh", f"{wd}/case.cnt"
    mesh, jmesh = read_mesh(msh), jread_mesh(msh)
    model = build_struct_model(mesh, read_cnt(cnt), device="cpu")
    jmodel = jbuild(jmesh, jread_cnt(cnt))
    return model, jmodel


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_contact_pair_parse_matches_jax(tmp_path):
    """The port's reader gives the JAX package's pair, slave node group
    and master surface group."""
    wd = write_deck(tmp_path / "wd", pair_mesh("punch"), static_cnt(),
                    seed=7)
    mesh, jmesh = read_mesh(f"{wd}/mesh.msh"), jread_mesh(f"{wd}/mesh.msh")
    assert [(p.name, p.ctype, p.slave, p.master)
            for p in mesh.contact_pairs] == \
        [(p.name, p.ctype, p.slave, p.master)
         for p in jmesh.contact_pairs] == \
        [("CP1", "NODE-SURF", "SLAVE", "MAST")]
    assert np.array_equal(mesh.node_groups["SLAVE"],
                          jmesh.node_groups["SLAVE"])
    assert np.array_equal(mesh.surf_groups["MAST"],
                          jmesh.surf_groups["MAST"])
    assert len(mesh.surf_groups["MAST"]) == 9


@pytest.mark.parametrize("search_bytes", [None, 64])
def test_search_blocks_augment_bit_equal(tmp_path, monkeypatch,
                                         search_bytes):
    """Two searches at perturbed, penetrating configurations, the
    penalty blocks with friction (some slots sticking, some slipping)
    and the AL update: bit-equal, with the candidate search in one
    block or one slave row at a time."""
    if search_bytes is not None:
        monkeypatch.setattr(ntos, "SEARCH_BYTES", search_bytes)
    model, jmodel = _models(tmp_path)
    cm = ntos.ContactManager(model.mesh, model, model.cfg)
    jcm = jntos.ContactManager(jmodel.mesh, jmodel, jmodel.cfg)
    assert cm.has_friction and cm.kn == jcm.kn
    rng = np.random.default_rng(11)
    slave = cm.all_slaves
    for k in range(2):
        disp = rng.uniform(-1e-3, 1e-3, model.coords.shape)
        disp[slave, 2] -= 2e-3 * (k + 1)
        disp[slave, 0] += 4e-3 * k
        proj = cm.search(model.coords + disp)
        jproj = jcm.search(jmodel.coords + disp)
        _same(proj, jproj)
        if k == 0:
            lam = rng.uniform(0.0, 50.0, len(slave))
            cm.lam, jcm.lam = lam.copy(), lam.copy()
    out, jout = cm.device_blocks(proj), jcm.device_blocks(jproj)
    for a, b in zip(out, jout):
        assert np.array_equal(a, b)
    assert np.array_equal(cm._t_trial, jcm._t_trial)
    assert out[3].any() and not out[3].all()
    cm.augment(proj)
    jcm.augment(jproj)
    for name in ("lam", "lam_t", "rel_prev"):
        assert np.array_equal(getattr(cm, name), getattr(jcm, name)), name


def _slots(tmp_path, tilt=False):
    """A search of the punch boxes pressed together and both packages'
    slot tables of it (every touching slot active but one);
    ``tilt`` turns every normal off the z axis."""
    model, _ = _models(tmp_path, mu="0.0")
    cm = ntos.ContactManager(model.mesh, model, model.cfg)
    rng = np.random.default_rng(5)
    disp = rng.uniform(-2e-3, 2e-3, model.coords.shape)
    proj = cm.search(model.coords + disp)
    if tilt:
        nrm = np.asarray([0.2, -0.1, -1.0]) / np.linalg.norm([0.2, -0.1,
                                                               1.0])
        proj["normal"] = np.tile(nrm, (len(proj["gap"]), 1))
    act = proj["touching"].copy()
    act[0] = False
    return model, cm, proj, act


def test_eliminator_matches_jax(tmp_path):
    """T, T^T, g, wrap, recover, reduce_rhs and lagrange on random
    vectors, against the JAX package's on the same slots (the JAX
    package's tables: no free mask)."""
    model, cm, proj, act = _slots(tmp_path)
    n, nd = model.n_dof_total, model.ndof
    elim = ContactEliminator(n, nd, "cpu")
    cn = elim.build(proj, cm.all_slaves, act)
    jelim = JElim(n, nd)
    jcn = jelim.build(proj, cm.all_slaves, act)
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    S = R @ R.T + np.eye(n)
    xt, yt, St = (torch.as_tensor(v) for v in (x, y, S))

    def A(v):
        return St @ v

    def jA(v):
        return jnp.asarray(S) @ v
    pairs = [
        (elim.T(cn, xt), jelim.T(jcn, jnp.asarray(x))),
        (elim.Tt(cn, yt), jelim.Tt(jcn, jnp.asarray(y))),
        (elim.g(cn), jelim.g(jcn)),
        (elim.wrap(cn, A)(xt), jelim.wrap(jcn, jA)(jnp.asarray(x))),
        (elim.recover(cn, xt), jelim.recover(jcn, jnp.asarray(x))),
        (elim.reduce_rhs(cn, A, yt),
         jelim.reduce_rhs(jcn, jA, jnp.asarray(y))),
        (elim.lagrange(cn, yt), jelim.lagrange(jcn, jnp.asarray(y))),
        (elim.dep_mask(cn), jelim.dep_mask(jcn))]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-12 * max(np.abs(want).max(), 1.0)
    assert np.count_nonzero(cn.mask == 0.0) == act.sum()
    # the scan's pressure from the pivots alone is lagrange's, bit-equal
    assert torch.equal(elim.pressure(proj, cm.all_slaves, act, yt),
                       elim.lagrange(cn, yt))


def test_quad4_projection_matches_jax_per_point():
    """``_project``'s quad4 Newton, all points at once, against the JAX
    package's point-by-point loop: bit-equal, on faces near and far
    (inside, outside, Newton not converged in 20 steps), a face folded
    flat (a singular 2 x 2 system) and a face shrunk to a point (no
    normal)."""
    rng = np.random.default_rng(17)
    F = 40
    base = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    corners = base[None] * rng.uniform(0.5, 2.0, (F, 1, 1)) + \
        rng.normal(0, 0.15, (F, 4, 3)) + rng.uniform(-3, 3, (F, 1, 3))
    corners[1] = corners[1, 0]                       # a point
    corners[2, 2:] = corners[2, 1::-1]               # folded flat
    coords = corners.reshape(-1, 3)
    faces = np.arange(4 * F).reshape(F, 4)
    for spread in (0.05, 0.5, 5.0):
        fi = rng.integers(0, F, 600)
        xs = corners[fi].mean(1) + rng.normal(0, spread, (600, 3))
        fnn = np.full(600, 4)
        got = ntos._project(xs, faces[fi], fnn, coords, 3)
        want = jntos._project(xs, faces[fi], fnn, coords, 3)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert got[3].any() and not got[3].all()


def test_index_add_matches_index_add(tmp_path):
    """``IndexAdd`` (the reductions' plan through K1's planes entry) on
    repeated targets equals ``index_add_``."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 50, 400)
    v, y = rng.standard_normal(400), rng.standard_normal(60)
    got = IndexAdd.build(idx, "cpu")(torch.as_tensor(y), torch.as_tensor(v))
    want = torch.as_tensor(y).index_add(0, torch.as_tensor(idx),
                                        torch.as_tensor(v))
    assert torch.allclose(got, want, rtol=0, atol=1e-13)


def _stiffness(model, free):
    """The punch model's dense K and its constrained A = P K P + (I-P)."""
    kes = compute_element_stiffness(model)
    K = direct.assemble_csr(kes, [b.dofs for b in model.blocks],
                            model.n_dof_total).toarray()
    P = np.diag(free)
    return K, P @ K @ P + np.diag(1.0 - free)


def test_fixed_masters_stay_fixed(tmp_path):
    """Fault 6: with tilted normals, slots whose masters include
    Dirichlet-fixed dofs (the X0 and Y0 planes, the lower box's bottom).
    The JAX package's elimination adds dependent rows into the fixed
    rows, so its solve moves fixed dofs off their prescribed increment;
    the port's (``build`` with the free mask and the increment) keeps
    every fixed dof at it and closes every active gap."""
    model, cm, proj, act = _slots(tmp_path, tilt=True)
    n, nd = model.n_dof_total, model.ndof
    free = np.ones(n)
    free[model.fixed_dofs] = 0.0
    dinc = np.zeros(n)
    dinc[model.fixed_dofs] = np.random.default_rng(2).uniform(
        -1e-3, 1e-3, len(model.fixed_dofs)) * (model.fixed_vals != 0.0)
    K, A0 = _stiffness(model, free)
    b = (np.random.default_rng(4).standard_normal(n) - K @ dinc) * free \
        + dinc * (1.0 - free)

    def solve(elim, cn, to, back):
        """The eliminated system solved densely, recovered."""
        def A(v):
            return to(A0) @ v
        Ar = np.stack([back(elim.wrap(cn, A)(to(np.eye(n)[:, j])))
                       for j in range(n)], 1)
        xr = np.linalg.solve(Ar, back(elim.reduce_rhs(cn, A, to(b))))
        return back(elim.recover(cn, to(xr)))
    jelim = JElim(n, nd)
    xj = solve(jelim, jelim.build(proj, cm.all_slaves, act), jnp.asarray,
               np.asarray)
    elim = ContactEliminator(n, nd, "cpu")
    xp = solve(elim, elim.build(proj, cm.all_slaves, act, free, dinc),
               torch.as_tensor, lambda t: t.numpy())
    fixed = free == 0.0
    assert np.abs(xj[fixed] - dinc[fixed]).max() > 1e-6
    assert np.abs(xp[fixed] - dinc[fixed]).max() <= 1e-14
    # every active slot's gap closes: n . (u_s - sum shp u_m) = -gap
    u = xp.reshape(-1, nd)
    s = np.flatnonzero(act)
    conn, shp, nrm = proj["conn"][s], proj["shape"][s], proj["normal"][s]
    rel = u[conn[:, 0]] - np.einsum("sk,skd->sd", shp, u[conn[:, 1:]])
    assert np.abs((rel * nrm).sum(1) + proj["gap"][s]).max() < 1e-12


def test_restricted_preconditioner(tmp_path):
    """Fault 5 on contact: block-Jacobi CG on the eliminated system takes
    the JAX package's count with the JAX package's preconditioner (the
    whole K's), fewer with the port's restricted one, and both answers
    agree to 1e-8."""
    model, cm, proj, act = _slots(tmp_path)
    n, nd = model.n_dof_total, model.ndof
    free = np.ones(n)
    free[model.fixed_dofs] = 0.0
    K, A0 = _stiffness(model, free)
    blocks = [A0[i:i + nd, i:i + nd] for i in range(0, n, nd)]
    Minv = np.zeros((n, n))
    for k, blk in enumerate(blocks):
        Minv[k * nd:(k + 1) * nd, k * nd:(k + 1) * nd] = np.linalg.inv(blk)
    b = np.random.default_rng(8).standard_normal(n) * free
    jelim = JElim(n, nd)
    jcn = jelim.build(proj, cm.all_slaves, act)
    res_j = jcg.pcg(jelim.wrap(jcn, lambda v: jnp.asarray(A0) @ v),
                    jelim.reduce_rhs(jcn, lambda v: jnp.asarray(A0) @ v,
                                     jnp.asarray(b)),
                    M=lambda r: jnp.asarray(Minv) @ r, tol=1e-10)
    elim = ContactEliminator(n, nd, "cpu")
    cn = elim.build(proj, cm.all_slaves, act)
    At, Mt = torch.as_tensor(A0), torch.as_tensor(Minv)
    A = elim.wrap(cn, lambda v: At @ v)
    b_r = elim.reduce_rhs(cn, lambda v: At @ v, torch.as_tensor(b))
    full = pcg(A, b_r, M=lambda r: Mt @ r, tol=1e-10)
    red = pcg(A, b_r, M=lambda r: cn.mask * (Mt @ (r * cn.mask))
              + r * (1.0 - cn.mask), tol=1e-10)
    assert full.iters == int(res_j.iters)
    assert red.iters < full.iters
    xf, xr = elim.recover(cn, full.x), elim.recover(cn, red.x)
    assert torch.abs(xf - xr).max() <= 1e-8 * torch.abs(xf).max()


def test_bicgstab_matches_jax():
    """A nonsymmetric, diagonally dominant system with a Jacobi
    preconditioner: the iterate after every step and the count."""
    rng = np.random.default_rng(0)
    n = 40
    A = rng.standard_normal((n, n)) * 0.3 + 4.0 * np.eye(n) + \
        np.triu(rng.standard_normal((n, n)), 1) * 0.5
    b, d = rng.standard_normal(n), 1.0 / np.diag(A)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    for k in (1, 2, 5, 200):
        r = bicgstab(lambda x: At @ x, torch.as_tensor(b),
                     M=lambda v: dt * v, tol=1e-12, maxiter=k)
        rj = jcg.bicgstab(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                          M=lambda v: jnp.asarray(d) * v, tol=1e-12,
                          maxiter=k)
        assert r.iters == int(rj.iters)
        assert np.abs(r.x.numpy() - np.asarray(rj.x)).max() <= 1e-12
    assert r.converged and r.iters < 200


def test_minres_matches_jax():
    """A symmetric indefinite saddle system [K B^T; B 0] with a
    block-diagonal SPD preconditioner: the iterate after every step and
    the count."""
    rng = np.random.default_rng(1)
    n, m = 30, 6
    R = rng.standard_normal((n, n))
    K = R @ R.T / n + np.eye(n)
    B = rng.standard_normal((m, n))
    S = np.block([[K, B.T], [B, np.zeros((m, m))]])
    dm = np.concatenate([1.0 / np.diag(K), np.ones(m)])
    b = rng.standard_normal(n + m)
    St, dt = torch.as_tensor(S), torch.as_tensor(dm)
    # the first iterates within 1e-12; once the Lanczos vectors lose
    # orthogonality (past about 15 steps here) the two packages' rounding
    # drifts apart, so the converged run (to 1e-8) holds the count and
    # the answer within 1e-8
    for k, tol, bar in ((1, 1e-12, 1e-12), (2, 1e-12, 1e-12),
                        (5, 1e-12, 1e-12), (500, 1e-8, 1e-8)):
        r = minres(lambda x: St @ x, torch.as_tensor(b), M=lambda v: dt * v,
                   tol=tol, maxiter=k)
        rj = jminres(lambda x: jnp.asarray(S) @ x, jnp.asarray(b),
                     M=lambda v: jnp.asarray(dm) * v, tol=tol, maxiter=k)
        assert r.iters == int(rj.iters)
        assert np.abs(r.x.numpy() - np.asarray(rj.x)).max() <= \
            bar * np.abs(np.asarray(rj.x)).max()
    assert r.converged and r.iters < 500
    assert np.abs(S @ r.x.numpy() - b).max() < 1e-7 * np.abs(b).max()
