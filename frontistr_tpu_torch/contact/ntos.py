"""Node-to-surface contact: pairs, search, penalty blocks and the
augmented-Lagrange update (``ContactPair``, ``ContactManager`` and
``_project`` copied from ``frontistr_tpu/contact/ntos.py``; reference
fistr1/src/lib/contact/contact_lib.f90 project_Point2Element,
fstr_contact_def.F90 scan/track, fstr_Newton_contactALag of
fstr_solve_NonLinear.f90:173-330).

Host numpy, as in the JAX package:

- ``search``: every slave's nearest master-face candidates by face
  centroid, a Newton projection onto each, the gap along the outward
  face normal (gap < 0 is penetration) and the relative displacement
  at the contact point;
- ``device_blocks``: the AL tangent kn g g^T and the force
  p = max(0, lambda - kn gap) on the (slave + face nodes) dofs, with
  the Coulomb return map (stick / slip, a nonsymmetric slip tangent);
- ``augment``: lambda <- p after a converged pass.

One slot per slave node, faces padded to four corner nodes, so the
shapes stay fixed as faces change.  Two changes from the JAX package,
neither of which changes a bit of the result: the search ranks
candidates a block of slave rows at a time (``SEARCH_BYTES``) instead of
forming the whole slave x face distance matrix at once, and the quad4
projection runs for every slave at once (``_project_quad4``) instead of
one slave at a time.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from frontistr_tpu_torch.assembly.loads import FACE_TABLES

# the most bytes of one block of the candidate search's distances
SEARCH_BYTES = 64 * 2 ** 20


@dataclasses.dataclass
class ContactPair:
    slave_nodes: np.ndarray          # (Ns,) node idx
    faces: np.ndarray                # (F, max_fn) node idx (-1 pad)
    face_nn: np.ndarray              # (F,) actual node count
    face_sign: np.ndarray = None     # (F,) +-1: raw normal -> outward
    mu: float = 0.0                  # fcoeff (!CONTACT data row col 2)
    kt: float = 1.0e6                # tPenalty (col 3; default 1e6,
    #                                  fstr_ctrl_common.f90:515)


class ContactManager:
    MAX_FN = 4                       # quad4/tri3 master faces

    def __init__(self, mesh, model, cfg):
        self.model = model
        self.pairs: List[ContactPair] = []
        eid2loc = mesh.elem_id_to_block()
        cpar = {}
        for c in cfg.contacts:
            if not c.data:
                continue
            row = c.data[0]
            cpar[row[0]] = (float(row[1]) if len(row) > 1 else 0.0,
                            float(row[2]) if len(row) > 2 else 1.0e6)
        for cp in mesh.contact_pairs:
            slave = mesh.node_groups.get(cp.slave)
            sg = mesh.surf_groups.get(cp.master)
            if slave is None or sg is None:
                continue
            faces, fnn, fsign = [], [], []
            for eid, fno in sg:
                bi, row = eid2loc[int(eid)]
                blk = mesh.blocks[bi]
                ftab = FACE_TABLES.get(blk.etype)
                if ftab is None:
                    continue
                _, lnodes = ftab[int(fno) - 1]
                nodes = blk.conn[row][np.asarray(lnodes)]
                corners = nodes[:self.MAX_FN]   # corner nodes only
                pad = np.full(self.MAX_FN, -1, np.int64)
                pad[:len(corners)] = corners
                faces.append(pad)
                fnn.append(len(corners))
                # orient the raw face normal outward from the parent
                # element (surface groups carry arbitrary winding)
                X = mesh.coords[:, :model.dim][corners]
                ec = mesh.coords[:, :model.dim][blk.conn[row]].mean(0)
                fc0 = X.mean(0)
                if model.dim == 3:
                    if len(corners) >= 3:
                        nr = np.cross(X[1] - X[0], X[2] - X[0])
                    else:
                        nr = np.zeros(3)
                else:
                    t = X[1] - X[0]
                    nr = np.array([-t[1], t[0]])
                sgn = 1.0 if (fc0 - ec) @ nr >= 0 else -1.0
                fsign.append(sgn)
            if faces:
                mu, kt = cpar.get(cp.name, (0.0, 1.0e6))
                self.pairs.append(ContactPair(
                    np.asarray(slave, np.int64), np.stack(faces),
                    np.asarray(fnn), np.asarray(fsign), mu=mu, kt=kt))
        # penalty: scaled from material stiffness (fstr: mu = cdotp *
        # max K diag with cdotp default 1e3, fstr_contact.f90:19,46;
        # here the scale base is E, factor 100 ~ 1e-3 rel. penetration).
        # '!CONTACT, NPENALTY=x' overrides the scale factor (the
        # reference's cdotp override, fstr_setup.f90:429).
        e_avg = max(float(np.mean([b.material.youngs
                                   for b in model.blocks])), 1.0)
        npen = 0.0
        self.ntol = 0.0          # penetration convergence (cgn override)
        self.ttol = 0.0          # tangent-slip convergence (cgt override)
        for c in cfg.contacts:
            npen = max(npen, c.fparam("NPENALTY", 0.0))
            self.ntol = max(self.ntol, c.fparam("NTOL", 0.0))
            self.ttol = max(self.ttol, c.fparam("TTOL", 0.0))
        self.kn = (npen if npen > 0 else 100.0) * e_avg
        ns_tot = sum(len(p.slave_nodes) for p in self.pairs)
        self.lam = np.zeros(ns_tot)
        # friction state: tangential AL multiplier + reference relative
        # position at the last augment (slip increment origin)
        self.mu = np.concatenate(
            [np.full(len(p.slave_nodes), p.mu) for p in self.pairs]) \
            if self.pairs else np.zeros(0)
        self.kt = np.concatenate(
            [np.full(len(p.slave_nodes), p.kt) for p in self.pairs]) \
            if self.pairs else np.zeros(0)
        self.lam_t = np.zeros((ns_tot, model.dim))
        self.rel_prev = None                  # set at first search
        self.active = ns_tot > 0
        # algorithm (!CONTACT_ALGO TYPE=SLAGRANGE|ALAGRANGE,
        # fstr_ctrl_get_CONTACTALGO): exact elimination vs AL penalty
        self.algo = (getattr(cfg, "contact_algo", "SLAGRANGE")
                     or "SLAGRANGE").upper()
        self.all_slaves = np.concatenate(
            [p.slave_nodes for p in self.pairs]) if self.pairs \
            else np.zeros(0, np.int64)
        self.slag_released = np.zeros(ns_tot, bool)

    @property
    def has_friction(self) -> bool:
        """True when any pair carries a Coulomb coefficient — the slip
        tangent is then nonsymmetric and the solve needs BiCGSTAB."""
        return bool(self.mu.size) and bool((self.mu > 0).any())

    # ------------------------------------------------------------------
    def search(self, coords_def: np.ndarray):
        """Project every slave onto its nearest master face.

        Returns dict with per-slot arrays: conn (Ns, 1+MAX_FN), gap (Ns,),
        normal (Ns, dim), shape (Ns, MAX_FN), touching (Ns,) bool.
        """
        model = self.model
        dim = model.dim
        coords0 = model.coords[:, :dim]
        out_conn, out_gap, out_nrm, out_shp, out_on = [], [], [], [], []
        out_rel = []
        for p in self.pairs:
            xs = coords_def[p.slave_nodes]                    # (Ns, dim)
            # face centroids for candidate search
            fc = np.zeros((len(p.faces), dim))
            for k in range(self.MAX_FN):
                sel = p.faces[:, k] >= 0
                fc[sel] += coords_def[p.faces[sel, k]]
            fc /= p.face_nn[:, None]
            # try a few nearest candidates, keep the best projection
            ncand = min(4, len(p.faces))
            cand = _nearest(xs, fc, ncand)
            best = None
            for ci in range(ncand):
                fi = cand[:, ci]
                gap, nrm, shp, inside = _project(
                    xs, p.faces[fi], p.face_nn[fi], coords_def, dim)
                score = np.where(inside, np.abs(gap), np.inf)
                if best is None:
                    best = [fi, gap, nrm, shp, score]
                else:
                    better = score < best[4]
                    best[0] = np.where(better, fi, best[0])
                    best[1] = np.where(better, gap, best[1])
                    best[2] = np.where(better[:, None], nrm, best[2])
                    best[3] = np.where(better[:, None], shp, best[3])
                    best[4] = np.minimum(score, best[4])
            fi, gap, nrm, shp, score = best
            sgn = p.face_sign[fi]
            gap = gap * sgn
            nrm = nrm * sgn[:, None]
            touching = np.isfinite(score)
            conn = np.concatenate([p.slave_nodes[:, None],
                                   p.faces[fi]], axis=1)
            conn = np.where(conn < 0, conn[:, :1] * 0, conn)  # pad -> node 0
            out_conn.append(conn)
            out_gap.append(gap)
            out_nrm.append(nrm)
            out_shp.append(shp)
            out_on.append(touching)
            # relative displacement at the contact point (slip origin):
            # u_slave - sum_k shp_k u_master_k
            disp = coords_def - coords0
            us = disp[p.slave_nodes]
            um = np.zeros_like(us)
            fconn = p.faces[fi]
            for k in range(self.MAX_FN):
                sel = fconn[:, k] >= 0
                um[sel] += shp[sel, k:k + 1] * disp[fconn[sel, k]]
            out_rel.append(us - um)
        gap = np.concatenate(out_gap)
        nrm = np.concatenate(out_nrm)
        rel = np.concatenate(out_rel)
        if self.rel_prev is None:
            self.rel_prev = rel.copy()
        return dict(conn=np.concatenate(out_conn), gap=gap, normal=nrm,
                    shape=np.concatenate(out_shp),
                    touching=np.concatenate(out_on), rel=rel)

    def device_blocks(self, proj):
        """(cdofs (Ns, m), cke (Ns, m, m), cqf (Ns, m)) with fixed shapes."""
        model = self.model
        ndof = model.ndof
        conn = proj["conn"]
        Ns, width = conn.shape
        m = width * ndof
        gvec = np.zeros((Ns, m))
        nrm = proj["normal"]
        shp = proj["shape"]
        gvec[:, :ndof] = nrm
        for k in range(self.MAX_FN):
            gvec[:, (1 + k) * ndof:(2 + k) * ndof] = \
                -shp[:, k:k + 1] * nrm
        # contact pressure p = max(0, lam - kn*gap); active where p>0
        pr = self.lam - self.kn * proj["gap"]
        act = (pr > 0) & proj["touching"]
        pr = np.where(act, pr, 0.0)
        # tangent active set additionally includes exactly-touching
        # slots (gap <= 0, p = 0): at first contact with lam = 0 the
        # force-active set is empty and the tangent would be singular —
        # a direct factorization blows up where CG iterated through it
        # (fstr_scan_contact_state activates by geometry for the same
        # reason); the residual force stays max(0, p) so the converged
        # answer is unchanged
        act_k = act | (proj["touching"] & (proj["gap"] <= 0.0))
        ke = self.kn * gvec[:, :, None] * gvec[:, None, :] * \
            act_k[:, None, None]
        qf = -pr[:, None] * gvec            # internal force (resists)

        # ---- Coulomb friction (AL tangential multiplier + return map,
        # contact_lib.f90:92-160 fric_state stick/slip arms) ----
        has_fric = self.mu.size and (self.mu > 0).any()
        if has_fric:
            dim = self.model.dim
            W = np.zeros((Ns, m, dim))      # rel-disp extractor W^T u
            for d in range(dim):
                W[:, d, d] = 1.0
            for k in range(self.MAX_FN):
                for d in range(dim):
                    W[:, (1 + k) * ndof + d, d] = -shp[:, k]
            slip = proj["rel"] - self.rel_prev
            slip_t = slip - (slip * nrm).sum(1, keepdims=True) * nrm
            t_tr = self.lam_t + self.kt[:, None] * slip_t
            t_tr = t_tr - (t_tr * nrm).sum(1, keepdims=True) * nrm
            ttn = np.linalg.norm(t_tr, axis=1)
            cap = self.mu * pr
            slipping = ttn > cap + 1e-300
            scale = np.where(slipping,
                             cap / np.maximum(ttn, 1e-300), 1.0)
            fr_act = act & (self.mu > 0)
            t_f = t_tr * (scale * fr_act)[:, None]
            self._t_trial = t_f             # consumed by augment()
            # Q += W t_f (slave +t_f, master -shp t_f): friction resists
            # the relative slip of the slave over the master face
            qf = qf + np.einsum("smd,sd->sm", W, t_f)
            # consistent tangent (contact_lib.f90:92-160):
            #   stick: kt W (I - n n^T) W^T
            #   slip:  (cap/|t|) kt W (P - s s^T) W^T - mu kn (W s)(W n)^T
            # the slip arm is nonsymmetric (Coulomb is nonassociative);
            # the contact solve switches to BiCGSTAB when friction is on
            P = np.eye(dim)[None] - nrm[:, :, None] * nrm[:, None, :]
            s_dir = t_tr / np.maximum(ttn, 1e-300)[:, None]
            Pmod = np.where(slipping[:, None, None],
                            P - s_dir[:, :, None] * s_dir[:, None, :],
                            P)
            kt_eff = self.kt * scale * fr_act
            ke = ke + kt_eff[:, None, None] * \
                np.einsum("smd,sde,sne->smn", W, Pmod, W)
            Ws = np.einsum("smd,sd->sm", W, s_dir)
            coup = (self.mu * self.kn) * (slipping & fr_act)
            ke = ke - coup[:, None, None] * \
                Ws[:, :, None] * gvec[:, None, :]
        else:
            self._t_trial = np.zeros_like(self.lam_t)
        dofs = (conn[:, :, None] * ndof +
                np.arange(ndof)[None, None, :]).reshape(Ns, m)
        return dofs.astype(np.int32), ke, qf, act, pr

    def augment(self, proj):
        """lambda <- p after a converged substep (AL outer update);
        tangential multiplier <- capped trial traction, slip origin
        re-anchored at the converged relative position.

        Slots whose gap is clearly open are FREED (lam=0) rather than
        Uzawa-downdated: on separation (bounce-off in dynamics) the
        stale multiplier otherwise keeps applying pressure across an
        open gap — a ghost force that injects energy (the reference
        frees tension-detected nodes in fstr_contact's active-set
        scan).  Near-contact slots (|gap| ~ pen tol) keep the gradual
        pr = lam - kn*gap downdate."""
        char = float(np.abs(self.model.coords).max()) or 1.0
        pr = self.lam - self.kn * proj["gap"]
        act = (pr > 0) & proj["touching"] & \
            (proj["gap"] <= 1e-4 * char)
        self.lam = np.where(act, pr, 0.0)
        if self.mu.size:
            self.lam_t = np.where(act[:, None],
                                  getattr(self, "_t_trial", self.lam_t),
                                  0.0)
            self.rel_prev = proj["rel"].copy()


def _nearest(xs, fc, ncand):
    """(Ns, ncand) indices of the face centroids ``fc`` nearest each
    point of ``xs``, by squared distance, in ``np.argsort``'s order; a
    block of rows at a time."""
    rows = max(1, SEARCH_BYTES // max(1, fc.size * 8))
    out = np.empty((len(xs), ncand), np.int64)
    for r0 in range(0, len(xs), rows):
        d2 = ((xs[r0:r0 + rows, None, :] - fc[None, :, :]) ** 2).sum(-1)
        out[r0:r0 + rows] = np.argsort(d2, axis=1)[:, :ncand]
    return out


def _project(xs, faces, fnn, coords, dim):
    """Project points onto faces (tri3 barycentric / quad4 2-step Newton).

    Returns (gap, normal (unit), shape (MAX_FN,), inside).  The quad4
    faces of a 3-D pair go through ``_project_quad4`` all at once; the
    rest one point at a time, as in the JAX package."""
    Ns = len(xs)
    MAX_FN = faces.shape[1]
    gap = np.zeros(Ns)
    nrm = np.zeros((Ns, dim))
    shp = np.zeros((Ns, MAX_FN))
    inside = np.zeros(Ns, bool)
    tol = 1e-6
    quad = np.zeros(Ns, bool) if dim == 2 else (np.asarray(fnn) == 4)
    if quad.any():
        q = np.flatnonzero(quad)
        gap[q], nrm[q], shp[q, :4], inside[q] = _project_quad4(
            xs[q], coords[faces[q, :4]])
    for i in np.flatnonzero(~quad):
        nn = int(fnn[i])
        nodes = faces[i, :nn]
        X = coords[nodes]                               # (nn, dim)
        x = xs[i]
        if dim == 2:
            # edge (2-node) "face"
            t = X[1] - X[0]
            L2 = (t * t).sum()
            xi = ((x - X[0]) @ t) / max(L2, 1e-300)
            # EdgeNormal convention (element.f90): outward for the
            # reference's face orderings; gap > 0 = separation
            n2 = np.array([-t[1], t[0]])
            n2 /= max(np.linalg.norm(n2), 1e-300)
            g = (x - (X[0] + xi * t)) @ n2
            gap[i] = g
            nrm[i] = n2
            shp[i, 0], shp[i, 1] = 1 - xi, xi
            inside[i] = -tol <= xi <= 1 + tol
            continue
        if nn == 3:
            v1, v2 = X[1] - X[0], X[2] - X[0]
            n3 = np.cross(v1, v2)
            a = np.linalg.norm(n3)
            if a < 1e-300:
                continue
            n3 /= a
            g = (x - X[0]) @ n3
            xp = x - g * n3
            A = np.stack([v1, v2], axis=1)
            sol, *_ = np.linalg.lstsq(A, xp - X[0], rcond=None)
            l1, l2 = sol
            shp[i, 0], shp[i, 1], shp[i, 2] = 1 - l1 - l2, l1, l2
            inside[i] = (-tol <= l1) and (-tol <= l2) and \
                (l1 + l2 <= 1 + tol)
            gap[i] = (x - X[0]) @ n3
            nrm[i] = n3
    return gap, nrm, shp, inside


def _quad_shape(xi):
    """The bilinear quad's shape values (S, 4) and their derivatives
    (S, 4, 2) at the points ``xi`` (S, 2)."""
    a, b = xi[:, 0], xi[:, 1]
    Nq = 0.25 * np.stack([(1 - a) * (1 - b), (1 + a) * (1 - b),
                          (1 + a) * (1 + b), (1 - a) * (1 + b)], axis=1)
    dN = 0.25 * np.stack(
        [np.stack([-(1 - b), -(1 - a)], axis=1),
         np.stack([(1 - b), -(1 + a)], axis=1),
         np.stack([(1 + b), (1 + a)], axis=1),
         np.stack([-(1 + b), (1 - a)], axis=1)], axis=1)
    return Nq, dN


def _vm(v, X):
    """Row by row v[s] @ X[s], (S, 4) x (S, 4, 3) -> (S, 3), through
    ``np.matmul``'s stacked loop: the vector-matrix routine a single
    ``v[s] @ X[s]`` calls, on operands of the same strides, so each row
    is the single product bit for bit."""
    return np.matmul(v[:, None, :], X)[:, 0]


def _dot(a, b):
    """Row by row a[s] @ b[s] of (S, 3) rows, the single ``@``'s dot."""
    return np.matmul(a[:, None, :], b[:, :, None])[:, 0, 0]


def _project_quad4(xs, X):
    """The quad4 arm of ``_project`` for every point at once: xs (S, 3),
    X (S, 4, 3) the faces' corners.  The JAX package's per-point Newton
    on (xi, eta), up to 20 steps, a point frozen once its step is below
    1e-12 or its 2 x 2 system is singular; each product is the one the
    per-point loop makes, so the results are bit for bit its own."""
    S = len(xs)
    xi = np.zeros((S, 2))
    ok = np.zeros(S, bool)
    live = np.arange(S)
    for _ in range(20):
        if not live.size:
            break
        Xl, xl = X[live], xs[live]
        Nq, dN = _quad_shape(xi[live])
        g1 = _vm(dN[:, :, 0], Xl)
        g2 = _vm(dN[:, :, 1], Xl)
        r = xl - _vm(Nq, Xl)
        Jm = np.empty((len(live), 2, 2))
        Jm[:, 0, 0], Jm[:, 0, 1] = _dot(g1, g1), _dot(g1, g2)
        Jm[:, 1, 0], Jm[:, 1, 1] = _dot(g2, g1), _dot(g2, g2)
        rhs = np.stack([_dot(r, g1), _dot(r, g2)], axis=1)
        solved = np.ones(len(live), bool)
        try:
            dxi = np.linalg.solve(Jm, rhs[:, :, None])[:, :, 0]
        except np.linalg.LinAlgError:
            dxi = np.zeros_like(rhs)
            for j in range(len(live)):
                try:
                    dxi[j] = np.linalg.solve(Jm[j], rhs[j])
                except np.linalg.LinAlgError:
                    solved[j] = False
        stepped = live[solved]
        xi[stepped] = xi[stepped] + dxi[solved]
        done = solved & (np.abs(dxi).max(axis=1) < 1e-12)
        ok[live[done]] = True
        live = live[solved & ~done]
    Nq, dN = _quad_shape(xi)
    g1 = _vm(dN[:, :, 0], X)
    g2 = _vm(dN[:, :, 1], X)
    n3 = np.cross(g1, g2)
    a = np.sqrt(_dot(n3, n3))
    good = a >= 1e-300
    n3 = np.where(good[:, None], n3 / np.where(good, a, 1.0)[:, None], 0.0)
    g = np.where(good, _dot(xs - _vm(Nq, X), n3), 0.0)
    shp = np.where(good[:, None], Nq, 0.0)
    inside = good & ok & (np.abs(xi) <= 1 + 1e-3).all(axis=1)
    return g, n3, shp, inside
