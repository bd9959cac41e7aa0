"""External coupling endpoint (the REVOCAP coupler surface; host code
copied from ``frontistr_tpu/couple/rcap.py``, only the imports differ).

Redesign of fstr_rcap_io.F90 (fstr_rcap_initialize /
fstr_rcap_get / fstr_rcap_send / fstr_rcap_finalize, lines 8-253) and
the couple load application dynamic_mat_ass_couple.f90: the reference
talks to the REVOCAP coupling server over its rcapf_* API; here the
rendezvous is a shared DIRECTORY of atomically-written npz files, which
works across containers/languages and needs no daemon:

    <dir>/<role>.init.npz           handshake: interface node ids+coords
    <dir>/<role>.<step>.npz         per-step fields (trac / disp+velo+acc)

Writes are tmp+os.replace (atomic on POSIX); reads poll with a timeout.
Protocol role names follow the reference's solid/fluid pairing; any peer
that writes the same file layout can couple (a Python fluid solver, a
mock, another fistr-tpu instance).

Enable by setting FRONTISTR_TPU_COUPLE_DIR on a deck that carries
!COUPLE — the analysis drivers then fetch interface traction before each
step and publish displacement/velocity/acceleration after it
(fstr_rcap_get / fstr_rcap_send call sites in fstr_solve_NonLinear and
fstr_dynamic_nlimplicit).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np


def _atomic_savez(path: str, **arrays):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _poll_load(path: str, timeout: float, interval: float = 0.02):
    t0 = time.monotonic()
    while True:
        if os.path.exists(path):
            try:
                with np.load(path, allow_pickle=False) as z:
                    return {k: z[k] for k in z.files}
            except Exception:
                pass             # torn read can't happen (atomic), but
                #                  a slow NFS rename might: retry
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"coupling peer file not found: {path}")
        time.sleep(interval)


class FileCoupler:
    """One endpoint of a two-code staggered coupling.

    role/peer: file name prefixes ("solid" and "fluid" by default,
    matching rcapf_init_solid_solver's pairing)."""

    def __init__(self, workdir: str, role: str = "solid",
                 peer: str = "fluid", timeout: float = 120.0):
        self.dir = workdir
        self.role = role
        self.peer = peer
        self.timeout = timeout

    # ---- handshake (fstr_rcap_initialize: matching node ids) ----
    def publish_interface(self, node_ids: np.ndarray,
                          coords: np.ndarray):
        _atomic_savez(os.path.join(self.dir, f"{self.role}.init.npz"),
                      node_ids=np.asarray(node_ids, np.int64),
                      coords=np.asarray(coords, float))

    def peer_interface(self) -> Dict[str, np.ndarray]:
        return _poll_load(os.path.join(self.dir,
                                       f"{self.peer}.init.npz"),
                          self.timeout)

    # ---- per-step exchange ----
    def send(self, step: int, **fields):
        """Publish this side's step fields (fstr_rcap_send: disp, and
        velo/acc for couple types 4-6)."""
        _atomic_savez(os.path.join(self.dir,
                                   f"{self.role}.{step:06d}.npz"),
                      **{k: np.asarray(v) for k, v in fields.items()})

    def get(self, step: int) -> Dict[str, np.ndarray]:
        """Fetch the peer's step fields (fstr_rcap_get: trac)."""
        return _poll_load(os.path.join(self.dir,
                                       f"{self.peer}.{step:06d}.npz"),
                          self.timeout)


def couple_surface_nodes(mesh, couple_card) -> np.ndarray:
    """Union of node indices on the !COUPLE surface groups."""
    from frontistr_tpu_torch.assembly.loads import FACE_TABLES
    eid2loc = mesh.elem_id_to_block()
    nodes = set()
    for row in couple_card.data:
        sg = mesh.surf_groups.get(row[0])
        if sg is None:
            continue
        for eid, fno in sg:
            bi, k = eid2loc[int(eid)]
            blk = mesh.blocks[bi]
            ftab = FACE_TABLES.get(blk.etype)
            if ftab is None:
                continue
            _, lnodes = ftab[int(fno) - 1]
            nodes.update(int(v) for v in blk.conn[k][np.asarray(lnodes)])
    return np.asarray(sorted(nodes), np.int64)


def couple_traction_force(model, mesh, couple_card,
                          trac: Dict[int, np.ndarray]) -> np.ndarray:
    """Traction on coupled nodes -> consistent nodal force vector
    (dynamic_mat_ass_couple.f90: per face, average the nodal tractions,
    multiply by the face area, distribute equally over the face nodes).

    trac maps node index -> (3,) traction vector (from the peer)."""
    from frontistr_tpu_torch.assembly.loads import FACE_TABLES
    ndof = model.ndof
    f = np.zeros(model.n_node * ndof)
    eid2loc = mesh.elem_id_to_block()
    for row in couple_card.data:
        sg = mesh.surf_groups.get(row[0])
        if sg is None:
            continue
        for eid, fno in sg:
            bi, k = eid2loc[int(eid)]
            blk = mesh.blocks[bi]
            ftab = FACE_TABLES.get(blk.etype)
            if ftab is None:
                continue
            _, lnodes = ftab[int(fno) - 1]
            nodes = blk.conn[k][np.asarray(lnodes)]
            pts = [trac.get(int(nn)) for nn in nodes]
            pts = [p for p in pts if p is not None]
            if not pts:
                continue
            p = np.mean(np.stack(pts), axis=0)        # (3,)
            X = mesh.coords[nodes][:, :3]
            area = _poly_area(X)
            v = p * area / len(nodes)
            for nn in nodes:
                f[nn * ndof:nn * ndof + 3] += v
    return f


def _poly_area(X: np.ndarray) -> float:
    """Area of a planar-ish face polygon (tri / quad corner fan)."""
    if len(X) < 3:
        return 0.0
    a = 0.0
    for i in range(1, len(X) - 1):
        a += 0.5 * np.linalg.norm(np.cross(X[i] - X[0], X[i + 1] - X[0]))
    return float(a)


class CoupleDriver:
    """Driver-facing adapter: owns the endpoint, the !COUPLE card, and
    the interface node set; the analysis loop only calls
    traction_force(step) before the solve and publish_state(step, ...)
    after it (the fstr_rcap_get / fstr_rcap_send call sites)."""

    def __init__(self, model, mesh, couple_card, endpoint: FileCoupler):
        self.model = model
        self.mesh = mesh
        self.card = couple_card
        self.ep = endpoint
        self.nodes = couple_surface_nodes(mesh, couple_card)
        gids = np.asarray(mesh.node_ids)[self.nodes]
        self.gids = gids
        endpoint.publish_interface(gids, mesh.coords[self.nodes][:, :3])

    def traction_force(self, step: int) -> np.ndarray:
        fields = self.ep.get(step)
        ids = np.asarray(fields.get("node_ids", self.gids), np.int64)
        tr = np.asarray(fields["trac"], float).reshape(len(ids), -1)
        trac = {}
        for gid, t in zip(ids, tr):
            k = self.mesh.id2idx.get(int(gid))
            if k is not None:
                trac[int(k)] = t[:3]
        return couple_traction_force(self.model, self.mesh, self.card,
                                     trac)

    def publish_state(self, step: int, u, vel=None, acc=None):
        nd = self.model.ndof
        sel = self.nodes
        out = dict(node_ids=self.gids,
                   disp=np.asarray(u).reshape(-1, nd)[sel][:, :3])
        if vel is not None:
            out["velo"] = np.asarray(vel).reshape(-1, nd)[sel][:, :3]
        if acc is not None:
            out["acc"] = np.asarray(acc).reshape(-1, nd)[sel][:, :3]
        self.ep.send(step, **out)


def driver_from_env(model, mesh, cfg) -> Optional["CoupleDriver"]:
    """Build a CoupleDriver when the deck has !COUPLE and
    FRONTISTR_TPU_COUPLE_DIR names the rendezvous directory (absent env
    -> None: the in-process StaggeredCoupling and plain runs are
    unaffected)."""
    card = getattr(cfg, "couple", None)
    d = os.environ.get("FRONTISTR_TPU_COUPLE_DIR", "")
    if card is None or not d:
        return None
    role = os.environ.get("FRONTISTR_TPU_COUPLE_ROLE", "solid")
    peer = os.environ.get("FRONTISTR_TPU_COUPLE_PEER", "fluid")
    to = float(os.environ.get("FRONTISTR_TPU_COUPLE_TIMEOUT", "120"))
    ep = FileCoupler(d, role=role, peer=peer, timeout=to)
    return CoupleDriver(model, mesh, card, ep)
