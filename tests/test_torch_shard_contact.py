"""Sharded contact (the contact arms over ``shard.RowFEOperator``: each
rank's element rows, all-gathered; the contact tables and the Krylov
vectors whole on every rank) on 2 and 3 ranks on the CPU (gloo) against
the JAX package's single-device run, the counterparts of
``tests/test_contact_mpc.py``'s ``test_sharded_contact_al_mpc_matches``,
``test_sharded_contact_slag_matches`` and
``test_sharded_dynamic_contact_slag_matches``: displacements within
1e-8 of the JAX package's, the Newton iterations equal and the CG
counts within 2 of the port's single-device run."""

import numpy as np
import pytest

from _torch_contact_decks import dyn_cnt, pair_mesh, static_cnt, tie
from _torch_contact_decks import write_deck
from _torch_shard_tasks import pools, references, rel, run

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64"}


@pytest.fixture(scope="module")
def ranks():
    with pools(2, 3) as ps:
        yield ps


def _check(got, jo, one, key="static"):
    for g in got[1:]:
        np.testing.assert_array_equal(g["u"], got[0]["u"])
    want = np.asarray(jo[key].u).reshape(-1)
    assert np.abs(want).max() > 1e-6
    assert rel(got[0]["u"], want) <= 1e-8
    cg, cg1 = (np.ravel(np.asarray(g.get("cg", []), dtype=object).tolist())
               for g in (got[0], one))
    assert len(cg) == len(cg1)
    assert all(abs(int(a) - int(b)) <= 2 for a, b in zip(cg, cg1))


@pytest.mark.parametrize("algo,n,mpc", [("SLAGRANGE", 2, False),
                                        ("SLAGRANGE", 3, True),
                                        ("ALAGRANGE", 2, True)])
def test_sharded_contact_matches(ranks, tmp_path, algo, n, mpc):
    """Static contact of two blocks (SLAGRANGE elimination, the
    augmented-Lagrange penalty arm), with and without a redundant
    !EQUATION tie away from the surfaces."""
    mesh = pair_mesh("block2")
    if mpc:
        tie(mesh)
    wd = write_deck(tmp_path / "wd", mesh, static_cnt(algo), seed=3)
    jo, one = references(f"{algo}{mpc}", wd, ENV)
    got = ranks[n].run(run, wd, ENV)
    _check(got, jo, one)
    assert got[0]["iters"] == one["iters"]


def test_sharded_dynamic_contact_matches(ranks, tmp_path):
    """Newmark with SLAGRANGE contact on 2 ranks: the elimination on the
    effective matrix c1 K + c2 M of the ranks' element rows."""
    wd = write_deck(tmp_path / "wd", pair_mesh("block2"),
                    dyn_cnt(3, 0.01, algo="SLAGRANGE"), seed=3)
    jo, one = references("dynamic", wd, ENV)
    got = ranks[2].run(run, wd, ENV)
    _check(got, jo, one, "dynamic")
    assert got[0]["newton"] == one["newton"]
