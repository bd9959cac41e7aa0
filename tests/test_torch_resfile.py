"""The port's ``.res`` writer and readers (``io/resfile.py``) against the
JAX package's, on the CPU: ``write_static_result`` of one result (random
values from a numpy seed, with and without REACTION_FORCE, with a
partition's node and element selection) in text and in binary, byte for
byte; ``write_result`` with element components only; the round trip
through ``read_result`` / ``read_result_bin`` / ``read_result_any`` to
the written values (text: to the 17 printed digits, 1e-15 relative;
binary: exactly)."""

import types

import numpy as np
import pytest

from frontistr_tpu.io import resfile as jres
from frontistr_tpu_torch.io import resfile as res


def _result(seed, n_node=23, n_elem=11, reaction=True):
    rng = np.random.default_rng(seed)
    r = types.SimpleNamespace(
        u=rng.standard_normal((n_node, 3)) * 1e-3,
        nodal_strain=rng.standard_normal((n_node, 6)) * 1e-4,
        nodal_stress=rng.standard_normal((n_node, 6)) * 1e2,
        nodal_mises=np.abs(rng.standard_normal(n_node)) * 1e2,
        elem_strain=rng.standard_normal((n_elem, 6)) * 1e-4,
        elem_stress=rng.standard_normal((n_elem, 6)) * 1e2,
        elem_mises=np.abs(rng.standard_normal(n_elem)) * 1e2,
        elem_ids=np.arange(1, n_elem + 1) * 3,
        reaction=rng.standard_normal((n_node, 3)) if reaction else None)
    r.u[0, 0] = 0.0
    r.nodal_stress[1, 2] = -1.0e-300
    mesh = types.SimpleNamespace(node_ids=np.arange(1, n_node + 1) * 2 + 5)
    return mesh, r


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("reaction", [False, True])
@pytest.mark.parametrize("select", [False, True])
def test_write_static_result_bytes_equal_jax(tmp_path, binary, reaction,
                                            select):
    mesh, r = _result(int(binary) + 2 * int(reaction), reaction=reaction)
    kw = {}
    if select:
        rng = np.random.default_rng(9)
        kw = dict(node_sel=rng.random(len(mesh.node_ids)) < 0.5,
                  elem_sel=rng.random(len(r.elem_ids)) < 0.5)
    a, b = tmp_path / "port.res.0.1", tmp_path / "jax.res.0.1"
    res.write_static_result(str(a), mesh, None, r, step=1, binary=binary,
                            **kw)
    jres.write_static_result(str(b), mesh, None, r, step=1, binary=binary,
                             **kw)
    assert _bytes(a) == _bytes(b) and len(_bytes(a)) > 0
    assert res.is_binary_result(str(a)) == binary


@pytest.mark.parametrize("binary", [False, True])
def test_round_trip(tmp_path, binary):
    mesh, r = _result(5)
    p = tmp_path / "r.res.0.1"
    res.write_static_result(str(p), mesh, None, r, binary=binary)
    back = (res.read_result_bin if binary else res.read_result)(str(p))
    assert back["header"] == "*fstrresult"
    assert np.array_equal(back["node_ids"], mesh.node_ids)
    assert np.array_equal(back["elem_ids"], r.elem_ids)
    want_n = [("DISPLACEMENT", r.u), ("REACTION_FORCE", r.reaction),
              ("NodalSTRAIN", r.nodal_strain),
              ("NodalSTRESS", r.nodal_stress),
              ("NodalMISES", r.nodal_mises[:, None])]
    want_e = [("ElementalSTRAIN", r.elem_strain),
              ("ElementalSTRESS", r.elem_stress),
              ("ElementalMISES", r.elem_mises[:, None])]
    for got, want in ((back["node_comps"], want_n),
                      (back["elem_comps"], want_e)):
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            if binary:
                assert np.array_equal(g, w)
            else:
                assert np.abs(g - w).max() <= 1e-15 * np.abs(w).max()
    anyr = res.read_result_any(str(p))
    for (_, g), (_, w) in zip(anyr["node_comps"], back["node_comps"]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("binary", [False, True])
def test_write_result_elements_only_bytes_equal_jax(tmp_path, binary):
    rng = np.random.default_rng(3)
    comps = [("TEMPERATURE", rng.standard_normal((7, 1)))]
    w = res.write_result_bin if binary else res.write_result
    jw = jres.write_result_bin if binary else jres.write_result
    a, b = tmp_path / "a", tmp_path / "b"
    w(str(a), "*fstrresult heat step=3", np.arange(1, 6), np.arange(1, 8),
      [], comps)
    jw(str(b), "*fstrresult heat step=3", np.arange(1, 6), np.arange(1, 8),
       [], comps)
    assert _bytes(a) == _bytes(b)
    back = res.read_result_any(str(a))
    assert back["node_comps"] == [] and back["elem_comps"][0][0] == \
        "TEMPERATURE"
