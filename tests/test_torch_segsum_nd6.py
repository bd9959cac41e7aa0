"""K1's nd = 6 entry (shells and 611 beams) on the CPU: the plain version
of the element assembly, ``segsum_reference`` through
``bell.assemble_cluster``, against the JAX package's cluster assembly on
the same cluster profile and element matrices, at the element widths
m = 12 (611), 18 (731), 24 (741) and 54 (743); and the port's cluster
profile of a shell plate bit-equal to the JAX package's.  Tolerances:
float32 within 1e-4 x max|JAX| (the bar of tests/test_segsum_pallas.py),
float64 within 1e-12 x max|JAX| (the same sums in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.assembly import bell as jbell
from frontistr_tpu_torch.assembly import bell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import plate_shell

from _torch_shell_decks import beam_line

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def _conns(m):
    if m == 12:
        mesh = beam_line(611, ne=40)
    else:
        mesh = plate_shell({18: 6, 24: 7, 54: 4}[m],
                           etype={18: 731, 24: 741, 54: 743}[m])
    return [mesh.blocks[0].conn], mesh.n_node


@pytest.mark.parametrize("m", [12, 18, 24, 54])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nd6_cluster_assembly_matches_jax(m, dtype):
    conns, n_node = _conns(m)
    nn = conns[0].shape[1]
    assert 6 * nn == m
    jprof = jbell.build_cluster_profile(conns, n_node, 6)
    prof = bell.build_cluster_profile(conns, n_node, 6)
    assert np.array_equal(prof.seg_sorted, jprof.seg_sorted)
    assert np.array_equal(prof.perm, jprof.perm)
    kes = [np.random.default_rng(m).standard_normal(
        (conns[0].shape[0], m, m))]
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    want_b, want_r = jbell._assemble_jit(
        jprof.device(), tuple(jnp.asarray(k, jd) for k in kes), (nn,))
    got_b, got_r = bell.assemble_cluster(
        prof, [torch.as_tensor(k, dtype=dtype) for k in kes], [nn])
    want_r = np.stack([np.asarray(p) for p in want_r])
    assert got_r.shape == want_r.shape and got_r.shape[0] == 36
    scale = np.abs(want_r).max()
    assert np.abs(got_r.numpy() - want_r).max() <= TOL[dtype] * scale
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() \
        <= TOL[dtype] * scale


def test_nd6_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is ``segsum_reference``, bit for bit,
    and it still refuses an nd the kernel has no instance of."""
    conns, n_node = _conns(24)
    prof = bell.build_cluster_profile(conns, n_node, 6)
    plan = prof.plan("cpu")
    ke = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (conns[0].shape[0], 24, 24)))
    got = sm.segsum(plan, [ke], [4], 6)
    assert torch.equal(got, sm.segsum_reference(plan, [ke], [4], 6))
    with pytest.raises(ValueError):
        sm.segsum(plan, [torch.zeros((len(ke), 20, 20),
                                     dtype=ke.dtype)], [4], 5)
