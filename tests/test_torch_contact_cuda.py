"""K1's planes entry at a contact plan on the card: the SLAGRANGE
reduction T^T and the penalty arm's block sum of the punch boxes
(``meshgen.contact_pair``) go through ``IndexAdd``, whose plan sums each
target in a fixed order.  Held against the plain version (``index_add_``
in slot order) on the same inputs, bit-equal on relaunch, and the
reduction on the card against the CPU's.  The file imports nothing of
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_contact_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerance: float64 within 1e-12 x
max|plain| (the same sums in another order).
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.contact.ntos import ContactManager
from frontistr_tpu_torch.contact.slag import ContactEliminator
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import contact_pair

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n BOT, 3, 3, 0.0\n"
       "!CONTACT_ALGO, TYPE=SLAGRANGE\n!CONTACT\n CP1, 0.0\n"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K1 kernel has no CPU mode)")
    return torch.device("cuda")


def _punch(tmp_path, n=12):
    m = n * 70 // 72
    mesh = contact_pair((n, n, n // 2), (m, m, m // 2), (1.0, 1.0, 0.5),
                        (0.9, 0.9, 0.45))
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    model = build_struct_model(mesh, read_cnt(str(p)), device="cpu")
    cm = ContactManager(mesh, model, model.cfg)
    disp = np.random.default_rng(0).uniform(-1e-4, 1e-4, model.coords.shape)
    proj = cm.search(model.coords + disp)
    return model, cm, proj


@pytest.mark.cuda
def test_planes_at_contact_plan(tmp_path, cuda_device):
    """The planes entry at the SLAGRANGE slots' plan (every slot's
    masters with a nonzero coefficient) and at the penalty blocks' plan
    (every slot's dofs with a nonzero row): against its plain version,
    and bit-equal on relaunch."""
    model, cm, proj = _punch(tmp_path)
    elim = ContactEliminator(model.n_dof_total, model.ndof, cuda_device)
    cn = elim.build(proj, cm.all_slaves, proj["touching"])
    cdofs, cke, cqf = cm.device_blocks(proj)[:3]
    keep = (cke != 0.0).any(axis=2) | (cqf != 0.0)
    rng = np.random.default_rng(1)
    for add in (cn.add, sm.IndexAdd.build(cdofs, cuda_device, keep=keep)):
        R = add.plan.perm.numel()
        vals = torch.as_tensor(rng.standard_normal((1, R)),
                               device=cuda_device)
        sm.segsum_planes.launches = 0
        got = sm.segsum_planes(vals, add.plan)
        again = sm.segsum_planes(vals, add.plan)
        assert sm.segsum_planes.launches == 2
        want = sm.segsum_planes_reference(vals, add.plan)
        assert torch.equal(got, again)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.cuda
def test_reduction_repeats_and_matches_cpu(tmp_path, cuda_device):
    """T^T of the eliminator on the card twice (bit-equal) and against
    the CPU's."""
    model, cm, proj = _punch(tmp_path)
    n, nd = model.n_dof_total, model.ndof
    y = np.random.default_rng(2).standard_normal(n)
    out = {}
    for dev in ("cpu", cuda_device):
        elim = ContactEliminator(n, nd, dev)
        cn = elim.build(proj, cm.all_slaves, proj["touching"])
        yt = torch.as_tensor(y, device=dev)
        out[str(dev)] = (elim.Tt(cn, yt), elim.Tt(cn, yt))
    a, b = out[str(cuda_device)]
    assert torch.equal(a, b)
    want = out["cpu"][0]
    assert (a.cpu() - want).abs().max() <= 1e-12 * want.abs().max()
