"""The explicit dynamics step at the explicit cell's shapes, part by part.

    python -m frontistr_tpu_torch.microbench.dynamic_step [--n 69] [--reps 20]

Builds the explicit cell's model (``box_tet4(n, n, n)``, node numbers
shuffled with seed 3 and reordered as ``run.run_directory`` does; 1,971,054
tets at n=69) on the card with its lumped mass, sets a random displacement
and increment, and times with CUDA events (mean of ``reps`` calls after
2) what ``analysis/dynamic._run_explicit`` does in a step:

- ``step_ms``: the whole step (load, central-difference update, element
  update, commit);
- ``element_values_ms``: the element gathers of u and of the increment;
- ``update_ms``: ``BlockPrograms.update`` (strain, stress, internal
  force) on gathered values;
- ``gather_sum_ms``: the incidence gather-sum of the element forces;
- ``kernels``: the device ms per call of each CUDA kernel the element
  gathers and update launch (``torch.profiler``), largest first, and
  ``kernel_launches`` per call;
- ``bound_ms``: the least bytes a step moves (the element gathers of u
  and the increment, the element coordinates, the element forces
  written and read back, Q) over 3.35 TB/s.

It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.analysis import dynamic as dyn
from frontistr_tpu_torch.analysis.nonlinear import (BlockPrograms,
                                                    _commit_state,
                                                    _element_values,
                                                    init_block_state)
from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.microbench.segsum import cuda_ms

HBM_BYTES_S = 3.35e12
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 11, 1\n"
       " 0.0, 1.0e-9, 1, 1.0e-9\n 0.5, 0.25\n 1, 1, 0.0, 0.0\n 10\n"
       "!BOUNDARY\n X0, 1, 3, 0.0\n!CLOAD\n X1, 3, -1.0\n"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!DENSITY\n 7.85e-9\n"
       "!END\n")


def kernel_times(fn, reps: int):
    """Device ms per call of each CUDA kernel ``fn`` launches
    (``torch.profiler``, ``reps`` calls after one; kernels of one name
    summed), largest first, and the kernel launches per call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            got[e.key[:100]] = got.get(e.key[:100], 0.0) + \
                e.self_device_time_total / 1e3 / reps
            launches += e.count
    return dict(sorted(got.items(), key=lambda kv: -kv[1])), \
        launches / reps


def model_for(n: int, dev):
    mesh = box_tet4(n, n, n)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    mesh = ordering.maybe_reorder(ordering.permute_mesh(mesh, order),
                                  verbose=False)
    path = os.path.join("build", "microbench", "dynamic_step.cnt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(CNT)
    return build_struct_model(mesh, read_cnt(path), device=dev)


def run(n: int, reps: int) -> dict:
    dev = torch.device("cuda")
    model = model_for(n, dev)
    nn, nd, N = model.n_node, model.ndof, model.n_dof_total
    gather = femop.incidence_gather(model, dev)
    mass = dyn.lumped_mass_vector(model, gather)
    p = BlockPrograms(model, model.blocks[0])
    state = init_block_state(model.blocks[0], p.table, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = 1e-3 * torch.randn(N, dtype=torch.float64, device=dev,
                           generator=gen)
    du = 1e-5 * torch.randn(N, dtype=torch.float64, device=dev,
                            generator=gen)
    f = torch.as_tensor(model.f_ext, device=dev)
    free = torch.as_tensor(np.isin(np.arange(N), model.fixed_dofs,
                                   invert=True).astype(np.float64),
                           device=dev)
    dt = 1.0e-9
    a1 = 1.0 / (dt * dt)
    vec1 = torch.where(a1 * mass * free == 0.0, 1.0, a1 * mass)
    m2, m3 = 2.0 * a1 * mass, -a1 * mass
    ue = _element_values(u, p, nn, nd)
    due = _element_values(du, p, nn, nd)
    qf = p.update(ue, due, state)[1]

    def step():
        Q = femop.gather_sum([p.update(_element_values(u, p, nn, nd),
                                       _element_values(du, p, nn, nd),
                                       state)[1]], gather)
        B = f - Q + m2 * u + m3 * (u - du)
        X = torch.where(free > 0, B / vec1, 0.0)
        _commit_state(state)
        return X

    def update_step():
        return p.update(_element_values(u, p, nn, nd),
                        _element_values(du, p, nn, nd), state)

    E = len(model.blocks[0].elem_ids)
    m = model.blocks[0].dofs.shape[1]
    nbytes = 8 * (2 * E * m + E * m + 2 * E * m + N)
    row = dict(n=n, elements=E, dofs=N,
               step_ms=cuda_ms(step, reps),
               element_values_ms=cuda_ms(
                   lambda: (_element_values(u, p, nn, nd),
                            _element_values(du, p, nn, nd)), reps),
               update_ms=cuda_ms(lambda: p.update(ue, due, state), reps),
               gather_sum_ms=cuda_ms(lambda: femop.gather_sum([qf], gather),
                                     reps),
               bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_bytes=nbytes)
    split, launches = kernel_times(update_step, reps)
    row.update(kernels_total_ms=sum(split.values()),
               kernel_launches=launches, kernels=split)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=69)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench.dynamic_step: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    run(args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
