"""CLI: ``python -m frontistr_tpu_torch [--device cuda|cpu] [workdir]``
(the fistr1 binary equivalent, fistr1/src/main/main.c:77-103)."""

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="frontistr_tpu_torch",
                                description="PyTorch/CUDA FrontISTR-"
                                            "compatible FEM solver")
    p.add_argument("workdir", nargs="?", default=".",
                   help="directory containing hecmw_ctrl.dat")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda; a missing card "
                        "is an error, never a silent CPU run)")
    p.add_argument("-v", "--version", action="store_true")
    args = p.parse_args(argv)
    if args.version:
        from frontistr_tpu_torch import __version__
        print(f"frontistr_tpu_torch {__version__}")
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available")
    from frontistr_tpu_torch.run import run_directory
    out = run_directory(args.workdir, device=args.device)
    for line in _summary(out):
        print(line)
    print(f"### frontistr_tpu_torch completed ({out['total_time']:.2f} s)")
    return 0


def _summary(out):
    """One line for each result of a ``run_directory`` output."""
    if "heat" in out:
        hr = out["heat"]
        yield (f"### heat: steps={hr.steps} fixed_point_iters={hr.iters} "
               f"cg_iters={sum(sum(h['cg']) for h in hr.history)}")
    if "freq" in out:
        fr = out["freq"]
        k = int(np.argmax(fr.disp_amp_max))
        yield (f"### frequency response: {len(fr.freqs)} frequencies, "
               f"peak disp_amp_max {fr.disp_amp_max[k]:.6e} at "
               f"{fr.freqs[k]:.6e} Hz")
    if "dynamic" in out:
        dr = out["dynamic"]
        cg = sum(sum(h["cg"]) for h in dr.history)
        yield (f"### dynamic: {dr.arm} steps={dr.steps} "
               f"newton_iters={sum(h['newton'] for h in dr.history)} "
               f"cg_iters={cg}")
    res = out.get("static")
    if res is not None and res.newton is not None:
        nw = res.newton
        yield (f"### newton: policy={res.policy} substeps={nw.substeps} "
               f"iterations={nw.total_iters} cutbacks={nw.cutbacks} "
               f"cg_iters={sum(h['cg_iters'] for h in nw.history)}")
    elif res is not None:
        yield (f"### solve: policy={res.policy} iters={res.iters} "
               f"passes={res.passes} relres={res.relres:.3e}")
    if "eigen" in out:
        er = out["eigen"]
        yield (f"### eigen: lanczos_iters={er.iters} "
               f"first_freq={er.freq[0]:.6e} Hz")
    if "flow" in out:
        fr = out["flow"]
        yield (f"### flow: steps={fr.steps} solves={fr.iters} "
               f"bicgstab_iters={sum(sum(h['bicgstab']) for h in fr.history)}"
               f" resid={fr.resid:.3e}")
    if "precheck" in out:
        yield (f"### precheck: degenerate elements "
               f"{out['precheck'].n_degenerate}")

if __name__ == "__main__":
    sys.exit(main())
