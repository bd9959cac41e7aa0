"""CLI: ``python -m frontistr_tpu_torch [--device cuda|cpu] [workdir]``
(the fistr1 binary equivalent, fistr1/src/main/main.c:77-103)."""

import argparse
import sys


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
    res = out["static"]
    print(f"### solve: policy={res.policy} iters={res.iters} "
          f"passes={res.passes} relres={res.relres:.3e}")
    print(f"### frontistr_tpu_torch completed ({out['total_time']:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
