#!/usr/bin/env python
"""Entry point for the 'nerfacto' method on the PyTorch/CUDA port, the
counterpart of train_nerfacto.py. Usage: python train_nerfacto_torch.py [nerfacto] [--field value ...];
with no method argument, 'nerfacto' is assumed. Runs on the CUDA card."""
import sys

from nerf_kbs_tpu_torch.engine.cli import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if (not argv or argv[0].startswith("--")) and argv[:1] != ["--help"] and argv[:1] != ["-h"]:
        argv = ["nerfacto"] + argv
    main(argv)
