#!/usr/bin/env python
"""Entry point for the 'test-nerfacto' method on the PyTorch/CUDA port, the
counterpart of train_z1.py. Usage: python train_z1_torch.py [test-nerfacto] [--field value ...];
with no method argument, 'test-nerfacto' is assumed. Runs on the CUDA card."""
import sys

from nerf_kbs_tpu_torch.engine.cli import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if (not argv or argv[0].startswith("--")) and argv[:1] != ["--help"] and argv[:1] != ["-h"]:
        argv = ["test-nerfacto"] + argv
    main(argv)
