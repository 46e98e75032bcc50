#!/usr/bin/env python
"""Entry point for the 'vanilla-nerf' method on the PyTorch/CUDA port, the
counterpart of train_nerf.py. Usage: python train_nerf_torch.py [vanilla-nerf] [--field value ...];
with no method argument, 'vanilla-nerf' is assumed. Runs on the CUDA card."""
import sys

from nerf_kbs_tpu_torch.engine.cli import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if (not argv or argv[0].startswith("--")) and argv[:1] != ["--help"] and argv[:1] != ["-h"]:
        argv = ["vanilla-nerf"] + argv
    main(argv)
