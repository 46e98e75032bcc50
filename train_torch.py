#!/usr/bin/env python
"""Entry point for the 'semantic-nerfw' method on the PyTorch/CUDA port, the
counterpart of train.py. Usage: python train_torch.py [semantic-nerfw] [--field value ...];
with no method argument, 'semantic-nerfw' is assumed. Runs on the CUDA card."""
import sys

from nerf_kbs_tpu_torch.engine.cli import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if (not argv or argv[0].startswith("--")) and argv[:1] != ["--help"] and argv[:1] != ["-h"]:
        argv = ["semantic-nerfw"] + argv
    main(argv)
