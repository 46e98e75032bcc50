"""Command-line front end of the preprocessing pipeline (the JAX package's
``process_data/cli.py``). Each tool builds its dataclass config from
``--field value`` flags.

Usage: python -m nerf_kbs_tpu_torch.process_data.cli <tool> [--field value ...]
       (or the ``nkt-process-torch`` script)
tools: motion-mask | inpaint | flows | metadata | images

The networks run on the CUDA card; ``main(argv, device="cpu")`` runs them on
the CPU from Python.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any


def _apply(cfg: Any, overrides: dict[str, str]) -> Any:
    """The config with each flag's value, typed by its field's annotation
    (an ``Optional[int]`` that is None parses as an int too)."""
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    for key, raw in overrides.items():
        name = key.replace("-", "_")
        if name not in fields:
            raise SystemExit(f"unknown option --{key}; have: {sorted(fields)}")
        kind = str(fields[name])
        if raw.lower() == "none" and kind.startswith("Optional"):
            val = None
        elif "bool" in kind:
            val = raw.lower() in ("1", "true", "yes")
        elif "int" in kind:
            val = int(raw)
        elif "float" in kind:
            val = float(raw)
        else:
            val = raw
        cfg = dataclasses.replace(cfg, **{name: val})
    return cfg


def _parse_flags(argv: list[str]) -> dict[str, str]:
    out = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"expected --option, got {a!r}")
        if "=" in a:
            k, _, v = a[2:].partition("=")
            out[k] = v
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"--{a[2:]} needs a value")
            out[a[2:]] = argv[i + 1]
            i += 2
    return out


def main(argv: list[str] | None = None, device=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    tool = argv.pop(0)
    flags = _parse_flags(argv)
    if tool == "motion-mask":
        from nerf_kbs_tpu_torch.process_data.motion_mask_driver import MotionMaskConfig, run

        print(run(_apply(MotionMaskConfig(), flags), device=device))
    elif tool == "inpaint":
        from nerf_kbs_tpu_torch.process_data.inpaint import InpaintDriverConfig, run

        written = run(_apply(InpaintDriverConfig(), flags), device=device)
        print(f"wrote {len(written)} frames to {written[0].rsplit('/', 1)[0]}")
    elif tool == "flows":
        from nerf_kbs_tpu_torch.process_data.raft_driver import FlowExtractConfig, extract_flows

        print(extract_flows(_apply(FlowExtractConfig(), flags), device=device))
    elif tool == "metadata":
        from nerf_kbs_tpu_torch.process_data.metadata import (
            KittiMetadataConfig,
            build_kitti_metadata,
        )

        items = build_kitti_metadata(_apply(KittiMetadataConfig(), flags))
        print(f"wrote metadata for {len(items)} frames")
    elif tool == "images":
        from nerf_kbs_tpu_torch.process_data.create_transform import ProcessImagesConfig
        from nerf_kbs_tpu_torch.process_data.create_transform import main as images_main

        print(images_main(_apply(ProcessImagesConfig(), flags)))
    else:
        raise SystemExit(f"unknown tool {tool!r}; see --help")


if __name__ == "__main__":
    main()
