"""CLI dispatcher: ``python -m multiview_tpu_torch <tool> ...``.

Port of ``multiview_tpu/__main__.py``. Ported tools:

  calibrate   rig_calibrator   (multi-pass rig BA)

The other tools of the reference CLI (sfm-init, fuse-mesh, texture, fit-rpc,
undistort) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def expand_flagfiles(argv, depth: int = 0):
    """gflags-style flagfile expansion: each non-empty, non-comment line of
    the file is inserted as one argument, recursively. Accepts both
    ``--flagfile=<path>`` and ``--flagfile <path>``."""
    if depth > 16:
        raise ValueError("--flagfile nesting too deep (cycle?)")
    out = []
    it = iter(argv)
    for a in it:
        path = None
        if a.startswith("--flagfile="):
            path = a.split("=", 1)[1]
        elif a == "--flagfile":
            path = next(it, None)
            if path is None:
                raise ValueError("--flagfile requires a path")
        if path is None:
            out.append(a)
            continue
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip() and not ln.strip().startswith("#")]
        out.extend(expand_flagfiles(lines, depth + 1))
    return out


def main(argv=None):
    from multiview_tpu_torch.tools import calibrate

    tools = {"calibrate": calibrate}
    parser = argparse.ArgumentParser(
        prog="multiview_tpu_torch",
        description="Rig calibration on PyTorch / CUDA (port of multiview_tpu)")
    sub = parser.add_subparsers(dest="tool", required=True)
    for name, mod in tools.items():
        p = sub.add_parser(name, help=(mod.__doc__ or "").strip().splitlines()[0])
        mod.add_args(p)
    if argv is None:
        argv = sys.argv[1:]
    args = parser.parse_args(expand_flagfiles(list(argv)))
    return tools[args.tool].run(args)


if __name__ == "__main__":
    sys.exit(main())
