"""Write or drift-check the port's knob reference.

    python -m sparknet_tpu_torch.tools.knobs --emit | --check

The counterpart of the root ``tools/lint.py knobs`` for the port's
registry (``sparknet_tpu_torch/utils/knobs.py``): ``--emit`` writes
``sparknet_tpu_torch/KNOBS.md`` from :func:`knobs.knobs_md`, ``--check``
exits 1 when the file is missing or differs from it.  The root
``KNOBS.md`` is the JAX package's and is not touched.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from ..utils import knobs

KNOBS_MD = pathlib.Path(__file__).resolve().parent.parent / "KNOBS.md"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--emit", action="store_true",
                      help="write sparknet_tpu_torch/KNOBS.md")
    mode.add_argument("--check", action="store_true",
                      help="exit 1 if sparknet_tpu_torch/KNOBS.md is "
                           "missing or stale")
    args = ap.parse_args(argv)
    want = knobs.knobs_md()
    if args.emit:
        KNOBS_MD.write_text(want)
        print(f"wrote {KNOBS_MD} ({len(knobs.all_knobs())} knobs)")
        return 0
    if KNOBS_MD.exists() and KNOBS_MD.read_text() == want:
        print("sparknet_tpu_torch/KNOBS.md is in sync with the registry")
        return 0
    print("sparknet_tpu_torch/KNOBS.md is missing or stale: run `python -m "
          "sparknet_tpu_torch.tools.knobs --emit` and commit the result")
    return 1


if __name__ == "__main__":
    sys.exit(main())
