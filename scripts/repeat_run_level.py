#!/usr/bin/env python3
"""Run chip_smoke.py's phase 11 (the training entry point's run-level
features at full width) several times on one GPU, to see how far its
witness and the differences it bounds move from run to run.

    python3 scripts/repeat_run_level.py [--repeat 2]

Each repetition prints phase 11's lines (witness, streamed and resumed
differences, resident and streamed step seconds); exit code 1 if one fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_run_level: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from corrifnet_tpu_torch import ops

    chip_smoke.log(chip_smoke.card_line())
    here = os.getcwd()
    for rep in range(args.repeat):
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                chip_smoke.log(f"repetition {rep}")
                chip_smoke.phase_run_level(ops, tmp)
            finally:
                os.chdir(here)
    return 0


if __name__ == "__main__":
    sys.exit(main())
