#!/usr/bin/env python3
"""The full-width training step of two checkouts, in turns, on one NVIDIA
GPU.

    python3 scripts/torch_train_ab.py PARENT_DIR CHANGE_DIR

Runs chip_smoke.py's train_full phase (train_from_config over seeded stereo
WAVs, then 10 timed steps of batch 16 x 2 s chunks and the step's split by
CUDA events) from each checkout's own package and kernels, each run in a
fresh process, in the order parent, change, change, parent, so that a drift
of the card's clock or temperature falls on both sides. The checkouts are
directories holding a tree of the repository (for example a `git archive`);
each builds its kernels into its own build/. Prints each run's train_full
line with the checkout's directory under "tree". Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys

# chip_smoke.py's train phase; both checkouts must have one that takes the
# torch module alone (tests/test_torch_train_ab.py holds this call to the
# phase's signature)
RUN = "import torch, chip_smoke; chip_smoke.phase_train_full(torch)"


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1:]
    for tree in (parent, change, change, parent):
        # run from the checkout, so its chip_smoke.py and package are found
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = next(ln for ln in proc.stdout.splitlines()
                    if '"phase": "train_full"' in ln)
        print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
