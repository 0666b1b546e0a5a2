"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (one JSON object); the numbers compared for `correct` are the last
lines of standard error. Exits 3, printing no result, when the machine
lacks the CUDA cards the cell asks for, and 4 when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside
    # the checkout (the program's nvcc libraries go to build/kernels/)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell

    def log(line):
        print(line, file=sys.stderr, flush=True)

    try:
        result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START, log=log)
    except cell.NoDevice as e:
        log(f"no result: {e}")
        return 3
    bad = cell.forbidden_modules()
    if bad:
        log(f"no result: loaded {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    for name, line in result["checks"].items():
        log(f"check {name}: {line['value']!r} (limit {line['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
