"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload v2.serve --seed 7 --seconds 45 --trace 0

From the root of a checkout that holds the port (`arttts_tpu_torch`) and a
CUDA card. Prints the numbers the check compares on standard error, and as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`.
Exits non-zero, printing no result, without a card, with fewer cards than
the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "build" / "portbench_cache"
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# Python's own bytecode of every module a run imports (torch's thousands among
# them), so that only a checkout's first run compiles it
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (REPO / "arttts_tpu_torch").is_dir():
        print("portbench: the port (arttts_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        print(f"portbench: {args.workload} needs {spec.cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from arttts_tpu_torch.core.runtime import setup_runtime

    device = setup_runtime("cuda:0")
    run = harness.Run(spec, args.seed, args.seconds, device, bool(args.trace), args.workload)
    try:
        result = harness.run_cell(run, T0)
    except harness.IsolationError as e:
        print(f"portbench: loaded in the run: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
