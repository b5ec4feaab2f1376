"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.calibrate --workload v2.serve --seconds 8 \
        --seeds 101 102 103 --mode program control fault:state_unchanged

For each mode and seed, one run of the cell in this process (the kernels
load once): `program` is the run as the benchmark makes it, with a short
window at the cell's own load; `control` is the plain reference put in the
program's place and computed in TF32, the precision below the configured
float32; `fault:<name>` is the program with a fault of `portbench/faults.py`
planted under the timed path. Prints one JSON line a run with the numbers
the check compares. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--mode", nargs="+", default=["program"])
    args = p.parse_args(argv)
    import torch

    from arttts_tpu_torch.core.runtime import setup_runtime
    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = setup_runtime("cuda:0")
    spec = harness.load_spec(args.workload)
    seen = {}
    compare = harness.compare

    def keep_all(readings, limits):  # every number the check works out, limited or not
        seen.clear()
        seen.update(readings)
        return compare(readings, limits)

    harness.compare = keep_all
    for mode in args.mode:
        fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
        for seed in args.seeds:
            run = harness.Run(spec, seed, args.seconds, device, False, args.workload,
                              fault=fault, control=mode == "control")
            t0 = time.perf_counter()
            try:
                res = harness.run_cell(run, t0, log=lambda *a: None)
                out = {"readings": dict(seen), "attempted": res["attempted"],
                       "metrics": res["metrics"]}
            except Exception as e:  # a control or fault that crashes gives no number
                out = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                              "seconds": time.perf_counter() - t0, **out}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
