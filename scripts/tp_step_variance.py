#!/usr/bin/env python3
"""Why two runs of the same v2 train step land apart on the card, and how
far. Every run is `chip_smoke.py` phase 15's two steps on
`chip_smoke.dp_batches()` from `_v2_model`'s seeded weights (B=16, pinned
draws, dropout 0):

- `default_{i}`: the one-process step in this process, cuDNN as the port
  runs it;
- `held_{g}g`: the same while another process holds all of the card's
  free memory but g GiB (cuDNN may then fall back to algorithms with a
  smaller workspace);
- `det_{i}`, `det_held_{g}g`: with `torch.backends.cudnn.deterministic`;
- `tp_default`, `tp_det`: phase 18's `_tp_rank_job` on two gloo ranks
  sharing the card (`shard_tp` on a 1 x 2 mesh, after each rank's own
  one-process steps), cuDNN as the port runs it, and deterministic.

For each pair of one-process runs: the elements of the first step's
gradients (before the clip) that differ at all, and the tensors where
most differ (a few elements: a reduction's order; most of a tensor: another
algorithm), then the parameters after the two steps: the elements over
2e-6 (the band `chip_smoke.py` and `tests/test_torch_train.py` hold) and
the largest difference. The TP runs' parameters are held against their
ranks' own one-process runs and this process's. Step walls a run.

    python3 scripts/tp_step_variance.py [--repeats 2] [--held 24 12 9]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(it builds the kernels first; about 2 min). Prints one JSON line a run and
a pair, then the card's name and power limit.
"""

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def params_apart(a, b):
    over = [int(((p - q).abs() > 2e-6).sum()) for p, q in zip(a, b)]
    return dict(params_over_2e6=sum(over),
                params_worst=max(float((p - q).abs().max()) for p, q in zip(a, b)))


def grads_apart(a, b, names, top=4):
    """Elements of two gradient lists that differ in any bit, and the
    tensors where the largest share differs."""
    rows = []
    for name, p, q in zip(names, a, b):
        n = int((p != q).sum())
        if n:
            rows.append((n / p.numel(), n, p.numel(), name))
    rows.sort(reverse=True)
    return dict(grad_elements_differing=sum(r[1] for r in rows),
                grad_tensors_differing=len(rows),
                grad_tensors_most_differing=[dict(name=r[3], differing=r[1], numel=r[2])
                                             for r in rows[:top]])


@contextlib.contextmanager
def held_memory(keep_gib):
    """Another process holds all of the card's free memory but `keep_gib`
    GiB for the block; yields the free bytes it leaves."""
    code = ("import sys, torch; free = torch.cuda.mem_get_info()[0]; "
            f"x = torch.empty(free - int({keep_gib} * 2**30), dtype=torch.uint8, device='cuda'); "
            "print(torch.cuda.mem_get_info()[0], flush=True); sys.stdin.read()")
    p = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True)
    try:
        yield int(p.stdout.readline())
    finally:
        p.stdin.close()
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def one_process(batches, out_size, lr, dev, deterministic):
    """Two steps of a fresh v2 in this process: the first step's gradients
    before the clip, the parameters after, the walls."""
    import torch

    import chip_smoke as cs
    from arttts_tpu_torch.train import step as step_mod

    raw = []
    real = step_mod.clip_gradients

    def recording(model, max_norm):
        if not raw:
            raw.extend(p.grad.detach().cpu().clone() for p in model.parameters())
        return real(model, max_norm)

    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    step_mod.clip_gradients = recording
    try:
        model = cs._v2_model(dev)
        opt = step_mod.make_optimizer(model, lr)
        walls = []
        for b in batches:
            tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_mod.train_step(model, opt, tb, None, out_size)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        params = [p.detach().cpu() for p in model.parameters()]
        peak = torch.cuda.max_memory_allocated(dev)
        del model, opt
        return dict(grads=raw, params=params, step_wall_ms=walls, peak_allocated_bytes=peak)
    finally:
        step_mod.clip_gradients = real
        torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--held", type=float, nargs="*", default=[24, 12, 9])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("tp_step_variance: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    exp = get_preset("v2")
    out_size, lr = exp.train.out_size, exp.train.learning_rate
    batches = cs.dp_batches()
    names = [n for n, _ in cs._v2_model("cpu").named_parameters()]
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)

    runs = {}

    def record(name, deterministic, keep=None):
        free = None
        try:
            if keep is None:
                run = one_process(batches, out_size, lr, dev, deterministic)
            else:
                with held_memory(keep) as free:
                    run = one_process(batches, out_size, lr, dev, deterministic)
        except torch.OutOfMemoryError as e:
            print(json.dumps({"run": name, "free_bytes_left": free, "oom": str(e)[:200]}),
                  flush=True)
            return
        runs[name] = run
        print(json.dumps({"run": name, "deterministic": deterministic, "free_bytes_left": free,
                          "step_wall_ms": run["step_wall_ms"],
                          "peak_allocated_bytes": run["peak_allocated_bytes"]}), flush=True)

    for i in range(args.repeats):
        record(f"default_{i}", False)
    for g in args.held:
        record(f"held_{g:g}g", False, g)
    for i in range(args.repeats):
        record(f"det_{i}", True)
    if args.held:
        record(f"det_held_{min(args.held):g}g", True, min(args.held))
    for a, b in itertools.combinations(runs, 2):
        print(json.dumps({"pair": [a, b], **grads_apart(runs[a]["grads"], runs[b]["grads"], names),
                          **params_apart(runs[a]["params"], runs[b]["params"])}), flush=True)

    ranks = cs._Ranks()
    out = ROOT / "build" / "tp_step_variance"
    out.mkdir(parents=True, exist_ok=True)
    for name, deterministic in (("tp_default", False), ("tp_det", True)):
        path = out / f"{name}.pt"
        r0, r1 = ranks.run("_tp_rank_job", batches, out_size, lr, str(path), deterministic)
        saved = torch.load(path, weights_only=True)
        row = {"run": name, "ranks_bit_equal": r0["params_digest"] == r1["params_digest"],
               "step_wall_ms": [r0["step_wall_ms"], r1["step_wall_ms"]],
               "own_one_process_step_wall_ms": [r0["one_process_step_wall_ms"],
                                                r1["one_process_step_wall_ms"]],
               "against_own_one_process": params_apart(saved["params"], saved["one_process"])}
        for ref in ("default_0", "det_0"):
            if ref in runs:
                row[f"against_{ref}"] = params_apart(saved["params"], runs[ref]["params"])
                row[f"own_one_process_against_{ref}"] = params_apart(saved["one_process"],
                                                                    runs[ref]["params"])
        print(json.dumps(row), flush=True)
    ranks.close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
