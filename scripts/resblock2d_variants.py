#!/usr/bin/env python3
"""Where K1's product time goes on the card: builds variants of
`arttts_tpu_torch/csrc/resblock2d.cu` (and of `csrc/tf32_mma.cuh`) with
parts of the work taken out and times their 3x3 and 1x1 product launches
at every shape of one score evaluation of the U-Net (B=1, 80 x 768 and
80 x 1024 mel, full lengths).

    python3 scripts/resblock2d_variants.py [--out build/resblock2d_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants of the `mma.sync` body, as in `scripts/updown_variants.py` (built
into build/resblock2d_variants/<variant>/):
- `kernel`: the source as it is;
- `no_mma`: no tensor-core work: the staging ring, the barriers and the
  epilogue;
- `no_copies`: only the first chunk is copied: the fragment loads, the
  split, the `mma`s, the barriers and the epilogue;
- `one_pass`: one TF32 `mma` per product instead of three (wrong answers
  by design: what the split costs);
- `stages3`: a ring of 3 stages instead of 2;
and of the float32 3x3 product's `wgmma` route, timed at every 3x3 shape
with the tile `ops/resblock2d.py:conv3x3_route` gives it (4 rows where the
route does not take the shape):
- `wgmma`: the route as it is;
- `wgmma_no_mma`: its producers' copies and split, the ring's barriers and
  the epilogue, no `wgmma`;
- `wgmma_no_copies`: no copies after the ring's first chunks;
- `wgmma_no_split`: the copies, no split after the first chunk.
`route` sums, per evaluation, what the port runs: the `wgmma` route where
the rule takes a shape, else the `mma.sync` body. Each launch is timed by
CUDA events around a CUDA graph of 20 launches (device time, no host in the
loop); the 3x3 shapes also beside cuDNN's `F.conv2d` on the same inputs
(TF32 off). Prints one JSON object with the per-shape times and their sums
over one evaluation at each bucket (each shape times its launches per
evaluation), and the TFLOP/s of TF32 products each variant runs (three
passes a product; one in `one_pass`).
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from updown_variants import HEADER, MMA3, build_variants, graph_ms  # noqa: E402

VARIANTS = {
    "kernel": [],
    "no_mma": [(HEADER, MMA3 + "#pragma unroll\n  for (int n = 0; n < N; ++n) "
                "mma_tf32(acc[n], ah, bh[n]);", "")],
    "no_copies": [(None, "    if (c + kStages - 1 < n_chunks) load(", "    if (c < 0) load(")],
    "one_pass": [(HEADER, MMA3, "")],
    "stages3": [(None, "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "wgmma_no_mma": [(None, "using arttts::wgmma_m64n64k8;",
                      "__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t a, "
                      "uint64_t b) { asm volatile(\"\" : \"+f\"(d[0]) : \"l\"(a), \"l\"(b)); }")],
    "wgmma_no_copies": [(None, "        load(c, c % kStages);",
                         "        if (c < kStages) load(c, c % kStages);")],
    "wgmma_no_split": [(None, "        split(cs % kStages);", "        if (cs == 0) split(cs % kStages);")],
}
# TF32 passes per product each variant runs
PASSES = {"no_mma": 0, "one_pass": 1, "wgmma_no_mma": 0}
# (kind, input chunks, c_out, H, T at 80 x 768, launches per score evaluation)
SHAPES = [
    ("3x3", (2,), 64, 80, 768, 1), ("3x3", (64,), 64, 80, 768, 4),
    ("3x3", (64,), 128, 40, 384, 1), ("3x3", (128,), 128, 40, 384, 3),
    ("3x3", (128,), 256, 20, 192, 1), ("3x3", (256,), 256, 20, 192, 7),
    ("3x3", (256, 256), 128, 20, 192, 1), ("3x3", (128,), 128, 20, 192, 3),
    ("3x3", (128, 128), 64, 40, 384, 1), ("3x3", (64,), 64, 40, 384, 3),
    ("1x1", (2,), 64, 80, 768, 1), ("1x1", (64,), 128, 40, 384, 1),
    ("1x1", (128,), 256, 20, 192, 1), ("1x1", (256, 256), 128, 20, 192, 1),
    ("1x1", (128, 128), 64, 40, 384, 1),
    ("1x1", (64,), 384, 80, 768, 1), ("1x1", (128,), 384, 40, 384, 1),
    ("1x1", (256,), 384, 20, 192, 2), ("1x1", (128,), 384, 20, 192, 1),
    ("1x1", (64,), 384, 40, 384, 1),
    ("1x1", (128,), 64, 80, 768, 1), ("1x1", (128,), 128, 40, 384, 1),
    ("1x1", (128,), 256, 20, 192, 2), ("1x1", (128,), 128, 20, 192, 1),
    ("1x1", (128,), 64, 40, 384, 1),
]
BUCKETS = (768, 1024)  # the 3x3 shapes at both; the 1x1 ones at 768


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("resblock2d_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from arttts_tpu_torch.ops import _build

    libs, ptxas = build_variants("resblock2d", VARIANTS,
                                 ROOT / "build" / "resblock2d_variants")
    from arttts_tpu_torch.ops import resblock2d as K1

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    p = _build.ptr

    rows = []
    names = [n for n in libs if not n.startswith("wgmma_")] + ["wgmma", "route", "cudnn"]
    names += [n for n in libs if n.startswith("wgmma_")]
    per_eval = {b: {name: {"3x3": 0.0, "1x1": 0.0} for name in names} for b in BUCKETS}
    gflop = {b: {"3x3": 0.0, "1x1": 0.0} for b in BUCKETS}
    for bucket in BUCKETS:
        for kind, cs, c_out, H, T768, count in SHAPES:
            if kind == "1x1" and bucket != 768:
                continue
            T = T768 * bucket // 768
            xs = [torch.randn(1, c, H, T, generator=g, device=dev) for c in cs]
            c_in = sum(cs)
            lens = torch.tensor([T], dtype=torch.int32, device=dev)
            ks = 3 if kind == "3x3" else 1
            w = torch.randn(c_out, c_in, ks, ks, generator=g, device=dev) * (ks * ks * c_in) ** -0.5
            b = torch.randn(c_out, generator=g, device=dev) * 0.1
            x_cat = torch.cat(xs, dim=1)
            ref = F.conv2d(x_cat, w, b, padding=ks // 2)
            out = torch.empty_like(ref)
            # room for the partials of any tile (the 2-row ones have the most)
            part = torch.empty((1, c_out // 8, H * math.ceil(T / 32), 2), device=dev)
            x1, c1 = (xs[1], cs[1]) if len(xs) > 1 else (None, 0)
            flops = 2 * ks * ks * c_in * c_out * H * T
            gflop[bucket][kind] += count * flops / 1e9
            rule = K1.conv3x3_route(1, c_in, c_out, H, T, False, sms) if kind == "3x3" else 0
            row = {"kind": kind, "chunks": list(cs), "c_out": c_out, "H": H, "T": T,
                   "bucket": bucket, "per_evaluation": count, "gflop": flops / 1e9,
                   "blocks": libs["kernel"].conv_blocks(1, c_out, H, T, 0),
                   "wgmma_rows": rule,
                   "blocks_wgmma": libs["kernel"].conv_blocks(1, c_out, H, T, rule or 4)
                   if kind == "3x3" and not c_in % K1.WGMMA_CI else None}
            if kind == "3x3":
                row["cudnn_ms"] = graph_ms(lambda: F.conv2d(x_cat, w, b, padding=1))
                per_eval[bucket]["cudnn"]["3x3"] += count * row["cudnn_ms"]
            for name, L in [*libs.items(), ("wgmma", libs["kernel"])]:
                on_route = name.startswith("wgmma")
                if on_route and (kind != "3x3" or c_in % K1.WGMMA_CI):
                    continue
                ops = (p(xs[0]), cs[0], p(x1), c1, p(lens), p(w), p(b), p(out))
                if on_route:
                    def call(L=L, ops=ops):
                        _build.call(L, "conv3x3_wgmma", *ops, p(part), 1, H, T, c_out, 1,
                                    rule or 4, _build.stream(out))
                elif kind == "3x3":
                    def call(L=L, ops=ops):
                        _build.call(L, "conv3x3", *ops, p(part), 1, H, T, c_out, 1,
                                    _build.stream(out))
                else:
                    w2 = w.reshape(c_out, c_in)
                    ops = (*ops[:5], p(w2), p(b), None, None, p(out))

                    def call(L=L, ops=ops):
                        _build.call(L, "conv1x1", *ops, 1, c_out, H, T, _build.stream(out))
                call()
                torch.cuda.synchronize()
                rel = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                ms = graph_ms(call)
                row[name] = {"ms": ms, "max_rel_err": rel,
                             "tf32_tflops": PASSES.get(name, 3) * flops / ms / 1e9}
                per_eval[bucket][name][kind] += count * ms
            port = "wgmma" if rule else "kernel"
            row["route"] = port
            per_eval[bucket]["route"][kind] += count * row[port]["ms"]
            rows.append(row)
    rates = {bucket: {name: {kind: PASSES.get(name, 3) * gflop[bucket][kind] / v[kind]
                             for kind in v if v[kind]}
                      for name, v in per_eval[bucket].items() if name != "cudnn"}
             for bucket in BUCKETS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"resblock2d_variants": {
        "card": smi, "sms": sms, "ptxas": ptxas, "gflop_per_evaluation": gflop,
        "ms_per_evaluation": per_eval, "tf32_tflops_per_evaluation": rates, "rows": rows}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
