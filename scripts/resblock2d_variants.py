#!/usr/bin/env python3
"""Where K1's product time goes on the card: builds variants of
`arttts_tpu_torch/csrc/resblock2d.cu` (and of `csrc/tf32_mma.cuh`) with
parts of the work taken out, and the `wgmma` route tried against it, and
times their 3x3 and 1x1 product launches at every shape of one score
evaluation of the U-Net (B=1, 80x768 mel, full lengths).

    python3 scripts/resblock2d_variants.py [--out build/resblock2d_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants, as in `scripts/updown_variants.py` (built into
build/resblock2d_variants/<variant>/):
- `kernel`: the source as it is (`mma.sync`);
- `no_mma`: no tensor-core work: the staging ring, the barriers and the
  epilogue;
- `no_copies`: only the first chunk is copied: the fragment loads, the
  split, the `mma`s, the barriers and the epilogue;
- `one_pass`: one TF32 `mma` per product instead of three (wrong answers
  by design: what the split costs);
- `stages3`: a ring of 3 stages instead of 2;
and `wgmma`, the same products on Hopper's warpgroup `wgmma`
(`scripts/conv_wgmma_route.cu`, tiles that give every SM a block), with
`wgmma_4rows`, its 3x3 product with the 4-row tile at every shape.
Each launch is timed by CUDA events around a CUDA graph of 20 launches
(device time, no host in the loop); the 3x3 shapes also beside cuDNN's
`F.conv2d` on the same inputs (TF32 off). Prints one JSON object with the
per-shape times and their sums over one evaluation (each shape times its
launches per evaluation), and the TFLOP/s of TF32 products each variant
runs (three passes a product; one in `one_pass`).
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
}
# TF32 passes per product each variant runs
PASSES = {"no_mma": 0, "one_pass": 1}
# (kind, input chunks, c_out, H, T, launches per score evaluation at 80x768)
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
    route_dir = ROOT / "build" / "resblock2d_variants" / "wgmma"
    route_dir.mkdir(parents=True, exist_ok=True)
    route_so = route_dir / "conv_wgmma_route.so"
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                            str(route_so), str(ROOT / "scripts" / "conv_wgmma_route.cu")],
                           capture_output=True, text=True)
    if build.returncode:
        sys.exit(f"resblock2d_variants: the wgmma route does not build:\n{build.stdout}"
                 f"{build.stderr}")
    ptxas["wgmma"] = [ln.split(":", 1)[-1].strip()
                      for ln in (build.stdout + build.stderr).splitlines()
                      if "registers" in ln or "spill" in ln]
    libs["wgmma"] = route = ctypes.CDLL(str(route_so))
    for fn in ("conv3x3", "conv1x1", "conv_tiles", "conv_blocks"):
        getattr(route, fn).argtypes = _build.SIGNATURES["resblock2d"][fn]
        getattr(route, fn).restype = ctypes.c_int
    route.conv3x3_4rows.argtypes = _build.SIGNATURES["resblock2d"]["conv3x3"]
    route.conv3x3_4rows.restype = ctypes.c_int
    route.arttts_error_string.argtypes = (ctypes.c_int,)
    route.arttts_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    p = _build.ptr

    rows = []
    per_eval = {name: {"3x3": 0.0, "1x1": 0.0} for name in [*libs, "wgmma_4rows", "cudnn"]}
    gflop = {"3x3": 0.0, "1x1": 0.0}
    for kind, cs, c_out, H, T, count in SHAPES:
        xs = [torch.randn(1, c, H, T, generator=g, device=dev) for c in cs]
        c_in = sum(cs)
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        ks = 3 if kind == "3x3" else 1
        w = torch.randn(c_out, c_in, ks, ks, generator=g, device=dev) * (ks * ks * c_in) ** -0.5
        b = torch.randn(c_out, generator=g, device=dev) * 0.1
        x_cat = torch.cat(xs, dim=1)
        ref = F.conv2d(x_cat, w, b, padding=ks // 2)
        out = torch.empty_like(ref)
        # room for the partials of any tile (the 4-row one has the fewest)
        part = torch.empty((1, c_out // 8, H * math.ceil(T / 32), 2), device=dev)
        x1, c1 = (xs[1], cs[1]) if len(xs) > 1 else (None, 0)
        flops = 2 * ks * ks * c_in * c_out * H * T
        gflop[kind] += count * flops / 1e9
        row = {"kind": kind, "chunks": list(cs), "c_out": c_out, "H": H, "T": T,
               "per_evaluation": count, "blocks": libs["kernel"].conv_blocks(1, c_out, H, T),
               "blocks_wgmma": libs["wgmma"].conv_blocks(1, c_out, H, T),
               "gflop": flops / 1e9}
        if kind == "3x3":
            row["cudnn_ms"] = graph_ms(lambda: F.conv2d(x_cat, w, b, padding=1))
            per_eval["cudnn"]["3x3"] += count * row["cudnn_ms"]
        for name, L in libs.items():
            if kind == "3x3":
                def call(L=L):
                    _build.call(L, "conv3x3", p(xs[0]), cs[0], p(x1), c1, p(lens), p(w), p(b),
                                p(out), p(part), 1, H, T, c_out, 1, _build.stream(out))
            else:
                w2 = w.reshape(c_out, c_in)

                def call(L=L, w2=w2):
                    _build.call(L, "conv1x1", p(xs[0]), cs[0], p(x1), c1, p(lens), p(w2), p(b),
                                None, None, p(out), 1, c_out, H, T, _build.stream(out))
            call()
            torch.cuda.synchronize()
            rel = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            ms = graph_ms(call)
            row[name] = {"ms": ms, "max_rel_err": rel,
                         "tf32_tflops": PASSES.get(name, 3) * flops / ms / 1e9}
            per_eval[name][kind] += count * ms
        if kind == "3x3":
            def call():
                _build.call(route, "conv3x3_4rows", p(xs[0]), cs[0], p(x1), c1, p(lens), p(w),
                            p(b), p(out), p(part), 1, H, T, c_out, 1, _build.stream(out))
            call()
            torch.cuda.synchronize()
            rel = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            ms = graph_ms(call)
            row["wgmma_4rows"] = {"ms": ms, "max_rel_err": rel,
                                  "tf32_tflops": 3 * flops / ms / 1e9,
                                  "blocks": math.ceil(H / 4) * math.ceil(T / 32) * c_out // 64}
            per_eval["wgmma_4rows"][kind] += count * ms
        rows.append(row)
    rates = {name: {kind: PASSES.get(name, 3) * gflop[kind] / v[kind] for kind in v if v[kind]}
             for name, v in per_eval.items() if name != "cudnn"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"resblock2d_variants": {
        "card": smi, "ptxas": ptxas, "gflop_per_evaluation": gflop,
        "ms_per_evaluation": per_eval, "tf32_tflops_per_evaluation": rates, "rows": rows}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
