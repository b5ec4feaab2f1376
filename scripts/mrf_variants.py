#!/usr/bin/env python3
"""Where K4's time goes on the card: builds variants of
`arttts_tpu_torch/csrc/mrf.cu` (and of `csrc/tf32_mma.cuh`) with parts of
the work taken out or the tiling changed, and times each over the three MRF
stages of one 768-frame request of the v2 vocoder (B=1; C=128 at 49,152
frames, C=64 at 98,304, C=32 at 196,608; kernel sizes 3/7/11, dilations
1/3/5), whole and branch by branch.

    python3 scripts/mrf_variants.py [--out build/mrf_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants, as in `scripts/updown_variants.py` (built into
build/mrf_variants/<variant>/):
- `kernel`: the source as it is;
- `no_mma`: no tensor-core work: the staging, the weight ring, the
  barriers and the epilogues;
- `no_copies`: only the first weight chunk is copied: the fragment loads,
  the split, the `mma`s, the barriers and the epilogues;
- `one_pass`: one TF32 `mma` per product instead of three (wrong answers
  by design: what the split costs);
- `taps_unrolled`: the tap loop unrolled (loads hoisted across taps, at
  up to 255 registers and spills);
- `window_loads`: the input window staged by plain loads instead of
  `cp.async` (each warp's loads wait in turn);
- `c128_16warps`: C=128 blocks of 16 warps with 32 x 32 warp tiles (the
  same 128 columns and shared memory, twice the warps an SM);
- `split_rna`: the 3xTF32 split of `csrc/tf32_mma.cuh` (hi rounded by
  `cvt.rna`) instead of the kernel's (hi = x with its low 13 bits cleared);
- `c128_64cols`: C=128 blocks of 64 conv1 columns (warp tile 32 x 32)
  instead of 128: twice the blocks, twice the halo recompute.
Each stage runs through the port's own wrapper (`ops/mrf.py`) with the
variant's library, timed by CUDA events around a CUDA graph of 5 stage
calls (device time, no host in the loop), beside the stage's 18
convolutions through cuDNN (`F.conv1d`, TF32 off) on the same inputs.
Prints one JSON object: ms per stage and per branch, the request's sum,
errors against the plain version, and the TFLOP/s of TF32 products each
variant runs (three passes a product; one in `one_pass`).
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from updown_variants import HEADER, MMA3, build_variants, graph_ms  # noqa: E402

VARIANTS = {
    "kernel": [],
    "no_mma": [(HEADER, MMA3 + "#pragma unroll\n  for (int n = 0; n < N; ++n) "
                "mma_tf32(acc[n], ah, bh[n]);", "")],
    "no_copies": [(None, "    if (c + 1 < 2 * NCH) load_w(", "    if (c < 0) load_w(")],
    "one_pass": [(HEADER, MMA3, "")],
    "taps_unrolled": [(None, "#pragma unroll 1\n    for (int tap = 0;",
                       "#pragma unroll\n    for (int tap = 0;")],
    "window_loads": [(None, "      cp_async4(dst + j, ok ? src + gg : xb, ok);",
                      "      dst[j] = ok ? src[gg] : 0.f;")],
    "c128_16warps": [(None, "kWarps = 8;", "kWarps = C == 128 ? 16 : 8;"),
                     (None, "kNT = C == 128 ? 8 : 4;", "kNT = 4;")],
    "split_rna": [(None, "  hi = __float_as_uint(x) & 0xffffe000u;", "  hi = arttts::to_tf32(x);")],
    "c128_64cols": [(None, "kNT = C == 128 ? 8 : 4;", "kNT = 4;")],
}
STAGES = [(128, 768 * 64), (64, 768 * 128), (32, 768 * 256)]
KS, DILS = (3, 7, 11), (1, 3, 5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("mrf_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from arttts_tpu_torch.ops import mrf

    libs, ptxas = build_variants("mrf", VARIANTS, ROOT / "build" / "mrf_variants")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows, total = [], {name: 0.0 for name in list(libs) + ["cudnn_convs"]}
    for C, T in STAGES:
        x = rnd(1, C, T)
        w = tuple(mrf.MRFBranch(w1=rnd(3, C, C, k, scale=(k * C) ** -0.5), b1=rnd(3, C, scale=0.1),
                                w2=rnd(3, C, C, k, scale=(k * C) ** -0.5), b2=rnd(3, C, scale=0.1),
                                dilations=DILS) for k in KS)
        ref = mrf.mrf_stage_plain(x, w)
        flops = 2 * 2 * C * C * T * len(DILS) * sum(KS)
        convs = [(br.w1[r], br.b1[r], d * (k - 1) // 2, d) for br, k in zip(w, KS)
                 for r, d in enumerate(DILS)]
        convs += [(br.w2[r], br.b2[r], (k - 1) // 2, 1) for br, k in zip(w, KS)
                  for r in range(len(DILS))]
        cudnn = graph_ms(lambda: [F.conv1d(x, k_, b_, padding=p_, dilation=d_)
                                  for k_, b_, p_, d_ in convs], n=5)
        row = {"C": C, "T": T, "gflop": flops / 1e9, "cudnn_convs_ms": cudnn}
        total["cudnn_convs"] += cudnn
        for name, L in libs.items():
            got = mrf._mrf_stage_cuda(L, x, w, None)
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            ms = graph_ms(lambda L=L: mrf._mrf_stage_cuda(L, x, w, None), n=5)
            by_branch = {f"k={k}": graph_ms(lambda L=L, br=br: mrf._mrf_stage_cuda(
                L, x, (br,), None), n=5) for br, k in zip(w, KS)}
            passes = 1 if name == "one_pass" else 3
            row[name] = {"ms": ms, "by_branch_ms": by_branch, "max_rel_err": rel,
                         "tf32_tflops": passes * flops / ms / 1e9}
            total[name] += ms
        rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"mrf_variants": {"card": smi, "ptxas": ptxas, "stages": rows,
                               "request_ms": total}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
