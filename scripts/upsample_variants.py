#!/usr/bin/env python3
"""Where K5's time goes on the card: builds the upsample kernel
(`arttts_tpu_torch/csrc/upsample1d.cu`) with parts of its work taken out
or its tiling changed, and the kernel it replaced
(`scripts/upsample1d_parent.cu`), and times each at the v2 vocoder's two
stride-2 upsamples of a 768-frame request (B=1; 128 -> 64 at 49,152
frames, 64 -> 32 at 98,304; padding 1) and at SPARC's window batches
(B=8, 576-frame windows).

    python3 scripts/upsample_variants.py [--out build/upsample_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants (textual edits, built with the port's nvcc flags into
build/upsample_variants/<variant>/, as in `scripts/updown_variants.py`):
- `kernel`: the source as it is;
- `no_mma`: no tensor-core work (the split and the fragment loads go with
  it): the staging, the weight ring, the barriers and the epilogue;
- `one_pass`: one TF32 `mma` per product instead of three (wrong answers
  by design: what the split costs);
- `no_weight_copies`: only the first weight chunk is copied;
- `one_block_c64`: no minimum of blocks an SM in the launch bounds: the
  compiler takes 130 registers for the Cout = 64 tile, so one block fits
  an SM (the kernel holds it to 128: two);
- `parent`: the parent's kernel (`fmaf` on the CUDA cores).
Each is timed by CUDA events around a CUDA graph of 20 calls (device
time, no host in the loop) beside `F.conv_transpose1d` on the
leaky-ReLU'd input (TF32 off), and checked against the plain version.
Prints one JSON object.
"""

import argparse
import ctypes
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
    "one_pass": [(HEADER, MMA3, "")],
    "no_weight_copies": [(None, "    if (c + 1 < n_chunks) load_w(", "    if (c < 0) load_w(")],
    "one_block_c64": [(None, "__launch_bounds__(Tile<CO>::kThreads, Tile<CO>::kMinBlocks)",
                       "__launch_bounds__(Tile<CO>::kThreads)")],
}
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {"upsample1d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)}
SHAPES = [("128->64, 768-frame request", 1, 128, 64, 768 * 64),
          ("64->32, 768-frame request", 1, 64, 32, 768 * 128),
          ("128->64, SPARC window batch", 8, 128, 64, 576 * 64),
          ("64->32, SPARC window batch", 8, 64, 32, 576 * 128)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("upsample_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from arttts_tpu_torch.ops import upsample as K5

    out_dir = ROOT / "build" / "upsample_variants"
    libs, ptxas = build_variants("upsample1d", VARIANTS, out_dir)
    plibs, pptxas = build_variants("upsample1d", {"parent": []}, out_dir,
                                   src=ROOT / "scripts" / "upsample1d_parent.cu",
                                   signatures=PARENT_SIGNATURES)
    libs.update(plibs)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, request = [], dict.fromkeys(list(libs) + ["conv_transpose1d"], 0.0)
    for name, B, cin, cout, T in SHAPES:
        x = torch.randn(B, cin, T, generator=g, device=dev)
        w = torch.randn(cin, cout, 4, generator=g, device=dev) * (2 * cin) ** -0.5
        b = torch.randn(cout, generator=g, device=dev) * 0.1
        xl = F.leaky_relu(x, 0.1)
        ref = K5.upsample1d_plain(x, w, b, 2, 1, 0)
        row = {"case": name, "shape": [B, cin, cout, T],
               "conv_transpose1d_ms": graph_ms(lambda: F.conv_transpose1d(xl, w, b, 2, 1, 0))}
        for vname, L in libs.items():
            got = K5._upsample1d_cuda(L, x, w, b, 2, 1, 0)
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            row[vname] = {"ms": graph_ms(lambda L=L: K5._upsample1d_cuda(L, x, w, b, 2, 1, 0)),
                          "max_rel_err": rel}
        if B == 1:
            for vname in libs:
                request[vname] += row[vname]["ms"]
            request["conv_transpose1d"] += row["conv_transpose1d_ms"]
        rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"upsample_variants": {"card": smi, "ptxas": {**ptxas, **pptxas}, "cases": rows,
                                    "request_ms": request}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
