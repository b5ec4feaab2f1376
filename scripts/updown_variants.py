#!/usr/bin/env python3
"""Where K2's and K3's time goes on the card: builds variants of
`arttts_tpu_torch/csrc/updown.cu` with parts of the work taken out and
times each at the U-Net's four call shapes (B=1, full lengths).

    python3 scripts/updown_variants.py [--out build/updown_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants (textual edits of the source and of `csrc/tf32_mma.cuh`, built
with the port's nvcc flags into build/updown_variants/<variant>/):
- `kernel`: the source as it is;
- `no_mma`: no tensor-core work (the split and the fragment loads go with
  it): the staging ring, the barriers and the epilogue;
- `no_copies`: only the first chunk is copied: the fragment loads, the
  split, the `mma`s, the barriers and the epilogue;
- `one_pass`: one TF32 `mma` per product instead of three (wrong answers
  by design, about 3e-4 relative: what the split costs);
- `stages3`: a ring of 3 stages instead of 2.
Each is timed by CUDA events around a CUDA graph of 20 launches (device
time, no host in the loop) beside the library call on the same inputs
(`F.conv2d` / `F.conv_transpose2d`, TF32 off). Prints one JSON object.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MMA3 = ("#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(acc[n], al, bh[n]);\n"
        "#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bl[n]);\n")
HEADER = "tf32_mma.cuh"
# (file, text, replacement); the file is the source or the shared header
VARIANTS = {
    "kernel": [],
    "no_mma": [(HEADER, MMA3 + "#pragma unroll\n  for (int n = 0; n < N; ++n) "
                "mma_tf32(acc[n], ah, bh[n]);", "")],
    "no_copies": [(None, "    if (c + kStages - 1 < n_chunks) load(", "    if (c < 0) load(")],
    "one_pass": [(HEADER, MMA3, "")],
    "stages3": [(None, "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
SHAPES = [("downsample2d", 64, 80, 768), ("downsample2d", 128, 40, 384),
          ("conv_transpose2d", 128, 20, 192), ("conv_transpose2d", 64, 40, 384)]


def build_variants(source, variants, out_dir, src=None, signatures=None):
    """Build each variant of csrc/<source>.cu, or of the file `src` (edits
    of the source, None, or of the shared header) into out_dir/<variant>/;
    a variant's copy of the header sits beside its source, so the include
    finds it first. Launchers are bound with `signatures` (default: the
    port's for `source`). Returns ({variant: ctypes library}, {variant:
    ptxas lines})."""
    from arttts_tpu_torch.ops import _build

    src = Path(src) if src is not None else _build.CSRC / f"{source}.cu"
    signatures = signatures if signatures is not None else _build.SIGNATURES[source]
    procs = {}
    for name, edits in variants.items():
        files = {None: src.read_text(),
                 HEADER: (_build.CSRC / HEADER).read_text()}
        for f, a, b in edits:
            if a not in files[f]:
                sys.exit(f"variants: {name} no longer applies to {f or source + '.cu'}")
            files[f] = files[f].replace(a, b)
        vdir = out_dir / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / f"{source}.cu").write_text(files[None])
        (vdir / HEADER).write_text(files[HEADER])
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(vdir / f"{source}.so"), str(vdir / f"{source}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs, ptxas = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"variants: {name} does not build:\n{log}")
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(out_dir / name / f"{source}.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.arttts_error_string.argtypes = (ctypes.c_int,)
        lib.arttts_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, ptxas


def graph_ms(fn, n=20, reps=5):
    """Device ms per call of fn: CUDA events around replays of a CUDA graph
    of n calls (no host in the loop)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (n * reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("updown_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from arttts_tpu_torch.ops import _build, updown

    libs, ptxas = build_variants("updown", VARIANTS, ROOT / "build" / "updown_variants")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    rows = []
    for kernel, c, H, T in SHAPES:
        x = torch.randn(1, c, H, T, generator=g, device=dev)
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        if kernel == "downsample2d":
            w = torch.randn(c, c, 3, 3, generator=g, device=dev) * (9 * c) ** -0.5
            b = torch.randn(c, generator=g, device=dev) * 0.1
            ref = updown.downsample2d_plain(x, lens, w, b)
            lib = lambda: torch.nn.functional.conv2d(x, w, b, stride=2, padding=1)  # noqa: E731
            fn = "downsample3x3s2"
        else:
            w = torch.randn(c, c, 4, 4, generator=g, device=dev) * (4 * c) ** -0.5
            b = torch.randn(c, generator=g, device=dev) * 0.1
            ref = updown.conv_transpose2d_plain(x, lens, w, b)
            lib = lambda: torch.nn.functional.conv_transpose2d(  # noqa: E731
                x, w, b, stride=2, padding=1)
            fn = "convt4x4s2"
        out = torch.empty_like(ref)
        row = {"kernel": kernel, "shape": [1, c, H, T], "library_ms": graph_ms(lib)}
        for name, L in libs.items():
            def call(L=L):
                _build.call(L, fn, x.data_ptr(), lens.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), 1, c, c, H, T, _build.stream(x))
            call()
            torch.cuda.synchronize()
            rel = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            row[name] = {"ms": graph_ms(call), "max_rel_err": rel}
        rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"updown_variants": {"card": smi, "ptxas": ptxas, "rows": rows}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
