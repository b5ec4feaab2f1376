#!/usr/bin/env python3
"""Where K6's time goes on the card: builds the MAS kernel
(`arttts_tpu_torch/csrc/mas.cu`) and the one it replaced
(`scripts/mas_parent.cu`), each whole and with parts of its work taken
out, and times each at the v2 training bucket (B=16, T_x 192, T_y 1024,
the lengths `chip_smoke.py` draws: one utterance fills the bucket).

    python3 scripts/mas_variants.py [--out build/mas_variants.json]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Variants (textual edits, built with the port's nvcc flags into
build/mas_variants/<variant>/, as in `scripts/updown_variants.py`):
- `kernel`: the source as it is (forward, backtrace, path launch);
- `forward_only`: the forward DP and its decision words, no backtrace,
  no path launch;
- `forward_no_copies`: the forward with the staging warp handing over
  chunks it never copied (wrong paths by design: what waiting for the
  copies costs);
- `forward_no_ballots`: the forward with each decision taken as a bit of
  its own lane instead of a ballot (wrong paths by design);
- `forward_dp_only`: the forward's DP alone (no decision word is stored,
  so the compiler drops the ballots and their selects);
- `backtrace_only`: the decision words zeroed in place of the forward
  (the walk then never steps back; the staging warp idle), the
  backtrace, no path launch;
- `walk_one_frame`: the whole kernel with the backtrace walking one frame
  a step (a load, a bit test and a decrement) instead of two;
- `path_only`: the path launch alone (from an unwritten index array);
- `parent`: the parent's kernel (one block an utterance, the column in
  shared memory, a barrier a frame), whole;
- `parent_forward_only`: its forward alone;
- `parent_backtrace_and_path`: its backtrace and its path writes (words
  zeroed), no forward;
- `parent_path_write_only`: its path writes alone (its backtrace chunk
  loop with the walk taken out).
Each is timed by CUDA events around a CUDA graph of 20 kernel-only calls
(the masked value and the lengths ready on the card: device time, no
host in the loop). Beside them: the wrapper's masking alone (`value *
mask` and the two length sums of `ops/mas.py:maximum_path`), and each of
the two whole kernels with that masking in front (the wrapper's work).
The whole kernels are checked bit for bit against the plain version and
the NumPy oracle. Prints one JSON object.
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

from updown_variants import build_variants, graph_ms  # noqa: E402

NO_PATH = (None, "  mas_path_kernel<<<", "  if (B < 0) mas_path_kernel<<<")
NO_BACKTRACE = (None, "  backtrace<J, false>(", "  if (t_y < 0) backtrace<J, false>(")
VARIANTS = {
    "kernel": [],
    "forward_only": [NO_BACKTRACE, NO_PATH],
    "backtrace_only": [(None, "  if (warp == 1) {\n", "  if (warp == 1) {\n    return;\n"),
                       (None, "  for (int c = 0; c < n_chunks; ++c) {\n    while (*landed <= c)",
                        "  for (int i = lane; i < T_y * J; i += 32) sdec[i] = 0u;\n"
                        "  __syncwarp();\n"
                        "  for (int c = 0; c < 0; ++c) {\n    while (*landed <= c)"), NO_PATH],
    "forward_no_copies": [(None, "      for (int x = lane >> 2; x < 32 * J; x += 8) {",
                           "      for (int x = lane >> 2; x < 0; x += 8) {"), NO_BACKTRACE,
                          NO_PATH],
    "forward_no_ballots": [(None, "    const unsigned w = __ballot_sync(kFull, diag || p < pm);",
                            "    const unsigned w = diag || p < pm;"), NO_BACKTRACE, NO_PATH],
    "forward_dp_only": [(None, "      if (lane < J) wc[(y % kChunk) * J + lane] = mine;",
                         "      if (lane < 0) wc[(y % kChunk) * J + lane] = mine;"),
                        NO_BACKTRACE, NO_PATH],
    "walk_one_frame": [(None, "  for (; y > y_lo; y -= 2, row -= 2 * WJ) {",
                        "  for (; y < y_lo; y -= 2, row -= 2 * WJ) {")],
    "path_only": [(None, "  const int rc = launch_dp(value, t_xs, t_ys, dec, idx, B, T_x, T_y, "
                         "p, s);", "  const int rc = 0;")],
}
NO_FORWARD = (None, "  for (int y = 0; y < T_y; ++y) {\n    const float* prev",
              "  for (int y = 0; y < 0; ++y) {\n    const float* prev")
PARENT_VARIANTS = {
    "parent": [],
    "parent_forward_only": [(None, "  // ---- backtrace, 32 frames at a time, top down",
                             "  return;\n  // ---- backtrace, 32 frames at a time, top down")],
    "parent_backtrace_and_path": [NO_FORWARD],
    "parent_path_write_only": [NO_FORWARD, (None, "    if (tid == 0) {\n      for (int y = y_hi;",
                                            "    if (tid < 0) {\n      for (int y = y_hi;")],
}
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {"mas_path": (_P, _P, _P, _P, _P, _I, _I, _I, _P)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("mas_variants: needs a CUDA card")
    from arttts_tpu_torch.ops import _build
    from arttts_tpu_torch.ops import mas as K6

    out_dir = ROOT / "build" / "mas_variants"
    libs, ptxas = build_variants("mas", VARIANTS, out_dir)
    plibs, pptxas = build_variants("mas", PARENT_VARIANTS, out_dir,
                                   src=ROOT / "scripts" / "mas_parent.cu",
                                   signatures=PARENT_SIGNATURES)
    dev = torch.device("cuda")
    # the training bucket as chip_smoke.py phase 3 draws it
    r = np.random.default_rng(0)
    t_x = [192] + [int(v) for v in r.integers(100, 191, 15)]
    t_y = [1024] + [min(1024, int(v * r.uniform(2.5, 4.5))) for v in t_x[1:]]
    B, T_x, T_y = 16, 192, 1024
    g = torch.Generator(device=dev).manual_seed(0)
    value = torch.randn(B, T_x, T_y, generator=g, device=dev)
    tx = torch.tensor(t_x, dtype=torch.int32, device=dev)
    ty = torch.tensor(t_y, dtype=torch.int32, device=dev)
    mask = ((torch.arange(T_x, device=dev)[None, :, None] < tx[:, None, None])
            & (torch.arange(T_y, device=dev)[None, None, :] < ty[:, None, None])).float()
    masked = value * mask

    def masking():
        return (value * mask, mask[:, :, 0].sum(1).to(torch.int32),
                mask[:, 0, :].sum(1).to(torch.int32))

    def parent_call(lib):
        path = torch.empty_like(masked)
        dec = torch.zeros((B, T_y, (T_x + 31) // 32), dtype=torch.int32, device=dev)
        _build.call(lib, "mas_path", _build.ptr(masked), _build.ptr(tx), _build.ptr(ty),
                    _build.ptr(dec), _build.ptr(path), B, T_x, T_y, _build.stream(masked))
        return path

    calls = {name: (lambda L=L: K6._maximum_path_cuda(L, masked, tx, ty))
             for name, L in libs.items()}
    calls.update({name: (lambda L=L: parent_call(L)) for name, L in plibs.items()})
    ref = K6.maximum_path_plain(masked, tx, ty)
    oracle = K6.mas_reference_numpy(masked.cpu().numpy(), np.asarray(t_x), np.asarray(t_y))
    checks = {}
    for name in ("kernel", "parent"):
        got = calls[name]()
        torch.cuda.synchronize()
        checks[name] = dict(exact_vs_plain=bool(torch.equal(got, ref)),
                            cells_off_oracle=int((got.cpu().numpy().astype(np.int32)
                                                  != oracle).sum()))
    ms = {name: graph_ms(fn) for name, fn in calls.items()}
    ms["masking_only"] = graph_ms(masking)
    ms["wrapper_kernel"] = graph_ms(lambda: (masking(), calls["kernel"]()))
    ms["wrapper_parent"] = graph_ms(lambda: (masking(), calls["parent"]()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"mas_variants": {"card": smi, "shape": [B, T_x, T_y], "t_x": t_x, "t_y": t_y,
                               "ms": ms, "checks": checks,
                               "ptxas": {**ptxas, **pptxas}}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    if not all(c["exact_vs_plain"] and c["cells_off_oracle"] == 0 for c in checks.values()):
        sys.exit("mas_variants: a whole kernel disagrees with the plain version or the oracle")


if __name__ == "__main__":
    main()
