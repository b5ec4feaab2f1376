"""Runtime setup of the port's CLIs (counterpart of
`arttts_tpu/core/runtime.py`, which turns on JAX's compile cache).

Float32 is the port's arithmetic contract: cuBLAS and cuDNN would otherwise
be free to run float32 products in TF32 on the tensor cores. There is no
compile cache to set up (the kernels are built once per process,
`ops/_build.py`).
"""

from __future__ import annotations

import torch

from arttts_tpu_torch.core.device import resolve


def setup_runtime(device="cuda") -> torch.device:
    """Turn TF32 off for matmuls and convolutions and resolve `device`
    (raises for "cuda" when there is no card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve(device)
