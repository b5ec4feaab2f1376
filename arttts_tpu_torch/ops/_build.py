"""Builds and loads the port's CUDA kernels at first use.

Each source under `arttts_tpu_torch/csrc/` compiles with `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
`ctypes`. The sources do not include PyTorch's headers, so a build takes
seconds rather than the minutes a `torch.utils.cpp_extension.load` build of
a file that includes `torch/extension.h` takes; all sources compile in
parallel, one `nvcc` each. Libraries go to `build/arttts_tpu_torch_kernels/`
at the root of the checkout, named by a hash of their sources and flags, so
a second process reuses them.

Nothing here runs at import: the CPU tests import every module, and the
build needs the card's toolkit. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arttts_tpu_torch_kernels"
SOURCES = ("resblock2d", "updown", "mrf", "upsample1d", "mas")
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every launcher, by library
SIGNATURES = {
    "resblock2d": {
        "conv3x3": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "conv1x1": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "conv3x3_wgmma": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "conv_tiles": (_I, _I, _I, _I, _I),
        "conv_blocks": (_I, _I, _I, _I, _I),
        "conv_wgmma_info": (_I, _P),
        "gn_stats": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "gn_act": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P),
        "attn_chunks": (_I,),
        "attention_core": (_P, _P, _P, _P, _P, _I, _I, _P),
    },
    "updown": {
        "downsample3x3s2": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "convt4x4s2": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "mrf": {
        "mrf_round": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "mrf_blocks": (_I, _I, _I, _I),
    },
    "upsample1d": {
        "upsample1d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "upsample1d_blocks": (_I, _I, _I, _I, _I, _I),
    },
    "mas": {
        "mas_path": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
        "mas_dec_words": (_I, _I, _I),
    },
}

# launchers that also come in the bf16 mode (bf16 operands, float32 sums),
# named `launcher(fn, True)`, with the same arguments
BF16_LAUNCHERS = {
    "resblock2d": ("conv3x3", "conv1x1", "attention_core"),
    "updown": ("downsample3x3s2", "convt4x4s2"),
    "mrf": ("mrf_round",),
}


def launcher(fn: str, bf16: bool) -> str:
    """The name of launcher `fn` in the float32 or the bf16 mode."""
    return fn + "_bf16" if bf16 else fn


_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing (in parallel) and load
    all of them. Returns {source name: ctypes.CDLL}. Raises on any failure."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels need a CUDA device; none is available")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name, so in todo.items():
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(so) + ".tmp", str(CSRC / f"{name}.cu")]
                procs[name] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )
            failed = []
            for name, p in procs.items():
                log, _ = p.communicate()
                (BUILD_DIR / f"{name}.log").write_text(log)
                if p.returncode != 0:
                    failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{log}")
                else:
                    os.replace(str(todo[name]) + ".tmp", todo[name])
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            lib = ctypes.CDLL(str(_target(name)))
            sigs = dict(SIGNATURES[name])
            sigs.update((launcher(fn, True), sigs[fn]) for fn in BF16_LAUNCHERS.get(name, ()))
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.arttts_error_string.argtypes = (ctypes.c_int,)
            lib.arttts_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


def library(name: str):
    """The loaded library of one source, building all of them at first use."""
    return build_all()[name]


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and shared-memory report) from
    the last build of `name` in this checkout, or '' when none ran here."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def stream(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def call(lib, fn: str, *args) -> None:
    """Run a launcher; raise with CUDA's message if it reports an error."""
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.arttts_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def ptr(t) -> int | None:
    """Device address of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()
