"""Build the CUDA kernels from the sources in this package, bind with ctypes.

Each ``csrc/*.cu`` file is one shared library with a plain C interface
(the receive kernels share ``csrc/accum.cuh``),
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/``
at the repository root (listed in ``.gitignore``).  The library name carries
a hash of its source, so an edited source rebuilds and an unchanged one is
loaded as built.  Nothing here runs at import time: the CPU tests import
every module, and ``nvcc`` is reached only when a wrapper is handed a CUDA
tensor (or ``chip_smoke.py`` builds ahead).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_I64 = ctypes.c_longlong

# C signature of every exported function: (argtypes), restype is int (for a
# launcher, the cudaError_t of cudaGetLastError after the launch).  Besides
# the launchers: K6's grid and K6c's and K7b's path for a shape without
# launching, and the registers and local bytes of K6c's and K7b's kernel
# instances (`kernel_attrs`).
SIGNATURES = {
    "quant": {
        "quantize_pack_2d_launch": (_P, _P, _P, _I, _I, _I, _U32, _U32, _P),
        "unpack_dequant_axpy_2d_launch": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
        "unpack_dequant_axpy_2d_bf16_launch": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
        "quantize_2d_launch": (_P, _P, _P, _I, _I, _I, _U32, _U32, _P),
        "dequantize_2d_launch": (_P, _P, _P, _I64, _I, _F, _P),
        "unpack_dequant_2d_launch": (_P, _P, _P, _I, _I, _I, _F, _P),
    },
    "sign": {
        "sign_pack_2d_launch": (_P, _P, _P, _I, _I, _I, _P),
        "unpack_sign_axpy_2d_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _P),
        "unpack_sign_axpy_2d_bf16_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _P),
    },
    "sparse": {
        "sparse_select_pack_2d_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _U32, _F,
                                         _P),
        "sparse_select_pack_2d_grid": (_I, _I, _I, _I),
        "sparse_scatter_axpy_2d_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
        "sparse_scatter_axpy_2d_bf16_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                               _P),
        "sparse_unpack_scatter_2d_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
        "sparse_scatter_axpy_2d_path": (_I, _I, _I, _P, _P),
        "sparse_kernel_attrs": (_I, _P, _P, _P, _I),
    },
    "lowrank": {
        "lowrank_project_2d_launch": (_P, _P, _P, _I, _I, _I, _I, _I64, _P),
        "lowrank_axpy_2d_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I64, _F, _F, _P),
        "lowrank_axpy_2d_bf16_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I64, _F, _F, _P),
        "lowrank_axpy_2d_path": (_I, _I, _P, _P),
        "lowrank_kernel_attrs": (_I, _P, _P, _P, _I),
    },
    "markov": {
        "markov_walk_launch": (_P, _P, _I, _I, _I, _U32, _F, _I, _P),
        "markov_scores_launch": (_P, _P, _P, _I, _I, _I, _U32, _F, _P),
    },
    "adamw": {
        "adamw_update_launch": (_P, _P, _P, _P, _P, _I64, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                                _F, _P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source and
    of the shared headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_library(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` if its library is missing; returns the
    compiler's log (register and shared-memory use) or None when cached.
    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            compile_library(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


class LaunchCount:
    """The launch and call counts of a kernel variant that shares its wrapper
    with the kernel (the bf16-accumulator receives): ``launches`` and
    ``calls`` under ``__name__``, read and reset with the wrappers' own
    counts."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0
        self.calls = 0


def count_call(counter, launched: bool = False) -> None:
    """One call of ``counter``'s kernel (a wrapper or a :class:`LaunchCount`)
    that ran on real tensors: ``calls`` counts it, ``launches`` too when it
    ``launched`` on the card rather than through the plain version."""
    counter.calls += 1
    if launched:
        counter.launches += 1


def kernel_attrs(name: str) -> list:
    """(kernel instance, registers, local bytes) of every instance that
    library ``name`` lists in its ``<name>_kernel_attrs`` query
    (``cudaFuncGetAttributes``: local bytes are spills and stack)."""
    query = getattr(load(name), f"{name}_kernel_attrs")
    out, i = [], 0
    while True:
        regs, local, label = ctypes.c_int(), ctypes.c_int(), ctypes.create_string_buffer(96)
        err = query(i, ctypes.byref(regs), ctypes.byref(local), label, len(label))
        if err == -1:
            return out
        check_launch(f"{name}_kernel_attrs", err)
        out.append((label.value.decode(), regs.value, local.value))
        i += 1


def check_launch(fn_name: str, err: int) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
