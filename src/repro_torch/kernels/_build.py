"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(one ``nvcc`` process per source, all started together) and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``build/repro_torch_kernels/``
at the root of the checkout, under a name that carries the hash of the
sources and flags: a changed source rebuilds, an unchanged one loads the
library already there. No ``--use_fast_math``: the quantization prologue
needs IEEE division and ``rintf``, and Box-Muller accurate ``logf``/``cosf``.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code through ``check``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    "cim_matmul_fused": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "cim_tile_partials": [_P, _I, _P, _P, _P] + [_I] * 7 + [_P],
    "cim_tile_merge": [_P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "cim_matmul_int8": [_P, _P, _P, _F, _P, _I, _I, _I, _F, _U, _U, _I, _I, _I,
                        _P],
    "decode_attention": [_P] * 10 + [_I] * 9 + [_F, _P],
    "flash_gqa": [_P] * 11 + [_I] * 11 + [_F, _P],
    "fused_dense_layer": [_P, _P],
    "ssm_decode_step": [_P] * 11 + [_I] * 14 + [_P],
    "mla_decode_attention": [_P] * 9 + [_I] * 8 + [_F, _P],
    "flash_mha": [_P] * 9 + [_I] * 8 + [_F, _P],
}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *FLAGS, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs, errors = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            text = out.decode(errors="replace")
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{text}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
