"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface, loaded through ``ctypes``. The library goes to
``build/torch_kernels/`` at the root of the checkout, named by a hash of
the sources and flags, and is built the first time a kernel is launched;
nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
SOURCES = (PKG / "csrc" / "fused_head.cu", PKG / "csrc" / "reinforce.cu")
BUILD_DIR = PKG.parent / "build" / "torch_kernels"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libposfeat_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> dict:
    """Compile the library unless it exists (or always, with ``force``).
    Returns {'path', 'seconds', 'log'}: ``log`` is nvcc's output with
    ``-Xptxas -v`` (registers, shared memory and spills of every kernel),
    kept beside the library."""
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists() and not force:
        return {"path": so, "seconds": 0.0, "log": log_path.read_text() if log_path.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return {"path": so, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The built library with every function's argtypes and restype set."""
    lib = ctypes.CDLL(str(build()["path"]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.posfeat_conv_phase.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.posfeat_conv_phase.restype = i
    lib.posfeat_head_tail.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.posfeat_head_tail.restype = i
    lib.posfeat_lse_pass.argtypes = [p] * 5 + [i] * 4 + [f] + [p]
    lib.posfeat_lse_pass.restype = i
    lib.posfeat_reward_pass.argtypes = [p] * 15 + [i] * 4 + [f] * 4 + [p]
    lib.posfeat_reward_pass.restype = i
    for name in ("posfeat_error_string", "posfeat_reinforce_error_string"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib
