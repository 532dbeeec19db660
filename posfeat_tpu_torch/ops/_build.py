"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` (which include ``csrc/hopper.cuh``) into
one shared library with a plain C interface, loaded through ``ctypes``.
The library goes to ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the sources, header and flags, and is built
the first time a kernel is launched; nothing is built when the package
is imported.
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
HEADERS = (PKG / "csrc" / "hopper.cuh",)  # included by the sources; in the library's hash
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
    for src in (*SOURCES, *HEADERS):
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
    # both files move into place whole: processes that start together (one
    # per extraction shard or training rank) may build at once, and a second
    # one never loads or reads a half-written file
    tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, so)
    return {"path": so, "seconds": seconds, "log": log}


def build_variants(src_name: str, builds, variant, out_dir) -> dict:
    """Compile one library per name in ``builds``, all in parallel, each
    from a copy of ``csrc/<src_name>`` rewritten by ``variant(src, name)``
    beside the other sources as they are (so that every entry point
    ``bind`` declares exists). For tools that time a kernel with a stage
    cut out. Returns {name: (library path, nvcc's log)}."""
    src = (PKG / "csrc" / src_name).read_text()
    os.makedirs(out_dir, exist_ok=True)
    others = [str(s) for s in SOURCES if s.name != src_name]
    inc = ["-I", str(PKG / "csrc")]  # the copies include csrc/hopper.cuh
    procs = {}
    for name in builds:
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(variant(src, name))
        procs[name] = (so, subprocess.Popen([_nvcc(), *FLAGS, *inc, "-o", so, cu, *others],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        out[name] = (so, log)
    return out


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The built library with every function's argtypes and restype set."""
    return bind(ctypes.CDLL(str(build()["path"])))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argtypes and restype of every C entry point of ``lib``, a
    build of ``SOURCES``; returns ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.posfeat_conv_phase.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.posfeat_conv_phase.restype = i
    lib.posfeat_conv_phase_img.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.posfeat_conv_phase_img.restype = i
    lib.posfeat_conv_smem_bytes.argtypes = [i, i]
    lib.posfeat_conv_smem_bytes.restype = ctypes.c_long
    lib.posfeat_head_tail.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.posfeat_head_tail.restype = i
    lib.posfeat_reinforce_split.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.posfeat_reinforce_split.restype = i
    lib.posfeat_lse_pass.argtypes = [p] * 5 + [i] * 4 + [f] + [p]
    lib.posfeat_lse_pass.restype = i
    lib.posfeat_reward_pass.argtypes = [p] * 12 + [i] * 4 + [f] * 4 + [p]
    lib.posfeat_reward_pass.restype = i
    for name in ("posfeat_error_string", "posfeat_reinforce_error_string"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib
