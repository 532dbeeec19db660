"""The host's fused crop-and-normalize of a uint8 image, through a ctypes
binding of ``native/preproc.cpp`` (the counterpart of
posfeat_tpu/data/native.py).

The library is compiled with ``g++ -O3 -march=native -shared -fPIC
-lpthread`` at its first use into ``build/torch_kernels/``, named by a
hash of the source and the flags (so it never meets the JAX package's
build of the same source), written under a temporary name and moved into
place, so that a second process never loads a half-written file. One
pass replaces numpy's convert, subtract and divide, and releases the GIL
for the loader's threads. Without g++ (or when the build fails) the same
function runs in numpy, and one warning says so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR
from .utils import IMAGENET_MEAN, IMAGENET_STD, crop_mod16

SOURCE = Path(__file__).resolve().parents[2] / "native" / "preproc.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lpthread",)
_log = logging.getLogger(__name__)
# the loaders' threads reach the first call together: one of them builds
_LOAD_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpreproc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError when g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {res.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def _library():
    """The loaded library, or None (after one warning) where it cannot be
    built; the first caller builds it while the others wait."""
    with _LOAD_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library():
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _log.warning(f"native preprocessing unavailable ({e}); normalizing images in numpy")
        return None
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.normalize_crop.argtypes = [p, i, i, i, i, p, p, p, i]
    lib.normalize_crop.restype = None
    return lib


def native_available() -> bool:
    """True when ``normalize_crop16`` runs the compiled library."""
    return _library() is not None


def normalize_crop16(im: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 HWC, cropped to multiples of 16 and
    ImageNet-normalized: (x / 255 − mean) / std, computed by the library
    as x · 1/(255·std) − mean/std (within a few ulp of numpy's). One
    thread per call: the loaders call it from their own threads."""
    im = np.ascontiguousarray(im, np.uint8)
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got shape {im.shape}")
    h, w = im.shape[:2]
    oh, ow = h - h % 16, w - w % 16
    lib = _library()
    if lib is None:
        return (crop_mod16(im).astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    out = np.empty((oh, ow, 3), np.float32)
    mean = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
    std = np.ascontiguousarray(IMAGENET_STD, np.float32)
    lib.normalize_crop(im.ctypes.data, h, w, oh, ow, mean.ctypes.data, std.ctypes.data,
                       out.ctypes.data, 1)
    return out
