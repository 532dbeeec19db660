#!/usr/bin/env python3
"""Split the time of posfeat_tpu_torch's conv kernels (K1, K3, T1, T2:
the bf16 instances in csrc/fused_head.cu, or with ``--dtype float32`` the
3xTF32 instances in csrc/fused_head_f32.cu) into their stages on one CUDA
card, by timing copies of the source with a stage cut out, at the
flagship point (B=16, h=120, w=160, Cin 192, Cout 128, KP 192).

    python3 tools/profile_torch_conv_stages.py [--dtype float32]

Builds, each from a copy of the source:
  full     the source as it is;
  no_epi   the epilogue (between its "epilogue begin" and "epilogue end"
           comments) replaced by a sum that keeps the accumulators alive:
           the MMA loop with its B stream and the halo staging;
  no_mma   the wgmma instructions removed: the B stream, the halo staging
           and the epilogue on zero accumulators (f32: on the running
           sums of accumulators no wgmma writes, with their adds);
  stream   both cut: the TMA ring and the halo staging alone (f32: the
           bulk copies of both rings, with the adds);
  mma      (f32 only) the epilogue and the staging (between "staging
           begin" and "staging end": the producer's copies and the
           consumers' waits for them) cut: the wgmmas and their adds on
           rings that are never filled.
The copies' outputs are wrong and are never read. At f32 the kernels
take the split of the real wrapper's library (timed once beside them),
and each build times the conv kernel alone. Each kernel is timed
with chip_smoke.py's timer (CUDA events around 20 launches after 3) in
the order full, no_epi, no_mma, stream, then once more in reverse. Prints
ptxas' registers and spills per build, one line per build and kernel,
and a last JSON line {"ms": {build: {kernel: [ms, ms]}}, "device": ...,
"power_limit": ...}. Without a CUDA card it exits 2 and prints no result.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _time_ms  # noqa: E402

B, H, W, CIN, COUT, KP = 16, 480, 640, 192, 128, 192
BUILDS = ("full", "no_epi", "no_mma", "stream", "mma")
KERNELS = ("K1", "K3", "T1", "T2")
# per dtype: the source, its accumulator count and z's type, and the
# wgmma calls that no_mma removes (bf16: one line; f32: the seven calls of
# a chunk's six products, each replaced by an empty statement)
SOURCES = {"bfloat16": ("fused_head.cu", 128, "__float2bfloat16(x)"),
           "float32": ("fused_head_f32.cu", 64, "x")}
KEEP_ALIVE = """    {{  // keeps the accumulators alive
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < {n}; ++i) x += acc[i];
      if (x == 12345.f) z[threadIdx.x] = {cast};
    }}
"""


def variant(src: str, build: str, dtype: str = "bfloat16") -> str:
    """The source of ``dtype``'s kernels with ``build``'s stages cut out."""
    _, n_acc, cast = SOURCES[dtype]
    if build in ("no_epi", "stream", "mma"):
        a = src.index("    // epilogue begin")
        b = src.index("    // epilogue end")
        src = src[:a] + KEEP_ALIVE.format(n=n_acc, cast=cast) + src[b:]
    if build == "mma":
        src, n = re.subn(r"^[ \t]*// staging begin.*?^(?=[ \t]*// staging end)", "", src, flags=re.S | re.M)
        assert n == 3, n
    if build in ("no_mma", "stream"):
        if dtype == "bfloat16":
            src, n = re.subn(r"\n[^\n]*wgmma_m64n256k16_ss\(acc[^\n]*", "", src)
            assert n == 1, n
        else:
            src, n = re.subn(r"wgmma_m64n128k8_tf32(?:_first)?\(d, [^;]*\);", ";", src)
            assert n == 7, n
    return src


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=tuple(SOURCES), default="bfloat16")
    dtype = ap.parse_args().dtype
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CONV_KERNELS, F32_CONV_KERNELS, _ptxas_summary
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import fused_head as fh

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    f32 = dtype == "float32"
    builds = _build.build_variants(SOURCES[dtype][0], BUILDS[:4] + BUILDS[4:] * f32,
                                   lambda src, name: variant(src, name, dtype),
                                   os.path.join(ROOT, "build", "torch_kernels", "stages", dtype))
    libs = {}
    for name, (so, log) in builds.items():
        summary = _ptxas_summary(log)
        print(f"{name}: " + "; ".join(f"{k} {summary[k]['regs']} regs, spills "
                                      f"{summary[k]['spill_stores']}/{summary[k]['spill_loads']} B"
                                      for k in (F32_CONV_KERNELS if f32 else CONV_KERNELS)))
        libs[name] = _build.bind(ctypes.CDLL(so))

    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    h, w = H // 4, W // 4
    th, tw = fh.K1_TILE
    N, T = 16 * COUT, -(-h // th) * -(-w // tw)

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    # the wrappers' operands, and what they hand the kernels: B K-major (bf16),
    # or the split's hi and lo tiles (f32)
    tp, kph = g(B, h + 2, w + 2, CIN).to(dt), g(9, CIN, N, scale=0.03).to(dt)
    pat, wm, b2b, b2 = g(B, h, w, KP).to(dt), g(B, KP, N, scale=0.03).to(dt), g(B, N), g(N)
    if f32:
        k1_ops = fh.split_conv_operands(tp, kph, pat, wm)
        img_ops = k1_ops[:2]
        split_ms = _time_ms(lambda: fh.split_conv_operands(tp, kph, pat, wm))
        print(f"split of K1's operands: {split_ms:.4f} ms (K3's halo and kph: part of it)", flush=True)
    else:
        k1_ops = (tp, fh.k_major(kph), pat, fh.k_major(wm))
        img_ops = k1_ops[:2]
    zfull, zph = g(B, H, W, COUT).to(dt), g(B, h, w, N).to(dt)
    z = torch.empty((B, h, w, N), dtype=dt, device=dev)
    ps, pq = torch.empty((B, T, N), device=dev), torch.empty((B, T, N), device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731

    def launch(lib, kernel):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if kernel == "K1":
            conv = lib.posfeat_conv_phase_f32 if f32 else lib.posfeat_conv_phase
            rc = conv(*map(ptr, k1_ops), ptr(b2b), ptr(z), ptr(ps), ptr(pq), B, h, w, CIN, KP, N, th, tw, stream)
        else:
            layout = next(lay for lay, k in fh.IMG_KERNELS.items() if k == kernel)
            img = {"full": zfull, "none": None, "phase": zph}[layout]
            conv = lib.posfeat_conv_phase_img_f32 if f32 else lib.posfeat_conv_phase_img
            rc = conv(*map(ptr, img_ops), ptr(img), ptr(b2), ptr(z), ptr(ps), ptr(pq), B, h, w, CIN, N, COUT,
                      fh.IMG_LAYOUTS.index(layout), th, tw, stream)
        if rc:
            raise RuntimeError(f"{kernel}: {lib.posfeat_error_string(rc).decode()}")

    ms = {name: {k: [] for k in KERNELS} for name in builds}
    for order in (tuple(builds), tuple(builds)[::-1]):
        for name in order:
            for k in KERNELS:
                ms[name][k].append(_time_ms(lambda: launch(libs[name], k)))
            print(f"{name}: " + ", ".join(f"{k} {ms[name][k][-1]:.4f} ms" for k in KERNELS), flush=True)
    print(smi)
    print(json.dumps({"dtype": dtype, "ms": ms, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi.split(", ")[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
