#!/usr/bin/env python3
"""Split the time of posfeat_tpu_torch's conv kernels (K1, K3, T1, T2 in
csrc/fused_head.cu) into their stages on one CUDA card, by timing copies
of the source with a stage cut out, at the flagship point (B=16, h=120,
w=160, Cin 192, Cout 128, KP 192).

    python3 tools/profile_torch_conv_stages.py

Builds, each from a copy of csrc/fused_head.cu:
  full     the source as it is;
  no_epi   the epilogue (between its "epilogue begin" and "epilogue end"
           comments) replaced by a sum that keeps the accumulators alive:
           the MMA loop with its B stream and the halo staging;
  no_mma   the wgmma instructions removed: the B stream, the halo staging
           and the epilogue on zero accumulators;
  stream   both cut: the TMA ring and the halo staging alone.
The copies' outputs are wrong and are never read. Each kernel is timed
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
BUILDS = ("full", "no_epi", "no_mma", "stream")
KERNELS = ("K1", "K3", "T1", "T2")
KEEP_ALIVE = """    {  // keeps the accumulators alive
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 128; ++i) x += acc[i];
      if (x == 12345.f) z[tid] = __float2bfloat16(x);
    }
"""


def variant(src: str, build: str) -> str:
    """The source with ``build``'s stages cut out."""
    if build in ("no_epi", "stream"):
        a = src.index("    // epilogue begin")
        b = src.index("    // epilogue end")
        src = src[:a] + KEEP_ALIVE + src[b:]
    if build in ("no_mma", "stream"):
        src, n = re.subn(r"\n[^\n]*wgmma_m64n256k16_ss\(acc[^\n]*", "", src)
        assert n == 1, n
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CONV_KERNELS, _ptxas_summary
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import fused_head as fh

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    builds = _build.build_variants("fused_head.cu", BUILDS, variant,
                                   os.path.join(ROOT, "build", "torch_kernels", "stages"))
    libs = {}
    for name, (so, log) in builds.items():
        summary = _ptxas_summary(log)
        print(f"{name}: " + "; ".join(f"{k} {summary[k]['regs']} regs, spills "
                                      f"{summary[k]['spill_stores']}/{summary[k]['spill_loads']} B"
                                      for k in CONV_KERNELS))
        libs[name] = _build.bind(ctypes.CDLL(so))

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    h, w = H // 4, W // 4
    th, tw = fh.K1_TILE
    N, T = 16 * COUT, -(-h // th) * -(-w // tw)

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    # the wrappers' operands, and B in the K-major layout they hand the kernels
    tp, kph = g(B, h + 2, w + 2, CIN).to(bf), g(9, CIN, N, scale=0.03).to(bf)
    pat, wm, b2b, b2 = g(B, h, w, KP).to(bf), g(B, KP, N, scale=0.03).to(bf), g(B, N), g(N)
    kph_t, wm_t = fh.k_major(kph), fh.k_major(wm)
    zfull, zph = g(B, H, W, COUT).to(bf), g(B, h, w, N).to(bf)
    z = torch.empty((B, h, w, N), dtype=bf, device=dev)
    ps, pq = torch.empty((B, T, N), device=dev), torch.empty((B, T, N), device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731

    def launch(lib, kernel):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if kernel == "K1":
            rc = lib.posfeat_conv_phase(ptr(tp), ptr(kph_t), ptr(pat), ptr(wm_t), ptr(b2b), ptr(z),
                                        ptr(ps), ptr(pq), B, h, w, CIN, KP, N, th, tw, stream)
        else:
            layout = next(lay for lay, k in fh.IMG_KERNELS.items() if k == kernel)
            img = {"full": zfull, "none": None, "phase": zph}[layout]
            rc = lib.posfeat_conv_phase_img(ptr(tp), ptr(kph_t), ptr(img), ptr(b2), ptr(z), ptr(ps), ptr(pq),
                                            B, h, w, CIN, N, COUT, fh.IMG_LAYOUTS.index(layout), th, tw,
                                            stream)
        if rc:
            raise RuntimeError(f"{kernel}: {lib.posfeat_error_string(rc).decode()}")

    ms = {name: {k: [] for k in KERNELS} for name in BUILDS}
    for order in (BUILDS, BUILDS[::-1]):
        for name in order:
            for k in KERNELS:
                ms[name][k].append(_time_ms(lambda: launch(libs[name], k)))
            print(f"{name}: " + ", ".join(f"{k} {ms[name][k][-1]:.4f} ms" for k in KERNELS), flush=True)
    print(smi)
    print(json.dumps({"ms": ms, "device": torch.cuda.get_device_name(0), "power_limit": smi.split(", ")[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
