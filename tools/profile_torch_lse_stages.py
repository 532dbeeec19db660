#!/usr/bin/env python3
"""Split the time of posfeat_tpu_torch's lse pass (K4+K5, lse_pass_kernel
in csrc/reinforce.cu) into its stages on one CUDA card, by timing copies
of the source with a stage cut out, at the training path's shapes (B=6,
m=n=4800, D=128, T=60).

    python3 tools/profile_torch_lse_stages.py

Builds, each from a copy of csrc/reinforce.cu:
  full      the source as it is;
  no_epi    the epilogue (between its "epilogue begin" and "epilogue end"
            comments) replaced by the last adds and a sum that keeps the
            accumulators alive: the wgmmas, their adds and the f2 staging;
  no_stage  the f2 staging (between "staging begin" and "staging end": the
            ring's bulk copies and the waits for them) removed as well:
            the wgmmas and their adds on a ring that is never refilled.
The copies' outputs are wrong and are never read. The kernel is timed
through its wrapper with chip_smoke.py's timer (CUDA events around 20
launches after 3) in the order full, no_epi, no_stage, then once more in
reverse. Prints ptxas' registers and spills per build and a last JSON line
{"ms": {build: [ms, ms]}, "device": ..., "power_limit": ...}. Without a
CUDA card it exits 2 and prints no result.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _ptxas_summary, _time_ms, _unit  # noqa: E402

B, M, D, T = 6, 4800, 128, 60.0
BUILDS = ("full", "no_epi", "no_stage")
KEEP_ALIVE = """    if (c == nck - 1) {  // keeps the accumulators alive
      wgmma_wait<0>();
      add(d0);
      if (nks == 2 || c > 0) add(d1);
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) x += acc[i];
      if (x == 12345.f) col_max[tid] = x;
    }
"""


def cut(src: str, stage: str, keep: str = "") -> str:
    a = src.index(f"    // {stage} begin")
    b = src.index(f"    // {stage} end")
    return src[:a] + keep + src[b:]


def variant(src: str, build: str) -> str:
    """The source with ``build``'s stages cut out."""
    if build in ("no_epi", "no_stage"):
        src = cut(src, "epilogue", KEEP_ALIVE)
    if build == "no_stage":
        src = cut(src, "staging")
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.ops import _build
    from posfeat_tpu_torch.ops import reinforce as rf

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {}
    for name, (so, log) in _build.build_variants(
            "reinforce.cu", BUILDS, variant, os.path.join(ROOT, "build", "torch_kernels", "lse_stages")).items():
        k = _ptxas_summary(log)["lse_pass_kernel"]
        print(f"{name}: lse_pass_kernel {k['regs']} regs, spills {k['spill_stores']}/{k['spill_loads']} B")
        libs[name] = _build.bind(ctypes.CDLL(so))

    # chip_smoke.phase_reduction's descriptors: unit f1, f2 noisy copies of permuted f1 rows
    rng = np.random.default_rng(0)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)  # noqa: E731
    f1 = _unit(torch, g(B, M, D))
    perm = torch.from_numpy(rng.permutation(M)).to(dev)
    f2 = _unit(torch, f1[:, perm] + 0.15 * g(B, M, D)).contiguous()
    ms = {}
    for order in (BUILDS, BUILDS[::-1]):
        for name in order:
            _build.load_kernels = lambda lib=libs[name]: lib  # the wrapper loads its library per call
            ms.setdefault(name, []).append(_time_ms(lambda: rf.lse_pass(f1, f2, T)))
    for name in BUILDS:
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in ms[name])} ms per B={B} launch")
    print(smi)
    print(json.dumps({"ms": ms, "device": torch.cuda.get_device_name(0), "power_limit": smi.split(", ")[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
