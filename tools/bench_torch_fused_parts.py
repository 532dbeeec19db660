#!/usr/bin/env python3
"""Per-stage timing of posfeat_tpu_torch's fused head on one CUDA card:
the port's twin of tools/bench_fused_parts.py, at its point (B=16, bf16,
480x640 so h=120, w=160, Cin 192, Cout 128, out_ch 1), on inputs drawn
from a seed.

    python3 tools/bench_torch_fused_parts.py [STAGE ...]   # default: all stages

Stages:
  K1       conv_phase, the v3 conv kernel (patches + composite weights)
  K1V1     K3: conv_phase_img, full-res z_img reordered to phase layout
  K1NOZ    T1: conv_phase_img without an image term
  K1PRE    T2: conv_phase_img with z_img already in phase layout
  K2       T3: head_tail, the tail kernel, on a seeded z
  FULL_V3  fused_head_tail, mode v3
  FULL_V1  fused_head_tail, mode v1 (cuDNN's full-res image conv + K3)
Each stage is timed with chip_smoke.py's timer (CUDA events around 20
calls after 3), as chip_smoke.py times the same kernels. One line per stage gives ms per B=16 call and ms per image; the last
line is one JSON object {"ms_per_img": {stage: ms}, "device": ...,
"power_limit": ...}. Without a CUDA card it exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _time_ms  # noqa: E402

B, H, W, CIN, COUT, OUT_CH, CY = 16, 480, 640, 192, 128, 1, 64
STAGES = ("K1", "K1V1", "K1NOZ", "K1PRE", "K2", "FULL_V3", "FULL_V1")


def make_inputs(torch, seed=0, device="cuda"):
    """Seeded operands of every stage, bf16 where the head is."""
    from posfeat_tpu_torch.ops.phase import _edge_pad1, _phase_kernel

    rng = np.random.default_rng(seed)
    dev, bf = torch.device(device), torch.bfloat16
    h, w, kk = H // 4, W // 4, 16
    N = kk * COUT

    def g(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    trunk = g(B, h, w, CIN).to(bf)
    img_s = g(B, H, W, 3).to(bf)
    k1i, b1i = g(3, 3, 3, CY, scale=0.2), torch.zeros(CY, device=dev)
    y_img = torch.nn.functional.conv2d(
        img_s.permute(0, 3, 1, 2), k1i.to(bf).permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1).contiguous()
    head = dict(
        k1_img=k1i, b1_img=b1i, k2_trunk=g(3, 3, CIN, COUT, scale=0.05),
        k2_img=g(3, 3, CY, COUT, scale=0.05), b2=g(COUT, scale=0.05),
        w3=g(1, 1, COUT, OUT_CH, scale=0.05), b3=torch.zeros(OUT_CH, device=dev),
        prelu_a=torch.tensor([0.25], device=dev), act="Softplus",
    )
    kph = _phase_kernel(head["k2_trunk"]).reshape(9, CIN, N).to(bf).contiguous()
    return {
        "trunk": trunk, "img_s": img_s, "y_img": y_img, "head": head,
        "tp": _edge_pad1(trunk).contiguous(), "kph": kph,
        "pat": g(B, h, w, 192).to(bf), "wm": g(B, 192, N, scale=0.05).to(bf),
        "b2b": g(B, N, scale=0.05), "b2ph": head["b2"].repeat(kk).contiguous(),
        "z_img": g(B, H, W, COUT).to(bf), "z_img_ph": g(B, h, w, N).to(bf),
        "z": g(B, h, w, N).to(bf), "mu": torch.zeros(B, COUT, device=dev),
        "sc": torch.ones(B, COUT, device=dev),
    }


def stage_fns(inp):
    """{stage: a call that runs it once on ``inp``}."""
    from posfeat_tpu_torch.ops import fused_head as fh

    tp, kph, hd = inp["tp"], inp["kph"], inp["head"]
    w3 = hd["w3"].reshape(COUT, OUT_CH).contiguous()
    return {
        "K1": lambda: fh.conv_phase(tp, kph, inp["pat"], inp["wm"], inp["b2b"]),
        "K1V1": lambda: fh.conv_phase_img(tp, kph, inp["z_img"], inp["b2ph"], "full"),
        "K1NOZ": lambda: fh.conv_phase_img(tp, kph, None, inp["b2ph"], "none"),
        "K1PRE": lambda: fh.conv_phase_img(tp, kph, inp["z_img_ph"], inp["b2ph"], "phase"),
        "K2": lambda: fh.head_tail(inp["z"], inp["mu"], inp["sc"], hd["prelu_a"], w3, hd["b3"]),
        "FULL_V3": lambda: fh.fused_head_tail(inp["trunk"], inp["img_s"], inp["y_img"], **hd),
        "FULL_V1": lambda: fh.fused_head_tail(
            inp["trunk"], inp["img_s"], inp["y_img"], **hd, mode="v1"
        ),
    }


def run(torch, stages=STAGES, seed=0):
    """{stage: ms per image} on the card; prints one line per stage."""
    fns = stage_fns(make_inputs(torch, seed))
    out = {}
    for name in stages:
        ms = _time_ms(fns[name])
        out[name] = ms / B
        print(f"{name}: {ms:.4f} ms per B={B} call, {ms / B:.4f} ms/img", flush=True)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_fused_parts: no CUDA device", file=sys.stderr)
        return 2
    stages = argv or list(STAGES)
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        print(f"unknown stages {unknown}; choose from {list(STAGES)}", file=sys.stderr)
        return 2
    from posfeat_tpu_torch import resolve_device

    resolve_device("cuda")  # f32 work on the card stays out of TF32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (p.strip() for p in smi.rsplit(",", 1))
    print(f"device: {smi}; B={B} {H}x{W} Cin={CIN} Cout={COUT} out_ch={OUT_CH} bf16")
    res = run(torch, stages)
    print(json.dumps({"ms_per_img": res, "device": name, "power_limit": limit}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
