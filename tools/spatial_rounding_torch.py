#!/usr/bin/env python3
"""Where the banded extraction program's rounding departs from the
unsharded program's, on one CUDA card.

    python3 tools/spatial_rounding_torch.py [--dtype bfloat16|float32] [--bands 2] [--height 2048 --width 3072]

At chip_smoke.py phase 18's point (a seeded 2048x3072 frame, or another
size such as phase 19's 3024x4032; the
flagship model with random weights from seed 0, the Aachen detector:
20480 points, NMS radius 3, thr 0.5 abs), bf16 with the "phase" head or
f32 with the reference dataflow, bands on cuda:0:

- the backbone's maps, banded against unsharded: the elements that
  differ;
- the slate (trimmed to the reference's count) of the banded backbone
  under the unsharded head, and of the unsharded backbone under the
  banded head, against the unsharded program's: the share of points
  without a partner at their pixel, and |valid − valid_ref|;
- the same figures for two runs of the unsharded program that differ from
  it by rounding alone: the frame in a batch of two (bf16 only; at f32 the
  reference dataflow's x4 resize of two frames passes INT_MAX elements),
  and the normalized input times (1 + 1e-6 · N(0, 1)).

Prints one line per measurement, then the card's name and power limit.
"""

import argparse
import copy
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--bands", type=int, default=2)
    ap.add_argument("--height", type=int, default=None, help="the frame's rows (phase 18's by default)")
    ap.add_argument("--width", type=int, default=None, help="the frame's columns (phase 18's by default)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("spatial_rounding_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.data.utils import IMAGENET_MEAN, IMAGENET_STD
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.ops.coords import denormalize_coords
    from posfeat_tpu_torch.ops.detect import generate_kpts_single
    from posfeat_tpu_torch.parallel import banded_ops as bo
    from posfeat_tpu_torch.parallel import spatial_mesh
    from posfeat_tpu_torch.parallel.banded_models import keypoint_det, resunet

    resolve_device("cuda")
    card = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    fh, fw = args.height or c.SLICE_K_H, args.width or c.SLICE_K_W
    frame = c._frame(np.random.default_rng(c.SEED), fh, fw)
    mean = torch.as_tensor(IMAGENET_MEAN, device=card)
    std = torch.as_tensor(IMAGENET_STD, device=card)
    im = (torch.from_numpy(frame)[None].to(card).float() / 255.0 - mean) / std
    cfg = copy.deepcopy(c.FLAGSHIP_MODEL_CONFIG)
    cfg["localheader_config"]["fused_upsample"] = "phase" if dtype == torch.bfloat16 else False
    model = PoSFeat(cfg, dtype=dtype, device=card, seed=c.SEED)
    label = f"{args.dtype} {'phase' if dtype == torch.bfloat16 else 'reference'}"

    def slate(score_map):
        coord, score, valid = generate_kpts_single(score_map[..., :1], **c.AACHEN_DET)
        v = int(valid[0])
        n = int(max(min(c.AACHEN_DET["num_pts"], v), 128))
        px = denormalize_coords(coord, fh, fw)[0, :n].float().cpu().numpy()
        return px, score[0, :n, 0].float().cpu().numpy(), None, v

    def head_of(fm, image):
        return model.localheader(torch.cat([fm[e] for e in model.local_input_elements], dim=-1), image)

    def against(name, got, ref):
        unmatched = c._pair_slates(got, ref)[0]
        print(f"{label}, {name}: unmatched {unmatched:.6f}, valid {got[3]} (|d| {abs(got[3] - ref[3])})")

    with torch.inference_mode():
        fm = model.backbone(im)
        head = head_of(fm, im)
        ref = slate(head)
        starts = spatial_mesh([card] * args.bands).plan(fh)
        bands = bo.split_rows(im, [card] * args.bands, starts)
        bfm = resunet(bands, [model.backbone] * args.bands)
        for key in ("global_map", "local_map", "local_map_small"):
            diff = int((bfm[key].concat() != fm[key]).sum())
            print(f"{label}, {args.bands} bands: backbone {key}: {diff} of {fm[key].numel()} elements differ")
        banded_fm = {k: bfm[k].concat() for k in model.local_input_elements}
        against(f"{args.bands}-band backbone, unsharded head", slate(head_of(banded_fm, im)), ref)
        local_input = torch.cat([fm[e] for e in model.local_input_elements], dim=-1)
        bhead = keypoint_det(bo.split_rows(local_input, [card] * args.bands, [a // 4 for a in starts]), bands,
                             [model.localheader] * args.bands).concat()
        print(f"{label}, {args.bands}-band head on the unsharded maps: {int((bhead != head).sum())} of "
              f"{head.numel()} score elements differ")
        against(f"unsharded backbone, {args.bands}-band head", slate(bhead), ref)
        if dtype == torch.bfloat16:
            two = torch.cat([im, im])
            against("unsharded, the frame in a batch of two", slate(head_of(model.backbone(two), two)[:1]), ref)
        g = torch.Generator(device=card).manual_seed(1)
        noisy = im * (1 + 1e-6 * torch.randn(im.shape, generator=g, device=card))
        against("unsharded, input x (1 + 1e-6 noise)", slate(head_of(model.backbone(noisy), noisy)), ref)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
