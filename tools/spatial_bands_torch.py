#!/usr/bin/env python3
"""What the band plan costs: each device's peak memory and the time of
the banded extraction program, for the port's plan (bands on the 512-row
conv tiles of ``ops/conv_tiles.py``) and for even 16-row-block bands.

    python3 tools/spatial_bands_torch.py [--height 3024 --width 4032] [--bands 4] [--dtypes bfloat16,float32]

At chip_smoke.py phase 19's point (a seeded frame, the flagship model
with random weights from seed 0, the Aachen detector; bf16 with the
"phase" head, f32 with the reference dataflow), for each dtype:

- the unsharded program on cuda:0: ms/image over ``--reps`` runs after a
  warm-up, and its peak memory;
- each plan over ``--bands`` bands, one card a band where the machine has
  that many (else all on cuda:0, where the bands run one after another):
  the first rows and rows of each band, ms/image, and the peak memory of
  each card; its slate against the unsharded one (bit for bit, or the
  unmatched share and |Δvalid|: the block bands' convs round by their
  height);
- each band of the tile plan alone, its rows through the unsharded
  program on cuda:0: ms/image and peak memory, what one card shows of a
  band's own share.

Prints one line per measurement, then the cards' name and power limit.
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
    ap.add_argument("--height", type=int, default=3024)
    ap.add_argument("--width", type=int, default=4032)
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("spatial_bands_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from posfeat_tpu_torch import resolve_device
    from posfeat_tpu_torch.models import PoSFeat
    from posfeat_tpu_torch.parallel import spatial_mesh
    from posfeat_tpu_torch.parallel.spatial import BLOCK, SpatialMesh

    class BlockMesh(SpatialMesh):
        """Bands of whole 16-row blocks, at most one block apart."""

        def plan(self, height):
            blocks = height // BLOCK
            n = min(len(self.devices), blocks)
            base, extra = divmod(blocks, n)
            return [BLOCK * (i * base + min(i, extra)) for i in range(n)]

    resolve_device("cuda")
    n_cards = torch.cuda.device_count()
    card = torch.device("cuda", 0)
    devices = ([torch.device("cuda", i) for i in range(args.bands)] if n_cards >= args.bands
               else [card] * args.bands)
    where = f"one card a band (cuda:0-{args.bands - 1})" if n_cards >= args.bands else "all on cuda:0"
    frame = c._frame(np.random.default_rng(c.SEED), args.height, args.width)
    im_u8 = torch.from_numpy(frame)[None].to(card)
    gib = lambda b: f"{b / 2**30:.2f}"  # noqa: E731
    for dt in args.dtypes.split(","):
        dtype = getattr(torch, dt)
        cfg = copy.deepcopy(c.FLAGSHIP_MODEL_CONFIG)
        cfg["localheader_config"]["fused_upsample"] = "phase" if dtype == torch.bfloat16 else False
        model = PoSFeat(cfg, dtype=dtype, device=card, seed=c.SEED)
        label = f"{args.height}x{args.width} {dt} {'phase' if dtype == torch.bfloat16 else 'reference'}"
        torch.cuda.empty_cache()
        ref, ms_ref, peak = c._timed_slate(torch, c.slice_k_program(torch, model, None), im_u8, [card], args.reps)
        print(f"{label}, unsharded on cuda:0: {ms_ref:.4f} ms/image, peak {gib(peak[0])} GiB", flush=True)
        for name, mesh in (("tile plan", spatial_mesh(devices)), ("16-row-block plan", BlockMesh(tuple(devices)))):
            starts = mesh.plan(args.height)
            rows = np.diff(starts + [args.height]).tolist()
            used = sorted(set(devices[: len(starts)]), key=str)
            torch.cuda.empty_cache()
            got, ms, peaks = c._timed_slate(torch, c.slice_k_program(torch, model, mesh), im_u8, used, args.reps)
            if got[3] == ref[3] and all(np.array_equal(g, r) for g, r in zip(got[:3], ref[:3])):
                cmp = "; the unsharded slate bit for bit"
            else:
                cmp = (f"; against the unsharded slate: unmatched {c._pair_slates(got, ref)[0]:.6f}, "
                       f"|Δvalid| {abs(got[3] - ref[3])}, non-finite keypoints {int((~np.isfinite(got[0])).sum())}")
            print(f"{label}, {name}, {len(starts)} bands {where}: first rows {starts}, rows {rows}; "
                  f"{ms:.4f} ms/image ({ms / ms_ref:.3f}x unsharded); peak GiB "
                  + ", ".join(f"{d}: {gib(p)}" for d, p in zip(used, peaks)) + cmp, flush=True)
        starts = spatial_mesh(devices).plan(args.height)
        for i, (a, b) in enumerate(zip(starts, starts[1:] + [args.height])):
            torch.cuda.empty_cache()
            _, ms, peak = c._timed_slate(torch, c.slice_k_program(torch, model, None), im_u8[:, a:b].contiguous(),
                                         [card], args.reps)
            print(f"{label}, tile plan band {i} alone (rows {a}-{b}, {b - a} rows) unsharded on cuda:0: "
                  f"{ms:.4f} ms/image, peak {gib(peak[0])} GiB", flush=True)
        del model
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("; ".join(smi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
