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
  and the normalized input times (1 + 1e-6 · N(0, 1));
- the decoder's blocks, banded against unsharded: the elements of each
  block's output that differ; with ``--decoder-tf32 off`` the decoder's
  f32-accumulated convs of bf16 values (the concat-free skip iconvs, the
  ``desc_tail`` ladder) keep TF32 off, which shows whether cuDNN's choice
  of a TF32 algorithm by map height is where the banded maps part;
- the head's instance norms, banded on the unsharded maps against the
  unsharded head, with their moments summed in each of these orders
  (``--in-orders``): "shipped" (both programs' own: each row's f32 sums,
  ``ops/moments.py``, the rows' partials concatenated and summed once),
  "bands" (the unsharded norm's one f32 sum a moment, each band's such
  sums added on the first device: the former banded order), "gathered" (one f32 sum over the
  bands concatenated there: the unsharded order), "rows" (both programs
  sum each row in f32, then the rows' sums in one f32 sum) and "f64"
  (both programs sum in f64). For each norm: whether its input is the
  unsharded one (an exact integer fingerprint of its bits) and how many
  channels' mean and rsqrt(var + eps) differ; then the score elements
  that differ and each slate's |Δvalid|, under the exact and the packed
  top-k (``--topk``);
- every conv of the backbone and the head on shared inputs:
  each ``F.conv2d`` call of the unsharded forward is run again as the
  banded program runs it (each band of its output rows through one call
  on the rows it reads, zero rows beyond the map's edges) on that call's
  own input, and the elements of the output that differ are counted, so
  each conv whose arithmetic depends on the map's height shows on equal
  inputs; the calls are named by module (the encoder's and the decoder's
  blocks) or by their place in the head.

Prints one line per measurement, then the card's name and power limit.
"""

import argparse
import contextlib
import copy
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


_LABEL = {"name": "?", "n": 0}  # the block that runs, for ``_conv_walk``'s names


@contextlib.contextmanager
def _recording_decoder(torch, steps):
    """``run_decoder`` for the unsharded and the banded backbone, keeping
    each block's output in ``steps`` (until it is cleared) and naming the
    block that runs for ``_conv_walk``."""
    from posfeat_tpu_torch.models import resunet as rn
    from posfeat_tpu_torch.parallel import banded_models as bm

    shipped = rn.run_decoder

    def run(ops, nets, maps, plan):
        names = [f"decoder {step.name}" for step in plan]
        _LABEL["name"], _LABEL["n"] = names[0], 0

        def after_step(step, y):
            i = plan.index(step)
            _LABEL["name"], _LABEL["n"] = names[min(i + 1, len(names) - 1)], 0
            if steps:
                steps["unsharded" if ops is rn.DenseOps else "banded"].append((step.name, y))

        return shipped(ops, nets, maps, plan, after_step)

    rn.run_decoder = bm.run_decoder = run
    try:
        yield
    finally:
        rn.run_decoder = bm.run_decoder = shipped


@contextlib.contextmanager
def _conv_walk(torch, model, height, starts, rows):
    """Every ``F.conv2d`` call while active is also run as the banded
    program runs it, over the bands whose first image rows are ``starts``
    (of ``height``), on the call's own input; appends (name, call, elements
    that differ, elements) to ``rows``. A call that is one of several row
    tiles (``row_tiled_conv``) is the banded program's own call where the
    bands lie on tile boundaries; it is listed with None for the count.
    Names come from forward pre-hooks on the backbone's blocks and the
    head's modules."""
    import torch.nn.functional as F

    from posfeat_tpu_torch.models import resunet as rn
    from posfeat_tpu_torch.ops import conv_tiles

    shipped, shipped_tiled = F.conv2d, conv_tiles.row_tiled_conv
    label = _LABEL
    hooks = []

    def row_tiled_conv(x, weight, bias, stride, padding, dilation, tile=None, *args):
        label["tiles"] = tile is not None and x.shape[2] > tile
        try:
            return shipped_tiled(x, weight, bias, stride, padding, dilation, tile, *args)
        finally:
            label["tiles"] = False

    for name, mod in model.named_modules():
        if isinstance(mod, (rn.Conv2d, rn.ConvBNElu, rn.UpConv)) or name == "localheader":
            def pre(_m, _a, name=name):
                label["name"], label["n"] = name, 0
            hooks.append(mod.register_forward_pre_hook(pre))

    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = shipped(x, w, b, stride, padding, dilation, groups)
        (sh, sw), (ph, pw), (dh, dw) = pair(stride), pair(padding), pair(dilation)
        kh, H_in, H_out = w.shape[2], x.shape[2], y.shape[2]
        name = f"{label['name']}#{label['n']}" if label["n"] else label["name"]
        if label.get("tiles"):
            label["n"] += 1
            rows.append((name, f"{tuple(x.shape)} {str(x.dtype)[6:]} * {tuple(w.shape)}, a row tile", None,
                         y.numel()))
            return y
        if x.shape[0] != 1 or height % H_out or isinstance(padding, str):
            return y
        f = height // H_out
        outs = [a // f for a in starts] + [H_out]
        parts = []
        xh = x.permute(0, 2, 3, 1)  # the NHWC rows the banded program holds
        for o0, o1 in zip(outs[:-1], outs[1:]):
            lo, hi = o0 * sh - ph, (o1 - 1) * sh - ph + (kh - 1) * dh + 1
            pieces = []
            if lo < 0:
                pieces.append(xh.new_zeros((1, -lo) + tuple(xh.shape[2:])))
            pieces.append(xh[:, max(lo, 0) : min(hi, H_in)])
            if hi > H_in:
                pieces.append(xh.new_zeros((1, hi - H_in) + tuple(xh.shape[2:])))
            e = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
            parts.append(shipped(e.permute(0, 3, 1, 2), w, b, (sh, sw), (0, pw), (dh, dw), groups))
        banded = torch.cat(parts, dim=2)
        label["n"] += 1
        call = (f"{tuple(x.shape)} {str(x.dtype)[6:]} * {tuple(w.shape)}, stride {sh}, pad {ph}, "
                f"TF32 {'on' if torch.backends.cudnn.allow_tf32 and x.dtype == torch.float32 else 'off'}")
        rows.append((name, call, int((banded != y).sum()), y.numel()))
        return y

    F.conv2d, conv_tiles.row_tiled_conv = conv2d, row_tiled_conv
    try:
        yield
    finally:
        F.conv2d, conv_tiles.row_tiled_conv = shipped, shipped_tiled
        for h in hooks:
            h.remove()


def _fingerprint(torch, x):
    """The exact sum of x's f32 bit patterns as integers: equal inputs give
    equal fingerprints, in any summation order."""
    return int(x.float().contiguous().view(torch.int32).sum(dtype=torch.int64))


def _moments(torch, parts, dims, order):
    """Σx and Σx² over ``dims`` of the row-split ``parts`` (one part: the
    unsharded map), summed in ``order``, and the count n; f32 sums, f64 for
    "f64", on the first part's device."""
    from posfeat_tpu_torch.ops import moments as mo

    dev = parts[0].device
    n = sum(int(np.prod([p.shape[d] for d in dims])) for p in parts)
    if order == "shipped":
        rows = [mo.row_moments(p) for p in parts]
        shape = (parts[0].shape[0],) + (1,) * (parts[0].ndim - 2) + (parts[0].shape[-1],)
        s1, s2 = (torch.cat([r[i].to(dev) for r in rows], dim=1).sum(dim=1).reshape(shape) for i in (0, 1))
        return s1, s2, n
    xf = [p.float() for p in parts]
    if order == "gathered":
        x = torch.cat([p.to(dev) for p in xf], dim=1)
        return x.sum(dim=dims, keepdim=True), (x * x).sum(dim=dims, keepdim=True), n
    if order == "rows":
        inner = tuple(d for d in dims if d != 1)
        rows = lambda f: torch.cat([f(p).sum(dim=inner, keepdim=True).to(dev) for p in xf], dim=1)  # noqa: E731
        return rows(lambda p: p).sum(dim=1, keepdim=True), rows(lambda p: p * p).sum(dim=1, keepdim=True), n
    acc = torch.float64 if order == "f64" else torch.float32
    s1 = sum(p.to(acc).sum(dim=dims, keepdim=True).to(dev) for p in xf)
    s2 = sum((p * p).to(acc).sum(dim=dims, keepdim=True).to(dev) for p in xf)
    return s1, s2, n


def _in_orders(torch, order, run_head, run_bhead, slate, topks, label):
    """The unsharded head (``run_head``) and the banded head on the same
    maps (``run_bhead``) with both programs' instance norms summing their
    moments in ``order``; prints, for each norm in call
    order, whether its input is the unsharded one and how many channels'
    mean and rstd differ, then the score map's differing elements and the
    slates' |Δvalid| under each top-k."""
    from posfeat_tpu_torch.models import keypoint_det as kd
    from posfeat_tpu_torch.parallel import banded_ops as bo

    seen = {"unsharded": [], "banded": []}

    def stats(parts, dims, eps, key):
        s1, s2, n = _moments(torch, parts, dims, order)  # one part: "bands" and "gathered" are one sum
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        mean, rstd = mean.float(), torch.rsqrt(var.float() + eps)
        seen[key].append((sum(_fingerprint(torch, p) for p in parts), mean, rstd))
        return mean, rstd

    def unsharded_in(x, eps=1e-5, dims=(1, 2)):
        mean, rstd = stats([x], dims, eps, "unsharded")
        return ((x.float() - mean) * rstd).to(x.dtype)

    def banded_in(x, eps=1e-5, dims=(1, 2)):
        mean, rstd = stats(x.parts, dims, eps, "banded")
        return bo.Bands([((p.float() - mean.to(p.device)) * rstd.to(p.device)).to(p.dtype) for p in x.parts],
                        list(x.starts), x.total)

    shipped = kd.instance_norm, bo.instance_norm
    kd.instance_norm, bo.instance_norm = unsharded_in, banded_in
    try:
        head, bhead = run_head(), run_bhead()
    finally:
        kd.instance_norm, bo.instance_norm = shipped
    norms = []
    for i, ((fu, mu, ru), (fb, mb, rb)) in enumerate(zip(seen["unsharded"], seen["banded"])):
        rel = ((mb - mu).abs() / mu.abs().clamp_min(1e-30)).max().item()
        norms.append(f"IN {i}: input {'equal' if fu == fb else 'DIFFERS'}, mean differs in "
                     f"{int((mu != mb).sum())} of {mu.numel()} channels (max rel {rel:.3g}), rstd in "
                     f"{int((ru != rb).sum())}")
    assert len(seen["unsharded"]) == len(seen["banded"]), {k: len(v) for k, v in seen.items()}
    dv = []
    for topk in topks:
        got, ref = slate(bhead, topk), slate(head, topk)
        dv.append(f"{topk} |Δvalid| {abs(got[3] - ref[3])} (valid {ref[3]})")
    print(f"{label}, IN sums '{order}', banded head on the unsharded maps: " + "; ".join(norms)
          + f"; score elements differ {int((bhead != head).sum())} of {head.numel()}; " + ", ".join(dv))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--bands", type=int, default=2)
    ap.add_argument("--height", type=int, default=None, help="the frame's rows (phase 18's by default)")
    ap.add_argument("--width", type=int, default=None, help="the frame's columns (phase 18's by default)")
    ap.add_argument("--decoder-tf32", choices=("on", "off"), default="on",
                    help="off: the decoder's f32-accumulated convs of bf16 values without TF32")
    ap.add_argument("--topk", default="exact,approx", help="the detector's top-k forms, comma-separated")
    ap.add_argument("--in-orders", default="shipped,bands,gathered,rows,f64",
                    help="the instance norms' summation orders to compare, comma-separated (none: '')")
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

    topks = args.topk.split(",")

    def slate(score_map, topk="exact"):
        coord, score, valid = generate_kpts_single(score_map[..., :1], topk=topk, **c.AACHEN_DET)
        v = int(valid[0])
        n = int(max(min(c.AACHEN_DET["num_pts"], v), 128))
        px = denormalize_coords(coord, fh, fw)[0, :n].float().cpu().numpy()
        return px, score[0, :n, 0].float().cpu().numpy(), None, v

    def head_of(fm, image):
        return model.localheader(torch.cat([fm[e] for e in model.local_input_elements], dim=-1), image)

    def against(name, got, ref):
        unmatched = c._pair_slates(got, ref)[0]
        print(f"{label}, {name}: unmatched {unmatched:.6f}, valid {got[3]} (|d| {abs(got[3] - ref[3])})")

    if args.decoder_tf32 == "off":
        import contextlib

        from posfeat_tpu_torch.models import resunet as rn

        rn._bf16_operands = contextlib.nullcontext
        label += ", decoder TF32 off"
    steps = {"unsharded": [], "banded": []}
    with torch.inference_mode(), _recording_decoder(torch, steps):
        fm = model.backbone(im)
        head = head_of(fm, im)
        ref = slate(head)
        starts = spatial_mesh([card] * args.bands).plan(fh, fw)
        bands = bo.split_rows(im, [card] * args.bands, starts)
        bfm = resunet(bands, [model.backbone] * args.bands)
        for (name, dense), (_, banded) in zip(steps["unsharded"], steps["banded"]):
            diff = int((banded.concat().to(card) != dense.permute(0, 2, 3, 1)).sum())
            print(f"{label}, {args.bands} bands: decoder {name}: {diff} of {dense.numel()} elements differ")
        steps.clear()
        for key in ("global_map", "local_map", "local_map_small"):
            diff = int((bfm[key].concat() != fm[key]).sum())
            print(f"{label}, {args.bands} bands: backbone {key}: {diff} of {fm[key].numel()} elements differ")
        # the whole banded program: its head on its own backbone's bands
        b_input = bfm[model.local_input_elements[0]].map(lambda *ps: torch.cat(ps, dim=-1),
                                                        *(bfm[e] for e in model.local_input_elements[1:]))
        whole = keypoint_det(b_input, bands, [model.localheader] * args.bands).concat()
        n_map = int((bfm["local_map"].concat() != fm["local_map"]).sum())
        print(f"{label}, {args.bands} bands (first rows {starts}), the whole banded program: local_map "
              f"{'equal' if n_map == 0 else f'differs in {n_map} elements'}, score map "
              f"{'equal' if torch.equal(whole, head) else f'differs in {int((whole != head).sum())} elements'} "
              f"(torch.equal)")
        against(f"the whole {args.bands}-band program", slate(whole), ref)
        del b_input, whole
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
        del bfm, banded_fm, bhead, noisy
        rows = []
        with _conv_walk(torch, model, fh, starts, rows):
            head_of(model.backbone(im), im)
        differ = [r for r in rows if r[2]]
        tiles = [r for r in rows if r[2] is None]
        for name, call, n, total in rows:
            print(f"{label}, {args.bands} bands, conv on shared input: {name}: {call}: "
                  + ("the banded program's own call" if n is None else f"{n} of {total} elements differ"))
        print(f"{label}, {args.bands} bands, convs on shared inputs: {len(differ)} of {len(rows) - len(tiles)} "
              f"whole-map calls differ" + (f", first {differ[0][0]}" if differ else "")
              + f"; {len(tiles)} row-tile calls")
        run_head = lambda: head_of(fm, im)  # noqa: E731
        run_bhead = lambda: keypoint_det(  # noqa: E731
            bo.split_rows(local_input, [card] * args.bands, [a // 4 for a in starts]), bands,
            [model.localheader] * args.bands).concat()
        for order in filter(None, args.in_orders.split(",")):
            _in_orders(torch, order, run_head, run_bhead, slate, topks, f"{label}, {args.bands} bands")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
