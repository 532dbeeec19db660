#!/usr/bin/env python3
"""One-command HPatches parity acceptance of posfeat_tpu_torch: the port's
counterpart of tools/acceptance.py.

Given an HPatches sequences directory and a reference PoSFeat run dir
(an epoch directory holding ``backbone.pth`` and ``localheader.pth``, the
run's ``config.yaml`` one directory up), it runs the parity chain in one
shot:

  1. the weights: the port loads the reference's ``.pth`` files as they
     are, so there is no import step; a directory without both files
     (a JAX msgpack checkpoint among them) exits non-zero before any
     extraction;
  2. HPatches feature extraction at configs/extract_hpatches.yaml's
     operating point (8192 points, SIFT off), resumed where its features
     are already written;
  3. MMA evaluation against a published error cache such as
     PoSFeat_CVPR.npy (reference evaluation.py:140-179): PASS when MMA@3
     is at most ``--bar`` (0.005) below the cache's.

Usage (extraction and matching on the card unless ``--device cpu``):

    python3 tools/acceptance_torch.py --hpatches DIR --weights RUN_DIR/EPOCH \\
        [--ref_cache PoSFeat_CVPR.npy] [--work ./acceptance_run] [--bar 0.005] \\
        [--fast] [--batch_size 16] [--device cpu]

``--fast`` extracts at ``compute_dtype: bfloat16``, which on the card
takes the fused head and the lite gate set (``extract/extractor.py``
``resolve_fast_gates``). It prints the JSON line of tools/acceptance.py
(``mma3``, ``mma_score``, ``bar``, ``fast``, ``ref_mma3``, ``delta_mma3``,
``passed``) and exits 0 on PASS or without a cache, 2 on FAIL.
``--ref_cache`` has no default: without it the tool reports absolute
numbers only.
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "extract_hpatches.yaml")
WEIGHTS = ("backbone.pth", "localheader.pth")


def check_weights(ckpt_dir):
    """Exits with a message unless ``ckpt_dir`` holds both ``.pth`` files
    of a reference run: the Extractor would otherwise keep random weights
    for a missing module."""
    missing = [f for f in WEIGHTS if not os.path.isfile(os.path.join(ckpt_dir, f))]
    if not missing:
        return
    if glob.glob(os.path.join(ckpt_dir, "*.msgpack")):
        sys.exit(f"{ckpt_dir}: a JAX msgpack checkpoint; the port loads the reference's {' and '.join(WEIGHTS)} "
                 "(posfeat_tpu_torch.core.jax_weights.from_jax_variables converts JAX variables)")
    sys.exit(f"{ckpt_dir}: {' and '.join(missing)} not found")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hpatches", required=True, help="hpatches-sequences-release directory")
    p.add_argument("--weights", required=True, help="reference run's epoch dir (backbone.pth, localheader.pth)")
    p.add_argument("--ref_cache", default=None, help="published reference error cache to compare against")
    p.add_argument("--work", default="./acceptance_run")
    p.add_argument("--bar", type=float, default=0.005, help="allowed MMA@3 deficit vs the reference cache")
    p.add_argument("--fast", action="store_true", help="extract in bf16 (the card's fused head and lite gates)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    from posfeat_tpu_torch.core.config import load_config
    from posfeat_tpu_torch.evals import hpatches as hp
    from posfeat_tpu_torch.extract import Extractor

    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)

    # ---- 1. weights -----------------------------------------------------
    ckpt_dir = os.path.abspath(args.weights)
    check_weights(ckpt_dir)
    print(f"[acceptance] using torch checkpoint {ckpt_dir}")

    # ---- 2. extraction --------------------------------------------------
    cfg = load_config(CONFIG)
    method = cfg["postfix"]
    cfg["load_path"] = ckpt_dir
    cfg["output_root"] = "hpatches_acceptance"
    cfg["resume"] = True
    cfg["data_config_extract"]["data_path"] = args.hpatches
    cfg["data_config_extract"]["batch_size"] = args.batch_size
    if args.fast:
        cfg["compute_dtype"] = "bfloat16"

    extractor = Extractor(cfg, ckpt_root=work, device=args.device)
    features_path = extractor.desc_root
    n_seqs = len([d for d in os.listdir(args.hpatches) if os.path.isdir(os.path.join(args.hpatches, d))])
    done = os.path.isdir(features_path) and len(
        glob.glob(os.path.join(features_path, "*", f"*.{method}"))) >= 6 * n_seqs
    if done:
        print(f"[acceptance] features already extracted in {features_path}")
    else:
        extractor.extract()

    # ---- 3. evaluation vs reference cache -------------------------------
    cache_dir = os.path.join(work, "eval_cache")
    errors = hp.evaluate_method(args.hpatches, features_path, method, cache_dir=cache_dir,
                                device=extractor.device)
    ours3 = hp.mma_at(errors, 3)[0]
    ours_score = hp.mma_score(errors)[0]
    print(hp.summary_line("PoSFeat_tpu_torch", errors))

    result = {"mma3": round(float(ours3), 4), "mma_score": round(float(ours_score), 4), "bar": args.bar,
              "fast": bool(args.fast)}
    if args.ref_cache and os.path.exists(args.ref_cache):
        ref = hp.load_reference_cache(args.ref_cache)
        ref3 = hp.mma_at(ref, 3)[0]
        print(hp.summary_line("PoSFeat_CVPR (cache)", ref))
        delta = float(ours3 - ref3)
        ok = delta >= -args.bar
        result.update(ref_mma3=round(float(ref3), 4), delta_mma3=round(delta, 4), passed=ok)
        print(json.dumps(result))
        print(f"[acceptance] MMA@3 {ours3:.4f} vs reference {ref3:.4f} (delta {delta:+.4f}, bar -{args.bar}) -> "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 2
    result.update(ref_mma3=None, passed=None)
    print(json.dumps(result))
    print(f"[acceptance] reference cache {args.ref_cache} not found — reporting absolute numbers only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
