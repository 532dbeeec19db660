"""Training CLI (reference train.py), both stages.

Usage: python -m posfeat_tpu_torch.train --config configs/train_desc.yaml [--device cpu]  # stage 1
       python -m posfeat_tpu_torch.train --config configs/train_kp.yaml [--device cpu]    # stage 2
"""

import argparse

from .trainer import Trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="PoSFeat training, stage 1 (descriptors) or stage 2 (keypoints) (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--overwrite", action="store_true", help="allow existing run dir")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the CUDA card unless given (e.g. 'cpu')")
    args = parser.parse_args(argv)
    Trainer(args.config, overwrite=args.overwrite, device=args.device).train()


if __name__ == "__main__":
    main()
