"""Training CLI (reference train.py), both stages.

Usage: python -m posfeat_tpu_torch.train --config configs/train_desc.yaml  # stage 1
       python -m posfeat_tpu_torch.train --config configs/train_kp.yaml   # stage 2

Without ``--device`` the run spreads its batch over the largest count of
the visible cards that divides it, one process per card, as the JAX
trainer spreads it over its local devices (``launch.py``); ``--devices``
lists them (e.g. ``cuda:0,cuda:1``). ``--device cpu`` (or one card) trains
in this one process, as does a config with a ``multihost:`` block (one
rank of a multi-host run).
"""

import argparse

from ..core.config import load_config
from .launch import launch
from .trainer import Trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="PoSFeat training, stage 1 (descriptors) or stage 2 (keypoints) (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--overwrite", action="store_true", help="allow existing run dir")
    parser.add_argument("--device", type=str, default=None,
                        help="train in this one process on this torch device (e.g. 'cpu', 'cuda:1')")
    parser.add_argument("--devices", type=str, default=None,
                        help="comma-separated devices to spread the batch over; every visible card unless given")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    if args.device is not None or config.get("multihost"):
        Trainer(config, overwrite=args.overwrite, device=args.device).train()
    else:
        launch(config, devices=args.devices.split(",") if args.devices else None, overwrite=args.overwrite)


if __name__ == "__main__":
    main()
