"""Feature-extraction CLI (reference extract.py).

Usage: python -m posfeat_tpu_torch.extract --config configs/extract_hpatches.yaml
"""

import argparse

from .extractor import Extractor


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="PoSFeat feature extraction (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the CUDA card unless given (e.g. 'cpu')")
    args = parser.parse_args(argv)
    Extractor(args.config, device=args.device).extract()


if __name__ == "__main__":
    main()
