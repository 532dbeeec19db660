"""Feature extraction: ``Extractor`` and the CLI
``python -m posfeat_tpu_torch.extract --config <yaml>``."""

from .extractor import Extractor

__all__ = ["Extractor"]
