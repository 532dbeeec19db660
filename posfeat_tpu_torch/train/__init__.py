"""Stage-2 detector training: ``Trainer`` and the CLI
``python -m posfeat_tpu_torch.train --config <yaml>``."""

from .trainer import Trainer

__all__ = ["Trainer"]
