"""Training of both stages: ``Trainer``, ``launch.launch`` (over every
local device, one process each) and the CLI
``python -m posfeat_tpu_torch.train --config <yaml>``."""

from .trainer import Trainer

__all__ = ["Trainer"]
