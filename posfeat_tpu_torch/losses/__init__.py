"""Training losses of stage 2 and the preprocess registry
(posfeat_tpu/losses/__init__.py). Stage 1's correspondence preprocess
and epipolar loss come with slice C (ROADMAP.md)."""

from .disk_loss import DiskLoss
from .preprocess import Preprocess_Skip

PREPROCESSES = {"Preprocess_Skip": Preprocess_Skip}
LOSSES = {"DiskLoss": DiskLoss}
