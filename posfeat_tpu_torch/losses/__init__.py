"""Training losses and the preprocess registry
(posfeat_tpu/losses/__init__.py): stage 1's Line2Window preprocess and
epipolar loss, stage 2's DiskLoss."""

from .disk_loss import DiskLoss
from .epipolar_loss import EpipolarLoss_full
from .preprocess import Preprocess_Line2Window, Preprocess_Skip

PREPROCESSES = {
    "Preprocess_Line2Window": Preprocess_Line2Window,
    "Preprocess_Skip": Preprocess_Skip,
}
LOSSES = {
    "EpipolarLoss_full": EpipolarLoss_full,
    "DiskLoss": DiskLoss,
}
