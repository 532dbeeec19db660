"""Host-side datasets: extraction image sets (numpy + OpenCV where an
image is read), MegaDepth training pairs (numpy + OpenCV) and synthetic
training pairs (numpy + scipy)."""

from .extraction import Aachen_Day_Night, ETH_LFB, HPatch_SIFT
from .megadepth import MegaDepth_SIFT
from .synthetic import SyntheticPairs

DATASETS = {
    "HPatch_SIFT": HPatch_SIFT,
    "Aachen_Day_Night": Aachen_Day_Night,
    "ETH_LFB": ETH_LFB,
    "MegaDepth_SIFT": MegaDepth_SIFT,
    "SyntheticPairs": SyntheticPairs,
}
