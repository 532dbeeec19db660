"""Host-side extraction datasets (numpy + OpenCV)."""

from .extraction import Aachen_Day_Night, ETH_LFB, HPatch_SIFT

DATASETS = {
    "HPatch_SIFT": HPatch_SIFT,
    "Aachen_Day_Night": Aachen_Day_Night,
    "ETH_LFB": ETH_LFB,
}
