"""Model zoo: descriptor backbone and keypoint head (torch, NHWC at the
public forward)."""

from .keypoint_det import KeypointDet
from .posfeat import BACKBONES, HEADS, MODELS, PoSFeat, init_parameters
from .resunet import ResUNet

__all__ = ["BACKBONES", "HEADS", "MODELS", "KeypointDet", "PoSFeat", "ResUNet", "init_parameters"]
