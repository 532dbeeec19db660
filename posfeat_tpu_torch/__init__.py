"""PyTorch + CUDA port of posfeat_tpu for one NVIDIA H100.

The JAX package ``posfeat_tpu`` stays the reference; this package mirrors
its module names (``ops/detect.py`` here is the counterpart of
``posfeat_tpu/ops/detect.py``) and keeps its public layouts (NHWC maps,
``[B, N, 2]`` normalized coordinates) so each piece can be held against
its JAX twin. The TPU's Pallas kernels become hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .core.device import resolve_device

__all__ = ["resolve_device"]
