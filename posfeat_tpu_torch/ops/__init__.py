"""Tensor ops of the extraction path (NHWC, like posfeat_tpu.ops)."""
