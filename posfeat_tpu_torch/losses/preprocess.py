"""Stage-2 preprocess (posfeat_tpu/losses/preprocess.py:231-243)."""


class Preprocess_Skip:
    """No-op preprocess for stage 2 (reference preprocess.py:120-129)."""

    __lossname__ = "Preprocess_Skip"

    def __init__(self, configs=None, **kwargs):
        pass

    def name(self):
        return self.__lossname__

    def __call__(self, inputs, outputs, generator=None):
        return None
