"""posfeat_tpu_torch's colour tables (``data/utils.py`` ``COLORMAPS``, the
port's stand-in for matplotlib in the training dumps) against matplotlib
itself, where it is installed: each table's 256 entries, a colouring of
values across [0, 1] (the bins and the end points), and ``tensor2array``
against the JAX package's, which colours through matplotlib. The tables
are matplotlib's ``LinearSegmentedColormap`` built from the same control
points, so they agree to the last bits of f64: held at 1e-12. The dumps'
f32 output is held bit for bit."""

import numpy as np
import pytest

from posfeat_tpu_torch.data import utils as tu

matplotlib = pytest.importorskip("matplotlib")

NAMES = sorted(tu.COLORMAPS)


@pytest.mark.parametrize("name", NAMES)
def test_table_is_matplotlibs(name):
    cmap = matplotlib.colormaps[name]
    assert cmap.N == len(tu.COLORMAPS[name]) == 256
    np.testing.assert_allclose(tu.COLORMAPS[name], cmap(np.arange(cmap.N)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_colouring_is_matplotlibs(name):
    x = np.concatenate([np.linspace(0.0, 1.0, 10001), np.arange(257) / 256, [-0.5, 1.5, 1.0 - 1e-12]])
    np.testing.assert_allclose(tu.apply_colormap(x, name), matplotlib.colormaps[name](np.clip(x, 0, 1)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_tensor2array_is_the_jax_packages(name):
    from posfeat_tpu.data.utils import tensor2array as jax_tensor2array

    arr = np.random.RandomState(3).rand(24, 32).astype(np.float32) * 2.0
    for max_value in (None, 1.0, 3.0):
        got = tu.tensor2array(arr, max_value, name)
        assert got.dtype == np.float32 and got.shape == (3, 24, 32)
        np.testing.assert_array_equal(got, jax_tensor2array(arr, max_value, name))
