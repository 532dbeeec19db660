"""The port's weight init against flax's ``lecun_normal``, the init of
every conv kernel of the JAX package (posfeat_tpu/models/resunet.py,
keypoint_det.py): ``variance_scaling(1, "fan_in", "truncated_normal")``,
a normal truncated at ±2 of its std, the std raised by 1 / 0.87962566 so
that the variance stays 1 / fan_in.

For each conv of a small PoSFeat (ResUNet on resnet18 and the head),
with w scaled by √fan_in:
- max |w| ≤ 2 / 0.87962566 (2.27369): the truncation;
- the std within 5 standard errors of 1, the standard error of a sample
  std from n draws of this distribution being sqrt((κ − 1) / (4n)),
  κ = 2.3655 its kurtosis;
- the two-sample KS statistic against a JAX ``lecun_normal`` draw of the
  same shape under its 1% critical value, 1.6276·sqrt(2 / n).
The untruncated normal that the port drew before fails the first check.
"""

import copy

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.models import PoSFeat, init_parameters
from torch_port_helpers import SMALL_CONFIG

TRUNC_STD = 0.87962566103423978
MAX_SCALED = 2.0 / TRUNC_STD  # 2.273694...
# kurtosis of the unit normal truncated at ±2: E[x^4] / E[x^2]^2
# E[x^2] = 1 − 2aφ(a)/Z and E[x^4] = 3·E[x^2] − 2a³φ(a)/Z at a = 2, Z = Φ(2) − Φ(−2)
_PHI_Z = np.exp(-2.0) / np.sqrt(2 * np.pi) / 0.9544997361036416
_M2 = 1.0 - 4.0 * _PHI_Z
_M4 = 3.0 * _M2 - 16.0 * _PHI_Z
KURTOSIS = _M4 / _M2 ** 2
KS_C01 = 1.6276  # c(0.01) of the two-sample KS test


def _convs(seed=0):
    model = PoSFeat(copy.deepcopy(SMALL_CONFIG), device="cpu", seed=seed)
    return [(name, m.weight.detach().numpy()) for name, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d)]


def _scaled(w):
    return w.reshape(-1) * np.sqrt(w[0].size)


def test_kurtosis_constant():
    assert MAX_SCALED == pytest.approx(2.2736945, abs=1e-6)
    assert KURTOSIS == pytest.approx(2.3655, abs=1e-4)
    # the raised std keeps the variance 1: E[x^2] of the truncated unit normal
    assert _M2 == pytest.approx(TRUNC_STD ** 2, rel=1e-6)


def test_port_init_is_truncated_lecun_normal():
    import jax
    from scipy.stats import ks_2samp

    convs = _convs()
    assert len(convs) > 20
    key = jax.random.PRNGKey(0)
    for i, (name, w) in enumerate(convs):
        x = _scaled(w)
        n = x.size
        assert np.abs(x).max() <= MAX_SCALED + 1e-5, (name, np.abs(x).max())
        se = np.sqrt((KURTOSIS - 1.0) / (4.0 * n))
        assert abs(x.std() - 1.0) <= 5.0 * se, (name, x.std(), se)
        hwio = tuple(w.transpose(2, 3, 1, 0).shape)
        ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.fold_in(key, i), hwio))
        ref = ref.reshape(-1) * np.sqrt(np.prod(hwio[:3]))
        assert np.abs(ref).max() <= MAX_SCALED + 1e-5
        stat = ks_2samp(x, ref).statistic
        assert stat < KS_C01 * np.sqrt(2.0 / n), (name, stat, KS_C01 * np.sqrt(2.0 / n))


def test_untruncated_draw_exceeds_the_bound():
    """The draw the port made before: normal(0, fan_in^-½), no bound.
    Every conv of 1,000 weights or more has a weight beyond JAX's ±2.2737
    (each lies there with probability 0.023)."""
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for name, w in _convs():
        fan_in = w[0].size
        old = torch.empty(w.shape).normal_(0, fan_in ** -0.5, generator=g).numpy()
        m = np.abs(_scaled(old)).max()
        worst = max(worst, m)
        if w.size >= 1000:
            assert m > MAX_SCALED, (name, m)
    assert worst > MAX_SCALED


def test_init_is_seeded():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = torch.nn.Conv2d(8, 16, 3)
    b = torch.nn.Conv2d(8, 16, 3)
    init_parameters(a, g1)
    init_parameters(b, g2)
    assert torch.equal(a.weight, b.weight) and not a.bias.any()
