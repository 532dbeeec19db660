"""Descriptor matchers: mutual-NN and Lowe's-ratio variants
(posfeat_tpu/ops/matchers.py; reference evaluations/aachen/matchers.py,
preprocess_utils.py:795-803, evaluations/ETH_local_feature/custom_matcher.py).

The n×m similarity is one f32 matrix product on the device, as the JAX
matchers take it outside any kernel at ``Precision.HIGHEST``
(matchers.py:17-31): ``resolve_device`` keeps TF32 off on the card. The
nearest neighbours are ``argmax`` (the first index on ties, as
``jnp.argmax``) and ``topk(…, 2)`` for the ratio test. Matches have a
variable length, so the mask is finalized on the host, where the
reference does its ``.cpu().numpy()``. Descriptors come as numpy arrays
or tensors; every matcher returns a numpy [k, 2] int64 array of index
pairs. ``device``: None for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


def _on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _sim_and_nn(d1, d2, device):
    dev = resolve_device(device)
    sim = _on(d1, dev) @ _on(d2, dev).T
    return sim, sim.argmax(dim=1), sim.argmax(dim=0)


def _top2_ratio(sim: torch.Tensor):
    nns_sim, nns = torch.topk(sim, 2, dim=1)
    nns_dist = torch.sqrt(torch.clamp(2 - 2 * nns_sim, min=0))
    ratios = nns_dist[:, 0] / (nns_dist[:, 1] + 1e-8)
    return ratios, nns[:, 0]


def _pairs(mask: np.ndarray, nn12: np.ndarray) -> np.ndarray:
    ids1 = np.arange(nn12.shape[0])
    return np.stack([ids1[mask], nn12[mask]], axis=-1).astype(np.int64)


def mutual_nn_matcher(descriptors1, descriptors2, device=None, **_):
    """Mutual nearest neighbors for L2-normalized descriptors -> [k, 2]."""
    _, nn12, nn21 = _sim_and_nn(descriptors1, descriptors2, device)
    nn12, nn21 = nn12.cpu().numpy(), nn21.cpu().numpy()
    return _pairs(np.arange(nn12.shape[0]) == nn21[nn12], nn12)


def ratio_matcher(descriptors1, descriptors2, ratio=0.95, device=None, **_):
    """Symmetric Lowe's ratio test -> [k, 2]."""
    sim, _, _ = _sim_and_nn(descriptors1, descriptors2, device)
    r12, nn12 = _top2_ratio(sim)
    r21, _ = _top2_ratio(sim.T)
    r12, nn12, r21 = r12.cpu().numpy(), nn12.cpu().numpy(), r21.cpu().numpy()
    return _pairs((r12 <= ratio) & (r21[nn12] <= ratio), nn12)


def mutual_nn_ratio_matcher(descriptors1, descriptors2, ratio=0.95, device=None, **_):
    """Mutual NN + symmetric ratio test -> [k, 2]."""
    sim, _, nn21 = _sim_and_nn(descriptors1, descriptors2, device)
    r12, nn12 = _top2_ratio(sim)
    r21, _ = _top2_ratio(sim.T)
    nn12, nn21 = nn12.cpu().numpy(), nn21.cpu().numpy()
    r12, r21 = r12.cpu().numpy(), r21.cpu().numpy()
    ids1 = np.arange(nn12.shape[0])
    return _pairs((ids1 == nn21[nn12]) & (r12 <= ratio) & (r21[nn12] <= ratio), nn12)


def mnn_matcher(descriptors_a, descriptors_b, device=None):
    """Mutual-NN (putils:795-803 / hpatches evaluation.py:28). -> [k, 2]."""
    return mutual_nn_matcher(descriptors_a, descriptors_b, device=device)


MATCHERS = {
    "mutual_nn_matcher": mutual_nn_matcher,
    "ratio_matcher": ratio_matcher,
    "mutual_nn_ratio_matcher": mutual_nn_ratio_matcher,
}
