"""posfeat_tpu_torch's synthetic training pairs and batch loader against
posfeat_tpu's: the geometry (F1, F2, coord1, coord2) bit for bit, the
pixels up to interpolation rounding, valid epipolar geometry, and the
loader's batches and its empty-shard error."""

import numpy as np
import pytest

from posfeat_tpu.data.synthetic import SyntheticPairs as JaxSyntheticPairs
from posfeat_tpu_torch.data import DATASETS
from posfeat_tpu_torch.data import synthetic as ts
from posfeat_tpu_torch.data.loader import PrefetchLoader, collate

CFG = {"num_pairs": 6, "height": 96, "width": 128, "num_pts": 32}


@pytest.mark.parametrize("extra", [{}, {"photometric": True}, {"num_scenes": 2}],
                         ids=["plain", "photometric", "scenes"])
def test_synthetic_pairs_match_jax(extra):
    cfg = {**CFG, **extra}
    port, ref = DATASETS["SyntheticPairs"](cfg), JaxSyntheticPairs(cfg)
    assert len(port) == len(ref) == 6
    for item in (0, 3):
        a, b = port[item], ref[item]
        for k in ("F1", "F2", "coord1", "coord2", "pose1", "intrinsic1"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["name1"] == b["name1"]
        for k in ("im1_ori", "im2_ori"):
            d = np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
            assert a[k].dtype == np.uint8 and a[k].shape == b[k].shape
            # interpolation rounding only: a few levels at most, rarely
            assert d.max() <= 3 and d.mean() < 0.05, (k, d.max(), d.mean())
            assert abs(a[k].mean() - b[k].mean()) < 0.05
        np.testing.assert_allclose(a["im1"], b["im1"], atol=0.05)


def test_synthetic_fundamental_matrices_are_valid():
    """x2 = H x1 lies on the epipolar line F1 x1, and x1 on F2 x2."""
    s = ts.SyntheticPairs(CFG)[1]
    Hm = s["homography"].astype(np.float64)
    x1 = np.concatenate([s["coord1"][:, :2], np.ones((CFG["num_pts"], 1))], 1)
    x2 = x1 @ Hm.T
    x2 = x2 / x2[:, 2:]
    for F, a, b in ((s["F1"], x1, x2), (s["F2"], x2, x1)):
        line = a @ F.astype(np.float64).T
        dist = np.abs((line * b).sum(1)) / np.linalg.norm(line[:, :2], axis=1)
        assert dist.max() < 1e-2, dist.max()


def test_resize_and_warp_match_opencv():
    import cv2

    rng = np.random.RandomState(0)
    base = rng.rand(12, 16, 3).astype(np.float32)
    np.testing.assert_allclose(
        ts.resize_cubic(base, 96, 128),
        cv2.resize(base, (128, 96), interpolation=cv2.INTER_CUBIC), atol=1e-5,
    )
    im = ts._texture(rng, 96, 128)
    Hm = np.eye(3)
    Hm[:2] = cv2.getRotationMatrix2D((64.0, 48.0), 11.0, 1.05)
    Hm[2, :2] = [2e-4, -1e-4]
    np.testing.assert_allclose(Hm[:2], ts.rotation_matrix_2d((64.0, 48.0), 11.0, 1.05))
    got = ts.warp_perspective_reflect(im, Hm, 128, 96).astype(np.int32)
    want = cv2.warpPerspective(im, Hm, (128, 96), borderMode=cv2.BORDER_REFLECT).astype(np.int32)
    assert np.abs(got - want).max() <= 3 and np.abs(got - want).mean() < 0.3


def test_loader_batches_and_empty_shard_raises():
    ds = ts.SyntheticPairs({**CFG, "num_pairs": 5})
    it = iter(PrefetchLoader(ds, batch_size=2, num_workers=2, seed=1, infinite=True))
    batches = [next(it) for _ in range(4)]  # crosses an epoch boundary
    it.close()
    for b in batches:
        assert b["im1"].shape == (2, 96, 128, 3) and b["F1"].shape == (2, 3, 3)
        assert isinstance(b["name1"], list) and len(b["name1"]) == 2
    order = [n for b in batches[:2] for n in b["name1"]]
    perm = np.arange(5)
    np.random.RandomState(1).shuffle(perm)
    assert order == [f"synthetic/{i}_1" for i in perm[:4]]
    finite = list(PrefetchLoader(ds, batch_size=2, shuffle=False, num_workers=1))
    assert [b["name1"] for b in finite] == [[f"synthetic/{i}_1" for i in k] for k in ((0, 1), (2, 3))]
    assert collate([ds[0]])["coord1"].shape == (1, 32, 3)
    # the JAX loader spins forever here (posfeat_tpu/data/loader.py:84)
    with pytest.raises(ValueError, match="no sample"):
        next(iter(PrefetchLoader([], batch_size=1, infinite=True)))
