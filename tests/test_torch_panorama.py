"""The one-tile banded image of posfeat_tpu_torch on the CPU: a panorama
(at most 512 rows, more than 8192 columns, so above the default 4 Mpx
``spatial_threshold_px``) gets row tiles of fewer rows
(``ops/conv_tiles.py`` ``tile_rows``: its rows split evenly into the
fewest tiles of at most 512 x 8192 pixels), so that it has two or more
tiles, its bands lie on tile boundaries and both programs issue the same
conv calls.

- the tile and the band plan of a panorama: two 256-row tiles at
  512x8704, bands [0, 256] over 2 and 4 devices;
- every map of an image of at most 8192 columns keeps the tiles it had
  (``ROW_TILE`` // stride at every level) and its band plan (the rule
  before panoramas had their own tiles, written out here);
- every image above 4 Mpx has two or more tiles;
- the whole banded program's maps against the unsharded ones at the
  smallest shape the rule reaches, with the rule scaled down (tiles of 64
  rows up to 128 columns: a 64x160 image has two tiles of 32 rows) so
  that the CPU runs it in seconds: bf16 ``torch.equal`` (under the former
  rule, 16-row-block bands, its local and score maps differ on the CPU
  too); f32 within test_torch_spatial.py's rtol 1e-4 / atol 1e-5, since
  oneDNN's f32 convs outside the tiles also pick by shape. The card runs
  the real 512x8704, both dtypes bit for bit (chip_smoke.py phase 25 (a)).
"""

import copy

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.models import PoSFeat
from posfeat_tpu_torch.ops import conv_tiles
from posfeat_tpu_torch.parallel import spatial_extract, spatial_mesh
from torch_port_helpers import SMALL_CONFIG

STRIDES = (2, 4, 8, 16)  # the tiled maps: H/2 (ResUNetHR's decoder) to H/16


def _parent_plan(height, n):
    """SpatialMesh.plan before panoramas had their own tiles: 512-row
    units above 512 rows, else 16-row blocks."""
    unit = 512 if height > 512 else 16
    units = -(-height // unit)
    n = min(n, units)
    base, extra = divmod(units, n)
    more = range(extra) if unit == 16 else range(n - extra, n)
    starts, r = [], 0
    for i in range(n):
        starts.append(r)
        r += unit * (base + (i in more))
    return starts


@pytest.mark.parametrize("height, width, rows", [(512, 8192, 512), (512, 8208, 256), (512, 8704, 256),
                                                 (496, 8704, 256), (1024, 8704, 352), (4096, 8704, 464),
                                                 (512, 12288, 256), (256, 16384, 256), (64, 262144, 16),
                                                 (16, 10**7, 16)])
def test_tile_rows(height, width, rows):
    assert conv_tiles.tile_rows(height, width) == rows
    assert rows * min(width, conv_tiles.WIDE) <= 512 * 8192 or rows == 16
    assert all(conv_tiles.map_tile(height // s, width // s, s) == rows // s for s in STRIDES)
    tiles = -(-height // rows)
    assert tiles * rows - height < 16 * tiles  # even: the last tile at most one block per tile short


@pytest.mark.parametrize("n", [2, 4, 8])
def test_panorama_band_plan(n):
    mesh = spatial_mesh(["cpu"] * n)
    assert mesh.plan(512, 8704) == [0, 256]  # two tiles, so two bands
    assert mesh.plan(512, 8208) == [0, 256]
    assert mesh.plan(1024, 8704) == [0, 352, 704][:n]
    assert mesh.plan(512) == _parent_plan(512, n)  # the width unsaid: at most 8192 columns


@pytest.mark.parametrize("height, width", [(480, 640), (1200, 1600), (2048, 3072), (3024, 4032), (512, 8192),
                                           (4096, 8192), (64, 8192), (8192, 512)])
def test_tiles_and_plans_up_to_8192_columns_unchanged(height, width):
    assert conv_tiles.tile_rows(height, width) == conv_tiles.ROW_TILE == 512
    for s in STRIDES:
        assert conv_tiles.map_tile(height // s, width // s, s) == 512 // s
    for n in (1, 2, 3, 4, 8):
        assert spatial_mesh(["cpu"] * n).plan(height, width) == _parent_plan(height, n)
    if (height, width) == (480, 640):  # one tile, one call a conv, at every level
        assert all(height // s <= conv_tiles.map_tile(height // s, width // s, s) for s in STRIDES)


@pytest.mark.parametrize("width", [640, 4096, 8192, 8208, 8704, 12288, 65536, 262144])
def test_every_image_above_4_mpx_has_two_tiles(width):
    height = (512 * 8192 // width + 1 + 15) // 16 * 16  # the fewest 16-row blocks above 4 Mpx
    tile = conv_tiles.tile_rows(height, width)
    assert height * width > 4 * 2**20 and tile % 16 == 0 and -(-height // tile) >= 2


@pytest.fixture(scope="module")
def scaled_models():
    return {dt: PoSFeat(copy.deepcopy(SMALL_CONFIG), dtype=dt, device="cpu", seed=5).eval()
            for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_panorama_banded_maps_equal_unsharded(scaled_models, monkeypatch, dtype, k):
    monkeypatch.setattr(conv_tiles, "ROW_TILE", 64)
    monkeypatch.setattr(conv_tiles, "WIDE", 128)
    height, width = 64, 160
    assert conv_tiles.tile_rows(height, width) == 32
    mesh = spatial_mesh(["cpu"] * k)
    assert mesh.plan(height, width) == [0, 32]
    model = scaled_models[dtype]
    im = torch.from_numpy(np.random.RandomState(6).randn(1, height, width, 3).astype(np.float32))
    with torch.inference_mode():
        want = model.extract(im)
        got = spatial_extract(model, mesh)(im)
    assert len(got["local_map"]) == 2
    for key in ("local_map", "local_point", "global_map"):
        g = got[key].concat()
        assert g.dtype == want[key].dtype, key
        if dtype == torch.bfloat16:
            assert torch.equal(g, want[key]), key
        else:
            np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)
