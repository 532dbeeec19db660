"""The fused Line2Window correspondence engine
(posfeat_tpu/ops/line_window.py:42-264).

The reference runs, per direction, 100 bilinear probes along each
query's epipolar line and then a wh×ww windowed soft-argmax around the
hit (putils:661-758), gathering a descriptor for every probe. This
engine computes one dense correlation map per chunk of queries,

    pf[b, p, y, x] = ⟨featmap2[b, y, x, :], feat1[b, p, :]⟩   (one matmul),

and then

  * line stage: the (arg)max of pf over the pixels within ±0.71 px of
    the epipolar line, without a graph; it only seeds the window, plus
    the ±0.707·ws jitter;
  * window stage: a [ph, pw] patch of pf around the centre and the
    reference window expectation by separable bilinear interpolation
    matrices (Ry · patch · Rxᵀ), the same arithmetic as grid_sample,
    dot and softmax.

Gradients reach featmap2 and feat1 through pf, as in the reference's
window stage. The result does not depend on the chunk, which bounds the
memory of the line stage's [B, chunk, Hf, Wf] maps; the jitter is one
[B, N, 2] draw for all chunks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .coords import homogenize
from .epipolar import _in_image, get_endpoints, jitter

# queries per correlation map: at the flagship point (B = 8, 1200 queries,
# 120×160 maps, D = 128) one direction's line and window stages then add
# 0.44 GiB to the peak on an H100 (chip_smoke.py phase 12)
CHUNK = 256


def _window_geometry(Hf: int, Wf: int, ws: float, device):
    """(wh, ww, offsets [K, 2], off_x [ww], off_y [wh], ph, pw): the window's
    offsets in normalized units and the pf patch that covers it."""
    wh, ww = int(ws * Hf), int(ws * Wf)
    oy = np.linspace(-ws, ws, wh, dtype=np.float32)
    ox = np.linspace(-ws, ws, ww, dtype=np.float32)
    gx, gy = np.meshgrid(ox, oy, indexing="xy")
    offsets = torch.from_numpy(np.stack([gx, gy], -1).reshape(-1, 2)).to(device)
    pw = int((ox[-1] - ox[0]) * Wf / 2) + 3
    ph = int((oy[-1] - oy[0]) * Hf / 2) + 3
    return wh, ww, offsets, torch.from_numpy(ox).to(device), torch.from_numpy(oy).to(device), ph, pw


def _correlation_maps(fm_flat: torch.Tensor, f1k: torch.Tensor, Hf: int, Wf: int) -> torch.Tensor:
    """fm_flat [B, Hf·Wf, D], f1k [B, C, D] -> pf [B, C, Hf, Wf] f32: a bf16
    operand is widened, so the product is exact and f32 as JAX's
    ``preferred_element_type=float32`` makes it (line_window.py:58-68)."""
    B, C, _ = f1k.shape
    return torch.bmm(f1k.float(), fm_flat.float().transpose(1, 2)).reshape(B, C, Hf, Wf)


def _window_from_pf(pf: torch.Tensor, centers_n: torch.Tensor, geometry):
    """The reference window soft-argmax from a correlation map: pf
    [B, C, Hf, Wf], centers_n [B, C, 2] normalized -> (expected_n
    [B, C, 2], std [B, C])."""
    B, C, Hf, Wf = pf.shape
    wh, ww, offsets, off_x, off_y, ph, pw = geometry
    px = ((centers_n[..., 0:1] + off_x + 1) * Wf - 1) / 2  # [B, C, ww]
    py = ((centers_n[..., 1:2] + off_y + 1) * Hf - 1) / 2  # [B, C, wh]
    ox = torch.floor(px[..., 0]).long().clamp(0, Wf - pw)
    oy = torch.floor(py[..., 0]).long().clamp(0, Hf - ph)
    dev = pf.device
    iy = oy[..., None] + torch.arange(ph, device=dev)  # [B, C, ph]
    ix = ox[..., None] + torch.arange(pw, device=dev)  # [B, C, pw]
    idx = (iy[..., :, None] * Wf + ix[..., None, :]).reshape(B, C, ph * pw)
    patches = torch.gather(pf.reshape(B, C, Hf * Wf), 2, idx).reshape(B, C, ph, pw)

    gy = iy.float()[..., None, :]  # [B, C, 1, ph]
    gx = ix.float()[..., None, :]
    ry = torch.relu(1.0 - (py[..., :, None] - gy).abs())  # [B, C, wh, ph]
    rx = torch.relu(1.0 - (px[..., :, None] - gx).abs())  # [B, C, ww, pw]
    # grid_sample's zero padding: drop corners past the map's far edge (the
    # near edge cannot be crossed: the origins are clamped at 0)
    ry = ry * (gy <= Hf - 1).to(ry.dtype)
    rx = rx * (gx <= Wf - 1).to(rx.dtype)
    sim = torch.einsum("bcip,bcpq,bcjq->bcij", ry, patches, rx)  # [B, C, wh, ww]
    prob = torch.softmax(sim.reshape(B, C, wh * ww), dim=-1)

    coords = centers_n[:, :, None, :] + offsets  # [B, C, K, 2]
    expected = (coords * prob[..., None]).sum(2)
    var = (coords ** 2 * prob[..., None]).sum(2) - expected ** 2
    std = var.clamp_min(1e-10).sqrt().sum(-1)
    return expected, std


def _line_band_argmax(pf: torch.Tensor, abc, band_px: float, use_nn: bool):
    """Band-masked (arg)max over a correlation map without a graph: pf
    [B, C, Hf, Wf]; abc three [B, C] unit-normal line coefficients in the
    map's pixel frame -> (center_n [B, C, 2], band_ok [B, C])."""
    B, C, Hf, Wf = pf.shape
    a, b, c = (t[..., None, None] for t in abc)
    ys = torch.arange(Hf, dtype=torch.float32, device=pf.device)[:, None]
    xs = torch.arange(Wf, dtype=torch.float32, device=pf.device)[None, :]
    band = (a * xs + b * ys + c).abs() <= band_px
    flat = torch.where(band, pf, float("-inf")).reshape(B, C, Hf * Wf)
    if use_nn:
        idx = flat.argmax(-1)
        cy = torch.div(idx, Wf, rounding_mode="floor").float()
        cx = (idx % Wf).float()
    else:
        p = torch.softmax(flat, dim=-1).reshape(B, C, Hf, Wf)
        cy = (p * ys).sum((-1, -2))
        cx = (p * xs).sum((-1, -2))
    band_ok = torch.isfinite(flat.amax(-1))
    return torch.stack([(2 * cx + 1) / Wf - 1, (2 * cy + 1) / Hf - 1], dim=-1), band_ok


def window_expectation_fused(featmap2: torch.Tensor, feat1: torch.Tensor, centers_n: torch.Tensor,
                             window_size: float, chunk: int = CHUNK):
    """The window stage alone: the (expected, std) of
    ``get_expected_correspondence_within_window`` from correlation maps."""
    B, Hf, Wf, D = featmap2.shape
    geometry = _window_geometry(Hf, Wf, window_size, featmap2.device)
    fm_flat = featmap2.reshape(B, Hf * Wf, D)
    outs = [
        _window_from_pf(_correlation_maps(fm_flat, feat1[:, s:s + chunk], Hf, Wf),
                        centers_n[:, s:s + chunk], geometry)
        for s in range(0, feat1.shape[1], chunk)
    ]
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)


def fused_line_window(featmap2: torch.Tensor, feat1: torch.Tensor, coord1: torch.Tensor,
                      fmat: torch.Tensor, h_img: int, w_img: int, *, window_size: float,
                      jitter_u: torch.Tensor = None, use_nn: bool = True, loc_rand: bool = True,
                      band_px: float = 0.71, chunk: int = CHUNK) -> Tuple[torch.Tensor, ...]:
    """Fused line search and window refinement: featmap2 [B, Hf, Wf, D]
    (temperature-scaled, normalized), feat1 [B, N, D], coord1 [B, N, 2]
    image-1 pixels, (h_img, w_img) image 2's size, ``jitter_u`` [B, N, 2]
    uniform [0, 1) draws read when ``loc_rand``. Returns (center_n
    [B, N, 2] after the jitter, center_org_n, valid [B, N],
    win_expected_n [B, N, 2], win_std [B, N])."""
    B, Hf, Wf, D = featmap2.shape
    N = feat1.shape[1]
    if loc_rand and jitter_u is None:
        raise ValueError("loc_rand needs jitter_u draws")
    geometry = _window_geometry(Hf, Wf, window_size, featmap2.device)

    # epipolar lines in the map's pixel frame: image px X = (2cW/Wf)·xf + cW/Wf
    cW, cH = (w_img - 1) / 2.0, (h_img - 1) / 2.0
    line = torch.matmul(fmat, homogenize(coord1).transpose(1, 2))  # [B, 3, N]
    a = line[:, 0] * (2 * cW / Wf)
    b = line[:, 1] * (2 * cH / Hf)
    c = line[:, 2] + line[:, 0] * (cW / Wf) + line[:, 1] * (cH / Hf)
    inv_norm = torch.rsqrt((a * a + b * b).clamp_min(1e-20))
    a, b, c = a * inv_norm, b * inv_norm, c * inv_norm  # [B, N]
    _, _, valid_ep = get_endpoints(coord1, fmat, h_img, w_img)

    fm_flat = featmap2.reshape(B, Hf * Wf, D)
    outs = []
    for s in range(0, N, chunk):
        sl = slice(s, s + chunk)
        pf = _correlation_maps(fm_flat, feat1[:, sl], Hf, Wf)
        with torch.no_grad():
            center_org, band_ok = _line_band_argmax(pf.detach(), (a[:, sl], b[:, sl], c[:, sl]),
                                                    band_px, use_nn)
            center = center_org + jitter(jitter_u[:, sl], window_size) if loc_rand else center_org
        expected, std = _window_from_pf(pf, center, geometry)
        outs.append((center, center_org, band_ok & _in_image(center), expected, std))
    centers, centers_org, ok, win_exp, win_std = (torch.cat(t, 1) for t in zip(*outs))
    return centers, centers_org, valid_ep & ok, win_exp, win_std
