"""Phase layout of conv3x3 ∘ bilinear_upsample_×k (posfeat_tpu
keypoint_det.py:52-156, 299-350).

A full-res map [B, k·h, k·w, C] in phase layout is [B, h, w, k, k, C]:
phase (ry, rx) at trunk cell (y, x) holds pixel (k·y + ry, k·x + rx).
Each phase of conv3x3(upsample(trunk)) is a 3×3 conv of the edge-padded
trunk with a phase kernel, exact except on the outermost output ring,
which ``ring_correction_strips`` corrects. Shared by the model's "phase"
and "always" dataflows and by the fused head.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import _upsample_axis_int


def _bilinear_taps_1d(k: int):
    """1-D bilinear ×k kernel in transposed-conv form: returns (offsets,
    values) with u[m] = weight of x[j] in output o = k*j + m."""
    taps = {}
    for r in range(k):
        off = (r + 0.5) / k - 0.5
        i0 = int(np.floor(off))
        w1 = off - i0
        taps[r - k * i0] = taps.get(r - k * i0, 0.0) + (1.0 - w1)
        taps[r - k * (i0 + 1)] = taps.get(r - k * (i0 + 1), 0.0) + w1
    ms = sorted(taps)
    return ms, [taps[m] for m in ms]


def _phase_mix_matrix(k: int):
    """Constant M[r, d, d'] of the phase decomposition of
    conv3x3 ∘ bilinear_upsample_×k: output phase r at trunk cell q is
    Σ_{d,d'} M[r,d,d']·K[d']·tp[q + d] per axis, tp = edge-padded trunk.
    Returns (M [k, D, 3], D)."""
    ms, vals = _bilinear_taps_1d(k)
    lo, hi = ms[0], ms[-1]
    n_taps = hi - lo + 3  # composite support incl. the conv's ±1
    u_ext = np.zeros((n_taps + 2,), np.float32)
    for m, v in zip(ms, vals):
        u_ext[m - lo + 2] = v
    A = np.stack([u_ext[d : d + n_taps] for d in range(3)], axis=1)  # [t, d']
    pl = hi + 1 - k
    D = (n_taps + k - 1) // k
    M = np.zeros((k, D, 3), np.float32)
    for r in range(k):
        for d in range(D):
            t = n_taps - 1 - (k * d + pl - r)
            if 0 <= t < n_taps:
                M[r, d] = A[t]
    return M, D


def _phase_kernel(k2_trunk: torch.Tensor, k: int = 4) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [3, 3, Cin, k·k·Cout] phase kernel (f32)."""
    M, D = _phase_mix_matrix(k)
    assert D == 3
    M = torch.from_numpy(M).to(k2_trunk.device)
    kph = torch.einsum("rda,sep,apcf->decrsf", M, M, k2_trunk.float())
    cin, cout = k2_trunk.shape[2], k2_trunk.shape[3]
    return kph.reshape(3, 3, cin, k * k * cout)


def _edge_pad1(x: torch.Tensor) -> torch.Tensor:
    """1-px edge pad of NHWC: the upsample's source-index clamping."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def space_to_phase(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, k·h, k·w, C] -> [B, h, w, k, k, C] (a view)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // k, k, W // k, k, C).permute(0, 1, 3, 2, 4, 5)


def phase_to_space(z: torch.Tensor) -> torch.Tensor:
    """[B, h, w, k, k, C] -> [B, k·h, k·w, C]."""
    B, h, w, ky, kx, C = z.shape
    return z.permute(0, 1, 3, 2, 4, 5).reshape(B, h * ky, w * kx, C)


def ring_correction_strips(trunk: torch.Tensor, kernel: torch.Tensor, k: int = 4):
    """Additive border-correction strips for the phase-conv composite
    (keypoint_det.py:299-350).

    The composite conv sees clamped upsample values where the reference
    conv2 zero-pads the upsampled map, so it differs from the reference
    exactly by the padded-tap contributions: on the top output row the
    excess is conv1d(edge strip, K[0]), and likewise for the other
    edges; each corner term is counted by both adjacent edges, so it is
    removed once from the row strips. trunk [B, h, w, Cin], kernel
    [3, 3, Cin, Cout] -> f32 (T, Bo) [B, k·w, Cout] and (L, R)
    [B, k·h, Cout]."""
    assert k == 4, "exact border fix derived for the head's x4 case"
    B, h, w, Cin = trunk.shape
    K = kernel.float()
    t32 = trunk.float()
    top_src = _upsample_axis_int(t32[:, 0:1], k, 2)[:, 0]
    bot_src = _upsample_axis_int(t32[:, h - 1 : h], k, 2)[:, 0]
    left_src = _upsample_axis_int(t32[:, :, 0:1], k, 1)[:, :, 0]
    right_src = _upsample_axis_int(t32[:, :, w - 1 : w], k, 1)[:, :, 0]

    def conv1d_edge(strip, k1d):
        # strip [B, L, Cin], k1d [3, Cin, Cout]; edge 'same' padding: the
        # out-of-range taps of the virtual upsampled map clamp to corners
        L = strip.shape[1]
        sp = torch.cat([strip[:, :1], strip, strip[:, -1:]], dim=1)
        return sum(sp[:, t : t + L] @ k1d[t] for t in range(3))

    T = conv1d_edge(top_src, K[0])
    Bo = conv1d_edge(bot_src, K[2])
    L = conv1d_edge(left_src, K[:, 0])
    R = conv1d_edge(right_src, K[:, 2])
    # corner double-counts (row and column strips both include them)
    T[:, 0] -= t32[:, 0, 0] @ K[0, 0]
    T[:, -1] -= t32[:, 0, w - 1] @ K[0, 2]
    Bo[:, 0] -= t32[:, h - 1, 0] @ K[2, 0]
    Bo[:, -1] -= t32[:, h - 1, w - 1] @ K[2, 2]
    return T, Bo, L, R
