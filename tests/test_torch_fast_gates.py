"""The JAX package's fast-path gates in posfeat_tpu_torch, each against
the JAX function under its environment knob (set with monkeypatch), on
the CPU:

- ``head_ring=False`` (POSFEAT_HEAD_RING=0): the ring-skip fused head
  against ``fused_head_tail(interpret=True)``, v3 and v1, the whole map,
  its border ring included, at the JAX fused-head tests' tolerance
  (rtol 2e-3 / atol 2e-4, tests/test_pallas_fused_head.py:97);
- ``head_im2col`` (POSFEAT_HEAD_IM2COL=1): K1's plain version against
  JAX's im2col trunk operand ("v3i", :81-97), same tolerance, with the
  ring and without;
- ``topk="approx"`` (POSFEAT_TOPK=approx): ``generate_kpts_single``'s
  winners in the same slots, their scores and counts bit for bit (JAX's
  approx_max_k is exact on the CPU);
- ``sample_impl`` "pair" (its factored lerp, within rtol 1e-6 / atol
  1e-7 of JAX's) and "quad" (F.grid_sample, within rtol 1e-5 / atol 1e-5,
  the corner impl's tolerance in tests/test_torch_ops.py);
- the Extractor's ``fast_mode`` / ``fast_gates`` resolution and record,
  and the lite set through both Extractors end to end;
- KeypointDet's ring-skip v3 head without the full-resolution convimg.
"""

import copy
import json

import numpy as np
import pytest
import torch

from posfeat_tpu_torch.extract import Extractor
from posfeat_tpu_torch.extract.extractor import EXACT_GATES, FAST_GATES, resolve_fast_gates
from posfeat_tpu_torch.models import keypoint_det as kd
from posfeat_tpu_torch.ops import detect as td
from posfeat_tpu_torch.ops import fused_head as fh
from posfeat_tpu_torch.ops import grid_sample as tg
from test_torch_extract import H, W, _config
from test_torch_extract import weights  # noqa: F401  (fixture)
from test_torch_fused_head import ATOL, RTOL, _img_branch_np, _setup
from torch_port_helpers import pairs_close

LITE_ENV = {"POSFEAT_HEAD_RING": "0", "POSFEAT_HEAD_IM2COL": "1", "POSFEAT_TOPK": "approx",
            "POSFEAT_SAMPLE_IMPL": "quad"}


def _heads(args, mode, ring, im2col):
    """(JAX's interpret-mode head, the port's plain-version head) on the
    same operands."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.pallas.fused_head import fused_head_tail as jax_fused_head_tail

    trunk, s, k1, b1, k2t, k2i, b2, w3, b3, a = args
    y, mu, ia = _img_branch_np(s, k1, b1)
    ops = (trunk, s, y, mu, ia, k1, b1, k2t, k2i, b2, w3, b3, a)
    ref = jax_fused_head_tail(*map(jnp.asarray, ops), act="Softplus", interpret=True)
    img_y = None if (mode == "v3" and not ring) else y  # the ring-skip v3 head reads no convimg output
    port_ops = (trunk, s, img_y, k1, b1, k2t, k2i, b2, w3, b3, a)
    got = fh.fused_head_tail(*(None if o is None else torch.from_numpy(np.array(o)) for o in port_ops),
                             act="Softplus", mode=mode, ring=ring, im2col=im2col)
    return np.asarray(ref), got


@pytest.mark.parametrize("mode, ring, im2col", [("v3", False, False), ("v1", False, False),
                                                ("v3", True, True), ("v3", False, True)],
                         ids=["v3_ring_skip", "v1_ring_skip", "v3_im2col", "v3_lite"])
def test_head_gates_match_pallas_interpret(rng, monkeypatch, mode, ring, im2col):
    monkeypatch.setenv("POSFEAT_HEAD_MODE", mode)
    monkeypatch.setenv("POSFEAT_HEAD_RING", "1" if ring else "0")
    monkeypatch.setenv("POSFEAT_HEAD_IM2COL", "1" if im2col else "0")
    # the shapes of test_pallas_fused_head.py's ring-skip test (:107)
    args = _setup(rng, B=2, h=16, w=24, cin=24, cy=16, cout=32, out=2)
    ref, got = _heads(args, mode, ring, im2col)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    if not ring:
        # the ring-skip map differs from the exact one on the border ring
        exact = fh.fused_head_tail(*(torch.from_numpy(np.array(o)) for o in (
            args[0], args[1], _img_branch_np(args[1], args[2], args[3])[0], *args[2:])), act="Softplus", mode=mode)
        assert not torch.allclose(exact[:, :2], got[:, :2], rtol=RTOL, atol=ATOL)


def test_ring_skip_needs_no_convimg_output_in_v3_only(rng):
    args = [torch.from_numpy(np.array(o)) for o in _setup(rng, B=1, h=8, w=16, cin=8, cy=8, cout=16, out=1)]
    trunk, s, k1, b1, *rest = args
    fh.fused_head_tail(trunk, s, None, k1, b1, *rest, ring=False)
    for mode, ring in (("v3", True), ("v1", False)):
        with pytest.raises(ValueError, match="img_y"):
            fh.fused_head_tail(trunk, s, None, k1, b1, *rest, mode=mode, ring=ring)


@pytest.mark.parametrize("ring, mode, computed", [(True, "v3", True), (False, "v3", False), (False, "v1", True)])
def test_keypoint_det_skips_the_convimg_output(rng, monkeypatch, ring, mode, computed):
    """Under v3 with the ring off the head computes no full-resolution
    convimg output (JAX gets that from XLA's dead-code elimination)."""
    head = kd.KeypointDet(in_channels=24, out_channels=1, prior="identity", act="Softplus",
                          fused_upsample="pallas", fused_head_mode=mode, head_ring=ring).eval()
    convs = []
    conv = kd._conv
    monkeypatch.setattr(kd, "_conv", lambda x, w, *a, **k: convs.append(tuple(w.shape)) or conv(x, w, *a, **k))
    with torch.no_grad():
        out = head(torch.from_numpy(rng.rand(1, 8, 12, 24).astype(np.float32)),
                   torch.from_numpy(rng.rand(1, 32, 48, 3).astype(np.float32)))
    assert out.shape == (1, 32, 48, 1) and torch.isfinite(out).all()
    assert ((64, 3, 3, 3) in convs) is computed, convs


def _quantized_map(rng, levels=None):
    m = rng.rand(2, 60, 76, 1) + 0.01
    if levels:
        m = np.round(m * levels) / levels + 0.01  # many exact ties
    return m.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(num_pts=200, nms_radius=1),
    dict(num_pts=200, nms_radius=2, thr=1.0, thr_mod="mean"),
    dict(num_pts=5000, nms_radius=3),
    dict(num_pts=300, nms_radius=1, refine="quad"),
    dict(num_pts=300, nms_radius=1, levels=16),
    dict(num_pts=100, nms_radius=0, use_nms=False),
], ids=["r1", "r2_thr", "r3_padded", "r1_quad", "r1_ties", "no_nms"])
def test_approx_topk_matches_jax(rng, monkeypatch, case):
    """On tests/test_detect_parity.py:242's map (and a tie-heavy one):
    the packed top-k's slate, scores and counts equal JAX's."""
    import jax.numpy as jnp
    from posfeat_tpu.ops.detect import generate_kpts_single as jax_detect

    case = dict(case)
    kp_map = _quantized_map(rng, case.pop("levels", None))
    monkeypatch.setenv("POSFEAT_TOPK", "approx")
    ref = [np.asarray(t) for t in jax_detect(jnp.asarray(kp_map), **case)]
    got = [t.numpy() for t in td.generate_kpts_single(torch.from_numpy(kp_map), topk="approx", **case)]
    exact = [t.numpy() for t in td.generate_kpts_single(torch.from_numpy(kp_map), **case)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
    # the same winners in the same slots (the refined coordinates at
    # tests/test_torch_detect.py's atol 1e-5, a pixel being 2.7e-2 here),
    # scores and counts bit for bit; the zero-score slots past the valid
    # count, which the extractor trims, tie and may come in any order
    n = int(ref[2].min())
    np.testing.assert_allclose(got[0][:, :n], ref[0][:, :n], rtol=0.0, atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    if case.get("use_nms", True):
        # the scores are the selected values with their 4 packing bits
        # cleared, not the max-pooled map's
        assert not np.array_equal(got[1], exact[1])


def test_topk_values_are_checked():
    m = torch.rand(1, 8, 8, 1)
    for det in (td.generate_kpts_single, td.generate_kpts_single_noavg):
        with pytest.raises(ValueError, match="unknown topk"):
            det(m, num_pts=4, nms_radius=1, topk="fast")
    with pytest.raises(ValueError, match="unknown topk"):
        td.generate_kpts_regular_grid_single(m, grid_size=4, topk="fast")


@pytest.mark.parametrize("impl", ["pair", "quad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_impls_match_jax(rng, monkeypatch, impl, dtype):
    import jax.numpy as jnp
    from posfeat_tpu.ops.grid_sample import sample_feat_by_coord as jax_sample

    fmap = rng.randn(2, 12, 16, 8).astype(np.float32)
    pts = rng.rand(2, 500, 2).astype(np.float32) * 2.2 - 1.1  # some out of bounds
    monkeypatch.setenv("POSFEAT_SAMPLE_IMPL", impl)
    tol = dict(rtol=1e-6, atol=1e-7) if impl == "pair" else dict(rtol=1e-5, atol=1e-5)
    for norm in (False, True):
        ref = jax_sample(jnp.asarray(fmap).astype(dtype), jnp.asarray(pts), norm)
        got = tg.sample_feat_by_coord(torch.from_numpy(fmap).to(getattr(torch, dtype)), torch.from_numpy(pts),
                                      norm, impl=impl)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), **tol)
    with pytest.raises(ValueError, match="zeros padding"):
        tg.grid_sample(torch.from_numpy(fmap), torch.from_numpy(pts), "border", impl=impl)
    with pytest.raises(ValueError, match="unknown sample_impl"):
        tg.grid_sample(torch.from_numpy(fmap), torch.from_numpy(pts), impl="row")


def test_fast_gate_resolution():
    """The lite set for bf16 on the card only; fast_mode: False, f32 and
    the CPU keep the exact set; a key given in fast_gates wins either way."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    bf16, f32 = torch.bfloat16, torch.float32
    assert resolve_fast_gates({}, bf16, cuda) == FAST_GATES
    assert resolve_fast_gates({"fast_mode": True}, bf16, cpu) == EXACT_GATES
    assert resolve_fast_gates({}, f32, cuda) == EXACT_GATES
    assert resolve_fast_gates({"fast_mode": False}, bf16, cuda) == EXACT_GATES
    assert resolve_fast_gates({"fast_gates": {"topk": "exact"}}, bf16, cuda) == {**FAST_GATES, "topk": "exact"}
    assert resolve_fast_gates({"fast_mode": False, "fast_gates": {"sample_impl": "pair"}}, bf16, cuda) == {
        **EXACT_GATES, "sample_impl": "pair"}
    assert resolve_fast_gates({"fast_gates": {"head_ring": False}}, f32, cpu)["head_ring"] is False
    with pytest.raises(ValueError, match="unknown fast_gates key"):
        resolve_fast_gates({"fast_gates": {"ring": False}}, bf16, cuda)
    with pytest.raises(ValueError, match="fast_gates.topk"):
        resolve_fast_gates({"fast_gates": {"topk": "fast"}}, bf16, cuda)


def _write_image(tmp_path, rng):
    import cv2

    from posfeat_tpu.data.synthetic import _texture

    seq = tmp_path / "hp" / "i_x"
    seq.mkdir(parents=True)
    cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(_texture(rng, H, W), cv2.COLOR_RGB2BGR))


def test_extractor_records_its_gates_and_keeps_them(tmp_path, rng, weights):  # noqa: F811
    """The resolved gates go into the run's config.yaml and the head; a
    later f32 Extractor in the same process sees none of them; a
    backbone_config numerics key of the extract config wins over the
    checkpoint's config."""
    _, _, ck = weights
    _write_image(tmp_path, rng)
    cfg = dict(_config(tmp_path, "lite", ck), compute_dtype="bfloat16", head_dataflow="pallas",
               fast_gates=dict(FAST_GATES))
    cfg["model_config"]["backbone_config"]["desc_tail"] = "split3"
    ex = Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu")
    saved = json.load(open(tmp_path / "out" / "ex_lite" / "config.yaml"))
    assert saved["fast_gates"] == FAST_GATES == ex.gates
    assert saved["model_config"]["backbone_config"]["desc_tail"] == "split3" == ex.model.backbone.desc_tail
    head = ex.model.localheader
    assert (head.head_ring, head.head_im2col) == (False, True)
    assert "fast gates" in open(tmp_path / "out" / "ex_lite" / "logging_file.txt").read()
    assert "fast_gates" not in cfg or cfg["fast_gates"] == FAST_GATES  # the caller's dict is untouched
    later = Extractor(_config(tmp_path, "f32", ck), ckpt_root=str(tmp_path / "out"), device="cpu")
    assert later.gates == EXACT_GATES and later.model.backbone.desc_tail == ""
    assert (later.model.localheader.head_ring, later.model.localheader.head_im2col) == (True, False)
    off = Extractor(dict(_config(tmp_path, "bf16", ck), compute_dtype="bfloat16", fast_mode=True),
                    ckpt_root=str(tmp_path / "out"), device="cpu")
    assert off.gates == EXACT_GATES  # the lite default is the card's


def test_lite_extractors_write_matching_npz(tmp_path, rng, weights, monkeypatch):  # noqa: F811
    """The lite set end to end: the port's Extractor with it in
    ``fast_gates`` (the fused head's plain versions on the CPU) against
    JAX's with its four knobs set, both f32 with the fused head, at
    test_torch_extract.py's tolerances."""
    from posfeat_tpu.extract import Extractor as JaxExtractor

    _, _, ck = weights
    _write_image(tmp_path, rng)
    for k, v in LITE_ENV.items():
        monkeypatch.setenv(k, v)
    JaxExtractor(dict(_config(tmp_path, "jax", ck), head_dataflow="pallas"), ckpt_root=str(tmp_path / "out")).extract()
    for k in LITE_ENV:
        monkeypatch.delenv(k)
    cfg = dict(_config(tmp_path, "port", ck), head_dataflow="pallas", fast_gates=copy.deepcopy(FAST_GATES))
    Extractor(cfg, ckpt_root=str(tmp_path / "out"), device="cpu").extract()
    ref = np.load(tmp_path / "out" / "ex_jax" / "desc" / "i_x" / "1.ppm.pf")
    got = np.load(tmp_path / "out" / "ex_port" / "desc" / "i_x" / "1.ppm.pf")
    assert got["keypoints"].shape == ref["keypoints"].shape
    pairs_close(got["keypoints"], got["scores"][:, 0], got["descriptors"],
                ref["keypoints"], ref["scores"][:, 0], ref["descriptors"])
