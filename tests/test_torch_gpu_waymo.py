"""PillarNet and DSVT on the card against the CPU.

These need a CUDA card: they carry the `gpu` marker and skip, with the
reason, where there is none. Run them on the card with

    python -m pytest tests/test_torch_gpu_waymo.py -q --noconftest

tiny_config()'s range (PillarNet at 0.25 m pillars; DSVT at 16 channels,
2 heads, 2 blocks, window (8, 4, 4), sets of 8, single-stage and in two
stages joined by ZPoolAttention), one set of seeded weights drawn on the
CPU, one seeded cloud of 1,500 points, fp32 with TF32 off: every sparse
stage's ids equal, the BEV and head outputs within 1e-4 relative L2, the
detections equal in count and labels with boxes within 1e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lvv_tpu_torch import tiny_config
from lvv_tpu_torch.models.registry import build_detector

pytestmark = [pytest.mark.fast, pytest.mark.gpu]

REL_TOL, BOX_TOL = 1e-4, 1e-3
DSVT_TINY = dict(dsvt_channels=16, dsvt_blocks=2, dsvt_heads=2,
                 dsvt_window=(8, 4, 4), dsvt_set_size=8)
CASES = {"PillarNet": ("PillarNet", {}, dict(voxel_size=(0.25, 0.25, 0.5))),
         "DSVT": ("DSVT", DSVT_TINY, {}),
         "DSVT-staged": ("DSVT", dict(
             DSVT_TINY, dsvt_stage_blocks=(1, 1),
             dsvt_stage_windows=((8, 4, 4), (2, 4, 4)),
             dsvt_downsample=(4,)), {})}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: PillarNet's and DSVT's detect on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cloud(pr, n=1500, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.array(pr[:3]), np.array(pr[3:])
    centres = rng.uniform(lo, hi, (n // 6, 3))
    pts = np.zeros((2048, 4), np.float32)
    pts[:n, :3] = centres[rng.integers(0, len(centres), n)] + rng.normal(
        0, 0.4, (n, 3))
    pts[:n, 3] = rng.uniform(0, 1, n)
    return torch.from_numpy(pts), n


def _run(det, pts, n):
    trace = []
    with torch.no_grad():
        out = det(pts.to(det.device), n, trace=trace)
    return out, det.detect(pts.to(det.device), n), trace


@pytest.mark.parametrize("case", list(CASES))
def test_detect_on_card_matches_cpu(card, case):
    name, det_kw, vox_kw = CASES[case]
    cfg = tiny_config()
    det_cfg = dataclasses.replace(cfg.model.voxelnext, **det_kw)
    vox_cfg = dataclasses.replace(cfg.voxelize, **vox_kw)
    cpu = build_detector(name, det_cfg, vox_cfg, device="cpu", seed=0)
    with torch.no_grad():
        cpu.head.hm.bias.fill_(-1.0)
        cpu.head.rot.bias[1] = 4.0
    gpu = build_detector(name, det_cfg, vox_cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    pts, n = _cloud(vox_cfg.point_range)
    got, got_d, got_t = _run(gpu, pts, n)
    want, want_d, want_t = _run(cpu, pts, n)
    assert [k for k, _ in got_t] == [k for k, _ in want_t] and got_t
    for (_, a), (_, b) in zip(got_t, want_t):
        assert torch.equal(a.ids.cpu(), b.ids)
    pairs = [(got["bev_dense"], want["bev_dense"])] + [
        (got["preds"][k], v) for k, v in want["preds"].items()]
    for a, b in pairs:
        a = a.double().cpu()
        b = b.double()
        assert float((a - b).norm() / b.norm()) <= REL_TOL
    count = int(want_d.count)
    assert count > 0 and int(got_d.count) == count
    assert torch.equal(got_d.labels.cpu(), want_d.labels)
    assert float((got_d.boxes.cpu()[:count] - want_d.boxes[:count]).abs()
                 .max()) <= BOX_TOL
