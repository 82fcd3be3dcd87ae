"""VoxelNeXt training and the native host I/O library on the card.

These need a CUDA card: they carry the `gpu` marker and skip, with the
reason, where there is none. Run them on the card with

    python -m pytest tests/test_torch_gpu_detector.py -q --noconftest

tiny_config()'s detector, one set of seeded weights drawn on the CPU, the
train CLI's synthetic batch of two clouds: one step of the CLI's chain on the card against the same
step on the CPU, in both norm modes (fp32, TF32 off). The loss within
1e-5 relative; every parameter's gradient within 1e-4 relative L2 (one
whose norm is under 1e-6 of the global norm, a conv bias that "bn"
subtracts out, within 1e-6 of the global norm); the running statistics
within 1e-5; vel / iou without a gradient on both. The native library,
built on the card's host, reads a sweep and voxelizes bit-equal to its
numpy versions.
"""
import numpy as np
import pytest
import torch

from lvv_tpu_torch import native, tiny_config
from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
from lvv_tpu_torch.tools.train_detector import synthetic_batch
from lvv_tpu_torch.train.detector import make_detector_train_step
from lvv_tpu_torch.train.optim import detector_optimizer

pytestmark = [pytest.mark.fast, pytest.mark.gpu]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the detector's train step on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _step(device, norm):
    """One step on `device` from the weights seed 0 draws on the CPU."""
    import dataclasses
    cfg = tiny_config()
    det_cfg = dataclasses.replace(cfg.model.voxelnext, norm=norm)
    start = VoxelNeXtDetector(det_cfg, cfg.voxelize, device="cpu", seed=0)
    det = VoxelNeXtDetector(det_cfg, cfg.voxelize, device=device)
    det.load_state_dict(start.state_dict())
    batch = synthetic_batch(np.random.default_rng(0), 2,
                            cfg.voxelize.max_points // 4, 8,
                            cfg.voxelize.point_range)
    tx = detector_optimizer(1e-3, 3)
    step = make_detector_train_step(det, tx, det_cfg, cfg.voxelize)
    _, metrics = step((det, tx.init(dict(det.named_parameters()))), batch)
    grads = {n: None if p.grad is None else p.grad.cpu()
             for n, p in det.named_parameters()}
    stats = {n: b.cpu() for n, b in det.named_buffers()}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_train_step_on_the_card_matches_the_cpu(card, norm):
    m_card, g_card, s_card = _step(card, norm)
    m_cpu, g_cpu, s_cpu = _step("cpu", norm)
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-5)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values()
                                 if g is not None)))
    for name, want in g_cpu.items():
        got = g_card[name]
        if want is None:
            assert got is None, name
            assert name.split(".")[1].startswith(("vel_", "iou_")), name
            continue
        err = float((got - want).norm())
        if float(want.norm()) <= 1e-6 * total:
            assert err <= 1e-6 * total, name
        else:
            assert err <= 1e-4 * float(want.norm()), (name, err)
    assert sum(g is None for g in g_card.values()) == 12
    for name, want in s_cpu.items():
        assert float((s_card[name] - want).abs().max()) <= 1e-5, name


def test_native_library_on_the_card_host(card, tmp_path):
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((3000, 5)).astype(np.float32)
    path = tmp_path / "sweep.pcd.bin"
    raw.tofile(path)
    got, n = native.load_points(path, 2048)
    want, n_want = native.load_points_plain(path, 2048)
    assert n == n_want == 2048
    np.testing.assert_array_equal(got, want)
    rng_range = (-2.0, -2.0, -2.0, 2.0, 2.0, 2.0)
    a = native.voxelize_mean_host(raw[:, :4], rng_range, (0.25,) * 3, 1000)
    b = native.voxelize_mean_host_plain(raw[:, :4], rng_range, (0.25,) * 3,
                                        1000)
    assert a[3] == b[3] > 0
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
