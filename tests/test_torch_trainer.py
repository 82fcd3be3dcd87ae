"""The port's training runtime around the step: checkpoints, the Trainer,
the train CLI, and the host-side copies (dataset split and sampler,
metrics, prefetcher, TensorBoard writer) against the JAX package's.

Checkpoint tests mirror tests/test_train_loop.py (round trip and pruning,
the best checkpoint protected, a corrupt newest skipped) plus a whole
TrainState round trip. The Trainer runs the tiny config in float32 on the
CPU over test_train_loop.py's synthetic fixture (8 BEV rows, a caption
and a det_area grounding row each: 12 train rows, 4 held out): two epochs, so the second trains after the first
epoch's generation (`greedy_generate` under inference mode), with
history.json, train.log, the TensorBoard file and the checkpoints written,
and a second Trainer resuming at the first one's step.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from lvv_tpu import config as JC
from lvv_tpu.data.dataset import DeterministicSampler as JaxSampler
from lvv_tpu.data.dataset import MixedNuDataset as JaxDataset
from lvv_tpu.data.dataset import split_rows as jax_split_rows
from lvv_tpu.train import metrics as jax_metrics
from lvv_tpu.utils.tb_writer import SummaryWriter as JaxWriter
from lvv_tpu_torch import config as C
from lvv_tpu_torch.data import (DeterministicSampler, MixedNuDataset,
                                Prefetcher, split_rows)
from lvv_tpu_torch.train import (CheckpointManager, Trainer, create_state,
                                 make_optimizer, metrics)
from lvv_tpu_torch.utils import SummaryWriter
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def synth_data(tmp_path):
    """Synthetic BEV features + QA JSONs at the tiny config's sizes (the
    fixture of tests/test_train_loop.py)."""
    cfg = C.tiny_config()
    bev_dir = tmp_path / "bev"
    bev_dir.mkdir()
    c, (h, w) = cfg.model.bev_channels, cfg.model.bev_hw
    rng = np.random.default_rng(0)
    cap, grd = [], []
    for i in range(8):
        tok = f"tok{i:02d}"
        np.save(bev_dir / f"{tok}.npy",
                rng.normal(size=(c, h, w)).astype(np.float16))
        cap.append({"sample_token": tok, "question": f"What is in scene {i}?",
                    "answer": f"A car number {i}."})
        grd.append({"sample_token": tok, "question": "Where is the car?",
                    "answer_lidar": "[1, 2, 0, 4, 2, 1.5, 0.1]",
                    "template_type": "det_area"})
    (tmp_path / "cap.json").write_text(json.dumps(cap))
    (tmp_path / "grd.json").write_text(json.dumps(grd))
    for path, value in (("data.bev_features_dir", str(bev_dir)),
                        ("data.caption_json", str(tmp_path / "cap.json")),
                        ("data.grounding_json", str(tmp_path / "grd.json")),
                        ("data.val_fraction", 0.25), ("train.epochs", 2),
                        ("train.batch_size", 2),
                        ("train.max_prompt_tokens", 24),
                        ("train.max_answer_tokens", 8),
                        ("train.output_dir", str(tmp_path / "run")),
                        ("train.inference_samples", 2),
                        ("train.log_every", 1), ("model.dtype", "float32"),
                        ("mesh.model", 1)):
        cfg = C.override(cfg, path, value)
    return cfg, tmp_path


def test_trainer_two_epochs_and_resume(synth_data):
    cfg, tmp = synth_data
    tr = Trainer(cfg, device="cpu")
    assert tr.state.generator.device.type == "cpu"
    result = tr.train()
    assert result["steps"] == 2 * tr.steps_per_epoch == 12
    assert len(result["history"]) == 2
    for hist in result["history"]:
        assert np.isfinite(hist["train_loss"])
        assert np.isfinite(hist["val_loss"])
        assert set(hist["inference"]) <= {"caption", "grounding"}
    run = tmp / "run"
    assert json.loads((run / "history.json").read_text())[1]["step"] == 12
    assert "[e1 s12]" in (run / "train.log").read_text()
    assert list((run / "tensorboard").glob("events.out.tfevents.*"))
    assert len(json.loads((run / "inference_samples.json").read_text())) == 2
    assert (run / "checkpoints" / "latest" / "state" / "state.pt").exists()
    best = json.loads((run / "checkpoints" / "best.json").read_text())
    assert (run / "checkpoints" / best["name"]).exists()
    # a second Trainer resumes the whole state at the first one's step
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.start_step == result["steps"]
    assert tr2.state.step == tr.state.step
    for name, t in tr.state.masters.items():
        assert torch.equal(tr2.state.masters[name], t), name
    got = dict(tr2.model.named_parameters())
    for name, t in tr.model.named_parameters():
        assert torch.equal(got[name], t), name
    assert torch.equal(tr2.state.generator.get_state(),
                       tr.state.generator.get_state())


def test_trainer_refuses_a_mesh(synth_data):
    cfg, _ = synth_data
    with pytest.raises(NotImplementedError, match="one card"):
        Trainer(C.override(cfg, "mesh.model", 2), device="cpu")


def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=2)
    state = {"params": {"w": torch.arange(4.0)}, "step": 7}
    for s in [10, 20, 30, 40]:
        mgr.save({**state, "step": s}, step=s)
    avail = [n for _, n in mgr.available()]
    assert avail == ["step_30", "step_40"]  # pruned to keep_last
    restored = mgr.restore("step_40", state)
    assert restored["step"] == 40
    assert torch.equal(restored["params"]["w"], torch.arange(4.0))


def test_checkpoint_best_protected(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=1)
    state = {"x": torch.ones(2)}
    mgr.save(state, step=1, is_best=True)
    for s in [2, 3, 4]:
        mgr.save(state, step=s)
    names = [n for _, n in mgr.available()]
    assert "step_1" in names  # best survives pruning
    assert "step_4" in names
    assert mgr.latest() == "step_4"


@pytest.mark.parametrize("how", ["empty_state_dir", "truncated_file"])
def test_checkpoint_corrupt_fallback(tmp_path, how):
    import shutil
    mgr = CheckpointManager(tmp_path / "ck", keep_last=5)
    mgr.save({"x": torch.ones(2)}, step=1)
    mgr.save({"x": torch.zeros(2)}, step=2)
    state_dir = tmp_path / "ck" / "step_2" / "state"
    if how == "empty_state_dir":
        shutil.rmtree(state_dir)
        state_dir.mkdir()
    else:
        data = (state_dir / "state.pt").read_bytes()
        (state_dir / "state.pt").write_bytes(data[:len(data) // 2])
    restored, step = mgr.try_restore_newest({"x": torch.ones(2)})
    assert restored is not None and step == 1
    assert torch.equal(restored["x"], torch.ones(2))


def test_train_state_roundtrip(tmp_path):
    """A TrainState saved and restored into a fresh one: step, masters,
    frozen weights, optimizer moments and the generator's position."""
    from lvv_tpu_torch import VQAModel
    cfg = C.tiny_config()

    def fresh(seed):
        model = VQAModel(cfg.model, dtype=torch.float32, device="cpu",
                         llm_lora_rank=2, clip_lora_rank=2, seed=seed)
        tx, _ = make_optimizer(cfg.train.optim, model, 10)
        return create_state(model, tx, torch.Generator().manual_seed(seed))
    a = fresh(0)
    a.step = 5
    for t in a.opt_state["groups"]["adapter"]["mu"].values():
        t.normal_(generator=torch.Generator().manual_seed(1))
    a.opt_state["groups"]["adapter"]["count"] = 5
    torch.rand(3, generator=a.generator)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(a, step=5, cfg=cfg)
    b = fresh(1)
    restored, step = mgr.try_restore_newest(b)
    assert restored is b and step == 5 and b.step == 5
    assert b.opt_state["groups"]["adapter"]["count"] == 5
    for name, t in a.masters.items():
        assert torch.equal(b.masters[name], t), name
    # the frozen weights come back into the second model (drawn from
    # another seed) too: a checkpoint holds the whole model
    assert a.frozen and b.frozen.keys() == a.frozen.keys()
    for name, t in a.frozen.items():
        assert torch.equal(b.frozen[name], t), name
    for name, t in a.opt_state["groups"]["adapter"]["mu"].items():
        assert torch.equal(b.opt_state["groups"]["adapter"]["mu"][name], t)
    assert torch.equal(torch.rand(3, generator=b.generator),
                       torch.rand(3, generator=a.generator))
    assert C.load(type(cfg), tmp_path / "ck" / "step_5" / "config.json") \
        == cfg


def test_train_cli_print_config(capsys):
    """`--print-config` with overrides prints JAX's CLI's config (the same
    schema and override rules), and starts no training."""
    from lvv_tpu_torch.tools import train_vqa
    sets = ["--set", "train.epochs=5", "--set", "model.llm_lora.r=32"]
    train_vqa.main(["--print-config", *sets])
    got = json.loads(capsys.readouterr().out)
    want = JC.to_dict(JC.apply_overrides(JC.default_config(),
                                         ["train.epochs=5",
                                          "model.llm_lora.r=32"]))
    assert got["train"] == want["train"]
    assert got["model"]["llm_lora"] == want["model"]["llm_lora"]
    assert got["train"]["epochs"] == 5
    # from a config file too, its _base_ chain resolved
    train_vqa.main(["--print-config", "--config",
                    str(REPO / "configs" / "vqa_nuscenes_serving.json")])
    got = json.loads(capsys.readouterr().out)
    want = JC.to_dict(JC.load(JC.VQAConfig, REPO / "configs" /
                              "vqa_nuscenes_serving.json"))
    assert got["model"]["sam"] == want["model"]["sam"]


@pytest.mark.parametrize("n,frac,seed", [(8, 0.25, 42), (101, 0.05, 3),
                                         (1, 0.5, 0)])
def test_split_and_sampler_match_jax(n, frac, seed):
    got_train, got_val = split_rows(n, frac, seed)
    want_train, want_val = jax_split_rows(n, frac, seed)
    np.testing.assert_array_equal(got_train, want_train)
    np.testing.assert_array_equal(got_val, want_val)
    for kw in (dict(shuffle=True), dict(shuffle=False),
               dict(num_shards=3, shard=1),
               dict(num_shards=3, shard=2, drop_last=False)):
        ours, ref = (DeterministicSampler(got_train, seed=seed, **kw),
                     JaxSampler(want_train, seed=seed, **kw))
        for epoch in (0, 1, 4):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref) and len(ours) == len(ref)


def test_dataset_matches_jax(synth_data):
    cfg, _ = synth_data
    d = cfg.data
    args = (d.bev_features_dir, d.caption_json, d.grounding_json)
    ours, ref = MixedNuDataset(*args), JaxDataset(*args)
    assert len(ours) == len(ref) == 16
    for i in (0, 7, 15):
        a, b = ours[i], ref[i]
        assert {k: v for k, v in a.items() if k != "bev"} == \
            {k: v for k, v in b.items() if k != "bev"}
        np.testing.assert_array_equal(a["bev"], b["bev"])


PREDS = ["A car is parked at [1, 2, 0, 4, 2, 1.5, 0.1] near a truck.",
         "two pedestrians cross the street", "a bus [0, 0, 0, 2, 2, 2, 0.7]",
         "the barrier is at [5.5, -1, 0.3, 1, 3, 1, 2.0], a bicycle too"]
REFS = ["A car at [1.2, 2.1, 0, 4, 2, 1.5, 0.3].", "a pedestrian crosses",
        "bus at [0.5, 0.2, 0.1, 2.5, 1.5, 2, 0.1]",
        "barrier at [5, -1.2, 0, 1.2, 2.5, 1, 1.7]"]


def test_metrics_match_jax():
    templates = ["det_area", "caption", "det_area", "det_area"]
    got = metrics.metrics_by_template(PREDS, REFS, templates)
    want = jax_metrics.metrics_by_template(PREDS, REFS, templates)
    assert got.keys() == want.keys() == {"caption", "grounding"}
    assert got["caption"] == want["caption"]
    for key, value in want["grounding"].items():
        assert got["grounding"][key] == pytest.approx(value, rel=1e-5,
                                                      abs=1e-6), key
    for a, b in zip(PREDS, REFS):
        for pa in metrics.extract_boxes(a):
            for pb in metrics.extract_boxes(b):
                assert metrics.bev_iou(pa, pb) == pytest.approx(
                    jax_metrics.bev_iou(pa, pb), rel=1e-5, abs=1e-6)
                assert metrics.iou3d(pa, pb) == pytest.approx(
                    jax_metrics.iou3d(pa, pb), rel=1e-5, abs=1e-6)
    assert metrics.bleu4(PREDS, REFS) == jax_metrics.bleu4(PREDS, REFS)
    assert metrics.cider(PREDS, REFS) == jax_metrics.cider(PREDS, REFS)


def test_prefetcher_and_tb_writer_match_jax(tmp_path):
    out = list(Prefetcher(range(10), prepare=lambda x: x * x, depth=3))
    assert out == [i * i for i in range(10)]

    def bad():
        yield 1
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        list(Prefetcher(bad()))
    for cls, sub in ((SummaryWriter, "ours"), (JaxWriter, "jax")):
        w = cls(tmp_path / sub)
        w.add_scalar("train/loss", 1.25, 3, wall_time=100.0)
        w.close()
    ours, = (tmp_path / "ours").iterdir()
    ref, = (tmp_path / "jax").iterdir()
    # the header record carries the wall clock; the scalar record is equal

    def after_header(data: bytes) -> bytes:
        return data[16 + int.from_bytes(data[:8], "little"):]
    got, want = after_header(ours.read_bytes()), after_header(ref.read_bytes())
    assert got == want and len(got) > 16


def test_remat_and_dropout():
    """`remat` recomputes each LLM layer in the backward and gives the same
    loss and gradients; dropout runs only with deterministic=False, draws
    from the generator it is given (the same state, the same mask) and
    keeps 1 - rate of the elements, scaled by 1 / (1 - rate)."""
    import dataclasses
    from lvv_tpu_torch import VQAModel
    from lvv_tpu_torch.models.layers import dropout
    from lvv_tpu_torch.models.vqa import VQABatch
    cfg = C.tiny_config().model
    rng = np.random.default_rng(3)
    s = cfg.sam.img_size
    ids = rng.integers(0, 500, (2, 12)).astype(np.int32)
    labels = np.where(np.arange(12) >= 6, ids, -100).astype(np.int32)
    batch = VQABatch(
        bev=torch.tensor(rng.standard_normal(
            (2, cfg.bev_channels, *cfg.bev_hw)), dtype=torch.float32),
        images=torch.tensor(rng.uniform(-1, 1, (2, 6, 3, s, s)),
                            dtype=torch.float32),
        view_valid=torch.ones(2, 6, dtype=torch.bool),
        text_ids=torch.tensor(ids), text_len=torch.tensor([12, 10]),
        labels=torch.tensor(labels), use_vision=torch.tensor(True),
        use_lidar=torch.tensor(True))
    grads = []
    for remat in (False, True):
        model = VQAModel(dataclasses.replace(cfg, remat=remat),
                         dtype=torch.float32, device="cpu", llm_lora_rank=2)
        assert model.llm.remat is remat
        # lora_b: lora_a's gradient is 0 while lora_b holds its zero init
        lora = model.llm.layer_0.attn.q_proj.lora_b.requires_grad_(True)
        loss, logits, count = model(batch)
        from lvv_tpu_torch.models.vqa import _prefix_len
        assert logits.shape[:2] == (2, _prefix_len(cfg) + 12)
        assert int(count) == 12
        loss.backward()
        grads.append((float(loss.detach()), lora.grad.clone()))
    assert grads[0][0] == grads[1][0]
    assert torch.allclose(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-9)
    assert grads[0][1].abs().max() > 0

    x = torch.ones(4096)
    assert dropout(x, 0.25, True) is x and dropout(x, 0.0, False) is x
    a = dropout(x, 0.25, False, torch.Generator().manual_seed(5))
    b = dropout(x, 0.25, False, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    # the adapter's configured rate reaches it, and only training draws
    model = VQAModel(dataclasses.replace(cfg, adapter=dataclasses.replace(
        cfg.adapter, dropout=0.5)), dtype=torch.float32, device="cpu")
    assert model.adapter.dropout == 0.5 and model.vat_lidar.dropout == 0.0
    with torch.no_grad():
        base = model(batch)[0]
        assert model(batch)[0] == base
        drawn = model(batch, deterministic=False,
                      generator=torch.Generator().manual_seed(1))[0]
        again = model(batch, deterministic=False,
                      generator=torch.Generator().manual_seed(1))[0]
    assert drawn != base and drawn == again
