"""The port's config package against the JAX package's (lvv_tpu/config).

Pure Python on both sides: every comparison is exact (dict equality).
"""
import glob
import json
import pathlib

import pytest

from lvv_tpu import config as J
from lvv_tpu_torch import config as C
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
VQA_CONFIGS = sorted(glob.glob(str(REPO / "configs" / "vqa_*.json")))


def test_there_are_vqa_configs():
    assert len(VQA_CONFIGS) >= 3


@pytest.mark.parametrize("path", VQA_CONFIGS,
                         ids=lambda p: pathlib.Path(p).stem)
def test_repo_config_loads_as_in_jax(path):
    """Every shipped VQA config (with its `_base_` chain) gives the JAX
    package's tree, section for section."""
    got = C.to_dict(C.load(C.VQAConfig, path))
    assert got == J.to_dict(J.load(J.VQAConfig, path))
    assert set(got) == {"model", "train", "data", "mesh", "voxelize",
                        "debug_level"}


def test_serving_preset_fields():
    cfg = C.load(C.VQAConfig, REPO / "configs" / "vqa_nuscenes_serving.json")
    m = cfg.model
    assert (m.sam.quant8, m.clip.quant8) == (True, True)
    assert (m.vat_vision.compression_factor, m.vat_lidar.n_queries) == (4,
                                                                        384)
    assert cfg.train.batch_size == 8 and cfg.mesh.data == -1


@pytest.mark.parametrize("make", ["default_config", "tiny_config"])
def test_presets_match_jax(make):
    assert C.to_dict(getattr(C, make)()) == J.to_dict(getattr(J, make)())


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return path


def test_base_chain_and_overrides(tmp_path):
    """A three-file `_base_` chain (child keys win at every depth), then
    dotted overrides parsed as JSON or kept as strings."""
    _write(tmp_path / "a.json", {"model": {"llm": {"num_layers": 3},
                                           "dtype": "float32"},
                                 "train": {"epochs": 7}})
    sub = tmp_path / "sub"
    sub.mkdir()
    _write(sub / "b.json", {"_base_": "../a.json",
                            "model": {"llm": {"hidden_size": 32}}})
    child = _write(tmp_path / "c.json", {
        "_base_": "sub/b.json", "_comment": "skipped",
        "model": {"sam": {"global_attn_indexes": [1, 3]}},
        "train": {"epochs": 2}})
    pairs = ["model.llm.rope_theta=10.5", "data.nuscenes_root=/x/y",
             "model.bev_hw=[8, 8]"]
    got, want = (C.load(C.VQAConfig, child, pairs),
                 J.load(J.VQAConfig, child, pairs))
    assert C.to_dict(got) == J.to_dict(want)
    assert got.model.llm.num_layers == 3 and got.model.llm.hidden_size == 32
    assert got.train.epochs == 2 and got.model.dtype == "float32"
    assert got.model.sam.global_attn_indexes == (1, 3)   # tuple rule
    assert got.model.llm.rope_theta == 10.5
    assert got.data.nuscenes_root == "/x/y"
    assert C.load_file(child) == J.load_file(child)
    assert C.deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"c": 3}}) == {
        "a": {"b": 1, "c": 3}}


def test_unknown_key_raises_as_in_jax(tmp_path):
    bad = _write(tmp_path / "bad.json", {"model": {"llm": {"layers": 2}}})
    for lib in (C, J):
        with pytest.raises(KeyError, match="unknown config key 'layers'"):
            lib.load(lib.VQAConfig, bad)


def test_yaml_is_refused(tmp_path):
    path = tmp_path / "x.yaml"
    path.write_text("model: {}\n")
    with pytest.raises(ValueError, match="JSON"):
        C.load_file(path)


def test_saved_files_cross_over(tmp_path):
    """A config.json saved by the JAX package reads back in the port, and
    the reverse; both write the same text."""
    cfg = J.override(J.tiny_config(), "model.llm.num_layers", 3)
    J.save(cfg, tmp_path / "jax.json")
    mine = C.load(C.VQAConfig, tmp_path / "jax.json")
    assert C.to_dict(mine) == J.to_dict(cfg)
    C.save(mine, tmp_path / "port.json")
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    assert J.to_dict(J.load(J.VQAConfig, tmp_path / "port.json")) == \
        J.to_dict(cfg)


def test_replace_and_override_copy():
    cfg = C.tiny_config()
    new = C.override(cfg, "model.llm.tie_word_embeddings", False)
    assert new.model.llm.tie_word_embeddings is False
    assert cfg.model.llm.tie_word_embeddings is True
    assert C.replace(cfg, debug_level=2).debug_level == 2


def test_package_keeps_its_old_names():
    """Names the port imported from its single-module config stay."""
    from lvv_tpu_torch.config import (LLMConfig, ModelConfig, SAMConfig,
                                      default_config, q8_scope, tiny_config)
    assert isinstance(q8_scope(), frozenset)
    assert isinstance(tiny_config().model, ModelConfig)
    assert default_config().model.llm == LLMConfig()
    assert SAMConfig().img_size == 1024
