"""The port's slice as a whole against the JAX package, plus its guards.

On the tiny config with one seeded parameter tree shared through
`from_jax_params`, in float32 on the CPU: the prefix embeddings and the
last prefill logits agree with JAX within 1e-4 relative to (1 + |JAX|)
(float32 round-off through ~20 layers; measured ~1e-6), and greedy_generate
gives identical tokens and lengths, with LoRA off and at rank 2. The same
holds for bench.py's serving levers: the int8 decode (packed and unfused)
and quant8 (which the CPU path ignores, as JAX's does off the TPU); the
int8 packs and trees are bit-equal to JAX's.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lvv_tpu.models import greedy_generate as jax_greedy_generate
from lvv_tpu.models.qwen import init_cache as jax_init_cache
from lvv_tpu.models.vqa import VQAModel as JaxVQAModel
from lvv_tpu_torch import (VQAModel, default_config, from_jax_params,
                           greedy_generate, prepare_serving_params,
                           prepare_serving_params_fused, tiny_config)
from lvv_tpu_torch.models.qwen import init_cache
from torch_parity_util import close, inputs, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pairs():
    """rank -> (JAX model, params, port model, cfg), built once per rank."""
    made = {}

    def get(lora_rank):
        if lora_rank not in made:
            jm, params = jax_model_and_params(lora_rank=lora_rank)
            cfg = tiny_config().model
            pm = VQAModel(cfg, dtype=torch.float32, device="cpu",
                          llm_lora_rank=lora_rank, llm_lora_alpha=4.0,
                          clip_lora_rank=lora_rank, clip_lora_alpha=4.0)
            pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
            made[lora_rank] = (jm, params, pm, cfg)
        return made[lora_rank]
    return get


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_slice_matches_jax(pairs, lora_rank):
    """encode_prefix, prefill logits and greedy tokens, batch 2 with a
    right-padded prompt; with LoRA, also an eos the answer produces."""
    jm, params, pm, cfg = pairs(lora_rank)
    x = inputs(cfg, b=2, seed=2)
    x["prompt_len"] = np.array([6, 4], np.int32)
    x["view_valid"][1, 3] = False
    sensors = (x["bev"], x["images"], x["view_valid"])

    want = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, method=JaxVQAModel.encode_prefix))(params, *sensors)
    with torch.no_grad():
        got = pm.encode_prefix(*(torch.as_tensor(a) for a in sensors))
    close(got.numpy(), want, TOL)

    def jax_prefill(p, *a):
        cache = jax_init_cache(jm.cfg.llm, 2, 64)
        return jm.apply({"params": p}, *a, cache,
                        method=JaxVQAModel.prefill)[0]
    want = jax.jit(jax_prefill)(params, *sensors, x["prompt_ids"],
                                x["prompt_len"])
    with torch.no_grad():
        got = pm.prefill(*(torch.as_tensor(a) for a in sensors),
                         torch.as_tensor(x["prompt_ids"]).long(),
                         torch.as_tensor(x["prompt_len"]),
                         init_cache(cfg.llm, 2, 64, dtype=torch.float32,
                                    device="cpu"))
    close(got.numpy(), want, TOL)

    args = (*sensors, x["prompt_ids"], x["prompt_len"])
    j_tok, j_len = jax_greedy_generate(jm, params, *args, max_new_tokens=8,
                                       eos_id=2)
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2   # a non-degenerate answer
    p_tok, p_len = greedy_generate(pm, *args, max_new_tokens=8, eos_id=2)
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
    if not lora_rank:
        return
    # the eos rule: stop at a token the answer really produces
    eos = int(j_tok[0, 2])
    j_tok, j_len = jax_greedy_generate(jm, params, *args, max_new_tokens=8,
                                       eos_id=eos)
    p_tok, p_len = greedy_generate(pm, *args, max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))


def _serving_args(cfg):
    x = inputs(cfg, b=2, seed=2)
    x["prompt_len"] = np.array([6, 4], np.int32)
    return (x["bev"], x["images"], x["view_valid"], x["prompt_ids"],
            x["prompt_len"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lora_rank", [0, 2])
def test_int8_decode_matches_jax(pairs, lora_rank, fused):
    """greedy_generate with the packed int8 decode (prepare_serving_params_
    fused) or the unfused int8 tree (prepare_serving_params): identical
    tokens and lengths to JAX's on the same weights. At rank 0 the two
    decodes also agree with each other (under LoRA they differ by design:
    the pack folds LoRA in before quantizing, the tree keeps it apart)."""
    from lvv_tpu.models.vqa import prepare_serving_params as jprep
    from lvv_tpu.models.vqa import prepare_serving_params_fused as jprep_f
    jm, params, pm, cfg = pairs(lora_rank)
    args = _serving_args(cfg)
    jdec = jprep_f(jm, params) if fused else jprep(params)
    pdec = (prepare_serving_params_fused(pm) if fused
            else prepare_serving_params(pm))
    j_tok, j_len = jax_greedy_generate(jm, params, *args, max_new_tokens=8,
                                       eos_id=2, params_decode=jdec)
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2   # a non-degenerate answer
    p_tok, p_len = greedy_generate(pm, *args, max_new_tokens=8, eos_id=2,
                                   params_decode=pdec)
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
    if lora_rank == 0:
        other = (prepare_serving_params(pm) if fused
                 else prepare_serving_params_fused(pm))
        o_tok, o_len = greedy_generate(pm, *args, max_new_tokens=8,
                                       eos_id=2, params_decode=other)
        assert torch.equal(o_tok, p_tok) and torch.equal(o_len, p_len)


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_int8_packs_bit_equal_jax(pairs, lora_rank):
    """pack_decode_params (LoRA folded in) and quantize_llm_params give the
    JAX package's int8 arrays, scales and packed biases, bit for bit."""
    from lvv_tpu.models.decode_fused import pack_decode_params as jpack
    from lvv_tpu.ops.quant import quantize_llm_params as jquant
    jm, params, pm, cfg = pairs(lora_rank)
    jp = jpack(params["llm"], jm.cfg.llm,
               lora_scaling=4.0 / lora_rank if lora_rank else 1.0)
    pp = prepare_serving_params_fused(pm)["_fused_decode"]
    jt = jquant(params["llm"])
    pt = prepare_serving_params(pm)["llm"]

    def same(a, b):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.dtype == torch.from_numpy(np.array(a)).dtype

    for i in range(cfg.llm.num_layers):
        for key in ("qkv", "o", "gateup", "down"):
            for f in ("q", "s"):
                same(jp["layers"][i][key][f], pp["layers"][i][key][f])
        same(jp["layers"][i]["qkv"]["b"], pp["layers"][i]["qkv"]["b"])
        assert "b" not in pp["layers"][i]["gateup"]
        for block in ("attn", "mlp"):
            tree = pt[f"layer_{i}"][block]
            assert set(tree) == {k for k, v in jt[f"layer_{i}"][block].items()
                                 if isinstance(v["kernel"], dict)}
            for name, kern in tree.items():
                for f in ("q", "s"):
                    same(jt[f"layer_{i}"][block][name]["kernel"][f], kern[f])
    for f in ("q", "s"):
        same(jp["unembed"][f], pp["unembed"][f])
        same(jt["unembed_q"][f], pt["unembed_q"][f])


def test_packed_decode_needs_tied_embeddings(pairs):
    """The pack's unembed is the quantized embedding table: an untied
    config raises a ValueError instead of asserting."""
    import dataclasses
    from lvv_tpu_torch.models.decode_fused import pack_decode_params
    _, _, pm, cfg = pairs(0)
    llm = pm.llm
    untied = dataclasses.replace(cfg.llm, tie_word_embeddings=False)
    saved = llm.cfg
    llm.cfg = untied
    try:
        with pytest.raises(ValueError, match="tied"):
            pack_decode_params(llm)
    finally:
        llm.cfg = saved


def test_quant8_serving_config_matches_jax_on_cpu(pairs):
    """bench.py's serving configuration (quant8 on SAM and CLIP, the packed
    int8 decode) on the CPU: both stacks take their float MLP paths there,
    so the tokens equal JAX's from the same configuration."""
    import dataclasses
    from lvv_tpu.models.vqa import prepare_serving_params_fused as jprep_f
    jm, params, _, cfg = pairs(0)
    q8 = dataclasses.replace(
        cfg, sam=dataclasses.replace(cfg.sam, quant8=True),
        clip=dataclasses.replace(cfg.clip, quant8=True))
    jq8 = JaxVQAModel(dataclasses.replace(
        jm.cfg, sam=dataclasses.replace(jm.cfg.sam, quant8=True),
        clip=dataclasses.replace(jm.cfg.clip, quant8=True)))
    pm = VQAModel(q8, dtype=torch.float32, device="cpu")
    pm.load_state_dict(from_jax_params(params, q8, device="cpu"))
    args = _serving_args(cfg)
    j_tok, j_len = jax_greedy_generate(jq8, params, *args, max_new_tokens=8,
                                       eos_id=2,
                                       params_decode=jprep_f(jq8, params))
    p_tok, p_len = greedy_generate(pm, *args, max_new_tokens=8, eos_id=2,
                                   params_decode=prepare_serving_params_fused(
                                       pm))
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))


def test_converter_places_every_leaf(pairs):
    """Every JAX leaf lands on a port parameter (conv kernels as OIHW) and
    an unknown or misshaped leaf raises."""
    _, params, _, cfg = pairs(2)
    sd = from_jax_params(params, cfg, device="cpu")
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    hwio = params["vat_lidar"]["dw_refine"]["kernel"]           # (3,3,1,C)
    np.testing.assert_array_equal(
        sd["vat_lidar.dw_refine.kernel"].numpy(), hwio.transpose(3, 2, 0, 1))
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        from_jax_params(extra, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["adapter"]["view_embed"] = np.zeros((5, 128), np.float32)
    with pytest.raises(ValueError):
        from_jax_params(bad, cfg, device="cpu")


def test_config_copy_matches_jax():
    """The port's own config copy has the JAX package's fields and values
    for every section it keeps."""
    from lvv_tpu.config import default_config as jdefault
    from lvv_tpu.config import tiny_config as jtiny
    for mine, theirs in ((tiny_config(), jtiny()),
                         (default_config(), jdefault())):
        for sec in ("sam", "clip", "projector", "adapter", "vat_lidar",
                    "vat_vision", "llm", "llm_lora", "clip_lora"):
            a, b = getattr(mine.model, sec), getattr(theirs.model, sec)
            assert vars(a) == {k: getattr(b, k) for k in vars(a)}, sec
        for k in ("prefix_scale", "bev_channels", "bev_hw", "views_chunk"):
            assert getattr(mine.model, k) == getattr(theirs.model, k)


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """With no card and no device given, entry points raise instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config().model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQAModel(cfg, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({}, cfg)


def test_port_imports_no_jax():
    """Importing every module of the port (its `tools` CLIs included), and
    chip_smoke, loads nothing of jax, flax or lvv_tpu; modules that need
    PIL or transformers import them only inside the functions that use
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'lvv_tpu'):\n"
        "            raise ImportError('port imported ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lvv_tpu_torch\n"
        "for m in pkgutil.walk_packages(lvv_tpu_torch.__path__, "
        "'lvv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'lvv_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('lvv_tpu_torch')]))"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """chip_smoke exits non-zero and prints no result without a card, and
    alone in a directory without the package."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
