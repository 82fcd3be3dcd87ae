"""The port's checkpoint converters against the JAX package's.

For each converter, a seeded random state dict with the reference's key
names at the tiny config's shapes goes through (a) the JAX converter,
`merge_params` onto a JAX VQAModel tree and `from_jax_params`, and (b) the
port's converter and `merge` onto the port's state_dict of the same tree.
The two state_dicts must be bit-equal (both only move and transpose
float32 values). The converters' own outputs are also compared key for
key (conv kernels HWIO in JAX, OIHW in the port), and the transformers
renamers must give the same dicts.
"""
import numpy as np
import pytest
import torch

from lvv_tpu import convert as JC
from lvv_tpu.convert.qwen_hf import convert_peft_lora as jax_peft
from lvv_tpu.convert.qwen_hf import convert_qwen_state as jax_qwen
from lvv_tpu_torch import convert as PC
from lvv_tpu_torch import from_jax_params, tiny_config
from torch_parity_util import jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def base():
    """(JAX params with LoRA rank 2, the port's state_dict of them, cfg)."""
    _, params = jax_model_and_params(lora_rank=2)
    cfg = tiny_config().model
    return params, from_jax_params(params, cfg, device="cpu"), cfg


class _Ref:
    """Builds a reference-named state dict whose shapes are read off the
    port's parameters."""

    def __init__(self, state, seed):
        self.p, self.sd = state, {}
        self.rng = np.random.default_rng(seed)

    def rand(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)

    def raw(self, ref, port, shape=None):
        self.sd[ref] = self.rand(shape or self.p[port].shape)

    def lin(self, ref, port, bias=True):
        self.sd[ref + ".weight"] = self.rand(
            self.p[port + ".kernel"].shape[::-1])
        if bias:
            self.sd[ref + ".bias"] = self.rand(self.p[port + ".bias"].shape)

    def ln(self, ref, port):
        self.sd[ref + ".weight"] = self.rand(self.p[port + ".scale"].shape)
        self.sd[ref + ".bias"] = self.rand(self.p[port + ".bias"].shape)

    def mha(self, ref, port):
        d = self.p[port + ".q_proj.kernel"].shape[0]
        self.sd[ref + ".in_proj_weight"] = self.rand((3 * d, d))
        self.sd[ref + ".in_proj_bias"] = self.rand((3 * d,))
        self.lin(ref + ".out_proj", port + ".o_proj")


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _both(base, prefix, jax_path, jax_out, port_out, *more):
    """JAX: merge_params of `jax_out` (then of each of `more`) at
    `jax_path` of the tree, then from_jax_params; port: merge at `prefix`.
    Returns both state_dicts."""
    params, state, cfg = base
    tree = dict(params)
    node = tree
    for k in jax_path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    for out in (jax_out, *more):
        node[jax_path[-1]] = JC.merge_params(node[jax_path[-1]], out)
    return (PC.merge(state, port_out, prefix),
            from_jax_params(tree, cfg, device="cpu"))


def _flat_jax(out):
    """A JAX converter's output flattened to the port's key and layout."""
    return {k: v.permute(3, 2, 0, 1).contiguous()
            if v.ndim == 4 and k.endswith("kernel") else v
            for k, v in PC.tensors(out).items()}


def test_sam(base):
    _, state, cfg = base
    r = _Ref({k[len("deepencoder.sam."):]: v for k, v in state.items()
              if k.startswith("deepencoder.sam.")}, 0)
    pre = "image_encoder."
    r.raw(pre + "patch_embed.proj.weight", "patch_embed.kernel")
    r.raw(pre + "patch_embed.proj.bias", "patch_embed.bias")
    r.raw(pre + "pos_embed", "pos_embed")
    for i in range(cfg.sam.depth):
        b, p = f"{pre}blocks.{i}.", f"block_{i}."
        r.ln(b + "norm1", p + "ln1")
        r.ln(b + "norm2", p + "ln2")
        r.lin(b + "attn.qkv", p + "attn.qkv")
        r.lin(b + "attn.proj", p + "attn.proj")
        r.raw(b + "attn.rel_pos_h", p + "attn.rel_pos_h")
        r.raw(b + "attn.rel_pos_w", p + "attn.rel_pos_w")
        r.lin(b + "mlp.lin1", p + "mlp.fc1")
        r.lin(b + "mlp.lin2", p + "mlp.fc2")
    for i, name in ((0, "neck_conv1"), (2, "neck_conv2")):
        r.raw(f"{pre}neck.{i}.weight", name + ".kernel")
    r.ln(pre + "neck.1", "neck_ln1")
    r.ln(pre + "neck.3", "neck_ln2")
    r.raw(pre + "net_2.weight", "net_2.kernel")   # net_3 absent: kept
    got_out = PC.convert_sam_state(r.sd, depth=cfg.sam.depth)
    jax_out = JC.convert_sam_state(r.sd, depth=cfg.sam.depth)
    _same(got_out, _flat_jax(jax_out))
    assert "net_3.kernel" not in got_out
    _same(*_both(base, "deepencoder.sam.", ("deepencoder", "sam"), jax_out,
                 got_out))


def test_sam_renamer():
    rng = np.random.default_rng(1)
    keys = ["vision_encoder.patch_embed.projection.weight",
            "vision_encoder.layers.0.layer_norm1.weight",
            "vision_encoder.layers.1.layer_norm2.bias",
            "vision_encoder.layers.1.attn.qkv.weight",
            "vision_encoder.neck.conv1.weight",
            "vision_encoder.neck.layer_norm1.bias",
            "vision_encoder.neck.conv2.weight",
            "vision_encoder.neck.layer_norm2.weight",
            "vision_encoder.pos_embed"]
    sd = {k: rng.standard_normal(3).astype(np.float32) for k in keys}
    got, want = PC.from_transformers_sam(sd), JC.from_transformers_sam(sd)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("tied", [True, False])
def test_qwen_and_peft(base, tied):
    """The HF key space (with 4 mean-initialised special-token rows) and a
    PEFT LoRA dict, merged onto the LLM; untied, the lm_head converts too
    (compared at the converter: the tiny tree is tied)."""
    _, state, cfg = base
    c = cfg.llm
    r = _Ref({k[len("llm."):]: v for k, v in state.items()
              if k.startswith("llm.")}, 2)
    r.raw("model.embed_tokens.weight", None, (c.vocab_size, c.hidden_size))
    r.raw("model.norm.weight", "final_ln.scale")
    for i in range(c.num_layers):
        b, p = f"model.layers.{i}.", f"layer_{i}."
        r.raw(b + "input_layernorm.weight", p + "input_ln.scale")
        r.raw(b + "post_attention_layernorm.weight", p + "post_attn_ln.scale")
        for n in ("q_proj", "k_proj", "v_proj"):
            r.lin(b + "self_attn." + n, p + "attn." + n)
        r.lin(b + "self_attn.o_proj", p + "attn.o_proj", bias=False)
        for n in ("gate_proj", "up_proj", "down_proj"):
            r.lin(b + "mlp." + n, p + "mlp." + n, bias=False)
    if not tied:
        r.raw("lm_head.weight", None, (c.vocab_size, c.hidden_size))
    kw = dict(tie_word_embeddings=tied, extra_tokens=4)
    got_out = PC.convert_qwen_state(r.sd, c.num_layers, **kw)
    jax_out = jax_qwen(r.sd, c.num_layers, **kw)
    _same(got_out, _flat_jax(jax_out))
    assert ("lm_head.kernel" in got_out) != tied
    if not tied:
        return
    peft = {}
    for i in range(c.num_layers):
        for n in ("q_proj", "v_proj"):
            k = f"base_model.model.model.layers.{i}.self_attn.{n}."
            peft[k + "lora_A.weight"] = r.rand(
                state[f"llm.layer_{i}.attn.{n}.lora_a"].shape[::-1])
            peft[k + "lora_B.weight"] = r.rand(
                state[f"llm.layer_{i}.attn.{n}.lora_b"].shape[::-1])
    peft["base_model.model.lm_head.weight"] = r.rand((2, 2))   # skipped
    lora_out = PC.convert_peft_lora(peft, c.num_layers)
    jax_lora = jax_peft(peft, c.num_layers)
    _same(lora_out, _flat_jax(jax_lora))
    _same(*_both(base, "llm.", ("llm",), jax_out, {**got_out, **lora_out},
                 jax_lora))


def test_clip_and_renamer():
    """OpenCLIP's visual.* onto a CLIP tower with its own patcher (the VQA
    stack's tower has none, in either package); transformers naming
    renamed as JAX renames it."""
    import jax
    from lvv_tpu.models.clip import CLIPVisionTower as JaxCLIP
    from lvv_tpu_torch.models.clip import CLIPVisionTower
    kw = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
              num_heads=2, intermediate_size=128)
    pix = np.zeros((1, 3, 32, 32), np.float32)
    init = jax.tree_util.tree_map(np.asarray, JaxCLIP(**kw).init(
        jax.random.PRNGKey(0), pixel_values=pix)["params"])
    tower = CLIPVisionTower(**kw, patcher=True, dtype=torch.float32,
                            device="cpu")
    state = _flat_jax(init)
    tower.load_state_dict(state)
    r = _Ref(state, 3)
    r.raw("visual.class_embedding", "cls_token")
    r.raw("visual.positional_embedding", "pos_embed")
    r.raw("visual.conv1.weight", "patch_embed.kernel")
    r.ln("visual.ln_pre", "pre_ln")
    for i in range(2):
        b, p = f"visual.transformer.resblocks.{i}.", f"layer_{i}."
        r.ln(b + "ln_1", p + "ln1")
        r.ln(b + "ln_2", p + "ln2")
        r.mha(b + "attn", p + "attn")
        r.lin(b + "mlp.c_fc", p + "fc1")
        r.lin(b + "mlp.c_proj", p + "fc2")
    got_out = PC.convert_clip_state(r.sd, num_layers=2)
    jax_out = JC.convert_clip_state(r.sd, num_layers=2)
    _same(got_out, _flat_jax(jax_out))
    _same(PC.merge(tower.state_dict(), got_out),
          _flat_jax(JC.merge_params(init, jax_out)))
    hf = {"vision_model.embeddings.class_embedding": r.rand((4,)),
          "vision_model.pre_layrnorm.weight": r.rand((4,))}
    for n in ("q", "k", "v"):
        for part, shape in (("weight", (4, 4)), ("bias", (4,))):
            hf[f"vision_model.encoder.layers.0.self_attn.{n}_proj.{part}"] = \
                r.rand(shape)
    hf["vision_model.encoder.layers.0.mlp.fc1.weight"] = r.rand((8, 4))
    got, want = PC.from_transformers_clip(hf), JC.from_transformers_clip(hf)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _vat_blocks(r, n):
    for i in range(n):
        b, p = f"blocks.{i}.", f"block_{i}."
        r.ln(b + "sa_ln", p + "ln_self")
        r.mha(b + "sa", p + "self_attn")
        r.ln(b + "ca_ln", p + "ln_cross_q")
        r.mha(b + "ca", p + "cross_attn")
        r.ln(b + "mlp_ln", p + "ln_mlp")
        r.lin(b + "mlp.0", p + "mlp.fc1")
        r.lin(b + "mlp.3", p + "mlp.fc2")


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def test_vat_lidar(base):
    _, state, cfg = base
    r = _Ref(_sub(state, "vat_lidar."), 4)
    r.raw("refine.0.weight", "dw_refine.kernel")
    r.raw("refine.0.bias", "dw_refine.bias")
    cin, d = r.p["in_proj.kernel"].shape
    r.raw("proj.weight", None, (d, cin, 1, 1))
    r.raw("proj.bias", "in_proj.bias")
    r.ln("norm_tokens", "in_ln")
    r.lin("geo_mlp.0", "pe_fc1")
    r.lin("geo_mlp.2", "pe_fc2")
    r.raw("view_embed", "sector_embed")
    r.raw("query", "queries")
    _vat_blocks(r, cfg.vat_lidar.n_blocks)
    r.ln("final_ln", "final_ln")
    r.ln("post.0", "post_ln")
    r.lin("post.1", "post_fc1")
    r.lin("post.4", "post_fc2")
    got_out = PC.convert_vat_lidar_state(r.sd)
    jax_out = JC.convert_vat_lidar_state(r.sd)
    _same(got_out, _flat_jax(jax_out))
    _same(*_both(base, "vat_lidar.", ("vat_lidar",), jax_out, got_out))


def test_vat_vision_and_adapter(base):
    _, state, cfg = base
    r = _Ref(_sub(state, "vat_vision."), 5)
    r.raw("query", "queries")
    r.sd["view_query_embed"] = None      # n_q % 6 != 0: no view embedding
    _vat_blocks(r, cfg.vat_vision.n_blocks)
    r.ln("final_ln", "final_ln")
    r.ln("post.0", "post_ln")
    r.lin("post.1", "post_fc1")
    r.lin("post.4", "post_fc2")
    r.ln("proj.0", "proj_ln")
    r.lin("proj.1", "proj_fc1")
    r.lin("proj.4", "proj_fc2")
    r.ln("proj.5", "out_ln")
    got_out = PC.convert_vat_vision_state(r.sd)
    jax_out = JC.convert_vat_vision_state(r.sd)
    _same(got_out, _flat_jax(jax_out))
    _same(*_both(base, "vat_vision.", ("vat_vision",), jax_out, got_out))
    a = _Ref(_sub(state, "adapter."), 6)
    a.ln("norm", "ln")
    a.raw("view_embed", "view_embed")
    got_out = PC.convert_vision_adapter_state(a.sd)
    jax_out = JC.convert_vision_adapter_state(a.sd)
    _same(*_both(base, "adapter.", ("adapter",), jax_out, got_out))


@pytest.mark.parametrize("kind", ["identity", "linear", "mlp_gelu",
                                  "normlayer_downsample_mlp_gelu"])
def test_projector(base, kind):
    """`layers` as a Linear, or a Sequential of Linears (GELU slots between,
    a LayerNorm first for the normlayer kind); the linear kind merged onto
    the model."""
    rng = np.random.default_rng(7)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "linear":
        sd = {"layers.weight": rand(128, 128), "layers.bias": rand(128)}
    elif kind == "mlp_gelu":
        sd = {"layers.0.weight": rand(32, 128), "layers.0.bias": rand(32),
              "layers.2.weight": rand(16, 32), "layers.2.bias": rand(16)}
    else:
        sd = {"layers.0.weight": rand(128), "layers.0.bias": rand(128),
              "layers.1.weight": rand(32, 512), "layers.1.bias": rand(32),
              "layers.3.weight": rand(16, 32), "layers.3.bias": rand(16)}
    got_out = PC.convert_projector_state(sd, kind)
    jax_out = JC.convert_projector_state(sd, kind)
    _same(got_out, _flat_jax(jax_out))
    if kind == "linear":
        _same(*_both(base, "deepencoder.projector.",
                     ("deepencoder", "projector"), jax_out, got_out))
    with pytest.raises(ValueError, match="no converter"):
        PC.convert_projector_state(sd, "low_high_split_mlp_gelu")


def test_merge_checks_keys_and_shapes(base):
    _, state, _ = base
    with pytest.raises(KeyError, match="not a model parameter"):
        PC.merge(state, {"nope.kernel": torch.zeros(1)}, "llm.")
    with pytest.raises(ValueError, match="shape mismatch"):
        PC.merge(state, {"final_ln.scale": torch.zeros(3)}, "llm.")
    out = PC.merge(state, {"final_ln.scale": torch.ones(64,
                                                        dtype=torch.float64)},
                   "llm.")
    assert out["llm.final_ln.scale"].dtype == torch.float32
    assert out is not state
