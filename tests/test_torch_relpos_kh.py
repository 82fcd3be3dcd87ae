"""K-h, the head-split rel-pos attention, in the port against the JAX package.

SAM's global layers at grids that fail the head-packed test (80x80 at
1280², or any ragged grid) run JAX's `flash_attention_relpos` on head-split
q, k, v and bf16-rounded q·R tables. The port's plain version (what its
wrapper computes on a CPU tensor) is held to the Pallas kernels run in
interpret mode on the same seeded inputs, in each of the wrapper's three
forms (streaming, fused, small) and both arms (float, int8 p@v); then
SAMAttention's dispatch, a SAM encoder whose global layer takes K-h, and
the tokens of a tiny VQA model built around it. On the CPU the port takes
its plain paths, so the model tests let CPU tensors reach the kernel
dispatch by patching the two eligibility tests, while JAX runs under
`fused_mlp.set_interpret(True)`. Each tolerance is stated where it is used.
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu_torch.models import sam as tsam
from lvv_tpu_torch.ops import attention as tattn
from lvv_tpu_torch.ops import fused_mlp as tmlp
from torch_parity_util import _leaf, close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

# The plain version against interpret-mode Pallas in float32: the same
# logits summed in another order (measured 1.1e-6 at most): 1e-5 relative
# to (1 + |JAX|). The int8 arm: a p8 on a rounding boundary may land one
# step apart, which moves an output by at most max|v| / 127; over the whole
# output the relative L2 stays under 1e-3 (measured 5.3e-5 at most, with a
# few flips at 80x80 and 64x64, max abs error 4.3e-4).
TOL = 1e-5
PV8_REL_L2 = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _operands(b, heads, gh, gw, d, seed):
    """q, k, v [B, H, S, d] and tables q_rh [.., gh], q_rw [.., gw]: unit
    normal, float32."""
    rng = np.random.default_rng(seed)
    s = gh * gw
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, heads, s, d), (b, heads, s, d), (b, heads, s, d),
        (b, heads, s, gh), (b, heads, s, gw))]


def _dense(q, k, v, q_rh, q_rw, scale, grid_w):
    """softmax over every key, float64: the function without K-h's tiles."""
    s = q.shape[2]
    cols = np.arange(s)
    sc = (np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * scale
          + q_rh[..., cols // grid_w] + q_rw[..., cols % grid_w])
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _both(ops, **kw):
    want = np.asarray(jattn.flash_attention_relpos(
        *(jnp.asarray(x) for x in ops), interpret=True, **kw))
    got = tattn.flash_attention_relpos(*(_t(x) for x in ops), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    return got.numpy(), want


def _check(got, want, quant8, vmax):
    if quant8:
        err = np.abs(got - want)
        assert np.all(err <= vmax / 127 + TOL * (1 + np.abs(want))), (
            float(err.max()))
        assert _rel_l2(got, want) <= PV8_REL_L2
    else:
        close(got, want, TOL)


# ------------------------------------------------------------- op level --

@pytest.mark.parametrize("quant8", [False, True])
@pytest.mark.parametrize("b,heads,gh,gw", [(2, 2, 24, 40), (1, 1, 80, 80),
                                           (1, 1, 40, 40)])
def test_streaming_form_matches_pallas(quant8, b, heads, gh, gw):
    """The streaming form at SAM's tiles (4096 / 1024): a ragged 24x40 grid
    (one partial kv tile), the 80x80 grid of 1280² (6400 tokens in 7 tiles,
    the last partial) and 40x40 (640²), where the JAX wrapper pads 1600
    tokens to 1664 and walks one kv tile of 1024, so keys 1024-1599 never
    count. The port keeps that: it matches JAX, and both stand far from a
    softmax over every key (measured 1.005), where the other grids agree
    with it in the float arm."""
    ops = _operands(b, heads, gh, gw, 64, seed=gh + gw)
    kw = dict(scale=0.125, grid_w=gw, block_q=4096, block_k=1024,
              quant8=quant8)
    s_pad, tile, kv_end = tattn.kh_tiles(gh * gw, 4096, 1024)
    assert tile == 1024 and kv_end == (1024 if gh == gw == 40 else gh * gw)
    got, want = _both(ops, **kw)
    _check(got, want, quant8, np.abs(ops[2]).max())
    far = np.abs(want - _dense(*ops, 0.125, gw)).max()
    if gh == gw == 40:
        assert far > 0.5, far
    elif not quant8:
        assert far < 1e-4, far


@pytest.mark.parametrize("quant8", [False, True])
def test_fused_form_matches_pallas(quant8):
    """The fused form at a 64x64 grid (d + gh = 128, S = 4096 on tiles of
    4096 / 1024, as benchmarks/gattn_fused_micro.py times it): base 2, the
    height bias inside the depth-128 product."""
    ops = _operands(1, 1, 64, 64, 64, seed=7)
    assert tattn._fused_ok(4096, 64, 64, 64, 4096, 1024)
    got, want = _both(ops, scale=0.125, grid_w=64, block_q=4096,
                      block_k=1024, quant8=quant8)
    _check(got, want, quant8, np.abs(ops[2]).max())


def test_fused_operands_are_jax_glue():
    """q_aug, k_aug and qrw as the JAX wrapper builds them (attention.py:
    630-640), zero-padded to depth 128; the padding adds nothing."""
    q, k, _, q_rh, q_rw = _operands(1, 2, 8, 64, 64, seed=8)
    q_aug, k_aug, qrw = tattn.fused_operands(
        *(_t(x).to(torch.bfloat16) for x in (q, k, q_rh, q_rw)), scale=0.125,
        grid_w=64)
    assert q_aug.shape == k_aug.shape == (1, 2, 512, 128)
    assert q_aug.dtype == torch.bfloat16
    jq, jk, jrh, jrw = (jnp.asarray(x).astype(jnp.bfloat16)
                        for x in (q, k, q_rh, q_rw))
    f32 = jnp.float32
    want_q = jnp.concatenate([jq.astype(f32) * (0.125 * math.log2(math.e)),
                              jrh.astype(f32) * math.log2(math.e)],
                             -1).astype(jnp.bfloat16)
    np.testing.assert_array_equal(q_aug[..., :72].float().numpy(),
                                  np.asarray(want_q.astype(f32)))
    np.testing.assert_array_equal(k_aug[..., 64:72].float().numpy().argmax(
        -1), np.broadcast_to(np.arange(512) // 64, (1, 2, 512)))
    assert not q_aug[..., 72:].any() and not k_aug[..., 72:].any()
    np.testing.assert_array_equal(
        qrw.float().numpy(), np.asarray((jrw.astype(f32) * math.log2(
            math.e)).astype(jnp.bfloat16).astype(f32)))


def test_small_form_matches_pallas():
    """The small form: 14x14 windows (196 tokens in one 256-wide tile, as
    benchmarks/sam_block_bisect.py feeds it) with p divided by its row sum
    before p@v, and no int8 arm: quant8 changes nothing there, as in JAX."""
    ops = _operands(3, 2, 14, 14, 64, seed=9)
    kw = dict(scale=0.125, grid_w=14, block_q=256, block_k=256)
    assert tattn.kh_tiles(196, 256, 256)[0] <= 512
    got, want = _both(ops, **kw)
    close(got, want, TOL)
    got8, want8 = _both(ops, quant8=True, **kw)
    np.testing.assert_array_equal(got8, got)
    np.testing.assert_array_equal(want8, want)


# ------------------------------------------------------------- the model --

def _sam_attention(h, w, dim, heads, seed, dtype=torch.float32, quant8=False):
    attn = tsam.SAMAttention(dim, heads, True, (h, w), quant8, dtype=dtype,
                             device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            x = _leaf(name.replace(".", "/"), tuple(p.shape), rng)
            p.copy_(torch.from_numpy(x))
    return attn


def _port_kernel_paths(monkeypatch):
    """Let CPU tensors take the port's kernel dispatch (the plain versions
    run where the kernels would), as JAX in interpret mode does."""
    monkeypatch.setattr(tsam, "_relpos_kernel_ok",
                        lambda x, hd, h, w: hd in (64, 128))
    monkeypatch.setattr(tmlp, "kernel_ok",
                        lambda x, c, h: c % 128 == 0 and h % 128 == 0)


def _record(monkeypatch):
    calls = []
    for name in ("flash_attention_relpos", "relpos_attention",
                 "relpos_attention_qk8"):
        fn = getattr(tsam, name)
        monkeypatch.setattr(tsam, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append((_n, a[0].shape[-2] if _n == "flash_attention_relpos"
                          else a[0].shape[1], kw.get("quant8",
                                                     kw.get("pv_int8")))),
            _f(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("scope", ["mlp", "mlp,attn", "mlp,attn,qk"])
def test_dispatch_sends_non_head_packed_grids_to_kh(monkeypatch, scope):
    """SAMAttention's three-way dispatch, as sam.py:139-231: the 80x80 and
    24x40 grids fail the head-packed test and go to flash_attention_relpos
    (int8 p@v under "attn"; "qk" applies only to head-packed grids), the
    64x64 grid still goes to relpos_attention (K-d / K-d8) or, under "qk",
    to relpos_attention_qk8, and a 14x14 window to relpos_attention without
    int8."""
    _port_kernel_paths(monkeypatch)
    calls = _record(monkeypatch)
    monkeypatch.setenv("LVV_Q8_SCOPE", scope)
    attn8 = "attn" in scope
    want = {(80, 80): ("flash_attention_relpos", 6400, attn8),
            (24, 40): ("flash_attention_relpos", 960, attn8),
            (64, 64): (("relpos_attention_qk8", 4096, None) if "qk" in scope
                       else ("relpos_attention", 4096, attn8)),
            (14, 14): ("relpos_attention", 196, None)}
    for (h, w), call in want.items():
        attn = _sam_attention(h, w, 64, 1, seed=h + w, quant8=True)
        calls.clear()
        with torch.no_grad():
            out = attn(_t(np.random.default_rng(0).standard_normal(
                (1, h, w, 64)).astype(np.float32)))
        assert out.shape == (1, h, w, 64)
        assert calls == [call], (h, w, calls)


@pytest.mark.parametrize("quant8", [False, True])
def test_bf16_tables_are_rounded_as_in_jax(quant8):
    """In bf16 the port's K-h path computes JAX's function: q·Rh and q·Rw
    in fp32 from the bf16 operands, rounded to bf16, then the base-e
    streaming softmax. Against interpret-mode Pallas (the same glue as
    sam.py:208-228) at a 24x40 grid, 2 heads of 64, few bf16 outputs differ
    (measured 0.03% in the float arm, 0.2% in the int8 arm, where a p8 on a
    boundary may flip), each within 2 ulps of (|JAX| + rms(JAX)) (plus one
    p8 step in the int8 arm), and the relative L2 is 2.3e-5 / 1.8e-4. K-d's
    function (fp32 tables inside the kernel, base 2), which the port ran at
    these grids before, differs in most outputs (68% / 82%), by 5.7e-3 /
    1.1e-2 relative L2: the rounding of the tables."""
    gh, gw, heads, d = 24, 40, 2, 64
    s, c = gh * gw, heads * d
    rng = np.random.default_rng(11)
    qkv = jnp.asarray(rng.standard_normal((2, s, 3 * c)),
                      jnp.float32).astype(jnp.bfloat16)
    rh = jnp.asarray(0.2 * rng.standard_normal((gh, gh, d)),
                     jnp.float32).astype(jnp.bfloat16)
    rw = jnp.asarray(0.2 * rng.standard_normal((gw, gw, d)),
                     jnp.float32).astype(jnp.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(2, s, heads, d).transpose(
        0, 2, 1, 3) for i in range(3))
    qr = q.reshape(2, heads, gh, gw, d)
    q_rh = jnp.einsum("bnhwc,hkc->bnhwk", qr, rh,
                      preferred_element_type=jnp.float32).reshape(2, heads,
                                                                  s, gh)
    q_rw = jnp.einsum("bnhwc,wkc->bnhwk", qr, rw,
                      preferred_element_type=jnp.float32).reshape(2, heads,
                                                                  s, gw)
    want = jattn.flash_attention_relpos(
        q, k, v, q_rh.astype(jnp.bfloat16), q_rw.astype(jnp.bfloat16),
        scale=0.125, grid_w=gw, block_q=4096, block_k=1024, quant8=quant8,
        interpret=True)
    want = np.asarray(want.transpose(0, 2, 1, 3).reshape(2, s, c).astype(
        jnp.float32))
    tq, th, tw = (_t(x.astype(jnp.float32)).to(torch.bfloat16)
                  for x in (qkv, rh, rw))
    got = tsam._kh_attention(tq, th, tw, heads, 0.125, gh, gw, quant8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    step = np.abs(np.asarray(v.astype(jnp.float32))).max() / 127
    bound = 2 ** -7 * (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    assert np.all(np.abs(got - want) <= bound + (step if quant8 else 0.0))
    assert (got != want).mean() < (1 / 100 if quant8 else 1 / 200)
    assert _rel_l2(got, want) <= (1e-3 if quant8 else 1e-4)
    old = tattn.relpos_attention(tq, th, tw, heads=heads, scale=0.125,
                                 pv_int8=quant8, pv_group=1024)
    old = old.float().numpy()
    assert (old != want).mean() > 0.5 and _rel_l2(old, want) > 2e-3


def test_resample_abs_pos_upsamples_as_jax():
    """CLIP's position table at 1280²: 16x16 -> 20x20 (bicubic upsampling,
    no antialiasing), and a 4x4 -> 6x6 table like the tiny model's here,
    against jax.image.resize (float32 round-off: 1e-5 relative)."""
    from lvv_tpu.models.clip import resample_abs_pos as jres
    from lvv_tpu_torch.models.clip import resample_abs_pos as tres
    rng = np.random.default_rng(12)
    for side, tgt in ((16, 20), (4, 6)):
        pos = rng.standard_normal((1 + side * side, 64)).astype(np.float32)
        got = tres(_t(pos), tgt)
        assert got.shape == (1 + tgt * tgt, 64)
        close(got.numpy(), np.asarray(jres(jnp.asarray(pos), tgt)), 1e-5)


# ------------------------------------------ a SAM encoder and a VQA model --

# img 192, patch 8: a 24x24 grid (576 tokens) whose global layer fails the
# head-packed test, so it takes K-h's streaming form with one 640-wide kv
# tile; the windowed layer pads 24 to 28 (2x2 windows of 14).
SAM_KW = dict(img_size=192, patch_size=8, embed_dim=128, depth=2,
              num_heads=2, out_chans=16, window_size=14,
              global_attn_indexes=(1,), vary_dims=(32, 64))


@pytest.fixture(scope="module")
def vqa_pair():
    """(JAX VQAModel, params, the port's model loaded through
    from_jax_params, cfg): the tiny config with SAM_KW and quant8 on SAM."""
    from lvv_tpu.config import tiny_config as jax_tiny_config
    from lvv_tpu.models import VQABatch
    from lvv_tpu.models import VQAModel as JaxVQAModel
    from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
    jcfg = jax_tiny_config().model
    jcfg = dataclasses.replace(jcfg, sam=dataclasses.replace(
        jcfg.sam, **SAM_KW, quant8=True))
    batch = VQABatch(
        bev=jnp.zeros((1, jcfg.bev_channels, *jcfg.bev_hw)),
        images=jnp.zeros((1, 6, 3, 192, 192)),
        view_valid=jnp.ones((1, 6), bool),
        text_ids=jnp.zeros((1, 4), jnp.int32),
        text_len=jnp.full((1,), 4, jnp.int32),
        labels=jnp.full((1, 4), -100, jnp.int32),
        use_vision=jnp.asarray(True), use_lidar=jnp.asarray(True))
    jm = JaxVQAModel(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf("/".join(k.key for k in p), s.shape, rng), shapes)
    cfg = tiny_config().model
    cfg = dataclasses.replace(cfg, sam=dataclasses.replace(
        cfg.sam, **SAM_KW, quant8=True))
    pm = VQAModel(cfg, dtype=torch.float32, device="cpu")
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    return jm, params, pm, cfg


@pytest.mark.parametrize("scope", ["mlp", "mlp,dense,attn"])
def test_sam_encoder_through_kh_matches_jax(vqa_pair, monkeypatch, scope):
    """The SAM encoder at a 24x24 grid under two scopes, JAX with every
    Pallas kernel in interpret mode, the port through K-h's plain version
    (its global layer calls flash_attention_relpos, with int8 p@v under
    "attn"). The int8 sub-paths may flip a value on a rounding boundary on
    one side only, and through two blocks such flips compound (a flip moves
    a row maximum), so the rule is statistical, as for the other scopes:
    relative L2 within 5e-3 (measured 6.0e-4 with "mlp", 4.1e-3 with
    "mlp,dense,attn") and elementwise within 5e-2 relative to (1 + |JAX|)
    (measured 1.5e-2 on outputs up to 2.8)."""
    from lvv_tpu.models.sam import SAMImageEncoder as JaxSAM
    _, params, pm, _ = vqa_pair
    img = np.random.default_rng(14).uniform(-1, 1, (1, 3, 192, 192)).astype(
        np.float32)
    monkeypatch.setenv("LVV_Q8_SCOPE", scope)
    jmlp.set_interpret(True)
    try:
        want = np.asarray(JaxSAM(**SAM_KW, quant8=True).apply(
            {"params": params["deepencoder"]["sam"]}, jnp.asarray(img)))
    finally:
        jmlp.set_interpret(False)
    _port_kernel_paths(monkeypatch)
    calls = _record(monkeypatch)
    with torch.no_grad():
        got = pm.deepencoder.sam(_t(img))
    assert calls == [("relpos_attention", 196, None),
                     ("flash_attention_relpos", 576, "attn" in scope)]
    close(got, want, 5e-2)
    assert _rel_l2(got, want) <= 5e-3


def test_tiny_vqa_through_kh_gives_jax_tokens(vqa_pair, monkeypatch):
    """greedy_generate of the tiny model whose SAM global layer takes K-h
    (and whose CLIP table upsamples 4x4 -> 6x6), with quant8 off
    (LVV_Q8_SCOPE=""): the port's tokens and lengths equal JAX's, JAX
    running its Pallas kernels in interpret mode."""
    from lvv_tpu.models import greedy_generate as jax_greedy_generate
    from lvv_tpu_torch import greedy_generate
    from torch_parity_util import inputs
    jm, params, pm, cfg = vqa_pair
    x = inputs(cfg, b=2, seed=15)
    x["prompt_len"] = np.array([6, 4], np.int32)
    args = (x["bev"], x["images"], x["view_valid"], x["prompt_ids"],
            x["prompt_len"])
    monkeypatch.setenv("LVV_Q8_SCOPE", "")
    jmlp.set_interpret(True)
    try:
        j_tok, j_len = jax_greedy_generate(jm, params, *args,
                                           max_new_tokens=6, eos_id=2)
    finally:
        jmlp.set_interpret(False)
    j_tok = np.asarray(j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2     # a non-degenerate answer
    _port_kernel_paths(monkeypatch)
    calls = _record(monkeypatch)
    p_tok, p_len = greedy_generate(pm, *args, max_new_tokens=6, eos_id=2)
    assert ("flash_attention_relpos", 576, False) in calls
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(j_len))
