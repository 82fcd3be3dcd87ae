"""SAM's int8 serving scopes in the port against the JAX package.

LVV_Q8_SCOPE picks, under `quant8`, the W8A8 projections ("dense", kernel
K-i), the int8 p@v of the global attention ("attn", K-d8) and its int8
scores ("qk", K-g). Each kernel's plain version (what its wrapper computes
on a CPU tensor) is held to the Pallas kernel it replaces, run in interpret
mode on the CPU, on the same seeded float32 inputs; then a small SAM
encoder under each scope. On the CPU the JAX package applies "dense" but not
"attn" or "qk" (it takes its materialised-bias path there), so the encoder
runs JAX under `fused_mlp.set_interpret(True)` and lets the port's CPU
tensors reach its kernel wrappers by patching the two eligibility tests.
Each tolerance is stated where it is used.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu.ops import quant as jq
from lvv_tpu_torch import config as tconfig
from lvv_tpu_torch import kernels
from lvv_tpu_torch.models import sam as tsam
from lvv_tpu_torch.ops import attention as tattn
from lvv_tpu_torch.ops import fused_mlp as tmlp
from lvv_tpu_torch.ops import quant as tq
from torch_parity_util import _leaf, close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

# K-g against interpret-mode Pallas: the same scores from the same int8
# operands, fp32 round-off only (measured 1.6e-6): 1e-3 relative to
# (1 + |JAX|). K-d8: the port scores in fp32 from the separate bias
# (q·k·scale + q·Rh + q·Rw, then log2e), the TPU kernel from log2e-scaled
# augmented operands, so scores differ in the last fp32 bits and an int8 p
# on a rounding boundary lands one step apart (some hundreds in 4M scores).
# One step moves an output by at most sp / 127 · |v| / l <= max|v| / 127,
# so elementwise that much is allowed; over the whole output the relative
# L2 must stay under PV8_REL_L2 (measured 1.2e-4 and 2.4e-4), which a wrong
# group size (3.5e-2) or the float arm (2.5e-2) fails.
ATTN_TOL = 1e-3
PV8_REL_L2 = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("env,want", [
    ("mlp", {"mlp"}), ("", {""}), ("mlp,dense,attn", {"mlp", "dense", "attn"}),
    ("qk,bogus", {"qk", "bogus"})])
def test_q8_scope_reads_any_names(monkeypatch, env, want):
    """q8_scope() is JAX's set of names, unknown ones included (they select
    nothing); it raises for none."""
    monkeypatch.setenv("LVV_Q8_SCOPE", env)
    assert tconfig.q8_scope() == frozenset(want)


# ------------------------------------------------------------------ K-i --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(300, 256, 384), (50, 200, 384),
                                   (50, 256, 200)])
def test_w8a8_matmul_matches_pallas(dtype, m, k, n):
    """K-i at [300, 256] x [256, 384] (the Pallas kernel) and the int8_dot
    fallback where K or N is off the 128 grid, as JAX dispatches.

    The int8 operands are bit-equal to JAX's, and the output is bit-equal
    to JAX's int8_dot (the same fp32 operations in the same order). Against
    the interpret-mode Pallas kernel each output is within one step of x8
    (sx · max_k |w[k, n]|) plus 4 ulps of the output dtype at the larger of
    |out| and |out - bias|: compiled by XLA for the CPU, the kernel takes
    sx = max|x| / 127 as max|x| · (1/127) (1 ulp off in 5 of 300 rows here,
    and then an x8 on a rounding boundary moves), and its fp32 epilogue
    lands up to 3 ulps from the same expression taken op by op."""
    rng = np.random.default_rng(0)
    jd = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32).astype(jd)
    w = jnp.asarray(rng.standard_normal((k, n)) / math.sqrt(k), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(n), jnp.float32)
    tx = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    for jfn, tfn, arg, targ in ((jq.quantize_rows, tq.quantize_rows, x, tx),
                                (jq.quantize_weight, tq.quantize_weight, w,
                                 _t(w))):
        for ja, ta in zip(jfn(arg), tfn(targ)):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    got = tq.w8a8_matmul(tx, _t(w), _t(b))
    assert got.dtype == tx.dtype and got.shape == (m, n)
    got32 = got.float().numpy()
    np.testing.assert_array_equal(
        got32, np.asarray(jq.int8_dot(x, w, b).astype(jnp.float32)))
    want32 = np.asarray(jq.w8a8_matmul(x, w, b, interpret=True).astype(
        jnp.float32))
    mag = np.maximum(np.abs(want32), np.abs(want32 - np.asarray(b)))
    ulp = np.spacing(mag.astype(np.float32))
    if dtype == "bfloat16":
        ulp = ulp * 2 ** 16               # 8 significant bits, not 24
    step = (np.asarray(jq.quantize_rows(x)[1])
            * np.abs(np.asarray(w)).max(0)[None, :])
    assert np.all(np.abs(got32 - want32) <= step + 4 * ulp)
    assert sum(kernels.launches.values()) == 0


# ------------------------------------------------------- K-d8 and K-g ----

def _pv8_close(got, want, vmax):
    """The K-d8 rule above; returns the relative L2 error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= vmax / 127 + ATTN_TOL * (1 + np.abs(want))), (
        float(err.max()))
    rel = _rel_l2(got, want)
    assert rel <= PV8_REL_L2, rel
    return rel


def _qkv_tables(gh, gw, heads, d, seed):
    rng = np.random.default_rng(seed)
    s = gh * gw
    qkv = rng.standard_normal((2, s, 3 * heads * d)).astype(np.float32)
    rh = (0.1 * rng.standard_normal((gh, gh, d))).astype(np.float32)
    rw = (0.1 * rng.standard_normal((gw, gw, d))).astype(np.float32)
    return qkv, rh, rw


@pytest.mark.parametrize("block_k", [256, 1024])
def test_pv8_matches_pallas(block_k):
    """K-d8 at a 32x32 grid, 2 heads, d 64: the head-packed kernel with
    quant8 and kv tile block_k, against the port with pv_group = block_k.
    The group is part of the function: the other group size differs by far
    more than the tolerance."""
    qkv, rh, rw = _qkv_tables(32, 32, 2, 64, seed=1)
    scale = 0.125
    want = jattn.flash_attention_relpos_hpacked(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale=scale,
        grid_w=32, heads=2, block_q=1024, block_k=block_k, quant8=True,
        interpret=True)
    kw = dict(heads=2, scale=scale, pv_int8=True)
    got = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw), pv_group=block_k,
                                 **kw)
    vmax = np.abs(qkv[..., 256:]).max()
    _pv8_close(got, want, vmax)
    other = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw),
                                   pv_group=1280 - block_k, **kw)
    with pytest.raises(AssertionError):
        _pv8_close(other, want, vmax)


@pytest.mark.parametrize("gh,gw", [(8, 64), (32, 32)])
def test_qk8_matches_pallas(gh, gw):
    """K-g at 8x64 and 32x32 grids: the head-packed kernel with qk8 (kv
    tiles of min(S, 1024)) against the port's plain version."""
    qkv, rh, rw = _qkv_tables(gh, gw, 2, 64, seed=2)
    s = gh * gw
    want = jattn.flash_attention_relpos_hpacked(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale=0.125,
        grid_w=gw, heads=2, block_q=min(s, 4096), block_k=min(s, 1024),
        qk8=True, interpret=True)
    got = tattn.relpos_attention_qk8(_t(qkv), _t(rh), _t(rw), heads=2,
                                     scale=0.125)
    close(got, want, ATTN_TOL)
    # the float scores are another function
    flt = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw), heads=2,
                                 scale=0.125)
    assert float((flt - got).abs().max()) > 10 * ATTN_TOL


def test_qk8_operands_match_jax_lanes():
    """The glue of K-g: the int8 q_aug / k_aug blocks equal JAX's (the
    one-hot kh columns make k's scale max(max|k|, 1) / 127)."""
    qkv, rh, rw = _qkv_tables(8, 64, 2, 64, seed=3)
    q8, k8, sq, sk, qrw = tattn.qk8_operands(_t(qkv), _t(rh), _t(rw),
                                             heads=2, scale=0.125)
    assert q8.shape == k8.shape == (2, 512, 2, 128)
    kr = qkv[..., 128:256].reshape(2, 512, 2, 64)
    np.testing.assert_allclose(
        sk.numpy(), np.maximum(np.abs(kr).max(-1), 1.0) / 127.0, rtol=1e-7)
    np.testing.assert_array_equal(k8[..., 64:72].numpy().argmax(-1),
                                  np.broadcast_to((np.arange(512) // 64)[
                                      None, :, None], (2, 512, 2)))
    assert not q8[..., 72:].any() and not k8[..., 72:].any()
    assert qrw.shape == (2, 512, 2, 64) and sq.shape == (2, 512, 2)


def test_kh_shape_int8_dispatch_matches_pallas():
    """A ragged 24x40 global grid fails the head-packed test, so JAX sends
    it to flash_attention_relpos (960 tokens padded to one 1024-column kv
    tile) with int8 p@v; the port runs K-d8 with that tile as its group."""
    gh, gw, heads, d = 24, 40, 2, 64
    assert not tsam._hpacked_ok(gh, gw, d)
    assert tsam._pv_group(gh * gw) == 1024
    qkv, rh, rw = _qkv_tables(gh, gw, heads, d, seed=4)
    scale = 0.125
    q, k, v = (jnp.asarray(qkv[..., i * 128:(i + 1) * 128]).reshape(
        2, gh * gw, heads, d).transpose(0, 2, 1, 3) for i in range(3))
    qr = q.reshape(2, heads, gh, gw, d)
    q_rh = jnp.einsum("bnhwc,hkc->bnhwk", qr, rh).reshape(2, heads, -1, gh)
    q_rw = jnp.einsum("bnhwc,wkc->bnhwk", qr, rw).reshape(2, heads, -1, gw)
    want = jattn.flash_attention_relpos(q, k, v, q_rh, q_rw, scale=scale,
                                        grid_w=gw, block_q=4096,
                                        block_k=1024, quant8=True,
                                        interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(2, gh * gw, -1)
    got = tattn.relpos_attention(_t(qkv), _t(rh), _t(rw), heads=heads,
                                 scale=scale, pv_int8=True,
                                 pv_group=tsam._pv_group(gh * gw))
    _pv8_close(got, want, np.abs(qkv[..., 256:]).max())


# ---------------------------------------------------------- the encoder --

ENC_REL_L2 = 5e-3


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


SAM_KW = dict(img_size=256, patch_size=8, embed_dim=128, depth=2,
              num_heads=2, out_chans=16, window_size=14,
              global_attn_indexes=(1,), vary_dims=(32, 64))


@pytest.fixture(scope="module")
def encoders():
    """(JAX SAMImageEncoder with quant8, its params, the port's encoder
    loaded through from_jax_params, an image): one windowed and one
    global block at a 32x32 grid, width 128, 2 heads of d 64. The rest of
    the tiny VQAModel is sized to match, since from_jax_params converts the
    whole model's tree."""
    import dataclasses
    from lvv_tpu.config import tiny_config as jax_tiny_config
    from lvv_tpu.models import VQABatch
    from lvv_tpu.models import VQAModel as JaxVQAModel
    from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
    jcfg = jax_tiny_config().model
    jcfg = dataclasses.replace(jcfg, sam=dataclasses.replace(
        jcfg.sam, **SAM_KW, quant8=True))
    batch = VQABatch(
        bev=jnp.zeros((1, jcfg.bev_channels, *jcfg.bev_hw)),
        images=jnp.zeros((1, 6, 3, 256, 256)),
        view_valid=jnp.ones((1, 6), bool),
        text_ids=jnp.zeros((1, 4), jnp.int32),
        text_len=jnp.full((1,), 4, jnp.int32),
        labels=jnp.full((1, 4), -100, jnp.int32),
        use_vision=jnp.asarray(True), use_lidar=jnp.asarray(True))
    shapes = jax.eval_shape(JaxVQAModel(jcfg).init, jax.random.PRNGKey(0),
                            batch)["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf("/".join(k.key for k in p), s.shape, rng), shapes)
    cfg = tiny_config().model
    cfg = dataclasses.replace(cfg, sam=dataclasses.replace(
        cfg.sam, **SAM_KW, quant8=True))
    pm = VQAModel(cfg, dtype=torch.float32, device="cpu")
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    img = np.random.default_rng(5).uniform(-1, 1, (1, 3, 256, 256)).astype(
        np.float32)
    from lvv_tpu.models.sam import SAMImageEncoder as JaxSAM
    return (JaxSAM(**SAM_KW, quant8=True), params["deepencoder"]["sam"],
            pm.deepencoder.sam, img)


def _port_kernel_paths(monkeypatch):
    """Let CPU tensors take the port's kernel dispatch (the plain versions
    run where the kernels would), as JAX in interpret mode does."""
    monkeypatch.setattr(tsam, "_relpos_kernel_ok",
                        lambda x, hd, h, w: hd in (64, 128) and h <= 64
                        and w <= 128)
    monkeypatch.setattr(tmlp, "kernel_ok",
                        lambda x, c, h: c % 128 == 0 and h % 128 == 0)


@pytest.mark.parametrize("scope", ["mlp,dense", "mlp,dense,attn",
                                   "mlp,dense,qk", "mlp,attn,qk"])
def test_sam_encoder_scopes_match_jax(encoders, monkeypatch, scope):
    """The whole encoder under each scope, JAX with every Pallas kernel in
    interpret mode. An int8 value on a rounding boundary may land one step
    apart on the two sides (above), and through two blocks such flips
    compound: a flip moves a row maximum, and with it every value quantized
    against it. So the rule is statistical: relative L2 within
    ENC_REL_L2 (measured 2.3e-3 to 2.7e-3 with "dense", 7e-4 without), and
    elementwise within 5e-2 relative to (1 + |JAX|) (measured 1.4e-2 on
    outputs up to 4). Each scope moves the output by at least 1.2e-2
    relative L2 against the "mlp" scope alone, which must exceed
    2 · ENC_REL_L2."""
    jenc, sam_params, penc, img = encoders
    monkeypatch.setenv("LVV_Q8_SCOPE", scope)
    jmlp.set_interpret(True)
    try:
        want = np.asarray(jenc.apply({"params": sam_params},
                                     jnp.asarray(img)))
    finally:
        jmlp.set_interpret(False)
    _port_kernel_paths(monkeypatch)
    with torch.no_grad():
        got = penc(_t(img))
        monkeypatch.setenv("LVV_Q8_SCOPE", "mlp")
        base = penc(_t(img))
    close(got, want, 5e-2)
    assert _rel_l2(got, want) <= ENC_REL_L2
    assert _rel_l2(got, base) > 2 * ENC_REL_L2


def test_qk_takes_precedence_over_attn(encoders, monkeypatch):
    """With "attn" and "qk" both set, the global layer runs K-g (int8
    scores, bf16 p@v) and not K-d8, as attention.py:856 decides."""
    _, _, penc, img = encoders
    _port_kernel_paths(monkeypatch)
    calls = []
    for name in ("relpos_attention", "relpos_attention_qk8"):
        fn = getattr(tsam, name)
        monkeypatch.setattr(tsam, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append((_n, kw.get("pv_int8", False))), _f(*a, **kw))[1])
    out = {}
    with torch.no_grad():
        for scope in ("mlp,qk", "mlp,attn,qk", "mlp,attn"):
            monkeypatch.setenv("LVV_Q8_SCOPE", scope)
            calls.clear()
            out[scope] = penc(_t(img))
            out[scope + " calls"] = list(calls)
    assert torch.equal(out["mlp,qk"], out["mlp,attn,qk"])
    assert out["mlp,attn,qk calls"] == [("relpos_attention", False),
                                        ("relpos_attention_qk8", False)]
    assert out["mlp,attn calls"] == [("relpos_attention", False),
                                     ("relpos_attention", True)]
    assert not torch.equal(out["mlp,attn"], out["mlp,qk"])


@pytest.mark.parametrize("scope", ["", "bogus"])
def test_scope_without_known_names_is_quant8_off(encoders, monkeypatch,
                                                 scope):
    """LVV_Q8_SCOPE="" (or only unknown names) with quant8 gives the
    quant8=False output exactly, as in JAX."""
    _, _, penc, img = encoders
    _port_kernel_paths(monkeypatch)
    monkeypatch.setenv("LVV_Q8_SCOPE", scope)
    blocks = [getattr(penc, f"block_{i}") for i in range(penc.depth)]
    with torch.no_grad():
        got = penc(_t(img))
        try:
            for blk in blocks:
                blk.quant8 = blk.attn.quant8 = False
            want = penc(_t(img))
        finally:
            for blk in blocks:
                blk.quant8 = blk.attn.quant8 = True
    assert torch.equal(got, want)
