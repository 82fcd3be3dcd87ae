"""The port's hand-written kernels on the card, against their plain versions.

These need a CUDA card (and nvcc): they carry the `gpu` marker
and skip, with the reason, where there is none. Run them on the card with

    python -m pytest tests/test_torch_gpu.py -q -p no:randomly

Inputs are seeded, small but kernel-eligible (ragged lengths, GQA, head
dims 64 / 112 / 256, windows and a global grid). Kernel and plain version
both produce bf16 from fp32 math; the tolerance is 4 bf16 ulps of
(|plain| + rms(plain)) elementwise and 1/128 relative L2 overall (they round
at different points, one ulp each), as chip_smoke.py states. The W8A8 MLP
(K-f) keeps the elementwise rule and tightens the relative L2 to 1/512
(chip_smoke.Q8_REL_L2_TOL, which states why), as does the W8A8 projection
(K-i); the int8 p@v arm (K-d8) allows one p8 step elementwise (chip_smoke
states why).
"""
import queue
import threading

import pytest
import torch

from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as A
from lvv_tpu_torch.ops import fused_mlp as M
from lvv_tpu_torch.ops import quant as Q

pytestmark = [pytest.mark.fast, pytest.mark.gpu]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(
        torch.bfloat16)


def _agree(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs() + want.square().mean().sqrt()
    assert torch.isfinite(got).all()
    assert bool((err <= scale / 32).all()), float(err.max())
    assert float((got - want).norm() / want.norm()) <= 1 / 128


def _launched(name, fn):
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("n,c", [(37, 256), (5, 896), (300, 2048)])
def test_norm(gen, rms, n, c):
    x, s, b = _rnd(gen, n, c), 1 + _rnd(gen, c, std=0.1), _rnd(gen, c,
                                                               std=0.1)
    bias = None if rms else b
    got = _launched("norm", lambda: M.norm(x, s, bias, eps=1e-6, rms=rms))
    _agree(got, M.norm_plain(x, s, bias, eps=1e-6, rms=rms))


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("n,c", [(3, 100), (64, 8192), (2, 1000)])
def test_norm_fp32_and_element_widths(gen, rms, n, c):
    """K-a in fp32 (C = 8192: 512 threads a row), and at widths that are not
    whole 16-byte vectors (one element a "vector")."""
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(n, c, generator=gen, device="cuda") * 2).to(dt)
        s = (1 + torch.randn(c, generator=gen, device="cuda") * 0.1).to(dt)
        b = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(dt)
        bias = None if rms else b
        got = _launched("norm", lambda: M.norm(x, s, bias, eps=1e-6,
                                               rms=rms))
        _agree(got, M.norm_plain(x, s, bias, eps=1e-6, rms=rms))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", [(1, 896), (8, 896), (1, 1564, 896),
                                   (2, 37, 256)])
def test_add_norm(gen, dt, rms, shape):
    """K-a's add form: s bit-equal to PyTorch's x + y on the card, n within
    the tolerance of norm_plain(s), one launch counted under norm and
    norm[add]."""
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dt)
    y = torch.randn(shape, generator=gen, device="cuda").to(dt)
    sc = (1 + torch.randn(c, generator=gen, device="cuda") * 0.1).to(dt)
    b = None if rms else (torch.randn(c, generator=gen, device="cuda")
                          * 0.1).to(dt)
    norms = kernels.launches["norm"]
    s, n = _launched("norm[add]", lambda: M.add_norm(x, y, sc, b, eps=1e-6,
                                                     rms=rms))
    assert kernels.launches["norm"] == norms + 1
    assert s.shape == x.shape and n.shape == x.shape
    assert torch.equal(s, x + y)
    _agree(n, M.norm_plain(x + y, sc, b, eps=1e-6, rms=rms))


def test_norm_wrappers_refuse_what_the_kernel_does_not_take(gen):
    x = _rnd(gen, 4, 256)
    with pytest.raises(ValueError):                   # scale of another type
        M.norm(x, torch.ones(256, device="cuda", dtype=torch.float16),
               eps=1e-6, rms=True)
    with pytest.raises(ValueError):                   # fp32 scale, bf16 bias
        M.norm(x, torch.ones(256, device="cuda"), _rnd(gen, 256), eps=1e-6)
    with pytest.raises(ValueError):                   # bf16 scale of fp32 x
        M.norm(x.float(), _rnd(gen, 256), eps=1e-6, rms=True)
    with pytest.raises(ValueError):                   # C > 8192
        M.norm(_rnd(gen, 2, 8320), _rnd(gen, 8320), eps=1e-6, rms=True)
    with pytest.raises(ValueError):                   # y of another shape
        M.add_norm(x, _rnd(gen, 2, 256), _rnd(gen, 256), eps=1e-6, rms=True)


def _share_rel(got, want):
    got, want = got.float(), want.float()
    return (float((got != want).float().mean()),
            float((got - want).norm() / want.norm()))


def _param_trap_fails(got, plain, rel_tol):
    """The kernel within rel_tol of its plain version on fp32 norm
    parameters, and the plain version with them rounded to bf16 first (the
    bf16-parameter model's function) beyond it."""
    from chip_smoke import agreement
    ok, err, rel = agreement(got, plain(lambda t: t), rel_tol)
    assert ok, (err, rel)
    ok, _, rel = agreement(got, plain(
        lambda t: None if t is None else t.to(torch.bfloat16).float()),
        rel_tol)
    assert not ok, rel


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", [(1, 896), (8, 896), (1564, 896),
                                   (24576, 768), (3, 100), (37, 256)])
def test_norm_fp32_params(gen, add, rms, shape):
    """K-a and its add form on bf16 x with fp32 scale and bias (the model's
    norms): every launch form (one vector a thread with the parameters
    loaded with x, four through L1, one element at a time at C = 100)
    within chip_smoke's PARAM_REL_L2_TOL of the plain version, which the
    parameters rounded to bf16 fail."""
    from chip_smoke import PARAM_REL_L2_TOL
    c = shape[-1]
    x, y = _rnd(gen, *shape), _rnd(gen, *shape)
    s = 1 + torch.randn(c, generator=gen, device="cuda") * 0.1
    b = None if rms else torch.randn(c, generator=gen, device="cuda") * 0.1
    if add:
        out, got = _launched("norm[add]", lambda: M.add_norm(
            x, y, s, b, eps=1e-6, rms=rms))
        assert torch.equal(out, x + y)
        base = x + y
    else:
        got = _launched("norm", lambda: M.norm(x, s, b, eps=1e-6, rms=rms))
        base = x
    _param_trap_fails(got, lambda r: M.norm_plain(
        base, r(s), r(b), eps=1e-6, rms=rms), PARAM_REL_L2_TOL)


@pytest.mark.parametrize("quant8", [False, True])
@pytest.mark.parametrize("n,c,h", [(77, 768, 3072), (33, 1024, 4096),
                                   (3, 128, 192)])
def test_ln_mlp_residual_fp32_params(gen, quant8, n, c, h):
    """K-b and K-f with fp32 ls / lb (the model's LN), held to their plain
    versions (K-b at PARAM_REL_L2_TOL, K-f at Q8_REL_L2_TOL), which the
    parameters rounded to bf16 fail."""
    from chip_smoke import PARAM_REL_L2_TOL, Q8_REL_L2_TOL
    x = _rnd(gen, n, c)
    p = _mlp_params(gen, c, h)
    ls = 1 + torch.randn(c, generator=gen, device="cuda") * 0.1
    lb = torch.randn(c, generator=gen, device="cuda") * 0.1
    name = "ln_mlp_residual_q8" if quant8 else "ln_mlp_residual"
    got = _launched(name, lambda: M.ln_mlp_residual(
        x, ls, lb, *p[2:], eps=1e-6, act="gelu", quant8=quant8))
    plain = (M.ln_mlp_residual_q8_plain if quant8
             else M.ln_mlp_residual_plain)
    _param_trap_fails(got, lambda r: plain(x, r(ls), r(lb), *p[2:],
                                           eps=1e-6, act="gelu"),
                      Q8_REL_L2_TOL if quant8 else PARAM_REL_L2_TOL)
    with pytest.raises(ValueError):                 # fp32 ls, bf16 lb
        M.ln_mlp_residual(x, ls, p[1], *p[2:], quant8=quant8)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("n,c,h", [(50, 128, 256), (77, 768, 3072),
                                   (33, 1024, 4096), (1, 768, 3072),
                                   (130, 256, 384), (3, 128, 192),
                                   (33920, 256, 128)])
def test_ln_mlp_residual(gen, act, n, c, h):
    """K-b at SAM's and CLIP's widths, one token, a ragged last token tile
    over three column tiles, H = 192 (a column tile half outside), and
    265 token tiles (the second product on 256-wide tiles)."""
    x = _rnd(gen, n, c)
    p = (1 + _rnd(gen, c, std=0.1), _rnd(gen, c, std=0.1),
         _rnd(gen, c, h, std=c ** -0.5), _rnd(gen, h, std=0.1),
         _rnd(gen, h, c, std=h ** -0.5), _rnd(gen, c, std=0.1))
    got = _launched("ln_mlp_residual",
                    lambda: M.ln_mlp_residual(x, *p, eps=1e-6, act=act))
    _agree(got, M.ln_mlp_residual_plain(x, *p, eps=1e-6, act=act))


@pytest.mark.parametrize("sq,sk,hq,hkv,d,causal", [
    (160, 160, 4, 2, 64, True),      # causal prefill with GQA
    (100, 260, 2, 2, 64, True),      # causal with the sk - sq offset
    (40, 1300, 2, 2, 112, False),    # VATLiDAR's head dim, ragged kv
    (70, 1536, 2, 2, 256, False),    # VATVision's head dim
])
def test_flash_attention(gen, sq, sk, hq, hkv, d, causal):
    q = _rnd(gen, 2, sq, hq * d).view(2, sq, hq, d).transpose(1, 2)
    k = _rnd(gen, 2, hkv, sk, d)
    v = _rnd(gen, 2, hkv, sk, d)
    kv_len = torch.tensor([sk, sk - 37], dtype=torch.int32, device="cuda")
    got = _launched("flash_attention", lambda: A.flash_attention(
        q, k, v, causal=causal, kv_len=kv_len))
    want = A.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    _agree(got, want)


# K-e's fp32 form: TransFusion's cross-attention (33 kv splits) and at its
# train step's batch of 2, a self-attention shape without a split, GQA with
# a ragged kv_len, causal, and head dims 7, 16, 48 and 64 (the kernel pads
# to a multiple of 8)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,ragged", [
    (1, 4, 4, 200, 32400, 32, False, False),
    (2, 4, 4, 24, 300, 32, False, False),
    (2, 8, 2, 70, 2000, 64, False, True),
    (1, 4, 4, 300, 300, 48, True, False),
    (3, 1, 1, 5, 1100, 7, False, False),
    (2, 4, 2, 130, 1500, 16, True, True),
    (2, 4, 4, 200, 32400, 32, False, False)])
def test_flash_attention_fp32(gen, b, hq, hkv, sq, sk, d, causal, ragged):
    """Against the plain version within 1e-5 relative L2 (chip_smoke's
    FP32_REL_L2_TOL), which a scale dropped and a single TF32 pass in place
    of the kernel's 3xTF32 must fail."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = rnd(b, sq, hq * d).view(b, sq, hq, d).transpose(1, 2)
    k, v = rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    kv_len = (torch.tensor([sk - 13 * i for i in range(b)], device="cuda")
              if ragged else None)
    kw = dict(causal=causal, kv_len=kv_len)
    got = _launched("flash_attention[fp32]",
                    lambda: A.flash_attention(q, k, v, **kw))
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = A.flash_attention_plain(q, k, v, **kw)

    def rel(ref):
        return float((got - ref).norm() / ref.norm())
    assert rel(want) <= 1e-5
    assert rel(A.flash_attention_plain(q, k, v, scale=1.0, **kw)) > 1e-3
    single = A.flash_attention_tf32_plain(q, k, v, passes=1, **kw)
    assert float((single - want).norm() / want.norm()) > 1e-5


@pytest.mark.parametrize("b,gh,gw,heads", [(5, 14, 14, 3), (1, 32, 32, 2),
                                           (1, 16, 128, 2)])
def test_relpos_attention(gen, b, gh, gw, heads):
    d = 64
    qkv = _rnd(gen, b, gh * gw, 3 * heads * d, std=0.5)
    rh, rw = _rnd(gen, gh, gh, d, std=0.1), _rnd(gen, gw, gw, d, std=0.1)
    got = _launched(f"relpos_attention[{gh}x{gw}]", lambda: A.relpos_attention(
        qkv, rh, rw, heads=heads, scale=0.125))
    _agree(got, A.relpos_attention_plain(qkv, rh, rw, heads=heads,
                                         scale=0.125))


@pytest.mark.parametrize("sq,sk,hq,hkv,d,causal,short", [
    # 8 splits of 512 keys; row 1's 700 keys leave six splits without one
    (40, 4096, 2, 2, 112, False, 700),
    # causal with GQA over 2 splits; row 1 cut to 1500 keys
    (2048, 2048, 2, 1, 64, True, 1500),
])
def test_flash_attention_split(gen, sq, sk, hq, hkv, d, causal, short):
    """The split-kv path against the plain version and against the split
    arithmetic in plain PyTorch, with chip_smoke's causal allowance: a
    causal row over few keys moves by up to max|v| / 128 where the two
    round p to bf16 at different points (chip_smoke.py's flash_case)."""
    from chip_smoke import agreement
    assert A.flash_splits(2, hq, sq, sk) > 1
    q = _rnd(gen, 2, sq, hq * d).view(2, sq, hq, d).transpose(1, 2)
    k = _rnd(gen, 2, hkv, sk, d)
    v = _rnd(gen, 2, hkv, sk, d)
    kv_len = torch.tensor([sk, short], dtype=torch.int32, device="cuda")
    got = _launched("flash_attention", lambda: A.flash_attention(
        q, k, v, causal=causal, kv_len=kv_len))
    extra = float(v.abs().max()) / 128 if causal else 0.0
    for want in (A.flash_attention_plain(q, k, v, causal=causal,
                                         kv_len=kv_len),
                 A.flash_attention_split_plain(
                     q, k, v, n_split=A.flash_splits(2, hq, sq, sk),
                     causal=causal, kv_len=kv_len)):
        ok, err, rel = agreement(got, want, abs_extra=extra)
        assert ok, (err, rel)


@pytest.mark.parametrize("b,gh,gw,heads,d", [
    (1, 64, 64, 2, 64),      # SAM's global grid: 8 x 16 patches of q rows
    (1, 64, 64, 2, 128),
    (1, 16, 64, 2, 64),
    (2, 14, 14, 2, 128),     # a window resident at head dim 128
    (3, 7, 7, 2, 64),        # a window of 49: kv padded to 64, q to 64
])
def test_relpos_attention_regimes(gen, b, gh, gw, heads, d):
    qkv = _rnd(gen, b, gh * gw, 3 * heads * d, std=0.5)
    rh, rw = _rnd(gen, gh, gh, d, std=0.1), _rnd(gen, gw, gw, d, std=0.1)
    kw = dict(heads=heads, scale=d ** -0.5)
    got = _launched(f"relpos_attention[{gh}x{gw}]",
                    lambda: A.relpos_attention(qkv, rh, rw, **kw))
    _agree(got, A.relpos_attention_plain(qkv, rh, rw, **kw))


def _mlp_params(gen, c, h):
    return (1 + _rnd(gen, c, std=0.1), _rnd(gen, c, std=0.1),
            _rnd(gen, c, h, std=c ** -0.5), _rnd(gen, h, std=0.1),
            _rnd(gen, h, c, std=h ** -0.5), _rnd(gen, c, std=0.1))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("n,c,h", [(77, 768, 3072), (33, 1024, 4096),
                                   (3, 128, 192), (130, 256, 1024),
                                   (1, 1024, 4096), (300, 1024, 4096),
                                   (1, 768, 3072)])
def test_ln_mlp_residual_q8(gen, act, n, c, h):
    """K-f at SAM's and CLIP's widths (one 3072 chunk; two 2048 chunks,
    each a slice of the second product, added by the combine pass) and odd
    shapes: 3 tokens with 64-wide chunks, 130 tokens (a ragged tile), one
    token, and 300 tokens of CLIP (a ragged last tile across the chunk
    boundary)."""
    from chip_smoke import Q8_REL_L2_TOL, agreement
    x = _rnd(gen, n, c)
    p = _mlp_params(gen, c, h)
    got = _launched("ln_mlp_residual_q8", lambda: M.ln_mlp_residual(
        x, *p, eps=1e-6, act=act, quant8=True))
    ok, err, rel = agreement(got, M.ln_mlp_residual_q8_plain(
        x, *p, eps=1e-6, act=act), Q8_REL_L2_TOL)
    assert ok, (err, rel)


@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (1024, 4096),
                                 (4096, 1024), (192, 128), (128, 192)])
def test_quantize_weight_t_is_quantize_weight(gen, k, n):
    """K-f's per-call weight quantization on the card is quant.
    quantize_weight bit for bit (there: max|w| times the reciprocal of 127),
    transposed."""
    w = _rnd(gen, k, n, std=0.05)
    w[:, 5] = 0                                        # the 1e-8 floor
    wt, s = M.quantize_weight_t(w)
    q, s0 = Q.quantize_weight(w)
    assert torch.equal(wt, q.t().contiguous()) and torch.equal(s, s0)


def test_q8_tolerance_sees_a_wrong_h_scale(gen):
    """At CLIP's widths the kernel's h has one row scale per 2048-wide
    chunk; held against a plain version with a single whole-row scale, it
    fails the K-f tolerance."""
    from chip_smoke import Q8_REL_L2_TOL, agreement
    x = _rnd(gen, 1542, 1024)
    p = _mlp_params(gen, 1024, 4096)
    got = M.ln_mlp_residual_q8(x, *p, eps=1e-6, act="quick_gelu")
    right = M.ln_mlp_residual_q8_plain(x, *p, eps=1e-6, act="quick_gelu")
    wrong = M.ln_mlp_residual_q8_plain(x, *p, eps=1e-6, act="quick_gelu",
                                       block_h=4096)
    assert agreement(got, right, Q8_REL_L2_TOL)[0]
    ok, _, rel = agreement(got, wrong, Q8_REL_L2_TOL)
    assert not ok, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 6])
@pytest.mark.parametrize("k,n", [(896, 1152), (896, 9728), (4864, 896),
                                 (300, 200)])
def test_int8_matmul(gen, dtype, m, k, n):
    """K-j at the decode's products and at N = 200 (no multiple of 128),
    M = 1, 3 and 6 (two row groups)."""
    q, s = Q.quantize_weight(torch.randn(k, n, generator=gen, device="cuda"))
    x = _rnd(gen, m, k).to(dtype)
    got = _launched("int8_matmul", lambda: Q.quantized_matmul(x, q, s))
    assert got.dtype == dtype
    _agree(got, Q.quantized_matmul_plain(x, q, s))


_DECODE = [(896, 1152), (896, 896), (896, 9728), (4864, 896)]


@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("k,n", _DECODE)
def test_int8_matmul_at_the_decode_shapes(gen, m, k, n):
    """K-j's split-K clusters at every product of the decode, batch 1 to 8
    (one row group: every row in one pass over the weight)."""
    q, s = Q.quantize_weight(torch.randn(k, n, generator=gen, device="cuda")
                             * k ** -0.5)
    x = _rnd(gen, m, k)
    got = _launched("int8_matmul", lambda: Q.quantized_matmul(x, q, s))
    _agree(got, Q.quantized_matmul_plain(x, q, s))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", _DECODE)
def test_int8_matmul_is_deterministic(gen, m, k, n):
    """The split-K partials are added in a fixed order (no atomics): two
    runs are bit-equal."""
    q, s = Q.quantize_weight(torch.randn(k, n, generator=gen, device="cuda"))
    x = _rnd(gen, m, k)
    assert torch.equal(Q.quantized_matmul(x, q, s),
                       Q.quantized_matmul(x, q, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 896, 151940), (3, 896, 1000),
                                   (5, 64, 200), (9, 896, 1000),
                                   (17, 64, 200), (2, 2048, 1332),
                                   (2, 896, 151940), (5, 896, 151940),
                                   (8, 896, 151940)])
def test_int8_matmul_nk(gen, dtype, m, k, n):
    """K-k at the unembed's shape for decode batch 1, 2, 5 and 8 (the fma
    form at one row or fp32, the tensor-core form at 2 to 8 bf16 rows), and
    at odd ones: K = 64 (a partial group of 64), more than 8 rows (two and
    three passes over the table), K = 2048."""
    t = Q.quantize_rows_table(torch.randn(n, k, generator=gen,
                                          device="cuda") * 0.02)
    x = _rnd(gen, m, k).to(dtype)
    got = _launched("int8_matmul_nk",
                    lambda: Q.quantized_matmul_nk(x, t["q"], t["s"]))
    assert got.dtype == dtype
    _agree(got, Q.quantized_matmul_nk_plain(x, t["q"], t["s"]))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _rnd(gen, 2, 64)
    q, s = Q.quantize_weight(torch.randn(64, 198, device="cuda"))
    with pytest.raises(ValueError):
        Q.quantized_matmul(x, q, s)                    # N % 4 != 0
    q, s = Q.quantize_weight(torch.randn(64, 200, device="cuda"))
    with pytest.raises(ValueError):
        Q.quantized_matmul(x.half(), q, s)             # fp16 x
    with pytest.raises(ValueError):
        Q.quantized_matmul(x, q.float(), s)            # not int8
    with pytest.raises(ValueError):
        Q.quantized_matmul(_rnd(gen, 2, 72), q, s)     # K mismatch
    t = Q.quantize_rows_table(torch.randn(50, 72, device="cuda"))
    with pytest.raises(ValueError):
        Q.quantized_matmul_nk(_rnd(gen, 2, 72), t["q"], t["s"])  # K % 16
    xq = _rnd(gen, 4, 1152)
    with pytest.raises(ValueError):
        M.ln_mlp_residual_q8(xq, *_mlp_params(gen, 1152, 256))   # C > 1024
    x8 = _rnd(gen, 4, 128)
    with pytest.raises(ValueError):
        M.ln_mlp_residual_q8(x8.float(), *(t.float() for t in
                                           _mlp_params(gen, 128, 256)))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _rnd(gen, 4, 1152)
    p = (x[0], x[0], _rnd(gen, 1152, 256), _rnd(gen, 256), _rnd(gen, 256,
                                                                1152), x[0])
    with pytest.raises(ValueError):
        M.ln_mlp_residual(x, *p)                       # C > 1024
    q = _rnd(gen, 1, 1, 8, 96)
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q)                     # head dim 96
    with pytest.raises(ValueError):
        A.flash_attention(q.float(), q.float(), q.float())


def test_tiny_model_on_card_matches_cpu(gen, monkeypatch):
    """The tiny model's greedy answer on the card (fp32) equals the CPU's.
    Its widths are below the fused kernels' lanes, so on the card it runs
    the norm kernel in fp32 and the plain paths elsewhere; cuDNN's TF32
    convolutions are turned off so both sides compute in fp32."""
    from lvv_tpu_torch import VQAModel, greedy_generate, tiny_config
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tiny_config().model
    cpu = VQAModel(cfg, dtype=torch.float32, device="cpu", seed=3)
    card = VQAModel(cfg, dtype=torch.float32, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(1, 32, 24, 24, generator=g),
            torch.rand(1, 6, 3, 64, 64, generator=g) * 2 - 1,
            torch.ones(1, 6, dtype=torch.bool),
            torch.randint(0, 500, (1, 6), generator=g), torch.tensor([6]))
    want, _ = greedy_generate(cpu, *args, max_new_tokens=6, eos_id=2)
    got, _ = greedy_generate(card, *args, max_new_tokens=6, eos_id=2)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_serving_path_on_card_matches_cpu(gen, monkeypatch, fused):
    """The tiny model's serving path (quant8 config, int8 decode packed or
    unfused) gives the CPU's tokens on the card, in fp32: the int8 products
    run kernels K-j and K-k there (the tiny widths keep the MLPs unfused,
    where quant8 is ignored, as in JAX)."""
    import dataclasses
    from lvv_tpu_torch import (VQAModel, greedy_generate,
                               prepare_serving_params,
                               prepare_serving_params_fused, tiny_config)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tiny_config().model
    cfg = dataclasses.replace(
        cfg, sam=dataclasses.replace(cfg.sam, quant8=True),
        clip=dataclasses.replace(cfg.clip, quant8=True))
    cpu = VQAModel(cfg, dtype=torch.float32, device="cpu", seed=3)
    card = VQAModel(cfg, dtype=torch.float32, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    prep = prepare_serving_params_fused if fused else prepare_serving_params
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(1, 32, 24, 24, generator=g),
            torch.rand(1, 6, 3, 64, 64, generator=g) * 2 - 1,
            torch.ones(1, 6, dtype=torch.bool),
            torch.randint(0, 500, (1, 6), generator=g), torch.tensor([6]))
    want, _ = greedy_generate(cpu, *args, max_new_tokens=6, eos_id=2,
                              params_decode=prep(cpu))
    before = dict(kernels.launches)
    got, _ = greedy_generate(card, *args, max_new_tokens=6, eos_id=2,
                             params_decode=prep(card))
    assert torch.equal(got.cpu(), want)
    for name in ("int8_matmul", "int8_matmul_nk"):
        assert kernels.launches[name] > before.get(name, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(77, 768, 2304), (130, 768, 768),
                                   (5, 128, 256), (300, 1024, 384)])
def test_w8a8_matmul(gen, dtype, m, k, n):
    """K-i at SAM's projection widths with ragged M (77, 130, 5 rows: the
    last 128-row block part empty), and at K = 1024. The kernel computes
    its plain version's arithmetic (chip_smoke.Q8_REL_L2_TOL)."""
    from chip_smoke import Q8_REL_L2_TOL, agreement
    x = _rnd(gen, m, k).to(dtype)
    w, b = _rnd(gen, k, n, std=k ** -0.5), _rnd(gen, n, std=0.1)
    got = _launched("w8a8_matmul", lambda: Q.w8a8_matmul(x, w, b))
    assert got.dtype == dtype
    ok, err, rel = agreement(got, Q.int8_dot(x, w, b), Q8_REL_L2_TOL)
    assert ok, (err, rel)


def test_w8a8_matmul_falls_back_off_the_128_grid(gen):
    """K or N off the 128 grid take int8_dot, as in JAX: no launch."""
    before = kernels.launches["w8a8_matmul"]
    for k, n in ((200, 256), (256, 200)):
        x, w = _rnd(gen, 9, k), _rnd(gen, k, n, std=0.05)
        _agree(Q.w8a8_matmul(x, w), Q.int8_dot(x, w))
    assert kernels.launches["w8a8_matmul"] == before


_SAM_DENSE = [(29400, 768, 2304), (29400, 768, 768), (24576, 768, 2304),
              (24576, 768, 768)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", _SAM_DENSE + [(29401, 768, 2304),
                                               (24575, 768, 768)])
def test_w8a8_matmul_at_sams_shapes(gen, dtype, m, k, n):
    """K-i at SAM's four projection shapes at 1024² and with a ragged last
    row tile, x, weight and bias all bf16 or all fp32 (the float-dtype
    path)."""
    from chip_smoke import Q8_REL_L2_TOL, agreement
    x = _rnd(gen, m, k).to(dtype)
    w = _rnd(gen, k, n, std=k ** -0.5).to(dtype)
    b = _rnd(gen, n, std=0.1).to(dtype)
    got = _launched("w8a8_matmul", lambda: Q.w8a8_matmul(x, w, b))
    assert got.dtype == dtype
    ok, err, rel = agreement(got, Q.int8_dot(x, w, b), Q8_REL_L2_TOL)
    assert ok, (err, rel)


def test_w8a8_matmul_refuses_what_the_kernel_does_not_take(gen):
    x = _rnd(gen, 4, 1664)
    with pytest.raises(ValueError):
        Q.w8a8_matmul(x, _rnd(gen, 1664, 128))         # K > 1536
    x = _rnd(gen, 4, 256)
    with pytest.raises(ValueError):
        Q.w8a8_matmul(x.half(), _rnd(gen, 256, 128))   # fp16 x
    with pytest.raises(ValueError):
        Q.w8a8_matmul(x, _rnd(gen, 256, 128).half())   # fp16 weight
    with pytest.raises(ValueError):
        Q.w8a8_matmul(x, _rnd(gen, 256, 128), _rnd(gen, 64))  # bias shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (1536, 128),
                                 (128, 384)])
def test_quantize_weight_t_at_k_is_shapes(gen, dtype, k, n):
    """The weight prep that K-i launches first (and K-f's wrapper calls) is
    quant.quantize_weight bit for bit on the card, transposed, for bf16 and
    fp32 weights at SAM's projection shapes; a zero column takes the 1e-8
    floor."""
    w = _rnd(gen, k, n, std=0.05).to(dtype)
    w[:, 3] = 0
    wt, sw = M.quantize_weight_t(w)
    q, s = Q.quantize_weight(w)
    assert torch.equal(wt, q.t().contiguous()) and torch.equal(sw, s)


@pytest.mark.parametrize("m", [1, 8, 11])
def test_int8_matmul_nk_is_deterministic(gen, m):
    """Every sum has a fixed order (no atomics): two runs are bit-equal."""
    t = Q.quantize_rows_table(torch.randn(151940, 896, generator=gen,
                                          device="cuda") * 0.02)
    x = _rnd(gen, m, 896)
    assert torch.equal(Q.quantized_matmul_nk(x, t["q"], t["s"]),
                       Q.quantized_matmul_nk(x, t["q"], t["s"]))


@pytest.mark.parametrize("b,gh,gw,heads,d,group", [
    (1, 32, 32, 2, 64, 256),        # four groups of p scales a row
    (2, 24, 40, 2, 64, 1024),       # K-h's ragged grid: one partial group
    (1, 64, 64, 2, 64, 1024),       # the global grid (rule "g64")
    (1, 16, 64, 2, 128, 512),       # head dim 128 (one consumer warpgroup)
    (1, 32, 32, 2, 64, 192),        # groups of 192: tiles that straddle
    (1, 64, 128, 1, 128, 1024),     # the widest tables at head dim 128
    (1, 14, 14, 2, 64, 64)])        # a window's grid, groups of 64
def test_relpos_attention_pv8(gen, b, gh, gw, heads, d, group):
    """K-d8 against its plain version with chip_smoke's rule: one p8 step
    (max|v| / 127) on top of the bf16 tolerance elementwise; and the trap
    (one p scale for the whole row), which the rule must fail."""
    from chip_smoke import REL_L2_TOL, agreement
    qkv = _rnd(gen, b, gh * gw, 3 * heads * d)
    rh, rw = _rnd(gen, gh, gh, d, std=0.1), _rnd(gen, gw, gw, d, std=0.1)
    kw = dict(heads=heads, scale=d ** -0.5, pv_int8=True, pv_group=group)
    got = _launched(f"relpos_attention_pv8[{gh}x{gw}]",
                    lambda: A.relpos_attention(qkv, rh, rw, **kw))
    vmax = float(qkv[..., 2 * heads * d:].abs().max())
    ok, err, rel = agreement(got, A.relpos_attention_plain(qkv, rh, rw, **kw),
                             REL_L2_TOL, vmax / 127)
    assert ok, (err, rel)
    if gh * gw > group:
        trap = A.relpos_attention_plain(qkv, rh, rw,
                                        **dict(kw, pv_group=gh * gw))
        ok, _, rel = agreement(got, trap, REL_L2_TOL, vmax / 127)
        assert not ok, rel


@pytest.mark.parametrize("shape", [(1, 6, 4096, 12, 64), (2, 3, 1000, 2, 128),
                                   (1, 2, 77, 1, 64)])
def test_pv8_quantization_is_bit_equal(gen, shape):
    """The kernels that make the int8 p@v launches' v operands (v8t, sv)
    before the attention kernel, against the PyTorch version they replace:
    bit for bit, on a head-split view of a packed projection (K-h's v, at
    SAM's 1024² global shape among others) and on K-d8's [B, S, H, d]."""
    b, _, s, heads, d = shape
    v = _rnd(gen, b, s, 3 * heads * d).view(b, s, 3, heads, d)[:, :, 2]
    for view in (v.transpose(1, 2), v.permute(0, 2, 1, 3)):
        v8t, sv = A.pv8_v_launch(view)
        want8, want_s = A.pv8_v_operands(view, 2)
        assert torch.equal(v8t, want8) and torch.equal(sv, want_s)


@pytest.mark.parametrize("b,gh,gw,heads", [(1, 32, 32, 2), (2, 8, 64, 3),
                                           (1, 64, 64, 2), (1, 40, 96, 2),
                                           (2, 12, 20, 2)])
def test_relpos_attention_qk8(gen, b, gh, gw, heads):
    """K-g against its plain attention on the prep's operands (the same
    exact int8 scores; the prep is held to `qk8_operands` below): grids 64,
    32 wide (the qrw columns at compile time) and 96, 20 wide (each lane
    steps them)."""
    qkv = _rnd(gen, b, gh * gw, 3 * heads * 64)
    rh, rw = _rnd(gen, gh, gh, 64, std=0.1), _rnd(gen, gw, gw, 64, std=0.1)
    kw = dict(heads=heads, scale=0.125)
    got = _launched(f"relpos_attention_qk8[{gh}x{gw}]",
                    lambda: A.relpos_attention_qk8(qkv, rh, rw, **kw))
    ops = A.qk8_prep_operands(A.qk8_prep(qkv, rh, rw, **kw), gh * gw)
    _agree(got, A.qk8_attention_plain(qkv, ops, heads=heads))


@pytest.mark.parametrize("b,gh,gw,heads", [(1, 32, 32, 2), (2, 8, 64, 3),
                                           (6, 64, 64, 12), (1, 40, 96, 2)])
def test_qk8_prep_against_qk8_operands(gen, b, gh, gw, heads):
    """K-g's prep kernel: k8 and sk bit-equal to `qk8_operands` on the card
    (the same roundings: the scale a multiply by fl(1/127), as PyTorch
    divides by a scalar here); q8, sq and qrw take q·Rh and q·Rw as sums in
    another order than cuBLAS's, so a byte may move one step and a bf16
    value one ulp, rarely (or, where a sum cancels to near 0, by fp32
    round-off of its terms: 1e-5 of the largest value)."""
    qkv = _rnd(gen, b, gh * gw, 3 * heads * 64)
    rh, rw = _rnd(gen, gh, gh, 64, std=0.1), _rnd(gen, gw, gw, 64, std=0.1)
    kw = dict(heads=heads, scale=0.125)
    want = A.qk8_operands(qkv, rh, rw, **kw)
    q8, k8, sq, skt, qrw = A.qk8_prep(qkv, rh, rw, **kw)
    s = gh * gw
    assert torch.equal(k8, want[1])
    assert torch.equal(skt[..., :s].transpose(1, 2), want[3])
    assert int((q8.int() - want[0].int()).abs().max()) <= 1
    assert float((q8 == want[0]).float().mean()) >= 0.999
    for got, ref in ((sq, want[2]), (qrw.float(), want[4])):
        ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
        assert bool(((got - ref).abs()
                     <= ulp + 1e-5 * float(ref.abs().max())).all())
        assert float((got == ref).float().mean()) >= 0.999


def test_int8_attention_refuses_what_the_kernels_do_not_take(gen):
    qkv = _rnd(gen, 1, 32 * 32, 3 * 2 * 128)
    rh, rw = _rnd(gen, 32, 32, 128), _rnd(gen, 32, 32, 128)
    with pytest.raises(ValueError):                   # head dim 128
        A.relpos_attention_qk8(qkv, rh, rw, heads=2, scale=0.1)
    with pytest.raises(ValueError):                   # group not of 64s
        A.relpos_attention(qkv, rh, rw, heads=2, scale=0.1, pv_int8=True,
                           pv_group=100)


def _kh_operands(gen, b, heads, gh, gw, d, std=1.0):
    """q, k, v [B, H, S, d] as views of a packed projection (as SAM passes
    them) and the bf16 tables q·Rh, q·Rw."""
    s = gh * gw
    qkv = _rnd(gen, b, s, 3 * heads * d, std=std)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    return (q, k, v, _rnd(gen, b, heads, s, gh, std=0.5),
            _rnd(gen, b, heads, s, gw, std=0.5))


@pytest.mark.parametrize("b,heads,gh,gw,d,bq,bk", [
    (1, 2, 80, 80, 64, 4096, 1024),     # SAM's global grid at 1280²
    (1, 2, 80, 80, 128, 4096, 1024),
    (2, 2, 24, 40, 64, 4096, 1024),     # ragged: one partial kv tile
    (1, 2, 40, 40, 64, 4096, 1024),     # keys past 1024 dropped, as in JAX
    (1, 2, 40, 40, 128, 4096, 1024),
    (2, 2, 48, 64, 64, 4096, 1024),     # ragged, 64 wide: column table
    (2, 2, 48, 64, 128, 4096, 1024),
    (1, 2, 16, 100, 128, 1024, 1024)])  # head dim 128
def test_flash_attention_relpos(gen, b, heads, gh, gw, d, bq, bk):
    """K-h's streaming form (float arm) against its plain version."""
    ops = _kh_operands(gen, b, heads, gh, gw, d, std=0.5)
    kw = dict(scale=d ** -0.5, grid_w=gw, block_q=bq, block_k=bk)
    assert A.kh_form(gh * gw, d, gw, bq, bk)[0] == "stream"
    got = _launched(f"flash_attention_relpos[{gh}x{gw}]",
                    lambda: A.flash_attention_relpos(*ops, **kw))
    _agree(got, A.flash_attention_relpos_plain(*ops, **kw))


@pytest.mark.parametrize("b,heads,gh,gw,d", [(1, 2, 80, 80, 64),
                                             (2, 2, 24, 40, 64),
                                             (1, 2, 32, 64, 128),
                                             (1, 2, 8, 256, 64),
                                             (1, 2, 40, 40, 64),
                                             (1, 2, 16, 96, 64),
                                             (1, 1, 3, 600, 64),
                                             (1, 1, 5, 300, 128)])
def test_flash_attention_relpos_pv8(gen, b, heads, gh, gw, d):
    """K-h's int8 p@v arm (p per row of each 1024-column kv tile) with
    chip_smoke's rule, and the trap (one p scale for the whole row) that the
    rule must fail, on every rule of the plan: "wide" (80x80, SAM at 1280²;
    16x96, keys past 1024 dropped), "any" (24x40, one ragged group; 40x40,
    keys past 1024 dropped; 8x256, a grid 256 wide, which the float forms
    refuse), "global" (3x600, tables too wide for shared memory; head dim
    128)."""
    from chip_smoke import REL_L2_TOL, agreement, kh_whole_row_trap
    ops = _kh_operands(gen, b, heads, gh, gw, d)
    kw = dict(scale=d ** -0.5, grid_w=gw, block_q=4096, block_k=1024,
              quant8=True)
    got = _launched(f"flash_attention_relpos_pv8[{gh}x{gw}]",
                    lambda: A.flash_attention_relpos(*ops, **kw))
    vmax = float(ops[2].abs().max())
    ok, err, rel = agreement(got, A.flash_attention_relpos_plain(*ops, **kw),
                             REL_L2_TOL, vmax / 127)
    assert ok, (err, rel)
    if gh * gw > 1024:
        ok, _, rel = agreement(got, kh_whole_row_trap(*ops, **kw),
                               REL_L2_TOL, vmax / 127)
        assert not ok, rel


@pytest.mark.parametrize("quant8", [False, True])
@pytest.mark.parametrize("b,heads,g,bk", [(1, 2, 64, 1024), (2, 2, 32, 512)])
def test_flash_attention_relpos_fused(gen, quant8, b, heads, g, bk):
    """K-h's fused form (d + gh <= 128, aligned tiles)."""
    from chip_smoke import REL_L2_TOL, agreement
    ops = _kh_operands(gen, b, heads, g, g, 64, std=0.5)
    kw = dict(scale=0.125, grid_w=g, block_q=g * g, block_k=bk,
              quant8=quant8)
    name = "flash_attention_relpos_fused" + ("_pv8" if quant8 else "")
    got = _launched(f"{name}[{g}x{g}]",
                    lambda: A.flash_attention_relpos(*ops, **kw))
    extra = float(ops[2].abs().max()) / 127 if quant8 else 0.0
    ok, err, rel = agreement(got, A.flash_attention_relpos_plain(*ops, **kw),
                             REL_L2_TOL, extra)
    assert ok, (err, rel)


@pytest.mark.parametrize("b,heads,g,bk", [(1, 2, 64, 1024), (2, 2, 32, 512)])
def test_flash_attention_relpos_fused_pv8_sees_the_trap(gen, b, heads, g, bk):
    """The fused form's int8 arm (rule "g64" at 64x64, "global" at 32x32)
    on peaked rows (N(0, 1) operands, as chip_smoke draws them): within
    the int8 rule of its plain version, and the trap (one p scale for the
    whole row) outside it."""
    from chip_smoke import REL_L2_TOL, agreement, kh_whole_row_trap
    ops = _kh_operands(gen, b, heads, g, g, 64)
    kw = dict(scale=0.125, grid_w=g, block_q=g * g, block_k=bk, quant8=True)
    got = _launched(f"flash_attention_relpos_fused_pv8[{g}x{g}]",
                    lambda: A.flash_attention_relpos(*ops, **kw))
    extra = float(ops[2].abs().max()) / 127
    ok, err, rel = agreement(got, A.flash_attention_relpos_plain(*ops, **kw),
                             REL_L2_TOL, extra)
    assert ok, (err, rel)
    ok, _, rel = agreement(got, kh_whole_row_trap(*ops, **kw), REL_L2_TOL,
                           extra)
    assert not ok, rel


@pytest.mark.parametrize("b,heads,gh,gw,d", [(150, 2, 14, 14, 64),
                                             (5, 2, 14, 14, 128),
                                             (5, 2, 20, 20, 64),
                                             (5, 2, 20, 20, 128),
                                             (3, 2, 16, 20, 128)])
def test_flash_attention_relpos_small(gen, b, heads, gh, gw, d):
    """K-h's small form (S padded to 512 or less: 196 tokens in 256, a
    16x20 grid in 384), which has no int8 arm: resident whole-row at 14x14,
    two passes over kv above 256 keys."""
    ops = _kh_operands(gen, b, heads, gh, gw, d, std=0.5)
    s = gh * gw
    bq = bk = 256 if s <= 256 else 1024
    for quant8 in (False, True):
        kw = dict(scale=d ** -0.5, grid_w=gw, block_q=bq, block_k=bk,
                  quant8=quant8)
        assert A.kh_form(s, d, gw, bq, bk)[0] == (
            "small" if s <= 256 else "small2")
        got = _launched(f"flash_attention_relpos_mh[{gh}x{gw}]",
                        lambda: A.flash_attention_relpos(*ops, **kw))
        _agree(got, A.flash_attention_relpos_plain(*ops, **kw))


@pytest.mark.parametrize("g", [112, 128])
def test_flash_attention_relpos_large_grids(gen, g):
    """K-h's float form at SAM 1792² (112x112: the tables in shared memory)
    and 2048² (128x128: read where they lie), which the int8 arm's rule
    takes too, against the plain version."""
    ops = _kh_operands(gen, 1, 12, g, g, 64, std=0.5)
    kw = dict(scale=0.125, grid_w=g, block_q=1024, block_k=1024)
    got = _launched(f"flash_attention_relpos[{g}x{g}]",
                    lambda: A.flash_attention_relpos(*ops, **kw))
    _agree(got, A.flash_attention_relpos_plain(*ops, **kw))


def test_flash_attention_relpos_refuses_what_the_kernel_does_not_take(gen):
    q, k, v, qrh, qrw = _kh_operands(gen, 1, 2, 24, 40, 64)
    with pytest.raises(ValueError):                   # grid_w does not divide
        A.flash_attention_relpos(q, k, v, qrh, qrw, scale=0.1, grid_w=41)
    with pytest.raises(ValueError):                   # fp32 operands
        A.flash_attention_relpos(q.float(), k.float(), v.float(),
                                 qrh.float(), qrw.float(), scale=0.1,
                                 grid_w=40)
    with pytest.raises(ValueError):                   # int8 group of 1000
        A.flash_attention_relpos(q, k, v, qrh, qrw, scale=0.1, grid_w=40,
                                 block_k=1000, quant8=True)


# K-l and K-m: the window alternates and the head-packed prep, at a small
# shape and at their benchmarks' (150 windows of 14x14, 6 views of 64x64,
# 12 heads, head dim 64); qkv N(0, 1), tables 0.3·N(0, 1) as those scripts
# draw them.
_WINDOW_KINDS = [("fused", {}), ("fused2", {}), ("v3", {}),
                 ("v3", {"bias_mode": "bcast"}), ("v4", {}), ("phased", {})]


def _window_operands(gen, b, win, heads, d):
    return (_rnd(gen, b, win * win, 3 * heads * d),
            _rnd(gen, win, win, d, std=0.3), _rnd(gen, win, win, d, std=0.3))


_WINDOW_SHAPES = [(5, 7, 3, 64), (3, 16, 2, 128), (150, 14, 12, 64)]
# the resident whole-row kernel at every kv-row count it instantiates (S =
# 49, 64, 196, 256 keys in 64, 64, 208, 256 rows), head dims 64 and 128
_WHOLE_ROW_SHAPES = [(3, win, 2, d) for win in (7, 8, 14, 16)
                     for d in (64, 128) if (3, win, 2, d) not in _WINDOW_SHAPES]


@pytest.mark.parametrize("kind,opts,b,win,heads,d", [
    (kind, opts, *shape) for kind, opts in _WINDOW_KINDS
    for shape in _WINDOW_SHAPES + _WHOLE_ROW_SHAPES
    # the fused variant needs d + 2·win <= 128, as in JAX
    if kind != "fused" or shape[3] + 2 * shape[1] <= 128])
def test_window_attention_rows(gen, kind, opts, b, win, heads, d):
    """K-l's five bodies (one kernel, window_attention_rows.cu) against
    their plain versions; v4 also launches its prep."""
    qkv, rh, rw = _window_operands(gen, b, win, heads, d)
    kw = dict(scale=d ** -0.5, heads=heads, win=win, **opts)
    prep = kernels.launches["qr_prep[rows]"]
    got = _launched(f"window_attention_rows[{kind}]", lambda: getattr(
        A, f"window_attention_{kind}")(qkv, rh, rw, **kw))
    assert kernels.launches["qr_prep[rows]"] == prep + (kind == "v4")
    _agree(got, getattr(A, f"window_attention_{kind}_plain")(qkv, rh, rw,
                                                             **kw))


@pytest.mark.parametrize("b,win,heads,d", _WINDOW_SHAPES + [(4, 14, 5, 128)])
def test_window_bias_prep(gen, b, win, heads, d):
    """K-l's prep (qr_prep.cu, mode rows): bf16 rows from fp32 sums, so at
    most one bf16 rounding apart from the plain version; windows of 49,
    196 and 256 tokens (7, 14 and 16 wide lines in 16-slot tiles), head
    dims 64 and 128, heads split over blocks."""
    qkv, rh, rw = _window_operands(gen, b, win, heads, d)
    got = _launched("qr_prep[rows]", lambda: A.window_bias_prep(
        qkv, rh, rw, heads=heads, win=win))
    for g, w in zip(got, A.window_bias_prep_plain(qkv, rh, rw, heads=heads,
                                                  win=win)):
        _agree(g, w)


def _global_operands(gen, b, gh, gw, heads):
    return (_rnd(gen, b, gh * gw, 3 * heads * 64),
            _rnd(gen, gh, gh, 64, std=0.3), _rnd(gen, gw, gw, 64, std=0.3))


@pytest.mark.parametrize("b,gh,gw,heads", [(1, 16, 64, 2), (2, 8, 32, 3),
                                           (6, 64, 64, 12), (3, 24, 40, 5)])
def test_hpacked_prep(gen, b, gh, gw, heads):
    """K-m's prep (qr_prep.cu, modes qk and v) against its plain version;
    at 24x40 a grid row (40 tokens) and a column (24) leave a ragged last
    16-token tile."""
    qkv, rh, rw = _global_operands(gen, b, gh, gw, heads)
    kw = dict(heads=heads, grid_w=gw, scale=0.125)
    for mode in ("qk", "v"):
        got = _launched(f"qr_prep[{mode}]", lambda: A.hpacked_prep(
            qkv, rh, rw, modes=(mode,), **kw))
        for g, w in zip(got, A.hpacked_prep_plain(qkv, rh, rw, modes=(mode,),
                                                  **kw)):
            _agree(g, w)


@pytest.mark.parametrize("b,gh,gw,heads,bq,bk", [(1, 16, 64, 2, 1024, 512),
                                                 (2, 8, 32, 3, 256, 128),
                                                 (6, 64, 64, 12, 4096, 1024)])
def test_flash_attention_relpos_hpacked_prepped(gen, b, gh, gw, heads, bq, bk):
    """K-m: the prep, then K-h's fused form on strided views of the lane
    blocks (the width table read out of v_aug). The kernel rounds p against
    the running maximum of 64-key tiles, the plain version of block_k: on
    rows this peaked (qkv N(0, 1)) that allows max|v| / 128, as
    chip_smoke's K-m case states."""
    from chip_smoke import REL_L2_TOL, agreement
    qkv, rh, rw = _global_operands(gen, b, gh, gw, heads)
    kw = dict(scale=0.125, grid_w=gw, heads=heads, block_q=bq, block_k=bk)
    got = _launched(f"flash_attention_relpos_hpacked_prepped[{gh}x{gw}]",
                    lambda: A.flash_attention_relpos_hpacked_prepped(
                        qkv, rh, rw, **kw))
    ok, err, rel = agreement(
        got, A.flash_attention_relpos_hpacked_prepped_plain(qkv, rh, rw,
                                                            **kw),
        REL_L2_TOL, float(qkv[..., 2 * heads * 64:].abs().max()) / 128)
    assert ok, (err, rel)


def test_window_and_prep_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qkv, rh, rw = _window_operands(gen, 2, 7, 2, 32)
    with pytest.raises(ValueError):                   # head dim 32
        A.window_attention_v3(qkv, rh, rw, scale=0.1, heads=2, win=7)
    with pytest.raises(ValueError):                   # head dim 32
        A.window_bias_prep(qkv, rh, rw, heads=2, win=7)
    qkv, rh, rw = _window_operands(gen, 1, 20, 2, 64)
    with pytest.raises(ValueError):                   # a window over 16 wide
        A.window_bias_prep(qkv, rh, rw, heads=2, win=20)
    qkv, rh, rw = _window_operands(gen, 2, 7, 2, 64)
    with pytest.raises(ValueError):                   # fp32 qkv
        A.window_attention_v4(qkv.float(), rh, rw, scale=0.1, heads=2, win=7)
    qkv, rh, rw = _window_operands(gen, 2, 16, 2, 128)
    with pytest.raises(ValueError):                   # d + 2·win > 128
        A.window_attention_fused(qkv, rh, rw, scale=0.1, heads=2, win=16)
    qkv, rh, rw = _global_operands(gen, 1, 16, 64, 2)
    with pytest.raises(ValueError):                   # grid_w does not divide
        A.flash_attention_relpos_hpacked_prepped(
            qkv, rh, rw, scale=0.1, grid_w=64, heads=2, block_q=1024,
            block_k=96)
    with pytest.raises(ValueError):                   # fp32 qkv
        A.hpacked_prep(qkv.float(), rh, rw, heads=2, grid_w=64, scale=0.1)


_BISECT_SHAPES = [(5, 8, 3), (150, 14, 12)]          # (windows, win, heads)
# the whole-row kernel's other kv-row counts (S = 49 and 256)
_BISECT_WHOLE_ROW = [(3, 7, 2), (3, 16, 2)]


def _bisect_operands(gen, b, win, heads):
    """qkv N(0, 1) and bias2's rows and expanders, as the B-1 script draws
    them (qrh 0.3·N(0, 1), eh 0.1·N(0, 1)), distinct qrw / ew."""
    s = win * win
    return (_rnd(gen, b, s, 3 * heads * 64),
            _rnd(gen, b, heads, s, 16, std=0.3),
            _rnd(gen, b, heads, s, 16, std=0.3),
            _rnd(gen, 16, s, std=0.1), _rnd(gen, 16, s, std=0.1))


@pytest.mark.parametrize("variant,b,win,heads", [
    (variant, *shape) for variant in A.BISECT_VARIANTS
    for shape in _BISECT_SHAPES + _BISECT_WHOLE_ROW
    # dots_qk keeps the first 64 key columns: S >= 64
    if variant != "dots_qk" or shape[1] ** 2 >= 64])
def test_window_attention_bisect(gen, variant, b, win, heads):
    """B-1's four modes of window_attention_rows.cu against their plain
    versions with chip_smoke's rule (the softmax modes allow max|v| / 128 on
    these peaked rows); bias2 also fails its one-hot trap."""
    from chip_smoke import REL_L2_TOL, agreement, bias2_gather_trap
    qkv, qrh, qrw, eh, ew = _bisect_operands(gen, b, win, heads)
    kw = dict(variant=variant, heads=heads, scale=0.125, qrh=qrh, qrw=qrw,
              eh=eh, ew=ew)
    got = _launched(f"window_attention_rows[{variant}]",
                    lambda: A.window_attention_bisect(qkv, **kw))
    extra = (float(qkv[..., 2 * heads * 64:].abs().max()) / 128
             if variant in ("softmax", "bias2") else 0.0)
    ok, err, rel = agreement(got, A.window_attention_bisect_plain(qkv, **kw),
                             REL_L2_TOL, extra)
    assert ok, (err, rel)
    if variant == "bias2":
        trap_ok, _, trap_rel = agreement(got, bias2_gather_trap(qkv, **kw),
                                         REL_L2_TOL, extra)
        assert not trap_ok, trap_rel


@pytest.mark.parametrize("b,win,heads", _BISECT_SHAPES + _BISECT_WHOLE_ROW)
def test_window_attention_hmaj(gen, b, win, heads):
    """B-2 (the kHmaj mode: softmax on head-major q, k, v, read by TMA
    through the views' own strides) against its plain version, on strided
    views of a packed projection and on every other head of a head-major
    tensor, and on contiguous copies of both (the same output)."""
    from chip_smoke import REL_L2_TOL, agreement
    s = win * win
    qkv = _rnd(gen, b, s, 3 * heads * 64)
    every_other = tuple(_rnd(gen, b, 2 * heads, s, 64)[:, ::2]
                        for _ in range(3))
    kw = dict(scale=0.125)
    for views in (A._split_qkv(qkv, heads), every_other):
        got = _launched("window_attention_rows[hmaj]",
                        lambda: A.window_attention_hmaj(*views, **kw))
        ok, err, rel = agreement(
            got, A.window_attention_hmaj_plain(*views, **kw), REL_L2_TOL,
            float(views[2].abs().max()) / 128)
        assert ok, (err, rel)
        copies = [t.contiguous() for t in views]
        assert torch.equal(A.window_attention_hmaj(*copies, **kw), got)


def test_bisect_wrappers_refuse_what_the_kernel_does_not_take(gen):
    qkv = _rnd(gen, 2, 49, 3 * 2 * 32)
    with pytest.raises(ValueError):                   # head dim 32
        A.window_attention_bisect(qkv, variant="softmax", heads=2,
                                  scale=0.1)
    qkv = _rnd(gen, 2, 289, 3 * 2 * 64)
    with pytest.raises(ValueError):                   # S 289 > 256
        A.window_attention_bisect(qkv, variant="softmax", heads=2,
                                  scale=0.1)
    q = _rnd(gen, 2, 2, 49, 64)
    with pytest.raises(ValueError):                   # fp32
        A.window_attention_hmaj(q.float(), q.float(), q.float(), scale=0.1)


def test_greedy_generate_multi_on_card(gen, monkeypatch):
    """The tiny model on the card (fp32): greedy_generate_multi over G = 2
    groups of B = 2 (a right-padded prompt) equals two greedy_generate
    calls, on float images and on uint8 frames preprocessed on the card."""
    from lvv_tpu_torch import (VQAModel, greedy_generate,
                               greedy_generate_multi, preprocess_views,
                               tiny_config)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tiny_config().model
    card = VQAModel(cfg, dtype=torch.float32, device="cuda", seed=3)
    g = torch.Generator().manual_seed(2)
    args = [torch.randn(2, 2, 32, 24, 24, generator=g),
            torch.rand(2, 2, 6, 3, 64, 64, generator=g) * 2 - 1,
            torch.ones(2, 2, 6, dtype=torch.bool),
            torch.randint(0, 500, (2, 2, 6), generator=g),
            torch.tensor([[6, 4], [5, 6]])]
    frames = torch.randint(0, 256, (2, 2, 6, 45, 80, 3), generator=g,
                           dtype=torch.uint8)
    for images in (args[1], frames):
        toks, lens = greedy_generate_multi(card, args[0], images, *args[2:],
                                           max_new_tokens=6, eos_id=2)
        for i in range(2):
            img = images[i]
            if img.dtype == torch.uint8:
                img = preprocess_views(img.flatten(0, 1).cuda(), 64).unflatten(
                    0, (2, 6))
            want, wlen = greedy_generate(card, args[0][i], img,
                                         *(a[i] for a in args[2:]),
                                         max_new_tokens=6, eos_id=2)
            assert torch.equal(toks[i], want) and torch.equal(lens[i], wlen)


def test_serving_batch_with_ragged_prompts_against_plain_kernels(gen):
    """bench.py's serving model at full width, B = 4 frames of
    serving_bench.py's inputs with two prompts cut short (17 and 9 of 24
    tokens): the launch counts of one generate are those of batch 1, and
    every row's prefill and first-step logits are within chip_smoke's
    LOGITS_REL_TOL of the same batch with every kernel swapped for its plain
    version."""
    import chip_smoke as C
    from lvv_tpu_torch import (VQAModel, greedy_generate,
                               prepare_serving_params_fused)
    cfg = C.config(1024, quant8=True)
    model = VQAModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    packed = prepare_serving_params_fused(model)
    args = [torch.as_tensor(a, device="cuda") for a in
            C.serving_batch_inputs(cfg, 4, ragged=((1, 17), (3, 9)))]
    with C.q8_scope_env("mlp"):
        kernels.launches.clear()
        greedy_generate(model, *args, max_new_tokens=C.NEW_TOKENS,
                        eos_id=C.EOS_ID, params_decode=packed)
        counts = {k: v for k, v in kernels.launches.items() if v}
        assert counts == C.expected_launches(cfg, serving=True)
        report, _ = C.against_plain_kernels(torch, model, args, packed)
    for key in ("logits_rel_l2_vs_plain_by_row",
                "step_logits_rel_l2_vs_plain_by_row"):
        assert len(report[key]) == 4
        assert max(report[key]) <= C.LOGITS_REL_TOL, report


def _tiny_on_card(monkeypatch):
    """The tiny model on the card in fp32 (TF32 off) and four requests of
    129-token ByteTokenizer prompts (the engines' width)."""
    import numpy as np
    from lvv_tpu_torch import VQAModel, tiny_config
    from lvv_tpu_torch.data import ByteTokenizer, pack_text
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tiny_config().model
    model = VQAModel(cfg, dtype=torch.float32, device="cuda", seed=4)
    tok = ByteTokenizer(cfg.llm.special_tokens)
    rng = np.random.default_rng(0)
    reqs = []
    for q in ("what is ahead?", "any cyclists?", "is it raining?",
              "how many lanes?"):
        ids, _, n, _ = pack_text(tok, q, None, 128, 0)
        reqs.append(dict(
            bev=rng.standard_normal((32, 24, 24)).astype(np.float32),
            images=rng.uniform(-1, 1, (6, 3, 64, 64)).astype(np.float32),
            view_valid=np.ones(6, bool), text_ids=ids, text_len=n))
    return model, tok, reqs


class _HeldQueue(queue.Queue):
    """A request queue that reads as empty until `release` is set: the
    continuous engine's worker, which polls it, then admits everything
    queued before at once, however the threads interleave."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()

    def empty(self):
        return not self.release.is_set() or super().empty()


def _padded_greedy(model, rows, n, eos, **kw):
    import numpy as np
    from lvv_tpu_torch import greedy_generate
    rows = rows + [rows[0]] * (n - len(rows))
    args = [torch.as_tensor(np.stack([r[k] for r in rows]), device="cuda")
            for k in ("bev", "images", "view_valid", "text_ids")]
    lens = torch.tensor([r["text_len"] for r in rows], device="cuda")
    toks, out = greedy_generate(model, *args, lens, max_new_tokens=6,
                                eos_id=eos, **kw)
    return [toks[i, :out[i]].tolist() for i in range(len(rows))]


@pytest.mark.parametrize("packed", [False, True])
def test_serving_engines_on_card(gen, monkeypatch, packed):
    """ServingEngine: three requests in one bucket of 4 answer as
    greedy_generate on that padded batch; ContinuousServingEngine: a burst
    of three answers as greedy_generate on the padded batch at the slab's
    cache length; with the float decode and the packed int8 decode
    (kernels K-j, K-k launched)."""
    from lvv_tpu_torch import prepare_serving_params_fused
    from lvv_tpu_torch.inference import (ContinuousServingEngine,
                                         ServingEngine)
    model, tok, reqs = _tiny_on_card(monkeypatch)
    pd = prepare_serving_params_fused(model) if packed else None

    with ServingEngine(model, tok, max_batch=4, max_wait_ms=2000,
                       max_new_tokens=6, params_decode=pd) as eng:
        futs = [eng.submit(r["bev"], r["images"], r["view_valid"],
                           r["text_ids"], r["text_len"]) for r in reqs[:3]]
        got = [f.result(timeout=300)[0] for f in futs]
        assert eng.stats()["batch_sizes"] == [3]
    assert got == _padded_greedy(model, reqs[:3], 4, tok.eos_id,
                                 params_decode=pd)[:3]
    before = dict(kernels.launches)
    with ContinuousServingEngine(model, tok, slots=4, chunk_steps=2,
                                 max_new_tokens=6, params_decode=pd) as eng:
        eng._queue = held = _HeldQueue()
        futs = [eng.submit(r["bev"], r["images"], r["view_valid"],
                           r["text_ids"], r["text_len"]) for r in reqs[:3]]
        held.release.set()
        got = [f.result(timeout=300)[0] for f in futs]
        max_cache = eng.max_cache(reqs[0]["text_ids"].shape[0])
        assert eng.stats()["admission_batches"] == 1
    assert got == _padded_greedy(model, reqs[:3], 4, tok.eos_id,
                                 params_decode=pd, max_cache=max_cache)[:3]
    assert (kernels.launches["int8_matmul"] > before.get("int8_matmul", 0)
            ) == packed


def test_model_loader_round_trip_on_card(gen, monkeypatch, tmp_path):
    """save_checkpoint, then ModelLoader.load_all() with no device: the
    model comes back on the card, every tensor bit-equal."""
    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.inference import ModelLoader, save_checkpoint
    model, _, _ = _tiny_on_card(monkeypatch)
    cfg = C.override(C.tiny_config(), "model.dtype", "float32")
    for path in ("model.llm_lora.enabled", "model.clip_lora.enabled"):
        cfg = C.override(cfg, path, False)
    save_checkpoint(model, cfg, tmp_path)
    again, _ = ModelLoader(tmp_path).load_all()
    assert again.device.type == "cuda"
    want = model.state_dict()
    for k, v in again.state_dict().items():
        assert torch.equal(v, want[k]), k
