"""The sm_90a schedules of the two MLP kernels, K-b and K-f, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold them to their plain versions there). These tests
emulate each kernel's arithmetic step by step in plain PyTorch: the
LayerNorm pass, the two products over the [128, 128] output tiles that the
persistent blocks walk (`mlp_plan`), the first product's epilogue (K-f:
the maxima of |h| over 64-column panels, reduced to each chunk's row
scale), K-f's second product over one grid slice per hidden chunk and the
chunks' parts added in chunk order. The emulations are held to the plain
versions, which tests/test_torch_ops.py and test_torch_quant.py hold to
interpret-mode Pallas; K-f's is also held to interpret-mode Pallas directly
at a chunk narrower than H (in float32, where it computes the activation as
the plain version does). The schedule function is pinned at every shape
the paths give the kernels.

Tolerances: chip_smoke.py's. K-b's tiles sum each product in another order
than the plain version's matmul, and both kernels take tanh-GELU as
z / (1 + exp(-2u)), a few fp32 ulps from the plain version's tanh: outputs
may land a bf16 rounding apart (4 ulps of (|plain| + rms(plain)), 1/128
relative L2; K-f 1/512, an int8 rounding flip of h8 allowed). With the
plain version's own activation, K-f's emulation is the plain version bit
for bit: every product is exact in int32, and the scales, the fold and the
chunk order are the same.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import Q8_REL_L2_TOL, agreement
from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu_torch.ops import fused_mlp as M
from lvv_tpu_torch.ops import quant as Q
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TILE = 128
BF = torch.bfloat16


def act_sm90(name: str, z: torch.Tensor) -> torch.Tensor:
    """gemm_sm90.cuh's mlp_act in fp32."""
    if name == "gelu":
        u = 0.7978845608028654 * (z + 0.044715 * z * z * z)
        return z / (1 + torch.exp(-2 * u))
    return z / (1 + torch.exp(-1.702 * z))


def act_plain(name: str, z: torch.Tensor) -> torch.Tensor:
    """The plain versions' activation (fused_mlp._act)."""
    if name == "gelu":
        return F.gelu(z, approximate="tanh")
    return z / (1.0 + torch.exp(-1.702 * z))


def tile_walk(rows: int, cols: int, slices: int, blocks: int, bn: int):
    """(slice, row0, col0) of each [128, bn] tile in the order the
    persistent blocks take them: block b the tiles b, b + blocks, ...,
    column tiles fastest. Each tile comes exactly once."""
    tn, tm = -(-cols // bn), -(-rows // TILE)
    seen = []
    for b in range(blocks):
        for t in range(b, tn * tm * slices, blocks):
            seen.append((t // (tn * tm), (t // tn % tm) * TILE,
                         (t % tn) * bn))
    assert len(seen) == len(set(seen)) == tn * tm * slices
    return seen


def product(a, b, rows: int, cols: int, slices: int, blocks: int, bn: int,
            epi):
    """The GEMM core: epi(acc, slice, row0, col0) for every [128, bn] tile
    of a [rows, K] @ b [K, cols], K split into `slices` equal slices; acc
    is the tile's fp32 sum (int8 operands: exact, as int32)."""
    kc = a.shape[1] // slices
    for z, r0, c0 in tile_walk(rows, cols, slices, blocks, bn):
        at = a[r0:r0 + TILE, z * kc:(z + 1) * kc]
        bt = b[z * kc:(z + 1) * kc, c0:c0 + bn]
        if at.dtype == torch.int8:
            acc = torch.matmul(at.double(), bt.double()).float()
        else:
            acc = at.float() @ bt.float()
        epi(acc, z, r0, c0)


def emulate_kb(x, ls, lb, w1, b1, w2, b2, *, act, eps=1e-6):
    """ln_mlp_residual.cu: mlp_ln_bf16, then the two products."""
    n, c = x.shape
    h = w1.shape[1]
    plan = M.mlp_plan(n, c, h)
    assert plan["slices"] == 1
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / c
    var = (xf - mean).square().sum(-1, keepdim=True) / c
    y = ((xf - mean) * torch.rsqrt(var + eps) * ls.float()
         + lb.float()).to(BF)
    hb = torch.full((n, h), float("nan"))

    def first(acc, z, r0, c0):
        zz = (acc + b1[c0:c0 + TILE].float()).to(BF).float()
        hb[r0:r0 + TILE, c0:c0 + TILE] = act_sm90(act, zz).to(BF).float()
    product(y, w1, n, h, 1, plan["blocks"][0], TILE, first)
    out = torch.full((n, c), float("nan"))

    def second(acc, z, r0, c0):
        cols = slice(c0, c0 + plan["bn2"])
        out[r0:r0 + TILE, cols] = xf[r0:r0 + TILE, cols] + (
            acc + b2[cols].float())
    product(hb.to(BF), w2, n, c, 1, plan["blocks"][1], plan["bn2"], second)
    assert not out.isnan().any()
    return out.to(BF)


def emulate_kf(x, ls, lb, w1, b1, w2, b2, *, act, block_h, act_fn=act_sm90,
               eps=1e-6):
    """ln_mlp_residual_q8.cu: the weights as the wrapper quantizes them,
    mlp_ln_q8, the first product with its panel maxima, mlp_quant_h, the
    second product over one slice per chunk, mlp_combine."""
    n, c = x.shape
    h = w1.shape[1]
    plan = M.mlp_plan(n, c, h, block_h)
    chunks = plan["slices"]
    assert chunks == h // block_h
    w1q, s1 = Q.quantize_weight(w1)
    w2q, s2 = Q.quantize_weight(w2)
    y8, sy = Q.quantize_rows(M._ln_f32(x, ls, lb, eps))
    hb = torch.full((n, h), float("nan"))
    pmax = torch.full((n, h // 64), float("nan"))

    def first(acc, z, r0, c0):
        cols = slice(c0, c0 + TILE)
        zz = acc * sy[r0:r0 + TILE] * s1[cols] + b1[cols].float()
        ht = act_fn(act, zz.to(x.dtype).float()).to(x.dtype).float()
        hb[r0:r0 + TILE, cols] = ht
        for p in range(0, ht.shape[1], 64):     # the tile's 64-wide panels
            panel = ht[:, p:p + 64].abs().amax(1)
            pmax[r0:r0 + TILE, (c0 + p) // 64] = panel
    product(y8, w1q, n, h, 1, plan["blocks"][0], TILE, first)
    # mlp_quant_h: each chunk's row scale from its panels' maxima
    amax = pmax.view(n, chunks, block_h // 64).amax(-1)
    sh = torch.clamp_min(amax / 127.0, 1e-8)
    h8 = torch.round(hb.view(n, chunks, block_h) / sh[..., None])
    h8 = torch.clamp(h8, -127, 127).to(torch.int8).view(n, h)
    parts = torch.full((chunks, n, c), float("nan"))

    def second(acc, z, r0, c0):
        cols = slice(c0, c0 + plan["bn2"])
        parts[z, r0:r0 + TILE, cols] = acc * sh[r0:r0 + TILE, z:z + 1] * s2[
            cols]
    product(h8, w2q, n, c, chunks, plan["blocks"][1], plan["bn2"], second)
    acc = parts[0]
    for part in parts[1:]:              # mlp_combine: chunk order
        acc = acc + part
    return ((x.float() + acc) + b2.float()).to(x.dtype)


def _inputs(n, c, h, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((n, c)),
              1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
              rng.standard_normal((c, h)) / math.sqrt(c),
              0.1 * rng.standard_normal(h),
              rng.standard_normal((h, c)) / math.sqrt(h),
              0.1 * rng.standard_normal(c)]
    return [torch.from_numpy(a.astype(np.float32)).to(BF) for a in arrays]


# (tokens, C, H) at every shape the paths give the kernels, and the
# schedule: the second product's tile width, each product's tiles and
# blocks, K-f's slices
SAM, CLIP = (768, 3072), (1024, 4096)
PLANS = [
    # 1024²: SAM's 12 blocks, CLIP's 24 layers
    ((24576,) + SAM, 256, (4608, 576), (264, 132), 1),
    ((1542,) + CLIP, 128, (416, 104), (264, 104), 1),
    ((1542,) + CLIP + (2048,), 128, (416, 208), (264, 208), 2),
    # 1280²
    ((38400,) + SAM, 256, (7200, 900), (264, 132), 1),
    ((2406,) + CLIP, 128, (608, 152), (264, 152), 1),
    ((2406,) + CLIP + (2048,), 128, (608, 304), (264, 264), 2),
    # serving-batch[8] (K-f)
    ((196608,) + SAM + (3072,), 128, (36864, 9216), (264, 264), 1),
    ((12336,) + CLIP + (2048,), 128, (3104, 1552), (264, 264), 2),
]


@pytest.mark.parametrize("shape,bn2,tiles,blocks,slices", PLANS)
def test_mlp_plan_at_every_path_shape(shape, bn2, tiles, blocks, slices):
    """[128, 128] tiles two blocks an SM (132 SMs); K-b's second product's
    tiles 256 wide, one block an SM, where that leaves two waves; K-f's
    second product takes one slice per hidden chunk (the JAX package's
    chunk: SAM one of 3072, CLIP two of 2048), K-b's one."""
    n, c, h = shape[:3]
    block_h = shape[3] if len(shape) > 3 else None
    if block_h is not None:
        assert M.q8_block_h(c, h, 2) == block_h
    assert M.mlp_plan(n, c, h, block_h) == dict(
        tiles=tiles, bn2=bn2, blocks=blocks, slices=slices)


def test_tile_walk_takes_every_tile_once():
    """More tiles than blocks (a block takes several), fewer (some blocks
    idle), and slices."""
    for rows, cols, slices, blocks, bn in ((300, 384, 1, 4, 128),
                                           (130, 256, 3, 264, 128),
                                           (1, 128, 2, 1, 128),
                                           (700, 768, 2, 5, 256)):
        walk = tile_walk(rows, cols, slices, blocks, bn)
        assert {t[0] for t in walk} == set(range(slices))


# ragged token tiles (130, 50, 1 rows), three column tiles (384), a hidden
# width that is no multiple of 128 (192: the last tile half outside), and
# enough rows (265 tiles) that the second product takes 256-wide tiles
KB_SHAPES = [(130, 256, 384), (50, 128, 256), (1, 128, 192),
             (33920, 256, 128)]


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("n,c,h", KB_SHAPES)
def test_kb_schedule_matches_plain(act, n, c, h):
    args = _inputs(n, c, h, seed=n)
    got = emulate_kb(*args, act=act)
    ok, err, rel = agreement(got, M.ln_mlp_residual_plain(*args, act=act))
    assert ok, (err, rel)


# (tokens, C, H, chunk): four chunks of 128 over a ragged token tile, one
# whole chunk, three chunks of 64 (the narrowest the kernel takes)
KF_SHAPES = [(130, 256, 512, 128), (33, 128, 256, 256), (3, 128, 192, 64)]


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("n,c,h,block_h", KF_SHAPES)
def test_kf_schedule_is_the_plain_version_exactly(act, n, c, h, block_h):
    """With the plain version's activation, the tiles, the panel maxima,
    the per-chunk scales and the chunk-order fold give its output bit for
    bit."""
    args = _inputs(n, c, h, seed=n + 1)
    got = emulate_kf(*args, act=act, block_h=block_h, act_fn=act_plain)
    want = M.ln_mlp_residual_q8_plain(*args, act=act, block_h=block_h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("n,c,h,block_h", KF_SHAPES)
def test_kf_schedule_matches_plain(act, n, c, h, block_h):
    """With the kernels' activation: chip_smoke's K-f rule."""
    args = _inputs(n, c, h, seed=n + 2)
    got = emulate_kf(*args, act=act, block_h=block_h)
    want = M.ln_mlp_residual_q8_plain(*args, act=act, block_h=block_h)
    ok, err, rel = agreement(got, want, Q8_REL_L2_TOL)
    assert ok, (err, rel)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_kf_schedule_matches_pallas(act):
    """Against _kernel_q8 in interpret mode, four 128-wide chunks over 130
    tokens, in float32 with the plain versions' activation (where the
    emulation's roundings of z and h to the input's dtype are no-ops and
    the JAX kernel takes its activation in float32 too): tests/
    test_torch_quant.py's 2e-5 relative to (1 + |reference|)."""
    args = [a.float() for a in _inputs(130, 256, 512, seed=3)]
    want = jmlp.ln_mlp_residual(*(jnp.asarray(a.numpy()) for a in args),
                                eps=1e-6, act=act, block_h=128, quant8=True,
                                interpret=True)
    got = emulate_kf(*args, act=act, block_h=128, act_fn=act_plain)
    close(got, want, 2e-5)
