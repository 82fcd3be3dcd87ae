"""K-i `w8a8_matmul`'s sm_90a schedule (w8a8_matmul.cu) on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold it to its plain version there). These tests pin its
launch plan `w8a8_plan` at SAM's projection shapes and emulate its
arithmetic step by step in plain PyTorch: the weight prep's scale (max ·
fl(1/127), a multiply, as PyTorch computes `quantize_weight` on the card)
and its true division, the row pass's scale (a true division) and its
quantization, the exact integer product, and the epilogue's unfused fp32
order ((float(z) · sx) · sw) + b rounded once. The emulation is held to the
plain version (`int8_dot`) and to interpret-mode Pallas
(lvv_tpu.ops.quant.w8a8_matmul); a per-tensor scale of x (chip_smoke's
trap) must fail the same tolerance. The epilogue's quad transpose, which
gives each lane 16 contiguous bytes to store, is emulated lane by lane.

Tolerance: chip_smoke's `agreement` with Q8_REL_L2_TOL (4 bf16 ulps of
(|want| + rms(want)) elementwise, 1/512 relative L2): the kernel divides
where PyTorch multiplies by the reciprocal, so a scale may sit one ulp
apart and move a value on a rounding boundary one int8 step. The plan, the
index maps and the epilogue on the same int8 operands are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Q8_REL_L2_TOL, agreement
from lvv_tpu.ops import quant as jq
from lvv_tpu_torch.ops import quant as Q
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

SMS = 132
# SAM's projections under the "dense" scope: (rows, K, N) at 1024², 1280²
SAM = [(29400, 768, 2304), (29400, 768, 768), (24576, 768, 2304),
       (24576, 768, 768), (42336, 768, 2304), (42336, 768, 768),
       (38400, 768, 2304), (38400, 768, 768)]
RAGGED = [(m, k, n) for m in (5, 77, 130) for k, n in ((768, 2304),
                                                       (768, 768))]


@pytest.mark.parametrize("m,k,n", SAM + RAGGED + [(300, 384, 384)])
def test_w8a8_plan_covers_the_output_once(m, k, n):
    """The persistent blocks walk the (row tile, column tile) grid, column
    tiles fastest (gemm_sm90.cuh): every element of [M, N] lies in exactly
    one tile that one block computes, the last row tile ragged where 128
    does not divide M; at most one wave of blocks, two an SM."""
    plan = Q.w8a8_plan(m, k, n)
    bn, (tm, tn) = plan["bn"], plan["tiles"]
    assert bn == 128 and tn * bn == n
    assert (tm - 1) * 128 < m <= tm * 128
    assert plan["blocks"] == min(tm * tn, 2 * SMS)
    cover = np.zeros((tm * 128, n), np.int32)
    for b in range(plan["blocks"]):
        for tile in range(b, tm * tn, plan["blocks"]):
            r0, c0 = tile // tn * 128, tile % tn * bn
            cover[r0:r0 + 128, c0:c0 + bn] += 1
    assert (cover == 1).all()


def test_w8a8_plan_at_sams_shapes():
    """The plans SAM's 1024² projections launch."""
    got = {s: tuple(Q.w8a8_plan(*s)[key] for key in ("tiles", "blocks"))
           for s in SAM[:4]}
    assert got == {(29400, 768, 2304): ((230, 18), 264),
                   (29400, 768, 768): ((230, 6), 264),
                   (24576, 768, 2304): ((192, 18), 264),
                   (24576, 768, 768): ((192, 6), 264)}


_RECIP127 = np.float32(1.0) / np.float32(127.0)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    """round half to even, clipped to +-127 (the kernels' quant())"""
    return torch.clamp(torch.round(v), -127, 127)


def weight_prep(w: torch.Tensor):
    """mlp_wmax / mlp_wquant: sw = max(max|column| · fl(1/127), 1e-8) in
    fp32, wq = round(w / sw) by a true division -> (wt [N, K] int8, sw)."""
    wf = w.float()
    sw = torch.clamp_min(wf.abs().amax(0) * torch.tensor(_RECIP127), 1e-8)
    return _round_clip(wf / sw).to(torch.int8).t().contiguous(), sw


def row_pass(x: torch.Tensor):
    """w8a8_rows: sx = max(max|row| / 127, 1e-8) by a true division,
    x8 = round(x / sx) -> (x8 [M, K] int8, sx [M])."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(1) / torch.tensor(np.float32(127.0)),
                         1e-8)
    return _round_clip(xf / sx[:, None]).to(torch.int8), sx


def int32_product(x8: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x8 [M, K] @ wt [N, K]ᵀ summed exactly (int64 holds every int32)."""
    return torch.from_numpy(x8.numpy().astype(np.int64)
                            @ wt.numpy().astype(np.int64).T)


def epilogue(z, sx, sw, bias, dtype):
    """EpiW8A8: ((float(z) · sx) · sw) + b in fp32, each op rounded, then
    one rounding to the output type (no bias: no add)."""
    y = (z.float() * sx[:, None]) * sw[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(dtype)


def emulate(x, w, bias=None, per_tensor_x=False):
    """K-i on x [M, K], w [K, N] in the kernel's order; per_tensor_x: one
    scale for all of x (the trap)."""
    wt, sw = weight_prep(w)
    if per_tensor_x:
        sx = torch.clamp_min(x.float().abs().max() / 127.0, 1e-8)
        x8 = _round_clip(x.float() / sx).to(torch.int8)
        sx = sx.expand(x.shape[0])
    else:
        x8, sx = row_pass(x)
    return epilogue(int32_product(x8, wt), sx, sw, bias, x.dtype)


def _operands(m, k, n, seed, dtype, wdtype=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    x = x.to(torch.bfloat16).to(dtype)          # bf16 values, as Pallas
    return x, (w * k ** -0.5).to(wdtype or dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(5, 128, 256), (77, 256, 128),
                                   (130, 384, 256)])
def test_emulation_matches_plain_and_pallas(dtype, m, k, n):
    """The emulated order against `int8_dot` and the Pallas kernel it
    replaces (interpret mode)."""
    x, w, b = _operands(m, k, n, seed=m + k, dtype=dtype)
    got = emulate(x, w, b)
    plain = Q.int8_dot(x, w, b)
    want = torch.from_numpy(np.array(jq.w8a8_matmul(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(w.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(b.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        interpret=True)).astype(np.float32)).to(dtype)
    assert got.dtype == dtype
    for ref in (plain, want):
        ok, err, l2 = agreement(got, ref, Q8_REL_L2_TOL)
        assert ok, (err, l2)


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
def test_weight_prep_is_quantize_weight_up_to_the_scales_rounding(wdtype):
    """The prep's scale is max · fl(1/127); `quantize_weight` divides by 127
    on the CPU. They agree within an ulp, and a quantized weight moves by at
    most one step where they differ; with the scale of the multiply, the
    quantization is `quantize_weight`'s true division exactly. A zero
    column takes the 1e-8 floor."""
    _, w, _ = _operands(3, 256, 384, seed=11, dtype=torch.float32,
                        wdtype=wdtype)
    w[:, 5] = 0
    wt, sw = weight_prep(w)
    q0, s0 = Q.quantize_weight(w)
    assert sw[5] == np.float32(1e-8)
    assert torch.allclose(sw, s0, rtol=2 ** -23, atol=0)
    assert (wt.t().int() - q0.int()).abs().max() <= 1
    same = torch.clamp(torch.round(w.float() / sw[None, :]), -127, 127)
    assert torch.equal(wt.t(), same.to(torch.int8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epilogue_is_int8_dots_order(dtype):
    """On int8_dot's own int8 operands and scales, the epilogue's unfused
    order reproduces int8_dot bit for bit: the rescale is the plain
    version's, and the exact int32 sum is its float64 sum."""
    x, w, b = _operands(33, 256, 128, seed=5, dtype=dtype)
    x8, sx = Q.quantize_rows(x)
    wq, sw = Q.quantize_weight(w)
    got = epilogue(int32_product(x8, wq.t().contiguous()), sx[:, 0], sw, b,
                   dtype)
    assert torch.equal(got, Q.int8_dot(x, w, b))
    got = epilogue(int32_product(x8, wq.t().contiguous()), sx[:, 0], sw,
                   None, dtype)
    assert torch.equal(got, Q.int8_dot(x, w))


@pytest.mark.parametrize("m,k,n", [(130, 256, 256), (64, 768, 384)])
def test_trap_per_tensor_x_scale_fails_the_tolerance(m, k, n):
    """One scale for all of x in place of one a row is another function:
    the tolerance must see it (rows of unequal ranges, as SAM's tokens)."""
    x, w, b = _operands(m, k, n, seed=9, dtype=torch.bfloat16)
    x = (x.float() * torch.linspace(0.05, 4.0, m)[:, None]).to(x.dtype)
    ok, _, _ = agreement(emulate(x, w, b, per_tensor_x=True),
                         Q.int8_dot(x, w, b), Q8_REL_L2_TOL)
    assert not ok
    assert agreement(emulate(x, w, b), Q.int8_dot(x, w, b), Q8_REL_L2_TOL)[0]


def _quad_transpose(words):
    """quad_transpose on the 4 lanes of a quad: words[t][i] is lane t's
    word of n8 tile i. xor_perm by t, shfl.xor by i, xor_perm by t."""
    perm = [[w[t ^ i] for i in range(4)] for t, w in enumerate(words)]
    shuf = [[perm[t ^ i][i] for i in range(4)] for t in range(4)]
    return [[shuf[t][t ^ s] for s in range(4)] for t in range(4)]


def test_quad_transpose_gives_each_lane_one_tiles_columns():
    """After the exchange lane t holds the words of n8 tile t from lanes
    0, 1, 2, 3 in order: columns 8t .. 8t + 7 of the 32, in column order,
    which it stores as 16 contiguous bytes (bf16; fp32 exchanges the low
    and high words alike and stores 32)."""
    # lane t's word of tile i covers columns 8i + 2t, 8i + 2t + 1
    words = [[(8 * i + 2 * t, 8 * i + 2 * t + 1) for i in range(4)]
             for t in range(4)]
    got = _quad_transpose(words)
    for t in range(4):
        cols = [c for pair in got[t] for c in pair]
        assert cols == list(range(8 * t, 8 * t + 8))


def test_plain_version_on_cpu_tensors():
    """On a CPU tensor the wrapper computes its plain version (no kernel),
    bias or none."""
    x, w, b = _operands(9, 128, 256, seed=3, dtype=torch.bfloat16)
    assert torch.equal(Q.w8a8_matmul(x, w, b), Q.int8_dot(x, w, b))
    assert torch.equal(Q.w8a8_matmul(x, w), Q.int8_dot(x, w))
