"""K-k `int8_matmul_nk`'s sm_90a schedule (int8_matmul_nk.cu) on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold it to its plain version there). These tests pin its
launch plan `qmv_nk_plan` (one pass over the table at every M <= 8, one
wave of persistent blocks, every vocabulary row once) and emulate its two
forms' arithmetic step by step in plain PyTorch:

- the fma form: lane l of a row's 8 lanes owns the 16-byte pieces l,
  l + 8, ...; an fp32 fma chain in k order over its pieces, then the fold
  over lane bits 0, 1, 2 (pairs), the scale, one rounding;
- the tensor-core form: per k16 step, the 16 products of bf16 operands
  (exact in fp32) summed and added to the fp32 accumulator, the step's k
  permuted alike in A and B (lane t's bytes 4s .. 4s + 3 of its piece at
  step s), then the scale and one rounding.

Both are held to the plain version and to interpret-mode Pallas
(lvv_tpu.ops.quant.quantized_matmul_nk); a scale rolled by one row (the
trap of chip_smoke) must fail the same tolerance.

Tolerances: bf16 outputs, chip_smoke's `agreement` (4 bf16 ulps of
(|want| + rms(want)), 1/128 relative L2): the plain version rounds x @ qᵀ
to bf16 before the scale and again after, the kernel once. The tensor
cores' own summation inside a k16 step may differ from the emulation's
(exact, rounded once) by their accumulator's truncation, which is far
below one bf16 ulp of the output. fp32 outputs: 1e-5 relative to
(1 + |want|) against the plain version, and the bf16 rule against Pallas,
whose wrapper rounds an fp32 caller's output to bf16 (a trait of the
reference that the port does not copy). The plan, the index maps and the
dequantization are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import agreement
from lvv_tpu.ops import quant as jq
from lvv_tpu_torch.ops import quant as Q
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

SMS, WARPS = 132, 8
VOCAB, HIDDEN = 151940, 896


@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("n", [VOCAB, 1000, 200])
@pytest.mark.parametrize("m", range(1, 9))
def test_qmv_nk_plan_reads_the_table_once(m, n, fp32):
    """Warp gw of W takes tiles gw, gw + W, ...: every vocabulary row lies
    in exactly one warp's tile; one pass over the table takes all of x's
    rows at every M <= 8; the blocks are one wave of what an SM holds and
    no more than the tiles need."""
    plan = Q.qmv_nk_plan(m, HIDDEN, n, fp32)
    assert plan["passes"] == 1 and plan["rows"] >= m
    assert plan["mma"] == (not fp32 and m >= 2)
    tr = plan["tile_rows"]
    assert plan["tiles"] == -(-n // tr)
    warps = plan["blocks"] * WARPS
    assert plan["blocks"] <= plan["per_sm"] * SMS
    assert warps - WARPS < plan["tiles"] or plan["blocks"] == (
        plan["per_sm"] * SMS)
    cover = np.zeros(plan["tiles"] * tr, np.int32)
    for gw in range(warps):
        for tile in range(gw, plan["tiles"], warps):
            cover[tile * tr:(tile + 1) * tr] += 1
    assert (cover == 1).all()


def test_qmv_nk_plan_at_the_decode_shapes():
    """The plans the serving decode launches (bf16, batch 1 and 8) and the
    fp32 form: one wave on 132 SMs, ~3 tiles a warp in the tensor-core
    form, 12 in the fma form."""
    got = {(m, fp32): tuple(Q.qmv_nk_plan(m, HIDDEN, VOCAB, fp32)[key] for key
                            in ("mma", "rows", "tiles", "per_sm", "blocks"))
           for m in (1, 2, 8) for fp32 in (False, True)}
    assert got == {(1, False): (False, 1, 37985, 3, 396),
                   (1, True): (False, 1, 37985, 3, 396),
                   (2, False): (True, 8, 9497, 3, 396),
                   (2, True): (False, 2, 37985, 3, 396),
                   (8, False): (True, 8, 9497, 3, 396),
                   (8, True): (False, 8, 37985, 2, 264)}


def test_more_than_eight_rows_take_more_passes():
    plan = Q.qmv_nk_plan(17, HIDDEN, VOCAB)
    assert plan["rows"] == 8 and plan["passes"] == 3


def _magic(w: np.ndarray) -> np.ndarray:
    """dequant4: w ^ 0x80 under the exponent of 2^23, less 2^23 + 128."""
    u = (w.astype(np.int32) & 0xFF) ^ 0x80
    return ((np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
            - np.float32(8388736.0))


def test_dequantization_is_exact_in_fp32_and_bf16():
    """Every int8 w comes out of the byte permute exactly, and the upper
    half of that float (dequant_bf2's second permute) is w in bf16."""
    w = np.arange(-128, 128)
    f = _magic(w)
    np.testing.assert_array_equal(f, w.astype(np.float32))
    upper = (f.view(np.uint32) & 0xFFFF0000).view(np.float32)
    np.testing.assert_array_equal(upper, w.astype(np.float32))


def _fma(acc, a, b):
    """fp32 fma: the product is exact in float64, the sum rounded once."""
    return (acc.double() + a.double() * b.double()).float()


def emulate_fma(x, q, s, roll=False):
    """The fma form on x [M, K], q [N, K] int8, s [N]: lane l's chain over
    pieces l, l + 8, ... (16 k each, in k order), the 8 lanes folded in
    pairs over lane bits 0, 1, 2, then the scale; roll puts each row's
    scale on its neighbour (the trap)."""
    m, k = x.shape
    xf, qf = x.float(), torch.from_numpy(_magic(q.numpy()))
    lanes = torch.zeros(8, m, q.shape[0])
    for l in range(8):
        for piece in range(l, -(-k // 16), 8):
            for kk in range(16 * piece, min(k, 16 * piece + 16)):
                lanes[l] = _fma(lanes[l], xf[:, kk:kk + 1], qf[:, kk][None])
    while lanes.shape[0] > 1:                 # pairs (l, l ^ 1), then ^ 2, ^ 4
        lanes = lanes[0::2] + lanes[1::2]
    sc = s.roll(1) if roll else s
    return (lanes[0] * sc).to(x.dtype)


def _mma_order(k: int):
    """The tensor-core form's k order: group G of 64, step s, lane t gives
    logical positions (2t, 2t + 1, 2t + 8, 2t + 9) from physical bytes
    64G + 16t + 4s + (0, 1, 2, 3). Returns [steps][16] physical k per
    logical position of each k16 step."""
    steps = []
    for g in range(-(-k // 64)):
        for s in range(4):
            logical = [0] * 16
            for t in range(4):
                phys = [64 * g + 16 * t + 4 * s + e for e in range(4)]
                for pos, p in zip((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9),
                                  phys):
                    logical[pos] = p
            steps.append(logical)
    return steps


def test_mma_order_takes_every_k_once():
    """Across a 64-wide group's 4 steps the permuted positions cover each k
    exactly once; A and B read the same physical k at each logical one."""
    steps = _mma_order(HIDDEN)
    flat = sorted(p for st in steps for p in st)
    assert flat == list(range(HIDDEN))


def emulate_mma(x, q, s):
    """The tensor-core form on bf16 x [M <= 8, K], q [N, K] int8: per k16
    step the products (bf16 x int8, exact) summed exactly and added to the
    fp32 accumulator once; past K the operands are zeros."""
    m, k = x.shape
    xf = x.float().double()
    qf = torch.from_numpy(_magic(q.numpy())).double()
    acc = torch.zeros(m, q.shape[0])
    for logical in _mma_order(k):
        idx = torch.tensor([p for p in logical if p < k], dtype=torch.long)
        step = xf[:, idx] @ qf[:, idx].t()
        acc = (acc.double() + step).float()
    return (acc * s).to(x.dtype)


def _operands(m, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(0.02 * rng.standard_normal((n, k)).astype(
        np.float32))
    t = Q.quantize_rows_table(table)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x.to(torch.bfloat16).to(dtype), t["q"], t["s"]


def _pallas(x, q, s):
    return torch.from_numpy(np.array(jq.quantized_matmul_nk(
        jnp.asarray(x.float().numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(s.numpy()), interpret=True))).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 256, 200), (3, 128, 96),
                                   (8, 384, 100), (2, 896, 52)])
def test_fma_form_matches_plain_and_pallas(dtype, m, k, n):
    """The fma form's order against `quantized_matmul_nk_plain` and the
    Pallas kernel it replaces (interpret mode; x as bf16 values, as that
    kernel takes it)."""
    x, q, s = _operands(m, k, n, seed=m + k, dtype=dtype)
    got = emulate_fma(x, q, s)
    plain = Q.quantized_matmul_nk_plain(x, q, s)
    want = _pallas(x, q, s)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        for ref in (plain, want):
            ok, err, l2 = agreement(got, ref)
            assert ok, (err, l2)
    else:           # the Pallas wrapper rounds an fp32 caller's output to bf16
        close(got.numpy(), plain.numpy(), 1e-5)
        ok, err, l2 = agreement(got, want)
        assert ok, (err, l2)


@pytest.mark.parametrize("m,k,n", [(2, 256, 200), (5, 128, 96),
                                   (8, 896, 60), (8, 384, 33)])
def test_mma_form_matches_plain_and_pallas(m, k, n):
    """The tensor-core form's per-step sums against the plain version and
    Pallas (bf16 x only: an fp32 x takes the fma form)."""
    x, q, s = _operands(m, k, n, seed=2 * m + k, dtype=torch.bfloat16)
    got = emulate_mma(x, q, s)
    for ref in (Q.quantized_matmul_nk_plain(x, q, s), _pallas(x, q, s)):
        ok, err, l2 = agreement(got, ref)
        assert ok, (err, l2)


@pytest.mark.parametrize("form", ["fma", "mma"])
def test_trap_rolled_scale_fails_the_tolerance(form):
    """Each row's scale on its neighbour's row is another function: the
    tolerance must see it."""
    x, q, s = _operands(4, 256, 128, seed=7, dtype=torch.bfloat16)
    s = s * torch.linspace(0.5, 2.0, s.shape[0])  # rows of unequal scales
    got = emulate_fma(x, q, s) if form == "fma" else emulate_mma(x, q, s)
    assert agreement(got, Q.quantized_matmul_nk_plain(x, q, s))[0]
    ok, _, _ = agreement(got, Q.quantized_matmul_nk_plain(x, q, s.roll(1)))
    assert not ok


def test_plain_version_on_cpu_tensors():
    """On a CPU tensor the wrapper computes its plain version (no kernel)."""
    x, q, s = _operands(2, 128, 64, seed=3, dtype=torch.bfloat16)
    assert torch.equal(Q.quantized_matmul_nk(x, q, s),
                       Q.quantized_matmul_nk_plain(x, q, s))
