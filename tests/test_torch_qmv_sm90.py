"""K-j `int8_matmul`'s sm_90a schedule (int8_matmul.cu) on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold it to its plain version there). These tests pin its
launch plan `qmv_plan` at the decode's shapes and emulate its arithmetic
step by step in plain PyTorch: each k-lane's fp32 fma chain over the rows
ka + kl, ka + kl + KL, ... of its K split, the fold of the lanes of a warp
that share columns (pairs over lane-row bit 0, then bit 1, ...), the 8
warps added in order, the cluster's ranks added in rank order, then the
scale and one rounding to x's dtype. The emulation is held to the plain
version and to interpret-mode Pallas (lvv_tpu.ops.quant.quantized_matmul);
a wrong fold (one rank's partial left out) must fail the same tolerance.

Tolerances: bf16 outputs, chip_smoke's `agreement` (4 bf16 ulps of
(|want| + rms(want)), 1/128 relative L2): the plain version rounds x @ q to
bf16 before the scale and again after, the kernel once. fp32 outputs: 1e-5
relative to (1 + |want|), fp32 sums in another order. The plan, the
dequantization's magic number and the fold's index map are exact.
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

THREADS, WARPS = 256, 8
# the decode's products (qkv, o, gate|up, down) and the tied unembed's shape
DECODE = [(896, 1152), (896, 896), (896, 9728), (4864, 896), (896, 151940)]


def _ranges(plan, k):
    return [(r * plan["k_split"], min(k, (r + 1) * plan["k_split"]))
            for r in range(plan["splits"])]


@pytest.mark.parametrize("k,n", DECODE)
@pytest.mark.parametrize("m", range(1, 9))
def test_qmv_plan_splits_k_once_and_fills_the_card(m, k, n):
    """Every K range is covered once and contiguously, none is empty; the
    cluster (<= 8 blocks) is the tile's splits; one row group takes all of
    x's rows; the grid reaches 128 blocks where N <= 1152; a thread's
    sums set its loads ahead."""
    plan = Q.qmv_plan(m, k, n)
    ranges = _ranges(plan, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert 1 <= plan["cluster"] <= 8 and plan["splits"] % plan["cluster"] == 0
    assert plan["cluster"] == plan["splits"]
    assert plan["rows"] >= m and plan["rows"] in (1, 2, 4, 8)
    assert n % plan["vec"] == 0 and plan["n_tile"] % plan["vec"] == 0
    assert plan["stages"] == (8 if plan["rows"] * plan["vec"] <= 16 else 4)
    blocks = -(-n // plan["n_tile"]) * plan["splits"]
    if n <= 1152:
        assert blocks >= 128


def test_qmv_plan_at_the_decode_shapes():
    """The plans the serving decode launches (batch 1 and 8)."""
    got = {(m, k, n): tuple(Q.qmv_plan(m, k, n)[key] for key in (
        "rows", "vec", "n_tile", "splits", "k_split", "stages"))
        for m in (1, 8) for k, n in DECODE[:4]}
    assert got == {
        (1, 896, 1152): (1, 16, 32, 8, 112, 8),
        (1, 896, 896): (1, 16, 32, 8, 112, 8),
        (1, 896, 9728): (1, 16, 128, 4, 224, 8),
        (1, 4864, 896): (1, 16, 32, 8, 608, 8),
        (8, 896, 1152): (8, 8, 32, 6, 150, 4),
        (8, 896, 896): (8, 8, 32, 8, 112, 4),
        (8, 896, 9728): (8, 8, 128, 3, 299, 4),
        (8, 4864, 896): (8, 8, 32, 8, 608, 4)}


def test_dequantization_magic_number_is_exact():
    """Each int8 byte w: w ^ 0x80 put under the exponent of 2^23 (one byte
    permute, 0x4B0000xx) less 2^23 + 128 is w exactly, for all 256."""
    w = np.arange(-128, 128, dtype=np.int32)
    u = (w & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388736.0),
                                  w.astype(np.float32))


def _fold_base(lrow: int, v: int, sh: int) -> int:
    """int8_matmul.cu's fold: the first of the v / sh sums a lane holds."""
    base, step, half = 0, 0, v // 2
    while (1 << step) < sh:
        base += half if (lrow >> step) & 1 else 0
        step, half = step + 1, half // 2
    return base


@pytest.mark.parametrize("rows,vec,n_tile", [
    (1, 16, 32), (1, 16, 128), (2, 16, 32), (4, 16, 128), (8, 8, 32),
    (8, 8, 128), (1, 4, 32), (1, 4, 128), (8, 4, 32)])
def test_fold_leaves_each_sum_with_one_lane(rows, vec, n_tile):
    """After the recursive halving the lanes on one column group hold every
    one of their rows·vec sums once."""
    sh, v = 32 // (n_tile // vec), rows * vec
    held = sorted(i for lrow in range(sh)
                  for i in range(_fold_base(lrow, v, sh),
                                 _fold_base(lrow, v, sh) + v // sh))
    assert held == list(range(v))


def _fma(acc, a, b):
    """fp32 fma: the product is exact in float64, the sum rounded once."""
    return (acc.double() + a.double() * b.double()).float()


def emulate(x, q, s, drop_rank=False):
    """K-j on x [M, K], q [K, N] int8, s [N], in the kernel's order of fp32
    operations (the plan of `qmv_plan`); drop_rank leaves the cluster's last
    rank out (a trap)."""
    m, k = x.shape
    n = q.shape[1]
    plan = Q.qmv_plan(m, k, n)
    ct = plan["n_tile"] // plan["vec"]
    lanes, sh = THREADS // ct, 32 // ct
    xf, qf = x.float(), q.float()
    total = None
    for r, (ka, kb) in enumerate(_ranges(plan, k)):
        part = torch.zeros(lanes, m, n)
        for r0 in range(ka, kb, lanes):       # row r0 + kl of lane kl
            idx = torch.arange(r0, min(r0 + lanes, kb))
            part[:len(idx)] = _fma(part[:len(idx)], xf[:, idx].t()[:, :, None],
                                   qf[idx][:, None, :])
        fold = part.reshape(WARPS, sh, m, n)  # lane row = kl % sh
        while fold.shape[1] > 1:              # pairs over bit 0, then 1, ...
            fold = fold.reshape(WARPS, -1, 2, m, n)
            fold = fold[:, :, 0] + fold[:, :, 1]
        blk = fold[0, 0]
        for w in range(1, WARPS):
            blk = blk + fold[w, 0]
        if drop_rank and r == plan["splits"] - 1:
            continue
        total = blk if total is None else total + blk
    return (total * s).to(x.dtype)


def _operands(m, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    q, s = Q.quantize_weight(w * k ** -0.5)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x.to(torch.bfloat16).to(dtype), q, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (3, 300, 200), (8, 200, 96),
                                   (2, 1100, 64)])
def test_emulation_matches_plain_and_pallas(dtype, m, k, n):
    """The emulated split-K order against `quantized_matmul_plain` and the
    Pallas kernel it replaces (interpret mode; x as bf16, as that kernel
    takes it: x here holds bf16 values)."""
    x, q, s = _operands(m, k, n, seed=m + k, dtype=dtype)
    got = emulate(x, q, s)
    plain = Q.quantized_matmul_plain(x, q, s)
    want = torch.from_numpy(np.array(jq.quantized_matmul(
        jnp.asarray(x.float().numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(s.numpy()), interpret=True))).to(dtype)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        for ref in (plain, want):
            ok, err, l2 = agreement(got, ref)
            assert ok, (err, l2)
    else:
        close(got.numpy(), plain.numpy(), 1e-5)
        close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("m,k,n", [(1, 896, 256), (8, 300, 200)])
def test_trap_one_rank_left_out_fails_the_tolerance(m, k, n):
    """A fold that drops the cluster's last rank (a K range) is another
    function: the tolerance must see it."""
    x, q, s = _operands(m, k, n, seed=7, dtype=torch.bfloat16)
    assert Q.qmv_plan(m, k, n)["splits"] > 1
    ok, _, _ = agreement(emulate(x, q, s, drop_rank=True),
                         Q.quantized_matmul_plain(x, q, s))
    assert not ok


def test_plain_version_on_cpu_tensors():
    """On a CPU tensor the wrapper computes its plain version (no kernel)."""
    x, q, s = _operands(2, 128, 64, seed=3, dtype=torch.bfloat16)
    assert torch.equal(Q.quantized_matmul(x, q, s),
                       Q.quantized_matmul_plain(x, q, s))
