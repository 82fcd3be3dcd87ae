"""The int8 p@v kernels' sm_90a schedule (pv8_sm90.cuh) on the CPU.

The CUDA kernels of the three int8 launches, K-d8 (`relpos_attention(...,
pv_int8=True)`) and K-h's int8 arm in its streaming and fused forms
(`flash_attention_relpos(..., quant8=True)`), run only on the card
(tests/test_torch_gpu.py and chip_smoke.py hold them to their plain
versions there). These tests emulate the kernels' arithmetic step by step
in plain PyTorch (fp32): the tiles of 128 keys in the producer's order
(each group of `group` columns walked twice), the plan's steps of the
score product (`pv8_plan`), pass 1's row maxima, the group's scale, pass
2's logits less the running maximum (inside the bias), p = 2^logit summed
into l, p8 by the kernel's magic-number rounding, in the kernel's kv order
against v8t's permuted kv axis (`pv8_kv_perm`), the int32 group sums, and
the fold in the plain version's order of roundings. The emulations are held
to the plain versions, and at one small shape each to interpret-mode
Pallas. The plan, the tile order, the kv permutation and the rounding are
pinned.

Tolerances:
- emulation against plain version or Pallas: chip_smoke's int8 rule,
  `agreement(got, want, REL_L2_TOL, max|v| / 127)`. Both sides take q·k as
  exact bf16 products summed in fp32 in another order, and the kernel
  subtracts the running maximum inside the bias (and the plain K-h in base
  e), so a p on a rounding boundary of p8 may land one step apart: that
  moves an output by at most max|v| / 127, added to 4 bf16 ulps of
  (|want| + rms(want)) elementwise; the relative L2 stays within 1/128.
- the trap, one p scale for each whole row in place of the groups, must
  fail that rule.
- the kv permutation, the rounding, the tile order and the plan: exact.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import REL_L2_TOL, agreement, kh_whole_row_trap
from lvv_tpu_torch.ops import attention as A
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

BN = 128                  # keys a tile
NEG = -1e30
LOG2E = math.log2(math.e)


def _bf16(*shape, seed, std=1.0):
    """Seeded normal values, rounded to bf16, held in fp32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std)
    return x.to(torch.bfloat16).float()


def fills(kv_end: int, group: int):
    """The tiles in the producer's order (pv8_sm90.cuh `Pv8Fills`): for each
    group [g0, g1) its 128-key tiles from g0 rounded down, pass 0 then pass
    1 -> [(pass, g0, k0)]."""
    out = []
    for g0 in range(0, kv_end, group):
        g1 = min(g0 + group, kv_end)
        for pss in (0, 1):
            out += [(pss, g0, k0) for k0 in range(g0 // BN * BN, g1, BN)]
    return out


def p8_round(x: torch.Tensor) -> torch.Tensor:
    """p8_bits: min(x, 127) + 1.5·2^23 in fp32 (the sum's low mantissa
    bits are rint(x), ties to even), read back as a number."""
    big = torch.tensor(12582912.0)
    return (torch.clamp(x, max=127.0) + big) - big


def emulate(acc_fn, bias_fn, sl, v8t, sv, *, kv_end: int, group: int,
            step: int):
    """pv8_consume over one batch of rows: acc_fn(c0, c1) -> the q·kᵀ
    accumulators [..., Sq, c1 - c0] (fp32); bias_fn(c0, c1, m) -> the
    log2-domain bias less m [..., Sq, c1 - c0]; sl = scale·log2e (None: the
    fused form, whose q_aug carries it); v8t [..., d, s_pad] int8 in
    pv8_kv_perm's order, sv [..., d]. Returns o / l [..., Sq, d]."""
    s_tiles = -(-kv_end // BN) * BN
    if v8t.shape[-1] < s_tiles:    # TMA reads zeros past s_pad
        v8t = torch.nn.functional.pad(v8t, (0, s_tiles - v8t.shape[-1]))
    v8 = v8t.double()
    m = l = o = None
    todo = fills(kv_end, group)
    for g0 in range(0, kv_end, group):
        g1 = min(g0 + group, kv_end)
        tiles = [(p, k0) for p, gg, k0 in todo if gg == g0]
        steps = [(c0, c0 + step) for pss, k0 in tiles if pss == 0
                 for c0 in range(k0, k0 + BN, step)]

        def logits(c0, c1, mm):
            acc, bias = acc_fn(c0, c1), bias_fn(c0, c1, mm)
            lg = (acc + bias if sl is None else
                  (acc.double() * sl + bias.double()).float())   # fmaf
            cols = torch.arange(c0, c1)
            return lg.masked_fill((cols < g0) | (cols >= g1), NEG)

        zero = torch.zeros(acc_fn(0, step).shape[:-1])
        gm = torch.stack([logits(c0, c1, zero).amax(-1)
                          for c0, c1 in steps]).amax(0)
        if m is None:
            m = torch.full_like(gm, NEG)
            l = torch.zeros_like(gm)
            o = torch.zeros(*gm.shape, v8t.shape[-2])
        mn = torch.maximum(m, gm)
        alpha = torch.exp2(m - mn)
        sp = torch.clamp_min(torch.exp2(gm - mn), 1e-30)
        mul = 127.0 / sp
        m = mn
        z = torch.zeros(o.shape, dtype=torch.float64)
        ps = torch.zeros_like(l)
        for c0, c1 in steps:
            p = torch.exp2(logits(c0, c1, m))
            ps = ps + p.sum(-1)
            p8 = p8_round(p * mul[..., None])
            # the A operand's k-slot σ of each 16 carries column perm(σ);
            # v8t's kv axis lies in the same order
            perm = A.pv8_kv_perm(c1 - c0)
            z += p8[..., perm].double() @ v8[..., c0:c1].transpose(-1, -2)
        l = l * alpha + ps
        o = (o * alpha[..., None]
             + (z.float() * (sp * (1.0 / 127.0))[..., None]) * sv[..., None, :])
    return o / torch.clamp_min(l, 1e-30)[..., None]


# ------------------------------------------------------ the three forms --

def _pad_cols(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices past the table (keys past S, masked) read entry 0."""
    return torch.cat([idx, torch.zeros(n - len(idx), dtype=idx.dtype)])


def _kd8_inputs(b, gh, gw, heads, d, seed):
    s = gh * gw
    return (_bf16(b, s, 3 * heads * d, seed=seed),
            _bf16(gh, gh, d, seed=seed + 1, std=0.1),
            _bf16(gw, gw, d, seed=seed + 2, std=0.1))


def emulate_kd8(qkv, rh, rw, *, heads: int, scale: float, group: int):
    """K-d8 (relpos_pv8_sm90): tables q·Rh, q·Rw of unscaled q in fp32
    times log2e (bias_tables), scores fmaf(q·k, scale·log2e, (h - m) + w).
    Returns [B, S, C]."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    gh, gw = rh.shape[0], rw.shape[0]
    q, k, v = A._split_qkv(qkv, heads)                    # [B, H, S, d]
    qh, qw = torch.arange(s) // gw, torch.arange(s) % gw
    th = torch.einsum("bhsc,skc->bhsk", q, rh[qh]) * LOG2E   # [.., S, gh]
    tw = torch.einsum("bhsc,skc->bhsk", q, rw[qw]) * LOG2E   # [.., S, gw]
    n = -(-s // BN) * BN
    kh, kw = _pad_cols(qh, n), _pad_cols(qw, n)
    v8t, sv = A.pv8_v_operands(v, 2)
    plan = A.pv8_plan("kd8", s, d, gh, gw)
    kf = torch.nn.functional.pad(k, (0, 0, 0, n - s))
    out = emulate(lambda c0, c1: q @ kf[:, :, c0:c1].transpose(-1, -2),
                  lambda c0, c1, m: ((th[..., kh[c0:c1]] - m[..., None])
                                     + tw[..., kw[c0:c1]]),
                  scale * LOG2E, v8t, sv, kv_end=s, group=group,
                  step=plan["step"])
    return out.transpose(1, 2).reshape(b, s, heads * d)


def _kh_inputs(b, heads, gh, gw, d, seed):
    s = gh * gw
    qkv = _bf16(b, s, 3 * heads * d, seed=seed)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    return (q, k, v, _bf16(b, heads, s, gh, seed=seed + 1, std=0.5),
            _bf16(b, heads, s, gw, seed=seed + 2, std=0.5))


def emulate_kh(q, k, v, q_rh, q_rw, *, scale: float, grid_w: int,
               block_q: int = 4096, block_k: int = 1024):
    """K-h's streaming int8 arm (kh_pv8_sm90): the caller's bf16 tables
    times log2e, scores fmaf(q·k, scale·log2e, (h - m) + w) over kh_tiles'
    kv extent in groups of its tile. Returns [B, H, S, d]."""
    b, heads, s, d = q.shape
    gh = s // grid_w
    _, tile, kv_end = A.kh_tiles(s, block_q, block_k)
    n = -(-s // BN) * BN + BN
    kh = _pad_cols(torch.arange(s) // grid_w, n)
    kw = _pad_cols(torch.arange(s) % grid_w, n)
    th, tw = q_rh * LOG2E, q_rw * LOG2E
    v8t, sv = A.pv8_v_operands(v, 2)
    kf = torch.nn.functional.pad(k, (0, 0, 0, n - s))
    return emulate(lambda c0, c1: q @ kf[:, :, c0:c1].transpose(-1, -2),
                   lambda c0, c1, m: ((th[..., kh[c0:c1]] - m[..., None])
                                      + tw[..., kw[c0:c1]]),
                   scale * LOG2E, v8t, sv, kv_end=kv_end, group=tile,
                   step=A.pv8_plan("stream", s, d, gh, grid_w)["step"])


def emulate_fused(q, k, v, q_rh, q_rw, *, scale: float, grid_w: int,
                  block_k: int):
    """K-h's fused int8 arm: the operands of fused_operands (depth 128,
    log2-domain), scores q_aug·k_augᵀ + (qrw - m), groups of block_k."""
    b, heads, s, d = q.shape
    q_aug, k_aug, qrw = (t.float() for t in A.fused_operands(
        q, k, q_rh, q_rw, scale=scale, grid_w=grid_w))
    kw = torch.arange(s) % grid_w
    v8t, sv = A.pv8_v_operands(v, 2)
    return emulate(lambda c0, c1: q_aug @ k_aug[:, :, c0:c1].transpose(-1, -2),
                   lambda c0, c1, m: qrw[..., kw[c0:c1]] - m[..., None],
                   None, v8t, sv, kv_end=s, group=block_k,
                   step=A.pv8_plan("fused", s, d, s // grid_w, grid_w)["step"])


def _int8_rule(got, want, vmax):
    ok, err, rel = agreement(got, want, REL_L2_TOL, float(vmax) / 127)
    assert ok, (err, rel)


@pytest.mark.parametrize("gh,gw,d,group", [
    (32, 32, 64, 1024),        # one whole group
    (32, 32, 64, 192),         # groups an odd multiple of 64: straddled tiles
    (24, 40, 64, 1024),        # a ragged group, 40 wide ("any")
    (32, 64, 64, 512),         # 64 wide ("g64", 128-key steps)
    (16, 64, 128, 512)])       # head dim 128 (32-key steps)
def test_kd8_emulation_matches_plain(gh, gw, d, group):
    qkv, rh, rw = _kd8_inputs(1, gh, gw, 2, d, seed=gh + gw + d)
    kw = dict(heads=2, scale=d ** -0.5)
    got = emulate_kd8(qkv, rh, rw, group=group, **kw)
    want = A.relpos_attention_plain(qkv, rh, rw, pv_int8=True,
                                    pv_group=group, **kw)
    _int8_rule(got, want, qkv[..., 4 * d:].abs().max())


@pytest.mark.parametrize("b,heads,gh,gw,d", [
    (2, 2, 24, 40, 64),        # one ragged group of 960 ("any")
    (1, 2, 40, 40, 64),        # keys past 1024 dropped (kh_tiles)
    (1, 2, 16, 80, 64),        # 80 wide ("wide"), as SAM at 1280²
    (1, 1, 8, 256, 64),        # 256 wide, which only the int8 arm takes
    (1, 2, 16, 64, 128)])      # head dim 128 (global tables)
def test_kh_emulation_matches_plain(b, heads, gh, gw, d):
    ops = _kh_inputs(b, heads, gh, gw, d, seed=gh * gw + d)
    kw = dict(scale=d ** -0.5, grid_w=gw, block_q=4096, block_k=1024)
    assert A.kh_form(gh * gw, d, gw, 4096, 1024)[0] == "stream"
    got = emulate_kh(*ops, **kw)
    want = A.flash_attention_relpos_plain(*ops, quant8=True, **kw)
    _int8_rule(got, want, ops[2].abs().max())


@pytest.mark.parametrize("g,block_k", [(32, 512), (64, 1024)])
def test_fused_emulation_matches_plain(g, block_k):
    ops = _kh_inputs(1, 1, g, g, 64, seed=g + block_k)
    kw = dict(scale=0.125, grid_w=g)
    got = emulate_fused(*ops, block_k=block_k, **kw)
    want = A.flash_attention_relpos_fused_plain(
        *ops, block_q=g * g, block_k=block_k, quant8=True, **kw)
    _int8_rule(got, want, ops[2].abs().max())


def test_trap_fails_the_rule():
    """One p scale for each whole row (a group as wide as the sequence) in
    place of the 1024-column groups: the rule sees it."""
    ops = _kh_inputs(1, 2, 32, 64, 64, seed=3)
    kw = dict(scale=0.125, grid_w=64, block_q=4096, block_k=1024)
    got = emulate_kh(*ops, **kw)
    vmax = ops[2].abs().max()
    _int8_rule(got, A.flash_attention_relpos_plain(*ops, quant8=True, **kw),
               vmax)
    ok, _, rel = agreement(got, kh_whole_row_trap(*ops, quant8=True, **kw),
                           REL_L2_TOL, float(vmax) / 127)
    assert not ok, rel


# ------------------------------------------------- against the TPU kernels

def _np(x):
    return jnp.asarray(x.numpy())


def test_kd8_emulation_matches_pallas():
    qkv, rh, rw = _kd8_inputs(1, 32, 32, 2, 64, seed=11)
    want = jattn.flash_attention_relpos_hpacked(
        _np(qkv), _np(rh), _np(rw), scale=0.125, grid_w=32, heads=2,
        block_q=1024, block_k=256, quant8=True, interpret=True)
    got = emulate_kd8(qkv, rh, rw, heads=2, scale=0.125, group=256)
    _int8_rule(got, torch.from_numpy(np.array(want)),
               qkv[..., 256:].abs().max())


@pytest.mark.parametrize("fused", [False, True])
def test_kh_emulation_matches_pallas(fused):
    g, bk = (32, 512) if fused else (24, 1024)
    gw = 32 if fused else 40
    ops = _kh_inputs(1, 2, g, gw, 64, seed=12)
    kw = dict(scale=0.125, grid_w=gw, block_q=g * gw if fused else 4096,
              block_k=bk)
    want = jattn.flash_attention_relpos(*(_np(t) for t in ops), quant8=True,
                                        interpret=True, **kw)
    got = (emulate_fused(*ops, scale=0.125, grid_w=gw, block_k=bk) if fused
           else emulate_kh(*ops, **kw))
    _int8_rule(got, torch.from_numpy(np.array(want)), ops[2].abs().max())


# --------------------------------------------- the pieces, pinned exactly

def test_kv_perm_keeps_the_integer_sum():
    """p8 @ v8 over the kernel's kv order is the same integer, and
    pv8_v_operands lays quantize_v's v8 out in that order."""
    perm = A.pv8_kv_perm(64)
    assert perm[:16].tolist() == [0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13,
                                  6, 7, 14, 15]
    assert sorted(perm.tolist()) == list(range(64))
    assert torch.equal(perm[16:32] - 16, perm[:16])
    rng = np.random.default_rng(0)
    p8 = torch.from_numpy(rng.integers(0, 128, (5, 64)))
    v8 = torch.from_numpy(rng.integers(-127, 128, (64, 7)))
    assert torch.equal(p8[:, perm] @ v8[perm], p8 @ v8)
    v = _bf16(2, 3, 100, 64, seed=5)
    v8t, sv = A.pv8_v_operands(v, 2)
    q8, qs = A.quantize_v(v, 2)
    assert v8t.shape == (2, 3, 64, 128) and v8t.dtype == torch.int8
    assert torch.equal(v8t[..., A.pv8_kv_perm(128).argsort()][..., :100],
                       q8.transpose(-1, -2))
    assert not v8t[..., A.pv8_kv_perm(128).argsort()][..., 100:].any()
    assert torch.equal(sv, qs[:, :, 0])
    # the [B, S, H, d] layout of K-d8's packed v gives the same operands
    t8, ts = A.pv8_v_operands(v.transpose(1, 2), 1)
    assert torch.equal(t8, v8t) and torch.equal(ts, sv)


def test_magic_rounding_is_rint():
    """p8_bits' add of 1.5·2^23 is torch.round (ties to even), clipped at
    127, on every half step of [0, 127.5] and at random points."""
    x = torch.cat([torch.arange(0, 256) / 2.0,
                   torch.rand(10000, generator=torch.Generator().manual_seed(
                       0)) * 127.4])
    assert torch.equal(p8_round(x), torch.clamp(torch.round(x), max=127))


def test_fill_order_with_groups_off_the_tiles():
    """Groups of 192 columns (not a multiple of the 128-key tile): a tile
    that straddles a group edge is streamed for each group it touches."""
    assert fills(512, 192) == [
        (0, 0, 0), (0, 0, 128), (1, 0, 0), (1, 0, 128),
        (0, 192, 128), (0, 192, 256), (1, 192, 128), (1, 192, 256),
        (0, 384, 384), (1, 384, 384)]
    assert fills(6400, 1024)[-4:] == [(0, 6144, 6144), (0, 6144, 6272),
                                      (1, 6144, 6144), (1, 6144, 6272)]


@pytest.mark.parametrize("args,rule,step,rows,ldw,stages", [
    (("kd8", 4096, 64, 64, 64), "g64", 128, 128, 72, 4),    # SAM 1024²
    (("kd8", 960, 64, 24, 40), "any", 64, 128, 42, 4),
    (("kd8", 4096, 64, 32, 128), "any", 64, 128, 130, 4),
    (("kd8", 8192, 128, 64, 128), "any", 32, 64, 130, 3),
    (("stream", 6400, 64, 80, 80), "wide", 64, 128, 152, 3),  # SAM 1280²
    (("stream", 960, 64, 24, 40), "any", 64, 128, 40, 4),
    (("stream", 2048, 64, 8, 256), "any", 64, 128, 264, 3),
    (("stream", 1800, 64, 3, 600), "global", 32, 64, 0, 4),
    (("stream", 2048, 128, 32, 64), "global", 32, 64, 0, 4),
    (("fused", 4096, 64, 64, 64), "g64", 128, 128, 72, 3),
    (("fused", 1024, 64, 32, 32), "global", 32, 64, 0, 4)])
def test_plan(args, rule, step, rows, ldw, stages):
    plan = A.pv8_plan(*args)
    assert (plan["rule"], plan["step"], plan["rows"], plan["ldw"],
            plan["stages"]) == (rule, step, rows, ldw, stages)
    assert plan["smem"] <= 232448


def test_plan_fits_every_grid_the_wrappers_take():
    """Every plan leaves two stages or more in 227 KB: K-d8 on grids up to
    64 x 128 at head dim 64 and 128, K-h's int8 arm on every grid
    `_kh_tables_fit` admits (sampled), the fused form likewise."""
    for d in (64, 128):
        for gh, gw in ((64, 128), (64, 64), (7, 128), (64, 9)):
            assert A.pv8_plan("kd8", gh * gw, d, gh, gw)["stages"] >= 2
    for gh, gw in ((80, 80), (3, 600), (600, 3), (300, 300), (1, 630),
                   (255, 255), (8, 256), (100, 500)):
        if not A._kh_tables_fit(gh * gw, gh, gw):
            continue
        for d in (64, 128):
            assert A.pv8_plan("stream", gh * gw, d, gh, gw)["stages"] >= 2
        assert A.pv8_plan("fused", gh * gw, 64, gh, gw)["stages"] >= 2
