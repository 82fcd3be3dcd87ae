"""K-g `relpos_attention_qk8`'s sm_90a schedule and its prep
(relpos_attention_qk8.cu) on the CPU, and the grids K-h's float forms take.

The CUDA kernels run only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold them to the plain versions there; the prep's k8 / sk
bit-equal to `qk8_operands` there). These tests emulate the attention
kernel's arithmetic step by step in plain PyTorch (fp32) on the plain
operands: 128-key tiles in order; exact int32 scores; the rescale in the
kernel's order of roundings, (z·sq)·sk + qrw; the qrw column of each
accumulator lane, fixed at compile time where 128 % gw == 0 and gw >= 8
((8j mod gw) + 2t + e for block j, quad lane t, element e), else stepped by
8 keys a block; keys past S masked; the base-2 online softmax with p
rounded to bf16 against the running maximum. The emulation is held to the
plain version and, at 8x64 and 32x32, to interpret-mode Pallas; traps
(qrw one column off, sk left out) must fail the same tolerance. The prep's
order of roundings is pinned against `qk8_operands` on the CPU.

Tolerances. Emulation against the plain version (bf16, as the kernel
runs): chip_smoke's `agreement` (4 bf16 ulps of (|want| + rms(want)),
1/128 relative L2): the scores are the same exact integers scaled in the
same order; p is rounded to bf16 against another maximum (the plain
version's whole row, normalised first; the kernel's running maximum over
128-key tiles), one bf16 ulp of p each. Against Pallas, on fp32 inputs as
tests/test_torch_sam_q8.py runs it (every rounding "to qkv's dtype" then
rounds to fp32): its ATTN_TOL, 1e-3 relative to (1 + |want|), fp32
round-off of the online softmax over other tiles. Column rules, the
prep's roundings and the table rule: exact.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import agreement
from lvv_tpu_torch.ops import attention as A
from torch_parity_util import close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

BN = 128                  # keys a tile
NEG = -1e30
LOG2E = math.log2(math.e)
ATTN_TOL = 1e-3


def _qkv_tables(b, gh, gw, heads, seed, std=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, gh * gw, 3 * heads * 64)) * std
    rh = 0.1 * rng.standard_normal((gh, gh, 64))
    rw = 0.1 * rng.standard_normal((gw, gw, 64))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype)
            for a in (qkv, rh, rw)]


def lane_columns(k0: int, gw: int) -> torch.Tensor:
    """The qrw column (kv mod gw) of the 128 accumulator columns of the tile
    at k0, as qk8_sm90 finds them: column 8j + 2t + e of block j, quad lane
    t, element e."""
    cols = torch.empty(BN, dtype=torch.long)
    for t in range(4):
        if 128 % gw == 0 and gw >= 8:          # compile-time offsets
            for j in range(BN // 8):
                for e in range(2):
                    cols[8 * j + 2 * t + e] = (8 * j) % gw + 2 * t + e
        else:                                  # stepped by 8 keys a block
            kwa, r8 = (k0 + 2 * t) % gw, 8 % gw
            for j in range(BN // 8):
                cols[8 * j + 2 * t] = kwa
                cols[8 * j + 2 * t + 1] = 0 if kwa + 1 == gw else kwa + 1
                kwa += r8
                if kwa >= gw:
                    kwa -= gw
    return cols


@pytest.mark.parametrize("gw", [1, 3, 7, 8, 16, 20, 32, 40, 64, 96, 100, 128])
def test_lane_columns_are_kv_mod_gw(gw):
    """Both column rules give kv mod gw for every key of every tile."""
    for k0 in range(0, 4 * BN, BN):
        assert torch.equal(lane_columns(k0, gw),
                           (k0 + torch.arange(BN)) % gw)


def emulate(qkv, rel_h, rel_w, *, heads, scale, trap=None):
    """K-g's tiles on the operands of `qk8_operands`, p rounded to qkv's
    dtype (bf16 in the kernel); trap "qrw_shift" reads qrw one column off,
    "no_sk" leaves sk out."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    gw = rel_w.shape[0]
    q8, k8, sq, sk, qrw = A.qk8_operands(qkv, rel_h, rel_w, heads=heads,
                                         scale=scale)
    if trap == "no_sk":
        sk = torch.ones_like(sk)
    out = torch.empty(b, s, c, dtype=qkv.dtype)
    for i in range(b):
        for h in range(heads):
            z = torch.matmul(q8[i, :, h].double(),
                             k8[i, :, h].double().t()).float()   # exact
            v = qkv[i, :, 2 * c + 64 * h:2 * c + 64 * (h + 1)].float()
            m = torch.full((s,), NEG)
            l = torch.zeros(s)
            o = torch.zeros(s, 64)
            for k0 in range(0, s, BN):
                cols = k0 + torch.arange(BN)
                kw = lane_columns(k0, gw)
                if trap == "qrw_shift":
                    kw = (kw + 1) % gw
                zc = z[:, cols.clamp(max=s - 1)]
                skc = sk[i, cols.clamp(max=s - 1), h]
                sc = (zc * sq[i, :, h, None]) * skc[None, :]
                sc = sc + qrw[i, :, h][:, kw]
                sc[:, cols >= s] = NEG
                m_new = torch.maximum(m, sc.amax(1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new[:, None])
                l = l * alpha + p.sum(1)
                vc = torch.zeros(BN, 64)
                vc[:min(BN, s - k0)] = v[k0:k0 + BN]
                o = o * alpha[:, None] + torch.matmul(
                    p.to(qkv.dtype).float(), vc)
                m = m_new
            out[i, :, 64 * h:64 * (h + 1)] = (
                o / torch.clamp_min(l, 1e-30)[:, None]).to(qkv.dtype)
    return out


@pytest.mark.parametrize("b,gh,gw,heads", [(1, 8, 64, 2), (1, 32, 32, 2),
                                           (2, 12, 20, 2), (1, 40, 96, 1),
                                           (1, 8, 16, 2)])
def test_emulation_matches_plain(b, gh, gw, heads):
    """The emulated tiles against `relpos_attention_qk8_plain` (every
    column rule: 64, 32 and 16 at compile time, 20 and 96 stepped, ragged
    last tiles)."""
    qkv, rh, rw = _qkv_tables(b, gh, gw, heads, seed=gh + gw)
    kw = dict(heads=heads, scale=0.125)
    ok, err, l2 = agreement(emulate(qkv, rh, rw, **kw),
                            A.relpos_attention_qk8_plain(qkv, rh, rw, **kw))
    assert ok, (err, l2)


@pytest.mark.parametrize("gh,gw", [(8, 64), (32, 32)])
def test_emulation_matches_pallas(gh, gw):
    """The emulated tiles against the head-packed Pallas kernel with qk8
    (interpret mode, kv tiles of min(S, 1024)), on the fp32 inputs of
    tests/test_torch_sam_q8.py::test_qk8_matches_pallas."""
    qkv, rh, rw = _qkv_tables(2, gh, gw, 2, seed=2, dtype=torch.float32)
    s = gh * gw
    want = jattn.flash_attention_relpos_hpacked(
        jnp.asarray(qkv.numpy()), jnp.asarray(rh.numpy()),
        jnp.asarray(rw.numpy()), scale=0.125, grid_w=gw, heads=2,
        block_q=min(s, 4096), block_k=min(s, 1024), qk8=True, interpret=True)
    got = emulate(qkv, rh, rw, heads=2, scale=0.125)
    close(got.numpy(), np.asarray(want), ATTN_TOL)


@pytest.mark.parametrize("trap", ["qrw_shift", "no_sk"])
@pytest.mark.parametrize("gh,gw", [(8, 64), (12, 20)])
def test_traps_fail_the_tolerance(trap, gh, gw):
    """qrw read one column off, or sk left out, is another function."""
    qkv, rh, rw = _qkv_tables(1, gh, gw, 2, seed=5)
    kw = dict(heads=2, scale=0.125)
    ok, _, _ = agreement(emulate(qkv, rh, rw, trap=trap, **kw),
                         A.relpos_attention_qk8_plain(qkv, rh, rw, **kw))
    assert not ok


def prep_rules(qkv, rel_h, rel_w, *, heads, scale, recip):
    """qk8_prep's order of roundings on the CPU: q_aug = [bf16(q·c1) |
    bf16(q·Rh·log2e) | 0] (c1 = fl(scale·log2e)), k_aug = [k | onehot | 0],
    scale = max(amax ÷ 127, 1e-8) in fp32 — as a multiply by fl(1/127)
    (recip, PyTorch on the card) or a true division (PyTorch on the CPU) —,
    x8 = clamp(rint(x / scale), ±127) by a true division, the scales and
    qrw = bf16(q·Rw·log2e) rounded to bf16. The q·R sums are the plain
    version's (the card's differ in order)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    gh, gw = rel_h.shape[0], rel_w.shape[0]
    q = qkv[..., :c].float().reshape(b, s, heads, 64)
    k = qkv[..., c:2 * c].float().reshape(b, s, heads, 64)
    q5 = q.reshape(b, gh, gw, heads, 64)
    q_rh = torch.einsum("bGwnc,Gkc->bGwnk", q5, rel_h.float()).reshape(
        b, s, heads, gh)
    q_rw = torch.einsum("bGwnc,wkc->bGwnk", q5, rel_w.float()).reshape(
        b, s, heads, gw)
    bf = torch.bfloat16
    c1 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    pad = torch.zeros(b, s, heads, 128 - 64 - gh)
    q_aug = torch.cat([(q * c1).to(bf).float(), (q_rh * log2e).to(bf).float(),
                       pad], -1)
    onehot = (torch.arange(gh)[None, :] == (torch.arange(s) // gw)[:, None])
    k_aug = torch.cat([k, onehot.float()[None, :, None, :].expand(
        b, s, heads, gh), pad], -1)

    def quant(x):
        amax = x.abs().amax(-1, keepdim=True)
        sc = (amax * torch.tensor(1 / 127, dtype=torch.float32) if recip
              else amax / torch.tensor(127.0))
        sc = torch.clamp_min(sc, 1e-8)
        return (torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8),
                sc[..., 0].to(bf).float())
    q8, sq = quant(q_aug)
    k8, sk = quant(k_aug)
    return q8, k8, sq, sk, (q_rw * log2e).to(bf).float()


def test_prep_rules_match_qk8_operands_on_cpu():
    """With the CPU's division for the scale, the prep's roundings give
    `qk8_operands`' operands bit for bit; with the card's multiply by
    fl(1/127) (which the prep uses and which PyTorch uses on the card) a
    scale moves by at most one bf16 ulp and a byte by at most one step."""
    qkv, rh, rw = _qkv_tables(1, 8, 16, 3, seed=11)
    kw = dict(heads=3, scale=0.125)
    ref = A.qk8_operands(qkv, rh, rw, **kw)
    for got, want in zip(prep_rules(qkv, rh, rw, recip=False, **kw), ref):
        assert torch.equal(got, want)
    card = prep_rules(qkv, rh, rw, recip=True, **kw)
    for i in (0, 1):
        assert int((card[i].int() - ref[i].int()).abs().max()) <= 1
    for i in (2, 3):
        ulp = 2.0 ** (torch.floor(torch.log2(ref[i])) - 7)
        assert bool(((card[i] - ref[i]).abs() <= ulp).all())
    assert torch.equal(card[4], ref[4])


def test_prep_k_scale_floor_and_onehot():
    """k's row scale is max(max|k|, 1) / 127 (the one-hot 1.0 sits in the
    row), and its one-hot byte is rint(1 / scale)."""
    qkv, rh, rw = _qkv_tables(1, 8, 16, 1, seed=12, std=0.01)
    _, k8, _, sk, _ = prep_rules(qkv, rh, rw, heads=1, scale=0.125,
                                 recip=True)
    kh = torch.arange(128) // 16
    assert bool((k8[0, torch.arange(128), 0, 64 + kh] == 127).all())
    assert torch.equal(sk, torch.full_like(sk, 1.0 / 127).to(
        torch.bfloat16).float())


@pytest.mark.parametrize("g", range(64, 129))
def test_kh_float_forms_take_every_grid_the_int8_arm_takes(g):
    """K-h's float forms take every square grid from 64 to 128, as the
    int8 arm does (one rule), on a plan whose shared memory fits:
    the tables in shared memory where they fit beside the tiles, else read
    where they lie."""
    s = g * g
    assert A._kh_tables_fit(s, g, g)
    for d in (64, 128):
        form, kv_end, _ = A.kh_form(s, d, g, 1024, 1024)
        plan = A.kh_float_plan(form, s, d, g, g, kv_end)
        assert plan["smem"] <= A._SMEM_MAX
        assert plan["tables"] in ("smem", "global")


def test_kh_float_plan_reads_large_tables_globally():
    """SAM 1792² (112x112) keeps its tables in shared memory at head dim
    64; 2048² (128x128) and a side past the column table's 8 bits read
    them where they lie, on 64-key tiles."""
    assert A.kh_float_plan("stream", 12544, 64, 112, 112, 12544)[
        "tables"] == "smem"
    for args in (("stream", 16384, 64, 128, 128, 16384),
                 ("stream", 12544, 128, 112, 112, 12544),
                 ("stream", 300, 64, 1, 300, 300)):
        plan = A.kh_float_plan(*args)
        assert plan["tables"] == "global" and plan["tile"] == 64
    assert A.kh_float_plan("stream", 6400, 64, 80, 80, 6400) == dict(
        tables="smem", tile=160, smem=A.kh_float_plan(
            "stream", 6400, 64, 80, 80, 6400)["smem"])
