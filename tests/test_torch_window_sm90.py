"""The sm_90a schedules of the window kernel and of K-h's float forms, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py holds them
to their plain versions there). These tests emulate each kernel's
arithmetic step by step in plain PyTorch and hold it against the plain
versions, which tests/test_torch_winattn.py, test_torch_bisect.py and
test_torch_relpos_kh.py hold against interpret-mode Pallas; the two-pass
small form is also held to interpret-mode Pallas directly. They pin the
routing function the K-h wrapper takes its form from, and the layout of
the one-hot expander through which the window kernel adds its bias on the
tensor cores.

Tolerances: the emulations sum in another order than the plain versions
(the two warpgroups' partial row sums and partial O, online maxima over
64- or 128-key tiles), so outputs may land one bf16 rounding apart: within
2 bf16 ulps of (|plain| + rms(plain)) elementwise, i.e. (|plain| + rms) /
64, for the forms that divide p before rounding it. The streaming form
rounds p against another running maximum than its plain version (128-key
tiles, not 1024): chip_smoke's rule, 4 ulps and 1/128 relative L2.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu_torch.ops import attention as A
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

jattn = importlib.import_module("lvv_tpu.ops.attention")

LOG2E = math.log2(math.e)
NEG_BIG = -1e30

# window_sm90.cuh: the kv rows a window of S keys takes (win_rows) and, at
# head dim 64, the keys each of the two warpgroups owns in a q tile (the
# dispatch at the end of win_sm90)
SPLIT_KEYS = {
    128: ([(0, 64)], [(64, 128)]),
    208: ([(0, 64), (160, 208)], [(64, 160)]),
    256: ([(0, 64), (128, 192)], [(64, 128), (192, 256)]),
}


def kv_rows(s: int) -> int:
    return 64 if s <= 64 else 128 if s <= 128 else 208 if s <= 208 else 256


def key_groups(s: int, d: int):
    n = kv_rows(s)
    if d == 64 and n >= 128:
        return [[k for lo, hi in wg for k in range(lo, hi)]
                for wg in SPLIT_KEYS[n]]
    return [list(range(n))]


def one_hot(n: int, s: int, gh: int, gw: int) -> torch.Tensor:
    """The expander E [32, N]: E[kv // gw, kv] = E[16 + kv % gw, kv] = 1
    for kv < S, else 0."""
    e = torch.zeros(32, n)
    kv = torch.arange(s)
    e[kv // gw, kv] = 1.0
    e[16 + kv % gw, kv] = 1.0
    return e


def bias_rows(rh, rw, gh: int, gw: int) -> torch.Tensor:
    """The A operand of the bias product: [rh[.., :gh] | 0 | rw[.., :gw] |
    0], 16 columns each, in fp32."""
    f = torch.nn.functional
    return torch.cat([f.pad(rh[..., :gh].float(), (0, 16 - gh)),
                      f.pad(rw[..., :gw].float(), (0, 16 - gw))], -1)


def resident(st, v, s: int, d: int, base2: bool):
    """The resident kernel's softmax and P·V on logits st [.., S, N] (keys
    past S not yet masked) and v [.., S, d]: each warpgroup's partial row
    maximum and sum, exchanged (sums added in warpgroup order), p divided,
    rounded to bf16, each warpgroup's partial O added in order. fp32."""
    n = st.shape[-1]
    st = st.clone()
    st[..., s:] = NEG_BIG
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, n - s))
    groups = key_groups(s, d)
    m = torch.stack([st[..., g].amax(-1) for g in groups]).amax(0)
    x = st - m[..., None]
    p = torch.exp2(x if base2 else x * LOG2E)
    l = sum(p[..., g].sum(-1) for g in groups)
    p = (p / l[..., None]).to(torch.bfloat16).float()
    return sum(torch.matmul(p[..., g], vp[..., g, :]) for g in groups)


def whole_row_rows(qkv, rh, rw, *, heads: int, win: int, scale: float,
                   prescale: bool):
    """window_attention_rows.cu's rows modes: q·k (q rounded to bf16(q·cs)
    first in kRowsPre, else the product times cs), plus the bias rows
    times the one-hot expander, then the resident softmax."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = A._split_qkv(qkv, heads)
    n = kv_rows(s)
    cs = torch.tensor(scale * LOG2E, dtype=torch.float32).item()
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, n - s))
    if prescale:
        st = torch.matmul((q.float() * cs).to(qkv.dtype).float(),
                          kp.transpose(-1, -2))
    else:
        st = torch.matmul(q.float(), kp.transpose(-1, -2)) * cs
    st = st + torch.matmul(bias_rows(rh, rw, win, win),
                           one_hot(n, s, win, win))
    out = resident(st, v, s, d, base2=True).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, s, c3 // 3)


def _bf16(*shape, std=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(torch.bfloat16)


def _close(got, want, ulps: int = 2):
    got, want = got.float(), want.float()
    scale = want.abs() + want.square().mean().sqrt()
    err = (got - want).abs()
    assert bool((err <= scale * ulps / 128).all()), float(
        (err / scale).max())


# ------------------------------------------------------------- routing --

@pytest.mark.parametrize("s,d,gw,bq,bk,want", [
    (196, 64, 14, 256, 256, ("small", 196, 256)),      # resident 14x14
    (256, 64, 32, 256, 256, ("small2", 256, 256)),     # 8x32: gw > 16
    (400, 64, 20, 1024, 1024, ("small2", 400, 512)),   # 20x20: S > 256
    (320, 128, 20, 1024, 1024, ("small2", 320, 384)),  # 16x20, head dim 128
    (1600, 64, 40, 4096, 1024, ("stream", 1024, 1024)),   # keys >= 1024 out
    (6400, 64, 80, 4096, 1024, ("stream", 6400, 1024)),   # SAM at 1280²
    (4096, 64, 64, 4096, 1024, ("fused", 4096, 1024)),    # d + gh <= 128
])
def test_kh_form_routes_as_the_wrapper_does(s, d, gw, bq, bk, want):
    """The form, kv extent and tile K-h's wrapper launches: JAX's dispatch
    (fused test, small form at S padded to 512 or less, streaming with
    kh_tiles' extent), the small form split by whether the resident
    kernel's one-hot bias covers the grid (S <= 256, both sides <= 16)."""
    assert A.kh_form(s, d, gw, bq, bk) == want
    if want[0] == "fused":
        assert A.kh_form(s, d, gw, bq, bk, fused=False)[0] == "stream"


@pytest.mark.parametrize("gh,gw,want", [
    (80, 80, True),              # SAM at 1280²
    (112, 112, True),            # SAM at 1792²
    (255, 1, True),              # past the column table's 8-bit fields the
    (256, 1, True),              # float forms read the tables globally
    (200, 200, True),            # 128 table rows do not fit beside the tiles
    (1, 630, True),              # the 64-row slice's bound at its edge
    (1, 640, False),
    (400, 400, False),
])
def test_kh_tables_fit_takes_each_arm_by_its_own_rule(gh, gw, want):
    """Which grids K-h's wrapper sends to the kernel: every arm by one rule,
    the first kernel's 64-row table slice in 160 KB (the float forms and
    the int8 arm read tables that do not fit shared memory from global
    memory)."""
    assert A._kh_tables_fit(gh * gw, gh, gw) == want


# ------------------------------------------------------- one-hot bias --

def _expander_bytes(n: int, s: int, gw: int) -> np.ndarray:
    """What win_sm90 writes: uint4 core row i holds keys 8·(i // 32) + i % 8
    at k = 8·((i // 8) % 4) .. + 7, as bf16 1.0 where k is kv // gw or
    16 + kv % gw (kv < S). Returned as the flat array of bf16 entries."""
    flat = np.zeros(n * 32, np.float32)
    for i in range(n * 4):
        key, k0 = (i >> 5) * 8 + (i & 7), ((i >> 3) & 3) * 8
        for u in range(8):
            k = k0 + u
            if key < s and k in (key // gw, 16 + key % gw):
                flat[i * 8 + u] = 1.0
    return flat


def _read_k_major(flat, start: int, n_keys: int, lbo=128, sbo=512):
    """B [16, n_keys] as wgmma reads a K-major operand without swizzle from
    byte `start`: entry (k, n) at (n // 8)·sbo + (k // 8)·lbo + (n % 8)·16
    + (k % 8)·2 bytes."""
    b = np.zeros((16, n_keys), np.float32)
    for k in range(16):
        for n in range(n_keys):
            off = start + (n // 8) * sbo + (k // 8) * lbo + (n % 8) * 16 \
                + (k % 8) * 2
            b[k, n] = flat[off // 2]
    return b


@pytest.mark.parametrize("gh,gw", [(7, 7), (8, 8), (14, 14), (16, 16),
                                   (8, 16)])
def test_expander_layout_is_the_one_hot(gh, gw):
    """The expander's bytes, read back through the descriptors the kernel
    issues (64-key chunks and 16-key pieces, k-step 0 for rh and 1 for rw:
    start (key / 8)·512 + k-step·256, LBO 128, SBO 512), are E."""
    s = gh * gw
    n = kv_rows(s)
    flat = _expander_bytes(n, s, gw)
    want = one_hot(n, s, gh, gw).numpy()
    pieces = [(c * 64, 64) for c in range(n // 64)]
    pieces += [(p, 16) for p in range(n // 64 * 64, n, 16)]
    for key0, width in pieces:
        for ks in range(2):
            got = _read_k_major(flat, key0 // 8 * 512 + ks * 256, width)
            np.testing.assert_array_equal(
                got, want[16 * ks:16 * ks + 16, key0:key0 + width])


@pytest.mark.parametrize("gh,gw", [(14, 14), (7, 7), (8, 16)])
def test_one_hot_product_is_the_gather(gh, gw):
    """[rh | rw] times E in fp32 is rh[kv // gw] + rw[kv % gw] bit for bit:
    two exact bf16 terms times 1.0 and zeros."""
    s = gh * gw
    rh, rw = _bf16(3, s, gh, std=3.0, seed=1), _bf16(3, s, gw, std=3.0,
                                                     seed=2)
    got = torch.matmul(bias_rows(rh, rw, gh, gw),
                       one_hot(kv_rows(s), s, gh, gw))[..., :s]
    kv = torch.arange(s)
    want = rh.float()[..., kv // gw] + rw.float()[..., kv % gw]
    assert torch.equal(got, want)


# -------------------------------------------------- the window kernel --

@pytest.mark.parametrize("win", [7, 14])
@pytest.mark.parametrize("kind", ["fused", "fused2", "v3", "v4"])
def test_whole_row_schedule_matches_rows_plain(kind, win):
    """The resident whole-row schedule of the rows modes (scores of every
    key, the bias on the tensor cores, exact maximum and sum over the two
    warpgroups' halves, divide, round, partial O added) on each layout's
    own bias rows, against the function every body is held to."""
    heads, d = 2, 64
    qkv = _bf16(3, win * win, 3 * heads * d)
    rel_h, rel_w = _bf16(win, win, d, std=0.3, seed=1), _bf16(
        win, win, d, std=0.3, seed=2)
    rh, rw = A._window_glue(kind, qkv, rel_h, rel_w, heads, win, True)
    kw = dict(heads=heads, win=win, scale=d ** -0.5,
              prescale=kind in ("fused", "fused2"))
    _close(whole_row_rows(qkv, rh, rw, **kw),
           A._window_rows_plain(qkv, rh, rw, **kw))


@pytest.mark.parametrize("variant", ["softmax", "bias2"])
def test_whole_row_schedule_matches_bisect_plain(variant):
    """B-1's softmax and bias2 modes on the resident schedule (base e;
    bias2's expander products accumulated into the scaled scores, qrh·eh
    first), against window_attention_bisect_plain."""
    heads, d, win = 2, 64, 14
    s = win * win
    qkv = _bf16(3, s, 3 * heads * d)
    qrh, qrw = _bf16(3, heads, s, 16, std=0.3, seed=1), _bf16(
        3, heads, s, 16, std=0.3, seed=2)
    eh, ew = _bf16(16, s, std=0.1, seed=3), _bf16(16, s, std=0.1, seed=4)
    q, k, v = A._split_qkv(qkv, heads)
    n = kv_rows(s)
    pad = torch.nn.functional.pad
    st = torch.matmul(q.float(), pad(k.float(), (0, 0, 0, n - s))
                      .transpose(-1, -2)) * 0.125
    if variant == "bias2":
        st = st + pad(torch.matmul(qrh.float(), eh.float()), (0, n - s))
        st = st + pad(torch.matmul(qrw.float(), ew.float()), (0, n - s))
    out = resident(st, v, s, d, base2=False).to(qkv.dtype)
    got = out.transpose(1, 2).reshape(3, s, heads * d)
    _close(got, A.window_attention_bisect_plain(
        qkv, variant=variant, heads=heads, scale=0.125, qrh=qrh, qrw=qrw,
        eh=eh, ew=ew))


# --------------------------------------------------------------- K-h ----

def _kh_ops(b, heads, gh, gw, d, seed=0):
    s = gh * gw
    qkv = _bf16(b, s, 3 * heads * d, std=0.5, seed=seed)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    return (q, k, v, _bf16(b, heads, s, gh, std=0.5, seed=seed + 1),
            _bf16(b, heads, s, gw, std=0.5, seed=seed + 2))


def test_resident_small_form_matches_plain():
    """K-h's small form at 14x14 on the resident kernel: natural-domain
    logits (q·k·scale plus the tables times the one-hot expander), exact
    softmax in base e, p divided then rounded."""
    q, k, v, qrh, qrw = _kh_ops(3, 2, 14, 14, 64)
    s, n = 196, kv_rows(196)
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, n - s))
    st = (torch.matmul(q.float(), kp.transpose(-1, -2)) * 0.125
          + torch.matmul(bias_rows(qrh, qrw, 14, 14), one_hot(n, s, 14, 14)))
    got = resident(st, v, s, 64, base2=False).to(q.dtype)
    _close(got, A.flash_attention_relpos_plain(
        q, k, v, qrh, qrw, scale=0.125, grid_w=14, block_q=256,
        block_k=256))


def two_pass(q, k, v, q_rh, q_rw, *, scale: float, grid_w: int,
             tile: int = 64):
    """kh_stream_sm90 in mode kSmall2: log2-domain logits q·k·scale·log2e
    + (rh + rw)·log2e over `tile`-key tiles, pass 1 the online row maximum
    and sum, pass 2 p = exp2(s − m) / l rounded to v's dtype, times v."""
    s = q.shape[2]
    kv = torch.arange(s)
    st = (torch.matmul(q.float(), k.float().transpose(-1, -2))
          * (scale * LOG2E) + (q_rh.float()[..., kv // grid_w] * LOG2E
                               + q_rw.float()[..., kv % grid_w] * LOG2E))
    m = torch.full(st.shape[:-1], NEG_BIG)
    l = torch.zeros(st.shape[:-1])
    for c0 in range(0, s, tile):
        blk = st[..., c0:c0 + tile]
        mn = torch.maximum(m, blk.amax(-1))
        l = l * torch.exp2(m - mn) + torch.exp2(blk - mn[..., None]).sum(-1)
        m = mn
    p = (torch.exp2(st - m[..., None]) / l[..., None]).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@pytest.mark.parametrize("gh,gw,d", [(20, 20, 64), (16, 20, 128)])
def test_two_pass_small_form_matches_plain(gh, gw, d):
    """The two-pass small form (S = 400 and 320: above the resident
    kernel's S <= 256 / 16 x 16) against the small form's plain version."""
    ops = _kh_ops(2, 2, gh, gw, d)
    kw = dict(scale=d ** -0.5, grid_w=gw)
    assert A.kh_form(gh * gw, d, gw, 1024, 1024)[0] == "small2"
    _close(two_pass(*ops, **kw), A.flash_attention_relpos_plain(
        *ops, block_q=1024, block_k=1024, **kw))


def test_two_pass_small_form_matches_pallas():
    """The same at 20x20 against JAX's `flash_attention_relpos` in
    interpret mode (its single-tile _relpos_mh_kernel), in float32, where
    only the summation order differs."""
    rng = np.random.default_rng(5)
    s, gw = 400, 20
    arrs = [rng.standard_normal(shape).astype(np.float32) * 0.5
            for shape in ((1, 2, s, 64),) * 3 + ((1, 2, s, 20),) * 2]
    want = np.asarray(jattn.flash_attention_relpos(
        *(jnp.asarray(x) for x in arrs), scale=0.125, grid_w=gw,
        block_q=1024, block_k=1024, interpret=True))
    got = two_pass(*(torch.from_numpy(x) for x in arrs), scale=0.125,
                   grid_w=gw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("gh,gw", [(40, 40), (24, 40)])
def test_streaming_schedule_matches_plain(gh, gw):
    """kh_stream_sm90's online softmax over 128-key tiles with the columns
    at or past kv_end masked (40x40: keys 1024-1599 dropped, as JAX's
    tiles drop them) against the streaming form's plain version, which
    walks 1024-key tiles: both round p against their running maximum."""
    from chip_smoke import REL_L2_TOL, agreement
    q, k, v, qrh, qrw = _kh_ops(1, 2, gh, gw, 64, seed=3)
    s = gh * gw
    form, kv_end, _ = A.kh_form(s, 64, gw, 4096, 1024)
    assert form == "stream" and kv_end == min(s, 1024)
    kv = torch.arange(s)
    st = (torch.matmul(q.float(), k.float().transpose(-1, -2))
          * (0.125 * LOG2E) + (qrh.float()[..., kv // gw] * LOG2E
                               + qrw.float()[..., kv % gw] * LOG2E))
    m = torch.full(st.shape[:-1], NEG_BIG)
    l = torch.zeros(st.shape[:-1])
    o = torch.zeros(*st.shape[:-1], 64)
    for c0 in range(0, kv_end, 128):
        blk = st[..., c0:min(c0 + 128, kv_end)]
        mn = torch.maximum(m, blk.amax(-1))
        p = torch.exp2(blk - mn[..., None])
        alpha = torch.exp2(m - mn)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), v[..., c0:c0 + blk.shape[-1], :]
            .float())
        m = mn
    got = (o / l[..., None]).to(q.dtype)
    want = A.flash_attention_relpos_plain(q, k, v, qrh, qrw, scale=0.125,
                                          grid_w=gw, block_q=4096,
                                          block_k=1024)
    ok, err, rel = agreement(got, want, REL_L2_TOL)
    assert ok, (err, rel)
