"""B-1 and B-2, the window-attention cost-bisect kernels of two benchmark
scripts, in the port against their Pallas kernels.

The scripts (`benchmarks/winattn_bisect2.py::main.make(variant)`, B-1, and
`benchmarks/winattn_bisect3.py::main.make_hmaj(batched)`, B-2) define their
kernel bodies as closures inside `main()`, so they cannot be imported: each
`kern` is rebuilt here verbatim, at a small size, and run through
`pl.pallas_call(..., interpret=True)` on inputs drawn as the scripts draw
them (numpy default_rng(0): qkv N(0, 1), then the rel tables, then qrh
0.3·N(0, 1) and eh 0.1·N(0, 1)). B-1's script passes qrh for both rows and
eh for both expanders; here bias2 gets distinct qrw and ew too, so that each
product is checked. The port's wrappers compute their plain versions on CPU
tensors and launch nothing.

Tolerances: float32 within atol / rtol 2e-5 (the same sums in another
order; measured at most 5.4e-7). bfloat16 within 2 bf16 ulps of (|JAX| +
rms(JAX)) elementwise, i.e. (|JAX| + rms) / 64: both sides round at the same
points, so they differ only where an fp32 sum or exp taken another way lands
on the other side of a bf16 rounding (measured at most 0.31 of that
scale). The bias2 trap (its expanders read as
one-hot, a gather) must be outside that tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from lvv_tpu_torch import kernels
from lvv_tpu_torch.ops import attention as A
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(8, 2, 64), (14, 2, 64)]       # (win, heads, hd): S >= hd
B = 2


def _draw(win, heads, hd, dtype):
    """The scripts' inputs at a small size, as (JAX, torch) pairs of qkv,
    qrh, qrw, eh, ew; bf16 values are rounded once and shared."""
    jd, td = DTYPES[dtype]
    s = win * win
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(B, s, 3 * heads * hd))
    rng.normal(size=(win, win, hd))          # rel_h, rel_w: unused by B-1
    rng.normal(size=(win, win, hd))
    qrh = rng.normal(size=(B, heads, s, 16)) * 0.3
    eh = rng.normal(size=(16, s)) * 0.1
    qrw = rng.normal(size=(B, heads, s, 16)) * 0.3
    ew = rng.normal(size=(16, s)) * 0.1
    arrs = [np.asarray(jnp.asarray(a, jd).astype(jnp.float32))
            for a in (qkv, qrh, qrw, eh, ew)]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a).to(td) for a in arrs])


def _bisect2(variant, qkv, qrh, qrw, eh, ew, heads, hd):
    """benchmarks/winattn_bisect2.py's `make(variant)` at qkv's shape, its
    `kern` verbatim, in interpret mode."""
    B, S, _ = qkv.shape
    HEADS, HD = heads, hd
    C = HEADS * HD
    scale = 1.0 / np.sqrt(HD)

    def kern(qkv_ref, qrh_ref, qrw_ref, eh_ref, ew_ref, o_ref):
        c = C
        hd = HD
        ehv = eh_ref[...]
        ewv = ew_ref[...]
        for h in range(HEADS):
            q = qkv_ref[0][:, h * hd:(h + 1) * hd]
            k = qkv_ref[0][:, c + h * hd:c + (h + 1) * hd]
            v = qkv_ref[0][:, 2 * c + h * hd:2 * c + (h + 1) * hd]
            s = jax.lax.dot_general(
                q, k, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32) * scale
            if variant in ("bias2",):
                s = s + jax.lax.dot_general(
                    qrh_ref[0, h], ehv, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
                s = s + jax.lax.dot_general(
                    qrw_ref[0, h], ewv, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
            if variant == "dots_qk":
                o_ref[0, :, h * hd:(h + 1) * hd] = (
                    s[:, :hd] * 1e-3).astype(o_ref.dtype)
                continue
            if variant in ("softmax", "bias2"):
                m = jnp.max(s, axis=-1, keepdims=True)
                p = jnp.exp(s - m)
                p = p / jnp.sum(p, axis=-1, keepdims=True)
            else:  # dots_qk_pv
                p = s * 1e-3
            o_ref[0, :, h * hd:(h + 1) * hd] = jax.lax.dot_general(
                p.astype(v.dtype), v, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32).astype(o_ref.dtype)

    return pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, S, 3 * C), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, HEADS, S, 16), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, HEADS, S, 16), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((16, S), lambda i: (0, 0)),
            pl.BlockSpec((16, S), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, S, C), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, S, C), qkv.dtype),
        interpret=True,
    )(qkv, qrh, qrw, eh, ew)


def _bisect3_hmaj(batched, q4, k4, v4):
    """benchmarks/winattn_bisect3.py's `make_hmaj(batched)` at q4's shape,
    its `kern` verbatim, in interpret mode."""
    B, HEADS, S, HD = q4.shape
    scale = 1.0 / np.sqrt(HD)

    def kern(q_ref, k_ref, v_ref, o_ref):
        if batched:
            q3 = q_ref[0]
            k3 = k_ref[0]
            v3 = v_ref[0]
            s = jax.lax.dot_general(
                q3, k3, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale
            m = jnp.max(s, axis=-1, keepdims=True)
            p = jnp.exp(s - m)
            p = p / jnp.sum(p, axis=-1, keepdims=True)
            o_ref[0] = jax.lax.dot_general(
                p.astype(v3.dtype), v3, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32).astype(o_ref.dtype)
        else:
            for h in range(HEADS):
                q = q_ref[0, h]
                k = k_ref[0, h]
                v = v_ref[0, h]
                s = jax.lax.dot_general(
                    q, k, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32) * scale
                m = jnp.max(s, axis=-1, keepdims=True)
                p = jnp.exp(s - m)
                p = p / jnp.sum(p, axis=-1, keepdims=True)
                o_ref[0, h] = jax.lax.dot_general(
                    p.astype(v.dtype), v, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32
                ).astype(o_ref.dtype)

    return pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[pl.BlockSpec((1, HEADS, S, HD),
                               lambda i: (i, 0, 0, 0))] * 3,
        out_specs=pl.BlockSpec((1, HEADS, S, HD), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, HEADS, S, HD), q4.dtype),
        interpret=True,
    )(q4, k4, v4)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(got, want, dtype) -> bool:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        return bool(np.allclose(got, want, atol=2e-5, rtol=2e-5))
    scale = np.abs(want) + np.sqrt(np.mean(want ** 2))
    return bool(np.all(np.abs(got - want) <= scale / 64))


def _no_launch(fn):
    before = dict(kernels.launches)
    out = fn()
    assert dict(kernels.launches) == before      # CPU: the plain version
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("win,heads,hd", SHAPES)
@pytest.mark.parametrize("variant", A.BISECT_VARIANTS)
def test_bisect2_variant_matches_pallas(variant, win, heads, hd, dtype):
    (jq, jrh, jrw, jeh, jew), (tq, trh, trw, teh, tew) = _draw(
        win, heads, hd, dtype)
    want = _bisect2(variant, jq, jrh, jrw, jeh, jew, heads, hd)
    got = _no_launch(lambda: A.window_attention_bisect(
        tq, variant=variant, heads=heads, scale=1.0 / math.sqrt(hd),
        qrh=trh, qrw=trw, eh=teh, ew=tew))
    assert got.dtype == DTYPES[dtype][1]
    assert _within(got, want, dtype), float(np.abs(_f32(got)
                                                   - _f32(want)).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batched", [False, True])
def test_bisect3_hmaj_matches_pallas(batched, dtype):
    """B-2 on head-major q, k, v cut from the packed qkv as the script does
    (transposes to [B, H, S, d]): each of the script's two schedules gives
    the port's one function."""
    win, heads, hd = 14, 2, 64
    (jq, *_), (tq, *_) = _draw(win, heads, hd, dtype)
    c = heads * hd

    def split(x, i):
        y = x[..., i * c:(i + 1) * c].reshape(B, win * win, heads, hd)
        return (y.transpose(0, 2, 1, 3) if isinstance(y, jax.Array)
                else y.transpose(1, 2))
    want = _bisect3_hmaj(batched, *(split(jq, i) for i in range(3)))
    got = _no_launch(lambda: A.window_attention_hmaj(
        *(split(tq, i) for i in range(3)), scale=1.0 / math.sqrt(hd)))
    assert got.shape == (B, heads, win * win, hd)
    assert _within(got, want, dtype), float(np.abs(_f32(got)
                                                   - _f32(want)).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bias2_gather_trap_fails_the_tolerance(dtype):
    """Reading bias2's dense expanders as one-hot (K-l's gather of table
    columns kv // win and kv % win) gives another function: the tolerance
    that the kernel is held to on the card must fail it, here and there."""
    win, heads, hd = 14, 2, 64
    (jq, jrh, jrw, jeh, jew), (tq, trh, trw, teh, tew) = _draw(
        win, heads, hd, dtype)
    want = _bisect2("bias2", jq, jrh, jrw, jeh, jew, heads, hd)
    kw = dict(heads=heads, scale=1.0 / math.sqrt(hd), qrh=trh, qrw=trw,
              eh=teh, ew=tew)
    trap = chip_smoke.bias2_gather_trap(tq, **kw)
    assert not _within(trap, want, dtype)
    ok, _, rel = chip_smoke.agreement(
        trap, A.window_attention_bisect_plain(tq, variant="bias2", **kw))
    assert not ok and rel > 8 * chip_smoke.REL_L2_TOL, rel


def test_bisect_shapes_are_checked():
    """Shapes the bisect functions do not define raise ValueError on the
    CPU as well: dots_qk over fewer keys than the head dim, bias2 without
    its tables or with expanders of another depth, B-2 with unequal q, k,
    v."""
    _, (tq, trh, trw, teh, tew) = _draw(8, 2, 64, "float32")
    kw = dict(heads=2, scale=0.125)
    small = torch.zeros(1, 49, 3 * 128)                 # S 49 < d 64
    with pytest.raises(ValueError):
        A.window_attention_bisect(small, variant="dots_qk", **kw)
    A.window_attention_bisect(small, variant="softmax", **kw)
    with pytest.raises(ValueError):
        A.window_attention_bisect(tq, variant="bias2", **kw)
    with pytest.raises(ValueError):
        A.window_attention_bisect(tq, variant="bias2", qrh=trh, qrw=trw,
                                  eh=teh[:8], ew=tew[:8], **kw)
    with pytest.raises(ValueError):
        A.window_attention_bisect(tq, variant="packed", **kw)
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError):
        A.window_attention_hmaj(q, q, q[:, :, :32], scale=0.125)
