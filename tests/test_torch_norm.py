"""Kernel K-a's add form in the port against the JAX package.

`add_norm(x, y, ...)` (kernels/csrc/norm.cu on the card) computes s = x + y
rounded once to x's dtype and n = norm(s) in one launch; on a CPU tensor it
computes its plain version `add_norm_plain`, PyTorch's add and then
`norm_plain`. Here that plain version is held to the JAX sequence it takes
the place of, `x + y` and then `norm_fast` (the Pallas kernel K-a in
interpret mode), on the same seeded inputs (numpy), and the Qwen stack,
whose residual adds now run in the following norm's launch, is held to the
JAX package's on one seeded parameter tree.

Tolerances. s is bit-equal (one fp32 add, one rounding, on both sides).
n: in float32 2e-5 relative to (1 + |JAX|) (sums over 256 or 896 terms in
another order); in bfloat16 one bf16 ulp of the larger magnitude (the two
fp32 results, a few fp32 ulps apart, may round to neighbouring bf16
values), as the prep tests state it. The Qwen logits: 1e-4 relative to (1 +
|JAX|), float32 round-off through two layers (test_torch_vqa.py), and the
greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.models.decode_fused import fused_decode_step as jax_fused_step
from lvv_tpu.models.decode_fused import pack_decode_params as jax_pack
from lvv_tpu.models.qwen import init_cache as jax_init_cache
from lvv_tpu.ops import fused_mlp as jmlp
from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
from lvv_tpu_torch.models.decode_fused import (fused_decode_step,
                                               pack_decode_params)
from lvv_tpu_torch.models.qwen import init_cache
from lvv_tpu_torch.ops import fused_mlp as tmlp
from torch_parity_util import close, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(1, 896), (8, 896), (2, 37, 256)]    # decode, batch 8, ragged


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _norm_agree(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        return
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_add_norm_matches_pallas(shape, rms, dtype):
    """(x + y, norm(x + y)) against JAX's add and interpret-mode K-a."""
    jd, td = DTYPES[dtype]
    c = shape[-1]
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(shape) * 2, rng.standard_normal(shape),
            1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)]
    arrs = [np.asarray(jnp.asarray(a, jd).astype(jnp.float32)) for a in arrs]
    jx, jy, js, jb = (jnp.asarray(a, jd) for a in arrs)
    tx, ty, ts, tb = (torch.tensor(a).to(td) for a in arrs)
    js_sum = jx + jy
    want = jmlp.norm_fast(js_sum, js, None if rms else jb, eps=1e-6, rms=rms,
                          interpret=True)
    s, n = tmlp.add_norm(tx, ty, ts, None if rms else tb, eps=1e-6, rms=rms)
    assert s.dtype == td and n.dtype == td
    np.testing.assert_array_equal(_f32(s), _f32(js_sum))
    _norm_agree(n, want, dtype)
    # the plain version and the dispatch entry are the same function here
    for got in (tmlp.add_norm_plain(tx, ty, ts, None if rms else tb,
                                    eps=1e-6, rms=rms),
                tmlp.add_norm_fast(tx, ty, ts, None if rms else tb,
                                   eps=1e-6, rms=rms)):
        assert torch.equal(got[0], s) and torch.equal(got[1], n)


@pytest.fixture(scope="module")
def pairs():
    """rank -> (JAX model, params, port model, cfg) on the tiny config
    (a 2-layer Qwen), built once per rank."""
    made = {}

    def get(lora_rank):
        if lora_rank not in made:
            jm, params = jax_model_and_params(lora_rank=lora_rank)
            cfg = tiny_config().model
            pm = VQAModel(cfg, dtype=torch.float32, device="cpu",
                          llm_lora_rank=lora_rank, llm_lora_alpha=4.0,
                          clip_lora_rank=lora_rank, clip_lora_alpha=4.0)
            pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
            made[lora_rank] = (jm, params, pm, cfg)
        return made[lora_rank]
    return get


def _llm_inputs(cfg):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 9, cfg.llm.hidden_size)).astype(np.float32)
    return emb, np.array([9, 6], np.int32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lora_rank", [0, 2])
def test_qwen_add_forms_match_jax(pairs, lora_rank, fused):
    """The 2-layer Qwen whose adds run in the norms' launches: prefill
    logits over padded embeddings, then 6 greedy steps through
    QwenModel.forward (the float decode) or fused_decode_step (the packed
    int8 decode): every step's logits and the tokens equal JAX's."""
    jm, params, pm, cfg = pairs(lora_rank)
    assert cfg.llm.num_layers == 2
    emb, seq_len = _llm_inputs(cfg)
    steps, cache_len = 6, 24

    def jax_prefill(p, e, s):
        return jm.apply({"params": p}, e, seq_len=s,
                        cache=jax_init_cache(jm.cfg.llm, 2, cache_len),
                        last_pos=s - 1, method=lambda m, *a, **k: m.llm(
                            *a, **k))
    j_logits, j_cache = jax.jit(jax_prefill)(params, emb, seq_len)
    t_cache = init_cache(cfg.llm, 2, cache_len, dtype=torch.float32,
                         device="cpu")
    with torch.no_grad():
        t_logits = pm.llm(torch.as_tensor(emb),
                          seq_len=torch.as_tensor(seq_len), cache=t_cache,
                          last_pos=torch.as_tensor(seq_len) - 1)
    close(t_logits.numpy(), np.asarray(j_logits), 1e-4)

    if fused:
        jpack = jax_pack(params["llm"], jm.cfg.llm,
                         lora_scaling=4.0 / lora_rank if lora_rank else 1.0)
        j_step = jax.jit(lambda ids, c: jax_fused_step(
            jm.cfg.llm, jnp.float32, jpack, ids, c))
        tpack = pack_decode_params(pm.llm)

        def t_step(ids, c):
            return fused_decode_step(cfg.llm, torch.float32, tpack, ids, c)
    else:
        def jax_decode(p, ids, c):
            return jm.apply({"params": p}, ids, c,
                            method=lambda m, i, cc: m.decode_step(i, cc))
        j_step = jax.jit(lambda ids, c: jax_decode(params, ids, c))

        def t_step(ids, c):
            out = pm.llm(pm.llm.embed(ids[:, None]),
                         positions=c.length[:, None].long(), cache=c)
            return out[:, -1]
    j_last, t_last = np.asarray(j_logits)[:, -1], t_logits[:, -1]
    j_tok, t_tok = [], []
    for _ in range(steps):
        j_ids = np.argmax(j_last, -1).astype(np.int32)
        t_ids = torch.argmax(t_last, -1)
        j_tok.append(j_ids)
        t_tok.append(t_ids.numpy())
        j_last, j_cache = j_step(jnp.asarray(j_ids), j_cache)
        with torch.no_grad():
            t_last = t_step(t_ids, t_cache)
        close(t_last.numpy(), np.asarray(j_last), 1e-4)
    j_tok, t_tok = np.stack(j_tok, 1), np.stack(t_tok, 1)
    assert len(set(j_tok.ravel().tolist())) > 2   # a non-degenerate answer
    np.testing.assert_array_equal(t_tok, j_tok)


def test_qwen_layer_forward_is_its_pending_sum(pairs):
    """QwenLayer.forward keeps its public behaviour: the layer's output is
    forward_pending's (h, mlp) summed, and the model's stack hands each
    layer's mlp on to the next layer's input norm."""
    _, _, pm, cfg = pairs(2)
    emb, _ = _llm_inputs(cfg)
    x = torch.as_tensor(emb)
    pos = torch.arange(x.shape[1])[None].expand(2, -1)
    layer = pm.llm.layer_0
    with torch.no_grad():
        h, mlp = layer.forward_pending(x, None, pos)
        assert torch.equal(layer(x, pos), h + mlp)
        h1, mlp1 = pm.llm.layer_1.forward_pending(h, mlp, pos)
        want = pm.llm.layer_1(layer(x, pos), pos)
    close((h1 + mlp1).numpy(), want.numpy(), 1e-6)
