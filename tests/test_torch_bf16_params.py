"""The port's bf16 model against the JAX package's on norm parameters that
have moved off ones and zeros.

The JAX package keeps every parameter in fp32 and casts at use; its norms
take the fp32 scale and bias as they are (`_norm_xla`, the Pallas bodies'
`ls_ref[...].astype(jnp.float32)`). The port keeps the norm parameters, and
CLIP's position table that JAX resamples in fp32, in fp32 whatever the
model's dtype. Rounding a scale of 1 + 0.1·N to bf16 first changes about
30% of a norm's bf16 outputs (14% at 1 + 1e-3·N, a few training updates
away from ones); kept in fp32, the two packages differ only where their
fp32 reductions round apart, so these bounds hold:

- a single norm (LayerNorm, RMSNorm, SAM's LayerNorm2d) on bf16 x: at most
  NORM_DIFF_SHARE of the bf16 outputs differ from JAX's, and their rel L2
  is at most NORM_REL_L2;
- the tiny model in bf16 (`tiny_config()`, every leaf random, norm scales 1
  + 0.1·N, biases 0.1·N): prefix embeddings within PREFIX_REL_L2 and
  prefill logits within PREFILL_REL_L2 of JAX's bf16 model. Both round
  every layer to bf16, in different orders, so they never agree exactly;
  with the norm parameters rounded to bf16 the prefix is 0.0122 away
  (0.0092 in fp32) and the logits 0.0144 (0.0138): the bf16 products'
  rounding, not the norms, sets the logits' distance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvv_tpu.models import layers as jax_layers
from lvv_tpu.models.qwen import init_cache as jax_init_cache
from lvv_tpu.models.sam import LayerNorm2d as JaxLayerNorm2d
from lvv_tpu.models.vqa import VQAModel as JaxVQAModel
from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
from lvv_tpu_torch.config import override
from lvv_tpu_torch.inference import ModelLoader, save_checkpoint
from lvv_tpu_torch.models.layers import LayerNorm, RMSNorm
from lvv_tpu_torch.models.qwen import init_cache
from lvv_tpu_torch.train.train_step import TrainState, load_masters
from torch_parity_util import inputs, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

NORM_DIFF_SHARE = 0.01
NORM_REL_L2 = 1e-3
PREFIX_REL_L2 = 0.011
PREFILL_REL_L2 = 0.02


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _share_and_rel(got: np.ndarray, want: np.ndarray):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    share = float(np.mean(got != want))
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return share, rel


def _norm_case(kind: str, spread: float, rng):
    """(x bf16 torch, scale fp32 np, bias fp32 np or None, shape)."""
    c = 512
    shape = (2, 16, 32, c) if kind == "layernorm2d" else (2048, c)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(torch.bfloat16)
    scale = (1.0 + spread * rng.standard_normal(c)).astype(np.float32)
    bias = (None if kind == "rmsnorm"
            else (spread * rng.standard_normal(c)).astype(np.float32))
    return x, scale, bias


@pytest.mark.parametrize("spread", [0.1, 1e-3])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm", "layernorm2d"])
def test_norm_matches_jax_in_bf16(kind, spread):
    """One norm of the bf16 model, fp32 parameters in both packages."""
    x, scale, bias = _norm_case(kind, spread, np.random.default_rng(0))
    c = x.shape[-1]
    xj = jnp.asarray(_bf16_np(x), jnp.bfloat16)
    eps = 1e-6
    if kind == "rmsnorm":
        jm, params = jax_layers.RMSNorm(eps=eps), {"scale": scale}
        pm = RMSNorm(c, eps, dtype=torch.bfloat16, device="cpu")
    else:
        jm = (JaxLayerNorm2d(eps=eps) if kind == "layernorm2d"
              else jax_layers.LayerNorm(eps=eps))
        params = {"scale": scale, "bias": bias}
        pm = LayerNorm(c, eps, dtype=torch.bfloat16, device="cpu")
    want = np.asarray(jm.apply({"params": params}, xj).astype(jnp.float32))
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = _bf16_np(pm(x))
    share, rel = _share_and_rel(got, want)
    assert share <= NORM_DIFF_SHARE and rel <= NORM_REL_L2, (share, rel)


@pytest.fixture(scope="module")
def bf16_pair():
    """(JAX tiny model in bf16, its fp32 params, the port's bf16 model
    loaded from the same tree, cfg)."""
    jm, params = jax_model_and_params()
    jm = JaxVQAModel(jm.cfg, dtype=jnp.bfloat16)
    cfg = tiny_config().model
    pm = VQAModel(cfg, dtype=torch.bfloat16, device="cpu")
    pm.load_state_dict(from_jax_params(params, cfg, device="cpu"))
    return jm, params, pm, cfg


def _rel(got: torch.Tensor, want) -> float:
    return _share_and_rel(got.float().numpy(),
                          np.asarray(jnp.asarray(want, jnp.float32)))[1]


def test_prefix_and_prefill_match_jax_in_bf16(bf16_pair):
    """encode_prefix and the prefill logits of the bf16 models."""
    jm, params, pm, cfg = bf16_pair
    x = inputs(cfg, b=2, seed=3)
    sensors = (x["bev"], x["images"], x["view_valid"])
    want = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, method=JaxVQAModel.encode_prefix))(params, *sensors)
    with torch.no_grad():
        got = pm.encode_prefix(*(torch.as_tensor(a) for a in sensors))
    assert _rel(got, want) <= PREFIX_REL_L2, _rel(got, want)

    def jax_prefill(p, *a):
        cache = jax_init_cache(jm.cfg.llm, 2, 64, dtype=jnp.bfloat16)
        return jm.apply({"params": p}, *a, cache,
                        method=JaxVQAModel.prefill)[0]
    want = jax.jit(jax_prefill)(params, *sensors, x["prompt_ids"],
                                x["prompt_len"])
    with torch.no_grad():
        got = pm.prefill(*(torch.as_tensor(a) for a in sensors),
                         torch.as_tensor(x["prompt_ids"]).long(),
                         torch.as_tensor(x["prompt_len"]),
                         init_cache(cfg.llm, 2, 64, dtype=torch.bfloat16,
                                    device="cpu"))
    assert _rel(got, want) <= PREFILL_REL_L2, _rel(got, want)


def test_fp32_parameters_of_the_bf16_model(bf16_pair):
    """Exactly the norm parameters and CLIP's position table are fp32 in
    the bf16 model; every other parameter is bf16."""
    _, _, pm, _ = bf16_pair
    norms = {f"{name}.{p}" for name, m in pm.named_modules()
             if isinstance(m, (LayerNorm, RMSNorm))
             for p, _ in m.named_parameters()}
    fp32 = norms | {"deepencoder.clip.pos_embed"}
    assert len(norms) > 20
    for name, p in pm.named_parameters():
        want = torch.float32 if name in fp32 else torch.bfloat16
        assert p.dtype == want, (name, p.dtype)


def test_checkpoint_and_masters_keep_fp32_norms(bf16_pair, tmp_path):
    """model.pt round-trips the mixed dtypes bit-equal, and an optimizer
    update below bf16's spacing reaches a norm's working copy."""
    _, _, pm, cfg = bf16_pair
    full = tiny_config()
    for key, value in (("model.dtype", "bfloat16"),
                       ("model.llm_lora.enabled", False),
                       ("model.clip_lora.enabled", False)):
        full = override(full, key, value)
    save_checkpoint(pm, full, tmp_path)
    loaded, _ = ModelLoader(tmp_path).load_all(device="cpu")
    want = pm.state_dict()
    for k, v in loaded.state_dict().items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v, want[k]), k
    name = "llm.final_ln.scale"
    masters = {name: want[name].float().clone() + 1e-4}
    load_masters(loaded, TrainState(step=1, masters=masters, opt_state={},
                                    generator=None, frozen={}))
    got = dict(loaded.named_parameters())[name]
    assert torch.equal(got, masters[name])
    assert not torch.equal(got, want[name])


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_gradients_are_fp32_and_match_jax(kind):
    """The autograd Function of a bf16 norm with fp32 parameters returns
    fp32 parameter gradients, within 1e-3 rel L2 of jax.vjp through JAX's
    norm on the same bf16 x, fp32 parameters and cotangent."""
    x, scale, bias = _norm_case(kind, 0.1, np.random.default_rng(4))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        x.shape).astype(np.float32)).to(torch.bfloat16)
    rms = kind == "rmsnorm"
    c = x.shape[-1]
    pm = (RMSNorm if rms else LayerNorm)(c, 1e-6, dtype=torch.bfloat16,
                                         device="cpu")
    params = {"scale": scale} if rms else {"scale": scale, "bias": bias}
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    for p in pm.parameters():
        p.requires_grad_(True)
    pm(x).backward(g)
    jm = (jax_layers.RMSNorm(eps=1e-6) if rms
          else jax_layers.LayerNorm(eps=1e-6))
    _, pull = jax.vjp(lambda p: jm.apply(
        {"params": p}, jnp.asarray(_bf16_np(x), jnp.bfloat16)), params)
    want = pull(jnp.asarray(_bf16_np(g), jnp.bfloat16))[0]
    for name, p in pm.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _, rel = _share_and_rel(p.grad.numpy(), np.asarray(want[name]))
        assert rel <= 1e-3, (name, rel)
