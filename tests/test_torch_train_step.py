"""The port's train step and optimizer against the JAX package's, on
shared weights.

The tiny config in float32 on the CPU, LoRA rank 2 on CLIP and the LLM, one
seeded parameter tree handed to both (`from_jax_params`), dropout 0, each
group at its own learning rate (so a parameter in the wrong group shows),
warmup 3 of 100 steps, clipping at 1.0.

- Four train steps with grad_accum_steps=2 (two updates, each over the
  mean of two mini-batches' gradients): JAX's jit'd step
  (parallel/train_step.py on a one-device mesh, optax multi_transform /
  MultiSteps) against `make_train_step` with its fp32 masters. Loss,
  gradient norm and token count agree within TOL relative to (1 + |JAX|)
  every step; every frozen leaf is bit-unchanged, every trainable one
  moved and its working weight equals its master; each update's learning
  rate equals optax's schedule at its count.
- The gradient of every trainable leaf at the first step, against
  jax.value_and_grad of the same loss with the frozen leaves under
  stop_gradient: within GRAD_TOL of the leaf's largest gradient plus
  1e-7 (measured at most 1.6e-5 of it; the k_proj biases, whose gradient
  is analytically zero, sit at ~1e-9 under the floor), so a leaf whose
  gradient is lost (a cut graph) fails.
- The optimizer alone on identical seeded gradients (some groups over the
  clipping norm, some under), three updates, grad_accum_steps 1 and 2:
  every trainable leaf within LEAF_TOL relative to (1 + |JAX|) of optax's
  after each update, the frozen ones bit-unchanged. (After whole train
  steps the leaves are not compared element by element: Adam moves a
  parameter by ~lr·sign(g) whatever |g| is above its eps of 1e-8, so an
  element whose gradient is float32 noise, such as the k_proj biases'
  analytically zero gradient, takes a random ±lr step in either stack.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvv_tpu import config as JC
from lvv_tpu.models import VQABatch as JaxBatch
from lvv_tpu.parallel import create_state as jax_create_state
from lvv_tpu.parallel import make_mesh
from lvv_tpu.parallel import make_train_step as jax_make_train_step
from lvv_tpu.train import optim as jax_optim
from lvv_tpu_torch import VQAModel, from_jax_params, tiny_config
from lvv_tpu_torch.models.vqa import VQABatch
from lvv_tpu_torch.train import (count_by_group, create_state, group_labels,
                                 make_optimizer, make_schedule,
                                 make_train_step)
from torch_parity_util import close, jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

TOL = 1e-4
GRAD_TOL = 1e-4
LEAF_TOL = 1e-6
LRS = {"lr_vat_lidar": 1e-3, "lr_vat_vision": 2e-3, "lr_adapter": 3e-3,
       "lr_llm_lora": 4e-3, "lr_clip_lora": 5e-3}
TOTAL = 100


def _port_override(cfg, path, value):
    from lvv_tpu_torch import config as PC
    return PC.override(cfg, path, value)


def _batches(cfg, n: int):
    """n seeded batches of 2: prompt ++ answer, ragged lengths, labels on
    the answer only."""
    rng = np.random.default_rng(5)
    m, b, t = cfg.model, 2, 25
    s = m.sam.img_size
    out = []
    for _ in range(n):
        ids = rng.integers(0, 500, (b, t)).astype(np.int32)
        lens = np.array([22, 17], np.int32)
        labels = np.full((b, t), -100, np.int32)
        for i, ln in enumerate(lens):
            labels[i, 9:ln] = ids[i, 9:ln]
        out.append(dict(
            bev=rng.standard_normal((b, m.bev_channels, *m.bev_hw)
                                    ).astype(np.float32),
            images=rng.uniform(-1, 1, (b, 6, 3, s, s)).astype(np.float32),
            view_valid=np.array([[True] * 6, [True] * 5 + [False]]),
            text_ids=ids, text_len=lens, labels=labels,
            use_vision=np.asarray(True), use_lidar=np.asarray(True)))
    return out


def _run_jax(params, batches, accum: int):
    cfg = JC.tiny_config()
    for k, v in LRS.items():
        cfg = JC.override(cfg, f"train.optim.{k}", v)
    cfg = JC.override(cfg, "train.optim.grad_accum_steps", accum)
    model, _ = jax_model_and_params(lora_rank=2)
    tx, _ = jax_optim.make_optimizer(cfg.train.optim, params, TOTAL)
    mesh = make_mesh(JC.MeshConfig(data=1, model=1),
                     devices=jax.devices()[:1])
    state = jax_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                             jax.random.PRNGKey(0))
    step = jax_make_train_step(model, tx, mesh, donate=False)
    metrics = []
    for b in batches:
        state, m = step(state, JaxBatch(**{k: jnp.asarray(v)
                                           for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree_util.tree_map(np.asarray, state.params)
    return metrics, final


def _run_port(params, batches, accum: int):
    cfg = tiny_config()
    for k, v in LRS.items():
        cfg = _port_override(cfg, f"train.optim.{k}", v)
    cfg = _port_override(cfg, "train.optim.grad_accum_steps", accum)
    model = VQAModel(cfg.model, dtype=torch.float32, device="cpu",
                     llm_lora_rank=2, llm_lora_alpha=4.0, clip_lora_rank=2,
                     clip_lora_alpha=4.0)
    model.load_state_dict(from_jax_params(params, cfg.model, device="cpu"))
    tx, labels = make_optimizer(cfg.train.optim, model, TOTAL)
    state = create_state(model, tx, torch.Generator().manual_seed(0))
    step = make_train_step(model, tx)
    metrics, lrs = [], []
    for b in batches:
        lrs.append(tx.learning_rates(state.opt_state))
        state, m = step(state, VQABatch(**{k: torch.as_tensor(v)
                                           for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model, state, labels, lrs


@pytest.fixture(scope="module")
def shared():
    _, params = jax_model_and_params(lora_rank=2)
    return params, _batches(tiny_config(), 4)


@pytest.fixture(scope="module")
def runs(shared):
    params, batches = shared
    return _run_jax(params, batches, 2), _run_port(params, batches, 2)


def test_train_steps_match_jax(shared, runs):
    params, _ = shared
    (j_metrics, j_final), (p_metrics, model, state, labels, lrs) = runs
    assert len(p_metrics) == 4
    for jm, pm in zip(j_metrics, p_metrics):
        for key in ("loss", "grad_norm", "tokens"):
            close(pm[key], jm[key], TOL)
    want = from_jax_params(j_final, tiny_config().model, device="cpu")
    start = {k: v.float() for k, v in from_jax_params(
        params, tiny_config().model, device="cpu").items()}
    got = dict(model.named_parameters())
    for name, group in labels.items():
        if group == "frozen":
            assert torch.equal(got[name].detach(), start[name]), name
            assert torch.equal(want[name], start[name]), name
            continue
        assert torch.equal(got[name].detach(), state.masters[name]), name
        assert not torch.equal(state.masters[name], start[name]), name
        assert not torch.equal(want[name], start[name]), name
    # each update's learning rate is optax's at that update's count
    assert state.opt_state["groups"]["adapter"]["count"] == 2
    cfg = JC.tiny_config()
    for i, step_lrs in enumerate(lrs[::2]):
        for group, lr in step_lrs.items():
            sched = jax_optim.make_schedule(LRS[f"lr_{group}"], TOTAL,
                                            cfg.train.optim.warmup_ratio)
            close(lr, float(sched(i)), 1e-6)


def test_gradients_match_jax(shared):
    """Every trainable leaf's gradient of the first batch's loss."""
    params, batches = shared
    jmodel, _ = jax_model_and_params(lora_rank=2)
    frozen = jax.tree_util.tree_map(lambda g: g == "frozen",
                                    jax_optim.group_labels(params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in batches[0].items()})

    def loss_fn(p):
        merged = jax.tree_util.tree_map(
            lambda t, f: jax.lax.stop_gradient(t) if f else t, p, frozen)
        return jmodel.apply({"params": merged}, batch)[0]
    _, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads),
                           tiny_config().model, device="cpu")

    cfg = tiny_config()
    model = VQAModel(cfg.model, dtype=torch.float32, device="cpu",
                     llm_lora_rank=2, llm_lora_alpha=4.0, clip_lora_rank=2,
                     clip_lora_alpha=4.0)
    model.load_state_dict(from_jax_params(params, cfg.model, device="cpu"))
    tx, labels = make_optimizer(cfg.train.optim, model, TOTAL)
    create_state(model, tx, torch.Generator())
    loss, _, _ = model(VQABatch(**{k: torch.as_tensor(v)
                                   for k, v in batches[0].items()}))
    loss.backward()
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None, name
            continue
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max() + 1e-7, name


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(shared, accum):
    """Identical gradients into optax's transform and the port's
    MultiGroupAdamW: three updates, each after `accum` mini-steps."""
    params, _ = shared
    cfg = JC.tiny_config()
    pcfg = tiny_config()
    for k, v in LRS.items():
        cfg = JC.override(cfg, f"train.optim.{k}", v)
        pcfg = _port_override(pcfg, f"train.optim.{k}", v)
    cfg = JC.override(cfg, "train.optim.grad_accum_steps", accum)
    pcfg = _port_override(pcfg, "train.optim.grad_accum_steps", accum)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                     params)
    tx, _ = jax_optim.make_optimizer(cfg.train.optim, jparams, TOTAL)
    opt_state = tx.init(jparams)
    start = {k: v.float() for k, v in from_jax_params(
        params, pcfg.model, device="cpu").items()}
    ptx, labels = make_optimizer(pcfg.train.optim, start, TOTAL)
    masters = {n: t.clone() for n, t in start.items()
               if labels[n] != "frozen"}
    pstate = ptx.init(masters)

    @jax.jit
    def update(g, st, p):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st
    rng = np.random.default_rng(7)
    for _ in range(3):
        for _ in range(accum):
            grads = jax.tree_util.tree_map(
                lambda a: 3e-3 * rng.standard_normal(a.shape).astype(
                    np.float32), params)
            jparams, opt_state = update(
                jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                jparams)
            pgrads = from_jax_params(grads, pcfg.model, device="cpu")
            ptx.update({n: pgrads[n] for n in masters}, pstate, masters)
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                               pcfg.model, device="cpu")
        for name, group in labels.items():
            if group == "frozen":
                assert torch.equal(want[name], start[name]), name
            else:
                close(masters[name].numpy(), want[name].numpy(), LEAF_TOL)


@pytest.mark.parametrize("total,ratio", [(100, 0.03), (40, 0.0), (7, 0.5)])
def test_schedule_matches_optax(total, ratio):
    ours = make_schedule(3e-4, total, ratio)
    ref = jax_optim.make_schedule(3e-4, total, ratio)
    for count in range(total + 5):
        close(ours(count), float(ref(count)), 1e-6)


def test_group_labels_and_counts_match_jax(shared):
    params, _ = shared
    flat = jax.tree_util.tree_flatten_with_path(
        jax_optim.group_labels(params))[0]
    want = {".".join(str(k.key) for k in path): lbl for path, lbl in flat}
    model = VQAModel(tiny_config().model, dtype=torch.float32, device="cpu",
                     llm_lora_rank=2, clip_lora_rank=2)
    assert group_labels(model) == want
    assert count_by_group(model) == jax_optim.count_by_group(params)
    assert set(want.values()) == set(jax_optim.GROUPS)
