"""The port's serving runtime against the JAX package and against the port's
own greedy_generate.

One seeded JAX parameter tree of the tiny VQAModel (LoRA rank 2, every leaf
non-zero) is written as a `params.npz` checkpoint and served by the port on
the CPU in float32. Exact checks throughout: text batches bit-equal to the
JAX collator's, state_dicts bit-equal after a round trip, answer text equal
to the JAX InferenceEngine's, and every engine's tokens equal to
greedy_generate on the same padded batch (the same shapes, so the same
arithmetic). Where the batching depends on thread timing (concurrent
submitters, multi_groups, staggered admissions), tokens are held to a
batch-1 greedy_generate, as the JAX package's own serving tests do: the
port's CPU logits move by ~3e-7 between batch sizes, far below any
argmax margin of these inputs.
"""
import json
import os
import pathlib
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from lvv_tpu import config as J
from lvv_tpu.data import ByteTokenizer as JaxByteTokenizer
from lvv_tpu.data.collate import Collator as JaxCollator
from lvv_tpu.data.collate import pack_text as jax_pack_text
from lvv_tpu.inference import InferenceEngine as JaxInferenceEngine
from lvv_tpu_torch import (greedy_generate, prepare_serving_params_fused,
                           sample_generate)
from lvv_tpu_torch.data import ByteTokenizer, Collator, pack_text
from lvv_tpu_torch.inference import (ContinuousServingEngine,
                                     InferenceEngine, ModelLoader,
                                     ServingEngine, save_checkpoint,
                                     save_params_npz)
from lvv_tpu_torch.inference.server import _buckets_up_to
from lvv_tpu_torch.tools.serve_vqa import make_handler
from torch_parity_util import jax_model_and_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fast

REPO = pathlib.Path(__file__).resolve().parents[1]
NEW = 6
QUESTIONS = ["what is ahead of the ego car?", "how many pedestrians?",
             "is the road wet?", "any parked trucks?"]


def _config():
    """The JAX tiny config in float32 with LoRA rank 2 (alpha 4) on both
    towers, the ranks of the shared tree."""
    cfg = J.override(J.tiny_config(), "model.dtype", "float32")
    for path, v in (("model.llm_lora.r", 2), ("model.llm_lora.alpha", 4),
                    ("model.clip_lora.r", 2), ("model.clip_lora.alpha", 4)):
        cfg = J.override(cfg, path, v)
    return cfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX model, its params, the port model loaded from params.npz, the
    loader, the checkpoint dir)."""
    jm, params = jax_model_and_params(lora_rank=2)
    d = save_params_npz(params, _config(), tmp_path_factory.mktemp("npz"))
    loader = ModelLoader(d)
    model, _ = loader.load_all("cpu")
    return jm, params, model, loader, d


@pytest.fixture(scope="module")
def reqs(served):
    """Four requests: a BEV, six float views, one valid mask each, and a
    prompt (the ByteTokenizer's packed question, 129 wide)."""
    model = served[2]
    cfg = model.cfg
    rng = np.random.default_rng(5)
    tok = ByteTokenizer(cfg.llm.special_tokens)
    s = cfg.sam.img_size
    out = []
    for q in QUESTIONS:
        ids, _, n, _ = pack_text(tok, q, None, 128, 0)
        out.append(dict(
            bev=rng.standard_normal((cfg.bev_channels, *cfg.bev_hw)
                                    ).astype(np.float32),
            images=rng.uniform(-1, 1, (6, 3, s, s)).astype(np.float32),
            view_valid=np.array([True, True, False, True, True, True]),
            text_ids=ids, text_len=n))
    return out


def _batch(rows):
    return [torch.as_tensor(np.stack([r[k] for r in rows]))
            for k in ("bev", "images", "view_valid", "text_ids")] + [
        torch.as_tensor([r["text_len"] for r in rows], dtype=torch.int32)]


def _greedy(model, rows, n_real=None, **kw):
    """greedy_generate on `rows` -> each real row's tokens up to its
    length."""
    toks, lens = greedy_generate(model, *_batch(rows), max_new_tokens=NEW,
                                 eos_id=model_eos(model), **kw)
    return [toks[i, :lens[i]].tolist() for i in range(n_real or len(rows))]


def model_eos(model):
    return ByteTokenizer(model.cfg.llm.special_tokens).eos_id


def _padded(rows, bucket):
    return rows + [rows[0]] * (bucket - len(rows))


def _submit(eng, r, **kw):
    return eng.submit(r["bev"], r["images"], r["view_valid"], r["text_ids"],
                      r["text_len"], **kw)


# ------------------------------------------------------------ text, batches

@pytest.mark.parametrize("answer", [None, "three cars and a bus"])
def test_pack_text_and_collator_match_jax(served, answer):
    model = served[2]
    cfg = model.cfg
    tok = ByteTokenizer(cfg.llm.special_tokens)
    jtok = JaxByteTokenizer(cfg.llm.special_tokens)
    for q in QUESTIONS:
        got, want = (pack_text(tok, q, answer, 48, 8),
                     jax_pack_text(jtok, q, answer, 48, 8))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    samples = [{"question": q, "answer": answer,
                "bev": rng.standard_normal((cfg.bev_channels + 2, 20, 30)
                                           ).astype(np.float32),
                "cam_paths": [None] * 6} for q in QUESTIONS[:3]]
    shape = (cfg.bev_channels,) + tuple(cfg.bev_hw)
    mine = Collator(tok, 48, 8, cfg.sam.img_size, shape)(samples, True,
                                                         False)
    theirs = JaxCollator(jtok, 48, 8, cfg.sam.img_size, shape)(samples, True,
                                                               False)
    for name in mine._fields:
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------ checkpoint, loader

def test_model_pt_round_trip_is_bit_equal(served, tmp_path):
    model, loader = served[2], served[3]
    d = save_checkpoint(model, loader.cfg, tmp_path / "ckpt")
    again = ModelLoader(d)
    assert J.to_dict(_config()) == json.loads(
        (d / "config.json").read_text())
    copy, state = again.load_all("cpu")
    assert copy.llm.layer_0.attn.q_proj.lora_rank == 2
    want = model.state_dict()
    assert state.keys() == want.keys()
    for k, v in copy.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_loader_takes_the_newest_loadable(served, tmp_path):
    """A root of step directories: the newest holds a corrupt model.pt, so
    the loader falls back to the one before; with nothing loadable it
    raises."""
    model, loader = served[2], served[3]
    save_checkpoint(model, loader.cfg, tmp_path / "step_1")
    bad = tmp_path / "step_2"
    bad.mkdir()
    (bad / "model.pt").write_bytes(b"not a checkpoint")
    root = ModelLoader(tmp_path)
    assert root.checkpoints()[0] == bad / "model.pt"
    copy, _ = root.load_all("cpu")
    assert torch.equal(copy.llm.final_ln.scale, model.llm.final_ln.scale)
    (tmp_path / "step_1" / "model.pt").unlink()
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        root.load_all("cpu")


def test_loader_raises_on_a_checkpoint_that_does_not_fit(served, tmp_path):
    """A newest checkpoint that reads but does not fit the config's model
    (a tensor missing) raises; the loader does not fall back past it."""
    model, loader = served[2], served[3]
    save_checkpoint(model, loader.cfg, tmp_path / "step_1")
    state = model.state_dict()
    state.pop("llm.final_ln.scale")
    (tmp_path / "step_2").mkdir()
    torch.save(state, tmp_path / "step_2" / "model.pt")
    with pytest.raises(RuntimeError, match="llm.final_ln.scale"):
        ModelLoader(tmp_path).load_all("cpu")


def test_params_npz_answers_equal_jax_engine(served, reqs):
    """A JAX tree written as params.npz and served by the port's
    InferenceEngine gives the JAX InferenceEngine's answer text."""
    jm, params, model, loader, _ = served
    bevs = [r["bev"] for r in reqs[:2]]
    got = InferenceEngine(model, loader.tokenizer,
                          max_new_tokens=NEW).generate_batch(QUESTIONS[:2],
                                                             bevs)
    jtok = JaxByteTokenizer(model.cfg.llm.special_tokens)
    want = JaxInferenceEngine(jm, params, jtok,
                              max_new_tokens=NEW).generate_batch(
        QUESTIONS[:2], bevs)
    assert got == want
    assert InferenceEngine(model, loader.tokenizer,
                           max_new_tokens=NEW).generate(
        QUESTIONS[1], bevs[1]) == want[1]


def test_engine_modality_toggles_reach_the_prefix(served, reqs):
    """--no-vision / --no-lidar zero their part of the prefix (the JAX
    engine drops these toggles before generation; the port applies them)."""
    model, loader = served[2], served[3]
    eng = InferenceEngine(model, loader.tokenizer, max_new_tokens=NEW)
    batch = eng.collator([{"question": QUESTIONS[0], "answer": None,
                           "bev": reqs[0]["bev"],
                           "cam_paths": [None] * 6}])
    toks, lens = greedy_generate(
        model, batch.bev, batch.images, batch.view_valid, batch.text_ids,
        batch.text_len, max_new_tokens=NEW, eos_id=loader.tokenizer.eos_id,
        use_lidar=False)
    want = loader.tokenizer.decode(toks[0, :lens[0]].tolist())
    assert eng.generate(QUESTIONS[0], reqs[0]["bev"],
                        use_lidar=False) == want


# -------------------------------------------------------- ServingEngine

def test_bucket_schedule():
    assert _buckets_up_to(8) == [1, 2, 4, 8]
    assert _buckets_up_to(6) == [1, 2, 4, 6]
    assert _buckets_up_to(1) == [1]


def test_partial_bucket_and_request_cap(served, reqs):
    """Three requests inside max_wait_ms make one bucket of 4 (row 0
    cloned); answers equal greedy_generate on that padded batch; a
    per-request cap cuts its answer to a prefix."""
    model = served[2]
    with ServingEngine(model, eos_id=model_eos(model), max_batch=4,
                       max_wait_ms=2000, max_new_tokens=NEW) as eng:
        futs = [_submit(eng, r) for r in reqs[:2]]
        futs.append(_submit(eng, reqs[2], max_new_tokens=2))
        got = [f.result(timeout=120)[0] for f in futs]
        st = eng.stats()
    want = _greedy(model, _padded(reqs[:3], 4), 3)
    assert got[:2] == want[:2] and got[2] == want[2][:2]
    assert st["batch_sizes"] == [3] and st["pad_rows"] == 1
    assert st["requests"] == 3 and st["p50_latency_s"] > 0


def test_pipelined_dispatch_keeps_every_answer(served, reqs):
    """pipeline_depth 2 (the next bucket issued before the last one's
    tokens are fetched) gives each request of a queue of buckets of one
    its batch-1 answer; the default depth is 1, and 0 is refused."""
    model = served[2]
    alone = [_greedy(model, [r])[0] for r in reqs]
    with ServingEngine(model, eos_id=model_eos(model), max_batch=1,
                       max_wait_ms=1, max_new_tokens=NEW,
                       pipeline_depth=2) as eng:
        futs = [_submit(eng, r) for r in reqs]
        got = [f.result(timeout=120)[0] for f in futs]
        st = eng.stats()
    assert got == alone and st["batch_sizes"] == [1] * len(reqs)
    with ServingEngine(model, eos_id=model_eos(model)) as eng:
        assert eng.pipeline_depth == 1
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServingEngine(model, eos_id=model_eos(model), pipeline_depth=0)


def test_concurrent_submitters(served, reqs):
    """Three threads submit four requests each; every answer is its
    request's batch-1 answer."""
    model = served[2]
    alone = [_greedy(model, [r])[0] for r in reqs]
    results = {}
    with ServingEngine(model, eos_id=model_eos(model), max_batch=4,
                       max_wait_ms=5, max_new_tokens=NEW) as eng:
        def client(c):
            futs = [(i, _submit(eng, reqs[i])) for i in range(4)]
            results[c] = [(i, f.result(timeout=120)[0]) for i, f in futs]
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
    assert st["requests"] == 12 and sum(st["batch_sizes"]) == 12
    for c in range(3):
        assert [toks for _, toks in results[c]] == alone


def test_u8_frames_and_f16_bev_equal_their_float_forms(served, reqs):
    """uint8 frames, preprocessed on the device by the engine, answer as the
    same frames preprocessed beforehand; a float16 BEV as its float32
    values."""
    from lvv_tpu_torch import preprocess_views
    model = served[2]
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, (6, 40, 56, 3), dtype=np.uint8)
    f32 = preprocess_views(torch.as_tensor(u8), model.cfg.sam.img_size)
    bev16 = reqs[0]["bev"].astype(np.float16)
    r = reqs[0]
    with ServingEngine(model, eos_id=model_eos(model), max_batch=2,
                       max_wait_ms=1, max_new_tokens=NEW) as eng:
        a = eng.submit(bev16, u8, r["view_valid"], r["text_ids"],
                       r["text_len"]).result(timeout=120)[0]
        b = eng.submit(bev16.astype(np.float32), f32, r["view_valid"],
                       r["text_ids"], r["text_len"]).result(timeout=120)[0]
    assert a == b


def test_prefix_cache_hits_and_eviction(served, reqs):
    """A frame encoded once answers a second question from the cache with
    no sensors; a cache of one frame evicts it for the next frame, after
    which a sensor-less request about it fails with KeyError."""
    model = served[2]
    r0, r1 = reqs[0], reqs[1]
    with ServingEngine(model, eos_id=model_eos(model), max_batch=2,
                       max_wait_ms=1, max_new_tokens=NEW,
                       prefix_cache_size=1) as eng:
        first = _submit(eng, r0, frame_id="f0").result(timeout=120)[0]
        hit = eng.submit(None, None, None, r1["text_ids"], r1["text_len"],
                         frame_id="f0").result(timeout=120)[0]
        _submit(eng, r1, frame_id="f1").result(timeout=120)
        miss = eng.submit(None, None, None, r1["text_ids"], r1["text_len"],
                          frame_id="f0")
        with pytest.raises(KeyError, match="f0"):
            miss.result(timeout=120)
        st = eng.stats()
    assert first == _greedy(model, [r0])[0]
    # r0's sensors with r1's question
    assert hit == _greedy(model, [dict(r0, text_ids=r1["text_ids"],
                                       text_len=r1["text_len"])])[0]
    assert st["prefix_hits"] == 1 and st["prefix_misses"] == 3


def test_multi_groups(served, reqs):
    """With the queue two full buckets deep, one greedy_generate_multi
    dispatch serves both; answers equal batch-1 answers."""
    model = served[2]
    work = (reqs * 3)[:10]
    alone = [_greedy(model, [r])[0] for r in reqs]
    with ServingEngine(model, eos_id=model_eos(model), max_batch=2,
                       max_wait_ms=400, max_new_tokens=NEW,
                       multi_groups=2) as eng:
        futs = [_submit(eng, r) for r in work]
        got = [f.result(timeout=120)[0] for f in futs]
        st = eng.stats()
    assert st["requests"] == 10
    assert 4 in st["batch_sizes"], st["batch_sizes"]
    assert got == [alone[i % 4] for i in range(10)]


def test_sampling_follows_its_seed(served, reqs):
    """Sampling draws from a torch.Generator seeded by sampling["seed"]:
    the engine's tokens equal sample_generate's with that generator on the
    same padded batch."""
    model = served[2]
    cfg = dict(temperature=0.9, top_k=20, top_p=0.9)
    with ServingEngine(model, eos_id=model_eos(model), max_batch=2,
                       max_wait_ms=2000, max_new_tokens=NEW,
                       sampling=dict(cfg, seed=7)) as eng:
        got = [f.result(timeout=120)[0]
               for f in [_submit(eng, r) for r in reqs[:2]]]
    toks, lens = sample_generate(
        model, torch.Generator().manual_seed(7), *_batch(reqs[:2]),
        max_new_tokens=NEW, eos_id=model_eos(model), **cfg)
    assert got == [toks[i, :lens[i]].tolist() for i in range(2)]
    with pytest.raises(ValueError, match="sampling"):
        ServingEngine(model, eos_id=1, sampling=cfg, params_decode={})


def test_closed_engine_and_refusals(served, reqs):
    model = served[2]
    with pytest.raises(NotImplementedError, match="multi-card"):
        ServingEngine(model, eos_id=1, mesh=object())
    with pytest.raises(ValueError, match="eos_id"):
        ServingEngine(model)
    eng = ServingEngine(model, eos_id=1)
    with pytest.raises(ValueError, match="prefix caching"):
        eng.submit(None, None, None, reqs[0]["text_ids"], 3)
    eng.close()
    assert not eng._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        _submit(eng, reqs[0])


# ------------------------------------------------ ContinuousServingEngine

def _continuous(model, **kw):
    return ContinuousServingEngine(model, eos_id=model_eos(model), slots=4,
                                   chunk_steps=2, max_new_tokens=NEW, **kw)


class _HeldQueue(queue.Queue):
    """A request queue that reads as empty until `release` is set: the
    continuous engine's worker, which polls it, then admits everything
    queued before at once, however the threads interleave."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()

    def empty(self):
        return not self.release.is_set() or super().empty()


@pytest.mark.parametrize("packed", [False, True])
def test_continuous_burst_equals_greedy(served, reqs, packed):
    """Three requests admitted together (a bucket of 4) give greedy_generate's
    tokens on that padded batch at the slab's cache length, with the float
    decode and with the packed int8 decode."""
    model = served[2]
    pd = prepare_serving_params_fused(model) if packed else None
    with _continuous(model, params_decode=pd) as eng:
        eng._queue = held = _HeldQueue()
        futs = [_submit(eng, r) for r in reqs[:3]]
        held.release.set()
        got = [f.result(timeout=120)[0] for f in futs]
        st = eng.stats()
        max_cache = eng.max_cache(reqs[0]["text_ids"].shape[0])
    assert got == _greedy(model, _padded(reqs[:3], 4), 3,
                          max_cache=max_cache, params_decode=pd)
    assert st["requests"] == 3 and st["admission_batches"] == 1
    assert st["decode_chunks"] >= NEW // 2 and st["mean_occupancy"] > 0


def test_continuous_staggered_admissions(served, reqs):
    """Requests admitted while others decode are prefilled at a chunk
    boundary and still give their batch-1 answers; a per-request cap and
    the streaming callback see the same tokens."""
    model = served[2]
    alone = [_greedy(model, [r])[0] for r in reqs]
    chunks, streamed = [], threading.Event()

    def stream(toks):
        chunks.append(toks)
        streamed.set()
    with _continuous(model) as eng:
        f0 = _submit(eng, reqs[0], on_tokens=stream)
        while not (streamed.wait(0.01) or f0.done()):
            pass
        futs = [_submit(eng, r) for r in reqs[1:]]   # while f0 decodes
        capped = _submit(eng, reqs[1], max_new_tokens=2)
        first = f0.result(timeout=120)[0]
        got = [f.result(timeout=120)[0] for f in futs]
        st = eng.stats()
    assert [first] + got == alone
    assert capped.result()[0] == alone[1][:2]
    assert [t for c in chunks for t in c] == first
    assert all(len(c) <= 2 for c in chunks)
    assert st["admission_batches"] >= 2


def test_continuous_prompt_width_check(served, reqs):
    """Every request must be as wide as the first (the slab was sized for
    it); the continuous engine has no prefix cache."""
    model = served[2]
    r = reqs[0]
    with _continuous(model) as eng:
        _submit(eng, r).result(timeout=120)
        wide = eng.submit(r["bev"], r["images"], r["view_valid"],
                          np.concatenate([r["text_ids"], [1, 2]]),
                          r["text_len"])
        with pytest.raises(ValueError, match="prompt width"):
            wide.result(timeout=120)
        with pytest.raises(ValueError, match="prefix cache"):
            eng.submit(None, None, None, r["text_ids"], 3)
    with pytest.raises(RuntimeError, match="closed"):
        _submit(eng, r)


# ------------------------------------------------------------ HTTP and CLI

def test_http_round_trip(served, reqs, tmp_path):
    """/healthz, /v1/stats, POST /v1/vqa (the engine's own answer), 400 on
    a missing BEV, 404 elsewhere, over loopback."""
    model, loader = served[2], served[3]
    np.save(tmp_path / "frame.npy", reqs[0]["bev"])
    with ServingEngine(model, loader.tokenizer, max_batch=2, max_wait_ms=1,
                       max_new_tokens=NEW) as eng:
        srv = ThreadingHTTPServer(("127.0.0.1", 0),
                                  make_handler(eng, tmp_path))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{srv.server_port}"

        def call(path, body=None):
            data = None if body is None else json.dumps(body).encode()
            try:
                with urllib.request.urlopen(base + path, data,
                                            timeout=120) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        try:
            assert call("/healthz") == (200, {"ok": True})
            code, ans = call("/v1/vqa", {"question": QUESTIONS[0],
                                         "bev_path": "frame.npy"})
            assert code == 200
            assert ans["answer"] == eng.generate(QUESTIONS[0],
                                                 reqs[0]["bev"])
            code, st = call("/v1/stats")
            assert code == 200 and st["requests"] == 2
            assert call("/v1/vqa", {"question": "q",
                                    "bev_path": "missing.npy"})[0] == 400
            assert call("/nope")[0] == 404
            assert call("/nope", {})[0] == 404
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)


def test_infer_cli_subprocess(served, reqs, tmp_path):
    """`python -m lvv_tpu_torch.tools.infer_vqa --device cpu` over a
    model.pt checkpoint: exit 0, one JSON row a question, the engine's
    answers, and an error row for a missing BEV."""
    model, loader = served[2], served[3]
    ckpt = save_checkpoint(model, loader.cfg, tmp_path / "ckpt")
    np.save(tmp_path / "a.npy", reqs[0]["bev"])
    rows = [{"question": QUESTIONS[0], "bev_path": str(tmp_path / "a.npy")},
            {"question": QUESTIONS[1], "bev_path": str(tmp_path / "no.npy")}]
    (tmp_path / "q.json").write_text(json.dumps(rows))
    out = subprocess.run(
        [sys.executable, "-m", "lvv_tpu_torch.tools.infer_vqa",
         "--checkpoint", str(ckpt), "--questions", str(tmp_path / "q.json"),
         "--max-new-tokens", str(NEW), "--device", "cpu",
         "--out", str(tmp_path / "a.json")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    printed = [json.loads(ln) for ln in out.stdout.splitlines()]
    want = InferenceEngine(model, loader.tokenizer,
                           max_new_tokens=NEW).generate(QUESTIONS[0],
                                                        reqs[0]["bev"])
    assert printed[0] == {"question": QUESTIONS[0], "answer": want}
    assert printed[1]["answer"].startswith("<error:")
    assert json.loads((tmp_path / "a.json").read_text()) == printed
