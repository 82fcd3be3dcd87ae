"""ServingEngine: the dynamic-batching VQA request server (counterpart of
lvv_tpu/inference/server.py).

- callers `submit()` requests from any thread and get a Future;
- a worker thread drains the queue into batches: it waits at most
  `max_wait_ms` after the first request for co-travellers, up to
  `max_batch`;
- a batch is padded up to a bucket size (powers of two up to `max_batch`)
  with clones of its row 0, whose results are dropped, so the model sees a
  few fixed shapes;
- one `greedy_generate` call serves the whole bucket.

Options, as in the JAX package: per-request `max_new_tokens` caps, a prefix
cache (`prefix_cache_size` frames' encoded prefixes, keyed by `frame_id`,
LRU-evicted; a request about a cached frame may carry no sensors),
`multi_groups` (up to that many full buckets in one
`greedy_generate_multi` call when the queue is that deep), and sampling
(`sample_generate` with a torch.Generator seeded from `sampling["seed"]`).
uint8 camera frames are preprocessed on the model's device and float16
BEVs cast there. With `pipeline_depth` > 1 the loop dispatches batch N + 1
before it fetches batch N's tokens, as the JAX package's does. Here the
default is 1: a dispatch is the host issuing every launch of a bucket, so
a bucket's answers would wait for the next bucket's issue (request
latency up, frames/s the same).

Multi-card serving (`mesh=`) is not ported.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.vqa import (encode_prefix_fn, generate_from_prefix,
                          greedy_generate, greedy_generate_multi,
                          sample_generate)
from ..ops.image import preprocess_views


def _buckets_up_to(max_batch: int) -> List[int]:
    """Bucket sizes: the powers of two under max_batch, then max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _text_request_arrays(model_cfg, tokenizer, question: str, cam_paths,
                         max_prompt: int = 128):
    """question / camera paths -> (images [6, 3, S, S] f32, valid [6], ids,
    length): the text-level submit path of both serving engines. Without
    camera paths every view is zero and invalid."""
    from ..data.collate import load_views_u8, pack_text
    s = model_cfg.sam.img_size
    ids, _, length, _ = pack_text(tokenizer, question, None,
                                  max_prompt=max_prompt, max_answer=0)
    images = np.zeros((6, 3, s, s), np.float32)
    valid = np.zeros((6,), bool)
    if cam_paths is not None and any(p for p in cam_paths):
        u8, valid = load_views_u8(cam_paths)
        images = preprocess_views(torch.as_tensor(u8), s).numpy()
    return images, valid, ids, length


def _resolve(future: Future, result=None, exc=None) -> None:
    """set_result / set_exception that survives a caller having cancelled
    the future (InvalidStateError would otherwise kill the worker)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:   # the future was cancelled: drop the result
        pass


def _preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, V, H, W, 3] uint8 frames -> [B, V, 3, size, size] float32 in
    [-1, 1] on their device."""
    return preprocess_views(images.flatten(0, 1), size).unflatten(
        0, images.shape[:2])


@dataclass
class _Request:
    bev: Optional[torch.Tensor]         # [C, H, W] f32 / f16, or None
    images: Optional[torch.Tensor]      # [6, 3, S, S] f32 or [6, H, W, 3]
                                        # u8, or None (hit-only)
    view_valid: Optional[torch.Tensor]  # [6]
    text_ids: np.ndarray                # [T]
    text_len: int
    max_new_tokens: Optional[int] = None   # per-request cap (<= engine's)
    frame_id: Optional[str] = None         # prefix-cache key
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    on_tokens: Optional[object] = None     # streaming callback (continuous)


class ServingEngine:
    """Dynamic-batching server over a port VQAModel.

    Parameters
    ----------
    model : the VQAModel (its weights inside; it runs on its device).
    tokenizer : optional; needed for the text-level API and the default
        `eos_id`.
    max_batch : the largest bucket.
    max_wait_ms : how long the worker holds a batch's first request waiting
        for more before it launches a partial bucket.
    params_decode : optional decode tree (`prepare_serving_params` or
        `prepare_serving_params_fused`).
    mesh : not ported; anything but None raises NotImplementedError.
    pipeline_depth : batches in flight; above 1, the next bucket is issued
        before the last one's tokens are fetched.
    """

    def __init__(self, model, tokenizer=None, *, max_batch: int = 8,
                 max_wait_ms: float = 4.0, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, params_decode=None, mesh=None,
                 pipeline_depth: int = 1, sampling: Optional[dict] = None,
                 prefix_cache_size: int = 0, multi_groups: int = 1):
        if mesh is not None:
            raise NotImplementedError("multi-card serving is not ported: "
                                      "the engine serves one device")
        if eos_id is None:
            if tokenizer is None:
                raise ValueError("pass eos_id when no tokenizer is given")
            eos_id = tokenizer.eos_id
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.model = model
        self.device = model.device
        self.params_decode = params_decode
        self.tokenizer = tokenizer
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.pipeline_depth = int(pipeline_depth)
        # {"temperature", "top_k", "top_p", "seed"} -> sample_generate;
        # None -> greedy
        self.sampling = dict(sampling) if sampling else None
        self._generator = None
        if self.sampling is not None:
            if params_decode is not None:
                raise ValueError("sampling mode does not support the int8 "
                                 "params_decode tree (greedy-only lever)")
            self._generator = torch.Generator(
                device=self.device).manual_seed(
                int(self.sampling.pop("seed", 0)))
        self.prefix_cache_size = int(prefix_cache_size)
        if self.prefix_cache_size and self.sampling is not None:
            raise ValueError("prefix caching supports the greedy path only")
        self._prefix_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self.multi_groups = int(multi_groups)
        self.buckets = _buckets_up_to(self.max_batch)

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "pad_rows": 0,
                       "batch_sizes": [], "latency_s": [],
                       "prefix_hits": 0, "prefix_misses": 0}
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="lvv-serving", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public

    def submit(self, bev, images, view_valid, text_ids, text_len: int,
               max_new_tokens: Optional[int] = None,
               frame_id: Optional[str] = None) -> Future:
        """Enqueue one request; resolves to (token ids, text | None).

        Arrays are single-sample (no batch axis) and every request shares
        the shapes of the first. `max_new_tokens` caps this request's answer
        (the bucket still decodes the engine's count). Ingest formats:
        `images` float32 [6, 3, S, S] (preprocessed) or uint8 [6, H, W, 3]
        (raw frames, preprocessed on the device); `bev` float32 or float16
        (cast on the device). With prefix caching, a request about a cached
        `frame_id` may pass `bev=None, images=None`; a cache miss without
        sensors fails with KeyError. The sensors are copied to the device
        here, in the submitter's thread.
        """
        if self._closed.is_set():
            raise RuntimeError("ServingEngine is closed")
        if images is None or bev is None:
            if not (self.prefix_cache_size and frame_id is not None):
                raise ValueError(
                    "bev/images may be omitted only with prefix caching "
                    "enabled and a frame_id (cache-hit-only request)")
            bev = images = view_valid = None

        def put(x, dtype=None):
            return (None if x is None else
                    torch.as_tensor(x, dtype=dtype, device=self.device))
        req = _Request(put(bev), put(images), put(view_valid, torch.bool),
                       np.asarray(text_ids, np.int32), int(text_len),
                       max_new_tokens=max_new_tokens,
                       frame_id=frame_id if self.prefix_cache_size else None)
        self._queue.put(req)
        return req.future

    def generate(self, question: str, bev, cam_paths=None,
                 timeout: Optional[float] = None,
                 frame_id: Optional[str] = None) -> str:
        """Blocking text-level convenience (requires a tokenizer)."""
        fut = self.submit_text(question, bev, cam_paths, frame_id=frame_id)
        return fut.result(timeout=timeout)[1]

    def submit_text(self, question: str, bev, cam_paths=None,
                    frame_id: Optional[str] = None) -> Future:
        if self.tokenizer is None:
            raise ValueError("submit_text requires a tokenizer")
        images, valid, ids, length = _text_request_arrays(
            self.model.cfg, self.tokenizer, question, cam_paths)
        return self.submit(bev, images, valid, ids, length,
                           frame_id=frame_id)

    def stats(self) -> dict:
        with self._stats_lock:
            st = dict(self._stats)
            st["batch_sizes"] = list(st["batch_sizes"])
            lat = sorted(st.pop("latency_s"))
            st["p50_latency_s"] = lat[len(lat) // 2] if lat else None
            return st

    def close(self, timeout: float = 30.0) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._worker.join(timeout=timeout)
        while True:    # fail anything still queued
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _resolve(req.future, exc=RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _take_batch(self, first_wait: float = 0.05) -> List[_Request]:
        """Block for the first request, then hold the door max_wait_ms."""
        try:
            first = self._queue.get(timeout=first_wait)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _serve_loop(self) -> None:
        """Dispatch batch N + 1 before fetching batch N's tokens, at most
        `pipeline_depth` batches in flight. Inference mode is per thread,
        so the worker enters it itself."""
        with torch.inference_mode():
            self._serve()

    def _serve(self) -> None:
        inflight: List[tuple] = []
        while True:
            done = self._closed.is_set() and self._queue.empty()
            if done and not inflight:
                return
            if inflight and (len(inflight) >= self.pipeline_depth or done):
                self._complete(*inflight.pop(0))
                continue
            batch = self._take_batch(0.005 if inflight else 0.05)
            if not batch:
                if inflight:
                    self._complete(*inflight.pop(0))
                continue
            groups = [batch]
            if (self.multi_groups > 1 and self.sampling is None
                    and not self.prefix_cache_size
                    and len(batch) == self.max_batch):
                # one consumer thread: qsize-then-get cannot race
                while (len(groups) < self.multi_groups
                       and self._queue.qsize() >= self.max_batch):
                    groups.append([self._queue.get_nowait()
                                   for _ in range(self.max_batch)])
            flat = [r for g in groups for r in g]
            try:
                if len(groups) == 1:
                    inflight.append((batch, self._dispatch(batch)))
                else:
                    inflight.append((flat, self._dispatch_multi(groups)))
            except Exception as e:   # this batch fails; the worker goes on
                for req in flat:
                    if not req.future.done():
                        _resolve(req.future, exc=e)

    def _sensor_stacks(self, rows: Sequence[_Request]):
        """rows -> (bev f32, images f32, valid) on the device, uint8 frames
        preprocessed there. Every row must carry sensors."""
        bev = torch.stack([r.bev for r in rows]).float()
        images = torch.stack([r.images for r in rows])
        if images.dtype == torch.uint8:
            images = _preprocess(images, self.model.cfg.sam.img_size)
        return bev, images, torch.stack([r.view_valid for r in rows])

    def _text(self, rows: Sequence[_Request]):
        ids = torch.as_tensor(np.stack([r.text_ids for r in rows]),
                              device=self.device)
        lens = torch.as_tensor([r.text_len for r in rows], dtype=torch.int32,
                               device=self.device)
        return ids, lens

    def _dispatch(self, batch: List[_Request]):
        """Issue one bucket; returns its device tensors without waiting."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        rows = batch + [batch[0]] * (bucket - n)   # pad rows: clone row 0
        ids, lens = self._text(rows)
        kw = dict(max_new_tokens=self.max_new_tokens, eos_id=self.eos_id)
        if self.sampling is not None:
            toks, out_lens = sample_generate(
                self.model, self._generator, *self._sensor_stacks(rows), ids,
                lens, **kw, **self.sampling)
        elif self.prefix_cache_size:
            toks, out_lens = generate_from_prefix(
                self.model, self._prefixes_for(rows, n), ids, lens,
                params_decode=self.params_decode, **kw)
        else:
            toks, out_lens = greedy_generate(
                self.model, *self._sensor_stacks(rows), ids, lens,
                params_decode=self.params_decode, **kw)
        return toks, out_lens, bucket

    def _dispatch_multi(self, groups: List[List[_Request]]):
        """Issue G full buckets as one greedy_generate_multi call; results
        flatten group-major, aligned with the flat request list. Sensors
        stack in their wire format: the call preprocesses uint8 frames and
        casts the BEV one group at a time."""
        bev = torch.stack([torch.stack([r.bev for r in g]) for g in groups])
        images = torch.stack([torch.stack([r.images for r in g])
                              for g in groups])
        if images.dtype != torch.uint8:
            images = images.float()
        valid = torch.stack([torch.stack([r.view_valid for r in g])
                             for g in groups])
        text = [self._text(g) for g in groups]
        toks, out_lens = greedy_generate_multi(
            self.model, bev, images, valid,
            torch.stack([t[0] for t in text]),
            torch.stack([t[1] for t in text]),
            max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
            params_decode=self.params_decode)
        n = sum(len(g) for g in groups)
        return toks.reshape(n, -1), out_lens.reshape(n), n

    def _prefixes_for(self, rows, n_real):
        """[bucket, P, D] prefix rows, encoding only cache misses.

        Misses (and every frame_id-less row) are encoded in one batch at a
        bucket size; hits reuse the cached row. A miss without sensors
        fails its request with KeyError unless another row of the batch
        carries that frame's sensors; its row then holds a placeholder
        whose result the resolved future ignores.
        """
        enc = encode_prefix_fn(self.model)
        miss_idx = [i for i, r in enumerate(rows)
                    if r.frame_id is None
                    or r.frame_id not in self._prefix_cache]
        misses = set(miss_idx)
        # hold the hits' rows now: this batch's inserts may evict them
        held = {r.frame_id: self._prefix_cache[r.frame_id]
                for i, r in enumerate(rows) if i not in misses}
        for fid in held:
            self._prefix_cache.move_to_end(fid)
        with self._stats_lock:   # real rows only (pads clone row 0)
            real_miss = len([i for i in miss_idx if i < n_real])
            self._stats["prefix_hits"] += n_real - real_miss
            self._stats["prefix_misses"] += real_miss
        # one encode per frame_id, preferring a row that carries sensors;
        # fid-less pad clones of row 0 dedup away too
        first_for_key, enc_order = {}, []
        for i in miss_idx:
            fid = rows[i].frame_id
            if fid is not None and fid in first_for_key:
                j = first_for_key[fid]
                if rows[j].images is None and rows[i].images is not None:
                    enc_order[enc_order.index(j)] = i
                    first_for_key[fid] = i
                continue
            if fid is not None:
                first_for_key[fid] = i
            elif rows[i] is rows[0] and i != 0:
                continue
            enc_order.append(i)
        failed, enc_final = set(), []
        for i in enc_order:
            if rows[i].images is None:
                failed.add(rows[i].frame_id)
            else:
                enc_final.append(i)
        for i in miss_idx:      # every row of a frame nobody could encode
            fid = rows[i].frame_id
            if fid in failed and not rows[i].future.done():
                _resolve(rows[i].future, exc=KeyError(
                    f"frame_id {fid!r} not in the prefix cache and the "
                    f"request carried no sensors"))
        fresh, batch_fid = {}, {}   # batch_fid survives the eviction below
        if enc_final:
            bucket = next(b for b in self.buckets if b >= len(enc_final))
            sel = enc_final + [enc_final[0]] * (bucket - len(enc_final))
            new = enc(*self._sensor_stacks([rows[i] for i in sel]))
            fresh = {i: new[j].clone() for j, i in enumerate(enc_final)}
            for i in enc_final:
                fid = rows[i].frame_id
                if fid is not None:
                    batch_fid[fid] = fresh[i]
                    self._prefix_cache[fid] = fresh[i]
                    self._prefix_cache.move_to_end(fid)
            while len(self._prefix_cache) > self.prefix_cache_size:
                self._prefix_cache.popitem(last=False)
        placeholder = next(iter(held.values()), None)
        if placeholder is None and fresh:
            placeholder = next(iter(fresh.values()))
        if placeholder is None:
            raise RuntimeError("no request in this batch could be served "
                               "(all were uncached sensor-less rows)")
        out = []
        for i, r in enumerate(rows):
            fid = r.frame_id
            if fid is not None and fid in batch_fid:
                out.append(batch_fid[fid])
            elif fid is not None and fid in held:
                out.append(held[fid])
            elif i in fresh:
                out.append(fresh[i])
            elif i == 0 or rows[i] is not rows[0]:
                out.append(placeholder)   # failed row: future already set
            else:                         # fid-less pad clone of row 0
                out.append(out[0])
        return torch.stack(out)

    def _complete(self, batch: List[_Request], result: tuple) -> None:
        """Fetch one dispatched batch and resolve its futures."""
        try:
            toks, out_lens, bucket = result
            toks, out_lens = toks.cpu().tolist(), out_lens.cpu().tolist()
        except Exception as e:   # a device fault surfaces at the fetch
            for req in batch:
                if not req.future.done():
                    _resolve(req.future, exc=e)
            return
        n = len(batch)
        now = time.perf_counter()
        with self._stats_lock:
            self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["pad_rows"] += bucket - n
            self._stats["batch_sizes"].append(n)
            self._stats["latency_s"] += [now - r.t_submit for r in batch]
        for i, req in enumerate(batch):
            cut = out_lens[i]
            if req.max_new_tokens is not None:
                cut = min(cut, int(req.max_new_tokens))
            ids_out = toks[i][:cut]
            text = (self.tokenizer.decode(ids_out)
                    if self.tokenizer is not None else None)
            _resolve(req.future, (ids_out, text))
