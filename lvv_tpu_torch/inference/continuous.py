"""ContinuousServingEngine: slot-based, chunked-decode serving (counterpart
of lvv_tpu/inference/continuous.py).

`ServingEngine` is batch-synchronous: a request arriving just after a batch
launches waits for that batch's whole generation. This engine removes the
barrier:

- the KV cache is one slab of `slots` rows (`init_cache`, allocated at the
  first admission);
- new requests are prefilled in power-of-two buckets and written into free
  slots by one indexed copy per layer;
- decode runs over all slots in `chunk_steps`-token chunks (through the
  packed int8 decode when `params_decode` carries "_fused_decode"); empty
  and finished slots emit eos into rows the next admission overwrites;
- at every chunk boundary the host collects finished answers, frees their
  slots and admits waiting requests.

A request's latency is its own prefill and decode plus at most one chunk of
queueing. Greedy only; a burst's tokens equal greedy_generate's on the same
padded batch at the same cache length.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.qwen import init_cache
from ..models.vqa import _prefix_len
from .server import (_Request, _buckets_up_to, _preprocess, _resolve,
                     _text_request_arrays)


class ContinuousServingEngine:
    def __init__(self, model, tokenizer=None, *, slots: int = 8,
                 chunk_steps: int = 8, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, params_decode=None):
        if eos_id is None:
            if tokenizer is None:
                raise ValueError("pass eos_id when no tokenizer is given")
            eos_id = tokenizer.eos_id
        self.model = model
        self.device = model.device
        self.params_decode = params_decode
        self.tokenizer = tokenizer
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.admit_buckets = _buckets_up_to(self.slots)
        self._prompt_width: Optional[int] = None
        self._max_cache: Optional[int] = None

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "admission_batches": 0,
                       "decode_chunks": 0, "latency_s": [],
                       "occupancy": []}
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="lvv-continuous", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------- public API

    def submit(self, bev, images, view_valid, text_ids, text_len: int,
               max_new_tokens: Optional[int] = None,
               on_tokens=None) -> Future:
        """Enqueue one request (ServingEngine.submit's formats; sensors are
        required). `on_tokens(list_of_new_ids)` is called from the serving
        thread with each chunk's fresh tokens for this request."""
        if self._closed.is_set():
            raise RuntimeError("engine is closed")
        if bev is None or images is None:
            raise ValueError("the continuous engine has no prefix cache; "
                             "every request must carry bev and images")

        def put(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        req = _Request(put(bev), put(images), put(view_valid, torch.bool),
                       np.asarray(text_ids, np.int32), int(text_len),
                       max_new_tokens=max_new_tokens, on_tokens=on_tokens)
        self._queue.put(req)
        return req.future

    def submit_text(self, question: str, bev, cam_paths=None) -> Future:
        if self.tokenizer is None:
            raise ValueError("submit_text requires a tokenizer")
        images, valid, ids, length = _text_request_arrays(
            self.model.cfg, self.tokenizer, question, cam_paths)
        return self.submit(bev, images, valid, ids, length)

    def generate(self, question: str, bev, cam_paths=None,
                 timeout: Optional[float] = None) -> str:
        return self.submit_text(question, bev,
                                cam_paths).result(timeout=timeout)[1]

    def stats(self) -> dict:
        with self._stats_lock:
            st = dict(self._stats)
            lat = sorted(st.pop("latency_s"))
            occ = st.pop("occupancy")
            st["p50_latency_s"] = lat[len(lat) // 2] if lat else None
            st["mean_occupancy"] = float(np.mean(occ)) if occ else 0.0
            return st

    def close(self, timeout: float = 60.0) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._worker.join(timeout=timeout)
        while True:
            try:
                _resolve(self._queue.get_nowait().future,
                         exc=RuntimeError("engine closed"))
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------- device steps

    def max_cache(self, prompt_width: int) -> int:
        """The slab's length for prompts `prompt_width` wide: the prefix,
        the prompt, the answer rounded up to whole chunks (a row decodes
        whole chunks until it is collected) and 8 spare."""
        chunks = -(-self.max_new_tokens // self.chunk_steps)
        return (_prefix_len(self.model.cfg) + prompt_width
                + chunks * self.chunk_steps + 8)

    def _new_cache(self, batch: int):
        return init_cache(self.model.cfg.llm, batch, self._max_cache,
                          dtype=self.model.dtype, device=self.device)

    def _prefill(self, rows: List[_Request]):
        """Prefill a bucket of admissions -> (last logits [b, V], cache)."""
        bev = torch.stack([r.bev for r in rows]).float()
        images = torch.stack([r.images for r in rows])
        if images.dtype == torch.uint8:     # raw frames: preprocess here
            images = _preprocess(images, self.model.cfg.sam.img_size)
        valid = torch.stack([r.view_valid for r in rows])
        ids = torch.as_tensor(np.stack([r.text_ids for r in rows]),
                              device=self.device).long()
        lens = torch.as_tensor([r.text_len for r in rows], dtype=torch.int32,
                               device=self.device)
        cache = self._new_cache(len(rows))
        return self.model.prefill(bev, images, valid, ids, lens, cache), cache

    def _decode_chunk(self, slab, logits, done):
        """chunk_steps greedy steps over every slot (greedy_loop's rule:
        done rows emit eos) -> (logits, tokens [S, chunk])."""
        packed = (self.params_decode or {}).get("_fused_decode")
        tree = (self.params_decode or {}).get("llm")
        toks = []
        for _ in range(self.chunk_steps):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, self.eos_id), nxt)
            if packed is not None:
                from ..models.decode_fused import fused_decode_step
                logits = fused_decode_step(
                    self.model.cfg.llm, self.model.dtype, packed, nxt.long(),
                    slab).to(logits.dtype)
            else:
                logits = self.model.decode_step(nxt.long(), slab, tree)
            done = done | (nxt == self.eos_id)
            toks.append(nxt)
        return logits, torch.stack(toks, dim=1)

    # ------------------------------------------------------------- worker

    def _admit(self, free: List[int], slab, logits_slab):
        """Drain up to len(free) queued requests into free slots ->
        (slab, logits_slab, {slot: request})."""
        admits: List[_Request] = []
        while len(admits) < len(free):
            try:
                admits.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not admits:
            return slab, logits_slab, {}
        try:
            return self._admit_rows(admits, free, slab, logits_slab)
        except Exception as e:   # these admissions fail; serving goes on
            for r in admits:
                if not r.future.done():
                    _resolve(r.future, exc=e)
            return slab, logits_slab, {}

    def _admit_rows(self, admits, free, slab, logits_slab):
        if self._prompt_width is None:
            self._prompt_width = admits[0].text_ids.shape[0]
            self._max_cache = self.max_cache(self._prompt_width)
        for r in admits:
            if r.text_ids.shape[0] != self._prompt_width:
                raise ValueError(
                    f"prompt width {r.text_ids.shape[0]} != engine width "
                    f"{self._prompt_width}: all requests must share the "
                    f"shapes of the first (a wider prompt would overflow "
                    f"the KV slab)")
        if slab is None:   # first admission, or after a failed chunk
            slab = self._new_cache(self.slots)
        n = len(admits)
        bucket = next(b for b in self.admit_buckets if b >= n)
        new_logits, new_cache = self._prefill(
            admits + [admits[0]] * (bucket - n))
        if logits_slab is None:
            logits_slab = new_logits.new_zeros(
                (self.slots, new_logits.shape[-1]))
        idx = torch.as_tensor(free[:n], device=self.device)
        for sk, sv, nk, nv in zip(slab.k, slab.v, new_cache.k, new_cache.v):
            sk[idx] = nk[:n]
            sv[idx] = nv[:n]
        slab.length[idx] = new_cache.length[:n]
        logits_slab[idx] = new_logits[:n]
        with self._stats_lock:
            self._stats["requests"] += n
            self._stats["admission_batches"] += 1
        return slab, logits_slab, dict(zip(free[:n], admits))

    def _serve_loop(self) -> None:
        with torch.inference_mode():    # per thread
            self._serve()

    def _serve(self) -> None:
        slab = logits_slab = None
        active: Dict[int, list] = {}            # slot -> [request, tokens]
        while True:
            if (self._closed.is_set() and self._queue.empty()
                    and not active):
                return
            free = [s for s in range(self.slots) if s not in active]
            if free and not self._queue.empty():
                slab, logits_slab, placed = self._admit(free, slab,
                                                        logits_slab)
                for slot, req in placed.items():
                    active[slot] = [req, []]
            if not active:
                time.sleep(0.01)
                continue
            done = torch.ones(self.slots, dtype=torch.bool)
            done[list(active)] = False
            free = [s for s in range(self.slots) if s not in active]
            try:
                if free:    # idle rows restart at 0: their writes stay in
                    slab.length[free] = 0       # the slab
                logits_slab, toks = self._decode_chunk(
                    slab, logits_slab, done.to(self.device))
                toks = toks.cpu().tolist()      # one host sync a chunk
            except Exception as e:
                # fail the in-flight requests and start a new slab for the
                # next admissions; the worker goes on
                for req, _ in active.values():
                    _resolve(req.future, exc=e)
                active.clear()
                slab = logits_slab = None
                continue
            with self._stats_lock:
                self._stats["decode_chunks"] += 1
                self._stats["occupancy"].append(len(active))
            now = time.perf_counter()
            for slot in list(active):
                req, out = active[slot]
                cap = (min(self.max_new_tokens, req.max_new_tokens)
                       if req.max_new_tokens is not None
                       else self.max_new_tokens)
                finished, fresh = False, []
                for t in toks[slot]:
                    if t == self.eos_id:
                        finished = True
                        break
                    out.append(t)
                    fresh.append(t)
                    if len(out) >= cap:
                        finished = True
                        break
                if req.on_tokens is not None and fresh:
                    try:
                        req.on_tokens(fresh)
                    except Exception:   # a broken stream consumer must not
                        pass            # stop serving
                if finished:
                    text = (self.tokenizer.decode(out)
                            if self.tokenizer is not None else None)
                    with self._stats_lock:
                        self._stats["latency_s"].append(now - req.t_submit)
                    _resolve(req.future, (out, text))
                    del active[slot]
