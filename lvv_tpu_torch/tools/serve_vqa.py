"""VQA serving daemon of the port: an HTTP JSON endpoint over the
dynamic-batching ServingEngine or the continuous-batching engine
(counterpart of tools/serve_vqa.py).

    python -m lvv_tpu_torch.tools.serve_vqa --checkpoint DIR --port 8000

    POST /v1/vqa   {"question": str, "bev_path": str[, "cam_paths": [...],
                    "frame_id": str]} -> {"answer": str, "latency_s": float}
                   (400 when the BEV file is missing)
    GET  /v1/stats -> the engine's stats()
    GET  /healthz  -> 200 once the model is loaded

Concurrent clients (one thread each, ThreadingHTTPServer) are coalesced
into batches by the engine. Runs on the card unless `--device` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(engine, bev_root: pathlib.Path):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # no access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._send(200, engine.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/vqa":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                bev = np.load(bev_root / req["bev_path"]).astype(np.float32)
                t0 = time.perf_counter()
                kw = {}
                if getattr(engine, "prefix_cache_size", 0):
                    # frame_id (default: the bev path) keys the prefix cache
                    kw["frame_id"] = req.get("frame_id", req["bev_path"])
                _, text = engine.submit_text(req["question"], bev,
                                             req.get("cam_paths"),
                                             **kw).result()
                self._send(200, {"answer": text, "latency_s": round(
                    time.perf_counter() - t0, 4)})
            except FileNotFoundError as e:
                self._send(400, {"error": f"bev not found: {e}"})
            except Exception as e:   # the request fails; the server goes on
                self._send(500, {"error": repr(e)})

    return Handler


def build_engine(args):
    """The engine of the command line's flags over the loaded checkpoint."""
    from lvv_tpu_torch.inference import (ContinuousServingEngine,
                                         ModelLoader, ServingEngine)
    from lvv_tpu_torch.models.vqa import (prepare_serving_params,
                                          prepare_serving_params_fused)

    loader = ModelLoader(args.checkpoint, args.tokenizer)
    model, _ = loader.load_all(args.device)
    params_decode = None
    if args.quantize_llm:
        params_decode = (prepare_serving_params_fused(model)
                         if args.fused_decode
                         else prepare_serving_params(model))
    if args.engine == "continuous":
        return ContinuousServingEngine(
            model, loader.tokenizer, slots=args.max_batch,
            chunk_steps=args.chunk_steps,
            max_new_tokens=args.max_new_tokens, params_decode=params_decode)
    return ServingEngine(
        model, loader.tokenizer, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_new_tokens=args.max_new_tokens,
        params_decode=params_decode, prefix_cache_size=args.prefix_cache)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--bev-root", default=".",
                   help="directory bev_path values are resolved against")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=4.0)
    p.add_argument("--max-new-tokens", type=int, default=96)
    p.add_argument("--quantize-llm", dest="quantize_llm",
                   action="store_true", default=True,
                   help="int8 LLM weights for the decode (default on)")
    p.add_argument("--no-quantize-llm", dest="quantize_llm",
                   action="store_false")
    p.add_argument("--fused-decode", dest="fused_decode",
                   action="store_true", default=True,
                   help="the packed int8 decode (default on; "
                        "--no-fused-decode: the unfused int8 tree)")
    p.add_argument("--no-fused-decode", dest="fused_decode",
                   action="store_false")
    p.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                   help="cache N frames' encoded prefixes: repeat "
                        "questions about a frame skip the sensor encode")
    p.add_argument("--engine", choices=("batch", "continuous"),
                   default="batch",
                   help="batch = bucket-synchronous ServingEngine; "
                        "continuous = slot-slab rolling admissions")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="continuous engine: decode tokens per chunk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.engine == "continuous" and args.prefix_cache:
        p.error("--prefix-cache is only supported by --engine batch")

    engine = build_engine(args)
    handler = make_handler(engine, pathlib.Path(args.bev_root))
    srv = ThreadingHTTPServer((args.host, args.port), handler)
    print(f"serving on http://{args.host}:{srv.server_port} "
          f"(engine={args.engine}, max_batch={args.max_batch})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()


if __name__ == "__main__":
    main()
