"""TTS serving: an HTTP front end and a dynamic batcher.

* **Dynamic batching.** Concurrent requests are collected for up to
  `batch_window_ms` (or until `max_batch`) and synthesised as one device
  call per (batch, text) bucket pair by `Synthesizer.synthesize_batch`, so
  the per-call host work is paid once per batch instead of once per request.
* **One device thread at a time.** Batches run on the batcher thread and
  streams on handler threads, both under the batcher's `device_lock`, so the
  device never sees work from two host threads at once.  Every device call
  runs under `torch.no_grad()`: grad mode is per thread, and these threads
  start with it on.
* **Streaming.** `stream=true` answers with chunked transfer encoding fed by
  `Synthesizer.stream_samples` (the sample-level streaming vocoder).
* **Data parallelism.** Under torchrun (`--data-parallel`), rank 0 runs the
  HTTP server and the batcher; for each group it broadcasts the texts and
  the group's parameters, and every rank runs its share of
  `Synthesizer.synthesize_batch_sharded`.  The other ranks wait in
  `follow`.  While idle, rank 0 broadcasts a heartbeat now and then, so
  that the waiting collective never reaches its timeout, and at shutdown
  a stop.  Streams run on rank 0 alone.
* The standard library's `http.server` only.

Endpoints:
  POST /synthesize   {"text": ..., "n_timesteps": 10, "temperature": 0.667,
                      "length_scale": 1.0, "seed": 0, "spk": null,
                      "stream": false}            -> audio/wav
                     (n_timesteps 1 to MAX_TIMESTEPS, else 400)
  GET  /healthz                                    -> {"status": "ok", ...}
  GET  /stats                                      -> batching counters

`/stats` counts `requests` submitted to the batcher, `batches` (groups
synthesised), `batched_requests`, `max_batch_seen`, `audio_seconds` and
`synth_seconds` (host clock around a group; `rtf` is their ratio), and
`queue_wait_seconds` and `queue_wait_max_seconds`: the sum and the largest
of each request's time from `submit` to the batcher taking it into a batch.

Under `torch.profiler` (of every thread: the handlers and the batcher run
on threads of their own), each POST is a span `matcha.serve.request` from
receipt to the response written, and each group a span
`matcha.serve.batch`.  Their `request_id` / `request_ids` arguments join a
request to its batch where the profiler keeps span arguments
(`utils/tracing.py`).
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.parallel.mesh import broadcast_json
from matcha_tts_tpu_torch.utils import tracing
from matcha_tts_tpu_torch.utils.wav import pcm16_bytes, wav_bytes

# the most solver steps a request may ask for: the flow is solved in a few
# (Matcha-TTS is evaluated at 2 to 10), and each step adds about a tenth of a
# call's device time to the batch that carries it
MAX_TIMESTEPS = 100


@dataclass
class _Request:
    text: str
    n_timesteps: int
    temperature: float
    length_scale: float
    seed: int
    spk: Optional[int]
    future: Future = field(default_factory=Future)
    rid: int = 0             # the request's id in the spans
    t_submit: float = 0.0

    @property
    def group_key(self):
        # requests fused into one device call share these parameters
        return (self.n_timesteps, self.temperature, self.length_scale, self.seed, self.spk)


class DynamicBatcher:
    """Collects requests for up to `batch_window_ms`, groups them by
    parameter key and synthesises each group as one batch on its own
    thread.  With a `mesh` (on rank 0), each group goes to every rank and
    through `Synthesizer.synthesize_batch_sharded`."""

    # the idle rank 0 broadcasts a heartbeat this often, far inside the
    # process group's timeout
    HEARTBEAT_S = 30.0

    def __init__(self, synth: Synthesizer, max_batch: int = 16,
                 batch_window_ms: float = 10.0, mesh=None):
        self.synth = synth
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.window_s = float(batch_window_ms) / 1000.0
        self.q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "audio_seconds": 0.0, "synth_seconds": 0.0, "max_batch_seen": 0,
                      "queue_wait_seconds": 0.0, "queue_wait_max_seconds": 0.0}
        # serialises all device work: batches here, streams on handler threads
        self.device_lock = threading.Lock()
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req: _Request) -> Future:
        if self._closing:
            req.future.set_exception(RuntimeError("server is shutting down"))
            return req.future
        self.stats["requests"] += 1
        req.t_submit = time.monotonic()
        self.q.put(req)
        return req.future

    def shutdown(self):
        """Drain: requests queued before the shutdown complete; later ones
        (and any that race past the sentinel) fail at once."""
        self._closing = True
        self.q.put(None)
        self._thread.join(timeout=300.0)
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.future.set_exception(RuntimeError("server is shutting down"))

    # -- the batcher thread ----------------------------------------------------

    def _first(self):
        """Block for the first request (or the shutdown's None); under a mesh,
        send a heartbeat for each idle `HEARTBEAT_S`."""
        if self.mesh is None:
            return self.q.get()
        while True:
            try:
                return self.q.get(timeout=self.HEARTBEAT_S)
            except queue.Empty:
                broadcast_json({"op": "ping"})

    def _taken(self, req: _Request) -> _Request:
        """Count `req`'s wait in the queue, as the batcher takes it."""
        wait = time.monotonic() - req.t_submit
        self.stats["queue_wait_seconds"] += wait
        self.stats["queue_wait_max_seconds"] = max(self.stats["queue_wait_max_seconds"], wait)
        return req

    def _collect(self):
        """Block for the first request, then take more for the batch window."""
        first = self._first()
        if first is None:
            return None
        batch = [self._taken(first)]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self.q.put(None)  # the outer loop stops on it
                break
            batch.append(self._taken(nxt))
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                if self.mesh is not None:
                    broadcast_json({"op": "stop"})
                return
            groups: dict = {}
            for r in batch:
                groups.setdefault(r.group_key, []).append(r)
            for key, reqs in groups.items():
                self._serve_group(key, reqs)

    def _serve_group(self, key, reqs):
        with tracing.span("matcha.serve.batch",
                          {"request_ids": ",".join(str(r.rid) for r in reqs)}):
            t0 = time.monotonic()
            texts = [r.text for r in reqs]
            try:
                with self.device_lock, torch.no_grad():
                    if self.mesh is not None:
                        broadcast_json({"op": "batch", "texts": texts, "key": list(key)})
                    results = _synthesize_group(self.synth, texts, key, self.mesh)
                    pcms = [res.pcm16 for res in results]
            except Exception as e:  # every waiter gets the failure
                for r in reqs:
                    r.future.set_exception(e)
                return
            sr = self.synth.matcha_cfg.audio.sample_rate
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(reqs)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(reqs))
            self.stats["synth_seconds"] += time.monotonic() - t0
            for r, pcm in zip(reqs, pcms):
                # int16 PCM straight off the packed copy, no float round trip
                self.stats["audio_seconds"] += len(pcm) / sr
                r.future.set_result(pcm)


def _synthesize_group(synth: Synthesizer, texts, key, mesh):
    nfe, temp, ls, seed, spk = key
    kw = dict(n_timesteps=nfe, temperature=temp, length_scale=ls, seed=seed, spk=spk)
    if mesh is None:
        return synth.synthesize_batch(texts, **kw)
    return synth.synthesize_batch_sharded(texts, mesh, keep_aux=False, **kw)


def follow(synth: Synthesizer, mesh) -> None:
    """The loop of the ranks past 0 of a data-parallel server: run this
    rank's share of each group that rank 0 broadcasts, until its stop.  A
    group that fails fails on rank 0 too, where its requests get the
    error."""
    while True:
        msg = broadcast_json(None)
        if msg["op"] == "stop":
            return
        if msg["op"] == "batch":
            try:
                with torch.no_grad():
                    _synthesize_group(synth, msg["texts"], msg["key"], mesh)
            except Exception as e:  # noqa: BLE001 -- the server answers; this rank goes on
                print(f"[follow] group failed: {type(e).__name__}: {e}", flush=True)


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        names = [str(device)]
    return {"backend": device.type, "device": str(device), "devices": names}


class TTSServer:
    """Threaded HTTP server around a `Synthesizer` and a `DynamicBatcher`.
    With a data-parallel `mesh` it runs on rank 0, and the other ranks run
    `follow`."""

    def __init__(self, synth: Synthesizer, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 16, batch_window_ms: float = 10.0, mesh=None):
        self.synth = synth
        self.batcher = DynamicBatcher(synth, max_batch, batch_window_ms, mesh=mesh)
        # request ids for the spans (`next` on a count is one C call: atomic
        # across the handler threads)
        self._request_ids = itertools.count(1)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer needs HTTP/1.1: under HTTP/1.0 a client reads
            # the chunk headers as payload
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet; /stats instead
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", **_device_info(server.synth.device)})
                elif self.path == "/stats":
                    st = dict(server.batcher.stats)
                    if st["synth_seconds"] > 0:
                        st["rtf"] = st["synth_seconds"] / max(st["audio_seconds"], 1e-9)
                    self._json(200, st)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                rid = next(server._request_ids)
                with tracing.span("matcha.serve.request", {"request_id": rid}):
                    self._post(rid)

            def _post(self, rid: int):
                if self.path != "/synthesize":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON: {e}"})
                    return
                text = payload.get("text", "") if isinstance(payload, dict) else ""
                if not isinstance(text, str) or not text.strip():
                    self._json(400, {"error": "missing/empty 'text'"})
                    return
                try:
                    req = _Request(
                        text=text,
                        n_timesteps=int(payload.get("n_timesteps", 10)),
                        temperature=float(payload.get("temperature", 0.667)),
                        length_scale=float(payload.get("length_scale", 1.0)),
                        seed=int(payload.get("seed", 0)),
                        spk=(int(payload["spk"]) if payload.get("spk") is not None else None),
                        rid=rid)
                    if not 1 <= req.n_timesteps <= MAX_TIMESTEPS:
                        raise ValueError(f"n_timesteps {req.n_timesteps} is outside "
                                         f"1..{MAX_TIMESTEPS}")
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": f"bad parameter: {e}"})
                    return
                sr = server.synth.matcha_cfg.audio.sample_rate
                if payload.get("stream"):
                    self._stream(req, sr)
                    return
                try:
                    pcm = server.batcher.submit(req).result(timeout=300.0)
                except Exception as e:
                    # the type too: some runtime errors carry an empty message
                    self._json(500, {"error": f"synthesis failed: {type(e).__name__}: {e}"})
                    return
                body = wav_bytes(pcm, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client left before its answer

            def _stream(self, req: _Request, sr: int):
                """Headerless PCM16 in chunks from the streaming vocoder,
                outside the batcher: streams are for latency, not throughput."""
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # no sentence lookahead: its producer thread would launch work
                # outside the device lock below
                gen = server.synth.stream_samples(
                    req.text, n_timesteps=req.n_timesteps, temperature=req.temperature,
                    length_scale=req.length_scale, seed=req.seed, spk=req.spk,
                    lookahead_sentences=0)
                try:
                    while True:
                        # the device work of a chunk happens inside next()
                        with server.batcher.device_lock, torch.no_grad():
                            chunk = next(gen, None)
                        if chunk is None:
                            break
                        pcm = pcm16_bytes(chunk)
                        self.wfile.write(f"{len(pcm):X}\r\n".encode() + pcm + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    gen.close()

        class _Server(ThreadingHTTPServer):
            # the default listen backlog of 5 resets a burst of connections
            request_queue_size = 128

        self.httpd = _Server((host, port), Handler)
        # non-daemon handlers: server_close() waits for responses in flight
        self.httpd.daemon_threads = False
        self.port = self.httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self):
        """Serve in a background thread (tests, embedding); returns self."""
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def serve_forever(self):
        """Serve until SIGTERM or SIGINT, then drain and return.  The signal
        handler only stops `httpd.serve_forever()` (from a helper thread:
        calling shutdown() on the serving thread would deadlock); the drain
        runs here, so the process ends after the queued requests are
        answered."""
        import signal

        def handle(signum, frame):
            print(f"signal {signum}: shutting down")
            threading.Thread(target=self.httpd.shutdown, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handle)
            except ValueError:  # not the main thread (embedded use)
                break
        print(f"matcha serving on :{self.port} on {self.synth.device} "
              f"(max_batch={self.batcher.max_batch}, "
              f"window={self.batcher.window_s * 1e3:.0f}ms)")
        self.httpd.serve_forever()
        self.batcher.shutdown()
        self.httpd.server_close()  # joins the handler threads in flight
        print("drained; clean exit")

    def stop(self):
        self.httpd.shutdown()
        # the batcher first: handlers may wait on its futures, and
        # server_close() waits for the handlers
        self.batcher.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)


def main(argv=None):
    """`python -m matcha_tts_tpu_torch.inference.server --ckpt ... --port 8080`."""
    import argparse
    from pathlib import Path

    from matcha_tts_tpu_torch.inference import cli
    from matcha_tts_tpu_torch.ops import cuda_build

    ap = argparse.ArgumentParser(description="Matcha-TTS server (PyTorch)")
    ap.add_argument("--ckpt", default=None,
                    help="Matcha checkpoint (torch .ckpt/.pt); random weights if omitted")
    ap.add_argument("--vocoder", default=None, help="HiFi-GAN checkpoint")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--batch-window-ms", type=float, default=10.0)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--vocoder-family", default="hifigan", choices=("hifigan", "vocos"))
    ap.add_argument("--denoise-strength", type=float, default=0.00025)
    ap.add_argument("--data-parallel", "--mesh", action="store_true",
                    help="shard each batch over the ranks torchrun started (1-D mesh): "
                         "rank 0 serves HTTP, every rank synthesizes its share")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend for --data-parallel (default nccl; "
                         "gloo for --device cpu)")
    ap.add_argument("--warmup", action="store_true",
                    help="run the batched shapes once before serving")
    ap.add_argument("--warmup-grid", action="store_true",
                    help="run every reachable (batch, text, frame) bucket triple once "
                         "(Synthesizer.warmup_grid) before serving")
    ap.add_argument("--warmup-only", action="store_true",
                    help="build the kernels and warm up (implies --warmup), then exit")
    ap.add_argument("--compile-cache", default=None,
                    help="directory for the kernels' nvcc builds (default: the "
                         "package's build/), reused across restarts")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    mesh, device = None, args.device
    if args.data_parallel:
        from matcha_tts_tpu_torch.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(backend=args.backend,
                               device=None if args.device == "cuda" else args.device)
        device = str(pmesh.rank_device())
    if args.compile_cache:
        cuda_build.BUILD_DIR = Path(args.compile_cache)
    model, cfg, vocoder, hcfg = cli.load_models(
        args.ckpt, args.vocoder, vocoder_family=args.vocoder_family, device=device)
    if mesh is not None:  # random weights drawn on each rank alike; a checkpoint alike
        from matcha_tts_tpu_torch.parallel.mesh import replicate

        replicate(mesh, model)
        replicate(mesh, vocoder)
    synth = Synthesizer(model, cfg, vocoder, hcfg, compute_dtype=args.compute_dtype,
                        denoise_strength=args.denoise_strength, device=device)
    if args.warmup or args.warmup_only or args.warmup_grid:
        print("warming up batched shapes ...")
        # every bucket a batch of at most max_batch requests can pad up to
        limit = synth._bucket(args.max_batch, synth.batch_buckets)
        sizes = [b for b in synth.batch_buckets if b <= limit]
        if args.warmup_grid:
            triples = synth.warmup_grid(batch_sizes=sizes)
            print(f"warmed {len(triples)} (batch, text, frame) shapes")
        else:
            print(f"warmed {synth.warmup(batch_sizes=sizes)} batch shapes")
    if args.warmup_only:
        return
    if mesh is not None and pmesh.batch_sharding(mesh).rank != 0:
        follow(synth, mesh)
        return
    if mesh is not None:
        print(f"serving data-parallel over {mesh.size()} ranks")
    TTSServer(synth, host=args.host, port=args.port, max_batch=args.max_batch,
              batch_window_ms=args.batch_window_ms, mesh=mesh).serve_forever()


if __name__ == "__main__":
    main()
