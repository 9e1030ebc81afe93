"""HTTP mask-serving front end over ``serving.Predictor`` (port of
``egm_unet_tpu/cli/serve.py``).

A threaded HTTP server whose concurrent requests are coalesced by a
micro-batcher into one fixed-size device batch per shape bucket (packed by
``Predictor``), so N simultaneous clients share one forward instead of N
sequential batch-1 forwards.

Endpoints:
  POST /predict   body = PNG/JPEG image bytes -> PNG {0,255} mask at the
                  original resolution (Content-Type: image/png)
  GET  /healthz   liveness ("ok" once the first request has been answered,
                  which builds the CUDA kernels; "warming" before)
  GET  /stats     JSON counters (requests, batches, mean batch occupancy,
                  p50/p95/p99 request latency in ms)

Run:  python -m egm_unet_torch.cli.serve --weights unet.pt --port 8000
      python -m egm_unet_torch.cli.serve --init-random \\
          --conv-impl pair --upsample-impl fused
      python -m egm_unet_torch.cli.serve --weights unet.pt --quant int8df

``--weights`` is a file holding the model's ``state_dict``, or a checkpoint
directory (``cli/train.py``'s, or ``cli/convert.py --kind egm``'s), folded
(``Predictor.from_checkpoint``).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="save_weights",
                   help="file holding the model's state_dict")
    p.add_argument("--model", default="egm_unet")
    p.add_argument("--base-c", default=32, type=int)
    p.add_argument("--num-classes", default=1, type=int)
    p.add_argument("--base-size", default=565, type=int)
    p.add_argument("--batch-size", default=128, type=int,
                   help="device batch capacity: requests of one shape bucket "
                        "packed into one forward")
    p.add_argument("--batch-window-ms", default=5.0, type=float,
                   help="how long the micro-batcher waits for more requests "
                        "after the first arrival before dispatching")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' runs the "
                        "kernels' plain versions")
    p.add_argument("--conv-impl", default="gemm", choices=["gemm", "pair"],
                   help="'pair': both convs of a DoubleConv in one kernel")
    p.add_argument("--upsample-impl", default="matmul", choices=["matmul", "fused"],
                   help="'fused': the decoder upsample as one kernel")
    p.add_argument("--quant", default=None, choices=[None, "int8", "int8df", "int8full"],
                   help="serving-only int8 quantization (ops/quant.py), "
                        "calibrated on the first batch; int8df and int8full "
                        "store the shipping sites 'mca:,egrfb:,:pool' in 8 bits")
    p.add_argument("--init-random", action="store_true",
                   help="serve randomly-initialized weights (smoke tests)")
    return p.parse_args(argv)


class MicroBatcher:
    """Coalesces concurrent predict() calls into one Predictor batch.

    Callers enqueue an image and block on a per-request event; a single
    dispatcher thread drains the queue — waiting ``window_ms`` after the
    first arrival so simultaneous clients land in the same device batch —
    and fans the masks back out.  Predictor packs one fixed-size batch per
    shape bucket.
    """

    # ring-buffer size for request-latency percentiles (/stats)
    LATENCY_WINDOW = 1024

    def __init__(self, predictor, max_batch: int, window_ms: float):
        self.predictor = predictor
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._wake = threading.Event()
        self._stop = False
        self.n_requests = 0
        self.n_batches = 0
        self.n_batched_items = 0
        # lone-client mode: when the previous dispatch went out with a single
        # item, the next singleton dispatches immediately instead of paying
        # the batching window — a lone client's p50 is then the device batch
        # time + O(1 ms), while burst traffic (previous occupancy > 1) keeps
        # the window so simultaneous clients coalesce.
        self._prev_occupancy = 1
        self.queue_time_s = 0.0  # sum of enqueue->dispatch waits
        self.device_time_s = 0.0  # sum of Predictor.predict() wall time
        self._latencies: List[float] = []  # seconds, last LATENCY_WINDOW
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def predict(self, image: np.ndarray, timeout: float = 120.0):
        t0 = time.perf_counter()
        item = {"image": image, "done": threading.Event(),
                "mask": None, "error": None, "t_enq": t0}
        with self._lock:
            self._queue.append(item)
            self.n_requests += 1
        self._wake.set()
        if not item["done"].wait(timeout):
            raise TimeoutError("predict timed out")
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            if len(self._latencies) > self.LATENCY_WINDOW:
                del self._latencies[: -self.LATENCY_WINDOW]
        if item["error"] is not None:
            raise item["error"]
        return item["mask"]

    def stats(self) -> dict:
        """Consistent snapshot of the counters: read unlocked, a new time sum
        could pair with a stale count."""
        with self._lock:
            return {"n_requests": self.n_requests,
                    "n_batches": self.n_batches,
                    "n_batched_items": self.n_batched_items,
                    "queue_time_s": self.queue_time_s,
                    "device_time_s": self.device_time_s}

    def latency_ms(self) -> dict:
        """p50/p95/p99 enqueue-to-mask latency (ms) over the last window."""
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        return {k: round(pick(q) * 1e3, 2)
                for k, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))}

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def _window_wait(self):
        """Let concurrent arrivals pile up — but dispatch IMMEDIATELY once
        the queue reaches device capacity (waiting past a full batch only
        adds latency), and skip the window entirely in lone-client mode (an
        unconditional sleep would put the whole window on every lone
        request's latency)."""
        with self._lock:
            if len(self._queue) >= self.max_batch:
                return
            if self._prev_occupancy <= 1 and len(self._queue) <= 1:
                return  # lone-client mode: no artificial wait
        deadline = time.perf_counter() + self.window_s
        slice_s = max(self.window_s / 8, 2e-4)
        while time.perf_counter() < deadline:
            with self._lock:
                if len(self._queue) >= self.max_batch:
                    return
            time.sleep(slice_s)

    def _run(self):
        while not self._stop:
            self._wake.wait()
            if self._stop:
                return
            self._window_wait()
            t_disp = time.perf_counter()
            with self._lock:
                batch, self._queue = (self._queue[: self.max_batch],
                                      self._queue[self.max_batch:])
                if not self._queue:
                    self._wake.clear()
            if not batch:
                continue
            try:
                masks = self.predictor.predict([b["image"] for b in batch])
                for b, m in zip(batch, masks):
                    b["mask"] = m
            except Exception as e:  # fan the failure out to every waiter
                for b in batch:
                    b["error"] = e
            t_done = time.perf_counter()
            with self._lock:
                self._prev_occupancy = len(batch)
                self.queue_time_s += sum(t_disp - b["t_enq"] for b in batch)
                self.device_time_s += t_done - t_disp
                self.n_batches += 1
                self.n_batched_items += len(batch)
            for b in batch:
                b["done"].set()


def _make_handler(batcher: MicroBatcher, state: dict):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /stats carries the counters
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                msg = b"ok" if state.get("warm") else b"warming"
                self._send(200, msg, "text/plain")
            elif self.path == "/stats":
                s = batcher.stats()
                occ = (s["n_batched_items"] / s["n_batches"]
                       if s["n_batches"] else 0.0)
                nb = max(s["n_batched_items"], 1)
                body = json.dumps({
                    "requests": s["n_requests"],
                    "batches": s["n_batches"],
                    "mean_batch_occupancy": round(occ, 2),
                    "latency_ms": batcher.latency_ms(),
                    # where a request's time goes: waiting in the batcher
                    # queue vs executing on the device
                    "mean_queue_ms": round(s["queue_time_s"] / nb * 1e3, 2),
                    "mean_device_ms": round(
                        s["device_time_s"] / max(s["n_batches"], 1)
                        * 1e3, 2),
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                img = Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB")
                mask = batcher.predict(np.asarray(img, np.uint8))
                out = io.BytesIO()
                # foreground -> 255, like the predict CLI's saved masks
                Image.fromarray((mask > 0).astype(np.uint8) * 255,
                                mode="L").save(out, format="PNG")
                state["warm"] = True
                self._send(200, out.getvalue(), "image/png")
            except Exception as e:
                self._send(400, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

    return Handler


def make_server(args, predictor=None) -> tuple:
    """Build (ThreadingHTTPServer, MicroBatcher); ``predictor`` replaces
    the one the arguments describe."""
    from egm_unet_torch.serving import Predictor, PredictorConfig

    cfg = PredictorConfig(model_name=args.model, base_c=args.base_c,
                          num_classes=args.num_classes + 1,
                          batch_size=args.batch_size,
                          base_size=args.base_size, dtype=args.dtype,
                          conv_impl=args.conv_impl,
                          upsample_impl=args.upsample_impl, quant=args.quant)
    if predictor is None:
        if args.init_random:  # seed 0
            predictor = Predictor(config=cfg, device=args.device)
        else:
            predictor = Predictor.from_checkpoint(args.weights, cfg,
                                                  device=args.device)
    batcher = MicroBatcher(predictor, args.batch_size, args.batch_window_ms)
    httpd = ThreadingHTTPServer((args.host, args.port),
                                _make_handler(batcher, {"warm": False}))
    return httpd, batcher


def main(argv=None):
    args = parse_args(argv)
    httpd, batcher = make_server(args)
    print(f"serving {args.model} on http://{args.host}:{httpd.server_port} "
          f"(batch {args.batch_size}, window {args.batch_window_ms} ms)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
