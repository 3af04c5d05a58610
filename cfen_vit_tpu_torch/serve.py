"""Inference server: dehaze images over HTTP (counterpart of the
repository's serve.py).

    python -m cfen_vit_tpu_torch.serve --name <ckpt> --checkpoints_dir ... \
        --which_epoch 32 --model_G iid_hlgvit_crs_gd4_cfs_v3 --n_feats 24 \
        --hidden_dim_ratio 4 [--port 8600] [--host 127.0.0.1] \
        [--compute_dtype bfloat16] [--max_batch 16] [--batch_window_ms 3] \
        [--gpu_ids 0]

    POST /dehaze   body: PNG/JPEG bytes -> PNG bytes of fake_A, with the
                   X-Latency-Ms, X-Decode-Ms, X-Model-Ms, X-Encode-Ms split
    GET  /healthz  -> {"status": "ok", ...} with the device accounting

`--gpu_ids 0` (the default) serves from cuda:0 and raises without CUDA;
`--gpu_ids -1` serves from the CPU.  The model is built and warmed once
(every batch shape the batcher can submit, which also builds the CUDA
kernels) before the first request.  Concurrent requests are micro-batched:
one batcher thread collects them for --batch_window_ms, pads the batch to
the next power of two up to --max_batch, and runs one forward for the
group; uint8 travels between host and card both ways.  On that path two
batches are in flight: the next batch is enqueued on the card before the
previous one is read back, and that read-back (`.cpu()`) is where the
batcher waits for the card.  Images are decoded and encoded with PIL (the
JAX package's native codec needs libjpeg's and libpng's headers, which
the card's machine lacks, and is not ported).  CFEN_PALLAS_VIT=1 runs the
ViT blocks that K2 admits through it (models/vit.py).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_model(argv):
    """(cfg, model, input size) from test.py's flags: --out_all forced on
    (serving returns fake_A only), weights cast to --compute_dtype."""
    from cfen_vit_tpu_torch.config import parse_args, select_device, set_precision
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel

    cfg = parse_args(argv, is_train=False, save_opt=False)
    cfg.out_all = True
    device = select_device(cfg.gpu_ids)
    set_precision(cfg.precision)
    model = DehazingModel(cfg, device)
    model.setup(cfg)
    return cfg, model, cfg.input_size()


def _batch_shapes(max_batch: int):
    """Every padded batch size Batcher._dispatch can produce: powers of two
    up to max_batch, plus max_batch itself when it is not one."""
    sizes, bsz = [], 1
    while bsz <= max_batch:
        sizes.append(bsz)
        bsz *= 2
    if sizes[-1] != max_batch:
        sizes.append(max_batch)
    return sizes


def warm(cfg, model, size, max_batch: int = 4):
    """Run every batch shape once, so no request waits for a kernel build
    or a first-call setup."""
    for bsz in _batch_shapes(max_batch):
        model.set_input({"B": _model_input(
            model, np.zeros((bsz, size, size, 3), np.uint8)),
            "B_paths": ["warmup"] * bsz})
        model.test(cfg)


def _model_input(model, batch_u8: np.ndarray):
    """uint8 batch -> what set_input's active path takes: uint8 on the
    uint8 wire, [-1, 1] floats under --chop/--self_ensemble."""
    if model._u8_io:
        return batch_u8
    return batch_u8.astype(np.float32) / 127.5 - 1.0


def _to_u8(arr):
    """tensor2im: uint8 passes through, float [-1, 1] is converted."""
    if arr.dtype == np.uint8:
        return arr
    return ((arr.astype(np.float32) + 1) / 2 * 255).clip(0, 255).astype(np.uint8)


class Stats:
    """Counters shared by the handler threads and the batcher thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d = {"t0": time.perf_counter()}  # uptime origin (/healthz)

    def add(self, key, delta):
        with self._lock:
            self._d[key] = self._d.get(key, 0) + delta

    def peak(self, key, value):
        with self._lock:
            self._d[key] = max(self._d.get(key, 0), value)

    def get(self, key, default=0):
        with self._lock:
            return self._d.get(key, default)


class Batcher:
    """Coalesces concurrent requests into one forward.

    Batches are padded to the next power of two (at most max_batch) with
    copies of the last image, which are discarded.  Only this thread
    touches the model; it enters the model's CUDA device and inference
    mode itself, since both are per thread.  On the uint8 path
    (no --chop/--self_ensemble) up to DEPTH batches are in flight."""

    DEPTH = 2

    def __init__(self, cfg, model, max_batch: int = 4, window_ms: float = 3.0,
                 stats=None):
        self.cfg = cfg
        self.model = model
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.stats = stats if stats is not None else Stats()
        self.q: queue.Queue = queue.Queue()
        self._direct = model._u8_io
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, img_u8: np.ndarray, timeout: float = 120.0):
        ev = threading.Event()
        slot = {}
        self.q.put((img_u8, ev, slot))
        if not ev.wait(timeout):
            raise TimeoutError("model worker timed out")
        if "err" in slot:
            raise RuntimeError(slot["err"])
        return slot["out"]

    def close(self, timeout: float = 60.0) -> None:
        """Answer what is queued, then stop the thread."""
        self.q.put(None)
        self._thread.join(timeout)

    def _collect(self, first):
        items = [first]
        deadline = time.perf_counter() + self.window_s
        while len(items) < self.max_batch:
            left = deadline - time.perf_counter()
            if self.window_s and left <= 0:
                break
            try:
                item = (self.q.get(timeout=left) if self.window_s
                        else self.q.get_nowait())
            except queue.Empty:
                break
            if item is None:        # close(): put it back for _loop
                self.q.put(None)
                break
            items.append(item)
        return items

    def _dispatch(self, items):
        """Pads the batch and starts the forward; returns the uint8 device
        tensor (not yet read back) on the direct path, host arrays else."""
        b = len(items)
        padded = 1
        while padded < b:
            padded *= 2
        padded = min(padded, self.max_batch)
        batch = np.stack([it[0] for it in items] + [items[-1][0]] * (padded - b))
        if self._direct:
            import torch
            out = self.model.forward_u8(torch.from_numpy(batch).to(self.model.device))
            # dec_ipt has no D branch: its dehazed image is the refined dh
            return out["d"] if "d" in out else out["dh"]
        self.model.set_input({"B": _model_input(self.model, batch),
                              "B_paths": ["req"] * padded})
        return self.model.test(self.cfg)["fake_A"]

    def _finish(self, items, dev_out):
        try:
            td0 = time.perf_counter()
            outs = dev_out if isinstance(dev_out, np.ndarray) else dev_out.cpu().numpy()
            self.stats.add("dev_t", time.perf_counter() - td0)
            for i, (_, ev, slot) in enumerate(items):
                slot["out"] = outs[i]
                ev.set()
        except Exception as e:  # surface to all waiters
            _fail(items, e)
        self.stats.add("batches", 1)
        self.stats.add("batched_reqs", len(items))
        self.stats.peak("max_seen", len(items))

    def _run(self):
        import torch
        dev = self.model.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()), torch.inference_mode():
            self._loop()

    def _loop(self):
        pending = collections.deque()
        while True:
            if pending:
                try:
                    first = self.q.get_nowait()
                except queue.Empty:
                    self._finish(*pending.popleft())
                    continue
            else:
                first = self.q.get()
            if first is None:
                while pending:
                    self._finish(*pending.popleft())
                return
            items = self._collect(first)
            try:
                pending.append((items, self._dispatch(items)))
            except Exception as e:
                _fail(items, e)
                continue
            while len(pending) >= self.DEPTH:
                self._finish(*pending.popleft())


def _fail(items, err):
    for _, ev, slot in items:
        slot["err"] = repr(err)
        ev.set()


def _decode(raw: bytes, size: int):
    """Request bytes -> [size, size, 3] uint8 (PIL; bicubic resize)."""
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    if img.shape[0] != size or img.shape[1] != size:
        img = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
    return img


def _encode(img_u8: np.ndarray) -> bytes:
    from PIL import Image
    png = io.BytesIO()
    Image.fromarray(img_u8).save(png, "PNG")
    return png.getvalue()


def make_handler(cfg, model, size, stats, max_batch: int = 4,
                 window_ms: float = 3.0):
    """The request handler class; its `batcher` attribute owns the model."""
    batcher = Batcher(cfg, model, max_batch=max_batch, window_ms=window_ms,
                      stats=stats)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if not self.path.startswith("/healthz"):
                self._json(404, {"error": "unknown path"})
                return
            # device accounting: dev_t is the time the batcher waits on
            # the read-back of each batch
            uptime = time.perf_counter() - stats.get("t0", 0.0)
            dev_t = stats.get("dev_t", 0.0)
            n, batches = stats.get("n", 0), stats.get("batches", 0)
            self._json(200, {
                "status": "ok", "model": cfg.model_G, "input_size": size,
                "requests": n, "batches": batches,
                "max_batch_seen": stats.get("max_seen", 0),
                "mean_latency_ms": round(stats.get("t", 0.0) / max(n, 1) * 1e3, 2),
                "mean_device_ms_per_batch": round(dev_t / max(batches, 1) * 1e3, 2),
                "uptime_s": round(uptime, 1),
                "device_s_total": round(dev_t, 3),
                "batched_reqs_total": stats.get("batched_reqs", 0),
                "device_util_pct": round(100.0 * dev_t / max(uptime, 1e-9), 2),
                "device_req_s_ceiling": round(
                    stats.get("batched_reqs", 0) / max(dev_t, 1e-9), 2)})

        def do_POST(self):
            if not self.path.startswith("/dehaze"):
                self._json(404, {"error": "unknown path"})
                return
            t_in = time.perf_counter()
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = _decode(raw, size)
            except Exception as e:
                self._json(400, {"error": f"bad image: {e}"})
                return
            t0 = time.perf_counter()
            try:
                out = batcher.submit(img)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            t1 = time.perf_counter()
            stats.add("n", 1)
            stats.add("t", t1 - t0)
            body = _encode(_to_u8(out))
            t2 = time.perf_counter()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-Ms", f"{(t1 - t0) * 1e3:.1f}")
            # decode, queue + model, encode
            self.send_header("X-Decode-Ms", f"{(t0 - t_in) * 1e3:.1f}")
            self.send_header("X-Model-Ms", f"{(t1 - t0) * 1e3:.1f}")
            self.send_header("X-Encode-Ms", f"{(t2 - t1) * 1e3:.1f}")
            self.end_headers()
            self.wfile.write(body)

    Handler.batcher = batcher
    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--batch_window_ms", type=float, default=3.0)
    args, rest = ap.parse_known_args(argv)

    stats = Stats()
    cfg, model, size = build_model(rest)
    warm(cfg, model, size, args.max_batch)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(cfg, model, size, stats, max_batch=args.max_batch,
                     window_ms=args.batch_window_ms))
    print(f"serving {cfg.model_G} ({size}x{size}) on {model.device} at "
          f"http://{args.host}:{args.port} (max_batch={args.max_batch})",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
