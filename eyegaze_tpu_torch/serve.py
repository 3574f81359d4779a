"""HTTP front end for the port's served models.

    python -m eyegaze_tpu_torch.serve --checkpoint model.pt [--dynamic-batch]

The counterpart of the JAX package's ``scripts/serve.py``, with all its
kinds: ``eeg`` (the flagship ``Predictor``), ``gaze`` (the early- and
late-fusion ViTs and the datafusion ViT, ``GazePredictor``), ``art``
(``ArtDenoiser``), ``multimodal`` (the fuzzy-gating composite,
``MultimodalPredictor``) and ``hypereeg`` (``HyperEEGPredictor``).  It
loads one checkpoint with ``from_checkpoint`` (bf16 compute; ``model.pt`` is
the reference-named state_dict that ``scripts/export_torch_checkpoint.py``
writes, with the orbax checkpoint's ``.meta.json`` copied to
``model.meta.json``), runs every bucket once unless ``--no-warmup``, and
serves:

  GET  /healthz   -> {"status": "ok", "kind": ...}
  GET  /info      -> kind, buckets, checkpoint path, inputs and their shapes
  GET  /metrics   -> request and error counts, p50/p90/p99 latency over the
                     last 1024 requests, the dynamic batcher's counters
  POST /predict   -> an ``.npz`` body with the kind's input arrays; the answer
                     is JSON, or ``.npz`` with ``?format=npz``

Inputs, batched on the leading axis, any N:

  eeg         eeg1, eeg2               (N, C, T) float32 trial pairs
  gaze        img1, img2               (N, 3, S, S) uint8 image pairs, S the
                                       model's img_size
  art         noisy                    (N, C, T) float32
  multimodal  img1, img2, eeg1, eeg2   the gaze pairs and (N, C, T) float32
                                       EEG windows
  hypereeg    eeg1, eeg2               (N, C, T) float32 windowed pairs

It serves on a CUDA card unless ``--device cpu`` is passed; without a card
it stops at once.  Device work is serialised by one lock (or by the dynamic
batcher's thread): concurrency belongs in the batch axis.

``--mesh [spec]`` ("dp" when no spec is given; "dpN", "tpN", "dpN,tpM")
serves on a mesh (``serving``'s docstring): the ranks are started with
``parallel.launch``, one per card (dp x tp gloo ranks with ``--device
cpu``; a spec that needs more cards than there are raises before anything
is built).  Rank 0, in this process, runs the HTTP front end, the dynamic
batcher and ``/metrics``; each dispatch goes to every rank first
(``serving.MeshDispatch``), and a stop header ends the other ranks' loop
when the server shuts down.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from eyegaze_tpu_torch import parallel, serving

REQUIRED_INPUTS = {"eeg": ("eeg1", "eeg2"), "gaze": ("img1", "img2"), "art": ("noisy",),
                   "multimodal": ("img1", "img2", "eeg1", "eeg2"), "hypereeg": ("eeg1", "eeg2")}
# Kinds the JAX package serves that the port does not serve yet: none left.
NOT_PORTED = ()


def sniff_kind(state_path: Path) -> str:
    """The kind of a checkpoint: from its meta as the JAX ``sniff_kind``
    reads it (the multimodal and HyperEEG stamps, the gaze ``kind`` stamp,
    ArtConfig-only fields, else the flagship), and without a meta from the
    state_dict's keys: the composite's ``gaze_encoder.``, ART's
    reconstructor, a fusion ViT's ``backbone.`` or ``encoder.``, the
    flagship's positional table, a bare (datafusion) ViT's root-level patch
    embed, HyperEEG's temporal block and classifier."""
    mc = serving.read_meta(state_path).get("config", {}).get("model", {})
    if mc:
        if "multimodal" in mc:
            return "multimodal"
        if "hypereeg" in mc:
            return "hypereeg"
        if mc.get("kind") in ("early", "late", "datafusion"):
            return "gaze"
        if "embedding_size" in mc or "num_decoder_layers" in mc:
            return "art"
        return "eeg"
    state = torch.load(state_path, map_location="cpu", weights_only=True)
    if "gaze_encoder.backbone.cls_token" in state:
        return "multimodal"
    if "reconstructor.proj.weight" in state:
        return "art"
    if "backbone.cls_token" in state or "encoder.cls_token" in state:
        return "gaze"
    if "cls_token" in state and "pos_embed.pos_embed.weight" in state:
        return "eeg"
    if "cls_token" in state and "patch_embed.proj.weight" in state:
        return "gaze"
    if "temporal.proj.weight" in state and "cls1.weight" in state:
        return "hypereeg"
    raise SystemExit(f"cannot tell the kind of {state_path} (no meta, and its keys are not the "
                     "flagship's, a gaze ViT's, ART's, the composite's or HyperEEG's); pass "
                     "--kind")


def build_predictor(kind: str, state_path: Path, buckets, device: torch.device, mesh=None):
    if kind in NOT_PORTED:
        raise SystemExit(f"kind {kind!r} is not yet ported to eyegaze_tpu_torch; it serves "
                         f"{sorted(REQUIRED_INPUTS)}")
    cls = {"eeg": serving.Predictor, "gaze": serving.GazePredictor,
           "art": serving.ArtDenoiser, "multimodal": serving.MultimodalPredictor,
           "hypereeg": serving.HyperEEGPredictor}[kind]
    return cls.from_checkpoint(state_path, device=device, batch_buckets=tuple(buckets),
                               mesh=mesh)


def input_spec(kind: str, predictor) -> dict:
    """Each input's expected shape (a string where any size goes), read off
    the loaded model, so a client can check before it posts."""
    m = predictor.model
    if kind == "art":
        return {"noisy": ["N", m.config.in_channels, f"T<={m.config.max_len}"]}
    if kind == "gaze":
        return {k: ["N", 3, m.img_size, m.img_size] for k in ("img1", "img2")}
    if kind == "multimodal":
        return {**{k: ["N", 3, m.img_size, m.img_size] for k in ("img1", "img2")},
                **{k: ["N", m.eeg_in_channels, "T"] for k in ("eeg1", "eeg2")}}
    return {k: ["N", m.in_channels, "T"] for k in ("eeg1", "eeg2")}  # eeg, hypereeg


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that holds a burst of
    concurrent clients: at socketserver's default of 5, the connections
    beyond it are dropped and each client retries a second later."""

    request_queue_size = 128


def _to_jsonable(out: dict) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in out.items()}


def _to_npz_bytes(out: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in out.items()})
    return buf.getvalue()


class _LatencyStats:
    """Request and error counts, and the latencies of the last ``size``
    requests -> p50/p90/p99, under a lock."""

    def __init__(self, size: int = 1024):
        self._lat: list[float] = []
        self._size = size
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0

    def record(self, ms: float, error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            self.errors += error
            self._lat.append(ms)
            del self._lat[:-self._size]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {"requests": self.requests, "errors": self.errors}
        for p in (50, 90, 99) if lat else ():
            out[f"latency_p{p}_ms"] = round(lat[min(len(lat) - 1, int(len(lat) * p / 100))], 2)
        return out


def make_handler(kind: str, predictor, state_path: Path, batcher=None):
    required = REQUIRED_INPUTS[kind]
    lock = threading.Lock()
    stats = _LatencyStats()
    spec = input_spec(kind, predictor)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # one line per request below instead
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"status": "ok", "kind": kind})
            elif path == "/info":
                info = {"kind": kind, "checkpoint": str(state_path),
                        "device": str(predictor.device),
                        "batch_buckets": list(predictor.buckets), "inputs": list(required),
                        "input_spec": spec}
                if batcher is not None:
                    info["dynamic_batch"] = {"max_wait_ms": batcher.max_wait * 1e3,
                                             "max_batch": batcher.max_batch,
                                             **batcher.public_stats()}
                self._send_json(200, info)
            elif path == "/metrics":
                metrics = stats.snapshot()
                if batcher is not None:
                    metrics["dynamic_batch"] = batcher.public_stats()
                self._send_json(200, metrics)
            else:
                self._send_json(404, {"error": f"unknown path {path!r}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._send_json(404, {"error": f"unknown path {url.path!r}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                arrays = dict(np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False))
            except Exception as e:  # noqa: BLE001 — a malformed body is the client's fault
                self._send_json(400, {"error": f"bad npz body: {e}"})
                return
            missing = [k for k in required if k not in arrays]
            if missing:
                self._send_json(400, {"error": f"missing input arrays {missing} (kind={kind!r} "
                                               f"needs {list(required)})"})
                return
            for k in required:  # refuse a mis-shaped input before any device work
                want, have = spec[k], arrays[k].shape
                if len(have) != len(want) or any(
                        w != h for w, h in zip(want, have) if isinstance(w, int)):
                    self._send_json(400, {"error": f"{k}: shape {list(have)} does not match "
                                                   f"expected {want} (see /info)"})
                    return
            if len({len(arrays[k]) for k in required}) != 1:
                self._send_json(400, {"error": "input arrays disagree on batch size"})
                return
            t0 = time.perf_counter()
            try:
                if batcher is not None:  # its thread is the device's one caller
                    out = batcher.predict(*[arrays[k] for k in required])
                else:
                    with lock:
                        out = predictor.predict(*[arrays[k] for k in required])
            except Exception as e:  # noqa: BLE001 — answered as a 500, the server keeps serving
                stats.record((time.perf_counter() - t0) * 1e3, error=True)
                self._send_json(500, {"error": f"predict failed: {e}"})
                return
            ms = (time.perf_counter() - t0) * 1e3
            stats.record(ms)
            if parse_qs(url.query).get("format", ["json"])[0] == "npz":
                self._send(200, _to_npz_bytes(out), "application/x-npz")
            else:
                self._send_json(200, _to_jsonable(out))
            print(f"[serve] n={len(arrays[required[0]])} {ms:.1f} ms", flush=True)

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--checkpoint", required=True, type=Path,
                    help="state_dict written by scripts/export_torch_checkpoint.py; its meta "
                         "is read from the same path with the suffix .meta.json")
    ap.add_argument("--kind", choices=sorted(REQUIRED_INPUTS) + list(NOT_PORTED), default=None,
                    help="model kind (default: from the meta, else from the state_dict keys)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' must be asked for)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", default="1,8,32", help="comma-separated batch buckets")
    ap.add_argument("--warmup", action="store_true", default=True,
                    help="run every bucket once before serving (the default)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip the warm-up: the first request of each bucket pays it")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="multi-chip serving: 'dp' shards request batches "
                         "over all local devices; 'dpN,tpM' also shards the "
                         "transformer matmuls (tensor parallel) to cut "
                         "per-request latency")
    ap.add_argument("--dynamic-batch", nargs="?", const=5.0, type=float, default=None,
                    metavar="MAX_WAIT_MS",
                    help="coalesce concurrent requests into one dispatch, waiting at most "
                         "MAX_WAIT_MS (default 5) for co-travellers")
    return ap.parse_args(argv)


# rank 0's ``ready`` under --mesh: rank 0 runs in this process (parallel.launch's
# ``here``), and a callable does not pickle to the other ranks.
_READY = None


def _serve_rank(rank, world, device, args, kind):
    group = serving.request_group()
    predictor = build_predictor(kind, args.checkpoint, _buckets(args), device, mesh=args.mesh)
    if args.warmup:
        predictor.warmup()
    if rank:
        serving.follow_requests(predictor, group)
        return None
    dispatch = serving.MeshDispatch(predictor, group)
    try:
        return _serve(args, kind, dispatch, _READY)
    finally:
        dispatch.close()


def _buckets(args) -> tuple:
    return tuple(int(b) for b in args.buckets.split(","))


def main(argv=None, ready=None):
    """Parses ``argv``, loads the checkpoint and serves until the server is
    shut down; returns the server.  ``ready``, if given, is called with the
    bound server before it serves (a caller in another thread learns the
    port and can call ``shutdown``).  ``--mesh``: rank 0 serves in this
    process, the other ranks in spawned ones (module docstring)."""
    global _READY
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eyegaze_tpu_torch.serve needs a CUDA device; pass --device cpu to "
                         "serve on the CPU")
    kind = args.kind or sniff_kind(args.checkpoint)
    if args.mesh:
        world = parallel.mesh_world(args.mesh, device)
        print(f"[serve] loading the {kind!r} predictor from {args.checkpoint} on mesh "
              f"{args.mesh!r}: {world} ranks on {device}", flush=True)
        _READY = ready
        try:
            # Ranks sharing one indexed card meet through gloo.
            backend = "gloo" if device.index is not None else None
            return parallel.launch(_serve_rank, world, args, kind, device=device,
                                   backend=backend, here=True)[0]
        finally:
            _READY = None
    print(f"[serve] loading the {kind!r} predictor from {args.checkpoint} onto {device}",
          flush=True)
    predictor = build_predictor(kind, args.checkpoint, _buckets(args), device)
    if args.warmup:
        t0 = time.perf_counter()
        predictor.warmup()
        print(f"[serve] warmed {len(predictor.buckets)} buckets in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return _serve(args, kind, predictor, ready)


def _serve(args, kind: str, predictor, ready):
    """The HTTP front end over ``predictor`` until it is shut down."""
    batcher = None
    if args.dynamic_batch is not None:
        batcher = serving.DynamicBatcher(predictor, max_wait_ms=args.dynamic_batch)
        print(f"[serve] dynamic batching: max_wait={args.dynamic_batch} ms, "
              f"max_batch={batcher.max_batch}", flush=True)

    server = _HTTPServer((args.host, args.port),
                         make_handler(kind, predictor, args.checkpoint, batcher))
    print(f"[serve] listening on http://{args.host}:{server.server_address[1]} "
          f"(kind={kind}, buckets={list(predictor.buckets)})", flush=True)
    try:
        if ready is not None:
            ready(server)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
    return server


if __name__ == "__main__":
    main()
