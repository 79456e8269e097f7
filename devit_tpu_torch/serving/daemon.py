"""Serving daemon for the deployed collaborative ensemble (counterpart of
devit_tpu/serving/daemon.py:79-649).

One batcher thread owns the device: requests land in a queue, the batcher
coalesces everything that arrives within `max_wait_ms` of the oldest waiting
request, pads the batch up to a fixed bucket size and runs one forward.
Batches above the largest bucket are chunked.

Protocol (stdlib http.server; one POST = one or more images):

    POST /predict
      body:    raw uint8 RGB bytes, C-order
      headers: X-Image-Shape: "N,H,W,3" (or "H,W,3" for a single image)
      query:   ?topk=5 (optional, default ServeConfig.topk)
      reply:   {"predictions": [{"topk": [...], "probs": [...]}, ...],
                "latency_ms": float}
    POST /reload
      body:    {"ens_path": "<stage-5 checkpoint>"}: hot-swap the fusion head
               (same geometry only; 400 otherwise)
    GET /healthz   -> model/device info (also the readiness probe)
    GET /stats     -> request/image/batch counters + latency percentiles

`build_engine_from_artifacts` serves what the deploy stage wrote
(`sub-dataset{i}/compact.msgpack`) with a stage-5 fusion checkpoint, both
in the JAX package's msgpack format. Images are scaled by 1/255 once, as on
the offline eval path. (The JAX daemon divides by 255 twice; the port does
not reproduce that defect.) The engine serves through the collaborative
server (parallel/serve.py): with --device cuda and several visible cards a
division a card and the fusion on a spare one, as the JAX daemon does on
several chips, else everything on the one device; /healthz reports the
placement. `serve_main` is the `serve` subcommand; under several ranks rank
0 serves on its own card and the others return (one process serves over
every card).

The JAX daemon keeps an on-disk AOT cache of its compiled bucket programs
(io/aot_cache.py). The port compiles no bucket programs (only the CUDA
kernels, built once per source hash by kernels/_build.py), so there is
nothing to cache: ServeConfig.aot_cache None/False is accepted and True
raises. A counterpart comes only with CUDA graphs or AOTInductor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from torch.func import functional_call

from devit_tpu_torch.data.pipeline import normalize
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.io.bridge import ensmlp_from_jax_params
from devit_tpu_torch.io.checkpoint import restore_pytree
from devit_tpu_torch.models.compact_vit import CompactViT, load_compact
from devit_tpu_torch.models.ensemble import EnsMLP
from devit_tpu_torch.parallel.serve import make_collaborative_server, serving_devices
from devit_tpu_torch.runtime import is_main_process


@dataclasses.dataclass
class ServeConfig:
    input_size: int = 224
    patch_size: int = 16
    # batch buckets: requests pad up to the smallest bucket that fits, bigger
    # coalesced batches chunk at max()
    buckets: Tuple[int, ...] = (1, 8, 32, 128, 256)
    max_wait_ms: float = 5.0  # coalescing window from the OLDEST queued request
    topk: int = 5
    dtype: torch.dtype = torch.bfloat16
    use_kernel: bool = True  # the CUDA attention kernel (the JAX use_pallas)
    fast_math: bool = True  # serving default (parity runs: False)
    warmup: bool = True  # run every bucket once before accepting traffic
    # the JAX daemon's AOT executable cache: nothing to cache here (module
    # docstring); None (auto) and False are accepted, True raises
    aot_cache: Optional[bool] = None

    def __post_init__(self):
        if self.aot_cache:
            raise ValueError("aot_cache=True: the port compiles no bucket programs, so it "
                             "has no AOT cache (the CUDA kernels are built once per source "
                             "hash); use auto or off")


class InferenceEngine:
    """Bucketed forward over the compact divisions + EnsMLP fusion.

    `predict(uint8 images (N,S,S,3)) -> np.float32 logits (N,K)`; intended to
    be driven by the single MicroBatcher thread, with a lock serializing
    stray direct callers.
    """

    def __init__(self, cms: Sequence[CompactViT], ens: EnsMLP, cfg: ServeConfig,
                 *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_divisions = len(cms)
        self.num_classes = ens.num_classes
        self._ens_avals = _avals({k.replace(".", "/"): p for k, p in ens.named_parameters()})
        self._lock = threading.Lock()
        # the deployment topology (parallel/serve.py): a division a card and
        # the token fusion on a spare one where several cards serve, all on
        # self.device otherwise
        self.ens = ens
        self._serve = make_collaborative_server(
            list(cms), lambda ev, c, t: functional_call(self.ens, ev, (c, t)),
            dict(ens.named_parameters()), patch_size=cfg.patch_size,
            devices=serving_devices(self.device), dtype=cfg.dtype, use_kernel=cfg.use_kernel,
            fast_math=cfg.fast_math)
        self.cms = self._serve.placed_divisions
        self.division_devices = self._serve.division_devices
        self.fusion_device = self._serve.fusion_device
        self.ens = ens.to(self.fusion_device)

    @torch.inference_mode()
    def _run_bucket(self, images_u8: np.ndarray) -> np.ndarray:
        """One padded-bucket forward; images_u8 (n <= max bucket, S, S, 3)."""
        n = images_u8.shape[0]
        bucket = next(b for b in sorted(self.cfg.buckets) if b >= n)
        if n < bucket:
            pad = np.zeros((bucket - n,) + images_u8.shape[1:], np.uint8)
            images_u8 = np.concatenate([images_u8, pad], axis=0)
        # request bodies arrive as read-only views: torch wants writable memory
        img = torch.from_numpy(np.require(images_u8, requirements=("C", "W"))).to(
            self.division_devices[0])
        logits = self._serve(dict(self.ens.named_parameters()), normalize(img, torch.float32))
        return logits[:n].float().cpu().numpy()

    def predict(self, images_u8: np.ndarray) -> np.ndarray:
        """uint8 (N, S, S, 3) -> float32 logits (N, num_classes). N beyond the
        largest bucket is chunked."""
        s = self.cfg.input_size
        if images_u8.ndim != 4 or images_u8.shape[1:] != (s, s, 3):
            raise ValueError(
                f"predict expects (N,{s},{s},3) uint8, got {images_u8.shape}")
        if images_u8.dtype != np.uint8:
            raise ValueError(f"predict expects uint8 images, got {images_u8.dtype}")
        cap = max(self.cfg.buckets)
        with self._lock:
            outs = [self._run_bucket(images_u8[i:i + cap])
                    for i in range(0, images_u8.shape[0], cap)]
        return np.concatenate(outs, axis=0)

    def reload_fusion(self, ens_path: str) -> None:
        """Hot-swap the fusion head from a (newer) stage-5 checkpoint: the
        head retrains far more often than the frozen divisions. Structure,
        shapes and dtypes must match the serving head's (f32) parameters
        exactly; another geometry needs a new engine."""
        ckpt = restore_pytree(ens_path)
        if not isinstance(ckpt, dict):  # a valid msgpack of the wrong thing
            raise ValueError(f"{ens_path!r} is not a checkpoint dict "
                             f"(restored {type(ckpt).__name__})")
        params = ckpt.get("ens_params", ckpt.get("params", ckpt))
        new = _avals(_flat(params)) if isinstance(params, dict) else type(params).__name__
        if new != self._ens_avals:
            raise ValueError(f"reload checkpoint geometry (shape/dtype) differs from the "
                             f"serving fusion head: {new} vs {self._ens_avals} - restart to "
                             f"change geometry")
        ens = ensmlp_from_jax_params(params, num_divisions=self.num_divisions,
                                     dtype=self.ens.dtype, device=self.fusion_device)
        with self._lock:  # never swap mid-forward
            self.ens = ens

    def warm_up(self) -> float:
        """Run every bucket once before traffic: the kernels' first-use
        build and the first cuBLAS call at each shape. Returns the seconds it
        took."""
        t0 = time.perf_counter()
        s = self.cfg.input_size
        for b in sorted(self.cfg.buckets):
            self.predict(np.zeros((b, s, s, 3), np.uint8))
        return time.perf_counter() - t0


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict -> {"a/b/c": leaf}."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _avals(flat: dict) -> dict:
    """{path: leaf} -> {path: (shape, dtype name)} for numpy and torch leaves."""
    def aval(x):
        if isinstance(x, torch.Tensor):
            return tuple(x.shape), str(x.dtype).replace("torch.", "")
        x = np.asarray(x)
        return x.shape, x.dtype.name
    return {k: aval(v) for k, v in sorted(flat.items())}


def _host_resize(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision eval geometry on the host (PIL): Resize(int(256/224*size),
    bicubic, shorter edge) + CenterCrop(size)."""
    from PIL import Image

    if img.shape[0] == size and img.shape[1] == size:
        return img
    scale = int(256 / 224 * size)
    im = Image.fromarray(img)
    w, h = im.size
    if w <= h:
        nw, nh = scale, int(scale * h / w)
    else:
        nh, nw = scale, int(scale * w / h)
    im = im.resize((nw, nh), Image.BICUBIC)
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    return np.asarray(im.crop((left, top, left + size, top + size)), dtype=np.uint8)


class MicroBatcher:
    """Single device-owner thread coalescing concurrent requests.

    Requests (uint8 (n,S,S,3), Future) enter a queue; the loop takes the
    oldest request, drains everything that arrives within `max_wait_ms` of it
    (up to the largest bucket), runs ONE engine.predict over the
    concatenation, and splits the logits back per request."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "images": 0, "batches": 0, "coalesced": 0}
        self._latencies: deque = deque(maxlen=1024)  # seconds, per request
        self._lock = threading.Lock()  # guards stats + latencies vs snapshots
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="devit-batcher")

    def start(self) -> "MicroBatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.q.put(None)  # wake the blocking get
        if self._thread.is_alive():
            self._thread.join(timeout=10)
        # fail any request still queued: a waiter must get a prompt error
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server shutting down"))

    def submit(self, images_u8: np.ndarray) -> Future:
        fut: Future = Future()
        self.q.put((images_u8, fut, time.time()))
        return fut

    def _loop(self) -> None:
        cap = max(self.engine.cfg.buckets)
        wait = self.engine.cfg.max_wait_ms / 1000.0
        while not self._stop.is_set():
            item = self.q.get()
            if item is None:
                continue
            group = [item]
            total = item[0].shape[0]
            deadline = item[2] + wait
            while total < cap:
                try:
                    # requests that queued while the previous batch ran are
                    # ready at zero cost: always drain them
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    timeout = deadline - time.time()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self.q.get(timeout=timeout)
                    except queue.Empty:
                        break
                if nxt is None:
                    break
                group.append(nxt)
                total += nxt[0].shape[0]
            try:
                batch = (group[0][0] if len(group) == 1 else
                         np.concatenate([g[0] for g in group], axis=0))
                logits = self.engine.predict(batch)
            except Exception as e:  # deliver the failure to every waiter
                for _, fut, _ in group:
                    fut.set_exception(e)
                continue
            now = time.time()
            off = 0
            for imgs, fut, t0 in group:
                n = imgs.shape[0]
                fut.set_result(logits[off:off + n])
                off += n
            with self._lock:
                self._latencies.extend(now - t0 for _, _, t0 in group)
                self.stats["requests"] += len(group)
                self.stats["images"] += total
                self.stats["batches"] += 1
                self.stats["coalesced"] += len(group) > 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            out = dict(self.stats)
        pct = (lambda p: round(lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3, 3)
               ) if lat else (lambda p: None)
        out.update(latency_ms_p50=pct(0.50), latency_ms_p99=pct(0.99),
                   queue_depth=self.q.qsize())
        return out


def build_engine_from_artifacts(
    compact_path: str,
    ens_path: Optional[str] = None,
    *,
    num_divisions: Optional[int] = None,
    teacher_size: Optional[int] = 768,
    cfg: Optional[ServeConfig] = None,
    log: Optional[Callable[[str], None]] = print,
    device: DeviceLike = None,
) -> InferenceEngine:
    """Load the deploy stage's artifacts (`sub-dataset{i}/compact.msgpack`
    under compact_path) and the stage-5 fusion checkpoint, inferring the
    fusion geometry (classes, teacher width, family) from the checkpoint's
    own shapes, so serving needs no dataset. Without ens_path the head is
    random (smoke mode, drawn from seed 0: the JAX package draws its own
    with jax.random), with a warning."""
    cfg = cfg or ServeConfig()
    dev = resolve_device(device)
    if num_divisions is None:  # auto-discover contiguous sub-dataset{i}
        num_divisions = 0
        while os.path.exists(os.path.join(
                compact_path, f"sub-dataset{num_divisions}", "compact.msgpack")):
            num_divisions += 1
        if num_divisions == 0:
            raise FileNotFoundError(
                f"no sub-dataset0/compact.msgpack under {compact_path!r} - "
                "run `devit deploy` first")
    cms = [load_compact(os.path.join(compact_path, f"sub-dataset{i}", "compact.msgpack"),
                        device=dev) for i in range(num_divisions)]
    sub_size = cms[0].pos_embed.shape[-1]
    family = "deit" if cms[0].distilled else "vit"

    if ens_path:
        ckpt = restore_pytree(ens_path)
        ens_params = ckpt.get("ens_params", ckpt.get("params", ckpt))
        if "cls_mlp" in ens_params:
            km = ens_params["cls_mlp"]["kernel"]
            if km.shape[0] != num_divisions * sub_size:
                raise ValueError(
                    f"fusion checkpoint fuses {km.shape[0]} features but the "
                    f"compact artifacts provide {num_divisions}x{sub_size} - "
                    "wrong --ens-path / --compact-path pairing")
        ck_family = "deit" if "dist_classifier" in ens_params else "vit"
        if ck_family != family:
            raise ValueError(f"fusion checkpoint is {ck_family!r} but compact backbones "
                             f"are {family!r}")
        ens = ensmlp_from_jax_params(ens_params, num_divisions=num_divisions,
                                     dtype=cfg.dtype, device=dev)
    else:
        # smoke mode only: a random fusion head, predictions are meaningless
        if log:
            log("WARNING: no --ens-path; serving with a RANDOM fusion head "
                "(smoke mode, predictions are meaningless)")
        num_classes = (int(cms[0].head["head_kernel"].shape[-1])
                       if "head_kernel" in cms[0].head else 100)
        ens = EnsMLP(num_classes=num_classes, sub_size=sub_size, num_divisions=num_divisions,
                     teacher_size=teacher_size, family=family, dtype=cfg.dtype)
        ens = ens.reset_parameters(torch.Generator().manual_seed(0))

    engine = InferenceEngine(cms, ens, cfg, device=dev)
    if log:
        log(f"engine: {num_divisions} divisions (sub_size {sub_size}, {family}), "
            f"{engine.num_classes} classes, buckets {sorted(cfg.buckets)}, on {engine.device}")
    return engine


class _Handler(BaseHTTPRequestHandler):
    # set per server by build_server
    batcher: MicroBatcher = None
    engine: InferenceEngine = None
    started: float = 0.0

    def log_message(self, fmt, *args):  # no line on stderr per request
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            e = self.engine
            self._json(200, {
                "status": "ok",
                "num_divisions": e.num_divisions,
                "num_classes": e.num_classes,
                "input_size": e.cfg.input_size,
                "buckets": sorted(e.cfg.buckets),
                "device": str(e.device),
                "division_devices": [str(d) for d in e.division_devices],
                "fusion_device": str(e.fusion_device),
                "uptime_s": round(time.time() - self.started, 1),
            })
        elif path == "/stats":
            self._json(200, self.batcher.snapshot())
        else:
            self._json(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path == "/reload":
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                path = body.get("ens_path") if isinstance(body, dict) else None
                if not isinstance(path, str):
                    raise ValueError("body must be a JSON object with string 'ens_path'")
                self.engine.reload_fusion(path)
            except json.JSONDecodeError as e:
                return self._json(400, {"error": f"invalid JSON body: {e}"})
            except (ValueError, OSError) as e:  # FileNotFoundError is an OSError
                return self._json(400, {"error": str(e)})
            return self._json(200, {"status": "reloaded", "ens_path": path})
        if url.path != "/predict":
            return self._json(404, {"error": f"unknown path {url.path!r}"})
        t0 = time.time()
        try:
            shape = tuple(int(v) for v in
                          self.headers.get("X-Image-Shape", "").split(","))
            if len(shape) == 3:
                shape = (1,) + shape
            if len(shape) != 4 or shape[-1] != 3 or any(v <= 0 for v in shape):
                raise ValueError(
                    "X-Image-Shape must be 'N,H,W,3' or 'H,W,3' (uint8 RGB)")
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            expect = int(np.prod(shape))
            if len(raw) != expect:
                raise ValueError(
                    f"body is {len(raw)} bytes, shape {shape} needs {expect}")
            imgs = np.frombuffer(raw, np.uint8).reshape(shape)
            s = self.engine.cfg.input_size
            if imgs.shape[1] != s or imgs.shape[2] != s:
                imgs = np.stack([_host_resize(i, s) for i in imgs])
            q = parse_qs(url.query)
            topk = min(int(q.get("topk", [self.engine.cfg.topk])[0]),
                       self.engine.num_classes)
            if topk <= 0:
                raise ValueError("topk must be >= 1")
        except (ValueError, OverflowError) as e:
            return self._json(400, {"error": str(e)})
        try:
            logits = self.batcher.submit(imgs).result(timeout=600)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})
        # softmax + topk on the host: K floats per image
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        idx = np.argsort(-logits, axis=-1)[:, :topk]
        self._json(200, {
            "predictions": [
                {"topk": r.tolist(), "probs": np.round(p[i, r], 6).tolist()}
                for i, r in enumerate(idx)],
            "latency_ms": round((time.time() - t0) * 1e3, 3),
        })


def build_server(engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 0) -> Tuple[ThreadingHTTPServer, MicroBatcher]:
    """Wire engine + batcher into a ThreadingHTTPServer (not started).
    port=0 binds an ephemeral port; callers run serve_forever()."""
    batcher = MicroBatcher(engine).start()
    handler = type("Handler", (_Handler,), {
        "batcher": batcher, "engine": engine, "started": time.time()})
    return ThreadingHTTPServer((host, port), handler), batcher


def serve_main(args, ready: Optional[Callable[[ThreadingHTTPServer], None]] = None) -> None:
    """The `serve` subcommand: the engine over --compact-path (and
    --ens-path), warmed up unless --no-warmup, behind the HTTP server until
    interrupted. `ready(httpd)`, when given, is called once the server is
    bound and before it serves; another thread stops it with
    httpd.shutdown()."""
    buckets = tuple(sorted({int(b) for b in args.buckets.split(",")}))
    if any(b <= 0 for b in buckets):
        raise ValueError(f"--buckets must be positive ints, got {args.buckets}")
    from devit_tpu_torch import runtime
    from devit_tpu_torch.cli import common as C

    runtime.setup_runtime(getattr(args, "device", "cuda"))
    if not is_main_process():
        # one server a launch, on rank 0's card; the other ranks have
        # nothing to serve
        print(f"rank {runtime.rank()}: serving runs on rank 0", flush=True)
        return
    device = C.device_from_args(args)
    use_kernel = getattr(args, "use_pallas", None)
    cfg = ServeConfig(
        input_size=args.input_size, patch_size=args.patch_size, buckets=buckets,
        max_wait_ms=args.max_wait_ms, topk=args.topk, dtype=C.dtype_from_args(args),
        use_kernel=device.type == "cuda" if use_kernel is None else use_kernel,
        fast_math=not args.no_fast_math, warmup=not args.no_warmup,
        aot_cache={"auto": None, "on": True, "off": False}[getattr(args, "aot_cache", "auto")])
    engine = build_engine_from_artifacts(
        args.compact_path, args.ens_path,
        num_divisions=args.num_division if args.num_division > 0 else None,
        teacher_size=args.teacher_size, cfg=cfg, device=device)
    if cfg.warmup:
        print(f"warmup: {len(buckets)} buckets ...", flush=True)
        print(f"warmup done in {engine.warm_up():.1f}s", flush=True)
    httpd, batcher = build_server(engine, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"devit-torch serving on http://{host}:{port} (POST /predict, GET /healthz, "
          f"GET /stats)", flush=True)
    try:
        if ready is not None:
            ready(httpd)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.stop()
