"""HTTP relighting server with micro-batching, on the card.

    python -m geomconsistentfr_torch.serve --checkpoint model.pth --port 8400 [--warmup]

Port of geomconsistentfr_tpu/serve.py. Endpoints:

  POST /relight   {"image": <base64 PNG>, "mask": <base64 PNG>,
                   "light": [lx, ly, lz] | "light_preset": "multipie_14",
                   "ambient": 0.5, "precision": "draft" (optional per-request
                   tier; requests coalesce per tier), "format": "jpeg"
                   (optional response codec, default "png"; "quality": 90)}
                  -> {"rendered": <base64>, "shadow_mask": <base64>, "format": ...}
  POST /estimate  {"image": <base64 PNG>} -> {"direction": [...], "ambient": a}
  POST /transfer  {"image", "reference", "mask"} -> /relight's reply plus the
                  estimated "direction" and "ambient" (two passes)
  GET  /healthz   -> {"status": "ok"}
  GET  /statz     -> the serving counters (requests per tier and format,
                     batches, padded rows, device seconds, pipelined batches)

Images are decoded and encoded through utils/io's codec (OpenCV, imageio, or
the port's own PNG codec). A JPEG response goes through libjpeg in the port's
native loader (data/native_loader.py, the JAX server's encoder), else OpenCV,
else Pillow; where none works the request gets a 400 that says so, never a
PNG in its place.

Handler threads decode, validate and encode; all device work goes through
one worker thread (`MicroBatcher`), which coalesces /relight requests into a
batch padded to one of two sizes (the minimum, 1 without a mesh, for idle
traffic and --max-batch for bursts) and runs /estimate between batches.
When more than --max-batch requests wait, the worker pipelines: batch N's
packed visuals copy into pinned host memory (`infer.AsyncFetch`) while batch
N+1 is assembled and dispatched. A handler waits on its future with a
timeout and returns 503 if the worker wedges or dies. SIGTERM and SIGINT
close the listener, answer every admitted request, then exit.

The server runs on CUDA unless given `--device cpu`, and raises without a
card. `--checkpoint` takes a reference .pth or an orbax checkpoint directory.

Several ranks, one process each, under torchrun:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m geomconsistentfr_torch.serve --checkpoint model.pth --data-parallel

--data-parallel shards each batch over the ranks (--max-batch a multiple of
the world), --sample-parallel shards the shadow march's t grid, and
--grid-parallel DxS does both on a D x S mesh (D * S the world size); they
are mutually exclusive (geomconsistentfr_tpu/serve.py:682-734). Rank 0
binds the port, runs the handlers and the MicroBatcher, and prints the
`serving` line. Its device calls go through a relay (`RankRelay`): before
each forward_visuals or estimate_lighting of a tier's Relighter runs on
rank 0, the relay broadcasts over the gloo control group
(parallel/distributed.control_group) a header (the op, the tier, the
inputs' dtypes and shapes) and then the inputs. Every other rank runs
`follow`: it makes the same call on its own Relighter of that tier, so the
collectives inside the forwards pair up, and drops the result. Broadcasts go
out in dispatch order, so pipelining stays on. After rank 0's drain a `stop`
message ends the followers, which exit 0; they ignore SIGTERM and SIGINT
(torchrun forwards SIGTERM to every rank), since a follower that died
mid-collective would hang rank 0's drain for distributed.TIMEOUT. The HTTP
surface and its answers are the single-process server's. JAX drives every
device from one process, so this relay has no JAX counterpart.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from geomconsistentfr_torch.config import PRECISION_TIERS
from geomconsistentfr_torch.infer import AsyncFetch
from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS
from geomconsistentfr_torch.utils import io as image_io


def _decode_image(b64: str, size: int) -> np.ndarray:
    """A base64 image as uint8 RGB (size, size, 3); the device divides by 255."""
    return image_io.as_rgb_u8(image_io.decode_image(base64.b64decode(b64)), size)


def _encode_image(img: np.ndarray, fmt: str = "png", quality: int = 90) -> str:
    """A uint8 (or [0, 1] float) image as base64 PNG or JPEG."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)
    data = image_io.encode_jpeg(img, quality) if fmt == "jpeg" else image_io.encode_png(img)
    return base64.b64encode(data).decode()


def _parse_format(req: dict) -> tuple[str, int]:
    """Validate the optional "format" ('png' | 'jpeg') and "quality" (1-100)."""
    fmt = req.get("format", "png")
    if fmt not in ("png", "jpeg"):
        raise ValueError(f"unknown format {fmt!r} (use 'png' or 'jpeg')")
    quality = int(req.get("quality", 90))
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in [1, 100], got {quality}")
    return fmt, quality


class WorkerDied(RuntimeError):
    """The device worker thread exited; the server cannot serve device work."""


def _parse_tier(req: dict):
    """Validate the optional per-request "precision" in the handler thread, so a
    bad value can only 400 its own caller."""
    tier = req.get("precision")
    if tier is not None and tier not in PRECISION_TIERS:
        raise ValueError(f"unknown precision {tier!r} (use one of {PRECISION_TIERS})")
    return tier


class MicroBatcher:
    """One device-worker thread: it coalesces /relight into padded batches and
    runs /estimate between them, so all device work goes through it.

    submit() and submit_estimate() block the calling handler thread (with a
    timeout) until their share of the device work is ready. For relights the
    worker drains the queue for up to window_ms after the first request, pads
    the batch to min_batch or max_batch, runs one forward_visuals and hands
    each request its row through a Future.

    When more than max_batch requests are outstanding, consecutive batches
    pipeline: the worker dispatches batch N+1 before it waits for batch N's
    copy to the host (pipeline=False fetches each batch before the next).
    """

    def __init__(self, relighter, max_batch: int = 8, window_ms: float = 4.0,
                 request_timeout_s: float = 120.0, tier_pool=None, pipeline: bool = True):
        # tier_pool: a callable tier -> Relighter for per-request "precision",
        # called here by the worker thread only. The default relighter serves
        # requests that name no tier.
        self.relighter = relighter
        self._tier_pool = tier_pool
        self.max_batch = max_batch
        # A relighter that shards the batch over a mesh needs every batch a
        # multiple of the batch axis; sample-parallel ones replicate the batch.
        mesh = getattr(relighter, "mesh", None)
        mode = getattr(relighter, "parallel", "data")
        if mesh is None or mode == "samples":
            self.min_batch = 1
        elif mode == "grid":
            self.min_batch = mesh.axis_size(mesh.axis_names[0])
        else:
            self.min_batch = mesh.size
        if max_batch % self.min_batch:
            raise ValueError(f"max_batch {max_batch} must be a multiple of the mesh's batch axis {self.min_batch}")
        self.window_s = window_ms / 1000.0
        self.request_timeout_s = request_timeout_s
        self.pipeline = pipeline
        self._queue: "queue.Queue" = queue.Queue()
        # Written only by the worker thread (per_format by the handlers, under
        # a lock); handlers read them for /statz.
        self.stats = {
            "relight_requests": 0,
            "estimate_requests": 0,
            "batches": 0,
            "batched_rows": 0,       # real rows, without the padding
            "padded_rows": 0,        # rows sent to the device
            "device_seconds": 0.0,   # CUDA events: from each dispatch to its copy's end
            "pipelined_batches": 0,  # batches dispatched while one was pending
            "errors": 0,
            "per_tier": {},          # tier -> requests ('' = the default)
            "per_format": {},        # response format -> requests
        }
        self._fmt_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def note_format(self, fmt: str) -> None:
        with self._fmt_lock:
            pf = self.stats["per_format"]
            pf[fmt] = pf.get(fmt, 0) + 1

    def _submit(self, kind: str, payload) -> Future:
        if not self._thread.is_alive():
            raise WorkerDied("device worker thread is not running")
        fut: Future = Future()
        self._queue.put((kind, payload, fut))
        return fut

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until every queued and in-flight request has resolved; True if all did.

        Graceful shutdown closes the listener first, then calls this, so no
        admitted request is dropped."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return self._queue.unfinished_tasks == 0

    def submit(self, image, mask, light, ambient, tier=None):
        """image (H, W, 3), mask (H, W), light (3,), ambient -> (rendered (H, W, 3), weights (H, W)) uint8.

        tier: an optional precision-tier override (needs a tier_pool)."""
        if tier is not None and self._tier_pool is None:
            raise ValueError("per-request precision overrides are not enabled on this server")
        fut = self._submit("relight", (image, mask, light, ambient, tier))
        return fut.result(timeout=self.request_timeout_s)

    def submit_estimate(self, image):
        """image (H, W, 3) -> (unit direction (3,), ambient)."""
        fut = self._submit("estimate", image)
        return fut.result(timeout=self.request_timeout_s)

    def _worker(self):
        # At most one batch is pending: dispatched, its copy to the host in
        # flight. It is fetched once the next batch is dispatched, or when the
        # queue is empty.
        pending = None
        while True:
            try:
                kind, payload, fut = self._queue.get(block=pending is None)
            except queue.Empty:
                pending = self._flush(pending)
                continue
            if kind == "estimate":
                pending = self._flush(pending)  # earlier relights first
                self._estimate(payload, fut)
                continue
            gets = 1  # task_done() once per get(), deferred to _flush
            tier = payload[4]
            items = [(payload, fut)]
            deadline = time.monotonic() + self.window_s
            while len(items) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    k2, p2, f2 = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if k2 == "relight" and p2[4] == tier:
                    items.append((p2, f2))
                    gets += 1
                else:
                    # Estimates and other tiers wait for the next iteration;
                    # the re-put counts a task of its own, so this get is done.
                    self._queue.put((k2, p2, f2))
                    self._queue.task_done()
                    break
            nxt = self._dispatch_relight_batch(items, gets, tier, pipelined=pending is not None)
            pending = self._flush(pending)
            if self.pipeline:
                pending = nxt
            else:
                self._flush(nxt)

    def _estimate(self, image, fut) -> None:
        try:
            self.stats["estimate_requests"] += 1
            t0 = time.monotonic()
            batch = np.repeat(image[None], self.min_batch, axis=0)
            unit, ambient = self.relighter.estimate_lighting(batch)
            result = (unit[0].cpu().numpy(), float(ambient[0]))  # waits for the device
            self.stats["device_seconds"] += time.monotonic() - t0
            fut.set_result(result)
        except BaseException as e:  # noqa: BLE001 - the worker must survive; each caller gets its error
            self.stats["errors"] += 1
            if not fut.done():
                fut.set_exception(e if isinstance(e, Exception) else WorkerDied(repr(e)))
        finally:
            self._queue.task_done()  # after the future resolves, so drain() sees it answered

    def _dispatch_relight_batch(self, items, gets, tier=None, pipelined=False):
        """Stack and dispatch one padded batch and start its copy to the host.
        Returns the pending record for _flush, or None (the futures failed)."""
        n = len(items)
        padded = self.min_batch if n <= self.min_batch else self.max_batch
        st = self.stats
        st["relight_requests"] += n
        st["batches"] += 1
        st["batched_rows"] += n
        st["padded_rows"] += padded
        key = tier or ""
        st["per_tier"][key] = st["per_tier"].get(key, 0) + n
        try:
            relighter = self.relighter if tier is None else self._tier_pool(tier)

            def stack(i):
                # Images and masks stay uint8 (divided by 255 on the device).
                rows = [np.asarray(it[0][i]) for it in items]
                rows += [rows[-1]] * (padded - n)
                out = np.stack(rows)
                return out if out.dtype == np.uint8 else out.astype(np.float32)

            fetch = AsyncFetch(relighter.device)
            fetch.copy(relighter.forward_visuals(stack(0), stack(1), target_light=stack(2), target_ambient=stack(3)))
            if pipelined:
                st["pipelined_batches"] += 1
            return {"fetch": fetch, "items": items, "gets": gets}
        except BaseException as e:  # noqa: BLE001 - each caller of the batch gets the error
            st["errors"] += 1
            err = e if isinstance(e, Exception) else WorkerDied(repr(e))
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(err)
            for _ in range(gets):
                self._queue.task_done()
            return None

    def _flush(self, pending):
        """Wait for a dispatched batch's copy, resolve its futures, and only then
        mark its queue entries done. Returns None."""
        if pending is None:
            return None
        st = self.stats
        try:
            pack, seconds = pending["fetch"].wait()
        except BaseException as e:  # noqa: BLE001 - each caller of the batch gets the error
            st["errors"] += 1
            err = e if isinstance(e, Exception) else WorkerDied(repr(e))
            for _, fut in pending["items"]:
                if not fut.done():
                    fut.set_exception(err)
        else:
            st["device_seconds"] += seconds
            for k, (_, fut) in enumerate(pending["items"]):
                fut.set_result((pack[k, ..., 0:3], pack[k, ..., 3]))
        finally:
            for _ in range(pending["gets"]):
                self._queue.task_done()
        return None


def make_tier_pool(cfg, relighter, default_tier: str, wrap=None):
    """A lazy tier -> Relighter factory for per-request precision.

    Each tier's Relighter is built once, on the default relighter's weights,
    device, mesh and parallel mode (JAX serve.py:422-445), so a tier runs
    sharded as the default does; the default tier maps to that relighter.
    `wrap(tier, relighter)`, where given, wraps each new one (rank 0's relay).
    The worker thread calls it (and `main`'s warm-up, before the server
    listens; a follower rank's loop), so the cache needs no lock."""
    from geomconsistentfr_torch.config import apply_precision_tier
    from geomconsistentfr_torch.infer import Relighter

    cache = {default_tier: relighter}

    def tier_pool(t: str):
        if t not in cache:
            rl = Relighter(apply_precision_tier(cfg, t), relighter.model.state_dict(),
                           use_skips=relighter.use_skips, device=relighter.device, mesh=relighter.mesh,
                           parallel=relighter.parallel)
            cache[t] = rl if wrap is None else wrap(t, rl)
        return cache[t]

    tier_pool.built = cache  # the tiers built so far (tier_meshes reads it)
    return tier_pool


def tier_meshes(tier_pool) -> dict:
    """Each built tier's ranks and parallel mode, for the server's last line."""
    return {t: {"ranks": 1 if rl.mesh is None else rl.mesh.size, "parallel": rl.parallel}
            for t, rl in sorted(tier_pool.built.items())}


# The relay's messages: the op, the tier's index in PRECISION_TIERS, the
# number of inputs, then each input's dtype code, rank and four dimensions.
_OPS = ("stop", "forward_visuals", "estimate_lighting")
_DTYPES = (torch.uint8, torch.float32)
_MAX_INPUTS, _MAX_DIMS = 4, 4
_HEADER = 3 + _MAX_INPUTS * (2 + _MAX_DIMS)


class RankRelay:
    """Rank 0's side of a multi-rank server: each device call of a wrapped
    Relighter is broadcast over `group` (the control group) before it runs.
    `send` holds a lock, so a message's header and inputs go out together."""

    def __init__(self, group):
        self.group = group
        self._lock = threading.Lock()
        self.stopped = False

    def send(self, op: str, tier: str, inputs=()) -> None:
        arrays = [np.asarray(x) for x in inputs]
        arrays = [np.ascontiguousarray(a if a.dtype == np.uint8 else a.astype(np.float32)) for a in arrays]
        header = [_OPS.index(op), PRECISION_TIERS.index(tier) if tier else -1, len(arrays)]
        if len(arrays) > _MAX_INPUTS or any(a.ndim > _MAX_DIMS for a in arrays):
            raise ValueError(f"the relay carries at most {_MAX_INPUTS} inputs of rank {_MAX_DIMS} or less")
        for a in arrays:
            code = 0 if a.dtype == np.uint8 else 1
            header += [code, a.ndim, *a.shape, *([0] * (_MAX_DIMS - a.ndim))]
        header += [0] * (_HEADER - len(header))
        with self._lock:
            if self.stopped:
                raise WorkerDied("the follower ranks were stopped")
            dist.broadcast(torch.tensor(header, dtype=torch.int64), src=0, group=self.group)
            for a in arrays:
                dist.broadcast(torch.from_numpy(a), src=0, group=self.group)
            if op == "stop":
                self.stopped = True

    def stop(self) -> None:
        self.send("stop", "")

    def wrap(self, tier: str, relighter) -> "RelayedRelighter":
        return RelayedRelighter(self, tier, relighter)


class RelayedRelighter:
    """A tier's Relighter on rank 0 whose device calls are broadcast first
    (RankRelay); every other attribute is the Relighter's."""

    def __init__(self, relay: RankRelay, tier: str, relighter):
        self._relay, self._tier, self._relighter = relay, tier, relighter

    def __getattr__(self, name):
        return getattr(self._relighter, name)

    def forward_visuals(self, images, masks, target_light=None, target_ambient=None):
        self._relay.send("forward_visuals", self._tier, (images, masks, target_light, target_ambient))
        return self._relighter.forward_visuals(images, masks, target_light=target_light,
                                               target_ambient=target_ambient)

    def estimate_lighting(self, images):
        self._relay.send("estimate_lighting", self._tier, (images,))
        return self._relighter.estimate_lighting(images)


def follow(group, tier_pool) -> dict:
    """A follower rank's loop: receive each of rank 0's device calls over
    `group` and make it on this rank's Relighter of that tier, until `stop`.
    Returns the count of calls by op."""
    done = dict.fromkeys(_OPS[1:], 0)
    while True:
        header = torch.empty(_HEADER, dtype=torch.int64)
        dist.broadcast(header, src=0, group=group)
        h = header.tolist()
        op = _OPS[h[0]]
        if op == "stop":
            return done
        inputs = []
        for k in range(h[2]):
            code, ndim, *dims = h[3 + k * (2 + _MAX_DIMS):3 + (k + 1) * (2 + _MAX_DIMS)]
            x = torch.empty(dims[:ndim], dtype=_DTYPES[code])
            dist.broadcast(x, src=0, group=group)
            inputs.append(x.numpy())
        relighter = tier_pool(PRECISION_TIERS[h[1]])
        try:
            if op == "forward_visuals":
                relighter.forward_visuals(inputs[0], inputs[1], target_light=inputs[2], target_ambient=inputs[3])
            else:
                relighter.estimate_lighting(inputs[0])
        except Exception:  # noqa: BLE001 - rank 0 raised the same error to its caller; keep following
            traceback.print_exc()
        done[op] += 1


def warmup(relighter, batch_sizes=(1, 8)) -> float:
    """Run every shape the serving path uses once, before traffic arrives.

    One forward_visuals per relight batch size and one estimate_lighting at the
    smallest, on zero inputs. On the card these build and load every kernel the
    relighter's tier launches (nvcc, once per source; a later process loads the
    build), so no request pays for it. Returns the wall seconds."""
    t0 = time.monotonic()
    size = relighter.cfg.render.img_height
    light = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    for b in sorted(set(batch_sizes)):
        relighter.forward_visuals(np.zeros((b, size, size, 3), np.uint8), np.zeros((b, size, size), np.uint8),
                                  target_light=np.repeat(light, b, 0),
                                  target_ambient=np.full((b,), 0.5, np.float32)).cpu()
    relighter.estimate_lighting(np.zeros((min(batch_sizes), size, size, 3), np.uint8))[0].cpu()
    if relighter.device.type == "cuda":
        torch.cuda.synchronize(relighter.device)
    return time.monotonic() - t0


def make_handler(relighter, batcher: MicroBatcher | None = None):
    size = relighter.cfg.render.img_height

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/statz":
                if batcher is None:
                    self._json(200, {"batching": False})
                    return
                st = dict(batcher.stats)
                st["per_tier"] = dict(st["per_tier"])
                st["per_format"] = dict(st["per_format"])
                st["batching"] = True
                st["worker_alive"] = batcher._thread.is_alive()
                st["queue_depth"] = batcher._queue.qsize()
                if st["batches"]:
                    st["mean_batch_rows"] = st["batched_rows"] / st["batches"]
                    st["padding_overhead"] = st["padded_rows"] / max(st["batched_rows"], 1) - 1.0
                self._json(200, st)
            else:
                self._json(404, {"error": "not found"})

        def _relight(self, image, mask, light, ambient, tier):
            """(rendered, weights) uint8, masked on the device."""
            if batcher is not None:
                return batcher.submit(image, mask, light, ambient, tier=tier)
            if tier is not None:
                raise ValueError("per-request 'precision' requires the batching worker")
            pack = relighter.forward_visuals(image[None], mask[None], target_light=light[None],
                                             target_ambient=np.asarray(ambient, np.float32)[None])[0].cpu().numpy()
            return pack[..., 0:3], pack[..., 3]

        def _estimate(self, image):
            if batcher is not None:
                return batcher.submit_estimate(image)
            unit, ambient = relighter.estimate_lighting(image[None])
            return unit[0].cpu().numpy(), float(ambient[0])

        def _relit_reply(self, rendered, weights, fmt, quality) -> dict:
            return {"rendered": _encode_image(rendered, fmt, quality),
                    "shadow_mask": _encode_image(weights, fmt, quality), "format": fmt}

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                if self.path == "/relight":
                    # The whole request is validated here, so a malformed one
                    # can only 400 its own caller, never a coalesced batch.
                    image = _decode_image(req["image"], size)
                    mask = _decode_image(req["mask"], size)[..., 0]
                    if "light_preset" in req:
                        light = np.asarray(LIGHT_PRESETS[req["light_preset"]], np.float32)
                    else:
                        light = np.asarray(req["light"], np.float32)
                    if light.shape != (3,) or not np.all(np.isfinite(light)):
                        raise ValueError(f"'light' must be 3 finite floats, got shape {light.shape}")
                    ambient = np.float32(req.get("ambient", DEFAULT_AMBIENT))
                    if not np.isfinite(ambient):
                        raise ValueError("'ambient' must be finite")
                    tier = _parse_tier(req)
                    fmt, quality = _parse_format(req)
                    if batcher is not None:
                        batcher.note_format(fmt)
                    rendered, weights = self._relight(image, mask, light, ambient, tier)
                    self._json(200, self._relit_reply(rendered, weights, fmt, quality))
                elif self.path == "/transfer":
                    # Two passes through the worker: estimate from the
                    # reference, then relight the input with it.
                    image = _decode_image(req["image"], size)
                    reference = _decode_image(req["reference"], size)
                    mask = _decode_image(req["mask"], size)[..., 0]
                    tier = _parse_tier(req)
                    fmt, quality = _parse_format(req)
                    if batcher is not None:
                        batcher.note_format(fmt)
                    unit, amb = self._estimate(reference)
                    rendered, weights = self._relight(image, mask, np.asarray(unit, np.float32), np.float32(amb), tier)
                    reply = self._relit_reply(rendered, weights, fmt, quality)
                    self._json(200, {**reply, "direction": [float(v) for v in unit], "ambient": float(amb)})
                elif self.path == "/estimate":
                    unit, amb = self._estimate(_decode_image(req["image"], size))
                    self._json(200, {"direction": [float(v) for v in unit], "ambient": float(amb)})
                else:
                    self._json(404, {"error": "not found"})
            except (FutTimeout, WorkerDied) as e:
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - a bad request gets its 400
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="reference .pth state dict or orbax checkpoint directory")
    parser.add_argument("--preset", default="single_image")
    parser.add_argument("--config", default=None,
                        help="JSON file with (partial) PipelineConfig overrides on the preset (the tier is applied "
                        "after it)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400, help="0 picks a free port (printed on the 'serving' line)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain paths)")
    parser.add_argument("--max-batch", type=int, default=8, help="micro-batch size for coalesced /relight requests")
    parser.add_argument("--batch-window-ms", type=float, default=4.0,
                        help="how long to wait for more requests after the first")
    parser.add_argument("--precision", choices=PRECISION_TIERS, default=None,
                        help="the default precision tier (default 'high'); requests may name another")
    parser.add_argument("--fast", action="store_true", help="alias for --precision fast")
    parser.add_argument("--no-pipeline", action="store_true",
                        help="fetch batch N's results before dispatching batch N+1")
    parser.add_argument("--drain-timeout-s", type=float, default=30.0,
                        help="max seconds to wait for in-flight device work after SIGTERM/SIGINT "
                        "before exiting non-zero")
    parser.add_argument("--warmup", action="store_true",
                        help="build the kernels and run every serving shape of every tier before announcing readiness")
    parser.add_argument("--data-parallel", action="store_true",
                        help="under torchrun, shard each batch over the ranks (--max-batch a multiple of the world)")
    parser.add_argument("--sample-parallel", action="store_true",
                        help="under torchrun, shard each image's shadow march over the ranks (outputs identical to "
                        "one process; for low concurrency)")
    parser.add_argument("--grid-parallel", metavar="DxS", default=None,
                        help="under torchrun, a D x S mesh (D * S ranks): batches shard over D, each march over S")
    args = parser.parse_args(argv)
    if sum(bool(x) for x in (args.data_parallel, args.sample_parallel, args.grid_parallel)) > 1:
        parser.error("--data-parallel / --sample-parallel / --grid-parallel are mutually exclusive")
    grid = None
    if args.grid_parallel:
        try:
            grid = tuple(int(v) for v in args.grid_parallel.lower().split("x"))
        except ValueError:
            grid = ()
        if len(grid) != 2 or min(grid) < 1:
            parser.error("--grid-parallel expects DxS, e.g. 4x2")

    from geomconsistentfr_torch.config import PRESETS, apply_precision_tier, load_config
    from geomconsistentfr_torch.infer import load_relighter, resolve_device
    from geomconsistentfr_torch.parallel import distributed

    tier = args.precision
    if args.fast:
        if tier and tier != "fast":
            parser.error("--fast conflicts with --precision " + tier)
        tier = "fast"
    tier = tier or "high"
    cfg = load_config(args.config, preset=args.preset) if args.config else PRESETS[args.preset]()
    cfg = apply_precision_tier(cfg, tier)
    mesh, parallel = None, "data"
    if grid or args.data_parallel or args.sample_parallel:
        from geomconsistentfr_torch.parallel.mesh import make_mesh, make_mesh_grid

        rank_device = distributed.initialize("cpu" if args.device == "cpu" else "cuda") or \
            resolve_device(args.device)
        world_size = dist.get_world_size() if dist.is_initialized() else 1
        if grid and grid[0] * grid[1] != world_size:
            parser.error(f"--grid-parallel {args.grid_parallel} needs {grid[0] * grid[1]} ranks; the world has "
                         f"{world_size}")
        mesh = make_mesh_grid(*grid, rank_device) if grid else make_mesh(rank_device)
        parallel = "grid" if grid else "samples" if args.sample_parallel else "data"
    device = mesh.device if mesh is not None else resolve_device(args.device)
    relighter = load_relighter(args.checkpoint, cfg=cfg, device=device, mesh=mesh, parallel=parallel)
    group = distributed.control_group()
    if group is not None and not distributed.is_writer():
        return _follower(group, make_tier_pool(cfg, relighter, tier))
    relay = None
    if group is not None:
        relay = RankRelay(group)
        relighter = relay.wrap(tier, relighter)
    tier_pool = make_tier_pool(cfg, relighter, tier, wrap=None if relay is None else relay.wrap)
    batcher = MicroBatcher(relighter, max_batch=args.max_batch, window_ms=args.batch_window_ms,
                           tier_pool=tier_pool, pipeline=not args.no_pipeline)
    if args.warmup:
        secs = sum(warmup(tier_pool(t), batch_sizes=(batcher.min_batch, args.max_batch)) for t in PRECISION_TIERS)
        _print_line({"warmup_seconds": round(secs, 2)})

    class GracefulServer(ThreadingHTTPServer):
        # server_close() joins the handler threads: after the batcher drains,
        # in-flight handlers still write their responses.
        daemon_threads = False
        block_on_close = True
        # The listen backlog (socketserver's default is 5): a burst of more
        # connections overflows it, and the kernel makes the rest retry a
        # second later.
        request_queue_size = 128

    server = GracefulServer((args.host, args.port), make_handler(relighter, batcher))

    # SIGTERM (a load balancer's stop) closes the listener, then every admitted
    # request resolves and its response is written before the process exits.
    import signal

    def _graceful(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    host, port = server.server_address[:2]
    ranks = {} if mesh is None else {"ranks": mesh.size, "parallel": parallel}
    _print_line({"serving": f"http://{host}:{port}", "device": str(device), "tier": tier, **ranks})
    server.serve_forever()
    drained = batcher.drain(timeout_s=args.drain_timeout_s)
    server.server_close()
    if relay is not None:
        relay.stop()  # the followers leave their loops and exit
        distributed.shutdown()
    _print_line({"drained": drained, "stats": batcher.stats, "tiers": tier_meshes(tier_pool)})
    return 0 if drained else 1


def _print_line(obj) -> None:
    """One JSON line on stdout in a single write: under torchrun the ranks share
    the pipe, and print()'s separate write of the newline lets two ranks' lines
    run together."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _follower(group, tier_pool) -> int:
    """A rank other than 0: rank 0's device calls until its `stop`; then exit 0."""
    import signal

    from geomconsistentfr_torch.parallel import distributed

    # torchrun forwards SIGTERM to every rank: rank 0 drains and then stops
    # this loop, so the signal is not this rank's to act on.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    calls = follow(group, tier_pool)
    rank = dist.get_rank()
    distributed.shutdown()
    _print_line({"follower": rank, "calls": calls, "tiers": tier_meshes(tier_pool)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
