"""The port's HTTP server on the CPU, on the pattern of tests/test_serve.py.

A 64x64, 16-sample port Relighter with seeded random weights serves through
`make_handler` and `MicroBatcher`; the decode size comes from the
relighter's config. Byte-level bars: a lone request's PNGs decode to exactly
`forward_visuals` at batch 1 of its tier; a coalesced row within one level
of it (the batch's convolutions may round differently); pipelined and
serialized workers give the same bytes. The request codec helpers equal
the JAX server's. `main` runs once in a subprocess (256x256 preset) and
drains on SIGTERM.
"""

import base64
import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from geomconsistentfr_torch import serve as tserve
from geomconsistentfr_torch.data import native_loader
from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.utils import io as tio
from geomconsistentfr_tpu import serve as jserve
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(img_height=64, img_width=64, num_sample_points=16, t_stop=0.105)
CODEC_PACKAGES = ("cv2", "imageio", "imageio.v2", "PIL", "PIL.Image")


def small_cfg(tier="high"):
    cfg = apply_precision_tier(preset_single_image(), tier)
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL))


@pytest.fixture(scope="module")
def state():
    return RelightNet(small_cfg().model, generator=torch.Generator().manual_seed(1)).state_dict()


def relighter(state, tier="high"):
    return Relighter(small_cfg(tier), state, device="cpu")


def png_b64(arr):
    return base64.b64encode(tio.encode_png(np.asarray(arr, np.uint8))).decode()


def unb64(s):
    return tio.decode_image(base64.b64decode(s))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:64, :64]
    mask = np.where(((xx - 32) / 22.0) ** 2 + ((yy - 33) / 27.0) ** 2 <= 1.0, 255, 0).astype(np.uint8)
    return img, mask


class Served:
    """A threaded server on a free port; closes on exit."""

    def __init__(self, relighter, batcher=None):
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(relighter, batcher))
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        conn.request(method, path, body if body is None or isinstance(body, str) else json.dumps(body))
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
        return resp.status, payload


def forward_row(rl, img, mask, light, ambient=0.5):
    pack = rl.forward_visuals(img[None], mask[None], np.asarray(light, np.float32)[None],
                              np.asarray([ambient], np.float32))[0].numpy()
    return pack[..., 0:3], pack[..., 3]


def test_relight_estimate_transfer_endpoints(state, inputs):
    rl = relighter(state)
    img, mask = inputs
    body = {"image": png_b64(img), "mask": png_b64(mask), "light_preset": "multipie_14", "ambient": 0.4}
    with Served(rl) as srv:
        status, payload = srv.request("POST", "/relight", body)
        assert status == 200, payload
        rendered, weights = forward_row(rl, img, mask, LIGHT_PRESETS["multipie_14"], 0.4)
        assert np.array_equal(unb64(payload["rendered"]), rendered)
        assert np.array_equal(unb64(payload["shadow_mask"]), weights)
        assert payload["format"] == "png"

        status, est = srv.request("POST", "/estimate", {"image": png_b64(img)})
        unit, amb = rl.estimate_lighting(img[None])
        assert status == 200 and est["direction"] == [float(v) for v in unit[0]] and est["ambient"] == float(amb[0])

        ref = np.random.default_rng(2).integers(0, 256, (64, 64, 3)).astype(np.uint8)
        status, tr = srv.request("POST", "/transfer", {"image": png_b64(img), "reference": png_b64(ref),
                                                       "mask": png_b64(mask)})
        assert status == 200, tr
        unit, amb = rl.estimate_lighting(ref[None])
        assert tr["direction"] == [float(v) for v in unit[0]] and tr["ambient"] == float(amb[0])
        rendered, _ = forward_row(rl, img, mask, unit[0].numpy(), float(amb[0]))
        assert np.array_equal(unb64(tr["rendered"]), rendered)

        assert srv.request("GET", "/healthz") == (200, {"status": "ok"})
        assert srv.request("GET", "/statz") == (200, {"batching": False})
        assert srv.request("POST", "/relight", "{not json")[0] == 400
        assert srv.request("POST", "/relight", {**body, "light_preset": None, "light": [1.0, 2.0]})[0] == 400
        assert srv.request("POST", "/nowhere", {})[0] == 404


def test_micro_batching_coalesces_and_returns_each_row(state, inputs):
    rl = relighter(state)
    img, mask = inputs
    calls = []
    orig = rl.forward_visuals

    def counting(images, masks, *args, **kw):
        calls.append(images.shape[0])
        return orig(images, masks, *args, **kw)

    rl.forward_visuals = counting
    batcher = tserve.MicroBatcher(rl, max_batch=4, window_ms=300.0)
    presets = ["multipie_14", "multipie_10", "A00E45"]
    results = {}
    with Served(rl, batcher) as srv:
        def post(p):
            results[p] = srv.request("POST", "/relight", {"image": png_b64(img), "mask": png_b64(mask),
                                                          "light_preset": p})

        threads = [threading.Thread(target=post, args=(p,)) for p in presets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    assert all(status == 200 for status, _ in results.values()), results
    assert len(calls) < 3 and set(calls) <= {1, 4}, calls
    for p in presets:
        want, _ = forward_row(rl, img, mask, LIGHT_PRESETS[p])
        got = unb64(results[p][1]["rendered"])
        assert np.abs(got.astype(np.int16) - want).max() <= 1, p
    assert len({results[p][1]["rendered"] for p in presets}) == 3


def test_mixed_relight_and_estimate(state, inputs):
    rl = relighter(state)
    img, mask = inputs
    batcher = tserve.MicroBatcher(rl, max_batch=4, window_ms=50.0)
    unit, amb = rl.estimate_lighting(img[None])
    statuses = []
    with Served(rl, batcher) as srv:
        def relight():
            statuses.append(srv.request("POST", "/relight", {"image": png_b64(img), "mask": png_b64(mask),
                                                             "light": [0.3, 0.4, 0.86]})[0])

        def estimate():
            status, est = srv.request("POST", "/estimate", {"image": png_b64(img)})
            assert est["direction"] == [float(v) for v in unit[0]]
            statuses.append(status)

        threads = [threading.Thread(target=f) for f in (relight, estimate, relight, estimate, relight)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert statuses == [200] * 5
    assert batcher.stats["relight_requests"] == 3 and batcher.stats["estimate_requests"] == 2
    assert batcher.stats["errors"] == 0


def test_worker_death_returns_503(state, inputs):
    class Boom:
        mesh = None
        device = torch.device("cpu")

        def forward_visuals(self, *a, **k):
            raise SystemExit("device lost")  # a BaseException

    batcher = tserve.MicroBatcher(Boom(), max_batch=2, window_ms=1.0, request_timeout_s=30.0)
    img, mask = inputs
    light = np.asarray([0.0, 0.0, 1.0], np.float32)
    for _ in range(2):  # the worker survives and turns the BaseException into WorkerDied
        with pytest.raises(tserve.WorkerDied):
            batcher.submit(img, mask, light, np.float32(0.5))
    assert batcher._thread.is_alive()

    class Dead(tserve.MicroBatcher):
        def _worker(self):
            return  # the worker thread exits at once

    rl = relighter(state)
    dead = Dead(rl, max_batch=2)
    dead._thread.join(timeout=10)
    with Served(rl, dead) as srv:
        status, payload = srv.request("POST", "/relight", {"image": png_b64(img), "mask": png_b64(mask),
                                                           "light_preset": "A00E45"})
        assert status == 503 and "WorkerDied" in payload["error"]
        assert srv.request("GET", "/statz")[1]["worker_alive"] is False


def test_per_request_precision_and_statz(state, inputs):
    img, mask = inputs
    rl = relighter(state, "high")
    pool = tserve.make_tier_pool(small_cfg("high"), rl, "high")
    assert pool("high") is rl and pool("draft") is pool("draft")
    batcher = tserve.MicroBatcher(rl, max_batch=4, window_ms=1.0, tier_pool=pool)
    body = {"image": png_b64(img), "mask": png_b64(mask), "light": [-0.5, 0.2, 0.84]}
    with Served(rl, batcher) as srv:
        for tier in ("strict", "high", "fast", "draft"):
            status, payload = srv.request("POST", "/relight", {**body, "precision": tier})
            assert status == 200, payload
            rendered, weights = forward_row(relighter(state, tier), img, mask, body["light"])
            assert np.array_equal(unb64(payload["rendered"]), rendered), tier
            assert np.array_equal(unb64(payload["shadow_mask"]), weights), tier
        assert srv.request("POST", "/relight", body)[0] == 200
        status, payload = srv.request("POST", "/relight", {**body, "precision": "ultra"})
        assert status == 400 and "unknown precision" in payload["error"]
        assert srv.request("POST", "/estimate", {"image": png_b64(img)})[0] == 200
        status, st = srv.request("GET", "/statz")
    assert status == 200 and st["batching"] and st["worker_alive"]
    assert st["relight_requests"] == 5 and st["estimate_requests"] == 1 and st["batches"] == 5
    assert st["batched_rows"] == 5 and st["padded_rows"] == 5 and st["padding_overhead"] == 0.0
    assert st["per_tier"] == {"strict": 1, "high": 1, "fast": 1, "draft": 1, "": 1}
    assert st["per_format"] == {"png": 5}
    assert st["device_seconds"] > 0 and st["errors"] == 0 and st["queue_depth"] == 0


def test_drain_waits_for_inflight_work():
    class Slow:
        mesh = None
        device = torch.device("cpu")

        def forward_visuals(self, images, masks, **kw):
            time.sleep(0.5)
            return torch.zeros((images.shape[0], 4, 4, 12), dtype=torch.uint8)

    batcher = tserve.MicroBatcher(Slow(), max_batch=2, window_ms=1.0)
    results = []
    t = threading.Thread(target=lambda: results.append(
        batcher.submit(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4), np.uint8), np.zeros(3, np.float32), 0.5)))
    t.start()
    time.sleep(0.05)
    assert batcher.drain(timeout_s=5.0)
    t.join(timeout=5.0)
    assert not t.is_alive() and results and results[0][0].shape == (4, 4, 3)
    assert batcher.drain(timeout_s=0.1)


def test_pipelined_worker_matches_serialized(state, inputs):
    img, mask = inputs
    lights = np.asarray([[0.3, 0.4, 0.866], [-0.5, 0.1, 0.86], [0.0, -0.6, 0.8], [0.7, 0.0, 0.71]], np.float32)

    def storm(pipeline):
        rl = relighter(state)
        orig = rl.forward_visuals

        def slow(images, masks, **kw):
            time.sleep(0.05)  # holds the worker in dispatch while the rest queue up
            return orig(images, masks, **kw)

        rl.forward_visuals = slow
        batcher = tserve.MicroBatcher(rl, max_batch=2, window_ms=200.0, pipeline=pipeline)
        results = [None] * len(lights)

        def post(i):
            results[i] = batcher.submit(img, mask, lights[i], 0.5)

        first = threading.Thread(target=lambda: batcher.submit(img, mask, lights[0], 0.5))
        first.start()
        time.sleep(0.02)
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(lights))]
        for t in threads:
            t.start()
        for t in threads + [first]:
            t.join(timeout=300)
        assert batcher.drain(timeout_s=10.0) and batcher.stats["errors"] == 0
        return results, batcher.stats["pipelined_batches"]

    piped, n_piped = storm(True)
    serial, n_serial = storm(False)
    assert n_piped > 0 and n_serial == 0
    for (a, b), (c, d) in zip(piped, serial):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_jpeg_present_or_refused(state, inputs, monkeypatch):
    img, mask = inputs
    rl = relighter(state)
    batcher = tserve.MicroBatcher(rl, max_batch=2, window_ms=1.0)
    body = {"image": png_b64(img), "mask": png_b64(mask), "light_preset": "multipie_14"}
    with Served(rl, batcher) as srv:
        png = srv.request("POST", "/relight", body)[1]
        status, jpg = srv.request("POST", "/relight", {**body, "format": "jpeg", "quality": 92})
        assert status == 200 and jpg["format"] == "jpeg"
        raw = base64.b64decode(jpg["rendered"])
        assert raw[:2] == b"\xff\xd8"
        assert np.abs(unb64(jpg["rendered"]).astype(np.int16) - unb64(png["rendered"])).mean() < 8.0
        assert unb64(jpg["shadow_mask"]).ndim == 2
        assert srv.request("POST", "/relight", {**body, "format": "webp"})[0] == 400
        assert srv.request("POST", "/relight", {**body, "format": "jpeg", "quality": 0})[0] == 400

        for name in CODEC_PACKAGES:  # a machine without OpenCV, imageio or Pillow
            monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.setattr(native_loader, "has_native_jpeg", lambda: False)  # nor libjpeg
        status, payload = srv.request("POST", "/relight", {**body, "format": "jpeg"})
        assert status == 400 and "no JPEG encoder" in payload["error"]
        status, again = srv.request("POST", "/relight", body)
        assert status == 200 and base64.b64decode(again["rendered"])[:8] == b"\x89PNG\r\n\x1a\n"
        assert np.array_equal(unb64(again["rendered"]), unb64(png["rendered"]))
    assert batcher.stats["per_format"] == {"png": 2, "jpeg": 2}  # the refused formats are not counted


def test_warmup_runs_every_serving_shape(state):
    rl = relighter(state)
    shapes = []
    orig_f, orig_e = rl.forward_visuals, rl.estimate_lighting
    rl.forward_visuals = lambda images, masks, **kw: shapes.append(("relight", images.shape)) or orig_f(images, masks,
                                                                                                        **kw)
    rl.estimate_lighting = lambda images: shapes.append(("estimate", images.shape)) or orig_e(images)
    assert tserve.warmup(rl, batch_sizes=(1, 4)) > 0
    assert shapes == [("relight", (1, 64, 64, 3)), ("relight", (4, 64, 64, 3)), ("estimate", (1, 64, 64, 3))]


def test_request_codec_equals_the_jax_server():
    rng = np.random.default_rng(4)
    for shape in ((64, 64, 3), (64, 64, 4), (64, 64), (80, 80, 3)):
        raw = rng.integers(0, 256, shape).astype(np.uint8)
        b64 = png_b64(raw)
        assert np.array_equal(tserve._decode_image(b64, 64), jserve._decode_image(b64, size=64)), shape
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    for x in (img, img[..., 0], img / 255.0):
        assert np.array_equal(unb64(tserve._encode_image(x)), unb64(jserve._encode_image(x)))
    for req in ({}, {"format": "jpeg", "quality": 5}, {"format": "png", "quality": 100}):
        assert tserve._parse_format(req) == jserve._parse_format(req)
    for req in ({"format": "gif"}, {"quality": 101}, {"quality": 0}):
        with pytest.raises(ValueError):
            tserve._parse_format(req)
        with pytest.raises(ValueError):
            jserve._parse_format(req)
    for tier in (None, "strict", "high", "fast", "draft"):
        assert tserve._parse_tier({"precision": tier}) == jserve._parse_tier({"precision": tier})
    with pytest.raises(ValueError):
        tserve._parse_tier({"precision": "best"})


def test_main_serves_and_drains_on_sigterm(tmp_path):
    """`main` in a subprocess on the CPU (256x256 preset): healthz, one
    /estimate, then SIGTERM drains and exits 0; two multi-rank flags together are refused."""
    pth = tmp_path / "w.pth"
    torch.save(RelightNet(preset_single_image().model, generator=torch.Generator().manual_seed(0)).state_dict(), pth)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "geomconsistentfr_torch.serve", "--checkpoint", str(pth), "--device", "cpu",
           "--port", "0"]
    refused = subprocess.run(cmd + ["--sample-parallel", "--grid-parallel", "1x1"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
    assert refused.returncode != 0 and "mutually exclusive" in refused.stderr
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        port = int(line["serving"].rsplit(":", 1)[1])
        assert line["device"] == "cpu" and line["tier"] == "high"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        img = np.random.default_rng(0).integers(0, 256, (256, 256, 3)).astype(np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/estimate", json.dumps({"image": png_b64(img)}))
        resp = conn.getresponse()
        assert resp.status == 200 and len(json.loads(resp.read())["direction"]) == 3
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert last["drained"] is True and last["stats"]["estimate_requests"] == 1


def test_status_lines_are_single_writes(monkeypatch):
    """Each status line reaches stdout in one write, newline included: under
    torchrun the ranks share the pipe, and a separate write of the newline lets
    rank 0's `drained` line and a follower's line run together."""
    writes = []

    class Recorder:
        def write(self, s):
            writes.append(s)

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stdout", Recorder())
    tserve._print_line({"drained": True, "stats": {"batches": 3}})
    tserve._print_line({"follower": 1, "calls": 7})
    assert [json.loads(w) for w in writes] == [{"drained": True, "stats": {"batches": 3}},
                                               {"follower": 1, "calls": 7}]
    assert all(w.endswith("\n") and w.count("\n") == 1 for w in writes)
