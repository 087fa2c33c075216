"""The traffic generators: the same seed gives the same inputs, and the open loop's clock."""

import time

import numpy as np
import torch

from gcfr_bench import core
from gcfr_bench.drivers import serve


def test_faces_and_lights_repeat_per_seed():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        ids = torch.randint(0, 10, (4,), generator=gen)
        img, mask = core.jittered_faces(gen, ids, "cpu", 3, 64)
        return img, mask, core.seeded_lights(gen, 4, "cpu", 0.5)

    a, b, c = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    lights = a[2]
    assert torch.allclose(lights.norm(dim=-1), torch.ones(4)) and bool((lights[:, 2] >= 0.5).all())


def test_jitter_is_bounded():
    gen = torch.Generator().manual_seed(3)
    ids = torch.arange(10)
    img, _ = core.jittered_faces(gen, ids, "cpu", 3, 64)
    base = torch.as_tensor(core.faces(None, 64)["image"]).to(torch.int16)
    assert int((img.to(torch.int16) - base).abs().max()) <= 3


def stub_driver(bodies=8, delay=0.0):
    drv = serve.Driver.__new__(serve.Driver)
    drv.seed, drv.traffic, drv.bodies = 9, {"workers": 8}, [b""] * bodies
    drv._post = lambda k: (time.sleep(delay), (200, b"ok"))[1]
    return drv


def test_schedule_repeats_per_seed_and_fixes_the_load():
    drv = stub_driver()
    d1, w1 = drv.schedule(50.0, 4.0, np.random.default_rng([5, 3]))
    d2, w2 = drv.schedule(50.0, 4.0, np.random.default_rng([5, 3]))
    d3, _ = drv.schedule(50.0, 4.0, np.random.default_rng([6, 3]))
    assert np.array_equal(d1, d2) and np.array_equal(w1, w2)
    assert len(d1) == len(d3) == 200 and not np.array_equal(d1, d3)
    assert d1[0] == 0.0 and np.all(np.diff(d1) >= 0) and d1[-1] < 4.0


def test_open_loop_times_from_due():
    """A request is timed from when it was due, so waiting behind a busy client counts."""
    drv = stub_driver(delay=0.05)
    drv.traffic = {"workers": 1}
    run = drv.open_loop(40.0, 0.5, rng=np.random.default_rng(1))
    lat, late = run["latency"], run["late"]
    assert np.all(np.isfinite(lat))
    assert np.all(lat >= late + 0.05 - 1e-3)
    # one worker, 20 requests of 50 ms due within 0.5 s: the queue grows
    assert lat[-1] > 0.5 and late[-1] > 0.3
