"""The arithmetic of the result: percentiles, spreads, the uint8 gaps, the reservoir, the trace."""

import statistics

import numpy as np
import pytest

from gcfr_bench import core


def test_quartile_spread_is_statistics_quantiles():
    v = [10.0, 10.5, 9.8, 10.2, 11.0, 9.9]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert core.quartile_spread(v) == pytest.approx((q3 - q1) / q2)


def test_percentile_interpolates():
    assert core.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert core.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_window_rate_counts_all_work_and_time():
    """relight_img_per_s is images over the whole window, not a mean of per-call rates."""
    times = [0.1, 0.1, 0.4]
    assert 3 * 64 / sum(times) != pytest.approx(np.mean([64 / t for t in times]))


def test_u8_gaps():
    want = np.zeros((2, 4, 4, 3), np.uint8)
    got = want.copy()
    got[1, 0, 0, :] = 5
    got[0, 1, 1, 0] = 1
    face = np.ones((2, 4, 4), bool)
    face[1, 3, 3] = False
    g = core.u8_gaps(got, want, face)
    assert g["worst_image_off_by_2"] == pytest.approx(3 / (15 * 3))
    assert g["mean_gap"] == pytest.approx((15 + 1) / (31 * 3))
    got[1, 3, 3] = 200  # off the face: not counted
    assert core.u8_gaps(got, want, face) == g


def test_reservoir_is_uniform_and_repeats():
    counts = np.zeros(50)
    for s in range(2000):
        r = core.Reservoir(2, s)
        for i in range(50):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert counts.min() > 40 and counts.max() < 130
    a, b = core.Reservoir(3, 7), core.Reservoir(3, 7)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_trace_busy_idle_and_gaps():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "stretch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "host.fetch", "ts": 50, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
    ]
    tr = core.Trace(events, 1e-4)
    assert tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.device_seconds(lambda n: n.startswith("k")) == pytest.approx(50e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["outside_spans"] == pytest.approx(20e-6) and gaps["host.fetch"] == pytest.approx(30e-6)
    assert tr.device_ops()[0] == ["k1", pytest.approx(30e-6)]


def test_verdict():
    v = core.Verdict()
    v.add("a", 0.1, 0.2)
    assert v.correct
    v.add("b", float("nan"), 1.0)
    assert not v.correct
    assert core.Verdict().correct is False
