"""The split of a traced stretch by the program's spans (gcfr_bench/spans.py), on synthetic
Chrome events, and its readers."""

import pytest

from gcfr_bench import core, spans

READERS = ("upload_ms.relight", "cnn_encoder_ms.relight", "cnn_decoders_ms.relight", "render_ms.relight",
           "pack_ms.relight", "program_idle_ms.relight")


def host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "pid": 1, "tid": 1,
            "args": {"correlation": corr}}


def op(name, ts, dur, corr=None, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": stream,
            "args": {"correlation": corr, "stream": stream}}


def call_events(t0=0.0):
    """One call: upload, a CNN with an encoder and a decoder, a render with its march
    (launched by a library whose launches go unrecorded), a pack and the fetch."""
    return [
        host("entry.forward_visuals", t0, 100),
        host("gcfr.upload", t0 + 1, 9),
        launch(1, t0 + 2),
        op("Memcpy HtoD", t0 + 3, 4, 1, cat="gpu_memcpy"),
        host("gcfr.cnn", t0 + 10, 40),
        host("gcfr.cnn.encoder", t0 + 11, 10),
        launch(2, t0 + 12),
        op("conv", t0 + 13, 12, 2),
        host("gcfr.cnn.decoder_depth", t0 + 30, 15),
        launch(3, t0 + 31),
        op("elementwise", t0 + 31, 10, 3),
        launch(4, t0 + 47),  # inside gcfr.cnn, in no stage
        op("sigmoid", t0 + 47, 2, 4),
        host("gcfr.render", t0 + 50, 30),
        launch(5, t0 + 51),
        op("normals", t0 + 51, 5, 5),
        host("gcfr.render.march", t0 + 60, 10),
        launch(6, t0 + 61),
        op("fill", t0 + 61, 1, 6),
        op("march_kernel<0, 1>", t0 + 62, 6, None),  # no launch record
        launch(7, t0 + 75),
        op("composite", t0 + 75, 3, 7),
        host("gcfr.pack", t0 + 85, 10),
        launch(8, t0 + 86),
        op("pack", t0 + 86, 4, 8),
        host("host.fetch", t0 + 100, 10),
        launch(9, t0 + 101),
        op("Memcpy DtoH", t0 + 101, 5, 9, cat="gpu_memcpy"),
    ]


def stretch(calls=2):
    events = [host("stretch", 0, 110 * calls)]
    for c in range(calls):
        events += call_events(110.0 * c)
    return events


def test_ops_go_to_the_innermost_span_of_their_launch():
    s = spans.Split(stretch(2), 2)
    assert s.device_ms("gcfr.upload") == pytest.approx(4e-3)
    assert s.device_ms("gcfr.cnn.encoder") == pytest.approx(12e-3)
    assert s.device_ms("gcfr.cnn.decoder_depth") == pytest.approx(10e-3)
    assert s.device_ms("gcfr.cnn") == pytest.approx(2e-3)  # the op outside the stages only
    assert s.device_ms("gcfr.render") == pytest.approx(8e-3)  # normals and composite, not the march
    assert s.device_ms("gcfr.render.march") == pytest.approx(7e-3)
    assert s.device_ms("gcfr.pack") == pytest.approx(4e-3)
    assert s.device_ms("host.fetch") == pytest.approx(5e-3)
    assert s.device_ms("gcfr.cnn.encoder", "gcfr.cnn.decoder_depth") == pytest.approx(22e-3)
    r = s.report()
    assert r["unassigned_share"] == 0.0 and r["program_or_fetch_share"] == pytest.approx(1.0)


def test_an_op_without_a_launch_record_takes_the_span_before_it_on_its_stream():
    s = spans.Split(stretch(1), 1)
    assert s.fallback_s == pytest.approx(6e-6)
    assert s.report()["fallback_share"] == pytest.approx(6 / s.total_s / 1e6)
    # On another stream, after nothing: unassigned, counted as such.
    events = stretch(1) + [op("march_kernel<0, 1>", 70, 3, None, stream=9)]
    s = spans.Split(events, 1)
    assert s.unassigned_s == pytest.approx(3e-6) and s.fallback_s == pytest.approx(6e-6)
    # Before the march's own launches: the op before on the stream is the render's.
    events = [e for e in stretch(1) if (e.get("args") or {}).get("correlation") != 6]
    assert spans.Split(events, 1).device_ms("gcfr.render.march") == 0.0


def test_an_op_launched_outside_every_span_is_outside_spans():
    events = stretch(1) + [launch(20, 105.5 + 100), op("late", 106, 1, 20)]
    events[0]["dur"] = 300
    assert spans.Split(events, 1).device_s[spans.OUTSIDE] == pytest.approx(1e-6)


def test_idle_gaps_go_to_the_span_open_when_they_begin():
    s = spans.Split(stretch(1), 1)
    # Gaps 0-3, 7-13, 25-31, 41-47, 49-51, 56-61, 68-75, 78-86, 90-101, 106-110.
    want = {"entry.forward_visuals": 3, "gcfr.upload": 6, "gcfr.cnn": 6 + 2, "gcfr.cnn.decoder_depth": 6,
            "gcfr.render": 5 + 8, "gcfr.render.march": 7, "gcfr.pack": 11, "host.fetch": 4}
    assert s.idle_s == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert s.program_idle_ms() == pytest.approx((6 + 8 + 6 + 13 + 7 + 11) * 1e-3)
    # The same gaps as the harness's own reduction, where no program span is open.
    plain = [e for e in stretch(1) if not e["name"].startswith("gcfr.")]
    assert dict(core.Trace(plain, 1.0).idle_gaps()) == pytest.approx(spans.Split(plain, 1).idle_s)


def test_nested_spans_in_parallel_stacks():
    """The open spans at each time, outermost first, for spans given in any order."""
    ivs = [("b", 2, 5), ("a", 0, 10), ("c", 3, 4), ("d", 6, 8)]
    assert spans._stacks_at(ivs, [0, 3.5, 4, 5, 7, 10, 2]) == [
        ["a"], ["a", "b", "c"], ["a", "b"], ["a"], ["a", "d"], [], ["a", "b"]]


def test_operator_labels_name_the_aten_op_and_the_port_function():
    events = stretch(1) + [
        host("aten::conv2d", 12, 2, cat="cpu_op"),
        host("aten::cudnn_convolution", 12, 1.5, cat="cpu_op"),
        host("geomconsistentfr_torch/models/layers.py(70): conv", 11.5, 3, cat="python_function"),
        host("torch/nn/functional.py(10): conv2d", 11.8, 2.5, cat="python_function"),
    ]
    r = spans.Split(events, 1, ops=True).report()["ops_ms"]
    assert r["gcfr.cnn.encoder | aten::conv2d @ layers.py: conv"] == pytest.approx(12e-3)
    assert r["gcfr.render.march | (no launch record)"] == pytest.approx(6e-3)
    assert r["gcfr.pack | (no aten op)"] == pytest.approx(4e-3)


class View:
    def __init__(self, events, device="cuda"):
        import torch

        self.trace = core.Trace(events, 1.0)
        self.trace.info = {"calls": 1}
        self.driver = type("D", (), {"device": torch.device(device), "_call": None})()


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_nothing_without_their_span(metric):
    """A program that opens no gcfr.* span (or none of a reader's) reports no value."""
    plain = [e for e in stretch(1) if not e["name"].startswith("gcfr.")]
    view = View(plain)
    setattr(view, spans.ATTR, spans.Split(plain, 1))
    assert core.metric_reader(metric).read(view) is None


@pytest.mark.parametrize("metric,want", [("upload_ms.relight", 4e-3), ("cnn_encoder_ms.relight", 12e-3),
                                         ("cnn_decoders_ms.relight", 10e-3), ("render_ms.relight", 8e-3),
                                         ("pack_ms.relight", 4e-3), ("program_idle_ms.relight", 51e-3)])
def test_readers_read_the_split_kept_on_the_view(metric, want):
    view = View(stretch(1))
    setattr(view, spans.ATTR, spans.Split(stretch(1), 1))
    assert core.metric_reader(metric).read(view) == pytest.approx(want)


def test_split_is_none_off_the_card_and_without_a_trace():
    view = View(stretch(1), device="cpu")
    assert spans.program_split(view) is None
    view = View(stretch(1))
    view.trace = None
    assert spans.program_split(view) is None
    assert all(core.metric_reader(m).read(view) is None for m in READERS)


class CpuDriver:
    """A driver whose call opens a gcfr.* span around a few operators, on the CPU."""

    n_inputs, free_bufs = 2, []
    device = __import__("torch").device("cpu")

    def _call(self, k, spans_on):
        import torch
        from torch.profiler import record_function

        with record_function("entry.call"), record_function("gcfr.cnn"):
            return torch.ones(8, 8) * (k + 1) + 1

    def _fetch(self, out):
        return out.clone()

    def _sync(self):
        pass


@pytest.mark.parametrize("stack", [False, True])
def test_the_split_s_stretch_records_spans_and_only_with_stack_operators(stack):
    events, host = spans.profiled_stretch(CpuDriver(), 3, stack=stack)
    s = spans.Split(events, 3, host_seconds=host)
    assert {"stretch", "entry.call", "gcfr.cnn", "host.fetch"} <= {e["name"] for e in events}
    assert s.names == {"entry.call", "gcfr.cnn", "host.fetch"} and host > 0
    assert (s.aten_ops > 0) == stack
