"""The lighting-transfer cell on the CPU at its small size: the light estimated in the first
pass, altered where it is produced, makes `correct` come out false (the sound run and the
altered pack are every cell's, in test_bench_faults.py); the estimate's work count matches
torch's FlopCounterMode; the share of bytes that differ holds against a few pixels far off."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gcfr_bench import core, run, work
from gcfr_bench.reference import model as ref_model
from gcfr_bench.reference import transfer as ref_transfer
from gcfr_bench.tests.conftest import sizes

CELL = "lighting_transfer.transfer64"
SEED = 2 ** 33 + 5


def small_run():
    return run.run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=sizes(CELL)["small"])


@pytest.mark.parametrize("fault", ["direction_x_negated", "ambient_plus_0.05"])
def test_estimate_altered(monkeypatch, fault):
    """The first pass's answer altered: the check sees the light estimated from the references."""
    from geomconsistentfr_torch.infer import Relighter

    fn = Relighter.estimate_lighting

    def altered(*args, **kwargs):
        light, ambient = fn(*args, **kwargs)
        if fault == "direction_x_negated":
            return light * torch.tensor([-1.0, 1.0, 1.0], device=light.device), ambient
        return light, ambient + 0.05

    monkeypatch.setattr(Relighter, "estimate_lighting", altered)
    assert small_run()["correct"] is False


def test_reference_estimate_is_the_program_s():
    """The reference's light from the head's outputs, against the program's on the same outputs."""
    from geomconsistentfr_torch.config import from_dict
    from geomconsistentfr_torch.render import estimated_light

    cfg = core.config("lighting_transfer")["pipeline"]
    head = torch.randn(64, 4, generator=torch.Generator().manual_seed(3))
    want = estimated_light(head, from_dict(cfg).render)
    got = ref_transfer.estimated_light(head, cfg["render"])
    assert torch.allclose(got[0], want[0], rtol=0, atol=1e-6) and torch.equal(got[1], want[1])
    assert bool((head[:, 3] < cfg["render"]["z_clamp_min"]).any())  # the clamp is exercised


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_encoder_table_is_flopcounter(variant):
    """The encoder and the lighting head by FlopCounterMode's per-module counts: the whole
    forward less every module of the two decoders."""
    with torch.device("meta"):
        net = ref_model.RelightNet(variant).eval()
        x = torch.empty(2, 256, 256, 3)
        with FlopCounterMode(display=False) as fc:
            net(x)
    counts = fc.get_flop_counts()
    decoders = [name for name, _ in net.named_children() if "albedo" in name or "depth" in name]
    assert len(decoders) > 40
    decoder_flops = sum(sum(counts.get(f"RelightNet.{n}", {}).values()) for n in decoders)
    encoder = sum(counts["Global"].values()) - decoder_flops
    assert encoder == 2 * work.relightnet_encoder_flops(variant, 256, 256)
    assert work.relightnet_encoder_flops(variant, 256, 256) < work.relightnet_flops(variant, 256, 256) / 4


def test_mfu_counts_the_references_by_their_encoder():
    reader = core.metric_reader("mfu.transfer")
    cfg = core.config("lighting_transfer")

    class Run:
        window = {"cnn_images": 64, "images": 64, "face_pixels": 64 * 21000, "seconds": 1.0}

        class driver:
            pass

    Run.driver.cfg = cfg
    r = cfg["pipeline"]["render"]
    want = (64 * (work.relightnet_flops("transfer", 256, 256) + work.relightnet_encoder_flops("transfer", 256, 256))
            + work.march_ops(64 * 21000, 159, "onehot"))
    assert r["num_sample_points"] == 159 and work.veto(r) == "onehot"
    assert reader.read(Run) == pytest.approx(100.0 * want / work.PEAK_F32_FLOPS)


def test_moved_share_holds_against_a_few_pixels_far_off():
    """A few pixels many levels off (a shadow's edge) move the mean gap, not the share of
    bytes that differ; one level in every byte moves the share to 1."""
    import numpy as np

    want = np.full((5, 8, 8, 12), 100, np.uint8)
    face = np.ones((5, 8, 8), bool)
    got = want.copy()
    got[:, 0, 0, 0] += 1
    base = core.u8_gaps(got, want, face)
    assert base["moved_share"] == pytest.approx(1 / (64 * 12)) == base["mean_gap"]
    got[2, 0, 1:3, 3] += 60
    edge = core.u8_gaps(got, want, face)
    assert edge["mean_gap"] > 20 * base["mean_gap"] and edge["moved_share"] < 2 * base["moved_share"]
    assert core.u8_gaps(want + 1, want, face)["moved_share"] == 1.0


def test_estimate_reader_reads_nothing_off_the_card():
    class Run:
        class driver:
            device = torch.device("cpu")

    assert core.metric_reader("estimate_ms.transfer").read(Run) is None


def test_float64_witness_runs_the_cell_at_its_small_size():
    """The witness's float64 reference answers the kept calls as the float32 one does, to
    rounding, and its tally covers every byte far off."""
    from gcfr_bench import witness

    wl, cfg, s = core.workload(CELL), core.config("lighting_transfer"), sizes(CELL)["small"]
    run.merge(wl, s["workload"])
    run.merge(cfg, s["config"])
    drv = core.driver_module(wl["driver"]).Driver(wl, cfg, SEED, "cpu")
    drv.setup()
    drv.window(0.2)
    drv.free()
    row = witness.witness(drv, far=8)
    assert row["float32_vs_float64"]["mean_gap"] < 0.05
    t = row["sides"]
    assert t["with_program"] + t["with_float32"] + t["with_neither"] == t["far_bytes"]


def test_witness_sides_counts_which_reference_the_float64_one_joins():
    import numpy as np

    from gcfr_bench import witness

    face = np.ones((1, 1, 4), bool)
    got = np.array([[[[100], [100], [100], [100]]]], np.uint8)
    want32 = np.array([[[[140], [140], [104], [140]]]], np.uint8)
    want64 = np.array([[[[101], [139], [100], [120]]]], np.uint8)
    assert witness.sides(got, want32, want64, face, far=8) == {
        "far_bytes": 3, "with_program": 1, "with_float32": 1, "with_neither": 1,
        "float32_vs_float64_far_bytes": 2}
