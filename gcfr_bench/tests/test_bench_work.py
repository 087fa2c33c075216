"""The work counts: the architecture table against torch's FlopCounterMode on the frozen
reference, the training count term by term, and a march count that reads only the mask,
the samples and the veto."""

import copy

import pytest
import torch
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

from gcfr_bench import core, work
from gcfr_bench.reference import model as ref_model


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_relightnet_table_is_flopcounter(variant):
    with torch.device("meta"):
        net = ref_model.RelightNet(variant).eval()
        x = torch.empty(2, 256, 256, 3)
        assert counted(lambda: net(x)) == 2 * work.relightnet_flops(variant, 256, 256)


def test_training_terms_are_flopcounter():
    """G's forward and backward, D's three forwards and their backward, as the step runs them."""
    b, s = 3, 256
    terms = work.train_step_flops("target", b, s, s)
    with torch.device("meta"):
        g = ref_model.RelightNet("target").train()
        d = ref_model.PatchGAN().train()
        img = torch.empty(b, s, s, 3)

        def generator():
            albedo, depth, lighting = g(img)
            (albedo.sum() + depth.sum() + lighting.sum()).backward()

        def discriminator():
            comp = torch.empty(b, s, s, 3, requires_grad=True)
            frozen = {k: v.detach() for k, v in d.named_parameters()}
            loss = d(comp.detach()).sum() + d(img).sum() + functional_call(d, frozen, (comp,)).sum()
            loss.backward()

        assert counted(generator) == terms["generator_forward"] + terms["generator_backward"]
        assert counted(discriminator) == terms["discriminator_forwards"] + terms["discriminator_backward"]


def test_march_count_reads_mask_samples_and_veto_only():
    reader = core.metric_reader("mfu.relight")
    cfg = core.config("single_image")

    class Run:
        window = {"cnn_images": 64, "images": 64, "face_pixels": 64 * 21000, "seconds": 1.0}

        class driver:
            pass

    Run.driver.cfg = cfg
    a = reader.read(Run)
    other = copy.deepcopy(cfg)
    other["pipeline"]["render"]["shadow_col_chunk"] = 64
    other["pipeline"]["render"]["shadow_mask_cull"] = False
    Run.driver.cfg = other
    assert reader.read(Run) == a
    assert work.march_ops(1000, 160, "onehot") == 1000 * (160 * 62 + 40)
    assert work.march_ops(1000, 160, "bilinear") > work.march_ops(1000, 160, "onehot")


def test_k1_bytes_and_least_time():
    n = work.march_bytes(64, 256, 256, 160)
    assert n == 4 * (3 * 64 * 65536 + 3 * 64 + 160)
    assert work.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
