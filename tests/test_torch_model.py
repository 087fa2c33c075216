"""Port RelightNet vs the JAX RelightNet on shared random weights (64x64, CPU).

Weights are drawn with numpy from a seed in the flax layout and carried into
the port by `state_dict_from_jax_variables`. Tolerances: rtol=atol=1e-4 for
float32 summation order; depth carries the x100 scale, so atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch.config import ModelConfig as TModelConfig
from geomconsistentfr_torch.convert import state_dict_from_jax_variables, transfer_to_target_variant
from geomconsistentfr_torch.models.relightnet import RelightNet as TRelightNet
from geomconsistentfr_tpu.config import ModelConfig as JModelConfig
from geomconsistentfr_tpu.convert import variables_to_torch_state
from geomconsistentfr_tpu.models.relightnet import RelightNet as JRelightNet
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)


def random_variables(variant: str, seed: int = 0, size: int = 64):
    """Flax RelightNet variables with numpy-drawn weights and BN statistics."""
    model = JRelightNet(cfg=JModelConfig(variant=variant))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False)
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_net(variables, variant: str, compute_dtype: str = "float32") -> TRelightNet:
    net = TRelightNet(TModelConfig(variant=variant, compute_dtype=compute_dtype))
    net.load_state_dict(state_dict_from_jax_variables(variables))
    return net.eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_eval_forward_matches_jax(variant, images):
    variables = random_variables(variant)
    jm = JRelightNet(cfg=JModelConfig(variant=variant, conv_precision="highest"))
    want = jm.apply(variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = port_net(variables, variant)(torch.from_numpy(images))
    np.testing.assert_allclose(got.albedo.numpy(), np.asarray(want.albedo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.lighting.numpy(), np.asarray(want.lighting), rtol=1e-4, atol=1e-4)
    assert got.albedo.shape == (2, 64, 64, 3) and got.depth.shape == (2, 64, 64)
    assert got.lighting.shape == (2, 4)


def test_train_mode_batch_norm_statistics_match_jax(images):
    variables = random_variables("target", seed=2)
    jm = JRelightNet(cfg=JModelConfig(variant="target", conv_precision="highest"))
    _, updated = jm.apply(variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
    net = port_net(variables, "target").train()
    with torch.no_grad():
        net(torch.from_numpy(images))
    state = net.state_dict()
    for name, stats in updated["batch_stats"].items():
        np.testing.assert_allclose(
            state[f"{name}.running_mean"].numpy(), np.asarray(stats["mean"]), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(
            state[f"{name}.running_var"].numpy(), np.asarray(stats["var"]), rtol=1e-4, atol=1e-4
        )


def test_state_dict_matches_reference_layout():
    """The port's state dict is the JAX package's .pth export, key for key and shape for shape."""
    for variant in ("target", "transfer"):
        variables = random_variables(variant)
        want = variables_to_torch_state(jax.tree_util.tree_map(np.asarray, variables))
        got = port_net(variables, variant).state_dict()
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert tuple(got[key].shape) == tuple(np.shape(value)), key
            np.testing.assert_array_equal(got[key].numpy(), value)


def test_transfer_embeds_into_target_identically(images):
    variables = random_variables("transfer", seed=3)
    state = state_dict_from_jax_variables(variables)
    transfer = TRelightNet(TModelConfig(variant="transfer"))
    transfer.load_state_dict(state)
    target = TRelightNet(TModelConfig(variant="target"))
    target.load_state_dict(transfer_to_target_variant(state))
    x = torch.from_numpy(images)
    with torch.no_grad():
        a, b = transfer.eval()(x), target.eval()(x)
    for name in ("albedo", "depth", "lighting"):
        np.testing.assert_allclose(getattr(a, name).numpy(), getattr(b, name).numpy(), rtol=1e-5, atol=1e-4)


def test_init_is_seeded_and_leaves_global_rng_alone():
    torch.manual_seed(123)
    before = torch.rand(1)
    torch.manual_seed(123)
    a = TRelightNet(generator=torch.Generator().manual_seed(7)).state_dict()
    after = torch.rand(1)
    b = TRelightNet(generator=torch.Generator().manual_seed(7)).state_dict()
    assert torch.equal(before, after)
    for key in a:
        assert torch.equal(a[key], b[key]), key
