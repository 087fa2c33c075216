"""The packed (distance, t) key of the sample-sharded march, on the CPU.

K5 and the sample-parallel serving march combine their ranks with one MIN
of int64 keys (`shadows.pack_march_key`; K2's key form writes the same words
on the card, tests/test_torch_cuda.py holds them bit for bit). The JAX
package combines with two pmins (shadows_pallas.py:851-855): the minimum
distance over the ranks, then the smallest t among the ranks that reach it.
  * On hypothesis-drawn per-rank (distance, t) arrays, with ties across
    ranks, negative distances (a negative shadow_bias), the 1e6 sentinel and
    1e6 + bias, and t from a padded table that repeats its last offset (one
    that starts below 0 too):
    unpack_march_key of the MIN over the ranks of pack_march_key is those two
    pmins computed in numpy, bit for bit, and pack / unpack round-trip bit
    for bit (-0 read as +0, which the MIN cannot tell apart).
  * The plain march's keys on each slice of sharded_sample_ts, reduced over
    the slices and unpacked, are the full grid's march: its distances bit for
    bit, its first winner's t on every pixel where the full grid's distance
    is reached by one slice only, and the JAX package's two pmins of the
    slices' (distance, t) everywhere.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import shadows_cuda
from test_torch_train_march import scene
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

SENTINEL = 1.0e6
BIASES = (5.0, -7.5, -2.0e6)


def canonical(x: np.ndarray) -> np.ndarray:
    """float32 with -0 read as +0 (the key cannot tell them apart)."""
    return np.where(x == 0, np.float32(0), x).astype(np.float32)


def two_pmins(d: np.ndarray, t: np.ndarray) -> tuple:
    """The JAX package's combine over axis 0 (ranks): pmin of the distances, then pmin of t
    over the ranks whose distance is the minimum (shadows_pallas.py:851-855)."""
    gmin = d.min(axis=0)
    t_star = np.where(d == gmin, t, np.inf).min(axis=0).astype(np.float32)
    return canonical(gmin), canonical(t_star)


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@st.composite
def rank_arrays(draw):
    """(ranks, pixels) float32 distances and the t each rank's march won at, from its slice of a
    padded table (contiguous, increasing, the last offset repeated)."""
    ranks = draw(st.integers(2, 4))
    pixels = draw(st.integers(1, 48))
    n = draw(st.integers(ranks, 40))  # the grid's samples before the pad
    chunk = -(-n // ranks)
    start = draw(st.sampled_from([0.0, 0.025, 0.03, -0.07]))  # a table may start below 0
    grid = (start + 0.005 * np.arange(n)).astype(np.float32)
    table = np.concatenate([grid, np.repeat(grid[-1:], ranks * chunk - n)]).reshape(ranks, chunk)
    bias = draw(st.sampled_from(BIASES))
    special = [SENTINEL, SENTINEL + bias, bias, 0.0, -0.0, 1e-3, 1e-3 + bias, -1e-3]
    value = st.one_of(st.sampled_from(special), st.floats(-3e6, 3e6, width=32),
                      st.floats(-2.0 ** -100, 2.0 ** -100, width=32))
    # A few values repeated across the ranks, so that ties are common.
    pool = draw(st.lists(value, min_size=1, max_size=6))
    d = np.asarray(draw(st.lists(st.lists(st.one_of(st.sampled_from(pool), value), min_size=pixels,
                                          max_size=pixels), min_size=ranks, max_size=ranks)), np.float32)
    cols = draw(st.lists(st.lists(st.integers(0, chunk - 1), min_size=pixels, max_size=pixels),
                         min_size=ranks, max_size=ranks))
    t = np.take_along_axis(table, np.asarray(cols), axis=1)
    return d, t.astype(np.float32)


@settings(max_examples=300, deadline=None)
@given(rank_arrays())
def test_min_of_keys_is_the_two_pmins(arrays):
    d, t = arrays
    keys = TS.pack_march_key(torch.from_numpy(d), torch.from_numpy(t))
    assert keys.dtype == torch.int64 and tuple(keys.shape) == d.shape
    got_d, got_t = TS.unpack_march_key(keys.amin(dim=0))
    want_d, want_t = two_pmins(d, t)
    np.testing.assert_array_equal(bits(got_d.numpy()), bits(want_d))
    np.testing.assert_array_equal(bits(got_t.numpy()), bits(want_t))
    # Round trip, every rank's pixel.
    back_d, back_t = TS.unpack_march_key(keys)
    np.testing.assert_array_equal(bits(back_d.numpy()), bits(canonical(d)))
    np.testing.assert_array_equal(bits(back_t.numpy()), bits(canonical(t)))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), min_size=2, max_size=64),
       st.floats(-2.0, 2.0, width=32))
def test_key_order_is_the_distance_order(values, t):
    """Any two distances at one t order as their keys do (equal keys for equal values, -0 and +0 too)."""
    d = torch.tensor(values, dtype=torch.float32)
    keys = TS.pack_march_key(d, torch.full_like(d, t))
    less_d = d[:, None] < d[None, :]
    less_k = keys[:, None] < keys[None, :]
    assert torch.equal(less_d, less_k)
    assert torch.equal(d[:, None] == d[None, :], keys[:, None] == keys[None, :])


def test_sliced_keys_are_the_full_grid_march():
    """The plain K5 path's keys (shadows_cuda._march_key on the CPU) on each of 3 slices of the
    padded table, reduced over the slices in one process, against the full grid's march."""
    cfg = RenderConfig(img_height=32, img_width=32, num_sample_points=16, t_start=0.025, t_stop=0.105,
                       march_chunk=16, shadow_bias_gate="inside_image", shadow_bias=-3.0)
    depth, mask, lights, _ = scene(seed=7, b=4, size=32)
    mask[3] = 0.0  # every sample vetoed: the first slice's first offset must win
    lights[1] = [3.0, -2.0, 40.0]  # inside the gate: its distances carry the negative bias
    depth, mask, lights = map(torch.from_numpy, (depth, mask, lights))
    table = torch.from_numpy(TS.sharded_sample_ts(cfg, 3)).view(3, -1)
    slices = [TS.ray_march_argmin_batch(depth, mask, lights, cfg, ts) for ts in table]
    keys = []
    for ts in table:  # each slice as K5 takes it: in the grid's range, with the grid's taps
        ts, clamp = shadows_cuda._grid_slice(torch.device("cpu"), cfg, ts)
        keys.append(shadows_cuda._march_key(depth, mask, lights, ts, cfg, clamp=clamp)[0])
    keys = torch.stack(keys)
    for (d, idx), ts, key in zip(slices, table, keys):
        assert torch.equal(key, TS.pack_march_key(d, ts[idx.long()]))
    got_d, got_t = shadows_cuda._combine(keys.amin(dim=0), None)

    full_d, full_idx = TS.ray_march_argmin_batch(depth, mask, lights, cfg)
    full_t = torch.from_numpy(TS.sample_ts(cfg).astype(np.float32))[full_idx.long()]
    assert torch.equal(got_d, full_d)
    assert (got_d[1] < 0).any()
    assert (got_t[3] == table[0, 0]).all()
    # Where one slice alone reaches the full grid's distance, its first winner is the full grid's.
    reached = torch.stack([d == full_d for d, _ in slices]).sum(dim=0)
    assert torch.equal(got_t[reached == 1], full_t[reached == 1])
    assert (got_t == full_t).float().mean().item() >= 0.9999
    want_d, want_t = two_pmins(np.stack([d.numpy() for d, _ in slices]),
                               np.stack([ts[idx.long()].numpy() for (_, idx), ts in zip(slices, table)]))
    np.testing.assert_array_equal(bits(got_d.numpy()), bits(want_d))
    np.testing.assert_array_equal(bits(got_t.numpy()), bits(want_t))
