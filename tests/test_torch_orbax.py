"""The port's orbax checkpoints (utils/zstd.py, utils/orbax.py, utils/checkpoint.py,
convert.variables_from_state_dict, infer.load_relighter on a directory, `cli convert`)
against orbax and the JAX package, on the CPU.

Bars: every leaf bit for bit (its type, dtype, shape and bytes) wherever a
tree is read back; forwards from a checkpoint directory within the strict
bar of tests/test_torch_infer.py (rendered PSNR >= 80 dB, uint8 visual packs
at most 1 apart on at most 0.1% of bytes).
"""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import cli as tcli
from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.convert import state_dict_from_jax_variables, variables_from_state_dict
from geomconsistentfr_torch.infer import Relighter as TRelighter
from geomconsistentfr_torch.infer import load_relighter
from geomconsistentfr_torch.utils import orbax as torbax
from geomconsistentfr_torch.utils import zstd
from geomconsistentfr_torch.utils.checkpoint import restore_variables, save_variables
from geomconsistentfr_tpu import cli as jcli
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.convert import torch_state_to_variables
from geomconsistentfr_tpu.infer import load_relighter as j_load_relighter
from geomconsistentfr_tpu.infer import pack_visuals as j_pack_visuals
from geomconsistentfr_tpu.utils import checkpoint as jckpt
from test_torch_infer import face_inputs, psnr, random_variables, small_cfg
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "golden" / "orbax_relightnet_seed0"
HASHES = ROOT / "tests" / "golden" / "orbax_relightnet_seed0.sha256.json"


def mixed_tree():
    """float32, int64, scalars (int and float), a nested dict and a list."""
    rng = np.random.default_rng(0)
    return {
        "params": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                            "bias": rng.normal(size=(5,)).astype(np.float32)},
                   "big": rng.normal(size=(300, 70)).astype(np.float32)},  # past OCDBT's inline limit
        "step": 7,
        "lr": 0.25,
        "counts": np.arange(11, dtype=np.int64) - 5,
        "nested": {"a": {"b": {"c": np.float32(1.5) * np.ones((2, 1, 3), np.float32)}}},
        "layers": [np.ones((2,), np.float32), {"w": np.zeros((3, 2), np.int64)}],
    }


def assert_trees_bit_equal(got, want, where="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_trees_bit_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_bit_equal(a, b, f"{where}.{i}")
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, got.shape)
            assert got.tobytes() == want.tobytes(), where
        else:
            assert got == want, where


def orbax_save(path, tree, ocdbt: bool):
    """The JAX package's save_variables (OCDBT on), or orbax's checkpointer with OCDBT off."""
    if ocdbt:
        jckpt.save_variables(str(path), tree)
    else:
        import orbax.checkpoint as ocp

        ocp.PyTreeCheckpointer(use_ocdbt=False).save(str(path), tree)


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def test_zstd_round_trips_and_streams_frames_without_a_size():
    import zstandard

    rng = np.random.default_rng(1)
    data = rng.integers(0, 4, 3 << 20, dtype=np.uint8).tobytes()
    frame = zstd.compress(data, 1)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data and zstd.decompress(frame, len(data)) == data
    sizeless = zstandard.ZstdCompressor(level=1, write_content_size=False).compress(data)  # as zarr writes
    assert zstd.decompress(sizeless, len(data)) == data
    assert zstd.decompress(sizeless) == data  # streamed (ZSTD_decompressStream), as larger OCDBT nodes are
    assert zstd.decompress(zstd.compress(b"")) == b""
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"plain bytes")
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(sizeless[:-5], len(data))
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(sizeless[:-5])
    with pytest.raises(zstd.ZstdError, match="too small"):
        zstd.decompress(frame, len(data) - 1)


# ---------------------------------------------------------------------------
# The reader against orbax's own restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt", "zarr"])
def test_reader_matches_orbax_restore(tmp_path, ocdbt):
    orbax_save(tmp_path / "ckpt", mixed_tree(), ocdbt)
    meta = json.loads((tmp_path / "ckpt" / "_METADATA").read_text())
    assert meta["use_ocdbt"] is ocdbt
    want = jckpt.restore_variables(str(tmp_path / "ckpt"))
    assert_trees_bit_equal(torbax.read_checkpoint(str(tmp_path / "ckpt")), want)
    assert_trees_bit_equal(restore_variables(str(tmp_path / "ckpt")), want)


def test_reader_walks_multi_level_ocdbt_trees(tmp_path):
    """Interior B-tree nodes, indirect values across data files and a version
    tree, as tensorstore writes them with small node and inline limits."""
    import tensorstore as ts

    rng = np.random.default_rng(2)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 24,
                                     "version_tree_arity_log2": 1}}).result()
    want = {}
    for _ in range(6):
        txn = ts.Transaction()
        for _ in range(50):
            key = f"p{rng.integers(0, 30)}.w{rng.integers(0, 300)}/0.0".encode()
            value = rng.bytes(int(rng.integers(0, 90)))
            kv.with_transaction(txn)[key] = value
            want[key] = value
        txn.commit_async().result()
    store = torbax.OcdbtStore(str(tmp_path))
    assert store.root_ref[3] >= 2  # the root is an interior node two levels up
    assert store.items() == want


def first_zarray(tree_dir):
    for root, _, names in os.walk(tree_dir):
        if ".zarray" in names:
            return Path(root) / ".zarray"
    raise AssertionError("no .zarray")


@pytest.mark.parametrize("case", ["zarr3", "compressor", "manifest_crc", "node_crc"])
def test_reader_refuses_what_it_cannot_read(tmp_path, case):
    path = tmp_path / "ckpt"
    orbax_save(path, mixed_tree(), ocdbt=case.endswith("crc"))
    if case == "zarr3":
        meta = json.loads((path / "_METADATA").read_text())
        (path / "_METADATA").write_text(json.dumps(dict(meta, use_zarr3=True)))
        match = "use_zarr3"
    elif case == "compressor":
        zarray = first_zarray(path)
        zarray.write_text(json.dumps(dict(json.loads(zarray.read_text()), compressor={"id": "blosc"})))
        match = "compressor.*blosc"
    else:
        target = path / "manifest.ocdbt" if case == "manifest_crc" else next((path / "d").iterdir())
        data = bytearray(target.read_bytes())
        data[20] ^= 0x40
        target.write_bytes(bytes(data))
        match = "CRC32C"
    with pytest.raises(torbax.CheckpointFormatError, match=match):
        torbax.read_checkpoint(str(path))


def test_crc32c_known_answers():
    assert torbax.crc32c(b"") == 0
    assert torbax.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert torbax.crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720, B.4


def test_committed_fixture_reads_to_its_hashes_and_to_orbax():
    want = json.loads(HASHES.read_text())
    tree = restore_variables(str(FIXTURE))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = v

    walk(tree, ())
    assert len(flat) == want["num_leaves"] == len(want["leaves"])
    for name, leaf in flat.items():
        h = want["leaves"][name]
        assert leaf.dtype.str == h["dtype"] and list(leaf.shape) == h["shape"], name
        assert hashlib.sha256(leaf.tobytes()).hexdigest() == h["sha256"], name
    assert_trees_bit_equal(tree, jckpt.restore_variables(str(FIXTURE)))


# ---------------------------------------------------------------------------
# The writer, read back by orbax and the JAX package
# ---------------------------------------------------------------------------

def test_writer_is_restored_by_orbax(tmp_path):
    tree = mixed_tree()
    save_variables(str(tmp_path / "ckpt"), tree)
    meta = json.loads((tmp_path / "ckpt" / "_METADATA").read_text())
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    assert not (tmp_path / "ckpt" / "_sharding").exists()
    assert_trees_bit_equal(jckpt.restore_variables(str(tmp_path / "ckpt")), tree)
    assert_trees_bit_equal(restore_variables(str(tmp_path / "ckpt")), tree)
    # Written again over itself (orbax's force=True), the tree is replaced.
    save_variables(str(tmp_path / "ckpt"), {"only": np.arange(3, dtype=np.float32)})
    assert_trees_bit_equal(jckpt.restore_variables(str(tmp_path / "ckpt")), {"only": np.arange(3, dtype=np.float32)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_restore_with_a_template_checks_shapes(tmp_path):
    tree = {"a": np.zeros((2, 3), np.float32), "b": [np.ones(4, np.int64)]}
    save_variables(str(tmp_path / "ckpt"), tree)
    got = restore_variables(str(tmp_path / "ckpt"), template={"a": np.empty((2, 3)), "b": (np.empty(4),)})
    assert isinstance(got["b"], tuple) and got["a"].shape == (2, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_variables(str(tmp_path / "ckpt"), template={"a": np.empty((3, 2)), "b": [np.empty(4)]})


@pytest.mark.parametrize("variant", ["transfer", "target"])
def test_variables_from_state_dict_is_jax_convert(variant):
    variables = random_variables(variant, seed=6)
    state = state_dict_from_jax_variables(variables)
    got = variables_from_state_dict(state)
    want = torch_state_to_variables({k: v.numpy() for k, v in state.items()})
    assert_trees_bit_equal(got, want)
    assert_trees_bit_equal(got, jax.tree.map(np.asarray, variables))
    back = state_dict_from_jax_variables(got)
    assert sorted(back) == sorted(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


# ---------------------------------------------------------------------------
# load_relighter on a directory, and `cli convert`
# ---------------------------------------------------------------------------

def assert_strict_bar(got, want_rendered, got_pack, want_pack):
    assert psnr(got.rendered.numpy(), want_rendered) >= 80.0
    diff = np.abs(got_pack.astype(np.int16) - want_pack.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_load_relighter_reads_the_jax_packages_checkpoint(tmp_path):
    """Transfer-variant weights written by the JAX package, driven through the
    target-variant pipeline (the embedding load_relighter applies)."""
    variables = random_variables("transfer", seed=7)
    jckpt.save_variables(str(tmp_path / "ckpt"), variables)
    cfg_t, cfg_j = small_cfg(TC, "strict"), small_cfg(JC, "strict")
    got = load_relighter(str(tmp_path / "ckpt"), cfg=cfg_t, device="cpu")
    want_state = state_dict_from_jax_variables(jckpt.restore_variables(str(tmp_path / "ckpt")))
    from geomconsistentfr_torch.convert import transfer_to_target_variant

    want_state = transfer_to_target_variant(want_state)
    state = got.model.state_dict()
    assert sorted(state) == sorted(want_state)
    for k in state:
        assert torch.equal(state[k], want_state[k]), k
    jrl = j_load_relighter(str(tmp_path / "ckpt"), cfg=cfg_j)
    images, masks, lights, ambients = face_inputs(2, seed=8)
    want = jrl.forward(images, masks, lights, ambients)
    out = got.forward(images, masks, lights, ambients)
    assert_strict_bar(out, want.rendered, got.forward_visuals(images, masks, lights, ambients).numpy(),
                      np.asarray(j_pack_visuals(want, jnp.asarray(masks))))


def test_the_jax_package_loads_the_ports_checkpoint(tmp_path):
    variables = random_variables("target", seed=9)
    state = state_dict_from_jax_variables(variables)
    save_variables(str(tmp_path / "ckpt"), variables_from_state_dict(state))
    assert_trees_bit_equal(jckpt.restore_variables(str(tmp_path / "ckpt")), jax.tree.map(np.asarray, variables))
    jrl = j_load_relighter(str(tmp_path / "ckpt"), cfg=small_cfg(JC, "strict"))
    trl = TRelighter(small_cfg(TC, "strict"), state, device="cpu")
    images, masks, lights, ambients = face_inputs(2, seed=10)
    want = jrl.forward(images, masks, lights, ambients)
    assert_strict_bar(trl.forward(images, masks, lights, ambients), want.rendered,
                      trl.forward_visuals(images, masks, lights, ambients).numpy(),
                      np.asarray(j_pack_visuals(want, jnp.asarray(masks))))


def test_cli_convert_writes_the_jax_clis_tree(tmp_path, capsys):
    state = state_dict_from_jax_variables(random_variables("transfer", seed=11))
    torch.save(state, tmp_path / "w.pth")
    assert tcli.main(["convert", "--pth", str(tmp_path / "w.pth"), "--out", str(tmp_path / "port")]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert jcli.main(["convert", "--pth", str(tmp_path / "w.pth"), "--out", str(tmp_path / "jax")]) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got == {"out": str(tmp_path / "port"), "num_values": want["num_values"]}
    tree = jckpt.restore_variables(str(tmp_path / "port"))
    assert_trees_bit_equal(tree, jckpt.restore_variables(str(tmp_path / "jax")))
    # The port reads both directories to the same tree.
    assert_trees_bit_equal(restore_variables(str(tmp_path / "jax")), tree)
