"""Orbax checkpoint directories, read and written without orbax or tensorstore.

    read_checkpoint(path) -> nested dict (lists for sequences) of numpy arrays and Python numbers
    write_checkpoint(path, tree)

What geomconsistentfr_tpu/utils/checkpoint.save_variables writes (orbax's
PyTreeCheckpointer) is a directory of:
  * `_METADATA`: JSON. `tree_metadata` maps each leaf to its key path
    (`key_metadata`: names, and key types 1 = sequence index, 2 = dict key)
    and its `value_type` ('np.ndarray', 'jax.Array' or 'scalar'); the tree's
    nesting is rebuilt from these, never by splitting names. `use_ocdbt`
    says where the arrays are; `use_zarr3` must be false.
  * every leaf a zarr v2 array named by its keys joined with '.': a
    `<name>/.zarray` JSON (shape, chunks, dtype such as '<f4' or '<i8',
    compressor {"id": "zstd"}; a scalar has shape [] and the chunk key
    '0') and its chunks `<name>/0.0.0`, each a zstd frame of the chunk's
    C-ordered bytes (without a content size: utils/zstd.py sizes it from
    the metadata).
  * with `use_ocdbt` false, those keys are files under the directory.
    With it true (orbax's default), they live in an OCDBT key-value store
    (tensorstore's format, read by `OcdbtStore`):
      - `manifest.ocdbt`: magic 0x0cdb3a2a (big-endian u32), the file's
        length (u64le), a format version and a compression (varints; 1 =
        zstd over the rest), the body, then the CRC32C of everything before
        it (u32le). The body holds the config (uuid, manifest kind,
        limits, the tree's compression), a data file table and the
        versions; the newest version's root is a reference (file, offset,
        length) to a B-tree node;
      - B-tree nodes: magic 0x0cdb20de and the same envelope; a height, a
        data file table, prefix-compressed keys; a leaf's values are
        inline or indirect (file, offset, length), an interior node's
        entries reference child nodes;
      - data files are named by the tables, relative to the directory
        (`d/<hex>` for the merged root's nodes, `ocdbt.process_0/d/<hex>`
        for the values and nodes each writing process left).
    The CRC32C of the manifest and of every node is checked.

`write_checkpoint` writes the layout with `use_ocdbt` false: the per-leaf
zarr v2 directories (zstd level 1, one chunk a leaf), `_METADATA` and
`_CHECKPOINT_METADATA`, into a temporary directory renamed into place, as
orbax's own `PyTreeCheckpointer(use_ocdbt=False)` writes numpy leaves; orbax
restores it. Leaves are numpy arrays ('np.ndarray'; tensors are taken to
numpy) and Python or numpy numbers ('scalar').
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from geomconsistentfr_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_KEY_SEQUENCE, _KEY_DICT = 1, 2
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_CHECKPOINT_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


class CheckpointFormatError(ValueError):
    """The directory is not an orbax checkpoint this reader takes; the message says what it found."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected polynomial 0x82f63b78), table-driven.
# ---------------------------------------------------------------------------

def _crc_table() -> Tuple[int, ...]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise CheckpointFormatError(f"{self.what}: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise CheckpointFormatError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CheckpointFormatError(f"{self.what}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u32le(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32le(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _envelope(data: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node file, its length, CRC32C and compression checked."""
    if len(data) < 4 + 8 + 2 + 4:
        raise CheckpointFormatError(f"{what}: {len(data)} bytes is too short")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise CheckpointFormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise CheckpointFormatError(f"{what}: the header says {length} bytes, the data is {len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    crc = crc32c(data[:-4])
    if crc != want:
        raise CheckpointFormatError(f"{what}: CRC32C {crc:#010x} where the file stores {want:#010x}")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise CheckpointFormatError(f"{what}: format version {version} (this reader takes 0)")
    compression = r.varint()
    rest = data[r.pos:-4]
    if compression == 1:
        rest = zstd.decompress(rest)
    elif compression != 0:
        raise CheckpointFormatError(f"{what}: compression {compression} (0 none and 1 zstd are taken)")
    return _Reader(rest, what)


def _data_file_table(r: _Reader, transitive: str) -> List[Tuple[str, str]]:
    """(base_path, relative_path) of each data file; a node's base paths are relative to its own."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        text = path.decode()
        files.append((transitive + text[:base[i]], text[base[i]:]))
    return files


def _file_ref(r_ids: List[int], table: List[Tuple[str, str]], what: str) -> List[Tuple[str, str]]:
    out = []
    for i in r_ids:
        if i >= len(table):
            raise CheckpointFormatError(f"{what}: data file {i} of a table of {len(table)}")
        out.append(table[i])
    return out


class OcdbtStore:
    """The newest version of an OCDBT key-value store in directory `root`, read into memory."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        manifest = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise CheckpointFormatError(f"{root}: no manifest.ocdbt")
        r = _envelope(self._read(manifest), MANIFEST_MAGIC, "manifest.ocdbt")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise CheckpointFormatError(f"{manifest}: manifest kind {kind}; only the single-file manifest "
                                        "(kind 0) is read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()    # version_tree_arity_log2
        if r.varint() == 1:
            r.i32le()  # the tree's zstd level
        table = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            self.root_ref = None
            return
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        files = _file_ref(r.varints(n), table, "manifest.ocdbt")
        offset, length = r.varints(n), r.varints(n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self.root_ref = (files[newest], offset[newest], length[newest], height[newest])

    def _read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def _slice(self, file: Tuple[str, str], offset: int, length: int) -> bytes:
        path = os.path.join(self.root, *(file[0] + file[1]).split("/"))
        if path not in self._files:
            if not os.path.isfile(path):
                raise CheckpointFormatError(f"{self.root}: the store references {file[0] + file[1]}, which is "
                                            "not there")
            self._files[path] = self._read(path)
        data = self._files[path]
        if offset + length > len(data):
            raise CheckpointFormatError(f"{path}: a reference to bytes [{offset}, {offset + length}) of "
                                        f"{len(data)}")
        return data[offset:offset + length]

    def items(self) -> Dict[bytes, bytes]:
        """Every key of the newest version with its value."""
        out: Dict[bytes, bytes] = {}
        if self.root_ref is not None:
            file, offset, length, height = self.root_ref
            self._node(file, offset, length, height, b"", out)
        return out

    def _node(self, file, offset, length, height, prefix: bytes, out: Dict[bytes, bytes]) -> None:
        what = f"node {file[0] + file[1]}@{offset}"
        r = _envelope(self._slice(file, offset, length), NODE_MAGIC, what)
        got = r.byte()
        if got != height:
            raise CheckpointFormatError(f"{what}: height {got} where its parent says {height}")
        table = _data_file_table(r, file[0])
        n = r.varint()
        key_prefix = [0] + r.varints(max(n - 1, 0))
        key_suffix = r.varints(n)
        common = r.varints(n) if height > 0 else None  # each subtree's common key prefix
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:key_prefix[i]] + r.take(key_suffix[i])
            keys.append(prev)
        if height > 0:
            files = _file_ref(r.varints(n), table, what)
            offsets, lengths = r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            for i in range(n):
                self._node(files[i], offsets[i], lengths[i], height - 1, prefix + keys[i][:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise CheckpointFormatError(f"{what}: value kinds {sorted(set(kinds))} (0 inline, 1 indirect)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        files = _file_ref(r.varints(len(indirect)), table, what)
        offsets = r.varints(len(indirect))
        refs = dict(zip(indirect, zip(files, offsets)))
        for i in range(n):
            if kinds[i] == 0:
                value = r.take(lengths[i])
            else:
                f, off = refs[i]
                value = self._slice(f, off, lengths[i])
            out[prefix + keys[i]] = value


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

def _zarr_array(get: Callable[[str], Optional[bytes]], name: str) -> np.ndarray:
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise CheckpointFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise CheckpointFormatError(f"{name}: zarr_format {meta.get('zarr_format')} (this reader takes 2)")
    comp = meta.get("compressor")
    if not comp or comp.get("id") != "zstd":
        raise CheckpointFormatError(f"{name}: compressor {comp!r}; only zstd is read")
    if meta.get("filters"):
        raise CheckpointFormatError(f"{name}: filters {meta['filters']!r} are not read")
    if meta.get("order", "C") != "C":
        raise CheckpointFormatError(f"{name}: order {meta['order']!r}; only C order is read")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise CheckpointFormatError(f"{name}: dtype {meta['dtype']!r} is not a numpy dtype") from None
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = sep.join(str(i) for i in index) if index else "0"
        data = get(f"{name}/{key}")
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if data is None:
            if meta.get("fill_value") is None:
                raise CheckpointFormatError(f"{name}: chunk {key} is missing and the array has no fill_value")
            out[region] = meta["fill_value"]
            continue
        chunk = np.frombuffer(zstd.decompress(data, chunk_bytes), dtype).reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


# ---------------------------------------------------------------------------
# The checkpoint
# ---------------------------------------------------------------------------

def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise CheckpointFormatError(f"{path}: no _METADATA (not an orbax PyTree checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise CheckpointFormatError(f"{meta_path}: no tree_metadata (an orbax format before 0.5 is not read)")
    if meta.get("use_zarr3"):
        raise CheckpointFormatError(f"{meta_path}: use_zarr3 is true; only zarr v2 arrays are read")
    return meta


def _nest(leaves: List[Tuple[List[Tuple[str, int]], Any]]):
    """Rebuild the tree from (key path, value) pairs: dicts for dict keys, lists for sequence keys."""
    root: dict = {}
    types: Dict[int, int] = {}  # id(node) -> the key type of its children
    for keys, value in leaves:
        node = root
        for depth, (name, kind) in enumerate(keys):
            seen = types.setdefault(id(node), kind)
            if seen != kind:
                raise CheckpointFormatError(f"{'.'.join(k for k, _ in keys)}: key types {seen} and {kind} "
                                            "under one node")
            key = int(name) if kind == _KEY_SEQUENCE else name
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def finish(node):
        if not isinstance(node, dict):
            return node
        if types.get(id(node)) == _KEY_SEQUENCE:
            return [finish(node[i]) for i in sorted(node)]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def read_checkpoint(path: str):
    """The tree orbax wrote to directory `path`: a nested dict (lists for
    sequences) of numpy arrays, Python numbers for scalars."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    if meta.get("use_ocdbt", False):
        store = OcdbtStore(path).items()

        def get(key: str) -> Optional[bytes]:
            return store.get(key.encode())
    else:
        def get(key: str) -> Optional[bytes]:
            file = os.path.join(path, *key.split("/"))
            if not os.path.isfile(file):
                return None
            with open(file, "rb") as f:
                return f.read()

    leaves = []
    for entry_name, entry in meta["tree_metadata"].items():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if any(kind not in (_KEY_SEQUENCE, _KEY_DICT) for _, kind in keys):
            raise CheckpointFormatError(f"{entry_name}: key types {[kind for _, kind in keys]} (1 sequence, 2 dict)")
        value_meta = entry["value_metadata"]
        value_type = value_meta["value_type"]
        if value_meta.get("skip_deserialize"):
            continue
        name = ".".join(k for k, _ in keys)
        if value_type in _ARRAY_TYPES:
            value = _zarr_array(get, name)
        elif value_type == "scalar":
            value = _zarr_array(get, name).item()
        else:
            raise CheckpointFormatError(f"{entry_name}: value_type {value_type!r} (arrays and scalars are read)")
        leaves.append((keys, value))
    return _nest(leaves)


def _flatten(tree, keys=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"dict keys must be strings, got {k!r} at {'.'.join(n for n, _ in keys)}")
            out += _flatten(v, keys + ((k, _KEY_DICT),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, keys + ((str(i), _KEY_SEQUENCE),))
        return out
    return [(keys, tree)]


def _leaf_array(value) -> Tuple[np.ndarray, str]:
    if isinstance(value, bool):
        raise TypeError("bool leaves are not written")
    if isinstance(value, int):
        return np.asarray(value, np.int64), "scalar"
    if isinstance(value, float):
        return np.asarray(value, np.float64), "scalar"
    if isinstance(value, np.generic):
        return np.asarray(value), "scalar"
    if hasattr(value, "detach"):  # a torch tensor
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        return np.ascontiguousarray(value), "np.ndarray"
    raise TypeError(f"cannot write a leaf of type {type(value).__name__}")


def write_checkpoint(path: str, tree) -> None:
    """Write `tree` to directory `path` (replaced if it exists) in orbax's layout without OCDBT."""
    path = os.path.abspath(path)
    leaves = _flatten(tree)
    if not leaves:
        raise ValueError("the tree has no leaves")
    init_ns = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{init_ns}"
    os.makedirs(tmp)
    try:
        tree_meta = {}
        for keys, value in leaves:
            arr, value_type = _leaf_array(value)
            if arr.dtype.kind not in "fiub" or arr.dtype.byteorder == ">":
                raise TypeError(f"{'.'.join(k for k, _ in keys)}: dtype {arr.dtype} is not written")
            name = ".".join(k for k, _ in keys)
            leaf_dir = os.path.join(tmp, name)
            os.makedirs(leaf_dir)
            zarray = {"chunks": [max(d, 1) for d in arr.shape],
                      "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
                      "dtype": arr.dtype.str, "fill_value": None, "filters": None, "order": "C",
                      "shape": list(arr.shape), "zarr_format": 2}
            with open(os.path.join(leaf_dir, ".zarray"), "w") as f:
                f.write(json.dumps(zarray, sort_keys=True, separators=(",", ":")))
            if arr.size:
                chunk = ".".join("0" for _ in arr.shape) or "0"
                with open(os.path.join(leaf_dir, chunk), "wb") as f:
                    f.write(zstd.compress(arr.tobytes(), 1))
            tree_meta[repr(tuple(k for k, _ in keys))] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                "value_metadata": {"value_type": value_type, "skip_deserialize": False},
            }
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _CHECKPOINT_HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init_ns, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
