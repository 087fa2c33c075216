"""Write the full-width orbax fixture that the port's orbax reader is held to.

    JAX_PLATFORMS=cpu python tests/torch_make_orbax_fixture.py

The JAX package's `utils/checkpoint.save_variables` (orbax, OCDBT on, zstd
chunks) writes the flax variables of `RelightNet.init(PRNGKey(0))`, the
transfer variant at RelightNet's published channels, to
tests/golden/orbax_relightnet_seed0/, and the sha256 of every leaf (its
C-ordered bytes, with its dtype and shape) to
tests/golden/orbax_relightnet_seed0.sha256.json. chip_smoke.py, which
imports no JAX, reads these committed files (its `orbax` phase), and
tests/test_torch_orbax.py reads them on the CPU. Rewriting the fixture
changes its bytes (orbax stamps times and a uuid); the leaves' hashes stay.
"""

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "golden" / "orbax_relightnet_seed0"
HASHES = ROOT / "tests" / "golden" / "orbax_relightnet_seed0.sha256.json"


def leaf_hashes(tree, prefix=()) -> dict:
    """{'params.conv_x.kernel': {'sha256', 'dtype', 'shape'}} of a nested dict of arrays."""
    import numpy as np

    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(leaf_hashes(value, prefix + (key,)))
        else:
            arr = np.ascontiguousarray(np.asarray(value))
            out[".".join(prefix + (key,))] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                                              "dtype": arr.dtype.str, "shape": list(arr.shape)}
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from geomconsistentfr_tpu.config import ModelConfig
    from geomconsistentfr_tpu.models.relightnet import RelightNet
    from geomconsistentfr_tpu.utils.checkpoint import save_variables

    model = RelightNet(cfg=ModelConfig(variant="transfer"))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))()
    variables = jax.tree.map(np.asarray, variables)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save_variables(str(FIXTURE), variables)
    hashes = leaf_hashes(variables)
    num_values = int(sum(np.prod(h["shape"], dtype=np.int64) for h in hashes.values()))
    rows = ",\n".join(f"  {json.dumps(k)}: {json.dumps(v, sort_keys=True)}" for k, v in sorted(hashes.items()))
    HASHES.write_text(f'{{"num_leaves": {len(hashes)}, "num_values": {num_values}, "leaves": {{\n{rows}\n}}}}\n')
    print(json.dumps({"out": str(FIXTURE.relative_to(ROOT)), "num_leaves": len(hashes)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
