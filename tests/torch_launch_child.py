"""One rank under torchrun for the port's launch tests (tests/test_torch_launch.py; no JAX here).

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tests/torch_launch_child.py OUT_DIR MODULE [ARGS...]

Runs `python -m MODULE ARGS` as -m does and writes the rank's exit code to
OUT_DIR/rank<RANK>.json, so a test can see how each rank ended after a
signal (torchrun itself then exits non-zero).
"""

import json
import os
import runpy
import sys


def main() -> None:
    out_dir, module = sys.argv[1], sys.argv[2]
    code = None
    try:
        sys.argv = [module] + sys.argv[3:]
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{os.environ.get('RANK', '0')}.json"), "w") as f:
            json.dump({"exit_code": code}, f)


if __name__ == "__main__":
    main()
