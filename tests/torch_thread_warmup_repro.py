"""Stand-alone check for a first-call misfire of PyTorch's CPU vector ops.

tests/torch_cpu_threads.py warms each port test module's intra-op thread
with one exp and one sqrt before it compares anything, because a fresh
thread's first such call was seen to return values off by ~1e-4 relative in
one chunk of a tensor. This script asks whether plain PyTorch shows that,
with none of the port's code: each child process makes a seeded tensor, runs
its first `torch.exp` (or `torch.sqrt`) on the default intra-op threads and
then a second one, and compares both with numpy's float64 result rounded to
float32. Children run `--parallel` at a time, as pytest-xdist workers do.
With `--after-jax` each child first runs one jitted `jnp.exp` on JAX's CPU
backend, as a port test process has done before it compares anything.

    JAX_PLATFORMS=cpu python tests/torch_thread_warmup_repro.py \
        [--procs 48] [--parallel 6] [--after-jax]

Prints one line per child that misfired and a JSON summary; exits 1 if any
first call was off, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

N = 1 << 23


def child(seed: int, op: str, after_jax: bool) -> dict:
    import numpy as np

    if after_jax:
        import jax
        import jax.numpy as jnp

        jax.block_until_ready(jax.jit(jnp.exp)(jnp.linspace(-3.0, 3.0, 1 << 20)))
    import torch

    rng = np.random.default_rng(seed)
    lo = -3.0 if op == "exp" else 0.0
    x = torch.from_numpy(rng.uniform(lo, 3.3, size=N).astype(np.float32))
    first = getattr(torch, op)(x).numpy()
    second = getattr(torch, op)(x).numpy()
    want = getattr(np, op)(x.numpy().astype(np.float64)).astype(np.float32)

    def worst(got):
        return float(np.max(np.abs(got.astype(np.float64) - want) / np.abs(want)))

    return dict(seed=seed, op=op, after_jax=after_jax, threads=torch.get_num_threads(), torch=torch.__version__,
                first_rel=worst(first), second_rel=worst(second),
                first_equals_second=bool(np.array_equal(first, second)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=48)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--after-jax", action="store_true",
                    help="run a jitted jnp.exp in each child before torch is imported, as the port's tests do")
    ap.add_argument("--child", nargs=2, metavar=("SEED", "OP"))
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(int(args.child[0]), args.child[1], args.after_jax)))
        return 0

    results = []
    jobs = [(seed, ("exp", "sqrt")[seed % 2]) for seed in range(args.procs)]
    for i in range(0, len(jobs), args.parallel):
        flags = ["--after-jax"] if args.after_jax else []
        running = [subprocess.Popen([sys.executable, __file__, "--child", str(s), op, *flags],
                                    stdout=subprocess.PIPE, text=True)
                   for s, op in jobs[i:i + args.parallel]]
        for p in running:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"child exited {p.returncode}")
            results.append(json.loads(out))
    # Correctly rounded float32 is within half an ulp (~6e-8 relative); allow 1e-6.
    bad = [r for r in results if r["first_rel"] > 1e-6 or not r["first_equals_second"]]
    for r in bad:
        print(json.dumps(r))
    print(json.dumps(dict(procs=len(results), after_jax=args.after_jax, first_call_off=len(bad),
                          worst_first_rel=max(r["first_rel"] for r in results),
                          worst_second_rel=max(r["second_rel"] for r in results),
                          threads=results[0]["threads"], torch=results[0]["torch"])))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
