#!/usr/bin/env python3
"""Time shortint keygen on one card for one or more trees of this
repository, in turns: PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 and
PARAM_MULTI_BIT_GROUP_3_..., each key drawn from its seed, and the masks of
2^22 uniform torus values from FheRng.

    python3 scripts/time_keygen.py TREE [TREE ...] [--rounds R]

Each TREE is the root of a checkout (a `git archive` of a commit). The
trees run in turns (A B ... A B ...), R rounds, each in a child process
that imports that tree's tfhe_tpu_torch: one warm-up keygen of each set,
then the mean wall time of REPS keygens (host clock around work that ends
in torch.cuda.synchronize()). It prints one JSON line per run, then the
mean of each tree's runs. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPS = 3
MASKS = 1 << 22


def worker() -> None:
    import torch

    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.rng import FheRng

    def wall_s(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS

    res = {
        "classic_keygen_s": wall_s(lambda: si.keygen(tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, seed=1, device="cuda")),
        "group3_keygen_s": wall_s(
            lambda: si.keygen(tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, seed=1, device="cuda")
        ),
        "uniform_torus_s": wall_s(lambda: FheRng(1, "cuda").uniform_torus((MASKS,))),
    }
    print(json.dumps(res), flush=True)


def main() -> int:
    args = sys.argv[1:]
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i : i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {t: [] for t in args}
    for r in range(rounds):
        for tree in args:
            path = os.path.abspath(tree)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker"], cwd=path,
                env=dict(os.environ, PYTHONPATH=path), capture_output=True, text=True, timeout=600,
            )
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            runs[tree].append(res)
            print(json.dumps({"tree": tree, "round": r, **res}), flush=True)
    for tree, rs in runs.items():
        print(json.dumps({"tree": tree, "mean": {k: sum(x[k] for x in rs) / len(rs) for k in rs[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker() if sys.argv[1:] == ["--worker"] else main())
