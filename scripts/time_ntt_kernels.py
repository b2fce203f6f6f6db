#!/usr/bin/env python3
"""Time the NTT kernels K1 (forward) and K2 (inverse) of one or more trees
of this repository on one card, in turns, at the loop path's shapes
(PARAM_MESSAGE_1_CARRY_1: N = 1024, 512 ciphertexts x 3 rows) and the
keygen's (N = 2048).

    python3 scripts/time_ntt_kernels.py TREE [TREE ...] [--rounds R]

Each TREE is the root of a checkout: a `git archive` of a commit, or a
copy with a variant of tfhe_tpu_torch/csrc/ntt.cu. The trees run in turns
(A B ... A B ...), R rounds, each in a child process that imports that
tree's tfhe_tpu_torch, builds its kernels into the tree's _build/, checks
K1 (int32 and u64 input, mod p) and K2 (exactly) against the plain
versions and times them: the kernel's device time per launch from
torch.profiler (null where the trace lost some of the launches) and the
wrapper's CUDA-event time per call. It prints one JSON line per run,
then the mean of each tree's runs. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = {  # name: (N, rows of K1's int32 input, rows of K1's u64 input, rows of K2's input)
    "loop": (1024, 1536, 1536, 1536),
    "keygen": (2048, 4096, 3520, 1760),
}
REPS = 20


def worker() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def timed(fn, symbol):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us, launches = 0.0, 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                us += getattr(ev, "self_cuda_time_total", 0) if t is None else t
                launches += ev.count
        # a trace that lost some of the launches' events gives no kernel time
        kernel = us / REPS if launches == REPS else None
        return {"kernel_us": kernel, "wrapper_us": start.elapsed_time(end) / REPS * 1e3}

    out = {}
    for name, (n, r1, ru, r2) in SHAPES.items():
        eng = get_folded_engine(n, dev)
        primes = torch.tensor(eng.primes, device=dev).view(1, -1, 1)
        x = torch.randint(-(2**31), 2**31, (r1, n), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
        hi, lo = (torch.randint(0, 2**32, (ru, n), generator=gen, device=dev, dtype=torch.int64) for _ in range(2))
        xu = (hi << 32) | lo  # u64 bit patterns
        f = torch.randint(0, 2**31, (r2, eng.n_primes, n), generator=gen, device=dev, dtype=torch.int64)
        f = f.to(torch.int32)
        mism = {
            "K1_i32": int(((ntt_cuda.forward(eng, x, True).to(torch.int64) - eng.forward_i32_plain(x).to(torch.int64))
                           % primes).count_nonzero()),
            "K1_u64": int(((ntt_cuda.forward(eng, xu, False).to(torch.int64)
                            - eng.forward_u64_plain(xu).to(torch.int64)) % primes).count_nonzero()),
            "K2": int((ntt_cuda.inverse(eng, f) != eng.inverse_plain(f)).count_nonzero()),
        }
        out[name] = {
            "N": n,
            "mismatches": mism,
            f"K1_i32 ({r1}, {n})": timed(lambda: ntt_cuda.forward(eng, x, True), "k1_forward"),
            f"K1_u64 ({ru}, {n})": timed(lambda: ntt_cuda.forward(eng, xu, False), "k1_forward"),
            f"K2 ({r2}, {eng.n_primes}, {n})": timed(lambda: ntt_cuda.inverse(eng, f), "k2_inverse"),
        }
    print(json.dumps(out), flush=True)


def main() -> int:
    args = sys.argv[1:]
    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i : i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = {tree: [] for tree in args}
    for _ in range(rounds):
        for tree in args:
            root = os.path.abspath(tree)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], cwd=root,
                                  env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: worker exited {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tree].append(res)
            print(json.dumps({"tree": tree, **res}), flush=True)
    bad = []
    for tree, rs in runs.items():
        parts = []
        for shape in SHAPES:
            for key in rs[0][shape]:
                if key in ("N", "mismatches"):
                    continue
                ks = [r[shape][key]["kernel_us"] for r in rs if r[shape][key]["kernel_us"] is not None]
                w = sum(r[shape][key]["wrapper_us"] for r in rs) / len(rs)
                k = f"{sum(ks) / len(ks):.1f} us over {len(ks)} of {len(rs)} runs" if ks else "not traced"
                parts.append(f"{key} {k} (wrapper {w:.1f})")
            if any(v for r in rs for v in r[shape]["mismatches"].values()):
                bad.append(f"{tree} {shape}")
        print(f"{tree}: " + "; ".join(parts), flush=True)
    if bad:
        print(f"mismatches against the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
    else:
        sys.exit(main())
