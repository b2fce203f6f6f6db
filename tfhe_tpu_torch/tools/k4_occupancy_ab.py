"""K4 with and without its register cap, on one card.

    python3 -m tfhe_tpu_torch.tools.k4_occupancy_ab

csrc/multibit.cu declares its kernel `__launch_bounds__(512, 2)`, which
caps registers so that two blocks share an SM. This script builds the
source as it is and a copy without the cap (into the git-ignored
`_build/ab/`), runs both on the same random inputs at the GROUP_3 main-path
shape (512 ciphertexts x 294 groups, g = 3, N = 2048), in the order
uncapped, capped, capped, uncapped, and prints each build's registers,
its time per launch (CUDA events, 2 launches after a warm-up) and whether
the outputs are equal. Key rows and the monomial table are random
residues: the work does not depend on their values.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

CAP = "__launch_bounds__(512, 2)"
BATCH, GROUPS, G, N = 512, 294, 3, 2048


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_occupancy_ab: no CUDA device", file=sys.stderr)
        return 2

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.blind_rotate_cuda import garner_consts
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    src = (_build.CSRC / "multibit.cu").read_text()
    if CAP not in src:
        raise RuntimeError(f"{CAP} not found in csrc/multibit.cu")
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "multibit_uncapped.cu").write_text(src.replace(CAP, ""))
    libs = {}
    for tag, path in (("uncapped", out_dir / "multibit_uncapped.cu"), ("capped", _build.CSRC / "multibit.cu")):
        so = out_dir / f"lib_{tag}.so"
        r = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(path)],
            capture_output=True, text=True,
        )
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{r.stdout}{r.stderr}")
        regs = [ln.split(":", 1)[1].strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln]
        print(f"{tag}: {regs}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.tfhe_multibit_group_steps.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.tfhe_multibit_group_steps.restype = ctypes.c_int
        libs[tag] = lib

    dev = torch.device("cuda")
    eng = get_folded_engine(N, dev)
    n_pr = eng.n_primes
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    primes = torch.tensor(eng.primes, device=dev).view(n_pr, 1)

    def rand_rows(lead):
        r = torch.remainder(torch.randint(0, 2**30, lead + (n_pr, N), generator=gen, device=dev), primes)
        return eng.make_shoup(r.to(torch.int32))

    bsk = torch.cat([rand_rows((min(16, GROUPS - j), 1 << G, 2, 2)) for j in range(0, GROUPS, 16)]).contiguous()
    table = rand_rows((2 * N,)).contiguous()
    acc = torch.randint(-(2**62), 2**62, (BATCH, 2, N), generator=gen, device=dev)
    a = torch.randint(0, 2 * N, (GROUPS * G, BATCH), generator=gen, device=dev).to(torch.int32)
    tw, pp = ntt_cuda.kernel_tables(eng)
    gc = garner_consts(eng)
    logn, logc = ntt_cuda._dims(eng)

    def run(lib, out):
        _build.check(lib.tfhe_multibit_group_steps(
            acc.data_ptr(), out.data_ptr(), a.data_ptr(), bsk.data_ptr(), table.data_ptr(), tw.data_ptr(),
            pp.data_ptr(), gc.data_ptr(), BATCH, GROUPS, G, logn, logc, n_pr, 23, 13,
            torch.cuda.current_stream().cuda_stream,
        ), "tfhe_multibit_group_steps")

    outs = {}
    for tag in ("uncapped", "capped", "capped", "uncapped"):
        out = torch.empty_like(acc)
        run(libs[tag], out)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(libs[tag], out)
        run(libs[tag], out)
        end.record()
        torch.cuda.synchronize()
        print(f"{tag}: {start.elapsed_time(end) / 2:.3f} ms per launch ({BATCH} ct x {GROUPS} groups, g={G})",
              flush=True)
        outs[tag] = out
    print(f"outputs equal: {bool(torch.equal(outs['uncapped'], outs['capped']))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
