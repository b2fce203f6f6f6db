"""Bulk PBS in a closed loop: `apply_lut` of the program's shortint layer on
batches of ciphertexts, one synchronise a batch.

Set-up: the program's keygen from the seed; the traffic's input batches,
encrypted by the benchmark under the key the reference works out from the
same seed (messages below the message modulus); its LUTs (random tables
from the seed), made by the program's `generate_lut`; one warm-up batch.
The window cycles through the input batches, batch i with LUT i mod luts.

Every answer of the window is decrypted on the card right after its batch
with the reference's key and held against its table (`wrong`); one
ciphertext a batch, at a row drawn from the seed, is kept. After the
window the reference bootstraps a sample of those kept inputs and
`gap_bits` is log2 of the widest gap between the program's phase and the
reference's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import system
from benchmark.reference import tfhe as rt
from benchmark.trace import span


class State:
    pass


def setup(cell, seed: int, device: str) -> State:
    from tfhe_tpu_torch.models import shortint as si

    cfg, t = cell.config, cell.traffic
    st = State()
    st.si, st.device, st.seed, st.traffic = si, device, seed, t
    st.p = rt.Params.from_config(cfg)
    st.prog = system.program_params(cfg)
    t0 = time.perf_counter()
    st.ck, st.sk = si.keygen(st.prog, seed=seed, device=device)
    st.phases = {"keygen": time.perf_counter() - t0}
    t0 = time.perf_counter()
    glwe_sk, _, _ = rt.secret_keys(st.p, seed, device)
    st.big_sk = glwe_sk.reshape(-1)
    gen = torch.Generator(device=device).manual_seed(seed)
    msg = st.p.message_modulus
    b, nb, nl = t["batch"], t["input_batches"], t["luts"]
    st.msgs = torch.randint(0, msg, (nb, b), generator=gen, device=device)
    st.tables = torch.randint(0, msg, (nl, msg * st.p.carry_modulus), generator=gen, device=device)
    st.cts = [rt.encrypt_big(st.big_sk, st.msgs[i] * st.p.delta, gen, cfg["glwe_noise_log2"]) for i in range(nb)]
    st.luts = [si.generate_lut(st.prog, st.tables[i].cpu().numpy().astype(np.uint64), device=device)
               for i in range(nl)]
    st.want = [[st.tables[j][st.msgs[i]] for j in range(nl)] for i in range(nb)]
    st.rows = torch.Generator().manual_seed(seed)
    st.phases["inputs and LUTs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _batch(st, 0)  # warm-up: the kernels are built and loaded, the one shape is seen
    if device == "cuda":
        torch.cuda.synchronize()
    st.phases["warm-up batch"] = time.perf_counter() - t0
    return st


def _batch(st: State, i: int):
    nb, nl = len(st.cts), len(st.luts)
    c = st.si.Ciphertext(ct=st.cts[i % nb], params=st.prog, degree=st.p.message_modulus - 1, noise_level=1)
    return st.si.apply_lut(st.sk, c, st.luts[i % nl], st.p.message_modulus - 1).ct


def window(st: State, seconds: float) -> dict:
    sync = torch.cuda.synchronize if st.device == "cuda" else (lambda: None)
    b = st.traffic["batch"]
    modulus = st.p.message_modulus * st.p.carry_modulus
    wrong = torch.zeros((), dtype=torch.int64, device=st.device)
    st.kept = []
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        with span("batch"):
            out = _batch(st, n)
        with span("answers"):
            got = rt.decode(st.p, rt.phase(st.big_sk, out), modulus)
            wrong += (got != st.want[n % len(st.cts)][n % len(st.luts)]).sum()
            r = int(torch.randint(0, b, (1,), generator=st.rows))
            st.kept.append((n, r, out[r].clone()))
        with span("sync"):
            sync()
        n += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    st.wrong = wrong
    return {"window_s": window_s, "attempted": n, "failed": 0, "pbs": n * b}


def check(st: State) -> dict:
    wrong = int(st.wrong)
    # free the program's state before the reference takes the card
    del st.sk, st.ck, st.luts
    if st.device == "cuda":
        torch.cuda.empty_cache()
    keys = rt.keygen(st.p, st.seed, st.device)
    k = min(st.traffic["check_sample"], len(st.kept))
    pick = torch.randperm(len(st.kept), generator=torch.Generator().manual_seed(st.seed))[:k].tolist()
    nb, nl = len(st.cts), len(st.tables)
    kept = [st.kept[j] for j in pick]
    ct = torch.stack([st.cts[i % nb][r] for i, r, _ in kept])
    luts = torch.stack([rt.lut_poly(st.p, st.tables[i % nl], st.device) for i, _, _ in kept])
    ref = rt.pbs(st.p, keys, ct, luts)
    prog = torch.stack([o for _, _, o in kept])
    gap = rt.centered(rt.phase(keys.big_sk, prog) - rt.phase(keys.big_sk, ref)).max().item()
    return {"wrong": wrong, "gap_bits": math.log2(gap) if gap > 0 else 0.0}

