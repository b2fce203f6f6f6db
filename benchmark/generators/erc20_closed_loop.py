"""fhevm's confidential ERC20 transfers through the program's server, in a
closed loop of one client.

Set-up: `create_instance` at the configuration's parameter set and the
seed, an `FheServer` on 127.0.0.1 (port chosen by the system) and the
program's `FheClient`; the account balances and a pool of amounts, drawn
from the seed, encrypted and ZK-proved on the client side with the
program's compact-PKE key and submitted through /input-proof; an encrypted
zero, made by /evaluate as xor(x, x); one warm-up request of the window's
shape.

Each request is one /evaluate of `transfers_per_request` whitepaper
transfers (le(amount, from), select(cond, amount, zero), sub(from, moved),
add(to, moved)) between distinct accounts drawn from the seed, amounts
drawn from the pool; balances carry over from request to request. The
client derives every result handle and checks the reply against them.

After the window the reference decrypts every account's final balance
from the server's ciphertexts with the key it works out from the seed:
`wrong` counts balances that differ from the clear replay of the same
transfers, `noise_bits` is log2 of the largest distance of a block's phase
from its decoded value.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import system
from benchmark.reference import erc20
from benchmark.reference import tfhe as rt
from benchmark.trace import span

CONTRACT = "0x" + "c0" * 20
USER = "0x" + "a1" * 20


class State:
    pass


def _submit(st: State, values, rng_seed: int) -> list[str]:
    """Client side of one input: block values, the compact-PKE list and
    its proof; then /input-proof. Returns the handles."""
    from tfhe_tpu_torch.api import compact_pke as cp
    from tfhe_tpu_torch.api import zkpok
    from tfhe_tpu_torch.rng import FheRng
    from tfhe_tpu_torch.utils import serialization

    inst, bits = st.inst, int(math.log2(st.p.message_modulus))
    blocks = [(int(v) >> (bits * i)) & (st.p.message_modulus - 1) for v in values for i in range(st.nblocks)]
    vals = torch.tensor(blocks, dtype=torch.int64, device=st.device)
    lst, r, e = cp.compact_pke_encrypt_with_witness(inst.pke_keys, vals, FheRng(rng_seed, st.device))
    aux = inst.input_aux_data(CONTRACT, USER)
    proof = zkpok.prove(inst.crs, inst.pke_keys.pke_pk, lst, r, np.asarray(blocks, dtype=np.uint64), e, aux)
    body = {"ciphertext": serialization.serialize(lst).hex(), "zkProof": proof.to_bytes().hex(),
            "types": [st.type.name] * len(values), "contract": CONTRACT, "user": USER}
    return st.client._post("/input-proof", body)["handles"]


def _handle(st: State, op: str, operands: list[str], tname: str) -> str:
    return st.FhevmHandle.from_op(op, [bytes.fromhex(x[2:]) for x in operands], st.inst.chain_id,
                                  st.types[tname].type_id).hex()


def setup(cell, seed: int, device: str) -> State:
    from tfhe_tpu_torch.api.client import FheClient
    from tfhe_tpu_torch.api.handles import FhevmHandle
    from tfhe_tpu_torch.api.instance import create_instance
    from tfhe_tpu_torch.api.serve import FheServer
    from tfhe_tpu_torch.api.types import FHE_TYPES
    from tfhe_tpu_torch.models import integer as ri

    cfg, t = cell.config, cell.traffic
    st = State()
    st.device, st.seed, st.traffic = device, seed, t
    st.FhevmHandle, st.types = FhevmHandle, FHE_TYPES
    st.p = rt.Params.from_config(cfg)
    st.type = FHE_TYPES[t["type"]]
    st.bits = st.type.bits
    prog = system.program_params(cfg)
    st.nblocks = ri.blocks_for_bits(prog, st.bits)
    t0 = time.perf_counter()
    st.inst = create_instance(params=prog, seed=seed, device=device)
    st.phases = {"create_instance": time.perf_counter() - t0}
    st.server = FheServer(st.inst).start()
    st.client = FheClient(f"http://127.0.0.1:{st.server.port}", timeout=t["timeout_s"])
    gen = torch.Generator().manual_seed(seed)

    def draw(lo_bits, hi_bits, n):
        lo, hi = 1 << lo_bits, 1 << hi_bits
        return [lo + int(x) for x in torch.randint(0, hi - lo, (n,), generator=gen, dtype=torch.int64)]

    n_acc, n_amt, n_over = t["accounts"], t["amounts"], t["overdraw_amounts"]
    st.bal = draw(*t["balance_bits"], n_acc)
    amts = draw(*t["amount_bits"], n_amt - n_over) + draw(*t["overdraw_bits"], n_over)
    st.amt = [amts[i] for i in torch.randperm(n_amt, generator=gen).tolist()]
    per = t["values_per_input"]
    t0 = time.perf_counter()
    st.inst.pke_keys, st.inst.crs  # made on first use
    st.phases["PKE keys and CRS"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k = 0
    st.acc_h, st.amt_h = [], []
    for vals, dest in ((st.bal, st.acc_h), (st.amt, st.amt_h)):
        for lo in range(0, len(vals), per):
            dest.extend(_submit(st, vals[lo:lo + per], (seed * 64 + k) % (1 << 62)))
            k += 1
    st.phases["inputs through /input-proof"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = st.client.evaluate_many([("xor", [st.amt_h[0]] * 2)])
    st.zero = res["handles"][0]
    st.gen = gen
    _request(st)  # warm-up, of the window's shape
    if device == "cuda":
        torch.cuda.synchronize()
    st.phases["zero and warm-up request"] = time.perf_counter() - t0
    return st


def _request(st: State) -> float:
    """One /evaluate of the next transfers; returns its latency in s."""
    t = st.traffic["transfers_per_request"]
    pick = torch.randperm(len(st.bal), generator=st.gen)[:2 * t].tolist()
    amt = torch.randint(0, len(st.amt), (t,), generator=st.gen).tolist()
    ops, new = [], []
    tname = st.type.name
    for f, to, a in zip(pick[:t], pick[t:], amt):
        hf, ht, ha = st.acc_h[f], st.acc_h[to], st.amt_h[a]
        cond = _handle(st, "le", [ha, hf], "ebool")
        moved = _handle(st, "select", [cond, ha, st.zero], tname)
        ops += [("le", [ha, hf]), ("select", [cond, ha, st.zero]), ("sub", [hf, moved]), ("add", [ht, moved])]
        new.append((f, _handle(st, "sub", [hf, moved], tname), to, _handle(st, "add", [ht, moved], tname)))
    with span("request"):
        t0 = time.perf_counter()
        res = st.client.evaluate_many(ops)
        lat = time.perf_counter() - t0
    got = res["handles"]
    if got[2::4] != [n[1] for n in new] or got[3::4] != [n[3] for n in new]:
        raise RuntimeError("/evaluate returned other handles than the client derived")
    for (f, hf, to, ht), a in zip(new, amt):
        erc20.transfer(st.bal, f, to, st.amt[a], st.bits)
        st.acc_h[f], st.acc_h[to] = hf, ht
    return lat


def window(st: State, seconds: float) -> dict:
    lat = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        lat.append(_request(st))
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    n = len(lat)
    return {"window_s": window_s, "attempted": n, "failed": 0,
            "transfers": n * st.traffic["transfers_per_request"], "latencies_s": lat}


def check(st: State) -> dict:
    items = st.inst.kms_items([(bytes.fromhex(h[2:]), CONTRACT) for h in st.acc_h])
    blocks = torch.from_numpy(np.stack([it["blocks"] for it in items]).view(np.int64)).to(st.device)
    st.server.stop()
    del st.inst, st.server
    if st.device == "cuda":
        torch.cuda.empty_cache()
    glwe_sk, _, _ = rt.secret_keys(st.p, st.seed, st.device)
    ph = rt.phase(glwe_sk.reshape(-1), blocks)  # (accounts, blocks)
    modulus = st.p.message_modulus * st.p.carry_modulus
    digits = rt.decode(st.p, ph, modulus)
    noise = rt.centered(ph - digits * st.p.delta).max().item()
    bits = int(math.log2(st.p.message_modulus))
    got = [sum(int(d) << (bits * i) for i, d in enumerate(row)) & ((1 << st.bits) - 1) for row in digits.tolist()]
    wrong = sum(g != w for g, w in zip(got, st.bal))
    return {"wrong": wrong, "noise_bits": math.log2(noise) if noise > 0 else 0.0}
