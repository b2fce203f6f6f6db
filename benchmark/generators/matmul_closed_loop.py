"""Encrypted x clear GLWE matmuls in a closed loop: the program's
`glwe_matmul.matrix_multiplication` of encrypted (rows x inner) inputs with
the clear (inner x out) weights of each of the traffic's `layers` in turn,
one synchronise a matmul, as a server runs a model's linear layers.

Set-up: the program's keys from the seed (`create_private_key`); each
layer's weight matrix of signed `weight_bits`-bit values drawn from the seed
and prepared once by the program (`prepare_clear_weights`), as a server
loads its layers; each layer's `input_matrices` inputs of unsigned
`input_bits`-bit values, drawn from the seed and encrypted by the benchmark
under the input key the reference works out from the same seed; one
warm-up matmul a layer. The window runs the layers in order, pass after
pass, each pass on the next of each layer's inputs, and keeps every result.

After the window, with the program's keys and weights freed, under the
reference's post key and lifted to q = 2^64:
- `err_bits`: log2 of the widest distance of an output's phase from its
  clear product times delta, over every output of every kept result;
- `wrong_outputs`: the outputs whose phase lies 2^WRONG_UNITS_LOG2 stored
  units (of 2^ct_modulus_out_bits) or more from their clear product times
  delta: a wrong weight, row or column;
- `gap_bits`: log2 of the widest distance between the program's output
  phase and the reference's, on `check_rows` rows of each layer drawn from
  the seed across the inputs that the window ran.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import system
from benchmark.reference import glwe_matmul as rm
from benchmark.reference import tfhe as rt
from benchmark.trace import span

WRONG_UNITS_LOG2 = 10


class Layer:
    """One layer: its clear weights (inner, out), its inputs (input_matrices,
    rows, inner) and their GLWEs (rows, chunks, k+1, N) each; the program's
    EncryptedMatrix of each input and PreparedClearMatrix of the weights."""

    def __init__(self, name, inner, out, weights, inputs, glwes, enc):
        self.name, self.inner, self.out = name, inner, out
        self.weights, self.inputs, self.glwes, self.enc = weights, inputs, glwes, enc
        self.prepared = None


class State:
    pass


def setup(cell, seed: int, device: str) -> State:
    from tfhe_tpu_torch.models import glwe_matmul as gm

    cfg, t = cell.config, cell.traffic
    st = State()
    st.gm, st.device, st.seed, st.traffic = gm, device, seed, t
    st.p = rm.Params.from_config(cfg)
    st.prog = system.matmul_params(cfg)
    t0 = time.perf_counter()
    st.key = gm.create_private_key(st.prog, seed=seed, device=device)
    st.phases = {"keygen": time.perf_counter() - t0}
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    half, rows = 1 << (t["weight_bits"] - 1), t["rows"]
    key = rm.input_key(st.p, seed, device)
    st.layers = []
    for spec in t["layers"]:
        c, o = spec["inner"], spec["out"]
        w = torch.randint(-half, half, (c, o), generator=gen, device=device)
        x = torch.randint(0, 1 << t["input_bits"], (t["input_matrices"], rows, c), generator=gen, device=device)
        glwes = [rm.encrypt_rows(st.p, key, xi, gen) for xi in x]
        enc = [gm.EncryptedMatrix(glwes=g, params=st.prog, n_valid=c, shape=(rows, c)) for g in glwes]
        st.layers.append(Layer(spec["name"], c, o, w, x, glwes, enc))
    st.phases["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for layer in st.layers:
        layer.prepared = gm.prepare_clear_weights(st.prog, layer.weights, device=device)
    st.phases["weights prepared"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for layer in st.layers:  # warm-up: the kernels built, every shape seen
        st.gm.matrix_multiplication(layer.enc[0], layer.prepared, st.key)
    if device == "cuda":
        torch.cuda.synchronize()
    st.phases["warm-up matmuls"] = time.perf_counter() - t0
    return st


def window(st: State, seconds: float) -> dict:
    sync = torch.cuda.synchronize if st.device == "cuda" else (lambda: None)
    rows = st.traffic["rows"]
    st.results = []  # (layer index, input index, result)
    calls = [0] * len(st.layers)
    n = macs = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        i = n % len(st.layers)
        layer = st.layers[i]
        j = (n // len(st.layers)) % len(layer.enc)
        with span("matmul"):
            out = st.gm.matrix_multiplication(layer.enc[j], layer.prepared, st.key)
        with span("sync"):
            sync()
        st.results.append((i, j, out))
        calls[i] += 1
        macs += rows * layer.inner * layer.out
        n += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "attempted": n, "failed": 0, "matmuls": n, "macs": macs,
            "layer_calls": dict(zip((layer.name for layer in st.layers), calls))}


def _log2(x: float) -> float:
    return math.log2(x) if x > 0 else 0.0


def check(st: State) -> dict:
    t, p = st.traffic, st.p
    rows = t["rows"]
    results, st.results = st.results, None
    # free the program's state before the reference takes the card
    del st.key
    for layer in st.layers:
        layer.enc = layer.prepared = None
    if st.device == "cuda":
        torch.cuda.empty_cache()
    keys = rm.keygen(p, st.seed, st.device)
    wrong_at = 1 << (64 - p.ct_modulus_out_bits + WRONG_UNITS_LOG2)
    err, wrong, gap, sound = 0, 0, 0, True
    pick_gen = torch.Generator().manual_seed(st.seed)
    for i, layer in enumerate(st.layers):
        mine = [(j, r) for li, j, r in results if li == i]
        if not mine:
            continue
        sound &= all(r.shape == (rows, layer.out) and r.n_bits_out == p.ct_modulus_out_bits for _, r in mine)
        if not sound:
            break
        stored = torch.stack([r.data for _, r in mine]).to(torch.int64)
        sound &= bool(((stored >= 0) & (stored < (1 << p.ct_modulus_out_bits))).all())
        clear = (layer.inputs.to(torch.float64) @ layer.weights.to(torch.float64)).to(torch.int64)  # exact below 2^53
        which = torch.tensor([j for j, _ in mine], device=stored.device)
        dist = rt.centered(rm.output_phase(p, keys.post_key, stored, layer.out) - clear[which] * p.delta)
        err = max(err, dist.max().item())
        wrong += int((dist >= wrong_at).sum())
        # the reference over rows drawn from the seed; the program's first
        # result of each input stands for the others (err_bits covers them)
        first = {}
        for j, r in mine:
            first.setdefault(j, r)
        ran = sorted(first)
        pick = torch.randperm(len(ran) * rows, generator=pick_gen)[:t["check_rows"]].tolist()
        glwes = torch.stack([layer.glwes[ran[k // rows]][k % rows] for k in pick])
        ref = rm.matmul(p, keys, glwes, layer.weights)
        prog = torch.stack([first[ran[k // rows]].data[k % rows] for k in pick]).to(torch.int64)
        gap = max(gap, rt.centered(rm.output_phase(p, keys.post_key, prog, layer.out)
                                   - rm.output_phase(p, keys.post_key, ref, layer.out)).max().item())
    if not sound:  # a result of the wrong shape or outside the output modulus: every output counts as wrong
        return {"err_bits": 64.0, "wrong_outputs": float(sum(rows * st.layers[i].out for i, _, _ in results)),
                "gap_bits": 64.0}
    return {"err_bits": _log2(err), "wrong_outputs": float(wrong), "gap_bits": _log2(gap)}
