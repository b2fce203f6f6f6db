"""A card's routed experts of DeepSeek-V2-style MoE layers on the GLWE
server, in a closed loop of one client: the program's
`glwe_matmul.expert_matmul`, the held experts' gate and up projections as
one grouped call, then their down projections as another, one synchronise
a call, the configuration's `moe_layers_held` layers in order.

Set-up: the program's keys from the seed; for each layer, a router of the
published width (`n_routed_experts` x `hidden_size`, float32), and the
`experts_held` routed experts and `n_shared_experts` shared experts of
signed `weight_bits`-bit weights, each prepared once by the program as
gate|up (hidden x 2 moe_intermediate) and down (moe_intermediate x hidden)
matrices; for each of the traffic's `input_sets`, `tokens` hidden states,
Gaussian noise plus one of `topics` fixed directions of the noise's
expected norm, routed by the reference router (softmax, greedy top-k): the
pairs whose expert is held, then tokens 0 .. `shared_tokens`-1 through each
shared expert; the hidden states quantized to unsigned `input_bits`, and a
row of unsigned `input_bits` down inputs drawn a pair, both encrypted by
the benchmark under the input key the reference works out from the seed;
one warm-up layer. The window runs the layers in order, pass after pass,
each pass on the next input set, and keeps every result; it ends with the
layer running at the deadline.

After the window, with the program's keys and weights freed, under the
reference's post key and lifted to q = 2^64:
- `missing_pairs`: over the window's calls, routed pairs without a result
  and results without a routed pair (a result holds one row a pair);
- `err_bits`: log2 of the widest distance of an output's phase from its
  pair's exact product (`reference/deepseek_v2_moe.pair_products`) times
  delta, over every output of every kept result;
- `wrong_outputs`: the outputs 2^WRONG_UNITS_LOG2 stored units or more from
  their product (every output of a call whose result misses pairs);
- `gap_bits`: log2 of the widest distance between the program's output
  phase and the reference's plain GLWE matmul, on `check_pairs` pairs of
  each layer and call drawn from the seed.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from benchmark import system
from benchmark.reference import deepseek_v2_moe as dm
from benchmark.reference import glwe_matmul as rm
from benchmark.reference import tfhe as rt
from benchmark.trace import span

WRONG_UNITS_LOG2 = 10
CALLS = ("gate_up", "down")


class Call:
    """One grouped call's operands: the encrypted rows (the program's
    EncryptedMatrix, and their GLWEs), their clear values, and the routing
    (pairs, 2) of (row, local expert)."""

    def __init__(self, values, glwes, enc, routing):
        self.values, self.glwes, self.enc, self.routing = values, glwes, enc, routing
        self.unique_rows = int(routing[:, 0].unique().numel())
        self.experts = int(routing[:, 1].unique().numel())


class Layer:
    """One MoE layer: its clear expert weights (int8), per call kind (E, C, O),
    the program's prepared matrices, and its calls per input set."""

    def __init__(self, weights):
        self.weights = weights  # {"gate_up": (E, C, 2I), "down": (E, I, C)}
        self.prepared = {}
        self.sets = []  # [{"gate_up": Call, "down": Call}]


class State:
    pass


def setup(cell, seed: int, device: str) -> State:
    from benchmark.harness import Refused
    from tfhe_tpu_torch.models import glwe_matmul as gm

    if not hasattr(gm, "expert_matmul"):
        raise Refused("the program has no routed matmul (glwe_matmul.expert_matmul)")
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
    c, inter, tokens = cfg["hidden_size"], cfg["moe_intermediate_size"], t["tokens"]
    held, n_experts = cfg["experts_held"], cfg["experts_held"] + cfg["n_shared_experts"]
    half, top = 1 << (t["weight_bits"] - 1), 1 << t["input_bits"]
    key = rm.input_key(st.p, seed, device)
    topics = torch.randn((t["topics"], c), generator=gen, device=device)
    topics *= math.sqrt(c) / topics.norm(dim=1, keepdim=True)
    shared = torch.stack([torch.arange(t["shared_tokens"], device=device).repeat_interleave(n_experts - held),
                          torch.arange(held, n_experts, device=device).repeat(t["shared_tokens"])], dim=1)
    st.layers, st.loads = [], []
    for _ in range(cfg["moe_layers_held"]):
        router = torch.randn((cfg["n_routed_experts"], c), generator=gen, device=device) / math.sqrt(c)
        layer = Layer({
            "gate_up": torch.randint(-half, half, (n_experts, c, 2 * inter), generator=gen, device=device,
                                     dtype=torch.int8),
            "down": torch.randint(-half, half, (n_experts, inter, c), generator=gen, device=device, dtype=torch.int8),
        })
        for _ in range(t["input_sets"]):
            topic = torch.randint(0, t["topics"], (tokens,), generator=gen, device=device)
            hidden = torch.randn((tokens, c), generator=gen, device=device) + topics[topic]
            routing = torch.cat([dm.held_pairs(hidden, router, cfg["num_experts_per_tok"], held), shared])
            load = torch.bincount(routing[:, 1], minlength=n_experts)[:held].to(torch.float64)
            st.loads.append((len(routing), (load.max() / load.mean()).item()))
            x = _quantized(hidden, t["input_bits"])
            h = torch.randint(0, top, (len(routing), inter), generator=gen, device=device)
            pair_rows = torch.stack([torch.arange(len(routing), device=device), routing[:, 1]], dim=1)
            layer.sets.append({"gate_up": _call(st, key, gen, x, routing), "down": _call(st, key, gen, h, pair_rows)})
        st.layers.append(layer)
    st.phases["inputs and routing"] = time.perf_counter() - t0
    print("moe: pairs a call " + ", ".join(str(n) for n, _ in st.loads) + "; max/mean rows a held expert "
          + ", ".join(f"{r:.3f}" for _, r in st.loads), file=sys.stderr)
    t0 = time.perf_counter()
    for layer in st.layers:  # as a server loads its layers
        layer.prepared = {kind: [gm.prepare_clear_weights(st.prog, w, device=device) for w in layer.weights[kind]]
                          for kind in CALLS}
    st.phases["weights prepared"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for kind in CALLS:  # warm-up: the kernels built, both calls' shapes seen
        call = st.layers[0].sets[0][kind]
        gm.expert_matmul(call.enc, st.layers[0].prepared[kind], call.routing.cpu(), st.key)
    if device == "cuda":
        torch.cuda.synchronize()
    st.phases["warm-up layer"] = time.perf_counter() - t0
    return st


def _quantized(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned `bits`-bit values over the batch's range, as the client's
    activation quantizer gives them."""
    lo, hi = min(x.min().item(), 0.0), max(x.max().item(), 0.0)
    scale = (hi - lo) / ((1 << bits) - 1) or 1.0
    return torch.clamp(torch.round((x - lo) / scale), 0, (1 << bits) - 1).to(torch.int64)


def _call(st: State, key, gen, values: torch.Tensor, routing: torch.Tensor) -> Call:
    glwes = rm.encrypt_rows(st.p, key, values, gen)
    r, c = values.shape
    enc = st.gm.EncryptedMatrix(glwes=glwes, params=st.prog, n_valid=c, shape=(r, c))
    return Call(values, glwes, enc, routing.cpu())


def window(st: State, seconds: float) -> dict:
    sync = torch.cuda.synchronize if st.device == "cuda" else (lambda: None)
    st.results = []  # (layer index, input set, call kind, result)
    calls = []  # what each call ran, for the roofline: (kind, pairs, unique rows, experts with pairs)
    n = macs = pairs = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:  # whole layers, so that every window holds its calls in the same mix
        i = n % len(st.layers)
        layer = st.layers[i]
        j = (n // len(st.layers)) % len(layer.sets)
        for kind in CALLS:
            call = layer.sets[j][kind]
            with span("expert_call"):
                out = st.gm.expert_matmul(call.enc, layer.prepared[kind], call.routing, st.key)
            with span("sync"):
                sync()
            st.results.append((i, j, kind, out))
            inner, width = layer.weights[kind].shape[1:]
            macs += len(call.routing) * inner * width
            pairs += len(call.routing)
            calls.append((kind, len(call.routing), call.unique_rows, call.experts))
        n += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "attempted": len(calls), "failed": 0, "macs": macs, "pairs": pairs,
            "calls": calls}


def _log2(x: float) -> float:
    return math.log2(x) if x > 0 else 0.0


def check(st: State) -> dict:
    t, p = st.traffic, st.p
    results, st.results = st.results, None
    del st.key  # free the program's state before the reference takes the card
    for layer in st.layers:
        layer.prepared = None
        for s in layer.sets:
            for call in s.values():
                call.enc = None
    if st.device == "cuda":
        torch.cuda.empty_cache()
    keys = rm.keygen(p, st.seed, st.device)
    wrong_at = 1 << (64 - p.ct_modulus_out_bits + WRONG_UNITS_LOG2)
    err = gap = missing = wrong = 0
    pick_gen = torch.Generator().manual_seed(st.seed)
    first = {}
    for i, j, kind, res in results:
        layer = st.layers[i]
        call = layer.sets[j][kind]
        n_pairs, width = len(call.routing), layer.weights[kind].shape[-1]
        rows = res.data.shape[0] if res.data.dim() == 4 else 0
        missing += abs(rows - n_pairs)
        stored = res.data.to(torch.int64)
        if (rows != n_pairs or res.shape != (n_pairs, width) or res.n_bits_out != p.ct_modulus_out_bits
                or not bool(((stored >= 0) & (stored < (1 << p.ct_modulus_out_bits))).all())):
            err, wrong = 2**64, wrong + n_pairs * width  # unassignable: every output of the call is wrong
            continue
        routing = call.routing.to(st.device)
        clear = dm.pair_products(call.values, layer.weights[kind], routing[:, 0], routing[:, 1])
        dist = rt.centered(rm.output_phase(p, keys.post_key, stored, width) - clear * p.delta)
        err = max(err, dist.max().item())
        wrong += int((dist >= wrong_at).sum())
        first.setdefault((i, kind), (j, res))
    for (i, kind), (j, res) in sorted(first.items()):
        layer, call = st.layers[i], st.layers[i].sets[j][kind]
        width = layer.weights[kind].shape[-1]
        for k in torch.randperm(len(call.routing), generator=pick_gen)[:t["check_pairs"]].tolist():
            row, e = call.routing[k].tolist()
            ref = rm.matmul(p, keys, call.glwes[row][None], layer.weights[kind][e].to(torch.int64))
            mine = res.data[k][None].to(torch.int64)
            gap = max(gap, rt.centered(rm.output_phase(p, keys.post_key, mine, width)
                                       - rm.output_phase(p, keys.post_key, ref, width)).max().item())
    return {"err_bits": _log2(err), "wrong_outputs": float(wrong), "gap_bits": _log2(gap),
            "missing_pairs": float(missing)}
