"""The controls: the plain reference put in the program's place, computed
below the precision the configurations state. They have to come out not
correct.

- `float32`: the rotation's products in float32 (TF32 off), the precision
  below the float64 the configurations state.
- `bsk_44_bits`: the products exact, the bootstrap key held at its 44 most
  significant bits (the program holds it at 52 or 53 for its primes): a
  less drastic step, which raises the output noise and still decrypts
  most balances, so that the ERC20 cells' `noise_bits` limit, and not
  only `wrong`, has to catch it.

On the CPU at a toy size; on the card (`-m card`) at each cell's own size,
on three seeds, through the whole harness with a short window (one batch
or one request) served by the control; each prints its readings as a
JSON line (`-s` shows them)."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import tfhe as rt
from benchmark.tests.conftest import ROOT, toy_cell

TOY_LIMITS = {"wrong": 0, "gap_bits": 52.0, "noise_bits": 56.0}
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
CONTROLS = {"float32": (torch.float32, None), "bsk_44_bits": (torch.float64, 44)}
TOY_KEY_BITS = 36  # a toy rotation has 6 groups, not 306: fewer bits move its noise as far


def held_at(x: torch.Tensor, bits: int) -> torch.Tensor:
    """u64 torus values rounded to their `bits` most significant bits."""
    return rt.round_msb(x, bits) << (64 - bits)


def _in_place(monkeypatch, cell, seed, device, dtype=torch.float32, key_bits=None):
    """Patch the reference, in `dtype` and with its bootstrap key held at
    `key_bits` (None: all 64), over the program's PBS: shortint's apply_lut
    (the PBS cells' entry) and the integer layer's _pbs_flat."""
    from tfhe_tpu_torch.models import integer as ri
    from tfhe_tpu_torch.models import shortint as si

    torch.backends.cuda.matmul.allow_tf32 = False
    p = rt.Params.from_config(cell.config)
    keys = rt.keygen(p, seed, device)
    if key_bits is not None:
        keys = dataclasses.replace(keys, bsk=held_at(keys.bsk, key_bits))

    def pbs_flat(sk, ct, lut):
        return rt.pbs(p, keys, ct, lut.expand(ct.shape[0], -1, -1), dtype)

    def apply_lut(sk, c, lut, out_degree):
        return si.Ciphertext(ct=pbs_flat(sk, c.ct, lut), params=c.params, degree=out_degree, noise_level=1)

    monkeypatch.setattr(si, "apply_lut", apply_lut)
    monkeypatch.setattr(ri, "_pbs_flat", pbs_flat)


@pytest.mark.parametrize("config,traffic", [("toy_c22", "toy_pbs"), ("toy_g3", "toy_pbs"), ("toy_g3", "toy_erc20")])
def test_control_is_not_correct_toy(monkeypatch, config, traffic):
    cell = toy_cell(config, traffic, TOY_LIMITS)
    seed = SEEDS[0]
    _in_place(monkeypatch, cell, seed, "cpu", torch.float64)
    sound = harness.execute(ROOT, cell.name, seed, 0.2, False, "cpu", time.perf_counter(), cell)
    assert sound["correct"], sound["checks"]  # the reference in float64 in the program's place passes
    _in_place(monkeypatch, cell, seed, "cpu")
    res = harness.execute(ROOT, cell.name, seed, 0.2, False, "cpu", time.perf_counter(), cell)
    assert not res["correct"]


def test_key_bits_control_fails_the_noise_limit_toy(monkeypatch):
    """The key held at fewer bits moves the ERC20 cell's noise over its
    limit while most balances still decrypt."""
    cell = toy_cell("toy_g3", "toy_erc20", TOY_LIMITS)
    seed = SEEDS[1]
    _in_place(monkeypatch, cell, seed, "cpu", torch.float64, TOY_KEY_BITS)
    res = harness.execute(ROOT, cell.name, seed, 0.2, False, "cpu", time.perf_counter(), cell)
    noise = res["checks"]["noise_bits"]
    assert noise["limit"] < noise["value"] < 62, res["checks"]
    assert res["checks"]["wrong"]["value"] < cell.traffic["accounts"] // 2, res["checks"]


def test_held_at():
    x = torch.tensor([0x0123456789ABCDEF, -1, 1 << 62], dtype=torch.int64)
    assert held_at(x, 64).tolist() == x.tolist()
    assert held_at(x, 8).tolist() == [0x0100000000000000, 0, 1 << 62]


def _in_place_for_window(monkeypatch, cell, seed, device, control):
    """The program serves set-up (the ERC20 cells' inputs, zero and warm-up
    request); the control takes its place from the window's start."""
    load = harness._module

    def module(path):
        m = load(path)
        if path.parent.name == "generators":
            window = m.window

            def controlled(st, seconds):
                _in_place(monkeypatch, cell, seed, device, *CONTROLS[control])
                return window(st, seconds)

            m.window = controlled
        return m

    monkeypatch.setattr(harness, "_module", module)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("workload", ["g3_erc20_b32", "c22_pbs_b512", "g3_erc20_b1", "g3_pbs_b512"])
def test_control_at_cell_size(card, monkeypatch, workload, control, seed):
    cell = harness.load_cell(ROOT, workload)
    harness.prepare_env(ROOT, cell.config)
    _in_place_for_window(monkeypatch, cell, seed, card, control)
    t0 = time.perf_counter()
    res = harness.execute(ROOT, workload, seed, 0.1, False, card, t0, cell)
    print(json.dumps({"workload": workload, "control": control, "seed": seed, "checks": res["checks"],
                      "seconds": time.perf_counter() - t0}))
    assert not res["correct"]
