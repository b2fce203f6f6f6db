"""The port's routed experts on the GLWE matmul, on the CPU at TOY_MATMUL
(N = 256) with 4-bit values and one key, created once and handed to every
executor by patching glwe_matmul.create_private_key. No JAX: the JAX
package has no routed matmul, so the yardsticks are plain integer products,
the port's own `matrix_multiplication` and the plain float32 DeepSeek-V2
layer of `tests/deepseek_v2_reference.py`.

* expert_matmul: every pair decrypts to its plain integer product, and
  each expert's results are bit-identical to `matrix_multiplication` on
  its rows, with uneven loads, an expert with no rows, one with every row
  and a shared expert on the card's own share of the rows; a tiny
  workspace (one pair a slice) gives the same bits; the one-expert case is
  `matrix_multiplication`; the counters and spans;
* HybridFHEModel over a toy DeepSeek-V2 layer (hidden 64, 8 experts, top-2,
  2 shared), its MoE block and MLA projections swapped: DISABLE against the
  reference, EXECUTE equal to DISABLE; four blocks of 2 held experts each,
  the shared experts on one of them, add up to the whole layer.
"""

import types

import numpy as np
import pytest
import torch

from tests import deepseek_v2_reference as ref
from tfhe_tpu_torch.ml.hybrid import FheMoEModule, HybridFHEModel
from tfhe_tpu_torch.models import glwe_matmul as gm
from tfhe_tpu_torch.params import TOY_MATMUL
from tfhe_tpu_torch.utils import profiling

ROWS, INNER, OUT = 4, 300, 20  # two input chunks at N = 256
# (row, expert): expert 0 uneven (row 0 twice), 1 none, 2 every row, 3 one
# row, 4 the shared expert on rows 0-1, the card's own share
ROUTING = [(0, 2), (0, 0), (1, 2), (2, 2), (3, 2), (3, 3), (0, 0), (0, 4), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def key():
    """The one key of the file, handed to every executor's keygen."""
    pkey = gm.create_private_key(TOY_MATMUL, seed=7, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gm, "create_private_key", lambda *a, **k: pkey)
        yield pkey


@pytest.fixture(scope="module")
def problem(key):
    g = torch.Generator().manual_seed(11)
    x = torch.randint(0, 16, (ROWS, INNER), generator=g)
    ws = [torch.randint(-8, 8, (INNER, OUT), generator=g) for _ in range(5)]
    enc = gm.encrypt_matrix(key, x, seed=3)
    preps = [gm.prepare_clear_weights(TOY_MATMUL, w, device="cpu") for w in ws]
    return x, ws, enc, preps, gm.expert_matmul(enc, preps, ROUTING, key)


def _rows(enc, rows):
    return gm.EncryptedMatrix(glwes=enc.glwes[rows], params=enc.params, n_valid=enc.n_valid,
                              shape=(len(rows), enc.n_valid))


def test_expert_matmul_per_pair(key, problem):
    x, ws, enc, preps, res = problem
    assert res.shape == (len(ROUTING), OUT) and res.data.shape == (len(ROUTING), 1, 2, 256)
    want = torch.stack([x[r] @ ws[e] for r, e in ROUTING])
    assert torch.equal(gm.decrypt_matrix(res, key), want)
    for e in range(len(preps)):
        pairs = [i for i, (_, ex) in enumerate(ROUTING) if ex == e]
        if not pairs:
            continue
        alone = gm.matrix_multiplication(_rows(enc, [ROUTING[i][0] for i in pairs]), preps[e], key)
        assert torch.equal(res.data[pairs], alone.data)


def test_tiny_workspace_gives_the_same_bits(key, problem, monkeypatch):
    _, _, enc, preps, res = problem
    slices = gm.expert_matmul.slices
    monkeypatch.setattr(gm, "WORKSPACE_BYTES", 1)
    one_a_slice = gm.expert_matmul(enc, preps, ROUTING, key)
    assert gm.expert_matmul.slices - slices == len(ROUTING)
    assert torch.equal(one_a_slice.data, res.data)


def _engine():
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine

    return get_folded_engine(TOY_MATMUL.polynomial_size, device="cpu")


def test_one_expert_is_matrix_multiplication(key, problem):
    """One expert over every row in order gives matrix_multiplication's
    bits; a routing that picks and reorders rows gives those of the plain
    product on those rows."""
    x, ws, enc, preps, _ = problem
    every = gm.expert_matmul(enc, preps[:1], [(i, 0) for i in range(ROWS)], key)
    assert torch.equal(every.data, gm.matrix_multiplication(enc, preps[0], key).data)
    routed = gm.expert_matmul(enc, preps[:1], [(2, 0), (1, 0)], key)
    assert torch.equal(routed.data, gm.matrix_multiplication(_rows(enc, [2, 1]), preps[0], key).data)
    assert torch.equal(gm.decrypt_matrix(routed, key), x[[2, 1]] @ ws[0])


def test_counters_spans_and_empty_routing(key, problem, monkeypatch):
    _, _, enc, preps, _ = problem
    before = (gm.expert_matmul.calls, gm.expert_matmul.pairs, gm.expert_matmul.slices)
    spans = profiling.SPANS.expert.count
    monkeypatch.setattr(gm, "WORKSPACE_BYTES", 2 * gm.pair_bytes(preps[0], _engine()))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        gm.expert_matmul(enc, preps, ROUTING[:3], key)
        empty = gm.expert_matmul(enc, preps, np.zeros((0, 2), np.int64), key)
    after = (gm.expert_matmul.calls, gm.expert_matmul.pairs, gm.expert_matmul.slices)
    assert [a - b for a, b in zip(after, before)] == [2, 3, 2]
    assert empty.shape == (0, OUT) and empty.data.shape[0] == 0
    # route twice; products and keyswitch once a slice, products once more for the K1 of the rows
    assert profiling.SPANS.expert.count - spans == 2 + 3 + 2
    assert {"expert.route", "expert.products", "expert.keyswitch"} <= set(profiling.SPANS.total)
    with pytest.raises(ValueError, match="expert outside"):
        gm.expert_matmul(enc, preps, [(0, 5)], key)
    with pytest.raises(ValueError, match="row outside"):
        gm.expert_matmul(enc, preps, [(ROWS, 0)], key)


# -- the DeepSeek-V2 layer -------------------------------------------------------

TOY = ref.Config(hidden_size=64, num_attention_heads=2, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                 v_head_dim=8, moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
                 num_experts_per_tok=2)
MLA = ["self_attn.q_proj", "self_attn.kv_a_proj_with_mqa", "self_attn.kv_b_proj", "self_attn.o_proj"]
TOKENS = 2  # each token a row of every MLA projection and ~4 pairs of each grouped call
# Tolerances on the relative Frobenius distance from the float32 reference.
# Quantization alone sets them: the integer pipeline is exact (EXECUTE
# equals DISABLE). At 4 bits (16 input levels over a batch's range, weights
# at max|w| / 7) the MoE block's two quantized stages (gate|up, then down on
# SiLU(gate) * up) read 0.21-0.31 on seeds 5-8, whole or in four shares:
# MOE_TOL_4. At 8 bits the error falls ~16 times (0.013-0.021), so MOE_TOL_8
# catches a pair routed to a wrong expert or dropped. The layer's update
# (output less input), with the four MLA projections at 4 bits too, reads
# 0.16-0.24: LAYER_TOL_4.
MOE_TOL_4, MOE_TOL_8, LAYER_TOL_4 = 0.45, 0.04, 0.40


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def layer():
    torch.manual_seed(5)
    net = ref.DecoderLayer(TOY).eval()
    x = torch.randn(1, TOKENS, TOY.hidden_size)
    with torch.no_grad():
        want = net(x)
        h = x + net.self_attn(net.input_layernorm(x))
        moe_in = net.post_attention_layernorm(h)
        moe_want = net.mlp(moe_in)
    return net, x, want, moe_in, moe_want


@pytest.fixture(scope="module")
def hybrid(key, layer):
    import copy

    net, *_ = layer
    model = HybridFHEModel(copy.deepcopy(net), MLA, params=TOY_MATMUL, n_bits=4, moe_blocks=["mlp"])
    return model.compile(device="cpu")


def test_hybrid_layer_disable_against_reference(hybrid, layer):
    net, x, want, moe_in, moe_want = layer
    with torch.no_grad():
        got = hybrid(x, fhe="disable")
        assert _rel(hybrid.model.mlp(moe_in), moe_want) < MOE_TOL_4
        assert _rel(got - x, want - x) < LAYER_TOL_4
        assert _rel(FheMoEModule(net.mlp, params=TOY_MATMUL, n_bits=8)(moe_in), moe_want) < MOE_TOL_8


def test_hybrid_layer_execute_equals_disable(hybrid, layer):
    """EXECUTE decrypts the exact integer accumulators of DISABLE's
    pipeline: the same floats."""
    _, x, *_ = layer
    with torch.no_grad():
        assert torch.equal(hybrid(x, fhe="execute"), hybrid(x, fhe="disable"))


@pytest.mark.parametrize("bits,tol", [(4, MOE_TOL_4), (8, MOE_TOL_8)])
def test_expert_shares_add_up(layer, bits, tol):
    """Four servers of 2 held experts each, the shared experts on one of
    them, give the whole MoE block (DISABLE): the same routing and input
    quantization; each down call's inputs quantized over its own pairs."""
    net, _, _, moe_in, moe_want = layer
    routed_only = types.SimpleNamespace(gate=net.mlp.gate, experts=net.mlp.experts, shared_experts=None)
    parts = [FheMoEModule(net.mlp if i == 0 else routed_only, held=(2 * i, 2 * i + 1), params=TOY_MATMUL,
                          n_bits=bits) for i in range(4)]
    assert [p.executor.n_shared for p in parts] == [2, 0, 0, 0]
    with torch.no_grad():
        assert _rel(sum(p(moe_in) for p in parts), moe_want) < tol
