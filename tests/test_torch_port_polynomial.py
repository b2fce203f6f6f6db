"""tfhe_tpu_torch.ops.polynomial against tfhe_tpu.ops.polynomial.

The cases of tests/test_polynomial.py and tests/test_four_step.py, case by
case, on the port's plain torch engine: each output is held against the
Python-int ground truth and, on the same inputs, against the JAX package's
function (every transform is exact mod p, so the two agree bit for bit).
The JAX four-step transform at N = 2048 compiles for a while, so that
comparison is in the slow tier; the default tier holds the port's own
N = 2048 round trip and its four-step engine against its radix-2 engine.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops import polynomial as jpoly
from tfhe_tpu_torch.ops import get_engine as ops_get_engine
from tfhe_tpu_torch.ops.polynomial import (
    DEFAULT_PRIMES,
    FourStepNtt,
    NegacyclicEngine,
    _ntt_tables,
    fntt,
    get_engine,
    intt,
    negacyclic_polymul_reference,
)

U64 = jnp.uint64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a) -> torch.Tensor:
    """numpy ints (uint64 bit patterns included) as an int64 tensor."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64))


def u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def test_constants_and_exports():
    assert DEFAULT_PRIMES == jpoly.DEFAULT_PRIMES
    assert ops_get_engine is get_engine
    for p in DEFAULT_PRIMES:
        for n in (16, 256):
            mine, ref = _ntt_tables(p, n), jpoly._ntt_tables(p, n)
            np.testing.assert_array_equal(mine[0], ref[0].astype(np.int64))
            np.testing.assert_array_equal(mine[1], ref[1].astype(np.int64))
            assert mine[2] == int(ref[2])


@pytest.mark.parametrize("p", DEFAULT_PRIMES)
@pytest.mark.parametrize("n", [16, 256])
def test_ntt_roundtrip(p, n):
    psi, psi_inv, n_inv = _ntt_tables(p, n)
    rs = np.random.RandomState(1)
    a = rs.randint(0, p, size=(3, n)).astype(np.uint64)
    f = fntt(t64(a), psi, p)
    if n == 16:  # JAX's eager butterflies cost seconds at larger N
        jf = jpoly.fntt(jnp.asarray(a), jnp.asarray(jpoly._ntt_tables(p, n)[0]), U64(p))
        np.testing.assert_array_equal(u64(f), np.asarray(jf))
    np.testing.assert_array_equal(u64(intt(f, psi_inv, n_inv, p)), a)


@pytest.mark.parametrize("p", DEFAULT_PRIMES)
def test_ntt_negacyclic_convolution_mod_p(p):
    """Pointwise product in the NTT domain == negacyclic convolution mod p."""
    n = 64
    psi, psi_inv, n_inv = _ntt_tables(p, n)
    rs = np.random.RandomState(2)
    a = rs.randint(0, p, size=n).astype(np.uint64)
    b = rs.randint(0, p, size=n).astype(np.uint64)
    conv = intt(fntt(t64(a), psi, p) * fntt(t64(b), psi, p) % p, psi_inv, n_inv, p)
    expected = negacyclic_polymul_reference(a, b, q=p).astype(np.uint64)
    np.testing.assert_array_equal(u64(conv), expected)


@pytest.mark.parametrize("n", [64, 256])
def test_polymul_small_x_u64_exact(n):
    """small signed poly x uniform u64 poly, exact mod 2^64, equal to JAX."""
    eng = get_engine(n, "cpu")
    rs = np.random.RandomState(3)
    a = rs.randint(-(2**15), 2**15, size=(2, n)).astype(np.int64)
    b = rs.randint(0, 2**64, size=(2, n), dtype=np.uint64)
    got = u64(eng.polymul(t64(a), t64(b)))
    for i in range(2):
        np.testing.assert_array_equal(got[i], negacyclic_polymul_reference(a[i], b[i]).astype(np.uint64))
    jeng = jpoly.get_engine(n)
    np.testing.assert_array_equal(got, np.asarray(jeng.polymul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        eng.forward_u64(t64(b)).numpy(), np.asarray(jeng.forward_u64(jnp.asarray(b))).astype(np.int32)
    )


def test_polymul_digits_x_modswitched_key():
    """Gadget-digit magnitudes (2^22) against 44-bit key values."""
    n = 256
    eng = get_engine(n, "cpu")
    rs = np.random.RandomState(8)
    a = rs.randint(-(2**22), 2**22, size=n).astype(np.int64)
    b = rs.randint(0, 2**44, size=n, dtype=np.uint64)
    got = u64(eng.polymul(t64(a), t64(b)))
    np.testing.assert_array_equal(got, negacyclic_polymul_reference(a, b).astype(np.uint64))


def test_polymul_binary_secret():
    """binary poly x u64 poly (the GLWE mask * secret product)."""
    n = 128
    eng = get_engine(n, "cpu")
    rs = np.random.RandomState(4)
    s = rs.randint(0, 2, size=n).astype(np.int64)
    m = rs.randint(0, 2**64, size=n, dtype=np.uint64)
    got = u64(eng.polymul(t64(s), t64(m)))
    np.testing.assert_array_equal(got, negacyclic_polymul_reference(s, m).astype(np.uint64))


def test_polymul_max_magnitude_guard():
    """The engine reports the JAX engine's headroom and is exact at the edge."""
    n = 256
    eng = get_engine(n, "cpu")
    assert eng.max_product_bits == jpoly.get_engine(n).max_product_bits >= 83
    hi = 2 ** (eng.max_product_bits - 64)
    rs = np.random.RandomState(5)
    a = rs.randint(-hi, hi, size=n).astype(np.int64)
    a[0] = hi - 1
    a[1] = -(hi - 1)
    b = np.full(n, 2**64 - 1, dtype=np.uint64)
    got = u64(eng.polymul(t64(a), t64(b)))
    np.testing.assert_array_equal(got, negacyclic_polymul_reference(a, b).astype(np.uint64))


def test_forward_small_accepts_u64_twos_complement():
    n = 64
    eng = get_engine(n, "cpu")
    a_signed = np.array([-5, 3] + [0] * (n - 2), dtype=np.int64)
    a_u64 = a_signed.astype(np.uint64)
    b = np.arange(n, dtype=np.uint64) * np.uint64(2**40)
    got1 = eng.polymul(t64(a_signed), t64(b))
    got2 = eng.polymul(t64(a_u64), t64(b))
    assert torch.equal(got1, got2)
    np.testing.assert_array_equal(
        eng.forward_small(t64(a_u64)).numpy(),
        np.asarray(jpoly.get_engine(n).forward_small(jnp.asarray(a_u64))).astype(np.int32),
    )


def test_transform_domain_accumulation():
    """sum_i a_i * b_i with one backward == the sum of polymuls."""
    n = 64
    eng = get_engine(n, "cpu")
    rs = np.random.RandomState(6)
    a = rs.randint(-(2**10), 2**10, size=(3, n)).astype(np.int64)
    b = rs.randint(0, 2**64, size=(3, n), dtype=np.uint64)
    prods = eng.pointwise_mul(eng.forward_small(t64(a)), eng.forward_u64(t64(b)))
    acc = prods[0]
    for i in range(1, 3):
        acc = eng.add_domain(acc, prods[i])
    got = u64(eng.backward(acc))
    expected = sum(negacyclic_polymul_reference(a[i], b[i]) for i in range(3)) % (2**64)
    np.testing.assert_array_equal(got, expected.astype(np.uint64))


# -- the four-step transform (tests/test_four_step.py) -------------------------


@pytest.mark.parametrize("p", DEFAULT_PRIMES)
@pytest.mark.parametrize("n", [16, 128, 2048])
def test_four_step_roundtrip(p, n):
    ntt = FourStepNtt(p, n, "cpu")
    rs = np.random.RandomState(n)
    x = rs.randint(0, p, size=(3, n)).astype(np.uint64)
    f = ntt.forward(t64(x))
    np.testing.assert_array_equal(u64(ntt.backward(f)), x)
    if n < 2048:
        np.testing.assert_array_equal(u64(f), np.asarray(jpoly.FourStepNtt(p, n).forward(jnp.asarray(x))))


@pytest.mark.slow
@pytest.mark.parametrize("p", DEFAULT_PRIMES)
def test_four_step_2048_equals_jax(p):
    n = 2048
    x = np.random.RandomState(n).randint(0, p, size=(3, n)).astype(np.uint64)
    got = u64(FourStepNtt(p, n, "cpu").forward(t64(x)))
    np.testing.assert_array_equal(got, np.asarray(jpoly.FourStepNtt(p, n).forward(jnp.asarray(x))))


@pytest.mark.parametrize("p", DEFAULT_PRIMES)
def test_four_step_convolution(p):
    """pointwise product in the four-step domain == negacyclic convolution."""
    n = 64
    ntt = FourStepNtt(p, n, "cpu")
    rs = np.random.RandomState(7)
    a = rs.randint(0, p, size=n).astype(np.uint64)
    b = rs.randint(0, p, size=n).astype(np.uint64)
    conv = ntt.backward(ntt.forward(t64(a)) * ntt.forward(t64(b)) % p)
    np.testing.assert_array_equal(u64(conv), negacyclic_polymul_reference(a, b, q=p).astype(np.uint64))


def test_engine_four_step_polymul_exact():
    eng = NegacyclicEngine(2048, ntt_impl="four_step", device="cpu")
    assert eng.ntt_impl == "four_step"
    rs = np.random.RandomState(9)
    a = rs.randint(-(2**15), 2**15, size=2048).astype(np.int64)
    b = rs.randint(0, 2**64, size=2048, dtype=np.uint64)
    got = eng.polymul(t64(a), t64(b))
    ref_eng = NegacyclicEngine(2048, ntt_impl="radix2", device="cpu")
    assert ref_eng.ntt_impl == "radix2"
    assert torch.equal(got, ref_eng.polymul(t64(a), t64(b)))
