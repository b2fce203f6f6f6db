"""The GLWE matmul slice of tfhe_tpu_torch against the JAX package, on the CPU.

One JAX keygen at TOY_MATMUL (N = 256) for the file, carried across:
* matrix_multiplication's CompressedResultMatrix.data equals JAX's bit for
  bit on the JAX ciphertexts, at c > N (two input chunks) and o > N (two
  output chunks), signed and unsigned weights; the prepared path equals
  the raw one; decrypt_matrix equals JAX's;
* packing_keyswitch equals JAX's on the carried packing key;
* backward_coeff equals JAX's and backward(f)[..., index];
* compress/decompress and the wire codec equal JAX's, byte for byte, and
  the port's bit-pack equals tfhe_tpu.native's;
* GlweLinearLayerExecutor gives JAX's output in DISABLE, SIMULATE and
  EXECUTE mode;
* noise estimates equal JAX's for every registered set.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import native
from tfhe_tpu import noise as jnoise
from tfhe_tpu import params as jp
from tfhe_tpu.core import packing as jpk
from tfhe_tpu.core import seeded as jsd
from tfhe_tpu.ml.linear import GlweLinearLayerExecutor as JaxExecutor
from tfhe_tpu.models import glwe_matmul as jgm
from tfhe_tpu.ops.folded_ntt import get_folded_engine as jax_engine
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import noise as tnoise
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import packing as tpk
from tfhe_tpu_torch.core import seeded as tsd
from tfhe_tpu_torch.core.glwe import decrypt_glwe
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.models import glwe_matmul as tgm
from tfhe_tpu_torch.ops import ntt_cuda
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 256
R, CIN, OUT = 2, 300, 300  # c > N and o > N: two input chunks, two output chunks


@pytest.fixture(scope="module")
def keys():
    """JAX TOY_MATMUL key (seed 71) and the port's copy."""
    pk = jgm.create_private_key(jp.TOY_MATMUL, seed=71)
    return pk, convert.matmul_private_key_from_reference(pk, device="cpu")


def _data(seed, signed, x_max=16, w_max=8):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, x_max, size=(R, CIN)).astype(np.uint64)
    w = rs.randint(-w_max if signed else 0, w_max, size=(CIN, OUT)).astype(np.int64)
    return x, w


@pytest.fixture(scope="module")
def reference_runs(keys):
    """JAX encrypt -> matrix_multiplication -> decrypt for unsigned and
    signed weights (one shape, so JAX compiles it once)."""
    pk, _ = keys
    runs = {}
    for signed in (False, True):
        x, w = _data(3 + signed, signed)
        enc = jgm.encrypt_matrix(pk, jnp.asarray(x), seed=5)
        res = jgm.matrix_multiplication(enc, jnp.asarray(w), pk)
        runs[signed] = (x, w, enc, np.asarray(res.data), np.asarray(jgm.decrypt_matrix(res, pk)))
    return runs


def _carried_enc(enc, tkey):
    return tgm.EncryptedMatrix(
        glwes=convert.u64_tensor(np.asarray(enc.glwes)), params=tkey.params, n_valid=enc.n_valid, shape=enc.shape
    )


@pytest.mark.parametrize("signed", [False, True])
def test_matmul_matches_reference(keys, reference_runs, signed):
    _, tkey = keys
    x, w, enc, want_data, want_dec = reference_runs[signed]
    tenc = _carried_enc(enc, tkey)
    res = tgm.matrix_multiplication(tenc, w, tkey)
    assert res.data.dtype == torch.int32 and tuple(res.data.shape) == want_data.shape
    np.testing.assert_array_equal(res.data.numpy().view(np.uint32), want_data)
    prep = tgm.prepare_clear_weights(tkey.params, w, device="cpu")
    np.testing.assert_array_equal(tgm.matrix_multiplication(tenc, prep, tkey).data.numpy(), res.data.numpy())
    got = tgm.decrypt_matrix(res, tkey).numpy()
    np.testing.assert_array_equal(got, want_dec)
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w)


@pytest.mark.parametrize("r,c,o,signed", [(2, 16, 3, False), (1, 256, 4, False), (3, 300, 5, True)])
def test_own_keys_matmul_decrypts(r, c, o, signed):
    """The JAX package's own matmul cases, with the port's keys end to end."""
    key = tgm.create_private_key(tp.TOY_MATMUL, seed=72, device="cpu")
    rs = np.random.RandomState(c)
    x = rs.randint(0, 16, size=(r, c)).astype(np.uint64)
    w = rs.randint(-8 if signed else 0, 8, size=(c, o)).astype(np.int64)
    res = tgm.matrix_multiplication(tgm.encrypt_matrix(key, x, seed=c), w, key)
    assert int(_u64.u32(res.data).max()) < 2**tp.TOY_MATMUL.ct_modulus_out_bits
    np.testing.assert_array_equal(tgm.decrypt_matrix(res, key).numpy(), x.astype(np.int64) @ w)
    wrong = dataclasses.replace(key, post_key=key.glwe_key)  # the result is under the post key only
    assert not np.array_equal(tgm.decrypt_matrix(res, wrong).numpy(), x.astype(np.int64) @ w)


def test_prepare_clear_weights_checks_the_crt_bound():
    eng = get_folded_engine(N, "cpu")
    w_bits = eng.max_product_bits - 64 - 1  # two chunks
    w = np.zeros((CIN, 2), dtype=np.int64)
    w[0, 0] = 1 << w_bits
    with pytest.raises(ValueError, match="CRT"):
        tgm.prepare_clear_weights(tp.TOY_MATMUL, w, device="cpu")


def test_packing_keyswitch_matches_reference(keys):
    """Random LWEs of the big key's width through the carried packing key,
    at the matmul's packing shape (R, 2 output chunks, N, kN+1)."""
    pk, tkey = keys
    lwes = np.random.default_rng(11).integers(0, 2**64, size=(R, 2, N, N + 1), dtype=np.uint64)
    lwes[1, 1, 200:] = 0  # a partly filled polynomial, as the last output chunk
    want = np.asarray(jpk.packing_keyswitch(jnp.asarray(lwes), pk.pksk, jax_engine(N)))
    got = tpk.packing_keyswitch(convert.u64_tensor(lwes), tkey.pksk, get_folded_engine(N, "cpu"))
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)
    assert tkey.pksk.shift == pk.pksk.shift


def test_packing_key_own_keygen_layout(keys):
    """The port's own packing key has the JAX key's shape, shift and dtype."""
    pk, _ = keys
    own = tgm.create_private_key(tp.TOY_MATMUL, seed=73, device="cpu")
    assert tuple(own.pksk.ksk_ntt.shape) == tuple(pk.pksk.ksk_ntt.shape)
    assert own.pksk.ksk_ntt.dtype == torch.int32
    assert own.pksk.shift == pk.pksk.shift and own.pksk.gadget == tp.TOY_MATMUL.packing_ks


@pytest.mark.parametrize("index", [0, 77, N - 1])
def test_backward_coeff_matches_reference(index):
    f = np.random.default_rng(index).integers(0, 2**31, size=(3, 2, 3, N), dtype=np.uint32)
    eng = get_folded_engine(N, "cpu")
    got = eng.backward_coeff(convert.u32_tensor(f), index, shift=5)
    want = np.asarray(jax_engine(N).backward_coeff(jnp.asarray(f), index, shift=5))
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)
    full = eng.backward(convert.u32_tensor(f), shift=5)[..., index]
    np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("log2_modulus", [12, 26, 32])
def test_compress_codec_matches_reference(log2_modulus):
    ct = np.random.default_rng(log2_modulus).integers(0, 2**64, size=(2, 2, N), dtype=np.uint64)
    ref = jsd.compress_glwe(jnp.asarray(ct), log2_modulus)
    got = tsd.compress_glwe(convert.u64_tensor(ct), log2_modulus)
    np.testing.assert_array_equal(got.data.numpy().view(np.uint32), np.asarray(ref.data))
    np.testing.assert_array_equal(
        _u64.u64_to_numpy(tsd.decompress_glwe(got)), np.asarray(jsd.decompress_glwe(ref))
    )
    blob = tsd.pack_compressed_glwe(got)
    assert blob == jsd.pack_compressed_glwe(ref)
    assert tsd.bitpack(np.asarray(ref.data), log2_modulus) == native.bitpack(np.asarray(ref.data), log2_modulus)
    back = tsd.unpack_compressed_glwe(blob, device="cpu")
    assert back.log2_modulus == log2_modulus
    np.testing.assert_array_equal(back.data.numpy(), got.data.numpy())


def test_bitpack_odd_widths_match_native():
    vals = np.random.default_rng(1).integers(0, 2**32, size=37, dtype=np.uint64).astype(np.uint32)
    for bits in (1, 3, 7, 31):
        packed = tsd.bitpack(vals & np.uint32((1 << bits) - 1), bits)
        assert packed == native.bitpack(vals & np.uint32((1 << bits) - 1), bits)
        np.testing.assert_array_equal(tsd.bitunpack(packed, bits, vals.size), native.bitunpack(packed, bits, vals.size))


def test_seeded_glwe_roundtrip_decrypts(keys):
    _, tkey = keys
    eng = get_folded_engine(N, "cpu")
    msg = torch.from_numpy(np.random.default_rng(2).integers(0, 16, size=(3, N))) << 58
    ct = tsd.encrypt_glwe_seeded(tkey.glwe_key, msg, 1234, tp.TOY_MATMUL.glwe_noise, eng)
    full = tsd.expand_seeded_glwe(ct)
    assert tuple(full.shape) == (3, 2, N)
    phase = decrypt_glwe(tkey.glwe_key, full, eng)
    np.testing.assert_array_equal(_u64.srl(phase + (1 << 57), 58).numpy(), (msg >> 58).numpy())
    again = tsd.expand_seeded_glwe(tsd.SeededGlweCiphertext(bodies=ct.bodies, seed=1234, k=ct.k))
    assert torch.equal(again, full)


@pytest.fixture(scope="module")
def linear_pair(keys):
    """The same float layer in both packages: 4-bit inputs and weights at
    the reference runs' shape (R, CIN) x (CIN, OUT)."""
    pk, tkey = keys
    rs = np.random.RandomState(21)
    w = rs.normal(size=(CIN, OUT))
    bias = rs.normal(size=OUT)
    x = rs.uniform(-1.0, 3.0, size=(R, CIN))
    kw = dict(bias=bias, n_bits_in=4, n_bits_w=4)
    ours = GlweLinearLayerExecutor(w, params=tp.TOY_MATMUL, **kw)
    ours._pkey = tkey
    ref = JaxExecutor(w, params=jp.TOY_MATMUL, **kw)
    ref._pkey = pk
    return ours, ref, x


@pytest.mark.parametrize("mode", ["disable", "simulate", "execute"])
def test_linear_layer_matches_reference(linear_pair, mode):
    ours, ref, x = linear_pair
    np.testing.assert_array_equal(ours.w_q, ref.w_q)
    got = ours.forward(x, fhe=mode)
    np.testing.assert_array_equal(got, ref.forward(x, fhe=mode))
    if FheMode(mode) == FheMode.EXECUTE:
        np.testing.assert_array_equal(got, ours.forward(x, fhe="disable"))


@pytest.mark.parametrize("name", [*sorted(jp.registry()), "TREES_MATMUL"])
def test_noise_estimates_match_reference(name):
    ref = getattr(jp, name)
    ours = getattr(tp, name)
    if hasattr(ref, "bits_reserved_for_computation"):
        for d in (300, 2048, 5000):
            assert tnoise.find_noise_profile(ours, d) == jnoise.find_noise_profile(ref, d)
        assert tnoise.matmul_noise_profile(ours) == jnoise.matmul_noise_profile(ref)
        return
    assert tnoise.pbs_output_variance(ours) == jnoise.pbs_output_variance(ref)
    if hasattr(ref, "message_modulus"):
        assert tnoise.failure_probability(ours) == jnoise.failure_probability(ref)
    else:
        assert tnoise.boolean_failure_probability(ours) == jnoise.boolean_failure_probability(ref)


def test_kernel_row_limit_is_checked():
    """K1/K2 take the packing keyswitch's largest launch at R = 32 and
    N = 2048 (131072 digit rows); a launch past the int grid raises."""
    ntt_cuda.check_rows(32 * 2048 * 2, 3, "K1")
    with pytest.raises(ValueError, match="2\\^31"):
        ntt_cuda.check_rows(2**31, 3, "K1")
    with pytest.raises(ValueError, match="2\\^31"):
        ntt_cuda.check_rows(2**30 + 2, 4, "K2")

