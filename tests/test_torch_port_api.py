"""The fhevm API layer of tfhe_tpu_torch (api/, utils/, native/) against the
JAX package, on the CPU.

One JAX keygen at TOY_SHORTINT plus its compact-PKE keys at TOY_PKE, carried
across with `convert`:
* keccak, secp256k1, the coprocessor quorum's signer addresses and
  signatures, ML-KEM keys and sealing, the KMS Shamir shares and partials,
  the handle codec, the type registry and the gas schedule equal the
  reference's;
* `serialize` writes the reference's bytes for a carried
  CompactCiphertextList, a RadixCiphertext and the carried key pair, and
  blobs cross between the packages in both directions;
* `expand` is bit-exact on the carried list and casting key;
* a ZK proof made by the port verifies under tfhe_tpu.api.zkpok.verify and
  the other way round (with the same prover seed the proofs are the same
  bytes);
* pk_encrypt_blocks and the port's own compact-PKE lists decrypt to their
  values; threshold partials combine to the clear value;
* with no `convert`, the port draws the reference's keys from the same
  seeds (the keygen, the compact-PKE keys and a list with its witnesses,
  the compact public key, the threshold shares);
* the key cache keeps the reference's file name and skips the disk on the
  card; every device entry point raises without a card unless given
  device="cpu".
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.api import attestation as jat
from tfhe_tpu.api import compact_pke as jcp
from tfhe_tpu.api import costs as jcosts
from tfhe_tpu.api import handles as jhd
from tfhe_tpu.api import kms as jkms
from tfhe_tpu.api import mlkem as jml
from tfhe_tpu.api import public_key as jpk
from tfhe_tpu.api import secp256k1 as jec
from tfhe_tpu.api import shamir as jsh
from tfhe_tpu.api import threshold as jth
from tfhe_tpu.api import types as jty
from tfhe_tpu.api import zkpok as jzk
from tfhe_tpu.models import integer as jri
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu.utils import keccak as jkeccak
from tfhe_tpu.utils import keycache as jkc
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu_torch import _u64, convert, native
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.api import attestation as tat
from tfhe_tpu_torch.api import compact_pke as tcp
from tfhe_tpu_torch.api import costs as tcosts
from tfhe_tpu_torch.api import handles as thd
from tfhe_tpu_torch.api import kms as tkms
from tfhe_tpu_torch.api import mlkem as tml
from tfhe_tpu_torch.api import public_key as tpk
from tfhe_tpu_torch.api import secp256k1 as tec
from tfhe_tpu_torch.api import shamir as tsh
from tfhe_tpu_torch.api import threshold as tth
from tfhe_tpu_torch.api import types as tty
from tfhe_tpu_torch.api import zkpok as tzk
from tfhe_tpu_torch.models import integer as tri
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.utils import keccak as tkeccak
from tfhe_tpu_torch.utils import keycache as tkc
from tfhe_tpu_torch.utils import serialization as tser

U64 = jnp.uint64
AUX = b"contract" + b"user" + b"acl" + (31337).to_bytes(32, "big")
LIST_VALS = np.arange(150, dtype=np.uint64) % 4  # two GLWEs at N_pke = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class Ref:
    jck: object
    jsk: object
    jkeys: object
    jlst: object
    jr: object
    je: object
    tck: object
    tsk: object
    tkeys: tcp.CompactPkeKeySet
    tlst: tcp.CompactCiphertextList


@pytest.fixture(scope="module")
def ref():
    """The one JAX keygen of the file, its compact-PKE keys and one
    two-GLWE list, each carried to the port."""
    jck, jsk = jsi.keygen(jp.TOY_SHORTINT, seed=41)
    jkeys = jcp.gen_compact_pke_keys(jck, jcp.TOY_PKE, JaxRng(42))
    jlst, jr, je = jcp.compact_pke_encrypt_with_witness(jkeys, jnp.asarray(LIST_VALS, dtype=U64), JaxRng(43))
    tck, tsk = convert.keys_from_reference(jck, jsk, device="cpu")
    tkeys = tcp.CompactPkeKeySet(
        pke_pk=convert.u64_tensor(jkeys.pke_pk),
        casting_ksk=convert.keyswitch_key_from_reference(jkeys.casting_ksk, device="cpu"),
        params=tcp.TOY_PKE,
        compute_params=tp.TOY_SHORTINT,
    )
    tlst = tcp.CompactCiphertextList(glwes=convert.u64_tensor(jlst.glwes), params=tcp.TOY_PKE, n_values=jlst.n_values)
    return Ref(jck, jsk, jkeys, jlst, jr, je, tck, tsk, tkeys, tlst)


# -- host modules: copies that must agree with the reference ----------------


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 1000])
def test_keccak_matches_reference(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    want = jkeccak.keccak256_py(data)
    assert tkeccak.keccak256(data) == want
    assert tkeccak.keccak256_py(data) == want


def test_native_builds_into_the_ports_build_dir():
    """The C core is compiled into tfhe_tpu_torch/_build (never beside the
    source) and its keccak equals the pure-python version."""
    if not native.available():
        pytest.skip("no C compiler: the pure-python fallbacks run")
    import os

    assert os.path.dirname(native._so_path()).endswith(os.path.join("tfhe_tpu_torch", "_build"))
    assert os.path.exists(native._so_path())
    assert native.keccak256(b"abc") == tkeccak.keccak256_py(b"abc")


def test_secp256k1_matches_reference(monkeypatch):
    digest = jkeccak.keccak256(b"message")
    for seed in (b"a", b"user-7"):
        priv = tec.keygen(seed)
        assert priv == jec.keygen(seed)
        assert tec.address(priv) == jec.address(priv)
        sig = tec.sign(priv, digest)
        assert sig == jec.sign(priv, digest)
        assert tec.recover_address(digest, sig) == jec.address(priv)
    # the port's C scalar multiplication against its pure-python window table
    if tec._native() is not None:
        k = 0x1234567890ABCDEF << 100
        via_c = tec.pubkey(k)
        monkeypatch.setattr(tec, "_native", lambda: None)
        assert tec.pubkey(k) == via_c == jec.pubkey(k)


def test_attestation_quorum_matches_reference():
    seed = b"coproc" + (19).to_bytes(8, "big")
    tq = tat.CoprocessorQuorum.generate(n=4, threshold=3, seed=seed)
    jq = jat.CoprocessorQuorum.generate(n=4, threshold=3, seed=seed)
    assert tq.addresses == jq.addresses
    handles = [bytes([i]) * 32 for i in range(3)]
    user, contract = "0x" + "22" * 20, "0x" + "11" * 20
    tsigs = tq.sign_handles(handles, user, contract, b"\x00", 31337)
    assert tsigs == jq.sign_handles(handles, user, contract, b"\x00", 31337)
    proof = tat.assemble_input_proof(handles, tsigs, b"\x00")
    assert proof == jat.assemble_input_proof(handles, tsigs, b"\x00")
    jat.verify_input_proof(proof, handles, tq.addresses, 3, user, contract, 31337, jq.verifying_contract)
    with pytest.raises(tat.InputProofError):
        tat.verify_input_proof(proof, handles, tq.addresses, 3, user, contract, 1, tq.verifying_contract)


def test_mlkem_keys_and_sealing_match_reference():
    ek, dk = tml.keygen(b"seed-1")
    assert (ek, dk) == jml.keygen(b"seed-1")
    assert tml.encaps(ek, b"m" * 32) == jml.encaps(ek, b"m" * 32)
    msg = (1234567).to_bytes(256, "big")
    assert jml.open_from(dk, tml.seal_to(ek, msg)) == msg
    assert tml.open_from(dk, jml.seal_to(ek, msg)) == msg


def test_kms_shares_and_partials_match_reference(ref):
    bits = _u64.u64_to_numpy(ref.tck.big_lwe_key.key)
    seed = b"kms" + (0).to_bytes(8, "big")
    tq = tkms.KmsQuorum.generate(bits, n=4, threshold=3, seed=seed, chain_id=31337)
    jq = jkms.KmsQuorum.generate(bits, n=4, threshold=3, seed=seed, chain_id=31337)
    assert tq.addresses == jq.addresses
    assert [s.share for s in tq.shares] == [s.share for s in jq.shares]
    ct = jri.encrypt_radix(ref.jck, jnp.asarray([201], dtype=U64), 8, JaxRng(9)).blocks
    block = np.asarray(ct, dtype=np.uint64)[0, 1]
    tparts = [tsh.partial_decrypt(block, s, nonce=b"n") for s in tq.shares]
    jparts = [jsh.partial_decrypt(block, s, nonce=b"n") for s in jq.shares]
    assert [(p.value, p.signature) for p in tparts] == [(p.value, p.signature) for p in jparts]
    p = jp.TOY_SHORTINT
    args = (tq.addresses, 3, p.delta, p.message_modulus * p.carry_modulus, b"n")
    got = tsh.combine(block, tparts[1:], *args)
    assert got == jsh.combine(block, jparts[1:], *args) == (201 >> 2) & 3
    digest_args = (31337, tq.verifying_contract)
    assert tkms.public_decrypt_digest([b"\x01" * 32], b"\x00" * 32, *digest_args) == jkms.public_decrypt_digest(
        [b"\x01" * 32], b"\x00" * 32, *digest_args
    )


def test_handles_types_and_costs_match_reference():
    blob = b"some ciphertext blob"
    addr = bytes.fromhex("ac" * 20)
    for idx, tid in ((0, 5), (3, 0)):
        t = thd.FhevmHandle.from_ciphertext_blob(blob, idx, tid, 31337, acl_address=addr)
        j = jhd.FhevmHandle.from_ciphertext_blob(blob, idx, tid, 31337, acl_address=addr)
        assert t.to_bytes32() == j.to_bytes32()
    ops = [b"\x07" * 32, 5, "euint16"]
    assert (
        thd.FhevmHandle.from_op("cast", ops, 31337, 3).to_bytes32()
        == jhd.FhevmHandle.from_op("cast", ops, 31337, 3).to_bytes32()
    )
    assert {k: dataclasses.astuple(v) for k, v in tty.FHE_TYPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jty.FHE_TYPES.items()
    }
    for op, t, scalar in (("add", "euint8", False), ("mul", "euint64", True), ("select", "euint32", False)):
        assert tcosts.cost_of(op, t, scalar=scalar) == jcosts.cost_of(op, t, scalar=scalar)


# -- serialization: the reference's bytes ------------------------------------


def test_serialize_list_is_byte_identical(ref):
    blob = jser.serialize(ref.jlst)
    assert tser.serialize(ref.tlst) == blob
    back = tser.deserialize(blob, device="cpu")
    assert isinstance(back, tcp.CompactCiphertextList) and back.params == tcp.TOY_PKE
    assert torch.equal(back.glwes, ref.tlst.glwes) and back.n_values == ref.tlst.n_values
    again = jser.deserialize(tser.serialize(back))
    np.testing.assert_array_equal(np.asarray(again.glwes), np.asarray(ref.jlst.glwes))
    assert again.params == ref.jlst.params


def test_serialize_radix_is_byte_identical(ref):
    jct = jri.encrypt_radix(ref.jck, jnp.asarray([7, 250], dtype=U64), 8, JaxRng(5))
    tct = tri.RadixCiphertext(blocks=convert.u64_tensor(jct.blocks), params=tp.TOY_SHORTINT, degrees=jct.degrees)
    blob = jser.serialize(jct)
    assert tser.serialize(tct) == blob
    back = tser.deserialize(blob, device="cpu")
    assert torch.equal(back.blocks, tct.blocks) and back.degrees == jct.degrees and back.params == tp.TOY_SHORTINT
    assert jser.deserialize(tser.serialize(back)).degrees == jct.degrees


def test_serialize_carried_keys_are_byte_identical(ref):
    """The key cache's blob: the port writes the reference's class names
    (the secret keys as NamedTuples), uint64/uint32/int8 arrays, and no
    derived cache fields."""
    ref.tsk.ksk.matmul_rhs()  # fill the cache field the blob must leave out
    blob = jser.serialize((ref.jck, ref.jsk), max_size=jkc.KEY_CACHE_MAX)
    assert tser.serialize((ref.tck, ref.tsk), max_size=tkc.KEY_CACHE_MAX) == blob
    ck, sk = tser.deserialize(blob, max_size=tkc.KEY_CACHE_MAX, device="cpu")
    assert torch.equal(ck.glwe_key.key, ref.tck.glwe_key.key)
    assert torch.equal(sk.bsk.bsk_ntt, ref.tsk.bsk.bsk_ntt) and torch.equal(sk.ksk.ksk_limbs, ref.tsk.ksk.ksk_limbs)


def test_deserialize_refuses_classes_outside_the_table(ref):
    name = b"tfhe_tpu.api.compact_pke:PkeParams"
    blob = jser.serialize(ref.jlst).replace(name, b"subprocess:Popen".ljust(len(name), b"_"))
    with pytest.raises(tser.SerializationError):
        tser.deserialize(blob, device="cpu")


# -- compact PKE, expand, ZK proofs ------------------------------------------


def test_expand_is_bit_exact(ref):
    want = np.asarray(jcp.expand(ref.jkeys, ref.jlst))
    got = tcp.expand(ref.tkeys, ref.tlst)
    assert got.shape == want.shape == (LIST_VALS.size, jp.TOY_SHORTINT.big_lwe_dimension + 1)
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)
    dec = tsi.decrypt(ref.tck, tsi.Ciphertext(ct=got, params=tp.TOY_SHORTINT, degree=3, noise_level=1))
    np.testing.assert_array_equal(dec.numpy(), LIST_VALS.astype(np.int64))


def test_zk_proofs_cross_between_packages(ref):
    """Same statement, witness and prover seed: the same proof bytes; each
    package's proof verifies under the other's verifier."""
    tcrs = tzk.CompactPkeCrs.from_params(tcp.TOY_PKE, tp.TOY_SHORTINT)
    jcrs = jzk.CompactPkeCrs.from_params(jcp.TOY_PKE, jp.TOY_SHORTINT)
    assert tcrs.hash == jcrs.hash
    tr, te = convert.u64_tensor(ref.jr), convert.u64_tensor(ref.je)
    tproof = tzk.prove(tcrs, ref.tkeys.pke_pk, ref.tlst, tr, LIST_VALS, te, AUX, seed=7)
    jproof = jzk.prove(jcrs, ref.jkeys.pke_pk, ref.jlst, ref.jr, LIST_VALS, ref.je, AUX, seed=7)
    assert tproof.to_bytes() == jproof.to_bytes()
    jzk.verify(jcrs, ref.jkeys.pke_pk, ref.jlst, jzk.CompactPkeProof.from_bytes(tproof.to_bytes()), AUX)
    tzk.verify(tcrs, ref.tkeys.pke_pk, ref.tlst, tzk.CompactPkeProof.from_bytes(jproof.to_bytes()), AUX)
    with pytest.raises(tzk.ZkProofError):
        tzk.verify(tcrs, ref.tkeys.pke_pk, ref.tlst, tproof, AUX + b"x")


def test_port_compact_pke_lists_decrypt_and_prove(ref):
    """The port's own PKE keys on the carried client key: a 150-value list
    (two GLWEs) expands to its values, and its proof verifies in both
    packages."""
    keys = tcp.gen_compact_pke_keys(ref.tck, tcp.TOY_PKE, FheRng(5, device="cpu"))
    assert keys.pke_pk.shape == (tcp.TOY_PKE.polynomial_size + 128, 2, tcp.TOY_PKE.polynomial_size)
    lst, r, e = tcp.compact_pke_encrypt_with_witness(keys, LIST_VALS, FheRng(6, device="cpu"))
    assert lst.glwes.shape[0] == 2 and lst.n_values == LIST_VALS.size
    blocks = tcp.expand(keys, lst)
    dec = tsi.decrypt(ref.tck, tsi.Ciphertext(ct=blocks, params=tp.TOY_SHORTINT, degree=3, noise_level=1))
    np.testing.assert_array_equal(dec.numpy(), LIST_VALS.astype(np.int64))
    crs = tzk.CompactPkeCrs.from_params(tcp.TOY_PKE, tp.TOY_SHORTINT)
    proof = tzk.prove(crs, keys.pke_pk, lst, r, LIST_VALS, e, AUX)
    tzk.verify(crs, keys.pke_pk, lst, proof, AUX)
    jlst = jcp.CompactCiphertextList(glwes=jnp.asarray(_u64.u64_to_numpy(lst.glwes)), params=jcp.TOY_PKE, n_values=lst.n_values)
    jcrs = jzk.CompactPkeCrs.from_params(jcp.TOY_PKE, jp.TOY_SHORTINT)
    jzk.verify(jcrs, _u64.u64_to_numpy(keys.pke_pk), jlst, jzk.CompactPkeProof.from_bytes(proof.to_bytes()), AUX)


def test_binary_combination_is_the_u64_product(ref):
    rows = ref.tkeys.pke_pk.reshape(ref.tkeys.pke_pk.shape[0], -1)
    r = torch.randint(0, 2, (3, rows.shape[0]), generator=torch.Generator().manual_seed(1))
    want = (r[:, :, None] * rows[None]).sum(dim=1)  # int64 sums wrap mod 2^64
    assert torch.equal(tpk.binary_combination(r, rows), want)


def test_pk_encrypt_blocks_decrypt(ref):
    pk = tpk.gen_public_key(ref.tck, FheRng(8, device="cpu"))
    assert pk.zeros.shape == (jp.TOY_SHORTINT.big_lwe_dimension + 128, jp.TOY_SHORTINT.big_lwe_dimension + 1)
    vals = torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0]])
    ct = tpk.pk_encrypt_blocks(pk, vals, FheRng(9, device="cpu"))
    dec = tsi.decrypt(ref.tck, tsi.Ciphertext(ct=ct, params=tp.TOY_SHORTINT, degree=3, noise_level=1))
    assert torch.equal(dec, vals)
    blob = jser.deserialize(tser.serialize(pk))  # /publickey's blob reads in the reference
    np.testing.assert_array_equal(np.asarray(blob.zeros), _u64.u64_to_numpy(pk.zeros))


def test_threshold_partials_combine(ref):
    p = tp.TOY_SHORTINT
    vals = torch.tensor([0, 1, 2, 3, 2])
    ct = tsi.encrypt(ref.tck, vals, FheRng(10, device="cpu")).ct
    shares = tth.share_secret_key(ref.tck.big_lwe_key, 3, FheRng(11, device="cpu"))
    flood = tp.NoiseDistribution.tuniform(20)
    parts = [tth.partial_decrypt(ct, s, FheRng(12 + s.party, device="cpu"), flood) for s in shares]
    assert torch.equal(tth.combine_partials(ct, parts, p.delta, p.message_modulus * p.carry_modulus), vals)
    # without flooding, a carried share's partial is the reference's bit for bit
    jshare = jth.KeyShare(share=jnp.asarray(_u64.u64_to_numpy(shares[0].share)), party=0, n_parties=3)
    want = jth.partial_decrypt(jnp.asarray(_u64.u64_to_numpy(ct)), jshare, JaxRng(0))
    np.testing.assert_array_equal(_u64.u64_to_numpy(tth.partial_decrypt(ct, shares[0], None)), np.asarray(want))


def test_port_draws_the_reference_keys_and_lists(ref):
    """The port's FheRng is the reference's threefry stream: its own keygen
    at seed 41, compact-PKE keys from FheRng(42), a list under FheRng(43),
    the public key and the threshold shares equal the reference's."""
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=41, device="cpu")
    for mine, carried in ((ck.glwe_key.key, ref.tck.glwe_key.key), (ck.lwe_key.key, ref.tck.lwe_key.key),
                          (sk.bsk.bsk_ntt, ref.tsk.bsk.bsk_ntt), (sk.ksk.ksk, ref.tsk.ksk.ksk)):
        assert torch.equal(mine, carried)
    keys = tcp.gen_compact_pke_keys(ck, tcp.TOY_PKE, FheRng(42, device="cpu"))
    assert torch.equal(keys.pke_pk, ref.tkeys.pke_pk)
    assert torch.equal(keys.casting_ksk.ksk, ref.tkeys.casting_ksk.ksk)
    lst, r, e = tcp.compact_pke_encrypt_with_witness(keys, LIST_VALS, FheRng(43, device="cpu"))
    np.testing.assert_array_equal(_u64.u64_to_numpy(lst.glwes), np.asarray(ref.jlst.glwes))
    np.testing.assert_array_equal(np.asarray(r), np.asarray(ref.jr))
    np.testing.assert_array_equal(np.asarray(e).astype(np.uint64), np.asarray(ref.je))  # signed, as u64 bits
    pk = tpk.gen_public_key(ck, FheRng(12, device="cpu"))
    jpk_zeros = jpk.gen_public_key(ref.jck, JaxRng(12)).zeros
    np.testing.assert_array_equal(_u64.u64_to_numpy(pk.zeros), np.asarray(jpk_zeros))
    shares = tth.share_secret_key(ck.lwe_key, 3, FheRng(14, device="cpu"))
    for mine, want in zip(shares, jth.share_secret_key(ref.jck.lwe_key, 3, JaxRng(14))):
        np.testing.assert_array_equal(_u64.u64_to_numpy(mine.share), np.asarray(want.share))


# -- key cache and devices ----------------------------------------------------


def test_keycache_names_files_as_the_reference_and_round_trips(tmp_path, monkeypatch):
    monkeypatch.delenv("TFHE_TPU_KEY_CACHE", raising=False)
    p = tp.TOY_SHORTINT
    for seed, g in ((1, None), (2, 3)):
        assert tkc.cache_path(p, seed, g, str(tmp_path)) == jkc.cache_path(jp.TOY_SHORTINT, seed, g, str(tmp_path))
    ck, sk, info = tkc.load_or_keygen(p, seed=5, cache_dir=str(tmp_path), device="cpu")
    assert not info["hit"] and tmp_path.joinpath(info["path"].split("/")[-1]).exists()
    ck2, sk2, info2 = tkc.load_or_keygen(p, seed=5, cache_dir=str(tmp_path), device="cpu")
    assert info2["hit"]
    assert torch.equal(ck2.lwe_key.key, ck.lwe_key.key) and torch.equal(sk2.bsk.bsk_ntt, sk.bsk.bsk_ntt)
    assert not tkc._disk_cache_pays_off(torch.device("cuda"))
    monkeypatch.setenv("TFHE_TPU_KEY_CACHE", "force")
    assert tkc._disk_cache_pays_off(torch.device("cuda"))


def test_api_entry_points_need_a_device_when_no_cuda(ref):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from tfhe_tpu_torch.api.instance import FhevmInstance, create_instance

    with pytest.raises(RuntimeError, match="CUDA"):
        create_instance(tp.TOY_SHORTINT)
    with pytest.raises(RuntimeError, match="CUDA"):
        FhevmInstance(tp.TOY_SHORTINT)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkc.load_or_keygen(tp.TOY_SHORTINT)
    with pytest.raises(RuntimeError, match="CUDA"):
        tser.deserialize(jser.serialize(ref.jlst))
