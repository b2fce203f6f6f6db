"""Input attestation: coprocessor signer quorum over ciphertext handles.

Makes the input-proof chain real (round 1 returned a placeholder blob).
Mirrors the reference protocol:

- the coprocessor verifies the uploaded ciphertext, recomputes its
  handles, and each signer returns an EIP-712 `CiphertextVerification`
  signature over (handles, user, contract, extraData) under a domain
  bound to chainId + verifying contract (reference:
  sdk/relayer/src/relayer/sendEncryption.ts:384-425 verifyTypedData
  against getCoprocessorSigners / threshold from config.ts:24-27);
- the client recomputes handles locally, cross-checks the response,
  verifies every signature against the known signer set, enforces the
  threshold, and assembles
  inputProof = nHandles || nSigners || handles || sigs || extraData
  (reference: sendEncryption.ts:427-441);
- verification fails CLOSED: bad signature, unknown signer, duplicate
  signer, below-threshold, or handle mismatch all raise.
"""

from __future__ import annotations

import dataclasses

from tfhe_tpu_torch.api import secp256k1 as ec
from tfhe_tpu_torch.utils.keccak import keccak256

# -- EIP-712 hashing ---------------------------------------------------------

_DOMAIN_TYPEHASH = keccak256(
    b"EIP712Domain(string name,string version,uint256 chainId,"
    b"address verifyingContract)"
)
# Struct fields match the reference exactly (sendEncryption.ts:390-397):
# ctHandles, userAddress, contractAddress, contractChainId, extraData.
# contractChainId binds the HOST chain into the struct hash so two
# deployments sharing a gateway domain cannot replay each other's
# attestations.
_CIPHERTEXT_VERIFICATION_TYPEHASH = keccak256(
    b"CiphertextVerification(bytes32[] ctHandles,address userAddress,"
    b"address contractAddress,uint256 contractChainId,bytes extraData)"
)

DOMAIN_NAME = b"InputVerification"
DOMAIN_VERSION = b"1"


def _addr32(addr: str) -> bytes:
    return bytes.fromhex(addr.removeprefix("0x").rjust(64, "0"))


def domain_separator(chain_id: int, verifying_contract: str) -> bytes:
    return keccak256(
        _DOMAIN_TYPEHASH
        + keccak256(DOMAIN_NAME)
        + keccak256(DOMAIN_VERSION)
        + chain_id.to_bytes(32, "big")
        + _addr32(verifying_contract)
    )


def ciphertext_verification_digest(
    handles: list[bytes],
    user: str,
    contract: str,
    extra_data: bytes,
    chain_id: int,
    verifying_contract: str,
    contract_chain_id: int | None = None,
) -> bytes:
    """Full EIP-712 digest: keccak("\\x19\\x01" || domainSep || structHash).

    contract_chain_id is the host chain the contract lives on; defaults
    to the gateway chain_id for single-chain deployments."""
    if contract_chain_id is None:
        contract_chain_id = chain_id
    struct_hash = keccak256(
        _CIPHERTEXT_VERIFICATION_TYPEHASH
        + keccak256(b"".join(handles))
        + _addr32(user)
        + _addr32(contract)
        + contract_chain_id.to_bytes(32, "big")
        + keccak256(extra_data)
    )
    return keccak256(
        b"\x19\x01" + domain_separator(chain_id, verifying_contract) + struct_hash
    )


# -- coprocessor signer quorum ----------------------------------------------


@dataclasses.dataclass
class CoprocessorQuorum:
    """n signers, t-of-n threshold (reference local-dev runs a signer set
    whose addresses/threshold the SDK discovers via config.ts:24-27)."""

    privs: list[int]
    threshold: int
    verifying_contract: str = "0x" + "69" * 20

    @staticmethod
    def generate(n: int, threshold: int, seed: bytes) -> "CoprocessorQuorum":
        privs = [ec.keygen(seed + bytes([i])) for i in range(n)]
        return CoprocessorQuorum(privs=privs, threshold=threshold)

    @property
    def addresses(self) -> list[str]:
        # address derivation is an EC mult per signer; the quorum is
        # static, so compute once (the serve path reads this per request)
        cached = getattr(self, "_addr_cache", None)
        if cached is None:
            cached = [ec.address(p) for p in self.privs]
            object.__setattr__(self, "_addr_cache", cached)
        return cached

    def sign_handles(
        self,
        handles: list[bytes],
        user: str,
        contract: str,
        extra_data: bytes,
        chain_id: int,
        signers: list[int] | None = None,
    ) -> list[bytes]:
        digest = ciphertext_verification_digest(
            handles, user, contract, extra_data, chain_id, self.verifying_contract
        )
        idx = signers if signers is not None else range(len(self.privs))
        return [ec.sign(self.privs[i], digest) for i in idx]


# -- inputProof assembly / verification --------------------------------------


def assemble_input_proof(
    handles: list[bytes], sigs: list[bytes], extra_data: bytes = b"\x00"
) -> bytes:
    """nHandles(1) || nSigners(1) || handles || sigs || extraData
    (reference sendEncryption.ts:427-441)."""
    assert all(len(h) == 32 for h in handles)
    assert all(len(s) == 65 for s in sigs)
    return (
        bytes([len(handles), len(sigs)])
        + b"".join(handles)
        + b"".join(sigs)
        + extra_data
    )


def parse_input_proof(proof: bytes) -> tuple[list[bytes], list[bytes], bytes]:
    if len(proof) < 2:
        raise ValueError("input proof too short")
    nh, ns = proof[0], proof[1]
    need = 2 + 32 * nh + 65 * ns
    if len(proof) < need:
        raise ValueError("input proof truncated")
    handles = [proof[2 + 32 * i : 2 + 32 * (i + 1)] for i in range(nh)]
    off = 2 + 32 * nh
    sigs = [proof[off + 65 * i : off + 65 * (i + 1)] for i in range(ns)]
    return handles, sigs, proof[need:]


class InputProofError(ValueError):
    pass


def verify_input_proof(
    proof: bytes,
    expected_handles: list[bytes],
    signer_addresses: list[str],
    threshold: int,
    user: str,
    contract: str,
    chain_id: int,
    verifying_contract: str,
) -> None:
    """Client-side verification, failing closed (sendEncryption.ts:361-425):
    handles must match the locally recomputed set, every signature must
    recover to a DISTINCT known signer, and at least `threshold` must."""
    handles, sigs, extra = parse_input_proof(proof)
    if handles != list(expected_handles):
        raise InputProofError("handle mismatch between proof and local derivation")
    digest = ciphertext_verification_digest(
        handles, user, contract, extra, chain_id, verifying_contract
    )
    known = {a.lower() for a in signer_addresses}
    seen: set[str] = set()
    for sig in sigs:
        try:
            addr = ec.recover_address(digest, sig).lower()
        except ValueError as e:
            raise InputProofError(f"unrecoverable signature: {e}") from None
        if addr not in known:
            raise InputProofError(f"signature from unknown signer {addr}")
        if addr in seen:
            raise InputProofError(f"duplicate signer {addr}")
        seen.add(addr)
    if len(seen) < threshold:
        raise InputProofError(
            f"{len(seen)} valid signatures below threshold {threshold}"
        )
