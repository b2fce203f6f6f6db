"""Threshold-KMS decryption protocol: signed requests, sealed shares.

The serving-layer realization of the reference KMS trust model
(VERDICT round-2 item 4 -- round 2 had the pieces but the HTTP path
returned plaintext):

- user-decrypt is an EIP-712-SIGNED request: the user's EOA authorizes an
  ML-KEM public key for a set of contracts over a validity window
  (reference sdk/relayer/src/sdk/keypair.ts:84-133
  `UserDecryptRequestVerification` + the delegated variant);
- each of n KMS parties answers with Shamir partial decryptions, signed
  per-party and SEALED to the user's ML-KEM key -- the cleartext never
  exists server-side and never crosses the wire (reference
  relayer/userDecrypt.ts:99-260: shares encrypted to the user keypair,
  verified/combined client-side by the TKMS client);
- public-decrypt responses carry per-party EIP-712
  `PublicDecryptVerification` signatures over (ctHandles,
  decryptedResult) plus an assembled decryptionProof blob (reference
  relayer/publicDecrypt.ts:23-47,132-146).

Crypto: api/shamir.py (t-of-n key shares, flooding noise from secret
per-party PRF keys, signed partials) + api/mlkem.py (FIPS 203 KEM-DEM).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from tfhe_tpu_torch.api import mlkem, secp256k1 as ec, shamir
from tfhe_tpu_torch.utils.keccak import keccak256

# -- EIP-712 ------------------------------------------------------------------

_DOMAIN_TYPEHASH = keccak256(
    b"EIP712Domain(string name,string version,uint256 chainId,"
    b"address verifyingContract)"
)
# Field set mirrors keypair.ts:84-103 (publicKey, contractAddresses,
# contractsChainId, startTimestamp, durationDays).
_USER_DECRYPT_TYPEHASH = keccak256(
    b"UserDecryptRequestVerification(bytes publicKey,"
    b"address[] contractAddresses,uint256 contractsChainId,"
    b"uint256 startTimestamp,uint256 durationDays)"
)
# Delegated variant (keypair.ts:105-133): a delegator account authorizes
# `delegatedAccount` to request decryption on its behalf.
_DELEGATED_USER_DECRYPT_TYPEHASH = keccak256(
    b"DelegatedUserDecryptRequestVerification(bytes publicKey,"
    b"address[] contractAddresses,address delegatedAccount,"
    b"uint256 contractsChainId,uint256 startTimestamp,uint256 durationDays)"
)
# publicDecrypt.ts:23-31: struct PublicDecryptVerification
_PUBLIC_DECRYPT_TYPEHASH = keccak256(
    b"PublicDecryptVerification(bytes32[] ctHandles,bytes decryptedResult)"
)

DOMAIN_NAME = b"Decryption"
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


def user_decrypt_request_digest(
    public_key: bytes,
    contract_addresses: list[str],
    chain_id: int,
    start_timestamp: int,
    duration_days: int,
    verifying_contract: str,
    delegated_account: str | None = None,
) -> bytes:
    """EIP-712 digest the user's EOA signs to authorize `public_key`
    (their ML-KEM encryption key) for these contracts over the validity
    window. With `delegated_account` set, the DELEGATOR signs the
    delegated-variant struct instead."""
    addrs_hash = keccak256(b"".join(_addr32(a) for a in contract_addresses))
    if delegated_account is None:
        struct_hash = keccak256(
            _USER_DECRYPT_TYPEHASH
            + keccak256(public_key)
            + addrs_hash
            + chain_id.to_bytes(32, "big")
            + start_timestamp.to_bytes(32, "big")
            + duration_days.to_bytes(32, "big")
        )
    else:
        struct_hash = keccak256(
            _DELEGATED_USER_DECRYPT_TYPEHASH
            + keccak256(public_key)
            + addrs_hash
            + _addr32(delegated_account)
            + chain_id.to_bytes(32, "big")
            + start_timestamp.to_bytes(32, "big")
            + duration_days.to_bytes(32, "big")
        )
    return keccak256(
        b"\x19\x01" + domain_separator(chain_id, verifying_contract) + struct_hash
    )


def public_decrypt_digest(
    handles: list[bytes],
    decrypted_result: bytes,
    chain_id: int,
    verifying_contract: str,
) -> bytes:
    struct_hash = keccak256(
        _PUBLIC_DECRYPT_TYPEHASH
        + keccak256(b"".join(handles))
        + keccak256(decrypted_result)
    )
    return keccak256(
        b"\x19\x01" + domain_separator(chain_id, verifying_contract) + struct_hash
    )


class KmsRequestError(ValueError):
    """Invalid / unauthorized decryption request -- callers fail closed."""


def verify_user_decrypt_request(
    signature: bytes,
    user_address: str,
    public_key: bytes,
    contract_addresses: list[str],
    chain_id: int,
    start_timestamp: int,
    duration_days: int,
    verifying_contract: str,
    requested_contracts: list[str],
    now: int | None = None,
    delegated_account: str | None = None,
) -> None:
    """Server-side request authentication (userDecrypt.ts:72-92 deadline
    checks + the EIP-712 signature the relayer forwards to the KMS).

    - the signature must recover to `user_address` (or, for the delegated
      variant, to the DELEGATOR -- `user_address` is then the delegator
      whose ACL rights are exercised while `delegated_account` is the
      requesting account);
    - the validity window [startTimestamp, +durationDays] must cover now;
    - every handle's contract must be in the signed contract list.
    """
    if not 0 < duration_days <= 365:
        raise KmsRequestError(f"durationDays {duration_days} out of range")
    now = int(time.time()) if now is None else now
    if start_timestamp > now:
        raise KmsRequestError("request not yet valid (startTimestamp in future)")
    if now > start_timestamp + duration_days * 86400:
        raise KmsRequestError("request expired")
    lowered = {a.lower() for a in contract_addresses}
    for c in requested_contracts:
        if c.lower() not in lowered:
            raise KmsRequestError(f"contract {c} not in the signed contract list")
    digest = user_decrypt_request_digest(
        public_key,
        contract_addresses,
        chain_id,
        start_timestamp,
        duration_days,
        verifying_contract,
        delegated_account=delegated_account,
    )
    try:
        signer = ec.recover_address(digest, signature)
    except ValueError as e:
        raise KmsRequestError(f"unrecoverable request signature: {e}") from None
    if signer.lower() != user_address.lower():
        raise KmsRequestError("request signature does not recover to the user")


# -- the KMS party quorum -----------------------------------------------------


@dataclasses.dataclass
class KmsQuorum:
    """n KMS parties holding Shamir shares of the big LWE secret key;
    any `threshold` of them reconstruct (reference local-dev
    docker-compose runs `-parties 5`; the SDK discovers KMS signer
    addresses + threshold via config.ts:19-22)."""

    shares: list[shamir.ShamirShare]
    threshold: int
    chain_id: int
    verifying_contract: str = "0x" + "6b" * 20
    flood_bits: int = 40

    @staticmethod
    def generate(
        key_bits, n: int, threshold: int, seed: bytes, chain_id: int
    ) -> "KmsQuorum":
        return KmsQuorum(
            shares=shamir.share_secret_key(key_bits, n, threshold, seed),
            threshold=threshold,
            chain_id=chain_id,
        )

    @property
    def addresses(self) -> list[str]:
        return [s.address for s in self.shares]

    # -- user decrypt: sealed signed shares, never plaintext ---------------

    def user_decrypt_respond(
        self,
        items: list[dict],
        user_public_key: bytes,
        nonce: bytes,
        parties: list[int] | None = None,
    ) -> list[dict]:
        """Each responding party partially decrypts EVERY block of every
        requested handle, signs each partial, and seals its whole share
        payload to the user's ML-KEM key. `items`:
        [{"handle": bytes32, "blocks": (nb, n+1) u64 array,
          "type": str, "bits": int}]. Returns one sealed envelope per
        party -- the server never sees a plaintext."""
        out = []
        idx = parties if parties is not None else range(len(self.shares))
        for i in idx:
            share = self.shares[i]
            partials = []
            for it in items:
                blocks = np.asarray(it["blocks"], dtype=np.uint64)
                for b_i in range(blocks.shape[0]):
                    p = shamir.partial_decrypt(
                        blocks[b_i], share, flood_bits=self.flood_bits, nonce=nonce
                    )
                    partials.append(
                        {
                            "handle": it["handle"].hex(),
                            "block": b_i,
                            "party": p.party,
                            "x": p.x,
                            "value": str(p.value),
                            "signature": p.signature.hex(),
                        }
                    )
            payload = json.dumps(
                {"party": share.party, "nonce": nonce.hex(), "partials": partials}
            ).encode()
            out.append(
                {
                    "party": share.party,
                    "sealedShares": mlkem.seal_to(user_public_key, payload).hex(),
                }
            )
        return out

    # -- public decrypt: EIP-712-signed results ----------------------------

    def sign_public_decrypt(
        self, handles: list[bytes], decrypted_result: bytes,
        parties: list[int] | None = None,
    ) -> list[bytes]:
        digest = public_decrypt_digest(
            handles, decrypted_result, self.chain_id, self.verifying_contract
        )
        idx = parties if parties is not None else range(len(self.shares))
        return [ec.sign(self.shares[i].sign_priv, digest) for i in idx]


def assemble_decryption_proof(sigs: list[bytes], extra_data: bytes = b"\x00") -> bytes:
    """decryptionProof = nSigners || sigs || extraData (the blob rebuilt
    at publicDecrypt.ts:132-146)."""
    assert all(len(s) == 65 for s in sigs)
    return bytes([len(sigs)]) + b"".join(sigs) + extra_data


def verify_public_decrypt(
    handles: list[bytes],
    decrypted_result: bytes,
    proof: bytes,
    signer_addresses: list[str],
    threshold: int,
    chain_id: int,
    verifying_contract: str,
) -> None:
    """Client-side verification of a public-decrypt response
    (publicDecrypt.ts:253-256 verifies KMS EIP-712 signatures against the
    discovered signer set + threshold). Fails closed."""
    if len(proof) < 1:
        raise KmsRequestError("decryption proof too short")
    ns = proof[0]
    if len(proof) < 1 + 65 * ns:
        raise KmsRequestError("decryption proof truncated")
    sigs = [proof[1 + 65 * i : 1 + 65 * (i + 1)] for i in range(ns)]
    digest = public_decrypt_digest(
        handles, decrypted_result, chain_id, verifying_contract
    )
    known = {a.lower() for a in signer_addresses}
    seen: set[str] = set()
    for sig in sigs:
        try:
            addr = ec.recover_address(digest, sig).lower()
        except ValueError as e:
            raise KmsRequestError(f"unrecoverable signature: {e}") from None
        if addr not in known:
            raise KmsRequestError(f"signature from unknown KMS signer {addr}")
        if addr in seen:
            raise KmsRequestError(f"duplicate KMS signer {addr}")
        seen.add(addr)
    if len(seen) < threshold:
        raise KmsRequestError(
            f"{len(seen)} valid KMS signatures below threshold {threshold}"
        )


# -- client-side share processing --------------------------------------------


def process_user_decrypt_response(
    envelopes: list[dict],
    private_key: bytes,
    items: list[dict],
    party_addresses: list[str],
    threshold: int,
    delta: int,
    plaintext_modulus: int,
    nonce: bytes,
    bits_per_block: int,
) -> list[int]:
    """The TKMS `process_user_decryption_resp_from_js` role
    (userDecrypt.ts:238-246): unseal each party's envelope with the
    user's ML-KEM private key, verify every partial's signature, and
    Lagrange-combine any `threshold` valid shares per block -- entirely
    CLIENT-side. `items` mirrors the request:
    [{"handle": bytes32, "blocks": (nb, n+1) u64, "type": str,
      "bits": int}]. Returns one clear value per item."""
    by_block: dict[tuple[str, int], list[shamir.SignedPartial]] = {}
    for env in envelopes:
        try:
            payload = json.loads(mlkem.open_from(private_key, bytes.fromhex(env["sealedShares"])))
        except (ValueError, KeyError):
            continue  # corrupted envelope: drop the party, not the request
        if payload.get("nonce") != nonce.hex():
            continue
        for p in payload.get("partials", []):
            by_block.setdefault((p["handle"], p["block"]), []).append(
                shamir.SignedPartial(
                    party=int(p["party"]),
                    x=int(p["x"]),
                    value=int(p["value"]),
                    signature=bytes.fromhex(p["signature"]),
                )
            )
    values = []
    for it in items:
        blocks = np.asarray(it["blocks"], dtype=np.uint64)
        block_vals = []
        for b_i in range(blocks.shape[0]):
            partials = by_block.get((it["handle"].hex(), b_i), [])
            v = shamir.combine(
                blocks[b_i],
                partials,
                party_addresses,
                threshold,
                delta,
                plaintext_modulus,
                nonce=nonce,
            )
            block_vals.append(int(v))
        if it["type"] == "ebool":
            values.append(block_vals[0] & 1)
        else:
            total = sum(v << (bits_per_block * i) for i, v in enumerate(block_vals))
            values.append(total % (1 << it["bits"]))
    return values
