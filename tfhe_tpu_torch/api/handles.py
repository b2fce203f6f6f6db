"""32-byte ciphertext handle codec.

Layout mirrors the reference (reference: sdk/relayer/src/sdk/FhevmHandle.ts
:203-215): hash21(21B) | index(1B) | chainId(8B) | typeId(1B) | version(1B).
Input handles derive from keccak256 domain-separated hashes over the
ciphertext blob, ACL, chainId and index ("ZK-w_rct"/"ZK-w_hdl" domains,
FhevmHandle.ts:341-370,424-478).
"""

from __future__ import annotations

import dataclasses

from tfhe_tpu_torch.utils.keccak import keccak256

HANDLE_VERSION = 0

# Index byte sentinel for COMPUTED (op-result) handles, matching the
# reference byte layout (FhevmHandle.ts:211,255-257: "255 means computed").
# Input handles carry their 0-based position in the ciphertext list;
# 255 distinguishes a computed handle from an input at index 0.
COMPUTED_INDEX = 255


@dataclasses.dataclass(frozen=True)
class FhevmHandle:
    hash21: bytes
    index: int
    chain_id: int
    type_id: int
    version: int = HANDLE_VERSION

    def to_bytes32(self) -> bytes:
        assert len(self.hash21) == 21
        return (
            self.hash21
            + bytes([self.index & 0xFF])
            + self.chain_id.to_bytes(8, "big")
            + bytes([self.type_id & 0xFF, self.version & 0xFF])
        )

    @staticmethod
    def from_bytes32(b: bytes) -> "FhevmHandle":
        assert len(b) == 32, f"handle must be 32 bytes, got {len(b)}"
        return FhevmHandle(
            hash21=b[:21],
            index=b[21],
            chain_id=int.from_bytes(b[22:30], "big"),
            type_id=b[30],
            version=b[31],
        )

    @staticmethod
    def from_ciphertext_blob(
        blob: bytes,
        index: int,
        type_id: int,
        chain_id: int,
        acl_address: bytes = b"\x00" * 20,
        contract_address: bytes = b"\x00" * 20,
        user_address: bytes = b"\x00" * 20,
    ) -> "FhevmHandle":
        """Derive the input handle for value `index` of a ciphertext blob
        (the fromZKProof derivation: domain-separated double hash)."""
        aux = contract_address + user_address + acl_address + chain_id.to_bytes(32, "big")
        blob_hash = keccak256(b"ZK-w_rct" + blob + aux)
        h = keccak256(b"ZK-w_hdl" + blob_hash + bytes([index]) + aux)
        return FhevmHandle(
            hash21=h[:21], index=index, chain_id=chain_id, type_id=type_id
        )

    @staticmethod
    def from_op(
        op: str,
        operands: list,
        chain_id: int,
        type_id: int,
    ) -> "FhevmHandle":
        """Deterministic RESULT-handle derivation (the symbolic-execution
        convention of reference FhevmHandle.ts:203-215: on-chain FHE ops
        compute the result handle as a keccak over the op and operands, so
        replaying an op sequence reproduces identical handles and the
        coprocessor can execute asynchronously against them).

        operands: 32-byte handles are hashed as-is with a 0x00 tag;
        ints/str are canonicalized to 32 bytes with a 0x01 scalar tag
        (the reference's scalarByte flag).
        """
        enc = [b"FHE-op", op.encode(), bytes([len(operands)])]
        for o in operands:
            if isinstance(o, bytes):
                assert len(o) == 32
                enc.append(b"\x00" + o)
            elif isinstance(o, int):
                enc.append(b"\x01" + (o % (1 << 256)).to_bytes(32, "big"))
            else:  # e.g. a type name for casts
                s = str(o).encode()
                enc.append(b"\x02" + bytes([len(s)]) + s)
        enc.append(chain_id.to_bytes(8, "big"))
        enc.append(bytes([type_id & 0xFF, HANDLE_VERSION]))
        h = keccak256(b"".join(enc))
        return FhevmHandle(
            hash21=h[:21], index=COMPUTED_INDEX, chain_id=chain_id, type_id=type_id
        )

    @property
    def is_computed(self) -> bool:
        return self.index == COMPUTED_INDEX

    def hex(self) -> str:
        return "0x" + self.to_bytes32().hex()

    @staticmethod
    def parse(s: str) -> "FhevmHandle":
        if s.startswith("0x"):
            s = s[2:]
        return FhevmHandle.from_bytes32(bytes.fromhex(s))
