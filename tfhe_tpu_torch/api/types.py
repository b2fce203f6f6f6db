"""FHE type registry: the fhevm encrypted type system.

Type ids and bit widths mirror the reference exactly (reference:
sdk/relayer/src/sdk/FheType.ts:17-78): ebool=0, euint8=2 ... euint256=8,
eaddress=7 (euint4/id 1 deprecated), bit widths 2,8,16,32,64,128,160,256.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FheType:
    name: str
    type_id: int
    bits: int  # encrypted payload bits (ebool counts as 2 per reference)
    solidity: str


FHE_TYPES = {
    t.name: t
    for t in [
        FheType("ebool", 0, 2, "ebool"),
        FheType("euint8", 2, 8, "euint8"),
        FheType("euint16", 3, 16, "euint16"),
        FheType("euint32", 4, 32, "euint32"),
        FheType("euint64", 5, 64, "euint64"),
        FheType("euint128", 6, 128, "euint128"),
        FheType("eaddress", 7, 160, "eaddress"),
        FheType("euint256", 8, 256, "euint256"),
        FheType("ebytes64", 9, 512, "ebytes64"),
        FheType("ebytes128", 10, 1024, "ebytes128"),
        FheType("ebytes256", 11, 2048, "ebytes256"),
    ]
}

_BY_ID = {t.type_id: t for t in FHE_TYPES.values()}
_BY_BITS = {
    t.bits: t
    for t in FHE_TYPES.values()
    if t.name not in ("eaddress",)  # eaddress shares no width with euints
}


def type_from_id(type_id: int) -> FheType:
    return _BY_ID[type_id]


def type_from_bits(bits: int) -> FheType:
    """fheTypeIdFromEncryptionBits analog (FheType.ts)."""
    return _BY_BITS[bits]


# protocol constants (reference: sdk/relayer/src/sdk/encrypt.ts:73-83 and
# src/constants.ts:1-3)
MAX_ENCRYPTION_BITS = 2048
MAX_VALUES_PER_INPUT = 256
MAX_SERIALIZED_SIZE = 512 * 1024 * 1024
