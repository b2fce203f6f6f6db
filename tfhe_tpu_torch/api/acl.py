"""Access-control list for ciphertext handles.

In-process analog of the on-chain ACL contract the reference SDK reads
(reference: sdk/relayer/src/sdk/ACL.ts:20-292 persistAllowed /
isAllowedForDecryption; packages/contracts/fhe/IFHENetwork.sol allow /
allowGlobal / allowTransient / allowForDecryption).
"""

from __future__ import annotations


class Acl:
    def __init__(self):
        self._allowed: dict[bytes, set] = {}
        self._global: set = set()
        self._transient: dict[bytes, set] = {}
        self._decryptable: set = set()

    def allow(self, handle: bytes, account: str) -> None:
        self._allowed.setdefault(handle, set()).add(account.lower())

    def allow_global(self, handle: bytes) -> None:
        self._global.add(handle)

    def allow_transient(self, handle: bytes, account: str) -> None:
        self._transient.setdefault(handle, set()).add(account.lower())

    def clear_transient(self) -> None:
        """End-of-transaction semantics for transient allowances."""
        self._transient.clear()

    def allow_for_decryption(self, handle: bytes) -> None:
        self._decryptable.add(handle)

    def persist_allowed(self, handle: bytes, account: str) -> bool:
        if handle in self._global:
            return True
        return account.lower() in self._allowed.get(handle, set())

    def is_allowed(self, handle: bytes, account: str) -> bool:
        return (
            self.persist_allowed(handle, account)
            or account.lower() in self._transient.get(handle, set())
        )

    def is_allowed_for_decryption(self, handle: bytes) -> bool:
        return handle in self._decryptable
