"""Thin HTTP client of the FHE server.

Role of the reference's luxfhejs client (reference:
packages/luxfhejs/src/index.ts:42-273 LuxFHEClient encrypt_uint8..256 /
unseal) and the hardhat plugin's HTTP calls (packages/hardhat-plugin/src/
index.ts:26-142 encrypt/decrypt/getPublicKey). Retry/timeout/auth options
mirror the relayer provider's fetch options (reference:
sdk/relayer/src/relayer-provider/AbstractRelayerProvider.ts:23-27,
RelayerV2MaxRetryError / RelayerV2TimeoutError, auth.ts:10-38).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

from tfhe_tpu_torch.utils.profiling import span


class FheClient:
    def __init__(
        self,
        base_url: str,
        api_key: str | None = None,
        timeout: float = 30.0,
        retries: int = 2,
        retry_backoff: float = 0.25,
    ):
        self.base = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.retries = retries
        self.retry_backoff = retry_backoff

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _request(self, req, idempotent: bool = True, terminal_5xx: bool = False):
        """Bounded retries on transport errors and 5xx (4xx raise
        immediately -- client errors do not heal with retries).

        Non-idempotent requests (state-changing POSTs like /evaluate or
        /encrypt) are never retried automatically: a timed-out request may
        have executed server-side, and a resend would double-execute.

        terminal_5xx: raise the typed error immediately on 5xx instead of
        retrying -- used by /v2/result polling, where a 5xx echoes a
        permanently FAILED job, not a transient server fault."""
        last = None
        retries = self.retries if idempotent else 0
        for attempt in range(retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                msg = ""
                try:
                    msg = json.loads(e.read()).get("error", "")
                except Exception:  # noqa: BLE001 -- body may not be JSON
                    pass
                if e.code < 500 or terminal_5xx:
                    raise _typed_error(e.code, msg) from None
                last = FheClientError(e.code, msg)
            except (urllib.error.URLError, TimeoutError) as e:
                last = FheClientError(0, f"transport: {e}")
            if attempt < self.retries:
                time.sleep(self.retry_backoff * (2**attempt))
        raise FheClientMaxRetryError(str(last))

    def _get(self, path: str):
        req = urllib.request.Request(self.base + path, headers=self._headers())
        return self._request(req)

    @span("client.post")
    def _post(self, path: str, body: dict, idempotent: bool = False):
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(body).encode(),
            headers=self._headers(),
            method="POST",
        )
        return self._request(req, idempotent=idempotent)

    # -- v2 queued-response protocol ---------------------------------------

    def submit_v2(self, path: str, body: dict) -> str:
        """POST a /v2/* queued request; returns the requestId."""
        r = self._post(path, body)
        return r["requestId"]

    def poll_v2(self, request_id: str, deadline: float = 30.0, interval: float = 0.05):
        """Poll /v2/result/<id> until done (reference
        RelayerV2PostResultQueued polling loop). Raises
        FheClientTimeoutError past the deadline; server-side failures
        re-raise as their typed error class."""
        t0 = time.time()
        while True:
            req = urllib.request.Request(
                self.base + f"/v2/result/{request_id}", headers=self._headers()
            )
            # a failed job replies with ITS error code; that outcome is
            # permanent, so surface the typed error instead of retrying
            r = self._request(req, terminal_5xx=True)
            if r.get("status") == "done":
                return r["result"]
            if time.time() - t0 > deadline:
                raise FheClientTimeoutError(
                    f"{request_id} still {r.get('status')} after {deadline}s"
                )
            time.sleep(interval)

    def evaluate_v2(self, op: str, *args, deadline: float = 30.0):
        sargs = [a if isinstance(a, str) else str(a) for a in args]
        rid = self.submit_v2("/v2/evaluate", {"op": op, "args": sargs})
        return self.poll_v2(rid, deadline=deadline)

    def decrypt_v2(self, handle: str, deadline: float = 30.0) -> int:
        rid = self.submit_v2("/v2/decrypt", {"handle": handle})
        return int(self.poll_v2(rid, deadline=deadline)["value"])

    def health(self):
        return self._get("/health")

    def get_public_key(self):
        return self._get("/publickey")

    def encrypt(self, value: int, type_name: str = "euint8", **kw):
        return self._post("/encrypt", {"value": str(value), "type": type_name, **kw})

    def encrypt_uint8(self, v, **kw):
        return self.encrypt(v, "euint8", **kw)

    def encrypt_uint16(self, v, **kw):
        return self.encrypt(v, "euint16", **kw)

    def encrypt_uint32(self, v, **kw):
        return self.encrypt(v, "euint32", **kw)

    def encrypt_uint64(self, v, **kw):
        return self.encrypt(v, "euint64", **kw)

    def encrypt_uint128(self, v, **kw):
        return self.encrypt(v, "euint128", **kw)

    def encrypt_uint256(self, v, **kw):
        return self.encrypt(v, "euint256", **kw)

    def encrypt_address(self, v, **kw):
        return self.encrypt(int(v, 16) if isinstance(v, str) else v, "eaddress", **kw)

    def evaluate(self, op: str, *args):
        sargs = [a if isinstance(a, str) else str(a) for a in args]
        return self._post("/evaluate", {"op": op, "args": sargs})

    def evaluate_many(self, ops: list):
        """ops: [(op, [args...]), ...] -> {"handles": [...], "gasUsed": N}.
        The server routes uniform spans through its batched path."""
        payload = [
            {
                "op": op,
                "args": [a if isinstance(a, str) else str(a) for a in args],
            }
            for op, args in ops
        ]
        return self._post("/evaluate", {"ops": payload})

    def allow(self, handle: str, account: str | None = None, for_decryption: bool = True):
        body = {"handle": handle, "forDecryption": for_decryption}
        if account:
            body["account"] = account
        return self._post("/allow", body, idempotent=True)

    def decrypt(self, handle: str):
        # reads don't mutate coprocessor state: safe to retry
        return int(self._post("/decrypt", {"handle": handle}, idempotent=True)["value"])

    def verify(self, handles: list):
        return self._post("/verify", {"handles": handles}, idempotent=True)["valid"]

    def public_decrypt(self, handles: list):
        return self._post("/public-decrypt", {"handles": handles}, idempotent=True)

    def kms_info(self):
        return self._get("/kms-info")

    def user_decrypt(
        self,
        pairs: list,
        user_priv: int,
        duration_days: int = 1,
        delegated_account: str | None = None,
        start_timestamp: int | None = None,
    ) -> list[int]:
        """Full KMS user-decrypt protocol, client side (reference
        userDecrypt.ts:99-260 + keypair.ts:84-144): generate a fresh
        ML-KEM keypair, EIP-712-sign the request with the user's EOA key
        (`user_priv`; for the delegated variant the DELEGATOR's key signs
        and `delegated_account` names the requester), POST, then unseal /
        verify / Lagrange-combine the t-of-n signed shares LOCALLY. The
        server never sees or sends a plaintext."""
        import time as _time

        import numpy as np

        from tfhe_tpu_torch.api import kms, mlkem, secp256k1 as ec

        info = self.kms_info()
        ek, dk = mlkem.keygen()
        contracts = sorted({c for _, c in pairs})
        start = (
            int(_time.time()) - 60 if start_timestamp is None else start_timestamp
        )
        digest = kms.user_decrypt_request_digest(
            ek,
            contracts,
            info["chainId"],
            start,
            duration_days,
            info["verifyingContract"],
            delegated_account=delegated_account,
        )
        sig = ec.sign(user_priv, digest)
        resp = self._post(
            "/user-decrypt",
            {
                "handleContractPairs": [
                    {"handle": h, "contractAddress": c} for h, c in pairs
                ],
                "userAddress": ec.address(user_priv),
                "publicKey": ek.hex(),
                "signature": sig.hex(),
                "contractAddresses": contracts,
                "startTimestamp": start,
                "durationDays": duration_days,
                **(
                    {"delegatedAccount": delegated_account}
                    if delegated_account
                    else {}
                ),
            },
        )
        items = [
            {
                "handle": bytes.fromhex(i["handle"][2:]),
                "blocks": np.frombuffer(
                    bytes.fromhex(i["blocks"]), dtype=np.uint64
                ).reshape(i["shape"]),
                "type": i["type"],
                "bits": i["bits"],
            }
            for i in resp["items"]
        ]
        return kms.process_user_decrypt_response(
            resp["responses"],
            dk,
            items,
            resp["kmsSigners"],
            resp["threshold"],
            info["delta"],
            info["plaintextModulus"],
            bytes.fromhex(resp["nonce"]),
            info["bitsPerBlock"],
        )

    def public_decrypt_verified(self, handles: list) -> dict:
        """public_decrypt + client-side verification of the KMS EIP-712
        result signatures and threshold (publicDecrypt.ts:253-256)."""
        from tfhe_tpu_torch.api import kms

        info = self.kms_info()
        resp = self.public_decrypt(handles)
        hbs = [bytes.fromhex(h.removeprefix("0x")) for h in handles]
        kms.verify_public_decrypt(
            hbs,
            bytes.fromhex(resp["decryptedResult"]),
            bytes.fromhex(resp["decryptionProof"]),
            info["kmsSigners"],
            info["threshold"],
            info["chainId"],
            info["verifyingContract"],
        )
        return resp


class FheClientError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(f"HTTP {code}: {msg}")
        self.code = code


class FheClientMaxRetryError(FheClientError):
    """All retry attempts exhausted (reference RelayerV2MaxRetryError)."""

    def __init__(self, msg: str):
        Exception.__init__(self, f"max retries exceeded: {msg}")
        self.code = 0


# typed error hierarchy (reference relayer-provider/v2/types/errors/):
# callers can catch by failure class instead of parsing status codes


class FheClientTimeoutError(FheClientError):
    """Polling deadline exceeded (reference RelayerV2TimeoutError)."""

    def __init__(self, msg: str):
        Exception.__init__(self, f"timeout: {msg}")
        self.code = 0


class FheClientBadRequestError(FheClientError):
    pass


class FheClientUnauthorizedError(FheClientError):
    pass


class FheClientForbiddenError(FheClientError):
    pass


class FheClientNotFoundError(FheClientError):
    pass


def _typed_error(code: int, msg: str) -> FheClientError:
    cls = {
        400: FheClientBadRequestError,
        401: FheClientUnauthorizedError,
        403: FheClientForbiddenError,
        404: FheClientNotFoundError,
    }.get(code, FheClientError)
    return cls(code, msg)
