"""Encrypted DataFrames with encrypted merge (counterpart of
tfhe_tpu/ml/pandas.py).

Analog of the reference's concrete-ml pandas layer (reference:
ml/concrete-ml/src/concrete/ml/pandas/dataframe.py EncryptedDataFrame :29
with encrypted `merge` :173, client_engine.py keygen/encrypt/decrypt):
every cell is a radix-encrypted small uint; `merge` evaluates key equality
homomorphically (PBS-backed radix eq) and gathers the matching right-row
values as eq-masked sums, so the server learns nothing about key values or
match positions.

Values are quantized to `value_bits` unsigned ints with 0 reserved as the
NaN/no-match marker, matching the reference's quantized-cell design.
pandas itself is imported only by `decrypt_to_pandas`; `encrypt_from_pandas`
takes any frame with `columns`, `len()` and `frame[name]`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tfhe_tpu_torch import _device
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.models import integer as ri
from tfhe_tpu_torch.models import shortint as si
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.utils.serialization import deserialize, serialize


class DataFrameClient:
    """Key owner: keygen + encrypt/decrypt of dataframes (reference
    pandas/client_engine.py ClientEngine). Keys and ciphertexts live on
    `device` (default "cuda"); `params` defaults to TOY_SHORTINT, as in
    the JAX package."""

    def __init__(self, params=None, seed: int = 0, value_bits: int = 4, device=None):
        self.params = params or tp.TOY_SHORTINT
        self.value_bits = value_bits
        self.device = _device.resolve(device)
        self.ck, self.sk = si.keygen(self.params, seed=seed, device=self.device)
        self._rng = FheRng(seed + 1, self.device)

    def encrypt_from_pandas(self, df) -> "EncryptedDataFrame":
        """A frame of small non-negative ints -> encrypted."""
        cols = {}
        for name in df.columns:
            vals = np.asarray(df[name], dtype=np.uint64)
            if vals.max(initial=0) >= 2**self.value_bits:
                raise ValueError(f"column {name} exceeds {self.value_bits}-bit range")
            cols[name] = ri.encrypt_radix(self.ck, vals, self.value_bits, self._rng)
        return EncryptedDataFrame(columns=cols, n_rows=len(df), value_bits=self.value_bits, sk=self.sk)

    def decrypt_to_pandas(self, edf: "EncryptedDataFrame"):
        import pandas as pd

        data = {}
        for name, ct in edf.columns.items():
            data[name] = ri.decrypt_radix(self.ck, ct).cpu().numpy().astype(np.int64)
        return pd.DataFrame(data)


def _row_broadcast(c: ri.RadixCiphertext, j: int, n: int) -> ri.RadixCiphertext:
    """Row j of a column as a batch of n identical ciphertexts (a view)."""
    return ri.RadixCiphertext(blocks=c.blocks[j].expand((n,) + c.blocks.shape[1:]), params=c.params,
                              degrees=c.degrees)


@dataclasses.dataclass
class EncryptedDataFrame:
    """columns: {name: RadixCiphertext of shape (n_rows,)}."""

    columns: dict
    n_rows: int
    value_bits: int
    sk: object  # server key: merge runs server-side

    @property
    def column_names(self) -> list:
        return list(self.columns.keys())

    def merge(self, right: "EncryptedDataFrame", on: str, how: str = "left") -> "EncryptedDataFrame":
        """Encrypted left merge on a unique-key column (the reference
        supports exactly this shape: dataframe.py merge `how in
        {left, right}` with unique keys).

        For each left row i and right column c:
            out_c[i] = sum_j eq(K_left[i], K_right[j]) * V_c[j]
        -- per right value column and right row, one radix eq, one select
        against a trivial zero and one add at batch n_left; non-matching
        rows decrypt to 0 (the NaN marker).
        """
        if how not in ("left", "right"):
            raise ValueError("unique-key left/right merge only")
        if how == "right":
            return right.merge(self, on=on, how="left")
        sk = self.sk
        lkey = self.columns[on]
        rkey = right.columns[on]
        nl, nr = self.n_rows, right.n_rows

        out_cols = {on: lkey}
        for name, ct in self.columns.items():
            if name != on:
                out_cols[name] = ct

        zero = ri.trivial_radix(sk.params, np.zeros((nl,), dtype=np.uint64), self.value_bits, device=sk.device)
        for name in [n for n in right.column_names if n != on]:
            vcol = right.columns[name]
            acc = None
            for j in range(nr):
                eq_ij = ri.eq(sk, lkey, _row_broadcast(rkey, j, nl))  # (nl,) encrypted 0/1
                # eq-masked gather: select(eq, v_j, 0), accumulated
                term = ri.select(sk, eq_ij, _row_broadcast(vcol, j, nl), zero)
                acc = term if acc is None else ri.add(sk, acc, term)
            out_cols[name if name not in out_cols else f"{name}_right"] = acc
        return EncryptedDataFrame(columns=out_cols, n_rows=nl, value_bits=self.value_bits, sk=sk)

    # -- serialization (reference dataframe.py save/load) -------------------

    def save(self, path: str):
        """The JAX package's bytes: a serialized dict of the columns, the
        row count and the value width."""
        with open(path, "wb") as f:
            f.write(serialize({"columns": dict(self.columns), "n_rows": self.n_rows, "value_bits": self.value_bits}))

    @staticmethod
    def load(path: str, sk) -> "EncryptedDataFrame":
        """A saved frame, its ciphertexts on the server key's device."""
        with open(path, "rb") as f:
            d = deserialize(f.read(), device=sk.device)
        return EncryptedDataFrame(columns=d["columns"], n_rows=d["n_rows"], value_bits=d["value_bits"], sk=sk)
