"""Batched-PBS dispatcher (counterpart of tfhe_tpu/parallel/dispatch.py).

Collects single-ciphertext PBS requests, groups them by program signature
(LUT table, ciphertext width), pads each group to a bucket size, runs one
batched PBS per group and scatters the results back to the callers'
tickets. Host-side only: the batched PBS is the caller's `run_batch`
(for example keyswitch + programmable bootstrap of the port, which runs
K3 or K4 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class _Pending:
    key: tuple  # program signature: (lut table bytes, ct width)
    ct: torch.Tensor  # (n+1,) one LWE ciphertext
    ticket: int


class PbsDispatcher:
    """Collect single-ciphertext PBS requests, execute them as padded
    batched calls.

    run_batch: callable (cts (B, n+1), lut_table np.ndarray) -> (B, m+1).
    bucket_sizes: allowed padded batch sizes. Padding wastes at most the
    distance to the next bucket and keeps the set of batch shapes small.
    """

    def __init__(self, run_batch: Callable, bucket_sizes: tuple = (1, 8, 64, 256, 1024)):
        self._run = run_batch
        self._buckets = tuple(sorted(bucket_sizes))
        self._queue: list[_Pending] = []
        self._results: dict[int, torch.Tensor] = {}
        self._next_ticket = 0
        self.stats = {"submitted": 0, "executed": 0, "padded": 0, "batches": 0}

    def submit(self, ct: torch.Tensor, lut_table: np.ndarray) -> int:
        """Enqueue one PBS(ct, lut). Returns a ticket for result pickup."""
        t = self._next_ticket
        self._next_ticket += 1
        key = (np.asarray(lut_table, dtype=np.uint64).tobytes(), ct.shape[-1])
        self._queue.append(_Pending(key=key, ct=ct, ticket=t))
        self.stats["submitted"] += 1
        return t

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return -(-n // self._buckets[-1]) * self._buckets[-1]

    def flush(self):
        """Group by signature, pad, execute, store results."""
        groups: dict[tuple, list[_Pending]] = {}
        for p in self._queue:
            groups.setdefault(p.key, []).append(p)
        self._queue.clear()
        for key, items in groups.items():
            lut_table = np.frombuffer(key[0], dtype=np.uint64)
            n = len(items)
            b = self._bucket(n)
            cts = torch.stack([p.ct for p in items], dim=0)
            if b > n:
                cts = torch.cat([cts, cts.new_zeros((b - n,) + tuple(cts.shape[1:]))], dim=0)
                self.stats["padded"] += b - n
            out = self._run(cts, lut_table)
            for i, p in enumerate(items):
                self._results[p.ticket] = out[i]
            self.stats["executed"] += n
            self.stats["batches"] += 1

    def result(self, ticket: int) -> torch.Tensor:
        if ticket not in self._results:
            self.flush()
        return self._results.pop(ticket)
