"""Radix big integers: euint8..euint256 as vectors of shortint blocks
(counterpart of tfhe_tpu/models/integer.py).

A radix ciphertext is ONE tensor (..., nblocks, kN+1) with a host-side
tuple of per-block degrees; the block axis is a batch axis, so blockwise
LUTs over all blocks of all ciphertexts in a batch are a single PBS call.
Where different blocks need different LUTs in the same round (message +
carry extract, schoolbook partial products), the LUTs are stacked along a
leading axis aligned with the stacked ciphertexts. Semantics follow the
fhevm operator corpus: wrapping mod-2^nbits arithmetic, unsigned
comparisons, boolean select.

Every op does the same PBS rounds, with the same tables and the same
degree bookkeeping, as the JAX package: given the same keys and inputs it
returns the same ciphertext bits, degree tuples and PBS count. `_pbs`
counts the PBS rows it runs in `_pbs.rows`. Entry points that make
ciphertexts from clear values take `device=` (default "cuda").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from tfhe_tpu_torch import _device, _u64
from tfhe_tpu_torch.core.lwe import decrypt_lwe, encrypt_lwe, trivial_lwe
from tfhe_tpu_torch.models import shortint as si
from tfhe_tpu_torch.models.shortint import ClientKey, ServerKey
from tfhe_tpu_torch.params import ShortintParams
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import decode, encode
from tfhe_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class RadixCiphertext:
    """blocks: (..., nblocks, kN+1); degrees: per-block max value."""

    blocks: torch.Tensor
    params: ShortintParams
    degrees: tuple

    @property
    def nblocks(self) -> int:
        return len(self.degrees)

    @property
    def nbits(self) -> int:
        return self.nblocks * _bits_per_block(self.params)

    @property
    def batch_shape(self):
        return tuple(self.blocks.shape[:-2])


def _bits_per_block(params: ShortintParams) -> int:
    return int(math.log2(params.message_modulus))


def blocks_for_bits(params: ShortintParams, nbits: int) -> int:
    bpb = _bits_per_block(params)
    if nbits % bpb:
        raise ValueError(f"{nbits} bits is not a whole number of {bpb}-bit blocks")
    return nbits // bpb


def _u64_values(values, device) -> torch.Tensor:
    """Unsigned ints (a tensor of u64 bits, a numpy array, python ints) ->
    an int64 tensor of u64 bits on `device`."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.int64)
    with span("wait.scalar_upload"):
        return _u64.u64_from_numpy(np.asarray(values, dtype=np.uint64)).to(device)


def _split_blocks(values: torch.Tensor, nb: int, params: ShortintParams) -> torch.Tensor:
    """(...,) u64 values -> (..., nb) message digits, LSB block first
    (a block past bit 63 is 0, as a u64 shift by >= 64 gives)."""
    bpb = _bits_per_block(params)
    mask = params.message_modulus - 1
    zero = torch.zeros_like(values)
    digits = [_u64.srl(values, bpb * i) & mask if bpb * i < 64 else zero for i in range(nb)]
    return torch.stack(digits, dim=-1)


# -- client side ---------------------------------------------------------------


def encrypt_radix(ck: ClientKey, values, nbits: int, rng: FheRng) -> RadixCiphertext:
    """values: (...,) unsigned ints (python ints or u64 tensor) -> radix ct."""
    p = ck.params
    nb = blocks_for_bits(p, nbits)
    blocks_pt = _split_blocks(_u64_values(values, ck.device), nb, p)
    ct = encrypt_lwe(ck.big_lwe_key, encode(blocks_pt, p.delta), rng, p.glwe_noise)
    return RadixCiphertext(blocks=ct, params=p, degrees=(p.message_modulus - 1,) * nb)


def _bigint_digits(params: ShortintParams, values: list, nb: int, device) -> torch.Tensor:
    bpb = _bits_per_block(params)
    mask = params.message_modulus - 1
    rows = [[(int(v) >> (bpb * i)) & mask for i in range(nb)] for v in values]
    return torch.tensor(rows, dtype=torch.int64, device=device).reshape(len(rows), nb)


def encrypt_radix_bigint(ck: ClientKey, values: list, nbits: int, rng: FheRng) -> RadixCiphertext:
    """Exact big-int radix encryption (euint128/256: python ints wider
    than u64)."""
    p = ck.params
    nb = blocks_for_bits(p, nbits)
    blocks_pt = _bigint_digits(p, values, nb, ck.device)
    ct = encrypt_lwe(ck.big_lwe_key, encode(blocks_pt, p.delta), rng, p.glwe_noise)
    return RadixCiphertext(blocks=ct, params=p, degrees=(p.message_modulus - 1,) * nb)


def _decrypt_blocks(ck: ClientKey, c: RadixCiphertext) -> torch.Tensor:
    p = ck.params
    return decode(decrypt_lwe(ck.big_lwe_key, c.blocks), p.delta, p.message_modulus * p.carry_modulus)


def decrypt_radix(ck: ClientKey, c: RadixCiphertext) -> torch.Tensor:
    """Decrypt to u64 bits in an int64 tensor (nbits > 64 uses
    decrypt_radix_bigint)."""
    vals = _decrypt_blocks(ck, c)
    bpb = _bits_per_block(ck.params)
    total = torch.zeros(vals.shape[:-1], dtype=torch.int64, device=vals.device)
    for i in range(c.nblocks):
        if bpb * i < 64:
            total = total + (vals[..., i] << (bpb * i))
    if c.nbits >= 64:
        return total
    return total & ((1 << c.nbits) - 1)


def decrypt_radix_bigint(ck: ClientKey, c: RadixCiphertext) -> list:
    """Exact big-int decryption (euint128/256): returns python ints."""
    vals = _decrypt_blocks(ck, c).cpu().numpy()
    bpb = _bits_per_block(ck.params)
    out = []
    for row in vals.reshape(-1, c.nblocks):
        total = sum(int(v) << (bpb * i) for i, v in enumerate(row))
        out.append(total % (1 << c.nbits))
    return out


def trivial_radix_bigint(params: ShortintParams, values: list, nbits: int, device=None) -> RadixCiphertext:
    """Trivial encryption of python ints wider than u64 (eaddress/ebytes
    scalar operands)."""
    p = params
    nb = blocks_for_bits(p, nbits)
    blocks_pt = _bigint_digits(p, values, nb, _device.resolve(device))
    ct = trivial_lwe(encode(blocks_pt, p.delta), p.big_lwe_dimension)
    return RadixCiphertext(blocks=ct, params=p, degrees=(p.message_modulus - 1,) * nb)


def _exact_degrees(params: ShortintParams, values: torch.Tensor, nb: int) -> tuple:
    """The largest digit of each block over the batch: a trivial zero has
    degree 0, which lets select() take its one-PBS-per-block path. The
    same numpy expression as the JAX package, so the degrees agree."""
    bpb = _bits_per_block(params)
    with span("wait.degrees"):
        vals_np = _u64.u64_to_numpy(values).reshape(-1)
    mask = np.uint64(params.message_modulus - 1)
    try:
        return tuple(int(((vals_np >> np.uint64(bpb * i)) & mask).max()) for i in range(nb))
    except ValueError:  # an empty batch has no maximum
        return (params.message_modulus - 1,) * nb


def trivial_radix(params: ShortintParams, values, nbits: int, device=None) -> RadixCiphertext:
    """Noiseless, keyless radix ciphertext of clear values, with exact
    per-block degrees."""
    p = params
    nb = blocks_for_bits(p, nbits)
    values = _u64_values(values, _device.resolve(device))
    degrees = _exact_degrees(p, values, nb)
    ct = trivial_lwe(encode(_split_blocks(values, nb, p), p.delta), p.big_lwe_dimension)
    return RadixCiphertext(blocks=ct, params=p, degrees=degrees)


# -- PBS plumbing ----------------------------------------------------------------


def _pbs_flat(sk: ServerKey, ct: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(B, kN+1) x (B, k+1, N) -> (B, kN+1), dispatched on the key type."""
    return si._keyswitch_pbs(sk, ct, lut)


def _pbs(sk: ServerKey, ct: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Raw batched PBS: ct (..., kN+1), lut broadcastable (..., k+1, N).
    The batch dims are flattened into one call. The JAX package also pads
    the flat batch to a size bucket, only to bound the number of XLA
    compiles; PyTorch compiles nothing per shape, and each row's PBS
    depends on that row alone, so the port runs the rows unpadded and
    they come out the same."""
    batch = tuple(ct.shape[:-1])
    b = math.prod(batch)
    flat_ct = ct.reshape(b, ct.shape[-1])
    flat_lut = lut.expand(batch + tuple(lut.shape[-2:])).reshape(b, *lut.shape[-2:])
    out = _pbs_flat(sk, flat_ct, flat_lut)
    _pbs.rows += b
    return out.reshape(batch + (out.shape[-1],))


_pbs.rows = 0


@span("integer.lut")
def _lut(sk: ServerKey, table) -> torch.Tensor:
    return si.generate_lut(sk.params, np.asarray(table, dtype=np.uint64), sk.device)


@span("integer.lut")
def _lut_table(params: ShortintParams, f: Callable) -> np.ndarray:
    space = params.message_modulus * params.carry_modulus
    return np.array([int(f(v)) % space for v in range(space)], dtype=np.uint64)


def _stacked_pbs(sk: ServerKey, cts: Sequence[torch.Tensor], tables) -> list:
    """len(cts) PBS with (possibly different) LUTs as ONE call. cts: list
    of (..., kN+1) of one shape; tables: the LUT value tables."""
    stack = torch.stack(list(cts), dim=0)  # (T, ..., kN+1)
    luts = torch.stack([_lut(sk, t) for t in tables], dim=0)  # (T, k+1, N)
    extra = stack.dim() - 2  # batch dims beyond the stack axis
    luts = luts.reshape((luts.shape[0],) + (1,) * extra + tuple(luts.shape[1:]))
    out = _pbs(sk, stack, luts)
    return [out[i] for i in range(len(cts))]


# -- carry propagation -------------------------------------------------------------


def _carry_plan(params: ShortintParams, degrees: tuple) -> tuple[tuple, tuple]:
    """What propagate_carries does to a radix of these block degrees:
    per block, None where it is left as it is, else the degree of the
    carry it passes on (0 from the last block); and the output degrees.
    Two radixes with equal steps run the same PBS rounds."""
    m = params.message_modulus
    space = m * params.carry_modulus
    steps = []
    out_degrees = []
    carry_deg = 0
    for i, d in enumerate(degrees):
        deg = d + carry_deg
        if deg >= space:
            raise ValueError(f"block {i} degree {deg} overflows before flush")
        if deg < m:
            # nothing to flush and no carry can emerge
            carry_deg = 0
            steps.append(None)
            out_degrees.append(deg)
            continue
        carry_deg = 0 if i == len(degrees) - 1 else deg // m
        steps.append(carry_deg)
        out_degrees.append(m - 1)
    return tuple(steps), tuple(out_degrees)


@span("integer.propagate_carries")
def propagate_carries(sk: ServerKey, c: RadixCiphertext) -> RadixCiphertext:
    """Flush carries block by block (sequential in nblocks, batched over
    the leading dims). Result blocks are fresh (degree < msg_mod)."""
    p = sk.params
    m = p.message_modulus
    steps, out_degrees = _carry_plan(p, c.degrees)
    msg_table = _lut_table(p, lambda v: v % m)
    car_table = _lut_table(p, lambda v: v // m)
    out_blocks = []
    carry_ct = None
    for i, step in enumerate(steps):
        blk = c.blocks[..., i, :]
        if carry_ct is not None:
            blk = blk + carry_ct
        if step is None:
            out_blocks.append(blk)
            carry_ct = None
        elif i == c.nblocks - 1:
            (msg,) = _stacked_pbs(sk, [blk], [msg_table])
            out_blocks.append(msg)
        else:
            msg, carry_ct = _stacked_pbs(sk, [blk, blk], [msg_table, car_table])
            out_blocks.append(msg)
    return RadixCiphertext(blocks=torch.stack(out_blocks, dim=-2), params=p, degrees=out_degrees)


def _fresh(sk: ServerKey, c: RadixCiphertext) -> RadixCiphertext:
    """Ensure every block is a pure message (degree < msg_mod)."""
    if max(c.degrees) >= sk.params.message_modulus:
        return propagate_carries(sk, c)
    return c


def _add_to_body(blocks: torch.Tensor, value: int, params: ShortintParams, block=None) -> torch.Tensor:
    """A copy of `blocks` with value * delta added to the body of every
    block (or of block `block` only)."""
    out = blocks.clone()
    idx = (..., -1) if block is None else (..., block, -1)
    out[idx] += _u64.const(value * params.delta)
    return out


# -- linear ops ---------------------------------------------------------------------


def _add_pre_carry(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    """add's blocks before its carry chain."""
    if a.nblocks != b.nblocks:
        raise ValueError("operands of different widths")
    p = sk.params
    space = p.message_modulus * p.carry_modulus
    if any(da + db >= space for da, db in zip(a.degrees, b.degrees)):
        a = _fresh(sk, a)
        b = _fresh(sk, b)
    return RadixCiphertext(
        blocks=a.blocks + b.blocks, params=p, degrees=tuple(da + db for da, db in zip(a.degrees, b.degrees))
    )


def bitnot_blocks(sk: ServerKey, a: RadixCiphertext) -> RadixCiphertext:
    """(msg_mod-1) - x per block; needs fresh blocks. No PBS."""
    p = sk.params
    a = _fresh(sk, a)
    new = _add_to_body(-a.blocks, p.message_modulus - 1, p)
    return RadixCiphertext(blocks=new, params=p, degrees=(p.message_modulus - 1,) * a.nblocks)


def _sub_pre_carry(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    """sub's blocks before its carry chain: a + ~b + 1."""
    p = sk.params
    nb = a.nblocks
    notb = bitnot_blocks(sk, b)
    a = _fresh(sk, a)
    s = _add_to_body(a.blocks + notb.blocks, 1, p, block=0)
    degs = [a.degrees[i] + notb.degrees[i] + (1 if i == 0 else 0) for i in range(nb)]
    return RadixCiphertext(blocks=s, params=p, degrees=tuple(degs))


_PRE_CARRY = {"add": _add_pre_carry, "sub": _sub_pre_carry}


@span("integer.add")
def add(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    return propagate_carries(sk, _add_pre_carry(sk, a, b))


@span("integer.sub")
def sub(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    """a - b = a + ~b + 1 (two's complement in base msg_mod)."""
    return propagate_carries(sk, _sub_pre_carry(sk, a, b))


@span("integer.add_sub_many")
def add_sub_many(sk: ServerKey, ops: Sequence[tuple]) -> list:
    """[(kind, a, b), ...] with kind "add" or "sub", over radixes of one
    width and any batch shapes -> one RadixCiphertext per op, equal to
    add(sk, a, b) or sub(sk, a, b) bit for bit, degrees included.

    The ops whose pre-carry degrees give propagate_carries the same steps
    (the same blocks flushed, the same carry degrees) run ONE carry chain
    over their rows stacked along a leading axis: each PBS round is one
    call for all of them. Each row's PBS depends on that row alone, so
    the stacking changes no bit. Ops whose steps differ run in chains of
    their own. `ops` counts the radix ciphertexts that ran in a shared
    chain, `chains` the shared chains."""
    pre = [_PRE_CARRY[kind](sk, a, b) for kind, a, b in ops]
    plans = [_carry_plan(sk.params, c.degrees) for c in pre]
    groups: dict[tuple, list[int]] = {}
    for i, (steps, _) in enumerate(plans):
        groups.setdefault(steps, []).append(i)
    out = [None] * len(ops)
    for idx in groups.values():
        flat = [pre[i].blocks.reshape((-1,) + tuple(pre[i].blocks.shape[-2:])) for i in idx]
        chain = propagate_carries(
            sk, RadixCiphertext(blocks=torch.cat(flat), params=sk.params, degrees=pre[idx[0]].degrees)
        )
        parts = torch.split(chain.blocks, [f.shape[0] for f in flat])
        for i, part in zip(idx, parts):
            out[i] = RadixCiphertext(
                blocks=part.reshape(pre[i].blocks.shape), params=sk.params, degrees=plans[i][1]
            )
        if len(idx) > 1:
            add_sub_many.chains += 1
            add_sub_many.ops += sum(f.shape[0] for f in flat)
    return out


add_sub_many.ops = 0
add_sub_many.chains = 0


@span("integer.add_sub")
def add_sub(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> tuple[RadixCiphertext, RadixCiphertext]:
    """(add(a, b), sub(a, b)) of fresh a and b, sharing ONE stacked carry
    chain where their steps agree (the ERC20 transfer's balance +/- moved):
    stacking the two pre-carry block tensors doubles the per-round PBS
    batch and halves the calls. Where they differ (low block degrees in
    b), each runs its own chain; the JAX package's add_sub then runs one
    chain on the larger of the two degrees of each block."""
    if a.nblocks != b.nblocks:
        raise ValueError("operands of different widths")
    a = _fresh(sk, a)
    b = _fresh(sk, b)
    return tuple(add_sub_many(sk, [("add", a, b), ("sub", a, b)]))


def _scalar_ct(sk: ServerKey, a: RadixCiphertext, s: int) -> RadixCiphertext:
    """A trivial radix of the clear scalar s (mod 2^nbits) over a's batch."""
    s = s % (1 << a.nbits)
    return trivial_radix(sk.params, np.full(a.batch_shape, s, dtype=np.uint64), a.nbits, sk.device)


def neg(sk: ServerKey, a: RadixCiphertext) -> RadixCiphertext:
    return sub(sk, _scalar_ct(sk, a, 0), a)


def scalar_add(sk: ServerKey, a: RadixCiphertext, s: int) -> RadixCiphertext:
    return add(sk, a, _scalar_ct(sk, a, s))


def scalar_sub(sk: ServerKey, a: RadixCiphertext, s: int) -> RadixCiphertext:
    return sub(sk, a, _scalar_ct(sk, a, s))


# -- bitwise ops ----------------------------------------------------------------------


def _bivariate_blocks(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext, f: Callable) -> RadixCiphertext:
    """Apply f(a_i, b_i) to every aligned block pair in one PBS call."""
    p = sk.params
    m = p.message_modulus
    a = _fresh(sk, a)
    b = _fresh(sk, b)
    packed = a.blocks * m + b.blocks
    table = _lut_table(p, lambda v: f(v // m, v % m))
    out = _pbs(sk, packed, _lut(sk, table))
    return RadixCiphertext(blocks=out, params=p, degrees=(int(table.max()),) * a.nblocks)


@span("integer.bitand")
def bitand(sk: ServerKey, a, b) -> RadixCiphertext:
    return _bivariate_blocks(sk, a, b, lambda x, y: x & y)


@span("integer.bitor")
def bitor(sk: ServerKey, a, b) -> RadixCiphertext:
    return _bivariate_blocks(sk, a, b, lambda x, y: x | y)


@span("integer.bitxor")
def bitxor(sk: ServerKey, a, b) -> RadixCiphertext:
    return _bivariate_blocks(sk, a, b, lambda x, y: x ^ y)


def bitnot(sk: ServerKey, a: RadixCiphertext) -> RadixCiphertext:
    return bitnot_blocks(sk, a)


# -- multiplication ---------------------------------------------------------------------


@span("integer.mul")
def mul(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    """Schoolbook block multiply mod 2^nbits: every partial product (lo
    and hi halves of every block pair) in ONE stacked bivariate PBS, then
    the columns are summed with carry flushes."""
    p = sk.params
    m = p.message_modulus
    nb = a.nblocks
    a = _fresh(sk, a)
    b = _fresh(sk, b)
    jobs = []  # (column, degree)
    cts = []
    tables = []
    lo_table = _lut_table(p, lambda v: ((v // m) * (v % m)) % m)
    hi_table = _lut_table(p, lambda v: ((v // m) * (v % m)) // m)
    for i in range(nb):
        for j in range(nb):
            if i + j < nb:
                cts.append(a.blocks[..., i, :] * m + b.blocks[..., j, :])
                tables.append(lo_table)
                jobs.append((i + j, m - 1))
            if i + j + 1 < nb:
                cts.append(a.blocks[..., i, :] * m + b.blocks[..., j, :])
                tables.append(hi_table)
                jobs.append((i + j + 1, (m - 1) * (m - 1) // m))
    outs = _stacked_pbs(sk, cts, tables)
    columns = [[] for _ in range(nb)]  # (ct, degree) terms per column
    for (col, deg), ct in zip(jobs, outs):
        columns[col].append((ct, deg))
    return _sum_columns(sk, columns)


def _sum_columns(sk: ServerKey, columns: list) -> RadixCiphertext:
    """Sum per-column term lists into a radix ciphertext, flushing carries
    whenever a column's accumulated degree would overflow the carry space."""
    p = sk.params
    m = p.message_modulus
    space = m * p.carry_modulus
    nb = len(columns)
    msg_table = _lut_table(p, lambda v: v % m)
    car_table = _lut_table(p, lambda v: v // m)
    zero = None
    while True:
        # accumulate within capacity
        acc = []
        for col in range(nb):
            terms = columns[col]
            if not terms:
                if zero is None:
                    zero = torch.zeros_like(columns[_first_nonempty(columns)][0][0])
                acc.append((zero, 0))
                continue
            ct, deg = terms[0]
            for t_ct, t_deg in terms[1:]:
                if deg + t_deg >= space:
                    break
                ct = ct + t_ct
                deg += t_deg
            acc.append((ct, deg))
            columns[col] = terms[_consumed_count(terms, space) :]
        if all(not columns[c] for c in range(nb)) and all(deg < m for _, deg in acc):
            blocks = torch.stack([ct for ct, _ in acc], dim=-2)
            return RadixCiphertext(blocks=blocks, params=p, degrees=tuple(d for _, d in acc))
        # flush: message back into the column, carry into the next column's terms
        flush_cts = []
        flush_tables = []
        for col in range(nb):
            ct, deg = acc[col]
            flush_cts.append(ct)
            flush_tables.append(msg_table)
            if col + 1 < nb and deg >= m:
                flush_cts.append(ct)
                flush_tables.append(car_table)
        outs = _stacked_pbs(sk, flush_cts, flush_tables)
        oi = 0
        new_columns = [[] for _ in range(nb)]
        for col in range(nb):
            ct, deg = acc[col]
            new_columns[col].insert(0, (outs[oi], min(deg, m - 1)))
            oi += 1
            if col + 1 < nb and deg >= m:
                new_columns[col + 1].append((outs[oi], deg // m))
                oi += 1
        # keep any unconsumed leftovers
        for col in range(nb):
            new_columns[col].extend(columns[col])
        columns = new_columns


def _first_nonempty(columns):
    for i, c in enumerate(columns):
        if c:
            return i
    raise ValueError("all columns empty")


def _consumed_count(terms, space):
    deg = terms[0][1]
    n = 1
    for _, td in terms[1:]:
        if deg + td >= space:
            break
        deg += td
        n += 1
    return n


# -- comparisons -----------------------------------------------------------------------


def _tree_reduce_blocks(sk: ServerKey, items: list, combine_f: Callable, max_val: int) -> torch.Tensor:
    """Tree-reduce single blocks with a bivariate LUT combine. items: list
    of (..., kN+1) blocks with values <= max_val < msg_mod."""
    p = sk.params
    m = p.message_modulus
    if max_val >= m:
        raise ValueError("tree-reduced blocks must hold values below msg_mod")
    table = _lut_table(p, lambda v: combine_f(v // m, v % m))
    while len(items) > 1:
        cts = []
        carry = items[-1] if len(items) % 2 else None
        for i in range(0, len(items) - (1 if carry is not None else 0), 2):
            cts.append(items[i] * m + items[i + 1])
        outs = _stacked_pbs(sk, cts, [table] * len(cts)) if cts else []
        items = outs + ([carry] if carry is not None else [])
    return items[0]


def _bool_block(sk: ServerKey, ct: torch.Tensor) -> si.Ciphertext:
    return si.Ciphertext(ct=ct, params=sk.params, degree=1, noise_level=1)


@span("integer.eq")
def eq(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> si.Ciphertext:
    """An encrypted boolean block (value in {0,1})."""
    ne_blocks = _bivariate_blocks(sk, a, b, lambda x, y: 1 if x != y else 0)
    items = [ne_blocks.blocks[..., i, :] for i in range(ne_blocks.nblocks)]
    any_ne = _tree_reduce_blocks(sk, items, lambda x, y: int(bool(x or y)), 1)
    return _bool_block(sk, _pbs(sk, any_ne, _lut(sk, _lut_table(sk.params, lambda v: 0 if v else 1))))


@span("integer.ne")
def ne(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> si.Ciphertext:
    e = eq(sk, a, b)
    return _bool_block(sk, _pbs(sk, e.ct, _lut(sk, _lut_table(sk.params, lambda v: 0 if v else 1))))


def _compare_sign(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext) -> torch.Tensor:
    """Per-ciphertext trichotomy block: 0 if a<b, 1 if a==b, 2 if a>b."""
    c = _bivariate_blocks(sk, a, b, lambda x, y: 0 if x < y else (1 if x == y else 2))
    # combine MSB-first: result = hi if hi != 1 else lo
    items = [c.blocks[..., i, :] for i in range(c.nblocks - 1, -1, -1)]
    return _tree_reduce_blocks(sk, items, lambda hi, lo: hi if hi != 1 else lo, 2)


def _sign_to_bool(sk: ServerKey, sign: torch.Tensor, pred: Callable) -> si.Ciphertext:
    table = _lut_table(sk.params, lambda v: 1 if pred(v) else 0)
    return _bool_block(sk, _pbs(sk, sign, _lut(sk, table)))


@span("integer.lt")
def lt(sk, a, b):
    return _sign_to_bool(sk, _compare_sign(sk, a, b), lambda s: s == 0)


@span("integer.le")
def le(sk, a, b):
    return _sign_to_bool(sk, _compare_sign(sk, a, b), lambda s: s != 2)


@span("integer.gt")
def gt(sk, a, b):
    return _sign_to_bool(sk, _compare_sign(sk, a, b), lambda s: s == 2)


@span("integer.ge")
def ge(sk, a, b):
    return _sign_to_bool(sk, _compare_sign(sk, a, b), lambda s: s != 0)


# -- select / min / max -------------------------------------------------------------------


@span("integer.select")
def select(sk: ServerKey, cond: si.Ciphertext, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
    """cond ? a : b, cond a 0/1 block. Two stacked bivariate PBS per block
    batch + add; one when either side is a trivial zero (degrees all 0)."""
    p = sk.params
    m = p.message_modulus
    a = _fresh(sk, a)
    b = _fresh(sk, b)
    nb = a.nblocks
    cond_b = cond.ct[..., None, :].expand(a.blocks.shape)
    ta = _lut_table(p, lambda v: (v % m) if (v // m) == 1 else 0)
    tb = _lut_table(p, lambda v: (v % m) if (v // m) == 0 else 0)
    if all(d == 0 for d in b.degrees):
        # select vs a trivial zero (the ERC20 `moved` gate): one bivariate
        # PBS per block instead of two + add
        out = _pbs(sk, cond_b * m + a.blocks, _lut(sk, ta))
    elif all(d == 0 for d in a.degrees):
        out = _pbs(sk, cond_b * m + b.blocks, _lut(sk, tb))
    else:
        out_a, out_b = _stacked_pbs(sk, [cond_b * m + a.blocks, cond_b * m + b.blocks], [ta, tb])
        out = out_a + out_b  # exactly one term is nonzero per block
    return RadixCiphertext(blocks=out, params=p, degrees=(m - 1,) * nb)


def min_(sk, a, b):
    return select(sk, lt(sk, a, b), a, b)


def max_(sk, a, b):
    return select(sk, lt(sk, a, b), b, a)


# -- shifts / rotates (clear amount) --------------------------------------------------------


def _shift_blocks(sk: ServerKey, a: RadixCiphertext, r: int, rotate: bool, left: bool) -> RadixCiphertext:
    p = sk.params
    m = p.message_modulus
    bpb = _bits_per_block(p)
    nb = a.nblocks
    # fhevm/tfhe-rs semantics: shift and rotate amounts reduce mod nbits
    r = r % a.nbits
    q, rr = divmod(r, bpb)
    a = _fresh(sk, a)
    blocks = [a.blocks[..., i, :] for i in range(nb)]
    zero = torch.zeros_like(blocks[0])

    def get(i):
        if rotate:
            return blocks[i % nb]
        return blocks[i] if 0 <= i < nb else zero

    # block-level move
    moved = [get(i - q) if left else get(i + q) for i in range(nb)]
    if rr == 0:
        return RadixCiphertext(blocks=torch.stack(moved, dim=-2), params=p, degrees=(m - 1,) * nb)
    # sub-block shift: combine adjacent blocks with a bivariate LUT
    if left:
        others = [get(i - q - 1) for i in range(nb)]
        f = lambda cur, low: ((cur << rr) | (low >> (bpb - rr))) % m
    else:
        others = [get(i + q + 1) for i in range(nb)]
        f = lambda cur, up: (cur >> rr) | ((up << (bpb - rr)) % m)
    pairs = torch.stack([moved[i] * m + others[i] for i in range(nb)], dim=-2)
    out = _pbs(sk, pairs, _lut(sk, _lut_table(p, lambda v: f(v // m, v % m))))
    return RadixCiphertext(blocks=out, params=p, degrees=(m - 1,) * nb)


@span("integer.shl")
def shl(sk, a, r: int):
    return _shift_blocks(sk, a, r, rotate=False, left=True)


@span("integer.shr")
def shr(sk, a, r: int):
    return _shift_blocks(sk, a, r, rotate=False, left=False)


@span("integer.rotl")
def rotl(sk, a, r: int):
    return _shift_blocks(sk, a, r, rotate=True, left=True)


@span("integer.rotr")
def rotr(sk, a, r: int):
    return _shift_blocks(sk, a, r, rotate=True, left=False)


# -- bit extraction / encrypted-amount shifts / division ---------------------------------------


@span("integer.extract_bits")
def extract_bits(sk: ServerKey, a: RadixCiphertext) -> list:
    """All nbits bits of `a` as fresh 0/1 blocks (LSB first), via one
    stacked PBS over (block, bit-position) pairs."""
    p = sk.params
    bpb = _bits_per_block(p)
    a = _fresh(sk, a)
    cts = []
    tables = []
    for i in range(a.nblocks):
        for r in range(bpb):
            cts.append(a.blocks[..., i, :])
            tables.append(_lut_table(p, lambda v, r=r: (v >> r) & 1))
    return _stacked_pbs(sk, cts, tables)  # list of (..., kN+1), values in {0,1}


def _encrypted_shift(sk: ServerKey, a: RadixCiphertext, amt: RadixCiphertext, kind: str) -> RadixCiphertext:
    """Barrel shifter: for each bit k of the (mod nbits) amount, select
    between the current value and its 2^k-shifted version."""
    nbits = a.nbits
    n_amt_bits = int(math.log2(nbits))
    if 2**n_amt_bits != nbits:
        raise ValueError("encrypted shifts need a power-of-two width")
    bits = extract_bits(sk, amt)[:n_amt_bits]  # amount mod nbits
    shift_f = {"shl": shl, "shr": shr, "rotl": rotl, "rotr": rotr}[kind]
    cur = _fresh(sk, a)
    for k, bit in enumerate(bits):
        cur = select(sk, _bool_block(sk, bit), shift_f(sk, cur, 1 << k), cur)
    return cur


@span("integer.shl_enc")
def shl_enc(sk, a, amt):
    return _encrypted_shift(sk, a, amt, "shl")


@span("integer.shr_enc")
def shr_enc(sk, a, amt):
    return _encrypted_shift(sk, a, amt, "shr")


@span("integer.rotl_enc")
def rotl_enc(sk, a, amt):
    return _encrypted_shift(sk, a, amt, "rotl")


@span("integer.rotr_enc")
def rotr_enc(sk, a, amt):
    return _encrypted_shift(sk, a, amt, "rotr")


@span("integer.div_rem")
def div_rem(sk: ServerKey, a: RadixCiphertext, b: RadixCiphertext):
    """Restoring division: (quotient, remainder), unsigned. Bit-serial:
    nbits rounds of R <- 2R + bit, compare, conditional subtract. Division
    by zero follows tfhe-rs: quotient all ones, remainder = dividend."""
    p = sk.params
    m = p.message_modulus
    nbits = a.nbits
    bpb = _bits_per_block(p)
    wide = nbits + 2 * bpb  # headroom for the 2R+1 step
    bits = extract_bits(sk, a)  # LSB first
    d = cast(sk, _fresh(sk, b), wide)
    r = trivial_radix(p, np.zeros(a.batch_shape, dtype=np.uint64), wide, sk.device)
    q_bits = {}
    zero_block = torch.zeros_like(bits[0])
    for i in range(nbits - 1, -1, -1):
        # R = 2R + bit_i
        r2 = shl(sk, r, 1)
        bit_radix = RadixCiphertext(
            blocks=torch.stack([bits[i]] + [zero_block] * (r2.nblocks - 1), dim=-2),
            params=p,
            degrees=(1,) + (0,) * (r2.nblocks - 1),
        )
        r2 = add(sk, r2, bit_radix)
        c = ge(sk, r2, d)  # 0/1 block
        r = select(sk, c, sub(sk, r2, d), r2)
        q_bits[i] = c.ct
    # assemble the quotient: block j = bit_{2j} + 2*bit_{2j+1} (linear, no PBS)
    nb = blocks_for_bits(p, nbits)
    blocks = []
    for j in range(nb):
        blk = q_bits[j * bpb]
        for t in range(1, bpb):
            blk = blk + q_bits[j * bpb + t] * (1 << t)
        blocks.append(blk)
    quot = RadixCiphertext(blocks=torch.stack(blocks, dim=-2), params=p, degrees=(m - 1,) * nb)
    return quot, cast(sk, r, nbits)


def div(sk, a, b):
    return div_rem(sk, a, b)[0]


def rem(sk, a, b):
    return div_rem(sk, a, b)[1]


def scalar_div(sk, a, s: int):
    return div(sk, a, _scalar_ct(sk, a, s))


def scalar_rem(sk, a, s: int):
    return rem(sk, a, _scalar_ct(sk, a, s))


# -- casts ------------------------------------------------------------------------------------


@span("integer.cast")
def cast(sk: ServerKey, a: RadixCiphertext, nbits: int) -> RadixCiphertext:
    """Zero-extend or truncate (fhevm asEuintX semantics for unsigned)."""
    p = sk.params
    nb_new = blocks_for_bits(p, nbits)
    a = _fresh(sk, a)
    if nb_new == a.nblocks:
        return a
    if nb_new < a.nblocks:
        return RadixCiphertext(blocks=a.blocks[..., :nb_new, :], params=p, degrees=a.degrees[:nb_new])
    pad = a.blocks.new_zeros(a.batch_shape + (nb_new - a.nblocks, a.blocks.shape[-1]))
    return RadixCiphertext(
        blocks=torch.cat([a.blocks, pad], dim=-2), params=p, degrees=a.degrees + (0,) * (nb_new - a.nblocks)
    )


# -- scalar variants ----------------------------------------------------------------------------


def scalar_mul(sk, a, s: int):
    return mul(sk, a, _scalar_ct(sk, a, s))


def scalar_bitand(sk, a, s: int):
    return bitand(sk, a, _scalar_ct(sk, a, s))


def scalar_bitor(sk, a, s: int):
    return bitor(sk, a, _scalar_ct(sk, a, s))


def scalar_bitxor(sk, a, s: int):
    return bitxor(sk, a, _scalar_ct(sk, a, s))


def scalar_eq(sk, a, s: int):
    return eq(sk, a, _scalar_ct(sk, a, s))


def scalar_ne(sk, a, s: int):
    return ne(sk, a, _scalar_ct(sk, a, s))


def scalar_lt(sk, a, s: int):
    return lt(sk, a, _scalar_ct(sk, a, s))


def scalar_le(sk, a, s: int):
    return le(sk, a, _scalar_ct(sk, a, s))


def scalar_gt(sk, a, s: int):
    return gt(sk, a, _scalar_ct(sk, a, s))


def scalar_ge(sk, a, s: int):
    return ge(sk, a, _scalar_ct(sk, a, s))


def scalar_min(sk, a, s: int):
    return min_(sk, a, _scalar_ct(sk, a, s))


def scalar_max(sk, a, s: int):
    return max_(sk, a, _scalar_ct(sk, a, s))
