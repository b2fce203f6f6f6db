"""The whitepaper ConfidentialERC20 transfer in the clear, the yardstick of
the ERC20 cells: cond = amount <= from; moved = cond ? amount : 0;
from -= moved; to += moved, all mod 2^bits."""


def transfer(balances: list[int], frm: int, to: int, amount: int, bits: int) -> None:
    mask = (1 << bits) - 1
    moved = amount if amount <= balances[frm] else 0
    balances[frm] = (balances[frm] - moved) & mask
    balances[to] = (balances[to] + moved) & mask
