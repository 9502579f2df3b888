"""Operations and bytes of the dropless MoE's grouped expert products,
from what the program's ``moe.experts`` span counts (beside ``counts.py``,
whose formulas it does not change)."""
from __future__ import annotations


def moe_flop_bytes(D, F, assignments, experts_hit, itemsize):
    """(operations, bytes) of one layer's routed SwiGLU experts: gate, up
    and down products of 2·D·F operations each an assignment; each expert
    hit reads its three D x F matrices once, and each assignment reads its
    token's row and writes its output row once."""
    flop = 6 * D * F * assignments
    nbytes = 3 * D * F * itemsize * experts_hit + 2 * D * itemsize * assignments
    return flop, nbytes
