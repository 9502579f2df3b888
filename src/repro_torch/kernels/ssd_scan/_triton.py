"""Triton bodies of the prefix-scan kernel (design note in ``prefix.py``).

Imported only by a CUDA launch (``repro_torch.kernels.triton_kernels``).
"""
import triton
import triton.language as tl


@triton.jit
def _add(a, b):
    return a + b


@triton.jit
def _max(a, b):
    return tl.maximum(a, b)


@triton.jit
def _min(a, b):
    return tl.minimum(a, b)


@triton.jit
def scan_tile(x_ptr, out_ptr, agg_ptr, n, ident,
              OP: tl.constexpr, BLOCK: tl.constexpr):
    t = tl.program_id(0)
    offs = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m, other=ident)
    if OP == 0:
        y = tl.associative_scan(x, 0, _add)
        a = tl.reduce(x, 0, _add)
    elif OP == 1:
        y = tl.associative_scan(x, 0, _max)
        a = tl.reduce(x, 0, _max)
    else:
        y = tl.associative_scan(x, 0, _min)
        a = tl.reduce(x, 0, _min)
    tl.store(out_ptr + offs, y, mask=m)
    tl.store(agg_ptr + t, a)


@triton.jit
def fold_carry(out_ptr, inc_ptr, n, OP: tl.constexpr, BLOCK: tl.constexpr):
    t = tl.program_id(0) + 1  # tile 0 has no carry
    carry = tl.load(inc_ptr + t - 1)
    offs = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    y = tl.load(out_ptr + offs, mask=m)
    if OP == 0:
        y = carry + y
    elif OP == 1:
        y = tl.maximum(carry, y)
    else:
        y = tl.minimum(carry, y)
    tl.store(out_ptr + offs, y, mask=m)
