"""Triton bodies of the segmented-scan kernel (design note in
``segment_reduce.py``).

Imported only by a CUDA launch (``repro_torch.kernels.triton_kernels``).
"""
import triton
import triton.language as tl


@triton.jit
def _seg_add(va, fa, vb, fb):
    return tl.where(fb != 0, vb, va + vb), fa | fb


@triton.jit
def _seg_max(va, fa, vb, fb):
    return tl.where(fb != 0, vb, tl.maximum(va, vb)), fa | fb


@triton.jit
def _seg_min(va, fa, vb, fb):
    return tl.where(fb != 0, vb, tl.minimum(va, vb)), fa | fb


@triton.jit
def seg_tile(v_ptr, f_ptr, out_ptr, aggv_ptr, aggf_ptr, n, ident,
             D: tl.constexpr, DP: tl.constexpr, OP: tl.constexpr,
             BLOCK: tl.constexpr):
    t = tl.program_id(0)
    rows = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    cols = tl.arange(0, DP)
    rm = rows < n
    m2 = rm[:, None] & (cols[None, :] < D)
    offs = rows[:, None] * D + cols[None, :]
    v = tl.load(v_ptr + offs, mask=m2, other=ident)
    f = tl.load(f_ptr + rows, mask=rm, other=1).to(tl.int32)
    f2 = tl.broadcast_to(f[:, None], (BLOCK, DP))
    if OP == 0:
        y, g = tl.associative_scan((v, f2), 0, _seg_add)
    elif OP == 1:
        y, g = tl.associative_scan((v, f2), 0, _seg_max)
    else:
        y, g = tl.associative_scan((v, f2), 0, _seg_min)
    tl.store(out_ptr + offs, y, mask=m2)
    # the tile's aggregate is its last scanned row (the segmented combine is
    # not commutative, so a tree reduction's lane order would be wrong) and
    # whether it holds a boundary (a max: commutative)
    last = (tl.arange(0, BLOCK) == BLOCK - 1)[:, None]
    tl.store(aggv_ptr + t * D + cols, tl.sum(tl.where(last, y, 0), 0),
             mask=cols < D)
    tl.store(aggf_ptr + t, tl.max(f, 0).to(tl.uint8))


@triton.jit
def seg_fold(out_ptr, f_ptr, incv_ptr, n, D: tl.constexpr, DP: tl.constexpr,
             OP: tl.constexpr, BLOCK: tl.constexpr):
    t = tl.program_id(0) + 1  # tile 0 has no carry
    rows = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    cols = tl.arange(0, DP)
    rm = rows < n
    m2 = rm[:, None] & (cols[None, :] < D)
    offs = rows[:, None] * D + cols[None, :]
    carry = tl.load(incv_ptr + (t - 1) * D + cols, mask=cols < D)
    f = tl.load(f_ptr + rows, mask=rm, other=1).to(tl.int32)
    seen = tl.cumsum(f, 0) > 0
    y = tl.load(out_ptr + offs, mask=m2)
    if OP == 0:
        c = carry[None, :] + y
    elif OP == 1:
        c = tl.maximum(carry[None, :], y)
    else:
        c = tl.minimum(carry[None, :], y)
    y = tl.where(seen[:, None], y, c)
    tl.store(out_ptr + offs, y, mask=m2)
