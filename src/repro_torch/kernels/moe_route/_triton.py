"""Triton bodies of the bucket-route kernel (design note in ``route.py``).

Imported only by a CUDA launch (``repro_torch.kernels.triton_kernels``).
"""
import triton
import triton.language as tl


@triton.jit
def tile_hist(d_ptr, hist_ptr, n, P: tl.constexpr, PP: tl.constexpr,
              BLOCK: tl.constexpr):
    t = tl.program_id(0)
    rows = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    cols = tl.arange(0, PP)
    d = tl.load(d_ptr + rows, mask=rows < n, other=P)
    oh = ((d[:, None] == cols[None, :]) & (cols[None, :] < P)).to(tl.int32)
    tl.store(hist_ptr + t.to(tl.int64) * P + cols, tl.sum(oh, 0), mask=cols < P)


@triton.jit
def col_scan(hist_ptr, base_ptr, counts_ptr, n_tiles, P: tl.constexpr,
             CHUNK: tl.constexpr):
    col = tl.program_id(0)
    carry = tl.zeros((1,), tl.int32)
    for start in range(0, n_tiles, CHUNK):
        tiles = start + tl.arange(0, CHUNK)
        m = tiles < n_tiles
        offs = tiles.to(tl.int64) * P + col
        h = tl.load(hist_ptr + offs, mask=m, other=0)
        tl.store(base_ptr + offs, tl.cumsum(h, 0) - h + carry, mask=m)
        carry += tl.sum(h, 0)
    tl.store(counts_ptr + col + tl.arange(0, 1), carry)


@triton.jit
def tile_rank(d_ptr, base_ptr, pos_ptr, keep_ptr, n, capacity,
              P: tl.constexpr, PP: tl.constexpr, BLOCK: tl.constexpr):
    t = tl.program_id(0)
    rows = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    cols = tl.arange(0, PP)
    rm = rows < n
    d = tl.load(d_ptr + rows, mask=rm, other=P)
    oh = ((d[:, None] == cols[None, :]) & (cols[None, :] < P)).to(tl.int32)
    csum = tl.cumsum(oh, 0)
    local = tl.sum((csum - oh) * oh, 1)
    base = tl.load(base_ptr + t.to(tl.int64) * P + cols, mask=cols < P, other=0)
    pos = tl.sum(oh * base[None, :], 1) + local
    keep = (pos < capacity) & (d < P)
    tl.store(pos_ptr + rows, pos, mask=rm)
    tl.store(keep_ptr + rows, keep.to(tl.uint8), mask=rm)
