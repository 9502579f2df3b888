"""HPC proxy apps run as native SPMD programs (paper §6.3 analogues).

* ``stencil`` — Jacobi relaxation with ring halo exchange (the ppermute
  Isend/Irecv pattern): the LULESH / miniAMR communication pattern.
* ``cg_solver`` — matrix-free conjugate gradient on a 1-D Laplacian:
  Allreduce-dominated, the AMG pattern (dot products every iteration).

Both are written exactly like the paper's ported MPI apps (Fig. 10): the
function receives the framework communicator from the context — the
IGNIS_COMM_WORLD swap, here the ``(ranks, axis)`` pair of ``ctx.comm()`` —
and otherwise keeps its "native" structure. The program runs over every
rank at once: a flat rank-major operand viewed as ``(p, rows/p, …)``, a
halo exchange a roll of that view over the rank axis (as
``comm.ppermute`` does), a dot product's psum a sum over all ranks.
"""
from __future__ import annotations

import torch

from repro_torch.core import comm
from repro_torch.core.native import ignis_export


def _spmd_plan(tag: str, ranks, axis: str, statics: tuple, prog, x):
    """Persistent plan for a whole SPMD program (comm.persistent_program):
    built once per (program, statics, operand shape, dtype and device,
    communicator) and reused from the collective plan cache."""
    x = torch.as_tensor(x)

    def build_plan():
        return prog

    return comm.persistent_program(
        tag, (tuple(ranks), axis),
        (*statics, tuple(x.shape), str(x.dtype), str(x.device)), build_plan), x


def _halos(v):
    """Ring halo exchange over the rank axis of ``v`` (p, rows, …): each
    rank's upper halo is its predecessor's last row, its lower halo its
    successor's first row."""
    up = torch.roll(v[:, -1:], 1, dims=0)  # halo from above: rank i-1 → i
    dn = torch.roll(v[:, :1], -1, dims=0)  # halo from below: rank i+1 → i
    return up, dn


# ---------------------------------------------------------------------------
# stencil (LULESH/miniAMR analogue)
# ---------------------------------------------------------------------------


def stencil_native(ranks, axis, grid, iters: int):
    """The 'native MPI' program: runs directly over the ranks (the
    benchmark's baseline — executing the app without the framework)."""
    p = len(ranks)

    def prog(u):  # u: (rows, cols), rank-major rows
        v = u.reshape(p, -1, *u.shape[1:])
        for _ in range(iters):
            up, dn = _halos(v)
            ext = torch.cat([up, v, dn], dim=1)
            v = (ext[:, :-2] + ext[:, 2:] + torch.roll(v, 1, 2)
                 + torch.roll(v, -1, 2)) * 0.25
        return v.reshape(u.shape)

    fn, grid = _spmd_plan("stencil", ranks, axis, (iters,), prog, grid)
    return fn(grid)


@ignis_export("stencil_app")
def stencil_app(ctx, data=None, valid=None):
    """Framework-wrapped version (paper Fig. 10): args from the context."""
    iters = int(ctx.var("iters", 10))
    ranks, axis = ctx.comm()  # ← the MPI_COMM_WORLD swap
    out = stencil_native(ranks, axis, data, iters)
    return out, valid


# ---------------------------------------------------------------------------
# CG solver (AMG analogue — Allreduce-heavy)
# ---------------------------------------------------------------------------


def cg_native(ranks, axis, b, iters: int):
    """Solve A x = b for the 1-D Laplacian A = tridiag(-1, 2, -1), rows
    rank-major over the ranks; halo exchange in matvec, a sum over every
    rank's dot in dots."""
    p = len(ranks)

    def prog(b):  # b: (n,), rank-major
        first = torch.arange(p, device=b.device)[:, None] == 0
        last = torch.arange(p, device=b.device)[:, None] == p - 1

        def matvec(x):
            v = x.reshape(p, -1)
            up, dn = _halos(v)
            up = torch.where(first, 0.0, up)  # Dirichlet boundaries
            dn = torch.where(last, 0.0, dn)
            xm = torch.cat([up, v, dn], dim=1)
            return (2 * v - xm[:, :-2] - xm[:, 2:]).reshape(x.shape)

        def dot(a, c):
            return (a.reshape(p, -1) * c.reshape(p, -1)).sum(dim=1).sum()

        x = torch.zeros_like(b)
        r = b - matvec(x)
        q = r
        rs = dot(r, r)
        for _ in range(iters):
            Aq = matvec(q)
            alpha = rs / torch.clamp_min(dot(q, Aq), 1e-30)
            x = x + alpha * q
            r = r - alpha * Aq
            rs_new = dot(r, r)
            q = r + (rs_new / torch.clamp_min(rs, 1e-30)) * q
            rs = rs_new
        return x

    fn, b = _spmd_plan("cg", ranks, axis, (iters,), prog, b)
    return fn(b)


@ignis_export("cg_app")
def cg_app(ctx, data=None, valid=None):
    iters = int(ctx.var("iters", 20))
    ranks, axis = ctx.comm()
    out = cg_native(ranks, axis, data, iters)
    # hand the in-flight result back as a nonblocking handle: the driver
    # layer chains the Block adaptation onto it and the engine awaits it
    return comm.CollHandle("spmd.cg", ctx, (out, valid))


def laplacian_matvec_ref(x):
    xm = torch.nn.functional.pad(x, (1, 1))
    return 2 * x - xm[:-2] - xm[2:]
