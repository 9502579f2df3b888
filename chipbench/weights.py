"""Weights drawn from the run's seed on the device, in the dtype they are
served in, in a few large calls: one normal draw for every random leaf of a
dtype (each leaf a view of it, scaled in place), one uniform draw for the
SSM's ``A_log`` leaves and one for its ``dt_bias`` leaves. The reference's
``param_specs`` names the leaves, their shapes, dtypes and laws; the same
seed gives the same weights, which the harness hands to the program and,
after the window, to the reference.
"""
from __future__ import annotations

import math

from chipbench.common import seed_of

#: leaves start on multiples of this many elements of their buffer, so each
#: is as aligned as a tensor of its own
ALIGN = 64


def make(specs: list, seed: int, device) -> dict:
    """``{name: tensor}`` for ``specs`` (``[(name, shape, dtype, init)]``)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed_of(seed, "weights"))
    out = {}
    by_dtype: dict[str, list] = {}
    for name, shape, dt, init in specs:
        if init[0] == "normal":
            by_dtype.setdefault(dt, []).append((name, shape, init[1]))
    for dt, leaves in sorted(by_dtype.items()):
        sizes = [math.prod(s) for _, s, _ in leaves]
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + -(-n // ALIGN) * ALIGN)
        flat = torch.randn(starts[-1], generator=g, dtype=getattr(torch, dt), device=device)
        for (name, shape, std), a, n in zip(leaves, starts, sizes):
            out[name] = flat[a:a + n].view(shape).mul_(std)
    for law in ("a_log", "dt_bias"):
        leaves = [(name, shape, dt, init) for name, shape, dt, init in specs if init[0] == law]
        if not leaves:
            continue
        n = sum(math.prod(s) for _, s, _, _ in leaves)
        u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
        at = 0
        for name, shape, dt, init in leaves:
            k = math.prod(shape)
            x = u[at:at + k].view(shape)
            at += k
            lo, hi = init[1], init[2]
            if law == "a_log":  # log of U(lo, hi)
                val = torch.log(lo + (hi - lo) * x)
            else:  # inverse softplus of a step log-uniform in [lo, hi]
                step = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * x)
                val = step + torch.log(-torch.expm1(-step))
            out[name] = val.to(getattr(torch, dt))
    for name, shape, dt, init in specs:
        if init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), dtype=getattr(torch, dt),
                                   device=device)
    missing = [name for name, *_ in specs if name not in out]
    if missing:
        raise ValueError(f"no law for leaves {missing[:4]}")
    return {name: out[name] for name, *_ in specs}
