"""The dropless MoE's grouped expert products.

Three grouped products (gate, up, down) of PyTorch's grouped GEMM
(``torch._grouped_mm``, not a kernel of the port) over the experts'
segments of the assignments sorted by expert, so an expert with no row
costs nothing. It sits beside the port's kernels so that
``launch_counters()`` counts its calls with theirs (``moe_experts``) and
the models call it as they call the kernels' wrappers; it replaces no TPU
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import count_launch, counted


@counted
def grouped_experts(xs, w_gate, w_up, w_down, ends):
    """The routed experts' SwiGLU over ``xs`` (N, D), whose rows are sorted
    by expert: rows ``ends[e-1]:ends[e]`` (``ends`` (E,) int32, inclusive
    cumulative counts) go through expert ``e`` of ``w_gate``, ``w_up`` (E,
    D, F) and ``w_down`` (E, F, D). On the card each call counts one launch
    of the grouped expert products."""
    g = F.silu(torch._grouped_mm(xs, w_gate, offs=ends))
    u = torch._grouped_mm(xs, w_up, offs=ends)
    ys = torch._grouped_mm(g * u, w_down, offs=ends)
    if xs.is_cuda:
        count_launch(grouped_experts, (tuple(xs.shape), tuple(w_gate.shape)))
    return ys
