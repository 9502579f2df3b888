from repro_torch.kernels.segment_reduce.ops import segment_reduce, segment_totals  # noqa: F401
from repro_torch.kernels.segment_reduce.ref import heads_of, segment_reduce_ref  # noqa: F401
