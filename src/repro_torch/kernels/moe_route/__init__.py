from repro_torch.kernels.moe_route.ops import bucket_route, moe_route  # noqa: F401
from repro_torch.kernels.moe_route.ref import bucket_route_ref, moe_route_ref  # noqa: F401
