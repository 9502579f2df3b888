from repro_torch.kernels.ssd_scan.ops import prefix_scan, ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref, ssd_ref  # noqa: F401
