"""Profiling for the torch port: the cost model's task history."""
from repro_torch.profile.cost import CostModel  # noqa: F401
