"""repro_torch.profile — profiling, cost modelling, and what-if replay (the
port of ``repro.profile``; docs/profiling.md).

``JobTracer`` captures per-task phase spans (lock-wait / compute /
collective-settle) and engine stage spans into Chrome-trace timelines;
``CostModel`` prices work statically (aten graphs traced on fake tensors,
and compiled HLO text via launch/hlo_cost.py) and learns task-duration
history; ``replay`` re-schedules a captured trace under hypothetical gang
splits, placements, and speculative timeouts; ``calibration`` measures the
device's rates. The scheduler consumes the model for cost-aware fusion
boundaries (``ignis.fusion.mode=cost``) and auto speculative timeouts
(``ignis.task.speculative.timeout=auto``)."""
from repro_torch.profile.calibration import (  # noqa: F401
    calibrate, calibrated_model, fit_from_trace,
)
from repro_torch.profile.cost import CostEstimate, CostModel, DeviceParams  # noqa: F401
from repro_torch.profile.replay import (  # noqa: F401
    Hypothesis, Schedule, Trace, TaskRecord, capture, predicted_vs_measured,
    simulate,
)
from repro_torch.profile.spans import (  # noqa: F401
    Span, TraceBuffer, save_chrome, to_chrome, validate,
)
from repro_torch.profile.tracer import JobTracer, task_lane  # noqa: F401
