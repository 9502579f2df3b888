"""Streaming micro-batch ingestion + multi-tenant serving (docs/streaming.md).

The subsystem turns unbounded sources into bounded sequences of micro-batch
job-task submissions on the ``IJob`` scheduler: per-tenant gang groups
are the isolation primitive (docs/collectives.md), admission control +
driver-side backpressure bound the in-flight depth, and stream offsets +
operator state checkpoint through ``repro_torch.checkpoint`` for exactly-once
restart. ``ServeFrontDoor`` runs continuous-batching decode ticks as
scheduler tasks so serving and ingestion overlap in one DAG — the paper's
hybrid pattern at serving time.
"""
from repro_torch.streaming.admission import AdmissionController
from repro_torch.streaming.context import StreamContext
from repro_torch.streaming.frontend import TenantFrontEnd
from repro_torch.streaming.serve import ServeFrontDoor, ServeTicket
from repro_torch.streaming.source import (
    ArraySource,
    IteratorSource,
    StreamSource,
    TenantRequestSource,
)
from repro_torch.streaming.telemetry import StreamTelemetry

__all__ = [
    "AdmissionController",
    "ArraySource",
    "IteratorSource",
    "ServeFrontDoor",
    "ServeTicket",
    "StreamContext",
    "StreamSource",
    "StreamTelemetry",
    "TenantFrontEnd",
    "TenantRequestSource",
]
