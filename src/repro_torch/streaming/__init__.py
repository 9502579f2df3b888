"""Serving at the scheduler (the port of part of ``repro.streaming``):
``ServeFrontDoor`` runs a ``ServeEngine``'s decode ticks as ``IJob`` tasks
of kind ``serve``, with per-tenant ``StreamTelemetry``. The ingestion half
(sources, admission, stream context, tenant front end) is ROADMAP A.5."""
from repro_torch.streaming.serve import ServeFrontDoor, ServeTicket  # noqa: F401
from repro_torch.streaming.telemetry import StreamTelemetry  # noqa: F401
