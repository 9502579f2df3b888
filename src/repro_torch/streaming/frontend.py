"""TenantFrontEnd — admit tenants onto per-tenant gang groups
(docs/streaming.md).

The isolation primitive is the communicator split (``worker.groups(n)``):
each admitted tenant's micro-batches are pinned to one group, so tenants
run concurrently on disjoint rank slices under per-group locks — one
tenant's heavy stream cannot serialize another's (the oracle test compares
per-tenant results and latency against solo runs). All pumps share ONE
``IJob`` (the paper's one-DAG claim), one admission controller and one
telemetry sink; ``job.stats()['stream']`` aggregates across tenants.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.job import IJob
from repro_torch.streaming.admission import AdmissionController
from repro_torch.streaming.context import StreamContext
from repro_torch.streaming.telemetry import StreamTelemetry


class TenantFrontEnd:
    def __init__(self, worker, *, n_groups: int = 1, name: str = "tenants",
                 props=None, admission: Optional[AdmissionController] = None,
                 telemetry: Optional[StreamTelemetry] = None, elastic=None):
        self.worker = worker
        self.name = name
        self.props = props if props is not None else worker.cluster.props
        # autoscaling hook (docs/elasticity.md): an ElasticPolicy here is
        # notified on every admit — tenants arrive, the world follows. The
        # front end's gang groups stay as built (pumps pin their group for
        # life); the grown ranks serve WORLD-communicator work and the next
        # front end built at the new size.
        self.elastic = elastic
        self.groups = worker.groups(n_groups) if n_groups > 1 else [None]
        self.job = IJob(name)
        self.admission = admission or AdmissionController(self.props)
        self.telemetry = telemetry or StreamTelemetry()
        self.telemetry.attach(self.job, self.admission)
        self._streams: dict[str, StreamContext] = {}
        self._next_group = 0

    def admit(self, tenant: str, source, *, ckpt_dir=None, init_state=None,
              batch_fn=None, fold_fn=None) -> StreamContext:
        """Admit a tenant: deal it the next gang group round-robin and build
        its pump. The pump shares the front end's job/admission/telemetry."""
        if tenant in self._streams:
            raise ValueError(f"tenant {tenant!r} already admitted")
        if self.elastic is not None:
            self.elastic.on_admit(len(self._streams) + 1)
        group = self.groups[self._next_group % len(self.groups)]
        self._next_group += 1
        sc = StreamContext(
            self.worker, source, tenant=tenant, name=self.name, group=group,
            job=self.job, admission=self.admission, telemetry=self.telemetry,
            props=self.props, ckpt_dir=ckpt_dir, init_state=init_state,
            batch_fn=batch_fn, fold_fn=fold_fn)
        self._streams[tenant] = sc
        return sc

    def stream(self, tenant: str) -> StreamContext:
        return self._streams[tenant]

    def run(self, max_batches: Optional[int] = None) -> dict:
        """Run every admitted tenant's pump concurrently (one driver thread
        per tenant — pumps park on futures, workers never block). Returns
        ``{tenant: final_state}``; re-raises the first pump error."""
        results: dict = {}
        errors: list = []

        def pump(tenant: str, sc: StreamContext):
            try:
                results[tenant] = sc.run(max_batches)
            except BaseException as e:  # surfaced to the caller below
                errors.append((tenant, e))

        threads = [
            threading.Thread(target=pump, args=(t, sc), daemon=True,
                             name=f"pump-{t}")
            for t, sc in self._streams.items()
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            tenant, err = errors[0]
            raise RuntimeError(f"tenant {tenant!r} pump failed") from err
        return results

    def stats(self) -> dict:
        return {
            "tenants": {t: sc.stats() for t, sc in self._streams.items()},
            "telemetry": self.telemetry.snapshot(self.admission),
            "job": self.job.stats(),
        }

    def summary(self) -> str:
        return self.telemetry.summary(self.admission)
