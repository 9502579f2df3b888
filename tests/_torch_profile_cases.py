"""Cases that tests/test_torch_profile.py runs on both packages: the JAX
package's at p = 8 in a subprocess (tests/_torch_profile_main.py), the
port's in the test process."""
import re

import numpy as np


def two_gang_job(core, profile, props):
    """A traced job dealt round-robin onto two gang groups of one worker
    (``IJob(gang=2)``), with a second worker importing one group's frame:
    action tasks on both groups, then a stage, a reshard and an action that
    depend on each other. Returns the capture's structure — each task's
    kind, lane, name (node ids stripped) and dependencies as indices into
    the capture — and the (name, category, arg keys) of the spans."""
    w = core.IWorker(core.ICluster(core.IProperties(props)), "python")
    w2 = core.IWorker(core.ICluster(core.IProperties(props)), "python")
    tracer = profile.JobTracer()
    tracer.attach_worker(w)
    job = core.IJob("two-gang", gang=2)
    tracer.attach(job)
    x = np.arange(4096, dtype=np.int32)
    src = w.parallelize({"key": x % 64, "value": x % 7})
    counts = (src.map(lambda r: {"key": r["key"], "value": r["value"]})
              .reduce_by_key(lambda a, b: a + b, 0))
    flipped = (src.map(lambda r: {"key": r["value"], "value": r["key"]})
               .reduce_by_key(lambda a, b: a + b, 0))
    moved = w2.import_data(counts).map(lambda r: {"key": r["key"], "value": r["value"] * 2})
    futs = [counts.count_async(job=job), flipped.count_async(job=job),
            moved.count_async(job=job)]
    counted = [int(f.result()) for f in futs]
    trace = profile.capture(job)
    index = {t.id: i for i, t in enumerate(trace.tasks)}
    tasks = [[t.kind, t.lane, re.sub(r"#\d+", "#", t.name), [index[d] for d in t.deps]]
             for t in trace.tasks]
    spans = sorted({(s.name if s.cat != "task" or s.name in ("compute", "settle")
                     else "<task>", s.cat, tuple(sorted(s.args)))
                    for s in tracer.spans()})
    tracer.detach()
    return {"counts": counted, "tasks": tasks, "spans": [list(s) for s in spans],
            "lanes": trace.lanes()}
