"""``tick_gap_ms.serve``: the mean time the traced ticks waited between
their submission by the front door (``ServeFrontDoor.tick_async``) and
their start on the scheduler: the ``handoff_ms`` of the program's
``serve.tick`` spans. It leaves out the time the caller takes between one
tick's result and the next tick's submission, which in the benchmark is
the work of its own closed loop of clients. Layer: the front door and scheduler
(``streaming/serve.py``, ``core/job.py``). Nothing is read from a program
that records no such spans."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    waits = [s.args["handoff_ms"] for s in spans if s.name == "serve.tick"]
    return sum(waits) / len(waits) if waits else None
