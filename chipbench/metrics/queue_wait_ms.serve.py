"""``queue_wait_ms.serve``: the mean wait of a request in the engine's
queue before its prefill starts, over the traced ticks' prefills: the
``queue_ms`` of the program's ``engine.prefill`` spans (prefill start less
``ServeEngine.submit``). Layer: the engine (``serving/engine.py``). Nothing
is read from a program that records no such spans."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    waits = [s.args["queue_ms"] for s in spans if s.name == "engine.prefill"]
    return sum(waits) / len(waits) if waits else None
