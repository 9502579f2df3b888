"""``tick_ms.serve``: the mean host-clock span of a front-door tick,
``ServeFrontDoor.tick_async().result()`` (the engine's admission and
prefills, one batched decode, and the argmax read back to the host, so the
span ends with the device's work), over the window's untraced ticks.
Layer: the front door and scheduler (``streaming/serve.py``,
``core/job.py``)."""


def read(run):
    ticks = [s for s, a in run.spans.spans.get("tick", []) if not a.get("traced")]
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
