"""``feed_wait_ms.train``: the mean span of ``next()`` on the
double-buffered ``TrainPipeline``, per untraced window step: how long a
step waited for its batch. Layer: the train loop (``launch/train.py``,
``data/pipeline.py``)."""


def read(run):
    waits = [s for s, a in run.spans.spans.get("feed_wait", []) if not a.get("traced")]
    return 1e3 * sum(waits) / len(waits) if waits else None
