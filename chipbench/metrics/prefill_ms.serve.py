"""``prefill_ms.serve``: the mean span of the engine's prefill calls
(``ModelBundle.prefill`` as ``ServeEngine`` calls it, wrapped by the
benchmark and synchronised to the device), over the untraced ticks.
Layer: the engine (``serving/engine.py``)."""


def read(run):
    spans = [s for s, a in run.spans.spans.get("prefill", []) if not a.get("traced")]
    return 1e3 * sum(spans) / len(spans) if spans else None
