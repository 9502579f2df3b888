"""``decode_host_share.serve``: the share of the traced ticks' batched
decodes in which the device waited on the host. Of each ``engine.decode``
span of the program, the host's part is its ``launch`` child (the tokens'
upload and the enqueueing of ``decode_step``'s work), and the whole runs
from there to the end of its ``readback`` child (the host blocked on the
next tokens, ``argmax(...).cpu()``); summed over the decodes. Layer: the
engine (``serving/engine.py``). Nothing is read from a program that
records no such spans."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    host = whole = 0.0
    for p in spans:
        if p.name != "engine.decode":
            continue
        kids = {s.name: s for s in spans
                if s.tid == p.tid and p.t0 <= s.t0 and s.t1 <= p.t1 and s is not p}
        if "launch" not in kids or "readback" not in kids:
            continue
        host += kids["launch"].dur
        whole += kids["readback"].t1 - kids["launch"].t0
    return 100.0 * host / whole if whole > 0 else None
