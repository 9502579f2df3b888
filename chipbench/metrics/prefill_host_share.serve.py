"""``prefill_host_share.serve``: the share of the traced ticks' prefills in
which the device waited on the host. Of each ``engine.prefill`` span of
the program, the host's part runs from its ``launch`` child's start to the
end of the model's own ``model.prefill`` inside it (the prompt's upload
and the enqueueing of the model's work), and the whole from there to the
end of its ``readback`` child (the host blocked on the first token,
``int(argmax)``); summed over the prefills. Whatever wraps the bundle's
prefill and waits there (with ``--trace 1`` the benchmark's own
``prefill_ms.serve`` synchronises inside it) counts as the host waiting
on the device, as ``readback`` does. Layer: the engine
(``serving/engine.py``). Nothing is read from a program that records no
such spans."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    host = whole = 0.0
    for p in spans:
        if p.name != "engine.prefill":
            continue
        kids = {s.name: s for s in spans
                if s.tid == p.tid and p.t0 <= s.t0 and s.t1 <= p.t1 and s is not p}
        if "launch" not in kids or "readback" not in kids:
            continue
        launch = kids["launch"]
        host += kids.get("model.prefill", launch).t1 - launch.t0
        whole += kids["readback"].t1 - launch.t0
    return 100.0 * host / whole if whole > 0 else None
