"""``decode_graph_share.serve``: the share of the traced ticks' batched
decodes that the engine replayed from a CUDA graph: of the program's
``engine.decode`` spans in the window that say how their decode ran (the
span's ``graph`` arg: ``"eager"``, ``"capture"`` or ``"replay"``), those
that say ``"replay"``. Layer: the engine (``serving/engine.py``). Nothing
is read from a program whose decode spans say nothing of a graph."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    how = [s.args["graph"] for s in spans if s.name == "engine.decode" and "graph" in s.args]
    return 100.0 * how.count("replay") / len(how) if how else None
