"""``backward_share.train``: the share of the traced training steps' device
time spent in the backward: the device milliseconds between the CUDA events
of the program's ``train.backward`` spans over those of its ``train.step``
spans, summed over the steps. Layer: the model step (``launch/train.py``,
``models/model_zoo.py``, ``optim/adamw.py``). Nothing is read from a
program that records no such spans."""


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    spans = PROFILED.between(t._t0, t._t0 + t.window_s) if t and t.window_s else []
    ms = {"train.backward": 0.0, "train.step": 0.0}
    for s in spans:
        if s.name in ms and s.device_ms is not None:
            ms[s.name] += s.device_ms
    return 100.0 * ms["train.backward"] / ms["train.step"] if ms["train.step"] > 0 else None
