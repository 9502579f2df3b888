"""The reader of ``decode_graph_share.serve`` on synthetic program spans:
the share of the traced window's ``engine.decode`` spans replayed from a
CUDA graph, and nothing from a program whose decode spans carry no
``graph`` arg."""
from types import SimpleNamespace

import pytest

from chipbench import registry

NAME = "decode_graph_share.serve"


@pytest.fixture
def profiled():
    from repro_torch.profile import spans as S

    S.PROFILED.clear()
    yield S
    S.PROFILED.clear()


def traced(t0=0.0, window_s=100.0):
    return SimpleNamespace(trace=SimpleNamespace(_t0=t0, window_s=window_s, busy_s=1.0))


def decodes(S, hows, start=10.0, **args):
    for i, how in enumerate(hows):
        t0 = start + 5.0 * i
        extra = {} if how is None else {"graph": how}
        S.PROFILED.add(S.Span("engine.decode", "program", t0, t0 + 4.0, 1,
                              {"live": 8, **extra, **args}))
        S.PROFILED.add(S.Span("launch", "program", t0, t0 + 1.0, 1, {}))


@pytest.mark.parametrize("hows,share", [(["replay"] * 4, 100.0),
                                        (["eager"] * 3, 0.0),
                                        (["eager", "capture", "replay", "replay"], 50.0)])
def test_the_share_of_replayed_decodes(profiled, hows, share):
    decodes(profiled, hows)
    assert registry.metric_reader(NAME)(traced()) == pytest.approx(share)


def test_only_the_traced_window_counts(profiled):
    decodes(profiled, ["eager", "capture"], start=1.0)
    decodes(profiled, ["replay"] * 3, start=20.0)
    assert registry.metric_reader(NAME)(traced(15.0, 50.0)) == pytest.approx(100.0)


def test_nothing_is_read_without_graph_args(profiled):
    decodes(profiled, [None, None])
    assert registry.metric_reader(NAME)(traced()) is None
    assert registry.metric_reader(NAME)(SimpleNamespace(trace=None)) is None
