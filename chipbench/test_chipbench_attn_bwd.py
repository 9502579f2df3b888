"""``attn_bwd_roofline.train``'s reader on synthetic traced windows of the
OLMo training cell: it reads 32 counted launches (16 layers x 2 traced
steps) against the ``attn_bwd*`` kernels' device time, returns nothing on
31 launches or on an untraced run, and its share is its formula worked by
hand."""
from types import SimpleNamespace

import pytest

from chipbench import common, registry

CELL = "olmo-1b.train-8x2048"
NAME = "attn_bwd_roofline.train"


def _run(launches, ops):
    cell = registry.cell(CELL)
    trace = common.DeviceTrace()
    trace._t0, trace.window_s, trace.busy_s = 0.5, 2.0, 1.9
    trace.ops = ops
    return SimpleNamespace(trace=trace, peaks=common.PEAKS[0], config=cell.config,
                           traffic=cell.traffic, spans=common.Spans(),
                           traced={"launches": {"flash_attention": 64,
                                                "flash_attention_bwd": launches}})


OPS = {"attn_bwd_main": [0.024, 32], "attn_bwd_dot_do_o": [0.0028, 32],
       "attn_bwd_dq_convert": [0.0025, 32], "flash_fwd_wgmma": [0.02, 64],
       "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT": [0.1, 500]}


def test_the_cell_reads_it_and_the_formula_by_hand():
    assert NAME in {m["name"] for m in registry.cell(CELL).per_layer}
    got = registry.metric_reader(NAME)(_run(32, OPS))
    # OLMo-1B at 8 x 2048: B 8, H = K = 16, hd 128
    flop = 10 * 128 * 8 * 16 * (2048 * 2049 // 2)
    nbytes = 2 * 128 * 8 * 2048 * (4 * 16 + 4 * 16) + 8 * 8 * 16 * 2048
    bound = max(32 * flop / common.PEAKS[0]["bf16_flops"],
                32 * nbytes / common.PEAKS[0]["hbm_bytes_per_s"])
    assert got == pytest.approx(100 * bound / (0.024 + 0.0028 + 0.0025))
    assert 0 < got < 100


def test_nothing_is_read_without_every_launch_or_a_trace():
    assert registry.metric_reader(NAME)(_run(31, OPS)) is None
    assert registry.metric_reader(NAME)(_run(32, {"flash_fwd_wgmma": [0.02, 64]})) is None
    cell = registry.cell(CELL)
    out = common.Outcome(cell.config, cell.traffic, common.Spans(), 0.0)
    assert registry.metric_reader(NAME)(out) is None
    parent = _run(32, OPS)
    del parent.traced["launches"]["flash_attention_bwd"]  # a program without the kernel
    assert registry.metric_reader(NAME)(parent) is None
