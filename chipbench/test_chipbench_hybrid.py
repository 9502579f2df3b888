"""The Granite-4.0-H-Small cell at a reduced size that keeps one whole
period (9 Mamba-2 layers and 1 attention layer) and 8 experts with k = 3,
every width cut (``conftest.tiny_cell`` cuts no heads or experts of a
non-dense family, so this file cuts its own): the reference
(``reference/hybrid.py``) against the port's prefill and decode through its
cache and its loss, the harness's run of the cell on the CPU, the fp8
control, and the two new readers."""
import copy

import numpy as np
import pytest
import torch

from chipbench import calibrate, common, harness, program, registry, weights
from chipbench.moe_counts import moe_flop_bytes

NAME = "granite-4.0-h-small.serve-chat-128"
READERS = ("moe_roofline.serve", "ssd_roofline.serve")
#: the port's plain path against the reference, both in f32 (the SSD's
#: chunked scan and the MoE's grouped sums add in other orders, some 1e-6
#: of the norm apart), as a relative L2 distance per row: the logits are
#: divided by 16 and the embedding drawn at 0.02/12, so an absolute
#: tolerance sized for unit logits would pass a wrong branch
REL_L2 = 1e-5
#: the tiny cell's limits: its logits are divided by 16 and its embedding
#: drawn at 0.02/12, so the others' ``max_gap`` does not carry over. At
#: this width bf16 (up to 6.9e-4 over fifteen seeds on the CPU) and the fp8
#: control (from 6.3e-4) overlap, so the harness runs the tiny cell in f32
#: here, which reads under 1e-5; the card's bf16 cell has its own limits
TINY_LIMITS = {"length_mismatch": 0, "max_gap": 4e-4}


def tiny_granite(dtype="bfloat16"):
    c = registry.cell(NAME)
    conf, mix = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    sz = conf["sizes"]
    sz.update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, num_experts=8,
              experts_per_token=3, moe_shared_ff=48, vocab_size=512, ssm_state=16,
              ssm_headdim=16, ssm_chunk=16, param_dtype=dtype)
    conf["program"] = dict(conf["program"], **{k: v for k, v in sz.items()
                                               if k not in ("dt_min", "dt_max")})
    mix.update(clients=4, slots=4, cache_len=128, requests=64,
               prompt=dict(mix["prompt"], median=32, min=16, max=96),
               output=dict(mix["output"], median=8, min=4, max=24),
               check=dict(min_tokens=30, max_requests=4), min_retired=8)
    c.config, c.traffic, c.limits = conf, mix, dict(TINY_LIMITS)
    return c


def _model(cell, seed=11):
    from repro_torch.models import build_model

    conf = cell.config
    ref = registry.reference_module(conf)
    w = weights.make(ref.param_specs(conf["sizes"]), seed, "cpu")
    cfg = program.config(conf)
    return ref, w, cfg, build_model(cfg), program.model(cfg, {k: v.clone()
                                                               for k, v in w.items()})


def test_the_cell_is_found_by_name_at_the_published_widths():
    cell = registry.cell(NAME)
    sz = cell.config["sizes"]
    assert cell.config["reference"] == "hybrid" and cell.chips == 1
    assert (sz["num_layers"], sz["d_model"], sz["num_experts"], sz["experts_per_token"],
            sz["d_ff"], sz["moe_shared_ff"], sz["vocab_size"]) == (10, 4096, 72, 10, 768,
                                                                  1536, 100352)
    assert cell.config["num_hidden_layers"] == 10 and cell.config["published"] == {
        "num_hidden_layers": 40}
    assert cell.config["layer_types"][:10] == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    assert {m["name"] for m in cell.per_layer} >= set(READERS)
    assert not {"prefill_mfu.serve", "flash_roofline.serve"} & {m["name"]
                                                                 for m in cell.per_layer}
    cfg = program.config(cell.config)
    assert cfg.num_layers == 10 and cfg.moe_dropless and cfg.attn_impl == "flash"


def test_reference_names_every_leaf_of_the_port_at_full_width():
    from repro_torch.models.model_zoo import build_module

    cell = registry.cell(NAME)
    specs = registry.reference_module(cell.config).param_specs(cell.config["sizes"])
    have = {k: (tuple(p.shape), str(p.dtype).split(".")[-1])
            for k, p in build_module(program.config(cell.config), "meta").named_parameters()}
    assert have == {n: (tuple(s), dt) for n, s, dt, _ in specs}
    assert sum(np.prod(s) for _, s, _, _ in specs) == 8_360_118_912


def _rel_l2(got, want):
    """Each row's ``|got - want| / |want|``."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).tolist()


def test_prefill_and_decode_through_the_cache_match_the_full_forward():
    """The bundle's prefill gives a prompt-sized cache, which the engine
    splices into its slab; here the same prompt is laid into a slab of 64
    positions the same way (``engine._splice``). The engine's slab is bf16
    whatever the model's dtype, which moves the decoded logits by some 3e-3
    of their norm; this slab is the model's f32, so each decoded row is held
    to the full forward as tightly as the prefill's."""
    from repro_torch.models.hybrid import make_hybrid_cache
    from repro_torch.serving.engine import _splice

    ref, w, cfg, bundle, model = _model(tiny_granite("float32"))
    sz = tiny_granite("float32").config["sizes"]
    prompt = torch.arange(300, 340)[None]
    logits, cache1 = bundle.prefill(model, tokens=prompt)
    cache = _splice(make_hybrid_cache(cfg, 1, 64, torch.float32, "cpu"), cache1, 0, 64)
    seq, steps = [logits[0]], [int(logits[0].argmax())]
    for _ in range(6):
        logits, cache = bundle.decode_step(model, cache, torch.tensor([[steps[-1]]]))
        seq.append(logits[0])
        steps.append(int(logits[0].argmax()))
    full = torch.cat([prompt[0], torch.tensor(steps[:-1])])[None]
    want = ref.logits(w, full, sz, start=prompt.shape[1] - 1)
    assert max(_rel_l2(torch.stack(seq), want)) <= REL_L2


def test_loss_matches_the_port():
    """The final hidden state against the reference's, and the loss with the
    logits scaled up to unit size (``logits_scaling`` 1/64 on both sides:
    at the cell's 16 a wrong hidden state moves the loss by under 1e-6)."""
    from repro_torch.models import hybrid
    from repro_torch.models.layers import lm_loss
    from repro_torch.models.transformer import head_matrix

    cell = tiny_granite("float32")
    for part in ("sizes", "program"):
        cell.config[part]["logits_scaling"] = 1 / 64
    ref, w, cfg, bundle, model = _model(cell)
    sz = cell.config["sizes"]
    g = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(g.integers(0, 512, (2, 37))),
             "labels": torch.as_tensor(g.integers(-1, 512, (2, 37)))}
    with torch.no_grad():
        h, _aux = hybrid.hybrid_forward(model, batch["tokens"], cfg)
        assert max(_rel_l2(h.flatten(0, 1), ref.hidden(w, batch["tokens"], sz).flatten(0, 1))) \
            <= REL_L2
        head = head_matrix(model, cfg) / cfg.logits_scaling
        assert float((h @ head).std()) > 0.3  # the loss sees the hidden state
        port = lm_loss(h, head, batch["labels"])
        want = ref.train_loss(w, batch, sz)
    assert float(port) == pytest.approx(float(want), rel=1e-5)


def test_the_harness_serves_the_cell_on_the_cpu_and_reads_no_device_metric():
    res = harness.run_cell(tiny_granite("float32"), 2**31 + 21, 0.5, True, "cpu", common.now())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["checks"]["length_mismatch"]["value"] == 0
    assert not set(res["metrics"]) & set(READERS)
    assert {"tick_ms.serve", "prefill_ms.serve"} <= set(res["metrics"])


def test_serve_control_fails_where_the_program_passes():
    cell, got = tiny_granite("float32"), {}
    calibrate.serve_readings(cell, 7, "cpu", True, 0.5,
                             lambda kind, seed, numbers: got.__setitem__(kind, numbers))
    assert got["program"]["max_gap"] <= cell.limits["max_gap"] < got["control"]["max_gap"]


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_on_an_untraced_run(name):
    out = common.Outcome(tiny_granite().config, tiny_granite().traffic, common.Spans(), 0.0)
    assert registry.metric_reader(name)(out) is None


def test_the_hybrid_reference_loads_nothing_of_the_port():
    from chipbench.test_chipbench_imports import loaded

    tops = loaded("import json, sys\nimport chipbench.reference.hybrid\n"
                  "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "torch" in tops
    assert not tops & ({"repro_torch"} | set(common.FORBIDDEN_MODULES))


def test_moe_counts_by_hand():
    f, b = moe_flop_bytes(4096, 768, 1280, 72, 2)
    assert f == 6 * 4096 * 768 * 1280
    assert b == 72 * 3 * 4096 * 768 * 2 + 1280 * 2 * 4096 * 2


GEMM = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel1"
        "3GemmUniversalINS5_17GroupProblem")


def test_roofline_readers_on_a_synthetic_traced_window():
    """One traced prefill of 300 tokens and one decode of 4 slots: 10
    ``moe.experts`` spans each, the grouped GEMM's kernels and the SSD's in
    the trace; the shares are the work's bound over those kernels' time."""
    from types import SimpleNamespace

    from repro_torch.profile import spans as S

    from chipbench import counts

    cell = registry.cell(NAME)
    sz = cell.config["sizes"]
    peaks = common.PEAKS[0]
    S.PROFILED.clear()
    try:
        for name, t0, tokens in (("engine.prefill", 1.0, 300), ("engine.decode", 3.0, 4)):
            S.PROFILED.add(S.Span(name, "program", t0, t0 + 1.0, 1, {}))
            for i in range(10):
                S.PROFILED.add(S.Span("moe.experts", "program", t0 + 0.05 * (i + 1),
                                      t0 + 0.05 * (i + 1.5), 1,
                                      {"tokens": tokens, "assignments": 10 * tokens,
                                       "experts_hit": 72 if tokens > 4 else 30}))
        trace = common.DeviceTrace()
        trace._t0, trace.window_s, trace.busy_s = 0.5, 4.0, 1.0
        trace.ops = {GEMM: [0.006, 60], "prepare_grouped_gemm_data": [0.0001, 60],
                     "ssd_chunk_scan": [0.002, 9], "ssd_cb": [0.0005, 9], "nvjet": [1.0, 9]}
        spans = common.Spans()
        spans.add("prefill", 0.04, tokens=300, traced=True)
        run = SimpleNamespace(trace=trace, peaks=peaks, config=cell.config, spans=spans,
                              traced={"launches": {"moe_experts": 20, "ssd_scan": 9}})
        f = b = 0
        for n, hit in ((300, 72), (4, 30)):
            fn, bn = moe_flop_bytes(4096, 768, 10 * n, hit, 2)
            f, b = f + 10 * fn, b + 10 * bn
        moe = registry.metric_reader("moe_roofline.serve")(run)
        assert moe == pytest.approx(counts.roofline_pct(f, b, 0.0061, peaks))
        fs, bs = counts.ssd_flop_bytes(1, 300, 128, 64, 1, 128, 256, 2)
        ssd = registry.metric_reader("ssd_roofline.serve")(run)
        assert ssd == pytest.approx(counts.roofline_pct(9 * fs, 9 * bs, 0.0025, peaks))
        assert 0 < moe < 100 and 0 < ssd < 100
        run.traced["launches"]["moe_experts"] = 19  # a call not counted: nothing read
        run.traced["launches"]["ssd_scan"] = 8
        assert registry.metric_reader("moe_roofline.serve")(run) is None
        assert registry.metric_reader("ssd_roofline.serve")(run) is None
    finally:
        S.PROFILED.clear()
