"""``flash_roofline.serve``: the flash attention forward's share of its
roofline in the traced ticks' prefills. The work is causal attention at
each traced prefill's shape in every layer (``counts.flash_flop_bytes``,
bf16), whatever implements it; the time is the device time of the kernels
named ``flash*`` in the trace. Nothing is read unless the port counted as
many flash launches as the traced prefills have layers. Layer: the kernels
(``kernels/flash_attention``, ``csrc/flash_attention.cu``)."""
from chipbench import counts


def read(run):
    if run.trace is None or not run.peaks:
        return None
    sz = run.config["sizes"]
    lens = [a["tokens"] for _, a in run.spans.spans.get("prefill", []) if a.get("traced")]
    if not lens or run.traced["launches"].get("flash_attention") != sz["num_layers"] * len(lens):
        return None
    secs, _ = run.trace.kernel_seconds(lambda k: k.startswith("flash"))
    flop = nbytes = 0
    for n in lens:
        f, b = counts.flash_flop_bytes(1, sz["num_heads"], sz["num_kv_heads"], n,
                                       sz["head_dim"], 2)
        flop += sz["num_layers"] * f
        nbytes += sz["num_layers"] * b
    return counts.roofline_pct(flop, nbytes, secs, run.peaks)
