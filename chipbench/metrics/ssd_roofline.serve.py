"""``ssd_roofline.serve``: the SSD scan's share of its roofline in the
traced ticks' prefills. Each traced prefill launches the scan once a
Mamba-2 layer at the prompt's length (``counts.ssd_flop_bytes``, bf16
inputs, batch 1); the time is the device time of the kernels named
``ssd_*`` (decode steps the state without the scan). Nothing is read
unless the port counted as many ``ssd_scan`` launches as the traced
prefills have Mamba-2 layers. Layer: the kernels (``kernels/ssd_scan``,
``csrc/ssd_scan.cu``)."""
from chipbench import counts


def read(run):
    if run.trace is None or not run.peaks:
        return None
    sz = run.config["sizes"]
    pattern = sz["layer_pattern"]
    mamba = pattern.count("M") * sz["num_layers"] // len(pattern)
    lens = [a["tokens"] for _, a in run.spans.spans.get("prefill", []) if a.get("traced")]
    if not lens or run.traced["launches"].get("ssd_scan") != mamba * len(lens):
        return None
    secs, _ = run.trace.kernel_seconds(lambda k: k.startswith("ssd_"))
    di = sz["ssm_expand"] * sz["d_model"]
    flop = nbytes = 0
    for n in lens:
        f, b = counts.ssd_flop_bytes(1, n, di // sz["ssm_headdim"], sz["ssm_headdim"],
                                     sz["ssm_groups"], sz["ssm_state"], sz["ssm_chunk"], 2)
        flop += mamba * f
        nbytes += mamba * b
    return counts.roofline_pct(flop, nbytes, secs, run.peaks)
