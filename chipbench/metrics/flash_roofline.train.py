"""``flash_roofline.train``: the flash attention forward's share of its
roofline in the traced steps: each launch the port counted there is
causal attention at the step's shape (``counts.flash_flop_bytes``, bf16),
against the device time of the kernels named ``flash*``. Layer: the
kernels (``kernels/flash_attention``, ``csrc/flash_attention.cu``)."""
from chipbench import counts


def read(run):
    if run.trace is None or not run.peaks:
        return None
    n = run.traced["launches"].get("flash_attention", 0)
    secs, _ = run.trace.kernel_seconds(lambda k: k.startswith("flash"))
    if not n or not secs:
        return None
    sz, mix = run.config["sizes"], run.traffic
    f, b = counts.flash_flop_bytes(mix["batch"], sz["num_heads"], sz["num_kv_heads"],
                                   mix["seq_len"], sz["head_dim"], 2)
    return counts.roofline_pct(n * f, n * b, secs, run.peaks)
