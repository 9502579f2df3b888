"""``ssd_roofline.train``: the SSD scan's share of its roofline in the
traced steps: each ``ssd_scan`` launch the port counted there is the scan
at the step's shape (``counts.ssd_flop_bytes``, bf16 inputs), against the
device time of the kernels named ``ssd_*``. Layer: the kernels
(``kernels/ssd_scan``, ``csrc/ssd_scan.cu``)."""
from chipbench import counts


def read(run):
    if run.trace is None or not run.peaks:
        return None
    n = run.traced["launches"].get("ssd_scan", 0)
    secs, _ = run.trace.kernel_seconds(lambda k: k.startswith("ssd_"))
    if not n or not secs:
        return None
    sz, mix = run.config["sizes"], run.traffic
    di = sz["ssm_expand"] * sz["d_model"]
    f, b = counts.ssd_flop_bytes(mix["batch"], mix["seq_len"], di // sz["ssm_headdim"],
                                 sz["ssm_headdim"], sz["ssm_groups"], sz["ssm_state"],
                                 sz["ssm_chunk"], 2)
    return counts.roofline_pct(n * f, n * b, secs, run.peaks)
