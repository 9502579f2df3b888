"""``prefill_mfu.serve``: the model operations of the window's prefills
(2·N a prompt token for the layers, the head at the last position, causal
attention in every layer: ``counts.prefill_flop``) over their time, as a
share of the card's bf16 peak. Layer: the model step
(``models/transformer.py``, ``attention.py``, ``layers.py``)."""
from chipbench import counts


def read(run):
    spans = [(s, a["tokens"]) for s, a in run.spans.spans.get("prefill", [])
             if not a.get("traced")]
    secs = sum(s for s, _ in spans)
    if not spans or not run.peaks or secs <= 0:
        return None
    flop = sum(counts.prefill_flop(run.config, n) for _, n in spans)
    return 100.0 * flop / secs / run.peaks["bf16_flops"]
