"""``step_mfu.train``: one step's model operations (6·N a token, plus the
sequence mixer's own work, causal attention or the SSD scan, three times
its forward; no recompute counted: ``counts.train_step_flop``) over the
mean untraced window step, as a share of the card's bf16 peak. Layer: the
model step (``models/*``, ``optim/adamw.py``)."""
from chipbench import counts


def read(run):
    steps = [s for s, a in run.spans.spans.get("step", []) if not a.get("traced")]
    if not steps or not run.peaks:
        return None
    mix = run.traffic
    flop = counts.train_step_flop(run.config, mix["batch"], mix["seq_len"])
    return 100.0 * flop / (sum(steps) / len(steps)) / run.peaks["bf16_flops"]
