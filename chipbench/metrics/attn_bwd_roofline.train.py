"""``attn_bwd_roofline.train``: the flash attention backward kernel's share
of its roofline in the traced steps. Each launch the port counted there
(``flash_attention_bwd``) is the backward of causal self-attention at the
step's shape: five products over the S(S+1)/2 live pairs, 10·hd operations
a pair and head (2.5 times ``counts.flash_flop_bytes``' forward); q, o and
dO read and dq written, k and v read and dk and dv written, in bf16, and
the log-sum-exp and D (f32, a row each) read. The time is the device time
of the kernels named ``attn_bwd*`` (D's pass, the main kernel, dq's
conversion). Nothing is read unless the launches are the layers times the
traced steps (a program without the kernel counts none). Layer: the
kernels (``kernels/flash_attention``, ``csrc/flash_attention.cu``)."""
from chipbench import counts
from chipbench.drivers.train import TRACED_STEPS


def attn_bwd_flop_bytes(B, H, K, S, hd):
    """(operations, bytes) of one causal self-attention backward over S
    positions, bf16 tensors and f32 row statistics."""
    flop = 10 * hd * B * H * (S * (S + 1) // 2)
    nbytes = 2 * hd * B * S * (4 * H + 4 * K) + 8 * B * H * S
    return flop, nbytes


def read(run):
    if run.trace is None or not run.peaks:
        return None
    sz, mix = run.config["sizes"], run.traffic
    n = run.traced["launches"].get("flash_attention_bwd", 0)
    if n != sz["num_layers"] * (TRACED_STEPS[1] - TRACED_STEPS[0]):
        return None
    secs, _ = run.trace.kernel_seconds(lambda k: k.startswith("attn_bwd"))
    if not secs:
        return None
    f, b = attn_bwd_flop_bytes(mix["batch"], sz["num_heads"], sz["num_kv_heads"],
                               mix["seq_len"], sz["head_dim"])
    return counts.roofline_pct(n * f, n * b, secs, run.peaks)
