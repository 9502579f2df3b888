"""The yardstick's arithmetic: operations and bytes of the work, from
shapes alone (the formulas of the port's smoke test, ``flash_flop`` and
``ssd_flop_bytes``, copied without their calls into the port), and a
roofline share against the published peaks.
"""
from __future__ import annotations


def flash_flop_bytes(B, H, K, S, hd, itemsize):
    """(operations, bytes) of one causal self-attention forward over S
    positions: Q·Kᵀ and P·V over the S(S+1)/2 live pairs (2 + 2 operations a
    pair and head dim); q, k, v read once, o written once."""
    flop = 4 * hd * B * H * (S * (S + 1) // 2)
    nbytes = itemsize * hd * B * S * (2 * H + 2 * K)
    return flop, nbytes


def ssd_flop_bytes(B, S, H, P, G, N, chunk, itemsize):
    """(operations, bytes) of the SSD scan: C·Bᵀ over the causal pairs of
    each (batch, chunk, group), the scores times x·Δ over the same pairs, C
    against the carried state and the state update, per head; x, B, C and
    y at ``itemsize``, Δ (f32) read once, A once a head, the final state
    (f32) written once."""
    nc, pairs = S // chunk, chunk * (chunk + 1) // 2
    flop = 2 * B * nc * (G * pairs * N + H * (pairs * P + 2 * chunk * N * P))
    nbytes = (2 * B * S * H * P * itemsize + 2 * B * S * G * N * itemsize + B * S * H * 4
              + H * 4 + B * H * P * N * 4)
    return flop, nbytes


def roofline_pct(flop, nbytes, seconds, peaks) -> float | None:
    """The least time the chip could take, the larger of operations over
    the peak rate and bytes over the memory rate, as a share (%) of the
    measured ``seconds``; None where there is no time or no peak."""
    if not seconds or seconds <= 0 or not peaks:
        return None
    bound = max(flop / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def matmul_params(config: dict) -> int:
    """Parameters that a token's forward multiplies by: the reference's
    leaves of two dimensions or more (the tied embedding counted once, as
    the head; the depthwise conv's kernel, one product a weight a token)."""
    import math

    from chipbench.registry import reference_module

    specs = reference_module(config).param_specs(config["sizes"])
    return sum(math.prod(s) for _, s, _, _ in specs if len(s) >= 2)


def train_step_flop(config: dict, batch: int, seq: int) -> float:
    """Model operations of one training step, forward and backward (no
    recompute counted): 6·N a token, plus the sequence mixer's own work
    (causal attention, or the SSD scan) three times its forward."""
    sz = config["sizes"]
    n = matmul_params(config)
    flop = 6 * n * batch * seq
    if config["family"] == "dense":
        f, _ = flash_flop_bytes(batch, sz["num_heads"], sz["num_kv_heads"], seq,
                                sz["head_dim"], 2)
        flop += 3 * sz["num_layers"] * f
    elif config["family"] == "ssm":
        di = sz["ssm_expand"] * sz["d_model"]
        f, _ = ssd_flop_bytes(batch, seq, di // sz["ssm_headdim"], sz["ssm_headdim"],
                              sz["ssm_groups"], sz["ssm_state"], sz["ssm_chunk"], 2)
        flop += 3 * sz["num_layers"] * f
    return float(flop)


def prefill_flop(config: dict, prompt: int) -> float:
    """Model operations of one prefill of ``prompt`` tokens: 2·N a token
    for the layers, the head at the last position only, and causal
    attention in every layer."""
    sz = config["sizes"]
    head = sz["vocab_size"] * sz["d_model"]
    flop = 2 * (matmul_params(config) - head) * prompt + 2 * head
    if config["family"] == "dense":
        f, _ = flash_flop_bytes(1, sz["num_heads"], sz["num_kv_heads"], prompt,
                                sz["head_dim"], 2)
        flop += sz["num_layers"] * f
    return float(flop)
