"""The yardstick's counts against cases worked by hand, and the traffic
generator's fixed sizes."""
import numpy as np
import pytest

from chipbench import counts, registry, traffic


def test_flash_counts_by_hand():
    # B 1, H 2, K 1, S 3, hd 4: 6 live pairs, 4 * 4 operations a pair a head
    flop, nbytes = counts.flash_flop_bytes(1, 2, 1, 3, 4, 2)
    assert flop == 4 * 4 * 2 * 6
    assert nbytes == 2 * 4 * (2 * 2 * 3 + 2 * 1 * 3)  # q and o of 2 heads, k and v of 1


def test_ssd_counts_by_hand():
    # B 1, S 4, H 2, P 3, G 1, N 5, chunk 2: two chunks of 3 causal pairs
    flop, nbytes = counts.ssd_flop_bytes(1, 4, 2, 3, 1, 5, 2, 2)
    assert flop == 2 * 1 * 2 * (1 * 3 * 5 + 2 * (3 * 3 + 2 * 2 * 5 * 3))
    assert nbytes == 2 * 4 * 2 * 3 * 2 + 2 * 4 * 1 * 5 * 2 + 4 * 2 * 4 + 2 * 4 + 2 * 3 * 5 * 4


def test_roofline_share():
    peaks = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    assert counts.roofline_pct(1e12, 1e6, 2.0, peaks) == pytest.approx(50.0)
    assert counts.roofline_pct(1.0, 4e9, 8.0, peaks) == pytest.approx(50.0)
    assert counts.roofline_pct(1.0, 1.0, 0.0, peaks) is None


def test_model_operations():
    olmo = registry.cell("olmo-1b.train-8x2048").config
    n = counts.matmul_params(olmo)
    assert n == 1_176_764_416  # OLMo-1B: 16 x 7 matrices and the tied 50304 x 2048 head
    attn = 3 * 16 * 4 * 128 * 8 * 16 * (2048 * 2049 // 2)
    assert counts.train_step_flop(olmo, 8, 2048) == 6 * n * 8 * 2048 + attn
    head = 50304 * 2048
    assert counts.prefill_flop(olmo, 10) == (2 * (n - head) * 10 + 2 * head
                                             + 16 * 4 * 128 * 16 * 55)


def test_lengths_fixed_and_orders_seeded():
    mix = registry.cell("olmo-1b.serve-chat-128").traffic
    a, b = traffic.requests(mix, 1, 50304), traffic.requests(mix, 2**31 + 7, 50304)
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert [n for _, n in a] == [n for _, n in b]
    assert [len(p) for p, _ in a] == [len(p) for p, _ in b]
    assert any((p != q).any() for (p, _), (q, _) in zip(a, b))
    assert all(128 <= len(p) <= 1792 and 2 <= n <= 256 for p, n in a)
    assert all(len(p) + n <= mix["cache_len"] for p, n in a)
    tmix = registry.cell("olmo-1b.train-8x2048").traffic
    d1, d2 = traffic.documents(tmix, 3, 50304), traffic.documents(tmix, 4, 50304)
    assert sorted(map(len, d1)) == sorted(map(len, d2))
    assert min(int(d.min()) for d in d1) >= 259
    assert sum(len(d) + 2 for d in d1) >= tmix["rows"] * (tmix["seq_len"] + 1)
    assert np.median([len(d) for d in d1]) == pytest.approx(600, rel=0.02)
