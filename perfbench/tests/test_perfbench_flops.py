"""The operation counts against hand counts."""

import pbsmall  # noqa: F401  (puts the repository on the path)
import pytest

from perfbench import flops, spec
from perfbench.reference import dense, hybrid


def test_causal_attention_counts_the_kept_pairs():
    # S 3: 6 kept (query, key) pairs; QK^T and PV a pair: 2 x (2 D) flops a head
    cfg = {"n_heads": 2, "head_dim": 4}
    assert flops.attention_forward_flops(cfg, 1, 3) == 6 * 2 * (2 * 4) * 2
    assert flops.attention_forward_flops(cfg, 5, 3) == 5 * flops.attention_forward_flops(cfg, 1, 3)


def test_ssd_count_by_hand_at_one_chunk():
    # B 1, S = L = 2, H 1, P 1, N 1: one chunk of 2
    cfg = {"ssm_heads": 1, "d_inner": 1, "ssm_state": 1}
    L, H, P, N = 2, 1, 1, 1
    hand = (2 * L * L * N + 4 * L * L * H + 2 * H * L * L * P + L * H * P + 2 * L * H * P * N
            + 2 * H * P * N + 2 * L * N * H * P + L * H * P)
    assert flops.ssd_forward_flops(cfg, 1, 2) == hand
    # 130 tokens take three chunks of 64
    assert flops.ssd_forward_flops(cfg, 1, 130) == 3 * flops.ssd_forward_flops(cfg, 1, 64)


def test_stablelm_step_is_the_issue_s_75_7_tflop():
    cfg = spec.config("stablelm-1.6b")
    d, F, V, nl = 2048, 5632, 100352, 24
    assert dense.matrix_params(cfg) == nl * (4 * d * d + 3 * d * F) + d * V
    f = flops.train_step_flops(dense, cfg, 4, 2048)
    assert f["matmul"] == 6 * dense.matrix_params(cfg) * 8192
    assert f["attention"] == 3 * nl * 2 * 2 * 4 * 32 * 64 * 2048 * 2049 / 2
    assert f["ssd"] == 0
    assert f["total"] == pytest.approx(75.7e12, rel=1e-3)


def test_zamba2_counts_the_shared_block_at_each_application():
    cfg = spec.config("zamba2-2.7b")
    d, di, N, H = 2560, 5120, 64, 80
    mamba = d * (2 * di + 2 * N + H) + di * d
    shared = 2 * d * d + 4 * d * d + 3 * d * 10240
    assert hybrid.matrix_params(cfg) == 54 * mamba + 9 * shared + d * 32000
    f = flops.train_step_flops(hybrid, cfg, 4, 2048)
    assert f["attention"] == 3 * 9 * flops.attention_forward_flops(cfg, 4, 2048)
    assert f["ssd"] == 3 * 54 * flops.ssd_forward_flops(cfg, 4, 2048)
    assert 150e12 < f["total"] < 175e12
