"""The frozen counters of work against hand counts."""

import pytest

from harness import work


def test_vit_b16_image_flops():
    n, w = 197, 768
    per_layer = (2 * n * w * 3 * w + 2 * 2 * n * n * w + 2 * n * w * w
                 + 2 * 2 * n * w * 4 * w)
    assert per_layer == 2_907_909_120
    want = 2 * 196 * 768 * 768 + 12 * per_layer + 2 * 768 * 512
    assert want == 35_126_906_880
    assert work.vit_image_flops(224, 16, 768, 12, 512) == want


def test_k4b_bytes_at_a_vit_b16_batch():
    # q, k, v [512, 197, 3 x 768] bf16 read once, [512, 197, 768] written
    assert work.attention_bytes(512, 197, 768) == 619_708_416
    assert work.attention_bytes(512, 197, 768) / work.PEAK_BYTES_PER_S \
        == pytest.approx(0.18499e-3, rel=1e-4)


def test_auction_bytes_at_the_zero_shot_batch():
    # values [100, 75, 1000] fp32 read once, col4row [100, 75] int32 written
    assert work.auction_bytes(100, 75, 1000) == 30_030_000
    assert work.auction_bytes(100, 75, 1000) / work.PEAK_BYTES_PER_S \
        == pytest.approx(8.964e-6, rel=1e-3)


def test_task_batch_bounds():
    # zero-shot: one E-step, 2 x 100 x 75 x 1000 x 1000, bounds the batch
    assert work.em_step_flops(100, 75, 1000) == 15_000_000_000
    assert work.task_batch_bytes(100, 75, 1000) == 30_060_400
    assert work.task_batch_bound_s(100, 75, 1000) == pytest.approx(
        15e9 / 67e12)
    # 4-shot: the 4000 support rows read once bound it
    assert work.task_batch_bytes(100, 75, 1000, 4000) == 1_630_060_400
    assert work.task_batch_bound_s(100, 75, 1000, 4000) == pytest.approx(
        1_630_060_400 / 3.35e12)
