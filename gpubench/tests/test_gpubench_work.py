"""The work counts against bytes and flops computed by hand at both
configurations' shapes."""

import pytest

from gpubench import work
from gpubench.run import HERE, load_json

Q3K = 110 / 256                      # bytes a Q3_K weight
FP8 = 1 + 4 / (128 * 128)            # bytes an F8E5M2 weight with its block scale


def test_v3_decode_step_by_hand():
    sh = work.Shapes.of(load_json(HERE, "configs", "deepseek-v3-q3k-8l.json"))
    attn = 576 * 7168 + 7168 * 16384 + 1536 * 7168 + 65536 * 1536 + 8192 * 1536 + 16384 * 512
    dense = 3 * 18432 * 7168
    expert = 3 * 2048 * 7168                         # one routed expert, as the shared one
    router = 256 * 7168
    assert (sh.attn[0], sh.dense[0], sh.dense[3], sh.expert) == (attn, dense, expert, expert)
    w_all = 8 * attn + 3 * dense + 5 * expert
    # 3 rows at attended lengths 10, 20, 70; 8, 9, 10, 11, 12 distinct experts
    f, b = work.step_work(sh, 3, 100, 100, [8, 9, 10, 11, 12], 3)
    flops = (2 * 3 * (w_all + 5 * 8 * expert) + 2 * 3 * 5 * router
             + 8 * 100 * 2 * 128 * (576 + 512) + 2 * 3 * 129280 * 7168)
    byts = (Q3K * (w_all + 50 * expert) + 4 * 5 * router + 8 * 100 * 576 * 2
            + 3 * 7168 * Q3K + Q3K * 129280 * 7168)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == pytest.approx(byts, rel=1e-12)
    assert work.least_seconds(f, b) == pytest.approx(byts / 3.35e12)


def test_v2_lite_prefill_chunk_by_hand():
    sh = work.Shapes.of(load_json(HERE, "configs", "deepseek-v2-lite-fp8.json"))
    attn = 576 * 2048 + 2048 * 2048 + 3072 * 2048 + 4096 * 512
    dense0, shared = 3 * 10944 * 2048, 3 * 2816 * 2048
    expert, router = 3 * 1408 * 2048, 64 * 2048
    assert (sh.attn[5], sh.dense[0], sh.dense[1], sh.expert) == (attn, dense0, shared, expert)
    w_all = 27 * attn + dense0 + 26 * shared
    pairs = 256 * 256 + 256 * 257 // 2              # a chunk of 256 at position 256
    f, b = work.step_work(sh, 256, 512, pairs, [64] * 26, 256)
    flops = (2 * 256 * (w_all + 26 * 6 * expert) + 2 * 256 * 26 * router
             + 27 * pairs * 2 * 16 * (192 + 128) + 2 * 256 * 102400 * 2048)
    byts = (FP8 * (w_all + 26 * 64 * expert) + 4 * 26 * router + 27 * 512 * 16 * 320 * 2
            + 256 * 2048 * FP8 + FP8 * 102400 * 2048)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == pytest.approx(byts, rel=1e-12)


def test_no_work_no_time():
    sh = work.Shapes.of(load_json(HERE, "configs", "deepseek-v2-lite-fp8.json"))
    assert work.step_work(sh, 0, 0, 0, [], 0) == (0.0, 0.0)
