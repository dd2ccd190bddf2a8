"""The operation and byte counters against counts made by hand."""

import pytest

from benchmark import flops, peaks

CFG = dict(vocab_size=10, embedding_size=3, hidden_size=2, image_feature_size=4,
           attention_projection_size=5, z_space=6, max_caption_length=3, beam_size=2,
           sentiment_vae=1, simple_vae=False)


def test_cbs_decode_flops_by_hand():
    images, boxes, n_z, states, exc = 2, 7, 3, 4, 5
    # once: token table 2·10·3·8, per image (4 + 1 sentiment)·8·2 and the
    # projected boxes 2·7·4·5
    once = 2 * 10 * 3 * 8 + 2 * (2 * 5 * 8 + 2 * 7 * 4 * 5)
    # a row: attention LSTM 2·6·8, query 2·2·5, scores 2·7·5, attended
    # 2·7·4, decoder LSTM 2·(4 + 6 + 6)·8, projection 2·2·3, logits 2·3·10
    row = 2 * 6 * 8 + 2 * 2 * 5 + 2 * 7 * 5 + 2 * 7 * 4 + 2 * 16 * 8 + 2 * 2 * 3 + 2 * 3 * 10
    want = once + 6 * row + 2 * 48 * (row + 2 * 3 * 5)
    assert flops.cbs_decode_flops(CFG, images, boxes, n_z, states, exc) == want


def test_topk_lse_call_by_hand():
    got = flops.topk_lse_call(rows=4, vocab=10, width=3, k=2, dtype="bfloat16")
    assert got == {"ops": 2 * 4 * 10 * 3, "bytes": 2 * (4 + 10) * 3 + 4 * (2 * 4 + 2 * 4 + 4)}
    f32 = flops.topk_lse_call(rows=4, vocab=10, width=3, k=2, dtype="float32")
    assert f32["bytes"] == 4 * (4 + 10) * 3 + 4 * 20


def test_bound_is_the_longer_of_the_two():
    assert peaks.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 3.35e12 / 2, "float32") == pytest.approx(1.0)
