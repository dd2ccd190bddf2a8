"""The CBS decode with no host-device sync in its loop, on the CPU at tiny
widths.

No device scalar is built from a Python value inside a decode (each
``torch.tensor(x, device=cuda)`` or ``t[i] = x`` on a 0-dim view is a
host-device sync on the card): ``torch.tensor``, ``torch.as_tensor`` and a
number assigned through ``Tensor.__setitem__`` raise inside the fast CBS
search (every selection), the dense CBS and the masked softmax.
"""

from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch

from style_seqcvae_tpu_torch.decoding import cbs as dense_cbs
from style_seqcvae_tpu_torch.decoding import harness as harness_mod
from style_seqcvae_tpu_torch.decoding.cbs_fast import SELECTIONS, fsm_to_tables
from style_seqcvae_tpu_torch.decoding.fsm import pack_fsm
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    init_captioner,
    make_decode_context,
    make_optimized_step_fn,
)
from style_seqcvae_tpu_torch.models.updown_cell import init_cell_state
from style_seqcvae_tpu_torch.ops.masked import masked_softmax

torch.set_num_threads(1)

V, B, NZ, S, BEAM, T, NBOX, F, Z = 40, 2, 2, 4, 4, 5, 5, 12, 4
CFG = CaptionerConfig(vocab_size=V, image_feature_size=F, embedding_size=300, hidden_size=10,
                      attention_projection_size=6, z_space=Z, sentiment_vae=1,
                      simple_vae=False, max_caption_length=T, beam_size=BEAM)


def _dense_fsm(rng):
    """Two single-word constraints of two wordforms each over S = 4 states."""
    f = np.zeros((S, S, V), np.uint8)
    for s in range(S):
        f[s, s, :] = 1
    toks = rng.choice(np.arange(2, V), (2, 2), replace=False)
    for c in range(2):
        for s in range(S):
            if not s & (1 << c):
                for t in toks[c]:
                    f[s, s | (1 << c), t] = 1
                    f[s, s, t] = 0
    return f


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    harness = DecodeHarness(init_captioner(CFG, seed=3, device="cpu"), CFG, device="cpu")
    feats = rng.randn(B, NBOX, F).astype(np.float32)
    sentiment = rng.choice([-1.0, 1.0], (B, 1)).astype(np.float32)
    dense = [[_dense_fsm(rng) for _ in range(NZ)] for _ in range(B)]
    tables = [[fsm_to_tables(d) for d in ds] for ds in dense]
    noise = rng.randn(NZ, T, B, 1, 1, Z).astype(np.float32)
    return harness, feats, sentiment, tables, noise, dense


def _no_scalar(*args, **kwargs):
    raise AssertionError("a tensor built from a Python value inside the decode")


_setitem = torch.Tensor.__setitem__


def _setitem_of_tensors(self, index, value):
    if isinstance(value, (bool, int, float)):
        raise AssertionError("a Python number assigned into a tensor inside the decode")
    return _setitem(self, index, value)


@contextmanager
def _strict():
    with mock.patch.object(torch, "tensor", _no_scalar), \
            mock.patch.object(torch, "as_tensor", _no_scalar), \
            mock.patch.object(torch.Tensor, "__setitem__", _setitem_of_tensors):
        yield


@pytest.mark.parametrize("selection", SELECTIONS)
def test_the_cbs_decode_builds_no_device_scalar_from_a_python_value(case, selection,
                                                                    monkeypatch):
    harness, feats, sentiment, tables, noise, _ = case
    want = harness.decode_cbs(feats, sentiment, None, tables, 2, noise, NZ, selection=selection)
    search = harness_mod.constrained_beam_search_fast

    def strict_search(*args, **kwargs):
        with _strict():
            return search(*args, **kwargs)

    monkeypatch.setattr(harness_mod, "constrained_beam_search_fast", strict_search)
    got = harness.decode_cbs(feats, sentiment, None, tables, 2, noise, NZ, selection=selection)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_strict_patch_catches_the_patterns_it_looks_for():
    with _strict():
        with pytest.raises(AssertionError):
            torch.tensor(float("-inf"))
        with pytest.raises(AssertionError):
            torch.zeros(3)[0] = 0.0
        torch.zeros(3)[:2] = torch.ones(2)


def test_the_dense_cbs_builds_no_device_scalar_from_a_python_value(case):
    harness, feats, sentiment, _, noise, dense = case
    params = harness.params
    ctx = make_decode_context(params, CFG, torch.from_numpy(feats),
                              sentiment=torch.from_numpy(sentiment))
    packed = np.stack([pack_fsm(ds[0]) for ds in dense])
    rows = torch.from_numpy(noise[0].copy())                    # (T, B, 1, 1, z)

    def run():
        return dense_cbs.constrained_beam_search(
            make_optimized_step_fn(params, CFG, ctx), torch.full((B,), 1, dtype=torch.long),
            init_cell_state((B,), CFG.hidden_size, device=torch.device("cpu")), packed, rows,
            max_steps=T, beam_size=BEAM, per_node_beam_size=BEAM // 2, end_index=1)

    want = run()
    with _strict():
        got = run()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_masked_softmax_builds_no_device_scalar_from_a_python_value():
    logits = torch.randn(3, 7)
    mask = torch.rand(3, 7) > 0.4
    mask[2] = False
    want = masked_softmax(logits, mask)
    with _strict():
        got = masked_softmax(logits, mask)
    assert torch.equal(got, want)
    assert torch.equal(got[2], torch.zeros(7))
