"""The BUTD attention wrapper (``ops/kernels/butd_attention.py``) on the CPU:
its plain version against the JAX package's ``attention_weights``, the
routing of ``models/attention.py::attention_weights`` (the plain version
under a gradient, the wrapper otherwise) and the wrapper's checks. The CUDA
kernel itself is held to the plain version in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.models import attention as jatt
from style_seqcvae_tpu_torch.models import attention as tatt
from style_seqcvae_tpu_torch.ops.kernels import butd_attention as katt

torch.set_num_threads(1)

B, H = 3, 24
# inner grid dims between the batch and H: none (one row an image), and
# (z-samples, FSM states, beam) as the CBS decode's step has them
GRIDS = {"rows": (), "z_states_beam": (2, 4, 3)}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# f32: the same operations on both sides, sums of P terms and of N
# exponentials in another order: measured at most 4.5e-8 over these cases,
# held to 5e-7. bf16: each op rounds to bf16 on both sides; measured equal
# to the bit over these cases, held within one bf16 ulp of a weight of 1/4.
TOL = {"f32": 5e-7, "bf16": 2.0 ** -10}


def _inputs(dtype: str, grid, N: int, P: int, seed: int):
    """Query, parameters, projected boxes and a ragged mask: image 0 keeps a
    random subset of its boxes (at least one), image 1 a prefix, image 2
    none (a fully masked image, whose rows give zeros)."""
    rng = np.random.RandomState(seed)
    wq = rng.uniform(-1, 1, (H, P)) / np.sqrt(H)
    wi = rng.uniform(-1, 1, (P, P)) / np.sqrt(P)
    wa = rng.uniform(-1, 1, P) / np.sqrt(P)
    query = rng.uniform(-1, 1, (B,) + grid + (H,))
    pv = 0.6 * rng.randn(B, N, P)
    mask = np.zeros((B, N), bool)
    mask[0] = rng.rand(N) < 0.7
    mask[0, rng.randint(N)] = True
    mask[1, :rng.randint(1, N + 1)] = True
    tdt, jdt = DTYPES[dtype]
    jp = jatt.AttentionParams(*(jnp.asarray(a, jdt) for a in (wq, wi, wa)))
    tp = tatt.AttentionParams(*(torch.from_numpy(np.asarray(jnp.asarray(a, jdt).astype(
        jnp.float32))).to(tdt) for a in (wq, wi, wa)))
    jq, jpv = jnp.asarray(query, jdt), jnp.asarray(pv, jdt)
    tq = torch.from_numpy(np.asarray(jq.astype(jnp.float32))).to(tdt)
    tpv = torch.from_numpy(np.asarray(jpv.astype(jnp.float32))).to(tdt)
    return (jp, jq, jpv, jnp.asarray(mask)), (tp, tq, tpv, torch.from_numpy(mask))


@pytest.mark.parametrize("P", [768, 100])
@pytest.mark.parametrize("N", [100, 37, 1])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax(dtype, grid, N, P):
    (jp, jq, jpv, jmask), (tp, tq, tpv, tmask) = _inputs(dtype, GRIDS[grid], N, P, seed=N + P)
    want = jatt.attention_weights(jp, jq, jpv, jmask)
    proj = torch.matmul(tq, tp.w_query)
    got = katt.butd_attention_plain(proj.reshape(-1, P), tpv, tp.w_attend, tmask)
    got = got.reshape(tuple(tq.shape[:-1]) + (N,))
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    masked = ~tmask.reshape((B,) + (1,) * len(GRIDS[grid]) + (N,)).expand(got.shape)
    assert (got[masked] == 0).all()
    assert (got[B - 1] == 0).all()                          # the fully masked image


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_no_grad_routes_to_wrapper_and_equals_composite(dtype, grid, monkeypatch):
    _, (tp, tq, tpv, tmask) = _inputs(dtype, GRIDS[grid], 37, 100, seed=5)
    calls = []

    def spy(*args):
        calls.append(args)
        return katt.butd_attention(*args)

    monkeypatch.setattr(tatt, "butd_attention", spy)
    with torch.no_grad():
        got = tatt.attention_weights(tp, tq, tpv, tmask)
    assert len(calls) == 1 and calls[0][0].shape == (tq[..., 0].numel(), 100)
    # the gradient's route: the same call with a parameter that needs it
    grad_tp = tatt.AttentionParams(tp.w_query, tp.w_image,
                                   tp.w_attend.clone().requires_grad_(True))
    want = tatt.attention_weights(grad_tp, tq, tpv, tmask)
    assert len(calls) == 1
    assert want.requires_grad and torch.equal(got, want.detach())


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grad_runs_composite_and_reaches_the_parameters(grid, monkeypatch):
    _, (tp, tq, tpv, tmask) = _inputs("f32", GRIDS[grid], 37, 100, seed=6)

    def refuse(*args):
        raise AssertionError("the wrapper has no backward: a gradient must take the plain "
                             "version")

    plain = []
    monkeypatch.setattr(tatt, "butd_attention", refuse)
    monkeypatch.setattr(tatt, "butd_attention_plain",
                        lambda *a: plain.append(a) or katt.butd_attention_plain(*a))
    before = katt.launches
    wq, wa = tp.w_query.clone().requires_grad_(True), tp.w_attend.clone().requires_grad_(True)
    q = tq.clone().requires_grad_(True)
    weights = tatt.attention_weights(tatt.AttentionParams(wq, tp.w_image, wa), q, tpv, tmask)
    (weights * torch.linspace(-1, 1, 37)).sum().backward()
    assert katt.launches == before and len(plain) == 1
    for g in (wq.grad, wa.grad, q.grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    assert (q.grad[B - 1] == 0).all()                       # no box, no gradient


def test_grad_disabled_with_trainable_inputs_routes_to_wrapper(monkeypatch):
    """``requires_grad`` alone does not pick the plain version: under
    ``torch.no_grad()`` no graph is built, so the wrapper runs."""
    _, (tp, tq, tpv, tmask) = _inputs("f32", (), 37, 100, seed=7)
    calls = []
    monkeypatch.setattr(tatt, "butd_attention",
                        lambda *a: calls.append(a) or katt.butd_attention(*a))
    trainable = tatt.AttentionParams(*(t.clone().requires_grad_(True) for t in tp))
    with torch.no_grad():
        got = tatt.attention_weights(trainable, tq, tpv, tmask)
    assert len(calls) == 1 and not got.requires_grad


def _valid():
    _, (tp, tq, tpv, tmask) = _inputs("f32", (), 6, 16, seed=8)
    return torch.matmul(tq, tp.w_query), tpv, tp.w_attend, tmask


@pytest.mark.parametrize("case", ["pv_not_contiguous", "mixed_dtypes", "rows_not_per_image",
                                  "widths_disagree", "float64"])
def test_wrapper_raises(case):
    q, pv, w, mask = _valid()
    error = ValueError
    if case == "pv_not_contiguous":
        pv = pv.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "mixed_dtypes":
        pv, error = pv.to(torch.bfloat16), TypeError
    elif case == "rows_not_per_image":
        q = torch.cat([q, q[:1]])
    elif case == "widths_disagree":
        w = w[:-1]
    else:
        q, pv, w, error = q.double(), pv.double(), w.double(), TypeError
    with pytest.raises(error):
        katt.butd_attention(q, pv, w, mask)


def test_wrapper_takes_float_masks_as_keep_above_zero():
    q, pv, w, mask = _valid()
    got = katt.butd_attention(q, pv, w, mask)
    assert torch.equal(katt.butd_attention(q, pv, w, mask.float() * 0.5), got)
