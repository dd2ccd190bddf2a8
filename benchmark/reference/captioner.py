"""Plain reference of the Style-SeqCVAE captioner's constrained beam search.

Written from the model's definition (Klein, Mahajan, Roth, GCPR 2021; the
UpDown cell of the reference's ``var_updown``), not from the program: every
step recomputes the whole LSTM input products, the head materialises the
(rows, V) logits, and the search expands each beam over a dense (S, S, V)
FSM, keeping per target state the top ``per_node_beam_size`` tokens of each
source beam and then the top ``beam_size`` of those. Nothing of the
program is imported.

The weights are the benchmark's own (:func:`make_weights`): one flat dict
of tensors drawn on the device from a seed, in a few large calls. The
driver hands the same tensors to the program in its parameter tree.

Products run through :func:`matmul` at a stated precision: ``"f32"`` (TF32
off), and the lower precisions that serve as the check's controls:
``"tf32"``, ``"bf16"`` and ``"fp8"`` (both operands rounded to
float8_e4m3 under a per-tensor scale).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch

FP8_MAX = 448.0


def condition_width(cfg: dict) -> int:
    """Width of the style condition in the LSTM inputs: the sentiment
    scalar in prior mode 1, nothing without a style prior."""
    if cfg["simple_vae"] or cfg["sentiment_vae"] == 0:
        return 0
    if cfg["sentiment_vae"] == 1:
        return 1
    raise ValueError(f"the reference covers prior modes 0 and 1, not {cfg['sentiment_vae']}")


def weight_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each leaf's shape and the bound of its uniform draw (0: normal).
    LSTM matrices are (input + hidden, 4 hidden), gates in (i, f, g, o)
    order, rows in the order of the input segments, then the recurrent h."""
    V, E, H = cfg["vocab_size"], cfg["embedding_size"], cfg["hidden_size"]
    F, P, Z = cfg["image_feature_size"], cfg["attention_projection_size"], cfg["z_space"]
    c = condition_width(cfg)
    lstm = 1.0 / math.sqrt(H)
    return {
        "embedding": ((V, E), 0.0),
        # attention LSTM: [token, mean image feature, h1, h_dec] + h1
        "attention_lstm.w": ((E + F + 2 * H + H, 4 * H), lstm),
        "attention_lstm.b": ((4 * H,), lstm),
        "attention.w_query": ((H, P), 1.0 / math.sqrt(H)),
        "attention.w_image": ((F, P), 1.0 / math.sqrt(F)),
        "attention.w_attend": ((P,), 1.0 / math.sqrt(P)),
        # encoder LSTM (training's posterior; unused by the decode)
        "encoder_lstm.w": ((c + F + 2 * H + H, 4 * H), lstm),
        "encoder_lstm.b": ((4 * H,), lstm),
        # decoder LSTM: [attended, h1, h_dec, condition, z] + h_dec
        "decoder_lstm.w": ((F + 2 * H + c + Z + H, 4 * H), lstm),
        "decoder_lstm.b": ((4 * H,), lstm),
        "fc_mean.w": ((H, Z), 1.0 / math.sqrt(H)),
        "fc_mean.b": ((Z,), 1.0 / math.sqrt(H)),
        "fc_log_var.w": ((H, Z), 1.0 / math.sqrt(H)),
        "fc_log_var.b": ((Z,), 1.0 / math.sqrt(H)),
        # tied head: tanh(h_dec W + b) · embedding^T
        "output_projection.w": ((H, E), 1.0 / math.sqrt(H)),
        "output_projection.b": ((E,), 1.0 / math.sqrt(H)),
    }


def make_weights(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every leaf drawn on ``device`` from ``seed``: the embedding from one
    normal draw (its padding row zero), the rest from one uniform draw
    sliced and scaled, then cast to ``dtype``."""
    shapes = weight_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    emb_shape = shapes["embedding"][0]
    emb = torch.randn(emb_shape, generator=gen, device=device)
    emb[cfg["pad_index"]] = 0.0
    rest = [(k, s, b) for k, (s, b) in shapes.items() if k != "embedding"]
    total = sum(math.prod(s) for _, s, _ in rest)
    flat = torch.rand((total,), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {"embedding": emb.to(dtype)}, 0
    for k, s, b in rest:
        n = math.prod(s)
        out[k] = (flat[at:at + n].view(s) * b).to(dtype)
        at += n
    return out


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in f32 after rounding both operands as ``precision`` says."""
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif precision == "bf16":
        a, b = a.bfloat16().float(), b.bfloat16().float()
    elif precision not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    with _tf32(precision == "tf32"):
        return a @ b


def _lstm(w, b, x, h, c, precision):
    gates = matmul(torch.cat([x, h], dim=-1), w, precision) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class Step:
    """The captioner's step at inference over rows (Bb, ...rows) of one
    block of images. ``w``: the weights as f32; ``feats`` (Bb, N, F);
    ``sentiment`` (Bb, 1)."""

    def __init__(self, w, cfg, feats, sentiment, precision):
        self.w, self.cfg, self.p = w, cfg, precision
        self.feats = feats
        mask = (feats.abs().sum(-1) > 0).float()                       # (Bb, N)
        self.mask = mask
        self.avg = (feats * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1e-13)
        self.proj = matmul(feats, w["attention.w_image"], precision)    # (Bb, N, P)
        self.sentiment = sentiment
        self.prior_mean = sentiment * cfg["senti_prior_multip"] if cfg["sentiment_vae"] == 1 \
            else torch.zeros_like(sentiment)
        self.std = float(cfg["prior_std"])

    def __call__(self, tokens, h1, c1, hd, cd, eps):
        """tokens (Bb, *g); states (Bb, *g, H); eps (Bb, *g, z) →
        (logits (Bb, *g, V), h1, c1, hd, cd)."""
        w, cfg, p = self.w, self.cfg, self.p
        Bb, g = tokens.shape[0], tuple(tokens.shape[1:])
        ones = (1,) * len(g)

        def grid(x):  # (Bb, D) → (Bb, *g, D)
            return x.reshape((Bb,) + ones + (x.shape[-1],)).expand((Bb,) + g + (x.shape[-1],))

        x = torch.cat([w["embedding"][tokens], grid(self.avg), h1, hd], dim=-1)
        h1, c1 = _lstm(w["attention_lstm.w"], w["attention_lstm.b"], x, h1, c1, p)
        q = matmul(h1, w["attention.w_query"], p)                       # (Bb, *g, P)
        N, P = self.proj.shape[1:]
        pv = self.proj.reshape((Bb,) + ones + (N, P))
        scores = matmul(torch.tanh(q[..., None, :] + pv), w["attention.w_attend"][:, None],
                        p)[..., 0]                                      # (Bb, *g, N)
        m = self.mask.reshape((Bb,) + ones + (N,))
        scores = torch.where(m > 0, scores, torch.tensor(float("-inf"), device=scores.device))
        att = torch.softmax(scores, dim=-1)
        attended = matmul(att.reshape(Bb, -1, N), self.feats, p).reshape((Bb,) + g + (-1,))
        z = eps * self.std + grid(self.prior_mean).expand((Bb,) + g + (cfg["z_space"],)) \
            if cfg["sentiment_vae"] == 1 else eps * self.std
        parts = [attended, h1, hd]
        if condition_width(cfg):
            parts.append(grid(self.sentiment))
        parts.append(z)
        hd, cd = _lstm(w["decoder_lstm.w"], w["decoder_lstm.b"], torch.cat(parts, -1), hd, cd, p)
        head = torch.tanh(matmul(hd, w["output_projection.w"], p) + w["output_projection.b"])
        return matmul(head, w["embedding"].T, p), h1, c1, hd, cd


def dense_fsm(tokens: torch.Tensor, states: int, vocab: int) -> torch.Tensor:
    """(Bb, C, W) constraint wordforms → (Bb, S, S, V) bool: every token
    keeps its state, except that a wordform of a constraint not yet met
    (its bit clear in the state) moves to the state with that bit set."""
    Bb, C, W = tokens.shape
    dev = tokens.device
    fsm = torch.zeros((Bb, states, states, vocab), dtype=torch.bool, device=dev)
    s = torch.arange(states, device=dev)
    fsm[:, s, s, :] = True
    for b in range(Bb):
        for c in range(C):
            for src in range(states):
                if src >> c & 1 or (src | 1 << c) >= states:
                    continue
                for t in tokens[b, c].tolist():
                    fsm[b, src, src, t] = False
                    fsm[b, src, src | 1 << c, t] = True
    return fsm


def constrained_beam_search(w, cfg, feats, sentiment, fsm, noise, precision="f32"):
    """One block of images through the dense constrained beam search.

    feats (Bb, N, F) and sentiment (Bb, 1) f32; fsm (Bb, S, S, V) bool;
    noise (n_z, T, Bb, S or 1, K or 1, z): the z-noise of beam (s, k) at
    step t (at step 0 the first entry). Returns (sequences (Bb, n_z, S, K, T),
    log-probs (Bb, n_z, S, K)), beams in each state sorted by log-prob."""
    T, K, end = cfg["max_caption_length"], cfg["beam_size"], cfg["boundary_index"]
    pnbs = cfg["per_node_beam_size"]
    Bb, S, V = fsm.shape[0], fsm.shape[1], fsm.shape[-1]
    n_z, H = noise.shape[0], cfg["hidden_size"]
    dev = feats.device
    ninf = torch.tensor(float("-inf"), device=dev)
    step = Step(w, cfg, feats, sentiment, precision)
    zeros = torch.zeros((Bb, n_z, H), device=dev)

    # step 0: every (image, z) from the boundary token in state 0
    eps0 = noise[:, 0, :, 0, 0].transpose(0, 1)                         # (Bb, n_z, z)
    start = torch.full((Bb, n_z), end, dtype=torch.long, device=dev)
    logits, h1, c1, hd, cd = step(start, zeros, zeros, zeros, zeros, eps0)
    lp = torch.log_softmax(logits, dim=-1)                              # (Bb, n_z, V)
    allowed0 = fsm[:, 0]                                                # (Bb, S_to, V)
    lp_sk, tok = torch.where(allowed0[:, None], lp[:, :, None, :], ninf).topk(K, dim=-1)
    states = [x[:, :, None, None].expand(Bb, n_z, S, K, H).contiguous() for x in (h1, c1, hd, cd)]
    history, backptrs = [tok], []

    for t in range(1, T):
        eps = noise[:, t].permute(1, 0, 2, 3, 4)                        # (Bb, n_z, S, K, z)
        logits, *states = step(tok, *states, eps)
        lp = torch.log_softmax(logits, dim=-1)                          # (Bb, n_z, S, K, V)
        # a beam that emitted the end token emits it again, at no cost
        after_end = torch.full((V,), float("-inf"), device=dev)
        after_end[end] = 0.0
        lp = torch.where((tok == end)[..., None], after_end, lp)
        # (Bb, n_z, S_from, K, S_to, V) → the top pnbs of each beam per target
        cand = torch.where(fsm[:, None, :, None], lp[:, :, :, :, None, :], ninf)
        val, idx = cand.topk(pnbs, dim=-1)                              # (Bb, n_z, Sf, K, St, p)
        total = val + lp_sk[..., None, None]
        total = total.permute(0, 1, 4, 2, 3, 5).reshape(Bb, n_z, S, S * K * pnbs)
        idx = idx.permute(0, 1, 4, 2, 3, 5).reshape(Bb, n_z, S, S * K * pnbs)
        lp_sk, pick = total.topk(K, dim=-1)                             # (Bb, n_z, S_to, K)
        tok = torch.gather(idx, -1, pick)
        back = pick // pnbs                                             # source s * K + k
        states = [torch.gather(x.reshape(Bb, n_z, S * K, H), 2,
                               back.reshape(Bb, n_z, S * K, 1).expand(-1, -1, -1, H)
                               ).reshape(Bb, n_z, S, K, H) for x in states]
        history.append(tok)
        backptrs.append(back)

    # the backpointer walk from the last step
    beam = torch.arange(S * K, device=dev).expand(Bb, n_z, S * K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(history[t].reshape(Bb, n_z, S * K), 2, beam)
        if t > 0:
            beam = torch.gather(backptrs[t - 1].reshape(Bb, n_z, S * K), 2, beam)
    seqs = torch.stack(out, dim=-1).reshape(Bb, n_z, S, K, T)
    return seqs, lp_sk


def best_beam(seqs, lp, given: int, min_to_satisfy: int):
    """The top beam of the most likely state that meets enough constraints
    (popcount of the state >= min(given, min_to_satisfy)).
    seqs (Bb, n_z, S, K, T), lp (Bb, n_z, S, K) → ((Bb, n_z, T), (Bb, n_z))."""
    S = seqs.shape[2]
    need = min(given, min_to_satisfy)
    valid = torch.tensor([bin(s).count("1") >= need and s < 2 ** given for s in range(S)],
                         device=lp.device)
    top = torch.where(valid, lp[..., 0], torch.tensor(float("-inf"), device=lp.device))
    best_lp, s = top.max(dim=-1)
    best = torch.gather(seqs[..., 0, :], 2,
                        s[..., None, None].expand(-1, -1, 1, seqs.shape[-1]))[:, :, 0]
    return best, best_lp


def score_captions(w, cfg, feats, sentiment, captions, noise, precision="f32"):
    """Teacher forcing: the log-prob of each given caption, its tokens fed
    back in turn from the boundary token, summed up to and including its
    first end token (an ended caption adds nothing more).

    feats (Bb, N, F), sentiment (Bb, 1); captions (Bb, n_z, T); noise
    (n_z, T, Bb, z): caption (b, z)'s z-noise at step t. Returns (Bb, n_z)."""
    T, end, H = cfg["max_caption_length"], cfg["boundary_index"], cfg["hidden_size"]
    Bb, n_z = captions.shape[:2]
    step = Step(w, cfg, feats, sentiment, precision)
    state = [torch.zeros((Bb, n_z, H), device=feats.device) for _ in range(4)]
    prev = torch.full((Bb, n_z), end, dtype=torch.long, device=feats.device)
    total = torch.zeros((Bb, n_z), device=feats.device)
    live = torch.ones((Bb, n_z), dtype=torch.bool, device=feats.device)
    for t in range(T):
        logits, *state = step(prev, *state, noise[:, t].transpose(0, 1))
        tok = captions[:, :, t]
        lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[..., None])[..., 0]
        total += torch.where(live, lp, torch.zeros_like(lp))
        live &= tok != end
        prev = tok
    return total
