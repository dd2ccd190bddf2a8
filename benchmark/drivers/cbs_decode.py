"""Driver of the captioning cells: groups of images through the port's
``DecodeHarness.decode_cbs`` (the inference CLI's constrained beam search),
one group after another.

A unit is one group: its inputs made on the card from the seed
(``generate.cbs_groups``), the decode, and the best captions with their
log-probs copied to the host, where a user gets them. The check draws
groups from the seed among those the window finished, decodes their inputs
again through the plain reference (``reference/captioner.py``) and compares
the best captions and their log-probs.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, generate
from benchmark.reference import captioner as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the control: the reference computed one precision below the cell's
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
# images a block of the reference: its dense search holds (block, n_z, S,
# K, S, V) candidates, ~1 GB in f32 at the published sizes
REFERENCE_BLOCK = 4


def program_params(w: Dict[str, torch.Tensor]):
    """The benchmark's flat weights as the port's parameter tree (the same
    tensors, not copies)."""
    from style_seqcvae_tpu_torch.models.attention import AttentionParams
    from style_seqcvae_tpu_torch.models.updown_cell import CellParams
    from style_seqcvae_tpu_torch.ops.lstm import LSTMCellParams

    def lstm(name):
        return LSTMCellParams(w[f"{name}.w"], w[f"{name}.b"])

    cell = CellParams(lstm("attention_lstm"),
                      AttentionParams(w["attention.w_query"], w["attention.w_image"],
                                      w["attention.w_attend"]),
                      lstm("encoder_lstm"), lstm("decoder_lstm"),
                      w["fc_mean.w"], w["fc_mean.b"], w["fc_log_var.w"], w["fc_log_var.b"])
    return {"embedding": w["embedding"], "cell": cell,
            "output_projection": {"w": w["output_projection.w"], "b": w["output_projection.b"]}}


def program_config(cfg: dict):
    from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig

    fields = set(CaptionerConfig._fields)
    return CaptionerConfig(**{k: v for k, v in cfg.items() if k in fields})


class Driver:
    unit_items = "captions"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from style_seqcvae_tpu_torch.decoding.cbs_fast import FSMTables
        from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
        from style_seqcvae_tpu_torch.ops.kernels import vocab_topk_lse

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = traffic["dtype"]
        self._tables = FSMTables
        self._kernel_a = vocab_topk_lse
        weights = ref.make_weights(cfg, generate.sub_seed(seed, generate.WEIGHTS), device,
                                   DTYPES[self.dtype])
        self.harness = DecodeHarness(program_params(weights), program_config(cfg), device=device)
        self.outputs: Dict[int, tuple] = {}
        self.units = 0
        self._a0 = 0

    def _decode(self, index: int):
        t = self.traffic
        x = generate.cbs_groups(t, self.cfg, self.seed, index, self.device)
        with torch.profiler.record_function("bench.decode"):
            best, lp = self.harness.decode_cbs(
                x["feats"], x["sentiment"], None, self._tables(*x["tables"]),
                x["num_constraints"], x["noise"], t["n_z"])
        return best.cpu(), lp.cpu()

    def warm(self) -> None:
        """The cell's own shapes, once, on inputs the window never sees."""
        self._decode(-1)

    def start(self) -> None:
        self._a0 = self._kernel_a.launches

    def unit(self, index: int) -> int:
        self.outputs[index] = self._decode(index)
        self.units += 1
        return self.traffic["images_per_group"] * self.traffic["n_z"]

    def counters(self) -> dict:
        """What the per-layer readers take from the window besides the
        trace: model operations by dtype, kernel A's launches and call
        shape, decode steps."""
        t, c = self.traffic, self.cfg
        S, K = 2 ** t["constraints_per_image"], c["beam_size"]
        E_exc = t["constraints_per_image"] * t["wordforms"]
        per = flops.cbs_decode_flops(c, t["images_per_group"], t["boxes"], t["n_z"], S, E_exc)
        rows = t["images_per_group"] * t["n_z"] * S * K
        return {"model_ops": {self.dtype: per * self.units},
                "decode_steps": self.units * c["max_caption_length"],
                "kernel_calls": {"vocab_topk_lse": {
                    "launches": self._kernel_a.launches - self._a0,
                    **flops.topk_lse_call(rows, c["vocab_size"], c["embedding_size"],
                                          c["per_node_beam_size"] + E_exc, self.dtype),
                    "dtype": self.dtype}}}

    def release(self) -> None:
        del self.harness
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, done: int) -> Dict[str, float]:
        """The numbers the traffic's ``limits`` hold the program to, on a
        sample of the finished groups drawn from the seed."""
        got = self.readings(done, ["program"], list(self.traffic["limits"]))["program"]
        return {k: got[k] for k in self.traffic["limits"]}

    def readings(self, done: int, sides: List[str], measures: List[str]
                 ) -> Dict[str, Dict[str, float]]:
        """For each side (``"program"``: the window's captions; a precision
        name: the plain reference's own search at that precision, put in the
        program's place), over the sampled groups:

        * ``lp_gap``: the widest gap between a side's log-prob of its best
          caption and the reference's (f32) log-prob of that caption by
          teacher forcing, which follows the caption's own tokens;
        * ``mismatch``: the share of best captions whose tokens differ from
          those of the reference's own search (f32), when asked for;
        * ``score_drop``: the most by which a side's best caption, scored
          by the reference, falls below the reference search's best, when
          asked for."""
        t, cfg = self.traffic, self.cfg
        picks = sample_units(self.seed, done, t["check_units"])
        w = {k: v.float() for k, v in ref.make_weights(
            cfg, generate.sub_seed(self.seed, generate.WEIGHTS), self.device,
            DTYPES[self.dtype]).items()}
        gaps = {s: [] for s in sides}
        same = {s: [] for s in sides}
        drops = {s: [] for s in sides}
        for i in picks:
            x = generate.cbs_groups(t, cfg, self.seed, i, self.device)
            want = reference_best(w, cfg, t, x, self.dtype, "f32") \
                if {"mismatch", "score_drop"} & set(measures) else None
            for side in sides:
                got = self.outputs[i] if side == "program" else \
                    reference_best(w, cfg, t, x, self.dtype, side)
                forced = reference_scores(w, cfg, t, x, got[0], self.dtype)
                gaps[side].append((got[1] - forced).abs().reshape(-1))
                if want is not None:
                    same[side].append((got[0] == want[0]).all(dim=-1).reshape(-1))
                    drops[side].append((want[1] - forced).reshape(-1))
        out = {}
        for side in sides:
            out[side] = {"lp_gap": torch.cat(gaps[side]).max().item()}
            if same[side]:
                out[side]["mismatch"] = 1.0 - torch.cat(same[side]).float().mean().item()
                out[side]["score_drop"] = torch.cat(drops[side]).max().item()
        return {s: {k: v for k, v in r.items() if k in measures} for s, r in out.items()}


def sample_units(seed: int, done: int, n: int) -> List[int]:
    """``n`` of the units 0 .. done - 1, drawn from the seed."""
    rng = np.random.default_rng(generate.sub_seed(seed, 99))
    return sorted(rng.choice(done, min(n, done), replace=False).tolist())


def reference_best(w, cfg, traffic, x, dtype: str, precision: str):
    """The reference's best captions (n_z, B, T) and log-probs (n_z, B) on
    the host, in blocks of ``REFERENCE_BLOCK`` images. Features pass
    through the program's dtype first, as the program receives them."""
    B, blk = traffic["images_per_group"], REFERENCE_BLOCK
    feats = x["feats"].to(DTYPES[dtype]).float()
    words = torch.from_numpy(x["wordforms"]).to(x["feats"].device)
    S = 2 ** traffic["constraints_per_image"]
    best, lp = [], []
    with torch.inference_mode():
        for b0 in range(0, B, blk):
            sl = slice(b0, b0 + blk)
            fsm = ref.dense_fsm(words[sl], S, cfg["vocab_size"])
            seqs, seq_lp = ref.constrained_beam_search(
                w, cfg, feats[sl], x["sentiment"][sl], fsm, x["noise"][:, :, sl], precision)
            b, l = ref.best_beam(seqs, seq_lp, traffic["constraints_per_image"],
                                 cfg["min_constraints_to_satisfy"])
            best.append(b.transpose(0, 1).cpu())
            lp.append(l.transpose(0, 1).cpu())
    return torch.cat(best, dim=1), torch.cat(lp, dim=1)


def reference_scores(w, cfg, traffic, x, captions, dtype: str):
    """The reference's f32 log-prob (n_z, B) of each caption (n_z, B, T) by
    teacher forcing, in blocks of ``REFERENCE_BLOCK`` images."""
    B, blk = traffic["images_per_group"], REFERENCE_BLOCK
    feats = x["feats"].to(DTYPES[dtype]).float()
    caps = captions.to(feats.device).transpose(0, 1)                   # (B, n_z, T)
    out = []
    with torch.inference_mode():
        for b0 in range(0, B, blk):
            sl = slice(b0, b0 + blk)
            out.append(ref.score_captions(w, cfg, feats[sl], x["sentiment"][sl], caps[sl],
                                          x["noise"][:, :, sl, 0, 0]).transpose(0, 1).cpu())
    return torch.cat(out, dim=1)
