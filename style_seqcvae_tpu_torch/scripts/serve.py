"""Serving CLI: raw images → N diverse CBS captions on the card
(counterpart of the JAX package's ``scripts/serve.py``).

    python -m style_seqcvae_tpu_torch.scripts.serve --config cfg.yml \\
        --image a.jpg b.png --canvas 608 928 --batch-requests 8 \\
        [--checkpoint-path params.npz] [--det-checkpoint-path det.npz] \\
        [--attrib-names-json attribs.json] [--output preds.json] [--cpu]

Each request runs ``serving.make_serve_fn``'s chain: the detector forward
(kernels C and D), the device box selection, per-z attribute constraints,
the FSM tables and the CBS decode (kernel A through ``"prehead"``), then the
best beam. Flags and outputs are the JAX CLI's.

* Batch mode (``--image``): requests are grouped by canvas bucket and
  served ``--batch-requests`` at a time, the last group padded by
  repetition; predictions come out in request order. Group g draws from a
  ``torch.Generator`` seeded ``RANDOM_SEED + g`` (JAX: ``PRNGKey(RANDOM_SEED
  + g)``; the two give different numbers).
* HTTP mode (``--http PORT``, port 0 picks a free one): ``GET /healthz`` and
  ``POST /caption?sentiment=±1`` with the image's bytes; one batcher thread
  owns the card and serves the requests of one canvas bucket that arrive
  within ``--batch-wait-ms`` as one group. Handler threads hand PNG and
  PPM to worker processes that decode them on the host (numpy's many short
  calls, each releasing the interpreter lock, crawl beside the batcher's
  Python step loop in one process) and check a JPEG by its header; the
  batcher decodes the JPEGs on the card (nvjpeg), copies the host-decoded
  pixels there and prepares every image on the card. A bad image is
  answered 400, a failed group 500, a request not served within 600 s 504.
  After a fault of the card (a CUDA or kernel error) the server stops and
  the CLI exits 1.

Unless ``--no-prewarm``, one warm-up group per canvas bucket runs first: it
builds the kernels and creates the library handles (there is no compile to
warm). Parameters: ``--checkpoint-path`` is the train CLI's directory (with
``--checkpoint-name``) or a ``.npz`` of the JAX captioner tree;
``--det-checkpoint-path`` a ``.npz`` of the JAX detector tree or a
reference ``.pth`` (Orbax checkpoints are refused). Without them the
weights are ``init_detector``'s (seed 0) and ``init_captioner``'s (seed
``RANDOM_SEED``, ``hashed_random_embeddings`` for a tied head). Params are
cast to bf16 unless ``--f32``. It runs on ``cuda`` unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing
import os
import queue
import signal
import threading
import time
from concurrent.futures import Future, ProcessPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.data.config_attrib_selection import attrib_selection
from style_seqcvae_tpu_torch.data.detection import (
    canvas_for,
    decode_image_bgr,
    load_image_bgr,
    prepare_image,
    prepared_size,
)
from style_seqcvae_tpu_torch.data.image_decode import (
    ImageError,
    bgr_tensor,
    decode_host,
    jpeg_header,
    sniff_format,
)
from style_seqcvae_tpu_torch.data.latents import LatentDictionary
from style_seqcvae_tpu_torch.data.readers import CocoAttributesReader
from style_seqcvae_tpu_torch.data.vocabulary import (
    Vocabulary,
    add_constraint_words_to_vocabulary,
)
from style_seqcvae_tpu_torch.decoding.device_fsm import build_attribute_wordform_table
from style_seqcvae_tpu_torch.decoding.fsm import FiniteStateMachineBuilder
from style_seqcvae_tpu_torch.decoding.harness import detokenize
from style_seqcvae_tpu_torch.device import resolve_device
from style_seqcvae_tpu_torch.models.captioner import (
    CaptionerConfig,
    hashed_random_embeddings,
    init_captioner,
)
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig, init_detector
from style_seqcvae_tpu_torch.ops.kernels._build import KernelError
from style_seqcvae_tpu_torch.serving import make_serve_fn
from style_seqcvae_tpu_torch.training.checkpointing import read_checkpoint
from style_seqcvae_tpu_torch.weights import (
    cast_floats,
    from_jax_params,
    load_detector_params,
    load_params_npz,
    to_device,
)

# HTTP mode: worker processes that decode PNG and PPM requests on the host
HOST_DECODE_WORKERS = min(4, os.cpu_count() or 1)

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--config", required=True)
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument("--image", nargs="+", default=[],
                    help="image file(s); each is served as one request (batch mode)")
parser.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="run an HTTP server instead of batch mode: POST /caption with raw "
                         "image bytes (optional ?sentiment=±1) → JSON {caption, candidates}; "
                         "GET /healthz. Port 0 picks a free port (printed). Requires --canvas")
parser.add_argument("--no-prewarm", action="store_true",
                    help="skip the warm-up group of each canvas bucket")
parser.add_argument("--batch-wait-ms", type=float, default=10.0,
                    help="HTTP mode: how long the batcher waits to fill a group")
parser.add_argument("--checkpoint-path", default="",
                    help="the train CLI's serialization directory (with --checkpoint-name), "
                         "or a .npz of the JAX captioner tree")
parser.add_argument("--checkpoint-name", default="checkpoint_best")
parser.add_argument("--det-checkpoint-path", default="",
                    help="a .npz of the JAX detector tree or a reference .pth")
parser.add_argument("--det-checkpoint-name", default="",
                    help="names an Orbax checkpoint in the JAX CLI; refused here")
parser.add_argument("--attribs-dir", default="",
                    help="COCO-Attributes index dir (attribute-head names)")
parser.add_argument("--attrib-names-json", default="",
                    help="JSON list of attribute-head names (alternative to --attribs-dir)")
parser.add_argument("--num-classes", type=int, default=81)
parser.add_argument("--depth", type=int, default=101, choices=[50, 101])
parser.add_argument("--sentiment", type=float, default=1.0)
parser.add_argument("--output", default="",
                    help="predictions JSON (image_id, caption, candidates)")
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions)")
parser.add_argument("--f32", action="store_true", help="decode in float32 (default bfloat16)")
parser.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="fixed serving canvas (landscape H W; portrait images use the "
                         "transpose). Default: per-request canvas of 32-multiples")
parser.add_argument("--batch-requests", type=int, default=1,
                    help="serve B requests per group (requires --canvas); the last group "
                         "pads by repetition")


def _card_fault(e: BaseException) -> bool:
    """A fault of the card or its code, after which serving must stop."""
    return isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)) or \
        type(e).__name__ == "AcceleratorError" or \
        (isinstance(e, RuntimeError) and "CUDA" in str(e))


class _Setup:
    """Everything a request needs: the serve function, the weights, the
    vocabulary and the prepare settings."""

    def __init__(self, _A, device: torch.device):
        self.device = device
        _C = Config(_A.config, _A.config_override)
        self.C, D = _C, _C.DET
        self.target, self.max_size = D.TEST.SCALES[0], D.TEST.MAX_SIZE
        vocabulary = Vocabulary.from_files(_C.DATA.VOCABULARY)
        if _C.DATA.CBS.WORDFORMS:
            add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS)
        if _C.DATA.CBS.WORDFORMS_ATTRIBS:
            add_constraint_words_to_vocabulary(vocabulary, _C.DATA.CBS.WORDFORMS_ATTRIBS)
        self.vocabulary = vocabulary

        attrib_names: List[str] = []
        if _A.attrib_names_json:
            with open(_A.attrib_names_json) as f:
                attrib_names = json.load(f)
        elif _A.attribs_dir:
            attrib_names = CocoAttributesReader(_A.attribs_dir).attrib_names
        fsm_builder = FiniteStateMachineBuilder(
            vocabulary, _C.DATA.CBS.WORDFORMS, _C.DATA.CBS.WORDFORMS_ATTRIBS,
            _C.DATA.CBS.MAX_GIVEN_CONSTRAINTS, _C.DATA.CBS.MAX_WORDS_PER_CONSTRAINT,
            use_coco_attributes=bool(attrib_names), attrib_selection=attrib_selection)
        # no attribute names → a 1-row unselectable table: every image decodes
        # unconstrained (num_constraints 0), matching the head size below
        table = build_attribute_wordform_table(attrib_names or ["<none>"],
                                               fsm_builder.wordforms, vocabulary)

        det_cfg = DetectorConfig(
            num_classes=_A.num_classes, num_att_classes=max(len(attrib_names), 1),
            depth=_A.depth, pooling_mode=D.POOLING_MODE,
            anchor_scales=tuple(D.ANCHOR_SCALES), anchor_ratios=tuple(D.ANCHOR_RATIOS))
        if _A.det_checkpoint_path:
            self.det_params = load_detector_params(_A.det_checkpoint_path, depth=_A.depth,
                                                   num_anchors=det_cfg.num_anchors,
                                                   device=device)
        else:
            self.det_params = init_detector(det_cfg, seed=0, device=device)

        cap_cfg = CaptionerConfig.from_config(_C, vocabulary)
        self.cap_cfg = cap_cfg
        if _A.checkpoint_path and os.path.isdir(_A.checkpoint_path):
            tree = read_checkpoint(os.path.join(_A.checkpoint_path, _A.checkpoint_name))
            cap_params = from_jax_params(tree["params"], device="cpu", family="cvae")
        elif _A.checkpoint_path:
            cap_params = from_jax_params(load_params_npz(_A.checkpoint_path), device="cpu",
                                         family="cvae")
        else:
            tokens = [vocabulary.get_token_from_index(i)
                      for i in range(vocabulary.get_vocab_size())]
            emb = (hashed_random_embeddings(tokens, cap_cfg.embedding_size, cap_cfg.pad_index)
                   if cap_cfg.tie_embeddings else None)
            cap_params = init_captioner(cap_cfg, seed=_C.RANDOM_SEED, device="cpu",
                                        embedding_table=emb)
        # the decode is weight-bound: bf16 params, not only bf16 activations
        self.cap_params = to_device(cast_floats(cap_params, None if _A.f32 else torch.bfloat16),
                                    device)

        att_embed_table = None
        if cap_cfg.sentiment_vae == 2:
            if cap_cfg.latent_embedding == "glove" and _C.DATA.SENTIGLOVE:
                latent_dict = LatentDictionary.from_sentiglove(
                    _C.DATA.SENTIGLOVE, cap_cfg.z_space, cap_cfg.latent_embedding_multip)
            elif cap_cfg.latent_embedding == "senti_word_net" and _C.DATA.SWN_SCORES:
                latent_dict = LatentDictionary.from_swn_scores(
                    _C.DATA.SWN_SCORES, cap_cfg.z_space, cap_cfg.latent_embedding_multip)
            else:
                raise SystemExit(
                    "MODEL.SENTIMENT_VAE=2 needs DATA.SENTIGLOVE or DATA.SWN_SCORES (the "
                    "mode-2 latent dictionary); refusing to serve with a silent zero-mean prior")
            if not attrib_names:
                raise SystemExit(
                    "MODEL.SENTIMENT_VAE=2 needs --attribs-dir or --attrib-names-json: the "
                    "attention prior is built from the attribute head's per-class latent "
                    "vectors")
            att_embed_table = latent_dict.embed_table(attrib_names)

        self.serve = make_serve_fn(
            det_cfg, cap_cfg, table,
            n_z=max(_C.MODEL.N_Z_SAMPLES, 1), beam_size=_C.MODEL.BEAM_SIZE,
            max_boxes=_C.DATA.MAX_BOXES, det_thresh=0.05, det_nms_thresh=D.TEST.NMS,
            att_thresh=_C.DATA.ATT_PRED_THRESH,
            max_constraints=_C.DATA.CBS.MAX_GIVEN_CONSTRAINTS,
            per_z_fsm=bool(_C.MODEL.STATE_MACHINE_PER_Z_SAMPLE),
            rpn_pre_nms_top_n=D.TEST.RPN_PRE_NMS_TOP_N,
            rpn_post_nms_top_n=D.TEST.RPN_POST_NMS_TOP_N,
            rpn_nms_thresh=D.TEST.RPN_NMS_THRESH,
            bbox_normalize_stds=D.TRAIN.BBOX_NORMALIZE_STDS,
            bbox_normalize_means=D.TRAIN.BBOX_NORMALIZE_MEANS,
            att_embed_table=att_embed_table,
            dtype=torch.float32 if _A.f32 else torch.bfloat16, device=device)

    def run_group(self, prepped: List[torch.Tensor], infos: List[tuple], sentiments: List[float],
                  bucket, batch: int, seed: int):
        """Serve one group padded by repetition to ``batch`` requests:
        prepped (h, w, 3) canvases, infos (h, w, scale). Returns the host
        arrays (captions (Z, B, T), log-probs (Z, B), constraints (B,))."""
        n = len(prepped)
        order = list(range(n)) + [n - 1] * (batch - n)
        ch, cw = bucket
        canvas = torch.zeros((batch, ch, cw, 3), dtype=torch.float32, device=self.device)
        info = np.zeros((batch, 3), np.float32)
        for i, j in enumerate(order):
            h, w, scale = infos[j]
            canvas[i, :h, :w] = prepped[j].to(self.device)
            info[i] = (float(h), float(w), scale)
        sent = np.asarray([[sentiments[j]] for j in order], np.float32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        best, lp, num_given = self.serve(self.det_params, self.cap_params, canvas,
                                         torch.from_numpy(info).to(self.device),
                                         torch.from_numpy(sent).to(self.device),
                                         generator=gen)
        return best.cpu().numpy(), lp.float().cpu().numpy(), num_given.cpu().numpy()

    def captions(self, best: np.ndarray, lp: np.ndarray, i: int):
        """(captions ordered by log-prob, best first) of request ``i``."""
        caps = [detokenize(best[z, i], self.vocabulary, self.cap_cfg.boundary_index)
                for z in range(best.shape[0])]
        order = np.argsort(-lp[:, i])
        return [caps[int(j)] for j in order]

    def prewarm(self, buckets, batch: int) -> None:
        t0 = time.time()
        for bucket in buckets:
            zero = torch.zeros((bucket[0], bucket[1], 3))
            self.run_group([zero], [(bucket[0], bucket[1], 1.0)], [0.0], bucket, batch, 0)
        print(f"warm-up: {len(buckets)} bucket group(s) in {time.time() - t0:.1f} s", flush=True)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the
    exit code. ``stats``, when given, receives ``groups`` (batch mode: the
    seconds of each group) and, in HTTP mode, ``server``, the running
    ``ThreadingHTTPServer`` (its ``shutdown()`` ends ``main``)."""
    _A = parser.parse_args(argv)
    if _A.det_checkpoint_name:
        parser.error("--det-checkpoint-name names an Orbax checkpoint, which the port does "
                     "not read: pass a .npz of the detector tree or a .pth as "
                     "--det-checkpoint-path")
    if _A.http is None and not _A.image:
        parser.error("either --image files or --http PORT is required")
    if _A.http is not None and not _A.canvas:
        parser.error("--http requires --canvas (groups share the canvas of their bucket)")
    B = max(_A.batch_requests, 1)
    if B > 1 and not _A.canvas:
        parser.error("--batch-requests > 1 requires --canvas (grouped images must share "
                     "one canvas)")
    stats = {} if stats is None else stats
    device = resolve_device("cpu" if _A.cpu else None)
    if _A.http is not None:
        # the decode workers import this CLI while the models are set up
        decoders = ProcessPoolExecutor(HOST_DECODE_WORKERS,
                                       mp_context=multiprocessing.get_context("spawn"))
        started = [decoders.submit(decode_host, b"P5 1 1 255\n\x00")
                   for _ in range(HOST_DECODE_WORKERS)]
        try:
            return _run_http_server(_A, _Setup(_A, device), B, stats, decoders, started)
        finally:
            decoders.shutdown(cancel_futures=True)
    setup = _Setup(_A, device)

    prepared = []
    for req, path in enumerate(_A.image):
        prepped, scale = prepare_image(load_image_bgr(path, setup.device), setup.target,
                                       setup.max_size)
        h, w = prepped.shape[:2]
        if _A.canvas:
            ch, cw = canvas_for({"height": h, "width": w}, tuple(_A.canvas))
            if h > ch or w > cw:
                raise SystemExit(f"image {path} prepped to {h}x{w} exceeds --canvas {ch}x{cw}; "
                                 "raise --canvas or lower DET.TEST.MAX_SIZE")
        else:
            ch, cw = -(-h // 32) * 32, -(-w // 32) * 32
        prepared.append((req, path, prepped, (h, w, scale), (ch, cw)))
    groups: Dict[Any, list] = {}
    for item in prepared:
        groups.setdefault(item[4], []).append(item)
    if not _A.no_prewarm:
        setup.prewarm(list(groups), B)

    predictions_by_idx: Dict[int, Dict[str, Any]] = {}
    stats["groups"] = []
    counter = 0
    for bucket, items in groups.items():
        for start in range(0, len(items), B):
            chunk = items[start:start + B]
            t0 = time.time()
            best, lp, num_given = setup.run_group(
                [it[2] for it in chunk], [it[3] for it in chunk],
                [float(_A.sentiment)] * len(chunk), bucket, B, setup.C.RANDOM_SEED + counter)
            dt = time.time() - t0
            stats["groups"].append(dt)
            counter += 1
            for i, (ridx, path, *_rest) in enumerate(chunk):
                caps = setup.captions(best, lp, i)
                tag = f" (batch {len(chunk)})" if B > 1 else ""
                print(f"[{path}] {dt * 1000:.1f} ms{tag}, {int(num_given[i])} constraints, "
                      f"{len(caps)} captions; best: {caps[0]!r}")
                predictions_by_idx[ridx] = {"image_id": path, "caption": caps[0],
                                            "candidates": caps}
    predictions = [predictions_by_idx[i] for i in range(len(prepared))]
    if _A.output:
        os.makedirs(os.path.dirname(os.path.abspath(_A.output)), exist_ok=True)
        with open(_A.output, "w") as f:
            json.dump(predictions, f, indent=2)
        print(f"wrote {len(predictions)} predictions to {_A.output}")
    return 0


def _run_http_server(_A, setup: _Setup, B: int, stats: Dict[str, Any],
                     decoders: ProcessPoolExecutor, started: List[Future]) -> int:
    """The HTTP front end: handler threads read the images (PNG and PPM
    decoded by ``decoders``' worker processes, which ``started`` starts),
    one batcher thread owns the card and serves each canvas bucket's
    requests in groups of up to ``B``. SIGTERM stops it as Ctrl-C does."""
    wait_s = max(_A.batch_wait_ms, 0.0) / 1000.0
    req_q: "queue.Queue" = queue.Queue()
    counter = itertools.count()
    fatal: List[BaseException] = []
    canvas_hw = tuple(_A.canvas)

    def prep(data: bytes, sentiment: float) -> Dict[str, Any]:
        """Host work of a request; raises ImageError for a bad image. A JPEG
        is only checked here: the batcher decodes it on the card."""
        item: Dict[str, Any] = {"sentiment": sentiment, "event": threading.Event(),
                                "out": None, "error": None}
        if sniff_format(data) == "JPEG":
            _, _, h0, w0, _ = jpeg_header(data)
            item["jpeg"] = data
        else:
            item["rgb"] = decoders.submit(decode_host, data).result()
            h0, w0 = item["rgb"].shape[:2]
        h, w, scale = prepared_size(h0, w0, setup.target, setup.max_size)
        ch, cw = canvas_for({"height": h, "width": w}, canvas_hw)
        if h > ch or w > cw:
            raise ImageError(f"image prepped to {h}x{w} exceeds --canvas {ch}x{cw}")
        item.update(info=(h, w, scale), bucket=(ch, cw))
        return item

    def finish(group, best, lp, num_given, dt_ms):
        for i, it in enumerate(group):
            caps = setup.captions(best, lp, i)
            it["out"] = {"caption": caps[0], "candidates": caps,
                         "num_constraints": int(num_given[i]), "batch": len(group),
                         "latency_ms": dt_ms}
            it["event"].set()

    def serve_group(group):
        """Decode the group's JPEGs on the card (a refused one is answered
        400 alone), prepare every image there, then serve them as one group;
        a failure answers 500 to every waiter, and a card fault stops the
        server."""
        try:
            ready = []
            for it in group:
                try:
                    img = (decode_image_bgr(it.pop("jpeg"), setup.device) if "jpeg" in it
                           else bgr_tensor(it.pop("rgb"), setup.device))
                    it["prepped"] = prepare_image(img, setup.target, setup.max_size)[0]
                except ImageError as e:
                    it["error"] = (400, f"bad request: {e}")
                    it["event"].set()
                    continue
                ready.append(it)
            if not ready:
                return
            t0 = time.time()
            best, lp, num_given = setup.run_group(
                [it["prepped"] for it in ready], [it["info"] for it in ready],
                [it["sentiment"] for it in ready], ready[0]["bucket"], B, next(counter))
        except Exception as e:      # report to every waiter; a card fault stops the server
            for it in group:
                if not it["event"].is_set():
                    it["error"] = (500, f"{type(e).__name__}: {e}")
                    it["event"].set()
            if _card_fault(e):
                fatal.append(e)
                threading.Thread(target=srv.shutdown, daemon=True).start()
            return
        finish(ready, best, lp, num_given, round((time.time() - t0) * 1000, 1))

    def batcher():
        pending: List[Dict[str, Any]] = []
        while not fatal:
            item = pending.pop(0) if pending else req_q.get()
            if item is None:
                return
            group, bucket = [item], item["bucket"]
            deadline = time.time() + wait_s
            i = 0
            while len(group) < B and i < len(pending):
                if pending[i]["bucket"] == bucket:
                    group.append(pending.pop(i))
                else:
                    i += 1
            while len(group) < B:
                t = deadline - time.time()
                if t <= 0:
                    break
                try:
                    nxt = req_q.get(timeout=t)
                except queue.Empty:
                    break
                if nxt is None:
                    req_q.put(None)
                    break
                (group if nxt["bucket"] == bucket else pending).append(nxt)
            serve_group(group)
        for it in pending:
            it["error"] = (500, "the server stopped after a fault of the card")
            it["event"].set()

    if not _A.no_prewarm:
        setup.prewarm(list(dict.fromkeys([canvas_hw, canvas_hw[::-1]])), B)
    default_sentiment = float(_A.sentiment)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet access log
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                return self._send(200, {"ok": True})
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/caption"):
                return self._send(404, {"error": "not found"})
            try:
                q = parse_qs(urlparse(self.path).query)
                sentiment = float(q.get("sentiment", [default_sentiment])[0])
                data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                item = prep(data, sentiment)
            except (ImageError, ValueError) as e:
                return self._send(400, {"error": f"bad request: {e}"})
            if fatal:
                return self._send(500, {"error": "the server stopped after a fault of the card"})
            req_q.put(item)
            if not item["event"].wait(timeout=600):
                return self._send(504, {"error": "decode timed out"})
            if item["error"]:
                code, message = item["error"]
                return self._send(code, {"error": message})
            return self._send(200, item["out"])

    for f in started:
        f.result()
    srv = ThreadingHTTPServer(("127.0.0.1", _A.http), Handler)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(target=srv.shutdown,
                                                                  daemon=True).start())
    worker = threading.Thread(target=batcher, daemon=True)
    worker.start()
    stats["server"] = srv
    print(f"serving on http://127.0.0.1:{srv.server_address[1]} "
          f"(POST /caption; batch {B} x {_A.batch_wait_ms} ms window)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        req_q.put(None)
        worker.join(timeout=60)
    if fatal:
        print(f"stopped after a fault of the card: {type(fatal[0]).__name__}: {fatal[0]}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
