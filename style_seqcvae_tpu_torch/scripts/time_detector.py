"""Time the detector's inference forward and training step on the card, for
comparing two checkouts of the package in one call:

    python3 style_seqcvae_tpu_torch/scripts/time_detector.py --root DIR \\
        [--reps 10] [--out FILE] [--cases CASE ...]

imports ``style_seqcvae_tpu_torch`` from the checkout at ``DIR`` (the
repository's root by default) and uses only what the package has offered
since the detector's training was ported, so that an older checkout can be
timed by this script too. Run it once per checkout and in the order A, B,
B, A, all in one call. Each case runs from random weights (seeded) on a
synthetic batch; its median and range of ``--reps`` timed runs after two
warm-ups go to stdout as one JSON line each (and to ``--out``):

    detect_r101_f32     config 5's inference forward (ResNet-101, 81 classes,
                        98 attributes, 16 canvases of 608 x 928), f32: the
                        forward that serving, e2e and the extract CLI run
    detect_r101_bf16    the same with bf16 weights and images
    heads_r101_bf16     the class, box and attribute heads alone on that
                        forward's 4,800 bf16 RoI features
    train_r101_bf16     a training step under bf16 compute (ResNet-101, 81
                        classes, 196 attributes, 4 images on 640 x 1024)
    train_r50_bf16      the workflow's stage 1 step shape (ResNet-50, 8
                        images on 384 x 512), bf16 compute
    detect_vgg16_bf16   VGG16's inference forward, 2 canvases of 608 x 928,
                        bf16 weights and images
    train_vgg16_bf16    a VGG16 training step, the same 2 images, bf16 compute
    roi_backward_r101_f32   RoIAlign's backward kernel alone
                        (``ops/kernels/roi_align.py::roi_align_backward``) at
                        the ResNet-101 step's (4, 40, 64, 1024) with 512 RoIs
                        laid out as proposal_target yields them, f32
    roi_backward_r101_bf16  the same in bf16
    roi_backward_r50_bf16   the same at the workflow's stage-1 step, bf16
                        (8, 24, 32, 1024) with 1,024 RoIs

The ``roi_backward_*`` cases time a CUDA graph of 10 launches with CUDA
events (``ops/kernels/ablate_topk_roi.py::graph_ms``): the median and range
of 5 replays, divided by 10. ``--cases`` runs only the cases named. The
last line is the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package is timed")
parser.add_argument("--reps", type=int, default=10)
parser.add_argument("--out", default="", help="also append the JSON lines to this file")
parser.add_argument("--cases", nargs="+", default=None, help="run only these cases")


def train_rois(gen, n, image, per_image=128):
    """n x per_image RoIs as proposal_target yields them: image-major,
    boxes over the image (a quarter near 8 ground-truth centres, 16-416
    px wide), the last two rows of each image all-zero padding; on the
    generator's device."""
    import torch

    dev = gen.device
    h, w = image
    size = torch.tensor([float(w), float(h)], device=dev)
    gt_ctr = torch.rand(n, 8, 2, generator=gen, device=dev) * size
    ctr = torch.rand(n, per_image, 2, generator=gen, device=dev) * size
    q = per_image // 4
    ctr[:, :q] = gt_ctr[:, torch.arange(q, device=dev) % 8] + torch.randn(
        n, q, 2, generator=gen, device=dev) * 8.0
    wh = torch.rand(n, per_image, 2, generator=gen, device=dev) * 400.0 + 16.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, w - 1)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, h - 1)
    col = torch.arange(n, device=dev, dtype=torch.float32)[:, None, None].expand(
        n, per_image, 1)
    rois = torch.cat([col, boxes], dim=-1)
    rois[:, -2:, 1:] = 0.0
    return rois.reshape(n * per_image, 5).contiguous()


def main() -> int:
    a = parser.parse_args()
    root = str(Path(a.root).resolve())
    sys.path.insert(0, root)
    import torch

    import style_seqcvae_tpu_torch as pkg
    from style_seqcvae_tpu_torch.config import Config
    from style_seqcvae_tpu_torch.models.detector import faster_rcnn as fr
    from style_seqcvae_tpu_torch.scripts import train_detector as td
    from style_seqcvae_tpu_torch.training.detector_optimizer import DetectorSGD

    if not str(Path(pkg.__file__).resolve()).startswith(root):
        raise SystemExit(f"imported {pkg.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("time_detector needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    # the heads' product: this checkout's shared f32 linear, or an older
    # checkout's own
    try:
        from style_seqcvae_tpu_torch.models.detector.layers import linear_f32 as head
    except ImportError:
        head = fr._linear

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(a.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ms), [min(ms), max(ms)]

    def emit(case, ms, **extra):
        row = json.dumps({"case": case, "root": root, "ms": ms[0], "ms_range": ms[1],
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **extra})
        print(row, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(row + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def cfg(depth, classes, atts, backbone="resnet"):
        c = td.detector_config(Config().DET, classes, atts, depth, False)
        return c._replace(backbone=backbone)

    def batch(n, canvas, image, atts, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        h, w = image
        images = torch.zeros((n,) + tuple(canvas) + (3,), device=dev)
        images[:, :h, :w] = torch.randn(n, h, w, 3, generator=gen, device=dev) * 50.0
        xy = torch.rand(n, 8, 2, generator=gen, device=dev) * torch.tensor(
            [w * 0.6, h * 0.6], device=dev)
        wh = torch.rand(n, 8, 2, generator=gen, device=dev) * torch.tensor(
            [w * 0.4, h * 0.4], device=dev) + 24.0
        cls = torch.randint(1, 81, (n, 8, 1), generator=gen, device=dev).float()
        return {"images": images,
                "im_info": torch.tensor([[float(h), float(w), 1.0]] * n, device=dev),
                "gt_boxes": torch.cat([xy, xy + wh, cls], dim=-1),
                "num_gt": torch.full((n,), 8, device=dev),
                "gt_atts": (torch.rand(n, 8, max(atts, 1), generator=gen, device=dev)
                            > 0.9).float(),
                "att_counts": torch.randint(1, 500, (max(atts, 1),), generator=gen,
                                            device=dev).float()}

    def detect(case, c, n, canvas, image, dtype):
        params = fr.init_detector(c, seed=0, device=dev, dtype=dtype)
        b = batch(n, canvas, image, 0, seed=3)
        images, im_info = b["images"].to(dtype), b["im_info"]
        with torch.inference_mode():
            ms = timed(lambda: fr.detector_forward_test(params, c, images, im_info))
            out = fr.detector_forward_test(params, c, images, im_info)
        emit(case, ms, batch=n, canvas=list(canvas), dtype=str(dtype).split(".")[-1],
             rois=int(out["rois"].shape[0] * out["rois"].shape[1]))
        return params, out

    def train(case, c, n, canvas, image, atts):
        params = fr.init_detector(c, seed=0, device=dev)
        opt = DetectorSGD(params, lr=1e-3, momentum=0.9, weight_decay=1e-4, steps_per_epoch=100)
        step = td.make_train_step(c, opt, True)
        b = batch(n, canvas, image, atts, seed=5)
        gen = torch.Generator(device=dev).manual_seed(1)
        emit(case, timed(lambda: step(params, b, gen)), batch=n, canvas=list(canvas),
             dtype="bf16")

    def roi_backward(case, n, canvas, image, dtype):
        from style_seqcvae_tpu_torch.ops.kernels import roi_align
        from style_seqcvae_tpu_torch.ops.kernels.ablate_topk_roi import graph_ms

        gen = torch.Generator(device=dev).manual_seed(18)
        rois = train_rois(gen, n, image)
        shape = (n, canvas[0] // 16, canvas[1] // 16, 1024)
        grad_out = torch.randn(rois.shape[0], 7, 7, 1024, generator=gen, device=dev).to(dtype)
        emit(case, graph_ms(lambda: roi_align.roi_align_backward(
            grad_out, rois, shape, spatial_scale=1 / 16.0, pooled_height=7, pooled_width=7,
            sampling_ratio=2)), features=list(shape), rois=int(rois.shape[0]),
            dtype=str(dtype).split(".")[-1])

    def want(*cases):
        return a.cases is None or any(c in a.cases for c in cases)

    c5 = cfg(101, 81, 98)
    if want("detect_r101_f32"):
        detect("detect_r101_f32", c5, 16, (608, 928), (600, 900), torch.float32)
    if want("detect_r101_bf16", "heads_r101_bf16"):
        params, out = detect("detect_r101_bf16", c5, 16, (608, 928), (600, 900),
                             torch.bfloat16)
        feat = out["pooled_feat"].reshape(-1, out["pooled_feat"].shape[-1])
        with torch.inference_mode():
            emit("heads_r101_bf16", timed(lambda: [head(params[k], feat) for k in (
                "cls_score", "bbox_pred", "cls_score_atts")]), rois=int(feat.shape[0]))
        del params, out, feat
    if want("train_r101_bf16"):
        train("train_r101_bf16", cfg(101, 81, 196), 4, (640, 1024), (600, 1000), 196)
    if want("train_r50_bf16"):
        train("train_r50_bf16", cfg(50, 81, 196), 8, (384, 512), (384, 512), 196)
    vgg = cfg(50, 81, 0, "vgg16")
    if want("detect_vgg16_bf16"):
        detect("detect_vgg16_bf16", vgg, 2, (608, 928), (600, 900), torch.bfloat16)
    if want("train_vgg16_bf16"):
        train("train_vgg16_bf16", vgg, 2, (608, 928), (600, 900), 0)
    # the C4 map is the canvas / 16, the RoIs lie on the image
    for case, n, canvas, image, dtype in (
            ("roi_backward_r101_f32", 4, (640, 1024), (600, 1000), torch.float32),
            ("roi_backward_r101_bf16", 4, (640, 1024), (600, 1000), torch.bfloat16),
            ("roi_backward_r50_bf16", 8, (384, 512), (384, 512), torch.bfloat16)):
        if want(case):
            roi_backward(case, n, canvas, image, dtype)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
