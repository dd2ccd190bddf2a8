"""The port's detection drawing (``utils/visualize.py``, ``utils/glyphs.py``
and ``scripts/eval_detections.py --vis-dir``) against the JAX package's,
which draws with PIL. Every comparison is equality to the bit: the port
reproduces PIL's rectangles, its label text in the default font (Aileron
Regular 10 through the committed glyph atlas) and its blending, so no pixel
may differ. Inputs come from numpy seeds; the JAX CLI runs in this process
(``runpy`` with ``sys.argv`` patched), the port's under ``--cpu``.

Run ``python -m tests.test_torch_visualize --print-atlas`` from the repo root
to print the atlas's ``_PACKED`` literal rendered from this machine's Pillow.
"""

import base64
import json
import runpy
import shutil
import struct
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageFont

from style_seqcvae_tpu.utils import visualize as jvis
from style_seqcvae_tpu_torch.data.image_decode import ImageFormatError
from style_seqcvae_tpu_torch.scripts import eval_detections as TE
from style_seqcvae_tpu_torch.utils import glyphs, visualize as tvis

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PRINTABLE = "".join(chr(c) for c in range(32, 127))
COCO80 = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
    "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball",
    "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
]


# ------------------------------------------------------------------ atlas


def pil_atlas():
    """The atlas rendered from this machine's Pillow: character → (mask,
    x, y, advance), as ``utils/glyphs.py`` documents it."""
    font = ImageFont.load_default()
    out = {}
    for ch in PRINTABLE:
        mask, (x, y) = font.getmask2(ch, "L")
        w, h = mask.size
        advance = font.getlength(ch)
        assert advance == int(advance), (ch, advance)
        out[ch] = (np.array(mask, np.uint8).reshape(h, w), x, y, int(advance))
    return out


def packed_literal(atlas) -> str:
    data = b"".join(struct.pack("<BBbbB", m.shape[1], m.shape[0], x, y, a) + m.tobytes()
                    for m, x, y, a in (atlas[ch] for ch in PRINTABLE))
    text = base64.b64encode(zlib.compress(data, 9)).decode()
    return "\n".join(f'    "{line}"' for line in textwrap.wrap(text, 88))


def test_atlas_matches_pillow():
    font = ImageFont.load_default()
    assert font.getmetrics()[0] == glyphs.ASCENT
    assert sorted(glyphs.GLYPHS) == sorted(PRINTABLE)
    for ch, (mask, x, y, advance) in pil_atlas().items():
        g = glyphs.GLYPHS[ch]
        assert (g.x, g.y, g.advance) == (x, y, advance), ch
        assert g.mask.dtype == np.uint8 and g.mask.shape == mask.shape, ch
        np.testing.assert_array_equal(g.mask, mask, err_msg=repr(ch))


def test_text_width_is_pillow_textlength():
    font = ImageFont.load_default()
    for label in [PRINTABLE, "AV To", "dog: 0.950"] + [f"{n}: 0.123" for n in COCO80]:
        assert tvis.text_width(label) == font.getlength(label), label


# -------------------------------------------------------- vis_detections


def _image(rng, h=72, w=96):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _dets(x1, y1, x2, y2, s, dtype=np.float32):
    return np.stack([np.asarray(v, np.float64) for v in (x1, y1, x2, y2, s)], 1).astype(dtype)


def _cases():
    """name → (image, [(class_name, dets, kwargs), ...]), each drawn in turn."""
    rng = np.random.RandomState(0)
    cases = {}
    n = 6
    x1, y1 = rng.uniform(0, 70, n), rng.uniform(0, 50, n)
    x1[:3] = np.floor(x1[:3]) + 0.5                     # coordinates at .5
    y1[2:5] = np.floor(y1[2:5]) + 0.5
    cases["fractional"] = (_image(rng), [(
        "dog", _dets(x1, y1, x1 + rng.uniform(1, 30, n), y1 + rng.uniform(1, 30, n),
                     rng.uniform(0.81, 1, n)), {})])
    cases["edges"] = (_image(rng), [(
        "person", _dets([80.3, 10.7, 3.2, 60.5], [40.6, 65.2, 4.9, 0.0],
                        [120.4, 30.1, 20.8, 95.9], [90.2, 80.6, 14.5, 71.9],
                        [0.9, 0.95, 0.99, 0.91]), {})])
    cases["negative"] = (_image(rng), [(
        "cat", _dets([-5.3, -20.0, -3.5, -0.7, 10.2], [-4.2, 10.5, -30.8, 20.1, -0.5],
                     [8.9, -2.5, 40.0, 0.2, 30.7], [20.3, 30.5, -10.1, 40.7, 8.8],
                     [0.9, 0.85, 0.96, 0.99, 0.97]), {})])
    x1, y1 = rng.uniform(0, 80, 12), rng.uniform(12, 60, 12)
    cases["twelve_boxes"] = (_image(rng), [(
        "zebra", _dets(x1, y1, x1 + 6, y1 + 5, rng.uniform(0.9, 1, 12)), {})])
    cases["at_threshold"] = (_image(rng), [(
        "kite", _dets([5, 30, 50], [20, 30, 40], [25, 45, 90], [35, 50, 60],
                      [0.8, 0.8000001, 0.5], np.float64), {"thresh": 0.8})])
    cases["explicit_color"] = (_image(rng), [(
        "bus", _dets([4.5, 40.2], [14.5, 30.7], [30.5, 70.1], [40.5, 60.3], [0.95, 0.9]),
        {"color": (17, 200, 90)})])
    chunks = [PRINTABLE[i:i + 12] for i in range(0, len(PRINTABLE), 12)]
    ascii_draws = []
    for i, name in enumerate(chunks):
        x = rng.uniform(-3, 60, 1)
        y = rng.uniform(0, 150, 1)
        ascii_draws.append((name, _dets(x, y, x + 40, y + 9, [0.5 + i / 20]), {"thresh": 0.1}))
    cases["all_ascii"] = (_image(rng, 170, 160), ascii_draws)
    coco = []
    for i, name in enumerate(COCO80):
        x = 4.0 + (i % 4) * 60 + rng.uniform(-2, 2)
        y = 14.0 + (i // 4) * 15 + rng.uniform(-3, 3)
        coco.append((name, _dets([x], [y], [x + 50.5], [y + 11.5], [rng.uniform(0.55, 1)]),
                     {"thresh": 0.5}))
    cases["coco80"] = (_image(rng, 320, 250), coco)
    # tiny boxes (PIL's column stubs under 3 pixels tall), zero-area boxes
    x1, y1 = rng.uniform(0, 80, 8), rng.uniform(0, 60, 8)
    cases["tiny"] = (_image(rng), [(
        "ant", _dets(x1, y1, x1 + rng.randint(0, 4, 8), y1 + rng.randint(0, 4, 8),
                     rng.uniform(0.9, 1, 8)), {})])
    cases["no_score_column"] = (_image(rng), [(
        "box", _dets([3.5], [20.5], [40.2], [50.7], [0.0])[:, :4], {})])
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_vis_detections_matches_jax(case):
    image, draws = CASES[case]
    before = image.copy()
    want = got = image
    for name, dets, kw in draws:
        want = jvis.vis_detections(want, name, dets, **kw)
        got = tvis.vis_detections(got, name, dets, **kw)
        assert got.dtype == np.uint8 and got.shape == image.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{case}: {name}")
    np.testing.assert_array_equal(image, before)          # the input is left as it was
    assert not np.array_equal(got, image)                   # something was drawn
    if case == "twelve_boxes":
        name, dets, kw = draws[0]
        np.testing.assert_array_equal(got, jvis.vis_detections(image, name, dets[:10], **kw))
        assert not np.array_equal(got, jvis.vis_detections(image, name, dets[:11], max_boxes=11))
    if case == "at_threshold":
        name, dets, kw = draws[0]
        np.testing.assert_array_equal(got, tvis.vis_detections(image, name, dets[1:2], **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vis_detections_matches_jax_on_random_draws(seed):
    """150 random draws a seed: images from 1 × 1 to 60 × 90, boxes
    anywhere around them (fractional, at halves, whole, or 0-4 pixels
    wide), class names of printable ASCII; a box with x2 < x1 or y2 < y1
    raises the same ValueError in both."""
    rng = np.random.RandomState(100 + seed)
    chars = list(PRINTABLE)
    raised = 0
    for n in range(150):
        H, W = rng.randint(1, 60), rng.randint(1, 90)
        img = _image(rng, H, W)
        k = rng.randint(1, 6)
        kind = rng.randint(4)
        x1, y1 = rng.uniform(-30, W + 10, k), rng.uniform(-30, H + 10, k)
        w = rng.uniform(-1, 40, k) * (rng.rand(k) < 0.9)
        h = rng.uniform(-1, 40, k) * (rng.rand(k) < 0.9)
        if kind == 0:
            x1, y1 = np.round(x1 * 2) / 2, np.round(y1 * 2) / 2
        elif kind == 1:
            x1, y1 = np.round(x1), np.round(y1)
        elif kind == 2:
            w, h = rng.randint(0, 5, k).astype(float), rng.randint(0, 5, k).astype(float)
        dets = _dets(x1, y1, x1 + w, y1 + h, rng.rand(k),
                     np.float32 if rng.rand() < 0.5 else np.float64)
        name = "".join(rng.choice(chars, rng.randint(1, 8)))
        try:
            want = jvis.vis_detections(img, name, dets, thresh=0.2)
        except ValueError as e:
            with pytest.raises(ValueError, match=f"^{e}$"):
                tvis.vis_detections(img, name, dets, thresh=0.2)
            raised += 1
            continue
        np.testing.assert_array_equal(tvis.vis_detections(img, name, dets, thresh=0.2), want,
                                      err_msg=f"draw {n}: {name!r} {dets.tolist()} on {H}x{W}")
    assert 0 < raised < 75


def test_text_origin_fractions_match_jax():
    """The label's origin at fractions around PIL's rounding edges, a few
    f32 ulps either side of 31.5 / 64, 32.5 / 64 and -32.5 / 64 and of whole
    pixels, for first glyphs that overhang the pen to the left ("sx", ",")
    and that do not, and lines of each height above the baseline."""
    img = _image(np.random.RandomState(5), 40, 60)
    fracs = set()
    for edge in (31.5 / 64, 32.5 / 64, -32.5 / 64, 0.5, 1 - 1e-9, 1e-9):
        f = np.float32(edge)
        for toward in (-1.0, 1.0):
            g = f
            for _ in range(3):
                fracs.update([float(g), float(g) + 1e-10, float(g) - 1e-10])
                g = np.nextafter(g, np.float32(toward))
    for base in (-5, -2, 0, 3):
        for f in sorted(fracs):
            for name in ("dog", "sx", "_q", ",", "~a", "(A)"):
                x1 = base + f
                for y1 in (12 + abs(f), 20 + abs(f)):
                    dets = np.array([[x1, y1, x1 + 20, y1 + 10, 0.9]])
                    np.testing.assert_array_equal(
                        tvis.vis_detections(img, name, dets, thresh=0.5),
                        jvis.vis_detections(img, name, dets, thresh=0.5),
                        err_msg=f"{name!r} at ({x1!r}, {y1!r})")


def test_non_ascii_class_name_is_refused_by_name():
    img = np.zeros((20, 30, 3), np.uint8)
    dets = np.array([[2.0, 14.0, 20.0, 19.0, 0.9]])
    with pytest.raises(ValueError, match="'café'.*'é'"):
        tvis.vis_detections(img, "café", dets)
    assert jvis.vis_detections(img, "café", dets).any()      # JAX draws Aileron's é


def test_vis_image_detections_matches_jax():
    rng = np.random.RandomState(7)
    image = _image(rng, 90, 120)
    n = 30
    x1, y1 = rng.uniform(-5, 110, n), rng.uniform(-5, 80, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 40, n), y1 + rng.uniform(2, 30, n)], 1)
    boxes = boxes.astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.choice([0, 2, 3, 5, 11], n)               # 11 is past the names: "11"
    names = ["__background__", "cat", "dog", "traffic light", "person", "zebra"]
    want = jvis.vis_image_detections(image, boxes, scores, labels, names, thresh=0.3)
    got = tvis.vis_image_detections(image, boxes, scores, labels, names, thresh=0.3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, tvis.vis_image_detections(
        image, boxes, scores, np.where(labels == 11, 5, labels), names, thresh=0.3))


# ------------------------------------------------------------------- CLI


def _world(tmp_path: Path, cat_names=("cat", "dog", "traffic light"), jpeg=False):
    """Three PNG images (RGB, grey, palette) under ``images/``; the
    instances name a fourth whose file is missing, and the detections hold an
    image id the instances do not list (also missing) and a category id past
    the names."""
    rng = np.random.RandomState(3)
    root = tmp_path / "images"
    root.mkdir()
    rgb = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(root / "a.png")
    Image.fromarray(rng.randint(0, 256, (50, 70)).astype(np.uint8)).save(root / "b.png")
    Image.fromarray(rng.randint(0, 256, (64, 48, 3)).astype(np.uint8)).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=16).save(root / "c.png")
    images = [{"id": 1, "file_name": "a.png"}, {"id": 2, "file_name": "b.png"},
              {"id": 5, "file_name": "c.png"}, {"id": 6, "file_name": "gone.png"}]
    if jpeg:
        shutil.copy(ROOT / "tests" / "fixtures" / "images" / "photo_a.jpg", root / "d.jpg")
        images.append({"id": 7, "file_name": "d.jpg"})
    cats = [{"id": cid, "name": n} for cid, n in zip((1, 3, 7), cat_names)]
    anns = [{"id": i + 1, "image_id": im["id"], "category_id": 3,
             "bbox": [5.0, 6.0, 20.0, 15.0], "area": 300.0, "iscrowd": 0}
            for i, im in enumerate(images)]
    dets = []
    for im_id in [im["id"] for im in images] + [9]:
        for _ in range(8):
            x, y = rng.uniform(-4, 60), rng.uniform(-4, 45)
            dets.append({"image_id": im_id, "category_id": int(rng.choice([1, 3, 7, 12])),
                         "bbox": [x, y, rng.uniform(1, 30), rng.uniform(1, 25)],
                         "score": float(rng.uniform(0, 1))})
    (tmp_path / "gt.json").write_text(json.dumps({"images": images, "annotations": anns,
                                                  "categories": cats}))
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    return ["--detections", str(tmp_path / "dets.json"),
            "--instances-json", str(tmp_path / "gt.json")], root


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["eval_detections.py", *argv])
    runpy.run_path(str(ROOT / "scripts" / "eval_detections.py"), run_name="__main__")


def _wrote_line(text: str, vis_dir: Path) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith("wrote ")]
    assert len(lines) == 1, text
    return lines[0].replace(str(vis_dir), "VIS")


def test_cli_vis_dir_matches_jax_cli(tmp_path, monkeypatch, capsys):
    common, root = _world(tmp_path)
    jdir, tdir = tmp_path / "vis_jax", tmp_path / "vis_port"
    args = ["--image-root", str(root), "--vis-thresh", "0.3"]
    _run_jax_cli(monkeypatch, [*common, "--vis-dir", str(jdir), *args])
    jline = _wrote_line(capsys.readouterr().out, jdir)
    stats = {}
    assert TE.main([*common, "--vis-dir", str(tdir), *args, "--cpu"], stats=stats) == 0
    tline = _wrote_line(capsys.readouterr().out, tdir)
    assert tline == jline == "wrote 3 visualization(s) to VIS (2 image file(s) not found " \
        f"under {root})"
    assert (stats["vis_written"], stats["vis_missing"]) == (3, 2)
    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir()) \
        == ["1.png", "2.png", "5.png"]
    for p in jdir.iterdir():
        want = np.asarray(Image.open(p).convert("RGB"))
        got = np.asarray(Image.open(tdir / p.name))
        np.testing.assert_array_equal(got, want, err_msg=p.name)
        src = {"1.png": "a.png", "2.png": "b.png", "5.png": "c.png"}[p.name]
        assert not np.array_equal(got, np.asarray(Image.open(root / src).convert("RGB")))


def test_cli_vis_dir_needs_image_root_as_jax(tmp_path, monkeypatch, capsys):
    common, _ = _world(tmp_path)
    argv = [*common, "--vis-dir", str(tmp_path / "vis")]
    with pytest.raises(SystemExit) as jexit:
        _run_jax_cli(monkeypatch, argv)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as texit:
        TE.main(argv)
    terr = capsys.readouterr().err
    assert jexit.value.code == texit.value.code == 2
    msg = "--vis-dir needs --image-root"
    assert msg in jerr and msg in terr
    assert jerr.splitlines()[-1].split(": error: ")[1] == terr.splitlines()[-1].split(
        ": error: ")[1]


def test_cli_refuses_a_non_ascii_class_name(tmp_path):
    common, root = _world(tmp_path, cat_names=("cat", "café", "dog"))
    vis = tmp_path / "vis"
    with pytest.raises(ValueError, match="'café'.*'é'"):
        TE.main([*common, "--vis-dir", str(vis), "--image-root", str(root), "--cpu"])
    assert not list(vis.iterdir())                 # refused before any image is drawn


def test_cli_jpeg_under_cpu_raises_naming_the_file(tmp_path):
    common, root = _world(tmp_path, jpeg=True)
    with pytest.raises(ImageFormatError, match="d.jpg.*JPEG"):
        TE.main([*common, "--vis-dir", str(tmp_path / "vis"), "--image-root", str(root),
                 "--cpu"])


def test_cli_vis_dir_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--cpu`` the images decode on the card; with no card the CLI
    raises before it scores, and the mAP-only run stays on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common, root = _world(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main([*common, "--vis-dir", str(tmp_path / "vis"), "--image-root", str(root)])
    assert TE.main(common) == 0


if __name__ == "__main__":
    if "--print-atlas" in sys.argv:
        print(packed_literal(pil_atlas()))
