"""The port's image decoding and detection inputs (``data/image_decode.py``,
``data/detection.py``) against the JAX package, on the CPU.

PNG (every mode PIL writes, every row filter, PIL's own photo PNGs) and
binary PPM / PGM decode
to exactly the pixels of JAX's ``load_image_bgr`` (PIL). JPEG decodes only
on the card (``tests/test_torch_cuda.py``); here it must raise, as every
refused format must, naming the format. ``prepare_image`` is held to
``prepare_image_np`` within 1e-4, and ``canvas_for``, ``make_batch`` and
``CocoDetectionDataset``'s records must be equal.
"""

import io
import json
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, JpegImagePlugin

from style_seqcvae_tpu.data import detection as jdet
from style_seqcvae_tpu_torch.data import detection as tdet
from style_seqcvae_tpu_torch.data import image_decode as idec
from tests.test_torch_data import attribute_images, write_attribs_dir

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
# prepare_image sums its taps in float64 as numpy does; only the final cast
# to float32 and the mean subtraction's rounding remain (~1e-5 at 255)
PREPARE_ATOL = 1e-4
CATEGORIES = ["dog", "cat", "car", "table"]


def picture(h, w, seed):
    """A seeded photo-like uint8 RGB picture: gradients, noise, a block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h, (x * 3 + y * 5) % 256], -1)
    img = img + rng.randn(h, w, 3) * 18
    img[h // 4:h // 2, w // 3:w // 2] = rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def png_bytes(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(samples: np.ndarray, ctype: int, depth: int, filters, palette=None,
               interlace=0) -> bytes:
    """A PNG written here with the given row filter for each row (cycled),
    so that all five filters are decoded: samples (H, W, channels) uint8
    at ``depth`` bits (packed below 8)."""
    H, W, C = samples.shape
    if depth < 8:
        per = 8 // depth
        pad = (-W) % per
        s = np.pad(samples[..., 0], ((0, 0), (0, pad))).reshape(H, -1, per)
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (s << shifts).sum(-1).astype(np.uint8)
        bpp = 1
    else:
        rows = samples.reshape(H, W * C)
        bpp = C
    rows = rows.astype(np.int32)
    out, prev = [], np.zeros_like(rows[0])
    for r in range(H):
        ft = filters[r % len(filters)]
        cur = rows[r]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (idec.PNG_SIGNATURE + body + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


def _pil_bgr(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)[:, :, ::-1]


def _modes():
    a = picture(37, 53, 0)
    return {
        "L": Image.fromarray(a[..., 0]),
        "LA": Image.fromarray(a[..., :2], "LA"),
        "RGB": Image.fromarray(a),
        "RGBA": Image.fromarray(np.concatenate([a, a[..., :1]], -1), "RGBA"),
        "P": Image.fromarray(a).quantize(200),
        "P_4bit": Image.fromarray(a).quantize(12),
        "P_2bit": Image.fromarray(a).quantize(4),
        "1": Image.fromarray(a[..., 0] > 128),
    }


@pytest.mark.parametrize("mode", sorted(_modes()))
def test_png_modes_equal_jax_load_image_bgr(tmp_path, mode):
    path = tmp_path / f"{mode}.png"
    _modes()[mode].save(path)
    want = jdet.load_image_bgr(str(path))
    got = tdet.load_image_bgr(str(path), device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdet.decode_image_bgr(path.read_bytes(), "cpu").numpy(), want)


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "rgba8", "palette2", "grey4"])
def test_png_all_five_filters_equal_pil(kind):
    rng = np.random.RandomState(1)
    a = picture(23, 31, 2)
    filters = [0, 1, 2, 3, 4, 4, 3, 1]
    palette = None
    if kind == "rgb8":
        data = encode_png(a, 2, 8, filters)
    elif kind == "grey8":
        data = encode_png(a[..., :1], 0, 8, filters)
    elif kind == "rgba8":
        data = encode_png(np.concatenate([a, a[..., :1]], -1), 6, 8, filters)
    elif kind == "palette2":
        palette = rng.randint(0, 256, (3, 3))      # index 3 lies past the palette: black
        data = encode_png(a[..., :1] % 4, 3, 2, filters, palette=palette)
    else:
        data = encode_png(a[..., :1] % 16, 0, 4, filters)
    np.testing.assert_array_equal(idec.decode_png(data)[:, :, ::-1], _pil_bgr(data))
    np.testing.assert_array_equal(tdet.decode_image_bgr(data, "cpu").numpy(), _pil_bgr(data))


def test_ppm_and_pgm_equal_pil():
    a = picture(19, 29, 3)
    ppm = b"P6\n# a comment\n29 19\n255\n" + a.tobytes()
    pgm = b"P5 29\n19 255\n" + a[..., 0].tobytes()
    for data in (ppm, pgm):
        np.testing.assert_array_equal(tdet.decode_image_bgr(data, "cpu").numpy(), _pil_bgr(data))
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PPM")
    np.testing.assert_array_equal(tdet.decode_image_bgr(buf.getvalue(), "cpu").numpy(),
                                  _pil_bgr(buf.getvalue()))


def _other_formats():
    a = picture(16, 20, 4)
    out = {}
    for fmt, name in (("GIF", "GIF"), ("BMP", "BMP"), ("TIFF", "TIFF")):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt)
        out[name] = buf.getvalue()
    out["16-bit PNG"] = png_bytes(Image.fromarray((a[..., 0].astype(np.uint16) * 257), "I;16"))
    out["interlaced"] = encode_png(a, 2, 8, [0], interlace=1)
    out["ASCII PPM"] = b"P3\n1 1\n255\n0 0 0\n"
    out["maxval 65535"] = b"P5\n1 1\n65535\n\x00\x00"
    out["unknown"] = b"not an image at all"
    return out


@pytest.mark.parametrize("name", sorted(_other_formats()))
def test_refused_formats_raise_by_name(name):
    with pytest.raises(idec.ImageFormatError, match=name.split()[0]):
        tdet.decode_image_bgr(_other_formats()[name], "cpu")


def test_jpeg_on_the_cpu_raises_and_refusals_by_name():
    data = (FIXTURES / "rgb420.jpg").read_bytes()
    with pytest.raises(idec.ImageFormatError, match="JPEG.*card"):
        tdet.decode_image_bgr(data, "cpu")
    buf = io.BytesIO()
    Image.fromarray(picture(16, 16, 5)).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(idec.ImageFormatError, match="CMYK"):
        tdet.decode_image_bgr(buf.getvalue(), "cpu")
    with pytest.raises(idec.ImageDecodeError, match="cut short"):
        tdet.decode_image_bgr(data[:len(data) // 2], "cpu")
    assert idec.jpeg_header(data)[2:] == (60, 84, 3)


def test_corrupt_png_raises():
    data = bytearray(png_bytes(Image.fromarray(picture(16, 16, 6))))
    with pytest.raises(idec.ImageDecodeError):
        tdet.decode_image_bgr(bytes(data[:len(data) // 2]), "cpu")
    data[40] ^= 0xFF                                # inside IDAT: the CRC fails
    with pytest.raises(idec.ImageDecodeError, match="CRC"):
        tdet.decode_image_bgr(bytes(data), "cpu")


def _png_filters(data: bytes) -> np.ndarray:
    """Each row's filter type of an 8-bit, non-interlaced PNG."""
    header = raw = b""
    for kind, body in idec._png_chunks(data):
        header = body if kind == b"IHDR" else header
        raw += body if kind == b"IDAT" else b""
    H = struct.unpack(">IIBBBBB", header)[1]
    return np.frombuffer(zlib.decompress(raw), np.uint8).reshape(H, -1)[:, 0]


@pytest.mark.parametrize("name", ["photo_a", "photo_b"])
def test_pil_photo_pngs_are_mostly_paeth_and_decode_exactly(name):
    """The premise of the PNG decoder's anti-diagonal sweep: PIL (as libpng)
    filters each row adaptively, and on the 480 x 640 photos most rows come
    out Paeth or Average, which only a sequential reconstruction undoes. The
    committed ``photo_a.png`` is PIL's PNG of ``photo_a.npy``."""
    rgb = np.load(FIXTURES / f"{name}.npy")
    data = png_bytes(Image.fromarray(rgb))
    mix = np.bincount(_png_filters(data), minlength=5)
    assert mix[3] + mix[4] >= 0.5 * rgb.shape[0], mix
    np.testing.assert_array_equal(idec.decode_png(data), rgb)
    if name == "photo_a":
        committed = (FIXTURES / "photo_a.png").read_bytes()
        np.testing.assert_array_equal(np.asarray(Image.open(FIXTURES / "photo_a.png")), rgb)
        assert (_png_filters(committed) >= 3).mean() >= 0.5
        np.testing.assert_array_equal(tdet.decode_image_bgr(committed, "cpu").numpy(),
                                      rgb[:, :, ::-1].astype(np.float32))


def test_jpeg_fixtures_hold_pil_decodes():
    """The committed ``.npy`` beside each JPEG fixture is PIL's decode of it
    (``tests/fixtures/images/make_fixtures.py``): the card's tests hold
    nvjpeg's pixels against these."""
    bounds = json.loads((FIXTURES / "nvjpeg_bounds.json").read_text())["fixtures"]
    assert sorted(bounds) == sorted(p.stem for p in FIXTURES.glob("*.jpg"))
    for jpg in sorted(FIXTURES.glob("*.jpg")):
        im = Image.open(jpg)
        want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(np.load(jpg.with_suffix(".npy")), want)
        # the subsampling each fixture's bound was measured at
        css = "grey" if im.mode == "L" else {0: "4:4:4", 2: "4:2:0"}[
            JpegImagePlugin.get_sampling(im)]
        assert bounds[jpg.stem]["subsampling"] == css


@pytest.mark.parametrize("hw,target,max_size", [((72, 96), 96, 128), ((96, 72), 96, 128),
                                                ((50, 210), 60, 150), ((61, 47), 80, 1000)])
def test_prepare_image_matches_jax(hw, target, max_size):
    img = picture(*hw, 7)[:, :, ::-1].astype(np.float32)
    want, want_scale = jdet.prepare_image_np(img, target, max_size)
    got, scale = tdet.prepare_image(torch.from_numpy(img.copy()), target, max_size)
    assert scale == want_scale and got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREPARE_ATOL)


def write_detection_world(root: Path, n_images: int = 48, hw=(72, 96), seed: int = 0,
                          portrait: int = 0, corrupt=()):
    """A COCO detection world written with PIL: ``n_images`` PNGs (the
    first ``portrait`` transposed, those at the indices ``corrupt`` cut
    short), an
    instances JSON whose annotation ids are the COCO-Attributes object
    instances of ``write_attribs_dir`` (objects of ``attribute_images``),
    one crowd annotation, and a Senticap JSON whose test split holds the
    second image. Returns (instances path, image root, attribs dir, Senticap
    path)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    objects = attribute_images(n_images, seed)
    attribs = write_attribs_dir(root / "attribs", objects)
    rng = np.random.RandomState(seed)
    images, anns, ann_id = [], [], 0
    for k, (iid, objs) in enumerate(objects.items()):
        h, w = hw[::-1] if k < portrait else hw
        name = f"{iid}.png"
        data = png_bytes(Image.fromarray(picture(h, w, seed * 1000 + k)))
        if k in corrupt:
            data = data[:len(data) // 3]
        (root / "images" / name).write_bytes(data)
        images.append({"id": iid, "file_name": name, "width": w, "height": h})
        for obj, _ in objs:
            ann_id += 1
            x, y = rng.uniform(-4, w * 0.6), rng.uniform(-4, h * 0.6)
            bw, bh = rng.uniform(8, w * 0.6), rng.uniform(8, h * 0.6)
            anns.append({"id": ann_id, "image_id": iid, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "category_id": CATEGORIES.index(obj) + 1})
    anns.append({"id": 10 ** 6, "image_id": images[0]["id"], "bbox": [0, 0, 10, 10],
                 "area": 100, "iscrowd": 1, "category_id": 1})
    inst = {"images": images, "annotations": anns,
            "categories": [{"id": i + 1, "name": n} for i, n in enumerate(CATEGORIES)]}
    (root / "instances.json").write_text(json.dumps(inst))
    senti = {"images": [{"filename": f"COCO_val2014_{images[1]['id']:012d}.jpg",
                         "split": "test",
                         "sentences": [{"raw": "a nice dog", "sentiment": 1}]}]}
    (root / "senticap.json").write_text(json.dumps(senti))
    return (str(root / "instances.json"), str(root / "images"), attribs,
            str(root / "senticap.json"))


def test_coco_detection_dataset_records_equal_jax(tmp_path):
    inst, image_root, attribs, senti = write_detection_world(tmp_path, portrait=3)
    # a second json: one image again (first-json-wins) and a new one
    data = json.loads(Path(inst).read_text())
    extra = {"images": [data["images"][0], dict(data["images"][2], id=999)],
             "annotations": [dict(data["annotations"][0], id=77),
                             dict(data["annotations"][3], id=78, image_id=999)],
             "categories": data["categories"]}
    (tmp_path / "extra.json").write_text(json.dumps(extra))
    for paths in (inst, [inst, str(tmp_path / "extra.json")]):
        for exclude in (True, False):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                want = jdet.CocoDetectionDataset(paths, image_root, senti, attribs,
                                                 exclude_senticap_test=exclude)
                n_want = len(seen)
                got = tdet.CocoDetectionDataset(paths, image_root, senti, attribs,
                                                exclude_senticap_test=exclude)
            # the union's first-json-wins skip is reported on both sides
            assert len(seen) == 2 * n_want and n_want == (not isinstance(paths, str))
            assert got.classes == want.classes and got.n_attribs == want.n_attribs > 0
            assert got.image_ids == want.image_ids and got.ann_atts == want.ann_atts != {}
            np.testing.assert_array_equal(got.att_counts, want.att_counts)
            for i in range(len(want)):
                a, b = got.record(i), want.record(i)
                assert a.keys() == b.keys()
                for key in a:
                    np.testing.assert_array_equal(np.asarray(a[key], dtype=object),
                                                  np.asarray(b[key], dtype=object), err_msg=key)
    excluded = tdet.CocoDetectionDataset(inst, image_root, senti, attribs)
    assert json.loads(Path(inst).read_text())["images"][1]["id"] not in excluded.image_ids


def test_canvas_for_and_make_batch_equal_jax(tmp_path):
    inst, image_root, attribs, _ = write_detection_world(tmp_path, portrait=2)
    ds = jdet.CocoDetectionDataset(inst, image_root, "", attribs)
    recs = [ds.record(i) for i in range(4)]
    for canvas in ((96, 128), (128, 96)):
        assert [tdet.canvas_for(r, canvas) for r in recs] == \
            [jdet.canvas_for(r, canvas) for r in recs]
    imgs, scales, timgs = [], [], []
    for r in recs:
        img = jdet.load_image_bgr(r["file_name"])
        p, s = jdet.prepare_image_np(img, 96, 128)
        imgs.append(p)
        scales.append(s)
        timgs.append(torch.from_numpy(p))
    want = jdet.make_batch(recs, imgs, scales, (96, 128), 5, ds.n_attribs)
    got = tdet.make_batch(recs, timgs, scales, (96, 128), 5, ds.n_attribs)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert want["num_gt"].sum() > 0 and want["gt_atts"].sum() > 0
