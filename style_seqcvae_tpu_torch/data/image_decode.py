"""Image files and bytes → float32 BGR HWC tensors (counterpart of the JAX
package's PIL decode: ``data/detection.py:170-176``, ``scripts/serve.py:
483-486``).

The pixels are PIL's ``Image.open(...).convert("RGB")``, channels reversed:
grey is replicated to three channels, grey + alpha and RGBA drop the alpha
without compositing, palette images are looked up in their palette (entries
past its end are black), and EXIF orientation is ignored.

* PNG (bit depths 1, 2, 4 and 8 for grey and palette images, 8 for RGB,
  grey + alpha and RGBA; all five row filters) and binary PPM / PGM (P6 /
  P5, maxval 255) decode on the host with ``zlib`` and numpy: the same
  pixels as PIL, exactly.
* JPEG decodes on the card with libnvjpeg from the CUDA toolkit
  (``csrc/nvjpeg_decode.cpp``); the image stays on the card. Its pixels are
  not libjpeg's (chroma upsampling and the IDCT differ). The port has no
  JPEG decoder for the CPU: a JPEG there raises. Each JPEG fixture of the
  tests is held to PIL's pixels within its own measured bound
  (``tests/fixtures/images/nvjpeg_bounds.json``).
* Everything else is refused by name (:class:`ImageFormatError`): 16-bit
  and interlaced PNG, CMYK, 12-bit, lossless and arithmetic-coded JPEG,
  what nvjpeg rejects, GIF, BMP, TIFF, WebP, ASCII and 16-bit PNM.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np
import torch

from style_seqcvae_tpu_torch.device import resolve_device

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → (name, channels, allowed bit depths)
_PNG_TYPES = {0: ("grey", 1, (1, 2, 4, 8)), 2: ("RGB", 3, (8,)), 3: ("palette", 1, (1, 2, 4, 8)),
              4: ("grey + alpha", 2, (8,)), 6: ("RGBA", 4, (8,))}
# magic bytes of the formats that are refused by name
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"),
                  (b"8BPS", "PSD"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"))


class ImageError(ValueError):
    """An image that the port does not decode: a refused format, or a file
    that is cut short or corrupt. Never a fault of the card."""


class ImageFormatError(ImageError):
    """A format or a feature of one that the port refuses, by name."""


class ImageDecodeError(ImageError):
    """A file of a decoded format that is cut short or corrupt."""


def sniff_format(data: bytes) -> str:
    """The format's name from the leading bytes: ``"PNG"``, ``"JPEG"``,
    ``"PPM"``, ``"PGM"``, another known format's name, or ``"unknown"``."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:2] == b"P6":
        return "PPM"
    if data[:2] == b"P5":
        return "PGM"
    if data[:2] in (b"P1", b"P2", b"P3", b"P4", b"P7"):
        return {b"P1": "ASCII PBM", b"P2": "ASCII PGM", b"P3": "ASCII PPM", b"P4": "PBM",
                b"P7": "PAM"}[data[:2]]
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


# --------------------------------------------------------------------- PNG


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ImageDecodeError(f"PNG chunk {kind!r} is cut short")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ImageDecodeError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ImageDecodeError("PNG ends before its IEND chunk")


def _unfilter(filtered: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: ``filtered`` (H, n, bpp) uint8 pixels (or
    bytes, with bpp 1, for depths below 8), ``filters`` (H,) in 0..4 → the
    reconstructed (H, n, bpp) uint8.

    Pixel (r, i) depends on its left (a), upper (b) and upper-left (c)
    neighbours, so every pixel of one anti-diagonal r + i = d depends only on
    the two diagonals before it: the image is swept in H + n - 1 vectorised
    steps, each pixel predicted by its own row's filter. PIL and libpng pick
    each row's filter adaptively, and on photos most rows come out Paeth
    (``tests/test_torch_images.py`` counts them), which a row-by-row decode
    could only reconstruct byte by byte."""
    H, n, bpp = filtered.shape
    if not filters.any():                   # every row None
        return filtered.copy()
    # zero-padded by one row above and one column to the left, flattened:
    # pixel (r, i) lies at k = (r + 1)(n + 1) + i + 1 and the pixels of one
    # diagonal lie n apart; a, b and c lie 1, n + 1 and n + 2 before k
    out = np.zeros((H + 1, n + 1, bpp), np.int16)
    x = out.copy()
    x[1:, 1:] = filtered
    ft = np.zeros((H + 1, n + 1, 1), np.int8)
    ft[1:, 1:] = filters.reshape(H, 1, 1)
    out, x, ft = out.reshape(-1, bpp), x.reshape(-1, bpp), ft.reshape(-1, 1)
    for d in range(H + n - 1):
        r0, r1 = max(0, d - n + 1), min(H - 1, d)
        k0, k1 = n + d + 2 + r0 * n, n + d + 2 + r1 * n + 1
        a, b, c = out[k0 - 1:k1 - 1:n], out[k0 - n - 1:k1 - n - 1:n], out[k0 - n - 2:k1 - n - 2:n]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ft[k0:k1:n], (0, a, b, (a + b) >> 1, paeth))
        out[k0:k1:n] = (x[k0:k1:n] + pred) & 0xFF
    return out.reshape(H + 1, n + 1, bpp)[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")``."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ImageDecodeError("PNG IHDR chunk of the wrong length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageDecodeError("PNG without an IHDR chunk")
    W, H, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _PNG_TYPES:
        raise ImageDecodeError(f"PNG colour type {ctype} does not exist")
    name, channels, depths = _PNG_TYPES[ctype]
    if depth == 16:
        raise ImageFormatError(f"16-bit PNG ({name}) is refused: only 8-bit channels decode")
    if depth not in depths:
        raise ImageDecodeError(f"PNG {name} at bit depth {depth} does not exist")
    if interlace:
        raise ImageFormatError("interlaced (Adam7) PNG is refused")
    if compression or filter_method:
        raise ImageDecodeError("PNG with an unknown compression or filter method")
    if ctype == 3 and palette is None:
        raise ImageDecodeError("palette PNG without a PLTE chunk")
    if W == 0 or H == 0:
        raise ImageDecodeError("PNG of zero width or height")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageDecodeError(f"PNG image data does not inflate: {e}") from None
    row_bytes = (W * channels * depth + 7) // 8
    if len(raw) < H * (row_bytes + 1):
        raise ImageDecodeError(f"PNG image data holds {len(raw)} bytes, "
                               f"{H * (row_bytes + 1)} expected")
    rows = np.frombuffer(raw, np.uint8, H * (row_bytes + 1)).reshape(H, row_bytes + 1)
    if (rows[:, 0] > 4).any():
        raise ImageDecodeError(f"PNG row filter {int(rows[:, 0].max())} does not exist")
    bpp = channels if depth == 8 else 1
    pix = _unfilter(rows[:, 1:].reshape(H, row_bytes // bpp, bpp), rows[:, 0])
    if depth < 8:                               # grey or palette: unpack the samples
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (pix.reshape(H, row_bytes, 1) >> shifts) & ((1 << depth) - 1)
        pix = samples.reshape(H, -1)[:, :W, None].astype(np.uint8)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:min(len(palette), 256)] = palette[:256]
        return table[pix[..., 0]]
    if ctype in (0, 4):
        grey = pix[..., 0]
        if ctype == 0 and depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


# --------------------------------------------------------------------- PNM


def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PPM (P6) or PGM (P5) bytes at maxval 255 → (H, W, 3) uint8 RGB."""
    magic = data[:2]
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":           # a comment runs to the end of its line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ImageDecodeError(f"{sniff_format(data)} header is malformed")
        fields.append(int(data[start:pos]))
    pos += 1                                    # the single whitespace before the pixels
    W, H, maxval = fields
    if maxval != 255:
        raise ImageFormatError(f"{sniff_format(data)} with maxval {maxval} is refused: "
                               "only maxval 255 decodes")
    channels = 3 if magic == b"P6" else 1
    need = W * H * channels
    if W == 0 or H == 0 or len(data) - pos < need:
        raise ImageDecodeError(f"{sniff_format(data)} data is cut short")
    pix = np.frombuffer(data, np.uint8, need, pos).reshape(H, W, channels)
    return pix.copy() if channels == 3 else np.repeat(pix, 3, axis=2)


# -------------------------------------------------------------------- JPEG


def jpeg_header(data: bytes) -> Tuple[int, int, int, int, int]:
    """(start-of-frame marker, precision, height, width, components) of a
    JPEG, read on the host; refuses what nvjpeg is not asked to decode
    (lossless, arithmetic-coded, 12-bit and CMYK / YCCK files) and a file
    with no end-of-image marker after its frame header (cut short)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ImageDecodeError("JPEG marker expected")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 10 > len(data):
                break
            precision, height, width, comps = struct.unpack(">BHHB", data[pos + 4:pos + 10])
            if marker in (0xC3, 0xC7, 0xCB, 0xCF):
                raise ImageFormatError("lossless JPEG is refused")
            if marker >= 0xC9:
                raise ImageFormatError("arithmetic-coded JPEG is refused")
            if precision != 8:
                raise ImageFormatError(f"{precision}-bit JPEG is refused: only 8-bit decodes")
            if comps == 4:
                raise ImageFormatError("CMYK / YCCK JPEG (4 components) is refused")
            if comps not in (1, 3):
                raise ImageFormatError(f"JPEG with {comps} components is refused")
            # nvjpeg decodes a cut file without a word; libjpeg refuses it
            if data.rfind(b"\xff\xd9") < pos:
                raise ImageDecodeError("JPEG is cut short: no end-of-image marker")
            return marker, precision, height, width, comps
        if marker == 0xDA:
            break
        pos += 2 + length
    raise ImageDecodeError("JPEG without a start-of-frame segment")


def decode_jpeg(data: bytes, device: torch.device) -> torch.Tensor:
    """JPEG bytes → (H, W, 3) uint8 BGR on the CUDA ``device`` (nvjpeg, on
    the current stream). Raises :class:`ImageFormatError` on the CPU, and
    on a machine whose toolkit has no libnvjpeg."""
    jpeg_header(data)
    if device.type != "cuda":
        raise ImageFormatError("JPEG decodes on the card (libnvjpeg); the port has no "
                               "JPEG decoder for the CPU")
    from style_seqcvae_tpu_torch.ops.kernels import _build

    if not _build.nvjpeg_available():
        raise ImageFormatError("JPEG is refused: this machine's CUDA toolkit has no libnvjpeg")
    lib = _build.nvjpeg_library()

    def check(status: int, what: str) -> None:
        kind = lib.ssc_jpeg_status_kind(status)
        if kind == 1:
            raise ImageFormatError(f"JPEG refused by nvjpeg ({what}: "
                                   f"{lib.ssc_jpeg_status_name(status).decode()})")
        if kind:
            raise _build.KernelError(f"nvjpeg {what} failed: "
                                     f"{lib.ssc_jpeg_status_name(status).decode()}")

    comps, css, width, height = (ctypes.c_int() for _ in range(4))
    check(lib.ssc_jpeg_info(data, len(data), ctypes.byref(comps), ctypes.byref(css),
                            ctypes.byref(width), ctypes.byref(height)), "image info")
    if comps.value not in (1, 3) or lib.ssc_jpeg_subsampling_name(css.value) == b"unknown":
        raise ImageFormatError(f"JPEG with {comps.value} components and chroma subsampling "
                               f"{lib.ssc_jpeg_subsampling_name(css.value).decode()} is refused")
    out = torch.empty((height.value, width.value, 3), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        check(lib.ssc_jpeg_decode_bgri(data, len(data), out.data_ptr(), 3 * width.value,
                                       stream.cuda_stream), "decode")
        # the host bytes must outlive nvjpeg's copies on the stream
        stream.synchronize()
    return out


# ------------------------------------------------------------------- entry


def decode_host(data: bytes) -> np.ndarray:
    """PNG or binary PPM / PGM bytes → (H, W, 3) uint8 RGB, decoded on the
    host with numpy alone (the serve CLI runs it in worker processes).
    Raises :class:`ImageFormatError` for every other format."""
    fmt = sniff_format(data)
    if fmt == "PNG":
        return decode_png(data)
    if fmt in ("PPM", "PGM"):
        return decode_pnm(data)
    raise ImageFormatError(f"{fmt} images are refused: the port decodes PNG, binary "
                           "PPM / PGM and (on the card) JPEG")


def bgr_tensor(rgb: np.ndarray, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB → (H, W, 3) float32 BGR on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(rgb[:, :, ::-1])).to(device).float()


def decode_image_bgr(data: bytes, device: Optional[Union[str, torch.device]] = None
                     ) -> torch.Tensor:
    """Image bytes → (H, W, 3) float32 BGR on ``device`` (the GPU unless
    ``"cpu"``), PIL's ``convert("RGB")`` pixels with the channels reversed.
    Raises :class:`ImageFormatError` for a refused format and
    :class:`ImageDecodeError` for a corrupt file."""
    dev = resolve_device(device)
    data = bytes(data)
    if sniff_format(data) == "JPEG":
        return decode_jpeg(data, dev).float()
    return bgr_tensor(decode_host(data), dev)
