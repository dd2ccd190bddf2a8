"""(H, W, 3) uint8 RGB images → JPEG or PNG bytes: the port's counterpart of
the JAX package's PIL ``Image.save`` of the world generator's images
(``scripts/make_world.py:315``).

* JPEG encodes on the card with libnvjpeg's encoder (``csrc/
  nvjpeg_decode.cpp``): quality 92, 4:2:0 chroma and the standard Huffman
  tables, as PIL's defaults. The bitstream is not libjpeg's (another
  colour conversion, DCT and quantisation rounding), so neither its bytes
  nor its decoded pixels are PIL's. There is no JPEG encoder for the CPU:
  a host array or a CPU tensor raises :class:`ImageFormatError`.
* PNG encodes on the host with ``zlib``: 8-bit RGB, no interlace, filter
  None on every row. Its pixels decode back exactly (``image_decode.
  decode_png``); its bytes are not PIL's (PIL picks filters per row).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np
import torch

from style_seqcvae_tpu_torch.data.image_decode import PNG_SIGNATURE, ImageFormatError

JPEG_QUALITY = 92


def _check_rgb(shape, dtype) -> None:
    if len(shape) != 3 or shape[2] != 3 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"an image must be (H, W, 3), got {tuple(shape)}")
    if dtype not in (np.uint8, torch.uint8):
        raise ValueError(f"an image must be uint8, got {dtype}")


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB → PNG bytes (zlib level 6)."""
    rgb = np.ascontiguousarray(rgb)
    _check_rgb(rgb.shape, rgb.dtype)
    H, W, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.zeros((H, 1 + 3 * W), np.uint8)       # filter byte 0 (None) on each row
    rows[:, 1:] = rgb.reshape(H, 3 * W)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_jpeg(rgb: torch.Tensor) -> bytes:
    """(H, W, 3) uint8 RGB on a CUDA device → JPEG bytes at quality 92
    (nvjpeg, on the current stream, which it synchronises). Raises
    :class:`ImageFormatError` for a tensor that is not on the card and on a
    machine whose toolkit has no libnvjpeg."""
    if not torch.is_tensor(rgb) or rgb.device.type != "cuda":
        raise ImageFormatError("JPEG encodes on the card (libnvjpeg); the port has no JPEG "
                               "encoder for the CPU (write PNG instead)")
    _check_rgb(tuple(rgb.shape), rgb.dtype)
    from style_seqcvae_tpu_torch.ops.kernels import _build

    if not _build.nvjpeg_available():
        raise ImageFormatError("JPEG is refused: this machine's CUDA toolkit has no libnvjpeg")
    lib = _build.nvjpeg_library()
    rgb = rgb.contiguous()
    H, W, _ = rgb.shape
    # a baseline JPEG at quality 92 stays well under the raw size; the
    # binding reports the length when it does not fit, and the encode runs again
    capacity = 3 * H * W + 4096
    for _ in range(2):
        out = np.empty(capacity, np.uint8)
        length = ctypes.c_size_t(0)
        with torch.cuda.device(rgb.device):
            status = lib.ssc_jpeg_encode_rgbi(
                rgb.data_ptr(), W, H, 3 * W, JPEG_QUALITY, out.ctypes.data, capacity,
                ctypes.byref(length), torch.cuda.current_stream().cuda_stream)
        if status == 0:
            return out[:length.value].tobytes()
        if length.value <= capacity:
            break
        capacity = length.value
    raise _build.KernelError(f"nvjpeg encode failed: {lib.ssc_jpeg_status_name(status).decode()}")
