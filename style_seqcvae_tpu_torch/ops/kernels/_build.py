"""Build the port's CUDA kernels at first use and bind them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into
``build/torch_kernels/<hash of the sources>/libssc_kernels.so`` under the
repository root. The sources expose a plain C interface: no PyTorch headers,
so a build takes seconds. The library is written under a temporary name and
moved into place with ``os.replace``, so a build that is cut leaves nothing
that a later process would load.

``csrc/nvjpeg_decode.cpp``, the binding of the toolkit's JPEG decoder, is
built the same way into a library of its own,
``build/torch_kernels/nvjpeg-<hash>/libssc_nvjpeg.so`` (:func:`build_nvjpeg`),
so that a machine without libnvjpeg still builds kernels A-D.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libssc_kernels.so"
NVJPEG_SOURCE = CSRC / "nvjpeg_decode.cpp"
NVJPEG_LIB_NAME = "libssc_nvjpeg.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """A kernel could not be built (no nvcc, a compile or link error) or a
    launch reported a CUDA error. Callers that fall back on other work let
    this one through: it means the card's code is at fault."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = cuda_home() / "bin" / "nvcc"
    if not path.exists():
        raise KernelError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")
    return str(path)


def _sources() -> List[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _compile(units: List[Path], out: Path, link_flags: List[str]) -> Path:
    """nvcc on each of ``units`` (all started together), then one link into
    ``out``; nvcc's messages go to ``build.log`` beside it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in units:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            so, se = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{so}{se}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs), *link_flags], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (out.parent / "build.log").write_text("\n".join(logs))
        os.replace(tmp_lib, out)
    return out


def build() -> Path:
    """Compile and link the kernels' library unless it is already built;
    returns its path. nvcc's messages (``-Xptxas -v``: registers, shared
    memory, spills) are kept beside it in ``build.log``. Raises
    :class:`KernelError` with nvcc's stderr on failure."""
    out = library_path()
    if out.exists():
        return out
    return _compile([p for p in _sources() if p.suffix == ".cu"], out, [])


def cuda_home() -> Path:
    """The CUDA toolkit's root: ``CUDA_HOME``, ``CUDA_PATH``, the directory
    above ``nvcc`` on ``PATH``, else ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return Path(home)
    found = shutil.which("nvcc")
    return Path(found).resolve().parents[1] if found else Path("/usr/local/cuda")


def nvjpeg_available() -> bool:
    """Whether the toolkit has nvjpeg's header and library."""
    home = cuda_home()
    libs = [d for d in (home / "lib64", home / "targets" / "x86_64-linux" / "lib") if d.is_dir()]
    return (home / "include" / "nvjpeg.h").exists() and \
        any(next(d.glob("libnvjpeg.so*"), None) for d in libs)


def build_nvjpeg() -> Path:
    """Compile and link ``csrc/nvjpeg_decode.cpp`` against libnvjpeg into
    its own library unless it is already built; returns its path."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode() + NVJPEG_SOURCE.read_bytes())
    out = BUILD_ROOT / f"nvjpeg-{h.hexdigest()[:16]}" / NVJPEG_LIB_NAME
    if out.exists():
        return out
    home = cuda_home()
    rpath = f"{home / 'lib64'}:{home / 'targets' / 'x86_64-linux' / 'lib'}"
    return _compile([NVJPEG_SOURCE], out, ["-lnvjpeg", "-Xlinker", f"-rpath,{rpath}"])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    # (x, emb, vals, idx, lse, R, V, E, k, stream)
    lib.ssc_vocab_topk_lse_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.ssc_vocab_topk_lse_f32.restype = i
    # (x, emb, vals, idx, lse, scratch, R, V, E, k, stream)
    lib.ssc_vocab_topk_lse_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.ssc_vocab_topk_lse_bf16.restype = i
    # (R, V, E, k, out[5]): blocks, segments, stages, smem bytes, scratch bytes
    lib.ssc_vocab_topk_lse_bf16_plan.argtypes = [i, i, i, i, p]
    lib.ssc_vocab_topk_lse_bf16_plan.restype = i
    # (logits, vals, idx, lse, R, V, k, is_bf16, stream)
    lib.ssc_topk_lse.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.ssc_topk_lse.restype = i
    f = ctypes.c_float
    # (feat, rois, out, B, H, W, C, R, spatial_scale, pooled, sampling, is_bf16, stream)
    lib.ssc_roi_align.argtypes = [p, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.ssc_roi_align.restype = i
    # (boxes, mask, G, N, threshold, stream)
    lib.ssc_nms_bitmask.argtypes = [p, p, i, i, f, p]
    lib.ssc_nms_bitmask.restype = i
    # (mask, order, keep_idx, keep_mask, G, N, out_len, stream)
    lib.ssc_nms_scan.argtypes = [p, p, p, p, i, i, i, p]
    lib.ssc_nms_scan.restype = i
    lib.ssc_nms_scan_smem_bytes.argtypes = [i]
    lib.ssc_nms_scan_smem_bytes.restype = i
    lib.ssc_error_string.argtypes = [i]
    lib.ssc_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


_nvjpeg_lib: Optional[ctypes.CDLL] = None


def nvjpeg_library() -> ctypes.CDLL:
    """The bound nvjpeg binding, built on first call in this process."""
    global _nvjpeg_lib
    with _lock:
        if _nvjpeg_lib is None:
            lib = ctypes.CDLL(str(build_nvjpeg()))
            p, i = ctypes.c_void_p, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            # (data, length, components, subsampling, width, height)
            lib.ssc_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip, ip, ip]
            lib.ssc_jpeg_info.restype = i
            # (data, length, out, pitch, stream)
            lib.ssc_jpeg_decode_bgri.argtypes = [ctypes.c_char_p, ctypes.c_size_t, p, i, p]
            lib.ssc_jpeg_decode_bgri.restype = i
            lib.ssc_jpeg_status_kind.argtypes = [i]
            lib.ssc_jpeg_status_kind.restype = i
            for name in ("ssc_jpeg_status_name", "ssc_jpeg_subsampling_name"):
                getattr(lib, name).argtypes = [i]
                getattr(lib, name).restype = ctypes.c_char_p
            _nvjpeg_lib = lib
        return _nvjpeg_lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise :class:`KernelError` if a launch reported a CUDA error
    (``cudaGetLastError``)."""
    if rc != 0:
        raise KernelError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.ssc_error_string(rc).decode()})")
