"""features.h5, the detector -> captioner interface (counterpart of
``style_seqcvae_tpu/utils/features_io.py:1-156``), without h5py.

The schema is the reference writer's (frcnn/test_net.py:297-306, :538-542):
vlen datasets ``features`` (flattened num_boxes x 2048 float32),
``obj_atts`` (uint8 packed stream: obj_id, then attr_id + 100 per attribute)
and ``obj_atts_det`` (float32 packed: obj_id, then attr_id + 100 and its
score for scores > 0.3), plus ``image_id`` and ``num_boxes`` int64 scalars
per image.

The packers and unpackers are copies of the JAX module's pure-Python ones
(``:23-75``). :class:`FeaturesReader` and :class:`FeaturesWriter` keep the
JAX classes' contracts (``:78-156``) over :class:`H5File`, a minimal HDF5
reader written from the HDF5 file format specification for exactly the
structures that h5py writes for this schema with its default settings:

* superblock version 0, 8-byte offsets and lengths;
* the root group as a symbol table (a version 1 B-tree, a local heap and
  SNOD nodes);
* version 1 object headers (continuation blocks followed);
* contiguous storage (an undefined address reads as the fill value);
* little-endian fixed-point and IEEE floating-point datatypes, and
  variable-length sequences of them, whose elements live in global heap
  collections.

Anything else raises ``ValueError`` naming what was found: another
superblock version, a chunked, compact or filtered dataset, link messages
or dense link storage, another datatype. :class:`FeaturesWriter` writes the
same structures, so that h5py and the JAX reader read its files.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pack_obj_atts(obj_ids: Sequence[int], att_lists: Sequence[Sequence[int]]) -> np.ndarray:
    """GT packing (test_net.py:520-527): [obj_id, att+100, att+100, ...]
    per box, concatenated. uint8 — attribute ids must be < 156."""
    out: List[int] = []
    for obj, atts in zip(obj_ids, att_lists):
        out.append(int(obj))
        for a in atts:
            out.append(int(a) + 100)
    return np.asarray(out, np.uint8)


def pack_obj_atts_det(obj_ids: Sequence[int], att_scores: np.ndarray,
                      thresh: float = 0.3) -> np.ndarray:
    """Detected packing (test_net.py:529-535): [obj_id, att+100, score, ...]
    float32."""
    out: List[float] = []
    for i, obj in enumerate(obj_ids):
        out.append(float(obj))
        idx = np.where(np.asarray(att_scores[i]) > thresh)[0]
        for a in idx:
            out.append(float(a) + 100.0)
            out.append(float(att_scores[i][a]))
    return np.asarray(out, np.float32)


def unpack_obj_atts(stream: np.ndarray) -> List[List]:
    """Inverse of pack_obj_atts — reader semantics of
    updown-baseline/updown/data/readers.py:70-82: [[obj, [[att, 1],…]], …]."""
    result: List[List] = []
    k = 0
    stream = np.asarray(stream)
    while k < len(stream):
        if stream[k] < 100:
            result.append([int(stream[k]), []])
        else:
            result[-1][1].append([int(stream[k]) - 100, 1])
        k += 1
    return result


def unpack_obj_atts_det(stream: np.ndarray) -> List[List]:
    """readers.py:96-111: [[obj, [[att, score],…]], …]."""
    result: List[List] = []
    k = 0
    stream = np.asarray(stream)
    while k < len(stream):
        if stream[k] < 100:
            result.append([int(stream[k]), []])
            k += 1
        else:
            result[-1][1].append([int(stream[k]) - 100, float(stream[k + 1])])
            k += 2
    return result


# ------------------------------------------------------------- HDF5 format

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
# H5HL_FREE_NULL: a local heap with no free block
_HEAP_FREE_NULL = 1
# the group B-tree's and the symbol-table node's K, as h5py's defaults
# write them into the superblock
_GROUP_INTERNAL_K, _GROUP_LEAF_K = 16, 4
_GCOL_MIN_SIZE = 4096
# object header message types
_MSG_NIL, _MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE = 0x00, 0x01, 0x02, 0x03
_MSG_FILL, _MSG_LINK, _MSG_LAYOUT, _MSG_GROUP_INFO = 0x05, 0x06, 0x08, 0x0A
_MSG_FILTERS, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x0B, 0x10, 0x11
_MSG_KEPT = {_MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL, _MSG_LAYOUT, _MSG_SYMBOL_TABLE,
             _MSG_LINK_INFO, _MSG_LINK, _MSG_GROUP_INFO}
# messages a reader of this schema may pass over: padding, the old fill
# value, attributes, a comment, modification times, B-tree K values,
# attribute info, a reference count
_MSG_IGNORED = {_MSG_NIL, 0x04, 0x0C, 0x0D, 0x0E, 0x12, 0x13, 0x16, 0x17}
# the root group's messages of a group that is not a symbol table
_MSG_NEW_GROUP = {_MSG_LINK_INFO: "link info (new-style or dense link storage)",
                  _MSG_LINK: "link (compact link storage)",
                  _MSG_GROUP_INFO: "group info (new-style group)"}
_VLEN_ELEMENT = 16          # sequence length (4), collection address (8), object index (4)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _dtype_message(dt: np.dtype) -> bytes:
    """A version 1 datatype message for the schema's element types: a
    little-endian integer, or an IEEE float32."""
    if dt.kind in "iu":
        flags = 0x08 if dt.kind == "i" else 0x00
        return struct.pack("<B3BIHH", 0x10, flags, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt == np.float32:
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32, 23, 8, 0, 23, 127)
    raise ValueError(f"no HDF5 datatype for {dt}")


def _parse_dtype(buf: bytes, off: int) -> Tuple[Tuple[str, np.dtype], int]:
    """(("fixed" or "vlen", numpy dtype of the element or the sequence's
    base), end offset) of the datatype message at ``buf[off:]``."""
    cv, b0, b1, b2, size = struct.unpack_from("<B3BI", buf, off)
    cls, ver = cv & 0x0F, cv >> 4
    if ver not in (1, 2, 3):
        raise ValueError(f"datatype message version {ver}")
    if cls == 0:                                            # fixed-point
        bit_off, prec = struct.unpack_from("<HH", buf, off + 8)
        if b0 & 0x01 or bit_off != 0 or prec != 8 * size or size not in (1, 2, 4, 8):
            raise ValueError(f"fixed-point datatype not a plain little-endian integer "
                             f"(flags {b0:#x}, size {size}, offset {bit_off}, precision {prec})")
        return ("fixed", np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}")), off + 12
    if cls == 1:                                            # floating point
        got = struct.unpack_from("<HHBBBBI", buf, off + 8)
        want = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}.get(size)
        if b0 & 0x41 or got != want or b1 != 8 * size - 1:
            raise ValueError(f"floating-point datatype not IEEE little-endian "
                             f"(flags {b0:#x} {b1}, size {size}, fields {got})")
        return ("fixed", np.dtype(f"<f{size}")), off + 20
    if cls == 9:                                            # variable length
        if b0 & 0x0F != 0:
            raise ValueError("variable-length string datatype")
        if size != _VLEN_ELEMENT:
            raise ValueError(f"variable-length datatype of size {size}")
        (kind, base), end = _parse_dtype(buf, off + 8)
        if kind != "fixed":
            raise ValueError("variable-length sequence of variable-length sequences")
        return ("vlen", base), end
    raise ValueError(f"datatype class {cls} (only integers, floats and "
                     "variable-length sequences of them are read)")


class H5Dataset:
    """One 1-D dataset of an :class:`H5File`: ``len``, ``ds[i]`` (a numpy
    scalar, or an array for a variable-length element) and ``read()`` (a
    fixed-type dataset whole)."""

    def __init__(self, f: "H5File", name: str, messages: Dict[int, bytes]):
        self._f, self.name = f, name
        for t in (_MSG_DATASPACE, _MSG_DATATYPE, _MSG_LAYOUT):
            if t not in messages:
                raise ValueError(f"dataset {name!r} has no message of type {t:#x}")
        space = messages[_MSG_DATASPACE]
        ver, rank = space[0], space[1]
        if ver == 1:
            dims_at = 8
        elif ver == 2:
            if space[3] != 1:
                raise ValueError(f"dataset {name!r}: dataspace type {space[3]} (not simple)")
            dims_at = 4
        else:
            raise ValueError(f"dataset {name!r}: dataspace message version {ver}")
        if rank != 1:
            raise ValueError(f"dataset {name!r} has rank {rank}; the schema's are 1-D")
        (self.length,) = struct.unpack_from("<Q", space, dims_at)
        (self.kind, self.dtype), _ = _parse_dtype(messages[_MSG_DATATYPE], 0)
        layout = messages[_MSG_LAYOUT]
        if layout[0] not in (3, 4):
            raise ValueError(f"dataset {name!r}: data layout message version {layout[0]}")
        if layout[1] != 1:
            what = {0: "compact", 2: "chunked", 3: "virtual"}.get(layout[1], str(layout[1]))
            raise ValueError(f"dataset {name!r}: {what} layout (only contiguous is read)")
        self._addr, size = struct.unpack_from("<QQ", layout, 2)
        itemsize = _VLEN_ELEMENT if self.kind == "vlen" else self.dtype.itemsize
        if self._addr != _UNDEF and size != self.length * itemsize:
            raise ValueError(f"dataset {name!r}: {size} bytes of storage for "
                             f"{self.length} elements of {itemsize}")
        self._itemsize = itemsize
        self._check_fill(messages.get(_MSG_FILL))

    def _check_fill(self, msg: Optional[bytes]) -> None:
        """Storage never written reads as the fill value: the library's
        default, zeros. A fill value of the writer's own raises."""
        if msg is None:
            return
        ver, n = msg[0], 0
        if ver in (1, 2) and (ver == 1 or msg[3]):
            (n,) = struct.unpack_from("<I", msg, 4)
        elif ver == 3 and msg[1] & 0x20:
            (n,) = struct.unpack_from("<I", msg, 2)
        elif ver not in (1, 2, 3):
            raise ValueError(f"dataset {self.name!r}: fill value message version {ver}")
        if n:
            raise ValueError(f"dataset {self.name!r} defines a fill value of its own")

    def __len__(self) -> int:
        return self.length

    def _raw(self, start: int, count: int) -> bytes:
        if self._addr == _UNDEF:
            return bytes(count * self._itemsize)
        return self._f.pread(self._addr + start * self._itemsize, count * self._itemsize)

    def __getitem__(self, i: int):
        i = int(i)
        if not 0 <= i < self.length:
            raise IndexError(f"index {i} out of range for {self.name!r} of {self.length}")
        raw = self._raw(i, 1)
        if self.kind == "fixed":
            return np.frombuffer(raw, self.dtype)[0]
        n, addr, idx = struct.unpack("<IQI", raw)
        if n == 0:
            return np.zeros((0,), self.dtype)
        data = self._f.heap_object(addr, idx)
        if len(data) < n * self.dtype.itemsize:
            raise ValueError(f"{self.name!r}[{i}]: heap object of {len(data)} bytes "
                             f"for {n} elements")
        return np.frombuffer(data, self.dtype, count=n).copy()

    def read(self) -> np.ndarray:
        """The whole of a fixed-type dataset."""
        if self.kind != "fixed":
            raise ValueError(f"{self.name!r} is variable-length: read it element by element")
        return np.frombuffer(self._raw(0, self.length), self.dtype).copy()


class H5File:
    """Minimal read-only HDF5 file: the root group's datasets by name
    (``in``, ``[]``, ``keys()``). See the module docstring for what it reads."""

    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._gcol: Dict[int, Dict[int, Tuple[int, int]]] = {}
            self._datasets: Dict[str, H5Dataset] = {}
            self._links = self._read_root()
        except BaseException:
            os.close(self._fd)
            raise

    def pread(self, addr: int, n: int) -> bytes:
        data = os.pread(self._fd, n, addr)
        if len(data) != n:
            raise ValueError(f"file ends before {n} bytes at {addr}")
        return data

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "H5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _read_root(self) -> Dict[str, int]:
        sb = self.pread(0, 96)
        if sb[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file (signature not at offset 0)")
        if sb[8] != 0:
            raise ValueError(f"superblock version {sb[8]} (only version 0 is read)")
        if sb[13] != 8 or sb[14] != 8:
            raise ValueError(f"{sb[13]}-byte offsets and {sb[14]}-byte lengths (8 and 8 are read)")
        base, = struct.unpack_from("<Q", sb, 24)
        if base != 0:
            raise ValueError(f"superblock base address {base}")
        root_header, = struct.unpack_from("<Q", sb, 64)
        msgs = self._object_header(root_header)
        for t, what in _MSG_NEW_GROUP.items():
            if t in msgs:
                raise ValueError(f"root group holds a {what} message: link storage other "
                                 "than a symbol table")
        if _MSG_SYMBOL_TABLE not in msgs:
            raise ValueError("root group has no symbol table message")
        btree, heap = struct.unpack_from("<QQ", msgs[_MSG_SYMBOL_TABLE], 0)
        hdr = self.pread(heap, 32)
        if hdr[:4] != b"HEAP" or hdr[4] != 0:
            raise ValueError("root group's local heap not found (HEAP, version 0)")
        seg_size, _, seg_addr = struct.unpack_from("<QQQ", hdr, 8)
        names = self.pread(seg_addr, seg_size)
        links: Dict[str, int] = {}
        self._walk_group_btree(btree, names, links)
        return links

    def _walk_group_btree(self, addr: int, names: bytes, links: Dict[str, int]) -> None:
        node = self.pread(addr, 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise ValueError("group B-tree node not found (TREE, type 0)")
        level, used = node[5], struct.unpack_from("<H", node, 6)[0]
        body = self.pread(addr + 24, used * 16 + 8)
        for j in range(used):
            (child,) = struct.unpack_from("<Q", body, 8 + 16 * j)
            if level > 0:
                self._walk_group_btree(child, names, links)
                continue
            snod = self.pread(child, 8)
            if snod[:4] != b"SNOD" or snod[4] != 1:
                raise ValueError("symbol table node not found (SNOD, version 1)")
            (count,) = struct.unpack_from("<H", snod, 6)
            entries = self.pread(child + 8, 40 * count)
            for e in range(count):
                name_off, header, cache = struct.unpack_from("<QQI", entries, 40 * e)
                name = names[name_off:names.index(b"\0", name_off)].decode()
                if cache == 2:
                    raise ValueError(f"{name!r} is a symbolic link")
                links[name] = header

    def _object_header(self, addr: int) -> Dict[int, bytes]:
        """{message type: data} of a version 1 object header; raises on a
        message this reader does not know."""
        head = self.pread(addr, 16)
        if head[0] != 1:
            raise ValueError(f"object header version {head[0]} at {addr} (only 1 is read)")
        n_msgs, _, size = struct.unpack_from("<HII", head, 2)
        blocks, msgs, seen = [(addr + 16, size)], {}, 0
        while blocks and seen < n_msgs:
            start, length = blocks.pop(0)
            block, pos = self.pread(start, length), 0
            while pos + 8 <= length and seen < n_msgs:
                t, n, flags = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + n]
                pos += 8 + n
                seen += 1
                if flags & 0x02:
                    raise ValueError(f"shared object header message of type {t:#x}")
                if t == _MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data, 0))
                elif t == _MSG_FILTERS:
                    raise ValueError("filter pipeline message: a filtered (compressed) dataset")
                elif t in _MSG_KEPT:
                    msgs[t] = data
                elif t not in _MSG_IGNORED:
                    raise ValueError(f"object header message type {t:#x} is not read")
        return msgs

    def heap_object(self, addr: int, idx: int) -> bytes:
        """Object ``idx`` of the global heap collection at ``addr``."""
        objs = self._gcol.get(addr)
        if objs is None:
            head = self.pread(addr, 16)
            if head[:4] != b"GCOL" or head[4] != 1:
                raise ValueError(f"global heap collection not found at {addr} (GCOL, version 1)")
            (size,) = struct.unpack_from("<Q", head, 8)
            objs, pos = {}, 16
            while pos + 16 <= size:
                i, _, n = struct.unpack("<HH4xQ", self.pread(addr + pos, 16))
                if i == 0:                  # free space; its size counts its header
                    if n < 16:
                        break
                    pos += n
                    continue
                objs[i] = (addr + pos + 16, n)
                pos += 16 + _pad8(n)
            self._gcol[addr] = objs
        if idx not in objs:
            raise ValueError(f"global heap collection at {addr} has no object {idx}")
        start, n = objs[idx]
        return self.pread(start, n)

    def keys(self) -> List[str]:
        return list(self._links)

    def __contains__(self, name: str) -> bool:
        return name in self._links

    def __getitem__(self, name: str) -> H5Dataset:
        if name not in self._datasets:
            self._datasets[name] = H5Dataset(self, name, self._object_header(self._links[name]))
        return self._datasets[name]


class FeaturesWriter:
    """Writes features.h5 as h5py does for the JAX writer (``:78-99``),
    without h5py: each ``write`` appends the row's three sequences to the
    file as one global heap collection; ``close`` writes the datasets, the
    root group and the superblock. Rows never written read as empty
    sequences and zeros, the datasets' fill values."""

    _VLEN = (("features", np.float32), ("obj_atts", np.uint8), ("obj_atts_det", np.float32))

    def __init__(self, path: str, num_images: int):
        self._f = open(path, "wb")
        self._n = int(num_images)
        self._refs = {name: [(0, 0, 0)] * self._n for name, _ in self._VLEN}
        self._ints = {"image_id": np.zeros((self._n,), np.int64),
                      "num_boxes": np.zeros((self._n,), np.int64)}
        self._f.write(bytes(96))            # the superblock, written at close

    def _append(self, data: bytes) -> int:
        addr = self._f.tell()
        self._f.write(data)
        if len(data) % 8:
            self._f.write(bytes(8 - len(data) % 8))
        return addr

    def write(self, index: int, image_id: int, features: np.ndarray,
              obj_atts: np.ndarray, obj_atts_det: np.ndarray) -> None:
        values = {"features": np.asarray(features, np.float32).flatten(),
                  "obj_atts": np.asarray(obj_atts, np.uint8).reshape(-1),
                  "obj_atts_det": np.asarray(obj_atts_det, np.float32).reshape(-1)}
        objects, size = [], 16
        for name, dt in self._VLEN:
            v = np.ascontiguousarray(values[name], dt)
            if v.size:
                objects.append((name, v))
                size += 16 + _pad8(v.nbytes)
        refs = {name: (0, 0, 0) for name, _ in self._VLEN}
        if objects:
            total = max(size, _GCOL_MIN_SIZE)
            addr = self._f.tell()
            out = [struct.pack("<4sB3xQ", b"GCOL", 1, total)]
            for i, (name, v) in enumerate(objects, start=1):
                out.append(struct.pack("<HH4xQ", i, 1, v.nbytes))
                out.append(v.tobytes() + bytes(_pad8(v.nbytes) - v.nbytes))
                refs[name] = (v.size, addr, i)
            if total - size >= 16:                  # the free space, as object 0
                out.append(struct.pack("<HH4xQ", 0, 0, total - size))
            blob = b"".join(out)
            self._append(blob + bytes(total - len(blob)))
        for name, _ in self._VLEN:
            self._refs[name][index] = refs[name]
        self._ints["num_boxes"][index] = int(np.asarray(features).shape[0])
        self._ints["image_id"][index] = int(image_id)

    def _dataset_header(self, dtype_msg: bytes, data_addr: int, nbytes: int, vlen: bool) -> int:
        space = struct.pack("<BBBB4xQ", 1, 1, 0, 0, self._n)
        # late allocation, the library's default fill value (as h5py writes it)
        fill = struct.pack("<BBBBI", 2, 2, 0 if vlen else 2, 1, 0)
        layout = struct.pack("<BBQQ", 3, 1, data_addr, nbytes)
        return self._object_header([(_MSG_DATASPACE, space, 0), (_MSG_DATATYPE, dtype_msg, 1),
                                    (_MSG_FILL, fill, 1), (_MSG_LAYOUT, layout, 0)])

    def _object_header(self, messages) -> int:
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), flags)
                        + d + bytes(_pad8(len(d)) - len(d)) for t, d, flags in messages)
        return self._append(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def close(self) -> None:
        if self._f.closed:
            return
        headers = {}
        for name, dt in self._VLEN:
            raw = b"".join(struct.pack("<IQI", *r) for r in self._refs[name])
            addr = self._append(raw)
            msg = struct.pack("<B3BI", 0x19, 0, 0, 0, _VLEN_ELEMENT) + _dtype_message(np.dtype(dt))
            headers[name] = self._dataset_header(msg, addr, len(raw), True)
        for name, values in self._ints.items():
            addr = self._append(values.astype("<i8").tobytes())
            headers[name] = self._dataset_header(_dtype_message(np.dtype("<i8")), addr,
                                                 values.nbytes, False)
        # the local heap's names: "" at offset 0, then each name, 8-aligned
        names, offsets = bytearray(8), {}
        for name in sorted(headers):
            offsets[name] = len(names)
            names += name.encode() + b"\0"
            names += bytes(_pad8(len(names)) - len(names))
        seg = self._append(bytes(names))
        heap = self._append(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(names),
                                        _HEAP_FREE_NULL, seg))
        entries = b"".join(struct.pack("<QQI4x16x", offsets[n], headers[n], 0)
                           for n in sorted(headers))
        snod = self._append((struct.pack("<4sBxH", b"SNOD", 1, len(headers)) + entries)
                            .ljust(8 + 2 * _GROUP_LEAF_K * 40, b"\0"))
        last = sorted(headers)[-1]
        btree = self._append((struct.pack("<4sBBHQQ", b"TREE", 0, 0, 1, _UNDEF, _UNDEF)
                              + struct.pack("<QQQ", 0, snod, offsets[last]))
                             .ljust(24 + 2 * _GROUP_INTERNAL_K * 8
                                    + (2 * _GROUP_INTERNAL_K + 1) * 8, b"\0"))
        root = self._object_header([(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap), 0)])
        eof = self._f.tell()
        self._f.seek(0)
        self._f.write(_SIGNATURE + struct.pack("<8BHHIQQQQ", 0, 0, 0, 0, 0, 8, 8, 0,
                                               _GROUP_LEAF_K, _GROUP_INTERNAL_K, 0, 0,
                                               _UNDEF, eof, _UNDEF)
                      + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
        self._f.close()


class FeaturesReader:
    """Reader with the reference's access pattern
    (updown-baseline/updown/data/readers.py:21-139), as the JAX package's
    (``:102-156``): ``image_ids``, ``len`` and ``reader[image_id]`` ->
    (features (num_boxes, F) float32, obj_atts or None)."""

    def __init__(self, features_h5path: str, in_memory: bool = False,
                 use_obj_att_preds: bool = False):
        if not os.path.exists(features_h5path):
            raise FileNotFoundError(
                f"features file not found: {features_h5path!r} — check "
                "DATA.TRAIN_FEATURES / DATA.INFER_FEATURES in your config "
                "(both are opened at dataset construction, matching the "
                "reference's reader layout)")
        self._h5 = H5File(features_h5path)
        self.use_obj_att_preds = use_obj_att_preds
        ids = self._h5["image_id"].read()
        num_boxes = self._h5["num_boxes"].read()
        self._map = {int(ids[i]): i for i in range(len(ids))}
        self._num_boxes = {int(ids[i]): int(num_boxes[i]) for i in range(len(ids))}
        self._in_memory = in_memory
        self._cache: Dict[int, np.ndarray] = {}
        if in_memory:
            feats = self._h5["features"]
            for iid, idx in self._map.items():
                self._cache[iid] = feats[idx]

    def __len__(self) -> int:
        return len(self._map)

    @property
    def image_ids(self) -> List[int]:
        return list(self._map.keys())

    def __getitem__(self, image_id: int) -> Tuple[np.ndarray, Optional[list]]:
        idx = self._map[image_id]
        num_boxes = self._num_boxes[image_id]
        feats = self._cache.get(image_id)
        if feats is None:
            feats = self._h5["features"][idx]
        obj_atts = None
        try:
            if self.use_obj_att_preds:
                obj_atts = unpack_obj_atts_det(self._h5["obj_atts_det"][idx])
            elif "obj_atts" in self._h5:
                obj_atts = unpack_obj_atts(self._h5["obj_atts"][idx])
            if obj_atts is not None and len(obj_atts) != num_boxes:
                obj_atts = [[0, []]] * num_boxes  # readers.py:131-134
        except KeyError:
            # missing dataset/id → None, matching the reference's defaulting
            # (readers.py:128-137); malformed streams still raise.
            pass
        return feats.reshape(num_boxes, -1), obj_atts

    def close(self) -> None:
        self._h5.close()
