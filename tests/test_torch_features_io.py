"""The port's features.h5 reader and writer (``utils/features_io.py``, no
h5py) against h5py and the JAX package's reader and writer, both ways:
every dataset of every row equal. Layouts the reader does not read raise
``ValueError``."""

import h5py
import numpy as np
import pytest
import torch

from style_seqcvae_tpu.utils import features_io as j_io
from style_seqcvae_tpu_torch.utils import features_io as t_io

torch.set_num_threads(1)

DATASETS = ("features", "obj_atts", "obj_atts_det", "image_id", "num_boxes")


def _rows(n=5, feat_dim=7, seed=0):
    """(image_id, features, obj_atts, obj_atts_det) rows: 0-length
    obj_atts_det in most rows (as the JAX CLI test writes them), one row
    with no obj_atts at all, one whose packed stream has fewer objects than
    boxes (the reader's reset), and one large row (its own heap
    collection)."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        nb = [3, 2, 1, 4, 300][i % 5]
        ids = [1 + k % 90 for k in range(nb)]
        feats = rng.randn(nb, feat_dim).astype(np.float32)
        oa = t_io.pack_obj_atts(ids, [list(rng.choice(20, rng.randint(3), False))
                                      for _ in ids])
        od = np.zeros((0,), np.float32)
        if i % 5 == 1:
            oa = np.zeros((0,), np.uint8)
        if i % 5 == 3:
            oa = t_io.pack_obj_atts(ids[:2], [[1], []])             # 2 objects, 4 boxes
            od = t_io.pack_obj_atts_det(ids, rng.rand(nb, 6))
        if i % 5 == 4:
            od = t_io.pack_obj_atts_det(ids, rng.rand(nb, 6))
        rows.append((1000 + 7 * i, feats, oa, od))
    return rows


def _write(io, path, rows, extra=0):
    w = io.FeaturesWriter(str(path), len(rows) + extra)
    for i, row in enumerate(rows):
        w.write(i, *row)
    w.close()


def _same_reads(path, in_memory, use_preds):
    jr = j_io.FeaturesReader(str(path), in_memory, use_preds)
    tr = t_io.FeaturesReader(str(path), in_memory, use_preds)
    assert tr.image_ids == jr.image_ids and len(tr) == len(jr)
    for iid in jr.image_ids:
        (jf, jo), (tf, to) = jr[iid], tr[iid]
        assert tf.dtype == jf.dtype and tf.shape == jf.shape
        np.testing.assert_array_equal(tf, jf)
        assert to == jo
    tr.close()


@pytest.mark.parametrize("in_memory", [False, True])
@pytest.mark.parametrize("use_preds", [False, True])
def test_port_reads_h5py_files_as_jax(tmp_path, in_memory, use_preds):
    _write(j_io, tmp_path / "f.h5", _rows(10))
    _same_reads(tmp_path / "f.h5", in_memory, use_preds)


def test_reader_keeps_jax_rules(tmp_path):
    """The ``len != num_boxes`` reset, 0-length streams, and a file with no
    ``obj_atts`` dataset (obj_atts None), as the JAX reader gives them."""
    rows = _rows(5)
    _write(j_io, tmp_path / "f.h5", rows)
    tr = t_io.FeaturesReader(str(tmp_path / "f.h5"))
    assert tr[rows[3][0]][1] == [[0, []]] * 4                    # the reset
    assert tr[rows[1][0]][1] == [[0, []]] * 2                    # empty stream, 2 boxes
    with h5py.File(tmp_path / "g.h5", "w") as f:                 # no obj_atts dataset
        f.create_dataset("features", (1,), dtype=h5py.vlen_dtype(np.float32))
        f["features"][0] = rows[0][1].flatten()
        f.create_dataset("image_id", data=np.array([5]))
        f.create_dataset("num_boxes", data=np.array([3]))
    for use_preds in (False, True):
        jr = j_io.FeaturesReader(str(tmp_path / "g.h5"), use_obj_att_preds=use_preds)
        t = t_io.FeaturesReader(str(tmp_path / "g.h5"), use_obj_att_preds=use_preds)
        np.testing.assert_array_equal(t[5][0], jr[5][0])
        assert t[5][1] is None and jr[5][1] is None
    with pytest.raises(FileNotFoundError):
        t_io.FeaturesReader(str(tmp_path / "missing.h5"))


def test_port_writer_read_by_h5py_and_jax(tmp_path):
    rows = _rows(10)
    _write(t_io, tmp_path / "p.h5", rows, extra=2)               # two rows never written
    with h5py.File(tmp_path / "p.h5", "r") as f:
        assert sorted(f.keys()) == sorted(DATASETS)
        assert f["features"].dtype == h5py.vlen_dtype(np.float32)
        assert f["obj_atts"].dtype == h5py.vlen_dtype(np.uint8)
        assert f["image_id"].dtype == np.int64 and f["num_boxes"].dtype == np.int64
        for i, (iid, feats, oa, od) in enumerate(rows):
            assert f["image_id"][i] == iid and f["num_boxes"][i] == feats.shape[0]
            np.testing.assert_array_equal(f["features"][i], feats.flatten())
            np.testing.assert_array_equal(f["obj_atts"][i], oa)
            np.testing.assert_array_equal(f["obj_atts_det"][i], od)
        for i in (10, 11):                                      # the fill values
            assert f["image_id"][i] == 0 and f["num_boxes"][i] == 0
            assert f["features"][i].size == f["obj_atts"][i].size == 0
    # the same file from JAX's writer reads the same through every reader
    _write(j_io, tmp_path / "j.h5", rows, extra=2)
    with h5py.File(tmp_path / "p.h5", "r") as p, h5py.File(tmp_path / "j.h5", "r") as j:
        for name in DATASETS:
            for i in range(12):
                np.testing.assert_array_equal(p[name][i], j[name][i])
    rj = j_io.FeaturesReader(str(tmp_path / "p.h5"))
    for iid, feats, _, _ in rows:
        np.testing.assert_array_equal(rj[iid][0], feats)
    for use_preds in (False, True):
        jr = j_io.FeaturesReader(str(tmp_path / "p.h5"), use_obj_att_preds=use_preds)
        tr = t_io.FeaturesReader(str(tmp_path / "p.h5"), use_obj_att_preds=use_preds)
        for iid, *_ in rows:
            assert tr[iid][1] == jr[iid][1]
            np.testing.assert_array_equal(tr[iid][0], jr[iid][0])


def test_h5file_reads_every_dataset(tmp_path):
    rows = _rows(5)
    _write(j_io, tmp_path / "f.h5", rows)
    with h5py.File(tmp_path / "f.h5", "r") as f, t_io.H5File(str(tmp_path / "f.h5")) as t:
        assert sorted(t.keys()) == sorted(f.keys())
        for name in DATASETS:
            assert len(t[name]) == len(f[name])
            for i in range(len(f[name])):
                np.testing.assert_array_equal(t[name][i], f[name][i])
        np.testing.assert_array_equal(t["image_id"].read(), f["image_id"][:])
        with pytest.raises(IndexError):
            t["image_id"][5]
        with pytest.raises(ValueError, match="variable-length"):
            t["features"].read()
    # a dataset h5py never wrote has no storage: it reads as zeros
    with h5py.File(tmp_path / "u.h5", "w") as f:
        f.create_dataset("image_id", (3,), dtype=np.int64)
    with t_io.H5File(str(tmp_path / "u.h5")) as t:
        np.testing.assert_array_equal(t["image_id"].read(), np.zeros(3, np.int64))


def _h5py_file(path, kind):
    kw = {"libver": "latest"} if kind == "libver_latest" else {}
    with h5py.File(path, "w", **kw) as f:
        if kind == "chunked":
            f.create_dataset("image_id", data=np.arange(4), chunks=(2,))
        elif kind == "gzip":
            f.create_dataset("image_id", data=np.arange(4), compression="gzip")
        elif kind == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"image_id", h5py.h5t.STD_I64LE,
                            h5py.h5s.create_simple((4,)), dcpl=dcpl)
        elif kind == "big_endian":
            f.create_dataset("image_id", data=np.arange(4, dtype=">i8"))
        elif kind == "string":
            f.create_dataset("image_id", data=np.array([b"a", b"b"]))
        elif kind == "two_dims":
            f.create_dataset("image_id", data=np.zeros((2, 2), np.int64))
        elif kind == "fill_value":
            f.create_dataset("image_id", (4,), dtype=np.int64, fillvalue=7)
        else:
            f.create_dataset("image_id", data=np.arange(4))


@pytest.mark.parametrize("kind,match", [
    ("chunked", "chunked"), ("gzip", "chunked|filter"), ("libver_latest", "superblock version"),
    ("compact", "compact"), ("big_endian", "little-endian"), ("string", "datatype class"),
    ("two_dims", "rank 2"), ("fill_value", "fill value of its own")])
def test_reader_refuses_other_layouts(tmp_path, kind, match):
    path = tmp_path / f"{kind}.h5"
    _h5py_file(path, kind)
    with pytest.raises(ValueError, match=match):
        with t_io.H5File(str(path)) as f:
            f["image_id"].read()
    (tmp_path / "not.h5").write_bytes(b"plain text, not HDF5" * 8)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        t_io.H5File(str(tmp_path / "not.h5"))


def test_packers_equal_jax():
    rng = np.random.RandomState(1)
    ids, atts = [3, 7, 1], [[0, 5], [], [55]]
    scores = rng.rand(3, 8)
    np.testing.assert_array_equal(t_io.pack_obj_atts(ids, atts), j_io.pack_obj_atts(ids, atts))
    np.testing.assert_array_equal(t_io.pack_obj_atts_det(ids, scores),
                                  j_io.pack_obj_atts_det(ids, scores))
    s, d = j_io.pack_obj_atts(ids, atts), j_io.pack_obj_atts_det(ids, scores)
    assert t_io.unpack_obj_atts(s) == j_io.unpack_obj_atts(s)
    assert t_io.unpack_obj_atts_det(d) == j_io.unpack_obj_atts_det(d)
