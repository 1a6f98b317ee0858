"""The port's training data paths (tecogan_tpu_torch.data: the records store,
the clip datasets, the native assembler's binding, TrainLoader and the
device-resident loader, the create_records tool) against the JAX package's,
on the same stores and (seed, epoch, i) streams: bit for bit."""

import json
import os
import os.path as osp
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tecogan_tpu.data import datasets as jdatasets
from tecogan_tpu.data import device_data as jdevice_data
from tecogan_tpu.data import native as jnative
from tecogan_tpu.data import records as jrecords
from tecogan_tpu.data.loader import TrainLoader as JTrainLoader
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.data import create_dataloader, datasets, device_data
from tecogan_tpu_torch.data import native, records
from tecogan_tpu_torch.data.loader import TrainLoader
from tecogan_tpu_torch.utils.png import write_png


def _frames(rng, t, h, w):
    return (rng.random((t, h, w, 3)) * 255).astype(np.uint8)


def _write(mod, out, seqs):
    w = mod.RecordWriter(str(out))
    for vid, frames in seqs:
        w.add_sequence(vid, frames)
    w.close()
    return str(out)


@pytest.fixture
def seqs(rng):
    # a vid with underscores, one shorter than the tempo extents below
    return [("a", _frames(rng, 6, 48, 56)), ("b_2", _frames(rng, 6, 48, 56)),
            ("c", _frames(rng, 2, 48, 56))]


@pytest.fixture
def store_dir(tmp_path, seqs):
    return _write(records, tmp_path / "GT.rec", seqs)


@pytest.fixture
def paired_dirs(tmp_path, rng):
    gt, lr = [], []
    for vid in ("a", "a_120x2", "b"):
        g = _frames(rng, 5, 64, 64)
        gt.append((vid, g))
        lr.append((vid, g[:, ::4, ::4].copy()))
    return (_write(records, tmp_path / "gt.rec", gt),
            _write(records, tmp_path / "lr.rec", lr))


# ------------------------------------------------------------------ stores

def test_writer_bytes_match_jax(tmp_path, seqs):
    ours = _write(records, tmp_path / "ours", seqs)
    theirs = _write(jrecords, tmp_path / "theirs", seqs)
    for name in ("data.bin", "index.json"):
        with open(osp.join(ours, name), "rb") as a, \
                open(osp.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, seqs, writer):
    path = _write(records if writer == "port" else jrecords,
                  tmp_path / writer, seqs)
    ours, theirs = records.RecordStore(path), jrecords.RecordStore(path)
    assert ours.keys == theirs.keys and len(ours.keys) == 14
    for key in ours.keys:
        np.testing.assert_array_equal(ours.get(key), theirs.get(key))
    vid, frames = seqs[1]
    np.testing.assert_array_equal(
        ours.get(records.make_key(vid, 6, 48, 56, 3)), frames[3])


@pytest.mark.parametrize("key", ["a_6x48x56_0003", "b_2_10x720x1280_0009",
                                 "x_y_z_1x1x1_0000"])
def test_keys_round_trip(key):
    parsed = records.parse_key(key)
    assert parsed == jrecords.parse_key(key)
    vid, (tot, h, w), idx = parsed
    assert records.make_key(vid, tot, h, w, idx) == key
    assert jrecords.make_key(vid, tot, h, w, idx) == key


def test_duplicate_vids_raise(tmp_path, rng):
    w = records.RecordWriter(str(tmp_path / "dup"))
    w.add_sequence("a", _frames(rng, 2, 8, 8))
    with pytest.raises(ValueError, match="duplicate sequence name"):
        w.add_sequence("a", _frames(rng, 2, 8, 8))
    w.close()
    # a hand-corrupted index with a duplicate refuses to open
    idx = tmp_path / "dup" / "index.json"
    meta = json.loads(idx.read_text())
    meta["seqs"].append(dict(meta["seqs"][0]))
    idx.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="duplicate sequence name"):
        records.RecordStore(str(tmp_path / "dup"))


def test_inconsistent_keys_and_dtypes_raise(store_dir):
    store = records.RecordStore(store_dir)
    for bad in ("a_6x48x56_0006", "a_6x40x56_0001"):
        with pytest.raises(KeyError, match="inconsistent"):
            store.get(bad)
    keys = [records.make_key("a", 6, 48, 56, i) for i in range(2)]
    with pytest.raises(ValueError, match="float32 .* or uint8"):
        store.clip(keys, [0, 0], [0, 0], 8, 8, np.float16)
    with pytest.raises(ValueError, match="uint8"):
        records.RecordWriter(store_dir + "_f").add_sequence(
            "a", np.zeros((1, 4, 4, 3), np.float32))


def test_lmdb_store_names_the_missing_package(tmp_path, monkeypatch):
    import pickle

    d = tmp_path / "ref.lmdb"
    d.mkdir()
    with open(d / "meta_info.pkl", "wb") as f:
        pickle.dump({"name": "ref", "keys": ["a_2x4x4_0000"]}, f)
    store = records.open_store(str(d))
    assert isinstance(store, records.LMDBStore)
    assert store.keys == ["a_2x4x4_0000"]
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="'lmdb' package") as e:
        store.get("a_2x4x4_0000")
    assert "index.json + data.bin" in str(e.value)


# -------------------------------------------------------- plans and clips

def _clip_pair(store_dir, te, mff, dtype):
    kw = dict(crop_size=24, tempo_extent=te, moving_first_frame=mff,
              moving_factor=0.5, output_dtype=dtype)
    return (datasets.UnpairedClipDataset(store_dir, **kw),
            jdatasets.UnpairedClipDataset(store_dir, **kw))


def _assert_plans_equal(p, q):
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], q[k], err_msg=k)


@pytest.mark.parametrize("mff", [False, True])
@pytest.mark.parametrize("te", [3, 7])  # 7: the 2-frame and 6-frame
def test_unpaired_plans_and_clips_match_jax(store_dir, te, mff):  # reflect
    for dtype in (np.uint8, np.float32):
        ours, theirs = _clip_pair(store_dir, te, mff, dtype)
        assert len(ours) == len(theirs) == 14
        spec = ours.batch_spec()
        assert spec == theirs.batch_spec()
        for epoch in (0, 1):
            for i in range(len(ours)):
                p = ours.sample_plan(i, np.random.default_rng((5, epoch, i)))
                q = theirs.sample_plan(i, np.random.default_rng((5, epoch, i)))
                _assert_plans_equal(p, q)
                got = {"gt": np.empty(*spec["gt"])}
                ours.assemble(p, out=got)
                np.testing.assert_array_equal(got["gt"],
                                              theirs.assemble(q)["gt"])


def test_short_sequence_reflects():
    for tot in (1, 2, 3):
        for cur in range(tot):
            keys, _ = datasets._clip_keys(
                records.make_key("s", tot, 8, 8, cur), 7)
            assert keys == jdatasets._clip_keys(
                jrecords.make_key("s", tot, 8, 8, cur), 7)[0]
            assert all(0 <= records.parse_key(k)[2] < tot for k in keys)


@pytest.mark.parametrize("mff", [False, True])
def test_paired_plans_and_clips_match_jax(paired_dirs, mff):
    """BI pairs GT and LR keys by (vid, idx), not by the sort order of the
    two key lists ('a' against 'a_120x2' sort differently at 64x64 and
    16x16)."""
    kw = dict(scale=4, gt_crop_size=32, tempo_extent=4,
              moving_first_frame=mff, moving_factor=0.5,
              output_dtype=np.uint8)
    ours = datasets.PairedClipDataset(*paired_dirs, **kw)
    theirs = jdatasets.PairedClipDataset(*paired_dirs, **kw)
    assert ours.pairs == theirs.pairs and len(ours.pairs) == 15
    for gk, lk in ours.pairs:
        assert records.parse_key(gk)[::2] == records.parse_key(lk)[::2]
    for i in range(len(ours)):
        p = ours.sample_plan(i, np.random.default_rng((1, 0, i)))
        q = theirs.sample_plan(i, np.random.default_rng((1, 0, i)))
        _assert_plans_equal(p, q)
        a, b = ours.assemble(p), theirs.assemble(q)
        for k in ("gt", "lr"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_paired_dataset_refuses_a_missing_lr(tmp_path, rng, paired_dirs):
    lr2 = _write(records, tmp_path / "lr2.rec",
                 [("a", _frames(rng, 5, 16, 16))])
    with pytest.raises(ValueError, match="no LR counterpart"):
        datasets.PairedClipDataset(paired_dirs[0], lr2, scale=4,
                                   gt_crop_size=32, tempo_extent=2)


# ---------------------------------------------------------------- native

def test_aug_maps_match_jax():
    for csz in (2, 5, 24):
        np.testing.assert_array_equal(device_data.dihedral_maps(csz),
                                      jdevice_data.dihedral_maps(csz))
        np.testing.assert_array_equal(native.aug_coeffs(csz),
                                      jnative.aug_coeffs(csz))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_native_assembler_matches_numpy_all_augs(tmp_path, store_dir, rng,
                                                 dtype):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/tecoloader.cpp")
    build = tmp_path / "build"
    path = kernel_build.build_native_loader(build)
    assert path.parent == build and path.exists()
    assert kernel_build.build_native_loader(build) == path  # cached
    lib = native.load_library(build)
    blob = native.NativeBlob(osp.join(store_dir, "data.bin"), lib)
    store = records.RecordStore(store_dir)
    keys = [records.make_key("b_2", 6, 48, 56, i) for i in (0, 3, 5, 3)]
    offs = [store._frame_offset(k)[0] for k in keys]
    for aug in range(12):
        tops = rng.integers(0, 48 - 20 + 1, 4)
        lefts = rng.integers(0, 56 - 20 + 1, 4)
        want = records._StoreBase.clip_aug(store, keys, tops, lefts, 20, aug,
                                           dtype)
        slot = np.empty((4, 20, 20, 3), dtype)
        got = blob.assemble_clip_aug(offs, 48, 56, 3, tops, lefts, 20, aug,
                                     dtype, out=slot)
        assert got is slot
        np.testing.assert_array_equal(got, want, err_msg=f"aug {aug}")
    np.testing.assert_array_equal(
        blob.assemble_clip(offs, 48, 56, 3, tops, lefts, 9, 13, dtype),
        records._StoreBase.clip(store, keys, tops, lefts, 9, 13, dtype))
    blob.close()


# --------------------------------------------------------------- loaders

def test_train_loader_matches_jax(store_dir):
    ours, theirs = _clip_pair(store_dir, 3, True, np.uint8)
    a = TrainLoader(ours, batch_size=3, seed=11, num_workers=2)
    b = JTrainLoader(theirs, batch_size=3, seed=11, num_workers=3)
    assert len(a) == len(b) == 4
    for epoch, start in ((0, 0), (1, 0), (1, 2)):
        got = list(a.epoch(epoch, start_batch=start))
        want = list(b.epoch(epoch, start_batch=start))
        assert len(got) == len(want) == 4 - start
        for x, y in zip(got, want):
            assert x["gt"].dtype == np.uint8
            np.testing.assert_array_equal(x["gt"], y["gt"])


def test_train_loader_early_exit_stops_producer(store_dir):
    """Leaving an epoch mid-way (total_iter reached, an exception) must
    not leave the producer parked in a blocking put."""
    ds = datasets.UnpairedClipDataset(store_dir, crop_size=24,
                                      tempo_extent=3)
    loader = TrainLoader(ds, batch_size=1, seed=7, num_workers=2,
                         prefetch=2)
    before = set(threading.enumerate())
    gen = loader.epoch(0)
    next(gen)
    gen.close()
    deadline = time.time() + 10.0
    while time.time() < deadline:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"leaked threads: {extra}"


def test_train_loader_slow_consumer_gets_the_sentinel(store_dir):
    """A consumer slower than the producer finds the queue full at the
    producer's exit; the end-of-epoch sentinel must still arrive."""
    ds = datasets.UnpairedClipDataset(store_dir, crop_size=24,
                                      tempo_extent=3)
    loader = TrainLoader(ds, batch_size=1, seed=7, num_workers=2,
                         prefetch=2)
    counts = []

    def consume_two_epochs():
        for epoch in range(2):
            n = 0
            for _ in loader.epoch(epoch):
                time.sleep(0.02)
                n += 1
            counts.append(n)

    t = threading.Thread(target=consume_two_epochs, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive(), "the loop hung at an epoch boundary"
    assert counts == [14, 14]


def _uniform_store(tmp_path, rng, name="uni.rec"):
    return _write(records, tmp_path / name,
                  [(f"v{i}", _frames(rng, 6, 48, 56)) for i in range(3)])


@pytest.mark.parametrize("resident", [False, True])
def test_loader_rank_rows_are_global_rows(tmp_path, rng, resident):
    """In a run of 2 ranks, rank r's batches are rows [r, r + 1) of each
    global batch of 2 the one-process loader yields, bit for bit
    (``parallel.dist.shard_rows``); a global batch that does not divide
    over the ranks raises."""
    ds = datasets.UnpairedClipDataset(
        _write(records, tmp_path / "four.rec",
               [(f"v{i}", _frames(rng, 6, 48, 56)) for i in range(4)]),
        crop_size=24, tempo_extent=4, moving_first_frame=True,
        moving_factor=0.5, output_dtype=np.uint8)

    def loader(rank, world):
        if resident:
            return device_data.DeviceResidentLoader(
                ds, batch_size=2, device=torch.device("cpu"), seed=3,
                rank=rank, world=world)
        return TrainLoader(ds, batch_size=2, seed=3, num_workers=2,
                           rank=rank, world=world)

    whole = list(loader(0, 1).epoch(1))
    assert len(whole) == len(ds) // 2
    for r in range(2):
        part = list(loader(r, 2).epoch(1))
        assert len(part) == len(whole)
        for x, y in zip(part, whole):
            np.testing.assert_array_equal(np.asarray(x["gt"]),
                                          np.asarray(y["gt"])[r:r + 1])
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        loader(0, 3)


@pytest.mark.parametrize("form", ["BD", "BI"])
def test_device_resident_loader_matches_host(tmp_path, rng, paired_dirs,
                                             form):
    if form == "BD":
        ds = datasets.UnpairedClipDataset(
            _uniform_store(tmp_path, rng), crop_size=24, tempo_extent=4,
            moving_first_frame=True, moving_factor=0.5,
            output_dtype=np.uint8)
    else:
        ds = datasets.PairedClipDataset(
            *paired_dirs, scale=4, gt_crop_size=32, tempo_extent=4,
            moving_first_frame=True, moving_factor=0.5,
            output_dtype=np.uint8)
    host = TrainLoader(ds, batch_size=2, seed=3, num_workers=2)
    dev = device_data.DeviceResidentLoader(ds, batch_size=2,
                                           device=torch.device("cpu"),
                                           seed=3)
    assert len(dev) == len(host) == len(ds) // 2
    for epoch, start in ((0, 0), (1, 2)):
        got = list(dev.epoch(epoch, start_batch=start))
        want = list(host.epoch(epoch, start_batch=start))
        assert len(got) == len(want) == len(host) - start
        for x, y in zip(got, want):
            assert set(x) == set(y) == ({"gt"} if form == "BD"
                                        else {"gt", "lr"})
            for k in x:
                assert x[k].dtype == torch.uint8
                np.testing.assert_array_equal(x[k].numpy(), y[k])


def test_device_resident_loader_refuses_what_jax_refuses(tmp_path, rng,
                                                         monkeypatch):
    mixed = _write(records, tmp_path / "mixed.rec",
                   [("a", _frames(rng, 4, 48, 56)),
                    ("b", _frames(rng, 4, 40, 56))])
    ds = datasets.UnpairedClipDataset(mixed, crop_size=24, tempo_extent=3)
    with pytest.raises(ValueError, match="uniform corpus"):
        device_data.DeviceResidentLoader(ds, 1, "cpu")
    assert device_data.MAX_CORPUS_BYTES == jdevice_data.MAX_CORPUS_BYTES
    ds = datasets.UnpairedClipDataset(_uniform_store(tmp_path, rng),
                                      crop_size=24, tempo_extent=3)
    monkeypatch.setattr(device_data, "MAX_CORPUS_BYTES", 3 * 6 * 48 * 56 * 3
                        - 1)
    with pytest.raises(ValueError, match="too large"):
        device_data.DeviceResidentLoader(ds, 1, "cpu")


def _factory_opt(form, store, paired, **train):
    data = ({"seq_dir": store, "crop_size": 24} if form == "BD" else
            {"gt_seq_dir": paired[0], "lr_seq_dir": paired[1],
             "gt_crop_size": 32})
    return {"scale": 4, "manual_seed": 4, "device_ids": [],
            "dataset": {"degradation": {"type": form, "sigma": 1.5},
                        "train": {**data, "batch_size_per_gpu": 2,
                                  "num_worker_per_gpu": 2, **train}},
            "train": {"tempo_extent": 3, "moving_first_frame": True,
                      "moving_factor": 0.7}}


@pytest.mark.parametrize("form", ["BD", "BI"])
def test_factory_builds_the_jax_loaders(tmp_path, rng, paired_dirs, form):
    store = _uniform_store(tmp_path, rng)
    opt = _factory_opt(form, store, paired_dirs)
    loader = create_dataloader(opt, "train", "train")
    assert type(loader) is TrainLoader and loader.num_workers == 2
    assert loader.batch_size == 2 and loader.seed == 4
    ds = loader.dataset
    if form == "BD":  # the enlarged crop: 24 + 2 * bd_border_size(1.5)
        assert ds.crop_size == 32 and ds.output_dtype == np.uint8
        jds = jdatasets.UnpairedClipDataset(
            store, crop_size=32, tempo_extent=3, moving_first_frame=True,
            moving_factor=0.7, output_dtype=np.uint8)
    else:
        jds = jdatasets.PairedClipDataset(
            *paired_dirs, scale=4, gt_crop_size=32, tempo_extent=3,
            moving_first_frame=True, moving_factor=0.7,
            output_dtype=np.uint8)
    want = next(iter(JTrainLoader(jds, 2, seed=4).epoch(1)))
    got = next(iter(loader.epoch(1)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    opt["dataset"]["train"]["device_resident"] = True
    dev = create_dataloader(opt, "train", "train", device="cpu")
    assert isinstance(dev, device_data.DeviceResidentLoader)
    np.testing.assert_array_equal(next(iter(dev.epoch(1)))["gt"].numpy(),
                                  want["gt"])
    with pytest.raises(ValueError, match="one process per device"):
        create_dataloader({**opt, "device_ids": [0, 1]}, "train", "train")


def test_record_store_reports_its_assembler(store_dir, caplog):
    store = records.RecordStore(store_dir)
    with caplog.at_level("INFO", logger="base"):
        want = "numpy" if shutil.which("g++") is None else "native"
        assert store.assembler == want
        store.clip_aug([records.make_key("a", 6, 48, 56, 0)], [0], [0], 8, 0)
    lines = [r.getMessage() for r in caplog.records
             if "clips assembled by" in r.getMessage()]
    assert len(lines) == 1 and want in lines[0]


def test_record_store_decides_its_assembler_once_across_threads(
        store_dir, monkeypatch, caplog):
    """Workers that ask while the library builds wait for it: none of them
    takes numpy meanwhile, the library loads once and one line is logged."""
    calls = []

    class Lib:
        _name = "stand-in"

    def slow_load():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return Lib()

    monkeypatch.setattr(native, "load_library", slow_load)
    monkeypatch.setattr(native, "NativeBlob", lambda path, lib: (path, lib))
    store = records.RecordStore(store_dir)
    seen = []
    with caplog.at_level("INFO", logger="base"):
        workers = [threading.Thread(target=lambda: seen.append(
            store.assembler)) for _ in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
    lines = [r.getMessage() for r in caplog.records
             if "clips assembled by" in r.getMessage()]
    assert seen == ["native"] * 8 and len(calls) == 1
    assert len(lines) == 1 and "stand-in" in lines[0]


# ---------------------------------------------------------------- tool

def test_create_records_tool(tmp_path, rng, capsys):
    from tecogan_tpu_torch.tools import create_records

    raw = tmp_path / "Raw"
    frames = {}
    for seq in ("000", "001", "002"):
        os.makedirs(raw / seq)
        frames[seq] = _frames(rng, 3, 16, 24)
        for i, f in enumerate(frames[seq]):
            write_png(str(raw / seq / f"{i:08d}.png"), f)
    (raw / "001" / "notes.txt").write_text("not a frame")
    flt = tmp_path / "list.txt"
    flt.write_text("000\n002\n")
    out = str(tmp_path / "GT.lmdb")
    create_records.main(["--raw_dir", str(raw), "--out_dir", out,
                         "--filter_file", str(flt)])
    store = jrecords.RecordStore(out)  # the JAX package reads it
    assert sorted({records.parse_key(k)[0] for k in store.keys}) == [
        "000", "002"]
    for seq in ("000", "002"):
        for i in range(3):
            np.testing.assert_array_equal(
                store.get(records.make_key(seq, 3, 16, 24, i)),
                frames[seq][i])
    create_records.main(["--check", "--out_dir", out])
    assert "6 frame keys, ~2 sequences" in capsys.readouterr().out
    assert len([f for f in os.listdir(out) if f.startswith("check_")]) >= 1
    # a JPEG frame raises, naming the file
    os.makedirs(raw / "003")
    (raw / "003" / "0000.jpg").write_bytes(b"\xff\xd8\xff\xe0not a png")
    with pytest.raises(IOError, match="0000.jpg"):
        create_records.main(["--raw_dir", str(raw), "--out_dir",
                             str(tmp_path / "x.rec")])
