"""Datasets: the training clip samplers and the test folder readers, (t, h,
w, c) numpy (copied from ``tecogan_tpu/data/datasets.py``: the clip
datasets from lines 40-293, the folder datasets from lines 300-381 with
PNG frames read by ``utils/png.py`` instead of cv2).

Sampling semantics preserved from the reference:
- a sample per *frame key*; a clip of ``tempo_extent`` frames starts at that
  frame, reflecting at the sequence end ((0,1,2) -> (0,1,2,1,0);
  `unpaired_lmdb_dataset.py:70-75`).
- "moving first frame" augmentation: with probability (1 - moving_factor),
  synthesize a clip by random-walking a crop window over the FIRST frame
  (offsets ~ floor(U[-3.5, 4.5)); `unpaired_lmdb_dataset.py:47-65`; the
  paired variant walks in LR units with U[-1.5, 1.5),
  `paired_lmdb_dataset.py:72-92`).
- augmentation: random spatial flip, optional temporal flip (unpaired only),
  random 90-degree rotations (`unpaired_lmdb_dataset.py:109-125`).

Randomness flows through an explicit ``np.random.Generator`` per sample,
drawn in the JAX package's order, so the (seed, epoch, i) streams give the
same clips in both packages. Test sequences: GT uint8, LR float32 in
[0, 1].
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import numpy as np

from ..utils.paths import retrieve_files
from ..utils.png import read_image
from .records import make_key, open_store, parse_key

__all__ = [
    "UnpairedClipDataset",
    "PairedClipDataset",
    "PairedFolderDataset",
    "UnpairedFolderDataset",
]


def _filter_keys(keys, filter_file, parse=lambda k: parse_key(k)[0]):
    if not filter_file:
        return keys
    with open(filter_file) as f:
        sel = {line.strip() for line in f if line.strip()}
    return [k for k in keys if parse(k) in sel]


def _reflect_index(i: int, tot: int) -> int:
    """Temporal reflect padding that stays valid for ANY overrun: the
    single-bounce formula 2*tot-i-2 (reference
    `unpaired_lmdb_dataset.py:70-75`) goes negative when a sequence is
    shorter than tempo_extent; full reflection (period 2*tot-2) matches it
    on the first bounce and keeps bouncing instead of producing a negative
    frame index (which the mmap store would turn into garbage bytes)."""
    if tot == 1:
        return 0
    period = 2 * tot - 2
    i %= period
    return i if i < tot else period - i


def _clip_keys(key, tempo_extent):
    vid, (tot, h, w), cur = parse_key(key)
    idxs = [_reflect_index(i, tot) for i in range(cur, cur + tempo_extent)]
    return [make_key(vid, tot, h, w, i) for i in idxs], (tot, h, w)


def _random_walk(rng, t, lo, hi):
    offsets = np.floor(rng.uniform(lo, hi, size=(t, 2))).astype(np.int32)
    pos = np.cumsum(offsets, axis=0)
    pos -= pos.min(axis=0)
    return pos, pos.max(axis=0)


class UnpairedClipDataset:
    """GT-only clips for BD training (reference UnpairedLMDBDataset)."""

    def __init__(self, seq_dir, crop_size, tempo_extent,
                 moving_first_frame=False, moving_factor=1.0,
                 filter_file=None, data_type="rgb",
                 output_dtype=np.float32):
        self.store = open_store(seq_dir)
        self.output_dtype = np.dtype(output_dtype)
        self.keys = _filter_keys(self.store.keys, filter_file)
        self.crop_size = crop_size
        self.tempo_extent = tempo_extent
        self.moving_first_frame = moving_first_frame
        self.moving_factor = moving_factor

    def __len__(self):
        return len(self.keys)

    def sample_plan(self, item, rng):
        """Draw every random decision for sample ``item`` into a plan dict.

        The plan fully determines the sample: frame indices (temporal
        reflection and the temporal flip already folded in), per-frame crop
        corners, and the spatial-augmentation index. ``assemble`` (host) and
        the device-resident gather (data/device_data.py) consume the SAME
        plan, so the two input paths are bit-identical by construction. RNG
        draws happen in the exact order of the original __getitem__, keeping
        the (seed, epoch, i) determinism contract unchanged.
        """
        key = self.keys[item]
        t = self.tempo_extent
        csz = self.crop_size
        vid, (tot, h, w), cur = parse_key(key)

        if self.moving_first_frame and rng.uniform() > self.moving_factor:
            # random-walk windows over the first frame, then the regular
            # random crop inside the (shrunk) common extent — composed into
            # one crop per frame so the native assembler does a single pass
            pos, rang = _random_walk(rng, t, -3.5, 4.5)
            ch, cw = h - rang[0], w - rang[1]
            if csz > ch or csz > cw:
                raise ValueError(f"crop {csz} > moving-clip extent {ch}x{cw}")
            top = rng.integers(0, ch - csz + 1)
            left = rng.integers(0, cw - csz + 1)
            f_idx = np.full(t, cur, np.int32)
            tops = (pos[:, 0] + top).astype(np.int32)
            lefts = (pos[:, 1] + left).astype(np.int32)
        else:
            if csz > h or csz > w:
                raise ValueError(f"crop {csz} > image {h}x{w}")
            top = rng.integers(0, h - csz + 1)
            left = rng.integers(0, w - csz + 1)
            f_idx = np.asarray(
                [_reflect_index(i, tot) for i in range(cur, cur + t)],
                np.int32)
            tops = np.full(t, top, np.int32)
            lefts = np.full(t, left, np.int32)

        # augmentation draws (same draw order as the original _augment)
        axis = int(rng.integers(1, 4))  # 1: none, 2: h, 3: w (thwc 1/2)
        if rng.integers(0, 2) == 0:  # temporal flip: reorder the plan
            f_idx, tops, lefts = f_idx[::-1], tops[::-1], lefts[::-1]
        k = int(rng.integers(0, 4))
        return {
            "vid": vid, "tot": tot, "h": h, "w": w,
            "f_idx": f_idx, "tops": tops, "lefts": lefts,
            "aug": (axis - 1) * 4 + k,  # spatial-aug index in [0, 12)
        }

    def batch_spec(self):
        """{key: (sample shape, dtype)} — lets the loader preallocate the
        batch and hand each worker its slot (one materialisation per
        sample instead of crop + aug + stack copies)."""
        c = self.store.get(self.keys[0]).shape[-1]
        t, csz = self.tempo_extent, self.crop_size
        return {"gt": ((t, csz, csz, c), self.output_dtype)}

    def assemble(self, plan, out=None):
        """Host assembly of a plan: one fused gather (crop + spatial aug),
        written into ``out``'s arrays when given (the batch slots)."""
        keys = [make_key(plan["vid"], plan["tot"], plan["h"], plan["w"], i)
                for i in plan["f_idx"]]
        gt = self.store.clip_aug(
            keys, plan["tops"], plan["lefts"], self.crop_size, plan["aug"],
            self.output_dtype, out=None if out is None else out["gt"])
        return {"gt": gt}

    def __getitem__(self, item_rng):
        item, rng = item_rng
        return self.assemble(self.sample_plan(item, rng))


class PairedClipDataset:
    """GT+LR clips for BI training (reference PairedLMDBDataset)."""

    def __init__(self, gt_seq_dir, lr_seq_dir, scale, gt_crop_size,
                 tempo_extent, moving_first_frame=False, moving_factor=1.0,
                 filter_file=None, data_type="rgb",
                 output_dtype=np.float32):
        self.output_dtype = np.dtype(output_dtype)
        self.gt_store = open_store(gt_seq_dir)
        self.lr_store = open_store(lr_seq_dir)
        gt_keys = _filter_keys(self.gt_store.keys, filter_file)
        lr_keys = _filter_keys(self.lr_store.keys, filter_file)
        # pair by parsed (vid, frame idx), NOT by zipping the two sorted
        # key lists: the keys embed their (different) sizes, and lexical
        # order can diverge between the GT and LR spellings of the same
        # vids (e.g. 'a' vs 'a_120x2' flip order between 256x256 and
        # 64x64 stores), which would mispair and then spuriously reject a
        # perfectly consistent dataset
        lr_by_id = {}
        for lk in lr_keys:
            lv, (_lt, _lh, _lw), li = parse_key(lk)
            lr_by_id[(lv, li)] = lk
        if len(lr_by_id) != len(lr_keys):
            raise ValueError("duplicate (vid, idx) among LR keys")
        pairs = []
        for gk in gt_keys:
            gv, _g, gi = parse_key(gk)
            lk = lr_by_id.pop((gv, gi), None)
            if lk is None:
                raise ValueError(f"GT key {gk} has no LR counterpart")
            pairs.append((gk, lk))
        if lr_by_id:
            extra = sorted(lr_by_id.values())[:3]
            raise ValueError(f"LR keys without GT counterparts: {extra}")
        self._check([g for g, _ in pairs], [l for _, l in pairs], scale)
        self.pairs = pairs
        self.scale = scale
        self.gt_crop_size = gt_crop_size
        self.tempo_extent = tempo_extent
        self.moving_first_frame = moving_first_frame
        self.moving_factor = moving_factor

    @staticmethod
    def _check(gt_keys, lr_keys, s):
        if len(gt_keys) != len(lr_keys):
            raise ValueError(
                f"GT/LR key count mismatch: {len(gt_keys)} vs {len(lr_keys)}")
        for gk, lk in zip(gt_keys, lr_keys):
            gv, (gt, gh, gw), gi = parse_key(gk)
            lv, (lt, lh, lw), li = parse_key(lk)
            if gv != lv or gi != li or gt != lt:
                raise ValueError(f"GT/LR key mismatch: {gk} vs {lk}")
            if gh != lh * s or gw != lw * s:
                raise ValueError(f"GT/LR size mismatch: {gk} vs {lk}")

    def __len__(self):
        return len(self.pairs)

    def sample_plan(self, item, rng):
        """Draw every random decision for sample ``item`` (see the unpaired
        variant's docstring): frame indices, LR-unit crop corners and the
        spatial-aug index (no temporal flip for paired data). RNG draw
        order matches the original __getitem__."""
        gt_key, lr_key = self.pairs[item]
        t, s = self.tempo_extent, self.scale
        lcsz = self.gt_crop_size // s
        vid, (tot, gh, gw), cur = parse_key(gt_key)
        _, (_, lh, lw), _ = parse_key(lr_key)
        if gh != s * lh or gw != s * lw:
            raise ValueError(f"GT/LR size mismatch: {gt_key} vs {lr_key}")

        if self.moving_first_frame and rng.uniform() > self.moving_factor:
            pos, rang = _random_walk(rng, t, -1.5, 1.5)
            ch, cw = lh - rang[0], lw - rang[1]
            if lcsz > ch or lcsz > cw:
                raise ValueError(
                    f"LR crop {lcsz} > moving-clip extent {ch}x{cw}")
            top = rng.integers(0, ch - lcsz + 1)
            left = rng.integers(0, cw - lcsz + 1)
            f_idx = np.full(t, cur, np.int32)
            l_tops = (pos[:, 0] + top).astype(np.int32)
            l_lefts = (pos[:, 1] + left).astype(np.int32)
        else:
            if lcsz > lh or lcsz > lw:
                raise ValueError(f"LR crop {lcsz} > LR image {lh}x{lw}")
            top = rng.integers(0, lh - lcsz + 1)
            left = rng.integers(0, lw - lcsz + 1)
            f_idx = np.asarray(
                [_reflect_index(i, tot) for i in range(cur, cur + t)],
                np.int32)
            l_tops = np.full(t, top, np.int32)
            l_lefts = np.full(t, left, np.int32)

        axis = int(rng.integers(1, 4))
        k = int(rng.integers(0, 4))
        return {
            "vid": vid, "tot": tot, "h": gh, "w": gw,
            "lh": lh, "lw": lw,
            "f_idx": f_idx, "tops": l_tops, "lefts": l_lefts,
            "aug": (axis - 1) * 4 + k,
        }

    def batch_spec(self):
        t, s = self.tempo_extent, self.scale
        gcsz = self.gt_crop_size
        gc = self.gt_store.get(self.pairs[0][0]).shape[-1]
        lc = self.lr_store.get(self.pairs[0][1]).shape[-1]
        return {
            "gt": ((t, gcsz, gcsz, gc), self.output_dtype),
            "lr": ((t, gcsz // s, gcsz // s, lc), self.output_dtype),
        }

    def assemble(self, plan, out=None):
        s = self.scale
        gcsz = self.gt_crop_size
        lcsz = gcsz // s
        gks = [make_key(plan["vid"], plan["tot"], plan["h"], plan["w"], i)
               for i in plan["f_idx"]]
        lks = [make_key(plan["vid"], plan["tot"], plan["lh"], plan["lw"], i)
               for i in plan["f_idx"]]
        dt = self.output_dtype
        lr = self.lr_store.clip_aug(
            lks, plan["tops"], plan["lefts"], lcsz, plan["aug"], dt,
            out=None if out is None else out["lr"])
        gt = self.gt_store.clip_aug(
            gks, plan["tops"] * s, plan["lefts"] * s, gcsz, plan["aug"], dt,
            out=None if out is None else out["gt"])
        return {"gt": gt, "lr": lr}

    def __getitem__(self, item_rng):
        item, rng = item_rng
        return self.assemble(self.sample_plan(item, rng))


# --------------------------------------------------------------------------
# test-time folder datasets
# --------------------------------------------------------------------------


def _select_keys(root, filter_file=None, filter_list=None):
    keys = sorted(os.listdir(root))
    sel = set(keys)
    if filter_file:
        with open(filter_file) as f:
            sel = {line.strip() for line in f if line.strip()}
    elif filter_list:
        sel = set(filter_list)
    return sorted(sel & set(keys))


def _read_seq(seq_dir, as_float):
    seq = np.stack([read_image(p) for p in retrieve_files(seq_dir)])
    if as_float:
        seq = seq.astype(np.float32) / 255.0
    return seq


class PairedFolderDataset:
    """Whole GT+LR sequences from PNG folders (reference counterpart:
    `paired_folder_dataset.py:12-63`). gt uint8, lr float32, both thwc."""

    def __init__(self, gt_seq_dir, lr_seq_dir, filter_file=None,
                 filter_list=None, **_):
        self.gt_seq_dir = gt_seq_dir
        self.lr_seq_dir = lr_seq_dir
        gt_keys = set(os.listdir(gt_seq_dir))
        lr_keys = set(os.listdir(lr_seq_dir))
        selected = set(_select_keys(gt_seq_dir, filter_file, filter_list))
        self.keys = sorted(selected & gt_keys & lr_keys)
        dropped = sorted((selected & gt_keys) - lr_keys)
        if dropped:
            # same intersection semantics as the reference
            # (`paired_folder_dataset.py:22`), but dropping sequences
            # changes every dataset-average metric — say so
            logging.getLogger("tecogan").warning(
                "PairedFolderDataset: %d GT sequence(s) have no matching "
                "LR folder under %s and will be SKIPPED: %s",
                len(dropped), lr_seq_dir, ", ".join(dropped[:8]))

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, item):
        key = self.keys[item]
        return {
            "gt": _read_seq(osp.join(self.gt_seq_dir, key), as_float=False),
            "lr": _read_seq(osp.join(self.lr_seq_dir, key), as_float=True),
            "seq_idx": key,
            "frm_idx": sorted(os.listdir(osp.join(self.gt_seq_dir, key))),
        }


class UnpairedFolderDataset:
    """GT-only sequences; LR generated downstream by on-the-fly BD
    (`unpaired_folder_dataset.py:12-52`)."""

    def __init__(self, gt_seq_dir, filter_file=None, filter_list=None, **_):
        self.gt_seq_dir = gt_seq_dir
        self.keys = _select_keys(gt_seq_dir, filter_file, filter_list)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, item):
        key = self.keys[item]
        return {
            "gt": _read_seq(osp.join(self.gt_seq_dir, key), as_float=False),
            "seq_idx": key,
            "frm_idx": sorted(os.listdir(osp.join(self.gt_seq_dir, key))),
        }
