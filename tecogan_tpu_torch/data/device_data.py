"""Device-resident training data: upload the corpus once, stream only plans
(port of ``tecogan_tpu/data/device_data.py`` lines 1-234).

The training batch is the only recurring host-to-device transfer of the
train loop (uint8 GT crops). For corpora that fit the card's memory, the
whole corpus is uploaded once as uint8, and each step ships only the sample
*plans* (frame indices, crop corners, augmentation index: a few hundred
bytes); the batch is gathered on the device by indexing.

Exactness: ``sample_plan`` draws every random decision with the same
(seed, epoch, i) streams the host loader uses, and the device gather
consumes the same plan, so the batches are bit-identical to the host
loader's. The spatial augmentation (flip none/h/w x rot90 k) is applied
through 12 precomputed index maps, so crop, flip and rotation are one
gather per sample. This is plain PyTorch indexing, not a kernel.

Data parallelism, as the JAX ``mesh=`` path
(``tecogan_tpu/data/device_data.py:134-167``): every rank keeps the whole
corpus on its own card and gathers only its rows of each global batch
(``TrainLoader``'s ``rank``/``world``); the global batch must divide over
the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .loader import TrainLoader
from .records import make_key, parse_key

__all__ = ["DeviceResidentLoader", "dihedral_maps", "MAX_CORPUS_BYTES"]

# the JAX package's cap (tecogan_tpu/data/device_data.py:38): the resident
# corpus leaves the rest of the device's memory to the model, its
# optimizer state and activations
MAX_CORPUS_BYTES = 4 << 30


def dihedral_maps(csz: int) -> np.ndarray:
    """(12, csz, csz, 2) source-index maps for the 12 spatial-aug variants
    (flip {none, h, w} x rot90 k in {0..3}), derived by pushing an identity
    index grid through the same numpy ops the host path applies, so the
    two paths cannot drift."""
    ii, jj = np.meshgrid(np.arange(csz), np.arange(csz), indexing="ij")
    ident = np.stack([ii, jj], axis=-1).astype(np.int32)  # (csz, csz, 2)
    maps = []
    for axis in (1, 2, 3):
        for k in range(4):
            m = ident[None]  # fake t-axis so axis numbers match thwc
            if axis > 1:
                m = np.flip(m, axis - 1)
            m = np.rot90(m, k, (1, 2))
            maps.append(np.ascontiguousarray(m[0]))
    return np.stack(maps)


def _load_uniform_corpus(store, keys):
    """Stack a store's sequences into one (n_clips, T, H, W, C) uint8 array.

    Requires every sequence to share (T, H, W, C); vids are indexed in
    sorted order and the vid->index map is returned for plan translation.
    """
    vids = sorted({parse_key(k)[0] for k in keys})
    shapes = set()
    infos = []
    for vid in vids:
        some_key = next(k for k in keys if parse_key(k)[0] == vid)
        _, (tot, h, w), _ = parse_key(some_key)
        infos.append((vid, tot, h, w))
        shapes.add((tot, h, w))
    if len(shapes) != 1:
        raise ValueError(
            f"device-resident data needs a uniform corpus; found clip "
            f"geometries {sorted(shapes)}. Use the host loader "
            f"(device_resident: false) for mixed-geometry data.")
    tot, h, w = next(iter(shapes))
    first = store.get(make_key(*infos[0][:4], 0))
    c = first.shape[-1]
    nbytes = len(vids) * tot * h * w * c
    if nbytes > MAX_CORPUS_BYTES:
        raise ValueError(
            f"corpus is {nbytes / 2 ** 30:.1f} GiB: too large to keep "
            f"device-resident (cap {MAX_CORPUS_BYTES / 2 ** 30:.0f} GiB). "
            f"Use the host loader (device_resident: false).")
    clips = np.empty((len(vids), tot, h, w, c), np.uint8)
    for ci, (vid, tot_, h_, w_) in enumerate(infos):
        for fi in range(tot_):
            clips[ci, fi] = store.get(make_key(vid, tot_, h_, w_, fi))
    return clips, {vid: i for i, (vid, *_rest) in enumerate(infos)}


class DeviceResidentLoader(TrainLoader):
    """TrainLoader drop-in whose epochs yield batches on ``device``.

    Same epoch order, same per-sample RNG streams, same batch contents as
    the host loader; the per-step host-to-device payload is the stacked
    plans (int32, ~100 B a sample) instead of the crops.
    """

    def __init__(self, dataset, batch_size: int, device, seed: int = 0,
                 rank: int = 0, world: int = 1):
        super().__init__(dataset, batch_size, seed=seed, num_workers=1,
                         rank=rank, world=world)
        self.device = torch.device(device)
        # paired (BI) datasets carry two stores; unpaired (BD) one
        if hasattr(dataset, "pairs"):
            scale = dataset.scale
            gcsz = dataset.gt_crop_size
            gt_clips, self.vid_index = _load_uniform_corpus(
                dataset.gt_store, [gk for gk, _ in dataset.pairs])
            lr_clips, _ = _load_uniform_corpus(
                dataset.lr_store, [lk for _, lk in dataset.pairs])
            corpora = {"gt": gt_clips, "lr": lr_clips}
            geoms = {"gt": (gcsz, scale), "lr": (gcsz // scale, 1)}
        else:
            clips, self.vid_index = _load_uniform_corpus(
                dataset.store, dataset.keys)
            corpora = {"gt": clips}
            geoms = {"gt": (dataset.crop_size, 1)}
        self._clips = {k: torch.from_numpy(v).to(self.device)
                       for k, v in corpora.items()}
        self._maps = {k: torch.from_numpy(dihedral_maps(csz).astype(np.int64))
                      .to(self.device) for k, (csz, _s) in geoms.items()}
        self._scales = {k: s for k, (_c, s) in geoms.items()}

    def _assemble(self, plans):
        """The batch {key: (n, t, csz, csz, C) uint8} from the stacked
        plans (on the device)."""
        ci = plans["ci"][:, None, None, None]            # (n, 1, 1, 1)
        f_idx = plans["f_idx"][:, :, None, None]         # (n, t, 1, 1)
        out = {}
        for k, clips in self._clips.items():
            s = self._scales[k]
            m = self._maps[k][plans["aug"]][:, None]     # (n, 1, csz, csz, 2)
            rows = s * plans["tops"][:, :, None, None] + m[..., 0]
            cols = s * plans["lefts"][:, :, None, None] + m[..., 1]
            out[k] = clips[ci, f_idx, rows, cols]        # (n, t, csz, csz, C)
        return out

    def epoch(self, epoch_idx: int, start_batch: int = 0):
        """``start_batch`` skips already-consumed batches plan-free on
        resume (same determinism: streams are keyed by (seed, epoch, i))."""
        n = len(self.dataset)
        order = np.random.default_rng((self.seed, epoch_idx)).permutation(n)
        for b in range(start_batch, len(self)):
            idxs = self._rows(order, b)
            plans = []
            for i in idxs:
                rng = np.random.default_rng((self.seed, epoch_idx, int(i)))
                p = self.dataset.sample_plan(int(i), rng)
                plans.append({
                    "ci": self.vid_index[p["vid"]], "f_idx": p["f_idx"],
                    "tops": p["tops"], "lefts": p["lefts"], "aug": p["aug"],
                })
            stacked = {k: torch.from_numpy(
                np.stack([p[k] for p in plans]).astype(np.int64))
                for k in plans[0]}
            if self.device.type == "cuda":
                stacked = {k: v.pin_memory().to(self.device,
                                                non_blocking=True)
                           for k, v in stacked.items()}
            yield self._assemble(stacked)
