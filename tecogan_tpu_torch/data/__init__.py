"""Loader factory (port of ``tecogan_tpu/data/__init__.py``; reference
contract: `codes/data/__init__.py:11-95`)."""

from .datasets import (
    PairedClipDataset,
    PairedFolderDataset,
    UnpairedClipDataset,
    UnpairedFolderDataset,
)
from .loader import TrainLoader
from .records import RecordStore, RecordWriter, open_store

__all__ = [
    "create_dataloader",
    "create_test_dataset",
    "TrainLoader",
    "PairedClipDataset",
    "PairedFolderDataset",
    "UnpairedClipDataset",
    "UnpairedFolderDataset",
    "RecordStore",
    "RecordWriter",
    "open_store",
]


def create_dataloader(opt, phase: str, idx: str, device=None):
    """Build a loader/dataset per the YAML dataset block.

    For training: a TrainLoader of uint8 batches (the step normalises on
    the device), or, with ``device_resident: true``, a DeviceResidentLoader
    whose corpus lives on ``device`` (the model's) and whose batches are
    born there. The global batch is ``batch_size_per_gpu`` times the
    process group's size (``parallel.dist``), and each rank gets its
    ``batch_size_per_gpu`` rows of it. Several devices in one process
    raise: training takes one process per device.
    """
    data_opt = opt["dataset"][idx]
    degradation = opt["dataset"]["degradation"]["type"]

    if phase == "train":
        import numpy as np

        from ..parallel import dist

        if dist.world() == 1 and len(opt.get("device_ids") or []) > 1:
            raise ValueError(
                f"training on device_ids {opt['device_ids']} takes one "
                f"process per device: launch through tecogan_tpu_torch.main "
                f"(--gpu_ids spawns them) or torchrun")
        common = dict(
            tempo_extent=opt["train"]["tempo_extent"],
            moving_first_frame=opt["train"].get("moving_first_frame", False),
            moving_factor=opt["train"].get("moving_factor", 1.0),
            filter_file=data_opt.get("filter_file"),
            # ship uint8 to the device; the step normalises there: a
            # quarter of the host-to-device bytes
            output_dtype=np.uint8,
        )
        if degradation == "BI":
            dataset = PairedClipDataset(
                data_opt["gt_seq_dir"], data_opt["lr_seq_dir"],
                scale=opt["scale"], gt_crop_size=data_opt["gt_crop_size"],
                **common)
        elif degradation == "BD":
            from ..ops.degrade import bd_border_size

            sigma = opt["dataset"]["degradation"]["sigma"]
            # the same border constant the in-step BD crop consumes
            # (steps.prepare_bd_batch); sharing the helper keeps the two
            # sides in lockstep
            enlarged = data_opt["crop_size"] + 2 * bd_border_size(sigma)
            dataset = UnpairedClipDataset(
                data_opt["seq_dir"], crop_size=enlarged, **common)
        else:
            raise ValueError(f"Unrecognized degradation type: {degradation}")

        seed = opt.get("manual_seed", 2021)
        ranks = dict(rank=dist.rank(), world=dist.world())
        batch = data_opt["batch_size_per_gpu"] * dist.world()
        if data_opt.get("device_resident", False):
            if device is None:
                raise ValueError("device_resident: true needs the model's "
                                 "device")
            from .device_data import DeviceResidentLoader

            return DeviceResidentLoader(dataset, batch_size=batch,
                                        device=device, seed=seed, **ranks)
        return TrainLoader(
            dataset, batch_size=batch, seed=seed,
            num_workers=data_opt.get("num_worker_per_gpu", 3), **ranks)

    if phase == "test":
        return create_test_dataset(opt, idx)

    raise ValueError(f"Unrecognized phase: {phase}")


def create_test_dataset(opt, idx: str):
    data_opt = opt["dataset"][idx]
    degradation = opt["dataset"]["degradation"]["type"]
    if data_opt.get("lr_seq_dir"):
        return PairedFolderDataset(
            data_opt["gt_seq_dir"], data_opt["lr_seq_dir"],
            filter_file=data_opt.get("filter_file"),
            filter_list=data_opt.get("filter_list"))
    if degradation != "BD":
        raise ValueError('"lr_seq_dir" is required for BI mode')
    return UnpairedFolderDataset(
        data_opt["gt_seq_dir"],
        filter_file=data_opt.get("filter_file"),
        filter_list=data_opt.get("filter_list"))
