"""Dataset factory (port of ``tecogan_tpu/data/__init__.py``'s test half).
The training loaders are ROADMAP Queue 1 item 4 and not ported yet."""

from .datasets import PairedFolderDataset, UnpairedFolderDataset

__all__ = [
    "create_dataloader",
    "create_test_dataset",
    "PairedFolderDataset",
    "UnpairedFolderDataset",
]


def create_dataloader(opt, phase: str, idx: str):
    """The test dataset for ``phase == 'test'``; training loaders raise."""
    if phase == "train":
        raise NotImplementedError(
            "training data loaders are not ported yet (ROADMAP Queue 1 "
            "item 4)")
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
