"""Entry point, test mode (port of ``tecogan_tpu/main.py``)::

    python -m tecogan_tpu_torch.main --exp_dir E --mode test --opt E/test.yml \
        [--gpu_ids 0]

It reads the experiment's YAML, reads every test set's PNG folders (BD
test sets without an LR folder are degraded on the device), runs each
generator checkpoint named by ``model.generator.load_path`` (``*.npz``
sweeps ``G_iter{N}``) over every sequence, writes the SR frames as PNGs
under ``test.res_dir/<dataset>/<checkpoint>/<sequence>/`` and scores them
(PSNR, SSIM, and tOF where cv2 is installed) into
``test.json_dir/<dataset>_avg.json`` or the log.

It runs on ``cuda:0`` unless ``--gpu_ids -1`` asks for the CPU; without
CUDA it raises. One process only. ``--mode train`` and ``--mode profile``
are not ported yet and raise.
"""

from __future__ import annotations

import os.path as osp
import time

import numpy as np
import torch

from .data import create_test_dataset
from .metrics import create_metric_calculator
from .models import define_model
from .ops.color import save_sequence
from .utils import config as config_utils
from .utils import paths as path_utils
from .utils.logging_utils import log_info, print_options, setup_logger


def _run_test_sets(opt, model, model_idx):
    """Every test set through ``model``; returns one record per sequence
    with its frame count, the host seconds it spent reading, inferring
    (degradation and the copy back included), writing and scoring, and
    its metrics (the sequence's mean of each)."""
    records = []
    for dataset_idx in sorted(opt["dataset"].keys()):
        if "test" not in dataset_idx:
            continue
        ds_name = opt["dataset"][dataset_idx]["name"]
        log_info(f"Testing on {ds_name} dataset")

        # cache per dataset on the model: a checkpoint sweep reuses the
        # dataset and the metric stack
        cache = getattr(model, "_test_set_cache", None)
        if cache is None:
            cache = model._test_set_cache = {}
        if dataset_idx not in cache:
            cache[dataset_idx] = (create_test_dataset(opt, dataset_idx),
                                  create_metric_calculator(opt))
        test_dataset, metric_calculator = cache[dataset_idx]
        if metric_calculator is not None:
            metric_calculator.reset()

        ds_records = []
        for idx in range(len(test_dataset)):
            t0 = time.perf_counter()
            data = test_dataset[idx]
            t1 = time.perf_counter()
            hr_seq = model.infer(model.prepare_inference_data(data))
            t2 = time.perf_counter()
            if opt["test"]["save_res"]:
                res_dir = osp.join(opt["test"]["res_dir"], ds_name, model_idx)
                save_sequence(
                    osp.join(res_dir, data["seq_idx"]), hr_seq,
                    data["frm_idx"], to_bgr=True)
            t3 = time.perf_counter()
            if metric_calculator is not None:
                metric_calculator.compute_sequence_metrics(
                    data["seq_idx"], np.asarray(data["gt"]), hr_seq)
            t4 = time.perf_counter()
            rec = {"dataset": ds_name, "model_idx": model_idx,
                   "seq_idx": data["seq_idx"], "frames": len(hr_seq),
                   "read_s": t1 - t0, "infer_s": t2 - t1,
                   "write_s": t3 - t2, "metrics_s": t4 - t3}
            ds_records.append(rec)
            log_info(f"{ds_name}/{data['seq_idx']}: {rec['frames']} frames, "
                     f"host seconds: read {rec['read_s']:.3f}, infer "
                     f"{rec['infer_s']:.3f}, write {rec['write_s']:.3f}, "
                     f"metrics {rec['metrics_s']:.3f}")

        if metric_calculator is not None:
            metric_calculator.gather(list(metric_calculator.metric_dict))
            for rec in ds_records:
                rec["metrics"] = metric_calculator.avg_metric_dict[
                    rec["seq_idx"]]
            if opt["test"].get("save_json"):
                json_path = osp.join(
                    opt["test"]["json_dir"], f"{ds_name}_avg.json")
                metric_calculator.save(model_idx, json_path, override=True)
            else:
                metric_calculator.display()
        records += ds_records
    return records


def test(opt):
    """Every checkpoint of the sweep over every test set; returns the
    per-sequence records of ``_run_test_sets``."""
    print_options(opt)
    if opt["model"]["generator"].get("compute_dtype",
                                      "float32") == "float32":
        log_info("compute_dtype float32: inference runs with TF32 off and "
                 "cuDNN's deterministic algorithms")
    records, model = [], None
    for load_path in opt["model"]["generator"]["load_path_lst"]:
        model_idx = osp.splitext(osp.split(load_path)[-1])[0]
        log_info("=" * 40)
        log_info(f"Testing model: {model_idx}")
        log_info("=" * 40)

        if model is None:
            opt["model"]["generator"]["load_path"] = load_path
            model = define_model(opt)
        else:
            # sweep over checkpoints: swap the weights only; datasets and
            # the metric stack are reused
            model.load_generator(load_path)
        records += _run_test_sets(opt, model, model_idx)
        log_info("-" * 40)
    return records


def main(argv=None):
    args = config_utils.parse_args(argv)
    if args.mode == "train":
        raise NotImplementedError(
            "--mode train is not ported yet: main.py's training loop and "
            "the data paths are ROADMAP Queue 1 item 4")
    if args.mode == "profile":
        raise NotImplementedError(
            "--mode profile is not ported yet (ROADMAP Queue 1 item 1)")
    if args.mode != "test":
        raise ValueError(
            f"Unrecognized mode: {args.mode} (train|test|profile)")
    opt = config_utils.parse_configs(args)
    setup_logger("base")
    path_utils.setup_paths(opt, args.mode)
    return test(opt)


if __name__ == "__main__":
    main()
