"""Entry point, train and test modes (port of ``tecogan_tpu/main.py``)::

    python -m tecogan_tpu_torch.main --exp_dir E --mode train --opt E/train.yml \
        [--gpu_ids 0 | --gpu_ids 0,1]
    torchrun --nproc_per_node N -m tecogan_tpu_torch.main --exp_dir E \
        --mode train --opt E/train.yml
    python -m tecogan_tpu_torch.main --exp_dir E --mode test --opt E/test.yml \
        [--gpu_ids 0]
    python -m tecogan_tpu_torch.main --exp_dir E --mode profile \
        --opt E/train.yml --lr_size 3x134x320 [--test_speed] [--gpu_ids 0]

Train mode trains FRVSR or TecoGAN from a records store (BD: GT only; BI:
GT + LR) through the threaded host loader or, with ``device_resident:
true``, the device-resident one; it logs every ``logger.log_freq``
iterations, writes ``G_iter{N}.npz`` (TecoGAN also ``D_iter{N}.npz``) and
``state_iter{N}.pth`` under ``train.ckpt_dir`` every ``logger.ckpt_freq``
iterations and at the last, validates on the test sets every
``test.test_freq``, resumes from the newest state file where the last run
left the data stream, and saves the state when the loop fails between
steps.

Test mode reads the experiment's YAML, reads every test set's PNG folders
(BD test sets without an LR folder are degraded on the device), runs each
generator checkpoint named by ``model.generator.load_path`` (``*.npz``
sweeps ``G_iter{N}``) over every sequence, writes the SR frames as PNGs
under ``test.res_dir/<dataset>/<checkpoint>/<sequence>/`` and scores them
(PSNR, SSIM, LPIPS where its weights are found, and tOF where cv2 is
installed) into
``test.json_dir/<dataset>_avg.json`` or the log.

Profile mode prints a generator's analytic GFLOPs and parameters per
module for one step at ``--lr_size`` (the JAX CLI's lines and numbers),
``FlopCounterMode``'s count of one ``FRNet.step`` and, with
``--test_speed``, the frames/s of 30 steps; ``TECOGAN_TRACE_DIR`` writes a
``torch.profiler`` chrome trace of them.

All three run on ``cuda:0`` unless ``--gpu_ids -1`` asks for the CPU;
without CUDA they raise. Train and test mode log the warp kernels' launch
counts of the process as one JSON line at their end (``kernel launches:
{...}``), for callers that run the CLI in a subprocess.

Data parallelism (the JAX package's dp mesh, ``--gpu_ids 0,1``) runs one
process per device over ``torch.distributed``: given several ids and no
torchrun environment, ``main`` builds the kernels once and spawns one
worker per id (rank = position in the list, device ``cuda:<id>``); under
torchrun it joins the group it names (rank r on ``cuda:LOCAL_RANK``, or on
``cuda:<ids[LOCAL_RANK]>`` with several ids). Training takes the global
batch of ``batch_size_per_gpu`` times the ranks, each rank its rows; rank
0 alone logs, writes checkpoints, the emergency save and the validation
JSON. Test mode and validation round-robin the sequences over the ranks
and merge their metrics before rank 0 writes them. Test mode with
``test.spatial_partition: true`` stays one process, and shards each
stream's rows over the listed devices.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from . import nn
from .data import create_dataloader, create_test_dataset
from .metrics import create_metric_calculator
from .metrics.model_summary import flop_count, profile_frnet
from .models import define_model
from .ops import kernel_launches
from .ops.color import save_sequence
from .parallel import dist
from .utils import config as config_utils
from .utils import paths as path_utils
from .utils.logging_utils import (log_info, log_warning, print_options,
                                  setup_logger)


def _run_test_sets(opt, model, model_idx):
    """Every test set through ``model``; returns one record per sequence
    with its frame count, the host seconds it spent reading, inferring
    (degradation and the copy back included), writing and scoring, and
    its metrics (the sequence's mean of each).

    In a data-parallel run rank r takes sequences r, r + world, ... (the
    reference's round-robin, `codes/main.py:93,169`) and returns their
    records; the per-sequence averages of every rank are merged before
    rank 0 saves or displays them."""
    rank, world = dist.rank(), dist.world()
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
        for idx in range(rank, len(test_dataset), world):
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
            if world > 1:
                _allgather_metrics(metric_calculator)
            if rank == 0 and opt["test"].get("save_json"):
                json_path = osp.join(
                    opt["test"]["json_dir"], f"{ds_name}_avg.json")
                metric_calculator.save(model_idx, json_path, override=True)
            elif rank == 0:
                metric_calculator.display()
        records += ds_records
    return records


def _allgather_metrics(metric_calculator):
    """Merge every rank's per-sequence averages into each rank's
    ``avg_metric_dict``, sorted by sequence (``tecogan_tpu/main.py:83-100``;
    ``all_gather_object`` pickles dicts of any size, so the JAX package's
    two-phase size exchange is not needed)."""
    merged = {}
    for part in dist.allgather_object(metric_calculator.avg_metric_dict):
        merged.update(part)
    metric_calculator.avg_metric_dict = dict(sorted(merged.items()))


def _batches(loader, start_epoch, total_epoch, skip_in_epoch):
    """(epoch, batch) from ``start_epoch`` on, the first epoch entered at
    batch ``skip_in_epoch``: the skipped batches are not assembled, and
    each sample's stream is keyed by (seed, epoch, dataset index), not by
    its position, so a resumed run sees what a straight one would."""
    for epoch in range(start_epoch, total_epoch):
        batches = loader.epoch(
            epoch, start_batch=skip_in_epoch if epoch == start_epoch else 0)
        with contextlib.closing(batches):
            for batch in batches:
                yield epoch, batch


def train(opt):
    """The training loop of ``tecogan_tpu/main.py:108-217``, on one device
    or one rank of a data-parallel group. Returns the model."""
    log_info(f'{20 * "-"} Configurations {20 * "-"}')
    print_options(opt)

    model = define_model(opt)
    train_loader = create_dataloader(opt, "train", "train",
                                     device=model.device)

    total_sample = len(train_loader.dataset)
    iter_per_epoch = len(train_loader)
    total_iter = opt["train"]["total_iter"]
    total_epoch = int(math.ceil(total_iter / iter_per_epoch))
    start_iter = opt["train"].get("start_iter", 0)
    test_freq = opt["test"]["test_freq"]
    log_freq = opt["logger"]["log_freq"]
    ckpt_freq = opt["logger"]["ckpt_freq"]

    log_info(f"Number of the training samples: {total_sample}")
    log_info(f"{total_epoch} epochs needed for {total_iter} iterations")

    # auto-resume if a state checkpoint exists
    model.state, resumed = model.try_resume(model.state)
    if resumed:
        start_iter = int(model.state["step"])
        # every rank read the same file; rank 0's copy makes them one
        model.sync_replicas(model.state)

    # Resume continues the data stream where the checkpoint left off, not
    # just the step counter: restarting at epoch 0 would replay the samples
    # already consumed. Enter at the checkpoint's epoch and skip the
    # batches it already trained on.
    start_epoch = start_iter // iter_per_epoch
    skip_in_epoch = start_iter % iter_per_epoch

    # trained_iter: the last iteration whose step completed, the one an
    # emergency save records; in_step: inside model.train, where a failure
    # may leave some weights or Adam moments updated and others not
    trained_iter, in_step = start_iter, False
    # closing: leaving the loop early (the budget reached, an exception)
    # stops the loader's producer thread at once
    stream = _batches(train_loader, start_epoch, total_epoch, skip_in_epoch)
    try:
        with contextlib.closing(stream):
            for epoch, batch in stream:
                curr_iter = trained_iter + 1
                # total_iter is the global budget: a resumed run finishes
                # the remaining iterations instead of training total_iter
                # more
                if curr_iter > total_iter:
                    return model

                batch = model.prepare_training_data(batch)
                in_step = True
                model.train(batch)
                in_step = False
                trained_iter = curr_iter

                if log_freq > 0 and curr_iter % log_freq == 0:
                    log_info(model.get_format_msg(model.state, epoch,
                                                  curr_iter))

                # always checkpoint the final iteration even when
                # ckpt_freq does not divide total_iter; ckpt_freq: 0 means
                # no checkpoints at all; rank 0 alone writes (the replicas
                # are identical, and writers would race on one path)
                if ckpt_freq > 0 and dist.is_main() and (
                        curr_iter == total_iter
                        or curr_iter % ckpt_freq == 0):
                    model.save(curr_iter)
                    model.save_training_state(model.state, curr_iter)

                if test_freq > 0 and curr_iter % test_freq == 0:
                    _run_test_sets(opt, model, f"G_iter{curr_iter}")
    except BaseException:
        # persist the full training state so auto-resume continues from
        # here (rank 0 alone), unless the step itself failed: its in-place
        # updates may be torn, so that state must not be resumed from
        if in_step and dist.is_main():
            log_warning(
                "Emergency save impossible: the failed training step may "
                "have updated some weights or optimizer moments and not "
                "others — resume from the last periodic checkpoint")
        elif dist.is_main():
            try:
                model.save_training_state(model.state, trained_iter)
                log_warning(f"Emergency training state saved at iter "
                            f"{trained_iter}")
            except Exception:
                logging.getLogger("base").exception(
                    f"Emergency training-state save FAILED at iter "
                    f"{trained_iter}: no state file was written for it")
        raise
    return model


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


def profile(opt, lr_size: str, test_speed: bool = False) -> dict:
    """``tecogan_tpu/main.py::profile`` on the port: the analytic GFLOPs and
    parameters of one generator step at ``lr_size`` ("CxHxW"), then
    ``FlopCounterMode``'s count of one ``FRNet.step`` on the device (that
    call is also the warm-up) and, with ``test_speed``, 30 more steps
    timed on the host clock up to a synchronise. The generator's weights
    are drawn from a seed and its compute dtype is the configuration's.
    Returns the numbers it prints."""
    from .models.networks import define_generator
    from .models.networks.frnet import _compute_module

    print_options(opt["model"]["generator"])
    c, h, w = map(int, lr_size.split("x"))
    scale = opt["scale"]
    msg = "\n" + "*" * 40
    msg += (f"\nResolution: {lr_size} -> "
            f"{c}x{h * scale}x{w * scale} ({scale}x SR)")

    device = nn.select_device(opt)
    cfg, build = define_generator(opt)
    net = _compute_module(build(torch.Generator().manual_seed(0), device),
                          cfg.dtype)

    gflops, params_cnt = profile_frnet(cfg, (c, h, w))
    tot_g, tot_p = 0.0, 0
    for name in gflops:
        msg += f'\n{"-" * 40}\nModule: [{name}]'
        msg += f"\n    FLOPs (10^9): {gflops[name]:.3f}"
        msg += f"\n    Parameters (10^6): {params_cnt[name] / 1e6:.3f}"
        tot_g += gflops[name]
        tot_p += params_cnt[name]
    msg += f'\n{"-" * 40}\nOverall'
    msg += f"\n    FLOPs (10^9): {tot_g:.3f}"
    msg += f"\n    Parameters (10^6): {tot_p / 1e6:.3f}"

    gen = torch.Generator().manual_seed(1)
    lr_curr, lr_prev = (torch.rand((1, c, h, w), generator=gen)
                        for _ in range(2))
    hr_prev = torch.rand((1, c, scale * h, scale * w), generator=gen)
    args = [t.to(device=device, dtype=cfg.dtype)
            for t in (lr_curr, lr_prev, hr_prev)]
    out = {"gflops": tot_g, "params": tot_p}
    with torch.inference_mode():
        out["counted_gflops"] = flop_count(net.step, *args) / 1e9
        msg += (f"\n    FlopCounterMode: {out['counted_gflops']:.3f} GFLOPs "
                f"(one FRNet.step: convolutions and resampling matmuls)")
        msg += "\n" + "*" * 40
        if test_speed:
            trace_dir = os.environ.get("TECOGAN_TRACE_DIR")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            trace = (torch.profiler.profile(activities=activities)
                     if trace_dir else contextlib.nullcontext())
            n_test = 30
            with trace:
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(n_test):
                    net.step(*args)
                _sync(device)
                dt = time.perf_counter() - t0
            if trace_dir:
                os.makedirs(trace_dir, exist_ok=True)
                trace.export_chrome_trace(
                    osp.join(trace_dir, "profile_trace.json"))
            out["fps"] = n_test / dt
            msg += (f"\nSpeed: {out['fps']:.3f} FPS "
                    f"(averaged over {n_test} runs)\n" + "*" * 40)
    log_info(msg)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _row_sharded(opt) -> bool:
    """Test mode with ``test.spatial_partition``: one process over all the
    listed devices."""
    return (opt["mode"] == "test"
            and opt.get("test", {}).get("spatial_partition", False))


def main(argv=None):
    """Returns the trained model in train mode, test mode's per-sequence
    records in test mode, and profile's numbers in profile mode; None in
    the process that spawned data-parallel workers."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = config_utils.parse_args(argv)
    if args.mode not in ("train", "test", "profile"):
        raise ValueError(
            f"Unrecognized mode: {args.mode} (train|test|profile)")
    opt = config_utils.parse_configs(args)
    ids = opt["device_ids"]
    if (not dist.launched() and len(ids) > 1 and args.mode != "profile"
            and not _row_sharded(opt)):
        # --gpu_ids 0,1: one worker per id; the kernels are built here
        # once, not once a rank
        nn.select_devices(opt)  # an id out of range raises here
        from . import kernel_build

        kernel_build.build()
        dist.spawn(main, len(ids), argv)
        return None
    setup_logger("base")
    if dist.launched():
        device = dist.rank_device(ids)
        dist.init_distributed(device)
        if device.type == "cuda":
            if dist.is_main():
                from . import kernel_build

                kernel_build.build()
            dist.barrier()
        if not dist.is_main():
            logging.getLogger("base").setLevel(logging.WARNING)
    path_utils.setup_paths(opt, args.mode)
    if args.mode == "profile":
        return profile(opt, args.lr_size, args.test_speed)
    try:
        return train(opt) if args.mode == "train" else test(opt)
    finally:
        # one JSON line of this run's kernel launches, read by callers that
        # drive the CLI in a subprocess (tools/run_synth_campaign.py); also
        # when the run leaves by an exception, a SIGINT's KeyboardInterrupt
        # included: after train mode's emergency save, before the re-raise
        log_info(f"kernel launches: {json.dumps(kernel_launches())}")


if __name__ == "__main__":
    try:
        main()
    finally:
        dist.shutdown()
