"""Model wrapper base (port of ``tecogan_tpu/models/base.py``): device
selection, training and inference data staging, temporal front padding,
the running log and checkpoints.

Checkpoints: generator weights go to ``G_iter{N}.npz`` in the JAX
package's layout; the full training state (weights, Adam state, step,
running log) to ``state_iter{N}.pth`` with ``torch.save``, and
``try_resume`` reloads the newest one with ``weights_only=True``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp

import numpy as np
import torch

from ..ops.degrade import downsample_bd
from ..utils import ckpt as ckpt_io

_log = logging.getLogger(__name__)


def select_device(opt) -> torch.device:
    """The one device ``opt['device_ids']`` names.

    ``[]`` is an explicit CPU run; ids map to ``cuda:<id>`` and must exist;
    no ids means ``cuda:0``. Without CUDA and without an explicit ``[]``
    this raises rather than running on the CPU.
    """
    ids = opt.get("device_ids")
    if ids is not None and len(ids) == 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set device_ids: [] to run on "
                           "the CPU explicitly")
    if not ids:
        return torch.device("cuda", 0)
    count = torch.cuda.device_count()
    bad = [i for i in ids if i >= count or i < 0]
    if bad:
        raise ValueError(f"device ids {bad} out of range: only {count} "
                         f"devices available")
    if len(ids) > 1:
        raise NotImplementedError(
            f"multi-device inference is not ported yet; got device_ids {ids}")
    return torch.device("cuda", ids[0])


@contextlib.contextmanager
def inference_numerics(compute_dtype: str):
    """The cuDNN and matmul settings inference runs under, restored after.

    fp32 means fp32 and the same every run: PyTorch runs fp32 cuDNN
    convolutions and matmuls in TF32 unless told not to, and cuDNN's
    default fp32 transposed convolutions are not deterministic, so for
    float32 work TF32 is off and cuDNN picks only deterministic algorithms.
    bf16 runs under the settings as they are (it is deterministic without
    them).
    """
    if compute_dtype != "float32":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic = True
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved


class BaseVSRModel:
    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.scale = opt["scale"]
        self.device = select_device(opt) if device is None else device
        self.is_train = opt.get("is_train", False)
        self.log_decay = opt.get("logger", {}).get("decay", 0.99)
        if self.is_train:
            self.ckpt_dir = opt["train"]["ckpt_dir"]

    def prepare_training_data(self, batch) -> dict:
        """Host batch {'gt': (n, t, H, W, c)[, 'lr']}, uint8 as the loader
        ships it (or float) -> device tensors. To a card the arrays go
        from pinned memory without blocking the host; normalisation happens
        on the device, inside the step."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def prepare_inference_data(self, data) -> torch.Tensor:
        """Sequence dict -> LR float32 (t, h, w, c) on the model's device.

        'lr' frames are taken as they are (float in [0, 1]); BD without an
        LR stream degrades the uint8 'gt' frames on the device with reflect
        padding (`base_model.py:96-119`).
        """
        if "lr" in data:
            return torch.as_tensor(np.asarray(data["lr"], np.float32),
                                   device=self.device)
        degradation = self.opt["dataset"]["degradation"]
        if degradation["type"] != "BD":
            raise ValueError("lr data is required for BI mode")
        gt = torch.as_tensor(np.asarray(data["gt"]), device=self.device)
        gt = gt.float().div_(255.0).permute(0, 3, 1, 2)  # (t, c, H, W)
        with inference_numerics("float32"):
            lr = downsample_bd(gt, self.scale,
                               sigma=degradation.get("sigma", 1.5),
                               pad_data=True)
        return lr.permute(0, 2, 3, 1).contiguous()

    def pad_sequence(self, lr_data: torch.Tensor):
        """Front-pad (t, h, w, c) frames to warm up the recurrence:
        'reflect' mirrors frames 1..n_pad, 'replicate' repeats frame 0.
        Returns (padded, n_pad)."""
        mode = self.opt["test"].get("padding_mode", "reflect")
        n_pad = self.opt["test"].get("num_pad_front", 0)
        if n_pad >= len(lr_data):
            raise ValueError(f"num_pad_front={n_pad} needs more than "
                             f"{len(lr_data)} frames")
        if n_pad == 0:
            return lr_data, 0
        if mode == "reflect":
            pad = lr_data[1:1 + n_pad].flip(0)
        elif mode == "replicate":
            pad = lr_data[:1].expand(n_pad, *lr_data.shape[1:])
        else:
            raise ValueError(f"Unrecognized padding mode: {mode}")
        return torch.cat([pad, lr_data], dim=0), n_pad

    # ------------------------------------------------------------------ logs
    def get_running_log(self, state) -> dict:
        """The EMA log as host floats (one device read per key)."""
        return {k: float(v) for k, v in state["running_log"].items()}

    # ----------------------------------------------------------- checkpoints
    def save_pytree(self, tree, filename):
        path = osp.join(self.ckpt_dir, filename)
        ckpt_io.save_pytree(tree, path)
        _log.info("Saved checkpoint: %s", path)

    def save_training_state(self, state, current_iter):
        """Full-state checkpoint: weights, optimizer, step, running log."""
        path = osp.join(self.ckpt_dir, f"state_iter{current_iter}.pth")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save({
            "g": state["g"].state_dict(),
            "opt_g": state["opt_g"].state_dict(),
            "step": state["step"],
            "running_log": dict(state["running_log"]),
        }, tmp)
        os.replace(tmp, path)
        _log.info("Saved checkpoint: %s", path)

    def try_resume(self, state):
        """Resume from the newest ``state_iter{N}.pth`` in ckpt_dir, if any.
        Returns (state, resumed). A checkpoint whose weights do not match
        the configured net (other widths or depth) raises ValueError."""
        path = ckpt_io.latest_training_state(self.ckpt_dir)
        if path is None:
            return state, False
        # to the host first: the loads below place each tensor (Adam keeps
        # its step counters on the host, so that a step reads no device
        # value back)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        net = state["g"]
        live = net.state_dict()
        if set(saved["g"]) != set(live):
            raise ValueError(
                f"checkpoint {path} does not match the configured model: "
                f"keys {sorted(set(saved['g']) ^ set(live))} differ")
        for k, v in live.items():
            if tuple(saved["g"][k].shape) != tuple(v.shape):
                raise ValueError(
                    f"checkpoint {path} does not match the configured "
                    f"model: {k} has shape {tuple(saved['g'][k].shape)}, "
                    f"expected {tuple(v.shape)}")
        net.load_state_dict(saved["g"])
        state["opt_g"].load_state_dict(saved["opt_g"])
        state["step"] = int(saved["step"])
        state["running_log"] = {
            k: saved["running_log"][k].to(self.device, torch.float32)
            for k in state["running_log"]}
        _log.info("Resumed training state from %s", path)
        return state, True
