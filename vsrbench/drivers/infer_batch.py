"""Batched streaming inference: a closed loop of calls to the program's
``infer_sequence_batch``, each on ``streams`` clips of ``frames`` LR frames
of ``height`` x ``width``, cycling through a pool of seeded batches made
on the card in set-up, so that no call repeats the one before. A call is
complete when its uint8 output is summed on the card and the checksum is
read back.

Correctness: the output of one call of the window, drawn from the seed
among the first ``SAMPLE_FROM_FIRST``, against the plain fp32 reference run
on the same LR clips with the same weights, once the window has closed:
gray levels of every frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import counts, weights
from ..reference import nets as ref
from ..reference.train import no_tf32
from ..trace import profile, span

SAMPLE_FROM_FIRST = 4   # the checked call: one of the window's first calls
DISPATCH_SAMPLES = 5    # calls timed alone for dispatch_ms.infer
TRACE_UNITS = 2         # calls under the profiler


def readings(out: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers compared: the worst frame's mean absolute difference in
    gray levels, the mean over all frames, and the largest difference."""
    d = (out.to(torch.int16) - want.to(torch.int16)).abs()
    per_frame = d.float().mean(dim=(2, 3, 4))
    return {"frame_mad_worst": float(per_frame.max()),
            "frame_mad_mean": float(per_frame.mean()),
            "max_abs": float(d.max())}


class Driver:
    kind = "infer"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                       infer_sequence_batch)

        g = config["generator"]
        self.dims = (g["nf"], g["nb"], config["scale"])
        self.cfg = FRNetConfig(nf=g["nf"], nb=g["nb"], scale=config["scale"],
                               degradation=config["degradation"]["type"],
                               compute_dtype=config["inference"][
                                   "compute_dtype"])
        self.device, self.mix = device, mix
        self.infer = infer_sequence_batch
        gen = weights.generator(seed, device)
        self.sd = weights.random_state(
            weights.layout(ref.FRNet, *self.dims), gen, device)
        self.net = FRNet.from_state_dict(self.cfg, self.sd, device).to(
            self.cfg.dtype)
        shape = (mix["streams"], mix["frames"], mix["height"], mix["width"],
                 3)
        self.pool = [torch.rand(shape, generator=gen, device=device)
                     for _ in range(mix["pool"])]
        self.sample_call = int(np.random.default_rng(
            seed % 2 ** 64).integers(0, SAMPLE_FROM_FIRST))
        self.calls, self.kept, self.spans = 0, None, []
        # warm-up: the one shape the window uses
        self._call(self.pool[-1])
        self._sync()

    def _call(self, x):
        return self.infer(self.net, x, self.cfg, chunk=self.mix["chunk"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        """One call, complete when its checksum is read back: the HR frames
        it made."""
        k = self.calls % len(self.pool)
        with span(self.spans, "call"):
            out = self._call(self.pool[k])
        with span(self.spans, "checksum"):
            int(out.sum(dtype=torch.int64))
        if self.calls == self.sample_call:
            self.kept = (k, out)
        self.calls += 1
        return out.shape[0] * out.shape[1]

    def pending(self) -> bool:
        """Whether the checked call has yet to run."""
        return self.kept is None

    def rates(self, units: int, seconds: float) -> dict:
        return {"infer_fps": units / seconds}

    def trace(self) -> dict:
        """Dispatch samples (host time of a call that starts with the device
        queue empty, until it returns) and a profiled steady sub-window."""
        dispatch = []
        for i in range(DISPATCH_SAMPLES):
            self._sync()
            t0 = time.perf_counter()
            self._call(self.pool[i % len(self.pool)])
            dispatch.append(time.perf_counter() - t0)
        self._sync()
        n, t, h, w, _ = self.pool[0].shape
        nf, nb, s = self.dims
        tr = profile(lambda: sum(self.unit() for _ in range(TRACE_UNITS)),
                     lambda frames: frames, self.device)
        dt = self.cfg.compute_dtype
        return {"kind": "infer", "trace": tr, "dispatch_s": dispatch,
                "calls": DISPATCH_SAMPLES + TRACE_UNITS,
                "flops_per_frame": counts.infer_frame_flops(h, w, nf, nb, s),
                "k1_bytes": counts.warp_bytes(n, 3, s * h, s * w, dt, dt)}

    def release(self):
        """Free the program's state; keep the sampled call's input and
        output."""
        k, out = self.kept
        self.kept = (self.pool[k], out)
        del self.net, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, x, rounding: str | None = None):
        """The plain reference's output on x; ``rounding`` "fp8": the
        control's operands."""
        net = ref.load(ref.FRNet(*self.dims), self.sd, self.device).eval()
        ref.ROUND["to"] = rounding
        try:
            with no_tf32():
                return net.infer(x)
        finally:
            ref.ROUND["to"] = None

    def check(self, limits: dict) -> list:
        x, out = self.kept
        got = readings(out, self.reference(x))
        return [{"name": k, "value": got[k], "limit": v}
                for k, v in limits["checks"].items()]
