"""Whole-clip inference of BasicVSR++: a closed loop of calls to the
program's ``infer_clip_batch`` (its generator built through
``define_generator``), each on ``streams`` whole clips of ``frames`` LR
frames of ``height`` x ``width``, cycling through a pool of ``pool`` seeded
batches made on the card in set-up, so that no call repeats the one
before. A call is complete when its uint8 output is summed on the card and
the checksum is read back.

The clips are smooth moving textures, not i.i.d. noise: each channel of a
clip is a sum of ``waves`` seeded sinusoidal gratings (frequencies up to
``max_freq`` cycles a pixel in each axis, seeded phases and weights), and
the whole clip drifts by a seeded constant velocity of up to
``max_speed`` pixels a frame in each axis, a sub-pixel pan, so that SPyNet
and the DCN sample real motion.

Correctness: the output of one call of the window, drawn from the seed
among the first ``SAMPLE_FROM_FIRST``, against the plain fp32 reference
(``reference/basicvsrpp.py``) run on the same LR clips with the same
weights, one clip at a time, once the window has closed and the program's
state is freed: gray levels of every frame (``infer_batch.readings``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import counts_basicvsrpp as counts
from .. import weights
from ..reference import basicvsrpp as ref
from ..reference.ops import ROUND
from ..reference.train import no_tf32
from ..trace import profile, span
from .infer_batch import readings

SAMPLE_FROM_FIRST = 4   # the checked call: one of the window's first calls
TRACE_UNITS = 1         # calls under the profiler


def moving_textures(mix: dict, gen: torch.Generator, device) -> torch.Tensor:
    """One batch of clips (streams, frames, height, width, 3) in [0, 1]
    (module docstring), drawn from ``gen`` on ``device``."""
    n, t, h, w = mix["streams"], mix["frames"], mix["height"], mix["width"]
    k = mix["waves"]

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    freq = (2.0 * draw(n, 3, k, 2) - 1.0) * mix["max_freq"]
    phase = 2.0 * math.pi * draw(n, 3, k)
    amp = draw(n, 3, k) + 0.25
    amp = amp / amp.sum(-1, keepdim=True)
    vel = (2.0 * draw(n, 2) - 1.0) * mix["max_speed"]
    tt = torch.arange(t, dtype=torch.float32, device=device)
    # each clip's sample coordinates: (n, t, h, 1) rows, (n, t, 1, w) cols
    ys = (torch.arange(h, dtype=torch.float32, device=device)[None, None]
          - vel[:, 0, None, None] * tt[None, :, None])[..., None]
    xs = (torch.arange(w, dtype=torch.float32, device=device)[None, None]
          - vel[:, 1, None, None] * tt[None, :, None])[:, :, None, :]
    out = torch.empty((n, t, h, w, 3), device=device)
    for c in range(3):
        acc = torch.zeros((n, t, h, w), device=device)
        for i in range(k):
            f = freq[:, c, i]
            arg = (2.0 * math.pi * (f[:, 0, None, None, None] * ys
                                    + f[:, 1, None, None, None] * xs)
                   + phase[:, c, i, None, None, None])
            acc += amp[:, c, i, None, None, None] * torch.sin(arg)
        out[..., c] = 0.5 + 0.45 * acc
    return out


class Driver:
    kind = "infer"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from tecogan_tpu_torch.models import networks

        g = config["generator"]
        opt = {"scale": config["scale"],
               "model": {"generator": dict(
                   g, compute_dtype=config["inference"]["compute_dtype"])},
               "dataset": {"degradation": config["degradation"]}}
        self.cfg, _ = networks.define_generator(opt)
        self.infer = networks.infer_clip_batch
        self.dims = (g["mid_channels"], g["num_blocks"],
                     g["max_residue_magnitude"], g["deform_groups"])
        self.device, self.mix = device, mix
        gen = weights.generator(seed, device)
        self.sd = weights.random_state(
            weights.layout(ref.BasicVSRPlusPlus, *self.dims), gen, device)
        scale = config.get("draw_scale", {})
        for name, v in self.sd.items():
            for suffix, s in scale.items():
                if name.endswith(suffix):
                    v.mul_(s)
        self.net = networks.BasicVSRPP.from_state_dict(
            self.cfg, self.sd, device).to(self.cfg.dtype)
        self.pool = [moving_textures(mix, gen, device)
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
        """A profiled steady sub-window, with the model FLOPs of a frame
        and the DCN's bytes and FLOPs at one frame step of the n clips."""
        self._sync()
        n, t, h, w, _ = self.pool[0].shape
        m, nb, _, groups = self.dims
        tr = profile(lambda: sum(self.unit() for _ in range(TRACE_UNITS)),
                     lambda frames: frames, self.device)
        return {"kind": "infer", "trace": tr, "calls": TRACE_UNITS,
                "flops_per_frame": counts.frame_flops(t, h, w, m, nb,
                                                      groups),
                "dcn_bytes": counts.dcn_bytes(n, h, w, m, groups,
                                              self.cfg.compute_dtype),
                "dcn_flops": counts.dcn_flops(n, h, w, m)}

    def release(self):
        """Free the program's state; keep the sampled call's input and
        output."""
        k, out = self.kept
        self.kept = (self.pool[k], out)
        del self.net, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, x, rounding: str | None = None):
        """The plain reference's output on x, clip by clip; ``rounding``
        "fp8": the control's operands."""
        net = ref.BasicVSRPlusPlus(*self.dims)
        net.load_state_dict({k: v.float() for k, v in self.sd.items()})
        net = net.to(self.device).eval()
        ROUND["to"] = rounding
        try:
            with no_tf32():
                return net.infer(x)
        finally:
            ROUND["to"] = None

    def check(self, limits: dict) -> list:
        x, out = self.kept
        got = readings(out, self.reference(x))
        return [{"name": k, "value": got[k], "limit": v}
                for k, v in limits["checks"].items()]
