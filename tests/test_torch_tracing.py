"""The port's spans and counters (``utils/tracing.py``) on the CPU: the
training steps' and ``stream_frames``' spans under the profiler, no span
entered while no profiler records, the serving export's graph without a
profiler node, the loader's counters over two epochs, and the warp launch
counters as they were. Tiny nets (nf 8-16, nb 1-2) drawn by the port."""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tecogan_tpu_torch import ops, serving
from tecogan_tpu_torch.data.loader import TrainLoader
from tecogan_tpu_torch.models import schedules, steps
from tecogan_tpu_torch.models.networks import (DTrunk, FRNet, FRNetConfig,
                                               STNetConfig)
from tecogan_tpu_torch.models.networks.frnet import stream_frames
from tecogan_tpu_torch.utils import tracing

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_S = 4
_HR = 32
_CB = {"type": "CB", "weight": 1, "reduction": "mean"}
_GAN = {"type": "GAN", "weight": 0.01, "reduction": "mean"}
_STEP_CHILDREN = {
    "frvsr": ["g_forward", "g_losses", "g_backward", "g_update"],
    "tecogan_pass": ["g_forward", "d_forward", "vote", "d_update",
                     "g_losses", "g_backward", "g_update"],
    "tecogan_skip": ["g_forward", "d_forward", "vote", "g_losses",
                     "g_backward", "g_update"],
}


def _step(kind, seed=0):
    """A step function of one tiny training state and its uint8 BD batch:
    FRVSR, or TecoGAN (STNet, ping-pong, no VGG19) with the adaptive vote
    forced to pass or to skip."""
    nf = 8 if kind == "frvsr" else 16
    cfg_g = FRNetConfig(nf=nf, nb=1, scale=_S)
    net_g = FRNet.random(cfg_g, torch.Generator().manual_seed(seed))
    og, sg = schedules.make_adam({"lr": 1e-4}, net_g.parameters())
    gt = torch.from_numpy((np.random.default_rng(seed).random(
        (1, 3, _HR + 8, _HR + 8, 3)) * 255).astype(np.uint8))
    base = dict(scale=_S, degradation="BD", sigma=1.5, pixel_crit=_CB,
                warping_crit=_CB)
    if kind == "frvsr":
        state = steps.frvsr_init_state(net_g, og)
        tcfg = steps.TrainConfig(**base)

        def run():
            steps.frvsr_train_step(state, {"gt": gt}, cfg_g=cfg_g, tcfg=tcfg,
                                   sched_g=sg)
        return run
    cfg_d = STNetConfig(spatial_size=_HR)
    net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(seed + 1))
    od, sd = schedules.make_adam({"lr": 1e-4}, net_d.parameters())
    state = steps.tecogan_init_state(net_g, net_d, og, od)
    tcfg = steps.TrainConfig(
        **base, tempo_extent=3, pingpong_crit={**_CB, "weight": 0.5},
        gan_crit=_GAN, update_policy="adaptive",
        update_threshold=1e9 if kind == "tecogan_pass" else -1e9)

    def run():
        steps.tecogan_train_step(state, {"gt": gt}, cfg_g=cfg_g, cfg_d=cfg_d,
                                 tcfg=tcfg, sched_g=sg, sched_d=sd)
    return run


def _stream(t, chunk):
    cfg = FRNetConfig(nf=8, nb=1, scale=_S)
    net = FRNet.random(cfg, torch.Generator().manual_seed(2))
    x = torch.rand((2, t, 8, 12, 3), generator=torch.Generator()
                   .manual_seed(3))

    def run():
        with torch.inference_mode():
            return stream_frames(net, x, cfg, chunk)
    return run


def _profiled(run):
    """``run()`` under the CPU profiler: the ``tecogan.`` ranges it
    recorded [(name, start_ns, end_ns, user-scope?)] in start order, and
    the spans the program kept meanwhile."""
    n = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ranges = sorted((e.name(), e.start_ns(), e.end_ns(),
                     e.is_user_annotation())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("tecogan."))
    ranges.sort(key=lambda r: r[1])
    return ranges, tracing.spans()[n:]


@pytest.mark.parametrize("kind", list(_STEP_CHILDREN))
def test_a_step_records_its_span_and_the_phases_inside_it(kind):
    run = _step(kind)
    ranges, kept = _profiled(run)
    names = [r[0] for r in ranges]
    assert names == ["tecogan.train.step"] + [
        "tecogan.train." + c for c in _STEP_CHILDREN[kind]]
    _, s0, e0, _ = ranges[0]
    for _, s, e, _ in ranges[1:]:
        assert s0 <= s <= e <= e0
    for (_, _, e, _), (_, s, _, _) in zip(ranges[1:], ranges[2:]):
        assert e <= s  # the phases follow each other
    # operator-scope ranges: kineto makes no device-side copy of them
    assert not any(r[3] for r in ranges)
    # the program keeps the same spans, the step's index in its args, on
    # the profiler's clock
    step = [k for k in kept if k.name == "train.step"]
    assert len(step) == 1 and step[0].args == {"step": 0}
    assert sorted(k.name for k in kept) == sorted(n[len("tecogan."):]
                                                  for n in names)
    for k in kept:
        s = next(r[1] for r in ranges if r[0] == "tecogan." + k.name)
        assert abs(k.start_ns - s) < 50_000_000
        assert k.marks is None and k.device_ms() is None
    assert names.count("tecogan.train.vote") == (kind != "frvsr")


@pytest.mark.parametrize("t,chunk", [(5, 2), (4, 4)])
def test_stream_frames_records_one_span_of_each_kind_per_chunk(t, chunk):
    ranges, kept = _profiled(_stream(t, chunk))
    n_chunks = -(-t // chunk)
    names = [r[0] for r in ranges]
    assert names == ["tecogan.infer.chunk", "tecogan.infer.fnet",
                     "tecogan.infer.recurrence"] * n_chunks
    for k in range(n_chunks):
        _, s0, e0, _ = ranges[3 * k]
        assert all(s0 <= s <= e <= e0 for _, s, e, _ in
                   ranges[3 * k + 1:3 * k + 3])
    assert sorted(k.name for k in kept) == sorted(
        n[len("tecogan."):] for n in names)


@pytest.mark.parametrize("what", ["frvsr", "tecogan_pass", "stream"])
def test_no_span_is_entered_while_no_profiler_records(monkeypatch, what):
    entered = []

    def counting(real):
        # torch's own ranges (Adam's step) are entered with no profiler too
        def wrapped(name, *a, **kw):
            if str(name).startswith("tecogan."):
                entered.append(name)
            return real(name, *a, **kw)
        return wrapped

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting(torch.ops.profiler
                                 ._record_function_enter_new))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    run = _stream(5, 2) if what == "stream" else _step(what)
    n = len(tracing.spans())
    assert tracing.span("x") is tracing.span("y")  # one shared no-op
    run()
    assert entered == []
    assert len(tracing.spans()) == n


def test_export_stream_graph_has_no_profiler_node_and_is_unchanged(
        monkeypatch):
    cfg = FRNetConfig(nf=8, nb=1, scale=_S)
    sd = FRNet.random(cfg, torch.Generator().manual_seed(0)).state_dict()

    def graph():
        blob = serving.export_stream(sd, cfg, 1, 5, 16, 24, chunk=4,
                                     platforms=["cpu"])
        return torch.export.load(io.BytesIO(blob)).graph

    with_spans = graph()
    targets = [str(n.target) for n in with_spans.nodes]
    assert not [t for t in targets if "profiler" in t or "record" in t]
    # the same graph as a program with no spans at all
    monkeypatch.setattr(tracing, "span",
                        lambda *a, **kw: contextlib.nullcontext())
    assert str(graph()) == str(with_spans)


class _Plain:
    """A dataset of 7 samples of 2x2 uint8 frames, each filled with its
    index: the loader stacks samples."""

    def __len__(self):
        return 7

    def __getitem__(self, item_rng):
        i, _ = item_rng
        return {"gt": np.full((2, 2), i, np.uint8)}


class _Planned(_Plain):
    """The same samples through the clip datasets' interface: the loader
    preallocates each batch and assembles every sample into its slot."""

    def batch_spec(self):
        return {"gt": ((2, 2), np.uint8)}

    def sample_plan(self, i, rng):
        return i

    def assemble(self, plan, out):
        out["gt"][...] = plan


@pytest.mark.parametrize("dataset", [_Plain, _Planned])
def test_loader_counts_epoch_starts_and_the_batches_it_built(dataset):
    loader = TrainLoader(dataset(), batch_size=2, seed=5, num_workers=2)
    c0 = tracing.counters()
    served = [b["gt"] for e in range(2) for b in loader.epoch(e)]
    c1 = tracing.counters()
    delta = {k: c1[k] - c0[k] for k in c1}
    assert len(served) == 2 * len(loader) == 6
    assert delta["loader.epoch_starts"] == 2
    assert delta["loader.assembled"] == len(served)
    assert delta["loader.assemble_s"] > 0
    assert delta["loader.epoch_start_wait_s"] > 0
    # a snapshot: the caller's dict does not move with the counters
    c1["loader.assembled"] += 100
    assert tracing.counters()["loader.assembled"] == (
        c0["loader.assembled"] + len(served))
    with pytest.raises(KeyError):
        tracing.add("loader.unknown", 1)


def test_kernel_launches_keep_their_keys_and_counts_under_spans():
    keys = ["K1", "K1 band", "K1 window", "K2", "K3", "K3+K4", "K4", "K5",
            "K1 zero", "DCN", "Epilogue"]
    before = ops.kernel_launches()
    assert list(before) == keys
    _profiled(_stream(5, 2))
    _stream(5, 2)()
    # the CPU takes every warp's plain version: no kernel is launched
    assert ops.kernel_launches() == before
    assert not set(keys) & set(tracing.counters())


def _span_split():
    spec = importlib.util.spec_from_file_location(
        "span_split", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "span_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MS = 1_000_000


@pytest.mark.parametrize("case", ["vote", "fnet"])
def test_span_split_attributes_launches_and_idle_to_the_innermost_span(
        case):
    """``span_split.reduce`` on a synthetic profile: a kernel belongs to
    the innermost program span around its launch, an idle
    gap is named by the harness's span, the innermost program span and
    the innermost op, and a device-side copy of a span is counted."""
    inner = "tecogan.train.vote" if case == "vote" else "tecogan.infer.fnet"
    op = "aten::_local_scalar_dense" if case == "vote" else "aten::conv2d"
    ev = [(False, "vsrbench.traced_window", 0, 100 * _MS, 0),
          (False, "vsrbench.step", 1 * _MS, 90 * _MS, 0),
          (False, "tecogan.outer", 2 * _MS, 80 * _MS, 0),
          (False, inner, 30 * _MS, 60 * _MS, 0),
          (False, op, 31 * _MS, 59 * _MS, 0),
          # launches: one inside the inner span, one inside the outer span
          # alone, one outside every program span
          (False, "cudaLaunchKernel", 32 * _MS, 33 * _MS, 7),
          (False, "cuLaunchKernel", 5 * _MS, 6 * _MS, 8),
          (False, "cudaLaunchKernel", 85 * _MS, 86 * _MS, 9),
          (True, "k_inner", 50 * _MS, 60 * _MS, 7),
          (True, "k_outer", 10 * _MS, 20 * _MS, 8),
          (True, "k_after", 86 * _MS, 88 * _MS, 9),
          (True, "k_unlinked", 90 * _MS, 91 * _MS, 99),
          (True, "tecogan.outer", 10 * _MS, 60 * _MS, 0)]
    kept = [tracing.SpanRecord(inner[len("tecogan."):], None, 30 * _MS + 5,
                               60 * _MS, None)]
    out = _span_split().reduce(ev, 0, 100 * _MS, kept)
    assert out["device_copies"] == {"tecogan.": 1}
    assert out["kernels"] == 4 and out["device_s"] == pytest.approx(0.023)
    assert out["in_spans"]["share"] == pytest.approx(20 / 23)
    assert out["in_spans"]["unlinked_s"] == {"k_unlinked": 0.001}
    assert out["by_span"]["device_s"] == {
        inner: pytest.approx(0.01), "tecogan.outer": pytest.approx(0.01)}
    # the longest gap, 20-50 ms: 20-30 in the outer span, 30-50 inside the
    # inner one
    assert out["idle_gaps"][0] == [f"vsrbench.step / {inner} / {op}",
                                   pytest.approx(0.03)]
    idle = out["by_span"]["idle_s"]
    assert idle[inner] == pytest.approx(0.02)
    assert idle["tecogan.outer"] == pytest.approx(0.008 + 0.010 + 0.020)
    assert out["clock"] == {"spans_matched": 1, "max_offset_us": 0.005}
