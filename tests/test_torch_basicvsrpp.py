"""BasicVSR++ in the port (``models/networks/basicvsrpp.py``, ``ops/dcn.py``,
K1's zero padding) against the benchmark's plain fp32 reference
(``vsrbench/reference/basicvsrpp.py``) and ``F.grid_sample`` on the CPU,
where every kernel wrapper takes its plain version; the normal path
(``define_generator``, ``VSRModel.infer``, test mode's CLI), its spans and
launch counters, and the benchmark's counts, driver and faults for the
cell."""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from torch.utils.flop_counter import FlopCounterMode

from tecogan_tpu_torch import ops
from tecogan_tpu_torch.main import main as torch_main
from tecogan_tpu_torch.models import VSRModel
from tecogan_tpu_torch.models.networks import (BasicVSRPP, BasicVSRPPConfig,
                                               define_generator,
                                               infer_clip_batch)
from tecogan_tpu_torch.models.networks import basicvsrpp as port
from tecogan_tpu_torch.ops import dcn
from tecogan_tpu_torch.ops.warp_cuda import warp_zero, warp_zero_reference
from tecogan_tpu_torch.utils import tracing
from tecogan_tpu_torch.utils.png import read_png, write_png
from tecogan_tpu_torch.utils.yaml_subset import safe_load
from vsrbench import counts_basicvsrpp, harness, weights
from vsrbench.drivers import infer_clips
from vsrbench.drivers.infer_batch import readings
from vsrbench.reference import basicvsrpp as ref
from vsrbench.reference.train import no_tf32

from torch_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
YML = osp.join(ROOT, "torch_experiments", "BI", "BasicVSRPP",
               "BasicVSRPP_REDS4_4xSR", "test.yml")
# a small BasicVSR++: 16 channels, 2 blocks, 4 deformable groups of the
# DCN's 32 input channels (the kernel's 8 a group)
M, NB, G = 16, 2, 4


def _clips(n, t, h, w, seed=0):
    """(n, t, h, w, 3) float in [0, 1]: smooth gratings drifting by a
    sub-pixel velocity per clip (the benchmark's textures)."""
    gen = torch.Generator().manual_seed(seed)
    mix = {"streams": n, "frames": t, "height": h, "width": w, "waves": 6,
           "max_freq": 0.12, "max_speed": 2.5}
    return infer_clips.moving_textures(mix, gen, "cpu")


def _state(seed, m=M, nb=NB, groups=G):
    """A state dict in mmagic's names drawn as the benchmark draws it, with
    the configuration's draw scales (conv_offset's last convolution, the
    DCN's weight)."""
    sd = weights.random_state(weights.layout(ref.BasicVSRPlusPlus, m, nb, 10,
                                             groups),
                              weights.generator(seed, "cpu"), "cpu")
    scale = harness.load_json(osp.join(
        ROOT, "vsrbench", "configs", "basicvsrpp_4x_reds.json"))["draw_scale"]
    for k, v in sd.items():
        for suffix, s in scale.items():
            if k.endswith(suffix):
                v.mul_(s)
    return sd


def _reference(sd, lr, m=M, nb=NB, groups=G):
    net = ref.BasicVSRPlusPlus(m, nb, 10, groups)
    net.load_state_dict(sd)
    with no_tf32():
        return net.eval().infer(lr)


# the worst frame's mean gray-level gap and the largest gap allowed. fp32:
# the port and the reference take the same operations in other orders (the
# warps' weights, the DCN's gathers and product), a few fp32 ulps apart, so
# a value that lands on a .5 boundary may round to the next gray level; on
# 2 x 6 frames that was 1 value of 294912. bf16: every convolution rounds
# its operands and output to 8 bits of mantissa, about 0.4% of a value; the
# network's part of a frame is a few gray levels, so about 3% of values
# move by one level (0.029 read on this input).
TOL = {"float32": (1e-3, 1), "bfloat16": (0.1, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_reference(dtype):
    sd = _state(3)
    lr = _clips(2, 6, 48, 64)
    want = _reference(sd, lr)
    cfg = BasicVSRPPConfig(mid_channels=M, num_blocks=NB, deform_groups=G,
                           compute_dtype=dtype)
    net = BasicVSRPP.from_state_dict(cfg, sd)
    got = infer_clip_batch(net, lr, cfg, chunk=4)
    assert got.shape == (2, 6, 192, 256, 3) and got.dtype == torch.uint8
    got_r = readings(got, want)
    worst, largest = TOL[dtype]
    assert got_r["frame_mad_worst"] <= worst, got_r
    assert got_r["max_abs"] <= largest, got_r
    # the network's part of the frame is not negligible: the output is
    # not the bilinear upsampling alone
    base = ref.quantize(F.interpolate(
        lr.reshape(-1, 48, 64, 3).permute(0, 3, 1, 2), scale_factor=4,
        mode="bilinear", align_corners=False)).permute(0, 2, 3, 1)
    assert (got.reshape(base.shape).int() - base.int()).abs().float().mean() \
        > 0.5


def test_published_widths_match_the_reference():
    """64 channels, 7 blocks, 16 groups (the published widths) on one clip
    of 3 frames of 32x32, fp32 (tolerance: ``TOL``)."""
    sd = _state(5, 64, 7, 16)
    lr = _clips(1, 3, 32, 32, seed=1)
    want = _reference(sd, lr, 64, 7, 16)
    cfg = BasicVSRPPConfig()
    got = infer_clip_batch(BasicVSRPP.from_state_dict(cfg, sd), lr, cfg)
    got_r = readings(got, want)
    assert got_r["frame_mad_worst"] <= TOL["float32"][0], got_r
    assert got_r["max_abs"] <= TOL["float32"][1], got_r


def _dcn_operands(gen, n, c, h, w, groups, sigma):
    x = torch.randn((n, c, h, w), generator=gen)
    raw = torch.randn((n, 27 * groups, h, w), generator=gen)
    f1, f2 = (sigma * torch.randn((n, 2, h, w), generator=gen)
              for _ in range(2))
    return x, raw, f1, f2


def _mmagic_offsets(raw, f1, f2, mag):
    """mmagic's SecondOrderDeformableAlignment epilogue: the offset and the
    mask the reference's DCN takes."""
    o1, o2, mask = torch.chunk(raw.float(), 3, 1)
    off = mag * torch.tanh(torch.cat((o1, o2), 1))
    a, b = torch.chunk(off, 2, 1)
    a = a + f1.flip(1).repeat(1, a.size(1) // 2, 1, 1)
    b = b + f2.flip(1).repeat(1, b.size(1) // 2, 1, 1)
    return torch.cat([a, b], 1), torch.sigmoid(mask)


@pytest.mark.parametrize("sigma", [0.5, 20.0])
def test_dcn_matches_the_reference_gathers(sigma):
    """The op with its fused epilogue against mmcv's formula written out
    (the reference's gathers) with mmagic's offsets; sigma 20 puts most
    taps outside the 10x14 frame. fp32: the two sum the same products in
    other orders (1e-5 of values of about 3)."""
    gen = torch.Generator().manual_seed(int(sigma * 10))
    x, raw, f1, f2 = _dcn_operands(gen, 2, 32, 10, 14, 4, sigma)
    weight = torch.randn((16, 32, 3, 3), generator=gen) / 17
    bias = torch.randn((16,), generator=gen)
    got = dcn.modulated_deform_conv(x, raw, f1, f2, weight, bias, 10.0, 4)
    offset, mask = _mmagic_offsets(raw, f1, f2, 10.0)
    want = ref.modulated_deform_conv(x, offset, mask, weight, bias, 4)
    assert got.shape == (2, 16, 10, 14)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    # bf16 channels_last operands: the columns are the fp32 ones rounded
    # to bf16 (the plain version samples in fp32)
    cl = [t.to(torch.bfloat16, memory_format=torch.channels_last)
          for t in (x, raw)]
    col16 = dcn.dcn_columns(*cl, f1, f2, 10.0, 4)
    col32 = dcn.dcn_columns(cl[0].float(), cl[1].float(), f1, f2, 10.0, 4)
    assert col16.dtype == torch.bfloat16
    torch.testing.assert_close(col16, col32.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_dcn_channel_layout_is_mmcv():
    """Offset channel 2 (9 g + k) moves tap k of group g down, 2 (9 g + k)
    + 1 right, and mask channel 18 G + 9 g + k scales it: each lands in
    columns k C + 8 g .. k C + 8 g + 7 alone. The first G/2 groups follow
    flow1, the rest flow2."""
    gen = torch.Generator().manual_seed(7)
    n, c, h, w, groups = 1, 32, 9, 11, 4
    x = torch.randn((n, c, h, w), generator=gen)
    zero = torch.zeros((n, 27 * groups, h, w))
    flat = torch.zeros((n, 2, h, w))
    base = dcn.dcn_columns(x, zero, flat, flat, 10.0, groups)

    def block(col, g, k):
        return col.view(h, w, 9, c)[:, :, k, 8 * g:8 * g + 8]

    g, k = 2, 4  # group 2 (of the second flow's half), the centre tap
    atanh_half = float(np.arctanh(0.5))  # 10 tanh -> 5 pixels
    for ch, (dy, dx) in ((2 * (9 * g + k), (5, 0)),
                         (2 * (9 * g + k) + 1, (0, 5))):
        raw = zero.clone()
        raw[:, ch] = atanh_half
        col = dcn.dcn_columns(x, raw, flat, flat, 10.0, groups)
        changed = (col != base).view(h, w, 9, c).any(0).any(0)
        assert changed.nonzero()[:, 0].unique().tolist() == [k]
        assert changed[k].nonzero()[:, 0].tolist() == list(
            range(8 * g, 8 * g + 8))
        # the centre tap of pixel (0, 0) now reads pixel (dy, dx), by half
        got = block(col, g, k)[0, 0]
        torch.testing.assert_close(got, 0.5 * x[0, 8 * g:8 * g + 8, dy, dx],
                                   rtol=0, atol=1e-6)
    raw = zero.clone()
    raw[:, 18 * groups + 9 * g + k] = -1e4  # mask 0
    col = dcn.dcn_columns(x, raw, flat, flat, 10.0, groups)
    assert (block(col, g, k) == 0).all()
    assert torch.equal(block(col, g, 3), block(base, g, 3))
    # a flow of 3 rows: flow1 moves groups 0-1, flow2 groups 2-3
    down = torch.zeros((n, 2, h, w))
    down[:, 1] = 3.0
    col = dcn.dcn_columns(x, zero, down, flat, 10.0, groups)
    moved = (col != base).view(h, w, 9, c).any(0).any(0).any(0)
    assert moved.nonzero()[:, 0].tolist() == list(range(16))
    # taps outside the frame read zero: pixel (h-1, w-1)'s bottom-right
    # tap moved 3 rows down
    assert (col.view(h, w, 9, c)[h - 1, w - 1, 8, :16] == 0).all()


@pytest.mark.parametrize("sigma", [0.7, 6.0, 40.0])
def test_k1_zero_padding_matches_grid_sample(sigma):
    """K1's zero-padding plain version against ``F.grid_sample(zeros,
    align_corners=True)`` (fp32: grid_sample's normalised coordinates
    round trip, a few ulps of the sample point), and a channels_last image
    keeps its layout."""
    gen = torch.Generator().manual_seed(int(sigma))
    n, c, h, w = 2, 5, 12, 17
    x = torch.randn((n, c, h, w), generator=gen)
    flow = sigma * torch.randn((n, h, w, 2), generator=gen)
    got = warp_zero(x, flow)
    ii, jj = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(),
                            indexing="ij")
    grid = torch.stack([(jj + flow[..., 0]) * 2 / (w - 1) - 1,
                        (ii + flow[..., 1]) * 2 / (h - 1) - 1], -1)
    want = F.grid_sample(x, grid, padding_mode="zeros", align_corners=True)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    if sigma > 6:
        assert (got == 0).float().mean() > 0.3  # many samples leave
    cl = x.to(memory_format=torch.channels_last)
    got_cl = warp_zero(cl, flow)
    assert got_cl.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got_cl, got)
    assert torch.equal(warp_zero_reference(x, flow), got)


def _opt(**generator):
    with open(YML) as f:
        opt = safe_load(f.read())
    opt["model"]["generator"].update(generator)
    opt["device_ids"] = []
    return opt


def test_define_generator_reads_the_shipped_yaml():
    cfg, build = define_generator(_opt())
    assert cfg == BasicVSRPPConfig(64, 7, 10.0, 16, "bfloat16")
    small, build = define_generator(_opt(mid_channels=M, num_blocks=NB,
                                         deform_groups=G))
    net = build(torch.Generator().manual_seed(0))
    assert isinstance(net, BasicVSRPP)
    assert sum(p.numel() for p in BasicVSRPP.random(
        cfg, torch.Generator().manual_seed(0)).parameters()) == 7322927
    bad = _opt()
    bad["scale"] = 2
    with pytest.raises(ValueError, match="4x"):
        define_generator(bad)


def test_vsr_model_infers_whole_clips_and_refuses_training(tmp_path):
    opt = _opt(mid_channels=M, num_blocks=NB, deform_groups=G,
               compute_dtype="float32")
    sd = _state(9)
    path = str(tmp_path / "bvpp.pth")
    # mmagic's checkpoint form: ``state_dict`` of ``generator.`` names
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}},
               path)
    opt["model"]["generator"]["load_path"] = path
    model = VSRModel(opt)
    assert model.whole_clip
    lr = _clips(1, 5, 32, 48, seed=2)[0]
    got = model.infer(lr.numpy())
    cfg = model.cfg_g
    want = infer_clip_batch(BasicVSRPP.from_state_dict(cfg, sd), lr[None],
                            cfg)[0]
    np.testing.assert_array_equal(got, want.numpy())
    opt["is_train"] = True
    opt["train"] = {"ckpt_dir": str(tmp_path)}
    with pytest.raises(NotImplementedError, match="not supported yet"):
        VSRModel(opt)


def test_cli_test_mode_on_a_png_set(tmp_path):
    """``main.py --mode test`` on the shipped YAML's layout (small widths,
    a tiny REDS-like BI set with LR): one PNG per GT frame, equal to
    ``VSRModel.infer`` on the LR PNGs, and a finite RGB PSNR."""
    t, h, w = 4, 24, 32
    lr = (_clips(1, t, h, w, seed=4)[0].numpy() * 255).round().astype(
        np.uint8)
    gt = np.repeat(np.repeat(lr, 4, 1), 4, 2)
    for sub, frames in (("GT", gt), ("LR", lr)):
        os.makedirs(tmp_path / sub / "000")
        for i, f in enumerate(frames):
            write_png(str(tmp_path / sub / "000" / f"{i:08d}.png"), f)
    sd = _state(11)
    torch.save(sd, str(tmp_path / "bvpp.pth"))
    opt = _opt(mid_channels=M, num_blocks=NB, deform_groups=G,
               load_path=str(tmp_path / "bvpp.pth"))
    opt.pop("device_ids")
    opt["dataset"]["test1"].update(gt_seq_dir=str(tmp_path / "GT"),
                                   lr_seq_dir=str(tmp_path / "LR"),
                                   num_worker_per_gpu=1)
    exp = tmp_path / "exp"
    opt["test"]["res_dir"] = str(exp / "results")
    opt["test"].update(save_json=True, json_dir=str(exp / "metrics"))
    os.makedirs(exp)
    with open(exp / "test.yml", "w") as f:
        yaml.safe_dump(opt, f)
    records = torch_main(["--exp_dir", str(exp), "--mode", "test", "--opt",
                          str(exp / "test.yml"), "--gpu_ids", "-1"])
    assert [r["frames"] for r in records] == [t]
    assert np.isfinite(float(records[0]["metrics"]["PSNR"]))
    out_dir = exp / "results" / "REDS4" / "bvpp" / "000"
    got = np.stack([read_png(str(out_dir / f"{i:08d}.png"))
                    for i in range(t)])
    opt["device_ids"] = []
    want = VSRModel(opt).infer(lr.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got, want)


def test_spans_and_launch_counters():
    cfg = BasicVSRPPConfig(mid_channels=M, num_blocks=NB, deform_groups=G)
    net = BasicVSRPP.random(cfg, torch.Generator().manual_seed(1))
    t, chunk = 5, 2
    lr = _clips(2, t, 16, 24)
    before = len(tracing.spans())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        infer_clip_batch(net, lr, cfg, chunk=chunk)
    new = tracing.spans()[before:]
    names = [s.name for s in new]
    assert names.count("infer.flow") == 1
    assert [s.args for s in new if s.name == "infer.propagate"] == [
        {"branch": j} for j in range(4)]
    assert names.count("infer.align") == names.count("infer.dcn") == 4 * (
        t - 1)
    assert names.count("infer.reconstruct") == -(-t // chunk)
    # each DCN span lies inside an alignment span
    aligns = [s for s in new if s.name == "infer.align"]
    for s, a in zip([s for s in new if s.name == "infer.dcn"], aligns):
        assert a.start_ns <= s.start_ns <= s.end_ns <= a.end_ns
    # the CPU takes every plain version: no kernel is launched, and the
    # counters read the wrappers' counts
    counts = ops.kernel_launches()
    assert counts["K1 zero"] == counts["DCN"] == 0
    port.warp_zero.launches += 3
    dcn.dcn_columns.launches += 2
    assert ops.kernel_launches()["K1 zero"] == 3
    assert ops.kernel_launches()["DCN"] == 2
    ops.reset_kernel_launches()
    assert ops.kernel_launches()["DCN"] == 0


def test_counts_match_flop_counter():
    """``counts_basicvsrpp.frame_flops`` is the reference's convolutions
    and DCN product as ``FlopCounterMode`` counts them, and the DCN's
    bytes at the REDS4 shape are the issue's 72.8 MB a frame step."""
    m, nb, groups, t, h, w = 16, 2, 4, 3, 36, 40
    net = ref.BasicVSRPlusPlus(m, nb, 10, groups).eval()
    lr = _clips(1, t, h, w)
    with FlopCounterMode(display=False) as fc:
        net.infer(lr)
    assert fc.get_total_flops() == pytest.approx(
        t * counts_basicvsrpp.frame_flops(t, h, w, m, nb, groups), rel=1e-12)
    assert counts_basicvsrpp.dcn_bytes(1, 180, 320, 64, 16, "bfloat16") == (
        72953984)
    assert abs(counts_basicvsrpp.frame_flops(100, 180, 320, 64, 7, 16)
               - 0.8698e12) < 1e9


def _toy_cell():
    cell = harness.find_cell(harness.load_json(osp.join(
        ROOT, "BENCHMARK.json")), "basicvsrpp_4x_reds.infer_reds4",
        osp.join(ROOT, "vsrbench"))
    cell["config_data"]["generator"].update(mid_channels=M, num_blocks=NB,
                                            deform_groups=G)
    cell["mix"].update(streams=1, frames=6, height=24, width=32, pool=2,
                       chunk=3)
    return cell


def test_driver_checks_its_sampled_call_and_faults_move_it():
    """The cell's driver on the CPU at toy widths: the sampled call against
    the reference reads inside bf16's gap, and each planted fault changes
    the program's output."""
    from vsrbench import faults_basicvsrpp

    cell = _toy_cell()
    cpu = torch.device("cpu")

    def run(fault=None):
        import contextlib
        with (faults_basicvsrpp.planted(fault) if fault
              else contextlib.nullcontext()):
            drv = infer_clips.Driver(cell["config_data"], cell["mix"],
                                     2 ** 33 + 5, cpu)
            while drv.pending():
                drv.unit()
            drv.release()
        return drv

    drv = run()
    x, out = drv.kept
    assert out.shape == (1, 6, 96, 128, 3)
    # the cell's limit is set at its own size; at these toy widths bf16
    # flips 1-4% of the gray levels (0.017-0.039 read over three seeds)
    checks = drv.check({"checks": {"frame_mad_worst": 0.1}})
    assert harness.verdict(checks), checks
    for fault in faults_basicvsrpp.FAULTS:
        faulty = run(fault).kept[1]
        assert not torch.equal(faulty, out), fault
    with pytest.raises(ValueError, match="unknown fault"):
        with faults_basicvsrpp.planted("nothing"):
            pass


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, vsrbench.reference.basicvsrpp, "
            "vsrbench.counts_basicvsrpp\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tecogan_tpu', 'tecogan_tpu_torch', 'jax')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_new_readers_report_nothing_without_the_program_spans():
    """A record without the DCN's counts (a program that predates them) or
    without device time gives no reading."""
    root = osp.join(ROOT, "vsrbench")

    class Idle:
        busy_s, units, window_s, kernels = 0.0, 0, 1.0, []

    for name in ("dcn_roofline.infer", "align_ms_per_frame.infer",
                 "flow_ms_per_frame.infer"):
        read = harness.reader(name, root)
        assert read({"kind": "infer", "trace": Idle()}) is None
        assert read({"kind": "train", "trace": Idle()}) is None


@pytest.mark.parametrize("kernel", ["zero", "zero_nhwc", "dcn"])
def test_wrappers_pack_what_the_c_launchers_read(monkeypatch, kernel):
    """``warp_zero`` (either entry point, chosen by the image's layout) and
    ``dcn_columns`` hand their C entry point the stream where its launcher
    reads it and, at every ``strides_from(a + k)``, the element strides of
    the tensor it stands for. The wrappers run on CPU tensors with the
    device checks and the launch stubbed out."""
    import re

    from tecogan_tpu_torch import kernel_build
    from tecogan_tpu_torch.ops import warp_cuda

    calls = []
    for mod in (warp_cuda, dcn):
        monkeypatch.setattr(mod, "launch",
                            lambda name, index, *a: calls.append((name, a)))
        monkeypatch.setattr(mod, "all_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "cuda_index", lambda name, *t: 0)
    flow = torch.randn(2, 2, 6, 9).permute(0, 2, 3, 1)  # an NCHW view
    feat = torch.randn(2, 16, 6, 9).contiguous(
        memory_format=torch.channels_last)
    plain = torch.randn(2, 2, 6, 9)
    x = torch.randn(2, 32, 6, 9).contiguous(memory_format=torch.channels_last)
    raw = torch.randn(2, 108, 6, 9).contiguous(
        memory_format=torch.channels_last)
    f1, f2 = torch.randn(2, 2, 6, 9), torch.randn(2, 6, 9, 2).permute(
        0, 3, 1, 2)
    run, strides, source, launcher, entry = {
        "zero": (lambda: warp_zero(plain, flow), [plain, plain, flow],
                 "warp_planes.cu", "launch_zero", "tecogan_warp_zero_f32_f32"),
        "zero_nhwc": (lambda: warp_zero(feat, flow), [feat, feat, flow],
                      "warp_planes.cu", "launch_zero_nhwc",
                      "tecogan_warp_zero_nhwc_f32"),
        "dcn": (lambda: dcn.dcn_columns(x, raw, f1, f2, 10.0, 4),
                [x, raw, f1, f2], "dcn.cu", "launch_columns",
                "tecogan_dcn_columns_f32"),
    }[kernel]
    run()
    ((name, args),) = calls
    assert name == entry
    text = (kernel_build.CSRC_DIR / source).read_text()
    body = re.search(rf"\nint {launcher}\(const int64_t\* a\) \{{(.*?)\n\}}",
                     text, re.S).group(1)
    (stream,) = re.findall(r"arg_ptr<CUstream_st>\(a, (\d+)\)", body)
    assert len(args) == int(stream)
    offsets = [int(k) for k in re.findall(r"strides_from\(a \+ (\d+)\)",
                                          body)]
    assert [tuple(args[k:k + 4]) for k in offsets] == [
        t.stride() for t in strides]
    if kernel == "dcn":
        assert args[11] == 1  # channels_last x: one vector load a corner
        assert np.float32(10.0).view(np.uint32) == args[10]
