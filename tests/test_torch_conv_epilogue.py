"""The bf16 inference convolutions' epilogue on the CPU: its plain version
(``ops/conv_epilogue.py``) against PyTorch's unfused bf16 chain, the
operator's fake and its checks, what the wrapper hands the C launcher, and
the route (``nn.conv_act``) in FNet, SRNet and BasicVSR++: fused only for
a convolution whose weight is bf16 channels_last on a card, with autograd
off, bit-identical there to the chain the card runs without it, and
PyTorch's own ops everywhere else. The kernel itself runs only on a card (``chip_smoke.phase_epilogue``).
"""

import io
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from tecogan_tpu_torch import kernel_build, ops
from tecogan_tpu_torch import nn as tnn
from tecogan_tpu_torch.models.networks import basicvsrpp, fnet, srnet
from tecogan_tpu_torch.ops import conv_epilogue as ep

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CL = torch.channels_last
ACTS = {"none": None, "relu": nn.ReLU(), "leaky0.2": nn.LeakyReLU(0.2),
        "leaky0.1": nn.LeakyReLU(0.1)}


def _code(act):
    if act is None:
        return ep.ACT_NONE, 0.0
    if isinstance(act, nn.LeakyReLU):
        return ep.ACT_LEAKY_RELU, act.negative_slope
    return ep.ACT_RELU, 0.0


def _operands(c, residual, seed=0, shape=(2, 5, 7)):
    """A channels_last bf16 output y (n, c, h, w), a bf16 bias and a
    residual in the form ``residual`` names (None, "nhwc", "nchw")."""
    gen = torch.Generator().manual_seed(seed)
    n, h, w = shape
    y = (3 * torch.randn(n, c, h, w, generator=gen)).to(torch.bfloat16,
                                                         memory_format=CL)
    bias = torch.randn(c, generator=gen).bfloat16()
    res = None
    if residual is not None:
        res = torch.randn(n, c, h, w, generator=gen).bfloat16()
        if residual == "nhwc":
            res = res.contiguous(memory_format=CL)
    return y, bias, res


def _chain(y, bias, act, res):
    """PyTorch's unfused bf16 ops, as the card runs them after a
    convolution without its bias: the broadcast bias add, the activation
    module, the residual as the left operand."""
    t = y + bias.view(1, -1, 1, 1)
    if act is not None:
        t = act(t)
    return t if res is None else res + t


@pytest.mark.parametrize("c", [2, 3, 16, 32, 64, 432])
@pytest.mark.parametrize("residual", [None, "nhwc", "nchw"])
@pytest.mark.parametrize("act", list(ACTS))
def test_plain_version_is_the_unfused_bf16_chain(c, residual, act):
    """Bit for bit and layout for layout, for every activation, every
    residual form and the paths' widths (2 and 3: the flow heads and
    conv_out; 432: conv_offset's last)."""
    y, bias, res = _operands(c, residual, seed=c)
    _assert_chain(y, bias, res, act, residual)


@pytest.mark.parametrize("residual", [None, "nchw"])
def test_plain_version_takes_an_nchw_y(residual):
    """y of any strides (a traced program's fake convolution output is
    contiguous): the output in the residual's layout, else y's."""
    y, bias, res = _operands(16, residual)
    _assert_chain(y.contiguous(), bias, res, "relu", residual)


def _assert_chain(y, bias, res, act, residual):
    want = _chain(y, bias, ACTS[act], res)
    got = ep.conv_epilogue(y, bias, res, *_code(ACTS[act]))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert got.stride() == want.stride()
    if residual == "nchw":
        assert got.is_contiguous()


@pytest.mark.parametrize("residual", [None, "nhwc", "nchw", "nchw y"])
def test_operator_fake_gives_the_outputs_shape_and_layout(residual):
    y, bias, res = _operands(3 if residual == "nchw" else 16,
                             None if residual == "nchw y" else residual)
    if residual == "nchw y":
        y = y.contiguous()
    with FakeTensorMode() as mode:
        fy, fb = mode.from_tensor(y), mode.from_tensor(bias)
        fr = None if res is None else mode.from_tensor(res)
        out = torch.ops.tecogan_torch.conv_epilogue(fy, fb, fr, 1, 0.0)
    want = ep.conv_epilogue_reference(y, bias, res, ep.ACT_RELU)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.stride() == want.stride()


def test_operator_fake_refuses_plain_meta_tensors():
    y, bias, _ = _operands(16, None)
    with pytest.raises((ValueError, RuntimeError), match="conv_epilogue"):
        torch.ops.tecogan_torch.conv_epilogue(y.to("meta"), bias.to("meta"),
                                              None, 0, 0.0)


def _bad(case):
    y, bias, res = _operands(16, "nhwc")
    return {
        "fp32 y": (y.float(), bias, res, 0),
        "fp16 bias": (y, bias.half(), res, 0),
        "fp32 residual": (y, bias, res.float(), 0),
        "bias shape": (y, bias[:8], res, 0),
        "residual shape": (y, bias, res[:1], 0),
        "residual layout": (y, bias, res.transpose(2, 3).contiguous(
        ).transpose(2, 3), 0),
        "3-D y": (y[0], bias, None, 0),
        "activation": (y, bias, res, 3),
    }[case]


@pytest.mark.parametrize("case", [
    "fp32 y", "fp16 bias", "fp32 residual", "bias shape",
    "residual shape", "residual layout", "3-D y", "activation"])
def test_wrapper_refuses_a_wrong_dtype_layout_or_shape(case):
    y, bias, res, act = _bad(case)
    with pytest.raises((TypeError, ValueError), match="conv_epilogue"):
        ep.conv_epilogue(y, bias, res, act)


@pytest.mark.parametrize("form", ["vector", "nchw residual", "flow head",
                                  "nchw y"])
def test_wrapper_packs_what_the_c_launcher_reads(monkeypatch, form):
    """The CUDA implementation hands ``tecogan_conv_epilogue_bf16`` the
    stream where the entry point reads it, y's, the residual's and the
    output's element strides at every ``strides_from(a + k)``, the vector
    flag for dense channels_last operands of 8 k channels, and counts the
    launch. It runs on CPU tensors with the device check and the launch
    stubbed out."""
    calls = []
    monkeypatch.setattr(ep, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    monkeypatch.setattr(ep, "cuda_index", lambda name, *t: 0)
    c, residual, act = {"vector": (64, "nhwc", ACTS["relu"]),
                        "nchw residual": (3, "nchw", None),
                        "flow head": (2, None, ACTS["leaky0.2"]),
                        "nchw y": (64, None, ACTS["relu"])}[form]
    y, bias, res = _operands(c, residual)
    if form == "nchw y":
        y = y.contiguous()
    before = ops.kernel_launches()["Epilogue"]
    out = ep._conv_epilogue_cuda(y, bias, res, *_code(act))
    assert ops.kernel_launches()["Epilogue"] == before + 1
    ((name, args),) = calls
    assert name == "tecogan_conv_epilogue_bf16"
    text = (kernel_build.CSRC_DIR / "conv_epilogue.cu").read_text()
    (stream,) = re.findall(r"arg_ptr<CUstream_st>\(a, (\d+)\)", text)
    assert len(args) == int(stream)
    offsets = [int(k) for k in re.findall(r"strides_from\(a \+ (\d+)\)",
                                          text)]
    zeros = (0, 0, 0, 0)
    assert [tuple(args[k:k + 4]) for k in offsets] == [
        y.stride(), zeros if res is None else res.stride(), out.stride()]
    assert args[4:8] == tuple(y.shape)
    assert args[8:12] == (_code(act)[0],
                          int(np.float32(_code(act)[1]).view(np.uint32)),
                          int(res is not None), int(form == "vector"))
    assert args[2] == (0 if res is None else res.data_ptr())


class _Stand:
    """What ``fused_epilogue`` reads of a convolution's weight, for a CUDA
    one."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, channels_last=True):
        self.is_cuda, self.dtype, self.cl = cuda, dtype, channels_last

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self.cl == (memory_format == CL)


@pytest.mark.parametrize("case", [
    "inference_mode", "no_grad", "grad", "fp32", "cpu", "nchw"])
def test_route_fuses_only_bf16_channels_last_cuda_without_autograd(case):
    weight = {"fp32": _Stand(dtype=torch.float32),
              "cpu": _Stand(cuda=False),
              "nchw": _Stand(channels_last=False)}.get(case, _Stand())
    mode = {"inference_mode": torch.inference_mode,
            "grad": torch.enable_grad}.get(case, torch.no_grad)
    with mode():
        assert tnn.fused_epilogue(weight) == (case in ("inference_mode",
                                                        "no_grad"))


@pytest.mark.parametrize("act", [nn.Tanh(), nn.GELU(), nn.PReLU()])
@pytest.mark.parametrize("fused", [False, True])
def test_conv_act_refuses_another_activation(monkeypatch, act, fused):
    """Only ReLU and LeakyReLU have a code in the epilogue: any other
    activation raises on both routes, so a CPU test catches what the card
    would otherwise run as a ReLU."""
    monkeypatch.setattr(tnn, "fused_epilogue", lambda w: fused)
    conv = nn.Conv2d(8, 8, 3, padding=1).to(torch.bfloat16,
                                             memory_format=CL)
    x = torch.rand(1, 8, 4, 5).to(torch.bfloat16, memory_format=CL)
    with torch.inference_mode(), pytest.raises(TypeError,
                                               match=type(act).__name__):
        tnn.conv_act(conv, x, act)


# ---------------------------------------------------------------- networks

def _fnet(dtype):
    torch.manual_seed(1)
    net = fnet.FNet().to(dtype)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(2, 3, 16, 24, generator=gen, dtype=dtype)
    y = torch.rand(2, 3, 16, 24, generator=gen, dtype=dtype)
    return net, lambda: net(x, y)


def _srnet(dtype):
    torch.manual_seed(3)
    net = srnet.SRNet(nf=16, nb=2).to(dtype)
    gen = torch.Generator().manual_seed(4)
    lr = torch.rand(2, 3, 6, 8, generator=gen, dtype=dtype)
    hr = torch.rand(2, 3, 24, 32, generator=gen, dtype=dtype)
    return net, lambda: net(lr, hr)


def _basicvsrpp(dtype):
    cfg = basicvsrpp.BasicVSRPPConfig(mid_channels=16, num_blocks=1,
                                      deform_groups=4)
    net = basicvsrpp.BasicVSRPP.random(
        cfg, torch.Generator().manual_seed(5)).to(dtype)
    lr = torch.rand(1, 3, 12, 16, 3, generator=torch.Generator().manual_seed(6))
    return net, lambda: net.forward_clips(lr, chunk=2)


NETS = {"fnet": _fnet, "srnet": _srnet, "basicvsrpp": _basicvsrpp}


class _Ops(TorchDispatchMode):
    """The aten (and port) operators a forward issues, in order."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.seen.append((str(func), func, args))
        return func(*args, **kwargs)


def _record(run):
    with _Ops() as rec:
        out = run()
    return out, rec.seen


_CONVS = ("aten.conv2d.default", "aten.conv_transpose2d.input",
          "aten.convolution.default")


def _conv_calls(seen):
    """The arguments of each convolution (the bias third), at whichever
    level the mode sees it."""
    return [args for name, _, args in seen if name in _CONVS]


def _module_route(monkeypatch):
    """``conv_act`` and ``run_fused`` as the plain module calls:
    ``residual + act(conv(x))`` and ``seq(x)``."""
    def conv_act(conv, x, act=None, residual=None):
        y = conv(x) if act is None else act(conv(x))
        return y if residual is None else residual + y

    for mod in (tnn, srnet, fnet, basicvsrpp):
        if hasattr(mod, "conv_act"):
            monkeypatch.setattr(mod, "conv_act", conv_act)
        if hasattr(mod, "run_fused"):
            monkeypatch.setattr(mod, "run_fused", lambda seq, x: seq(x))


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("mode", ["fp32", "bf16 with autograd"])
def test_unfused_route_issues_the_modules_own_ops(monkeypatch, net, mode):
    """An fp32 forward (inference mode) and a bf16 forward that records a
    graph issue exactly the ops of the modules called as they are: no
    epilogue, every convolution with its bias."""
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    grad = torch.inference_mode if mode == "fp32" else torch.enable_grad
    model, run = NETS[net](dtype)
    with grad():
        run()  # SPyNet makes its normalisation once per device
        out, seen = _record(run)
    with monkeypatch.context() as m:
        _module_route(m)
        with grad():
            want, plain = _record(run)
    assert [s[0] for s in seen] == [s[0] for s in plain]
    assert not any("conv_epilogue" in s[0] for s in seen)
    convs = _conv_calls(seen)
    assert convs and all(args[2] is not None for args in convs)
    assert torch.equal(out, want)


def _card_convs(monkeypatch):
    """``nn.Conv2d`` and ``nn.ConvTranspose2d`` as PyTorch runs them on the
    card: the convolution without its bias, then the broadcast bias add."""
    def conv(self, x):
        y = self._conv_forward(x, self.weight, None)
        return y.add_(self.bias.view(1, -1, 1, 1))

    def conv_t(self, x, output_size=None):
        y = F.conv_transpose2d(x, self.weight, None, self.stride,
                               self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y.add_(self.bias.view(1, -1, 1, 1))

    monkeypatch.setattr(nn.Conv2d, "forward", conv)
    monkeypatch.setattr(nn.ConvTranspose2d, "forward", conv_t)


def _fused_on_the_cpu(weight):
    return (weight.dtype == torch.bfloat16 and not torch.is_grad_enabled()
            and weight.is_contiguous(memory_format=CL))


@pytest.mark.parametrize("net", list(NETS))
def test_fused_route_is_the_cards_unfused_chain_bit_for_bit(monkeypatch,
                                                           net):
    """bf16 inference with the route's device test passed on the CPU: one
    epilogue per convolution (every one has a bias), each convolution run
    without its bias, no separate activation, and the output bit-identical
    to the card's unfused chain (bias-free convolution, broadcast bias add,
    the activation, the residual)."""
    model, run = NETS[net](torch.bfloat16)
    with monkeypatch.context() as m:
        _card_convs(m)
        with torch.inference_mode():
            want, unfused = _record(run)
    with monkeypatch.context() as m:
        m.setattr(tnn, "fused_epilogue", _fused_on_the_cpu)
        with torch.inference_mode():
            got, fused = _record(run)
    names = [s[0] for s in fused]
    convs = _conv_calls(fused)
    assert len(convs) == len(_conv_calls(unfused)) > 0
    assert all(args[2] is None for args in convs)
    assert names.count("tecogan_torch.conv_epilogue.default") == len(convs)
    assert not {"aten.relu.default", "aten.leaky_relu.default"} & set(names)
    assert torch.equal(got, want)


def test_export_traces_through_the_epilogue(monkeypatch):
    """``serving.export_stream`` traces with autograd off, so where the
    route fuses (here the device test passed on the CPU) the exported
    program holds the operator, through its fake, and the loaded program
    gives the live route's frames bit for bit."""
    from tecogan_tpu_torch import serving
    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence_batch)

    cfg = FRNetConfig(nf=8, nb=2, scale=4, compute_dtype="bfloat16")
    sd = FRNet.random(cfg, torch.Generator().manual_seed(7)).state_dict()
    lr = torch.rand(1, 3, 16, 24, 3, generator=torch.Generator(
    ).manual_seed(8))
    monkeypatch.setattr(tnn, "fused_epilogue", _fused_on_the_cpu)
    blob = serving.export_stream(sd, cfg, 1, 3, 16, 24, chunk=2,
                                 platforms=["cpu"])
    before = ops.kernel_launches()["Epilogue"]
    got = serving.load_stream(blob)(sd, lr)
    want = infer_sequence_batch(sd, lr, cfg, chunk=2)
    assert torch.equal(got, want)
    assert ops.kernel_launches()["Epilogue"] == before  # the CPU: plain
    ep_prog = torch.export.load(io.BytesIO(blob))
    targets = [str(node.target) for node in ep_prog.graph.nodes]
    # per chunk FNet's 14 convolutions, per frame SRNet's 2 nb + 4
    assert targets.count("tecogan_torch.conv_epilogue.default") == (
        2 * 14 + 4 * (2 * 2 + 4))
