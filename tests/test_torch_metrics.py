"""The port's test-mode metric stack against the JAX package's on the same
uint8 sequences: YCbCr, SSIM, the MetricCalculator (PSNR on Y and RGB,
SSIM, tOF) and its JSON file; the LPIPS and tOF gates."""

import json
import logging
import sys

import numpy as np
import pytest

from tecogan_tpu.metrics import MetricCalculator as JCalc
from tecogan_tpu.metrics import ssim as jssim
from tecogan_tpu.ops import rgb_to_ycbcr as jycbcr
from tecogan_tpu_torch.metrics import MetricCalculator as TCalc
from tecogan_tpu_torch.metrics import create_metric_calculator, ssim
from tecogan_tpu_torch.ops import float32_to_uint8, rgb_to_ycbcr

_RTOL = 1e-12


def _pair(rng, t=4, h=40, w=48):
    """GT and a noisy SR of it, (t, h, w, 3) uint8, drifting frames."""
    base = rng.random((h + t, w + t, 3))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    gt = np.stack([base[i:i + h, i:i + w] for i in range(t)]) * 255
    sr = gt + rng.normal(0, 6, gt.shape)
    return (np.clip(gt.round(), 0, 255).astype(np.uint8),
            np.clip(sr.round(), 0, 255).astype(np.uint8))


def test_ycbcr_and_uint8(rng):
    img = (rng.random((5, 7, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(rgb_to_ycbcr(img), jycbcr(img))
    from tecogan_tpu.ops import float32_to_uint8 as jf2u

    x = rng.random((4, 6, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(float32_to_uint8(x), jf2u(x))


@pytest.mark.parametrize("shape", [(40, 48), (7, 9), (23, 31)])
def test_ssim_matches_jax(rng, shape):
    a = rng.random(shape) * 255
    b = np.clip(a + rng.normal(0, 10, shape), 0, 255)
    assert ssim(a, b, 255.0) == pytest.approx(jssim(a, b, 255.0),
                                              rel=_RTOL)
    with pytest.raises(ValueError):
        ssim(a[:5], b[:5], 255.0)


@pytest.mark.parametrize("metric", [
    {"PSNR": {"colorspace": "y"}, "SSIM": None, "tOF": {"colorspace": "y"}},
    {"PSNR": {"colorspace": "rgb"}},
    {"tOF": None, "PSNR": None},
])
def test_calculator_matches_jax(rng, tmp_path, metric):
    opt = {"metric": metric}
    jc, tc = JCalc(opt), TCalc(opt)
    for seq in ("b_seq", "a_seq"):
        gt, sr = _pair(rng)
        jc.compute_sequence_metrics(seq, gt, sr)
        tc.compute_sequence_metrics(seq, gt, sr)
    # one sequence of one frame: its tOF series is empty (NaN, excluded)
    gt, sr = _pair(rng, t=1)
    jc.compute_sequence_metrics("c_one", gt, sr)
    tc.compute_sequence_metrics("c_one", gt, sr)
    assert tc.metric_dict.keys() == jc.metric_dict.keys()
    for seq, per_frame in jc.metric_dict.items():
        assert list(tc.metric_dict[seq]) == list(per_frame)
        for m, vals in per_frame.items():
            np.testing.assert_allclose(tc.metric_dict[seq][m], vals,
                                       rtol=_RTOL, atol=0)
    for c in (jc, tc):
        c.gather(list(c.metric_dict))
    got, want = tc.average(), jc.average()
    assert list(got) == list(want)
    for m in want:
        assert np.isfinite(got[m])
        assert got[m] == pytest.approx(want[m], rel=_RTOL)

    # the JSON file: the same layout, entries and iter<N> order
    for name, c in (("jax", jc), ("torch", tc)):
        for idx in ("G_iter10", "G_iter2", "TecoGAN_4x"):
            c.save(idx, str(tmp_path / name / "Vid4_avg.json"))
        c.save("G_iter2", str(tmp_path / name / "Vid4_avg.json"),
               override=True)
    texts = [(tmp_path / n / "Vid4_avg.json").read_text()
             for n in ("jax", "torch")]
    assert texts[0] == texts[1]
    assert list(json.loads(texts[1])) == ["G_iter2", "G_iter10",
                                          "TecoGAN_4x"]


def test_display_and_unknown_metric(rng, caplog):
    tc = create_metric_calculator({"metric": {"PSNR": None}})
    gt, sr = _pair(rng)
    tc.compute_sequence_metrics("s", gt, sr)
    tc.gather(["s", "missing"])
    with caplog.at_level(logging.INFO, logger="base"):
        tc.display()
    assert "Sequence: s" in caplog.text and "Average" in caplog.text
    assert create_metric_calculator({"metric": None}) is None
    with pytest.raises(ValueError, match="tLP100"):
        TCalc({"metric": {"PSNR": None, "tLP100": None}})


def _warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno == logging.WARNING]


def test_lpips_is_gated(rng, caplog):
    with caplog.at_level(logging.INFO, logger="base"):
        tc = TCalc({"metric": {"PSNR": None, "LPIPS": {"net": "alex"}},
                    "device_ids": []})
    warns = _warnings(caplog)
    assert len(warns) == 1 and "LPIPS disabled" in warns[0]
    assert "weights unavailable" in warns[0]
    gt, sr = _pair(rng)
    tc.compute_sequence_metrics("s", gt, sr)
    tc.gather(["s"])
    assert list(tc.average()) == ["PSNR"]


def test_tof_is_gated_without_cv2(rng, caplog, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with caplog.at_level(logging.INFO, logger="base"):
        tc = TCalc({"metric": {"PSNR": None, "SSIM": None, "tOF": None}})
    warns = _warnings(caplog)
    assert len(warns) == 1 and "tOF disabled" in warns[0]
    assert "cv2" in warns[0]
    gt, sr = _pair(rng)
    tc.compute_sequence_metrics("s", gt, sr)
    tc.gather(["s"])
    got = tc.average()
    assert list(got) == ["PSNR", "SSIM"]
    want = JCalc({"metric": {"PSNR": None, "SSIM": None}})
    want.compute_sequence_metrics("s", gt, sr)
    want.gather(["s"])
    for m, v in want.average().items():
        assert got[m] == pytest.approx(v, rel=_RTOL)
