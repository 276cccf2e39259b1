"""The port's roofline probe (``tfk8s_tpu_torch.tools.roofline``) on the
CPU at its small shapes: every key of the one JSON line is there, and the
copy probe's plain path (``out.copy_(x)`` on CPU tensors) is exact. Its
numbers on the CPU time PyTorch's CPU kernels and are no device metric;
the card's come from ``chip_smoke.py``."""

import json

import numpy as np
import pytest
import torch

from tfk8s_tpu_torch.ops import block_copy as tbc
from tfk8s_tpu_torch.tools import roofline
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PROBES = ("matmul_tflops", "stream_bf16_gbps", "stream_f32_gbps", "copy_gbps",
          "resnet_fwd_ms", "resnet_gn_ablated_step_ms", "resnet_step_ms")


def test_run_all_small_on_cpu_returns_every_key(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA copy wrapper")

    monkeypatch.setattr(tbc, "block_copy_cuda", refuse)
    out = roofline.run_all(small=True, device="cpu")
    assert "degraded_probes" not in out, out
    for key in PROBES:
        assert np.isfinite(out[key]) and out[key] > 0, (key, out[key])
    assert out["platform"] == "cpu" and out["small"] is True
    assert out["copy_source"] == "tfk8s_tpu_torch/ops/csrc/block_copy.cu"
    json.dumps(out)  # one JSON line


@pytest.mark.parametrize("rows,cols", [(64, 96), (7, 5), (1, 1)])
def test_copy_plain_path_is_exact(rows, cols):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    tbc.reset_launches()
    out = tbc.block_copy(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    into = torch.empty_like(x)
    assert tbc.block_copy(x, into) is into and torch.equal(into, x)
    assert tbc.LAUNCHES == {"block_copy": 0}


def test_copy_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        tbc.block_copy(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="match"):
        tbc.block_copy(torch.zeros(4, 4), torch.zeros(4, 5))


def test_probe_failure_is_marked_not_invented(monkeypatch):
    monkeypatch.setattr(roofline, "matmul_tflops", lambda **kw: 1 / 0)
    for name in ("resnet_fwd_ms", "resnet_step_ms"):  # the ResNet probes are not under test
        monkeypatch.setattr(roofline, name, lambda *a, **kw: 1.0)
    out = roofline.run_all(small=True, device="cpu")
    assert out["degraded_probes"] == ["matmul_tflops"] and "matmul_tflops" not in out


def test_median_window_takes_the_middle_of_three(monkeypatch):
    clock = iter([0.0, 0.03, 1.0, 1.01, 2.0, 2.02])
    monkeypatch.setattr(roofline.time, "perf_counter", lambda: next(clock))
    med, times = roofline._median_window(lambda: None)
    assert times == pytest.approx([0.03, 0.01, 0.02]) and med == pytest.approx(0.02)


def test_the_probe_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TFK8S_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.run_all(small=True)
