"""utils/profiling.py: the chrome-trace readers on synthetic traces (two
devices, busiest against sum, copies that overlap kernels, annotated
spans, missing files), the kernel-name buckets, and trace / annotate /
sync on the CPU (the spans themselves: test_torch_tracing.py)."""
import json
import time

import pytest
import torch

from ml_audio_restoration_torch.utils import (
    annotate, sync, trace, trace_device_times, trace_top_ops)
from ml_audio_restoration_torch.utils.profiling import bucket

K1 = "void (anonymous namespace)::lstm_recurrence_kernel<float, 64>(...)"
CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float> >(...)")


def _ev(cat, name, ts, dur, device=0, stream=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": device, "tid": stream, "args": {"device": device}}


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _two_devices(tmp_path):
    return _write(tmp_path / "trace_1.json", [
        # device 0: K1 3 ms, a conv 2 ms, an add 1 ms on stream 7; a copy on
        # stream 9 under the conv (overlap) and one alone (data movement)
        _ev("kernel", K1, 0, 3000), _ev("kernel", CONV, 3000, 2000),
        _ev("kernel", ADD, 5000, 1000),
        _ev("gpu_memcpy", "Memcpy HtoD", 3500, 500, stream=9),
        _ev("gpu_memset", "Memset", 7000, 250, stream=9),
        _ev("gpu_user_annotation", "restore", 0, 6000),
        _ev("gpu_user_annotation", "tiny", 0, 500),
        # device 1: one conv of 4 ms
        _ev("kernel", CONV, 0, 4000, device=1),
        # host events are not device time
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 99999, "pid": 123, "tid": 1}])


def test_busiest_device(tmp_path):
    _two_devices(tmp_path)
    got = trace_device_times(tmp_path)
    assert got["device_planes"] == 2
    assert got["total_device_ms"] == pytest.approx(6.25)
    assert got["recurrence"] == pytest.approx(3.0)
    assert got["convolution"] == pytest.approx(2.0)
    assert got["fusion(elementwise)"] == pytest.approx(1.0)
    assert got["data-movement"] == pytest.approx(0.25)
    assert got["async_copy_overlap_ms"] == pytest.approx(0.5)
    assert got["module_step_ms"] == [pytest.approx(6.0)]
    assert list(got)[4] == "recurrence"  # buckets in falling order


def test_sum_over_devices(tmp_path):
    _two_devices(tmp_path)
    got = trace_device_times(tmp_path, combine="sum")
    assert got["total_device_ms"] == pytest.approx(10.25)
    assert got["convolution"] == pytest.approx(6.0)
    with pytest.raises(ValueError, match="combine"):
        trace_device_times(tmp_path, combine="mean")


def test_newest_trace_is_read(tmp_path):
    _two_devices(tmp_path)
    time.sleep(0.01)
    _write(tmp_path / "sub" / "trace_2.json", [_ev("kernel", ADD, 0, 100)])
    assert trace_device_times(tmp_path)["total_device_ms"] == pytest.approx(
        0.1)


def test_top_ops_of_busiest_device(tmp_path):
    _two_devices(tmp_path)
    got = trace_top_ops(tmp_path, 2)
    assert got == [(K1, pytest.approx(3.0), 1), (CONV, pytest.approx(2.0), 1)]


def test_missing_trace_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        trace_device_times(tmp_path)
    with pytest.raises(RuntimeError, match="no trace"):
        trace_top_ops(tmp_path / "absent")


def test_trace_without_device_events(tmp_path):
    """A trace with no GPU event raises rather than read as 0 ms, and a
    JSON file that is not a trace_*.json is never read, however new."""
    _write(tmp_path / "trace_1.json", [])
    with pytest.raises(RuntimeError, match="no GPU events"):
        trace_device_times(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU events"):
        trace_top_ops(tmp_path)
    _two_devices(tmp_path)
    time.sleep(0.01)
    (tmp_path / "results.json").write_text(json.dumps({"ms": 1.0}))
    assert trace_device_times(tmp_path)["total_device_ms"] == pytest.approx(
        6.25)


@pytest.mark.parametrize("name,want", [
    (K1, "recurrence"),
    ("void (anonymous namespace)::lstm_train_bwd_kernel<64>(...)",
     "recurrence"),
    ("void (anonymous namespace)::dw_partial_kernel<64>(...)", "recurrence"),
    ("void (anonymous namespace)::sos_forward<float, 2>(...)", "recurrence"),
    ("void (anonymous namespace)::df2t_adjoint<float, 4>(...)",
     "recurrence"),
    (CONV, "convolution"),
    ("void cudnn::cnn::wgrad_alg1_engine<float, float, 128>(...)",
     "convolution"),
    ("void (anonymous namespace)::int8_conv_wgmma<128>(...)", "convolution"),
    (ADD, "fusion(elementwise)"),
    ("void at::native::reduce_kernel<512, 1>(...)", "fusion(elementwise)"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "data-movement"),
    ("void at::native::index_elementwise_kernel<128, 4>(...)",
     "data-movement"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", "matmul"),
    ("void at::native::elementwise_kernel<convert_float_to_half>",
     "fusion(elementwise)"),
    ("some_kernel", "other")])
def test_kernel_buckets(name, want):
    assert bucket(name) == want


def test_trace_annotate_sync_on_the_cpu(tmp_path):
    x = torch.ones(64)
    with trace(tmp_path / "p"):
        with annotate("step"):
            y = sync(x * 2)
    files = list((tmp_path / "p").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "step" in names
    assert torch.equal(y, x * 2)
    with pytest.raises(RuntimeError, match="no GPU events"):
        trace_device_times(tmp_path / "p")
