"""The reduction of a chrome trace and the readers' arithmetic, on a small
synthetic trace."""
import pytest

from benchmark.harness import reading
from benchmark.harness import trace as tr


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 1, "args": args}


TRACE = {"traceEvents": [
    _ev("cpu_op", "aten::conv1d", 0, 100),
    _ev("cpu_op", "aten::pad", 42, 3),
    _ev("kernel", "sm80_xmma_fprop_implicit_gemm_f32", 10, 30, device=0),
    _ev("kernel", "lstm_recurrence_kernel<float, 64>", 50, 20, device=0),
    _ev("cuda_runtime", "cudaMemcpyAsync", 75, 20),
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 80, 10, device=0),
    _ev("kernel", "vectorized_elementwise_kernel add", 85, 5, device=0),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
]}


def test_buckets():
    assert tr.bucket("sm80_xmma_fprop_implicit_gemm_f32f32") == "convolution"
    assert tr.bucket("lstm_train_bwd_kernel<64>") == "recurrence"
    assert tr.bucket("dw_partial_kernel<64>") == "recurrence"
    assert tr.bucket("vectorized_elementwise_kernel<4, "
                     "CUDAFunctor_add>") == "fusion(elementwise)"
    assert tr.bucket("Memcpy HtoD") == "data-movement"
    assert tr.bucket("nhwcToNchwKernel") == "other"


def test_reduce_busy_idle_and_gaps():
    r = tr.reduce(TRACE)
    # busy: [10, 40] + [50, 70] + [80, 90] (the add overlaps the copy)
    assert r["busy_s"] == pytest.approx(60e-6)
    assert r["window_s"] == pytest.approx(90e-6)
    assert tr.idle_share(r) == pytest.approx(100 * 30 / 90)
    assert r["by_bucket_ms"] == pytest.approx({
        "convolution": 0.030, "recurrence": 0.020, "data-movement": 0.010,
        "fusion(elementwise)": 0.005})
    # gaps [0, 10], [40, 50], [70, 80], each named by the innermost host
    # op running at its start
    assert [name for name, _ in r["idle_gaps"]] == [
        "aten::conv1d", "aten::conv1d", "aten::conv1d"]
    assert [s for _, s in r["idle_gaps"]] == pytest.approx([10e-6] * 3)
    assert tr.kernel_ms(r, "lstm_recurrence_kernel") == pytest.approx(0.02)


def test_no_device_event_reads_nothing():
    cpu_only = {"traceEvents": [_ev("cpu_op", "aten::add", 0, 5)]}
    assert tr.reduce(cpu_only) is None
    rec = {"trace": None, "traced_units": [], "units": [], "window_s": 1.0,
           "dtype": "float32"}
    assert reading.roofline(rec, "k1_bound_ms", "lstm") is None
    assert reading.idle_share(rec) is None
    assert reading.mfu(rec) is None


def test_breakdown_lists():
    b = tr.breakdown(tr.reduce(TRACE), n=2)
    assert b["device_ops"][0] == ["sm80_xmma_fprop_implicit_gemm_f32",
                                  pytest.approx(30e-6)]
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2


def test_readers_arithmetic():
    r = tr.reduce(TRACE)
    units = [{"t": 0.5, "audio_s": 100.0, "flops": 6.7e12, "steps": 2}] * 4
    rec = {"trace": r, "units": units, "window_s": 2.0, "dtype": "float32",
           "traced_units": [{"k1_bound_ms": 0.005, "steps": 2},
                            {"k1_bound_ms": 0.005, "steps": 2}]}
    assert reading.audio_rate(rec) == pytest.approx(200.0)
    # 4 x 6.7 TFLOP in 2 s over 67 TFLOP/s
    assert reading.mfu(rec) == pytest.approx(20.0)
    assert reading.roofline(rec, "k1_bound_ms",
                            "lstm_recurrence") == pytest.approx(50.0)
    assert reading.device_ms_per_step(rec) == pytest.approx(0.06 / 4)
    assert reading.device_ms_per_step(rec, "convolution") == pytest.approx(
        0.03 / 4)
    rec["units"] = [{"t": t / 100} for t in range(1, 101)]
    assert reading.unit_p95_ms(rec) == pytest.approx(950.5)
