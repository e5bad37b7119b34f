"""The port's ``utils.profiling`` on the CPU: the synchronized timers, a
CPU trace written and read back, ``top_ops``'s sums, counts, shares and
line format (the JAX package's ``tools/profile_refinement.py:43-47``) on a
hand-written Chrome trace, the device lane's busy share, and the CUDA
profile refusing to run without a GPU."""
import json

import pytest
import torch

from latentfusion_tpu_torch.utils import profiling


@pytest.fixture
def synced(monkeypatch):
    """The devices ``profiling`` waits for, in order."""
    calls = []
    monkeypatch.setattr(profiling, "synchronize", calls.append)
    return calls


def test_measure_time_sets_elapsed_and_syncs_value(synced):
    with profiling.measure_time("block") as holder:
        holder["value"] = {"a": torch.zeros(2), "b": [torch.ones(1)]}
    assert holder["elapsed"] >= 0.0
    assert synced == [torch.device("cpu")]
    with profiling.measure_time("block", sync_value=(torch.zeros(1),)) as holder:
        pass
    assert "elapsed" in holder and len(synced) == 2
    with profiling.measure_time("block") as holder:
        pass
    assert "elapsed" in holder and len(synced) == 2


def test_timeit_runs_warmup_then_reps(synced):
    calls = []

    def fn(x, y):
        calls.append((x, y))
        return torch.full((1,), float(len(calls)))

    seconds = profiling.timeit(fn, 1, 2, reps=4, warmup=2)
    assert seconds >= 0.0
    assert calls == [(1, 2)] * 6
    assert synced == [torch.device("cpu")] * 6


def test_profile_cpu_trace_reads_back(tmp_path, capsys):
    a = torch.randn(64, 64)
    with profiling.profile(tmp_path / "trace", device="cpu") as prof:
        for _ in range(3):
            a @ a
    (written,) = (tmp_path / "trace").glob(profiling.TRACE_GLOB)
    assert profiling.newest_trace(tmp_path) == written
    from_file = profiling.top_ops(tmp_path, k=5, device="cpu")
    out = capsys.readouterr().out
    assert "== plane: /host:cpu (total " in out and "aten::mm" in out
    live, live_counts = profiling.op_totals(prof, "cpu")
    file_counts = profiling.op_totals(written, "cpu")[1]
    assert live_counts["aten::mm"] == file_counts["aten::mm"] == 3
    assert from_file["aten::mm"] == pytest.approx(live["aten::mm"], rel=1e-3, abs=1e-3)
    # No device activity on the CPU: the lane is empty, the device idle.
    assert profiling.op_totals(prof, "cuda") == ({}, {})
    assert profiling.device_busy(prof)["busy_share"] == 0.0


def _trace(path):
    """Host ops nested on two threads, kernels on two streams, a copy,
    and the events a reader must skip (the profiler's own span, a range
    mirrored on the device, a flow and a metadata record)."""
    x = {"ph": "X"}
    events = [
        {**x, "cat": "user_annotation", "name": "PyTorch Profiler (0)", "pid": 1, "tid": 1,
         "ts": 0, "dur": 1000},
        {**x, "cat": "cpu_op", "name": "aten::conv", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {**x, "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 10, "dur": 40},
        {**x, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 20, "dur": 5},
        {**x, "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 2, "ts": 0, "dur": 20},
        {**x, "cat": "kernel", "name": "void k1<float>(float*)", "pid": 0, "tid": 7,
         "ts": 30, "dur": 250},
        {**x, "cat": "kernel", "name": "void k1<float>(float*)", "pid": 0, "tid": 7,
         "ts": 300, "dur": 250},
        {**x, "cat": "kernel", "name": "void k2(float*)", "pid": 0, "tid": 8,
         "ts": 400, "dur": 500},
        {**x, "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
         "ts": 950, "dur": 50},
        {**x, "cat": "gpu_user_annotation", "name": "range", "pid": 0, "tid": 9,
         "ts": 0, "dur": 1000},
        {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 1, "tid": 1, "ts": 20, "id": 1},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_top_ops_sums_a_hand_written_trace(tmp_path, capsys):
    trace = _trace(tmp_path / "trace-1.json")
    durations = profiling.top_ops(tmp_path, k=2, device="cuda")
    assert capsys.readouterr().out.splitlines() == [
        "",
        "== plane: /device:cuda (total 1.05 ms) ==",
        "    0.500 ms   47.6%  x2     void k1<float>(float*)",
        "    0.500 ms   47.6%  x1     void k2(float*)"]
    assert durations == pytest.approx({"void k1<float>(float*)": 0.5, "void k2(float*)": 0.5,
                                       "Memcpy HtoD": 0.05})
    # The host lane by self time: conv 100 - 40, mm (40 - 5) + 20, the launch 5.
    durations = profiling.top_ops(trace, k=5, device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        "",
        "== plane: /host:cpu (total 0.12 ms) ==",
        "    0.060 ms   50.0%  x1     aten::conv",
        "    0.055 ms   45.8%  x2     aten::mm",
        "    0.005 ms    4.2%  x1     cudaLaunchKernel"]
    assert durations == pytest.approx({"aten::conv": 0.06, "aten::mm": 0.055,
                                       "cudaLaunchKernel": 0.005})
    counts = profiling.op_totals(trace, "cuda")[1]
    assert counts == {"void k1<float>(float*)": 2, "void k2(float*)": 1, "Memcpy HtoD": 1}
    # Busy: 30-280 and 300-900 (the streams' overlap once) and 950-1000,
    # of the window 0-1000 (the profiler's span left out).
    busy = profiling.device_busy(trace)
    assert busy == pytest.approx({"busy_ms": 0.9, "window_ms": 1.0, "busy_share": 0.9,
                                  "idle_share": 0.1})


def test_top_ops_without_a_trace(tmp_path, capsys):
    assert profiling.newest_trace(tmp_path) is None
    assert profiling.top_ops(tmp_path, device="cpu") is None
    assert "no trace found" in capsys.readouterr().err


def test_profile_cuda_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.profile(tmp_path, device="cuda"):
            pass
    assert not list(tmp_path.iterdir())
