"""The reduction of a traced window by the program's spans
(``portbench/spans.py``), on synthetic profiler events, and its readers; a
traced window on the CPU holds the port's spans as profiler ranges."""

import itertools
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, spans
from portbench.tests.tiny import ROOT

_ids = itertools.count(1)


def ev(name, start, end, *, device=DeviceType.CPU, thread=1, annotation=False, link=0):
    return SimpleNamespace(name=name, id=next(_ids), thread=thread, device_type=device,
                           is_user_annotation=annotation, linked_correlation_id=link,
                           time_range=SimpleNamespace(start=start, end=end))


def rng(name, start, end, thread=1):
    return ev(name, start, end, thread=thread, annotation=True)


def kernel(op, start, end, name="k"):
    """A device operation launched by ``op``, with the runtime call that
    launched it (a CPU event of the device operation's id, linked to the
    same operation)."""
    d = ev(name, start, end, device=DeviceType.CUDA, link=op.id)
    launch = ev("cudaLaunchKernel", op.time_range.start, op.time_range.start + 1,
                thread=op.thread + 1000, link=op.id)
    launch.id = d.id
    return [launch, d]


def _window():
    """A window of two rounds' phases under a dispatch span, on thread 1,
    with a second thread's range overlapping it."""
    mark = rng(spans.MARK, 0, 1000)
    loop = rng("dispatch/local-update", 10, 900)
    upd = rng("fit/round/update", 20, 100)
    wire = rng("fit/round/wire", 120, 200)  # 100..120: between phases
    agg = rng("fit/round/aggregate", 200, 300)
    other = rng("serve/predict", 0, 1000, thread=2)
    mm = ev("aten::mm", 30, 40)
    add = ev("aten::add", 130, 140)
    sub = ev("aten::sub", 950, 960)  # after the loop, inside the mark alone
    other_op = ev("aten::mul", 150, 160, thread=2)
    events = [mark, loop, upd, wire, agg, other, mm, add, sub, other_op]
    events += kernel(mm, 40, 90, "gemv")  # 50 µs under update
    events += kernel(add, 150, 170, "add_kernel")  # 20 µs under wire
    events += kernel(sub, 960, 965)  # 5 µs unspanned
    events += kernel(other_op, 170, 180)  # 10 µs under the other thread's range
    # a kernel library launched from the aggregate range itself (ctypes)
    events.append(ev("topk_encode_kernel", 210, 240, device=DeviceType.CUDA, link=agg.id))
    # a device operation linked to nothing the trace holds
    events.append(ev("memset", 250, 251, device=DeviceType.CUDA, link=10**9))
    # the profiler's own device-side twin of a range: never an operation
    events.append(ev("fit/round/update", 40, 90, device=DeviceType.CUDA, annotation=True,
                     link=upd.id))
    return events


def test_nesting_threads_and_launches_from_a_range():
    out = spans.attribute(_window(), [])
    s = out["spans"]
    assert s["fit/round/update"]["device_s"] == pytest.approx(50e-6)
    assert s["fit/round/wire"]["device_s"] == pytest.approx(20e-6)
    assert s["fit/round/aggregate"]["device_s"] == pytest.approx(30e-6)
    assert s["serve/predict"]["device_s"] == pytest.approx(10e-6)
    assert s["dispatch/local-update"]["device_s"] == 0.0
    assert [s[n]["launches"] for n in ("fit/round/update", "fit/round/wire",
                                       "fit/round/aggregate", "serve/predict")] == [1, 1, 1, 1]
    # the mark is no program range; the unlinked memset and the kernel
    # launched under the mark alone are unspanned
    assert spans.MARK not in s
    assert out["unspanned_device_s"] == pytest.approx(6e-6)
    assert s["dispatch/local-update"]["host_s"] == pytest.approx(890e-6)
    assert all(v["count"] == 1 for v in s.values())


def test_launches_from_a_worker_thread_or_from_no_operation_go_by_time():
    """A backward launched from the autograd engine's device thread (a
    thread that opens no range) and a kernel launched from a range through
    ``ctypes`` with no operation linked (only its runtime call) go to the
    innermost range that holds their launch; an operation on a thread that
    opens ranges but holds none at its start stays unspanned."""
    events = _window()
    backward = ev("aten::mm", 50, 60, thread=3)  # inside update, on thread 1's clock
    events += [backward] + kernel(backward, 95, 99, "gemv_backward")
    lib = ev("nearest_tc_kernel", 230, 250, device=DeviceType.CUDA)
    call = ev("cudaLaunchKernel", 215, 216, thread=4242)
    call.id = lib.id
    events += [lib, call]
    s = spans.attribute(events, [])["spans"]
    assert s["fit/round/update"]["device_s"] == pytest.approx(54e-6)
    assert s["fit/round/aggregate"]["device_s"] == pytest.approx(50e-6)
    assert s["fit/round/aggregate"]["launches"] == 2
    out = spans.attribute(events, [])
    assert out["unspanned_device_s"] == pytest.approx(6e-6)
    assert [n for n, _ in out["unspanned_top"]] == ["k", "memset"]


def test_gaps_go_to_the_innermost_range_of_their_midpoint():
    gaps = [(100, 120),  # between two phases: the dispatch span
            (60, 62),  # inside update
            (905, 945),  # after the loop: only the other thread's range
            ]
    out = spans.attribute([e for e in _window() if e.name != "serve/predict"], gaps)
    s = out["spans"]
    assert s["dispatch/local-update"]["idle_s"] == pytest.approx(20e-6)
    assert s["fit/round/update"]["idle_s"] == pytest.approx(2e-6)
    assert out["unspanned_idle_s"] == pytest.approx(40e-6)
    out = spans.attribute(_window(), gaps)
    assert out["spans"]["serve/predict"]["idle_s"] == pytest.approx(40e-6)
    # a gap inside ranges of both threads goes to the latest started
    assert out["spans"]["dispatch/local-update"]["idle_s"] == pytest.approx(20e-6)


def test_an_unlinked_runtime_call_never_stands_for_an_operation():
    """A runtime call outside every operation keeps CUDA's correlation id,
    which may equal an operation's id: the device operation still goes to
    its own operation."""
    events = _window()
    mm = next(e for e in events if e.name == "aten::mm")
    sync = ev("cudaDeviceSynchronize", 980, 990, thread=7)
    sync.id = mm.id
    events.append(sync)
    out = spans.attribute(events, [])
    assert out["spans"]["fit/round/update"]["device_s"] == pytest.approx(50e-6)


def test_the_profilers_raw_events_on_its_own_clock():
    """``profiler_events`` reads the raw results: the ranges and operations
    of a CPU profile with the names, threads and times of
    ``prof.events()``, and a link field on every event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(spans.MARK), record_function("fit/round/update"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    raw = spans.profiler_events(prof)

    def keyed(evs):
        return sorted((e.name, e.thread, round(e.time_range.start, 3), e.is_user_annotation)
                      for e in evs if e.name in (spans.MARK, "fit/round/update", "aten::mm"))

    assert keyed(raw) == keyed(prof.events())
    assert len(keyed(raw)) == 3
    assert all(e.linked_correlation_id == 0 for e in raw)


def test_device_seconds_add_up_to_the_windows():
    events = _window()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.name != spans.MARK]
    total = sum((e.time_range.end - e.time_range.start) / 1e6 for e in device)
    out = spans.attribute(events, [])
    assert sum(v["device_s"] for v in out["spans"].values()) + out["unspanned_device_s"] \
        == pytest.approx(total)
    assert sum(v["launches"] for v in out["spans"].values()) == len(device) - 2


def test_the_innermost_sweep_sees_past_any_number_of_spans():
    """Per-round spans inside one long loop span: a point between phases
    thousands of spans after the loop opened still finds the loop."""
    ranges = [(0, 10**7)] + [(10 * i + 1, 10 * i + 5) for i in range(5000)]
    found = spans._innermost(ranges, [10 * 4000 + 7, 10 * 4000 + 2, 10**7 + 1])
    assert found == [0, 4001, None]


def test_gaps_of_a_window():
    events = [ev("k", 10, 20, device=DeviceType.CUDA), ev("k", 15, 30, device=DeviceType.CUDA),
              ev("k", 50, 60, device=DeviceType.CUDA),
              ev("x", 30, 50, device=DeviceType.CUDA, annotation=True)]
    assert spans.idle_gaps(events, 0, 100) == [(0, 10), (30, 50), (60, 100)]


def _record(program, units=4, device_ops=10, window_s=1e-3):
    return {"units": units, "device_ops": device_ops, "window_s": window_s,
            "program": program}


READERS = [n for names in spans.READERS.values() for n in names]


def _read(name, record):
    mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                              "test_span_metric_" + name.replace(".", "_"))
    return mod.read(record)


def test_the_readers():
    program = spans.attribute(_window(), [(100, 120), (905, 945)])
    rec = _record(program, units=2)
    assert _read("update_span_ms.fit", rec) == pytest.approx(50e-3 / 2)
    assert _read("wire_span_ms.fit", rec) == pytest.approx(20e-3 / 2)
    assert _read("aggregate_span_ms.fit", rec) == pytest.approx(30e-3 / 2)
    assert _read("round_idle_ms.fit", rec) == pytest.approx(20e-3 / 2)
    assert _read("between_fits_share.fit", rec) == pytest.approx(100 * (1 - 890e-6 / 1e-3))
    # no such span in the program: nothing to read
    assert _read("metric_span_ms.fit", rec) is None
    assert _read("estep_span_ms.kmeans", rec) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_the_spans_or_the_card(name):
    program = spans.attribute(_window(), [])
    assert _read(name, {"units": 4, "device_ops": 10, "window_s": 1.0}) is None
    assert _read(name, _record(program, device_ops=0)) is None
    assert _read(name, _record({"spans": {}, "unspanned_device_s": 0.0,
                                "unspanned_idle_s": 0.0})) is None


def test_a_traced_window_on_the_cpu_holds_the_ports_spans(tiny_root):
    """The window as ``spans.py`` runs it, on the CPU at a tiny size: each
    chunk's fit opens its round spans once a round, as profiler ranges, and
    a k-means chunk its EM spans; the readers of the device find nothing."""
    fit = spans.measure(tiny_root, "fit-epsilon-16sites-topk", 3, device="cpu")
    rounds = fit["record"]["units"]
    assert rounds == 5 * 3
    s = fit["record"]["program"]["spans"]
    for name in ("fit/round/update", "fit/round/wire", "fit/round/aggregate",
                 "fit/round/metric"):
        assert s[name]["count"] == rounds and s[name]["device_s"] == 0.0
    assert s["dispatch/local-update"]["count"] == 3 and s["portbench/chunk"]["count"] == 3
    assert set(fit["metrics"].values()) == {None}
    km = spans.measure(tiny_root, "kmeans-kdd99-16sites-k1000", 3, device="cpu")
    s = km["record"]["program"]["spans"]
    assert s["kmeans/estep"]["count"] == s["kmeans/mstep"]["count"] == km["record"]["units"]
    assert s["kmeans/assign"]["count"] == 2


def test_the_command_refuses_without_a_card():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, str(Path(spans.__file__)), "--workload",
                          "fit-epsilon-16sites-topk", "--seed", "1"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
