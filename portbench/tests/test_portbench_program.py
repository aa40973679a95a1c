"""The readings the runner adds: ``frozen_update`` in ``compare``, the
program slice's reduction of spans and device activities
(``harness/program_trace``), and the five readers of it."""
import pytest

from portbench.harness import check, program_trace, spec
from portbench.runners.train import compare
from portbench.tests.tiny import ROOT

NEW_READERS = ["train_step.forward_device_ms", "train_step.backward_device_ms",
               "train_step.optimizer_device_ms", "model.encode_device_ms", "data.produce_ms"]


def _readings(change_c: float):
    """Hand-built readings: leaves ``a`` and ``b`` trained on both sides,
    ``c`` without a gradient in the reference, moved by ``change_c`` in the
    program."""
    ref = {"losses": [1.0, 0.9, 0.8], "grad": {"a": 1.0, "b": 2.0}, "trained": ["a", "b"],
           "update": {"a": 0.1, "b": 0.2}, "change": {"a": 0.01, "b": 0.02, "c": 0.0}}
    prog = {"losses": [1.0, 0.9, 0.8], "grad": {"a": 1.0, "b": 2.0},
            "update": {"a": 0.1, "b": 0.2}, "change": {"a": 0.01, "b": 0.02, "c": change_c},
            "metrics1": {}}
    return prog, ref


def test_a_frozen_leaf_that_moves_fails_a_limit_of_0():
    numbers, detail = compare(*_readings(3e-4))
    assert numbers["frozen_update"] == pytest.approx(3e-4)
    assert detail["frozen_leaf"] == "c" and detail["frozen_leaves"] == 1
    assert not check.verdict(numbers, {"frozen_update": 0})[0]
    numbers, _ = compare(*_readings(0.0))
    assert numbers["frozen_update"] == 0.0
    assert check.verdict(numbers, {"frozen_update": 0})[0]


def test_without_frozen_leaves_frozen_update_is_0():
    prog, ref = _readings(1.0)
    ref["trained"].append("c")
    ref["grad"]["c"] = 1.5
    prog["grad"]["c"], prog["update"]["c"], ref["update"]["c"] = 1.5, 0.3, 0.3
    numbers, detail = compare(prog, ref)
    assert numbers["frozen_update"] == 0.0 and detail["frozen_leaf"] is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_reader_without_the_program_slice_reads_none(name):
    rec = {"layers": {"steps": 2, "window_s": 0.2, "batch_wait_s": [0.001],
                      "profile": {"busy_s": 0.03, "window_s": 0.12, "steps": 2, "by_name": {}}}}
    assert spec.reader(name)(rec) is None
    rec["layers"]["program"] = {"replayed": {"steps": 2, "spans": {}, "counters": {}},
                                "eager": {"steps": 2, "spans": {}, "counters": {}}}
    assert spec.reader(name)(rec) is None


def test_readers_of_the_program_slice():
    eager = {name: {"calls": 1.0, "host_ms": 9.0, "device_ms": ms} for name, ms in
             [("train.forward", 4.0), ("train.backward", 8.0), ("train.optimizer", 2.5),
              ("model.encode", 1.5)]}
    replayed = {"prefetch.produce": {"calls": 1.0, "host_ms": 14.0},
                "prefetch.put": {"calls": 1.0, "host_ms": 3.0}}
    rec = {"layers": {"program": {"eager": {"spans": eager}, "replayed": {"spans": replayed}}}}
    read = {name: spec.reader(name)(rec) for name in NEW_READERS}
    assert read == {"train_step.forward_device_ms": 4.0, "train_step.backward_device_ms": 8.0,
                    "train_step.optimizer_device_ms": 2.5, "model.encode_device_ms": 1.5,
                    "data.produce_ms": 11.0}
    del replayed["prefetch.put"]  # a producer never blocked: all of it is work
    replayed["prefetch.produce"]["calls"] = 2.0
    assert spec.reader("data.produce_ms")(rec) == 7.0


def _span(id, name, parent, start, end, thread=1):
    from collections import namedtuple

    return namedtuple("Span", "id name thread parent start_ns end_ns attrs")(
        id, name, thread, parent, start, end, {})


def test_spans_are_kept_whole():
    spans = [
        _span(1, "store.gather", 0, 0, 10, thread=2),  # its batch began before the part
        _span(2, "store.gather", 3, 20, 30, thread=2),
        _span(3, "prefetch.produce", 0, 15, 40, thread=2),
        _span(4, "train.replay", 5, 12, 45),
        _span(5, "train.step", 0, 10, 50),
        _span(6, "store.gather", 7, 60, 70, thread=2),  # its batch ended after the part
        _span(7, "prefetch.produce", 0, 55, 80, thread=2),
    ]
    kept = program_trace.whole(spans, end_ns=50)
    assert [s.id for s in kept] == [2, 3, 4, 5]
    rows = program_trace.table(kept, steps=2)
    assert rows["prefetch.produce"] == {"calls": 0.5, "host_ms": pytest.approx(12.5e-6)}


def test_device_ms_is_the_union_of_what_a_span_launched():
    spans = [_span(1, "train.forward", 0, 0, 100_000), _span(2, "train.backward", 0, 100_000,
                                                              200_000),
             _span(3, "train.forward", 0, 300_000, 400_000)]  # ns on the host clock
    launches = {11: 10.0, 12: 50.0, 13: 150.0, 14: 350.0, 15: 250.0}  # us on the trace's clock
    device = [(11, 20.0, 60.0), (12, 40.0, 90.0), (13, 160.0, 400.0), (14, 500.0, 510.0),
              (15, 600.0, 700.0), (16, 0.0, 1000.0)]  # 16 has no launch record
    ms = program_trace.device_ms(spans, launches, device, steps=2, place=lambda t: t / 1e3)
    # forward: [20, 90] and [500, 510] = 80 us over 2 steps; backward: [160, 400]
    assert ms == {"train.forward": pytest.approx(0.04), "train.backward": pytest.approx(0.12)}


def test_to_trace_us():
    # perf clock 5,000 ns, read with the epoch clock at 1e9 + 2,000 ns; the
    # trace started at epoch 1e9: 7,000 ns later on its clock
    assert program_trace.to_trace_us(10_000, (1_000_002_000, 5_000), 1_000_000_000) == 7.0


def test_the_new_metrics_are_in_the_benchmark():
    bench = spec.load_benchmark(ROOT)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_READERS:
        assert per_layer[name]["workloads"] == ["flagship.train.store"]
        assert per_layer[name]["moves"] == "train_samples_per_s"
