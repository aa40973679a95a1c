"""The port's tracer (``hulc2_torch/core/trace.py``), its spans on the train
path and the per-phase reading of ``tools/profile_train``.

Torch only, so the card's machine, which has no JAX, runs the card's tests:
``python -m pytest --noconftest -m cuda tests/test_torch_port_trace.py``.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from _torch_port_dataset import write_calvin_dir
from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core import trace
from hulc2_torch.data.loader import DevicePrefetcher
from hulc2_torch.ops import preprocess
from hulc2_torch.tools import profile_train, roofline
from hulc2_torch.training import SyntheticRun

TINY = [  # test_torch_port_callbacks.TINY
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
]
SMALL_BATCH = ["datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
               "datamodule.min_window_size=4", "datamodule.max_window_size=4"]


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


# ---- the tracer ------------------------------------------------------------- #
def test_off_is_one_shared_context_that_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while tracing was off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(trace.torch.profiler, "record_function", no_clock)
    assert trace.span("a") is trace.span("b", step=3) is trace.OFF
    assert trace.device_counts("cpu", syncs="x") is trace.OFF
    with trace.span("a"), trace.span("b", step=1):
        trace.count("c", 5)
    assert trace.drain() == {"spans": [], "counters": {}}


def test_on_records_nesting_parents_and_counters():
    trace.enable()
    with trace.span("outer", step=7):
        with trace.span("first"):
            trace.count("hits")
        with trace.span("second"):
            with trace.span("inner"):
                trace.count("hits", 2)
    trace.count("other", 0)
    got = trace.drain()
    spans = {s.name: s for s in got["spans"]}
    assert [s.name for s in got["spans"]] == ["first", "inner", "second", "outer"]  # as they end
    assert spans["outer"].parent == 0 and spans["outer"].attrs == {"step": 7}
    assert spans["first"].parent == spans["second"].parent == spans["outer"].id
    assert spans["inner"].parent == spans["second"].id
    assert spans["outer"].start_ns <= spans["first"].start_ns <= spans["first"].end_ns \
        <= spans["second"].start_ns <= spans["inner"].end_ns <= spans["outer"].end_ns
    assert len({s.id for s in got["spans"]}) == 4
    assert got["counters"] == {"hits": 3, "other": 0}
    assert trace.drain() == {"spans": [], "counters": {}}  # drain cleared both


def test_each_thread_keeps_its_own_parents():
    trace.enable()
    entered, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("worker.outer"):
            entered.set()
            release.wait(10)
            with trace.span("worker.inner"):
                pass

    t = threading.Thread(target=worker)
    with trace.span("main.outer"):
        t.start()
        assert entered.wait(10)
        with trace.span("main.inner"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    spans = {s.name: s for s in trace.drain()["spans"]}
    assert spans["worker.outer"].parent == 0  # not the main thread's open span
    assert spans["worker.inner"].parent == spans["worker.outer"].id
    assert spans["main.inner"].parent == spans["main.outer"].id
    assert spans["worker.outer"].thread == spans["worker.inner"].thread \
        != spans["main.outer"].thread == threading.get_native_id()


def test_counters_add_up_across_threads():
    trace.enable()

    def add():
        for _ in range(2000):
            trace.count("n")

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert trace.drain()["counters"] == {"n": 16000}


def test_record_function_only_while_a_profiler_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("off.span", k=1):
            torch.ones(2) + 1
    assert not [e for e in prof.events() if e.name.startswith("off.span")]

    trace.enable()
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    with trace.span("unprofiled"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("on.span", k=1, j="x"):
            torch.ones(2) + 1
    assert entered == ["on.span k=1 j=x"]
    assert [e.name for e in prof.events() if e.name.startswith("on.span")] == ["on.span k=1 j=x"]
    assert [s.name for s in trace.drain()["spans"]] == ["unprofiled", "on.span"]


def test_the_kernel_span_keeps_the_name_roofline_reads():
    """``ops/preprocess`` has no tracing helper of its own: its launch span is
    a ``trace.span`` whose label ``tools/roofline.py`` parses."""
    assert not hasattr(preprocess, "_launch_span")
    name = trace.label(preprocess.SPAN, {"n": 2048, "h": 96, "w": 96, "out": "bfloat16"})
    assert name == "shift_normalize n=2048 h=96 w=96 out=bfloat16"
    assert roofline._SHIFT.match(name).groups() == ("2048", "96", "96", "bfloat16")


# ---- the train step --------------------------------------------------------- #
def _run(device="cpu") -> SyntheticRun:
    return SyntheticRun(flagship_config(TINY + SMALL_BATCH), device)


def test_train_step_spans_one_step_per_call_in_order():
    torch.set_num_threads(1)
    run = _run()
    trace.enable()
    for _ in range(2):
        run.step(run.next_batch())
    spans = trace.drain()["spans"]
    steps = _by_name(spans, "train.step")
    assert [s.attrs for s in steps] == [{"step": 1}, {"step": 2}]
    for step in steps:
        children = sorted((s for s in spans if s.parent == step.id), key=lambda s: s.start_ns)
        assert [s.name for s in children] == ["train.forward", "train.backward", "train.optimizer"]
        forward, _, optimizer = children
        inner = sorted((s for s in spans if s.parent == forward.id), key=lambda s: s.start_ns)
        assert [s.name for s in inner] == ["train.transform", "model.encode", "model.encode_lang",
                                           "model.plan", "model.decode", "model.aux"]
        assert [s.name for s in sorted((s for s in spans if s.parent == optimizer.id),
                                       key=lambda s: s.start_ns)] == ["train.grad_norm",
                                                                      "train.adam"]
        assert all(step.start_ns <= c.start_ns <= c.end_ns <= step.end_ns for c in children)


def test_train_step_is_bitwise_equal_with_tracing_on_and_off():
    torch.set_num_threads(1)
    runs = [_run(), _run()]
    runs[1].model.load_state_dict(runs[0].model.state_dict())
    metrics = []
    for traced, run in zip((False, True), runs):
        if traced:
            trace.enable()
        metrics.append([run.step(run.next_batch()) for _ in range(2)])
        trace.disable()
    assert len(_by_name(trace.drain()["spans"], "train.step")) == 2
    for a, b in zip(*metrics):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for (name, p), q in zip(runs[0].model.named_parameters(), runs[1].model.parameters()):
        assert torch.equal(p, q), name


# ---- the prefetcher and the trainer ---------------------------------------- #
def test_prefetcher_spans_on_both_threads_joined_by_batch():
    trace.enable()
    it = DevicePrefetcher(({"x": np.full(3, i)} for i in range(4)), "cpu")
    got = [int(b["x"][0]) for b in it]
    it.close(timeout=10)
    assert got == [0, 1, 2, 3] and not it.thread.is_alive()
    spans = trace.drain()["spans"]
    taken = _by_name(spans, "prefetch.next")
    made = _by_name(spans, "prefetch.produce")
    main = threading.get_native_id()
    assert {s.thread for s in taken} == {main} and {s.thread for s in made} - {main}
    assert [s.attrs["batch"] for s in taken] == list(range(5))  # the last one ends the stream
    for name in ("prefetch.queue_get", "prefetch.handoff"):
        assert all(s.thread == main for s in _by_name(spans, name))
    assert len(_by_name(spans, "prefetch.handoff")) == 4
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == "prefetch.next" for s in _by_name(spans, "prefetch.handoff"))
    for name in ("prefetch.to_device", "prefetch.put"):
        assert len(_by_name(spans, name)) == 4
        assert all(by_id[s.parent].name == "prefetch.produce" for s in _by_name(spans, name))
    joined = profile_train.handoffs(spans)
    # the stream's end is a fifth: the consumer's last wait for the producer's last next()
    assert joined["batches"] == 5 and joined["overlap"] == 0.0  # no train.step here
    assert 0.0 <= joined["next_overlap"] <= 1.0
    pairs = {(s.attrs["prefetcher"], s.attrs["batch"]) for s in made} & {
        (s.attrs["prefetcher"], s.attrs["batch"]) for s in taken}
    assert len(pairs) == 5 and all(p == it.id for p, _ in pairs)


def test_fit_traces_the_step_the_store_and_the_prefetcher(tmp_path):
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    root = write_calvin_dir(tmp_path / "data", static_hw=96, gripper_hw=64)
    cfg = flagship_config(TINY + [
        f"datamodule.root_data_dir={root}", "datamodule.batch_size_vis=2",
        "datamodule.batch_size_lang=2", "datamodule.min_window_size=4",
        "datamodule.max_window_size=4", "datamodule.num_workers=1",
        "trainer.log_every_n_steps=1", "trainer.limit_train_batches=2",
        "trainer.limit_val_batches=1"])
    dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device="cpu")
    dm.setup()
    trace.enable()
    Trainer(cfg, dm, tmp_path / "run", device="cpu").fit(1)
    spans = trace.drain()["spans"]
    assert len(_by_name(spans, "train.step")) == 2
    by_id = {s.id: s for s in spans}
    for name in ("store.plan_rows", "store.gather"):
        assert _by_name(spans, name)
        assert all(by_id[s.parent].name == "prefetch.produce" for s in _by_name(spans, name))


# ---- the per-phase reading -------------------------------------------------- #
def _span(id, name, parent, start_us, end_us, thread=1, **attrs):
    return trace.Span(id, name, thread, parent, int(start_us * 1e3), int(end_us * 1e3), attrs)


def _slice(spans, device, launches=(), steps=1, **extra):
    # the epoch clock puts the host's ns at the trace's us x 1e3
    return {"spans": spans, "device": device, "launches": list(launches), "steps": steps,
            "clock": (0, 0), "trace_start_ns": 0, "counters": {}, **extra}


def test_idle_gaps_and_launches_go_to_the_innermost_span_and_its_parents():
    spans = [_span(1, "train.step", 0, 0, 100), _span(2, "train.forward", 1, 0, 40),
             _span(3, "model.plan", 2, 10, 30), _span(4, "train.backward", 1, 40, 90),
             _span(5, "prefetch.produce", 0, 0, 100, thread=2)]
    device = [(0, 5), (8, 12), (20, 25), (45, 50), (95, 110), (130, 140)]
    # gaps: 5-8 forward, 12-20 plan, 25-45 plan (it opened at 25), 50-95 backward,
    # 110-130 outside every span
    launches = [1, 15, 50, 120, 60, 61]
    table = profile_train.phase_table(_slice(spans, device, launches))
    rows = table["rows"]
    assert table["idle_ms"] == pytest.approx(96 / 1e3)
    assert rows["model.plan"]["idle_ms"] == pytest.approx((8 + 20) / 1e3)
    assert rows["train.forward"]["idle_ms"] == pytest.approx((3 + 28) / 1e3)
    assert rows["train.backward"]["idle_ms"] == pytest.approx(45 / 1e3)
    assert rows["train.step"]["idle_ms"] == pytest.approx(76 / 1e3)
    assert rows[profile_train.NO_SPAN]["idle_ms"] == pytest.approx(20 / 1e3)
    # the worker's spans take no idle and no launch: they fall on the main thread's
    assert rows["prefetch.produce"]["thread"] == "worker"
    assert rows["prefetch.produce"]["idle_ms"] == rows["prefetch.produce"]["launches"] == 0
    assert rows["model.plan"]["launches"] == 1 and rows["train.forward"]["launches"] == 2
    assert rows["train.backward"]["launches"] == 3 and rows["train.step"]["launches"] == 5
    assert rows[profile_train.NO_SPAN]["launches"] == 1
    assert rows["train.step"]["host_ms"] == pytest.approx(0.1)
    assert rows["train.step"]["calls"] == 1


def test_an_innermost_span_inside_a_long_sibling_chain():
    spans = [_span(1, "a", 0, 0, 50), _span(2, "b", 0, 60, 70), _span(3, "c", 2, 61, 62)]
    times = {s.id: (s.start_ns / 1e3, s.end_ns / 1e3) for s in spans}
    inner = profile_train.Innermost(spans, times)
    assert inner.at(10).name == "a" and inner.at(61.5).name == "c" and inner.at(65).name == "b"
    assert inner.at(55) is None and inner.at(-1) is None and inner.at(80) is None


def test_anchor_arithmetic():
    """The host is placed on the trace's clock by the epoch clock:
    ``time.time_ns`` read with ``perf_counter_ns``, against the trace's start."""
    sl = _slice([], [], clock=(1_700_000_000_000_000_000, 5_000_000),
                trace_start_ns=1_700_000_000_000_000_000 + 1_000_000)
    # perf 5 ms is the epoch's wall, 1 ms before the trace starts
    assert profile_train.to_trace_us(5_000_000, sl) == pytest.approx(-1000.0)
    assert profile_train.to_trace_us(7_003_000, sl) == pytest.approx(1003.0)


def test_handoffs_join_producer_and_consumer():
    spans = [_span(1, "train.step", 0, 0, 10),
             _span(2, "prefetch.next", 0, 10, 12, batch=0, prefetcher=3),
             _span(3, "prefetch.produce", 0, 4, 8, thread=2, batch=0, prefetcher=3),
             _span(4, "prefetch.produce", 0, 11, 20, thread=2, batch=1, prefetcher=3),
             _span(5, "prefetch.put", 4, 11.5, 20, thread=2)]
    h = profile_train.handoffs(spans)
    assert h["batches"] == 1 and h["lead_ms"] == pytest.approx(2e-3) and h["overlap"] == 1.0
    # batch 1's producer worked 11-11.5 and then waited on the queue: a quarter of next's 10-12
    assert h["next_overlap"] == pytest.approx(0.25)


# ---- on the card ------------------------------------------------------------ #
@pytest.mark.cuda
def test_sync_counter_counts_the_step_threads_syncs(cuda_device):
    x = torch.ones(4, device=cuda_device)
    torch.cuda.empty_cache()  # so that the new segment below is a cudaMalloc
    mode = torch.cuda.get_sync_debug_mode()
    trace.enable()
    with trace.device_counts(cuda_device, syncs="syncs", mallocs="mallocs"):
        (x + 1).sum().item()
        float(x[0])
        y = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)  # a new 256 MiB segment
    with trace.device_counts(cuda_device, syncs="none"):
        x.mul_(2)
    assert torch.cuda.get_sync_debug_mode() == mode
    counters = trace.drain()["counters"]
    assert counters["syncs"] == 2 and counters["none"] == 0 and counters["mallocs"] >= 1
    del y


@pytest.mark.cuda
def test_traced_card_step_counts_and_phase_table(cuda_device):
    run = _run("cuda")
    run.step(run.next_batch())
    on = profile_train.traced_slice(run, 2)
    assert len(_by_name(on["spans"], "train.step")) == 2 and not trace._on
    assert {"train.host_syncs", "train.device_mallocs"} <= set(on["counters"])
    table = profile_train.phase_table(on)
    assert table["rows"]["train.step"]["calls"] == 1 and table["idle_ms"] > 0
    print(f"[trace] counters {on['counters']}, idle {table['idle_ms']:.3f} ms a step")
