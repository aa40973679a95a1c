"""The FLOP count (``tools/flops_probe.py``), the roofline
(``tools/roofline.py``) and the profilers' reduction of device activities
(``tools/profiling.py``) on the CPU.

The count of a small ``cfg_low_level`` train step, and of its recurrent
variant (LSTM decoder, BiLSTM posterior), must equal a count made without
``FlopCounterMode``: forward hooks on every linear, convolution, attention,
recurrent and CLIP-projection module record their shapes, and each product
counts 2 M N K in the forward pass and, where the gradient reaches the
module, once more for the weight gradient and once for the input gradient
when the input needs one. The cuDNN recurrence's formula must equal the
unfused recurrence's count on the CPU for every kind, depth, direction and
gradient need. The roofline reads a hand-written Chrome trace, the
reduction hand-made activities.
"""
import itertools
import json
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn

from hulc2_torch.models.aux_nets import ProjVisLang
from hulc2_torch.models.layers import MultiHeadAttention, ReluRNN
from hulc2_torch.tools import flops_probe, profiling, roofline
from hulc2_torch.training import SyntheticRun

SMALL = ["model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
         "model.plan_recognition.fc_hidden_size=64", "model.visual_goal.hidden_size=64",
         "model.language_goal.hidden_size=64", "model.action_decoder.hidden_size=64",
         "datamodule.min_window_size=4", "datamodule.max_window_size=4"]
RECURRENT = ["model.action_decoder.rnn_model=lstm_decoder", "model/plan_recognition=bilstm",
             "model/distribution=continuous", "model/optimizer=adamw",
             "model/lr_scheduler=cosine_warmup"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ProductCount:
    """FLOPs of the products of ``model``'s modules, from their shapes."""

    def __init__(self, model: nn.Module):
        self.forward = self.backward = 0
        for m in model.modules():
            for kind, hook in ((nn.Linear, self._linear), (nn.Conv2d, self._conv),
                               (MultiHeadAttention, self._attention), (ReluRNN, self._relu_rnn),
                               (nn.LSTM, self._library_rnn), (nn.GRU, self._library_rnn),
                               (ProjVisLang, self._clip)):
                if isinstance(m, kind):
                    m.register_forward_hook(hook)
                    break

    def _count(self, out, fwd: int, bwd: int) -> None:
        """``fwd`` now; ``bwd`` when the gradient reaches ``out``."""
        self.forward += fwd
        out = out[0] if isinstance(out, tuple) else out
        if out.requires_grad:
            out.register_hook(lambda g: setattr(self, "backward", self.backward + bwd))

    def _linear(self, m, inp, out):
        x = inp[0]
        f = 2 * (x.numel() // m.in_features) * m.in_features * m.out_features
        self._count(out, f, f * (m.weight.requires_grad + x.requires_grad))

    def _conv(self, m, inp, out):
        b, c_out, oh, ow = out.shape
        kh, kw = m.kernel_size
        f = 2 * b * c_out * oh * ow * (m.in_channels // m.groups) * kh * kw
        self._count(out, f, f * (m.weight.requires_grad + inp[0].requires_grad))

    def _attention(self, m, inp, out):
        x = inp[0]
        b, s, e = x.shape
        proj = 2 * b * s * e * 3 * e
        scores = 2 * b * s * s * e  # q k^T, and the same for the weights times v
        self._count(out, proj + 2 * scores,
                    proj * (m.in_proj_weight.requires_grad + x.requires_grad) + 2 * 2 * scores)

    def _recurrence(self, out, x, h0, gates, hidden, layers, dirs, batch_first=True):
        b, t = (x.shape[0], x.shape[1]) if batch_first else (x.shape[1], x.shape[0])
        g = gates * hidden
        fwd = bwd = 0
        for layer, _ in itertools.product(range(layers), range(dirs)):
            i = x.shape[2] if layer == 0 else dirs * hidden
            proj, step = 2 * t * b * i * g, 2 * b * hidden * g
            fwd += proj + t * step
            bwd += proj + t * step  # the weight gradients
            bwd += proj if layer > 0 or x.requires_grad else 0
            bwd += (t - 1 + int(h0 is not None and h0.requires_grad)) * step
        self._count(out, fwd, bwd)

    def _relu_rnn(self, m, inp, out):
        h0 = inp[1] if len(inp) > 1 else None
        self._recurrence(out, inp[0], h0, 1, m.hidden_size, m.num_layers, 1)

    def _library_rnn(self, m, inp, out):
        hx = inp[1] if len(inp) > 1 else None
        h0 = hx[0] if isinstance(hx, tuple) else hx
        gates = 4 if isinstance(m, nn.LSTM) else 3
        self._recurrence(out, inp[0], h0, gates, m.hidden_size, m.num_layers,
                         2 if m.bidirectional else 1, m.batch_first)

    def _clip(self, m, inp, out):
        img, txt = out
        f = 2 * img.shape[0] * txt.shape[0] * img.shape[1]
        self._count(img, f, 2 * f)


@pytest.mark.parametrize("extra", [[], RECURRENT], ids=["rnn_decoder", "lstm_decoder"])
def test_flop_count_equals_the_products_of_the_step(extra):
    cfg = flops_probe.config_for("cfg_low_level", SMALL + extra, batch=2)
    run = SyntheticRun(cfg, "cpu")
    reference = ProductCount(run.model)
    out = flops_probe.count_step(run, flops_probe.host_batch(run))
    assert reference.forward > 0 and reference.backward > reference.forward
    assert out["flops"] == reference.forward + reference.backward
    assert out["flops"] == sum(out["flops_by_op"].values())
    assert ("aten.convolution" in out["flops_by_op"]
            and "aten.convolution_backward" in out["flops_by_op"])


@pytest.mark.parametrize("cls,layers,bidirectional", [(nn.LSTM, 2, True), (nn.LSTM, 1, False),
                                                      (nn.GRU, 2, False), (nn.GRU, 1, True),
                                                      (nn.RNN, 2, True)])
def test_cudnn_rnn_formula_equals_the_unfused_recurrence(cls, layers, bidirectional):
    """``RNN_FLOPS`` on ``aten._cudnn_rnn``'s arguments against
    ``FlopCounterMode`` on the CPU's unfused recurrence, for each need of an
    input and an initial-state gradient."""
    mode = {nn.LSTM: 2, nn.GRU: 3, nn.RNN: 0}[cls]
    kw = {"nonlinearity": "relu"} if cls is nn.RNN else {}
    m = cls(5, 7, layers, batch_first=True, bidirectional=bidirectional, **kw)
    d = 2 if bidirectional else 1
    for in_grad, hx_grad in itertools.product((False, True), repeat=2):
        x = torch.randn(3, 6, 5, requires_grad=in_grad)
        h0 = torch.randn(layers * d, 3, 7, requires_grad=hx_grad)
        hx = (h0, torch.randn(layers * d, 3, 7)) if cls is nn.LSTM else h0
        with flops_probe._unfused_cpu_rnn(), \
                torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
            m(x, hx)[0].sum().backward()
        args = dict(input=(3, 6, 5), weight=None, weight_stride0=0, weight_buf=None, hx=None,
                    cx=None, mode=mode, hidden_size=7, proj_size=0, num_layers=layers,
                    batch_first=True, dropout=0.0, train=True, bidirectional=bidirectional,
                    batch_sizes=[], dropout_state=None)
        formula = (flops_probe.cudnn_rnn_flop(**args) + flops_probe.cudnn_rnn_backward_flop(
            **args, output=None, grad_output=None, grad_hy=None, grad_cy=None, reserve=None,
            output_mask=[in_grad, hx_grad, False, True]))
        assert formula == counter.get_total_flops(), (in_grad, hx_grad)


def test_uncounted_product_raises_naming_the_op(monkeypatch):
    """With oneDNN's fused LSTM left on, the count refuses and names it."""
    import contextlib

    if not torch.backends.mkldnn.is_available():
        pytest.skip("this torch has no oneDNN")
    monkeypatch.setattr(flops_probe, "_unfused_cpu_rnn", contextlib.nullcontext)
    cfg = flops_probe.config_for("cfg_low_level", SMALL + RECURRENT, batch=2)
    run = SyntheticRun(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="mkldnn_rnn_layer"):
        flops_probe.count_step(run, flops_probe.host_batch(run))


def test_probe_cli_on_the_cpu(capsys):
    out = flops_probe.main(["--device", "cpu", "--batch", "2", *SMALL])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert (out["config"], out["batch"], out["window"], out["device"]) == ("cfg_low_level", 2, 4,
                                                                          "cpu")
    assert out["compute_dtype"] == "float32" and out["flops"] > 0 and "not_counted" in out
    with pytest.raises(ValueError, match="CUDA"):
        flops_probe.main(["--device", "cpu", "--batch", "2", "--measure", *SMALL])


def test_peak_table_needs_a_known_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert flops_probe.peak_tflops(torch.device("cuda"), "bfloat16") == 989.0
    assert flops_probe.peak_tflops(torch.device("cuda"), "float32") == 67.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Card")
    with pytest.raises(ValueError, match="--peak-tflops"):
        flops_probe.peak_tflops(torch.device("cuda"), "bfloat16")
    assert flops_probe.peak_tflops(torch.device("cuda"), "bfloat16", 100.0) == 100.0


# ------------------------------------------------------------------ roofline
def _launch(events, corr, ts, op=None, op_args=None, cat="cpu_op", tid=1):
    """A host span (when ``op``) around a runtime launch with ``corr``."""
    if op:
        events.append({"ph": "X", "cat": cat, "name": op, "pid": 1, "tid": tid, "ts": ts,
                       "dur": 50, "args": op_args or {}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                   "tid": tid, "ts": ts + 10, "dur": 5, "args": {"correlation": corr}})


def _kernel(events, corr, name, ts, dur, cat="kernel", **args):
    events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
                   "args": {"correlation": corr, **args}})


ADD = {"Input Dims": [[1024, 256], [1024, 256], []],
       "Input type": ["c10::BFloat16", "c10::BFloat16", "Scalar"],
       "Input Strides": [[256, 1], [256, 1], []], "Concrete Inputs": ["", "", "1"]}


def write_trace(path, name="NVIDIA H100 80GB HBM3"):
    """Two steps: an add (two launches a step), the shift kernel under its
    span, a GEMM under aten::mm, a kernel launched outside any op, a copy."""
    ev = []
    corr = itertools.count(1)
    for step in range(2):
        t0 = 10_000 * step
        for k in range(2):
            c = next(corr)
            _launch(ev, c, t0 + 100 * k, "aten::add", ADD)
            _kernel(ev, c, "vectorized_elementwise_kernel<add>", t0 + 5000 + 10 * k, 2.0)
        c = next(corr)
        _launch(ev, c, t0 + 300, "shift_normalize n=2048 h=200 w=200 out=bfloat16",
                cat="user_annotation")
        _kernel(ev, c, "shift_normalize_kernel", t0 + 5100, 300.0)
        c = next(corr)
        _launch(ev, c, t0 + 400, "aten::mm", {"Input Dims": [[64, 64], [64, 64]],
                                              "Input type": ["float", "float"]})
        _kernel(ev, c, "sm90_xmma_gemm_f32f32", t0 + 5500, 400.0)
        c = next(corr)
        _launch(ev, c, t0 + 600)
        _kernel(ev, c, "mystery_kernel", t0 + 6000, 1.0)
        c = next(corr)
        _launch(ev, c, t0 + 700, "aten::copy_", {})
        _kernel(ev, c, "Memcpy HtoD (Pinned -> Device)", t0 + 6100, 10.0, cat="gpu_memcpy",
                bytes=4_000_000)
    path.write_text(json.dumps({"deviceProperties": [{"name": name}], "traceEvents": ev}))
    return path


def test_roofline_rows_from_a_trace(tmp_path):
    r = roofline.roofline(write_trace(tmp_path / "t.json"), steps=2)
    assert r["hbm_gbps"] == 3350.0 and r["device"] == "NVIDIA H100 80GB HBM3"
    rows = {row["kernel"]: row for row in r["rows"]}
    assert "sm90_xmma_gemm_f32f32" not in rows  # products are left out
    assert r["device_ms_per_step"] == pytest.approx((4 + 300 + 400 + 1 + 10) / 1e3)
    assert r["non_product_pct"] == pytest.approx(100 * 315 / 715)
    add = rows["vectorized_elementwise_kernel<add>"]
    assert (add["op"], add["execs_per_step"], add["bytes_exact"]) == ("aten::add", 2.0, True)
    assert add["bytes_per_step"] == 2 * 3 * 1024 * 256 * 2  # two reads and a write, bf16
    assert add["ms_per_step"] == pytest.approx(0.004)
    assert add["achieved_gb_s"] == pytest.approx(add["bytes_per_step"] / 4e-6 / 1e9)
    assert add["roofline_pct"] == pytest.approx(100 * add["achieved_gb_s"] / 3350.0)
    shift = rows["shift_normalize_kernel"]
    assert shift["bytes_per_step"] == 2048 * 200 * 200 * 3 * 3 + 2048 * 8 and shift["bytes_exact"]
    assert shift["execs_per_step"] == 1.0 and shift["family"] == "shift_normalize"
    mystery = rows["mystery_kernel"]
    assert (mystery["op"], mystery["bytes_per_step"], mystery["bytes_exact"]) == ("", None, False)
    assert mystery["achieved_gb_s"] is None and mystery["roofline_pct"] is None
    assert "?" in roofline.format_row(mystery) and "~" not in roofline.format_row(mystery)
    copy = rows["Memcpy HtoD (Pinned -> Device)"]
    assert copy["bytes_per_step"] == 4_000_000 and copy["bytes_exact"]
    assert [row["kernel"] for row in roofline.roofline(tmp_path / "t.json", 2, top=1)["rows"]] == \
        ["shift_normalize_kernel"]


def test_roofline_memory_rate_by_card(tmp_path, capsys):
    write_trace(tmp_path / "t.json", name="Some Card")
    with pytest.raises(ValueError, match="--hbm-gbps"):
        roofline.roofline(tmp_path / "t.json", 2)
    r = roofline.main([str(tmp_path / "t.json"), "--steps", "2", "--hbm-gbps", "1000"])
    assert r["hbm_gbps"] == 1000.0 and "shift_normalize_kernel" in capsys.readouterr().out


@pytest.mark.parametrize("name,args,want", [
    ("aten::copy_", {"Input Dims": [[8, 4], [8, 4], []], "Input type": ["c10::BFloat16", "float",
                                                                          "Scalar"],
                     "Concrete Inputs": ["", "", "False"]}, (8 * 4 * 4 + 8 * 4 * 2, True)),
    ("aten::sum", {"Input Dims": [[64, 16], [], [], []],
                   "Input type": ["float", "ScalarList", "Scalar", ""],
                   "Concrete Inputs": ["", "[1]", "False", ""]}, (64 * 16 * 4 + 64 * 4, True)),
    ("aten::cat", {"Input Dims": [[[4, 2], [4, 2]], []], "Input type": ["TensorList", "Scalar"],
                   "Concrete Inputs": ["", "0"]}, (2 * 4 * 2 * 4 + 4 * 2 * 4, False)),
    # the profiler records no shapes for a long tensor list
    ("aten::_foreach_addcdiv_", {"Input Dims": [[], [], [], []],
                                 "Input type": ["TensorList", "TensorList", "TensorList", "Scalar"]},
     (None, False)),
])
def test_op_bytes(name, args, want):
    assert roofline.op_bytes(name, args) == want


# ------------------------------------------------------------------ profiling
def _activity(name, start, end):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start))


@pytest.mark.parametrize("activities,busy_us,family_us", [
    # disjoint
    ([("void at::native::vectorized_elementwise_kernel<4>", 0, 10),
      ("sm90_xmma_gemm_bf16bf16_bf16f32", 20, 30)], 20,
     {"elementwise": 10, "gemm (cuBLAS)": 10}),
    # overlapping; a cuDNN implicit GEMM is a convolution (first match wins)
    ([("shift_normalize_kernel", 0, 10), ("cutlass_implicit_gemm_conv_fprop", 5, 15),
      ("cudnn::winograd_dgrad", 12, 14)], 15,
     {"shift_normalize": 10, "conv (cuDNN)": 12}),
    # nested
    ([("multi_tensor_apply_kernel<FusedAdam>", 0, 30), ("reduce_kernel<512>", 10, 20),
      ("layer_norm_kernel", 12, 14)], 30,
     {"optimizer": 30, "reduction": 12}),
    # touching, listed out of order; an unknown name is "other"
    ([("softmax_warp_forward", 10, 20), ("Memcpy DtoD (Device -> Device)", 0, 10),
      ("mystery", 25, 27), ("index_select_kernel", 20, 25)], 27,
     {"softmax": 10, "index / copy": 15, "other": 2}),
])
def test_profiling_busy_time_and_families(activities, busy_us, family_us):
    """The union of the activities' intervals; their device time by kernel
    family, per call of two, largest first; executions and names kept."""
    events = [_activity(*a) for a in activities]
    assert profiling.union_us([(e.time_range.start, e.time_range.end) for e in events]) == busy_us
    b = profiling.breakdown(events, 2)
    assert b.family_ms == pytest.approx({f: us / 1e3 / 2 for f, us in family_us.items()})
    assert list(b.family_ms) == sorted(family_us, key=lambda f: -family_us[f])
    assert sum(b.family_execs.values()) == len(activities) / 2
    assert {n: sum(t) for n, t in b.by_name.items()} == {n: e - a for n, a, e in activities}
    rows = profiling.family_rows(b, busy_us / 1e3 / 2)
    assert [r.split()[0] for r in rows] == [f.split()[0] for f in b.family_ms]
    top = profiling.top_rows(b, 2, 1)
    assert len(top) == 1 and max(activities, key=lambda a: a[2] - a[1])[0][:100] in top[0]
