"""Memory roofline of the kernels of a profiled train step that are not
products (GEMMs, convolutions, attention, recurrences).

    python -m hulc2_torch.tools.profile_train --config-name cfg_low_level --steps 3 --trace T.json
    python -m hulc2_torch.tools.roofline T.json --steps 3 [--top 10] [--hbm-gbps 3350] [--json]

The counterpart of ``hulc2_tpu/tools/roofline.py``, over the Chrome trace
that ``profile_train --trace`` writes (``torch.profiler`` with
``record_shapes=True``). Each device activity is linked to the host op that
launched it: its ``correlation`` id names the runtime call (the launch), and
the innermost host span around that call on its thread is the op. Rows are
(kernel, op, input shapes); for each of the ``--top`` rows by device time
that are not products it gives the executions per step (counted in the
trace), the device ms per step, the bytes per step and the achieved GB/s as a
share of the card's memory rate (``--hbm-gbps``, by default from the trace's
device name: 3.35 TB/s for the H100 SXM, NVIDIA's data sheet).

Bytes: each input read once and each output written once. The inputs are
the recorded shapes and dtypes; the outputs come from running the op on
meta tensors of those shapes. Where that cannot be done, the output is taken
as the broadcast of the inputs in the first input's dtype and the row's
``bytes_exact`` is false, as the JAX tool marks its rows whose operands are
elided; where the trace holds no shapes (a long tensor list, a kernel
outside any op) the bytes are unknown (None). An op that only writes its
first argument (``copy_``, ``fill_``,
``zero_``) does not read it. The ``shift_normalize`` kernel, launched
through ctypes, has no aten op: its wrapper's profiler span carries the
launch's shape, and its bytes are ``bench_shift_normalize.launch_bytes``.
A copy or memset carries its own byte count.
"""
from __future__ import annotations

import argparse
import ast
import bisect
import gzip
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from hulc2_torch.ops.preprocess import SPAN as SHIFT_SPAN
from hulc2_torch.tools.bench_shift_normalize import launch_bytes
from hulc2_torch.tools.flops_probe import PRODUCT
from hulc2_torch.tools.profiling import family

# memory rate by device name, GB/s (NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s)
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

DTYPES = {
    "float": torch.float32, "double": torch.float64, "c10::Half": torch.float16,
    "c10::BFloat16": torch.bfloat16, "long int": torch.int64, "int": torch.int32,
    "short int": torch.int16, "signed char": torch.int8, "unsigned char": torch.uint8,
    "bool": torch.bool, "c10::complex<float>": torch.complex64,
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "bernoulli_", "random_",
              "exponential_", "set_"}
_MATRIX_KERNEL = re.compile(r"gemm|nvjet|cutlass|cublas|xmma|gemv|splitK|conv|cudnn|fprop|dgrad|"
                            r"wgrad|winograd|attention|flash|fmha|sm90_xmma", re.IGNORECASE)
_SHIFT = re.compile(rf"^{SHIFT_SPAN} n=(\d+) h=(\d+) w=(\d+) out=(\w+)$")


def load_events(path) -> Tuple[List[dict], Optional[str]]:
    """(the trace's events, the name of its first device)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    if isinstance(data, list):
        return data, None
    props = data.get("deviceProperties") or [{}]
    return data.get("traceEvents", []), props[0].get("name")


def _value(typ: str, concrete: str):
    """A recorded non-tensor argument as a Python value (None if unknown)."""
    if typ in ("Scalar", "ScalarList", "int", "float", "bool", "") and concrete not in ("", None):
        try:
            return ast.literal_eval(concrete.replace("inf", "1e999"))
        except (ValueError, SyntaxError):
            return concrete
    return None


def _tensors(dims, types) -> List[Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of every tensor among the recorded inputs, the members
    of tensor lists included."""
    out = []
    for d, t in zip(dims, types):
        if t in DTYPES:
            out.append((tuple(d), DTYPES[t]))
        elif t in ("TensorList", "GenericList") and d and isinstance(d[0], list):
            out.extend((tuple(x), torch.float32) for x in d)
    return out


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def _meta_outputs(name: str, args: dict) -> Optional[List[Tuple[tuple, torch.dtype]]]:
    """(shape, dtype) of the op's outputs, from running it on meta tensors
    built from the recorded inputs; None where that cannot be done."""
    dims, types = args.get("Input Dims"), args.get("Input type")
    if dims is None or types is None:
        return None
    strides = args.get("Input Strides") or [None] * len(dims)
    concrete = args.get("Concrete Inputs") or [""] * len(dims)
    call = []
    for d, t, st, c in zip(dims, types, strides, concrete):
        if t in DTYPES:
            call.append(torch.empty_strided(d, st if st and len(st) == len(d) else
                                            torch.empty(d, device="meta").stride(),
                                            dtype=DTYPES[t], device="meta"))
        elif t in ("TensorList", "GenericList"):
            return None
        else:
            call.append(_value(t, c))
    packet = getattr(torch.ops.aten, name, None)
    for overload in packet.overloads() if packet is not None else ():
        op = getattr(packet, overload)
        params = op._schema.arguments
        if len(call) > len(params):
            continue
        # the profiler records keyword-only arguments (an add's alpha) in order too
        args = [v for p, v in zip(params, call) if not p.kwarg_only]
        kwargs = {p.name: v for p, v in zip(params, call) if p.kwarg_only and v is not None}
        while args and args[-1] is None:
            args.pop()
        try:
            out = op(*args, **kwargs)
            break
        except Exception:  # noqa: BLE001 - this overload does not take them
            continue
    else:
        return None
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(o.shape), o.dtype) for o in outs if isinstance(o, torch.Tensor)]


def op_bytes(name: str, args: dict) -> Tuple[Optional[int], bool]:
    """(bytes one execution moves, whether its outputs are known exactly);
    the bytes are None where the trace does not hold the inputs' shapes
    (the profiler records none for a long tensor list)."""
    m = _SHIFT.match(name)
    if m:
        n, h, w = (int(m.group(i)) for i in (1, 2, 3))
        out_bytes = torch.empty((), dtype=getattr(torch, m.group(4))).element_size()
        return launch_bytes(n, h, out_bytes, w), True
    op = name.split("::", 1)[-1]
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    if any(t in ("TensorList", "GenericList") and not d for d, t in zip(dims, types)):
        return None, False
    ins = _tensors(dims, types)
    read = sum(_nbytes(s, d) for s, d in (ins[1:] if op in WRITE_ONLY else ins))
    outs = _meta_outputs(op, args)
    if outs is not None:
        return read + sum(_nbytes(s, d) for s, d in outs), True
    if not ins:
        return None, False
    try:
        shape = torch.broadcast_shapes(*(s for s, _ in ins))
    except RuntimeError:  # not elementwise: the largest input's shape
        shape = max((s for s, _ in ins), key=lambda s: _nbytes(s, torch.uint8))
    return read + _nbytes(tuple(shape), ins[0][1]), False


class _Spans:
    """The host spans of one thread, for the innermost one around a time."""

    def __init__(self, events: List[dict]):
        self.events = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.events]

    def innermost(self, ts: float) -> Optional[dict]:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            e = self.events[i]
            if e["ts"] + e.get("dur", 0) >= ts:
                return e
            i -= 1
        return None


def launching_ops(events: Sequence[dict]) -> Dict[int, dict]:
    """correlation id -> the innermost host span (aten op or annotation)
    around the runtime call that launched the device activity."""
    spans: Dict[tuple, List[dict]] = defaultdict(list)
    runtime = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in HOST_CATS:
            spans[(e.get("pid"), e.get("tid"))].append(e)
        elif cat.startswith("cuda_") and "correlation" in e.get("args", {}):  # the launch calls
            runtime[e["args"]["correlation"]] = e
    index = {k: _Spans(v) for k, v in spans.items()}
    out = {}
    for corr, r in runtime.items():
        s = index.get((r.get("pid"), r.get("tid")))
        op = s.innermost(r["ts"]) if s else None
        if op is not None:
            out[corr] = op
    return out


def is_product(kernel: str, op: str) -> bool:
    return bool(_MATRIX_KERNEL.search(kernel) or PRODUCT.search(op.split("::", 1)[-1]))


def roofline(trace, steps: int, top: int = 10, hbm_gbps: Optional[float] = None) -> dict:
    events, device_name = load_events(trace)
    if hbm_gbps is None:
        if device_name not in HBM_GBPS:
            raise ValueError(f"no memory rate known for {device_name!r}: pass --hbm-gbps")
        hbm_gbps = HBM_GBPS[device_name]
    ops = launching_ops(events)
    rows: Dict[tuple, dict] = {}
    total_us = other_us = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = float(e.get("dur", 0))
        total_us += dur
        op = ops.get(e.get("args", {}).get("correlation"))
        op_name = op["name"] if op else ""
        if is_product(e["name"], op_name):
            continue
        other_us += dur
        op_args = op.get("args", {}) if op else {}
        key = (e["name"], op_name, json.dumps(op_args.get("Input Dims")))
        row = rows.get(key)
        if row is None:
            if e["cat"] != "kernel" and "bytes" in e.get("args", {}):
                nbytes, exact = int(e["args"]["bytes"]), True
            elif op is None:
                nbytes, exact = None, False
            else:
                nbytes, exact = op_bytes(op_name, op_args)
            row = rows[key] = {"kernel": e["name"], "op": op_name, "family": family(e["name"]),
                               "input_dims": op_args.get("Input Dims"), "bytes": nbytes,
                               "bytes_exact": exact, "us": 0.0, "count": 0}
        row["us"] += dur
        row["count"] += 1
    out_rows = []
    for row in sorted(rows.values(), key=lambda r: -r["us"])[:top]:
        ms = row["us"] / 1e3 / steps
        execs = row["count"] / steps
        per_step = gbps = None
        if row["bytes"] is not None:
            per_step = row["bytes"] * execs
            gbps = per_step / (ms * 1e-3) / 1e9 if ms > 0 else 0.0
        out_rows.append({
            "kernel": row["kernel"], "op": row["op"], "family": row["family"],
            "input_dims": row["input_dims"], "execs_per_step": execs, "ms_per_step": ms,
            "pct_of_device": 100 * row["us"] / total_us if total_us else 0.0,
            "bytes_per_step": per_step, "bytes_exact": row["bytes_exact"],
            "achieved_gb_s": gbps, "roofline_pct": None if gbps is None else 100 * gbps / hbm_gbps,
        })
    return {"trace": str(trace), "device": device_name, "steps": steps, "hbm_gbps": hbm_gbps,
            "device_ms_per_step": total_us / 1e3 / steps,
            "non_product_pct": 100 * other_us / total_us if total_us else 0.0, "rows": out_rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="a Chrome trace of profile_train --trace (.json or .json.gz)")
    p.add_argument("--steps", type=int, required=True, help="the steps the trace holds")
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--hbm-gbps", type=float, default=None,
                   help="the card's memory rate (default: by the trace's device name)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    r = roofline(args.trace, args.steps, args.top, args.hbm_gbps)
    if args.json:
        print(json.dumps(r))
        return r
    print(f"{r['device']}: device {r['device_ms_per_step']:.3f} ms/step; kernels other than "
          f"products {r['non_product_pct']:.1f}% of it; memory rate {r['hbm_gbps']} GB/s")
    print(f"{'ms/step':>8} {'%dev':>6} {'execs':>6} {'MB/step':>10} {'GB/s':>8} {'roof%':>6}  "
          "kernel [op]")
    for row in r["rows"]:
        print(format_row(row))
    return r


def format_row(row: dict) -> str:
    """One row as a line: ms a step, share of the device time, executions a
    step, MB a step (``~`` estimated, ``?`` unknown), GB/s, share of the
    memory rate, the kernel and its op."""
    if row["bytes_per_step"] is None:
        moved = f"{'?':>10} {'?':>8} {'?':>6}"
    else:
        moved = (f"{'' if row['bytes_exact'] else '~'}{row['bytes_per_step'] / 1e6:>9.2f} "
                 f"{row['achieved_gb_s']:>8.1f} {row['roofline_pct']:>5.1f}%")
    return (f"{row['ms_per_step']:>8.3f} {row['pct_of_device']:>5.1f}% "
            f"{row['execs_per_step']:>6.1f} {moved}  {row['kernel'][:70]} [{row['op']}]")


if __name__ == "__main__":
    main()
