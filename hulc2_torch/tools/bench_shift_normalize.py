"""Device time of the shift_normalize kernel at the train steps' shapes.

    python -m hulc2_torch.tools.bench_shift_normalize [--baseline SOURCE.cu]

For each camera of three launches per step -- the flagship's train step
(``rand_shift_96``: 2048 frames of 96x96x3 with pad 4, and 2048 of 64x64x3
with pad 3), ``cfg_low_level``'s train step (``rand_shift``: 2048 of
200x200x3 with pad 10, 2048 of 84x84x3 with pad 4), its validation step
per modality at pad 0 (1024 frames of each), and the static camera of the
other transform presets (``real_world``: 2048 of 200x200x3 at pad 0 with
mean 0 and std 1; ``real_world_square``: 2048 of 150x200x3 with pad 6;
``clip``: 2048 of 224x224x3 with pad 10 and CLIP's channel statistics)
-- bf16 out, it times the kernel, its plain PyTorch
version, ``imgs.to(torch.bfloat16)`` (PyTorch's elementwise cast, which moves
the same bytes) and ``imgs.clone()`` (a device-to-device copy, whose TB/s is
the card's streaming rate for a plain copy). Each time is one pair of CUDA
events around LAUNCHES back-to-back calls, divided by the count. The calls
rotate over SETS inputs, so each launch finds its input cold in the 50 MB L2,
and they queue up behind a spin kernel before the first event fires, so host
time does not reach the measurement.

``--baseline`` builds another source of the kernel whose C entry point has the
first version's signature, ``shift_normalize_launch(in, offsets, out,
out_is_bf16, n, h, w, pad, scale, shift, stream)``, and times it in turns with
this one: baseline, kernel, kernel, baseline, twice.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from hulc2_torch.kernels import build
from hulc2_torch.ops import preprocess
from hulc2_torch.tools.profiling import card_line

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
SHAPES = {"rgb_static": (2048, 96, 4), "rgb_gripper": (2048, 64, 3)}  # frames, side, pad
RAND_SHIFT_SHAPES = {"rgb_static": (2048, 200, 10), "rgb_gripper": (2048, 84, 4)}
RAND_SHIFT_VAL_SHAPES = {"rgb_static": (1024, 200, 0), "rgb_gripper": (1024, 84, 0)}
MEAN, STD = [0.5], [0.5]
CLIP_MEAN, CLIP_STD = [0.48145466, 0.4578275, 0.40821073], [0.26862954, 0.26130258, 0.27577711]
# frames, height, width, pad, mean, std of the static camera's train kernel run
PRESET_SHAPES = {"real_world": (2048, 200, 200, 0, [0.0], [1.0]),
                 "real_world_square": (2048, 150, 200, 6, [0.0], [1.0]),
                 "clip": (2048, 224, 224, 10, CLIP_MEAN, CLIP_STD)}
STEPS = {"rand_shift_96 train": SHAPES, "rand_shift train": RAND_SHIFT_SHAPES,
         "rand_shift val": RAND_SHIFT_VAL_SHAPES,
         "presets train": {f"{k} rgb_static": v for k, v in PRESET_SHAPES.items()}}
LAUNCHES = 50
SETS = 4  # 4 x 57 MB of static frames: each set is out of L2 when its turn comes
SPIN_CYCLES = 1 << 25  # ~17 ms at 1.98 GHz; lengthened while the host needs longer to enqueue

Set = Tuple[torch.Tensor, torch.Tensor]


def device_ms(call: Callable[[int], object]) -> float:
    """Device time per call of ``call(k)``, k = 0..LAUNCHES-1, enqueued back to
    back between one pair of CUDA events. A spin kernel holds the stream until
    every call is enqueued, so the events see the device's time only; if the
    spin ran out first, the run is repeated with a longer spin."""
    for k in range(SETS):  # warm-up: a first call builds and allocates
        call(k)
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for k in range(LAUNCHES):
            call(k)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        queued_first = not start.query()
        end.synchronize()
        if queued_first:
            return start.elapsed_time(end) / LAUNCHES
        spin *= 4
    raise RuntimeError(f"enqueueing {LAUNCHES} calls took {enqueue_ms:.1f} ms on the host, longer "
                       f"than a spin of {spin // 4} cycles: the events would time the host")


def rotating(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
             sets: Sequence[Set]) -> Callable[[int], None]:
    """call(k) runs ``fn`` on set k mod len(sets) and keeps its output alive
    until the same set comes round again, so outputs rotate as inputs do."""
    outs: List[Optional[torch.Tensor]] = [None] * len(sets)

    def call(k: int) -> None:
        outs[k % len(sets)] = fn(*sets[k % len(sets)])

    return call


def full_shape(shape: tuple) -> tuple:
    """(n, h, w, pad, mean, std) of a (n, side, pad) or a full shape."""
    if len(shape) == 3:
        n, hw, pad = shape
        return n, hw, hw, pad, MEAN, STD
    return shape


def make_sets(n: int, hw: int, pad: int, count: int, dev: torch.device, seed: int,
              w: Optional[int] = None) -> List[Set]:
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randint(0, 256, (n, hw, w or hw, 3), generator=g, device=dev,
                           dtype=torch.uint8),
             torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device=dev, dtype=torch.int32))
            for _ in range(count)]


def launch_bytes(n: int, hw: int, out_bytes: int, w: Optional[int] = None) -> int:
    """Bytes one launch on (n, hw, w or hw, 3) uint8 frames must move: each
    input byte (frames and int32 offsets) read once, each output element
    written once."""
    return n * hw * (w or hw) * 3 * (1 + out_bytes) + n * 2 * 4


def bound(n: int, hw: int, out_bytes: int, w: Optional[int] = None) -> Tuple[float, str]:
    """(ms, what bounds it) for one launch of (n, hw, w or hw, 3) frames:
    ``launch_bytes`` over the memory rate, 2 fp32 flops per element over the
    fp32 rate."""
    elems = n * hw * (w or hw) * 3
    t_bytes = launch_bytes(n, hw, out_bytes, w) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * elems / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_fn(pad: int, mean=MEAN, std=STD) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    return lambda imgs, off: preprocess.random_shift_normalize(imgs, off, pad, mean, std)


def plain_fn(pad: int, mean=MEAN, std=STD) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    return lambda imgs, off: preprocess.shift_normalize_plain(imgs, off, pad, mean, std)


def cast_fn(imgs: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return imgs.to(torch.bfloat16)


def copy_fn(imgs: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return imgs.clone()


def baseline_fn(source: Path, pad: int) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The kernel of ``source`` (first-version C signature), built with the
    port's nvcc flags into the build directory."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()
    lib = build.BUILD_DIR / f"libbaseline-{digest[:12]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(source)],
                       check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).shift_normalize_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scale_c, shift_c = preprocess._affine_c(tuple(MEAN), tuple(STD), 3)

    def run(imgs: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = imgs.shape
        out = torch.empty(imgs.shape, dtype=torch.bfloat16, device=imgs.device)
        err = fn(imgs.data_ptr(), off.data_ptr(), out.data_ptr(), 1, n, h, w, pad, scale_c, shift_c,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline launch failed with cudaError {err}")
        return out

    return run


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--baseline", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    summary: Dict = {"card": card}
    cases = [(f"{step} {cam}", shape) for step, shapes in STEPS.items() for cam, shape in shapes.items()]
    for seed, (cam, shape) in enumerate(cases):
        n, hw, w, pad, mean, std = full_shape(shape)
        sets = make_sets(n, hw, pad, SETS, dev, seed, w)
        bound_ms, _ = bound(n, hw, 2, w)
        variants = {"kernel": kernel_fn(pad, mean, std), "plain": plain_fn(pad, mean, std),
                    "cast": cast_fn, "copy": copy_fn}
        order = ["kernel", "plain", "cast", "copy"]
        if args.baseline is not None and (mean, std) == (MEAN, STD):
            variants["baseline"] = baseline_fn(args.baseline, pad)
            want = preprocess.shift_normalize_plain(*sets[0], pad, MEAN, STD)
            if not torch.equal(variants["baseline"](*sets[0]), want):
                raise RuntimeError("the baseline kernel disagrees with the plain version")
            order = ["baseline", "kernel", "kernel", "baseline"] * 2 + ["plain", "cast",
                                                                                 "copy"]
        times: Dict[str, List[float]] = {k: [] for k in variants}
        for name in order:
            times[name].append(device_ms(rotating(variants[name], sets)))
            print(f"  {cam} {name}: {times[name][-1]:.4f} ms", flush=True)
        row = {name: statistics.median(ts) for name, ts in times.items()}
        copy_tb_s = 2 * sets[0][0].numel() / (row.pop("copy") * 1e-3) / 1e12
        row.update(bound_ms=bound_ms, copy_tb_s=copy_tb_s,
                   runs={k: ts for k, ts in times.items() if len(ts) > 1})
        summary[cam] = row
        line = ", ".join(f"{k} {row[k]:.4f} ms ({100 * bound_ms / row[k]:.1f}% of bound)"
                         for k in variants if k != "copy")
        line += f"; a device copy of the input moves {copy_tb_s:.3f} TB/s"
        print(f"{cam} {n}x{hw}x{w}x3 pad {pad} bf16, bound {bound_ms:.4f} ms: {line}", flush=True)
        for k, ts in row["runs"].items():
            print(f"  {k} in turn order: " + ", ".join(f"{t:.4f}" for t in ts), flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
