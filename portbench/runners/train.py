"""Training cells: the port's train step fed by its own data layer, as
``Trainer.fit`` drives it, for ``--seconds`` of host time.

Set-up writes the seeded dataset into the run's temporary directory and
the index of a training split of ``store_rows`` frames tiled from it
(``harness/dataset.tile_index``), builds the datamodule, spreads its
training split's RAM cache and datasets over the tiled index (so that the
sampler draws windows across all the rows and an epoch lasts as long as one
of a split of that size), builds the ``Trainer``, loads the benchmark's
weights, uploads the device store, and takes the first steps through the
window's own call and feed: the first three are the ones the reference
follows, the rest warm up. The window then runs step after step, each step
seeded from (seed, step) and the metrics fetched every ``log_every`` steps,
with a CUDA event after each step; it ends in a device synchronise. No
validation and no checkpoint.

With ``--trace 1`` a profiled slice of ``profile_steps`` more steps
follows the window (``harness/trace``), then the program slice: as many
steps again with the program's tracer on, and as many eager steps under the
profiler (``harness/program_trace``); and the FLOPs of the reference step
are counted at the batch's shapes.

Once the window has closed and the memory peak is read, the program's state
is freed and the reference (``reference/``) works out the first three
batches from the dataset's files and the tiled index and follows the three
steps from the same weights and the same seeds; ``checks`` compares them.
"""
from __future__ import annotations

import copy
import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check, counts, dataset, program_trace, trace
from portbench.harness.weights import make_weights, param_shapes
from portbench.reference.data import ReferenceBatches
from portbench.reference.train_step import ReferenceTrainStep

CHECK_STEPS = 3
BETA1 = 0.9


def step_seed(seed: int, stream: int, k: int) -> int:
    """The seed of step k's draws, as the port's trainer makes it."""
    a, b = np.random.SeedSequence([seed, stream, k]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def tile_split(dm, index_dir) -> None:
    """Spread the datamodule's training split over the tiled index in
    ``index_dir``: the RAM cache's arrays repeated copy after copy to the
    index's rows (row ``r`` holds the split's row ``r % n``, the frame of
    the tiled id at ``r``), and the split's two datasets rebuilt over the
    tiled index as ``Hulc2DataModule.setup`` builds them. Done before the
    device store's upload, which then holds every row."""
    from hulc2_torch.data import episode_index as ei
    from hulc2_torch.data.window_dataset import WindowDataset

    cfg, ram = dm.cfg, dm._stores["training"]
    ranges = ei.load_ep_start_end_ids(index_dir, "training")
    ids = np.concatenate([np.arange(s, e + 1) for s, e in ranges])
    n = len(ram.frame_ids)
    if not np.array_equal(ids[:n], ram.frame_ids):
        raise ValueError("the tiled index does not start with the split's frames")
    for k, a in ram.arrays.items():
        ram.arrays[k] = np.resize(a, (len(ids), *a.shape[1:]))
    ram.ranges = [(int(s), int(e)) for s, e in ranges]
    ram.frame_ids = ids
    ram.id_to_row = dict(zip(ids.tolist(), range(len(ids))))
    lo, hi = cfg["min_window_size"], cfg["max_window_size"]
    indices = {"vis": ei.build_vision_index(index_dir, "training", lo, hi),
               "lang": ei.build_lang_index(index_dir, "training", lo, hi, cfg["lang_folder"],
                                           aux_lang_loss_window=cfg.get("aux_lang_loss_window", 8),
                                           load_lang_embeddings=cfg.get("load_lang_embeddings", True))}
    for key, index in indices.items():
        dm.datasets[f"{key}_training"] = WindowDataset(
            index, ram, cfg["observation_space"], pad=cfg.get("pad", True), seed=dm.seed)


class Feed:
    """The trainer's batches epoch after epoch through ``DevicePrefetcher``,
    each epoch's prefetcher started as ``Trainer.fit`` starts it; ``waits``
    holds the seconds each ``next`` took, ``queue_waits`` the part of them
    that the prefetcher's own ``wait_s`` counts (blocked on its queue)."""

    def __init__(self, loader, device, prefetcher_cls):
        self.loader, self.device, self.cls = loader, device, prefetcher_cls
        self.epoch, self.it = 0, None
        self.waits: List[float] = []
        self.queue_waits: List[float] = []
        self.starts: List[float] = []
        self.epoch_steps: List[int] = []  # the step count at each epoch's first batch

    def next(self):
        t0 = time.perf_counter()
        while True:
            if self.it is None:
                self.epoch_steps.append(len(self.waits))
                self.loader.epoch = self.epoch
                self.it = self.cls(self.loader, self.device)
            queued = self.it.wait_s
            try:
                raw = next(self.it)
                self.queue_waits.append(self.it.wait_s - queued)
                break
            except StopIteration:
                self.close()
                self.epoch += 1
        self.waits.append(time.perf_counter() - t0)
        self.starts.append(t0)
        return raw

    def close(self) -> None:
        if self.it is not None:
            self.it.close()
            self.it = None


def _host(raw: dict) -> Dict[str, np.ndarray]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()
            for k, v in raw.items()}


def _to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


PACKED = ("in_proj_weight", "in_proj_bias")  # attention's query, key and value, stacked


def _slices(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves, each packed attention projection split into its query,
    key and value slices (``<name>.q``, ``.k``, ``.v``): the key's bias has no
    gradient under softmax, and ``check.moved_leaves`` leaves it out alone."""
    out = {}
    for name, t in tensors.items():
        if name.endswith(PACKED):
            out.update(zip((f"{name}.q", f"{name}.k", f"{name}.v"), t.chunk(3, dim=0)))
        else:
            out[name] = t
    return out


def _largest(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The largest absolute element of each leaf (whole, not by slice)."""
    names = sorted(tensors)
    return dict(zip(names, torch.stack([tensors[n].detach().abs().amax().float()
                                        for n in names]).tolist()))


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """The norm of each leaf, packed projections by slice (``_slices``)."""
    tensors = _slices(tensors)
    names = sorted(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, (values * scale).tolist()))


def forced_plans(cfg: dict, seed: int, device) -> List[torch.Tensor]:
    """The plan draws handed to the checked steps (the step's ``gumbel``):
    noise of 1e4 on one class of each category, drawn from the seed, so that
    the straight-through argmax takes that class on both sides and bf16
    rounding cannot break a near-tie the other way; the gradient still flows
    through the posterior's probabilities."""
    dist = cfg["model"]["distribution"]
    dm = cfg["datamodule"]
    rows = dm["batch_size_vis"] + dm["batch_size_lang"]
    rng = np.random.default_rng([seed, 7])
    out = []
    for _ in range(CHECK_STEPS):
        cls = torch.from_numpy(rng.integers(0, dist["class_size"], (rows, dist["category_size"])))
        out.append((1e4 * torch.nn.functional.one_hot(cls, dist["class_size"]).float()).to(device))
    return out


def _fault(name: str, step, params):
    """The timed path broken underneath (for the tests of the check):
    ``frozen`` returns the state unchanged, ``half_batch`` drops half of
    each modality's rows, so the means run over the rest."""
    if name == "frozen":
        def frozen(raw, gen, kl_beta, **kw):
            before = [p.detach().clone() for p in params]
            out = step(raw, gen, kl_beta, **kw)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return out
        return frozen
    if name == "half_batch":
        def half(raw, gen, kl_beta, gumbel=None):
            nl = raw["lang"].shape[0]
            nv = raw["actions"].shape[0] - nl
            keep = torch.cat([torch.arange(nv // 2), nv + torch.arange(nl // 2)])
            cut = {k: (v[keep.to(v.device)] if v.shape[0] == nv + nl
                       else v[: nl // 2]) for k, v in raw.items()}
            return step(cut, gen, kl_beta,
                        gumbel=None if gumbel is None else gumbel[keep.to(gumbel.device)])
        return half
    raise ValueError(f"unknown fault {name!r}")


def run(ctx) -> dict:
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.loader import DevicePrefetcher
    from hulc2_torch.train.trainer import Trainer

    p = ctx.traffic
    device = ctx.device
    seed = ctx.seed
    root = ctx.tmp / "data"
    index_dir = ctx.tmp / "tiled"
    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.empty(1, device=device)
    marks.append(("cuda_init", time.perf_counter()))
    cfg = copy.deepcopy(ctx.config["config"])
    dataset.write_dataset(root, seed, p["static_hw"], p["gripper_hw"],
                          {k: tuple(v) for k, v in p["splits"].items()},
                          cfg["datamodule"]["min_window_size"])
    dataset.tile_index(root / "training", index_dir, p["store_rows"],
                       cfg["datamodule"]["max_window_size"] + 1)
    cfg["datamodule"]["root_data_dir"] = str(root)
    cfg["seed"] = cfg["training"]["seed"] = seed
    if not cfg["datamodule"]["device_store"]:
        raise ValueError("the training runner feeds the step from the device store")

    marks.append(("dataset", time.perf_counter()))
    dm = Hulc2DataModule(cfg["datamodule"], seed=seed, device=device)
    dm.setup()
    tile_split(dm, index_dir)
    marks.append(("datamodule", time.perf_counter()))
    trainer = Trainer(cfg, dm, run_dir=None, device=device)
    marks.append(("trainer", time.perf_counter()))
    weights = make_weights(param_shapes(trainer.model), seed, device)
    trainer.model.load_state_dict(weights, strict=False)
    weights = {k: v.cpu() for k, v in weights.items()}
    params = dict(trainer.model.named_parameters())
    marks.append(("weights", time.perf_counter()))
    step = trainer.make_train_step()
    if ctx.fault:
        step = _fault(ctx.fault, step, list(params.values()))
    loader = dm.fused_train_iter()
    feed = Feed(loader, device, DevicePrefetcher)
    marks.append(("loader_upload", time.perf_counter()))
    gen = trainer.generator
    kl_beta = float(trainer.kl_schedule(0))
    log_every = int(cfg["trainer"].get("log_every_n_steps", 50))

    # the first steps: the three the reference follows, then the warm-up
    plans = forced_plans(cfg, seed, device)
    kept, losses = [], []
    k = 0
    for k in range(CHECK_STEPS + p["warmup_steps"]):
        raw = feed.next()
        if k < CHECK_STEPS:
            kept.append(_host(raw))
        gen.manual_seed(step_seed(seed, 0, k))
        if k < CHECK_STEPS:
            metrics = step(raw, gen, kl_beta, gumbel=plans[k])
            losses.append(metrics["loss"].float())
        else:
            metrics = step(raw, gen, kl_beta)
        if k == 0:
            _sync(device)
            marks.append(("first_step", time.perf_counter()))
            prog_metrics1 = {m: float(v) for m, v in metrics.items()}
            state = trainer.optimizer.state
            prog_grad = _norms({n: state[q]["exp_avg"] for n, q in params.items() if q in state},
                               1.0 / (1.0 - BETA1))
        if k == CHECK_STEPS - 1:
            change = {n: q.detach() - weights[n].to(device) for n, q in params.items()}
            prog_update, prog_change = _norms(change), _largest(change)
            del change  # a copy of every leaf, which would stay on the card through the window
    k += 1
    prog_losses = [float(v) for v in losses]
    _sync(device)
    marks.append(("warm_steps", time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t_start

    # the window
    cuda = device.type == "cuda"
    events = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    n = bad = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        raw = feed.next()
        gen.manual_seed(step_seed(seed, 0, k))
        metrics = step(raw, gen, kl_beta)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        n += 1
        k += 1
        if n % log_every == 0:
            names = sorted(metrics)
            values = torch.stack([metrics[m].float() for m in names]).tolist()
            bad += sum(not math.isfinite(v) for v in values) and log_every
    _sync(device)
    window_s = time.perf_counter() - t0
    waits = feed.waits[-n:] if n else []
    first = len(feed.waits) - n
    rec: dict = {"attempted": n, "failed": bad, "window_s": window_s, "setup_s": setup_s,
                 "samples_per_step": int(kept[0]["actions"].shape[0])}
    if cuda:
        done = [start] + events
        rec["step_ms"] = [a.elapsed_time(b) for a, b in zip(done, done[1:])]
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    rec["e2e"] = {"train_samples_per_s": n * rec["samples_per_step"] / max(window_s, 1e-9),
                  "setup_s": setup_s}
    if rec.get("step_ms"):
        rec["e2e"]["train_step_p95_ms"] = float(np.percentile(rec["step_ms"], 95))
    rec["diag"] = {"setup_phases_s": {b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])},
                   "epoch_starts_in_window": sum(first <= s < first + n for s in feed.epoch_steps)}
    if waits:
        w = np.asarray(waits) * 1e3
        rec["diag"]["wait_ms"] = {"median": float(np.median(w)), "p90": float(np.percentile(w, 90)),
                                  "max": float(w.max()), "over_5ms": int((w > 5).sum()),
                                  "queue_mean": 1e3 * float(np.mean(feed.queue_waits[-n:]))}
    if rec.get("step_ms"):
        s = np.asarray(rec["step_ms"])
        rec["diag"]["step_ms"] = {"median": float(np.median(s)), "p90": float(np.percentile(s, 90)),
                                  "max": float(s.max())}
    layers = {"batch_wait_s": waits, "window_s": window_s, "steps": n,
              "crops": [(int(np.prod(kept[0][c].shape[:2])), *kept[0][c].shape[2:4])
                        for c in cfg["datamodule"]["observation_space"]["rgb_obs"]]}

    if ctx.trace:
        batches = p["profile_steps"]
        spans = trace.Spans()
        with trace.profiler() as prof:
            t1 = time.perf_counter()
            for _ in range(batches):
                with spans.span("loader_wait"):
                    raw = feed.next()
                gen.manual_seed(step_seed(seed, 0, k))
                with spans.span("step_enqueue"):
                    metrics = step(raw, gen, kl_beta)
                k += 1
                if k % log_every == 0:
                    with spans.span("metrics_fetch"):
                        torch.stack([metrics[m].float() for m in sorted(metrics)]).tolist()
            _sync(device)
            t_end = time.perf_counter()
        layers["profile"] = trace.read_slice(prof, t_end, t_end - t1, batches, spans)

        def run_step(raw, eager):
            nonlocal k
            gen.manual_seed(step_seed(seed, 0, k))
            k += 1
            return step(raw, gen, kl_beta, eager=True) if eager else step(raw, gen, kl_beta)

        program = program_trace.program_slice(feed.next, feed.close, run_step, batches, device)
        if program is not None:
            layers["program"] = program
            rec["diag"]["program"] = program_trace.summary(program)

    # the program's own crops of the first batch, for the kernel's check
    transform = trainer._transform(True)
    gen.manual_seed(step_seed(seed, 0, 0))
    with torch.no_grad():
        out = transform(_to(kept[0], device), gen)["rgb_obs"]
    crop_dtype = next(iter(out.values())).dtype
    prog_crops = {c: v.float().cpu() for c, v in out.items()}
    layers["crop_out_bytes"] = torch.empty((), dtype=crop_dtype).element_size()
    del out

    feed.close()
    del feed, step, trainer, dm, loader, params, metrics, raw, transform
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference
    ref, readings = reference_readings(cfg, root, index_dir, seed, weights, device, kl_beta,
                                       crop_dtype)
    batch_diff = sum(int(np.count_nonzero(kept[i][key] != readings["batches"][i][key]))
                     if kept[i][key].shape == readings["batches"][i][key].shape
                     else kept[i][key].size
                     for i in range(CHECK_STEPS) for key in readings["batches"][i])
    crop_diff = sum(int(torch.count_nonzero(prog_crops[c] != readings["crops"][c]))
                    for c in readings["crops"])
    rec["checks"], rec["check_detail"] = compare(
        {"losses": prog_losses, "grad": prog_grad, "update": prog_update,
         "change": prog_change, "metrics1": prog_metrics1}, readings,
        ctx.extra.get("leaf_detail", False))
    rec["checks"].update(batch_diff=batch_diff, crop_diff=crop_diff)
    if ctx.trace:
        hw = {c: tuple(kept[0][c].shape[2:4]) for c in cfg["datamodule"]["observation_space"]["rgb_obs"]}
        layers["flops_per_step"] = counts.train_step_flops(cfg, hw)
    rec["layers"] = layers
    return rec


def reference_readings(cfg, root, index_dir, seed: int, weights: Dict[str, torch.Tensor], device,
                       kl_beta: float, crop_dtype, quantize=None):
    """(the reference step, its readings): the first batches worked out from
    the dataset's files and the tiled index, the crops of the first in ``crop_dtype``, the losses
    of the first steps, each leaf's first gradient norm, the leaves the
    first step gives a gradient (``trained``), and each leaf's change after
    the steps, by norm and by its largest element, from ``weights`` (on the
    host)."""
    plan = ReferenceBatches(cfg["datamodule"], root, seed, index_dir)
    batches = [plan.batch(0, b) for b in range(CHECK_STEPS)]
    ref = ReferenceTrainStep(cfg, {k: v.to(device) for k, v in weights.items()}, root, device,
                             quantize=quantize)
    crops = _reference_crops(cfg, root, batches[0], seed, device, crop_dtype)
    losses, grad = [], None
    plans = forced_plans(cfg, seed, device)
    for i in range(CHECK_STEPS):
        g = torch.Generator(device=device).manual_seed(step_seed(seed, 0, i))
        out = ref.step(_to(batches[i], device), g, kl_beta, plans[i])
        losses.append(float(out["loss"]))
        if i == 0:
            grad, trained = _norms(out["grads"]), sorted(out["grads"])
            metrics1 = {m: float(v) for m, v in out["metrics"].items()}
        del out
    change = {n: q - weights[n].to(device) for n, q in ref.params().items()}
    return ref, {"batches": batches, "crops": crops, "losses": losses, "grad": grad,
                 "trained": trained, "update": _norms(change), "change": _largest(change),
                 "metrics1": metrics1}


def compare(prog: dict, ref: dict, leaves: bool = False):
    """The numbers, ({name: value}, detail): the first step's loss gap
    relative to the reference's loss (``loss1_gap``); the worst leaf's gap
    of the change after the steps over the leaves the reference's gradient
    moves (``update_gap``, ``check.moved_leaves``); and the worst leaf's gap
    of the first gradient over the others, the leaves the reference keeps
    still (``still_grad_gap``: a key's bias under softmax, whose gradient
    is nought to rounding; a product in a lower precision breaks softmax's
    shift invariance and moves them). Gaps of the gradient are against the
    larger of the leaf's reference norm and the median leaf's over all
    leaves. ``frozen_update`` is the largest absolute change after the steps
    of any of the program's leaves that the reference's first step gives no
    gradient (``ref["trained"]``): a trunk the configuration freezes, held
    to 0 where a cell's limits name it. The detail holds what is read and
    not compared: the worst leaf's gradient gap over all leaves (``grad_gap``), the later steps'
    loss gaps, medians and quantiles, and with ``leaves`` each leaf's gaps
    and reference gradient norm. A cell's limits name the numbers it
    compares."""
    moved = check.moved_leaves(ref["grad"])
    still = sorted(set(ref["grad"]) - set(moved))
    grad_gaps = check.leaf_gaps(prog["grad"], ref["grad"])
    update_gaps = check.leaf_gaps(prog["update"], ref["update"], moved)
    grad_leaf = max(grad_gaps, key=lambda k: (math.isnan(grad_gaps[k]), grad_gaps[k]))
    update_leaf = max(update_gaps, key=lambda k: (math.isnan(update_gaps[k]), update_gaps[k]))
    still_leaf = max(still, key=lambda k: (math.isnan(grad_gaps[k]), grad_gaps[k])) if still else None
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    frozen = sorted(set(prog["change"]) - set(ref["trained"]))
    frozen_leaf = max(frozen, key=lambda k: (math.isnan(prog["change"][k]), prog["change"][k]),
                      default=None)
    numbers = {"loss1_gap": gaps[0], "update_gap": update_gaps[update_leaf],
               "still_grad_gap": grad_gaps[still_leaf] if still else 0.0,
               "frozen_update": prog["change"][frozen_leaf] if frozen else 0.0}
    detail = {"loss_gaps": gaps, "prog_losses": prog["losses"], "ref_losses": ref["losses"],
              "grad_gap": grad_gaps[grad_leaf], "grad_leaf": grad_leaf,
              "grad_gap_median": statistics.median(grad_gaps.values()),
              "grad_gap_q": _quantiles(grad_gaps.values()),
              "update_leaf": update_leaf, "update_gap_median": statistics.median(update_gaps.values()),
              "update_gap_q": _quantiles(update_gaps.values()),
              "still_leaf": still_leaf, "still_leaves": len(still), "leaves": len(ref["grad"]),
              "frozen_leaf": frozen_leaf, "frozen_leaves": len(frozen),
              "global_grad_gap": abs(_global(prog["grad"]) - _global(ref["grad"])) / _global(ref["grad"]),
              "metric_gaps1": {m: abs(prog["metrics1"][m] - v) / max(abs(v), 1e-12)
                               for m, v in ref.get("metrics1", {}).items()
                               if m in prog.get("metrics1", {})}}
    if leaves:
        detail.update(grad_gaps=_rounded(grad_gaps), update_gaps=_rounded(update_gaps),
                      ref_grad=_rounded(ref["grad"]))
    return numbers, detail


def _rounded(d: Dict[str, float]) -> Dict[str, float]:
    return {k: float(f"{v:.4g}") for k, v in d.items()}


def _quantiles(values) -> Dict[str, float]:
    v = np.asarray(sorted(values))
    return {f"p{q}": float(np.percentile(v, q)) for q in (50, 75, 90, 95)}


def _global(norms: Dict[str, float]) -> float:
    return math.sqrt(sum(v * v for v in norms.values()))


def _reference_crops(cfg, root, batch, seed, device, dtype) -> Dict[str, torch.Tensor]:
    """The reference transform's crops of ``batch`` under step 0's draws,
    in the program's output dtype."""
    from portbench.reference.port.data.device_transforms import make_batch_transform
    from portbench.reference.port.data.statistics import load_statistics

    dm = cfg["datamodule"]
    transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                     dm["transforms"], dtype=dtype, train=True,
                                     stats=load_statistics(f"{root}/training"))
    g = torch.Generator(device=device).manual_seed(step_seed(seed, 0, 0))
    with torch.no_grad():
        return {c: v.float().cpu() for c, v in transform(_to(batch, device), g)["rgb_obs"].items()}


def control(ctx) -> dict:
    """The control's readings: the reference put in the program's place in
    float8 (``reference/lowp.fp8``) against the reference in fp32, on the
    cell's dataset, weights and seeds: {"checks", "check_detail"}."""
    from portbench.reference.lowp import fp8
    from portbench.reference.port.models.build import build_policy_for

    p, device, seed = ctx.traffic, ctx.device, ctx.seed
    root, index_dir = ctx.tmp / "data", ctx.tmp / "tiled"
    cfg = copy.deepcopy(ctx.config["config"])
    dataset.write_dataset(root, seed, p["static_hw"], p["gripper_hw"],
                          {k: tuple(v) for k, v in p["splits"].items()},
                          cfg["datamodule"]["min_window_size"])
    dataset.tile_index(root / "training", index_dir, p["store_rows"],
                       cfg["datamodule"]["max_window_size"] + 1)
    cfg["datamodule"]["root_data_dir"] = str(root)
    cfg["seed"] = cfg["training"]["seed"] = seed
    shapes = param_shapes(build_policy_for({**cfg, "model": {**cfg["model"],
                                                             "compute_dtype": "float32"}}, seed=0))
    weights = {k: v.cpu() for k, v in make_weights(shapes, seed, device).items()}
    kl_beta = float(cfg["callbacks"]["kl_schedule"].get("kl_beta", cfg["loss"]["kl_beta"]))
    dtype = torch.bfloat16 if cfg["model"].get("compute_dtype") == "bfloat16" else torch.float32
    _, low = reference_readings(cfg, root, index_dir, seed, weights, device, kl_beta, dtype, fp8)
    _, ref = reference_readings(cfg, root, index_dir, seed, weights, device, kl_beta, dtype)
    checks, detail = compare(low, ref, ctx.extra.get("leaf_detail", False))
    return {"checks": checks, "check_detail": detail}
