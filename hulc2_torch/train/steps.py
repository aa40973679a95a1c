"""The fused train step and the fused rollout steps (``hulc2_tpu/train/steps.py``).

Train step (``:24-88``): concatenate the raw uint8 vis and lang windows (a
single-modality batch is transformed alone), run the transform (one
shift_normalize launch per RGB camera over all B*S frames), the model
forward under bf16 autocast, the loss with the CLIP and
aux betas, backward through autograd, the gradients clipped by their global
norm where the config asks for it, and one optimizer update at the
schedule's learning rate. Returns the metrics, ``loss`` and ``grad_norm``
(before clipping, as in JAX) included, as detached tensors on the device.
Its phases are spans of ``core/trace``, recorded while tracing is on:
``train.step`` (with its call count) holds ``train.forward`` (the transform,
``train.transform``, the model and the loss sum), ``train.backward`` and
``train.optimizer`` (``train.grad_norm``: the norm and the clip;
``train.adam``: the update and the schedule), and on the card the counters
``train.host_syncs`` and ``train.device_mallocs``.

On the card in one process the step is captured once per batch signature as
one CUDA graph and replayed (``StepGraphs``): ~2,350 launches of the
flagship step become one graph launch. A replayed step's span is
``train.replay`` under ``train.step``; the inner phases are spans only of
eager and capturing calls. Counters: ``train.eager_steps``,
``train.graph_captures``, ``train.graph_replays`` and
``train.runahead_waits`` (a replay that waited for the device).

Rollout steps (``:146``, ``:178``): one call per env step for a batch of envs,
under ``torch.inference_mode()``: [render the frames (and depth_static) from
the env states,] the val transform (one shift_normalize launch at pad 0 per
RGB camera), the policy step on the rgb and depth frames and the processed
robot_obs, then the gripper binarized to +-1. They return the device
action without waiting for it.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from hulc2_torch import kernels
from hulc2_torch.core import trace
from hulc2_torch.data.device_transforms import LANG_KEYS
from hulc2_torch.models.hulc2 import Hulc2, PolicyCarry, PolicyDraws
from hulc2_torch.parallel import batch_shard
from hulc2_torch.parallel.batch_shard import BatchShard
from hulc2_torch.parallel.mesh import unwrap
from hulc2_torch.train.optim import clip_gradients_
from hulc2_torch.utils.device import resolve_device


def aux_betas_from_loss_cfg(loss_cfg: dict) -> Dict[str, float]:
    """Metric name -> beta of the aux losses (``hulc2_tpu/train/trainer.py:130-134``);
    a metric the model does not emit adds nothing."""
    return {
        "proprio_loss": loss_cfg.get("state_recon_beta", 0.5),
        "lang_pred_loss": loss_cfg.get("bc_z_auxiliary_loss_beta", 1.0),
        "lang_contrastive_loss": loss_cfg.get("mia_auxiliary_loss_beta", 1.0),
        "lang_task_loss": loss_cfg.get("lang_task_auxiliary_loss_beta", 1.0),
    }


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, transform: Callable,
                    clip_loss_beta: float = 3.0, aux_betas: Optional[Dict[str, float]] = None,
                    device=None, scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    gradient_clip_norm: Optional[float] = None) -> Callable:
    """fn(raw_batch, generator, kl_beta, gumbel=None, draws=None, eager=False) -> metrics.

    ``raw_batch`` is {"vis": window dict, "lang": window dict}, or one batch
    with [vis; lang] rows already fused, as the device-store loader yields it
    (``hulc2_tpu/train/steps.py:41-47``: n_vis is its action rows less its
    lang rows), or a single modality's {"vis": ...} or {"lang": ...}.
    ``draws`` and ``gumbel`` replace the transform's draws (the crop
    offsets among them, ``data/device_transforms``) and the plan sampler's
    draw (the parity tests hand in the same draws as the JAX side). Raises unless the model lives on ``device`` (CUDA unless
    ``device="cpu"`` is asked for).

    ``model`` may be the policy wrapped for data parallelism
    (``parallel/mesh.wrap_model``): each rank then steps on its own rows, its
    draws and its batch-coupled losses taken over the global batch of all
    ranks' rows (``parallel/batch_shard.py``), the gradients averaged over
    the ranks before their norm and clipping, and the returned metrics are
    the ranks' mean: those of one process's step on the global batch.

    On the card in one process, the model not wrapped for data parallelism,
    without ``draws``, with a float ``kl_beta`` and a capturable optimizer
    (``capture_safe``; ``graph_engages``), the step is replayed as a
    CUDA graph, one per batch signature (``batch_signature``, and the
    generator): a signature's first call runs eager and, unless it made a
    host synchronisation, its second captures the step and every later call
    replays it (``StepGraphs``, the returned function's ``graphs``; None
    where the step never replays); a signature whose first call synchronised
    stays eager. The work, its order and its precision are the eager step's.
    Every other call runs eager, and so does a call with ``eager=True``
    (``tools/profile_train``'s traced steps, whose kernels ``tools/roofline``
    links to the ops that launched them, which a replay does not have).
    """
    device = resolve_device(device)
    core = unwrap(model)
    param_device = next(core.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, the step on {device}")
    use_autocast = device.type == "cuda" and getattr(core, "compute_dtype", None) == torch.bfloat16
    aux_betas = dict(aux_betas or {})
    params = list(model.parameters())
    # optax decays every parameter, those without a gradient in this graph
    # (GCBC's plan heads) too; torch skips a parameter whose .grad is None
    zero_fill = any(g.get("weight_decay", 0.0) for g in optimizer.param_groups)
    wrapped = model is not core or _sharded(model)  # DDP or FSDP2, on any number of ranks
    world = dist.get_world_size() if wrapped else 1
    rank = dist.get_rank() if world > 1 else 0
    graphs = (StepGraphs(device, model, params, scheduler)
              if graph_engages(device, world, wrapped=wrapped) else None)

    calls = 0

    def step(raw_batch: Dict, generator: torch.Generator,
             kl_beta: float, gumbel: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None, eager: bool = False) -> Dict[str, torch.Tensor]:
        nonlocal calls
        calls += 1
        with trace.span("train.step", step=calls):
            key = None
            if (graphs is not None and not eager and graph_engages(device, world, draws, wrapped)
                    and isinstance(kl_beta, (int, float)) and capture_safe(optimizer)):
                sig = batch_signature(raw_batch, gumbel)
                if _on_card(sig):
                    key = (sig, generator)
            seen = graphs.table.get(key) if key is not None else EAGER
            if isinstance(seen, CapturedStep):
                trace.count("train.graph_replays")
                return graphs.replay(seen, raw_batch, gumbel, kl_beta)
            counts = trace.device_counts(device, syncs="train.host_syncs",
                                         mallocs="train.device_mallocs")
            if seen is WARM:
                with counts:
                    captured = graphs.capture(key, body, raw_batch, generator, gumbel)
                trace.count("train.graph_captures")
                return graphs.replay(captured, None, None, kl_beta)
            with counts:
                trace.count("train.eager_steps")
                if seen is EAGER:
                    return step_body(raw_batch, generator, kl_beta, gumbel, draws)
                # the signature's first call: it warms up (the optimizer's
                # state, cuDNN's and cuBLAS's handles) and tells whether the
                # step synchronises, which a graph cannot
                with trace.SyncCounter() as syncs:
                    metrics = step_body(raw_batch, generator, kl_beta, gumbel, draws)
                graphs.table[key] = WARM if syncs.n == 0 else EAGER
                return metrics

    def body(raw_batch, generator, kl_beta, gumbel):
        """The captured step: the eager one without the schedule's step,
        which the replay takes on the host."""
        return step_body(raw_batch, generator, kl_beta, gumbel, None, schedule=False)

    def step_body(raw_batch, generator, kl_beta, gumbel, draws, schedule=True):
        if "actions" in raw_batch:  # fused on the host or by the store's gather
            fused = raw_batch
            n_vis = fused["actions"].shape[0] - fused["lang"].shape[0]
        elif len(raw_batch) == 1:  # one modality (vision_only, lang_only)
            fused = raw_batch.get("vis", raw_batch.get("lang"))
            n_vis = fused["actions"].shape[0] if "vis" in raw_batch else 0
        else:
            vis, lang = raw_batch["vis"], raw_batch["lang"]
            n_vis = vis["actions"].shape[0]
            # fuse BEFORE the transform: the uint8 concat moves a quarter of the bytes
            fused = {k: torch.cat([vis[k], lang[k]], dim=0) for k in vis if k in lang}
            fused.update({k: lang[k] for k in LANG_KEYS if k in lang})
        shard = (BatchShard(rank, world, n_vis, fused["actions"].shape[0] - n_vis)
                 if world > 1 else None)
        model.train()
        with trace.span("train.forward"):
            with batch_shard.active(shard):
                with trace.span("train.transform"):
                    batch = transform(fused, generator, draws)
                with torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                                    enabled=use_autocast):
                    metrics = model(batch, kl_beta, n_vis, deterministic=False,
                                    generator=generator, gumbel=gumbel)
            loss = metrics["total_loss"]
            if "lang_clip_loss" in metrics:
                loss = loss + clip_loss_beta * metrics["lang_clip_loss"]
            for key, beta in aux_betas.items():
                if key in metrics:
                    loss = loss + beta * metrics[key]
            metrics["loss"] = loss
        with trace.span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if zero_fill:
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        with trace.span("train.optimizer"):
            with trace.span("train.grad_norm"):
                grads = [p.grad for p in params if p.grad is not None]
                metrics["grad_norm"] = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(_full(g).float()) for g in grads]))
                if gradient_clip_norm:
                    clip_gradients_([_local(g) for g in grads], metrics["grad_norm"],
                                    gradient_clip_norm)
            with trace.span("train.adam"):
                optimizer.step()
                if scheduler is not None and schedule:
                    scheduler.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return mean_over_ranks(metrics) if world > 1 else metrics

    step.graphs = graphs
    return step


def graph_engages(device: torch.device, world: int, draws: Optional[Dict] = None,
                  wrapped: bool = False) -> bool:
    """Whether a train step may be replayed as a CUDA graph: on the card, in
    one process, not a data-parallel rank (a model wrapped by DDP or FSDP2
    stays eager, on one rank too: its reducer's work cannot be captured)
    and without given draws (the parity tests' steps stay eager)."""
    return device.type == "cuda" and world == 1 and not wrapped and draws is None


def capture_safe(optimizer: torch.optim.Optimizer) -> bool:
    """Whether the optimizer's update can be replayed: every group
    ``capturable``, its learning rate a tensor on the card, which the
    schedule fills in place (a float would be baked into the graph)."""
    return all(g.get("capturable", False) and isinstance(g["lr"], torch.Tensor)
               and g["lr"].is_cuda for g in optimizer.param_groups)


def _leaves(batch: Dict, path: tuple = ()):
    """(path, value) of a (nested) batch dict's leaves, in its order."""
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def batch_signature(raw_batch: Dict, gumbel: Optional[torch.Tensor]) -> tuple:
    """((path, shape, dtype, device) of each of the batch's leaves, and
    gumbel's (shape, dtype, device) or None): a captured step replays only a
    batch of its signature. A leaf that is not a tensor reads (path, None,
    None, None)."""
    leaves = tuple((path, tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
                   else (path, None, None, None) for path, v in _leaves(raw_batch))
    return leaves, None if gumbel is None else (tuple(gumbel.shape), gumbel.dtype, gumbel.device)


def _on_card(signature: tuple) -> bool:
    """Whether every tensor of a signature is on the card, and every leaf a tensor."""
    leaves, gumbel = signature
    devices = [d for *_, d in leaves] + ([gumbel[2]] if gumbel else [])
    return all(d is not None and d.type == "cuda" for d in devices)


WARM = "warm"  # a signature whose first call made no host sync: the next call captures
EAGER = "eager"  # a signature whose first call synchronised, or a call not replayed


class CapturedStep(NamedTuple):
    """One signature's captured step: the graph, the buffers it reads (the
    batch's leaves in ``_leaves`` order, ``gumbel``), the gradients it leaves
    on the parameters, the metrics it packs into one float32 vector with
    their (name, shape, dtype), and the hand-written kernels' launches it
    holds (``kernels.LAUNCHES`` counted them once, at the capture)."""
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]
    gumbel: Optional[torch.Tensor]
    grads: List[Optional[torch.Tensor]]
    packed: torch.Tensor
    layout: List[Tuple[str, torch.Size, torch.dtype]]
    launches: Dict[str, int]


class StepGraphs:
    """The captured train steps of one ``make_train_step`` on the card.

    ``table`` maps (signature, generator) to WARM, EAGER or a
    ``CapturedStep``. Each capture registers the step's generator with its
    graph, so that the caller's ``manual_seed`` before a replay reseeds it
    and the replay draws what the eager step would; it runs on a side stream
    of its own in ``thread_local`` mode (the prefetch thread goes on
    enqueueing its gathers meanwhile), and all captures share one memory
    pool (their replays never overlap), after the caching allocator's unused
    blocks went back to the card. A replay copies the batch into the
    graph's buffers and the KL beta into a device scalar the graphs read,
    launches the graph, adds the launches it holds to ``kernels.REPLAYED``
    (not on the replay right after the capture, whose launches the wrapper
    counted while it recorded them), steps the schedule on the host and
    returns a copy of the packed metrics. The host runs at most two replays
    ahead of the device: each replay waits on the end of the one two before
    it, and counts ``train.runahead_waits`` when it has to."""

    RUN_AHEAD = 2

    def __init__(self, device: torch.device, model: nn.Module, params: List[torch.Tensor],
                 scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]):
        self.device, self.model, self.params, self.scheduler = device, model, params, scheduler
        self.table: Dict[tuple, object] = {}
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.kl = torch.zeros((), dtype=torch.float32, device=device)
        self.kl_value: Optional[float] = None
        self.done = [torch.cuda.Event() for _ in range(self.RUN_AHEAD)]
        self.replays = 0

    def capture(self, key: tuple, body: Callable, raw_batch: Dict, generator: torch.Generator,
                gumbel: Optional[torch.Tensor]) -> CapturedStep:
        """Capture ``body`` on copies of the batch and ``gumbel``, the KL
        scalar and ``generator``; the copies hold this call's batch, so a
        replay without a new batch runs this call's step. Raises if the
        capture fails."""
        inputs = _map_leaves(raw_batch, torch.clone)
        static_gumbel = None if gumbel is None else gumbel.clone()
        # the capture allocates the step's memory anew, in the graphs' own
        # pool, which cannot take the blocks the caching allocator keeps from
        # the eager calls; those go back to the card first, with the pools of
        # graphs no longer referenced (a reference cycle may still hold a
        # finished run's step until the collector runs), so that the peak is
        # the eager step's and not twice it
        gc.collect()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        launched = dict(kernels.LAUNCHES)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                metrics = body(inputs, generator, self.kl, static_gumbel)
                layout = [(k, v.shape, v.dtype) for k, v in metrics.items()]
                packed = torch.cat([v.float().reshape(-1) for v in metrics.values()])
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:  # the capture it invalidated: the body's error is raised
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        if self.pool is None:
            self.pool = graph.pool()
        captured = CapturedStep(graph, [v for _, v in _leaves(inputs)], static_gumbel,
                                [p.grad for p in self.params], packed, layout,
                                {k: n - launched[k] for k, n in kernels.LAUNCHES.items()})
        self.table[key] = captured
        return captured

    def replay(self, c: CapturedStep, raw_batch: Optional[Dict], gumbel: Optional[torch.Tensor],
               kl_beta: float) -> Dict[str, torch.Tensor]:
        """Run ``c`` on ``raw_batch`` (None: the batch it was captured on)."""
        slot = self.done[self.replays % self.RUN_AHEAD]
        if self.replays >= self.RUN_AHEAD and not slot.query():
            trace.count("train.runahead_waits")
            slot.synchronize()
        with trace.span("train.replay"):
            if raw_batch is not None:
                torch._foreach_copy_(c.inputs, [v for _, v in _leaves(raw_batch)])
                if gumbel is not None:
                    c.gumbel.copy_(gumbel)
            if kl_beta != self.kl_value:
                self.kl.fill_(kl_beta)
                self.kl_value = kl_beta
            if not self.model.training:
                self.model.train()
            c.graph.replay()
            if raw_batch is not None:  # not the capture's own replay: the wrapper counted those
                for k, n in c.launches.items():
                    kernels.REPLAYED[k] += n
            slot.record()
            self.replays += 1
            for p, g in zip(self.params, c.grads):
                if p.grad is not g:
                    p.grad = g
            if self.scheduler is not None:
                self.scheduler.step()
            flat = c.packed.clone()
        out, at = {}, 0
        for name, shape, dtype in c.layout:
            n = shape.numel()
            out[name] = flat[at:at + n].view(shape).to(dtype)
            at += n
        return out


def _map_leaves(batch: Dict, fn: Callable) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in batch.items()}


def _sharded(model: nn.Module) -> bool:
    """Whether FSDP2 shards the model's parameters."""
    return any(hasattr(p, "full_tensor") for p in model.parameters())


def _full(g: torch.Tensor) -> torch.Tensor:
    return g.full_tensor() if hasattr(g, "full_tensor") else g


def _local(g: torch.Tensor) -> torch.Tensor:
    return g.to_local() if hasattr(g, "to_local") else g


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the process group's ranks, in one all-reduce."""
    names = sorted(metrics)
    values = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(values)
    values /= dist.get_world_size()
    return dict(zip(names, values.unbind()))


def make_val_step(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw_batch, generator, kl_beta=0.01, draws=None) -> metrics
    (``hulc2_tpu/train/steps.py:91-99``): each modality of a {"vis": ...,
    "lang": ...} batch goes through the val ``transform`` on its own (the
    shift_normalize kernel at pad 0, one launch per camera), then
    ``Hulc2.val_forward`` without gradients. The JAX step leaves kl_beta at
    ``val_forward``'s default of 0.01, and so does the trainer here."""
    device = next(model.parameters()).device

    def step(raw_batch: Dict[str, Dict[str, torch.Tensor]], generator: Optional[torch.Generator],
             kl_beta: float = 0.01, draws: Optional[Dict[str, PolicyDraws]] = None
             ) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), _autocast(model, device):
            batch = {m: transform(raw_batch[m], None) for m in raw_batch}
            metrics = model.val_forward(batch, kl_beta, generator, draws)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_plan_sampler(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw_batch, generator, noise=None) -> (plans (B_total, P), modality
    ids (B_total,)) for the plan-space t-SNE (``hulc2_tpu/train/steps.py:102-127``):
    each modality of a {"vis": ..., "lang": ...} batch, in sorted order (lang
    0, vis 1), through the val ``transform``, the perceptual encoder and the
    posterior without dropout, and a plan sampled from it. ``noise`` maps a
    modality to its plan's draw (Gumbel noise or a standard normal, as
    ``Hulc2.forward``'s ``gumbel``); without it the draw comes from
    ``generator``."""
    device = next(model.parameters()).device

    def sample(raw_batch: Dict[str, Dict[str, torch.Tensor]],
               generator: Optional[torch.Generator],
               noise: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        plans, labels = [], []
        with torch.no_grad(), _autocast(model, device):
            for i, mod in enumerate(sorted(raw_batch)):
                emb = model.encode(transform(raw_batch[mod], None))
                pr_state, _ = model.plan_recognition(emb)
                plan = model._plan(pr_state.float(), (noise or {}).get(mod), generator,
                                   rsample=False)
                plans.append(plan.float())
                labels.append(torch.full((plan.shape[0],), i, dtype=torch.int32,
                                         device=plan.device))
        return torch.cat(plans), torch.cat(labels)

    return sample


def _binarize_gripper(action: torch.Tensor) -> torch.Tensor:
    grip = torch.where(action[..., -1] > 0, 1.0, -1.0).to(action.dtype)
    return torch.cat([action[..., :-1], grip[..., None]], dim=-1)


def _autocast(model: Hulc2, device: torch.device):
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          enabled=device.type == "cuda" and model.compute_dtype == torch.bfloat16)


def make_fused_policy_step(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw, goal, carry, generator, draws=None) -> (action (B, 7), carry).

    ``raw`` holds (B, 1, H, W, 3) uint8 frames per camera, (B, 1, H, W)
    depth maps per depth camera, ``robot_obs_raw`` (B, 1, 15) and, when the
    observation space names it, ``scene_obs`` (B, 1, 24) on the model's
    device; ``goal`` is {"lang": token ids (B, 77)} or a visual goal
    (``Hulc2.policy_step``)."""
    device = next(model.parameters()).device

    def step(raw: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode(), _autocast(model, device):
            tfd = transform(raw, generator)
            action, carry = model.policy_step(tfd["rgb_obs"], tfd["robot_obs_raw"], goal, carry,
                                              generator, draws, depth_obs=tfd["depth_obs"],
                                              robot_obs=tfd["robot_obs"])
            return _binarize_gripper(action), carry

    return step


def make_fused_render_policy_step(model: Hulc2, transform: Callable, render_fn: Callable,
                                  rgb_keys: Sequence[str], depth_keys: Sequence[str] = ()) -> Callable:
    """fn(state, goal, carry, generator, draws=None) -> (action (B, 7), carry),
    where ``state`` = {"robot_obs": (B, 15), "scene_obs": (B, 24)} float32 on
    the model's device: the frames of ``rgb_keys`` and the depth maps of
    ``depth_keys`` are rendered on the device (``envs/render_torch.py``;
    ``hulc2_tpu/train/steps.py:198-199``), then the step of
    ``make_fused_policy_step``. The state's scene_obs goes to the transform
    too, which reads it when the observation space names it; JAX's render
    step drops it (``:196-201``)."""
    device = next(model.parameters()).device
    policy_step = make_fused_policy_step(model, transform)

    def step(state: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode():
            robot = state["robot_obs"].float()
            frames = render_fn(state["scene_obs"].float(), robot)
            raw = {k: frames[k][:, None] for k in list(rgb_keys) + list(depth_keys)}
            raw["robot_obs_raw"] = robot[:, None]
            raw["scene_obs"] = state["scene_obs"].float()[:, None]
            raw["actions"] = torch.zeros((robot.shape[0], 1, 7), dtype=torch.float32,
                                         device=device)
            return policy_step(raw, goal, carry, generator, draws)

    return step
