"""Batched, pipelined CALVIN evaluation: K lockstep envs, one policy call per step.

The port's copy of ``PipelinedEvaluator`` from
``hulc2_tpu/evaluation/batched_eval.py:228``. K env instances run in
lockstep (``envs.EnvFarm``); the policy step of all K is one call (the carry
is batched and resettable per env), and the task oracle is checked per env
on the host. The K envs are
split into C cohorts, each with its own agent: while one cohort's policy step
runs on the device, the other cohorts' host simulators step, so the wall
time per K env steps approaches max(host sim time, C x dispatch time).

Each env works through its own queue of (initial_state, chain) jobs; when
env i finishes (or fails) its chain, it resets to its next job at once.
Under the paraphrase protocol each chain's goals, the policy's and the
detector's, are the task's variant ``job_idx % n_variants``.
``BatchedEvaluator`` is the single-cohort case.

Given an affordance predictor, the evaluator runs the hierarchical (HULC++)
mode: at each subtask start the env's static frame and the task's
instruction are queued; the queries of one round are answered by one batched
prediction before the next dispatch; the predicted pixel and depth are
deprojected to a world point, and when that pixel is more than
``MOVE_THRESHOLD_PX`` from the TCP's, a staged PD ``ApproachController``
drives the arm to the point (raised by ``APPROACH_OFFSET``). Its absolute
actions replace the policy's for that env and do not use the subtask's
step budget; when it is done, the env's policy carry restarts.

Two faults of the original are repaired here: ``evaluate`` resets the list
of finished chains with the rest of its per-run state, and the partial
results file is replaced atomically. Unlike the original, the partial file
also gets a last snapshot when the run ends. The module imports no torch: the device
action is fetched by ``_AsyncFetch``, which imports it only for a tensor.
"""
from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hulc2_torch.agents.approach import ApproachController
from hulc2_torch.envs.camera import PinholeCamera
from hulc2_torch.envs.render import render, scene_boxes
from hulc2_torch.envs.task_oracle import SceneObsTaskOracle
from hulc2_torch.evaluation.harness import count_success
from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
from hulc2_torch.evaluation.sequences import get_sequences

logger = logging.getLogger(__name__)

MOVE_THRESHOLD_PX = 15.0  # approach only when the target pixel is farther from the TCP's
APPROACH_OFFSET = np.array([0.0, 0.0, 0.1])  # the approach ends this far above the target


class _AsyncFetch:
    """The host copy of a step's (K, 7) actions, started at once, waited for
    in ``get()``. A CUDA tensor is copied without blocking into pinned host
    memory, and a CUDA event recorded after the copy is what ``get()`` waits
    on; no second thread touches the device. Host arrays and CPU tensors are
    ready as they are."""

    __slots__ = ("_host", "_event")

    def __init__(self, actions):
        self._event = None
        self._host = actions
        if isinstance(actions, np.ndarray):
            return
        import torch

        if actions.device.type == "cuda":
            self._host = torch.empty(actions.shape, dtype=actions.dtype, pin_memory=True)
            self._host.copy_(actions, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(actions.device))

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host if isinstance(self._host, np.ndarray) else self._host.numpy()


class _EnvJob:
    """Per-env chain cursor."""

    __slots__ = ("chain", "subtask_idx", "steps_left", "start_info", "done", "result",
                 "job_idx", "approach", "approach_steps")

    def __init__(self, job_idx: int, chain: Sequence[str]):
        self.job_idx = job_idx
        self.chain = list(chain)
        self.subtask_idx = 0
        self.steps_left = 0
        self.start_info = None
        self.done = False
        self.result = 0
        # hierarchical mode: the subtask's PD approach in flight (the policy's
        # actions are ignored until it is done) and its steps so far
        self.approach: Optional[ApproachController] = None
        self.approach_steps = 0


class _Cohort:
    """One (farm, agent) pair working a shared job queue."""

    def __init__(self, farm, agent, evaluator: "PipelinedEvaluator"):
        if agent.n_envs != len(farm):
            raise ValueError(f"agent for {agent.n_envs} envs on a farm of {len(farm)}")
        self.farm = farm
        self.agent = agent
        self.ev = evaluator
        self.k = len(farm)
        self.jobs: List[Optional[_EnvJob]] = [None] * self.k
        self.goals = np.zeros((self.k, evaluator.goal_dim), evaluator.goal_dtype)
        self.pending: Optional[_AsyncFetch] = None  # the in-flight step's actions
        # the approach phase's actions of the in-flight step, which replace
        # the policy's in settle()
        self._pd_actions: List[Optional[tuple]] = [None] * self.k
        # per-env latest observation, reused for the next dispatch so each
        # env renders exactly once per step
        self.obs: List[Optional[Dict]] = [None] * self.k

    @property
    def active(self) -> bool:
        return any(j is not None for j in self.jobs)

    def assign(self, i: int) -> bool:
        """Pull the next job from the shared queue into env slot i."""
        job_idx = self.ev.take_job()
        if job_idx is None:
            self.jobs[i] = None
            return False
        job = _EnvJob(job_idx, self.ev.sequences[job_idx][1])
        self.jobs[i] = job
        initial_state, _ = self.ev.sequences[job_idx]
        robot_obs, scene_obs = get_env_state_for_initial_condition(dict(initial_state))
        self.obs[i] = self.farm.envs[i].reset(robot_obs=robot_obs, scene_obs=scene_obs)
        self.begin_subtask(i, job)
        self.goals[i] = self.ev.goal_for(job.chain[0], job.job_idx)
        return True

    def begin_subtask(self, i: int, job: _EnvJob):
        job.steps_left = self.ev.ep_len
        job.approach_steps = 0
        job.start_info = self.farm.envs[i].get_info()
        self.agent.reset_env_slot(i)
        self.ev.queue_approach(self.farm.envs[i], self.obs[i], job, job.chain[job.subtask_idx])

    def dispatch(self):
        """Submit the next policy step for this cohort without waiting. The
        queued affordance queries are answered first; an env in its approach
        phase gets its PD action from the same observation, and an approach
        that is done restarts the env's carry before the step. The step covers
        all K envs; the approaching envs' policy actions are dropped in
        settle()."""
        if any(o is None for o in self.obs):
            self.obs = [o if o is not None else e.get_obs()
                        for o, e in zip(self.obs, self.farm.envs)]
        t0 = time.perf_counter()
        self.ev.flush_approaches()
        self.ev.timings["aff_flush_s"] += time.perf_counter() - t0
        self._pd_actions = [None] * self.k
        for i, job in enumerate(self.jobs):
            if job is None or job.approach is None:
                continue
            robot = np.asarray(self.obs[i]["robot_obs"], np.float64)
            a = job.approach.action(robot[:3], robot[3:6])
            if a is None:
                job.approach = None
                self.agent.reset_env_slot(i)
            else:
                self._pd_actions[i] = a
        t0 = time.perf_counter()
        stacked = type(self.farm).stack_obs(self.obs)
        self.pending = _AsyncFetch(self.agent.step_async(stacked, {"lang": self.goals}))
        self.ev.timings["dispatch_submit_s"] += time.perf_counter() - t0
        self.ev.n_dispatches += 1

    def settle(self):
        """Wait for the in-flight step, step the host sims, and advance the
        per-env job bookkeeping. Returns the number of env steps taken."""
        t0 = time.perf_counter()
        actions = self.pending.get()
        self.ev.timings["fetch_wait_s"] += time.perf_counter() - t0
        self.pending = None
        if actions.ndim == 1:
            actions = actions[None]
        acts: List = list(actions)
        for i, pd in enumerate(self._pd_actions):
            if pd is not None and self.jobs[i] is not None:
                acts[i] = pd
                self.ev.n_approach_steps += 1
                self.jobs[i].approach_steps += 1
        t0 = time.perf_counter()
        obs_list, infos = self.farm.step_all(acts)
        self.ev.timings["sim_step_s"] += time.perf_counter() - t0
        self.obs = list(obs_list)
        oracle = self.ev.oracle
        for i in range(self.k):
            job = self.jobs[i]
            if job is None or job.done:
                continue
            if self._pd_actions[i] is None:
                # approach steps do not use the policy's step budget
                job.steps_left -= 1
            subtask = job.chain[job.subtask_idx]
            hit = subtask in oracle.get_task_info_for_set(job.start_info, infos[i], [subtask])
            advance_chain = False
            if hit:
                self.ev.record_subtask(job, subtask, True)
                job.result += 1
                job.subtask_idx += 1
                if job.subtask_idx >= len(job.chain):
                    advance_chain = True
                else:
                    self.begin_subtask(i, job)
                    self.goals[i] = self.ev.goal_for(job.chain[job.subtask_idx], job.job_idx)
            elif job.steps_left <= 0:
                self.ev.record_subtask(job, subtask, False)
                advance_chain = True
            if advance_chain:
                self.ev.finish_job(job)
                self.assign(i)
        return self.k


class PipelinedEvaluator:
    """Evaluate a shared chain queue over C cohorts of lockstep envs.

    ``cohorts`` is a list of (farm, agent) pairs; the agents should share one
    fused step function (``fused_step=`` of ``Hulc2Agent``).
    ``lang_embeddings`` maps each task to its goal: BPE token ids for a policy
    with the text tower, or a sentence embedding. ``affordance`` (an
    ``AffordancePredictor``) turns on the hierarchical mode, with
    ``aff_lang_embeddings`` mapping each task to the detector's token ids.
    ``lang_variants`` and ``aff_lang_variants`` (the paraphrase protocol) map
    each task to a list of goals: chain ``job_idx`` gets variant ``job_idx %
    n_variants`` for every subtask, so each held-out sentence is used by an
    equal share of the chains.
    """

    def __init__(
        self,
        cohorts: Sequence[Tuple[object, object]],
        lang_embeddings: Dict[str, np.ndarray],
        ep_len: int = 360,
        oracle: Optional[SceneObsTaskOracle] = None,
        affordance=None,
        aff_lang_embeddings: Optional[Dict[str, np.ndarray]] = None,
        lang_variants: Optional[Dict[str, Sequence[np.ndarray]]] = None,
        aff_lang_variants: Optional[Dict[str, Sequence[np.ndarray]]] = None,
    ):
        self.ep_len = ep_len
        self.oracle = oracle or SceneObsTaskOracle()
        self.lang = lang_embeddings
        self.lang_variants = lang_variants
        self.aff_lang_variants = aff_lang_variants
        sample_goal = np.asarray(next(iter(lang_embeddings.values())))
        self.goal_dim = int(sample_goal.shape[-1])
        self.goal_dtype = sample_goal.dtype
        self.affordance = affordance
        self.aff_lang = aff_lang_embeddings or {}
        self.n_aff_predictions = 0
        self.n_approaches = 0
        self.n_approach_steps = 0
        self._aff_pending: List[tuple] = []
        self._cam_cache: Dict[int, PinholeCamera] = {}
        self.cohorts = [_Cohort(farm, agent, self) for farm, agent in cohorts]
        # shared job queue state (set per evaluate() call)
        self.sequences: Sequence = []
        self._next_job = 0
        self._results: List[int] = []
        self._completed = 0
        self._done_idx: List[int] = []
        # per-subtask outcome records, the host-time split of the run (summed
        # over cohorts), the count of policy steps submitted, and the
        # throughput per window of completed chains
        self.subtask_records: List[dict] = []
        self.timings: Dict[str, float] = {
            "fetch_wait_s": 0.0, "sim_step_s": 0.0, "aff_flush_s": 0.0, "dispatch_submit_s": 0.0,
        }
        self.n_dispatches = 0
        self.throughput_curve: List[dict] = []
        # optional crash/cutoff insurance: when set, each curve point dumps
        # the completed chains so far
        self.partial_path: Optional[Path] = None

    def _dump_partial(self, n_jobs: int, elapsed_s: float, n_steps: int) -> None:
        """Replace ``partial_path`` with the summary of the chains completed so
        far: written to a temporary file beside it, then renamed over it, so
        a reader never sees a half-written file. A chain's completion time
        correlates with its outcome, so early snapshots are biased; the bias
        vanishes as completed_chains approaches total_chains."""
        done = [self._results[i] for i in self._done_idx]
        tmp = self.partial_path.with_name(f"{self.partial_path.name}.tmp{os.getpid()}")
        tmp.write_text(json.dumps({
            "completed_chains": len(done),
            "total_chains": n_jobs,
            "avg_seq_len_partial": round(float(np.mean(done)), 4) if done else None,
            "chain_sr_partial": count_success(done) if done else None,
            "elapsed_s": round(elapsed_s, 1),
            "env_steps_per_s": round(n_steps / max(elapsed_s, 1e-9), 1),
        }))
        os.replace(tmp, self.partial_path)

    # ---- shared queue ------------------------------------------------- #
    def take_job(self) -> Optional[int]:
        if self._next_job >= len(self.sequences):
            return None
        idx = self._next_job
        self._next_job += 1
        return idx

    def finish_job(self, job: _EnvJob):
        self._results[job.job_idx] = job.result
        job.done = True
        self._completed += 1
        self._done_idx.append(job.job_idx)

    def record_subtask(self, job: _EnvJob, subtask: str, success: bool) -> None:
        self.subtask_records.append({
            "chain": job.job_idx,
            "pos": job.subtask_idx,
            "task": subtask,
            "success": bool(success),
            "policy_steps": int(self.ep_len - job.steps_left),
            "approach_steps": int(job.approach_steps),
        })

    def goal_for(self, subtask: str, job_idx: int = 0) -> np.ndarray:
        if self.lang_variants:
            v = self.lang_variants[subtask]
            return np.asarray(v[job_idx % len(v)], self.goal_dtype)
        return np.asarray(self.lang[subtask], self.goal_dtype)

    def aff_goal_for(self, subtask: str, job_idx: int = 0) -> np.ndarray:
        if self.aff_lang_variants:
            v = self.aff_lang_variants[subtask]
            return np.asarray(v[job_idx % len(v)])
        return np.asarray(self.aff_lang[subtask])

    # ---- hierarchical (affordance) mode -------------------------------- #
    def _camera(self, env) -> PinholeCamera:
        """The env's static camera, cached per env."""
        cam = self._cam_cache.get(id(env))
        if cam is None:
            cam = self._cam_cache[id(env)] = PinholeCamera(**env.get_camera_params())
        return cam

    def queue_approach(self, env, obs, job: _EnvJob, subtask: str) -> None:
        """Queue an affordance query for ``job``'s new subtask; answered by
        ``flush_approaches`` before the next dispatch."""
        if self.affordance is None:
            return
        self._aff_pending.append((env, self._ensure_frames(env, obs), job, subtask))

    def _ensure_frames(self, env, obs: Dict) -> Dict:
        """``obs`` with its static RGB and depth frames. A state-only env (the
        device-render path) has none, so they are rendered here on the host,
        at subtask starts only."""
        if obs.get("rgb_obs"):
            return obs
        boxes, n_static = scene_boxes(obs["scene_obs"], obs["robot_obs"])
        rgb, depth = render(self._camera(env), boxes, n_static=n_static, cache_key="static")
        return {**obs, "rgb_obs": {"rgb_static": rgb}, "depth_obs": {"depth_static": depth}}

    def flush_approaches(self) -> None:
        """Answer every queued affordance query with one batched prediction."""
        if not self._aff_pending:
            return
        reqs, self._aff_pending = self._aff_pending, []
        preds = self.affordance.predict_batch([obs["rgb_obs"]["rgb_static"] for _, obs, _, _ in reqs],
                                              [self.aff_goal_for(t, job.job_idx)
                                               for _, _, job, t in reqs])
        self.n_aff_predictions += len(reqs)
        for (env, obs, job, _), pred in zip(reqs, preds):
            job.approach = self._approach_from_pred(env, obs, pred)

    def make_approach(self, env, obs, subtask: str, job_idx: int = 0) -> Optional[ApproachController]:
        """One env's query, unbatched: predict, deproject, and the approach, or
        None when no approach is needed."""
        if self.affordance is None:
            return None
        obs = self._ensure_frames(env, obs)
        pred = self.affordance.predict(obs["rgb_obs"]["rgb_static"],
                                       self.aff_goal_for(subtask, job_idx))
        self.n_aff_predictions += 1
        return self._approach_from_pred(env, obs, pred)

    def _approach_from_pred(self, env, obs, pred: Dict) -> Optional[ApproachController]:
        """The approach to the predicted pixel's world point (the predicted
        depth, else the frame's depth map), or None when the pixel is within
        ``MOVE_THRESHOLD_PX`` of the TCP's."""
        cam = self._camera(env)
        if "depth" in pred:
            target = cam.deproject_single_depth(pred["pixel"], pred["depth"])
        else:
            target = cam.deproject(pred["pixel"], obs["depth_obs"]["depth_static"])
        tcp_pos = np.asarray(obs["robot_obs"][:3], np.float64)
        tcp_px = cam.project(np.append(tcp_pos, 1.0))
        if np.linalg.norm(np.asarray(pred["pixel"], np.float64) - tcp_px) <= MOVE_THRESHOLD_PX:
            return None
        self.n_approaches += 1
        return ApproachController(tcp_pos, np.asarray(target) + APPROACH_OFFSET, gripper_action=1.0)

    # ---- main loop ----------------------------------------------------- #
    def evaluate(self, num_sequences: int = 1000, sequences=None, progress: bool = True) -> List[int]:
        self.sequences = sequences if sequences is not None else get_sequences(num_sequences)
        n_jobs = len(self.sequences)
        self._results = [0] * n_jobs
        self._next_job = 0
        self._completed = 0
        self._done_idx = []

        for c in self.cohorts:
            for i in range(c.k):
                c.assign(i)
            if c.active:
                c.dispatch()

        t0 = time.time()
        n_steps = 0
        last_log = 0
        curve_every = max(50, n_jobs // 20)
        next_curve = curve_every
        prev_curve = (0, 0.0)  # (n_steps, elapsed) at the last curve point
        while self._completed < n_jobs:
            for c in self.cohorts:
                if c.pending is None:
                    continue
                n_steps += c.settle()
                if c.active:
                    c.dispatch()
            if progress and n_steps - last_log >= 500 * sum(c.k for c in self.cohorts):
                last_log = n_steps
                rate = n_steps / max(time.time() - t0, 1e-9)
                logger.info("[%d/%d chains] %.0f env-steps/s (%d envs, %d cohorts)",
                            self._completed, n_jobs, rate, sum(c.k for c in self.cohorts),
                            len(self.cohorts))
            if self._completed >= next_curve:
                el = time.time() - t0
                self.throughput_curve.append({
                    "chains_done": self._completed,
                    "elapsed_s": round(el, 1),
                    "window_env_steps_per_s": round(
                        (n_steps - prev_curve[0]) / max(el - prev_curve[1], 1e-9), 1),
                })
                prev_curve = (n_steps, el)
                next_curve += curve_every
                if self.partial_path is not None:
                    self._dump_partial(n_jobs, el, n_steps)
        dt = time.time() - t0
        self.total_env_steps = n_steps
        self.wall_clock_s = dt
        if self.partial_path is not None:
            # the last snapshot: a run shorter than one curve window leaves one too
            self._dump_partial(n_jobs, dt, n_steps)
        logger.info("batched eval: %d chains in %.1f s (%.0f env-steps/s)",
                    n_jobs, dt, n_steps / max(dt, 1e-9))
        logger.info("stage timings (s, summed over cohorts): %s",
                    {k: round(v, 1) for k, v in self.timings.items()})
        return list(self._results)


class BatchedEvaluator(PipelinedEvaluator):
    """The single-cohort evaluator: one farm and its agent
    (``hulc2_tpu/evaluation/batched_eval.py:496``)."""

    def __init__(self, farm, agent, lang_embeddings: Dict[str, np.ndarray], ep_len: int = 360,
                 oracle: Optional[SceneObsTaskOracle] = None, **kwargs):
        super().__init__([(farm, agent)], lang_embeddings, ep_len, oracle, **kwargs)
        self.farm = farm
        self.agent = agent
        self.k = len(farm)
