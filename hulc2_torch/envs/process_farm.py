"""Multiprocess env farm: N simulator instances stepping in parallel.

The port's copy of ``hulc2_tpu/envs/process_farm.py:49-224`` (numpy only).
The in-process ``EnvFarm`` steps its envs one after another; a PyBullet
CALVIN instance costs 10-20 ms a step (physics and the camera render), so
64 of them would take about a second per lockstep round while the card
waits. Here each env lives in its own worker process (the reference gets
simulator parallelism only across eval jobs: reference:
hulc2/evaluation/run_multiple.py:24-43). ``step_all`` and ``reset_all``
send a command to every worker before collecting any result, so the N
simulators advance together on N host cores while the policy runs on the
card.

Workers are fresh interpreters started with fork and exec (``subprocess``),
not ``multiprocessing`` children: a plain fork is unsafe once the parent has
started threads (the CUDA runtime's, the loader's), and spawn and forkserver
re-import the parent's ``__main__`` in every child. Each worker runs
``python -m hulc2_torch.envs.process_farm``, which imports numpy and the env
modules only, never torch, with ``CUDA_VISIBLE_DEVICES`` empty, so it can
never reach the card. It connects back over a Unix socket, receives its
pickled env factory (a top-level callable with its arguments, e.g.
``partial(make_wrapped_calvin_env, dataset_path)``), reports what it can see
(``worker_info``) and serves (method, args, kwargs) calls. A worker that
fails to build its env raises in the parent.
"""
from __future__ import annotations

import os
import secrets
import shutil
import subprocess
import sys
import tempfile
from multiprocessing.connection import Client, Listener
from typing import Callable, Dict, List, Sequence

import numpy as np

from hulc2_torch.envs.calvin_wrapper import EnvFarm

_CLOSE = "__close__"
_ADDR_ENV = "HULC2_ENV_WORKER_ADDR"
_KEY_ENV = "HULC2_ENV_WORKER_KEY"


def _worker_main() -> None:
    """A worker interpreter's entry point (``-m``): connect back to the farm,
    build the env from the pickled factory, serve calls."""
    addr = os.environ[_ADDR_ENV]
    key = bytes.fromhex(os.environ[_KEY_ENV])
    conn = Client(addr, family="AF_UNIX", authkey=key)
    try:
        factory = conn.recv()
        try:
            env = factory()
        except Exception as e:  # noqa: BLE001 — reported to the parent
            conn.send(("error", repr(e)))
            return
        conn.send(("ok", {"pid": os.getpid(),
                          "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                          "torch_imported": "torch" in sys.modules}))
        while True:
            try:
                method, args, kwargs = conn.recv()
            except EOFError:
                break
            if method == _CLOSE:
                conn.send(("ok", None))
                break
            try:
                conn.send(("ok", getattr(env, method)(*args, **kwargs)))
            except Exception as e:  # noqa: BLE001 — raised in the parent
                conn.send(("error", repr(e)))
    finally:
        conn.close()


class RemoteEnv:
    """Proxy of one env in a worker process. Sending and receiving are split,
    so that the farm can send a command to every worker before it collects
    any result."""

    def __init__(self, factory: Callable, tmpdir: str):
        addr = os.path.join(tmpdir, f"env_{secrets.token_hex(4)}.sock")
        key = secrets.token_bytes(16)
        listener = Listener(addr, family="AF_UNIX", authkey=key)
        env = dict(os.environ, **{_ADDR_ENV: addr, _KEY_ENV: key.hex()})
        env["CUDA_VISIBLE_DEVICES"] = ""  # a worker never reaches the card
        import hulc2_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(hulc2_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen([sys.executable, "-m", "hulc2_torch.envs.process_farm"],
                                      env=env)
        try:
            self._conn = listener.accept()
        finally:
            listener.close()
        self._conn.send(factory)
        status, info = self._conn.recv()
        if status != "ok":
            self._proc.wait()
            self._conn.close()
            raise RuntimeError(f"env worker failed to construct env: {info}")
        self.worker_info: Dict = info

    def call_async(self, method: str, *args, **kwargs) -> None:
        self._conn.send((method, args, kwargs))

    def call_wait(self):
        status, result = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"env worker error: {result}")
        return result

    def call(self, method: str, *args, **kwargs):
        self.call_async(method, *args, **kwargs)
        return self.call_wait()

    # the env's surface, as synchronous calls, for the per-env code paths
    def reset(self, **kwargs):
        return self.call("reset", **kwargs)

    def step(self, action):
        return self.call("step", action)

    def get_obs(self):
        return self.call("get_obs")

    def get_info(self):
        return self.call("get_info")

    def get_camera_params(self):
        return self.call("get_camera_params")

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self.call(_CLOSE)
            except (RuntimeError, EOFError, BrokenPipeError, OSError):
                pass
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                # a worker stuck in native simulator code: SIGTERM, then
                # SIGKILL; always reaped, so that the socket dir can go
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
        self._conn.close()


class ProcessEnvFarm:
    """An ``EnvFarm`` whose envs live in worker processes and step in
    parallel. ``factories`` holds one picklable zero-argument callable per
    env."""

    def __init__(self, factories: Sequence[Callable]):
        self._tmpdir = tempfile.mkdtemp(prefix="hulc2_envfarm_")
        self.envs: List[RemoteEnv] = []
        try:
            for f in factories:
                self.envs.append(RemoteEnv(f, self._tmpdir))
        except BaseException:
            self.close()
            raise

    def __len__(self):
        return len(self.envs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def worker_info(self) -> List[Dict]:
        """Each worker's pid, ``CUDA_VISIBLE_DEVICES`` and whether torch was
        imported there, as it reported them after building its env."""
        return [e.worker_info for e in self.envs]

    def step_all(self, actions: np.ndarray):
        """Step every env concurrently; returns (obs_list, infos)."""
        for e, a in zip(self.envs, actions):
            e.call_async("step", a)
        obs_list, infos = [], []
        for e in self.envs:
            o, _, _, info = e.call_wait()
            obs_list.append(o)
            infos.append(info)
        return obs_list, infos

    def step(self, actions: np.ndarray):
        """``EnvFarm.step``: the stacked obs, rewards, dones and infos."""
        obs_list, infos = self.step_all(actions)
        return (self.stack_obs(obs_list), np.zeros(len(self.envs)),
                np.zeros(len(self.envs), bool), infos)

    def reset_all(self, robot_obs=None, scene_obs=None) -> List[Dict]:
        for i, e in enumerate(self.envs):
            e.call_async("reset",
                         robot_obs=None if robot_obs is None else robot_obs[i],
                         scene_obs=None if scene_obs is None else scene_obs[i])
        return [e.call_wait() for e in self.envs]

    def reset(self, robot_obs=None, scene_obs=None):
        return self.stack_obs(self.reset_all(robot_obs, scene_obs))

    def get_obs(self):
        for e in self.envs:
            e.call_async("get_obs")
        return self.stack_obs([e.call_wait() for e in self.envs])

    def get_infos(self) -> List[Dict]:
        for e in self.envs:
            e.call_async("get_info")
        return [e.call_wait() for e in self.envs]

    stack_obs = staticmethod(EnvFarm.stack_obs)

    def close(self) -> None:
        for e in self.envs:
            e.close()
        shutil.rmtree(self._tmpdir, ignore_errors=True)


if __name__ == "__main__":
    _worker_main()
