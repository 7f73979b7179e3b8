"""Host-side actor: rolls an environment into learner-ready unrolls,
ported from the JAX package's runtime/actor.py.

Semantics kept from the reference:
- persistent cross-unroll state (env output, agent output, LSTM carry);
- the 1-frame overlap: each `ActorOutput` has T+1 timesteps, timestep 0
  being the previous unroll's last (env_output, agent_output);
- `agent_state` in the output is the LSTM carry at the *start* of the
  unroll;
- episode statistics flow *through* the trajectory as `StepOutputInfo`:
  the output at a done step carries the finished episode's stats while
  the carried state resets to zero.

Everything here is host numpy; the policy (runtime/inference.py
`InferenceServer.policy` in the fleet) is where the device comes in. The
policy state is the numeric carry, or in the server's state-cache mode
an opaque slot handle (`snapshot`, `write`, `release`): the actor reads
its carry once per unroll, at the start, and releases the slot on exit.
"""

import time
from typing import Callable, Optional

import numpy as np

from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

# run_actor_loop's put polls: each timeout re-checks the stop event, so
# a stopping fleet can join producers parked on a full buffer.
_PUT_POLL_SECS = 0.5
# After stop is requested, how long a parked producer keeps trying to
# land its completed unroll before dropping it and exiting.
_STOP_PUT_GRACE_SECS = 5.0


def _stack(items, axis=0, empty=None):
  """Stack a list of like-structured nests of numpy arrays along `axis`;
  `empty(shape, dtype)` allocates each result (np.empty by default)."""
  def stack(*xs):
    xs = [np.asarray(x) for x in xs]
    shape = list(xs[0].shape)
    shape.insert(axis if axis >= 0 else len(shape) + 1 + axis, len(xs))
    out = (empty or np.empty)(tuple(shape), xs[0].dtype)
    return np.stack(xs, axis=axis, out=out)
  return map_structure(stack, *items)


class Actor:
  """One environment and its rollout state.

  Args:
    env: an `envs.base.Environment`.
    policy: `(prev_action i32[], env_output StepOutput of scalars,
      core_state) -> (AgentOutput of scalars, new_core_state)`.
    initial_core_state: zeroed LSTM carry (c, h) for one env, [1, hidden]
      each, or the server's state-arena slot handle.
    unroll_length: T (the output carries T+1 with the overlap frame).
    num_action_repeats: frames per env step, for episode_step accounting.
    level_name_id: int id of the level (strings do not enter
      trajectories).
  """

  def __init__(self, env, policy: Callable, initial_core_state,
               unroll_length: int, num_action_repeats: int = 1,
               level_name_id: int = 0):
    self._env = env
    self._policy = policy
    self._unroll_length = unroll_length
    self._num_action_repeats = num_action_repeats
    self._level_name_id = np.int32(level_name_id)

    observation = env.initial()
    self._env_output = StepOutput(
        reward=np.float32(0.0),
        info=StepOutputInfo(np.float32(0.0), np.int32(0)),
        done=np.bool_(True),  # the first observation starts an episode
        observation=observation)
    self._core_state = initial_core_state
    self._agent_output: Optional[AgentOutput] = None
    self._episode_return = np.float32(0.0)
    self._episode_step = np.int32(0)

  def unroll(self) -> ActorOutput:
    """One ActorOutput of [T+1] time-major numpy arrays."""
    core0 = self._core_state
    # A slot handle's carry lives on the device: read it once here (the
    # learner's unroll-start state).
    initial_core_state = (core0.snapshot() if hasattr(core0, 'snapshot')
                          else core0)
    env_outputs = [self._env_output]
    if self._agent_output is None:
      # Prime lazily, so the first policy call tells num_actions; its new
      # carry is discarded (on the device: written back).
      out, _ = self._policy(np.int32(0), self._env_output,
                            self._core_state)
      if hasattr(core0, 'write'):
        core0.write(initial_core_state)
      self._agent_output = AgentOutput(
          action=np.int32(0),
          policy_logits=np.zeros_like(np.asarray(out.policy_logits)),
          baseline=np.float32(0.0))
    agent_outputs = [self._agent_output]

    for _ in range(self._unroll_length):
      agent_output, core_state = self._policy(
          self._agent_output.action, self._env_output, self._core_state)
      agent_output = AgentOutput(*[np.asarray(x) for x in agent_output])
      reward, done, observation = self._env.step(int(agent_output.action))

      self._episode_return = np.float32(self._episode_return + reward)
      self._episode_step = np.int32(
          self._episode_step + self._num_action_repeats)
      info = StepOutputInfo(self._episode_return, self._episode_step)
      if done:
        self._episode_return = np.float32(0.0)
        self._episode_step = np.int32(0)

      env_output = StepOutput(np.float32(reward), info, np.bool_(done),
                              observation)
      env_outputs.append(env_output)
      agent_outputs.append(agent_output)
      self._env_output = env_output
      self._agent_output = agent_output
      self._core_state = core_state

    return ActorOutput(
        level_name=self._level_name_id,
        agent_state=initial_core_state,
        env_outputs=_stack(env_outputs),
        agent_outputs=_stack(agent_outputs))

  def release_policy_state(self):
    """Return a state-arena slot to its server (a no-op for a numeric
    carry). Idempotent: close() calls it, and the fleet's respawn too."""
    if hasattr(self._core_state, 'release'):
      try:
        self._core_state.release()
      except Exception:
        pass

  def close(self):
    self.release_policy_state()
    self._env.close()


def run_actor_loop(actor: Actor, buffer, stop_event,
                   on_unroll: Optional[Callable[[], bool]] = None,
                   on_failure: Optional[Callable] = None) -> None:
  """Produce unrolls into `buffer` until stopped (a thread's target).

  - Clean shutdown: a closed buffer or a cancelled inference call while
    `stop_event` is set ends the loop quietly.
  - Failure (those while not stopping, or anything else): by default the
    buffer is closed, so the learner's next get raises instead of
    hanging, and the exception is raised on this thread;
    `on_failure(exc)` replaces that (the fleet records it on its slot).

  `on_unroll()` runs after each put; returning False ends the loop. The
  actor is closed on every exit.
  """
  from scalable_agent_tpu_torch.ops.dynamic_batching import BatcherCancelled
  from scalable_agent_tpu_torch.runtime import ring_buffer

  def fail(exc):
    if on_failure is None:
      buffer.close()
      raise exc
    on_failure(exc)

  try:
    while not stop_event.is_set():
      unroll = actor.unroll()
      stop_deadline = None
      while True:
        try:
          buffer.put(unroll, timeout=_PUT_POLL_SECS)
          break
        except TimeoutError:
          if not stop_event.is_set():
            continue
          if stop_deadline is None:
            stop_deadline = time.monotonic() + _STOP_PUT_GRACE_SECS
          elif time.monotonic() > stop_deadline:
            return  # stopping and nobody drains: drop and exit
      if on_unroll is not None and not on_unroll():
        return
  except (ring_buffer.Closed, BatcherCancelled) as e:
    if not stop_event.is_set():
      fail(e)
  except BaseException as e:
    fail(e)
  finally:
    try:
      actor.close()
    except Exception:
      pass


def batch_unrolls(unrolls, empty=None):
  """Stack B ActorOutputs into a learner batch: time-major [T+1, B] for
  the trajectory, [B, ...] for level_name and agent_state. `empty(shape,
  dtype)` allocates each stacked array (the driver passes pinned host
  memory on CUDA); np.empty by default."""
  env_outputs = _stack([u.env_outputs for u in unrolls], 1, empty)
  agent_outputs = _stack([u.agent_outputs for u in unrolls], 1, empty)
  level = _stack([u.level_name for u in unrolls], 0, empty)
  # Each actor's carry is [1, hidden]: concatenated, the learner's
  # [B, hidden].
  agent_state = map_structure(
      lambda *xs: _stack([x[0] for x in xs], 0, empty),
      *[u.agent_state for u in unrolls])
  return ActorOutput(level, agent_state, env_outputs, agent_outputs)
