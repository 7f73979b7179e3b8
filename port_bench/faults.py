"""Faults planted in the port under the timed path, to show that the
comparison fails them (tests/ and calibrate.py; never in a benchmark
run). Each is a context manager that patches a module attribute of the
port and restores it.

- unchanged_state: the train step computes its gradients and returns the
  state it was given (parameters and optimizer state unmoved).
- half_batch: the learner leaves out half the batch's columns and takes
  the rest twice (the losses are sums, so twice the half stands in for
  the mean over the rest).
- altered_action: the acting step's action is the policy's argmax where
  it should be a draw from it.
- reset_nu: each step's RMSProp starts from a zero second moment, as if
  the optimizer's state were not carried from step to step.
- zeroed_carry: the learner unrolls each batch from a zero LSTM state
  where it should start from the state the actor carried into it.
"""

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
  saved = getattr(module, name)
  setattr(module, name, value)
  try:
    yield
  finally:
    setattr(module, name, saved)


def unchanged_state():
  from scalable_agent_tpu_torch import learner

  def apply_gradients(state, grads, metrics, config, schedule, **kwargs):
    metrics['grad_norm'] = learner.global_norm(grads)
    metrics['learning_rate'] = schedule(state.update_steps)
    metrics['step_ok'] = torch.ones_like(metrics['total_loss'])
    return state._replace(update_steps=state.update_steps + 1), metrics

  return _patched(learner, 'apply_gradients', apply_gradients)


def half_batch():
  from scalable_agent_tpu_torch import learner
  from scalable_agent_tpu_torch.structs import ActorOutput, map_structure
  loss_fn = learner.loss_fn

  def half(batch, **kwargs):
    b = batch.env_outputs.reward.shape[1] // 2
    batch = ActorOutput(
        level_name=None if batch.level_name is None
        else batch.level_name[:b],
        agent_state=map_structure(lambda x: x[:b], batch.agent_state),
        env_outputs=map_structure(lambda x: x[:, :b], batch.env_outputs),
        agent_outputs=map_structure(lambda x: x[:, :b], batch.agent_outputs))
    return batch

  def halved(agent, batch, config, **kwargs):
    total, metrics, aux = loss_fn(agent, half(batch), config, **kwargs)
    metrics = {k: 2 * v if k in learner.SUMMED_KEYS else v
               for k, v in metrics.items()}
    return 2 * total, metrics, aux

  return _patched(learner, 'loss_fn', halved)


def altered_action():
  from scalable_agent_tpu_torch.parallel import anakin
  make_step_fn = anakin.make_step_fn

  def greedy_step_fn(agent, **kwargs):
    step = make_step_fn(agent, **kwargs)

    def act(generator, prev_action, env_output, core_state):
      out, state = step(generator, prev_action, env_output, core_state)
      return out._replace(action=out.policy_logits.argmax(dim=-1)), state

    return act

  return _patched(anakin, 'make_step_fn', greedy_step_fn)


def reset_nu():
  from scalable_agent_tpu_torch import learner
  apply_gradients = learner.apply_gradients

  def fresh(state, grads, metrics, config, schedule, **kwargs):
    nu = {k: torch.zeros_like(v) for k, v in state.opt_state.nu.items()}
    state = state._replace(opt_state=state.opt_state._replace(nu=nu))
    return apply_gradients(state, grads, metrics, config, schedule, **kwargs)

  return _patched(learner, 'apply_gradients', fresh)


def zeroed_carry():
  from scalable_agent_tpu_torch import learner
  from scalable_agent_tpu_torch.structs import map_structure
  loss_fn = learner.loss_fn

  def zeroed(agent, batch, config, **kwargs):
    batch = batch._replace(
        agent_state=map_structure(torch.zeros_like, batch.agent_state))
    return loss_fn(agent, batch, config, **kwargs)

  return _patched(learner, 'loss_fn', zeroed)


FAULTS = {'unchanged_state': unchanged_state, 'half_batch': half_batch,
          'altered_action': altered_action, 'reset_nu': reset_nu,
          'zeroed_carry': zeroed_carry}
