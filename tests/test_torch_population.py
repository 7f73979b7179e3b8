"""The port's population engine (scalable_agent_tpu_torch/population.py)
against the JAX package's: the curriculum's functions at rtol 1e-6, the
sampler's frequencies by a fixed-seed chi-square test (its stream is the
port's own), the host planners and PBT decisions equal to JAX's for the
same seeds, the validators' errors and warnings equal over a table of
configs, and the curriculum's fold in the fused step: one JAX procgen
step with curriculum='regret', replayed through the port's update from
the same batch, level ids and table (rtol 1e-6), and its train step at
the slice bar (loss rtol 2e-4, params rtol 5e-4 / atol 5e-6)."""

import warnings as warnings_lib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import config as jax_config
from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu import population as jax_population
from scalable_agent_tpu.parallel import anakin as jax_anakin
from scalable_agent_tpu_torch import config as port_config
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch import population
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.structs import map_structure

torch.set_num_threads(1)


def _scores(seed, n=8):
  rng = np.random.RandomState(seed)
  scores = rng.rand(n).astype(np.float32) * rng.choice([1e-3, 1.0, 50.0])
  scores[rng.rand(n) < 0.3] = 0.0
  return scores


@pytest.mark.parametrize('seed, temperature, eps', [
    (0, 1.0, 0.1), (1, 0.3, 0.0), (2, 2.5, 0.5), (3, 1.0, 1.0)])
def test_level_probs_and_metrics_match_jax(seed, temperature, eps):
  scores = _scores(seed)
  visits = np.where(np.random.RandomState(seed).rand(8) < 0.5, 0.0,
                    3.0).astype(np.float32)
  np.testing.assert_allclose(
      population.level_probs(torch.from_numpy(scores), temperature,
                             eps).numpy(),
      np.asarray(jax_population.level_probs(scores, temperature, eps)),
      rtol=1e-6)
  got = population.curriculum_metrics(torch.from_numpy(scores),
                                      torch.from_numpy(visits),
                                      temperature, eps)
  want = jax_population.curriculum_metrics(jnp.asarray(scores),
                                           jnp.asarray(visits),
                                           temperature, eps)
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_allclose(float(got[key]), float(want[key]),
                               rtol=1e-6, err_msg=key)
  np.testing.assert_allclose(
      population.level_probs(torch.zeros(4), temperature, eps).numpy(),
      0.25, rtol=1e-6)  # all-zero scores: uniform


@pytest.mark.parametrize('mode', ['regret', 'td'])
def test_score_signal_and_update_match_jax(mode):
  rng = np.random.RandomState(4)
  delta = rng.randn(6, 5).astype(np.float32)
  ids = rng.randint(0, 3, (6, 5)).astype(np.int32)  # levels 3..7 unseen
  scores, visits = _scores(5), rng.rand(8).astype(np.float32)
  np.testing.assert_allclose(
      population.score_signal(torch.from_numpy(delta), mode).numpy(),
      np.asarray(jax_population.score_signal(jnp.asarray(delta), mode)),
      rtol=1e-6)
  signal = population.score_signal(torch.from_numpy(delta), mode)
  got = population.update_scores(torch.from_numpy(scores),
                                 torch.from_numpy(visits),
                                 torch.from_numpy(ids), signal, 0.3, 0.995)
  want = jax_population.update_scores(
      scores, visits, ids, jax_population.score_signal(delta, mode), 0.3,
      0.995)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
  # A group's sum of segment sums and counts is what one rank holding
  # every column computes.
  halves = [population.update_scores(
      torch.from_numpy(scores), torch.from_numpy(visits),
      torch.from_numpy(ids[:, cols]), signal[:, cols], 0.3, 0.995,
      all_reduce=lambda x, cols=cols: x + _totals(ids, signal, other))
      for cols, other in ((slice(0, 2), slice(2, 5)),
                          (slice(2, 5), slice(0, 2)))]
  for scores_k, visits_k in halves:
    np.testing.assert_allclose(scores_k.numpy(), got[0].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(visits_k.numpy(), got[1].numpy())
  with pytest.raises(ValueError, match='unknown curriculum'):
    population.score_signal(torch.zeros(2), 'uniform')


def _totals(ids, signal, cols):
  """The flat [2n] sums and counts of the columns `cols`."""
  totals = torch.zeros((2, 8))
  flat = torch.from_numpy(ids[:, cols]).reshape(-1).long()
  totals[0].index_add_(0, flat, signal[:, cols].reshape(-1))
  totals[1].index_add_(0, flat, torch.ones(flat.shape))
  return totals.reshape(-1)


def test_sample_levels_frequencies_follow_level_probs():
  """200,000 draws from a fixed seed: Pearson's chi-square against
  level_probs, 7 degrees of freedom, below its 0.999 quantile (24.32)."""
  scores = torch.tensor([0.0, 0.2, 1.0, 0.5, 0.0, 3.0, 0.1, 0.7])
  probs = population.level_probs(scores, 0.5, 0.1).double().numpy()
  draws = population.sample_levels(torch.Generator().manual_seed(0),
                                   scores, 200_000, 0.5, 0.1)
  assert draws.dtype == torch.int64
  counts = np.bincount(draws.numpy(), minlength=8)
  expected = probs * draws.numel()
  chi2 = float(np.sum((counts - expected) ** 2 / expected))
  assert chi2 < 24.32, (chi2, counts, expected)


def test_host_planners_equal_jax():
  for spec in ('bandit:2,gridworld:1', 'procgen', ' a:0.5, b , c:3 '):
    assert population.parse_fleet_tasks(spec) == \
        jax_population.parse_fleet_tasks(spec)
  for bad in ('a:0', 'a,a', ':2', 'a:x'):
    with pytest.raises(ValueError) as mine:
      population.parse_fleet_tasks(bad)
    with pytest.raises(ValueError) as ref:
      jax_population.parse_fleet_tasks(bad)
    assert str(mine.value) == str(ref.value)
  for tasks, n in (([('a', 2.0), ('b', 1.0)], 7),
                   ([('a', 1.0), ('b', 1.0), ('c', 5.0)], 3),
                   ([('a', 0.1), ('b', 9.0)], 2), ([('a', 1.0)], 5)):
    assert population.plan_actor_assignment(tasks, n) == \
        jax_population.plan_actor_assignment(tasks, n)
  families = {(72, 96, 3): 30, (24, 32, 3): 70, (84, 84, 1): 5}
  assert population.padding_report(families) == \
      jax_population.padding_report(families)
  assert population.padding_report({}) == jax_population.padding_report({})


@pytest.mark.parametrize('seed', [0, 1, 2, 7])
def test_pbt_decisions_equal_jax(seed):
  """pbt_explore and pbt_decide make JAX's decisions from equal
  np.random.Generator states, over several rounds of one stream."""
  mine_rng, ref_rng = (np.random.default_rng(seed) for _ in range(2))
  hypers = [{'learning_rate': 4.8e-4 * (1 + i), 'entropy_cost': 2.5e-4}
            for i in range(6)]
  groups = ['procgen', 'gridworld', 'procgen', 'gridworld', 'procgen',
            'bandit']
  for r in range(4):
    returns = list(np.random.RandomState(seed * 10 + r).randint(0, 4, 6)
                   .astype(float))
    assert population.pbt_explore(hypers[0], mine_rng, 1.2) == \
        jax_population.pbt_explore(hypers[0], ref_rng, 1.2)
    mine = population.pbt_decide(returns, groups, mine_rng, 0.34, 1.3,
                                 hypers)
    ref = jax_population.pbt_decide(returns, groups, ref_rng, 0.34, 1.3,
                                    hypers)
    assert mine == ref
  assert population.PBT_HYPERS == jax_population.PBT_HYPERS
  assert population.CURRICULUM_MODES == jax_population.CURRICULUM_MODES


# Configs for the validators: (kwargs, expected to raise).
_VALIDATION_TABLE = [
    dict(),
    dict(curriculum='regret'),
    dict(curriculum='regret', env_backend='procgen', runtime='anakin'),
    dict(curriculum='td', env_backend='procgen', unroll_length=1,
         curriculum_eps=0.0),
    dict(curriculum='bogus'),
    dict(curriculum_temperature=0.0),
    dict(curriculum_eps=1.5),
    dict(curriculum_alpha=0.0),
    dict(curriculum_decay=1.5),
    dict(procgen_num_levels=0),
    dict(procgen_wall_density=1.0),
    dict(curriculum='regret', anakin_filler=True, filler_backend='procgen'),
    dict(fleet_tasks='bandit:2,gridworld:1', num_actors=4),
    dict(fleet_tasks='bandit:2,dmlab', num_actors=4),
    dict(fleet_tasks='cue_memory,gridworld', num_actors=4),
    dict(fleet_tasks='a,b,c', num_actors=2),
    dict(fleet_tasks='bandit,gridworld', runtime='anakin',
         env_backend='bandit'),
    dict(pbt_population=-1),
    dict(pbt_round_frames=-1),
    dict(pbt_quantile=0.6),
    dict(pbt_perturb=1.0),
    dict(pbt_population=1),
    dict(pbt_vectorized=True),
    dict(pbt_population=2),
    dict(pbt_population=2, runtime='anakin', env_backend='procgen'),
    dict(pbt_population=3, runtime='anakin', pbt_suites='procgen,gridworld'),
    dict(pbt_population=2, runtime='anakin', pbt_suites='dmlab'),
    dict(pbt_population=2, runtime='anakin',
         pbt_suites='cue_memory,procgen'),
    dict(pbt_population=4, runtime='anakin', pbt_suites='procgen,gridworld',
         pbt_vectorized=True),
    dict(pbt_population=4, runtime='anakin', env_backend='procgen',
         pbt_vectorized=True, model_parallelism=2),
    dict(pbt_population=2, runtime='anakin', pbt_suites='a,b,c'),
    # The runtime axis and the filler.
    dict(runtime='bogus'),
    dict(filler_batch_size=-1),
    dict(filler_unroll_length=-1),
    dict(runtime='anakin', env_backend='dmlab'),
    dict(runtime='anakin', env_backend='bandit', anakin_filler=True),
    dict(filler_backend='gridworld'),
    dict(anakin_filler=True),
    dict(anakin_filler=True, surrogate='impact'),
    dict(anakin_filler=True, filler_backend='dmlab'),
    dict(anakin_filler=True, env_backend='procgen', surrogate='impact'),
]


def _outcome(validate, config_cls, kw):
  try:
    return ('ok', validate(config_cls(**kw)))
  except ValueError as e:
    return ('raises', str(e))


@pytest.mark.parametrize('kw', _VALIDATION_TABLE)
def test_validators_equal_jax(kw):
  """validate_population and validate_runtime raise JAX's errors and warn
  JAX's warnings. (JAX's runtime warning for the filler with its SLO
  engine off has no port counterpart: the table keeps the engine on, its
  default.)"""
  for name in ('validate_population', 'validate_runtime'):
    mine = _outcome(getattr(port_config, name), port_config.Config, kw)
    ref = _outcome(getattr(jax_config, name), jax_config.Config, kw)
    assert mine == ref, name
  # The resolved fields the validators read.
  config, ref = port_config.Config(**kw), jax_config.Config(**kw)
  for prop in ('resolved_filler_backend', 'resolved_filler_batch_size',
               'resolved_filler_unroll_length', 'resolved_pbt_suites',
               'resolved_pbt_round_frames'):
    assert getattr(config, prop) == getattr(ref, prop), prop


def test_multi_process_filler_warning_equal_jax():
  kw = dict(anakin_filler=True, coordinator_address='localhost:1234',
            num_processes=2, process_id=0)
  mine = port_config.validate_distributed(port_config.Config(**kw))
  with warnings_lib.catch_warnings():
    warnings_lib.simplefilter('ignore')
    ref = jax_config.validate_distributed(jax_config.Config(**kw))
  filler = [w for w in ref if 'anakin_filler' in w]
  assert filler and all(w in mine for w in filler)


def _port_state(agent, jax_state):
  """The port's TrainState holding a JAX TrainState's optimizer state."""
  rms, schedule, _ = jax_state.opt_state
  nu = convert.params_from_jax(rms.nu)
  del nu['core.bias_ih']  # a buffer in the port, not a parameter
  return learner.TrainState(
      params=dict(agent.named_parameters()),
      opt_state=learner.RMSPropState(
          count=torch.tensor(int(schedule.count), dtype=torch.int32),
          nu=nu),
      update_steps=int(jax_state.update_steps))


def test_curriculum_fold_matches_one_jax_fused_step():
  """One JAX fused procgen step with curriculum='regret' (T=5, B=4,
  24x32) after a first one (nonzero scores): the port's score update from
  JAX's batch, pre-step level ids (replayed through JAX's core from its
  state) and table gives JAX's level_scores, level_visits and
  curriculum_* metrics at rtol 1e-6; the port's train step on the batch
  gives JAX's loss (rtol 2e-4) and params (rtol 5e-4 / atol 5e-6)."""
  kw = dict(env_backend='procgen', curriculum='regret', batch_size=4,
            unroll_length=5, num_action_repeats=1, episode_length=6,
            height=24, width=32, torso='shallow', use_instruction=False,
            discounting=0.9, learning_rate=2e-3, entropy_cost=3e-3,
            total_environment_frames=10**6, seed=0)
  jcfg, cfg = jax_config.Config(**kw), port_config.Config(**kw)
  jcore = jax_anakin.make_env_core(jcfg)
  jagent = jax_driver.build_agent(jcfg, jcore.num_actions)
  jstep = jax_anakin.make_anakin_step(jagent, jcore, jcfg,
                                      return_batch=True)
  jcarry = jax_anakin.init_carry(jagent, jcore, jcfg, jax.random.PRNGKey(0))
  jcarry, _ = jstep(jcarry)
  pre_env = jax.device_get(jcarry.env_state)
  pre_state = jax.device_get(jcarry.train_state)
  jcarry, jm = jstep(jcarry)
  jm = jax.device_get(jm)
  post_env = jax.device_get(jcarry.env_state)
  assert np.asarray(pre_env.level_scores).any()

  # The pre-step level of each transition, replayed through JAX's core.
  actions = np.asarray(jm['batch'].agent_outputs.action)
  env_state, level_ids = pre_env, []
  for t in range(1, cfg.unroll_length + 1):
    level_ids.append(torch.from_numpy(np.array(env_state.level_id)).long())
    env_state, _ = jcore.step(env_state, jnp.asarray(actions[t]))

  batch = map_structure(lambda x: torch.from_numpy(np.array(x)),
                        jm['batch'])
  port_env = anakin.make_env_core(cfg).init(
      torch.Generator().manual_seed(0), 4)[0]._replace(
          level_scores=torch.from_numpy(np.array(pre_env.level_scores)),
          level_visits=torch.from_numpy(np.array(pre_env.level_visits)))
  env_out, metrics = anakin._curriculum_update(cfg, batch, port_env,
                                                level_ids)
  np.testing.assert_allclose(env_out.level_scores.numpy(),
                             np.asarray(post_env.level_scores), rtol=1e-6)
  np.testing.assert_array_equal(env_out.level_visits.numpy(),
                                np.asarray(post_env.level_visits))
  assert set(metrics) == {k for k in jm if k.startswith('curriculum_')}
  for key, value in metrics.items():
    np.testing.assert_allclose(float(value), float(jm[key]), rtol=1e-6,
                               err_msg=key)

  agent = ImpalaAgent(jcore.num_actions, (24, 32, 3), torso='shallow')
  agent.load_state_dict(convert.params_from_jax(pre_state.params))
  state, m = learner.make_train_step_fn(agent, cfg)(
      _port_state(agent, pre_state), batch)
  np.testing.assert_allclose(float(m['total_loss']),
                             float(jm['total_loss']), rtol=2e-4)
  ref = convert.params_from_jax(jax.device_get(jcarry.train_state.params))
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=k)
