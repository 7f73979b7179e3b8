"""The port's Config keeps the JAX package's field names and defaults:
every field of `scalable_agent_tpu_torch.config.Config` exists in
`scalable_agent_tpu.config.Config` with the same default, so a config
carries across the two packages unchanged."""

import dataclasses

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu_torch.config import Config


def _defaults(cls):
  return {f.name: (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
          for f in dataclasses.fields(cls)}


def test_every_port_field_has_the_jax_default():
  port, ref = _defaults(Config), _defaults(JaxConfig)
  assert not sorted(set(port) - set(ref))
  differ = {k: (v, ref[k]) for k, v in port.items() if ref[k] != v}
  assert not differ
  # 63 until the checkpoint slice, 74 after it; the multi-process slice
  # adds tp_compute, sharding_rules, sdc_check and sdc_allgather; the
  # learner extensions popart_beta, the five pixel_control_* knobs,
  # impact_epsilon, target_update_interval, the three replay_* fields
  # and max_unroll_staleness; the Anakin runtime's rest (A6) the four
  # filler fields, the four curriculum_* knobs, procgen_num_levels,
  # procgen_wall_density and the six pbt_* fields; evaluation and the
  # serving plane (A7.1, A7.2) test_num_episodes, dataset_path,
  # level_cache_dir, sticky_action_prob, inference_state_slots and
  # inference_admission_timeout_secs; the telemetry plane (A7.4's first
  # part, with A7.5's lock primitives) telemetry_trace,
  # telemetry_flight_len and lock_order_check; remote actors (A7.3's
  # first part) task, job_name, remote_actor_port, remote_actor_bind_host,
  # learner_address, remote_publish_secs, remote_params_dtype,
  # actor_reconnect_secs, remote_heartbeat_secs,
  # remote_conn_idle_timeout_secs, ingest_workers and wire_crc; routed
  # serving and the SLO engine (A7.3b, A7.4's second part) the eight slo_*
  # fields and profile_dir, profile_start_step and profile_num_steps; the
  # controller (the rest of A7.4) controller, controller_policy,
  # controller_interval_secs, controller_replay_k_max,
  # controller_publish_secs_max and pod_max_hosts, and A7.5
  # compile_cache_dir: every JAX field.
  assert len(port) == 145
  assert set(port) == set(ref)


def test_the_checkpoint_and_health_fields_reach_the_cli():
  from scalable_agent_tpu_torch import experiment
  args = vars(experiment._parser().parse_args(
      ['--checkpoint_secs=5', '--ckpt_digests=false',
       '--preempt_drain_timeout_secs=2.5', '--health_rollback_after=2']))
  args.pop('device')
  config = Config(**args)
  assert (config.checkpoint_secs, config.ckpt_digests,
          config.preempt_drain_timeout_secs,
          config.health_rollback_after) == (5, False, 2.5, 2)


def test_the_tp_and_sdc_fields_reach_the_cli():
  from scalable_agent_tpu_torch import experiment
  args = vars(experiment._parser().parse_args(
      ['--model_parallelism=2', '--tp_compute=sharded',
       '--sharding_rules=megatron', '--sdc_check=false',
       '--staging_mode=unroll']))
  args.pop('device')
  config = Config(**args)
  assert (config.model_parallelism, config.tp_compute,
          config.sharding_rules, config.sdc_check,
          config.staging_mode) == (2, 'sharded', 'megatron', False, 'unroll')


def test_the_serving_fields_validate_as_in_jax():
  """validate_serving's hard errors and warnings are JAX's, routed
  serving's serving_replicas among them (ROADMAP A7.3b: on a learner,
  a warning), and every fleet setting validates."""
  import pytest

  from scalable_agent_tpu.config import validate_serving as jax_validate
  from scalable_agent_tpu_torch.config import (validate_fleet,
                                               validate_serving)
  for bad in (dict(serving_resident_versions=0),
              dict(serving_hbm_budget_mb=-1.0),
              dict(serving_ab_fraction=1.5),
              dict(serving_shadow_fraction=-0.1)):
    with pytest.raises(ValueError):
      jax_validate(JaxConfig(**bad))
    with pytest.raises(ValueError):
      validate_serving(Config(**bad))
  warn = dict(serving_shadow_fraction=0.5)
  assert validate_serving(Config(**warn)) == jax_validate(JaxConfig(**warn))
  assert len(validate_serving(Config(**warn))) == 1
  for ported in (dict(inference_state_cache=True, inference_state_slots=4),
                 dict(inference_admission='grow'), dict(publish_codec='int8'),
                 dict(serving_resident_versions=3, serving_aot=True),
                 dict(fleet_tasks='gridworld:2,procgen')):
    validate_fleet(Config(**ported))
  routed = dict(serving_replicas='localhost:1')
  validate_fleet(Config(**routed))
  assert validate_serving(Config(**routed)) == jax_validate(
      JaxConfig(**routed))
  assert len(validate_serving(Config(**routed))) == 1
  assert validate_serving(Config(learner_address='h:1', **routed)) == []
  with pytest.raises(ValueError):
    validate_fleet(Config(inference_state_slots=-1))
