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
  # and max_unroll_staleness.
  assert len(port) == 90


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
