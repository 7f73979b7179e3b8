"""The port's sharding registry (scalable_agent_tpu_torch/parallel/
sharding.py), its SDC fingerprint (learner.param_fingerprint) and the
group helpers of parallel/distributed.py and driver.choose_mesh, against
the JAX package's on the same inputs, on the CPU.

The registry's rules are JAX's regexes over JAX's parameter paths; the
port maps each of its parameter names back to those paths. So on the
converted weights of the same agent, the port's specs per JAX path, its
manifest (`describe`, before and after the divisibility guard) and the
manifest's digest must equal JAX's exactly (string equality), and the
blocks a rank holds must be the slices of the JAX leaves that JAX's
NamedSharding gives the device at the same model index (bit-equal).
`param_fingerprint` is exact integer arithmetic: bit-equal to JAX's.
No collectives run here: the multi-rank paths are in
tests/test_torch_tensor_parallel.py and tests/test_torch_dp_fleet.py.
"""

import functools
import logging

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import (Config, validate_distributed,
                                             validate_integrity)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.structs import map_structure

A = 4
H, W = 24, 32
MODEL = sharding.MODEL_AXIS


@functools.lru_cache(maxsize=None)
def _jax_params(torso):
  """The JAX agent's params (one init per torso: a test that changes a
  leaf copies the tree first)."""
  import jax
  from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
  from scalable_agent_tpu.models import init_params as jax_init_params
  agent = JaxAgent(num_actions=A, torso=torso, use_instruction=False)
  return jax.device_get(jax_init_params(
      agent, jax.random.PRNGKey(0), {'frame': (H, W, 3), 'instr_len': 16}))


def _port_params(jax_params):
  state = convert.params_from_jax(jax_params)
  del state['core.bias_ih']  # a buffer in the port, not a parameter
  return state


def _jax_mesh(width):
  import jax
  from jax.sharding import Mesh
  devices = np.asarray(jax.devices()[:width]).reshape(1, width)
  return Mesh(devices, ('data', 'model'))


# --- resolution -----------------------------------------------------------

def test_rule_order_first_match_wins():
  specific_first = sharding.ShardingRegistry((
      (r'special/kernel$', (MODEL, None)),
      (r'.*kernel$', (None, MODEL)),
      (r'.*', ()),
  ))
  leaf = (8, 16)
  assert specific_first.spec_for('special/kernel', leaf) == (MODEL, None)
  assert specific_first.spec_for('other/kernel', leaf) == (None, MODEL)
  assert specific_first.spec_for('other/bias', leaf) == ()
  generic_first = sharding.ShardingRegistry((
      (r'.*kernel$', (None, MODEL)),
      (r'special/kernel$', (MODEL, None)),
      (r'.*', ()),
  ))
  assert generic_first.spec_for('special/kernel', leaf) == (None, MODEL)


def test_unmatched_path_is_a_hard_error():
  registry = sharding.ShardingRegistry(((r'.*kernel$', ()),))
  assert registry.spec_for('torso/kernel', torch.zeros(4, 4)) == ()
  with pytest.raises(sharding.ShardingRuleError, match='torso/bias'):
    registry.spec_for('torso/bias', torch.zeros(4, 4))
  with pytest.raises(ValueError, match='at least one rule'):
    sharding.ShardingRegistry(())


def test_scalars_replicate_before_rules_run():
  registry = sharding.ShardingRegistry(((r'.*', (MODEL,)),))
  assert registry.spec_for('step', ()) == ()
  assert registry.spec_for('one_elem', (1,)) == ()
  assert registry.spec_for('vec', (8,)) == (MODEL,)


def test_from_config_resolution():
  assert sharding.from_config(Config()).rule_set == 'replicated'
  assert sharding.from_config(
      Config(batch_size=8, model_parallelism=2)).rule_set == 'megatron'
  assert sharding.from_config(
      Config(sharding_rules='megatron')).rule_set == 'megatron'
  assert not sharding.from_config(
      Config(batch_size=8, model_parallelism=2,
             sharding_rules='replicated')).model_sharded
  with pytest.raises(ValueError, match='bogus'):
    sharding.from_config(Config(sharding_rules='bogus'))


def test_rule_sets_are_jax_rule_sets():
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  assert set(sharding.RULE_SETS) == set(jax_sharding.RULE_SETS)
  for name, rules in sharding.RULE_SETS.items():
    want = [(p, str(s)) for p, s in jax_sharding.RULE_SETS[name]]
    assert [(p, sharding.spec_str(s)) for p, s in rules] == want


# --- the registry on the agent's parameters, against JAX's ----------------

@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_paths_are_the_jax_tree(torso):
  import jax
  jax_params = _jax_params(torso)
  want = {'/'.join(str(getattr(k, 'key', k)) for k in kp): tuple(v.shape)
          for kp, v in jax.tree_util.tree_flatten_with_path(jax_params)[0]}
  assert convert.jax_view(_port_params(jax_params)) == want


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_jax_leaves_invert_params_from_jax(torso):
  """Each port tensor rebuilt from the JAX leaves `jax_leaves` names,
  each leaf's dims moved by `dims` and the gate blocks joined on dim 0,
  is the tensor params_from_jax made, bit for bit."""
  import jax
  jax_params = _jax_params(torso)
  by_path = {'/'.join(str(getattr(k, 'key', k)) for k in kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_flatten_with_path(
                 jax_params)[0]}
  port = _port_params(jax_params)
  for name, tensor in port.items():
    leaves, blocks = convert.jax_leaves(name, tensor.shape, list(port))
    assert len(leaves) == blocks, name
    parts = [np.transpose(by_path[leaf.path], np.argsort(leaf.dims))
             for leaf in leaves]
    np.testing.assert_array_equal(np.concatenate(parts, 0),
                                  tensor.numpy(), err_msg=name)


@pytest.mark.parametrize('width', [None, 1, 2, 3])
@pytest.mark.parametrize('rule_set', ['megatron', 'replicated'])
@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_describe_matches_jax(torso, rule_set, width):
  """The manifest per JAX path, without a mesh and with the divisibility
  guard at model widths 1 and 2 (every cut divides) and 3 (none of the
  convs' 16/32 channels nor the 256 features divide: all replicated)."""
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  jax_params = _jax_params(torso)
  jax_registry = jax_sharding.ShardingRegistry(
      jax_sharding.RULE_SETS[rule_set], rule_set=rule_set)
  registry = sharding.ShardingRegistry(sharding.RULE_SETS[rule_set],
                                       rule_set=rule_set)
  jax_mesh = None if width is None else _jax_mesh(width)
  mesh = None if width is None else {'data': 1, 'model': width}
  want = jax_registry.describe(jax_params, jax_mesh)
  got = registry.describe(_port_params(jax_params), mesh)
  assert got == want
  assert integrity.spec_table_digest(got) == (
      jax_sharding_digest(want))
  cut = {p for p, s in got.items() if 'model' in s}
  if rule_set == 'megatron' and width != 3:
    assert len(cut) == len(got) - 4  # all but the two heads' leaves
  else:
    assert not cut


def jax_sharding_digest(specs):
  from scalable_agent_tpu import integrity as jax_integrity
  return jax_integrity.spec_table_digest(specs)


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_port_specs_follow_the_jax_leaves(torso):
  """Each port tensor's spec is its JAX leaves' spec moved onto the port
  layout: every cut lands on the port's output-feature dim 0."""
  jax_params = _jax_params(torso)
  registry = sharding.from_config(Config(sharding_rules='megatron'))
  specs = registry.param_specs(_port_params(jax_params))
  for name, spec in specs.items():
    if name.startswith(('policy_logits', 'baseline')):
      assert spec == (), name
    else:
      assert spec[0] == MODEL and all(e is None for e in spec[1:]), name


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_blocks_are_jax_device_shards(torso):
  """The block a rank at model index m holds, mapped back through the
  conversion, is the shard JAX's `param_shardings` puts on the device at
  model index m of a (1, 2) mesh, bit for bit (the LSTM's fused gates
  included)."""
  import jax
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  jax_params = _jax_params(torso)
  port = _port_params(jax_params)
  jax_mesh = _jax_mesh(2)
  jax_registry = jax_sharding.from_config(
      Config(batch_size=8, model_parallelism=2))
  placed = jax.tree_util.tree_map(
      jax.device_put, jax_params,
      jax_registry.param_shardings(jax_params, jax_mesh))
  layout = sharding.ParamLayout(sharding.from_config(
      Config(batch_size=8, model_parallelism=2)), port,
      {'data': 1, 'model': 2})
  for m, device in enumerate(jax_mesh.devices.flat):
    local = jax.tree_util.tree_map(
        lambda x: np.asarray(x.addressable_data(
            [s.device for s in x.addressable_shards].index(device))),
        placed)
    layout.index = m
    want = _port_params(local)
    for name, full in port.items():
      got = layout.local(name, full)
      np.testing.assert_array_equal(got.numpy(), want[name].numpy(),
                                    err_msg=f'{name} at model index {m}')
  blocks = [{k: sharding.take_block(v, layout.cuts[k], m)
             for k, v in port.items()} for m in range(2)]
  for name, full in port.items():
    joined = sharding.join_blocks([b[name] for b in blocks],
                                  layout.cuts[name])
    assert torch.equal(joined, full), name


def test_opt_and_state_specs_clone_param_specs():
  """RMSProp's moments take their params' specs (the JAX state's nu and
  momentum trace take the same JAX leaf specs); the count and the step
  counter are replicated."""
  import jax
  from jax.sharding import PartitionSpec as P
  from scalable_agent_tpu import learner as jax_learner
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  jax_params = _jax_params('shallow')
  jcfg = JaxConfig(batch_size=8, model_parallelism=2, momentum=0.5)
  jax_registry = jax_sharding.from_config(jcfg)
  jstate = jax_learner.make_train_state(jax_params, jcfg)
  jspecs = jax_registry.state_specs(jstate)
  flat_p = jax.tree_util.tree_leaves(jspecs.params,
                                     is_leaf=lambda x: isinstance(x, P))
  flat_o = jax.tree_util.tree_leaves(jspecs.opt_state,
                                     is_leaf=lambda x: isinstance(x, P))
  assert flat_o == flat_p + [P()] + flat_p

  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  agent.load_state_dict(convert.params_from_jax(jax_params))
  config = Config(batch_size=8, model_parallelism=2, momentum=0.5)
  state = learner.make_train_state(agent, config)
  registry = sharding.from_config(config)
  specs = registry.state_specs(state)
  assert specs.opt_state.nu == specs.params
  assert specs.opt_state.trace == specs.params
  assert specs.opt_state.count == () and specs.update_steps == ()
  # Each port spec is the JAX leaves' spec on the port layout.
  want = jax_registry.describe(jax_params)
  names = list(state.params)
  for name, spec in specs.opt_state.nu.items():
    leaves, _ = convert.jax_leaves(name, state.params[name].shape, names)
    for leaf in leaves:
      assert sharding.port_spec(
          _parse(want[leaf.path]), leaf, len(spec)) == spec, name


def _parse(text):
  return eval(text[len('PartitionSpec'):])  # noqa: S307 -- a repr


def test_batch_specs_match_jax():
  import jax
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  from scalable_agent_tpu.testing import make_example_batch
  jax_batch = make_example_batch(5, 8, H, W, A, 16)
  batch = map_structure(np.asarray, jax_batch)
  batch = batch._replace(agent_state=tuple(batch.agent_state))
  jax_registry = jax_sharding.from_config(Config())
  registry = sharding.from_config(Config())
  for over in (False, True):
    want = jax_registry.batch_specs(jax_batch, shard_over_model=over)
    got = registry.batch_specs(batch, shard_over_model=over)
    got_flat = []
    map_structure(lambda _, spec: got_flat.append(spec), batch, got)
    want_flat = [str(s) for s in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: type(x).__name__ == 'PartitionSpec')]
    # JAX's specs name only the batch dim; trailing Nones are implicit.
    assert [sharding.spec_str(_trim(s)) for s in got_flat] == want_flat


def _trim(spec):
  spec = list(spec)
  while spec and spec[-1] is None:
    spec.pop()
  return tuple(spec)


def test_layout_violations_name_the_structural_reason():
  registry = sharding.ShardingRegistry((
      (r'.*rank$', (None, None, MODEL)),
      (r'.*odd$', (None, MODEL)),
      (r'.*', ()),
  ), rule_set='layout-test')
  tree = {'a_rank': (4, 4), 'b_odd': (4, 7), 'c_fine': (4, 4)}
  on_tp = dict(registry.layout_violations(tree, {'data': 1, 'model': 2}))
  assert set(on_tp) == {'a_rank', 'b_odd'}
  assert 'rank' in on_tp['a_rank']
  assert 'does not divide' in on_tp['b_odd']
  on_dp = dict(registry.layout_violations(tree, {'data': 2}))
  assert set(on_dp) == {'a_rank', 'b_odd'}
  assert "'model'" in on_dp['b_odd']


def test_check_layout_exempts_leaves_saved_replicated():
  registry = sharding.ShardingRegistry((
      (r'.*odd$', (None, MODEL)),
      (r'.*', ()),
  ), rule_set='layout-test')
  mesh = {'data': 1, 'model': 2}
  tree = {'w_odd': (4, 7)}
  with pytest.raises(sharding.ShardingLayoutError, match='w_odd'):
    registry.check_layout(tree, mesh, what='param')
  registry.check_layout(tree, mesh, what='param',
                        saved_specs={'w_odd': 'PartitionSpec()'})
  with pytest.raises(sharding.ShardingLayoutError, match='does not divide'):
    registry.check_layout(
        tree, mesh, what='param',
        saved_specs={'w_odd': "PartitionSpec(None, 'model')"})


def test_fused_gates_with_different_specs_raise():
  registry = sharding.ShardingRegistry((
      (r'.*/ii/kernel$', (None, MODEL)),
      (r'.*', ()),
  ))
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  with pytest.raises(sharding.ShardingRuleError, match='core.weight_ih'):
    registry.param_specs(dict(agent.named_parameters()))


# --- predicates and group helpers ----------------------------------------

def test_batch_over_model_predicates(monkeypatch):
  tp = Config(batch_size=8, model_parallelism=2)
  assert not sharding.shard_batch_over_model(tp)  # no group: one rank
  monkeypatch.setattr(distributed, 'world_size', lambda: 2)
  assert sharding.shard_batch_over_model(tp)
  assert not sharding.shard_batch_over_model(Config())
  mesh = mesh_lib.Mesh(rank=0, size=1, device=torch.device('cpu'),
                       model_index=1, model_size=2)
  assert sharding.needs_host_local_params(tp, mesh)
  assert not sharding.needs_host_local_params(tp, None)
  assert not train_parallel.supports_unroll_staging(tp, mesh)
  assert not train_parallel.supports_sdc_check(tp, mesh)


def test_mesh_axes_and_refusals():
  mesh = mesh_lib.Mesh(rank=1, size=2, device=torch.device('cpu'),
                       model_index=1, model_size=2)
  assert mesh.shape == {'data': 2, 'model': 2}
  assert (mesh.world_rank, mesh.world_size) == (3, 4)
  for axis in ('data', 'model', None):
    with pytest.raises(RuntimeError, match='process group'):
      mesh.all_reduce_sum_(torch.zeros(1), axis=axis)
  with pytest.raises(ValueError, match='model index'):
    mesh_lib.Mesh(rank=0, size=1, device=torch.device('cpu'),
                  model_index=2, model_size=2)
  one = mesh_lib.Mesh(rank=0, size=1, device=torch.device('cpu'))
  x = torch.ones(3)
  assert one.all_gather(x, axis='data')[0] is x
  assert one.broadcast_(x) is x


def test_topology_delta():
  mesh = mesh_lib.Mesh(rank=0, size=1, device=torch.device('cpu'),
                       model_index=0, model_size=2)
  assert distributed.topology_delta(None, mesh) is None
  assert distributed.topology_delta({'data': 1, 'model': 2}, None) is None
  assert distributed.topology_delta({'data': 1, 'model': 2}, mesh) is None
  delta = distributed.topology_delta({'data': 2, 'model': 1}, mesh)
  assert delta == {'saved_mesh': {'data': 2, 'model': 1},
                   'live_mesh': {'data': 1, 'model': 2},
                   'processes': 1, 'process_index': 0}


def test_choose_mesh_model_axis_rules(monkeypatch, caplog):
  monkeypatch.setattr(distributed, 'world_size', lambda: 1)
  with pytest.raises(ValueError, match='does not divide the device count'):
    driver.choose_mesh(Config(model_parallelism=2), 'cpu')
  monkeypatch.setattr(distributed, 'world_size', lambda: 4)
  with pytest.raises(ValueError, match='does not divide the device count'):
    driver.choose_mesh(Config(batch_size=8, model_parallelism=3), 'cpu')
  # Under TP the batch shards over every rank: 6 does not split 4 ways.
  with caplog.at_level(logging.WARNING, logger='scalable_agent_tpu_torch'):
    assert driver.choose_mesh(
        Config(batch_size=6, model_parallelism=2), 'cpu') is None
  assert 'not divisible by the 4 ranks' in caplog.text


@pytest.mark.parametrize('kw', [
    {'tp_compute': 'fast'}, {'sharding_rules': 'bogus'},
    {'sharding_rules': 'replicated', 'model_parallelism': 2},
    {'coordinator_address': 'localhost:1', 'num_processes': 2,
     'model_parallelism': 2},
    {'coordinator_address': 'localhost:1', 'num_processes': 2,
     'sdc_allgather': False},
    {'coordinator_address': 'localhost:1', 'num_processes': 2}])
def test_tp_and_sdc_validation_matches_jax(kw):
  """JAX's range errors and multi-process cross-links on the TP and SDC
  fields, message for message (the port's rank is JAX's process)."""
  from scalable_agent_tpu import config as jax_config

  def outcome(validate, config):
    try:
      return 'ok', validate(config)
    except ValueError as e:
      return 'error', str(e)

  got = outcome(validate_distributed, Config(**kw))
  want = outcome(jax_config.validate_distributed, jax_config.Config(**kw))
  assert got[0] == want[0], (got, want)
  if got[0] == 'error':
    assert got[1] == want[1]
  else:
    assert [w.split(':')[0] for w in got[1]] == [
        w.split(':')[0] for w in want[1]]


def test_validate_integrity_matches_jax():
  from scalable_agent_tpu import config as jax_config
  for kw in ({}, {'health_watchdog': False},
             {'health_watchdog': False, 'sdc_check': False}):
    assert validate_integrity(Config(**kw)) == (
        jax_config.validate_integrity(jax_config.Config(**kw)))


# --- the SDC fingerprint --------------------------------------------------

@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_param_fingerprint_matches_jax(torso):
  import jax
  from scalable_agent_tpu import learner as jax_learner
  jax_params = _jax_params(torso)
  want = int(jax_learner.param_fingerprint(jax_params))
  port = _port_params(jax_params)
  assert int(learner.param_fingerprint(port)) == want
  # One flipped bit, in the same element of both trees.
  flipped = np.asarray(jax_params['params']['baseline']['kernel']).copy()
  flipped.view(np.uint32)[3, 0] ^= 1 << 17
  jax_flipped = jax.tree_util.tree_map(lambda x: x, jax_params)
  jax_flipped['params']['baseline']['kernel'] = flipped
  want_flipped = int(jax_learner.param_fingerprint(jax_flipped))
  assert want_flipped != want
  assert int(learner.param_fingerprint(_port_params(jax_flipped))) == (
      want_flipped)


def test_param_fingerprint_widths_match_jax():
  """Every leaf width JAX handles: 8-byte leaves as uint32 pairs, bool as
  uint8, 1- and 2-byte leaves as their own unsigned widths."""
  import jax.numpy as jnp
  from scalable_agent_tpu import learner as jax_learner
  rng = np.random.RandomState(1)
  leaves = {'f32': rng.randn(5, 3).astype(np.float32),
            'i32': rng.randint(-2**31, 2**31 - 1, 7).astype(np.int32),
            'u8': rng.randint(0, 256, 9).astype(np.uint8),
            'i16': rng.randint(-2**15, 2**15, 6).astype(np.int16),
            'bool': rng.rand(4) > 0.5,
            'empty': np.zeros((0,), np.float32)}
  want = int(jax_learner.param_fingerprint(
      {k: jnp.asarray(v) for k, v in leaves.items()}))
  got = learner.param_fingerprint(
      {k: torch.from_numpy(v) for k, v in leaves.items()})
  assert int(got) == want
  wide = rng.randint(-2**62, 2**62, 5).astype(np.int64)
  halves = wide.view(np.uint32).astype(np.uint64).sum() % 2**32
  assert int(learner.param_fingerprint({'i64': torch.from_numpy(wide)})) == (
      int(halves))
