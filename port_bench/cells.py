"""Finding a cell's files by name: `workloads/<cell>.json` names its
configuration (`configs/<config>.json`) and its traffic mix
(`traffic/<traffic>.json`), whose `runtime` names the module under
`runtimes/` that drives it. BENCHMARK.json, at the checkout's root,
lists the same names; a cell whose files disagree with it is refused.
"""

import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# The learner settings the reference implements (reference/learner.py):
# a configuration that asks for another is refused before any run.
REFERENCE_FIXED = {'reward_clipping': 'abs_one', 'momentum': 0.0,
                   'grad_clip_norm': None, 'use_popart': False,
                   'pixel_control_cost': 0.0, 'surrogate': 'vtrace',
                   'use_instruction': False, 'replay_k': 1,
                   'replay_ratio': 0.0}
HYPER_KEYS = ('learning_rate', 'decay', 'epsilon', 'entropy_cost',
              'baseline_cost', 'discounting', 'total_environment_frames')


def load_json(*parts):
  with open(os.path.join(BENCH_DIR, *parts)) as f:
    return json.load(f)


def benchmark():
  with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    return json.load(f)


def model_of(config, fields):
  """The widths the reference and the counting read: the torso, its
  sections, the frame, the action count and the core."""
  return dict(config['model'], torso=fields['torso'],
              height=fields['height'], width=fields['width'],
              num_actions=fields['num_actions'])


def load(name, bench=None):
  """The cell `name`: {'name', 'workload', 'config', 'traffic',
  'fields' (the port Config's fields less the seed and logdir),
  'model', 'hyper', 'limits'}."""
  workload = load_json('workloads', f'{name}.json')
  config = load_json('configs', f'{workload["config"]}.json')
  traffic = load_json('traffic', f'{workload["traffic"]}.json')
  if bench is not None:
    entry = {w['name']: w for w in bench['workloads']}.get(name)
    if entry is None:
      raise KeyError(f'BENCHMARK.json has no workload {name!r}')
    for key in ('config', 'traffic', 'chips'):
      if entry[key] != workload[key]:
        raise ValueError(f'{name}: {key} is {workload[key]!r} in its file '
                         f'and {entry[key]!r} in BENCHMARK.json')
  fields = dict(config['fields'], **traffic['fields'])
  for key, value in REFERENCE_FIXED.items():
    if fields.get(key, value) != value:
      raise ValueError(f'{name}: {key}={fields[key]!r}; the reference '
                       f'implements {value!r} only')
  return {'name': name, 'workload': workload, 'config': config,
          'traffic': traffic, 'fields': fields,
          'model': model_of(config, fields),
          'hyper': {k: fields[k] for k in HYPER_KEYS},
          'limits': workload['limits']}
