"""The port's benchmark: one run of one cell.

  python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout that holds the port
(`scalable_agent_tpu_torch`). The cell's files are found by name
(cells.py); its traffic's `runtime` names the module under `runtimes/`
that builds the program from the seed, warms up the cell's shapes,
measures for `--seconds`, and compares what the timed path produced
with the plain reference (reference/). With `--trace 0` the result
carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, each read by `metrics/<name>.py` from the run's record.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit;
the same numbers are the last lines of standard error. Exit codes: 0
with a result (correct or not); 2 when the card or the port is
missing; 3 when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import cells  # noqa: E402
from port_bench import check  # noqa: E402

# Top-level module names the process may not hold (compared whole: the
# port, `scalable_agent_tpu_torch`, is not the JAX package).
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'scalable_agent_tpu')
CACHE_DIR = os.path.join(cells.BENCH_DIR, '_cache')


def forbidden_loaded():
  """The forbidden top-level modules present in sys.modules."""
  tops = {name.split('.', 1)[0] for name in list(sys.modules)}
  return sorted(tops.intersection(FORBIDDEN_MODULES))


def pin_caches():
  """Kernel caches a library may write, at fixed paths inside the
  checkout; the port's nvcc libraries already live in its `_build/`."""
  os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE_DIR, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE_DIR,
                                                    'torch_extensions')
  os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE_DIR, 'nv')


def metric_reader(name):
  """`metrics/<name>.py`'s `read(record)`, found by the metric's name."""
  path = os.path.join(cells.BENCH_DIR, 'metrics', f'{name}.py')
  spec = importlib.util.spec_from_file_location(
      f'port_bench.metrics.{name.replace(".", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read


def _applies(metric, cell_name, e2e_names):
  if 'workloads' in metric:
    return cell_name in metric['workloads']
  return metric.get('moves', metric['name']) in e2e_names


def cell_metrics(bench, cell_name):
  """(end-to-end entries, per-layer entries) that the cell reports."""
  e2e = [m for m in bench['end_to_end']
         if 'workloads' not in m or cell_name in m['workloads']]
  names = {m['name'] for m in e2e}
  layer = [m for m in bench['per_layer'] if _applies(m, cell_name, names)]
  return e2e, layer


def execute(cell, bench, seed, seconds, trace, device, t0=T0):
  """One run of `cell` on `device`; returns the result object."""
  runtime = importlib.import_module(
      f'port_bench.runtimes.{cell["traffic"]["runtime"]}')
  out = runtime.run(cell, seed, seconds, trace, device, t0)
  correct, checks = check.judge(out['numbers'], cell['limits'])
  e2e, layer = cell_metrics(bench, cell['name'])
  metrics = {}
  if not trace:
    for m in e2e:
      metrics[m['name']] = {'value': out['e2e'][m['name']],
                            'unit': m['unit']}
  else:
    for m in layer:
      value = metric_reader(m['name'])(out['record'])
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  import torch
  on_card = torch.device(device).type == 'cuda'
  result = {
      'correct': correct, 'attempted': out['attempted'],
      'failed': out['failed'], 'metrics': metrics,
      'device': dict({
          'platform': 'gpu' if on_card else 'cpu',
          'kind': (torch.cuda.get_device_name(0) if on_card
                   else 'cpu'),
          'count': cell['workload']['chips'],
          'memory_peak_bytes': out['memory_peak_bytes']}, **out['device'])}
  if trace and out['breakdown'] is not None:
    result['breakdown'] = out['breakdown']
  result['checks'] = checks
  return result


def main(argv=None):
  parser = argparse.ArgumentParser(prog='python -m port_bench.run')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  pin_caches()
  bench = cells.benchmark()
  cell = cells.load(args.workload, bench)
  try:
    import torch
    importlib.import_module('scalable_agent_tpu_torch')
  except ImportError as e:
    print(f'port_bench: the port cannot be imported: {e}', file=sys.stderr)
    return 2
  chips = cell['workload']['chips']
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f'port_bench: {args.workload} needs {chips} CUDA device(s); '
          f'available: {torch.cuda.is_available()}, count '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
          file=sys.stderr)
    return 2
  result = execute(cell, bench, args.seed, args.seconds, args.trace, 'cuda')
  loaded = forbidden_loaded()
  if loaded:
    print(f'port_bench: the process loaded {", ".join(loaded)}; no result',
          file=sys.stderr)
    return 3
  for name, c in result['checks'].items():
    print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
