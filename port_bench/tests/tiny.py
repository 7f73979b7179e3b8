"""Cells shrunk for the CPU tests: a cell's files (listed in
BENCHMARK.json or not yet), with frames, batch and unroll small enough
for a test run."""

from port_bench import cells

TINY = dict(height=24, width=32, batch_size=4, unroll_length=5,
            episode_length=3)


def cell(name, **fields):
  out = cells.load(name)
  out['fields'].update(TINY, **fields)
  out['model'] = cells.model_of(out['config'], out['fields'])
  return out
