"""A live learner's telemetry over the ingest's `stats` request.

    python -m scalable_agent_tpu_torch.scripts.fleet_stats HOST:PORT [--json] [--filter ingest]

Connects to a running learner's trajectory ingest port (the one actor
hosts use), sends the v8 `stats` request
(`RemoteActorClient.fetch_stats`) and prints the reply: the metrics
registry's snapshot and the ingest server's stats, for live debugging
without the logdir or a restart. Histograms print as count/p50/p99/max
rows; `--filter` keeps the names that contain its substring; `--json`
prints the raw reply. `stats` is served before any contract is offered,
so the tool needs none of the run's env or agent shapes. Exit status: 0
on a reply, 1 when the learner could not be reached.
"""

import argparse
import json
import math
import sys


def _fmt(v):
  if v is None:
    return '-'
  if isinstance(v, float):
    if math.isnan(v):
      return '-'
    return f'{v:.3f}'.rstrip('0').rstrip('.')
  return str(v)


def render(stats, name_filter=''):
  """The reply as the operator reads it: the registry's scalars, its
  histograms, then the ingest server's stats (nested dicts indented)."""
  out = []
  w = out.append
  registry = stats.get('registry') or {}
  ingest = stats.get('ingest') or {}
  w('== metrics registry (%d names) ==' % len(registry))
  scalars = {}
  hists = {}
  for name, value in registry.items():
    if name_filter and name_filter not in name:
      continue
    (hists if isinstance(value, dict) else scalars)[name] = value
  for name in sorted(scalars):
    w(f'  {name:<44} {_fmt(scalars[name])}')
  if hists:
    w(f"  {'-- histograms --':<44} "
      f"{'count':>8} {'p50':>10} {'p99':>10} {'max':>10}")
    for name in sorted(hists):
      h = hists[name]
      w(f"  {name:<44} {_fmt(h.get('count')):>8} "
        f"{_fmt(h.get('p50')):>10} {_fmt(h.get('p99')):>10} "
        f"{_fmt(h.get('max')):>10}")
  w('')
  w('== ingest server ==')
  for key in sorted(ingest):
    value = ingest[key]
    if name_filter and name_filter not in key:
      continue
    if isinstance(value, dict):
      w(f'  {key}:')
      for sub in sorted(value):
        w(f'    {sub:<42} {_fmt(value[sub])}')
    else:
      w(f'  {key:<44} {_fmt(value)}')
  return '\n'.join(out)


def fetch(address, connect_timeout_secs=10.0):
  """One `fetch_stats` round trip against a live learner."""
  from scalable_agent_tpu_torch.runtime import remote
  client = remote.RemoteActorClient(
      address, connect_timeout_secs=connect_timeout_secs)
  try:
    return client.fetch_stats()
  finally:
    client.close()


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.fleet_stats',
      description="print a live learner's v8 stats reply (registry and "
                  'ingest)')
  parser.add_argument('address', help='the learner ingest HOST:PORT')
  parser.add_argument('--json', action='store_true',
                      help='print the raw reply as JSON instead')
  parser.add_argument('--filter', default='',
                      help='substring filter on metric and stat names')
  parser.add_argument('--timeout', type=float, default=10.0,
                      help='connect timeout seconds')
  args = parser.parse_args(argv)
  try:
    stats = fetch(args.address, connect_timeout_secs=args.timeout)
  except Exception as e:  # the operator reads the reason
    print(f'could not fetch stats from {args.address!r}: {e}',
          file=sys.stderr)
    return 1
  if args.json:
    print(json.dumps(stats, indent=2, sort_keys=True, default=str))
  else:
    print(render(stats, name_filter=args.filter))
  return 0


if __name__ == '__main__':
  sys.exit(main())
