"""Per-unroll pipeline latency and policy-lag report from a run's traces.

    python -m scalable_agent_tpu_torch.scripts.trace_report LOGDIR [--json OUT.json]

Reads every `traces*.jsonl` under LOGDIR (one stream per process under a
group: `traces_p<k>.jsonl`) and every `incidents*.jsonl`, and reports:

- **per-hop latency**: p50/p99/max milliseconds for each adjacent hop
  transition observed (done→send→wire→commit→staged→serve→step; a span
  may omit hops, as a local-fleet unroll never crosses the wire), and
  the end-to-end span;
- **policy lag**: the per-batch publish-version delta, the staleness
  V-trace corrects for, as a histogram and per-batch mean/max
  percentiles;
- **param propagation**: publish→installed-at-actor latency per version,
  joined from the 'publish' and 'install' records;
- **timeline**: batches per second with the incidents (rollbacks,
  partitions, reattaches) marked beside them.

The port's copy of the JAX package's `scripts/trace_report.py`: the same
names, CLI, data model and text. Missing values render '-'. A truncated
last line (a crashed writer) is skipped. Cross-host hop deltas carry the
hosts' NTP skew; within a host they are exact. It reads files only: no
device, no torch.
"""

import argparse
import collections
import glob
import json
import math
import os
import sys

from scalable_agent_tpu_torch import telemetry

HOP_ORDER = telemetry.HOP_ORDER


def span_hop_deltas(span):
  """One span's `[hop, wall_time]` list → (adjacent-hop deltas, e2e):
  `([((hop_from, hop_to), ms_or_None), ...], e2e_ms_or_None)`. Keeps the
  FIRST stamp per hop name, in pipeline order: a resend re-stamps
  send/wire, and the first traversal is the latency story. A negative
  raw delta (cross-host wall clocks skewed past each other) yields
  ms=None, which the report renders '-' rather than a fake 0 ms, and
  which summarize and to_tensorboard skip. Malformed stamps (wrong
  arity, a time that is not a number) are ignored: the streams may come
  from crashed peers. The one implementation behind summarize() and
  to_tensorboard's trace conversion."""
  seen = {}
  for entry in span.get('h') or []:
    try:
      name, t = entry
      t = float(t)
    except (TypeError, ValueError):
      continue
    seen.setdefault(name, t)
  ordered = [(n, seen[n]) for n in HOP_ORDER if n in seen]
  deltas = [((n0, n1), (t1 - t0) * 1e3 if t1 >= t0 else None)
            for (n0, t0), (n1, t1) in zip(ordered, ordered[1:])]
  e2e = None
  if len(ordered) >= 2 and ordered[-1][1] >= ordered[0][1]:
    e2e = (ordered[-1][1] - ordered[0][1]) * 1e3
  return deltas, e2e


def _fmt(v, digits=2):
  """Numbers → fixed-point; None/NaN → '-'."""
  if v is None:
    return '-'
  try:
    f = float(v)
  except (TypeError, ValueError):
    return str(v)
  if math.isnan(f):
    return '-'
  return f'{f:.{digits}f}'


def _percentiles(values, *qs):
  if not values:
    return tuple(float('nan') for _ in qs)
  snap = sorted(values)
  last = len(snap) - 1
  return tuple(snap[min(last, int(round(q * last)))] for q in qs)


def _read_jsonl(pattern):
  """Every decodable record of the files matching `pattern`, file by
  file in name order; undecodable lines (a truncated last line) skip."""
  records = []
  for path in sorted(glob.glob(pattern)):
    with open(path) as f:
      for line in f:
        line = line.strip()
        if not line:
          continue
        try:
          records.append(json.loads(line))
        except json.JSONDecodeError:
          continue
  return records


def load_traces(logdir):
  """Every record of every traces*.jsonl under `logdir`, sorted by record
  wall time."""
  records = _read_jsonl(os.path.join(logdir, 'traces*.jsonl'))
  records.sort(key=lambda r: r.get('t', 0.0))
  return records


def load_incidents(logdir):
  """Every event of every incidents*.jsonl under `logdir`, sorted by wall
  time."""
  events = _read_jsonl(os.path.join(logdir, 'incidents*.jsonl'))
  events.sort(key=lambda e: e.get('wall_time', 0.0))
  return events


def summarize(records, incidents=()):
  """The report's data model: hop-transition latencies, end-to-end spans,
  the policy-lag histogram, publish→install propagation and the
  per-second batch timeline. A pure function of the parsed records
  (scripts/chaos.py, scripts/soak.py, slo.py and chip_smoke.py read it;
  main() renders it)."""
  hop_deltas = collections.defaultdict(list)   # (from, to) -> [ms]
  e2e_ms = []
  lag_hist = collections.Counter()
  batch_lag_mean = []
  batch_lag_max = []
  batches = 0
  unrolls = 0
  actors = set()
  publishes = {}                              # version -> wall time
  install_lat = []                            # publish -> install secs
  timeline = collections.Counter()            # int(second) -> batches
  steps = []
  for rec in records:
    kind = rec.get('k')
    if kind == 'publish':
      # Install notices carry the ingest lane's version sequence ('rv' on
      # publish records that also went to remote actors); the
      # step-stamped label 'v' is another clock.
      publishes[rec['rv'] if 'rv' in rec else rec.get('v')] = rec.get('t')
    elif kind == 'install':
      t_pub = publishes.get(rec.get('v'))
      if t_pub is not None and rec.get('t') is not None:
        install_lat.append(max(rec['t'] - t_pub, 0.0))
    elif kind == 'batch':
      batches += 1
      steps.append(rec.get('step'))
      if rec.get('t') is not None:
        timeline[int(rec['t'])] += 1
      lags = rec.get('lag') or []
      for lag in lags:
        lag_hist[int(lag)] += 1
      if lags:
        batch_lag_mean.append(sum(lags) / len(lags))
        batch_lag_max.append(max(lags))
      for span in rec.get('spans') or []:
        unrolls += 1
        actors.add(span.get('a'))
        deltas, e2e = span_hop_deltas(span)
        for pair, ms in deltas:
          if ms is not None:  # clock-skewed hops render '-', not 0
            hop_deltas[pair].append(ms)
        if e2e is not None:
          e2e_ms.append(e2e)
  hop_rows = []
  for (n0, n1), values in sorted(
      hop_deltas.items(),
      key=lambda kv: (HOP_ORDER.index(kv[0][0]),
                      HOP_ORDER.index(kv[0][1]))):
    p50, p99 = _percentiles(values, 0.5, 0.99)
    hop_rows.append({'hop': f'{n0}->{n1}', 'count': len(values),
                     'p50_ms': p50, 'p99_ms': p99,
                     'max_ms': max(values)})
  e2e_p50, e2e_p99 = _percentiles(e2e_ms, 0.5, 0.99)
  lag_p50, lag_p99 = _percentiles(
      [lag for lag, n in lag_hist.items() for _ in range(n)], 0.5, 0.99)
  inst_p50, inst_p99 = _percentiles(install_lat, 0.5, 0.99)
  incident_rows = [
      {'wall_time': e.get('wall_time'), 'kind': e.get('kind'),
       'step': e.get('step')}
      for e in incidents]
  return {
      'batches': batches,
      'unrolls': unrolls,
      'actors': len(actors),
      'steps': [s for s in (min(steps or [None]), max(steps or [None]))
                if s is not None],
      'hops': hop_rows,
      'e2e_ms': {'count': len(e2e_ms), 'p50': e2e_p50, 'p99': e2e_p99,
                 'max': max(e2e_ms) if e2e_ms else float('nan')},
      'policy_lag': {
          'histogram': dict(sorted(lag_hist.items())),
          'p50': lag_p50, 'p99': lag_p99,
          'batch_mean_p99': _percentiles(batch_lag_mean, 0.99)[0],
          'batch_max_p99': _percentiles(batch_lag_max, 0.99)[0],
      },
      'publish_to_install_secs': {'count': len(install_lat),
                                  'p50': inst_p50, 'p99': inst_p99},
      'timeline': {str(k): v for k, v in sorted(timeline.items())},
      'incidents': incident_rows,
  }


def render(summary):
  out = []
  w = out.append
  lo_hi = summary['steps']
  w('== trace report ==')
  w(f"batches {summary['batches']}  unrolls {summary['unrolls']}  "
    f"actors {summary['actors']}  steps "
    f"{lo_hi[0] if lo_hi else '-'}..{lo_hi[-1] if lo_hi else '-'}")
  w('')
  w('-- per-hop latency (ms) --')
  w(f"{'hop':>14} {'count':>8} {'p50':>10} {'p99':>10} {'max':>10}")
  for row in summary['hops']:
    w(f"{row['hop']:>14} {row['count']:>8} {_fmt(row['p50_ms']):>10} "
      f"{_fmt(row['p99_ms']):>10} {_fmt(row['max_ms']):>10}")
  e2e = summary['e2e_ms']
  w(f"{'end-to-end':>14} {e2e['count']:>8} {_fmt(e2e['p50']):>10} "
    f"{_fmt(e2e['p99']):>10} {_fmt(e2e['max']):>10}")
  w('')
  w('-- policy lag (publish-version delta at train time) --')
  lag = summary['policy_lag']
  if lag['histogram']:
    total = sum(lag['histogram'].values())
    for value, count in lag['histogram'].items():
      bar = '#' * max(1, int(40 * count / total))
      w(f'  lag {value:>4}: {count:>8}  {bar}')
  else:
    w('  (no behaviour-version data: old-protocol peers, or tracing off)')
  w(f"  p50 {_fmt(lag['p50'])}  p99 {_fmt(lag['p99'])}  "
    f"batch-mean p99 {_fmt(lag['batch_mean_p99'])}  "
    f"batch-max p99 {_fmt(lag['batch_max_p99'])}")
  w('')
  pi = summary['publish_to_install_secs']
  w('-- param propagation (publish -> installed-at-actor) --')
  w(f"  joins {pi['count']}  p50 {_fmt(pi['p50'], 3)}s  "
    f"p99 {_fmt(pi['p99'], 3)}s")
  w('')
  w('-- timeline (batches/sec, * = incident) --')
  incident_secs = collections.defaultdict(list)
  for e in summary['incidents']:
    if e.get('wall_time') is not None:
      incident_secs[int(e['wall_time'])].append(e.get('kind'))
  seconds = sorted(set(int(s) for s in summary['timeline']) |
                   set(incident_secs))
  t0 = seconds[0] if seconds else 0
  for sec in seconds:
    n = summary['timeline'].get(str(sec), 0)
    marks = ','.join(incident_secs.get(sec, []))
    bar = '#' * min(n, 60)
    w(f'  +{sec - t0:>4}s {n:>5} {bar}{"  *" + marks if marks else ""}')
  return '\n'.join(out)


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.trace_report',
      description='per-unroll trace + policy-lag report from traces.jsonl')
  parser.add_argument('logdir', help='run directory (has traces.jsonl)')
  parser.add_argument('--json', default=None,
                      help='also write the summary as JSON here')
  args = parser.parse_args(argv)
  records = load_traces(args.logdir)
  if not records:
    print(f'no traces*.jsonl records under {args.logdir!r} — was the '
          'run started with --telemetry_trace=false?', file=sys.stderr)
    return 1
  summary = summarize(records, load_incidents(args.logdir))
  print(render(summary))
  if args.json:
    with open(args.json, 'w') as f:
      json.dump(summary, f, indent=2, default=str)
    print(f'\nsummary JSON: {args.json}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
