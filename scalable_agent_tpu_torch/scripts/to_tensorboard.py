"""Convert a run's JSONL summaries and traces into TensorBoard event files.

    python -m scalable_agent_tpu_torch.scripts.to_tensorboard LOGDIR [--out OUT]
    tensorboard --logdir OUT   # default: LOGDIR/tb

The port logs JSONL (observability.py); this offline converter gives an
operator the reference's TensorBoard view of a run. Each summary stream
becomes a run: `summaries.jsonl` -> train, `summaries_p3.jsonl` ->
train_p3 (one stream per process under a group), `eval_summaries.jsonl`
-> eval. Scalars convert exactly (tag, value, step, wall time).
Histograms (kind=histogram: integer `counts`, optional bin `edges`)
convert through add_histogram_raw, with min/max/sum/sum_sq rebuilt from
the bin centres. Each trace stream (`traces.jsonl` -> trace,
`traces_p1.jsonl` -> trace_p1) becomes a run of per-batch policy-lag and
mean per-hop latency scalars, the hops computed by trace_report's
`span_hop_deltas`.

The port's copy of the JAX package's `scripts/to_tensorboard.py`, with
the same names, run names and events. It writes through
`torch.utils.tensorboard.SummaryWriter`, which needs the `tensorboard`
package; it is imported inside `convert` only, and nothing in the
training path imports this module.
"""

import argparse
import glob
import json
import os
import shutil
import sys

from scalable_agent_tpu_torch.scripts import trace_report


def _run_name(filename):
  base = os.path.basename(filename)
  if base == 'summaries.jsonl':
    return 'train'
  if base == 'eval_summaries.jsonl':
    return 'eval'
  for prefix, run in (('summaries_', 'train_'),
                      ('eval_summaries_', 'eval_')):
    if base.startswith(prefix):
      return run + base[len(prefix):].removesuffix('.jsonl')
  return base.removesuffix('.jsonl')


def _histogram_raw_args(event):
  """JSONL histogram -> add_histogram_raw kwargs. Without edges the
  counts are per-integer bins (e.g. action ids 0..n-1)."""
  counts = event['counts']
  edges = event.get('edges')
  if edges is None:
    edges = [i - 0.5 for i in range(len(counts) + 1)]
  centers = [(edges[i] + edges[i + 1]) / 2 for i in range(len(counts))]
  num = float(sum(counts))
  total = sum(c * x for c, x in zip(counts, centers))
  total_sq = sum(c * x * x for c, x in zip(counts, centers))
  nonzero = [i for i, c in enumerate(counts) if c]
  lo = edges[nonzero[0]] if nonzero else 0.0
  hi = edges[nonzero[-1] + 1] if nonzero else 0.0
  return dict(min=lo, max=hi, num=num, sum=total, sum_squares=total_sq,
              bucket_limits=list(edges[1:]), bucket_counts=list(counts))


def _trace_events(event):
  """One traces.jsonl 'batch' record → [(tag, value, step)] scalars: the
  batch's policy-lag mean and max, and the mean per-hop latency across
  its spans."""
  if event.get('k') != 'batch':
    return []
  step = int(event.get('step', 0))
  rows = []
  lags = event.get('lag') or []
  if lags:
    rows.append(('trace/policy_lag_mean', sum(lags) / len(lags), step))
    rows.append(('trace/policy_lag_max', float(max(lags)), step))
  deltas = {}
  for span in event.get('spans') or []:
    span_deltas, e2e = trace_report.span_hop_deltas(span)
    for (n0, n1), ms in span_deltas:
      if ms is None:  # clock-skewed cross-host hop: no fake 0 point
        continue
      deltas.setdefault(f'trace/hop_{n0}_{n1}_ms', []).append(ms)
    if e2e is not None:
      deltas.setdefault('trace/e2e_ms', []).append(e2e)
  for tag, values in deltas.items():
    rows.append((tag, sum(values) / len(values), step))
  return rows


def _fresh_writer(writer_cls, out, run):
  """A writer for `out/run`, the run's earlier event files removed:
  TensorBoard would merge two conversions and show every point twice."""
  run_dir = os.path.join(out, run)
  if os.path.isdir(run_dir):
    shutil.rmtree(run_dir)
  return writer_cls(run_dir)


def _events(path):
  """(decoded events, undecodable line count) of one JSONL file."""
  events, skipped = [], 0
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      try:
        events.append(json.loads(line))
      except json.JSONDecodeError:
        # A crashed writer can leave a truncated last line; the valid
        # events before it still convert.
        skipped += 1
  return events, skipped


def convert(logdir, out=None):
  """Convert every summary and trace stream under `logdir`; returns
  {run_name: events_written}."""
  try:
    from torch.utils.tensorboard import SummaryWriter
  except ImportError as e:
    raise ImportError(
        'scalable_agent_tpu_torch.scripts.to_tensorboard writes events '
        'through torch.utils.tensorboard, which needs the `tensorboard` '
        'package; the training path itself never requires it') from e

  out = out or os.path.join(logdir, 'tb')
  streams = sorted(glob.glob(os.path.join(logdir, '*summaries*.jsonl')))
  trace_streams = sorted(glob.glob(os.path.join(logdir, 'traces*.jsonl')))
  if not streams and not trace_streams:
    raise FileNotFoundError(
        f'no *summaries*.jsonl or traces*.jsonl under {logdir!r}')
  written = {}
  for path in trace_streams:
    base = os.path.basename(path)
    run = ('trace' if base == 'traces.jsonl'
           else 'trace_' + base[len('traces_'):].removesuffix('.jsonl'))
    writer = _fresh_writer(SummaryWriter, out, run)
    n = 0
    for event in _events(path)[0]:
      for tag, value, step in _trace_events(event):
        writer.add_scalar(tag, value, global_step=step,
                          walltime=event.get('t'))
        n += 1
    writer.close()
    written[run] = n
  for path in streams:
    run = _run_name(path)
    writer = _fresh_writer(SummaryWriter, out, run)
    events, skipped = _events(path)
    for event in events:
      step = int(event.get('step', 0))
      wall = event.get('wall_time')
      if event.get('kind') == 'histogram':
        writer.add_histogram_raw(event['tag'], global_step=step,
                                 walltime=wall, **_histogram_raw_args(event))
      else:
        writer.add_scalar(event['tag'], float(event['value']),
                          global_step=step, walltime=wall)
    writer.close()
    if skipped:
      print(f'warning: {run}: skipped {skipped} undecodable line(s) '
            f'in {path}', file=sys.stderr)
    written[run] = len(events)
  return written


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.to_tensorboard',
      description='JSONL summaries -> TensorBoard event files')
  parser.add_argument('logdir', help='run directory (has summaries.jsonl)')
  parser.add_argument('--out', default=None,
                      help='TB output dir (default: LOGDIR/tb)')
  args = parser.parse_args(argv)
  written = convert(args.logdir, args.out)
  for run, n in sorted(written.items()):
    print(f'{run}: {n} events')
  return 0


if __name__ == '__main__':
  sys.exit(main())
