"""Reading a torch.profiler window: the device's busy time (the union of
its kernels, copies and memsets), device time by kernel name, and the
idle gaps between device work named by what the host was doing.

`summarize(prof)` returns a plain dict that the per-layer metric
readers take; nothing here reads the program.
"""

import bisect
import collections

# Span labels the runtimes wrap around the calls into each layer.
SPAN_PREFIX = 'port_bench.'
TOP = 10
NAME_CHARS = 160  # kernel names are C++ signatures; keep their heads


def _is_device(event):
  return str(getattr(event, 'device_type', '')).endswith('CUDA')


def _union(intervals):
  """Merged, sorted [start, end] intervals (microseconds)."""
  merged = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return merged


def _host_name(host, starts, spans, at):
  """What the host was doing at time `at`: 'span:op', the innermost
  host op running then under the innermost of the benchmark's spans."""
  span = None
  for start, end, name in spans:
    if start <= at <= end:
      span = name[len(SPAN_PREFIX):]
  i = bisect.bisect_right(starts, at)
  op = None
  for start, end, name in reversed(host[max(0, i - 400):i]):
    if end >= at and not name.startswith(('cuda', SPAN_PREFIX)):
      op = name
      break
  return f'{span or "host"}:{op or "python"}'


def summarize(prof):
  """{'busy_s', 'kernels': {name: [seconds, launches]}, 'device_ops':
  [[name, seconds]] (top ten), 'idle_gaps': [[host name, seconds]] (top
  ten by summed gap time)}; busy_s is None when the trace holds no
  device event."""
  device, host = [], []
  for e in prof.events():
    start, end = e.time_range.start, e.time_range.end
    if _is_device(e):
      # The spans' own marks on the device timeline are not device work.
      if not e.name.startswith(SPAN_PREFIX):
        device.append((start, end, e.name[:NAME_CHARS]))
    else:
      host.append((start, end, e.name))
  kernels = collections.defaultdict(lambda: [0.0, 0])
  for start, end, name in device:
    kernels[name][0] += (end - start) / 1e6
    kernels[name][1] += 1
  out = {'kernels': dict(kernels),
         'device_ops': [[n, v[0]] for n, v in sorted(
             kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
         'busy_s': None, 'idle_gaps': []}
  if not device:
    return out
  merged = _union([(s, e) for s, e, _ in device])
  out['busy_s'] = sum(e - s for s, e in merged) / 1e6
  host.sort()
  starts = [s for s, _, _ in host]
  marks = [h for h in host if h[2].startswith(SPAN_PREFIX)]
  gaps = collections.defaultdict(float)
  for (_, end), (nxt, _) in zip(merged, merged[1:]):
    gaps[_host_name(host, starts, marks, end)] += (nxt - end) / 1e6
  out['idle_gaps'] = [[n, s] for n, s in sorted(
      gaps.items(), key=lambda kv: -kv[1])[:TOP]]
  return out
