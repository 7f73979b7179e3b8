"""device_idle.anakin: the share of a fused step in which no kernel,
copy or memset ran on the card, in %: 1 - (the union of device activity
per profiled step / the mean step time of the untimed first third of
the window, from CUDA events). The profiler slows the host-paced loop,
so its own window would overstate the idle share."""


def read(record):
  trace = record.get('trace')
  if not trace or not trace.get('busy_s'):
    return None
  return 100.0 * (1.0 - trace['busy_s'] / trace['steps'] / trace['step_s'])
