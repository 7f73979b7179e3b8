"""device_busy_ms.anakin: ms per fused step in which a kernel, copy or
memset ran on the card (the union of device activity over the profiled
steps, per step). The host paces the loop, so env_frames_per_s swings
with the host's speed; this reads the device's share of the step alone,
which a kernel or layout gain lowers whatever the host does."""


def read(record):
  trace = record.get('trace')
  if not trace or not trace.get('busy_s'):
    return None
  return 1e3 * trace['busy_s'] / trace['steps']
