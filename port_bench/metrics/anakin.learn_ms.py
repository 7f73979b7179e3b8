"""anakin.learn_ms: host ms per fused step in the train step (unroll,
V-trace, losses, RMSProp), between two synchronizes."""

import statistics


def read(record):
  spans = record.get('spans_ms', {}).get('learn')
  return statistics.mean(spans) if spans else None
