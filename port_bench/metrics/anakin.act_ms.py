"""anakin.act_ms: host ms per fused step spent acting (the T policy and
bandit steps and the batch's assembly), from the benchmark's span: the
step's start to the train step's call, ended by a synchronize."""

import statistics


def read(record):
  spans = record.get('spans_ms', {}).get('act')
  return statistics.mean(spans) if spans else None
