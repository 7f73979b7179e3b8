"""setup.build_s: seconds spent building the fused step, its carry and
the weights from the seed, the second part of setup_s (host clock)."""


def read(record):
  marks = record.get('setup_marks')
  return marks['built'] - marks['imported'] if marks else None
