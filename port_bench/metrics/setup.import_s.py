"""setup.import_s: seconds from the process's start until torch and the
port are imported, the first part of setup_s (host clock)."""


def read(record):
  marks = record.get('setup_marks')
  return marks['imported'] if marks else None
