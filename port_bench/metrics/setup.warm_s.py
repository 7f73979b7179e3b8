"""setup.warm_s: seconds from the built step to the window's opening:
the recorded steps and the one after them, which warm up every shape
of the cell (cuDNN and cuBLAS plans, the V-trace kernel's build when
its library is not yet in the checkout), the last part of setup_s
(host clock)."""


def read(record):
  marks = record.get('setup_marks')
  return marks['setup'] - marks['built'] if marks else None
