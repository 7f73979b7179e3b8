"""The profiler window's reading: busy time as the union of device
work, kernels by name, and idle gaps named by the host's op and span."""

import collections

import pytest

from port_bench import trace

Range = collections.namedtuple('Range', 'start end')


class Event:

  def __init__(self, name, start, end, device=False):
    self.name, self.time_range = name, Range(start, end)
    self.device_type = 'DeviceType.CUDA' if device else 'DeviceType.CPU'


class Prof:

  def __init__(self, events):
    self._events = events

  def events(self):
    return self._events


def test_busy_kernels_and_gaps():
  prof = Prof([
      Event('port_bench.act', 0, 100),
      Event('aten::conv2d', 5, 20),
      Event('cudaLaunchKernel', 18, 19),
      Event('port_bench.learn', 60, 100),
      Event('aten::mm', 65, 70),
      # Device work, microseconds: two overlapping kernels count once.
      Event('conv_kernel', 10, 30, device=True),
      Event('conv_kernel', 25, 40, device=True),
      Event('gemm', 70, 80, device=True),
      # The spans' own marks on the device timeline are not work.
      Event('port_bench.learn', 60, 100, device=True),
  ])
  out = trace.summarize(prof)
  approx = lambda x: pytest.approx(x, rel=1e-12)  # noqa: E731
  assert out['busy_s'] == approx((30 + 10) / 1e6)
  assert out['kernels']['conv_kernel'] == [approx(35 / 1e6), 2]
  assert out['device_ops'][0] == ['conv_kernel', approx(35 / 1e6)]
  # The one gap, 40..70 us, starts while the act span runs and no op.
  assert out['idle_gaps'] == [['act:python', approx(30 / 1e6)]]


def test_a_trace_without_device_work_reads_none():
  out = trace.summarize(Prof([Event('aten::add', 0, 5)]))
  assert out['busy_s'] is None and out['idle_gaps'] == []
