"""pytest settings of port_bench's own tests: the marker of the tests
that need an NVIDIA card (they skip without one)."""


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'requires_cuda: needs an NVIDIA card; skips on a '
      'machine without CUDA')
