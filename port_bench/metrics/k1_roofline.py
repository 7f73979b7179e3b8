"""k1_roofline: the V-trace kernel's (K1, csrc/vtrace.cu) share of its
roofline, in %: the least time its bytes at [T, B] take at the card's
HBM rate (counting.k1_bytes: each input read once, each output written
once; its FLOPs bound it far less) over its device time per launch in
the profiler's trace. None when the trace holds no K1 launch."""

from port_bench import counting

KERNEL = 'vtrace_kernel'


def read(record):
  trace, peaks = record.get('trace'), record.get('peaks')
  if not trace or not peaks:
    return None
  hits = [v for name, v in trace['kernels'].items() if KERNEL in name]
  launches = sum(n for _, n in hits)
  if not launches:
    return None
  per_launch = sum(s for s, _ in hits) / launches
  fields = record['fields']
  least = counting.k1_bytes(fields['unroll_length'],
                            fields['batch_size']) / peaks['hbm_bytes_per_s']
  return 100.0 * least / per_launch
