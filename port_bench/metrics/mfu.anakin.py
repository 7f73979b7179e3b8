"""mfu.anakin: the fused step's model FLOPs (counting.anakin_step_flops:
the acting forward over T*B frames and the learner's 3x forward over
(T+1)*B) over the mean step time of the window's untraced first third
(CUDA events) times the card's peak in the configuration's precision,
in %."""

from port_bench import counting


def read(record):
  trace, peaks = record.get('trace'), record.get('peaks')
  if not trace or not peaks or not trace.get('busy_s'):
    return None
  fields = record['fields']
  flops = counting.anakin_step_flops(record['model'], fields['batch_size'],
                                     fields['unroll_length'])
  peak = peaks['flops_per_s'][record['precision']]
  return 100.0 * flops / (trace['step_s'] * peak)
