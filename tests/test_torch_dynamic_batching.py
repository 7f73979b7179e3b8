"""The port's dynamic-batching API (scalable_agent_tpu_torch/ops/
dynamic_batching.py: `batch_fn`, `batch_fn_with_options`, `Batcher.
get_batch`, `family_key`, `FamilyBatcher`) against the JAX package's, and
the native stress test of the port's batcher (`ops/batcher/
batcher_test.cc`).

Each case of JAX's tests/test_dynamic_batching.py (merging, max-size
splits, the timeout flush, errors to the right caller, shape checks,
cancellation, out-of-order answers, a 48-thread stress) and the two
FamilyBatcher cases of tests/test_population.py runs once through each
package on the same inputs and returns a record: its outputs, the merged
batch sizes where the options fix them, and each error's type and
message. The two records must be equal. The stress test builds with g++
from the port's sources, plain and under ThreadSanitizer, and must exit 0.
"""

import subprocess
import threading
import time

import numpy as np
import pytest

from scalable_agent_tpu import population as jax_population
from scalable_agent_tpu.ops import dynamic_batching as jax_db
from scalable_agent_tpu_torch import population
from scalable_agent_tpu_torch.ops import build
from scalable_agent_tpu_torch.ops import dynamic_batching as db

_PACKAGES = {'jax': (jax_db, jax_population), 'port': (db, population)}


def _run_threads(fns):
  """Run callables concurrently; re-raise the first exception."""
  results = [None] * len(fns)
  errors = []

  def runner(i, fn):
    try:
      results[i] = fn()
    except Exception as e:  # noqa: BLE001 — re-raised below
      errors.append(e)

  threads = [threading.Thread(target=runner, args=(i, fn))
             for i, fn in enumerate(fns)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  if errors:
    raise errors[0]
  return results


def _error(fn):
  """(type name, message) of what `fn()` raises."""
  try:
    fn()
  except Exception as e:  # noqa: BLE001 — the record holds it
    return type(e).__name__, str(e)
  raise AssertionError('no error raised')


def _listed(out):
  if isinstance(out, tuple):
    return [(o.dtype.str, o.tolist()) for o in out]
  return (out.dtype.str, out.tolist())


# --- JAX's tests/test_dynamic_batching.py, one record per case --------


def _single_call(m, _):
  @m.batch_fn
  def f(a, b):
    return a + b
  try:
    return _listed(f(np.array([1.0]), np.array([2.0])))
  finally:
    f.close()


def _sequential_calls(m, _):
  @m.batch_fn
  def f(a):
    return a * 2
  try:
    return [_listed(f(np.array([float(i)]))) for i in range(5)]
  finally:
    f.close()


def _multiple_outputs_and_2d_rows(m, _):
  @m.batch_fn
  def f(a):
    return a + 1, (a * 2).astype(np.int32)
  try:
    return _listed(f(np.arange(6, dtype=np.float32).reshape(2, 3)))
  finally:
    f.close()


def _concurrent_calls_merge(m, _):
  batch_sizes = []

  @m.batch_fn_with_options(minimum_batch_size=2, maximum_batch_size=1024,
                           timeout_ms=5000)
  def f(a):
    batch_sizes.append(a.shape[0])
    return a * 10
  try:
    outs = _run_threads([lambda: f(np.array([1.0])),
                         lambda: f(np.array([2.0]))])
    return [_listed(o) for o in outs], batch_sizes
  finally:
    f.close()


def _each_caller_gets_its_slice(m, _):
  # JAX's case waits 5 s for a third caller's rows that may come in a
  # batch of their own (min=3 counts rows, each caller has 2); 200 ms
  # gives the same answers.
  @m.batch_fn_with_options(minimum_batch_size=3, timeout_ms=200)
  def f(a):
    return a * 2
  try:
    outs = _run_threads([lambda v=v: f(np.array([v, v], dtype=np.float64))
                         for v in (1.0, 2.0, 3.0)])
    return [_listed(o) for o in outs]
  finally:
    f.close()


def _maximum_batch_size_splits(m, _):
  batch_sizes = []

  @m.batch_fn_with_options(minimum_batch_size=2, maximum_batch_size=2,
                           timeout_ms=200)
  def f(a):
    batch_sizes.append(a.shape[0])
    return a
  try:
    outs = _run_threads([lambda v=v: f(np.array([float(v)]))
                         for v in range(4)])
    return ([_listed(o) for o in outs], sum(batch_sizes),
            max(batch_sizes) <= 2)
  finally:
    f.close()


def _timeout_flushes_partial_batch(m, _):
  @m.batch_fn_with_options(minimum_batch_size=8, timeout_ms=100)
  def f(a):
    return a + 1
  try:
    t0 = time.monotonic()
    out = f(np.array([1.0]))  # never reaches min=8
    return _listed(out), time.monotonic() - t0 < 10
  finally:
    f.close()


def _error_propagates(m, _):
  @m.batch_fn
  def f(a):
    raise ValueError('deliberate kaboom')
  try:
    return _error(lambda: f(np.array([1.0])))
  finally:
    f.close()


def _error_hits_only_its_batch(m, _):
  calls = []

  @m.batch_fn_with_options(minimum_batch_size=1, timeout_ms=10)
  def f(a):
    calls.append(a.shape[0])
    if float(a[0]) < 0:
      raise ValueError('negative!')
    return a
  try:
    return (_error(lambda: f(np.array([-1.0]))),
            _listed(f(np.array([5.0]))), calls)
  finally:
    f.close()


def _wrong_trailing_shape(m, _):
  @m.batch_fn_with_options(minimum_batch_size=1, timeout_ms=10)
  def f(a):
    return a
  try:
    first = _listed(f(np.zeros((1, 3), np.float32)))
    return (first, _error(lambda: f(np.zeros((1, 4), np.float32))),
            _error(lambda: f(np.zeros((1, 3), np.float64))))
  finally:
    f.close()


def _scalar_rejected(m, _):
  @m.batch_fn
  def f(a):
    return a
  try:
    return _error(lambda: f(np.float32(1.0)))
  finally:
    f.close()


def _rows_over_maximum(m, _):
  @m.batch_fn_with_options(maximum_batch_size=2, timeout_ms=10)
  def f(a):
    return a
  try:
    return _error(lambda: f(np.zeros((3,), np.float32)))
  finally:
    f.close()


def _close_cancels_pending(m, _):
  @m.batch_fn_with_options(minimum_batch_size=4, timeout_ms=60000)
  def f(a):
    return a

  results = []

  def caller():
    try:
      f(np.array([1.0]))
      results.append('ok')
    except m.BatcherCancelled:
      results.append('cancelled')

  t = threading.Thread(target=caller)
  t.start()
  time.sleep(0.2)  # parked waiting for min=4
  f.close()
  t.join(timeout=10)
  return results, t.is_alive()


def _compute_after_close(m, _):
  @m.batch_fn
  def f(a):
    return a
  first = _listed(f(np.array([1.0])))
  f.close()
  return first, _error(lambda: f(np.array([1.0])))


def _out_of_order_set_outputs(m, _):
  b = m.Batcher(num_tensors=1, minimum_batch_size=1, maximum_batch_size=1,
                timeout_ms=10)
  try:
    outs = {}

    def caller(v):
      def run():
        outs[v] = b.compute([np.array([v], np.float32)])[0]
      return run

    t1 = threading.Thread(target=caller(1.0))
    t1.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=caller(2.0))
    t2.start()
    b1, arr1 = b.get_batch()  # max=1: two batches, FIFO
    b2, arr2 = b.get_batch()
    b.set_outputs(b2, [arr2[0] * 100])  # the second batch first
    t2.join(timeout=10)
    first_waits = outs.get(2.0) is not None and t1.is_alive()
    b.set_outputs(b1, [arr1[0] * 100])
    t1.join(timeout=10)
    return (arr1[0].tolist(), arr2[0].tolist(), first_waits,
            _listed(outs[1.0]), _listed(outs[2.0]))
  finally:
    b.close()


def _set_outputs_wrong_rows(m, _):
  b = m.Batcher(num_tensors=1, minimum_batch_size=1, timeout_ms=10)
  caller_saw = []

  def call():
    caller_saw.append(_error(
        lambda: b.compute([np.array([1.0], np.float32)]))[0])

  t = threading.Thread(target=call)
  t.start()
  try:
    bid, _ = b.get_batch()
    return _error(lambda: b.set_outputs(bid, [np.zeros((5,), np.float32)]))
  finally:
    b.close()
    t.join(timeout=5)
    assert caller_saw == ['BatcherCancelled']


def _many_threads_many_calls(m, _):
  """48 threads x 20 calls, the reference's actor-thread regime."""
  @m.batch_fn_with_options(minimum_batch_size=8, maximum_batch_size=64,
                           timeout_ms=5)
  def f(a):
    return a * 2 + 1

  def worker(tid):
    def run():
      outs = []
      for i in range(20):
        v = float(tid * 100 + i)
        outs.append(f(np.array([v, v + 0.5])).tolist())
      return outs
    return run
  try:
    return _run_threads([worker(t) for t in range(48)])
  finally:
    f.close()


# --- tests/test_population.py's FamilyBatcher cases ------------------


def _family_batcher_routes_families(m, _):
  def make_fn(key):
    def handler(x):
      return [x.reshape(x.shape[0], -1).sum(-1)]
    return handler

  fb = m.FamilyBatcher(make_fn, minimum_batch_size=1, maximum_batch_size=64,
                       timeout_ms=5)
  small = np.full((2, 16, 16, 3), 1, np.uint8)
  large = np.full((1, 24, 32, 3), 1, np.uint8)
  outs = [_listed(fb(small)), _listed(fb(large)), _listed(fb(small))]
  stats = fb.padding_stats()
  fb.close()
  return (outs, stats, m.family_key([small]), m.family_key([large]),
          _error(lambda: fb(small)))


def _family_batcher_matches_actor_plan(m, pop):
  tasks = [('cue_memory', 2.0), ('gridworld', 1.0)]
  plan = pop.plan_actor_assignment(tasks, 6)
  frames = {0: np.zeros((1, 16, 16, 3), np.uint8),
            1: np.zeros((1, 24, 32, 3), np.uint8)}
  fb = m.FamilyBatcher(lambda key: (lambda x: [x[:, 0, 0, 0]]),
                       timeout_ms=5)
  for task in plan:
    fb(frames[task])
  stats = fb.padding_stats()
  fb.close()
  expected = pop.padding_report(
      {(16, 16, 3): plan.count(0), (24, 32, 3): plan.count(1)})
  return plan, stats, expected


_CASES = [
    _single_call, _sequential_calls, _multiple_outputs_and_2d_rows,
    _concurrent_calls_merge, _each_caller_gets_its_slice,
    _maximum_batch_size_splits, _timeout_flushes_partial_batch,
    _error_propagates, _error_hits_only_its_batch, _wrong_trailing_shape,
    _scalar_rejected, _rows_over_maximum, _close_cancels_pending,
    _compute_after_close, _out_of_order_set_outputs,
    _set_outputs_wrong_rows, _many_threads_many_calls,
    _family_batcher_routes_families, _family_batcher_matches_actor_plan,
]

# What each record must also show on its own (JAX's assertions), so that
# two packages failing the same way do not pass.
_EXPECTED = {
    '_single_call': ('<f8', [3.0]),
    '_concurrent_calls_merge': ([('<f8', [10.0]), ('<f8', [20.0])], [2]),
    '_each_caller_gets_its_slice': [
        ('<f8', [2.0, 2.0]), ('<f8', [4.0, 4.0]), ('<f8', [6.0, 6.0])],
    '_timeout_flushes_partial_batch': (('<f8', [2.0]), True),
    '_error_propagates': ('BatcherError', 'ValueError: deliberate kaboom'),
    '_scalar_rejected': (
        'ValueError',
        'batched tensors need a leading batch dim; got scalar of dtype '
        'float32'),
    '_rows_over_maximum': ('ValueError',
                           'rows=3 exceeds maximum_batch_size'),
    '_close_cancels_pending': (['cancelled'], False),
    '_set_outputs_wrong_rows': ('ValueError',
                                'output rows do not match the batch rows'),
}


@pytest.mark.parametrize('case', _CASES, ids=[c.__name__[1:] for c in _CASES])
def test_the_batching_api_matches_jax_s(case):
  records = {name: case(*modules) for name, modules in _PACKAGES.items()}
  assert records['port'] == records['jax']
  record = records['port']
  if case.__name__ in _EXPECTED:
    assert record == _EXPECTED[case.__name__]
  if case is _maximum_batch_size_splits:
    assert record[1:] == (4, True)
  if case is _many_threads_many_calls:
    assert record == [[[2 * v + 1, 2 * v + 2]
                       for v in (float(t * 100 + i) for i in range(20))]
                      for t in range(48)]
  if case is _family_batcher_routes_families:
    outs, stats, _, _, error = record
    assert outs == [('<u8', [768, 768]), ('<u8', [2304]),
                    ('<u8', [768, 768])]
    assert stats['families'] == 2 and stats['rows'] == 5
    assert stats['bucketed_bytes'] == stats['useful_bytes'] == \
        4 * 768 + 1 * 2304
    assert stats['max_shape_bytes'] == 5 * 2304
    assert error[0] == 'BatcherCancelled'
  if case is _family_batcher_matches_actor_plan:
    _, stats, expected = record
    assert stats['useful_bytes'] == expected['useful_bytes']
    assert abs(stats['waste_ratio'] - expected['waste_ratio']) < 1e-9


def test_a_batched_function_runs_on_its_named_thread_and_stops_at_close():
  seen = []

  @db.batch_fn
  def policy(a):
    seen.append(threading.current_thread().name)
    return a

  policy(np.zeros((1,), np.float32))
  thread = policy._thread
  policy.close()
  assert seen == ['batcher-policy']
  assert not thread.is_alive()


# --- batcher_test.cc ---------------------------------------------------


def _tsan_links(tmp_path) -> bool:
  src = tmp_path / 'probe.cc'
  src.write_text('int main() { return 0; }\n')
  proc = subprocess.run(
      [build._gxx(), '-fsanitize=thread', str(src), '-o',
       str(tmp_path / 'probe')], capture_output=True, text=True)
  return proc.returncode == 0


@pytest.fixture(scope='module')
def native_builds():
  """Both variants built at once; a variant that failed holds its
  error."""
  try:
    return dict(zip(('plain', 'tsan'),
                    build.build_host_tests('batcher_test',
                                           ['plain', 'tsan'])))
  except build.KernelBuildError as e:
    return {'error': e}


@pytest.mark.parametrize('variant', ['plain', 'tsan'])
def test_the_native_stress_test_passes(native_builds, variant, tmp_path):
  if 'error' in native_builds:
    if variant == 'tsan' and not _tsan_links(tmp_path):
      pytest.skip('this host\'s g++ cannot link -fsanitize=thread')
    # The other variant built, or the plain build failed: build this one
    # alone so its own error shows.
    build.build_host_tests('batcher_test', [variant])
  proc = build.run_host_test('batcher_test', variant)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert 'batcher_test: PASS' in proc.stdout
