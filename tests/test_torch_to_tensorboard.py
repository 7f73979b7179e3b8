"""The port's TensorBoard converter (scalable_agent_tpu_torch/scripts/
to_tensorboard.py) against the JAX package's scripts/to_tensorboard.py.

One run directory made from a numpy seed: summaries.jsonl written by the
port's SummaryWriter (scalars and action histograms without edges, and
histograms with `edges`), summaries_p3.jsonl, eval_summaries.jsonl and
the two trace streams of tests/test_torch_trace_report.py. Both tools
convert it into separate output directories, read back with
TensorBoard's EventAccumulator: the same runs, and per run the same
scalars (tag, step, value, wall time) and the same histograms (step,
wall time, min, max, num, sum, sum of squares, bucket limits and
counts). A missing directory raises FileNotFoundError in both, a
truncated last line is skipped with the same warning, the run names
agree, and without `tensorboard` the port's converter raises an
ImportError that names the package.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

tb_accumulator = pytest.importorskip(
    'tensorboard.backend.event_processing.event_accumulator')

from scalable_agent_tpu_torch import observability  # noqa: E402
from scalable_agent_tpu_torch.scripts import to_tensorboard  # noqa: E402
from scripts import to_tensorboard as jax_to_tensorboard  # noqa: E402
from test_torch_trace_report import write_run  # noqa: E402

BOTH = {'jax': jax_to_tensorboard, 'port': to_tensorboard}


def _write_summaries(logdir, seed):
  rng = np.random.RandomState(seed)
  train = observability.SummaryWriter(logdir)
  p3 = observability.SummaryWriter(logdir, filename='summaries_p3.jsonl')
  for step in range(0, 60, 3):
    for writer in (train, p3):
      writer.scalar('loss/total', float(rng.randn()), step)
      writer.scalar('cue_memory/episode_return', float(rng.uniform(0, 3)),
                    step)
    train.histogram('actions', rng.randint(0, 9, size=rng.randint(3, 10)),
                    step)
  train.histogram('empty_actions', np.zeros(4, np.int64), 60)
  train.close()
  p3.close()
  ev = observability.SummaryWriter(logdir, filename='eval_summaries.jsonl')
  ev.scalar('cue_memory/test_episode_return', 2.5, step=60)
  ev.close()
  # Histograms with bin edges, as JAX's value histograms carry them.
  with open(train.path, 'a') as f:
    for step in (10, 20):
      edges = np.sort(rng.randn(6)).tolist()
      f.write(json.dumps({
          'wall_time': 1.7e9 + step, 'step': step, 'tag': 'values',
          'kind': 'histogram', 'edges': edges,
          'counts': rng.randint(0, 5, size=5).tolist()}) + '\n')


def _read(out):
  """{run: {'scalars': {tag: [...]}, 'histograms': {tag: [...]}}}."""
  runs = {}
  for run in sorted(os.listdir(out)):
    acc = tb_accumulator.EventAccumulator(
        os.path.join(out, run), size_guidance={tb_accumulator.SCALARS: 0,
                                               tb_accumulator.HISTOGRAMS: 0})
    acc.Reload()
    tags = acc.Tags()
    runs[run] = {
        'scalars': {tag: [(e.step, e.value, e.wall_time)
                          for e in acc.Scalars(tag)]
                    for tag in sorted(tags['scalars'])},
        'histograms': {tag: [
            (e.step, e.wall_time, e.histogram_value.min,
             e.histogram_value.max, e.histogram_value.num,
             e.histogram_value.sum, e.histogram_value.sum_squares,
             list(e.histogram_value.bucket_limit),
             list(e.histogram_value.bucket))
            for e in acc.Histograms(tag)]
            for tag in sorted(tags['histograms'])},
    }
  return runs


@pytest.fixture(scope='module')
def converted(tmp_path_factory):
  logdir = str(tmp_path_factory.mktemp('run'))
  write_run(logdir, seed=3)
  _write_summaries(logdir, seed=3)
  written, read = {}, {}
  for name, tool in BOTH.items():
    out = os.path.join(logdir, f'tb_{name}')
    written[name] = tool.convert(logdir, out)
    read[name] = _read(out)
  return written, read


def test_both_write_the_same_runs_and_counts(converted):
  written, read = converted
  assert written['port'] == written['jax']
  assert set(written['port']) == {'train', 'train_p3', 'eval', 'trace',
                                  'trace_p1'}
  assert sorted(read['port']) == sorted(read['jax']) == sorted(
      written['port'])


@pytest.mark.parametrize('run', ['train', 'train_p3', 'eval', 'trace',
                                 'trace_p1'])
def test_each_run_reads_back_as_jax_s(converted, run):
  _, read = converted
  port, jax = read['port'][run], read['jax'][run]
  assert port == jax
  assert port['scalars']
  if run == 'train':
    assert {'actions', 'empty_actions', 'values'} == set(port['histograms'])
  if run.startswith('trace'):
    assert {'trace/policy_lag_mean', 'trace/e2e_ms'} <= set(port['scalars'])


def test_reconverting_replaces_the_event_files(tmp_path):
  _write_summaries(str(tmp_path), seed=4)
  for _ in range(2):
    to_tensorboard.convert(str(tmp_path))
  assert len(os.listdir(tmp_path / 'tb' / 'train')) == 1


@pytest.mark.parametrize('filename', [
    'summaries.jsonl', 'summaries_p3.jsonl', 'eval_summaries.jsonl',
    'eval_summaries_p1.jsonl', 'other.jsonl'])
def test_run_names_equal_jax_s(filename):
  path = os.path.join('/x', filename)
  assert to_tensorboard._run_name(path) == jax_to_tensorboard._run_name(path)


@pytest.mark.parametrize('name', sorted(BOTH))
def test_a_missing_directory_raises(tmp_path, name):
  with pytest.raises(FileNotFoundError):
    BOTH[name].convert(str(tmp_path / 'nope'))


def test_a_truncated_final_line_is_skipped_as_in_jax(tmp_path):
  results = {}
  for name, tool in BOTH.items():
    logdir = tmp_path / name
    writer = observability.SummaryWriter(str(logdir))
    writer.scalar('loss/total', 1.0, step=1)
    writer.close()
    with open(writer.path, 'a') as f:
      f.write('{"tag": "loss/total", "va')  # truncated mid-write
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
      written = tool.convert(str(logdir))
    results[name] = (written, err.getvalue().replace(str(logdir), 'LOGDIR'))
  assert results['port'] == results['jax']
  assert results['port'][0] == {'train': 1}
  assert 'skipped 1 undecodable line' in results['port'][1]


def test_without_tensorboard_the_port_names_the_package(tmp_path,
                                                        monkeypatch):
  _write_summaries(str(tmp_path), seed=5)
  monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
  with pytest.raises(ImportError, match='`tensorboard` package'):
    to_tensorboard.convert(str(tmp_path))
  assert not os.path.exists(tmp_path / 'tb')
