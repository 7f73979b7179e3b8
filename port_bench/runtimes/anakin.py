"""The Anakin runtime: the port's fused step (`parallel/anakin.py`
`make_anakin_step`, the step `build_run` builds and `anakin.train`
loops), acting T steps on the on-device bandit and then the learner's
train step, in a closed loop on one card.

Set-up builds one step and its carry from the seed, loads the weights
the benchmark made into it, and drives it through the recorded steps
(whose batches, losses, optimizer state and parameters the reference
follows) and one more, whose end opens the window. The window runs the
same step object until `seconds` have passed on the host clock and
reads each step's end from a CUDA event; nothing is read back inside
it.

With `trace`, the window's first third runs as timed (the step time
mfu divides by), its second times acting and learning apart (a
synchronize at the train step's start and end); then `trace_steps`
steps run under torch.profiler tracing the device (busy time, kernels,
K1's time per launch), and one more with the host's ops traced too,
which names the idle gaps.
"""

import gc
import statistics
import sys
import tempfile
import time

import torch

from port_bench import check
from port_bench import counting
from port_bench import trace as trace_lib
from port_bench.reference import agent as ref_agent
from port_bench.reference import bandit
from port_bench.reference import learner as ref_learner


class Clock:
  """Step ends: CUDA events on the card, the host clock elsewhere."""

  def __init__(self, device):
    self.cuda = device.type == 'cuda'

  def sync(self):
    if self.cuda:
      torch.cuda.synchronize()

  def mark(self):
    if self.cuda:
      event = torch.cuda.Event(enable_timing=True)
      event.record()
      return event
    return time.perf_counter()

  def seconds(self, start, end):
    """Seconds between two marks, after `sync`."""
    if self.cuda:
      return start.elapsed_time(end) / 1e3
    return end - start


class Spans:
  """The benchmark's own spans around the train step: acting is the
  fused step up to it, learning the train step itself."""

  def __init__(self, clock):
    self.clock = clock
    self.timing = False     # synchronize and time act / learn
    self.labelled = False   # torch.profiler labels
    self.step_start = 0.0
    self.act_s, self.learn_s = [], []

  def wrap(self, train_step):
    def spanned(state, batch):
      if self.timing:
        self.clock.sync()
        start = time.perf_counter()
        self.act_s.append(start - self.step_start)
        out = train_step(state, batch)
        self.clock.sync()
        self.learn_s.append(time.perf_counter() - start)
        return out
      if self.labelled:
        with torch.profiler.record_function(trace_lib.SPAN_PREFIX + 'learn'):
          return train_step(state, batch)
      return train_step(state, batch)
    return spanned

  def step(self, step, carry):
    self.step_start = time.perf_counter()
    if self.labelled:
      with torch.profiler.record_function(trace_lib.SPAN_PREFIX + 'act'):
        return step(carry)
    return step(carry)


def _ref_batch(batch):
  """The program's [T+1, B] ActorOutput as the reference reads it."""
  return {'frames': batch.env_outputs.observation[0],
          'reward': batch.env_outputs.reward,
          'done': batch.env_outputs.done,
          'action': batch.agent_outputs.action.long(),
          'logits': batch.agent_outputs.policy_logits}


class AnakinRun:
  """One cell's program, from set-up to the reference's comparison."""

  def __init__(self, cell, seed: int, device, logdir: str):
    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch import learner
    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.parallel import anakin

    self.cell, self.seed = cell, seed
    self.device = driver.resolve_device(device)
    driver.set_float32_precision()
    self.config = Config(**cell['fields'], seed=seed, logdir=logdir)
    self.clock = Clock(self.device)
    self.spans = Spans(self.clock)
    env_core = anakin.make_env_core(self.config)
    agent = driver.build_agent(self.config, env_core.num_actions)
    self.step = anakin.make_anakin_step(
        agent, env_core, self.config, return_batch=True,
        train_step_fn=self.spans.wrap(
            learner.make_train_step_fn(agent, self.config)))
    self.carry = anakin.init_carry(agent, env_core, self.config, seed,
                                   self.device)
    # The benchmark's weights, from the seed: a copy goes to the program
    # (which updates it in place), the originals stay the reference's.
    self.weights = ref_agent.make_weights(cell['model'], seed, self.device)
    params = self.carry.train_state.params
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(v.shape) for k, v in self.weights.items()}
    if shapes != want:
      raise ValueError(f'the program\'s parameters {shapes} are not the '
                       f'configuration\'s {want}')
    with torch.no_grad():
      for k, p in params.items():
        p.copy_(self.weights[k])
    self.recorded = None

  def run_step(self):
    self.carry, metrics = self.spans.step(self.step, self.carry)
    return metrics

  def record(self, steps: int):
    """The first `steps` fused steps, kept for the reference: each
    batch, loss, and the parameters and RMSProp state after it."""
    batches, losses, params, nu = [], [], [], []
    for _ in range(steps):
      metrics = self.run_step()
      batches.append(_ref_batch(metrics['batch']))
      losses.append(metrics['total_loss'])
      state = self.carry.train_state
      params.append({k: v.detach().clone() for k, v in state.params.items()})
      nu.append({k: v.detach().clone() for k, v in state.opt_state.nu.items()})
    self.recorded = {
        'batches': batches,
        'program': {'logits': [b['logits'][1:] for b in batches],
                    'losses': [float(x) for x in losses],
                    'params': params, 'nu': nu}}

  def free(self):
    """Drop the program's state before the reference runs."""
    self.step = self.carry = None
    gc.collect()
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def numbers(self, control: bool = False):
    """The comparison's numbers; with `control` also the control's: the
    reference in TF32 (the nearest precision below float32 with TF32
    off) in the program's place, on the same batches."""
    rec = self.recorded
    out, ref = self._judge(rec['program'])
    out['env_errors'] = bandit.env_errors(
        rec['batches'], self.cell['fields']['episode_length'])
    out['action_z'] = bandit.action_z(rec['batches'][:1], ref['logits'][:1])
    if control:
      return out, self._judge(self._follow(tf32=True))[0]
    return out

  def _follow(self, tf32=False, starts=None):
    return ref_learner.follow(self.recorded['batches'], self.weights,
                              self.cell['model'], self.cell['hyper'],
                              self.config.frames_per_step, tf32=tf32,
                              starts=starts)

  def _judge(self, run):
    """(the gaps of `run`'s steps from the reference's, the reference's
    steps): `run` is the program's record or the control's, and each
    reference step starts from `run`'s state before it."""
    ref = self._follow(starts=list(zip(run['params'], run['nu']))[:-1])
    return check.compare(run, ref, self.cell['hyper']['decay']), ref


def _quantile(values, q):
  if len(values) < 2:
    return values[0]
  return statistics.quantiles(values, n=100, method='inclusive')[q - 1]


def _window(run, seconds):
  """Steps until `seconds` pass on the host clock; (step seconds of
  each, [step_ok tensors])."""
  marks, oks = [run.clock.mark()], []
  start = time.perf_counter()
  while True:
    metrics = run.run_step()
    marks.append(run.clock.mark())
    oks.append(metrics.get('step_ok'))
    del metrics
    if time.perf_counter() - start >= seconds:
      break
  run.clock.sync()
  return [run.clock.seconds(a, b) for a, b in zip(marks, marks[1:])], oks


def _profiled(run, steps, host_ops):
  """`steps` steps under torch.profiler: (trace summary, window
  seconds). The device's activity alone costs the host little; with
  `host_ops` the host's ops are traced too (for naming idle gaps), which
  slows a host-bound loop about twofold."""
  activities = []
  if host_ops or run.device.type != 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CPU)
  if run.device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  run.spans.labelled = host_ops
  run.clock.sync()
  with torch.profiler.profile(activities=activities) as prof:
    t0 = time.perf_counter()
    for _ in range(steps):
      run.run_step()
    run.clock.sync()
    window_s = time.perf_counter() - t0
  run.spans.labelled = False
  return trace_lib.summarize(prof), window_s


def run(cell, seed, seconds, trace, device, t0):
  """One run of an Anakin cell; see run.py for what it returns."""
  traffic = cell['traffic']
  marks = [('imported', time.perf_counter() - t0)]
  with tempfile.TemporaryDirectory(prefix='port_bench_') as logdir:
    prog = AnakinRun(cell, seed, device, logdir)
    if prog.device.type == 'cuda':
      torch.cuda.reset_peak_memory_stats()
    marks.append(('built', time.perf_counter() - t0))
    prog.record(traffic['recorded_steps'])
    prog.clock.sync()
    marks.append(('recorded', time.perf_counter() - t0))
    prog.run_step()  # its end opens the window
    prog.clock.sync()
    setup_s = time.perf_counter() - t0
    record = {'runtime': 'anakin', 'model': cell['model'],
              'fields': cell['fields'],
              'precision': cell['config']['precision'],
              'setup_marks': dict(marks, setup=setup_s)}
    if prog.device.type == 'cuda':
      record['peaks'] = counting.peaks(torch.cuda.get_device_name(0))
    device_info, breakdown = {}, None
    if not trace:
      step_s, oks = _window(prog, seconds)
    else:
      # A third of the window as timed, for mfu's step time; a third
      # with acting and learning timed apart; then the profiled steps.
      step_s, oks = _window(prog, seconds / 3)
      prog.spans.timing = True
      _, more = _window(prog, seconds / 3)
      oks += more
      prog.spans.timing = False
      summary, window_s = _profiled(prog, traffic['trace_steps'], False)
      # One more step with the host's ops traced names the idle gaps.
      summary['idle_gaps'] = _profiled(prog, 1, True)[0]['idle_gaps']
      record['spans_ms'] = {'act': [1e3 * s for s in prog.spans.act_s],
                            'learn': [1e3 * s for s in prog.spans.learn_s]}
      record['trace'] = dict(summary, window_s=window_s,
                             steps=traffic['trace_steps'],
                             step_s=statistics.mean(step_s))
      device_info = {'busy_s': summary['busy_s'], 'window_s': window_s}
      breakdown = {'device_ops': summary['device_ops'],
                   'idle_gaps': summary['idle_gaps']}
    failed = sum(1 for ok in oks if ok is not None and float(ok) == 0.0)
    peak = (torch.cuda.max_memory_allocated()
            if prog.device.type == 'cuda' else 0)
    frames = prog.config.frames_per_step
    ms = sorted(1e3 * x for x in step_s)
    print(f'port_bench: {len(ms)} window steps, ms min {ms[0]:.2f} median '
          f'{statistics.median(ms):.2f} max {ms[-1]:.2f}; set-up '
          f'{setup_s:.2f} s (' +
          ', '.join(f'{k} at {v:.2f}' for k, v in marks) + ')',
          file=sys.stderr)
    e2e = {'setup_s': setup_s,
           'env_frames_per_s': len(step_s) * frames / sum(step_s),
           'step_ms.p90': 1e3 * _quantile(step_s, 90),
           'peak_device_gib': peak / 2**30}
    prog.free()
    numbers = prog.numbers()
  return {'e2e': e2e, 'record': record, 'numbers': numbers,
          'attempted': len(oks), 'failed': failed,
          'memory_peak_bytes': peak, 'device': device_info,
          'breakdown': breakdown}
