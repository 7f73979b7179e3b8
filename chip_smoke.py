#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

  python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device  — assert CUDA, print the card's name and power limit
             (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader).
2. build   — build every CUDA kernel of the port with nvcc, one process per
             source, all at once.
3. kernels — the fused V-trace kernel against its plain twin on the card at
             [100, 32] (the learner's shape), [7, 300] and [6, 70, 3], for
             three threshold pairs, rtol 1e-5 / atol 1e-6; its median time
             over 200 launches (CUDA events), the twin's, and the bound.
4. slice   — the port's Anakin trainer at the full width of the reference's
             deep agent (72x96 frames, T=100, B=32, 9 actions, deep torso,
             LSTM 256, float32, fused V-trace) for 4 fused steps through
             `anakin.run`: finite losses, update_steps == 4, changed
             params, and exactly one V-trace kernel launch per step. Then
             the train step on a small fixed batch on the card against the
             same step on the CPU (the kernels' plain twins).
5. cli     — `python -m scalable_agent_tpu_torch.experiment --mode=anakin`
             for 2 full-width steps into a temporary logdir; its
             summaries.jsonl must hold a finite total_loss.
6. conv_pool — the fused conv3x3+max-pool kernel (K2) against its plain
             twin at [3232, 72, 96] (the learner's (T+1)*B frames),
             [32, 72, 96] (the acting batch) and [5, 21, 27] (odd sizes),
             nonzero bias, max|kernel - plain| <= 2**-7 * max|plain|; the
             count of elements that differ at all; the median time over 50
             launches of the kernel, the twin and cuDNN's conv + pool
             (`library_conv_pool`), and the bound.
7. conv_pool_torso — K2 against the port's bf16 deep torso's section 1
             (`sections[0].conv`, then `max_pool_same`) on the section's
             own weights, on [32, 72, 96] frames.
8. slice_bf16, slice_bf16_reference, cli_bf16 — phases 4 and 5 at
             compute_dtype='bfloat16'; params and optimizer state stay
             float32, and the card-vs-CPU train step is held at the bf16
             tolerance of tests/test_torch_bf16.py.
9. conv_pool_entry — K2's entry point, `python -m
             scalable_agent_tpu_torch.scripts.conv_pool`, at its card
             shape [3232, 72, 96].

Every kernel's launch count is set to 0 just before each path (the two
slices and the K2 entry point) and read just after; a kernel that its path
did not launch fails the run. The second-to-last line of the output is the
JSON `{"kernels": [...]}` record, the last `{"ok": true, "device": {...}}`.
Without CUDA, or run outside the repo, it exits non-zero before printing
either.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The port first: outside the repo this import fails before any output.
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.models.torsos import max_pool_same, scaled_nchw
from scalable_agent_tpu_torch.observability import cuda_median_ms
from scalable_agent_tpu_torch.ops import build
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.profile_anakin import SLICE
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (the V-trace kernel is scalar float32 code).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per element of [T, N] the kernel does one exp, three minimums and about
# twelve adds and multiplies.
VTRACE_OPS_PER_ELEMENT = 16

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6

SLICE_STEPS = 4

CONV_POOL_SHAPES = [(3232, 72, 96), (32, 72, 96), (5, 21, 27)]

# Launch counters of every kernel of the port, by kernel name.
COUNTERS = {'vtrace': vtrace_cuda.from_importance_weights,
            'conv_pool': conv_pool_cuda.fused_conv_pool}


def log(*args):
  print(*args, flush=True)


def phase_device():
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  log(f'torch {torch.__version__} cuda {torch.version.cuda} '
      f'device 0: {torch.cuda.get_device_name(0)} '
      f'count {torch.cuda.device_count()}')
  return card


def phase_build():
  t0 = time.perf_counter()
  paths = build.build_all()
  log(f'build: {len(paths)} kernel libraries in '
      f'{time.perf_counter() - t0:.2f} s: '
      + ', '.join(os.path.relpath(p) for p in paths))


def _vtrace_inputs(shape, seed):
  rng = np.random.RandomState(seed)
  arrays = dict(
      log_rhos=rng.randn(*shape) * 0.8,
      discounts=0.99 * (rng.rand(*shape) > 0.1),
      rewards=rng.randn(*shape),
      values=rng.randn(*shape),
      bootstrap_value=rng.randn(*shape[1:]))
  return {k: torch.tensor(v, dtype=torch.float32, device='cuda')
          for k, v in arrays.items()}


def _vtrace_bound_ms(shape):
  t, n = shape[0], math.prod(shape[1:])
  nbytes = 4 * (4 * t * n + n + 2 * t * n)
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = VTRACE_OPS_PER_ELEMENT * t * n / F32_OPS_PER_S * 1e3
  return (max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms
          else 'operations', nbytes)


def phase_kernels():
  """V-trace kernel vs its plain twin; returns the record at [100, 32]."""
  record = None
  worst = 0.0
  for seed, shape in enumerate([(100, 32), (7, 300), (6, 70, 3)]):
    for clips in [(1.0, 1.0), (None, None), (3.7, 2.2)]:
      x = _vtrace_inputs(shape, seed)
      kw = dict(clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
      vs, pg = vtrace_cuda.from_importance_weights(**x, **kw)
      torch.cuda.synchronize()
      ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(**x, **kw)
      torch.testing.assert_close(vs, ref_vs, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL)
      torch.testing.assert_close(pg, ref_pg, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL)
      err = max(float((vs - ref_vs).abs().max()),
                float((pg - ref_pg).abs().max()))
      worst = max(worst, err)
      ms = cuda_median_ms(
          lambda: vtrace_cuda.from_importance_weights(**x, **kw), 200)
      plain_ms = cuda_median_ms(
          lambda: vtrace_cuda.plain_from_importance_weights(**x, **kw), 30)
      bound_ms, bound_by, nbytes = _vtrace_bound_ms(shape)
      log(f'vtrace {list(shape)} clips={clips}: max_abs_err {err:.3e} '
          f'kernel {ms:.5f} ms plain {plain_ms:.5f} ms bound '
          f'{bound_ms:.3e} ms ({bound_by}, {nbytes} bytes)')
      if shape == (100, 32) and clips == (1.0, 1.0):
        record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
  record['max_abs_err'] = worst
  return record


def _param_snapshot(params):
  return {k: v.detach().to('cpu', copy=True) for k, v in params.items()}


def _drive(path, fn):
  """Run one path with every launch count set to 0 just before it;
  returns (fn's result, the counts just after)."""
  for counter in COUNTERS.values():
    counter.launches = 0
  out = fn()
  counts = {name: counter.launches for name, counter in COUNTERS.items()}
  log(f'{path}: kernel launches {counts}')
  return out, counts


def phase_slice(compute_dtype='float32'):
  log(f'slice at compute_dtype={compute_dtype}; float32 layers without '
      f'TF32: torch.backends.cudnn.allow_tf32='
      f'{torch.backends.cudnn.allow_tf32} '
      f'torch.backends.cuda.matmul.allow_tf32='
      f'{torch.backends.cuda.matmul.allow_tf32}')
  config = Config(**SLICE, compute_dtype=compute_dtype)
  # The same seed initialises the same params on any device (a CPU
  # generator), so this snapshot is the run's initial params.
  _, _, _, cpu_carry = anakin.build_run(config, device='cpu')
  initial = _param_snapshot(cpu_carry.train_state.params)

  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  (carry, history, fps), counts = _drive(
      f'slice {compute_dtype}',
      lambda: anakin.run(config, SLICE_STEPS, device='cuda'))
  wall = time.perf_counter() - t0
  launches = counts['vtrace']

  losses = [h['total_loss'] for h in history]
  if not all(math.isfinite(v) for v in losses):
    raise AssertionError(f'non-finite losses: {losses}')
  if carry.train_state.update_steps != SLICE_STEPS:
    raise AssertionError(f'update_steps {carry.train_state.update_steps}')
  if launches != SLICE_STEPS:
    raise AssertionError(f'V-trace kernel launched {launches} times in '
                         f'{SLICE_STEPS} fused steps')
  state = carry.train_state
  not_f32 = [k for tree in (state.params, state.opt_state.nu)
             for k, v in tree.items() if v.dtype != torch.float32]
  not_f32 += [f'core_state[{i}]' for i, v in enumerate(carry.core_state)
              if v.dtype != torch.float32]
  if not_f32:
    raise AssertionError(f'not float32 after training: {not_f32}')
  final = _param_snapshot(carry.train_state.params)
  moved = max(float((final[k] - initial[k]).abs().max()) for k in final)
  if not moved > 0:
    raise AssertionError('params did not change')
  step_ms = config.frames_per_step / fps * 1e3
  log(f'slice {compute_dtype}: {SLICE_STEPS} fused steps in {wall:.2f} s '
      f'(first one untimed); losses {losses}; mean_reward '
      f'{[h["mean_reward"] for h in history]}; max |param change| '
      f'{moved:.3e}; vtrace launches {launches}')
  log(f'slice {compute_dtype}: {fps:.1f} env-frames/s, {step_ms:.2f} ms '
      f'per fused step ({config.frames_per_step} frames), '
      f'max_memory_allocated '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
  return counts


def _small_batch(t, b, a, h, w, seed=0):
  rng = np.random.RandomState(seed)
  tensor = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
  return ActorOutput(
      level_name=torch.zeros(b, dtype=torch.int32),
      agent_state=(tensor(rng.randn(b, 256).astype(np.float32) * 0.3),
                   tensor(rng.randn(b, 256).astype(np.float32) * 0.3)),
      env_outputs=StepOutput(
          tensor(rng.randn(t + 1, b).astype(np.float32)),
          StepOutputInfo(torch.zeros(t + 1, b),
                         torch.zeros(t + 1, b, dtype=torch.int32)),
          tensor(rng.rand(t + 1, b) > 0.8),
          (tensor(rng.randint(0, 256, (t + 1, b, h, w, 3)).astype(
              np.uint8)),
           torch.zeros(t + 1, b, 16, dtype=torch.int32))),
      agent_outputs=AgentOutput(
          tensor(rng.randint(0, a, (t + 1, b))),
          tensor(rng.randn(t + 1, b, a).astype(np.float32)),
          tensor(rng.randn(t + 1, b).astype(np.float32))))


def _train_small_batch(config, device, steps=2):
  """`steps` train steps on the fixed small batch from the config's seeded
  params: (losses, initial params, final params) on the CPU."""
  _, agent, _, carry = anakin.build_run(config, device=device)
  step = learner.make_train_step_fn(agent, config)
  state = carry.train_state
  initial = _param_snapshot(state.params)
  batch = map_structure(lambda x: x.to(device),
                        _small_batch(5, 3, 9, 24, 32))
  losses = []
  for _ in range(steps):
    state, metrics = step(state, batch)
    losses.append(float(metrics['total_loss']))
  return np.asarray(losses), initial, _param_snapshot(state.params)


def _small_config(compute_dtype):
  return Config(**dict(SLICE, height=24, width=32, batch_size=3,
                       unroll_length=5, num_action_repeats=1,
                       total_environment_frames=100,
                       compute_dtype=compute_dtype))


def phase_slice_reference():
  """Two train steps on a fixed small batch, card vs CPU, from the same
  params: the card runs the CUDA kernel, the CPU its plain twin. Loss
  rtol 1e-4, params rtol 1e-3 / atol 1e-5 (float32 convolutions summed in
  another order, through RMSProp's 1/sqrt)."""
  config = _small_config('float32')
  cpu_losses, _, cpu_params = _train_small_batch(config, 'cpu')
  gpu_losses, _, gpu_params = _train_small_batch(config, 'cuda')
  np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
  err = 0.0
  for k in cpu_params:
    np.testing.assert_allclose(gpu_params[k].numpy(), cpu_params[k].numpy(),
                               rtol=1e-3, atol=1e-5, err_msg=k)
    err = max(err, float((gpu_params[k] - cpu_params[k]).abs().max()))
  log(f'slice reference: losses card {gpu_losses.tolist()} cpu '
      f'{cpu_losses.tolist()}; max |param diff| {err:.3e}')


def _within_bf16_error(got, ref16, ref32, what, atol=1e-3, rtol=2**-5):
  """tests/test_torch_bf16.py's bar, with the CPU as the reference:
  max|got - ref16| <= 2 max|ref16 - ref32| + atol and <= rtol max|ref32|.
  Returns max|got - ref16|."""
  got, ref16, ref32 = (np.asarray(x, np.float32) for x in (got, ref16, ref32))
  err = float(np.max(np.abs(got - ref16)))
  bound = min(2 * float(np.max(np.abs(ref16 - ref32))) + atol,
              rtol * float(np.max(np.abs(ref32))))
  if not err <= bound:
    raise AssertionError(f'{what}: max|card_bf16 - cpu_bf16| {err} > '
                         f'{bound}')
  return err


def phase_slice_bf16_reference():
  """The bf16 train step, card vs CPU, on the fixed small batch: held as
  tests/test_torch_bf16.py holds the port to JAX, with the CPU's bf16 and
  float32 runs as the reference pair. Loss: max|card - cpu_bf16| <=
  2 max|cpu_bf16 - cpu_f32| + 1e-3 and <= 2**-5 max|cpu_f32|. Parameter
  updates: the same with 1e-3 of the largest float32 update in place of
  1e-3, and 0.25 in place of 2**-5."""
  cpu32_losses, initial, cpu32 = _train_small_batch(
      _small_config('float32'), 'cpu')
  config = _small_config('bfloat16')
  cpu16_losses, _, cpu16 = _train_small_batch(config, 'cpu')
  gpu16_losses, _, gpu16 = _train_small_batch(config, 'cuda')
  loss_err = _within_bf16_error(gpu16_losses, cpu16_losses, cpu32_losses,
                                'total_loss')
  update_err = 0.0
  for k in initial:
    moved32 = cpu32[k] - initial[k]
    update_err = max(update_err, _within_bf16_error(
        gpu16[k] - initial[k], cpu16[k] - initial[k], moved32, k,
        atol=1e-3 * float(moved32.abs().max()), rtol=0.25))
  log(f'slice_bf16 reference: losses card {gpu16_losses.tolist()} cpu '
      f'bf16 {cpu16_losses.tolist()} cpu f32 {cpu32_losses.tolist()}; max '
      f'|update diff| card vs cpu bf16 {update_err:.3e}; loss diff '
      f'{loss_err:.3e}')


def phase_conv_pool():
  """K2 against its plain twin at the three shapes, and its times."""
  record = None
  worst = 0.0
  for seed, shape in enumerate(CONV_POOL_SHAPES):
    frames, weight, bias = conv_pool_script.make_inputs(*shape, 'cuda',
                                                        seed=seed)
    out = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
    torch.cuda.synchronize()
    check = conv_pool_script.parity(
        out, conv_pool_cuda.plain_conv_pool(frames, weight, bias))
    worst = max(worst, check['max_abs_err'])
    times = conv_pool_script.timings(frames, weight, bias)
    log(f'conv_pool {list(shape)}: max_abs_err {check["max_abs_err"]:.3e} '
        f'(tolerance {2**-7 * check["scale"]:.3e}), {check["n_differ"]} of '
        f'{out.numel()} elements differ; kernel {times["ms"]:.5f} ms plain '
        f'{times["plain_ms"]:.5f} ms library {times["library_ms"]:.5f} ms '
        f'bound {times["bound_ms"]:.5f} ms ({times["bound_by"]}, '
        f'{times["bytes"]} bytes, {times["flops"]} FLOP)')
    if shape == CONV_POOL_SHAPES[0]:
      record = times
  record['max_abs_err'] = worst
  return record


def phase_conv_pool_torso():
  """K2 computes the bf16 trainer's section 1: against the port's bf16
  deep torso (`sections[0].conv`, then `max_pool_same`) on the section's
  own weights, with a nonzero bias, at the acting batch [32, 72, 96].
  The torso rounds its conv before adding the bias, K2 after pooling;
  max commutes with both roundings, so the two differ by the conv's
  summation order: one bf16 ulp of the pre-bias value plus one of the
  output, max|K2 - torso| <= 2**-7 * (2 max|torso| + max|b|)."""
  config = Config(**SLICE, compute_dtype='bfloat16')
  agent = driver.build_agent(config, SLICE['num_actions'])
  generator = torch.Generator().manual_seed(config.seed)
  init_params(agent, generator)
  conv = agent.torso.sections[0].conv
  with torch.no_grad():
    conv.bias.copy_(torch.randn(conv.bias.shape, generator=generator) * 0.3)
  agent.to('cuda')
  frames, _, _ = conv_pool_script.make_inputs(32, 72, 96, 'cuda', seed=7)
  with torch.no_grad():
    x = scaled_nchw(frames, torch.bfloat16)
    ref = max_pool_same(conv(x)).permute(0, 2, 3, 1).float()
    got = conv_pool_cuda.fused_conv_pool(frames, conv.weight,
                                         conv.bias).float()
  err = float((got - ref).abs().max())
  tol = 2**-7 * (2 * float(ref.abs().max()) +
                 float(conv.bias.detach().abs().max()))
  if not err <= tol:
    raise AssertionError(f'K2 vs bf16 torso section 1: {err} > {tol}')
  log(f'conv_pool vs bf16 torso section 1 [32, 72, 96]: max_abs_err '
      f'{err:.3e} (tolerance {tol:.3e}), {int((got != ref).sum())} of '
      f'{got.numel()} elements differ')


def phase_conv_pool_entry():
  """K2's entry point at its card shape: the path that launches K2."""
  _, counts = _drive('conv_pool entry point',
                     lambda: conv_pool_script.main([]))
  if counts['conv_pool'] < 1 or counts['vtrace'] != 0:
    raise AssertionError(f'conv_pool entry point launches {counts}')
  return counts


def phase_cli(compute_dtype='float32'):
  config = Config(**SLICE)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as logdir:
    cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=anakin', f'--logdir={logdir}', '--summary_secs=0',
           f'--total_environment_frames={2 * config.frames_per_step}',
           f'--compute_dtype={compute_dtype}']
    for field, value in SLICE.items():
      cmd.append(f'--{field}={value}')
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'CLI failed ({proc.returncode}):\n{proc.stderr}')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if not losses or not all(math.isfinite(v) for v in losses):
    raise AssertionError(f'CLI total_loss: {losses}')
  log(f'cli {compute_dtype}: 2 steps in {time.perf_counter() - t0:.1f} s, '
      f'total_loss {losses}')


def main():
  phases = []

  def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    phases.append((name, time.perf_counter() - t0))
    return out

  timed('device', phase_device)
  # Float32 layers run without TF32 (the float32 slice is held to the
  # CPU's float32); K2's twin is unaffected, bf16 values being exact in
  # TF32.
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  timed('build', phase_build)
  k1 = timed('kernels', phase_kernels)
  k2 = timed('conv_pool', phase_conv_pool)
  timed('conv_pool_torso', phase_conv_pool_torso)
  paths = {}
  paths['slice'] = timed('slice', phase_slice)
  timed('slice_reference', phase_slice_reference)
  timed('cli', phase_cli)
  paths['slice_bf16'] = timed('slice_bf16', phase_slice, 'bfloat16')
  timed('slice_bf16_reference', phase_slice_bf16_reference)
  timed('cli_bf16', phase_cli, 'bfloat16')
  paths['conv_pool_entry'] = timed('conv_pool_entry', phase_conv_pool_entry)
  log('phases: ' + ', '.join(f'{n} {s:.1f} s' for n, s in phases))
  launches = {name: {path: counts[name] for path, counts in paths.items()}
              for name in COUNTERS}
  for name, by_path in launches.items():
    if not sum(by_path.values()):
      raise AssertionError(f'{name} was launched on no path: {by_path}')
  vtrace = dict(
      name='vtrace', route='cuda',
      source='scalable_agent_tpu_torch/csrc/vtrace.cu',
      replaces='scalable_agent_tpu/ops/vtrace_pallas.py:58',
      launches=sum(launches['vtrace'].values()),
      launches_by_path=launches['vtrace'],
      max_abs_err=k1['max_abs_err'], ms=k1['ms'],
      plain_ms=k1['plain_ms'], bound_ms=k1['bound_ms'],
      bound_by=k1['bound_by'], library_ms=None,
      ok=True, max_err=k1['max_abs_err'], kernel_ms=k1['ms'])
  conv_pool = dict(
      name='conv_pool', route='cuda',
      source='scalable_agent_tpu_torch/csrc/conv_pool.cu',
      replaces='scripts/pallas_conv_pool.py:66',
      launches=sum(launches['conv_pool'].values()),
      launches_by_path=launches['conv_pool'],
      max_abs_err=k2['max_abs_err'], ms=k2['ms'],
      plain_ms=k2['plain_ms'], bound_ms=k2['bound_ms'],
      bound_by=k2['bound_by'], library_ms=k2['library_ms'],
      ok=True, max_err=k2['max_abs_err'], kernel_ms=k2['ms'])
  print(json.dumps({'kernels': [vtrace, conv_pool]}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
