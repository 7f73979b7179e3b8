"""The CUDA kernels' layouts, on the CPU: what ops/vtrace_cuda.py and
ops/conv_pool_cuda.py compute in Python for csrc/vtrace.cu and
csrc/conv_pool.cu to launch with, and the design claims the kernels rest
on. The kernels themselves run only on the card (tests/test_torch_cuda.py);
these pin their launch geometry, shared-memory layout and arithmetic order
here.

- vtrace_cuda.launch_geometry: every column in exactly one block, every
  time step in exactly one chunk, shared memory within what an H100 block
  may use; and a Python model of the kernel's chunked pre-pass, walk and
  post-pass is bit-equal to the plain twin.
- conv_pool_cuda.launch_geometry: the bands and tiles cover every pooled
  output once, within the shared-memory cap and the kernel's thread needs.
- conv_pool_cuda.pack_weight: an im2col of the bf16 frames in the kernel's
  K order (k_element) times the packed weight is the twin's pre-pool conv,
  within float32 summation tolerance (rtol 1e-5, atol 1e-5: the same bf16
  products summed in another order); rows 25, 27, 29, 30 and 31 are zero.
- The window layout puts the 32 lanes of every A load of the mma on 32
  shared-memory banks.
- x = bf16(u * (1/255)) is bf16(u / 255) for every byte, and the SAME
  max-pool with -inf pads equals the pool over indices clamped into the
  image (what K2 computes).
"""

import math

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.torsos import max_pool_same, scaled_nchw
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import vtrace_cuda

torch.set_num_threads(1)

H100_BLOCK_SHARED_BYTES = 232448
T_LENS = [1, 100, 257, 1000]
N_COLS = [1, 16, 32, 210, 4096]


def _chunks(geometry, t_len):
  """The kernel's chunks as (t0, rows), from the end of time: chunk k holds
  [T - k*chunk - rows, T - k*chunk)."""
  out = []
  for k in range(-(-t_len // geometry.chunk)):
    rows = min(geometry.chunk, t_len - k * geometry.chunk)
    out.append((t_len - k * geometry.chunk - rows, rows))
  return out


@pytest.mark.parametrize('n_cols', N_COLS)
@pytest.mark.parametrize('t_len', T_LENS)
def test_vtrace_geometry_covers_every_column_and_step_once(t_len, n_cols):
  g = vtrace_cuda.launch_geometry(t_len, n_cols)
  assert g.cols in (4, 8, 16, 32) and g.threads % g.cols == 0
  assert g.threads % 32 == 0 and g.threads <= 1024
  columns = [c for b in range(g.blocks)
             for c in range(b * g.cols, min((b + 1) * g.cols, n_cols))]
  assert columns == list(range(n_cols))
  assert g.blocks * g.cols - n_cols < g.cols
  steps = sorted(t for t0, rows in _chunks(g, t_len)
                 for t in range(t0, t0 + rows))
  assert steps == list(range(t_len))
  assert g.stages in (1, 2)
  assert g.stages == min(2, len(_chunks(g, t_len)))
  assert g.smem_bytes == 4 * (4 * g.stages + 2) * g.chunk * g.cols
  assert g.smem_bytes <= H100_BLOCK_SHARED_BYTES


def test_vtrace_geometry_refuses_empty_shapes():
  for shape in ((0, 4), (4, 0)):
    with pytest.raises(ValueError):
      vtrace_cuda.launch_geometry(*shape)


def _model_kernel(x, clips):
  """The kernel's arithmetic, order and chunks in Python: per column, per
  chunk from the end, the pre-pass (rho, c, delta), the walk (acc, vs) and
  the post-pass (pg), each op one float32 rounding."""
  f32 = np.float32
  lr, disc, rew, val = (x[k].numpy() for k in
                        ('log_rhos', 'discounts', 'rewards', 'values'))
  boot = x['bootstrap_value'].numpy()
  t_len, n_cols = lr.shape
  clip, clip_pg = (math.inf if c is None else c for c in clips)
  rho_all = torch.exp(x['log_rhos']).numpy()
  g = vtrace_cuda.launch_geometry(t_len, n_cols)

  def minimum(v, hi):
    return v if not v > hi else f32(hi)

  vs_out = np.full(lr.shape, np.nan, f32)
  pg_out = np.full(lr.shape, np.nan, f32)
  for n in range(n_cols):
    acc, v_next, vs_next = f32(0), boot[n], boot[n]
    for t0, rows in _chunks(g, t_len):
      ts = range(t0, t0 + rows)
      c = {t: f32(disc[t, n] * minimum(rho_all[t, n], 1.0)) for t in ts}
      delta = {t: f32(minimum(rho_all[t, n], clip)
                      * f32(f32(rew[t, n] + f32(disc[t, n] * val[t + 1, n]))
                            - val[t, n])) for t in ts if t + 1 < t0 + rows}
      top = t0 + rows - 1
      delta[top] = f32(minimum(rho_all[top, n], clip)
                       * f32(f32(rew[top, n] + f32(disc[top, n] * v_next))
                             - val[top, n]))
      pg_out[top, n] = f32(minimum(rho_all[top, n], clip_pg)
                           * f32(f32(rew[top, n]
                                     + f32(disc[top, n] * vs_next))
                                 - val[top, n]))
      for t in reversed(ts):
        acc = f32(delta[t] + f32(c[t] * acc))
        vs_out[t, n] = vs_next = f32(acc + val[t, n])
        v_next = val[t, n]
      for t in ts[:-1]:
        pg_out[t, n] = f32(minimum(rho_all[t, n], clip_pg)
                           * f32(f32(rew[t, n]
                                     + f32(disc[t, n] * vs_out[t + 1, n]))
                                 - val[t, n]))
  return vs_out, pg_out


@pytest.mark.parametrize('clips', [(1.0, 1.0), (None, None), (3.7, 2.2)],
                         ids=str)
@pytest.mark.parametrize('shape', [(1, 1), (6, 21), (150, 3)], ids=str)
def test_chunked_kernel_model_is_bit_equal_to_the_twin(shape, clips):
  rng = np.random.RandomState(0)
  x = {k: torch.tensor(v, dtype=torch.float32) for k, v in dict(
      log_rhos=rng.randn(*shape) * 0.8,
      discounts=0.99 * (rng.rand(*shape) > 0.1),
      rewards=rng.randn(*shape), values=rng.randn(*shape),
      bootstrap_value=rng.randn(shape[1])).items()}
  vs, pg = _model_kernel(x, clips)
  ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(
      **x, clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
  np.testing.assert_array_equal(vs, ref_vs.numpy())
  np.testing.assert_array_equal(pg, ref_pg.numpy())


@pytest.mark.parametrize('shape', [(3232, 72, 96), (5, 21, 27), (1, 1, 1),
                                   (7, 72, 96), (2, 20, 150)], ids=str)
def test_conv_pool_geometry_covers_every_output_once(shape):
  n, h, w = shape
  g = conv_pool_cuda.launch_geometry(n, h, w)
  _, out_h, out_w, _ = conv_pool_cuda.output_shape(n, h, w)
  rows = sorted(r for band in range(g.row_bands)
                for r in range(band * g.rows, min((band + 1) * g.rows, out_h)))
  cols = sorted(c for tile in range(g.col_tiles)
                for c in range(tile * g.cols, min((tile + 1) * g.cols, out_w)))
  assert rows == list(range(out_h)) and cols == list(range(out_w))
  assert g.blocks == n * g.row_bands * g.col_tiles
  assert g.segs * conv_pool_cuda.SEG >= 2 * g.cols + 1
  assert g.threads % 32 == 0 and 32 <= g.threads <= 256
  # One pass of staging and of conversion: a thread per 16-byte chunk of a
  # staged row and per six window elements of a row.
  in_rows, in_pixels = 2 * g.rows + 3, 2 * g.cols + 3
  raw_stride = -(-(in_pixels * 3 + 15) // 16) * 16
  win_stride, copy1 = conv_pool_cuda.window_layout(g.segs, in_rows)
  assert g.threads >= raw_stride // 16 and g.threads >= win_stride // 6
  assert win_stride % 6 == 0 and win_stride >= 48 * g.segs + 8
  assert copy1 >= in_rows * win_stride * 2
  assert g.smem_bytes <= H100_BLOCK_SHARED_BYTES - 4 * (2 * 16 + 3)


def test_conv_pool_geometry_at_the_learner_shape():
  g = conv_pool_cuda.launch_geometry(3232, 72, 96)
  # Full-width bands: 48 pooled columns in one tile, 6 pooled rows a band.
  assert (g.cols, g.col_tiles, g.rows, g.row_bands) == (48, 1, 6, 6)
  assert (g.segs, g.threads, g.blocks) == (7, 224, 3232 * 6)


def test_conv_pool_geometry_refuses_empty_frames():
  with pytest.raises(ValueError):
    conv_pool_cuda.launch_geometry(1, 0, 4)


def _im2col_in_k_order(frames):
  """[N, H, W, 32] float32: for each conv position, what row k of the
  kernel's K dimension multiplies (conv_pool_cuda.k_element), from the
  bf16 x zero-padded by the conv's SAME pad; element 9 of a window row is
  the next pixel's channel 0, as the kernel loads it."""
  x = scaled_nchw(frames, torch.bfloat16).float().permute(0, 2, 3, 1)
  n, h, w, _ = x.shape
  padded = F.pad(x, (0, 0, 1, 2, 1, 1))  # W: 1 before, 2 after; H: 1, 1
  cols = torch.zeros((n, h, w, conv_pool_cuda.K_PADDED))
  for k in range(conv_pool_cuda.K_PADDED):
    tap = conv_pool_cuda.k_element(k)
    if tap is None:
      continue
    dy, e = tap
    dx, ci = divmod(e, 3)
    cols[..., k] = padded[:, dy:dy + h, dx:dx + w, ci]
  return cols


def test_pack_weight_times_the_im2col_is_the_conv():
  gen = torch.Generator().manual_seed(3)
  frames = torch.randint(0, 256, (5, 21, 27, 3), generator=gen,
                         dtype=torch.uint8)
  weight = torch.randn(conv_pool_cuda.WEIGHT_SHAPE, generator=gen) * 0.3
  packed = conv_pool_cuda.pack_weight(weight)
  assert packed.dtype == torch.bfloat16 and packed.shape == (32, 16)
  zero = [k for k in range(32) if not packed[k].any()]
  assert zero == [25, 27, 29, 30, 31]
  got = _im2col_in_k_order(frames) @ packed.float()
  ref = F.conv2d(scaled_nchw(frames, torch.bfloat16).float(),
                 weight.to(torch.bfloat16).float(), padding=1)
  torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=1e-5,
                             atol=1e-5)
  # The element-9 columns hold data: the zero rows are what cancels them.
  assert _im2col_in_k_order(frames)[..., 25].abs().sum() > 0


def test_every_mma_pair_is_two_neighbouring_window_elements():
  for k in range(0, conv_pool_cuda.K_PADDED, 2):
    lo, hi = conv_pool_cuda.k_element(k), conv_pool_cuda.k_element(k + 1)
    if lo is None:
      assert hi is None
      continue
    assert lo[0] == hi[0] and hi[1] == lo[1] + 1 and lo[1] % 2 == 0
  # The four pairs one load reads (k-step s, half h: pairs 8s + 4h + tig)
  # lie in one window row, or are the rows' element 8.
  for first in (0, 4, 8, 12):
    taps = [conv_pool_cuda.k_element(2 * p) for p in range(first, first + 4)]
    taps = [t for t in taps if t is not None]
    assert len({t[0] for t in taps}) == 1 or {t[1] for t in taps} == {8}


def _a_load_wavefronts(segs, in_rows):
  """Shared-memory wavefronts of the 8 A loads of one conv row (k-step,
  low/high 8 k, rows gid / gid + 8), by the kernel's addresses."""
  win_stride, copy1 = conv_pool_cuda.window_layout(segs, in_rows)
  total = 0
  for s in range(2):
    for half in range(2):
      for row in (0, 8):
        words = {}
        for lane in range(32):
          gid, tig = divmod(lane, 4)
          dy, e = conv_pool_cuda.k_element(2 * (8 * s + 4 * half + tig)) or (
              0, 0)
          el = 3 * (gid + row) + dy * win_stride + e
          byte = 2 * el if el % 2 == 0 else copy1 + 2 * (el + 1)
          words.setdefault(byte // 4 % 32, set()).add(byte // 4)
        total += max(len(v) for v in words.values())
  return total


@pytest.mark.parametrize('segs', range(1, 10))
def test_window_layout_puts_each_a_load_on_32_banks(segs):
  for rows in (1, 4, 6, 8):
    assert _a_load_wavefronts(segs, 2 * rows + 3) == 8


def test_bytes_times_inverse_255_round_like_the_division():
  u = torch.arange(256, dtype=torch.float32)
  inverse = torch.tensor(float.fromhex('0x1.010102p-8'), dtype=torch.float32)
  assert inverse == torch.tensor(1 / 255, dtype=torch.float32)
  assert torch.equal((u * inverse).to(torch.bfloat16),
                     (u / 255).to(torch.bfloat16))
  assert torch.equal((u * inverse).to(torch.bfloat16),
                     scaled_nchw(torch.arange(256, dtype=torch.uint8).reshape(
                         1, 1, 256, 1), torch.bfloat16).reshape(-1))


@pytest.mark.parametrize('size', [(1, 1), (2, 3), (7, 6), (21, 27), (72, 96)],
                         ids=str)
def test_same_pool_equals_the_pool_over_clamped_indices(size):
  h, w = size
  y = torch.randn(2, 4, h, w, generator=torch.Generator().manual_seed(h))
  out_h, out_w = -(-h // 2), -(-w // 2)
  pad_top = max((out_h - 1) * 2 + 3 - h, 0) // 2
  pad_left = max((out_w - 1) * 2 + 3 - w, 0) // 2
  rows = [[min(max(2 * p - pad_top + d, 0), h - 1) for d in range(3)]
          for p in range(out_h)]
  cols = [[min(max(2 * q - pad_left + d, 0), w - 1) for d in range(3)]
          for q in range(out_w)]
  clamped = torch.stack([torch.stack([
      y[:, :, r][:, :, :, c].amax(dim=(2, 3)) for c in cols], dim=-1)
      for r in rows], dim=-2)
  assert torch.equal(clamped, max_pool_same(y))


def test_phase_script_names_each_sources_phase_bits():
  """scripts/kernel_phases.py compiles phase i out with bit 1 << i; each
  source documents its bits in that order."""
  import os
  import re
  from scalable_agent_tpu_torch.ops import build
  from scalable_agent_tpu_torch.scripts import kernel_phases
  for name, phases in kernel_phases.PHASES.items():
    with open(os.path.join(build.CSRC_DIR, name + '.cu')) as f:
      text = ' '.join(f.read().split())
    listed = re.search(r'Phases compiled out, by bit \(([^)]*)\)', text)
    assert listed, name
    bits = [int(b) for b in re.findall(r'\b(\d+) ', listed.group(1))]
    assert bits == [1 << i for i in range(len(phases))], (name, bits)


def test_phase_script_raises_without_cuda():
  from scalable_agent_tpu_torch.scripts import kernel_phases
  with pytest.raises(RuntimeError):
    kernel_phases.main([])
