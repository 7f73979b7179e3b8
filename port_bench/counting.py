"""Operations and bytes from shapes: the yardstick that the roofline and
mfu metrics divide by. Model FLOPs count 2 per multiply-add of the
convolutions and matrix products; elementwise work (relu, pooling,
adds, the LSTM's gates) is not counted.
"""

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'peaks.json')


def _conv(h, w, k, stride, pad, c_in, c_out):
  """(FLOPs, out h, out w) of one convolution; `pad` is the total
  padding of a dim."""
  oh, ow = (h + pad - k) // stride + 1, (w + pad - k) // stride + 1
  return 2 * k * k * c_in * c_out * oh * ow, oh, ow


def torso_flops(model) -> int:
  """Forward FLOPs of the torso on one frame."""
  h, w, c = model['height'], model['width'], 3
  total = 0
  if model['torso'] == 'shallow':
    f, h, w = _conv(h, w, 8, 4, 0, c, 16)
    total += f
    f, h, w = _conv(h, w, 4, 2, 0, 16, 32)
    total += f
    c = 32
  else:
    for ch, blocks in model['sections']:
      f, h, w = _conv(h, w, 3, 1, 2, c, ch)
      total += f
      h, w, c = -(-h // 2), -(-w // 2), ch
      total += blocks * 2 * _conv(h, w, 3, 1, 2, ch, ch)[0]
  return total + 2 * h * w * c * model['torso_output']


def core_flops(model) -> int:
  """Forward FLOPs of the LSTM step and the two heads on one frame."""
  hidden, actions = model['hidden_size'], model['num_actions']
  core_in = model['torso_output'] + 1 + actions
  return (2 * core_in * 4 * hidden + 2 * hidden * 4 * hidden +
          2 * hidden * (actions + 1))


def frame_flops(model) -> int:
  return torso_flops(model) + core_flops(model)


def anakin_step_flops(model, batch: int, unroll: int) -> int:
  """One fused step: the acting forward over T*B frames, and the
  learner's forward and backward (3x the forward) over (T+1)*B."""
  per_frame = frame_flops(model)
  return per_frame * unroll * batch + 3 * per_frame * (unroll + 1) * batch


def k1_bytes(unroll: int, batch: int) -> int:
  """V-trace kernel (K1) at [T, B]: log_rhos, discounts, rewards, values
  read and vs, pg_advantages written, float32, plus the [B] bootstrap."""
  return 4 * (6 * unroll * batch + batch)


def peaks(device_name: str):
  """The published peaks of a card by its name: FLOP/s per precision
  and HBM bytes/s; None for a card the table lacks (the metrics that
  divide by a peak then read nothing)."""
  with open(PEAKS_FILE) as f:
    table = json.load(f)
  return table.get(device_name)
