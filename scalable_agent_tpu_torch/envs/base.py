"""Environment protocol (host side), as in the JAX package's envs/base.py.

Environments live on the host, possibly each in its own process
(runtime/py_process.py), and speak numpy:

- `initial()` -> observation
- `step(action)` -> (reward f32[], done bool[], observation), with
  action repeat and auto-reset inside (done=True: the returned
  observation is the *first* frame of the next episode)
- `close()`
- `_tensor_specs(method_name, kwargs, constructor_kwargs)` -> the
  dtype/shape declaration that process hosting checks replies against.

Observations are `(frame uint8 [H, W, 3], instruction_ids int32 [L])`:
strings are hashed on the host (envs/fake.py `hash_instruction`), so only
fixed-shape numbers cross process and device boundaries.
"""

from typing import NamedTuple, Tuple

import numpy as np


class ArraySpec(NamedTuple):
  shape: Tuple[int, ...]
  dtype: np.dtype


def observation_specs(height, width, instr_len):
  return (ArraySpec((height, width, 3), np.dtype(np.uint8)),
          ArraySpec((instr_len,), np.dtype(np.int32)))


def step_output_specs(height, width, instr_len):
  """Specs for the (reward, done, observation) tuple of `step`."""
  return (ArraySpec((), np.dtype(np.float32)),
          ArraySpec((), np.dtype(bool)),
          observation_specs(height, width, instr_len))


class Environment:
  """Base class; subclasses implement `initial`/`step` (action repeat
  and auto-reset live inside `step`) and declare `_tensor_specs`."""

  def initial(self):
    raise NotImplementedError

  def step(self, action):
    raise NotImplementedError

  def close(self):
    pass

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    raise NotImplementedError
