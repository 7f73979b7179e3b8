"""Run construction shared by the port's entry points.

So far only `build_agent` (scalable_agent_tpu/driver.py) and the device
rule of the entry points: the fleet training loop and evaluation are later
slices (ROADMAP.md).
"""

import torch

from scalable_agent_tpu_torch.config import COMPUTE_DTYPES, Config
from scalable_agent_tpu_torch.models import ImpalaAgent


def resolve_device(device) -> torch.device:
  """The device an entry point runs on. 'cuda' with no CUDA raises: the
  port never falls back to the CPU unless the caller asks for it."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} requested but torch.cuda.is_available() is '
        "False; pass device='cpu' to run on the CPU")
  return device


def build_agent(config: Config, num_actions: int) -> ImpalaAgent:
  """The config's agent, on the CPU with PyTorch's default init: callers
  initialise it (models.init_params) and move it to their device. Its
  parameters are float32 whatever `config.compute_dtype` says."""
  return ImpalaAgent(num_actions=num_actions,
                     frame_shape=(config.height, config.width, 3),
                     torso=config.torso,
                     dtype=COMPUTE_DTYPES[config.compute_dtype])
