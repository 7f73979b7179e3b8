"""The language-instruction pathway, ported from the JAX package's
models/instruction.py.

- Host side: `hash_instruction(text)` splits on whitespace and hashes
  each token into [1, VOCAB_SIZE] (0 is the pad id), padded or cut to
  MAX_INSTRUCTION_LEN, so a trajectory carries int32 ids only. The env
  adapters call it (envs/fake.py).
- Device side: `InstructionEncoder` embeds the ids (Embedding(1001, 20)),
  runs an LSTM-64 over the 16 padded positions from a zero carry, and
  returns the output at the last non-pad position, or zeros for an
  all-pad row.

The LSTM is Flax's OptimizedLSTMCell on the port's `nn.LSTMCell`
parameters, as the agent's core is (models/agent.py): one bias, on the
hidden kernels, and `bias_ih` a zero buffer. `dtype` is Flax's compute
dtype: the embedding table and the gate products round to it, while the
carry starts as float32 zeros, as Flax's `initialize_carry` makes it,
and the cell state and output stay float32 (a bf16 gate times a float32
state promotes). The output is float32 in either dtype.
"""

import zlib

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.lstm import unroll_lstm

VOCAB_SIZE = 1000  # hash buckets, matching the reference
MAX_INSTRUCTION_LEN = 16
EMBED_SIZE = 20
LSTM_SIZE = 64


def hash_instruction(text, vocab_size=VOCAB_SIZE,
                     max_len=MAX_INSTRUCTION_LEN):
  """Whitespace split + crc32 (stable across processes and runs) ->
  int32 [max_len] ids; 0 is the padding id."""
  if isinstance(text, bytes):
    text = text.decode('utf-8', errors='replace')
  ids = np.zeros((max_len,), dtype=np.int32)
  for i, token in enumerate(text.split()[:max_len]):
    ids[i] = (zlib.crc32(token.encode('utf-8')) % vocab_size) + 1
  return ids


def empty_instruction(max_len=MAX_INSTRUCTION_LEN):
  """All-pad ids for env families with no language channel (Atari)."""
  return np.zeros((max_len,), dtype=np.int32)


class InstructionEncoder(nn.Module):
  """ids int [N, L] -> float32 [N, lstm_size]."""

  def __init__(self, vocab_size: int = VOCAB_SIZE,
               embed_size: int = EMBED_SIZE, lstm_size: int = LSTM_SIZE,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.lstm_size = lstm_size
    self.embed = nn.Embedding(vocab_size + 1, embed_size)
    self.cell = nn.LSTMCell(embed_size, lstm_size)
    del self.cell.bias_ih
    self.cell.register_buffer('bias_ih', torch.zeros(4 * lstm_size))

  def forward(self, ids, tp=None):
    """`tp` (a models.torsos.TensorParallel) runs the cell on this
    rank's blocks of its gates, as the agent's core does."""
    ids = ids.long()
    n, length = ids.shape
    emb = F.embedding(ids, self.embed.weight.to(self.dtype))  # [N, L, E]
    zeros = torch.zeros((n, self.lstm_size), device=ids.device)
    outputs, _, _ = unroll_lstm(self.cell, emb.transpose(0, 1), zeros,
                                zeros, self.dtype, tp=tp)  # [L, N, H]
    lengths = torch.sum(ids != 0, dim=1)
    last = torch.clamp(lengths - 1, 0, length - 1)
    gathered = outputs[last, torch.arange(n, device=ids.device)].float()
    return torch.where(lengths[:, None] > 0, gathered,
                       torch.zeros_like(gathered))
