"""The FLOP and byte counts against shapes worked by hand."""

from port_bench import cells
from port_bench import counting

DEEP = cells.load('deep.anakin.b32')['model']
SHALLOW = cells.load('shallow.anakin.b32')['model']


def test_deep_torso_flops_by_hand():
  # Section 1 at 72x96: conv 3->16, then two blocks of two 16->16 convs
  # at 36x48; section 2: conv 16->32 at 36x48, four 32->32 at 18x24;
  # section 3: conv 32->32 at 18x24, four at 9x12; Linear 3456->256.
  by_hand = (2 * 9 * 3 * 16 * 72 * 96 + 4 * 2 * 9 * 16 * 16 * 36 * 48 +
             2 * 9 * 16 * 32 * 36 * 48 + 4 * 2 * 9 * 32 * 32 * 18 * 24 +
             2 * 9 * 32 * 32 * 18 * 24 + 4 * 2 * 9 * 32 * 32 * 9 * 12 +
             2 * 9 * 12 * 32 * 256)
  assert counting.torso_flops(DEEP) == by_hand == 103_292_928


def test_shallow_torso_flops_by_hand():
  # Conv 8x8/4 to 17x23, Conv 4x4/2 to 7x10, Linear 2240->256.
  by_hand = (2 * 64 * 3 * 16 * 17 * 23 + 2 * 16 * 16 * 32 * 7 * 10 +
             2 * 7 * 10 * 32 * 256)
  assert counting.torso_flops(SHALLOW) == by_hand == 4_696_064


def test_core_and_heads_flops_by_hand():
  # LSTM input 256 + 1 + 9, hidden 256; heads to 9 logits and 1 value.
  by_hand = 2 * 266 * 1024 + 2 * 256 * 1024 + 2 * 256 * 10
  assert counting.core_flops(DEEP) == by_hand == 1_074_176


def test_anakin_step_flops():
  per_frame = counting.frame_flops(DEEP)
  assert counting.anakin_step_flops(DEEP, 32, 100) == (
      per_frame * 3200 + 3 * per_frame * 3232)
  assert round(counting.anakin_step_flops(DEEP, 32, 100) / 1e12, 3) == 1.346
  assert round(counting.anakin_step_flops(SHALLOW, 32, 100) / 1e9, 1) == 74.4


def test_k1_bytes_at_the_learner_shape():
  assert counting.k1_bytes(100, 32) == 76_928


def test_peaks_of_the_card():
  peaks = counting.peaks('NVIDIA H100 80GB HBM3')
  assert peaks['flops_per_s']['float32'] == 67e12
  assert peaks['hbm_bytes_per_s'] == 3.35e12
  assert counting.peaks('a card the table lacks') is None
