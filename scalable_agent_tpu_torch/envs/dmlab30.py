"""The port's copy of the JAX package's envs/dmlab30.py (numpy only).

DMLab-30 benchmark metadata and human-normalized scoring.

TPU-native counterpart of the reference's task-metadata module
(reference: dmlab30.py — `LEVEL_MAPPING`, `HUMAN_SCORES`,
`RANDOM_SCORES`, `compute_human_normalized_score`). Pure numpy; nothing
here touches a device.

The 30-level table maps *training* level names to their *held-out test*
variants (only the two `rooms_*_train` levels differ). Human/random
anchor scores reproduce the published DMLab-30 calibration values
(IMPALA paper, arXiv:1802.01561, appendix). Provenance caveat: the
reference mount was empty at build time (see SURVEY.md) — the tables
below are reconstructed from the public benchmark definition; re-verify
against the reference if it becomes available.
"""

import collections

import numpy as np

from scalable_agent_tpu_torch.envs import anchors

# Provenance of the anchor tables below (see module docstring and
# envs/anchors.py): 'reconstructed' until scripts/verify_anchors.py has
# diffed them against the upstream reference (dmlab30.py HUMAN_SCORES /
# RANDOM_SCORES / LEVEL_MAPPING) — it prints the edit that flips this
# to 'verified'. Scoring warns once per process while unverified.
ANCHOR_PROVENANCE = 'reconstructed'
# SHA-256 of the canonical table serialization (anchors.anchor_checksum)
# — pins the exact constants below against silent edits; scoring
# self-checks it (tests/test_anchors.py pins it too).
ANCHOR_SHA256 = (
    'fb874c63c1632dbd673b0ff0282805474fbffb627b9be7f8e5ca0f2edb393b7e')

LEVEL_MAPPING = collections.OrderedDict([
    ('rooms_collect_good_objects_train', 'rooms_collect_good_objects_test'),
    ('rooms_exploit_deferred_effects_train',
     'rooms_exploit_deferred_effects_test'),
    ('rooms_select_nonmatching_object', 'rooms_select_nonmatching_object'),
    ('rooms_watermaze', 'rooms_watermaze'),
    ('rooms_keys_doors_puzzle', 'rooms_keys_doors_puzzle'),
    ('language_select_described_object', 'language_select_described_object'),
    ('language_select_located_object', 'language_select_located_object'),
    ('language_execute_random_task', 'language_execute_random_task'),
    ('language_answer_quantitative_question',
     'language_answer_quantitative_question'),
    ('lasertag_one_opponent_small', 'lasertag_one_opponent_small'),
    ('lasertag_three_opponents_small', 'lasertag_three_opponents_small'),
    ('lasertag_one_opponent_large', 'lasertag_one_opponent_large'),
    ('lasertag_three_opponents_large', 'lasertag_three_opponents_large'),
    ('natlab_fixed_large_map', 'natlab_fixed_large_map'),
    ('natlab_varying_map_regrowth', 'natlab_varying_map_regrowth'),
    ('natlab_varying_map_randomized', 'natlab_varying_map_randomized'),
    ('skymaze_irreversible_path_hard', 'skymaze_irreversible_path_hard'),
    ('skymaze_irreversible_path_varied', 'skymaze_irreversible_path_varied'),
    ('psychlab_arbitrary_visuomotor_mapping',
     'psychlab_arbitrary_visuomotor_mapping'),
    ('psychlab_continuous_recognition', 'psychlab_continuous_recognition'),
    ('psychlab_sequential_comparison', 'psychlab_sequential_comparison'),
    ('psychlab_visual_search', 'psychlab_visual_search'),
    ('explore_object_locations_small', 'explore_object_locations_small'),
    ('explore_object_locations_large', 'explore_object_locations_large'),
    ('explore_obstructed_goals_small', 'explore_obstructed_goals_small'),
    ('explore_obstructed_goals_large', 'explore_obstructed_goals_large'),
    ('explore_goal_locations_small', 'explore_goal_locations_small'),
    ('explore_goal_locations_large', 'explore_goal_locations_large'),
    ('explore_object_rewards_few', 'explore_object_rewards_few'),
    ('explore_object_rewards_many', 'explore_object_rewards_many'),
])

ALL_LEVELS = tuple(LEVEL_MAPPING.keys())

HUMAN_SCORES = {
    'rooms_collect_good_objects_test': 10.0,
    'rooms_exploit_deferred_effects_test': 85.65,
    'rooms_select_nonmatching_object': 65.9,
    'rooms_watermaze': 54.0,
    'rooms_keys_doors_puzzle': 53.8,
    'language_select_described_object': 389.5,
    'language_select_located_object': 280.7,
    'language_execute_random_task': 254.05,
    'language_answer_quantitative_question': 184.5,
    'lasertag_one_opponent_small': 12.65,
    'lasertag_three_opponents_small': 18.55,
    'lasertag_one_opponent_large': 18.6,
    'lasertag_three_opponents_large': 31.5,
    'natlab_fixed_large_map': 36.9,
    'natlab_varying_map_regrowth': 24.45,
    'natlab_varying_map_randomized': 42.35,
    'skymaze_irreversible_path_hard': 100.0,
    'skymaze_irreversible_path_varied': 100.0,
    'psychlab_arbitrary_visuomotor_mapping': 58.75,
    'psychlab_continuous_recognition': 58.3,
    'psychlab_sequential_comparison': 39.5,
    'psychlab_visual_search': 78.5,
    'explore_object_locations_small': 74.45,
    'explore_object_locations_large': 65.65,
    'explore_obstructed_goals_small': 206.0,
    'explore_obstructed_goals_large': 119.5,
    'explore_goal_locations_small': 267.5,
    'explore_goal_locations_large': 194.5,
    'explore_object_rewards_few': 77.7,
    'explore_object_rewards_many': 106.7,
}

RANDOM_SCORES = {
    'rooms_collect_good_objects_test': 0.073,
    'rooms_exploit_deferred_effects_test': 8.501,
    'rooms_select_nonmatching_object': 0.312,
    'rooms_watermaze': 4.065,
    'rooms_keys_doors_puzzle': 4.135,
    'language_select_described_object': -0.07,
    'language_select_located_object': 1.929,
    'language_execute_random_task': -5.913,
    'language_answer_quantitative_question': -0.33,
    'lasertag_one_opponent_small': -0.224,
    'lasertag_three_opponents_small': -0.214,
    'lasertag_one_opponent_large': -0.083,
    'lasertag_three_opponents_large': -0.102,
    'natlab_fixed_large_map': 2.173,
    'natlab_varying_map_regrowth': 2.989,
    'natlab_varying_map_randomized': 7.346,
    'skymaze_irreversible_path_hard': 0.1,
    'skymaze_irreversible_path_varied': 14.4,
    'psychlab_arbitrary_visuomotor_mapping': 0.163,
    'psychlab_continuous_recognition': 0.224,
    'psychlab_sequential_comparison': 0.129,
    'psychlab_visual_search': 0.085,
    'explore_object_locations_small': 3.575,
    'explore_object_locations_large': 4.673,
    'explore_obstructed_goals_small': 6.76,
    'explore_obstructed_goals_large': 2.61,
    'explore_goal_locations_small': 7.66,
    'explore_goal_locations_large': 3.14,
    'explore_object_rewards_few': 2.073,
    'explore_object_rewards_many': 2.438,
}


def compute_human_normalized_score(level_returns, per_level_cap=None):
  """Mean human-normalized score over the 30 levels.

  Args:
    level_returns: dict mapping *training* level name -> list/array of
      episode returns for that level. Every level in `ALL_LEVELS` must be
      present and non-empty (reference: dmlab30.py
      compute_human_normalized_score raises on missing levels).
    per_level_cap: optional scalar; each level's normalized score is
      clipped above at this value (cap=100 gives the paper's "capped"
      metric).

  Returns:
    float: mean over levels of
      (mean_return - random) / (human - random) * 100, optionally capped.
  """
  anchors.check_provenance(
      'envs/dmlab30.py', ANCHOR_PROVENANCE, ANCHOR_SHA256,
      {'LEVEL_MAPPING': dict(LEVEL_MAPPING),
       'HUMAN_SCORES': HUMAN_SCORES, 'RANDOM_SCORES': RANDOM_SCORES})
  missing = [l for l in ALL_LEVELS
             if l not in level_returns or len(level_returns[l]) == 0]
  if missing:
    raise ValueError(f'Missing returns for levels: {missing}')
  scores = []
  for train_level in ALL_LEVELS:
    test_level = LEVEL_MAPPING[train_level]
    human, random = HUMAN_SCORES[test_level], RANDOM_SCORES[test_level]
    mean_return = float(np.mean(level_returns[train_level]))
    score = (mean_return - random) / (human - random) * 100.0
    if per_level_cap is not None:
      score = min(score, per_level_cap)
    scores.append(score)
  return float(np.mean(scores))
