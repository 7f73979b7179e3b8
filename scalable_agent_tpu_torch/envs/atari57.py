"""The port's copy of the JAX package's envs/atari57.py (numpy only).

Atari-57 benchmark metadata and human-normalized scoring.

Companion of `envs/dmlab30.py` for the Atari workload (SURVEY §0:
"Atari-style via swap-in env"; §6 cites the paper's Atari-57 headline,
median human-normalized score over the 57-game suite). The reference
repo itself ships only DMLab metadata (reference: dmlab30.py), so this
module is the Atari half of the same evaluation story: game list +
human/random anchor scores + the aggregate the papers report.

Conventions:
- Game names are ALE snake_case rom ids ('kung_fu_master'); the
  `envs/atari.py` adapter accepts them for both backends.
- The headline aggregate is the MEDIAN over games (DQN/IMPALA/Rainbow
  convention — the mean is dominated by a few games with huge
  human-relative ceilings); the mean is also provided.

Provenance caveat (same as dmlab30.py): the reference mount was empty
at build time and this sandbox has no network, so the anchor tables
below are reconstructed from the standard published table (Wang et al.
2016 "Dueling Network Architectures", Table 4 — the table IMPALA,
Rainbow, Ape-X and R2D2 all normalize against). Re-verify against the
published table before reporting any score from a real run
(docs/RUNBOOK.md makes this step mandatory).

Pure numpy; nothing here touches a device.
"""

from typing import Dict, Optional

import numpy as np

from scalable_agent_tpu_torch.envs import anchors

# Provenance gate (see envs/anchors.py and the caveat above):
# 'reconstructed' until scripts/verify_anchors.py diffs the table
# against the published Wang et al. 2016 Table 4; scoring warns once
# per process while unverified and self-checks the pinned SHA-256.
ANCHOR_PROVENANCE = 'reconstructed'
ANCHOR_SHA256 = (
    'b57710f7f90fc73e5cd900d3c47278ac0bf9e4b1a70ae498de4eb8e374fa0987')

# game: (random_score, human_score) — Wang et al. 2016 Table 4 anchors.
_ANCHOR_SCORES = {
    'alien': (227.8, 7127.7),
    'amidar': (5.8, 1719.5),
    'assault': (222.4, 742.0),
    'asterix': (210.0, 8503.3),
    'asteroids': (719.1, 47388.7),
    'atlantis': (12850.0, 29028.1),
    'bank_heist': (14.2, 753.1),
    'battle_zone': (2360.0, 37187.5),
    'beam_rider': (363.9, 16926.5),
    'berzerk': (123.7, 2630.4),
    'bowling': (23.1, 160.7),
    'boxing': (0.1, 12.1),
    'breakout': (1.7, 30.5),
    'centipede': (2090.9, 12017.0),
    'chopper_command': (811.0, 7387.8),
    'crazy_climber': (10780.5, 35829.4),
    'defender': (2874.5, 18688.9),
    'demon_attack': (152.1, 1971.0),
    'double_dunk': (-18.6, -16.4),
    'enduro': (0.0, 860.5),
    'fishing_derby': (-91.7, -38.7),
    'freeway': (0.0, 29.6),
    'frostbite': (65.2, 4334.7),
    'gopher': (257.6, 2412.5),
    'gravitar': (173.0, 3351.4),
    'hero': (1027.0, 30826.4),
    'ice_hockey': (-11.2, 0.9),
    'jamesbond': (29.0, 302.8),
    'kangaroo': (52.0, 3035.0),
    'krull': (1598.0, 2665.5),
    'kung_fu_master': (258.5, 22736.3),
    'montezuma_revenge': (0.0, 4753.3),
    'ms_pacman': (307.3, 6951.6),
    'name_this_game': (2292.3, 8049.0),
    'phoenix': (761.4, 7242.6),
    'pitfall': (-229.4, 6463.7),
    'pong': (-20.7, 14.6),
    'private_eye': (24.9, 69571.3),
    'qbert': (163.9, 13455.0),
    'riverraid': (1338.5, 17118.0),
    'road_runner': (11.5, 7845.0),
    'robotank': (2.2, 11.9),
    'seaquest': (68.4, 42054.7),
    'skiing': (-17098.1, -4336.9),
    'solaris': (1236.3, 12326.7),
    'space_invaders': (148.0, 1668.7),
    'star_gunner': (664.0, 10250.0),
    'surround': (-10.0, 6.5),
    'tennis': (-23.8, -8.3),
    'time_pilot': (3568.0, 5229.2),
    'tutankham': (11.4, 167.6),
    'up_n_down': (533.4, 11693.2),
    'venture': (0.0, 1187.5),
    'video_pinball': (16256.9, 17667.9),
    'wizard_of_wor': (563.5, 4756.5),
    'yars_revenge': (3092.9, 54576.9),
    'zaxxon': (32.5, 9173.3),
}

ALL_GAMES = tuple(sorted(_ANCHOR_SCORES))

RANDOM_SCORES = {g: rh[0] for g, rh in _ANCHOR_SCORES.items()}
HUMAN_SCORES = {g: rh[1] for g, rh in _ANCHOR_SCORES.items()}


def per_game_human_normalized(game_returns: Dict[str, list],
                              per_game_cap: Optional[float] = None
                              ) -> Dict[str, float]:
  """Per-game `(mean_return - random) / (human - random) * 100`.

  Args:
    game_returns: game name -> list/array of episode returns. Every
      game in `ALL_GAMES` must be present and non-empty (same
      missing-levels contract as dmlab30.compute_human_normalized_score).
    per_game_cap: optional scalar clip applied above, per game.
  """
  anchors.check_provenance(
      'envs/atari57.py', ANCHOR_PROVENANCE, ANCHOR_SHA256,
      {'RANDOM_SCORES': RANDOM_SCORES, 'HUMAN_SCORES': HUMAN_SCORES})
  missing = [g for g in ALL_GAMES
             if g not in game_returns or len(game_returns[g]) == 0]
  if missing:
    raise ValueError(f'Missing returns for games: {missing}')
  scores = {}
  for game in ALL_GAMES:
    human, random = HUMAN_SCORES[game], RANDOM_SCORES[game]
    mean_return = float(np.mean(game_returns[game]))
    score = (mean_return - random) / (human - random) * 100.0
    if per_game_cap is not None:
      score = min(score, per_game_cap)
    scores[game] = score
  return scores


def compute_human_normalized_score(game_returns: Dict[str, list],
                                   per_game_cap: Optional[float] = None,
                                   aggregate: str = 'median') -> float:
  """Aggregate human-normalized score over the 57 games.

  `aggregate='median'` is the suite's headline number (the convention
  every Atari-57 paper reports); 'mean' is the dmlab30-style mean.
  """
  scores = np.asarray(
      list(per_game_human_normalized(game_returns, per_game_cap)
           .values()))
  if aggregate == 'median':
    return float(np.median(scores))
  if aggregate == 'mean':
    return float(np.mean(scores))
  raise ValueError(f'unknown aggregate {aggregate!r}')
