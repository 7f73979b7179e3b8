"""The port's copy of the JAX package's envs/suites.py (data and
scoring only).

Benchmark-suite registry: ONE place that knows which `level_name`
values expand to a multi-task suite and how each suite is scored.

Factory level expansion, training-time scoring (observability.
EpisodeStats) and eval-time scoring (driver.evaluate) all dispatch
through `SUITES` — adding a suite is one entry here, nothing else.
(Reference scope: dmlab30.py is the only suite upstream; atari57 is
this build's addition for the paper's Atari evaluation story.)
"""

from typing import Callable, Dict, List, NamedTuple, Tuple

from scalable_agent_tpu_torch.envs import atari57, dmlab30


class Suite(NamedTuple):
  """A multi-task benchmark: its level lists and score summaries.

  The score functions take `{train_level_name: [episode returns]}`
  (every level present and non-empty — they raise otherwise) and
  return `{summary_tag: value}` ready for the JSONL writer.
  """
  train_levels: Tuple[str, ...]
  test_levels: Tuple[str, ...]
  training_scores: Callable[[Dict[str, List[float]]], Dict[str, float]]
  eval_scores: Callable[[Dict[str, List[float]]], Dict[str, float]]


def _dmlab30_scores(prefix):
  def scores(level_returns):
    return {
        f'dmlab30/{prefix}_no_cap': dmlab30.compute_human_normalized_score(
            level_returns, per_level_cap=None),
        f'dmlab30/{prefix}_cap_100': dmlab30.compute_human_normalized_score(
            level_returns, per_level_cap=100),
    }
  return scores


def _atari57_scores(prefix):
  def scores(game_returns):
    return {
        f'atari57/{prefix}_median': atari57.compute_human_normalized_score(
            game_returns, aggregate='median'),
        f'atari57/{prefix}_mean': atari57.compute_human_normalized_score(
            game_returns, aggregate='mean'),
    }
  return scores


SUITES: Dict[str, Suite] = {
    'dmlab30': Suite(
        train_levels=tuple(dmlab30.ALL_LEVELS),
        test_levels=tuple(dmlab30.LEVEL_MAPPING.values()),
        training_scores=_dmlab30_scores('training'),
        eval_scores=_dmlab30_scores('test'),
    ),
    # Atari has no held-out level variants: eval plays the training
    # games (episode diversity comes from the always-on random no-op
    # starts — the ALE eval protocol — policy sampling, and sticky
    # actions if configured).
    'atari57': Suite(
        train_levels=atari57.ALL_GAMES,
        test_levels=atari57.ALL_GAMES,
        training_scores=_atari57_scores('training'),
        eval_scores=_atari57_scores('test'),
    ),
}
