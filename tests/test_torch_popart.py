"""The port's PopArt (scalable_agent_tpu_torch/popart.py) against the JAX
package's popart.py on the same numpy-seeded statistics, targets and
head, float32 on the CPU.

Tolerances: rtol 1e-5 / atol 1e-6 (the same float32 formulas; the batch
moments are sums in another order); the preservation property itself
(sigma'(w'x + b') + mu' == sigma(wx + b) + mu) rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import popart as jax_popart
from scalable_agent_tpu_torch import popart

K, T, B, HIDDEN = 6, 5, 8, 16


def _states(seed=0):
  rng = np.random.RandomState(seed)
  mu = rng.randn(K).astype(np.float32)
  nu = (mu ** 2 + rng.rand(K) * 4 + 0.1).astype(np.float32)
  nu[2] = mu[2] ** 2 - 1e-3   # a variance below zero: clipped, no NaN
  jstate = jax_popart.init(K)._replace(mu=jnp.asarray(mu),
                                       nu=jnp.asarray(nu))
  state = popart.init(K)._replace(mu=torch.from_numpy(mu),
                                  nu=torch.from_numpy(nu))
  return jstate, state


def _close(got, want, what=''):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                             atol=1e-6, err_msg=what)


def test_init_and_sigma_match_jax():
  for field, value in popart.init(K)._asdict().items():
    _close(value, getattr(jax_popart.init(K), field), field)
  assert (popart.DEFAULT_BETA, popart.DEFAULT_SIGMA_MIN,
          popart.DEFAULT_SIGMA_MAX) == (jax_popart.DEFAULT_BETA,
                                        jax_popart.DEFAULT_SIGMA_MIN,
                                        jax_popart.DEFAULT_SIGMA_MAX)
  jstate, state = _states()
  sig = popart.sigma(state)
  assert torch.isfinite(sig).all()
  _close(sig, jax_popart.sigma(jstate))


def test_normalize_unnormalize_match_jax():
  jstate, state = _states(1)
  rng = np.random.RandomState(2)
  values = rng.randn(T, B).astype(np.float32) * 3
  ids = rng.randint(0, K, B).astype(np.int32)
  _close(popart.normalize(state, torch.from_numpy(values),
                          torch.from_numpy(ids)),
         jax_popart.normalize(jstate, values, ids))
  _close(popart.unnormalize(state, torch.from_numpy(values),
                            torch.from_numpy(ids)),
         jax_popart.unnormalize(jstate, values, ids))


@pytest.mark.parametrize('beta', [3e-4, 0.3])
def test_update_stats_matches_jax(beta):
  """Tasks absent from the batch keep their statistics; the split into
  batch moments and their EMA (what a process group all-reduces
  between) gives the same statistics."""
  jstate, state = _states(3)
  rng = np.random.RandomState(4)
  targets = rng.randn(T, B).astype(np.float32) * 5
  ids = np.array([0, 1, 1, 3, 3, 3, 0, 5], np.int32)   # no 2, no 4
  want = jax_popart.update_stats(jstate, jnp.asarray(targets),
                                 jnp.asarray(ids), beta=beta)
  got = popart.update_stats(state, torch.from_numpy(targets),
                            torch.from_numpy(ids), beta=beta)
  _close(got.mu, want.mu, 'mu')
  _close(got.nu, want.nu, 'nu')
  for absent in (2, 4):
    assert got.mu[absent] == state.mu[absent]
    assert got.nu[absent] == state.nu[absent]
  halves = [popart.batch_moments(torch.from_numpy(targets[:, s]),
                                 torch.from_numpy(ids[s]), K)
            for s in (slice(0, 4), slice(4, 8))]
  summed = [a + b for a, b in zip(*halves)]
  split = popart.update_from_moments(state, *summed, beta=beta)
  _close(split.mu, got.mu, 'split mu')
  _close(split.nu, got.nu, 'split nu')


def test_preservation_matches_jax_and_preserves_outputs():
  jold, old = _states(5)
  jnew, new = _states(6)
  rng = np.random.RandomState(7)
  kernel = rng.randn(HIDDEN, K).astype(np.float32)   # Flax's [hidden, K]
  bias = rng.randn(K).astype(np.float32)
  jk, jb = jax_popart.preserve_outputs(jnp.asarray(kernel),
                                       jnp.asarray(bias), jold, jnew)
  params = {'baseline.weight': torch.from_numpy(kernel.T.copy()),
            'baseline.bias': torch.from_numpy(bias), 'other': torch.ones(2)}
  out = popart.apply_preservation(params, old, new)
  _close(out['baseline.weight'], np.asarray(jk).T, 'weight')
  _close(out['baseline.bias'], jb, 'bias')
  assert out['other'] is params['other']
  japplied = jax_popart.apply_preservation(
      {'params': {'baseline': {'kernel': jnp.asarray(kernel),
                               'bias': jnp.asarray(bias)}}}, jold, jnew)
  _close(out['baseline.weight'],
         np.asarray(japplied['params']['baseline']['kernel']).T)
  x = torch.from_numpy(rng.randn(3, HIDDEN).astype(np.float32))
  before = (popart.sigma(old) * (x @ params['baseline.weight'].T +
                                 params['baseline.bias']) + old.mu)
  after = (popart.sigma(new) * (x @ out['baseline.weight'].T +
                                out['baseline.bias']) + new.mu)
  np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5,
                             atol=1e-5)


def test_stats_summary_matches_jax():
  jstate, state = _states(8)
  names = [f'level_{i}' for i in range(K)]
  got = popart.stats_summary(state, names)
  want = jax_popart.stats_summary(jstate, names)
  assert got['tasks'] == want['tasks'] == names
  _close(got['mu'], want['mu'])
  _close(got['sigma'], want['sigma'])
  assert set(popart.stats_summary(state)) == {'mu', 'sigma'}
