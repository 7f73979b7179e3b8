"""What the contextual bandit guarantees, checked on the batches the
program acted (ContextualBanditEnv: the frame is one colour plane at 255,
whose channel is the episode's context; an action is rewarded 1 when it
equals the context, else 0; an episode lasts `episode_length` steps and
the first output of a run starts one)."""

import torch


def context(frames):
  """The channel of each uint8 [..., H, W, 3] frame, and whether the
  frame is exactly that channel's plane at 255."""
  channel = frames[..., 0, 0, :].argmax(dim=-1)
  plane = torch.nn.functional.one_hot(channel, 3).to(torch.uint8) * 255
  valid = (frames == plane[..., None, None, :]).flatten(-3).all(dim=-1)
  return channel, valid


def env_errors(batches, episode_length: int) -> int:
  """Mismatches over consecutive [T+1, B] batches, the first from the
  start of the run: frames that are not a plane, rewards that are not
  `action == context` of the frame the action answered, `done` off the
  episode clock, and contexts that change inside an episode."""
  errors = 0
  t = batches[0]['reward'].shape[0] - 1
  for k, batch in enumerate(batches):
    channel, valid = context(batch['frames'])
    errors += int((~valid).sum())
    want = (batch['action'][1:] == channel[:-1]).float()
    errors += int((batch['reward'][1:] != want).sum())
    clock = torch.arange(k * t, k * t + t + 1, device=channel.device)
    want_done = (clock % episode_length == 0)[:, None].expand_as(
        batch['done'])
    errors += int((batch['done'] != want_done).sum())
    changed = channel[1:] != channel[:-1]
    errors += int((changed & ~batch['done'][1:]).sum())
  return errors


def action_z(batches, logits) -> float:
  """How far the actions drawn lie from the reference policy: for each
  action, (times drawn - expected times) / its standard deviation, over
  every acting step of every batch; the largest in absolute value. A
  sound sampler gives about a normal draw per action."""
  count = expected = var = 0.0
  for batch, step_logits in zip(batches, logits):
    probs = torch.softmax(step_logits.double(), dim=-1)
    drawn = torch.nn.functional.one_hot(batch['action'][1:],
                                        probs.shape[-1]).double()
    count = count + drawn.sum(dim=(0, 1))
    expected = expected + probs.sum(dim=(0, 1))
    var = var + (probs * (1.0 - probs)).sum(dim=(0, 1))
  return float(((count - expected).abs() / var.sqrt()).max())
