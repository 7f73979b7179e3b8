#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

  python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device  — assert CUDA, print the card's name and power limit
             (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader).
2. build   — build every CUDA kernel of the port with nvcc, one process per
             source, all at once; log each kernel's registers, shared
             memory and spills from `nvcc -Xptxas -v`, and fail on a spill.
             Before the builds, alone and timed: the lint module
             (`python -m scalable_agent_tpu_torch.scripts.lint`, every
             checker over the tree) must exit 0. Beside the builds: the
             batcher's native stress test (ops/batcher/batcher_test.cc,
             built by g++) must pass. Then the us per
             EventLog.event() of a durable (fsync'd) and a non-durable
             incident kind.
   launch_floor — the device time of a one-element `add_` (torch.profiler):
             the least a kernel launch takes on the card.
3. kernels — the fused V-trace kernel against its plain twin on the card at
             [100, 32] (the learner's shape), [100, 128] (the lockstep
             population's 4 members), [7, 300], [6, 70, 3], [257, 45]
             and [1000, 32] (several time chunks and blocks), for three
             threshold pairs: bit-equal (torch.equal); its median time over
             200 launches (CUDA events: host work included), its device
             time per launch (torch.profiler), the twin's, and the bound.
4. slice   — the port's Anakin trainer at the full width of the reference's
             deep agent (72x96 frames, T=100, B=32, 9 actions, deep torso,
             LSTM 256, float32, fused V-trace) for 4 fused steps through
             `anakin.run`: finite losses, update_steps == 4, changed
             params, and exactly one V-trace kernel launch per step. Then
             the train step on a small fixed batch on the card against the
             same step on the CPU (the kernels' plain twins).
5. cli     — `python -m scalable_agent_tpu_torch.experiment --mode=anakin`
             for 2 full-width steps into a temporary logdir; its
             summaries.jsonl must hold a finite total_loss.
6. conv_pool — the fused conv3x3+max-pool kernel (K2) against its plain
             twin at [3232, 72, 96] (the learner's (T+1)*B frames),
             [32, 72, 96] (the acting batch), [5, 21, 27] (odd sizes),
             [7, 72, 96] and [3, 1, 1], nonzero bias,
             max|kernel - plain| <= 2**-7 * max|plain|; the count of
             elements that differ at all; the median time over 50 launches
             of the kernel, the twin and cuDNN's conv + pool
             (`library_conv_pool`), the kernel's device time per launch
             (torch.profiler) and the bound.
7. conv_pool_torso — K2 against the port's bf16 deep torso's section 1
             (`sections[0].conv`, then `max_pool_same`) on the section's
             own weights, on [32, 72, 96] frames.
8. slice_bf16, slice_bf16_reference, cli_bf16 — phases 4 and 5 at
             compute_dtype='bfloat16'; params and optimizer state stay
             float32, and the card-vs-CPU train step is held at the bf16
             tolerance of tests/test_torch_bf16.py.
9. conv_pool_entry — K2's entry point, `python -m
             scalable_agent_tpu_torch.scripts.conv_pool`, at its card
             shape [3232, 72, 96].
10. vtrace_sharded — the sharded V-trace kernel (K1b) once per rank of an
             explicit-rank mesh, at [100, 32] over 2 and 4 ranks and
             [6, 70, 3] over 2, three threshold pairs: the ranks' results
             together are bit-equal to K1 on the whole batch, and within
             rtol 1e-5 / atol 1e-6 of the plain twin; B=70 over 4 ranks
             raises. Its median time over 200 launches at the per-rank
             shape [100, 16] (CUDA events, and device time by
             torch.profiler), the twin's, and the bound.
11. slice_dp — 2 ranks on the one card over gloo, the slice's config
             (global B=32, 16 per rank) for 4 fused steps through
             `anakin.run(mesh=...)`: finite losses, update_steps == 4, the
             ranks' params bit-equal (a checksum over the group), K1b
             launched once per step per rank; global env-frames/s, peak
             memory per rank and the gloo all-reduce's share of the step.
             Then the sharded train step on a fixed full-width global
             batch against the 1-rank step: loss rtol 2e-4, params rtol
             5e-4 / atol 5e-6.
12. cli_dp — `python -m torch.distributed.run --standalone
             --nproc_per_node=1 -m scalable_agent_tpu_torch.experiment
             --mode=anakin` for 2 full-width steps: an NCCL group of one;
             its summaries.jsonl must hold a finite total_loss.
13. fleet  — the fleet runtime, `driver.train` on the card at the slice's
             full width (deep torso, 72x96, T=100, B=32, 9 actions, 4
             action repeats, float32, fused V-trace) with 32 actors, each
             env (the host bandit, 100-step episodes) in its own process,
             for 8 learner steps, publishing every 3: finite losses,
             update_steps == 8, changed params, exactly one V-trace kernel
             launch per learner step, the server's parameters on the card
             and its merged batches above 1 request on average, the
             published version advanced, and the server's snapshot
             bit-equal to the learner's params at the last publish (step
             6) and unequal to them after steps 7 and 8. It prints
             env-frames/s and ms per learner step over steps 3-8, the
             share of that time the learner blocked in prefetcher.get,
             the inference mean batch and latency p50/p99 (per merged
             call, over the server's last 512 calls), the buffer's high
             water, peak device memory, and the device's busy time per
             learner step and idle share by torch.profiler over steps 7-8
             (the union of every stream's device events, the server's
             inference kernels included), which must not read empty, and
             the SLO engine's verdict, with the slo_report module over the
             logdir exiting as the verdict says (0 pass, 1 fail).
14. fleet_reference — the inference server on the card against the same
             server on the CPU, same params, 32 concurrent callers at
             [72, 96] frames with random carries: logits, baseline and new
             carry within rtol 1e-4 / atol 1e-5 (the float32 card-vs-CPU
             bar of slice_reference). Then publishes racing inference on
             the card: 8 callers loop on fixed inputs while the learner's
             tensors alternate between two versions, each published and
             at once overwritten in place; every answer must be one
             version's (same bar) and both must be seen.
15. (the fleet CLI's own check runs in drain_fleet, phase 18: its two
             CLI runs hold a finite total_loss and env_frames_per_sec at
             every step.)
16. resume_anakin — `anakin.train` for 2 full-width fused steps into a
             logdir, then again: the second call restores step 2 onto the
             card (params and RMSProp's nu bit-equal to the payload on
             disk), ends at update_steps 4 with summary steps 3 and 4 and 2
             V-trace launches, and leaves LAST_GOOD at step 4 with verified
             digests. It prints the step directory's bytes and the median of
             5 full-width saves (payload copy, write, fsync, digests) and
             restores.
17. rollback_fleet — `driver.train` at the fleet phase's width with NaN
             rewards on learner steps 4-6 (the nan_burst fault) and
             health_rollback_after=2 for 7 steps: exactly one rollback, the
             params right after it bit-equal to the LAST_GOOD payload, the
             server's live version the rollback step, a monotone step
             counter, finite params, one V-trace launch per learner step;
             the SLO verdict lists rollbacks_zero as burned; the
             controller acts under a policy that maps rollbacks_zero to
             admission block->shed (a 4 s fast window): in the rollback's
             step the server's admission reads shed, then block after the
             revert, with two applied rows in CONTROLLER_LOG.json, two
             controller_action incidents and controller_admission 2 in
             the health ledger; the operator's profile_dir window over
             learner step 2 writes a Chrome trace holding exactly one
             V-trace kernel.
18. drain_fleet — the fleet CLI with a budget of 4 learner steps: SIGTERM
             once step 2 is summarised; the process exits 0 within
             preempt_drain_timeout_secs + 60 s with a resume manifest whose
             checkpoint is verified at its step; the same command again
             restores that step, consumes the manifest and ends at step 4;
             the two runs' summary steps are 1..4, each with a finite
             total_loss and env_frames_per_sec; the manifest's metrics
             are the registry's snapshot (buffer/*, staging/*,
             checkpoint/*, driver/* names; slo the SLO engine's verdict so
             far, controller the observing controller's counts, nothing
             applied), and both runs write SLO_VERDICT.json.
             It prints the drain latency.

19. dp_fleet — the data-parallel fleet: 2 gloo ranks sharing the card,
             each with 16 process-hosted actors feeding its 16 rows of the
             global batch of 32, at the slice's widths, for 5 learner steps:
             K1b once per learner step per rank (K1 never), the ranks'
             params bit-equal after every step, the SDC sentinel armed with
             0 mismatches; then the `replica_divergence` drill (health_
             rollback_after=1): one `sdc_replica_mismatch` incident and one
             rollback per rank, the ranks still bit-equal. The first run's
             tail save (at D=2) restored on one rank: bit-equal. It prints
             global env-frames/s, ms per learner step and the blocked-get
             share per rank over steps 3-5, and the gloo gradient
             all-reduce's ms per step.
20. cli_fleet_dp — `python -m torch.distributed.run --standalone
             --nproc_per_node=1 -m scalable_agent_tpu_torch.experiment
             --mode=train --runtime=fleet` for 1 full-width step: an NCCL
             group of one (NCCL refuses two ranks on one card).
21. unroll_fleet — unroll staging: 32 full-width unrolls staged one by one
             into the arena on a side stream, bit-equal to `batch_unrolls`
             staged as batch staging stages it; then the fleet phase's run
             with staging_mode='unroll' for 5 learner steps (K1 once per
             step), its ms per learner step over steps 3-5 beside the fleet
             phase's.
22. tp — 2 gloo ranks as a {data 1, model 2} mesh: the TP train step in
             `gathered` at T=100, B=32 and in `sharded` at T=20, B=8 (the
             cut and its reason in phase_tp), each against the one-rank
             step on the card as training runs it, timed and gated (the
             sharded step pins cuDNN's deterministic algorithms itself,
             ROADMAP C4); a 3-step TP fleet whose server serves the
             gathered params; its save at {data 1, model 2} restored at
             {data 1, model 1} bit-equal. It prints each mode's ms per step
             in both runs and the save's and the restore's ms.
23. full_feature — the learner extensions' main path: `driver.train` on
             the 30 fake DMLab-30 levels at the fleet phase's widths in
             bfloat16, with PopArt over the 30 tasks, pixel control at
             0.01 and the instruction encoder, 32 process-hosted actors
             stamping level ids i % 30, for 5 learner steps (3 timed):
             K1 once per learner step, finite losses, every task's PopArt
             statistics moved; env-frames/s, ms per learner step, the
             blocked-get share, device busy and idle share (torch.profiler,
             last 2 steps), peak memory and the PopArt sigma range.
24. full_feature_reference — the float32 full-feature learner step (deep
             torso, 72x96, T=20, B=4, 30 tasks) on the card against the
             CPU from one seeded state on one fixed batch: loss, grad
             norm, pixel-control loss and PopArt statistics rtol 1e-4;
             each parameter tensor within 4x the CPU float32 run's
             distance to the same step with float64 layers on the CPU,
             or 1e-3 of its update's norm, whichever is larger.
25. cli_full_feature — the CLI with the full-feature flags for 1 step.
26. impact_fleet — IMPACT with sample reuse (replay_k 2, replay_ratio
             0.5, target_update_interval 4) at the same widths in float32
             for 8 learner steps: K1 once per step (on the target
             network's inputs), the frame clock at the fresh slots served,
             re-serves and replayed unrolls, the target equal to the params
             after step 8's refresh; fresh frames against steps x
             frames_per_step, the tier's occupancy, the clip fraction.
27. extensions_anakin — `anakin.train` with PopArt, pixel control and the
             instruction encoder at the slice's widths for 3 fused steps.
28. popart_dp — 2 gloo ranks: the data-parallel fleet with PopArt, pixel
             control and the instruction encoder for 4 learner steps (K1b
             per step per rank, params and PopArt statistics bit-equal
             across the ranks after every step), then the sharded step on
             a fixed full-width batch against the one-rank step.
29. fit — parallel/fit.py's memory fit at B=32 and B=16 per card: one
             full-feature bf16 step each, peak memory against 0.85 of the
             card's.
30. procgen_anakin — the procgen core (8 levels, wall density 0.25, 5x5,
             4 actions) with the regret curriculum at the slice's widths:
             4 fused steps through `anakin.run`, one K1 launch each, the
             curriculum's entropy and levels visited; then one unroll's
             score update on the card against the CPU's on the same batch
             and level ids (rtol 1e-6, visits exact).
31. pbt_vectorized — the population's main path: 4 members in lockstep
             (--pbt_vectorized) on procgen with the regret curriculum at
             the slice's widths, through driver.train_population, 2 rounds
             of 2 lockstep steps: K1 launched once per lockstep step (4,
             not 16), the record (PBT_LOG.json, population_summaries.jsonl,
             pbt_winner), each member's ladder at every round, peak memory.
             Before it, members 0 and 1's lockstep train steps against the
             serial member's train step (its member config) from the same
             state on the same batch (slice_reference's bar); after it, the
             CLI form as a subprocess.
32. pbt_serial — the serial population over two suites (procgen and
             gridworld, 2 members each) at T=20, B=8 for 3 rounds: every
             exploit goes through train_anakin(initial_state=...), at least
             one.
33. curriculum_dp — the td curriculum through driver.train_anakin over 2
             gloo ranks sharing the card, 3 full-width steps: K1b once per
             step per rank, the ranks' score and visit tables bit-equal,
             CURRICULUM_LEVELS.json and the curriculum summaries.
34. filler_fleet — the hybrid filler on the fleet phase's run with the
             host procgen env in the 32 actors' processes and IMPACT, 5
             learner steps: the fleet's clocks as without the filler
             (update_steps, frames, the RMSProp count, the LR per step),
             filler updates > 0, K1 once per learner step and per filler
             update.
35. deep_fast — the slice with torso=deep_fast in float32 and bf16, 3
             fused steps each; its train step card vs CPU on the small
             fixed batch at slice_reference's bar.
36. cores_anakin — the gridworld and cue-memory cores at the slice's widths
             cut to T=20, 2 fused steps each.
37. eval_cli — the fleet CLI trains 1 learner step on the 30 fake DMLab-30
             levels (float32) and saves; `--mode=test` with
             test_num_episodes=1 evaluates from the same logdir: exit 0,
             eval_summaries.jsonl holds 30 finite test_episode_return rows
             at the restored step 1 and the dmlab30 scores, equal to
             suites.eval_scores over the rows; the eval's peak device memory
             against the trainer's, its mean merged batch and wall times.
38. state_cache_fleet — the fleet phase with the state arena, 6 learner
             steps (K1 once per step), set_target_size(16) after step 2 and
             (32) after step 4: slots released and re-acquired; with one
             3-step carry run after it, one cache/carry pair: ms per
             learner step, env-frames/s, host<->device bytes per actor
             step.
39. state_cache_reference — 32 fixed callers through the cache path and
             the carry path on the card, one merged batch per step, 3
             steps with done edges and a slot reused after release, the
             callers started 20 ms apart so that both servers merge them
             in the same order: every output and new carry bit-equal.
40. serving — the version table at the slice's widths: 3 resident, 5
             publishes, version 1 pinned; A/B and shadow 0.25 (divergence 0
             on equal params, > 0 on perturbed ones); int8 resident bytes
             against float32, its logits equal to a float32 server's on
             the dequantized params (rtol 1e-5 / atol 1e-5), != the
             float32 params' and within the first-order bound
             max_abs_error gives, greedy agreement; serving_aot's flip to
             the int8 structure with aot_misses 0. Then batch_fn: 24
             threads with their own rows through
             batch_fn_with_options(minimum_batch_size=16, timeout_ms=20)
             around the full-width T=1 forward, each caller's logits and
             baseline against an unbatched forward of its rows (rtol
             1e-5 / atol 1e-5, float32, TF32 off), the mean merged batch
             and us per merged call; and a FamilyBatcher over [72, 96]
             and [48, 64] frames (each family's agent built on the card
             by make_fn), held the same way, its padding_stats equal to
             the request stream's counts.
41. admission — 32 actors on 16 slots: block (handover, no raise), shed
             (driver.train for 3 learner steps, sheds in the summaries, K1
             once per step), grow (16 -> 32, carries bit-equal).
42. mixed_fleet — fleet_tasks='gridworld:2,procgen', 4 actions, PopArt, 32
             process-hosted actors, 4 learner steps: plan 21/11, two PopArt
             slots, both tasks' episode curves, K1 once per step.
43. telemetry_fleet — the fleet phase's configuration (32 process-hosted
             actors, K1 in the learner step), publishing every learner
             step, with telemetry_trace=True and
             lock_order_check=True, alternated with telemetry_trace=False,
             one pair of 3-step runs in this process. The traced run:
             trace/batches equals the learner steps, no untagged unroll,
             no dropped record, every span stamped done <= staged <= serve
             <= step in HOP_ORDER, one lag entry per unroll with a known
             behaviour version, 0 lock-order cycles; per-hop p50/p99 and
             the policy-lag histogram by the port's trace_report
             (`scalable_agent_tpu_torch.scripts.trace_report`), whose CLI
             (`main([logdir, '--json', out])`) must exit 0 with the same
             batch count in its JSON; the port's to_tensorboard converts
             the logdir, and TensorBoard's EventAccumulator must read
             back every tag of summaries.jsonl in the train run and the
             lag, e2e and per-hop tags in the trace run. Both runs: ms
             per learner step (the pair's traced / untraced ratio), host
             CPU seconds per learner step by thread group (actors,
             inference dispatch and completion, the prefetcher, the
             learner's main thread, the rest) and of the env processes
             from /proc. The tracer's own cost, replayed on
             a traced run's counts (us per unroll, ms per on_step), and
             an acquire of an ordered lock against a plain one times the
             run's acquires per step.
44. faults_fleet — the fleet phase's widths with 20-step unrolls, 4 learner
             steps: an env_step
             'raise' in one actor (respawned, an actors_respawned
             incident, an unroll completed after the respawn) and
             slow_learner 'hang' 12 s before steps 2 and 3
             (fault_slow_learner incidents, buffer/put_waits rising in the
             registry, the steps completed); the incident lines printed;
             the port's trace_report over the run's traces and incidents
             reads 4 batches and marks the respawn and both slow steps.
45. remote_fleet — remote actors at the fleet phase's widths:
             `driver.train` with num_actors=0 and remote_actor_port for 4
             learner steps, publishing at step 3 (the param lane sends no
             'bye' to a host mid-fetch at the learner's close, as in JAX,
             so the last step publishes nothing), fed by 2 actor-host
             processes of the CLI
             (`--job_name=actor --task=0/1 --num_actors=16`, envs in their
             own processes, inference on the card): update_steps 4, one
             K1 launch per learner step, ingest unrolls >= 4 x 32 and the
             local fleet's 0, no CRC, stale-epoch, discard, digest or
             validation refusal, both hosts joined, one serialization per
             published version, both hosts exit 0 on the learner's 'bye'.
             It prints ms per learner step (median of steps 2-4) beside the
             fleet phase's, the learner process's idle share
             (torch.profiler, steps 2-4), unrolls/s and MB/s over the wire
             and the bytes of one unroll's frame, the ack p50/p99, the bf16
             param blob's bytes and a publish's ms, and peak memory; the
             idle share must not read empty. At the last step, after the
             timed window, the fleet_stats module (--json) against the
             live ingest agrees with fetch_stats() taken in this process
             around it. Actor
             hosts run with faulthandler: one still running 60 s after
             the learner's end gets SIGABRT (its threads' stacks go into
             its log) before the kill, and the phase fails.
46. remote_faults — the drill: one actor host (16 actors,
             actor_reconnect_secs=120) feeds the learner CLI (num_actors=0,
             a checkpoint every step) whose fault plan from the
             environment holds wire_bitflip once (it fires in the actor
             host, which gets the same plan), publish_corrupt at each of
             its 4 publishes and learner_crash at the 5th consumed batch;
             the learner dies by SIGKILL, the same CLI restarted on the
             same port resumes from step 4 and reaches its 5-step budget
             publishing nothing, the
             host reattaches (counted) and exits 0 on the bye; no
             stale-epoch unroll arrives, a CRC refusal was followed by a
             resend, the corrupt publishes were refused and none was
             installed;
             the refusal burned wire_crc_rejected_zero (a durable
             slo_violation incident: the SIGKILLed learner writes no
             verdict), and the restarted learner's SLO_VERDICT.json ends
             clean at step 5.
47. routed_serving — routed serving at the fleet phase's widths: two
             in-process replicas (an ingest listener with its own
             InferenceServer on the card, serve_remote attached) behind
             a ServingRouter; 24 batches of 32 (more, up to 48, until the
             router has picked the closed replica once), replica 0 closed
             without a 'bye' before batch 10: both served before, the
             survivor every batch after (a failover, zero
             NoReplicasAvailable),
             its drain notice then empties the rotation; 9 routed results
             against the CPU's forward (rtol 1e-4 / atol 1e-5); the
             routed-latency objective and serving_latency_p99_ms judged
             by the port's SloEvaluator, never burning.
48. chaos_fault — the port's fault storm (`python -m
             scalable_agent_tpu_torch.scripts.chaos --device=cuda` with
             CHAOS_SMOKE=1 CHAOS_STORM=fault, seed 1) as a process on the
             card, its actor-host child on the card too: env hang and
             raise, socket garbage, a NaN burst and an interrupted save
             under the armed lock-order checker. Exit 0, `chaos_ok` true,
             no crash, health rollbacks >= 1, ingest quarantined >= 1,
             zero lock-order cycles, and an SLO verdict whose violations
             include ingest_quarantine_zero and rollbacks_zero (JAX's
             storm's asserts); it prints the storm's figures and the full
             set of violations. Its learner is a subprocess: its launches
             are not counted (the drills' configs leave use_pallas_vtrace
             off, as JAX's do).
49. compare_torsos — the port's deep against deep_fast harness (`python
             -m scalable_agent_tpu_torch.scripts.compare_torsos
             --device=cuda` with SMOKE=1: cue_memory, 2 actors, B=2, T=8,
             24x32, float32, 8 learner steps per torso) as a process on
             the card: exit 0, JAX's artifact keys, both torsos with 8
             steps and 128 frames on cuda, decile curves of 10 buckets or
             none, finite tail means. It launches no kernel
             (use_pallas_vtrace off, as in JAX's script); the full size
             (400 steps each, 72x96 bf16) runs on its own, not here.

The SLO engine (slo.py) runs at its default, on, in every fleet, Anakin
and population run here; the phases' own profiler windows refuse to start
over another session, and the engine's captures never start under one.
The self-healing controller (controller.py) runs at its default, observe,
in every fleet run but rollback_fleet's, which acts: each such phase
reads its CONTROLLER_LOG.json (every rank's, every run's) and its
controller_action incidents, and fails on an applied move or on a
virtual one that the phase's known burns do not imply (a virtual
replay_k move of learner_plane_utilization anywhere; admission
block->shed of unroll_e2e_p99_ms in remote_faults; fleet_size up of
fleet_healthy_fraction's thin margin in admission's shed run, which
quarantines half its actors). The fleet phase also
prints a controller tick's cost on this host, idle and acting.

Every CLI phase checks that its process logged `float32 precision: tf32 off
(cudnn, matmul)`: the port's entry points run float32 layers without TF32.
Phases whose work is in subprocesses and whose checks are of correctness
run at once, to keep the script inside its time limit: cli, cli_bf16 and
cli_dp; and, last, drain_fleet, cli_fleet_dp, cli_full_feature,
remote_faults, eval_cli, chaos_fault and compare_torsos.

The script makes itself its descendants' subreaper (prctl
PR_SET_CHILD_SUBREAPER), so a process orphaned by a killed parent (a
SIGKILLed learner's or actor host's forkserver and env processes) is
still its child. When the phases end, pass or fail, it waits up to 10 s
for every child left to exit, SIGKILLs the rest, reaps them, and logs
each one and the count, before it prints its last two lines.

The forkserver that env processes fork from is started before the first
CUDA call. Every kernel's launch count is set to 0 just before each path
(the three slices, the fleet, the K2 entry point, resume_anakin's second
call, rollback_fleet, unroll_fleet, full_feature, impact_fleet and
extensions_anakin, procgen_anakin, pbt_vectorized, pbt_serial,
filler_fleet, deep_fast, cores_anakin, state_cache_fleet, admission's shed
run, mixed_fleet, telemetry_fleet, faults_fleet, remote_fleet and
routed_serving (which launches none); the ranks of slice_dp,
dp_fleet, tp, popart_dp and curriculum_dp count their own and report
them)
and read just after; a kernel that its
path did not launch fails the run. The second-to-last line of the output is the
JSON `{"kernels": [...]}` record, the last `{"ok": true, "device": {...}}`.
Without CUDA, or run outside the repo, it exits non-zero before printing
either.
"""

import collections
import contextlib
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import math
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The port first: outside the repo this import fails before any output.
from scalable_agent_tpu_torch import checkpoint as checkpoint_lib
from scalable_agent_tpu_torch import controller as controller_lib
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch import popart as popart_lib
from scalable_agent_tpu_torch import slo
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis import runtime as lock_check
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.models.agent import make_step_fn
from scalable_agent_tpu_torch.models.torsos import max_pool_same, scaled_nchw
from scalable_agent_tpu_torch.observability import cuda_median_ms
from scalable_agent_tpu_torch.observability import profiled_device_us
from scalable_agent_tpu_torch.ops import build
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import dynamic_batching
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.profile_anakin import SLICE
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.runtime import py_process
from scalable_agent_tpu_torch.runtime import remote
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime import routing
from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script
from scalable_agent_tpu_torch.scripts import fleet_stats as fleet_stats_script
from scalable_agent_tpu_torch.scripts import to_tensorboard
from scalable_agent_tpu_torch.scripts import trace_report
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (the V-trace kernel is scalar float32 code).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per element of [T, N] the kernel does one exp, three minimums and about
# twelve adds and multiplies.
VTRACE_OPS_PER_ELEMENT = 16

SLICE_STEPS = 4

CONV_POOL_SHAPES = [(3232, 72, 96), (32, 72, 96), (5, 21, 27), (7, 72, 96),
                    (3, 1, 1)]
VTRACE_SHAPES = [(100, 32), (100, 128), (7, 300), (6, 70, 3), (257, 45),
                 (1000, 32)]

CLIPS = [(1.0, 1.0), (None, None), (3.7, 2.2)]
# K1b: (global shape, ranks); timed at the slice's per-rank shape.
K1B_CASES = [((100, 32), 2), ((100, 32), 4), ((6, 70, 3), 2)]
K1B_TIMED = ((100, 32), 2)

# The fleet phase: the slice's widths through the fleet runtime.
FLEET = dict(SLICE, num_actors=32, use_py_process=True, episode_length=100,
             num_action_repeats=4, publish_params_every=3, summary_secs=0)
FLEET_STEPS = 8
FLEET_TIMED_FROM = 2     # steps 3..8 are timed
FLEET_PROFILED_FROM = 6  # steps 7..8 are profiled
SLO_OBSERVE_REPS = 20
PUBLISH_RACE_CALLERS = 8
PUBLISH_RACE_ROUNDS = 40

DP_RANKS = 2
DP_TIMEOUT_SECS = 900
GROUP_TIMEOUT_SECS = 300

# Launch counters of every kernel of the port, by kernel name.
COUNTERS = {'vtrace': vtrace_cuda.from_importance_weights,
            'conv_pool': conv_pool_cuda.fused_conv_pool,
            'vtrace_sharded': vtrace_cuda.sharded_from_importance_weights}


def log(*args):
  print(*args, flush=True)


REPO_DIR = os.path.dirname(os.path.abspath(__file__))
LINT_TIMEOUT_SECS = 300
EVENT_COST_REPS = 200


def _module_run(module, *args, timeout=LINT_TIMEOUT_SECS):
  """`python -m <module> <args>` from the repo's root; the finished
  process, its output captured."""
  return subprocess.run([sys.executable, '-m', module, *args],
                        capture_output=True, text=True, timeout=timeout,
                        cwd=REPO_DIR)


def _in_thread(fn, out):
  """A started daemon thread that appends fn()'s result, or the
  exception it raised, to `out`."""
  def run():
    try:
      out.append(fn())
    except BaseException as e:  # the caller raises it
      out.append(e)
  thread = threading.Thread(target=run, daemon=True)
  thread.start()
  return thread


def _joined(name, thread, out, timeout):
  """The result `_in_thread` left once the thread ends; raises what it
  raised, or when it did not end in `timeout` seconds."""
  thread.join(timeout)
  if not out:
    raise AssertionError(f'{name} did not end in {timeout} s')
  if isinstance(out[0], BaseException):
    raise AssertionError(f'{name} failed: {out[0]!r}') from out[0]
  return out[0]


def _event_costs(reps=EVENT_COST_REPS):
  """us per EventLog.event() (median over `reps`) for a kind that holds a
  durable marker (fsync'd) and one that holds none."""
  costs = {}
  with tempfile.TemporaryDirectory(prefix='chip_smoke_events_') as logdir:
    events = observability.EventLog(logdir)
    try:
      for kind in ('rollback', 'actors_respawned'):
        times = []
        for i in range(reps):
          t = time.perf_counter()
          events.event(kind, step=i, detail='x')
          times.append(1e6 * (time.perf_counter() - t))
        costs[kind] = (statistics.median(times), max(times))
    finally:
      events.close()
  return costs


def phase_device():
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  log(f'torch {torch.__version__} cuda {torch.version.cuda} '
      f'device 0: {torch.cuda.get_device_name(0)} '
      f'count {torch.cuda.device_count()}')
  return card


def phase_build():
  """Run the lint module over the tree, then build every kernel (and,
  beside the nvcc processes, the batcher's native stress test); returns
  {source: {kernel: ptxas's numbers}}."""
  t = time.perf_counter()
  lint = _module_run('scalable_agent_tpu_torch.scripts.lint')
  lint_secs = time.perf_counter() - t
  if lint.returncode != 0:
    raise AssertionError(f'scalable_agent_tpu_torch.scripts.lint exited '
                         f'{lint.returncode}:\n{lint.stdout}{lint.stderr}')
  log(f'build: the lint module (every checker, the whole tree) clean, '
      f'{lint_secs:.2f} s alone (process start included): '
      f'{lint.stderr.strip()}')
  t0 = time.perf_counter()
  native = []
  batcher_test = _in_thread(lambda: (
      build.run_host_test('batcher_test', 'plain'), time.perf_counter()),
                            native)
  paths = build.build_all()
  log(f'build: {len(paths)} kernel libraries in '
      f'{time.perf_counter() - t0:.2f} s: '
      + ', '.join(os.path.relpath(p) for p in paths))
  proc, done = _joined('batcher_test', batcher_test, native,
                       LINT_TIMEOUT_SECS)
  if proc.returncode != 0:
    raise AssertionError(f'batcher_test exited {proc.returncode}:\n'
                         f'{proc.stdout}{proc.stderr}')
  log(f'build: batcher_test (g++ {" ".join(build.HOST_TEST_FLAGS["plain"])}'
      f') built and passed {done - t0:.2f} s from the start, beside the '
      f'kernels\' builds: {proc.stdout.strip().splitlines()[-1]}')
  costs = _event_costs()
  log('build: EventLog.event() on this host\'s temp directory, median (max) '
      f'over {EVENT_COST_REPS}: a durable kind (rollback, fsync\'d) '
      f'{costs["rollback"][0]:.1f} us ({costs["rollback"][1]:.1f}); a '
      f'non-durable kind (actors_respawned, line-buffered, no fsync) '
      f'{costs["actors_respawned"][0]:.1f} us '
      f'({costs["actors_respawned"][1]:.1f})')
  reports = {name: build.ptxas_report(name) for name in build.sources()}
  for name, kernels in reports.items():
    if not kernels:
      raise AssertionError(f'no ptxas report for csrc/{name}.cu')
    for kernel, numbers in kernels.items():
      log(f'ptxas {name}: {kernel}: {numbers}')
      if numbers.get('spill_stores') or numbers.get('spill_loads'):
        raise AssertionError(f'{kernel} spills: {numbers}')
  return reports


def phase_launch_floor():
  """Device time per launch of a one-element add_ (torch.profiler)."""
  one = torch.zeros(1, device='cuda')
  floor_us = profiled_device_us(lambda: one.add_(1.0), 200, None)
  if floor_us is None:
    raise AssertionError('torch.profiler showed no device time')
  log(f'launch floor: one-element add_ {floor_us:.3f} us device time per '
      'launch (torch.profiler, 200 launches)')
  return floor_us


def _vtrace_inputs(shape, seed):
  rng = np.random.RandomState(seed)
  arrays = dict(
      log_rhos=rng.randn(*shape) * 0.8,
      discounts=0.99 * (rng.rand(*shape) > 0.1),
      rewards=rng.randn(*shape),
      values=rng.randn(*shape),
      bootstrap_value=rng.randn(*shape[1:]))
  return {k: torch.tensor(v, dtype=torch.float32, device='cuda')
          for k, v in arrays.items()}


def _vtrace_bound_ms(shape):
  t, n = shape[0], math.prod(shape[1:])
  nbytes = 4 * (4 * t * n + n + 2 * t * n)
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = VTRACE_OPS_PER_ELEMENT * t * n / F32_OPS_PER_S * 1e3
  return (max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms
          else 'operations', nbytes)


def phase_kernels():
  """V-trace kernel vs its plain twin, bit for bit; returns the record at
  [100, 32]."""
  record = None
  for seed, shape in enumerate(VTRACE_SHAPES):
    for clips in CLIPS:
      x = _vtrace_inputs(shape, seed)
      kw = dict(clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
      vs, pg = vtrace_cuda.from_importance_weights(**x, **kw)
      torch.cuda.synchronize()
      ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(**x, **kw)
      err = max(float((vs - ref_vs).abs().max()),
                float((pg - ref_pg).abs().max()))
      if not (torch.equal(vs, ref_vs) and torch.equal(pg, ref_pg)):
        raise AssertionError(f'vtrace {list(shape)} clips={clips} is not '
                             f'bit-equal to its twin: max diff {err}')
      line = f'vtrace {list(shape)} clips={clips}: bit-equal to the twin'
      if clips == (1.0, 1.0):
        launch = lambda: vtrace_cuda.from_importance_weights(**x, **kw)  # noqa: E731
        ms = cuda_median_ms(launch, 200)
        device_us = profiled_device_us(launch, 200, 'vtrace_kernel')
        plain_ms = cuda_median_ms(
            lambda: vtrace_cuda.plain_from_importance_weights(**x, **kw), 30)
        bound_ms, bound_by, nbytes = _vtrace_bound_ms(shape)
        line += (f'; kernel {ms:.5f} ms per call (CUDA events), '
                 f'{_us(device_us)} device time per launch; plain '
                 f'{plain_ms:.5f} ms; bound {bound_ms:.3e} ms ({bound_by}, '
                 f'{nbytes} bytes)')
        if shape == VTRACE_SHAPES[0]:
          record = dict(ms=ms, device_us=device_us, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        max_abs_err=0.0)
      log(line)
  return record


def _us(device_us):
  return ('not measured (no device events)' if device_us is None
          else f'{device_us:.3f} us')


def _k1b_per_rank(x, shards, kw):
  """K1b on each rank's block of `x` (an explicit-rank mesh per rank):
  the ranks' (vs, pg) concatenated along the batch dim."""
  ndim = x['log_rhos'].ndim
  batch = x['log_rhos'].shape[1]
  outs = []
  for rank in range(shards):
    local = {k: sharding.local_shard(
        v, (sharding.spec_batch_lead(ndim - 1) if k == 'bootstrap_value'
            else sharding.spec_time_major(ndim)), rank, shards).contiguous()
             for k, v in x.items()}
    mesh = mesh_lib.Mesh(rank=rank, size=shards,
                         device=x['log_rhos'].device)
    outs.append(vtrace_cuda.sharded_from_importance_weights(
        mesh, **local, **kw, batch_size=batch))
  return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def phase_vtrace_sharded():
  """K1b per rank against K1 on the whole batch and the plain twin (both
  bit-equal); its times at the per-rank shape [100, 16]."""
  for seed, (shape, shards) in enumerate(K1B_CASES):
    for clips in CLIPS:
      x = _vtrace_inputs(shape, seed)
      kw = dict(clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
      vs, pg = _k1b_per_rank(x, shards, kw)
      whole_vs, whole_pg = vtrace_cuda.from_importance_weights(**x, **kw)
      torch.cuda.synchronize()
      if not (torch.equal(vs, whole_vs) and torch.equal(pg, whole_pg)):
        raise AssertionError(
            f'K1b over {shards} ranks at {list(shape)} clips={clips} is not '
            f'bit-equal to K1: max diff '
            f'{float((vs - whole_vs).abs().max())}, '
            f'{float((pg - whole_pg).abs().max())}')
      ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(**x, **kw)
      if not (torch.equal(vs, ref_vs) and torch.equal(pg, ref_pg)):
        raise AssertionError(
            f'K1b over {shards} ranks at {list(shape)} clips={clips} is not '
            f'bit-equal to the twin: max diff '
            f'{float((vs - ref_vs).abs().max())}, '
            f'{float((pg - ref_pg).abs().max())}')
      log(f'vtrace_sharded {list(shape)} over {shards} ranks clips={clips}: '
          'bit-equal to K1 and to the twin')
  x = _vtrace_inputs((6, 70, 3), 0)
  try:
    _k1b_per_rank(x, 4, {})
  except ValueError as e:
    log(f'vtrace_sharded [6, 70, 3] over 4 ranks raises: {e}')
  else:
    raise AssertionError('K1b split B=70 over 4 ranks')

  (shape, shards) = K1B_TIMED
  local_shape = (shape[0], shape[1] // shards) + shape[2:]
  x = _vtrace_inputs(local_shape, 0)
  mesh = mesh_lib.Mesh(rank=0, size=shards, device=x['log_rhos'].device)
  launch = lambda: vtrace_cuda.sharded_from_importance_weights(  # noqa: E731
      mesh, **x, batch_size=shape[1])
  ms = cuda_median_ms(launch, 200)
  device_us = profiled_device_us(launch, 200, 'vtrace_kernel')
  plain_ms = cuda_median_ms(
      lambda: vtrace_cuda.plain_from_importance_weights(**x), 30)
  bound_ms, bound_by, nbytes = _vtrace_bound_ms(local_shape)
  log(f'vtrace_sharded per-rank shape {list(local_shape)}: {ms:.5f} ms per '
      f'call (CUDA events), device time per launch {_us(device_us)}; plain '
      f'{plain_ms:.5f} ms; bound {bound_ms:.3e} ms ({bound_by}, {nbytes} '
      'bytes)')
  return dict(ms=ms, device_us=device_us, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)


def _param_snapshot(params):
  return {k: v.detach().to('cpu', copy=True) for k, v in params.items()}


def _drive(path, fn):
  """Run one path with every launch count set to 0 just before it;
  returns (fn's result, the counts just after)."""
  for counter in COUNTERS.values():
    counter.launches = 0
  out = fn()
  counts = {name: counter.launches for name, counter in COUNTERS.items()}
  log(f'{path}: kernel launches {counts}')
  return out, counts


def phase_slice(compute_dtype='float32'):
  log(f'slice at compute_dtype={compute_dtype}; float32 layers without '
      f'TF32: torch.backends.cudnn.allow_tf32='
      f'{torch.backends.cudnn.allow_tf32} '
      f'torch.backends.cuda.matmul.allow_tf32='
      f'{torch.backends.cuda.matmul.allow_tf32}')
  config = Config(**SLICE, compute_dtype=compute_dtype)
  # The same seed initialises the same params on any device (a CPU
  # generator), so this snapshot is the run's initial params.
  _, _, _, cpu_carry = anakin.build_run(config, device='cpu')
  initial = _param_snapshot(cpu_carry.train_state.params)

  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  (carry, history, fps), counts = _drive(
      f'slice {compute_dtype}',
      lambda: anakin.run(config, SLICE_STEPS, device='cuda'))
  wall = time.perf_counter() - t0
  launches = counts['vtrace']

  losses = [h['total_loss'] for h in history]
  if not all(math.isfinite(v) for v in losses):
    raise AssertionError(f'non-finite losses: {losses}')
  if carry.train_state.update_steps != SLICE_STEPS:
    raise AssertionError(f'update_steps {carry.train_state.update_steps}')
  if launches != SLICE_STEPS:
    raise AssertionError(f'V-trace kernel launched {launches} times in '
                         f'{SLICE_STEPS} fused steps')
  state = carry.train_state
  not_f32 = [k for tree in (state.params, state.opt_state.nu)
             for k, v in tree.items() if v.dtype != torch.float32]
  not_f32 += [f'core_state[{i}]' for i, v in enumerate(carry.core_state)
              if v.dtype != torch.float32]
  if not_f32:
    raise AssertionError(f'not float32 after training: {not_f32}')
  final = _param_snapshot(carry.train_state.params)
  moved = max(float((final[k] - initial[k]).abs().max()) for k in final)
  if not moved > 0:
    raise AssertionError('params did not change')
  step_ms = config.frames_per_step / fps * 1e3
  MEASURED[f'slice_{compute_dtype}_step_ms'] = step_ms
  log(f'slice {compute_dtype}: {SLICE_STEPS} fused steps in {wall:.2f} s '
      f'(first one untimed); losses {losses}; mean_reward '
      f'{[h["mean_reward"] for h in history]}; max |param change| '
      f'{moved:.3e}; vtrace launches {launches}')
  log(f'slice {compute_dtype}: {fps:.1f} env-frames/s, {step_ms:.2f} ms '
      f'per fused step ({config.frames_per_step} frames), '
      f'max_memory_allocated '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
  return counts


def _small_batch(t, b, a, h, w, seed=0):
  rng = np.random.RandomState(seed)
  tensor = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
  return ActorOutput(
      level_name=torch.zeros(b, dtype=torch.int32),
      agent_state=(tensor(rng.randn(b, 256).astype(np.float32) * 0.3),
                   tensor(rng.randn(b, 256).astype(np.float32) * 0.3)),
      env_outputs=StepOutput(
          tensor(rng.randn(t + 1, b).astype(np.float32)),
          StepOutputInfo(torch.zeros(t + 1, b),
                         torch.zeros(t + 1, b, dtype=torch.int32)),
          tensor(rng.rand(t + 1, b) > 0.8),
          (tensor(rng.randint(0, 256, (t + 1, b, h, w, 3)).astype(
              np.uint8)),
           torch.zeros(t + 1, b, 16, dtype=torch.int32))),
      agent_outputs=AgentOutput(
          tensor(rng.randint(0, a, (t + 1, b))),
          tensor(rng.randn(t + 1, b, a).astype(np.float32)),
          tensor(rng.randn(t + 1, b).astype(np.float32))))


def _train_small_batch(config, device, steps=2):
  """`steps` train steps on the fixed small batch from the config's seeded
  params: (losses, initial params, final params) on the CPU."""
  _, agent, _, carry = anakin.build_run(config, device=device)
  step = learner.make_train_step_fn(agent, config)
  state = carry.train_state
  initial = _param_snapshot(state.params)
  batch = map_structure(lambda x: x.to(device),
                        _small_batch(5, 3, 9, 24, 32))
  losses = []
  for _ in range(steps):
    state, metrics = step(state, batch)
    losses.append(float(metrics['total_loss']))
  return np.asarray(losses), initial, _param_snapshot(state.params)


def _small_config(compute_dtype):
  return Config(**dict(SLICE, height=24, width=32, batch_size=3,
                       unroll_length=5, num_action_repeats=1,
                       total_environment_frames=100,
                       compute_dtype=compute_dtype))


def phase_slice_reference():
  """Two train steps on a fixed small batch, card vs CPU, from the same
  params: the card runs the CUDA kernel, the CPU its plain twin. Loss
  rtol 1e-4, params rtol 1e-3 / atol 1e-5 (float32 convolutions summed in
  another order, through RMSProp's 1/sqrt)."""
  config = _small_config('float32')
  cpu_losses, _, cpu_params = _train_small_batch(config, 'cpu')
  gpu_losses, _, gpu_params = _train_small_batch(config, 'cuda')
  np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
  err = 0.0
  for k in cpu_params:
    np.testing.assert_allclose(gpu_params[k].numpy(), cpu_params[k].numpy(),
                               rtol=1e-3, atol=1e-5, err_msg=k)
    err = max(err, float((gpu_params[k] - cpu_params[k]).abs().max()))
  log(f'slice reference: losses card {gpu_losses.tolist()} cpu '
      f'{cpu_losses.tolist()}; max |param diff| {err:.3e}')


def _within_bf16_error(got, ref16, ref32, what, atol=1e-3, rtol=2**-5):
  """tests/test_torch_bf16.py's bar, with the CPU as the reference:
  max|got - ref16| <= 2 max|ref16 - ref32| + atol and <= rtol max|ref32|.
  Returns max|got - ref16|."""
  got, ref16, ref32 = (np.asarray(x, np.float32) for x in (got, ref16, ref32))
  err = float(np.max(np.abs(got - ref16)))
  bound = min(2 * float(np.max(np.abs(ref16 - ref32))) + atol,
              rtol * float(np.max(np.abs(ref32))))
  if not err <= bound:
    raise AssertionError(f'{what}: max|card_bf16 - cpu_bf16| {err} > '
                         f'{bound}')
  return err


def phase_slice_bf16_reference():
  """The bf16 train step, card vs CPU, on the fixed small batch: held as
  tests/test_torch_bf16.py holds the port to JAX, with the CPU's bf16 and
  float32 runs as the reference pair. Loss: max|card - cpu_bf16| <=
  2 max|cpu_bf16 - cpu_f32| + 1e-3 and <= 2**-5 max|cpu_f32|. Parameter
  updates: the same with 1e-3 of the largest float32 update in place of
  1e-3, and 0.25 in place of 2**-5."""
  cpu32_losses, initial, cpu32 = _train_small_batch(
      _small_config('float32'), 'cpu')
  config = _small_config('bfloat16')
  cpu16_losses, _, cpu16 = _train_small_batch(config, 'cpu')
  gpu16_losses, _, gpu16 = _train_small_batch(config, 'cuda')
  loss_err = _within_bf16_error(gpu16_losses, cpu16_losses, cpu32_losses,
                                'total_loss')
  update_err = 0.0
  for k in initial:
    moved32 = cpu32[k] - initial[k]
    update_err = max(update_err, _within_bf16_error(
        gpu16[k] - initial[k], cpu16[k] - initial[k], moved32, k,
        atol=1e-3 * float(moved32.abs().max()), rtol=0.25))
  log(f'slice_bf16 reference: losses card {gpu16_losses.tolist()} cpu '
      f'bf16 {cpu16_losses.tolist()} cpu f32 {cpu32_losses.tolist()}; max '
      f'|update diff| card vs cpu bf16 {update_err:.3e}; loss diff '
      f'{loss_err:.3e}')


def phase_conv_pool():
  """K2 against its plain twin at the three shapes, and its times."""
  record = None
  worst = 0.0
  for seed, shape in enumerate(CONV_POOL_SHAPES):
    frames, weight, bias = conv_pool_script.make_inputs(*shape, 'cuda',
                                                        seed=seed)
    out = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
    torch.cuda.synchronize()
    check = conv_pool_script.parity(
        out, conv_pool_cuda.plain_conv_pool(frames, weight, bias))
    worst = max(worst, check['max_abs_err'])
    times = conv_pool_script.timings(frames, weight, bias)
    log(f'conv_pool {list(shape)}: max_abs_err {check["max_abs_err"]:.3e} '
        f'(tolerance {2**-7 * check["scale"]:.3e}), {check["n_differ"]} of '
        f'{out.numel()} elements differ; kernel {times["ms"]:.5f} ms plain '
        f'{times["plain_ms"]:.5f} ms library {times["library_ms"]:.5f} ms '
        f'bound {times["bound_ms"]:.5f} ms ({times["bound_by"]}, '
        f'{times["bytes"]} bytes, {times["flops"]} FLOP)')
    if shape == CONV_POOL_SHAPES[0]:
      record = times
      record['device_us'] = profiled_device_us(
          lambda: conv_pool_cuda.fused_conv_pool(frames, weight, bias), 20,
          'conv_pool_kernel')
      record['n_differ'] = check['n_differ']
      log(f'conv_pool {list(shape)}: {_us(record["device_us"])} device time '
          'per launch (torch.profiler, 20 launches)')
  record['max_abs_err'] = worst
  return record


def phase_conv_pool_torso():
  """K2 computes the bf16 trainer's section 1: against the port's bf16
  deep torso (`sections[0].conv`, then `max_pool_same`) on the section's
  own weights, with a nonzero bias, at the acting batch [32, 72, 96].
  The torso rounds its conv before adding the bias, K2 after pooling;
  max commutes with both roundings, so the two differ by the conv's
  summation order: one bf16 ulp of the pre-bias value plus one of the
  output, max|K2 - torso| <= 2**-7 * (2 max|torso| + max|b|)."""
  config = Config(**SLICE, compute_dtype='bfloat16')
  agent = driver.build_agent(config, SLICE['num_actions'])
  generator = torch.Generator().manual_seed(config.seed)
  init_params(agent, generator)
  conv = agent.torso.sections[0].conv
  with torch.no_grad():
    conv.bias.copy_(torch.randn(conv.bias.shape, generator=generator) * 0.3)
  agent.to('cuda')
  frames, _, _ = conv_pool_script.make_inputs(32, 72, 96, 'cuda', seed=7)
  with torch.no_grad():
    x = scaled_nchw(frames, torch.bfloat16)
    ref = max_pool_same(conv(x)).permute(0, 2, 3, 1).float()
    got = conv_pool_cuda.fused_conv_pool(frames, conv.weight,
                                         conv.bias).float()
  err = float((got - ref).abs().max())
  tol = 2**-7 * (2 * float(ref.abs().max()) +
                 float(conv.bias.detach().abs().max()))
  if not err <= tol:
    raise AssertionError(f'K2 vs bf16 torso section 1: {err} > {tol}')
  log(f'conv_pool vs bf16 torso section 1 [32, 72, 96]: max_abs_err '
      f'{err:.3e} (tolerance {tol:.3e}), {int((got != ref).sum())} of '
      f'{got.numel()} elements differ')


def phase_conv_pool_entry():
  """K2's entry point at its card shape: the path that launches K2."""
  _, counts = _drive('conv_pool entry point',
                     lambda: conv_pool_script.main([]))
  if counts['conv_pool'] < 1 or counts['vtrace'] != 0:
    raise AssertionError(f'conv_pool entry point launches {counts}')
  return counts


def _check_precision_line(stderr, phase):
  """The CLI ran its float32 layers with TF32 off, and said so."""
  if driver.PRECISION_LINE not in stderr:
    raise AssertionError(f'{phase}: no {driver.PRECISION_LINE!r} line in the '
                         f'CLI\'s log:\n{stderr[-4000:]}')


def phase_cli(compute_dtype='float32'):
  config = Config(**SLICE)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as logdir:
    cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=anakin', f'--logdir={logdir}', '--summary_secs=0',
           f'--total_environment_frames={2 * config.frames_per_step}',
           f'--compute_dtype={compute_dtype}']
    for field, value in SLICE.items():
      cmd.append(f'--{field}={value}')
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'CLI failed ({proc.returncode}):\n{proc.stderr}')
    _check_precision_line(proc.stderr, f'cli {compute_dtype}')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if not losses or not all(math.isfinite(v) for v in losses):
    raise AssertionError(f'CLI total_loss: {losses}')
  log(f'cli {compute_dtype}: 2 steps in {time.perf_counter() - t0:.1f} s, '
      f'total_loss {losses}')


@dataclasses.dataclass(frozen=True)
class _TimedMesh(mesh_lib.Mesh):
  """A mesh whose all-reduce is timed on the host, from a synchronize
  before it (gloo copies a CUDA tensor to the host, which waits for the
  stream anyway) to one after; the wait for the other rank is in it."""
  seconds: list = dataclasses.field(default_factory=list)

  def all_reduce_sum_(self, tensor, axis=sharding.DATA_AXIS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = super().all_reduce_sum_(tensor, axis)
    torch.cuda.synchronize()
    self.seconds.append(time.perf_counter() - t0)
    return out


def _params_digest(params):
  digest = hashlib.sha256()
  for k, v in sorted(params.items()):
    digest.update(k.encode())
    digest.update(v.detach().cpu().numpy().tobytes())
  return digest.hexdigest()


def _seeded_agent(config, device):
  agent = driver.build_agent(config, SLICE['num_actions'])
  init_params(agent, torch.Generator().manual_seed(config.seed))
  return agent.to(device)


def _dp_rank(rank, world, port, outdir):
  """One rank of the slice_dp phase (a spawned process): 4 fused steps
  over a gloo group on the shared card, then the sharded train step on a
  fixed full-width batch (rank 0 also the 1-rank step). Writes its
  results to `outdir`/rank<r>.json."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  config = Config(**SLICE, coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cuda:0',
                                        timeout_secs=GROUP_TIMEOUT_SECS)
  group_mesh = mesh_lib.make_mesh(device)
  mesh = _TimedMesh(group_mesh.rank, group_mesh.size, group_mesh.device,
                    group_mesh.group)
  torch.cuda.reset_peak_memory_stats()
  for counter in COUNTERS.values():
    counter.launches = 0
  t0 = time.perf_counter()
  carry, history, fps = anakin.run(config, SLICE_STEPS, device='cuda',
                                   mesh=mesh)
  wall = time.perf_counter() - t0
  counts = {name: counter.launches for name, counter in COUNTERS.items()}
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  digests = [None] * world
  dist.all_gather_object(digests, _params_digest(carry.train_state.params))
  # Two all-reduces per fused step: the learner's, and mean_reward's.
  reduce_s = mesh.seconds
  result = dict(
      rank=rank, counts=counts, fps=fps, wall_s=wall, peak_gib=peak_gib,
      losses=[h['total_loss'] for h in history],
      mean_reward=[h['mean_reward'] for h in history],
      update_steps=carry.train_state.update_steps, digests=digests,
      all_reduce_ms=[1e3 * v for v in reduce_s])
  del carry

  batch = _small_batch(SLICE['unroll_length'], SLICE['batch_size'],
                       SLICE['num_actions'], SLICE['height'], SLICE['width'])
  agent = _seeded_agent(config, device)
  state = train_parallel.make_sharded_train_state(agent, config, group_mesh)
  step, place = train_parallel.make_sharded_train_step(agent, config,
                                                       group_mesh, batch)
  state, metrics = step(state, place(batch))
  result['step_loss'] = float(metrics['total_loss'])
  if rank == 0:
    params = _param_snapshot(state.params)
    agent1 = _seeded_agent(config, device)
    state1, metrics1 = learner.make_train_step_fn(agent1, config)(
        learner.make_train_state(agent1, config),
        map_structure(lambda v: v.to(device), batch))
    single_loss = float(metrics1['total_loss'])
    np.testing.assert_allclose(result['step_loss'], single_loss, rtol=2e-4)
    single = _param_snapshot(state1.params)
    err = 0.0
    for k in single:
      np.testing.assert_allclose(params[k].numpy(), single[k].numpy(),
                                 rtol=5e-4, atol=5e-6, err_msg=k)
      err = max(err, float((params[k] - single[k]).abs().max()))
    result.update(single_loss=single_loss, max_param_diff=err)
  with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
    json.dump(result, f)
  distributed.shutdown()


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def phase_slice_dp():
  """2 ranks sharing the card over gloo (see _dp_rank); returns the
  launch counts of the fused-step path, summed over the ranks."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_') as outdir:
    _free_the_card('slice_dp')
    context = mp.start_processes(
        _dp_rank, args=(DP_RANKS, _free_port(), outdir), nprocs=DP_RANKS,
        join=False, start_method='spawn')
    deadline = time.monotonic() + DP_TIMEOUT_SECS
    # join raises when a rank fails, after stopping the others.
    while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
      if time.monotonic() >= deadline:
        for process in context.processes:
          process.kill()
        raise RuntimeError(f'slice_dp ranks still running after '
                           f'{DP_TIMEOUT_SECS} s')
    ranks = []
    for rank in range(DP_RANKS):
      with open(os.path.join(outdir, f'rank{rank}.json')) as f:
        ranks.append(json.load(f))
  counts = {name: sum(r['counts'][name] for r in ranks) for name in COUNTERS}
  log(f'slice_dp: kernel launches {counts} (by rank: '
      f'{[r["counts"] for r in ranks]})')
  for r in ranks:
    if not all(math.isfinite(v) for v in r['losses']):
      raise AssertionError(f'rank {r["rank"]}: losses {r["losses"]}')
    if r['update_steps'] != SLICE_STEPS:
      raise AssertionError(f'rank {r["rank"]}: update_steps '
                           f'{r["update_steps"]}')
    if r['counts']['vtrace_sharded'] != SLICE_STEPS or r['counts']['vtrace']:
      raise AssertionError(f'rank {r["rank"]}: launches {r["counts"]} in '
                           f'{SLICE_STEPS} fused steps')
    if len(set(r['digests'])) != 1:
      raise AssertionError(f'ranks\' params differ: {r["digests"]}')
  config = Config(**SLICE)
  for r in ranks:
    # Timed steps 2..4; two all-reduces per step (learner, mean_reward).
    timed = r['all_reduce_ms'][2:]
    reduce_ms = sum(timed) / (SLICE_STEPS - 1)
    step_ms = config.frames_per_step / r['fps'] * 1e3
    log(f'slice_dp rank {r["rank"]}: {r["fps"]:.1f} global env-frames/s, '
        f'{step_ms:.2f} ms per fused step, all-reduce {reduce_ms:.2f} ms '
        f'per step ({reduce_ms / step_ms:.4f} of the step; per call '
        f'{[round(v, 3) for v in r["all_reduce_ms"]]} ms), peak '
        f'{r["peak_gib"]:.3f} GiB; losses {r["losses"]}; mean_reward '
        f'{r["mean_reward"]}; params sha256 {r["digests"][0][:16]}')
  log(f'slice_dp sharded train step at full width: loss 2 ranks '
      f'{ranks[0]["step_loss"]} / {ranks[1]["step_loss"]}, 1 rank '
      f'{ranks[0]["single_loss"]}; max |param diff| '
      f'{ranks[0]["max_param_diff"]:.3e}')
  return counts


def phase_cli_dp():
  """The CLI under torch.distributed.run: an NCCL group of one rank."""
  config = Config(**SLICE)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_dp_') as logdir:
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node=1', '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=anakin', f'--logdir={logdir}', '--summary_secs=0',
           f'--total_environment_frames={2 * config.frames_per_step}']
    for field, value in SLICE.items():
      cmd.append(f'--{field}={value}')
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'CLI under torch.distributed.run failed '
                         f'({proc.returncode}):\n{proc.stderr}')
    if 'process group (nccl): rank 0 of 1' not in proc.stderr:
      raise AssertionError(f'no NCCL group joined:\n{proc.stderr}')
    _check_precision_line(proc.stderr, 'cli_dp')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if not losses or not all(math.isfinite(v) for v in losses):
    raise AssertionError(f'CLI total_loss: {losses}')
  log(f'cli_dp: 2 steps in {time.perf_counter() - t0:.1f} s in an NCCL '
      f'group of one, total_loss {losses}')


def _device_busy_ms(prof):
  """Time the device was busy in a profile, ms: the union over every
  stream of the device-side events' intervals (kernels, copies, memsets).
  The CPU ops that launched them carry the same time again, and kernels
  of two streams that overlap count once."""
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if str(getattr(e, 'device_type', '')).endswith('CUDA'))
  busy_us, covered_to = 0.0, float('-inf')
  for start, end in spans:
    if end > covered_to:
      busy_us += end - max(start, covered_to)
      covered_to = end
  return busy_us / 1e3


def _start_own_profiler(profiler, name):
  """Start a phase's own profiler window, never over another session:
  torch.profiler's CUDA collection is process-wide, and a second start
  ends the first one's (the SLO engine's captures and the operator's
  window refuse to start under this one for the same reason)."""
  if driver.profiler_running():
    raise AssertionError(f'{name}: another profiler session was running '
                         'when the phase\'s own window started')
  profiler.start()


def _busy_ms_or_fail(name, profiler):
  """The phase's device-busy sum, which must not read empty."""
  busy_ms = _device_busy_ms(profiler)
  if not busy_ms > 0:
    raise AssertionError(f'{name}: the phase\'s own profiler window read no '
                         'device time (a collision with another session?)')
  return busy_ms


_VERDICT_KEYS = {'pass', 'violations', 'wall_time', 'objectives', 'captures',
                 'clean_exit', 'update_steps'}


def _slo_verdict(name, logdir, burned=()):
  """The run's SLO_VERDICT.json (the engine at its default, on): JAX's
  keys, every default objective judged, and `burned` among its
  violations. Returns it."""
  verdict = slo.read_verdict(logdir)
  if (verdict is None or not _VERDICT_KEYS <= set(verdict) or
      set(verdict['objectives']) != {o.name for o in slo.DEFAULT_OBJECTIVES}):
    raise AssertionError(f'{name}: SLO verdict {verdict}')
  missing = sorted(set(burned) - set(verdict['violations']))
  if missing:
    raise AssertionError(f'{name}: {missing} not burned; verdict '
                         f'violations {verdict["violations"]}')
  return verdict


def _slo_report(name, logdir, verdict):
  """The slo_report module over the run's logdir: its exit code must be
  the verdict's (0 pass, 1 fail) and its table must name every
  violation. Returns a line for the log."""
  t = time.perf_counter()
  report = _module_run('scalable_agent_tpu_torch.scripts.slo_report', logdir)
  want = 0 if verdict['pass'] else 1
  header = '== SLO verdict: %s ==' % ('PASS' if verdict['pass'] else 'FAIL')
  if (report.returncode != want or header not in report.stdout
      or not all(v in report.stdout for v in verdict['violations'])):
    raise AssertionError(f'{name}: slo_report exited {report.returncode} '
                         f'for a verdict pass={verdict["pass"]}:\n'
                         f'{report.stdout}{report.stderr}')
  return (f'slo_report exit {report.returncode} (agrees with '
          f'pass={verdict["pass"]}) in {time.perf_counter() - t:.2f} s')


def _verdict_line(verdict):
  return (f'SLO verdict pass={verdict["pass"]} violations '
          f'{verdict["violations"]} captures {sorted(verdict["captures"])}')


# The controller's observe-mode moves a phase may log, by the objective
# that drives them: the one rule of the default table over each burn (or
# thin margin) the phases raise (PERF.md section 6). The other burns
# (rollbacks_zero, sdc_mismatch_zero, wire_crc_rejected_zero) drive no
# rule. learner_plane_utilization (info, >= 0.05) burns wherever the
# learner idles 0.95 of a window, so every phase allows its virtual
# replay_k move; fleet_healthy_fraction's grow rule triggers at a margin
# of 0.25 (a healthy fraction of 0.5), which admission's shed run holds
# on purpose.
CONTROLLER_MOVES = {
    'learner_plane_utilization': 'replay_k',
    'unroll_e2e_p99_ms': 'admission',
    'fleet_healthy_fraction': 'fleet_size',
}
CONTROLLER_ANYWHERE = ('learner_plane_utilization',)


def _expected_move(action, allowed):
  """Whether one CONTROLLER_LOG.json row is a virtual move that a burn in
  `allowed` implies: unapplied, over the rule's actuator, one step."""
  objective = action['objective']
  if (action['applied'] or action['mode'] != 'observe' or
      objective not in allowed or
      action['actuator'] != CONTROLLER_MOVES.get(objective)):
    return False
  step = {'escalate': 1, 'revert': -1}.get(action['kind'])
  if action['actuator'] != 'admission':  # the numeric rules step up by 1
    return step is not None and action['to'] == action['from'] + step
  moves = {'escalate': ('block', 'shed'), 'revert': ('shed', 'block')}
  return (action['from'], action['to']) == moves.get(action['kind'])


def _controller_logs(name, logdir, allowed=CONTROLLER_ANYWHERE):
  """Every CONTROLLER_LOG*.json of a fleet run in `logdir` (the controller
  at its default, observe): nothing applied or failed, no row dropped,
  and every logged move one that a burn in `allowed` implies; likewise
  every controller_action incident in the logdir's incident streams (a
  SIGKILLed learner's moves live only there). An unexpected move fails
  the phase with its row. Returns a line for the phase's log."""
  files = sorted(os.listdir(logdir))
  paths = [f for f in files
           if f.startswith('CONTROLLER_LOG') and f.endswith('.json')]
  if not paths:
    raise AssertionError(f'{name}: no CONTROLLER_LOG.json in {logdir}')
  incidents = 0
  for path in (f for f in files
               if f.startswith('incidents') and f.endswith('.jsonl')):
    with open(os.path.join(logdir, path)) as f:
      for event in map(json.loads, f):
        if event['kind'] != 'controller_action':
          continue
        action = dict(event, kind=event['action'])
        if not _expected_move(action, allowed):
          raise AssertionError(f'{name}: unexpected controller_action '
                               f'incident in {path}: {json.dumps(event)}')
        incidents += 1
  moves = []
  for path in paths:
    with open(os.path.join(logdir, path)) as f:
      record = json.load(f)
    counts = record['counts']
    if (record['mode'] != 'observe' or counts['applied'] or
        counts['apply_errors'] or record['dropped_actions'] or
        counts['actions'] != len(record['actions'])):
      raise AssertionError(f'{name}: {path} mode {record["mode"]}, counts '
                           f'{counts}, dropped {record["dropped_actions"]}')
    for action in record['actions']:
      if not _expected_move(action, allowed):
        raise AssertionError(f'{name}: unexpected controller action in '
                             f'{path}: {json.dumps(action)}')
      moves.append(f'{action["objective"]} {action["actuator"]} '
                   f'{action["from"]}->{action["to"]}')
  return (f'controller observe, {len(paths)} log(s): {len(moves)} virtual '
          f'move(s) {moves}, {incidents} controller_action incident(s), '
          f'applied 0')


def _controller_tick_costs(engine, reps=200, acting_reps=20):
  """The controller's cost on this host. Idle: a tick of the default
  table in observe mode over the fleet's own SLO engine (its locked
  control_snapshot of every objective, the rules judged; a tick that
  moves a knob is counted apart; observe sets nothing). Acting: a tick
  that applies one move (the knob's set, the fsync'd controller_action
  incident, the CONTROLLER_LOG.json rewrite) over an always-burning
  stub. Returns
  (idle us p50, idle us max, ticks that moved, acting ms p50, acting ms
  max)."""
  actuators = [
      controller_lib.Actuator('replay_k', kind='int', get_fn=lambda: 1,
                              set_fn=None, minimum=1, maximum=4),
      controller_lib.Actuator('admission', kind='enum',
                              get_fn=lambda: 'block', set_fn=None,
                              values=('block', 'shed', 'grow')),
      controller_lib.Actuator('fleet_size', kind='int', get_fn=lambda: 32,
                              set_fn=None, minimum=1, maximum=32)]

  class Burning:
    def control_snapshot(self):
      return {'load': {'state': slo.BURNING, 'margin': -1.0, 'value': 2.0}}

  with tempfile.TemporaryDirectory(prefix='chip_smoke_ticks_') as logdir:
    idle = controller_lib.Controller(engine, controller_lib.DEFAULT_RULES,
                                     actuators, logdir, mode='observe',
                                     log_name='IDLE_LOG.json')
    idle_us, moved = [], 0
    for i in range(reps):
      t = time.perf_counter()
      taken = idle.tick(now=float(i))
      dt = 1e6 * (time.perf_counter() - t)
      if taken:
        moved += 1
      else:
        idle_us.append(dt)
    idle.stop()
    incidents = observability.EventLog(logdir)
    level = {'v': 1}
    acting = controller_lib.Controller(
        Burning(), [controller_lib.Rule(objective='load', actuator='replay_k',
                                        cooldown_secs=0.0)],
        [controller_lib.Actuator('replay_k', kind='int',
                                 get_fn=lambda: level['v'],
                                 set_fn=lambda v: level.update(v=v),
                                 minimum=1, maximum=10**9)],
        logdir, mode='act', incidents=incidents)
    acting_ms = []
    for i in range(acting_reps):
      t = time.perf_counter()
      taken = acting.tick(now=float(i))
      acting_ms.append(1e3 * (time.perf_counter() - t))
      if len(taken) != 1 or not taken[0]['applied']:
        raise AssertionError(f'acting tick {i}: {taken}')
    acting.stop()
    incidents.close()
  return (statistics.median(idle_us), max(idle_us), moved,
          statistics.median(acting_ms), max(acting_ms))


def phase_fleet():
  """The fleet runtime at full width through driver.train (see the
  module docstring); returns its kernel launch counts."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_fleet_') as logdir:
    return _fleet_run(Config(**FLEET, logdir=logdir))


def _fleet_run(config):
  agent = driver.build_agent(config, SLICE['num_actions'])
  init_params(agent, torch.Generator().manual_seed(config.seed))
  initial = _param_snapshot(dict(agent.named_parameters()))
  published = {}
  learner_after = {}
  window = []  # wall-clock start and end of the profiled steps
  profiler = torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA])
  observe_ms = []

  def on_step(run, step, metrics):
    if step == FLEET_TIMED_FROM:
      # The SLO engine's per-observe cost on the live registry: a
      # snapshot and the default objectives judged, SLO_OBSERVE_REPS times.
      evaluator = slo.SloEvaluator(slo.load_objectives())
      for _ in range(SLO_OBSERVE_REPS):
        t = time.perf_counter()
        evaluator.observe(telemetry.registry().snapshot())
        observe_ms.append(1e3 * (time.perf_counter() - t))
    if step % config.publish_params_every == 0:
      published[step] = _param_snapshot(run.state.params)
    elif step > FLEET_PROFILED_FROM:
      learner_after[step] = _param_snapshot(run.state.params)
    if step == FLEET_PROFILED_FROM:
      torch.cuda.synchronize()
      _start_own_profiler(profiler, 'fleet')
      window.append(time.perf_counter())
    elif step == FLEET_STEPS:
      torch.cuda.synchronize()
      window.append(time.perf_counter())
      profiler.stop()

  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  run, counts = _drive('fleet', lambda: driver.train(
      config, max_steps=FLEET_STEPS, device='cuda', stall_timeout_secs=300,
      on_step=on_step))
  wall = time.perf_counter() - t0
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  with open(os.path.join(config.logdir, 'summaries.jsonl')) as f:
    events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if len(losses) != FLEET_STEPS or not all(map(math.isfinite, losses)):
    raise AssertionError(f'fleet losses: {losses}')
  if run.state.update_steps != FLEET_STEPS:
    raise AssertionError(f'fleet update_steps {run.state.update_steps}')
  if counts['vtrace'] != FLEET_STEPS or counts['conv_pool'] or (
      counts['vtrace_sharded']):
    raise AssertionError(f'fleet launches {counts} in {FLEET_STEPS} learner '
                         'steps')
  final = _param_snapshot(run.state.params)
  moved = max(float((final[k] - initial[k]).abs().max()) for k in final)
  if not moved > 0:
    raise AssertionError('fleet params did not change')
  server_params = run.server.live_params()
  if not all(p.is_cuda for p in server_params.values()):
    raise AssertionError('the server\'s params are not on the card')
  served = _param_snapshot(server_params)
  last = max(published)
  if not all(torch.equal(served[k], published[last][k]) for k in served):
    raise AssertionError(f'the server\'s snapshot differs from the params '
                         f'published at step {last}')
  for step, after in sorted(learner_after.items()):
    if all(torch.equal(served[k], after[k]) for k in served):
      raise AssertionError(f'the server\'s snapshot follows the learner\'s '
                           f'params after step {step}')
  server = run.stats['server']
  if not server['mean_batch'] > 1:
    raise AssertionError(f'inference merged no calls: {server}')
  if (server['params_version'] < 1 + FLEET_STEPS // config.publish_params_every
      or server['live_version'] != last):
    raise AssertionError(f'published version did not advance to step '
                         f'{last}: {server}')
  log_ = run.step_log
  timed_s = log_[-1]['time'] - log_[FLEET_TIMED_FROM - 1]['time']
  waited_s = (log_[-1]['get_wait_secs'] -
              log_[FLEET_TIMED_FROM - 1]['get_wait_secs'])
  timed_steps = FLEET_STEPS - FLEET_TIMED_FROM
  fps = timed_steps * config.frames_per_step / timed_s
  profiled_steps = FLEET_STEPS - FLEET_PROFILED_FROM
  busy_ms = _busy_ms_or_fail('fleet', profiler)
  busy = (f'{busy_ms / profiled_steps:.2f} ms per learner step, idle share '
          f'{1 - busy_ms / (1e3 * (window[1] - window[0])):.4f}')
  verdict = _slo_verdict('fleet', config.logdir)
  report_line = _slo_report('fleet', config.logdir, verdict)
  controller_line = _controller_logs('fleet', config.logdir)
  idle_us, idle_max_us, moved, acting_ms, acting_max_ms = (
      _controller_tick_costs(run.controller._engine))
  log(f'fleet: {controller_line}; a controller tick on this host: idle '
      f'(the default table over the fleet\'s SLO engine) p50 {idle_us:.2f} '
      f'us max {idle_max_us:.2f} us over {200 - moved} ticks ({moved} that '
      f'moved apart), acting (one applied move, its fsync\'d incident and '
      f'the log rewrite) p50 {acting_ms:.3f} ms max {acting_max_ms:.3f} ms '
      f'over 20')
  log(f'fleet: {FLEET_STEPS} learner steps in {wall:.2f} s (set-up '
      f'included); losses {losses}; max |param change| {moved:.3e}; vtrace '
      f'launches {counts["vtrace"]}; server snapshot bit-equal to the '
      f'params published at step {last}, unequal to the learner\'s after '
      f'steps {sorted(learner_after)}')
  MEASURED['fleet_step_ms'] = 1e3 * timed_s / timed_steps
  log(f'fleet: {fps:.1f} env-frames/s, {1e3 * timed_s / timed_steps:.2f} ms '
      f'per learner step over steps {FLEET_TIMED_FROM + 1}-{FLEET_STEPS}; '
      f'learner blocked in prefetcher.get {waited_s / timed_s:.4f} of that '
      f'time; inference mean batch {server["mean_batch"]:.3f} over '
      f'{server["calls"]} calls; latency per merged call over the last 512 '
      f'calls p50 {server["latency_p50_ms"]} ms p99 '
      f'{server["latency_p99_ms"]} ms; {server["snapshots"]} snapshots; '
      f'buffer high water {run.stats["buffer"]["high_water"]} of '
      f'{run.stats["buffer"]["capacity"]}; peak allocated {peak_gib:.3f} '
      f'GiB; device busy {busy} (torch.profiler, union of the device '
      f'events of every stream over steps {FLEET_PROFILED_FROM + 1}-'
      f'{FLEET_STEPS}, inference kernels included, the SLO engine '
      f'running); fleet {run.stats["fleet"]}; prefetcher '
      f'{run.stats["prefetcher"]}; {_verdict_line(verdict)}; an SLO observe '
      f'(registry snapshot + the default objectives) p50 '
      f'{statistics.median(observe_ms):.3f} ms max {max(observe_ms):.3f} ms '
      f'over {SLO_OBSERVE_REPS} in step {FLEET_TIMED_FROM}; {report_line}')
  return counts


def _reference_callers(num, config, seed=0):
  rng = np.random.RandomState(seed)
  calls = []
  for _ in range(num):
    frame = rng.randint(0, 256, (config.height, config.width, 3)).astype(
        np.uint8)
    env_output = StepOutput(
        np.float32(rng.randn()), StepOutputInfo(np.float32(0), np.int32(0)),
        np.bool_(rng.rand() < 0.2), (frame, np.zeros(16, np.int32)))
    carry = tuple(rng.randn(1, 256).astype(np.float32) * 0.3
                  for _ in range(2))
    calls.append((np.int32(rng.randint(config.num_actions)), env_output,
                  carry))
  return calls


def _serve(server, calls, gap_secs=0.0):
  """Each call from a thread of its own; their answers in order. With
  `gap_secs`, the main thread sleeps that long after starting each thread,
  so the calls reach the batcher in list order (the row of a merged batch
  that a caller takes sets which noise its sampled action draws)."""
  outs = [None] * len(calls)

  def call(i):
    outs[i] = server.policy(*calls[i])

  threads = [threading.Thread(target=call, args=(i,))
             for i in range(len(calls))]
  for t in threads:
    t.start()
    time.sleep(gap_secs)
  for t in threads:
    t.join()
  return outs


def phase_fleet_reference():
  """The server on the card against the same server on the CPU: the same
  seeded params and 32 concurrent callers' inputs; logits, baseline and
  new carry within rtol 1e-4 / atol 1e-5."""
  config = Config(**dict(FLEET, inference_timeout_ms=1000))
  agent = driver.build_agent(config, SLICE['num_actions'])
  params = init_params(agent, torch.Generator().manual_seed(config.seed))
  calls = _reference_callers(config.num_actors, config)
  results = {}
  for device in ('cpu', 'cuda'):
    server = InferenceServer(agent, {k: v.to(device) for k, v in
                                     params.items()}, config, seed=1,
                             fleet_size=config.num_actors)
    try:
      results[device] = _serve(server, calls)
      stats = server.stats()
    finally:
      server.close()
    log(f'fleet_reference {device}: {stats["calls"]} merged calls, mean '
        f'batch {stats["mean_batch"]:.2f}')
  err = 0.0
  for (cpu_out, cpu_carry), (gpu_out, gpu_carry) in zip(results['cpu'],
                                                        results['cuda']):
    for got, ref in ((gpu_out.policy_logits, cpu_out.policy_logits),
                     (gpu_out.baseline, cpu_out.baseline),
                     (gpu_carry[0], cpu_carry[0]), (gpu_carry[1], cpu_carry[1])):
      np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
      err = max(err, float(np.max(np.abs(np.asarray(got) - ref))))
  log(f'fleet_reference: {len(calls)} callers, card vs CPU max |diff| '
      f'{err:.3e} over logits, baseline and carry')
  _publish_race(agent, params, config, calls[:PUBLISH_RACE_CALLERS])


def _matches(outs, refs):
  return all(np.allclose(got, ref, rtol=1e-4, atol=1e-5)
             for (out, carry), (ref, ref_carry) in zip(outs, refs)
             for got, ref in ((out.policy_logits, ref.policy_logits),
                              (out.baseline, ref.baseline),
                              (carry[0], ref_carry[0]),
                              (carry[1], ref_carry[1])))


def _publish_race(agent, params, config, calls):
  """Publishes racing inference on the card: callers loop on fixed inputs
  while the main thread alternates the learner's tensors between two
  versions, publishes, and at once overwrites them in place (the
  learner's next update). Every answer must be one version's answer
  (within the fleet_reference bar), never a half-written or overwritten
  snapshot's; both versions must be seen."""
  versions = [{k: v.detach().to('cuda', copy=True) for k, v in params.items()}]
  versions.append({k: v * 0.5 + 0.01 for k, v in versions[0].items()})
  refs = []
  for version in versions:
    server = InferenceServer(agent, version, config, seed=1,
                             fleet_size=len(calls))
    try:
      refs.append(_serve(server, calls))
    finally:
      server.close()
  learner_params = {k: v.clone() for k, v in versions[0].items()}
  server = InferenceServer(agent, learner_params, config, seed=1,
                           fleet_size=len(calls))
  answers = []
  done = threading.Event()

  def caller(i):
    for _ in range(PUBLISH_RACE_ROUNDS):
      answers.append((i, server.policy(*calls[i])))
    done.set()

  threads = [threading.Thread(target=caller, args=(i,))
             for i in range(len(calls))]
  publishes = 0
  try:
    for t in threads:
      t.start()
    with torch.no_grad():
      while not done.is_set() and any(t.is_alive() for t in threads):
        for k, p in learner_params.items():
          p.copy_(versions[publishes % 2][k])
        server.update_params(learner_params, version=publishes)
        for p in learner_params.values():
          p.add_(1000.0)  # the learner's next in-place update
        publishes += 1
    for t in threads:
      t.join()
    stats = server.stats()
  finally:
    server.close()
  if len(answers) != len(calls) * PUBLISH_RACE_ROUNDS:
    raise AssertionError(f'publish race: {len(answers)} answers of '
                         f'{len(calls) * PUBLISH_RACE_ROUNDS}')
  seen = [0, 0]
  for i, answer in answers:
    which = [_matches([answer], [ref[i]]) for ref in refs]
    if not any(which):
      raise AssertionError(f'publish race: caller {i} got an answer of '
                           'neither published version')
    seen[which.index(True)] += 1
  if not all(seen):
    raise AssertionError(f'publish race: answers by version {seen}')
  log(f'fleet_reference publish race: {publishes} publishes racing '
      f'{len(answers)} answers from {len(calls)} callers; answers by '
      f'version {seen}, each one version\'s; {stats["snapshots"]} '
      'snapshots')


def _dir_bytes(path):
  return sum(os.path.getsize(os.path.join(root, name))
             for root, _, files in os.walk(path) for name in files)


def phase_resume_anakin():
  """anakin.train for 2 fused steps into a logdir, then again: the second
  call restores step 2 onto the card (params and nu bit-equal to the
  payload on disk), trains steps 3 and 4 with 2 K1 launches, and leaves
  LAST_GOOD at step 4 with verified digests. Then the save (payload copy,
  write, fsync, digests) and the restore of the full-width state, timed
  (median of 5). Returns the second call's launch counts."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_resume_') as logdir:
    config = Config(**SLICE, logdir=logdir, checkpoint_secs=0, summary_secs=0)
    first = anakin.train(config, max_steps=2, device='cuda')
    if first.train_state.update_steps != 2:
      raise AssertionError(f'first call: {first.train_state.update_steps}')
    del first
    restores = []
    restore_latest = checkpoint_lib.Checkpointer.restore_latest

    def recording(self, target):
      restored = restore_latest(self, target)
      restores.append((restored, self.last_restore_secs,
                       None if restored is None else _param_snapshot(
                           restored.params),
                       None if restored is None else _param_snapshot(
                           restored.opt_state.nu)))
      return restored

    checkpoint_lib.Checkpointer.restore_latest = recording
    try:
      carry, counts = _drive('resume_anakin', lambda: anakin.train(
          config, max_steps=2, device='cuda'))
    finally:
      checkpoint_lib.Checkpointer.restore_latest = restore_latest
    ckpt_dir = os.path.join(logdir, 'checkpoints')
    payload = torch.load(os.path.join(ckpt_dir, '2', 'default', 'state.pt'),
                         weights_only=True)
    restored, restore_secs, params, nu = restores[0]
    if restored is None or restored.update_steps != 2:
      raise AssertionError(f'the second call restored {restored}')
    if not all(p.is_cuda for p in restored.params.values()):
      raise AssertionError('the restored params are not on the card')
    if not (all(torch.equal(params[k], payload['params'][k]) for k in params)
            and all(torch.equal(nu[k], payload['opt_state']['nu'][k])
                    for k in nu)):
      raise AssertionError('the restored params or nu differ from step 2 on '
                           'disk')
    if carry.train_state.update_steps != 4 or counts['vtrace'] != 2:
      raise AssertionError(f'second call: update_steps '
                           f'{carry.train_state.update_steps}, launches '
                           f'{counts}')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      steps = [e['step'] for e in map(json.loads, f)
               if e['tag'] == 'total_loss']
    if steps != [1, 2, 3, 4]:
      raise AssertionError(f'summary steps {steps}')
    ckpt = checkpoint_lib.Checkpointer(ckpt_dir)
    if ckpt.last_good_step() != 4 or ckpt.verify_step_digests(4) is not True:
      raise AssertionError(f'LAST_GOOD {ckpt.last_good_step()}')
    step_bytes = _dir_bytes(os.path.join(ckpt_dir, '4'))

    state = carry.train_state
    timing = checkpoint_lib.Checkpointer(os.path.join(logdir, 'timing'),
                                         max_to_keep=2)
    save_ms, load_ms = [], []
    for i in range(5):
      timing.save(state._replace(update_steps=10 + i))
      save_ms.append(1e3 * timing.last_save_secs)
      timing.restore_latest(state)
      load_ms.append(1e3 * timing.last_restore_secs)
    torch.cuda.synchronize()
  log(f'resume_anakin: restored step 2 onto the card in '
      f'{1e3 * restore_secs:.1f} ms (params and nu bit-equal to the payload); '
      f'steps 3-4 with {counts["vtrace"]} V-trace launches; LAST_GOOD 4 '
      f'verified; step directory {step_bytes} bytes; digests '
      f'{integrity.CRC_ALGO}; full-width save '
      f'{statistics.median(save_ms):.1f} ms, restore '
      f'{statistics.median(load_ms):.1f} ms (median of 5; save '
      f'{[round(v, 1) for v in save_ms]}, restore '
      f'{[round(v, 1) for v in load_ms]})')
  return counts


ROLLBACK_STEPS = 7


# rollback_fleet's controller acts: its rollback burns rollbacks_zero,
# which this policy maps to admission block->shed, reverted once the
# burn leaves the fast window (4 s here, so the revert lands inside the
# run).
ROLLBACK_POLICY = [dict(objective='rollbacks_zero', actuator='admission',
                        to='shed', revert_to='block', cooldown_secs=0.0,
                        clear_margin=0.0)]
ROLLBACK_SLO_WINDOWS = dict(slo_fast_window_secs=4.0,
                            slo_slow_window_secs=20.0)
CONTROLLER_WAIT_SECS = 20.0


def _await(condition, secs):
  """Poll `condition` every 50 ms for up to `secs`; its last value."""
  deadline = time.monotonic() + secs
  while not condition() and time.monotonic() < deadline:
    time.sleep(0.05)
  return condition()


def _acting_controller(logdir, run, seen):
  """rollback_fleet's act-mode checks: the server's admission really
  moved to shed and back to block (read in the step of the rollback, while
  the loop waits for the controller's thread), and the log rows, the
  controller_action incidents and the health ledger's entries are the
  two applied moves. Returns a line for the phase's log."""
  want = [('escalate', 'block', 'shed'), ('revert', 'shed', 'block')]
  with open(os.path.join(logdir, 'CONTROLLER_LOG.json')) as f:
    record = json.load(f)
  with open(os.path.join(logdir, 'incidents.jsonl')) as f:
    events = [e for e in map(json.loads, f)
              if e['kind'] == 'controller_action']
  rows = [(a['kind'], a['from'], a['to']) for a in record['actions']
          if a['applied'] and a['objective'] == 'rollbacks_zero'
          and a['actuator'] == 'admission']
  incident_rows = [(e['action'], e['from'], e['to']) for e in events
                   if e['applied'] and e['mode'] == 'act']
  ledger = run.health.external_incidents.get('controller_admission')
  counts = run.controller.counts()
  if (seen.get('admission') != ['shed', 'block'] or record['mode'] != 'act'
      or rows != want or len(record['actions']) != 2
      or incident_rows != want or len(events) != 2 or ledger != 2
      or counts['applied'] != 2 or counts['apply_errors']):
    raise AssertionError(
        f'rollback_fleet: acting controller: admission after the rollback '
        f'{seen.get("admission")}, log {json.dumps(record["actions"])}, '
        f'incidents {events}, ledger {ledger}, counts {counts}')
  return (f'the acting controller moved admission block->shed '
          f'{seen["shed_secs"]:.2f} s after the rollback step\'s burn and '
          f'back {seen["block_secs"]:.2f} s after it (log rows, '
          f'controller_action incidents and the health ledger\'s '
          f'controller_admission {ledger} agree)')


def phase_rollback_fleet():
  """The fleet at full width with a NaN burst on learner steps 4-6 and
  health_rollback_after=2: one rollback, at step 6, to LAST_GOOD (step 4)
  — the params right after it bit-equal to that payload, the server's
  live version the rollback step — a monotone update counter, finite
  params at the end, K1 once per learner step; the SLO verdict lists
  rollbacks_zero as burned; the controller acts (ROLLBACK_POLICY): the
  burn flips the server's admission to shed and its end back to block
  (`_acting_controller`); the operator's profile_dir window over learner
  step 2 writes a Chrome trace holding the V-trace kernel."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_rollback_') as logdir:
    profile_dir = os.path.join(logdir, 'profile')
    policy = os.path.join(logdir, 'policy.json')
    with open(policy, 'w') as f:
      json.dump(ROLLBACK_POLICY, f)
    config = Config(**FLEET, **ROLLBACK_SLO_WINDOWS, logdir=logdir,
                    checkpoint_secs=0, health_rollback_after=2,
                    profile_dir=profile_dir, profile_start_step=1,
                    profile_num_steps=1, controller='act',
                    controller_policy=policy)
    seen = {'steps': []}

    def on_step(run, step, metrics):
      seen['steps'].append(run.state.update_steps)
      if run.health.rollbacks and 'step' not in seen:
        seen['step'] = step
        seen['params'] = _param_snapshot(run.state.params)
        seen['version'] = run.server.stats()['live_version']
        seen['last_good'] = run.checkpointer.last_good_step()
        # The summary block's observe judged the burn; the controller's
        # thread applies the move, then reverts it once the burn has left
        # the fast window.
        t0 = time.monotonic()
        seen['admission'] = []
        for applied, key in ((1, 'shed_secs'), (2, 'block_secs')):
          _await(lambda: run.controller.counts()['applied'] >= applied,
                 CONTROLLER_WAIT_SECS)
          seen['admission'].append(run.server.admission)
          seen[key] = time.monotonic() - t0

    faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=3,
                                          nan_burst_len=3))
    try:
      run, counts = _drive('rollback_fleet', lambda: driver.train(
          config, max_steps=ROLLBACK_STEPS, device='cuda',
          stall_timeout_secs=300, on_step=on_step))
    finally:
      faults.clear()
    payload = torch.load(os.path.join(logdir, 'checkpoints',
                                      str(seen['last_good']), 'default',
                                      'state.pt'), weights_only=True)
    with open(os.path.join(logdir, 'incidents.jsonl')) as f:
      kinds = [e['kind'] for e in map(json.loads, f)]
    verdict = _slo_verdict('rollback_fleet', logdir, burned=['rollbacks_zero'])
    controller_line = _acting_controller(logdir, run, seen)
    trace_path = os.path.join(profile_dir, 'trace.json')
    trace_mb = os.path.getsize(trace_path) / 1e6
    with open(trace_path) as f:
      events = json.load(f)['traceEvents']
    vtrace_events = [e for e in events if e.get('cat') == 'kernel'
                     and 'vtrace_kernel' in e.get('name', '')]
    if len(vtrace_events) != 1:
      raise AssertionError(f'rollback_fleet: the profile_dir trace holds '
                           f'{len(vtrace_events)} V-trace kernel events')
  stats = run.health.stats()
  if stats['rollbacks'] != 1 or kinds.count('rollback') != 1:
    raise AssertionError(f'rollbacks {stats}, incidents {kinds}')
  if not all(torch.equal(v, payload['params'][k])
             for k, v in seen['params'].items()):
    raise AssertionError(f'the params after the rollback differ from '
                         f'LAST_GOOD (step {seen["last_good"]})')
  if seen['steps'] != list(range(1, ROLLBACK_STEPS + 1)):
    raise AssertionError(f'update_steps not monotone: {seen["steps"]}')
  if seen['version'] != seen['step']:
    raise AssertionError(f'live version {seen["version"]} after the rollback '
                         f'at step {seen["step"]}')
  if not all(torch.isfinite(p).all() for p in run.state.params.values()):
    raise AssertionError('non-finite params at the end')
  if counts['vtrace'] != ROLLBACK_STEPS:
    raise AssertionError(f'rollback_fleet launches {counts}')
  log(f'rollback_fleet: rolled back at step {seen["step"]} to checkpoint step '
      f'{seen["last_good"]} (params bit-equal to its payload, live version '
      f'{seen["version"]}); health {stats}; update_steps {seen["steps"]}; '
      f'vtrace launches {counts["vtrace"]}; incidents {kinds}; '
      f'{_verdict_line(verdict)}; {controller_line}; profile_dir trace of '
      f'learner step 2: {trace_mb:.1f} MB, {len(events)} events, V-trace '
      f'kernel {vtrace_events[0]["dur"]} us')
  return counts


DRAIN_STEPS = 4


def _cli_fleet_run(cmd, logdir, name, sigterm_at_step=None):
  """The fleet CLI in a subprocess, its log in a file; with
  `sigterm_at_step`, one SIGTERM once its summaries show that step.
  Returns (stderr text, seconds from the SIGTERM to its exit)."""
  errpath = os.path.join(logdir, f'{name}.stderr')
  with open(errpath, 'w') as err:
    proc = subprocess.Popen(cmd, stdout=err, stderr=err, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    sent = None
    try:
      deadline = time.monotonic() + 600
      while sigterm_at_step is not None and sent is None:
        if proc.poll() is not None or time.monotonic() > deadline:
          raise RuntimeError(f'{name}: the CLI ended before step '
                             f'{sigterm_at_step}')
        if any(s >= sigterm_at_step for s in _fps_steps(logdir)):
          proc.send_signal(signal.SIGTERM)
          sent = time.monotonic()
        time.sleep(0.1)
      proc.wait(timeout=600 if sent is None
                else Config().preempt_drain_timeout_secs + 60)
    finally:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  with open(errpath) as f:
    stderr = f.read()
  if proc.returncode != 0:
    raise RuntimeError(f'{name} failed ({proc.returncode}):\n{stderr[-8000:]}')
  _check_precision_line(stderr, name)
  return stderr, None if sent is None else time.monotonic() - sent


def _fps_steps(logdir):
  path = os.path.join(logdir, 'summaries.jsonl')
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [e['step'] for e in map(json.loads, f)
            if e.get('tag') == 'env_frames_per_sec']


def phase_drain_fleet():
  """The fleet CLI (--mode=train --runtime=fleet) with a budget of 4
  learner steps: SIGTERM once step 2 is summarised; the process exits 0,
  with a verified checkpoint at the manifest's step; the same command
  again resumes there, consumes the manifest and ends at step 4; the two
  runs' summary steps are 1..4, each with a finite total_loss and
  env_frames_per_sec (the fleet CLI's check). The manifest's `metrics` is the
  registry's snapshot with the buffer/*, staging/*, checkpoint/* and
  driver/* names; `slo` is the SLO engine's verdict so far and
  `controller` the observing controller's counts, nothing applied; each
  run writes its SLO_VERDICT.json and its CONTROLLER_LOG.json."""
  config = Config(**FLEET)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_drain_') as logdir:
    cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=train', '--runtime=fleet', f'--logdir={logdir}',
           f'--total_environment_frames={DRAIN_STEPS * config.frames_per_step}']
    cmd += [f'--{field}={value}' for field, value in FLEET.items()]
    t0 = time.perf_counter()
    _, exit_secs = _cli_fleet_run(cmd, logdir, 'drained', sigterm_at_step=2)
    manifest = driver.read_resume_manifest(logdir)
    if not (manifest and manifest['checkpoint_verified'] and
            manifest['checkpoint_step'] == manifest['update_steps'] and
            manifest['drain_source'] == 'signal'):
      raise AssertionError(f'drain manifest {manifest}')
    # The manifest's metrics are the registry's snapshot, its slo the
    # verdict so far, its controller the observing controller's counts.
    metrics = manifest['metrics']
    planes = sorted({k.split('/')[0] for k in metrics or {}})
    drained_verdict = _slo_verdict('drain_fleet', logdir)
    drained_controller = _controller_logs('drain_fleet', logdir)
    controller = manifest['controller'] or {}
    if (not isinstance(metrics, dict) or
        not {'buffer', 'staging', 'checkpoint', 'driver'} <= set(planes) or
        metrics.get('driver/update_steps') != manifest['update_steps'] or
        not isinstance(manifest['slo'], dict) or
        set(manifest['slo']) != _VERDICT_KEYS - {'clean_exit', 'update_steps'}
        or controller.get('mode') != 'observe' or controller.get('applied')
        or set(controller) != {'actions', 'escalations', 'reverts',
                               'applied', 'apply_errors', 'mode'}):
      raise AssertionError(f'drain manifest metrics {metrics}, slo '
                           f'{manifest["slo"]}, controller '
                           f'{manifest["controller"]}')
    drained_at = manifest['update_steps']
    t1 = time.perf_counter()
    stderr, _ = _cli_fleet_run(cmd, logdir, 'resumed')
    if f'restored checkpoint at step {drained_at}' not in stderr:
      raise AssertionError(f'the rerun did not restore step {drained_at}:\n'
                           f'{stderr[-4000:]}')
    if not os.path.exists(os.path.join(logdir,
                                       'resume_manifest.json.consumed')):
      raise AssertionError('the manifest was not consumed')
    steps = _fps_steps(logdir)
    losses = _summary_values(logdir, 'total_loss')
    if (steps != list(range(1, DRAIN_STEPS + 1))
        or [s for s, _ in losses] != steps
        or not all(math.isfinite(v) for _, v in losses)):
      raise AssertionError(f'summary steps {steps}, total_loss {losses}')
    last_good = checkpoint_lib.Checkpointer(
        os.path.join(logdir, 'checkpoints')).last_good_step()
    if last_good != DRAIN_STEPS:
      raise AssertionError(f'LAST_GOOD {last_good}')
    resumed_verdict = _slo_verdict('drain_fleet', logdir)
    resumed_controller = _controller_logs('drain_fleet', logdir)
    if (resumed_verdict['update_steps'] != DRAIN_STEPS
        or not resumed_verdict['clean_exit']):
      raise AssertionError(f'drain_fleet: the resumed run\'s verdict '
                           f'{resumed_verdict}')
  log(f'drain_fleet: SIGTERM at step >= 2, drained at step {drained_at} in '
      f'{manifest["drain_latency_secs"]} s (drain latency, the manifest), '
      f'exit {exit_secs:.1f} s after the signal; {manifest["buffer"]} left; '
      f'the manifest\'s metrics: {len(metrics)} registry names of the planes '
      f'{planes}; '
      f'run 1 {t1 - t0:.1f} s, the resumed run {time.perf_counter() - t1:.1f}'
      f' s; summary steps {steps}; the drained run\'s '
      f'{_verdict_line(drained_verdict)}, {drained_controller}, the resumed '
      f'run\'s {_verdict_line(resumed_verdict)}, {resumed_controller}')

# --- multi-process training: the data-parallel fleet, unroll staging and
# tensor parallelism ------------------------------------------------------

# The data-parallel fleet: 2 gloo ranks sharing the card, each with 16
# process-hosted actors, global B=32 (16 rows per rank).
DP_FLEET = dict(FLEET, num_actors=16)
DP_FLEET_STEPS = 5
SDC_DRILL_STEPS = 5
# The tensor-parallel phase: the sharded step at a cut T*B (see phase_tp),
# and a short TP fleet with 16 actors per rank.
TP_STEPS = 3
UNROLL_FLEET_STEPS = 5
TP_SHARDED_CUT = dict(unroll_length=20, batch_size=8)
TP_FLEET = dict(FLEET, num_actors=16, publish_params_every=1,
                model_parallelism=2, tp_compute='gathered')
TP_FLEET_STEPS = 3
# Wall clock per measured run: set-up and the first steps are excluded.
MEASURED = {}


def _free_the_card(name):
  """Before ranks that share the card start: the blocks the parent's
  allocator keeps from earlier phases go back to the card. Kept, they
  starve the ranks' cuDNN workspaces, a starved convolution falls back
  to algorithms that round otherwise, and the tp phase's comparison
  with the one-rank step then read up to 3x its gate (PERF.md). Logs
  the card's memory as the ranks start."""
  gc.collect()
  reserved = torch.cuda.memory_reserved()
  torch.cuda.empty_cache()
  released = reserved - torch.cuda.memory_reserved()
  free, total = torch.cuda.mem_get_info()
  log(f'{name}: the parent released {released / 2**30:.2f} GiB of cache '
      f'and holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB; the '
      f'phase starts with {free / 2**30:.2f} of {total / 2**30:.2f} GiB '
      'free')


def _run_ranks(name, worker, outdir, *args):
  """`worker(rank, world, port, outdir, *args)` in DP_RANKS spawned
  processes sharing the card, the parent's cache released first;
  returns each rank's result (its `outdir`/rank<r>.pt). A rank that
  raises stops the others and fails the phase."""
  _free_the_card(name)
  context = mp.start_processes(
      worker, args=(DP_RANKS, _free_port(), outdir) + args,
      nprocs=DP_RANKS, join=False, start_method='spawn')
  deadline = time.monotonic() + DP_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      raise RuntimeError(f'{name} ranks still running after '
                         f'{DP_TIMEOUT_SECS} s')
  return [torch.load(os.path.join(outdir, f'rank{r}.pt'),
                     weights_only=False) for r in range(DP_RANKS)]


def _in_rank(rank, world, port, outdir, body):
  """A spawned rank's frame: its own forkserver (before any CUDA call),
  TF32 off, the gloo group on cuda:0, `body(config_fields, device)`'s
  result saved for the parent; the group left and the forkserver stopped
  on the way out."""
  py_process.warm_forkserver(preload=['chip_smoke'])
  try:
    driver.set_float32_precision()
    group = dict(coordinator_address=f'localhost:{port}',
                 num_processes=world, process_id=rank)
    device = distributed.maybe_initialize(Config(**SLICE, **group),
                                          backend='gloo', device='cuda:0',
                                          timeout_secs=GROUP_TIMEOUT_SECS)
    try:
      result = body(group, device)
    except BaseException:
      distributed.shutdown(wait=False)
      raise
    torch.save(result, os.path.join(outdir, f'rank{rank}.pt'))
    distributed.shutdown()
  finally:
    py_process.stop_forkserver()


def _counts():
  return {name: counter.launches for name, counter in COUNTERS.items()}


def _zero_counts():
  for counter in COUNTERS.values():
    counter.launches = 0


def _incident_kinds(logdir, rank):
  name = 'incidents.jsonl' if rank == 0 else f'incidents_p{rank}.jsonl'
  with open(os.path.join(logdir, name)) as f:
    return [e['kind'] for e in map(json.loads, f)]


def _step_times(run, first):
  """(seconds, blocked-get seconds) of the learner steps after `first`."""
  log_ = run.step_log
  return (log_[-1]['time'] - log_[first - 1]['time'],
          log_[-1]['get_wait_secs'] - log_[first - 1]['get_wait_secs'])


def _dp_fleet_rank(rank, world, port, outdir):
  def body(group, device):
    reduce_s = []
    plain = learner._all_reduce_sum

    def timed_all_reduce(*args, **kwargs):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = plain(*args, **kwargs)
      torch.cuda.synchronize()
      reduce_s.append(time.perf_counter() - t0)
      return out

    learner._all_reduce_sum = timed_all_reduce
    digests = []

    def on_step(run, step, metrics):
      digests.append(_params_digest(run.state.params))

    logdir = os.path.join(outdir, 'plain')
    config = Config(**DP_FLEET, **group, logdir=logdir)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    run = driver.train(config, max_steps=DP_FLEET_STEPS, device=device,
                       stall_timeout_secs=300, on_step=on_step)
    counts = _counts()
    all_digests = [None] * world
    dist.all_gather_object(all_digests, digests)
    timed_s, waited_s = _step_times(run, FLEET_TIMED_FROM)
    timed_steps = DP_FLEET_STEPS - FLEET_TIMED_FROM
    result = dict(
        counts=counts, update_steps=run.state.update_steps,
        digests=all_digests, sdc_armed=run.mesh is not None and
        train_parallel.supports_sdc_check(config, run.mesh),
        sdc_mismatches=run.health.sdc_mismatches,
        fps=timed_steps * config.frames_per_step / timed_s,
        step_ms=1e3 * timed_s / timed_steps, blocked=waited_s / timed_s,
        all_reduce_ms=[1e3 * v for v in reduce_s[FLEET_TIMED_FROM:]],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        fleet=run.stats['fleet'], server=run.stats['server'],
        params=_param_snapshot(run.state.params),
        checkpoints=os.path.join(logdir, 'checkpoints'))
    learner._all_reduce_sum = plain
    # The SDC drill: one replica's probe lane perturbed at the third
    # check; one bad check rolls back.
    logdir = os.path.join(outdir, 'sdc')
    faults.install(faults.FaultPlan.storm(seed=0, replica_divergence_at=2,
                                          replica_divergence_len=1))
    try:
      run = driver.train(
          Config(**DP_FLEET, **group, logdir=logdir, checkpoint_secs=0,
                 checkpoint_check_every_steps=1, health_rollback_after=1),
          max_steps=SDC_DRILL_STEPS, device=device, stall_timeout_secs=300)
    finally:
      faults.clear()
    result['drill'] = dict(kinds=_incident_kinds(logdir, rank),
                           health=run.health.stats(),
                           digest=_params_digest(run.state.params))
    return result

  _in_rank(rank, world, port, outdir, body)


def phase_dp_fleet():
  """The data-parallel fleet: 2 gloo ranks sharing the card, each with 16
  process-hosted actors feeding its 16 rows of the global batch of 32, at
  the slice's widths, for DP_FLEET_STEPS learner steps, then the SDC
  drill; the tail
  save of the first run restored on one rank. Returns the launch counts
  of the first run, summed over the ranks."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_fleet_') as outdir:
    ranks = _run_ranks('dp_fleet', _dp_fleet_rank, outdir)
    # Both ranks' logs of both runs (the drill's rollbacks_zero and
    # sdc_mismatch_zero drive no rule).
    controller_lines = [_controller_logs(f'dp_fleet {run}',
                                         os.path.join(outdir, run))
                        for run in ('plain', 'sdc')]
    # The save at D=2 (the tail save, rank 0's write) on one rank.
    config = Config(**DP_FLEET)
    target = learner.make_train_state(_seeded_agent(config, 'cuda'), config)
    checkpointer = checkpoint_lib.Checkpointer(ranks[0]['checkpoints'])
    restored = checkpointer.restore_latest(target)
    restore_ms = 1e3 * checkpointer.last_restore_secs
  if restored.update_steps != DP_FLEET_STEPS or not all(
      torch.equal(v.cpu(), ranks[0]['params'][k])
      for k, v in restored.params.items()):
    raise AssertionError('dp_fleet: the save at D=2 restored on one rank '
                         'differs from the ranks\' params')
  counts = {name: sum(r['counts'][name] for r in ranks) for name in COUNTERS}
  for rank, r in enumerate(ranks):
    if (r['counts']['vtrace_sharded'] != DP_FLEET_STEPS or
        r['counts']['vtrace'] or r['counts']['conv_pool']):
      raise AssertionError(f'dp_fleet rank {rank}: launches {r["counts"]} '
                           f'in {DP_FLEET_STEPS} learner steps')
    if r['update_steps'] != DP_FLEET_STEPS:
      raise AssertionError(f'dp_fleet rank {rank}: {r["update_steps"]} steps')
    if r['digests'][0] != r['digests'][1] or len(r['digests'][0]) != (
        DP_FLEET_STEPS):
      raise AssertionError('dp_fleet: the ranks\' params differ after a '
                           f'step: {r["digests"]}')
    if not r['sdc_armed'] or r['sdc_mismatches']:
      raise AssertionError(f'dp_fleet rank {rank}: SDC armed '
                           f'{r["sdc_armed"]}, mismatches '
                           f'{r["sdc_mismatches"]}')
    kinds = r['drill']['kinds']
    if (kinds.count('sdc_replica_mismatch') != 1 or
        kinds.count('rollback') != 1 or
        r['drill']['health']['rollbacks'] != 1):
      raise AssertionError(f'dp_fleet rank {rank} SDC drill: incidents '
                           f'{kinds}, health {r["drill"]["health"]}')
  if ranks[0]['drill']['digest'] != ranks[1]['drill']['digest']:
    raise AssertionError('dp_fleet: the ranks\' params differ after the '
                         'SDC drill\'s rollback')
  log(f'dp_fleet: kernel launches {counts} (by rank: '
      f'{[r["counts"] for r in ranks]}); params bit-equal across the ranks '
      f'after each of the {DP_FLEET_STEPS} steps; SDC armed, 0 mismatches; '
      f'drill incidents {ranks[0]["drill"]["kinds"]}; the tail save at D=2 '
      f'restored on one rank bit-equal in {restore_ms:.1f} ms; the first '
      f'run\'s {controller_lines[0]}; the drill\'s {controller_lines[1]}')
  for rank, r in enumerate(ranks):
    reduce = r['all_reduce_ms']
    log(f'dp_fleet rank {rank}: {r["fps"]:.1f} global env-frames/s, '
        f'{r["step_ms"]:.2f} ms per learner step over steps '
        f'{FLEET_TIMED_FROM + 1}-{DP_FLEET_STEPS}; blocked in prefetcher.get '
        f'{r["blocked"]:.4f} of that time; gradient all-reduce (gloo, card '
        f'to host and back) {statistics.median(reduce):.2f} ms median per '
        f'step ({[round(v, 2) for v in reduce]}); inference mean batch '
        f'{r["server"]["mean_batch"]:.3f}; peak allocated '
        f'{r["peak_gib"]:.3f} GiB; fleet {r["fleet"]}')
  return counts


def phase_cli_fleet_dp():
  """The fleet's CLI under torch.distributed.run: an NCCL group of one
  (NCCL refuses two ranks on one card)."""
  config = Config(**DP_FLEET)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_fleet_dp_') as logdir:
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node=1', '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=train', '--runtime=fleet', f'--logdir={logdir}',
           f'--total_environment_frames={config.frames_per_step}']
    cmd += [f'--{field}={value}' for field, value in DP_FLEET.items()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'fleet CLI under torch.distributed.run failed '
                         f'({proc.returncode}):\n{proc.stderr[-8000:]}')
    if 'process group (nccl): rank 0 of 1' not in proc.stderr:
      raise AssertionError(f'no NCCL group joined:\n{proc.stderr[-8000:]}')
    _check_precision_line(proc.stderr, 'cli_fleet_dp')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      losses = [e['value'] for e in map(json.loads, f)
                if e['tag'] == 'total_loss']
    controller_line = _controller_logs('cli_fleet_dp', logdir)
  if len(losses) != 1 or not all(map(math.isfinite, losses)):
    raise AssertionError(f'fleet CLI total_loss {losses}')
  log(f'cli_fleet_dp: 1 step in {time.perf_counter() - t0:.1f} s in an NCCL '
      f'group of one, total_loss {losses}; {controller_line}')


def _full_width_unrolls(config, num, seed=0):
  """`num` unrolls as the actors emit them at the config's widths."""
  rng = np.random.RandomState(seed)
  t1, a = config.unroll_length + 1, config.num_actions
  frames = rng.randint(0, 256, (num, t1, config.height, config.width, 3),
                       dtype=np.uint8)
  return [ActorOutput(
      level_name=np.int32(0),
      agent_state=tuple(rng.randn(1, 256).astype(np.float32)
                        for _ in range(2)),
      env_outputs=StepOutput(
          rng.randn(t1).astype(np.float32),
          StepOutputInfo(rng.randn(t1).astype(np.float32),
                         rng.randint(0, 100, t1).astype(np.int32)),
          rng.rand(t1) > 0.9, (frames[i], np.zeros((t1, 16), np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, a, t1).astype(np.int32),
          rng.randn(t1, a).astype(np.float32),
          rng.randn(t1).astype(np.float32)))
          for i in range(num)]


def phase_unroll_fleet():
  """Unroll staging at the slice's widths: the arena of 32 full-width
  unrolls, copied one by one on a side stream, bit-equal to
  `batch_unrolls` staged as batch staging stages it; then the one-rank
  fleet (the fleet phase's config) with staging_mode='unroll' for 8
  learner steps, K1 once per step; its ms per learner step beside the
  fleet phase's (batch staging) of this run. Returns the fleet's launch
  counts."""
  config = Config(**FLEET, staging_mode='unroll')
  unrolls = _full_width_unrolls(config, config.batch_size)
  copy_stream = torch.cuda.Stream()
  stager = ring_buffer.UnrollBatchStager(
      config.batch_size, device='cuda', copy_stream=copy_stream)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for u in unrolls:
    stager.add(u)
  arena = stager.finish()
  torch.cuda.synchronize()
  unroll_ms = 1e3 * (time.perf_counter() - t0)
  t0 = time.perf_counter()
  placed = learner.place_batch(
      batch_unrolls(unrolls, empty=learner.pinned_empty), 'cuda', copy_stream)
  torch.cuda.synchronize()
  batch_ms = 1e3 * (time.perf_counter() - t0)
  leaves = []
  map_structure(lambda a, b: leaves.append(torch.equal(a, b)), arena, placed)
  if len(leaves) != 12 or not all(leaves):
    raise AssertionError(f'the unroll arena differs from batch_unrolls: '
                         f'{leaves}')
  with tempfile.TemporaryDirectory(prefix='chip_smoke_unroll_') as logdir:
    run, counts = _drive('unroll_fleet', lambda: driver.train(
        Config(**FLEET, staging_mode='unroll', logdir=logdir),
        max_steps=UNROLL_FLEET_STEPS, device='cuda', stall_timeout_secs=300))
    controller_line = _controller_logs('unroll_fleet', logdir)
  if counts['vtrace'] != UNROLL_FLEET_STEPS or counts['vtrace_sharded']:
    raise AssertionError(f'unroll_fleet launches {counts}')
  prefetch = run.stats['prefetcher']
  if prefetch['mode'] != 'unroll' or prefetch['unrolls_staged'] < (
      UNROLL_FLEET_STEPS * config.batch_size):
    raise AssertionError(f'unroll_fleet prefetcher {prefetch}')
  timed_s, waited_s = _step_times(run, FLEET_TIMED_FROM)
  timed_steps = UNROLL_FLEET_STEPS - FLEET_TIMED_FROM
  step_ms = 1e3 * timed_s / timed_steps
  log(f'unroll_fleet: the arena of {config.batch_size} full-width unrolls '
      f'bit-equal to batch_unrolls (all 12 leaves); one batch staged per '
      f'unroll in {unroll_ms:.2f} ms, stacked and copied at once in '
      f'{batch_ms:.2f} ms (host clock, outside the fleet)')
  log(f'unroll_fleet: {step_ms:.2f} ms per learner step over steps '
      f'{FLEET_TIMED_FROM + 1}-{UNROLL_FLEET_STEPS} with unroll staging, '
      f'{MEASURED.get("fleet_step_ms", float("nan")):.2f} ms with batch '
      f'staging (the fleet phase, this run); blocked in prefetcher.get '
      f'{waited_s / timed_s:.4f}; vtrace launches {counts["vtrace"]}; '
      f'prefetcher {prefetch}; {controller_line}')
  return counts


def _tp_steps(config, device, mesh, batch, steps):
  """`steps` TP steps from the seeded params: (median ms per step after
  the first, losses, grad norms, the full state gathered before the
  first step and after each (learner.state_to_payload), the step's
  mode, counts). The gathers are collectives, outside the timing."""
  agent = _seeded_agent(config, device)
  state = train_parallel.make_sharded_train_state(agent, config, mesh)
  step, place = train_parallel.make_sharded_train_step(agent, config,
                                                       mesh, batch)
  local = place(batch)

  def gathered():
    return learner.state_to_payload(
        train_parallel.gather_state(state, step.layout))

  times, losses, norms, states = [], [], [], [gathered()]
  _zero_counts()
  for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, local)
    losses.append(float(metrics['total_loss']))
    norms.append(float(metrics['grad_norm']))
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    states.append(gathered())
  counts = _counts()
  return (1e3 * statistics.median(times[1:]), losses, norms, states,
          step.tp_compute, counts)


def _one_rank_steps(config, device, batch, states):
  """The one-rank reference on the same batch: the losses of
  len(states) - 1 steps from the seeded params, and for each TP step
  the one-rank step from the TP run's gathered state before it,
  (loss, grad norm, state after): each TP step held on its own, so the
  rounding of earlier steps does not compound into the comparison."""
  agent = _seeded_agent(config, device)
  state = learner.make_train_state(agent, config)
  step = learner.make_train_step_fn(agent, config)
  batch = map_structure(lambda x: x.to(device), batch)
  free = []
  for _ in states[1:]:
    state, metrics = step(state, batch)
    free.append(float(metrics['total_loss']))
  forced = []
  for before in states[:-1]:
    state = learner.load_state_(state, before)
    state, metrics = step(state, batch)
    forced.append((float(metrics['total_loss']),
                   float(metrics['grad_norm']),
                   learner.state_to_payload(state)))
  return free, forced


def _tp_rank(rank, world, port, outdir):
  def body(group, device):
    mesh = mesh_lib.make_mesh(device, model_parallelism=2)
    result = {}
    # Each mode runs as training runs it: chip_smoke sets no cuDNN flag.
    # The sharded step pins cuDNN's deterministic algorithms itself
    # (train_parallel.pinned_cudnn, ROADMAP C4), so its run repeats.
    for mode, cut in (('gathered', {}), ('sharded', TP_SHARDED_CUT)):
      config = Config(**dict(SLICE, **cut), **group, model_parallelism=2,
                      tp_compute=mode)
      batch = _small_batch(config.unroll_length, config.batch_size,
                           config.num_actions, config.height, config.width)
      if torch.backends.cudnn.deterministic:
        raise AssertionError('tp: cudnn.deterministic is set before the '
                             f'{mode} run')
      ms, losses, norms, states, ran, counts = _tp_steps(
          config, device, mesh, batch, TP_STEPS)
      if torch.backends.cudnn.deterministic:
        raise AssertionError(f'tp: the {mode} step left '
                             'cudnn.deterministic set')
      result[mode] = dict(ms=ms, losses=losses, norms=norms, states=states,
                          ran=ran, counts=counts)
      if rank == 0:
        one = Config(**dict(SLICE, **cut))
        result[mode]['one'] = _one_rank_steps(one, device, batch, states)
    # A short TP fleet: publishes gather a full copy for the server.
    logdir = os.path.join(outdir, 'fleet')
    config = Config(**TP_FLEET, **group, logdir=logdir)
    seen = {}

    def on_step(run, step, metrics):
      if step == TP_FLEET_STEPS:  # a collective, on every rank
        layout = train_parallel.param_layout(run.agent, config, run.mesh)
        seen['full'] = train_parallel.gather_state(run.state, layout)
        seen['layout'] = layout

    _zero_counts()
    run = driver.train(config, max_steps=TP_FLEET_STEPS, device=device,
                       stall_timeout_secs=300, on_step=on_step)
    counts = _counts()
    served = run.server.live_params()
    full = seen['full']
    # A timed save at {data 1, model 2}: the gather and rank 0's write.
    checkpointer = checkpoint_lib.Checkpointer(
        os.path.join(outdir, 'timed_save'), mesh=run.mesh,
        registry=sharding.from_config(config), layout=seen['layout'])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpointer.save(run.state, force=True)
    save_ms = 1e3 * (time.perf_counter() - t0)
    result['fleet'] = dict(
        counts=counts, update_steps=run.state.update_steps,
        served_equal=all(torch.equal(served[k], full.params[k])
                         for k in full.params),
        params=_param_snapshot(full.params), save_ms=save_ms,
        write_ms=(1e3 * checkpointer.last_save_secs
                  if checkpointer.last_save_secs else None),
        checkpoints=os.path.join(logdir, 'checkpoints'),
        blocks={k: tuple(v.shape) for k, v in run.state.params.items()})
    return result

  _in_rank(rank, world, port, outdir, body)


def _tp_violations(what, got, want, rtol, atol):
  """(max |got - want|, [what] if any element exceeds atol + rtol *
  |want| else [])."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  diff = np.abs(got - want)
  bad = bool(np.any(diff > atol + rtol * np.abs(want)))
  return float(diff.max(initial=0.0)), [what] if bad else []


def _gate_share(got, want, rtol, atol):
  """The largest |got - want| / (atol + rtol |want|): above 1 fails."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max(
      initial=0.0))


def _bit_equal(a, b):
  return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in b)


def _tp_check(mode, ranks, decay):
  """One TP mode's run, as training runs it, against the one-rank step
  (rank 0 ran it); returns ({quantity: largest difference},
  [failures]). Raises if a rank's gathered states differ
  from rank 0's. Gated: the losses of the 3 steps from
  the seeded params at rtol 2e-4; each TP step against the one-rank
  step from the same state (the TP run's before it), its loss and grad
  norm at rtol 2e-4 and its params at rtol 5e-4 / atol 5e-6 (slice_dp's
  gates); and after step 1 the squared gradient the step adds to
  RMSProp's nu, (1 - decay) g^2 = nu - decay nu_before, within 1e-3 of
  the one-rank step's in relative L2 norm, tensor by tensor.

  The nu gate is normwise because the TP and one-rank steps reduce in
  other orders and through other cuDNN algorithms (16 rows against 32,
  half the output channels against all of them), and the elements
  whose terms cancel differ elementwise by up to ~1e-3 of the tensor's
  largest; a wrong scale, half a batch or a misplaced block moves the
  norm by O(1). It holds after step 1, from the seeded params; after
  the large steps 2 and 3 a few tensors' norms differ by ~1e-3 too
  (PERF.md), so from step 2 on nu is reported, with the largest
  elementwise difference, and the params, loss and grad norm stay
  gated."""
  free, forced = ranks[0][mode]['one']
  failures, worst, rows = [], {}, []
  for rank, r in enumerate(ranks):
    got = r[mode]
    if got['ran'] != mode or got['counts']['vtrace_sharded'] != TP_STEPS:
      raise AssertionError(f'tp {mode} rank {rank}: ran {got["ran"]}, '
                           f'launches {got["counts"]}')
    for i, (st, ref) in enumerate(zip(got['states'],
                                      ranks[0][mode]['states'])):
      if not (_bit_equal(st['params'], ref['params']) and
              _bit_equal(st['opt_state']['nu'], ref['opt_state']['nu'])):
        raise AssertionError(f'tp {mode} rank {rank} gathered state {i} '
                             'differs from rank 0\'s')
    _, bad = _tp_violations(f'{mode} rank {rank} losses from the seeded '
                            'params', got['losses'], free, 2e-4, 0.0)
    failures += bad
    for i, (loss, norm, after) in enumerate(forced):
      what = f'{mode} rank {rank} step {i + 1}'
      tp_after = got['states'][i + 1]
      step = {}
      step['loss'], bad = _tp_violations(f'{what} loss', got['losses'][i],
                                         loss, 2e-4, 0.0)
      failures += bad
      step['grad_norm'], bad = _tp_violations(
          f'{what} grad_norm', got['norms'][i], norm, 2e-4, 0.0)
      failures += bad
      step['params'] = step['params_share'] = 0.0
      for k, v in after['params'].items():
        have, want = tp_after['params'][k].numpy(), v.numpy()
        diff, bad = _tp_violations(f'{what} params {k}', have, want,
                                   5e-4, 5e-6)
        step['params'] = max(step['params'], diff)
        step['params_share'] = max(step['params_share'],
                                   _gate_share(have, want, 5e-4, 5e-6))
        failures += bad
      step['nu'] = step['nu_rel'] = 0.0
      before = got['states'][i]['opt_state']['nu']
      for k, v in after['opt_state']['nu'].items():
        want = v.numpy().astype(np.float64)
        have = tp_after['opt_state']['nu'][k].numpy().astype(np.float64)
        added = want - decay * before[k].numpy().astype(np.float64)
        diff = np.linalg.norm(have - want)
        rel = diff / np.linalg.norm(added) if diff else 0.0
        step['nu'] = max(step['nu'], float(np.abs(have - want).max()))
        step['nu_rel'] = max(step['nu_rel'], float(rel))
        if i == 0 and not rel <= 1e-3:
          failures.append(f'{what} nu {k}: relative L2 {rel:.3e}')
      rows.append((rank, i + 1, step))
      for q, v in step.items():
        worst[q] = max(worst.get(q, 0.0), v)
  for rank, i, step in rows:
    log(f'tp {mode} rank {rank} step {i} against the one-rank step from '
        f'the same state: max |diff| ' +
        ', '.join(f'{q} {v:.3e}' for q, v in step.items()))
  return worst, failures


def phase_tp():
  """Tensor parallelism, 2 gloo ranks sharing the card as a {data 1,
  model 2} mesh. The TP train step in `gathered` at the slice's widths
  (T=100, global B=32, 16 rows per rank) and in `sharded` at T=20, B=8,
  each for 3 steps from the seeded params, against the one-rank step on
  the same batch on the card (`_tp_check`: the losses of the 3 steps,
  and each step from the same state, params, nu, loss and grad norm),
  as training runs it, timed and gated: the sharded step pins cuDNN's
  deterministic algorithms itself (ROADMAP C4, repaired), and the phase
  checks that no cuDNN flag is left set around either run. The sharded
  mode's cut: through
  gloo every blocked layer's output crosses the host twice (the
  all-gather forward, the input gradient's all-reduce backward), and at
  T=100, B=32 the first conv's output alone is 1.43 GB ([3232, 16, 72,
  96] float32). Then a TP fleet (16 process-hosted actors per rank,
  gathered, publishing every step) for 3 learner steps: K1b once per
  step per rank, the server's snapshot bit-equal to the gathered params;
  its tail save at {data 1, model 2} restored at {data 1, model 1}
  bit-equal. Returns the TP fleet's launch counts, summed over the
  ranks."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_tp_') as outdir:
    ranks = _run_ranks('tp', _tp_rank, outdir)
    config = Config(**SLICE)
    registry = sharding.from_config(config)
    target = learner.make_train_state(_seeded_agent(config, 'cuda'), config)
    checkpointer = checkpoint_lib.Checkpointer(
        ranks[0]['fleet']['checkpoints'], registry=registry)
    saved_mesh = checkpointer.saved_mesh_shape()
    restored = checkpointer.restore_resharded(
        target, registry, mesh_lib.Mesh(0, 1, torch.device('cuda')))
    restore_ms = 1e3 * checkpointer.last_restore_secs
    controller_line = _controller_logs('tp fleet',
                                       os.path.join(outdir, 'fleet'))
  if saved_mesh != {'data': 1, 'model': 2}:
    raise AssertionError(f'tp: the manifest\'s mesh {saved_mesh}')
  fleet0 = ranks[0]['fleet']
  if restored.update_steps != TP_FLEET_STEPS or not all(
      torch.equal(v.cpu(), fleet0['params'][k])
      for k, v in restored.params.items()):
    raise AssertionError('tp: the TP checkpoint restored at {data 1, model '
                         '1} differs from the gathered params')
  worst, failures = {}, []
  for mode in ('gathered', 'sharded'):
    worst[mode], bad = _tp_check(mode, ranks, config.decay)
    failures += bad
  if failures:
    raise AssertionError(f'tp: {len(failures)} comparison(s) out of '
                         f'tolerance: {failures[:8]}')
  counts = {name: sum(r['fleet']['counts'][name] for r in ranks)
            for name in COUNTERS}
  for rank, r in enumerate(ranks):
    fleet = r['fleet']
    if (fleet['update_steps'] != TP_FLEET_STEPS or
        fleet['counts']['vtrace_sharded'] != TP_FLEET_STEPS or
        fleet['counts']['vtrace']):
      raise AssertionError(f'tp fleet rank {rank}: {fleet["update_steps"]} '
                           f'steps, launches {fleet["counts"]}')
    if not fleet['served_equal']:
      raise AssertionError(f'tp fleet rank {rank}: the server\'s snapshot '
                           'is not the gathered params')
  cut = ranks[0]['fleet']['blocks']

  def ms(key):
    return f'{ranks[0][key]["ms"]:.2f} / {ranks[1][key]["ms"]:.2f}'

  log(f'tp: as trained (the sharded step under pinned_cudnn, ROADMAP C4): '
      f'gathered step (T=100, B=32, 16 rows per rank) {ms("gathered")} ms '
      f'per step (rank 0 / 1, median of steps 2-{TP_STEPS}); sharded step '
      f'(T=20, B=8) {ms("sharded")} ms; largest share of the params gate '
      f'against the one-rank step from the same state: gathered '
      f'{worst["gathered"]["params_share"]:.4f}, sharded '
      f'{worst["sharded"]["params_share"]:.4f}; losses '
      f'{ranks[0]["gathered"]["losses"]} / {ranks[0]["sharded"]["losses"]}; '
      f'largest |diff| against the one-rank step from the same state, '
      f'over the steps and ranks: {worst}')
  log(f'tp fleet: {TP_FLEET_STEPS} learner steps, kernel launches {counts}; '
      f'the server serves the gathered params; blocks at rest, e.g. '
      f'core.weight_ih {cut["core.weight_ih"]}, torso.linear.weight '
      f'{cut["torso.linear.weight"]}; save at {{data 1, model 2}} '
      f'{fleet0["save_ms"]:.1f} ms (gather + write; the write '
      f'{fleet0["write_ms"]:.1f} ms), restore at {{data 1, model 1}} '
      f'{restore_ms:.1f} ms, bit-equal; {controller_line}')
  return counts


# --- the learner extensions (PopArt, pixel control, the instruction
# encoder, IMPACT with the replay tier, the memory fit) ---------------------

# The full-feature fleet: the fleet phase's widths on the 30 fake DMLab-30
# levels (actor i plays level i % 30 and stamps its level id), PopArt over
# the 30 tasks, pixel control at 0.01, the instruction encoder, bf16.
FULL_FEATURE = dict(FLEET, env_backend='fake', level_name='dmlab30',
                    use_popart=True, pixel_control_cost=0.01,
                    use_instruction=True, compute_dtype='bfloat16')
# IMPACT with sample reuse at the same widths, float32.
IMPACT_FLEET = dict(FULL_FEATURE, compute_dtype='float32',
                    surrogate='impact', replay_k=2, replay_ratio=0.5,
                    target_update_interval=4)
EXTENSIONS_ANAKIN = dict(SLICE, use_popart=True, pixel_control_cost=0.01,
                         use_instruction=True)
EXTENSIONS_ANAKIN_STEPS = 3
FULL_FEATURE_STEPS = 5
POPART_DP_FLEET = dict(DP_FLEET, env_backend='fake', level_name='dmlab30',
                       use_popart=True, pixel_control_cost=0.01,
                       use_instruction=True)
POPART_DP_STEPS = 4
NUM_TASKS = 30


def _extension_run(name, config, steps=FLEET_STEPS):
  """driver.train at `config` for `steps` learner steps, steps 3.. timed
  and the last two profiled; returns (run, counts, the last step's
  metrics as floats, the timings)."""
  window, last = [], {}
  profiler = torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA])

  def on_step(run, step, metrics):
    if step == steps - 2:
      torch.cuda.synchronize()
      _start_own_profiler(profiler, name)
      window.append(time.perf_counter())
    elif step == steps:
      torch.cuda.synchronize()
      window.append(time.perf_counter())
      profiler.stop()
      last.update({k: float(v) for k, v in metrics.items()})

  torch.cuda.reset_peak_memory_stats()
  run, counts = _drive(name, lambda: driver.train(
      config, max_steps=steps, device='cuda', stall_timeout_secs=300,
      on_step=on_step))
  if run.state.update_steps != steps:
    raise AssertionError(f'{name}: update_steps {run.state.update_steps}')
  if counts['vtrace'] != steps or counts['conv_pool'] or (
      counts['vtrace_sharded']):
    raise AssertionError(f'{name}: launches {counts} in {steps} learner '
                         'steps')
  with open(os.path.join(config.logdir, 'summaries.jsonl')) as f:
    events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if len(losses) != steps or not all(map(math.isfinite, losses)):
    raise AssertionError(f'{name} losses: {losses}')
  timed_s, waited_s = _step_times(run, FLEET_TIMED_FROM)
  busy_ms = _busy_ms_or_fail(name, profiler)
  log(f'{name}: {_verdict_line(_slo_verdict(name, config.logdir))}; '
      f'{_controller_logs(name, config.logdir)}')
  timing = dict(
      steps=steps,
      step_ms=1e3 * timed_s / (steps - FLEET_TIMED_FROM),
      blocked=waited_s / timed_s,
      busy_ms=busy_ms / 2,
      idle=1 - busy_ms / (1e3 * (window[1] - window[0])),
      peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  return run, counts, last, losses, timing


def _timing_line(timing):
  busy = (f'{timing["busy_ms"]:.2f} ms per learner step, idle share '
          f'{timing["idle"]:.4f}')
  return (f'{timing["step_ms"]:.2f} ms per learner step over steps '
          f'{FLEET_TIMED_FROM + 1}-{timing["steps"]}; learner blocked in '
          f'prefetcher.get {timing["blocked"]:.4f} of that time; device '
          f'busy {busy} (torch.profiler over the last 2 steps, inference '
          f'kernels included); peak allocated {timing["peak_gib"]:.3f} GiB')


def phase_full_feature():
  """The full-feature fleet (FULL_FEATURE) for 5 learner steps, 3 timed:
  one K1 launch per learner step, finite losses, PopArt statistics over
  the 30 tasks that every task's actors moved, a finite pixel-control
  loss; env-frames/s, ms per learner step, device busy and idle share,
  peak memory, the PopArt sigma range."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_ff_') as logdir:
    config = Config(**FULL_FEATURE, logdir=logdir)
    run, counts, last, losses, timing = _extension_run(
        'full_feature', config, steps=FULL_FEATURE_STEPS)
  popart = run.state.popart
  moved = int((popart.mu != 0).sum())
  if popart.mu.shape != (NUM_TASKS,) or moved != NUM_TASKS:
    raise AssertionError(f'full_feature: PopArt over {popart.mu.shape} '
                         f'tasks, {moved} moved')
  for key in ('pixel_control_loss', 'popart_sigma_min', 'popart_sigma_max'):
    if not math.isfinite(last[key]):
      raise AssertionError(f'full_feature: {key} {last[key]}')
  fps = config.frames_per_step / timing['step_ms'] * 1e3
  log(f'full_feature: {fps:.1f} env-frames/s, {_timing_line(timing)}; '
      f'losses {losses}; pixel_control_loss {last["pixel_control_loss"]}; '
      f'PopArt sigma {last["popart_sigma_min"]:.6f}..'
      f'{last["popart_sigma_max"]:.6f} over {moved} of {NUM_TASKS} tasks; '
      f'vtrace launches {counts["vtrace"]}')
  MEASURED['full_feature_step_ms'] = timing['step_ms']
  return counts


def _ff_reference_steps(device, compute=torch.float32, steps=1):
  """`steps` full-feature learner steps (deep torso, 72x96, T=20, B=4, 30
  tasks, PopArt, pixel control, the instruction encoder, fused V-trace)
  on one fixed batch from the seeded state, on `device`, the layers
  computing in `compute` (float64 gives the reference's accurate sums;
  params, the heads' outputs, V-trace and the losses stay float32):
  (losses, metrics, initial params, params, PopArt mu) on the CPU."""
  from scalable_agent_tpu_torch.models import ImpalaAgent
  from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN
  from scalable_agent_tpu_torch.testing import make_example_batch
  config = Config(**dict(FULL_FEATURE, compute_dtype='float32',
                         unroll_length=20, batch_size=4,
                         num_action_repeats=1))
  agent = ImpalaAgent(SLICE['num_actions'], (72, 96, 3), torso='deep',
                      dtype=compute, use_instruction=True,
                      num_popart_tasks=NUM_TASKS, use_pixel_control=True)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  state = learner.make_train_state(agent, config, NUM_TASKS)
  initial = _param_snapshot(state.params)
  step = learner.make_train_step_fn(agent, config)
  batch = make_example_batch(21, 4, 72, 96, SLICE['num_actions'],
                             MAX_INSTRUCTION_LEN, device=device,
                             num_tasks=NUM_TASKS, done_prob=0.1)
  batch = batch._replace(level_name=torch.tensor(
      [0, 7, 29, 7], dtype=torch.int32, device=device))
  losses = []
  for _ in range(steps):
    state, metrics = step(state, batch)
    losses.append(float(metrics['total_loss']))
  return (np.asarray(losses), {k: float(v) for k, v in metrics.items()},
          initial, _param_snapshot(state.params), state.popart.mu.cpu())


# The reference's parameter gate. Over two steps an elementwise gate
# (rtol 1e-3 / atol 1e-5) and then a normwise one (1e-3 of each tensor's
# two updates) failed on the first conv: at losses of ~1e4 a gradient
# element of it is a float32 sum of ~6e5 terms with heavy cancellation,
# RMSProp's first steps carry that rounding into the update, and the
# second step's gradient, taken at the moved params, compounds it. So
# the phase holds one step, and holds the card to the float32 error
# itself: per parameter tensor, its distance to the same step computed
# with float64 layers on the CPU within FF_REFERENCE_MARGIN times the
# CPU float32 run's distance to it, or within FF_REFERENCE_FLOOR of the
# norm of the tensor's update, whichever is larger. cuDNN's and cuBLAS's
# algorithms round otherwise than the CPU's (a margin of 2 read 2.02 on
# a conv bias), and where the CPU's float32 happens to land very close
# the floor carries the gate. A layout or arithmetic fault reads orders
# of magnitude more.
FF_REFERENCE_MARGIN = 4.0
FF_REFERENCE_FLOOR = 1e-3


def phase_full_feature_reference():
  """The float32 full-feature learner step on the card against the same
  step on the CPU, from one seeded state on one fixed batch: loss, grad
  norm, pixel-control loss and PopArt sigma rtol 1e-4, PopArt mu rtol
  1e-4 / atol 1e-7; per parameter tensor ||p_card - p_64|| <=
  max(FF_REFERENCE_MARGIN ||p_cpu - p_64||, FF_REFERENCE_FLOOR
  ||p_64 - p_initial||), with p_64 the same steps with float64 layers on
  the CPU. It prints the largest shares of that bound and the largest
  elementwise differences."""
  cpu_losses, cpu_m, initial, cpu_params, cpu_mu = _ff_reference_steps(
      'cpu')
  _, _, _, ref_params, _ = _ff_reference_steps('cpu', torch.float64)
  gpu_losses, gpu_m, _, gpu_params, gpu_mu = _ff_reference_steps('cuda')
  np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
  for key in ('grad_norm', 'pixel_control_loss', 'popart_sigma_min',
              'popart_sigma_max'):
    np.testing.assert_allclose(gpu_m[key], cpu_m[key], rtol=1e-4,
                               err_msg=key)
  np.testing.assert_allclose(gpu_mu.numpy(), cpu_mu.numpy(), rtol=1e-4,
                             atol=1e-7)
  ratios, card_err, cpu_err = [], 0.0, 0.0
  for k in cpu_params:
    card = float((gpu_params[k] - ref_params[k]).norm())
    cpu = float((cpu_params[k] - ref_params[k]).norm())
    moved = float((ref_params[k] - initial[k]).norm())
    bound = max(FF_REFERENCE_MARGIN * cpu, FF_REFERENCE_FLOOR * moved)
    if not card <= bound:
      raise AssertionError(
          f'full_feature_reference {k}: ||card - f64|| {card:.3e} > max('
          f'{FF_REFERENCE_MARGIN} x ||cpu - f64|| {cpu:.3e}, '
          f'{FF_REFERENCE_FLOOR} x ||update|| {moved:.3e})')
    ratios.append((card / bound if bound else 0.0, k))
    card_err = max(card_err,
                   float((gpu_params[k] - ref_params[k]).abs().max()))
    cpu_err = max(cpu_err, float((cpu_params[k] - ref_params[k]).abs().max()))
  log(f'full_feature reference: loss card {gpu_losses.tolist()} cpu '
      f'{cpu_losses.tolist()}; grad_norm card {gpu_m["grad_norm"]} cpu '
      f'{cpu_m["grad_norm"]}; pixel_control_loss card '
      f'{gpu_m["pixel_control_loss"]} cpu {cpu_m["pixel_control_loss"]}; '
      f'max |PopArt mu diff| {float((gpu_mu - cpu_mu).abs().max()):.3e}; '
      f'against the float64-layer steps: ||card - f64|| over its bound, '
      f'largest {[(round(r, 3), k) for r, k in sorted(ratios)[-3:]]}, '
      f'median {statistics.median(r for r, _ in ratios):.3f}; max '
      f'|card - f64| {card_err:.3e}, max |cpu - f64| {cpu_err:.3e}')


def phase_cli_full_feature():
  """The CLI with the full-feature flags (bf16, dmlab30 on the fake
  backend, PopArt, pixel control, the instruction encoder) for 1 learner
  step through 32 process-hosted actors."""
  config = Config(**FULL_FEATURE)
  with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_ff_') as logdir:
    cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=train', '--runtime=fleet', f'--logdir={logdir}',
           f'--total_environment_frames={config.frames_per_step}']
    cmd += [f'--{field}={value}' for field, value in FULL_FEATURE.items()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'full-feature CLI failed ({proc.returncode}):\n'
                         f'{proc.stderr[-8000:]}')
    _check_precision_line(proc.stderr, 'cli_full_feature')
    if 'PopArt statistics per task' not in proc.stderr:
      raise AssertionError('cli_full_feature: no PopArt statistics logged')
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      events = [json.loads(line) for line in f]
    controller_line = _controller_logs('cli_full_feature', logdir)
  tags = {e['tag']: e['value'] for e in events if 'value' in e}
  for key in ('total_loss', 'pixel_control_loss', 'popart_sigma_max'):
    if not math.isfinite(tags.get(key, math.nan)):
      raise AssertionError(f'cli_full_feature: {key} {tags.get(key)}')
  log(f'cli_full_feature: 1 step in {time.perf_counter() - t0:.1f} s; '
      f'last total_loss {tags["total_loss"]}, pixel_control_loss '
      f'{tags["pixel_control_loss"]}, popart_sigma_max '
      f'{tags["popart_sigma_max"]}; {controller_line}')


def phase_impact_fleet():
  """IMPACT with sample reuse (IMPACT_FLEET) for 8 learner steps: one K1
  launch per learner step (on the target network's rhos and values), the
  frame clock at the fresh slots served (fewer frames than steps x
  frames_per_step), re-serves and replayed unrolls, the target network
  equal to the params after the refresh at step 8; fresh frames, the
  tier's occupancy and the clip fraction."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_impact_') as logdir:
    config = Config(**IMPACT_FLEET, logdir=logdir)
    run, counts, last, losses, timing = _extension_run('impact_fleet',
                                                       config)
  prefetch, buffer = run.stats['prefetcher'], run.stats['buffer']
  frames_per_unroll = config.unroll_length * config.num_action_repeats
  fresh = prefetch['fresh_slots_served'] * frames_per_unroll
  steps_frames = FLEET_STEPS * config.frames_per_step
  if run.frames != fresh or not fresh < steps_frames:
    raise AssertionError(f'impact_fleet: frames {run.frames}, fresh {fresh}'
                         f', steps x frames_per_step {steps_frames}')
  if prefetch['batch_reserves'] < FLEET_STEPS // 2 - 1 or not (
      buffer['replay_reused_unrolls']):
    raise AssertionError(f'impact_fleet: no reuse: {prefetch} {buffer}')
  state = run.state
  if not all(torch.equal(state.target_params[k], p.detach())
             for k, p in state.params.items()):
    raise AssertionError('impact_fleet: the target network is not the '
                         'params after the refresh at step 8')
  if not math.isfinite(last['impact_clip_fraction']):
    raise AssertionError(f'impact_fleet: clip fraction {last}')
  fps = fresh / (1e-3 * timing['step_ms'] * FLEET_STEPS)
  log(f'impact_fleet: fresh frames {fresh} against {FLEET_STEPS} steps x '
      f'{config.frames_per_step} = {steps_frames} ({fresh / steps_frames:.4f}'
      f'); {prefetch["serves"]} serves, {prefetch["batch_reserves"]} '
      f're-serves; replay tier occupancy {buffer["replay_occupancy"]} of '
      f'{buffer["replay_capacity"]}, {buffer["replay_reused_unrolls"]} '
      f'replayed unrolls, mean staleness {buffer["replay_mean_staleness"]}, '
      f'evictions age/version/crc {buffer["replay_evictions_age"]}/'
      f'{buffer["replay_evictions_version"]}/{buffer["replay_evictions_crc"]}'
      f'; clip fraction at step {FLEET_STEPS} {last["impact_clip_fraction"]}'
      f'; about {fps:.1f} fresh env-frames/s; {_timing_line(timing)}; '
      f'losses {losses}; vtrace launches {counts["vtrace"]}')
  return counts


def phase_extensions_anakin():
  """anakin.train with PopArt (one task), pixel control and the
  instruction encoder at the slice's widths for 3 fused steps: one K1
  launch per step, finite summaries, the state's PopArt statistics and
  a checkpoint that holds them."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_ext_anakin_') as d:
    config = Config(**EXTENSIONS_ANAKIN, mode='anakin', logdir=d,
                    summary_secs=0,
                    total_environment_frames=10**9)
    t0 = time.perf_counter()
    carry, counts = _drive('extensions_anakin', lambda: anakin.train(
        config, max_steps=EXTENSIONS_ANAKIN_STEPS, device='cuda'))
    wall = time.perf_counter() - t0
    with open(os.path.join(d, 'summaries.jsonl')) as f:
      losses = [e['value'] for e in map(json.loads, f)
                if e['tag'] == 'total_loss']
    saved = checkpoint_lib.Checkpointer(os.path.join(d, 'checkpoints'))
    steps = saved.all_steps()
  state = carry.train_state
  if counts['vtrace'] != EXTENSIONS_ANAKIN_STEPS or counts['conv_pool']:
    raise AssertionError(f'extensions_anakin: launches {counts}')
  if (state.update_steps != EXTENSIONS_ANAKIN_STEPS or not losses or
      not all(map(math.isfinite, losses)) or
      state.popart.mu.shape != (1,) or steps != [EXTENSIONS_ANAKIN_STEPS]):
    raise AssertionError(f'extensions_anakin: steps {state.update_steps}, '
                         f'losses {losses}, popart {state.popart}, '
                         f'checkpoints {steps}')
  log(f'extensions_anakin: {EXTENSIONS_ANAKIN_STEPS} fused steps in '
      f'{wall:.2f} s (set-up and first step included); losses {losses}; '
      f'PopArt mu {state.popart.mu.tolist()} sigma '
      f'{float(popart_lib.sigma(state.popart)[0]):.6f}; vtrace launches '
      f'{counts["vtrace"]}')
  return counts


def _popart_dp_rank(rank, world, port, outdir):
  def body(group, device):
    digests, moments = [], []

    def on_step(run, step, metrics):
      digests.append(_params_digest(run.state.params))
      moments.append(run.state.popart.mu.cpu().numpy().tobytes().hex())

    config = Config(**POPART_DP_FLEET, **group,
                    logdir=os.path.join(outdir, 'fleet'))
    _zero_counts()
    run = driver.train(config, max_steps=POPART_DP_STEPS, device=device,
                       stall_timeout_secs=300, on_step=on_step)
    counts = _counts()
    gathered = [None] * world
    dist.all_gather_object(gathered, (digests, moments))
    result = dict(counts=counts, update_steps=run.state.update_steps,
                  gathered=gathered, sdc_mismatches=run.health.sdc_mismatches)
    del run
    # The sharded step on a fixed full-width global batch (float32)
    # against the one-rank step from the same seeded state.
    from scalable_agent_tpu_torch.models.instruction import (
        MAX_INSTRUCTION_LEN)
    from scalable_agent_tpu_torch.testing import make_example_batch
    step_config = Config(**dict(POPART_DP_FLEET, **group,
                                num_action_repeats=1))
    batch = make_example_batch(
        step_config.unroll_length + 1, step_config.batch_size, 72, 96,
        SLICE['num_actions'], MAX_INSTRUCTION_LEN, num_tasks=NUM_TASKS,
        done_prob=0.1)
    mesh = mesh_lib.make_mesh(device)

    def fresh_agent(cfg):
      agent = driver.build_agent(cfg, SLICE['num_actions'], NUM_TASKS)
      init_params(agent, torch.Generator().manual_seed(cfg.seed))
      return agent.to(device)

    agent = fresh_agent(step_config)
    state = train_parallel.make_sharded_train_state(agent, step_config, mesh)
    step, place = train_parallel.make_sharded_train_step(agent, step_config,
                                                         mesh, batch)
    _zero_counts()
    state, metrics = step(state, place(batch))
    result['step_counts'] = _counts()
    result['step'] = dict(loss=float(metrics['total_loss']),
                          pc=float(metrics['pixel_control_loss']),
                          params=_param_snapshot(state.params),
                          mu=state.popart.mu.cpu())
    if rank == 0:
      one = Config(**dict(POPART_DP_FLEET, num_action_repeats=1))
      agent1 = fresh_agent(one)
      state1, metrics1 = learner.make_train_step_fn(agent1, one)(
          learner.make_train_state(agent1, one, NUM_TASKS),
          map_structure(lambda v: v.to(device), batch))
      result['single'] = dict(loss=float(metrics1['total_loss']),
                              pc=float(metrics1['pixel_control_loss']),
                              params=_param_snapshot(state1.params),
                              mu=state1.popart.mu.cpu())
    return result

  _in_rank(rank, world, port, outdir, body)


def phase_popart_dp():
  """2 gloo ranks sharing the card: the data-parallel fleet with PopArt,
  pixel control and the instruction encoder (16 actors per rank, global
  B=32) for 4 learner steps: K1b once per learner step per rank, the
  ranks' params and PopArt statistics bit-equal after every step, no SDC
  mismatch. Then the sharded step on a fixed full-width global batch
  against the one-rank step from the same state: loss and pixel-control
  loss rtol 2e-4, PopArt mu rtol 2e-4 / atol 1e-7, params rtol 5e-4 /
  atol 5e-6 (slice_dp's gate). Returns the fleet's launch counts."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_popart_dp_') as out:
    ranks = _run_ranks('popart_dp', _popart_dp_rank, out)
    controller_line = _controller_logs('popart_dp', os.path.join(out, 'fleet'))
  counts = {name: sum(r['counts'][name] for r in ranks) for name in COUNTERS}
  for rank, r in enumerate(ranks):
    if (r['counts']['vtrace_sharded'] != POPART_DP_STEPS or
        r['counts']['vtrace'] or r['update_steps'] != POPART_DP_STEPS or
        r['step_counts']['vtrace_sharded'] != 1):
      raise AssertionError(f'popart_dp rank {rank}: launches {r["counts"]},'
                           f' {r["step_counts"]}, {r["update_steps"]} steps')
    if r['gathered'][0] != r['gathered'][1] or r['sdc_mismatches']:
      raise AssertionError("popart_dp: the ranks' params or PopArt "
                           'statistics differ after a step, or the SDC '
                           f'sentinel fired ({r["sdc_mismatches"]})')
  single = ranks[0]['single']
  err = 0.0
  for rank, r in enumerate(ranks):
    got = r['step']
    np.testing.assert_allclose(got['loss'], single['loss'], rtol=2e-4)
    np.testing.assert_allclose(got['pc'], single['pc'], rtol=2e-4)
    np.testing.assert_allclose(got['mu'].numpy(), single['mu'].numpy(),
                               rtol=2e-4, atol=1e-7)
    for k, p in single['params'].items():
      np.testing.assert_allclose(got['params'][k].numpy(), p.numpy(),
                                 rtol=5e-4, atol=5e-6, err_msg=k)
      err = max(err, float((got['params'][k] - p).abs().max()))
  log(f'popart_dp: kernel launches {counts} (by rank: '
      f'{[r["counts"] for r in ranks]}); params and PopArt statistics '
      f'bit-equal across the ranks after each of the {POPART_DP_STEPS} '
      f'steps; SDC 0 mismatches. Sharded step at full width, float32: loss '
      f'2 ranks {ranks[0]["step"]["loss"]} / {ranks[1]["step"]["loss"]}, '
      f'1 rank {single["loss"]}; pixel_control_loss '
      f'{ranks[0]["step"]["pc"]} / {single["pc"]}; max |param diff| '
      f'{err:.3e}; {controller_line}')
  return counts


def phase_fit():
  """parallel/fit.py's memory_fit on the card at B=32 and B=16 per card:
  one full-feature bf16 train step each, its peak allocated memory
  against HBM_BUDGET_FRACTION of the card's memory."""
  from scalable_agent_tpu_torch.parallel import fit
  for rows in (32, 16):
    result = fit.memory_fit('cuda', batch_size=rows)
    if not result['fits'] or not result['total_loss_finite']:
      raise AssertionError(f'fit B={rows}: {result}')
    log(fit.format_fit(result))
    log(json.dumps(result, sort_keys=True))


# The rest of the Anakin runtime: the procgen core with the regret
# curriculum at the slice's widths (the JAX defaults: 8 levels, wall
# density 0.25, a 5x5 grid, 4 actions).
PROCGEN = dict(SLICE, env_backend='procgen', num_actions=4,
               curriculum='regret')
PROCGEN_STEPS = 4
PBT_MEMBERS = 4
PBT_ROUNDS = 2
PBT_ROUND_STEPS = 2
# The serial population: two suites, cut to T=20, B=8 (12 member runs
# with their set-up in the smoke run's time), 2 members per suite so
# that a suite has a donor.
PBT_SERIAL = dict(SLICE, env_backend='procgen', num_actions=4,
                  unroll_length=20, batch_size=8, pbt_population=4,
                  pbt_suites='procgen,gridworld', runtime='anakin',
                  summary_secs=0, checkpoint_secs=10**6)
PBT_SERIAL_ROUNDS = 3
CURRICULUM_DP = dict(PROCGEN, curriculum='td')
CURRICULUM_DP_STEPS = 3
FILLER_FLEET_STEPS = 5
FILLER_FLEET = dict(FLEET, env_backend='procgen', num_actions=4,
                    anakin_filler=True, surrogate='impact')
DEEP_FAST_STEPS = 3
CORES = {'gridworld': dict(SLICE, env_backend='gridworld', unroll_length=20),
         'cue_memory': dict(SLICE, env_backend='cue_memory', num_actions=3,
                            unroll_length=20)}
CORE_STEPS = 2


def _run_summary(name, config, history, fps):
  losses = [h['total_loss'] for h in history]
  if not all(map(math.isfinite, losses)):
    raise AssertionError(f'{name}: losses {losses}')
  step_ms = config.frames_per_step / fps * 1e3
  log(f'{name}: {fps:.1f} env-frames/s, {step_ms:.2f} ms per fused step '
      f'({config.frames_per_step} frames, first step untimed); losses '
      f'{losses}; peak allocated '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
  return step_ms


def phase_procgen_anakin():
  """The procgen core with the regret curriculum at the slice's widths:
  4 fused steps through anakin.run, one K1 launch each, the curriculum's
  metrics; then one more unroll's score update on the card against the
  CPU's update_scores on the same batch and level ids (rtol 1e-6, visits
  exact)."""
  config = Config(**PROCGEN)
  torch.cuda.reset_peak_memory_stats()
  (carry, history, fps), counts = _drive('procgen_anakin', lambda: anakin.run(
      config, PROCGEN_STEPS, device='cuda'))
  if counts['vtrace'] != PROCGEN_STEPS or carry.train_state.update_steps != (
      PROCGEN_STEPS):
    raise AssertionError(f'procgen_anakin: launches {counts}, steps '
                         f'{carry.train_state.update_steps}')
  _run_summary('procgen_anakin', config, history, fps)
  last = history[-1]
  log(f'procgen_anakin: curriculum entropy {last["curriculum_entropy"]:.6f} '
      f'(uniform {math.log(config.procgen_num_levels):.6f}), levels visited '
      f'{last["curriculum_levels_visited"]:.0f} of '
      f'{config.procgen_num_levels}, score max '
      f'{last["curriculum_score_max"]:.6f}')
  core = anakin.make_env_core(config)
  agent = driver.build_agent(config, core.num_actions).to('cuda')
  agent.load_state_dict(carry.train_state.params, strict=False)
  batch, env, level_ids = anakin._act(make_step_fn(agent), core, carry,
                                      config.unroll_length, True)
  card, _ = anakin._curriculum_update(config, batch, env.env_state,
                                      level_ids)
  to_cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731
  cpu, _ = anakin._curriculum_update(
      config, map_structure(to_cpu, batch),
      env.env_state._replace(level_scores=env.env_state.level_scores.cpu(),
                             level_visits=env.env_state.level_visits.cpu()),
      [x.cpu() for x in level_ids])
  np.testing.assert_allclose(card.level_scores.cpu().numpy(),
                             cpu.level_scores.numpy(), rtol=1e-6)
  np.testing.assert_array_equal(card.level_visits.cpu().numpy(),
                                cpu.level_visits.numpy())
  log(f'procgen_anakin: score update card vs CPU max |diff| '
      f'{float((card.level_scores.cpu() - cpu.level_scores).abs().max()):.3e}'
      f'; scores {[round(v, 6) for v in card.level_scores.tolist()]}; '
      f'visits {card.level_visits.tolist()}')
  return counts


def _pbt_config(logdir, **kw):
  frames = Config(**PROCGEN).frames_per_step
  return Config(**dict(PROCGEN, runtime='anakin', logdir=logdir,
                       pbt_population=PBT_MEMBERS, pbt_vectorized=True,
                       pbt_round_frames=PBT_ROUND_STEPS * frames,
                       total_environment_frames=(PBT_ROUNDS *
                                                 PBT_ROUND_STEPS * frames),
                       summary_secs=0, checkpoint_secs=10**6, **kw))


def phase_pbt_vectorized():
  """The main path: the lockstep population of 4 members on procgen with
  the regret curriculum at the slice's widths, through
  driver.train_population, 2 rounds of 2 lockstep steps: one K1 launch
  per lockstep step (not per member), the record (PBT_LOG.json
  vectorized, population_summaries.jsonl, the pbt_winner incident), each
  member's ladder at every round, peak memory. Beforehand, outside the
  counts: members 0 and 1's first lockstep train steps against the train
  step a serial member runs, from the same state on the same batch
  (slice_reference's bar). Then the CLI form."""
  _pbt_reference(_pbt_config('/unused'))
  _free_the_card('pbt_vectorized')
  torch.cuda.reset_peak_memory_stats()
  with tempfile.TemporaryDirectory(prefix='chip_smoke_pbt_') as logdir:
    config = _pbt_config(logdir)
    t0 = time.perf_counter()
    run, counts = _drive('pbt_vectorized', lambda: driver.train(
        config, device='cuda'))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = PBT_ROUNDS * PBT_ROUND_STEPS
    with open(os.path.join(logdir, 'PBT_LOG.json')) as f:
      pbt_log = json.load(f)
    with open(os.path.join(logdir, 'population_summaries.jsonl')) as f:
      rows = [json.loads(line) for line in f]
    kinds = _incident_kinds(logdir, 0)
    ladders = [checkpoint_lib.Checkpointer(os.path.join(
        logdir, f'member_{k:02d}', 'checkpoints')).all_steps()
               for k in range(PBT_MEMBERS)]
  if counts['vtrace'] != steps:
    raise AssertionError(f'pbt_vectorized: K1 launched {counts["vtrace"]} '
                         f'times in {steps} lockstep steps of {PBT_MEMBERS} '
                         'members')
  if (not pbt_log['vectorized'] or len(pbt_log['rounds']) != PBT_ROUNDS or
      len(rows) != PBT_ROUNDS * PBT_MEMBERS or 'pbt_winner' not in kinds or
      any(ladder[-1] != steps for ladder in ladders) or
      any(c.train_state.update_steps != steps for c in run.members)):
    raise AssertionError(f'pbt_vectorized: log {pbt_log}, {len(rows)} rows, '
                         f'incidents {kinds}, ladders {ladders}')
  exploits = kinds.count('pbt_exploit')
  log(f'pbt_vectorized: {PBT_MEMBERS} members x {steps} lockstep steps in '
      f'{wall:.2f} s (set-up included); K1 launches {counts["vtrace"]}; '
      f'{exploits} exploit(s); returns by round '
      f'{[r["returns"] for r in pbt_log["rounds"]]}; winner member '
      f'{pbt_log["winner"]["member"]}; ladders {ladders}; peak allocated '
      f'{peak:.3f} GiB ({peak / PBT_MEMBERS:.3f} per member)')
  del run
  _pbt_cli()
  return counts


def _pbt_reference(config):
  """One lockstep step of the population's members on the card, timed,
  and members 0 (the configured hypers) and 1 (explored) against the
  train step a serial population member runs (its own agent, its member
  config) from the same state on the same batch: loss rtol 1e-4, params
  rtol 1e-3 / atol 1e-5."""
  core = anakin.make_env_core(config)
  members = [driver._member_config(config, m) for m in driver._initial_members(
      config, np.random.default_rng(config.seed), [config.env_backend])]
  agents, carries = anakin.init_members(
      members[0], core, [c.seed for c in members], 'cuda')
  checked = (0, 1)
  before = [learner.state_to_payload(carries[k].train_state) for k in checked]
  hypers = {name: torch.tensor([getattr(c, name) for c in members],
                               device='cuda')
            for name in ('learning_rate', 'entropy_cost')}
  vstep = anakin.make_vectorized_anakin_step(agents, core, members[0],
                                             return_batch=True)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  carries, metrics = vstep(carries, hypers)
  losses = [float(metrics['total_loss'][k]) for k in checked]
  lockstep_ms = 1e3 * (time.perf_counter() - t0)
  batches = [metrics['batch'][k] for k in checked]
  got = [_param_snapshot(carries[k].train_state.params) for k in checked]
  del agents, carries, metrics
  report = []
  for i, k in enumerate(checked):
    agent = driver.build_agent(members[k], core.num_actions).to('cuda')
    state = learner.load_state_(
        learner.make_train_state(agent, members[k]), before[i])
    state, want = learner.make_train_step_fn(agent, members[k])(
        state, batches[i])
    np.testing.assert_allclose(losses[i], float(want['total_loss']),
                               rtol=1e-4)
    err = 0.0
    for name, p in state.params.items():
      np.testing.assert_allclose(got[i][name].numpy(),
                                 p.detach().cpu().numpy(), rtol=1e-3,
                                 atol=1e-5, err_msg=f'member {k}: {name}')
      err = max(err, float((got[i][name] - p.detach().cpu()).abs().max()))
    report.append(f'member {k} (lr {members[k].learning_rate:.6g}, '
                  f'entropy {members[k].entropy_cost:.6g}): loss '
                  f'{losses[i]} / {float(want["total_loss"])}, max |param '
                  f'diff| {err:.3e}')
    del agent, state
  log(f'pbt_vectorized reference: one lockstep step of {len(members)} '
      f'members {lockstep_ms:.1f} ms (first, with set-up work); against '
      f'the serial member\'s train step: {"; ".join(report)}')


def _pbt_cli():
  """The CLI form: --mode=train --runtime=anakin --env_backend=procgen
  --curriculum=regret --pbt_population=4 --pbt_vectorized=true, 2
  rounds of one lockstep step, as a subprocess."""
  frames = Config(**PROCGEN).frames_per_step
  with tempfile.TemporaryDirectory(prefix='chip_smoke_pbt_cli_') as logdir:
    cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--mode=train', '--runtime=anakin', f'--logdir={logdir}',
           '--summary_secs=0', f'--pbt_population={PBT_MEMBERS}',
           '--pbt_vectorized=true', f'--pbt_round_frames={frames}',
           f'--total_environment_frames={2 * frames}']
    cmd += [f'--{field}={value}' for field, value in PROCGEN.items()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
      raise RuntimeError(f'pbt CLI failed ({proc.returncode}):\n'
                         f'{proc.stderr[-6000:]}')
    _check_precision_line(proc.stderr, 'pbt_vectorized cli')
    with open(os.path.join(logdir, 'PBT_LOG.json')) as f:
      pbt_log = json.load(f)
  if not pbt_log['vectorized'] or len(pbt_log['rounds']) != 2:
    raise AssertionError(f'pbt CLI: {pbt_log}')
  log(f'pbt_vectorized cli: {PBT_MEMBERS} members, 2 rounds in '
      f'{time.perf_counter() - t0:.1f} s; returns '
      f'{[r["returns"] for r in pbt_log["rounds"]]}')


def phase_pbt_serial():
  """The serial population over two suites (procgen, gridworld; 2
  members each) at T=20, B=8, 3 rounds of one step per member: the
  in-process exploits go through train_anakin(initial_state=...) (at
  least one), each a pbt_exploit incident; the record's suites."""
  inherited = []
  train_anakin = driver.train_anakin

  def spy(member_config, **kw):
    if kw.get('initial_state') is not None:
      inherited.append(member_config.logdir[-2:])
    return train_anakin(member_config, **kw)

  with tempfile.TemporaryDirectory(prefix='chip_smoke_pbt_serial_') as d:
    frames = Config(**PBT_SERIAL).frames_per_step
    config = Config(**PBT_SERIAL, logdir=d, pbt_round_frames=frames,
                    total_environment_frames=PBT_SERIAL_ROUNDS * frames)
    driver.train_anakin = spy
    t0 = time.perf_counter()
    try:
      run, counts = _drive('pbt_serial', lambda: driver.train(
          config, device='cuda'))
    finally:
      driver.train_anakin = train_anakin
    wall = time.perf_counter() - t0
    with open(os.path.join(d, 'PBT_LOG.json')) as f:
      pbt_log = json.load(f)
    kinds = _incident_kinds(d, 0)
  runs = PBT_SERIAL_ROUNDS * config.pbt_population
  if counts['vtrace'] != runs or run.state.update_steps != PBT_SERIAL_ROUNDS:
    raise AssertionError(f'pbt_serial: launches {counts} in {runs} member '
                         f'steps; winner at {run.state.update_steps}')
  if not inherited or len(inherited) != kinds.count('pbt_exploit'):
    raise AssertionError(f'pbt_serial: exploits {kinds.count("pbt_exploit")}'
                         f', through initial_state {inherited}')
  if pbt_log['vectorized'] or pbt_log['rounds'][0]['suites'] != [
      'procgen', 'gridworld', 'procgen', 'gridworld']:
    raise AssertionError(f'pbt_serial: {pbt_log}')
  log(f'pbt_serial: {config.pbt_population} members x {PBT_SERIAL_ROUNDS} '
      f'rounds in {wall:.2f} s; {len(inherited)} exploit(s) through '
      f'initial_state (members {inherited}); returns by round '
      f'{[r["returns"] for r in pbt_log["rounds"]]}; decisions '
      f'{[r["decisions"] for r in pbt_log["rounds"]]}')
  return counts


def _curriculum_dp_rank(rank, world, port, outdir):
  def body(group, device):
    config = Config(**CURRICULUM_DP, **group, runtime='anakin',
                    logdir=os.path.join(outdir, 'run'), summary_secs=0,
                    checkpoint_secs=10**6)
    mesh = mesh_lib.make_mesh(device)
    _zero_counts()
    run = driver.train_anakin(config, max_steps=CURRICULUM_DP_STEPS,
                              device=device, mesh=mesh)
    counts = _counts()
    env = run.carry.env_state
    return dict(counts=counts, update_steps=run.state.update_steps,
                scores=env.level_scores.cpu(), visits=env.level_visits.cpu(),
                level_ids=env.level_id.cpu())
  _in_rank(rank, world, port, outdir, body)


def phase_curriculum_dp():
  """The td curriculum over 2 gloo ranks sharing the card, through
  driver.train_anakin: K1b once per fused step per rank (K1 never), the
  ranks' score and visit tables bit-equal, CURRICULUM_LEVELS.json and
  the curriculum summaries on rank 0."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_curr_dp_') as outdir:
    ranks = _run_ranks('curriculum_dp', _curriculum_dp_rank, outdir)
    with open(os.path.join(outdir, 'run', 'CURRICULUM_LEVELS.json')) as f:
      levels = json.load(f)
    with open(os.path.join(outdir, 'run', 'summaries.jsonl')) as f:
      tags = {json.loads(line)['tag'] for line in f}
  counts = {name: sum(r['counts'][name] for r in ranks) for name in COUNTERS}
  for r in ranks:
    if (r['counts']['vtrace_sharded'] != CURRICULUM_DP_STEPS or
        r['counts']['vtrace'] or r['update_steps'] != CURRICULUM_DP_STEPS):
      raise AssertionError(f'curriculum_dp: {r["counts"]}, steps '
                           f'{r["update_steps"]}')
  if not (torch.equal(ranks[0]['scores'], ranks[1]['scores']) and
          torch.equal(ranks[0]['visits'], ranks[1]['visits'])):
    raise AssertionError(f'curriculum_dp: the ranks\' tables differ: '
                         f'{ranks[0]["scores"]} / {ranks[1]["scores"]}')
  if levels['scores'] != ranks[0]['scores'].tolist() or (
      'curriculum_entropy' not in tags):
    raise AssertionError(f'curriculum_dp: CURRICULUM_LEVELS.json {levels}, '
                         f'tags {sorted(tags)}')
  total = CURRICULUM_DP_STEPS * (Config(**CURRICULUM_DP).unroll_length - 1) * (
      Config(**CURRICULUM_DP).batch_size)
  if sum(levels['visits']) != total:
    raise AssertionError(f'curriculum_dp: {sum(levels["visits"])} visits, '
                         f'{total} transitions')
  log(f'curriculum_dp: kernel launches {counts} (by rank: '
      f'{[r["counts"] for r in ranks]}); tables bit-equal across the '
      f'ranks; scores {[round(v, 6) for v in levels["scores"]]}; visits '
      f'{levels["visits"]}; probs {[round(v, 4) for v in levels["probs"]]}')
  return counts


def phase_filler_fleet():
  """The hybrid filler on the fleet at the fleet phase's widths: 32
  process-hosted actors on the host procgen env, IMPACT, 5 learner steps.
  The fleet's clocks are those of a run without the filler (update_steps
  6, its frame clock 6 x frames_per_step, the RMSProp count 6, the LR at
  the fleet's count); filler updates > 0, counted apart; K1 once per
  learner step plus once per filler update."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_filler_') as logdir:
    config = Config(**FILLER_FLEET, logdir=logdir)
    t0 = time.perf_counter()
    run, counts = _drive('filler_fleet', lambda: driver.train(
        config, max_steps=FILLER_FLEET_STEPS, device='cuda', stall_timeout_secs=300))
    wall = time.perf_counter() - t0
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      events = [json.loads(line) for line in f]
    controller_line = _controller_logs('filler_fleet', logdir)
  filler = run.stats['filler']
  lr = [e['value'] for e in events if e['tag'] == 'learning_rate']
  schedule = learner.make_schedule(config)
  if (run.state.update_steps != FILLER_FLEET_STEPS or
      run.frames != FILLER_FLEET_STEPS * config.frames_per_step or
      int(run.state.opt_state.count) != FILLER_FLEET_STEPS or
      lr != [float(schedule(s)) for s in range(FILLER_FLEET_STEPS)]):
    raise AssertionError(f'filler_fleet: clocks steps '
                         f'{run.state.update_steps} frames {run.frames} '
                         f'count {int(run.state.opt_state.count)} lr {lr}')
  if not filler['updates'] > 0 or filler['skipped']:
    raise AssertionError(f'filler_fleet: filler {filler}')
  if counts['vtrace'] != FILLER_FLEET_STEPS + filler['updates']:
    raise AssertionError(f'filler_fleet: K1 {counts["vtrace"]} for '
                         f'{FILLER_FLEET_STEPS} learner steps and '
                         f'{filler["updates"]} filler updates')
  log(f'filler_fleet: {FILLER_FLEET_STEPS} learner steps in {wall:.2f} s (set-up '
      f'included) with {filler["updates"]} filler updates ({filler["frames"]} '
      f'filler frames, B={filler["batch_size"]}, T={filler["unroll_length"]}, '
      f'{filler["updates"] / FILLER_FLEET_STEPS:.3f} per learner step); fleet '
      f'clocks: update_steps {run.state.update_steps}, frames {run.frames}, '
      f'RMSProp count {int(run.state.opt_state.count)}; K1 launches '
      f'{counts["vtrace"]}; prefetcher {run.stats["prefetcher"]}; '
      f'{controller_line}')
  return counts


def phase_deep_fast():
  """The slice with torso=deep_fast in float32 and bf16, 3 fused steps
  each (one K1 launch per step); then its train step on the small fixed
  batch, card vs CPU, at slice_reference's bar."""
  counts = {name: 0 for name in COUNTERS}
  for dtype in ('float32', 'bfloat16'):
    config = Config(**dict(SLICE, torso='deep_fast', compute_dtype=dtype))
    torch.cuda.reset_peak_memory_stats()
    (carry, history, fps), run_counts = _drive(
        f'deep_fast {dtype}',
        lambda c=config: anakin.run(c, DEEP_FAST_STEPS, device='cuda'))
    if run_counts['vtrace'] != DEEP_FAST_STEPS:
      raise AssertionError(f'deep_fast {dtype}: launches {run_counts}')
    step_ms = _run_summary(f'deep_fast {dtype}', config, history, fps)
    deep_ms = MEASURED.get(f'slice_{dtype}_step_ms')
    if deep_ms:  # the slice phase ran earlier in this process
      log(f'deep_fast {dtype}: {step_ms / deep_ms:.4f} x the deep slice\'s '
          f'fused step ({deep_ms:.2f} ms) in this run')
    counts = {k: counts[k] + run_counts[k] for k in counts}
    del carry
  config = Config(**dict(SLICE, torso='deep_fast', height=24, width=32,
                         batch_size=3, unroll_length=5, num_action_repeats=1,
                         total_environment_frames=100))
  cpu_losses, _, cpu_params = _train_small_batch(config, 'cpu')
  gpu_losses, _, gpu_params = _train_small_batch(config, 'cuda')
  np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
  err = 0.0
  for k in cpu_params:
    np.testing.assert_allclose(gpu_params[k].numpy(), cpu_params[k].numpy(),
                               rtol=1e-3, atol=1e-5, err_msg=k)
    err = max(err, float((gpu_params[k] - cpu_params[k]).abs().max()))
  log(f'deep_fast reference: losses card {gpu_losses.tolist()} cpu '
      f'{cpu_losses.tolist()}; max |param diff| {err:.3e}')
  return counts


def phase_cores_anakin():
  """The gridworld and cue-memory cores at the slice's widths cut to
  T=20: 2 fused steps each through anakin.run, one K1 launch per step."""
  counts = {name: 0 for name in COUNTERS}
  for name, fields in CORES.items():
    config = Config(**fields)
    (carry, history, fps), run_counts = _drive(
        f'cores_anakin {name}',
        lambda c=config: anakin.run(c, CORE_STEPS, device='cuda'))
    if run_counts['vtrace'] != CORE_STEPS:
      raise AssertionError(f'cores_anakin {name}: launches {run_counts}')
    _run_summary(f'cores_anakin {name}', config, history, fps)
    counts = {k: counts[k] + run_counts[k] for k in counts}
  return counts


# --- A7.1 and A7.2: evaluation and the serving plane ---

# The eval phase's fleet: the full_feature phase's (the 30 fake DMLab-30
# levels at the slice's widths) in float32, with 25-step episodes, so 2
# eval episodes per level take less than one unroll.
EVAL_FLEET = dict(FULL_FEATURE, compute_dtype='float32', episode_length=25)
EVAL_TRAIN_STEPS = 1
EVAL_EPISODES = 1
CACHE_FLEET = dict(FLEET, inference_state_cache=True)
# The cache/carry pair: the resize run (steps 5..6 timed, after the
# fleet is back to 32) and one carry run of CACHE_PAIR_STEPS (steps 2..3
# timed). Two more runs (carry, cache) for a second pair took the whole
# script to 1,092.6 s of its 1,200 s limit on one H100 host, and the
# pairs' reading stays unresolved either way (PERF.md).
CACHE_PAIR_STEPS = 3
CACHE_MAIN_STEPS = 6
CACHE_MAIN_TIMED_FROM = 4
RESIZE_AT = {2: 16, 4: 32}  # learner step -> set_target_size
ADMISSION_SLOTS = 16
ADMISSION_STEPS = 3
MIXED_FLEET = dict(FLEET, fleet_tasks='gridworld:2,procgen', num_actions=4,
                   use_popart=True)
MIXED_FLEET_STEPS = 4
SERVING_VERSIONS = 5
SERVING_ROUNDS = 16


def _cli(args, logdir, name, timeout=600):
  cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
         f'--logdir={logdir}'] + args
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                        cwd=os.path.dirname(os.path.abspath(__file__)))
  if proc.returncode != 0:
    raise RuntimeError(f'{name} CLI failed ({proc.returncode}):\n'
                       f'{proc.stderr[-8000:]}')
  _check_precision_line(proc.stderr, name)
  return proc.stderr, time.perf_counter() - t0


def _logged_int(stderr, prefix):
  for line in stderr.splitlines():
    if prefix in line:
      return int(line.split(prefix)[1].split()[0])
  return None


def phase_eval_cli():
  """The fleet CLI trains EVAL_TRAIN_STEPS learner steps on the 30 fake
  DMLab-30 levels and saves; `--mode=test` with test_num_episodes=1
  evaluates from the same logdir: exit 0, eval_summaries.jsonl holds a
  finite test_episode_return per level at the restored step 2 and the
  dmlab30 scores, equal to suites.eval_scores over the levels' returns;
  prints the eval's peak device memory against the trainer's, the
  server's mean merged batch and the wall times."""
  from scalable_agent_tpu_torch.envs import factory, suites
  config = Config(**EVAL_FLEET)
  flags = [f'--{field}={value}' for field, value in EVAL_FLEET.items()]
  with tempfile.TemporaryDirectory(prefix='chip_smoke_eval_') as logdir:
    train_err, train_s = _cli(
        ['--mode=train', '--runtime=fleet',
         f'--total_environment_frames='
         f'{EVAL_TRAIN_STEPS * config.frames_per_step}'] + flags,
        logdir, 'eval_cli train')
    controller_line = _controller_logs('eval_cli train', logdir)
    eval_err, eval_s = _cli(
        ['--mode=test', f'--test_num_episodes={EVAL_EPISODES}'] + flags,
        logdir, 'eval_cli test')
    with open(os.path.join(logdir, 'eval_summaries.jsonl')) as f:
      rows = [json.loads(line) for line in f]
  test_levels = factory.test_level_names(config)
  train_levels = factory.level_names(config)
  returns = {r['tag'].split('/')[0]: r['value'] for r in rows
             if r['tag'].endswith('/test_episode_return')}
  if sorted(returns) != sorted(test_levels) or not all(
      map(math.isfinite, returns.values())):
    raise AssertionError(f'eval_cli: test_episode_return rows {returns}')
  if {r['step'] for r in rows} != {EVAL_TRAIN_STEPS}:
    raise AssertionError(f'eval_cli: steps {sorted({r["step"] for r in rows})}')
  scores = {r['tag']: r['value'] for r in rows
            if r['tag'].startswith('dmlab30/')}
  # A level's score reads its mean return, which is what its row holds.
  want = suites.SUITES['dmlab30'].eval_scores(
      {train: [returns[test]] for train, test in zip(train_levels,
                                                     test_levels)})
  if sorted(scores) != sorted(want) or any(
      not math.isclose(scores[k], want[k], rel_tol=1e-9, abs_tol=1e-9)
      for k in want):
    raise AssertionError(f'eval_cli: scores {scores}, want {want}')
  batch = [line for line in eval_err.splitlines() if 'mean batch' in line]
  eval_peak = _logged_int(eval_err, 'eval peak device memory: ')
  train_peak = _logged_int(train_err, 'peak device memory: ')
  log(f'eval_cli: train {EVAL_TRAIN_STEPS} steps in {train_s:.1f} s, '
      f'--mode=test over {len(returns)} levels x {EVAL_EPISODES} episodes '
      f'in {eval_s:.1f} s (process wall time, set-up included); scores '
      f'{scores}; peak allocated {eval_peak / 2**30:.3f} GiB in eval '
      f'against {train_peak / 2**30:.3f} GiB in the trainer; '
      f'{batch[-1].split("eval played ")[-1] if batch else "no server line"}'
      f'; the trainer\'s {controller_line}')


def _cache_run(name, config, steps, on_step=None,
               timed_from=FLEET_TIMED_FROM, controller=CONTROLLER_ANYWHERE):
  """driver.train for `steps` learner steps, its controller's log checked
  against the moves `controller` allows; returns (run, counts, ms per
  step over the steps after `timed_from`, the server's host<->device
  bytes per request)."""
  run, counts = _drive(name, lambda: driver.train(
      config, max_steps=steps, device='cuda', stall_timeout_secs=300,
      on_step=on_step))
  if run.state.update_steps != steps or counts['vtrace'] != steps or (
      counts['conv_pool'] or counts['vtrace_sharded']):
    raise AssertionError(f'{name}: update_steps {run.state.update_steps}, '
                         f'launches {counts} in {steps} learner steps')
  with open(os.path.join(config.logdir, 'summaries.jsonl')) as f:
    events = [json.loads(line) for line in f]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  if len(losses) != steps or not all(map(math.isfinite, losses)):
    raise AssertionError(f'{name} losses: {losses}')
  log(f'{name}: {_controller_logs(name, config.logdir, controller)}')
  timed_s, _ = _step_times(run, timed_from)
  server = run.stats['server']
  wire = (server['h2d_bytes'] + server['d2h_bytes']) / server['requests']
  return run, counts, 1e3 * timed_s / (steps - timed_from), wire


def phase_state_cache_fleet():
  """The fleet phase's config with the state arena (CACHE_FLEET), 32
  actors, 6 learner steps: K1 once per learner step, finite losses,
  changed params; set_target_size(16) after step 2 and (32) after step
  4, the parked actors' slots released and re-acquired. With one
  CACHE_PAIR_STEPS-step carry run after it, one cache/carry pair: ms per
  learner step, env-frames/s, host<->device bytes per actor step."""
  reports = []

  def on_step(run, step, metrics):
    if step in RESIZE_AT:
      reports.append(run.fleet.set_target_size(RESIZE_AT[step]))

  with tempfile.TemporaryDirectory(prefix='chip_smoke_cache_') as logdir:
    config = Config(**CACHE_FLEET, logdir=logdir)
    agent = driver.build_agent(config, SLICE['num_actions'])
    init_params(agent, torch.Generator().manual_seed(config.seed))
    initial = _param_snapshot(dict(agent.named_parameters()))
    run, counts, step_ms, wire = _cache_run(
        'state_cache_fleet', config, CACHE_MAIN_STEPS, on_step,
        timed_from=CACHE_MAIN_TIMED_FROM)
  final = _param_snapshot(run.state.params)
  moved = max(float((final[k] - initial[k]).abs().max()) for k in final)
  server, fleet = run.stats['server'], run.stats['fleet']
  parked = [r['parked'] for r in reports]
  unparked = [r['unparked'] for r in reports]
  if not (moved > 0 and len(parked[0]) == 16 and len(unparked[1]) == 16):
    raise AssertionError(f'state_cache_fleet: moved {moved}, resize '
                         f'{reports}')
  if server['acquires'] < config.num_actors + 16 or not server['state_cache']:
    raise AssertionError(f'state_cache_fleet: slots not re-acquired: '
                         f'{server}')
  log(f'state_cache_fleet: {CACHE_MAIN_STEPS} learner steps; vtrace launches '
      f'{counts["vtrace"]}; max |param change| {moved:.3e}; resize to 16 '
      f'parked {len(parked[0])}, back to 32 unparked {len(unparked[1])}; '
      f'{server["acquires"]} slot acquires over {server["num_slots"]} '
      f'slots, {server["slots_free"]} free at exit; fleet {fleet}')
  log(f'state_cache_fleet: {step_ms:.2f} ms per learner step over steps '
      f'{CACHE_MAIN_TIMED_FROM + 1}-{CACHE_MAIN_STEPS}, '
      f'{config.frames_per_step / step_ms * 1e3:.1f} env-frames/s, '
      f'{wire:.1f} host<->device bytes per actor step (inference mean '
      f'batch {server["mean_batch"]:.2f})')
  with tempfile.TemporaryDirectory(prefix='chip_smoke_pair_') as logdir:
    cfg = Config(**FLEET, logdir=logdir)
    run, run_counts, carry_ms, carry_wire = _cache_run(
        'state_cache_run2_carry', cfg, CACHE_PAIR_STEPS, timed_from=1)
  counts = {c: counts[c] + run_counts[c] for c in counts}
  log(f'state_cache_run2_carry: {carry_ms:.2f} ms per learner step over '
      f'steps 2-{CACHE_PAIR_STEPS}, '
      f'{cfg.frames_per_step / carry_ms * 1e3:.1f} env-frames/s, '
      f'{carry_wire:.1f} host<->device bytes per actor step (inference '
      f'mean batch {run.stats["server"]["mean_batch"]:.2f}); cache / carry '
      f'{step_ms / carry_ms:.4f} per learner step, '
      f'{wire / carry_wire:.4f} per actor step\'s bytes')
  return counts


def _cache_reference_calls(config, rng, n, done_rows=()):
  calls = []
  for i in range(n):
    frame = rng.randint(0, 256, (config.height, config.width, 3)).astype(
        np.uint8)
    calls.append((np.int32(rng.randint(config.num_actions)), StepOutput(
        np.float32(rng.randn()), StepOutputInfo(np.float32(0), np.int32(0)),
        np.bool_(i in done_rows), (frame, np.zeros(16, np.int32)))))
  return calls


# state_cache_reference's callers start this far apart, so both servers
# merge them in the same order: a sampled action depends on its row.
ARRIVAL_GAP_SECS = 0.02


def phase_state_cache_reference():
  """The same 32 fixed callers through the cache path and the carry path
  on the card, one merged batch per step, 3 steps, the callers reaching
  each server in the same order: action, logits, baseline and new carry
  bit-equal (torch.equal on the host copies).
  Step 2 has done edges; before step 3 slot 0 is released and a fresh
  slot re-acquired (zeroed), against a zero carry on the carry path."""
  n = FLEET['num_actors']
  base = dict(FLEET, inference_timeout_ms=5000, inference_min_batch=n)
  config = Config(**base)
  agent = driver.build_agent(config, SLICE['num_actions'])
  params = {k: v.cuda() for k, v in init_params(
      agent, torch.Generator().manual_seed(config.seed)).items()}
  rng = np.random.RandomState(7)
  carries = [tuple(rng.randn(1, 256).astype(np.float32) * 0.3
                   for _ in range(2)) for _ in range(n)]
  steps = [_cache_reference_calls(config, rng, n, done)
           for done in ((), (1, 5, 30), ())]
  carry_server = InferenceServer(agent, params, config, seed=3,
                                 fleet_size=n)
  cache_server = InferenceServer(
      agent, params, Config(**dict(base, inference_state_cache=True)),
      seed=3, fleet_size=n)
  try:
    handles = [cache_server.initial_core_state() for _ in range(n)]
    for handle, carry in zip(handles, carries):
      handle.write(carry)
    states = list(carries)
    checked = 0
    for k, calls in enumerate(steps):
      if k == 2:
        handles[0].release()
        handles[0] = cache_server.initial_core_state()
        states[0] = tuple(np.zeros((1, 256), np.float32) for _ in range(2))
      want = _serve(carry_server, [(a, e, s) for (a, e), s in
                                   zip(calls, states)],
                    gap_secs=ARRIVAL_GAP_SECS)
      got = _serve(cache_server, [(a, e, h) for (a, e), h in
                                  zip(calls, handles)],
                   gap_secs=ARRIVAL_GAP_SECS)
      for i, ((w_out, w_carry), (g_out, handle)) in enumerate(zip(want,
                                                                  got)):
        g_carry = handle.snapshot()
        for a, b in zip(tuple(w_out) + tuple(w_carry),
                        tuple(g_out) + tuple(g_carry)):
          if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f'state_cache_reference: step {k} caller '
                                 f'{i}: cache path differs from carry path')
          checked += 1
      states = [c for _, c in want]
    stats = (carry_server.stats(), cache_server.stats())
  finally:
    carry_server.close()
    cache_server.close()
  if any(s['calls'] != len(steps) for s in stats):
    raise AssertionError(f'state_cache_reference: merged calls '
                         f'{[s["calls"] for s in stats]}, want {len(steps)}')
  log(f'state_cache_reference: {n} callers x {len(steps)} steps, '
      f'{checked} output arrays bit-equal (cache vs carry path, one merged '
      f'batch of {n} per step, done edges at step 2, slot 0 reused at step '
      f'3)')


def _serving_server(agent, params, **kw):
  """A card server at the fleet's widths whose merged calls carry all 32
  callers (kw overrides)."""
  fields = dict(FLEET, inference_timeout_ms=5000,
                inference_min_batch=FLEET['num_actors'])
  fields.update(kw)
  return InferenceServer(agent, params, Config(**fields), seed=5,
                         fleet_size=FLEET['num_actors'])


def _logits_bound(agent, params, quantized, calls):
  """First-order bound on |logits(int8) - logits(f32)| per (caller,
  action): sum over parameters of |d logit / d param| times the
  parameter's tensor's max quantization error (codec.max_abs_error of
  that tensor)."""
  from scalable_agent_tpu_torch.runtime import codec
  agent = agent.cuda()
  with torch.no_grad():
    for k, p in agent.named_parameters():
      p.copy_(params[k])
  errors = {k: codec.max_abs_error({k: quantized[k]}) for k in quantized}
  bounds = []
  for action, env_output, carry in calls:
    frame, instr = env_output.observation
    out, _ = agent(
        torch.tensor([[action]], device='cuda'), StepOutput(
            torch.tensor([[env_output.reward]], device='cuda'), None,
            torch.tensor([[env_output.done]], device='cuda'),
            (torch.from_numpy(frame)[None, None].cuda(),
             torch.from_numpy(instr)[None, None].cuda())),
        tuple(torch.from_numpy(c).cuda() for c in carry))
    row = []
    for a in range(out.policy_logits.shape[-1]):
      grads = torch.autograd.grad(out.policy_logits[0, 0, a],
                                  list(agent.parameters()),
                                  retain_graph=True, allow_unused=True)
      row.append(sum(float(g.abs().sum()) * errors[k] for (k, _), g in zip(
          agent.named_parameters(), grads) if g is not None))
    bounds.append(row)
  return np.asarray(bounds)


# batch_fn and FamilyBatcher on the card: the full-width agent's T=1
# forward (argmax, no sampling) behind the batcher, BATCHED_CALLERS threads
# with their own rows each, against an unbatched forward of those rows in
# float32 without TF32. The tolerance is float32 rounding: the merged
# batch's convolutions may take another cuDNN algorithm than one caller's.
BATCHED_CALLERS = 24
BATCHED_ROWS = 2
BATCHED_ROUNDS = 4
BATCHED_MIN = 16
BATCHED_TIMEOUT_MS = 20
BATCHED_RTOL = BATCHED_ATOL = 1e-5
FAMILY_FRAMES = ((72, 96), (48, 64))


def _t1_forward(agent, sizes=None, times=None):
  """The agent's T=1 forward over numpy rows (prev action, reward, done,
  frame, instruction, carry c, carry h) on the card; returns (logits,
  baseline) as numpy. Appends each call's rows and seconds to `sizes`
  and `times` when given."""
  def forward(action, reward, done, frame, instr, c, h):
    t = time.perf_counter()
    card = lambda a: torch.from_numpy(a)[None].cuda()  # noqa: E731
    with torch.no_grad():
      out, _ = agent(card(action), StepOutput(
          card(reward), None, card(done), (card(frame), card(instr))),
                     (torch.from_numpy(c).cuda(), torch.from_numpy(h).cuda()))
    logits = out.policy_logits[0].cpu().numpy()
    baseline = out.baseline[0].cpu().numpy()
    if sizes is not None:
      sizes.append(len(action))
      times.append(time.perf_counter() - t)
    return logits, baseline
  return forward


def _caller_rows(rng, frame, rows=BATCHED_ROWS):
  """One caller's request: `rows` rows of the forward's inputs."""
  carry = [(rng.randn(rows, 256) * 0.3).astype(np.float32)
           for _ in range(2)]
  return (rng.randint(SLICE['num_actions'], size=rows).astype(np.int32),
          rng.randn(rows).astype(np.float32), rng.rand(rows) < 0.2,
          rng.randint(0, 256, (rows,) + tuple(frame) + (3,)).astype(
              np.uint8),
          np.zeros((rows, 16), np.int32), *carry)


def _concurrent_requests(fn, requests):
  """Each thread's requests through `fn`, one thread per list; their
  answers, in order."""
  answers = [None] * len(requests)
  errors = []

  def run(i):
    try:
      answers[i] = [fn(*rows) for rows in requests[i]]
    except BaseException as e:  # re-raised below
      errors.append(e)

  threads = [threading.Thread(target=run, args=(i,))
             for i in range(len(requests))]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    raise errors[0]
  return answers


def _held_to_unbatched(name, answers, requests, reference):
  """Every caller's logits and baseline against the unbatched forward of
  its rows; the largest |difference|."""
  worst = 0.0
  for thread_answers, thread_requests in zip(answers, requests):
    for got, rows in zip(thread_answers, thread_requests):
      for a, b in zip(got, reference(*rows)):
        if a.shape != b.shape or not np.allclose(
            a, b, rtol=BATCHED_RTOL, atol=BATCHED_ATOL):
          raise AssertionError(f'{name}: batched {a} against unbatched {b}')
        worst = max(worst, float(np.abs(a - b).max()))
  return worst


def _batch_fn_check(agent):
  """batch_fn_with_options over the full-width agent (see above)."""
  sizes, times = [], []
  batched = dynamic_batching.batch_fn_with_options(
      minimum_batch_size=BATCHED_MIN, timeout_ms=BATCHED_TIMEOUT_MS)(
          _t1_forward(agent, sizes, times))
  rng = np.random.RandomState(21)
  requests = [[_caller_rows(rng, FAMILY_FRAMES[0])
               for _ in range(BATCHED_ROUNDS)]
              for _ in range(BATCHED_CALLERS)]
  try:
    answers = _concurrent_requests(batched, requests)
  finally:
    batched.close()
  total = BATCHED_CALLERS * BATCHED_ROUNDS * BATCHED_ROWS
  if sum(sizes) != total or not max(sizes) > BATCHED_ROWS:
    raise AssertionError(f'batch_fn: merged batches {sizes} for {total} '
                         'rows')
  worst = _held_to_unbatched('batch_fn', answers, requests,
                             _t1_forward(agent))
  log(f'serving batch_fn: {BATCHED_CALLERS} threads x {BATCHED_ROUNDS} '
      f'calls of {BATCHED_ROWS} rows through batch_fn_with_options('
      f'minimum_batch_size={BATCHED_MIN}, timeout_ms={BATCHED_TIMEOUT_MS}) '
      f'around the full-width T=1 forward: {len(sizes)} merged calls, mean '
      f'merged batch {total / len(sizes):.2f} rows (max {max(sizes)}), '
      f'{1e6 * statistics.median(times):.1f} us per merged call (median; '
      f'host to card and back included); max |batched - unbatched| of '
      f'logits and baseline {worst:.3e} (rtol {BATCHED_RTOL} / atol '
      f'{BATCHED_ATOL}, float32, TF32 off)')


def _family_batcher_check(config):
  """FamilyBatcher over two frame shapes, each family's agent built on
  the card by make_fn; outputs against each family's unbatched forward,
  padding_stats against the counts the request stream implies."""
  agents, sizes, times = {}, [], []

  def make_fn(key):
    height, width, _ = key[3][1]  # the frame tensor's trailing shape
    agents[(height, width)] = _seeded_agent(
        dataclasses.replace(config, height=height, width=width), 'cuda')
    return _t1_forward(agents[(height, width)], sizes, times)

  batcher = dynamic_batching.FamilyBatcher(
      make_fn, minimum_batch_size=BATCHED_MIN // 2,
      timeout_ms=BATCHED_TIMEOUT_MS)
  rng = np.random.RandomState(22)
  frames = [FAMILY_FRAMES[i % 2] for i in range(BATCHED_CALLERS)]
  requests = [[_caller_rows(rng, frame) for _ in range(BATCHED_ROUNDS)]
              for frame in frames]
  try:
    answers = _concurrent_requests(batcher, requests)
    stats = batcher.padding_stats()
  finally:
    batcher.close()
  worst = 0.0
  for frame in FAMILY_FRAMES:
    mine = [i for i, f in enumerate(frames) if f == frame]
    worst = max(worst, _held_to_unbatched(
        f'FamilyBatcher {frame}', [answers[i] for i in mine],
        [requests[i] for i in mine], _t1_forward(agents[frame])))
  # The stream's own accounting: rows per family times its row bytes,
  # against every row padded to the widest family.
  row_bytes = {f: sum(a[:1].nbytes for a in _caller_rows(rng, f, rows=1))
               for f in FAMILY_FRAMES}
  rows = {f: frames.count(f) * BATCHED_ROUNDS * BATCHED_ROWS
          for f in FAMILY_FRAMES}
  useful = float(sum(rows[f] * row_bytes[f] for f in FAMILY_FRAMES))
  widest = float(sum(rows.values()) * max(row_bytes.values()))
  want = dict(families=2, rows=float(sum(rows.values())),
              useful_bytes=useful, bucketed_bytes=useful,
              max_shape_bytes=widest,
              waste_ratio=(widest - useful) / widest)
  if any(stats[k] != v for k, v in want.items()) or sorted(agents) != sorted(
      FAMILY_FRAMES):
    raise AssertionError(f'FamilyBatcher: padding_stats {stats}, the '
                         f'stream {want}; families built {sorted(agents)}')
  log(f'serving FamilyBatcher: {BATCHED_CALLERS} threads over frames '
      f'{list(FAMILY_FRAMES)} (one agent built on the card per family): '
      f'{len(sizes)} merged calls, mean merged batch '
      f'{sum(sizes) / len(sizes):.2f} rows, '
      f'{1e6 * statistics.median(times):.1f} us per merged call (median); '
      f'max |batched - unbatched| {worst:.3e} (rtol {BATCHED_RTOL} / atol '
      f'{BATCHED_ATOL}); padding_stats equal to the stream\'s counts: rows '
      f'{stats["rows"]:.0f}, useful {stats["useful_bytes"]:.0f} bytes '
      f'against {stats["max_shape_bytes"]:.0f} padded to the widest family '
      f'(waste ratio {stats["waste_ratio"]:.4f})')


def phase_serving():
  """The version table on the card at the slice's widths: 3 resident
  versions, 5 publishes with version 1 pinned (LRU eviction keeps it); A/B
  0.25 and shadow 0.25 over 32 callers (serve counts per version, shadow
  divergence 0 for equal params and > 0 for perturbed ones); int8
  resident bytes against float32, the int8 version's logits equal to a
  float32 server's on the dequantized params (float32 rounding), != the
  float32 version's and within the first-order bound the per-tensor
  max_abs_error gives, greedy agreement; serving_aot: a flip to the int8
  structure serves with aot_misses == 0."""
  from scalable_agent_tpu_torch.runtime import codec
  config = Config(**FLEET)
  agent = driver.build_agent(config, SLICE['num_actions'])
  params = {k: v.cuda() for k, v in init_params(
      agent, torch.Generator().manual_seed(config.seed)).items()}
  perturbed = {k: v + 0.05 * torch.randn(v.shape, device='cuda',
                                         generator=torch.Generator(
                                             'cuda').manual_seed(1))
               for k, v in params.items()}
  calls = _reference_callers(FLEET['num_actors'], config, seed=11)
  obs = {'frame': (config.height, config.width, 3), 'instr_len': 16}
  server = _serving_server(agent, params, serving_resident_versions=3)
  try:
    for version in range(1, SERVING_VERSIONS + 1):
      server.update_params(params, version=version)
      if version == 1:
        server.pin_version(1)
    labels = [label for label, _, _, _ in server.resident_versions()]
    evictions = server.stats()['evictions']
    if labels != [1, SERVING_VERSIONS - 1, SERVING_VERSIONS]:
      raise AssertionError(f'serving: resident {labels}')
    server.set_ab(None, 0.25)
    server.set_shadow(None, 0.25)
    for _ in range(SERVING_ROUNDS):
      _serve(server, calls)
    equal = server.stats()
    server.update_params(perturbed, version=SERVING_VERSIONS + 1)
    # Shadow: the newest non-live resident (the unperturbed params).
    server.set_shadow(None, 1.0)
    for _ in range(SERVING_ROUNDS):
      _serve(server, calls)
    moved = server.stats()
  finally:
    server.close()
  if not (equal['shadow_calls'] > 0 and equal['shadow_divergence'] == 0.0
          and equal['ab_calls'] > 0 and moved['shadow_divergence'] > 0.0):
    raise AssertionError(f'serving: A/B and shadow {equal}, {moved}')
  log(f'serving: resident {labels} after {SERVING_VERSIONS} publishes '
      f'({evictions} evictions, version 1 pinned); A/B 0.25 and shadow 0.25 '
      f'over {SERVING_ROUNDS} merged calls: serve counts '
      f'{equal["serve_counts"]}, ab_calls {equal["ab_calls"]}, shadow calls '
      f'{equal["shadow_calls"]} divergence {equal["shadow_divergence"]}; '
      f'perturbed live (0.05 normal noise) against the unperturbed '
      f'shadow: divergence {moved["shadow_divergence"]} over '
      f'{moved["shadow_calls"] - equal["shadow_calls"]} calls')
  quantized = codec.quantize(params)
  f32 = _serving_server(agent, params)
  int8 = _serving_server(agent, params, publish_codec='int8',
                         serving_aot=True)
  deq = _serving_server(agent, codec.dequantize_tree(quantized))
  try:
    int8.warmup(obs, max_size=FLEET['num_actors'])
    int8.update_params(params, version=1)
    f32_out = _serve(f32, calls)
    int8_out = _serve(int8, calls)
    deq_out = _serve(deq, calls)
    int8.update_params(params, version=2)
    _serve(int8, calls)
    stats8, stats32 = int8.stats(), f32.stats()
  finally:
    f32.close()
    int8.close()
    deq.close()
  ratio = codec.tree_nbytes(quantized) / codec.tree_nbytes(params)
  resident = stats8['resident_bytes'] / stats32['resident_bytes']
  got = np.stack([o.policy_logits for o, _ in int8_out])
  ref = np.stack([o.policy_logits for o, _ in f32_out])
  plain = np.stack([o.policy_logits for o, _ in deq_out])
  bound = _logits_bound(driver.build_agent(config, SLICE['num_actions']),
                        params, quantized, calls)
  diff = np.abs(got - ref)
  # The int8 entry's forward against a float32 server holding the
  # dequantized params: the same arithmetic, so float32 rounding
  # (rtol 1e-5 / atol 1e-5); and it must differ from the float32 params'
  # (a forward that fell back to them would give 0).
  plain_diff = np.abs(got - plain)
  agreement = codec.greedy_agreement(got, ref)
  if not (np.allclose(got, plain, rtol=1e-5, atol=1e-5)
          and diff.max() > 0 and np.all(diff <= bound)
          and 0.2 < ratio < 0.3
          and stats8['aot_misses'] == 0 and stats8['aot_compiled'] >= 2):
    raise AssertionError(f'serving int8: ratio {ratio}, max diff '
                         f'{diff.max()}, against the dequantized params '
                         f'{plain_diff.max()}, bound min {bound.min()}, '
                         f'{stats8}')
  log(f'serving int8: resident bytes per version {stats8["resident_bytes"]} '
      f'against float32 {stats32["resident_bytes"]} ({resident:.4f}; the '
      f'params alone {ratio:.4f}); max |logits int8 - float32 server on '
      f'the dequantized params| {plain_diff.max():.3e} (rtol 1e-5 / atol '
      f'1e-5); max |logits int8 - float32| '
      f'{diff.max():.3e} (> 0), at most {float((diff / bound).max()):.4f} of '
      f'its first-order bound (bound {bound.min():.3e}..{bound.max():.3e}); '
      f'greedy agreement {agreement:.4f} over {len(calls)} callers; '
      f'serving_aot: aot_misses {stats8["aot_misses"]}, warmed pairs '
      f'{stats8["aot_compiled"]}')
  card_agent = _seeded_agent(config, 'cuda').eval()
  _batch_fn_check(card_agent)
  _family_batcher_check(config)


# Routed serving: two in-process replicas at the fleet's widths, each an
# ingest listener answering 'infer' with its own InferenceServer on the
# card, behind one ServingRouter; batches of ROUTED_BATCH rows (the bucket
# each server warms, so no routed call pays a first-use set-up), replica 0
# closed without a 'bye' before batch ROUTED_KILL_AT.
ROUTED_BATCH = 32
ROUTED_BATCHES = 24
ROUTED_KILL_AT = 10
# The pump goes on past ROUTED_BATCHES until the router has picked the
# closed replica once (a failover): a slow first reply can leave it at
# the floor weight, 1/11 of the picks.
ROUTED_MAX_BATCHES = 48
# The batches held against the CPU's forward: both replicas before the
# kill, the survivor after it.
ROUTED_CHECKED = (0, 1, 2, 3, 10, 11, 22, 23)


def _routed_payloads(config, hidden, count):
  rng = np.random.RandomState(7)
  b = ROUTED_BATCH
  return [{
      'prev_action': rng.randint(0, config.num_actions, b).astype(np.int32),
      'reward': rng.randn(b).astype(np.float32),
      'done': rng.rand(b) < 0.2,
      'frame': rng.randint(0, 256, (b, config.height, config.width,
                                    3)).astype(np.uint8),
      'instr': np.zeros((b, 16), np.int32),
      'core_c': (rng.randn(b, hidden) * 0.3).astype(np.float32),
      'core_h': (rng.randn(b, hidden) * 0.3).astype(np.float32),
  } for _ in range(count)]


def _serves(router):
  return {r['address']: r['serves'] for r in router.stats()['replicas']}


def _routed_pump(router, payloads, replicas, evaluator):
  """Pump payloads through the router, closing replica 0's ingest
  without a 'bye' before batch ROUTED_KILL_AT, ROUTED_BATCHES of them and
  then on until the router failed over; returns (results, the address
  that served each, the serve counts at the kill, the
  NoReplicasAvailable count after it, the routed ms per batch)."""
  results, served_by, starved, ms = [], [], 0, []
  at_kill = None
  for i, payload in enumerate(payloads):
    if i >= ROUTED_BATCHES and router.stats()['route_failovers']:
      break
    if i == ROUTED_KILL_AT:
      at_kill = _serves(router)
      replicas[0][1].close(graceful=False)
    before = _serves(router)
    t = time.perf_counter()
    try:
      result, _ = router.infer(payload)
    except routing.NoReplicasAvailable:
      starved += 1
      results.append(None)
      served_by.append(None)
      continue
    ms.append(1e3 * (time.perf_counter() - t))
    after = _serves(router)
    results.append(result)
    served_by.append(next(a for a in after if after[a] != before[a]))
    evaluator.observe(telemetry.registry().snapshot())
  return results, served_by, at_kill, starved, ms


def phase_routed_serving():
  """Routed serving at the deep agent's full width (72x96 frames, LSTM
  256), after JAX's routed drill (scripts/chaos.py run_routed_storm):
  two replicas serve before replica 0 is closed mid-pump without a 'bye';
  every later batch is served by the survivor (the router fails over once
  it picks the closed one, zero NoReplicasAvailable); the survivor's drain
  notice then takes it
  out of new picks; the routed results at ROUTED_CHECKED hold to the same
  params' forward on the CPU (rtol 1e-4 / atol 1e-5, fleet_reference's
  float32 bar); the routed-latency objective (serving/route_ms p99 <=
  5 s, JAX's drill's) and the default serving_latency_p99_ms, judged by
  the port's SloEvaluator over the pump, never burn. Returns the launch
  counts (the path runs no hand-written kernel)."""
  config = Config(**dict(FLEET, inference_timeout_ms=1))
  num_actions = SLICE['num_actions']
  agent = driver.build_agent(config, num_actions)
  params = init_params(agent, torch.Generator().manual_seed(config.seed))
  contract = remote.trajectory_contract(config, agent, num_actions)
  payloads = _routed_payloads(config, agent.hidden_size,
                              ROUTED_MAX_BATCHES + 2)
  obs_spec = {'frame': (config.height, config.width, 3), 'instr_len': 16}
  objectives = [
      slo.Objective(name='routed_latency_p99_ms', metric='serving/route_ms',
                    field='p99', comparison='<=', target=5000.0,
                    severity='ticket', fast_window_secs=2.0,
                    slow_window_secs=30.0),
      next(dataclasses.replace(o, fast_window_secs=2.0, slow_window_secs=30.0)
           for o in slo.DEFAULT_OBJECTIVES
           if o.name == 'serving_latency_p99_ms')]
  evaluator = slo.SloEvaluator(objectives)
  replicas, router = [], None
  t0 = time.perf_counter()

  def drive():
    nonlocal router
    for k in range(2):
      buffer = ring_buffer.TrajectoryBuffer(2)
      replicas.append([buffer, None, None])
      replicas[-1][1] = remote.TrajectoryIngestServer(
          buffer, driver.host_params(params), host='127.0.0.1',
          contract=contract)
      server = replicas[-1][2] = InferenceServer(
          agent, {n: v.to('cuda') for n, v in params.items()}, config,
          seed=10 + k, fleet_size=ROUTED_BATCH)
      server.warmup(obs_spec, sizes=[ROUTED_BATCH])
      replicas[-1][1].attach_serving(server.serve_remote)
    addresses = [f'127.0.0.1:{r[1].port}' for r in replicas]
    router = routing.ServingRouter(
        addresses, lambda a: routing.connect_serving(
            a, contract, connect_timeout_secs=30), probation_secs=600.0)
    evaluator.observe(telemetry.registry().snapshot())
    pumped = _routed_pump(router, payloads[:ROUTED_MAX_BATCHES], replicas,
                          evaluator)
    # The survivor's drain notice: its reply is valid, and no new pick
    # lands on it.
    replicas[1][1].set_draining()
    drained, _ = router.infer(payloads[ROUTED_MAX_BATCHES])
    refused = False
    try:
      router.infer(payloads[ROUTED_MAX_BATCHES + 1])
    except routing.NoReplicasAvailable:
      refused = True
    return addresses, pumped, drained, refused, router.stats()

  try:
    (addresses, (results, served_by, at_kill, starved, ms), drained, refused,
     stats), counts = _drive('routed_serving', drive)
  finally:
    if router is not None:
      router.close()
    for buffer, ingest, server in replicas:
      if ingest is not None:
        ingest.close(graceful=False)
      if server is not None:
        server.close()
      buffer.close()
  wall = time.perf_counter() - t0
  problems = []
  if not at_kill or not all(at_kill[a] > 0 for a in addresses):
    problems.append(f'a replica served nothing before the kill: {at_kill}')
  after = served_by[ROUTED_KILL_AT:]
  if starved or set(after) != {addresses[1]}:
    problems.append(f'{starved} NoReplicasAvailable after the kill; served '
                    f'by {after}')
  if stats['route_failovers'] < 1:
    problems.append(f'the kill took no failover: {stats}')
  by_addr = {r['address']: r for r in stats['replicas']}
  if not (by_addr[addresses[1]]['draining'] and stats['available'] == 0
          and refused and drained['logits'].shape == (ROUTED_BATCH,
                                                      num_actions)):
    problems.append(f'the drain notice did not empty the rotation: {stats}')
  if any(counts.values()):
    problems.append(f'routed serving launched kernels: {counts}')
  verdict = evaluator.verdict()
  if not verdict['pass'] or any(
      e['state'] != slo.OK for e in verdict['objectives'].values()):
    problems.append(f'routed SLO verdict {verdict}')
  if problems:
    raise AssertionError(f'routed_serving: {problems}')
  cpu = InferenceServer(agent, params, config, seed=1,
                        fleet_size=ROUTED_BATCH)
  err = 0.0
  try:
    for i in ROUTED_CHECKED + (ROUTED_MAX_BATCHES,):
      got = drained if i == ROUTED_MAX_BATCHES else results[i]
      ref = cpu.serve_remote(payloads[i])
      for key in ('logits', 'baseline', 'core_c', 'core_h'):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5,
                                   err_msg=f'routed batch {i} {key}')
        err = max(err, float(np.max(np.abs(got[key] - ref[key]))))
  finally:
    cpu.close()
  objective_values = {n: e['value'] for n, e in verdict['objectives'].items()}
  log(f'routed_serving: {len(results)} batches of {ROUTED_BATCH} at '
      f'{config.height}x{config.width} through 2 replicas in {wall:.1f} s '
      f'(set-up included, the CPU check not); served before the kill '
      f'{at_kill}, after it {len(after)} of {len(after)} by the survivor, '
      f'{stats["route_failovers"]} failover(s), {starved} '
      f'NoReplicasAvailable; the drain notice left {stats["available"]} '
      f'available; routed ms per batch p50 {statistics.median(ms):.2f} max '
      f'{max(ms):.2f} (wire both ways, the card\'s forward, host copies); '
      f'card vs CPU max |diff| {err:.3e} over {len(ROUTED_CHECKED) + 1} '
      f'batches; SLO {objective_values} (ok); launches {counts}')
  return counts


def phase_admission():
  """32 actors on ADMISSION_SLOTS slots. block: 32 threads acquire, step
  and release on a card server; all get a slot, none raises, half by
  handover. shed: driver.train with the arena short, a 0.05 s deadline
  and quarantine after 2 respawns, for ADMISSION_STEPS learner steps:
  sheds > 0, K1 once per step, the summaries hold inference_sheds. grow: the 17th acquire doubles the
  arena, and the 16 held slots' carries are bit-equal across the grow."""
  n = FLEET['num_actors']
  config = Config(**FLEET)
  agent = driver.build_agent(config, SLICE['num_actions'])
  params = {k: v.cuda() for k, v in init_params(
      agent, torch.Generator().manual_seed(config.seed)).items()}
  calls = _reference_callers(n, config, seed=2)
  kw = dict(inference_state_cache=True, inference_state_slots=ADMISSION_SLOTS,
            inference_min_batch=1, inference_timeout_ms=2)
  server = _serving_server(agent, params, **kw)
  errors = []

  def actor(i):
    try:
      handle = server.initial_core_state()
      for _ in range(3):
        server.policy(calls[i][0], calls[i][1], handle)
      handle.release()
    except Exception as e:  # the phase's failure
      errors.append(e)

  try:
    threads = [threading.Thread(target=actor, args=(i,)) for i in range(n)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
    block = server.stats()
  finally:
    server.close()
  if errors or block['acquires'] != n or block['admission_waits'] < n - (
      ADMISSION_SLOTS) or block['sheds'] or block['admission_timeouts']:
    raise AssertionError(f'admission block: {errors}, {block}')
  log(f'admission block: {n} actors on {ADMISSION_SLOTS} slots, '
      f'{block["admission_waits"]} parked and handed a released slot, no '
      f'raise; admission wait p99 not measured; calls {block["calls"]}')
  with tempfile.TemporaryDirectory(prefix='chip_smoke_shed_') as logdir:
    # The merge floor is the admitted actors', not the fleet's (AUTO, 32
    # here): with 16 of 32 actors shed, a floor of 32 holds every merged
    # call for inference_timeout_ms, and a learner step takes about ten
    # times as long as with the floor met.
    cfg = Config(**dict(FLEET, inference_state_cache=True,
                        inference_min_batch=ADMISSION_SLOTS,
                        inference_state_slots=ADMISSION_SLOTS,
                        inference_admission='shed',
                        inference_admission_timeout_secs=0.05,
                        fleet_quarantine_after=2),
                 logdir=logdir)
    # The shed actors are quarantined: the healthy fraction sits at 0.5,
    # and the grow rule proposes a bigger fleet (virtually).
    run, counts, step_ms, _ = _cache_run(
        'admission_shed', cfg, ADMISSION_STEPS,
        controller=CONTROLLER_ANYWHERE + ('fleet_healthy_fraction',))
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      sheds = [e['value'] for e in map(json.loads, f)
               if e['tag'] == 'inference_sheds']
  if not (run.stats['server']['sheds'] > 0 and sheds and sheds[-1] > 0):
    raise AssertionError(f'admission shed: {run.stats["server"]}, summaries '
                         f'{sheds}')
  log(f'admission shed: {run.stats["server"]["sheds"]} sheds over '
      f'{run.stats["server"]["acquires"]} acquires, summaries '
      f'inference_sheds {sheds}; {ADMISSION_STEPS} learner steps at '
      f'{step_ms:.2f} ms per step; vtrace launches {counts["vtrace"]}')
  server = _serving_server(agent, params, **dict(kw,
                                                 inference_admission='grow'))
  try:
    handles = [server.initial_core_state() for _ in range(ADMISSION_SLOTS)]
    _serve(server, [(a, e, h) for (a, e, _), h in zip(calls, handles)])
    before = [h.snapshot() for h in handles]
    extra = server.initial_core_state()
    after = [h.snapshot() for h in handles]
    grow = server.stats()
    extra.release()
  finally:
    server.close()
  same = all(np.array_equal(x, y) for b, a in zip(before, after)
             for x, y in zip(b, a))
  if not (grow['arena_grows'] >= 1 and same and
          grow['num_slots'] == 2 * ADMISSION_SLOTS):
    raise AssertionError(f'admission grow: carries kept {same}, {grow}')
  log(f'admission grow: arena {ADMISSION_SLOTS} -> {grow["num_slots"]} '
      f'slots ({grow["arena_grows"]} grow), {ADMISSION_SLOTS} carries '
      'bit-equal across it')
  return counts


def phase_mixed_fleet():
  """A mixed fleet (MIXED_FLEET: gridworld 2 : procgen 1, 4 actions,
  PopArt) of 32 process-hosted actors for 4 learner steps: the actor plan
  21/11, two PopArt slots, both tasks' episode curves, K1 once per
  step."""
  from scalable_agent_tpu_torch import population
  plan = population.plan_actor_assignment(
      population.parse_fleet_tasks(MIXED_FLEET['fleet_tasks']),
      MIXED_FLEET['num_actors'])
  if [plan.count(0), plan.count(1)] != [21, 11]:
    raise AssertionError(f'mixed_fleet: plan {plan}')
  with tempfile.TemporaryDirectory(prefix='chip_smoke_mixed_') as logdir:
    config = Config(**MIXED_FLEET, logdir=logdir)
    run, counts, step_ms, _ = _cache_run('mixed_fleet', config,
                                         MIXED_FLEET_STEPS)
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      tags = {e['tag'] for e in map(json.loads, f)}
  curves = sorted(t for t in tags if t.endswith('/episode_return'))
  if run.state.popart.mu.shape != (2,) or curves != [
      'gridworld/episode_return', 'procgen/episode_return']:
    raise AssertionError(f'mixed_fleet: PopArt {run.state.popart.mu.shape}, '
                         f'curves {curves}')
  log(f'mixed_fleet: plan 21/11 (gridworld/procgen), PopArt mu '
      f'{run.state.popart.mu.tolist()}, curves {curves}; {step_ms:.2f} ms '
      f'per learner step over steps {FLEET_TIMED_FROM + 1}-'
      f'{MIXED_FLEET_STEPS}, '
      f'{config.frames_per_step / step_ms * 1e3:.1f} env-frames/s; vtrace '
      f'launches {counts["vtrace"]}')
  return counts


# --- the telemetry plane and the lock-order runtime -----------------------

# The telemetry phase: the fleet phase's configuration, publishing every
# learner step so that a 3-step run has a policy lag to read, traced with
# the lock-order checker armed, alternated with untraced runs.
TELEMETRY_FLEET = dict(FLEET, publish_params_every=1)
TELEMETRY_PAIRS = 1
TELEMETRY_STEPS = 3
# The fault drill: an env_step crash in one actor early in the first
# unrolls, and the learner sleeping before steps 2 and 3. Before an
# actor's put blocks, the prefetcher's two staged batches, the batch it
# assembles and the buffer take 128 unrolls: 10-16 s of the 32 actors'
# output at the fleet's rate with its 100-step unrolls, so 12 s sleeps
# left buffer/put_waits at 0 on a slow host (and 2 s sleeps on any).
# Unrolls of 20 steps make those 128 unrolls 2-3.2 s of output, inside
# one 12 s sleep on a host twice as slow; the widths stay the fleet's.
FAULTS_FLEET = dict(FLEET, unroll_length=20)
FAULTS_FLEET_STEPS = 4
FAULTS_PLAN = dict(env_raise_at=500, slow_learner_at=1, slow_learner_len=2,
                   slow_learner_secs=12.0)
LOCK_BENCH_ACQUIRES = 200_000
_CLK_TCK = os.sysconf('SC_CLK_TCK') if hasattr(os, 'sysconf') else 100


def _cpu_secs(stat_path):
  """utime + stime of /proc/<...>/stat in seconds (None once gone)."""
  try:
    with open(stat_path) as f:
      fields = f.read().rsplit(')', 1)[1].split()
  except OSError:
    return None
  return (int(fields[11]) + int(fields[12])) / _CLK_TCK


def _thread_group(name):
  for prefix, group in (('actor-', 'actors'),
                        ('inference-dispatch', 'inference_dispatch'),
                        ('inference-completion', 'inference_completion'),
                        ('batch-prefetcher', 'prefetcher'),
                        ('MainThread', 'learner_main')):
    if name.startswith(prefix):
      return group
  return 'other_python'


def _host_cpu_sample():
  """CPU seconds so far of each thread of this process by group (Python
  threads by name through their native ids; the rest, such as torch's
  and the CUDA driver's threads, as native_other) and of the env
  processes (this process's multiprocessing children)."""
  by_tid = {t.native_id: _thread_group(t.name)
            for t in threading.enumerate() if t.native_id is not None}
  threads = {}
  for tid in os.listdir('/proc/self/task'):
    secs = _cpu_secs(f'/proc/self/task/{tid}/stat')
    if secs is not None:
      threads[int(tid)] = (by_tid.get(int(tid), 'native_other'), secs)
  children = {}
  for child in mp.active_children():
    secs = _cpu_secs(f'/proc/{child.pid}/stat')
    if secs is not None:
      children[child.pid] = secs
  return threads, children


def _host_cpu_split(first, last, steps):
  """CPU seconds per learner step by group between two samples, over the
  threads and processes present in both."""
  split = collections.Counter()
  for tid, (group, secs) in last[0].items():
    if tid in first[0]:
      split[group] += secs - first[0][tid][1]
  split['env_processes'] = sum(secs - first[1][pid]
                               for pid, secs in last[1].items()
                               if pid in first[1])
  return {g: round(s / steps, 4) for g, s in sorted(split.items())}


def _check_traces(name, logdir, run, steps):
  """The traced run's checks; returns (batch records, report summary)."""
  stats = run.stats['trace']
  if (stats['batches'] != steps or stats['untagged_unrolls'] or
      stats['dropped_records']):
    raise AssertionError(f'{name}: tracer stats {stats} over {steps} steps')
  with open(os.path.join(logdir, 'traces.jsonl')) as f:
    records = [json.loads(line) for line in f]
  batches = [r for r in records if r['k'] == 'batch']
  order = list(telemetry.HOP_ORDER)
  if [r['step'] for r in batches] != list(range(1, steps + 1)):
    raise AssertionError(f'{name}: batch records at steps '
                         f'{[r["step"] for r in batches]}')
  for r in batches:
    known = sum('bv' in s for s in r['spans'])
    if len(r['lag']) != known or len(r['spans']) != r['n_fresh']:
      raise AssertionError(f'{name}: step {r["step"]}: {len(r["lag"])} lag '
                           f'entries for {known} known versions')
    for span in r['spans']:
      hops = [h for h, _ in span['h']]
      times = [t for _, t in span['h']]
      if (hops != ['done', 'staged', 'serve', 'step'] or
          [order.index(h) for h in hops] != sorted(map(order.index, hops))
          or times != sorted(times)):
        raise AssertionError(f'{name}: span {span}')
  summary = trace_report.summarize(trace_report.load_traces(logdir))
  if summary['batches'] != steps:
    raise AssertionError(f'{name}: trace_report read {summary["batches"]} '
                         'batches')
  # The operator's CLI on the same file: exit 0 and the same count in
  # its JSON (its text report goes to a buffer, not this log).
  out = os.path.join(logdir, 'trace_report.json')
  with contextlib.redirect_stdout(io.StringIO()) as text:
    rc = trace_report.main([logdir, '--json', out])
  with open(out) as f:
    cli = json.load(f)
  if rc != 0 or cli['batches'] != steps or 'policy lag' not in text.getvalue():
    raise AssertionError(f'{name}: trace_report CLI exit {rc}, '
                         f'{cli["batches"]} batches in its JSON')
  _check_tensorboard(name, logdir, summary)
  return batches, summary


def _check_tensorboard(name, logdir, summary):
  """The port's to_tensorboard over the traced run's logdir, read back
  with TensorBoard's EventAccumulator: the train run holds every tag of
  summaries.jsonl, the trace run the lag, e2e and one tag per hop that
  trace_report read."""
  from tensorboard.backend.event_processing import event_accumulator
  t0 = time.perf_counter()
  written = to_tensorboard.convert(logdir)
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    summary_tags = {json.loads(line)['tag'] for line in f}
  trace_tags = {'trace/hop_{}_{}_ms'.format(*row['hop'].split('->'))
                for row in summary['hops']}
  if summary['policy_lag']['histogram']:
    trace_tags |= {'trace/policy_lag_mean', 'trace/policy_lag_max'}
  if summary['e2e_ms']['count']:
    trace_tags.add('trace/e2e_ms')
  expect = {'train': summary_tags, 'trace': trace_tags}
  tags = {}
  for run in expect:
    acc = event_accumulator.EventAccumulator(
        os.path.join(logdir, 'tb', run),
        size_guidance={event_accumulator.SCALARS: 0,
                       event_accumulator.HISTOGRAMS: 0})
    acc.Reload()
    tags[run] = set(acc.Tags()['scalars']) | set(acc.Tags()['histograms'])
  if tags != expect or not all(written.get(run) for run in expect):
    raise AssertionError(f'{name}: to_tensorboard wrote {written}; tags '
                         f'{tags}, expected {expect}')
  log(f'{name}: to_tensorboard wrote {written} events in '
      f'{time.perf_counter() - t0:.2f} s; read back: {len(tags["train"])} '
      f'train tags, {len(tags["trace"])} trace tags')


def _tracer_cost(unrolls, batches, batch_size):
  """The tracer's own host cost, replayed on a run's record counts:
  microseconds per unroll of begin_unroll_trace + stamp + tag_unroll +
  pop_unroll (the actor's and the prefetcher's per-unroll calls), and
  milliseconds per batch of on_step (its spans completed, its record
  written) after on_batch and on_serve."""
  with tempfile.TemporaryDirectory(prefix='chip_smoke_tracer_') as logdir:
    tracer = telemetry.PipelineTracer(logdir)
    telemetry.set_tracer(tracer)
    try:
      keys = [object() for _ in range(max(unrolls, 1))]
      t0 = time.perf_counter()
      for i, key in enumerate(keys):
        trace = telemetry.begin_unroll_trace('actor-0', i)
        telemetry.stamp(trace, telemetry.HOP_DONE)
        telemetry.tag_unroll(key, trace)
        telemetry.pop_unroll(key)
      per_unroll_us = 1e6 * (time.perf_counter() - t0) / len(keys)
      step_s = 0.0
      for b in range(max(batches, 1)):
        batch = [object() for _ in range(batch_size)]
        for i, key in enumerate(batch):
          trace = telemetry.begin_unroll_trace(f'actor-{i}', b)
          telemetry.stamp(trace, telemetry.HOP_DONE)
          telemetry.tag_unroll(key, trace)
        tracer.on_batch(batch, batch_size)
        tracer.on_serve()
        t0 = time.perf_counter()
        tracer.on_step(b + 1)
        step_s += time.perf_counter() - t0
      return per_unroll_us, 1e3 * step_s / max(batches, 1)
    finally:
      telemetry.set_tracer(None)
      tracer.close()


def _lock_bench():
  """Microseconds per acquire + release of a plain lock and of an
  OrderedLock, with nothing held and with one ordered lock held (the
  edge's fast path)."""
  plain = threading.Lock()
  outer = lock_check.OrderedLock('chip_smoke.bench_outer')
  inner = lock_check.OrderedLock('chip_smoke.bench_inner')

  def us(lock):
    t0 = time.perf_counter()
    for _ in range(LOCK_BENCH_ACQUIRES):
      lock.acquire()
      lock.release()
    return 1e6 * (time.perf_counter() - t0) / LOCK_BENCH_ACQUIRES

  out = {'plain_us': us(plain), 'ordered_us': us(inner)}
  with outer:
    out['ordered_held_us'] = us(inner)
  lock_check.reset()
  return out


def _telemetry_run(name, traced, steps=TELEMETRY_STEPS):
  """One fleet run of the fleet phase's config: traced with the lock
  check armed, or untraced and unarmed (chip_smoke disarms after each
  armed run: arming is one-way in the driver). Returns (run, counts,
  ms per learner step over steps 2..steps, host split per step,
  acquires per step, batch records and report summary or None)."""
  times, samples, acquires = {}, {}, {}
  counter = itertools.count()
  plain_acquire = lock_check.OrderedLock.acquire

  def counting_acquire(self, blocking=True, timeout=-1):
    next(counter)
    return plain_acquire(self, blocking, timeout)

  def on_step(run, step, metrics):
    if step in (1, steps):
      torch.cuda.synchronize()
      times[step] = time.perf_counter()
      samples[step] = _host_cpu_sample()
      acquires[step] = next(counter)

  lock_check.reset()
  with tempfile.TemporaryDirectory(prefix='chip_smoke_telemetry_') as logdir:
    config = Config(**TELEMETRY_FLEET, logdir=logdir,
                    telemetry_trace=traced, lock_order_check=traced)
    lock_check.OrderedLock.acquire = counting_acquire
    try:
      run, counts = _drive(name, lambda: driver.train(
          config, max_steps=steps, device='cuda', stall_timeout_secs=300,
          on_step=on_step))
    finally:
      lock_check.OrderedLock.acquire = plain_acquire
      lock_check.arm(False)
    if run.state.update_steps != steps or counts['vtrace'] != steps:
      raise AssertionError(f'{name}: {run.state.update_steps} steps, '
                           f'launches {counts}')
    traces = _check_traces(name, logdir, run, steps) if traced else None
    log(f'{name}: {_controller_logs(name, logdir)}')
  if traced:
    cycles = telemetry.registry().get('analysis/lock_cycles')
    if lock_check.cycles_detected() or cycles is None or cycles.value:
      raise AssertionError(f'{name}: lock-order cycles '
                           f'{lock_check.cycle_reports()}')
  elif run.tracer is not None:
    raise AssertionError(f'{name}: a tracer ran with telemetry_trace off')
  timed = steps - 1
  ms = 1e3 * (times[steps] - times[1]) / timed
  split = _host_cpu_split(samples[1], samples[steps], timed)
  return run, counts, ms, split, (acquires[steps] - acquires[1]) / timed, traces


def phase_telemetry_fleet():
  """The telemetry plane on the fleet phase's configuration (see the
  module docstring): TELEMETRY_PAIRS pairs of TELEMETRY_STEPS-step runs,
  traced (telemetry_trace, lock_order_check) then untraced, in one
  process; returns the K1 launches summed over the runs."""
  counts = dict.fromkeys(COUNTERS, 0)
  rows = []
  for pair in range(TELEMETRY_PAIRS):
    for traced in (True, False):
      name = f'telemetry_fleet_pair{pair + 1}_{"traced" if traced else "untraced"}'
      run, run_counts, ms, split, acquires, traces = _telemetry_run(
          name, traced)
      counts = {c: counts[c] + run_counts[c] for c in counts}
      rows.append((pair, traced, ms))
      log(f'{name}: {ms:.2f} ms per learner step over steps 2-'
          f'{TELEMETRY_STEPS}; host CPU seconds per learner step by thread '
          f'group (/proc, steps 2-{TELEMETRY_STEPS}): {split} (sum '
          f'{sum(split.values()):.4f} s against {ms / 1e3:.4f} s of wall); '
          f'ordered-lock acquires per learner step {acquires:.0f}')
      if not traced:
        continue
      batches, summary = traces
      hops = {row['hop']: (row['count'], row['p50_ms'], row['p99_ms'])
              for row in summary['hops']}
      lag = summary['policy_lag']
      log(f'{name}: traces.jsonl {len(batches)} batch records, '
          f'{sum(len(b["spans"]) for b in batches)} spans, untagged 0, '
          f'dropped 0, lock-order cycles 0; per-hop (count, p50 ms, p99 ms) '
          f'by the port\'s trace_report: {hops}; policy lag histogram '
          f'{lag["histogram"]} (p50 {lag.get("p50")}, p99 {lag.get("p99")})')
      unroll_us, step_ms = _tracer_cost(run.stats['trace']['unrolls'],
                                        run.stats['trace']['batches'],
                                        run.config.batch_size)
      per_step_ms = unroll_us * run.config.batch_size / 1e3 + step_ms
      log(f'{name}: tracer host cost replayed on the run\'s '
          f'{run.stats["trace"]["unrolls"]} unrolls and '
          f'{run.stats["trace"]["batches"]} batches: {unroll_us:.3f} us per '
          f'unroll (begin_unroll_trace + stamp + tag_unroll + pop_unroll), '
          f'{step_ms:.4f} ms per batch (on_step); {per_step_ms:.4f} ms per '
          f'learner step of {run.config.batch_size} unrolls = '
          f'{per_step_ms / ms:.6f} of the step')
      if pair == 0:
        bench = _lock_bench()
        extra_ms = acquires * (bench['ordered_held_us'] -
                               bench['plain_us']) / 1e3
        log(f'{name}: lock bench over {LOCK_BENCH_ACQUIRES} acquires: plain '
            f'{bench["plain_us"]:.3f} us, ordered {bench["ordered_us"]:.3f} '
            f'us, ordered with one lock held {bench["ordered_held_us"]:.3f} '
            f'us; x {acquires:.0f} acquires per step = {extra_ms:.3f} ms per '
            f'learner step = {extra_ms / ms:.6f} of the step')
  ratios = [next(r[2] for r in rows if r[0] == p and r[1]) /
            next(r[2] for r in rows if r[0] == p and not r[1])
            for p in range(TELEMETRY_PAIRS)]
  log(f'telemetry_fleet: ms per learner step traced / untraced by pair: '
      f'{[round(r, 4) for r in ratios]} '
      f'({[(p + 1, "traced" if t else "untraced", round(m, 2)) for p, t, m in rows]})')
  return counts


def phase_faults_fleet():
  """The two fault sites that need no transport on one short fleet run
  at the fleet phase's widths (20-step unrolls, FAULTS_FLEET): an
  env_step 'raise' crashes one actor,
  which the fleet respawns (an actors_respawned incident) and which
  rejoins; slow_learner 'hang's 12 s before learner steps 2 and 3, the
  buffer fills and buffer/put_waits rises in the registry snapshot; the
  run completes its steps. Prints the incident lines both faults wrote.
  Returns the run's launch counts."""
  snapshots, slots = {}, []

  def on_step(run, step, metrics):
    snapshots[step] = (time.perf_counter(),
                       telemetry.registry().snapshot()['buffer/put_waits'])
    if step == FAULTS_FLEET_STEPS:
      # (slot, respawns, respawns since its last completed unroll).
      slots.extend((s.index, s.respawns, s.respawn_streak)
                   for s in run.fleet._slots if s.respawns)

  with tempfile.TemporaryDirectory(prefix='chip_smoke_faults_') as logdir:
    config = Config(**FAULTS_FLEET, logdir=logdir)
    faults.install(faults.FaultPlan.storm(seed=0, **FAULTS_PLAN))
    try:
      run, counts = _drive('faults_fleet', lambda: driver.train(
          config, max_steps=FAULTS_FLEET_STEPS, device='cuda',
          stall_timeout_secs=300, on_step=on_step))
      fired = faults.active().stats()
    finally:
      faults.clear()
    with open(os.path.join(logdir, 'incidents.jsonl')) as f:
      incidents = [json.loads(line) for line in f]
    controller_line = _controller_logs('faults_fleet', logdir)
    report = trace_report.summarize(trace_report.load_traces(logdir),
                                    trace_report.load_incidents(logdir))
  fleet = run.stats['fleet']
  respawned = [e for e in incidents if e['kind'] == 'actors_respawned']
  slow = [e for e in incidents if e['kind'] == 'fault_slow_learner']
  if (run.state.update_steps != FAULTS_FLEET_STEPS or
      counts['vtrace'] != FAULTS_FLEET_STEPS):
    raise AssertionError(f'faults_fleet: {run.state.update_steps} steps, '
                         f'launches {counts}')
  if (fired['env_step']['fired'] != 1 or fleet['respawns'] != 1 or
      len(respawned) != 1 or not any('InjectedFault' in e for e in
                                     respawned[0]['errors'])):
    raise AssertionError(f'faults_fleet: env_step {fired["env_step"]}, '
                         f'fleet {fleet}, incidents {respawned}')
  if (fleet['healthy'] != config.num_actors or
      [(i, n) for i, n, _ in slots] != [(respawned[0]['slots'][0], 1)] or
      slots[0][2] != 0):
    raise AssertionError(f'faults_fleet: the respawned actor did not '
                         f'rejoin with a completed unroll: {slots}, {fleet}')
  if [e['step'] for e in slow] != [2, 3] or fired['slow_learner'][
      'fired'] != 2:
    raise AssertionError(f'faults_fleet: slow_learner incidents {slow}')
  slept = [snapshots[s][0] - snapshots[s - 1][0] for s in (2, 3)]
  waits = [snapshots[s][1] for s in sorted(snapshots)]
  if min(slept) < FAULTS_PLAN['slow_learner_secs'] or not (
      waits[2] > waits[0]):
    raise AssertionError(f'faults_fleet: steps 2-3 took {slept} s, '
                         f'buffer/put_waits by step {waits}')
  marked = collections.Counter(e['kind'] for e in report['incidents'])
  if (report['batches'] != FAULTS_FLEET_STEPS or
      marked['actors_respawned'] != 1 or marked['fault_slow_learner'] != 2):
    raise AssertionError(f'faults_fleet: trace_report read '
                         f'{report["batches"]} batches, incidents {marked}')
  for e in respawned + slow:
    log(f'faults_fleet incident: {json.dumps(e)}')
  log(f'faults_fleet: {FAULTS_FLEET_STEPS} learner steps, vtrace launches '
      f'{counts["vtrace"]}; env_step {fired["env_step"]}, slow_learner '
      f'{fired["slow_learner"]}; steps 2 and 3 took '
      f'{[round(s, 3) for s in slept]} s; buffer/put_waits by step {waits}; '
      f'the respawned slot (index, respawns, streak) {slots} completed an '
      f'unroll after its respawn; fleet {fleet}; trace_report: '
      f'{report["batches"]} batches, {report["unrolls"]} unrolls, timeline '
      f'{report["timeline"]} with incidents {dict(marked)}; {controller_line}')
  return counts


# Remote actors: the learner with no local fleet, fed over TCP by actor-
# host processes of the CLI (--job_name=actor), each with its own envs
# and inference on the card. It publishes at step 3 (the fleet phase's
# cadence), so no host is mid-fetch of a blob when the learner closes: a
# subscriber mid-reply gets no 'bye' (the JAX package's param lane
# behaves alike) and would wait out its reconnect window.
REMOTE_FLEET = dict(FLEET, num_actors=0)
REMOTE_FLEET_STEPS = 4
REMOTE_HOSTS = 2
REMOTE_HOST_ACTORS = 16
REMOTE_PUBLISH_REPS = 3
# The drill: one actor host feeds a learner CLI that crashes, then the
# learner restarted on the same port from its checkpoint.
REMOTE_FAULTS = dict(FLEET, num_actors=0, publish_params_every=1,
                     checkpoint_secs=0, remote_publish_secs=0.0)
# learner_crash at the 5th consumed batch, after steps 1-4 (the
# checkpointer's clock starts at its first check, so step 2 is the first
# step saved, step 4 the last), and every one of the first learner's 4
# publishes corrupt: up to 3 batches are staged ahead of a step, so the
# host acks unrolls of a corrupt version before the crash whatever the
# staging (a page burn's profiler capture before step 1 lets all 3 stage,
# and then steps 1-3 take no unroll acked after the first publish).
REMOTE_FAULTS_CRASH = 4
REMOTE_FAULTS_PLAN = dict(wire_bitflip=[0], publish_corrupt_at=1,
                          publish_corrupt_len=REMOTE_FAULTS_CRASH,
                          learner_crash_at=REMOTE_FAULTS_CRASH)
REMOTE_FAULTS_STEPS = REMOTE_FAULTS_CRASH + 1  # the restarted one's budget
# The CLI with the fault plan of SA_FAULT_PLAN installed first.
_CLI_WITH_PLAN = ('import sys; from scalable_agent_tpu_torch.runtime '
                  'import faults; faults.install_from_env(); from '
                  'scalable_agent_tpu_torch import experiment; '
                  'experiment.main(sys.argv[1:])')


def _flags(config_dict):
  return [f'--{field}={value}' for field, value in config_dict.items()]


def _actor_host(port, task, num_actors, logdir, plan=None, reconnect=None):
  """An actor-host CLI process on the card, its output in a file;
  returns (Popen, the file's path)."""
  env = dict(os.environ)
  env.pop(faults.PLAN_ENV_VAR, None)
  # faulthandler: a host that stalls gets SIGABRT before it is killed
  # (_finish_hosts), and writes every thread's stack into its log.
  head = [sys.executable, '-X', 'faulthandler', '-m',
          'scalable_agent_tpu_torch.experiment']
  if plan is not None:
    env[faults.PLAN_ENV_VAR] = plan.to_json()
    head = [sys.executable, '-X', 'faulthandler', '-c', _CLI_WITH_PLAN]
  flags = dict(FLEET, num_actors=num_actors)
  if reconnect is not None:
    flags['actor_reconnect_secs'] = reconnect
  cmd = head + ['--job_name=actor', f'--task={task}',
                f'--learner_address=127.0.0.1:{port}',
                f'--logdir={logdir}/actor{task}'] + _flags(flags)
  path = os.path.join(logdir, f'actor{task}.log')
  with open(path, 'w') as out:
    proc = subprocess.Popen(cmd, stdout=out, stderr=out, text=True, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
  return proc, path


def _finish_hosts(hosts, name, timeout=60):
  """Wait for every actor host to exit 0; raise otherwise. A host still
  running after `timeout` gets SIGABRT first (faulthandler writes its
  threads' stacks into its log), then a kill. Returns their logs."""
  logs, failed = [], []
  for proc, path in hosts:
    try:
      proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
      log(f'{name}: actor host {path} still running after {timeout} s: '
          'SIGABRT for its stacks')
      proc.send_signal(signal.SIGABRT)
      try:
        proc.wait(timeout=10)
      except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(path) as f:
      logs.append(f.read())
    if proc.returncode != 0:
      failed.append((proc.returncode, logs[-1][-6000:]))
  if failed:
    raise RuntimeError(f'{name}: actor host(s) failed: {failed}')
  return logs


def _summary_values(logdir, tag):
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    return [(e['step'], e['value']) for e in map(json.loads, f)
            if e.get('tag') == tag]


def phase_remote_fleet():
  """The remote actors' main path at full width: driver.train with no
  local fleet fed by REMOTE_HOSTS actor-host CLI processes of
  REMOTE_HOST_ACTORS process-hosted actors each (see the module
  docstring). Returns the learner's launch counts."""
  port = _free_port()
  with tempfile.TemporaryDirectory(prefix='chip_smoke_remote_') as logdir:
    config = Config(**REMOTE_FLEET, logdir=logdir, remote_actor_port=port)
    profiler = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    window, unrolls, stats_line = [], {}, []

    def on_step(run, step, metrics):
      unrolls[step] = (time.perf_counter(), run.ingest.stats()['unrolls'])
      if step == 1:
        torch.cuda.synchronize()
        _start_own_profiler(profiler, 'remote_fleet')
        window.append(time.perf_counter())
      elif step == REMOTE_FLEET_STEPS:
        torch.cuda.synchronize()
        window.append(time.perf_counter())
        profiler.stop()
        # fleet_stats against the live ingest, after the timed window and
        # before the ingest closes at the loop's end.
        stats_line.append(_fleet_stats_against_fetch(port))

    hosts = [_actor_host(port, task, REMOTE_HOST_ACTORS, logdir)
             for task in range(REMOTE_HOSTS)]
    try:
      torch.cuda.reset_peak_memory_stats()
      t0 = time.perf_counter()
      run, counts = _drive('remote_fleet', lambda: driver.train(
          config, max_steps=REMOTE_FLEET_STEPS, device='cuda',
          stall_timeout_secs=300, on_step=on_step))
      wall = time.perf_counter() - t0
      peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
      host_logs = _finish_hosts(hosts, 'remote_fleet')
    with open(os.path.join(logdir, 'traces.jsonl')) as f:
      remote_publishes = [r['rv'] for r in map(json.loads, f)
                          if r.get('k') == 'publish' and 'rv' in r]
    losses = [v for _, v in _summary_values(logdir, 'total_loss')]
    verdict = _slo_verdict('remote_fleet', logdir)
    controller_line = _controller_logs('remote_fleet', logdir)
  ingest = run.stats['ingest']
  if (run.state.update_steps != REMOTE_FLEET_STEPS
      or counts['vtrace'] != REMOTE_FLEET_STEPS
      or not all(map(math.isfinite, losses))):
    raise AssertionError(f'remote_fleet: {run.state.update_steps} steps, '
                         f'launches {counts}, losses {losses}')
  if (ingest['unrolls'] < REMOTE_FLEET_STEPS * config.batch_size
      or run.stats['fleet']['unrolls'] != 0):
    raise AssertionError(f'remote_fleet: not every unroll came over the '
                         f'wire: ingest {ingest}, fleet {run.stats["fleet"]}')
  bad = {k: ingest[k] for k in ('wire_crc_rejected', 'stale_epoch_rejected',
                                'discarded_frames', 'publish_digest_rejected',
                                'rejected', 'quarantined')
         if ingest[k]}
  if bad or ingest['hosts_joined'] != REMOTE_HOSTS:
    raise AssertionError(f'remote_fleet: {bad}, ingest {ingest}')
  if (run.ingest.serializations != 1 + len(remote_publishes)
      or remote_publishes != list(range(2, 2 + len(remote_publishes)))):
    raise AssertionError(f'remote_fleet: {run.ingest.serializations} '
                         f'serializations for remote publishes '
                         f'{remote_publishes}')
  for i, text in enumerate(host_logs):
    if 'learner finished training' not in text:
      raise AssertionError(f'remote_fleet: actor host {i} did not end on '
                           f'the learner\'s bye:\n{text[-4000:]}')
  # The timed window: steps 2..REMOTE_FLEET_STEPS.
  times = [run.step_log[i]['time'] for i in range(REMOTE_FLEET_STEPS)]
  step_ms = statistics.median(1e3 * (b - a) for a, b in zip(times, times[1:]))
  (t_a, u_a), (t_b, u_b) = unrolls[1], unrolls[REMOTE_FLEET_STEPS]
  busy_ms = _busy_ms_or_fail('remote_fleet', profiler)
  idle = f'{1 - busy_ms / (1e3 * (window[1] - window[0])):.4f}'
  # The wire's bytes per unroll: the OOB frame of a full-width unroll
  # with its params version, epoch and trace context.
  unroll = _full_width_unrolls(config, 1)[0]
  trace = telemetry.make_trace('host0:1', 7, epoch=1 << 60,
                               behavior_version=2)
  frame_bytes = sum(memoryview(seg).nbytes for seg in
                    remote._oob_frame_segments(
                        ('unroll', unroll, 2, 1 << 60, trace)))
  serializations = run.ingest.serializations
  host = driver.host_params(run.state.params)
  publish_ms = []
  for _ in range(REMOTE_PUBLISH_REPS):
    torch.cuda.synchronize()
    t = time.perf_counter()
    run.ingest.publish_params(driver.host_params(run.state.params))
    publish_ms.append(1e3 * (time.perf_counter() - t))
  f32_bytes = sum(v.nbytes for v in host.values())
  MEASURED['remote_step_ms'] = step_ms
  log(f'remote_fleet: {REMOTE_FLEET_STEPS} learner steps in {wall:.2f} s '
      f'(the actor hosts\' start-up included); losses {losses}; vtrace '
      f'launches {counts["vtrace"]}; {REMOTE_HOSTS} actor hosts x '
      f'{REMOTE_HOST_ACTORS} actors, both exited 0 on the learner\'s bye; '
      f'ingest {ingest}')
  log(f'remote_fleet: {step_ms:.2f} ms per learner step (median of steps '
      f'2-{REMOTE_FLEET_STEPS}; the fleet phase in this run: '
      f'{MEASURED.get("fleet_step_ms", float("nan")):.2f}); idle share '
      f'{idle} (torch.profiler in the learner process, steps 2-'
      f'{REMOTE_FLEET_STEPS}: the hosts\' inference runs in their own '
      f'processes); {(u_b - u_a) / (t_b - t_a):.2f} unrolls/s over the wire '
      f'in that window, {frame_bytes} bytes per unroll frame '
      f'({(u_b - u_a) * frame_bytes / (t_b - t_a) / 1e6:.2f} MB/s); ack '
      f'p50 {ingest["ack_p50_ms"]} ms p99 {ingest["ack_p99_ms"]} ms; '
      f'param blob {run.ingest.snapshot_nbytes()} bytes bf16 '
      f'(float32 {f32_bytes}), publish (device->host copy, cast, digest, '
      f'frame) {[round(m, 2) for m in publish_ms]} ms; '
      f'{len(remote_publishes)} remote publishes, {serializations} '
      f'serializations, '
      f'{ingest["param_blobs"]} blobs served; peak allocated '
      f'{peak_gib:.3f} GiB; the learner\'s {_verdict_line(verdict)}; '
      f'{controller_line}; {stats_line[0]}')
  return counts


# Monotone counters of a live ingest's stats reply that fleet_stats and an
# in-process fetch_stats() must agree on (before <= the tool's <= after).
FLEET_STATS_COUNTERS = ('unrolls', 'connections', 'hosts_joined',
                        'param_blobs')


def _fleet_stats_against_fetch(port):
  """The fleet_stats module (--json) against the live ingest at `port`,
  between two in-process fetch_stats() calls: the same registry names and
  ingest keys as the second, each monotone counter between the two, and
  its reply's text form holding both sections. Returns a line for the
  log."""
  def fetch():
    client = remote.RemoteActorClient(f'127.0.0.1:{port}',
                                      connect_timeout_secs=10)
    try:
      return client.fetch_stats()
    finally:
      client.close()

  t = time.perf_counter()
  before = fetch()
  tool = _module_run('scalable_agent_tpu_torch.scripts.fleet_stats',
                     f'127.0.0.1:{port}', '--json', timeout=120)
  after = fetch()
  if tool.returncode != 0:
    raise AssertionError(f'remote_fleet: fleet_stats exited '
                         f'{tool.returncode}: {tool.stderr}')
  got = json.loads(tool.stdout)
  text = fleet_stats_script.render(got, name_filter='ingest')
  problems = []
  for part in ('registry', 'ingest'):
    if set(got[part]) != set(after[part]):
      problems.append(f'{part} keys differ: '
                      f'{sorted(set(got[part]) ^ set(after[part]))}')
  pairs = [(f'ingest {k}', before['ingest'][k], got['ingest'][k],
            after['ingest'][k]) for k in FLEET_STATS_COUNTERS]
  pairs.append(('registry ingest/unrolls', before['registry']['ingest/unrolls'],
                got['registry']['ingest/unrolls'],
                after['registry']['ingest/unrolls']))
  problems += [f'{what}: {a} <= {b} <= {c} fails'
               for what, a, b, c in pairs if not a <= b <= c]
  if ('== metrics registry' not in text or '== ingest server ==' not in text
      or 'ingest/unrolls' not in text):
    problems.append(f'text form: {text[:400]}')
  if problems:
    raise AssertionError(f'remote_fleet: fleet_stats against fetch_stats: '
                         f'{problems}')
  return (f'fleet_stats --json agrees with fetch_stats() taken around it: {len(got["registry"])} registry '
          f'names, ingest unrolls {before["ingest"]["unrolls"]} <= '
          f'{got["ingest"]["unrolls"]} <= {after["ingest"]["unrolls"]}, in '
          f'{time.perf_counter() - t:.2f} s')


def phase_remote_faults():
  """The drill (see the module docstring): one actor host with a
  reconnect window feeds a learner CLI that a learner_crash SIGKILLs at
  its (REMOTE_FAULTS_CRASH + 1)th consumed batch, then the same CLI
  restarted on the same port, resumed from its last checkpoint (step
  REMOTE_FAULTS_CRASH), to REMOTE_FAULTS_STEPS. The plan's wire_bitflip
  fires in the actor host, publish_corrupt in every publish of the first
  learner."""
  port = _free_port()
  config = Config(**REMOTE_FAULTS)
  plan = faults.FaultPlan.storm(seed=1, **REMOTE_FAULTS_PLAN)
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory(prefix='chip_smoke_remote_faults_') as logdir:
    flags = _flags(REMOTE_FAULTS) + [
        f'--remote_actor_port={port}', f'--logdir={logdir}',
        f'--total_environment_frames={REMOTE_FAULTS_STEPS * config.frames_per_step}']
    host = _actor_host(port, 0, REMOTE_HOST_ACTORS, logdir, plan=plan,
                       reconnect=120.0)
    try:
      env = dict(os.environ, **{faults.PLAN_ENV_VAR: plan.to_json()})
      t0 = time.perf_counter()
      first = subprocess.run([sys.executable, '-c', _CLI_WITH_PLAN] + flags,
                             capture_output=True, text=True, timeout=300,
                             env=env, cwd=root)
      crashed_at = time.perf_counter() - t0
      env.pop(faults.PLAN_ENV_VAR)
      # The restarted learner publishes nothing (no host mid-fetch when it
      # closes; see REMOTE_FLEET).
      second = subprocess.run(
          [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment'] +
          flags + ['--publish_params_every=1000'], capture_output=True,
          text=True, timeout=300, env=env, cwd=root)
      wall = time.perf_counter() - t0
    except BaseException:
      host[0].kill()
      host[0].wait()
      raise
    learners = []
    if (first.returncode != -signal.SIGKILL
        or f'learner_crash fault firing (index {REMOTE_FAULTS_CRASH})'
        not in first.stderr):
      learners.append(f'the first learner exited {first.returncode}:\n'
                      f'{first.stderr[-6000:]}')
    if second.returncode != 0 or (
        f'restored checkpoint at step {REMOTE_FAULTS_CRASH}'
        not in second.stderr):
      learners.append(f'the restarted learner exited {second.returncode}:'
                      f'\n{second.stderr[-8000:]}')
    if learners:
      host[0].kill()
      host[0].wait()
      with open(host[1]) as f:
        learners.append(f'the actor host:\n{f.read()[-4000:]}')
      raise AssertionError('remote_faults: ' + '\n'.join(learners))
    (actor_log,) = _finish_hosts([host], 'remote_faults')
    summaries = {tag: _summary_values(logdir, tag) for tag in (
        'total_loss', 'wire_crc_rejected', 'remote_unrolls',
        'remote_reattached', 'remote_stale_epoch_rejected',
        'publish_digest_rejected')}
    # The restarted learner's verdict; the SIGKILLed one writes none, and
    # its burns live in the durable slo_violation incidents the two share.
    verdict = _slo_verdict('remote_faults', logdir)
    with open(os.path.join(logdir, 'incidents.jsonl')) as f:
      burned = [e['objective'] for e in map(json.loads, f)
                if e['kind'] == 'slo_violation']
    # Unrolls held across the crash can burn unroll_e2e_p99_ms: its rule
    # flips admission block->shed, virtually.
    controller_line = _controller_logs(
        'remote_faults', logdir,
        allowed=CONTROLLER_ANYWHERE + ('unroll_e2e_p99_ms',))
  _check_precision_line(second.stderr, 'remote_faults')
  steps = [s for s, _ in summaries['total_loss']]
  if steps != list(range(1, REMOTE_FAULTS_STEPS + 1)):
    raise AssertionError(f'remote_faults: loss steps {steps}')
  last = {tag: values[-1][1] for tag, values in summaries.items() if values}
  crc_first = [v for s, v in summaries['wire_crc_rejected'] if s == 1]
  before_reattach = actor_log.split('RE-ATTACHED')[0]
  problems = []
  if not last.get('remote_reattached', 0) >= 1:
    problems.append('the reattach was not counted')
  if any(v for _, v in summaries['remote_stale_epoch_rejected']):
    problems.append('stale-epoch unrolls arrived')
  if not (crc_first and crc_first[0] >= 1
          and 're-sending once' in actor_log):
    problems.append('no CRC refusal followed by a resend')
  if ('failed its content digest' not in before_reattach
      or 'refreshed params to v' in before_reattach):
    problems.append('a corrupt publish was installed or none was refused')
  if 'RE-ATTACHED' not in actor_log or 'learner finished training' not in (
      actor_log):
    problems.append('the actor host did not reattach and end on the bye')
  if 'wire_crc_rejected_zero' not in burned + verdict['violations']:
    problems.append(f'the CRC refusal burned no wire_crc_rejected_zero '
                    f'(slo_violation incidents {burned}, the restarted '
                    f'learner\'s verdict {verdict["violations"]})')
  if (verdict['update_steps'] != REMOTE_FAULTS_STEPS
      or not verdict['clean_exit']):
    problems.append(f'the restarted learner\'s verdict {verdict}')
  if problems:
    raise AssertionError(f'remote_faults: {problems}; summaries '
                         f'{summaries}; actor host log:\n'
                         f'{actor_log[-6000:]}')
  report = [line for line in actor_log.splitlines()
            if 'INTEGRITY_REPORT' in line or 'RE-ATTACHED' in line]
  log(f'remote_faults: the first learner SIGKILLed {crashed_at:.1f} s in '
      f'(learner_crash at its {REMOTE_FAULTS_CRASH + 1}th consumed batch), the '
      f'restarted one resumed from step {REMOTE_FAULTS_CRASH} and ended at '
      f'step {steps[-1]}; {wall:.1f} s in all; '
      f'summaries (step, value) {summaries}; actor host: {report}; '
      f'slo_violation incidents of both learners {burned}; the restarted '
      f'learner\'s {_verdict_line(verdict)}, {controller_line}')


CHAOS_TIMEOUT_SECS = 300
# What JAX's fault storm asserts its verdict violates (scripts/chaos.py).
CHAOS_VIOLATIONS = ('ingest_quarantine_zero', 'rollbacks_zero')


def phase_chaos_fault():
  """The port's fault storm at smoke size on the card, as a process;
  returns its record."""
  out_dir = tempfile.mkdtemp(prefix='chaos_fault_')
  out_path = os.path.join(out_dir, 'CHAOS_TORCH.json')
  env = dict(os.environ, CHAOS_SMOKE='1', CHAOS_STORM='fault',
             CHAOS_SEED='1', CHAOS_OUT=out_path)
  env.pop(faults.PLAN_ENV_VAR, None)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, '-m', 'scalable_agent_tpu_torch.scripts.chaos',
       '--device=cuda'], cwd=REPO_DIR, env=env, capture_output=True,
      text=True, timeout=CHAOS_TIMEOUT_SECS)
  secs = time.perf_counter() - t0
  tail = (proc.stdout[-1500:] + '\n' + proc.stderr[-3000:])
  lines = proc.stdout.strip().splitlines()
  summary = json.loads(lines[-1]) if lines else {}
  if proc.returncode != 0 or not summary.get('chaos_ok'):
    raise AssertionError(f'chaos_fault: the storm exited {proc.returncode}'
                         f' (chaos_ok {summary.get("chaos_ok")}): {tail}')
  with open(out_path) as f:
    result = json.load(f)
  violations = set((result.get('slo_verdict') or {}).get('violations')
                   or [])
  checks = {
      'device cuda': result.get('device', '').startswith('cuda'),
      'no crash': result.get('crash') is None,
      'rollbacks >= 1': result['health']['rollbacks'] >= 1,
      'quarantined >= 1': result['ingest']['quarantined'] >= 1,
      'lock-order cycles 0': result['lock_order']['cycles'] == 0,
      f'violations include {CHAOS_VIOLATIONS}':
          set(CHAOS_VIOLATIONS) <= violations,
  }
  failed = [name for name, ok in checks.items() if not ok]
  if failed:
    raise AssertionError(f'chaos_fault: {failed}: {json.dumps(result)}')
  log(f'chaos_fault: exit 0 in {secs:.1f} s (storm wall {result["wall_secs"]}'
      f' s), {result["device_update_steps"]} learner steps, time to '
      f'recover {result["time_to_recover_secs"]} s, rollbacks '
      f'{result["health"]["rollbacks"]}, skipped steps '
      f'{result["health"]["skipped_steps"]}, ingest {result["ingest"]}, '
      f'fleet {result["fleet"]}, save_errors '
      f'{result["checkpoint"]["save_errors"]}, lock order '
      f'{result["lock_order"]}, verdict pass '
      f'{result["slo_verdict"]["pass"]} violations {sorted(violations)}')
  return result


COMPARE_TORSOS_TIMEOUT_SECS = 300
# The artifact keys of JAX's scripts/compare_torsos.py, and of each run.
COMPARE_TORSOS_KEYS = ('task', 'note', 'runs')
COMPARE_TORSOS_RUN_KEYS = ('torso', 'steps', 'frames',
                           'return_curve_deciles', 'tail_mean_return')
# Its SMOKE size: 8 learner steps of B=2, T=8 per torso.
COMPARE_TORSOS_SMOKE_STEPS = 8
COMPARE_TORSOS_SMOKE_FRAMES = COMPARE_TORSOS_SMOKE_STEPS * 2 * 8


def phase_compare_torsos():
  """The port's deep against deep_fast harness at its SMOKE size on the
  card, as a process; returns its artifact."""
  out_dir = tempfile.mkdtemp(prefix='compare_torsos_')
  out_path = os.path.join(out_dir, 'TORSO_COMPARE.json')
  env = dict(os.environ, SMOKE='1', TORSO_COMPARE_OUT=out_path)
  env.pop(faults.PLAN_ENV_VAR, None)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, '-m', 'scalable_agent_tpu_torch.scripts.compare_torsos',
       '--device=cuda'], cwd=REPO_DIR, env=env, capture_output=True,
      text=True, timeout=COMPARE_TORSOS_TIMEOUT_SECS)
  secs = time.perf_counter() - t0
  if proc.returncode != 0 or not os.path.exists(out_path):
    raise AssertionError(f'compare_torsos: exit {proc.returncode}: '
                         f'{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}')
  with open(out_path) as f:
    result = json.load(f)
  runs = result.get('runs') or []
  checks = {
      'JAX\'s keys': all(k in result for k in COMPARE_TORSOS_KEYS) and all(
          k in r for r in runs for k in COMPARE_TORSOS_RUN_KEYS),
      'deep, deep_fast': [r.get('torso') for r in runs] == ['deep',
                                                            'deep_fast'],
      'device cuda': all(r.get('device', '').startswith('cuda')
                         for r in runs),
      f'{COMPARE_TORSOS_SMOKE_STEPS} steps, {COMPARE_TORSOS_SMOKE_FRAMES} '
      'frames': all(r.get('steps') == COMPARE_TORSOS_SMOKE_STEPS and
                    r.get('frames') == COMPARE_TORSOS_SMOKE_FRAMES
                    for r in runs),
      'curves of 10 deciles or none': all(
          len(r.get('return_curve_deciles', ())) in (0, 10) for r in runs),
      'finite tail means': all(math.isfinite(r.get('tail_mean_return',
                                                    math.nan)) for r in runs),
  }
  failed = [name for name, ok in checks.items() if not ok]
  if failed:
    raise AssertionError(f'compare_torsos: {failed}: {json.dumps(result)}')
  log(f'compare_torsos: exit 0 in {secs:.1f} s; ' + '; '.join(
      f'{r["torso"]} {r["steps"]} steps, {r["frames"]} frames, '
      f'{r["wall_secs"]} s, tail mean {r["tail_mean_return"]}, deciles '
      f'{r["return_curve_deciles"]}' for r in runs))
  return result


PR_SET_CHILD_SUBREAPER = 36
# How long processes left at the end may take to exit on their own (a
# killed host's forkserver and env processes see their pipes close).
LEFTOVER_GRACE_SECS = 10.0


def _become_subreaper():
  """Make this process the reaper of its descendants' orphans (Linux
  prctl), so the sweep at the end finds every process the phases
  started, also one whose parent was killed. Returns whether it took."""
  import ctypes
  try:
    libc = ctypes.CDLL(None, use_errno=True)
    return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
  except (OSError, AttributeError):
    return False


def _children():
  """{pid: (state, command line)} of this process's children, zombies
  included, from /proc."""
  me, found = os.getpid(), {}
  for entry in os.listdir('/proc'):
    if not entry.isdigit():
      continue
    try:
      with open(f'/proc/{entry}/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
      if int(fields[1]) != me:
        continue
      with open(f'/proc/{entry}/cmdline', 'rb') as f:
        cmd = f.read().replace(b'\0', b' ').decode(errors='replace')
    except (OSError, IndexError, ValueError):
      continue  # it exited while being read
    found[int(entry)] = (fields[0], cmd.strip()[:200])
  return found


def _reap(pids):
  for pid in pids:
    try:
      os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
      pass


def _stop_leftover_processes():
  """Reap every child still there once the phases have ended: wait up
  to LEFTOVER_GRACE_SECS for them to exit, then SIGKILL the rest (and
  whatever their deaths hand to this reaper). Logs each one stopped;
  returns how many were killed."""
  deadline = time.monotonic() + LEFTOVER_GRACE_SECS
  seen, killed = {}, 0
  while True:
    kids = _children()
    _reap(kids)
    live = {pid: cmd for pid, (state, cmd) in kids.items() if state != 'Z'}
    seen.update(live)
    if not live:
      break
    if time.monotonic() >= deadline:
      for pid, cmd in live.items():
        log(f'leftover process {pid} still running after the phases; '
            f'SIGKILL: {cmd}')
        try:
          os.kill(pid, signal.SIGKILL)
          killed += 1
        except ProcessLookupError:
          pass
      deadline = time.monotonic() + 2.0  # for the killed to be reaped
    time.sleep(0.1)
  log(f'processes at the end: {len(seen)} outlived the phases, '
      f'{killed} killed' + (f': {sorted(seen.values())}' if seen else ''))
  return killed


def main():
  reaper = _become_subreaper()
  # Before any CUDA call: the fleet's env processes fork from this
  # server, which has this script's imports loaded.
  py_process.warm_forkserver(preload=['chip_smoke'])
  try:
    records = run_phases()
  finally:
    py_process.stop_forkserver()
    if not reaper:
      log('prctl(PR_SET_CHILD_SUBREAPER) refused: the sweep sees only '
          'direct children')
    _stop_leftover_processes()
  # The kernels line and the ok line come last, after the sweep's.
  for record in records:
    print(json.dumps(record), flush=True)


def _together(*calls):
  """Run phases whose work is in subprocesses and whose checks are of
  correctness, not time, at once: each in a thread that waits on its
  processes. Raises the first failure after all have ended."""
  errors = []

  def run(fn, *args):
    try:
      fn(*args)
    except BaseException as e:  # re-raised below
      errors.append(e)

  threads = [threading.Thread(target=run, args=call) for call in calls]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    raise errors[0]


def run_phases():
  phases = []

  def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    phases.append((name, time.perf_counter() - t0))
    return out

  timed('device', phase_device)
  # Float32 layers run without TF32 (the float32 slice is held to the
  # CPU's float32); K2's twin is unaffected, bf16 values being exact in
  # TF32.
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  ptxas = timed('build', phase_build)
  floor_us = timed('launch_floor', phase_launch_floor)
  k1 = timed('kernels', phase_kernels)
  k2 = timed('conv_pool', phase_conv_pool)
  timed('conv_pool_torso', phase_conv_pool_torso)
  paths = {}
  paths['slice'] = timed('slice', phase_slice)
  timed('slice_reference', phase_slice_reference)
  paths['slice_bf16'] = timed('slice_bf16', phase_slice, 'bfloat16')
  timed('slice_bf16_reference', phase_slice_bf16_reference)
  paths['conv_pool_entry'] = timed('conv_pool_entry', phase_conv_pool_entry)
  k1b = timed('vtrace_sharded', phase_vtrace_sharded)
  paths['slice_dp'] = timed('slice_dp', phase_slice_dp)
  # The Anakin CLIs at once (their checks are of correctness).
  timed('cli, cli_bf16, cli_dp', _together, (phase_cli,),
        (phase_cli, 'bfloat16'), (phase_cli_dp,))
  paths['fleet'] = timed('fleet', phase_fleet)
  timed('fleet_reference', phase_fleet_reference)
  paths['resume_anakin'] = timed('resume_anakin', phase_resume_anakin)
  paths['rollback_fleet'] = timed('rollback_fleet', phase_rollback_fleet)
  paths['dp_fleet'] = timed('dp_fleet', phase_dp_fleet)
  paths['unroll_fleet'] = timed('unroll_fleet', phase_unroll_fleet)
  paths['tp'] = timed('tp', phase_tp)
  paths['full_feature'] = timed('full_feature', phase_full_feature)
  timed('full_feature_reference', phase_full_feature_reference)
  paths['impact_fleet'] = timed('impact_fleet', phase_impact_fleet)
  paths['extensions_anakin'] = timed('extensions_anakin',
                                     phase_extensions_anakin)
  paths['popart_dp'] = timed('popart_dp', phase_popart_dp)
  timed('fit', phase_fit)
  paths['procgen_anakin'] = timed('procgen_anakin', phase_procgen_anakin)
  paths['pbt_vectorized'] = timed('pbt_vectorized', phase_pbt_vectorized)
  paths['pbt_serial'] = timed('pbt_serial', phase_pbt_serial)
  paths['curriculum_dp'] = timed('curriculum_dp', phase_curriculum_dp)
  paths['filler_fleet'] = timed('filler_fleet', phase_filler_fleet)
  paths['deep_fast'] = timed('deep_fast', phase_deep_fast)
  paths['cores_anakin'] = timed('cores_anakin', phase_cores_anakin)
  paths['state_cache_fleet'] = timed('state_cache_fleet',
                                     phase_state_cache_fleet)
  timed('state_cache_reference', phase_state_cache_reference)
  timed('serving', phase_serving)
  paths['routed_serving'] = timed('routed_serving', phase_routed_serving)
  paths['admission'] = timed('admission', phase_admission)
  paths['mixed_fleet'] = timed('mixed_fleet', phase_mixed_fleet)
  paths['telemetry_fleet'] = timed('telemetry_fleet', phase_telemetry_fleet)
  paths['faults_fleet'] = timed('faults_fleet', phase_faults_fleet)
  paths['remote_fleet'] = timed('remote_fleet', phase_remote_fleet)
  # The fleet's CLI phases at once: their checks are of correctness, and
  # the wall times and the drain latency they print include the others'
  # load. The parent's cached blocks go back to the card first.
  _free_the_card('the fleet CLIs')
  timed('drain_fleet, cli_fleet_dp, cli_full_feature, remote_faults, '
        'eval_cli, chaos_fault, compare_torsos', _together,
        (phase_drain_fleet,), (phase_cli_fleet_dp,),
        (phase_cli_full_feature,), (phase_remote_faults,), (phase_eval_cli,),
        (phase_chaos_fault,), (phase_compare_torsos,))
  log('phases: ' + ', '.join(f'{n} {s:.1f} s' for n, s in phases))
  launches = {name: {path: counts[name] for path, counts in paths.items()}
              for name in COUNTERS}
  for name, by_path in launches.items():
    if not sum(by_path.values()):
      raise AssertionError(f'{name} was launched on no path: {by_path}')
  vtrace = dict(
      name='vtrace', route='cuda',
      source='scalable_agent_tpu_torch/csrc/vtrace.cu',
      replaces='scalable_agent_tpu/ops/vtrace_pallas.py:58',
      launches=sum(launches['vtrace'].values()),
      launches_by_path=launches['vtrace'],
      max_abs_err=k1['max_abs_err'], ms=k1['ms'],
      plain_ms=k1['plain_ms'], bound_ms=k1['bound_ms'],
      bound_by=k1['bound_by'], library_ms=None, device_us=k1['device_us'],
      launch_floor_us=floor_us, ptxas=ptxas['vtrace'],
      ok=True, max_err=k1['max_abs_err'], kernel_ms=k1['ms'])
  conv_pool = dict(
      name='conv_pool', route='cuda',
      source='scalable_agent_tpu_torch/csrc/conv_pool.cu',
      replaces='scripts/pallas_conv_pool.py:66',
      launches=sum(launches['conv_pool'].values()),
      launches_by_path=launches['conv_pool'],
      max_abs_err=k2['max_abs_err'], ms=k2['ms'],
      plain_ms=k2['plain_ms'], bound_ms=k2['bound_ms'],
      bound_by=k2['bound_by'], library_ms=k2['library_ms'],
      device_us=k2['device_us'], n_differ=k2['n_differ'],
      ptxas=ptxas['conv_pool'],
      ok=True, max_err=k2['max_abs_err'], kernel_ms=k2['ms'])
  vtrace_sharded = dict(
      name='vtrace_sharded', route='cuda',
      source='scalable_agent_tpu_torch/csrc/vtrace.cu',
      replaces='scalable_agent_tpu/ops/vtrace_pallas.py:177',
      launches=sum(launches['vtrace_sharded'].values()),
      launches_by_path=launches['vtrace_sharded'],
      max_abs_err=k1b['max_abs_err'], ms=k1b['ms'],
      plain_ms=k1b['plain_ms'], bound_ms=k1b['bound_ms'],
      bound_by=k1b['bound_by'], library_ms=None,
      device_us=k1b['device_us'], launch_floor_us=floor_us,
      ok=True, max_err=k1b['max_abs_err'], kernel_ms=k1b['ms'])
  return [{'kernels': [vtrace, conv_pool, vtrace_sharded]},
          {'ok': True, 'device': {
              'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': torch.cuda.device_count()}}]


if __name__ == '__main__':
  main()
