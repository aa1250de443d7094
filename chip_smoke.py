#!/usr/bin/env python3
"""Smoke run of the PyTorch port (or_gym_inventory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source, all
at once), then drives the port's main paths, each with every
launch counter set to 0 just before it and read just after:

- slice 1, NetInvMgmt random-policy episode returns (phases 3-4): what
  bench.py does on the JAX package, a cross-check of the fused kernel on its
  own dumped streams followed by random-policy returns of the default graph
  at 4,194,304 lanes x 16 episodes x 30 periods, through
  ``vector.fast_episodes.random_episode_returns``, which alone launches K2
  once, nothing else and no plain version;
- slice 2, NetInvMgmt PPO and learned-policy evaluation (phase 8):
  ``agents.ppo.train`` with ``rollout="kernel"`` at 65,536 envs x 30
  periods, the default 64x64 tanh actor-critic, 4 epochs x 8 minibatches,
  3 updates, then ``policy_episode_returns`` of the trained actor at
  65,536 x 16, deterministic and stochastic. After the counts are read, the
  deterministic returns of the first 1,024 lanes are held against plain K5;
- slice 3, InvManagement random-policy returns (phase 11):
  ``random_episode_returns`` with ``inv_management.default_params()`` at
  4,194,304 x 16 x 30 launches K8 once, nothing else and no plain version
  (K9 and K7 are held on the same seed's streams before the count);
- slice 3, InvManagement PPO (phase 13): ``train`` with ``rollout="kernel"``
  at 65,536 x 30, 64x64 (obs_dim 33, act_dim 3), 4 epochs x 8 minibatches,
  3 updates: 3 launches of K10 and no plain version;
- slice 4, InvManagement learned-policy evaluation (phase 17):
  ``policy_episode_returns`` of phase 13's trained actor at 65,536 x 16 x 30,
  deterministic and stochastic, launches K11 once per call, nothing else and
  no plain version; the first 1,024 lanes are then held against plain K11;
- slice 4, Newsvendor random-policy returns (phase 19):
  ``random_episode_returns`` with benchmarks/benchmark_newsvendor.py's
  ENV_CONFIG_EVAL (lead_time 5, step_limit 50, mu_max 200) at 4,194,304 x
  16 x 50 launches K16 once, nothing else and no plain version; its first
  65,536 x 16 returns are then held against plain K16 on the replayed seed;
- slice 5, Newsvendor PPO (phase 22): ``train`` with ``rollout="kernel"`` at
  ENV_CONFIG_EVAL, 65,536 x 50, 64x64 (obs_dim 10, act_dim 1), 4 epochs x 8
  minibatches, 3 updates: 3 launches of K18 and nothing else;
- slice 5, Newsvendor learned-policy evaluation (phase 23):
  ``policy_episode_returns`` of phase 22's trained actor at 65,536 x 16 x
  50, deterministic and stochastic, launches K19 once per call and nothing
  else; the first 1,024 lanes are then held against plain K19;
- slice 6, recurrent PPO on InvManagement (phase 26):
  ``recurrent_ppo.train`` with ``rollout="kernel"`` at 65,536 x 30, the
  benchmark LSTM (encoder 64, hidden 128), 4 epochs x 8 env-sliced
  minibatches, 3 updates: 3 launches of K24 and nothing else;
- slice 6, LSTM-policy evaluation (phase 27): ``lstm_policy_episode_returns``
  of phase 26's trained actor at 1,048,576 x 30 launches K22 once and
  nothing else; the first 1,024 lanes are then held against plain K22;
- slice 7, the last two NetInvMgmt sites (phase 31): ``rollout_transposed``
  of the default graph at 65,536 envs x 30 periods launches K25 once per
  period, then ``episode_returns_random_policy`` on K3's demand K26 once,
  nothing else; the rollout's total is then held against the plain step
  replayed on the same generator seed, and K26 against K2;
- slice 7, TD3 with ``collect="kernel"`` on InvManagement backlog (phase
  33) at tools/validate_kernel_collect.py's config (1,024 envs, buffer
  200,704, batch 256, 32 updates per period) for 8 iterations: K27 once
  per iteration and nothing else; then the deterministic actor over 30
  episodes, which must beat the random policy;
- slice 7, SAC and DDPG on Newsvendor and NetInvMgmt (phase 34), 2
  iterations each (the uniform warmup, then the algorithm's head): K28 or
  K29 once per iteration and nothing else;
- slice 8, PPO's fused policy+env update (phase 36): Newsvendor at
  benchmarks/benchmark_newsvendor.py's PPO_CFG with ``rollout="xla"``,
  plain PyTorch on ``vector.vecenv`` as the JAX package left it to XLA,
  launches no kernel and runs no plain kernel version; its trained-steps/s
  is printed beside the kernel path's at the same config, and
  ``vecenv.auto_reset``'s share of an update. Phase 37 trains ``PPOAgent``
  on it, saves and loads it (the loaded agent's actions equal bit for bit)
  and trains ``A2CAgent`` with ``A2CConfig()``; phase 38 takes one update
  at ``PPOConfig()``'s defaults on InvManagement and NetInvMgmt;
- slice 9, recurrent PPO's fused policy+env update (phase 39): the
  roster's PPO_LSTM configs with ``rollout="xla"`` on InvManagement (512 x
  50), NetInvMgmt and Newsvendor (256 x 30), launching no kernel and no
  plain kernel version, beside the kernel path's update at InvManagement's
  config (K24 once an update, nothing else). Phase 40 trains
  ``RecurrentPPOAgent`` on the kernel path (K24 once an update) and
  ``A2CLSTMAgent`` with ``A2CLSTMConfig()`` on the xla path, saves and
  loads them (``get_action`` over an episode and the stateful seeded
  evaluator equal bit for bit); phase 41 runs the seeded evaluators
  (``vector.evaluate_episodes_seeded``) at 65,536 lanes on each family, a
  permuted 1,000-seed sub-batch equal to the full batch's rows bit for bit
  and 256 seeds on the card against the CPU. Phase 15 also evaluates its
  trained PPO on the seeded protocol (30 episodes, seeds 4000-4029);
- slice 10, the off-policy step-interleaved update (phase 42): SAC, TD3
  and DDPG with ``collect="xla"`` at ``make_agent``'s config (32 envs,
  (256, 256), batch 256) on each family, launching no kernel and no plain
  kernel version, each iteration timed, and TD3 on InvManagement at
  tools/validate_kernel_collect.py's config beside it. Phase 43 builds
  the seven learners by name (``agents.make_agent``), trains, saves and
  loads each (``get_action`` bit for bit), and trains ``TD3Agent`` with
  ``collect="kernel"`` on InvManagement (K27 once an iteration, nothing
  else); phase 44 holds ``poisson_ppf`` on the card against SciPy and runs
  the heuristic roster through the seeded evaluator at 65,536 lanes, its
  actions against the CPU's teacher-forced;
- slice 11, the benchmark harness and the Gymnasium surfaces (phases
  45-47): ``bench.protocols``' InvManagement backlog protocol through
  ``bench.runner.run_benchmark`` with the vectorized evaluator on the card,
  30 episodes from seed 4000 at 50 periods, the roster cut to Random,
  BaseStock 1.0, PPO and PPO_Kernel (``OGT_AGENTS``, ``OGT_KERNEL_ROSTER``),
  K10 launched once for each of PPO_Kernel's 3 updates and nothing else,
  no plain version in that run (K10 is held against it just before, at
  PPO_Kernel's 1,024 x 50); the host protocol (``bench.evaluate_agent`` on the
  port's ``envs.adapters.InvManagementBacklogEnv``) with BaseStock 1.0 and
  the trained PPO, each mean within 4 combined standard errors of its
  phase-45 mean; ``vector.gym_vector.BatchedGymVectorEnv`` over
  NetInvMgmt's defaults at 4,096 envs, SAME_STEP, for a horizon plus one
  (both no launch).

Every kernel output on those paths is held against the kernel's plain
PyTorch version on the same inputs: K1-K3 in phases 3-4, K4-K6 in phase 7
(at the main path's shapes, with a seeded actor whose obs statistics are
folded into layer 1), which also holds the NaN propagation of the shared
step and K5/K6 on a ragged batch (1,000 x 3) and with a NaN weight, K7-K9
in phase 10 for all five demand modes in backlog and lost sales (K9 also on
a ragged batch, and on a chain of 8 stocked stages with lt 32, the struct
maxima, with K8 = K7 on its streams), and K10
in phase 12 (with the env step chain on its streams and a
NaN std) and again at 1,024 x 50 on the IM-backlog protocol's params before
phase 45 (``k10_against_plain``), K11/K12 in phase 16 (at 65,536 x 16 x 30, both modes, with K7 on
K12's streams and K10 against the stochastic episode 0 bit for bit, a
ragged batch and a NaN weight), and K13-K17 in
phase 18 (at 65,536 x 50, E 1 and 4, for lead time 5 and 0, gamma 1 and
0.99, mu_max 200 and 3, with the chain K16 = K14 = K13 _random = K13 on
K17's streams and a NaN lane; and K16/K17 at mu_max 30,000, whose Poisson
table no block holds, so they count linearly, at 4,096 x 2 x 50), and K18-K21 in phase 21 (K18 at 65,536 x
50, K19/K20 at 65,536 x 16 x 50, lead time 5 and 0, gamma 1 and 0.99,
deterministic and stochastic, with K13 on K20's streams, K18 against the
stochastic episode 0 bit for bit, a NaN std, K19/K20 on a ragged batch,
with a NaN weight and on the linear count at mu_max 30,000 (4,096 x 2 x 50), and K21's
normals through the goodness-of-fit pin of
tests/test_pallas_policy.py:394-419), and K22-K24
in phase 25 (at 65,536 x 30 with a seeded actor of the benchmark widths,
Poisson demand in backlog and lost sales, binomial and USER mode, with K7
on K23's streams, K24 replayed through the env step chain, its raws
squashed to its actions and a NaN std), K25/K26 in phase 30 (K25 on 30
chained periods at 65,536 lanes, backlog and lost sales, on the default,
two-retail and custom graphs; K26 on K3's demand against K2 and plain K26)
and K27-K29 in phase 32 (at 65,536 lanes and at
the learners' 1,024, with a seeded actor of SB3's default (256, 256) relu
widths, heads det, sac and uniform, the demand against K10/K18/K4's on the
same seed, a_norm teacher-forced on the kernel's own obs, each kernel's
streams through the plain step chain, K29's through K1 too; and K27/K28 on
a ragged batch of 1,000 lanes, K28's econ bit for bit, and, with a
(512, 512) actor whose slice fits no cluster tile, on the wrapper's wide
route; K29 too on the ragged batch and the wide route, and, at 65,536
lanes, on the batch route that the wrapper takes past
``net_step._NET_CLUSTER_MAX_ROUNDS`` rounds of the card's clusters, the
first design). Phase 7 also holds the stochastic K6's episode 0 against K4
on the same seed (its words are K4's, and both run the actor on the same
tensor-core tile): demand bit for bit, actions by the share of lanes,
whether bit for bit reported. Kernels on no main path are
launched only to be held: K6, K5 with its streams dumped (phase 7), K9 and
K7, the streams and the stream-in replay of K8's draws (phases 10-12), K12
(phase 16), K13 (also on ragged batches and at lead times 0 and 32, its
edges), K14, K15 and K17 (phase 18), K20 and K21 (phase 21), K23
(phase 25). Phase 2 prints each kernel's registers and stack frame from
``ptxas -v``, and the local-memory loads and stores (LDL/STL) in the SASS
of net_episode.cu's kernels; it fails unless K1 and K25 (their state in
shared memory), and K2, K3 and K26 with them, have no stack frame and no
LDL/STL, K5/K6's deterministic
instances (the state in shared memory) have none (the stochastic ones keep
only cosf's never-run 32-byte reduction frame) and K5/K6's and K11/K12's
hold tensor-core (HMMA) instructions and spill nothing; K19/K20 (the
tensor-core tile too) are held as K5/K6, and K8 must have an instance for
each m1 up to the struct maxima, none with a stack frame or a local-memory
load or store, and K7 (K8's body, its streams staged by cp.async) one for
each m1, backlog flag and mode, none with either, and K9 one for each m1
and K21 (both on 2-D grids), none with either, and K13 one for each lead
time from 0 to 32 and mode (its pipeline in registers), none with either;
K4, K10 and K18 are the
tiles of K5, K11 and K19 with one stochastic episode a lane and their
streams written (``TRAJ_INSTANCES``:
``k_policy_returns<1,0,1>``, ``k_im_policy_returns<1,0,1,BACKLOG>``,
``k_nv_policy_returns<1,0,1,LAYOUT>``), which must be there, held as their
kernels' stochastic instances; K27-K29's cluster instances
(csrc/cluster_mlp.cuh) must all be built and spill nothing, their products on the FP32 cores (no HMMA).
Phase 6 also times K1 at the 1,024 and 4,096 lanes x 30 at which bench.py's
cross-check launches it (16 of its 17 launches are at 1,024), each shape
through the entry point and the kernel alone (the C entry point with its
plan made before, its returns the entry point's bit for bit); K3 at 65,536
x 30, K7 (streamed and _random, phase 14) and K13 (streamed and _random,
phase 20) are timed alone the same way.
Then it times the vecenv rollout (phase 5),
each kernel against its plain version (phases 6, 9, 14, 20, 24 and 28), K2
against plain K2 on a graph with two retail links and L = 0 links, backlog
and lost sales, at 65,536 x 4 x 30 (phase 6), one PPO update
with its gradient in 8 chunks per minibatch against 1 (phase 9), trains
InvManagement at the protocol of tools/validate_kernel_ppo.py for its
reward (phase 15), Newsvendor at benchmarks/benchmark_newsvendor.py's
PPO_CFG for 4M env-steps for its reward (phase 24), and recurrent PPO at
validate_kernel_ppo.py's rppo_kernel protocol for its reward, which must
beat the random policy's (phase 29), then K25-K29 (K27-K29 at the
learners' 1,024 lanes and at 65,536, through the entry points and, for
K27-K29, the kernel alone on the entry point's route, whose outputs must
first equal the entry point's bit for bit) and one TD3 iteration split into the kernel,
``insert_chunk`` and the gradient updates (phase 35). K16's bound is counted
for the search it runs (``nv_draw_ops``), with the first version's linear
count's beside it; K4-K6, K10-K12, K18-K20 and K22-K24's with their
tensor-core products (the MLP's layers, ``mlp_tc_flops``; the LSTM's gate
and encoder products, ``lstm_tc_flops``) as three TF32 products on the
tensor cores (``tc_bound``), with the all-FP32 count's beside it (and for
K18-K20, whose search replaced the linear count, the first version's count
too).
Every phase prints its lines; any
failure raises and exits non-zero. Without a CUDA device it exits 1 and
prints no result.

The last lines are one JSON object of per-kernel numbers, K1-K29
(``launches`` is the sum of a kernel's launches in the counted main-path
runs, so 0 for K6, K7, K9, K12-K15, K17, K20, K21 and K23; for K4, K5,
K10, K11, K14, K16, K18, K19, K20, K22, K24 and K27-K29, ``max_abs_err`` is
over the lanes that agree with the plain version; K27-K29's row is the det
head's at the learners' 1,024 lanes, the shape their main paths launch;
K1's row also splits its launches, times and bounds by shape), one JSON
object a group of paths (``ppo_main_path``: the NetInvMgmt PPO path's
rates; ``im_main_path``, ``nv_main_path``, ``lstm_main_path``: those
families' and the recurrent paths' rates and rewards;
``offpolicy_main_path``: the slice-7 paths' rates and TD3's reward;
``xla_main_path``, ``rppo_xla_main_path``, ``offpolicy_xla_main_path``: the
xla paths' rates beside the kernel paths' and the agents' training times;
``bench_main_path``: phases 45-47's rewards, rates and warm-ups), the card's
name and power limit as nvidia-smi gives them, and ``{"ok": true,
"device": {...}}``.

Tolerances: streams of draws (actions of K3 and K9, demand of K3, K4, K6,
K9 and K10) bit for bit; the InvManagement int32 state of the env step
chain against K10's inv exactly; K1-K3 and K7-K8 against their plain
versions, the fused kernels against the stream-in kernels, and the
stream-in kernels on K4/K6/K10's streams against their rewards and K5's
returns, rtol=1e-5 atol=1e-3 (f32 sums in another order, FMA contraction),
except K2 against K1 on K3's streams, K8 against K7 on K9's streams and
K7 _random on K9's demand, and K13 and K13 _random on K17's streams
against K16, bit for bit (one episode body, one order of sums);
the env step chain against the stream-in kernel and K4/K10's reward
streams rtol=1e-4 atol=1e-2 (bench.py:156); K4's raws against the folded
actor on the assembled obs plus the plain normals atol=1e-4 (matmul sums
in another order, an ulp of logf/cosf); K4-K6 and K10 free-running against
their plain versions: at least 99% of lanes agree over the whole episode
within rtol=1e-4 atol=1e-2, since a rounding tie in rint (NetInvMgmt) or a
truncation boundary (InvManagement) lets a lane take the other integer and
diverge (the fraction-closeness rule, ROADMAP.md Queue C). K8 against plain
K8 bit for bit (int32 state, the same arithmetic; E = 1, 16 and a ragged
batch in phase 10, also on chains of 1, 2 and 8 stocked stages, each m1 its
own instance; the main path's first lanes in phase 11). K11 and K12 are
held like K10, and K7 on K12's streams gives K11's returns within rtol=1e-5
atol=1e-3; the stochastic K11's episode 0 equals K10 bit for bit (the same
tile kernel): actions, demand, and its return K10's reward sum. Newsvendor
(K13-K17): econ and action streams bit for bit; the demand equal on at least 99.99% of draws and never more than 1 apart (the
inversion's logf/expf may differ from torch's by an ulp); returns against
the plain versions within rtol=1e-5 atol=1e-2 on at least 99% of lanes; the
chain K16 = K14 = K13 _random = K13 on K17's streams bit for bit (the same
words and the same arithmetic). Newsvendor policy kernels (K18-K21): econ and demand bit for bit
(K18 searches its Poisson table as K19/K20 do); K18's raws teacher-forced
atol=1e-4; free-running orders, raws, rewards and returns by the share of
lanes (>= 99% within rtol=1e-4 atol=1e-2: tanh and the MLP's sum order feed
back through the pipeline); K20 = K19 and K13 on K20's streams = K19 bit for
bit; the stochastic K19's episode 0 against K18 bit for bit (the same tile
kernel): econ, demand, K20's orders through the pipeline's cap against
K18's capped orders, and the return against K18's gamma^t-summed rewards;
K21 atol=1e-5 (also on a ragged batch in phase 24).
LSTM kernels (K22-K24; the kernels run the gate product and the encoder on
the tensor cores in 3xTF32, which keeps FP32's accuracy, the plain versions
in full f32 with TF32 off): demand bit for bit; K23's returns equal to K22's; returns, actions, inv, raws and
rewards against the plain versions by the share of lanes (>= 99% within
rtol=1e-4 atol=1e-2: the actor sums in another order, so a truncation
boundary lets a lane diverge); K7 on K23's and K24's streams within
rtol=1e-5 atol=1e-3 (whether bit for bit is reported); the env step chain
on K24's streams: inv exactly, rewards rtol=1e-4 atol=1e-2; K24's raws
squashed by torch give its actions on >= 99.99% of elements (reported).
K25 and K26 against their plain versions, K26 against K2, and the
rollout's total rtol=1e-5 atol=1e-3. K27-K29 (f32, TF32 off, the MLP summed
in another order): demand bit for bit against the plain versions and the
PPO kernels on the same seed; a_norm in [-1, 1], and teacher-forced (the
plain head on the kernel's own obs and words) within atol=1e-4 on every
element; free-running, a_norm on >= 99% of lanes within rtol=1e-4
atol=1e-4 and the other streams by the share of lanes (rtol=1e-4
atol=1e-2), uniform bit for bit, except the det and sac lanes of the float
families (K28, K29), which their pipelines' feedback lets drift and which
need only FLOAT_FREE_SHARE (K28 on the ragged batch too; on the wide
route's (512, 512) actor its share is reported, not gated); K27's a_norm rescaled gives its actions on
>= 99.99% of elements and the env step chain on its streams its inv
exactly; the plain step chain on K28's and K29's a_norm and demand gives
their other streams within rtol=1e-5 atol=1e-3 (orders rtol=1e-6
atol=1e-4), and K1 on K29's streams its rewards.
"""

import json
import math
import re
import subprocess
import sys
import time

NUM_STEPS = 30
MAIN_LANES = 4_194_304       # bench.py NUM_ENVS_PALLAS
MAIN_EPISODES = 16           # bench.py EPISODES_PER_LANE
CHECK_LANES = 65_536         # cross-check size, and the K1/K3 main-path shape
MULTI_LANES = 1_024          # bench.py:115, E=16 dumped in ranges of 8
# K4, K10 and K18: the tile kernels of K5/K6, K11/K12 and K19/K20, stochastic,
# their streams written (net_policy.cu; im_policy.cu in backlog and lost
# sales; nv_policy.cu on either demand layout)
TRAJ_INSTANCES = {"im_policy": ("k_im_policy_returns<1,0,1,0>", "k_im_policy_returns<1,0,1,1>"),
                  "nv_policy": ("k_nv_policy_returns<1,0,1,0>", "k_nv_policy_returns<1,0,1,1>"),
                  "net_policy": ("k_policy_returns<1,0,1>",)}
# K1's other shapes: the cross-check's per-episode launches (MULTI_LANES)
# and bench.py's own cross-check size (bench.py:79-135 runs at 4,096)
K1_LANES = (MULTI_LANES, 4_096)
ROLLOUT_ENVS = 262_144       # bench.py NUM_ENVS_XLA
SEED = 2024
PPO_ENVS = 65_536            # the PPO main path: envs x 30 periods per update
PPO_UPDATES = 3
EVAL_EPISODES = 16           # policy evaluation: PPO_ENVS lanes x 16 episodes
LANE_SHARE = 0.99            # free-running policy kernels vs plain

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet; FP32 outside
# the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_TC_OPS_PER_S = 495e12   # the tensor cores' dense TF32 rate

KERNEL_ROWS = [  # wrapper, source, the Pallas entry it replaces
    ("episode_returns", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:820"),
    ("episode_returns_fully_fused", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:379"),
    ("sample_streams_debug", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:427"),
    ("rollout_traj_net", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:683"),
    ("episode_returns_net_policy", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:611"),
    ("sample_policy_streams_debug_net", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:756"),
    ("episode_returns_im", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:779"),
    ("episode_returns_im_fused", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:919"),
    ("sample_streams_debug_im", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1873"),
    ("rollout_traj_im", "or_gym_inventory_torch/csrc/im_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1683"),
    ("episode_returns_im_policy", "or_gym_inventory_torch/csrc/im_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1264"),
    ("sample_policy_streams_debug_im", "or_gym_inventory_torch/csrc/im_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1287"),
    ("episode_returns_nv", "or_gym_inventory_torch/csrc/nv_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:146"),
    ("episode_returns_nv_fused", "or_gym_inventory_torch/csrc/nv_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:368"),
    ("sample_streams_debug_nv", "or_gym_inventory_torch/csrc/nv_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:529"),
    ("episode_returns_nv_reset_fused", "or_gym_inventory_torch/csrc/nv_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:495"),
    ("sample_streams_debug_nv_reset", "or_gym_inventory_torch/csrc/nv_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:513"),
    ("rollout_traj_nv", "or_gym_inventory_torch/csrc/nv_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1796"),
    ("episode_returns_nv_policy", "or_gym_inventory_torch/csrc/nv_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:648"),
    ("sample_policy_streams_debug_nv", "or_gym_inventory_torch/csrc/nv_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:665"),
    ("sample_normals_debug", "or_gym_inventory_torch/csrc/nv_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1849"),
    ("episode_returns_im_lstm", "or_gym_inventory_torch/csrc/im_lstm.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1459"),
    ("sample_lstm_streams_debug_im", "or_gym_inventory_torch/csrc/im_lstm.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1470"),
    ("rollout_traj_im_lstm", "or_gym_inventory_torch/csrc/im_lstm.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1551"),
    ("batched_step", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:774"),
    ("episode_returns_random_policy", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:857"),
    ("rollout_traj_im_offpolicy", "or_gym_inventory_torch/csrc/im_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1683"),
    ("rollout_traj_nv_offpolicy", "or_gym_inventory_torch/csrc/nv_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1796"),
    ("rollout_traj_net_offpolicy", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:683"),
]
IM_KERNELS = [name for name, _, _ in KERNEL_ROWS[6:10]]
IM_EVAL_KERNELS = [name for name, _, _ in KERNEL_ROWS[10:12]]
NV_KERNELS = [name for name, _, _ in KERNEL_ROWS[12:17]]
NV_POLICY_KERNELS = [name for name, _, _ in KERNEL_ROWS[17:21]]
LSTM_KERNELS = [name for name, _, _ in KERNEL_ROWS[21:24]]
B6_KERNELS = [name for name, _, _ in KERNEL_ROWS[24:26]]
OFF_KERNELS = [name for name, _, _ in KERNEL_ROWS[26:29]]
# the recurrent learner: RecurrentPPOConfig's default widths, the benchmark
# PPO_LSTM architecture (obs_dim 33, encoder 64, hidden 128, act_dim 3)
LSTM_HIDDEN, LSTM_ENCODER = 128, (64,)
LSTM_EVAL_LANES = 1_048_576  # the evaluation main path: lanes x 30 periods
# the five demand modes of InvManagement (inventory_management.py:169-184)
IM_DIST_MODES = [
    ("poisson", {}),
    ("binomial", {"dist": 2, "dist_param": {"n": 40, "p": 0.5}}),
    ("randint", {"dist": 3, "dist_param": {"low": 10, "high": 30}}),
    ("geometric", {"dist": 4, "dist_param": {"p": 0.05}}),
    ("user", {"dist": 5, "user_D": tuple((7 * t) % 41 for t in range(NUM_STEPS))}),
]
# phase 25's cases: (demand mode, backlog)
LSTM_CASES = [(IM_DIST_MODES[0], True), (IM_DIST_MODES[0], False), (IM_DIST_MODES[1], True),
              (IM_DIST_MODES[4], False)]
# tools/validate_kernel_ppo.py run_rppo_row("rppo_kernel"): IM backlog, periods 50
RPPO_RECIPE = dict(num_envs=1024, rollout_steps=50, num_minibatches=8, update_epochs=4,
                   rollout="kernel")
RPPO_BUDGET = 2_000_000
RPPO_EVAL_ENVS = 64
TPU_RPPO_REWARD = "+8,306.2 +- 15.5"  # tools/remeasure_logs/validate_kernel_ppo.jsonl:11
# benchmarks/benchmark_newsvendor.py:35-38 (the reference's evaluation config)
NV_ENV_CONFIG = {"lead_time": 5, "step_limit": 50, "p_max": 100.0, "h_max": 5.0,
                 "k_max": 10.0, "mu_max": 200.0}
NV_CASES = [(L, gamma, mu_max) for L in (5, 0) for gamma in (1.0, 0.99)
            for mu_max in (200.0, 3.0)]
DEMAND_SHARE = 0.9999        # Newsvendor demand draws equal to the plain version's
# K13's edges in phase 18: (lead time, lanes), ragged batches and the
# pipeline's depths 0 and NV_MAX_L, each its own instance
K13_EDGES = ((5, 1_000), (5, 1_025), (0, 1_000), (0, 1_025), (32, 1_025), (32, 65_536))
# a mu_max whose Poisson table (K = 2,005 floats a thread) no block of 32
# holds, so K14-K17 and K19/K20 count linearly; held at a small batch
NV_LINEAR_MU_MAX, NV_LINEAR_LANES = 30_000.0, 4_096
# K8's instances beside the default's three stocked stages (phase 10)
IM_CHAIN_M1 = (1, 2, 8)
# lead times of phase 10's chain of 8 stocked stages at lt_max 32 (the struct
# maxima, where tools/k9_k21_sweep.py times K9 too)
IM_MAXIMA_L = (3, 5, 10, 32) * 2
NORMAL_ROWS = 64             # K21's dump: 64 x 65,536 normals for the goodness-of-fit pin
# benchmarks/benchmark_newsvendor.py:46-47 PPO_CFG, for RESULTS.md:56's 4M env-steps
NV_PPO_RECIPE = dict(num_envs=256, rollout_steps=50, num_minibatches=8, update_epochs=4,
                     ent_coef=0.0, rollout="kernel")
NV_PPO_BUDGET = 4_000_000
# the off-policy learners (slice 7): SB3's default actor, every roster's OFF_CFG
# (off_policy.py:69); TD3/DDPG's exploration sigma
OFF_ARCH = (256, 256)
# an actor whose slice fits no cluster tile of K27/K28 (the wide route)
OFF_WIDE = (512, 512)
# the learners' lanes (TD3_RECIPE's num_envs): the main paths launch K27-K29
# at this shape
LEARN_LANES = 1_024
OFF_STD = 0.1
OFF_MODES = ("det", "sac", "uniform")
# K28/K29's det lanes free-running against the plain version are reported and
# held only this far: the float families feed every order back into the obs,
# so the 256-wide MLP's ulps grow over the episode (on an H100, K28 98.88% of
# a_norm and 91.41% of reward lanes agreed, K29 97.69% of a_norm); their
# per-element checks are teacher-forced
FLOAT_FREE_SHARE = 0.5
# tools/validate_kernel_collect.py run_row("td3", "kernel"), cut from 2M env-steps
TD3_RECIPE = dict(algo="td3", collect="kernel", num_envs=1024, buffer_size=200_704,
                  batch_size=256, updates_per_iter=32)
# 245,760 env-steps, 1 uniform warmup + 7 det iterations: its 960 updates an
# iteration are host-bound eager PyTorch, 8-15 ms each on an H100's host
TD3_ITERS = 8
TPU_TD3_REWARD = "+5,061.2 +- 29.1"  # tools/remeasure_logs/validate_kernel_collect.jsonl:10
# the xla path (phases 36-38): updates timed at PPO_CFG on each path (the
# first builds the model), PPOAgent's and A2CAgent's updates
XLA_RATE_UPDATES = 4
XLA_AGENT_UPDATES = 16
XLA_A2C_UPDATES = 8
# the recurrent xla path (phase 39): the roster's PPO_LSTM rows, each update
# timed (the first builds the model; the best of RPPO_RATE_UPDATES is kept)
RPPO_XLA_CASES = (
    ("InvManagement PPO_LSTM", "im", {"periods": 50},
     dict(num_envs=512, rollout_steps=50, num_minibatches=8),
     "benchmarks/benchmark_inv_management_backlog.py:80-83"),
    ("NetInvMgmt SB3_PPO-LSTM", "net", None,
     dict(num_envs=256, rollout_steps=30, num_minibatches=8),
     "benchmarks/benchmark_net_inv_backlog_combined.py:63-66"),
    ("Newsvendor", "nv", NV_ENV_CONFIG,
     dict(num_envs=256, rollout_steps=30, num_minibatches=8), "NetInvMgmt's shape"),
)
RPPO_RATE_UPDATES = 3
RPPO_AGENT_ENVS = 4_096       # phase 40: RecurrentPPOAgent on the kernel path
RPPO_AGENT_UPDATES = 3
# the seeded evaluators (phase 41): lanes a family, the permuted sub-batch
# held against them, and the seeds run on the card and on the CPU
SEEDED_LANES = 65_536
SEEDED_SUB = 1_000
SEEDED_CPU = 256
# demand draws equal on the card and the CPU: Newsvendor's inversion may move
# a draw by 1 at expf/logf ulps, held as against JAX (ROADMAP, departures)
SEEDED_DEMAND_SHARE = 0.999
# the off-policy xla path (phase 42): make_agent's SAC/TD3/DDPG config
# (agents/algo_registry.py), each iteration timed past the uniform warmup;
# beside TD3 on InvManagement, tools/validate_kernel_collect.py's config
OFF_XLA_RECIPE = dict(num_envs=32, buffer_size=100_000, batch_size=256, start_steps=1_000)
OFF_XLA_ITERS = 200
OFF_XLA_VKC = dict(num_envs=1024, buffer_size=200_704, batch_size=256, updates_per_iter=32)
OFF_XLA_VKC_ITERS = 20
# phase 43: make_agent's seven names, a family each, at a few updates
AGENT_NAMES = (("PPO", "Newsvendor-v0", 2), ("A2C", "InvManagementBacklog-v0", 2),
               ("SAC", "NetInvMgmtBacklog-v0", 40), ("TD3", "InvManagementBacklog-v0", 40),
               ("DDPG", "Newsvendor-v0", 40), ("PPO_LSTM", "InvManagementBacklog-v0", 1),
               ("A2C_LSTM", "NetInvMgmtBacklog-v0", 2))
# phase 44: the heuristic roster at HEUR_LANES lanes; HEUR_CPU lanes teacher-
# forced against the CPU; poisson_ppf's random points and its allowance (the
# card's float64 gammaincc may round a CDF at a quantile's edge otherwise)
HEUR_LANES = 65_536
HEUR_CPU = 1_024
PPF_POINTS = 1_000_000
PPF_ALLOWED = 10
NV_HEUR_SHARE = 0.9999
# RESULTS.md's rows on the reference protocol (first seed, episodes, the
# benchmark's env_config), rewards of the JAX package's seeded evaluator, not
# speeds: benchmark_newsvendor.py, benchmark_inv_management_backlog_combined.py
# (periods 50), benchmark_net_inv_backlog_combined.py (30 periods)
HEUR_PROTOCOL = {"nv": (2000, 30, NV_ENV_CONFIG, "RESULTS.md:67-70"),
                 "im": (9000, 30, {"periods": 50}, "RESULTS.md:144-148"),
                 "net": (11000, 10, {"num_periods": 30}, "RESULTS.md:180-181")}
HEUR_RESULTS = {"OrderUpTo_SF=0.8": "-106,568", "OrderUpTo_SF=1.0": "-138,709",
                "OrderUpTo_SF=1.2": "-170,849", "ClassicNV_SF=1.0_k_vs_h": "-140,622",
                "BaseStock_SF=1.0": "+5,251", "BaseStock_SF=0.8": "+3,076",
                "BaseStock_SF=1.2": "-29,775", "ConstantOrder_5%": "-2,610",
                "ConstantOrder_10%": "-5,760"}

# phases 45-47, the harness: the InvManagement backlog protocol (seeds from
# 4000, periods 50) on a cut roster through run_benchmark, its RL budget
# BENCH_KERNEL_UPDATES of PPO_Kernel's updates (1,024 x 50; PPO's 256 x 50
# takes four times as many), then the host protocol, then the vector env
BENCH_PROTOCOL = "benchmark_inv_management_backlog"
BENCH_ROSTER = ("Random", "BaseStock_SF=1.0", "PPO", "PPO_Kernel")
BENCH_EPISODES = 30
BENCH_KERNEL_UPDATES = 3
BENCH_HOST_SE = 4            # the host path's mean within 4 combined SE of the device path's
VEC_ENVS = 4_096


def close(name, got, want, rtol, atol):
    """Max |got - want|; raises unless every element is within tolerance."""
    import torch
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {int(bad.sum())} of {got.numel()} elements "
                             f"outside rtol={rtol} atol={atol}; max |diff| "
                             f"{float(err.max()):.6g}")
    return float(err.max())


def exact(name, got, want):
    if not (got.shape == want.shape and bool((got == want).all())):
        raise AssertionError(f"{name}: not equal bit for bit")


def lane_share(name, got, want, rtol=1e-4, atol=1e-2, need=LANE_SHARE):
    """(share of lanes, last axis, on which every element of ``got`` is
    within tolerance of ``want``; max |diff| over those lanes). Raises below
    ``need`` or on a non-finite value."""
    import torch
    err = (got.double() - want.double()).abs()
    ok = (err <= atol + rtol * want.double().abs()).reshape(-1, got.shape[-1]).all(0)
    share = float(ok.double().mean())
    if share < need or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {share:.4%} of lanes within rtol={rtol} "
                             f"atol={atol}, need {need:.0%}")
    return share, float(err.reshape(-1, got.shape[-1])[:, ok].max())


# ------------------------------------------------------------- work model

def step_ops(T):
    """Arithmetic operations of one period of step_view in
    csrc/net_step.cuh for topology T, an FMA counted as two: per reorder
    link the request (rint, max); with a main supplier the contention
    (avail's sub and max, the factory cap's product and two min, the min,
    consumed's division and add) and sold's add, else the raw material's
    -price * f (an FMA); Y, arrivals and, for L > 0, the ring slot; the
    holding term (max, FMA). Per main node X's update (two adds), HC (max,
    product), a factory's OC (product, division) and the total (two adds).
    Per retail link the fill (rint, max, add), the sale (max, min), X and
    sold, U, the revenue and penalty (product, FMA, add). The discount's
    FMA."""
    ops = 2 + 12 * T.n_retail
    for i, L in enumerate(T.ro_L):
        sup = T.ro_sup_main[i]
        ops += 2                                   # rint, max
        if sup >= 0:
            ops += 5 + (3 if T.is_factory[sup] else 0) + 1  # contention, sold
        else:
            ops += 2                               # -price * f
        ops += 3 + (2 if L > 0 else 0)             # Y, arrivals, ring slot
        ops += 3                                   # max + FMA of the holding term
    for n in range(T.n_main):
        ops += 2 + 2 + (2 if T.is_factory[n] else 0) + 2  # X, HC, OC, node total
    return ops


def draw_ops(T, link_specs):
    """Operations of draw_period in csrc/net_step.cuh for one period: the
    Philox blocks, the word conversions, and for each table link the binary
    search this table needs."""
    words = T.n_reorder + T.n_retail
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    for spec in link_specs:
        if spec[0] == "table":
            ops += 4 * math.ceil(math.log2(len(spec[2]) + 1)) + 2
        else:
            ops += 1
    return ops


def mlp_ops(dims):
    """Operations of one forward pass of the folded actor in
    csrc/net_policy.cu: an FMA per weight counted as two, a bias add per
    output, a tanh per hidden output (transcendentals counted as one)."""
    ops = sum(2 * a * b + b for a, b in zip(dims, dims[1:]))
    return ops + sum(dims[1:-1])


def lstm_gate_flops(dims, hidden):
    """FLOPs of one period's gate product G = W [E; H] (an FMA counted as
    two): 2 (enc + h) 4h."""
    return 2 * (dims[-1] + hidden) * 4 * hidden


def lstm_tc_flops(dims, hidden):
    """FLOPs of one period that csrc/lstm.cuh runs on the tensor cores: the
    gate product and each encoder layer's product, 2 in out (their bias
    adds and tanh stay on the FP32 cores)."""
    return lstm_gate_flops(dims, hidden) + sum(2 * a * b for a, b in zip(dims, dims[1:]))


def lstm_ops(dims, hidden, act_dim):
    """Operations of one period of the folded LSTM actor in csrc/lstm.cuh,
    an FMA counted as two and a transcendental as one: the encoder (a bias
    add and a tanh per output), the gates (``lstm_gate_flops`` and a bias
    per gate), the cell per unit (three sigmoids of an exp, an add and a
    division, two tanh, three products and a sum) and the mean head."""
    ops = sum(2 * a * b + 2 * b for a, b in zip(dims, dims[1:]))
    ops += lstm_gate_flops(dims, hidden) + 4 * hidden
    ops += hidden * (3 * 3 + 2 + 4)
    return ops + 2 * hidden * act_dim + act_dim


def policy_draw_ops(T, link_specs, stochastic):
    """Operations of one period's draws of the policy kernels: the Philox
    blocks, the word conversions, each table link's binary search, and per
    action the Box-Muller normal (log, sqrt, cos and five arithmetic ops)
    when stochastic, plus the squash (tanh, add, multiply)."""
    words = T.n_retail + (2 * T.n_reorder if stochastic else 0)
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    for spec in link_specs:
        ops += 4 * math.ceil(math.log2(len(spec[2]) + 1)) + 2 if spec[0] == "table" else 1
    return ops + T.n_reorder * ((8 if stochastic else 0) + 3)


def im_step_ops(params):
    """Operations of one period of im_step in csrc/im_step.cuh for params
    with m1 stocked stages: per stage the order (max, add, two min), the
    arrival (compare, slot, add), the decrement, the history store; per
    stage of m1 + 1 the profit (two products, two sums, two casts), the
    holding term (max, cast, product, sum) and the backlog; the retail
    sale, the slot and the discount."""
    m1 = params.m1
    return 4 * m1 + 3 * m1 + (m1 - 1) + m1 + 7 * (m1 + 1) + 4 * m1 + 4 + 2 + 2


def im_draw_ops(params, table_len):
    """Operations of one period's random-policy draws (im_draw_actions,
    im_demand): the Philox blocks of m1 + 1 words, the word conversions,
    per action a product, a cast and a min, and the binary search of this
    table (one load for USER mode)."""
    words = params.m1 + 1
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words + 3 * params.m1
    return ops + (4 * math.ceil(math.log2(table_len + 1)) + 2 if table_len else 1)


def im_policy_draw_ops(params, table_len, stochastic=True):
    """Operations of one period's draws and head in K10-K12: the Philox
    blocks of 1 (+ 2 m1 when stochastic) words, the conversions, the
    demand's binary search, the obs (m1 (lt + 1) casts), and per action,
    when stochastic, the Box-Muller normal (log, sqrt, cos and five
    arithmetic ops) and the sample, then the squash (tanh, add, product,
    cast)."""
    m1 = params.m1
    words = 1 + (2 * m1 if stochastic else 0)
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    ops += 4 * math.ceil(math.log2(table_len + 1)) + 2 if table_len else 1
    return ops + m1 * (params.lt_max + 1) + m1 * ((8 + 2 if stochastic else 0) + 4)


def nv_step_ops(params):
    """Operations of one period of nv_step in csrc/nv_step.cuh: the pipeline
    sum (L - 1 adds), the cap (sub, min, max), sales, excess and shortage
    (min, two subs, two max), the reward (four products, three subs), the
    ring store and head, the discount (product, sum) and the order's clip
    or product."""
    return max(params.lead_time - 1, 0) + 3 + 5 + 7 + 2 + 2 + 2


def nv_draw_ops(params, econ_drawn, table=True):
    """Operations per env-step of the in-kernel draws of K14-K17, as the
    kernel runs them: the period's Philox block and two word conversions,
    the threshold (sub, product); per episode the setup (~30 operations and
    K recurrence steps of 7: a Kahan sum of four, the quotient, the
    product, the decrement) and, when the econ is drawn, the reset's two
    Philox blocks, five conversions and formulas; spread over the episode's
    periods. With ``table`` (nv_table_setup/nv_table_invert), the setup
    also stores each S(k) and tracks m and the suffix's min and max (4 a
    step), and a period searches: ceil(log2 K) rounds of an address, a
    load, a compare and a select, the last probe and the suffix's two
    compares (the data's rare linear counts over the suffix not counted);
    without, the linear count of the first version (nv_poisson_invert, as
    K18 runs it, and K19/K20's first version): per chunk of 16 periods the K recurrence steps again
    and per period K compare-and-count pairs."""
    from or_gym_inventory_torch.ops import nv_poisson
    T = params.step_limit
    _, K, _ = nv_poisson.window(params)
    if table:
        per_episode = 30 + K * (7 + 4) + T * (4 * math.ceil(math.log2(K)) + 2 + 2)
    else:
        per_episode = math.ceil(T / 16) * K * 7 + T * K * 2 + 30 + K * 7
    if econ_drawn:
        per_episode += 2 * (10 * 8 + 9 * 2) + 5 * 3 + 7
    return (10 * 8 + 9 * 2) + 2 * 3 + 2 + per_episode / T


def nv_policy_draw_ops(params, stochastic, table=False):
    """Operations per env-step of the draws and the head of K18-K20:
    ``nv_draw_ops`` with the reset drawn (the three of its order word's
    conversion stand for the squash: tanh, add, product), by the linear
    count (K18, and K19/K20's first version) or, with ``table``, the search
    (K19/K20's tile: every period's demand searched at the reset), and,
    when stochastic, the period's Philox block again, two conversions, the
    Box-Muller normal (log, sqrt, cos and five arithmetic operations) and
    the sample (product, sum)."""
    return nv_draw_ops(params, True, table=table) + (
        (10 * 8 + 9 * 2) + 2 * 3 + 8 + 2 if stochastic else 0)


NORMAL_OPS = (10 * 8 + 9 * 2) + 2 * 3 + 8   # one K21 element: a Philox block, the normal


def random_action_ops(T):
    """Operations of one period's in-kernel actions of K26: the Philox
    blocks of the n_ro action words, and per word a shift, a conversion and
    a product."""
    return math.ceil(T.n_reorder / 4) * (10 * 8 + 9 * 2) + 3 * T.n_reorder


def offpolicy_work(name, params, obs_dim, act_dim, mode):
    """(bytes per lane, operations per env-step, horizon, bytes of the
    packed actor) of one K27-K29 launch under the ``det`` or ``sac`` head:
    the streams written once; the (256, 256) relu actor (``mlp_ops``, 2
    act_dim outputs for sac), the step, and the policy kernels' stochastic
    draws (the demand's and 2 act_dim head words, Box-Muller, the squash),
    plus per action the head's own operations (det: the clip's two; sac:
    exp and the clip's two, a product)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    dims = [obs_dim, *OFF_ARCH, 2 * act_dim if mode == "sac" else act_dim]
    weights = sum(a * b + b for a, b in zip(dims, dims[1:])) * 4
    per_step = mlp_ops(dims) + act_dim * (4 if mode == "sac" else 2)
    if name == "rollout_traj_im_offpolicy":
        T, m1 = params.periods, params.m1
        table_len = len(ek._im_demand_spec(params)[1])
        per_step += im_step_ops(params) + im_policy_draw_ops(params, table_len)
        n_bytes = ((T + 1) * m1 + 2 * T * m1 + 2 * T) * 4
    elif name == "rollout_traj_nv_offpolicy":
        T = params.step_limit
        per_step += nv_step_ops(params) + nv_policy_draw_ops(params, True)
        n_bytes = (5 + 4 * T) * 4
    else:
        topo, T = params.topology, params.num_periods
        per_step += step_ops(topo) + policy_draw_ops(topo, ns._topology_link_specs(topo, T),
                                                     True)
        n_bytes = ((T + 1) * (topo.n_main + topo.n_retail)
                   + T * (2 * topo.n_reorder + 1 + topo.n_retail)) * 4
    return n_bytes, per_step, T, weights


def bound(n_bytes, n_ops, n_tf32=0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak, ``n_ops`` at FP32 and
    ``n_tf32`` (the tensor-core products) at TF32."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / FP32_OPS_PER_S + n_tf32 / TF32_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_tc_flops(dims):
    """FLOPs of one forward pass that csrc/mlp_tile.cuh runs on the tensor
    cores (K5/K6, K11/K12): 2 in out per layer at the unpadded widths (the
    bias adds and tanh stay on the FP32 cores)."""
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


def tc_bound(n_bytes, n, ops, tc_flops):
    """The bound of a tensor-core kernel (K5/K6, K11/K12, K22-K24) for
    ``n`` env-steps of ``ops`` operations each: (the smaller of the two
    counts (ms, by), the FP32 count's ms): every operation at FP32, or the
    ``tc_flops`` of them that the kernel runs on the tensor cores
    (``mlp_tc_flops``, ``lstm_tc_flops``) as three TF32 products each and
    the rest at FP32."""
    fp32 = bound(n_bytes, n * ops)
    tc = bound(n_bytes, n * (ops - tc_flops), 3 * n * tc_flops)
    return min(fp32, tc), fp32[0]


# ------------------------------------------------------------------ phases

def reset_counts(wrappers):
    for ws in wrappers.values():
        for w in ws:
            w.launches = 0


def read_counts(wrappers):
    """Launches per kernel row: the sum over the row's wrappers (K7 has two,
    ``episode_returns_im`` and ``episode_returns_im_random``)."""
    return {name: sum(w.launches for w in ws) for name, ws in wrappers.items()}


class no_plain_versions:
    """Within the block, every plain version of K1-K29 (and the plain actors'
    ``lstm_forward``, ``mlp_forward`` and ``traj_policy``) raises, so a
    counted main-path run shows that it went through the kernels alone."""

    NAMES = {"net_step": ("_episode_returns_plain", "_episode_returns_fully_fused_plain",
                          "_sample_streams_plain", "_rollout_traj_plain",
                          "_policy_returns_plain", "_batched_step_plain",
                          "_episode_returns_random_policy_plain"),
             "episode_kernels": ("_episode_returns_im_plain", "_im_fused_plain",
                                 "_rollout_traj_im_plain", "_im_policy_plain",
                                 "_episode_returns_nv_plain", "_nv_fused_plain",
                                 "_rollout_traj_nv_plain", "_nv_policy_plain",
                                 "_sample_normals_plain", "_im_lstm_plain",
                                 "_rollout_traj_im_lstm_plain", "lstm_forward",
                                 "mlp_forward", "traj_policy")}

    def __enter__(self):
        import importlib

        def refuse(*_a, **_k):
            raise AssertionError("a plain version ran on the counted main path")

        self.saved = []
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(f"or_gym_inventory_torch.ops.{mod_name}")
            for n in names:
                self.saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, refuse)

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def ptxas_entries(out):
    """Each kernel of one source's ``ptxas -v`` output as "name<template
    flags> registers, stack frame" (and its spills, where it has any)."""
    rows, name, frame = [], None, ""
    for ln in out.splitlines():
        m = re.search(r"entry function '\w*?(k_[a-z0-9_]+?)(I(?:L[bi]n?\d+E)+E)?E", ln)
        if m:
            flags = ",".join(re.findall(r"L[bi](n?\d+)", m.group(2) or "")).replace("n", "-")
            name, frame = (f"{m.group(1)}<{flags}>" if flags else m.group(1)), ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and name:
            frame = f"{m.group(1)} B stack" + (
                f", spills {m.group(2)} B stored / {m.group(3)} B loaded"
                if m.group(2) != "0" or m.group(3) != "0" else "")
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name} {m.group(1)} registers, {frame or '? B stack'}")
            name = None
    return "; ".join(rows)


def sass_counts(so_path):
    """{kernel: (LDL, STL, HMMA)}: the local-memory loads and stores and the
    tensor-core instructions in the SASS of each kernel of one built
    library, from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    import pathlib

    from or_gym_inventory_torch.ops import _build
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", so_path], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : \S*?(k_[a-z0-9_]+?)(I(?:L[bi]n?\d+E)+E)?E", ln)
        if m:
            flags = ",".join(re.findall(r"L[bi](n?\d+)", m.group(2) or "")).replace("n", "-")
            name = m.group(1) + (f"<{flags}>" if flags else "")
            counts[name] = [0, 0, 0]
        elif name:
            for k, op in enumerate(("LDL", "STL", "HMMA")):
                if re.search(r"\b%s\b" % op, ln):
                    counts[name][k] += 1
    return {k: tuple(v) for k, v in counts.items()}


def tile_sass_check(logs):
    """Phase 2's check of the tile kernels: every instance of K4-K6
    (net_policy.cu ``k_policy_returns<STOCH,DUMP,TRAJ>``), of K10-K12
    (im_policy.cu ``k_im_policy_returns<STOCH,DUMP,TRAJ,BACKLOG>``) and of
    K18-K20 (nv_policy.cu ``k_nv_policy_returns<STOCH,DUMP,TRAJ,LAYOUT>``)
    holds HMMA instructions and spills nothing (ptxas, where this run built
    the library); the trajectory kernels' instances (``TRAJ_INSTANCES``:
    K4's ``<1,0,1>``, K10's ``<1,0,1,0/1>`` and K18's ``<1,0,1,0/1>``) must
    be there. K4-K6's and K18-K20's deterministic instances have no
    local-memory load or store and no stack. Their stochastic instances may
    keep the 32-byte frame of cosf's Payne-Hanek reduction (CUDA's library,
    for |x| > 105,615; the normals' argument 2 pi u stays below 2 pi, so it
    is never run), at most 8 LDL/STL. K18-K20's instances use at most
    ``_NV_TILE_REGS`` registers, which their plan counts. Returns the line
    to print; raises on a miss."""
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    parts = []
    for src, kernel in (("net_policy", "k_policy_returns"), ("im_policy", "k_im_policy_returns"),
                        ("nv_policy", "k_nv_policy_returns")):
        counts = sass_counts(str(_build._target(_build.CSRC / f"{src}.cu")))
        if counts is None:
            raise AssertionError("cuobjdump not found: the tile kernels' SASS cannot be read")
        mine = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
        log = next((out for so, out in logs.items() if f"lib{src}-" in so), "")
        ptx = [e for e in ptxas_entries(log).split("; ") if e.startswith(kernel + "<")]
        if not mine or any(h == 0 for _, _, h in mine.values()) or any("spills" in e for e in ptx):
            raise AssertionError(f"{kernel}: instances without HMMA or with spills {mine} {ptx}")
        missing = [k for k in TRAJ_INSTANCES[src] if k not in mine]
        if missing:
            raise AssertionError(f"the trajectory instances {missing} are not in {sorted(mine)}")
        if src != "im_policy":
            for name, (ld, st, _) in mine.items():
                stoch = name.startswith(kernel + "<1")
                frame = next((e for e in ptx if e.startswith(name + " ")), "0 B stack")
                stack = int(re.search(r"(\d+) B stack", frame).group(1))
                if ld + st > (8 if stoch else 0) or stack > (32 if stoch else 0):
                    raise AssertionError(f"{name}: {ld} LDL / {st} STL, {frame}")
        if src == "nv_policy":
            regs = [int(r) for r in re.findall(r"%s<[\d,]+> (\d+) registers" % kernel,
                                               "; ".join(ptx))]
            if ptx and (not regs or max(regs) > ek._NV_TILE_REGS):
                raise AssertionError(f"{kernel}: its instances use {regs} registers; "
                                     f"_nv_tile_plan counts {ek._NV_TILE_REGS}")
        parts.append(f"{src}.cu {kernel} (LDL/STL/HMMA) " + ", ".join(
            f"{k} {ld}/{st}/{h}" for k, (ld, st, h) in sorted(mine.items()))
            + "; ptxas " + "; ".join(ptx))
    return "; ".join(parts)


def cluster_check(logs):
    """Phase 2's check of K27-K29 on the thread-block cluster (im_policy.cu
    ``k_im_rollout_traj_cluster<RELU,BACKLOG>``, nv_policy.cu
    ``k_nv_rollout_traj_cluster<RELU>``, net_policy.cu
    ``k_rollout_traj_cluster<RELU>``): every instance built, none spills
    (ptxas, where this run built the library), and none holds a tensor-core
    instruction (the products run on the FP32 cores). Returns the line to
    print; raises on a miss."""
    from or_gym_inventory_torch.ops import _build
    parts = []
    for src, kernel, want in (("im_policy", "k_im_rollout_traj_cluster", 4),
                              ("nv_policy", "k_nv_rollout_traj_cluster", 2),
                              ("net_policy", "k_rollout_traj_cluster", 2)):
        counts = sass_counts(str(_build._target(_build.CSRC / f"{src}.cu")))
        if counts is None:
            raise AssertionError("cuobjdump not found: the cluster kernels' SASS cannot be read")
        mine = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
        log = next((out for so, out in logs.items() if f"lib{src}-" in so), "")
        ptx = [e for e in ptxas_entries(log).split("; ") if e.startswith(kernel + "<")]
        if (len(mine) != want or (ptx and len(ptx) != want) or any("spills" in e for e in ptx)
                or any(h for _, _, h in mine.values())):
            raise AssertionError(f"{kernel}: {len(mine)} instances (want {want}), "
                                 f"LDL/STL/HMMA {mine}, ptxas {ptx}")
        parts.append(f"{src}.cu {kernel} (LDL/STL/HMMA) " + ", ".join(
            f"{k} {ld}/{st}/{h}" for k, (ld, st, h) in sorted(mine.items()))
            + "; ptxas " + "; ".join(ptx))
    return "; ".join(parts)


def k8_frame_check(logs):
    """Phase 2's check of K8 (im_episode.cu ``k_im_returns_fused<BACKLOG,
    M1>``): an instance for each m1 from 1 to IM_MAX_M1 in backlog and lost
    sales, none with a stack frame or a local-memory load or store (its
    state in registers and shared memory), each within the registers
    ``_im_fused_plan`` counts for its m1 (``_IM_FUSED_REGS``). Returns the
    line to print; raises on a miss."""
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    kernel = "k_im_returns_fused"
    counts = sass_counts(str(_build._target(_build.CSRC / "im_episode.cu")))
    if counts is None:
        raise AssertionError("cuobjdump not found: K8's SASS cannot be read")
    mine = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
    log = next((out for so, out in logs.items() if "libim_episode-" in so), "")
    ptx = [e for e in ptxas_entries(log).split("; ") if e.startswith(kernel + "<")]
    for entry in ptx:
        m = re.match(r"%s<\d,(\d+)> (\d+) registers, (\d+) B stack" % kernel, entry)
        cap = ek._IM_FUSED_REGS.get(int(m.group(1)), 0) if m else 0
        if m is None or int(m.group(3)) or "spills" in entry or int(m.group(2)) > cap:
            raise AssertionError(f"K8 {entry}: a stack frame, spills or more than {cap} registers")
    want = 2 * ek.IM_MAX_M1
    if len(mine) != want or (ptx and len(ptx) != want):
        raise AssertionError(f"K8: {len(mine)} instances in the SASS, {len(ptx)} in ptxas; "
                             f"want one for each m1 in backlog and lost sales, {want}")
    if any(ld + st for ld, st, _ in mine.values()):
        raise AssertionError(f"K8: local-memory loads or stores {mine}")
    return ("im_episode.cu k_im_returns_fused (LDL/STL) " + ", ".join(
        f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(mine.items())) + "; ptxas "
            + "; ".join(ptx))


def frame_free_check(logs, src, prefix, want, name):
    """Phase 2's check that ``src``.cu holds ``want`` kernels whose names
    start with ``prefix``, none with a stack frame (ptxas, where this run
    built the library), a spill or a local-memory load or store (SASS).
    Returns the part of the line to print; raises on a miss."""
    from or_gym_inventory_torch.ops import _build
    counts = sass_counts(str(_build._target(_build.CSRC / f"{src}.cu")))
    if counts is None:
        raise AssertionError(f"cuobjdump not found: {name}'s SASS cannot be read")
    mine = {k: v for k, v in counts.items() if k.startswith(prefix)}
    log = next((out for so, out in logs.items() if f"lib{src}-" in so), "")
    ptx = [e for e in ptxas_entries(log).split("; ") if e.startswith(prefix)]
    for entry in ptx:
        if not re.match(r"\S+ \d+ registers, 0 B stack$", entry):
            raise AssertionError(f"{name} {entry}: a stack frame or spills")
    if len(mine) != want or (ptx and len(ptx) != want):
        raise AssertionError(f"{name}: {len(mine)} instances in the SASS, {len(ptx)} in "
                             f"ptxas; want {want}")
    if any(ld + st for ld, st, _ in mine.values()):
        raise AssertionError(f"{name}: local-memory loads or stores {mine}")
    return (f"{src}.cu {prefix.rstrip('<')} (LDL/STL) " + ", ".join(
        f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(mine.items())) + "; ptxas "
            + "; ".join(ptx))


def k7_frame_check(logs):
    """Phase 2's check of K7 (im_episode.cu ``k_im_returns<BACKLOG, RANDOM,
    M1>``, K8's episode body with its streams staged by cp.async): an
    instance for each m1 from 1 to IM_MAX_M1 in backlog and lost sales,
    streamed and _random, none with a stack frame, a spill or a
    local-memory load or store (``frame_free_check``)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    return frame_free_check(logs, "im_episode", "k_im_returns<", 4 * ek.IM_MAX_M1, "K7")


def k9_k21_frame_check(logs):
    """Phase 2's check of K9 (im_episode.cu ``k_im_sample_streams<M1>``, an
    instance for each m1 from 1 to IM_MAX_M1) and K21 (nv_policy.cu
    ``k_sample_normals``), both on 2-D grids: none with a stack frame, a
    spill or a local-memory load or store (``frame_free_check``; K21's one
    copy of normal01 keeps cosf's never-run reduction out of a frame)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    return "; ".join((
        frame_free_check(logs, "im_episode", "k_im_sample_streams<", ek.IM_MAX_M1, "K9"),
        frame_free_check(logs, "nv_policy", "k_sample_normals", 1, "K21")))


def k13_frame_check(logs):
    """Phase 2's check of K13 (nv_episode.cu ``k_nv_returns<RANDOM, L>``,
    its pipeline in registers, its streams staged by cp.async): an instance
    for each mode and each lead time from 0 to NV_MAX_L, none with a stack
    frame, a spill or a local-memory load or store (``frame_free_check``)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    return frame_free_check(logs, "nv_episode", "k_nv_returns<", 2 * (ek.NV_MAX_L + 1), "K13")


def net_episode_frame_check(logs, local):
    """Phase 2's check of net_episode.cu's kernels, K1 ``k_episode_returns``
    and K25 ``k_batched_step`` (their state in shared memory since they
    left the thread's Episode frame) with K2, K3 and K26: none has a stack
    frame (ptxas, where this run built the library) or a local-memory load
    or store in its SASS (``local``, sass_counts of net_episode.cu).
    Returns the line to print; raises on a miss."""
    kernels = ("k_episode_returns", "k_batched_step", "k_episode_returns_fused",
               "k_sample_streams", "k_episode_returns_random")
    if local is None:
        raise AssertionError("cuobjdump not found: K1's and K25's SASS cannot be read")
    log = next((out for so, out in logs.items() if "libnet_episode-" in so), "")
    ptx = {e.split(" ")[0]: e for e in ptxas_entries(log).split("; ") if e}
    parts = []
    for k in kernels:
        entry = ptx.get(k)
        if k not in local or (log and entry is None):
            raise AssertionError(f"{k}: not in net_episode.cu's build")
        ld, st, _ = local[k]
        if ld or st or (entry and (" 0 B stack" not in entry or "spills" in entry)):
            raise AssertionError(f"{k}: {ld} LDL / {st} STL, {entry}: a local frame")
        parts.append(f"{k} {ld}/{st} LDL/STL" + (f", {entry.split(' ', 1)[1]}" if entry else ""))
    return "; ".join(parts)


def k2_graph_check(dev):
    """Phase 6: K2 on ``topology.two_retail_topology`` at 65,536 x 4 x 30, backlog and
    lost sales, against plain K2 on the same seed, rtol=1e-5 atol=1e-3: the
    shared layout's offsets on another graph than the default. Returns
    (max |diff|, lines)."""
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import topology
    from or_gym_inventory_torch.ops import net_step as ns
    worst, lines = 0.0, []
    for backlog in (True, False):
        params = net.default_params(topology=topology.two_retail_topology(NUM_STEPS),
                                    num_periods=NUM_STEPS, backlog=backlog)
        T = params.topology
        hi = float(T.order_cap_heuristic * 2)
        got = ns.episode_returns_fully_fused(params, SEED, hi, CHECK_LANES,
                                             episodes_per_lane=4, device=dev)
        want = ns._episode_returns_fully_fused_plain(params, SEED, hi, CHECK_LANES,
                                                     NUM_STEPS, 4, dev)
        case = "backlog" if backlog else "lost sales"
        e = close(f"K2 vs plain K2, two-retail graph, {case}", got, want, 1e-5, 1e-3)
        worst = max(worst, e)
        plan, _ = ns._shared_layout(T)
        lines.append(f"two-retail graph ({case}; n_main {T.n_main}, n_ro {T.n_reorder}, "
                     f"n_rt {T.n_retail}, lead times {T.ro_L}; {plan.words} words a thread): "
                     f"{CHECK_LANES} x 4 x {NUM_STEPS} within rtol=1e-5 atol=1e-3 of plain K2, "
                     f"max |diff| {e:.6g}")
    return worst, lines


def k1_kernel_launch(params, acts, dems, dev):
    """A launch of K1 alone on ``acts``/``dems``: the C entry point with the
    plan, the discounts and the output made before, as the entry point
    makes them (host work out of the timing). Returns (launch, its output)."""
    import ctypes

    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    T = params.topology
    num_steps, _, B = acts.shape
    tp, disc, _ = ns._launch_plan(params, num_steps, ek._plan_key(dev), False)
    _, lay, st = ns._k1_layout(T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    args = (ctypes.addressof(tp), ctypes.addressof(lay), ctypes.addressof(st), acts.data_ptr(),
            dems.data_ptr(), disc.data_ptr(), out.data_ptr(), B, num_steps, ek._stream(dev))

    def launch():
        ek._launch("net_episode", "net_episode_returns", *args)
    return launch, out


def k3_kernel_launch(params, act_hi, dev):
    """A launch of K3 alone at the main path's shape (``CHECK_LANES`` x
    ``NUM_STEPS``, one episode, seed ``SEED``): the C entry point with the
    plan and the outputs made before, as the entry point makes them. Returns
    (launch, (actions, demands))."""
    import ctypes

    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    T = params.topology
    tp, _, tab = ns._launch_plan(params, NUM_STEPS, ek._plan_key(dev), True)
    f32 = dict(dtype=torch.float32, device=dev)
    acts = torch.empty((NUM_STEPS, T.n_reorder, CHECK_LANES), **f32)
    dems = torch.empty((NUM_STEPS, T.n_retail, CHECK_LANES), **f32)
    args = (ctypes.addressof(tp), tab.data_ptr(), acts.data_ptr(), dems.data_ptr(), SEED,
            ns._act_scale(act_hi), CHECK_LANES, NUM_STEPS, 0, 1, ek._stream(dev))

    def launch():
        ek._launch("net_episode", "net_sample_streams", *args)
    return launch, (acts, dems)


def k7_kernel_launch(params, acts, dems, seed, dev):
    """A launch of K7 alone on ``dems`` and ``acts`` (None: _random on
    ``seed``): the C entry point with the plan, the discounts and the output
    made before, as the entry point makes them. Returns (launch, output)."""
    import ctypes

    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    T, B = dems.shape
    plan = ek._im_plan(params, ek._plan_key(dev), False)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    args = (ctypes.addressof(plan["struct"]), ctypes.addressof(plan["k7"]),
            None if acts is None else acts.data_ptr(), dems.data_ptr(), plan["disc"].data_ptr(),
            out.data_ptr(), seed or 0, int(acts is None), int(params.backlog), B, T,
            ek._stream(dev))

    def launch():
        ek._launch("im_episode", "im_episode_returns", *args)
    return launch, out


def k13_kernel_launch(params, econ, acts, dems, seed, dev):
    """A launch of K13 alone on ``econ``, ``dems`` and ``acts`` (None:
    _random on ``seed``): the C entry point with the plan, the discounts
    and the output made before, as the entry point makes them. Returns
    (launch, output)."""
    import ctypes

    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    T, B = dems.shape
    plan = ek._nv_plan(params, ek._plan_key(dev))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    args = (ctypes.addressof(plan["struct"]), econ.data_ptr(),
            None if acts is None else acts.data_ptr(), dems.data_ptr(), plan["disc"].data_ptr(),
            out.data_ptr(), seed or 0, int(acts is None), B, T, ek._stream(dev))

    def launch():
        ek._launch("nv_episode", "nv_episode_returns", *args)
    return launch, out


def timed_once(fn, *args):
    """(milliseconds between CUDA events around one call, its result)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def cross_check(params, dev):
    """Phase 3, the main path's cross-check (bench.py:79-161): the fused
    kernel against the stream-in kernel on its own dumped streams, bit for
    bit, at one episode per lane and at E=16 dumped in ranges of 8, and the
    env step chain on the same streams. Every kernel output is also held against its
    plain version on the same inputs. Returns the max |diff| per kernel, the
    streams, which phase 6 times the kernels on, and K1's launches by its
    lanes."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import net_step as ns
    hi = float(params.topology.order_cap_heuristic * 2)
    err, k1_lanes = {}, {}

    def k1(a, d):   # K1, its launch counted by its lanes
        k1_lanes[a.shape[-1]] = k1_lanes.get(a.shape[-1], 0) + 1
        return ns.episode_returns(params, a, d)

    acts, dems = ns.sample_streams_debug(params, SEED, hi, CHECK_LANES, device=dev)
    pa, pd = ns._sample_streams_plain(params, SEED, hi, CHECK_LANES, NUM_STEPS, 0, 1, dev)
    exact("K3 actions", acts, pa.reshape(acts.shape))
    exact("K3 demands", dems, pd.reshape(dems.shape))
    err["sample_streams_debug"] = 0.0
    r1 = k1(acts, dems)
    err["episode_returns"] = close("K1 vs plain K1", r1,
                                   ns._episode_returns_plain(params, acts, dems),
                                   1e-5, 1e-3)
    k2 = ns.episode_returns_fully_fused(params, SEED, hi, CHECK_LANES, device=dev)
    exact("K2 vs K1 on K3's streams", k2, r1)   # one episode body, one order of sums
    err["episode_returns_fully_fused"] = close(
        "K2 vs plain K2", k2, ns._episode_returns_fully_fused_plain(
            params, SEED, hi, CHECK_LANES, NUM_STEPS, 1, dev)[0], 1e-5, 1e-3)

    E = MAIN_EPISODES
    multi = ns.episode_returns_fully_fused(params, SEED, hi, MULTI_LANES,
                                           episodes_per_lane=E, device=dev)
    plain_multi = ns._episode_returns_fully_fused_plain(params, SEED, hi, MULTI_LANES,
                                                        NUM_STEPS, E, dev)
    err["episode_returns_fully_fused"] = max(
        err["episode_returns_fully_fused"],
        close("K2 vs plain K2, E=16", multi, plain_multi, 1e-5, 1e-3))
    for e0 in range(0, E, 8):
        a_e, d_e = ns.sample_streams_debug(params, SEED, hi, MULTI_LANES,
                                           episodes_per_lane=E, dump_range=(e0, e0 + 8),
                                           device=dev)
        pa_e, pd_e = ns._sample_streams_plain(params, SEED, hi, MULTI_LANES, NUM_STEPS,
                                              e0, e0 + 8, dev)
        exact(f"K3 actions, episodes [{e0}, {e0 + 8})", a_e, pa_e)
        exact(f"K3 demands, episodes [{e0}, {e0 + 8})", d_e, pd_e)
        for e in range(e0, e0 + 8):
            per = k1(a_e[:, e - e0].contiguous(), d_e[:, e - e0].contiguous())
            exact(f"K2 episode {e} vs K1", multi[e], per)

    state, _ = net.reset(params, batch=CHECK_LANES, device=dev)
    chain = torch.zeros(CHECK_LANES, dtype=torch.float32, device=dev)
    for t in range(NUM_STEPS):
        state, ts = net.step_with_demand(params, state, acts[t].T, dems[t].T)
        chain = chain + ts.reward
    close("env step chain vs K1", chain, r1, 1e-4, 1e-2)
    torch.cuda.synchronize()
    return err, acts, dems, k1_lanes


def episode_returns_at_scale(params, dev, err, wrappers):
    """Phase 4, random-policy returns at the operating point through
    ``random_episode_returns``, which must launch K2 once, nothing else and
    no plain version, held element by element against plain K2 on the same
    seed. Returns the plain version's milliseconds."""
    import torch

    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.vector import fast_episodes
    gen = torch.Generator(device=dev).manual_seed(0)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    before = read_counts(wrappers)
    with no_plain_versions():
        ret = fast_episodes.random_episode_returns(params, gen, MAIN_LANES,
                                                   episodes_per_lane=MAIN_EPISODES,
                                                   device=dev)
        torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in read_counts(wrappers).items() if c != before[n]}
    if moved != {"episode_returns_fully_fused": 1}:
        raise AssertionError(f"main path: random_episode_returns launched {moved}, not K2 once")
    if ret.shape != (MAIN_LANES * MAIN_EPISODES,):
        raise AssertionError(f"main path: returns of shape {tuple(ret.shape)}")
    hi = float(params.topology.order_cap_heuristic * 2)
    plain_ms, plain = timed_once(ns._episode_returns_fully_fused_plain, params,
                                 fast_episodes.kernel_seed(replay), hi, MAIN_LANES,
                                 NUM_STEPS, MAIN_EPISODES, dev)
    err["episode_returns_fully_fused"] = max(
        err["episode_returns_fully_fused"],
        close("main path: K2 vs plain K2", ret, plain.reshape(-1), 1e-5, 1e-3))
    mean = float(ret.double().mean())
    del ret, plain
    return mean, plain_ms


def seeded_actor(obs_dim, act_dim, dev):
    """Phases 7 and 12's actor: the default 64x64 actor-critic of
    (obs_dim, act_dim) drawn from its own initialisation, and obs statistics
    with mean ~50 and std ~20 folded into its first layer. Returns (folded
    actor, log_std), on ``dev``."""
    import torch

    from or_gym_inventory_torch.agents import networks, ppo
    from or_gym_inventory_torch.ops import episode_kernels as ek
    g = torch.Generator().manual_seed(SEED)
    model = networks.MLPActorCritic(obs_dim, act_dim, generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(obs_dim, generator=g),
                             var=(20.0 + 5.0 * torch.rand(obs_dim, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = ek.fold_actor_params(ppo.PPOConfig(), model, rms)
    actor = (tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs))
    return actor, model.log_std.detach().to(dev)


def policy_cross_check(params, dev, actor, log_std):
    """Phase 7: K4-K6 against their plain versions at the main path's shapes
    (65,536 lanes x 30 periods; K5/K6 at 16 episodes per lane,
    deterministic and stochastic), K4's streams replayed teacher-forced
    through K1, the env step chain and the folded actor, and the NaN lane
    of the shared step. Returns (max |diff| per kernel, plain ms per
    kernel)."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.ops import rng
    T = params.topology
    B, E = CHECK_LANES, EVAL_EPISODES
    std = ek.clipped_std(log_std)
    err, plain_ms, lines = {}, {}, []

    # K4, free-running against its plain version
    tr = ns.rollout_traj_net(params, actor, log_std, SEED, B, device=dev)
    plain_ms["rollout_traj_net"], want = timed_once(
        ns._rollout_traj_plain, params, actor, std, SEED, B, dev)
    exact("K4 demand", tr["demand"], want["demand"])
    shares = {k: lane_share(f"K4 {k} vs plain", tr[k], want[k]) for k in tr}
    err["rollout_traj_net"] = max(e for _, e in shares.values())
    lines.append("K4 vs plain: lanes agreeing " + ", ".join(
        f"{k} {sh:.4%}" for k, (sh, _) in shares.items()))
    del want

    # K4, teacher-forced: its own streams through K1, the step chain, the actor
    acts = (torch.tanh(tr["raw"]) + 1.0) * ns._half_hi(T)
    close("K1 on K4's streams vs K4 rewards",
          ns.episode_returns(params, acts.contiguous(), tr["demand"]),
          tr["reward"].sum(0), 1e-5, 1e-3)
    state, _ = net.reset(params, batch=B, device=dev)
    for t in range(NUM_STEPS):
        close(f"step chain X[{t}] vs K4 x", state.X.T, tr["x"][t], 1e-4, 1e-2)
        close(f"step chain U[{t}] vs K4 u", state.U.T, tr["u"][t], 1e-4, 1e-2)
        state, ts = net.step_with_demand(params, state, acts[t].T, tr["demand"][t].T)
        close(f"step chain r[{t}] vs K4 r", ts.info["fulfilled_orders"].T, tr["r"][t],
              1e-4, 1e-2)
    close("step chain final X vs K4 x", state.X.T, tr["x"][NUM_STEPS], 1e-4, 1e-2)
    obs = net.assemble_obs_from_streams(params, tr["x"], tr["u"], tr["r"])
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    n_rt, n_ro = T.n_retail, T.n_reorder
    for t in range(NUM_STEPS):
        w = rng.period_words(SEED, lanes, 0, t, n_rt + 2 * n_ro, key1=rng.POLICY_KEY)
        z = rng.normal01(torch.stack(w[n_rt:n_rt + n_ro]), torch.stack(w[n_rt + n_ro:]))
        close(f"K4 raw[{t}] vs folded actor + plain normals", tr["raw"][t],
              ek.folded_actor_mean(actor, obs[t]).T + std * z, 0.0, 1e-4)
    lines.append("K4 teacher-forced: K1, the step chain and the folded actor "
                 "reproduce its streams")

    # the NaN lane: K1 and plain K1 both give NaN there and agree elsewhere
    nan_acts = acts.clone()
    nan_lane = B // 3
    nan_acts[7, 3, nan_lane] = float("nan")
    k1 = ns.episode_returns(params, nan_acts, tr["demand"])
    p1 = ns._episode_returns_plain(params, nan_acts, tr["demand"])
    nan_k, nan_p = torch.isnan(k1), torch.isnan(p1)
    if nan_k.nonzero().flatten().tolist() != [nan_lane] or not torch.equal(nan_k, nan_p):
        raise AssertionError(f"NaN lane: K1 NaN at {nan_k.nonzero().flatten()[:5].tolist()}"
                             f", plain at {nan_p.nonzero().flatten()[:5].tolist()}")
    keep = ~nan_k
    close("K1 vs plain K1 beside the NaN lane", k1[keep], p1[keep], 1e-5, 1e-3)
    lines.append("NaN action: K1 and plain K1 NaN in that lane only, equal elsewhere")
    k4_acts, k4_dem = acts, tr["demand"]   # for the stochastic K6's episode 0 below
    del tr, acts, nan_acts, obs

    # K5 and K6, deterministic and stochastic, E episodes per lane
    err["episode_returns_net_policy"] = err["sample_policy_streams_debug_net"] = 0.0
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        k5 = ns.episode_returns_net_policy(params, actor, SEED, B, episodes_per_lane=E,
                                           log_std=ls, device=dev)
        k6, a6, d6 = ns.sample_policy_streams_debug_net(
            params, actor, SEED, B, episodes_per_lane=E, log_std=ls, device=dev)
        pstd = None if ls is None else std
        ms5, (want, _, _) = timed_once(ns._policy_returns_plain, params, actor, pstd,
                                       SEED, B, E, dev, False)
        ms6, (_, _, want_d) = timed_once(ns._policy_returns_plain, params, actor, pstd,
                                         SEED, B, E, dev, True)
        if ls is None:
            plain_ms["episode_returns_net_policy"] = ms5
            plain_ms["sample_policy_streams_debug_net"] = ms6
        exact(f"K6 demand, {kind}", d6, want_d)
        if ls is not None:   # K4 draws the words of the stochastic K5/K6's episode 0
            exact("stochastic K6 episode 0 demand vs K4", d6[:, 0], k4_dem)
            share4, _ = lane_share("stochastic K6 episode 0 actions vs K4's squashed raws",
                                   a6[:, 0], k4_acts)
            lines.append(f"stochastic K6 episode 0 vs K4 on the same seed and actor: demand "
                         f"bit-exact, actions agreeing on {share4:.4%} of lanes, bit for bit: "
                         f"{torch.equal(a6[:, 0], k4_acts)}")
            del k4_acts, k4_dem
        err["sample_policy_streams_debug_net"] = max(
            err["sample_policy_streams_debug_net"],
            close(f"K6 vs K5 returns, {kind}", k6, k5, 1e-5, 1e-3))
        replay = ns.episode_returns(
            params, a6.permute(0, 2, 1, 3).reshape(NUM_STEPS, n_ro, E * B).contiguous(),
            d6.permute(0, 2, 1, 3).reshape(NUM_STEPS, n_rt, E * B).contiguous())
        close(f"K1 on K6's streams vs K5, {kind}", replay.reshape(E, B), k5, 1e-5, 1e-3)
        share, e5 = lane_share(f"K5 vs plain, {kind}", k5, want)
        err["episode_returns_net_policy"] = max(err["episode_returns_net_policy"], e5)
        lines.append(f"K5/K6 {kind}, {B} x {E}: K6 demand bit-exact, K1 replays "
                     f"K6's streams, {share:.4%} of lanes agree with plain K5")
        del k5, k6, a6, d6, want, want_d, replay
    lines += tile_edge_cases("net", params, dev, actor, log_std)
    torch.cuda.synchronize()
    return err, plain_ms, lines


RAGGED = (1_000, 3)   # B x E of the tile kernels' ragged launch: no multiple of a warp


def nan_weight_actor(actor, layer=1):
    """``actor`` with W[5, 1] of ``layer`` set to the canonical NaN
    0x7fffffff (what CUDA's arithmetic produces; the wrappers write it as the
    quiet NaN the TF32 split keeps)."""
    import torch
    Ws = [W.clone() for W in actor[0]]
    Ws[layer][5, 1] = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)[0]
    return tuple(Ws), actor[1]


def tile_edge_cases(family, params, dev, actor, log_std):
    """K5/K6 (``family`` "net") or K11/K12 ("im") on the tile's edges, each
    against its plain version: a ragged batch (``RAGGED``), deterministic
    and stochastic, by the share of lanes; and a NaN weight in the hidden
    layer 1, whose NaN raws reach every action: K5's actions all NaN as
    the plain version's, K11's all 0 (the cast of a NaN) as its, the
    demand bit for bit. Returns the lines to print."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    if family == "net":
        run, plain, label = ns.sample_policy_streams_debug_net, ns._policy_returns_plain, "K5/K6"
    else:
        run, plain, label = ek.sample_policy_streams_debug_im, ek._im_policy_plain, "K11/K12"
    b, e = RAGGED
    lines = []
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        ret, acts, dems = run(params, actor, SEED, b, e, ls, dev)
        want, want_a, want_d = plain(params, actor, None if ls is None else ek.clipped_std(ls),
                                     SEED, b, e, dev, True)
        exact(f"{label} ragged demand, {kind}", dems, want_d)
        share, _ = lane_share(f"{label} ragged {b} x {e}, {kind}", ret, want)
        share_a, _ = lane_share(f"{label} ragged actions, {kind}",
                                acts.transpose(1, 2).reshape(-1, e * b),
                                want_a.transpose(1, 2).reshape(-1, e * b))
        lines.append(f"{label} ragged {b} x {e} ({b * e % 64} pairs in the last tile), {kind}: "
                     f"demand bit-exact, lanes agreeing with plain {share:.4%} (returns), "
                     f"{share_a:.4%} (actions)")
    bad = nan_weight_actor(actor)
    ret, acts, dems = run(params, bad, SEED, 4_096, 2, None, dev)
    want, want_a, want_d = plain(params, bad, None, SEED, 4_096, 2, dev, True)
    exact(f"{label} NaN weight demand", dems, want_d)
    if family == "net":
        if not (torch.isnan(acts).all() and torch.isnan(want_a).all()):
            raise AssertionError(f"{label} NaN weight: actions not all NaN")
    elif not (int(acts.abs().max()) == 0 and torch.equal(acts, want_a)):
        raise AssertionError(f"{label} NaN weight: actions not the plain version's zeros")
    lines.append(f"{label} NaN weight (0x7fffffff in layer 1): NaN raws, actions "
                 f"{'NaN' if family == 'net' else '0'} as the plain version's, demand bit-exact")
    return lines


def ppo_main_path(env, params, dev, smi, label, kernel, num_steps=NUM_STEPS):
    """Phases 8, 13 and 22: ``train`` with ``rollout="kernel"`` at 65,536
    envs x ``num_steps`` periods (the env's horizon), 64x64, 4 epochs x 8
    minibatches, 3 updates, no plain version allowed; ``kernel``, the
    trajectory kernel's wrapper, must launch once per update (its count set
    to 0 just before). Returns (lines, best update ms, (cfg, state,
    generator), rates for the summary)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    cfg = ppo.PPOConfig(num_envs=PPO_ENVS, rollout_steps=num_steps, num_minibatches=8,
                        update_epochs=4, pi_arch=(64, 64), vf_arch=(64, 64),
                        rollout="kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with no_plain_versions():
        state, metrics = ppo.train(env, params, cfg, gen,
                                   PPO_UPDATES * PPO_ENVS * num_steps, device=dev,
                                   progress=progress)
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != PPO_UPDATES:
        raise AssertionError(f"{label} PPO metrics not finite: {bad}; {metrics}")
    if kernel.launches != PPO_UPDATES:
        raise AssertionError(f"{kernel.__name__} launched {kernel.launches} times in "
                             f"{PPO_UPDATES} updates")
    update_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    best = min(update_ms[1:])     # the first update also builds the model
    samples = PPO_ENVS * num_steps
    lines = [f"{label} PPO {PPO_ENVS} x {num_steps}, 64x64, 4 epochs x 8 minibatches: "
             f"update ms {', '.join(f'{t:.3f}' for t in update_ms)}; best {best:.3f} ms = "
             f"{samples / best * 1e3:.6g} trained-steps/s on {smi}",
             f"{label} PPO metrics: " + "; ".join(f"{k} {', '.join(f'{x:.6g}' for x in v)}"
                                                  for k, v in metrics.items())]
    rates = {"update_ms": best, "trained_steps_s": samples / best * 1e3}
    return lines, best, (cfg, state, gen), rates


def evaluate_trained(params, dev, smi, trained):
    """Phase 8, after the NetInvMgmt ``train``: the trained actor's
    ``policy_episode_returns`` at 65,536 x 16, deterministic and stochastic,
    no plain version allowed. Returns (lines, folded actor, log_std, the
    deterministic returns, the kernel seed they came from, rates)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    cfg, state, _ = trained
    actor = ek.fold_actor_params(cfg, state.params, state.rms)
    log_std = state.params.log_std.detach()
    E = EVAL_EPISODES
    env_steps = PPO_ENVS * E * NUM_STEPS
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    replay_gen = torch.Generator(device=dev)
    replay_gen.set_state(g.get_state())
    with no_plain_versions():
        det_ms, det = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, True, None, dev)
        sto_ms, sto = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, False, log_std, dev)
    for name, ret in (("deterministic", det), ("stochastic", sto)):
        if ret.shape != (PPO_ENVS * E,) or not torch.isfinite(ret).all():
            raise AssertionError(f"{name} evaluation: shape {tuple(ret.shape)} or non-finite")
    lines = [f"policy_episode_returns {PPO_ENVS} x {E} x {NUM_STEPS}: deterministic "
             f"{det_ms:.3f} ms = {env_steps / det_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(det.double().mean()):.3f}; stochastic {sto_ms:.3f} ms = "
             f"{env_steps / sto_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(sto.double().mean()):.3f}; on {smi}"]
    torch.cuda.synchronize()
    rates = {"eval_det_steps_s": env_steps / det_ms * 1e3,
             "eval_sto_steps_s": env_steps / sto_ms * 1e3}
    return lines, actor, log_std, det, fast_episodes.kernel_seed(replay_gen), rates


def check_evaluation(params, dev, actor, det, seed):
    """After phase 8's counts are read: the deterministic evaluation's first
    1,024 lanes against plain K5 on the same seed (lanes keep their
    counters, so a slice of lanes replays alone)."""
    from or_gym_inventory_torch.ops import net_step as ns
    E = EVAL_EPISODES
    plain, _, _ = ns._policy_returns_plain(params, actor, None, seed, MULTI_LANES, E, dev)
    share, _ = lane_share("main path: evaluation vs plain K5",
                          det.reshape(E, PPO_ENVS)[:, :MULTI_LANES].contiguous(), plain)
    return (f"the deterministic evaluation's first {MULTI_LANES} lanes: {share:.4%} "
            "agree with plain K5")


def profile_update(params, dev, trained):
    """One more PPO update of the trained state under torch.profiler: its
    wall time (the profiler's host overhead included), the device's busy
    time (the sum of the device events, kernels and copies; one stream, so
    they do not overlap), their count and the ones that take most device
    time. Outside the counted main path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import net_inv_management as net
    cfg, state, gen = trained
    update = ppo.make_update_fn(net.ENV, params, cfg, PPO_UPDATES + 1, device=dev)
    update(state, gen)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    line = (f"profiled PPO update: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.1%}), {n_kernels} device kernels and copies; top by "
            "device time: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                        for e in top))
    return line, {"busy_ms": busy_ms, "profiled_wall_ms": wall_ms, "events": n_kernels}


def time_chunks(params, dev, trained, order=(8, 1, 1, 8)):
    """Wall ms of one PPO update of the trained state per explicit
    ``minibatch_chunks`` value, in the given order (8 is the JAX package's
    automatic value at this shape: chunks of at most 32,768 samples).
    Returns {chunks: [ms, ...]}."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import net_inv_management as net
    cfg, state, gen = trained
    out = {}
    for k in order:
        update = ppo.make_update_fn(net.ENV, params, cfg.replace(minibatch_chunks=k),
                                    PPO_UPDATES + 1, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(state, gen)
        torch.cuda.synchronize()
        out.setdefault(k, []).append((time.perf_counter() - t0) * 1e3)
    return out


# ------------------------------------------------ InvManagement (slice 3)

def im_cross_check(dev):
    """Phase 10: K7-K9 against their plain versions and each other, for each
    of the five demand modes in backlog and lost sales: at 65,536 x 30
    (E = 1) and at 1,024 lanes x 16 episodes, K9's streams bit for bit
    against plain K9, K8 against K7 on K9's streams, K8 bit for bit against
    plain K8 (int32 state, the same arithmetic; K8 and K9 also on a ragged
    batch, ``RAGGED``), K7 _random on K9's demand against K8, and K7 against
    plain K7. Then K8 bit for bit against plain K8 on chains of
    ``IM_CHAIN_M1`` stocked stages (``im_chain``), each m1 K8's own
    instance, backlog and lost sales, at E = 1, 16 and ragged; and K9's m1
    = 8 instance at lt 32 (``IM_MAXIMA_L``) bit for bit against plain K9 at
    E = 1, 16 and two ragged batches, K8 = K7 on its streams. Returns the
    max |diff| per kernel (K8's is 0: it is held bit for bit)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    err = dict.fromkeys(IM_KERNELS, 0.0)

    def track(name, *args):
        err[name] = max(err[name], close(*args, 1e-5, 1e-3))

    def k8_exact(case, got, *plain_args):
        if not torch.equal(got, ek._im_fused_plain(params, SEED, *plain_args, dev)):
            raise AssertionError(f"K8 vs plain K8, {case}: not bit for bit")

    def k9_exact(params, case, b, e):   # K9 at b lanes x e episodes against plain K9
        a, d = ek.sample_streams_debug_im(params, SEED, b, e, device=dev)
        pa, pd = ek._im_fused_plain(params, SEED, b, e, dev, dump=True)
        if e == 1:
            pa, pd = pa[:, 0], pd[:, 0]
        exact(f"K9 actions, {case}", a, pa)
        exact(f"K9 demand, {case}", d, pd)
        return a, d

    for label, kw in IM_DIST_MODES:
        for backlog in (True, False):
            params = im.default_params(backlog=backlog, **kw)
            case = f"{label}, {'backlog' if backlog else 'lost sales'}"
            a, d = ek.sample_streams_debug_im(params, SEED, CHECK_LANES, device=dev)
            pa, pd = ek._im_fused_plain(params, SEED, CHECK_LANES, 1, dev, dump=True)
            exact(f"K9 actions, {case}", a, pa[:, 0])
            exact(f"K9 demand, {case}", d, pd[:, 0])
            k8 = ek.episode_returns_im_fused(params, SEED, CHECK_LANES, device=dev)
            k7 = ek.episode_returns_im(params, a, d)
            exact(f"K8 vs K7 on K9's streams, {case}", k8, k7)   # one episode body
            exact(f"K7 _random on K9's demand vs K8, {case}",
                  ek.episode_returns_im_random(params, d, SEED), k8)
            track("episode_returns_im", f"K7 vs plain K7, {case}", k7,
                  ek._episode_returns_im_plain(params, a, d))
            k8_exact(case, k8.reshape(1, -1), CHECK_LANES, 1)
            E = MAIN_EPISODES
            a, d = ek.sample_streams_debug_im(params, SEED, MULTI_LANES, E, device=dev)
            pa, pd = ek._im_fused_plain(params, SEED, MULTI_LANES, E, dev, dump=True)
            exact(f"K9 actions, E={E}, {case}", a, pa)
            exact(f"K9 demand, E={E}, {case}", d, pd)
            k8 = ek.episode_returns_im_fused(params, SEED, MULTI_LANES, E, device=dev)
            k8_exact(f"E={E}, {case}", k8, MULTI_LANES, E)
            b, e = RAGGED
            k8_exact(f"ragged {b} x {e}, {case}",
                     ek.episode_returns_im_fused(params, SEED, b, e, device=dev), b, e)
            k9_exact(params, f"ragged {b} x {e}, {case}", b, e)
            for e in range(E):
                exact(f"K8 episode {e} vs K7 on K9's streams, {case}", k8[e],
                      ek.episode_returns_im(params, a[:, e].contiguous(),
                                            d[:, e].contiguous()))
    for m1 in IM_CHAIN_M1:   # K8's instances for other m1
        for backlog in (True, False):
            params = im_chain(m1, backlog)
            case = f"m1={m1}, {'backlog' if backlog else 'lost sales'}"
            k8_exact(case, ek.episode_returns_im_fused(params, SEED, CHECK_LANES, device=dev)
                     .reshape(1, -1), CHECK_LANES, 1)
            k8_exact(f"E={E}, {case}",
                     ek.episode_returns_im_fused(params, SEED, MULTI_LANES, E, device=dev),
                     MULTI_LANES, E)
            b, e = RAGGED
            k8_exact(f"ragged {b} x {e}, {case}",
                     ek.episode_returns_im_fused(params, SEED, b, e, device=dev), b, e)
    for backlog in (True, False):   # K9's m1 = 8 instance at lt 32, the struct maxima
        params = im_chain(8, backlog, IM_MAXIMA_L)
        case = f"m1=8, lt=32, {'backlog' if backlog else 'lost sales'}"
        a, d = k9_exact(params, case, CHECK_LANES, 1)
        exact(f"K8 vs K7 on K9's streams, {case}",
              ek.episode_returns_im_fused(params, SEED, CHECK_LANES, device=dev),
              ek.episode_returns_im(params, a, d))
        k9_exact(params, f"E={E}, {case}", MULTI_LANES, E)
        k9_exact(params, f"ragged {RAGGED[0]} x {RAGGED[1]}, {case}", *RAGGED)
        k9_exact(params, f"ragged {RAGGED[0] + 25} x 1, {case}", RAGGED[0] + 25, 1)
    return err


def im_chain(m1, backlog, L=None):
    """An InvManagement chain of ``m1`` stocked stages, the default's
    inventories, costs, capacities and lead times taken in turn (lt_max 1
    at m1 = 1, 5 at 2, 10 past; or the lead times ``L``), Poisson demand."""
    from or_gym_inventory_torch.envs import inv_management as im
    d = im.default_params()

    def cycle(xs, n):
        return tuple(xs[i % len(xs)] for i in range(n))
    return im.default_params(backlog=backlog, I0=cycle(d.I0, m1), r=cycle(d.r, m1 + 1),
                             k=cycle(d.k, m1 + 1), h=cycle(d.h, m1), c=cycle(d.c, m1),
                             L=cycle(d.L, m1) if L is None else L)


def im_main_path(dev, wrappers):
    """Phase 11, the InvManagement random-policy path. Before the count, K9
    dumps the streams of the main path's seed at 65,536 x 30 and K7 replays
    them (stream-in and _random). Then, counting launches from 0,
    ``random_episode_returns`` at 4,194,304 x 16 must launch K8 exactly
    once, nothing else and no plain version. After the counts are read, the
    first 65,536 lanes of episode 0 are held against K7 (the same counters)
    and the first 1,024 lanes of every episode against plain K8, bit for
    bit. Returns
    (launches, max |diff| of K8, mean return, streams and seed for phase
    14)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    params = im.default_params(backlog=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    seed = fast_episodes.kernel_seed(replay)
    a, d = ek.sample_streams_debug_im(params, seed, CHECK_LANES, device=dev)
    k7 = ek.episode_returns_im(params, a, d)
    k7r = ek.episode_returns_im_random(params, d, seed)
    reset_counts(wrappers)
    with no_plain_versions():
        ret = fast_episodes.random_episode_returns(params, gen, MAIN_LANES,
                                                   episodes_per_lane=MAIN_EPISODES,
                                                   device=dev)
    launches = read_counts(wrappers)
    torch.cuda.synchronize()
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"episode_returns_im_fused": 1}:
        raise AssertionError(f"random_episode_returns launched {moved}, not K8 once")
    if ret.shape != (MAIN_LANES * MAIN_EPISODES,):
        raise AssertionError(f"IM main path: returns of shape {tuple(ret.shape)}")
    ret = ret.reshape(MAIN_EPISODES, MAIN_LANES)
    exact("IM main path: K8 episode 0 vs K7 on K9's streams", ret[0, :CHECK_LANES], k7)
    exact("IM main path: K7 _random vs K8 episode 0", k7r, ret[0, :CHECK_LANES])
    err = 0.0
    if not torch.equal(ret[:, :MULTI_LANES].contiguous(),
                       ek._im_fused_plain(params, seed, MULTI_LANES, MAIN_EPISODES, dev)):
        raise AssertionError("IM main path: the first lanes differ from plain K8")
    mean = float(ret.double().mean())
    del ret
    return launches, err, mean, (params, a, d, seed)


def k10_against_plain(params, actor, log_std, B, dev, case):
    """K10 (``rollout_traj_im``) and its plain version on the same actor,
    ``B`` lanes x ``params``' horizon: demand bit for bit; inv, actions, raws
    and rewards by the share of lanes (``lane_share``); the env step chain on
    K10's actions and demand reproduces its inv exactly and its rewards
    within rtol=1e-4 atol=1e-2 on every lane. Returns (K10's trajectory,
    plain's ms, {key: (share, max |diff|)})."""
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    tr = ek.rollout_traj_im(params, actor, log_std, SEED, B, device=dev)
    ms, want = timed_once(ek._rollout_traj_im_plain, params, actor, ek.clipped_std(log_std),
                          SEED, B, dev)
    exact(f"K10 demand, {case}", tr["demand"], want["demand"])
    shares = {k: lane_share(f"K10 {k} vs plain, {case}", tr[k], want[k])
              for k in ("inv", "actions", "raw", "reward")}
    del want
    T = tr["reward"].shape[0]
    state, _ = im.reset(params, batch=B, device=dev)
    for t in range(T):
        exact(f"step chain inv[{t}] vs K10 inv, {case}", state.inv.T, tr["inv"][t])
        state, ts = im.step_with_demand(params, state, tr["actions"][t].T, tr["demand"][t])
        close(f"step chain reward[{t}] vs K10, {case}", ts.reward, tr["reward"][t],
              1e-4, 1e-2)
    exact(f"step chain final inv vs K10, {case}", state.inv.T, tr["inv"][T])
    return tr, ms, shares


def im_policy_cross_check(dev, actor, log_std):
    """Phase 12: K10 at 65,536 x 30, backlog and lost sales, against plain
    K10 and the env step chain (``k10_against_plain``); K7 on K10's streams
    gives the sum of its rewards; a NaN std gives NaN raws and actions 0 in
    the kernel and the plain version. Returns (max |diff| over agreeing
    lanes, plain ms, lines)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    err, plain_ms, lines = 0.0, None, []
    for backlog in (True, False):
        params = im.default_params(backlog=backlog)
        case = "backlog" if backlog else "lost sales"
        tr, ms, shares = k10_against_plain(params, actor, log_std, CHECK_LANES, dev, case)
        plain_ms = plain_ms or ms
        err = max([err] + [e for _, e in shares.values()])
        lines.append(f"K10 vs plain, {case}: lanes agreeing " + ", ".join(
            f"{k} {sh:.4%}" for k, (sh, _) in shares.items()))
        close(f"K7 on K10's streams vs its rewards, {case}",
              ek.episode_returns_im(params, tr["actions"], tr["demand"]),
              tr["reward"].sum(0), 1e-5, 1e-3)
        lines.append(f"K10 teacher-forced, {case}: the env step chain gives its inv "
                     "exactly and its rewards, K7 its returns")
        nan_std = torch.full_like(log_std, float("nan"))
        got = ek.rollout_traj_im(params, actor, nan_std, SEED, MULTI_LANES, device=dev)
        plain = ek._rollout_traj_im_plain(params, actor, ek.clipped_std(nan_std), SEED,
                                          MULTI_LANES, dev)
        if not (torch.isnan(got["raw"]).all() and int(got["actions"].abs().max()) == 0
                and torch.equal(got["actions"], plain["actions"])):
            raise AssertionError(f"K10 with a NaN std, {case}: actions not all 0 or "
                                 "not the plain version's")
    lines.append("NaN raws: K10 and plain K10 cast them to 0, as JAX does")
    torch.cuda.synchronize()
    return err, plain_ms, lines


def im_reward_check(dev, seed=0):
    """Phase 15, the IM-backlog protocol of tools/validate_kernel_ppo.py:
    periods 50, 1,024 envs, 4 epochs x 8 env-sliced minibatches, 2M steps
    (39 updates), seed 0 (or ``seed``), rollout="kernel"; then 30
    deterministic episodes through ``vecenv.evaluate_episodes`` and, on the
    reference protocol, through ``vecenv.evaluate_episodes_seeded`` on seeds
    4000-4029 (validate_kernel_ppo.py:47-55). Returns (AvgReward, its
    standard error, training seconds, updates, the seeded AvgReward, its
    standard error)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import vecenv
    params = im.default_params(backlog=True, periods=50)
    cfg = ppo.PPOConfig(num_envs=1024, rollout_steps=50, num_minibatches=8,
                        update_epochs=4, shuffle_minibatches=False, rollout="kernel")
    t0 = time.perf_counter()
    state, metrics = ppo.train(im.ENV, params, cfg,
                               torch.Generator(device=dev).manual_seed(seed), 2_000_000,
                               device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    policy = ppo.make_eval_policy(im.ENV, params, cfg, deterministic=True)
    totals, _ = vecenv.evaluate_episodes(im.ENV, params, policy, (state.params, state.rms),
                                         torch.Generator(device=dev).manual_seed(4000), 30,
                                         device=dev)
    seeded, _ = vecenv.evaluate_episodes_seeded(im.ENV, params, policy,
                                                (state.params, state.rms),
                                                torch.arange(4000, 4030), device=dev)
    totals, seeded = totals.double().cpu().numpy(), seeded.double().cpu().numpy()
    if not (np.isfinite(totals).all() and np.isfinite(seeded).all()):
        raise AssertionError("IM reward check: non-finite episode totals")
    return (float(totals.mean()), float(totals.std(ddof=1) / np.sqrt(len(totals))), wall,
            len(metrics["update"]), float(seeded.mean()),
            float(seeded.std(ddof=1) / np.sqrt(len(seeded))))


# ------------------------------------------ InvManagement evaluation (slice 4)

def im_eval_cross_check(dev, params, actor, log_std):
    """Phase 16: K11 and K12 at 65,536 x 16 x 30 with phase 13's trained
    actor, deterministic and stochastic, against plain K11/K12 (demand bit
    for bit; returns and actions by the share of lanes); K7 on K12's streams
    gives K11's returns; the stochastic K11's episode 0 against K10 on the
    same seed, bit for bit (K10 is the same tile kernel's one-episode
    instance: its actions and demand are K12's episode 0's, its reward sum
    K11's episode 0 return). Returns (max |diff| per kernel, plain ms per
    kernel, lines)."""
    import functools

    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    B, E, T, m1 = PPO_ENVS, EVAL_EPISODES, NUM_STEPS, params.m1
    err = dict.fromkeys(IM_EVAL_KERNELS, 0.0)
    plain_ms, lines = {}, []
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        k11 = ek.episode_returns_im_policy(params, actor, SEED, B, E, ls, dev)
        r12, a12, d12 = ek.sample_policy_streams_debug_im(params, actor, SEED, B, E, ls, dev)
        pstd = None if ls is None else ek.clipped_std(ls)
        ms11, (want, _, _) = timed_once(ek._im_policy_plain, params, actor, pstd, SEED, B, E,
                                        dev, False)
        ms12, (_, want_a, want_d) = timed_once(ek._im_policy_plain, params, actor, pstd, SEED,
                                               B, E, dev, True)
        if ls is None:
            plain_ms["episode_returns_im_policy"] = ms11
            plain_ms["sample_policy_streams_debug_im"] = ms12
        exact(f"K12 demand, {kind}", d12, want_d)
        err["sample_policy_streams_debug_im"] = max(
            err["sample_policy_streams_debug_im"],
            close(f"K12 vs K11 returns, {kind}", r12, k11, 1e-5, 1e-3))
        sh_r, e11 = lane_share(f"K11 vs plain, {kind}", k11, want)
        sh_a, _ = lane_share(f"K12 actions vs plain, {kind}",
                             a12.permute(0, 2, 1, 3).reshape(T * m1, E * B),
                             want_a.permute(0, 2, 1, 3).reshape(T * m1, E * B))
        err["episode_returns_im_policy"] = max(err["episode_returns_im_policy"], e11)
        replay = ek.episode_returns_im(
            params, a12.permute(0, 2, 1, 3).reshape(T, m1, E * B).contiguous(),
            d12.reshape(T, E * B).contiguous())
        close(f"K7 on K12's streams vs K11, {kind}", replay.reshape(E, B), k11, 1e-5, 1e-3)
        lines.append(f"K11/K12 {kind}, {B} x {E} x {T}: K12 demand bit-exact, K7 replays "
                     f"K12's streams, lanes agreeing with plain K11 {sh_r:.4%} (returns), "
                     f"{sh_a:.4%} (actions)")
        if ls is not None:
            tr = ek.rollout_traj_im(params, actor, ls, SEED, B, device=dev)
            exact("stochastic K12 episode 0 actions vs K10", a12[:, 0], tr["actions"])
            exact("stochastic K12 episode 0 demand vs K10", d12[:, 0], tr["demand"])
            exact("stochastic K11 episode 0 vs K10's reward sum", k11[0],
                  functools.reduce(torch.add, tr["reward"]))
            lines.append(f"stochastic K11/K12 episode 0 vs K10 on the same seed, {B} lanes: "
                         "actions, demand and return (K10's reward sum) bit for bit")
            del tr
        del k11, r12, a12, d12, want, want_a, want_d, replay
    lines += tile_edge_cases("im", params, dev, actor, log_std)
    torch.cuda.synchronize()
    return err, plain_ms, lines


def eval_main_path(dev, wrappers, params, actor, log_std, smi, kernel, plain, num_steps):
    """Phases 17 and 23, the learned-policy evaluation of a trained actor:
    ``policy_episode_returns`` at 65,536 x 16 x ``num_steps``, deterministic
    and stochastic, counting launches from 0 and with every plain version
    patched to raise: the wrapper named ``kernel`` (K11, K19) once per call
    and nothing else. After the counts are read, the deterministic
    evaluation's first 1,024 lanes are held against ``plain(seed)``, the
    kernel's plain version on the replayed seed. Returns (launches, lines,
    rates)."""
    import torch

    from or_gym_inventory_torch.vector import fast_episodes
    E = EVAL_EPISODES
    env_steps = PPO_ENVS * E * num_steps
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    replay = torch.Generator(device=dev)
    replay.set_state(g.get_state())
    det_seed = fast_episodes.kernel_seed(replay)
    reset_counts(wrappers)
    with no_plain_versions():
        det_ms, det = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, True, None, dev)
        sto_ms, sto = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, False, log_std, dev)
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {kernel: 2}:
        raise AssertionError(f"the evaluation launched {moved}, not {kernel} once per call")
    for name, ret in (("deterministic", det), ("stochastic", sto)):
        if ret.shape != (PPO_ENVS * E,) or not torch.isfinite(ret).all():
            raise AssertionError(f"{name} evaluation: shape {tuple(ret.shape)} or "
                                 "non-finite")
    share, _ = lane_share(f"evaluation vs plain {kernel}",
                          det.reshape(E, PPO_ENVS)[:, :MULTI_LANES].contiguous(),
                          plain(det_seed))
    lines = [f"policy_episode_returns {PPO_ENVS} x {E} x {num_steps}: deterministic "
             f"{det_ms:.3f} ms = {env_steps / det_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(det.double().mean()):.3f}; stochastic {sto_ms:.3f} ms = "
             f"{env_steps / sto_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(sto.double().mean()):.3f}; on {smi}",
             f"{kernel} launched once per call, nothing else, no plain version; the "
             f"deterministic evaluation's first {MULTI_LANES} lanes: {share:.4%} agree with "
             "its plain version"]
    rates = {"eval_det_ms": det_ms, "eval_det_steps_s": env_steps / det_ms * 1e3,
             "eval_sto_ms": sto_ms, "eval_sto_steps_s": env_steps / sto_ms * 1e3}
    return launches, lines, rates


# --------------------------------------------------------- Newsvendor (slice 4)

def nv_env():
    from or_gym_inventory_torch.envs import newsvendor as nv
    return nv.ENV


def nv_params(L=5, gamma=1.0, mu_max=200.0):
    from or_gym_inventory_torch.envs import newsvendor as nv
    return nv.default_params(dict(NV_ENV_CONFIG, lead_time=L, gamma=gamma, mu_max=mu_max))


def demand_check(name, got, want):
    """Max |got - want| of two demand streams; raises unless they are equal
    on at least DEMAND_SHARE of the draws and never more than 1 apart."""
    diff = (got - want).abs()
    share = float((diff == 0).double().mean())
    if share < DEMAND_SHARE or float(diff.max()) > 1:
        raise AssertionError(f"{name}: {share:.6%} of draws equal, max |diff| "
                             f"{float(diff.max())}")
    return float(diff.max())


def nv_cross_check(dev):
    """Phase 18: K13-K17 at 65,536 lanes x 50 periods, E 1 and 4, for lead
    time 5 and 0, gamma 1 and 0.99, mu_max 200 and 3: K17's econ and
    actions bit for bit against plain K17 and its demand by DEMAND_SHARE;
    K16 against plain K16 by the share of lanes; K16 at E=1 equal to
    episode 0 at E=4; on episode 0's streams K15 = K17, and the chain K16 =
    K14 = K13 _random = K13 bit for bit; K13 and K14 against their plain
    versions; a NaN action through K13 gives NaN in its lane only, as in
    plain K13. Then K13 at ``K13_EDGES`` (ragged batches, the ring's depths
    0 and 32): K13 and K13 _random on K17's streams equal to K16 bit for
    bit, and against plain with orders past both clips. Returns (max |diff|
    per kernel, lines)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import nv_poisson
    B, E = CHECK_LANES, 4
    err = dict.fromkeys(NV_KERNELS, 0.0)
    lines = []

    def track(name, value):
        err[name] = max(err[name], value)

    for L, gamma, mu_max in NV_CASES:
        params = nv_params(L, gamma, mu_max)
        case = f"L={L}, gamma={gamma}, mu_max={mu_max}"
        econ, acts, dems = ek.sample_streams_debug_nv_reset(params, SEED, B, E, dev)
        pe, pa, pd = ek._nv_fused_plain(params, SEED, B, E, dev, dump=True)
        exact(f"K17 econ, {case}", econ, pe)
        exact(f"K17 actions, {case}", acts, pa)
        track("sample_streams_debug_nv_reset", demand_check(f"K17 demand, {case}", dems, pd))
        del pe, pa, pd
        k16 = ek.episode_returns_nv_reset_fused(params, SEED, B, E, dev)
        _, e16 = lane_share(f"K16 vs plain, {case}", k16,
                            ek._nv_fused_plain(params, SEED, B, E, dev), 1e-5, 1e-2)
        track("episode_returns_nv_reset_fused", e16)
        exact(f"K16 E=1 vs episode 0 at E=4, {case}",
              ek.episode_returns_nv_reset_fused(params, SEED, B, 1, dev), k16[0])
        e0, a0, d0 = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
        a15, d15 = ek.sample_streams_debug_nv(params, e0, SEED)
        exact(f"K15 actions vs K17 episode 0, {case}", a15, a0)
        exact(f"K15 demand vs K17 episode 0, {case}", d15, d0)
        pa15, pd15 = (x[:, 0] for x in ek._nv_fused_plain(params, SEED, B, 1, dev, e0,
                                                           True)[1:])
        exact(f"K15 actions vs plain, {case}", a15, pa15)
        track("sample_streams_debug_nv", demand_check(f"K15 demand vs plain, {case}", d15,
                                                      pd15))
        k14 = ek.episode_returns_nv_fused(params, e0, SEED)
        k13r = ek.episode_returns_nv_random(params, e0, d0, SEED)
        k13 = ek.episode_returns_nv(params, e0, a0, d0)
        for name, got in (("K14", k14), ("K13 _random", k13r), ("K13", k13)):
            exact(f"{name} on K17's streams vs K16, {case}", got, k16[0])
        _, e14 = lane_share(f"K14 vs plain, {case}", k14,
                            ek._nv_fused_plain(params, SEED, B, 1, dev, e0)[0], 1e-5, 1e-2)
        track("episode_returns_nv_fused", e14)
        track("episode_returns_nv", close(f"K13 vs plain, {case}", k13,
                                          ek._episode_returns_nv_plain(params, e0, a0, d0),
                                          1e-5, 1e-2))
        nan_acts = a0.clone()
        nan_lane = B // 3
        nan_acts[7, nan_lane] = float("nan")
        got = ek.episode_returns_nv(params, e0, nan_acts, d0)
        want = ek._episode_returns_nv_plain(params, e0, nan_acts, d0)
        if (torch.isnan(got).nonzero().flatten().tolist() != [nan_lane]
                or not torch.equal(torch.isnan(got), torch.isnan(want))):
            raise AssertionError(f"NaN lane, {case}: K13 NaN at "
                                 f"{torch.isnan(got).nonzero().flatten()[:5].tolist()}")
        lines.append(f"{case}: K17 econ and actions bit-exact, demand max |diff| "
                     f"{err['sample_streams_debug_nv_reset']}; K16 = plain K16 and K16 E=1 = "
                     "episode 0; K15 = K17's episode 0; K14, K13 _random, K13 on K17's "
                     "streams = K16; a NaN action gives NaN in its lane only")
        del econ, acts, dems, k16
    lines.append("the chain K16 = K14 = K13 _random = K13 held bit for bit (an exact gate)")
    for L, b in K13_EDGES:
        params = nv_params(L, 0.99)
        case = f"K13 at L={L} on {b} lanes"
        econ, acts, dems = ek.sample_streams_debug_nv_reset(params, SEED, b, 1, dev)
        e0, a0, d0 = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
        k16 = ek.episode_returns_nv_reset_fused(params, SEED, b, 1, dev)   # (b,) at E = 1
        k13r = ek.episode_returns_nv_random(params, e0, d0, SEED)
        exact(f"{case} on K17's streams vs K16", ek.episode_returns_nv(params, e0, a0, d0), k16)
        exact(f"{case}, _random on K17's streams vs K16", k13r, k16)
        wild = a0 * 1.5 - 10.0     # orders past both clip bounds
        e13 = close(f"{case} vs plain", ek.episode_returns_nv(params, e0, wild, d0),
                    ek._episode_returns_nv_plain(params, e0, wild, d0), 1e-5, 1e-2)
        e13r = close(f"{case}, _random vs plain", k13r,
                     ek._episode_returns_nv_plain(params, e0, None, d0, SEED), 1e-5, 1e-2)
        track("episode_returns_nv", max(e13, e13r))
        lines.append(f"{case}, gamma 0.99 (its instances k_nv_returns<*,{L}>): K13 and K13 _random on "
                     f"K17's streams = K16 bit for bit; against plain max |diff| {e13:.6g} "
                     f"(orders past both clips), _random {e13r:.6g}")
    for mu_max in (NV_CASES[0][2], NV_CASES[1][2], NV_LINEAR_MU_MAX):
        params = nv_params(mu_max=mu_max)
        K = nv_poisson.window(params)[1]
        lines.append(f"mu_max={mu_max}: K = {K}, {ek._nv_table_plan(K)}")
    params = nv_params(mu_max=NV_LINEAR_MU_MAX)
    b = NV_LINEAR_LANES
    case = f"the linear count, mu_max={NV_LINEAR_MU_MAX}"
    econ, acts, dems = ek.sample_streams_debug_nv_reset(params, SEED, b, 2, dev)
    pe, pa, pd = ek._nv_fused_plain(params, SEED, b, 2, dev, dump=True)
    exact(f"K17 econ, {case}", econ, pe)
    exact(f"K17 actions, {case}", acts, pa)
    track("sample_streams_debug_nv_reset", demand_check(f"K17 demand, {case}", dems, pd))
    share, e16 = lane_share(f"K16 vs plain, {case}",
                            ek.episode_returns_nv_reset_fused(params, SEED, b, 2, dev),
                            ek._nv_fused_plain(params, SEED, b, 2, dev), 1e-5, 1e-2)
    track("episode_returns_nv_reset_fused", e16)
    lines.append(f"{case} at {b} x 2 x 50: K17 econ and actions bit-exact, demand max |diff| "
                 f"{float((dems - pd).abs().max())}; K16 {share:.4%} of lanes = plain K16")
    torch.cuda.synchronize()
    return err, lines


def nv_main_path(dev, wrappers):
    """Phase 19, the Newsvendor random-policy path: ``random_episode_returns``
    with NV_ENV_CONFIG at 4,194,304 x 16 x 50, counting launches from 0 and
    with every plain version patched to raise: K16 once and nothing else.
    After the counts are read, the first 65,536 lanes of every episode are
    held against plain K16 on the replayed seed (lanes keep their counters,
    so a slice of lanes replays alone). Returns (launches, max |diff| over
    agreeing lanes, share, mean, plain ms, params)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    params = nv_params()
    gen = torch.Generator(device=dev).manual_seed(0)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    seed = fast_episodes.kernel_seed(replay)
    reset_counts(wrappers)
    with no_plain_versions():
        ret = fast_episodes.random_episode_returns(params, gen, MAIN_LANES,
                                                   episodes_per_lane=MAIN_EPISODES,
                                                   device=dev)
    launches = read_counts(wrappers)
    torch.cuda.synchronize()
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"episode_returns_nv_reset_fused": 1}:
        raise AssertionError(f"random_episode_returns launched {moved}, not K16 once")
    if ret.shape != (MAIN_LANES * MAIN_EPISODES,) or not torch.isfinite(ret).all():
        raise AssertionError(f"NV main path: returns of shape {tuple(ret.shape)} or "
                             "non-finite")
    ret = ret.reshape(MAIN_EPISODES, MAIN_LANES)
    plain_ms, plain = timed_once(ek._nv_fused_plain, params, seed, CHECK_LANES,
                                 MAIN_EPISODES, dev)
    share, err = lane_share("NV main path: first lanes vs plain K16",
                            ret[:, :CHECK_LANES].contiguous(), plain, 1e-5, 1e-2)
    mean = float(ret.double().mean())
    del ret, plain
    return launches, err, share, mean, plain_ms, params


# ---------------------------------------------- Newsvendor learning (slice 5)

def normals_pin(z):
    """The goodness-of-fit pin of tests/test_pallas_policy.py:394-419 on the
    normals ``z``: mean within 5 / sqrt(n) of 0, std within 0.005 of 1, the
    third and fourth central moments within 0.02 of 0 and 0.06 of 3, no
    |z| beyond the sqrt(48 ln 2) cap of the 24-bit uniform, and a KS
    distance to Phi under 0.006. Returns the statistics; raises if one
    fails."""
    import torch
    z = z.double().reshape(-1)
    n = z.numel()
    c = z - z.mean()
    stats = {"mean": float(z.mean()), "std": float(z.std(correction=0)),
             "m3": float((c ** 3).mean()), "m4": float((c ** 4).mean()),
             "max_abs": float(z.abs().max())}
    cdf = 0.5 * (1.0 + torch.special.erf(torch.sort(z).values / math.sqrt(2.0)))
    hi = torch.arange(1, n + 1, dtype=torch.float64, device=z.device) / n
    stats["ks"] = float(torch.maximum((hi - cdf).abs(), (hi - 1.0 / n - cdf).abs()).max())
    if not (abs(stats["mean"]) < 5.0 / math.sqrt(n) and abs(stats["std"] - 1.0) < 0.005
            and abs(stats["m3"]) < 0.02 and abs(stats["m4"] - 3.0) < 0.06
            and stats["max_abs"] <= math.sqrt(48 * math.log(2)) + 1e-3 and stats["ks"] < 0.006):
        raise AssertionError(f"normals fail the goodness-of-fit pin: {stats}")
    return stats


def nv_policy_cross_check(dev):
    """Phase 21: K18-K21 against their plain versions with a seeded actor
    (obs_dim 10 or 5, act_dim 1, obs statistics folded), for lead time 5
    and 0 and gamma 1 and 0.99. K18 at 65,536 x 50: econ and demand bit for
    bit, orders, raws and rewards by the share of lanes, and,
    teacher-forced, its raws the folded actor on its assembled obs plus
    std times the plain normals (atol=1e-4). K19/K20 at 65,536 x 16 x 50,
    deterministic and stochastic: K20's econ and demand bit for bit against
    the plain version, K20 = K19 bit for bit, K19 and K20's orders against
    the plain version by the share of lanes, K13 on K20's streams = K19 bit
    for bit; the stochastic episode 0 against K18 bit for bit (K18 is the
    same tile kernel's one-episode instance): econ, demand, K20's orders
    through the pipeline's cap (``capped_orders``) against K18's capped
    orders, and K19's return against K18's gamma^t-summed rewards. K19/K20 on a ragged
    batch (``RAGGED``; deterministic and stochastic) and with a NaN weight
    (``nan_weight_actor``), against the plain version. A NaN std: NaN raws,
    orders and returns in the kernels and the plain versions, the econ and
    demand untouched. K21 at 64 x 65,536 against plain K21 and through the
    goodness-of-fit pin. Returns (max |diff| per kernel, plain ms per
    kernel, lines)."""
    import functools

    import torch

    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import rng
    B, E = PPO_ENVS, EVAL_EPISODES
    err = dict.fromkeys(NV_POLICY_KERNELS, 0.0)
    plain_ms, lines = {}, []
    lanes = torch.arange(B, dtype=torch.int64, device=dev)

    def track(name, value):
        err[name] = max(err[name], value)

    for L in (5, 0):
        for gamma in (1.0, 0.99):
            params = nv_params(L, gamma)
            T, case = params.step_limit, f"L={L}, gamma={gamma}"
            actor, log_std = seeded_actor(params.obs_dim, 1, dev)
            std = ek.clipped_std(log_std)
            tr = ek.rollout_traj_nv(params, actor, log_std, SEED, B, device=dev)
            ms, want = timed_once(ek._rollout_traj_nv_plain, params, actor, std, SEED, B, dev)
            plain_ms.setdefault("rollout_traj_nv", ms)
            exact(f"K18 econ, {case}", tr["econ"], want["econ"])
            exact(f"K18 demand, {case}", tr["demand"], want["demand"])
            shares = {k: lane_share(f"K18 {k} vs plain, {case}", tr[k], want[k])
                      for k in ("orders", "raw", "reward")}
            track("rollout_traj_nv", max(e for _, e in shares.values()))
            del want
            obs = nv.assemble_obs_from_streams(params, tr["econ"], tr["orders"])
            for t in range(T):
                w = rng.period_words(SEED, lanes, 0, t, 3, key1=rng.POLICY_KEY)
                close(f"K18 raw[{t}] vs folded actor + plain normals, {case}", tr["raw"][t, 0],
                      ek.folded_actor_mean(actor, obs[t])[:, 0]
                      + std[0, 0] * rng.normal01(w[1], w[2]), 0.0, 1e-4)
            del obs
            lines.append(f"K18 {case}: econ and demand bit-exact, lanes agreeing " + ", ".join(
                             f"{k} {sh:.4%}" for k, (sh, _) in shares.items())
                         + "; raws = folded actor + plain normals within atol=1e-4")
            disc = ek._discounts(params.gamma, T)
            for ls in (None, log_std):
                kind = "deterministic" if ls is None else "stochastic"
                pstd = None if ls is None else std
                k19 = ek.episode_returns_nv_policy(params, actor, SEED, B, E, ls, dev)
                r20, e20, a20, d20 = ek.sample_policy_streams_debug_nv(params, actor, SEED, B, E,
                                                                      ls, dev)
                if not plain_ms.get("episode_returns_nv_policy"):
                    plain_ms["episode_returns_nv_policy"], _ = timed_once(
                        ek._nv_policy_plain, params, actor, pstd, SEED, B, E, dev)
                ms, (want, we, wa, wd) = timed_once(ek._nv_policy_plain, params, actor, pstd,
                                                    SEED, B, E, dev, True)
                plain_ms.setdefault("sample_policy_streams_debug_nv", ms)
                exact(f"K20 econ, {kind}, {case}", e20, we)
                exact(f"K20 demand vs plain, {kind}, {case}", d20, wd)
                exact(f"K20 vs K19 returns, {kind}, {case}", r20, k19)
                sh_r, e19 = lane_share(f"K19 vs plain, {kind}, {case}", k19, want)
                sh_a, e_orders = lane_share(f"K20 orders vs plain, {kind}, {case}",
                                            a20.reshape(T, E * B), wa.reshape(T, E * B))
                track("episode_returns_nv_policy", e19)
                track("sample_policy_streams_debug_nv", e_orders)
                k13 = ek.episode_returns_nv(params,
                                            e20.permute(1, 0, 2).reshape(5, E * B).contiguous(),
                                            a20.reshape(T, E * B).contiguous(),
                                            d20.reshape(T, E * B).contiguous()).reshape(E, B)
                exact(f"K13 on K20's streams vs K19, {kind}, {case}", k13, k19)
                line = (f"K19/K20 {kind}, {case}: econ and demand bit-exact, K20 = K19 and K13 "
                        f"on K20's streams = K19 bit for bit, lanes agreeing with plain K19 "
                        f"{sh_r:.4%} (returns), {sh_a:.4%} (orders)")
                if ls is not None:
                    exact(f"stochastic K20 episode 0 econ vs K18, {case}", e20[0], tr["econ"])
                    exact(f"stochastic K20 episode 0 demand vs K18, {case}", d20[:, 0],
                          tr["demand"])
                    exact(f"stochastic K20 episode 0 orders, capped, vs K18's, {case}",
                          capped_orders(params, a20[:, 0]), tr["orders"])
                    ret18 = functools.reduce(lambda acc, t: acc + disc[t] * tr["reward"][t],
                                             range(T), torch.zeros_like(k19[0]))
                    exact(f"stochastic K19 episode 0 vs K18's rewards, {case}", k19[0], ret18)
                    line += ("; episode 0 against K18: econ, demand, orders (capped) and "
                             "return bit for bit")
                lines.append(line)
                del k19, r20, e20, a20, d20, want, we, wa, wd, k13
            nan_ls = torch.full_like(log_std, float("nan"))
            got = ek.rollout_traj_nv(params, actor, nan_ls, SEED, MULTI_LANES, device=dev)
            plain = ek._rollout_traj_nv_plain(params, actor, ek.clipped_std(nan_ls), SEED,
                                              MULTI_LANES, dev)
            got19 = ek.episode_returns_nv_policy(params, actor, SEED, MULTI_LANES, E, nan_ls, dev)
            if not (all(bool(torch.isnan(x[k]).all()) for x in (got, plain)
                        for k in ("raw", "orders", "reward"))
                    and bool(torch.isnan(got19).all())
                    and torch.equal(got["econ"], tr["econ"][:, :MULTI_LANES])
                    and torch.equal(got["demand"], tr["demand"][:, :MULTI_LANES])):
                raise AssertionError(f"K18/K19 with a NaN std, {case}: not NaN throughout, or "
                                     "the econ or demand moved")
            del tr, got, plain, got19
            if (L, gamma) == (5, 1.0):
                lines += nv_tile_edge_cases(params, dev, actor, log_std)
    lines.append("a NaN std: NaN raws, orders, rewards and returns in K18, K19 and plain K18, "
                 "the econ and demand unchanged")
    z = ek.sample_normals_debug(SEED, NORMAL_ROWS, B, device=dev)
    plain_ms["sample_normals_debug"], pz = timed_once(ek._sample_normals_plain, SEED,
                                                      NORMAL_ROWS, B, dev)
    track("sample_normals_debug", close("K21 vs plain K21", z, pz, 0.0, 1e-5))
    pin = normals_pin(z)
    lines.append(f"K21 {NORMAL_ROWS} x {B}: within atol=1e-5 of plain K21; the "
                 "goodness-of-fit pin holds: " + ", ".join(f"{k} {v:.6g}" for k, v in pin.items()))
    torch.cuda.synchronize()
    return err, plain_ms, lines


def capped_orders(params, orders):
    """K20's orders (T, B), written before the pipeline's cap, through the
    plain step's cap (``_nv_step_math``, nv_step_ring's arithmetic) as K18
    writes them, the pipeline the capped orders of the last L periods."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    zero = torch.zeros_like(orders[0])
    P, q = [zero] * params.lead_time, []
    for order in orders:
        P, _, qty = ek._nv_step_math(params, P, zero, zero, zero, zero, order, zero)
        q.append(qty)
    return torch.stack(q)


def nv_tile_edge_cases(params, dev, actor, log_std):
    """K19/K20 on the tile's edges, against the plain version: a ragged batch
    (``RAGGED``), deterministic and stochastic, econ and demand bit for bit,
    returns and orders by the share of lanes; a NaN weight in the hidden
    layer 1 (``nan_weight_actor``): NaN orders and returns as the plain
    version's, the econ and demand bit for bit; and the linear count, the
    layout the entry points take where no Poisson table fits a block
    (``NV_LINEAR_MU_MAX`` on ``NV_LINEAR_LANES`` x 2, deterministic and
    stochastic): econ and demand bit for bit, K20 = K19, returns and orders
    by the share of lanes. Returns the lines to print."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    b, e = RAGGED
    T, lines = params.step_limit, []
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        ret, econ, acts, dems = ek.sample_policy_streams_debug_nv(params, actor, SEED, b, e, ls,
                                                                  dev)
        want, we, wa, wd = ek._nv_policy_plain(params, actor,
                                               None if ls is None else ek.clipped_std(ls), SEED,
                                               b, e, dev, True)
        exact(f"K20 ragged econ, {kind}", econ, we)
        exact(f"K20 ragged demand, {kind}", dems, wd)
        share, _ = lane_share(f"K19/K20 ragged {b} x {e}, {kind}", ret, want)
        share_a, _ = lane_share(f"K20 ragged orders, {kind}", acts.reshape(T, e * b),
                                wa.reshape(T, e * b))
        lines.append(f"K19/K20 ragged {b} x {e} ({b * e % 64} pairs in the last tile), {kind}: "
                     f"econ and demand bit-exact, lanes agreeing with plain {share:.4%} "
                     f"(returns), {share_a:.4%} (orders)")
    bad = nan_weight_actor(actor)
    ret, econ, acts, dems = ek.sample_policy_streams_debug_nv(params, bad, SEED, 4_096, 2, None,
                                                              dev)
    want, we, wa, wd = ek._nv_policy_plain(params, bad, None, SEED, 4_096, 2, dev, True)
    exact("K20 NaN weight econ", econ, we)
    exact("K20 NaN weight demand", dems, wd)
    if not all(bool(torch.isnan(x).all()) for x in (ret, acts, want, wa)):
        raise AssertionError("K19/K20 NaN weight: orders and returns not all NaN")
    lines.append("K19/K20 NaN weight (0x7fffffff in layer 1): NaN orders and returns as the "
                 "plain version's, econ and demand bit-exact")
    lin = nv_params(params.lead_time, params.gamma, NV_LINEAR_MU_MAX)
    st = ek._nv_plan(lin, "cpu")["struct"]   # the host's struct: K, kc_max
    dims = tuple([lin.obs_dim] + [int(W.shape[1]) for W in actor[0]])
    plan = ek._nv_tile_choice(dims, st.L, st.K, lin.step_limit, st.kc_max)
    if plan.layout != "linear":
        raise AssertionError(f"K19 at mu_max={NV_LINEAR_MU_MAX} (K = {st.K}) takes the "
                             f"{plan.layout} layout, not the linear count")
    b, e = NV_LINEAR_LANES, 2
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        case = f"the linear count, mu_max={NV_LINEAR_MU_MAX}, {kind}"
        k19 = ek.episode_returns_nv_policy(lin, actor, SEED, b, e, ls, dev)
        ret, econ, acts, dems = ek.sample_policy_streams_debug_nv(lin, actor, SEED, b, e, ls, dev)
        want, we, wa, wd = ek._nv_policy_plain(lin, actor,
                                               None if ls is None else ek.clipped_std(ls), SEED,
                                               b, e, dev, True)
        exact(f"K20 econ, {case}", econ, we)
        exact(f"K20 demand, {case}", dems, wd)
        exact(f"K20 vs K19 returns, {case}", ret, k19)
        share, _ = lane_share(f"K19 vs plain, {case}", k19, want)
        share_a, _ = lane_share(f"K20 orders vs plain, {case}", acts.reshape(-1, e * b),
                                wa.reshape(-1, e * b))
        lines.append(f"K19/K20 {case} at {b} x {e} x {lin.step_limit} (K = {st.K}, "
                     f"{plan.lanes} lanes, {plan.bytes} B a block): econ and demand bit-exact, "
                     f"K20 = K19, lanes agreeing with plain {share:.4%} (returns), "
                     f"{share_a:.4%} (orders)")
    return lines


def nv_reward_check(dev, params, seed=0):
    """Phase 24's reward: benchmarks/benchmark_newsvendor.py's PPO_CFG with
    rollout="kernel" (256 envs x 50, 8 minibatches, 4 epochs, ent_coef 0)
    for RESULTS.md:56's 4M env-steps, seed 0 (or ``seed``), on ``params``;
    then the deterministic ``policy_episode_returns`` of the trained actor
    over 65,536 x 16 episodes. Returns (mean, its standard error, training
    seconds, updates)."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    cfg = ppo.PPOConfig(**NV_PPO_RECIPE)
    t0 = time.perf_counter()
    state, metrics = ppo.train(nv.ENV, params, cfg,
                               torch.Generator(device=dev).manual_seed(seed), NV_PPO_BUDGET,
                               device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    actor = ek.fold_actor_params(cfg, state.params, state.rms)
    ret = fast_episodes.policy_episode_returns(
        params, actor, torch.Generator(device=dev).manual_seed(2000), PPO_ENVS, EVAL_EPISODES,
        True, None, dev).double()
    if not torch.isfinite(ret).all():
        raise AssertionError("NV reward check: non-finite returns")
    return (float(ret.mean()), float(ret.std() / math.sqrt(ret.numel())), wall,
            len(metrics["update"]))


# ------------------------------------- InvManagement recurrent PPO (slice 6)

def seeded_lstm_actor(params, dev):
    """Phase 25's actor: an LSTMActorCritic of the benchmark widths (encoder
    64, hidden 128) drawn from its own initialisation, its mean head scaled
    by 30 so that the actions move across their range, and obs statistics
    with mean ~50 and std ~20 folded into the encoder's first layer.
    Returns (folded actor, log_std) on ``dev``."""
    import torch

    from or_gym_inventory_torch.agents import networks, ppo
    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    g = torch.Generator().manual_seed(SEED)
    D = im.observation_space(params).shape[0]
    model = networks.LSTMActorCritic(D, params.m1, hidden=LSTM_HIDDEN, encoder=LSTM_ENCODER,
                                     generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(D, generator=g),
                             var=(20.0 + 5.0 * torch.rand(D, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    actor = ek._lstm_on(ek.fold_lstm_actor(rppo.RecurrentPPOConfig(), model, rms), dev)
    return actor, model.log_std.detach().to(dev)


def k24_against_plain(params, actor, log_std, B, dev, case):
    """K24 (``rollout_traj_im_lstm``) and its plain version on the same
    actor, ``B`` lanes x ``params``' horizon: demand bit for bit; inv,
    actions, raws and rewards by the share of lanes (``lane_share``).
    Returns (K24's trajectory, plain's ms, {key: (share, max |diff|)})."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    tr = ek.rollout_traj_im_lstm(params, actor, log_std, SEED, B, device=dev)
    ms, ptr = timed_once(ek._rollout_traj_im_lstm_plain, params, actor,
                         ek.clipped_std(log_std), SEED, B, dev)
    exact(f"K24 demand vs plain, {case}", tr["demand"], ptr["demand"])
    shares = {k: lane_share(f"K24 {k} vs plain, {case}", tr[k], ptr[k])
              for k in ("inv", "actions", "raw", "reward")}
    return tr, ms, shares


def lstm_cross_check(dev):
    """Phase 25: K22-K24 against their plain versions at 65,536 x 30 with a
    seeded actor of the benchmark widths, for Poisson demand in backlog and
    lost sales, binomial in backlog and USER mode in lost sales. K23's
    demand bit for bit and its returns equal to K22's; K22's returns and
    K23's actions against the plain version by the share of lanes; K7 on
    K23's streams gives K22's returns. K24's demand bit for bit against the
    plain version and K23's; its inv, actions, raws and rewards by the share
    of lanes; the env step chain on its actions and demand gives its inv
    exactly and its rewards within rtol=1e-4 atol=1e-2; its raws squash to
    its actions; K7 on its streams gives the sum of its rewards. A NaN std
    gives NaN raws and actions 0 in K24 and its plain version; a NaN weight
    (the bits CUDA's arithmetic makes, 0x7fffffff) in the encoder, wx or wh
    gives K23 the plain version's actions, demand and returns and K24 NaN
    raws and the plain version's actions. Returns (max
    |diff| per kernel over agreeing lanes, plain ms per kernel, lines)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    B, T = CHECK_LANES, NUM_STEPS
    err = dict.fromkeys(LSTM_KERNELS, 0.0)
    plain_ms, lines = {}, []
    bitwise = {"K7 on K23": True, "K7 on K24": True, "squash": True}
    for (label, kw), backlog in LSTM_CASES:
        params = im.default_params(backlog=backlog, **kw)
        case = f"{label}, {'backlog' if backlog else 'lost sales'}"
        m1 = params.m1
        actor, log_std = seeded_lstm_actor(params, dev)
        k22 = ek.episode_returns_im_lstm(params, actor, SEED, B, dev)
        r23, a23, d23 = ek.sample_lstm_streams_debug_im(params, actor, SEED, B, dev)
        ms, (want, want_a, want_d) = timed_once(ek._im_lstm_plain, params, actor, SEED, B, dev,
                                                True)
        plain_ms.setdefault("sample_lstm_streams_debug_im", ms)
        exact(f"K23 demand, {case}", d23, want_d)
        exact(f"K23 returns vs K22, {case}", r23, k22)
        sh_r, e22 = lane_share(f"K22 vs plain, {case}", k22, want)
        sh_a, e23 = lane_share(f"K23 actions vs plain, {case}", a23.reshape(T * m1, B),
                               want_a.reshape(T * m1, B))
        err["episode_returns_im_lstm"] = max(err["episode_returns_im_lstm"], e22)
        err["sample_lstm_streams_debug_im"] = max(err["sample_lstm_streams_debug_im"], e22, e23)
        k7 = ek.episode_returns_im(params, a23, d23)
        close(f"K7 on K23's streams vs K22, {case}", k7, k22, 1e-5, 1e-3)
        bitwise["K7 on K23"] &= bool(torch.equal(k7, k22))
        del want, want_a, want_d, k7

        tr, ms, shares = k24_against_plain(params, actor, log_std, B, dev, case)
        plain_ms.setdefault("rollout_traj_im_lstm", ms)
        exact(f"K24 demand vs K23, {case}", tr["demand"], d23)
        err["rollout_traj_im_lstm"] = max([err["rollout_traj_im_lstm"]]
                                          + [e for _, e in shares.values()])
        state, _ = im.reset(params, batch=B, device=dev)
        for t in range(T):
            exact(f"step chain inv[{t}] vs K24 inv, {case}", state.inv.T, tr["inv"][t])
            state, ts = im.step_with_demand(params, state, tr["actions"][t].T, tr["demand"][t])
            close(f"step chain reward[{t}] vs K24, {case}", ts.reward, tr["reward"][t],
                  1e-4, 1e-2)
        exact(f"step chain final inv vs K24, {case}", state.inv.T, tr["inv"][T])
        half_c = torch.tensor(ek._half_c(params), device=dev)[:, None]
        squashed = im.trunc_i32((torch.tanh(tr["raw"]) + 1.0) * half_c)
        same = float((squashed == tr["actions"]).double().mean())
        if same < 0.9999:
            raise AssertionError(f"K24's raws squash to its actions on {same:.6%} of elements, "
                                 f"{case}")
        bitwise["squash"] &= same == 1.0
        k7 = ek.episode_returns_im(params, tr["actions"], tr["demand"])
        close(f"K7 on K24's streams vs its rewards, {case}", k7, tr["reward"].sum(0), 1e-5, 1e-3)
        bitwise["K7 on K24"] &= bool(torch.equal(k7, tr["reward"].sum(0)))
        lines.append(f"{case}: K23 demand bit-exact and K23 = K22; lanes agreeing with plain "
                     f"K22 {sh_r:.4%} (returns), {sh_a:.4%} (K23's actions); K24 demand = "
                     "plain = K23's, lanes agreeing " + ", ".join(
                         f"{k} {sh:.4%}" for k, (sh, _) in shares.items())
                     + f"; the step chain gives K24's inv exactly; raws squash to its actions "
                     f"on {same:.6%} of elements")
        del k22, r23, a23, d23, tr, k7
    params = im.default_params()
    actor, log_std = seeded_lstm_actor(params, dev)
    nan_std = torch.full_like(log_std, float("nan"))
    got = ek.rollout_traj_im_lstm(params, actor, nan_std, SEED, MULTI_LANES, device=dev)
    plain = ek._rollout_traj_im_lstm_plain(params, actor, ek.clipped_std(nan_std), SEED,
                                           MULTI_LANES, dev)
    if not (torch.isnan(got["raw"]).all() and int(got["actions"].abs().max()) == 0
            and torch.equal(got["actions"], plain["actions"])):
        raise AssertionError("K24 with a NaN std: raws not NaN or actions not all 0")
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32).to(dev)[0]
    for where in ("enc", "wx", "wh"):
        bad = {k: ([(W.clone(), b.clone()) for W, b in v] if k == "enc" else v.clone())
               for k, v in actor.items()}
        if where == "enc":
            bad["enc"][0][0][5, 7] = nan
        else:
            bad[where][10, 3] = nan
        r23, a23, d23 = ek.sample_lstm_streams_debug_im(params, bad, SEED, MULTI_LANES, dev)
        want, want_a, want_d = ek._im_lstm_plain(params, bad, SEED, MULTI_LANES, dev, True)
        exact(f"K23 actions with a NaN weight in {where}", a23, want_a)
        exact(f"K23 demand with a NaN weight in {where}", d23, want_d)
        close(f"K23 returns with a NaN weight in {where}", r23, want, 1e-5, 1e-3)
        got = ek.rollout_traj_im_lstm(params, bad, log_std, SEED, MULTI_LANES, device=dev)
        plain = ek._rollout_traj_im_lstm_plain(params, bad, ek.clipped_std(log_std), SEED,
                                               MULTI_LANES, dev)
        if not (torch.isnan(got["raw"]).all() and torch.isnan(plain["raw"]).all()
                and torch.equal(got["actions"], plain["actions"])):
            raise AssertionError(f"K24 with a NaN weight (0x7fffffff) in {where}: raws not "
                                 "NaN or actions not those of plain K24")
    lines.append("a NaN std: K24 and plain K24 give NaN raws and actions 0; a NaN weight "
                 "(0x7fffffff) in the encoder, wx or wh: K23's actions, demand and returns "
                 "those of plain K23, K24's raws NaN and its actions plain K24's; bit for "
                 "bit: " + ", ".join(f"{k} {v}" for k, v in bitwise.items()))
    torch.cuda.synchronize()
    return err, plain_ms, lines


def lstm_train_main_path(dev, wrappers, smi):
    """Phase 26, the recurrent learner's main path: ``recurrent_ppo.train``
    with ``rollout="kernel"`` on ``inv_management.default_params()`` at
    65,536 envs x 30, encoder 64 and hidden 128, 4 epochs x 8 env-sliced
    minibatches, 3 updates, counting launches from 0 with every plain
    version patched to raise: K24 once per update and nothing else.
    Returns (launches, lines, (params, cfg, state, eval_episodes), rates)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    params = im.default_params()
    cfg = rppo.RecurrentPPOConfig(num_envs=PPO_ENVS, rollout_steps=NUM_STEPS,
                                  num_minibatches=8, update_epochs=4, hidden=LSTM_HIDDEN,
                                  encoder=LSTM_ENCODER, rollout="kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset_counts(wrappers)
    with no_plain_versions():
        state, eval_episodes, metrics = rppo.train(im.ENV, params, cfg, gen,
                                                   PPO_UPDATES * PPO_ENVS * NUM_STEPS,
                                                   progress=progress, device=dev)
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"rollout_traj_im_lstm": PPO_UPDATES}:
        raise AssertionError(f"the recurrent PPO path launched {moved}, not K24 once per "
                             "update")
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != PPO_UPDATES:
        raise AssertionError(f"recurrent PPO metrics not finite: {bad}; {metrics}")
    update_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    best = min(update_ms)
    samples = PPO_ENVS * NUM_STEPS
    lines = [f"recurrent PPO {PPO_ENVS} x {NUM_STEPS}, encoder 64, hidden 128, 4 epochs x 8 "
             f"env-sliced minibatches: update ms {', '.join(f'{t:.3f}' for t in update_ms)} "
             f"(the first builds the model); best {best:.3f} ms = "
             f"{samples / best * 1e3:.6g} trained-steps/s on {smi}",
             "recurrent PPO metrics: " + "; ".join(f"{k} {', '.join(f'{x:.6g}' for x in v)}"
                                                   for k, v in metrics.items()),
             "K24 launched once per update, nothing else, no plain version"]
    rates = {"update_ms": best, "trained_steps_s": samples / best * 1e3}
    return launches, lines, (params, cfg, state, eval_episodes), rates


def lstm_eval_main_path(dev, wrappers, params, actor, smi):
    """Phase 27, the LSTM-policy evaluation of phase 26's trained actor:
    ``lstm_policy_episode_returns`` at 1,048,576 lanes x 30, counting
    launches from 0 with every plain version patched to raise: K22 once and
    nothing else. After the counts are read, the first 1,024 lanes are held
    against plain K22 on the replayed seed (lanes keep their counters).
    Returns (launches, max |diff| over agreeing lanes, lines, rates)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    replay = torch.Generator(device=dev)
    replay.set_state(g.get_state())
    seed = fast_episodes.kernel_seed(replay)
    reset_counts(wrappers)
    with no_plain_versions():
        ms, ret = timed_once(fast_episodes.lstm_policy_episode_returns, params, actor, g,
                             LSTM_EVAL_LANES, dev)
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"episode_returns_im_lstm": 1}:
        raise AssertionError(f"the LSTM evaluation launched {moved}, not K22 once")
    if ret.shape != (LSTM_EVAL_LANES,) or not torch.isfinite(ret).all():
        raise AssertionError(f"LSTM evaluation: shape {tuple(ret.shape)} or non-finite")
    share, err = lane_share("LSTM evaluation vs plain K22", ret[:MULTI_LANES].contiguous(),
                            ek._im_lstm_plain(params, actor, seed, MULTI_LANES, dev)[0])
    env_steps = LSTM_EVAL_LANES * NUM_STEPS
    lines = [f"lstm_policy_episode_returns {LSTM_EVAL_LANES} x {NUM_STEPS}: {ms:.3f} ms = "
             f"{env_steps / ms * 1e3:.6g} env-steps/s, mean {float(ret.double().mean()):.3f} "
             f"on {smi}",
             f"K22 launched once, nothing else, no plain version; the first {MULTI_LANES} "
             f"lanes: {share:.4%} agree with plain K22"]
    rates = {"eval_ms": ms, "eval_env_steps_s": env_steps / ms * 1e3,
             "eval_mean": float(ret.double().mean())}
    return launches, err, lines, rates


def lstm_reward_check(dev):
    """Phase 29, tools/validate_kernel_ppo.py run_rppo_row("rppo_kernel")'s
    protocol: IM backlog, periods 50, 1,024 envs, rollout_steps 50, 8
    minibatches, 4 epochs, 2M steps (39 updates), seed 0; then the port's
    ``eval_episodes`` on 64 envs. The random policy's mean return at the
    same params (K8, 65,536 episodes) is the bar it must beat. Returns
    (mean, its standard error, the random mean, training seconds,
    updates)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import fast_episodes
    params = im.default_params(backlog=True, periods=50)
    cfg = rppo.RecurrentPPOConfig(**RPPO_RECIPE)
    t0 = time.perf_counter()
    state, eval_episodes, metrics = rppo.train(
        im.ENV, params, cfg, torch.Generator(device=dev).manual_seed(0), RPPO_BUDGET,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = eval_episodes(state.params, state.rms,
                           torch.Generator(device=dev).manual_seed(4000), RPPO_EVAL_ENVS)
    totals = totals.double().cpu().numpy()
    random_mean = float(fast_episodes.random_episode_returns(
        params, torch.Generator(device=dev).manual_seed(0), CHECK_LANES,
        device=dev).double().mean())
    if not np.isfinite(totals).all():
        raise AssertionError("recurrent reward check: non-finite episode totals")
    return (float(totals.mean()), float(totals.std(ddof=1) / np.sqrt(len(totals))),
            random_mean, wall, len(metrics["update"]))


# --------------------------------- the last two sites and the off-policy heads (slice 7)

def b6_cross_check(dev):
    """Phase 30: K25 against its plain version on 30 chained periods at
    65,536 lanes, backlog and lost sales, on the default graph and on
    ``topology.two_retail_topology`` and ``custom_topology`` (links with
    L = 0, which have no ring word in K25's state; several retail links;
    periods t < L; alpha 0.97, the discount through ctypes' rounding to
    f32): random actions and demand, each period's input the
    kernel's last output; X, Y, U, RH' and the reward within rtol=1e-5
    atol=1e-3. K26 on K3's dumped demand against K2's returns on the same
    seed and against plain K26, rtol=1e-5 atol=1e-3. The plain time is the
    default graph's. Returns (max |diff| per kernel, plain ms, lines)."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import topology
    from or_gym_inventory_torch.ops import net_step as ns
    B = CHECK_LANES
    err = {"batched_step": 0.0}
    plain_ms, lines = {}, []
    graphs = (("default", topology.default_topology), ("two-retail", topology.two_retail_topology),
              ("custom", topology.custom_topology))
    for (graph, topo_fn), backlog in ((g, b) for g in graphs for b in (True, False)):
        params = net.default_params(topology=topo_fn(NUM_STEPS), num_periods=NUM_STEPS,
                                    backlog=backlog, alpha=1.0 if graph == "default" else 0.97)
        case = f"{graph} graph, {'backlog' if backlog else 'lost sales'}"
        T = params.topology
        hi = float(T.order_cap_heuristic * 2)
        g = torch.Generator(device=dev).manual_seed(SEED)
        X, Y, U, RH = (x.contiguous() for x in ns.init_transposed(params, B, dev))
        for t in range(NUM_STEPS):
            action = torch.rand((T.n_reorder, B), generator=g, device=dev) * hi
            demand = net.sample_demand(params, g, t, B, device=dev).T.contiguous()
            got = ns.batched_step(params, X, Y, U, RH, action, demand, t)
            ms, want = timed_once(ns._batched_step_plain, params, X, Y, U, RH, action, demand,
                                  t)
            if graph == "default":
                plain_ms["batched_step"] = min(plain_ms.get("batched_step", ms), ms)
            for name, a, b in zip(("X", "Y", "U", "RH", "reward"), got, want):
                err["batched_step"] = max(err["batched_step"],
                                          close(f"K25 {name}[{t}], {case}", a, b, 1e-5, 1e-3))
            X, Y, U, RH = got[:4]
        lines.append(f"K25 vs plain, {case} (lead times {T.ro_L}): {NUM_STEPS} chained "
                     f"periods at {B} lanes within rtol=1e-5 atol=1e-3")
    params = net.default_params(num_periods=NUM_STEPS)
    hi = float(params.topology.order_cap_heuristic * 2)
    _, dems = ns.sample_streams_debug(params, SEED, hi, B, device=dev)
    k2 = ns.episode_returns_fully_fused(params, SEED, hi, B, device=dev)
    k26 = ns.episode_returns_random_policy(params, dems, SEED, hi)
    plain_ms["episode_returns_random_policy"], want = timed_once(
        ns._episode_returns_random_policy_plain, params, dems, SEED, hi)
    e2 = close("K26 on K3's demand vs K2", k26, k2, 1e-5, 1e-3)
    err["episode_returns_random_policy"] = max(
        e2, close("K26 vs plain K26", k26, want, 1e-5, 1e-3))
    lines.append(f"K26 on K3's demand = K2's returns ({'bit for bit' if e2 == 0 else e2}) "
                 "and plain K26, within rtol=1e-5 atol=1e-3")
    torch.cuda.synchronize()
    return err, plain_ms, lines


def b6_main_path(dev, wrappers, smi):
    """Phase 31, counted: ``rollout_transposed`` of the default graph at
    65,536 envs x 30 periods (K25 once per period), then
    ``episode_returns_random_policy`` on K3's demand dumped before the count
    (K26 once), every plain version patched to raise. After the count, the
    rollout's total against the plain step replayed on the same generator
    seed (rtol=1e-5), and the time of the rollout. Returns (launches,
    lines, rates)."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.utils.profiling import cuda_time
    params = net.default_params(num_periods=NUM_STEPS)
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    B = CHECK_LANES
    _, dems = ns.sample_streams_debug(params, SEED, hi, B, device=dev)
    k2 = ns.episode_returns_fully_fused(params, SEED, hi, B, device=dev)
    reset_counts(wrappers)
    with no_plain_versions():
        total = ns.rollout_transposed(params, torch.Generator(device=dev).manual_seed(3), B,
                                      NUM_STEPS, device=dev)
        k26 = ns.episode_returns_random_policy(params, dems, SEED, hi)
        torch.cuda.synchronize()
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"batched_step": NUM_STEPS, "episode_returns_random_policy": 1}:
        raise AssertionError(f"the B6 path launched {moved}, not K25 once per period and "
                             "K26 once")
    g = torch.Generator(device=dev).manual_seed(3)
    X, Y, U, RH = (x.contiguous() for x in ns.init_transposed(params, B, dev))
    want = torch.zeros((), dtype=torch.float64, device=dev)
    for t in range(NUM_STEPS):
        action = torch.rand((T.n_reorder, B), generator=g, device=dev) * hi
        demand = net.sample_demand(params, g, t, B, device=dev).T.contiguous()
        X, Y, U, RH, rew = ns._batched_step_plain(params, X, Y, U, RH, action, demand, t)
        want = want + rew.double().sum()
    close("rollout_transposed vs the plain step's rollout", total.reshape(1),
          want.float().reshape(1), 1e-5, 1e-3)
    close("K26 vs K2 on the main path", k26, k2, 1e-5, 1e-3)
    roll_t = cuda_time(ns.rollout_transposed, params, torch.Generator(device=dev).manual_seed(3),
                       B, NUM_STEPS, None, dev, warmup=1, iters=3)
    rate = B * NUM_STEPS / roll_t["best_ms"] * 1e3
    lines = [f"rollout_transposed {B} x {NUM_STEPS}: K25 launched {NUM_STEPS} times, then K26 "
             f"once, nothing else, no plain version; total {float(total):.6g} = the plain "
             f"step's within rtol=1e-5; K26 = K2; best {roll_t['best_ms']:.3f} ms, "
             f"{rate:.6g} env-steps/s on {smi}"]
    return launches, lines, {"rollout_transposed_ms": roll_t["best_ms"],
                             "rollout_transposed_env_steps_s": rate}


def seeded_offpolicy_actor(obs_dim, act_dim, stochastic, dev, arch=None):
    """Phase 32's actor: an ``off_policy._Actor`` of ``arch`` widths (SB3's
    default, OFF_ARCH, when None) drawn from its own initialisation, obs statistics with mean ~50
    and std ~20 folded into its first layer, and the det head's log(0.1).
    Returns (folded actor, log_std), on ``dev``."""
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.ops import episode_kernels as ek
    g = torch.Generator().manual_seed(SEED + int(stochastic))
    arch = OFF_ARCH if arch is None else arch
    actor = op._Actor(obs_dim, act_dim, arch, stochastic, g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(obs_dim, generator=g),
                             var=(20.0 + 5.0 * torch.rand(obs_dim, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = ek.fold_offpolicy_actor(arch, actor, rms, stochastic)
    return ((tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs)),
            torch.full((act_dim,), math.log(OFF_STD), device=dev))


def offpolicy_families(dev):
    """(name, wrapper, plain version, params, ppo kernel, obs_dim, act_dim)
    of K27-K29: InvManagement backlog (30 periods), Newsvendor
    ENV_CONFIG_EVAL (50), NetInvMgmt's default graph (30)."""
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    imp, nvp, netp = im.default_params(backlog=True), nv_params(), \
        net.default_params(num_periods=NUM_STEPS)
    return [("rollout_traj_im_offpolicy", ek.rollout_traj_im_offpolicy,
             ek._rollout_traj_im_plain, imp, ek.rollout_traj_im, imp.pipeline_length, imp.m1),
            ("rollout_traj_nv_offpolicy", ek.rollout_traj_nv_offpolicy,
             ek._rollout_traj_nv_plain, nvp, ek.rollout_traj_nv, nvp.obs_dim, 1),
            ("rollout_traj_net_offpolicy", ns.rollout_traj_net_offpolicy,
             ns._rollout_traj_plain, netp, ns.rollout_traj_net, netp.topology.obs_dim,
             netp.topology.n_reorder)]


def offpolicy_teacher_forced(name, params, tr, actor, std, mode, act_dim, dev, atol=1e-4):
    """The kernel's a_norm against the plain head (``traj_policy``) on the
    kernel's own observations, rebuilt from its streams by the family's
    ``assemble_obs_from_streams``, and the plain draws of its words: every
    element within ``atol`` (1e-4: the MLP's sums in another order,
    tanhf/expf ulps; no feedback through the episode). Returns (the max
    |diff|, the share of elements within 1e-4)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import rng
    if name == "rollout_traj_im_offpolicy":
        obs_all, n_dem = im.assemble_obs_from_streams(params, tr["inv"], tr["actions"]), 1
    elif name == "rollout_traj_nv_offpolicy":
        obs_all, n_dem = nv.assemble_obs_from_streams(params, tr["econ"], tr["orders"]), 1
    else:
        obs_all = net.assemble_obs_from_streams(params, tr["x"], tr["u"], tr["r"])
        n_dem = params.topology.n_retail
    layers = ek.kernel_layers(actor, dev)
    lanes = torch.arange(tr["raw"].shape[-1], dtype=torch.int64, device=dev)
    n_head = ek._head_words(mode, act_dim)
    worst, within = 0.0, 0
    for t in range(tr["raw"].shape[0]):
        words = rng.period_words(SEED, lanes, 0, t, n_dem + n_head, key1=rng.POLICY_KEY)
        _, a = ek.traj_policy(mode, "relu", act_dim, layers, std, list(obs_all[t].T),
                              ek._head_noise(mode, words[n_dem:]))
        worst = max(worst, close(f"{name} a_norm[{t}] vs the plain head on its own obs, {mode}",
                                 tr["raw"][t], a, 0.0, atol))
        within += int(((tr["raw"][t] - a).abs() <= 1e-4).sum())
    return worst, within / tr["raw"].numel()


def nv_step_chain(params, tr, label):
    """The plain Newsvendor step chain on K28's econ, demand and a_norm
    gives its orders (rtol=1e-6, atol=1e-4) and rewards (rtol=1e-5,
    atol=1e-3)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    P = [torch.zeros_like(tr["reward"][0])] * params.lead_time
    half_hi = ek._nv_half_hi(params)[0]
    for t in range(params.step_limit):
        P, rew, q = ek._nv_step_math(params, P, *tr["econ"][:4],
                                     (tr["raw"][t, 0] + 1.0) * half_hi, tr["demand"][t])
        close(f"step chain order[{t}] vs K28, {label}", q, tr["orders"][t], 1e-6, 1e-4)
        close(f"step chain reward[{t}] vs K28, {label}", rew, tr["reward"][t], 1e-5, 1e-3)


def net_step_chain(params, tr, label, dev):
    """K1 on K29's a_norm (mapped onto the actions) and demand gives its
    rewards' sum (rtol=1e-5, atol=1e-3), and the plain step chain on them
    its x, u, r and rewards (rtol=1e-5, atol=1e-3)."""
    from or_gym_inventory_torch.ops import net_step as ns
    acts = (tr["raw"] + 1.0) * ns._half_hi(params.topology)
    close(f"K1 on K29's streams vs its rewards, {label}",
          ns.episode_returns(params, acts.contiguous(), tr["demand"]),
          tr["reward"].sum(0), 1e-5, 1e-3)
    n_ro = params.topology.n_reorder
    X, Y, U, RH = ns.init_transposed(params, tr["raw"].shape[-1], dev)
    for t in range(params.num_periods):
        X, Y, U, RH, rew = ns._batched_step_plain(params, X, Y, U, RH, acts[t],
                                                  tr["demand"][t], t)
        for k, want_k in (("x", X), ("u", U), ("r", RH[:n_ro])):
            close(f"step chain {k}[{t}] vs K29, {label}", tr[k][t + (k != "r")], want_k,
                  1e-5, 1e-3)
        close(f"step chain reward[{t}] vs K29, {label}", tr["reward"][t], rew, 1e-5, 1e-3)


def offpolicy_route(name, params, batch, mode, dev):
    """The route the off-policy wrapper ``name`` must take for ``batch``
    lanes under ``mode`` with phase 32's (256, 256) actor: K27/K28 the
    cluster; K29 the cluster at the learners' 1,024 lanes, and beyond that
    by its rule (``net_step._net_route``: the rounds of the clusters the
    card holds for the plan's tile)."""
    if name != "rollout_traj_net_offpolicy":
        return "cluster"
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    T = params.topology
    act = T.n_reorder
    dims = (T.obs_dim, *OFF_ARCH, 2 * act if mode == "sac" else act)
    plan = ek._cluster_choice(dims, act, mode in ("ppo", "det"), params.num_periods,
                              ns._shared_layout(T)[0].words, False, mode != "uniform",
                              ns._net_cluster_layout(T))
    held = ek._cluster_max_active("net_policy", "net_rollout_traj_cluster_occupancy",
                                  plan.cluster, plan.floats, (1,), ek._plan_key(dev))
    route = ns._net_route(batch, plan.lanes, held)
    if batch == LEARN_LANES and route != "cluster":
        raise AssertionError(f"K29 at the learners' {batch} lanes, {mode}: the {route} route")
    return route


def offpolicy_cross_check(dev):
    """Phase 32: K27-K29 at 65,536 and 1,024 lanes with a seeded (256, 256)
    relu actor, heads det (sigma 0.1), sac and uniform, each on the route
    ``offpolicy_route`` names (K29 at 65,536 det and sac on its batch
    route, the first design), against their plain versions:
    demand bit for bit (Newsvendor's by the K16 rule), and bit for bit with
    K10/K18/K4's on the same seed; the stored a_norm in [-1, 1],
    teacher-forced within atol=1e-4 on every element
    (``offpolicy_teacher_forced``), and free-running on >= 99% of lanes
    within rtol=1e-4, atol=1e-4 (uniform: bit for bit); the other streams
    by the share of lanes. The float families' det and sac lanes
    free-running need only FLOAT_FREE_SHARE: their pipelines feed the MLP's
    ulps back into the obs of the 256-wide actor, so their streams are held
    teacher-forced instead: the a_norm as above, and the plain step chain
    on K28's econ, demand and a_norm gives its orders and rewards, on K29's
    demand and a_norm its x, u, r and rewards (rtol=1e-5, atol=1e-3), K1 on
    K29's actions and demand its rewards' sum. The InvManagement step chain
    on K27's streams gives its inv exactly. Then each on a ragged batch and
    an actor of OFF_WIDE widths (the wide route). Returns (max |diff| per
    kernel over agreeing lanes, plain ms of the det head, lines)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    err, plain_ms, lines = {}, {}, []
    cases = [(fam, B, mode) for fam in offpolicy_families(dev) for B in (CHECK_LANES, LEARN_LANES)
             for mode in OFF_MODES]
    for fam, B, mode in cases:
        name, kernel, plain, params, ppo_kernel, obs_dim, act_dim = fam
        nv_family = name == "rollout_traj_nv_offpolicy"
        same = demand_check if nv_family else exact
        err.setdefault(name, 0.0)
        if mode == OFF_MODES[0]:
            ppo_actor, ppo_log_std = seeded_actor(obs_dim, act_dim, dev)
            ppo_demand = ppo_kernel(params, ppo_actor, ppo_log_std, SEED, B, device=dev)["demand"]
        actor, log_std = seeded_offpolicy_actor(obs_dim, act_dim, mode == "sac", dev)
        tr = kernel(params, actor, log_std, SEED, B, mode, "relu", dev)
        route = kernel.route
        if route != offpolicy_route(name, params, B, mode, dev):
            raise AssertionError(f"{name} at {B} lanes, {mode}: the {route} route")
        std = ek.clipped_std(log_std) if mode == "det" else None
        ms, want = timed_once(plain, params, actor, std, SEED, B, dev, mode, "relu")
        if mode == "det" and B == LEARN_LANES:
            plain_ms[name] = ms
        name_b = f"{name} at {B} lanes"
        same(f"{name_b} demand, {mode}", tr["demand"], want["demand"])
        same(f"{name_b} demand vs the PPO kernel's, {mode}", tr["demand"], ppo_demand)
        if not (float(tr["raw"].min()) >= -1.0 and float(tr["raw"].max()) <= 1.0):
            raise AssertionError(f"{name_b} {mode}: a_norm outside [-1, 1]")
        forced, _ = offpolicy_teacher_forced(name, params, tr, actor, std, mode, act_dim, dev)
        need = FLOAT_FREE_SHARE if name != "rollout_traj_im_offpolicy" and \
            mode != "uniform" else LANE_SHARE
        if mode == "uniform":
            exact(f"{name_b} a_norm, uniform", tr["raw"], want["raw"])
            shares = {"raw": (1.0, 0.0)}
        else:
            shares = {"raw": lane_share(f"{name_b} a_norm vs plain, {mode}", tr["raw"],
                                        want["raw"], 1e-4, 1e-4, need)}
        shares.update({k: lane_share(f"{name_b} {k} vs plain, {mode}", tr[k], want[k],
                                     need=need)
                       for k in tr if k not in ("raw", "demand")})
        err[name] = max([err[name]] + [e for _, e in shares.values()])
        lines.append(f"{name_b} {mode} ({route} route): demand equal to plain's and the PPO "
                     f"kernel's; "
                     f"a_norm teacher-forced max |diff| {forced:.3g}; lanes agreeing "
                     + ", ".join(f"{k} {sh:.4%}" for k, (sh, _) in shares.items()))
        if name == "rollout_traj_im_offpolicy":
            acts = im.trunc_i32((tr["raw"] + 1.0) * torch.tensor(
                ek._half_c(params), device=dev)[None, :, None])
            share = float((acts == tr["actions"]).double().mean())
            if share < 0.9999:
                raise AssertionError(f"K27 {mode}: a_norm rescaled gives its actions on "
                                     f"{share:.4%} of elements")
            state, _ = im.reset(params, batch=B, device=dev)
            for t in range(NUM_STEPS):
                exact(f"step chain inv[{t}] vs K27 inv, {mode}", state.inv.T, tr["inv"][t])
                state, ts = im.step_with_demand(params, state, tr["actions"][t].T,
                                                tr["demand"][t])
                close(f"step chain reward[{t}] vs K27, {mode}", ts.reward,
                      tr["reward"][t], 1e-4, 1e-2)
            exact(f"step chain final inv vs K27, {mode}", state.inv.T,
                  tr["inv"][NUM_STEPS])
            lines.append(f"K27 {mode}: a_norm rescaled gives its actions on {share:.4%} "
                         "of elements; the env step chain gives its inv exactly")
        elif nv_family:
            nv_step_chain(params, tr, mode)
            lines.append(f"K28 {mode}: the plain step chain on its econ, demand and a_norm "
                         "gives its orders and rewards")
        elif name == "rollout_traj_net_offpolicy":
            net_step_chain(params, tr, mode, dev)
            lines.append(f"K29 {mode}: the plain step chain on its demand and a_norm gives "
                         "its x, u, r and rewards; K1 on its streams its rewards' sum")
        del tr, want
    # K27-K29 on a ragged batch, and on the wide route: an actor of OFF_WIDE
    # widths, whose slice fits no cluster tile, so the wrapper launches the
    # first design (csrc/wide_mlp.cuh). K27's a_norm free-running on >= 99%
    # of lanes; K28's econ bit for bit; K28's and K29's a_norm
    # teacher-forced, with the plain step chain on their streams, and
    # free-running on FLOAT_FREE_SHARE of the ragged batch's lanes, as the
    # cases above; on the wide route their free-running share is reported,
    # not gated: the (512, 512) actor's ulps feed back through the state
    for name, kernel, plain, params, _, obs_dim, act_dim in offpolicy_families(dev):
        nv_family = name == "rollout_traj_nv_offpolicy"
        same = demand_check if nv_family else exact
        for case, B, arch in (("ragged", RAGGED[0], OFF_ARCH),
                              ("wide route", LEARN_LANES, OFF_WIDE)):
            need = LANE_SHARE if name == "rollout_traj_im_offpolicy" else \
                FLOAT_FREE_SHARE if case == "ragged" else 0.0
            actor, log_std = seeded_offpolicy_actor(obs_dim, act_dim, False, dev, arch)
            std = ek.clipped_std(log_std)
            tr = kernel(params, actor, log_std, SEED, B, "det", "relu", dev)
            route = "wide" if case == "wide route" else "cluster"
            if kernel.route != route:
                raise AssertionError(f"{name} {case}: the wrapper took the {kernel.route} route")
            want = plain(params, actor, std, SEED, B, dev, "det", "relu")
            same(f"{name} {case} demand", tr["demand"], want["demand"])
            if nv_family:
                exact(f"{name} {case} econ", tr["econ"], want["econ"])
            # K29's first design under the (512, 512) actor: 512-term f32 sums
            # of NetInvMgmt's obs, whose order windows reach hundreds, round
            # to ~1e-4 in either order (on an H100, 111 of 337,920 elements
            # past 1e-4, the largest 1.25e-4): every element within 1e-3, the
            # share within 1e-4 reported
            wide_net = name == "rollout_traj_net_offpolicy" and case == "wide route"
            forced, within = offpolicy_teacher_forced(name, params, tr, actor, std, "det",
                                                      act_dim, dev, 1e-3 if wide_net else 1e-4)
            share, e = lane_share(f"{name} {case} a_norm vs plain", tr["raw"], want["raw"],
                                  1e-4, 1e-4, need)
            err[name] = max(err[name], e)
            if nv_family:
                nv_step_chain(params, tr, f"det, {case}")
            elif name == "rollout_traj_net_offpolicy":
                net_step_chain(params, tr, f"det, {case}", dev)
            lines.append(f"{name} det, {case} ({B} lanes, actor {arch}, the {route} kernel): "
                         f"demand{' and econ' if nv_family else ''} equal to plain's; a_norm "
                         f"teacher-forced max |diff| "
                         f"{forced:.3g} ({within:.4%} of elements within 1e-4); lanes agreeing "
                         f"{share:.4%}"
                         + ("; the plain step chain on its econ, demand and a_norm gives its "
                            "orders and rewards" if nv_family else
                            "; K1 and the plain step chain on its demand and a_norm give its "
                            "rewards, x, u and r" if name == "rollout_traj_net_offpolicy"
                            else ""))
            del tr, want
    torch.cuda.synchronize()
    return err, plain_ms, lines


def offpolicy_kernel_launch(name, kernel, params, actor, log_std, batch, dev):
    """A function that launches K27's, K28's or K29's kernel alone on the
    route its entry point takes (the det head: the cluster, or K29's wide
    route past its rounds), its plan, packed actor and outputs made once,
    before: what CUDA events around it time is the launch. It is launched
    once here, and each of its outputs must equal the entry point's
    (``kernel``) on the same seed and batch, bit for bit. Returns (the
    function, the route)."""
    import ctypes

    import torch

    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    std = ek.clipped_std(log_std)
    want = kernel(params, actor, log_std, SEED, batch, "det", "relu", dev)
    route = kernel.route
    if name == "rollout_traj_im_offpolicy":
        src, T, act, obs = "im_policy", params.periods, params.m1, params.pipeline_length
        st, flat = ek._pack_cluster_actor(actor, std, obs, act, "det", ek._half_c(params), T,
                                          obs, False, dev)
        flags, plan = (1, int(params.backlog)), ek._im_plan(params, ek._plan_key(dev))
        head, env = (ctypes.addressof(plan["struct"]),), (
            plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr())
        streams = ("inv", "actions", "raw", "reward", "demand")
    elif name == "rollout_traj_nv_offpolicy":
        src, T, obs = "nv_policy", params.step_limit, params.obs_dim
        st, flat = ek._pack_cluster_actor(actor, std, obs, 1, "det", ek._nv_half_hi(params), T,
                                          obs + 1, True, dev)
        flags, plan = (1,), ek._nv_plan(params, ek._plan_key(dev))
        head, env = (ctypes.addressof(plan["struct"]),), (plan["lgam"].data_ptr(),)
        streams = ("econ", "orders", "raw", "reward", "demand")
    else:
        topo, T = params.topology, params.num_periods
        src, act, half_hi = "net_policy", topo.n_reorder, [ns._half_hi(topo)] * topo.n_reorder
        layout, lay = ns._shared_layout(topo)
        if route == "cluster":
            st, flat = ek._pack_cluster_actor(actor, std, topo.obs_dim, act, "det", half_hi, T,
                                              layout.words, False, dev,
                                              ns._net_cluster_layout(topo))
        else:
            st, flat = ek._pack_wide_actor(actor, std, topo.obs_dim, act, "det", half_hi, dev)
        flags = (1,)
        tp, disc, tab = ns._launch_plan(params, T, ek._plan_key(dev), True)
        plan = (tp, disc, tab, lay)
        head = (ctypes.addressof(tp),) + ((ctypes.addressof(lay),) if route == "cluster" else ())
        env = (tab.data_ptr(), disc.data_ptr())
        streams = ("x", "u", "r", "raw", "reward", "demand")
    fam = src.split("_")[0]
    if route == "cluster":
        ek._set_cluster_grid(st, batch, src, f"{fam}_rollout_traj_cluster_occupancy", flags, dev)
    outs = [torch.empty_like(want[k]) for k in streams]
    fn = getattr(_build.library(src), f"{fam}_rollout_traj_{route}")
    args = (*head, ctypes.addressof(st), flat.data_ptr(), *env,
            *(o.data_ptr() for o in outs), SEED, *flags, batch, T, ek._stream(dev))

    alive = (st, flat, plan, outs)   # what the pointers in args point into

    def launch():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fam}_rollout_traj_{route}: {_build.error_string(src, rc)}")
        return alive[-1]
    launch()
    for k, got in zip(streams, outs):
        exact(f"{name} kernel alone ({route}) {k} vs the entry point's at {batch} lanes",
              got.reshape(-1), want[k].reshape(-1))
    del want
    return launch, route


def td3_main_path(dev, wrappers, smi):
    """Phase 33, counted: TD3 with ``collect="kernel"`` on InvManagement
    backlog at tools/validate_kernel_collect.py's config (1,024 envs, buffer
    200,704, batch 256, 32 updates per iteration, seed 0) for TD3_ITERS
    iterations, every plain version patched to raise: K27 once per
    iteration, nothing else. Then the deterministic actor over 30 episodes
    (``vecenv.evaluate_episodes``) against the random policy's mean return
    at the same params (K8, 65,536 episodes), which it must beat. Returns
    (launches, lines, rates, (state, update))."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import fast_episodes, vecenv
    params = im.default_params(backlog=True)
    cfg = op.OffPolicyConfig(**TD3_RECIPE)
    steps = TD3_ITERS * cfg.num_envs * NUM_STEPS
    reset_counts(wrappers)
    with no_plain_versions():
        t0 = time.perf_counter()
        state, eval_policy, metrics = op.train(im.ENV, params, cfg,
                                               torch.Generator(device=dev).manual_seed(0),
                                               steps, log_every=4, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"rollout_traj_im_offpolicy": TD3_ITERS}:
        raise AssertionError(f"the TD3 path launched {moved}, not K27 once per iteration")
    totals, _ = vecenv.evaluate_episodes(im.ENV, params, eval_policy,
                                         (state.actor_params, state.rms),
                                         torch.Generator(device=dev).manual_seed(4000), 30,
                                         device=dev)
    totals = totals.double().cpu().numpy()
    random_mean = float(fast_episodes.random_episode_returns(
        params, torch.Generator(device=dev).manual_seed(0), CHECK_LANES,
        device=dev).double().mean())
    avg, se = float(totals.mean()), float(totals.std(ddof=1) / np.sqrt(len(totals)))
    if not (np.isfinite(totals).all() and avg > random_mean):
        raise AssertionError(f"TD3 reward {avg} not above the random policy's {random_mean}")
    lines = [f"TD3, validate_kernel_collect.py's config (1,024 envs, buffer 200,704, batch 256, "
             f"32 updates per iteration), {TD3_ITERS} iterations = {steps} env-steps (of its "
             f"2M; 1 uniform warmup), {wall:.1f} s = {steps / wall:.6g} trained-steps/s on {smi}: "
             f"K27 launched once per iteration, nothing else, no plain version; mean step "
             f"reward per chunk {np.round(metrics['mean_step_reward'], 3).tolist()}",
             f"TD3 reward: AvgReward {avg:.1f} +- {se:.1f} over 30 deterministic episodes "
             f"(evaluate_episodes), random policy {random_mean:.1f} (K8, {CHECK_LANES} episodes); "
             f"the JAX package's TPU run at 2M steps {TPU_TD3_REWARD} (a reward, not a speed)"]
    rates = {"td3_train_s": wall, "td3_trained_steps_s": steps / wall, "td3_reward_mean": avg,
             "td3_reward_se": se, "td3_random_mean": random_mean, "td3_iters": TD3_ITERS}
    return launches, lines, rates, (state, cfg, params)


def offpolicy_short_runs(dev, wrappers):
    """Phase 34, counted: SAC and DDPG with ``collect="kernel"``, 2
    iterations each (the uniform warmup, then the sac/det head) at 1,024
    envs, one update per period, on Newsvendor ENV_CONFIG_EVAL and the
    NetInvMgmt default graph, every plain version patched to raise: each run
    launches its family's off-policy kernel twice and nothing else. Returns
    (launches summed over the runs, lines)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import net_inv_management as net
    total, lines = {name: 0 for name in wrappers}, []
    for fam, env, params, kname in (
            ("Newsvendor", nv_env(), nv_params(), "rollout_traj_nv_offpolicy"),
            ("NetInvMgmt", net.ENV, net.default_params(num_periods=NUM_STEPS),
             "rollout_traj_net_offpolicy")):
        horizon = env.horizon(params)
        for algo in ("sac", "ddpg"):
            cfg = op.OffPolicyConfig(algo=algo, collect="kernel", num_envs=1024,
                                     buffer_size=1024 * horizon * 2, batch_size=256,
                                     start_steps=1024 * horizon, updates_per_iter=1)
            reset_counts(wrappers)
            with no_plain_versions():
                t0 = time.perf_counter()
                state, _, metrics = op.train(env, params, cfg,
                                             torch.Generator(device=dev).manual_seed(1),
                                             2 * 1024 * horizon, log_every=1, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            moved = {n: c for n, c in launches.items() if c}
            if moved != {kname: 2}:
                raise AssertionError(f"{algo} on {fam} launched {moved}, not {kname} twice")
            route = wrappers[kname][0].route   # the head's iteration, the last launch
            if route != "cluster":
                raise AssertionError(f"{algo} on {fam}: {kname} took the {route} route")
            if not np.isfinite(metrics["mean_step_reward"]).all() or \
                    state.buffer.filled != 2 * 1024 * horizon:
                raise AssertionError(f"{algo} on {fam}: non-finite rewards or a buffer of "
                                     f"{state.buffer.filled}")
            total = {n: total[n] + launches[n] for n in total}
            lines.append(f"{algo} on {fam}, 2 iterations (uniform, then {algo}'s head) at 1,024 "
                         f"x {horizon}: {kname} launched twice (the head's on the cluster), "
                         f"nothing else; mean step reward "
                         f"{np.round(metrics['mean_step_reward'], 3).tolist()}; {wall:.1f} s")
    return total, lines


def td3_iteration_split(dev, state, cfg, params):
    """Phase 35: one TD3 iteration of phase 33's trained state split into
    the kernel's collection, the n-step collapse with ``insert_chunk``, and
    the horizon x 32 gradient updates, each on the host clock with a
    synchronise. Returns (ms per part, the iteration's env-steps/s)."""
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import inv_management as im
    _, update, _ = op.make_offpolicy(im.ENV, params, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    parts = {}

    def clock(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    obs_all, a_norm, reward = clock("kernel", update.collect, state, 7, "det")
    clock("insert_chunk", lambda: state.buffer.insert_chunk(*op.episode_transitions(
        obs_all, a_norm, reward, cfg.n_step, cfg.gamma)))
    n_upd = NUM_STEPS * cfg.updates_per_iter
    idx = torch.randint(0, state.buffer.filled, (n_upd, cfg.batch_size), generator=g,
                        device=dev)
    z = torch.randn((n_upd, 2, cfg.batch_size, params.m1), generator=g, device=dev)

    def updates():
        for u in range(n_upd):
            update.one_update(state, idx[u], z[u, 0], z[u, 1], u)
    clock(f"{n_upd}_updates", updates)
    total = sum(parts.values())
    return parts, cfg.num_envs * NUM_STEPS / total * 1e3


def slice7_phases(dev, wrappers, smi, err, times, work):
    """Phases 30-35, the last two sites and the off-policy heads: K25/K26
    and K27-K29 held against their plain versions, the three counted main
    paths (``rollout_transposed`` and K26; TD3; SAC and DDPG), then the
    kernels' times and work model and one TD3 iteration split into its
    parts. Fills ``err``, ``times`` and ``work`` for K25-K29; returns (their
    launches on the counted paths, the summary of the off-policy paths)."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.utils.profiling import cuda_time
    params = net.default_params(num_periods=NUM_STEPS)
    hi = float(params.topology.order_cap_heuristic * 2)

    # 30. K25 and K26 against their plain versions, and K26 against K2
    t0 = time.perf_counter()
    err2, b6_plain_ms, lines = b6_cross_check(dev)
    err.update(err2)
    for line in lines:
        print(f"[30 B6 kernels] {line}", flush=True)
    print(f"[30 B6 kernels] max |diff| {err2}; plain ms {b6_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 31. the eleventh main path, counting launches: rollout_transposed, then K26
    t0 = time.perf_counter()
    launches11, lines, off_summary = b6_main_path(dev, wrappers, smi)
    for line in lines:
        print(f"[31 B6 main path] {line}", flush=True)
    print(f"[31 B6 main path] launches {launches11}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 32. K27-K29 against their plain versions, with a seeded (256, 256) relu actor
    t0 = time.perf_counter()
    err2, off_plain_ms, lines = offpolicy_cross_check(dev)
    err.update(err2)
    for line in lines:
        print(f"[32 off-policy kernels] {line}", flush=True)
    print(f"[32 off-policy kernels] max |diff| over agreeing lanes {err2}; plain ms (det) "
          f"{off_plain_ms}; {time.perf_counter() - t0:.1f} s", flush=True)

    # 33. the twelfth main path, counting launches: TD3 with collect="kernel"
    t0 = time.perf_counter()
    launches12, lines, td3_rates, (td3_state, td3_cfg, td3_params) = td3_main_path(
        dev, wrappers, smi)
    off_summary.update(td3_rates)
    for line in lines:
        print(f"[33 TD3 main path] {line}", flush=True)
    print(f"[33 TD3 main path] launches {launches12}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 34. the thirteenth main path, counting launches: SAC and DDPG on the other families
    t0 = time.perf_counter()
    launches13, lines = offpolicy_short_runs(dev, wrappers)
    for line in lines:
        print(f"[34 SAC/DDPG main paths] {line}", flush=True)
    print(f"[34 SAC/DDPG main paths] launches {launches13}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches11[name] + launches12[name] + launches13[name]
                for name in wrappers}
    missing = [name for name in B6_KERNELS + OFF_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the slice-7 main paths launched no {missing}")

    # 35. per-kernel times of K25-K29 at the main paths' shapes, the work
    # model, and one TD3 iteration split into its parts
    t0 = time.perf_counter()
    topo, B = params.topology, CHECK_LANES
    lt = max(topo.lt_max, 1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    X, Y, U, RH = (x.contiguous() for x in ns.init_transposed(params, B, dev))
    action = torch.rand((topo.n_reorder, B), generator=g, device=dev) * hi
    demand = net.sample_demand(params, g, 3, B, device=dev).T.contiguous()
    k25_t = cuda_time(ns.batched_step, params, X, Y, U, RH, action, demand, 3, warmup=2,
                      iters=20)
    _, b6_dems = ns.sample_streams_debug(params, SEED, hi, B, device=dev)
    k26_t = cuda_time(ns.episode_returns_random_policy, params, b6_dems, SEED, hi, warmup=2,
                      iters=20)
    del X, Y, U, RH, action, demand, b6_dems
    state_rows = topo.n_main + topo.n_reorder + topo.n_retail + lt * topo.n_reorder
    work.update({
        "batched_step": bound(B * (2 * state_rows + topo.n_reorder + topo.n_retail + 1) * 4,
                              B * step_ops(topo)),
        "episode_returns_random_policy": bound(
            B * (NUM_STEPS * topo.n_retail + 1) * 4,
            B * NUM_STEPS * (step_ops(topo) + random_action_ops(topo))),
    })
    times.update({"batched_step": (k25_t, {"best_ms": b6_plain_ms["batched_step"]}),
                  "episode_returns_random_policy": (
                      k26_t, {"best_ms": b6_plain_ms["episode_returns_random_policy"]})})
    off_lines = []
    for name, kernel, _, fparams, _, obs_dim, act_dim in offpolicy_families(dev):
        n_bytes, per_step, horizon, weights = offpolicy_work(name, fparams, obs_dim, act_dim,
                                                             "det")
        entry_ms, parts = {}, []
        for mode in OFF_MODES:
            actor, log_std = seeded_offpolicy_actor(obs_dim, act_dim, mode == "sac", dev)
            for lanes in (LEARN_LANES, B):
                entry_ms[mode, lanes] = cuda_time(kernel, fparams, actor, log_std, SEED, lanes,
                                                  mode, "relu", dev, warmup=1, iters=5)
        actor, log_std = seeded_offpolicy_actor(obs_dim, act_dim, False, dev)
        for lanes in (LEARN_LANES, B):
            b_ms, b_by = bound(lanes * n_bytes + weights, lanes * horizon * per_step)
            det = entry_ms["det", lanes]["best_ms"]
            key = "learner" if lanes == LEARN_LANES else "check"
            off_summary[f"{name}_{key}_ms"] = det
            off_summary[f"{name}_{key}_bound_ms"] = b_ms
            line = f"at {lanes} x {horizon}: det {det:.4f} ms through the entry point"
            # the kernel alone on the entry point's route, its plan and inputs made before
            launch, route = offpolicy_kernel_launch(name, kernel, fparams, actor, log_std,
                                                    lanes, dev)
            alone = cuda_time(launch, warmup=1, iters=5)["best_ms"]
            off_summary[f"{name}_{key}_kernel_ms"] = alone
            off_summary[f"{name}_{key}_route"] = route
            line += f", {alone:.4f} ms the kernel alone ({route} route)"
            parts.append(line + f", bound {b_ms:.4f} ms by {b_by} ({b_ms / det:.1%} of the "
                         f"entry point's); sac {entry_ms['sac', lanes]['best_ms']:.4f}, uniform "
                         f"{entry_ms['uniform', lanes]['best_ms']:.4f} ms")
            off_summary[f"{name}_{key}_sac_ms"] = entry_ms["sac", lanes]["best_ms"]
            off_summary[f"{name}_{key}_uniform_ms"] = entry_ms["uniform", lanes]["best_ms"]
        # the kernels line holds the main paths' shape, the learners' lanes
        work[name] = bound(LEARN_LANES * n_bytes + weights, LEARN_LANES * horizon * per_step)
        times[name] = (entry_ms["det", LEARN_LANES], {"best_ms": off_plain_ms[name]})
        off_lines.append(f"{name} {'; '.join(parts)}; {per_step:.0f} operations an env-step "
                         f"(det)")
    print(f"[35 work] K25 per lane {state_rows} state rows read and written, step "
          f"{step_ops(topo)} ops; K26 per env-step step {step_ops(topo)} + actions "
          f"{random_action_ops(topo)} ops; K27-K29: the (256, 256) relu actor "
          f"(mlp_ops) + step + draws + head, det head; " + "; ".join(off_lines), flush=True)
    for name in B6_KERNELS + OFF_KERNELS:
        print_kernel(35, name, times[name], work[name], launches[name])
    parts, split_rate = td3_iteration_split(dev, td3_state, td3_cfg, td3_params)
    print("[35 TD3 iteration] " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f": {split_rate:.6g} trained-steps/s for this iteration at {td3_cfg.num_envs} x "
          f"{NUM_STEPS} env-steps and {td3_cfg.updates_per_iter} updates per period; the "
          f"kernel is {parts['kernel'] / sum(parts.values()):.2%} of it, on {smi}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    off_summary.update({f"split_{k}_ms": v for k, v in parts.items()})
    off_summary.update(split_trained_steps_s=split_rate,
                       k25_ms=k25_t["best_ms"], k26_ms=k26_t["best_ms"])
    return launches, off_summary


def update_times(env, params, cfg, dev, updates):
    """``updates`` updates of ``train`` at ``cfg`` on ``dev``: each one's
    wall time (synchronised at its end) and the metrics."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _, metrics = ppo.train(env, params, cfg, torch.Generator(device=dev).manual_seed(SEED),
                           updates * cfg.num_envs * cfg.rollout_steps, device=dev,
                           progress=progress)
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != updates:
        raise AssertionError(f"xla path metrics not finite: {bad}; {metrics}")
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])], metrics


def rppo_update_times(env, params, cfg, dev, updates):
    """``update_times`` of ``recurrent_ppo.train``."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _, _, metrics = rppo.train(env, params, cfg, torch.Generator(device=dev).manual_seed(SEED),
                               updates * cfg.num_envs * cfg.rollout_steps, device=dev,
                               progress=progress)
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != updates:
        raise AssertionError(f"recurrent path metrics not finite: {bad}; {metrics}")
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])], metrics


def auto_reset_share(env, params, cfg, dev, times=update_times):
    """One xla update at ``cfg`` (``times``: PPO's or recurrent PPO's) with
    ``vecenv.auto_reset`` timed inside it (the card synchronised around
    each call): (its ms in the update, the update's ms, calls)."""
    import torch

    from or_gym_inventory_torch.vector import vecenv
    inner, spent = vecenv.auto_reset, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    vecenv.auto_reset = timed
    try:
        times(env, params, cfg, dev, 1)                             # warm
        spent.clear()
        ms, _ = times(env, params, cfg, dev, 1)
    finally:
        vecenv.auto_reset = inner
    return sum(spent) * 1e3, ms[0], len(spent)


def xla_phases(dev, wrappers, smi):
    """Phases 36-38, the fused policy+env update (``rollout="xla"``, plain
    PyTorch, no kernel on its path) and the agents: 36, Newsvendor at
    benchmark_newsvendor.py's PPO_CFG, counting launches (none) with every
    plain kernel version patched to raise, its trained-steps/s beside the
    kernel path's at the same config, and ``vecenv.auto_reset``'s share of
    an update; 37, ``PPOAgent`` trains PPO_CFG for XLA_AGENT_UPDATES
    updates, saves, and a fresh agent loads it and acts as it does, bit for
    bit; ``A2CAgent`` with ``A2CConfig()`` takes a few updates; 38,
    InvManagement and NetInvMgmt take one update each at ``PPOConfig()``'s
    defaults. Every loss finite. Returns the summary."""
    import os

    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import A2CAgent, PPOAgent
    from or_gym_inventory_torch.agents import a2c, ppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import _build
    params = nv.default_params(env_config=NV_ENV_CONFIG)
    xla_cfg = ppo.PPOConfig(**dict(NV_PPO_RECIPE, rollout="xla"))
    samples = xla_cfg.num_envs * xla_cfg.rollout_steps
    summary = {}

    # 36. the counted xla path, its rate beside the kernel path's, auto_reset
    t0 = time.perf_counter()
    reset_counts(wrappers)
    with no_plain_versions():
        xla_ms, metrics = update_times(nv.ENV, params, xla_cfg, dev, XLA_RATE_UPDATES)
    launches = read_counts(wrappers)
    if any(launches.values()):
        raise AssertionError(f"the xla path launched kernels: {launches}")
    kernel_ms, _ = update_times(nv.ENV, params, ppo.PPOConfig(**NV_PPO_RECIPE), dev,
                                    XLA_RATE_UPDATES)
    xla_best, kernel_best = min(xla_ms[1:]), min(kernel_ms[1:])
    reset_ms, update_ms, calls = auto_reset_share(nv.ENV, params, xla_cfg, dev)
    summary.update(nv_update_ms=xla_best, nv_trained_steps_s=samples / xla_best * 1e3,
                   nv_kernel_update_ms=kernel_best,
                   nv_kernel_trained_steps_s=samples / kernel_best * 1e3,
                   auto_reset_ms=reset_ms, auto_reset_update_ms=update_ms)
    print(f"[36 xla main path] Newsvendor PPO_CFG (256 x 50, 8 minibatches, 4 epochs), "
          f'rollout="xla": no kernel launched, no plain kernel version; update ms '
          f"{', '.join(f'{t:.3f}' for t in xla_ms)}; best {xla_best:.3f} ms = "
          f"{samples / xla_best * 1e3:.6g} trained-steps/s, beside rollout=\"kernel\" (K18) at "
          f"the same config: {', '.join(f'{t:.3f}' for t in kernel_ms)}; best {kernel_best:.3f} "
          f"ms = {samples / kernel_best * 1e3:.6g} trained-steps/s ({kernel_best / xla_best:.3f} "
          f"of the xla update's time), on {smi}; launches {launches}", flush=True)
    print(f"[36 xla main path] metrics: " + "; ".join(
        f"{k} {', '.join(f'{x:.6g}' for x in v)}" for k, v in metrics.items()), flush=True)
    print(f"[36 xla main path] vecenv.auto_reset (a whole batch reset every step): "
          f"{reset_ms:.3f} ms over {calls} calls in one update of {update_ms:.3f} ms "
          f"({reset_ms / update_ms:.1%}; the card synchronised around each call), on {smi}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 37. the agents: train, save, load, act; A2C
    t0 = time.perf_counter()
    root = _build.BUILD_DIR / "chip_smoke_agents"
    kw = dict(model_dir=str(root / "models"), log_dir=str(root / "logs"), force_retrain=True,
              device=dev)
    agent = PPOAgent(nv.ENV, nv.default_params, config=xla_cfg, **kw)
    agent.train(NV_ENV_CONFIG, XLA_AGENT_UPDATES * samples)
    log = agent.training_log
    if len(log["update"]) != XLA_AGENT_UPDATES or not all(
            np.isfinite(log[k]).all() for k in ("pg_loss", "v_loss", "entropy")):
        raise AssertionError(f"PPOAgent's training log: {log}")
    path = agent.save()
    fresh = PPOAgent(nv.ENV, nv.default_params, config=xla_cfg, **kw)
    fresh.load(path)
    _, ts = nv.ENV.reset(params, torch.Generator(device=dev).manual_seed(7), 4_096, device=dev)
    acts = [a.device_policy(nv.ENV, params)(None, ts.obs, None, 0) for a in (agent, fresh)]
    exact("PPOAgent: the loaded agent's device_policy actions", acts[1], acts[0])

    class host:   # what get_action reads of a host env (no gymnasium on this machine)
        action_space = nv.ENV.action_space(params)
    one = [a.get_action(ts.obs[0].cpu().numpy(), host) for a in (agent, fresh)]
    if not (np.array_equal(one[0], one[1]) and one[0].shape == (1,)):
        raise AssertionError(f"PPOAgent get_action after load: {one}")
    a2c_agent = A2CAgent(nv.ENV, nv.default_params, **kw)
    a2c_cfg = a2c_agent.config
    a2c_agent.train(NV_ENV_CONFIG, XLA_A2C_UPDATES * a2c_cfg.num_envs * a2c_cfg.rollout_steps)
    a2c_log = a2c_agent.training_log
    if a2c_cfg != a2c.A2CConfig() or not all(np.isfinite(v).all() for v in a2c_log.values()):
        raise AssertionError(f"A2CAgent: {a2c_cfg}; {a2c_log}")
    summary.update(agent_train_s=agent.training_time, a2c_train_s=a2c_agent.training_time,
                   a2c_trained_steps_s=XLA_A2C_UPDATES * a2c_cfg.num_envs
                   * a2c_cfg.rollout_steps / a2c_agent.training_time)
    print(f"[37 agents] PPOAgent PPO_CFG on the xla path: {XLA_AGENT_UPDATES} updates in "
          f"{agent.training_time:.2f} s, last mean_step_reward {log['mean_step_reward'][-1]:.6g}; "
          f"saved to {os.path.basename(path)}, a fresh agent loaded it: device_policy on 4,096 "
          f"obs and get_action {one[0].tolist()} equal bit for bit; A2CAgent, A2CConfig() "
          f"(256 x 8, RMSprop): {XLA_A2C_UPDATES} updates in {a2c_agent.training_time:.2f} s "
          f"({summary['a2c_trained_steps_s']:.6g} trained-steps/s with its host work), v_loss "
          f"{', '.join(f'{x:.4g}' for x in a2c_log['v_loss'][-3:])}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 38. one update at PPOConfig()'s defaults on the other two families
    t0 = time.perf_counter()
    for label, mod, p in (("InvManagement", im, im.default_params()),
                          ("NetInvMgmt", net, net.default_params())):
        ms, m = update_times(mod.ENV, p, ppo.PPOConfig(), dev, 1)
        summary[f"{label}_default_update_ms"] = ms[0]
        print(f"[38 xla defaults] {label}, PPOConfig() (1,024 x 64, 8 minibatches, 4 epochs, "
              f'rollout="xla"): one update {ms[0]:.3f} ms (its first, the model built), '
              f"pg_loss {m['pg_loss'][0]:.6g}, v_loss {m['v_loss'][0]:.6g}, entropy "
              f"{m['entropy'][0]:.6g}, episodes {m['episodes'][0]:.0f}", flush=True)
    print(f"[38 xla defaults] {time.perf_counter() - t0:.1f} s", flush=True)
    return summary


def elementwise_policy(space, dev):
    """Phase 41's deterministic policy: each lane's orders from its own obs
    alone, elementwise (half the action box's top less a quarter of the
    obs' first entries, clipped), so that nothing but the env's draws could
    couple the lanes."""
    import numpy as np
    import torch
    low = torch.as_tensor(space.low, dtype=torch.float32, device=dev)
    high = torch.as_tensor(np.where(np.isinf(space.high), 1e4, space.high),
                           dtype=torch.float32, device=dev)
    ints = np.issubdtype(space.dtype, np.integer)

    def policy(_state, obs, _generator, _t):
        x = obs[:, :low.shape[0]].to(torch.float32)
        a = torch.minimum(torch.maximum(0.5 * high - 0.25 * x, low), high)
        return a.to(torch.int32) if ints else a
    return policy


def rppo_xla_phases(dev, wrappers, smi, err):
    """Phases 39-41, the recurrent fused policy+env update
    (``recurrent_ppo`` with ``rollout="xla"``, plain PyTorch, no kernel on
    its path), the recurrent agents and the seeded evaluators. 39, counted:
    the roster's PPO_LSTM configs on the three families (RPPO_XLA_CASES),
    every plain kernel version patched to raise and no kernel launched,
    the best of RPPO_RATE_UPDATES updates, trained-steps/s and
    ``auto_reset``'s share; beside InvManagement's, the kernel path's
    update at the same config, K24 counted. 40: ``RecurrentPPOAgent`` with
    ``rollout="kernel"`` on InvManagement (K24 counted) and
    ``A2CLSTMAgent`` (``A2CLSTMConfig()``, xla) train, save and load; the
    loaded agents' ``get_action`` over an episode and their
    ``device_policy_stateful`` through ``evaluate_episodes_seeded_stateful``
    equal the trained ones' bit for bit. Before each run of K24 on a path
    (39's 512 x 50, 40's RPPO_AGENT_ENVS x 30), K24 against its plain
    version at that shape with ``seeded_lstm_actor`` (phase 25's gates,
    ``k24_against_plain``), its max |diff| into ``err``. 41:
    ``evaluate_episodes_seeded`` at SEEDED_LANES lanes a family with
    ``elementwise_policy``, its env-steps/s; a permuted sub-batch of
    SEEDED_SUB seeds gives the full batch's rows bit for bit; SEEDED_CPU
    seeds on the card against the CPU: the draws and InvManagement's
    integer states, obs and actions exact, its totals exactly those of the
    card's step chain on the CPU's actions and demand (the card's f32 powf
    and stage sum round otherwise than the CPU's), every family's totals
    against the CPU's by the fraction-closeness rule. Returns (launches,
    summary)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import A2CLSTMAgent, RecurrentPPOAgent
    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time
    from or_gym_inventory_torch.vector import (evaluate_episodes_seeded,
                                               evaluate_episodes_seeded_stateful)
    mods = {"im": im, "net": net, "nv": nv}
    totals = {name: 0 for name in wrappers}
    summary = {}

    def k24_check(params, B, label):
        """K24 against plain at this path's shape; its line."""
        actor, log_std = seeded_lstm_actor(params, dev)
        case = f"{label}, {B} x {im.ENV.horizon(params)}"
        _, _, shares = k24_against_plain(params, actor, log_std, B, dev, case)
        err["rollout_traj_im_lstm"] = max([err["rollout_traj_im_lstm"]]
                                          + [e for _, e in shares.values()])
        return (f"K24 against plain at {B} x {im.ENV.horizon(params)} (seeded actor, encoder "
                f"64, hidden 128): demand bit for bit, lanes agreeing "
                + ", ".join(f"{k} {sh:.4%}" for k, (sh, _) in shares.items())
                + f", max |diff| over them {max(e for _, e in shares.values()):.6g}")

    # 39. the recurrent xla path on three families, counted; the kernel path beside IM's
    t0 = time.perf_counter()
    for label, fam, env_config, kw, source in RPPO_XLA_CASES:
        mod = mods[fam]
        params = mod.default_params(env_config=env_config)
        cfg = rppo.RecurrentPPOConfig(**kw)
        samples = cfg.num_envs * cfg.rollout_steps
        reset_counts(wrappers)
        with no_plain_versions():
            ms, metrics = rppo_update_times(mod.ENV, params, cfg, dev, RPPO_RATE_UPDATES)
        launches = read_counts(wrappers)
        if any(launches.values()):
            raise AssertionError(f"the recurrent xla path launched kernels: {launches}")
        best = min(ms)
        reset_ms, update_ms, calls = auto_reset_share(mod.ENV, params, cfg, dev,
                                                      rppo_update_times)
        key = fam + "_rppo_xla"
        summary.update({f"{key}_update_ms": best, f"{key}_trained_steps_s": samples / best * 1e3,
                        f"{key}_auto_reset_ms": reset_ms, f"{key}_auto_reset_update_ms": update_ms})
        print(f"[39 RPPO xla main path] {label} ({source}: {cfg.num_envs} x "
              f"{cfg.rollout_steps}, horizon {mod.ENV.horizon(params)}, encoder 64, hidden 128, "
              f"{cfg.update_epochs} epochs x {cfg.num_minibatches} env-sliced minibatches), "
              f'rollout="xla": no kernel launched, no plain kernel version; update ms '
              f"{', '.join(f'{t:.3f}' for t in ms)}; best {best:.3f} ms = "
              f"{samples / best * 1e3:.6g} trained-steps/s; vecenv.auto_reset {reset_ms:.3f} ms "
              f"over {calls} calls in one update of {update_ms:.3f} ms ({reset_ms / update_ms:.1%}; "
              f"the card synchronised around each call), on {smi}", flush=True)
        print(f"[39 RPPO xla main path] {label} metrics: " + "; ".join(
            f"{k} {', '.join(f'{x:.6g}' for x in v)}" for k, v in metrics.items()), flush=True)
        if fam == "im":
            print(f"[39 RPPO xla main path] {label}: {k24_check(params, cfg.num_envs, label)}",
                  flush=True)
            kcfg = cfg.replace(rollout="kernel")
            reset_counts(wrappers)
            with no_plain_versions():
                kms, _ = rppo_update_times(mod.ENV, params, kcfg, dev, RPPO_RATE_UPDATES)
            launches = read_counts(wrappers)
            moved = {n: c for n, c in launches.items() if c}
            if moved != {"rollout_traj_im_lstm": RPPO_RATE_UPDATES}:
                raise AssertionError(f"the recurrent kernel path launched {moved}")
            totals = {n: totals[n] + launches[n] for n in wrappers}
            kbest = min(kms)
            summary.update(im_rppo_kernel_update_ms=kbest,
                           im_rppo_kernel_trained_steps_s=samples / kbest * 1e3)
            print(f'[39 RPPO xla main path] {label} beside rollout="kernel" at the same '
                  f"config: update ms {', '.join(f'{t:.3f}' for t in kms)}; best {kbest:.3f} "
                  f"ms = {samples / kbest * 1e3:.6g} trained-steps/s ({kbest / best:.3f} of the "
                  f"xla update's time); K24 launched {launches['rollout_traj_im_lstm']} times, "
                  f"nothing else", flush=True)
    print(f"[39 RPPO xla main path] {time.perf_counter() - t0:.1f} s", flush=True)

    # 40. the recurrent agents: train, save, load, act, the stateful evaluator
    t0 = time.perf_counter()
    root = _build.BUILD_DIR / "chip_smoke_agents"
    kw = dict(model_dir=str(root / "models"), log_dir=str(root / "logs"), force_retrain=True,
              device=dev)
    params = im.default_params()
    space = im.ENV.action_space(params)

    class host:   # what get_action reads of a host env (no gymnasium on this machine)
        action_space = space
        period = 0

    kcfg = rppo.RecurrentPPOConfig(num_envs=RPPO_AGENT_ENVS, rollout_steps=NUM_STEPS,
                                   rollout="kernel")
    runs = (("RecurrentPPOAgent", RecurrentPPOAgent, kcfg, RPPO_AGENT_UPDATES),
            ("A2CLSTMAgent", A2CLSTMAgent, rppo.A2CLSTMConfig(), XLA_A2C_UPDATES))
    seeds = torch.arange(4000, 4000 + RPPO_AGENT_ENVS)
    for label, cls, cfg, updates in runs:
        agent = cls(im.ENV, im.default_params, config=cfg, **kw)
        if cfg.rollout == "kernel":
            print(f"[40 RPPO agents] {label}: {k24_check(params, cfg.num_envs, label)}",
                  flush=True)
        reset_counts(wrappers)
        agent.train(None, updates * cfg.num_envs * cfg.rollout_steps)
        launches = read_counts(wrappers)
        moved = {n: c for n, c in launches.items() if c}
        want = {"rollout_traj_im_lstm": updates} if cfg.rollout == "kernel" else {}
        if moved != want:
            raise AssertionError(f"{label} launched {moved}, not {want}")
        totals = {n: totals[n] + launches[n] for n in wrappers}
        log = agent.training_log
        if len(log["update"]) != updates or not all(np.isfinite(v).all() for v in log.values()):
            raise AssertionError(f"{label}'s training log: {log}")
        if agent.device_policy(im.ENV, params) is not None:
            raise AssertionError(f"{label}.device_policy is not None")
        fresh = cls(im.ENV, im.default_params, config=cfg, **kw)
        fresh.load(agent.save())
        state, ts = im.reset(params, None, 1, device=dev)
        acts = []
        for t in range(NUM_STEPS):   # one episode on a demand of 20 a period
            host.period = t
            pair = [a.get_action(ts.obs[0].cpu().numpy(), host) for a in (agent, fresh)]
            if not np.array_equal(pair[0], pair[1]):
                raise AssertionError(f"{label} get_action after load at period {t}: {pair}")
            acts.append(pair[0])
            state, ts = im.step_with_demand(params, state,
                                            torch.as_tensor(pair[0], device=dev)[None],
                                            torch.tensor([20], dtype=torch.int32, device=dev))
        evals = [evaluate_episodes_seeded_stateful(im.ENV, params,
                                                   *a.device_policy_stateful(im.ENV, params),
                                                   seeds, device=dev)[0] for a in (agent, fresh)]
        exact(f"{label}: the loaded agent's seeded stateful returns", evals[1], evals[0])
        mean = float(evals[0].double().mean())
        summary[f"{label}_train_s"] = agent.training_time
        summary[f"{label}_seeded_mean"] = mean
        print(f"[40 RPPO agents] {label} ({cfg.num_envs} x {cfg.rollout_steps}, "
              f'rollout="{cfg.rollout}"): {updates} updates in {agent.training_time:.2f} s, '
              f"launches {moved or 'none'}; saved, loaded by a fresh agent: get_action over "
              f"{NUM_STEPS} periods (carry reset at period 0; last {acts[-1].tolist()}) and "
              f"evaluate_episodes_seeded_stateful on {RPPO_AGENT_ENVS} seeds equal bit for "
              f"bit, mean return {mean:.6g}", flush=True)
    print(f"[40 RPPO agents] {time.perf_counter() - t0:.1f} s", flush=True)

    # 41. the seeded evaluators at scale; lane independence; the card against the CPU
    t0 = time.perf_counter()
    keys = {"im": "demand_realized", "net": "demand", "nv": "demand"}
    for fam, env_config in (("im", None), ("net", None), ("nv", NV_ENV_CONFIG)):
        mod = mods[fam]
        params = mod.default_params(env_config=env_config)
        policy = elementwise_policy(mod.ENV.action_space(params), dev)
        cpu_policy = elementwise_policy(mod.ENV.action_space(params), "cpu")
        seeds = torch.arange(SEEDED_LANES, device=dev) + 10_000
        horizon = mod.ENV.horizon(params)
        full, traj = evaluate_episodes_seeded(mod.ENV, params, policy, None, seeds, device=dev)
        if full.shape != (SEEDED_LANES,) or not torch.isfinite(full).all():
            raise AssertionError(f"seeded {fam}: shape {tuple(full.shape)} or non-finite")
        idx = torch.randperm(SEEDED_LANES, generator=torch.Generator().manual_seed(7))[
            :SEEDED_SUB].to(dev)
        part, ptraj = evaluate_episodes_seeded(mod.ENV, params, policy, None, seeds[idx],
                                               device=dev)
        exact(f"seeded {fam}: a permuted sub-batch's totals", part, full[idx])
        exact(f"seeded {fam}: a permuted sub-batch's demand", ptraj.info[keys[fam]],
              traj.info[keys[fam]][:, idx])
        exact(f"seeded {fam}: a permuted sub-batch's obs", ptraj.obs, traj.obs[:, idx])
        card, ctraj = evaluate_episodes_seeded(mod.ENV, params, policy, None,
                                               seeds[:SEEDED_CPU], device=dev)
        host_t, htraj = evaluate_episodes_seeded(mod.ENV, params, cpu_policy, None,
                                                 seeds[:SEEDED_CPU].cpu(), device="cpu")
        if fam == "im":
            for k in ("demand_realized", "current_inventory_on_hand", "current_backlog"):
                exact(f"seeded im: {k} on the card against the CPU", ctraj.info[k].cpu(),
                      htraj.info[k])
            exact("seeded im: obs on the card against the CPU", ctraj.obs.cpu(), htraj.obs)
            exact("seeded im: actions on the card against the CPU", ctraj.action.cpu(),
                  htraj.action)
            # the totals: the card's reward chain on the CPU's actions and demand,
            # summed period by period as the evaluator sums them
            state, _ = im.reset(params, None, SEEDED_CPU, device=dev)
            chain = torch.zeros(SEEDED_CPU, device=dev)
            for t in range(horizon):
                state, ts = im.step_with_demand(params, state, htraj.action[t].to(dev),
                                                htraj.info["demand_realized"][t].to(dev))
                chain = chain + ts.reward
            exact("seeded im: totals on the card against the card's step chain on the CPU's "
                  "actions and demand", card, chain)
        gap = (ctraj.info[keys[fam]].cpu().double() - htraj.info[keys[fam]].double()).abs()
        dem_share = float((gap == 0).double().mean())
        ok = torch.isclose(card.cpu(), host_t, rtol=1e-4, atol=1e-2)
        bit = bool(torch.equal(card.cpu(), host_t))
        if float(ok.double().mean()) < LANE_SHARE or dem_share < SEEDED_DEMAND_SHARE \
                or float(gap.max()) > 1:
            raise AssertionError(f"seeded {fam} on the card against the CPU: totals share "
                                 f"{float(ok.double().mean())}, demand share {dem_share}")
        tm = cuda_time(evaluate_episodes_seeded, mod.ENV, params, policy, None, seeds, dev,
                       warmup=1, iters=3)
        steps = SEEDED_LANES * horizon
        summary.update({f"{fam}_seeded_ms": tm["best_ms"],
                        f"{fam}_seeded_env_steps_s": steps / tm["best_ms"] * 1e3,
                        f"{fam}_seeded_mean": float(full.double().mean())})
        print(f"[41 seeded eval] {mod.ENV.name} at {SEEDED_LANES} lanes x {horizon} "
              f"(elementwise deterministic policy): best {tm['best_ms']:.3f} ms (mean "
              f"{tm['mean_ms']:.3f}) = {steps / tm['best_ms'] * 1e3:.6g} env-steps/s on {smi}, "
              f"mean return {float(full.double().mean()):.6g}; a permuted sub-batch of "
              f"{SEEDED_SUB} seeds equal to the full batch's rows bit for bit (totals, demand, "
              f"obs); {SEEDED_CPU} seeds on the card against the CPU: demand equal on "
              f"{dem_share:.4%} of draws, totals within rtol 1e-4 atol 1e-2 on "
              f"{float(ok.double().mean()):.2%} of lanes, bit for bit: {bit}"
              + ("; integer states, obs and actions bit for bit, the totals those of the "
                 "card's step chain on the CPU's actions and demand bit for bit"
                 if fam == "im" else ""), flush=True)
    print(f"[41 seeded eval] {time.perf_counter() - t0:.1f} s", flush=True)
    return totals, summary


def offpolicy_iteration_times(env, params, cfg, dev, iters):
    """The iterations of ``make_offpolicy``'s xla update at ``cfg`` past its
    uniform warmup (``start_steps``), each synchronised and timed on the
    host: (ms per iteration, the last iteration's metrics, warmup count)."""
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    init, update, _ = op.make_offpolicy(env, params, cfg, device=dev)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    state = init(generator)
    warm = -(-cfg.start_steps // cfg.num_envs)
    for _ in range(warm):
        state, _ = update(state, generator)
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, metrics = update(state, generator)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise AssertionError(f"off-policy xla metrics not finite: {metrics}")
    return ms, metrics, warm


def offpolicy_xla_phases(dev, wrappers, smi):
    """Phases 42-44, slice 10: the off-policy step-interleaved update
    (``OffPolicyConfig(collect="xla")``, plain PyTorch, no kernel on its
    path), the agents by name and the heuristic roster. 42, counted: SAC,
    TD3 and DDPG on each family's defaults (Newsvendor's ENV_CONFIG_EVAL) at
    ``make_agent``'s config (32 envs, (256, 256) networks, batch 256, one
    update an iteration), every plain kernel version patched to raise and
    no kernel launched, the median of OFF_XLA_ITERS iterations past the
    warmup and trained-steps/s; beside TD3 on InvManagement the same
    iteration at tools/validate_kernel_collect.py's config. 43:
    ``make_agent`` for the seven names, a family each, a few updates; every
    learner saved, loaded and acting bit for bit; ``TD3Agent`` with
    ``collect="kernel"`` on InvManagement, K27 counted, its
    ``device_policy`` through ``evaluate_episodes_seeded`` equal before and
    after the load. 44: ``poisson_ppf`` on the card against SciPy on the
    host (JAX's grids exact, PPF_POINTS random points with at most
    PPF_ALLOWED mismatches, none past 1); every device heuristic through
    ``evaluate_episodes_seeded`` at HEUR_LANES lanes, env-steps/s; the
    card's actions against the CPU's on the CPU trajectory's obs,
    teacher-forced (exact but on Newsvendor, there NV_HEUR_SHARE and never
    past 1); each heuristic's figure on RESULTS.md's protocol. Returns
    (launches, summary)."""
    import numpy as np
    import torch
    from scipy import stats

    from or_gym_inventory_torch.agents import heuristics as H
    from or_gym_inventory_torch.agents import make_agent
    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.envs import registry
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops.distributions import poisson_ppf
    from or_gym_inventory_torch.utils.profiling import cuda_time
    from or_gym_inventory_torch.vector import evaluate_episodes_seeded
    fams = (("Newsvendor", "nv", nv, nv.default_params(env_config=NV_ENV_CONFIG)),
            ("InvManagement", "im", im, im.default_params()),
            ("NetInvMgmt", "net", net, net.default_params()))
    totals = {name: 0 for name in wrappers}
    summary = {}

    # 42. the off-policy xla iteration, counted, at make_agent's config
    t0 = time.perf_counter()
    for label, fam, mod, params in fams:
        for algo in ("sac", "td3", "ddpg"):
            cfg = op.OffPolicyConfig(algo=algo, **OFF_XLA_RECIPE)
            reset_counts(wrappers)
            with no_plain_versions():
                ms, metrics, warm = offpolicy_iteration_times(mod.ENV, params, cfg, dev,
                                                              OFF_XLA_ITERS)
            launches = read_counts(wrappers)
            if any(launches.values()):
                raise AssertionError(f"the off-policy xla path launched kernels: {launches}")
            med = float(np.median(ms))
            key = f"{fam}_{algo}_xla"
            summary.update({f"{key}_iter_ms": med,
                            f"{key}_trained_steps_s": cfg.num_envs / med * 1e3})
            print(f"[42 off-policy xla] {label} {algo.upper()} (make_agent's config: "
                  f"{cfg.num_envs} envs, (256, 256), batch 256, 1 update an iteration), "
                  f'collect="xla": no kernel launched, no plain kernel version; {OFF_XLA_ITERS} '
                  f"iterations past {warm} of warmup: median {med:.3f} ms (min {min(ms):.3f}, "
                  f"max {max(ms):.3f}) = {cfg.num_envs / med * 1e3:.6g} trained-steps/s on "
                  f"{smi}; mean_step_reward {float(metrics['mean_step_reward']):.6g}, alpha "
                  f"{float(metrics['alpha']):.6g}", flush=True)
            if fam == "im" and algo == "td3":
                vcfg = op.OffPolicyConfig(algo="td3", **OFF_XLA_VKC)
                reset_counts(wrappers)
                with no_plain_versions():
                    vms, _, vwarm = offpolicy_iteration_times(mod.ENV, params, vcfg, dev,
                                                              OFF_XLA_VKC_ITERS)
                launches = read_counts(wrappers)
                if any(launches.values()):
                    raise AssertionError(f"the off-policy xla path launched kernels: {launches}")
                vmed = float(np.median(vms))
                summary.update(im_td3_xla_vkc_iter_ms=vmed,
                               im_td3_xla_vkc_trained_steps_s=vcfg.num_envs / vmed * 1e3,
                               im_td3_xla_vkc_update_ms=vmed / vcfg.updates_per_iter)
                print(f"[42 off-policy xla] {label} TD3 at validate_kernel_collect.py's config "
                      f"(1,024 envs, buffer 200,704, batch 256, 32 updates an iteration): "
                      f"{OFF_XLA_VKC_ITERS} iterations past {vwarm} of warmup: median "
                      f"{vmed:.3f} ms = {vmed / vcfg.updates_per_iter:.3f} ms an update = "
                      f"{vcfg.num_envs / vmed * 1e3:.6g} trained-steps/s; no kernel launched",
                      flush=True)
    print(f"[42 off-policy xla] {time.perf_counter() - t0:.1f} s", flush=True)

    # 43. make_agent's seven names: train, save, load, act; TD3 on the kernel path
    t0 = time.perf_counter()
    root = _build.BUILD_DIR / "chip_smoke_agents"
    kw = dict(model_dir=str(root / "models"), log_dir=str(root / "logs"), force_retrain=True,
              device=dev)
    for name, env_id, updates in AGENT_NAMES:
        env, params = registry.make_functional(env_id)
        agent = make_agent(name, env_id, **kw)
        cfg = agent.config   # an off-policy iteration is one env step
        steps = updates * cfg.num_envs * getattr(cfg, "rollout_steps", 1)
        reset_counts(wrappers)
        agent.train(None, steps)
        launches = read_counts(wrappers)
        if any(launches.values()):
            raise AssertionError(f"make_agent({name!r}) launched kernels: {launches}")
        fresh = make_agent(name, env_id, **kw)
        fresh.load(agent.save())

        class host:   # what get_action reads of a host env (no gymnasium on this machine)
            action_space = env.action_space(params)
            period = 0
        _, ts = env.reset(params, torch.Generator(device=dev).manual_seed(3), 1, device=dev)
        pair = [a.get_action(ts.obs[0].cpu().numpy(), host) for a in (agent, fresh)]
        if not np.array_equal(pair[0], pair[1]):
            raise AssertionError(f"make_agent({name!r}) get_action after load: {pair}")
        summary[f"make_agent_{name}_train_s"] = agent.training_time
        print(f"[43 agents by name] make_agent({name!r}, {env_id!r}): {type(agent).__name__}, "
              f"{steps} env-steps in {agent.training_time:.2f} s, no kernel launched; saved, "
              f"loaded, get_action {pair[0].tolist()} equal bit for bit", flush=True)
    params = im.default_params()
    kcfg = op.OffPolicyConfig(collect="kernel", num_envs=LEARN_LANES, buffer_size=200_704,
                              batch_size=256, start_steps=LEARN_LANES * NUM_STEPS)
    agent = op.TD3Agent(im.ENV, im.default_params, config=kcfg, **kw)
    reset_counts(wrappers)
    with no_plain_versions():
        agent.train(None, 2 * LEARN_LANES * NUM_STEPS)
    launches = read_counts(wrappers)
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"rollout_traj_im_offpolicy": 2}:
        raise AssertionError(f"TD3Agent(collect='kernel') launched {moved}, not K27 twice")
    totals = {n: totals[n] + launches[n] for n in wrappers}
    fresh = op.TD3Agent(im.ENV, im.default_params, config=kcfg, **kw)
    fresh.load(agent.save())
    seeds = torch.arange(4000, 4000 + SEEDED_LANES, device=dev)
    evals = [evaluate_episodes_seeded(im.ENV, params, a.device_policy(im.ENV, params), None,
                                      seeds, device=dev)[0] for a in (agent, fresh)]
    exact("TD3Agent(collect='kernel'): the loaded agent's seeded returns", evals[1], evals[0])
    summary.update(td3_kernel_agent_train_s=agent.training_time,
                   td3_kernel_agent_seeded_mean=float(evals[0].double().mean()))
    print(f"[43 agents by name] TD3Agent collect=\"kernel\" on InvManagement ({LEARN_LANES} x "
          f"{NUM_STEPS}, the uniform warmup then the det head, 30 updates each): "
          f"{agent.training_time:.2f} s, K27 launched twice, nothing else, no plain version; "
          f"saved, loaded; device_policy through evaluate_episodes_seeded on {SEEDED_LANES} "
          f"seeds equal bit for bit, mean return {float(evals[0].double().mean()):.6g}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 44. the heuristic roster on the card
    t0 = time.perf_counter()
    grid_q = np.array([0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999,
                       0.833333, 0.6, 0.3711], np.float32)
    for mu in (0.5, 5, 20, 200, 500, 1200, 1440, 2000, 4000):
        got = poisson_ppf(torch.as_tensor(grid_q, device=dev), float(mu)).cpu().numpy()
        if not np.array_equal(got, stats.poisson.ppf(grid_q.astype(np.float64), mu)):
            raise AssertionError(f"poisson_ppf on the card off scipy at mu {mu}: {got}")
    rng = np.random.default_rng(SEED)
    for n, (lo, hi) in ((500, (0.5, 5000.0)), (200, (0.1, 500.0)), (200, (500.0, 2000.0))):
        q = rng.uniform(0.001, 0.999, n).astype(np.float32)
        mu = (np.exp(rng.uniform(np.log(lo), np.log(hi), n)) if n == 500
              else rng.uniform(lo, hi, n)).astype(np.float32)
        got = poisson_ppf(torch.as_tensor(q, device=dev), torch.as_tensor(mu, device=dev))
        if not np.array_equal(got.cpu().numpy(), stats.poisson.ppf(q.astype(np.float64),
                                                                   mu.astype(np.float64))):
            raise AssertionError(f"poisson_ppf on the card off scipy on JAX's grid {lo}-{hi}")
    q = rng.uniform(0.001, 0.999, PPF_POINTS).astype(np.float32)
    mu = rng.uniform(0.1, 16_000.0, PPF_POINTS).astype(np.float32)
    qd, mud = torch.as_tensor(q, device=dev), torch.as_tensor(mu, device=dev)
    got = poisson_ppf(qd, mud).cpu().numpy()
    want = stats.poisson.ppf(q.astype(np.float64), mu.astype(np.float64))
    miss = int((got != want).sum())
    worst = float(np.abs(got - want).max())
    if miss > PPF_ALLOWED or worst > 1:
        raise AssertionError(f"poisson_ppf on the card: {miss} of {PPF_POINTS} off scipy, "
                             f"worst by {worst}")
    ppf_t = cuda_time(poisson_ppf, qd, mud, warmup=1, iters=3)
    summary.update(ppf_mismatches=miss, ppf_points=PPF_POINTS, ppf_ms=ppf_t["best_ms"])
    print(f"[44 heuristics] poisson_ppf on the card: JAX's grids (tests/test_distributions.py:"
          f"126-163, tests/test_heuristics.py:20-36) equal to scipy; {PPF_POINTS} random (q, mu), "
          f"mu 0.1-16,000: {miss} off scipy (allowed {PPF_ALLOWED}), worst by {worst:g}; "
          f"{ppf_t['best_ms']:.3f} ms a call on them (23 float64 bisection steps) on {smi}",
          flush=True)
    roster = {"nv": [H.OrderUpToHeuristicAgent(0.8), H.OrderUpToHeuristicAgent(1.0),
                     H.OrderUpToHeuristicAgent(1.2), H.ClassicNewsvendorAgent("k_vs_h", 1.0),
                     H.ClassicNewsvendorAgent("profit_margin", 1.0), H.sSPolicyAgent()],
              "im": [H.BaseStockAgent(sf) for sf in (0.8, 1.0, 1.2)],
              "net": [H.ConstantOrderAgent(0.05), H.ConstantOrderAgent(0.1)]}
    for label, fam, mod, params in fams:
        horizon = mod.ENV.horizon(params)
        for agent in roster[fam]:
            policy = agent.device_policy(mod.ENV, params)
            seeds = torch.arange(HEUR_LANES, device=dev) + 20_000
            full, _ = evaluate_episodes_seeded(mod.ENV, params, policy, None, seeds, device=dev)
            if not torch.isfinite(full).all():
                raise AssertionError(f"{agent.name}: non-finite returns")
            tm = cuda_time(evaluate_episodes_seeded, mod.ENV, params, policy, None, seeds, dev,
                           warmup=0, iters=2)
            rate = HEUR_LANES * horizon / tm["best_ms"] * 1e3
            # teacher-forced: the card's policy on the CPU trajectory's obs
            _, htraj = evaluate_episodes_seeded(mod.ENV, params, policy, None,
                                                torch.arange(HEUR_CPU) + 20_000, device="cpu")
            card = torch.stack([policy(None, htraj.obs[t].to(dev), None, t).cpu()
                                for t in range(horizon)])
            gap = (card.double() - htraj.action.double()).abs()
            share = float((gap == 0).double().mean())
            if fam == "nv":
                if share < NV_HEUR_SHARE or float(gap.max()) > 1:
                    raise AssertionError(f"{agent.name} on the card against the CPU: share "
                                         f"{share}, worst {float(gap.max())}")
            else:
                exact(f"{agent.name}: the card's actions on the CPU's obs", card, htraj.action)
            start, n_eps, env_config, where = HEUR_PROTOCOL[fam]
            ref_params = mod.default_params(env_config=env_config)
            ref, _ = evaluate_episodes_seeded(mod.ENV, ref_params,
                                              agent.device_policy(mod.ENV, ref_params), None,
                                              torch.arange(start, start + n_eps, device=dev),
                                              device=dev)
            ref = ref.double().cpu()
            avg, se = float(ref.mean()), float(ref.std() / np.sqrt(n_eps))
            summary.update({f"heur_{agent.name}_env_steps_s": rate,
                            f"heur_{agent.name}_ms": tm["best_ms"],
                            f"heur_{agent.name}_protocol_mean": avg,
                            f"heur_{agent.name}_lanes_mean": float(full.double().mean())})
            print(f"[44 heuristics] {label} {agent.name} at {HEUR_LANES} lanes x {horizon} "
                  f"(evaluate_episodes_seeded): best {tm['best_ms']:.3f} ms = {rate:.6g} "
                  f"env-steps/s on {smi}, mean return {float(full.double().mean()):.6g}; "
                  f"{HEUR_CPU} lanes teacher-forced on the CPU's obs: actions equal on "
                  f"{share:.4%} (worst by {float(gap.max()):g}); reference protocol ({n_eps} "
                  f"episodes, seeds {start}+, horizon {mod.ENV.horizon(ref_params)}): "
                  f"{avg:.1f} +- {se:.1f}, RESULTS.md "
                  f"{HEUR_RESULTS.get(agent.name, 'no row')} ({where}; the JAX package's "
                  f"streams, a reward, not a gate)", flush=True)
    print(f"[44 heuristics] {time.perf_counter() - t0:.1f} s", flush=True)
    return totals, summary


def bench_phases(dev, wrappers, smi, err):
    """Phases 45-47, slice 11: the benchmark harness and the Gymnasium
    surfaces. 45: first, before the count, K10 against its plain version at
    the shape PPO_Kernel's training gives it (the protocol's params, 1,024
    lanes x 50 periods, ``seeded_actor`` of the roster's 64x64 width;
    ``k10_against_plain``), its max |diff| into ``err``; then, counted,
    ``bench.protocols``' InvManagement backlog
    protocol through ``run_benchmark`` with the vectorized evaluator on the
    card (OGT_FAST's path), BENCH_EPISODES episodes from seed 4000 at 50
    periods, the roster cut to BENCH_ROSTER by OGT_AGENTS with
    OGT_KERNEL_ROSTER=1, its artifacts in a temporary directory, every
    plain kernel version patched to raise: PPO_Kernel's training launches
    K10 once an update and nothing else does; every row evaluated on the
    vectorized path (the summary's ``attrs["vectorized"]``) with Seeds
    4000-4029 and SuccessRate 100; the summary and raw CSVs written, and the
    boxplot where matplotlib is installed; each row's AvgReward +- SE, rate
    and warm-up seconds. 46, counted (no
    launch): ``evaluate_agent``, the host protocol, on the port's
    ``InvManagementBacklogEnv`` with BaseStock 1.0 and phase 45's trained
    PPO (loaded from its checkpoint by the skip-retrain path; ``get_action``
    on its CPU copy) over the same seeds: SuccessRate 100, each mean within
    BENCH_HOST_SE combined SE of its phase-45 mean (same policy and laws,
    other streams), the time per episode. 47, counted (no launch):
    ``BatchedGymVectorEnv`` over NetInvMgmt's defaults at VEC_ENVS envs on
    the card, SAME_STEP, the random action for a horizon plus one:
    ``final_obs`` and its masks at the horizon alone, the fresh obs after
    it, env-steps/s. Returns (launches, summary)."""
    import importlib.util
    import os
    import tempfile

    import numpy as np

    from or_gym_inventory_torch.agents import heuristics as H
    from or_gym_inventory_torch.bench import protocols
    from or_gym_inventory_torch.bench.evaluate import evaluate_agent
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.vector.gym_vector import BatchedGymVectorEnv

    totals = {name: 0 for name in wrappers}
    summary = {}
    proto = protocols.PROTOCOLS[BENCH_PROTOCOL]
    short = proto.env_name_short
    seeds = list(range(proto.seed_offset, proto.seed_offset + BENCH_EPISODES))
    budget = BENCH_KERNEL_UPDATES * 1024 * proto.env_config["periods"]

    def mean_se(x):
        x = np.asarray(x, np.float64)
        return float(x.mean()), float(x.std(ddof=1) / np.sqrt(len(x)))

    # 45. K10 against plain at PPO_Kernel's shape, then the protocol through
    # run_benchmark, counted
    t0 = time.perf_counter()
    params = proto.params_factory(env_config=proto.env_config)
    actor, log_std = seeded_actor(params.pipeline_length, params.m1, dev)
    B, T = 1024, im.ENV.horizon(params)
    _, _, shares = k10_against_plain(params, actor, log_std, B, dev,
                                     f"the protocol's params, {B} x {T}")
    err["rollout_traj_im"] = max([err["rollout_traj_im"]] + [e for _, e in shares.values()])
    print(f"[45 protocol] K10 against plain at PPO_Kernel's {B} x {T} (seeded 64x64 actor): "
          "demand bit for bit, lanes agreeing "
          + ", ".join(f"{k} {sh:.4%}" for k, (sh, _) in shares.items())
          + f", max |diff| over them {max(e for _, e in shares.values()):.6g}; the env step "
          f"chain gives its inv exactly; {time.perf_counter() - t0:.1f} s", flush=True)
    del actor, log_std

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        env_vars = {"OGT_AGENTS": ",".join(BENCH_ROSTER), "OGT_KERNEL_ROSTER": "1"}
        saved_env = {k: os.environ.get(k) for k in env_vars}
        os.environ.update(env_vars)
        try:
            reset_counts(wrappers)
            with no_plain_versions():
                table, raw = protocols.run(BENCH_PROTOCOL, root=root, device=dev,
                                           episodes=BENCH_EPISODES, timesteps=budget, fast=True)
            launches = read_counts(wrappers)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        moved = {n: c for n, c in launches.items() if c}
        if moved != {"rollout_traj_im": BENCH_KERNEL_UPDATES}:
            raise AssertionError(f"the protocol launched {moved}, not K10 once for each of "
                                 f"PPO_Kernel's {BENCH_KERNEL_UPDATES} updates")
        totals = {n: totals[n] + launches[n] for n in wrappers}
        vec_runs = table.attrs["vectorized"]
        if sorted(vec_runs) != sorted(BENCH_ROSTER) or sorted(table.index) != sorted(BENCH_ROSTER):
            raise AssertionError(f"rows {sorted(table.index)}, vectorized {sorted(vec_runs)}")
        if not (table["SuccessRate(%)"] == 100).all():
            raise AssertionError(f"SuccessRate(%): {table['SuccessRate(%)'].to_dict()}")
        results = os.path.join(root, f"benchmark_results_torch_{short}_subset")
        for name in ("summary.csv", "raw_summary.csv"):
            if not os.path.exists(os.path.join(results, f"{short}_benchmark_{name}")):
                raise AssertionError(f"run_benchmark wrote no {name}")
        png = os.path.join(results, f"{short}_benchmark_rewards_boxplot.png")
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if has_mpl and not os.path.exists(png):
            raise AssertionError("run_benchmark drew no rewards boxplot")
        device_rows = {}
        for name in BENCH_ROSTER:
            rows = raw[raw.Agent == name]
            if rows["Seed"].tolist() != seeds:
                raise AssertionError(f"{name}: Seeds {rows['Seed'].tolist()}")
            if not np.isfinite(rows["TotalReward"]).all():
                raise AssertionError(f"{name}: non-finite returns")
            avg, se = mean_se(rows["TotalReward"])
            device_rows[name] = (avg, se)
            res = vec_runs[name]
            summary.update({f"{name}_avg_reward": avg, f"{name}_se": se,
                            f"{name}_env_steps_s": res["steps_per_second"],
                            f"{name}_warmup_s": res["compile_seconds"]})
            print(f"[45 protocol] {BENCH_PROTOCOL} {name}: AvgReward {avg:.1f} +- {se:.1f} over "
                  f"{BENCH_EPISODES} episodes (seeds {seeds[0]}-{seeds[-1]}, periods "
                  f"{proto.env_config['periods']}), evaluate_agent_vectorized "
                  f"{res['steps_per_second']:.6g} env-steps/s, warm-up (compile_seconds) "
                  f"{res['compile_seconds']:.3f} s on {smi}; SuccessRate 100", flush=True)
        train_s = {n: float(table.loc[n, "TrainingTime(s)"]) for n in ("PPO", "PPO_Kernel")}
        summary.update(k10_launches=launches["rollout_traj_im"], rl_budget=budget,
                       ppo_train_s=train_s["PPO"], ppo_kernel_train_s=train_s["PPO_Kernel"],
                       boxplot=os.path.exists(png))
        print(f"[45 protocol] run_benchmark (fast, OGT_AGENTS={env_vars['OGT_AGENTS']}, "
              f"OGT_KERNEL_ROSTER=1), RL budget {budget} env-steps: PPO trained in "
              f"{train_s['PPO']:.2f} s (xla, no kernel), PPO_Kernel in "
              f"{train_s['PPO_Kernel']:.2f} s with K10 launched "
              f"{launches['rollout_traj_im']} times, once an update, nothing else, no plain "
              f"version; summary and raw CSVs written, "
              + ("the rewards boxplot drawn" if has_mpl else
                 "no plot drawn: matplotlib is not installed on this host (run_benchmark "
                 "prints the error and goes on, as the JAX package's does)")
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)

        # 46. the host protocol on the port's adapter, counted
        t0 = time.perf_counter()
        ppo_agent = dict(protocols.build_agents(BENCH_PROTOCOL, root=root, device=dev))["PPO"]
        ppo_agent.train(proto.env_config, budget, save_path_prefix=f"{short}_")
        if ppo_agent.training_time != 0.0:
            raise AssertionError("phase 46's PPO retrained instead of loading phase 45's")
        reset_counts(wrappers)
        for agent in (H.BaseStockAgent(1.0), ppo_agent):
            df = evaluate_agent(agent, proto.env_factory, BENCH_EPISODES,
                                seed_offset=proto.seed_offset,
                                env_config=proto.env_config)["summary"]
            if len(df) != BENCH_EPISODES or not df["Error"].isna().all() \
                    or df["Seed"].tolist() != seeds:
                raise AssertionError(f"{agent.name} on the host path: {df['Error'].tolist()}")
            avg, se = mean_se(df["TotalReward"])
            d_avg, d_se = device_rows[agent.name]
            gap = abs(avg - d_avg) / np.hypot(se, d_se)
            if not gap <= BENCH_HOST_SE:
                raise AssertionError(f"{agent.name}: host {avg} +- {se} against the card's "
                                     f"{d_avg} +- {d_se}: {gap:.2f} combined SE apart")
            per_ep = float(df["Time"].mean())
            summary.update({f"host_{agent.name}_avg_reward": avg, f"host_{agent.name}_se": se,
                            f"host_{agent.name}_s_per_episode": per_ep})
            print(f"[46 host protocol] evaluate_agent on {proto.env_factory.__name__} "
                  f"(NumPy, PCG64 streams) {agent.name}: AvgReward {avg:.1f} +- {se:.1f}, "
                  f"SuccessRate 100; the card's {d_avg:.1f} +- {d_se:.1f} ({gap:.2f} combined "
                  f"SE apart, allowed {BENCH_HOST_SE}); {per_ep * 1e3:.3f} ms an episode of "
                  f"{proto.env_config['periods']} periods on the host", flush=True)
        launches = read_counts(wrappers)
        if any(launches.values()):
            raise AssertionError(f"the host protocol launched kernels: {launches}")
        print(f"[46 host protocol] no kernel launched; {time.perf_counter() - t0:.1f} s",
              flush=True)

    # 47. BatchedGymVectorEnv on the card, counted
    t0 = time.perf_counter()
    params = net.default_params()
    T = params.num_periods
    venv = BatchedGymVectorEnv(net.ENV, params, VEC_ENVS, seed=SEED, device=dev)
    obs, _ = venv.reset()
    fresh = obs.copy()
    reset_counts(wrappers)
    step_s = []
    for t in range(T + 1):
        action = venv.action_space.sample()
        s0 = time.perf_counter()
        obs, reward, term, trunc, info = venv.step(action)
        step_s.append(time.perf_counter() - s0)
        ended = bool(info["_final_obs"].any())
        if ended != (t == T - 1) or not np.isfinite(reward).all():
            raise AssertionError(f"BatchedGymVectorEnv step {t}: final_obs mask {ended}")
        if t == T - 1:
            if not (trunc.all() and info["_final_obs"].all()
                    and info["final_obs"].shape == obs.shape == (VEC_ENVS, params.obs_dim)):
                raise AssertionError("no final_obs at the horizon")
            if not np.array_equal(obs, fresh):
                raise AssertionError("the step after the horizon is not the reset obs")
    launches = read_counts(wrappers)
    if any(launches.values()):
        raise AssertionError(f"BatchedGymVectorEnv launched kernels: {launches}")
    rate = VEC_ENVS * (T + 1) / sum(step_s)
    summary.update(vec_env_steps_s=rate, vec_step_ms_median=float(np.median(step_s)) * 1e3)
    print(f"[47 vector env] BatchedGymVectorEnv(NetInvMgmt defaults, {VEC_ENVS} envs, "
          f"SAME_STEP) on the card, {T + 1} steps of the random action (NumPy in and out): "
          f"{rate:.6g} env-steps/s, median step {np.median(step_s) * 1e3:.3f} ms on {smi}; "
          f"final_obs and its masks at step {T} alone, the reset obs after it; no kernel "
          f"launched; {time.perf_counter() - t0:.1f} s", flush=True)
    return totals, summary

RANDOM_KERNELS = ("episode_returns", "episode_returns_fully_fused",
                  "sample_streams_debug")
POLICY_KERNELS = ("rollout_traj_net", "episode_returns_net_policy",
                  "sample_policy_streams_debug_net")
PPO_PATH_KERNELS = POLICY_KERNELS[:2]   # K6 is held in phase 7, off the path
# K7 and K9 are held in phases 10-12, off the paths: random_episode_returns
# runs K8 alone, as the JAX package's does (fast_episodes.py:80-94)
IM_PATH_KERNELS = ("episode_returns_im_fused", "rollout_traj_im")


def print_kernel(phase, name, kt, work, launches):
    (b_ms, b_by), (t, pt) = work, kt
    print(f"[{phase} kernel] {name}: {t['best_ms']:.4f} ms (mean "
          f"{t.get('mean_ms', t['best_ms']):.4f}), plain {pt['best_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by} ({b_ms / t['best_ms']:.1%} of it), launches on the "
          f"main paths {launches}, library none", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.ops import nv_poisson
    from or_gym_inventory_torch.utils.profiling import cuda_time
    from or_gym_inventory_torch.vector import fast_episodes, vecenv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {name: [getattr(ns if "/net_" in source else ek, name)]
                for name, source, _ in KERNEL_ROWS}
    wrappers["episode_returns_im"].append(ek.episode_returns_im_random)
    wrappers["episode_returns_nv"].append(ek.episode_returns_nv_random)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1 device] {kind}, {torch.cuda.device_count()} card(s); nvidia-smi: "
          f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for lib in _build.SIGNATURES:
        _build.library(lib)
    ptxas = [ln.split("info    :")[-1].strip() for out in logs.values()
             for ln in out.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s, {len(logs)} source(s) "
          f"compiled; ptxas: {' | '.join(ptxas)}", flush=True)
    print("[2 build] K22-K24 (csrc/im_lstm.cu; <lanes,warps_m,...>): " + "; ".join(
        ptxas_entries(out) for so, out in logs.items() if "libim_lstm" in so), flush=True)
    nv_entries = "; ".join(ptxas_entries(out) for so, out in logs.items()
                           if "libnv_episode" in so)
    print("[2 build] K13-K17 (csrc/nv_episode.cu; k_nv_episodes<econ in,dump,table>): "
          + nv_entries, flush=True)
    nv_regs = [int(r) for r in re.findall(r"k_nv_episodes<[\d,]+> (\d+) registers", nv_entries)]
    if nv_regs and max(nv_regs) > ek._NV_TABLE_REGS:
        raise AssertionError(f"k_nv_episodes uses {max(nv_regs)} registers a thread; "
                             f"_nv_table_plan counts {ek._NV_TABLE_REGS}")
    new_entries = [e for out in logs.values() for e in ptxas_entries(out).split("; ")
                   if e.startswith(("k_batched_step", "k_episode_returns_random",
                                    "k_im_rollout_traj_wide", "k_nv_rollout_traj_wide",
                                    "k_rollout_traj_wide"))]
    print("[2 build] K25/K26 (net_episode.cu) and K27-K29's wide route (im/nv/net_"
          "policy.cu on wide_mlp.cuh): " + "; ".join(new_entries), flush=True)
    print("[2 build] K27-K29 on the thread-block cluster (cluster_mlp.cuh, FP32 products): "
          + cluster_check(logs), flush=True)
    net_so = str(_build._target(_build.CSRC / "net_episode.cu"))
    net_log = next((out for so, out in logs.items() if "libnet_episode" in so), "")
    local = sass_counts(net_so)
    k2_plan, _ = ns._shared_layout(net.default_params(num_periods=NUM_STEPS).topology)
    print("[2 build] K2 and K26 (net_episode.cu, the state in shared memory): "
          + "; ".join(e for e in ptxas_entries(net_log).split("; ")
                      if e.startswith(("k_episode_returns_fused", "k_episode_returns_random")))
          + f"; dynamic shared memory {k2_plan.bytes} B a block ({k2_plan.words} words x "
          f"{k2_plan.threads} threads, {k2_plan.blocks_per_sm} blocks an SM) on the default "
          "graph; SASS LDL/STL per kernel of net_episode.cu: "
          + ("cuobjdump not found" if local is None else
             ", ".join(f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(local.items()))), flush=True)
    print("[2 build] K1-K3, K25 and K26 (net_episode.cu; K1 and K25 on shared-memory state "
          "staged by cp.async), no frame: " + net_episode_frame_check(logs, local), flush=True)
    print("[2 build] K4-K6, K10-K12 and K18-K20 on the tensor-core tile (mlp_tile.cuh; K4, "
          f"K10 and K18 = {', '.join(k for ks in TRAJ_INSTANCES.values() for k in ks)}): "
          + tile_sass_check(logs), flush=True)
    print("[2 build] K8, its ring in shared memory and its stages in registers: "
          + k8_frame_check(logs), flush=True)
    print("[2 build] K7 on K8's body, its streams staged by cp.async: " + k7_frame_check(logs),
          flush=True)
    print("[2 build] K9 (an instance per m1) and K21 on 2-D grids: " + k9_k21_frame_check(logs),
          flush=True)
    print("[2 build] K13, its pipeline in registers and its streams staged by cp.async: "
          + k13_frame_check(logs), flush=True)

    # 3-4. the main path, counting launches: bench.py's cross-check, then
    # random-policy returns at the operating point
    params = net.default_params(num_periods=NUM_STEPS)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    err, acts, dems, k1_lanes = cross_check(params, dev)
    print(f"[3 cross-check] K3 streams bit-exact; K1, K2 within rtol=1e-5 atol=1e-3 "
          f"of their plain versions; K2 equal to K1 on K3's streams bit for bit (65,536 "
          f"lanes, and each of the 16 episodes at 1,024); step chain within rtol=1e-4 "
          f"atol=1e-2; {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mean, k2_plain_ms = episode_returns_at_scale(params, dev, err, wrappers)
    launches = read_counts(wrappers)
    missing = [name for name in RANDOM_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if sum(k1_lanes.values()) != launches["episode_returns"]:
        raise AssertionError(f"K1 launched {launches['episode_returns']} times, by its lanes "
                             f"{k1_lanes}")
    print(f"[4 main path] {MAIN_LANES * MAIN_EPISODES} episode returns from K2 launched "
          f"once and nothing else, within "
          f"rtol=1e-5 atol=1e-3 of plain K2 on the same seed, mean {mean:.3f}; "
          f"max |diff| {err}; launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_t = cuda_time(fast_episodes.random_episode_returns, params, gen, MAIN_LANES,
                       MAIN_EPISODES, dev, warmup=1, iters=5)
    env_steps = MAIN_LANES * MAIN_EPISODES * NUM_STEPS
    print(f"[4 main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x "
          f"{NUM_STEPS}: best {main_t['best_ms']:.3f} ms, mean {main_t['mean_ms']:.3f} "
          f"ms, {env_steps / main_t['best_ms'] * 1e3:.6g} env-steps/s on {smi}",
          flush=True)

    # 5. the vecenv path
    space = net.action_space(params)

    def policy(_s, obs, g, _t):
        return space.sample(g, (obs.shape[0],), device=dev)

    def run_rollout(g):
        _, traj = vecenv.rollout(net.ENV, params, policy, None, g, ROLLOUT_ENVS,
                                 NUM_STEPS, device=dev)
        return traj.reward.sum()

    gen = torch.Generator(device=dev).manual_seed(2)
    roll_t = cuda_time(run_rollout, gen, warmup=1, iters=3)
    print(f"[5 vecenv] rollout {ROLLOUT_ENVS} x {NUM_STEPS}: best "
          f"{roll_t['best_ms']:.3f} ms, {ROLLOUT_ENVS * NUM_STEPS / roll_t['best_ms'] * 1e3:.6g} "
          f"env-steps/s on {smi}", flush=True)

    # 6. per-kernel times of K1-K3 at the main path's shapes
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    specs = ns._topology_link_specs(T, NUM_STEPS)
    words = T.n_reorder + T.n_retail
    k1_t = cuda_time(ns.episode_returns, params, acts, dems, warmup=2, iters=20)
    k1_p = cuda_time(ns._episode_returns_plain, params, acts, dems, warmup=1, iters=3)

    def k1_alone(a, d):   # K1 alone, its output first held against the entry point's
        launch, out = k1_kernel_launch(params, a, d, dev)
        launch()
        exact("K1 alone vs the entry point", out, ns.episode_returns(params, a, d))
        return cuda_time(launch, warmup=2, iters=20)["best_ms"]
    k1_alone_ms = {CHECK_LANES: k1_alone(acts, dems)}
    k3_t = cuda_time(ns.sample_streams_debug, params, SEED, hi, CHECK_LANES,
                     NUM_STEPS, 1, None, dev, warmup=2, iters=20)
    launch, (a3, d3) = k3_kernel_launch(params, hi, dev)
    launch()   # K3 alone, its streams first held against the entry point's
    exact("K3 alone vs the entry point, actions", a3, acts)
    exact("K3 alone vs the entry point, demand", d3, dems)
    k3_alone_ms = cuda_time(launch, warmup=2, iters=20)["best_ms"]
    del a3, d3
    k3_p = cuda_time(ns._sample_streams_plain, params, SEED, hi, CHECK_LANES,
                     NUM_STEPS, 0, 1, dev, warmup=1, iters=3)
    k2_t = cuda_time(ns.episode_returns_fully_fused, params, SEED, hi, MAIN_LANES,
                     NUM_STEPS, MAIN_EPISODES, dev, warmup=1, iters=5)
    del acts, dems
    # K1 at each shape the cross-check launches it at, and at bench.py's 4,096
    k1_by_lanes = {CHECK_LANES: (k1_t, k1_p)}
    for lanes in K1_LANES:
        a1, d1 = ns.sample_streams_debug(params, SEED, hi, lanes, device=dev)
        k1_by_lanes[lanes] = (cuda_time(ns.episode_returns, params, a1, d1, warmup=2, iters=20),
                              cuda_time(ns._episode_returns_plain, params, a1, d1, warmup=1,
                                        iters=3))
        k1_alone_ms[lanes] = k1_alone(a1, d1)
        del a1, d1
    k1_shapes = {f"{lanes}x{NUM_STEPS}": {
        "launches": k1_lanes.get(lanes, 0), "ms": t["best_ms"], "plain_ms": pt["best_ms"],
        "kernel_ms": k1_alone_ms[lanes],
        "bound_ms": bound(lanes * (NUM_STEPS * words + 1) * 4,
                          lanes * NUM_STEPS * step_ops(T))[0]}
        for lanes, (t, pt) in k1_by_lanes.items()}
    main_envs = MAIN_LANES * MAIN_EPISODES
    work = {
        "episode_returns": bound(CHECK_LANES * (NUM_STEPS * words + 1) * 4,
                                 CHECK_LANES * NUM_STEPS * step_ops(T)),
        "episode_returns_fully_fused": bound(
            main_envs * 4, main_envs * NUM_STEPS * (step_ops(T) + draw_ops(T, specs))),
        "sample_streams_debug": bound(CHECK_LANES * NUM_STEPS * words * 4,
                                      CHECK_LANES * NUM_STEPS * draw_ops(T, specs)),
    }
    times = {"episode_returns": (k1_t, k1_p),
             "episode_returns_fully_fused": (k2_t, {"best_ms": k2_plain_ms}),
             "sample_streams_debug": (k3_t, k3_p)}
    print(f"[6 work] per env-step: step {step_ops(T)} ops, draw {draw_ops(T, specs)} "
          f"ops; peaks {HBM_BYTES_PER_S:.3g} B/s, {FP32_OPS_PER_S:.3g} op/s", flush=True)
    for name in RANDOM_KERNELS:
        print_kernel(6, name, times[name], work[name], launches[name])
    k3_bound = work["sample_streams_debug"][0]
    print(f"[6 kernel] sample_streams_debug (K3, a thread a (lane, episode, 4 periods)) at "
          f"{CHECK_LANES} x {NUM_STEPS}: {k3_alone_ms:.4f} ms the kernel alone, "
          f"{k3_t['best_ms']:.4f} ms through the entry point, bound {k3_bound:.4f} ms "
          f"({k3_bound / k3_alone_ms:.1%} of the kernel alone) on {smi}", flush=True)
    print("[6 kernel] episode_returns by shape (launches on the main path: bench.py's "
          "cross-check, once at 65,536 lanes and once per episode at 1,024): " + "; ".join(
              f"{k}: {v['ms']:.4f} ms through the entry point, {v['kernel_ms']:.4f} ms the "
              f"kernel alone, plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} "
              f"ms by bytes ({v['bound_ms'] / v['ms']:.1%} of it), launches {v['launches']}"
              for k, v in k1_shapes.items()) + f" on {smi}", flush=True)
    t0 = time.perf_counter()
    err2, lines = k2_graph_check(dev)
    err["episode_returns_fully_fused"] = max(err["episode_returns_fully_fused"], err2)
    for line in lines:
        print(f"[6 K2 graph] {line}", flush=True)
    print(f"[6 K2 graph] {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. the policy kernels against their plain versions, at the main path's
    # shapes, with a seeded actor
    t0 = time.perf_counter()
    actor, log_std = seeded_actor(T.obs_dim, T.n_reorder, dev)
    err2, policy_plain_ms, lines = policy_cross_check(params, dev, actor, log_std)
    err.update(err2)
    for line in lines:
        print(f"[7 policy kernels] {line}", flush=True)
    print(f"[7 policy kernels] max |diff| {err2}; plain ms {policy_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the second main path, counting launches: PPO, then the evaluation
    reset_counts(wrappers)
    t0 = time.perf_counter()
    lines, best_update_ms, trained, summary = ppo_main_path(
        net.ENV, params, dev, smi, "NetInvMgmt", ns.rollout_traj_net)
    eval_lines, actor, log_std, det, det_seed, eval_rates = evaluate_trained(
        params, dev, smi, trained)
    launches2 = read_counts(wrappers)
    lines += eval_lines
    summary.update(eval_rates)
    missing = [name for name in PPO_PATH_KERNELS if launches2[name] == 0]
    if missing:
        raise AssertionError(f"PPO main path launched no {missing}")
    lines.append(check_evaluation(params, dev, actor, det, det_seed))
    del det
    for line in lines:
        print(f"[8 main path] {line}", flush=True)
    print(f"[8 main path] launches {launches2}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches2[name] for name in wrappers}

    # 9. per-kernel times of K4-K6 at the main path's shapes, with the
    # trained actor
    E = EVAL_EPISODES
    dims = [T.obs_dim, 64, 64, T.n_reorder]
    step_all = step_ops(T) + mlp_ops(dims)
    k4_t = cuda_time(ns.rollout_traj_net, params, actor, log_std, SEED, PPO_ENVS,
                     "ppo", "tanh", dev, warmup=1, iters=5)
    k5_t = cuda_time(ns.episode_returns_net_policy, params, actor, SEED, PPO_ENVS, E,
                     None, dev, warmup=1, iters=3)
    k5s_t = cuda_time(ns.episode_returns_net_policy, params, actor, SEED, PPO_ENVS, E,
                      log_std, dev, warmup=1, iters=3)
    k6_t = cuda_time(ns.sample_policy_streams_debug_net, params, actor, SEED, PPO_ENVS,
                     E, None, dev, warmup=1, iters=3)
    k4_rows = (NUM_STEPS + 1) * (T.n_main + T.n_retail) + NUM_STEPS * (
        2 * T.n_reorder + 1 + T.n_retail)
    n_eval = PPO_ENVS * E * NUM_STEPS
    k5_ops = step_all + policy_draw_ops(T, specs, False)
    tile_bounds = {
        "rollout_traj_net": tc_bound(PPO_ENVS * k4_rows * 4, PPO_ENVS * NUM_STEPS,
                                     step_all + policy_draw_ops(T, specs, True),
                                     mlp_tc_flops(dims)),
        "episode_returns_net_policy": tc_bound(PPO_ENVS * E * 4, n_eval, k5_ops,
                                               mlp_tc_flops(dims)),
        "sample_policy_streams_debug_net": tc_bound(PPO_ENVS * E * (1 + NUM_STEPS * words) * 4,
                                                    n_eval, k5_ops, mlp_tc_flops(dims)),
    }
    work.update({name: b for name, (b, _) in tile_bounds.items()})
    times.update({name: (t, {"best_ms": policy_plain_ms[name]}) for name, t in (
        ("rollout_traj_net", k4_t), ("episode_returns_net_policy", k5_t),
        ("sample_policy_streams_debug_net", k6_t))})
    print(f"[9 work] per env-step: MLP {mlp_ops(dims)} ops, step {step_ops(T)} ops, "
          f"draws {policy_draw_ops(T, specs, True)} (stochastic) / "
          f"{policy_draw_ops(T, specs, False)} (deterministic) ops", flush=True)
    for name in POLICY_KERNELS:
        print_kernel(9, name, times[name], work[name], launches[name])
        if name in tile_bounds:
            fp32_ms = tile_bounds[name][1]
            print(f"[9 kernel] {name}: the MLP's {mlp_tc_flops(dims)} FLOPs an env-step as "
                  f"three TF32 products; bound with every operation at FP32 {fp32_ms:.4f} ms "
                  f"({fp32_ms / times[name][0]['best_ms']:.1%} of it)", flush=True)
    print(f"[9 kernel] episode_returns_net_policy, stochastic: {k5s_t['best_ms']:.4f} ms "
          f"(mean {k5s_t['mean_ms']:.4f}); rollout_traj_net is "
          f"{k4_t['best_ms'] / best_update_ms:.1%} of the best PPO update "
          f"({best_update_ms:.3f} ms)", flush=True)
    line, prof = profile_update(params, dev, trained)
    print(f"[9 profile] {line}", flush=True)
    chunk_ms = time_chunks(params, dev, trained)
    print("[9 chunks] one PPO update per minibatch_chunks value, in the order 8, 1, 1, "
          "8: " + "; ".join(f"{k}: {', '.join(f'{t:.3f}' for t in v)} ms"
                            for k, v in chunk_ms.items()) + f" on {smi}", flush=True)
    summary.update(prof)
    summary.update({f"update_ms_chunks_{k}": min(v) for k, v in chunk_ms.items()})
    summary["k4_share_of_update"] = k4_t["best_ms"] / best_update_ms

    # 10. the InvManagement kernels against their plain versions, every
    # demand mode, backlog and lost sales
    t0 = time.perf_counter()
    err.update(im_cross_check(dev))
    print(f"[10 IM cross-check] 5 demand modes x backlog/lost sales at {CHECK_LANES} x "
          f"{NUM_STEPS} and {MULTI_LANES} x {MAIN_EPISODES}: K9 streams bit-exact (also "
          f"ragged {RAGGED[0]} x {RAGGED[1]}, and at m1 = 8, lt 32 at E = 1, "
          f"{MAIN_EPISODES}, ragged {RAGGED[0]} x {RAGGED[1]} and {RAGGED[0] + 25} x 1); K8 = K7 "
          "on K9's streams = K7 _random on K9's demand bit for bit; K8 = plain "
          f"K8 bit for bit (also ragged {RAGGED[0]} x {RAGGED[1]}, and at m1 = "
          f"{', '.join(map(str, IM_CHAIN_M1))} at E = 1, {MAIN_EPISODES} and ragged); "
          "K7 = plain K7 within "
          f"rtol=1e-5 atol=1e-3; max |diff| "
          f"{ {k: err[k] for k in IM_KERNELS[:2]} }; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 11. the third main path, counting launches: IM random-policy returns
    t0 = time.perf_counter()
    launches3, k8_err, im_mean, (im_params, im_a, im_d, im_seed) = im_main_path(dev, wrappers)
    err["episode_returns_im_fused"] = max(err["episode_returns_im_fused"], k8_err)
    print(f"[11 IM main path] K9 -> K7 and K7 _random at {CHECK_LANES} x {NUM_STEPS} "
          f"before the count, then random_episode_returns {MAIN_LANES} x {MAIN_EPISODES}: "
          f"K8 launched once, nothing else, no plain version; episode 0 = K7 on K9's streams, the first {MULTI_LANES} lanes = "
          f"plain K8; mean {im_mean:.3f}; launches {launches3}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    im_t = cuda_time(fast_episodes.random_episode_returns, im_params, gen, MAIN_LANES,
                     MAIN_EPISODES, dev, warmup=1, iters=5)
    print(f"[11 IM main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x "
          f"{NUM_STEPS}: best {im_t['best_ms']:.3f} ms, mean {im_t['mean_ms']:.3f} ms, "
          f"{env_steps / im_t['best_ms'] * 1e3:.6g} env-steps/s on {smi}", flush=True)

    # 12. K10 against its plain version and the env chain, a seeded actor
    t0 = time.perf_counter()
    im_actor, im_log_std = seeded_actor(im_params.pipeline_length, im_params.m1, dev)
    err["rollout_traj_im"], k10_plain_ms, lines = im_policy_cross_check(dev, im_actor,
                                                                        im_log_std)
    for line in lines:
        print(f"[12 IM policy kernel] {line}", flush=True)
    print(f"[12 IM policy kernel] max |diff| over agreeing lanes "
          f"{err['rollout_traj_im']}; {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the fourth main path, counting launches: PPO on InvManagement
    t0 = time.perf_counter()
    reset_counts(wrappers)
    lines, im_update_ms, (im_cfg, im_state, _), im_rates = ppo_main_path(
        im.ENV, im_params, dev, smi, "InvManagement", ek.rollout_traj_im)
    launches4 = read_counts(wrappers)
    im_actor = ek.fold_actor_params(im_cfg, im_state.params, im_state.rms)
    im_log_std = im_state.params.log_std.detach()
    for line in lines:
        print(f"[13 IM main path] {line}", flush=True)
    print(f"[13 IM main path] launches {launches4}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches3[name] + launches4[name]
                for name in wrappers}
    missing = [name for name in IM_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the IM main paths launched no {missing}")

    # 14. per-kernel times of K7-K10 at the main paths' shapes
    table_len = len(ek._im_demand_spec(im_params)[1])
    k7_t = cuda_time(ek.episode_returns_im, im_params, im_a, im_d, warmup=2, iters=20)
    k7_p = cuda_time(ek._episode_returns_im_plain, im_params, im_a, im_d, warmup=1, iters=3)
    k7r_t = cuda_time(ek.episode_returns_im_random, im_params, im_d, im_seed, warmup=2, iters=20)

    def k7_alone(a, seed, want):   # K7 alone, its output first held against the entry point's
        launch, out = k7_kernel_launch(im_params, a, im_d, seed, dev)
        launch()
        exact("K7 alone vs the entry point", out, want)
        return cuda_time(launch, warmup=2, iters=20)["best_ms"]
    k7_alone_ms = {
        "streamed": k7_alone(im_a, None, ek.episode_returns_im(im_params, im_a, im_d)),
        "random": k7_alone(None, im_seed, ek.episode_returns_im_random(im_params, im_d, im_seed))}
    k8_t = cuda_time(ek.episode_returns_im_fused, im_params, SEED, MAIN_LANES,
                     MAIN_EPISODES, dev, warmup=1, iters=5)
    k8_p = cuda_time(ek._im_fused_plain, im_params, SEED, CHECK_LANES, 1, dev,
                     warmup=1, iters=3)
    k9_t = cuda_time(ek.sample_streams_debug_im, im_params, SEED, CHECK_LANES, 1, dev,
                     warmup=2, iters=20)
    k9_p = cuda_time(ek._im_fused_plain, im_params, SEED, CHECK_LANES, 1, dev, True,
                     warmup=1, iters=3)
    k10_t = cuda_time(ek.rollout_traj_im, im_params, im_actor, im_log_std, SEED, PPO_ENVS,
                      "ppo", "tanh", dev, warmup=1, iters=5)
    del im_a, im_d
    m1, T = im_params.m1, NUM_STEPS
    im_dims = [im_params.pipeline_length, 64, 64, m1]
    # K10 on K11's tile: the MLP's products as three TF32 products each
    k10_bound, k10_fp32_ms = tc_bound(
        PPO_ENVS * ((T + 1) * m1 + 2 * T * m1 + 2 * T) * 4, PPO_ENVS * T,
        mlp_ops(im_dims) + im_step_ops(im_params) + im_policy_draw_ops(im_params, table_len),
        mlp_tc_flops(im_dims))
    work.update({
        "episode_returns_im": bound(CHECK_LANES * (T * (m1 + 1) + 1) * 4,
                                    CHECK_LANES * T * im_step_ops(im_params)),
        "episode_returns_im_fused": bound(
            main_envs * 4,
            main_envs * T * (im_step_ops(im_params) + im_draw_ops(im_params, table_len))),
        "sample_streams_debug_im": bound(CHECK_LANES * T * (m1 + 1) * 4,
                                         CHECK_LANES * T * im_draw_ops(im_params, table_len)),
        "rollout_traj_im": k10_bound,
    })
    times.update({"episode_returns_im": (k7_t, k7_p),
                  "episode_returns_im_fused": (k8_t, k8_p),
                  "sample_streams_debug_im": (k9_t, k9_p),
                  "rollout_traj_im": (k10_t, {"best_ms": k10_plain_ms})})
    print(f"[14 work] IM per env-step: step {im_step_ops(im_params)} ops, random draws "
          f"{im_draw_ops(im_params, table_len)} ops (table of {table_len}), K10 MLP "
          f"{mlp_ops(im_dims)} + draws {im_policy_draw_ops(im_params, table_len)} ops; plain "
          f"K8 timed at {CHECK_LANES} x {T}, E=1", flush=True)
    for name in IM_KERNELS:
        print_kernel(14, name, times[name], work[name], launches[name])
    k7_bound = work["episode_returns_im"][0]
    print(f"[14 kernel] episode_returns_im (K7 on K8's body, staged by cp.async, "
          f"{ek._im_k7_plan(m1, im_params.lt_max)}) at {CHECK_LANES} x {T}: streamed "
          f"{k7_alone_ms['streamed']:.4f} ms the kernel alone "
          f"({k7_bound / k7_alone_ms['streamed']:.1%} of its bound), {k7_t['best_ms']:.4f} "
          f"through the entry point; _random "
          f"{k7_alone_ms['random']:.4f} alone, {k7r_t['best_ms']:.4f} through the entry point "
          f"on {smi}", flush=True)
    print(f"[14 kernel] rollout_traj_im (K11's tile): the MLP's {mlp_tc_flops(im_dims)} FLOPs "
          f"an env-step as three TF32 products; bound with every operation at FP32 "
          f"{k10_fp32_ms:.4f} ms ({k10_fp32_ms / k10_t['best_ms']:.1%} of it); "
          f"{k10_t['best_ms'] / im_update_ms:.1%} of the best IM PPO update "
          f"({im_update_ms:.3f} ms)", flush=True)

    # 15. reward at the IM-backlog protocol of tools/validate_kernel_ppo.py
    t0 = time.perf_counter()
    avg, se, wall, n_upd, s_avg, s_se = im_reward_check(dev)
    print(f"[15 IM reward] periods 50, 1,024 envs, 4 epochs x 8 env-sliced minibatches, 2M "
          f"steps ({n_upd} updates, {wall:.1f} s), seed 0: AvgReward {avg:.1f} +- {se:.1f} "
          f"over 30 deterministic episodes (evaluate_episodes); on the reference protocol "
          f"(evaluate_episodes_seeded, seeds 4000-4029) {s_avg:.1f} +- {s_se:.1f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    im_summary = dict(im_rates, random_ms=im_t["best_ms"],
                      random_env_steps_s=env_steps / im_t["best_ms"] * 1e3,
                      k10_ms=k10_t["best_ms"], k10_bound_ms=k10_bound[0],
                      k10_fp32_bound_ms=k10_fp32_ms,
                      k10_share_of_update=k10_t["best_ms"] / im_update_ms,
                      k8_ms=k8_t["best_ms"], k8_bound_ms=work["episode_returns_im_fused"][0],
                      validate_avg_reward=avg, validate_eval_se=se,
                      validate_seeded_avg_reward=s_avg, validate_seeded_se=s_se)

    # 16. K11/K12 against their plain versions, with phase 13's trained actor
    t0 = time.perf_counter()
    err2, eval_plain_ms, lines = im_eval_cross_check(dev, im_params, im_actor, im_log_std)
    err.update(err2)
    for line in lines:
        print(f"[16 IM policy kernels] {line}", flush=True)
    print(f"[16 IM policy kernels] max |diff| {err2}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 17. the fifth main path, counting launches: IM learned-policy evaluation
    t0 = time.perf_counter()
    launches5, lines, eval_rates = eval_main_path(
        dev, wrappers, im_params, im_actor, im_log_std, smi, "episode_returns_im_policy",
        lambda seed: ek._im_policy_plain(im_params, im_actor, None, seed, MULTI_LANES,
                                         EVAL_EPISODES, dev)[0], NUM_STEPS)
    im_summary.update(eval_rates)
    for line in lines:
        print(f"[17 IM eval main path] {line}", flush=True)
    print(f"[17 IM eval main path] launches {launches5}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 18. the Newsvendor kernels against their plain versions and each other
    t0 = time.perf_counter()
    err2, lines = nv_cross_check(dev)
    err.update(err2)
    for line in lines:
        print(f"[18 NV cross-check] {line}", flush=True)
    print(f"[18 NV cross-check] {len(NV_CASES)} cases at {CHECK_LANES} x 50, E 1 and 4; max "
          f"|diff| {err2}; {time.perf_counter() - t0:.1f} s", flush=True)

    # 19. the sixth main path, counting launches: Newsvendor random-policy returns
    t0 = time.perf_counter()
    launches6, k16_err, nv_share, nv_mean, k16_plain_ms, nv_p = nv_main_path(dev, wrappers)
    err["episode_returns_nv_reset_fused"] = max(err["episode_returns_nv_reset_fused"], k16_err)
    nv_T = nv_p.step_limit
    nv_steps = MAIN_LANES * MAIN_EPISODES * nv_T
    print(f"[19 NV main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x {nv_T} "
          f"(benchmark_newsvendor.py ENV_CONFIG_EVAL): K16 launched once, nothing else, no "
          f"plain version; the first {CHECK_LANES} lanes of every episode: {nv_share:.4%} "
          f"agree with plain K16; mean {nv_mean:.3f}; launches {launches6}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    nv_t = cuda_time(fast_episodes.random_episode_returns, nv_p, gen, MAIN_LANES,
                     MAIN_EPISODES, dev, warmup=1, iters=5)
    print(f"[19 NV main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x {nv_T}: "
          f"best {nv_t['best_ms']:.3f} ms, mean {nv_t['mean_ms']:.3f} ms, "
          f"{nv_steps / nv_t['best_ms'] * 1e3:.6g} env-steps/s on {smi}", flush=True)
    launches = {name: launches[name] + launches5[name] + launches6[name] for name in wrappers}
    missing = [name for name in ("episode_returns_im_policy", "episode_returns_nv_reset_fused")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"the slice-4 main paths launched no {missing}")

    # 20. per-kernel times of K11-K17 at the main paths' shapes
    E = EVAL_EPISODES
    k11_t = cuda_time(ek.episode_returns_im_policy, im_params, im_actor, SEED, PPO_ENVS, E,
                      None, dev, warmup=1, iters=3)
    k11s_t = cuda_time(ek.episode_returns_im_policy, im_params, im_actor, SEED, PPO_ENVS, E,
                       im_log_std, dev, warmup=1, iters=3)
    k12_t = cuda_time(ek.sample_policy_streams_debug_im, im_params, im_actor, SEED, PPO_ENVS,
                      E, None, dev, warmup=1, iters=3)
    econ, acts, dems = ek.sample_streams_debug_nv_reset(nv_p, SEED, CHECK_LANES, 1, dev)
    econ, acts, dems = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
    k13_t = cuda_time(ek.episode_returns_nv, nv_p, econ, acts, dems, warmup=2, iters=20)
    k13_p = cuda_time(ek._episode_returns_nv_plain, nv_p, econ, acts, dems, warmup=1, iters=3)
    k13r_t = cuda_time(ek.episode_returns_nv_random, nv_p, econ, dems, SEED, warmup=2, iters=20)

    def k13_alone(a, seed, want):  # K13 alone, its output first held against the entry point's
        launch, out = k13_kernel_launch(nv_p, econ, a, dems, seed, dev)
        launch()
        exact("K13 alone vs the entry point", out, want)
        return cuda_time(launch, warmup=2, iters=20)["best_ms"]
    k13_alone_ms = {
        "streamed": k13_alone(acts, None, ek.episode_returns_nv(nv_p, econ, acts, dems)),
        "random": k13_alone(None, SEED, ek.episode_returns_nv_random(nv_p, econ, dems, SEED))}
    k14_t = cuda_time(ek.episode_returns_nv_fused, nv_p, econ, SEED, warmup=2, iters=20)
    k14_p = cuda_time(ek._nv_fused_plain, nv_p, SEED, CHECK_LANES, 1, dev, econ,
                      warmup=1, iters=3)
    k15_t = cuda_time(ek.sample_streams_debug_nv, nv_p, econ, SEED, warmup=2, iters=20)
    k15_p = cuda_time(ek._nv_fused_plain, nv_p, SEED, CHECK_LANES, 1, dev, econ, True,
                      warmup=1, iters=3)
    k16_t = cuda_time(ek.episode_returns_nv_reset_fused, nv_p, SEED, MAIN_LANES,
                      MAIN_EPISODES, dev, warmup=1, iters=5)
    k17_t = cuda_time(ek.sample_streams_debug_nv_reset, nv_p, SEED, CHECK_LANES, 1, dev,
                      warmup=2, iters=20)
    k17_p = cuda_time(ek._nv_fused_plain, nv_p, SEED, CHECK_LANES, 1, dev, None, True,
                      warmup=1, iters=3)
    del econ, acts, dems
    n_eval = PPO_ENVS * E * NUM_STEPS
    k11_ops = (mlp_ops(im_dims) + im_step_ops(im_params)
               + im_policy_draw_ops(im_params, table_len, stochastic=False))
    nv_envs = MAIN_LANES * MAIN_EPISODES
    nv_step, nv_draw = nv_step_ops(nv_p), nv_draw_ops(nv_p, False)
    nv_draw_reset = nv_draw_ops(nv_p, True)
    nv_draw_linear = nv_draw_ops(nv_p, True, table=False)
    k16_linear_bound = bound(nv_envs * 4, nv_envs * nv_T * (nv_step + nv_draw_linear))
    tile_bounds = {
        "episode_returns_im_policy": tc_bound(PPO_ENVS * E * 4, n_eval, k11_ops,
                                              mlp_tc_flops(im_dims)),
        "sample_policy_streams_debug_im": tc_bound(PPO_ENVS * E * (1 + T * (m1 + 1)) * 4,
                                                   n_eval, k11_ops, mlp_tc_flops(im_dims)),
    }
    work.update({name: b for name, (b, _) in tile_bounds.items()})
    work.update({
        "episode_returns_nv": bound(CHECK_LANES * (5 + 2 * nv_T + 1) * 4,
                                    CHECK_LANES * nv_T * nv_step),
        "episode_returns_nv_fused": bound(CHECK_LANES * (5 + 1) * 4,
                                          CHECK_LANES * nv_T * (nv_step + nv_draw)),
        "sample_streams_debug_nv": bound(CHECK_LANES * (5 + 2 * nv_T) * 4,
                                         CHECK_LANES * nv_T * nv_draw),
        "episode_returns_nv_reset_fused": bound(nv_envs * 4,
                                                nv_envs * nv_T * (nv_step + nv_draw_reset)),
        "sample_streams_debug_nv_reset": bound(CHECK_LANES * (5 + 2 * nv_T) * 4,
                                               CHECK_LANES * nv_T * nv_draw_reset),
    })
    times.update({
        "episode_returns_im_policy": (k11_t, {"best_ms": eval_plain_ms[
            "episode_returns_im_policy"]}),
        "sample_policy_streams_debug_im": (k12_t, {"best_ms": eval_plain_ms[
            "sample_policy_streams_debug_im"]}),
        "episode_returns_nv": (k13_t, k13_p), "episode_returns_nv_fused": (k14_t, k14_p),
        "sample_streams_debug_nv": (k15_t, k15_p),
        "episode_returns_nv_reset_fused": (k16_t, {"best_ms": k16_plain_ms}),
        "sample_streams_debug_nv_reset": (k17_t, k17_p)})
    print(f"[20 work] K11 per env-step: MLP {mlp_ops(im_dims)} + step {im_step_ops(im_params)} "
          f"+ draws {im_policy_draw_ops(im_params, table_len, stochastic=False)} ops "
          f"(deterministic); NV per env-step: step {nv_step} ops, draws {nv_draw:.1f} "
          f"(econ in) / {nv_draw_reset:.1f} (econ drawn) ops with the table "
          f"({ek._nv_table_plan(nv_poisson.window(nv_p)[1])}); the first version's "
          f"linear count "
          f"{nv_draw_linear:.1f} (econ drawn), K16's bound by it {k16_linear_bound[0]:.4f} ms; "
          f"K13-K15 and K17 and plain K14-K17 at {CHECK_LANES} x {nv_T}, E=1, plain K16 at "
          f"{CHECK_LANES} x {MAIN_EPISODES}", flush=True)
    for name in IM_EVAL_KERNELS + NV_KERNELS:
        print_kernel(20, name, times[name], work[name], launches[name])
        if name in tile_bounds:
            fp32_ms = tile_bounds[name][1]
            print(f"[20 kernel] {name}: the MLP's {mlp_tc_flops(im_dims)} FLOPs an env-step as "
                  f"three TF32 products; bound with every operation at FP32 {fp32_ms:.4f} ms "
                  f"({fp32_ms / times[name][0]['best_ms']:.1%} of it)", flush=True)
    print(f"[20 kernel] episode_returns_im_policy, stochastic: {k11s_t['best_ms']:.4f} ms "
          f"(mean {k11s_t['mean_ms']:.4f})", flush=True)
    k13_bound = work["episode_returns_nv"][0]
    print(f"[20 kernel] episode_returns_nv (K13, its pipeline in registers, an instance per "
          f"lead time, its streams staged by cp.async, {ek._nv_k13_plan()}): "
          f"{k13_alone_ms['streamed']:.4f} ms the kernel alone ({k13_bound / k13_alone_ms['streamed']:.1%} "
          f"of its bound), {k13_t['best_ms']:.4f} through the entry point; _random "
          f"{k13_alone_ms['random']:.4f} alone, {k13r_t['best_ms']:.4f} through the entry point "
          f"(best of 20), on {smi}", flush=True)
    nv_summary = {"random_ms": nv_t["best_ms"],
                  "random_env_steps_s": nv_steps / nv_t["best_ms"] * 1e3,
                  "k16_ms": k16_t["best_ms"], "k16_bound_ms": work[
                      "episode_returns_nv_reset_fused"][0],
                  "k16_linear_bound_ms": k16_linear_bound[0], "mean_return": nv_mean,
                  "plain_share": nv_share}

    # 21. the Newsvendor policy kernels against their plain versions
    t0 = time.perf_counter()
    err2, nv_plain_ms, lines = nv_policy_cross_check(dev)
    err.update(err2)
    for line in lines:
        print(f"[21 NV policy kernels] {line}", flush=True)
    print(f"[21 NV policy kernels] max |diff| {err2}; plain ms {nv_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 22. the seventh main path, counting launches: PPO on Newsvendor
    t0 = time.perf_counter()
    reset_counts(wrappers)
    lines, nv_update_ms, (nv_cfg, nv_state, _), nv_rates = ppo_main_path(
        nv.ENV, nv_p, dev, smi, "Newsvendor", ek.rollout_traj_nv, nv_T)
    launches7 = read_counts(wrappers)
    moved = {n: c for n, c in launches7.items() if c}
    if moved != {"rollout_traj_nv": PPO_UPDATES}:
        raise AssertionError(f"the Newsvendor PPO path launched {moved}, not K18 once per "
                             "update")
    nv_actor = ek.fold_actor_params(nv_cfg, nv_state.params, nv_state.rms)
    nv_log_std = nv_state.params.log_std.detach()
    for line in lines:
        print(f"[22 NV PPO main path] {line}", flush=True)
    print(f"[22 NV PPO main path] K18 launched once per update, nothing else, no plain "
          f"version; launches {launches7}; {time.perf_counter() - t0:.1f} s", flush=True)
    nv_summary.update({f"ppo_{k}": v for k, v in nv_rates.items()})

    # 23. the eighth main path, counting launches: Newsvendor learned-policy evaluation
    t0 = time.perf_counter()
    launches8, lines, eval_rates = eval_main_path(
        dev, wrappers, nv_p, nv_actor, nv_log_std, smi, "episode_returns_nv_policy",
        lambda seed: ek._nv_policy_plain(nv_p, nv_actor, None, seed, MULTI_LANES, E, dev)[0],
        nv_T)
    nv_summary.update(eval_rates)
    for line in lines:
        print(f"[23 NV eval main path] {line}", flush=True)
    print(f"[23 NV eval main path] launches {launches8}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches7[name] + launches8[name] for name in wrappers}
    missing = [name for name in ("rollout_traj_nv", "episode_returns_nv_policy")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"the slice-5 main paths launched no {missing}")

    # 24. per-kernel times of K18-K21 at the main paths' shapes, and the reward
    k18_t = cuda_time(ek.rollout_traj_nv, nv_p, nv_actor, nv_log_std, SEED, PPO_ENVS, "ppo",
                      "tanh", dev, warmup=1, iters=5)
    k19_t = cuda_time(ek.episode_returns_nv_policy, nv_p, nv_actor, SEED, PPO_ENVS, E, None,
                      dev, warmup=1, iters=3)
    k19s_t = cuda_time(ek.episode_returns_nv_policy, nv_p, nv_actor, SEED, PPO_ENVS, E,
                       nv_log_std, dev, warmup=1, iters=3)
    k20_t = cuda_time(ek.sample_policy_streams_debug_nv, nv_p, nv_actor, SEED, PPO_ENVS, E,
                      None, dev, warmup=1, iters=3)
    k21_t = cuda_time(ek.sample_normals_debug, SEED, NORMAL_ROWS, PPO_ENVS, dev, warmup=2,
                      iters=20)
    rows, b = NORMAL_ROWS - 1, RAGGED[0]   # no multiple of K21's rows a thread, nor of a warp
    k21_ragged = close(f"K21 vs plain K21, ragged {rows} x {b}",
                       ek.sample_normals_debug(SEED, rows, b, device=dev),
                       ek._sample_normals_plain(SEED, rows, b, dev), 0.0, 1e-5)
    print(f"[24 kernel] sample_normals_debug (K21) ragged {rows} x {b}: within atol=1e-5 of "
          f"plain K21, max |diff| {k21_ragged}", flush=True)
    err["sample_normals_debug"] = max(err["sample_normals_debug"], k21_ragged)
    nv_dims = [nv_p.obs_dim, 64, 64, 1]
    nv_det_linear = mlp_ops(nv_dims) + nv_step + nv_policy_draw_ops(nv_p, False)
    nv_det = mlp_ops(nv_dims) + nv_step + nv_policy_draw_ops(nv_p, False, table=True)
    nv_sto = mlp_ops(nv_dims) + nv_step + nv_policy_draw_ops(nv_p, True, table=True)
    n_nv_eval = PPO_ENVS * E * nv_T
    nv_bytes = {"episode_returns_nv_policy": PPO_ENVS * E * 4,
                "sample_policy_streams_debug_nv": PPO_ENVS * E * (1 + 5 + 2 * nv_T) * 4}
    nv_tile_bounds = {name: tc_bound(n_bytes, n_nv_eval, nv_det, mlp_tc_flops(nv_dims))
                      for name, n_bytes in nv_bytes.items()}
    nv_first_bounds = {name: bound(n_bytes, n_nv_eval * nv_det_linear)
                       for name, n_bytes in nv_bytes.items()}
    work.update({name: b for name, (b, _) in nv_tile_bounds.items()})
    # K18 on K19's tile: the MLP's products at TF32, every period's demand searched
    nv_tile_bounds["rollout_traj_nv"] = tc_bound(PPO_ENVS * (5 + 4 * nv_T) * 4,
                                                 PPO_ENVS * nv_T, nv_sto, mlp_tc_flops(nv_dims))
    nv_first_bounds["rollout_traj_nv"] = bound(
        PPO_ENVS * (5 + 4 * nv_T) * 4,
        PPO_ENVS * nv_T * (mlp_ops(nv_dims) + nv_step + nv_policy_draw_ops(nv_p, True)))
    work["rollout_traj_nv"] = nv_tile_bounds["rollout_traj_nv"][0]
    work.update({
        "sample_normals_debug": bound(NORMAL_ROWS * PPO_ENVS * 4,
                                      NORMAL_ROWS * PPO_ENVS * NORMAL_OPS),
    })
    times.update({name: (t, {"best_ms": nv_plain_ms[name]}) for name, t in (
        ("rollout_traj_nv", k18_t), ("episode_returns_nv_policy", k19_t),
        ("sample_policy_streams_debug_nv", k20_t), ("sample_normals_debug", k21_t))})
    print(f"[24 work] NV policy per env-step: MLP {mlp_ops(nv_dims)} + step {nv_step} + draws "
          f"{nv_policy_draw_ops(nv_p, False, table=True):.1f} (K19/K20, deterministic, the "
          f"search) / {nv_policy_draw_ops(nv_p, False):.1f} (the first version's linear count) / "
          f"{nv_policy_draw_ops(nv_p, True, table=True):.1f} (K18, stochastic, the search; "
          f"{nv_policy_draw_ops(nv_p, True):.1f} by its first version's linear count) ops; "
          f"K18-K20 run the MLP's "
          f"{mlp_tc_flops(nv_dims)} FLOPs on the tensor cores as three TF32 products; K21 "
          f"{NORMAL_OPS} ops a normal; plain versions timed in phase 21 with its seeded actor",
          flush=True)
    for name in NV_POLICY_KERNELS:
        print_kernel(24, name, times[name], work[name], launches[name])
        if name in nv_tile_bounds:
            fp32_ms, first_ms = nv_tile_bounds[name][1], nv_first_bounds[name][0]
            kt = times[name][0]["best_ms"]
            print(f"[24 kernel] {name}: bound with every operation at FP32 {fp32_ms:.4f} ms "
                  f"({fp32_ms / kt:.1%} of it); by the first version's count (the linear "
                  f"count, FP32) {first_ms:.4f} ms ({first_ms / kt:.1%})", flush=True)
    print(f"[24 kernel] episode_returns_nv_policy, stochastic: {k19s_t['best_ms']:.4f} ms "
          f"(mean {k19s_t['mean_ms']:.4f}); rollout_traj_nv is "
          f"{k18_t['best_ms'] / nv_update_ms:.1%} of the best NV PPO update "
          f"({nv_update_ms:.3f} ms)", flush=True)
    t0 = time.perf_counter()
    nv_avg, nv_se, nv_wall, nv_upd = nv_reward_check(dev, nv_p)
    if not (math.isfinite(nv_avg) and nv_avg > nv_mean):
        raise AssertionError(f"NV PPO reward {nv_avg} not above the random policy's {nv_mean}")
    print(f"[24 NV reward] benchmark_newsvendor.py PPO_CFG (256 envs x 50, 8 minibatches, "
          f"4 epochs, ent_coef 0), rollout=\"kernel\", {NV_PPO_BUDGET} env-steps ({nv_upd} "
          f"updates, {nv_wall:.1f} s), seed 0: deterministic return {nv_avg:.1f} +- "
          f"{nv_se:.1f} over {PPO_ENVS * E} episodes, random policy {nv_mean:.1f} (phase 19); "
          "RESULTS.md's TPU rows, rewards not speeds: PPO +97,569, best heuristic -106,568 "
          f"(XLA rollout, 30 episodes); {time.perf_counter() - t0:.1f} s", flush=True)
    nv_summary.update(k18_ms=k18_t["best_ms"], k19_ms=k19_t["best_ms"],
                      k19_stoch_ms=k19s_t["best_ms"],
                      k19_bound_ms=work["episode_returns_nv_policy"][0],
                      k19_fp32_bound_ms=nv_tile_bounds["episode_returns_nv_policy"][1],
                      k19_first_bound_ms=nv_first_bounds["episode_returns_nv_policy"][0],
                      k18_bound_ms=work["rollout_traj_nv"][0],
                      k18_fp32_bound_ms=nv_tile_bounds["rollout_traj_nv"][1],
                      k18_share_of_update=k18_t["best_ms"] / nv_update_ms,
                      reward_mean=nv_avg, reward_se=nv_se, reward_train_s=nv_wall,
                      reward_updates=nv_upd)

    # 25. the LSTM kernels against their plain versions, with a seeded actor
    t0 = time.perf_counter()
    err2, lstm_plain_ms, lines = lstm_cross_check(dev)
    err.update(err2)
    for line in lines:
        print(f"[25 LSTM kernels] {line}", flush=True)
    print(f"[25 LSTM kernels] {len(LSTM_CASES)} cases at {CHECK_LANES} x {NUM_STEPS}; max "
          f"|diff| over agreeing lanes {err2}; plain ms {lstm_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 26. the ninth main path, counting launches: recurrent PPO on InvManagement
    t0 = time.perf_counter()
    launches9, lines, (lstm_p, lstm_cfg, lstm_state, _), lstm_rates = lstm_train_main_path(
        dev, wrappers, smi)
    for line in lines:
        print(f"[26 RPPO main path] {line}", flush=True)
    print(f"[26 RPPO main path] launches {launches9}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    lstm_actor = ek.fold_lstm_actor(lstm_cfg, lstm_state.params, lstm_state.rms)
    lstm_log_std = lstm_state.params.log_std.detach()

    # 27. the tenth main path, counting launches: LSTM-policy evaluation
    t0 = time.perf_counter()
    launches10, k22_err, lines, eval_rates = lstm_eval_main_path(dev, wrappers, lstm_p,
                                                                 lstm_actor, smi)
    err["episode_returns_im_lstm"] = max(err["episode_returns_im_lstm"], k22_err)
    lstm_rates.update(eval_rates)
    for line in lines:
        print(f"[27 LSTM eval main path] {line}", flush=True)
    print(f"[27 LSTM eval main path] launches {launches10}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches9[name] + launches10[name] for name in wrappers}
    missing = [name for name in ("rollout_traj_im_lstm", "episode_returns_im_lstm")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"the slice-6 main paths launched no {missing}")

    # 28. per-kernel times of K22-K24 at the main paths' shapes, and the work model
    n22 = LSTM_EVAL_LANES
    k22_t = cuda_time(ek.episode_returns_im_lstm, lstm_p, lstm_actor, SEED, n22, dev,
                      warmup=1, iters=3)
    k22_p = cuda_time(ek._im_lstm_plain, lstm_p, lstm_actor, SEED, n22, dev, warmup=0, iters=1)
    k23_t = cuda_time(ek.sample_lstm_streams_debug_im, lstm_p, lstm_actor, SEED, n22, dev,
                      warmup=1, iters=3)
    k23_p = cuda_time(ek._im_lstm_plain, lstm_p, lstm_actor, SEED, n22, dev, True, warmup=0,
                      iters=1)
    k24_t = cuda_time(ek.rollout_traj_im_lstm, lstm_p, lstm_actor, lstm_log_std, SEED, PPO_ENVS,
                      dev, warmup=1, iters=5)
    k24_p = cuda_time(ek._rollout_traj_im_lstm_plain, lstm_p, lstm_actor,
                      ek.clipped_std(lstm_log_std), SEED, PPO_ENVS, dev, warmup=0, iters=3)
    lstm_dims = [lstm_p.pipeline_length] + list(LSTM_ENCODER)
    gate = lstm_gate_flops(lstm_dims, LSTM_HIDDEN)
    tc_flops = lstm_tc_flops(lstm_dims, LSTM_HIDDEN)
    cell_ops = lstm_ops(lstm_dims, LSTM_HIDDEN, m1) + im_step_ops(lstm_p)
    det_ops = cell_ops + im_policy_draw_ops(lstm_p, table_len, stochastic=False)
    sto_ops = cell_ops + im_policy_draw_ops(lstm_p, table_len)
    lstm_bounds = {
        "episode_returns_im_lstm": tc_bound(n22 * 4, n22 * T, det_ops, tc_flops),
        "sample_lstm_streams_debug_im": tc_bound(n22 * (1 + T * (m1 + 1)) * 4, n22 * T,
                                                   det_ops, tc_flops),
        "rollout_traj_im_lstm": tc_bound(
            PPO_ENVS * ((T + 1) * m1 + 2 * T * m1 + 2 * T) * 4, PPO_ENVS * T, sto_ops,
            tc_flops),
    }
    work.update({name: b for name, (b, _) in lstm_bounds.items()})
    times.update({"episode_returns_im_lstm": (k22_t, k22_p),
                  "sample_lstm_streams_debug_im": (k23_t, k23_p),
                  "rollout_traj_im_lstm": (k24_t, k24_p)})
    print(f"[28 work] LSTM per env-step: actor {lstm_ops(lstm_dims, LSTM_HIDDEN, m1)} ops "
          f"(widths {lstm_dims}, hidden {LSTM_HIDDEN}), step {im_step_ops(lstm_p)}, draws "
          f"{im_policy_draw_ops(lstm_p, table_len, stochastic=False)} (deterministic) / "
          f"{im_policy_draw_ops(lstm_p, table_len)} (stochastic); the gate product {gate} "
          f"and the encoder's products {tc_flops - gate} FLOPs of them, run as three TF32 "
          f"products at {TF32_TC_OPS_PER_S:.3g} FLOP/s, the rest at FP32; K22/K23 at {n22} x {T}, K24 at {PPO_ENVS} x {T}, with phase 26's "
          f"trained actor", flush=True)
    for name in LSTM_KERNELS:
        print_kernel(28, name, times[name], work[name], launches[name])
        fp32_ms = lstm_bounds[name][1]
        print(f"[28 kernel] {name}: bound with every operation at FP32 {fp32_ms:.4f} ms "
              f"({fp32_ms / times[name][0]['best_ms']:.1%} of it)", flush=True)
    lstm_rates.update(k22_ms=k22_t["best_ms"], k24_ms=k24_t["best_ms"],
                      k22_bound_ms=work["episode_returns_im_lstm"][0],
                      k22_fp32_bound_ms=lstm_bounds["episode_returns_im_lstm"][1],
                      k24_share_of_update=k24_t["best_ms"] / lstm_rates["update_ms"])
    print(f"[28 kernel] rollout_traj_im_lstm is {lstm_rates['k24_share_of_update']:.1%} of the "
          f"best recurrent PPO update ({lstm_rates['update_ms']:.3f} ms)", flush=True)

    # 29. reward at the recurrent protocol of tools/validate_kernel_ppo.py
    t0 = time.perf_counter()
    r_avg, r_se, r_random, r_wall, r_upd = lstm_reward_check(dev)
    if not (math.isfinite(r_avg) and r_avg > r_random):
        raise AssertionError(f"recurrent PPO reward {r_avg} not above the random policy's "
                             f"{r_random}")
    print(f"[29 RPPO reward] validate_kernel_ppo.py rppo_kernel protocol (IM backlog, periods "
          f"50, 1,024 envs, 8 minibatches, 4 epochs, {RPPO_BUDGET} steps = {r_upd} updates, "
          f"{r_wall:.1f} s), seed 0: AvgReward {r_avg:.1f} +- {r_se:.1f} over "
          f"{RPPO_EVAL_ENVS} deterministic episodes (eval_episodes); random policy "
          f"{r_random:.1f}; the JAX package's TPU run {TPU_RPPO_REWARD} (a reward, not a "
          f"speed); {time.perf_counter() - t0:.1f} s", flush=True)
    lstm_rates.update(reward_mean=r_avg, reward_se=r_se, reward_random_mean=r_random,
                      reward_train_s=r_wall, reward_updates=r_upd)

    launches_s7, off_summary = slice7_phases(dev, wrappers, smi, err, times, work)
    launches = {name: launches[name] + launches_s7[name] for name in wrappers}

    xla_summary = xla_phases(dev, wrappers, smi)

    launches_rppo, rppo_summary = rppo_xla_phases(dev, wrappers, smi, err)
    launches = {name: launches[name] + launches_rppo[name] for name in wrappers}

    launches_off, off_xla_summary = offpolicy_xla_phases(dev, wrappers, smi)
    launches = {name: launches[name] + launches_off[name] for name in wrappers}

    launches_bench, bench_summary = bench_phases(dev, wrappers, smi, err)
    launches = {name: launches[name] + launches_bench[name] for name in wrappers}

    rows = []
    for name, source, replaces in KERNEL_ROWS:
        (kt, pt), (b_ms, b_by) = times[name], work[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": kt["best_ms"],
                     "plain_ms": pt["best_ms"], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    rows[0]["by_shape"] = k1_shapes   # K1: the row's numbers are at 65,536 lanes
    rows[2]["kernel_ms"] = k3_alone_ms
    rows[6]["kernel_ms"] = k7_alone_ms["streamed"]   # K7: the row's numbers are streamed
    rows[6]["random"] = {"ms": k7r_t["best_ms"], "kernel_ms": k7_alone_ms["random"]}
    rows[12]["kernel_ms"] = k13_alone_ms["streamed"]   # K13: the row's numbers are streamed
    rows[12]["random"] = {"ms": k13r_t["best_ms"], "kernel_ms": k13_alone_ms["random"]}

    # the last lines: the kernels, a summary of the PPO main path (kept near
    # the end, where a short tail of the output still holds it), the card
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ppo_main_path": summary}))
    print(json.dumps({"im_main_path": im_summary}))
    print(json.dumps({"nv_main_path": nv_summary}))
    print(json.dumps({"lstm_main_path": lstm_rates}))
    print(json.dumps({"offpolicy_main_path": off_summary}))
    print(json.dumps({"xla_main_path": xla_summary}))
    print(json.dumps({"rppo_xla_main_path": rppo_summary}))
    print(json.dumps({"offpolicy_xla_main_path": off_xla_summary}))
    print(json.dumps({"bench_main_path": bench_summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
