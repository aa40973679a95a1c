"""Chip smoke test of the PyTorch/CUDA port (``hulc2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
1. the card: fail without CUDA; print its name and power limit (nvidia-smi);
2. build every native source of the main path from ``hulc2_torch/csrc``:
   the kernels with nvcc, the npz frame loader with g++;
3. each kernel against its plain PyTorch version at the main path's shapes
   (2048 frames of 96x96x3 with pad 4, and of 64x64x3 with pad 3), bit for
   bit, then its device time beside the memory-traffic bound, the plain
   version's and that of a bf16 cast of the same bytes (CUDA events around 50
   back-to-back launches, ``hulc2_torch.tools.bench_shift_normalize``);
4. a small-width policy on the card in fp32 (TF32 off) against the same
   policy on the CPU, same weights, batches and draws: the train-step losses
   must agree;
5. the full-width policy's forward under bf16 autocast against the same
   forward in fp32 on the card: the losses must agree within 5%;
6. the main path: ``python -m hulc2_torch.training --synthetic`` at the full
   flagship width for a few steps, with every kernel launch count reset just
   before and read just after: losses finite, parameters moved, and
   shift_normalize launched exactly twice per step;
7. (a) the kernel at pad 0, the evaluation's val transform with the preset's
   val mean and std, against its plain version on 1, 2, 4, 8 and 32 frames of
   96x96 and 64x64 (1-8 are the evaluations' frames per camera and dispatch),
   fp32 and bf16, bit for bit, and its device time at the eval's 8 frames per
   camera;
8. (b) the device renderer on the card against the same renderer on the CPU,
   32 evaluation initial states with perturbed robot poses: no pixel off by
   more than one, fewer than 1e-4 of them off at all, depth within 1e-5;
9. (c) a small fp32 policy's fused render+policy step through ``Hulc2Agent``,
   card against CPU, same weights and draws, 40 steps across a replan
   boundary with one ``reset_env_slot``: actions within 1e-3;
10. (d) the evaluation path: ``python -m hulc2_torch.evaluation.evaluate_policy
   --synthetic --fake-env --device-render`` over 32 chains with 32 envs in 4
   cohorts at the full flagship width, counts reset just before and read just
   after: 32 results in 0..5, results.json written, shift_normalize launched
   exactly twice per dispatch;
11. (e) the port's generator (``python -m hulc2_torch.tools.make_expert_dataset``)
   writes a small expert dataset at 96/64 px with token annotations;
12. (f) device-store batches on the card, through the prefetcher, against the
   same plan assembled on the host from the RAM cache, bit for bit, over two
   epochs;
13. (g) the disk path: ``python -m hulc2_torch.training`` from that dataset at
   the full flagship width, one epoch of 20 steps and 2 val batches, then the
   same command to a second epoch, which resumes from step 20, counts reset
   before each run: losses and val metrics finite, config.json and both
   checkpoints written, shift_normalize launched exactly 2 x train steps + 4 x
   val steps; then the kernel against its plain version, bit for bit, on the
   first validation batch (1024 frames per camera and modality) with the val
   pipelines' mean and std, fp32 and bf16;
14. (h) ``evaluate_policy --train-dir`` on that run, 8 chains: the loaded
   parameters equal the checkpoint's, results.json written, shift_normalize
   launched exactly twice per dispatch;
15. (i) the affordance detector (``rn18_tokens_pixel``) at full width in fp32,
   card against CPU, same weights: 8 frames of 96x96 resized on the device to
   224 and the token ids of 8 validation sentences; logits, depth mu and
   sigma within 1e-3 of the largest logit's magnitude (at least 1e-3), and
   equal argmax pixels wherever the CPU's top two logits are further apart
   than twice that;
16. (j) label mining: ``python -m hulc2_torch.affordance.dataset_creation``
   on (e)'s dataset must label frames in both splits;
17. (k) ``python -m hulc2_torch.affordance.train_affordance`` on those labels
   at batch 32, ``AFF_STEPS`` steps with a validation and a checkpoint per
   epoch: losses and val metrics finite, the decoder's and the tower's
   parameters moved, the encoder's bit for bit as initialised, config.json
   holding ``depth_norm``, the last step's checkpoint written;
18. (l) the hierarchical eval: ``evaluate_policy --train-dir`` (g)'s run
   ``--aff-train-dir`` (k)'s run, 8 chains, counts reset just before and
   read just after: the loaded detector's parameters equal the checkpoint's,
   results.json written, one affordance prediction per subtask start,
   approaches taken, shift_normalize launched exactly twice per dispatch;
19. (m) the paraphrase protocol: (l) again with ``--paraphrase-eval``: the
   policy's and the detector's goals are each task's held-out sentences;
   results.json written, ``"paraphrase_eval": true`` in the diagnostics, one
   prediction per subtask start, shift_normalize launched twice per dispatch;
20. (n) ``evaluate_policy --all-checkpoints --device-render`` over the disk
   run's two steps, 4 chains each: both in one results.json, "best" the one
   with the higher avg_seq_len, twice per dispatch of each step;
21. (o) ``--single-step --dataset-path`` the dataset of (e): as many jobs as
   ``harness.dataset_singlestep_sequences`` finds in its validation split,
   one subtask and one record each, twice per dispatch;
22. (p) ``interactive.main`` on the disk run with two instructions on a
   StringIO stdin, one from the offline keyword planner, up to 60 steps
   each: one verdict line per instruction, twice per policy step;
23. (q) the JAX package's default configuration, ``cfg_low_level``, from here
   on: the kernel against its plain version, bit for bit, at its
   ``rand_shift`` train shapes (2048 frames of 200x200x3 with pad 10 and of
   84x84x3 with pad 4), fp32 and bf16, then its device time beside the
   bytes bound;
24. (r) the port's generator writes a dataset at 200/84 px with hash
   sentence embeddings (no ``--lang-tokens``);
25. (s) a small fp32 ``cfg_low_level`` policy on the card against the CPU on
   one fixed batch of the host loader from (r): two train steps, losses
   within rel 1e-3; then ``python -m hulc2_torch.training --config-name
   cfg_low_level`` from (r) at full width, through the host loader
   (``FusedBatchLoader``, the native npz loader, pinned ring), one epoch of
   LOW_STEPS steps and LOW_VAL val batches, counts reset just before and read
   just after: losses and val metrics finite, a checkpoint written, the
   native loader used, shift_normalize launched exactly 2 x train steps + 4 x
   val steps; the step's wall time and its wait for the loader;
26. (t) ``evaluate_policy --train-dir`` (s)'s run ``--dataset-path`` (r)'s
   dataset (its embeddings.npy gives the goals), 8 chains on 8 envs in 2
   cohorts rendered at 200/84 on the card: results.json written,
   shift_normalize launched exactly twice per dispatch;
27. (u) the policy's options (PR 8), from here on: for a small fp32 model
   of each (``cfg_gcbc``, its aux heads, the GRU, LSTM and MLP decoders, the
   mixture over all 7 dims, the BiLSTM and BiRNN posteriors, continuous
   plans, the transformer's LayerNorms, ``lang_mlp``, ``vision_conv`` with
   ``cnn_4_layers``, sinusoid features with a learned temperature and
   ``cnn_3_layers``, AdamW with a cosine warm-up, SGD with a linear warm-up
   and clipping), two train steps on the card and on the CPU on one batch
   of the host loader from (r), same weights, offsets and plan noise:
   losses within rel 1e-3;
28. (v) ``python -m hulc2_torch.training --config-name cfg_gcbc`` from (r)
   at full width, OPT_STEPS steps and OPT_VAL val batches, counts reset just
   before and read just after: no plan, losses and val metrics finite, a
   checkpoint, shift_normalize launched exactly 2 x train steps + 4 x val
   steps, the step's wall time and loader wait; then ``evaluate_policy
   --train-dir`` on it as in (t), twice per dispatch;
29. (w) the same for the recurrent variant of ``cfg_low_level`` (the LSTM
   decoder and its (h, c) carry, the BiLSTM posterior, continuous plans,
   AdamW, the cosine warm-up), built from registry options and dotted
   overrides only; its eval takes the (h, c) carry through ``policy_step``,
   the per-env reset and the pipelined evaluator;
30. (x) the observation space, from here on: for a small fp32 model
   of each new option (a depth static encoder, the static camera only with
   the identity proprio encoder, robot_scene's robot_obs ++ scene_obs, frame
   skipping random and diff, vision_only and lang_only), two train steps on
   the card and on the CPU on one batch of the option's own training loader
   from (r), same weights, transform draws and plan noise: losses within
   rel 1e-5;
31. (y) ``cfg_low_level`` with ``rgbd_both``'s depth_static encoder (no
   gripper depth: the fake env renders none) from (r) at full width,
   OBS_STEPS steps and OBS_VAL val batches: the depth encoder's parameters
   moved, shift_normalize 2 x train steps + 4 x val steps; then its eval as
   in (t), depth_static rendered in the fused step, twice per dispatch;
32. (z) the static camera only with robot_scene proprio (scene_obs) and
   random frame skipping, the same way: shift_normalize 1 x train steps +
   2 x val steps, once per dispatch, every agent holding the training
   split's statistics;
33. (aa) every transform preset's train and val pipelines card against CPU
   at 200/84 and at 96/64 px (real resizes), same draws, within 1e-5 of
   scale, every uint8 kernel run launched; the kernel at the other presets'
   static shapes (200 px pad 0, 150x200 pad 6, 224 px pad 10 with CLIP's
   statistics) bit for bit with its device time and bound; then
   ``datamodule/datasets=vision_only`` and ``=lang_only``, SINGLE_STEPS
   steps each from (r), 2 launches a train and a val step;
34. (ab) the pretrained encoders and the real-robot root, from here on: for
   a small fp32 model of each (``cfg_low_level_rw``'s frozen R3M stream,
   ``static_clip`` with a narrow RN50 and a narrow ViT tower, ``vision_resnet``
   on the static camera with R3M on the gripper, ``vision_resnet_aff``, and
   ``static_rgb_tactile`` with 6-channel tactile frames of 160x120 added to
   the batch), two train steps on the card and on the CPU on one batch of
   the host loader from (r), same weights, transform draws and plan noise:
   losses within rel 1e-5;
35. (ac) ``python -m hulc2_torch.training --config-name cfg_low_level_rw``
   from (r) at full width through the process loader
   (``datamodule.loader_isolation=process``), RW_STEPS steps and RW_VAL val
   batches, the only overrides those (r)'s data forces (its action key and
   ``lang_folder``): shift_normalize 2 x train steps + 4 x val steps, the
   frozen R3M trunk bit for bit as initialised, no ``hulc2_pl_*`` segment
   left; then its eval as in (t), twice per dispatch; then the kernel at the
   real-robot preset's shapes (200 px and 84 px, pad 0, mean 0, std 1) bit
   for bit with its device time and bound;
36. (ad) the process loader against the thread loader on the same
   ``cfg_low_level_rw`` config in turns (thread, process, thread, process):
   each turn's first ISOLATION_BATCHES batches bit for bit equal to the
   first turn's, through the prefetcher into the train step; per turn the
   median step wall time, loader wait and device busy; no segment left;
37. (ae) ``static_clip`` at full width with the RN50 and the ViT-B/32
   tower (``datamodule.transforms=clip``, 224 px), ENCODER_STEPS synthetic
   train steps each through ``python -m hulc2_torch.training --synthetic``:
   losses finite, the frozen tower bit for bit as initialised, 2 launches a
   step; the step's wall time and device busy;
38. (af) ``static_rgb_tactile`` the same way, with 6-channel tactile frames
   of 160x120 that the ``resize 70`` op resizes: 1 launch a step;
39. (ag) the affordance package's options, from here on: for a small fp32
   detector of each (the nine sentence-level fusers other than ``mult``,
   ResNet50, CLIP RN50 and R3M encoders frozen and trainable, the logistic
   head with metric bounds, no depth head, mask labels, ``rn18_pixel``'s
   sentence embeddings), two train steps on the card and on the CPU, same
   weights, batches and crop offsets, cuDNN deterministic: losses within
   rel 1e-5; the bf16 decoder card against CPU within rel 1e-2 and against
   the card's fp32 within 5%;
40. (ah) labels mined from (r)'s dataset, then ``python -m
   hulc2_torch.affordance.train_affordance aff_detection=rn18_pixel`` (the
   JAX root's default: frozen ResNet18, ``mult``, Gaussian head, 1024-d hash
   sentence embeddings under ``HULC2_ALLOW_STUB_EMBEDDINGS=1``) at batch 32
   and 224 px for AFF_LOW_STEPS steps: losses and val metrics finite, the
   encoder bit for bit as initialised, ``depth_norm`` in config.json, a
   checkpoint; then ``evaluate_policy --train-dir`` (s)'s run
   ``--dataset-path`` (r) ``--aff-train-dir`` that run, 8 chains on 8 envs in
   2 cohorts: one prediction per subtask start, approaches, shift_normalize
   launched exactly twice per dispatch, env-steps/s and ``aff_flush_s``;
41. (ai) ``rn18_pixel`` in fp32 and with the bf16 decoder, ``rn50_pixel``,
   ``r3m_pixel``, ``clip`` and ``rn18_clip_mask`` at full width on synthetic
   frames, AFF_OPT_STEPS steps each: R3M's layer4 moved with its stem
   through layer3 bit for bit, every other encoder bit for bit; the step's
   wall time, device busy and the convolutions' share; then ``python -m
   hulc2_torch.affordance.train_depth --synthetic`` for DEPTH_ONLY_STEPS
   steps: total loss = depth loss, the encoder moved; then phase 5's bf16
   gate on ``cfg_low_level_rw``, ``static_clip`` with RN50 and with
   ViT-B/32, and ``static_rgb_tactile``;
42. (aj) the eval backends beyond the fake env, from here on, on the
   recorded calvin_env contract (``tests/mock_calvin_env`` first on
   ``PYTHONPATH``): the kernel at pad 0 at their shapes (1 and 4 frames of
   200x200 and of 84x84, the cfg_low_level val pipeline's statistics) bit for
   bit, with its device time per batched dispatch and per serial step; then
   ``python -m hulc2_torch.evaluation.evaluate_policy --train-dir`` (s)'s run
   ``--dataset-path`` (r) (its ``.hydra/merged_config.yaml`` written)
   ``--aff-train-dir`` (ah)'s run ``--aff-lang-embeddings`` a table of its
   hash embeddings, 8 chains on 8 envs in 2 cohorts with ``--process-envs``
   in a subprocess, then again without it: calvin_env's native oracle chosen,
   results.json and partial_results.json written, the same results and
   records from both farms, one prediction per subtask start, every env
   worker without a card or torch, shift_normalize launched exactly twice per
   dispatch (the subprocess's own counts); env-steps/s and the farm's step
   wait;
43. (ak) the serial loop, ``--n-envs 1`` with the detector over 2 chains,
   then with ``--heuristic-oracle``: one prediction per subtask start,
   approach steps taken (JAX's agent raises there), the heuristic oracle
   scoring calvin_env's info (JAX's raises there), twice per policy step;
44. (al) ``real_world_eval.main`` with ``--env-factory
   hulc2_torch.envs.fake_env:FakeCalvinEnv``, (s)'s run, (ah)'s detector and
   two instructions: each approach moves the TCP more than 5 cm before the
   policy steps, twice per policy step; then ``python -m
   hulc2_torch.affordance.test_move_to_pt`` exits 0;
45. (am) the trainer's callbacks and sinks: ``python -m hulc2_torch.training``
   at full flagship width from (e)'s dataset, two epochs of CB_STEPS steps
   and CB_VAL val batches, with the JAX package's documented disk-run
   rollouts (``docs/runs/r3_disk_run.md:15-19``: ``callbacks.rollout_lh`` of 4
   chains with a video, ``callbacks.rollout`` of both modalities on the fake
   env), ``callbacks.tsne_plot``, ``logger=tb`` and ``callbacks/checkpoint=lh_sr``
   keeping the best one, counts reset just before and read just after:
   ``eval_lh/*``, ``tasks/*`` and ``tasks_vis/*`` in metrics.jsonl, the kept
   checkpoint the best by ``eval_lh/avg_seq_len``, shift_normalize launched
   exactly 2 x train steps + 4 x (val steps + plan-sampler batches) + 2 x
   (the rollouts' policy steps + visual goals); the video, the t-SNE figure
   and the tensorboard events checked where their packages import, and the
   packages that are missing printed; the callbacks' time per eval epoch
   and env-steps/s;
46. (an) data parallel on the one card: the kernel at the per-rank shapes
   (1024 frames of 96x96 pad 4 and of 64x64 pad 3) bit for bit; two spawned
   gloo ranks train the full-width flagship in fp32 (TF32 off) on local
   batches of 16 + 16 windows, DP_STEPS Adam steps, then DP_STEPS SGD steps,
   against one process on the global 32 + 32 with the same draws: every loss
   term and the grad norm within rel 1e-3, the parameters after the SGD steps
   within rel 1e-3 of their scale; the step's time for 2 ranks and 1 process
   and the all-reduce's share; each rank's launches exactly 2 per step; then
   ``torchrun --nproc_per_node 1 -m hulc2_torch.training`` over nccl, one
   epoch of TORCHRUN_STEPS steps, twice per step by its own count;
47. the kernels line, the card line, and the final JSON line.
"""
from __future__ import annotations

import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

MAIN_STEPS = 10
WARM_STEPS = 2  # steps 0 and 1 carry cuDNN's algorithm search and allocator growth
BUILD = Path(__file__).resolve().parent / "build"
RUN_DIR = BUILD / "chip_smoke_run"
EVAL_DIR = BUILD / "chip_smoke_eval"
EVAL_ENVS, EVAL_COHORTS, EVAL_CHAINS, EVAL_EP_LEN = 32, 4, 32, 360
# the disk path: a dataset of about 1,700 + 220 frames (29 train batches of
# 32 + 32 windows per epoch, 4 val batches), two runs of one epoch each cut
# to DISK_STEPS steps and DISK_VAL val batches, then 8 chains of the trained run
DATA_DIR = BUILD / "chip_smoke_data"
DISK_RUN = BUILD / "chip_smoke_disk"
DATA_EPISODES, DATA_TASKS, DATA_VAL_TASKS = 3, 12, 6
LOADER_BATCHES = 3
DISK_STEPS, DISK_VAL = 20, 2
DISK_ENVS, DISK_COHORTS, DISK_CHAINS = 8, 2, 8
# the affordance phases: labels mined from the disk path's dataset, a
# detector trained on them for AFF_STEPS steps, then the hierarchical eval of
# the disk run with that detector
AFF_DATA = BUILD / "chip_smoke_aff_data"
AFF_RUN = BUILD / "chip_smoke_aff"
HIER_DIR = BUILD / "chip_smoke_hier"
AFF_STEPS = 20
AFF_FRAMES = 8
# the other protocols, on the disk run (and (k)'s detector): the paraphrase
# eval at (l)'s counts, the every-checkpoint sweep over both saved steps with
# SWEEP_CHAINS chains each, the single-step protocol on the dataset's
# validation split, and the interactive entry point with two instructions
PARA_DIR = BUILD / "chip_smoke_para"
SWEEP_DIR = BUILD / "chip_smoke_sweep"
SINGLE_DIR = BUILD / "chip_smoke_single"
SWEEP_ENVS, SWEEP_CHAINS = 4, 4
SINGLE_ENVS = 2
INTERACTIVE_EP_LEN = 60
# the default configuration, cfg_low_level: a 200/84 px dataset with hash
# embeddings (2 training episodes of 15 tasks, 24 batches of cfg_low_level's
# 32 + 32 windows, and 1 validation episode of 6),
# one training run of LOW_STEPS steps and LOW_VAL val batches through the
# host loader, then 8 chains of the trained run with the dataset's goals
LOW_DATA = BUILD / "chip_smoke_low_data"
LOW_RUN = BUILD / "chip_smoke_low"
LOW_EPISODES, LOW_TASKS, LOW_VAL_TASKS = 2, 15, 6
LOW_STEPS, LOW_VAL = 20, 2
# the policy's options: two full-width runs of OPT_STEPS steps from (r)'s
# dataset, each scored like (t)
GCBC_RUN = BUILD / "chip_smoke_gcbc"
RECURRENT_RUN = BUILD / "chip_smoke_recurrent"
OPT_STEPS, OPT_VAL = 10, 2
RECURRENT = ["model.action_decoder.rnn_model=lstm_decoder", "model/plan_recognition=bilstm",
             "model/distribution=continuous", "model/optimizer=adamw",
             "model/lr_scheduler=cosine_warmup"]
OPTION_CASES = {
    "cfg_gcbc": ("cfg_gcbc", []),
    "gcbc_aux_heads": ("cfg_gcbc", ["model.use_state_recons=true",
                                    "model.use_bc_z_auxiliary_loss=true",
                                    "model.use_mia_auxiliary_loss=true"]),
    "recurrent_variant": ("cfg_low_level", RECURRENT),
    "gru_decoder": ("cfg_low_level", ["model.action_decoder.rnn_model=gru_decoder"]),
    "mlp_decoder_mixture": ("cfg_low_level", ["model.action_decoder.rnn_model=mlp_decoder",
                                              "model.action_decoder.discrete_gripper=false"]),
    "birnn_posterior": ("cfg_low_level", ["model/plan_recognition=birnn"]),
    "transformer_norms_lang_mlp": ("cfg_low_level", [
        "model.plan_recognition.encoder_normalize=true",
        "model.plan_recognition.positional_normalize=true", "model/language_encoder=mlp"]),
    "vision_conv_cnn_4_layers": ("cfg_low_level", [
        "model/perceptual_encoder/rgb_static=vision_conv",
        "model.perceptual_encoder.rgb_gripper.conv_encoder=\"cnn_4_layers\""]),
    "sinusoid_temp_cnn_3_layers": ("cfg_low_level", [
        "model.perceptual_encoder.rgb_static.use_sinusoid=true",
        "model.perceptual_encoder.rgb_static.spatial_softmax_temp=null",
        "model.perceptual_encoder.rgb_gripper.conv_encoder=\"cnn_3_layers\""]),
    "sgd_linear_warmup_clip": ("cfg_low_level", ["model/optimizer=sgd",
                                                 "model/lr_scheduler=linear_warmup",
                                                 "model.optimizer.gradient_clip_norm=1.0"]),
}
# the observation space: on (r)'s dataset (float16 depth_static and scene_obs
# in every frame), a depth run and a static-camera run with proprio,
# scene_obs and frame skipping, OBS_STEPS steps and OBS_VAL val batches each,
# scored like (t); then each single-modality config for SINGLE_STEPS steps
DEPTH_RUN = BUILD / "chip_smoke_depth"
SCENE_RUN = BUILD / "chip_smoke_scene"
VISION_ONLY_RUN = BUILD / "chip_smoke_vision_only"
LANG_ONLY_RUN = BUILD / "chip_smoke_lang_only"
OBS_STEPS, OBS_VAL, SINGLE_STEPS = 10, 2, 5
DEPTH = ["model/perceptual_encoder=rgbd_both", "model.perceptual_encoder.depth_gripper=null",
         'datamodule.observation_space.depth_obs=["depth_static"]']
SCENE = ["model/perceptual_encoder=static_rgb",
         "datamodule/observation_space=lang_rgb_static_robot_scene_abs_act",
         "datamodule/proprioception_dims=robot_scene",
         "model.perceptual_encoder.proprio.n_state_obs=54"]
# frame skipping cut to LOW_SMALL's 4-frame windows (the posterior's positions end there)
SKIP_SMALL = ["datamodule.frame_skip.effective_min_ws=2", "datamodule.frame_skip.effective_max_ws=3"]
OBS_CASES = {
    "depth_static": DEPTH,
    "static_proprio": ["model/perceptual_encoder=static_rgb",
                       "datamodule/observation_space=lang_rgb_static_rel_act"],
    "robot_scene": SCENE,
    "frame_skip_random": ["datamodule/frame_skip=random"] + SKIP_SMALL,
    "frame_skip_diff": ["datamodule/frame_skip=diff"] + SKIP_SMALL,
    "vision_only": ["datamodule/datasets=vision_only"],
    "lang_only": ["datamodule/datasets=lang_only"],
}
# the pretrained encoders and the real-robot root: (r)'s data writes
# rel_actions and lang_annotations, the only overrides cfg_low_level_rw needs
RW_DATA = ['datamodule.observation_space.actions=["rel_actions"]',
           "datamodule.lang_folder=lang_annotations"]
RW_RUN = BUILD / "chip_smoke_rw"
RW_STEPS, RW_VAL = 10, 2
RW_SHAPES = {"real_world_r3m rgb_static": (2048, 200, 200, 0, [0.0], [1.0]),
             "real_world_r3m rgb_gripper": (2048, 84, 84, 0, [0.0], [1.0])}
ISOLATION_BATCHES, BUSY_STEPS = 10, 3
ENCODER_STEPS = 10
ENCODER_RUN = BUILD / "chip_smoke_encoders"
TACTILE_HW = (160, 120)
CLIP_SMALL = ('model.perceptual_encoder.rgb_static.tower_kwargs='
              '{"layers": [1, 1, 1, 1], "width": 32, "heads": 4}')
VIT_SMALL = ('model.perceptual_encoder.rgb_static.tower_kwargs='
             '{"patch_size": 20, "width": 64, "layers": 2, "heads": 2}')
TACTILE = ["model/perceptual_encoder=static_rgb_tactile",
           "datamodule/observation_space=lang_rgb_static_tactile_abs_act"]
PRETRAINED_CASES = {
    "rw_r3m": ("cfg_low_level_rw", RW_DATA),
    "clip_rn50": ("cfg_low_level", ["model/perceptual_encoder=static_clip", CLIP_SMALL]),
    "clip_vit": ("cfg_low_level", ["model/perceptual_encoder=static_clip",
                                   'model.perceptual_encoder.rgb_static.model_name="ViT-B/32"',
                                   VIT_SMALL]),
    "resnet_static_r3m_gripper": ("cfg_low_level", ["model/perceptual_encoder/rgb_static=resnet",
                                                    "model/perceptual_encoder/rgb_gripper=r3m"]),
    "resnet_aff": ("cfg_low_level", ["model/perceptual_encoder/rgb_static=resnet_aff"]),
    "tactile": ("cfg_low_level", TACTILE),
}
LOW_SMALL = [
    "model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
    "model.plan_recognition.fc_hidden_size=64", "model.plan_recognition.dropout_p=0.0",
    "model.visual_goal.hidden_size=64", "model.language_goal.hidden_size=64",
    "model.action_decoder.hidden_size=64", "model.compute_dtype=\"float32\"",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.min_window_size=4", "datamodule.max_window_size=4",
]

# the affordance package's options: (ag) small fp32 detectors of each new
# option card against CPU; (ah) the JAX root's rn18_pixel detector over
# 1024-d hash sentence embeddings, trained on labels mined from (r)'s dataset,
# then the hierarchical eval of (s)'s cfg_low_level run with it; (ai) the
# other encoders, the mask labels and the bf16 decoder at full width on
# synthetic frames, AFF_OPT_STEPS steps each, then train_depth; and the
# bf16-vs-fp32 gate of phase 5 on the pretrained trunks' presets
AFF_SMALL = ["aff_detection.decoder_channels=[32,16,8,8,8]", "aff_detection.lang_embed_dim=16",
             "aff_detection.dataset.img_resize.static=64", "batch_size=2"]
AFF_OPTION_CASES = {
    **{f"fusion {f}": ("rn18_pixel", [f"aff_detection.fusion_type={f}"])
       for f in ("add", "max", "concat", "conv", "conv_lat", "film", "deep_conv", "cross_modal_2d",
                 "sentence_attention")},
    **{f"{g} {'frozen' if frozen else 'trainable'}":
       (g, [f"aff_detection.freeze_encoder={str(frozen).lower()}"])
       for g in ("rn50_pixel", "rn50_clip_pixel", "r3m_pixel") for frozen in (True, False)},
    "logistic head, metric bounds": ("rn18_pixel", ["aff_detection.depth_dist=logistic",
                                                    "aff_detection.normalize_depth=false"]),
    "no depth head": ("rn18_pixel", ["aff_detection.depth_dist=null"]),
    "mask labels": ("rn18_clip_mask", []),
    "sentence embeddings": ("rn18_pixel", []),
}
AFF_BF16 = ["aff_detection.compute_dtype=bfloat16"]
AFF_LOW_DATA = BUILD / "chip_smoke_aff_low_data"
AFF_LOW_RUN = BUILD / "chip_smoke_aff_low"
AFF_LOW_DIR = BUILD / "chip_smoke_aff_low_hier"
AFF_LOW_STEPS = 12
AFF_OPT_STEPS = 6
AFF_PRESETS = {
    "rn18_pixel": ["aff_detection=rn18_pixel"],
    "rn18_pixel bf16": ["aff_detection=rn18_pixel", *AFF_BF16],
    "rn50_pixel": ["aff_detection=rn50_pixel"],
    "r3m_pixel": ["aff_detection=r3m_pixel"],
    "clip": ["aff_detection=clip"],
    "rn18_clip_mask": ["aff_detection=rn18_clip_mask"],
}
DEPTH_ONLY_RUN = BUILD / "chip_smoke_train_depth"
DEPTH_ONLY_STEPS = 3
# the eval backends beyond the fake env: (s)'s cfg_low_level run with (ah)'s
# rn18_pixel detector on the recorded calvin_env contract (tests/mock_calvin_env,
# first on the eval's PYTHONPATH), batched with and without the process farm
# (aj) and serial (ak), then the real-robot eval on the fake env (al)
MOCK_CALVIN = Path(__file__).resolve().parent / "tests" / "mock_calvin_env"
REAL_DIR = BUILD / "chip_smoke_real_env"
AFF_TABLE = BUILD / "chip_smoke_aff_table.npy"
REAL_EP_LEN = 40
SERIAL_CHAINS = 2
RW_EP_LEN = 20
# the trainer's callbacks and sinks (am) from (e)'s dataset, and data parallel
# on the one card (an)
CB_RUN = BUILD / "chip_smoke_callbacks"
CB_STEPS, CB_VAL = 4, 1
CB_CALLBACKS = [
    'callbacks.rollout_lh={"env":"fake","num_sequences":4,"ep_len":4,"every_n_epochs":2,'
    '"start_epoch":1,"video_dir":"auto","num_videos":1}',
    'callbacks.rollout={"env":"fake","rollouts_per_task":1,"ep_len":8,"every_n_epochs":2,'
    '"start_epoch":1}',
    'callbacks.tsne_plot={"every_n_epochs":1}', "logger=tb", "callbacks/checkpoint=lh_sr",
    "callbacks.checkpoint.save_top_k=1",
]
DIAGNOSTICS = {"video": ("cv2", "imageio"), "t-SNE": ("sklearn", "matplotlib"),
               "tensorboard": ("tensorboard",)}
DP_WORLD, DP_STEPS = 2, 3
DP_SGD = ["model/optimizer=sgd", "model.optimizer.lr=0.05"]
TORCHRUN_RUN = BUILD / "chip_smoke_torchrun"
TORCHRUN_STEPS = 4
BF16_PRESETS = {
    "cfg_low_level_rw": ("cfg_low_level_rw", []),
    "static_clip RN50": ("cfg_low_level", ["model/perceptual_encoder=static_clip",
                                           "datamodule.transforms=clip"]),
    "static_clip ViT-B/32": ("cfg_low_level", [
        "model/perceptual_encoder=static_clip", "datamodule.transforms=clip",
        'model.perceptual_encoder.rgb_static.model_name="ViT-B/32"']),
    "static_rgb_tactile": ("cfg_low_level", TACTILE),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from hulc2_torch.kernels import build

    t0 = time.perf_counter()
    results = build.build()
    print(f"[build] {len(results)} native libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, res in results.items():
        print(f"[build] {name}: {res.path.name} in {res.seconds:.1f} s", flush=True)
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)


def phase_kernel_vs_plain(dev: torch.device) -> dict:
    """The kernel against its plain version, bit for bit, at the main path's
    shapes; then device times per launch (``tools/bench_shift_normalize``: 50
    back-to-back launches over 4 input sets between one pair of CUDA events) of
    the kernel, the plain version and a bf16 cast of the same bytes."""
    from hulc2_torch.ops import preprocess
    from hulc2_torch.tools import bench_shift_normalize as bench

    totals = {"ms": 0.0, "plain_ms": 0.0, "cast_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for seed, (cam, (n, hw, pad)) in enumerate(bench.SHAPES.items()):
        sets = bench.make_sets(n, hw, pad, bench.SETS, dev, seed)
        imgs, offsets = sets[0]
        for out_dtype in (torch.float32, torch.bfloat16):
            got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            torch.cuda.synchronize(dev)
            if not torch.isfinite(got.float()).all():
                fail(f"shift_normalize {cam} {out_dtype}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            # tolerance 0: the kernel rounds the multiply, the add and the bf16
            # cast exactly as the plain version does
            print(f"[kernel] shift_normalize {cam} {n}x{hw}x{hw}x3 pad {pad} {out_dtype}: "
                  f"max_abs_err {err:.3g} (tol 0)", flush=True)
            if err > 0 or got.shape != want.shape:
                fail(f"shift_normalize disagrees with its plain version on {cam} {out_dtype}")
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
        ms = bench.device_ms(bench.rotating(bench.kernel_fn(pad), sets))
        plain_ms = bench.device_ms(bench.rotating(bench.plain_fn(pad), sets))
        cast_ms = bench.device_ms(bench.rotating(bench.cast_fn, sets))
        bound_ms, bound_by = bench.bound(n, hw, 2)
        gbytes = 3 * imgs.numel() / 1e9  # uint8 in, bf16 out
        print(f"[kernel] shift_normalize {cam} bf16, device time per launch: kernel {ms:.4f} ms "
              f"({gbytes / ms:.3f} TB/s), bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of roofline); plain version {plain_ms:.4f} ms (same "
              f"arithmetic, unfused); PyTorch's bf16 cast of the same bytes {cast_ms:.4f} ms "
              f"({gbytes / cast_ms:.3f} TB/s)", flush=True)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["cast_ms"] += cast_ms
        totals["bound_ms"] += bound_ms
        del sets, imgs, offsets, got, want
    return {"bound_by": bound_by, **totals}


SMALL_OVERRIDES = [
    "model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
    "model.plan_recognition.fc_hidden_size=64", "model.plan_recognition.dropout_p=0.0",
    "model.visual_goal.hidden_size=64", "model.language_goal.hidden_size=64",
    "model.action_decoder.hidden_size=64", "model.language_encoder.width=32",
    "model.language_encoder.heads=2", "model.compute_dtype=\"float32\"",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.max_window_size=4",
]


def phase_reference(dev: torch.device) -> None:
    """Two fp32 train steps of a small policy on the card and on the CPU, same
    weights, batches and draws; the card runs the kernel, the CPU its plain
    version."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.data.random_data import RandomWindowBatches
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = flagship_config(SMALL_OVERRIDES)
    dm, mc = cfg["datamodule"], cfg["model"]
    data = RandomWindowBatches(2, 2, 4, seed=3, device="cpu")
    batches = [data.next_batch() for _ in range(2)]
    draws = []
    g = torch.Generator().manual_seed(4)
    for _ in batches:
        offsets = {cam: torch.randint(0, 2 * pad + 1, (16, 2), generator=g, dtype=torch.int32)
                   for cam, pad in (("rgb_static", 4), ("rgb_gripper", 3))}
        draws.append((offsets, -torch.log(-torch.log(torch.rand((4, 32, 32), generator=g)))))
    losses = {}
    for device in (torch.device("cpu"), dev):
        model = build_policy(mc, seed=5).to(device)
        opt = make_optimizer(model.parameters(), mc["optimizer"])
        tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], dm["transforms"])
        step = make_train_step(model, opt, tf, 3.0, aux_betas_from_loss_cfg(cfg["loss"]), device=device)
        losses[device.type] = []
        for raw, (offsets, gumbel) in zip(batches, draws):
            raw_d = {m: {k: v.to(device) for k, v in w.items()} for m, w in raw.items()}
            shifts = {k: {1: v.to(device)} for k, v in offsets.items()}  # the shift is op 1
            metrics = step(raw_d, None, 0.01, gumbel=gumbel.to(device), draws=shifts)
            losses[device.type].append(metrics["loss"].item())
    print(f"[reference] small fp32 policy, 2 train steps: cpu {losses['cpu']} cuda {losses['cuda']}",
          flush=True)
    for a, b in zip(losses["cpu"], losses["cuda"]):
        # fp32 on both sides, reduction orders differ; Adam's first update can
        # amplify near-zero gradients, so the second step gets a looser bound
        if not math.isclose(a, b, rel_tol=1e-3, abs_tol=1e-4):
            fail(f"card and CPU train-step losses disagree: {losses}")


def phase_bf16_vs_fp32(dev: torch.device, cfg: dict = None, tag: str = "flagship") -> float:
    """One forward of the full-width policy (``cfg``, the flagship's by
    default) on one synthetic batch under bf16 autocast (bf16 transform
    output) and in fp32 (fp32 output), same weights, transform draws and
    Gumbel draws: the bf16 losses must stay within 5% of the fp32 ones.
    Returns the largest relative gap."""
    from hulc2_torch import training
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import LANG_KEYS, make_batch_transform

    cfg = cfg or flagship_config()
    dm = cfg["datamodule"]
    run = training.SyntheticRun(cfg, dev)
    model, raw = run.model, run.next_batch()
    n_vis = raw["vis"]["actions"].shape[0]
    fused = {k: torch.cat([raw["vis"][k], raw["lang"][k]]) for k in raw["vis"] if k in raw["lang"]}
    fused.update({k: raw["lang"][k] for k in LANG_KEYS if k in raw["lang"]})
    gumbel = model.dist.gumbel((fused["actions"].shape[0], model.dist.category_size,
                                model.dist.class_size), torch.Generator(device=dev).manual_seed(9),
                               dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                  dm["transforms"], dtype=dtype)
        batch = tf(fused, torch.Generator(device=dev).manual_seed(10), None)
        with torch.no_grad(), torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                             enabled=dtype == torch.bfloat16):
            out[dtype] = model(batch, cfg["loss"]["kl_beta"], n_vis, deterministic=True,
                               gumbel=gumbel)
    worst = 0.0
    for k, ref in out[torch.float32].items():
        if k == "lang_task_acc":
            continue
        a, b = ref.item(), out[torch.bfloat16][k].item()
        gap = abs(a - b) / max(abs(a), 1e-3)
        print(f"[bf16] {tag} {k}: fp32 {a:.5f} bf16 {b:.5f} rel gap {gap:.2e}", flush=True)
        if not math.isfinite(b) or gap > 0.05:
            fail(f"{tag}: bf16 forward drifts from fp32 on {k}: {a} vs {b}")
        worst = max(worst, gap)
    del run, model, raw, fused, out
    return worst


def phase_main_path(dev: torch.device, card: str) -> dict:
    from hulc2_torch import kernels, training
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.models.build import build_policy

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    result = training.main(["--synthetic", "--max-steps", str(MAIN_STEPS), "--device", "cuda",
                            "--run-dir", str(RUN_DIR)])
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if len(result.history) != MAIN_STEPS:
        fail(f"expected {MAIN_STEPS} steps, got {len(result.history)}")
    for line in result.history:
        bad = [k for k, v in line.items() if not math.isfinite(v)]
        if bad:
            fail(f"non-finite metrics at step {line['step']}: {bad}")
    if launches["shift_normalize"] != 2 * MAIN_STEPS:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{MAIN_STEPS} steps, expected {2 * MAIN_STEPS}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    cfg = flagship_config()
    fresh = build_policy(cfg["model"], seed=cfg["seed"]).state_dict()
    trained = result.model.state_dict()
    moved = sum(not torch.equal(fresh[k], trained[k].cpu()) for k in fresh)
    if moved < len(fresh) // 2:
        fail(f"only {moved} of {len(fresh)} parameter tensors changed")
    lines = (RUN_DIR / "metrics.jsonl").read_text().splitlines()
    if len(lines) < MAIN_STEPS:
        fail("metrics.jsonl is short")

    n_params = sum(p.numel() for p in result.model.parameters())
    steady = [line["step_ms"] for line in result.history[WARM_STEPS:]]
    step_ms = statistics.median(steady)
    windows = cfg["datamodule"]["batch_size_vis"] + cfg["datamodule"]["batch_size_lang"]
    frames = windows * cfg["datamodule"]["max_window_size"]
    print(f"[main] flagship policy, {n_params / 1e6:.2f}M params, batch {windows} windows x "
          f"{cfg['datamodule']['max_window_size']} frames, bf16 autocast", flush=True)
    print(f"[main] losses: " + ", ".join(f"{line['loss']:.4f}" for line in result.history), flush=True)
    print(f"[main] {moved}/{len(fresh)} parameter tensors moved; launches {launches}", flush=True)
    print(f"[main] step time {step_ms:.2f} ms (median of steps {WARM_STEPS}..{MAIN_STEPS - 1}, "
          f"spread {min(steady):.1f}-{max(steady):.1f} ms; step 0 "
          f"{result.history[0]['step_ms']:.1f} ms), {1e3 * windows / step_ms:.1f} windows/s = "
          f"{1e3 * frames / step_ms:.0f} frames/s, peak memory {peak_gib:.2f} GiB, on {card}",
          flush=True)
    return launches


def val_norm(cam: str) -> tuple:
    """(mean, std) of the flagship preset's val pipeline for ``cam``."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS

    norm = TRANSFORM_PRESETS[flagship_config()["datamodule"]["transforms"]]["val"][cam][-1]
    return norm["mean"], norm["std"]


def check_pad0(tag: str, imgs: torch.Tensor, mean, std) -> float:
    """The kernel at pad 0 with zero offsets against its plain version on
    ``imgs`` (N, H, W, 3) uint8 on the card, fp32 and bf16 out, tolerance 0;
    returns the largest error."""
    from hulc2_torch.ops import preprocess

    offsets = torch.zeros((imgs.shape[0], 2), dtype=torch.int32, device=imgs.device)
    err_max = 0.0
    for out_dtype in (torch.float32, torch.bfloat16):
        got = preprocess.random_shift_normalize(imgs, offsets, 0, mean, std, out_dtype)
        want = preprocess.shift_normalize_plain(imgs, offsets, 0, mean, std, out_dtype)
        torch.cuda.synchronize(imgs.device)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[{tag}] shift_normalize {'x'.join(map(str, imgs.shape))} pad 0 mean {mean} std "
              f"{std} {out_dtype}: max_abs_err {err:.3g} (tol 0)", flush=True)
        if err > 0 or got.shape != want.shape or not torch.isfinite(got.float()).all():
            fail(f"shift_normalize at pad 0 disagrees with its plain version on {tag} "
                 f"{tuple(imgs.shape)} {out_dtype}")
        err_max = max(err_max, err)
    return err_max


def phase_kernel_pad0(dev: torch.device) -> dict:
    """(a) The kernel at pad 0 with zero offsets, the val transform's
    scale/normalize with the preset's val mean and std, against its plain
    version bit for bit on the evaluations' 1 (interactive), 2, 4 and 8
    frames per camera and dispatch and on 32; then its device time at 8
    frames per camera."""
    from hulc2_torch.tools import bench_shift_normalize as bench

    err_max = 0.0
    for n in sorted({1, SINGLE_ENVS, SWEEP_ENVS, DISK_ENVS // DISK_COHORTS,
                     EVAL_ENVS // EVAL_COHORTS, 32}):
        for seed, (cam, hw) in enumerate((("rgb_static", 96), ("rgb_gripper", 64))):
            imgs, _ = bench.make_sets(n, hw, 0, 1, dev, seed)[0]
            err_max = max(err_max, check_pad0("pad0", imgs, *val_norm(cam)))
    k = EVAL_ENVS // EVAL_COHORTS
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": err_max}
    for seed, hw in enumerate((96, 64)):
        sets = bench.make_sets(k, hw, 0, bench.SETS, dev, seed)
        totals["ms"] += bench.device_ms(bench.rotating(bench.kernel_fn(0), sets))
        totals["plain_ms"] += bench.device_ms(bench.rotating(bench.plain_fn(0), sets))
        bound_ms, totals["bound_by"] = bench.bound(k, hw, 2)
        totals["bound_ms"] += bound_ms
    print(f"[pad0] per eval dispatch ({k} frames of 96x96 and of 64x64, bf16 out): kernel "
          f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, bound {totals['bound_ms']:.5f} "
          f"ms ({totals['bound_by']})", flush=True)
    return totals


def phase_renderer(dev: torch.device) -> None:
    """(b) The device renderer on the card against itself on the CPU."""
    from hulc2_torch.envs.render_torch import make_render_obs_fn
    from hulc2_torch.tools.profile_eval import perturbed_states

    scenes, robots = perturbed_states(32, seed=11)
    out = {}
    for d in (torch.device("cpu"), dev):
        fn = make_render_obs_fn(96, 64, with_depth=True, device=d)
        with torch.inference_mode():
            res = fn(torch.from_numpy(scenes).to(d), torch.from_numpy(robots).to(d))
        out[d.type] = {k: v.cpu() for k, v in res.items()}
    for key in ("rgb_static", "rgb_gripper"):
        diff = (out["cpu"][key].int() - out["cuda"][key].int()).abs()
        over, off = (diff > 1).float().mean().item(), (diff != 0).float().mean().item()
        print(f"[render] {key} 32 envs: max diff {diff.max().item()} LSB, share off {off:.3g}, "
              f"share off by more than 1: {over:.3g}", flush=True)
        if over > 0 or off >= 1e-4:
            fail(f"the card renderer's {key} leaves the bounds")
    depth_err = (out["cpu"]["depth_static"] - out["cuda"]["depth_static"]).abs().max().item()
    print(f"[render] depth_static: max abs err {depth_err:.3g} (tol 1e-5)", flush=True)
    if not depth_err < 1e-5:
        fail("the card renderer's depth leaves the bound")


def phase_policy_step(dev: torch.device) -> None:
    """(c) A small fp32 policy's fused render+policy step through the agent,
    card against CPU, same weights and draws, 40 steps with a replan at 0 and
    30 and one env restarted at step 17."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.models.hulc2 import PolicyDraws
    from hulc2_torch.tools.profile_eval import perturbed_states
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = flagship_config(SMALL_OVERRIDES)
    k, steps = 4, 40
    agents = {}
    for d in (torch.device("cpu"), dev):
        model = build_policy(cfg["model"], seed=5).to(d).eval()
        agents[d.type] = Hulc2Agent(model, cfg["datamodule"], n_envs=k,
                                    device_render={"static_hw": 96, "gripper_hw": 64})
    scenes, robots = perturbed_states(steps * k, seed=12)
    lang = tokenize(["open the drawer", "turn on the led", "push the red block to the left",
                     "stack the blocks"])
    mc = cfg["model"]
    g = torch.Generator().manual_seed(13)
    worst = 0.0
    for t in range(steps):
        if t == 17:
            for agent in agents.values():
                agent.reset_env_slot(2)
        obs = {"robot_obs": robots[t * k:(t + 1) * k], "scene_obs": scenes[t * k:(t + 1) * k]}
        draws = PolicyDraws(
            -torch.log(-torch.log(torch.rand((k, mc["distribution"]["category_size"],
                                              mc["distribution"]["class_size"]), generator=g))),
            1e-5 + (1 - 2e-5) * torch.rand((k, 1, 6, mc["action_decoder"]["n_mixtures"]), generator=g),
            1e-5 + (1 - 2e-5) * torch.rand((k, 1, 6), generator=g))
        acts = {}
        for name, agent in agents.items():
            d_draws = PolicyDraws(*(None if x is None else x.to(agent.device) for x in draws))
            acts[name] = agent.step_async(obs, {"lang": lang}, d_draws).cpu()
        err = (acts["cpu"] - acts["cuda"]).abs().max().item()
        worst = max(worst, err)
        if not torch.isfinite(acts["cuda"]).all() or err > 1e-3:
            fail(f"card and CPU policy steps disagree at step {t}: max abs err {err}")
    steps_cuda = agents["cuda"].carry.step.cpu().tolist()
    print(f"[policy_step] small fp32 policy, {k} envs, {steps} steps: actions max abs err "
          f"{worst:.3g} (tol 1e-3); step counters {steps_cuda}", flush=True)
    if steps_cuda != [steps, steps, steps - 17, steps]:
        fail(f"step counters {steps_cuda} after {steps} steps with env 2 restarted at 17")


def phase_eval(dev: torch.device, card: str) -> dict:
    """(d) The evaluation entry point at full flagship width; returns the
    launch counts of its run."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--synthetic", "--fake-env", "--device-render", "--n-envs", str(EVAL_ENVS),
        "--cohorts", str(EVAL_COHORTS), "--num-sequences", str(EVAL_CHAINS),
        "--ep-len", str(EVAL_EP_LEN), "--log-dir", str(EVAL_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    results_file = EVAL_DIR / "results.json"
    if not results_file.is_file():
        fail("the evaluation wrote no results.json")
    diag = json.loads((EVAL_DIR / "eval_diagnostics.json").read_text())
    chains = {}
    for r in diag["subtask_records"]:
        chains[r["chain"]] = chains.get(r["chain"], 0) + int(r["success"])
    if len(chains) != EVAL_CHAINS or not all(0 <= v <= 5 for v in chains.values()):
        fail(f"expected {EVAL_CHAINS} chain results in 0..5, got {chains}")
    if not 0.0 <= merged["synthetic"]["avg_seq_len"] <= 5.0:
        fail(f"avg_seq_len out of range: {merged['synthetic']['avg_seq_len']}")
    dispatches = diag["dispatches"]
    if launches["shift_normalize"] != 2 * dispatches:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in {dispatches} "
             f"dispatches, expected {2 * dispatches}")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    print(f"[eval] {EVAL_CHAINS} chains, {EVAL_ENVS} envs in {EVAL_COHORTS} cohorts, ep_len "
          f"{EVAL_EP_LEN}, device render, flagship width: avg_seq_len "
          f"{merged['synthetic']['avg_seq_len']:.3f}; {diag['total_env_steps']} env steps in "
          f"{diag['wall_clock_s']:.2f} s of the evaluator's loop = {rate:.1f} env-steps/s; "
          f"{dispatches} dispatches ({1e3 * diag['wall_clock_s'] / dispatches:.2f} ms each); "
          f"whole entry point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    print(f"[eval] host time, summed over cohorts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in diag["timings_s"].items()), flush=True)
    return launches


def phase_dataset() -> dict:
    """(e) The port's generator writes a small expert dataset (96/64 px, token
    annotations) from scratch; returns its frame counts."""
    import numpy as np

    from hulc2_torch.tools import make_expert_dataset

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    make_expert_dataset.main([str(DATA_DIR), "--episodes", str(DATA_EPISODES),
                              "--tasks-per-episode", str(DATA_TASKS), "--val-episodes", "1",
                              "--val-tasks-per-episode", str(DATA_VAL_TASKS), "--lang-tokens",
                              "--holdout-paraphrases", "4", "--seed", "0"])
    seconds = time.perf_counter() - t0
    frames = {}
    for split in ("training", "validation"):
        ids = np.load(DATA_DIR / split / "ep_start_end_ids.npy")
        frames[split] = int(sum(e - s + 1 for s, e in ids))
    frame_bytes = 96 * 96 * 3 + 64 * 64 * 3
    print(f"[dataset] {DATA_EPISODES} training episodes of {DATA_TASKS} tasks, 1 validation "
          f"episode of {DATA_VAL_TASKS}: {frames['training']} + {frames['validation']} frames, "
          f"training store {frames['training'] * frame_bytes} bytes of images, written in "
          f"{seconds:.1f} s", flush=True)
    return frames


def phase_loader(dev: torch.device) -> None:
    """(f) Device-store batches on the card, through the prefetcher, against
    the same plan assembled on the host from the RAM cache
    (``device_store.host_fused_batches``), bit for bit, for the first batches
    of two epochs."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_store import host_fused_batches
    from hulc2_torch.data.loader import DevicePrefetcher

    dm_cfg = flagship_config([f"datamodule.root_data_dir={DATA_DIR}"])["datamodule"]
    host = Hulc2DataModule(dm_cfg, seed=42, device="cpu")
    card = Hulc2DataModule(dm_cfg, seed=42, device=dev)
    host.setup()
    card.setup()
    loader = card.fused_train_iter()
    compared = 0
    for epoch in range(2):
        it = DevicePrefetcher(loader, dev)
        plain = host_fused_batches(host.datasets["vis_training"], host.datasets["lang_training"],
                                   dm_cfg["batch_size_vis"], dm_cfg["batch_size_lang"], 42, epoch)
        for b, (got, want) in enumerate(zip(it, plain)):
            if b == LOADER_BATCHES:
                break
            for k, w in want.items():
                g = got[k].cpu().numpy()
                if g.dtype != w.dtype or g.shape != w.shape or not (g == w).all():
                    fail(f"device-store batch {b} of epoch {epoch} differs from the host plan on {k}")
            compared += 1
        it.close()
    print(f"[loader] {compared} device-store batches of 2 epochs equal the host plan bit for bit "
          f"(tol 0; {len(loader)} batches per epoch, {card.val_batches()} val batches)", flush=True)
    return host


def phase_val_kernel(dev: torch.device, dm) -> float:
    """(g) The kernel at the validation step's shapes: each camera of each
    modality of the first validation batch (``dm.val_iter``, the batches the
    trainer's val steps read), moved to the card, through the kernel and its
    plain version with the val pipelines' mean and std, tolerance 0."""
    batches = dm.val_iter()
    batch = next(batches)
    batches.close()
    err_max = 0.0
    for m, window in batch.items():
        for cam in dm.cfg["observation_space"]["rgb_obs"]:
            b, s, h, w, c = window[cam].shape
            imgs = torch.from_numpy(window[cam]).to(dev).reshape(b * s, h, w, c)
            err_max = max(err_max, check_pad0(f"val {m} {cam}", imgs, *val_norm(cam)))
    return err_max


def phase_disk_train(dev: torch.device, card: str) -> tuple:
    """(g) ``python -m hulc2_torch.training`` from the dataset at full flagship
    width: one epoch, then the same command resumed to a second; each run
    with the launch counts reset just before and read just after."""
    from hulc2_torch import kernels, training

    shutil.rmtree(DISK_RUN, ignore_errors=True)
    argv = ["--run-dir", str(DISK_RUN), "--device", "cuda", f"datamodule.root_data_dir={DATA_DIR}",
            f"trainer.limit_train_batches={DISK_STEPS}", f"trainer.limit_val_batches={DISK_VAL}",
            "trainer.log_every_n_steps=1"]
    results, launches = [], []
    for epochs in (1, 2):
        kernels.reset_launch_counts()
        results.append(training.main(argv + ["--max-epochs", str(epochs)]))
        torch.cuda.synchronize(dev)
        launches.append(dict(kernels.LAUNCHES))
    first, second = results
    if first.resumed_from is not None or second.resumed_from != DISK_STEPS:
        fail(f"the second run resumed from {second.resumed_from}, expected {DISK_STEPS}")
    if (first.step, second.step) != (DISK_STEPS, 2 * DISK_STEPS):
        fail(f"runs ended at steps {first.step}, {second.step}")
    steps = [DISK_STEPS, 2 * DISK_STEPS]
    ckpts = sorted(int(p.stem) for p in (DISK_RUN / "saved_models").glob("*.pt"))
    if ckpts != steps or not (DISK_RUN / "config.json").is_file():
        fail(f"checkpoints {ckpts} (expected {steps}) or config.json missing")
    for r in results:
        if len(r.history) != DISK_STEPS or len(r.val_history) != 1:
            fail(f"{len(r.history)} train lines and {len(r.val_history)} val lines logged")
        bad = [k for line in r.history + r.val_history for k, v in line.items()
               if not math.isfinite(v)]
        if bad:
            fail(f"non-finite metrics: {sorted(set(bad))}")
    for n in launches:
        if n["shift_normalize"] != 2 * DISK_STEPS + 4 * DISK_VAL:
            fail(f"shift_normalize launched {n['shift_normalize']} times for {DISK_STEPS} train "
                 f"and {DISK_VAL} val steps, expected {2 * DISK_STEPS + 4 * DISK_VAL}")
    steady = [(t, w) for r in results for t, w in zip(r.step_ms[WARM_STEPS:], r.wait_ms[WARM_STEPS:])]
    step_ms = statistics.median(t for t, _ in steady)
    wait_ms = statistics.median(w for _, w in steady)
    val = second.val_history[0]
    print(f"[disk] losses: " + ", ".join(f"{line['train/loss']:.4f}" for r in results
                                         for line in r.history), flush=True)
    print(f"[disk] val after epoch 2: " + ", ".join(
        f"{k[4:]} {v:.4f}" for k, v in val.items() if k.startswith("val/")), flush=True)
    print(f"[disk] 2 runs x {DISK_STEPS} steps + {DISK_VAL} val batches, resumed from step "
          f"{second.resumed_from}; launches {launches}; step time {step_ms:.2f} ms (median of "
          f"{len(steady)} steps after {WARM_STEPS} warm-up steps per run, each ending in a fetch "
          f"of its metrics), of which waiting on the prefetcher {wait_ms:.3f} ms "
          f"({100 * wait_ms / step_ms:.1f}%); device store {second.store_nbytes} bytes resident, "
          f"uploaded in {first.store_upload_s:.3f} s and {second.store_upload_s:.3f} s; on {card}",
          flush=True)
    total = {k: sum(n[k] for n in launches) for k in launches[0]}
    return second.model, total


def phase_disk_eval(dev: torch.device, card: str, trained) -> dict:
    """(h) ``evaluate_policy --train-dir`` on the trained run: the loaded
    parameters equal the newest checkpoint's and the trained model's, and
    the kernel launches twice per dispatch."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.evaluation.loading import load_policy

    model, _, step = load_policy(DISK_RUN)
    saved = torch.load(DISK_RUN / "saved_models" / f"{2 * DISK_STEPS}.pt", map_location="cpu",
                       weights_only=True)["model"]
    mine = {k: v.cpu() for k, v in trained.state_dict().items()}
    loaded = model.state_dict()
    if step != 2 * DISK_STEPS or not all(torch.equal(loaded[k], saved[k]) and torch.equal(loaded[k], mine[k])
                                         for k in saved):
        fail("the evaluation's parameters differ from the checkpoint's")
    log_dir = DISK_RUN / "evaluation"
    shutil.rmtree(log_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--fake-env", "--device-render", "--n-envs", str(DISK_ENVS),
        "--cohorts", str(DISK_COHORTS), "--num-sequences", str(DISK_CHAINS), "--ep-len",
        str(EVAL_EP_LEN), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not (log_dir / "results.json").is_file():
        fail("the evaluation of the trained run wrote no results.json")
    diag = json.loads((log_dir / "eval_diagnostics.json").read_text())
    if not 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0 or \
            len({r["chain"] for r in diag["subtask_records"]}) != DISK_CHAINS:
        fail(f"unexpected results: {merged['latest']}")
    if launches["shift_normalize"] != 2 * diag["dispatches"]:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{diag['dispatches']} dispatches")
    print(f"[disk_eval] step {step} of {DISK_RUN.name}: {len(saved)} parameter tensors equal the "
          f"checkpoint's; {DISK_CHAINS} chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts: "
          f"avg_seq_len {merged['latest']['avg_seq_len']:.3f}; {diag['total_env_steps']} env "
          f"steps in {diag['wall_clock_s']:.2f} s, {diag['dispatches']} dispatches; whole entry "
          f"point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    return launches


def phase_detector(dev: torch.device) -> None:
    """(i) The full-width detector in fp32 on the card against the CPU, same
    weights, 8 frames of 96x96 at 224 and 8 validation sentences."""
    import numpy as np

    from hulc2_torch.affordance.train_affordance import build_detector
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.ops.preprocess import resize
    from hulc2_torch.tools.annotations import VALIDATION_BANK
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = affordance_config()
    frames = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (AFF_FRAMES, 96, 96, 3), dtype=np.uint8))
    toks = torch.from_numpy(tokenize(list(VALIDATION_BANK.values())[:AFF_FRAMES]))
    out = {}
    for d in (torch.device("cpu"), dev):
        model = build_detector(cfg["aff_detection"], seed=22).to(d).eval()
        with torch.no_grad():
            imgs = resize(frames.to(d).float() / 255.0, 224, 224)
            o = model(imgs, toks.to(d))
            px, _, _ = model.predict_from_output(o, torch.zeros((AFF_FRAMES, 1), device=d), None)
        out[d.type] = {"imgs": imgs.cpu(), "logits": o.aff_logits.cpu(), "mu": o.depth_pred[0].cpu(),
                       "sigma": o.depth_pred[1].cpu(), "px": px.cpu()}
    cpu, card = out["cpu"], out["cuda"]
    resize_err = (cpu["imgs"] - card["imgs"]).abs().max().item()
    tol = 1e-3 * max(1.0, cpu["logits"].abs().max().item())
    errs = {k: (cpu[k] - card[k]).abs().max().item() for k in ("logits", "mu", "sigma")}
    top2 = cpu["logits"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = (cpu["px"] == card["px"]).all(dim=-1)
    print(f"[detector] rn18_tokens_pixel fp32, {AFF_FRAMES} frames 96->224: resize max abs err "
          f"{resize_err:.3g} (tol 1e-5); " + ", ".join(f"{k} max abs err {v:.3g}" for k, v in
                                                        errs.items())
          + f" (tol {tol:.3g}); pixels equal {int(same.sum())}/{AFF_FRAMES}, "
          f"{int(clear.sum())} with a top-two margin over {2 * tol:.3g}", flush=True)
    if resize_err > 1e-5 or max(errs.values()) > tol:
        fail(f"the detector on the card disagrees with the CPU: resize {resize_err}, {errs}")
    if not bool(same[clear].all()):
        fail("the detector's argmax pixel differs where the logits' margin is clear")


def phase_mining() -> dict:
    """(j) Labels mined from (e)'s dataset; returns the labels per split."""
    from hulc2_torch.affordance import dataset_creation

    shutil.rmtree(AFF_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    info = dataset_creation.main([str(DATA_DIR), "--out-dir", str(AFF_DATA),
                                  "--holdout-paraphrases", "4"])
    seconds = time.perf_counter() - t0
    labels = {split: sum(len(c["static_cam"]) for c in info[split].values())
              for split in ("training", "validation")}
    print(f"[mining] {labels['training']} training and {labels['validation']} validation labels "
          f"mined in {seconds:.1f} s; depth norm {info['norm_values']['depth']['static_cam']}",
          flush=True)
    if not all(labels.values()):
        fail(f"label mining found no labels in a split: {labels}")
    return labels


def phase_aff_train(dev: torch.device, card: str, labels: dict, tag: str = "aff_train",
                    run_dir: Path = AFF_RUN, data_dir: Path = AFF_DATA,
                    group: str = "rn18_tokens_pixel", steps: int = AFF_STEPS):
    """(k) The detector trained on the mined labels at batch 32 ((ah): the
    ``group`` on ``data_dir``'s labels for ``steps`` steps); returns the
    trained model."""
    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.configs.affordance import affordance_config

    cfg = affordance_config([f"aff_detection={group}"])
    per_epoch = labels["training"] // cfg["batch_size"]
    if per_epoch < 1:
        fail(f"{labels['training']} training labels make no batch of {cfg['batch_size']}")
    epochs = -(-steps // per_epoch)
    shutil.rmtree(run_dir, ignore_errors=True)
    result = train_affordance.main(["--run-dir", str(run_dir), "--device", "cuda", "--max-epochs",
                                    str(epochs), "--max-steps", str(steps),
                                    f"aff_detection={group}",
                                    f"aff_detection.dataset.data_dir={data_dir}"])
    torch.cuda.synchronize(dev)
    if result.step != steps or len(result.history) != steps or len(result.val_history) != epochs:
        fail(f"{group}: {result.step} steps, {len(result.history)} train and "
             f"{len(result.val_history)} val lines, expected {steps} steps and {epochs} validations")
    bad = sorted({k for line in result.history + result.val_history for k, v in line.items()
                  if not math.isfinite(v)})
    if bad or "val/px_dist_err" not in result.val_history[-1]:
        fail(f"non-finite or missing metrics: {bad}")
    run_cfg = json.loads((run_dir / "config.json").read_text())
    if set(run_cfg.get("depth_norm", {})) != {"mean", "std"}:
        fail(f"{group}: config.json holds no depth_norm")
    if not (run_dir / "saved_models" / f"{steps}.pt").is_file():
        fail(f"{group}: no checkpoint of the last step")
    fresh = train_affordance.build_detector(cfg["aff_detection"], cfg["seed"]).state_dict()
    trained = {k: v.cpu() for k, v in result.model.state_dict().items()}
    encoder = [k for k in fresh if k.startswith("aff_stream.encoder.")]
    if not encoder or not all(torch.equal(fresh[k], trained[k]) for k in encoder):
        fail("the frozen encoder's parameters or statistics changed")
    trainable = [n for n, p in result.model.named_parameters() if p.requires_grad]
    moved = [n for n in trainable if not torch.equal(fresh[n], trained[n])]
    tower = result.model.text_tower
    if len(moved) < 0.9 * len(trainable) or not any(n.startswith("aff_stream.decoder.") for n in moved) \
            or tower != any(n.startswith("lang_tower.") for n in moved):
        fail(f"{group}: only {len(moved)} of {len(trainable)} trainable tensors moved")
    steady = [line["step_ms"] for line in result.history[WARM_STEPS:]]
    val = result.val_history[-1]
    print(f"[{tag}] {group}: {steps} steps at batch {cfg['batch_size']} over {epochs} epochs of "
          f"{per_epoch}: losses " + ", ".join(f"{line['total_loss']:.4f}" for line in result.history),
          flush=True)
    print(f"[{tag}] val: " + ", ".join(f"{k[4:]} {v:.4f}" for k, v in val.items()
                                        if k.startswith("val/")), flush=True)
    print(f"[{tag}] {len(moved)}/{len(trainable)} trainable tensors moved, {len(encoder)} encoder "
          f"tensors bit-equal; step time {statistics.median(steady):.2f} ms (median of steps "
          f"{WARM_STEPS}..{steps - 1}, spread {min(steady):.1f}-{max(steady):.1f} ms, host "
          f"clock per step incl. the batch's copy and a fetch of its metrics; step 0 "
          f"{result.history[0]['step_ms']:.1f} ms); on {card}", flush=True)
    return result.model


def phase_hier_eval(dev: torch.device, card: str, trained, tag: str = "hier_eval",
                    policy_run: Path = DISK_RUN, policy_step: int = 2 * DISK_STEPS,
                    aff_run: Path = AFF_RUN, aff_steps: int = AFF_STEPS,
                    log_dir: Path = HIER_DIR, extra=()) -> dict:
    """(l) The hierarchical eval of the disk run with (k)'s detector ((ah):
    ``policy_run`` with ``aff_run``'s detector and ``extra`` flags); returns
    the launch counts of its run, its env-steps/s and ``aff_flush_s`` per
    prediction."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.evaluation.loading import load_affordance

    pred = load_affordance(aff_run, device=dev)
    saved = torch.load(aff_run / "saved_models" / f"{aff_steps}.pt", map_location="cpu",
                       weights_only=True)["model"]
    loaded = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    mine = {k: v.cpu() for k, v in trained.state_dict().items()}
    if not all(torch.equal(loaded[k], saved[k]) and torch.equal(loaded[k], mine[k]) for k in saved):
        fail("the evaluation's detector differs from the checkpoint")
    del pred
    shutil.rmtree(log_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(policy_run), "--aff-train-dir", str(aff_run), *extra, "--fake-env",
        "--device-render", "--n-envs", str(DISK_ENVS), "--cohorts", str(DISK_COHORTS),
        "--num-sequences", str(DISK_CHAINS), "--ep-len", str(EVAL_EP_LEN), "--log-dir",
        str(log_dir), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not (log_dir / "results.json").is_file():
        fail(f"the hierarchical evaluation of {aff_run.name} wrote no results.json")
    diag = json.loads((log_dir / "eval_diagnostics.json").read_text())
    h, records = diag["hierarchical"], diag["subtask_records"]
    if not 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0 or len({r["chain"] for r in records}) != DISK_CHAINS:
        fail(f"unexpected results: {merged['latest']}")
    if h["aff_predictions"] != len(records) or h["approaches"] < 1:
        fail(f"{h} for {len(records)} subtask starts")
    if h["approach_steps"] != sum(r["approach_steps"] for r in records):
        fail("the approach steps of the records do not add up")
    if launches["shift_normalize"] != 2 * diag["dispatches"]:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{diag['dispatches']} dispatches")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    flush_ms = 1e3 * diag["timings_s"]["aff_flush_s"] / h["aff_predictions"]
    print(f"[{tag}] step {policy_step} of {policy_run.name} with step {aff_steps} of "
          f"{aff_run.name} ({len(saved)} detector tensors equal the checkpoint's): {DISK_CHAINS} "
          f"chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts, avg_seq_len "
          f"{merged['latest']['avg_seq_len']:.3f}; {h['aff_predictions']} affordance predictions, "
          f"{h['approaches']} approaches, {h['approach_steps']} approach steps; "
          f"{diag['total_env_steps']} env steps in {diag['wall_clock_s']:.2f} s = {rate:.1f} "
          f"env-steps/s, {diag['dispatches']} dispatches; aff_flush_s {flush_ms:.2f} ms per "
          f"prediction; whole entry point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    print(f"[{tag}] host time, summed over cohorts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in diag["timings_s"].items()), flush=True)
    return {"launches": launches, "rate": rate, "flush_ms": flush_ms}


def eval_diag(log_dir: Path, what: str) -> dict:
    """``eval_diagnostics.json`` of an evaluation that must have written
    ``results.json`` beside it."""
    if not (log_dir / "results.json").is_file():
        fail(f"the {what} wrote no results.json")
    return json.loads((log_dir / "eval_diagnostics.json").read_text())


def check_launches(launches: dict, n: int, what: str, per_dispatch: int = 2) -> None:
    if launches["shift_normalize"] != per_dispatch * n:
        fail(f"{what}: shift_normalize launched {launches['shift_normalize']} times, expected "
             f"{per_dispatch} x {n}")


def phase_paraphrase(dev: torch.device, card: str) -> dict:
    """(m) The hierarchical eval of (l) under the paraphrase protocol: the
    policy and the detector get each task's held-out sentences."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    shutil.rmtree(PARA_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--aff-train-dir", str(AFF_RUN), "--paraphrase-eval",
        "--fake-env", "--device-render", "--n-envs", str(DISK_ENVS), "--cohorts",
        str(DISK_COHORTS), "--num-sequences", str(DISK_CHAINS), "--ep-len", str(EVAL_EP_LEN),
        "--log-dir", str(PARA_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    diag = eval_diag(PARA_DIR, "paraphrase evaluation")
    h, records = diag["hierarchical"], diag["subtask_records"]
    if diag["paraphrase_eval"] is not True or len({r["chain"] for r in records}) != DISK_CHAINS:
        fail(f"paraphrase eval: {diag['paraphrase_eval']}, {merged['latest']}")
    if h["aff_predictions"] != len(records):
        fail(f"{h['aff_predictions']} affordance predictions for {len(records)} subtask starts")
    check_launches(launches, diag["dispatches"], "paraphrase eval")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    flush_ms = 1e3 * diag["timings_s"]["aff_flush_s"] / max(h["aff_predictions"], 1)
    print(f"[para_eval] held-out paraphrases, step {2 * DISK_STEPS} of {DISK_RUN.name} with "
          f"{AFF_RUN.name}: {DISK_CHAINS} chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts, "
          f"avg_seq_len {merged['latest']['avg_seq_len']:.3f}; {h['aff_predictions']} "
          f"predictions, {h['approaches']} approaches, {h['approach_steps']} approach steps; "
          f"{diag['total_env_steps']} env steps in {diag['wall_clock_s']:.2f} s = {rate:.1f} "
          f"env-steps/s, {diag['dispatches']} dispatches; aff_flush_s {flush_ms:.2f} ms per "
          f"prediction; whole entry point {wall_s:.1f} s; launches {launches}; on {card}",
          flush=True)
    return launches


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_sweep(dev: torch.device, card: str) -> dict:
    """(n) ``evaluate_policy --all-checkpoints`` over the disk run's two
    steps: both in one results.json, "best" the higher avg_seq_len, two
    launches per dispatch of each step (read from each step's log line)."""
    import re

    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    log = logging.getLogger("hulc2_torch.evaluation.evaluate_policy")
    handler, level = _Messages(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        evaluate_policy.main([
            "--train-dir", str(DISK_RUN), "--all-checkpoints", "--fake-env", "--device-render",
            "--n-envs", str(SWEEP_ENVS), "--num-sequences", str(SWEEP_CHAINS), "--ep-len",
            str(EVAL_EP_LEN), "--log-dir", str(SWEEP_DIR), "--device", "cuda"])
        torch.cuda.synchronize(dev)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    eval_diag(SWEEP_DIR, "sweep")
    results = json.loads((SWEEP_DIR / "results.json").read_text())
    steps = [str(DISK_STEPS), str(2 * DISK_STEPS)]
    if sorted(k for k in results if k != "best") != sorted(steps):
        fail(f"the sweep's results.json holds {sorted(results)}, expected {steps} and best")
    top = max(results[s]["avg_seq_len"] for s in steps)
    best = results["best"]
    if best["avg_seq_len"] != top or results[best["epoch"]]["avg_seq_len"] != top:
        fail(f"best is {best['epoch']} at {best['avg_seq_len']}, the top avg_seq_len is {top}")
    runs = [re.search(r"(\d+) env steps in ([\d.]+) s .*, (\d+) dispatches", m)
            for m in handler.messages if m.startswith("evaluation:")]
    if len(runs) != len(steps) or None in runs:
        fail(f"expected one evaluation line per step, got {handler.messages}")
    dispatches = sum(int(m.group(3)) for m in runs)
    check_launches(launches, dispatches, "sweep")
    env_steps = sum(int(m.group(1)) for m in runs)
    loop_s = sum(float(m.group(2)) for m in runs)
    print(f"[sweep] --all-checkpoints over steps {steps} of {DISK_RUN.name}, {SWEEP_CHAINS} "
          f"chains each on {SWEEP_ENVS} envs: avg_seq_len " + ", ".join(
              f"{s} {results[s]['avg_seq_len']:.3f}" for s in steps)
          + f", best {best['epoch']}; {env_steps} env steps in {loop_s:.1f} s of the loops = "
          f"{env_steps / loop_s:.1f} env-steps/s, {dispatches} dispatches; whole sweep "
          f"{wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    return launches


def phase_single_step(dev: torch.device, card: str) -> dict:
    """(o) ``evaluate_policy --single-step --dataset-path`` on the disk run:
    one job per oracle-detected validation window, one subtask each."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy, harness

    jobs = harness.dataset_singlestep_sequences(DATA_DIR / "validation")
    shutil.rmtree(SINGLE_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--single-step", "--dataset-path", str(DATA_DIR),
        "--fake-env", "--device-render", "--n-envs", str(SINGLE_ENVS), "--ep-len",
        str(EVAL_EP_LEN), "--log-dir", str(SINGLE_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    diag = eval_diag(SINGLE_DIR, "single-step evaluation")
    records = diag["subtask_records"]
    if not jobs or diag["num_sequences"] != len(jobs) or len(records) != len(jobs) \
            or sorted(r["chain"] for r in records) != list(range(len(jobs))) \
            or any(r["pos"] != 0 for r in records):
        fail(f"{len(jobs)} single-step jobs, {diag['num_sequences']} evaluated, records "
             f"{[(r['chain'], r['pos']) for r in records]}")
    check_launches(launches, diag["dispatches"], "single-step eval")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    print(f"[single_step] {len(jobs)} jobs from the validation split "
          f"({', '.join(c[0] for _, c in jobs)}), {SINGLE_ENVS} envs: SR "
          f"{merged['latest']['chain_sr'][1]:.3f}; {diag['total_env_steps']} env steps in "
          f"{diag['wall_clock_s']:.2f} s = {rate:.1f} env-steps/s, {diag['dispatches']} "
          f"dispatches; whole entry point {wall_s:.1f} s; launches {launches}; on {card}",
          flush=True)
    return launches


def phase_interactive(dev: torch.device, card: str) -> dict:
    """(p) ``interactive.main`` on the disk run with two instructions on a
    StringIO stdin, one of them from the offline planner."""
    import contextlib
    import io

    from hulc2_torch import kernels
    from hulc2_torch.evaluation import interactive
    from hulc2_torch.evaluation.llm_planning import LLMPlanner

    planned = LLMPlanner().instructions("please turn on the led")
    if not planned:
        fail("the keyword planner planned nothing for 'please turn on the led'")
    instructions = ["open the drawer", planned[0]]
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        verdicts = interactive.main(["--train-dir", str(DISK_RUN), "--fake-env", "--ep-len",
                                     str(INTERACTIVE_EP_LEN), "--device", "cuda"],
                                    stdin=io.StringIO("\n".join(instructions) + "\n"))
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("-> ")]
    if len(lines) != len(instructions) or [v[0] for v in verdicts] != instructions:
        fail(f"expected one verdict line per instruction, got {lines}")
    steps = sum(v[2] for v in verdicts)
    check_launches(launches, steps, "interactive")
    print(f"[interactive] {instructions} -> {lines}; {steps} env steps in {wall_s:.2f} s of the "
          f"entry point = {steps / wall_s:.1f} env-steps/s (one env, host render, one fetch per "
          f"step, the policy's load included); launches {launches}; on {card}", flush=True)
    return launches


def phase_kernel_rand_shift(dev: torch.device) -> dict:
    """(q) The kernel at ``cfg_low_level``'s train shapes against its plain
    version, bit for bit, fp32 and bf16; then its device time, the plain
    version's and a bf16 cast's, per launch, beside the bytes bound."""
    from hulc2_torch.ops import preprocess
    from hulc2_torch.tools import bench_shift_normalize as bench

    totals = {"ms": 0.0, "plain_ms": 0.0, "cast_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for seed, (cam, (n, hw, pad)) in enumerate(bench.RAND_SHIFT_SHAPES.items()):
        sets = bench.make_sets(n, hw, pad, bench.SETS, dev, 30 + seed)
        imgs, offsets = sets[0]
        for out_dtype in (torch.float32, torch.bfloat16):
            got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            torch.cuda.synchronize(dev)
            err = (got.float() - want.float()).abs().max().item()
            print(f"[rand_shift] shift_normalize {cam} {n}x{hw}x{hw}x3 pad {pad} {out_dtype}: "
                  f"max_abs_err {err:.3g} (tol 0)", flush=True)
            if err > 0 or got.shape != want.shape or not torch.isfinite(got.float()).all():
                fail(f"shift_normalize disagrees with its plain version at {cam} {hw}px {out_dtype}")
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
        ms = bench.device_ms(bench.rotating(bench.kernel_fn(pad), sets))
        plain_ms = bench.device_ms(bench.rotating(bench.plain_fn(pad), sets))
        cast_ms = bench.device_ms(bench.rotating(bench.cast_fn, sets))
        bound_ms, totals["bound_by"] = bench.bound(n, hw, 2)
        print(f"[rand_shift] {cam} bf16, device time per launch: kernel {ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of its {bound_ms:.4f} ms bound, {totals['bound_by']}); "
              f"plain {plain_ms:.4f} ms; bf16 cast of the same bytes {cast_ms:.4f} ms", flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("cast_ms", cast_ms), ("bound_ms", bound_ms)):
            totals[k] += v
        del sets, imgs, offsets, got, want
    print(f"[rand_shift] per cfg_low_level train step (both cameras): kernel {totals['ms']:.4f} ms, "
          f"bound {totals['bound_ms']:.4f} ms ({100 * totals['bound_ms'] / totals['ms']:.1f}%), "
          f"plain {totals['plain_ms']:.4f} ms", flush=True)
    return totals


def phase_low_dataset() -> dict:
    """(r) The port's generator writes a 200/84 px dataset with hash sentence
    embeddings; returns its frame counts."""
    import numpy as np

    from hulc2_torch.tools import make_expert_dataset

    shutil.rmtree(LOW_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    make_expert_dataset.main([str(LOW_DATA), "--episodes", str(LOW_EPISODES), "--tasks-per-episode",
                              str(LOW_TASKS), "--val-episodes", "1", "--val-tasks-per-episode",
                              str(LOW_VAL_TASKS), "--static-hw", "200", "--gripper-hw", "84",
                              "--seed", "0"])
    seconds = time.perf_counter() - t0
    frames = {split: int(sum(e - s + 1 for s, e in np.load(LOW_DATA / split / "ep_start_end_ids.npy")))
              for split in ("training", "validation")}
    table = np.load(LOW_DATA / "validation" / "lang_annotations" / "embeddings.npy",
                    allow_pickle=True).item()
    dims = {np.asarray(v["emb"]).squeeze().shape for v in table.values()}
    print(f"[low_dataset] {LOW_EPISODES} training episodes of {LOW_TASKS} tasks, 1 validation "
          f"episode of {LOW_VAL_TASKS} at 200/84 px: {frames['training']} + {frames['validation']} "
          f"frames written in {seconds:.1f} s ({sum(frames.values()) / seconds:.1f} frames/s); "
          f"goal table of {len(table)} tasks, embeddings {dims}", flush=True)
    if dims != {(384,)}:
        fail(f"the dataset's goal table holds embeddings of shapes {dims}, expected (384,)")
    return frames


def phase_low_reference(dev: torch.device) -> None:
    """(s) Two fp32 train steps of a small ``cfg_low_level`` policy on the card
    and on the CPU, same weights, one fixed batch of the host loader from (r),
    same offsets and Gumbel draws; the card runs the kernel, the CPU its
    plain version."""
    import hulc2_torch.configs  # noqa: F401  (registers the config groups)
    from hulc2_torch.core.config import compose
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = compose("cfg_low_level", LOW_SMALL + [f"datamodule.root_data_dir={LOW_DATA}"])
    dm_cfg, mc = cfg["datamodule"], cfg["model"]
    dm = Hulc2DataModule(dm_cfg, seed=cfg["seed"], device="cpu")
    dm.setup()
    raw = {k: torch.from_numpy(v) for k, v in next(iter(dm.fused_train_iter())).items()}
    n = raw["actions"].shape[0] * raw["actions"].shape[1]
    g = torch.Generator().manual_seed(4)
    draws = [({cam: torch.randint(0, 2 * pad + 1, (n, 2), generator=g, dtype=torch.int32)
               for cam, pad in (("rgb_static", 10), ("rgb_gripper", 4))},
              -torch.log(-torch.log(torch.rand((raw["actions"].shape[0], 32, 32), generator=g))))
             for _ in range(2)]
    losses = {}
    for device in (torch.device("cpu"), dev):
        model = build_policy(mc, gripper_hw=84, seed=5).to(device)
        tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                                  dm_cfg["transforms"], stats=dm.stats["training"])
        step = make_train_step(model, make_optimizer(model.parameters(), mc["optimizer"]), tf,
                               cfg["loss"]["clip_auxiliary_loss_beta"],
                               aux_betas_from_loss_cfg(cfg["loss"]), device=device)
        losses[device.type] = [step({k: v.to(device) for k, v in raw.items()}, None, 0.01,
                                    gumbel=gumbel.to(device),  # the shift is op 1
                                    draws={k: {1: v.to(device)} for k, v in off.items()}
                                    )["loss"].item() for off, gumbel in draws]
    print(f"[low_reference] small fp32 cfg_low_level policy (no text tower, no task head), "
          f"2 train steps on a {tuple(raw['rgb_static'].shape)} host-loader batch with 384-d "
          f"embeddings: cpu {losses['cpu']} cuda {losses['cuda']} (rel tol 1e-3)", flush=True)
    for a, b in zip(losses["cpu"], losses["cuda"]):
        if not math.isclose(a, b, rel_tol=1e-3, abs_tol=1e-4):
            fail(f"card and CPU cfg_low_level losses disagree: {losses}")


def phase_low_train(dev: torch.device, card: str, tag: str = "low_train",
                    run_dir: Path = LOW_RUN, root: str = "cfg_low_level", overrides=(),
                    steps: int = LOW_STEPS, val: int = LOW_VAL, per_step: int = 2,
                    per_val: int = 4, child_loader: bool = False) -> dict:
    """(s) ``python -m hulc2_torch.training --config-name cfg_low_level`` from
    (r)'s dataset at full width through the host loader (and (v), (w), (y),
    (z), (aa): the same entry point for another root and overrides, whose
    train and val steps launch the kernel ``per_step`` and ``per_val``
    times; with ``child_loader`` the training batches are read in the process
    loader's child, where no read is seen here); returns the launch counts
    of the run, its median step and loader wait."""
    from hulc2_torch import kernels, training
    from hulc2_torch.data import native_loader

    shutil.rmtree(run_dir, ignore_errors=True)
    reads = []
    load_frames_into = native_loader.load_frames_into

    def counting(paths, key, out, n_threads=8):
        reads.append(len(paths))
        return load_frames_into(paths, key, out, n_threads)

    native_loader.load_frames_into = counting
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = training.main([
            "--config-name", root, "--run-dir", str(run_dir), "--device", "cuda",
            "--max-epochs", "1", f"datamodule.root_data_dir={LOW_DATA}",
            f"trainer.limit_train_batches={steps}", f"trainer.limit_val_batches={val}",
            "trainer.log_every_n_steps=1", *overrides])
        torch.cuda.synchronize(dev)
    finally:
        native_loader.load_frames_into = load_frames_into
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    what = f"{root} {' '.join(overrides)}".strip()
    if result.step != steps or len(result.history) != steps or len(result.val_history) != 1:
        fail(f"{what}: {result.step} steps, {len(result.history)} train and "
             f"{len(result.val_history)} val lines, expected {steps} and 1")
    bad = sorted({k for line in result.history + result.val_history for k, v in line.items()
                  if not math.isfinite(v)})
    if bad:
        fail(f"non-finite metrics of {what}: {bad}")
    if not (run_dir / "saved_models" / f"{steps}.pt").is_file():
        fail(f"no checkpoint of the {what} run")
    if result.store_nbytes is not None or result.model.lang_net is not None:
        fail(f"the {what} run used a device store or built a language network")
    if not reads and not child_loader:
        fail(f"the {what} run read no frame through the native loader")
    want = per_step * steps + per_val * val
    if launches["shift_normalize"] != want:
        fail(f"shift_normalize launched {launches['shift_normalize']} times for {steps} train "
             f"and {val} val steps of {what}, expected {want}")
    steady_ms = statistics.median(result.step_ms[WARM_STEPS:])
    wait_ms = statistics.median(result.wait_ms[WARM_STEPS:])
    cfg = json.loads((run_dir / "config.json").read_text())
    dm = cfg["datamodule"]
    obs = dm["observation_space"]
    mods = [m for m in ("vis", "lang") if (dm.get("datasets") or {}).get(m, True)]
    windows = sum(dm[f"batch_size_{m}"] for m in mods)
    frame_bytes = {"rgb_static": 200 * 200 * 3, "rgb_gripper": 84 * 84 * 3,
                   "depth_static": 200 * 200 * 2}  # depth stored float16
    frames = (dm["frame_skip"] or {}).get("effective_max_ws", dm["max_window_size"])
    batch_bytes = windows * frames * sum(frame_bytes[k] for k in obs["rgb_obs"] + obs["depth_obs"])
    print(f"[{tag}] {what} at full width, batch {windows} windows x "
          f"{frames} frames ({batch_bytes} bytes of images a batch, assembled on "
          f"the host): losses " + ", ".join(f"{line['train/loss']:.4f}" for line in result.history),
          flush=True)
    print(f"[{tag}] lr " + ", ".join(f"{line['train/lr']:.3g}" for line in result.history)
          + "; val: " + ", ".join(f"{k[4:]} {v:.4f}" for k, v in result.val_history[0].items()
                                   if k.startswith("val/")), flush=True)
    print(f"[{tag}] {steps} steps + {val} val batches in {wall_s:.1f} s of the entry "
          f"point; step time {steady_ms:.2f} ms (median of steps {WARM_STEPS}..{steps - 1}, "
          f"each ending in a fetch of its metrics, spread {min(result.step_ms[WARM_STEPS:]):.1f}-"
          f"{max(result.step_ms[WARM_STEPS:]):.1f} ms), of which waiting on the loader "
          f"{wait_ms:.2f} ms ({100 * wait_ms / steady_ms:.1f}%); {batch_bytes / steady_ms / 1e6:.3f} GB/s "
          f"of images fed; native loader used: {len(reads)} calls, {sum(reads)} frame reads; "
          f"launches {launches}; on {card}", flush=True)
    return {"launches": launches, "step_ms": steady_ms, "wait_ms": wait_ms, "model": result.model,
            "cfg": cfg}


def phase_low_eval(dev: torch.device, card: str, tag: str = "low_eval",
                   run_dir: Path = LOW_RUN, steps: int = LOW_STEPS, per_dispatch: int = 2) -> dict:
    """(t) ``evaluate_policy --train-dir`` (s)'s run with (r)'s goal table,
    frames rendered at 200/84 on the card (and (v), (w), (y), (z): their
    runs, whose dispatches launch the kernel ``per_dispatch`` times);
    returns the launch counts, env-steps/s, the statistics each agent was
    given and the frames its renderer returned (names and counts)."""
    from hulc2_torch.agents import hulc2_agent
    from hulc2_torch.envs import render_torch
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    log_dir = run_dir / "evaluation"
    shutil.rmtree(log_dir, ignore_errors=True)
    stats, rendered = [], {}
    agent_init, make_render = hulc2_agent.Hulc2Agent.__init__, render_torch.make_render_obs_fn

    def recording_init(self, *args, **kw):
        stats.append(kw.get("stats"))
        agent_init(self, *args, **kw)

    def recording_render(*args, **kw):
        render = make_render(*args, **kw)

        def call(*a):
            out = render(*a)
            for k in out:
                rendered[k] = rendered.get(k, 0) + 1
            return out

        return call

    hulc2_agent.Hulc2Agent.__init__ = recording_init
    render_torch.make_render_obs_fn = recording_render
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        merged = evaluate_policy.main([
            "--train-dir", str(run_dir), "--dataset-path", str(LOW_DATA), "--fake-env",
            "--device-render", "--n-envs", str(DISK_ENVS), "--cohorts", str(DISK_COHORTS),
            "--num-sequences", str(DISK_CHAINS), "--ep-len", str(EVAL_EP_LEN), "--device", "cuda"])
        torch.cuda.synchronize(dev)
    finally:
        hulc2_agent.Hulc2Agent.__init__ = agent_init
        render_torch.make_render_obs_fn = make_render
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    diag = eval_diag(log_dir, f"{run_dir.name} evaluation")
    if not 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0 or \
            len({r["chain"] for r in diag["subtask_records"]}) != DISK_CHAINS:
        fail(f"unexpected {run_dir.name} results: {merged['latest']}")
    check_launches(launches, diag["dispatches"], f"{run_dir.name} eval", per_dispatch)
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    print(f"[{tag}] step {steps} of {run_dir.name}, goals from {LOW_DATA.name}'s "
          f"embeddings.npy, {DISK_CHAINS} chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts, "
          f"200/84 px rendered on the card: avg_seq_len {merged['latest']['avg_seq_len']:.3f}; "
          f"{diag['total_env_steps']} env steps in {diag['wall_clock_s']:.2f} s = {rate:.1f} "
          f"env-steps/s, {diag['dispatches']} dispatches "
          f"({1e3 * diag['wall_clock_s'] / diag['dispatches']:.2f} ms each); whole entry point "
          f"{wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    print(f"[{tag}] host time, summed over cohorts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in diag["timings_s"].items())
        + f"; frames the renderer returned: {rendered}", flush=True)
    return {"launches": launches, "rate": rate, "stats": stats, "rendered": rendered}


def phase_options_reference(dev: torch.device) -> None:
    """(u) Two fp32 train steps of a small model of each of the policy's new
    options on the card and on the CPU, same weights, one fixed batch of the
    host loader from (r), same offsets and plan noise, each with its
    config's optimizer, schedule and clipping; the card runs the kernel, the
    CPU its plain version."""
    import hulc2_torch.configs  # noqa: F401  (registers the config groups)
    from hulc2_torch.core.config import compose
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.train.optim import make_optimizer, make_scheduler
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    data = [f"datamodule.root_data_dir={LOW_DATA}"]
    dm_cfg = compose("cfg_low_level", LOW_SMALL + data)["datamodule"]
    dm = Hulc2DataModule(dm_cfg, seed=0, device="cpu")
    dm.setup()
    raw = {k: torch.from_numpy(v) for k, v in next(iter(dm.fused_train_iter())).items()}
    b = raw["actions"].shape[0]
    n = b * raw["actions"].shape[1]
    t0 = time.perf_counter()
    for i, (name, (root, overrides)) in enumerate(OPTION_CASES.items()):
        cfg = compose(root, LOW_SMALL + data + overrides)
        mc = cfg["model"]
        g = torch.Generator().manual_seed(40 + i)
        d = mc["distribution"]
        draws = [({cam: torch.randint(0, 2 * pad + 1, (n, 2), generator=g, dtype=torch.int32)
                   for cam, pad in (("rgb_static", 10), ("rgb_gripper", 4))},
                  torch.randn((b, d["plan_features"]), generator=g) if d["dist"] == "continuous"
                  else -torch.log(-torch.log(torch.rand((b, d["category_size"], d["class_size"]),
                                                        generator=g))))
                 for _ in range(2)]
        losses = {}
        for device in (torch.device("cpu"), dev):
            model = build_policy(mc, gripper_hw=84, static_hw=200, seed=5).to(device)
            opt = make_optimizer(model.parameters(), mc["optimizer"])
            tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                                      dm_cfg["transforms"], stats=dm.stats["training"])
            step = make_train_step(
                model, opt, tf, cfg["loss"]["clip_auxiliary_loss_beta"],
                aux_betas_from_loss_cfg(cfg["loss"]), device=device,
                scheduler=make_scheduler(opt, mc["optimizer"], mc.get("lr_scheduler"), 20),
                gradient_clip_norm=mc["optimizer"].get("gradient_clip_norm"))
            losses[device.type] = [step({k: v.to(device) for k, v in raw.items()}, None, 0.01,
                                        gumbel=noise.to(device),  # the shift is op 1
                                        draws={k: {1: v.to(device)} for k, v in off.items()}
                                        )["loss"].item() for off, noise in draws]
        print(f"[options_reference] {name} ({root} {' '.join(overrides)}): cpu {losses['cpu']} "
              f"cuda {losses['cuda']} (rel tol 1e-3)", flush=True)
        for a, c in zip(losses["cpu"], losses["cuda"]):
            if not (math.isfinite(a) and math.isclose(a, c, rel_tol=1e-3, abs_tol=1e-4)):
                fail(f"card and CPU losses of the {name} option disagree: {losses}")
    print(f"[options_reference] {len(OPTION_CASES)} options on a "
          f"{tuple(raw['rgb_static'].shape)} host-loader batch in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def seeded_draws(pipelines: dict, raw: dict, seed: int) -> dict:
    """Draws on the CPU for every op of ``pipelines`` that draws, at the
    shapes its ops see in the (B, S, H, W[, C]) windows of ``raw``
    (``device_transforms.op_draws``); both devices get the same ones."""
    from hulc2_torch.data.device_transforms import op_draws

    g = torch.Generator().manual_seed(seed)
    return {key: op_draws(ops, (raw[key].shape[0] * raw[key].shape[1], *raw[key].shape[2:4],
                                1 if raw[key].dim() == 4 else raw[key].shape[-1]), g, "cpu")
            for key, ops in pipelines.items() if key in raw}


def to_dev(batch: dict, device) -> dict:
    return {k: to_dev(v, device) if isinstance(v, dict) else v.to(device) for k, v in batch.items()}


def phase_obs_reference(dev: torch.device) -> None:
    """(x) Two fp32 train steps of a small model of each new observation
    option on the card and on the CPU, same weights, one fixed batch of the
    option's own training loader from (r) (fused, or one modality's;
    windows skipped to the effective length), same transform draws (crop
    offsets, the depth noise) and plan noise; the card runs the kernel, the
    CPU its plain version."""
    import hulc2_torch.configs  # noqa: F401  (registers the config groups)
    from hulc2_torch.core.config import compose
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS, make_batch_transform
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    t0 = time.perf_counter()
    worst = 0.0
    for i, (name, overrides) in enumerate(OBS_CASES.items()):
        cfg = compose("cfg_low_level", LOW_SMALL + [f"datamodule.root_data_dir={LOW_DATA}"]
                      + overrides)
        dm_cfg, mc = cfg["datamodule"], cfg["model"]
        dm = Hulc2DataModule(dm_cfg, seed=cfg["seed"], device="cpu")
        dm.setup()
        host = next(iter(dm.fused_train_iter()))
        raw = ({m: {k: torch.from_numpy(v) for k, v in b.items()} for m, b in host.items()}
               if "actions" not in host else {k: torch.from_numpy(v) for k, v in host.items()})
        fused = raw if "actions" in raw else next(iter(raw.values()))
        pipelines = TRANSFORM_PRESETS[dm_cfg["transforms"]]["train"]
        rows = sum(v["actions"].shape[0] for v in raw.values()) if "actions" not in raw \
            else raw["actions"].shape[0]
        g = torch.Generator().manual_seed(60 + i)
        steps = [(seeded_draws(pipelines, fused, 70 + i + k),
                  -torch.log(-torch.log(torch.rand((rows, 32, 32), generator=g))))
                 for k in range(2)]
        losses = {}
        for device in (torch.device("cpu"), dev):
            model = build_policy_for(cfg, seed=5).to(device)
            tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                                      dm_cfg["transforms"], stats=dm.stats["training"])
            step = make_train_step(model, make_optimizer(model.parameters(), mc["optimizer"]), tf,
                                   cfg["loss"]["clip_auxiliary_loss_beta"],
                                   aux_betas_from_loss_cfg(cfg["loss"]), device=device)
            losses[device.type] = [step(to_dev(raw, device), None, 0.01, gumbel=noise.to(device),
                                        draws={k: {j: d.to(device) for j, d in v.items()}
                                               for k, v in draws.items()})["loss"].item()
                                   for draws, noise in steps]
        rel = max(abs(a - c) / max(abs(a), 1e-12) for a, c in zip(losses["cpu"], losses["cuda"]))
        worst = max(worst, rel)
        shape = tuple(fused["rgb_static"].shape)
        print(f"[obs_reference] {name} ({' '.join(overrides)}): batch {sorted(raw) if 'actions' not in raw else 'fused'} "
              f"rgb_static {shape}: cpu {losses['cpu']} cuda {losses['cuda']} (largest relative "
              f"difference {rel:.2e}; rel tol 1e-5)", flush=True)
        for a, c in zip(losses["cpu"], losses["cuda"]):
            if not (math.isfinite(a) and math.isclose(a, c, rel_tol=1e-5)):
                fail(f"card and CPU losses of the {name} observation option disagree: {losses}")
    print(f"[obs_reference] {len(OBS_CASES)} options in {time.perf_counter() - t0:.1f} s; "
          f"largest relative loss difference {worst:.2e}", flush=True)


def phase_depth_run(dev: torch.device, card: str) -> tuple:
    """(y) ``cfg_low_level`` with the static depth camera from (r) at full
    width, then its eval: the depth encoder's parameters moved, depth_static
    rendered in the fused step, 2 launches a train step, 4 a val step and 2
    a dispatch."""
    from hulc2_torch.models.build import build_policy_for

    train = phase_low_train(dev, card, "depth_train", DEPTH_RUN, "cfg_low_level", DEPTH,
                            OBS_STEPS, OBS_VAL)
    enc = train["model"].perceptual_encoder.depth_static_encoder
    if enc is None or enc.conv_model[0].in_channels != 1:
        fail("the depth run built no one-channel depth_static encoder")
    init = build_policy_for(train["cfg"], seed=int(train["cfg"]["training"].get("seed", 42)))
    moved = sum(not torch.equal(p.cpu(), q) for p, q in zip(
        enc.parameters(), init.perceptual_encoder.depth_static_encoder.parameters()))
    print(f"[depth_train] depth_static encoder: {moved} of "
          f"{len(list(enc.parameters()))} parameter tensors moved", flush=True)
    if moved == 0:
        fail("the depth encoder's parameters did not move")
    evaluation = phase_low_eval(dev, card, "depth_eval", DEPTH_RUN, OBS_STEPS)
    if evaluation["rendered"].get("depth_static", 0) == 0:
        fail("no depth_static was rendered in the depth run's fused steps")
    del train["model"]
    return train, evaluation


def phase_scene_run(dev: torch.device, card: str) -> tuple:
    """(z) The static camera only, with the identity proprio encoder over
    robot_obs ++ scene_obs (robot_scene) and random frame skipping, from
    (r) at full width, then its eval: one launch a train step, 2 a val step,
    1 a dispatch; every agent holds the training split's statistics."""
    import numpy as np

    from hulc2_torch.data.statistics import load_statistics

    train = phase_low_train(dev, card, "scene_train", SCENE_RUN, "cfg_low_level",
                            SCENE + ["datamodule/frame_skip=random"], OBS_STEPS, OBS_VAL, 1, 2)
    model = train["model"]
    if model.perceptual_encoder.rgb_gripper_encoder is not None or \
            model.visual_goal.mlp[0].in_features != 64 + 39:
        fail("the scene run did not build a static-only policy over 39 proprio dims")
    del train["model"], model
    evaluation = phase_low_eval(dev, card, "scene_eval", SCENE_RUN, OBS_STEPS, per_dispatch=1)
    want = load_statistics(LOW_DATA / "training")
    if not evaluation["stats"] or not all(
            s is not None and np.array_equal(s.robot_obs_mean, want.robot_obs_mean)
            and np.array_equal(s.robot_obs_std, want.robot_obs_std) for s in evaluation["stats"]):
        fail("the scene run's agents did not get the training split's statistics")
    print(f"[scene_eval] {len(evaluation['stats'])} agents, each with the training split's "
          f"robot_obs statistics", flush=True)
    return train, evaluation


def bf16_step(pipeline: list) -> float:
    """An output's change for one bf16 step (1.0) of a pixel value below
    256 before the pipeline's normalising ops, with a margin of 1.25 for
    the colour jitter's brightness, contrast and hue (each near 1)."""
    gain = 1.0 / 255
    for op in pipeline:
        if op["op"] in ("scale_normalize", "normalize"):
            gain /= min(op["std"])
    return 1.25 * gain


def phase_presets(dev: torch.device) -> float:
    """(aa) Every transform preset's train and val pipelines on the card
    against the CPU, same draws, fp32, 2 windows of 8 frames at the presets'
    200/84 px and at 96/64 px (every resize then changes the size), depth
    and scene_obs included: within 1e-5 of the output's scale when the
    card's pipeline is given the CPU's resize values. With its own resize,
    frames resized and then shifted round to bf16 first (as JAX's do), and
    where the two fp32 resizes straddle a bf16 boundary a pixel rounds
    apart: fewer than 1e-3 of the elements may then differ, by at most one
    bf16 step (``bf16_step``). Every uint8 kernel run launched, none on the
    plain version."""
    import numpy as np

    from hulc2_torch import kernels
    from hulc2_torch.data import device_transforms as tdt
    from hulc2_torch.data.statistics import DatasetStatistics
    from hulc2_torch.ops import preprocess

    obs = {"rgb_obs": ["rgb_static", "rgb_gripper"], "depth_obs": ["depth_static", "depth_gripper"],
           "state_obs": ["robot_obs", "scene_obs"], "actions": ["rel_actions"]}
    proprio = {"n_state_obs": 54, "keep_indices": [[0, 54]], "robot_orientation_idx": [3, 6],
               "normalize": True, "normalize_robot_orientation": True}
    stats = DatasetStatistics(robot_obs_mean=np.full(15, 0.1, np.float32),
                              robot_obs_std=np.full(15, 2.0, np.float32),
                              scene_obs_mean=np.full(24, -0.1, np.float32),
                              scene_obs_std=np.full(24, 3.0, np.float32))
    g = torch.Generator().manual_seed(80)
    resize = preprocess.resize_shorter_edge
    worst, worst_own, apart, cases, t0 = 0.0, 0.0, 0.0, 0, time.perf_counter()
    for sizes in ({"rgb_static": 200, "rgb_gripper": 84}, {"rgb_static": 96, "rgb_gripper": 64}):
        raw = {cam: torch.randint(0, 256, (2, 8, hw, hw, 3), generator=g, dtype=torch.uint8)
               for cam, hw in sizes.items()}
        for cam, hw in sizes.items():
            raw[cam.replace("rgb", "depth")] = (torch.rand((2, 8, hw, hw), generator=g) * 2
                                                + 0.5).half()
        raw.update(robot_obs_raw=torch.randn((2, 8, 15), generator=g),
                   scene_obs=torch.randn((2, 8, 24), generator=g),
                   actions=torch.randn((2, 8, 7), generator=g))
        for preset in tdt.TRANSFORM_PRESETS:
            for split in ("train", "val"):
                pipelines = tdt.TRANSFORM_PRESETS[preset][split]
                tf = tdt.make_batch_transform(obs, proprio, preset, train=split == "train",
                                              stats=stats)
                draws = seeded_draws(pipelines, raw, 90 + cases)
                runs = sum(tdt.kernel_run(pipelines.get(c, []), 0,
                                          raw[c].reshape(-1, *raw[c].shape[2:])) is not None
                           for c in obs["rgb_obs"])
                kernels.reset_launch_counts()
                got = tf(to_dev(raw, dev), None, draws=to_dev(draws, dev))
                torch.cuda.synchronize(dev)
                if kernels.LAUNCHES["shift_normalize"] != runs:
                    fail(f"{preset} {split}: {kernels.LAUNCHES['shift_normalize']} kernel launches "
                         f"for {runs} uint8 runs")
                want = tf(raw, None, draws=draws)
                preprocess.resize_shorter_edge = lambda x, size: resize(x.cpu(), size).to(x.device)
                try:
                    same_resize = tf(to_dev(raw, dev), None, draws=to_dev(draws, dev))
                finally:
                    preprocess.resize_shorter_edge = resize
                for group in ("rgb_obs", "depth_obs"):
                    for k, w in want[group].items():
                        scale = max(1.0, w.abs().max().item())
                        err = (same_resize[group][k].float().cpu() - w.float()).abs().max().item() \
                            / scale
                        worst = max(worst, err)
                        if same_resize[group][k].shape != w.shape or err > 1e-5:
                            fail(f"{preset} {split} {k} at {sizes}: card and CPU differ by "
                                 f"{err:.3g} of scale")
                        d = (got[group][k].float().cpu() - w.float()).abs()
                        share = (d > 1e-5 * scale).float().mean().item()
                        worst_own, apart = max(worst_own, d.max().item()), max(apart, share)
                        if share >= 1e-3 or d.max().item() > bf16_step(pipelines.get(k, [])):
                            fail(f"{preset} {split} {k} at {sizes}: with the card's own resize "
                                 f"{share:.3g} of the elements differ, by up to {d.max().item():.3g}")
                if not torch.allclose(got["robot_obs"].cpu(), want["robot_obs"], atol=1e-5):
                    fail(f"{preset} {split}: robot_obs differs")
                cases += 1
    print(f"[presets] {len(tdt.TRANSFORM_PRESETS)} presets x train/val x 2 frame sizes = "
          f"{cases} cases, card against CPU: largest difference {worst:.3g} of scale (tol 1e-5) "
          f"with the CPU's resize values; with the card's own resize at most {apart:.3g} of a "
          f"camera's elements differ by more, by up to {worst_own:.3g} (one bf16 step at most) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def shm_segments() -> list:
    from hulc2_torch.data.process_loader import SEGMENT_PREFIX, SHM_DIR

    return sorted(p.name for p in Path(SHM_DIR).glob(f"{SEGMENT_PREFIX}*"))


def device_busy_ms(step, n: int) -> float:
    """Device-busy ms per call of ``step`` (the union of the kernels' and
    copies' intervals under ``torch.profiler``, as ``tools/profile_train``)."""
    from torch.profiler import ProfilerActivity, profile

    from hulc2_torch.tools.profile_train import _union_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not events:
        fail("the profiler recorded no device activity")
    return _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / n


def phase_pretrained_reference(dev: torch.device) -> None:
    """(ab) Two fp32 train steps of a small model of each pretrained encoder
    preset on the card and on the CPU, same weights, one fixed batch of the
    host loader from (r) (with 6-channel tactile frames added), same
    transform draws and plan noise; the card runs the kernel, the CPU its
    plain version."""
    import hulc2_torch.configs  # noqa: F401  (registers the config groups)
    from hulc2_torch.core.config import compose
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS, make_batch_transform
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    data = [f"datamodule.root_data_dir={LOW_DATA}"]
    dm = Hulc2DataModule(compose("cfg_low_level", LOW_SMALL + data)["datamodule"], seed=0,
                         device="cpu")
    dm.setup()
    raw = {k: torch.from_numpy(v) for k, v in next(iter(dm.fused_train_iter())).items()}
    b, s = raw["actions"].shape[:2]
    g = torch.Generator().manual_seed(100)
    raw["rgb_tactile"] = torch.randint(0, 256, (b, s, *TACTILE_HW, 6), generator=g,
                                       dtype=torch.uint8)
    t0, worst = time.perf_counter(), 0.0
    for i, (name, (root, overrides)) in enumerate(PRETRAINED_CASES.items()):
        cfg = compose(root, LOW_SMALL + data + overrides)
        dm_cfg, mc = cfg["datamodule"], cfg["model"]
        pipelines = TRANSFORM_PRESETS[dm_cfg["transforms"]]["train"]
        keys = dm_cfg["observation_space"]["rgb_obs"]
        case_raw = {k: v for k, v in raw.items() if k not in ("rgb_static", "rgb_gripper",
                                                               "rgb_tactile") or k in keys}
        steps = [(seeded_draws({k: pipelines.get(k, []) for k in keys}, case_raw, 110 + i + k),
                  -torch.log(-torch.log(torch.rand((b, 32, 32), generator=g)))) for k in range(2)]
        losses = {}
        for device in (torch.device("cpu"), dev):
            model = build_policy_for(cfg, seed=5).to(device)
            tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                                      dm_cfg["transforms"], stats=dm.stats["training"])
            step = make_train_step(model, make_optimizer(model.parameters(), mc["optimizer"]), tf,
                                   cfg["loss"]["clip_auxiliary_loss_beta"],
                                   aux_betas_from_loss_cfg(cfg["loss"]), device=device)
            losses[device.type] = [step(to_dev(case_raw, device), None, 0.01,
                                        gumbel=noise.to(device),
                                        draws={k: {j: d.to(device) for j, d in v.items()}
                                               for k, v in draws.items()})["loss"].item()
                                   for draws, noise in steps]
        rel = max(abs(a - c) / max(abs(a), 1e-12) for a, c in zip(losses["cpu"], losses["cuda"]))
        worst = max(worst, rel)
        encoders = {k: type(v).__name__ for k, v in model.perceptual_encoder.named_children()}
        print(f"[pretrained_reference] {name} ({root} {' '.join(overrides)}): {encoders}; "
              f"cpu {losses['cpu']} cuda {losses['cuda']} (largest relative difference "
              f"{rel:.2e}; rel tol 1e-5)", flush=True)
        for a, c in zip(losses["cpu"], losses["cuda"]):
            if not (math.isfinite(a) and math.isclose(a, c, rel_tol=1e-5)):
                fail(f"card and CPU losses of the {name} encoders disagree: {losses}")
    print(f"[pretrained_reference] {len(PRETRAINED_CASES)} presets in "
          f"{time.perf_counter() - t0:.1f} s; largest relative loss difference {worst:.2e}",
          flush=True)


def phase_rw_run(dev: torch.device, card: str) -> tuple:
    """(ac) ``cfg_low_level_rw`` from (r) at full width through the process
    loader, then its eval; the frozen R3M trunk unchanged, no segment left."""
    from hulc2_torch.models.build import build_policy_for

    train = phase_low_train(dev, card, "rw_train", RW_RUN, "cfg_low_level_rw",
                            RW_DATA + ["datamodule.loader_isolation=process"], RW_STEPS, RW_VAL,
                            child_loader=True)
    left = shm_segments()
    if left:
        fail(f"the process loader left shared-memory segments: {left[:4]}")
    enc = train["model"].perceptual_encoder.rgb_static_encoder
    if type(enc).__name__ != "VisionR3M" or train["cfg"]["datamodule"]["loader_isolation"] != "process":
        fail("the rw run built no R3M static encoder or ran no process loader")
    init = build_policy_for(train["cfg"], seed=int(train["cfg"]["training"].get("seed", 42)))
    trunk = {k: v.cpu() for k, v in enc.r3m.state_dict().items()}
    same = all(torch.equal(trunk[k], v) for k, v in
               init.perceptual_encoder.rgb_static_encoder.r3m.state_dict().items())
    head_moved = not torch.equal(enc.fc2.weight.cpu(),
                                 init.perceptual_encoder.rgb_static_encoder.fc2.weight)
    print(f"[rw_train] frozen R3M trunk ({len(trunk)} tensors) as initialised: {same}; its FC "
          f"head moved: {head_moved}; no hulc2_pl_* segment left", flush=True)
    if not same or not head_moved:
        fail("the rw run moved its frozen R3M trunk or left its head")
    del train["model"], enc, init
    evaluation = phase_low_eval(dev, card, "rw_eval", RW_RUN, RW_STEPS)
    return train, evaluation


def phase_isolation(dev: torch.device, card: str) -> dict:
    """(ad) The same ``cfg_low_level_rw`` trainer fed by the thread loader and
    the process loader in turns: the first ISOLATION_BATCHES batches of each
    turn bit for bit equal to the first turn's; per turn the step's wall
    time and loader wait (median), then the device busy of BUSY_STEPS more
    steps; returns the launches of all turns' steps."""
    import hulc2_torch.configs  # noqa: F401  (registers the config groups)
    from hulc2_torch import kernels
    from hulc2_torch.core.config import compose
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.loader import DevicePrefetcher
    from hulc2_torch.train.trainer import Trainer

    base = compose("cfg_low_level_rw", RW_DATA + [f"datamodule.root_data_dir={LOW_DATA}"])
    first, turns, trainer, step = None, [], None, None
    kernels.reset_launch_counts()
    for turn, isolation in enumerate(("none", "process", "none", "process")):
        cfg = json.loads(json.dumps(base))
        cfg["datamodule"]["loader_isolation"] = isolation
        dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device=dev)
        dm.setup()
        if trainer is None:
            trainer = Trainer(cfg, dm, run_dir=None, device=dev)
            step = trainer.make_train_step()
        t_start = time.perf_counter()
        it = DevicePrefetcher(dm.fused_train_iter(), dev)
        batches, wall, wait = [], [], []
        try:
            for i in range(ISOLATION_BATCHES + BUSY_STEPS):
                torch.cuda.synchronize(dev)
                t0, w0 = time.perf_counter(), it.wait_s
                raw = next(it)
                if i < ISOLATION_BATCHES:
                    batches.append({k: v.clone() for k, v in raw.items()})
                    step(raw, trainer.generator, 0.01)
                    torch.cuda.synchronize(dev)
                    wall.append(1e3 * (time.perf_counter() - t0))
                    wait.append(1e3 * (it.wait_s - w0))
                elif i == ISOLATION_BATCHES:
                    rest = [raw] + [next(it) for _ in range(BUSY_STEPS - 1)]
                    busy = device_busy_ms(lambda: step(rest.pop(0), trainer.generator, 0.01),
                                          BUSY_STEPS)
                    break
        finally:
            it.close()
            dm.close()
        if first is None:
            first = batches
        else:
            for j, (a, b) in enumerate(zip(batches, first)):
                bad = [k for k in b if not torch.equal(a[k], b[k])]
                if bad or set(a) != set(b):
                    fail(f"turn {turn} ({isolation}) batch {j} differs from the thread loader's "
                         f"in {bad}")
        del batches
        row = {"loader": "thread" if isolation == "none" else "process",
               "step_ms": statistics.median(wall[WARM_STEPS:]),
               "wait_ms": statistics.median(wait[WARM_STEPS:]), "busy_ms": busy,
               "turn_s": time.perf_counter() - t_start}
        turns.append(row)
        print(f"[isolation] turn {turn}: {row['loader']} loader, {ISOLATION_BATCHES} batches "
              f"bit for bit equal to turn 0's; step {row['step_ms']:.2f} ms (median of steps "
              f"{WARM_STEPS}..{ISOLATION_BATCHES - 1}, spread {min(wall[WARM_STEPS:]):.1f}-"
              f"{max(wall[WARM_STEPS:]):.1f}), loader wait {row['wait_ms']:.2f} ms, device busy "
              f"{busy:.2f} ms a step; turn {row['turn_s']:.1f} s with start-up; on {card}",
              flush=True)
    launches = dict(kernels.LAUNCHES)
    want = 2 * (ISOLATION_BATCHES + BUSY_STEPS) * len(turns)
    if launches["shift_normalize"] != want:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in the turns' "
             f"steps, expected {want}")
    left = shm_segments()
    if left:
        fail(f"the process loader left shared-memory segments: {left[:4]}")
    del first
    print(f"[isolation] no hulc2_pl_* segment left; launches {launches}", flush=True)
    return {"launches": launches, "turns": turns}


def phase_encoder_run(dev: torch.device, card: str, tag: str, overrides: list,
                      per_step: int, frozen: str) -> dict:
    """(ae), (af) ENCODER_STEPS synthetic train steps of ``cfg_low_level``
    with ``overrides`` at full width through ``python -m hulc2_torch.training
    --synthetic``, counts reset just before and read just after: losses
    finite, the ``frozen`` submodule of the perceptual encoder bit for bit as
    initialised, ``per_step`` launches a step; then BUSY_STEPS more steps of
    the same run under the profiler for the device busy."""
    from hulc2_torch import kernels, training
    from hulc2_torch.core.config import compose
    from hulc2_torch.models.build import build_policy_for

    run_dir = ENCODER_RUN / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--synthetic", "--config-name", "cfg_low_level", "--max-steps", str(ENCODER_STEPS),
            "--device", "cuda", "--run-dir", str(run_dir), *overrides]
    kernels.reset_launch_counts()
    result = training.main(argv)
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    losses = [line["loss"] for line in result.history]
    if len(losses) != ENCODER_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: losses {losses}")
    if launches["shift_normalize"] != per_step * ENCODER_STEPS:
        fail(f"{tag}: shift_normalize launched {launches['shift_normalize']} times in "
             f"{ENCODER_STEPS} steps, expected {per_step * ENCODER_STEPS}")
    cfg = compose("cfg_low_level", overrides)
    init = dict(build_policy_for(cfg).perceptual_encoder.named_modules())[frozen].state_dict()
    now = dict(result.model.perceptual_encoder.named_modules())[frozen].state_dict()
    if not all(torch.equal(now[k].cpu(), v) for k, v in init.items()):
        fail(f"{tag}: the frozen {frozen} moved")
    step_ms = statistics.median(line["step_ms"] for line in result.history[WARM_STEPS:])
    del result, now
    run = training.SyntheticRun(cfg, dev)
    batches = [run.next_batch() for _ in range(BUSY_STEPS + 1)]
    run.step(batches.pop())
    busy = device_busy_ms(lambda: run.step(batches.pop()), BUSY_STEPS)
    print(f"[{tag}] {' '.join(overrides)} at full width, synthetic windows: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; frozen {frozen} ({len(init)} tensors) as "
          f"initialised; step {step_ms:.2f} ms (median of steps {WARM_STEPS}..{ENCODER_STEPS - 1}, "
          f"host clock), device busy {busy:.2f} ms a step ({100 * (1 - busy / step_ms):.1f}% "
          f"idle); launches {launches}; on {card}", flush=True)
    del run, batches
    return {"launches": launches, "step_ms": step_ms, "busy_ms": busy}


def phase_kernel_presets(dev: torch.device, shapes: dict = None) -> dict:
    """(aa) The kernel at the other presets' static-camera shapes (the
    static-only run's are (q)'s; (ac): ``shapes``, the real-robot preset's)
    against its plain version, bit for bit, fp32 and bf16; then its device
    time, the plain version's and a bf16 cast's beside the bytes bound."""
    from hulc2_torch.ops import preprocess
    from hulc2_torch.tools import bench_shift_normalize as bench

    rows = {}
    for seed, (preset, (n, h, w, pad, mean, std)) in enumerate(
            (shapes or bench.PRESET_SHAPES).items()):
        sets = bench.make_sets(n, h, pad, bench.SETS, dev, 50 + seed, w)
        imgs, offsets = sets[0]
        err = 0.0
        for out_dtype in (torch.float32, torch.bfloat16):
            got = preprocess.random_shift_normalize(imgs, offsets, pad, mean, std, out_dtype)
            want = preprocess.shift_normalize_plain(imgs, offsets, pad, mean, std, out_dtype)
            torch.cuda.synchronize(dev)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if err > 0 or got.shape != want.shape:
                fail(f"shift_normalize disagrees with its plain version at {preset}'s {h}x{w} "
                     f"pad {pad} {out_dtype}")
        ms = bench.device_ms(bench.rotating(bench.kernel_fn(pad, mean, std), sets))
        plain_ms = bench.device_ms(bench.rotating(bench.plain_fn(pad, mean, std), sets))
        cast_ms = bench.device_ms(bench.rotating(bench.cast_fn, sets))
        bound_ms, bound_by = bench.bound(n, h, 2, w)
        rows[preset] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "max_abs_err": err}
        print(f"[presets] shift_normalize {preset} rgb_static {n}x{h}x{w}x3 pad {pad} mean {mean} "
              f"std {std}: max_abs_err {err:.3g} (tol 0); bf16 device time per launch {ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of its {bound_ms:.4f} ms bound, {bound_by}); plain "
              f"{plain_ms:.4f} ms; bf16 cast of the same bytes {cast_ms:.4f} ms", flush=True)
        del sets, imgs, offsets, got, want
    return rows


def slice_phases(dev: torch.device, card: str) -> tuple:
    """(ab)-(af); returns their paths' launch counts by name and (ac)'s kernel rows."""
    phase_pretrained_reference(dev)
    rw_train, rw_eval = phase_rw_run(dev, card)
    rw_kernel = phase_kernel_presets(dev, RW_SHAPES)
    isolation = phase_isolation(dev, card)
    rn50 = phase_encoder_run(dev, card, "clip_rn50", ["model/perceptual_encoder=static_clip",
                                                       "datamodule.transforms=clip"], 2,
                             "rgb_static_encoder.clip")
    vit = phase_encoder_run(dev, card, "clip_vit", [
        "model/perceptual_encoder=static_clip", "datamodule.transforms=clip",
        'model.perceptual_encoder.rgb_static.model_name="ViT-B/32"'], 2,
        "rgb_static_encoder.clip")
    tactile = phase_encoder_run(dev, card, "tactile", TACTILE, 1, "tactile_encoder.trunk")
    turns = isolation["turns"]
    print(f"[pretrained] cfg_low_level_rw (process loader) step {rw_train['step_ms']:.2f} ms "
          f"({rw_train['wait_ms']:.2f} ms waiting), eval {rw_eval['rate']:.1f} env-steps/s; "
          f"turns (loader: step / wait / busy ms): " + "; ".join(
              f"{t['loader']} {t['step_ms']:.2f} / {t['wait_ms']:.2f} / {t['busy_ms']:.2f}"
              for t in turns)
          + f"; synthetic steps (step / busy ms): static_clip RN50 {rn50['step_ms']:.2f} / "
          f"{rn50['busy_ms']:.2f}, ViT-B/32 {vit['step_ms']:.2f} / {vit['busy_ms']:.2f}, "
          f"static_rgb_tactile {tactile['step_ms']:.2f} / {tactile['busy_ms']:.2f}; on {card}",
          flush=True)
    return ({"rw_train": rw_train, "rw_eval": rw_eval, "isolation_turns": isolation,
             "clip_rn50_train": rn50, "clip_vit_train": vit, "tactile_train": tactile},
            rw_kernel)


def aff_losses(cfg: dict, device: torch.device, dtype: torch.dtype = torch.float32,
               steps: int = 2) -> list:
    """The total losses of ``steps`` train steps of the detector of ``cfg`` on
    synthetic 48 px frames (``tools/profile_affordance.synthetic_train_step``:
    the same weights, batches and offsets on any device, in ``dtype``)."""
    from hulc2_torch.tools.profile_affordance import synthetic_train_step

    _, step = synthetic_train_step(cfg, device, frame_hw=48, n_batches=steps, dtype=dtype)
    return [step()["total_loss"].item() for _ in range(steps)]


def phase_aff_options_reference(dev: torch.device) -> float:
    """(ag) Two train steps of a small detector of each new option in fp32 on
    the card and in fp64 on the CPU, same weights, batches and offsets,
    cuDNN deterministic: losses within rel 1e-5 (the CPU's own fp32 steps
    part from its fp64 ones by up to 1.06e-5 on ``rn50_clip_pixel``, so an
    fp32 CPU reference could not hold that bound); then the bf16 decoder
    card against CPU within rel 1e-2 and against the card's fp32 within 5%.
    Returns the largest fp32 gap."""
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    worst = 0.0
    try:
        t0 = time.perf_counter()
        for name, (group, overrides) in AFF_OPTION_CASES.items():
            cfg = affordance_config([f"aff_detection={group}", *AFF_SMALL, *overrides])
            cpu, card = aff_losses(cfg, torch.device("cpu"), torch.float64), aff_losses(cfg, dev)
            gap = max(abs(a - b) / max(abs(a), 1e-6) for a, b in zip(cpu, card))
            worst = max(worst, gap)
            if gap > 1e-5 or not all(map(math.isfinite, card)):
                fail(f"{name}: the small detector's losses on the card {card} and the CPU {cpu}")
        print(f"[aff_options] {len(AFF_OPTION_CASES)} small detectors ("
              + ", ".join(AFF_OPTION_CASES) + f"), 2 train steps each: card fp32 vs CPU fp64 "
              f"losses within rel {worst:.3g} (tol 1e-5), cuDNN deterministic; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cfg = affordance_config(["aff_detection=rn18_pixel", *AFF_SMALL, *AFF_BF16])
        fp32 = aff_losses(affordance_config(["aff_detection=rn18_pixel", *AFF_SMALL]), dev)
        cpu, card = aff_losses(cfg, torch.device("cpu")), aff_losses(cfg, dev)
        dev_gap = max(abs(a - b) / abs(a) for a, b in zip(cpu, card))
        prec_gap = max(abs(a - b) / abs(a) for a, b in zip(fp32, card))
        print(f"[aff_options] bf16 decoder: card {card}, CPU {cpu} (rel {dev_gap:.3g}, tol 1e-2); "
              f"the card's fp32 {fp32} (rel {prec_gap:.3g}, tol 5e-2)", flush=True)
        if dev_gap > 1e-2 or prec_gap > 0.05:
            fail(f"the bf16 decoder: card {card}, CPU {cpu}, fp32 {fp32}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return worst


def phase_aff_low(dev: torch.device, card: str) -> dict:
    """(ah) Labels mined from (r)'s 200/84 px dataset, the JAX default root's
    ``rn18_pixel`` detector trained on them over hash sentence embeddings,
    then the hierarchical eval of (s)'s ``cfg_low_level`` run with it;
    returns the eval's launch counts, env-steps/s and ``aff_flush_s``."""
    import os

    from hulc2_torch.affordance import dataset_creation

    os.environ["HULC2_ALLOW_STUB_EMBEDDINGS"] = "1"
    shutil.rmtree(AFF_LOW_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    info = dataset_creation.main([str(LOW_DATA), "--out-dir", str(AFF_LOW_DATA)])
    labels = {split: sum(len(c["static_cam"]) for c in info[split].values())
              for split in ("training", "validation")}
    print(f"[aff_low] {labels['training']} training and {labels['validation']} validation labels "
          f"mined from {LOW_DATA.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    if not all(labels.values()):
        fail(f"label mining of {LOW_DATA.name} found no labels in a split: {labels}")
    detector = phase_aff_train(dev, card, labels, "aff_low_train", AFF_LOW_RUN, AFF_LOW_DATA,
                               "rn18_pixel", AFF_LOW_STEPS)
    if detector.text_tower or detector.lang_embed_dim != 1024:
        fail("the rn18_pixel run built a token tower or another language width")
    return phase_hier_eval(dev, card, detector, "aff_low_eval", LOW_RUN, LOW_STEPS, AFF_LOW_RUN,
                           AFF_LOW_STEPS, AFF_LOW_DIR, ["--dataset-path", str(LOW_DATA)])


def phase_aff_presets(dev: torch.device, card: str) -> dict:
    """(ai) AFF_OPT_STEPS train steps of each preset at full width on
    synthetic 96 px frames: losses finite, R3M's layer4 moved with its stem
    through layer3 bit for bit as built, every other encoder bit for bit;
    the median step's wall time, then BUSY_STEPS steps under the profiler:
    device busy and the convolutions' share. Then ``train_depth``."""
    from hulc2_torch.affordance import train_affordance, train_depth
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.tools.profile_affordance import CONV, step_profile, synthetic_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    rows = {}
    for name, overrides in AFF_PRESETS.items():
        cfg = affordance_config(overrides)
        aff = cfg["aff_detection"]
        model, step = synthetic_train_step(cfg, dev)
        fresh = train_affordance.build_detector(aff, cfg["seed"]).aff_stream.encoder.state_dict()
        walls, losses = [], []
        for _ in range(AFF_OPT_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(step()["total_loss"].item())
            walls.append(1e3 * (time.perf_counter() - t0))
        now = {k: v.cpu() for k, v in model.aff_stream.encoder.state_dict().items()}
        moved = sorted(k for k in fresh if not torch.equal(fresh[k], now[k]))
        want = sorted(k for k in fresh if not aff["freeze_encoder"] and k.startswith("layer4_")
                      and "running" not in k)
        if moved != want or not all(map(math.isfinite, losses)):
            fail(f"{name}: losses {losses}; encoder tensors moved {moved}, expected {want}")
        busy, _, _, fams = step_profile(step, BUSY_STEPS)
        wall = statistics.median(walls[WARM_STEPS:])
        rows[name] = {"step_ms": wall, "busy_ms": busy, "conv_share": fams.get(CONV, 0.0) / busy}
        print(f"[aff_presets] {name}: {aff['encoder_name']} "
              f"{'trainable' if aff['freeze_encoder'] is False else 'frozen'}, "
              f"{aff['fusion_type']}, {aff['depth_dist']} head, "
              f"{aff['dataset'].get('label_type', 'pixel')} labels, decoder "
              f"{aff.get('compute_dtype') or 'float32'}, batch {cfg['batch_size']} at "
              f"{train_affordance.input_hw(aff)} px: losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f"; {len(want)} encoder tensors moved, {len(fresh) - len(want)} bit-equal; step "
              f"{wall:.2f} ms (median of steps {WARM_STEPS}..{AFF_OPT_STEPS - 1}, host clock), "
              f"device busy {busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle), convolutions "
              f"{100 * rows[name]['conv_share']:.1f}% of it; on {card}", flush=True)
        del model, step
    shutil.rmtree(DEPTH_ONLY_RUN, ignore_errors=True)
    res = train_depth.main(["--synthetic", "--device", "cuda", "--max-steps", str(DEPTH_ONLY_STEPS),
                            "--max-epochs", str(DEPTH_ONLY_STEPS), "--run-dir", str(DEPTH_ONLY_RUN)])
    cfg = json.loads((DEPTH_ONLY_RUN / "config.json").read_text())
    fresh = train_affordance.build_detector(cfg["aff_detection"], cfg["seed"]).state_dict()
    now = {k: v.cpu() for k, v in res.model.state_dict().items()}
    moved = [k for k in fresh if k.startswith("aff_stream.encoder.") and not torch.equal(fresh[k], now[k])]
    if res.step != DEPTH_ONLY_STEPS or not moved or any(
            not math.isclose(line["total_loss"], line["depth_loss"], rel_tol=1e-6)
            for line in res.history):
        fail(f"train_depth: {res.step} steps, {len(moved)} encoder tensors moved, {res.history}")
    print(f"[train_depth] {DEPTH_ONLY_STEPS} steps of the depth objective: depth losses "
          + ", ".join(f"{line['depth_loss']:.4f}" for line in res.history)
          + f"; {len(moved)} encoder tensors moved; on {card}", flush=True)
    return rows


def affordance_phases(dev: torch.device, card: str) -> dict:
    """(ag)-(ai) and the bf16 gate of the pretrained presets; returns (ah)'s eval."""
    from hulc2_torch.core.config import compose

    phase_aff_options_reference(dev)
    low = phase_aff_low(dev, card)
    rows = phase_aff_presets(dev, card)
    gaps = {name: phase_bf16_vs_fp32(dev, compose(root, overrides), name)
            for name, (root, overrides) in BF16_PRESETS.items()}
    print(f"[affordance] rn18_pixel + cfg_low_level hierarchical eval {low['rate']:.1f} env-steps/s, "
          f"aff_flush_s {low['flush_ms']:.2f} ms per prediction; detector step (wall / busy ms, "
          f"conv share): " + "; ".join(f"{k} {r['step_ms']:.2f} / {r['busy_ms']:.2f}, "
                                       f"{100 * r['conv_share']:.1f}%" for k, r in rows.items())
          + "; bf16 vs fp32 largest gaps: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f"; on {card}", flush=True)
    return low


def phase_kernel_real_env(dev: torch.device) -> dict:
    """(aj) The kernel at pad 0 at the real env's shapes: one frame per camera
    (a serial or real-robot step) and a cohort's 4 (a batched dispatch), 200 px
    static and 84 px gripper with ``cfg_low_level``'s val statistics, bit
    for bit; then the device time per dispatch and per serial step."""
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS
    from hulc2_torch.tools import bench_shift_normalize as bench

    val = TRANSFORM_PRESETS["rand_shift"]["val"]
    cams = {"rgb_static": 200, "rgb_gripper": 84}
    err = 0.0
    for n in (1, DISK_ENVS // DISK_COHORTS):
        for seed, (cam, hw) in enumerate(cams.items()):
            imgs, _ = bench.make_sets(n, hw, 0, 1, dev, 60 + seed)[0]
            err = max(err, check_pad0("real_env", imgs, val[cam][-1]["mean"], val[cam][-1]["std"]))
    rows = {}
    for name, n in (("dispatch", DISK_ENVS // DISK_COHORTS), ("serial_step", 1)):
        row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": err}
        for seed, (cam, hw) in enumerate(cams.items()):
            norm = val[cam][-1]
            sets = bench.make_sets(n, hw, 0, bench.SETS, dev, 70 + seed)
            row["ms"] += bench.device_ms(bench.rotating(
                bench.kernel_fn(0, norm["mean"], norm["std"]), sets))
            row["plain_ms"] += bench.device_ms(bench.rotating(
                bench.plain_fn(0, norm["mean"], norm["std"]), sets))
            bound_ms, row["bound_by"] = bench.bound(n, hw, 2)
            row["bound_ms"] += bound_ms
        rows[name] = row
        print(f"[real_env] shift_normalize per {name} ({n} frame(s) of 200x200 and of 84x84, pad 0, "
              f"bf16 out): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})", flush=True)
    return rows


def mock_calvin_env() -> dict:
    """The environment of a subprocess that imports the recorded calvin_env
    contract in place of the simulator, which this host lacks."""
    import os

    root = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(MOCK_CALVIN), str(root), os.environ.get("PYTHONPATH", "")]))


def write_aff_table() -> dict:
    """(r)'s recorded render config, and an ``embeddings.npy``-style table of
    (ah)'s detector goals: the 1024-d ``hash_embed`` it trained on, of each
    sentence of (r)'s validation table. Returns the task -> sentence table."""
    import numpy as np

    from hulc2_torch.evaluation.evaluate_policy import load_lang_embeddings
    from hulc2_torch.tools.auto_lang_annotator import hash_embed

    (LOW_DATA / ".hydra").mkdir(exist_ok=True)
    (LOW_DATA / ".hydra" / "merged_config.yaml").write_text("env: {}\ncameras: {}\n")
    _, task_to_ann = load_lang_embeddings(LOW_DATA, "lang_annotations")
    np.save(AFF_TABLE, {t: {"ann": [a], "emb": hash_embed([a], 1024)} for t, a in task_to_ann.items()},
            allow_pickle=True)
    return task_to_ann


def real_env_eval(tag: str, log_dir: Path, extra: list) -> dict:
    """``python -m hulc2_torch.evaluation.evaluate_policy`` without
    ``--fake-env`` on (s)'s run with (ah)'s detector, in a subprocess whose
    PYTHONPATH starts with the mock calvin_env; returns its results,
    diagnostics and wall time. Its kernel counts are the subprocess's own
    (``kernel_launches``), zero when it starts."""
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    cmd = [sys.executable, "-m", "hulc2_torch.evaluation.evaluate_policy", "--train-dir",
           str(LOW_RUN), "--dataset-path", str(LOW_DATA), "--aff-train-dir", str(AFF_LOW_RUN),
           "--aff-lang-embeddings", str(AFF_TABLE), "--ep-len", str(REAL_EP_LEN), "--log-dir",
           str(log_dir), "--device", "cuda", *extra]
    t0 = time.perf_counter()
    with open(log_dir / "eval.log", "w") as log:
        proc = subprocess.run(cmd, env=mock_calvin_env(), stdout=log, stderr=subprocess.STDOUT,
                              timeout=300)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print((log_dir / "eval.log").read_text()[-4000:], file=sys.stderr, flush=True)
        fail(f"{tag}: evaluate_policy exited {proc.returncode}")
    diag = eval_diag(log_dir, f"{tag} evaluation")
    results = json.loads((log_dir / "results.json").read_text())["latest"]
    h, records = diag["hierarchical"], diag["subtask_records"]
    if h["aff_predictions"] != len(records) or not records:
        fail(f"{tag}: {h} for {len(records)} subtask starts")
    if h["approach_steps"] != sum(r["approach_steps"] for r in records):
        fail(f"{tag}: the approach steps of the records do not add up")
    check_launches(diag["kernel_launches"], diag["dispatches"], tag)
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    return {"results": results, "diag": diag, "wall_s": wall_s, "rate": rate,
            "launches": diag["kernel_launches"]}


def phase_real_env_batched(card: str) -> dict:
    """(aj) The batched eval on the mock simulator, with and without the
    process farm; returns each run's counts and rates."""
    runs = {}
    for name, extra in (("process_farm", ["--process-envs"]), ("env_farm", [])):
        r = runs[name] = real_env_eval(f"real_{name}", REAL_DIR / name, [
            "--n-envs", str(DISK_ENVS), "--cohorts", str(DISK_COHORTS), "--num-sequences",
            str(DISK_CHAINS), *extra])
        d = r["diag"]
        if d["oracle"] != "CalvinTaskOracle":
            fail(f"{name}: scored with {d['oracle']}, not calvin_env's native oracle")
        if not (REAL_DIR / name / "partial_results.json").is_file():
            fail(f"{name}: no partial_results.json")
        if len({rec["chain"] for rec in d["subtask_records"]}) != DISK_CHAINS:
            fail(f"{name}: unexpected records for {DISK_CHAINS} chains")
        workers = d.get("env_workers", [])
        if extra and (len(workers) != DISK_ENVS or any(
                w["cuda_visible_devices"] != "" or w["torch_imported"] for w in workers)):
            fail(f"{name}: env workers {workers}")
        wait_ms = 1e3 * d["timings_s"]["sim_step_s"] / d["dispatches"]
        r["wait_ms"] = wait_ms
        print(f"[real_{name}] {DISK_CHAINS} chains, {DISK_ENVS} mock calvin_env envs in "
              f"{DISK_COHORTS} cohorts{' (one worker process each)' if extra else ''}, ep_len "
              f"{REAL_EP_LEN}, scored by {d['oracle']}: avg_seq_len {r['results']['avg_seq_len']:.3f};"
              f" {d['hierarchical']['aff_predictions']} predictions, "
              f"{d['hierarchical']['approaches']} approaches, {d['hierarchical']['approach_steps']} "
              f"approach steps; {d['total_env_steps']} env steps in {d['wall_clock_s']:.2f} s = "
              f"{r['rate']:.1f} env-steps/s, {d['dispatches']} dispatches, the farm's step wait "
              f"{wait_ms:.2f} ms per dispatch (sim_step_s {d['timings_s']['sim_step_s']:.3f} s); "
              f"whole subprocess {r['wall_s']:.1f} s; launches {r['launches']}"
              + (f"; workers {[w['pid'] for w in workers]} with CUDA_VISIBLE_DEVICES='' and no "
                 "torch" if extra else "") + f"; on {card}", flush=True)
        print(f"[real_{name}] host time, summed over cohorts: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in d["timings_s"].items()), flush=True)
    a, b = runs["process_farm"], runs["env_farm"]
    if a["results"] != b["results"] or a["diag"]["subtask_records"] != b["diag"]["subtask_records"] \
            or a["diag"]["hierarchical"] != b["diag"]["hierarchical"]:
        fail("the process farm's results or records differ from the in-process farm's")
    return runs


def phase_real_env_serial(card: str) -> dict:
    """(ak) The serial loop over one mock env, with the native oracle, then
    with ``--heuristic-oracle``."""
    runs = {}
    for name, extra, oracle in (("serial", [], "CalvinTaskOracle"),
                                ("serial_heuristic", ["--heuristic-oracle"], "SceneObsTaskOracle")):
        r = runs[name] = real_env_eval(name, REAL_DIR / name, [
            "--n-envs", "1", "--num-sequences", str(SERIAL_CHAINS), *extra])
        d, h = r["diag"], r["diag"]["hierarchical"]
        if d["oracle"] != oracle:
            fail(f"{name}: scored with {d['oracle']}, expected {oracle}")
        if h["approaches"] < 1 or h["approach_steps"] < 1:
            fail(f"{name}: no approach on the mock env ({h})")
        if d["total_env_steps"] != d["dispatches"] + h["approach_steps"]:
            fail(f"{name}: env steps do not add up: {d['total_env_steps']}")
        print(f"[{name}] {SERIAL_CHAINS} chains on one mock calvin_env env, ep_len {REAL_EP_LEN}, "
              f"scored by {d['oracle']}: avg_seq_len {r['results']['avg_seq_len']:.3f}; "
              f"{h['aff_predictions']} predictions for {len(d['subtask_records'])} subtask starts, "
              f"{h['approaches']} approaches, {h['approach_steps']} approach steps; "
              f"{d['total_env_steps']} env steps ({d['dispatches']} policy steps) in "
              f"{d['wall_clock_s']:.2f} s = {r['rate']:.1f} env-steps/s; host time: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in d["timings_s"].items())
              + f"; whole subprocess {r['wall_s']:.1f} s; launches {r['launches']}; on {card}",
              flush=True)
    return runs


def phase_real_world(dev: torch.device, card: str, task_to_ann: dict) -> dict:
    """(al) ``real_world_eval.main`` on the fake env with (s)'s policy and
    (ah)'s detector, two instructions; then ``test_move_to_pt``."""
    import contextlib
    import io

    import numpy as np

    from hulc2_torch import kernels
    from hulc2_torch.agents.real_world_agent import RealWorldAgent
    from hulc2_torch.evaluation import real_world_eval

    instructions = [task_to_ann["open_drawer"], task_to_ann["turn_on_led"]]
    moves = []
    reset = RealWorldAgent.reset

    def recording_reset(self, caption=None):
        before = np.array(self.env.robot_obs[:3])
        reset(self, caption)
        moves.append(float(np.linalg.norm(self.env.robot_obs[:3] - before)))

    RealWorldAgent.reset = recording_reset
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            agent = real_world_eval.main([
                "--train-dir", str(LOW_RUN), "--aff-train-dir", str(AFF_LOW_RUN),
                "--aff-lang-embeddings", str(AFF_TABLE), "--dataset-path", str(LOW_DATA),
                "--env-factory", "hulc2_torch.envs.fake_env:FakeCalvinEnv", "--ep-len",
                str(RW_EP_LEN), "--device", "cuda"], stdin=io.StringIO("\n".join(instructions) + "\n"))
        torch.cuda.synchronize(dev)
    finally:
        RealWorldAgent.reset = reset
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = RW_EP_LEN * len(instructions)
    if len(moves) != len(instructions) or min(moves) <= 0.05 or \
            agent.n_aff_predictions != len(instructions):
        fail(f"real_world_eval: approaches moved the TCP by {moves} m, "
             f"{agent.n_aff_predictions} predictions; printed {out.getvalue()!r}")
    check_launches(launches, steps, "real_world_eval")
    proc = subprocess.run([sys.executable, "-m", "hulc2_torch.affordance.test_move_to_pt"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"test_move_to_pt exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"[real_world] {instructions} on the fake env: approaches moved the TCP by "
          + ", ".join(f"{m:.3f}" for m in moves) + f" m ({agent.n_move_steps} approach steps) "
          f"before {RW_EP_LEN} policy steps each; {steps + agent.n_move_steps} env steps in "
          f"{wall_s:.2f} s of the entry point = {(steps + agent.n_move_steps) / wall_s:.1f} "
          f"env-steps/s (the policy's and the detector's load included); launches {launches}; "
          f"test_move_to_pt: {proc.stdout.strip().splitlines()[-1]}; on {card}", flush=True)
    return {"launches": launches, "rate": (steps + agent.n_move_steps) / wall_s}


def real_env_phases(dev: torch.device, card: str) -> tuple:
    """(aj)-(al); returns their paths' launch counts by name and the kernel's
    rows at their shapes."""
    rows = phase_kernel_real_env(dev)
    task_to_ann = write_aff_table()
    batched = phase_real_env_batched(card)
    serial = phase_real_env_serial(card)
    rw = phase_real_world(dev, card, task_to_ann)
    print(f"[real_env] env-steps/s: process farm {batched['process_farm']['rate']:.1f} (step wait "
          f"{batched['process_farm']['wait_ms']:.2f} ms a dispatch), in-process farm "
          f"{batched['env_farm']['rate']:.1f} ({batched['env_farm']['wait_ms']:.2f} ms), serial "
          f"{serial['serial']['rate']:.1f}, serial heuristic {serial['serial_heuristic']['rate']:.1f}"
          f", real-robot eval {rw['rate']:.1f}; on {card}", flush=True)
    paths = {f"real_{k}": v for k, v in batched.items()}
    paths.update(serial)
    paths["real_world"] = rw
    return paths, rows


def lacking_packages() -> dict:
    """Diagnostic -> the packages it needs that do not import on this host."""
    import importlib

    lacking = {}
    for diag, mods in DIAGNOSTICS.items():
        lacking[diag] = []
        for m in mods:
            try:
                importlib.import_module(m)
            except Exception:  # noqa: BLE001 - absent or broken: the diagnostic is not driven
                lacking[diag].append(m)
    return lacking


def phase_callbacks(dev: torch.device, card: str) -> dict:
    """(am) ``python -m hulc2_torch.training`` with the rollout callbacks, the
    t-SNE, the tensorboard sink and ``lh_sr`` retention, two epochs from
    (e)'s dataset at full width; returns its launch counts and rates."""
    from hulc2_torch import kernels, training
    from hulc2_torch.core.checkpoint import CheckpointManager

    lacking = lacking_packages()
    driven = [d for d, miss in lacking.items() if not miss]
    print(f"[callbacks] diagnostics driven: {driven or 'none'}; not driven: "
          f"{ {d: miss for d, miss in lacking.items() if miss} or 'none'} (packages that do not "
          f"import here)", flush=True)
    from hulc2_torch.evaluation.sequences import get_sequences

    # the long-horizon callback's chains, made (and cached) before the run so
    # that the callbacks' time is the rollouts'
    t0 = time.perf_counter()
    get_sequences(4)
    chains_s = time.perf_counter() - t0
    shutil.rmtree(CB_RUN, ignore_errors=True)
    argv = ["--run-dir", str(CB_RUN), "--device", "cuda", "--max-epochs", "2",
            f"datamodule.root_data_dir={DATA_DIR}", f"trainer.limit_train_batches={CB_STEPS}",
            f"trainer.limit_val_batches={CB_VAL}", "trainer.log_every_n_steps=1", *CB_CALLBACKS]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = training.main(argv)
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    names = [type(cb).__name__ for cb in result.callbacks]
    if names != ["RolloutLongHorizonCallback", "RolloutCallback", "RolloutCallback",
                 "TSNEPlotCallback"]:
        fail(f"the callbacks built were {names}: the vision-goal rollouts need oracle windows "
             f"in (e)'s validation split")
    lh, lang, vis, tsne = result.callbacks
    missing = {m for miss in lacking.values() for m in miss}
    for err in result.callback_errors:
        if not any(f"No module named '{m}'" in err for m in missing):
            fail(f"a callback failed: {err}")
    if result.step != 2 * CB_STEPS or len(result.history) != 2 * CB_STEPS:
        fail(f"the callbacks run ended at step {result.step} with {len(result.history)} lines")
    lines = [json.loads(x) for x in (CB_RUN / "metrics.jsonl").read_text().splitlines()]
    for prefix in ("eval_lh/", "tasks/", "tasks_vis/"):
        if not any(k.startswith(prefix) for line in lines for k in line):
            fail(f"no {prefix}* metric in metrics.jsonl")
    scored = {line["step"]: line["eval_lh/avg_seq_len"] for line in lines
              if "eval_lh/avg_seq_len" in line}
    best = max(scored, key=lambda k: (scored[k], k))
    kept = CheckpointManager(CB_RUN).all_steps()
    if kept != [best]:
        fail(f"lh_sr with save_top_k 1 kept steps {kept}, the best by eval_lh/avg_seq_len is "
             f"{best} ({scored})")
    counts = {k: sum(cb.rollout_fn_factory.counts[k] for cb in (lh, lang, vis))
              for k in ("policy_steps", "goals")}
    plan_batches = 2  # one validation batch through the plan sampler per epoch
    want = (2 * result.step + 4 * CB_VAL * 2 + 4 * plan_batches
            + 2 * (counts["policy_steps"] + counts["goals"]))
    if launches["shift_normalize"] != want:
        fail(f"shift_normalize launched {launches['shift_normalize']} times, expected {want}: "
             f"2 x {result.step} train steps + 4 x {2 * CB_VAL} val steps + 4 x {plan_batches} "
             f"plan batches + 2 x ({counts['policy_steps']} policy steps + {counts['goals']} "
             f"visual goals)")
    checked = []
    if not lacking["video"]:
        if not lh.videos or not all(p.is_file() and p.stat().st_size > 0 for p in lh.videos):
            fail("the long-horizon callback wrote no video")
        checked.append(f"{len(lh.videos)} videos ({', '.join(p.name for p in lh.videos)})")
    if not lacking["t-SNE"]:
        if len(tsne.figures) != 2 or not all(p.is_file() for p in tsne.figures):
            fail(f"the t-SNE callback wrote {tsne.figures}")
        checked.append(f"t-SNE figures {[p.name for p in tsne.figures]}")
    if not lacking["tensorboard"]:
        events = list((CB_RUN / "tb").glob("events.out.tfevents.*"))
        if not events or not any(b"eval_lh/avg_seq_len" in e.read_bytes() for e in events):
            fail("the tensorboard sink wrote no events with the callbacks' scalars")
        checked.append(f"tensorboard events {[e.name for e in events]}")
    eval_epoch = result.callback_seconds[1]
    rollout_s = sum(v for k, v in eval_epoch.items() if "Rollout" in k)
    env_steps = counts["policy_steps"]
    line = result.callback_history[-1]
    print(f"[callbacks] 2 epochs x {CB_STEPS} steps + {CB_VAL} val batch: eval_lh/avg_seq_len "
          f"{line['eval_lh/avg_seq_len']:.3f}, tasks/average_sr {line['tasks/average_sr']:.3f}, "
          f"tasks_vis/average_sr {line['tasks_vis/average_sr']:.3f} "
          f"({sum(k.startswith('tasks_vis/') for k in line) - 1} tasks with visual goals); kept "
          f"checkpoint {kept}; checked: {'; '.join(checked) or 'none'}; callback errors "
          f"{result.callback_errors}", flush=True)
    print(f"[callbacks] eval epoch: callbacks {sum(eval_epoch.values()):.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in eval_epoch.items())
          + f"), {env_steps} rollout env steps and {counts['goals']} visual goals in "
          f"{rollout_s:.2f} s of rollouts: {env_steps / rollout_s:.1f} env-steps/s; whole entry "
          f"point {wall_s:.1f} s (the 4 chains made before it in {chains_s:.2f} s); launches "
          f"{launches}; on {card}", flush=True)
    return {"launches": launches, "callback_s": sum(eval_epoch.values()),
            "rate": env_steps / rollout_s}


def dp_batch(cfg: dict, dev: torch.device) -> dict:
    """The global {"vis": ..., "lang": ...} batch of (an), made from a seed on
    the host: the flagship's windows at its camera sizes, token ids, an aux
    mask and task ids that differ between the ranks' rows."""
    import numpy as np

    from hulc2_torch.data.device_transforms import camera_sizes

    rng = np.random.default_rng(7)
    dm = cfg["datamodule"]
    s, sizes = dm["max_window_size"], camera_sizes(dm["transforms"])

    def window(b: int) -> dict:
        actions = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
        actions[..., -1] = np.sign(actions[..., -1] + 1e-6)
        return {cam: rng.integers(0, 256, (b, s, sizes[cam], sizes[cam], 3), dtype=np.uint8)
                for cam in ("rgb_static", "rgb_gripper")} | {
            "robot_obs_raw": rng.standard_normal((b, s, 15)).astype(np.float32),
            "actions": actions}

    b = 2 * dm["batch_size_lang"]
    lang = window(b)
    toks = np.zeros((b, 77), np.int64)
    for i in range(b):
        n = int(rng.integers(4, 16))
        toks[i, 0], toks[i, n - 1] = 49406, 49407
        toks[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    lang["lang"] = toks
    lang["use_for_aux_lang_loss"] = rng.random(b) < np.linspace(0.9, 0.3, b)
    lang["lang_task_id"] = rng.integers(0, cfg["model"]["lang_task_classes"], b).astype(np.int32)
    batch = {"vis": window(2 * dm["batch_size_vis"]), "lang": lang}
    return {m: {k: torch.from_numpy(v).to(dev) for k, v in w.items()} for m, w in batch.items()}


def dp_steps(cfg: dict, model, batches: dict, dev: torch.device, profile: bool = False) -> tuple:
    """DP_STEPS train steps of ``model`` (the policy, or its DDP wrapper) on
    ``batches``, each step's generator seeded from its index: (metrics per
    step, the policy's parameters after, step times in ms, and with
    ``profile`` the profiler's records of the collectives and DDP's reducer in
    the last step, name -> CPU time in us)."""
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.parallel.mesh import unwrap
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step

    dm = cfg["datamodule"]
    optimizer = make_optimizer(model.parameters(), cfg["model"]["optimizer"])
    transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                     dm["transforms"], dtype=torch.float32)
    step = make_train_step(model, optimizer, transform, cfg["loss"]["clip_auxiliary_loss_beta"],
                           aux_betas_from_loss_cfg(cfg["loss"]), device=dev)
    generator = torch.Generator(device=dev)
    history, times, share = [], [], None
    for k in range(DP_STEPS):
        generator.manual_seed(1000 + k)
        torch.cuda.synchronize(dev)
        last = profile and k == DP_STEPS - 1
        prof = None
        if last:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        metrics = step(batches, generator, cfg["loss"]["kl_beta"])
        history.append({n: float(v) for n, v in metrics.items()})
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        if prof is not None:
            prof.__exit__(None, None, None)
            # gloo's own all_reduce records carry no duration (its threads
            # run the work); these are the step thread's
            share = {e.key: e.cpu_time_total for e in prof.key_averages()
                     if e.key.startswith(("c10d::", "gloo:", "nccl:", "torch.distributed",
                                          "torch::distributed"))}
    params = {n: p.detach().float().cpu() for n, p in unwrap(model).named_parameters()}
    return history, params, times, share


def dp_rank_run(dev: torch.device, rank: int, world: int, mesh) -> dict:
    """One rank's (or, without a mesh, the one process's) Adam and SGD steps
    on its rows of ``dp_batch``, with its launch counts."""
    from hulc2_torch import kernels
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.parallel.mesh import wrap_model
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    fp32 = ['model.compute_dtype="float32"', "datamodule.batch_size_vis=16",
            "datamodule.batch_size_lang=16"]
    cfg, sgd = flagship_config(fp32), flagship_config(fp32 + DP_SGD)
    batch = dp_batch(cfg, dev)
    if world > 1:
        batch = {m: {k: v[rank * v.shape[0] // world:(rank + 1) * v.shape[0] // world]
                     for k, v in w.items()} for m, w in batch.items()}
    kernels.reset_launch_counts()
    adam = dp_steps(cfg, wrap_model(build_policy_for(cfg, seed=0).to(dev), mesh), batch, dev,
                    profile=True)
    plain = dp_steps(sgd, wrap_model(build_policy_for(sgd, seed=0).to(dev), mesh), batch, dev)
    torch.cuda.synchronize(dev)
    reduce_ms = None
    if world > 1:  # one all-reduce of all the gradients' values, as DDP's buckets hold them
        import torch.distributed as dist

        flat = torch.ones(sum(p.numel() for p in plain[1].values()), device=dev)
        times = []
        for _ in range(4):
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        reduce_ms = statistics.median(times[1:])
    return {"adam": adam[0], "adam_ms": adam[2], "ddp_records": adam[3], "sgd": plain[0],
            "reduce_ms": reduce_ms, "numel": sum(p.numel() for p in plain[1].values()),
            "params": plain[1], "launches": dict(kernels.LAUNCHES),
            "rows": batch["vis"]["actions"].shape[0] + batch["lang"]["actions"].shape[0]}


def _dp_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from hulc2_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # two ranks on one card: NCCL refuses them, gloo moves CUDA tensors for
    # the all-reduce and broadcast that DDP and the step's gathers use
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        torch.save(dp_rank_run(dev, rank, world, make_mesh()), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_kernel_dp(dev: torch.device) -> dict:
    """(an) The kernel at one rank's shapes (16 + 16 windows of 32 frames),
    bit for bit against its plain version, and its device time per rank step."""
    from hulc2_torch.ops import preprocess
    from hulc2_torch.tools import bench_shift_normalize as bench

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for seed, (cam, (n, hw, pad)) in enumerate(bench.SHAPES.items()):
        n //= DP_WORLD
        sets = bench.make_sets(n, hw, pad, bench.SETS, dev, 60 + seed)
        imgs, offsets = sets[0]
        for out_dtype in (torch.float32, torch.bfloat16):
            got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            torch.cuda.synchronize(dev)
            err = (got.float() - want.float()).abs().max().item()
            print(f"[data_parallel] shift_normalize {cam} {n}x{hw}x{hw}x3 pad {pad} {out_dtype}: "
                  f"max_abs_err {err:.3g} (tol 0)", flush=True)
            if err > 0 or got.shape != want.shape or not torch.isfinite(got.float()).all():
                fail(f"shift_normalize disagrees with its plain version at the per-rank {cam} "
                     f"shape, {out_dtype}")
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
        totals["ms"] += bench.device_ms(bench.rotating(bench.kernel_fn(pad), sets))
        totals["plain_ms"] += bench.device_ms(bench.rotating(bench.plain_fn(pad), sets))
        bound_ms, totals["bound_by"] = bench.bound(n, hw, 2)
        totals["bound_ms"] += bound_ms
        del sets, imgs, offsets, got, want
    print(f"[data_parallel] per rank step (both cameras, bf16): kernel {totals['ms']:.4f} ms, "
          f"bound {totals['bound_ms']:.4f} ms ({100 * totals['bound_ms'] / totals['ms']:.1f}%), "
          f"plain {totals['plain_ms']:.4f} ms", flush=True)
    return totals


def phase_data_parallel(dev: torch.device, card: str) -> tuple:
    """(an) Two gloo ranks on the card against one process on the global
    batch, then ``torchrun --nproc_per_node 1`` over nccl; returns the paths'
    launch counts and the kernel's row at the per-rank shapes."""
    import torch.multiprocessing as mp

    kernel = phase_kernel_dp(dev)
    out_dir = BUILD / "chip_smoke_dp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_dp_worker, args=(DP_WORLD, free_port(), str(out_dir)), nprocs=DP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    ref = dp_rank_run(dev, 0, 1, None)
    worst = {}
    for k in range(DP_STEPS):
        for tag in ("adam", "sgd"):
            got, want = ranks[0][tag][k], ref[tag][k]
            if set(got) != set(want) or ranks[1][tag][k] != got:
                fail(f"the ranks' {tag} step {k} metrics differ from each other or in keys")
            for name, w in want.items():
                rel = abs(got[name] - w) / max(abs(w), 1e-6)
                worst[name] = max(worst.get(name, 0.0), rel)
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    # the parameters' scale is the model's largest magnitude: a tensor whose
    # true gradient is zero (an attention key's bias, zero at init) holds only
    # rounding noise after the steps, which has no scale of its own
    scale = max(w.abs().max().item() for w in ref["params"].values())
    errs = {n: (ranks[0]["params"][n] - w).abs().max().item() for n, w in ref["params"].items()}
    worst_param = max(errs, key=errs.get)
    param_rel = errs[worst_param] / scale
    for r in ranks:
        if r["launches"]["shift_normalize"] != 2 * 2 * DP_STEPS or r["rows"] != 32:
            fail(f"a rank launched shift_normalize {r['launches']} times on {r['rows']} rows, "
                 f"expected {4 * DP_STEPS} on 16 + 16")
    rank_ms = statistics.median(t for r in ranks for t in r["adam_ms"][1:])
    records = ranks[0]["ddp_records"]
    reduce_ms = max(r["reduce_ms"] for r in ranks)
    one_ms = statistics.median(ref["adam_ms"][1:])
    print(f"[data_parallel] 2 gloo ranks x 16 + 16 windows against 1 process x 32 + 32, full "
          f"width fp32, TF32 off, {DP_STEPS} Adam + {DP_STEPS} SGD steps: worst rel error over "
          f"{len(worst)} metrics {max(worst.values()):.3g} (grad_norm {worst['grad_norm']:.3g}, "
          f"loss {worst['loss']:.3g}, lang_clip_loss {worst['lang_clip_loss']:.3g}); "
          f"parameters after the SGD steps within rel {param_rel:.3g} of their scale {scale:.3g} "
          f"(tol 1e-3; worst {worst_param}, {errs[worst_param]:.3g})", flush=True)
    if bad:
        fail(f"2 ranks differ from one process by more than rel 1e-3: {bad}")
    if param_rel > 1e-3:
        fail(f"the parameters after {DP_STEPS} SGD steps differ by rel {param_rel:.3g} of their scale")
    print(f"[data_parallel] step time (median of Adam steps 2-{DP_STEPS}, host clock ending in a "
          f"sync): 2 ranks {rank_ms:.2f} ms, 1 process {one_ms:.2f} ms; one gloo all-reduce of "
          f"the {ranks[0]['numel'] / 1e6:.2f}M fp32 gradient values between the ranks "
          f"{reduce_ms:.2f} ms ({100 * reduce_ms / rank_ms:.1f}% of a rank's step; median of 3 "
          f"after one); the profiler's records of the collectives and DDP's reducer on rank 0's "
          f"step thread {sum(records.values()) / 1e3:.2f} ms "
          f"({ {k: round(v / 1e3, 2) for k, v in records.items()} } ms; gloo's own records carry "
          f"no duration); spawn to join {spawn_s:.1f} s; on {card}", flush=True)
    # torchrun over nccl: one process, the group and the DDP wrapper as on more cards
    shutil.rmtree(TORCHRUN_RUN, ignore_errors=True)
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
            "--master_port", str(free_port()), "-m", "hulc2_torch.training",
            "--run-dir", str(TORCHRUN_RUN), "--max-epochs", "1",
            f"datamodule.root_data_dir={DATA_DIR}", f"trainer.limit_train_batches={TORCHRUN_STEPS}",
            "trainer.limit_val_batches=1", "trainer.log_every_n_steps=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=600)
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0 or "process group: rank 0 of 1 (nccl)" not in proc.stderr:
        fail(f"torchrun training exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in (TORCHRUN_RUN / "metrics.jsonl").read_text().splitlines()]
    perf = [x for x in lines if "perf/kernel_launches_shift_normalize" in x]
    train = [x for x in lines if "train/loss" in x]
    torchrun_launches = int(perf[0]["perf/kernel_launches_shift_normalize"]) if perf else -1
    if (len(train) != TORCHRUN_STEPS or torchrun_launches != 2 * TORCHRUN_STEPS
            or not (TORCHRUN_RUN / "saved_models" / f"{TORCHRUN_STEPS}.pt").is_file()
            or not all(math.isfinite(x["train/loss"]) for x in train)):
        fail(f"torchrun training logged {len(train)} steps, {torchrun_launches} launches")
    print(f"[data_parallel] torchrun --nproc_per_node 1 over nccl: {TORCHRUN_STEPS} steps, losses "
          + ", ".join(f"{x['train/loss']:.4f}" for x in train)
          + f", {torchrun_launches} shift_normalize launches by its own count, checkpoint written;"
          f" {torchrun_s:.1f} s; on {card}", flush=True)
    paths = {"dp_train": {"launches": {"shift_normalize": sum(
                 r["launches"]["shift_normalize"] for r in ranks)}},
             "torchrun_train": {"launches": {"shift_normalize": torchrun_launches}}}
    return paths, kernel, {"rank_ms": rank_ms, "one_ms": one_ms, "reduce_ms": reduce_ms}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        import hulc2_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the hulc2_torch package is not importable from here: {exc}")
    dev = torch.device("cuda", 0)
    # the trainer's lines (epochs, the resume, checkpoints) and warnings
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    logging.getLogger("hulc2_torch.train.trainer").setLevel(logging.INFO)
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase_build()
    kernel = phase_kernel_vs_plain(dev)
    phase_reference(dev)
    phase_bf16_vs_fp32(dev)
    launches = phase_main_path(dev, card)
    pad0 = phase_kernel_pad0(dev)
    phase_renderer(dev)
    phase_policy_step(dev)
    eval_launches = phase_eval(dev, card)
    phase_dataset()
    host_dm = phase_loader(dev)
    trained, disk_launches = phase_disk_train(dev, card)
    val_err = phase_val_kernel(dev, host_dm)
    disk_eval_launches = phase_disk_eval(dev, card, trained)
    phase_detector(dev)
    labels = phase_mining()
    detector = phase_aff_train(dev, card, labels)
    hier_launches = phase_hier_eval(dev, card, detector)["launches"]
    para_launches = phase_paraphrase(dev, card)
    sweep_launches = phase_sweep(dev, card)
    single_launches = phase_single_step(dev, card)
    interactive_launches = phase_interactive(dev, card)
    low_kernel = phase_kernel_rand_shift(dev)
    phase_low_dataset()
    phase_low_reference(dev)
    low_train = phase_low_train(dev, card)
    low_eval = phase_low_eval(dev, card)
    phase_options_reference(dev)
    gcbc_train = phase_low_train(dev, card, "gcbc_train", GCBC_RUN, "cfg_gcbc", (), OPT_STEPS,
                                 OPT_VAL)
    if gcbc_train["model"].use_plan or gcbc_train["model"].proj_vis_lang is None:
        fail("the cfg_gcbc run built a plan or no CLIP loss")
    gcbc_eval = phase_low_eval(dev, card, "gcbc_eval", GCBC_RUN, OPT_STEPS)
    rec_train = phase_low_train(dev, card, "recurrent_train", RECURRENT_RUN, "cfg_low_level",
                                RECURRENT, OPT_STEPS, OPT_VAL)
    rec_model = rec_train["model"]
    if rec_model.action_decoder.rnn_model != "lstm_decoder" or \
            type(rec_model.plan_recognition).__name__ != "PlanRecognitionBiLSTM":
        fail("the recurrent variant built no LSTM decoder or no BiLSTM posterior")
    del rec_model, gcbc_train["model"], rec_train["model"], low_train["model"]
    rec_eval = phase_low_eval(dev, card, "recurrent_eval", RECURRENT_RUN, OPT_STEPS)
    print(f"[options] train step (median, host clock) and loader wait: cfg_low_level "
          f"{low_train['step_ms']:.2f} ms ({low_train['wait_ms']:.2f} ms waiting), cfg_gcbc "
          f"{gcbc_train['step_ms']:.2f} ms ({gcbc_train['wait_ms']:.2f}), recurrent variant "
          f"{rec_train['step_ms']:.2f} ms ({rec_train['wait_ms']:.2f}); eval env-steps/s: "
          f"cfg_low_level {low_eval['rate']:.1f}, cfg_gcbc {gcbc_eval['rate']:.1f}, recurrent "
          f"{rec_eval['rate']:.1f}; on {card}", flush=True)
    low_train_launches, low_eval_launches = low_train["launches"], low_eval["launches"]
    option_paths = {"gcbc_train": gcbc_train, "gcbc_eval": gcbc_eval,
                    "recurrent_train": rec_train, "recurrent_eval": rec_eval}

    phase_obs_reference(dev)
    depth_train, depth_eval = phase_depth_run(dev, card)
    scene_train, scene_eval = phase_scene_run(dev, card)
    phase_presets(dev)
    preset_kernel = phase_kernel_presets(dev)
    single = {}
    for mod, run_dir in (("vision_only", VISION_ONLY_RUN), ("lang_only", LANG_ONLY_RUN)):
        single[mod] = phase_low_train(dev, card, f"{mod}_train", run_dir, "cfg_low_level",
                                      [f"datamodule/datasets={mod}"], SINGLE_STEPS, OBS_VAL, 2, 2)
        del single[mod]["model"]
    print(f"[observation_space] train step (median, host clock) and loader wait: depth "
          f"{depth_train['step_ms']:.2f} ms ({depth_train['wait_ms']:.2f} ms waiting), static "
          f"camera + robot_scene + frame skip {scene_train['step_ms']:.2f} ms "
          f"({scene_train['wait_ms']:.2f}), vision_only {single['vision_only']['step_ms']:.2f} ms "
          f"({single['vision_only']['wait_ms']:.2f}), lang_only "
          f"{single['lang_only']['step_ms']:.2f} ms ({single['lang_only']['wait_ms']:.2f}); eval "
          f"env-steps/s: depth {depth_eval['rate']:.1f}, static camera + scene "
          f"{scene_eval['rate']:.1f}; on {card}", flush=True)
    option_paths.update({"depth_train": depth_train, "depth_eval": depth_eval,
                         "scene_train": scene_train, "scene_eval": scene_eval,
                         "vision_only_train": single["vision_only"],
                         "lang_only_train": single["lang_only"]})
    slice_paths, rw_kernel = slice_phases(dev, card)
    option_paths.update(slice_paths)
    option_paths["aff_low_eval"] = affordance_phases(dev, card)
    real_paths, real_kernel = real_env_phases(dev, card)
    option_paths.update(real_paths)
    option_paths["callbacks_train"] = phase_callbacks(dev, card)
    dp_paths, dp_kernel, _ = phase_data_parallel(dev, card)
    option_paths.update(dp_paths)

    entry = {
        "name": "shift_normalize",
        "route": "cuda",
        "source": "hulc2_torch/csrc/shift_normalize.cu",
        "replaces": "hulc2_tpu/ops/pallas_shift.py:52",
        "launches": sum(n["shift_normalize"] for n in (
            launches, eval_launches, disk_launches, disk_eval_launches, hier_launches,
            para_launches, sweep_launches, single_launches, interactive_launches,
            low_train_launches, low_eval_launches))
        + sum(r["launches"]["shift_normalize"] for r in option_paths.values()),
        "max_abs_err": max(kernel["max_abs_err"], pad0["max_abs_err"], val_err,
                           low_kernel["max_abs_err"], real_kernel["dispatch"]["max_abs_err"],
                           *(r["max_abs_err"] for r in preset_kernel.values()),
                           *(r["max_abs_err"] for r in rw_kernel.values()),
                           dp_kernel["max_abs_err"]),
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
        "launches_by_path": {"train": launches["shift_normalize"],
                             "eval": eval_launches["shift_normalize"],
                             "disk_train": disk_launches["shift_normalize"],
                             "disk_eval": disk_eval_launches["shift_normalize"],
                             "hier_eval": hier_launches["shift_normalize"],
                             "para_eval": para_launches["shift_normalize"],
                             "sweep": sweep_launches["shift_normalize"],
                             "single_step": single_launches["shift_normalize"],
                             "interactive": interactive_launches["shift_normalize"],
                             "low_level_train": low_train_launches["shift_normalize"],
                             "low_level_eval": low_eval_launches["shift_normalize"],
                             **{k: r["launches"]["shift_normalize"]
                                for k, r in option_paths.items()}},
        "eval_dispatch": {k: pad0[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "rand_shift_step": {k: low_kernel[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "max_abs_err")},
        "preset_static_launch": preset_kernel,
        "real_world_r3m_launch": rw_kernel,
        "real_env": real_kernel,
        "dp_rank_step": {k: dp_kernel[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "max_abs_err")},
    }
    print(f"[kernels] ms, plain_ms and bound_ms are device times per train step, one rgb_static "
          f"and one rgb_gripper launch (a bf16 cast of the same bytes takes "
          f"{kernel['cast_ms']:.4f} ms); eval_dispatch holds the same per eval dispatch at pad 0, "
          f"rand_shift_step per cfg_low_level train step (200 px pad 10 and 84 px pad 4), "
          f"preset_static_launch per static-camera launch of the real_world, real_world_square "
          f"and clip presets, real_world_r3m_launch per launch of cfg_low_level_rw's train "
          f"step (static and gripper), real_env per batched dispatch (4 frames of 200 px and of "
          f"84 px) and per serial step (1 of each) at pad 0, dp_rank_step per data-parallel "
          f"rank's train step (1024 frames of 96 px pad 4 and of 64 px pad 3)",
          flush=True)
    print(f"[time] all phases {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
