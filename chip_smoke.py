#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi); no card → fail
  2. build    compile ops/csrc/*.cu with nvcc (sm_90a) and load the library;
              build the C++ substructure library with g++ (native/)
  3. K1       fused EPiC forward (its per-particle products on the tensor
              cores under the 3×TF32 split) vs its plain PyTorch version,
              config-berlin (elementwise atol/rtol 1e-4) and hidden 64 / 4
              blocks (per particle: rtol scaled by the particle's largest
              output), B=1024, N=128, random masks with empty jets; then both
              timed with CUDA events at B=32768
  4. K2       one fused sampler step vs its plain version at three times with
              the same uniforms; then both timed at B=32768
  5. slice    MultiModalBridgeMatching(config-berlin, 100 timesteps).predict
              serves requests of 1024, 8192 and 32768 jets; each request
              must launch K2 99 times and call no plain version. Each
              response also carries the model's heads at the last time,
              which `forward_kernel` computes with one launch of K1.
  6. paths    the 99-step kernel path vs the plain module path at B=1024
              with the same generator seed (informational, loose bounds:
              ≤ 1% token mismatch, median |Δx|/max(|x|, 1) ≤ 1e-4)
  7. K3       EPiC forward + hand-written backward (epic_backward.cu: its
              rerun K1's forward, dz·Wᵀ and aᵀ·dz on the tensor cores under
              the 3×TF32 split) vs
              plain autograd at config-berlin and hidden 64 / 4 blocks at
              B=1024, and at config-berlin at the training batch B=8192;
              N=128, random masks with empty jets, a random cotangent (0 on
              jets with a leaky/SELU input within 8x the jet's measured
              float32 rounding of its kink): the forward by the K1 gates,
              every packed weight's gradient per leaf
              (|err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|), and at least B/16
              of the jets held must have more than 64 particles; at B=8192
              the backward's rerun must give K1's output bits on the same
              buffer; then forward+backward and the backward alone timed at
              B=8192
  8. train    the training path, counted as one run: Trainer.fit at
              config-berlin, B=8192, N=128 (2 epochs of 8 synthetic
              batches + 1 validation batch, checkpoints to a temporary
              directory), load_checkpoint("best"), then Trainer.predict
              (EMA weights) on 1024 jets. The loss must fall, K3's
              backward must launch once per train step (16), the forward
              kernel once per train step and validation batch (18), K2 99
              times, and no plain version may be called; load_checkpoint
              restores the params; then the bare steps/s and jets/s
  9. profile  one torch.profiler window over 3 train steps at B=8192; the
              device's idle share of the bare step, unclamped
 10. train_paths  5 train steps on the kernel path and on the plain module
              path from the same weights and the same injected bridge draws,
              B=8192: every parameter within 1e-3·max|leaf| of the other

 11. K4       the wide fused EPiC forward (epic_wide_forward.cu) vs its plain
              version at the scaled backbone (every width 128, 6 blocks) at
              B=1024, per particle (|err| ≤ 1e-4 + 1e-4·max|ref| over the
              particle's 11 outputs), and with skip and discrete head off at
              B=64; then both timed at B=8192
 12. K5       wide forward + hand-written backward (epic_wide_backward.cu) vs
              plain autograd at the scaled backbone under K3's rules (per
              leaf, near-kink jets without cotangent, B/16 of the jets held
              with more than 64 particles) at B=2048 and at the training batch
              B=8192, and with skip and head off at B=64; the same bits on a
              repeated call. The plain backward and the near-kink window are
              taken over chunks of 2048 jets and the chunks' gradients summed:
              d(flat) is a sum over jets, and plain autograd's saved
              activations at 8192 would take tens of GB. Then timed at B=8192
              (the plain version at B=2048)
 13. raw_init_scaled  the scaled model as the entry points build it
              (init_mbm_parameters, Trainer.setup: the seeded initialiser
              alone), through the kernels: one predict request of 1024 jets
              and 3 train steps at B=8192. Its heads reach 1e5, so its 99-step
              flow leaves float32 and its loss is of the order of 1e9; the
              line records the finite share and the losses, and only the
              launch counts are held. The JAX package's flax initialiser does
              the same (scripts/scaled_init_magnitudes.py)
 14. slice_scaled  predict at the scaled backbone, 100 timesteps, serves
              requests of 1024 and 8192 jets: 99 launches of K4 each, no
              plain version called. This model and the next phases' get
              data-dependent weight-norm gains on top of the seeded weights
              (`data_dependent_gains`), so that what is generated and learnt
              can be checked
 15. paths_scaled  the 99-step wide kernel path vs the plain module path at
              B=256, same generator seed, the bounds of phase 6
 16. train_scaled  Trainer.fit at the scaled backbone, B=8192 (1 epoch of 8
              synthetic batches + 1 validation batch), then Trainer.predict
              on 1024 jets, counted as one run: K5 once a train step, K4 once
              a train step and validation batch and 99 times in predict, no
              plain version; the loss falls; steps/s, and one profiler window
 17. train_paths_scaled  5 train steps on the wide kernel path and on the
              plain module path from the same weights and draws at B=2048
              (what plain autograd holds): every step's loss within 1e-3 of
              the other's, relative; the parameters' distance is printed

 18. k1_hidden  K1 with `output_hidden_local` and the absorbing generator's
              56-wide discrete head at hidden 16, N=109, B=4096 vs its plain
              version: the 11 outputs and the (B, N, 16) hidden state within
              atol = rtol = 1e-4; random non-prefix masks, one empty jet; then
              both timed
 19. k6       the fused survival head (survival_head.cu) vs its plain version
              at (B, N) = (4096, 109), (7, 109) and (64, 128), random
              non-prefix masks, times in (0, 1): logits within atol = rtol =
              2e-4 (the JAX kernel's own test's tolerance), the same bits on a
              repeated launch; then both timed at B=4096, N=109
 20. slice_absorbing  AbsorbingFlow(AbsorbingConfig defaults, 100 timesteps)
              .predict serves requests of 4096 and 1024 jets at N=109: K1 and
              K6 launched 99 times each, no plain version called; kinematics
              finite, tokens in [0, 8), dead slots zero, and (the solver is
              birth-only at death_rate_scale 0) every slot alive in the source
              alive at the end; multiplicity in and out
 21. paths_absorbing  the 99-step kernel path vs the module path at B=256 with
              the same generator seed: mask and token mismatch ≤ 1% of slots,
              median |Δx|/max(|x|, 1) printed
 22. train_absorbing  Trainer.fit with an AbsorbingFlow at B=4096, N=109 (3
              epochs of 8 synthetic batches + 1 validation batch), then
              Trainer.predict (EMA weights) on 1024 jets. Absorbing training
              launches no hand-written kernel, as the JAX package's does not
              (its loss_fn runs the flax modules): the fit must launch none,
              every loss term must be finite and the total fall, and predict
              must launch K1 and K6 99 times each; then steps/s over 8
              synchronized steps
 23. profile_absorbing  torch.profiler windows over 3 train steps and over a
              serving request of 1024 jets: the top device operations

 24. k1_fold  K1 with the folded Linear-discrete input (the transdimensional
              trunk: a Dense over the 8 noisy one-hot channel values in place
              of a token's table row), no discrete head, the hidden output,
              hidden 16 / global 19, N=128, B=4096, prefix masks with one
              dims=1 jet, vs its plain version: the 11 outputs and the hidden
              state within atol = rtol = 1e-4; then both timed
 25. k7       the fused gsdm stack (gsdm_stack.cu) vs its plain version at
              (B, N, Din) = (4096, 128, 24), (4096, 128, 27), (7, 40, 27) and
              (64, 109, 24): the hidden state within atol = rtol = 2e-4 (the
              JAX kernel's own test's tolerance), the same bits on a repeated
              launch; then both timed at (4096, 128, 27); its registers and
              spills from the build log
 26. slice_transdim  TransdimensionalJumpDiffusion(TransdimensionalEpicConfig
              defaults, dt 1/48, multi_birth 24, a multiplicity prior uniform
              in [1, 128] attached).predict serves requests of 4096, 1024 and
              again 4096 jets (the first request carries the allocator's first
              cudaMallocs): per request 48 launches of K1 and 96 of K7, no plain
              version called, NFE 48; latents finite, 1 ≤ dims ≤ 128, rows
              from dims on zero, the live rows' centre of mass 0 to rounding;
              the mean multiplicity out within 10% of the prior's (with the
              all-dims analytic posterior the terminal multiplicity follows
              the prior)
 27. paths_transdim  the 48-step kernel path vs the module path at B=256 from
              the same injected draws: the final dims equal on ≥ 95% of the
              jets (a rounding can flip a birth); on those, |Δx| relative to
              each jet's scale, beside the same for the module path against
              itself from draws 1 ulp away (the initial draw ×(1 ± 2⁻²³),
              every step's noise ×(1 + 2⁻²³): the flow's own sensitivity).
              At most 3× the worst nudge's jets parted by more than 1e-3 of
              their scale, and 4 more; every kernel call on the kernel path
              held against its plain version on the same inputs, per jet
              (|err| ≤ tol·(1 + max|ref| over the jet), 1e-4 for the
              trunk, 2e-4 for K7) where the plain version is finite (the
              seeded flow overflows float32 in some jets' GroupNorms; those
              jets are counted); past 128 slots K7 against its plain
              version's float64 evaluation on the jets where the float32
              plain version misses K7's gate against that evaluation
              (counted)
 28. train_transdim  Trainer.fit with the transdimensional model at B=1024,
              N=128 (3 epochs of 8 synthetic 'list' batches + 1 validation
              batch, Adam at lr 1e-3, the JAX quality runs' rate), then
              Trainer.predict (EMA weights) on 1024 jets. Its training
              launches no hand-written kernel, as the JAX package's does not
              (net_forward(fused=False) under jax.grad): the fit must launch
              none, every loss term must be finite, the loss on one fixed
              batch with fixed corruption draws must fall, and predict must
              launch K1 48 times and K7 96 times; then steps/s over 8
              synchronized steps, and the peak memory
 29. profile_transdim  torch.profiler windows over 3 train steps and over
              serving requests of 1024 and 4096 jets: the top device operations

 30. k4_hidden_head  K4 as the `--scaled` absorbing generator calls it (every
              width 128, 6 blocks: bench.py's `_scale_encoder`): the 56-wide
              discrete head and the hidden output, N=109, B=4096, seeded
              weights, random non-prefix masks, one empty jet: the 11 outputs
              and the (B, N, 128) hidden state per particle (|err| ≤ 1e-4 +
              1e-4·max|ref| over the particle's row, as phase 11), the same
              bits on a repeat; then both timed
 31. k4_fold  K4 as the `--scaled` transdimensional trunk calls it: the folded
              Linear-discrete input, no discrete head, the hidden output,
              N=128, B=4096, prefix masks with one dims=1 jet; as phase 30.
              Then k4_row_cut: each of K4's four template instances (tokens
              or the folded input, times the 8-wide or the 56-wide head) with
              the hidden output at B=256 and N = 1, 40, 109, 112, 113, 128
              (both sides of its tensor-core products' 16-row and 64-row
              edges), per particle as phase 11, the same bits on a repeat
 32. k7_wide_input  K7 at the `--scaled` stacks' input widths 136 and 139
              (trunk hidden 128 ‖ V, ‖ 3 more: two passes of the first
              product over the input tile) at B=4096, N=128, atol = rtol =
              2e-4, the same bits on a repeat; then both timed at 139
 33. k8       the attention core (attention_core.cu) vs the einsum at B=1024,
              C=128, head widths 32, 64 and 128, N = 1, 17, 109 and 128, and
              at B=4096, N=128, 2 heads, with a random key mask that masks
              every key of one jet (whose output must be the mean of its
              values) and without a mask: atol 2e-5 (the JAX kernel's
              test's), the same bits on a repeat; then timed at B=4096,
              N=128 with the mask beside the einsum and, as the library's
              time, torch's scaled_dot_product_attention with the same
              additive mask (timed only; the port never calls it). Then K8's
              path, counted as one run: AttnBlock(use_pallas=True) forward
              and backward at B=4096, N=109 with a key mask (one launch of K8,
              the backward autograd of the einsum, as in JAX), held against
              AttnBlock(use_pallas=False): the output, the input's and every
              parameter's gradient per leaf (|err| ≤ 1e-4·max|ref leaf| +
              1e-3·|ref|), the key bias's against 0
 34. slice_absorbing_scaled  AbsorbingFlow at the `--scaled` backbone
              .predict serves requests of 4096, 4096, 1024 and 1024 jets at
              N=109 (each size's second request is the steady one): K4 (hidden
              output, 56-wide head) and K6 launched 99 times each, no other
              kernel, no plain version; the checks of phase 20. The model gets
              `data_dependent_gains` (its seeded trunk's heads reach 1e5, as
              the scaled MBM's). A torch.profiler window over one more
              4096-jet request (profile_absorbing_scaled). Then the 99-step
              kernel path vs the module path at B=256 as phase 21
              (paths_absorbing_scaled)
 35. slice_transdim_scaled  TransdimensionalJumpDiffusion at the `--scaled`
              backbone (the sampler of phase 26) .predict serves requests of
              4096, 4096, 1024 and 1024 jets: K4 (folded input, hidden output)
              48 and K7 (Din 136 and 139) 96 times a request, no other kernel,
              no plain version; the checks of phase 26; gains as phase 34;
              a profiler window as phase 34 (profile_transdim_scaled). Then
              the kernel path vs the module path from the same draws at
              B=256 as phase 27 (paths_transdim_scaled)

 36. experiment  the user's MBM run from a YAML config on real jets:
              MultimodalBridgeMatchingExperiment(config-mbm-test.yaml: the
              config-berlin encoder, N=128, 100 timesteps, 3 epochs) on the
              bundled AspenOpenJets shard (100 jets, read from its .npz), in a
              run directory under the build directory. train() must launch K3
              once a train step and K1 once a train step and a validation
              batch, and its epoch loss fall; generate() (after
              load_checkpoint("best")) K2 99 times a batch, no plain version
              in either. The generated jets post-processed: finite, tokens in
              [0, 8), dead slots 0; their KL/W1 against the shard printed
              (informational). A second experiment built by
              load_from_experiment_dir on the run directory must generate the
              same bits (experiment_generate)
 37. experiment_absorbing  AbsorbingExperiment(config-absorbing-test.yaml:
              N=109, 1000 timesteps) on the shard, the YAML's 200 epochs cut
              to 2 (the line prints both): the fit launches no kernel (as in
              JAX), generate() K1 (hidden output) and K6 999 times a batch;
              the generated jets pass phase 20's checks
 38. experiment_transdim  TransdimensionalExperiment(TransdimensionalEpicConfig
              defaults: dt 0.001, 1000 network evaluations) on the shard, 2
              epochs: the fit launches no kernel, generate() K1 (folded
              input) once and K7 twice a network evaluation; a request of
              1024 jets (the shard's jets repeated as the template) through
              Trainer.predict launches the same and its mean multiplicity
              lies within 10% of the data's

 39. bulk_mbm  the million-jet sweep: bulk_sample(config-berlin seeded model,
              1,000,000 jets in chunks of 32,768, sources drawn on the card
              from the bundled shard's multiplicity histogram, collect=False):
              K2 exactly 99 × (31 chunks + the warm-up) = 3,168 times, no
              other kernel, no plain version; its jets/s. Then collect=True
              on 65,536 jets: shapes (65536, 128, ·), finite, tokens in
              [0, 8), dead slots 0, and a rerun from the same seed the same
              bits
 40. bulk_absorbing, bulk_transdim  bulk_sample at B=4096, 3 chunks and the
              warm-up, collected: absorbing K1 (hidden output) and K6 exactly
              99 a chunk, transdim K1 (folded input) 48 and K7 96 a chunk, no
              plain version; the absorbing mask 0/1 with dead slots 0, the
              transdim dims in [1, 128] and their mean within 10% of the
              prior's
 41. substructure_native  the port's C++ substructure library
              (native/substructure.cpp, built with g++ at first use) against
              its numpy version on the shard's 100 jets and on the first 128 of
              phase 39's collected jets (post-processed with the shard's
              stats) whose particles all lie at |φ| < π (outside that domain
              the JAX package's two versions part too): the library's valid
              flags equal to the numpy selection,
              tau1/2/3, tau21/32, D2 within rtol 1e-6 (atol 1e-9, the JAX
              tests' bound); both versions' jets/s and the library's seconds
              on all 65,536 jets
 42. conditioned_transdim  reconstruction guidance: the transdimensional
              model (TransdimensionalEpicConfig(), dt cut to 1/100 as the JAX
              demo's default, do_conditioning, guidance_weight 2.0, seeded
              weights) completes 256 jets of the shard, gathered through the
              port's datamodule, from their first 3 particles: finite, dims
              in [1, 128], a trajectory other than the unguided one from the
              same generator seed, and (the guided score differentiates the
              module path, as in JAX) no kernel launched and no plain version
              called; its seconds

 43. switches  MBM at config-berlin widths, N=128, under each encoder switch
              that the trunk kernels do not take (time "Linear", continuous
              None, a Dense over the token id), with a continuous context (2
              values), a discrete one (one token of 10) and both (each
              embedded 16 wide), seeded weights: the module forward at
              B=4096 on the card against the port's CPU forward on the same
              weights and inputs (atol = rtol = 1e-4), a 99-step request of
              4096 jets (finite, tokens in [0, 8), masked slots 0; jets/s,
              the conditional model's second request the steady one), and 8
              Trainer steps of the conditional model at B=8192 (finite
              losses); K1, K2 and K3 launched 0 times, no plain version
              called. Beside them config-berlin's kernel path at 4096 jets
 44. conditional_absorbing  AbsorbingFlow(AbsorbingConfig defaults) with both
              contexts: no trunk kernel takes a context, so a step is the
              module trunk and K6. K6 against its plain version on one step's
              states at B=4096, N=109 (atol = rtol = 2e-4); two requests of
              4096 jets: K6 99 times each, K1 none, the checks of phase 20;
              then 4 train steps, finite, no kernel
 45. bf16     `parallel.compute_dtype: "bfloat16"`, whose gates the kernels do
              not read (as in JAX): config-berlin serves 32768 jets through
              K2 (99 launches) and takes a train step through K1 and K3 with
              the float32 config's bits from the same draws; the conditional
              MBM (module path, cast to bf16): its card forward at B=4096
              against the port's CPU bf16 forward, the gap as a share of the
              CPU's own float32-vs-bf16 gap (mean ≤ 0.05, largest ≤ 1: the
              card parts from the CPU on more jets than the CPU from JAX,
              scripts/bf16_card_gap.py), 8 train steps finite with
              float32 parameters; AbsorbingFlow trains 4 steps under bf16 and
              serves 1024 jets through K1 and K6 (99 each) with the float32
              bits. Information only: the scaled MBM's request of 8192 jets
              through K4, and through the module path in float32 and in bf16

 46. synth_shard  scripts/torch_make_jetclass_synth.py writes the synthetic
              JetClass shard (20,000 jets, 64 slots) as .npz; the port's
              JetClass reader takes it back: every jet's multiplicity equal to
              the shard's mask count (5 to 64), the mask 0/1 and a prefix,
              the kinematics finite and 0 on dead slots
 47. quality_absorbing  scripts/torch_quality_families.py --family absorbing:
              AbsorbingFlow (config-absorbing-test) trained QUALITY_ABS_EPOCHS
              epochs on the bundled shard, 4096 jets in requests of 1024 at
              100 sampler steps, scored against the shard; and the harness on
              the seeded weights. K1 (hidden output) and K6 99 times a
              request, no plain call; the loss falls; every reading finite;
              KL_mult_hist below the untrained model's (its readings, seconds,
              and KL_mult_hist against the source masks' KL_mult_hist_init)
 48. quality_transdim  the same for the transdimensional family with the
              tuned block at the 96-step headline (4096 jets): K1 (folded
              input) once and K7 twice a network evaluation, no plain call;
              the loss falls; every reading finite; the diverged share below
              the untrained model's; the mean multiplicity within 10% of the
              data's (KL_mult_gen_vs_data and the standardized pt's W1 of both
              printed). Then phase 27 on the trained weights
              (paths_transdim_trained, its gates): the worst K7 call's share
              of K7's gate
 49. evaluate scripts/torch_evaluate.py on phase 36's run directory, reloaded
              on the card: K2 99 times a request, no plain call; every KL/W1
              of pt, m, η and φ finite
 50. transdim_context  the transdimensional model with both contexts (2
              continuous values, one token of 10 carried as the 'list'
              loader's one-hot) at its reference widths (N=128, trunk hidden
              16, heads 128 × 2 heads × 2 blocks): 4 train steps at B=1024,
              one network evaluation on the card against the card's CPU
              (every output within 2e-4 + 2e-4 × the jet's largest output,
              the gsdm kernels' tolerance; 256 noisy states with contexts),
              then two requests of 4096
              jets. No trunk kernel takes a
              context, so K1 and K7 launch 0 times, as JAX runs none (the
              gate's reason printed); finite losses, dims in [1, N], the
              final states' contexts the template's bit for bit; then a
              24-step single-birth trajectory of 256 jets (β·dt ≤ 0.83; at 4
              steps β·dt > 1 scrubbed every latent to 0) from the same
              injected draws on the card and on the card's CPU: dims equal
              on ≥ 95% of the jets, and the jets parted beyond 1e-3 of their
              largest |x| (at least 1), the CPU test's bound, at most 3 × the
              CPU's own parted jets on draws 1 ulp away + 4 (phase 27's
              yardstick); the share within 1e-3 and the median printed
 51. quality_parity  scripts/torch_quality_parity.py (MBM, config-mbm-test)
              at QP_TRAIN_STEPS train steps (the JAX protocol's 6000 cut) and
              4096 jets, with the JAX readings of
              benchmarks/quality_parity_mbm.json beside: K3 once a train
              step and K1 at least that often in training, K2 99 times a
              request in generation, no plain call; the loss falls; every
              reading finite
 52. scaled_data  scripts/torch_quality_scaled_data.py for the three families
              on phase 46's shard (20,000 jets, 64 slots), each trained
              SCALED_DATA_STEPS steps (the JAX protocols' 6000-10000 cut),
              10,000 jets generated, the floors at this scale (3 bootstraps
              of 10,000 jets): MBM at hidden 64 × 4 blocks K2 99 times a
              request, the absorbing family (hidden 64 × 4 blocks, 100 steps)
              K1 and K6 once a step, transdim K1 once and K7 twice a network
              evaluation; no plain call; the floors finite and above 0 (but
              W1_φ's: the reader's constituents are relative to the jet axis,
              so every data jet sits at φ ≈ 0, and JAX's floor reads 0.0
              too); every reading finite
 53. absorbing_stress  scripts/torch_quality_parity_absorbing.py's nominal
              protocol and mask-dynamics stress, and
              scripts/torch_death_channel_sweep.py at scales 0, 0.5 and 1.0,
              both on phase 47's trained weights at its 100 sampler steps: K1
              and K6 once a step of every request, no plain call; every
              reading finite; at scale 0 the halved stress's KL_mult falls
              from the source's to the generated jets' (both printed)
 54. transdim_sweeps  scripts/torch_transdim_operating_points.py at 96 × 16
              and 48 × 24 and scripts/torch_diagnose_transdim.py on 256 jets,
              both on phase 48's trained weights: K1 once and K7 twice a
              network evaluation, no plain call; the table finite; mean dims
              in [1, N]

 55. dp_nccl  a world-size-1 NCCL process group (FileStore rendezvous),
              `Trainer(mesh=make_device_mesh())` for one epoch of 8 batches
              at config-berlin, B=8192: the gradients and metrics through
              NCCL's all-reduce, K1 and K3 once a step, no plain call; the
              losses the single-device Trainer's bit for bit
 56. dp_train  two gloo ranks on the card (spawned processes, FileStore
              rendezvous; NCCL refuses two ranks on one card, gloo
              all-reduces CUDA tensors), 'jit' mode, config-berlin, global
              B=8192 (4096 a rank), 5 steps: each rank K1 5 and K3 5 times, no
              plain call; the losses within rtol 2e-4 of the single-process
              run from the same seed and batches, every parameter within
              1e-3·max|leaf| (phase 10's gate); steps/s beside phase 8's
 57. dp_train_scaled  the same at the scaled backbone (its gains from
              `data_dependent_gains`), 3 steps through K4/K5 (3 and 3 a rank);
              the losses held, the parameters printed
 58. tp_train  the two ranks at model 2 (the Megatron pairs split): scaled MBM
              (B=2048) and the reference transdimensional model (B=512), both
              with data-dependent gains, 3 steps each; both ranks' losses
              within rtol 2e-4, atol 1e-5 of the replicated module path on the
              card; no kernel launches (every gate is off at model_axis > 1,
              as in JAX)
 59. bulk_dp  the 2-rank MBM sweep at config-berlin: 4 chunks of 65,536 jets
              (32,768 a rank) through K2, 99 launches a chunk a rank and the
              warm-up chunk's; the summed and per-rank jets/s beside phase
              39's. A rank that fails or outlives 300 s fails phases 56-59;
              both ranks are joined or killed.

 60. head_widths  K6, K7 and K8 at every transformer width and head count
              the head kernels take beyond 128 × 2 heads (WIDTH_PAIRS: 128 ×
              8; 256 × 8 and 64 (heads 4 wide); 384 × 4 (heads 96 wide across
              two blocks of the cluster, GroupNorm groups too), 6 and 128
              (heads 3 wide, one across two blocks); 512 × 16) against their
              plain versions with the gates of phases 19, 25 and 33: K6 at
              phase 19's shapes, K7 at phase 25's, K8 at N 17 and 128 (B=1024)
              with a key mask and without, the same bits on a repeat (the
              plain versions in chunks of 512 jets); then each timed at B=4096
              (K6 N=109, K7 N=128 and Din 27, K8 N=128 with the mask) beside
              its plain version and (K8) scaled_dot_product_attention (in
              chunks of 512 jets where the heads are no multiple of 8
              channels: its math path holds the (B, heads, N, N) scores); and
              K8's path, AttnBlock(use_pallas=True) forward at each pair, one
              launch, against AttnBlock(use_pallas=False) (1e-4 + 1e-4·|ref|)
 61. slice_absorbing_c256_h8, slice_absorbing_c128_h8  AbsorbingFlow at
              AbsorbingConfig() with its survival head 256 wide with 8 heads,
              then 128 wide with 8 heads: one predict request of 4096 jets at
              N=109, 99 steps, K1 and K6 99 times each, no plain version
              called, phase 20's checks (finite kinematics, tokens in range,
              dead slots zero, source slots alive)
 62. slice_transdim_c256_h8, slice_transdim_c128_h8  the transdimensional
              model at TransdimensionalEpicConfig() with its gsdm stacks 256
              wide with 8 heads, then 128 wide with 8 heads: one predict
              request of 4096 jets, 48 steps × multi_birth 24, K1 once and K7
              twice a network evaluation, no plain version called, phase 26's
              checks
 63. wide_widths  K4 at the general widths (a cluster of hidden / 128 blocks
              a jet): scaled-256 (every width 256, 6 blocks), local 256 with
              global 128, 384 and 512 (2 blocks each) against its plain
              version per particle at B=1024, the same bits on a repeat, then
              both timed at B=8192; K4 as the scaled-256 absorbing generator
              and transdimensional trunk call it (k4_hidden_head_256,
              k4_fold_256, B=4096, timed), and with discrete heads 128 and 512
              wide (wide_heads, B=1024, N=109, hidden output)
 64. wide_widths_backward  K5 at the same four cases under phase 12's rules
              (the plain backward in chunks of 256 jets) on phase 12's batch
              of 2048 jets, where past width 128 the near-kink window leaves
              out most jets of more than 64 particles, and on 2048 jets of
              scattered sparse masks (each slot alive with probability 0.15),
              of whose held jets B/16 must have a particle past slot 64; the
              same bits on a repeat; the backward timed at B=8192
 65. k6_trunk_256  K6 on the scaled-256 absorbing trunk (hidden 256, C=128,
              its first product in two passes of 128 columns) against its
              plain version at phase 19's shapes and gate; then timed
 66. slice_scaled256  MBM at scaled-256 (data-dependent gains) serves
              requests of 8192 and 1024 jets: 99 launches of K4 each, no other
              kernel, no plain version; its parameter count
 67. train_scaled256  Trainer.fit at scaled-256, B=8192, 8 steps + 1
              validation batch: K5 once a step, K4 once a step and a
              validation batch, no plain version, the losses finite and falling;
              K5's scratch and the peak memory
 68. slice_absorbing_scaled256  AbsorbingFlow at scaled-256 (the survival
              head at C=128 on the trunk of 256) serves 4096 jets: K4 and K6 99
              times each; then paths_absorbing_scaled256 (phase 34's check)
 69. slice_transdim_scaled256  the transdimensional model at scaled-256 (the
              stacks read 264 and 267 columns) serves 4096 jets: K4 48 and K7 96
              times; then paths_transdim_scaled256 (phase 35's check)

 70. long_heads  K6, K7 and K8 on jets of 129, 200 and 256 slots (two row
              blocks a jet: K6 and K7 clusters of C/128 × 2 blocks, K8 a block
              a query half) at 128 × 2 heads and every pair of phase 60 against
              their plain versions with the gates of phases 19, 25 and 33 at
              B=64 (K7 at Din 24 for N=200, 27 else; K8 with a key mask that
              masks every key of one jet, whose output must be its values'
              mean, and without), the same bits on a repeat; then each timed
              at B=4096, N=256, 128 × 2 heads beside its plain version (in
              chunks of 512 jets), its bounds and (K8) SDPA; and K7 checked and
              timed at the scaled-256 stacks' inputs (Din 264 and 267, N=128)
 71. slice_absorbing_n256, slice_absorbing_n200  AbsorbingFlow at
              AbsorbingConfig() with max_num_particles 256: two predict
              requests of 4096 jets (the second the steady one), then at 200
              one of 1024; each K1 and K6 99 times, no plain version called,
              phase 20's checks
 72. paths_absorbing_n256  phase 21's check at N=256
 73. slice_transdim_n256, slice_transdim_n200  the transdimensional model
              at TransdimensionalEpicConfig() with max_num_particles 256: two
              requests of 4096 jets, then at 200 one of 1024; K1 48 and K7 96
              times each, no plain version called, phase 26's checks
 74. paths_transdim_n256  phase 27's check at N=256 (dims equal on ≥ 95% of
              jets, parted jets ≤ 3 × a 1-ulp nudge's + 4, every kernel call
              within its bound of its plain version)

 75. long_wide_k4  K4 on jets of 129, 144, 145, 192, 193, 200 and 256 slots
              (a cluster of hidden / 128 column blocks × 2 row blocks a jet)
              as MBM's, the absorbing generator's (56-wide head, hidden
              output) and the transdimensional trunk (folded input, hidden
              output) call it, at the scaled backbone (6 blocks) and at local
              256 / global 128, 384 and 512 (2 blocks), B=64, one jet's only
              live particle at the last slot: per particle against the plain
              version as phase 11, the same bits on a repeat
 76. long_wide_k5  K5 at N = 129, 200 and 256 at the scaled backbone,
              scaled-256 and 512 (2 blocks) under phase 12's rules on 512
              jets of random masks and 512 of sparse scattered ones (about 19
              live slots a jet; B/16 of the held jets with a particle past
              slot 128), the same bits on a repeat
 77. long_wide_time  K4 and K5 at B=8192, N=256 at the scaled backbone and
              scaled-256, and K4 at the scaled backbone at N = 128, 129 and
              192 (the step at the row cut), beside their plain versions and
              both bounds for that N
 78. slice_scaled_n256  scaled MBM with max_num_particles 256 serves 8192
              jets: 99 launches of K4, nothing else, no plain version; then
              paths_scaled_n256 (phase 6's check at N=256, B=256)
 79. train_scaled_n256  Trainer.fit at the scaled backbone, N=256, B=8192,
              8 steps + 1 validation batch: K5 once a step, K4 once a step and
              a validation batch, no plain version, the losses finite and
              falling; on 256 jets of the first batch the kernels' loss and
              every parameter's gradient against plain autograd with the same
              draws (losses within 1e-3, every leaf within 1e-3 of its largest)
 80. slice_absorbing_scaled_n256, slice_transdim_scaled_n256 and their
              scaled-256 twins  the scaled and scaled-256 absorbing and
              transdimensional families at max_num_particles 256 serve 4096
              jets each: K4 and K6 99 times a request (absorbing), K4 48 and
              K7 96 times (transdim), nothing else, no plain version; then
              the kernel path against the module path as phases 34 and 35

The line before the last lists every kernel with its launches on its own
path's run, its two bounds from the shapes and the H100 data sheet's peaks
(`bound_ms` with the operations on the CUDA cores in fp32, `tensor_bound_ms`
with them on the tensor cores as three TF32 products, the 3×TF32 split that
every kernel runs), and the times measured here; K1's and K3's entries
also the tensor bound of the per-particle products they need
(`products_tensor_bound_ms`) and the timed call's share of each bound (K1's
at each of its three shapes: config-berlin, absorbing, transdim), and in
`launches_by_path` each path's own count, phases 36-40's, 43-45's and 47-54's
among them (`switches`, `conditional_absorbing`, `bf16_predict`, `bf16_train`,
`bf16_absorbing_predict`, `quality_absorbing`, `quality_transdim`,
`evaluate`: the trained runs'; `transdim_context` (0), `quality_parity_train`,
`quality_parity_generate`, `scaled_data_<family>` (training and generation),
`absorbing_stress`, `transdim_sweeps`, `dp_nccl`, and each rank's own
`dp_train_rank<r>`, `dp_train_scaled_rank<r>`, `bulk_dp_rank<r>`, and phases
60-62's `attn_block_C<c>_h<h>`, `serving_absorbing_c<c>_h<h>`,
`serving_transdim_c<c>_h<h>`, and phases 66-69's `serving_scaled256`,
`train_scaled256`, `serving_absorbing_scaled256`,
`serving_transdim_scaled256`, and phases 71 and 73's
`serving_absorbing_n256`, `serving_absorbing_n200`,
`serving_transdim_n256`, `serving_transdim_n200`), K6's, K7's and K8's
checks and times at every pair of phase 60 (`widths`) and past 128 slots
(`past_128_slots`, phase 70), K4's and K5's at every case of phases 63-64
(`widths`), K6's on the trunk of 256 (`trunk_256`), and K7's worst share of
its gate on the trained flow; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Uses torch, numpy, scipy (the port's jet metrics), the standard library, the
port and the port's scripts under scripts/ (torch_*.py) only. fp32 with TF32 off (phase 45 also computes in bf16 on the module path).
"""

import copy
import dataclasses
import datetime
import json
import math
import multiprocessing
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data import (
    InMemoryDataModule,
    MultimodalDatabatch,
    absorbing_training_batch,
    gauss_noise_source_batch,
    multiplicity_histogram,
    synthetic_training_batch,
    transdim_training_batch,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (
    JetClassHighLevelFeatures,
    JetDataclass,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule,
)
from multimodal_particles_tpu_torch.data.particle_clouds.particles import ParticleClouds
from multimodal_particles_tpu_torch.data.particle_clouds.substructure import (
    substructure_observables,
)
from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock
from multimodal_particles_tpu_torch.models.architectures.utils import WeightNormLinear
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import (
    init_absorbing_parameters,
    init_mbm_parameters,
    init_transdimensional_parameters,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    HybridState,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
    DistributionNodes,
    StructuredState,
    adjust_state,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import (
    transdimensional_model as transdim_module,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.sampler import (
    Condition,
    _build_time_grid,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
    sample_gumbel,
)
from multimodal_particles_tpu_torch import native
from multimodal_particles_tpu_torch.ops import _build, epic_wide_vjp_cuda
from multimodal_particles_tpu_torch.ops.attention_cuda import (
    attention_core,
    attention_core_reference,
    key_bias,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    EpicDims,
    epic_forward,
    epic_forward_reference,
    pack_encoder,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward,
    epic_backward_reference,
    epic_train_forward,
    epic_train_forward_reference,
    near_kink_jets,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    epic_forward_wide,
    pack_wide_encoder_params,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
)
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (
    blocks_reference,
    gsdm_stack,
    gsdm_stack_reference,
    stack_time_embeddings,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import (
    pack_sampler_params,
    sampler_step,
    sampler_step_reference,
)
from multimodal_particles_tpu_torch.ops.survival_cuda import (
    project_time_embeddings,
    survival_head,
    survival_head_reference,
)
from multimodal_particles_tpu_torch.parallel.bulk_sampling import bulk_sample
from multimodal_particles_tpu_torch.parallel.mesh import LocalMesh, make_device_mesh, mesh_shape
from multimodal_particles_tpu_torch.training import (
    AbsorbingExperiment,
    MultimodalBridgeMatchingExperiment,
    TransdimensionalExperiment,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.experiment_files import ExperimentsFiles

ROOT = Path(__file__).resolve().parent
sys.path.append(str(ROOT / "scripts"))  # the port's quality scripts (phases 46-54)

import torch_death_channel_sweep as death_sweep  # noqa: E402
import torch_diagnose_transdim as diagnose  # noqa: E402
import torch_evaluate  # noqa: E402
import torch_harness as harness  # noqa: E402
import torch_make_jetclass_synth as synth  # noqa: E402
import torch_quality_families as quality  # noqa: E402
import torch_quality_parity as quality_parity  # noqa: E402
import torch_quality_parity_absorbing as parity_absorbing  # noqa: E402
import torch_quality_scaled_data as scaled_data  # noqa: E402
import torch_transdim_operating_points as operating_points  # noqa: E402
ATOL = RTOL = 1e-4
MAX_TOKEN_MISMATCH = 0.01
N = 128
SEED = 0
REQUEST_SIZES = (1024, 8192, 32768)
CHECK_B = 1024
TIMING_B = 32768
TRAIN_B = 8192
TRAIN_BATCHES, TRAIN_EPOCHS = 8, 2
EMA_DECAY = 0.99
PARAM_BOUND = 1e-3  # train_paths: |Δparam| ≤ PARAM_BOUND·max|leaf|
LOSS_BOUND = 1e-3  # train_paths_scaled: |Δloss| ≤ LOSS_BOUND·|loss|, every step
SCALED_HIDDEN, SCALED_BLOCKS = 128, 6  # the scaled backbone: every width 128
SCALED_REQUEST_SIZES = (1024, 8192)
SCALED_PATHS_B = 256
SCALED_PLAIN_B = 2048  # the plain backward is timed here: autograd keeps every activation
FLIPPED_B = 64
# K5's check: a CPU count at B=512 left 346 jets out as near a kink and held 43 of more
# than 64 particles against the 32 asked for, so the check takes 2048 jets for margin
K5_CHECK_B = 2048
# the absorbing family at its reference config: N=109, the batch of its bench line
ABS_N, ABS_B = 109, 4096
ABS_REQUEST_SIZES = (4096, 1024)
ABS_PATHS_B = 256
ABS_K6_SHAPES = ((ABS_B, ABS_N), (7, ABS_N), (64, 128))
ABS_TRAIN_EPOCHS = 3
K6_TOL = 2e-4  # tests/test_ops/test_survival_pallas.py:86-88
# the transdimensional family at its reference config: N=128, 48 steps, the batches of its
# bench lines (4096 jets served, 1024 trained)
TD_N, TD_STEPS, TD_MULTI_BIRTH = 128, 48, 24
TD_B, TD_TRAIN_B = 4096, 1024
TD_REQUEST_SIZES = (4096, 1024, 4096)  # the first carries the allocator's first cudaMallocs
TD_PATHS_B = 256
TD_K7_SHAPES = ((TD_B, TD_N, 24), (TD_B, TD_N, 27), (7, 40, 27), (64, 109, 24))
TD_TRAIN_EPOCHS = 3
TD_LR = 1e-3
K7_TOL = 2e-4  # tests/test_ops/test_gsdm_stack_pallas.py:72
# the absorbing and transdimensional families at the `--scaled` backbone (bench.py --scaled):
# each request size twice, the second the steady one
SCALED_FAMILY_REQUEST_SIZES = (4096, 4096, 1024, 1024)
K8_TOL = 2e-5  # tests/test_ops/test_attention_pallas.py:26
K8_HEADS = 2
# phase 60: (transformer width, heads) beyond 128 × 2 heads; phases 61-62's predicts
WIDTH_PAIRS = ((128, 8), (256, 8), (256, 64), (384, 4), (384, 6), (384, 128), (512, 16))
WIDTH_SLICES = ((256, 8), (128, 8))
WIDTH_K8_N = (17, TD_N)
WIDTH_PLAIN_CHUNK = 512  # jets a plain call: its attention holds (B, heads, N, N) scores
MIN_EQUAL_DIMS = 0.95
# paths_transdim: the kernel path may part (|Δx| > 1e-3 of the jet's scale) PART_FACTOR
# times as many jets as the worst 1-ulp nudge of the module path does, and PART_SLACK more
PART_FACTOR, PART_SLACK = 3, 4
ULP = 2.0 ** -23
MAX_MULTIPLICITY_SHIFT = 0.10
# phases 36-38: the experiments from the repo's test configs on the bundled jets (.npz)
MBM_EXPERIMENT_YAML = ROOT / "tests" / "resources" / "configs_files" / "config-mbm-test.yaml"
ABS_EXPERIMENT_YAML = ROOT / "tests" / "resources" / "configs_files" / "config-absorbing-test.yaml"
EXPERIMENT_ABS_EPOCHS = 2  # the YAML's 200 cut
EXPERIMENT_TD_EPOCHS = 2
EXPERIMENT_TD_B = 1024  # the multiplicity check's request
# phases 39-42: the bulk sweep (BASELINE.md workload 5), the C++ substructure library and
# reconstruction guidance
BULK_JETS, BULK_B, BULK_COLLECT_JETS = 1_000_000, 32768, 65536
BULK_FAMILY_B, BULK_FAMILY_CHUNKS = 4096, 3
SUBSTRUCTURE_RTOL, SUBSTRUCTURE_ATOL = 1e-6, 1e-9  # tests/test_data/test_substructure.py:34-42
SUBSTRUCTURE_NUMPY_JETS = 128  # of phase 39's jets, the numpy loop's share (≈ 25 jets/s)
COND_JETS, COND_OBSERVED, COND_WEIGHT = 256, 3, 2.0
COND_STEPS = 100  # the JAX demo's default (examples/conditional_generation_demo.py:29)
# phases 43-45: every encoder switch and both contexts (the module path, every trunk kernel's
# gate off), and the bfloat16 compute dtype. The contexts: 2 continuous values and one
# token of a vocabulary of 10, each embedded 16 wide
CONTEXT = {"data": {"dim_context_continuous": 2, "dim_context_discrete": 1,
                    "vocab_size_context": 10},
           "encoder": {"dim_emb_context_continuous": 16, "dim_emb_context_discrete": 16}}
SWITCHES = {
    "time_linear": {"encoder": {"embedding_time": "Linear"}},
    "continuous_none": {"encoder": {"embedding_features_continuous": None}},
    "discrete_linear": {"encoder": {"embedding_features_discrete": "Linear"}},
    "context_continuous": {"data": {"dim_context_continuous": 2},
                           "encoder": {"dim_emb_context_continuous": 16}},
    "context_discrete": {"data": {"dim_context_discrete": 1, "vocab_size_context": 10},
                         "encoder": {"dim_emb_context_discrete": 16}},
    "both_contexts": CONTEXT,
}
SWITCH_B, SWITCH_TRAIN_B, SWITCH_TRAIN_STEPS = 4096, 8192, 8
COND_ABS_TRAIN_STEPS = 4
BF16_TRAIN_STEPS, BF16_ABS_B = 8, 1024
# the bf16 module forward on the card against the port's own on the CPU, as shares of the
# CPU's float32-vs-bf16 gap (mean, largest). cuBLAS sums the bf16 products in another order
# than the CPU, and an early rounding flipped by it moves a whole jet: the card parts from
# the CPU on more jets than the CPU from JAX (scripts/bf16_card_gap.py), so the card is held
# to a mean share of 0.05 (the CPU tests' 0.02) and to a largest gap below the control's
BF16_MEAN_SHARE, BF16_MAX_SHARE = 0.05, 1.0
SCALED_BF16_B = 8192  # the informational scaled timing
# phases 46-49: the quality path. The synthetic shard at the JAX script's defaults
# (scripts/make_jetclass_synth.py:51); the families' quality harness at the JAX
# harness's generation size and the 96-step transdimensional headline
# (benchmarks/quality_*.json), the epochs cut to the phases' time budget (JAX: 400
# absorbing at 1000 sampler steps, 3000 transdim)
SYNTH_JETS, SYNTH_SLOTS = 20000, 64
QUALITY_GEN_JETS, QUALITY_GEN_CHUNK = 4096, 1024
QUALITY_ABS_EPOCHS, QUALITY_ABS_STEPS = 200, 100
QUALITY_TD_EPOCHS, QUALITY_TD_STEPS = 200, 96
# phases 50-54: the transdimensional model with a context, and the head-to-head and sweep
# harnesses at the JAX scripts' protocols with the training cut to the phases' budget
TDC_TRAIN_B, TDC_TRAIN_STEPS, TDC_SERVE_B = 1024, 4, 4096
# the trajectory's 24 steps: at 4 (dt = 0.25) β(t)·dt > 1 at every step, √(1 − β·dt) is NaN
# and `adjust_state` scrubs every latent to 0 (both packages; tests/test_torch_conditioning.py)
TDC_PATHS_B, TDC_PATHS_STEPS, TDC_PATHS_TOL = 256, 24, 1e-3  # tests/test_torch_transdim.py:777-784
# the card's and the CPU's float32 evaluations of the same module path part as the seeded
# flow amplifies their rounding: the jets parted beyond 1e-3 of their scale are held to
# PART_FACTOR × those by which the CPU parts from itself on draws 1 ulp away + PART_SLACK
# (phase 27's yardstick); a context lost on one device would part every jet by O(1)
# one network evaluation, card against CPU, per jet row: the gsdm stacks' tolerance (K6's and
# K7's, the JAX kernels' own tests'); at 1e-4 the creation mean (a sum of 128 weighted unit
# vectors) missed by 1.14x on one jet
TDC_FORWARD_TOL = K6_TOL
QP_TRAIN_STEPS, QP_GEN_JETS = 600, 4096
SCALED_DATA_STEPS, SCALED_DATA_GEN = 300, 10000
SCALED_DATA = {"mbm": {"batch": 2048, "steps": 0}, "absorbing": {"batch": 1024, "steps": 100},
               "transdim": {"batch": 512, "steps": 0}}  # the JAX script's batches; 0: the config's
# the JetClass reader's constituents are relative to the jet axis, so the shard's jets all
# sit at φ ≈ 0 and W1_φ's bootstrap floor is 0 (JAX's, benchmarks/quality_mbm_scaled_data.json,
# reads 0.0 as well)
ZERO_FLOORS = ("W1_phi",)
STRESS_GEN, STRESS_JETS, SWEEP_GEN = 2048, 512, 1024
DEATH_SCALES = ("0.0", "0.5", "1.0")
OPERATING_POINTS, DIAGNOSE_JETS = "96x16,48x24", 256
# NVIDIA's H100 SXM data sheet: fp32 outside the tensor cores, dense TF32 on
# the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
TF32X3_PRODUCTS = 3  # tensor-core products a multiply-add under the 3×TF32 split


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_config(hidden=16, num_blocks=2, num_timesteps=100, emb=None, skip=True, head=True,
                glob=None):
    """config-berlin with the encoder's widths and depth replaced; `emb`
    sets the three embedding widths (None: config-berlin's 16), `glob` the
    global width (None: `hidden`)."""
    config = MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.dim_hidden_local, e.dim_hidden_glob = hidden, hidden if glob is None else glob
    e.num_blocks = num_blocks
    e.skip_connection, e.add_discrete_head = skip, head
    if emb is not None:
        e.dim_emb_time = e.dim_emb_features_continuous = e.dim_emb_features_discrete = emb
    config.bridge.num_timesteps = num_timesteps
    return config


SCALED = dict(hidden=SCALED_HIDDEN, num_blocks=SCALED_BLOCKS, emb=SCALED_HIDDEN)
# phases 63-69: scaled-256, bench.py's `_scale_encoder` with every width 256; K4's and K5's
# general kernels at (name, make_config's widths, blocks), the depth cut to 2 blocks past
# scaled-256; their checks' batch and the plain backward's chunk (autograd keeps every
# activation); K4's discrete heads past the width-128 kernel's 64 at scaled-256's widths
SCALED256_HIDDEN = 256
SCALED256 = dict(hidden=SCALED256_HIDDEN, num_blocks=SCALED_BLOCKS, emb=SCALED256_HIDDEN)
WIDE_CASES = (("scaled256", dict(hidden=256, emb=256), SCALED_BLOCKS),
              ("local256_glob128", dict(hidden=256, emb=256, glob=128), 2),
              ("all384", dict(hidden=384, emb=384), 2),
              ("all512", dict(hidden=512, emb=512), 2))
WIDE_CHECK_B, WIDE_PLAIN_CHUNK = 1024, 256
# K5's check at these widths, on two batches of 2048 jets. Past width 128 a jet has 2-4
# times the activations, and the near-kink window (8 times the jet's rounding) leaves out
# most jets of more than 64 particles (1,822 of 2,048 jets left out at scaled-256, 4 long
# jets held at 384, on an H100 80GB HBM3), so phase 12's rule (B/16 of the held jets longer than 64)
# cannot hold on phase 12's batch. The second batch scatters about 19 particles a jet over
# all 128 slots (each alive with probability WIDE_K5_SPARSE); of its held jets B/16 must
# have a particle past slot 64, the second warpgroup's rows
WIDE_K5_CHECK_B, WIDE_K5_SPARSE = 2048, 0.15
WIDE_HEADS = (128, 512)
SCALED256_REQUEST_SIZES = (8192, 1024)
SCALED256_TRAIN_BATCHES = TRAIN_BATCHES
SCALED256_FAMILY_B = 4096


def make_model(device, hidden=16, num_blocks=2, num_timesteps=100, **kwargs):
    model = MultiModalBridgeMatching(make_config(hidden, num_blocks, num_timesteps, **kwargs))
    init_mbm_parameters(model, SEED)
    return model.to(device).eval()


def random_inputs(B, device, gen):
    """t, x, k, mask at N=128: multiplicities uniform in [1, N], the first
    4 jets empty, and a Bernoulli(0.9) mask on top in every other jet."""
    batch = gauss_noise_source_batch(B, N, 3, 8, gen, device=device)
    mask = batch.source_mask
    mask[:4] = 0.0
    holes = torch.rand(mask.shape, generator=gen, device=device) < 0.1
    mask[1::2] = torch.where(holes[1::2], 0.0, mask[1::2])
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, batch.source_continuous, batch.source_discrete, mask


def compare(got, ref, tol=ATOL):
    """Elementwise |err| <= tol + tol·|ref|, and the per-particle form
    |err| <= tol + tol·max|ref| over the particle's output row (tol: ATOL =
    RTOL unless given)."""
    err = (got - ref).abs()
    row_scale = ref.abs().amax(dim=-1, keepdim=True)
    return {
        "max_abs_err": err.max().item(),
        "max_rel_err": (err / ref.abs().clamp_min(1e-3)).max().item(),
        "within_tol": bool((err <= tol + tol * ref.abs()).all().item()),
        "within_tol_per_particle": bool((err <= tol + tol * row_scale).all().item()),
        "worst_particle_err_over_bound": (err / (tol + tol * row_scale)).max().item(),
    }


def cuda_ms(fn, iters=10):
    """Mean time of one call, by CUDA events over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kernel_fn, plain_fn):
    """Plain, kernel, kernel, plain; each number is the mean of its two turns."""
    p1, k1, k2, p2 = cuda_ms(plain_fn), cuda_ms(kernel_fn), cuda_ms(kernel_fn), cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_k1(device, card):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = []
    # config-berlin is held elementwise. At hidden 64 / 4 blocks the outputs
    # reach ~1e4 and small ones are differences of such terms: the plain
    # version in float32 itself misses its float64 evaluation by 7-33x the
    # elementwise bound there, so that width is held per particle.
    for hidden, blocks, gate in ((16, 2, "within_tol"), (64, 4, "within_tol_per_particle")):
        model = make_model(device, hidden, blocks)
        packed = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
        t, x, k, mask = random_inputs(CHECK_B, device, gen)
        got = epic_forward(packed, t, x, k, mask)
        torch.cuda.synchronize()
        cmp = compare(got, epic_forward_reference(packed, t, x, k, mask))
        cmp.update(hidden=hidden, num_blocks=blocks, B=CHECK_B, N=N, gate=gate,
                   finite=bool(torch.isfinite(got).all().item()),
                   empty_jets_zero_cont=bool((got[:4, :, :3] == 0).all().item()))
        results.append(cmp)
        emit({"phase": "K1", **cmp})
        if not (cmp[gate] and cmp["finite"] and cmp["empty_jets_zero_cont"]):
            raise RuntimeError(f"K1 disagrees with its plain version: {cmp}")

    model = make_model(device)
    packed = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
    t, x, k, mask = random_inputs(TIMING_B, device, gen)
    ms, plain_ms = time_pair(lambda: epic_forward(packed, t, x, k, mask),
                             lambda: epic_forward_reference(packed, t, x, k, mask))
    bounds = forward_bounds(packed, TIMING_B, "forward", N, ms)
    emit({"phase": "K1_time", "B": TIMING_B, "N": N, "ms": ms, "plain_ms": plain_ms, **bounds,
          "card": card})
    errors = [{"hidden": r["hidden"], "num_blocks": r["num_blocks"], "B": r["B"],
               "max_abs_err": r["max_abs_err"]} for r in results]
    return results[0]["max_abs_err"], errors, ms, plain_ms, bounds


def phase_k2(device, card):
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    model = make_model(device)
    packed = pack_sampler_params(model.encoder, model.config)
    gamma = model.config.bridge.gamma
    _, dt = model.time_grid()
    _, x, k, mask = random_inputs(CHECK_B, device, gen)
    k = k.to(torch.int32)
    u = torch.rand((2, CHECK_B, N), generator=gen, device=device)
    real = mask[..., 0] > 0
    worst = 0.0
    for t in (0.0101, 0.5, 1.0 - 1e-4):
        x_new, k_new = sampler_step(packed, x, k, mask, u, t, dt, gamma=gamma)
        torch.cuda.synchronize()
        x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, t, dt, gamma=gamma)
        cmp = compare(x_new, x_ref)
        mismatch = ((k_new != k_ref)[..., 0] & real).sum().item() / real.sum().item()
        jumps = ((k_ref != k)[..., 0] & real).sum().item() / real.sum().item()
        cmp.update(t=t, dt=dt, token_mismatch=mismatch, jump_fraction=jumps)
        emit({"phase": "K2", **cmp})
        worst = max(worst, cmp["max_abs_err"])
        if not cmp["within_tol"] or mismatch > MAX_TOKEN_MISMATCH:
            raise RuntimeError(f"K2 disagrees with its plain version: {cmp}")

    _, x, k, mask = random_inputs(TIMING_B, device, gen)
    k = k.to(torch.int32)
    u = torch.rand((2, TIMING_B, N), generator=gen, device=device)
    ms, plain_ms = time_pair(
        lambda: sampler_step(packed, x, k, mask, u, 0.5, dt, gamma=gamma),
        lambda: sampler_step_reference(packed, x, k, mask, u, 0.5, dt, gamma=gamma),
    )
    bound = kernel_bound(packed, TIMING_B, "sampler_step")
    emit({"phase": "K2_time", "B": TIMING_B, "N": N, "ms": ms, "plain_ms": plain_ms, **bound,
          **against_bounds(bound, ms),
          "products_tensor_bound_ms": needed_products_tensor_bound_ms(packed.dims, TIMING_B, N),
          "card": card})
    return worst, ms, plain_ms


def check_generated(out, batch, B, n=N):
    x, k = out.continuous, out.discrete
    mask = batch.source_mask
    ok = {
        "shape": tuple(x.shape) == (B, n, 3) and tuple(k.shape) == (B, n, 1),
        "finite": bool(torch.isfinite(x).all().item()),
        "tokens_in_range": bool(((k >= 0) & (k < 8)).all().item()),
        "masked_slots_zero": bool(((x * (1 - mask)) == 0).all().item()
                                  and ((k * (1 - mask).long()) == 0).all().item()),
        "empty_jet_zero": bool((x[-1] == 0).all().item() and (k[-1] == 0).all().item()),
    }
    if not all(ok.values()):
        raise RuntimeError(f"generated jets fail their checks: {ok}")
    return ok


def phase_slice(device, card):
    model = make_model(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    batches = [gauss_noise_source_batch(B, N, 3, 8, gen, device=device, num_empty=1)
               for B in REQUEST_SIZES]
    torch.cuda.synchronize()

    # the main path's run: every count starts at 0 here
    sampler_step.launches = epic_forward.launches = 0
    sampler_step_reference.calls = epic_forward_reference.calls = 0
    for B, batch in zip(REQUEST_SIZES, batches):
        before_k2, before_k1 = sampler_step.launches, epic_forward.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        heads = model.forward_kernel(out.replace(
            time=torch.full((B, 1, 1), model.time_grid()[0][-1], device=device)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k2, k1 = sampler_step.launches - before_k2, epic_forward.launches - before_k1
        checks = check_generated(out, batch, B)
        if not bool(torch.isfinite(heads.discrete).all().item()):
            raise RuntimeError("final heads are not finite")
        rec = {"phase": "slice", "B": B, "N": N, "steps": k2, "K2_launches": k2,
               "K1_launches": k1, "seconds": seconds, "jets_per_s": B / seconds,
               "card": card, **checks}
        emit(rec)
        if k2 != 99 or k1 != 1:
            raise RuntimeError(f"request of {B} jets launched K2 {k2} and K1 {k1} times")
    plain_calls = sampler_step_reference.calls + epic_forward_reference.calls
    launches = {"epic_forward": epic_forward.launches, "sampler_step": sampler_step.launches}
    emit({"phase": "slice_counts", "launches": launches, "plain_calls": plain_calls})
    if plain_calls != 0:
        raise RuntimeError(f"the main path called a plain version {plain_calls} times")
    return launches


def leaf_compare(got, ref, packed):
    """Per packed leaf: |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|
    (tests/test_ops/test_epic_pallas_vjp.py:115-123)."""
    worst_ratio, bad = 0.0, []
    refs = packed.rebind(ref).tensors
    for name, a in packed.rebind(got).tensors.items():
        r = refs[name]
        bound = 1e-4 * max(r.abs().max().item(), 1e-6) + 1e-3 * r.abs()
        ratio = ((a - r).abs() / bound).max().item()
        worst_ratio = max(worst_ratio, ratio)
        if not ratio <= 1.0:
            bad.append(name)
    return {"max_abs_err": (got - ref).abs().max().item(), "worst_leaf_err_over_bound": worst_ratio,
            "leaves_out_of_bound": bad}


def plain_calls():
    return (epic_forward_reference.calls + sampler_step_reference.calls
            + epic_train_forward_reference.calls + epic_backward_reference.calls
            + survival_head_reference.calls + gsdm_stack_reference.calls
            + attention_core_reference.calls)


def multiplicity_bins(mult):
    """Jet counts by multiplicity: 0, 1-32, 33-64, 65-96, 97-128."""
    edges = [(0, 0), (1, 32), (33, 64), (65, 96), (97, N)]
    return {f"{lo}-{hi}": int(((mult >= lo) & (mult <= hi)).sum().item()) for lo, hi in edges}


def phase_k3(device, card):
    """K3 forward + backward against plain autograd at config-berlin and
    hidden 64 / 4 blocks (B=1024), and at config-berlin at the training
    batch (B=8192), where each block of the persistent grid sums ~8x more
    jets into its gradient row. Then both timed at B=8192."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    checks = []
    for hidden, blocks, B, gate in ((16, 2, CHECK_B, "within_tol"),
                                    (64, 4, CHECK_B, "within_tol_per_particle"),
                                    (16, 2, TRAIN_B, "within_tol")):
        model = make_model(device, hidden, blocks)
        packed = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
        t, x, k, mask = random_inputs(B, device, gen)
        # jets with a leaky/SELU input within float32 rounding of its kink
        # get no cotangent: there the two float32 evaluations may take other
        # branches of the derivative (near_kink_jets)
        near = near_kink_jets(packed, t, x, k, mask)
        g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
        leaf = packed.flat.clone().requires_grad_(True)
        out = epic_train_forward(packed.rebind(leaf), t, x, k, mask)
        out.backward(g)
        torch.cuda.synchronize()
        fwd = compare(out.detach(), epic_forward_reference(packed, t, x, k, mask))
        bwd = leaf_compare(leaf.grad, epic_backward_reference(packed, t, x, k, mask, g), packed)
        mult = mask[..., 0].sum(dim=1)
        # the jets held must include enough of more than 64 particles, more
        # than four of the kernel's warps of 16 slots
        kept_long = int(((~near) & (mult > 64)).sum().item())
        rec = {"phase": "K3", "hidden": hidden, "num_blocks": blocks, "B": B, "N": N,
               "forward_gate": gate, "forward": fwd, "backward": bwd,
               "near_kink_jets_left_out": int(near.sum().item()),
               "kept_jets_by_multiplicity": multiplicity_bins(mult[~near]),
               "left_out_by_multiplicity": multiplicity_bins(mult[near]),
               "kept_jets_over_64": kept_long, "kept_jets_over_64_min": B // 16,
               "finite": bool(torch.isfinite(leaf.grad).all().item())}
        emit(rec)
        checks.append(rec)
        if not (fwd[gate] and rec["finite"] and not bwd["leaves_out_of_bound"]):
            raise RuntimeError(f"K3 disagrees with plain autograd: {rec}")
        if kept_long < B // 16:
            raise RuntimeError(f"K3 check holds only {kept_long} jets of more than 64 particles")
    # the backward's rerun is K1's forward on the same buffer: K1's bits
    rerun = torch.empty((TRAIN_B, N, 11), device=device)
    epic_backward(packed, t, x, k, mask, g, rerun_out=rerun)
    rerun_bits = bool(torch.equal(rerun, epic_forward(packed, t, x, k, mask)))
    emit({"phase": "K3_rerun", "B": TRAIN_B, "N": N, "rerun_equals_k1_bits": rerun_bits})
    if not rerun_bits:
        raise RuntimeError("K3's rerun of the forward does not give K1's bits")

    # the timing reuses the training-batch check's weights and inputs
    g = torch.randn((TRAIN_B, N, 11), generator=gen, device=device)
    leaf_packed = packed.rebind(leaf)

    def kernel_fb():
        leaf.grad = None
        epic_train_forward(leaf_packed, t, x, k, mask).backward(g)

    def plain_fb():
        leaf.grad = None
        epic_train_forward_reference(leaf_packed, t, x, k, mask).backward(g)

    fb_ms, fb_plain_ms = time_pair(kernel_fb, plain_fb)
    ms, plain_ms = time_pair(lambda: epic_backward(packed, t, x, k, mask, g),
                             lambda: epic_backward_reference(packed, t, x, k, mask, g))
    bounds = backward_bounds(packed, TRAIN_B, N, ms)
    emit({"phase": "K3_time", "hidden": 16, "B": TRAIN_B, "N": N, "forward_backward_ms": fb_ms,
          "forward_backward_plain_ms": fb_plain_ms, "backward_ms": ms,
          "backward_plain_ms": plain_ms, **bounds, "card": card})
    errors = [{"hidden": c["hidden"], "num_blocks": c["num_blocks"], "B": c["B"],
               "max_abs_err": c["backward"]["max_abs_err"]} for c in checks]
    return checks[-1]["backward"]["max_abs_err"], errors, ms, plain_ms, bounds


def train_config(num_timesteps=100):
    config = MultimodalBridgeMatchingConfig()
    config.bridge.num_timesteps = num_timesteps
    return config


def phase_train(device, card, workdir):
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    dm = InMemoryDataModule(
        train=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)
               for _ in range(TRAIN_BATCHES)],
        valid=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)],
    )
    config = train_config()
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config,
                      ExperimentsFiles(str(workdir / "run")), seed=SEED, ema_decay=EMA_DECAY)
    step_losses = []
    train_step = trainer.train_step

    def recording_step(batch, draws=None):
        metrics = train_step(batch, draws)
        step_losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recording_step
    torch.cuda.synchronize()

    request = gauss_noise_source_batch(CHECK_B, N, 3, 8, gen, device=device, num_empty=1)
    torch.cuda.synchronize()

    # the main path's run (fit, restore the best checkpoint, predict): every
    # count starts at 0 here and is read after predict
    epic_forward.launches = epic_backward.launches = sampler_step.launches = 0
    epic_forward_reference.calls = sampler_step_reference.calls = 0
    epic_train_forward_reference.calls = epic_backward_reference.calls = 0
    start = time.perf_counter()
    history = trainer.fit(dm, epochs=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    fit_launches = {"epic_forward": epic_forward.launches, "epic_backward": epic_backward.launches}
    trainer.train_step = train_step
    losses = [v.item() for v in step_losses]
    emit({"phase": "train", "B": TRAIN_B, "N": N, "steps": steps, "step_losses": losses,
          "epochs": history, "launches": fit_launches, "plain_calls": plain_calls(),
          "fit_seconds": fit_seconds, "fit_steps_per_s": steps / fit_seconds, "card": card})
    if fit_launches != {"epic_forward": steps + TRAIN_EPOCHS, "epic_backward": steps}:
        raise RuntimeError(f"fit launched {fit_launches}")
    finite = all(torch.isfinite(torch.tensor(losses + [r["val_loss"] for r in history])).tolist())
    if not finite or len(losses) != steps or not sum(losses[-4:]) / 4 < losses[0]:
        raise RuntimeError(f"the loss is not finite or did not fall: {losses}")

    best = torch.load(Path(trainer.files.get_checkpoint_path("best")) / "state.pt",
                      map_location=device, weights_only=True)["params"]
    with torch.no_grad():  # so that only the load can bring the values back
        for p in trainer.state.params.values():
            p.zero_()
    trainer.load_checkpoint("best")
    restored = all(torch.equal(p, best[k]) for k, p in trainer.state.params.items())
    emit({"phase": "checkpoint", "best_restored": restored})
    if not restored:
        raise RuntimeError("load_checkpoint('best') did not restore the saved params")

    out = trainer.predict([request], generator=torch.Generator(device=device).manual_seed(SEED))[0]
    torch.cuda.synchronize()
    launches = {"epic_forward": epic_forward.launches, "epic_backward": epic_backward.launches,
                "sampler_step": sampler_step.launches}
    checks = check_generated(out, request, CHECK_B)
    emit({"phase": "train_predict", "B": CHECK_B, "launches": launches,
          "plain_calls": plain_calls(), "ema": True, **checks})
    if launches != {**fit_launches, "sampler_step": 99} or plain_calls():
        raise RuntimeError(f"the training path launched {launches} and called plain "
                           f"versions {plain_calls()} times")

    # the bare step rate: host clock around synchronized steps
    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in dm.train:
        trainer.train_step(b)
    torch.cuda.synchronize()
    step_seconds = (time.perf_counter() - start) / TRAIN_BATCHES
    rate = {"phase": "train_rate", "B": TRAIN_B, "steps_per_s": 1.0 / step_seconds,
            "jets_per_s": TRAIN_B / step_seconds, "step_seconds": step_seconds, "card": card}
    emit(rate)
    READINGS["train_steps_per_s"] = rate["steps_per_s"]
    return trainer, dm, launches, rate


RANGE_PREFIXES = ("train.", "mbm.", "absorbing.", "transdim.", "Optimizer.step")


def device_operations(prof, repeats):
    """Device time by operation from a profiler window: (ms, count, name) per
    repeat, largest first, the record_function ranges left out."""

    def dev_ms(e):
        t = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if t is None else t) / 1e3 / repeats

    return sorted(((dev_ms(e), e.count // repeats, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_ms(e) > 0
                   and not e.key.startswith(RANGE_PREFIXES)), reverse=True)


def phase_profile(trainer, dm, card, workdir, step_seconds, phase="profile"):
    """Device time by kernel and by range over 3 train steps at B=8192.
    The profiler slows the host many times over, so the device's idle share
    of a step is read against the bare step time, not the profiled wall."""
    steps = 3
    torch.cuda.synchronize()
    start = time.perf_counter()
    with trainer.profile(str(workdir / "profile")) as prof:
        for b in dm.train[:steps]:
            trainer.train_step(b)
    wall_ms = (time.perf_counter() - start) * 1e3

    def range_ms(e):
        t = getattr(e, "device_time_total", None)
        return (e.cuda_time_total if t is None else t) / 1e3 / steps

    # the ranges appear twice: as host events, whose device time is the
    # sum of the kernels they launched, and as spans on the device timeline
    kernels = device_operations(prof, steps)
    ranges = {e.key: range_ms(e) for e in prof.key_averages()
              if e.key.startswith(RANGE_PREFIXES) and not str(e.device_type).endswith("CUDA")}
    device_ms = sum(k[0] for k in kernels)
    step_ms = step_seconds * 1e3
    rec = {"phase": phase, "steps": steps, "B": TRAIN_B, "profiled_wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms, "launches_per_step": sum(k[1] for k in kernels),
           "bare_step_ms": step_ms,
           "device_idle_share_of_bare_step": 1.0 - device_ms / step_ms,
           "ranges_device_ms_per_step": ranges,
           "kernels_ms_per_step": [{"ms": ms, "per_step": n, "name": name[:80]}
                                   for ms, n, name in kernels[:14]],
           "card": card}
    emit(rec)
    # one stream: the device cannot be busy for longer than the step, so a
    # kernel sum above it counts something twice
    if device_ms > 1.05 * step_ms:
        raise RuntimeError(f"profiled device time exceeds the bare step: {rec}")


def phase_train_paths(device, card, make_config=None, B=TRAIN_B, phase="train_paths", gains=False,
                      hold="params"):
    """5 steps on the kernel path and on the plain module path, same weights
    and bridge draws. Held: every parameter within PARAM_BOUND·max|leaf| of
    the other (`hold="params"`), or every step's loss within LOSS_BOUND of
    the other, relative (`hold="losses"`); both are printed, and so is the
    distance of the two paths' gradients at the first step, where weights and
    draws are still the same. At the scaled backbone the parameters are not
    held. Two thirds of its jets (at the seeded weights, phase 12) have a leaky
    or SELU input within rounding of its kink (`near_kink_jets`), where two float32 evaluations may take
    other branches of the derivative: the kernel checks leave such jets out,
    a training batch cannot. AdamW's first steps then move an element by
    about lr whatever its gradient's size, so a few elements end up to lr
    apart while the losses agree."""
    make_config = make_config or train_config
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    batches = [synthetic_training_batch(B, N, 3, 8, gen, device=device) for _ in range(5)]
    draws = [(torch.rand((B,), generator=gen, device=device),
              torch.randn((B, N, 3), generator=gen, device=device),
              torch.rand((B, N), generator=gen, device=device)) for _ in batches]
    finals, losses, first_grads = [], [], []
    for use_pallas in ("auto", False):
        config = make_config()
        config.parallel.use_pallas = use_pallas
        trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED)
        trainer.setup()
        if gains:
            set_gains(trainer, device)
        lr = config.train.lr
        step_losses = []
        for b, dr in zip(batches, draws):
            step_losses.append(trainer.train_step(b, dr)["loss"].item())
            if len(step_losses) == 1:
                first_grads.append({k: p.grad.detach().clone()
                                    for k, p in trainer.state.params.items()})
        losses.append(step_losses)
        finals.append({k: p.detach().clone() for k, p in trainer.state.params.items()})
    worst, worst_leaf, out_of_bound, elements, max_abs, far_grad, grad_diff = 0.0, None, 0, 0, 0.0, 0.0, 0.0
    for name, p in finals[0].items():
        diff = (p - finals[1][name]).abs()
        scale = finals[1][name].abs().max().clamp_min(1e-12)
        rel = (diff.max() / scale).item()
        far = diff > PARAM_BOUND * scale
        out_of_bound += int(far.sum().item())
        g = first_grads[1][name].abs()
        g_scale = g.max().clamp_min(1e-30)
        grad_diff = max(grad_diff, ((first_grads[0][name] - first_grads[1][name]).abs().max()
                                    / g_scale).item())
        if far.any():  # how large the far elements' first gradient was within its leaf
            far_grad = max(far_grad, (g[far].max() / g_scale).item())
        elements += p.numel()
        max_abs = max(max_abs, diff.max().item())
        if rel >= worst:
            worst, worst_leaf = rel, name
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    rec = {"phase": phase, "B": B, "steps": 5, "hold": hold, "max_rel_param_diff": worst,
           "worst_leaf": worst_leaf, "bound": PARAM_BOUND,
           "elements_out_of_param_bound": out_of_bound, "elements": elements,
           "max_abs_param_diff_over_lr": max_abs / lr,
           "far_elements_max_first_grad_over_leaf_max": far_grad,
           "first_step_max_grad_diff_over_leaf_max": grad_diff,
           "step_losses_kernel": losses[0], "step_losses_plain": losses[1],
           "max_rel_loss_diff": loss_diff, "loss_bound": LOSS_BOUND, "card": card}
    emit(rec)
    held = worst <= PARAM_BOUND if hold == "params" else loss_diff <= LOSS_BOUND
    if not held:
        raise RuntimeError(f"kernel and plain training paths diverge: {rec}")


def phase_paths(device, model=None, B=CHECK_B, phase="paths", n=N):
    model = model or make_model(device)
    batch = gauss_noise_source_batch(
        B, n, 3, 8, torch.Generator(device=device).manual_seed(SEED + 4), device=device,
        num_empty=1)
    out_kernel = model.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 5))
    model.config.parallel.use_pallas = False
    out_plain = model.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 5))
    model.config.parallel.use_pallas = "auto"
    real = batch.source_mask[..., 0] > 0
    mismatch = ((out_kernel.discrete != out_plain.discrete)[..., 0] & real).sum().item() / real.sum().item()
    x_plain = out_plain.continuous.abs()[real]
    dx = (out_kernel.continuous - out_plain.continuous).abs()[real]
    rel = dx / x_plain.clamp_min(1.0)
    q = torch.tensor([0.5, 0.99, 1.0], device=device)
    rec = {"phase": phase, "B": B, "N": n, "steps": 99, "token_mismatch": mismatch,
           "median_abs_dx": dx.median().item(), "max_abs_dx": dx.max().item(),
           "median_rel_dx": rel.median().item(), "max_rel_dx": rel.max().item(),
           "abs_x_q50_q99_max": torch.quantile(x_plain, q).tolist()}
    emit(rec)
    # the untrained model's flow expands |x| a hundredfold over the 99 steps
    # and rounding differences grow with it, so the bound is relative
    if mismatch > MAX_TOKEN_MISMATCH or rec["median_rel_dx"] > 1e-4:
        raise RuntimeError(f"kernel path and plain path diverge: {rec}")


def local_0_macs(d):
    """Multiply-adds a particle of local_0's particle two thirds with the x
    and discrete embeddings (Dense layers) folded into them as tables
    (ops/epic_cuda.py::tensor_core_weights): x·T_x (3·H) plus the channel
    values times T_k (8·H) with the folded input, or plus a token's row of T_k
    (H additions, counted as H/2 multiply-adds); the tables are made once a
    packing and left out."""
    return 3 * d.hidden + (8 * d.hidden if d.fold_discrete else d.hidden / 2)


def encoder_macs(d):
    """Multiply-adds of one EPiC forward, (per particle, per jet), with what
    is the same for every particle of a jet (the time third of local_0, the
    [g ‖ temb] thirds of fc_local1, the global MLP) taken once a jet, and
    local_0's particle two thirds folded with the embeddings
    (`local_0_macs`)."""
    H, Hg, Et, nb = d.hidden, d.hidden_glob, d.emb_t, d.num_blocks
    per_particle = (local_0_macs(d) + nb * 2 * H * H + H * 11
                    + (2 * 8 * d.head_hidden if d.add_discrete_head else 0))
    per_jet = (Et * H + (2 * H + Et) * H + H * H + H * Hg
               + nb * ((2 * H + Hg + Et) * H + H * Hg + (Hg + Et) * H))
    return per_particle, per_jet


def products_tensor_bound_ms(d, B, n):
    """The tensor-core bound of K4's per-particle products alone (fc_local1's
    particle third and fc_local2 of every layer, 2·H² multiply-adds a layer
    and particle), at (B, n)."""
    return roofline(2.0 * d.num_blocks * 2 * d.hidden ** 2 * B * n, 0)["tensor_bound_ms"]


def needed_products_tensor_bound_ms(d, B, n):
    """The tensor-core bound of K1's or K2's per-particle products alone, at
    (B, n): the multiply-adds the function needs a particle (`encoder_macs`'
    per particle term: local_0's particle two thirds folded, fc_local1's
    particle third and fc_local2 of every layer, the output layer's 11
    columns, the 8 → head width → 8 head at its real width, or none), not the
    padded products the kernels run (local_0 16 deep, the output layer 16
    columns, the head in 8-column tiles)."""
    per_particle, _ = encoder_macs(d)
    return roofline(2.0 * per_particle * B * n, 0)["tensor_bound_ms"]


def forward_bounds(packed, B, kind, n, ms):
    """K1's bounds at (B, n) and a call of `ms`'s share of each (1 = at the
    bound): the fp32 and the tensor bound of the whole function
    (`kernel_bound`), and the tensor bound of the per-particle products it
    needs (`needed_products_tensor_bound_ms`)."""
    bound = kernel_bound(packed, B, kind, n)
    products = needed_products_tensor_bound_ms(packed.dims, B, n)
    return {**bound_fields(bound), "products_tensor_bound_ms": products,
            "share_of_bound": bound["bound_ms"] / ms,
            "share_of_tensor_bound": bound["tensor_bound_ms"] / ms,
            "share_of_products_tensor_bound": products / ms}


def backward_macs(d):
    """Multiply-adds of the EPiC backward (the weights' gradient), (per
    particle, per jet): the forward's rerun (`encoder_macs`), then dz·Wᵀ and
    aᵀ·dz of each layer, as many multiply-adds each as the layer's forward,
    save what no gradient needs. t, x, k and mask get none, so no dz·Wᵀ runs
    into local_0's input (its time third, its particle two thirds and the
    embeddings behind them) or into the time embedding's columns of g0,
    fc_global1 and fc_local1's broadcast third. The gradients of local_0's
    particle two thirds and of the embeddings all follow from Rᵀ·dz_l0, R the
    folded input (x, 1, and the token's one-hot or the channel values): as
    many multiply-adds a particle as the folded forward (`local_0_macs`); the
    products that turn it into them are made once a call and left out."""
    rerun, rerun_jet = encoder_macs(d)
    local_0 = local_0_macs(d)
    per_particle = rerun + 2 * (rerun - local_0) + local_0
    per_jet = 3 * rerun_jet - d.emb_t * d.hidden * (2 + 2 * d.num_blocks)
    return per_particle, per_jet


def narrow_backward_products_tensor_bound_ms(d, B, n):
    """The tensor-core bound of K3's per-particle products alone, at (B, n):
    the per-particle multiply-adds the function needs (`backward_macs`), not
    the padded products the kernel runs."""
    per_particle, _ = backward_macs(d)
    return roofline(2.0 * per_particle * B * n, 0)["tensor_bound_ms"]


def backward_bounds(packed, B, n, ms):
    """K3's bounds at (B, n) and a call of `ms`'s share of each (1 = at the
    bound): the fp32 and the tensor bound of the whole function
    (`kernel_bound`), and the tensor bound of the per-particle products it
    needs (`narrow_backward_products_tensor_bound_ms`)."""
    bound = kernel_bound(packed, B, "backward", n)
    products = narrow_backward_products_tensor_bound_ms(packed.dims, B, n)
    return {**bound_fields(bound), "products_tensor_bound_ms": products,
            "share_of_bound": bound["bound_ms"] / ms,
            "share_of_tensor_bound": bound["tensor_bound_ms"] / ms,
            "share_of_products_tensor_bound": products / ms}


def wide_backward_products_tensor_bound_ms(d, B, n):
    """The tensor-core bound of K5's (128, 128, 128) products alone: per
    layer and particle the rerun's two (fc_local1's particle third,
    fc_local2), dz·Wᵀ and aᵀ·dz of each, 6·H² multiply-adds, at (B, n)."""
    return roofline(2.0 * d.num_blocks * 6 * d.hidden ** 2 * B * n, 0)["tensor_bound_ms"]


def gsdm_products_tensor_bound_ms(dim_in, n_blocks, B, n, pre_rate=False, C=128):
    """The tensor-core bound of K6's or K7's products alone (proj_in over the
    real input width, six (n, C)·(C, C) a block, K6's pre_rate; not the
    attention), at (B, n) and transformer width C."""
    macs = n * (dim_in * C + n_blocks * 6 * C * C + (C * C if pre_rate else 0))
    return roofline(2.0 * macs * B, 0)["tensor_bound_ms"]


def roofline(flops, nbytes):
    """The least time for `flops` operations and `nbytes` bytes: `bound_ms` at
    the fp32 peak of the CUDA cores, `tensor_bound_ms` with every operation
    on the tensor cores as three TF32 products (the 3×TF32 split), each the
    larger of the operations' time and the bytes' at the HBM rate."""
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    by_tensor = TF32X3_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3
    return {"bound_ms": max(by_fp32, by_bytes),
            "bound_by": "operations" if by_fp32 >= by_bytes else "bytes",
            "tensor_bound_ms": max(by_tensor, by_bytes),
            "tensor_bound_by": "operations" if by_tensor >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def against_bounds(bound, ms):
    """A timed call's rate and its share of each bound (1 = at the bound)."""
    return {"tflops": bound["flops"] / ms / 1e9, "share_of_bound": bound["bound_ms"] / ms,
            "share_of_tensor_bound": bound["tensor_bound_ms"] / ms}


BOUND_KEYS = ("bound_ms", "bound_by", "tensor_bound_ms", "tensor_bound_by")


def bound_fields(bound):
    """A roofline's two bounds, as the kernels line carries them."""
    return {key: bound[key] for key in BOUND_KEYS}


def kernel_bound(packed, B, kind, n=N):
    """The least time the card could take for one call at (B, n): the larger
    of the function's operations at the fp32 peak and its bytes (each input
    read once, each output written once) at the HBM rate. The backward's
    operations are `backward_macs`."""
    def flops(macs):
        per_particle, per_jet = macs
        return 2.0 * (per_particle * B * n + per_jet * B)

    forward_flops = flops(encoder_macs(packed.dims))
    weights = 4 * packed.flat.numel()
    slots = B * n
    # t, x, k (int32, or with the folded input the 8 float channel values), mask
    inputs = 4 * B + slots * (12 + (32 if packed.dims.fold_discrete else 4) + 4)
    flops, nbytes = {
        "forward": (forward_flops, inputs + slots * 44 + weights),
        # + the (B, n, H) hidden state out
        "forward_hidden": (forward_flops, inputs + slots * (44 + 4 * packed.dims.hidden) + weights),
        # + uniforms in, (x, k) out; ~60 operations a slot for the two updates
        "sampler_step": (forward_flops + 60.0 * slots, inputs + slots * (8 + 16) + weights),
        # + cotangent in, d(weights) out
        "backward": (flops(backward_macs(packed.dims)), inputs + slots * 44 + 2 * weights),
    }[kind]
    return roofline(flops, nbytes)


def survival_bound(head, B, n):
    """K6's bound at (B, n) and the head's transformer width C: proj_in, per
    block six (n, C)·(C, C) products and the heads' n·n scores and values (C
    multiply-adds a pair of slots over the heads together, whatever their
    count and width), pre_rate, post_rate; in: the hidden state, the mask as
    the caller holds it (int64), the time rows, the weights; out: the
    logits."""
    C, dh, nb = head.channels, head.dim_hidden, head.n_blocks
    macs_per_jet = n * dh * C + nb * (6 * n * C * C + 2 * n * n * C) + n * C * C + n * C
    nbytes = B * n * (4 * dh + 8 + 4) + 4 * nb * B * C + 4 * head.flat.numel()
    return roofline(2.0 * macs_per_jet * B, nbytes)


def gsdm_stack_bound(packed, B, n):
    """K7's bound at (B, n) and the stack's transformer width C: proj_in over
    the real input width, per block six (n, C)·(C, C) products and the
    heads' n·n scores and values (C multiply-adds a pair of slots over the
    heads together, whatever their count and width); in: the input, the
    time rows, the weights; out: the hidden state (B, n, C)."""
    C, din, nb = packed.channels, packed.dim_in, packed.n_blocks
    macs_per_jet = n * din * C + nb * (6 * n * C * C + 2 * n * n * C)
    nbytes = B * n * 4 * (din + C) + 4 * nb * B * C + 4 * packed.flat.numel()
    return roofline(2.0 * macs_per_jet * B, nbytes)


FLIPPED = {"skip": False, "head": False}


def scaled_packed(device, **flips):
    model = make_model(device, **SCALED, **flips)
    return pack_wide_encoder_params(model.encoder, model.config)


def phase_k4(device, card):
    """K4 against its plain version at the scaled backbone, per particle; once
    with skip and discrete head off; then both timed at B=8192."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    gate, results = "within_tol_per_particle", []
    for B, flips in ((CHECK_B, {}), (FLIPPED_B, FLIPPED)):
        packed = scaled_packed(device, **flips)
        t, x, k, mask = random_inputs(B, device, gen)
        got = epic_forward_wide(packed, t, x, k, mask)
        torch.cuda.synchronize()
        ref = epic_forward_reference(packed, t, x, k, mask)
        cmp = compare(got, ref)
        cmp.update(hidden=SCALED_HIDDEN, num_blocks=SCALED_BLOCKS, B=B, N=N, gate=gate,
                   skip=flips.get("skip", True), head=flips.get("head", True),
                   max_abs_ref=ref.abs().max().item(),
                   finite=bool(torch.isfinite(got).all().item()),
                   empty_jets_zero_cont=bool((got[:4, :, :3] == 0).all().item()))
        results.append(cmp)
        emit({"phase": "K4", **cmp})
        if not (cmp[gate] and cmp["finite"] and cmp["empty_jets_zero_cont"]):
            raise RuntimeError(f"K4 disagrees with its plain version: {cmp}")

    packed = scaled_packed(device)
    t, x, k, mask = random_inputs(TRAIN_B, device, gen)
    ms, plain_ms = time_pair(lambda: epic_forward_wide(packed, t, x, k, mask),
                             lambda: epic_forward_reference(packed, t, x, k, mask))
    bound = kernel_bound(packed, TRAIN_B, "forward")
    emit({"phase": "K4_time", "B": TRAIN_B, "N": N, "ms": ms, "plain_ms": plain_ms, **bound,
          **against_bounds(bound, ms),
          "products_tensor_bound_ms": products_tensor_bound_ms(packed.dims, TRAIN_B, N),
          "card": card})
    errors = [{"skip": r["skip"], "head": r["head"], "B": r["B"], "max_abs_err": r["max_abs_err"],
               "max_abs_ref": r["max_abs_ref"]} for r in results]
    return results[0]["max_abs_err"], errors, ms, plain_ms, bound


def jet_chunks(B, *tensors):
    """The tensors cut along the jet axis into chunks of SCALED_PLAIN_B jets."""
    return [tuple(a[i:i + SCALED_PLAIN_B] for a in tensors) for i in range(0, B, SCALED_PLAIN_B)]


def phase_k5(device, card):
    """K5 forward + backward against plain autograd at the scaled backbone
    under K3's rules, at B=2048, with skip and head off at B=64, and at the
    training batch B=8192, where each block of the persistent grid sums four
    times as many jets into its gradient row and contracts four times as many
    logged vector pairs. The plain backward and the near-kink window go over
    chunks of 2048 jets (both are per jet; d(flat) is the chunks' sum). The
    same bits on a repeated call; then timed at B=8192, the plain version at
    B=2048."""
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    gate, checks = "within_tol_per_particle", []
    for B, flips in ((K5_CHECK_B, {}), (FLIPPED_B, FLIPPED), (TRAIN_B, {})):
        packed = scaled_packed(device, **flips)
        t, x, k, mask = random_inputs(B, device, gen)
        near = torch.cat([near_kink_jets(packed, *c) for c in jet_chunks(B, t, x, k, mask)])
        g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
        leaf = packed.flat.clone().requires_grad_(True)
        out = epic_train_forward_wide(packed.rebind(leaf), t, x, k, mask)
        out.backward(g)
        again = epic_backward_wide(packed, t, x, k, mask, g)
        torch.cuda.synchronize()
        fwd = compare(out.detach(), epic_forward_reference(packed, t, x, k, mask))
        ref = sum(epic_backward_reference(packed, *c) for c in jet_chunks(B, t, x, k, mask, g))
        bwd = leaf_compare(leaf.grad, ref, packed)
        mult = mask[..., 0].sum(dim=1)
        kept_long = int(((~near) & (mult > 64)).sum().item())
        rec = {"phase": "K5", "hidden": SCALED_HIDDEN, "num_blocks": SCALED_BLOCKS, "B": B, "N": N,
               "skip": flips.get("skip", True), "head": flips.get("head", True),
               "plain_chunks": len(jet_chunks(B, t)),
               "forward_gate": gate, "forward": fwd, "backward": bwd,
               "near_kink_jets_left_out": int(near.sum().item()),
               "kept_jets_by_multiplicity": multiplicity_bins(mult[~near]),
               "left_out_by_multiplicity": multiplicity_bins(mult[near]),
               "kept_jets_over_64": kept_long, "kept_jets_over_64_min": B // 16,
               "same_bits_on_repeat": bool(torch.equal(again, leaf.grad)),
               "finite": bool(torch.isfinite(leaf.grad).all().item())}
        emit(rec)
        checks.append(rec)
        if not (fwd[gate] and rec["finite"] and rec["same_bits_on_repeat"]
                and not bwd["leaves_out_of_bound"]):
            raise RuntimeError(f"K5 disagrees with plain autograd: {rec}")
        if B != FLIPPED_B and kept_long < B // 16:
            raise RuntimeError(f"K5 check holds only {kept_long} jets of more than 64 particles")
    del leaf, out, again, near, ref, g

    packed = scaled_packed(device)
    t, x, k, mask = random_inputs(TRAIN_B, device, gen)
    g = torch.randn((TRAIN_B, N, 11), generator=gen, device=device)
    small = tuple(a[:SCALED_PLAIN_B].contiguous() for a in (t, x, k, mask, g))
    leaf = packed.flat.clone().requires_grad_(True)
    leaf_packed = packed.rebind(leaf)

    def kernel_fb():
        leaf.grad = None
        epic_train_forward_wide(leaf_packed, t, x, k, mask).backward(g)

    def plain_fb():
        leaf.grad = None
        epic_train_forward_reference(leaf_packed, *small[:4]).backward(small[4])

    plain = lambda: epic_backward_reference(packed, *small)
    kernel = lambda: epic_backward_wide(packed, t, x, k, mask, g)
    kernel_small = lambda: epic_backward_wide(packed, *small)
    p1, k1 = cuda_ms(plain, 3), cuda_ms(kernel, 5)
    ks, fb, fb_plain = cuda_ms(kernel_small, 5), cuda_ms(kernel_fb, 5), cuda_ms(plain_fb, 3)
    k2, p2 = cuda_ms(kernel, 5), cuda_ms(plain, 3)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    bound = kernel_bound(packed, TRAIN_B, "backward")
    emit({"phase": "K5_time", "hidden": SCALED_HIDDEN, "B": TRAIN_B, "N": N, "backward_ms": ms,
          "forward_backward_ms": fb, "plain_B": SCALED_PLAIN_B, "backward_plain_ms_at_plain_B": plain_ms,
          "forward_backward_plain_ms_at_plain_B": fb_plain, "backward_ms_at_plain_B": ks, **bound,
          **against_bounds(bound, ms),
          "products_tensor_bound_ms": wide_backward_products_tensor_bound_ms(packed.dims, TRAIN_B, N),
          "card": card})
    errors = [{"skip": c["skip"], "head": c["head"], "B": c["B"],
               "max_abs_err": c["backward"]["max_abs_err"]} for c in checks]
    return checks[-1]["backward"]["max_abs_err"], errors, ms, plain_ms, bound


def wide_counts():
    return {"epic_wide_forward": epic_forward_wide.launches,
            "epic_wide_backward": epic_backward_wide.launches}


def narrow_counts():
    return {"epic_forward": epic_forward.launches, "epic_backward": epic_backward.launches,
            "sampler_step": sampler_step.launches}


def reset_counts():
    """Every launch count and every plain version's call count to 0."""
    for fn in (epic_forward, epic_backward, sampler_step, epic_forward_wide, epic_backward_wide,
               survival_head, gsdm_stack, attention_core):
        fn.launches = 0
    for fn in (epic_forward_reference, sampler_step_reference, epic_train_forward_reference,
               epic_backward_reference, survival_head_reference, gsdm_stack_reference,
               attention_core_reference):
        fn.calls = 0


def mbm_probe(model, device, gen):
    model.forward(HybridState(*random_inputs(256, device, gen)))


def absorbing_probe(model, device, gen):
    t, x, k, mask = scattered_inputs(256, ABS_N, device, gen)
    model.forward(AbsorbingBridgeState(t, x, k, mask.long()))


def transdim_probe(model, device, gen):
    state, ts = transdim_state(256, TD_N, device, gen)
    model.network(state, ts, torch.zeros(256, dtype=torch.long, device=device))


@torch.no_grad()
def data_dependent_gains(model, device, probe=mbm_probe):
    """Data-dependent initialisation of the weight-norm gains (Salimans &
    Kingma 2016): one pass of a probe batch through the module path (`probe`:
    the family's module forward on a state of 256 jets), each weight-normed
    layer's gain divided so that the layer's output has unit standard
    deviation on the probe (the biases are 0, so dividing the gain divides
    the output). Returns log10 of the product of the divisors. With the seeded initialiser alone the scaled backbone's
    heads reach 1e5 (each of the 6 blocks adds a skip and a sum over up to
    128 particles): an untrained flow of that size overflows float32 within a
    few of the 99 steps, and a first optimizer step at lr 1e-3 moves such a
    network's outputs by orders of magnitude, whatever computes them. The
    absorbing and transdimensional families have the same EPiC trunk."""
    log10_total = 0.0

    def rescale(module, args, output):
        nonlocal log10_total
        std = output.std()
        module.g.div_(std)
        log10_total += torch.log10(std).item()
        return output / std

    hooks = [m.register_forward_hook(rescale) for m in model.modules()
             if isinstance(m, WeightNormLinear)]
    probe(model, device, torch.Generator(device=device).manual_seed(SEED + 13))
    for hook in hooks:
        hook.remove()
    return log10_total


def set_gains(trainer, device):
    """`data_dependent_gains` on a set-up trainer's live parameters, copied
    into their EMA where the trainer keeps one. Returns log10 of the product
    of the divisors."""
    divisors = data_dependent_gains(trainer.model, device)
    if trainer.state.ema_params is not None:
        with torch.no_grad():
            for name, p in trainer.state.params.items():
                trainer.state.ema_params[name].copy_(p)
    return divisors


def phase_raw_init_scaled(device, card):
    """The scaled model as `init_mbm_parameters` and `Trainer.setup` build it,
    through the kernels: one request of 1024 jets, 3 train steps at B=8192.
    What comes out is recorded, not held: with the seeded initialiser alone
    the heads reach 1e5 and the 99-step flow leaves float32 (the JAX package's
    flax initialiser does the same, scripts/scaled_init_magnitudes.py). The
    launch counts are held."""
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    request = gauss_noise_source_batch(CHECK_B, N, 3, 8, gen, device=device, num_empty=1)
    batches = [synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device) for _ in range(3)]
    reset_counts()
    model = make_model(device, **SCALED)
    heads = model.forward_kernel(HybridState(*random_inputs(CHECK_B, device, gen)))
    out = model.predict(request, generator=gen)
    real = request.source_mask[..., 0] > 0
    config = make_config(**SCALED)
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED)
    trainer.setup(steps_per_epoch=len(batches))
    losses = [trainer.train_step(b)["loss"].item() for b in batches]
    launches = wide_counts()
    emit({"phase": "raw_init_scaled", "max_abs_drift": heads.continuous.abs().max().item(),
          "max_abs_logit": heads.discrete.abs().max().item(),
          "predict_B": CHECK_B, "predict_finite_share": torch.isfinite(out.continuous[real]).float().mean().item(),
          "train_B": TRAIN_B, "step_losses": losses, "launches": launches,
          "plain_calls": plain_calls(), "card": card})
    if launches != {"epic_wide_forward": 1 + 99 + 3, "epic_wide_backward": 3} or plain_calls():
        raise RuntimeError(f"the raw-init scaled model left its kernels: {launches}, {plain_calls()}")


def phase_slice_scaled(device, card):
    """predict at the scaled backbone: 99 launches of K4 a request, the
    bridges' solver steps in plain PyTorch, no plain version of a kernel."""
    model = make_model(device, **SCALED)
    emit({"phase": "slice_scaled_init", "log10_gain_divisors": data_dependent_gains(model, device)})
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    batches = [gauss_noise_source_batch(B, N, 3, 8, gen, device=device, num_empty=1)
               for B in SCALED_REQUEST_SIZES]
    torch.cuda.synchronize()

    reset_counts()  # the scaled serving path's run starts here
    for B, batch in zip(SCALED_REQUEST_SIZES, batches):
        before = epic_forward_wide.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k4 = epic_forward_wide.launches - before
        checks = check_generated(out, batch, B)
        emit({"phase": "slice_scaled", "B": B, "N": N, "steps": k4, "K4_launches": k4,
              "seconds": seconds, "jets_per_s": B / seconds, "card": card, **checks})
        if k4 != 99:
            raise RuntimeError(f"scaled request of {B} jets launched K4 {k4} times")
    launches = wide_counts()
    emit({"phase": "slice_scaled_counts", "launches": launches, "narrow_launches": narrow_counts(),
          "plain_calls": plain_calls()})
    if plain_calls() != 0 or any(narrow_counts().values()) or launches["epic_wide_backward"]:
        raise RuntimeError("the scaled serving path left its kernels")
    return launches, model


def phase_train_scaled(device, card, workdir):
    """Trainer.fit (1 epoch of 8 batches + 1 validation batch at B=8192) and
    Trainer.predict at the scaled backbone, counted as one run; then the bare
    step rate and one profiler window."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    dm = InMemoryDataModule(
        train=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)
               for _ in range(TRAIN_BATCHES)],
        valid=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)],
    )
    config = make_config(**SCALED)
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config,
                      ExperimentsFiles(str(workdir / "run_scaled")), seed=SEED, ema_decay=EMA_DECAY)
    step_losses = []
    train_step = trainer.train_step

    def recording_step(batch, draws=None):
        metrics = train_step(batch, draws)
        step_losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recording_step
    request = gauss_noise_source_batch(CHECK_B, N, 3, 8, gen, device=device, num_empty=1)
    # the seeded weights, then the gains set from a probe batch in the live
    # parameters and in their EMA copy
    trainer.setup(steps_per_epoch=TRAIN_BATCHES)
    divisors = set_gains(trainer, device)
    torch.cuda.synchronize()

    reset_counts()  # the scaled training path's run starts here
    start = time.perf_counter()
    history = trainer.fit(dm, epochs=1)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    trainer.train_step = train_step
    fit_launches = wide_counts()
    losses = [v.item() for v in step_losses]
    emit({"phase": "train_scaled", "B": TRAIN_B, "N": N, "steps": TRAIN_BATCHES,
          "parameters": sum(p.numel() for p in trainer.model.parameters()),
          "log10_gain_divisors": divisors,
          "step_losses": losses, "epochs": history, "launches": fit_launches,
          "plain_calls": plain_calls(), "fit_seconds": fit_seconds, "card": card})
    if fit_launches != {"epic_wide_forward": TRAIN_BATCHES + 1, "epic_wide_backward": TRAIN_BATCHES}:
        raise RuntimeError(f"scaled fit launched {fit_launches}")
    finite = all(torch.isfinite(torch.tensor(losses + [r["val_loss"] for r in history])).tolist())
    if not finite or len(losses) != TRAIN_BATCHES or not sum(losses[-2:]) / 2 < losses[0]:
        raise RuntimeError(f"the scaled loss is not finite or did not fall: {losses}")

    out = trainer.predict([request], generator=torch.Generator(device=device).manual_seed(SEED))[0]
    torch.cuda.synchronize()
    launches = wide_counts()
    checks = check_generated(out, request, CHECK_B)
    emit({"phase": "train_scaled_predict", "B": CHECK_B, "launches": launches,
          "narrow_launches": narrow_counts(), "plain_calls": plain_calls(), "ema": True, **checks})
    expected = {"epic_wide_forward": TRAIN_BATCHES + 1 + 99, "epic_wide_backward": TRAIN_BATCHES}
    if launches != expected or plain_calls() or any(narrow_counts().values()):
        raise RuntimeError(f"the scaled training path launched {launches}, narrow "
                           f"{narrow_counts()}, plain versions {plain_calls()}")

    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in dm.train:
        trainer.train_step(b)
    torch.cuda.synchronize()
    step_seconds = (time.perf_counter() - start) / TRAIN_BATCHES
    emit({"phase": "train_scaled_rate", "B": TRAIN_B, "steps_per_s": 1.0 / step_seconds,
          "jets_per_s": TRAIN_B / step_seconds, "step_seconds": step_seconds, "card": card})
    phase_profile(trainer, dm, card, workdir, step_seconds, phase="profile_scaled")
    return launches


# --------------------------------------------------- the absorbing family


def scale_encoder(config, width=SCALED_HIDDEN):
    """bench.py's `_scale_encoder`: 6 blocks, hidden, global and every
    embedding 128 (or `width`: scaled-256 at 256)."""
    e = config.encoder
    e.num_blocks = SCALED_BLOCKS
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = width
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = width


def make_absorbing(device, num_timesteps=100, scaled=False, gains=False, heads=None, n=ABS_N):
    """AbsorbingFlow at AbsorbingConfig's defaults (EPiC 2 blocks, hidden 16;
    survival head 128 wide, 2 heads, 2 blocks; N=109), seeded weights; with
    `scaled` at the `--scaled` backbone (True, or a width: every width
    `scaled`), with `gains` `data_dependent_gains`, with `heads` = (width,
    count) the survival head at that width and count, with `n` that many
    particle slots."""
    config = AbsorbingConfig()
    config.bridge.num_timesteps = num_timesteps
    config.data.max_num_particles = n
    if heads:
        config.generator.transformer_dim, config.generator.n_heads = heads
    if scaled:
        scale_encoder(config, SCALED_HIDDEN if scaled is True else scaled)
    model = init_absorbing_parameters(AbsorbingFlow(config), SEED).to(device).eval()
    if gains:
        emit({"phase": "absorbing_gains", "scaled": scaled,
              "log10_gain_divisors": data_dependent_gains(model, device, absorbing_probe)})
    return model


def scattered_inputs(B, n, device, gen):
    """t in (0, 1), x, k and a random, non-prefix mask (each slot alive with
    probability 0.6) at n slots; the last jet is empty."""
    mask = (torch.rand((B, n, 1), generator=gen, device=device) < 0.6).float()
    mask[-1] = 0.0
    x = torch.randn((B, n, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, n, 1), generator=gen, device=device) * mask.long()
    t = torch.rand((B, 1, 1), generator=gen, device=device).clamp(1e-3, 1 - 1e-3)
    return t, x, k, mask


def phase_k1_hidden(device, card):
    """K1 as the absorbing family calls it: 56-wide discrete head, hidden
    output, N=109, B=4096; then timed beside its plain version."""
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    model = make_absorbing(device)
    trunk, _ = model.pack_for_kernel()
    t, x, k, mask = scattered_inputs(ABS_B, ABS_N, device, gen)
    out, hid = epic_forward(trunk, t, x, k, mask, output_hidden_local=True)
    torch.cuda.synchronize()
    ref_out, ref_hid = epic_forward_reference(trunk, t, x, k, mask, output_hidden_local=True)
    cmp_out, cmp_hid = compare(out, ref_out), compare(hid, ref_hid)
    rec = {"phase": "k1_hidden", "hidden": 16, "head_hidden": trunk.dims.head_hidden, "B": ABS_B,
           "N": ABS_N, "outputs": cmp_out, "hidden_state": cmp_hid,
           "hidden_shape": list(hid.shape), "alive_share": mask.mean().item(),
           "finite": bool(torch.isfinite(out).all().item() and torch.isfinite(hid).all().item()),
           "empty_jet_zero_cont": bool((out[-1, :, :3] == 0).all().item())}
    emit(rec)
    if not (cmp_out["within_tol"] and cmp_hid["within_tol"] and rec["finite"]
            and rec["empty_jet_zero_cont"] and rec["hidden_shape"] == [ABS_B, ABS_N, 16]):
        raise RuntimeError(f"K1's hidden output disagrees with its plain version: {rec}")
    ms, plain_ms = time_pair(
        lambda: epic_forward(trunk, t, x, k, mask, output_hidden_local=True),
        lambda: epic_forward_reference(trunk, t, x, k, mask, output_hidden_local=True))
    bounds = forward_bounds(trunk, ABS_B, "forward_hidden", ABS_N, ms)
    emit({"phase": "K1_hidden_time", "B": ABS_B, "N": ABS_N, "ms": ms, "plain_ms": plain_ms,
          **bounds, "card": card})
    return {"max_abs_err": max(cmp_out["max_abs_err"], cmp_hid["max_abs_err"]), "ms": ms,
            "plain_ms": plain_ms, **bounds,
            "B": ABS_B, "N": ABS_N, "head_hidden": trunk.dims.head_hidden}


def phase_k6(device, card):
    """K6 against its plain version at three shapes, the same bits on a
    repeat; then both timed at B=4096, N=109."""
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    model = make_absorbing(device)
    cfg_g = model.config.generator
    _, head = model.pack_for_kernel()
    errors = []
    for B, n in ABS_K6_SHAPES:
        t, _, _, mask = scattered_inputs(B, n, device, gen)
        mask_t = mask.long()
        last = torch.randn((B, n, head.dim_hidden), generator=gen, device=device)
        tp = project_time_embeddings(model.generator, t, cfg_g.n_attn_blocks, cfg_g.transformer_dim)
        got = survival_head(head, tp, last, mask_t, n_heads=cfg_g.n_heads)
        again = survival_head(head, tp, last, mask_t, n_heads=cfg_g.n_heads)
        torch.cuda.synchronize()
        ref = survival_head_reference(head, tp, last, mask_t, n_heads=cfg_g.n_heads)
        err = (got - ref).abs()
        rec = {"phase": "k6", "B": B, "N": n, "max_abs_err": err.max().item(),
               "max_abs_ref": ref.abs().max().item(), "atol": K6_TOL, "rtol": K6_TOL,
               "within_tol": bool((err <= K6_TOL + K6_TOL * ref.abs()).all().item()),
               "same_bits_on_repeat": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all().item()),
               "shape": list(got.shape), "alive_share": mask.mean().item()}
        emit(rec)
        errors.append({"B": B, "N": n, "max_abs_err": rec["max_abs_err"]})
        if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]
                and rec["shape"] == [B, n, 1]):
            raise RuntimeError(f"K6 disagrees with its plain version: {rec}")

    t, _, _, mask = scattered_inputs(ABS_B, ABS_N, device, gen)
    mask_t = mask.long()
    last = torch.randn((ABS_B, ABS_N, head.dim_hidden), generator=gen, device=device)
    tp = project_time_embeddings(model.generator, t, cfg_g.n_attn_blocks, cfg_g.transformer_dim)
    ms, plain_ms = time_pair(
        lambda: survival_head(head, tp, last, mask_t, n_heads=cfg_g.n_heads),
        lambda: survival_head_reference(head, tp, last, mask_t, n_heads=cfg_g.n_heads))
    bound = survival_bound(head, ABS_B, ABS_N)
    emit({"phase": "K6_time", "B": ABS_B, "N": ABS_N, "ms": ms, "plain_ms": plain_ms, **bound,
          "tflops": bound["flops"] / ms / 1e9, "products_tensor_bound_ms":
          gsdm_products_tensor_bound_ms(head.dim_hidden, head.n_blocks, ABS_B, ABS_N, True),
          "card": card})
    return errors[0]["max_abs_err"], errors, ms, plain_ms, bound


def absorbing_counts():
    return {"epic_forward": epic_forward.launches, "survival_head": survival_head.launches}


def check_generated_absorbing(out, batch, B, n=ABS_N):
    """What a birth-only request must give: finite kinematics of the expected
    shape, tokens in [0, 8), dead slots zero, no source slot dead."""
    x, k, mask = out.continuous, out.discrete, out.mask_t
    dead = mask == 0
    ok = {
        "shape": (tuple(x.shape) == (B, n, 3) and tuple(k.shape) == (B, n, 1)
                  and tuple(mask.shape) == (B, n, 1)),
        "finite": bool(torch.isfinite(x).all().item()),
        "tokens_in_range": bool(((k >= 0) & (k < 8)).all().item()),
        "mask_is_0_or_1": bool(((mask == 0) | (mask == 1)).all().item()),
        "dead_slots_zero": bool((x[dead.expand_as(x)] == 0).all().item()
                                and (k[dead] == 0).all().item()),
        "source_slots_alive": bool((mask[batch.source_mask > 0] == 1).all().item()),
    }
    if not all(ok.values()):
        raise RuntimeError(f"generated absorbing jets fail their checks: {ok}")
    return ok


def phase_slice_absorbing(device, card, heads=None, sizes=ABS_REQUEST_SIZES,
                          phase="slice_absorbing", n=ABS_N):
    """predict at the absorbing family's reference config (with `heads` =
    (width, count) its survival head's, with `n` particle slots): per step
    one launch of K1 (with its hidden output) and one of K6, the solver steps
    in plain PyTorch, no plain version of a kernel."""
    model = make_absorbing(device, heads=heads, n=n)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    batches = [absorbing_training_batch(B, n, 3, 8, gen, device=device, num_empty=1)
               for B in sizes]
    torch.cuda.synchronize()

    reset_counts()  # the absorbing serving path's run starts here
    for B, batch in zip(sizes, batches):
        before = absorbing_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k1 = epic_forward.launches - before["epic_forward"]
        k6 = survival_head.launches - before["survival_head"]
        checks = check_generated_absorbing(out, batch, B, n)
        emit({"phase": phase, "heads": heads, "B": B, "N": n, "steps": k6, "K1_launches": k1,
              "K6_launches": k6, "seconds": seconds, "jets_per_s": B / seconds,
              "multiplicity_in": batch.source_mask.sum().item() / B,
              "multiplicity_out": out.mask_t.sum().item() / B,
              "multiplicity_target": batch.target_mask.sum().item() / B, "card": card, **checks})
        if k1 != 99 or k6 != 99:
            raise RuntimeError(f"absorbing request of {B} jets launched K1 {k1} and K6 {k6} times")
    launches = absorbing_counts()
    others = {**narrow_counts(), **wide_counts()}
    del others["epic_forward"]
    emit({"phase": f"{phase}_counts", "launches": launches, "other_launches": others,
          "plain_calls": plain_calls()})
    if plain_calls() != 0 or any(others.values()):
        raise RuntimeError("the absorbing serving path left its kernels")
    return launches


def phase_paths_absorbing(device, model=None, phase="paths_absorbing", n=ABS_N):
    """The 99-step kernel path against the module path, same generator seed;
    `n` particle slots."""
    model = model or make_absorbing(device, n=n)
    B = ABS_PATHS_B
    batch = absorbing_training_batch(
        B, n, 3, 8, torch.Generator(device=device).manual_seed(SEED + 18), device=device,
        num_empty=1)
    outs = []
    for use_pallas in ("auto", False):
        model.config.parallel.use_pallas = use_pallas
        outs.append(model.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 19)))
    kernel, plain = outs
    slots = B * n
    mask_mismatch = (kernel.mask_t != plain.mask_t).sum().item() / slots
    token_mismatch = (kernel.discrete != plain.discrete).sum().item() / slots
    both = ((kernel.mask_t > 0) & (plain.mask_t > 0))[..., 0]
    x_plain = plain.continuous.abs()[both]
    dx = (kernel.continuous - plain.continuous).abs()[both]
    rel = dx / x_plain.clamp_min(1.0)
    rec = {"phase": phase, "B": B, "N": n, "steps": 99,
           "mask_mismatch": mask_mismatch, "token_mismatch": token_mismatch,
           "median_abs_dx": dx.median().item(), "max_abs_dx": dx.max().item(),
           "median_rel_dx": rel.median().item(), "max_rel_dx": rel.max().item(),
           "abs_x_q50_q99_max": torch.quantile(
               x_plain, torch.tensor([0.5, 0.99, 1.0], device=device)).tolist(),
           "multiplicity_out": plain.mask_t.sum().item() / B}
    emit(rec)
    if mask_mismatch > MAX_TOKEN_MISMATCH or token_mismatch > MAX_TOKEN_MISMATCH:
        raise RuntimeError(f"absorbing kernel path and module path diverge: {rec}")


def phase_train_absorbing(device, card, workdir):
    """Trainer.fit with an AbsorbingFlow (3 epochs of 8 batches + 1 validation
    batch at B=4096, N=109) and Trainer.predict, counted as one run; the bare
    step rate; profiler windows over 3 train steps and a request of 1024 jets."""
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    dm = InMemoryDataModule(
        train=[absorbing_training_batch(ABS_B, ABS_N, 3, 8, gen, device=device)
               for _ in range(TRAIN_BATCHES)],
        valid=[absorbing_training_batch(ABS_B, ABS_N, 3, 8, gen, device=device)],
    )
    config = AbsorbingConfig()
    config.bridge.num_timesteps = 100
    trainer = Trainer(AbsorbingFlow(config).to(device), config,
                      ExperimentsFiles(str(workdir / "run_absorbing")), seed=SEED,
                      ema_decay=EMA_DECAY)
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(batch, draws=None):
        metrics = train_step(batch, draws)
        step_metrics.append(metrics)
        return metrics

    trainer.train_step = recording_step
    request = absorbing_training_batch(CHECK_B, ABS_N, 3, 8, gen, device=device, num_empty=1)
    torch.cuda.synchronize()

    reset_counts()  # the absorbing training path's run starts here
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    history = trainer.fit(dm, epochs=ABS_TRAIN_EPOCHS)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    trainer.train_step = train_step
    steps = TRAIN_BATCHES * ABS_TRAIN_EPOCHS
    terms = {name: [m[name].item() for m in step_metrics] for name in step_metrics[0]}
    fit_launches = {**absorbing_counts(), **narrow_counts(), **wide_counts()}
    emit({"phase": "train_absorbing", "B": ABS_B, "N": ABS_N, "steps": steps,
          "parameters": sum(p.numel() for p in trainer.model.parameters()),
          "step_losses": terms["loss"], "first_and_last_terms":
              {name: [v[0], v[-1]] for name, v in terms.items()},
          "epochs": history, "launches": fit_launches, "plain_calls": plain_calls(),
          "fit_seconds": fit_seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    # the JAX package's absorbing loss_fn runs the flax modules, not a kernel;
    # the port's runs the nn.Modules under autograd
    if any(fit_launches.values()) or plain_calls():
        raise RuntimeError(f"absorbing training launched kernels: {fit_launches}, {plain_calls()}")
    every = [v for series in terms.values() for v in series] + [r["val_loss"] for r in history]
    losses = terms["loss"]
    if (not all(torch.isfinite(torch.tensor(every)).tolist()) or len(losses) != steps
            or not sum(losses[-4:]) / 4 < losses[0]):
        raise RuntimeError(f"the absorbing loss is not finite or did not fall: {terms}")

    out = trainer.predict([request], generator=torch.Generator(device=device).manual_seed(SEED))[0]
    torch.cuda.synchronize()
    launches = absorbing_counts()
    checks = check_generated_absorbing(out, request, CHECK_B)
    emit({"phase": "train_absorbing_predict", "B": CHECK_B, "launches": launches,
          "plain_calls": plain_calls(), "ema": True,
          "multiplicity_in": request.source_mask.sum().item() / CHECK_B,
          "multiplicity_out": out.mask_t.sum().item() / CHECK_B, **checks})
    if launches != {"epic_forward": 99, "survival_head": 99} or plain_calls():
        raise RuntimeError(f"the absorbing training path launched {launches} and called plain "
                           f"versions {plain_calls()} times")

    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in dm.train:
        trainer.train_step(b)
    torch.cuda.synchronize()
    step_seconds = (time.perf_counter() - start) / TRAIN_BATCHES
    emit({"phase": "train_absorbing_rate", "B": ABS_B, "steps_per_s": 1.0 / step_seconds,
          "jets_per_s": ABS_B / step_seconds, "step_seconds": step_seconds, "card": card})

    def top(kernels, n=12):
        return [{"ms": ms, "count": c, "name": name[:80]} for ms, c, name in kernels[:n]]

    def window(fn, repeats, name):
        """(profiled wall ms, device operations) of fn under Trainer.profile."""
        torch.cuda.synchronize()
        begin = time.perf_counter()
        with trainer.profile(str(workdir / name)) as prof:
            fn()
        return (time.perf_counter() - begin) * 1e3, device_operations(prof, repeats)

    wall_ms, kernels = window(lambda: [trainer.train_step(b) for b in dm.train[:3]], 3,
                              "profile_absorbing_train")
    device_ms = sum(k[0] for k in kernels)
    emit({"phase": "profile_absorbing", "window": "train", "steps": 3, "B": ABS_B,
          "profiled_wall_ms_per_step": wall_ms / 3, "device_ms_per_step": device_ms,
          "bare_step_ms": step_seconds * 1e3,
          "device_idle_share_of_bare_step": 1.0 - device_ms / (step_seconds * 1e3),
          "launches_per_step": sum(k[1] for k in kernels),
          "operations_ms_per_step": top(kernels), "card": card})

    trainer.model.eval()
    serve_gen = torch.Generator(device=device).manual_seed(SEED + 21)
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.model.predict(request, generator=serve_gen)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - start) * 1e3
    wall_ms, kernels = window(lambda: trainer.model.predict(request, generator=serve_gen), 1,
                              "profile_absorbing_request")
    device_ms = sum(k[0] for k in kernels)
    emit({"phase": "profile_absorbing", "window": "request", "B": CHECK_B, "N": ABS_N,
          "profiled_wall_ms": wall_ms, "device_ms": device_ms, "bare_request_ms": request_ms,
          "device_idle_share_of_bare_request": 1.0 - device_ms / request_ms,
          "launches": sum(k[1] for k in kernels),
          "operations_ms": top(kernels), "card": card})
    return launches


def absorbing_phases(device, card, build_dir):
    """Phases 18-23 at the absorbing family's reference config; K6's entry of
    the kernels line and what K1's entry gains. `launches` is the count of the
    absorbing serving path's run (two requests)."""
    k1 = phase_k1_hidden(device, card)
    k6_err, k6_errors, k6_ms, k6_plain, k6_bound = phase_k6(device, card)
    serving = phase_slice_absorbing(device, card)
    phase_paths_absorbing(device)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        train = phase_train_absorbing(device, card, Path(tmp))
    by_path = {"serving_absorbing": serving["survival_head"], "train_absorbing": train["survival_head"]}
    k1["launches_by_path"] = {"serving_absorbing": serving["epic_forward"],
                              "train_absorbing": train["epic_forward"]}
    # no one PyTorch call computes the head (GroupNorm, six products and
    # attention a block, chained): no library time
    entry = {"name": "survival_head", "route": "cuda",
             "source": "multimodal_particles_tpu_torch/ops/csrc/survival_head.cu",
             "replaces": "multimodal_particles_tpu/ops/survival_pallas.py:324",
             "launches": serving["survival_head"], "launches_by_path": by_path,
             "max_abs_err": k6_err, "max_abs_err_by_check": k6_errors,
             "ms": k6_ms, "plain_ms": k6_plain, **bound_fields(k6_bound), "library_ms": None,
             "timed_at": {"B": ABS_B, "N": ABS_N, "transformer_dim": 128, "n_heads": 2,
                          "n_attn_blocks": 2}}
    return entry, k1


def make_transdim(device, prior_batch=None, scaled=False, gains=False, heads=None, n=TD_N):
    """The transdimensional model at its reference config with the sampler of
    the JAX bench's transdim line (48 steps, multi_birth 24), seeded weights,
    and a multiplicity prior from `prior_batch`'s multiplicities; with
    `scaled` at the `--scaled` backbone (True, or a width: every width
    `scaled`), with `gains` `data_dependent_gains`, with `heads` = (width,
    count) the gsdm stacks at that width and count, with `n` that many
    particle slots."""
    config = TransdimensionalEpicConfig()
    if heads:
        config.encoder.transformer_dim, config.encoder.n_heads = heads
    config.data.max_num_particles = n
    config.sampler_kwargs.dt = 1.0 / TD_STEPS
    config.sampler_kwargs.multi_birth = TD_MULTI_BIRTH
    if scaled:
        scale_encoder(config, SCALED_HIDDEN if scaled is True else scaled)
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), SEED)
    if prior_batch is not None:
        attach_prior(model, prior_batch)
    model = model.to(device).eval()
    if gains:
        emit({"phase": "transdim_gains", "scaled": scaled,
              "log10_gain_divisors": data_dependent_gains(model, device, transdim_probe)})
    return model


def attach_prior(model, batch):
    model.graphical_structure = SimpleNamespace(
        nodes_dist=DistributionNodes(multiplicity_histogram(batch[0])))


def transdim_state(B, n, device, gen):
    """A noisy state as the sampler meets it: prefix masks with dims uniform
    in [1, n] and jet 0 at dims = 1, kinematics, noisy one-hot channel values,
    times in (0, 1]."""
    dims, x, one_hot = transdim_training_batch(B, n, 3, 8, gen, device=device)
    dims[0] = 1
    live = (torch.arange(n, device=device)[None, :] < dims[:, None]).float()[..., None]
    values = (one_hot + 0.3 * torch.randn(one_hot.shape, generator=gen, device=device)) * live
    ts = torch.rand((B,), generator=gen, device=device).clamp(1e-3, 1.0)
    return StructuredState(x * live, values, dims), ts


def phase_k1_fold(device, card):
    """K1 as the transdimensional family calls it: the folded Linear-discrete
    input, no discrete head, hidden output, global width 19, N=128, B=4096;
    then timed beside its plain version."""
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    model = make_transdim(device)
    trunk, _, _ = model.pack_for_kernel()
    state, ts = transdim_state(TD_B, TD_N, device, gen)
    args = (trunk, ts.reshape(TD_B, 1, 1), state.continuous, state.discrete,
            state.particle_mask()[:, :, None])
    out, hid = epic_forward(*args, output_hidden_local=True)
    torch.cuda.synchronize()
    ref_out, ref_hid = epic_forward_reference(*args, output_hidden_local=True)
    cmp_out, cmp_hid = compare(out, ref_out), compare(hid, ref_hid)
    rec = {"phase": "k1_fold", "hidden": trunk.dims.hidden, "hidden_glob": trunk.dims.hidden_glob,
           "fold_discrete": trunk.dims.fold_discrete,
           "add_discrete_head": trunk.dims.add_discrete_head, "B": TD_B, "N": TD_N,
           "outputs": cmp_out, "hidden_state": cmp_hid, "hidden_shape": list(hid.shape),
           "dims_of_jet_0": int(state.dims[0].item()), "mean_dims": state.dims.float().mean().item(),
           "finite": bool(torch.isfinite(out).all().item() and torch.isfinite(hid).all().item())}
    emit(rec)
    if not (cmp_out["within_tol"] and cmp_hid["within_tol"] and rec["finite"]
            and rec["fold_discrete"] and not rec["add_discrete_head"] and rec["hidden_glob"] == 19
            and rec["hidden_shape"] == [TD_B, TD_N, 16]):
        raise RuntimeError(f"K1's folded input disagrees with its plain version: {rec}")
    ms, plain_ms = time_pair(lambda: epic_forward(*args, output_hidden_local=True),
                             lambda: epic_forward_reference(*args, output_hidden_local=True))
    bounds = forward_bounds(trunk, TD_B, "forward_hidden", TD_N, ms)
    emit({"phase": "K1_fold_time", "B": TD_B, "N": TD_N, "ms": ms, "plain_ms": plain_ms, **bounds,
          "card": card})
    return {"max_abs_err": max(cmp_out["max_abs_err"], cmp_hid["max_abs_err"]), "ms": ms,
            "plain_ms": plain_ms, **bounds,
            "B": TD_B, "N": TD_N, "hidden_glob": 19, "fold_discrete": True}


def phase_k7(device, card, build_log):
    """K7 against its plain version at four shapes, the same bits on a repeat;
    then both timed at (4096, 128, 27)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    model = make_transdim(device)
    net, n_heads = model.network, model.config.encoder.n_heads
    _, rate_stack, vec_stack = model.pack_for_kernel()
    stacks = {24: (rate_stack, net.blocks()[0]), 27: (vec_stack, net.blocks("vec_")[0])}

    def case(B, n, din):
        packed, res_blocks = stacks[din]
        x_in = torch.randn((B, n, din), generator=gen, device=device)
        ts = torch.rand((B,), generator=gen, device=device)
        with torch.no_grad():
            tp = stack_time_embeddings(net.time_embedding(ts), res_blocks)
        return packed, tp, x_in

    errors = []
    for B, n, din in TD_K7_SHAPES:
        packed, tp, x_in = case(B, n, din)
        got = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
        again = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
        torch.cuda.synchronize()
        ref = gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads)
        err = (got - ref).abs()
        rec = {"phase": "k7", "B": B, "N": n, "Din": din, "max_abs_err": err.max().item(),
               "max_abs_ref": ref.abs().max().item(), "atol": K7_TOL, "rtol": K7_TOL,
               "within_tol": bool((err <= K7_TOL + K7_TOL * ref.abs()).all().item()),
               "same_bits_on_repeat": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all().item()), "shape": list(got.shape)}
        emit(rec)
        errors.append({"B": B, "N": n, "Din": din, "max_abs_err": rec["max_abs_err"]})
        if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]
                and rec["shape"] == [B, n, 128]):
            raise RuntimeError(f"K7 disagrees with its plain version: {rec}")

    packed, tp, x_in = case(TD_B, TD_N, 27)
    ms, plain_ms = time_pair(lambda: gsdm_stack(packed, tp, x_in, n_heads=n_heads),
                             lambda: gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads))
    bound = gsdm_stack_bound(packed, TD_B, TD_N)
    lines = build_log.splitlines()
    # ptxas -v, an entry: "Compiling entry function", "Function properties", the stack
    # frame and spills, the registers
    ptxas = [f"{lines[i + 2].strip()}; {lines[i + 3].strip()}" for i, line in enumerate(lines[:-3])
             if "gsdm_stack_kernel" in line and "Compiling entry" in line]
    emit({"phase": "K7_time", "B": TD_B, "N": TD_N, "Din": 27, "ms": ms, "plain_ms": plain_ms,
          **bound, "tflops": bound["flops"] / ms / 1e9, "products_tensor_bound_ms":
          gsdm_products_tensor_bound_ms(27, packed.n_blocks, TD_B, TD_N), "ptxas": ptxas,
          "card": card})
    return errors[1]["max_abs_err"], errors, ms, plain_ms, bound


def transdim_counts():
    return {"epic_forward": epic_forward.launches, "gsdm_stack": gsdm_stack.launches}


def check_generated_transdim(out, B, n=TD_N):
    """What a request must give: finite latents of the expected shape,
    1 ≤ dims ≤ N, rows from dims on zero, the live rows centred."""
    x, values, dims = out.continuous, out.discrete, out.dims
    dead = (torch.arange(n, device=x.device)[None, :] >= dims[:, None])[..., None]
    live = (~dead).float()
    centre = (x * live).sum(dim=1).abs().max().item()
    scale = max(x.abs().max().item(), 1.0)
    ok = {
        "shape": (tuple(x.shape) == (B, n, 3) and tuple(values.shape) == (B, n, 8)
                  and tuple(dims.shape) == (B,)),
        "finite": bool(torch.isfinite(x).all().item() and torch.isfinite(values).all().item()),
        "dims_in_range": bool(((dims >= 1) & (dims <= n)).all().item()),
        "dead_rows_zero": bool((x[dead.expand_as(x)] == 0).all().item()
                               and (values[dead.expand_as(values)] == 0).all().item()),
        # a sum of up to n float32 values of the jets' scale
        "centred": centre <= 1e-5 * n * scale,
    }
    if not all(ok.values()):
        raise RuntimeError(f"generated transdimensional jets fail their checks: {ok}")
    return {**ok, "max_abs_x": scale, "centre_of_mass": centre}


def phase_slice_transdim(device, card, heads=None, sizes=TD_REQUEST_SIZES,
                         phase="slice_transdim", n=TD_N):
    """predict at the transdimensional family's reference config (with
    `heads` = (width, count) its gsdm stacks', with `n` particle slots): per
    network evaluation one launch of K1 (folded input, hidden output) and two
    of K7, everything between them plain PyTorch, no plain version of a
    kernel."""
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    batches = [transdim_training_batch(B, n, 3, 8, gen, device=device) for B in sizes]
    model = make_transdim(device, batches[0], heads=heads, n=n)
    prior_mean = batches[0][0].float().mean().item()
    torch.cuda.synchronize()

    reset_counts()  # the transdimensional serving path's run starts here
    for B, batch in zip(sizes, batches):
        before = transdim_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k1 = epic_forward.launches - before["epic_forward"]
        k7 = gsdm_stack.launches - before["gsdm_stack"]
        nfe = k1  # a network evaluation launches K1 once
        checks = check_generated_transdim(out, B, n)
        mean_out = out.dims.float().mean().item()
        emit({"phase": phase, "heads": heads, "B": B, "N": n, "steps": TD_STEPS, "nfe": nfe,
              "K1_launches": k1, "K7_launches": k7, "seconds": seconds,
              "jets_per_s": B / seconds, "multiplicity_prior": prior_mean,
              "multiplicity_out": mean_out, "card": card, **checks})
        if (k1, k7, nfe) != (TD_STEPS, 2 * TD_STEPS, TD_STEPS):
            raise RuntimeError(f"transdim request of {B} jets: K1 {k1}, K7 {k7}, NFE {nfe}")
        if abs(mean_out - prior_mean) > MAX_MULTIPLICITY_SHIFT * prior_mean:
            raise RuntimeError(f"mean multiplicity {mean_out} against the prior's {prior_mean}")
    launches = transdim_counts()
    others = {**narrow_counts(), **wide_counts(), "survival_head": survival_head.launches}
    del others["epic_forward"]
    emit({"phase": f"{phase}_counts", "launches": launches, "other_launches": others,
          "plain_calls": plain_calls()})
    if plain_calls() != 0 or any(others.values()):
        raise RuntimeError("the transdimensional serving path left its kernels")
    return launches


def jet_divergence(got, ref):
    """Two generated batches compared jet by jet: the share of jets of equal
    multiplicity and, over those, |Δx| relative to the jet's scale (its
    largest |x| in `ref`, at least 1): the flow expands |x| to 1e19 and more,
    so an entry near 0 of such a jet makes an elementwise ratio meaningless."""
    same = got.dims == ref.dims
    x_ref = ref.get_flat_lats()[same].abs()
    dx = (got.get_flat_lats() - ref.get_flat_lats())[same].abs()
    jet_rel = dx.amax(dim=1) / x_ref.amax(dim=1).clamp_min(1.0)
    return same, x_ref, dx, {
        "equal_dims_share": same.float().mean().item(),
        "median_jet_rel_dx": jet_rel.median().item(), "max_jet_rel_dx": jet_rel.max().item(),
        "jets_over_1e-3_of_their_scale": int((jet_rel > 1e-3).sum().item())}


def jet_err_over_bound(got, ref, tol):
    """Per jet: the largest |got − ref| over the jet's entries where `ref` is
    finite, over the bound tol·(1 + the largest such |ref|); inf where `got`
    is not finite and `ref` is. Where `ref` itself is not finite (the seeded
    flow reaches |x| ≈ 1e21, whose squares in a GroupNorm float32 cannot
    hold) the plain version has no value to hold the kernel to; those
    entries are counted apart (`not_finite_jets`)."""
    B = ref.shape[0]
    got, ref = got.reshape(B, -1), ref.reshape(B, -1)
    defined = torch.isfinite(ref)
    err = torch.where(defined, (got - ref).abs().nan_to_num(nan=torch.inf), 0.0).amax(dim=1)
    return err / (tol * (1.0 + torch.where(defined, ref.abs(), 0.0).amax(dim=1)))


def not_finite_jets(got, ref):
    """Per jet: (`ref` not finite somewhere, and `got` finite at every such
    entry: the kernel gives a value where the plain version has none)."""
    B = ref.shape[0]
    got, ref = got.reshape(B, -1), ref.reshape(B, -1)
    undefined = ~torch.isfinite(ref)
    return undefined.any(dim=1), undefined.any(dim=1) & ~(undefined & ~torch.isfinite(got)).any(dim=1)


def gsdm_stack_float64(packed, temb_projected, x_in, n_heads):
    """K7's plain version evaluated in float64 on the same weights."""
    W = {name: t.double() for name, t in packed.tensors.items()}
    h = x_in.double() @ W["w_in"][:packed.dim_in] + W["b_in"]
    return blocks_reference(W, h, [t.double() for t in temb_projected], packed.n_blocks, n_heads)


class KernelShadow:
    """Within `with`: the transdimensional network's kernels as
    `forward_kernel` calls them (the trunk's, K1 or K4, and K7), each call
    also through its plain version on the same inputs. `trunk` and `stack`
    hold per call each jet's error over its bound (`jet_err_over_bound`, the
    trunk at ATOL, K7 at K7_TOL): along the flow the inputs reach 1e21 and
    a jet's entries are coupled through its GroupNorm and attention, so the
    bound scales with the jet's largest output. `undefined` and
    `kernel_only` hold per call and kernel the jets of `not_finite_jets`.
    K7's plain version is float32 and is itself only so close to the
    function: past 128 slots, on a jet where it is finite but misses K7's
    gate against its own float64 evaluation (`gsdm_stack_float64`; on the
    scaled-256 flow at N = 256 the worst such jet was 1.17 of the gate from
    it), K7 is held to the float64 evaluation instead; `plain_off` holds those
    jets per call."""

    def __enter__(self):
        m = transdim_module
        self.trunk, self.stack, self.plain_off = [], [], []
        self.undefined = {"trunk": [], "gsdm_stack": []}
        self.kernel_only = {"trunk": [], "gsdm_stack": []}
        self.saved = m.epic_forward, m.epic_forward_wide, m.gsdm_stack
        m.epic_forward, m.epic_forward_wide = self._trunk(epic_forward), self._trunk(epic_forward_wide)
        m.gsdm_stack = self._stack
        return self

    def __exit__(self, *exc):
        m = transdim_module
        m.epic_forward, m.epic_forward_wide, m.gsdm_stack = self.saved

    def _count(self, name, got, ref):
        undefined, kernel_only = not_finite_jets(got, ref)
        self.undefined[name].append(undefined)
        self.kernel_only[name].append(kernel_only)

    def _trunk(self, kernel):
        def run(packed, t, x, k, mask, output_hidden_local=False):
            out, hid = kernel(packed, t, x, k, mask, output_hidden_local=True)
            ref_out, ref_hid = epic_forward_reference(packed, t, x, k, mask, True)
            self.trunk.append(torch.maximum(jet_err_over_bound(out, ref_out, ATOL),
                                            jet_err_over_bound(hid, ref_hid, ATOL)))
            self._count("trunk", torch.cat([out, hid], -1), torch.cat([ref_out, ref_hid], -1))
            return (out, hid) if output_hidden_local else out
        return run

    def _stack(self, packed, temb, x_in, *, n_heads):
        got = gsdm_stack(packed, temb, x_in, n_heads=n_heads)
        ref = gsdm_stack_reference(packed, temb, x_in, n_heads=n_heads)
        err = jet_err_over_bound(got, ref, K7_TOL)
        off = torch.zeros_like(err, dtype=torch.bool)
        if x_in.shape[1] > 128:
            exact = gsdm_stack_float64(packed, temb, x_in, n_heads)
            finite = torch.isfinite(ref).reshape(ref.shape[0], -1).all(dim=1)
            off = finite & (jet_err_over_bound(ref.double(), exact, K7_TOL) > 1.0)
            err = torch.where(off, jet_err_over_bound(got.double(), exact, K7_TOL).float(), err)
        self.stack.append(err)
        self.plain_off.append(off)
        self._count("gsdm_stack", got, ref)
        return got

    def worst(self):
        """The largest error over bound of each kernel; the calls; and summed
        over calls, the jets where the plain version is not finite and, of
        those, the ones where the kernel is, and the jets where K7 was held to
        the float64 evaluation."""
        def total(per_call):
            return {name: int(torch.stack(v).sum().item()) for name, v in per_call.items()}
        return {"trunk": torch.stack(self.trunk).max().item(),
                "gsdm_stack": torch.stack(self.stack).max().item(),
                "calls": [len(self.trunk), len(self.stack)],
                "jet_calls_plain_not_finite": total(self.undefined),
                "of_those_kernel_finite": total(self.kernel_only),
                "jet_calls_k7_held_to_float64": int(torch.stack(self.plain_off).sum().item())}


def transdim_path_draws(B, gen, device, n=TD_N):
    """Every draw of a 48-step request at n slots: the initial state, the
    chain's uniforms, the Gumbel noise of the nearest atom, and two normals a
    step."""
    D, kw = n * 11, dict(generator=gen, device=device)
    return {"init": torch.randn((B, D), **kw), "em_noise": torch.randn((TD_STEPS, B, D), **kw),
            "birth_noise": torch.randn((TD_STEPS, B, D), **kw),
            "u_chain": torch.rand((TD_STEPS, B, TD_MULTI_BIRTH), **kw),
            "gumbel": sample_gumbel((TD_STEPS, B, n), gen, device)}


def nudged_draws(draws):
    """The same draws moved by 1 ulp: the initial state ×(1 ± 2⁻²³), every
    step's Euler-Maruyama noise ×(1 + 2⁻²³)."""
    return {"init_up": {**draws, "init": draws["init"] * (1 + ULP)},
            "init_down": {**draws, "init": draws["init"] * (1 - ULP)},
            "em_noise_up": {**draws, "em_noise": draws["em_noise"] * (1 + ULP)}}


def phase_paths_transdim(device, scaled=False, phase="paths_transdim", weights=None, n=TD_N):
    """The 48-step kernel path against the module path from the same injected
    draws. Beside it, as the yardstick of the flow's own sensitivity, the
    module path against itself from draws 1 ulp away (`nudged_draws`): a
    rounding can flip a birth or a nearest atom and part a jet for good, and
    the flow expands what parts to 1e15 of the other's scale. Checks: the
    final dims equal on ≥ 95% of the jets; at most PART_FACTOR × the worst
    nudge's parted jets and PART_SLACK more; every kernel call of the kernel
    path within its bound of its plain version on the same inputs
    (`KernelShadow`), the states on which jets part included. `weights`
    (by name) replace the seeded ones: a trained model's flow; `n` particle
    slots. Returns the line."""
    B = TD_PATHS_B
    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    batch = transdim_training_batch(B, n, 3, 8, gen, device=device)
    model = make_transdim(device, batch, scaled=scaled, gains=bool(scaled), n=n)
    if weights is not None:
        quality.load_weights(model, weights)
    draws = transdim_path_draws(B, gen, device, n)
    model.config.parallel.use_pallas = True
    with KernelShadow() as shadow:
        kernel = model.predict(batch, draws=draws)
    model.config.parallel.use_pallas = False
    plain = model.predict(batch, draws=draws)
    yardstick = {name: jet_divergence(model.predict(batch, draws=nudged), plain)[3]
                 for name, nudged in nudged_draws(draws).items()}
    same, x_plain, dx, by_jet = jet_divergence(kernel, plain)
    rel = dx / x_plain.clamp_min(1.0)
    nudged_parted = max(y["jets_over_1e-3_of_their_scale"] for y in yardstick.values())
    allowed = PART_FACTOR * nudged_parted + PART_SLACK
    rec = {"phase": phase, "B": B, "N": n, "steps": TD_STEPS, **by_jet,
           "parted_jets_allowed": allowed, "module_vs_module_1ulp": yardstick,
           "kernel_err_over_bound": shadow.worst(),
           "median_rel_dx": rel.median().item(), "max_rel_dx": rel.max().item(),
           "median_abs_dx": dx.median().item(), "max_abs_dx": dx.max().item(),
           "max_abs_x": x_plain.max().item(), "mean_dims": plain.dims.float().mean().item()}
    emit(rec)
    worst = rec["kernel_err_over_bound"]
    if (rec["equal_dims_share"] < MIN_EQUAL_DIMS or by_jet["jets_over_1e-3_of_their_scale"] > allowed
            or not (worst["trunk"] <= 1.0 and worst["gsdm_stack"] <= 1.0)):
        raise RuntimeError(f"transdim kernel path and module path diverge: {rec}")
    return rec


def phase_train_transdim(device, card, workdir):
    """Trainer.fit with the transdimensional model (3 epochs of 8 batches + 1
    validation batch at B=1024, N=128) and Trainer.predict, counted as one
    run; the bare step rate; profiler windows over 3 train steps and a request
    of 1024 jets."""
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    B = TD_TRAIN_B

    def batch():
        return transdim_training_batch(B, TD_N, 3, 8, gen, device=device)

    dm = InMemoryDataModule(train=[batch() for _ in range(TRAIN_BATCHES)], valid=[batch()])
    config = TransdimensionalEpicConfig()
    config.data.max_num_particles = TD_N
    config.sampler_kwargs.dt, config.sampler_kwargs.multi_birth = 1.0 / TD_STEPS, TD_MULTI_BIRTH
    config.batch_size, config.optimizer_kwargs.lr = B, TD_LR
    model = TransdimensionalJumpDiffusion(config).to(device)
    attach_prior(model, [torch.cat([b[0] for b in dm.train])])
    trainer = Trainer(model, config, ExperimentsFiles(str(workdir / "run_transdim")), seed=SEED)
    trainer.setup(TRAIN_BATCHES)
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(batch, draws=None):
        metrics = train_step(batch, draws)
        step_metrics.append(metrics)
        return metrics

    trainer.train_step = recording_step
    request = batch()
    fixed = (torch.rand((B,), generator=gen, device=device),
             torch.poisson(torch.full((B,), 20.0, device=device), generator=gen),
             torch.randn((B, TD_N * 11), generator=gen, device=device))

    def fixed_loss():
        with torch.no_grad():
            return {k: v.item() for k, v in model.loss_fn(dm.valid[0], draws=fixed)[1].items()}

    before = fixed_loss()
    torch.cuda.synchronize()

    reset_counts()  # the transdimensional training path's run starts here
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    history = trainer.fit(dm, epochs=TD_TRAIN_EPOCHS)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    trainer.train_step = train_step
    steps = TRAIN_BATCHES * TD_TRAIN_EPOCHS
    terms = {name: [m[name].item() for m in step_metrics] for name in step_metrics[0]}
    fit_launches = {**transdim_counts(), **narrow_counts(), **wide_counts(),
                    "survival_head": survival_head.launches}
    fit_plain = plain_calls()
    after = fixed_loss()
    emit({"phase": "train_transdim", "B": B, "N": TD_N, "steps": steps, "lr": TD_LR,
          "ema_decay": trainer.ema_decay,
          "parameters": sum(p.numel() for p in trainer.model.parameters()),
          "step_losses": terms["loss"], "first_and_last_terms":
              {name: [v[0], v[-1]] for name, v in terms.items()},
          "fixed_batch_terms_before_and_after": {k: [before[k], after[k]] for k in before},
          "epochs": history, "launches": fit_launches, "plain_calls": fit_plain,
          "fit_seconds": fit_seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    # the JAX package's transdimensional loss runs the flax modules under
    # jax.grad, not a kernel; the port's runs the nn.Modules under autograd
    if any(fit_launches.values()) or fit_plain:
        raise RuntimeError(f"transdim training launched kernels: {fit_launches}, {fit_plain}")
    every = ([v for series in terms.values() for v in series] + [r["val_loss"] for r in history]
             + list(before.values()) + list(after.values()))
    if (not all(torch.isfinite(torch.tensor(every)).tolist()) or len(terms["loss"]) != steps
            or not after["loss"] < before["loss"]):
        raise RuntimeError(f"the transdim loss is not finite or did not fall: {before} → {after}")

    out = trainer.predict([request], generator=torch.Generator(device=device).manual_seed(SEED))[0]
    torch.cuda.synchronize()
    launches = transdim_counts()
    checks = check_generated_transdim(out, B)
    emit({"phase": "train_transdim_predict", "B": B, "launches": launches,
          "plain_calls": plain_calls(), "ema": True,
          "multiplicity_prior": torch.cat([b[0] for b in dm.train]).float().mean().item(),
          "multiplicity_out": out.dims.float().mean().item(), **checks})
    if launches != {"epic_forward": TD_STEPS, "gsdm_stack": 2 * TD_STEPS} or plain_calls():
        raise RuntimeError(f"the transdim training path's predict launched {launches} and called "
                           f"plain versions {plain_calls()} times")

    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in dm.train:
        trainer.train_step(b)
    torch.cuda.synchronize()
    step_seconds = (time.perf_counter() - start) / TRAIN_BATCHES
    emit({"phase": "train_transdim_rate", "B": B, "steps_per_s": 1.0 / step_seconds,
          "jets_per_s": B / step_seconds, "step_seconds": step_seconds, "card": card})

    def top(kernels, n=12):
        return [{"ms": ms, "count": c, "name": name[:80]} for ms, c, name in kernels[:n]]

    def window(fn, repeats, name):
        """(profiled wall ms, device operations) of fn under Trainer.profile."""
        torch.cuda.synchronize()
        begin = time.perf_counter()
        with trainer.profile(str(workdir / name)) as prof:
            fn()
        return (time.perf_counter() - begin) * 1e3, device_operations(prof, repeats)

    wall_ms, kernels = window(lambda: [trainer.train_step(b) for b in dm.train[:3]], 3,
                              "profile_transdim_train")
    device_ms = sum(k[0] for k in kernels)
    emit({"phase": "profile_transdim", "window": "train", "steps": 3, "B": B,
          "profiled_wall_ms_per_step": wall_ms / 3, "device_ms_per_step": device_ms,
          "bare_step_ms": step_seconds * 1e3,
          "device_idle_share_of_bare_step": 1.0 - device_ms / (step_seconds * 1e3),
          "launches_per_step": sum(k[1] for k in kernels),
          "operations_ms_per_step": top(kernels), "card": card})

    trainer.model.eval()
    serve_gen = torch.Generator(device=device).manual_seed(SEED + 27)
    for request_b in (B, TD_B):
        request = transdim_training_batch(request_b, TD_N, 3, 8, gen, device=device)
        request_ms = []
        for _ in range(2):  # the second is the bare request: the first may allocate
            torch.cuda.synchronize()
            start = time.perf_counter()
            trainer.model.predict(request, generator=serve_gen)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - start) * 1e3)
        wall_ms, kernels = window(lambda: trainer.model.predict(request, generator=serve_gen), 1,
                                  f"profile_transdim_request_{request_b}")
        device_ms = sum(k[0] for k in kernels)
        emit({"phase": "profile_transdim", "window": "request", "B": request_b, "N": TD_N,
              "profiled_wall_ms": wall_ms, "device_ms": device_ms,
              "first_request_ms": request_ms[0], "bare_request_ms": request_ms[1],
              "device_idle_share_of_bare_request": 1.0 - device_ms / request_ms[1],
              "launches": sum(k[1] for k in kernels),
              "operations_ms": top(kernels), "card": card})
    return launches


def transdim_phases(device, card, build_dir, build_log):
    """Phases 24-29 at the transdimensional family's reference config; K7's
    entry of the kernels line and what K1's entry gains. `launches` is the
    count of the transdimensional serving path's run (two requests)."""
    k1 = phase_k1_fold(device, card)
    k7_err, k7_errors, k7_ms, k7_plain, k7_bound = phase_k7(device, card, build_log)
    serving = phase_slice_transdim(device, card)
    phase_paths_transdim(device)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        train = phase_train_transdim(device, card, Path(tmp))
    by_path = {"serving_transdim": serving["gsdm_stack"], "train_transdim": train["gsdm_stack"]}
    k1["launches_by_path"] = {"serving_transdim": serving["epic_forward"],
                              "train_transdim": train["epic_forward"]}
    # no one PyTorch call computes the stack (GroupNorm, six products and
    # attention a block, chained): no library time
    entry = {"name": "gsdm_stack", "route": "cuda",
             "source": "multimodal_particles_tpu_torch/ops/csrc/gsdm_stack.cu",
             "replaces": "multimodal_particles_tpu/ops/gsdm_stack_pallas.py:173",
             "launches": serving["gsdm_stack"], "launches_by_path": by_path,
             "max_abs_err": k7_err, "max_abs_err_by_check": k7_errors,
             "ms": k7_ms, "plain_ms": k7_plain, **bound_fields(k7_bound), "library_ms": None,
             "timed_at": {"B": TD_B, "N": TD_N, "Din": 27, "transformer_dim": 128, "n_heads": 2,
                          "n_attn_blocks": 2}}
    return entry, k1


# ------------------ the absorbing and transdimensional families at `--scaled`


def phase_k4_family(device, card, family, width=SCALED_HIDDEN):
    """K4 as the scaled absorbing generator (56-wide head, hidden output,
    N=109, phase "k4_hidden_head") or the scaled transdimensional trunk
    (folded input, no head, hidden output, N=128, phase "k4_fold") calls it,
    at B=4096, seeded weights, per particle, the same bits on a repeat; then
    both timed. `width`: the backbone's widths (scaled-256 at 256, phases
    with "_256" at the end)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 28)
    tag = "" if width == SCALED_HIDDEN else f"_{width}"
    if family == "absorbing":
        phase, B, n = f"k4_hidden_head{tag}", ABS_B, ABS_N
        trunk, _ = make_absorbing(device, scaled=width).pack_for_kernel()
        args = (trunk, *scattered_inputs(B, n, device, gen))
    else:
        phase, B, n = f"k4_fold{tag}", TD_B, TD_N
        trunk, _, _ = make_transdim(device, scaled=width).pack_for_kernel()
        state, ts = transdim_state(B, n, device, gen)
        args = (trunk, ts.reshape(B, 1, 1), state.continuous, state.discrete,
                state.particle_mask()[:, :, None])
    out, hid = epic_forward_wide(*args, output_hidden_local=True)
    again = epic_forward_wide(*args, output_hidden_local=True)
    torch.cuda.synchronize()
    ref_out, ref_hid = epic_forward_reference(*args, output_hidden_local=True)
    cmp_out, cmp_hid = compare(out, ref_out), compare(hid, ref_hid)
    gate = "within_tol_per_particle"
    d = trunk.dims
    rec = {"phase": phase, "layout": trunk.layout, "hidden": d.hidden, "num_blocks": d.num_blocks,
           "head_hidden": d.head_hidden, "add_discrete_head": d.add_discrete_head,
           "fold_discrete": d.fold_discrete, "B": B, "N": n, "gate": gate,
           "outputs": cmp_out, "hidden_state": cmp_hid, "hidden_shape": list(hid.shape),
           "max_abs_ref": ref_out.abs().max().item(),
           "same_bits_on_repeat": bool(torch.equal(out, again[0]) and torch.equal(hid, again[1])),
           "finite": bool(torch.isfinite(out).all().item() and torch.isfinite(hid).all().item())}
    emit(rec)
    if not (cmp_out[gate] and cmp_hid[gate] and rec["finite"] and rec["same_bits_on_repeat"]
            and rec["layout"] == "wide" and rec["hidden_shape"] == [B, n, width]):
        raise RuntimeError(f"K4 ({phase}) disagrees with its plain version: {rec}")
    ms, plain_ms = time_pair(lambda: epic_forward_wide(*args, output_hidden_local=True),
                             lambda: epic_forward_reference(*args, output_hidden_local=True))
    bound = kernel_bound(trunk, B, "forward_hidden", n)
    emit({"phase": f"{phase}_time", "B": B, "N": n, "ms": ms, "plain_ms": plain_ms, **bound,
          **against_bounds(bound, ms), "products_tensor_bound_ms": products_tensor_bound_ms(d, B, n),
          "card": card})
    return {"max_abs_err": max(cmp_out["max_abs_err"], cmp_hid["max_abs_err"]),
            "max_abs_ref": rec["max_abs_ref"], "ms": ms, "plain_ms": plain_ms,
            **bound_fields(bound), "B": B, "N": n,
            "num_blocks": d.num_blocks, "head_hidden": d.head_hidden if d.add_discrete_head else None,
            "fold_discrete": d.fold_discrete, "output_hidden_local": True}


K4_ROW_CUT_B = 256
K4_ROW_CUT_N = (1, 40, 109, 112, 113, 128)  # both sides of a 16-row tile's and a 64-row half's edge


def k4_instances(device):
    """K4's four template instances at the scaled backbone, seeded weights:
    (name, packing). The folded input under the 56-wide head is no model's
    trunk; it is packed from the transdim trunk and the absorbing head."""
    absorbing = make_absorbing(device, scaled=True)
    tokens_wide_head, _ = absorbing.pack_for_kernel()
    transdim = make_transdim(device, scaled=True)
    fold, _, _ = transdim.pack_for_kernel()
    d = dataclasses.replace(fold.dims, add_discrete_head=True,
                            head_hidden=tokens_wide_head.dims.head_hidden)
    fold_wide_head = pack_encoder(transdim.network, d, "wide",
                                  head=absorbing.generator.discrete_head_mlp)
    return [("tokens", scaled_packed(device)), ("tokens_wide_head", tokens_wide_head),
            ("fold", fold), ("fold_wide_head", fold_wide_head)]


def phase_k4_row_cut(device, card):
    """Each of K4's four instances with the hidden output at B=256 and N on
    both sides of the tensor-core products' 16-row and 64-row edges, per
    particle, the same bits on a repeat. Returns the worst share of the gate
    by instance."""
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    gate, worst = "within_tol_per_particle", {}
    for name, packed in k4_instances(device):
        for n in K4_ROW_CUT_N:
            if packed.dims.fold_discrete:
                state, ts = transdim_state(K4_ROW_CUT_B, n, device, gen)
                args = (packed, ts.reshape(-1, 1, 1), state.continuous, state.discrete,
                        state.particle_mask()[:, :, None])
            else:
                args = (packed, *scattered_inputs(K4_ROW_CUT_B, n, device, gen))
            got = epic_forward_wide(*args, output_hidden_local=True)
            again = epic_forward_wide(*args, output_hidden_local=True)
            torch.cuda.synchronize()
            ref = epic_forward_reference(*args, output_hidden_local=True)
            cmps = [compare(a, r) for a, r in zip(got, ref)]
            rec = {"phase": "k4_row_cut", "instance": name, "B": K4_ROW_CUT_B, "N": n,
                   "fold_discrete": packed.dims.fold_discrete,
                   "head_hidden": packed.dims.head_hidden, "gate": gate,
                   "worst_particle_err_over_bound": max(c["worst_particle_err_over_bound"]
                                                        for c in cmps),
                   "max_abs_err": max(c["max_abs_err"] for c in cmps),
                   "same_bits_on_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
                   "finite": all(bool(torch.isfinite(a).all().item()) for a in got)}
            emit(rec)
            if not (all(c[gate] for c in cmps) and rec["same_bits_on_repeat"] and rec["finite"]):
                raise RuntimeError(f"K4 ({name}) disagrees with its plain version: {rec}")
            worst[name] = max(worst.get(name, 0.0), rec["worst_particle_err_over_bound"])
    return worst


def phase_k7_wide_input(device, card):
    """K7 at the scaled stacks' input widths 136 and 139, B=4096, N=128, the
    same bits on a repeat; then both timed at 139."""
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    model = make_transdim(device, scaled=True)
    net, n_heads = model.network, model.config.encoder.n_heads
    _, rate_stack, vec_stack = model.pack_for_kernel()
    cases = {}
    errors = []
    for packed, res_blocks in ((rate_stack, net.blocks()[0]), (vec_stack, net.blocks("vec_")[0])):
        x_in = torch.randn((TD_B, TD_N, packed.dim_in), generator=gen, device=device)
        with torch.no_grad():
            tp = stack_time_embeddings(
                net.time_embedding(torch.rand((TD_B,), generator=gen, device=device)), res_blocks)
        got = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
        again = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
        torch.cuda.synchronize()
        ref = gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads)
        err = (got - ref).abs()
        rec = {"phase": "k7_wide_input", "B": TD_B, "N": TD_N, "Din": packed.dim_in,
               "padded_rows": packed.tensors["w_in"].shape[0], "max_abs_err": err.max().item(),
               "max_abs_ref": ref.abs().max().item(), "atol": K7_TOL, "rtol": K7_TOL,
               "within_tol": bool((err <= K7_TOL + K7_TOL * ref.abs()).all().item()),
               "same_bits_on_repeat": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all().item())}
        emit(rec)
        errors.append({"Din": packed.dim_in, "max_abs_err": rec["max_abs_err"]})
        if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]):
            raise RuntimeError(f"K7 at a wide input disagrees with its plain version: {rec}")
        cases[packed.dim_in] = (packed, tp, x_in)
    if sorted(cases) != [136, 139]:
        raise RuntimeError(f"the scaled stacks read {sorted(cases)} columns, not 136 and 139")
    packed, tp, x_in = cases[139]
    ms, plain_ms = time_pair(lambda: gsdm_stack(packed, tp, x_in, n_heads=n_heads),
                             lambda: gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads))
    bound = gsdm_stack_bound(packed, TD_B, TD_N)
    emit({"phase": "k7_wide_input_time", "B": TD_B, "N": TD_N, "Din": 139, "ms": ms,
          "plain_ms": plain_ms, **bound, "tflops": bound["flops"] / ms / 1e9,
          "products_tensor_bound_ms": gsdm_products_tensor_bound_ms(139, packed.n_blocks, TD_B, TD_N),
          "card": card})
    return {"max_abs_err": errors[1]["max_abs_err"], "max_abs_err_by_check": errors, "ms": ms,
            "plain_ms": plain_ms, **bound_fields(bound),
            "B": TD_B, "N": TD_N, "Din": 139}


def attention_bound(B, n, C=128, masked=True):
    """K8's bound at (B, n): the scores and the values, n·n·C multiply-adds
    each a jet over the heads together; in: q, k, v (and the mask), out: the
    result."""
    return roofline(2.0 * 2 * n * n * C * B, 4.0 * B * n * C * 4 + (4.0 * B * n if masked else 0))


K8_CHECK_B = 1024
K8_CHECK_N = (1, 17, ABS_N, TD_N)  # both sides of the 16-row tiles and the 64-key chunks
K8_CHECK_HEADS = (4, 2, 1)  # head widths 32, 64, 128


def phase_k8(device, card):
    """K8 against the einsum at every head width it takes (32, 64, 128) and
    N in K8_CHECK_N at B=1024, and at the timed shape (B=4096, N=128, 2
    heads), with a key mask (one jet wholly masked: the mean of its values)
    and without, the same bits on a repeat; then timed at N=128 with the mask
    beside the einsum and scaled_dot_product_attention."""
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    C = 128
    errors = []
    cases = [(K8_CHECK_B, n, h) for n in K8_CHECK_N for h in K8_CHECK_HEADS] + [(TD_B, TD_N, K8_HEADS)]
    for B, n, heads in cases:
        q, k, v = (torch.randn((B, n, C), generator=gen, device=device) for _ in range(3))
        mask = (torch.rand((B, n, 1), generator=gen, device=device) < 0.6).float()
        mask[0] = 0.0
        for m in (mask, None):
            got = attention_core(q, k, v, m, n_heads=heads)
            again = attention_core(q, k, v, m, n_heads=heads)
            torch.cuda.synchronize()
            ref = attention_core_reference(q, k, v, m, n_heads=heads)
            err = (got - ref).abs()
            rec = {"phase": "k8", "B": B, "N": n, "C": C, "n_heads": heads, "head_width": C // heads,
                   "masked": m is not None, "max_abs_err": err.max().item(),
                   "max_abs_ref": ref.abs().max().item(), "atol": K8_TOL,
                   "within_tol": bool((err <= K8_TOL).all().item()),
                   "masked_jet_is_the_mean_of_its_values": bool(
                       (got[0] - v[0].mean(0)).abs().max().item() <= K8_TOL) if m is not None else None,
                   "same_bits_on_repeat": bool(torch.equal(got, again)),
                   "finite": bool(torch.isfinite(got).all().item())}
            emit(rec)
            errors.append({"B": B, "N": n, "n_heads": heads, "masked": m is not None,
                           "max_abs_err": rec["max_abs_err"]})
            if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]
                    and rec["masked_jet_is_the_mean_of_its_values"] in (True, None)):
                raise RuntimeError(f"K8 disagrees with its plain version: {rec}")

    # timed at B=4096, N=128, 2 heads with the mask (q, k, v, mask of the last case)
    B = TD_B
    ms, plain_ms = time_pair(lambda: attention_core(q, k, v, mask, n_heads=K8_HEADS),
                             lambda: attention_core_reference(q, k, v, mask, n_heads=K8_HEADS))
    hd = C // K8_HEADS
    q4, k4, v4 = (a.view(B, TD_N, K8_HEADS, hd).transpose(1, 2) for a in (q, k, v))
    bias4 = key_bias(mask, B, TD_N, q)[:, None]  # (B, 1, 1, N)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias4)

    library = sdpa().transpose(1, 2).reshape(B, TD_N, C)
    library_err = (library - attention_core_reference(q, k, v, mask, n_heads=K8_HEADS)).abs().max().item()
    lib1, lib2 = cuda_ms(sdpa), cuda_ms(sdpa)
    bound = attention_bound(B, TD_N)
    emit({"phase": "k8_time", "B": B, "N": TD_N, "C": C, "n_heads": K8_HEADS, "masked": True,
          "ms": ms, "plain_ms": plain_ms, "library_ms": (lib1 + lib2) / 2,
          "library": "torch.nn.functional.scaled_dot_product_attention, float mask",
          "library_max_abs_err": library_err, **bound, **against_bounds(bound, ms),
          "card": card})
    return errors, ms, plain_ms, (lib1 + lib2) / 2, bound


def phase_attn_block(device, card):
    """K8's path, counted as one run: AttnBlock(use_pallas=True) forward and
    backward at B=4096, N=109 with a key mask (one jet wholly masked); then
    held against AttnBlock(use_pallas=False) from the same weights."""
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    fused = init_transdimensional_parameters(AttnBlock(128, K8_HEADS, use_pallas=True), SEED)
    fused = fused.to(device)
    with torch.no_grad():  # non-zero biases and GroupNorm offsets
        for p in fused.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
    einsum = AttnBlock(128, K8_HEADS, use_pallas=False).to(device)
    einsum.load_state_dict(fused.state_dict())
    B, n = TD_B, ABS_N
    x = torch.randn((B, n, 128), generator=gen, device=device)
    mask = (torch.rand((B, n, 1), generator=gen, device=device) < 0.6).float()
    mask[0] = 0.0
    g = torch.randn((B, n, 128), generator=gen, device=device)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    torch.cuda.synchronize()

    reset_counts()  # K8's path: AttnBlock(use_pallas=True) forward and backward
    out = fused(xs[0], mask)
    out.backward(g)
    torch.cuda.synchronize()
    launches = {"attention_core": attention_core.launches}
    calls = plain_calls()

    ref = einsum(xs[1], mask)
    ref.backward(g)
    err = (out - ref).abs()
    pairs = [("x", xs[0].grad, xs[1].grad)] + [
        (name, p.grad, dict(einsum.named_parameters())[name].grad)
        for name, p in fused.named_parameters()]
    worst, bad, key_bias_grads = 0.0, [], None
    for name, a, r in pairs:
        if name == "k.bias":  # 0 in exact arithmetic: a shift of a row's scores
            scale = fused.k.weight.grad.abs().max().item()
            key_bias_grads = {"fused": a.abs().max().item(), "einsum": r.abs().max().item(),
                              "k_weight_grad_max": scale}
            if not max(key_bias_grads["fused"], key_bias_grads["einsum"]) <= 1e-4 * scale:
                bad.append(name)
            continue
        bound = 1e-4 * max(r.abs().max().item(), 1e-6) + 1e-3 * r.abs()
        ratio = ((a - r).abs() / bound).max().item()
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            bad.append(name)
    rec = {"phase": "attn_block", "B": B, "N": n, "n_heads": K8_HEADS, "launches": launches,
           "plain_calls": calls, "output_max_abs_err": err.max().item(),
           "output_max_abs_ref": ref.abs().max().item(),
           "output_within_tol": bool((err <= 1e-4 + 1e-4 * ref.abs()).all().item()),
           "worst_grad_err_over_bound": worst, "grads_out_of_bound": bad,
           "key_bias_grad": key_bias_grads, "card": card}
    emit(rec)
    if launches != {"attention_core": 1} or calls or bad or not rec["output_within_tol"]:
        raise RuntimeError(f"AttnBlock(use_pallas=True) disagrees with the einsum path: {rec}")
    return launches


def profile_request(model, request, B, gen, phase, bare_seconds, card):
    """One torch.profiler window over a served request of B jets: device time
    by operation, against the bare request's time, unprofiled, of the same
    size."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    begin = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        model.predict(request, generator=gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - begin) * 1e3
    kernels = device_operations(prof, 1)
    device_ms = sum(k[0] for k in kernels)
    emit({"phase": phase, "window": "request", "B": B, "profiled_wall_ms": wall_ms,
          "device_ms": device_ms,
          "bare_request_ms": bare_seconds * 1e3,
          "device_idle_share_of_bare_request": 1.0 - device_ms / (bare_seconds * 1e3),
          "launches": sum(k[1] for k in kernels),
          "operations_ms": [{"ms": ms, "count": c, "name": name[:80]}
                            for ms, c, name in kernels[:12]], "card": card})


def phase_slice_absorbing_scaled(device, card, width=SCALED_HIDDEN,
                                 sizes=SCALED_FAMILY_REQUEST_SIZES, tag="", n=ABS_N):
    """predict at the scaled absorbing backbone (every width `width`, `n`
    particle slots): per step one launch of K4 (hidden output, 56-wide head)
    and one of K6, nothing else, no plain version; then the kernel path
    against the module path. With more than one request size, a profiler
    window over one request. `tag` ends the phases' names."""
    model = make_absorbing(device, scaled=width, gains=True, n=n)
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    batches = [absorbing_training_batch(B, n, 3, 8, gen, device=device, num_empty=1)
               for B in sizes]
    torch.cuda.synchronize()

    reset_counts()  # the scaled absorbing serving path's run starts here
    bare = {}
    for B, batch in zip(sizes, batches):
        k4_before, k6_before = epic_forward_wide.launches, survival_head.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = bare[B] = time.perf_counter() - start
        k4 = epic_forward_wide.launches - k4_before
        k6 = survival_head.launches - k6_before
        checks = check_generated_absorbing(out, batch, B, n)
        emit({"phase": f"slice_absorbing_scaled{tag}", "width": width, "B": B, "N": n,
              "steps": k6,
              "K4_launches": k4, "K6_launches": k6, "seconds": seconds,
              "jets_per_s": B / seconds, "multiplicity_in": batch.source_mask.sum().item() / B,
              "multiplicity_out": out.mask_t.sum().item() / B, "card": card, **checks})
        if k4 != 99 or k6 != 99:
            raise RuntimeError(f"scaled absorbing request of {B} jets launched K4 {k4} and K6 "
                               f"{k6} times")
    launches = {"epic_wide_forward": epic_forward_wide.launches,
                "survival_head": survival_head.launches}
    others = {**narrow_counts(), "epic_wide_backward": epic_backward_wide.launches,
              "gsdm_stack": gsdm_stack.launches, "attention_core": attention_core.launches}
    emit({"phase": f"slice_absorbing_scaled{tag}_counts", "launches": launches,
          "other_launches": others, "plain_calls": plain_calls()})
    if plain_calls() != 0 or any(others.values()):
        raise RuntimeError("the scaled absorbing serving path left its kernels")
    if len(sizes) > 1:
        profile_request(model, batches[1], ABS_B, gen, f"profile_absorbing_scaled{tag}",
                        bare[ABS_B], card)
    phase_paths_absorbing(device, model, f"paths_absorbing_scaled{tag}", n)
    return launches


def phase_slice_transdim_scaled(device, card, width=SCALED_HIDDEN,
                                sizes=SCALED_FAMILY_REQUEST_SIZES, tag="", n=TD_N):
    """predict at the scaled transdimensional backbone (every width `width`,
    `n` particle slots): per network evaluation one launch of K4 (folded
    input, hidden output) and two of K7 (Din width + 8 and + 11), nothing
    else, no plain version; then the kernel path against the module path
    from the same draws. With more than one request size, a profiler window
    over one request."""
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    batches = [transdim_training_batch(B, n, 3, 8, gen, device=device) for B in sizes]
    model = make_transdim(device, batches[0], scaled=width, gains=True, n=n)
    prior_mean = batches[0][0].float().mean().item()
    torch.cuda.synchronize()

    reset_counts()  # the scaled transdimensional serving path's run starts here
    bare = {}
    for B, batch in zip(sizes, batches):
        k4_before, k7_before = epic_forward_wide.launches, gsdm_stack.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = bare[B] = time.perf_counter() - start
        k4 = epic_forward_wide.launches - k4_before
        k7 = gsdm_stack.launches - k7_before
        checks = check_generated_transdim(out, B, n)
        mean_out = out.dims.float().mean().item()
        emit({"phase": f"slice_transdim_scaled{tag}", "width": width, "B": B, "N": n,
              "steps": TD_STEPS, "nfe": k4,
              "K4_launches": k4, "K7_launches": k7, "seconds": seconds,
              "jets_per_s": B / seconds, "multiplicity_prior": prior_mean,
              "multiplicity_out": mean_out, "card": card, **checks})
        if (k4, k7) != (TD_STEPS, 2 * TD_STEPS):
            raise RuntimeError(f"scaled transdim request of {B} jets: K4 {k4}, K7 {k7}")
        if abs(mean_out - prior_mean) > MAX_MULTIPLICITY_SHIFT * prior_mean:
            raise RuntimeError(f"mean multiplicity {mean_out} against the prior's {prior_mean}")
    launches = {"epic_wide_forward": epic_forward_wide.launches, "gsdm_stack": gsdm_stack.launches}
    others = {**narrow_counts(), "epic_wide_backward": epic_backward_wide.launches,
              "survival_head": survival_head.launches, "attention_core": attention_core.launches}
    emit({"phase": f"slice_transdim_scaled{tag}_counts", "launches": launches,
          "other_launches": others, "plain_calls": plain_calls()})
    if plain_calls() != 0 or any(others.values()):
        raise RuntimeError("the scaled transdimensional serving path left its kernels")
    if len(sizes) > 1:
        profile_request(model, batches[1], TD_B, gen, f"profile_transdim_scaled{tag}",
                        bare[TD_B], card)
    phase_paths_transdim(device, scaled=width, phase=f"paths_transdim_scaled{tag}", n=n)
    return launches


def scaled_family_phases(device, card):
    """Phases 30-35: K4's two other trunks, K7 at wide inputs, K8 and its
    path, the scaled absorbing and transdimensional serving paths. Returns
    what the kernels line gains."""
    k4_absorbing = phase_k4_family(device, card, "absorbing")
    k4_transdim = phase_k4_family(device, card, "transdim")
    k4_row_cut = phase_k4_row_cut(device, card)
    k7_wide = phase_k7_wide_input(device, card)
    k8_errors, k8_ms, k8_plain, k8_library, k8_bound = phase_k8(device, card)
    k8_path = phase_attn_block(device, card)
    absorbing = phase_slice_absorbing_scaled(device, card)
    transdim = phase_slice_transdim_scaled(device, card)
    k8_entry = {"name": "attention_core", "route": "cuda",
                "source": "multimodal_particles_tpu_torch/ops/csrc/attention_core.cu",
                "replaces": "multimodal_particles_tpu/ops/attention_pallas.py:98",
                "launches": k8_path["attention_core"],
                "launches_by_path": {"attn_block": k8_path["attention_core"]},
                "max_abs_err": k8_errors[-2]["max_abs_err"], "max_abs_err_by_check": k8_errors,
                "ms": k8_ms, "plain_ms": k8_plain, **bound_fields(k8_bound),
                "library_ms": k8_library,
                "library": "torch.nn.functional.scaled_dot_product_attention",
                "timed_at": {"B": TD_B, "N": TD_N, "C": 128, "n_heads": K8_HEADS, "masked": True}}
    return {"k4_absorbing": k4_absorbing, "k4_transdim": k4_transdim, "k4_row_cut": k4_row_cut,
            "k7_wide": k7_wide,
            "k8_entry": k8_entry, "absorbing": absorbing, "transdim": transdim}


# ------------------------------------------------ phases 36-38: the experiments


def all_counts():
    """Every kernel's launch count."""
    return {**narrow_counts(), **wide_counts(), "survival_head": survival_head.launches,
            "gsdm_stack": gsdm_stack.launches, "attention_core": attention_core.launches}


def launched(expected):
    """The kernels launched since the last reset_counts(), and whether they are
    exactly `expected` (every other kernel at 0) with no plain version called."""
    counts = {k: v for k, v in all_counts().items() if v}
    return counts, counts == {k: v for k, v in expected.items() if v} and plain_calls() == 0


def finite_or_none(x):
    x = float(x)
    return x if math.isfinite(x) else None


def jets_against_data(states, config):
    """Generated jets in physics space against the shard's: the checks that
    must hold (the sampler's dead slots 0 before postprocess() masks them,
    finite jets) and the KL/W1 of the jet observables (informational, as in
    the JAX package)."""
    state = HybridState(
        continuous=torch.cat([s.continuous for s in states]),
        discrete=torch.cat([s.discrete for s in states]),
        absorbing=torch.cat([s.absorbing for s in states]))
    dead = state.absorbing[..., 0] == 0
    dead_slots_zero = bool((state.continuous[dead] == 0).all().item()
                           and (state.discrete[dead] == 0).all().item())
    cloud = ParticleClouds(state)
    cloud.postprocess(config.data.target_preprocess_continuous,
                      config.data.target_preprocess_discrete,
                      stats=config.data.target_preprocess_stats)
    generated = JetClassHighLevelFeatures(cloud)
    data = JetClassHighLevelFeatures(ParticleClouds(
        config.data.target_name, config.data.target_path,
        max_num_particles=config.data.max_num_particles, num_jets=config.data.num_jets))
    checks = {
        "finite": bool(np.isfinite(cloud.continuous).all()),
        "dead_slots_zero": dead_slots_zero,
        "jet_observables_finite": bool(np.isfinite(generated.pt).all()
                                       and np.isfinite(generated.m).all()),
    }
    metrics = {f"{kind}_{f}": finite_or_none(getattr(generated, metric)(f, data))
               for f in ("pt", "eta", "phi", "m", "tau21", "tau32", "d2")
               for kind, metric in (("KL", "KLmetric1D"), ("W1", "Wassertein1D"))}
    return checks, metrics


def check_tokens(states):
    ok = all(bool(((s.discrete >= 0) & (s.discrete < 8)).all().item()) for s in states)
    if not ok:
        raise RuntimeError("generated tokens outside [0, 8)")
    return ok


def phase_experiment(device, card, workdir):
    """The user's MBM run from config-mbm-test.yaml on the AspenOpenJets .npz
    shard: train() for the YAML's epochs (K3 once a train step, K1 once a
    train step and a validation batch), generate() (K2 99 times a batch), the
    jets post-processed and scored against the shard, then the run reloaded
    by load_from_experiment_dir to the same bits."""
    config = MultimodalBridgeMatchingConfig.from_yaml(str(MBM_EXPERIMENT_YAML))
    torch.cuda.synchronize()
    start = time.perf_counter()
    experiment = MultimodalBridgeMatchingExperiment(config, str(workdir / "mbm"), seed=SEED,
                                                    device=device)
    setup_seconds = time.perf_counter() - start
    dm = experiment.datamodule
    epochs = config.train.epochs
    steps, valid = len(dm.train) * epochs, len(dm.valid) * epochs

    reset_counts()  # the experiment's training run starts here
    start = time.perf_counter()
    history = experiment.train()
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    fit_launches, fit_ok = launched({"epic_forward": steps + valid, "epic_backward": steps})
    losses = [r["train_loss"] for r in history]
    emit({"phase": "experiment", "config": str(MBM_EXPERIMENT_YAML.relative_to(ROOT)),
          "jets": len(dm.dataset), "N": config.data.max_num_particles,
          "batch_size": config.data.batch_size, "epochs": epochs, "train_steps": steps,
          "train_losses": losses, "val_losses": [r["val_loss"] for r in history],
          "launches": fit_launches, "plain_calls": plain_calls(), "setup_seconds": setup_seconds,
          "fit_seconds": fit_seconds, "card": card})
    if not fit_ok:
        raise RuntimeError(f"the experiment's training launched {fit_launches}, "
                           f"{plain_calls()} plain calls")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the experiment's loss is not finite or did not fall: {losses}")

    experiment.trainer.load_checkpoint("best")
    reset_counts()
    start = time.perf_counter()
    generated = experiment.generate()
    torch.cuda.synchronize()
    generate_seconds = time.perf_counter() - start
    batches = len(generated)
    gen_launches, gen_ok = launched({"sampler_step": 99 * batches})
    tokens_ok = check_tokens(generated)
    checks, metrics = jets_against_data(generated, experiment.config)

    start = time.perf_counter()
    again = MultimodalBridgeMatchingExperiment(experiment_dir=str(workdir / "mbm"), seed=SEED,
                                               device=device)
    regenerated = again.generate()
    torch.cuda.synchronize()
    reload_seconds = time.perf_counter() - start
    same_bits = all(torch.equal(a.continuous, b.continuous) and torch.equal(a.discrete, b.discrete)
                    for a, b in zip(generated, regenerated))
    emit({"phase": "experiment_generate", "jets": sum(s.continuous.shape[0] for s in generated),
          "batches": batches, "launches": gen_launches, "plain_calls": plain_calls(),
          "tokens_in_range": tokens_ok, **checks, "against_data": metrics,
          "reload_same_bits": same_bits, "generate_seconds": generate_seconds,
          "reload_seconds": reload_seconds, "card": card})
    if not gen_ok or not all(checks.values()) or not same_bits:
        raise RuntimeError("the experiment's generate() failed its checks")
    return {"train": fit_launches, "generate": gen_launches, "generate_batches": batches}


def phase_experiment_absorbing(device, card, workdir):
    """The absorbing run from config-absorbing-test.yaml (N = 109, 1000
    timesteps) on the shard, its 200 epochs cut to EXPERIMENT_ABS_EPOCHS: the
    fit launches no kernel (as in JAX), generate() launches K1 (hidden output)
    and K6 once a solver step."""
    config = AbsorbingConfig.from_yaml(str(ABS_EXPERIMENT_YAML))
    yaml_epochs = config.train.epochs
    torch.cuda.synchronize()
    start = time.perf_counter()
    experiment = AbsorbingExperiment(config, str(workdir / "absorbing"), seed=SEED,
                                     device=device)
    setup_seconds = time.perf_counter() - start
    reset_counts()
    start = time.perf_counter()
    history = experiment.train(EXPERIMENT_ABS_EPOCHS)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    fit_launches, fit_ok = launched({})
    losses = [r["train_loss"] for r in history]

    reset_counts()
    start = time.perf_counter()
    generated = experiment.generate()
    torch.cuda.synchronize()
    generate_seconds = time.perf_counter() - start
    solver_steps = (config.bridge.num_timesteps - 1) * len(generated)
    gen_launches, gen_ok = launched({"epic_forward": solver_steps, "survival_head": solver_steps})
    valid = list(experiment.datamodule.valid)
    checks = [check_generated_absorbing(out, batch, out.continuous.shape[0])
              for out, batch in zip(generated, valid)]
    multiplicity = torch.cat([s.mask_t.sum(dim=(1, 2)) for s in generated]).float()
    emit({"phase": "experiment_absorbing", "config": str(ABS_EXPERIMENT_YAML.relative_to(ROOT)),
          "epochs_in_yaml": yaml_epochs, "epochs_run": EXPERIMENT_ABS_EPOCHS,
          "N": config.data.max_num_particles, "num_timesteps": config.bridge.num_timesteps,
          "train_losses": losses, "fit_launches": fit_launches, "generate_launches": gen_launches,
          "plain_calls": plain_calls(), "checks": checks[0],
          "multiplicity_out_mean": multiplicity.mean().item(),
          "setup_seconds": setup_seconds, "fit_seconds": fit_seconds,
          "generate_seconds": generate_seconds, "card": card})
    if not fit_ok or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"the absorbing experiment's fit: {fit_launches}, losses {losses}")
    if not gen_ok:
        raise RuntimeError(f"the absorbing experiment's generate() launched {gen_launches}")
    return {"generate": gen_launches}


def phase_experiment_transdim(device, card, workdir):
    """The transdimensional run at TransdimensionalEpicConfig() on the shard,
    EXPERIMENT_TD_EPOCHS epochs: the fit launches no kernel (as in JAX),
    generate() launches K1 (folded input) once and K7 twice a network
    evaluation; a request of EXPERIMENT_TD_B jets' mean multiplicity within
    MAX_MULTIPLICITY_SHIFT of the data's."""
    config = TransdimensionalEpicConfig()
    torch.cuda.synchronize()
    start = time.perf_counter()
    experiment = TransdimensionalExperiment(config, str(workdir / "transdim"), seed=SEED,
                                            device=device)
    setup_seconds = time.perf_counter() - start
    dm = experiment.datamodule
    reset_counts()
    start = time.perf_counter()
    history = experiment.train(EXPERIMENT_TD_EPOCHS)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - start
    fit_launches, fit_ok = launched({})
    losses = [r["train_loss"] for r in history]

    # without corrector steps, one network evaluation a step of the time grid
    if config.sampler_kwargs.corrector_steps:
        raise RuntimeError("the phase counts one network evaluation a sampler step")
    nfe = len(_build_time_grid(config.sampler_kwargs)[0])
    reset_counts()
    start = time.perf_counter()
    generated = experiment.generate()
    torch.cuda.synchronize()
    generate_seconds = time.perf_counter() - start
    gen_launches, gen_ok = launched({"epic_forward": nfe * len(generated),
                                     "gsdm_stack": 2 * nfe * len(generated)})
    template = dm.dataset.gather(np.arange(EXPERIMENT_TD_B) % len(dm.dataset))
    reset_counts()
    start = time.perf_counter()
    request = experiment.trainer.predict([template])[0]
    torch.cuda.synchronize()
    request_seconds = time.perf_counter() - start
    request_launches, request_ok = launched({"epic_forward": nfe, "gsdm_stack": 2 * nfe})
    data_hist = dm.histogram_target
    data_mean = sum(k * v for k, v in data_hist.items()) / sum(data_hist.values())
    mean_out = request.dims.float().mean().item()
    emit({"phase": "experiment_transdim", "N": config.data.max_num_particles,
          "epochs": EXPERIMENT_TD_EPOCHS, "train_losses": losses, "fit_launches": fit_launches,
          "nfe": nfe, "generate_launches": gen_launches, "request_launches": request_launches,
          "plain_calls": plain_calls(),
          "generated_jets": sum(s.dims.shape[0] for s in generated),
          "request_jets": EXPERIMENT_TD_B, "multiplicity_data": data_mean,
          "multiplicity_out": mean_out, "setup_seconds": setup_seconds,
          "fit_seconds": fit_seconds, "generate_seconds": generate_seconds,
          "request_seconds": request_seconds, "card": card})
    if not fit_ok or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"the transdim experiment's fit: {fit_launches}, losses {losses}")
    if not (gen_ok and request_ok):
        raise RuntimeError(f"the transdim experiment's generate() launched {gen_launches}, "
                           f"its request {request_launches}")
    for out in generated + [request]:
        finite = torch.isfinite(out.continuous).all() and torch.isfinite(out.discrete).all()
        in_range = ((out.dims >= 1) & (out.dims <= config.data.max_num_particles)).all()
        if not (finite and in_range):
            raise RuntimeError("generated transdimensional jets are not finite or out of range")
    if abs(mean_out - data_mean) > MAX_MULTIPLICITY_SHIFT * data_mean:
        raise RuntimeError(f"mean multiplicity {mean_out} against the data's {data_mean}")
    return {"generate": gen_launches}


def experiment_phases(device, card, runs):
    """Phases 36-38, each in a run directory under `runs` (phase 49 scores
    phase 36's)."""
    mbm = phase_experiment(device, card, runs)
    absorbing = phase_experiment_absorbing(device, card, runs)
    transdim = phase_experiment_transdim(device, card, runs)
    return mbm, absorbing, transdim


# ---------------------------------- phases 39-42: the bulk sweep, substructure, guidance


def check_bulk(result, jets, n):
    """What a collected sweep must hold: shapes (jets, n, ·), finite
    kinematics, tokens in [0, 8), a 0/1 mask with dead slots 0."""
    x, k, mask = result["continuous"], result["discrete"], result["mask"]
    dead = mask[..., 0] == 0
    ok = {
        "shape": (x.shape[:2] == (jets, n) and k.shape == (jets, n, 1)
                  and mask.shape == (jets, n, 1)),
        "finite": bool(np.isfinite(x).all()),
        "tokens_in_range": bool(((k >= 0) & (k < 8)).all()),
        "mask_is_0_or_1": bool(np.isin(mask, (0, 1)).all()),
        "dead_slots_zero": bool((x[dead] == 0).all() and (k[dead] == 0).all()),
    }
    if not all(ok.values()):
        raise RuntimeError(f"the sweep's jets fail their checks: {ok}")
    return ok


def phase_bulk_mbm(device, card, multiplicities):
    """The 1M-jet sweep at config-berlin through K2 alone, then a collected
    sweep of BULK_COLLECT_JETS checked and rerun to the same bits."""
    model = make_model(device)
    chunks = math.ceil(BULK_JETS / BULK_B)
    torch.cuda.synchronize()
    reset_counts()  # the sweep's run starts here
    _, stats = bulk_sample(model, model.config, BULK_JETS, batch_size=BULK_B, seed=SEED,
                           target_multiplicity=multiplicities, collect=False)
    launches, ok = launched({"sampler_step": 99 * (chunks + 1)})
    emit({"phase": "bulk_mbm", "B": BULK_B, "N": N, "chunks": chunks, **stats,
          "launches": launches, "plain_calls": plain_calls(), "card": card})
    READINGS["bulk_jets_per_s"] = stats["jets_per_sec"]
    if not ok:
        raise RuntimeError(f"the 1M-jet sweep launched {launches}, {plain_calls()} plain calls")

    collected, cstats = bulk_sample(model, model.config, BULK_COLLECT_JETS, batch_size=BULK_B,
                                    seed=SEED, target_multiplicity=multiplicities)
    again, _ = bulk_sample(model, model.config, BULK_COLLECT_JETS, batch_size=BULK_B, seed=SEED,
                           target_multiplicity=multiplicities)
    checks = check_bulk(collected, BULK_COLLECT_JETS, N)
    same_bits = all(np.array_equal(collected[key], again[key]) for key in collected)
    emit({"phase": "bulk_mbm_collect", **cstats, **checks, "same_seed_same_bits": same_bits,
          "multiplicity_mean": float(collected["mask"].sum(axis=(1, 2)).mean()),
          "card": card})
    if not same_bits:
        raise RuntimeError("the collected sweep did not rerun to the same bits")
    return launches, collected


def phase_bulk_family(device, card, family, multiplicities):
    """The sweep of the absorbing or the transdimensional family at
    BULK_FAMILY_B, BULK_FAMILY_CHUNKS chunks and the warm-up, collected."""
    runs = BULK_FAMILY_CHUNKS + 1
    jets = BULK_FAMILY_B * BULK_FAMILY_CHUNKS
    extra = {}
    if family == "absorbing":
        model, n = make_absorbing(device), ABS_N
        expected = {"epic_forward": 99 * runs, "survival_head": 99 * runs}
        extra["target_multiplicity"] = multiplicities
    else:
        gen = torch.Generator(device=device).manual_seed(SEED + 40)
        prior = transdim_training_batch(BULK_FAMILY_B, TD_N, 3, 8, gen, device=device)
        model, n = make_transdim(device, prior), TD_N
        prior_mean = prior[0].float().mean().item()
        expected = {"epic_forward": TD_STEPS * runs, "gsdm_stack": 2 * TD_STEPS * runs}
    torch.cuda.synchronize()
    reset_counts()  # the family's sweep starts here
    result, stats = bulk_sample(model, model.config, jets, batch_size=BULK_FAMILY_B, seed=SEED,
                                **extra)
    launches, ok = launched(expected)
    checks = check_bulk(result, jets, n)
    multiplicity = result["mask"].sum(axis=(1, 2))
    line = {"phase": f"bulk_{family}", "B": BULK_FAMILY_B, "N": n,
            "chunks": BULK_FAMILY_CHUNKS, **stats, "launches": launches,
            "plain_calls": plain_calls(), **checks,
            "multiplicity_mean": float(multiplicity.mean()), "card": card}
    if family == "transdim":
        in_range = bool(((multiplicity >= 1) & (multiplicity <= n)).all())
        shift = abs(float(multiplicity.mean()) - prior_mean) / prior_mean
        line.update(dims_in_range=in_range, multiplicity_prior=prior_mean,
                    multiplicity_shift=shift)
        if not in_range or shift > MAX_MULTIPLICITY_SHIFT:
            raise RuntimeError(f"transdim sweep: dims in range {in_range}, shift {shift}")
    emit(line)
    if not ok:
        raise RuntimeError(f"the {family} sweep launched {launches}, "
                           f"{plain_calls()} plain calls")
    return launches


def substructure_against_numpy(pt, eta, phi, mask):
    """The library on the jets against the numpy loop: its valid flags equal
    to the numpy selection, each observable within SUBSTRUCTURE_RTOL; each
    version's seconds."""
    start = time.perf_counter()
    lib = native.substructure_batch_native(pt, eta, phi, mask)
    native_seconds = time.perf_counter() - start
    start = time.perf_counter()
    ref = substructure_observables(pt, eta, phi, mask, use_native=False)
    numpy_seconds = time.perf_counter() - start
    sel = ref["selection"]
    got = substructure_observables(pt, eta, phi, mask)
    worst = 0.0
    for key in ("tau1", "tau2", "tau3", "tau21", "tau32", "d2"):
        a, b = got[key], ref[key]
        if not (np.isnan(a) == np.isnan(b)).all():
            raise RuntimeError(f"substructure {key}: NaN where the other is not")
        a, b = a[~np.isnan(b)], b[~np.isnan(b)]
        worst = max(worst, float((np.abs(a - b) / (SUBSTRUCTURE_ATOL + SUBSTRUCTURE_RTOL
                                                    * np.abs(b))).max(initial=0.0)))
    return {"jets": len(pt), "valid": int(sel.sum()),
            "valid_equal": bool(np.array_equal(lib["valid"], sel)), "native": got["native"],
            "worst_err_over_bound": worst, "native_seconds": native_seconds,
            "numpy_seconds": numpy_seconds, "native_jets_per_s": len(pt) / native_seconds,
            "numpy_jets_per_s": len(pt) / numpy_seconds}


def phase_substructure_native(card, shard, collected):
    """The C++ library (built with the kernels, `main`) held against the numpy
    version on the shard's jets and on phase 39's (post-processed with the
    shard's stats), then timed on all of phase 39's collected jets."""
    cloud = ParticleClouds(np.concatenate(
        [collected["continuous"], collected["discrete"], collected["mask"]], axis=-1))
    cloud.postprocess("standardize", "tokens", stats=shard.summary_stats())
    # Both JAX versions wrap a φ difference once and the numpy one re-derives
    # each φ from the four-momentum into (−π, π], where the library keeps the
    # input's: they part on a jet with a particle at |φ| ≥ π, which the seeded
    # model generates (|φ| up to 80). The comparison takes jets within the angle
    # domain.
    in_domain = ((np.abs(cloud.phi_rel) < np.pi) | (cloud.mask[..., 0] == 0)).all(axis=1)
    held = {"shard": substructure_against_numpy(shard.pt, shard.eta_rel, shard.phi_rel,
                                                shard.mask[..., 0])}
    rows = np.flatnonzero(in_domain)[:SUBSTRUCTURE_NUMPY_JETS]
    held["bulk_mbm"] = substructure_against_numpy(cloud.pt[rows], cloud.eta_rel[rows],
                                                  cloud.phi_rel[rows], cloud.mask[rows, :, 0])
    held["bulk_mbm"]["jets_in_angle_domain"] = int(in_domain.sum())
    start = time.perf_counter()
    every = substructure_observables(cloud.pt, cloud.eta_rel, cloud.phi_rel, cloud.mask[..., 0])
    seconds = time.perf_counter() - start
    emit({"phase": "substructure_native", "against_numpy": held,
          "all_collected": {"jets": len(cloud), "native": every["native"], "seconds": seconds,
                            "jets_per_s": len(cloud) / seconds,
                            "valid": int(every["selection"].sum())},
          "card": card})
    for name, h in held.items():
        if not (h["native"] and h["valid_equal"] and h["worst_err_over_bound"] <= 1.0):
            raise RuntimeError(f"the C++ substructure library against numpy on {name}: {h}")
    if not every["native"]:
        raise RuntimeError("the collected jets were not scored by the C++ library")


def phase_conditioned_transdim(device, card):
    """Reconstruction guidance on the card: jets of the shard, gathered by the
    port's datamodule, completed from their first COND_OBSERVED particles;
    the guided sampler runs the module path under autograd (no kernel, as in
    JAX); the unguided run from the same generator seed differs."""
    config = TransdimensionalEpicConfig()
    config.data.return_type = "list"
    sk = config.sampler_kwargs
    dt_in_config, sk.dt = sk.dt, 1.0 / COND_STEPS
    sk.do_conditioning, sk.guidance_weight = True, COND_WEIGHT
    jets = JetDataclass(config, seed=SEED)
    jets.preprocess()
    dm = JetsDataloaderModule(config, jets, device=device)
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config, dm), SEED)
    model = model.to(device).eval()
    state = model._as_state(dm.dataset.gather(np.arange(COND_JETS) % len(dm.dataset)))
    condition = Condition.observe(state, torch.full((COND_JETS,), COND_OBSERVED))
    torch.cuda.synchronize()
    reset_counts()  # the guided run starts here
    start = time.perf_counter()
    guided, nfe = model.sample(state, torch.Generator(device=device).manual_seed(SEED + 42),
                               condition=condition)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, ok = launched({})
    sk.do_conditioning = False
    reset_counts()
    start = time.perf_counter()
    plain, _ = model.sample(state, torch.Generator(device=device).manual_seed(SEED + 42))
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - start
    plain_launches, _ = launched({})

    def observed_miss(out):
        """Mean |x − observation| over the observed entries, in the geometry
        the guidance compares in (the observed rows, centred over them)."""
        observed, _ = adjust_state(out.delete_dims(condition.dims))
        return (condition.mask * (observed.get_flat_lats() - condition.lats)).abs().mean().item()

    checks = {
        "finite": bool(torch.isfinite(guided.continuous).all().item()
                       and torch.isfinite(guided.discrete).all().item()),
        "dims_in_range": bool(((guided.dims >= 1) & (guided.dims <= TD_N)).all().item()),
        "differs_from_unguided": not torch.equal(guided.get_flat_lats(), plain.get_flat_lats()),
    }
    emit({"phase": "conditioned_transdim", "jets": COND_JETS, "observed_particles": COND_OBSERVED,
          "guidance_weight": COND_WEIGHT, "steps": nfe, "dt_in_config": dt_in_config,
          "launches": launches, "plain_calls": plain_calls(), **checks,
          "mean_dims": guided.dims.float().mean().item(),
          "data_mean_dims": state.dims.float().mean().item(),
          "observed_mean_abs_miss": observed_miss(guided),
          "unguided_observed_mean_abs_miss": observed_miss(plain),
          "seconds": seconds, "unguided_seconds": plain_seconds,
          "unguided_launches": plain_launches, "card": card})
    if not ok or not all(checks.values()):
        raise RuntimeError(f"the guided sampler: launches {launches}, checks {checks}")


def bulk_phases(device, card):
    """Phases 39-42; the sweeps' launch counts for the kernels line."""
    shard = ParticleClouds("AspenOpenJets", max_num_particles=N)  # the bundled 100 jets (.npz)
    mbm, collected = phase_bulk_mbm(device, card, shard.multiplicity)
    absorbing = phase_bulk_family(device, card, "absorbing", shard.multiplicity)
    transdim = phase_bulk_family(device, card, "transdim", None)
    phase_substructure_native(card, shard, collected)
    phase_conditioned_transdim(device, card)
    return mbm, absorbing, transdim


# ------------------------------- phases 43-45: encoder switches, contexts, bf16


def apply_sections(config, sections):
    """The config with `sections` ({section: {field: value}}) set."""
    for section, fields in sections.items():
        for name, value in fields.items():
            setattr(getattr(config, section), name, value)
    return config


def with_contexts(batch, config, gen, device):
    """The batch with the contexts the config asks for: normal continuous
    values, tokens uniform in the context vocabulary."""
    B, d = batch.source_continuous.shape[0], config.data
    if d.dim_context_continuous:
        batch.context_continuous = torch.randn((B, d.dim_context_continuous), generator=gen,
                                               device=device)
    if d.dim_context_discrete:
        batch.context_discrete = torch.randint(0, d.vocab_size_context,
                                               (B, d.dim_context_discrete), generator=gen,
                                               device=device)
    return batch


def on_cpu(batch):
    return MultimodalDatabatch(**{f.name: (None if getattr(batch, f.name) is None
                                           else getattr(batch, f.name).cpu())
                                  for f in dataclasses.fields(batch)})


def timed_predict(model, batch, gen):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = model.predict(batch, generator=gen)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def card_against_cpu(model, state, batch):
    """The module forward on the card and on the CPU from the same weights
    and inputs: (card heads, CPU heads)."""
    with torch.no_grad():
        heads = model.forward(state, batch)
        cpu_model = copy.deepcopy(model).cpu()
        ref = cpu_model.forward(dataclasses.replace(
            state, **{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)}),
            on_cpu(batch))
    return heads, ref


def phase_switches(device, card):
    """Phase 43: MBM at config-berlin widths under each encoder switch and
    with both contexts, through the module path (every kernel gate off, as
    in JAX): the forward on the card against the CPU, a 99-step request of
    SWITCH_B jets, and 8 train steps of the conditional model; K1, K2 and K3
    launched 0 times. Beside them the kernel path's jets/s at the same size."""
    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    kernel_model = make_model(device)
    source = gauss_noise_source_batch(SWITCH_B, N, 3, 8, gen, device=device, num_empty=1)
    timed_predict(kernel_model, source, gen)  # the allocator's first request of this size
    _, kernel_seconds = timed_predict(kernel_model, source, gen)
    del kernel_model

    torch.cuda.synchronize()
    reset_counts()  # the switch paths' run starts here
    records = {}
    for name, sections in SWITCHES.items():
        config = apply_sections(make_config(), sections)
        model = init_mbm_parameters(MultiModalBridgeMatching(config), SEED).to(device).eval()
        if model.kernel_enabled(device) or model.wide_kernel_enabled(device):
            raise RuntimeError(f"a kernel gate holds for the {name} switch")
        t, x, k, mask = random_inputs(SWITCH_B, device, gen)
        batch = with_contexts(MultimodalDatabatch(x, k, mask), config, gen, device)
        heads, ref = card_against_cpu(model, HybridState(t, x, k, mask), batch)
        forward = {head: compare(getattr(heads, head).cpu(), getattr(ref, head))
                   for head in ("continuous", "discrete")}
        source = with_contexts(gauss_noise_source_batch(SWITCH_B, N, 3, 8, gen, device=device,
                                                        num_empty=1), config, gen, device)
        out, seconds = timed_predict(model, source, gen)
        if name == "both_contexts":  # the steady request
            out, seconds = timed_predict(model, source, gen)
        rec = {"forward_vs_cpu": forward, "seconds": seconds, "jets_per_s": SWITCH_B / seconds,
               **check_generated(out, source, SWITCH_B)}
        records[name] = rec
        emit({"phase": "switches", "switch": name, "B": SWITCH_B, "N": N, **rec, "card": card})
        if not all(f["within_tol"] for f in forward.values()):
            raise RuntimeError(f"the {name} forward on the card parts from the CPU: {forward}")

    config = apply_sections(make_config(), CONTEXT)
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED)
    trainer.setup()
    batches = [with_contexts(synthetic_training_batch(SWITCH_TRAIN_B, N, 3, 8, gen,
                                                      device=device), config, gen, device)
               for _ in range(SWITCH_TRAIN_STEPS)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = [trainer.train_step(b)["loss"].item() for b in batches]
    train_seconds = time.perf_counter() - start
    launches, ok = launched({})
    finite = all(math.isfinite(v) for v in losses)
    emit({"phase": "switches_train", "B": SWITCH_TRAIN_B, "N": N, "steps": len(losses),
          "losses": losses, "finite": finite, "steps_per_s": len(losses) / train_seconds,
          "launches": launches, "plain_calls": plain_calls(),
          "conditional_jets_per_s": records["both_contexts"]["jets_per_s"],
          "kernel_path_jets_per_s": SWITCH_B / kernel_seconds, "card": card})
    if not ok or not finite:
        raise RuntimeError(f"switch paths: launches {launches}, losses {losses}")
    return {name: all_counts()[name] for name in ("epic_forward", "sampler_step", "epic_backward")}


def phase_conditional_absorbing(device, card):
    """Phase 44: AbsorbingFlow with both contexts. No trunk kernel takes a
    context, so a step is the module trunk and K6 (as in JAX): K6 against its
    plain version on one step's states, then two requests of ABS_B jets
    (K6 99 times each, K1 none), then 4 train steps (no kernel)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 44)
    config = apply_sections(AbsorbingConfig(), CONTEXT)
    config.bridge.num_timesteps = 100  # as phase 20's model
    model = init_absorbing_parameters(AbsorbingFlow(config), SEED).to(device).eval()
    trunk, head = model.pack_for_kernel()
    if trunk is not None or not model._pallas_enabled(device):
        raise RuntimeError("the conditional absorbing model should take the module trunk and K6")
    cfg_g = config.generator
    t, x, k, mask = scattered_inputs(ABS_B, ABS_N, device, gen)
    state = AbsorbingBridgeState(t, x, k, mask.long())
    batch = with_contexts(absorbing_training_batch(ABS_B, ABS_N, 3, 8, gen, device=device,
                                                   num_empty=1), config, gen, device)
    with torch.no_grad():
        _, _, last = model.generator.trunk_and_heads(state, batch)
        tp = project_time_embeddings(model.generator, t, cfg_g.n_attn_blocks, cfg_g.transformer_dim)
        got = survival_head(head, tp, last.contiguous(), state.mask_t, n_heads=cfg_g.n_heads)
        ref = survival_head_reference(head, tp, last.contiguous(), state.mask_t,
                                      n_heads=cfg_g.n_heads)
    err = (got - ref).abs()
    k6 = {"max_abs_err": err.max().item(), "max_abs_ref": ref.abs().max().item(),
          "within_tol": bool((err <= K6_TOL + K6_TOL * ref.abs()).all().item())}
    emit({"phase": "conditional_absorbing_k6", "B": ABS_B, "N": ABS_N, "atol": K6_TOL,
          "rtol": K6_TOL, **k6})
    if not k6["within_tol"]:
        raise RuntimeError(f"K6 on the conditional trunk's states disagrees: {k6}")

    steps = len(model.time_grid()[0]) - 1
    torch.cuda.synchronize()
    reset_counts()  # the conditional absorbing serving path's run starts here
    for request in range(2):
        before = survival_head.launches
        out, seconds = timed_predict(model, batch, gen)
        checks = check_generated_absorbing(out, batch, ABS_B)
        k6_launches = survival_head.launches - before
        emit({"phase": "conditional_absorbing", "request": request, "B": ABS_B, "N": ABS_N,
              "K6_launches": k6_launches, "K1_launches": epic_forward.launches,
              "seconds": seconds, "jets_per_s": ABS_B / seconds,
              "multiplicity_out": out.mask_t.sum().item() / ABS_B, "card": card, **checks})
        if k6_launches != steps:
            raise RuntimeError(f"a conditional absorbing request launched K6 {k6_launches} times")
    serving, ok = launched({"survival_head": 2 * steps})
    if not ok:
        raise RuntimeError(f"the conditional absorbing path launched {serving}")

    trainer = Trainer(AbsorbingFlow(config).to(device), config, seed=SEED)
    trainer.setup()
    batches = [with_contexts(absorbing_training_batch(ABS_B, ABS_N, 3, 8, gen, device=device),
                             config, gen, device) for _ in range(COND_ABS_TRAIN_STEPS)]
    reset_counts()
    losses = [trainer.train_step(b)["loss"].item() for b in batches]
    launches, ok = launched({})
    finite = all(math.isfinite(v) for v in losses)
    emit({"phase": "conditional_absorbing_train", "B": ABS_B, "N": ABS_N, "losses": losses,
          "finite": finite, "launches": launches, "card": card})
    if not ok or not finite:
        raise RuntimeError(f"conditional absorbing training: launches {launches}, {losses}")
    return serving


def twin(model, config):
    """A model of `config` (another compute dtype) with `model`'s weights."""
    other = type(model)(config)
    other.load_state_dict(model.state_dict())
    return other.to(next(model.parameters()).device).eval()


def bf16_config(config):
    config = copy.deepcopy(config)
    config.parallel.compute_dtype = "bfloat16"
    return config


def bf16_gap(got, ref_bf16, ref_f32):
    """The card's bf16 head against the CPU's, as shares of the CPU's own
    float32-vs-bf16 gap (mean, largest)."""
    gap, control = (got.cpu() - ref_bf16).abs(), (ref_f32 - ref_bf16).abs()
    return {"mean_share": (gap.mean() / control.mean()).item(),
            "max_share": (gap.max() / control.max()).item()}


def phase_bf16(device, card):
    """Phase 45: `compute_dtype: "bfloat16"`. The kernels' gates do not read
    the dtype (as in JAX): config-berlin serves through K2 and trains through
    K1/K3 with the float32 config's bits. The module path casts: the
    conditional MBM's forward on the card against the CPU's, 8 train steps;
    AbsorbingFlow trains under bf16 and serves through K1 and K6 in float32.
    Then, as information, the scaled MBM's module path in float32 and bf16
    beside its K4 path."""
    gen = torch.Generator(device=device).manual_seed(SEED + 45)
    f32 = make_model(device)
    bf16 = twin(f32, bf16_config(f32.config))
    batch = gauss_noise_source_batch(TIMING_B, N, 3, 8, gen, device=device, num_empty=1)
    torch.cuda.synchronize()
    reset_counts()  # the bf16 serving run
    out, seconds = timed_predict(bf16, batch, torch.Generator(device=device).manual_seed(SEED + 46))
    predict_counts, predict_ok = launched({"sampler_step": len(f32.time_grid()[0]) - 1})
    ref = f32.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 46))
    predict_bits = bool(torch.equal(out.continuous, ref.continuous)
                        and torch.equal(out.discrete, ref.discrete))

    train_batch = synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)
    draws = (torch.rand((TRAIN_B,), generator=gen, device=device),
             torch.randn((TRAIN_B, N, 3), generator=gen, device=device),
             torch.rand((TRAIN_B, N), generator=gen, device=device))
    steps = []
    for config in (bf16_config(train_config()), train_config()):
        trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED)
        trainer.setup()
        reset_counts()
        loss = trainer.train_step(train_batch, draws)["loss"]
        steps.append((loss, {k: p.detach().clone() for k, p in trainer.state.params.items()},
                      all_counts(), plain_calls()))
    train_counts = {k: v for k, v in steps[0][2].items() if v}
    train_bits = bool(torch.equal(steps[0][0], steps[1][0]) and all(
        torch.equal(p, steps[1][1][k]) for k, p in steps[0][1].items()))
    emit({"phase": "bf16_kernel_paths", "predict_B": TIMING_B, "predict_launches": predict_counts,
          "predict_same_bits_as_float32": predict_bits, "predict_jets_per_s": TIMING_B / seconds,
          "train_B": TRAIN_B, "train_launches": train_counts,
          "train_step_same_bits_as_float32": train_bits, "card": card})
    if not (predict_ok and predict_bits and train_bits and steps[0][3] == 0
            and train_counts == {"epic_forward": 1, "epic_backward": 1}):
        raise RuntimeError("the bf16 config-berlin model left its float32 kernel path")

    # the conditional MBM under bf16: the module path, which casts
    config = bf16_config(apply_sections(make_config(), CONTEXT))
    model = init_mbm_parameters(MultiModalBridgeMatching(config), SEED).to(device).eval()
    t, x, k, mask = random_inputs(SWITCH_B, device, gen)
    cbatch = with_contexts(MultimodalDatabatch(x, k, mask), config, gen, device)
    state = HybridState(t, x, k, mask)
    heads, ref_bf16 = card_against_cpu(model, state, cbatch)
    _, ref_f32 = card_against_cpu(twin(model, apply_sections(
        copy.deepcopy(config), {"parallel": {"compute_dtype": "float32"}})), state, cbatch)
    shares = {h: bf16_gap(getattr(heads, h), getattr(ref_bf16, h), getattr(ref_f32, h))
              for h in ("continuous", "discrete")}
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED)
    trainer.setup()
    reset_counts()
    losses = [trainer.train_step(with_contexts(synthetic_training_batch(
        TRAIN_B, N, 3, 8, gen, device=device), config, gen, device))["loss"].item()
        for _ in range(BF16_TRAIN_STEPS)]
    cond_counts, cond_ok = launched({})
    float32_params = all(p.dtype == torch.float32 for p in trainer.model.parameters())
    rec = {"phase": "bf16_conditional", "B": SWITCH_B, "forward_vs_cpu_shares": shares,
           "mean_share_bound": BF16_MEAN_SHARE, "max_share_bound": BF16_MAX_SHARE,
           "train_B": TRAIN_B, "losses": losses, "params_float32": float32_params,
           "launches": cond_counts, "card": card}
    emit(rec)
    if not (all(s["mean_share"] <= BF16_MEAN_SHARE and s["max_share"] <= BF16_MAX_SHARE
                for s in shares.values()) and cond_ok and float32_params
            and all(math.isfinite(v) for v in losses)):
        raise RuntimeError(f"the conditional bf16 MBM: {rec}")

    # AbsorbingFlow under bf16: trains on the cast module forward, serves in float32
    config = bf16_config(AbsorbingConfig())
    trainer = Trainer(AbsorbingFlow(config).to(device), config, seed=SEED)
    trainer.setup()
    losses = [trainer.train_step(absorbing_training_batch(ABS_B, ABS_N, 3, 8, gen,
                                                          device=device))["loss"].item()
              for _ in range(COND_ABS_TRAIN_STEPS)]
    f32_abs = make_absorbing(device)
    bf16_abs = twin(f32_abs, bf16_config(f32_abs.config))
    abs_batch = absorbing_training_batch(BF16_ABS_B, ABS_N, 3, 8, gen, device=device,
                                         num_empty=1)
    reset_counts()  # the bf16 absorbing serving run
    out = bf16_abs.predict(abs_batch, generator=torch.Generator(device=device).manual_seed(SEED))
    steps = len(f32_abs.time_grid()[0]) - 1
    abs_counts, abs_ok = launched({"epic_forward": steps, "survival_head": steps})
    ref = f32_abs.predict(abs_batch, generator=torch.Generator(device=device).manual_seed(SEED))
    abs_bits = all(torch.equal(getattr(out, f), getattr(ref, f))
                   for f in ("continuous", "discrete", "mask_t"))
    rec = {"phase": "bf16_absorbing", "train_B": ABS_B, "losses": losses,
           "predict_B": BF16_ABS_B, "predict_launches": abs_counts,
           "predict_same_bits_as_float32": abs_bits, "card": card}
    emit(rec)
    if not (abs_ok and abs_bits and all(math.isfinite(v) for v in losses)):
        raise RuntimeError(f"bf16 AbsorbingFlow: {rec}")

    # information only: the scaled MBM's module path in float32 and bf16 beside K4
    model = make_model(device, **SCALED)
    data_dependent_gains(model, device)
    scaled_batch = gauss_noise_source_batch(SCALED_BF16_B, N, 3, 8, gen, device=device)
    timings = {}
    for name, use_pallas, dtype in (("k4", "auto", "float32"), ("module_float32", False, "float32"),
                                    ("module_bfloat16", False, "bfloat16")):
        model.config.parallel.use_pallas, model.config.parallel.compute_dtype = use_pallas, dtype
        out, seconds = timed_predict(model, scaled_batch, gen)
        timings[name] = {"seconds": seconds, "jets_per_s": SCALED_BF16_B / seconds,
                         "finite": bool(torch.isfinite(out.continuous).all().item())}
    emit({"phase": "bf16_scaled_timing", "B": SCALED_BF16_B, "N": N, **timings, "card": card})
    return {"bf16_predict": predict_counts, "bf16_train": train_counts,
            "bf16_absorbing_predict": abs_counts}


def switch_phases(device, card):
    """Phases 43-45; the launch counts of their paths for the kernels line."""
    switches = phase_switches(device, card)
    conditional = phase_conditional_absorbing(device, card)
    bf16 = phase_bf16(device, card)
    return switches, conditional, bf16


# ------------------------- phases 46-49: the quality path (shard, harness, evaluation)


def phase_synth_shard(card, runs):
    """The synthetic JetClass shard (scripts/torch_make_jetclass_synth.py) at
    20,000 jets of 64 slots, written as .npz and read back through the port's
    JetClass reader: its jets and slots, each jet's multiplicity equal to the
    shard's mask count (5 to 64), the mask 0/1 and a prefix after the reader
    sorts by pt, the kinematics finite and zero on dead slots."""
    path = runs / "jetclass_synth.npz"
    start = time.perf_counter()
    synth.write_synthetic_jetclass_npz(str(path), SYNTH_JETS, SYNTH_SLOTS)
    write_seconds = time.perf_counter() - start
    start = time.perf_counter()
    jets = ParticleClouds("JetClass", [str(path)], max_num_particles=SYNTH_SLOTS,
                          num_jets=SYNTH_JETS)
    read_seconds = time.perf_counter() - start
    with np.load(path) as f:
        counts = f["mask"].sum(axis=1)
    mask = jets.mask[..., 0]
    mult = mask.sum(axis=1)
    checks = {
        "jets_and_slots": mask.shape == (SYNTH_JETS, SYNTH_SLOTS),
        "counts_equal": bool((mult == counts).all()),
        "counts_in_range": bool(counts.min() >= 5 and counts.max() <= SYNTH_SLOTS),
        "mask_01_prefix": bool((mask == (np.arange(SYNTH_SLOTS)[None, :] < mult[:, None])).all()),
        "finite": bool(np.isfinite(jets.continuous).all()),
        "dead_slots_zero": bool((jets.continuous[mask == 0] == 0).all()),
    }
    emit({"phase": "synth_shard", "jets": SYNTH_JETS, "slots": SYNTH_SLOTS,
          "bytes": path.stat().st_size, "multiplicity_mean": float(mult.mean()),
          "multiplicity_min_max": [int(counts.min()), int(counts.max())], **checks,
          "write_seconds": write_seconds, "read_seconds": read_seconds, "card": card})
    if not all(checks.values()):
        raise RuntimeError(f"the synthetic shard failed its checks: {checks}")


def quality_args(family, epochs, steps, workdir, device):
    return quality.parse_args([
        "--family", family, "--epochs", str(epochs), "--gen-jets", str(QUALITY_GEN_JETS),
        "--gen-chunk", str(QUALITY_GEN_CHUNK), "--sampler-steps", str(steps),
        "--device", str(device), "--workdir", str(workdir), "--skip-ref-mode"])


def all_finite(*sections):
    """Every reading of the sections a number and finite."""
    return all(v is not None and math.isfinite(v) for sec in sections for v in sec.values())


def quality_runs(device, family, epochs, steps, runs, expected):
    """The harness of `family` untrained (its seeded weights) and trained for
    `epochs`, each counted: {name: (result, launches, exactly as
    `expected(result)` with no plain call, seconds)}."""
    out = {}
    for name, n_epochs in (("untrained", 0), ("trained", epochs)):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = quality.run(quality_args(family, n_epochs, steps,
                                          runs / f"quality_{family}_{name}", device))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches, ok = launched(expected(result))
        out[name] = (result, launches, ok, seconds)
    return out


def quality_line(phase, runs, card, **extra):
    """The phase's line: per run the readings, launches and seconds."""
    def summary(result, launches, ok, seconds):
        keep = {k: v for k, v in result.items() if k not in ("protocol", "config")}
        return {**keep, "launches": launches, "launches_as_expected": ok, "seconds": seconds}
    emit({"phase": phase, **{name: summary(*run) for name, run in runs.items()},
          "plain_calls": plain_calls(), **extra, "card": card})


def phase_quality_absorbing(device, card, runs):
    """scripts/torch_quality_families.py --family absorbing on the card: the
    AbsorbingFlow of config-absorbing-test trained QUALITY_ABS_EPOCHS epochs
    on the bundled shard, 4096 jets generated in requests of 1024 at 100
    sampler steps, scored against the shard; beside it the same harness on the
    seeded weights (0 epochs). Gates: K1 (hidden output) and K6 launched 99
    times a request in each run (training launches none, as in JAX), no plain
    call; the training loss falls; every reading finite; the trained model's
    multiplicity histogram closer to the data's (KL_mult_hist) than the
    untrained model's. KL_mult_hist against KL_mult_hist_init (the source
    masks', drawn from the data's histogram) is printed: the solver only
    births, so it can move a jet only away from its draw, and the JAX
    package's own reading has KL_mult_hist above KL_mult_hist_init."""
    def expected(result):
        steps = (QUALITY_ABS_STEPS - 1) * result["predict_calls"]
        return {"epic_forward": steps, "survival_head": steps}

    done = quality_runs(device, "absorbing", QUALITY_ABS_EPOCHS, QUALITY_ABS_STEPS, runs, expected)
    trained, untrained = done["trained"][0], done["untrained"][0]
    mask, mask_untrained = trained["mask_dynamics"], untrained["mask_dynamics"]
    gates = {
        "launches": done["trained"][2] and done["untrained"][2],
        "loss_falls": trained["final_train_loss"] < trained["train_loss_first"],
        "readings_finite": all_finite(trained["metrics"], mask),
        "KL_mult_hist_below_untrained": mask["KL_mult_hist"] < mask_untrained["KL_mult_hist"],
    }
    quality_line("quality_absorbing", done, card, gates=gates,
                 KL_mult_hist_below_init=mask["KL_mult_hist"] < mask["KL_mult_hist_init"])
    if not all(gates.values()):
        raise RuntimeError(f"quality_absorbing failed its gates: {gates}")
    return done["trained"][1]


def phase_quality_transdim(device, card, runs):
    """scripts/torch_quality_families.py --family transdimensional on the
    card: the tuned block (ce_w 200, rate_w 100, lr 1e-3, EMA half-life 10
    kimg) trained QUALITY_TD_EPOCHS epochs on the bundled shard, 4096 jets at
    the 96-step headline (multi_birth 16, the analytic posterior at every
    state), scored against the shard and the prior; beside it the seeded
    weights (0 epochs). Gates: K1 (folded input) once and K7 twice a network
    evaluation in each run, no plain call; the training loss falls; every
    reading finite; the trained model's share of diverged constituents
    (|pt| ≥ 50 standardized) below the untrained model's; its mean
    multiplicity within MAX_MULTIPLICITY_SHIFT of the data's. Printed for both
    runs: KL_mult_gen_vs_data, which is the same number (with the analytic
    posterior at every state the births follow the prior whatever the
    weights, from the same draws), and the standardized pt's W1 over the
    constituents that did not diverge (a few hundred epochs leave most of the
    trained flow's constituents diverged: the JAX reading took 3000). Then,
    with the trained weights, phase 27's kernel-vs-module comparison
    (paths_transdim_trained): its worst K7 call's share of K7's gate."""
    config = quality.tuned_transdim_config(QUALITY_TD_STEPS)
    if config.sampler_kwargs.corrector_steps:
        raise RuntimeError("the phase counts one network evaluation a sampler step")
    nfe = len(_build_time_grid(config.sampler_kwargs)[0])

    def expected(result):
        calls = nfe * result["predict_calls"]
        return {"epic_forward": calls, "gsdm_stack": 2 * calls}

    done = quality_runs(device, "transdimensional", QUALITY_TD_EPOCHS, QUALITY_TD_STEPS, runs,
                        expected)
    trained, untrained = done["trained"][0], done["untrained"][0]
    metrics, metrics_untrained = trained["metrics"], untrained["metrics"]
    gates = {
        "launches": done["trained"][2] and done["untrained"][2],
        "loss_falls": trained["final_train_loss"] < trained["train_loss_first"],
        "readings_finite": all_finite(metrics, trained["physics_metrics"]),
        "diverged_below_untrained": (metrics["diverged_constituent_frac"]
                                     < metrics_untrained["diverged_constituent_frac"]),
        "multiplicity_near_data": (abs(metrics["mult_mean_gen"] - metrics["mult_mean_data"])
                                   <= MAX_MULTIPLICITY_SHIFT * metrics["mult_mean_data"]),
    }
    quality_line("quality_transdim", done, card, nfe_a_request=nfe, gates=gates,
                 KL_mult_gen_vs_data_below_untrained=(
                     metrics["KL_mult_gen_vs_data"] < metrics_untrained["KL_mult_gen_vs_data"]),
                 W1_pt_standardized_below_untrained=(
                     metrics["W1_pt_standardized"]
                     < metrics_untrained.get("W1_pt_standardized", math.inf)))
    if not all(gates.values()):
        raise RuntimeError(f"quality_transdim failed its gates: {gates}")

    weights = torch.load(runs / "quality_transdimensional_trained" / quality.PARAMS_FILE,
                         map_location=device, weights_only=True)
    rec = phase_paths_transdim(device, phase="paths_transdim_trained", weights=weights)
    share = rec["kernel_err_over_bound"]["gsdm_stack"]
    emit({"phase": "paths_transdim_trained_k7", "worst_share_of_K7_gate": share,
          "trunk_worst_share_of_gate": rec["kernel_err_over_bound"]["trunk"], "card": card})
    return {**done["trained"][1], "k7_share_of_gate": share}


def phase_evaluate(device, card, runs, mbm):
    """scripts/torch_evaluate.py on phase 36's run directory: the MBM run
    reloaded from its params.yaml and 'best' checkpoint on the card, its
    validation batches generated (K2 99 times a request, no plain call) and
    scored; every KL/W1 of pt, m, η and φ finite."""
    steps = MultimodalBridgeMatchingConfig.from_yaml(str(MBM_EXPERIMENT_YAML)).bridge.num_timesteps - 1
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = torch_evaluate.evaluate_experiment(experiment_dir=str(runs / "mbm"), device=device,
                                                 seed=SEED)
    seconds = time.perf_counter() - start
    launches, ok = launched({"sampler_step": steps * mbm["generate_batches"]})
    finite = all(metrics[f"{kind}_{f}"] is not None and math.isfinite(metrics[f"{kind}_{f}"])
                 for f in ("pt", "m", "eta", "phi") for kind in ("KL", "W1"))
    emit({"phase": "evaluate", "experiment": "phase 36's run directory",
          "requests": mbm["generate_batches"], "launches": launches, "plain_calls": plain_calls(),
          "metrics": metrics, "kinematics_finite": finite, "seconds": seconds, "card": card})
    if not (ok and finite):
        raise RuntimeError(f"evaluate launched {launches}; kinematic metrics finite: {finite}")
    return launches


def quality_phases(device, card, runs, mbm):
    """Phases 46-49; the launch counts of their paths for the kernels line."""
    phase_synth_shard(card, runs)
    absorbing = phase_quality_absorbing(device, card, runs)
    transdim = phase_quality_transdim(device, card, runs)
    evaluated = phase_evaluate(device, card, runs, mbm)
    return absorbing, transdim, evaluated

def transdim_context_config():
    """The transdimensional model at its reference widths with both contexts
    (CONTEXT) and the sampler of phase 26 (48 steps, multi_birth 24)."""
    config = apply_sections(TransdimensionalEpicConfig(), CONTEXT)
    config.data.max_num_particles = TD_N
    config.sampler_kwargs.dt = 1.0 / TD_STEPS
    config.sampler_kwargs.multi_birth = TD_MULTI_BIRTH
    return config


def with_list_contexts(batch, config, gen, device):
    """A 'list' batch with the contexts as the list loader carries them:
    normal continuous values and the one-hot of a token uniform in the
    context vocabulary (jets_dataloader.py:94-95 one-hots the first token)."""
    B, d = batch[0].shape[0], config.data
    context = torch.randn((B, d.dim_context_continuous), generator=gen, device=device)
    tokens = torch.randint(0, d.vocab_size_context, (B,), generator=gen, device=device)
    one_hot = (tokens[:, None] == torch.arange(d.vocab_size_context, device=device)).float()
    return [*batch, context, one_hot]


def contexts_kept(state, batch):
    """The final states' contexts the template's, bit for bit."""
    return bool(torch.equal(state.context_continuous, batch[3])
                and torch.equal(state.context_discrete, batch[4]))


def phase_transdim_context(device, card):
    """Phase 50: the transdimensional model with both contexts, trained and
    served on the card through its modules (no kernel takes a context, as in
    JAX); a 24-step trajectory on the card against the card's CPU."""
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    config = transdim_context_config()
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), SEED).to(device)
    reason = model.kernel_refusal()
    if model._pallas_enabled(device) or reason is None:
        raise RuntimeError("a kernel gate holds for the transdimensional model with a context")

    trainer = Trainer(model, config, seed=SEED)
    trainer.setup()
    batches = [with_list_contexts(transdim_training_batch(TDC_TRAIN_B, TD_N, 3, 8, gen,
                                                          device=device), config, gen, device)
               for _ in range(TDC_TRAIN_STEPS)]
    torch.cuda.synchronize()
    reset_counts()  # the context model's training starts here
    start = time.perf_counter()
    losses = [trainer.train_step(b)["loss"].item() for b in batches]
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - start
    train_launches, train_ok = launched({})

    # one network evaluation on the card against the card's CPU, on noisy states with contexts
    state, ts = transdim_state(TDC_PATHS_B, TD_N, device, gen)
    contexts = with_list_contexts([state.dims], config, gen, device)[1:]
    state = state.replace(context_continuous=contexts[0], context_discrete=contexts[1])
    nearest = (state.dims.long() - 1).clamp(min=0)
    model.eval()
    with torch.no_grad():
        heads = model.network(state, ts, nearest)
        cpu_state = dataclasses.replace(state, **{f.name: getattr(state, f.name).cpu()
                                                  for f in dataclasses.fields(state)})
        ref_heads = copy.deepcopy(model.network).cpu()(cpu_state, ts.cpu(), nearest.cpu())
    forward = {name: compare(h.cpu(), r, TDC_FORWARD_TOL) for name, h, r in zip(
        ("D_xt", "rate_emb", "near_atom_logits", "auto_mean", "auto_std"), heads, ref_heads)}

    template = with_list_contexts(transdim_training_batch(TDC_SERVE_B, TD_N, 3, 8, gen,
                                                          device=device), config, gen, device)
    attach_prior(model, template)
    model.eval()
    reset_counts()  # the context model's serving path starts here
    requests = [timed_predict(model, template, gen) for _ in range(2)]
    serve_launches, serve_ok = launched({})
    out, seconds = requests[-1]
    checks = {"losses_finite": all(math.isfinite(v) for v in losses),
              "dims_in_range": bool(all(o.dims.min() >= 1 and o.dims.max() <= TD_N
                                        for o, _ in requests)),
              "finite": bool(all(torch.isfinite(o.get_flat_lats()).all() for o, _ in requests)),
              "contexts_kept": all(contexts_kept(o, template) for o, _ in requests)}

    paths_config = copy.deepcopy(config)
    paths_config.sampler_kwargs.dt = 1.0 / TDC_PATHS_STEPS
    paths_config.sampler_kwargs.multi_birth = 1  # the CPU test's single birth
    twin = TransdimensionalJumpDiffusion(paths_config)
    twin.load_state_dict(model.state_dict())
    twin = twin.to(device).eval()
    batch = with_list_contexts(transdim_training_batch(TDC_PATHS_B, TD_N, 3, 8, gen,
                                                       device=device), config, gen, device)
    attach_prior(twin, batch)
    D, T, kw = TD_N * 11, TDC_PATHS_STEPS, dict(generator=gen, device=device)
    draws = {"init": torch.randn((TDC_PATHS_B, D), **kw),
             "em_noise": torch.randn((T, TDC_PATHS_B, D), **kw),
             "birth_noise": torch.randn((T, TDC_PATHS_B, D), **kw),
             "u_jump": 0.5 * torch.rand((T, TDC_PATHS_B), **kw),  # births happen
             "gumbel": sample_gumbel((T, TDC_PATHS_B, TD_N), gen, device)}
    reset_counts()
    got, _ = twin.sample(twin._as_state(batch), draws=draws)
    cpu_twin = copy.deepcopy(twin).cpu()
    cpu_batch = [b.cpu() for b in batch]
    cpu_draws = {k: v.cpu() for k, v in draws.items()}
    ref, _ = cpu_twin.sample(cpu_twin._as_state(cpu_batch), draws=cpu_draws)
    nudged, _ = cpu_twin.sample(cpu_twin._as_state(cpu_batch), draws={
        **cpu_draws, "em_noise": cpu_draws["em_noise"] * (1 + ULP)})
    paths_launches, paths_ok = launched({})

    def parted(a, b):
        """(dims equal share, the jets parted beyond TDC_PATHS_TOL of their scale, each
        jet's largest |Δ latents| over its scale) of a against b."""
        same = a.dims.cpu() == b.dims
        scale = b.get_flat_lats().abs().amax(dim=1).clamp(min=1.0)
        shares = (a.get_flat_lats().cpu() - b.get_flat_lats()).abs().amax(dim=1) / scale
        return same.float().mean().item(), int(((shares > TDC_PATHS_TOL) | ~same).sum()), shares

    equal, over, shares = parted(got, ref)
    _, nudged_over, _ = parted(nudged, ref)
    paths = {"jets": TDC_PATHS_B, "steps": T, "equal_dims_share": equal, "tol": TDC_PATHS_TOL,
             "jets_over_tol": over, "cpu_vs_cpu_1ulp_jets_over_tol": nudged_over,
             "jets_over_tol_allowed": PART_FACTOR * nudged_over + PART_SLACK,
             "share_within_tol": (shares <= TDC_PATHS_TOL).float().mean().item(),
             "worst_err_over_scale": shares.max().item(),
             "median_err_over_scale": shares.median().item(),
             "nonzero_latents": bool(ref.get_flat_lats().abs().max().item() > 0),
             "contexts_kept": contexts_kept(got, batch) and contexts_kept(ref, cpu_batch)}
    checks.update(forward_within_tol=all(f["within_tol_per_particle"] for f in forward.values()),
                  paths_within_gate=equal >= MIN_EQUAL_DIMS
                  and over <= paths["jets_over_tol_allowed"] and paths["nonzero_latents"]
                  and paths["contexts_kept"],
                  no_kernel=train_ok and serve_ok and paths_ok)
    emit({"phase": "transdim_context", "N": TD_N, "train_B": TDC_TRAIN_B, "losses": losses,
          "train_steps_per_s": len(losses) / train_seconds, "serve_B": TDC_SERVE_B,
          "seconds": seconds, "jets_per_s": TDC_SERVE_B / seconds,
          "first_request_seconds": requests[0][1], "mean_dims": out.dims.float().mean().item(),
          "kernel_gate": False, "gate_reason": reason,
          "launches": {"train": train_launches, "serve": serve_launches, "paths": paths_launches},
          "plain_calls": plain_calls(), "forward_vs_cpu": forward, "paths_card_vs_cpu": paths,
          **checks, "card": card})
    if not all(checks.values()):
        raise RuntimeError(f"transdim_context failed its checks: {checks}")
    return {"epic_forward": 0, "gsdm_stack": 0}


def requests_of(jets, chunk):
    return -(-jets // chunk)


def phase_quality_parity(device, card):
    """Phase 51: the MBM head-to-head harness with the JAX readings beside."""
    args = quality_parity.parse_args([
        "--train-steps", str(QP_TRAIN_STEPS), "--gen-jets", str(QP_GEN_JETS), "--device",
        str(device), "--jax-readings", str(ROOT / "benchmarks" / "quality_parity_mbm.json")])
    reset_counts()
    start = time.perf_counter()
    result = quality_parity.run(args)
    seconds = time.perf_counter() - start
    launches, side = result["launches"], result["rebuilt"]
    steps = result["train_steps"]
    k2 = (result["sampler_steps"] - 1) * requests_of(args.gen_jets, args.gen_chunk)
    gates = {
        "train_launches": (launches["train"].get("epic_backward") == steps
                           and launches["train"].get("epic_forward", 0) >= steps
                           and set(launches["train"]) == {"epic_forward", "epic_backward"}),
        "generate_launches": launches["generate"] == {"sampler_step": k2},
        "no_plain_call": plain_calls() == 0,
        "loss_falls": side["final_train_loss"] < side["train_loss_first"],
        "readings_finite": all_finite(side["metrics"]),
    }
    emit({"phase": "quality_parity", **{k: v for k, v in result.items() if k != "protocol"},
          "gates": gates, "seconds": seconds, "card": card})
    if not all(gates.values()):
        raise RuntimeError(f"quality_parity failed its gates: {gates}")
    return launches


def scaled_data_expected(family, result, gen_chunk):
    """Each family's generation launches: K2 once a step (MBM); K1 and K6
    once a step (absorbing); K1 once and K7 twice a network evaluation
    (transdim; no corrector: an evaluation a step)."""
    requests = requests_of(result["gen_jets"], gen_chunk)
    steps = result["sampler_steps"]
    if family == "mbm":
        return {"sampler_step": (steps - 1) * requests}
    if family == "absorbing":
        return {"epic_forward": (steps - 1) * requests, "survival_head": (steps - 1) * requests}
    return {"epic_forward": steps * requests, "gsdm_stack": 2 * steps * requests}


def phase_scaled_data(device, card, runs):
    """Phase 52: the scaled-data harness of each family on phase 46's shard."""
    out = {}
    for family, setting in SCALED_DATA.items():
        argv = ["--family", family, "--shard", str(runs / "jetclass_synth.npz"),
                "--train-steps", str(SCALED_DATA_STEPS), "--batch-size", str(setting["batch"]),
                "--sampler-steps", str(setting["steps"]), "--gen-jets", str(SCALED_DATA_GEN),
                "--device", str(device), "--workdir", str(runs / f"scaled_{family}")]
        if family == "mbm":
            argv += ["--jax-readings", str(ROOT / "benchmarks" / "quality_mbm_scaled_data.json")]
        args = scaled_data.parse_args(argv)
        reset_counts()
        start = time.perf_counter()
        result = scaled_data.run(args)
        seconds = time.perf_counter() - start
        floors = {k: f["median"] for k, f in result["floors_at_this_scale"].items()
                  if f is not None}
        gates = {
            "generate_launches": (result["launches"]["generate"]
                                  == scaled_data_expected(family, result, args.gen_chunk)),
            "no_plain_call": plain_calls() == 0,
            "floors_finite_above_0": all(math.isfinite(f) and (f > 0 or k in ZERO_FLOORS)
                                         for k, f in floors.items()),
            "readings_finite": all_finite(result["rebuilt"]["metrics"]),
        }
        emit({"phase": "scaled_data", **{k: v for k, v in result.items() if k != "protocol"},
              "gates": gates, "seconds": seconds, "card": card})
        if not all(gates.values()):
            raise RuntimeError(f"scaled_data {family} failed its gates: {gates}")
        out[family] = result["launches"]
    return out


def phase_absorbing_stress(device, card, runs):
    """Phase 53: the absorbing head-to-head's nominal protocol and stress, and
    the death-channel sweep, on phase 47's trained weights."""
    weights = str(runs / "quality_absorbing_trained" / quality.PARAMS_FILE)
    common = ["--reuse-params", weights, "--epochs", str(QUALITY_ABS_EPOCHS), "--sampler-steps",
              str(QUALITY_ABS_STEPS), "--stress-jets", str(STRESS_JETS), "--seeds", str(SEED),
              "--device", str(device)]
    args = parity_absorbing.parse_args([*common, "--gen-jets", str(STRESS_GEN), "--jax-readings",
                                        str(ROOT / "benchmarks" /
                                            "quality_parity_absorbing.json")])
    reset_counts()
    start = time.perf_counter()
    run = parity_absorbing.run_seed(args, SEED, device,
                                    harness.load_jax_readings(args.jax_readings))
    parity_seconds = time.perf_counter() - start
    sweep_args = [*common, "--gen-jets", str(SWEEP_GEN), "--target-dropout", "0.0",
                  "--scales", *DEATH_SCALES]
    start = time.perf_counter()
    block = death_sweep.main(sweep_args)
    sweep_seconds = time.perf_counter() - start

    per_step = QUALITY_ABS_STEPS - 1
    stress_requests = requests_of(STRESS_JETS, args.gen_chunk)

    def both(requests):
        return {"epic_forward": per_step * requests, "survival_head": per_step * requests}

    seed_block = block["seeds"][0]
    sweep_requests = requests_of(SWEEP_GEN, args.gen_chunk) + 2 * stress_requests
    halved = seed_block["scales"]["0.0"]["halved"]
    readings = [run["rebuilt"]["metrics"]] + [seed_block["scales"][s]["nominal"]["metrics"]
                                              for s in DEATH_SCALES]
    gates = {
        "launches": (run["launches"]["generate"] == both(requests_of(STRESS_GEN, args.gen_chunk))
                     and run["launches"]["stress"] == both(2 * stress_requests)
                     and all(seed_block["scales"][s]["launches"] == both(sweep_requests)
                             for s in DEATH_SCALES)),
        "no_plain_call": plain_calls() == 0,
        "readings_finite": all_finite(*readings),
        "halved_KL_mult_falls_at_scale_0": halved["KL_mult_final"] < halved["KL_mult_init"],
    }
    emit({"phase": "absorbing_stress", "weights": "phase 47's trained run",
          "parity": {k: v for k, v in run.items()}, "parity_seconds": parity_seconds,
          "death_channel": {k: v for k, v in block.items() if k != "protocol"},
          "sweep_seconds": sweep_seconds,
          "halved_at_scale_0": {"KL_mult_init": halved["KL_mult_init"],
                                "KL_mult_final": halved["KL_mult_final"]},
          "gates": gates, "card": card})
    if not all(gates.values()):
        raise RuntimeError(f"absorbing_stress failed its gates: {gates}")
    return {name: run["launches"]["generate"][name] + run["launches"]["stress"][name]
            + sum(seed_block["scales"][s]["launches"][name] for s in DEATH_SCALES)
            for name in ("epic_forward", "survival_head")}


def phase_transdim_sweeps(device, card, runs):
    """Phase 54: the operating-point sweep and the trajectory diagnosis on
    phase 48's trained weights."""
    workdir = runs / "quality_transdimensional_trained"
    reset_counts()
    start = time.perf_counter()
    doc = operating_points.main([
        "--reuse-params", str(workdir / quality.PARAMS_FILE), "--points", OPERATING_POINTS,
        "--gen-jets", str(QUALITY_GEN_JETS), "--gen-chunk", str(QUALITY_GEN_JETS),
        "--device", str(device), "--params-provenance",
        f"chip_smoke.py phase 48: {QUALITY_TD_EPOCHS} epochs, seed {SEED}"])
    points_seconds = time.perf_counter() - start
    start = time.perf_counter()
    diag = diagnose.main(["--workdir", str(workdir), "--gen-jets", str(DIAGNOSE_JETS),
                          "--sampler-steps", str(QUALITY_TD_STEPS), "--multi-birth", "16",
                          "--device", str(device), "--seed", str(SEED)])
    diagnose_seconds = time.perf_counter() - start

    def per_evaluation(nfe):
        return {"epic_forward": nfe, "gsdm_stack": 2 * nfe}

    rows = diag["rows"]
    gates = {
        "launches": (all(r["launches"] == per_evaluation(r["sampler_steps"] * r["predict_calls"])
                         for r in doc["rows"])
                     and diag["launches"] == per_evaluation(diag["nfe"])),
        "no_plain_call": plain_calls() == 0,
        "table_finite": all(math.isfinite(v) for r in rows for v in r.values()),
        "points_finite": all(math.isfinite(r[k]) for r in doc["rows"]
                             for k in ("KL_mult", "W1_mult", "mult_mean_gen")),
        "mean_dims_in_range": all(1 <= r["mean_dims"] <= TD_N for r in rows)
        and all(1 <= r["mult_mean_gen"] <= TD_N for r in doc["rows"]),
    }
    emit({"phase": "transdim_sweeps", "weights": "phase 48's trained run",
          "operating_points": doc["rows"], "points_seconds": points_seconds,
          "diagnose": {k: v for k, v in diag.items()}, "diagnose_seconds": diagnose_seconds,
          "gates": gates, "card": card})
    if not all(gates.values()):
        raise RuntimeError(f"transdim_sweeps failed its gates: {gates}")
    calls = sum(r["sampler_steps"] * r["predict_calls"] for r in doc["rows"]) + diag["nfe"]
    return per_evaluation(calls)


def sweep_phases(device, card, runs):
    """Phases 50-54; the launch counts of their paths for the kernels line."""
    context = phase_transdim_context(device, card)
    parity = phase_quality_parity(device, card)
    scaled = phase_scaled_data(device, card, runs)
    stress = phase_absorbing_stress(device, card, runs)
    sweeps = phase_transdim_sweeps(device, card, runs)
    return context, parity, scaled, stress, sweeps



# ------------------------------- phases 55-59: data and tensor parallelism

DP_STEPS, DP_SCALED_STEPS, TP_STEPS = 5, 3, 3
TP_MBM_B, TP_TD_B = 2048, 512
BULK_DP_CHUNKS, BULK_DP_B = 4, 2 * BULK_B  # global chunks: BULK_B jets a rank a chunk
RANKS = 2
RANK_TIMEOUT = 300  # seconds for the two ranks' start and phases 56-59
TP_RTOL, TP_ATOL = 2e-4, 1e-5  # tests/test_parallel/test_tensor_parallel.py's bound
READINGS = {}  # phase 8's steps/s and phase 39's jets/s, printed beside phases 56 and 59


def parallel_batches(B, steps, device, family="mbm"):
    """`steps` training batches of B jets from a fixed seed, the same in every
    process."""
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    if family == "transdim":
        return [transdim_training_batch(B, TD_N, 3, 8, gen, device=device) for _ in range(steps)]
    return [synthetic_training_batch(B, N, 3, 8, gen, device=device) for _ in range(steps)]


def parallel_config(family, model_axis=1, use_pallas="auto"):
    if family == "transdim":
        config = TransdimensionalEpicConfig()
        config.data.max_num_particles = TD_N
    else:
        config = make_config(**SCALED) if family == "mbm_scaled" else train_config()
    config.parallel.model_axis, config.parallel.use_pallas = model_axis, use_pallas
    return config


def parallel_model(family, config, device):
    if family == "transdim":
        return TransdimensionalJumpDiffusion(config).to(device)
    return MultiModalBridgeMatching(config).to(device)


def gained_weights(family, device):
    """A family's seeded weights with `data_dependent_gains` set on the module
    path, whole: every process computes the same. (Seeded alone, the scaled
    backbone's heads reach 1e5 and the reference transdimensional model's
    first loss 1e14 on these batches.)"""
    init = init_transdimensional_parameters if family == "transdim" else init_mbm_parameters
    model = init(parallel_model(family, parallel_config(family), device), SEED)
    data_dependent_gains(model, device, transdim_probe if family == "transdim" else mbm_probe)
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def parallel_run(family, config, batches, device, mesh=None, weights=None):
    """A trainer from SEED (then `weights`, whole, where given) and one
    train step a batch on this rank's rows, counted from 0: (losses, the
    parameters whole, launches, plain calls, seconds of the steps after the
    first)."""
    trainer = Trainer(parallel_model(family, config, device), config, seed=SEED, mesh=mesh)
    trainer.setup()
    if weights is not None:
        trainer.copy_params(weights)
    rows = [trainer.shard(b)[0] for b in batches]
    torch.cuda.synchronize()
    reset_counts()
    losses = [trainer.train_step(rows[0])["loss"].item()]
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses += [trainer.train_step(b)["loss"].item() for b in rows[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: v for k, v in all_counts().items() if v}
    params = {k: trainer.whole(k, p.detach()).clone() for k, p in trainer.state.params.items()}
    return losses, params, launches, plain_calls(), seconds


def rank_phases(rank, store, outdir, device_type="cuda"):
    """One of the RANKS gloo ranks on the card: phases 56-59's runs, written
    to outdir/rank{rank}.pt; a failure's traceback to rank{rank}.err."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device_type, 0)
        if device_type == "cuda":
            torch.cuda.set_device(device)
            _build.load_library()
        dist.init_process_group("gloo", store=dist.FileStore(store, RANKS), rank=rank,
                                world_size=RANKS, timeout=datetime.timedelta(seconds=120))
        data_mesh = make_device_mesh(device_type=device_type)
        model_mesh = make_device_mesh(data_axis=1, model_axis=RANKS, device_type=device_type)
        gains = {f: gained_weights(f, device) for f in ("mbm_scaled", "transdim")}
        shard = ParticleClouds("AspenOpenJets", max_num_particles=N)
        while not (Path(outdir) / "go").exists():  # the parent's references first
            time.sleep(0.05)
        out = {"dp_train": parallel_run("mbm", parallel_config("mbm"),
                                        parallel_batches(TRAIN_B, DP_STEPS, device), device,
                                        data_mesh),
               "dp_train_scaled": parallel_run(
                   "mbm_scaled", parallel_config("mbm_scaled"),
                   parallel_batches(TRAIN_B, DP_SCALED_STEPS, device), device, data_mesh,
                   gains["mbm_scaled"])}
        for family, B in (("mbm_scaled", TP_MBM_B), ("transdim", TP_TD_B)):
            out[f"tp_{family}"] = parallel_run(
                family, parallel_config(family, model_axis=RANKS),
                parallel_batches(B, TP_STEPS, device, family), device, model_mesh, gains[family])
        model = make_model(device)
        torch.cuda.synchronize()
        reset_counts()
        _, stats = bulk_sample(model, model.config, BULK_DP_CHUNKS * BULK_DP_B,
                               batch_size=BULK_DP_B, seed=SEED,
                               target_multiplicity=shard.multiplicity, collect=False,
                               mesh=data_mesh)
        out["bulk_dp"] = (stats, {k: v for k, v in all_counts().items() if v}, plain_calls())
        torch.save(out, Path(outdir) / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(outdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start_ranks(outdir, device_type, target=None):
    """RANKS processes running `rank_phases` (or `target`), started by spawn."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or rank_phases,
                         args=(r, str(outdir / "store"), str(outdir), device_type))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, outdir):
    """Every rank's record, or a failure as soon as a rank fails or the
    RANK_TIMEOUT passes (the other ranks are stopped)."""
    deadline = time.monotonic() + RANK_TIMEOUT
    while any(p.is_alive() for p in procs):
        failed = [p for p in procs if p.exitcode not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.join()
            errors = [f.read_text() for f in sorted(outdir.glob("rank*.err"))]
            raise RuntimeError(f"a rank failed or hung (exit codes {[p.exitcode for p in procs]}): "
                               f"{errors}")
        time.sleep(0.1)
    if any(p.exitcode for p in procs):
        raise RuntimeError(f"the ranks exited with {[p.exitcode for p in procs]}: "
                           f"{[f.read_text() for f in sorted(outdir.glob('rank*.err'))]}")
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


def worst_param_diff(got, ref):
    """The largest |Δ| of a leaf over its reference's largest |value|, and that leaf."""
    return max((((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-12)).item(), k)
               for k in ref)


def phase_dp_nccl(device, card):
    """Phase 55: a world-size-1 NCCL group, `Trainer(mesh)` for one epoch at
    config-berlin, B=8192: K1 and K3 once a step, no plain call, the losses
    the single-device Trainer's bit for bit."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    dm = InMemoryDataModule(train=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)
                                   for _ in range(TRAIN_BATCHES)])

    def epoch(mesh):
        config = train_config()
        trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=SEED,
                          mesh=mesh)
        losses, train_step = [], trainer.train_step

        def recording_step(batch, draws=None):
            metrics = train_step(batch, draws)
            losses.append(metrics["loss"])
            return metrics

        trainer.train_step = recording_step
        reset_counts()
        trainer.fit(dm, epochs=1)
        torch.cuda.synchronize()
        return ([v.item() for v in losses], {k: v for k, v in all_counts().items() if v},
                plain_calls())

    single = epoch(LocalMesh("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1, device_id=device)
        try:
            mesh = make_device_mesh(device_type="cuda")
            losses, launches, plain = epoch(mesh)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    rec = {"phase": "dp_nccl", "B": TRAIN_B, "steps": TRAIN_BATCHES, "backend": backend,
           "world_size": 1, "mesh": mesh_shape(mesh), "launches": launches, "plain_calls": plain,
           "losses": losses, "single_device_losses": single[0],
           "same_bits": losses == single[0], "card": card}
    emit(rec)
    expected = {"epic_forward": TRAIN_BATCHES, "epic_backward": TRAIN_BATCHES}
    if launches != expected or plain or not rec["same_bits"] or backend != "nccl":
        raise RuntimeError(f"the NCCL one-rank trainer: {rec}")
    return launches


def phase_parallel_train(card, phase, ranks, ref, expected, steps):
    """Phases 56-57: the ranks' 'jit' data-parallel run against the
    single-process run at the global batch."""
    losses = [r[phase][0] for r in ranks]
    ref_losses, ref_params = ref[0], ref[1]
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses[0], ref_losses))
    param_diff, leaf = worst_param_diff(ranks[0][phase][1], ref_params)
    rate = (steps - 1) / ranks[0][phase][4]
    rec = {"phase": phase, "ranks": RANKS, "backend": "gloo", "global_B": TRAIN_B,
           "rank_B": TRAIN_B // RANKS, "steps": steps, "spmd_mode": "jit",
           "launches": {f"rank{i}": r[phase][2] for i, r in enumerate(ranks)},
           "plain_calls": [r[phase][3] for r in ranks], "losses": losses[0],
           "single_process_losses": ref_losses, "max_rel_loss_diff": loss_diff,
           "loss_rtol": TP_RTOL, "max_rel_param_diff": param_diff, "worst_leaf": leaf,
           "param_bound": PARAM_BOUND, "steps_per_s": rate,
           "single_process_steps_per_s": (steps - 1) / ref[4],
           "phase8_steps_per_s": READINGS.get("train_steps_per_s"), "card": card}
    emit(rec)
    held = (losses[0] == losses[1] and loss_diff <= TP_RTOL
            and (phase == "dp_train_scaled" or param_diff <= PARAM_BOUND))
    if not held or any(r[phase][2] != expected or r[phase][3] for r in ranks):
        raise RuntimeError(f"{phase}: {rec}")


def phase_tp_train(card, ranks, refs):
    """Phase 58: 2 ranks at model 2 (the Megatron pairs split), scaled MBM and
    the reference transdimensional model, against the replicated module path
    on the card, and the two ranks' losses against each other (each rank
    computes the pair's loss itself: the card's reductions need not give
    both the same bits); no kernel launches (the gates are off under
    model_axis > 1)."""
    rec = {"phase": "tp_train", "ranks": RANKS, "backend": "gloo", "mesh": {"data": 1,
                                                                           "model": RANKS},
           "steps": TP_STEPS, "card": card}
    held = True
    for family, B in (("mbm_scaled", TP_MBM_B), ("transdim", TP_TD_B)):
        got = [r[f"tp_{family}"] for r in ranks]
        ref = refs[family]
        diff = max(abs(a - b) - TP_RTOL * abs(b) for a, b in zip(got[0][0] + got[1][0], ref[0] * 2))
        rec[family] = {"B": B, "losses": got[0][0], "rank1_losses": got[1][0],
                       "replicated_losses": ref[0],
                       "max_abs_loss_diff_over_rtol_bound": diff,
                       "max_rel_param_diff": worst_param_diff(got[0][1], ref[1])[0],
                       "launches": [g[2] for g in got], "plain_calls": [g[3] for g in got],
                       "replicated_launches": ref[2]}
        held &= diff <= TP_ATOL and all(not g[2] and not g[3] for g in got) and not ref[2]
    rec["loss_rtol"], rec["loss_atol"] = TP_RTOL, TP_ATOL
    emit(rec)
    if not held:
        raise RuntimeError(f"tp_train: {rec}")


def phase_bulk_dp(card, ranks):
    """Phase 59: the 2-rank MBM sweep, BULK_DP_CHUNKS chunks of BULK_DP_B
    jets (BULK_B a rank), K2 99 times a chunk a rank (and the warm-up)."""
    stats = [r["bulk_dp"][0] for r in ranks]
    expected = {"sampler_step": 99 * (BULK_DP_CHUNKS + 1)}
    rec = {"phase": "bulk_dp", "ranks": RANKS, "chunks": BULK_DP_CHUNKS, "global_B": BULK_DP_B,
           "rank_B": BULK_DP_B // RANKS, "N": N, "num_jets": stats[0]["num_jets"],
           "mesh": stats[0]["mesh"], "jets_per_s": stats[0]["jets_per_sec"],
           "rank_jets_per_s": [s["rank_jets_per_sec"] for s in stats],
           "single_process_jets_per_s": READINGS.get("bulk_jets_per_s"),
           "launches": {f"rank{i}": r["bulk_dp"][1] for i, r in enumerate(ranks)},
           "plain_calls": [r["bulk_dp"][2] for r in ranks], "card": card}
    emit(rec)
    if (any(r["bulk_dp"][1] != expected or r["bulk_dp"][2] for r in ranks)
            or rec["num_jets"] != BULK_DP_CHUNKS * BULK_DP_B or rec["mesh"] != {"data": RANKS}):
        raise RuntimeError(f"bulk_dp: {rec}")


def parallel_phases(device, card, build_dir, rank_target=None):
    """Phases 55-59; each path's launches for the kernels line."""
    nccl = phase_dp_nccl(device, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        outdir = Path(tmp)
        procs = start_ranks(outdir, device.type, rank_target)
        try:
            # the single-process references, while the ranks start
            gains = {f: gained_weights(f, device) for f in ("mbm_scaled", "transdim")}
            refs = {"dp_train": parallel_run("mbm", parallel_config("mbm"),
                                             parallel_batches(TRAIN_B, DP_STEPS, device), device),
                    "dp_train_scaled": parallel_run(
                        "mbm_scaled", parallel_config("mbm_scaled"),
                        parallel_batches(TRAIN_B, DP_SCALED_STEPS, device), device, None,
                        gains["mbm_scaled"])}
            tp_refs = {family: parallel_run(
                family, parallel_config(family, use_pallas=False),
                parallel_batches(B, TP_STEPS, device, family), device, None, gains[family])
                for family, B in (("mbm_scaled", TP_MBM_B), ("transdim", TP_TD_B))}
            del gains
            torch.cuda.empty_cache()
        finally:
            (outdir / "go").touch()
        ranks = join_ranks(procs, outdir)
    phase_parallel_train(card, "dp_train", ranks, refs["dp_train"],
                         {"epic_forward": DP_STEPS, "epic_backward": DP_STEPS}, DP_STEPS)
    phase_parallel_train(card, "dp_train_scaled", ranks, refs["dp_train_scaled"],
                         {"epic_wide_forward": DP_SCALED_STEPS,
                          "epic_wide_backward": DP_SCALED_STEPS}, DP_SCALED_STEPS)
    phase_tp_train(card, ranks, tp_refs)
    phase_bulk_dp(card, ranks)
    by_rank = {f"{phase}_rank{i}": r[phase][2] for phase in ("dp_train", "dp_train_scaled")
               for i, r in enumerate(ranks)}
    by_rank.update({f"bulk_dp_rank{i}": r["bulk_dp"][1] for i, r in enumerate(ranks)})
    return nccl, by_rank


# ------------------------------------ phases 60-62: the head kernels at every width


def chunked(fn, B, *tensors, chunk=WIDTH_PLAIN_CHUNK):
    """fn over jet chunks of `chunk` (each tensor, or each tensor of a tuple,
    cut along its batch axis, 1 for the stacked time rows), concatenated."""
    def cut(t, lo, hi):
        if isinstance(t, (tuple, list)):
            return type(t)(x[lo:hi] for x in t)
        return None if t is None else t[lo:hi]
    return torch.cat([fn(*(cut(t, lo, min(lo + chunk, B)) for t in tensors))
                      for lo in range(0, B, chunk)])


def width_check(kernel, C, heads, shape, got, again, ref, tol, relative=True,
                phase="head_widths"):
    """One check line of phase 60 (or 70): |err| ≤ tol (+ tol·|ref| when
    `relative`), the same bits on a repeat, finite."""
    err = (got - ref).abs()
    bound = tol + (tol * ref.abs() if relative else 0.0)
    rec = {"phase": phase, "kernel": kernel, "C": C, "n_heads": heads,
           "head_width": C // heads, **shape, "max_abs_err": err.max().item(),
           "max_abs_ref": ref.abs().max().item(), "tol": tol, "relative": relative,
           "worst_err_over_bound": (err / bound).max().item(),
           "within_tol": bool((err <= bound).all().item()),
           "same_bits_on_repeat": bool(torch.equal(got, again)),
           "finite": bool(torch.isfinite(got).all().item())}
    emit(rec)
    if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]):
        raise RuntimeError(f"{kernel} at width {C} with {heads} heads disagrees with its plain "
                           f"version: {rec}")
    return rec["max_abs_err"]


def width_time(kernel, C, heads, timed_at, kernel_fn, plain_fn, bound, card, phase="head_widths",
               **extra):
    """One time line of phase 60 (or 70): the kernel and its plain version in
    turns."""
    ms, plain_ms = time_pair(kernel_fn, plain_fn)
    emit({"phase": f"{phase}_time", "kernel": kernel, "C": C, "n_heads": heads,
          **timed_at, "ms": ms, "plain_ms": plain_ms, **bound, **against_bounds(bound, ms),
          **extra, "card": card})
    return {"ms": ms, "plain_ms": plain_ms, **bound_fields(bound), "timed_at": timed_at, **extra}


def phase_head_widths(device, card):
    """K6, K7 and K8 at every pair of WIDTH_PAIRS against their plain versions,
    timed at B=4096; K8's path at each pair. Returns per kernel {pair: its
    error, times and bounds} and the AttnBlock launches by pair."""
    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    torch.cuda.empty_cache()  # what the earlier phases left cached
    out = {"survival_head": {}, "gsdm_stack": {}, "attention_core": {}}
    attn_launches = {}
    for C, heads in WIDTH_PAIRS:
        key = f"C{C}_h{heads}"
        # K6
        model = make_absorbing(device, heads=(C, heads))
        _, head = model.pack_for_kernel()
        errors = []
        for B, n in ABS_K6_SHAPES:
            t, _, _, mask = scattered_inputs(B, n, device, gen)
            last = torch.randn((B, n, head.dim_hidden), generator=gen, device=device)
            tp = project_time_embeddings(model.generator, t, head.n_blocks, C)
            got = survival_head(head, tp, last, mask.long(), n_heads=heads)
            again = survival_head(head, tp, last, mask.long(), n_heads=heads)
            torch.cuda.synchronize()
            ref = chunked(lambda tp_, last_, m_: survival_head_reference(
                head, tp_, last_, m_, n_heads=heads), B, tp, last, mask.long())
            errors.append(width_check("K6", C, heads, {"B": B, "N": n}, got, again, ref, K6_TOL))

        t, _, _, mask = scattered_inputs(ABS_B, ABS_N, device, gen)  # the timed call's
        mask_t = mask.long()
        last = torch.randn((ABS_B, ABS_N, head.dim_hidden), generator=gen, device=device)
        tp = project_time_embeddings(model.generator, t, head.n_blocks, C)
        out["survival_head"][key] = {"max_abs_err": max(errors), **width_time(
            "K6", C, heads, {"B": ABS_B, "N": ABS_N},
            lambda: survival_head(head, tp, last, mask_t, n_heads=heads),
            lambda: chunked(lambda tp_, last_, m_: survival_head_reference(
                head, tp_, last_, m_, n_heads=heads), ABS_B, tp, last, mask_t),
            survival_bound(head, ABS_B, ABS_N), card, products_tensor_bound_ms=
            gsdm_products_tensor_bound_ms(head.dim_hidden, head.n_blocks, ABS_B, ABS_N, True, C))}
        del model, head, t, mask, mask_t, last, tp, got, again, ref

        # K7
        model = make_transdim(device, heads=(C, heads))
        net = model.network
        _, rate_stack, vec_stack = model.pack_for_kernel()
        stacks = {24: (rate_stack, net.blocks()[0]), 27: (vec_stack, net.blocks("vec_")[0])}

        def case(B, n, din):
            packed, res_blocks = stacks[din]
            x_in = torch.randn((B, n, din), generator=gen, device=device)
            ts = torch.rand((B,), generator=gen, device=device)
            with torch.no_grad():
                tp = stack_time_embeddings(net.time_embedding(ts), res_blocks)
            return packed, tp, x_in

        errors = []
        for B, n, din in TD_K7_SHAPES:
            packed, tp, x_in = case(B, n, din)
            got = gsdm_stack(packed, tp, x_in, n_heads=heads)
            again = gsdm_stack(packed, tp, x_in, n_heads=heads)
            torch.cuda.synchronize()
            ref = chunked(lambda tp_, x_: gsdm_stack_reference(packed, tp_, x_, n_heads=heads),
                          B, tp, x_in)
            errors.append(width_check("K7", C, heads, {"B": B, "N": n, "Din": din}, got, again,
                                      ref, K7_TOL))
        packed, tp, x_in = case(TD_B, TD_N, 27)
        out["gsdm_stack"][key] = {"max_abs_err": max(errors), **width_time(
            "K7", C, heads, {"B": TD_B, "N": TD_N, "Din": 27},
            lambda: gsdm_stack(packed, tp, x_in, n_heads=heads),
            lambda: chunked(lambda tp_, x_: gsdm_stack_reference(packed, tp_, x_, n_heads=heads),
                            TD_B, tp, x_in),
            gsdm_stack_bound(packed, TD_B, TD_N), card, products_tensor_bound_ms=
            gsdm_products_tensor_bound_ms(27, packed.n_blocks, TD_B, TD_N, C=C))}
        del model, net, stacks, packed, tp, x_in, got, again, ref

        # K8
        errors = []
        for n in WIDTH_K8_N:
            q, k, v = (torch.randn((K8_CHECK_B, n, C), generator=gen, device=device)
                       for _ in range(3))
            mask = (torch.rand((K8_CHECK_B, n, 1), generator=gen, device=device) < 0.6).float()
            mask[0] = 0.0
            for m in (mask, None):
                got = attention_core(q, k, v, m, n_heads=heads)
                again = attention_core(q, k, v, m, n_heads=heads)
                torch.cuda.synchronize()
                ref = chunked(lambda q_, k_, v_, m_: attention_core_reference(
                    q_, k_, v_, m_, n_heads=heads), K8_CHECK_B, q, k, v, m)
                errors.append(width_check("K8", C, heads, {"B": K8_CHECK_B, "N": n,
                                                           "masked": m is not None},
                                          got, again, ref, K8_TOL, relative=False))
        B, hd = TD_B, C // heads
        q, k, v = (torch.randn((B, TD_N, C), generator=gen, device=device) for _ in range(3))
        mask = (torch.rand((B, TD_N, 1), generator=gen, device=device) < 0.6).float()
        q4, k4, v4 = (a.view(B, TD_N, heads, hd).transpose(1, 2) for a in (q, k, v))
        bias4 = key_bias(mask, B, TD_N, q)[:, None]
        # heads that are no multiple of 8 channels take SDPA's math path, which holds
        # the (B, heads, N, N) scores: there in chunks of WIDTH_PLAIN_CHUNK jets
        sdpa_chunk = B if hd % 8 == 0 else WIDTH_PLAIN_CHUNK

        def sdpa():
            return chunked(lambda q_, k_, v_, b_: torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=b_), B, q4, k4, v4, bias4, chunk=sdpa_chunk)
        library_ms = (cuda_ms(sdpa) + cuda_ms(sdpa)) / 2
        out["attention_core"][key] = {"max_abs_err": max(errors), **width_time(
            "K8", C, heads, {"B": B, "N": TD_N, "masked": True},
            lambda: attention_core(q, k, v, mask, n_heads=heads),
            lambda: chunked(lambda q_, k_, v_, m_: attention_core_reference(
                q_, k_, v_, m_, n_heads=heads), B, q, k, v, mask),
            attention_bound(B, TD_N, C), card, library_ms=library_ms,
            library="torch.nn.functional.scaled_dot_product_attention, float mask",
            library_chunk=sdpa_chunk)}
        del q, k, v, q4, k4, v4, bias4, mask, got, again, ref

        # K8's path at this pair: AttnBlock(use_pallas=True) forward, one launch
        fused = init_transdimensional_parameters(AttnBlock(C, heads, use_pallas=True), SEED)
        fused = fused.to(device)
        einsum = AttnBlock(C, heads, use_pallas=False).to(device)
        einsum.load_state_dict(fused.state_dict())
        x = torch.randn((K8_CHECK_B, ABS_N, C), generator=gen, device=device)
        mask = (torch.rand((K8_CHECK_B, ABS_N, 1), generator=gen, device=device) < 0.6).float()
        torch.cuda.synchronize()
        reset_counts()  # K8's path at this pair
        with torch.no_grad():
            y = fused(x, mask)
        torch.cuda.synchronize()
        attn_launches[key] = attention_core.launches
        calls = plain_calls()
        with torch.no_grad():
            ref = einsum(x, mask)
        rec = {"phase": "head_widths_attn_block", "C": C, "n_heads": heads, "B": K8_CHECK_B,
               "N": ABS_N, "launches": attn_launches[key], "plain_calls": calls,
               "max_abs_err": (y - ref).abs().max().item(),
               "within_tol": bool(((y - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all().item())}
        emit(rec)
        if rec["launches"] != 1 or calls or not rec["within_tol"]:
            raise RuntimeError(f"AttnBlock(use_pallas=True) at width {C}, {heads} heads: {rec}")
        del fused, einsum, x, mask, y, ref
        torch.cuda.empty_cache()
    return out, attn_launches


def head_width_phases(device, card):
    """Phases 60-62. Returns phase 60's per-kernel results and each path's
    launches by kernel name."""
    widths, attn_launches = phase_head_widths(device, card)
    paths = {f"attn_block_C{c}_h{h}": {"attention_core": n}
             for (c, h), n in zip(WIDTH_PAIRS, attn_launches.values())}
    for c, h in WIDTH_SLICES:
        paths[f"serving_absorbing_c{c}_h{h}"] = phase_slice_absorbing(
            device, card, heads=(c, h), sizes=(ABS_B,), phase=f"slice_absorbing_c{c}_h{h}")
        torch.cuda.empty_cache()
    for c, h in WIDTH_SLICES:
        paths[f"serving_transdim_c{c}_h{h}"] = phase_slice_transdim(
            device, card, heads=(c, h), sizes=(TD_B,), phase=f"slice_transdim_c{c}_h{h}")
        torch.cuda.empty_cache()
    return widths, paths


# ------------------ phases 63-69: K4, K5 and K6 at the wide widths, and scaled-256


def wide_case_packing(device, enc, blocks, head_hidden=None):
    """MBM's encoder at make_config's widths `enc` and `blocks` blocks,
    seeded weights, packed for the wide kernels; with `head_hidden` a seeded
    Dense(8 → head_hidden)-SELU-Dense(head_hidden → 8) discrete head (the
    absorbing generator's form) in its place."""
    model = make_model(device, num_blocks=blocks, **enc)
    if head_hidden is None:
        return pack_wide_encoder_params(model.encoder, model.config)
    torch.manual_seed(SEED + head_hidden)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, head_hidden), torch.nn.SELU(),
                              torch.nn.Linear(head_hidden, 8)).to(device)
    return pack_wide_encoder_params(model.encoder, model.config, head=mlp)


def chunked_jets(fn, B, *tensors, chunk=WIDE_PLAIN_CHUNK):
    """fn summed over jet chunks of `chunk` (d(flat) is a sum over jets)."""
    return sum(fn(*(a[lo:lo + chunk] for a in tensors)) for lo in range(0, B, chunk))


def phase_wide_widths(device, card):
    """Phase 63. K4 at every case of WIDE_CASES (a cluster of hidden / 128
    blocks a jet) against its plain version per particle at B=1024, the same
    bits on a repeat; then both timed at B=8192 (the plain version in chunks
    of 2048 jets). Then K4 as the scaled-256 absorbing generator (56-wide
    head, hidden output) and transdimensional trunk (folded input) call it,
    and with discrete heads of WIDE_HEADS at scaled-256's widths. Returns
    {case: error, times, bounds}."""
    gen = torch.Generator(device=device).manual_seed(SEED + 63)
    torch.cuda.empty_cache()
    gate, out = "within_tol_per_particle", {}
    for name, enc, blocks in WIDE_CASES:
        packed = wide_case_packing(device, enc, blocks)
        t, x, k, mask = random_inputs(WIDE_CHECK_B, device, gen)
        got = epic_forward_wide(packed, t, x, k, mask)
        again = epic_forward_wide(packed, t, x, k, mask)
        torch.cuda.synchronize()
        ref = epic_forward_reference(packed, t, x, k, mask)
        cmp = compare(got, ref)
        d = packed.dims
        rec = {"phase": "wide_widths", "kernel": "K4", "case": name, "hidden": d.hidden,
               "hidden_glob": d.hidden_glob, "emb_t": d.emb_t, "num_blocks": blocks,
               "cluster": d.hidden // 128, "B": WIDE_CHECK_B, "N": N, "gate": gate, **cmp,
               "max_abs_ref": ref.abs().max().item(),
               "same_bits_on_repeat": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all().item())}
        emit(rec)
        if not (cmp[gate] and rec["same_bits_on_repeat"] and rec["finite"]):
            raise RuntimeError(f"K4 at {name} disagrees with its plain version: {rec}")
        t, x, k, mask = random_inputs(TRAIN_B, device, gen)
        ms, plain_ms = time_pair(
            lambda: epic_forward_wide(packed, t, x, k, mask),
            lambda: torch.cat([epic_forward_reference(packed, *(a[lo:lo + SCALED_PLAIN_B]
                                                                for a in (t, x, k, mask)))
                               for lo in range(0, TRAIN_B, SCALED_PLAIN_B)]))
        bound = kernel_bound(packed, TRAIN_B, "forward")
        products = products_tensor_bound_ms(d, TRAIN_B, N)
        emit({"phase": "wide_widths_time", "kernel": "K4", "case": name, "B": TRAIN_B, "N": N,
              "num_blocks": blocks, "ms": ms, "plain_ms": plain_ms, **bound,
              **against_bounds(bound, ms), "products_tensor_bound_ms": products,
              "needed_products_tensor_bound_ms": needed_products_tensor_bound_ms(d, TRAIN_B, N),
              "card": card})
        out[name] = {"max_abs_err": cmp["max_abs_err"], "max_abs_ref": rec["max_abs_ref"],
                     "ms": ms, "plain_ms": plain_ms, **bound_fields(bound),
                     "products_tensor_bound_ms": products,
                     "timed_at": {"hidden": d.hidden, "hidden_glob": d.hidden_glob,
                                  "emb_t": d.emb_t, "num_blocks": blocks, "B": TRAIN_B, "N": N}}
        del packed, t, x, k, mask, got, again, ref
    out["absorbing_scaled256"] = phase_k4_family(device, card, "absorbing", SCALED256_HIDDEN)
    out["transdim_scaled256"] = phase_k4_family(device, card, "transdim", SCALED256_HIDDEN)
    for head_hidden in WIDE_HEADS:
        packed = wide_case_packing(device, dict(hidden=SCALED256_HIDDEN, emb=SCALED256_HIDDEN), 2,
                                   head_hidden)
        t, x, k, mask = scattered_inputs(WIDE_CHECK_B, ABS_N, device, gen)
        got = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=True)
        again = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=True)
        torch.cuda.synchronize()
        ref = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=True)
        cmps = [compare(a, r) for a, r in zip(got, ref)]
        rec = {"phase": "wide_heads", "kernel": "K4", "head_hidden": head_hidden,
               "hidden": SCALED256_HIDDEN, "num_blocks": 2, "B": WIDE_CHECK_B, "N": ABS_N,
               "gate": gate, "outputs": cmps[0], "hidden_state": cmps[1],
               "same_bits_on_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
               "finite": all(bool(torch.isfinite(a).all().item()) for a in got)}
        emit(rec)
        if not (all(c[gate] for c in cmps) and rec["same_bits_on_repeat"] and rec["finite"]):
            raise RuntimeError(f"K4 with a head of {head_hidden} disagrees: {rec}")
        out[f"head{head_hidden}_scaled256"] = {"max_abs_err": max(c["max_abs_err"] for c in cmps)}
    torch.cuda.empty_cache()
    return out


def sparse_inputs(B, device, gen):
    """t, x, k and a random mask at N=128, each slot alive with probability
    WIDE_K5_SPARSE, the first jet empty."""
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < WIDE_K5_SPARSE).float()
    mask[0] = 0.0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    return torch.rand((B, 1, 1), generator=gen, device=device), x, k, mask


def phase_wide_widths_backward(device, card):
    """Phase 64. K5 (the wide forward + hand-written backward) at every case
    of WIDE_CASES against plain autograd under K3's rules (per packed leaf,
    near-kink jets without cotangent) on two batches of 2048 jets: phase 12's
    (`random_inputs`) and one of scattered, sparse masks (`sparse_inputs`),
    of whose held jets B/16 must have a particle past slot 64; the plain
    backward in chunks of WIDE_PLAIN_CHUNK jets; the same bits on a repeated
    call; then the backward timed at the training batch B=8192 and the plain
    one at WIDE_PLAIN_CHUNK jets. Returns {case: error, times, bounds}."""
    gen = torch.Generator(device=device).manual_seed(SEED + 64)
    torch.cuda.empty_cache()
    out = {}
    for name, enc, blocks in WIDE_CASES:
        packed = wide_case_packing(device, enc, blocks)
        B, errors = WIDE_K5_CHECK_B, []
        for batch in ("prefix", "sparse"):
            t, x, k, mask = (random_inputs if batch == "prefix" else sparse_inputs)(B, device, gen)
            near = torch.cat([near_kink_jets(packed, *(a[lo:lo + WIDE_PLAIN_CHUNK]
                                                       for a in (t, x, k, mask)))
                              for lo in range(0, B, WIDE_PLAIN_CHUNK)])
            g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
            leaf = packed.flat.clone().requires_grad_(True)
            y = epic_train_forward_wide(packed.rebind(leaf), t, x, k, mask)
            y.backward(g)
            again = epic_backward_wide(packed, t, x, k, mask, g)
            torch.cuda.synchronize()
            fwd = compare(y.detach(), epic_forward_reference(packed, t, x, k, mask))
            ref = chunked_jets(lambda *a: epic_backward_reference(packed, *a), B, t, x, k, mask, g)
            bwd = leaf_compare(leaf.grad, ref, packed)
            mult = mask[..., 0].sum(dim=1)
            past_64 = mask[:, 64:, 0].sum(dim=1) > 0
            held_past_64 = int(((~near) & past_64).sum().item())
            rec = {"phase": "wide_widths_backward", "kernel": "K5", "case": name, "batch": batch,
                   "hidden": packed.dims.hidden, "num_blocks": blocks, "B": B, "N": N,
                   "forward": fwd, "backward": bwd,
                   "near_kink_jets_left_out": int(near.sum().item()),
                   "kept_jets_by_multiplicity": multiplicity_bins(mult[~near]),
                   "kept_jets_with_a_particle_past_64": held_past_64,
                   "same_bits_on_repeat": bool(torch.equal(again, leaf.grad)),
                   "finite": bool(torch.isfinite(leaf.grad).all().item())}
            emit(rec)
            covered = batch == "prefix" or held_past_64 >= B // 16
            if not (fwd["within_tol_per_particle"] and rec["finite"] and covered
                    and rec["same_bits_on_repeat"] and not bwd["leaves_out_of_bound"]):
                raise RuntimeError(f"K5 at {name} disagrees with plain autograd: {rec}")
            errors.append(bwd)
            del leaf, y, again, ref, near
        t, x, k, mask = random_inputs(TRAIN_B, device, gen)
        g = torch.randn((TRAIN_B, N, 11), generator=gen, device=device)
        small = tuple(a[:WIDE_PLAIN_CHUNK].contiguous() for a in (t, x, k, mask, g))
        kernel = lambda: epic_backward_wide(packed, t, x, k, mask, g)
        plain = lambda: epic_backward_reference(packed, *small)
        p1, k1, k2, p2 = cuda_ms(plain, 3), cuda_ms(kernel, 3), cuda_ms(kernel, 3), cuda_ms(plain, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound = kernel_bound(packed, TRAIN_B, "backward")
        products = wide_backward_products_tensor_bound_ms(packed.dims, TRAIN_B, N)
        emit({"phase": "wide_widths_backward_time", "kernel": "K5", "case": name, "B": TRAIN_B,
              "N": N, "num_blocks": blocks, "backward_ms": ms, "plain_B": WIDE_PLAIN_CHUNK,
              "backward_plain_ms_at_plain_B": plain_ms, **bound, **against_bounds(bound, ms),
              "products_tensor_bound_ms": products, "card": card})
        out[name] = {"max_abs_err": max(e["max_abs_err"] for e in errors),
                     "worst_leaf_err_over_bound": max(e["worst_leaf_err_over_bound"]
                                                      for e in errors), "ms": ms,
                     "plain_ms": plain_ms, **bound_fields(bound),
                     "products_tensor_bound_ms": products,
                     "timed_at": {"hidden": packed.dims.hidden, "num_blocks": blocks,
                                  "B": TRAIN_B, "N": N, "plain_B": WIDE_PLAIN_CHUNK}}
        del packed, t, x, k, mask, g, small
        torch.cuda.empty_cache()
    return out


def phase_k6_trunk_256(device, card):
    """Phase 65. K6 at the scaled-256 absorbing generator's head (C = 128, 2
    heads, 2 blocks) on its trunk of hidden width 256 (the first product in
    two passes of 128 columns) against its plain version at K6's shapes,
    atol = rtol = 2e-4, the same bits on a repeat; then both timed at
    B=4096, N=109."""
    gen = torch.Generator(device=device).manual_seed(SEED + 65)
    model = make_absorbing(device, scaled=SCALED256_HIDDEN)
    _, head = model.pack_for_kernel()
    heads = model.config.generator.n_heads
    errors = []
    for B, n in ABS_K6_SHAPES:
        t, _, _, mask = scattered_inputs(B, n, device, gen)
        last = torch.randn((B, n, head.dim_hidden), generator=gen, device=device)
        tp = project_time_embeddings(model.generator, t, head.n_blocks, head.channels)
        got = survival_head(head, tp, last, mask.long(), n_heads=heads)
        again = survival_head(head, tp, last, mask.long(), n_heads=heads)
        torch.cuda.synchronize()
        ref = survival_head_reference(head, tp, last, mask.long(), n_heads=heads)
        err = (got - ref).abs()
        rec = {"phase": "k6_trunk_256", "dim_hidden": head.dim_hidden, "C": head.channels,
               "B": B, "N": n, "max_abs_err": err.max().item(),
               "max_abs_ref": ref.abs().max().item(), "atol": K6_TOL, "rtol": K6_TOL,
               "within_tol": bool((err <= K6_TOL + K6_TOL * ref.abs()).all().item()),
               "same_bits_on_repeat": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all().item())}
        emit(rec)
        errors.append(rec["max_abs_err"])
        if not (rec["within_tol"] and rec["same_bits_on_repeat"] and rec["finite"]):
            raise RuntimeError(f"K6 on a trunk of 256 disagrees with its plain version: {rec}")
    t, _, _, mask = scattered_inputs(ABS_B, ABS_N, device, gen)
    mask_t = mask.long()
    last = torch.randn((ABS_B, ABS_N, head.dim_hidden), generator=gen, device=device)
    tp = project_time_embeddings(model.generator, t, head.n_blocks, head.channels)
    ms, plain_ms = time_pair(lambda: survival_head(head, tp, last, mask_t, n_heads=heads),
                             lambda: survival_head_reference(head, tp, last, mask_t, n_heads=heads))
    bound = survival_bound(head, ABS_B, ABS_N)
    products = gsdm_products_tensor_bound_ms(head.dim_hidden, head.n_blocks, ABS_B, ABS_N, True)
    emit({"phase": "k6_trunk_256_time", "B": ABS_B, "N": ABS_N, "dim_hidden": head.dim_hidden,
          "ms": ms, "plain_ms": plain_ms, **bound, **against_bounds(bound, ms),
          "products_tensor_bound_ms": products, "card": card})
    return {"max_abs_err": max(errors), "ms": ms, "plain_ms": plain_ms, **bound_fields(bound),
            "products_tensor_bound_ms": products,
            "timed_at": {"B": ABS_B, "N": ABS_N, "dim_hidden": head.dim_hidden, "C": head.channels}}


def phase_slice_scaled256(device, card):
    """Phase 66. MBM at scaled-256 (bench.py's `_scale_encoder` with every
    width 256: 6 blocks, hidden, global and embeddings 256), data-dependent
    gains, serves requests of 8192 and 1024 jets: 99 launches of K4 a
    request, no other kernel, no plain version."""
    model = make_model(device, **SCALED256)
    parameters = sum(p.numel() for p in model.parameters())
    emit({"phase": "slice_scaled256_init", "parameters": parameters,
          "log10_gain_divisors": data_dependent_gains(model, device)})
    gen = torch.Generator(device=device).manual_seed(SEED + 66)
    batches = [gauss_noise_source_batch(B, N, 3, 8, gen, device=device, num_empty=1)
               for B in SCALED256_REQUEST_SIZES]
    torch.cuda.synchronize()
    reset_counts()  # the scaled-256 serving path's run starts here
    for B, batch in zip(SCALED256_REQUEST_SIZES, batches):
        before = epic_forward_wide.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k4 = epic_forward_wide.launches - before
        checks = check_generated(out, batch, B)
        emit({"phase": "slice_scaled256", "B": B, "N": N, "K4_launches": k4, "seconds": seconds,
              "jets_per_s": B / seconds, "parameters": parameters, "card": card, **checks})
        if k4 != 99:
            raise RuntimeError(f"scaled-256 request of {B} jets launched K4 {k4} times")
    counts, only = launched({"epic_wide_forward": 99 * len(SCALED256_REQUEST_SIZES)})
    emit({"phase": "slice_scaled256_counts", "launches": counts, "plain_calls": plain_calls()})
    if not only:
        raise RuntimeError(f"the scaled-256 serving path left its kernels: {counts}")
    return counts


def phase_train_scaled256(device, card):
    """Phase 67. Trainer.fit at scaled-256, B=8192 (SCALED256_TRAIN_BATCHES
    synthetic batches + 1 validation batch), data-dependent gains: K5 once a
    train step, K4 once a step and a validation batch, no plain version; the
    losses finite and falling. The records K5 keeps fit: its scratch at this
    batch is printed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 67)
    dm = InMemoryDataModule(
        train=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)
               for _ in range(SCALED256_TRAIN_BATCHES)],
        valid=[synthetic_training_batch(TRAIN_B, N, 3, 8, gen, device=device)])
    config = make_config(**SCALED256)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(MultiModalBridgeMatching(config).to(device), config,
                          ExperimentsFiles(str(Path(tmp) / "run_scaled256")), seed=SEED,
                          ema_decay=EMA_DECAY)
        step_losses = []
        train_step = trainer.train_step

        def recording_step(batch, draws=None):
            metrics = train_step(batch, draws)
            step_losses.append(metrics["loss"])
            return metrics

        trainer.train_step = recording_step
        trainer.setup(steps_per_epoch=SCALED256_TRAIN_BATCHES)
        divisors = set_gains(trainer, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()  # the scaled-256 training path's run starts here
        start = time.perf_counter()
        history = trainer.fit(dm, epochs=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    counts, only = launched({"epic_wide_forward": SCALED256_TRAIN_BATCHES + 1,
                             "epic_wide_backward": SCALED256_TRAIN_BATCHES})
    losses = [v.item() for v in step_losses]
    _, floats = epic_wide_vjp_cuda._workspace(_build.load_library(), TRAIN_B, N,
                                              EpicDims.from_config(config), device)
    emit({"phase": "train_scaled256", "B": TRAIN_B, "N": N, "steps": SCALED256_TRAIN_BATCHES,
          "parameters": sum(p.numel() for p in trainer.model.parameters()),
          "log10_gain_divisors": divisors, "step_losses": losses, "epochs": history,
          "launches": counts, "plain_calls": plain_calls(), "fit_seconds": seconds,
          "k5_scratch_gb": 4 * floats / 1e9,
          "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9, "card": card})
    finite = all(torch.isfinite(torch.tensor(losses + [r["val_loss"] for r in history])).tolist())
    if not only:
        raise RuntimeError(f"the scaled-256 fit launched {counts}, plain {plain_calls()}")
    if not finite or not sum(losses[-2:]) / 2 < losses[0]:
        raise RuntimeError(f"the scaled-256 loss is not finite or did not fall: {losses}")
    return counts


def wide_width_phases(device, card):
    """Phases 63-69. Returns the kernels line's additions: K4's and K5's
    results by case, K6's on the trunk of 256, and each path's launches by
    kernel name."""
    k4 = phase_wide_widths(device, card)
    k5 = phase_wide_widths_backward(device, card)
    k6 = phase_k6_trunk_256(device, card)
    paths = {"serving_scaled256": phase_slice_scaled256(device, card),
             "train_scaled256": phase_train_scaled256(device, card)}
    torch.cuda.empty_cache()
    paths["serving_absorbing_scaled256"] = phase_slice_absorbing_scaled(
        device, card, SCALED256_HIDDEN, (SCALED256_FAMILY_B,), "256")
    torch.cuda.empty_cache()
    paths["serving_transdim_scaled256"] = phase_slice_transdim_scaled(
        device, card, SCALED256_HIDDEN, (SCALED256_FAMILY_B,), "256")
    torch.cuda.empty_cache()
    return k4, k5, k6, paths


# ------------------------------- phases 70-74: the head kernels past 128 slots

# N on both sides of the row blocks' edge, one odd, and the most the kernels take
LONG_N = (129, 200, 256)
LONG_PAIRS = ((128, 2),) + WIDTH_PAIRS
LONG_CHECK_B = 64  # more jets than the clusters of 8 blocks resident at once
LONG_TIMED_N, LONG_B = 256, 4096
LONG_ODD_N, LONG_ODD_B = 200, 1024
SCALED256_DIN = (264, 267)  # the scaled-256 transdim stacks' inputs: 256 ‖ V (‖ 3)


def phase_long_heads(device, card):
    """K6, K7 and K8 at N = 129, 200 and 256 (two row blocks a jet: K6 and
    K7 as clusters of C/128 × 2 blocks, K8 a block a query half) against
    their plain versions at every pair of LONG_PAIRS, K8 with a key mask that
    masks every key of one jet and without, the same bits on a repeat; then
    each timed at B=4096, N=256, C=128 × 2 heads beside its plain version,
    its bounds and (K8) SDPA, and K7 at the scaled-256 stacks' input widths
    (B=4096, N=128). Returns per kernel its worst error and its times."""
    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    torch.cuda.empty_cache()
    errors = {"survival_head": [], "gsdm_stack": [], "attention_core": []}
    for C, heads in LONG_PAIRS:
        absorbing = make_absorbing(device, heads=(C, heads))
        _, head = absorbing.pack_for_kernel()
        model = make_transdim(device, heads=(C, heads))
        net = model.network
        _, rate_stack, vec_stack = model.pack_for_kernel()
        stacks = {24: (rate_stack, net.blocks()[0]), 27: (vec_stack, net.blocks("vec_")[0])}
        B = LONG_CHECK_B
        for n in LONG_N:
            t, _, _, mask = scattered_inputs(B, n, device, gen)
            last = torch.randn((B, n, head.dim_hidden), generator=gen, device=device)
            tp = project_time_embeddings(absorbing.generator, t, head.n_blocks, C)
            got = survival_head(head, tp, last, mask.long(), n_heads=heads)
            again = survival_head(head, tp, last, mask.long(), n_heads=heads)
            torch.cuda.synchronize()
            ref = chunked(lambda tp_, last_, m_: survival_head_reference(
                head, tp_, last_, m_, n_heads=heads), B, tp, last, mask.long())
            errors["survival_head"].append(width_check(
                "K6", C, heads, {"B": B, "N": n}, got, again, ref, K6_TOL, phase="long_heads"))

            din = 24 if n == LONG_ODD_N else 27
            packed, res_blocks = stacks[din]
            x_in = torch.randn((B, n, din), generator=gen, device=device)
            with torch.no_grad():
                tp = stack_time_embeddings(net.time_embedding(torch.rand(
                    (B,), generator=gen, device=device)), res_blocks)
            got = gsdm_stack(packed, tp, x_in, n_heads=heads)
            again = gsdm_stack(packed, tp, x_in, n_heads=heads)
            torch.cuda.synchronize()
            ref = chunked(lambda tp_, x_: gsdm_stack_reference(packed, tp_, x_, n_heads=heads),
                          B, tp, x_in)
            errors["gsdm_stack"].append(width_check(
                "K7", C, heads, {"B": B, "N": n, "Din": din}, got, again, ref, K7_TOL,
                phase="long_heads"))

            q, k, v = (torch.randn((B, n, C), generator=gen, device=device) for _ in range(3))
            mask = (torch.rand((B, n, 1), generator=gen, device=device) < 0.6).float()
            mask[0] = 0.0  # every key of jet 0 masked: its output is the mean of its values
            for m in (mask, None):
                got = attention_core(q, k, v, m, n_heads=heads)
                again = attention_core(q, k, v, m, n_heads=heads)
                torch.cuda.synchronize()
                ref = attention_core_reference(q, k, v, m, n_heads=heads)
                errors["attention_core"].append(width_check(
                    "K8", C, heads, {"B": B, "N": n, "masked": m is not None}, got, again, ref,
                    K8_TOL, relative=False, phase="long_heads"))
                if m is not None and not torch.allclose(got[0], v[0].mean(0).expand(n, -1),
                                                        atol=K8_TOL, rtol=0):
                    raise RuntimeError(f"K8 at N={n}: a wholly masked jet is not its values' mean")
        del absorbing, head, model, net, stacks, rate_stack, vec_stack
        torch.cuda.empty_cache()

    # the timed calls: the reference widths (128 × 2 heads) at N = 256
    n, B, C, heads = LONG_TIMED_N, LONG_B, 128, 2
    out = {}
    absorbing = make_absorbing(device, n=n)
    _, head = absorbing.pack_for_kernel()
    t, _, _, mask = scattered_inputs(B, n, device, gen)
    mask_t = mask.long()
    last = torch.randn((B, n, head.dim_hidden), generator=gen, device=device)
    tp = project_time_embeddings(absorbing.generator, t, head.n_blocks, C)
    out["survival_head"] = {"max_abs_err": max(errors["survival_head"]), **width_time(
        "K6", C, heads, {"B": B, "N": n},
        lambda: survival_head(head, tp, last, mask_t, n_heads=heads),
        lambda: chunked(lambda tp_, last_, m_: survival_head_reference(
            head, tp_, last_, m_, n_heads=heads), B, tp, last, mask_t),
        survival_bound(head, B, n), card, phase="long_heads", products_tensor_bound_ms=
        gsdm_products_tensor_bound_ms(head.dim_hidden, head.n_blocks, B, n, True, C))}
    del absorbing, head, t, mask, mask_t, last, tp

    model = make_transdim(device, n=n)
    net = model.network
    _, rate_stack, vec_stack = model.pack_for_kernel()
    x_in = torch.randn((B, n, 27), generator=gen, device=device)
    with torch.no_grad():
        tp = stack_time_embeddings(net.time_embedding(torch.rand((B,), generator=gen,
                                                                 device=device)),
                                   net.blocks("vec_")[0])
    out["gsdm_stack"] = {"max_abs_err": max(errors["gsdm_stack"]), **width_time(
        "K7", C, heads, {"B": B, "N": n, "Din": 27},
        lambda: gsdm_stack(vec_stack, tp, x_in, n_heads=heads),
        lambda: chunked(lambda tp_, x_: gsdm_stack_reference(vec_stack, tp_, x_, n_heads=heads),
                        B, tp, x_in),
        gsdm_stack_bound(vec_stack, B, n), card, phase="long_heads", products_tensor_bound_ms=
        gsdm_products_tensor_bound_ms(27, vec_stack.n_blocks, B, n, C=C))}
    del model, net, rate_stack, vec_stack, x_in, tp

    # K7 at the scaled-256 transdim stacks' input widths, N = 128
    model = make_transdim(device, scaled=SCALED256_HIDDEN)
    net = model.network
    _, rate_stack, vec_stack = model.pack_for_kernel()
    out["gsdm_stack"]["scaled256_inputs"] = {}
    for din, (packed, res_blocks) in zip(SCALED256_DIN, ((rate_stack, net.blocks()[0]),
                                                         (vec_stack, net.blocks("vec_")[0]))):
        if packed.dim_in != din:
            raise RuntimeError(f"the scaled-256 stack reads {packed.dim_in} columns, not {din}")
        x_in = torch.randn((B, TD_N, din), generator=gen, device=device)
        with torch.no_grad():
            tp = stack_time_embeddings(net.time_embedding(torch.rand((B,), generator=gen,
                                                                     device=device)), res_blocks)
        got = gsdm_stack(packed, tp, x_in, n_heads=heads)
        ref = chunked(lambda tp_, x_: gsdm_stack_reference(packed, tp_, x_, n_heads=heads),
                      B, tp, x_in)
        err = width_check("K7", C, heads, {"B": B, "N": TD_N, "Din": din}, got,
                          gsdm_stack(packed, tp, x_in, n_heads=heads), ref, K7_TOL,
                          phase="long_heads")
        out["gsdm_stack"]["scaled256_inputs"][din] = {"max_abs_err": err, **width_time(
            "K7", C, heads, {"B": B, "N": TD_N, "Din": din},
            lambda: gsdm_stack(packed, tp, x_in, n_heads=heads),
            lambda: chunked(lambda tp_, x_: gsdm_stack_reference(packed, tp_, x_, n_heads=heads),
                            B, tp, x_in),
            gsdm_stack_bound(packed, B, TD_N), card, phase="long_heads",
            products_tensor_bound_ms=gsdm_products_tensor_bound_ms(din, packed.n_blocks, B, TD_N,
                                                                   C=C))}
        del got, ref, x_in, tp
    del model, net, rate_stack, vec_stack

    q, k, v = (torch.randn((B, n, C), generator=gen, device=device) for _ in range(3))
    mask = (torch.rand((B, n, 1), generator=gen, device=device) < 0.6).float()
    q4, k4, v4 = (a.view(B, n, heads, C // heads).transpose(1, 2) for a in (q, k, v))
    bias4 = key_bias(mask, B, n, q)[:, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias4)
    library_ms = (cuda_ms(sdpa) + cuda_ms(sdpa)) / 2
    out["attention_core"] = {"max_abs_err": max(errors["attention_core"]), **width_time(
        "K8", C, heads, {"B": B, "N": n, "masked": True},
        lambda: attention_core(q, k, v, mask, n_heads=heads),
        lambda: chunked(lambda q_, k_, v_, m_: attention_core_reference(
            q_, k_, v_, m_, n_heads=heads), B, q, k, v, mask),
        attention_bound(B, n, C), card, phase="long_heads", library_ms=library_ms,
        library="torch.nn.functional.scaled_dot_product_attention, float mask")}
    del q, k, v, q4, k4, v4, bias4, mask
    torch.cuda.empty_cache()
    return out


def long_head_phases(device, card):
    """Phases 70-74: the head kernels past 128 slots (70), the absorbing
    family served at N = 256 and 200 and its kernel path against its module
    path (71-72), the transdimensional family likewise (73-74). Returns
    phase 70's per-kernel results and each path's launches by kernel name."""
    long_heads = phase_long_heads(device, card)
    paths = {}
    paths["serving_absorbing_n256"] = phase_slice_absorbing(
        device, card, sizes=(LONG_B, LONG_B), phase="slice_absorbing_n256", n=LONG_TIMED_N)
    paths["serving_absorbing_n200"] = phase_slice_absorbing(
        device, card, sizes=(LONG_ODD_B,), phase="slice_absorbing_n200", n=LONG_ODD_N)
    phase_paths_absorbing(device, phase="paths_absorbing_n256", n=LONG_TIMED_N)
    torch.cuda.empty_cache()
    paths["serving_transdim_n256"] = phase_slice_transdim(
        device, card, sizes=(LONG_B, LONG_B), phase="slice_transdim_n256", n=LONG_TIMED_N)
    paths["serving_transdim_n200"] = phase_slice_transdim(
        device, card, sizes=(LONG_ODD_B,), phase="slice_transdim_n200", n=LONG_ODD_N)
    phase_paths_transdim(device, phase="paths_transdim_n256", n=LONG_TIMED_N)
    torch.cuda.empty_cache()
    return long_heads, paths



# ------------------------------------------- phases 75-80: K4 and K5 past 128 slots

# N on both sides of the row blocks' edge, of a 16-row tile's (144, 145) and a 64-row
# half's (192, 193) edge in the second row block, one odd N, and the most the kernels take
LONG_WIDE_N = (129, 144, 145, 192, 193, 200, 256)
# K4's widths (name, make_config's widths, blocks): the scaled backbone and phase 63's
# cluster widths, cut to 2 blocks as there
LONG_WIDE_CASES = (("scaled", dict(hidden=128, emb=128), SCALED_BLOCKS),
                   ("local256_glob128", dict(hidden=256, emb=256, glob=128), 2),
                   ("all384", dict(hidden=384, emb=384), 2),
                   ("all512", dict(hidden=512, emb=512), 2))
LONG_WIDE_CHECK_B = 64  # more jets than the clusters of 8 blocks resident at once
# K5's checks at these N and widths: the scaled backbone, scaled-256 and 512 (2 blocks)
LONG_K5_N = (129, 200, 256)
LONG_K5_CASES = (("scaled", dict(hidden=128, emb=128), SCALED_BLOCKS),
                 ("scaled256", dict(hidden=256, emb=256), SCALED_BLOCKS),
                 ("all512", dict(hidden=512, emb=512), 2))
LONG_K5_B = 512
# past 128 slots the near-kink window leaves out nearly every dense jet; the sparse batch
# scatters about this many particles a jet over all N slots
LONG_K5_PARTICLES = 19
LONG_WIDE_TIMED_N = (128, 129, 192, 256)  # K4's time against N: the step at the row cut
LONG_WIDE_TIMED_CASES = (("scaled", dict(hidden=128, emb=128), SCALED_BLOCKS),
                         ("scaled256", dict(hidden=256, emb=256), SCALED_BLOCKS))
LONG_WIDE_SLOTS = 256  # the served and trained paths' N
LONG_GRAD_B = 256  # the train step's gradient check: a slice of the batch
GRAD_BOUND = 1e-3  # |Δgrad| ≤ GRAD_BOUND·max|leaf| (phase 17's first step: 8.3e-5)


def encoder_fields(enc):
    """make_config's width arguments as encoder fields."""
    hidden = enc["hidden"]
    emb, glob = enc.get("emb", hidden), enc.get("glob", hidden)
    return {"dim_hidden_local": hidden, "dim_hidden_glob": glob, "dim_emb_time": emb,
            "dim_emb_features_continuous": emb, "dim_emb_features_discrete": emb}


def long_k4_instances(device, enc, blocks, n=LONG_WIDE_SLOTS):
    """K4's three trunks at make_config's widths `enc`, `blocks` blocks and
    `n` slots, seeded weights, as their models pack them: MBM's (tokens, the
    8-wide head), the absorbing generator's (the 56-wide head, the hidden
    output) and the transdimensional network's (the folded input, no head,
    the hidden output): (name, packing, hidden output)."""
    out = [("mbm", wide_case_packing(device, enc, blocks), False)]
    for name, config, init, model_class in (
            ("absorbing", AbsorbingConfig(), init_absorbing_parameters, AbsorbingFlow),
            ("transdim", TransdimensionalEpicConfig(), init_transdimensional_parameters,
             TransdimensionalJumpDiffusion)):
        config.data.max_num_particles = n
        for field, value in encoder_fields(enc).items():
            setattr(config.encoder, field, value)
        config.encoder.num_blocks = blocks
        model = init(model_class(config), SEED).to(device).eval()
        trunk = model.pack_for_kernel()[0]
        if trunk is None or trunk.layout != "wide":
            raise RuntimeError(f"the {name} trunk at {enc} and N={n} is not packed for K4")
        out.append((name, trunk, True))
    return out


def long_inputs(packed, B, n, device, gen):
    """K4's inputs at n slots: random non-prefix masks with the last jet
    empty (tokens), or the transdimensional state's prefix masks (the folded
    input); jet 1 then has one live particle, at slot n − 1, past the first
    row block."""
    if packed.dims.fold_discrete:
        state, ts = transdim_state(B, n, device, gen)
        t, x, k, mask = (ts.reshape(B, 1, 1), state.continuous.clone(), state.discrete.clone(),
                         state.particle_mask()[:, :, None].float().contiguous())
    else:
        t, x, k, mask = scattered_inputs(B, n, device, gen)
    mask[1] = 0.0
    mask[1, n - 1] = 1.0
    x, k = x * mask, k * (mask if packed.dims.fold_discrete else mask.long())
    return t, x.contiguous(), k.contiguous(), mask


def phase_long_wide_k4(device, card):
    """Phase 75. K4 on jets of LONG_WIDE_N slots (a cluster of hidden / 128
    column blocks × 2 row blocks a jet) as each family's trunk calls it
    (`long_k4_instances`) at each case of LONG_WIDE_CASES, B=64, jet 1 with
    its one live particle at the last slot: per particle against the plain
    version (outputs and hidden state), the same bits on a repeat. Returns
    the worst share of the gate and error by case."""
    gen = torch.Generator(device=device).manual_seed(SEED + 75)
    gate, out = "within_tol_per_particle", {}
    for name, enc, blocks in LONG_WIDE_CASES:
        worst, err = 0.0, 0.0
        for instance, packed, hidden in long_k4_instances(device, enc, blocks):
            for n in LONG_WIDE_N:
                args = (packed, *long_inputs(packed, LONG_WIDE_CHECK_B, n, device, gen))
                got = epic_forward_wide(*args, output_hidden_local=hidden)
                again = epic_forward_wide(*args, output_hidden_local=hidden)
                torch.cuda.synchronize()
                ref = epic_forward_reference(*args, output_hidden_local=hidden)
                got, again, ref = ((a,) if not hidden else a for a in (got, again, ref))
                cmps = [compare(a, r) for a, r in zip(got, ref)]
                rec = {"phase": "long_wide_k4", "case": name, "instance": instance,
                       "hidden": packed.dims.hidden, "num_blocks": blocks,
                       "cluster": [packed.dims.hidden // 128, 2], "B": LONG_WIDE_CHECK_B, "N": n,
                       "gate": gate,
                       "worst_particle_err_over_bound": max(c["worst_particle_err_over_bound"]
                                                            for c in cmps),
                       "max_abs_err": max(c["max_abs_err"] for c in cmps),
                       "max_abs_ref": max(r.abs().max().item() for r in ref),
                       "same_bits_on_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
                       "finite": all(bool(torch.isfinite(a).all().item()) for a in got)}
                emit(rec)
                if not (all(c[gate] for c in cmps) and rec["same_bits_on_repeat"] and rec["finite"]):
                    raise RuntimeError(f"K4 past 128 slots disagrees with its plain version: {rec}")
                worst = max(worst, rec["worst_particle_err_over_bound"])
                err = max(err, rec["max_abs_err"])
        out[name] = {"worst_share_of_gate": worst, "max_abs_err": err}
        torch.cuda.empty_cache()
    return out


def sparse_long_inputs(B, n, device, gen):
    """t, x, k and a random mask at n slots, each alive with probability
    LONG_K5_PARTICLES / n, and every other jet's last slot alive (at n = 129
    the one slot past the first row block); jet 0 with one live particle, at
    slot n − 1; the last jet empty."""
    mask = (torch.rand((B, n, 1), generator=gen, device=device) < LONG_K5_PARTICLES / n).float()
    mask[::2, n - 1] = 1.0
    mask[0] = 0.0
    mask[0, n - 1] = 1.0
    mask[-1] = 0.0
    x = torch.randn((B, n, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, n, 1), generator=gen, device=device) * mask.long()
    return torch.rand((B, 1, 1), generator=gen, device=device), x, k, mask


def phase_long_wide_k5(device, card):
    """Phase 76. K5 (the wide forward + hand-written backward) on jets of
    LONG_K5_N slots at each case of LONG_K5_CASES against plain autograd
    under phase 12's rules (per packed leaf, no cotangent on near-kink jets),
    B=512: on random non-prefix masks (60% of the slots alive), where the
    near-kink window leaves out nearly every jet, and on sparse scattered
    masks (`sparse_long_inputs`), of whose held jets B/16 must have a
    particle past slot 128; the plain backward in chunks of WIDE_PLAIN_CHUNK
    jets; the same bits on a repeat. Returns the worst error and share of
    the gate by case."""
    gen = torch.Generator(device=device).manual_seed(SEED + 76)
    out, B = {}, LONG_K5_B
    for name, enc, blocks in LONG_K5_CASES:
        packed = wide_case_packing(device, enc, blocks)
        errors = []
        for n in LONG_K5_N:
            for batch in ("dense", "sparse"):
                t, x, k, mask = (scattered_inputs if batch == "dense" else sparse_long_inputs)(
                    B, n, device, gen)
                near = torch.cat([near_kink_jets(packed, *(a[lo:lo + WIDE_PLAIN_CHUNK]
                                                           for a in (t, x, k, mask)))
                                  for lo in range(0, B, WIDE_PLAIN_CHUNK)])
                g = torch.randn((B, n, 11), generator=gen, device=device) * (~near)[:, None, None]
                leaf = packed.flat.clone().requires_grad_(True)
                y = epic_train_forward_wide(packed.rebind(leaf), t, x, k, mask)
                y.backward(g)
                again = epic_backward_wide(packed, t, x, k, mask, g)
                torch.cuda.synchronize()
                fwd = compare(y.detach(), epic_forward_reference(packed, t, x, k, mask))
                ref = chunked_jets(lambda *a: epic_backward_reference(packed, *a), B,
                                   t, x, k, mask, g)
                bwd = leaf_compare(leaf.grad, ref, packed)
                held_past_128 = int(((~near) & (mask[:, 128:, 0].sum(dim=1) > 0)).sum().item())
                rec = {"phase": "long_wide_k5", "case": name, "batch": batch,
                       "hidden": packed.dims.hidden, "num_blocks": blocks,
                       "cluster": [packed.dims.hidden // 128, 2], "B": B, "N": n,
                       "forward": fwd, "backward": bwd,
                       "near_kink_jets_left_out": int(near.sum().item()),
                       "kept_jets_with_a_particle_past_128": held_past_128,
                       "one_particle_jet_held": bool(batch == "sparse" and not near[0].item()),
                       "same_bits_on_repeat": bool(torch.equal(again, leaf.grad)),
                       "finite": bool(torch.isfinite(leaf.grad).all().item())}
                emit(rec)
                covered = batch == "dense" or held_past_128 >= B // 16
                if not (fwd["within_tol_per_particle"] and rec["finite"] and covered
                        and rec["same_bits_on_repeat"] and not bwd["leaves_out_of_bound"]):
                    raise RuntimeError(f"K5 past 128 slots disagrees with plain autograd: {rec}")
                errors.append(bwd)
                del leaf, y, again, ref, near, g
        out[name] = {"max_abs_err": max(e["max_abs_err"] for e in errors),
                     "worst_leaf_err_over_bound": max(e["worst_leaf_err_over_bound"]
                                                      for e in errors)}
        del packed
        torch.cuda.empty_cache()
    return out


def phase_long_wide_time(device, card):
    """Phase 77. K4 and K5 at B=8192 on jets of 256 slots at the scaled
    backbone and at scaled-256, and K4 at the scaled backbone also at N =
    128, 129 and 192 (the step at the row cut), each beside its plain
    version (K4's in chunks of 2048 jets, K5's autograd at WIDE_PLAIN_CHUNK
    jets) and both bounds for this N, timed in turns plain, kernel, kernel,
    plain. Returns the times and bounds by case and N."""
    gen = torch.Generator(device=device).manual_seed(SEED + 77)
    out = {}
    for name, enc, blocks in LONG_WIDE_TIMED_CASES:
        packed = wide_case_packing(device, enc, blocks)
        d = packed.dims
        for n in (LONG_WIDE_TIMED_N if name == "scaled" else (LONG_WIDE_SLOTS,)):
            t, x, k, mask = scattered_inputs(TRAIN_B, n, device, gen)
            kernel = lambda: epic_forward_wide(packed, t, x, k, mask)
            plain = lambda: torch.cat([epic_forward_reference(
                packed, *(a[lo:lo + SCALED_PLAIN_B] for a in (t, x, k, mask)))
                for lo in range(0, TRAIN_B, SCALED_PLAIN_B)])
            p1, k1, k2, p2 = cuda_ms(plain, 2), cuda_ms(kernel, 5), cuda_ms(kernel, 5), cuda_ms(plain, 2)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound = kernel_bound(packed, TRAIN_B, "forward", n)
            products = products_tensor_bound_ms(d, TRAIN_B, n)
            emit({"phase": "long_wide_time", "kernel": "K4", "case": name, "B": TRAIN_B, "N": n,
                  "num_blocks": blocks, "ms": ms, "plain_ms": plain_ms, **bound,
                  **against_bounds(bound, ms), "products_tensor_bound_ms": products,
                  "card": card})
            out[f"K4_{name}_n{n}"] = {"ms": ms, "plain_ms": plain_ms, **bound_fields(bound),
                                      "products_tensor_bound_ms": products,
                                      "timed_at": {"hidden": d.hidden, "num_blocks": blocks,
                                                   "B": TRAIN_B, "N": n}}
        n = LONG_WIDE_SLOTS
        t, x, k, mask = scattered_inputs(TRAIN_B, n, device, gen)
        g = torch.randn((TRAIN_B, n, 11), generator=gen, device=device)
        small = tuple(a[:WIDE_PLAIN_CHUNK].contiguous() for a in (t, x, k, mask, g))
        kernel = lambda: epic_backward_wide(packed, t, x, k, mask, g)
        plain = lambda: epic_backward_reference(packed, *small)
        p1, k1, k2, p2 = cuda_ms(plain, 3), cuda_ms(kernel, 3), cuda_ms(kernel, 3), cuda_ms(plain, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound = kernel_bound(packed, TRAIN_B, "backward", n)
        products = wide_backward_products_tensor_bound_ms(d, TRAIN_B, n)
        _, floats = epic_wide_vjp_cuda._workspace(_build.load_library(), TRAIN_B, n, d, device)
        emit({"phase": "long_wide_time", "kernel": "K5", "case": name, "B": TRAIN_B, "N": n,
              "num_blocks": blocks, "backward_ms": ms, "plain_B": WIDE_PLAIN_CHUNK,
              "backward_plain_ms_at_plain_B": plain_ms, **bound, **against_bounds(bound, ms),
              "products_tensor_bound_ms": products, "k5_scratch_gb": 4 * floats / 1e9,
              "card": card})
        out[f"K5_{name}_n{n}"] = {"ms": ms, "plain_ms": plain_ms, **bound_fields(bound),
                                  "products_tensor_bound_ms": products,
                                  "timed_at": {"hidden": d.hidden, "num_blocks": blocks,
                                               "B": TRAIN_B, "N": n, "plain_B": WIDE_PLAIN_CHUNK}}
        del packed, t, x, k, mask, g, small
        torch.cuda.empty_cache()
    return out


def phase_slice_scaled_n256(device, card):
    """Phase 78. MBM at the scaled backbone with max_num_particles 256
    (data-dependent gains) serves one request of 8192 jets: 99 launches of
    K4, no other kernel, no plain version, phase 5's checks; then the 99-step
    kernel path against the module path at B=256 (paths_scaled_n256, phase
    6's bounds)."""
    n = LONG_WIDE_SLOTS
    config = make_config(**SCALED)
    config.data.max_num_particles = n
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, SEED)
    model = model.to(device).eval()
    emit({"phase": "slice_scaled_n256_init", "log10_gain_divisors":
          data_dependent_gains(model, device)})
    gen = torch.Generator(device=device).manual_seed(SEED + 78)
    batch = gauss_noise_source_batch(TRAIN_B, n, 3, 8, gen, device=device, num_empty=1)
    torch.cuda.synchronize()
    reset_counts()  # the scaled N = 256 serving path's run starts here
    start = time.perf_counter()
    out = model.predict(batch, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts, only = launched({"epic_wide_forward": 99})
    checks = check_generated(out, batch, TRAIN_B, n)
    emit({"phase": "slice_scaled_n256", "B": TRAIN_B, "N": n, "launches": counts,
          "plain_calls": plain_calls(), "seconds": seconds, "jets_per_s": TRAIN_B / seconds,
          "card": card, **checks})
    if not only:
        raise RuntimeError(f"the scaled N = 256 serving path left its kernels: {counts}")
    phase_paths(device, model, SCALED_PATHS_B, "paths_scaled_n256", n=n)
    return counts


def phase_train_scaled_n256(device, card):
    """Phase 79. Trainer.fit at the scaled backbone with max_num_particles
    256, B=8192 (TRAIN_BATCHES synthetic batches + 1 validation batch),
    data-dependent gains: K5 once a train step, K4 once a step and a
    validation batch, no plain version, the losses finite and falling. Then
    on a slice of LONG_GRAD_B jets of the first batch, with the same bridge
    draws, `loss_fn`'s value and every parameter's gradient by the kernels
    (K4 + K5) against plain autograd: the losses within LOSS_BOUND, every
    leaf's gradient within GRAD_BOUND of the leaf's largest."""
    n = LONG_WIDE_SLOTS
    gen = torch.Generator(device=device).manual_seed(SEED + 79)
    dm = InMemoryDataModule(
        train=[synthetic_training_batch(TRAIN_B, n, 3, 8, gen, device=device)
               for _ in range(TRAIN_BATCHES)],
        valid=[synthetic_training_batch(TRAIN_B, n, 3, 8, gen, device=device)])
    config = make_config(**SCALED)
    config.data.max_num_particles = n
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(MultiModalBridgeMatching(config).to(device), config,
                          ExperimentsFiles(str(Path(tmp) / "run_scaled_n256")), seed=SEED,
                          ema_decay=EMA_DECAY)
        step_losses = []
        train_step = trainer.train_step

        def recording_step(batch, draws=None):
            metrics = train_step(batch, draws)
            step_losses.append(metrics["loss"])
            return metrics

        trainer.train_step = recording_step
        trainer.setup(steps_per_epoch=TRAIN_BATCHES)
        divisors = set_gains(trainer, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()  # the scaled N = 256 training path's run starts here
        start = time.perf_counter()
        history = trainer.fit(dm, epochs=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    counts, only = launched({"epic_wide_forward": TRAIN_BATCHES + 1,
                             "epic_wide_backward": TRAIN_BATCHES})
    plain = plain_calls()
    losses = [v.item() for v in step_losses]
    finite = all(torch.isfinite(torch.tensor(losses + [r["val_loss"] for r in history])).tolist())

    model, S = trainer.model, LONG_GRAD_B
    first = dm.train[0]
    batch = MultimodalDatabatch(**{f.name: None if getattr(first, f.name) is None
                                   else getattr(first, f.name)[:S]
                                   for f in dataclasses.fields(first)})
    draws = (torch.rand((S,), generator=gen, device=device),
             torch.randn((S, n, 3), generator=gen, device=device),
             torch.rand((S, n), generator=gen, device=device))
    grads, slice_losses = [], []
    for use_pallas in (True, False):
        model.config.parallel.use_pallas = use_pallas
        model.zero_grad()
        loss, _ = model.loss_fn(batch, draws=draws)
        loss.backward()
        slice_losses.append(loss.item())
        grads.append({name: p.grad.detach().clone() for name, p in model.named_parameters()
                      if p.grad is not None})
    model.config.parallel.use_pallas = "auto"
    model.zero_grad()
    worst, worst_leaf = 0.0, None
    for name, ref in grads[1].items():
        share = ((grads[0][name] - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        if share >= worst:
            worst, worst_leaf = share, name
    loss_diff = abs(slice_losses[0] - slice_losses[1]) / abs(slice_losses[1])
    emit({"phase": "train_scaled_n256", "B": TRAIN_B, "N": n, "steps": TRAIN_BATCHES,
          "log10_gain_divisors": divisors, "step_losses": losses, "epochs": history,
          "launches": counts, "plain_calls": plain, "fit_seconds": seconds,
          "steps_per_s": TRAIN_BATCHES / seconds,
          "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
          "slice_B": S, "slice_loss_kernel": slice_losses[0], "slice_loss_plain": slice_losses[1],
          "slice_rel_loss_diff": loss_diff, "loss_bound": LOSS_BOUND,
          "max_grad_diff_over_leaf_max": worst, "worst_leaf": worst_leaf,
          "leaves": len(grads[1]), "grad_bound": GRAD_BOUND, "card": card})
    if not only:
        raise RuntimeError(f"the scaled N = 256 fit launched {counts}, plain {plain}")
    if not finite or not sum(losses[-2:]) / 2 < losses[0]:
        raise RuntimeError(f"the scaled N = 256 loss is not finite or did not fall: {losses}")
    if set(grads[0]) != set(grads[1]) or loss_diff > LOSS_BOUND or worst > GRAD_BOUND:
        raise RuntimeError(f"the kernels' gradient at N = 256 parts from autograd: {worst_leaf} "
                           f"{worst}, losses {slice_losses}")
    return counts


def long_wide_phases(device, card):
    """Phases 75-80: K4 (75) and K5 (76) past 128 slots against their plain
    versions, both timed at N = 256 and K4 across the row cut (77), scaled
    MBM served (78) and trained (79) at N = 256, and (80) the scaled and
    scaled-256 absorbing and transdimensional families served at N = 256,
    4096 jets each, with their paths checks. Returns the kernels line's
    additions for K4 and K5 and each path's launches by kernel name."""
    k4 = phase_long_wide_k4(device, card)
    k5 = phase_long_wide_k5(device, card)
    times = phase_long_wide_time(device, card)
    paths = {"serving_scaled_n256": phase_slice_scaled_n256(device, card)}
    torch.cuda.empty_cache()
    paths["train_scaled_n256"] = phase_train_scaled_n256(device, card)
    torch.cuda.empty_cache()
    for width, tag in ((SCALED_HIDDEN, "_n256"), (SCALED256_HIDDEN, "256_n256")):
        paths[f"serving_absorbing_scaled{tag}"] = phase_slice_absorbing_scaled(
            device, card, width, (LONG_B,), tag, n=LONG_WIDE_SLOTS)
        torch.cuda.empty_cache()
        paths[f"serving_transdim_scaled{tag}"] = phase_slice_transdim_scaled(
            device, card, width, (LONG_B,), tag, n=LONG_WIDE_SLOTS)
        torch.cuda.empty_cache()
    return k4, k5, times, paths


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    build = _build.build_library()
    _build.load_library()
    ptxas = [line.strip() for line in build.log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry function" in line]
    # the C++ substructure library (g++, host side) that phases 36-38 and 41 score with
    start = time.perf_counter()
    if native.load_substructure_lib() is None:
        raise RuntimeError("the C++ substructure library did not build (g++)")
    substructure_seconds = time.perf_counter() - start
    emit({"phase": "build", "seconds": build.seconds, "source_seconds": build.source_seconds,
          "library": str(build.path.relative_to(ROOT)), "ptxas": ptxas,
          "substructure_library": str(native.build_library().relative_to(ROOT)),
          "substructure_build_seconds": substructure_seconds})

    build_dir = ROOT / "multimodal_particles_tpu_torch" / "ops" / "build"
    kernels = narrow_phases(device, card, build_dir) + scaled_phases(device, card, build_dir)
    k6_entry, k1_absorbing = absorbing_phases(device, card, build_dir)
    # K1 also serves the absorbing family, with its hidden output and the
    # 56-wide head: that call's check, times and launches beside MBM's
    kernels[0]["launches_by_path"].update(k1_absorbing.pop("launches_by_path"))
    kernels[0]["absorbing"] = k1_absorbing
    kernels.append(k6_entry)
    # and the transdimensional family, with the folded Linear-discrete input
    k7_entry, k1_transdim = transdim_phases(device, card, build_dir, build.log)
    kernels[0]["launches_by_path"].update(k1_transdim.pop("launches_by_path"))
    kernels[0]["transdim"] = k1_transdim
    kernels.append(k7_entry)
    # the two families at the `--scaled` backbone: K4's other trunks, K7 at
    # wide inputs, and K8
    scaled = scaled_family_phases(device, card)
    k4, k6, k7 = kernels[3], kernels[5], kernels[6]
    k4["absorbing_scaled"], k4["transdim_scaled"] = scaled["k4_absorbing"], scaled["k4_transdim"]
    k4["row_cut_worst_share_of_gate"] = scaled["k4_row_cut"]
    k4["launches_by_path"].update(serving_absorbing_scaled=scaled["absorbing"]["epic_wide_forward"],
                                  serving_transdim_scaled=scaled["transdim"]["epic_wide_forward"])
    k6["launches_by_path"]["serving_absorbing_scaled"] = scaled["absorbing"]["survival_head"]
    k7["wide_input"] = scaled["k7_wide"]
    k7["launches_by_path"]["serving_transdim_scaled"] = scaled["transdim"]["gsdm_stack"]
    kernels.append(scaled["k8_entry"])
    # the user's runs from a config on the jets; their run directories live on
    # for phase 49
    runs_dir = tempfile.TemporaryDirectory(dir=build_dir)
    runs = Path(runs_dir.name)
    mbm, absorbing, transdim = experiment_phases(device, card, runs)
    k1, k2, k3 = kernels[0], kernels[1], kernels[2]
    k1["launches_by_path"].update(
        experiment_train=mbm["train"]["epic_forward"],
        experiment_absorbing_generate=absorbing["generate"]["epic_forward"],
        experiment_transdim_generate=transdim["generate"]["epic_forward"])
    k2["launches_by_path"]["experiment_generate"] = mbm["generate"]["sampler_step"]
    k3["launches_by_path"]["experiment_train"] = mbm["train"]["epic_backward"]
    k6["launches_by_path"]["experiment_absorbing_generate"] = absorbing["generate"]["survival_head"]
    k7["launches_by_path"]["experiment_transdim_generate"] = transdim["generate"]["gsdm_stack"]
    # the bulk sweeps of the three families
    bulk_mbm, bulk_absorbing, bulk_transdim = bulk_phases(device, card)
    k2["launches_by_path"]["bulk_mbm"] = bulk_mbm["sampler_step"]
    k1["launches_by_path"].update(bulk_absorbing=bulk_absorbing["epic_forward"],
                                  bulk_transdim=bulk_transdim["epic_forward"])
    k6["launches_by_path"]["bulk_absorbing"] = bulk_absorbing["survival_head"]
    k7["launches_by_path"]["bulk_transdim"] = bulk_transdim["gsdm_stack"]
    # every encoder switch and context on the module path, and the bf16 compute dtype
    switches, conditional, bf16 = switch_phases(device, card)
    for entry, name in ((k1, "epic_forward"), (k2, "sampler_step"), (k3, "epic_backward")):
        entry["launches_by_path"]["switches"] = switches[name]
    k1["launches_by_path"]["conditional_absorbing"] = conditional.get("epic_forward", 0)
    k6["launches_by_path"]["conditional_absorbing"] = conditional["survival_head"]
    k2["launches_by_path"]["bf16_predict"] = bf16["bf16_predict"]["sampler_step"]
    k1["launches_by_path"]["bf16_train"] = bf16["bf16_train"]["epic_forward"]
    k3["launches_by_path"]["bf16_train"] = bf16["bf16_train"]["epic_backward"]
    k1["launches_by_path"]["bf16_absorbing_predict"] = bf16["bf16_absorbing_predict"]["epic_forward"]
    k6["launches_by_path"]["bf16_absorbing_predict"] = bf16["bf16_absorbing_predict"]["survival_head"]
    # the quality path: a shard, the families' harness trained and scored, the evaluation
    with runs_dir:
        q_absorbing, q_transdim, evaluated = quality_phases(device, card, runs, mbm)
        # the transdimensional context, and the head-to-head and sweep harnesses on the
        # shard and the trained weights of phases 46-48
        context, parity, scaled_data_runs, stress, sweeps = sweep_phases(device, card, runs)
    k1["launches_by_path"].update(quality_absorbing=q_absorbing["epic_forward"],
                                  quality_transdim=q_transdim["epic_forward"])
    k6["launches_by_path"]["quality_absorbing"] = q_absorbing["survival_head"]
    k7["launches_by_path"]["quality_transdim"] = q_transdim["gsdm_stack"]
    k7["paths_transdim_trained_worst_share_of_gate"] = q_transdim["k7_share_of_gate"]
    k2["launches_by_path"]["evaluate"] = evaluated["sampler_step"]
    k1["launches_by_path"]["transdim_context"] = context["epic_forward"]
    k7["launches_by_path"]["transdim_context"] = context["gsdm_stack"]
    k1["launches_by_path"]["quality_parity_train"] = parity["train"]["epic_forward"]
    k3["launches_by_path"]["quality_parity_train"] = parity["train"]["epic_backward"]
    k2["launches_by_path"]["quality_parity_generate"] = parity["generate"]["sampler_step"]
    for family, launches in scaled_data_runs.items():
        for entry, name in ((k1, "epic_forward"), (k2, "sampler_step"), (k3, "epic_backward"),
                            (k6, "survival_head"), (k7, "gsdm_stack")):
            count = launches["train"].get(name, 0) + launches["generate"].get(name, 0)
            if count:
                entry["launches_by_path"][f"scaled_data_{family}"] = count
    k1["launches_by_path"]["absorbing_stress"] = stress["epic_forward"]
    k6["launches_by_path"]["absorbing_stress"] = stress["survival_head"]
    k1["launches_by_path"]["transdim_sweeps"] = sweeps["epic_forward"]
    k7["launches_by_path"]["transdim_sweeps"] = sweeps["gsdm_stack"]
    # data and tensor parallelism: one NCCL rank, then two gloo ranks on the card
    nccl, by_rank = parallel_phases(device, card, build_dir)
    k1["launches_by_path"]["dp_nccl"] = nccl["epic_forward"]
    k3["launches_by_path"]["dp_nccl"] = nccl["epic_backward"]
    for path, launches in by_rank.items():
        for entry in kernels[:5]:
            if launches.get(entry["name"]):
                entry["launches_by_path"][path] = launches[entry["name"]]
    # the head kernels at every width and head count, and the four predicts beside them
    widths, paths = head_width_phases(device, card)
    k8 = kernels[7]
    for entry in (k6, k7, k8):
        entry["widths"] = widths[entry["name"]]
    for entry in (k1, k6, k7, k8):
        for path, launches in paths.items():
            if launches.get(entry["name"]):
                entry["launches_by_path"][path] = launches[entry["name"]]
    # K4, K5 and K6 at the wide widths, and the three families at scaled-256
    k4_widths, k5_widths, k6_trunk, wide_paths = wide_width_phases(device, card)
    k4, k5 = kernels[3], kernels[4]
    k4["widths"], k5["widths"], k6["trunk_256"] = k4_widths, k5_widths, k6_trunk
    for entry in (k4, k5, k6, k7):
        for path, launches in wide_paths.items():
            if launches.get(entry["name"]):
                entry["launches_by_path"][path] = launches[entry["name"]]
    # K6, K7 and K8 past 128 slots, and the two families served at N = 256 and 200
    long_heads, long_paths = long_head_phases(device, card)
    for entry in (k6, k7, k8):
        entry["past_128_slots"] = long_heads[entry["name"]]
    for entry in (k1, k6, k7):
        for path, launches in long_paths.items():
            if launches.get(entry["name"]):
                entry["launches_by_path"][path] = launches[entry["name"]]
    # K4 and K5 past 128 slots, scaled MBM served and trained at N = 256, and the two
    # families at the scaled and scaled-256 backbones at N = 256
    k4_long, k5_long, long_times, long_wide_paths = long_wide_phases(device, card)
    for entry in (k4, k5, k6, k7):
        for path, launches in long_wide_paths.items():
            if launches.get(entry["name"]):
                entry["launches_by_path"][path] = launches[entry["name"]]
    kernels.extend(past_128_entries(k4_long, k5_long, long_times, long_wide_paths))
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def past_128_entries(k4_checks, k5_checks, times, paths):
    """The kernels line's entries of K4 and K5 on jets of 129 to 256 slots
    (phases 75-80): `launches` the scaled N = 256 serving path's run (K4) and
    training path's run (K5); the errors from phases 75 and 76, the times and
    bounds from phase 77 at the scaled backbone, N = 256, B = 8192."""
    n = LONG_WIDE_SLOTS

    def by_path(name):
        return {path: launches[name] for path, launches in paths.items() if launches.get(name)}

    k4, k5 = times[f"K4_scaled_n{n}"], times[f"K5_scaled_n{n}"]
    return [
        {"name": "epic_wide_forward_past_128_slots", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_wide_forward_h128_r2.cu",
         "also_sources": [f"multimodal_particles_tpu_torch/ops/csrc/epic_wide_forward_h{w}_r2.cu"
                          for w in (256, 384, 512)],
         "replaces": "multimodal_particles_tpu/ops/epic_pallas_wide.py:318",
         "launches": paths["serving_scaled_n256"]["epic_wide_forward"],
         "launches_by_path": by_path("epic_wide_forward"),
         "max_abs_err": k4_checks["scaled"]["max_abs_err"], "max_abs_err_by_case": k4_checks,
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         **{key: k4[key] for key in BOUND_KEYS}, "library_ms": None,
         "timed_at": k4["timed_at"],
         "times": {key: value for key, value in times.items() if key.startswith("K4")}},
        {"name": "epic_wide_backward_past_128_slots", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_wide_backward_h128_r2.cu",
         "also_sources": [f"multimodal_particles_tpu_torch/ops/csrc/epic_wide_backward_h{w}_r2.cu"
                          for w in (256, 384, 512)],
         "replaces": "multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py:349",
         "launches": paths["train_scaled_n256"]["epic_wide_backward"],
         "launches_by_path": by_path("epic_wide_backward"),
         "max_abs_err": k5_checks["scaled"]["max_abs_err"], "max_abs_err_by_case": k5_checks,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         **{key: k5[key] for key in BOUND_KEYS}, "library_ms": None,
         "timed_at": k5["timed_at"],
         "times": {key: value for key, value in times.items() if key.startswith("K5")}},
    ]


def bound_keys(packed, B, kind):
    bound = kernel_bound(packed, B, kind)
    return bound_fields(bound)


def narrow_phases(device, card, build_dir):
    """Phases 3-10 at config-berlin; the kernels line's entries for K1-K3."""
    k1_err, k1_errors, k1_ms, k1_plain, k1_bounds = phase_k1(device, card)
    k2_err, k2_ms, k2_plain = phase_k2(device, card)
    serving = phase_slice(device, card)
    phase_paths(device)
    k3_err, k3_errors, k3_ms, k3_plain, k3_bounds = phase_k3(device, card)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        trainer, dm, train, rate = phase_train(device, card, Path(tmp))
        phase_profile(trainer, dm, card, Path(tmp), rate["step_seconds"])
    del trainer, dm
    phase_train_paths(device, card)

    # `launches` is the count of the training path's run (fit, restore,
    # predict); each path's own count beside it. `max_abs_err` is taken at the
    # width `ms` was timed at (hidden 16). No one PyTorch call computes an EPiC
    # encoder or its sampler step, so there is no library time.
    def by_path(name):
        return {"serving": serving.get(name, 0), "train": train[name]}

    model = make_model(device)
    berlin = pack_mbm_encoder_params(model.encoder, model.config)
    return [
        {"name": "epic_forward", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_forward.cu",
         "replaces": "multimodal_particles_tpu/ops/epic_pallas.py:432",
         "also_replaces": "multimodal_particles_tpu/ops/epic_pallas_vjp.py:313",
         "launches": train["epic_forward"], "launches_by_path": by_path("epic_forward"),
         "max_abs_err": k1_err, "max_abs_err_by_check": k1_errors,
         "ms": k1_ms, "plain_ms": k1_plain, **k1_bounds,
         "library_ms": None, "timed_at": {"hidden": 16, "B": TIMING_B}},
        {"name": "sampler_step", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/sampler_step.cu",
         "replaces": "multimodal_particles_tpu/ops/sampler_pallas.py:152",
         "launches": train["sampler_step"], "launches_by_path": by_path("sampler_step"),
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         **bound_keys(berlin, TIMING_B, "sampler_step"), "library_ms": None,
         "timed_at": {"hidden": 16, "B": TIMING_B}},
        {"name": "epic_backward", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_backward.cu",
         "replaces": "multimodal_particles_tpu/ops/epic_pallas_vjp.py:351",
         "launches": train["epic_backward"], "launches_by_path": by_path("epic_backward"),
         "max_abs_err": k3_err, "max_abs_err_by_check": k3_errors,
         "ms": k3_ms, "plain_ms": k3_plain, **k3_bounds,
         "library_ms": None, "timed_at": {"hidden": 16, "B": TRAIN_B}},
    ]


def scaled_phases(device, card, build_dir):
    """Phases 11-17 at the scaled backbone; the kernels line's entries for
    K4 and K5. `launches` is the count of the scaled training path's run
    (fit, predict)."""
    k4_err, k4_errors, k4_ms, k4_plain, k4_bound = phase_k4(device, card)
    k5_err, k5_errors, k5_ms, k5_plain, k5_bound = phase_k5(device, card)
    phase_raw_init_scaled(device, card)
    serving, model = phase_slice_scaled(device, card)
    phase_paths(device, model, SCALED_PATHS_B, "paths_scaled")
    del model
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        train = phase_train_scaled(device, card, Path(tmp))
    phase_train_paths(device, card, lambda: make_config(**SCALED), SCALED_PLAIN_B,
                      "train_paths_scaled", gains=True, hold="losses")

    def by_path(name):
        return {"serving_scaled": serving[name], "train_scaled": train[name]}

    return [
        {"name": "epic_wide_forward", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_wide_forward.cu",
         "replaces": "multimodal_particles_tpu/ops/epic_pallas_wide.py:318",
         "also_replaces": "multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py:311",
         "launches": train["epic_wide_forward"], "launches_by_path": by_path("epic_wide_forward"),
         "max_abs_err": k4_err, "max_abs_err_by_check": k4_errors,
         "ms": k4_ms, "plain_ms": k4_plain, **bound_fields(k4_bound), "library_ms": None,
         "timed_at": {"hidden": SCALED_HIDDEN, "num_blocks": SCALED_BLOCKS, "B": TRAIN_B}},
        {"name": "epic_wide_backward", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_wide_backward.cu",
         "replaces": "multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py:349",
         "launches": train["epic_wide_backward"], "launches_by_path": by_path("epic_wide_backward"),
         "max_abs_err": k5_err, "max_abs_err_by_check": k5_errors,
         "ms": k5_ms, "plain_ms": k5_plain, **bound_fields(k5_bound), "library_ms": None,
         "timed_at": {"hidden": SCALED_HIDDEN, "num_blocks": SCALED_BLOCKS, "B": TRAIN_B,
                      "plain_B": SCALED_PLAIN_B}},
    ]


if __name__ == "__main__":
    sys.exit(main())
