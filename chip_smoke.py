"""Drive the PyTorch port (slowfast_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card's name and power limit; fails without CUDA.
  2. build    builds every CUDA kernel from slowfast_tpu_torch/csrc with nvcc,
              with the registers and spill bytes ptxas gives each kernel of
              the tensor-core sources (the exact pair and the constant-shift
              forwards and backwards), and the wgmma serialization warnings
              (C7514) of each source's build log.
  3. kernel   each kernel against its plain PyTorch version on the card, at the
              slice's shape and a ragged one, with its device time, the plain
              version's time and its byte bound.
  3a. maxpool_bwd_kernel  the max-pool backward (csrc/max_pool3d_bwd.cu)
              against max_pool3d_bwd_plain at every max pool of the bf16
              SlowFast 4x16 R50 and MViTv2-S 16x4 train forwards at 16 clips
              and at POOL_EDGE_CASES, bf16 and fp32, on inputs full of ties:
              bit-equal, and bit-equal over two launches; per main-path
              shape the device time, the plain time, ATen's atomic
              max_pool3d_with_indices_backward and the byte bound, summed per
              SlowFast and per MViTv2-S step (with the kernel over ATen and
              its share of the bound).
  3b. avgpool_bwd_kernel  the average-pool backward (csrc/avg_pool3d_bwd.cu)
              against avg_pool3d_bwd_plain, fp32 and float64, at every
              average pool of the bf16 train forwards at 16 clips of
              SlowFast 4x16 R50 (the head's two one-window pools) and X3D-M,
              at SlowFast's head on the 256 test crop (overlapping windows),
              at MViTv2-S's pools under MVIT.MODE avg and at
              AVG_POOL_EDGE_CASES and a strided gradient: bit-equal, and
              bit-equal over two launches; at the CNN heads' shapes in fp32
              the device time, the plain time, ATen's atomic
              avg_pool3d_backward and the byte bound, summed per step.
  4. fp32     the full-width SLOWFAST_4x16_R50 forward on the card against the
              same weights on the CPU, fp32, TF32 off.
  5. slice    the multi-view test (engine.tester.test) at full width in bf16 on
              synthetic video: 2 videos x 10 views x 3 crops; the kernel's
              launch count must equal the batch count.
  6. breakdown  the eval step alone on a batch already on the card, and the
              loader alone, per batch.
  7. attn_kernel  both pooled-attention kernels (the constant-shift core,
              MViT's default, and the exact-softmax core of
              TPU.PALLAS_ATTENTION) against their plain versions on the
              inputs the full-width MViTv2-S 16x4 eval step gives its 16
              blocks at B=8 in bf16, at block 1 at B=1 in fp32, and at small
              cases on every edge of the 64 x 64 tiling (Nk < 64,
              Nk = 64 j + 1, Nq = 1, dq 20/21/24, dv 12/16, extreme
              logits), one bf16 case for each template instance of the
              tensor-core forwards and a case whose every e is a subnormal
              bf16 number; both cores must run their bf16 tensor-core
              kernels in bf16 and their FMA kernels in fp32 (launch
              counters), and every bf16 forward is bit-equal over two
              launches; per distinct block shape the device
              time, the plain time, SDPA's time and backend (on the same
              inputs, and on the backend SDPA picks once q and k are
              zero-padded to a multiple of 8 channels), and the bound. Also
              the MViT eval step alone on a batch already on the card.
  8. mvit_fp32  the full-width MViTv2-S forward on the card against the CPU
              on the same weights, fp32, TF32 off, once with each core.
  9. mvit_slice  the MViTv2-S multi-view test (engine.tester.test) in bf16
              on synthetic video: 4 videos x 5 views x 1 crop in batches of
              8; the constant-shift kernel must launch 16 times a batch.
 10. attn_bwd_kernel  both pooled-attention backward kernels against their
              plain backwards on the q, k, v that the 16 blocks of one
              full-width MViTv2-S train forward at 16 clips in bf16 hand
              their core (with a seeded output gradient), at block 1 at one
              clip in fp32, at the edge cases of attn_kernel and at a case
              whose every e is a subnormal bf16 number; bf16 must run the
              tensor-core kernels and fp32 the FMA ones (launch counters),
              and every bf16 backward is bit-equal over two launches; the
              wrappers' autograd on the card; per distinct block shape the
              device time, the plain time, SDPA's backward time and backend,
              and the bound.
 10a. attn_fused_kernel  the saved-e pair (fused_pooled_attention: the
              saved-e forward and the backward that reads e) on the same
              inputs, the edge cases and one bf16 case for each template
              instance of its tensor-core forward and backward: out and e
              against the plain versions (with the count of e's elements
              that differ from the plain e, and by how many ulps), out
              bit-equal to the flash forward kernel's, forwards on the
              tensor cores in bf16 and the FMA kernel in fp32,
              the gradients against the plain backward and the flash
              backward kernel, bf16 on the tensor cores and fp32 on the FMA
              kernel, bf16 backwards bit-equal over two launches, zero
              underflowing rows, autograd on the card; per distinct block
              shape forward and backward times beside the flash kernels',
              the plain versions', SDPA's, the bounds, the bytes of e and
              the backward's floor (e read four times).
 10b. mvit_train_fused  one full-width MViTv2-S train step at 16 clips
              with the default core, with fused_pooled_attention swapped
              in, and with the exact core (TPU.PALLAS_ATTENTION: the bf16
              tensor-core pair), from the same weights, clips and generator
              seeds. bf16: equal losses of flash and fused, gradients
              within twice the run-to-run distance of two default-core
              runs, 16 launches of each fused and each exact kernel, step
              times and peak memory; the exact step's finite loss and its
              gradients' distance from flash's (recorded: its softmax rounds
              otherwise); the exact step once more with every kernel call
              held against the plain versions on its own inputs, and with
              the plain forward the backward kernel's gradients within
              twice the run-to-run distance of the plain backward's; the
              default step once more with every call of the flash backward
              held against flash_bwd_plain on its own inputs and output
              gradient; fp32 (TF32 off): equal losses and gradients within
              1e-3 relative L2.
 10c. determinism  under torch.use_deterministic_algorithms(True), no
              warn_only (CUBLAS_WORKSPACE_CONFIG=:4096:8, which main sets
              before CUDA starts): two bf16 MViTv2-S 16x4 and two bf16
              SlowFast 4x16 R50 train steps at 16 clips from one state each:
              no op refused, equal losses, bit-equal gradients, both pool
              backward kernels launched on SlowFast's; each pair's step p50
              with the max-pool kernel and with ATen's backward in turns;
              the argmax flips of MViT's residual pools between the flash
              and exact cores.
 11. mvit_train_fp32  one train step of full-width MViTv2-S on one clip on
              the card against the CPU on the same weights, fp32, TF32 off,
              once with each core: loss, grad norm, every gradient and the
              updated parameters; no parameter may lack a gradient or have
              an all-zero one, unless it is zero in exact arithmetic.
 12. mvit_train_slice  run_net.main training MViTv2-S 16x4 for one epoch on
              synthetic video: 4 steps of 16 clips (8 videos, 2 samples
              each) with mixup, drop path, dropout, AdamW and warmup, a val
              epoch of 4 batches and the epoch-1 checkpoint, which must
              reload into a fresh model with an identical eval output.
 13. sf_train_fp32  one train step of full-width SLOWFAST_4x16_R50 on 2
              clips, card vs CPU on the same weights, fp32, TF32 off,
              Nesterov SGD, dropout off: the loss within 1e-5, the head's
              gradients within 1e-4 of their max, all gradients no further
              from a float64 CPU step than twice the CPU's fp32 step, the
              updated parameters and the BN running buffers; the same card
              step with TF32 on, the control, must fail the gradient limit.
 14. sf_train_slice  run_net.main training SLOWFAST_4x16_R50 for one epoch
              on synthetic video: 4 steps of 16 clips with Nesterov SGD,
              warmup and head dropout 0.5, precise BN over the 4 train
              batches, a val epoch of 4 batches and the epoch-1 checkpoint,
              whose BN buffers must be the precise ones and which must
              reload into a fresh model with an identical eval output; the
              preprocess kernel launched once per train, precise-BN and val
              batch.
 14a. data_slice  run_net.main training SLOWFAST_4x16_R50 as sf_train_slice
              does, but on decoded video: a corpus of 64 mp4s of 340 x 256
              at 30 fps, 300 frames each, written with cv2 into a temporary
              directory; Kinetics with the recipe's jitter 256-320, crop
              224, flip, 32 frames at rate 2; 4 steps of 16 clips, precise
              BN, a val epoch of 2 batches, then the 10 x 3 test of 2 videos
              on the epoch-1 checkpoint. Also the train loader alone (no
              model) per 16-clip batch. Prints the step p50 beside
              sf_train_slice's, the share of the steps spent waiting for
              data, the decode backend, and the preprocess launches, which
              must equal the batches. If cv2 does not import it prints
              {"phase": "data_slice", "ran": false, "missing": ["cv2"]}.
 15. cnn_family  X3D-M, I3D-NLN R50, CSN R101 (32 frames, channelwise
              3x3x3) and R(2+1)D R50 (16 frames) at full width: the eval
              forward of one clip card vs CPU in fp32 (TF32 off) within
              1e-4, and bf16 train steps of 16 clips, or 8 where 16 do not
              fit (step p50, peak memory); X3D-M's with its channelwise
              convs on the channels_last_3d view and on a contiguous NCDHW
              copy.
 16. roi_align_kernel  both ROIAlign kernels (csrc/roi_align.cu, forward
              and deterministic backward) against the plain version and
              autograd through it, on the temporal means that a full-width
              SLOWFAST_32x2_R50_SHORT bf16 train forward at 16 clips hands its
              RoI head (slow (16, 14, 14, 2048), fast (16, 14, 14, 256), 128
              ROIs of the synthetic sampler, padded to 8 a clip) and on edge
              cases (16 x 16 and 16 x 28 maps, aligned False, a binding grid
              cap, boxes past the map, C 3 and 257) in fp32 and bf16: forward
              within 1e-5 of max |out|, backward within 1e-5 (fp32) or 2^-8
              (bf16) of max |grad|, both bit-equal over two launches; device
              and plain times and the bounds on the main path.
 17. det_fp32  one SLOWFAST_32x2_R50_SHORT detection train step on 2
              synthetic clips (boxes padded to 8), card vs CPU, fp32, TF32
              off: the masked loss within 1e-5, the eval predictions per box
              within 1e-4, the head's gradients within 1e-4 of their max, all
              gradients within twice the CPU's own distance from float64; the
              TF32 step must fail that limit.
 18. det_train_slice  run_net.main on SLOWFAST_32x2_R50_SHORT over an AVA
              corpus of 455 x 256 JPEG frames (4 videos, keyframes 902-917)
              written with cv2 into a temporary directory: 4 steps of 16 clips
              in bf16, a val epoch with AVA mAP on the mini GT, the checkpoint
              (reloaded: identical eval output), the test split on it with
              mAP on the full GT; ROIAlign launched twice a forward batch and
              twice a train step's backward; the train loader alone; one bf16
              16-clip SLOW_4x16_R50_DETECTION step on bench.py:225's batch.
              Needs cv2.
 19. mvitv1_train_slice  run_net.main training MViTv1-B 16x4
              (MVIT_B_16x4_CONV.yaml: separable pos-embeds, dq = dv = 96) at
              full width and depth in bf16 on synthetic video: 4 steps of 16
              clips with the recipe's AdamW, mixup/cutmix, RandAugment,
              random erasing and clipping, a val epoch and the checkpoint,
              then the 10 x 1 test of 2 videos on it; every call of the
              constant-shift kernels (rows 6 and 7) held against flash_plain
              / flash_bwd_plain on its own inputs, one clip at a time
              (FlashShadow); the step alone, unheld (p50, peak memory); rows
              6 and 7 at each of its block shapes against their plain
              versions, their bounds and SDPA.
 20. mvitv1_fp32  one fp32 train step of MViTv1-B on 2 clips, card (TF32
              off) vs CPU: the loss within 1e-5, the gradients within 1e-3
              relative L2.
 21. vit_train_slice  run_net.main training the ViT-B fine-tune
              (k400_VIT_B_16x4_FT.yaml: 12 blocks, 768 channels, 12 heads,
              1,569 tokens, no pooling, mean pooling) in bf16 with layer
              decay 0.65: 4 steps of 8 clips and a val epoch, every flash
              call held; the step alone; rows 6 and 7 at its shape
              (Nq = Nk = 1,569, dq = dv = 64).
 22. mvit_l_fit  MViTv2-L 40x3 (MVITv2_L_40x3_test.yaml, 48 blocks, 40
              frames at 312², ACT_CHECKPOINT) at full width and depth in
              bf16: 3 held train steps at 4 clips, 3 more unheld (step ms,
              peak memory), steps at 1 clip without checkpointing, the 5 x 3
              test of one video (held); at depth 4 with L's widths the
              checkpointed and the plain step from one state: equal losses,
              gradients within twice the run-to-run distance.
 23. mvit_det  MViTv2-S with DETECTION.ENABLE at full width: one held bf16
              train step on 16 synthetic clips (boxes padded to 8) and its
              ROIAlign launches.
 24. maskfeat_train_slice  run_net.main pretraining MaskFeat
              (k400_MVITv2_S_16x4_MaskFeat_PT.yaml: MViTv2-S, loader masks
              of window [8, 7, 7] at ratio 0.4, HOG targets) at full width
              and depth in bf16 with the recipe's AdamW, clip 0.02 and
              cosine warmup: 4 steps of 32 clips decoded from a corpus of
              mp4s (Kinetics, cv2), the checkpoint (reloaded: identical
              weights), no val epoch; every flash call held; the step alone,
              unheld (p50, peak memory), and HOG's share of it.
 25. mae_train_slice  the same for MAE (k400_VIT_B_16x4_MAE_PT.yaml: ViT-B
              on the 10% visible tokens, a 4-block 512-wide decoder, AdamW
              betas 0.9/0.95, loss-explosion kill 2.0) at 64 clips a step;
              rows 6 and 7 at the encoder's and the decoder's shapes against
              their plain versions (one clip at a time at the decoder's
              size), their bounds and SDPA.
 26. masked_fp32  one fp32 train step of each masked recipe on 2 clips,
              card (TF32 off) vs CPU on the same weights, clips and masks:
              the loss within 1e-5, the gradients within 1e-3 relative L2;
              HOG on the card against the CPU within 1e-5 (a bin flip only
              on a float64 bin edge, counted).
 24a. finetune_slice  (after mae_train_slice, on the same corpus)
              run_net.main fine-tuning MViTv2-S (k400_MVITv2_S_16x4_FT.yaml,
              CHECKPOINT_EPOCH_RESET) in bf16 from maskfeat_train_slice's
              checkpoint: 4 decoded steps of 16 clips and a val epoch, from
              epoch 0; before the first step every loaded tensor equal to
              the checkpoint's or, where the shapes differ, its resize; the
              load's counts FINETUNE_COUNTS; every flash call held.
 24b. ssl_train_slice  (after finetune_slice, on the same corpus)
              run_net.main pretraining MoCo (MoCo_SlowR50_8x8.yaml: Slow R50
              8 x 224², DIM 128, a 3-layer projection MLP, QUEUE_LEN 65,536,
              MOCO_MULTI_VIEW_QUEUE, 4 temporal views a clip with the MoCo-v2
              colour recipe) at full width in bf16 for 2 epochs over 64 of
              the decoded videos at the recipe's 64 clips a step: epoch 0 is
              all queue warm-up (the parameters bit-equal after its step),
              the step after it updates, the queue pointer moves 2 x clips
              a step, the kNN probe runs after epoch 2, the checkpoint resumes
              model and SSL state bit-equal; the updating step's clips/s and
              the run's peak memory. No kernel but the Slow stem's max-pool
              backward launches: the SSL items are float pathways and Slow
              R50 runs on cuDNN.
 24c. linear_probe_slice  run_net.main training linear_k400_Slow_8x8_R50_syn8
              (Slow R50, DETACH_FINAL_FC) from ssl_train_slice's checkpoint
              through CHECKPOINT_CLEAR_NAME_PATTERN ("backbone."): the load's
              counts (every backbone tensor loaded, the head's projection
              fresh), 4 decoded steps of 16 clips and a val batch, 5
              preprocess launches, the backbone bit-equal to the checkpoint
              after them and without gradients.
 24d. ssl_family  BYOL, SimCLR and SwAV at full width in bf16 with LARS,
              each 2 decoded run_net steps of 32 clips (64 do not fit in
              80 GB) with finite losses: the p50 and the fastest of the
              steps after the first (clips/s) and the run's peak memory; SwAV's prototype
              rows of unit length after each step and unmoved in epoch 0
              but for the renormalization.
 24e. ssl_ddp  (after ssl_family, on the same corpus) the SSL collectives
              under data parallelism, one NCCL rank: MoCo_SlowR50_8x8.yaml
              (the multi-view queue), SimCLR_SlowR50_8x8.yaml and
              SwAV_Slow_R50_8x8.yaml at full width, per recipe an fp32 step
              (TF32 off) on 4 clips in a group of one against the same step
              from the same state with no group: loss within 1e-5,
              gradients within 1e-4 relative L2, the queue rows, pointer,
              bank rows and momentum encoder equal; the bf16 MoCo step of
              16 clips with no group, the group and no group again (p50 ms,
              clips/s, peak memory); then the launcher's rank entry
              (utils.multiprocessing.run) on run_net's MoCo config: one
              epoch of 2 steps of 8 decoded clips, the kNN probe and the
              checkpoint, and a second run that auto-resumes from it (its
              model and SSL state bit-equal to the first run's end) and
              trains epoch 2.
 24f. ptv_recipes  run_net.main training
              configs/Kinetics/pytorchvideo/SLOWFAST_4x16_R50.yaml
              (Ptvkinetics, PTVSlowFast) as shipped, TensorBoard on, at full
              width in bf16 on the corpus: 4 steps of 16 clips, the recipe's
              precise BN over the 4 train batches and a val epoch, row 1
              once per train, precise-BN and val batch, the JAX trainer's
              scalar tags in one event file; the same with
              TPU.UINT8_PIPELINE False (float pathways normalized on the
              host, no row-1 launch), and the host's normalization within
              1e-6 of row 1's output on the same clips; every
              configs/Kinetics/pytorchvideo YAML built at full size on the
              card; one bf16 forward of the PTVMViT model (4 clips) with
              every flash call held against flash_plain.
 24g. vis_tools  the visualize tool through run_net on MVITv2_S_16x4 in
              bf16: seeded weights saved as a port checkpoint, the test of 16
              synthetic clips (its predictions pickled), then MODEL_VIS (the
              weight and first-batch activation histograms of blocks 2 and
              14, Grad-CAM on block 13) and WRONG_PRED_VIS with the pickle as
              PREDICTIONS_PATH: the event file's tags, rows 1, 6 and 7
              counted, every flash call held; Grad-CAM of one batch at its
              labels with the kernels and with their plain versions in bf16
              and fp32: the kernels' bf16 map and gradient within twice the
              plain versions' bf16 distance of their fp32 ones;
              SlowFast 4x16's two-pathway Grad-CAM, fp32, card (TF32 off)
              against CPU within 1e-4.
 24h. mae_vis  the MAE ViT-B recipe's test of 8 decoded clips under
              VIS_MASK.ENABLE: 8 mp4s that cv2 reads back as T frames of
              H x 3W, row 6 counted and held.
 24i. demo_slice  the demo through run_net on SLOWFAST_4x16_R50 in bf16 over
              one corpus mp4, a clip every 8 frames: plain, then threaded
              with two clips in flight (the same predictions within 1e-5),
              the frames the JAX demo writes, the first clip fp32 card vs
              CPU within 1e-4, the p50 clip latency; the AVA live demo on
              SLOWFAST_32x2_R50_SHORT with the motion proposals (ROIAlign a
              clip) and the precomputed-box visualizer on a csv of boxes and
              ground truth.
 24j. data_bench  utils/benchmark.py: benchmark_data_loading for one epoch
              of SlowFast 4x16's train loader over 64 decoded clips (clips/s
              a batch), and benchmark_core_budget (one worker's clips per
              CPU-second over the same mp4s).
 26a. ssl_fp32  one MoCo step on 2 clips and one BYOL step on 4 (its MLPs'
              BNs are degenerate on 2) at full width in fp32, card (TF32
              off) vs CPU from the same weights, SSL state
              and batch, past MoCo's warm-up: the loss within 1e-5, the
              gradients no further from the float64 step than twice the
              CPU's; the queue rows written, the kNN rows and each leaf of
              the momentum encoder within 1e-6 relative L2 of the CPU's or
              no further from the float64 step than twice the CPU's (a leaf
              that takes in an update large against it carries the
              gradients' conditioning); equal pointers and step counts.
 27. rev_mvit_train_slice  run_net.main training Rev-MViT-B 16x4
              (REV_MVIT_B_16x4_CONV.yaml) at full width and depth in bf16
              with the reversible backward: 4 steps of 16 clips, a val
              epoch, the checkpoint (identical eval output on reload), the
              5 x 1 test of 2 videos; 29 row-6 forwards and 16 row-7
              backwards a step, every call held (FlashShadow), the
              rebuilds' included; the step alone, unheld.
 28. rev_mvit_memory  the memory a forward leaves for the backward and the
              peak above the allocation before it, 16 clips in bf16, with
              the reversible backward, the checkpointed fallback
              (TPU.REV_BACKPROP False) and neither, at depth 16 and 24: the
              reversible growth a block under 5% of the checkpointed one;
              the rebuilt inputs' error against the forward's, per span.
 29. rev_mvit_fp32  one fp32 train step of Rev-MViT-B on 2 clips, card
              (TF32 off) vs CPU: loss within 1e-5, gradients within 1e-3
              relative L2; the reversible backward against the fallback on
              the card within the same limits.
 30. multigrid_slice  run_net.main training
              SLOWFAST_8x8_R50_stepwise_multigrid.yaml (both cycles) at full
              width in bf16, TRAIN.BATCH_SIZE 8 on one GPU (the recipe's BN
              splits), on 256 synthetic clips, the schedule shrunk to 6
              epochs over the four long-cycle shapes: every step's (B, T,
              crop) and BN splits equal MultigridSchedule's, each transition
              carries the parameters and momentum bit for bit, the
              preprocess kernel once a train, precise-BN and val batch; per
              (B, T, crop) the step ms, clips/s and peak memory, and the LR
              around each transition.
 31. imagenet_train_slice  (on a corpus of 192 JPEGs of 500 x 375 written
              with cv2) run_net.main training ImageNet MViTv2-S
              (configs/ImageNet/MVITv2_S.yaml, the 2D patch stem, 1,000
              classes, mixup, RandAugment, erasing) at full width in bf16: 4
              steps of 32 images and a val epoch, every flash call held; the
              loader alone; the step alone; rows 6 and 7 at each block
              shape (the first block's Nq 3,136, Nk 196) against their
              plain versions, bounds and SDPA.
 32. in1k_maskfeat  run_net.main pretraining in1k_VIT_B_MaskFeat_PT.yaml
              (2D MaskFeat, the loader's 14 x 14 masks) on the same corpus:
              4 steps of 32 images, every flash call held; every
              configs/ImageNet and in1k_* YAML built at full size.
 33. imagenet_fp32  one fp32 train step of the 2D MViTv2-S on 2 images,
              card (TF32 off) vs CPU: loss within 1e-5, gradients within
              1e-3 relative L2.
 34. ddp_slice  the data-parallel path (utils/distributed.py,
              utils/multiprocessing.py) on SLOWFAST_4x16_R50 at full width
              with BN.NORM_TYPE sync_batchnorm, one rank over NCCL (one card
              holds one rank): three fp32 steps (TF32 off) in a group of one,
              each against the same step from the same state with no group
              (loss within 1e-5, gradients within 1e-4 relative L2); the
              bf16 step of 16 clips with no group, with the group and with
              no group again (p50 ms, peak memory, the profiler's device time
              and NCCL kernels, the collectives a step calls and the host
              time of one); then
              the launcher's rank entry (utils.multiprocessing.run, what each
              spawned rank runs) on run_net's config: one epoch of 4 steps,
              precise BN, a val epoch and the checkpoint, and a second run
              resumed from that checkpoint through TRAIN.CHECKPOINT_FILE_PATH
              (CHECKPOINT_EPOCH_RESET False): epoch 2 only, the optimizer
              state bit-equal to the checkpoint's; the preprocess kernel
              once a train, precise-BN and val batch.
 35. kernels  one line per kernel with its launches on its path, error,
              times and bound; before it the max-pool and the average-pool
              backwards' launches by train path (maxpool_launches,
              avgpool_launches; the latter must be above zero on
              sf_train_slice, X3D-M's cnn_family run and ddp_slice).
Before the phases, one line per host library that the data path and the
trainer may use (cv2, PIL, sklearn, tensorboard, matplotlib): whether it
imports, and its version. On the H100 hosts this runs on, tensorboard
imports and matplotlib does not, so ptv_recipes runs the recipe's
TensorBoard as shipped (scalars only; the confusion-matrix and histogram
figures need matplotlib and stay on the CPU tests).
The last line is {"ok": true, "device": {...}}. Any failed check raises, and
the script exits non-zero without printing that line.
"""

import contextlib
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(ROOT, "configs", "Kinetics", "SLOWFAST_4x16_R50.yaml")
MVIT_YAML = os.path.join(ROOT, "configs", "Kinetics", "MVITv2_S_16x4.yaml")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# H100 SXM (80 GB HBM3) peaks, NVIDIA's data sheet: memory rate,
# non-tensor-core fp32 rate and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
FULL_WIDTH_ATOL = 1e-4  # softmax, card (fp32, TF32 off) vs CPU
# The MaskFeat pretraining checkpoint loaded into the MViTv2-S fine-tune
# (finetune_slice): the counts the JAX package's load gives at the recipes'
# depth and grids (tests/test_torch_finetune.py pins them); "loaded" is the
# fine-tune's tensors less the missing final norm and head.
FINETUNE_COUNTS = {"skipped": 0, "missing": 4, "unexpected": 5}
# Exponentials: 16 a clock on each of the 132 SMs at the 1.98 GHz boost
# clock (the multi-function unit's ex2 rate, CUDA programming guide).
EXP_PER_S = 16 * 132 * 1.98e9
# Attention kernel vs its plain version, as a share of max |v| (outputs are
# convex combinations of v's rows): fp32 differs only in summation order;
# bf16 may round e, and the output, one bf16 ulp (2^-8) the other way.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Backward kernel vs its plain backward, max abs error of each of dq, dk, dv
# as a share of its max: fp32 differs in summation order only; in bf16 the
# rounded e, do_n and dl may round the other way (one ulp, 2^-8), and an
# element of dq, dk or dv sums hundreds of such terms.
ATTN_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# One fp32 train step, card (TF32 off) vs CPU, with random weights whose
# gradient norm is above 100. Past the last residual max pool (block 14's),
# in block 15, the final norm and the head, each parameter's gradient is
# held within TRAIN_GRAD_TOL_TAIL of its own max |grad| (sums taken in
# other orders). Upstream of it the max pools' argmax flips wherever two
# entries of a window are closer than the forward's fp32 difference (about
# 1e-6), which sends those gradient entries elsewhere: all gradients
# together within TRAIN_GRAD_L2_TOL (relative L2), each parameter within
# TRAIN_GRAD_TOL of its max; the loosest are rel-pos tables, small sums
# over up to 25,089 query rows of terms that cancel.
TRAIN_GRAD_TOL_TAIL = 1e-4
TRAIN_GRAD_L2_TOL = 1e-3
TRAIN_GRAD_TOL = 5e-2
TRAIN_CLIPS = 16  # TRAIN.BATCH_SIZE 8 x AUG.NUM_SAMPLE 2, bench.py's B for MViTv2-S
# The bf16 step pairs are held within twice a run-to-run distance: that of
# two steps whose max pools differ only in the order ATen's backward adds
# (its atomic adds round into bf16 at every add). No such limit may exceed
# twice the distance measured with both steps on ATen's backward, before the
# deterministic backward kernel existed (H100 80GB HBM3, 700 W):
# mvit_train_fused's flash_again and mvit_l_fit's depth-4 plain_again.
ATEN_RUN_TO_RUN = {"mvit_train_fused": 0.004160421499397166,
                   "mvit_l_depth4": 0.0010373952881413382}


def run_to_run_limit(floor, phase):
    """Twice the measured run-to-run ``floor``, at most twice ``ATEN_RUN_TO_RUN``'s."""
    return min(floor, ATEN_RUN_TO_RUN[phase]) * 2 + 1e-6
# The CNN train steps: 16 clips a step on one card (bench.py's B for SlowFast).
CNN_TRAIN_CLIPS = 16
# BN running buffers after one fp32 train step, card vs CPU: each buffer
# within this share of its own max |value| (the step's batch statistics
# enter them with momentum 0.1).
BN_BUFFER_TOL = 1e-4
X3D_YAML = os.path.join(ROOT, "configs", "Kinetics", "X3D_M.yaml")
I3D_NLN_YAML = os.path.join(ROOT, "configs", "Kinetics", "I3D_NLN_8x8_R50.yaml")
PTV_YAML = os.path.join(ROOT, "configs", "Kinetics", "pytorchvideo")
# The recipes of CSN and R(2+1)D leave RESNET.TRANS_FUNC at the bottleneck;
# their transforms are selected by it (slowfast_tpu/models/__init__.py:13).
CSN = (os.path.join(PTV_YAML, "CSN_32x2_R101.yaml"), ["RESNET.TRANS_FUNC", "csn_transform"])
R2PLUS1D = (os.path.join(PTV_YAML, "R2PLUS1D_16x4_R50.yaml"),
            ["RESNET.TRANS_FUNC", "r2plus1d_transform"])
# data_slice's corpus: Kinetics' storage shape at short side 256, 10 s clips.
CORPUS = {"train": 4 * CNN_TRAIN_CLIPS, "val": 2 * CNN_TRAIN_CLIPS, "test": 2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def device_ms(fn, iters=25):
    """Median device time of ``fn`` in ms over ``iters`` runs (CUDA events).
    A sleep kernel ahead of each run keeps the card busy while the host
    enqueues, so the events time the device work and not the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slowfast_cfg(extra, yaml=YAML, out_dir=OUT_DIR):
    """``yaml`` with ``extra``, on one process and one card (``NUM_GPUS 1``,
    ``NUM_SHARDS 1``: the recipes' 8 ranks a host, and Rev-MViT's 16 hosts,
    would need the launcher and as many cards; ``run_net`` sets
    ``NUM_SHARDS`` from ``--num_shards`` as well)."""
    from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(["TRAIN.ENABLE", "False", "NUM_GPUS", "1", "NUM_SHARDS", "1",
                         "OUTPUT_DIR", out_dir] + list(extra))
    return assert_and_infer_cfg(cfg)


def mvit_cfg(extra):
    return slowfast_cfg(["NUM_GPUS", "1"] + list(extra), MVIT_YAML,
                        os.path.join(OUT_DIR, "mvit"))


def reset_launches():
    from slowfast_tpu_torch.ops import attention as ta
    from slowfast_tpu_torch.ops import avg_pool as ap
    from slowfast_tpu_torch.ops import max_pool as mp
    from slowfast_tpu_torch.ops import preprocess as pp
    from slowfast_tpu_torch.ops import roi_align as ra

    ra.launches = ra.bwd_launches = mp.bwd_launches = ap.bwd_launches = 0
    pp.launches = ta.flash_launches = ta.exact_launches = ta.fused_launches = 0
    ta.flash_bwd_launches = ta.exact_bwd_launches = ta.fused_bwd_launches = 0
    ta.flash_tc_launches = ta.exact_tc_launches = ta.fused_tc_launches = 0
    ta.exact_tc_bwd_launches = ta.flash_tc_bwd_launches = ta.fused_tc_bwd_launches = 0


def read_launches():
    from slowfast_tpu_torch.ops import attention as ta
    from slowfast_tpu_torch.ops import avg_pool as ap
    from slowfast_tpu_torch.ops import max_pool as mp
    from slowfast_tpu_torch.ops import preprocess as pp
    from slowfast_tpu_torch.ops import roi_align as ra

    # attention_exact{,_bwd}: the bf16 tensor-core pair (kernel table rows 2
    # and 3); attention_{flash,fused}: the bf16 tensor-core forwards of rows
    # 6 and 4, attention_{flash,fused}_bwd their backwards (rows 7 and 5);
    # *_fma*: the fp32 instances, the FMA kernels.
    return {"preprocess_u8": pp.launches, "roi_align": ra.launches,
            "roi_align_bwd": ra.bwd_launches, "max_pool3d_bwd": mp.bwd_launches,
            "avg_pool3d_bwd": ap.bwd_launches,
            "attention_flash": ta.flash_tc_launches,
            "attention_flash_fma": ta.flash_launches,
            "attention_exact": ta.exact_tc_launches,
            "attention_exact_fma": ta.exact_launches,
            "attention_fused": ta.fused_tc_launches,
            "attention_fused_fma": ta.fused_launches,
            "attention_flash_bwd": ta.flash_tc_bwd_launches,
            "attention_flash_fma_bwd": ta.flash_bwd_launches,
            "attention_exact_bwd": ta.exact_tc_bwd_launches,
            "attention_exact_fma_bwd": ta.exact_bwd_launches,
            "attention_fused_bwd": ta.fused_tc_bwd_launches,
            "attention_fused_fma_bwd": ta.fused_bwd_launches}


# The forward and backward kernels that each core runs in fp32.
FP32_CORE_KEYS = {"flash": ("attention_flash_fma", "attention_flash_fma_bwd"),
                  "exact": ("attention_exact_fma", "attention_exact_fma_bwd")}


# Which kernels the exact core's wrappers launch, by dtype (checked on every
# call in phases attn_kernel and attn_bwd_kernel).
EXACT_PATH = {"bfloat16": "wgmma (tensor cores): csrc/pooled_attention_exact.cu, "
                          "csrc/pooled_attention_exact_bwd.cu",
              "float32": "FMA (CUDA cores): exact modes of csrc/pooled_attention.cu, "
                         "csrc/pooled_attention_bwd.cu"}
# Which kernels the constant-shift forwards launch, by dtype (checked on
# every call in phases attn_kernel and attn_fused_kernel).
FLASH_PATH = {"bfloat16": "wgmma (tensor cores): csrc/pooled_attention_flash.cu "
                          "(flash mode; saved-e mode for the fused core)",
              "float32": "FMA (CUDA cores): csrc/pooled_attention.cu"}
# Which kernels the constant-shift backwards launch, by dtype (checked on
# every call in phases attn_bwd_kernel and attn_fused_kernel).
FLASH_BWD_PATH = {"bfloat16": "wgmma (tensor cores): csrc/pooled_attention_flash_bwd.cu "
                              "(recompute e; read e for the fused core)",
                  "float32": "FMA (CUDA cores): csrc/pooled_attention_bwd.cu, "
                             "csrc/pooled_attention_fused_bwd.cu"}


def only_pool_bwd(launches):
    """No kernel launched but the max-pool backward, which the backward of
    every model with a max pool launches (the SSL pretrains' Slow stems):
    it at least once."""
    return launches["max_pool3d_bwd"] > 0 and not any(
        n for k, n in launches.items() if k != "max_pool3d_bwd")


def only_launched(launches, keys, n):
    """Every attention kernel in ``keys`` launched ``n`` times (any number of
    times if ``n`` is None), every other attention kernel never."""
    return all((key in keys and n is None) or count == (n if key in keys else 0)
               for key, count in launches.items() if key.startswith("attention_"))


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_host_libs():
    """Whether each host library of the data path imports, one line each."""
    import importlib

    for name in ("cv2", "PIL", "sklearn", "tensorboard", "matplotlib"):
        try:
            module = importlib.import_module(name)
        except ImportError as e:
            emit({"host_lib": name, "imports": False, "error": str(e)})
        else:
            emit({"host_lib": name, "imports": True,
                  "version": getattr(module, "__version__", None)})


def ptxas_usage(log):
    """Registers and spill bytes of each kernel in ptxas's ``-v`` report, by
    kernel name with its template arguments."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled = line.rsplit(" ", 1)[-1]
            m = re.match(r"_Z(\d+)", mangled)
            name = mangled
            if m:  # _Z<length><name>[I<template arguments>E], int or bool arguments
                end = m.end() + int(m[1])
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
                vals = [({"0": "false", "1": "true"}[val] if kind == "b" else val)
                        for kind, val in re.findall(r"L([ib])(\d+)E", args[1])] if args else []
                name = mangled[m.end():end] + (f"<{', '.join(vals)}>" if vals else "")
            usage[name] = {}
        elif name and "spill stores" in line:
            usage[name]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line and "registers" in line:
            usage[name]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            name = None
    return usage


def phase_build():
    from slowfast_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    # The tensor-core kernels' resources, as their source notes quote them.
    tc_sources = ("pooled_attention_exact", "pooled_attention_exact_bwd",
                  "pooled_attention_flash", "pooled_attention_flash_bwd")
    logs = {name: _build.log_path(name).read_text(errors="replace") for name in tc_sources}
    ptxas = {name: ptxas_usage(log) for name, log in logs.items()}
    # C7514: ptxas serialized wgmma groups it could not follow.
    serialized = {name: log.count("C7514") for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(libs),
          "ptxas": ptxas, "wgmma_serialized": serialized})


def phase_kernel():
    """Preprocess kernel vs its plain version; bit-equal is expected (the
    kernel rounds as the plain version does), 1 ulp is the stated limit."""
    from slowfast_tpu_torch.ops import preprocess as pp

    mean, std = [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]
    scale, bias = pp.scale_bias(mean, std)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((8, 32, 256, 256, 3), 8), ((3, 10, 17, 13, 3), 4)]
    max_err, max_ulp, n_checked = 0.0, 0, 0
    for shape, alpha in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        idx = pp.slow_index(shape[1], alpha)
        for dtype in (torch.bfloat16, torch.float32):
            for reverse in (False, True):
                for flip in (False, True):
                    flips = (np.arange(shape[0]) % 2 == 1) if flip else None
                    got = pp.device_preprocess(x, mean, std, flips=flips, alpha=alpha,
                                               out_dtype=dtype, reverse_channels=reverse)
                    fl = None if flips is None else torch.as_tensor(flips, device="cuda")
                    want = pp.preprocess_plain(x, scale, bias, fl, idx, dtype, reverse)
                    for g, w in zip(got, want):
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
                        int_t = torch.int16 if dtype == torch.bfloat16 else torch.int32
                        ulp = (g.view(int_t).long() - w.view(int_t).long()).abs().max().item()
                        err = (g.float() - w.float()).abs().max().item()
                        max_ulp, max_err = max(max_ulp, ulp), max(max_err, err)
                        n_checked += 1
    check(max_ulp <= 1, f"preprocess kernel differs from plain by {max_ulp} ulps")

    # Time the main path's call: B=8, T=32, 256^2, bf16, both pathways.
    shape, alpha = cases[0]
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    idx = pp.slow_index(shape[1], alpha)
    kernel_ms = device_ms(lambda: pp.device_preprocess(x, mean, std, alpha=alpha))
    plain_ms = device_ms(
        lambda: pp.preprocess_plain(x, scale, bias, None, idx, torch.bfloat16, False))
    n = x.numel()
    out_elems = n + n * len(idx) // shape[1]
    nbytes = n + 2 * out_elems  # u8 in once, bf16 fast + slow out once
    flops = 2 * out_elems  # multiply + add per output element
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    row = {"phase": "kernel", "name": "preprocess_u8", "cases_checked": n_checked,
           "max_abs_err": max_err, "max_ulp": max_ulp, "shape": list(shape),
           "alpha": alpha, "dtype": "bfloat16", "ms": kernel_ms, "plain_ms": plain_ms,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_rate": "H100 SXM 3.35 TB/s", "roofline_share": bound_ms / kernel_ms}
    emit(row)
    return row


def randomize_bn(model, seed):
    """Seeded BN parameters and statistics, so no residual branch is zero."""
    from slowfast_tpu_torch.models.batchnorm import BatchNorm3D

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm3D):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


def temper_head(model, clip, cfg, logit_std=2.0):
    """Scale the projection so the logits of ``clip`` have std ``logit_std``.
    With random weights at full depth SlowFast's logits saturate the softmax
    and MViT's (head init std 0.02) leave it near uniform; either way the
    comparison would pass whatever the error."""
    from slowfast_tpu_torch.engine.steps import make_eval_step

    feats = []
    hook = model.head.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    try:
        make_eval_step(cfg, model)({"inputs": [torch.as_tensor(clip)]})
    finally:
        hook.remove()
    if isinstance(feats[0], torch.Tensor):  # MViT: the (B, C) cls row
        pooled = feats[0].float()
    else:  # SlowFast: per-pathway NTHWC maps, pooled and concatenated
        pooled = torch.cat([x.float().mean(dim=(1, 2, 3)) for x in feats[0]], dim=-1)
    proj = model.head.projection
    with torch.no_grad():
        std = torch.nn.functional.linear(pooled, proj.weight, proj.bias).std().item()
        proj.weight.mul_(logit_std / std)
        proj.bias.mul_(logit_std / std)


def phase_fp32():
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    cpu_model = build_model(cfg, device="cpu")
    randomize_bn(cpu_model, 1)
    clip = np.random.RandomState(2).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8)
    temper_head(cpu_model, clip, cfg)
    gpu_model = build_model(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    want = make_eval_step(cfg, cpu_model)({"inputs": [torch.from_numpy(clip)]})
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_eval_step(cfg, gpu_model)({"inputs": [torch.from_numpy(clip).cuda()]})
        got = got.cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = (got - want).abs().max().item()
    check(got.shape == (1, cfg.MODEL.NUM_CLASSES) and torch.isfinite(got).all().item(),
          f"bad output {got.shape}")
    check(want.max().item() < 0.5, f"saturated softmax {want.max().item()}")
    check(err <= FULL_WIDTH_ATOL, f"card vs CPU softmax max abs err {err}")
    emit({"phase": "fp32", "max_abs_err": err, "atol": FULL_WIDTH_ATOL,
          "max_rel_err": ((got - want).abs() / want).max().item(),
          "argmax_equal": bool(got.argmax() == want.argmax()),
          "max_prob": want.max().item(), "crop": cfg.DATA.TEST_CROP_SIZE,
          "frames": cfg.DATA.NUM_FRAMES})


def drive_test(phase, make_cfg, out_dir, num_videos):
    """``engine.tester.test`` on the card in bf16 on synthetic video, with
    every kernel count set to 0 just before and read just after. Checks the
    predictions, the log and the batch count; returns (row, launches)."""
    from slowfast_tpu_torch.engine import tester

    os.makedirs(out_dir, exist_ok=True)
    stats_log = os.path.join(out_dir, "json_stats.log")
    results = os.path.join(out_dir, "results.pkl")
    for path in (stats_log, results):
        if os.path.exists(path):
            os.remove(path)
    cfg = make_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "syntheticvideo",
                    "DATA.SYNTHETIC_SIZE", str(num_videos), "TEST.BATCH_SIZE", "8",
                    "TEST.SAVE_RESULTS_PATH", results])
    per_view = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_clips = num_videos * per_view
    num_batches = -(-num_clips // cfg.TEST.BATCH_SIZE)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    (stats,) = tester.test(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()

    with open(results, "rb") as f:
        video_preds, _ = pickle.load(f)
    row_sums = video_preds.sum(axis=1) / per_view
    with open(stats_log) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    iters = [float(s["time_diff"]) for s in logged if s["_type"] == "test_iter"]
    check(np.isfinite(video_preds).all() and (video_preds >= 0).all(), "bad predictions")
    check(np.abs(row_sums - 1.0).max() < 1e-2, f"softmax rows do not sum to 1: {row_sums}")
    check(logged[-1]["_type"] == "test_final" and logged[-1] == stats, "no test_final")
    check(len(iters) == num_batches, f"{len(iters)} iterations, expected {num_batches}")
    check(launches["preprocess_u8"] == num_batches,
          f"preprocess kernel launched {launches['preprocess_u8']} times for "
          f"{num_batches} batches")
    row = {"phase": phase, "clips": num_clips, "batches": num_batches,
           "batch_size": cfg.TEST.BATCH_SIZE, "crop": cfg.DATA.TEST_CROP_SIZE,
           "frames": cfg.DATA.NUM_FRAMES, "dtype": "bfloat16",
           "eval_clips_per_s": num_clips / sum(iters),
           "p50_batch_ms": statistics.median(iters) * 1e3,
           "p50_clips_per_s": cfg.TEST.BATCH_SIZE / statistics.median(iters),
           "first_batch_ms": iters[0] * 1e3, "test_wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "row_sum_max_dev": float(np.abs(row_sums - 1.0).max()),
           "top1_acc": stats["top1_acc"], "top5_acc": stats["top5_acc"],
           "launches": launches}
    return row, launches


def phase_slice():
    """SlowFast 4x16 R50: 2 videos x 10 views x 3 crops."""
    row, launches = drive_test("slice", slowfast_cfg, OUT_DIR, 2)
    check(only_launched(launches, (), 0), f"SlowFast launched an attention kernel: {launches}")
    emit(row)
    return launches


def phase_mvit_slice():
    """MViTv2-S 16x4: 4 videos x 5 views x 1 crop, 3 batches of 8 (the last
    one ragged). Every block runs the constant-shift attention kernel."""
    row, launches = drive_test("mvit_slice", mvit_cfg, os.path.join(OUT_DIR, "mvit"), 4)
    depth = mvit_cfg([]).MVIT.DEPTH
    check(only_launched(launches, ("attention_flash",), depth * row["batches"]),
          f"attention kernels launched {launches} for {row['batches']} batches of {depth} "
          f"blocks: the tensor-core flash forward alone, once a block")
    emit(row)
    return launches


def roofline(flops, nbytes, dtype):
    """The least time the card could take: ``flops`` over the peak rate for
    ``dtype`` or ``nbytes`` over the memory rate, whichever is larger."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "bytes": nbytes}


def attention_sizes(q, k, v):
    """``P = B nh Nq Nk`` and the elements of q, k and v together and of the
    output."""
    B, Nq, nh, _ = q.shape
    return B * nh * Nq * k.shape[1], q.numel() + k.numel() + v.numel(), B * Nq * nh * v.shape[3]


def attention_bound(q, k, v):
    """The least time one pooled-attention call could take on the card: its
    operations (2 per multiply-add of q kᵀ and p v), or q, k, v and the
    output moved once; the exponentials over the ex2 rate beside it."""
    P, qkv, o = attention_sizes(q, k, v)
    bound = roofline(2 * P * (q.shape[3] + v.shape[3]), (qkv + o) * q.element_size(), q.dtype)
    return {**bound, "exp_bound_ms": P / EXP_PER_S * 1e3}


def sdpa_yardsticks(q, k, v, do=None, iters=25):
    """Device ms of SDPA (scale 1.0, heads-first layout) computing the same
    function as the pooled-attention core: the forward, or with ``do`` the
    backward by ``autograd.grad``. ``library``: on these inputs, where SDPA
    picks its MATH backend (dq is not a multiple of 8). ``library_fast``: on
    q and k zero-padded to a multiple of 8 channels (the same logits), where
    it picks a fused backend; the padding is outside the timing. Each with
    the backend's name."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    row = {}
    for key, pad in (("library", 0), ("library_fast", -q.shape[3] % 8)):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        qt, kt = (F.pad(t, (0, pad)) for t in (qt, kt))
        if do is not None:
            qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        row[f"{key}_backend"] = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, scale=1.0)).name
        if do is None:
            row[f"{key}_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0), iters)
        else:
            out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
            do_t = do.transpose(1, 2).contiguous()
            row[f"{key}_ms"] = device_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), do_t, retain_graph=True), iters)
            del out
    return row


def attention_inputs(shape, dtype, seed, extreme=False):
    """Seeded q, k, v of ``shape`` (B, Nq, Nk, nh, dq, dv) on the card. With
    ``extreme``, q rows 0-2 put every logit above the clamp at 50 and rows
    3-5 make every exp(l - 20) underflow; with ``extreme="subnormal"``
    every logit lies near -69.5, so every e = exp(l - 20) is a subnormal
    bf16 number (and s is the clamp's 1e-30)."""
    B, Nq, Nk, nh, dq, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Nq, nh, dq), device="cuda", generator=gen) * 0.6
    k = torch.randn((B, Nk, nh, dq), device="cuda", generator=gen) * 0.6
    v = torch.randn((B, Nk, nh, dv), device="cuda", generator=gen)
    if extreme == "subnormal":
        q, k = q * 0.05, k * 0.05
        k[..., 0] = 1.0
        q[..., 0] = -69.5
    elif extreme:
        k[..., 0] = 1.0 + torch.rand(k[..., 0].shape, device="cuda", generator=gen)
        q[:, 0:3, :, 0] = 100.0
        q[:, 3:6, :, 0] = -200.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def edge_cases(max_dq):
    """Small (shape, dtype, extreme) cases that reach every edge of the
    kernels' 64 x 64 tiling: Nk under one chunk, Nk = 64 j + 1, Nq = 1,
    depths 20/24 and 12/16 (padded to 32 and 16 by the tensor-core
    kernels), an odd depth (2-byte copies), and extreme logits where Nq
    allows; then ``template_cases(max_dq)``."""
    shapes = [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12), (1, 1, 65, 3, 20, 12),
              (2, 100, 129, 1, 21, 12)]
    cases = [(shape, dtype, extreme) for shape in shapes
             for dtype in (torch.float32, torch.bfloat16)
             for extreme in (False, True) if shape[1] >= 6 or not extreme]
    return cases + template_cases(max_dq)


def template_cases(max_dq):
    """One bf16 case for each template instance of the tensor-core kernels:
    dq padded to 32, 128, 144, 192 and 256 (up to ``max_dq``, the entry
    point's limit) against dv padded to 16, 64, 96 and 128."""
    return [((1, 129, 65, 1, dq, dv), torch.bfloat16, False)
            for dq in (20, 118, 132, 192, 256) if dq <= max_dq for dv in (12, 64, 96, 128)]


# Every e of these a subnormal bf16 number: the tensor cores must take them
# as the plain version does.
SUBNORMAL_CASES = [((1, 70, 200, 2, 20, 12), dtype, "subnormal")
                   for dtype in (torch.float32, torch.bfloat16)]


def capture_mvit_attention(batch_size, steps=6):
    """The (q, k, v) that each block of one full-width MViTv2-S 16x4 eval
    step (bf16, seeded random weights and clips) hands its attention core,
    and the eval step's own time on a batch already on the card (median
    host time of ``steps`` runs after one warm-up, each ending in a
    synchronize)."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import attention as ta

    cfg = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cuda")
    step = make_eval_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(4)
    size = (batch_size, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE,
            cfg.DATA.TEST_CROP_SIZE, 3)
    batch = {"inputs": [torch.randint(0, 256, size, dtype=torch.uint8, device="cuda",
                                      generator=gen)]}
    captured, core = [], ta.flash_pooled_attention

    def recording_core(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return core(q, k, v)

    ta.flash_pooled_attention = recording_core
    try:
        step(batch)
    finally:
        ta.flash_pooled_attention = core
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check(len(captured) == cfg.MVIT.DEPTH, f"captured {len(captured)} attention calls")
    return captured, statistics.median(step_s) * 1e3


def phase_attn_kernel():
    """Both attention kernels against their plain versions, and their times
    at each distinct block shape of MViTv2-S at B=8 in bf16."""
    from slowfast_tpu_torch.ops import attention as ta

    kernels = {"flash": (ta.flash_pooled_attention, ta.flash_plain),
               "exact": (ta.pooled_attention, ta.exact_plain)}
    counters = {"flash": ("flash_tc_launches", "flash_launches"),
                "exact": ("exact_tc_launches", "exact_launches")}
    max_err = {name: 0.0 for name in kernels}
    n_bit_equal = {name: 0 for name in kernels}
    fp32_err = {}
    n_checked = 0

    def compare(name, q, k, v):
        """The kernel against its plain version; returns (output, max abs err)."""
        nonlocal n_checked
        fn, plain = kernels[name]
        before = [getattr(ta, c) for c in counters[name]]
        got, want = fn(q, k, v), plain(q, k, v)
        # bf16 on the tensor cores, fp32 on the FMA kernel
        tc = q.dtype == torch.bfloat16
        check([getattr(ta, c) - n for c, n in zip(counters[name], before)]
              == [int(tc), int(not tc)], f"{name} {q.dtype}: wrong kernel launched")
        if tc:  # deterministic: a second launch gives the same bits
            check(torch.equal(got, fn(q, k, v)),
                  f"{name} forward differs between two launches at q {tuple(q.shape)}")
            n_bit_equal[name] += 1
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        vmax = v.float().abs().max().item()
        check(err <= ATTN_TOL[q.dtype] * vmax,
              f"{name} kernel differs from plain by {err} (max |v| {vmax}) at "
              f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
        max_err[name] = max(max_err[name], err)
        n_checked += 1
        return got, err

    batch_size = 8
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    try:
        with torch.inference_mode():
            captured, step_ms = capture_mvit_attention(batch_size)
            block_err = [{name: compare(name, q, k, v)[1] for name in kernels}
                         for q, k, v in captured]
            block1 = [t[:1].float().contiguous() for t in captured[1]]
            for name in kernels:
                fp32_err[name] = compare(name, *block1)[1]
            for shape, dtype, extreme in edge_cases(ta._MAX_DQ) + SUBNORMAL_CASES:
                q, k, v = attention_inputs(shape, dtype, 5, extreme)
                for name in kernels:
                    got, _ = compare(name, q, k, v)
                    if extreme is True and name == "flash":
                        check(got[:, 3:6].abs().max().item() == 0.0,
                              "underflowing rows are not zero")
                    if extreme == "subnormal" and name == "flash":
                        # the case tests something only if every e is subnormal
                        e = ta.fused_plain(q, k, v)[1].float()
                        check(0.0 < e.min().item() and e.max().item() < 2.0 ** -126
                              and got.abs().max().item() > 0.0,
                              f"subnormal case: e in [{e.min().item()}, {e.max().item()}], "
                              f"output max {got.abs().max().item()}")

            totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                                 library_fast_ms=0.0) for name in kernels}
            bound_split = {"operations": 0.0, "bytes": 0.0}  # summed bound, by kind
            for blocks in group_blocks(captured):
                q, k, v = captured[blocks[0]]
                sdpa = sdpa_yardsticks(q, k, v)
                bound = attention_bound(q, k, v)
                bound_split[bound["bound_by"]] += len(blocks) * bound["bound_ms"]
                row = {"phase": "attn_kernel", "blocks": blocks, "B": q.shape[0],
                       "Nq": q.shape[1], "Nk": k.shape[1], "nh": q.shape[2],
                       "dq": q.shape[3], "dv": v.shape[3], "dtype": "bfloat16", **bound,
                       **sdpa}
                for name, (fn, plain) in kernels.items():
                    ms = device_ms(lambda: fn(q, k, v))
                    plain_ms = device_ms(lambda: plain(q, k, v))
                    row[name] = {"ms": ms, "plain_ms": plain_ms,
                                 "roofline_share": bound["bound_ms"] / ms,
                                 "max_abs_err": max(block_err[i][name] for i in blocks)}
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("bound_ms", bound["bound_ms"]),
                                     ("library_ms", sdpa["library_ms"]),
                                     ("library_fast_ms", sdpa["library_fast_ms"])):
                        totals[name][key] += len(blocks) * val
                emit(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    summary = {"phase": "attn_kernel", "batch_size": batch_size, "cases_checked": n_checked,
               "max_abs_err": max_err, "fp32_block1_max_abs_err": fp32_err,
               "tolerance_of_max_abs_v": {"float32": ATTN_TOL[torch.float32],
                                          "bfloat16": ATTN_TOL[torch.bfloat16]},
               "exact_path": EXACT_PATH, "flash_path": FLASH_PATH,
               "flash_bf16_bit_equal_relaunches": n_bit_equal["flash"],
               "exact_bf16_bit_equal_relaunches": n_bit_equal["exact"],
               "flash_ms_over_exact_ms": totals["flash"]["ms"] / totals["exact"]["ms"],
               "per_forward": totals, "bound_split_ms": bound_split,
               "bound_by": max(bound_split, key=bound_split.get),
               "mvit_eval_step_p50_ms": step_ms,
               "flash_share_of_step": totals["flash"]["ms"] / step_ms}
    emit(summary)
    return summary


def phase_mvit_fp32():
    """Full-width MViTv2-S, one clip, on the card against the CPU on the same
    weights, fp32 with TF32 off, with each attention core. The head is
    tempered first, so the softmax is neither uniform nor saturated."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32"]
    cfg = mvit_cfg(base)
    cpu_model = build_model(cfg, device="cpu")
    clip = np.random.RandomState(3).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8)
    temper_head(cpu_model, clip, cfg)
    state = cpu_model.state_dict()
    num_classes = cfg.MODEL.NUM_CLASSES
    launches = {}
    for core, extra in (("flash", []), ("exact", ["TPU.PALLAS_ATTENTION", "True"])):
        cfg = mvit_cfg(base + extra)
        models = {}
        for device in ("cpu", "cuda"):
            models[device] = build_model(cfg, device=device)
            models[device].load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        want = make_eval_step(cfg, models["cpu"])({"inputs": [torch.from_numpy(clip)]})
        cpu_s = time.perf_counter() - t0
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            reset_launches()
            got = make_eval_step(cfg, models["cuda"])(
                {"inputs": [torch.from_numpy(clip).cuda()]})
            torch.cuda.synchronize()
            launches[core] = read_launches()
            got = got.cpu()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        err = (got - want).abs().max().item()
        check(got.shape == (1, num_classes) and torch.isfinite(got).all().item(),
              f"bad output {got.shape}")
        check(2.0 / num_classes < want.max().item() < 0.5,
              f"softmax max {want.max().item()} outside (2/{num_classes}, 0.5)")
        check(err <= FULL_WIDTH_ATOL, f"{core}: card vs CPU softmax max abs err {err}")
        check(bool(got.argmax() == want.argmax()), f"{core}: argmax differs")
        check(only_launched(launches[core], FP32_CORE_KEYS[core][:1], cfg.MVIT.DEPTH)
              and launches[core]["preprocess_u8"] == 1,
              f"{core}: launches {launches[core]}")
        emit({"phase": "mvit_fp32", "core": core, "max_abs_err": err,
              "atol": FULL_WIDTH_ATOL,
              "max_rel_err": ((got - want).abs() / want).max().item(),
              "argmax_equal": True, "max_prob": want.max().item(),
              "crop": cfg.DATA.TEST_CROP_SIZE, "frames": cfg.DATA.NUM_FRAMES,
              "cpu_forward_s": cpu_s, "launches": launches[core]})
    return launches


def attention_bwd_bound(q, k, v):
    """The least time one pooled-attention backward could take on the card:
    2 P (3 dq + 2 dv) operations (the logits once, dpn, dv, dq, dk), or q,
    k, v, do, dq, dk and dv moved once."""
    P, qkv, o = attention_sizes(q, k, v)
    return roofline(2 * P * (3 * q.shape[3] + 2 * v.shape[3]),
                    (2 * qkv + o) * q.element_size(), q.dtype)


def fused_bounds(q, k, v):
    """The least times of the saved-e pair. Forward: 2 P (dq + dv)
    operations, or q, k, v and the output moved once and e (P elements)
    written. Backward: 2 P (2 dq + 2 dv) operations (dv, dpn, dq, dk; no
    logits), or q, k, v, do, dq, dk and dv moved once and e read."""
    P, qkv, o = attention_sizes(q, k, v)
    dq, dv, size = q.shape[3], v.shape[3], q.element_size()
    return (roofline(2 * P * (dq + dv), (qkv + o + P) * size, q.dtype),
            roofline(2 * P * (2 * dq + 2 * dv), (2 * qkv + o + P) * size, q.dtype))


def capture_mvit_train_attention(num_clips):
    """The (q, k, v) that each block of one full-width MViTv2-S 16x4 train
    forward (bf16, seeded random weights and clips, drop path and dropout
    on) hands its attention core."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import attention as ta

    cfg = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cuda")
    model.train()
    gen = torch.Generator(device="cuda").manual_seed(6)
    size = (num_clips, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
            cfg.DATA.TRAIN_CROP_SIZE, 3)
    clips = torch.randint(0, 256, size, dtype=torch.uint8, device="cuda", generator=gen)
    captured, core = [], ta.flash_pooled_attention

    def recording_core(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return core(q, k, v)

    ta.flash_pooled_attention = recording_core
    try:
        with torch.no_grad():
            model(maybe_device_preprocess(cfg, [clips]))
    finally:
        ta.flash_pooled_attention = core
    check(len(captured) == cfg.MVIT.DEPTH, f"captured {len(captured)} attention calls")
    return captured


def grad_out(q, v, seed):
    """A seeded output gradient for the core's output, in v's dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (q.shape[0], q.shape[1], q.shape[2], v.shape[3])
    return torch.randn(shape, device="cuda", generator=gen).to(v.dtype)


def group_blocks(captured):
    """Block indices by distinct (q shape, Nk, dv)."""
    groups = {}
    for i, (q, k, v) in enumerate(captured):
        groups.setdefault((tuple(q.shape), k.shape[1], v.shape[3]), []).append(i)
    return list(groups.values())


def phase_attn_bwd_kernel():
    """Both backward kernels against their plain backwards, and their times
    at each distinct block shape of the MViTv2-S train step at 16 clips."""
    from slowfast_tpu_torch.ops import attention as ta

    plains = {"flash": ta.flash_bwd_plain, "exact": ta.exact_bwd_plain}
    wrappers = {"flash": ta.flash_pooled_attention, "exact": ta.pooled_attention}
    max_abs = {name: 0.0 for name in plains}
    max_share = {name: 0.0 for name in plains}
    n_checked = 0
    n_bit_equal = {name: 0 for name in plains}
    counters = {"flash": ("flash_tc_bwd_launches", "flash_bwd_launches"),
                "exact": ("exact_tc_bwd_launches", "exact_bwd_launches")}

    def compare(name, q, k, v, do):
        """The kernel against its plain backward; returns the three grads and
        the largest error share of dq, dk, dv."""
        nonlocal n_checked
        before = [getattr(ta, c) for c in counters[name]]
        got = ta._launch_bwd(q, k, v, do, exact=name == "exact")
        # bf16 on the tensor cores, fp32 on the FMA kernels
        tc = q.dtype == torch.bfloat16
        check([getattr(ta, c) - n for c, n in zip(counters[name], before)]
              == [int(tc), int(not tc)], f"{name} {q.dtype}: wrong backward launched")
        if tc:  # deterministic: a second launch gives the same bits
            again = ta._launch_bwd(q, k, v, do, exact=name == "exact")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} backward differs between two launches at q {tuple(q.shape)}")
            n_bit_equal[name] += 1
        want = plains[name](q, k, v, do)
        shares = []
        for g, w, t in zip(got, want, (q, k, v)):
            check(g.shape == t.shape and g.dtype == t.dtype, f"{name}: grad {g.shape} {g.dtype}")
            check(torch.isfinite(g).all().item(), f"{name}: non-finite gradient")
            err = (g.float() - w.float()).abs().max().item()
            scale = max(w.float().abs().max().item(), 1e-30)
            shares.append(err / scale)
            max_abs[name] = max(max_abs[name], err)
        check(max(shares) <= ATTN_BWD_TOL[q.dtype],
              f"{name} backward differs from plain by {shares} of max at q "
              f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
        max_share[name] = max(max_share[name], max(shares))
        n_checked += 1
        return got, max(shares)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    try:
        captured = capture_mvit_train_attention(TRAIN_CLIPS)
        dos = [grad_out(q, v, 100 + i) for i, (q, k, v) in enumerate(captured)]
        block_err = [{name: compare(name, q, k, v, do)[1] for name in plains}
                     for (q, k, v), do in zip(captured, dos)]
        block1 = [t[:1].float().contiguous() for t in captured[1]]
        fp32_err = {name: compare(name, *block1, grad_out(block1[0], block1[2], 7))[1]
                    for name in plains}
        extreme_zero = True
        for shape, dtype, extreme in edge_cases(ta._MAX_DQ_BWD) + SUBNORMAL_CASES:
            q, k, v = attention_inputs(shape, dtype, 5, extreme)
            do = grad_out(q, v, 8)
            (dq, _, dv), _ = compare("flash", q, k, v, do)
            compare("exact", q, k, v, do)
            if extreme is True:
                extreme_zero &= dq[:, 3:6].abs().max().item() == 0.0
            if extreme == "subnormal":  # the case tests something only if every e is subnormal
                e = ta.fused_plain(q, k, v)[1].float()
                check(0.0 < e.min().item() and e.max().item() < 2.0 ** -126
                      and dv.abs().max().item() > 0.0,
                      f"subnormal case: e in [{e.min().item()}, {e.max().item()}], "
                      f"dv max {dv.abs().max().item()}")
        check(extreme_zero, "underflowing rows have a nonzero dq")

        # The wrappers on the card: an output with a grad_fn whose gradients
        # are the backward kernel's, one launch each.
        q, k, v = (t[:2].clone().requires_grad_() for t in captured[2])
        do = dos[2][:2].contiguous()
        autograd_launches = {}
        for name, fn in wrappers.items():
            reset_launches()
            out = fn(q, k, v)
            check(out.grad_fn is not None, f"{name}: the output has no grad_fn")
            grads = torch.autograd.grad(out, (q, k, v), do)
            want = ta._launch_bwd(q.detach(), k.detach(), v.detach(), do, exact=name == "exact")
            check(all(torch.equal(g, w) for g, w in zip(grads, want)),
                  f"{name}: autograd on the card is not the backward kernel")
            autograd_launches[name] = read_launches()
            check(autograd_launches[name][f"attention_{name}_bwd"] == 2,
                  f"{name}: launches {autograd_launches[name]}")

        totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                             library_fast_ms=0.0) for name in plains}
        for blocks in group_blocks(captured):
            q, k, v = captured[blocks[0]]
            do = dos[blocks[0]]
            sdpa = sdpa_yardsticks(q, k, v, do, 10)
            bound = attention_bwd_bound(q, k, v)
            row = {"phase": "attn_bwd_kernel", "blocks": blocks, "B": q.shape[0],
                   "Nq": q.shape[1], "Nk": k.shape[1], "nh": q.shape[2], "dq": q.shape[3],
                   "dv": v.shape[3], "dtype": "bfloat16", **bound, **sdpa}
            for name in plains:
                exact = name == "exact"
                ms = device_ms(lambda: ta._launch_bwd(q, k, v, do, exact), 10)
                plain_ms = device_ms(lambda: plains[name](q, k, v, do), 5)
                row[name] = {"ms": ms, "plain_ms": plain_ms,
                             "roofline_share": bound["bound_ms"] / ms,
                             "max_err_share": max(block_err[i][name] for i in blocks)}
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound["bound_ms"]),
                                 ("library_ms", sdpa["library_ms"]),
                                 ("library_fast_ms", sdpa["library_fast_ms"])):
                    totals[name][key] += len(blocks) * val
            emit(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    summary = {"phase": "attn_bwd_kernel", "clips": TRAIN_CLIPS, "cases_checked": n_checked,
               "exact_bf16_bit_equal_relaunches": n_bit_equal["exact"],
               "flash_bf16_bit_equal_relaunches": n_bit_equal["flash"], "exact_path": EXACT_PATH,
               "flash_path": FLASH_BWD_PATH,
               "max_abs_err": max_abs, "max_err_share": max_share,
               "fp32_block1_err_share": fp32_err,
               "tolerance_share": {"float32": ATTN_BWD_TOL[torch.float32],
                                   "bfloat16": ATTN_BWD_TOL[torch.bfloat16]},
               "per_backward": totals, "bound_by": "operations",
               "autograd_launches": autograd_launches}
    emit(summary)
    return summary


def phase_attn_fused_kernel():
    """The saved-e pair against its plain versions and against the flash
    kernels, and the times of both pairs at each distinct block shape of
    the MViTv2-S train step at 16 clips."""
    from slowfast_tpu_torch.ops import attention as ta

    max_abs = {"out": 0.0, "e": 0.0, "grads": 0.0, "grads_vs_flash": 0.0}
    max_share = {"out": 0.0, "e": 0.0, "grads": 0.0, "grads_vs_flash": 0.0}
    n_checked = n_bit_equal = n_fwd_bit_equal = 0
    # The kernel's e against fused_plain's: elements compared, elements that
    # differ, and the largest difference in ulps (bf16 cases).
    e_diff = {"elements": 0, "differ": 0, "max_ulp": 0}

    def check_forward(q, k, v):
        """The saved-e forward against fused_plain and the flash forward
        kernel; returns (out, e)."""
        nonlocal n_fwd_bit_equal
        before = (ta.fused_tc_launches, ta.fused_launches)
        out, e = ta._launch_fused(q, k, v)
        # bf16 on the tensor cores, fp32 on the FMA kernel
        tc = q.dtype == torch.bfloat16
        check((ta.fused_tc_launches - before[0], ta.fused_launches - before[1])
              == (int(tc), int(not tc)), f"fused {q.dtype}: wrong forward launched")
        want_out, want_e = ta.fused_plain(q, k, v)
        check(out.shape == want_out.shape and out.dtype == want_out.dtype
              and e.shape == want_e.shape and e.dtype == want_e.dtype,
              f"fused: out {out.shape} {out.dtype}, e {e.shape} {e.dtype}")
        check(torch.isfinite(out).all().item() and torch.isfinite(e).all().item(),
              "fused: non-finite output or e")
        tol = ATTN_TOL[q.dtype]
        where = f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}"
        share = note("out", (out.float() - want_out.float()).abs().max().item(),
                     v.float().abs().max().item())
        check(share <= tol, f"fused forward differs from plain by {share} of max |v| at {where}")
        share = note("e", (e.float() - want_e.float()).abs().max().item(),
                     want_e.float().abs().max().item())
        check(share <= tol, f"fused e differs from plain by {share} of its max at {where}")
        check(torch.equal(out, ta._launch(q, k, v, exact=False)),
              f"fused forward is not bit-equal to the flash forward at {where}")
        if tc:
            again = ta._launch_fused(q, k, v)
            check(torch.equal(out, again[0]) and torch.equal(e, again[1]),
                  f"fused forward differs between two launches at {where}")
            n_fwd_bit_equal += 1
            ulps = (e.view(torch.int16).int() - want_e.view(torch.int16).int()).abs()
            e_diff["elements"] += ulps.numel()
            e_diff["differ"] += int(torch.count_nonzero(ulps).item())
            e_diff["max_ulp"] = max(e_diff["max_ulp"], int(ulps.max().item()))
        return out, e

    def note(key, err, scale):
        max_abs[key] = max(max_abs[key], err)
        max_share[key] = max(max_share[key], err / max(scale, 1e-30))
        return err / max(scale, 1e-30)

    def compare(q, k, v, do):
        """The pair against its plain versions (on the kernel's own e) and
        against the flash kernels; returns (out, grads, largest gradient
        error share against the plain backward)."""
        nonlocal n_checked, n_bit_equal
        out, e = check_forward(q, k, v)
        where = f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}"
        before = (ta.fused_tc_bwd_launches, ta.fused_bwd_launches)
        grads = ta._launch_fused_bwd(q, k, v, do, e)
        # bf16 on the tensor cores, fp32 on the FMA kernel
        tc = q.dtype == torch.bfloat16
        check((ta.fused_tc_bwd_launches - before[0], ta.fused_bwd_launches - before[1])
              == (int(tc), int(not tc)), f"fused {q.dtype}: wrong backward launched")
        if tc:  # deterministic: a second launch gives the same bits
            again = ta._launch_fused_bwd(q, k, v, do, e)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"fused backward differs between two launches at {where}")
            n_bit_equal += 1
        want = ta.fused_bwd_plain(q, k, v, do, e)
        flash = ta._launch_bwd(q, k, v, do, exact=False)
        shares = []
        for g, w, f, t in zip(grads, want, flash, (q, k, v)):
            check(g.shape == t.shape and g.dtype == t.dtype, f"fused: grad {g.shape} {g.dtype}")
            check(torch.isfinite(g).all().item(), "fused: non-finite gradient")
            scale = w.float().abs().max().item()
            shares.append(note("grads", (g.float() - w.float()).abs().max().item(), scale))
            vs_flash = note("grads_vs_flash", (g.float() - f.float()).abs().max().item(), scale)
            check(vs_flash <= ATTN_BWD_TOL[q.dtype],
                  f"fused backward differs from the flash backward by {vs_flash} at {where}")
        check(max(shares) <= ATTN_BWD_TOL[q.dtype],
              f"fused backward differs from plain by {shares} of max at {where}")
        n_checked += 1
        return out, grads, max(shares)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    try:
        captured = capture_mvit_train_attention(TRAIN_CLIPS)
        dos = [grad_out(q, v, 100 + i) for i, (q, k, v) in enumerate(captured)]
        block_err = [compare(q, k, v, do)[2] for (q, k, v), do in zip(captured, dos)]
        block1 = [t[:1].float().contiguous() for t in captured[1]]
        fp32_err = compare(*block1, grad_out(block1[0], block1[2], 7))[2]
        extreme_zero = True
        cases = [(shape, dtype, extreme)
                 for shape in [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12)]
                 for dtype in (torch.float32, torch.bfloat16) for extreme in (False, True)]
        for shape, dtype, extreme in (cases + template_cases(ta._MAX_DQ_BWD)
                                      + SUBNORMAL_CASES):
            q, k, v = attention_inputs(shape, dtype, 5, extreme)
            out, (dq, _, _), _ = compare(q, k, v, grad_out(q, v, 8))
            if extreme is True:
                extreme_zero &= out[:, 3:6].abs().max().item() == 0.0
                extreme_zero &= dq[:, 3:6].abs().max().item() == 0.0
        check(extreme_zero, "underflowing rows have a nonzero output or dq")
        # The forward's template instances past the backward's depth limit
        for shape, dtype, extreme in template_cases(ta._MAX_DQ):
            if shape[4] > ta._MAX_DQ_BWD:
                check_forward(*attention_inputs(shape, dtype, 5, extreme))

        # The wrapper on the card: an output with a grad_fn whose gradients
        # are the backward kernel's, one launch of each kernel.
        q, k, v = (t[:2].clone().requires_grad_() for t in captured[2])
        do = dos[2][:2].contiguous()
        reset_launches()
        out = ta.fused_pooled_attention(q, k, v)
        check(out.grad_fn is not None, "fused: the output has no grad_fn")
        grads = torch.autograd.grad(out, (q, k, v), do)
        autograd_launches = read_launches()
        check(autograd_launches["attention_fused"] == autograd_launches["attention_fused_bwd"]
              == 1 and autograd_launches["attention_flash"] == 0
              and autograd_launches["attention_flash_bwd"] == 0,
              f"fused: launches {autograd_launches}")
        q, k, v = q.detach(), k.detach(), v.detach()
        want = ta._launch_fused_bwd(q, k, v, do, ta._launch_fused(q, k, v)[1])
        check(all(torch.equal(g, w) for g, w in zip(grads, want)),
              "fused: autograd on the card is not the backward kernel")
        del out, grads, want

        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "library_fast_ms", "flash_ms")
        totals = {"fwd": dict.fromkeys(keys, 0.0), "bwd": dict.fromkeys(keys, 0.0)}
        bound_split = {part: {"operations": 0.0, "bytes": 0.0} for part in totals}
        e_bytes = 0
        for blocks in group_blocks(captured):
            q, k, v = captured[blocks[0]]
            do = dos[blocks[0]]
            _, e = ta._launch_fused(q, k, v)
            bounds = fused_bounds(q, k, v)
            row = {"phase": "attn_fused_kernel", "blocks": blocks, "B": q.shape[0],
                   "Nq": q.shape[1], "Nk": k.shape[1], "nh": q.shape[2], "dq": q.shape[3],
                   "dv": v.shape[3], "dtype": "bfloat16",
                   "e_bytes": e.numel() * e.element_size(),
                   "max_err_share": max(block_err[i] for i in blocks)}
            timed = {
                "fwd": (lambda: ta._launch_fused(q, k, v), lambda: ta.fused_plain(q, k, v),
                        lambda: ta._launch(q, k, v, exact=False), 25, None),
                "bwd": (lambda: ta._launch_fused_bwd(q, k, v, do, e),
                        lambda: ta.fused_bwd_plain(q, k, v, do, e),
                        lambda: ta._launch_bwd(q, k, v, do, exact=False), 10, do)}
            for (name, (kernel, plain, flash, iters, grad)), bound in zip(timed.items(), bounds):
                ms = device_ms(kernel, iters)
                row[name] = {"ms": ms, "plain_ms": device_ms(plain, 5),
                             "flash_ms": device_ms(flash, iters), **bound,
                             "roofline_share": bound["bound_ms"] / ms,
                             **sdpa_yardsticks(q, k, v, grad, iters)}
                for key in keys:
                    totals[name][key] += len(blocks) * row[name][key]
                bound_split[name][bound["bound_by"]] += len(blocks) * bound["bound_ms"]
            # The tensor-core backward's own floor: e read four times (three
            # row passes and the keys kernel).
            row["bwd"]["e_floor_ms"] = 4 * row["e_bytes"] / HBM_BYTES_PER_S * 1e3
            totals["bwd"]["e_floor_ms"] = (totals["bwd"].get("e_floor_ms", 0.0)
                                           + len(blocks) * row["bwd"]["e_floor_ms"])
            e_bytes += len(blocks) * row["e_bytes"]
            del e
            emit(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    summary = {"phase": "attn_fused_kernel", "clips": TRAIN_CLIPS, "cases_checked": n_checked,
               "bf16_bit_equal_relaunches": n_bit_equal,
               "fwd_bf16_bit_equal_relaunches": n_fwd_bit_equal, "fwd_path": FLASH_PATH,
               "bwd_path": FLASH_BWD_PATH, "e_vs_plain_bf16": e_diff,
               "forward_bit_equal_to_flash": True, "max_abs_err": max_abs,
               "max_err_share": max_share, "fp32_block1_grad_err_share": fp32_err,
               "tolerance_share": {"out_and_e": {"float32": ATTN_TOL[torch.float32],
                                                 "bfloat16": ATTN_TOL[torch.bfloat16]},
                                   "grads": {"float32": ATTN_BWD_TOL[torch.float32],
                                             "bfloat16": ATTN_BWD_TOL[torch.bfloat16]}},
               "per_step": totals, "bound_split_ms": bound_split,
               "bound_by": {part: max(split, key=split.get)
                            for part, split in bound_split.items()},
               "e_bytes_per_step": e_bytes,
               # rows 4 + 5 against rows 6 + 7 on the same inputs
               "saved_e_pair_ms": totals["fwd"]["ms"] + totals["bwd"]["ms"],
               "flash_pair_ms": totals["fwd"]["flash_ms"] + totals["bwd"]["flash_ms"],
               "autograd_launches": autograd_launches}
    emit(summary)
    return summary


def train_step_run(cfg, state, batch, swap=(), timed_steps=0):
    """One ``make_train_step`` step of a model built from ``cfg`` and loaded
    with ``state``, its generators seeded from ``cfg.RNG_SEED`` (drop path,
    dropout and mixup draw alike in every run), with each ``(module, name,
    value)`` of ``swap`` setting ``module.<name>`` to ``value`` for the run
    (``ops.attention``'s default core to the saved-e core, say, or
    ``ops.max_pool.max_pool3d`` to ``aten_max_pool3d``); then
    ``timed_steps`` more on the same batch (host clock to a synchronize).
    Returns the first step's loss, grad norm, gradients before the clip
    (fp32, on the CPU), launches and peak memory, and the timed steps' ms."""
    import gc

    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    opt = construct_optimizer(model, cfg)
    grads, update = {}, opt.step

    def recording_update(lr):
        if not grads:
            grads.update({n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters() if p.grad is not None})
        return update(lr)

    opt.step = recording_update
    step = make_train_step(cfg, model, opt, torch.Generator().manual_seed(cfg.RNG_SEED))
    kept = [(module, name, getattr(module, name)) for module, name, _ in swap]
    for module, name, value in swap:
        setattr(module, name, value)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        m = step(batch)
        torch.cuda.synchronize()
        run = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
               "launches": read_launches(), "max_memory_allocated": torch.cuda.max_memory_allocated()}
        steps_ms = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for module, name, value in kept:
            setattr(module, name, value)
    if steps_ms:
        run.update(step_p50_ms=statistics.median(steps_ms), steps_ms=steps_ms)
    del model, opt, step, recording_update, update, m
    gc.collect()
    torch.cuda.empty_cache()
    return run, grads


def aten_max_pool3d(x, kernel, stride=None, padding=(0, 0, 0)):
    """``ops.max_pool.max_pool3d`` with ATen's own backward (on the card a
    scatter with atomic adds, whose order changes from run to run): the
    port's max pool before its backward kernel, the yardstick of run-to-run
    noise that the bf16 step checks were set against."""
    import torch.nn.functional as F

    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(kernel), tuple(stride or kernel),
                     tuple(padding))
    return y.permute(0, 2, 3, 4, 1)


def _aten_pool_swap():
    from slowfast_tpu_torch.ops import max_pool as mp

    return [(mp, "max_pool3d", aten_max_pool3d)]


def rel_l2(a, b, names):
    """Relative L2 distance of the tensors ``a[n]`` from ``b[n]`` over
    ``names`` together."""
    diff = sum((a[n] - b[n]).double().pow(2).sum().item() for n in names)
    return (diff / sum(b[n].double().pow(2).sum().item() for n in names)) ** 0.5


def phase_mvit_train_fused():
    """The full-width MViTv2-S 16x4 train step at 16 clips with the default
    core and with ``fused_pooled_attention`` swapped in (no config key
    routes MViT to it), from the same weights, clips and generator seeds.
    bf16: flash, fused, flash again; the forwards are bit-equal, so all
    three losses must be equal; step time and peak memory of each core.
    The third run, flash_again, takes ATen's own max_pool3d backward for
    the residual pools (``_aten_pool_swap``), which adds with atomics: its
    distance from flash (whose pools run the deterministic backward kernel)
    is the run-to-run floor, as two runs on ATen's backward measured it, and
    fused may differ from flash by at most twice it (``run_to_run_limit``); pairs
    whose gradients are bit-equal are listed (``grads_bit_equal``). fp32 (TF32 off): flash and fused once more, where that noise is
    about 1e-7: equal losses and gradients within 1e-3 relative L2. The
    exact core (TPU.PALLAS_ATTENTION) in bf16 runs the tensor-core pair; its
    softmax rounds otherwise than flash's, so its distance from flash is
    recorded, not held. It is held instead to its plain versions: once
    more with every call checked against them on the inputs the model
    gave it (and within twice the run-to-run distance of the timed run),
    and with the plain forward, its backward kernel's gradients within
    twice the run-to-run distance of the step with the plain backward (the
    same forward). The distance of steps whose forwards differ is recorded.
    The default core is held the same way: once more with every call of
    its forward and of its tensor-core backward checked against flash_plain
    and flash_bwd_plain on the inputs (and output gradient) the model gave
    it. Last, one bf16 flash step under torch.use_deterministic_algorithms(True,
    warn_only=True) names the ops that have no deterministic version: none,
    since the max pools' backward is the kernel."""
    import warnings

    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import attention as ta

    class PlainExactCore(torch.autograd.Function):
        """The exact core on the card with ``exact_plain`` for its forward
        and, unless ``kernel_bwd``, ``exact_bwd_plain`` for its backward."""

        @staticmethod
        def forward(ctx, qh, kh, vh, kernel_bwd):
            ctx.save_for_backward(qh, kh, vh)
            ctx.kernel_bwd = kernel_bwd
            return ta.exact_plain(qh, kh, vh)

        @staticmethod
        def backward(ctx, do):
            args = (*ctx.saved_tensors, do.contiguous())
            if ctx.kernel_bwd:
                return (*ta._launch_bwd(*args, exact=True), None)
            return (*ta.exact_bwd_plain(*args), None)

    shadow = {name: dict(fwd_calls=0, bwd_calls=0, fwd_err_share=0.0,
                         fwd_elems_differ_share=0.0, bwd_err_share=0.0)
              for name in ("exact", "flash")}

    def shadowed(name, kernel_core, fwd_plain, bwd_plain):
        """The core's entry point, each call also held against the plain
        versions on the inputs (and output gradient) it was given."""
        stats = shadow[name]

        def shadowed_core(qh, kh, vh):
            out = kernel_core(qh, kh, vh)
            q, k, v = (t.detach() for t in (qh, kh, vh))
            want = fwd_plain(q, k, v)
            err = (out.detach().float() - want.float()).abs().max().item()
            stats["fwd_calls"] += 1
            stats["fwd_err_share"] = max(stats["fwd_err_share"],
                                         err / v.float().abs().max().item())
            stats["fwd_elems_differ_share"] = max(stats["fwd_elems_differ_share"],
                                                  (out.detach() != want).float().mean().item())

            def check_bwd(grad_inputs, grad_outputs):
                stats["bwd_calls"] += 1
                for g, w in zip(grad_inputs, bwd_plain(q, k, v, grad_outputs[0])):
                    err = (g.float() - w.float()).abs().max().item()
                    stats["bwd_err_share"] = max(stats["bwd_err_share"],
                                                 err / max(w.float().abs().max().item(), 1e-30))

            out.grad_fn.register_hook(check_bwd)
            return out

        return shadowed_core

    cfg = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
    depth = cfg.MVIT.DEPTH
    gen = torch.Generator(device="cuda").manual_seed(10)
    size = (TRAIN_CLIPS, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
            cfg.DATA.TRAIN_CROP_SIZE, 3)
    batch = {"inputs": [torch.randint(0, 256, size, dtype=torch.uint8, device="cuda",
                                      generator=gen)],
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (TRAIN_CLIPS,), device="cuda",
                                     generator=gen),
             "epoch_exact": 15.0}  # mid-warmup: a nonzero LR
    state = {k: v.cpu() for k, v in build_model(cfg, device="cuda").state_dict().items()}
    runs, grads = {}, {}
    fused_swap = [(ta, "flash_pooled_attention", ta.fused_pooled_attention)]
    for name, swap in (("flash", ()), ("fused", fused_swap),
                       ("flash_again", _aten_pool_swap())):
        runs[name], grads[name] = train_step_run(cfg, state, batch, swap, 3)
    runs["flash_shadow"], grads["flash_shadow"] = train_step_run(
        cfg, state, batch, [(ta, "flash_pooled_attention",
                             shadowed("flash", ta.flash_pooled_attention, ta.flash_plain,
                                      ta.flash_bwd_plain))])
    cfg_exact = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.PALLAS_ATTENTION", "True"])
    runs["exact"], grads["exact"] = train_step_run(cfg_exact, state, batch, (), 3)
    for name, core in (("exact_shadow", shadowed("exact", ta.pooled_attention, ta.exact_plain,
                                                 ta.exact_bwd_plain)),
                       ("plain_exact", lambda q, k, v: PlainExactCore.apply(q, k, v, False)),
                       ("plain_fwd_exact_bwd",
                        lambda q, k, v: PlainExactCore.apply(q, k, v, True))):
        runs[name], grads[name] = train_step_run(cfg_exact, state, batch,
                                                 [(ta, "pooled_attention", core)])
    cfg32 = mvit_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, swap in (("flash_fp32", ()), ("fused_fp32", fused_swap)):
            runs[name], grads[name] = train_step_run(cfg32, state, batch, swap)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            train_step_run(cfg, state, batch)
        finally:
            torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message).split(" does not have")[0][:120] for w in caught
                               if "deterministic" in str(w.message)})

    check(all(sorted(g) == sorted(grads["flash"]) for g in grads.values()),
          "the runs differ in which parameters have a gradient")
    pairs = (("fused", "flash"), ("flash_again", "flash"), ("fused_fp32", "flash_fp32"))
    l2 = {f"{a}_vs_{b}": rel_l2(grads[a], grads[b], grads[b])
          for a, b in pairs + (("flash_shadow", "flash"), ("exact_shadow", "exact"),
                               ("plain_fwd_exact_bwd", "plain_exact"),
                               ("exact", "plain_fwd_exact_bwd"), ("exact", "plain_exact"),
                               ("exact", "flash"), ("plain_exact", "flash"))}
    bit_equal = sorted(k for k in l2 if k.split("_vs_")[0] in grads
                       and all(torch.equal(grads[k.split("_vs_")[0]][n],
                                           grads[k.split("_vs_")[1]][n])
                               for n in grads["flash"]))
    row = {"phase": "mvit_train_fused", "clips": TRAIN_CLIPS, "grad_rel_l2": l2,
           "grads_bit_equal": bit_equal,
           "bf16_pair_limit": run_to_run_limit(l2["flash_again_vs_flash"], "mvit_train_fused"),
           "grad_l2_tol_fp32": TRAIN_GRAD_L2_TOL, "params_checked": len(grads["flash"]),
           "peak_memory_delta": runs["fused"]["max_memory_allocated"]
           - runs["flash"]["max_memory_allocated"],
           "nondeterministic_ops": nondeterministic, "exact_shadow_checks": shadow["exact"],
           "flash_shadow_checks": shadow["flash"], **runs}
    emit(row)
    for a, b in pairs:
        check(np.isfinite(runs[b]["loss"]) and runs[a]["loss"] == runs[b]["loss"],
              f"{a} loss {runs[a]['loss']} vs {b} {runs[b]['loss']}")
    # The exact softmax rounds otherwise than the constant shift: its loss and
    # gradients are recorded beside flash's, and held to its plain versions'.
    check(np.isfinite(runs["exact"]["loss"]) and np.isfinite(l2["exact_vs_flash"]),
          f"exact: loss {runs['exact']['loss']}, gradients {l2['exact_vs_flash']} from flash's")
    for name, stats in shadow.items():
        check(stats["fwd_calls"] == stats["bwd_calls"] == depth
              and stats["fwd_err_share"] <= ATTN_TOL[torch.bfloat16]
              and stats["bwd_err_share"] <= ATTN_BWD_TOL[torch.bfloat16],
              f"{name} kernels in the train step against their plain versions: {stats}")
    limit = run_to_run_limit(l2["flash_again_vs_flash"], "mvit_train_fused")
    for a, b in (("flash_shadow", "flash"), ("exact_shadow", "exact"),
                 ("plain_fwd_exact_bwd", "plain_exact")):
        check(l2[f"{a}_vs_{b}"] <= limit,
              f"bf16: {a} gradients differ from {b}'s by {l2[f'{a}_vs_{b}']}, over {limit}: "
              f"twice the run-to-run {l2['flash_again_vs_flash']} (L2), capped")
    check(l2["fused_fp32_vs_flash_fp32"] <= TRAIN_GRAD_L2_TOL,
          f"fp32: fused gradients differ from flash's by {l2['fused_fp32_vs_flash_fp32']} (L2)")
    check(l2["fused_vs_flash"] <= limit,
          f"bf16: fused gradients differ from flash's by {l2['fused_vs_flash']}, over {limit}: "
          f"twice the run-to-run {l2['flash_again_vs_flash']} (L2), capped")
    flash = ("attention_flash", "attention_flash_bwd")
    fused = ("attention_fused", "attention_fused_bwd")
    exact = ("attention_exact", "attention_exact_bwd")
    want = {"flash": flash, "fused": fused, "flash_again": flash, "flash_shadow": flash,
            "exact": exact, "exact_shadow": exact, "plain_exact": (),
            "plain_fwd_exact_bwd": ("attention_exact_bwd",),
            "flash_fp32": FP32_CORE_KEYS["flash"],
            "fused_fp32": ("attention_fused_fma", "attention_fused_fma_bwd")}
    for name, run in runs.items():
        n = run["launches"]
        check(only_launched(n, want[name], depth) and n["preprocess_u8"] == 1,
              f"{name}: launches {n}")
    return {name: run["launches"] for name, run in runs.items()}


def structurally_zero(name, depth):
    """Gradients that vanish in exact arithmetic: a bias on every key shifts
    each logit row by a constant, which the softmax ignores (norm_k.bias);
    the last block's q pooling and rel-pos tables act only on non-cls query
    rows, and only the cls row reaches the head."""
    last = f"blocks.{depth - 1}.attn."
    return name.endswith("norm_k.bias") or (
        name.startswith(last) and name[len(last):].startswith(("pool_q.", "rel_pos")))


def train_one_step(cfg, model, clip, label, epoch_exact, extra=None):
    """One ``make_train_step`` step (``extra``: more batch entries, such as a
    detection batch's boxes and box mask); returns (metrics, gradients
    before the clip, parameters after the update), all on the CPU."""
    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    opt = construct_optimizer(model, cfg)
    grads, update = {}, opt.step

    def recording_update(lr):
        grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return update(lr)

    opt.step = recording_update
    dev = next(model.parameters()).device
    batch = {"inputs": [clip.to(dev)], "labels": label.to(dev), "epoch_exact": epoch_exact}
    batch.update({k: v.to(dev) for k, v in (extra or {}).items()})
    m = make_train_step(cfg, model, opt)(batch)
    metrics = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"]}
    params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return metrics, grads, params


def phase_mvit_train_fp32():
    """One train step of full-width MViTv2-S on one clip, card vs CPU, fp32
    with TF32 off, with each core against the CPU run of the same core. The
    two CPU runs compute the same softmax in fp32 and differ only in
    rounding; their distance is reported as the noise floor."""
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32", "AUG.NUM_SAMPLE", "1", "MIXUP.ENABLE", "False",
            "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]
    cfg = mvit_cfg(base)
    depth = cfg.MVIT.DEPTH
    cpu_model = build_model(cfg, device="cpu")
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    clip = torch.from_numpy(np.random.RandomState(8).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    ).astype(np.uint8))
    label = torch.tensor([17])
    epoch_exact = 15.0  # mid-warmup: a nonzero LR
    cores = (("flash", []), ("exact", ["TPU.PALLAS_ATTENTION", "True"]))
    cpu, cpu_s = {}, {}
    for core, extra in cores:
        cfg = mvit_cfg(base + extra)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        cpu[core] = train_one_step(cfg, model, clip, label, epoch_exact)
        cpu_s[core] = time.perf_counter() - t0

    launches = {}
    for core, extra in cores:
        want, want_grads, want_params = cpu[core]
        gmax = max(g.abs().max().item() for g in want_grads.values())
        cfg = mvit_cfg(base + extra)
        model = build_model(cfg, device="cuda")
        model.load_state_dict(state, strict=True)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            reset_launches()
            got, grads, params = train_one_step(cfg, model, clip, label, epoch_exact)
            torch.cuda.synchronize()
            launches[core] = read_launches()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        missing = [n for n, p in model.named_parameters() if p.requires_grad and (
            n not in grads or (grads[n].abs().max().item() == 0.0
                               and not structurally_zero(n, depth)))]
        check(not missing, f"{core}: parameters with no or an all-zero gradient: {missing}")
        shares = {}
        for n, g in grads.items():
            w = want_grads[n]
            if structurally_zero(n, depth):
                # rounding noise on both sides: small against the largest gradient
                check(g.abs().max().item() <= 1e-3 * gmax, f"{core}: {n} is not ~0")
                continue
            shares[n] = (g - w).abs().max().item() / w.abs().max().item()
        worst = sorted(shares.items(), key=lambda kv: -kv[1])[:6]
        tail = max(v for n, v in shares.items()
                   if n.startswith((f"blocks.{depth - 1}.", "norm.", "head.")))
        l2_err = rel_l2(grads, want_grads, shares)
        cpu_spread = rel_l2(cpu["exact"][1], cpu["flash"][1], shares)
        param_err = max((params[n] - want_params[n]).abs().max().item() for n in params)
        loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
        norm_err = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        emit({"phase": "mvit_train_fp32", "core": core, "loss": got["loss"],
              "cpu_loss": want["loss"], "loss_rel_err": loss_err,
              "grad_norm": got["grad_norm"], "grad_norm_rel_err": norm_err,
              "grad_rel_l2_err": l2_err, "grad_l2_tol": TRAIN_GRAD_L2_TOL,
              "cpu_flash_vs_exact_grad_rel_l2": cpu_spread,
              "max_grad_err_share_after_last_pool": tail,
              "grad_tol_share_after_last_pool": TRAIN_GRAD_TOL_TAIL,
              "worst_grad_err_shares": worst, "grad_tol_share": TRAIN_GRAD_TOL,
              "median_grad_err_share": statistics.median(shares.values()),
              "max_param_err_after_update": param_err,
              "lr": got["lr"], "params_checked": len(grads), "cpu_step_s": cpu_s[core],
              "launches": launches[core]})
        check(loss_err <= 1e-5, f"{core}: loss {got['loss']} vs CPU {want['loss']}")
        check(norm_err <= 1e-4, f"{core}: grad norm {got['grad_norm']} vs {want['grad_norm']}")
        check(tail <= TRAIN_GRAD_TOL_TAIL, f"{core}: gradients past the last pool differ by {tail}")
        check(l2_err <= TRAIN_GRAD_L2_TOL, f"{core}: gradients differ by {l2_err} (L2)")
        check(worst[0][1] <= TRAIN_GRAD_TOL, f"{core}: gradients differ: {worst}")
        # Adam's first step moves each parameter by about lr times the sign
        # of its gradient; where a gradient is rounding noise the sign may
        # differ, so the bound is twice the LR.
        check(param_err <= 2.0 * want["lr"] + 1e-6, f"{core}: parameters differ by {param_err}")
        check(only_launched(launches[core], FP32_CORE_KEYS[core], depth),
              f"{core}: launches {launches[core]}")
    return launches


def phase_mvit_train_slice(attn_bwd, attn_fwd):
    """``run_net.main`` training MViTv2-S 16x4 on the card: one epoch of 4
    steps of 16 clips, a val epoch and the epoch-1 checkpoint."""
    import gc
    import shutil

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(OUT_DIR, "mvit_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, models = [], []
    make_step = trainer.make_train_step

    def recording_make_step(cfg, model, optimizer, generator):
        """The trainer's step, timed on the host clock to a synchronize."""
        models.append(model)
        step = make_step(cfg, model, optimizer, generator)

        def timed(batch):
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
                          "clips": batch["labels"].shape[0]})
            return m

        return timed

    argv = ["--cfg", MVIT_YAML, "--opts", "NUM_GPUS", "1", "TRAIN.DATASET", "syntheticvideo",
            "DATA.SYNTHETIC_SIZE", "32", "TRAIN.BATCH_SIZE", "8", "SOLVER.MAX_EPOCH", "1",
            "TEST.ENABLE", "False", "OUTPUT_DIR", out_dir]
    trainer.make_train_step = recording_make_step
    # Models of earlier phases whose optimizer step was wrapped in a closure
    # sit in reference cycles; free them, so the peak is this run's own.
    gc.collect()
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        run_net.main(argv)
    finally:
        trainer.make_train_step = make_step
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    cfg = mvit_cfg([])
    depth = cfg.MVIT.DEPTH
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    types = [s["_type"] for s in logged]
    check(len(steps) == 4 and all(s["clips"] == TRAIN_CLIPS for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps),
          f"non-finite loss: {steps}")
    check("train_epoch" in types and "val_epoch" in types, f"logged {types}")
    check(launches["attention_flash_bwd"] == depth * 4 and launches["attention_flash_fma_bwd"] == 0,
          f"tensor-core backward launched {launches['attention_flash_bwd']} times for 4 "
          f"steps, FMA backward {launches['attention_flash_fma_bwd']}")
    check(launches["attention_flash"] == depth * (4 + 4),
          f"tensor-core forward launched {launches['attention_flash']} times for 4 + 4 "
          f"batches")
    check(all(n == 0 for key, n in launches.items() if key.startswith("attention_")
              and key not in ("attention_flash", "attention_flash_bwd")),
          f"FMA, exact or fused kernels launched: {launches}")
    check(launches["preprocess_u8"] == 4 + 4, f"preprocess launches {launches}")

    path = cu.get_path_to_checkpoint(out_dir, 1)
    check(os.path.exists(path), f"no checkpoint at {path}")
    trained = models[0]
    fresh = build_model(cfg, device="cuda")
    fresh.load_state_dict(torch.load(path, map_location="cuda", weights_only=True)["model_state"],
                          strict=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    clips = torch.randint(0, 256, (2, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE,
                                   cfg.DATA.TEST_CROP_SIZE, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    a = make_eval_step(cfg, trained)({"inputs": [clips]})
    b = make_eval_step(cfg, fresh)({"inputs": [clips]})
    check(torch.equal(a, b), f"reloaded checkpoint differs: {(a - b).abs().max().item()}")
    ckpt_bytes = os.path.getsize(path)
    os.remove(path)  # weights and AdamW state: too large to keep among the run's files

    step_ms = statistics.median(s["ms"] for s in steps)
    bwd_ms = attn_bwd["per_backward"]["flash"]["ms"]
    row = {"phase": "mvit_train_slice", "steps": len(steps), "clips_per_step": TRAIN_CLIPS,
           "step_p50_ms": step_ms, "train_clips_per_s": TRAIN_CLIPS / step_ms * 1e3,
           "first_step_ms": steps[0]["ms"], "max_memory_allocated": peak,
           "memory_allocated_at_start": allocated_at_start,
           "attn_bwd_ms_per_step": bwd_ms, "attn_bwd_share_of_step": bwd_ms / step_ms,
           # the forward kernel's time at 8 clips (phase attn_kernel), twice
           "attn_fwd_ms_per_step_est": 2 * attn_fwd["per_forward"]["flash"]["ms"],
           "per_step": [{k: s[k] for k in ("ms", "loss", "grad_norm", "lr")} for s in steps],
           "val_epoch": [s for s in logged if s["_type"] == "val_epoch"][-1],
           "train_wall_s": wall, "checkpoint": os.path.relpath(path, ROOT),
           "checkpoint_bytes": ckpt_bytes,
           "reload_identical": True, "launches": launches}
    emit(row)
    return launches


def running_buffers(model):
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running_" in n}


def float64_grads(cfg, state, clip, label, extra=None):
    """The train step's gradients with the model, its activations and its
    sums in float64 on the CPU: the yardstick of fp32 rounding. ``extra``
    holds a detection batch's ``boxes`` and ``box_mask``."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess, masked_detection_loss
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.losses import get_loss_func

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    model.double()
    model.dtype = torch.float64
    model.train()
    inputs = [x.double() for x in maybe_device_preprocess(cfg, [clip])]
    loss_fun = get_loss_func(cfg.MODEL.LOSS_FUNC)
    if extra is None:
        loss_fun(model(inputs), label).backward()
    else:
        preds = model(inputs, extra["boxes"].double())
        masked_detection_loss(loss_fun, preds, label.double(), extra["box_mask"]).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def phase_sf_train_fp32():
    """One train step of full-width SlowFast 4x16 R50 on 2 clips, card vs CPU
    on the same weights (every BN parameter and statistic random), fp32 with
    TF32 off: SGD with Nesterov momentum, dropout off (the two generators
    draw different masks). The loss, grad norm, every gradient, the updated
    parameters and the BN running buffers after the step.

    In fp32 this gradient is not a smooth function of the rounding: ReLU
    masks and max-pool argmaxes flip on near-ties, and the BNs' backward
    spreads each moved entry over its channel. So all gradients together are
    held by a yardstick measured here: their distance from the same step in
    float64 on the CPU must be at most twice the CPU's fp32 distance from
    it. The head's gradients, which no flip upstream reaches, are held
    within TRAIN_GRAD_TOL_TAIL of their max. A control proves the gradient
    limit's power: the same card step with TF32 left on must fail it."""
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import OPTIMIZERS, SGD

    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "float32", "MODEL.DROPOUT_RATE", "0.0",
                        "NUM_GPUS", "1", "TRAIN.BATCH_SIZE", "2"])
    cpu_model = build_model(cfg, device="cpu")
    randomize_bn(cpu_model, 3)
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    crop = cfg.DATA.TRAIN_CROP_SIZE
    clip = torch.from_numpy(np.random.RandomState(10).randint(
        0, 255, (2, cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8))
    label = torch.tensor([17, 305])
    epoch_exact = 15.0  # mid-warmup: a nonzero LR
    t0 = time.perf_counter()
    want, want_grads, want_params = train_one_step(cfg, cpu_model, clip, label, epoch_exact)
    cpu_s = time.perf_counter() - t0
    want_bufs = running_buffers(cpu_model)
    exact = float64_grads(cfg, state, clip, label)

    def card_step(allow_tf32):
        model = build_model(cfg, device="cuda")
        model.load_state_dict(state, strict=True)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            reset_launches()
            out = train_one_step(cfg, model, clip, label, epoch_exact)
            torch.cuda.synchronize()
            launches = read_launches()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        return (*out, running_buffers(model), launches)

    got, grads, params, bufs, launches = card_step(False)
    names = [n for n, p in cpu_model.named_parameters() if p.requires_grad]
    missing = [n for n in names if n not in grads or grads[n].abs().max().item() == 0.0]
    check(not missing, f"parameters with no or an all-zero gradient: {missing}")
    shares = {n: (grads[n] - want_grads[n]).abs().max().item() / want_grads[n].abs().max().item()
              for n in names}
    head = max(v for n, v in shares.items() if n.startswith("head."))
    l2_err = rel_l2(grads, want_grads, names)
    card_vs_f64, cpu_vs_f64 = rel_l2(grads, exact, names), rel_l2(want_grads, exact, names)
    norm_f64 = sum(exact[n].pow(2).sum().item() for n in names) ** 0.5
    norm_floor = abs(want["grad_norm"] - norm_f64) / norm_f64
    grad_abs_err = max((grads[n] - want_grads[n]).abs().max().item() for n in names)
    param_err = max((params[n] - want_params[n]).abs().max().item() for n in names)
    buf_share = max((bufs[n] - want_bufs[n]).abs().max().item() / want_bufs[n].abs().max().item()
                    for n in want_bufs)
    moved = max((want_bufs[n] - state[n]).abs().max().item() for n in want_bufs)
    loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
    norm_err = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:6]
    # The control: the same card step with TF32 left on. The gradient limit
    # must reject it, or it could not tell the fp32 step from a TF32 one.
    c_got, c_grads = card_step(True)[:2]
    control = {"loss_rel_err": abs(c_got["loss"] - want["loss"]) / want["loss"],
               "grad_rel_l2_err": rel_l2(c_grads, want_grads, names),
               "card_vs_float64_grad_rel_l2": rel_l2(c_grads, exact, names),
               "max_head_grad_err_share": max(
                   (c_grads[n] - want_grads[n]).abs().max().item()
                   / want_grads[n].abs().max().item() for n in names if n.startswith("head."))}
    control["fails"] = [k for k, bad in (
        ("loss", control["loss_rel_err"] > 1e-5),
        ("head", control["max_head_grad_err_share"] > TRAIN_GRAD_TOL_TAIL),
        ("grads", control["card_vs_float64_grad_rel_l2"] > 2.0 * cpu_vs_f64)) if bad]
    emit({"phase": "sf_train_fp32", "clips": 2, "frames": cfg.DATA.NUM_FRAMES, "crop": crop,
          "optimizer": cfg.SOLVER.OPTIMIZING_METHOD, "nesterov": cfg.SOLVER.NESTEROV,
          "loss": got["loss"], "cpu_loss": want["loss"], "loss_rel_err": loss_err,
          "grad_norm": got["grad_norm"], "grad_norm_rel_err": norm_err,
          "grad_rel_l2_err": l2_err, "card_vs_float64_grad_rel_l2": card_vs_f64,
          "cpu_vs_float64_grad_rel_l2": cpu_vs_f64,
          "cpu_vs_float64_grad_norm_rel_err": norm_floor,
          "max_head_grad_err_share": head, "head_grad_tol_share": TRAIN_GRAD_TOL_TAIL,
          "worst_grad_err_shares": worst,
          "median_grad_err_share": statistics.median(shares.values()),
          "max_param_err_after_update": param_err, "max_grad_abs_err": grad_abs_err,
          "max_bn_buffer_err_share": buf_share, "bn_buffer_tol_share": BN_BUFFER_TOL,
          "max_bn_buffer_move": moved, "bn_buffers_checked": len(want_bufs),
          "lr": got["lr"], "params_checked": len(names), "cpu_step_s": cpu_s,
          "launches": launches, "tf32_control": control})
    check(OPTIMIZERS[cfg.SOLVER.OPTIMIZING_METHOD] is SGD and cfg.SOLVER.NESTEROV,
          "the recipe's optimizer is not Nesterov SGD")
    check(loss_err <= 1e-5, f"loss {got['loss']} vs CPU {want['loss']}")
    check(norm_err <= max(1e-4, 2.0 * norm_floor),
          f"grad norm {got['grad_norm']} vs {want['grad_norm']}")
    check(head <= TRAIN_GRAD_TOL_TAIL, f"head gradients differ by {head} of their max")
    check(card_vs_f64 <= 2.0 * cpu_vs_f64,
          f"gradients {card_vs_f64} from float64 (L2), the CPU's fp32 {cpu_vs_f64}")
    check("grads" in control["fails"],
          f"the gradient limit passes a TF32 step: {control}")
    # SGD applies the same linear map to both gradients: (1 + momentum) lr g
    # plus the same decay, so the parameters differ by at most that much.
    check(param_err <= 2.0 * got["lr"] * grad_abs_err + 1e-6,
          f"parameters differ by {param_err}")
    check(moved > 0.0 and buf_share <= BN_BUFFER_TOL, f"BN buffers differ by {buf_share}")
    check(launches["preprocess_u8"] == 1, f"launches {launches}")


def phase_sf_train_slice():
    """``run_net.main`` training SlowFast 4x16 R50 on the card for one epoch
    on synthetic video: 4 steps of 16 clips (SGD with Nesterov momentum,
    warmup, head dropout 0.5), precise BN over the epoch's 4 train batches,
    a val epoch of 4 batches and the epoch-1 checkpoint."""
    import gc
    import shutil

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(OUT_DIR, "sf_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, models, precise = [], [], []
    make_step, precise_bn = trainer.make_train_step, trainer.compute_precise_bn_stats

    def recording_make_step(cfg, model, optimizer, generator):
        """The trainer's step, timed on the host clock to a synchronize."""
        models.append(model)
        step = make_step(cfg, model, optimizer, generator)

        def timed(batch):
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
                          "clips": batch["labels"].shape[0]})
            return m

        return timed

    def recording_precise_bn(cfg, model, loader, num_batches):
        """The trainer's precise BN, with the buffers before and after."""
        before = running_buffers(model)
        launched = read_launches()["preprocess_u8"]
        t0 = time.perf_counter()
        n = precise_bn(cfg, model, loader, num_batches)
        torch.cuda.synchronize()
        precise.append({"batches": n, "ms": (time.perf_counter() - t0) * 1e3, "before": before,
                        "after": running_buffers(model),
                        "launches": read_launches()["preprocess_u8"] - launched})
        return n

    argv = ["--cfg", YAML, "--opts", "NUM_GPUS", "1", "TRAIN.DATASET", "syntheticvideo",
            "DATA.SYNTHETIC_SIZE", str(4 * CNN_TRAIN_CLIPS), "TRAIN.BATCH_SIZE",
            str(CNN_TRAIN_CLIPS), "SOLVER.MAX_EPOCH", "1", "TEST.ENABLE", "False",
            "OUTPUT_DIR", out_dir]
    trainer.make_train_step = recording_make_step
    trainer.compute_precise_bn_stats = recording_precise_bn
    gc.collect()
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        run_net.main(argv)
    finally:
        trainer.make_train_step = make_step
        trainer.compute_precise_bn_stats = precise_bn
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    cfg = slowfast_cfg(["NUM_GPUS", "1"])
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    types = [s["_type"] for s in logged]
    check(len(steps) == 4 and all(s["clips"] == CNN_TRAIN_CLIPS for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps),
          f"non-finite loss: {steps}")
    check("train_epoch" in types and "val_epoch" in types, f"logged {types}")
    check(len(precise) == 1 and precise[0]["batches"] == 4 and precise[0]["launches"] == 4,
          f"precise BN: {[(p['batches'], p['launches']) for p in precise]}")
    check(only_launched(launches, (), 0), f"SlowFast launched an attention kernel: {launches}")
    check(launches["preprocess_u8"] == 4 + 4 + 4,
          f"preprocess launches {launches['preprocess_u8']}: 4 steps + 4 precise-BN "
          f"batches + 4 val batches expected")

    path = cu.get_path_to_checkpoint(out_dir, 1)
    check(os.path.exists(path), f"no checkpoint at {path}")
    saved = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
    after, before = precise[0]["after"], precise[0]["before"]
    check(all(torch.equal(saved[n], after[n]) for n in after),
          "the checkpoint's BN buffers are not the precise ones")
    ema_differs = sum(not torch.equal(after[n], before[n]) for n in after)
    check(ema_differs == len(after), f"precise BN left {len(after) - ema_differs} buffers as "
          f"the train steps' running averages")
    fresh = build_model(cfg, device="cuda")
    fresh.load_state_dict({k: v.cuda() for k, v in saved.items()}, strict=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    clips = torch.randint(0, 256, (2, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE,
                                   cfg.DATA.TEST_CROP_SIZE, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    a = make_eval_step(cfg, models[0])({"inputs": [clips]})
    b = make_eval_step(cfg, fresh)({"inputs": [clips]})
    check(torch.equal(a, b), f"reloaded checkpoint differs: {(a - b).abs().max().item()}")
    ckpt_bytes = os.path.getsize(path)
    os.remove(path)  # weights and momentum: too large to keep among the run's files

    step_ms = statistics.median(s["ms"] for s in steps)
    row = {"phase": "sf_train_slice", "steps": len(steps), "clips_per_step": CNN_TRAIN_CLIPS,
           "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
           "dtype": cfg.TPU.COMPUTE_DTYPE, "optimizer": "sgd, nesterov",
           "dropout": cfg.MODEL.DROPOUT_RATE,
           "step_p50_ms": step_ms, "train_clips_per_s": CNN_TRAIN_CLIPS / step_ms * 1e3,
           "first_step_ms": steps[0]["ms"], "max_memory_allocated": peak,
           "memory_allocated_at_start": allocated_at_start,
           "per_step": [{k: s[k] for k in ("ms", "loss", "grad_norm", "lr")} for s in steps],
           "precise_bn_batches": precise[0]["batches"], "precise_bn_ms": precise[0]["ms"],
           "precise_bn_buffers": len(after), "checkpoint_buffers_precise": True,
           "val_epoch": [s for s in logged if s["_type"] == "val_epoch"][-1],
           "train_wall_s": wall, "checkpoint_bytes": ckpt_bytes,
           "reload_identical": True, "launches": launches}
    emit(row)
    del models[:], fresh
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_data_slice(sf_train):
    """``run_net.main`` training SlowFast 4x16 R50 on decoded mp4s (Kinetics,
    cv2) for one epoch of 4 steps of 16 clips, precise BN, a val epoch of 2
    batches, then the 10 x 3 test of 2 videos on the epoch-1 checkpoint;
    before it, the train loader alone. Returns the run's launches, or None
    when cv2 does not import on this host."""
    import gc
    import shutil
    import tempfile

    try:
        import cv2  # noqa: F401
    except ImportError:
        emit({"phase": "data_slice", "ran": False, "missing": ["cv2"]})
        return None
    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.data import construct_loader, decoder, synth_media
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(OUT_DIR, "data_slice")
    shutil.rmtree(out_dir, ignore_errors=True)
    corpus = tempfile.mkdtemp(prefix="data_slice_corpus_")
    try:
        t0 = time.perf_counter()
        synth_media.make_video_corpus(corpus, CORPUS, frames=300, size=(340, 256), fps=30,
                                      workers=os.cpu_count() or 1)
        corpus_s = time.perf_counter() - t0
        corpus_bytes = sum(os.path.getsize(os.path.join(corpus, f)) for f in os.listdir(corpus))
        results = os.path.join(out_dir, "results.pkl")
        opts = ["NUM_GPUS", "1", "TRAIN.DATASET", "kinetics", "TEST.DATASET", "kinetics",
                "DATA.PATH_TO_DATA_DIR", corpus, "TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS),
                "TEST.BATCH_SIZE", "8", "SOLVER.MAX_EPOCH", "1", "TEST.ENABLE", "True",
                "TEST.CHECKPOINT_FILE_PATH", cu.get_path_to_checkpoint(out_dir, 1),
                "TEST.SAVE_RESULTS_PATH", results, "OUTPUT_DIR", out_dir]
        cfg = slowfast_cfg(opts + ["TRAIN.ENABLE", "True"], out_dir=out_dir)

        # The train loader alone: the 4 batches of an epoch, each to a synchronize.
        loader = construct_loader(cfg, "train", device="cuda")
        loader.set_epoch(0)
        load_ms = []
        t0 = time.perf_counter()
        for _ in loader:
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()

        steps, epochs = [], []
        make_step, train_epoch = trainer.make_train_step, trainer.train_epoch

        def recording_make_step(cfg, model, optimizer, generator):
            step = make_step(cfg, model, optimizer, generator)

            def timed(batch):
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                steps.append({"start": t0, "end": time.perf_counter(), "loss": m["loss"].item(),
                              "clips": batch["labels"].shape[0]})
                return m

            return timed

        def recording_train_epoch(*args, **kwargs):
            epochs.append(time.perf_counter())
            return train_epoch(*args, **kwargs)

        trainer.make_train_step = recording_make_step
        trainer.train_epoch = recording_train_epoch
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            run_net.main(["--cfg", YAML, "--opts", *opts])
        finally:
            trainer.make_train_step = make_step
            trainer.train_epoch = train_epoch
        wall = time.perf_counter() - t0
        launches = read_launches()
        gc.collect()
        torch.cuda.empty_cache()
        prefetch = prefetch_phase_rows(cfg)
    finally:
        shutil.rmtree(corpus, ignore_errors=True)

    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    by_type = {}
    for stats in logged:
        by_type.setdefault(stats["_type"], []).append(stats)
    with open(results, "rb") as f:
        video_preds, _ = pickle.load(f)
    test_clips = CORPUS["test"] * cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    test_batches = -(-test_clips // cfg.TEST.BATCH_SIZE)
    val_batches = CORPUS["val"] // CNN_TRAIN_CLIPS
    batches = len(steps) + len(steps) + val_batches + test_batches  # precise BN: the 4 again
    check(len(steps) == 4 and all(s["clips"] == CNN_TRAIN_CLIPS for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(all(np.isfinite(s["loss"]) for s in steps), f"non-finite loss: {steps}")
    check(len(by_type.get("val_epoch", [])) == 1, f"logged {list(by_type)}")
    check(len(by_type.get("test_iter", [])) == test_batches and "test_final" in by_type,
          f"test iterations {len(by_type.get('test_iter', []))}, expected {test_batches}")
    check(video_preds.shape == (CORPUS["test"], cfg.MODEL.NUM_CLASSES)
          and np.isfinite(video_preds).all(), "bad test predictions")
    check(only_launched(launches, (), 0), f"SlowFast launched an attention kernel: {launches}")
    check(launches["preprocess_u8"] == batches,
          f"preprocess launches {launches['preprocess_u8']} for {batches} batches")

    step_ms = [(s["end"] - s["start"]) * 1e3 for s in steps]
    wait_ms = [(steps[0]["start"] - epochs[0]) * 1e3] + [
        (b["start"] - a["end"]) * 1e3 for a, b in zip(steps, steps[1:])]
    row = {"phase": "data_slice", "ran": True, "decode_backend": decoder.BACKEND,
           "decoding_backend_cfg": cfg.DATA.DECODING_BACKEND,
           "corpus": {"videos": max(CORPUS.values()), "frames": 300, "size": [340, 256],
                      "fps": 30, "bytes": corpus_bytes, "write_s": corpus_s},
           "num_workers_cfg": cfg.DATA_LOADER.NUM_WORKERS,
           "num_workers": loader.num_workers, "clips_per_step": CNN_TRAIN_CLIPS,
           "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
           "loader_batch_ms": load_ms, "loader_batch_p50_ms": statistics.median(load_ms),
           "step_ms": step_ms, "step_p50_ms": statistics.median(step_ms),
           "synthetic_step_p50_ms": sf_train["step_p50_ms"],
           "data_wait_ms": wait_ms,
           "data_wait_share": sum(wait_ms[1:]) / (sum(wait_ms[1:]) + sum(step_ms[1:])),
           "data_wait_share_with_first": sum(wait_ms) / (sum(wait_ms) + sum(step_ms)),
           "losses": [s["loss"] for s in steps], "val_epoch": by_type["val_epoch"][-1],
           "test_final": by_type["test_final"][-1], "test_clips": test_clips,
           "batches": {"train": len(steps), "precise_bn": len(steps), "val": val_batches,
                       "test": test_batches},
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "wall_s": wall,
           "launches": launches, "prefetch": prefetch}
    emit(row)
    os.remove(cu.get_path_to_checkpoint(out_dir, 1))  # too large to keep among the run's files
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def temper_logits(model, clip, cfg, logit_std=2.0, boxes=None):
    """Scale the projection so the eval logits of ``clip`` (the head's
    activation switched off; a detection model's at ``boxes``) have std
    ``logit_std``: with random weights at full depth the softmax or sigmoid
    saturates, and the comparison would pass whatever the error."""
    from slowfast_tpu_torch.engine.steps import make_eval_step

    act = model.head.act_func
    model.head.act_func = "none"
    batch = {"inputs": [torch.from_numpy(clip)]}
    if boxes is not None:
        batch["boxes"] = boxes
    try:
        logits = make_eval_step(cfg, model)(batch).float()
    finally:
        model.head.act_func = act
    proj = model.head.projection
    with torch.no_grad():
        k = logit_std / logits.std().item()
        proj.weight.mul_(k)
        proj.bias.mul_(k)


def cnn_fp32(make_cfg):
    """The full-width eval forward on one clip, card vs CPU, fp32, TF32 off."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = make_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    cpu_model = build_model(cfg, device="cpu")
    randomize_bn(cpu_model, 4)
    crop = cfg.DATA.TEST_CROP_SIZE
    clip = np.random.RandomState(11).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8)
    temper_logits(cpu_model, clip, cfg)
    want = make_eval_step(cfg, cpu_model)({"inputs": [torch.from_numpy(clip)]})
    gpu_model = build_model(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_eval_step(cfg, gpu_model)({"inputs": [torch.from_numpy(clip).cuda()]}).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = (got - want).abs().max().item()
    check(got.shape == (1, cfg.MODEL.NUM_CLASSES) and torch.isfinite(got).all().item(),
          f"bad output {got.shape}")
    check(want.max().item() < 0.5, f"saturated softmax {want.max().item()}")
    check(err <= FULL_WIDTH_ATOL, f"{cfg.MODEL.MODEL_NAME}: card vs CPU softmax err {err}")
    return {"max_abs_err": err, "atol": FULL_WIDTH_ATOL, "max_prob": want.max().item(),
            "argmax_equal": bool(got.argmax() == want.argmax()), "crop": crop,
            "frames": cfg.DATA.NUM_FRAMES, "params": sum(p.numel() for p in cpu_model.parameters())}


def cnn_train_steps(cfg, runs, n=CNN_TRAIN_CLIPS):
    """Train steps of ``n`` clips in bf16 on one seeded batch: ``runs`` is a
    list of (label, set_up) pairs, each set_up(model) called before its
    steps; the runs take turns, two turns each, and every turn starts from
    the same weights and optimizer state: one untimed step, then 3 timed.
    Each turn's first loss must be finite. Returns per label the p50 step
    ms, the peak memory and the losses."""
    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device="cuda")
    opt = construct_optimizer(model, cfg)
    step = make_train_step(cfg, model, opt, torch.Generator().manual_seed(cfg.RNG_SEED))
    start = ({k: v.clone() for k, v in model.state_dict().items()}, opt.state_dict())
    crop = cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"inputs": [torch.randint(0, 256, (n, cfg.DATA.NUM_FRAMES, crop, crop, 3),
                                      dtype=torch.uint8, device="cuda", generator=gen)],
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (n,), device="cuda",
                                     generator=gen),
             "epoch_exact": 0.0}
    out = {label: {"steps_ms": [], "losses": [], "max_memory_allocated": 0}
           for label, _ in runs}
    for _ in range(2):
        for label, set_up in runs:
            model.load_state_dict(start[0])
            opt.load_state_dict(start[1])
            set_up(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            for i in range(4):
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                if i:
                    out[label]["steps_ms"].append((time.perf_counter() - t0) * 1e3)
                out[label]["losses"].append(m["loss"].item())
            check(np.isfinite(out[label]["losses"][-4]),
                  f"{label}: non-finite loss {out[label]['losses']}")
            out[label]["max_memory_allocated"] = max(out[label]["max_memory_allocated"],
                                                     torch.cuda.max_memory_allocated())
            out[label]["launches"] = read_launches()
    for label, run in out.items():
        check(run["launches"]["preprocess_u8"] == 4 and only_launched(run["launches"], (), 0),
              f"{label}: launches {run['launches']}")
        run["step_p50_ms"] = statistics.median(run["steps_ms"])
        run["train_clips_per_s"] = n / run["step_p50_ms"] * 1e3
    return out


def fitting_train_steps(cfg, runs):
    """``cnn_train_steps`` at 16 clips, or at 8 if 16 run out of the card's
    memory; returns (clips, result)."""
    import gc

    try:
        return CNN_TRAIN_CLIPS, cnn_train_steps(cfg, runs)
    except torch.cuda.OutOfMemoryError:
        gc.collect()
        torch.cuda.empty_cache()
        return CNN_TRAIN_CLIPS // 2, cnn_train_steps(cfg, runs, CNN_TRAIN_CLIPS // 2)


def phase_cnn_family():
    """X3D-M (16 frames at 224²), I3D-NLN R50 (8 frames at 224², softmax
    non-local blocks in res3 and res4), CSN R101 (32 frames, channelwise
    3x3x3 convs) and R(2+1)D R50 (16 frames) at full width: the fp32 eval
    forward card vs CPU, and bf16 train steps of 16 clips (8 where 16 do
    not fit); X3D-M's with its channelwise convs on the channels_last_3d
    view (the default) and on a contiguous NCDHW copy (each channelwise
    ``Conv3D``'s forward swapped for ``ncdhw_forward`` in that run)."""
    import gc
    import types

    import torch.nn.functional as F

    from slowfast_tpu_torch.models.common import Conv3D, to_ncthw, to_nthwc

    def ncdhw_forward(self, x):
        """``Conv3D.forward`` on a contiguous NCDHW copy of the input."""
        b = self.bias.to(x.dtype) if self.bias is not None else None
        y = F.conv3d(to_ncthw(x).contiguous(), self.weight.to(x.dtype), b, self.stride,
                     self.padding, self.dilation, self.groups)
        return to_nthwc(y)

    def set_layout(ncdhw):
        def set_up(model):
            convs = [m for m in model.modules() if isinstance(m, Conv3D) and m.groups > 1]
            check(convs, "no channelwise conv")
            for m in convs:
                if ncdhw:
                    m.forward = types.MethodType(ncdhw_forward, m)
                else:
                    m.__dict__.pop("forward", None)
        return set_up

    rows = {}
    default = [("default", lambda model: None)]
    for name, yaml, opts, runs in (
            ("x3d_m", X3D_YAML, [], [("channels_last_3d", set_layout(False)),
                                     ("ncdhw", set_layout(True))]),
            ("i3d_nln", I3D_NLN_YAML, [], default),
            ("csn_r101", *CSN, default),
            ("r2plus1d_r50", *R2PLUS1D, default)):
        def make_cfg(extra, yaml=yaml, name=name, opts=opts):
            return slowfast_cfg(["NUM_GPUS", "1", "TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS)]
                                + opts + list(extra), yaml, os.path.join(OUT_DIR, name))
        fp32 = cnn_fp32(make_cfg)
        cfg = make_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
        clips, train = fitting_train_steps(cfg, runs)
        row = {"phase": "cnn_family", "model": name, "yaml": os.path.relpath(yaml, ROOT),
               "opts": opts, "fp32": fp32, "train_dtype": "bfloat16",
               "clips_per_step": clips, "train_frames": cfg.DATA.NUM_FRAMES,
               "train_crop": cfg.DATA.TRAIN_CROP_SIZE, "train": train}
        if name == "i3d_nln":
            row["nonlocal_blocks"] = cfg.NONLOCAL.LOCATION
        emit(row)
        rows[name] = row
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def count_conv_flops(model, step, batch):
    """Operations (2 per multiply-add) of every conv in one eval step, from
    the shapes the step gives them."""
    from slowfast_tpu_torch.models.common import Conv3D

    total = 0

    def hook(module, args, out):
        nonlocal total
        total += 2 * out.numel() * module.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv3D)]
    try:
        step(batch)
    finally:
        for h in handles:
            h.remove()
    return total


def phase_breakdown():
    """Where a test batch's time goes: the eval step alone on a batch that
    already lies on the card, and the loader alone (host clock, each
    measurement ending in a synchronize)."""
    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "syntheticvideo",
                        "DATA.SYNTHETIC_SIZE", "2", "TEST.BATCH_SIZE", "8"])
    model = build_model(cfg, device="cuda")
    step = make_eval_step(cfg, model)
    loader = construct_loader(cfg, "test", device="cuda")
    batches = iter(loader)
    batch = {"inputs": next(batches)[0]}
    batches.close()
    conv_flops = count_conv_flops(model, step, batch)
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    load_s = []
    t0 = time.perf_counter()
    for inputs, *_ in loader:
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    step_p50 = statistics.median(step_s[2:])
    emit({"phase": "breakdown", "batch_size": cfg.TEST.BATCH_SIZE,
          "eval_step_p50_ms": step_p50 * 1e3,
          "conv_gflop_per_batch": conv_flops / 1e9,
          "conv_tflop_per_s": conv_flops / step_p50 / 1e12,
          "bf16_peak_share": conv_flops / step_p50 / BF16_FLOP_PER_S,
          "loader_batch_p50_ms": statistics.median(load_s) * 1e3,
          "loader_workers": loader.num_workers, "loader_batches": len(load_s)})


DET_YAML = os.path.join(ROOT, "configs", "AVA", "SLOWFAST_32x2_R50_SHORT.yaml")
SLOW_DET_YAML = os.path.join(ROOT, "configs", "AVA", "SLOW_4x16_R50_DETECTION.yaml")
# ROIAlign kernel vs its plain version: the forward (and an fp32 backward)
# sums the same terms in another order, as a share of the output's max;
# a bf16 backward may round an element the other way (one bf16 rounding).
ROI_TOL = 1e-5
ROI_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
# det_train_slice's corpus: AVA's frames at short side 256, keyframes 902-917
# of 4 videos (64 train keyframes: 4 steps of 16 clips).
AVA_CORPUS = dict(num_videos=4, secs=range(902, 918), size=(455, 256), num_classes=80)


def det_cfg(extra, yaml=DET_YAML, out_dir=OUT_DIR):
    return slowfast_cfg(["NUM_GPUS", "1"] + list(extra), yaml, out_dir)


def synthetic_det_batch(cfg, n, bucket=8):
    """The first ``n`` consecutive synthetic detection items (the
    ``Syntheticvideo`` sampler: 1-5 boxes with multi-hot labels) whose
    largest box count pads to ``bucket``, collated:
    ``(clips_u8, labels, boxes, box_mask)`` as CPU tensors."""
    from slowfast_tpu_torch.data.kinetics import Syntheticvideo
    from slowfast_tpu_torch.data.loader import _box_bucket, detection_collate

    ds = Syntheticvideo(cfg, "train")
    counts = [ds[i][4]["boxes"].shape[0] for i in range(n + 64)]
    start = next(i for i in range(64) if _box_bucket(max(counts[i:i + n])) == bucket)
    inputs, labels, _, _, meta = detection_collate([ds[start + i] for i in range(n)])
    return (torch.from_numpy(inputs[0]), torch.from_numpy(labels),
            torch.from_numpy(meta["boxes"]), torch.from_numpy(meta["box_mask"]))


def roi_align_work(feats, rois, kw):
    """The bytes (each input read once, the output written once) and the
    operations of one ROIAlign forward and backward on these ROIs: a valid
    sample costs 4 taps of a multiply and an add per channel, a bin one
    division; the backward one multiply-add per channel for every (ROI,
    bin, row, column) whose separable weight is nonzero."""
    from slowfast_tpu_torch.ops import roi_align as ra

    B, H, W, C = feats.shape
    P = kw["output_size"]
    rois = rois.cpu().float()
    R = rois.shape[0]
    _, (y1, bh, gh), (x1, bw, gw), S = ra._geometry(
        rois, P, kw["spatial_scale"], kw["sampling_ratio"], kw["aligned"], 4)
    counts = {}
    for axis, (start, size, grid, n) in enumerate(((y1, bh, gh, H), (x1, bw, gw, W))):
        pos, inside = ra._positions(start, size, grid, P, S)
        valid = inside * ((pos >= -1.0) & (pos <= n)).float()  # (R, P, S)
        pc = pos.clamp(0.0, n - 1.0)
        hat = (1.0 - (pc[..., None] - torch.arange(n)).abs()).clamp(min=0.0)
        support = ((hat * valid[..., None]).sum(2) > 0).float()  # (R, P, n)
        counts[axis] = (valid.sum(2), support.sum(2))  # samples, rows per bin
    samples = (counts[0][0][:, :, None] * counts[1][0][:, None, :]).sum().item()
    taps = (counts[0][1].sum(1) * counts[1][1].sum(1)).sum().item()
    f_bytes = feats.numel() * feats.element_size()
    out_bytes = R * P * P * C * 4
    fwd = {"bytes": f_bytes + rois.numel() * 4 + out_bytes,
           "ops": (samples * 8 + R * P * P) * C}
    bwd = {"bytes": out_bytes + rois.numel() * 4 + f_bytes, "ops": taps * 2 * C}
    for w in (fwd, bwd):
        w["bound_ms"] = max(w["bytes"] / HBM_BYTES_PER_S, w["ops"] / FP32_FLOP_PER_S) * 1e3
        w["bound_by"] = ("bytes" if w["bytes"] / HBM_BYTES_PER_S >= w["ops"] / FP32_FLOP_PER_S
                         else "operations")
    return fwd, bwd


def roi_align_case(feats, rois, kw, rois_per_batch, seed, timed=False):
    """Both ROIAlign kernels against the plain version and autograd through
    it on one input; both bit-equal over two launches."""
    from slowfast_tpu_torch.ops import roi_align as ra

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = feats.detach().requires_grad_(True)
    out = ra.roi_align(f, rois, rois_per_batch=rois_per_batch, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    (grad,) = torch.autograd.grad(out, f, g)
    out2 = ra.roi_align(f, rois, rois_per_batch=rois_per_batch, **kw)
    (grad2,) = torch.autograd.grad(out2, f, g)
    plain = ra.roi_align_plain(f, rois, **kw)
    (plain_grad,) = torch.autograd.grad(plain, f, g, retain_graph=timed)
    check(out.dtype == plain.dtype == torch.float32 and grad.dtype == feats.dtype,
          f"dtypes {out.dtype} {grad.dtype}")
    fwd_err = (out - plain).abs().max().item()
    bwd_err = (grad.float() - plain_grad.float()).abs().max().item()
    row = {"shape": list(feats.shape), "rois": rois.shape[0], "dtype": str(feats.dtype)[6:],
           "aligned": kw["aligned"], "rois_per_batch": rois_per_batch,
           "fwd_err_share": fwd_err / plain.abs().max().item(),
           "bwd_err_share": bwd_err / plain_grad.float().abs().max().item(),
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
           "fwd_bit_equal": torch.equal(out, out2), "bwd_bit_equal": torch.equal(grad, grad2)}
    check(row["fwd_err_share"] <= ROI_TOL, f"ROIAlign forward differs: {row}")
    check(row["bwd_err_share"] <= ROI_BWD_TOL[feats.dtype], f"ROIAlign backward differs: {row}")
    check(row["fwd_bit_equal"] and row["bwd_bit_equal"], f"ROIAlign relaunch differs: {row}")
    if timed:
        args = (kw["output_size"], kw["spatial_scale"], kw["sampling_ratio"], kw["aligned"], 4)
        rois32 = rois.float().contiguous()
        with torch.no_grad():
            row["ms"] = device_ms(lambda: ra._launch_fwd(feats, rois32, *args))
            row["plain_ms"] = device_ms(lambda: ra.roi_align_plain(feats, rois, **kw))
            row["bwd_ms"] = device_ms(lambda: ra._launch_bwd(
                g, rois32, feats.shape, feats.dtype, rois_per_batch, *args))
        row["bwd_plain_ms"] = device_ms(
            lambda: torch.autograd.grad(plain, f, g, retain_graph=True))
        fwd, bwd = roi_align_work(feats, rois, kw)
        row.update(fwd_bound=fwd, bwd_bound=bwd)
    return row


def roi_edge_cases():
    """(name, feats (fp32, CPU), rois, kwargs): the maps and boxes off the
    main path, each given to the kernels in fp32 and bf16, with ROIs in no
    batch order (the backward's per-batch lists)."""
    rs = np.random.RandomState(7)
    kw = dict(output_size=7, spatial_scale=1.0 / 16, sampling_ratio=0, aligned=True)

    def boxes(n, B, crop):
        xy1 = rs.rand(n, 2) * (crop / 2)
        b = np.concatenate([rs.randint(0, B, (n, 1)), xy1, xy1 + rs.rand(n, 2) * (crop / 2)
                            + 2.0], axis=1)
        return b.astype(np.float32)

    cases = [
        ("map_16x16", rs.randn(4, 16, 16, 2048), boxes(24, 4, 256), kw),
        ("map_16x28", rs.randn(2, 16, 28, 256), boxes(12, 2, 448), kw),
        ("unaligned", rs.randn(2, 14, 14, 64), boxes(12, 2, 224), dict(kw, aligned=False)),
        ("cap_binds", rs.randn(2, 64, 64, 32),
         np.array([[0, 0, 0, 1024, 1024], [1, 30, 50, 900, 1000], [0, 100, 0, 800, 700]],
                  np.float32), kw),
        ("past_the_map", rs.randn(2, 14, 14, 64),
         np.array([[0, -60, -40, 100, 90], [1, 150, 170, 300, 320], [1, -200, 10, -20, 50],
                   [0, 230, 230, 260, 250]], np.float32), kw),
        ("c3", rs.randn(3, 14, 14, 3), boxes(10, 3, 224), kw),
        ("c257", rs.randn(2, 14, 14, 257), boxes(10, 2, 224), kw),
    ]
    return [(n, torch.from_numpy(f.astype(np.float32)), torch.from_numpy(r), k)
            for n, f, r, k in cases]


def phase_roi_align_kernel():
    """The ROIAlign kernels against their plain versions on the card: on the
    temporal means that a full-width SLOWFAST_32x2_R50_SHORT bf16 train
    forward at 16 clips hands its RoI head (slow (16, 14, 14, 2048), fast
    (16, 14, 14, 256)) at the synthetic sampler's 128 ROIs (bucket 8, zero
    rows included), with the device times, the plain times and the bounds;
    and on the edge cases in fp32 and bf16."""
    import gc

    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models import heads
    from slowfast_tpu_torch.models.build import build_model

    cfg = det_cfg(["TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS)])
    clips, _, boxes, _ = synthetic_det_batch(cfg, CNN_TRAIN_CLIPS)
    model = build_model(cfg, device="cuda")
    model.train()
    seen, real = [], heads.roi_align

    def recording(feats, rois, **kw):
        seen.append((feats.detach().clone(), rois.detach().clone(), kw))
        return real(feats, rois, **kw)

    heads.roi_align = recording
    try:
        with torch.no_grad():
            model(maybe_device_preprocess(cfg, [clips.cuda()]), boxes.cuda())
    finally:
        heads.roi_align = real
    del model
    gc.collect()
    torch.cuda.empty_cache()
    M = boxes.shape[1]
    main = []
    for p, (feats, rois, kw) in enumerate(seen):
        kw = {k: v for k, v in kw.items() if k != "rois_per_batch"}
        main.append(dict(roi_align_case(feats, rois, kw, M, p, timed=True),
                         pathway=("slow", "fast")[p]))
    check([r["shape"] for r in main] == [[CNN_TRAIN_CLIPS, 14, 14, 2048],
                                         [CNN_TRAIN_CLIPS, 14, 14, 256]]
          and all(r["rois"] == CNN_TRAIN_CLIPS * 8 for r in main), f"main path {main}")
    edges = []
    for i, (name, feats, rois, kw) in enumerate(roi_edge_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            edges.append(dict(roi_align_case(feats.cuda().to(dtype), rois.cuda(), kw, 0,
                                             100 + i), case=name))
    rows = main + edges
    per = {}
    for part, key in (("fwd", "ms"), ("bwd", "bwd_ms")):
        plain_key = "plain_ms" if part == "fwd" else "bwd_plain_ms"
        bounds = [r[f"{part}_bound"] for r in main]
        per[part] = {"ms": sum(r[key] for r in main), "plain_ms": sum(r[plain_key] for r in main),
                     "bound_ms": sum(b["bound_ms"] for b in bounds),
                     "bound_by": bounds[0]["bound_by"],
                     "bytes": sum(b["bytes"] for b in bounds),
                     "ops": sum(b["ops"] for b in bounds)}
        per[part]["bound_share"] = per[part]["bound_ms"] / per[part]["ms"]
    out = {"phase": "roi_align_kernel", "main_path": main,
           "edge_cases": edges, "cases_checked": len(rows),
           "bit_equal_relaunches": sum(r["fwd_bit_equal"] and r["bwd_bit_equal"] for r in rows),
           "max_fwd_err_share": max(r["fwd_err_share"] for r in rows),
           "max_bwd_err_share": {d: max([r["bwd_err_share"] for r in rows if r["dtype"] == d])
                                 for d in ("float32", "bfloat16")},
           "max_abs_err": {"fwd": max(r["fwd_max_abs_err"] for r in rows),
                           "bwd": max(r["bwd_max_abs_err"] for r in rows)},
           "per_forward": per, "bound_rate": "H100 SXM 3.35 TB/s, 67 TFLOP/s fp32"}
    emit(out)
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_det_fp32():
    """One train step of full-width SLOWFAST_32x2_R50_SHORT detection on 2
    synthetic uint8 clips (boxes padded to 8), card vs CPU on the same
    weights (every BN parameter and statistic random, the projection
    tempered), fp32 with TF32 off, dropout off: the masked bce loss, the
    eval predictions per box, the head's gradients and, by the float64
    yardstick of sf_train_fp32, all gradients; the same card step with TF32
    on must fail that limit."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = det_cfg(["TPU.COMPUTE_DTYPE", "float32", "MODEL.DROPOUT_RATE", "0.0",
                   "TRAIN.BATCH_SIZE", "2"])
    clip, labels, boxes, mask = synthetic_det_batch(cfg, 2)
    extra = {"boxes": boxes, "box_mask": mask}
    cpu_model = build_model(cfg, device="cpu")
    randomize_bn(cpu_model, 5)
    temper_logits(cpu_model, clip.numpy(), cfg, boxes=boxes)
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    want_preds = make_eval_step(cfg, cpu_model)({"inputs": [clip], "boxes": boxes})
    epoch_exact = 2.5  # mid-warmup: a nonzero LR
    t0 = time.perf_counter()
    want, want_grads, _ = train_one_step(cfg, cpu_model, clip, labels, epoch_exact, extra)
    cpu_s = time.perf_counter() - t0
    exact = float64_grads(cfg, state, clip, labels, extra)

    def card_step(allow_tf32):
        model = build_model(cfg, device="cuda")
        model.load_state_dict(state, strict=True)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            reset_launches()
            preds = make_eval_step(cfg, model)({"inputs": [clip.cuda()],
                                                "boxes": boxes.cuda()}).cpu()
            out = train_one_step(cfg, model, clip, labels, epoch_exact, extra)
            torch.cuda.synchronize()
            launches = read_launches()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        return (preds, *out, launches)

    preds, got, grads, _, launches = card_step(False)
    names = [n for n, p in cpu_model.named_parameters() if p.requires_grad]
    missing = [n for n in names if n not in grads or grads[n].abs().max().item() == 0.0]
    check(not missing, f"parameters with no or an all-zero gradient: {missing}")
    head = max((grads[n] - want_grads[n]).abs().max().item() / want_grads[n].abs().max().item()
               for n in names if n.startswith("head."))
    card_vs_f64, cpu_vs_f64 = rel_l2(grads, exact, names), rel_l2(want_grads, exact, names)
    loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
    pred_err = (preds - want_preds).abs().max().item()
    c_preds, c_got, c_grads = card_step(True)[:3]
    control = {"loss_rel_err": abs(c_got["loss"] - want["loss"]) / want["loss"],
               "pred_max_abs_err": (c_preds - want_preds).abs().max().item(),
               "card_vs_float64_grad_rel_l2": rel_l2(c_grads, exact, names)}
    control["fails"] = [k for k, bad in (
        ("loss", control["loss_rel_err"] > 1e-5), ("preds", control["pred_max_abs_err"] > 1e-4),
        ("grads", control["card_vs_float64_grad_rel_l2"] > 2.0 * cpu_vs_f64)) if bad]
    row = {"phase": "det_fp32", "clips": 2, "boxes_padded_to": boxes.shape[1],
           "real_boxes": int(mask.sum().item()), "frames": cfg.DATA.NUM_FRAMES,
           "crop": cfg.DATA.TRAIN_CROP_SIZE, "loss": got["loss"], "cpu_loss": want["loss"],
           "loss_rel_err": loss_err, "pred_max_abs_err": pred_err,
           "pred_range": [want_preds.min().item(), want_preds.max().item()],
           "grad_rel_l2_err": rel_l2(grads, want_grads, names),
           "card_vs_float64_grad_rel_l2": card_vs_f64, "cpu_vs_float64_grad_rel_l2": cpu_vs_f64,
           "max_head_grad_err_share": head, "head_grad_tol_share": TRAIN_GRAD_TOL_TAIL,
           "lr": got["lr"], "params_checked": len(names), "cpu_step_s": cpu_s,
           "launches": launches, "tf32_control": control}
    emit(row)
    check(loss_err <= 1e-5, f"loss {got['loss']} vs CPU {want['loss']}")
    check(pred_err <= 1e-4, f"eval predictions differ by {pred_err}")
    check(head <= TRAIN_GRAD_TOL_TAIL, f"head gradients differ by {head} of their max")
    check(card_vs_f64 <= 2.0 * cpu_vs_f64,
          f"gradients {card_vs_f64} from float64 (L2), the CPU's fp32 {cpu_vs_f64}")
    check("grads" in control["fails"], f"the gradient limit passes a TF32 step: {control}")
    check(launches["roi_align"] == 4 and launches["roi_align_bwd"] == 2
          and launches["preprocess_u8"] == 2, f"launches {launches}")
    return row


def phase_det_train_slice():
    """``run_net.main`` on SLOWFAST_32x2_R50_SHORT over an AVA corpus of JPEG
    frames that the phase writes with cv2 into a temporary directory: one
    epoch of 4 steps of 16 clips (bf16, the recipe's SGD, warmup and
    dropout), a val epoch scored by AVAMeter on the mini GT, the epoch-1
    checkpoint, then the test split on it (short side 224, centre crop) on
    the full GT; before it, the train loader alone. The ROIAlign kernels'
    launches must be 2 a forward batch and 2 a train step's backward. Then
    one bf16 16-clip SLOW_4x16_R50_DETECTION train step on bench.py:225's
    batch."""
    import gc
    import shutil
    import tempfile

    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise RuntimeError("det_train_slice needs cv2 on this host") from e
    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.data import construct_loader, synth_media
    from slowfast_tpu_torch.engine import tester, trainer
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(OUT_DIR, "det_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    root = tempfile.mkdtemp(prefix="ava_corpus_")
    try:
        t0 = time.perf_counter()
        corpus = synth_media.make_ava_corpus(root, workers=os.cpu_count() or 1, **AVA_CORPUS)
        corpus_s = time.perf_counter() - t0
        opts = ["NUM_GPUS", "1", "TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS), "SOLVER.MAX_EPOCH",
                "1", "DATA_LOADER.NUM_WORKERS", str(os.cpu_count() or 1), "OUTPUT_DIR",
                out_dir, *corpus]
        cfg = det_cfg(opts + ["TRAIN.ENABLE", "True"], out_dir=out_dir)

        loader = construct_loader(cfg, "train", device="cuda")
        loader.set_epoch(0)
        load_ms = []
        t0 = time.perf_counter()
        for _ in loader:
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()

        steps, models, evals = [], [], {"val": 0, "test": 0}
        make_step = trainer.make_train_step
        make_evals = {"val": trainer.make_eval_step, "test": tester.make_eval_step}

        def recording_make_step(cfg, model, optimizer, generator):
            models.append(model)
            step = make_step(cfg, model, optimizer, generator)

            def timed(batch):
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                              "clips": batch["labels"].shape[0],
                              "real_boxes": int(batch["box_mask"].sum().item()),
                              "boxes_padded_to": batch["boxes"].shape[1]})
                return m

            return timed

        def counting(split):
            def make(cfg, model):
                fn = make_evals[split](cfg, model)

                def counted(batch):
                    evals[split] += 1
                    return fn(batch)

                return counted

            return make

        trainer.make_train_step = recording_make_step
        trainer.make_eval_step, tester.make_eval_step = counting("val"), counting("test")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            run_net.main(["--cfg", DET_YAML, "--opts", *opts])
        finally:
            trainer.make_train_step = make_step
            trainer.make_eval_step, tester.make_eval_step = make_evals["val"], make_evals["test"]
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()

        with open(os.path.join(out_dir, "json_stats.log")) as f:
            logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
        val = [s for s in logged if s.get("_type") == "val_epoch"]
        test = [s for s in logged if s.get("mode") == "test" and "_type" not in s]
        check(len(steps) == 4 and all(s["clips"] == CNN_TRAIN_CLIPS for s in steps),
              f"steps {[s['clips'] for s in steps]}")
        check(all(np.isfinite(s["loss"]) for s in steps), f"non-finite loss: {steps}")
        check(len(val) == 1 and len(test) == 1 and np.isfinite(val[0]["map"])
              and np.isfinite(test[0]["map"]) and test[0]["map"] > 0.0,
              f"mAPs: val {val}, test {test}")
        forward_batches = len(steps) + evals["val"] + evals["test"]
        check(launches["roi_align"] == 2 * forward_batches
              and launches["roi_align_bwd"] == 2 * len(steps),
              f"ROIAlign launches {launches} for {len(steps)} steps and {evals} eval batches")
        check(launches["preprocess_u8"] == 0 and only_launched(launches, (), 0),
              f"the AVA path launched {launches}")

        # The checkpoint reloads into a fresh model with an identical eval output.
        path = cu.get_path_to_checkpoint(out_dir, 1)
        saved = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
        fresh = build_model(cfg, device="cuda")
        fresh.load_state_dict({k: v.cuda() for k, v in saved.items()}, strict=True)
        batches = iter(construct_loader(cfg, "test", device="cuda"))
        inputs, _, _, _, meta = next(batches)
        batches.close()  # stops the loader's workers
        batch = {"inputs": inputs, "boxes": meta["boxes"]}
        a = make_eval_step(cfg, models[0])(batch)
        b = make_eval_step(cfg, fresh)(batch)
        check(torch.equal(a, b), f"reloaded checkpoint differs: {(a - b).abs().max().item()}")
        ckpt_bytes = os.path.getsize(path)
        os.remove(path)
        del models[:], fresh, batch, inputs
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = [s["ms"] for s in steps]
    row = {"phase": "det_train_slice", "corpus": dict(AVA_CORPUS, secs=[902, 917],
                                                    write_s=corpus_s),
           "clips_per_step": CNN_TRAIN_CLIPS, "frames": cfg.DATA.NUM_FRAMES,
           "crop": cfg.DATA.TRAIN_CROP_SIZE, "dtype": cfg.TPU.COMPUTE_DTYPE,
           "dropout": cfg.MODEL.DROPOUT_RATE, "per_step": steps,
           "step_p50_ms": statistics.median(step_ms),
           "step_p50_ms_after_first": statistics.median(step_ms[1:]),
           "loader_batch_ms": load_ms, "loader_batch_p50_ms": statistics.median(load_ms),
           "max_memory_allocated": peak, "val_epoch": val[0], "test_map": test[0]["map"],
           "eval_batches": evals, "reload_identical": True, "checkpoint_bytes": ckpt_bytes,
           "train_wall_s": wall, "launches": launches,
           "slow_4x16_bench_step": slow_det_bench_step()}
    emit(row)
    return row


def slow_det_bench_step(steps=5):
    """bf16 train steps of SLOW_4x16_R50_DETECTION at 16 clips on the batch of
    bench.py:225 bench_ava_detection (boxes bucketed to 8, 1-8 real a clip,
    multi-hot labels at 0.1): the p50 of the steps after the first, and the
    peak memory."""
    import gc

    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    cfg = det_cfg(["TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS)], yaml=SLOW_DET_YAML)
    B, M = CNN_TRAIN_CLIPS, 8
    rs = np.random.RandomState(3)
    xy1 = rs.rand(B, M, 2).astype(np.float32) * 100
    wh = rs.rand(B, M, 2).astype(np.float32) * 100 + 4
    n_real = rs.randint(1, M + 1, (B,))
    batch = {
        "boxes": torch.from_numpy(np.concatenate([xy1, xy1 + wh], axis=-1)).cuda(),
        "box_mask": torch.from_numpy((np.arange(M)[None] < n_real[:, None]).astype(
            np.float32)).cuda(),
        "labels": torch.from_numpy((rs.rand(B, M, cfg.MODEL.NUM_CLASSES) < 0.1).astype(
            np.float32)).cuda(),
        "inputs": [torch.randint(0, 256, (B, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
                                          cfg.DATA.TRAIN_CROP_SIZE, 3), dtype=torch.uint8,
                                 device="cuda", generator=torch.Generator(
                                     device="cuda").manual_seed(3))],
        "epoch_exact": 0.5}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    step = make_train_step(cfg, model, construct_optimizer(model, cfg))
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    check(all(np.isfinite(losses)), f"SLOW_4x16 detection losses {losses}")
    out = {"clips": B, "boxes_padded_to": M, "real_boxes": int(n_real.sum()),
           "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
           "dtype": cfg.TPU.COMPUTE_DTYPE, "step_ms": ms, "step_p50_ms": statistics.median(ms[1:]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "losses": losses}
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- The rest of the MViT family: MViTv1-B, the ViT-B fine-tune, MViTv2-L
# with activation checkpointing, MViT detection --------------------------------

MVITV1_YAML = os.path.join(ROOT, "configs", "Kinetics", "MVIT_B_16x4_CONV.yaml")
VIT_YAML = os.path.join(ROOT, "configs", "masked_ssl", "k400_VIT_B_16x4_FT.yaml")
MVIT_L_YAML = os.path.join(ROOT, "configs", "Kinetics", "MVITv2_L_40x3_test.yaml")
VIT_TRAIN_CLIPS = 8  # the ViT-B FT recipe's TRAIN.BATCH_SIZE
# MViTv2-L's train step: 4 clips fit on the card with ACT_CHECKPOINT.
MVIT_L_TRAIN_CLIPS = 4
# The K400 MViTv2-L recipe is a test recipe and has no solver; its train
# steps take the SSv2 MViTv2-L recipe's (configs/SSv2/MVITv2_L_40x3.yaml).
MVIT_L_SOLVER = ["SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.00125",
                 "SOLVER.CLIP_GRAD_L2NORM", "2.0", "SOLVER.WEIGHT_DECAY", "1e-4",
                 "SOLVER.WARMUP_EPOCHS", "3.0", "SOLVER.WARMUP_START_LR", "1e-6",
                 "SOLVER.COSINE_AFTER_WARMUP", "True", "SOLVER.COSINE_END_LR", "1e-6",
                 "SOLVER.MAX_EPOCH", "40"]
# MViTv2-L's widths at depth 4: its first stage transition only.
MVIT_L_DEPTH4 = ["MVIT.DEPTH", "4", "MVIT.DIM_MUL", "[[2, 2.0]]", "MVIT.HEAD_MUL", "[[2, 2.0]]",
                 "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 1, 1], [2, 1, 2, 2], [3, 1, 1, 1]]"]


@contextlib.contextmanager
def removed_after(path):
    """Removes the directory ``path`` when the block ends, however it ends:
    a run's weights and optimizer state are too large to keep among its
    files."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def family_cfg(yaml, extra, sub):
    return slowfast_cfg(["NUM_GPUS", "1"] + list(extra), yaml, os.path.join(OUT_DIR, sub))


def per_clip(fn, *tensors):
    """``fn`` (a plain attention function) one clip at a time: it is the
    same function per batch element, and a clip's (nh, Nq, Nk) matrices fit
    where the whole batch's would not (MViTv2-L's first blocks at 4 clips:
    1.95e9 logits)."""
    for b in range(tensors[0].shape[0]):
        yield b, fn(*(t[b:b + 1] for t in tensors))


# Above this many logits (B nh Nq Nk) the plain attention versions run one
# clip at a time: MAE's decoder at 64 clips has 1.26e9, whose fp32
# intermediates would take tens of GB.
PLAIN_WHOLE_LOGITS = 2 ** 29


def plain_call(fn, q, k, *rest):
    """``fn`` (a plain attention function) on the whole batch, or clip by
    clip past ``PLAIN_WHOLE_LOGITS``, its outputs joined along the batch."""
    if attention_sizes(q, k, q)[0] <= PLAIN_WHOLE_LOGITS:
        return fn(q, k, *rest)
    outs = [out for _, out in per_clip(fn, q, k, *rest)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


class FlashShadow:
    """Inside ``with``, every call of the constant-shift core (kernel rows 6
    and 7) is also held against ``flash_plain`` and, in its backward,
    ``flash_bwd_plain`` on the inputs and output gradient that the model
    gave it (as mvit_train_fused's flash_shadow), one clip at a time: the
    output within ATTN_TOL of max |v| and each of dq, dk, dv within
    ATTN_BWD_TOL of its max. A checkpointed block calls the forward again
    in its recompute; that call is held too."""

    def __init__(self):
        self.stats = dict(fwd_calls=0, bwd_calls=0, fwd_err_share=0.0, bwd_err_share=0.0)

    def __enter__(self):
        from slowfast_tpu_torch.ops import attention as ta

        self.ta, self.kernel_core = ta, ta.flash_pooled_attention
        ta.flash_pooled_attention = self.core
        return self

    def __exit__(self, *exc):
        self.ta.flash_pooled_attention = self.kernel_core

    def core(self, qh, kh, vh):
        stats, ta = self.stats, self.ta
        out = self.kernel_core(qh, kh, vh)
        q, k, v = (t.detach() for t in (qh, kh, vh))
        vmax = v.float().abs().max().item()
        with torch.no_grad():
            for b, want in per_clip(ta.flash_plain, q, k, v):
                err = (out[b:b + 1].detach().float() - want.float()).abs().max().item()
                stats["fwd_err_share"] = max(stats["fwd_err_share"], err / vmax)
        stats["fwd_calls"] += 1

        def check_bwd(grad_inputs, grad_outputs):
            stats["bwd_calls"] += 1
            do = grad_outputs[0].contiguous()
            with torch.no_grad():
                want = [list(g) for _, g in per_clip(ta.flash_bwd_plain, q, k, v, do)]
                for g, w in zip(grad_inputs, zip(*want)):
                    w = torch.cat(w)
                    err = (g.float() - w.float()).abs().max().item()
                    stats["bwd_err_share"] = max(
                        stats["bwd_err_share"], err / max(w.float().abs().max().item(), 1e-30))

        if out.requires_grad:
            out.grad_fn.register_hook(check_bwd)
        return out

    def check(self, what, fwd_calls, bwd_calls, dtype=torch.bfloat16):
        s = self.stats
        check(s["fwd_calls"] == fwd_calls and s["bwd_calls"] == bwd_calls
              and s["fwd_err_share"] <= ATTN_TOL[dtype]
              and s["bwd_err_share"] <= ATTN_BWD_TOL[dtype],
              f"{what}: the flash kernels against their plain versions: {s}, expected "
              f"{fwd_calls} forward and {bwd_calls} backward calls")
        return s


def drive_train(yaml, opts, out_dir, expect_val=True, on_model=None):
    """``run_net.main`` training ``yaml`` with ``opts`` into ``out_dir`` on
    the card, every call of the flash kernels held by a ``FlashShadow``,
    every kernel count set to 0 just before and read just after; a val
    epoch must run when ``expect_val``, else none; ``on_model`` is called
    with the model before its first step. Returns the steps
    (clips, loss, grad norm, LR), the logged stats, the launches, the
    shadow's stats, the peak memory, the wall time and the trained model."""
    import gc
    import shutil

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine import trainer

    shutil.rmtree(out_dir, ignore_errors=True)
    steps, models, make_step = [], [], trainer.make_train_step

    def recording_make_step(cfg, model, optimizer, generator):
        models.append(model)
        if on_model is not None:
            on_model(model)
        step = make_step(cfg, model, optimizer, generator)

        def recorded(batch):
            m = step(batch)
            steps.append({"clips": batch["labels"].shape[0], "loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(), "lr": m["lr"]})
            return m

        return recorded

    argv = ["--cfg", yaml, "--opts", "NUM_GPUS", "1", "TRAIN.DATASET", "syntheticvideo",
            "SOLVER.MAX_EPOCH", "1", "TEST.ENABLE", "False", "OUTPUT_DIR", out_dir] + list(opts)
    trainer.make_train_step = recording_make_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with FlashShadow() as shadow:
            run_net.main(argv)
    finally:
        trainer.make_train_step = make_step
    wall = time.perf_counter() - t0
    launches = read_launches()
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps),
          f"non-finite loss: {steps}")
    types = [s["_type"] for s in logged]
    check("train_epoch" in types and ("val_epoch" in types) == expect_val, f"logged {types}")
    return dict(steps=steps, logged=logged, launches=launches, shadow=shadow,
                max_memory_allocated=torch.cuda.max_memory_allocated(), wall_s=wall,
                model=models[-1])


def uint8_train_batch(cfg, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    size = (n, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    return {"inputs": [torch.randint(0, 256, size, dtype=torch.uint8, device="cuda",
                                     generator=gen)],
            "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (n,), device="cuda",
                                    generator=gen),
            "epoch_exact": 0.5}


def timed_train_steps(cfg, batch, n):
    """``n`` bf16 train steps of a fresh model built from ``cfg`` on one batch
    already on the card, with no shadow (the measurement of the step):
    each step's host ms to a synchronize, the p50 of the steps after the
    first, and the peak memory."""
    import gc

    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda")
    step = make_train_step(cfg, model, construct_optimizer(model, cfg),
                           torch.Generator().manual_seed(cfg.RNG_SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    out = {"clips": batch["labels"].shape[0], "steps_ms": ms,
           "step_p50_ms": statistics.median(ms[1:]), "losses": losses,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def capture_attention(cfg, n, seed, calls=None):
    """The (q, k, v) that each block of one bf16 train-mode forward of the
    model built from ``cfg`` hands its constant-shift core, on ``n`` seeded
    clips (``calls`` of them, ``MVIT.DEPTH`` by default)."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import attention as ta

    model = build_model(cfg, device="cuda")
    model.train()
    clips = uint8_train_batch(cfg, n, seed)["inputs"][0]
    captured, core = [], ta.flash_pooled_attention

    def recording_core(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return core(q, k, v)

    ta.flash_pooled_attention = recording_core
    try:
        with torch.no_grad():
            model(maybe_device_preprocess(cfg, [clips]))
    finally:
        ta.flash_pooled_attention = core
    check(len(captured) == (calls or cfg.MVIT.DEPTH), f"captured {len(captured)} attention calls")
    del model
    return captured


def attention_shape_times(phase, captured):
    """At each distinct block shape of ``captured``: the constant-shift
    forward (row 6) and backward (row 7) kernels on the card beside their
    plain versions (device ms, max abs error), their bounds, SDPA's times
    and backends (forward and ``autograd.grad``), and the depth the forward
    pads q·kᵀ to. One line per shape; returns the totals over the blocks
    (per forward and per backward)."""
    from slowfast_tpu_torch.ops import attention as ta

    totals = {part: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                         library_fast_ms=0.0) for part in ("fwd", "bwd")}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    try:
        for blocks in group_blocks(captured):
            q, k, v = captured[blocks[0]]
            do = grad_out(q, v, 11)
            fwd = lambda: ta.flash_pooled_attention(q, k, v)  # noqa: E731
            bwd = lambda: ta._launch_bwd(q, k, v, do, exact=False)  # noqa: E731
            plain_fwd = lambda: plain_call(ta.flash_plain, q, k, v)  # noqa: E731
            plain_bwd = lambda: plain_call(ta.flash_bwd_plain, q, k, v, do)  # noqa: E731
            err_f = (fwd().float() - plain_fwd().float()).abs().max().item()
            err_b = max((g.float() - w.float()).abs().max().item()
                        for g, w in zip(bwd(), plain_bwd()))
            parts = {
                "fwd": dict(ms=device_ms(fwd), plain_ms=device_ms(plain_fwd),
                            **attention_bound(q, k, v), **sdpa_yardsticks(q, k, v),
                            max_abs_err=err_f),
                "bwd": dict(ms=device_ms(bwd), plain_ms=device_ms(plain_bwd),
                            **attention_bwd_bound(q, k, v), **sdpa_yardsticks(q, k, v, do),
                            max_abs_err=err_b)}
            for part, row in parts.items():
                row["roofline_share"] = row["bound_ms"] / row["ms"]
                max_err[part] = max(max_err[part], row["max_abs_err"])
                for key in totals[part]:
                    totals[part][key] += len(blocks) * row[key]
            emit({"phase": phase, "blocks": blocks, "B": q.shape[0], "Nq": q.shape[1],
                  "plain_per_clip": attention_sizes(q, k, v)[0] > PLAIN_WHOLE_LOGITS,
                  "Nk": k.shape[1], "nh": q.shape[2], "dq": q.shape[3], "dv": v.shape[3],
                  "fwd_qk_depth": min(d for d in ta._FWD_QK_DEPTHS if d >= q.shape[3]),
                  "dtype": str(q.dtype), **parts})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"per_forward": totals["fwd"], "per_backward": totals["bwd"], "max_abs_err": max_err}


def phase_mvitv1_train_slice():
    """``run_net.main`` training MViTv1-B 16x4 (``MVIT_B_16x4_CONV.yaml``) at
    full width and depth in bf16: the recipe's AdamW, mixup/cutmix,
    RandAugment, random erasing and clipping, 4 steps of 16 clips, a val
    epoch, the checkpoint; then the recipe's 10 x 1 test of 2 synthetic
    videos on that checkpoint; every flash call held. Also the step alone
    (unheld) and the attention kernels at its shapes."""
    cfg = family_cfg(MVITV1_YAML, [], "mvitv1")
    depth = cfg.MVIT.DEPTH
    out_dir = os.path.join(OUT_DIR, "mvitv1")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(MVITV1_YAML, ["DATA.SYNTHETIC_SIZE", "32", "TRAIN.BATCH_SIZE", "8"],
                          out_dir)
        launches, steps = run["launches"], run["steps"]
        check(len(steps) == 4 and all(s["clips"] == TRAIN_CLIPS for s in steps),
              f"steps {[s['clips'] for s in steps]}")
        check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
              and launches["attention_flash"] == depth * (4 + 4)
              and launches["attention_flash_bwd"] == depth * 4
              and launches["preprocess_u8"] == 4 + 4, f"train launches {launches}")
        shadow = run["shadow"].check("mvitv1 train", depth * (4 + 4), depth * 4)
        ckpt = os.path.join(out_dir, "checkpoints", "checkpoint_epoch_00001.pyth")
        check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")

        # The test loads the epoch-1 checkpoint, the last in OUTPUT_DIR.
        with FlashShadow() as test_shadow:
            test_row, test_launches = drive_test(
                "mvitv1_test", lambda extra: family_cfg(MVITV1_YAML, extra, "mvitv1"), out_dir, 2)
    check(only_launched(test_launches, ("attention_flash",), depth * test_row["batches"]),
          f"test launches {test_launches}")
    test_shadow.check("mvitv1 test", depth * test_row["batches"], 0)

    timing = timed_train_steps(family_cfg(MVITV1_YAML, ["TRAIN.BATCH_SIZE", "8"], "mvitv1"),
                               uint8_train_batch(cfg, TRAIN_CLIPS, 21), 5)
    attn = attention_shape_times("mvitv1_attn", capture_attention(cfg, TRAIN_CLIPS, 22))
    total = {k: launches[k] + test_launches[k] for k in launches}
    emit({"phase": "mvitv1_train_slice", "steps": len(steps), "clips_per_step": TRAIN_CLIPS,
          "per_step": steps, "val_epoch": [s for s in run["logged"]
                                           if s["_type"] == "val_epoch"][-1],
          "train_wall_s": run["wall_s"], "run_max_memory_allocated": run["max_memory_allocated"],
          "step_p50_ms": timing["step_p50_ms"], "steps_ms": timing["steps_ms"],
          "max_memory_allocated": timing["max_memory_allocated"],
          "train_clips_per_s": TRAIN_CLIPS / timing["step_p50_ms"] * 1e3,
          "flash_shadow_checks": shadow, "test_flash_shadow_checks": test_shadow.stats,
          "test": test_row, "attention": attn, "launches": total})
    return {"launches": total, "attention": attn}


def phase_mvitv1_fp32():
    """One train step of full-width MViTv1-B on 2 clips, card vs CPU on the
    same weights, fp32 with TF32 off (phase_mvit_train_fp32's limits: the
    loss within 1e-5, all gradients within 1e-3 relative L2, the
    structurally zero ones excepted); the card's flash calls held."""
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32", "AUG.NUM_SAMPLE", "1", "MIXUP.ENABLE", "False",
            "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]
    cfg = family_cfg(MVITV1_YAML, base, "mvitv1")
    depth = cfg.MVIT.DEPTH
    cpu_model = build_model(cfg, device="cpu")
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    clip = torch.from_numpy(np.random.RandomState(23).randint(
        0, 255, (2, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    ).astype(np.uint8))
    label = torch.tensor([17, 301])
    t0 = time.perf_counter()
    want, want_grads, _ = train_one_step(cfg, cpu_model, clip, label, 15.0)
    cpu_s = time.perf_counter() - t0
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_launches()
        with FlashShadow() as shadow:
            got, grads, _ = train_one_step(cfg, model, clip, label, 15.0)
            torch.cuda.synchronize()
        launches = read_launches()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    missing = [n for n, p in model.named_parameters() if p.requires_grad and (
        n not in grads or (grads[n].abs().max().item() == 0.0
                           and not structurally_zero(n, depth)))]
    check(not missing, f"parameters with no or an all-zero gradient: {missing}")
    names = [n for n in grads if not structurally_zero(n, depth)]
    shares = {n: (grads[n] - want_grads[n]).abs().max().item()
              / want_grads[n].abs().max().item() for n in names}
    l2_err = rel_l2(grads, want_grads, names)
    loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
    emit({"phase": "mvitv1_fp32", "clips": 2, "loss": got["loss"], "cpu_loss": want["loss"],
          "loss_rel_err": loss_err, "grad_rel_l2_err": l2_err, "grad_l2_tol": TRAIN_GRAD_L2_TOL,
          "worst_grad_err_shares": sorted(shares.items(), key=lambda kv: -kv[1])[:6],
          "median_grad_err_share": statistics.median(shares.values()),
          "params_checked": len(names), "cpu_step_s": cpu_s,
          "flash_shadow_checks": shadow.stats, "launches": launches})
    check(loss_err <= 1e-5, f"loss {got['loss']} vs CPU {want['loss']}")
    check(l2_err <= TRAIN_GRAD_L2_TOL, f"gradients differ by {l2_err} (L2)")
    check(only_launched(launches, FP32_CORE_KEYS["flash"], depth), f"launches {launches}")
    shadow.check("mvitv1 fp32", depth, depth, torch.float32)


def phase_vit_train_slice():
    """``run_net.main`` training the ViT-B fine-tune (``k400_VIT_B_16x4_FT
    .yaml``: 12 blocks of 768 channels and 12 heads over 1,568 patches and
    the cls token, no pooling, mean pooling) at full width and depth in
    bf16 with the recipe's AdamW and layer decay 0.65: 4 steps of 8 clips
    and a val epoch, every flash call held; the step alone (unheld); the
    attention kernels at its shape (Nq = Nk = 1,569, dq = dv = 64)."""
    cfg = family_cfg(VIT_YAML, [], "vit")
    depth = cfg.MVIT.DEPTH
    check(cfg.SOLVER.LAYER_DECAY == 0.65, f"layer decay {cfg.SOLVER.LAYER_DECAY}")
    per_video = VIT_TRAIN_CLIPS // cfg.AUG.NUM_SAMPLE
    out_dir = os.path.join(OUT_DIR, "vit")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(VIT_YAML, ["DATA.SYNTHETIC_SIZE", str(4 * per_video),
                                     "TRAIN.BATCH_SIZE", str(per_video)], out_dir)
    launches, steps = run["launches"], run["steps"]
    check(len(steps) == 4 and all(s["clips"] == VIT_TRAIN_CLIPS for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    # 4 train and 4 val batches (the val loader batches TRAIN.BATCH_SIZE videos).
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["attention_flash"] == depth * (4 + 4)
          and launches["attention_flash_bwd"] == depth * 4
          and launches["preprocess_u8"] == 4 + 4, f"launches {launches}")
    shadow = run["shadow"].check("vit train", depth * (4 + 4), depth * 4)
    timing = timed_train_steps(family_cfg(VIT_YAML, ["TRAIN.BATCH_SIZE", str(per_video)], "vit"),
                               uint8_train_batch(cfg, VIT_TRAIN_CLIPS, 24), 5)
    attn = attention_shape_times("vit_attn", capture_attention(cfg, VIT_TRAIN_CLIPS, 25))
    emit({"phase": "vit_train_slice", "steps": len(steps), "clips_per_step": VIT_TRAIN_CLIPS,
          "layer_decay": cfg.SOLVER.LAYER_DECAY, "per_step": steps,
          "val_epoch": [s for s in run["logged"] if s["_type"] == "val_epoch"][-1],
          "train_wall_s": run["wall_s"],
          "run_max_memory_allocated": run["max_memory_allocated"],
          "step_p50_ms": timing["step_p50_ms"], "steps_ms": timing["steps_ms"],
          "max_memory_allocated": timing["max_memory_allocated"],
          "train_clips_per_s": VIT_TRAIN_CLIPS / timing["step_p50_ms"] * 1e3,
          "flash_shadow_checks": shadow, "attention": attn, "launches": launches})
    return {"launches": launches, "attention": attn}


def phase_mvit_l_fit():
    """MViTv2-L 40x3 (``MVITv2_L_40x3_test.yaml``: 48 blocks, 144 -> 1152
    channels, 40 frames at 312², ``ACT_CHECKPOINT`` on) at full width and
    depth in bf16: 3 train steps at 4 clips with every flash call held, 3
    more unheld on the same model (step ms, peak memory), steps at 1 clip
    without checkpointing for comparison, and the 5 x 3 test of one
    synthetic video. At depth 4 with L's widths, the checkpointed and the
    plain step from the same state: equal losses, gradients within twice
    the distance of two plain steps."""
    import gc

    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    extra = ["TPU.COMPUTE_DTYPE", "bfloat16"] + MVIT_L_SOLVER
    cfg = family_cfg(MVIT_L_YAML, extra, "mvit_l")
    depth = cfg.MVIT.DEPTH
    check(cfg.MODEL.ACT_CHECKPOINT and depth == 48, "MViTv2-L recipe")
    batch = uint8_train_batch(cfg, MVIT_L_TRAIN_CLIPS, 26)
    model = build_model(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, model, construct_optimizer(model, cfg),
                           torch.Generator().manual_seed(cfg.RNG_SEED))
    losses = []
    reset_launches()
    with FlashShadow() as shadow:
        for _ in range(3):
            losses.append(step(batch)["loss"].item())
    torch.cuda.synchronize()
    launches = read_launches()
    check(all(np.isfinite(losses)), f"MViTv2-L losses {losses}")
    # Each checkpointed block's forward runs again in the backward's recompute.
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["attention_flash"] == 2 * depth * 3
          and launches["attention_flash_bwd"] == depth * 3
          and launches["preprocess_u8"] == 3, f"launches {launches}")
    shadow.check("mvit_l train", 2 * depth * 3, depth * 3)
    # The same step alone, unheld, on the same model: its time and memory.
    torch.cuda.reset_peak_memory_stats()
    steps_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(step(batch)["loss"].item())
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"MViTv2-L losses {losses}")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    one_clip = {"inputs": [batch["inputs"][0][:1]], "labels": batch["labels"][:1],
                "epoch_exact": batch["epoch_exact"]}
    plain_1 = timed_train_steps(family_cfg(MVIT_L_YAML, extra + ["MODEL.ACT_CHECKPOINT", "False"],
                                           "mvit_l"), one_clip, 3)

    with FlashShadow() as test_shadow:
        test_row, test_launches = drive_test(
            "mvit_l_test", lambda e: family_cfg(MVIT_L_YAML, e, "mvit_l"),
            os.path.join(OUT_DIR, "mvit_l"), 1)
    check(only_launched(test_launches, ("attention_flash",), depth * test_row["batches"]),
          f"test launches {test_launches}")
    test_shadow.check("mvit_l test", depth * test_row["batches"], 0)

    # Depth 4 at L's widths: checkpointed vs plain from one state.
    cfg4 = family_cfg(MVIT_L_YAML, extra + MVIT_L_DEPTH4, "mvit_l")
    cfg4_plain = family_cfg(MVIT_L_YAML, extra + MVIT_L_DEPTH4
                            + ["MODEL.ACT_CHECKPOINT", "False"], "mvit_l")
    state = {k: v.cpu() for k, v in build_model(cfg4, device="cuda").state_dict().items()}
    runs, grads = {}, {}
    # plain_again takes ATen's own max-pool backward: the run-to-run floor
    # the limit was set against (phase mvit_train_fused).
    with FlashShadow() as d4_shadow:
        for name, c, swap in (("plain", cfg4_plain, ()),
                              ("plain_again", cfg4_plain, _aten_pool_swap()),
                              ("checkpointed", cfg4, ())):
            runs[name], grads[name] = train_step_run(c, state, batch, swap)
    check(runs["checkpointed"]["loss"] == runs["plain"]["loss"]
          and np.isfinite(runs["plain"]["loss"]),
          f"depth 4: losses {[r['loss'] for r in runs.values()]}")
    floor = rel_l2(grads["plain_again"], grads["plain"], grads["plain"])
    ckpt_l2 = rel_l2(grads["checkpointed"], grads["plain"], grads["plain"])
    check(ckpt_l2 <= run_to_run_limit(floor, "mvit_l_depth4"),
          f"depth 4: checkpointed gradients {ckpt_l2} from plain, run-to-run {floor} (the "
          f"limit twice it, capped)")
    d4 = d4_shadow.check("mvit_l depth 4", sum(r["launches"]["attention_flash"]
                                              for r in runs.values()), 3 * 4)
    emit({"phase": "mvit_l_fit", "params": n_params, "clips_per_step": MVIT_L_TRAIN_CLIPS,
          "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
          "act_checkpoint": True, "losses": losses, "step_p50_ms": statistics.median(steps_ms),
          "steps_ms": steps_ms, "max_memory_allocated": peak,
          "train_clips_per_s": MVIT_L_TRAIN_CLIPS / statistics.median(steps_ms) * 1e3,
          "one_clip_no_checkpoint": plain_1,
          "flash_shadow_checks": shadow.stats, "test": test_row,
          "test_flash_shadow_checks": test_shadow.stats,
          "depth4": {"losses": {k: r["loss"] for k, r in runs.items()},
                     "checkpointed_vs_plain_grad_rel_l2": ckpt_l2,
                     "checkpointed_vs_plain_bit_equal": all(
                         torch.equal(grads["checkpointed"][n], grads["plain"][n])
                         for n in grads["plain"]),
                     "plain_again_vs_plain_grad_rel_l2": floor,
                     "peak_memory": {k: r["max_memory_allocated"] for k, r in runs.items()},
                     "flash_shadow_checks": d4},
          "launches": launches})
    total = {k: launches[k] + test_launches[k] for k in launches}
    return {"launches": total}


def phase_mvit_det():
    """MViTv2-S 16x4 with ``DETECTION.ENABLE`` at full width (AVA's head: 80
    classes, sigmoid, ``bce``; the 7 x 7 map at 1/32): one bf16 train step
    on ``synthetic_det_batch`` (16 clips, boxes padded to 8), every flash
    call held, and the ROIAlign launches."""
    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    cfg = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "DETECTION.ENABLE", "True",
                    "DETECTION.SPATIAL_SCALE_FACTOR", "32", "MODEL.NUM_CLASSES", "80",
                    "MODEL.HEAD_ACT", "sigmoid", "MODEL.LOSS_FUNC", "bce",
                    "MIXUP.ENABLE", "False"])
    depth = cfg.MVIT.DEPTH
    clips, labels, boxes, mask = synthetic_det_batch(cfg, CNN_TRAIN_CLIPS)
    batch = {"inputs": [clips.cuda()], "labels": labels.cuda(), "boxes": boxes.cuda(),
             "box_mask": mask.cuda(), "epoch_exact": 0.5}
    model = build_model(cfg, device="cuda")
    step = make_train_step(cfg, model, construct_optimizer(model, cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with FlashShadow() as shadow:
        m = step(batch)
        loss = m["loss"].item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    check(np.isfinite(loss), f"detection loss {loss}")
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), depth)
          and launches["roi_align"] == 1 and launches["roi_align_bwd"] == 1
          and launches["preprocess_u8"] == 1, f"launches {launches}")
    emit({"phase": "mvit_det", "clips": CNN_TRAIN_CLIPS, "boxes_padded_to": boxes.shape[1],
          "real_boxes": int(mask.sum().item()), "loss": loss, "held_step_ms": ms,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "flash_shadow_checks": shadow.check("mvit_det", depth, depth),
          "roi_align_launches": {k: launches[k] for k in ("roi_align", "roi_align_bwd")},
          "launches": launches})
    del model, step
    return {"launches": launches}


MASKFEAT_YAML = os.path.join(ROOT, "configs", "masked_ssl", "k400_MVITv2_S_16x4_MaskFeat_PT.yaml")
MAE_YAML = os.path.join(ROOT, "configs", "masked_ssl", "k400_VIT_B_16x4_MAE_PT.yaml")
# The recipes' TRAIN.BATCH_SIZE: MaskFeat's 32 is its global batch; MAE's
# 64 clips are its 8 cards x 8, here on one card.
MASKFEAT_TRAIN_CLIPS = 32
MAE_TRAIN_CLIPS = 64
MASKED_VIDEOS = 128
HOG_TOL = 1e-5


@contextlib.contextmanager
def masked_corpus():
    """``MASKED_VIDEOS`` mp4s of 340 x 256 at 30 fps, 100 frames each (the
    recipes' 16 frames at rate 4 span 64), written with cv2 into a
    temporary directory that is removed after; yields (directory, write
    seconds)."""
    import tempfile

    from slowfast_tpu_torch.data import synth_media

    root = tempfile.mkdtemp(prefix="masked_corpus_")
    try:
        t0 = time.perf_counter()
        synth_media.make_video_corpus(root, {"videos": MASKED_VIDEOS}, frames=100,
                                      size=(340, 256), fps=30, workers=os.cpu_count() or 1)
        yield root, time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)


def kinetics_split(corpus, name, n_train):
    """A data directory ``name`` in the corpus whose ``train.csv`` lists
    ``n_train`` clips of the corpus (each video as often as needed) and
    ``val.csv`` two; returns the run's data options."""
    videos = open(os.path.join(corpus, "videos.csv")).read().splitlines()
    data_dir = os.path.join(corpus, name)
    os.makedirs(data_dir, exist_ok=True)
    for split, n in (("train", n_train), ("val", 2)):
        with open(os.path.join(data_dir, f"{split}.csv"), "w") as f:
            f.writelines(videos[i % len(videos)] + "\n" for i in range(n))
    return ["TRAIN.DATASET", "kinetics", "DATA.PATH_TO_DATA_DIR", data_dir]


def reload_identical(model, cfg, out_dir):
    """The epoch-1 checkpoint of ``out_dir`` loads into a fresh model with
    weights equal to ``model``'s; returns the checkpoint's bytes."""
    from slowfast_tpu_torch.models.build import build_model

    path = cu_path(out_dir, cfg)
    check(os.path.exists(path), f"no checkpoint at {path}")
    fresh = build_model(cfg, device="cuda")
    fresh.load_state_dict(torch.load(path, map_location="cuda", weights_only=True)["model_state"],
                          strict=True)
    want = model.state_dict()
    for name, t in fresh.state_dict().items():
        check(torch.equal(t, want[name]), f"reloaded checkpoint differs at {name}")
    del fresh
    return os.path.getsize(path)


def loader_masks(cfg, n, epoch=0):
    """``n`` loader masks as the Kinetics items draw them, on the card."""
    from slowfast_tpu_torch.data.kinetics import gen_mask
    from slowfast_tpu_torch.data.utils import sample_rngs

    return torch.from_numpy(np.stack([gen_mask(cfg, *sample_rngs(cfg.RNG_SEED, epoch, i))
                                      for i in range(n)])).cuda()


def masked_blocks(cfg):
    """Attention calls of one masked forward: the trunk's blocks and the
    decoder's."""
    n_xf = cfg.MASK.DECODER_DEPTH if cfg.MASK.HEAD_TYPE.endswith("xformer") else 0
    return max(cfg.MASK.PRETRAIN_DEPTH) + 1 + n_xf * len(cfg.MASK.PRETRAIN_DEPTH)


def masked_train_run(name, yaml, clips, corpus, keep=None):
    """``run_net.main`` pretraining ``yaml`` for one epoch of 4 steps of
    ``clips`` decoded clips, every flash call held, then the checkpoint
    reloaded (and copied to ``keep`` when given); returns (cfg, blocks,
    run, checkpoint bytes)."""
    cfg = family_cfg(yaml, [], name)
    blocks = masked_blocks(cfg)
    check(cfg.TRAIN.BATCH_SIZE == clips and not cfg.MIXUP.ENABLE, f"{name} recipe")
    out_dir = os.path.join(OUT_DIR, name)
    opts = kinetics_split(corpus, name, 4 * clips)
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(yaml, opts, out_dir, expect_val=False)
        ckpt_bytes = reload_identical(run["model"], cfg, out_dir)
        if keep is not None:
            shutil.copyfile(cu_path(out_dir, cfg), keep)
    launches, steps = run["launches"], run["steps"]
    check(len(steps) == 4 and all(s["clips"] == clips for s in steps),
          f"{name} steps {[s['clips'] for s in steps]}")
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["attention_flash"] == blocks * 4
          and launches["attention_flash_bwd"] == blocks * 4
          and launches["preprocess_u8"] == 4, f"{name} launches {launches}")
    run["shadow"].check(f"{name} train", blocks * 4, blocks * 4)
    del run["model"]
    return cfg, blocks, run, ckpt_bytes


def masked_row(name, cfg, run, ckpt_bytes, timing, **extra):
    steps = run["steps"]
    return {"phase": name, "steps": len(steps), "clips_per_step": steps[0]["clips"],
            "per_step": steps, "train_wall_s": run["wall_s"],
            "run_max_memory_allocated": run["max_memory_allocated"],
            "logged_types": sorted({s["_type"] for s in run["logged"]}),
            "checkpoint_bytes": ckpt_bytes, "reload_identical": True,
            "step_p50_ms": timing["step_p50_ms"], "steps_ms": timing["steps_ms"],
            "max_memory_allocated": timing["max_memory_allocated"],
            "train_clips_per_s": timing["clips"] / timing["step_p50_ms"] * 1e3,
            "flash_shadow_checks": run["shadow"].stats, **extra,
            "launches": run["launches"]}


def cu_path(out_dir, cfg):
    """The epoch-1 checkpoint of the run in ``out_dir``."""
    from slowfast_tpu_torch.utils import checkpoint as cu

    return cu.get_path_to_checkpoint(out_dir, 1, cfg.TASK)


def phase_maskfeat_train_slice(corpus, keep=None):
    """MaskFeat pretraining on MViTv2-S at the recipe's 32 clips (its
    checkpoint copied to ``keep`` for finetune_slice); also the step alone
    and HOG's time a step."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.masked import MaskMViT
    from slowfast_tpu_torch.models.mvit import feature_geometry, mvit_block_schedule

    name, n = "maskfeat_train_slice", MASKFEAT_TRAIN_CLIPS
    cfg, blocks, run, ckpt_bytes = masked_train_run("maskfeat", MASKFEAT_YAML, n, corpus, keep)
    check(cfg.MASK.PRED_HOG and cfg.AUG.GEN_MASK_LOADER, "MaskFeat recipe")
    batch = uint8_train_batch(cfg, n, 31)
    batch["mask"] = loader_masks(cfg, n)
    timing = timed_train_steps(cfg, batch, 5)
    check(timing["max_memory_allocated"] < 70e9,
          f"MaskFeat at {n} clips takes {timing['max_memory_allocated']} bytes")
    x = maybe_device_preprocess(cfg, batch["inputs"])[0]
    ps = cfg.MVIT.PATCH_STRIDE
    thw = [cfg.DATA.NUM_FRAMES // ps[0], cfg.DATA.TRAIN_CROP_SIZE // ps[1],
           cfg.DATA.TRAIN_CROP_SIZE // ps[2]]
    (t_d, h_d, w_d), _ = feature_geometry(mvit_block_schedule(cfg), thw,
                                          max(cfg.MASK.PRETRAIN_DEPTH))
    hog_ms = device_ms(lambda: MaskMViT._hog_labels(x, t_d, h_d, w_d), iters=10)
    emit(masked_row(name, cfg, run, ckpt_bytes, timing, blocks=blocks,
                    mask_window=list(cfg.AUG.MASK_WINDOW_SIZE), mask_ratio=cfg.AUG.MASK_RATIO,
                    masked_share=batch["mask"].mean().item(),
                    hog={"frames": n * t_d, "feature_grid": [t_d, h_d, w_d], "ms": hog_ms,
                         "share_of_step": hog_ms / timing["step_p50_ms"]}))
    return {"launches": run["launches"]}


def phase_mae_train_slice(corpus):
    """MAE pretraining on ViT-B at the recipe's 64 clips; also the step
    alone and rows 6 and 7 at the encoder's and decoder's shapes."""
    name, n = "mae_train_slice", MAE_TRAIN_CLIPS
    cfg, blocks, run, ckpt_bytes = masked_train_run("mae", MAE_YAML, n, corpus)
    check(cfg.MASK.MAE_ON and cfg.SOLVER.BETAS == (0.9, 0.95)
          and cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR == 2.0, "MAE recipe")
    timing = timed_train_steps(cfg, uint8_train_batch(cfg, n, 32), 5)
    attn = attention_shape_times("mae_attn", capture_attention(cfg, n, 33, calls=blocks))
    emit(masked_row(name, cfg, run, ckpt_bytes, timing, blocks=blocks,
                    mask_ratio=cfg.AUG.MASK_RATIO, attention=attn))
    return {"launches": run["launches"], "attention": attn}


def hog_card_vs_cpu(x):
    """HOG of ``x`` (fp32 frames on the CPU) on the card and on the CPU. A
    pixel whose orientation bin differs (a flip) must sit within 1e-5 of a
    bin edge in float64; every HOG cell with no flipped pixel within
    HOG_TOL."""
    from slowfast_tpu_torch.ops.hog import hog_features, orientation_bins

    want, got = hog_features(x), hog_features(x.cuda()).cpu()
    bins = orientation_bins(x)[1]
    flipped = orientation_bins(x.cuda())[1].cpu() != bins
    xp = np.pad(x.double().numpy(), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    sm_v = xp[:, :-2] + 2.0 * xp[:, 1:-1] + xp[:, 2:]
    sm_h = xp[:, :, :-2] + 2.0 * xp[:, :, 1:-1] + xp[:, :, 2:]
    phase = np.arctan2(sm_v[:, :, :-2] - sm_v[:, :, 2:], sm_h[:, :-2] - sm_h[:, 2:]) / np.pi * 9
    edge = np.abs(phase - np.round(phase))[flipped.numpy()]
    check(edge.size == 0 or edge.max() < 1e-5,
          f"HOG: {edge.size} bins differ card vs CPU, up to {edge.max()} from a bin edge")
    # Cells (b, c, i, j) holding a flipped pixel; the others are held to HOG_TOL.
    B, H, W, C = x.shape
    cell_flip = flipped[:, :H // 8 * 8, :W // 8 * 8].reshape(B, H // 8, 8, W // 8, 8, C)
    cell_flip = cell_flip.any(dim=4).any(dim=2).permute(0, 3, 1, 2)[:, :, None]
    err = (got - want).abs()
    unflipped_err = err.masked_fill(cell_flip, 0.0).max().item()
    check(unflipped_err <= HOG_TOL, f"HOG card vs CPU: {unflipped_err}")
    return {"max_abs_err": err.max().item(), "max_abs_err_unflipped_cells": unflipped_err,
            "flipped_pixels": int(flipped.sum()), "pixels": flipped.numel(),
            "flip_max_edge_distance": float(edge.max()) if edge.size else None}


def masked_forward(cfg, model, clip, mask):
    """The eval forward of a masked model on ``clip`` (uint8, on the
    model's device) with ``mask``: (predictions, [(target, mask)])."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess

    model.eval()
    with torch.no_grad():
        return model(maybe_device_preprocess(cfg, [clip]), mask=mask)


def phase_masked_fp32():
    """One fp32 train step of each masked recipe on 2 clips, card (TF32
    off) vs CPU on the same weights, clips, loader masks (MaskFeat), mask
    noise (MAE) and HOG targets (the card's step reads the CPU's HOG of its
    frames, as it reads the same masks: fp32 atan2 rounds differently on
    the card at bin edges, `hog` below); every flash call of the card's
    step held. Beside it the eval forward with the card's own targets:
    predictions and targets card vs CPU, and its loss on its own and on
    the CPU's targets. HOG on the card against the CPU."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models import masked
    from slowfast_tpu_torch.models.build import build_model

    rows, failures = {}, []
    for name, yaml in (("maskfeat", MASKFEAT_YAML), ("mae", MAE_YAML)):
        cfg = family_cfg(yaml, ["TPU.COMPUTE_DTYPE", "float32"], name)
        blocks = masked_blocks(cfg)
        crop = cfg.DATA.TRAIN_CROP_SIZE
        clip = torch.from_numpy(np.random.RandomState(34).randint(
            0, 255, (2, cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8))
        extra = {"mask": loader_masks(cfg, 2).cpu()} if cfg.AUG.GEN_MASK_LOADER else {}
        ps = cfg.MVIT.PATCH_STRIDE
        tokens = cfg.DATA.NUM_FRAMES // ps[0] * (crop // ps[1]) * (crop // ps[2])
        noise = torch.from_numpy(np.random.RandomState(35).rand(2, tokens).astype(np.float32))
        draw, hog_labels = masked.uniform_noise, masked.MaskMViT._hog_labels
        masked.uniform_noise = lambda shape, generator, device: noise.reshape(shape).to(device)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        try:
            cpu_model = build_model(cfg, device="cpu")
            state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
            cpu_fwd = masked_forward(cfg, cpu_model, clip, extra.get("mask"))
            t0 = time.perf_counter()
            want, want_grads, _ = train_one_step(cfg, cpu_model, clip,
                                                 torch.zeros(2, dtype=torch.long), 5.0, extra)
            cpu_s = time.perf_counter() - t0
            model = build_model(cfg, device="cuda")
            model.load_state_dict(state, strict=True)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            mask = extra["mask"].cuda() if extra else None
            card_fwd = masked_forward(cfg, model, clip.cuda(), mask)
            masked.MaskMViT._hog_labels = staticmethod(
                lambda x, *grid: hog_labels(x.cpu(), *grid).to(x.device))
            reset_launches()
            with FlashShadow() as shadow:
                got, grads, _ = train_one_step(cfg, model, clip,
                                               torch.zeros(2, dtype=torch.long), 5.0, extra)
                torch.cuda.synchronize()
            launches = read_launches()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            masked.uniform_noise = draw
            masked.MaskMViT._hog_labels = staticmethod(hog_labels)
        (cpu_preds, cpu_labels), (card_preds, card_labels) = cpu_fwd, card_fwd
        card_preds = [p.cpu() for p in card_preds]
        card_labels = [(t.cpu(), m.cpu()) for t, m in card_labels]
        cpu_eval_loss = masked.masked_loss(cpu_preds, cpu_labels).item()
        forward = {
            "pred_max_abs_err": max((a - b).abs().max().item()
                                    for a, b in zip(card_preds, cpu_preds)),
            "pred_rel_l2_err": max(((a - b).norm() / b.norm()).item()
                                   for a, b in zip(card_preds, cpu_preds)),
            "target_max_abs_err": max((a[0] - b[0]).abs().max().item()
                                      for a, b in zip(card_labels, cpu_labels)),
            "masks_equal": all(torch.equal(a[1], b[1]) for a, b in zip(card_labels, cpu_labels)),
            "eval_loss_rel_err": abs(masked.masked_loss(card_preds, card_labels).item()
                                     - cpu_eval_loss) / cpu_eval_loss,
            "eval_loss_rel_err_cpu_targets": abs(
                masked.masked_loss(card_preds, cpu_labels).item() - cpu_eval_loss)
            / cpu_eval_loss}
        missing = [n for n, p in model.named_parameters() if n not in grads]
        l2_err = rel_l2(grads, want_grads, list(grads))
        loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
        rows[name] = {"blocks": blocks, "loss": got["loss"], "cpu_loss": want["loss"],
                      "loss_rel_err": loss_err, "grad_rel_l2_err": l2_err,
                      "grad_l2_tol": TRAIN_GRAD_L2_TOL, "lr": got["lr"], "forward": forward,
                      "params_checked": len(grads), "cpu_step_s": cpu_s,
                      "flash_shadow_checks": shadow.stats, "launches": launches}
        for ok, msg in ((not missing, f"{name}: parameters with no gradient: {missing}"),
                        (forward["masks_equal"], f"{name}: masks differ card vs CPU"),
                        (loss_err <= 1e-5, f"{name}: loss {got['loss']} vs CPU {want['loss']}"),
                        (l2_err <= TRAIN_GRAD_L2_TOL, f"{name}: gradients differ by {l2_err}"),
                        (only_launched(launches, FP32_CORE_KEYS["flash"], blocks),
                         f"{name}: {launches}")):
            if not ok:
                failures.append(msg)
        try:
            shadow.check(f"{name} fp32", blocks, blocks, torch.float32)
        except RuntimeError as e:
            failures.append(str(e))
        del model, cpu_model
    cfg = family_cfg(MASKFEAT_YAML, ["TPU.COMPUTE_DTYPE", "float32"], "maskfeat")
    x = maybe_device_preprocess(cfg, [torch.from_numpy(np.random.RandomState(34).randint(
        0, 255, (2, 16, 224, 224, 3)).astype(np.uint8))])[0]
    try:
        hog = hog_card_vs_cpu(x.reshape(-1, *x.shape[2:]))
    except RuntimeError as e:
        hog = {"failed": str(e)}
        failures.append(str(e))
    emit({"phase": "masked_fp32", "clips": 2, **rows, "hog": hog, "hog_tol": HOG_TOL})
    check(not failures, f"masked_fp32: {failures}")


REV_YAML = os.path.join(ROOT, "configs", "Kinetics", "REV_MVIT_B_16x4_CONV.yaml")
MVITV2_FT_YAML = os.path.join(ROOT, "configs", "masked_ssl", "k400_MVITv2_S_16x4_FT.yaml")
# Rev-MViT-B at depth 24: the 8 extra blocks land in the 384-wide stage
# (8 x 14 x 14 = 1,568 tokens a clip), its stage-4 entries moved from 14 to 22.
REV_DEPTH24 = ["MVIT.DEPTH", "24", "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0], [22, 2.0]]",
               "MVIT.HEAD_MUL", "[[1, 2.0], [3, 2.0], [22, 2.0]]",
               "MVIT.POOL_Q_STRIDE", "[[1, 1, 2, 2], [3, 1, 2, 2], [22, 1, 2, 2]]",
               "MVIT.REV.BUFFER_LAYERS", "[1, 3, 22]"]
# The reversible path's activation growth per extra block, as a share of
# the checkpointed path's, must stay under this.
REV_GROWTH_SHARE = 0.05
FINETUNE_CLIPS = 16  # TRAIN.BATCH_SIZE 8 x AUG.NUM_SAMPLE 2


def rev_launches_per_step(cfg):
    """Row-6 forwards and row-7 backwards of one Rev-MViT train step: each
    transition's forward once, each reversible block's twice (its forward
    and its rebuild); one backward a block."""
    n_rev = cfg.MVIT.DEPTH - len(cfg.MVIT.REV.BUFFER_LAYERS)
    return cfg.MVIT.DEPTH + n_rev, cfg.MVIT.DEPTH


def eval_identical(model, cfg, path):
    """A fresh model loaded from the checkpoint ``path`` gives ``model``'s
    eval output, bit for bit, on a seeded batch of 8 clips."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    fresh = build_model(cfg, device="cuda")
    fresh.load_state_dict(torch.load(path, map_location="cuda", weights_only=True)["model_state"],
                          strict=True)
    batch = {"inputs": uint8_train_batch(cfg, 8, 41)["inputs"]}
    same = torch.equal(make_eval_step(cfg, model)(batch), make_eval_step(cfg, fresh)(batch))
    del fresh
    return same


def phase_rev_mvit_train_slice():
    """``run_net.main`` training Rev-MViT-B 16x4 (``REV_MVIT_B_16x4_CONV
    .yaml``: 16 layers, transitions at [1, 3, 14], the reversible backward)
    at full width and depth in bf16 on synthetic video: 4 steps of 16 clips
    with the recipe's AdamW, mixup/cutmix, RandAugment and random erasing,
    a val epoch, the checkpoint (reloaded: identical eval output), then the
    5 x 1 test of 2 videos on it; every call of rows 6 and 7 held against
    flash_plain / flash_bwd_plain, the rebuilds' included; 29 forwards and
    16 backwards a step. Also the step alone, unheld (p50, peak memory)."""
    cfg = family_cfg(REV_YAML, [], "rev_mvit")
    depth = cfg.MVIT.DEPTH
    fwd, bwd = rev_launches_per_step(cfg)
    check(depth == 16 and (fwd, bwd) == (29, 16) and cfg.TPU.REV_BACKPROP
          and not cfg.MVIT.CLS_EMBED_ON, "Rev-MViT recipe")
    out_dir = os.path.join(OUT_DIR, "rev_mvit")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(REV_YAML, ["DATA.SYNTHETIC_SIZE", "32", "TRAIN.BATCH_SIZE", "8"],
                          out_dir)
        launches, steps = run["launches"], run["steps"]
        check(len(steps) == 4 and all(s["clips"] == TRAIN_CLIPS for s in steps),
              f"steps {[s['clips'] for s in steps]}")
        # 4 train steps and 4 val batches (one forward a block).
        check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
              and launches["attention_flash"] == fwd * 4 + depth * 4
              and launches["attention_flash_bwd"] == bwd * 4
              and launches["preprocess_u8"] == 4 + 4, f"train launches {launches}")
        shadow = run["shadow"].check("rev_mvit train", fwd * 4 + depth * 4, bwd * 4)
        identical = eval_identical(run["model"], cfg, cu_path(out_dir, cfg))
        check(identical, "the reloaded checkpoint's eval output differs")
        del run["model"]
        with FlashShadow() as test_shadow:
            test_row, test_launches = drive_test(
                "rev_mvit_test", lambda extra: family_cfg(REV_YAML, extra, "rev_mvit"), out_dir, 2)
    check(only_launched(test_launches, ("attention_flash",), depth * test_row["batches"]),
          f"test launches {test_launches}")
    test_shadow.check("rev_mvit test", depth * test_row["batches"], 0)
    timing = timed_train_steps(family_cfg(REV_YAML, ["TRAIN.BATCH_SIZE", "8"], "rev_mvit"),
                               uint8_train_batch(cfg, TRAIN_CLIPS, 42), 5)
    total = {k: launches[k] + test_launches[k] for k in launches}
    emit({"phase": "rev_mvit_train_slice", "steps": len(steps), "clips_per_step": TRAIN_CLIPS,
          "per_step": steps, "flash_fwd_per_step": fwd, "flash_bwd_per_step": bwd,
          "val_epoch": [s for s in run["logged"] if s["_type"] == "val_epoch"][-1],
          "reload_identical": identical, "train_wall_s": run["wall_s"],
          "run_max_memory_allocated": run["max_memory_allocated"],
          "step_p50_ms": timing["step_p50_ms"], "steps_ms": timing["steps_ms"],
          "max_memory_allocated": timing["max_memory_allocated"],
          "train_clips_per_s": TRAIN_CLIPS / timing["step_p50_ms"] * 1e3,
          "flash_shadow_checks": shadow, "test_flash_shadow_checks": test_shadow.stats,
          "test": test_row, "launches": total})
    return {"launches": total}


def rev_model(cfg, mode):
    """Rev-MViT on the card; ``mode`` "plain" runs its reversible blocks
    with neither the reversible backward nor checkpointing (every
    intermediate kept), the yardstick of the activation memory."""
    import types

    from slowfast_tpu_torch.models.build import build_model

    model = build_model(cfg, device="cuda")
    if mode == "plain":
        def plain_span(self, idx, x1, x2, thws):
            for i in idx:
                x1, x2 = self.layers[i](x1, x2, thws[i])
            return x1, x2

        model.rev_backbone._run_span = types.MethodType(plain_span, model.rev_backbone)
    return model


def rev_activation_bytes(cfg, batch, mode):
    """The activation memory of one bf16 train step, after a first step (the
    optimizer state and the parameter gradients exist; the gradients,
    zeroed, are accumulated into in place, so they count as before the
    forward): ``held_bytes``, what the forward leaves allocated for the
    backward, and ``activation_bytes``, the peak ``max_memory_allocated`` of
    the forward and backward, each minus what is allocated just before the
    forward."""
    import gc

    from slowfast_tpu_torch.engine.steps import make_train_step, maybe_device_preprocess
    from slowfast_tpu_torch.solver.losses import get_loss_func
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    model = rev_model(cfg, mode)
    step = make_train_step(cfg, model, construct_optimizer(model, cfg),
                           torch.Generator().manual_seed(cfg.RNG_SEED))
    step(batch)
    inputs = maybe_device_preprocess(cfg, batch["inputs"])
    loss_fun = get_loss_func(cfg.MODEL.LOSS_FUNC)
    for p in model.parameters():
        p.grad.zero_()
    model.train()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = loss_fun(model(inputs), batch["labels"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    loss.backward()
    torch.cuda.synchronize()
    out = {"held_bytes": held, "activation_bytes": torch.cuda.max_memory_allocated() - before,
           "allocated_before_forward": before, "loss": loss.item()}
    check(np.isfinite(out["loss"]), f"non-finite loss {out}")
    del model, step, loss
    return out


def rev_rebuild_errors(cfg, batch):
    """One bf16 train forward and backward with each reversible block's F
    and G inputs recorded in the forward and in the rebuild; per span, the
    worst relative L2 error of the rebuilt x2 (F's input) and y1 (G's
    input) against the forward's."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.reversible import ReversibleBlock
    from slowfast_tpu_torch.solver.losses import get_loss_func

    model = rev_model(cfg, "rev")
    model.train()
    seen = {}
    spans, span = [], []
    for i, blk in enumerate(model.rev_backbone.layers):
        if not isinstance(blk, ReversibleBlock):
            spans, span = spans + [span] * bool(span), []
            continue
        span.append(i)
        f, g = blk.f, blk.g

        def rec_f(x2, thw, i=i, f=f):
            seen.setdefault((i, "x2"), []).append(x2.detach().float().clone())
            return f(x2, thw)

        def rec_g(y1, i=i, g=g):
            seen.setdefault((i, "y1"), []).append(y1.detach().float().clone())
            return g(y1)

        blk.f, blk.g = rec_f, rec_g
    spans += [span] * bool(span)
    inputs = maybe_device_preprocess(cfg, batch["inputs"])
    get_loss_func(cfg.MODEL.LOSS_FUNC)(model(inputs), batch["labels"]).backward()
    rows = []
    for idx in spans:
        row = {"blocks": idx}
        for what in ("x2", "y1"):
            errs = {}
            for i in idx:
                fwd, rebuilt = seen[(i, what)]
                errs[i] = ((rebuilt - fwd).norm() / fwd.norm()).item()
            worst = max(errs, key=errs.get)
            row[what] = {"worst_block": worst, "rel_l2": errs[worst]}
        rows.append(row)
    del model, seen
    return rows


def phase_rev_mvit_memory():
    """Activation memory of Rev-MViT-B at full width, 16 clips, bf16: the
    reversible backward, the checkpointed fallback (``TPU.REV_BACKPROP
    False``) and no checkpointing at all, at depth 16 and at depth 24 (8
    more blocks in the 384-wide stage). The reversible path's growth per
    extra block of the memory held for the backward must stay under 5% of
    the checkpointed path's, which keeps two 16 x 1,568 x 384 bf16 streams
    a block. (The peak is reported too: it falls in the 25,088-token first
    stage, before the extra blocks' streams exist, and grows with neither.)
    Also the rebuilt inputs' error against the forward's, per span."""
    opts = ["MIXUP.ENABLE", "False", "MODEL.LOSS_FUNC", "cross_entropy", "TRAIN.BATCH_SIZE", "8"]
    rows = {}
    for depth, extra in ((16, []), (24, REV_DEPTH24)):
        for mode in ("rev", "checkpoint", "plain"):
            cfg = family_cfg(REV_YAML, opts + extra + ["TPU.REV_BACKPROP", str(mode == "rev")],
                             "rev_mvit")
            check(cfg.MVIT.DEPTH == depth, f"depth {cfg.MVIT.DEPTH}")
            rows[f"{mode}_{depth}"] = rev_activation_bytes(
                cfg, uint8_train_batch(cfg, TRAIN_CLIPS, 43), mode)
    growth, peak_growth = ({mode: (rows[f"{mode}_24"][key] - rows[f"{mode}_16"][key]) / 8
                            for mode in ("rev", "checkpoint", "plain")}
                           for key in ("held_bytes", "activation_bytes"))
    cfg = family_cfg(REV_YAML, opts, "rev_mvit")
    errors = rev_rebuild_errors(cfg, uint8_train_batch(cfg, TRAIN_CLIPS, 44))
    share = growth["rev"] / growth["checkpoint"]
    emit({"phase": "rev_mvit_memory", "clips": TRAIN_CLIPS, "dtype": "bfloat16", **rows,
          "held_growth_per_block": growth, "peak_growth_per_block": peak_growth,
          "rev_over_checkpoint_growth": share,
          "growth_share_limit": REV_GROWTH_SHARE,
          "two_streams_bytes": 2 * TRAIN_CLIPS * 1568 * 384 * 2, "rebuild_errors": errors})
    check(growth["checkpoint"] > 0 and share < REV_GROWTH_SHARE,
          f"reversible held-memory growth {growth['rev']} per block against the "
          f"checkpointed {growth['checkpoint']}")


def phase_rev_mvit_fp32():
    """One fp32 train step of full-width Rev-MViT-B on 2 clips, card (TF32
    off) against the CPU on the same weights: the loss within 1e-5, the
    gradients within 1e-3 relative L2; on the card, the reversible backward
    against the checkpointed fallback within the same limits. Every flash
    call held; 29 FMA forwards and 16 FMA backwards a step."""
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32", "AUG.NUM_SAMPLE", "1", "MIXUP.ENABLE", "False",
            "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]
    cfg = family_cfg(REV_YAML, base, "rev_mvit")
    depth = cfg.MVIT.DEPTH
    fwd, bwd = rev_launches_per_step(cfg)
    cpu_model = build_model(cfg, device="cpu")
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    clip = torch.from_numpy(np.random.RandomState(27).randint(
        0, 255, (2, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    ).astype(np.uint8))
    label = torch.tensor([17, 301])
    t0 = time.perf_counter()
    want, want_grads, _ = train_one_step(cfg, cpu_model, clip, label, 15.0)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    card = {}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for rev in (True, False):
            model = build_model(family_cfg(REV_YAML, base + ["TPU.REV_BACKPROP", str(rev)],
                                           "rev_mvit"), device="cuda")
            model.load_state_dict(state, strict=True)
            reset_launches()
            with FlashShadow() as shadow:
                got, grads, _ = train_one_step(cfg, model, clip, label, 15.0)
                torch.cuda.synchronize()
            card[rev] = (got, grads, read_launches(), shadow)
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got, grads, launches, shadow = card[True]
    # A bias on every key shifts a logit row by a constant: norm_k.bias's
    # gradient is zero in exact arithmetic.
    missing = [n for n in state if n not in grads or (
        grads[n].abs().max().item() == 0.0 and not n.endswith("norm_k.bias"))]
    names = [n for n in grads if not n.endswith("norm_k.bias")]
    loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
    l2_err = rel_l2(grads, want_grads, names)
    off, off_grads, off_launches, off_shadow = card[False]
    off_loss_err = abs(off["loss"] - got["loss"]) / got["loss"]
    off_l2 = rel_l2(grads, off_grads, names)
    emit({"phase": "rev_mvit_fp32", "clips": 2, "loss": got["loss"], "cpu_loss": want["loss"],
          "loss_rel_err": loss_err, "grad_rel_l2_err": l2_err, "grad_l2_tol": TRAIN_GRAD_L2_TOL,
          "fallback_loss_rel_err": off_loss_err, "rev_vs_fallback_grad_rel_l2": off_l2,
          "params_checked": len(names), "cpu_step_s": cpu_s,
          "flash_shadow_checks": shadow.stats, "fallback_flash_shadow_checks": off_shadow.stats,
          "launches": launches, "fallback_launches": off_launches})
    check(not missing, f"parameters with no or an all-zero gradient: {missing}")
    check(loss_err <= 1e-5, f"loss {got['loss']} vs CPU {want['loss']}")
    check(l2_err <= TRAIN_GRAD_L2_TOL, f"gradients differ from the CPU's by {l2_err} (L2)")
    check(off_loss_err <= 1e-5 and off_l2 <= TRAIN_GRAD_L2_TOL,
          f"reversible vs checkpointed: loss {off_loss_err}, gradients {off_l2}")
    for lc, sh in ((launches, shadow), (off_launches, off_shadow)):
        check(only_launched(lc, FP32_CORE_KEYS["flash"], None)
              and lc["attention_flash_fma"] == fwd and lc["attention_flash_fma_bwd"] == bwd,
              f"launches {lc}")
        sh.check("rev_mvit fp32", fwd, bwd, torch.float32)
    check(depth == 16, "depth")


def phase_finetune_slice(corpus, pt_ckpt):
    """``run_net.main`` fine-tuning MViTv2-S (``k400_MVITv2_S_16x4_FT.yaml``:
    ``CHECKPOINT_EPOCH_RESET``, layer decay 0.75, AdamW, mixup) at full
    width and depth in bf16 from ``pt_ckpt``, the checkpoint that
    maskfeat_train_slice wrote: 4 steps of 16 clips decoded from the mp4
    corpus and a val epoch. Before the first step every tensor the load
    wrote equals the checkpoint's bit for bit, or, where the shapes differ
    (block 15's rel-pos tables: MaskFeat keeps the 14² grid there), its
    resize by ``_surgery_convert``; the load's counts are
    ``FINETUNE_COUNTS``; the run starts at epoch 0; every flash call held."""
    from slowfast_tpu_torch.utils import checkpoint as cu

    cfg = family_cfg(MVITV2_FT_YAML, ["TRAIN.BATCH_SIZE", "8"], "finetune")
    depth = cfg.MVIT.DEPTH
    check(cfg.TRAIN.CHECKPOINT_EPOCH_RESET and depth == 16
          and FINETUNE_CLIPS == cfg.TRAIN.BATCH_SIZE * cfg.AUG.NUM_SAMPLE, "fine-tune recipe")
    out_dir = os.path.join(OUT_DIR, "finetune")
    opts = kinetics_split(corpus, "finetune", 4 * cfg.TRAIN.BATCH_SIZE) + [
        "TRAIN.BATCH_SIZE", str(cfg.TRAIN.BATCH_SIZE), "TRAIN.CHECKPOINT_FILE_PATH", pt_ckpt]
    reports, snapshots, load = [], [], cu.load_weights

    def recording_load(*args, **kwargs):
        reports.append(load(*args, **kwargs))
        return reports[-1]

    cu.load_weights = recording_load
    try:
        with removed_after(os.path.join(out_dir, "checkpoints")):
            run = drive_train(MVITV2_FT_YAML, opts, out_dir, on_model=lambda m: snapshots.append(
                {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}))
    finally:
        cu.load_weights = load
    del run["model"]
    pt_state = torch.load(pt_ckpt, map_location="cpu", weights_only=True)["model_state"]
    (report,), (before,) = reports, snapshots
    resized = [k for k in report.loaded if before[k].shape != pt_state[k].shape]

    def loaded_value(k):
        if k not in resized:
            return pt_state[k]
        return torch.from_numpy(cu._surgery_convert(k, pt_state[k].numpy(), before[k].shape))

    differ = [k for k in report.loaded if not torch.equal(before[k], loaded_value(k))]
    counts = {"loaded": len(report.loaded), "skipped": report.skipped,
              "missing": len(report.missing), "unexpected": len(report.unexpected)}
    launches, steps = run["launches"], run["steps"]
    val_batches = (launches["attention_flash"] - depth * 4) // depth
    epochs = [s["epoch"] for s in run["logged"] if s["_type"] == "train_epoch"]
    emit({"phase": "finetune_slice", "steps": len(steps), "clips_per_step": FINETUNE_CLIPS,
          "per_step": steps, "epochs": epochs, "load_counts": counts,
          "pinned_counts": FINETUNE_COUNTS, "missing": report.missing, "resized": resized,
          "loaded_differ_from_checkpoint": differ, "val_batches": val_batches,
          "val_epoch": [s for s in run["logged"] if s["_type"] == "val_epoch"][-1],
          "train_wall_s": run["wall_s"], "run_max_memory_allocated": run["max_memory_allocated"],
          "flash_shadow_checks": run["shadow"].stats, "launches": launches})
    check(epochs == ["1/1"], f"the fine-tune ran epochs {epochs}, not from epoch 0")
    check(len(steps) == 4 and all(s["clips"] == FINETUNE_CLIPS for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(not differ, f"loaded tensors differ from the checkpoint: {differ[:5]}")
    check({k: counts[k] for k in FINETUNE_COUNTS} == FINETUNE_COUNTS
          and counts["loaded"] == len(before) - FINETUNE_COUNTS["missing"],
          f"load counts {counts}, expected {FINETUNE_COUNTS}")
    check(val_batches >= 1 and only_launched(launches, ("attention_flash", "attention_flash_bwd"),
                                             None)
          and launches["attention_flash"] == depth * (4 + val_batches)
          and launches["attention_flash_bwd"] == depth * 4
          and launches["preprocess_u8"] == 4 + val_batches, f"launches {launches}")
    run["shadow"].check("finetune train", depth * (4 + val_batches), depth * 4)
    return {"launches": launches}


# --- Contrastive SSL pretraining and its transfer ----------------------------------

SSL_CONFIGS = os.path.join(ROOT, "configs", "contrastive_ssl")
SSL_YAML = {t: os.path.join(SSL_CONFIGS, f) for t, f in (
    ("moco", "MoCo_SlowR50_8x8.yaml"), ("byol", "BYOL_SlowR50_8x8.yaml"),
    ("simclr", "SimCLR_SlowR50_8x8.yaml"), ("swav", "SwAV_Slow_R50_8x8.yaml"))}
LINEAR_YAML = os.path.join(SSL_CONFIGS, "linear_k400_Slow_8x8_R50_syn8.yaml")
# Clips a step: MoCo at its recipe's 64; BYOL, SimCLR and SwAV run out of
# an 80 GB card's memory at their recipes' 64, so at 32 (PERF.md).
SSL_CLIPS = {"moco": 64, "byol": 32, "simclr": 32, "swav": 32}
LINEAR_CLIPS = 16
SSL_STATE_TOL = 1e-6
# MoCo's videos and epochs and the other recipes' steps, as few as the
# checks allow so the whole script keeps within its time (their loaders
# decode 4 views of 64 or 32 clips a step on the host, 10-33 s a step; only
# the max-pool backward runs on these paths): MoCo takes one step an epoch,
# a warm-up epoch and an updating one.
SSL_VIDEOS = 64
SSL_EPOCHS = 2
SSL_FAMILY_STEPS = 2


def ssl_float_batch(cfg, n, seed, device="cuda"):
    """An SSL step's batch of ``n`` clips: two views of seeded normal float
    pathways (the SSL items' normalized clips), clip ids and times."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (n, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    views = [[torch.randn(shape, generator=gen, device=device)] for _ in range(2)]
    return {"inputs": views[0], "inputs2": views[1], "index": torch.arange(n, device=device),
            "time": torch.rand(n, generator=gen, device=device)}


def ssl_setup(cfg, device, steps_per_epoch, first_iter=0, generator=None):
    """A fresh model, optimizer, SSL state and SSL train step on ``device``;
    the step count starts at ``first_iter``."""
    from slowfast_tpu_torch.engine.ssl_steps import make_ssl_train_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.models.contrastive import init_ssl_state
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device=device)
    opt = construct_optimizer(model, cfg)
    ssl = init_ssl_state(cfg, model, torch.Generator().manual_seed(cfg.RNG_SEED))
    ssl.iter = first_iter
    return model, opt, ssl, make_ssl_train_step(cfg, model, opt, ssl, steps_per_epoch, generator)


def drive_ssl_train(yaml, opts, out_dir, on_step=None):
    """``run_net.main`` pretraining ``yaml`` with ``opts`` into ``out_dir``
    on the card, every kernel count set to 0 just before and read just
    after. Each step is recorded: its clips, loss, grad norm, LR, step
    count, device-synchronized ms, whether it moved any parameter, and how
    far the queue pointer advanced; ``on_step(model, ssl, before)`` gets the
    parameters from before it. Returns the steps, the logged stats, the
    launches, the peak memory, the wall time, the model and the SSL state."""
    import gc

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine import trainer

    shutil.rmtree(out_dir, ignore_errors=True)
    steps, made, make = [], [], trainer.make_ssl_train_step

    def recording(cfg, model, optimizer, ssl, steps_per_epoch, generator=None):
        step = make(cfg, model, optimizer, ssl, steps_per_epoch, generator)
        made.append((model, ssl))

        def recorded(batch):
            before = [p.detach().clone() for p in model.parameters()]
            ptr, length = ssl.ptr, None if ssl.queue_x is None else ssl.queue_x.shape[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            moved = not all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
            steps.append({"clips": batch["index"].shape[0], "iter": ssl.iter - 1,
                          "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                          "lr": m["lr"], "ms": ms, "params_moved": moved,
                          "ptr_advance": None if length is None else (ssl.ptr - ptr) % length})
            if on_step is not None:
                on_step(model, ssl, before)
            return m

        return recorded

    argv = ["--cfg", yaml, "--opts", "NUM_GPUS", "1", "TEST.ENABLE", "False",
            "OUTPUT_DIR", out_dir] + list(opts)
    trainer.make_ssl_train_step = recording
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        run_net.main(argv)
    finally:
        trainer.make_ssl_train_step = make
    wall = time.perf_counter() - t0
    launches = read_launches()
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    check(steps and all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps),
          f"non-finite SSL loss: {steps}")
    check(only_pool_bwd(launches), f"an SSL pretrain launched {launches}")
    model, ssl = made[-1]
    return dict(steps=steps, logged=logged, launches=launches, wall_s=wall, model=model, ssl=ssl,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def ssl_reload_identical(cfg, out_dir, model, ssl):
    """The last checkpoint of ``out_dir`` auto-resumes a fresh model,
    optimizer and SSL state to ``model``'s weights and ``ssl``'s state, bit
    for bit; returns the checkpoint's bytes."""
    from slowfast_tpu_torch.utils import checkpoint as cu

    path = cu.get_last_checkpoint(out_dir, cfg.TASK)
    check(path is not None, f"no checkpoint in {out_dir}")
    fresh, fresh_opt, fresh_ssl, _ = ssl_setup(cfg, "cuda", 1)
    cu.load_train_checkpoint(cfg, fresh, fresh_opt, fresh_ssl)
    want, got = ssl.state_dict(), fresh_ssl.state_dict()
    for k, v in want.items():
        if isinstance(v, dict):
            check(all(torch.equal(v[n], got[k][n]) for n in v), f"resumed SSL state {k} differs")
        elif isinstance(v, torch.Tensor):
            check(torch.equal(v, got[k]), f"resumed SSL state {k} differs")
        else:
            check(v == got[k], f"resumed SSL state {k}: {got[k]}, not {v}")
    mine = model.state_dict()
    for name, t in fresh.state_dict().items():
        check(torch.equal(t, mine[name]), f"resumed model differs at {name}")
    del fresh, fresh_opt, fresh_ssl
    return os.path.getsize(path)


def loader_batch_ms(cfg):
    """The train loader alone: ms to its first batch on the card."""
    from slowfast_tpu_torch.data import construct_loader

    t0 = time.perf_counter()
    next(iter(construct_loader(cfg, "train", "cuda")))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_ssl_train_slice(corpus, keep):
    """``run_net.main`` pretraining MoCo (MoCo_SlowR50_8x8.yaml: Slow R50,
    8 x 224², DIM 128, a 3-layer projection MLP, QUEUE_LEN 65,536,
    MOCO_MULTI_VIEW_QUEUE, 4 temporal views, the MoCo-v2 colour recipe) at
    full width in bf16 on ``SSL_VIDEOS`` clips of the mp4 corpus for
    ``SSL_EPOCHS`` epochs at the
    recipe's 64 clips a step: epoch 0 all queue warm-up (the parameters
    bit-equal after each step), every step after it updating, the pointer
    2 x clips on a step, the kNN probe after the last epoch, the checkpoint
    auto-resuming
    bit-equal (copied to ``keep`` for the linear probe). The p50 and the
    fastest of the updating steps (clips/s) and the run's peak memory."""
    from slowfast_tpu_torch.utils import checkpoint as cu

    cfg0 = family_cfg(SSL_YAML["moco"], [], "ssl")
    c = cfg0.CONTRASTIVE
    check(cfg0.MODEL.MODEL_NAME == "ContrastiveModel" and c.TYPE == "moco"
          and c.QUEUE_LEN == 65536 and c.NUM_MLP_LAYERS == 3 and c.MOCO_MULTI_VIEW_QUEUE
          and cfg0.TRAIN.BATCH_SIZE == SSL_CLIPS["moco"] and cfg0.DATA.TRAIN_CROP_SIZE == 224
          and cfg0.DATA.NUM_FRAMES == 8 and cfg0.TPU.COMPUTE_DTYPE == "bfloat16", "MoCo recipe")
    n = SSL_CLIPS["moco"]
    out_dir = os.path.join(OUT_DIR, "ssl")
    opts = kinetics_split(corpus, "ssl", SSL_VIDEOS) + [
        "TRAIN.BATCH_SIZE", str(n), "SOLVER.MAX_EPOCH", str(SSL_EPOCHS)]
    cfg = family_cfg(SSL_YAML["moco"], opts, "ssl")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_ssl_train(SSL_YAML["moco"], opts, out_dir)
        cfg.CONTRASTIVE.LENGTH = SSL_VIDEOS
        ckpt_bytes = ssl_reload_identical(cfg, out_dir, run["model"], run["ssl"])
        shutil.copyfile(cu.get_last_checkpoint(out_dir, cfg.TASK), keep)
    steps, spe = run["steps"], SSL_VIDEOS // n
    del run["model"], run["ssl"]
    knn = [s for s in run["logged"] if s["_type"] == "knn_epoch"]
    epochs = [s["epoch"] for s in run["logged"] if s["_type"] == "train_epoch"]
    ms = [s["ms"] for s in steps[spe:]]
    p50 = statistics.median(ms)
    emit({"phase": "ssl_train_slice", "recipe": "MoCo_SlowR50_8x8.yaml", "clips_per_step": n,
          "videos": SSL_VIDEOS, "steps_per_epoch": spe, "warmup_iters": 65536 // n,
          "epochs": epochs, "per_step": steps, "knn": knn, "checkpoint_bytes": ckpt_bytes,
          "reload_identical": True, "step_p50_ms": p50, "train_clips_per_s": n / p50 * 1e3,
          "step_min_ms": min(ms), "min_step_clips_per_s": n / min(ms) * 1e3,
          "max_memory_allocated": run["max_memory_allocated"], "train_wall_s": run["wall_s"],
          "launches": run["launches"]})
    check(len(steps) == SSL_EPOCHS * spe and all(s["clips"] == n for s in steps),
          f"steps {len(steps)}")
    check(not any(s["params_moved"] for s in steps[:spe]),
          "a queue warm-up step of epoch 0 moved the parameters")
    check(all(s["params_moved"] for s in steps[spe:]), "a step after epoch 0 left the parameters")
    check(all(s["ptr_advance"] == 2 * n for s in steps), "the queue pointer moved by "
          f"{[s['ptr_advance'] for s in steps]}, not 2 x {n}")
    check(epochs == [f"{e}/{SSL_EPOCHS}" for e in range(1, SSL_EPOCHS + 1)] and len(knn) == 1
          and 0.0 <= knn[0]["top1_acc"] <= 100.0, f"epochs {epochs}, kNN {knn}")
    return {"launches": run["launches"]}


def phase_linear_probe_slice(corpus, pt_ckpt):
    """``run_net.main`` training the linear probe
    (linear_k400_Slow_8x8_R50_syn8.yaml: Slow R50, DETACH_FINAL_FC) at full
    width in bf16 from ssl_train_slice's checkpoint through
    ``CHECKPOINT_CLEAR_NAME_PATTERN ("backbone.",)``: every backbone tensor
    loaded, the head's projection fresh; 4 decoded steps of 16 clips and a
    val batch, each through the preprocess kernel; the backbone's weights
    bit-equal to the checkpoint's after them, no backbone parameter with a
    gradient."""
    from slowfast_tpu_torch.utils import checkpoint as cu

    cfg = family_cfg(LINEAR_YAML, ["TRAIN.BATCH_SIZE", str(LINEAR_CLIPS)], "linear")
    check(cfg.MODEL.DETACH_FINAL_FC and cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN == ("backbone.",)
          and cfg.MODEL.MODEL_NAME == "ResNet", "linear probe recipe")
    out_dir = os.path.join(OUT_DIR, "linear")
    opts = kinetics_split(corpus, "linear", 4 * LINEAR_CLIPS) + [
        "TRAIN.BATCH_SIZE", str(LINEAR_CLIPS), "TRAIN.CHECKPOINT_FILE_PATH", pt_ckpt]
    reports, load = [], cu.load_weights

    def recording_load(*args, **kwargs):
        reports.append(load(*args, **kwargs))
        return reports[-1]

    cu.load_weights = recording_load
    try:
        with removed_after(os.path.join(out_dir, "checkpoints")):
            run = drive_train(LINEAR_YAML, opts, out_dir)
    finally:
        cu.load_weights = load
    model = run.pop("model")
    (report,) = reports
    pt_state = torch.load(pt_ckpt, map_location="cpu", weights_only=True)["model_state"]
    names = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]
    backbone = [k for k, _ in model.named_parameters() if not k.startswith("head.projection")]
    differ = [k for k in backbone
              if not torch.equal(model.get_parameter(k).detach().cpu(), pt_state["backbone." + k])]
    with_grad = [k for k in backbone if model.get_parameter(k).grad is not None
                 and model.get_parameter(k).grad.abs().max().item() > 0]
    del model
    launches, steps = run["launches"], run["steps"]
    counts = {"loaded": len(report.loaded), "skipped": report.skipped,
              "missing": len(report.missing), "unexpected": len(report.unexpected)}
    emit({"phase": "linear_probe_slice", "recipe": "linear_k400_Slow_8x8_R50_syn8.yaml",
          "steps": len(steps), "clips_per_step": LINEAR_CLIPS, "per_step": steps,
          "load_counts": counts, "missing": report.missing, "unexpected": report.unexpected,
          "backbone_params": len(backbone), "backbone_differ_from_checkpoint": differ,
          "backbone_params_with_grad": with_grad,
          "val_epoch": [s for s in run["logged"] if s["_type"] == "val_epoch"][-1],
          "train_wall_s": run["wall_s"], "run_max_memory_allocated": run["max_memory_allocated"],
          "launches": launches})
    check(len(steps) == 4 and all(s["clips"] == LINEAR_CLIPS for s in steps), f"steps {steps}")
    check(sorted(report.missing) == ["head.projection.bias", "head.projection.weight"]
          and sorted(report.loaded) == sorted(n for n in names if not n.startswith("head."))
          and report.skipped == 0
          and all(u.startswith("head.projection.projection.") for u in report.unexpected),
          f"load {counts}: missing {report.missing}, unexpected {report.unexpected}")
    check(not differ and not with_grad, f"DETACH_FINAL_FC moved {differ[:4]}, grads {with_grad[:4]}")
    check(only_launched(launches, (), None) and launches["preprocess_u8"] == 4 + 1
          and launches["roi_align"] == 0, f"launches {launches}")
    return {"launches": launches}


def phase_ssl_family(corpus):
    """BYOL (2-layer MLPs of 4,096, a predictor), SimCLR and SwAV (1,000
    prototypes) at full width in bf16 with LARS: per recipe
    ``run_net.main`` for ``SSL_FAMILY_STEPS`` decoded steps of 32 clips on
    the mp4 corpus with finite losses, the p50 and the fastest of the steps
    after the first (clips/s) and the run's peak memory; SwAV's prototype
    rows of unit length after each step and, in epoch 0, after each step
    but the first equal to the rows before it renormalized (LARS gives
    their zero gradient no decay)."""
    out = {}
    for t in ("byol", "simclr", "swav"):
        cfg = family_cfg(SSL_YAML[t], [], f"ssl_{t}")
        check(cfg.SOLVER.LARS_ON and cfg.CONTRASTIVE.TYPE == t, f"{t} recipe")
        n = SSL_CLIPS[t]
        out_dir = os.path.join(OUT_DIR, f"ssl_{t}")
        proto = []

        def swav_check(model, ssl, before, proto=proto):
            if t != "swav":
                return
            w = model.swav_prototypes.weight.detach()
            w0 = before[[n for n, _ in model.named_parameters()].index("swav_prototypes.weight")]
            unit0 = w0 / torch.linalg.vector_norm(w0, dim=1, keepdim=True)
            proto.append({"max_row_norm_err": (torch.linalg.vector_norm(w, dim=1) - 1).abs()
                          .max().item(), "max_move_beyond_renorm": (w - unit0).abs().max().item()})

        with removed_after(os.path.join(out_dir, "checkpoints")):
            run = drive_ssl_train(SSL_YAML[t], kinetics_split(
                corpus, f"ssl_{t}", SSL_FAMILY_STEPS * n) + [
                "TRAIN.BATCH_SIZE", str(n), "SOLVER.MAX_EPOCH", "1"], out_dir, on_step=swav_check)
        del run["model"], run["ssl"]
        # The loader's workers decode the next batches on the host's cores
        # while the first steps run; the fastest step is the one they left
        # alone.
        ms = [s["ms"] for s in run["steps"][1:]]
        p50 = statistics.median(ms)
        out[t] = {"clips_per_step": n, "step_p50_ms": p50, "train_clips_per_s": n / p50 * 1e3,
                  "step_min_ms": min(ms), "min_step_clips_per_s": n / min(ms) * 1e3,
                  "max_memory_allocated": run["max_memory_allocated"],
                  "run_steps": run["steps"], "train_wall_s": run["wall_s"], "prototypes": proto}
        check(len(run["steps"]) == SSL_FAMILY_STEPS
              and all(s["params_moved"] for s in run["steps"]),
              f"{t} steps {run['steps']}")
        if t == "swav":
            check(len(proto) == SSL_FAMILY_STEPS
                  and all(p["max_row_norm_err"] <= 1e-6 for p in proto)
                  and all(p["max_move_beyond_renorm"] <= 1e-6 for p in proto[1:]),
                  f"SwAV prototypes {proto}")
    emit({"phase": "ssl_family", **out})


def float64_ssl(model, cfg, ssl_state, batch):
    """The SSL step of ``model`` (its state before the step) in float64 on
    the CPU: returns its loss, gradients and SSL state after it."""
    import copy

    from slowfast_tpu_torch.engine.ssl_steps import make_ssl_train_step
    from slowfast_tpu_torch.models.contrastive import init_ssl_state
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    def as_float64(module):
        module.double()
        for m in module.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        return module

    m64 = as_float64(copy.deepcopy(model))
    ssl = init_ssl_state(cfg, m64, torch.Generator().manual_seed(0))
    ssl.load_state_dict(ssl_state)
    for name in ssl.TENSORS:
        if getattr(ssl, name) is not None:
            setattr(ssl, name, getattr(ssl, name).double())
    if ssl.hist is not None:
        as_float64(ssl.hist)
    step = make_ssl_train_step(cfg, m64, construct_optimizer(m64, cfg), ssl, 1,
                               torch.Generator().manual_seed(0))
    step.keep_grads = True
    m = step({k: [x.double() for x in v] if isinstance(v, list) else v for k, v in batch.items()})
    return m["loss"].item(), step.last_grads, ssl


def ssl_fp32_case(t, clips):
    """One fp32 step of ``t`` at full width on ``clips`` clips, card (TF32
    off) vs CPU vs float64 on the CPU, from one state: random BN parameters
    and statistics, the momentum encoder a copy of the backbone, the
    recipe's queue and kNN bank, the step count in epoch 1 (past MoCo's
    warm-up)."""
    cfg = family_cfg(SSL_YAML[t], ["TPU.COMPUTE_DTYPE", "float32",
                                   "TRAIN.BATCH_SIZE", str(clips)], "ssl_fp32")
    cpu_model, cpu_opt, cpu_ssl, cpu_step = ssl_setup(cfg, "cpu", 1, first_iter=1,
                                                      generator=torch.Generator())
    randomize_bn(cpu_model, 5)
    cpu_ssl.hist.load_state_dict(cpu_model.backbone.state_dict())
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    ssl0 = cpu_ssl.state_dict()
    batch = ssl_float_batch(cfg, clips, 9, device="cpu")
    names = [n for n, _ in cpu_model.named_parameters()]
    t0 = time.perf_counter()
    cpu_step.keep_grads = True
    want = cpu_step(batch)
    cpu_s = time.perf_counter() - t0
    model, opt, ssl, step = ssl_setup(cfg, "cuda", 1, first_iter=1, generator=torch.Generator(
        device="cuda"))
    model.load_state_dict(state, strict=True)
    ssl.load_state_dict(ssl0)
    step.keep_grads = True
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_launches()
        got = step({k: [x.cuda() for x in v] if isinstance(v, list) else v.cuda()
                    for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_model.load_state_dict(state, strict=True)
    loss64, grads64, ssl64 = float64_ssl(cpu_model, cfg, ssl0, batch)
    grads = {n: g.cpu() for n, g in step.last_grads.items()}
    want_grads = cpu_step.last_grads
    gnames = [n for n in names if n in want_grads]
    check(sorted(grads) == sorted(want_grads), "the card and the CPU took different gradients")
    card_vs_f64, cpu_vs_f64 = rel_l2(grads, grads64, gnames), rel_l2(want_grads, grads64, gnames)
    # The SSL state: the queue rows this step wrote, the kNN bank's rows of
    # the batch, the momentum encoder's weights and BN statistics.
    got_s, want_s, exact_s = ssl.state_dict(), cpu_ssl.state_dict(), ssl64.state_dict()
    parts = {}
    index = batch["index"]
    if "queue_x" in want_s:
        ptr0, rows = ssl0["ptr"], 2 * clips
        idx = (ptr0 + torch.arange(rows)) % want_s["queue_x"].shape[0]
        parts["queue_rows"] = [d["queue_x"][idx] for d in (got_s, want_s, exact_s)]
    parts["knn_rows"] = [d["memory"][index] for d in (got_s, want_s, exact_s)]
    for k in want_s.get("hist", {}):
        if not k.endswith("num_batches_tracked"):
            parts["hist." + k] = [d["hist"][k] for d in (got_s, want_s, exact_s)]
    state_err = {}
    for k, (g, w, e) in parts.items():
        one = {"x": g.double()}, {"x": w.double()}, {"x": e.double()}
        state_err[k] = (rel_l2(one[0], one[1], ["x"]), rel_l2(one[0], one[2], ["x"]),
                        rel_l2(one[1], one[2], ["x"]))
    # Each part within 1e-6 of the CPU's, or no further from the float64
    # step than twice the CPU's: a momentum-encoder leaf takes (1 - mmt) of
    # the update in, so where the update is large against the leaf (the
    # stem, the BN biases, the MLPs' zero-initialised biases) it carries the
    # gradients' conditioning, and the queue and kNN rows are the fp32
    # forward's embeddings.
    bad_state = {k: v for k, v in state_err.items()
                 if v[0] > SSL_STATE_TOL and v[1] > 2.0 * v[2]}
    over = sorted(((v[0], k) for k, v in state_err.items() if v[0] > SSL_STATE_TOL), reverse=True)
    hist_err = max((v[0] for k, v in state_err.items() if k.startswith("hist.")), default=0.0)
    loss_err = abs(got["loss"].item() - want["loss"].item()) / abs(want["loss"].item())
    card_loss_f64 = abs(got["loss"].item() - loss64) / abs(loss64)
    cpu_loss_f64 = abs(want["loss"].item() - loss64) / abs(loss64)
    out = {"clips": clips, "loss": got["loss"].item(), "cpu_loss": want["loss"].item(),
           "float64_loss": loss64, "loss_rel_err": loss_err,
           "card_vs_float64_loss_rel_err": card_loss_f64,
           "cpu_vs_float64_loss_rel_err": cpu_loss_f64, "lr": got["lr"],
           "card_vs_float64_grad_rel_l2": card_vs_f64, "cpu_vs_float64_grad_rel_l2": cpu_vs_f64,
           "grad_rel_l2_err": rel_l2(grads, want_grads, gnames), "params_with_grad": len(gnames),
           "ptr": [ssl.ptr, cpu_ssl.ptr], "iter": [ssl.iter, cpu_ssl.iter],
           "max_hist_rel_l2_err": hist_err,
           "queue_rows_rel_l2_err": state_err.get("queue_rows", [None])[0],
           "knn_rows_rel_l2_err": state_err["knn_rows"][0],
           "state_over_1e-6": {k: state_err[k] for _, k in over[:12]},
           "state_over_1e-6_count": len(over),
           "state_beyond_tol": bad_state, "cpu_step_s": cpu_s, "launches": launches}
    out["fails"] = [msg for bad, msg in (
        (loss_err > 1e-5, "loss"),
        (card_vs_f64 > 2.0 * cpu_vs_f64, "gradients"),
        (ssl.ptr != cpu_ssl.ptr or ssl.iter != cpu_ssl.iter, "pointer or step count"),
        (bool(bad_state), "SSL state"),
        (not only_pool_bwd(launches), "launches")) if bad]
    del model, opt, ssl, step
    return out


def phase_ssl_fp32():
    """One MoCo step on 2 clips and one BYOL step on 4 at full width in fp32,
    card with TF32 off vs CPU on the same weights, state and batch
    (ssl_fp32_case). BYOL's projection and predictor MLPs batch-normalize:
    over 2 clips a BN's output is +-1 whatever its input, so every gradient
    below it is zero in exact arithmetic and rounding noise in fp32; 4
    clips keep them real. The loss within 1e-5; the gradients no further
    from the float64 step than twice the CPU's fp32 ones (Slow R50's fp32
    gradient is ill-conditioned, ROADMAP Queue 3 #4); the queue rows
    written, the kNN bank's rows and each leaf of the momentum encoder
    within 1e-6 relative L2 of the CPU's, or no further from the float64
    step than twice the CPU's fp32 run (the leaves that take in an update
    large against them carry the gradients' conditioning); equal pointers
    and step counts."""
    cases = {"moco": ssl_fp32_case("moco", 2), "byol": ssl_fp32_case("byol", 4)}
    emit({"phase": "ssl_fp32", **cases})
    check(not any(c["fails"] for c in cases.values()),
          f"ssl_fp32 fails: { {t: c['fails'] for t, c in cases.items()} }")


MG_YAML = os.path.join(ROOT, "configs", "Kinetics", "SLOWFAST_8x8_R50_stepwise_multigrid.yaml")
# One GPU's share of the recipe's 64 clips on 8 GPUs, so the BN splits are
# the recipe's; the schedule shrunk to 6 epochs that visit the four
# long-cycle shapes, each epoch one or more full short cycles of 256 clips.
MG_OPTS = ["TRAIN.BATCH_SIZE", "8", "DATA.SYNTHETIC_SIZE", "256", "SOLVER.STEPS", "[0, 3]",
           "SOLVER.LRS", "[1, 0.1]", "SOLVER.MAX_EPOCH", "4", "SOLVER.WARMUP_EPOCHS", "1.0"]
IN1K_YAML = os.path.join(ROOT, "configs", "ImageNet", "MVITv2_S.yaml")
IN1K_MASKFEAT_YAML = os.path.join(ROOT, "configs", "masked_ssl", "in1k_VIT_B_MaskFeat_PT.yaml")
IN1K_IMAGES = 32  # one GPU's share of the recipes' 256
IN1K_CORPUS = {"train": 4 * IN1K_IMAGES, "val": 2 * IN1K_IMAGES}


def mg_expected_shapes(cfg):
    """Per epoch of the shrunk multigrid schedule, the long-cycle (B, T, S),
    the BN splits, the epoch's train batches ``[(B·fᵢ, crop)]`` (full short
    cycles of the synthetic clips, then what still fits) and val batches,
    from the port's ``MultigridSchedule`` on ``cfg`` (which it mutates);
    and the schedule."""
    from slowfast_tpu_torch.data.loader import short_cycle_batches
    from slowfast_tpu_torch.utils.multigrid import MultigridSchedule

    mg = MultigridSchedule()
    cfg = mg.init_multigrid(cfg)
    out = []
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        cfg, _ = mg.update_long_cycle(cfg, epoch)
        crops = [int(round(f * cfg.MULTIGRID.DEFAULT_S))
                 for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS] + [cfg.DATA.TRAIN_CROP_SIZE]
        cycle = list(zip(short_cycle_batches(cfg, cfg.TRAIN.BATCH_SIZE), crops))
        steps, pos = [], 0  # the epoch's batches: full short cycles of the clips
        while pos + cycle[len(steps) % 3][0] <= cfg.DATA.SYNTHETIC_SIZE:
            steps.append(cycle[len(steps) % 3])
            pos += steps[-1][0]
        out.append({"shape": (cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE),
                    "splits": cfg.BN.NUM_SPLITS if cfg.BN.NORM_TYPE == "sub_batchnorm" else 1,
                    "steps": steps,
                    "val_batches": -(-cfg.DATA.SYNTHETIC_SIZE // cfg.TRAIN.BATCH_SIZE)})
    return out, mg.schedule


def phase_multigrid_slice():
    """``run_net.main`` training ``SLOWFAST_8x8_R50_stepwise_multigrid.yaml``
    at full width (R50, 400 classes, 32 frames at 224² by default) in bf16
    with both cycles, ``TRAIN.BATCH_SIZE 8`` and ``NUM_GPUS 1``, on
    synthetic video, the schedule shrunk to 6 epochs (``MG_OPTS``): the
    (B, T, crop) of every step and its BN splits against
    ``MultigridSchedule``'s; at each long-cycle transition the rebuilt
    model and optimizer hold the old ones' parameters and momentum bit for
    bit; per batch shape of each long-cycle shape the steps, p50 (after
    the first) and fastest step ms to a synchronize, clips/s and the peak
    memory a step; the LR around each
    transition's first step; the preprocess kernel once a train, precise-BN
    and val batch."""
    import gc

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.models.batchnorm import BatchNorm3D

    out_dir = os.path.join(OUT_DIR, "multigrid")
    shutil.rmtree(out_dir, ignore_errors=True)
    expected, schedule = mg_expected_shapes(slowfast_cfg(["NUM_GPUS", "1"] + MG_OPTS, MG_YAML))
    steps, builds, make_step = [], [], trainer.make_train_step

    def recording_make_step(cfg, model, optimizer, generator):
        if builds:  # a rebuild: the state carried bit for bit
            old_model, old_opt = builds[-1]
            params = dict(model.named_parameters())
            same_params = all(torch.equal(p, params[n]) for n, p in old_model.named_parameters())
            same_trace = all(torch.equal(a, b) for a, b in zip(old_opt.trace, optimizer.trace))
            steps.append({"rebuild": True, "params_carried": same_params,
                          "momentum_carried": same_trace and old_opt.count == optimizer.count,
                          "momentum_norm": float(sum(t.float().norm() ** 2
                                                     for t in optimizer.trace) ** 0.5)})
        builds[:] = [(model, optimizer)]
        splits = max(m.num_splits for m in model.modules() if isinstance(m, BatchNorm3D))
        step = make_step(cfg, model, optimizer, generator)

        def recorded(batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            b, t, s = batch["inputs"][0].shape[:3]
            steps.append({"shape": (b, t, s), "splits": splits, "epoch": int(batch["epoch_exact"]),
                          "ms": ms, "loss": m["loss"].item(), "lr": m["lr"],
                          "max_memory_allocated": torch.cuda.max_memory_allocated()})
            return m

        return recorded

    argv = ["--cfg", MG_YAML, "--opts", "NUM_GPUS", "1", "TRAIN.DATASET", "syntheticvideo",
            "TEST.ENABLE", "False", "OUTPUT_DIR", out_dir] + MG_OPTS
    trainer.make_train_step = recording_make_step
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with removed_after(os.path.join(out_dir, "checkpoints")):
            run_net.main(argv)
    finally:
        trainer.make_train_step = make_step
    wall = time.perf_counter() - t0
    launches = read_launches()
    builds.clear()
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    rebuilds = [s for s in steps if "rebuild" in s]
    runs = [s for s in steps if "rebuild" not in s]
    check(all(np.isfinite(s["loss"]) for s in runs), f"non-finite loss: {runs}")
    check(rebuilds and all(r["params_carried"] and r["momentum_carried"] and r["momentum_norm"] > 0
                           for r in rebuilds), f"state not carried across a transition: {rebuilds}")
    want = [(epoch, (b, e["shape"][1], crop), e["splits"])
            for epoch, e in enumerate(expected) for b, crop in e["steps"]]
    got = [(s["epoch"], s["shape"], s["splits"]) for s in runs]
    check(got == want, f"multigrid steps {got} differ from the schedule's {want}")
    # Per batch shape of each long-cycle shape (a short-cycle batch recurs
    # under another long-cycle shape, with other BN splits): the first step
    # includes cuDNN's choice of algorithms, so the p50 is of the others.
    shapes = {}
    for s in runs:
        shapes.setdefault((expected[s["epoch"]]["shape"], s["shape"]), []).append(s)
    per_shape = []
    for (long_shape, shape), ss in shapes.items():
        ms = [s["ms"] for s in ss]
        p50 = statistics.median(ms[1:] or ms)
        per_shape.append({"long_cycle": long_shape, "B": shape[0], "T": shape[1],
                          "crop": shape[2], "steps": len(ss), "bn_splits": ss[0]["splits"],
                          "step_p50_ms": p50, "step_min_ms": min(ms), "steps_ms": ms,
                          "clips_per_s": shape[0] / p50 * 1e3,
                          "max_memory_allocated": max(s["max_memory_allocated"] for s in ss)})
    transitions, prev, rebuilt = [], None, False
    for s in steps:
        if "rebuild" in s:
            rebuilt = True
            continue
        if rebuilt:
            transitions.append({"epoch": s["epoch"], "long_cycle": expected[s["epoch"]]["shape"],
                                "lr_before": prev["lr"], "lr_after": s["lr"]})
            rebuilt = False
        prev = s
    vals = [s for s in logged if s["_type"] == "val_epoch"]
    # Every epoch of this schedule evaluates and checkpoints: its precise BN
    # takes the epoch's short-cycle batches again, and its val epoch.
    val_batches = sum(e["val_batches"] for e in expected)
    emit({"phase": "multigrid_slice", "schedule": schedule, "epochs": len(expected),
          "steps": len(runs), "per_shape": per_shape, "transitions": transitions,
          "rebuilds": rebuilds, "val_epochs": len(vals), "val_batches": val_batches,
          "wall_s": wall,
          "launches": launches})
    check(len(vals) == len(expected), f"{len(vals)} val epochs")
    check(only_launched(launches, (), 0)
          and launches["preprocess_u8"] == 2 * len(runs) + val_batches, f"launches {launches}")
    return {"launches": launches}


@contextlib.contextmanager
def imagenet_corpus():
    """ImageNet's tree of ``IN1K_CORPUS`` JPEGs of 500 x 375 in 10 classes,
    written with cv2 into a temporary directory that is removed after;
    yields (directory, write seconds)."""
    import tempfile

    from slowfast_tpu_torch.data import synth_media

    root = tempfile.mkdtemp(prefix="imagenet_corpus_")
    try:
        t0 = time.perf_counter()
        synth_media.make_imagenet_corpus(root, IN1K_CORPUS, workers=os.cpu_count() or 1)
        yield root, time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)


def float_image_batch(cfg, n, seed):
    """``n`` seeded normalized images (T = 1) on the card, and their labels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    return {"inputs": [torch.randn((n, 1, crop, crop, 3), device="cuda", generator=gen)],
            "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (n,), device="cuda",
                                    generator=gen),
            "epoch_exact": 0.5}


def phase_imagenet_train_slice(corpus):
    """``run_net.main`` training ImageNet MViTv2-S (``configs/ImageNet/
    MVITv2_S.yaml``: the 2D patch stem, 224² images, 1,000 classes, the
    recipe's mixup/cutmix, RandAugment, random erasing, AdamW and clip) at
    full width and depth in bf16 on the JPEG corpus: 4 steps of 32 images
    and a val epoch of 2 batches, every flash call held; the loader alone
    per batch; the step alone (unheld, on images already on the card: p50,
    images/s, peak memory); rows 6 and 7 at each block shape, the first
    block's 2D one (Nq 3,136, Nk 196) among them, against their plain
    versions, their bounds and SDPA."""
    data = ["TRAIN.DATASET", "imagenet", "DATA.PATH_TO_DATA_DIR", corpus,
            "TRAIN.BATCH_SIZE", str(IN1K_IMAGES)]
    cfg = family_cfg(IN1K_YAML, data, "imagenet")
    depth = cfg.MVIT.DEPTH
    check(cfg.MVIT.PATCH_2D and cfg.MODEL.NUM_CLASSES == 1000 and cfg.MIXUP.ENABLE,
          "the ImageNet recipe")
    out_dir = os.path.join(OUT_DIR, "imagenet")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(IN1K_YAML, data, out_dir)
    launches, steps = run["launches"], run["steps"]
    val_batches = IN1K_CORPUS["val"] // IN1K_IMAGES
    check(len(steps) == 4 and all(s["clips"] == IN1K_IMAGES for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["attention_flash"] == depth * (4 + val_batches)
          and launches["attention_flash_bwd"] == depth * 4
          and launches["preprocess_u8"] == 0, f"launches {launches}")
    shadow = run["shadow"].check("imagenet train", depth * (4 + val_batches), depth * 4)
    loader_ms = [loader_batch_ms(cfg) for _ in range(2)]
    timing = timed_train_steps(cfg, float_image_batch(cfg, IN1K_IMAGES, 31), 5)
    attn = attention_shape_times("imagenet_attn", capture_attention(cfg, IN1K_IMAGES, 32))
    emit({"phase": "imagenet_train_slice", "steps": len(steps), "images_per_step": IN1K_IMAGES,
          "per_step": steps,
          "val_epoch": [s for s in run["logged"] if s["_type"] == "val_epoch"][-1],
          "train_wall_s": run["wall_s"], "run_max_memory_allocated": run["max_memory_allocated"],
          "loader_batch_ms": loader_ms,
          "step_p50_ms": timing["step_p50_ms"], "steps_ms": timing["steps_ms"],
          "max_memory_allocated": timing["max_memory_allocated"],
          "train_images_per_s": IN1K_IMAGES / timing["step_p50_ms"] * 1e3,
          "flash_shadow_checks": shadow, "attention": attn, "launches": launches})
    return {"launches": launches, "attention": attn}


def phase_imagenet_fp32():
    """One train step of the full-width 2D MViTv2-S on 2 images, card vs
    CPU on the same weights, fp32 with TF32 off: the loss within 1e-5, the
    gradients within 1e-3 relative L2 (the structurally zero ones
    excepted); the card's flash calls held, on the FMA kernels."""
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32", "MIXUP.ENABLE", "False", "MVIT.DROPPATH_RATE", "0.0",
            "MODEL.DROPOUT_RATE", "0.0"]
    cfg = family_cfg(IN1K_YAML, base, "imagenet")
    depth = cfg.MVIT.DEPTH
    cpu_model = build_model(cfg, device="cpu")
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    image = torch.from_numpy(np.random.RandomState(33).randint(
        0, 255, (2, 1, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)).astype(np.uint8))
    label = torch.tensor([17, 901])
    t0 = time.perf_counter()
    want, want_grads, _ = train_one_step(cfg, cpu_model, image, label, 100.0)
    cpu_s = time.perf_counter() - t0
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_launches()
        with FlashShadow() as shadow:
            got, grads, _ = train_one_step(cfg, model, image, label, 100.0)
            torch.cuda.synchronize()
        launches = read_launches()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    missing = [n for n, p in model.named_parameters() if p.requires_grad and (
        n not in grads or (grads[n].abs().max().item() == 0.0
                           and not structurally_zero(n, depth)))]
    check(not missing, f"parameters with no or an all-zero gradient: {missing}")
    names = [n for n in grads if not structurally_zero(n, depth)]
    l2_err = rel_l2(grads, want_grads, names)
    loss_err = abs(got["loss"] - want["loss"]) / want["loss"]
    emit({"phase": "imagenet_fp32", "images": 2, "loss": got["loss"], "cpu_loss": want["loss"],
          "loss_rel_err": loss_err, "grad_rel_l2_err": l2_err, "grad_l2_tol": TRAIN_GRAD_L2_TOL,
          "params_checked": len(names), "cpu_step_s": cpu_s,
          "flash_shadow_checks": shadow.stats, "launches": launches})
    check(loss_err <= 1e-5, f"loss {got['loss']} vs CPU {want['loss']}")
    check(l2_err <= TRAIN_GRAD_L2_TOL, f"gradients differ by {l2_err} (L2)")
    check(only_launched(launches, FP32_CORE_KEYS["flash"], depth), f"launches {launches}")
    shadow.check("imagenet fp32", depth, depth, torch.float32)


def phase_in1k_maskfeat(corpus):
    """``run_net.main`` pretraining 2D MaskFeat (``in1k_VIT_B_MaskFeat_PT
    .yaml``: ViT-B on 16² patches of 224² images, the loader's 2D masks at
    the 14² grid, HOG targets) at full width in bf16 on the JPEG corpus: 4
    steps of 32 images, no val epoch, every flash call held; the loader's
    masked share; and every ``configs/ImageNet/*`` and ``in1k_*`` YAML
    built at full size on the card's meta device (parameter counts)."""
    import glob

    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.models.build import MODEL_REGISTRY

    data = ["TRAIN.DATASET", "imagenet", "DATA.PATH_TO_DATA_DIR", corpus,
            "TRAIN.BATCH_SIZE", str(IN1K_IMAGES)]
    cfg = family_cfg(IN1K_MASKFEAT_YAML, data, "in1k_maskfeat")
    depth = max(cfg.MASK.PRETRAIN_DEPTH) + 1
    out_dir = os.path.join(OUT_DIR, "in1k_maskfeat")
    with removed_after(os.path.join(out_dir, "checkpoints")):
        run = drive_train(IN1K_MASKFEAT_YAML, data, out_dir, expect_val=False)
    launches, steps = run["launches"], run["steps"]
    check(len(steps) == 4 and all(s["clips"] == IN1K_IMAGES for s in steps),
          f"steps {[s['clips'] for s in steps]}")
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["attention_flash"] == depth * 4
          and launches["attention_flash_bwd"] == depth * 4, f"launches {launches}")
    shadow = run["shadow"].check("in1k maskfeat", depth * 4, depth * 4)
    meta = next(iter(construct_loader(cfg, "train", "cuda")))[4]
    masks = meta["mask"]
    check(masks.shape == (IN1K_IMAGES, 14, 14), f"loader masks {tuple(masks.shape)}")
    builds = {}
    for recipe in sorted(glob.glob(os.path.join(ROOT, "configs", "ImageNet", "*.yaml"))
                         + glob.glob(os.path.join(ROOT, "configs", "masked_ssl", "in1k_*"))):
        c = family_cfg(recipe, [], "in1k_maskfeat")
        with torch.device("meta"):
            model = MODEL_REGISTRY[c.MODEL.MODEL_NAME](c)
        builds[os.path.relpath(recipe, ROOT)] = sum(p.numel() for p in model.parameters())
    emit({"phase": "in1k_maskfeat", "steps": len(steps), "images_per_step": IN1K_IMAGES,
          "per_step": steps, "train_wall_s": run["wall_s"],
          "run_max_memory_allocated": run["max_memory_allocated"],
          "masked_share": masks.float().mean().item(), "flash_shadow_checks": shadow,
          "recipes_built": builds, "launches": launches})
    check(len(builds) == 12, f"built {sorted(builds)}")
    return {"launches": launches}


# ddp_slice: each fp32 step in a group of one against the same step, from
# the same state, with no group. The global BN averages the ranks' moments,
# so one rank's forward is one process's; the max-pool backward's atomics
# still order sums anew (ROADMAP Queue 3 #2). Run free, this random-weight
# step drifts from itself: 4e-2 and 1.3 relative L2 at its second and third
# steps between two runs with no group.
DDP_LOSS_TOL = 1e-5
DDP_GRAD_TOL = 1e-4
DDP_OPTS = ["BN.NORM_TYPE", "sync_batchnorm"]


@contextlib.contextmanager
def process_group(cfg):
    """``cfg``'s job as a NCCL group of one rank on this card, its ranks
    meeting through a file of their own."""
    import tempfile

    from slowfast_tpu_torch.utils import distributed as du

    rendezvous = tempfile.mkdtemp(prefix="ddp_rendezvous_")
    cfg.INIT_METHOD = "file://" + os.path.join(rendezvous, "store")
    du.init_distributed(cfg, 0, "cuda")
    try:
        yield
    finally:
        du.destroy()
        shutil.rmtree(rendezvous, ignore_errors=True)


class DdpStepper:
    """One model and optimizer on the card that take ``make_train_step``
    steps with no process group or in a group of one."""

    def __init__(self, cfg, state=None):
        from slowfast_tpu_torch.engine.steps import make_train_step
        from slowfast_tpu_torch.models.build import build_model
        from slowfast_tpu_torch.solver.optimizer import construct_optimizer

        self.cfg = cfg
        self.model = build_model(cfg, device="cuda")
        if state is not None:
            self.model.load_state_dict(state, strict=True)
        self.opt = construct_optimizer(self.model, cfg)
        self.grads, update = [], self.opt.step

        def recording(lr):
            if self.record:
                self.grads.append({n: p.grad.detach().cpu().clone()
                                   for n, p in self.model.named_parameters()})
            return update(lr)

        self.record = False
        self.opt.step = recording
        self.step = make_train_step(cfg, self.model, self.opt)

    def steps_from(self, batches, starts, grouped):
        """A step on each batch from its start (``(model state, optimizer
        state)``; None: where the step before left it): each step's loss,
        its gradients (on the CPU) and the start it took."""
        self.grads, self.record, losses, taken = [], True, [], []
        with process_group(self.cfg) if grouped else contextlib.nullcontext():
            for batch, start in zip(batches, starts):
                if start is not None:
                    self.model.load_state_dict(start[0], strict=True)
                    self.opt.load_state_dict(start[1])
                taken.append(({k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()},
                              self.opt.state_dict()))
                losses.append(self.step(batch)["loss"].item())
        self.record = False
        return losses, self.grads, taken

    def timed(self, batch, grouped, steps=4):
        """Host ms of ``steps`` bf16 steps (each to a synchronize) after one
        untimed step, the peak memory, and one profiled step."""
        with process_group(self.cfg) if grouped else contextlib.nullcontext():
            self.step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(steps):
                t0 = time.perf_counter()
                self.step(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            prof = profile_step(self.step, batch, steps=1)
            if grouped:
                prof["all_reduce_host"] = all_reduce_host_us()
        return {"step_p50_ms": statistics.median(ms), "step_ms": ms,
                "max_memory_allocated": peak, **prof}


def all_reduce_host_us(calls=200, channels=512, busy_ms=50.0):
    """What one BN's all-reduce (``2 · channels`` fp32 values) costs the
    host in the current group: microseconds a call, the calls queued back
    to back on an idle card and timed to a synchronize; and the ms one call
    holds the host while the card still runs ``busy_ms`` of earlier work (a
    sleep kernel): about ``busy_ms`` if the call waits for the card."""
    import torch.distributed as dist

    x = torch.zeros(2 * channels, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    per_call_us = (time.perf_counter() - t0) / calls * 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(int(busy_ms * 1.98e6))  # cycles at the 1.98 GHz boost clock
    end.record()
    t0 = time.perf_counter()
    dist.all_reduce(x)
    held_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {"per_call_us": per_call_us, "busy_card_ms": start.elapsed_time(end),
            "host_held_ms": held_ms}


def profile_step(step, batch, steps=1):
    """Device time a step of ``step`` on ``batch`` (torch.profiler): per
    step, the kernels' ms by category (``profile_eval.CATEGORIES``, NCCL's
    collectives first), the NCCL kernels' count (NCCL launches none for an
    in-place collective of one rank) and the collectives the host called."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slowfast_tpu_torch.profile_eval import category

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    by_cat, nccl, calls = {}, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            cat = category(e.name)
            by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            nccl += cat == "nccl"
        elif e.name.startswith("nccl:"):
            calls += 1
    return {"kernel_ms": sum(by_cat.values()), "by_category_ms": by_cat,
            "nccl_kernels": nccl / steps, "collective_calls": calls / steps}


def launcher_train(argv, out_dir, on_load=None):
    """``run_net``'s config of ``argv`` trained by the launcher's rank entry
    (``utils.multiprocessing.run``, what each spawned rank runs) as rank 0
    of a NCCL group of one; every step timed to a synchronize, and
    ``on_load(epoch, optimizer)`` told what the checkpoint load gave.
    Returns the steps, the kernel counts and the logged stats."""
    import tempfile

    from slowfast_tpu_torch.config import assert_and_infer_cfg
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.utils.multiprocessing import run
    from slowfast_tpu_torch.utils.parser import load_config, parse_args

    shutil.rmtree(out_dir, ignore_errors=True)
    rendezvous = tempfile.mkdtemp(prefix="ddp_rendezvous_")
    args = parse_args(["--cfg", YAML, "--init_method",
                       "file://" + os.path.join(rendezvous, "store"), "--opts", *argv,
                       "OUTPUT_DIR", out_dir])
    cfg = assert_and_infer_cfg(load_config(args, YAML))
    steps, make_step, load = [], trainer.make_train_step, trainer.cu.load_train_checkpoint

    def timed_make_step(*a, **k):
        step = make_step(*a, **k)

        def timed(batch):
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                          "clips": batch["labels"].shape[0]})
            return m

        return timed

    def reporting_load(cfg, model, optimizer, *a):
        epoch = load(cfg, model, optimizer, *a)
        if on_load is not None:
            on_load(epoch, optimizer)
        return epoch

    trainer.make_train_step, trainer.cu.load_train_checkpoint = timed_make_step, reporting_load
    reset_launches()
    try:
        run(0, trainer.train, cfg, "cuda")
    finally:
        trainer.make_train_step, trainer.cu.load_train_checkpoint = make_step, load
        shutil.rmtree(rendezvous, ignore_errors=True)
    launches = read_launches()
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    return {"cfg": cfg, "steps": steps, "launches": launches, "logged": logged}


def phase_ddp_slice():
    """The data-parallel path on SlowFast 4x16 R50 at full width, one rank
    over NCCL (``BN.NORM_TYPE sync_batchnorm``): the fp32 steps in a group
    of one against no group, the bf16 step's cost with the group, and the
    launcher's rank entry training, checkpointing and resuming."""
    from slowfast_tpu_torch.models.build import build_model

    t_phase = time.perf_counter()
    parts = {}
    # 1. fp32, TF32 off: three steps with no group, each again from the
    # same start in the group and with no group (the card's own spread).
    cfg = slowfast_cfg(DDP_OPTS + ["TPU.COMPUTE_DTYPE", "float32", "MODEL.DROPOUT_RATE", "0.0",
                                   "TRAIN.BATCH_SIZE", "2"])
    model = build_model(cfg, device="cpu")
    randomize_bn(model, 5)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    gen = torch.Generator(device="cuda").manual_seed(11)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    batches = [{"inputs": [torch.randint(0, 256, (2, cfg.DATA.NUM_FRAMES, crop, crop, 3),
                                         dtype=torch.uint8, device="cuda", generator=gen)],
                "labels": torch.tensor([17, 305], device="cuda"), "epoch_exact": 0.5 * i}
               for i in range(3)]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        stepper = DdpStepper(cfg, state)
        plain_loss, plain_grads, starts = stepper.steps_from(batches, [None] * 3, False)
        group_loss, group_grads, _ = stepper.steps_from(batches, starts, True)
        again_loss, again_grads, _ = stepper.steps_from(batches, starts, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del stepper, starts
    names = list(plain_grads[0])
    fp32 = {"loss": group_loss, "plain_loss": plain_loss,
            "loss_rel_err": [abs(g - p) / abs(p) for g, p in zip(group_loss, plain_loss)],
            "grad_rel_l2": [rel_l2(g, p, names) for g, p in zip(group_grads, plain_grads)],
            "plain_again_loss_rel_err": [abs(a - p) / abs(p)
                                         for a, p in zip(again_loss, plain_loss)],
            "plain_again_grad_rel_l2": [rel_l2(a, p, names)
                                        for a, p in zip(again_grads, plain_grads)]}
    parts["fp32_s"] = time.perf_counter() - t_phase

    # 2. The bf16 step of 16 clips on one model: no group, the group, no
    # group again.
    t0 = time.perf_counter()
    cfg16 = slowfast_cfg(DDP_OPTS + ["TPU.COMPUTE_DTYPE", "bfloat16",
                                     "TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS)])
    batch = {"inputs": [torch.randint(0, 256, (CNN_TRAIN_CLIPS, cfg16.DATA.NUM_FRAMES, crop,
                                               crop, 3), dtype=torch.uint8, device="cuda",
                                      generator=gen)],
             "labels": torch.randint(0, cfg16.MODEL.NUM_CLASSES, (CNN_TRAIN_CLIPS,),
                                     device="cuda", generator=gen), "epoch_exact": 0.5}
    stepper = DdpStepper(cfg16)
    timing = {mode: stepper.timed(batch, mode == "group")
              for mode in ("plain", "group", "plain_again")}
    del stepper
    torch.cuda.empty_cache()
    plain_ms = statistics.mean([timing["plain"]["step_p50_ms"],
                                timing["plain_again"]["step_p50_ms"]])
    plain_kernel_ms = statistics.mean([timing["plain"]["kernel_ms"],
                                       timing["plain_again"]["kernel_ms"]])
    parts["bf16_s"] = time.perf_counter() - t0

    # 3. The launcher's rank entry: an epoch and its checkpoint, then a run
    # resumed from that checkpoint through TRAIN.CHECKPOINT_FILE_PATH.
    base = ["NUM_GPUS", "1", *DDP_OPTS, "TRAIN.DATASET", "syntheticvideo",
            "DATA.SYNTHETIC_SIZE", str(4 * CNN_TRAIN_CLIPS), "TRAIN.BATCH_SIZE",
            str(CNN_TRAIN_CLIPS), "TEST.ENABLE", "False"]
    t0 = time.perf_counter()
    first = launcher_train(base + ["SOLVER.MAX_EPOCH", "1"], os.path.join(OUT_DIR, "ddp"))
    ckpt = os.path.join(OUT_DIR, "ddp", "checkpoints", "checkpoint_epoch_00001.pyth")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    loaded = {}

    def on_load(epoch, optimizer):
        loaded.update(epoch=epoch, state=optimizer.state_dict())

    resumed = launcher_train(base + ["SOLVER.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FILE_PATH", ckpt],
                             os.path.join(OUT_DIR, "ddp_resumed"), on_load)
    opt_equal = (loaded["state"]["count"] == saved["optimizer_state"]["count"] and all(
        torch.equal(loaded["state"]["trace"][n], t)
        for n, t in saved["optimizer_state"]["trace"].items()))
    ckpt_bytes = os.path.getsize(ckpt)
    parts["launcher_s"] = time.perf_counter() - t0
    for path in (ckpt, os.path.join(OUT_DIR, "ddp_resumed", "checkpoints",
                                    "checkpoint_epoch_00002.pyth")):
        if os.path.exists(path):
            os.remove(path)  # weights and momentum: too large to keep among the run's files
    epochs = {name: [s["epoch"] for s in run["logged"] if s["_type"] == "train_epoch"]
              for name, run in (("first", first), ("resumed", resumed))}
    launches = {k: first["launches"][k] + resumed["launches"][k] for k in first["launches"]}
    row = {"phase": "ddp_slice", "world_size": 1, "backend": first["cfg"].DIST_BACKEND,
           "norm_type": first["cfg"].BN.NORM_TYPE, "fp32": fp32,
           "bf16_step": {"clips": CNN_TRAIN_CLIPS, **timing,
                         "group_over_plain_ms": timing["group"]["step_p50_ms"] - plain_ms,
                         "group_over_plain_kernel_ms": timing["group"]["kernel_ms"]
                         - plain_kernel_ms},
           "launcher": {"steps": [s["ms"] for s in first["steps"]],
                        "resumed_steps": [s["ms"] for s in resumed["steps"]],
                        "step_p50_ms": statistics.median(
                            s["ms"] for s in first["steps"] + resumed["steps"]),
                        "epochs": epochs, "resumed_start_epoch": loaded["epoch"],
                        "saved_epoch": saved["epoch"], "optimizer_bit_equal": opt_equal,
                        "val_epochs": [s["epoch"] for s in resumed["logged"]
                                       if s["_type"] == "val_epoch"],
                        "checkpoint_bytes": ckpt_bytes},
           "launches": launches, "phase_s": time.perf_counter() - t_phase, **parts}
    emit(row)
    check(all(e <= DDP_LOSS_TOL for e in fp32["loss_rel_err"]), f"fp32 losses: {fp32}")
    check(all(e <= DDP_GRAD_TOL for e in fp32["grad_rel_l2"]), f"fp32 gradients: {fp32}")
    check(all(np.isfinite(s["loss"]) and s["clips"] == CNN_TRAIN_CLIPS
              for s in first["steps"] + resumed["steps"]) and len(first["steps"]) == 4
          and len(resumed["steps"]) == 4, f"launcher steps: {first['steps']}, "
                                          f"{resumed['steps']}")
    check(epochs == {"first": ["1/1"], "resumed": ["2/2"]}, f"epochs {epochs}")
    check(loaded["epoch"] == saved["epoch"] + 1 == 1 and opt_equal,
          f"resume: epoch {loaded['epoch']}, optimizer equal {opt_equal}")
    for run in (first, resumed):
        check(run["launches"]["preprocess_u8"] == 4 + 4 + 4 and only_launched(
            run["launches"], (), 0), f"launches {run['launches']}: 4 steps + 4 precise-BN "
                                     "batches + 4 val batches expected, no attention kernel")
    return row


# --- SSL under data parallelism, and the pytorchvideo recipes -----------------------

SSL_DDP_RECIPES = ("moco", "simclr", "swav")
SSL_DDP_CLIPS = 4  # the fp32 steps' clips (the MLP heads' BN needs more than 2)
SSL_DDP_TIMED_CLIPS = 16
SSL_DDP_LAUNCHER_CLIPS = 8
SSL_DDP_LAUNCHER_STEPS = 2  # an epoch of the launcher's run; 4 until PR 18


def ssl_group_step(cfg, state, ssl0, batch, grouped):
    """One fp32 SSL step (TF32 off) of ``cfg`` on the card from ``state``
    and ``ssl0``, its draws from a generator seeded anew, in a NCCL group
    of one or with no group: the loss, the gradients (on the CPU) and the
    SSL state after it."""
    model, opt, ssl, step = ssl_setup(cfg, "cuda", 1, generator=torch.Generator(
        device="cuda").manual_seed(3))
    model.load_state_dict(state, strict=True)
    ssl.load_state_dict(ssl0)
    step.keep_grads = True
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with process_group(cfg) if grouped else contextlib.nullcontext():
            loss = step(batch)["loss"].item()
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    grads = {n: g.cpu() for n, g in step.last_grads.items()}
    out = (loss, grads, ssl.state_dict())
    del model, opt, ssl, step
    return out


def ssl_state_diff(got, want):
    """Per part of two ``SSLState.state_dict()``s: whether it is equal, and
    the largest absolute difference of a tensor part."""
    out = {}
    for k, v in want.items():
        if isinstance(v, dict):
            diffs = [(got[k][n].double() - t.double()).abs().max().item() for n, t in v.items()
                     if t.is_floating_point()]
            out[k] = {"equal": all(torch.equal(got[k][n], t) for n, t in v.items()),
                      "max_abs_diff": max(diffs, default=0.0)}
        elif isinstance(v, torch.Tensor):
            out[k] = {"equal": torch.equal(got[k], v),
                      "max_abs_diff": (got[k].double() - v.double()).abs().max().item()}
        else:
            out[k] = {"equal": got[k] == v, "value": v}
    return out


def ssl_timed(cfg, batch, grouped, steps=4):
    """Host ms of ``steps`` bf16 SSL steps (each to a synchronize) after one
    untimed step, past MoCo's warm-up, and the peak memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    model, opt, ssl, step = ssl_setup(cfg, "cuda", 1, first_iter=1,
                                      generator=torch.Generator(device="cuda"))
    with process_group(cfg) if grouped else contextlib.nullcontext():
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, opt, ssl, step
    p50 = statistics.median(ms)
    return {"step_ms": ms, "step_p50_ms": p50,
            "clips_per_s": batch["index"].shape[0] / p50 * 1e3, "max_memory_allocated": peak}


def launcher_ssl(argv, out_dir, on_load=None):
    """``run_net``'s SSL config of ``argv`` (the MoCo recipe) trained by the
    launcher's rank entry (``utils.multiprocessing.run``) as rank 0 of a
    NCCL group of one; ``on_load(model, ssl)`` sees what the checkpoint
    load gave. Returns the config, the trained model and SSL state, the
    launches and the logged stats."""
    import tempfile

    from slowfast_tpu_torch.config import assert_and_infer_cfg
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.utils.multiprocessing import run
    from slowfast_tpu_torch.utils.parser import load_config, parse_args

    rendezvous = tempfile.mkdtemp(prefix="ddp_rendezvous_")
    args = parse_args(["--cfg", SSL_YAML["moco"], "--init_method",
                       "file://" + os.path.join(rendezvous, "store"), "--opts", *argv,
                       "OUTPUT_DIR", out_dir])
    cfg = assert_and_infer_cfg(load_config(args, SSL_YAML["moco"]))
    load = trainer.cu.load_train_checkpoint

    def reporting_load(cfg, model, optimizer, ssl=None):
        epoch = load(cfg, model, optimizer, ssl)
        if on_load is not None:
            on_load(model, ssl)
        return epoch

    trainer.cu.load_train_checkpoint = reporting_load
    reset_launches()
    t0 = time.perf_counter()
    try:
        model, ssl = run(0, trainer.train, cfg, "cuda")
    finally:
        trainer.cu.load_train_checkpoint = load
        shutil.rmtree(rendezvous, ignore_errors=True)
    launches = read_launches()
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    return {"cfg": cfg, "model": model, "ssl": ssl, "launches": launches, "logged": logged,
            "wall_s": time.perf_counter() - t0}


def phase_ssl_ddp(corpus):
    """The SSL collectives under data parallelism, one NCCL rank (one card
    holds one rank), at full width: MoCo (MoCo_SlowR50_8x8.yaml, the
    multi-view queue), SimCLR and SwAV (their MLP heads' BN). Per recipe an
    fp32 step (TF32 off) in a group of one against the same step from the
    same state with no group: loss within 1e-5, gradients within 1e-4
    relative L2, the queue rows, pointer, bank rows and momentum encoder
    equal. The bf16 MoCo step of 16 clips with and without the group: p50
    ms, clips/s, peak memory. Then the launcher's rank entry on run_net's
    MoCo config over the mp4 corpus: one epoch of 2 steps of 8 clips, the
    kNN probe and the checkpoint, and a second run that auto-resumes from
    it, its model and SSL state bit-equal to the first run's end."""
    import tempfile

    from slowfast_tpu_torch.utils import checkpoint as cu

    t_phase = time.perf_counter()
    fp32 = {}
    for t in SSL_DDP_RECIPES:
        cfg = family_cfg(SSL_YAML[t], ["TPU.COMPUTE_DTYPE", "float32",
                                       "TRAIN.BATCH_SIZE", str(SSL_DDP_CLIPS)], "ssl_ddp")
        model, _, ssl, _ = ssl_setup(cfg, "cpu", 1)
        randomize_bn(model, 5)
        if ssl.hist is not None:
            ssl.hist.load_state_dict(model.backbone.state_dict())
        state, ssl0 = {k: v.clone() for k, v in model.state_dict().items()}, ssl.state_dict()
        del model, ssl
        batch = ssl_float_batch(cfg, SSL_DDP_CLIPS, 9)
        reset_launches()
        plain = ssl_group_step(cfg, state, ssl0, batch, False)
        group = ssl_group_step(cfg, state, ssl0, batch, True)
        launches = read_launches()
        names = sorted(plain[1])
        state_diff = ssl_state_diff(group[2], plain[2])
        fp32[t] = {"clips": SSL_DDP_CLIPS, "loss": group[0], "plain_loss": plain[0],
                   "loss_rel_err": abs(group[0] - plain[0]) / abs(plain[0]),
                   "grad_rel_l2": rel_l2(group[1], plain[1], names),
                   "same_grad_names": sorted(group[1]) == names,
                   "ssl_state": state_diff, "launches": launches}
        check(fp32[t]["loss_rel_err"] <= DDP_LOSS_TOL and fp32[t]["grad_rel_l2"] <= DDP_GRAD_TOL
              and fp32[t]["same_grad_names"], f"ssl_ddp {t}: {fp32[t]}")
        check(all(d["equal"] for d in state_diff.values()), f"ssl_ddp {t} state: {state_diff}")
        check(only_pool_bwd(launches), f"ssl_ddp {t} launched {launches}")
    fp32_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    cfg = family_cfg(SSL_YAML["moco"], ["TPU.COMPUTE_DTYPE", "bfloat16",
                                        "TRAIN.BATCH_SIZE", str(SSL_DDP_TIMED_CLIPS)], "ssl_ddp")
    batch = ssl_float_batch(cfg, SSL_DDP_TIMED_CLIPS, 10)
    timing = {mode: ssl_timed(cfg, batch, mode == "group")
              for mode in ("plain", "group", "plain_again")}
    plain_ms = statistics.mean([timing["plain"]["step_p50_ms"],
                                timing["plain_again"]["step_p50_ms"]])
    timed_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    n = SSL_DDP_LAUNCHER_CLIPS
    out_dir = os.path.join(OUT_DIR, "ssl_ddp")
    shutil.rmtree(out_dir, ignore_errors=True)
    base = ["NUM_GPUS", "1", "TRAIN.BATCH_SIZE", str(n), "TEST.ENABLE", "False",
            "LOG_PERIOD", "1",
            *kinetics_split(corpus, "ssl_ddp", SSL_DDP_LAUNCHER_STEPS * n)]
    with removed_after(os.path.join(out_dir, "checkpoints")):
        first = launcher_ssl(base + ["SOLVER.MAX_EPOCH", "1"], out_dir)
        ckpt = cu.get_last_checkpoint(out_dir, first["cfg"].TASK)
        check(ckpt is not None, f"no SSL checkpoint in {out_dir}")
        ckpt_bytes = os.path.getsize(ckpt)
        want_model = {k: v.detach().cpu().clone()
                      for k, v in first["model"].state_dict().items()}
        want_ssl = first["ssl"].state_dict()
        del first["model"], first["ssl"]
        loaded = {}

        def on_load(model, ssl):
            loaded["model"] = {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}
            loaded["ssl"] = ssl.state_dict()

        resumed = launcher_ssl(base + ["SOLVER.MAX_EPOCH", "2"], out_dir, on_load)
        del resumed["model"], resumed["ssl"]
        # The resumed run appends to the first run's json_stats.log.
        resumed["logged"] = resumed["logged"][len(first["logged"]):]
    model_equal = all(torch.equal(loaded["model"][k], v) for k, v in want_model.items())
    ssl_diff = ssl_state_diff(loaded["ssl"], want_ssl)
    epochs = {name: [s["epoch"] for s in run["logged"] if s["_type"] == "train_epoch"]
              for name, run in (("first", first), ("resumed", resumed))}
    knn = [s["top1_acc"] for s in resumed["logged"] if s["_type"] == "knn_epoch"]
    iters = {name: sum(s["_type"] == "train_iter" for s in run["logged"])
             for name, run in (("first", first), ("resumed", resumed))}
    launcher_s = time.perf_counter() - t0
    row = {"phase": "ssl_ddp", "world_size": 1, "backend": first["cfg"].DIST_BACKEND,
           "fp32": fp32,
           "bf16_moco_step": {"clips": SSL_DDP_TIMED_CLIPS, **timing,
                              "group_over_plain_ms": timing["group"]["step_p50_ms"] - plain_ms},
           "launcher": {"clips_per_step": n, "epochs": epochs, "train_iters": iters,
                        "knn_top1": knn, "checkpoint_bytes": ckpt_bytes,
                        "resumed_model_bit_equal": model_equal, "resumed_ssl_state": ssl_diff,
                        "first_wall_s": first["wall_s"], "resumed_wall_s": resumed["wall_s"],
                        "launches": {k: first["launches"][k] + resumed["launches"][k]
                                     for k in first["launches"]}},
           "fp32_s": fp32_s, "timed_s": timed_s, "launcher_s": launcher_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(epochs == {"first": ["1/1"], "resumed": ["2/2"]}
          and iters == {"first": SSL_DDP_LAUNCHER_STEPS, "resumed": SSL_DDP_LAUNCHER_STEPS},
          f"launcher epochs {epochs}, iterations {iters}")
    check(model_equal and all(d["equal"] for d in ssl_diff.values()),
          f"resumed state differs: model {model_equal}, SSL {ssl_diff}")
    check(len(knn) == 1 and 0.0 <= knn[0] <= 100.0, f"kNN lines {knn}")
    check(only_pool_bwd(row["launcher"]["launches"]),
          f"the SSL launcher runs launched {row['launcher']['launches']}")
    return row


PTV_SLOWFAST_YAML = os.path.join(PTV_YAML, "SLOWFAST_4x16_R50.yaml")
PTV_MVIT_YAML = os.path.join(PTV_YAML, "MVIT_B_16x4_CONV.yaml")
# The scalars the trainer's TensorBoard writer takes (the JAX trainer's).
TB_TAGS = ["Train/Top1_err", "Train/Top5_err", "Train/loss", "Train/lr", "Val/top1_err",
           "Val/top5_err"]


def tensorboard_scalars(log_dir):
    """The scalar tags and their step counts in the event files under
    ``log_dir``, and the files' count."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    files = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    return {"tags": {t: len(acc.Scalars(t)) for t in acc.Tags()["scalars"]}, "files": len(files)}


def phase_ptv_recipes(corpus):
    """The pytorchvideo recipes through run_net: SLOWFAST_4x16_R50
    (``Ptvkinetics``, ``PTVSlowFast``) trained as shipped, TensorBoard on,
    at full width in bf16 over the mp4 corpus: 4 steps of 16 clips, the
    recipe's precise BN (4 batches) and a val epoch, row 1 once per train,
    precise-BN and val batch, every scalar tag of the JAX trainer in the one
    event file. The same recipe with ``TPU.UINT8_PIPELINE False``: the
    float pathways the host normalizes, no launch of row 1, and on the same
    clips the host's normalization within 1e-6 of row 1's output. Every
    configs/Kinetics/pytorchvideo YAML built at full size on the card, and
    one held bf16 forward of the ``PTVMViT`` model (every flash call
    against flash_plain)."""
    import gc

    from slowfast_tpu_torch.data import utils as data_utils
    from slowfast_tpu_torch.data.kinetics import Kinetics
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops.preprocess import device_preprocess

    t_phase = time.perf_counter()
    n = CNN_TRAIN_CLIPS
    data = kinetics_split(corpus, "ptv", 4 * n)
    data[1] = "ptvkinetics"  # the recipe's dataset name, not kinetics_split's
    opts = data + ["TRAIN.BATCH_SIZE", str(n), "DATA_LOADER.NUM_WORKERS", "8", "LOG_PERIOD", "1"]
    runs = {}
    for name, extra in (("uint8", []), ("float", ["TPU.UINT8_PIPELINE", "False"])):
        out_dir = os.path.join(OUT_DIR, f"ptv_{name}")
        with removed_after(os.path.join(out_dir, "checkpoints")):
            run = drive_train(PTV_SLOWFAST_YAML, opts + extra, out_dir)
        del run["model"]
        log_dir = os.path.join(out_dir, "runs-ptvkinetics")
        runs[name] = {"steps": run["steps"], "launches": run["launches"],
                      "val_batches": sum(s["_type"] == "val_iter" for s in run["logged"]),
                      "tensorboard": tensorboard_scalars(log_dir),
                      "max_memory_allocated": run["max_memory_allocated"],
                      "wall_s": run["wall_s"]}
        gc.collect()
        torch.cuda.empty_cache()
    train_s = time.perf_counter() - t_phase

    # The host's float pathways against row 1 on the same uint8 clips.
    cfg = family_cfg(PTV_SLOWFAST_YAML, data, "ptv_uint8")
    ds = Kinetics(cfg, "train")
    clips = np.stack([ds[i][0][0] for i in range(4)])
    host = [data_utils.pack_pathway_output(cfg, data_utils.tensor_normalize(
        c, cfg.DATA.MEAN, cfg.DATA.STD)) for c in clips]
    card = device_preprocess(torch.from_numpy(clips).cuda(), cfg.DATA.MEAN, cfg.DATA.STD,
                             alpha=cfg.SLOWFAST.ALPHA, single_pathway=False,
                             out_dtype=torch.float32,
                             reverse_channels=cfg.DATA.REVERSE_INPUT_CHANNEL)
    float_err = max((card[p].cpu() - torch.from_numpy(np.stack([h[p] for h in host]))).abs()
                    .max().item() for p in range(2))

    # Every recipe of the directory built at full size on the card.
    t0 = time.perf_counter()
    built = {}
    for yaml in sorted(os.listdir(PTV_YAML)):
        bcfg = family_cfg(os.path.join(PTV_YAML, yaml), [], "ptv_build")
        model = build_model(bcfg, device="cuda")
        built[yaml] = {"model": bcfg.MODEL.MODEL_NAME, "class": type(model).__name__,
                       "params": sum(p.numel() for p in model.parameters())}
        del model
    gc.collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0

    # One held bf16 forward of PTVMViT.
    mcfg = family_cfg(PTV_MVIT_YAML, ["TPU.COMPUTE_DTYPE", "bfloat16"], "ptv_mvit")
    model = build_model(mcfg, device="cuda")
    eval_fn = make_eval_step(mcfg, model)
    batch = uint8_train_batch(mcfg, 4, 12)
    reset_launches()
    with FlashShadow() as shadow:
        preds = eval_fn({"inputs": batch["inputs"]})
        torch.cuda.synchronize()
    mvit_launches = read_launches()
    finite = bool(torch.isfinite(preds.float()).all().item())
    depth = mcfg.MVIT.DEPTH
    del model, eval_fn
    launches = {k: runs["uint8"]["launches"][k] + runs["float"]["launches"][k]
                + mvit_launches[k] for k in mvit_launches}
    row = {"phase": "ptv_recipes", "clips_per_step": n, "runs": runs,
           "float_vs_row_1_max_abs_err": float_err, "built": built, "build_s": build_s,
           "ptvmvit": {"class": built["MVIT_B_16x4_CONV.yaml"]["class"], "clips": 4,
                       "finite": finite, "launches": mvit_launches,
                       "flash_shadow_checks": shadow.check("ptv_recipes PTVMViT", depth, 0)},
           "train_s": train_s, "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    u8, fl = runs["uint8"], runs["float"]
    for name, run in runs.items():
        check(len(run["steps"]) == 4 and all(s["clips"] == n for s in run["steps"])
              and run["val_batches"] >= 1, f"ptv {name} run: {run['steps']}")
        check(sorted(run["tensorboard"]["tags"]) == TB_TAGS and run["tensorboard"]["files"] == 1
              and run["tensorboard"]["tags"]["Train/loss"] == 4,
              f"ptv {name} TensorBoard: {run['tensorboard']}")
        check(only_launched(run["launches"], (), 0), f"ptv {name} launches {run['launches']}")
    check(u8["launches"]["preprocess_u8"] == 4 + 4 + u8["val_batches"],
          f"row 1 launches {u8['launches']}: 4 steps, 4 precise-BN and the val batches expected")
    check(fl["launches"]["preprocess_u8"] == 0, f"float run launched row 1: {fl['launches']}")
    check(float_err <= 1e-6, f"host float pathways vs row 1: {float_err}")
    check(len(built) == 15 and built["MVIT_B_16x4_CONV.yaml"]["class"] == "MViT",
          f"built {built}")
    check(finite and only_launched(mvit_launches, ("attention_flash",), depth)
          and mvit_launches["preprocess_u8"] == 1, f"PTVMViT forward launches {mvit_launches}")
    return {"launches": launches}


# --- the tools (PR 18): the visualize tool with Grad-CAM, MAE's renders, the
# demo and the data-loading benchmark -----------------------------------------

VIS_CLIPS = 16  # two test batches of 8 (bench.py's eval B)
# MODEL_VIS's layers: a 28² block and a 7² one; Grad-CAM on the last 14²
# block, so its backward runs row 7 in blocks 14 and 15.
VIS_LAYERS = ["blocks/2", "blocks/14"]
VIS_CAM_LAYER = "blocks/13"
# Grad-CAM on the max prediction is discontinuous where two classes tie:
# a bf16 forward that flips one clip's argmax moves that clip's gradient
# entirely (dS/dA 58% apart in relative L2 with one flip, PR 18 calls
# 2-4). So the held maps take a fixed class a clip (GRAD_CAM.USE_TRUE_LABEL),
# and the kernels' bf16 map and gradient are held to the plain versions'
# fp32 ones: within twice the distance of the plain versions in bf16.
VIS_CAM_FACTOR = 2.0
SF_CAM_TOL = 1e-4  # SlowFast's two-pathway maps, fp32, card vs CPU
SF_CAM_LAYERS = ["s5/pathway0_res2", "s5/pathway1_res2"]
DEMO_BUFFER = 56  # the demo's overlap: a clip every 8 frames
DEMO_TOL = 1e-5  # the threaded, two-in-flight demo against the plain one
BENCH_CLIPS = 64
CORE_BUDGET_SAMPLES = 16


class PlainFlashCore(torch.autograd.Function):
    """Rows 6 and 7's plain versions as one core: ``flash_plain`` forward,
    ``flash_bwd_plain`` backward (the kernels' rounding of ``e``, ``do/s``
    and ``dl`` to the input dtype, step by step)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        from slowfast_tpu_torch.ops import attention as ta

        ctx.save_for_backward(qh, kh, vh)
        return ta.flash_plain(qh, kh, vh)

    @staticmethod
    def backward(ctx, do):
        from slowfast_tpu_torch.ops import attention as ta

        return ta.flash_bwd_plain(*ctx.saved_tensors, do.contiguous())


@contextlib.contextmanager
def plain_flash_core():
    """MViT's attention core on ``PlainFlashCore`` in place of rows 6 and
    7."""
    from slowfast_tpu_torch.ops import attention as ta

    kernel_core = ta.flash_pooled_attention
    ta.flash_pooled_attention = PlainFlashCore.apply
    try:
        yield
    finally:
        ta.flash_pooled_attention = kernel_core


@contextlib.contextmanager
def no_tf32():
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def histogram_tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"histograms": 0})
    acc.Reload()
    return sorted(acc.Tags()["histograms"])


def phase_vis_tools():
    """The visualize tool through run_net on MViTv2-S 16x4 in bf16: seeded
    weights saved as a port checkpoint, the multi-view test of 16 synthetic
    clips (its predictions pickled), then MODEL_VIS (the weight and
    first-batch activation histograms of two blocks, Grad-CAM on one) and
    WRONG_PRED_VIS with the test's pickle as PREDICTIONS_PATH; every flash
    call held against its plain version, rows 1, 6 and 7 counted; the
    activation heatmaps stay off, as matplotlib is not on the card's host.
    Then Grad-CAM of one batch at its labels, with the kernels and with
    their plain versions, in bf16 and in fp32: the kernels' bf16 map and
    gradient within twice the plain versions' bf16 distance of the plain
    versions' fp32 ones, the fp32 kernels' map within 1e-4 of it; and
    SlowFast 4x16's two-pathway Grad-CAM, fp32, card against CPU."""
    import pickle
    import tempfile

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.visualization.gradcam import GradCAM, class_activation_map

    t_phase = time.perf_counter()
    out_dir = os.path.join(OUT_DIR, "vis_tools")
    shutil.rmtree(out_dir, ignore_errors=True)
    results = os.path.join(out_dir, "test.pkl")
    opts = ["NUM_GPUS", "1", "TRAIN.ENABLE", "False", "TEST.ENABLE", "True",
            "TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", str(VIS_CLIPS),
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "TEST.BATCH_SIZE", "8",
            "TEST.SAVE_RESULTS_PATH", results, "TENSORBOARD.ENABLE", "True",
            "TENSORBOARD.MODEL_VIS.ENABLE", "True", "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True",
            "TENSORBOARD.MODEL_VIS.LAYER_LIST", str(VIS_LAYERS),
            "TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST", str([VIS_CAM_LAYER]),
            "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True",
            "TENSORBOARD.PREDICTIONS_PATH", results]
    cfg = family_cfg(MVIT_YAML, opts[2:], "vis_tools")
    ckpt_dir = tempfile.mkdtemp(prefix="vis_tools_")
    try:
        ckpt = os.path.join(ckpt_dir, "mvit.pyth")
        model = build_model(cfg, device="cuda")
        torch.save({"model_state": model.state_dict()}, ckpt)
        n_params = {layer: len(list(model.get_submodule(layer.replace("/", ".")).parameters()))
                    for layer in VIS_LAYERS}
        os.makedirs(out_dir)
        argv = ["--cfg", MVIT_YAML, "--opts", *opts, "OUTPUT_DIR", out_dir,
                "TEST.CHECKPOINT_FILE_PATH", ckpt]
        reset_launches()
        t0 = time.perf_counter()
        with FlashShadow() as shadow:
            run_net.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        with open(results, "rb") as f:
            saved_preds = pickle.load(f)[0]
        tags = histogram_tags(os.path.join(out_dir, "runs-kinetics"))

        # Grad-CAM on one batch with the kernels and with their plain
        # versions, in bf16 and in fp32 (TF32 off), the head tempered so the
        # softmax is neither flat nor saturated; each against the plain
        # versions in fp32.
        batch = uint8_train_batch(cfg, 8, 40)
        temper_head(model, batch["inputs"][0], cfg)
        cfg32 = family_cfg(MVIT_YAML, opts[2:] + ["TPU.COMPUTE_DTYPE", "float32"], "vis_tools")
        model32 = build_model(cfg32, device="cuda")
        model32.load_state_dict(model.state_dict(), strict=True)
        variants = {}
        for name, m, c, plain in (("kernels_bf16", model, cfg, False),
                                  ("plain_bf16", model, cfg, True),
                                  ("kernels_fp32", model32, cfg32, False),
                                  ("plain_fp32", model32, cfg32, True)):
            x = maybe_device_preprocess(c, batch["inputs"])
            with (plain_flash_core() if plain else contextlib.nullcontext()), no_tf32():
                reset_launches()
                t0 = time.perf_counter()
                preds, act, grads, thw = GradCAM(m, [VIS_CAM_LAYER]).layer_gradients(
                    x, VIS_CAM_LAYER, batch["labels"], use_labels=True)
                cam = class_activation_map(act.float(), grads.float(), thw)
                torch.cuda.synchronize()
                variants[name] = {"preds": preds.float(), "act": act.float(),
                                  "grads": grads.float(), "cam": cam, "launches": read_launches(),
                                  "ms": (time.perf_counter() - t0) * 1e3}
        del model, model32, x
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = variants["plain_fp32"]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    cam_err = {name: {"cam_max_abs": (v["cam"] - ref["cam"]).abs().max().item(),
                      "cam_mean_abs": (v["cam"] - ref["cam"]).abs().mean().item(),
                      "act_rel_l2": rel(v["act"], ref["act"]),
                      "grads_rel_l2": rel(v["grads"], ref["grads"]),
                      "preds_max_abs": (v["preds"] - ref["preds"]).abs().max().item(),
                      "argmax_flips": int((v["preds"].argmax(-1) != ref["preds"].argmax(-1))
                                          .sum().item()),
                      "ms": v["ms"]}
               for name, v in variants.items() if name != "plain_fp32"}
    cam_launches = variants["kernels_bf16"]["launches"]
    cams = [variants["kernels_bf16"]["cam"].cpu().numpy()]

    # SlowFast's two-pathway maps, fp32, card against CPU.
    scfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    cpu_model = build_model(scfg, device="cpu")
    randomize_bn(cpu_model, 5)
    clip = np.random.RandomState(6).randint(
        0, 256, (1, scfg.DATA.NUM_FRAMES, scfg.DATA.TEST_CROP_SIZE, scfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8)
    temper_head(cpu_model, clip, scfg)
    gpu_model = build_model(scfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    t0 = time.perf_counter()
    want, want_preds = GradCAM(cpu_model, SF_CAM_LAYERS)(
        maybe_device_preprocess(scfg, [torch.from_numpy(clip)]))
    sf_cpu_s = time.perf_counter() - t0
    with no_tf32():
        got, got_preds = GradCAM(gpu_model, SF_CAM_LAYERS)(
            maybe_device_preprocess(scfg, [torch.from_numpy(clip).cuda()]))
    sf_err = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    del cpu_model, gpu_model

    depth = cfg.MVIT.DEPTH
    tail = depth - 1 - int(VIS_CAM_LAYER.split("/")[1])  # blocks after the target
    batches = VIS_CLIPS // 8
    want_tags = ({f"weights/{layer}/{i}" for layer in VIS_LAYERS for i in range(n_params[layer])}
                 | {f"activations/{layer}" for layer in VIS_LAYERS} | {"gradcam/pathway0"})
    row = {"phase": "vis_tools", "clips": VIS_CLIPS, "layers": VIS_LAYERS,
           "grad_cam_layer": VIS_CAM_LAYER, "run_s": run_s, "launches": launches,
           "flash_shadow_checks": shadow.stats, "histogram_tags": len(tags),
           "saved_videos": len(saved_preds),
           "grad_cam": {"launches": cam_launches, "vs_plain_fp32": cam_err,
                        "map_shape": list(cams[0].shape),
                        "fp32_launches": variants["kernels_fp32"]["launches"],
                        "max_prob": ref["preds"].max().item()},
           "slowfast_fp32": {"layers": SF_CAM_LAYERS, "card_vs_cpu_max_abs": sf_err,
                             "tol": SF_CAM_TOL, "map_shapes": [list(g.shape) for g in got],
                             "preds_max_abs": float(np.abs(got_preds - want_preds).max()),
                             "cpu_s": sf_cpu_s},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    # Rows 1 and 6: the test's and the visualize tool's batches, the first
    # batch again for the activations and for Grad-CAM; row 7: Grad-CAM's
    # backward through the blocks after its layer.
    check(only_launched(launches, ("attention_flash", "attention_flash_bwd"), None)
          and launches["preprocess_u8"] == 2 * batches + 1
          and launches["attention_flash"] == depth * (2 * batches + 2)
          and launches["attention_flash_bwd"] == tail, f"vis_tools launches {launches}")
    shadow.check("vis_tools", depth * (2 * batches + 2), tail)
    check(want_tags <= set(tags), f"vis_tools tags {tags} lack {want_tags - set(tags)}")
    check(len(saved_preds) == VIS_CLIPS, f"saved predictions {len(saved_preds)}")
    check(only_launched(cam_launches, ("attention_flash", "attention_flash_bwd"), None)
          and cam_launches["attention_flash"] == depth
          and cam_launches["attention_flash_bwd"] == tail, f"Grad-CAM launches {cam_launches}")
    k, p = cam_err["kernels_bf16"], cam_err["plain_bf16"]
    check(np.isfinite(cams[0]).all() and cams[0].max() > 0.5
          and all(k[key] <= VIS_CAM_FACTOR * p[key]
                  for key in ("cam_max_abs", "cam_mean_abs", "grads_rel_l2"))
          and cam_err["kernels_fp32"]["cam_max_abs"] <= SF_CAM_TOL,
          f"Grad-CAM, kernels against the plain versions' fp32 map: {cam_err}")
    check(max(sf_err) <= SF_CAM_TOL and min(g.max() for g in got) > 0.5,
          f"SlowFast Grad-CAM card vs CPU: {sf_err}")
    return {"launches": launches}


def phase_mae_vis(corpus):
    """MAE's reconstruction renders: the ViT-B MAE recipe's test of 8
    decoded clips under VIS_MASK.ENABLE through run_net, every flash call
    held; one mp4 a clip, which cv2 reads back as T frames of H x 3W."""
    from slowfast_tpu_torch import run_net

    t_phase = time.perf_counter()
    n = 8
    out_dir = os.path.join(OUT_DIR, "mae_vis")
    shutil.rmtree(out_dir, ignore_errors=True)
    data_dir = os.path.join(corpus, "mae_vis")
    os.makedirs(data_dir, exist_ok=True)
    videos = open(os.path.join(corpus, "videos.csv")).read().splitlines()
    with open(os.path.join(data_dir, "test.csv"), "w") as f:
        f.writelines(v + "\n" for v in videos[:n])
    opts = ["NUM_GPUS", "1", "TRAIN.ENABLE", "False", "TEST.ENABLE", "True",
            "TEST.DATASET", "kinetics", "DATA.PATH_TO_DATA_DIR", data_dir,
            "TEST.BATCH_SIZE", str(n), "TEST.NUM_ENSEMBLE_VIEWS", "1",
            "TEST.NUM_SPATIAL_CROPS", "1", "VIS_MASK.ENABLE", "True",
            "DATA_LOADER.NUM_WORKERS", "8"]
    cfg = family_cfg(MAE_YAML, opts[2:], "mae_vis")
    blocks = masked_blocks(cfg)
    vid_dir = os.path.join(out_dir, "vis_mask", "vid")
    with removed_after(vid_dir):
        reset_launches()
        t0 = time.perf_counter()
        with FlashShadow() as shadow:
            run_net.main(["--cfg", MAE_YAML, "--opts", *opts, "OUTPUT_DIR", out_dir])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        names = sorted(os.listdir(vid_dir))
        shapes = {}
        for name in names:
            frames = read_video(os.path.join(vid_dir, name))
            shapes[name] = [len(frames)] + (list(frames[0].shape) if frames else [])
    shown = cfg.DATA.NUM_FRAMES // cfg.MVIT.PATCH_STRIDE[0] if cfg.MASK.TIME_STRIDE_LOSS \
        else cfg.DATA.NUM_FRAMES
    crop = cfg.DATA.TEST_CROP_SIZE
    emit({"phase": "mae_vis", "clips": n, "blocks": blocks, "videos": names, "shapes": shapes,
          "launches": launches, "flash_shadow_checks": shadow.stats, "run_s": run_s,
          "phase_s": time.perf_counter() - t_phase})
    check(names == [f"vis_mask_mr{cfg.AUG.MASK_RATIO}_0_{i}.mp4" for i in range(n)],
          f"mae_vis videos {names}")
    check(all(s == [shown, crop, 3 * crop, 3] for s in shapes.values()),
          f"mae_vis frames {shapes}, want {shown} of {crop} x {3 * crop}")
    check(only_launched(launches, ("attention_flash",), blocks)
          and launches["preprocess_u8"] == 1, f"mae_vis launches {launches}")
    shadow.check("mae_vis", blocks, 0)
    return {"launches": launches}


def read_video(path, limit=None):
    """The frames of ``path`` (the first ``limit``), BGR uint8."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    ok, frame = cap.read()
    while ok and (limit is None or len(frames) < limit):
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    return frames


def demo_frames(n_frames, seq, buffer):
    """The frames the demo writes for ``n_frames`` input frames, clips of
    ``seq`` and ``buffer`` frames of overlap, as the JAX package's
    VideoManager reads and writes them: the first clip writes ``seq``, each
    later one ``seq - buffer``."""
    if n_frames < seq:
        return 0
    return seq + (n_frames - seq) // (seq - buffer) * (seq - buffer)


def phase_demo_slice(corpus):
    """The demo through run_net on SlowFast 4x16 R50 in bf16 over one corpus
    mp4 (a clip every 8 frames): once plain and once with the threaded
    reader and two clips in flight (AsyncPredictor), the same predictions;
    the frames written as the JAX demo writes them; the first clip's fp32
    prediction card against CPU; the p50 clip latency. Then the AVA live
    demo (SLOWFAST_32x2_R50_SHORT with the motion proposals: ROIAlign on
    every clip) and the precomputed-box visualizer on a csv of boxes and
    ground truth."""
    import csv

    from slowfast_tpu_torch import run_net
    from slowfast_tpu_torch.visualization import demo

    t_phase = time.perf_counter()
    out_dir = os.path.join(OUT_DIR, "demo_slice")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    src = open(os.path.join(corpus, "videos.csv")).readline().split()[0]
    n_frames = len(read_video(src))
    recorded = []

    class Recording(demo.Predictor):
        def __call__(self, task):
            t0 = time.perf_counter()
            task = super().__call__(task)
            recorded[-1].append((task.id, task.action_preds, (time.perf_counter() - t0) * 1e3))
            return task

    base = ["NUM_GPUS", "1", "TRAIN.ENABLE", "False", "TEST.ENABLE", "False", "DEMO.ENABLE",
            "True", "DEMO.INPUT_VIDEO", src, "OUTPUT_DIR", out_dir]
    runs = {}
    real = demo.Predictor
    demo.Predictor = Recording
    try:
        for name, extra in (("plain", ["DEMO.THREAD_ENABLE", "False", "DEMO.NUM_VIS_INSTANCES",
                                       "1"]),
                            ("threaded", ["DEMO.THREAD_ENABLE", "True",
                                          "DEMO.NUM_VIS_INSTANCES", "2"])):
            recorded.append([])
            out = os.path.join(out_dir, f"{name}.mp4")
            reset_launches()
            t0 = time.perf_counter()
            run_net.main(["--cfg", YAML, "--opts", *base, "DEMO.BUFFER_SIZE", str(DEMO_BUFFER),
                          "DEMO.OUTPUT_FILE", out, *extra])
            runs[name] = {"wall_s": time.perf_counter() - t0, "launches": read_launches(),
                          "clips": [r[0] for r in recorded[-1]],
                          "clip_ms": [r[2] for r in recorded[-1]],
                          "frames": len(read_video(out))}
        plain, threaded = ({i: p for i, p, _ in rec} for rec in recorded)
    finally:
        demo.Predictor = real
    preds_err = max(float(np.abs(plain[i] - threaded[i]).max()) for i in plain)
    cfg = slowfast_cfg(["DEMO.BUFFER_SIZE", str(DEMO_BUFFER)])
    seq = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
    want_frames = demo_frames(n_frames, seq, DEMO_BUFFER)

    # The first clip's prediction in fp32, card against CPU.
    fcfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    task = demo.TaskInfo()
    task.frames = read_video(src, seq)
    cpu_pred = demo.Predictor(fcfg, "cpu")
    randomize_bn(cpu_pred.model, 7)
    temper_head(cpu_pred.model, np.random.RandomState(8).randint(
        0, 256, (1, fcfg.DATA.NUM_FRAMES, fcfg.DATA.TEST_CROP_SIZE, fcfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8), fcfg)
    card_pred = demo.Predictor(fcfg, "cuda")
    card_pred.model.load_state_dict(cpu_pred.model.state_dict(), strict=True)
    want = cpu_pred(task).action_preds
    with no_tf32():
        got = card_pred(task).action_preds
    fp32_err = float(np.abs(got - want).max())
    del cpu_pred, card_pred

    # AVA: the live demo on the motion proposals, then precomputed boxes.
    ava = {}
    ava_base = base + ["DEMO.NUM_VIS_INSTANCES", "1"]
    reset_launches()
    t0 = time.perf_counter()
    run_net.main(["--cfg", DET_YAML, "--opts", *ava_base, "DEMO.BUFFER_SIZE", str(DEMO_BUFFER),
                  "DEMO.OUTPUT_FILE", os.path.join(out_dir, "ava_live.mp4")])
    ava["live"] = {"wall_s": time.perf_counter() - t0, "launches": read_launches(),
                   "frames": len(read_video(os.path.join(out_dir, "ava_live.mp4")))}
    boxes, gt = os.path.join(out_dir, "boxes.csv"), os.path.join(out_dir, "gt.csv")
    with open(boxes, "w") as f:
        csv.writer(f).writerows([["v", 900, 0.1, 0.1, 0.5, 0.9, 0.95],
                                 ["v", 900, 0.4, 0.2, 0.9, 0.95, 0.9]])
    with open(gt, "w") as f:
        csv.writer(f).writerows([["v", 900, 0.1, 0.1, 0.5, 0.9, 12],
                                 ["v", 900, 0.1, 0.1, 0.5, 0.9, 17]])
    reset_launches()
    t0 = time.perf_counter()
    run_net.main(["--cfg", DET_YAML, "--opts", *ava_base, "DEMO.PREDS_BOXES", boxes,
                  "DEMO.GT_BOXES", gt, "DEMO.OUTPUT_FILE", os.path.join(out_dir, "ava_boxes.mp4")])
    ava["boxes"] = {"wall_s": time.perf_counter() - t0, "launches": read_launches(),
                    "frames": len(read_video(os.path.join(out_dir, "ava_boxes.mp4")))}
    det_cfg_ = slowfast_cfg([], DET_YAML)
    det_seq = det_cfg_.DATA.NUM_FRAMES * det_cfg_.DATA.SAMPLING_RATE
    live_clips = len(range(0, n_frames - det_seq + 1, det_seq - DEMO_BUFFER))
    for f in ("plain.mp4", "threaded.mp4", "ava_live.mp4", "ava_boxes.mp4"):
        os.remove(os.path.join(out_dir, f))
    row = {"phase": "demo_slice", "video_frames": n_frames, "seq": seq,
           "buffer": DEMO_BUFFER, "frames_written_want": want_frames, "runs": runs,
           "clip_p50_ms": statistics.median(runs["plain"]["clip_ms"]),
           "threaded_clip_p50_ms": statistics.median(runs["threaded"]["clip_ms"]),
           "threaded_vs_plain_max_abs": preds_err, "tol": DEMO_TOL,
           "fp32_card_vs_cpu_max_abs": fp32_err, "fp32_tol": FULL_WIDTH_ATOL,
           "fp32_max_prob": float(want.max()), "ava": ava, "ava_live_clips": live_clips,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    n_clips = len(range(0, n_frames - seq + 1, seq - DEMO_BUFFER))
    for name, run in runs.items():
        check(run["frames"] == want_frames and run["clips"] == list(range(n_clips))
              and run["launches"]["preprocess_u8"] == 0
              and only_launched(run["launches"], (), 0), f"demo {name}: {run}")
    check(preds_err <= DEMO_TOL, f"threaded demo vs plain: {preds_err}")
    check(fp32_err <= FULL_WIDTH_ATOL and want.max() < 0.5, f"demo fp32 card vs CPU {fp32_err}")
    live, boxed = ava["live"], ava["boxes"]
    check(live["frames"] == demo_frames(n_frames, det_seq, DEMO_BUFFER)
          and live["launches"]["roi_align"] == 2 * live_clips, f"AVA live demo {live}")
    check(boxed["frames"] == n_frames // det_seq * det_seq
          and boxed["launches"]["roi_align"] == 2, f"AVA precomputed boxes {boxed}")
    return {"launches": {k: live["launches"][k] + boxed["launches"][k]
                         for k in live["launches"]}}


def phase_data_bench(corpus):
    """The data-loading benchmark (utils/benchmark.py) on the card's host:
    benchmark_data_loading for one epoch of SlowFast 4x16's train loader
    over 64 decoded clips (8 workers, batches of 16 landing on the card),
    and benchmark_core_budget, one worker's items over the same mp4s."""
    from slowfast_tpu_torch.utils.benchmark import benchmark_core_budget, benchmark_data_loading

    t_phase = time.perf_counter()
    data = kinetics_split(corpus, "data_bench", BENCH_CLIPS)
    out_dir = os.path.join(OUT_DIR, "data_bench")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg = family_cfg(YAML, data + ["TRAIN.BATCH_SIZE", str(CNN_TRAIN_CLIPS),
                                   "DATA_LOADER.NUM_WORKERS", "8", "BENCHMARK.NUM_EPOCHS", "1",
                                   "BENCHMARK.LOG_PERIOD", "1", "BENCHMARK.SHUFFLE", "True"],
                     "data_bench")
    rates = benchmark_data_loading(cfg, "cuda")
    with open(os.path.join(out_dir, "json_stats.log")) as f:
        records = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    budget = benchmark_core_budget(cfg, n_samples=CORE_BUDGET_SAMPLES, corpus=data[3])
    row = {"phase": "data_bench", "clips": BENCH_CLIPS, "batch": CNN_TRAIN_CLIPS, "workers": 8,
           "clips_per_s": rates[0], "batch_clips_per_s": [r["clips_per_s"] for r in records],
           "core_budget": budget, "core_budget_samples": CORE_BUDGET_SAMPLES,
           "host_cores": os.cpu_count(), "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check([(r["_type"], r["epoch"], r["iter"]) for r in records]
          == [("benchmark", 0, i + 1) for i in range(BENCH_CLIPS // CNN_TRAIN_CLIPS)]
          and all(r["clips_per_s"] > 0 for r in records), f"data_bench records {records}")
    check(budget["clips_per_core_sec"] > 0, f"core budget {budget}")
    return row


def capture_pool_calls(cfg, n, avg=False, crop=None):
    """``(input shape, kernel, stride, padding)`` of every max pool of one
    train-mode forward of ``cfg``'s model (bf16) on ``n`` seeded clips of
    ``crop`` (the train crop by default), in call order; with ``avg`` the
    ``(input shape, kernel, stride)`` of every average pool instead (the
    zero-padded fp32 input that ``ops.avg_pool.avg_pool3d`` takes)."""
    import gc

    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import avg_pool as ap
    from slowfast_tpu_torch.ops import max_pool as mp

    model = build_model(cfg, device="cuda")
    model.train()
    gen = torch.Generator(device="cuda").manual_seed(13)
    crop = crop or cfg.DATA.TRAIN_CROP_SIZE
    clip = torch.randint(0, 256, (n, cfg.DATA.NUM_FRAMES, crop, crop, 3), dtype=torch.uint8,
                         device="cuda", generator=gen)
    module, name = (ap, "avg_pool3d") if avg else (mp, "max_pool3d")
    calls, real = [], getattr(module, name)

    def recording(x, kernel, stride=None, padding=(0, 0, 0)):
        calls.append((tuple(x.shape), tuple(kernel), tuple(stride or kernel))
                     + (() if avg else (tuple(padding),)))
        return real(x, kernel, stride) if avg else real(x, kernel, stride, padding)

    setattr(module, name, recording)
    try:
        with torch.no_grad():
            model(maybe_device_preprocess(cfg, [clip]))
    finally:
        setattr(module, name, real)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return calls


# Small max pools on every edge of the backward's window arithmetic: odd
# sizes, padding, stride 2 in time, windows that reach past a 1 x 1 map,
# the key/value pools' stride 8, an odd channel count.
POOL_EDGE_CASES = [((2, 5, 17, 15, 5), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
                   ((1, 7, 9, 11, 3), (3, 3, 3), (1, 8, 8), (1, 1, 1)),
                   ((3, 6, 5, 7, 33), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
                   ((2, 3, 13, 13, 7), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
                   ((1, 4, 1, 1, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
                   ((2, 3, 9, 11, 6), (1, 3, 3), (1, 2, 2), (0, 1, 1))]


def maxpool_case(shape, kernel, stride, padding, dtype, seed, timed, strided=False):
    """The backward kernel against ``max_pool3d_bwd_plain`` on integer-valued
    inputs (windows full of ties) and a seeded output gradient in the
    model's NTHWC layout (with ``strided`` the gradient and the indices
    every other channel of wider tensors, which the kernel reads a channel
    at a time): bit-equality, a bit-equal relaunch, ATen's backward's
    distance; with ``timed`` the device times of the kernel, the plain
    version and ATen's ``max_pool3d_with_indices_backward`` (the library
    yardstick) and the byte bound."""
    import torch.nn.functional as F

    from slowfast_tpu_torch.ops import max_pool as mp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-4, 5, shape, device="cuda", generator=gen).to(dtype)
    xc = x.permute(0, 4, 1, 2, 3)
    y, idx = F.max_pool3d(xc, kernel, stride, padding, return_indices=True)
    go = torch.randn(y.permute(0, 2, 3, 4, 1).shape, device="cuda", generator=gen).to(dtype)
    idx5 = idx.permute(0, 2, 3, 4, 1)
    if strided:
        go, idx5 = (torch.stack([v, torch.zeros_like(v)], dim=-1).flatten(-2)[..., ::2]
                    for v in (go, idx5))
    args = (go, idx5, shape, dtype, kernel, stride, padding)
    got, again = mp._launch_bwd(*args), mp._launch_bwd(*args)
    want = mp.max_pool3d_bwd_plain(go, idx5, shape, kernel, stride, padding, dtype)

    def aten():
        return torch.ops.aten.max_pool3d_with_indices_backward(
            go.permute(0, 4, 1, 2, 3), xc, list(kernel), list(stride), list(padding), [1, 1, 1],
            False, idx)

    torch.cuda.synchronize()
    row = {"shape": list(shape), "kernel": list(kernel), "stride": list(stride),
           "padding": list(padding), "dtype": str(dtype).replace("torch.", ""),
           "strided": strided, "bit_equal_plain": torch.equal(got, want),
           "relaunch_bit_equal": torch.equal(got, again),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "aten_max_abs_diff": (got.float() - aten().permute(0, 2, 3, 4, 1).float())
           .abs().max().item()}
    if timed:
        nbytes = (go.numel() + x.numel()) * go.element_size() + idx.numel() * 8
        row.update(ms=device_ms(lambda: mp._launch_bwd(*args)),
                   plain_ms=device_ms(lambda: mp.max_pool3d_bwd_plain(
                       go, idx5, shape, kernel, stride, padding, dtype), iters=5),
                   library_ms=device_ms(aten), **roofline(go.numel(), nbytes, dtype))
    return row


def phase_maxpool_bwd_kernel():
    """The max-pool backward kernel (csrc/max_pool3d_bwd.cu) against its
    plain version at every pool of the full-width SlowFast 4x16 R50 and
    MViTv2-S 16x4 train steps at 16 clips, at ``POOL_EDGE_CASES`` and at a
    strided gradient, in bf16 and fp32, on integer-valued inputs full of
    ties: bit-equal (the plain version adds in the kernel's order and rounds
    once), bit-equal over two launches; per distinct main-path shape in bf16 the device
    time, the plain version's, ATen's backward's and the byte bound, and
    their sums over each step's pools. The kernels line takes the SlowFast
    step's pools in bf16, summed."""
    t0 = time.perf_counter()
    sf = capture_pool_calls(slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), CNN_TRAIN_CLIPS)
    mvit = capture_pool_calls(mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), TRAIN_CLIPS)
    check(sf and mvit, f"pools captured: SlowFast {len(sf)}, MViT {len(mvit)}")
    main_path = list(dict.fromkeys(sf + mvit))
    rows = {}
    for i, case in enumerate(main_path + POOL_EDGE_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            timed = case in main_path and dtype == torch.bfloat16
            rows[(case, dtype)] = maxpool_case(*case, dtype, 100 + i, timed)
    for dtype in (torch.bfloat16, torch.float32):
        rows[("strided", dtype)] = maxpool_case(*POOL_EDGE_CASES[0], dtype, 99, False,
                                                strided=True)
    cases = list(rows.values())
    bad = [r for r in cases if not (r["bit_equal_plain"] and r["relaunch_bit_equal"])]
    row = {"phase": "maxpool_bwd_kernel", "source": "slowfast_tpu_torch/csrc/max_pool3d_bwd.cu",
           "slowfast_pools": [list(c) for c in sf], "mvit_pools": [list(c) for c in mvit],
           "cases_checked": len(cases), "bit_equal": len(cases) - len(bad),
           "max_abs_err": max(r["max_abs_err"] for r in cases),
           "per_slowfast_step": per_step_sums(rows, sf, torch.bfloat16),
           "per_mvit_step": per_step_sums(rows, mvit, torch.bfloat16), "cases": cases,
           "seconds": time.perf_counter() - t0}
    emit(row)
    check(not bad, f"max-pool backward kernel differs from its plain version: {bad}")
    return row


def per_step_sums(rows, calls, dtype):
    """The timed rows of ``calls`` summed: a step's device time of the
    kernel, of its plain version and of ATen's backward, its bound and bytes,
    the kernel's time over ATen's and its share of the bound."""
    step = [rows[(c, dtype)] for c in calls]
    out = {"bound_by": "bytes", **{k: sum(r[k] for r in step)
                                   for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bytes")}}
    out.update(over_library=out["ms"] / out["library_ms"],
               share_of_bound=out["bound_ms"] / out["ms"])
    return out


# Small average pools on the edges of the backward: odd channel counts
# (one channel a thread), overlapping windows at stride 1 and 2, stride 2
# in time, windows that fill an axis, a 1 x 1 x 1 map.
AVG_POOL_EDGE_CASES = [((2, 4, 8, 8, 5), (4, 7, 7), (1, 1, 1)),
                       ((1, 4, 11, 11, 3), (3, 3, 3), (1, 2, 2)),
                       ((2, 3, 9, 9, 33), (3, 3, 3), (1, 4, 4)),
                       ((1, 7, 6, 7, 8), (3, 3, 3), (2, 1, 1)),
                       ((2, 2, 3, 3, 16), (2, 3, 3), (1, 1, 1)),
                       ((3, 1, 1, 1, 12), (1, 1, 1), (1, 1, 1))]


def avgpool_case(shape, kernel, stride, dtype, seed, timed, strided=False):
    """The average-pool backward kernel against ``avg_pool3d_bwd_plain`` on
    a seeded output gradient (with ``strided`` every other channel of a
    wider one, which the kernel reads a channel at a time): bit-equality, a
    bit-equal relaunch, ATen's backward's distance; with ``timed`` the
    device times of the kernel, the plain version and ATen's
    ``avg_pool3d_backward`` (the library yardstick, atomic adds) and the
    byte bound."""
    import math

    from slowfast_tpu_torch.ops import avg_pool as ap

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = [shape[0]] + [(shape[1 + a] - kernel[a]) // stride[a] + 1 for a in range(3)]
    go = torch.randn(out + [shape[4]], device="cuda", generator=gen,
                     dtype=torch.float64).to(dtype)
    if strided:
        go = torch.stack([go, torch.zeros_like(go)], dim=-1).flatten(-2)[..., ::2]
    args = (go, shape, kernel, stride)
    got, again = ap._launch_bwd(*args), ap._launch_bwd(*args)
    want = ap.avg_pool3d_bwd_plain(*args)
    x = torch.empty(shape, dtype=dtype, device="cuda").permute(0, 4, 1, 2, 3)

    def aten():
        return torch.ops.aten.avg_pool3d_backward(go.permute(0, 4, 1, 2, 3), x, list(kernel),
                                                  list(stride), [0, 0, 0], False, True, None)

    torch.cuda.synchronize()
    row = {"shape": list(shape), "kernel": list(kernel), "stride": list(stride),
           "dtype": str(dtype).replace("torch.", ""), "strided": strided,
           "bit_equal_plain": torch.equal(got, want), "relaunch_bit_equal": torch.equal(got, again),
           "max_abs_err": (got - want).abs().max().item(),
           "aten_max_abs_diff": (got - aten().permute(0, 2, 3, 4, 1)).abs().max().item()}
    if timed:
        # Each window's terms: a division and an add per input it covers.
        ops = 2 * go.numel() * math.prod(kernel)
        nbytes = (go.numel() + math.prod(shape)) * go.element_size()
        row.update(ms=device_ms(lambda: ap._launch_bwd(*args)),
                   plain_ms=device_ms(lambda: ap.avg_pool3d_bwd_plain(*args), iters=5),
                   library_ms=device_ms(aten), **roofline(ops, nbytes, dtype))
    return row


def phase_avgpool_bwd_kernel():
    """The average-pool backward kernel (csrc/avg_pool3d_bwd.cu) against its
    plain version, fp32 and float64, at every average pool of the bf16
    train forwards at 16 clips of SlowFast 4x16 R50 (the head's two
    pathways, one window each) and X3D-M (its head), at SlowFast's head on
    the 256 test crop (a 7 x 7 pool over an 8 x 8 map: 4 overlapping
    windows), at MViTv2-S 16x4's pools under MVIT.MODE avg (k // 2 padding)
    and at ``AVG_POOL_EDGE_CASES`` and a strided gradient: bit-equal, and
    bit-equal over two launches. At the CNN heads' shapes in fp32 the device
    time, the plain version's, ATen's ``avg_pool3d_backward`` and the byte
    bound, summed per SlowFast step for the kernels line."""
    t0 = time.perf_counter()
    sf = capture_pool_calls(slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), CNN_TRAIN_CLIPS,
                            avg=True)
    sf_test = capture_pool_calls(slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), 8, avg=True,
                                 crop=256)
    x3d = capture_pool_calls(
        slowfast_cfg(["NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "bfloat16"], X3D_YAML,
                     os.path.join(OUT_DIR, "x3d_m")), CNN_TRAIN_CLIPS, avg=True)
    mvit = capture_pool_calls(mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "MVIT.MODE", "avg"]),
                              TRAIN_CLIPS, avg=True)
    check(sf and sf_test and x3d and mvit, f"average pools captured: SlowFast {len(sf)}, test "
          f"crop {len(sf_test)}, X3D-M {len(x3d)}, MViT avg {len(mvit)}")
    timed_cases = list(dict.fromkeys(sf + sf_test + x3d))
    rows = {}
    for i, case in enumerate(list(dict.fromkeys(timed_cases + mvit)) + AVG_POOL_EDGE_CASES):
        for dtype in (torch.float32, torch.float64):
            timed = case in timed_cases and dtype == torch.float32
            rows[(case, dtype)] = avgpool_case(*case, dtype, 200 + i, timed)
    rows["strided"] = avgpool_case(*AVG_POOL_EDGE_CASES[1], torch.float32, 199, False,
                                   strided=True)
    cases = list(rows.values())
    bad = [r for r in cases if not (r["bit_equal_plain"] and r["relaunch_bit_equal"])]
    row = {"phase": "avgpool_bwd_kernel", "source": "slowfast_tpu_torch/csrc/avg_pool3d_bwd.cu",
           "slowfast_pools": [list(c) for c in sf],
           "slowfast_test_pools": [list(c) for c in sf_test],
           "x3d_pools": [list(c) for c in x3d], "mvit_avg_pools": [list(c) for c in mvit],
           "cases_checked": len(cases), "bit_equal": len(cases) - len(bad),
           "max_abs_err": max(r["max_abs_err"] for r in cases),
           "per_slowfast_step": per_step_sums(rows, sf, torch.float32),
           "per_slowfast_test_batch": per_step_sums(rows, sf_test, torch.float32),
           "per_x3d_step": per_step_sums(rows, x3d, torch.float32), "cases": cases,
           "seconds": time.perf_counter() - t0}
    emit(row)
    check(not bad, f"average-pool backward kernel differs from its plain version: {bad}")
    return row


def run_recording_pools(cfg, state, batch, store):
    """``train_step_run`` with every max pool's argmax of the forward kept
    in ``store`` (one int64 tensor a call, on the card)."""
    import torch.nn.functional as F

    from slowfast_tpu_torch.ops import max_pool as mp

    real = mp.max_pool3d

    def recording(x, kernel, stride=None, padding=(0, 0, 0)):
        stride = stride or kernel
        with torch.no_grad():
            store.append(F.max_pool3d(x.detach().permute(0, 4, 1, 2, 3), tuple(kernel),
                                      tuple(stride), tuple(padding), return_indices=True)[1])
        return real(x, kernel, stride, padding)

    return train_step_run(cfg, state, batch, [(mp, "max_pool3d", recording)])


def deterministic_pair(cfg, state, batch):
    """Two train steps of ``cfg`` from ``state`` on ``batch`` under
    ``torch.use_deterministic_algorithms(True)`` (no ``warn_only``): the
    losses, whether the gradients are bit-equal and their distance, the pool
    backward kernels' launches. If torch refuses an op, the op it names and
    no steps."""
    torch.use_deterministic_algorithms(True)
    try:
        runs = [train_step_run(cfg, state, batch) for _ in range(2)]
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        return {"nondeterministic_ops": [str(e).split(" does not have")[0][:120]]}
    finally:
        torch.use_deterministic_algorithms(False)
    (a, ga), (b, gb) = runs
    return {"losses": [a["loss"], b["loss"]], "same_loss": a["loss"] == b["loss"],
            "grads_bit_equal": all(torch.equal(ga[n], gb[n]) for n in ga),
            "grad_rel_l2": rel_l2(gb, ga, ga), "nondeterministic_ops": [],
            "max_pool3d_bwd_launches": a["launches"]["max_pool3d_bwd"],
            "avg_pool3d_bwd_launches": a["launches"]["avg_pool3d_bwd"]}


class PinnedArgmaxPool(torch.autograd.Function):
    """A max pool whose windows take the given argmax (ATen's indices of
    another forward) instead of their own: the forward gathers ``x`` there,
    the backward is the deterministic kernel on those indices."""

    @staticmethod
    def forward(ctx, x, idx, kernel, stride, padding):
        n, c = x.shape[0], x.shape[4]
        flat = x.permute(0, 4, 1, 2, 3).reshape(n, c, -1)
        y = torch.gather(flat, 2, idx.reshape(n, c, -1)).reshape(idx.shape)
        ctx.save_for_backward(idx)
        ctx.geometry = (tuple(x.shape), x.dtype, kernel, stride, padding)
        return y.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, grad):
        from slowfast_tpu_torch.ops import max_pool as mp

        (idx,) = ctx.saved_tensors
        shape, dtype, kernel, stride, padding = ctx.geometry
        return (mp._launch_bwd(grad, idx.permute(0, 2, 3, 4, 1), shape, dtype, kernel, stride,
                               padding), None, None, None, None)


def run_pinned_pools(cfg, state, batch, pinned):
    """``train_step_run`` with the i-th max pool of the forward taking the
    argmax ``pinned[i]``."""
    from slowfast_tpu_torch.ops import max_pool as mp

    calls = iter(pinned)

    def pinned_pool(x, kernel, stride=None, padding=(0, 0, 0)):
        return PinnedArgmaxPool.apply(x, next(calls), tuple(kernel), tuple(stride or kernel),
                                      tuple(padding))

    return train_step_run(cfg, state, batch, [(mp, "max_pool3d", pinned_pool)])


def pool_bwd_step_ab(cfg, state, batch, steps=3):
    """The train step of ``cfg`` from ``state`` on ``batch`` with the max-pool
    backward kernel and with ATen's own backward (``_aten_pool_swap``), in
    turns kernel, ATen, ATen, kernel: each run's p50 of ``steps`` timed
    steps (host clock to a synchronize), what the kernel costs a step
    (recorded, not held)."""
    out = {"kernel": [], "aten": []}
    for name in ("kernel", "aten", "aten", "kernel"):
        run, _ = train_step_run(cfg, state, batch, _aten_pool_swap() if name == "aten" else (),
                                timed_steps=steps)
        out[name].append(run["step_p50_ms"])
    return out


def phase_determinism():
    """Under ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
    set before CUDA started, by ``main``): two bf16 MViTv2-S 16x4 train
    steps at 16 clips from one state, and two bf16 SlowFast 4x16 R50 steps
    at 16 clips: no op refused, the same loss and bit-equal gradients, the
    max-pool backward kernel launched in both and the average-pool one in
    SlowFast's (its head). Then the flash-core and exact-core
    MViTv2-S steps from one state (their forwards differ by one ulp in a
    few attention outputs): per max pool the outputs whose argmax differs
    between the two forwards, beside the steps' gradient distance, and the
    distance once the exact step's pools take the flash forward's argmax
    (recorded, not held). Each pair's step p50 with the kernel and with
    ATen's backward (``pool_bwd_step_ab``, out of deterministic mode)."""
    from slowfast_tpu_torch.models.build import build_model

    out = {"phase": "determinism"}
    for name, cfg, n in (
            ("mvit", mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), TRAIN_CLIPS),
            ("slowfast", slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]), CNN_TRAIN_CLIPS)):
        state = {k: v.cpu() for k, v in build_model(cfg, device="cuda").state_dict().items()}
        batch = uint8_train_batch(cfg, n, 21)
        batch["epoch_exact"] = 15.0 if name == "mvit" else 0.5  # mid-warmup: a nonzero LR
        out[name] = deterministic_pair(cfg, state, batch)
        out[name]["step_p50_ms"] = pool_bwd_step_ab(cfg, state, batch)
        if name == "mvit":
            flips = {}
            cfg_exact = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.PALLAS_ATTENTION",
                                  "True"])
            torch.use_deterministic_algorithms(True)
            try:
                for core, c in (("flash", cfg), ("exact", cfg_exact)):
                    flips[core] = []
                    _, flips[core + "_grads"] = run_recording_pools(c, state, batch, flips[core])
                # The exact step with its pools on the flash forward's argmax.
                _, pinned = run_pinned_pools(cfg_exact, state, batch, flips["flash"])
            finally:
                torch.use_deterministic_algorithms(False)
            ref = flips["flash_grads"]
            out["flash_vs_exact"] = {
                "pools": len(flips["flash"]),
                "outputs": [i.numel() for i in flips["flash"]],
                "argmax_flips": [int((a != b).sum()) for a, b in zip(flips["flash"],
                                                                     flips["exact"])],
                "grad_rel_l2": rel_l2(flips["exact_grads"], ref, ref),
                "grad_rel_l2_exact_on_flash_argmax": rel_l2(pinned, ref, ref),
                "grad_rel_l2_exact_on_flash_argmax_vs_exact": rel_l2(
                    pinned, flips["exact_grads"], flips["exact_grads"])}
            del flips, pinned
    emit(out)
    for name in ("mvit", "slowfast"):
        pair = out[name]
        check(not pair["nondeterministic_ops"],
              f"{name} names nondeterministic ops: {pair['nondeterministic_ops']}")
        check(pair["same_loss"] and pair["grads_bit_equal"],
              f"{name}: deterministic steps differ: {pair}")
        check(pair["max_pool3d_bwd_launches"] > 0, f"{name}: no max-pool backward launch")
    check(out["slowfast"]["avg_pool3d_bwd_launches"] > 0,
          "slowfast: no average-pool backward launch")
    return out


def prefetch_loop(cfg, prefetcher, model, optimizer):
    """One epoch (4 steps) of ``trainer.train_epoch`` on the decoded-video
    train loader staged by ``prefetcher`` (the batches with their labels),
    under the profiler: steps/s on the host clock and the device's idle
    share from the epoch's first kernel to its last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.engine import trainer
    from slowfast_tpu_torch.engine.steps import make_train_step
    from slowfast_tpu_torch.profile_eval import merged_busy_us
    from slowfast_tpu_torch.utils.meters import TrainMeter

    loader = construct_loader(cfg, "train", "cuda", prefetcher=prefetcher)
    loader.set_epoch(0)
    step = make_train_step(cfg, model, optimizer, torch.Generator().manual_seed(cfg.RNG_SEED))
    torch.cuda.synchronize()
    # The card's activity only: the host's op events would take the
    # profiler longer to gather than the epoch takes.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(loader, step, TrainMeter(len(loader), cfg), 0, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    window = max(e for _, e in kernels) - min(s for s, _ in kernels)
    return {"steps": len(loader), "wall_s": wall, "steps_per_s": len(loader) / wall,
            "idle_share": 1.0 - merged_busy_us(kernels) / window}


def prefetch_phase_rows(cfg):
    """The prefetcher on ``cfg``'s decoded-video train loader: its first two
    staged batches bit-equal to synchronous copies of the same host
    batches; then the train loop's steps/s and idle share with the
    side-stream prefetcher and with ``staged_inline`` (the synchronous
    staging, passed as the loader's ``prefetcher``), in
    turns from one state: records, not claims."""
    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.parallel.prefetch import DevicePrefetcher, staged_inline
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    cfg = cfg.clone()
    cfg.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, "prefetch")  # its own json_stats.log
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    loader = construct_loader(cfg, "train", "cuda")
    loader.set_epoch(0)
    staged, host = iter(loader), loader._host_batches()
    equal = []
    try:
        for _ in range(2):
            inputs, host_inputs = next(staged)[0], next(host)[0]
            equal.append(all(torch.equal(s, torch.from_numpy(x).cuda())
                             for s, x in zip(inputs, host_inputs)))
    finally:
        staged.close()
        host.close()
    check(equal == [True, True], f"staged batches differ from synchronous copies: {equal}")
    model = build_model(cfg, device="cuda")
    optimizer = construct_optimizer(model, cfg)
    start = ({k: v.clone() for k, v in model.state_dict().items()}, optimizer.state_dict())
    runs = {"prefetcher": [], "inline": []}
    for name in ("prefetcher", "inline", "inline", "prefetcher"):
        model.load_state_dict(start[0])
        optimizer.load_state_dict(start[1])
        runs[name].append(prefetch_loop(cfg, DevicePrefetcher if name == "prefetcher"
                                        else staged_inline, model, optimizer))
    return {"staged_equal_sync": equal, "depth": max(cfg.TPU.PREFETCH, 1),
            "prefetch_cfg": cfg.TPU.PREFETCH, **runs}


def phase_tools():
    """``profile_step`` on two bf16 MViTv2-S 16x4 train steps at 16 clips:
    its top five ops, kernel time a step and idle share (the trace is
    written to a temporary directory and removed: its size is recorded). ``log_model_info`` on the flagship
    SlowFast 4x16 R50 on the card: its parameter count equals the CPU
    model's; the GFLOPs per clip are recorded."""
    import tempfile

    from slowfast_tpu_torch import profile_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.utils import misc

    with tempfile.TemporaryDirectory(prefix="profile_step_") as out:
        t0 = time.perf_counter()
        prof = profile_step.profile_step(mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"]),
                                         TRAIN_CLIPS, 2, out, 5)
        prof_s = time.perf_counter() - t0
        trace_bytes = os.path.getsize(os.path.join(out, "trace.json"))
    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
    t0 = time.perf_counter()
    params, gflops = misc.log_model_info(build_model(cfg, device="cuda"), cfg)
    info_s = time.perf_counter() - t0
    cpu_params = misc.params_count(build_model(cfg, device="cpu"))
    row = {"phase": "tools", "profile_step": {"top5": prof["rows"], "s": prof_s,
                                              "by_category": prof["by_category"],
                                              "step_timer": prof["step_timer"],
                                              "kernel_ms_per_step": prof["kernel_ms_per_step"],
                                              "idle_share": prof["idle_share"],
                                              "trace_bytes": trace_bytes},
           "log_model_info": {"model": "SLOWFAST_4x16_R50", "params": params,
                              "cpu_params": cpu_params, "gflops_per_clip": gflops,
                              "s": info_s}}
    emit(row)
    check(len(prof["rows"]) == 5 and prof["rows"][0]["ms_per_step"] > 0
          and prof["kernel_ms_per_step"] > 0, f"profile_step rows {prof['rows']}, kernels "
          f"{prof['kernel_ms_per_step']} ms a step")
    check(params == cpu_params and gflops and gflops > 0,
          f"log_model_info: {params} params on the card, {cpu_params} on the CPU, {gflops}")
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS is deterministic only with this workspace setting, read when CUDA
    # starts (phase determinism). The runs below skip LOG_MODEL_INFO's FLOP
    # count, a few seconds of host time each; phase tools runs it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from slowfast_tpu_torch.config import defaults

    defaults._C.LOG_MODEL_INFO = False
    info = phase_device()
    phase_host_libs()
    phase_build()
    kernel = phase_kernel()
    maxpool = phase_maxpool_bwd_kernel()
    avgpool = phase_avgpool_bwd_kernel()
    phase_fp32()
    phase_slice()
    phase_breakdown()
    attn = phase_attn_kernel()
    phase_mvit_fp32()
    mvit_launches = phase_mvit_slice()
    attn_bwd = phase_attn_bwd_kernel()
    fused = phase_attn_fused_kernel()
    train_runs = phase_mvit_train_fused()
    determinism = phase_determinism()
    phase_mvit_train_fp32()
    train_launches = phase_mvit_train_slice(attn_bwd, attn)
    phase_sf_train_fp32()
    sf_train = phase_sf_train_slice()
    data_launches = phase_data_slice(sf_train)
    cnn = phase_cnn_family()
    roi = phase_roi_align_kernel()
    phase_det_fp32()
    det = phase_det_train_slice()
    family = {"mvitv1": phase_mvitv1_train_slice()}
    phase_mvitv1_fp32()
    family["vit"] = phase_vit_train_slice()
    family["mvit_l"] = phase_mvit_l_fit()
    family["mvit_det"] = phase_mvit_det()
    with masked_corpus() as (corpus, corpus_s):
        emit({"phase": "masked_corpus", "videos": MASKED_VIDEOS, "frames": 100,
              "size": [340, 256], "write_s": corpus_s})
        # MaskFeat's checkpoint, kept outside the run files for the fine-tune.
        pt_ckpt = os.path.join(corpus, "maskfeat_pt.pyth")
        family["maskfeat"] = phase_maskfeat_train_slice(corpus, keep=pt_ckpt)
        family["mae"] = phase_mae_train_slice(corpus)
        family["finetune"] = phase_finetune_slice(corpus, pt_ckpt)
        # MoCo's checkpoint, kept outside the run files for the linear probe.
        ssl_ckpt = os.path.join(corpus, "moco_pt.pyth")
        family["ssl"] = phase_ssl_train_slice(corpus, keep=ssl_ckpt)
        family["linear"] = phase_linear_probe_slice(corpus, ssl_ckpt)
        phase_ssl_family(corpus)
        phase_ssl_ddp(corpus)
        family["ptv"] = phase_ptv_recipes(corpus)
        family["vis_tools"] = phase_vis_tools()
        family["mae_vis"] = phase_mae_vis(corpus)
        family["demo"] = phase_demo_slice(corpus)
        phase_data_bench(corpus)
    phase_ssl_fp32()
    phase_masked_fp32()
    family["rev_mvit"] = phase_rev_mvit_train_slice()
    phase_rev_mvit_memory()
    phase_rev_mvit_fp32()
    family["multigrid"] = phase_multigrid_slice()
    with imagenet_corpus() as (corpus, corpus_s):
        emit({"phase": "imagenet_corpus", "images": IN1K_CORPUS, "size": [500, 375],
              "write_s": corpus_s})
        family["imagenet"] = phase_imagenet_train_slice(corpus)
        family["in1k_maskfeat"] = phase_in1k_maskfeat(corpus)
    phase_imagenet_fp32()
    ddp = phase_ddp_slice()
    phase_tools()
    # The preprocess kernel's launches are those of the SlowFast train run
    # on synthetic video (4 steps, 4 precise-BN batches, 4 val batches), of
    # the one on decoded video (the same, with 2 val batches, and the test's
    # 8 batches), of the two masked pretraining runs (4 steps each), of the
    # fine-tune (4 steps and its val batch), of the linear probe (4 steps and
    # its val batch; the SSL pretrains ship float pathways), of Rev-MViT's
    # run (4 steps, 4 val and 2 test batches) and of the multigrid run (its
    # steps, its precise-BN batches and its val batches; ImageNet's items
    # are float images, as in JAX), of the data-parallel runs (the
    # launcher's two runs: 4 steps, 4 precise-BN and 4 val batches each),
    # and of the pytorchvideo SlowFast run (4 steps, 4 precise-BN batches,
    # its val batch; its float run launches none) and the PTVMViT forward,
    # and of the visualize tool (the test's and its own batches, the first
    # batch again for the activations and Grad-CAM) and MAE's renders.
    lines = [{
        "name": "preprocess_u8", "route": "cuda",
        "source": "slowfast_tpu_torch/csrc/preprocess.cu",
        "replaces": "slowfast_tpu/ops/preprocess.py:42",
        "launches": sf_train["launches"]["preprocess_u8"]
        + (data_launches["preprocess_u8"] if data_launches else 0)
        + sum(family[k]["launches"]["preprocess_u8"]
              for k in ("maskfeat", "mae", "finetune", "linear", "ptv", "rev_mvit",
                        "multigrid", "vis_tools", "mae_vis"))
        + ddp["launches"]["preprocess_u8"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None,
    }]
    # Attention: per MViTv2-S forward at B=8 in bf16 (both on the tensor
    # cores), summed over its 16 blocks. The constant-shift core's launches
    # are the MViTv2-S test's and the new MViT family paths' (MViTv1-B,
    # ViT-B, MViTv2-L, MViT detection); the exact core runs on the model
    # path only under TPU.PALLAS_ATTENTION, so its launches are those of
    # phase mvit_train_fused's bf16 exact step. The masked pretraining runs
    # (MaskFeat, MAE), the fine-tune, Rev-MViT's run (29 forwards and 16
    # backwards a train step), the ImageNet runs (MViTv2-S on the 2D stem,
    # 2D MaskFeat) and the tools (the visualize tool's test and eval
    # batches, activations and Grad-CAM, whose backward runs row 7; MAE's
    # renders) count in the family's.
    family_fwd = sum(f["launches"]["attention_flash"] for f in family.values())
    family_bwd = sum(f["launches"]["attention_flash_bwd"] for f in family.values())
    for core, source, replaces, n in (
            ("flash", "pooled_attention_flash.cu", ":375",
             mvit_launches["attention_flash"] + family_fwd),
            ("exact", "pooled_attention_exact.cu", ":39",
             train_runs["exact"]["attention_exact"])):
        tot = attn["per_forward"][core]
        lines.append({
            "name": f"attention_{core}", "route": "cuda",
            "source": f"slowfast_tpu_torch/csrc/{source}",
            "replaces": f"slowfast_tpu/ops/pallas_attention.py{replaces}", "launches": n,
            "max_abs_err": attn["max_abs_err"][core],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": attn["bound_by"], "library_ms": tot["library_ms"],
        })
    # Attention backwards: per MViTv2-S train step at 16 clips in bf16 (on
    # the tensor cores), summed over its 16 blocks. The constant-shift
    # backward's launches are the MViTv2-S train slice's and the new MViT
    # family paths'; the exact one's those of phase mvit_train_fused's bf16
    # exact step.
    for core, source, replaces, n in (
            ("flash", "pooled_attention_flash_bwd.cu", ":392",
             train_launches["attention_flash_bwd"] + family_bwd),
            ("exact", "pooled_attention_exact_bwd.cu", ":58",
             train_runs["exact"]["attention_exact_bwd"])):
        tot = attn_bwd["per_backward"][core]
        lines.append({
            "name": f"attention_{core}_bwd", "route": "cuda",
            "source": f"slowfast_tpu_torch/csrc/{source}",
            "replaces": f"slowfast_tpu/ops/pallas_attention.py{replaces}", "launches": n,
            "max_abs_err": attn_bwd["max_abs_err"][core],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": attn_bwd["bound_by"], "library_ms": tot["library_ms"],
        })
    # The saved-e pair: per MViTv2-S train step at 16 clips in bf16, summed
    # over its 16 blocks. No config key routes MViT to it; its launches are
    # those of phase mvit_train_fused's step with the core swapped in.
    for name, source, replaces, part in (
            ("attention_fused", "pooled_attention_flash.cu", ":237", "fwd"),
            ("attention_fused_bwd", "pooled_attention_flash_bwd.cu", ":255", "bwd")):
        tot = fused["per_step"][part]
        lines.append({
            "name": name, "route": "cuda", "source": f"slowfast_tpu_torch/csrc/{source}",
            "replaces": f"slowfast_tpu/ops/pallas_attention.py{replaces}",
            "launches": train_runs["fused"][name],
            "max_abs_err": fused["max_abs_err"]["out" if part == "fwd" else "grads"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": fused["bound_by"][part],
            "library_ms": tot["library_ms"],
        })
    # ROIAlign (a hand kernel beyond the TPU's: the JAX package's is plain
    # XLA): per SLOWFAST_32x2_R50_SHORT train forward at 16 clips in bf16,
    # summed over its two pathways; launches are det_train_slice's, two a
    # forward batch and two a train step's backward, mvit_det's one and
    # one, and the AVA demos' two a clip with boxes.
    for name, part in (("roi_align", "fwd"), ("roi_align_bwd", "bwd")):
        tot = roi["per_forward"][part]
        lines.append({
            "name": name, "route": "cuda", "source": "slowfast_tpu_torch/csrc/roi_align.cu",
            "replaces": "slowfast_tpu/ops/roi_align.py:106",
            "launches": det["launches"][name] + family["mvit_det"]["launches"][name]
            + family["demo"]["launches"][name],
            "max_abs_err": roi["max_abs_err"][part], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": None,
        })
    # The max-pool backward (a hand kernel beyond the TPU's: the JAX
    # package's argmax VJP is plain XLA): per SLOWFAST_4x16_R50 train step at
    # 16 clips in bf16, summed over its pools; launches are every train
    # path's backward passes (SlowFast, the CNN family, MViT, detection,
    # the masked, SSL, Rev-MViT, multigrid, ImageNet and data-parallel runs).
    pool_paths = {"sf_train_slice": sf_train["launches"], "data_slice": data_launches or {},
                  "mvit_train_slice": train_launches, "det_train_slice": det["launches"],
                  "ddp_slice": ddp["launches"],
                  **{f"cnn_family.{name}.{label}": run["launches"]
                     for name, row in cnn.items() for label, run in row["train"].items()},
                  **{f"family.{k}": f["launches"] for k, f in family.items()}}
    pool_launches = {k: v.get("max_pool3d_bwd", 0) for k, v in pool_paths.items()}
    emit({"phase": "maxpool_launches", "by_path": pool_launches,
          "determinism": {k: determinism[k]["max_pool3d_bwd_launches"]
                          for k in ("mvit", "slowfast")}})
    for path in ("sf_train_slice", "mvit_train_slice", "cnn_family.i3d_nln.default"):
        check(pool_launches[path] > 0, f"{path}: the max-pool backward kernel never launched")
    tot = maxpool["per_slowfast_step"]
    lines.append({
        "name": "max_pool3d_bwd", "route": "cuda",
        "source": "slowfast_tpu_torch/csrc/max_pool3d_bwd.cu",
        "replaces": "slowfast_tpu/ops/video_conv.py:464",
        "launches": sum(pool_launches.values()), "max_abs_err": maxpool["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
    })
    # The average-pool backward (a hand kernel beyond the TPU's: JAX's
    # avg_pool VJP is plain XLA): per SLOWFAST_4x16_R50 train step at 16
    # clips, the head's two fp32 pools summed; launches are the train paths'
    # with a pooling head (the RoI head, the SSL models and multigrid's short
    # cycle pool by mean).
    avg_launches = {k: v.get("avg_pool3d_bwd", 0) for k, v in pool_paths.items()}
    emit({"phase": "avgpool_launches", "by_path": avg_launches,
          "determinism": {k: determinism[k]["avg_pool3d_bwd_launches"]
                          for k in ("mvit", "slowfast")}})
    for path in ("sf_train_slice", "cnn_family.x3d_m.channels_last_3d", "ddp_slice"):
        check(avg_launches[path] > 0, f"{path}: the average-pool backward kernel never launched")
    tot = avgpool["per_slowfast_step"]
    lines.append({
        "name": "avg_pool3d_bwd", "route": "cuda",
        "source": "slowfast_tpu_torch/csrc/avg_pool3d_bwd.cu",
        "replaces": "slowfast_tpu/models/common.py:153",
        "launches": sum(avg_launches.values()), "max_abs_err": avgpool["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
    })
    emit({"kernels": lines})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
