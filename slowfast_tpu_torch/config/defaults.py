"""Default configuration tree, a copy of slowfast_tpu/config/defaults.py.

The port keeps its own copy so that it imports nothing of the JAX package;
the key tree is the same, so every shipped YAML and ``--opts KEY VALUE``
override parses unchanged. Of the ``TPU`` keys, the port reads
``COMPUTE_DTYPE`` (bf16 or fp32 compute) and ``UINT8_PIPELINE`` (the loader
ships uint8 clips); the others are accepted and unused.
"""

import math

from .cfg_node import CfgNode
from . import custom_config

_C = CfgNode()

# ---------------------------------------------------------------------------
# Contrastive SSL options (reference defaults.py:21-90)
# ---------------------------------------------------------------------------
_C.CONTRASTIVE = CfgNode(
    dict(
        T=0.07,
        DIM=128,
        LENGTH=239975,
        QUEUE_LEN=65536,
        MOMENTUM=0.5,
        MOMENTUM_ANNEALING=False,
        TYPE="mem",
        INTERP_MEMORY=False,
        MEM_TYPE="1d",
        # TPU addition: time slots of the 2d memory bank (the reference
        # hardcodes duration=1 at contrastive.py:67 and only reaches >1
        # via Memory.resize; here it is a config knob).
        DURATION=1,
        NUM_CLASSES_DOWNSTREAM=400,
        NUM_MLP_LAYERS=1,
        MLP_DIM=2048,
        BN_MLP=False,
        BN_SYNC_MLP=False,
        # Shuffle-BN: active for MoCo when BN.NORM_TYPE=sub_batchnorm
        # (per-split local stats — engine/ssl_steps.py encode_keys); a
        # no-op under plain/sync BN where GSPMD global-batch stats remove
        # the leakage it works around (models/batchnorm.py). The
        # local-vs-global shuffle distinction has no analogue in a
        # single-program SPMD step; the key is accepted for compatibility.
        LOCAL_SHUFFLE_BN=True,
        MOCO_MULTI_VIEW_QUEUE=False,
        DELTA_CLIPS_MIN=-math.inf,
        DELTA_CLIPS_MAX=math.inf,
        PREDICTOR_DEPTHS=[],
        # Sequential per-clip forward/backward is a CUDA memory
        # workaround (reference contrastive.py:1058-1100); the joint
        # jitted step computes the same total gradient — use
        # MODEL.ACT_CHECKPOINT for the memory relief instead.
        SEQUENTIAL=False,
        # SimCLR negatives always span the GLOBAL batch inside the
        # sharded jit (engine/ssl_steps.py NT-Xent over 2B rows) — the
        # True semantics; False (local-only negatives) is a DDP
        # process-boundary notion with no SPMD equivalent.
        SIMCLR_DIST_ON=True,
        SWAV_QEUE_LEN=0,
        KNN_ON=True,
    )
)

# ---------------------------------------------------------------------------
# Batch norm options (reference defaults.py:96-126)
# ---------------------------------------------------------------------------
_C.BN = CfgNode(
    dict(
        USE_PRECISE_STATS=False,
        NUM_BATCHES_PRECISE=200,
        WEIGHT_DECAY=0.0,
        NORM_TYPE="batchnorm",
        NUM_SPLITS=1,
        NUM_SYNC_DEVICES=1,
        GLOBAL_SYNC=False,
    )
)

# ---------------------------------------------------------------------------
# Training options (reference defaults.py:131-174)
# ---------------------------------------------------------------------------
_C.TRAIN = CfgNode(
    dict(
        ENABLE=True,
        KILL_LOSS_EXPLOSION_FACTOR=0.0,
        DATASET="kinetics",
        BATCH_SIZE=64,
        EVAL_PERIOD=10,
        CHECKPOINT_PERIOD=10,
        AUTO_RESUME=True,
        CHECKPOINT_FILE_PATH="",
        CHECKPOINT_TYPE="pytorch",
        CHECKPOINT_INFLATE=False,
        CHECKPOINT_EPOCH_RESET=False,
        CHECKPOINT_CLEAR_NAME_PATTERN=(),
        # AMP maps to TPU.COMPUTE_DTYPE=bfloat16 (fp32 params, bf16
        # compute, no loss scaler needed on TPU).
        MIXED_PRECISION=False,
        CHECKPOINT_IN_INIT=False,
    )
)

# ---------------------------------------------------------------------------
# Augmentation options (reference defaults.py:179-226)
# ---------------------------------------------------------------------------
_C.AUG = CfgNode(
    dict(
        ENABLE=False,
        NUM_SAMPLE=1,
        COLOR_JITTER=0.4,
        AA_TYPE="rand-m9-mstd0.5-inc1",
        INTERPOLATION="bicubic",
        RE_PROB=0.25,
        RE_MODE="pixel",
        RE_COUNT=1,
        RE_SPLIT=False,  # dead in the reference too (never read)
        GEN_MASK_LOADER=False,
        MASK_TUBE=False,
        MASK_FRAMES=False,
        MASK_WINDOW_SIZE=[8, 7, 7],
        MASK_RATIO=0.0,
        MAX_MASK_PATCHES_PER_BLOCK=None,
    )
)

_C.VIS_MASK = CfgNode(dict(ENABLE=False))

# ---------------------------------------------------------------------------
# MixUp / CutMix options (reference defaults.py:239-257)
# ---------------------------------------------------------------------------
_C.MIXUP = CfgNode(
    dict(
        ENABLE=False,
        ALPHA=0.8,
        CUTMIX_ALPHA=1.0,
        PROB=1.0,
        SWITCH_PROB=0.5,
        LABEL_SMOOTH_VALUE=0.1,
    )
)

# ---------------------------------------------------------------------------
# Testing options (reference defaults.py:262-289)
# ---------------------------------------------------------------------------
_C.TEST = CfgNode(
    dict(
        ENABLE=True,
        DATASET="kinetics",
        BATCH_SIZE=8,
        CHECKPOINT_FILE_PATH="",
        NUM_ENSEMBLE_VIEWS=10,
        NUM_SPATIAL_CROPS=3,
        CHECKPOINT_TYPE="pytorch",
        SAVE_RESULTS_PATH="",
        NUM_TEMPORAL_CLIPS=[],
    )
)

# ---------------------------------------------------------------------------
# ResNet options (reference defaults.py:293-327)
# ---------------------------------------------------------------------------
_C.RESNET = CfgNode(
    dict(
        TRANS_FUNC="bottleneck_transform",
        NUM_GROUPS=1,
        WIDTH_PER_GROUP=64,
        INPLACE_RELU=True,  # memory note for torch; meaningless under XLA
        STRIDE_1X1=False,
        ZERO_INIT_FINAL_BN=False,
        ZERO_INIT_FINAL_CONV=False,
        DEPTH=50,
        NUM_BLOCK_TEMP_KERNEL=[[3], [4], [6], [3]],
        SPATIAL_STRIDES=[[1], [2], [2], [2]],
        SPATIAL_DILATIONS=[[1], [1], [1], [1]],
    )
)

# ---------------------------------------------------------------------------
# X3D options (reference defaults.py:333-360)
# ---------------------------------------------------------------------------
_C.X3D = CfgNode(
    dict(
        WIDTH_FACTOR=1.0,
        DEPTH_FACTOR=1.0,
        BOTTLENECK_FACTOR=1.0,
        DIM_C5=2048,
        DIM_C1=12,
        SCALE_RES2=False,
        BN_LIN5=False,
        CHANNELWISE_3x3x3=True,
    )
)

# ---------------------------------------------------------------------------
# Non-local options (reference defaults.py:363-387)
# ---------------------------------------------------------------------------
_C.NONLOCAL = CfgNode(
    dict(
        LOCATION=[[[]], [[]], [[]], [[]]],
        GROUP=[[1], [1], [1], [1]],
        INSTANTIATION="dot_product",
        POOL=[
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
        ],
    )
)

# ---------------------------------------------------------------------------
# Model options (reference defaults.py:390-438)
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode(
    dict(
        ARCH="slowfast",
        MODEL_NAME="SlowFast",
        NUM_CLASSES=400,
        LOSS_FUNC="cross_entropy",
        SINGLE_PATHWAY_ARCH=["2d", "c2d", "i3d", "slow", "x3d", "mvit", "csn", "r2plus1d"],
        MULTI_PATHWAY_ARCH=["slowfast"],
        DROPOUT_RATE=0.5,
        DROPCONNECT_RATE=0.0,
        FC_INIT_STD=0.01,
        HEAD_ACT="softmax",
        ACT_CHECKPOINT=False,
        DETACH_FINAL_FC=False,
        FROZEN_BN=False,
        # Gradient-compression hook (DDP comm); XLA collectives run in
        # the compute dtype already.
        FP16_ALLREDUCE=False,
    )
)

# ---------------------------------------------------------------------------
# MViT options (reference defaults.py:447-558, 611-628 for REV)
# ---------------------------------------------------------------------------
_C.MVIT = CfgNode(
    dict(
        MODE="conv",
        POOL_FIRST=False,
        CLS_EMBED_ON=True,
        PATCH_KERNEL=[3, 7, 7],
        PATCH_STRIDE=[2, 4, 4],
        PATCH_PADDING=[2, 4, 4],
        EMBED_DIM=96,
        NUM_HEADS=1,
        MLP_RATIO=4.0,
        QKV_BIAS=True,
        DROPPATH_RATE=0.1,
        LAYER_SCALE_INIT_VALUE=0.0,
        DEPTH=16,
        NORM="layernorm",
        DIM_MUL=[],
        HEAD_MUL=[],
        POOL_KV_STRIDE=[],
        POOL_KV_STRIDE_ADAPTIVE=None,
        POOL_Q_STRIDE=[],
        POOL_KVQ_KERNEL=None,
        ZERO_DECAY_POS_CLS=True,
        NORM_STEM=False,
        SEP_POS_EMBED=False,
        DROPOUT_RATE=0.0,
        USE_ABS_POS=True,
        REL_POS_SPATIAL=False,
        REL_POS_TEMPORAL=False,
        REL_POS_ZERO_INIT=False,
        RESIDUAL_POOLING=False,
        DIM_MUL_IN_ATT=False,
        SEPARATE_QKV=False,
        HEAD_INIT_SCALE=1.0,
        USE_MEAN_POOLING=False,
        USE_FIXED_SINCOS_POS=False,
        PATCH_2D=False,
        REV=CfgNode(
            dict(
                ENABLE=False,
                RESPATH_FUSE="concat",
                BUFFER_LAYERS=[],
                RES_PATH="conv",
                PRE_Q_FUSION="avg",
            )
        ),
    )
)

# ---------------------------------------------------------------------------
# Masked pretraining (MaskFeat / MAE) options (reference defaults.py:563-609)
# ---------------------------------------------------------------------------
_C.MASK = CfgNode(
    dict(
        ENABLE=False,
        MAE_ON=False,
        MAE_RND_MASK=False,
        PER_FRAME_MASKING=False,
        TIME_STRIDE_LOSS=True,
        NORM_PRED_PIXEL=True,
        SCALE_INIT_BY_DEPTH=False,
        DECODER_EMBED_DIM=512,
        DECODER_SEP_POS_EMBED=False,
        DEC_KV_KERNEL=[],
        DEC_KV_STRIDE=[],
        PRETRAIN_DEPTH=[15],
        HEAD_TYPE="separate",
        DECODER_DEPTH=0,
        PRED_HOG=False,
    )
)

# ---------------------------------------------------------------------------
# SlowFast options (reference defaults.py:633-648)
# ---------------------------------------------------------------------------
_C.SLOWFAST = CfgNode(
    dict(
        BETA_INV=8,
        ALPHA=8,
        FUSION_CONV_CHANNEL_RATIO=2,
        FUSION_KERNEL_SZ=5,
    )
)

# ---------------------------------------------------------------------------
# Data options (reference defaults.py:654-804)
# ---------------------------------------------------------------------------
_C.DATA = CfgNode(
    dict(
        PATH_TO_DATA_DIR="",
        PATH_LABEL_SEPARATOR=" ",
        PATH_PREFIX="",
        NUM_FRAMES=8,
        SAMPLING_RATE=8,
        TRAIN_PCA_EIGVAL=[0.225, 0.224, 0.229],
        TRAIN_PCA_EIGVEC=[
            [-0.5675, 0.7192, 0.4009],
            [-0.5808, -0.0045, -0.8140],
            [-0.5836, -0.6948, 0.4203],
        ],
        PATH_TO_PRELOAD_IMDB="",
        MEAN=[0.45, 0.45, 0.45],
        STD=[0.225, 0.225, 0.225],
        INPUT_CHANNEL_NUM=[3, 3],
        TRAIN_JITTER_SCALES=[256, 320],
        TRAIN_JITTER_SCALES_RELATIVE=[],
        TRAIN_JITTER_ASPECT_RELATIVE=[],
        USE_OFFSET_SAMPLING=False,
        TRAIN_JITTER_MOTION_SHIFT=False,
        TRAIN_CROP_SIZE=224,
        TEST_CROP_SIZE=256,
        TARGET_FPS=30,
        TRAIN_JITTER_FPS=0.0,
        # "native" (first-party FFmpeg service; the reference names "pyav"
        # and "torchvision" alias it) or "cv2" to force the fallback
        # decoder (debug / A-B). Reference default: "pyav".
        DECODING_BACKEND="native",
        DECODING_SHORT_SIZE=256,
        # TPU addition: fuse the train-time short-side scale jitter into
        # the native decoder's sws_scale (one image pass on the host).
        DECODE_AT_SCALE=True,
        # TPU addition: additionally fuse the random CROP into that same
        # sws_scale (decoder emits (T, crop, crop) directly; host aug
        # reduces to the horizontal flip). Uint8-pipeline train path only;
        # crop-then-resize equals resize-then-crop up to bilinear subpixel
        # phase, so the augmentation distribution is unchanged.
        FUSED_DECODE_CROP=True,
        INV_UNIFORM_SAMPLE=False,
        RANDOM_FLIP=True,
        MULTI_LABEL=False,
        ENSEMBLE_METHOD="sum",
        REVERSE_INPUT_CHANNEL=False,
        TRAIN_CROP_NUM_TEMPORAL=1,
        TRAIN_CROP_NUM_SPATIAL=1,
        COLOR_RND_GRAYSCALE=0.0,
        LOADER_CHUNK_SIZE=0,
        LOADER_CHUNK_OVERALL_SIZE=0,
        SKIP_ROWS=0,
        TIME_DIFF_PROB=0.0,
        SSL_COLOR_JITTER=False,
        SSL_COLOR_BRI_CON_SAT=[0.4, 0.4, 0.4],
        SSL_COLOR_HUE=0.1,
        SSL_MOCOV2_AUG=False,
        SSL_BLUR_SIGMA_MIN=[0.0, 0.1],
        SSL_BLUR_SIGMA_MAX=[0.0, 2.0],
        IN_VAL_CROP_RATIO=0.875,
        DUMMY_LOAD=False,
        # Size of the synthetic dataset (0 = default sizing) — TPU-native
        # extension for input-free integration tests and benchmarks.
        SYNTHETIC_SIZE=0,
        IN22K_TRAINVAL=False,  # dead in the reference too (never read)
    )
)

# ---------------------------------------------------------------------------
# Solver options (reference defaults.py:809-881)
# ---------------------------------------------------------------------------
_C.SOLVER = CfgNode(
    dict(
        BASE_LR=0.1,
        LR_POLICY="cosine",
        COSINE_END_LR=0.0,
        GAMMA=0.1,
        STEP_SIZE=1,  # dead in the reference too (never read)
        STEPS=[],
        LRS=[],
        MAX_EPOCH=300,
        MOMENTUM=0.9,
        DAMPENING=0.0,
        NESTEROV=True,
        WEIGHT_DECAY=1e-4,
        WARMUP_FACTOR=0.1,  # dead in the reference too (never read)
        WARMUP_EPOCHS=0.0,
        WARMUP_START_LR=0.01,
        OPTIMIZING_METHOD="sgd",
        BASE_LR_SCALE_NUM_SHARDS=False,
        COSINE_AFTER_WARMUP=False,
        ZERO_WD_1D_PARAM=False,
        CLIP_GRAD_VAL=None,
        CLIP_GRAD_L2NORM=None,
        LARS_ON=False,
        LAYER_DECAY=1.0,
        BETAS=(0.9, 0.999),
    )
)

# ---------------------------------------------------------------------------
# Globals (reference defaults.py:884-912)
# ---------------------------------------------------------------------------
_C.TASK = ""
_C.NUM_GPUS = 1  # interpreted as "number of accelerator chips" on TPU
_C.NUM_SHARDS = 1
_C.SHARD_ID = 0
_C.OUTPUT_DIR = "."
_C.RNG_SEED = 1
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = True
_C.DIST_BACKEND = "nccl"  # the process group's backend on the cards (gloo on the CPU)
# Where the ranks of a multi-process job meet (torch.distributed init method;
# run_net's --init_method sets it).
_C.INIT_METHOD = "tcp://localhost:9999"

# ---------------------------------------------------------------------------
# Benchmark options (reference defaults.py:917-926)
# ---------------------------------------------------------------------------
_C.BENCHMARK = CfgNode(dict(NUM_EPOCHS=5, LOG_PERIOD=100, SHUFFLE=True))

# Compat node: some shipped SSv2 configs set PREFETCH.NUM_LOADERS even though
# the reference defaults never define it; accept it as an inert knob.
_C.PREFETCH = CfgNode(dict(NUM_LOADERS=3))

# ---------------------------------------------------------------------------
# Data loader options (reference defaults.py:932-941)
# ---------------------------------------------------------------------------
_C.DATA_LOADER = CfgNode(
    dict(NUM_WORKERS=8, PIN_MEMORY=True, ENABLE_MULTI_THREAD_DECODE=False)
)

# ---------------------------------------------------------------------------
# Detection options (reference defaults.py:947-959)
# ---------------------------------------------------------------------------
_C.DETECTION = CfgNode(
    dict(
        ENABLE=False,
        ALIGNED=True,
        SPATIAL_SCALE_FACTOR=16,
        ROI_XFORM_RESOLUTION=7,
    )
)

# ---------------------------------------------------------------------------
# AVA options (reference defaults.py:965-1025). Default paths are generic.
# ---------------------------------------------------------------------------
_C.AVA = CfgNode(
    dict(
        FRAME_DIR="",
        FRAME_LIST_DIR="",
        ANNOTATION_DIR="",
        TRAIN_LISTS=["train.csv"],
        TEST_LISTS=["val.csv"],
        TRAIN_GT_BOX_LISTS=["ava_train_v2.2.csv"],
        TRAIN_PREDICT_BOX_LISTS=[],
        TEST_PREDICT_BOX_LISTS=["ava_val_predicted_boxes.csv"],
        DETECTION_SCORE_THRESH=0.9,
        BGR=False,
        TRAIN_USE_COLOR_AUGMENTATION=False,
        TRAIN_PCA_JITTER_ONLY=True,
        TEST_FORCE_FLIP=False,
        FULL_TEST_ON_VAL=False,
        LABEL_MAP_FILE="ava_action_list_v2.2_for_activitynet_2019.pbtxt",
        EXCLUSION_FILE="ava_val_excluded_timestamps_v2.2.csv",
        GROUNDTRUTH_FILE="ava_val_v2.2.csv",
        IMG_PROC_BACKEND="cv2",
    )
)

# ---------------------------------------------------------------------------
# Multigrid options (reference defaults.py:1031-1068)
# ---------------------------------------------------------------------------
_C.MULTIGRID = CfgNode(
    dict(
        EPOCH_FACTOR=1.5,
        SHORT_CYCLE=False,
        SHORT_CYCLE_FACTORS=[0.5, 0.5 ** 0.5],
        LONG_CYCLE=False,
        LONG_CYCLE_FACTORS=[
            (0.25, 0.5 ** 0.5),
            (0.5, 0.5 ** 0.5),
            (0.5, 1),
            (1, 1),
        ],
        BN_BASE_SIZE=8,
        EVAL_FREQ=3,
        LONG_CYCLE_SAMPLING_RATE=0,
        DEFAULT_B=0,
        DEFAULT_T=0,
        DEFAULT_S=0,
    )
)

# ---------------------------------------------------------------------------
# TensorBoard options (reference defaults.py:1073-1168)
# ---------------------------------------------------------------------------
_C.TENSORBOARD = CfgNode(
    dict(
        ENABLE=False,
        PREDICTIONS_PATH="",
        LOG_DIR="",
        CLASS_NAMES_PATH="",
        CATEGORIES_PATH="",
        CONFUSION_MATRIX=CfgNode(
            dict(ENABLE=False, FIGSIZE=[8, 8], SUBSET_PATH="")
        ),
        HISTOGRAM=CfgNode(
            dict(ENABLE=False, SUBSET_PATH="", TOPK=10, FIGSIZE=[8, 8])
        ),
        MODEL_VIS=CfgNode(
            dict(
                ENABLE=False,
                MODEL_WEIGHTS=False,
                ACTIVATIONS=False,
                INPUT_VIDEO=False,
                LAYER_LIST=[],
                TOPK_PREDS=1,
                COLORMAP="Pastel2",
                GRAD_CAM=CfgNode(
                    dict(
                        ENABLE=True,
                        LAYER_LIST=[],
                        USE_TRUE_LABEL=False,
                        COLORMAP="viridis",
                    )
                ),
            )
        ),
        WRONG_PRED_VIS=CfgNode(
            dict(
                ENABLE=False,
                TAG="Incorrectly classified videos.",
                SUBSET_PATH="",
            )
        ),
    )
)

# ---------------------------------------------------------------------------
# Demo options (reference defaults.py:1174-1257)
# ---------------------------------------------------------------------------
_C.DEMO = CfgNode(
    dict(
        ENABLE=False,
        LABEL_FILE_PATH="",
        WEBCAM=-1,
        INPUT_VIDEO="",
        DISPLAY_WIDTH=0,
        DISPLAY_HEIGHT=0,
        # The person detector is a torchvision faster-rcnn loaded from
        # local weights (visualization/demo.py PersonDetector) — the
        # detectron2 cfg name is accepted for config compatibility.
        DETECTRON2_CFG="COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml",
        DETECTRON2_WEIGHTS="",
        DETECTRON2_THRESH=0.9,
        BUFFER_SIZE=0,
        OUTPUT_FILE="",
        OUTPUT_FPS=-1,
        INPUT_FORMAT="BGR",
        # Annotation drawing runs at native frame resolution here;
        # accepted for config compatibility.
        CLIP_VIS_SIZE=10,
        NUM_VIS_INSTANCES=2,
        PREDS_BOXES="",
        THREAD_ENABLE=False,
        NUM_CLIPS_SKIP=0,
        GT_BOXES="",
        STARTING_SECOND=900,
        FPS=30,
        VIS_MODE="thres",
        COMMON_CLASS_THRES=0.7,
        UNCOMMON_CLASS_THRES=0.3,
        COMMON_CLASS_NAMES=[
            "watch (a person)",
            "talk to (e.g., self, a person, a group)",
            "listen to (a person)",
            "touch (an object)",
            "carry/hold (an object)",
            "walk",
            "sit",
            "lie/sleep",
            "bend/bow (at the waist)",
        ],
        SLOWMO=1,
    )
)

# ---------------------------------------------------------------------------
# TPU-native extensions (not in the reference).
# ---------------------------------------------------------------------------
_C.TPU = CfgNode(
    dict(
        # Mesh axis sizes; -1 on DATA means "all remaining devices".
        MESH_DATA=-1,
        # Spatial partitioning: shard the clip H axis over a second
        # ("spatial") mesh axis of this size. XLA/GSPMD inserts the conv
        # halo exchanges automatically; semantics are identical to the
        # data-only mesh (tested). Lets per-chip batch shrink below 1
        # clip — the TPU answer to the reference's fixed one-GPU-many-
        # clips decomposition for large spatial extents.
        SPATIAL_PARTITIONS=1,
        # Sequence partitioning (MViT family): shard the token axis of
        # every (B, N, C) block activation over a second ("seq") mesh
        # axis. Token-parallel LN/MLP/projections run without comms;
        # GSPMD all-gathers the (pooled, small) K/V for attention and
        # reshards around pooling convs. The TPU answer to the
        # reference's single-GPU O(N^2) ceiling for long token grids
        # (SURVEY.md §5: MViTv2-L 40x3 reaches N≈62k at stage 1).
        # Mutually exclusive with SPATIAL_PARTITIONS.
        SEQ_PARTITIONS=1,
        # Tensor (head/hidden) partitioning for the MViT family: shard the
        # attention q/k/v channel axis (head-major, so heads split across
        # chips) and the MLP hidden axis over a second ("model") mesh axis.
        # Megatron-style compute split: qkv/fc1 column-parallel, proj/fc2
        # row-parallel with a GSPMD-inserted psum; params stay replicated
        # (memory scaling comes from remat/Rev-MViT), so checkpoints and
        # multigrid rebuilds are sharding-agnostic. Must divide
        # MVIT.NUM_HEADS at every stage. Mutually exclusive with
        # SPATIAL_PARTITIONS and SEQ_PARTITIONS.
        TENSOR_PARTITIONS=1,
        # Pipeline parallelism (MViT family): split the transformer block
        # stack into this many stages placed on disjoint device groups
        # (parallel/pipeline.py). GPipe schedule: microbatches stream
        # through per-stage jitted programs; backward recomputes each
        # stage's forward (stage-granular remat); gradients accumulate on
        # the stage's own devices. Unlike the GSPMD axes above, stage
        # params are PLACED (each group owns its blocks' weights and
        # optimizer state outright) — this is the axis that scales
        # parameter memory. Composes with data parallelism (devices are a
        # (pipe, data) grid); mutually exclusive with the GSPMD model axes.
        # train() dispatches to engine/pipeline_trainer.py when > 1; the
        # tester/visualizers drive one GSPMD mesh and reject the knob.
        PIPELINE_PARTITIONS=1,
        # Microbatches per step in pipeline mode; 0 = PIPELINE_PARTITIONS
        # (the minimum that keeps every stage busy outside fill/drain).
        PIPELINE_MICROBATCHES=0,
        # Compute dtype for matmuls/convs: "bfloat16" or "float32".
        COMPUTE_DTYPE="bfloat16",
        # Number of batches prefetched to device.
        PREFETCH=2,
        # Donate input buffers to the train step (saves HBM).
        DONATE=True,
        # Pallas pooled-attention kernel for MViT (ops/pallas_attention.py):
        # True = on when running on the TPU backend; "force" = also on CPU
        # (interpret mode, tests only); False = XLA einsum path.
        # Default OFF: measured 45.6 vs 51.9 clips/s on MViTv2-S/v5e — the
        # pooled-K attention is only ~5% of step HBM traffic, and the
        # kernel's recompute + dq-padding overheads outweigh the saving.
        PALLAS_ATTENTION=False,
        # Round-3 aligned fused attention kernel (fused_pooled_attention):
        # per-head-aligned flat layout, constant-shift softmax, e16-only
        # residual. Default OFF: once the pool-norm fp32 promotion was
        # fixed (bf16 q/k/v), the XLA einsum path measures 88.3 vs the
        # kernel's 75.7 clips/s on MViTv2-S/v5e — XLA's fused bf16 chains
        # beat the custom-call boundary. Kept for ablation/large-Nk cases.
        FUSED_ATTENTION=False,
        # True reversible backprop for Rev-MViT (models/reversible.py):
        # a custom VJP over each reversible span saves ONLY the span
        # outputs and reconstructs every block's inputs in the backward by
        # inverting the two residual updates — O(1)-in-depth residual
        # activation memory, like the reference's RevBackProp
        # (reversible_mvit.py:177-263). False falls back to per-block
        # remat (O(depth) stream boundaries, same numerics up to fp
        # rounding); used for the grad-equivalence test.
        REV_BACKPROP=True,
        # Use jax.checkpoint (remat) on heavy stages when ACT_CHECKPOINT.
        REMAT_POLICY="nothing_saveable",
        # Debug: return early after this stage name (e.g. "s2"); "" = off.
        TRUNCATE_AT="",
        # Selective rematerialization: stage names to recompute in backward
        # (e.g. ["s1", "s2"] — cheap FLOPs, huge activations).
        REMAT_STAGES=[],
        # uint8 input pipeline: datasets emit cropped uint8 clips, the
        # host->device transfer ships uint8 (4x smaller), and the train/eval
        # step normalizes + pathway-splits on-chip (ops/preprocess.py).
        # Spatial resampling then happens in uint8 (one extra rounding vs
        # the reference's float path — same tradeoff as its decode-time
        # resize backend).
        UINT8_PIPELINE=True,
    )
)

custom_config.add_custom_config(_C)


def assert_and_infer_cfg(cfg):
    """Validate a merged config and apply derived values.

    Mirrors the reference's checks (slowfast/config/defaults.py:1262-1287):
    checkpoint-type membership, batch divisibility by chip count, ResNet
    group sanity, LR scaling by NUM_SHARDS, and shard-id bounds.
    """
    if cfg.BN.USE_PRECISE_STATS:
        assert cfg.BN.NUM_BATCHES_PRECISE >= 0
    assert cfg.TRAIN.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.NUM_GPUS == 0 or cfg.TRAIN.BATCH_SIZE % cfg.NUM_GPUS == 0
    assert cfg.TEST.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.NUM_GPUS == 0 or cfg.TEST.BATCH_SIZE % cfg.NUM_GPUS == 0
    assert cfg.RESNET.NUM_GROUPS > 0
    assert cfg.RESNET.WIDTH_PER_GROUP > 0
    assert cfg.RESNET.WIDTH_PER_GROUP % cfg.RESNET.NUM_GROUPS == 0
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.WARMUP_START_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.COSINE_END_LR *= cfg.NUM_SHARDS
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    # All reference MASK mode combinations are implemented
    # (models/masked.py): MAE/MaskFeat x loader/random/tube/per-frame
    # masking, DECODER_SEP_POS_EMBED, and DEC_KV_KERNEL/STRIDE pooling.
    assert cfg.MASK.HEAD_TYPE in ("separate", "separate_xformer"), (
        cfg.MASK.HEAD_TYPE
    )
    return cfg


def get_cfg():
    """Return a fresh mutable copy of the default config."""
    return _C.clone()
