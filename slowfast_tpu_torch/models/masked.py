"""Masked pretraining, MaskFeat and MAE, on the MViT trunk (counterpart of
slowfast_tpu/models/masked.py; reference slowfast/models/masked.py).

``MaskMViT`` returns ``(preds, [(target, mask), ...])``, one pair per
prediction depth; ``masked_loss`` is the mask-weighted MSE over them.

MaskFeat (``MASK.MAE_ON`` off): the loader's mask (``AUG.MASK_WINDOW_SIZE``
granularity) is upsampled to the token grid, or, under
``MASK.MAE_RND_MASK``, a random token mask is drawn; masked tokens become
the mask token before the cls token is prepended; the trunk runs to
``MASK.PRETRAIN_DEPTH``; each depth's features go through its head
(``MSSeparateHead``) and are scored against HOG (``MASK.PRED_HOG``) or
pixel targets of the temporally strided frames, at every position, the
loss weighting the masked ones.

MAE (``MASK.MAE_ON``): one noise tensor expresses every mask source (the
loader's mask itself, ``AUG.MASK_TUBE``, ``MASK.PER_FRAME_MASKING`` rows,
uniform noise); a stable argsort gives the kept and the restoring
indices, with the kept count static from ``AUG.MASK_RATIO``. The encoder
runs without pooling or rel-pos on the visible tokens and the cls token,
then its norm and ``decoder_embed``; the mask tokens fill the other slots,
unshuffled as the JAX package does it (per-frame rows are formed after the
mask tokens are appended to the whole sample, so an earlier frame's masked
slots take later frames' visible embeddings: a quirk of the reference kept
on purpose); the decoder pos-embeds and ``MSSeparateHead``'s transformer
blocks follow, scored against patchified pixels.

Random masks draw from the model's generator in training and from a
generator seeded with 0 in eval (the JAX package draws from
``PRNGKey(0)`` there; the draws differ).
"""

import numpy as np
import torch
from torch import nn

from slowfast_tpu_torch.ops.hog import hog_features

from .attention import MultiScaleBlock
from .common import layer_norm, linear
from .mvit import (_check_supported, feature_geometry, get_3d_sincos_pos_embed,
                   mvit_block_schedule, patch_stride, sep_pos_table)
from .stem import PatchEmbed
from .video_models import compute_dtype

HOG_BINS, HOG_CELL = 9, 8


def uniform_noise(shape, generator, device):
    """Uniform [0, 1) fp32 noise of ``shape`` from ``generator``: the one
    place the masks draw from."""
    return torch.rand(shape, generator=generator, device=device)


def _norm_pixels(patches):
    mu = patches.mean(dim=-1, keepdim=True)
    var = patches.var(dim=-1, keepdim=True, correction=0)
    return (patches - mu) / torch.sqrt(var + 1e-6)


class MSSeparateHead(nn.Module):
    """Per-depth heads (slowfast_tpu/models/masked.py:36, reference
    head_helper.py:565-672): under ``HEAD_TYPE separate_xformer``
    ``MASK.DECODER_DEPTH`` transformer blocks (no q pooling, kv pooling by
    ``MASK.DEC_KV_KERNEL``/``DEC_KV_STRIDE``), then a LayerNorm (default
    init, eps 1e-6), the cls row dropped, and the Linear ``projections.{i}``.
    ``transforms.{i}`` holds the blocks and the LayerNorm last, as the
    reference's ``nn.Sequential`` does, so the ``state_dict`` keys match."""

    def __init__(self, cfg, num_classes, head_dims, feat_sizes, dtype):
        super().__init__()
        head_type = cfg.MASK.HEAD_TYPE.split("_")
        n_xf = cfg.MASK.DECODER_DEPTH if len(head_type) > 1 and head_type[1] == "xformer" else 0
        self.cls_on = cfg.MVIT.CLS_EMBED_ON
        self.dtype = dtype
        self.transforms = nn.ModuleList()
        self.projections = nn.ModuleList()
        for i, n_out in enumerate(num_classes):
            dim, layers = head_dims[i], []
            for _ in range(n_xf):
                dim_out = cfg.MASK.DECODER_EMBED_DIM
                layers.append(MultiScaleBlock(
                    dim=dim, dim_out=dim_out, num_heads=max(dim_out // 64, 1),
                    input_size=tuple(feat_sizes[i]), mlp_ratio=cfg.MVIT.MLP_RATIO,
                    qkv_bias=cfg.MVIT.QKV_BIAS, drop_rate=cfg.MVIT.DROPOUT_RATE,
                    kernel_kv=tuple(cfg.MASK.DEC_KV_KERNEL),
                    stride_kv=tuple(cfg.MASK.DEC_KV_STRIDE), mode=cfg.MVIT.MODE,
                    has_cls_embed=self.cls_on, pool_first=cfg.MVIT.POOL_FIRST,
                    exact_softmax=bool(cfg.TPU.PALLAS_ATTENTION), dtype=dtype))
                dim = dim_out
            layers.append(nn.LayerNorm(dim, eps=1e-6))
            self.transforms.append(nn.ModuleList(layers))
            self.projections.append(nn.Linear(dim, n_out))

    def forward(self, feats, thws):
        outs = []
        for i, x in enumerate(feats):
            thw = list(thws[i])
            *blocks, norm = self.transforms[i]
            for blk in blocks:
                x, thw = blk(x, thw)
            x = layer_norm(x, norm)
            if self.cls_on:
                x = x[:, 1:]
            outs.append(linear(x, self.projections[i], self.dtype))
        return outs


class MaskMViT(nn.Module):
    """MaskFeat / MAE pretraining model (slowfast_tpu/models/masked.py:106).

    ``forward([clips (B, T, H, W, C)], mask=None)``: ``mask`` is the
    loader's, ``(B, t, h, w)`` (or ``(B, h, w)``), needed unless
    ``MASK.MAE_RND_MASK``."""

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        m, mk = cfg.MVIT, cfg.MASK
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.generator = None  # the model's, set by models.build.build_model
        self.mae = mk.MAE_ON
        self.cls_on = m.CLS_EMBED_ON
        s = int(self.cls_on)
        dim = m.EMBED_DIM
        ps = patch_stride(cfg)
        self.patch_embed = PatchEmbed(cfg.DATA.INPUT_CHANNEL_NUM[0], dim, m.PATCH_KERNEL,
                                      m.PATCH_STRIDE, m.PATCH_PADDING, conv_2d=m.PATCH_2D)
        T0, H0, W0 = (cfg.DATA.NUM_FRAMES // ps[0], cfg.DATA.TRAIN_CROP_SIZE // ps[1],
                      cfg.DATA.TRAIN_CROP_SIZE // ps[2])
        self.patch_dims = [T0, H0, W0]
        N = T0 * H0 * W0
        dec_dim = mk.DECODER_EMBED_DIM
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec_dim if self.mae else dim))
        if self.cls_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_mode = None
        if m.USE_ABS_POS:
            if m.USE_FIXED_SINCOS_POS:
                self.pos_mode = "sincos"
                self.register_buffer("sincos", torch.from_numpy(get_3d_sincos_pos_embed(
                    dim, int(round(np.sqrt(H0 * W0))), T0, cls_token=self.cls_on))[None],
                    persistent=False)
            elif m.SEP_POS_EMBED:
                self.pos_mode = "sep"
                self.pos_embed_spatial = nn.Parameter(torch.zeros(1, H0 * W0, dim))
                self.pos_embed_temporal = nn.Parameter(torch.zeros(1, T0, dim))
                if self.cls_on:
                    self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, dim))
            else:
                self.pos_mode = "joint"
                self.pos_embed = nn.Parameter(torch.zeros(1, s + N, dim))

        # The trunk to the deepest PRETRAIN_DEPTH (masked.py:527-573): MAE's
        # runs on the visible tokens with no pooling and no rel-pos.
        self.schedule = mvit_block_schedule(cfg)
        self.depths = list(mk.PRETRAIN_DEPTH)
        pool = not self.mae
        dpr = np.linspace(0, m.DROPPATH_RATE, m.DEPTH)
        input_size = list(self.patch_dims) if pool else [1, 1, 1]
        self.blocks = nn.ModuleList()
        for i, blk in enumerate(self.schedule[:max(self.depths) + 1]):
            self.blocks.append(MultiScaleBlock(
                dim=blk["dim"], dim_out=blk["dim_out"], num_heads=blk["num_heads"],
                input_size=tuple(input_size), mlp_ratio=m.MLP_RATIO, qkv_bias=m.QKV_BIAS,
                droppath_rate=float(dpr[i]),
                kernel_q=blk["kernel_q"] if pool else (),
                kernel_kv=blk["kernel_kv"] if pool else (),
                stride_q=blk["stride_q"] if pool else (),
                stride_kv=blk["stride_kv"] if pool else (), mode=m.MODE,
                has_cls_embed=self.cls_on, rel_pos_spatial=m.REL_POS_SPATIAL and pool,
                rel_pos_temporal=m.REL_POS_TEMPORAL and pool,
                residual_pooling=m.RESIDUAL_POOLING, dim_mul_in_att=m.DIM_MUL_IN_ATT,
                exact_softmax=bool(cfg.TPU.PALLAS_ATTENTION), dtype=self.dtype))
            if pool and blk["stride_q"]:
                input_size = [(n - 1) // st + 1 for n, st in zip(input_size, blk["stride_q"])]

        crop, C = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.INPUT_CHANNEL_NUM[0]
        if self.mae:
            enc_dim = self.schedule[max(self.depths)]["dim_out"]
            self.norm = nn.LayerNorm(enc_dim, eps=1e-6)
            self.decoder_embed = nn.Linear(enc_dim, dec_dim)
            self.dec_pos_mode = None
            if m.USE_ABS_POS:
                if mk.DECODER_SEP_POS_EMBED:
                    self.dec_pos_mode = "sep"
                    self.dec_pos_embed_spatial = nn.Parameter(torch.zeros(1, H0 * W0, dec_dim))
                    self.dec_pos_embed_temporal = nn.Parameter(torch.zeros(1, T0, dec_dim))
                    if self.cls_on:
                        self.dec_pos_embed_class = nn.Parameter(torch.zeros(1, 1, dec_dim))
                else:
                    self.dec_pos_mode = "joint"
                    self.decoder_pos_embed = nn.Parameter(torch.zeros(1, s + N, dec_dim))
            pt, ph, pw = ps
            label_dim = ph * pw * C * (1 if mk.TIME_STRIDE_LOSS else pt)
            self.pred_head = MSSeparateHead(cfg, [label_dim], [dec_dim], [self.patch_dims],
                                            self.dtype)
        else:
            num_classes, head_dims, feat_sizes = [], [], []
            for depth in self.depths:
                (t_d, h_d, w_d), _ = feature_geometry(self.schedule, self.patch_dims, depth)
                if mk.PRED_HOG:
                    cells_per = (crop // HOG_CELL) // h_d
                    num_classes.append(3 * HOG_BINS * cells_per * cells_per)
                else:
                    num_classes.append((crop // h_d) * (crop // w_d) * C)
                head_dims.append(self.schedule[depth]["dim_out"])
                feat_sizes.append([t_d, h_d, w_d])
            self.pred_head = MSSeparateHead(cfg, num_classes, head_dims, feat_sizes, self.dtype)

    def forward(self, xs, mask=None):
        x_raw = xs[0]
        tokens, thw = self.patch_embed(x_raw.to(self.dtype))
        if self.mae:
            return self._mae_forward(tokens, thw, x_raw, mask)
        return self._maskfeat_forward(tokens, thw, x_raw, mask)

    # --- masks ------------------------------------------------------------

    def _noise(self, shape, device):
        gen = self.generator if self.training else (
            torch.Generator(device=device).manual_seed(0))
        return uniform_noise(shape, gen, device)

    def _random_token_mask(self, B, N, device):
        """A random ``(B, N)`` token mask at ``AUG.MASK_RATIO`` (masked.py:168)."""
        len_keep = int(N * (1 - self.cfg.AUG.MASK_RATIO))
        ids_shuffle = torch.argsort(self._noise((B, N), device), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        m = torch.zeros((B, N), device=device)
        m[:, len_keep:] = 1.0
        return torch.gather(m, 1, ids_restore)

    @staticmethod
    def _mask_to_token_grid(mask, B, T0, H0, W0):
        """The loader's mask repeated up to the token grid ``(B, T0, H0, W0)``
        (masked.py:158-166)."""
        mask = mask.float()
        if mask.dim() == 3:  # a 2D mask: the same for every time step
            mask = mask[:, None].expand(B, T0, *mask.shape[1:])
        mt, mh, mw = mask.shape[1:]
        return (mask.repeat_interleave(T0 // mt, dim=1).repeat_interleave(H0 // mh, dim=2)
                .repeat_interleave(W0 // mw, dim=3))

    # --- pos-embeds -------------------------------------------------------

    def _pos_table(self):
        """The trunk's ``(1, s + N, C)`` fp32 pos-embed table, or None."""
        if self.pos_mode == "sincos":
            return self.sincos
        if self.pos_mode == "sep":
            return sep_pos_table(self.pos_embed_spatial, self.pos_embed_temporal,
                              self.pos_embed_class if self.cls_on else None)
        return self.pos_embed if self.pos_mode == "joint" else None

    def _dec_pos_table(self):
        if self.dec_pos_mode == "sep":
            return sep_pos_table(self.dec_pos_embed_spatial, self.dec_pos_embed_temporal,
                              self.dec_pos_embed_class if self.cls_on else None)
        return self.decoder_pos_embed if self.dec_pos_mode == "joint" else None

    # --- MaskFeat ---------------------------------------------------------

    def _maskfeat_forward(self, tokens, thw, x_raw, mask):
        cfg = self.cfg
        B, N, C = tokens.shape
        T0, H0, W0 = thw
        if cfg.MASK.MAE_RND_MASK:
            mask_tok = self._random_token_mask(B, N, tokens.device).reshape(B, T0, H0, W0)
        else:
            if mask is None:
                raise ValueError("MaskFeat needs the loader's mask (AUG.GEN_MASK_LOADER)")
            mask_tok = self._mask_to_token_grid(mask, B, T0, H0, W0)
        mask_flat = mask_tok.reshape(B, N, 1)
        dt = tokens.dtype
        x = tokens * (1.0 - mask_flat).to(dt) + self.mask_token.to(dt) * mask_flat.to(dt)
        # The cls token joins after the mask token's replacement.
        if self.cls_on:
            x = torch.cat([self.cls_token.to(dt).expand(B, -1, -1), x], dim=1)
        pos = self._pos_table()
        if pos is not None:
            x = x + pos.to(dt)
        feats = []
        for i, blk in enumerate(self.blocks):
            x, thw = blk(x, thw)
            if i in self.depths:
                feats.append(x)

        thws, labels = [], []
        for d_i, depth in enumerate(self.depths):
            (t_d, h_d, w_d), _ = feature_geometry(self.schedule, [T0, H0, W0], depth)
            labels.append(self._hog_labels(x_raw, t_d, h_d, w_d) if cfg.MASK.PRED_HOG
                          else self._pixel_labels(x_raw, t_d, h_d, w_d))
            m = mask_tok[:, ::max(T0 // t_d, 1), ::max(H0 // h_d, 1), ::max(W0 // w_d, 1)]
            labels[-1] = (labels[-1], m[:, :t_d, :h_d, :w_d].reshape(B, -1))
            thws.append([t_d, h_d, w_d])
        return self.pred_head(feats, thws), labels

    @staticmethod
    def _hog_labels(x_raw, t_d, h_d, w_d):
        """HOG of the temporally strided frames, one row per feature cell, in
        the per-cell order (c, bin, i, j), the cell offsets fastest
        (masked.py:264-289)."""
        B, T, H, W, C = x_raw.shape
        frames = x_raw[:, ::T // t_d][:, :t_d].reshape(B * t_d, H, W, C)
        hog = hog_features(frames.detach().float(), nbins=HOG_BINS, cell_sz=HOG_CELL)
        Hc, Wc = hog.shape[-2:]
        if Hc % h_d or Wc % w_d:
            raise ValueError(f"HOG cell grid {Hc}x{Wc} (crop/{HOG_CELL}) must tile the feature "
                             f"grid {h_d}x{w_d}; pick DATA.TRAIN_CROP_SIZE so crop/{HOG_CELL} "
                             f"is a multiple of the pooled token grid")
        cp = Hc // h_d
        hog = hog.reshape(B * t_d, 3, HOG_BINS, h_d, cp, w_d, cp).permute(0, 3, 5, 1, 2, 4, 6)
        return hog.reshape(B, t_d * h_d * w_d, -1)

    def _pixel_labels(self, x_raw, t_d, h_d, w_d):
        """Pixel targets per feature cell (masked.py:291-304)."""
        B, T, H, W, C = x_raw.shape
        hs, ws = H // h_d, W // w_d
        frames = x_raw[:, ::T // t_d][:, :t_d].detach().float()
        patches = frames.reshape(B, t_d, h_d, hs, w_d, ws, C).permute(0, 1, 2, 4, 3, 5, 6)
        patches = patches.reshape(B, t_d * h_d * w_d, -1)
        return _norm_pixels(patches) if self.cfg.MASK.NORM_PRED_PIXEL else patches

    # --- MAE ----------------------------------------------------------------

    def _mae_forward(self, tokens, thw, x_raw, mask):
        cfg = self.cfg
        B, N, C = tokens.shape
        T0, H0, W0 = thw
        s = int(self.cls_on)
        dev = tokens.device
        pos = self._pos_table()
        x = tokens if pos is None else tokens + pos[:, s:].to(tokens.dtype)

        if not cfg.MASK.MAE_RND_MASK:
            if mask is None:
                raise ValueError("MASK.MAE_RND_MASK False needs the loader's mask "
                                 "(AUG.GEN_MASK_LOADER)")
            if mask.numel() != B * N:
                raise ValueError(f"MAE loader mask {tuple(mask.shape)} must match the token "
                                 f"grid ({B}, {T0}, {H0}, {W0}); set AUG.MASK_WINDOW_SIZE to "
                                 "the patch grid")
            noise = mask.float().reshape(B, N)
        elif cfg.AUG.MASK_TUBE:
            noise = self._noise((B, 1, H0 * W0), dev).repeat(1, T0, 1).reshape(B, N)
        else:
            noise = self._noise((B, N), dev)
        rows, L = (B * T0, H0 * W0) if cfg.MASK.PER_FRAME_MASKING else (B, N)
        len_keep = int(L * (1 - cfg.AUG.MASK_RATIO))
        if len_keep < 1:
            raise ValueError(f"AUG.MASK_RATIO {cfg.AUG.MASK_RATIO} leaves no visible tokens")
        ids_shuffle = torch.argsort(noise.reshape(rows, L), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep, None]
        x_vis = torch.gather(x.reshape(rows, L, C), 1, ids_keep.expand(-1, -1, C))
        x_vis = x_vis.reshape(B, -1, C)
        if s:
            cls = self.cls_token.to(x_vis.dtype)
            if pos is not None:
                cls = cls + pos[:, :s].to(x_vis.dtype)
            x_vis = torch.cat([cls.expand(B, -1, -1), x_vis], dim=1)

        for blk in self.blocks:
            x_vis, _ = blk(x_vis, [1, 1, x_vis.shape[1]])
        x_dec = linear(layer_norm(x_vis, self.norm), self.decoder_embed, self.dtype)
        D = x_dec.shape[-1]
        n_vis = x_dec.shape[1] - s
        mask_tokens = self.mask_token.to(x_dec.dtype).expand(B, N - n_vis, -1)
        x_ = torch.cat([x_dec[:, s:], mask_tokens], dim=1).reshape(rows, L, D)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, D)).reshape(B, N, D)
        x_full = torch.cat([x_dec[:, :s], x_], dim=1)
        dec_pos = self._dec_pos_table()
        if dec_pos is not None:
            x_full = x_full + dec_pos.to(x_full.dtype)

        preds = self.pred_head([x_full], [[T0, H0, W0]])
        m = torch.zeros((rows, L), device=dev)
        m[:, len_keep:] = 1.0
        m = torch.gather(m, 1, ids_restore).reshape(B, N)
        return preds, [(self._mae_pixel_targets(x_raw, T0, H0, W0), m)]

    def _mae_pixel_targets(self, x_raw, T0, H0, W0):
        """Patchified pixels (masked.py:426-448); under
        ``MASK.TIME_STRIDE_LOSS`` of the temporally strided frames."""
        B, T, H, W, C = x_raw.shape
        pt, ph, pw = patch_stride(self.cfg)
        frames = x_raw.detach().float()
        if self.cfg.MASK.TIME_STRIDE_LOSS:
            patches = frames[:, ::pt][:, :T0].reshape(B, T0, H0, ph, W0, pw, C)
            patches = patches.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T0 * H0 * W0, -1)
        else:
            patches = frames.reshape(B, T0, pt, H0, ph, W0, pw, C)
            patches = patches.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, T0 * H0 * W0, -1)
        return _norm_pixels(patches) if self.cfg.MASK.NORM_PRED_PIXEL else patches


def masked_loss(preds, labels, count=lambda n: n):
    """The mask-weighted MSE over ``(pred, (target, mask))`` pairs, in fp32
    (slowfast_tpu/models/masked.py:576): per depth, the per-position mean
    square error summed over the masked positions and divided by
    ``max(mask.sum(), 1)``; averaged over the depths. ``count`` maps the
    depths' stacked mask sums to the ones to divide by (the global ones
    under a process group)."""
    counts = count(torch.stack([torch.sum(mask) for _, (_, mask) in zip(preds, labels)]))
    total = 0.0
    for pred, (target, mask), n in zip(preds, labels, counts):
        err = torch.mean(torch.square(pred.float() - target), dim=-1)
        total = total + torch.sum(err * mask) / torch.clamp(n, min=1.0)
    return total / len(preds)
