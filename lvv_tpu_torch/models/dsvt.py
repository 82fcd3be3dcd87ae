"""DSVT, the Dynamic Sparse Voxel Transformer with rotated sets
(counterpart of lvv_tpu/models/dsvt.py).

- `window_coords`: each voxel's window id and in-window (z, y, x); the
  shifted phase offsets the grid by half a window (no z shift where the
  window spans the whole z extent).
- `rotated_set_partition`: each window's voxels ranked along y or x (one
  stable sort by the int32 key wid · max_key + in-window key, ranks within
  a window) and cut into sets of `set_size`: (set_row, col, ok) into a
  [max_sets, set_size] table; row `max_sets` is the dump of invalid and
  overflowing voxels (the fixed-capacity unique's clamp to its last slot).
- `plan_max_sets`: the host's count of the sets a cloud needs (numpy).
- `SetAttentionLayer`: the voxels scattered into their sets (with the
  in-window position embedding), multi-head attention within each set
  (keys up to the set's count, at least one), gathered back, residual,
  LayerNorm, ReLU FFN, LayerNorm.
- `DSVTBlock`: two such layers in one window phase, over the y-sorted
  sets and then the x-sorted ones.
- `ZPoolAttention`: the attention z-pooling between stages: groups of
  `stride` voxels along z; the query is their masked max, the keys carry a
  learned per-slot embedding, one attention layer (empty slots masked by
  an additive -1e30 bias), LayerNorm of attention + query.
- `DSVTBackbone`: the blocks, shift alternating, in one stage or in
  stages joined by ZPoolAttention; `DSVTDetector`: DynamicVoxelVFE (two
  layers) -> DSVTBackbone -> the z-fold onto a dense BEV ->
  BaseBEVResBackbone -> DenseCenterHead, decoded at stride 1.

Set and window keys are int32 as in JAX (SENTINEL = int32 max). Live
(row, col) slots are unique; only the dump row takes repeated writes, all
zeros. The attention keeps JAX's dispatch rule (`ops.attention.attention`):
with 36 or 48 keys, and with ZPoolAttention's bias, it is the plain fp32
attention; no hand-written kernel runs here. Every norm is flax's
nn.LayerNorm (`flax_layer_norm`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.attention import attention
from ..ops.segment import ingroup_inds, unique_with_inverse
from ..ops.sparse import (SENTINEL, SparseTensor, bev_collapse, delinearize,
                          from_voxels, gather_rows, report_overflow,
                          to_dense)
from ..ops.voxelize import voxelize_mean
from .layers import PARAM_FP32, new_param
from .pointpillars import (BaseBEVResBackbone, Dense, DenseCenterHead,
                           DenseDetector, FlaxLayerNorm, decode_dense)
from .vfe import DynamicVoxelVFE
from .voxelnext import Detections

NEG = -1e30              # ZPoolAttention's mask value, as JAX's


def _i32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def window_coords(st: SparseTensor, window: Tuple[int, int, int],
                  shift: bool):
    """-> (window id [V] int32, SENTINEL where invalid; in-window coords
    [V, 3] (z, y, x), 0 where invalid)."""
    dev = st.ids.device
    coords = delinearize(st.ids, st.grid)                 # (z, y, x)
    wz, wy, wx = window
    nz = int(st.grid[2])
    shift_z = shift and wz < nz
    off = _i32([wz // 2 if shift_z else 0, wy // 2 if shift else 0,
                wx // 2 if shift else 0], dev)
    shifted = coords + off[None]
    win = _i32([wz, wy, wx], dev)[None]
    wc = torch.div(shifted, win, rounding_mode="floor")
    inner = shifted - wc * win
    nwx = -(-st.grid[0] // wx) + 1
    nwy = -(-st.grid[1] // wy) + 1
    wid = (wc[:, 0] * nwy + wc[:, 1]) * nwx + wc[:, 2]
    valid = st.valid
    wid = torch.where(valid, wid, SENTINEL).to(torch.int32)
    inner = torch.where(valid[:, None], inner, 0).to(torch.int32)
    return wid, inner


def rotated_set_partition(wid: torch.Tensor, inner: torch.Tensor,
                          valid: torch.Tensor, window: Tuple[int, int, int],
                          set_size: int, max_sets: int, axis: str):
    """-> (set_row [V], col [V], ok [V]): each valid voxel's set (rank in
    its window along `axis` // set_size, numbered by a fixed-capacity
    unique over (window, set)) and column (rank % set_size); overflowing
    and invalid voxels to row max_sets."""
    wz, wy, wx = window
    if axis == "y":
        key = inner[:, 1] * (wz * wx) + inner[:, 2] * wz + inner[:, 0]
    else:
        key = inner[:, 2] * (wz * wy) + inner[:, 1] * wz + inner[:, 0]
    max_key = wz * wy * wx
    composite = torch.where(valid, wid * max_key + key,
                            SENTINEL).to(torch.int32)
    order = torch.argsort(composite, stable=True)
    rank_sorted = ingroup_inds(wid[order], valid[order])
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    set_in_win = torch.where(valid, torch.div(rank, set_size,
                                              rounding_mode="floor"), 0)
    col = torch.where(valid, rank % set_size, 0).to(torch.int32)
    max_sets_per_win = -(-max_key // set_size)
    gset = torch.where(valid, wid * max_sets_per_win + set_in_win,
                       SENTINEL).to(torch.int32)
    # max_sets + 1 slots: the unique clamps overflowing runs into its last
    # slot, which is kept as the dump row
    _, inverse, _, n_unique = unique_with_inverse(gset, SENTINEL,
                                                  max_sets + 1)
    report_overflow("dsvt_sets", n_unique, max_sets)
    ok = valid & (inverse < max_sets)
    return torch.where(ok, inverse, max_sets).to(torch.int32), col, ok


def plan_max_sets(ids, grid, window: Tuple[int, int, int], set_size: int,
                  bucket: int = 1024) -> int:
    """The sets a cloud needs on the host (numpy): Σ_w ceil(n_w / set_size)
    over the occupied windows, the larger of the two window phases,
    rounded up to `bucket`. `ids` are linear voxel ids, SENTINEL where
    empty."""
    ids = np.asarray(ids)
    ids = ids[ids != SENTINEL]
    if ids.size == 0:
        return bucket
    nx, ny, nz = grid
    z = ids // (nx * ny)
    y = (ids // nx) % ny
    x = ids % nx
    wz, wy, wx = window
    need = 0
    for shift in (False, True):
        oz = wz // 2 if (shift and wz < nz) else 0
        oy, ox = (wy // 2, wx // 2) if shift else (0, 0)
        wc = ((z + oz) // wz, (y + oy) // wy, (x + ox) // wx)
        n_wx = -(-nx // wx) + 1
        n_wy = -(-ny // wy) + 1
        wid = (wc[0] * n_wy + wc[1]) * n_wx + wc[2]
        _, counts = np.unique(wid, return_counts=True)
        need = max(need, int(np.sum(-(-counts // set_size))))
    return -(-need // bucket) * bucket


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, C] -> [B, heads, S, C // heads]."""
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class SetAttentionLayer(nn.Module):
    """Set attention and FFN over one partition (`rotated_set_partition`'s
    tables); the position embedding is added to the set's entries, so q, k
    and v all see it, as in JAX."""

    def __init__(self, c: int, num_heads: int, mlp_ratio: float = 2.0, *,
                 device):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Dense(c, c, **kw))
        self.ln1 = FlaxLayerNorm(c, **kw)
        self.fc1 = Dense(c, int(c * mlp_ratio), **kw)
        self.fc2 = Dense(int(c * mlp_ratio), c, **kw)
        self.ln2 = FlaxLayerNorm(c, **kw)

    def forward(self, feats: torch.Tensor, pos: torch.Tensor, set_row, col,
                ok, max_sets: int, set_size: int) -> torch.Tensor:
        c = feats.shape[-1]
        row, colj = set_row.long(), col.long()
        # row max_sets is the dump of invalid and overflowing voxels; live
        # (row, col) slots are unique, the dump only takes zeros
        sets = feats.new_zeros((max_sets + 1, set_size, c)).index_put(
            (row, colj), torch.where(ok[:, None], feats + pos, 0.0))
        counts = torch.zeros(max_sets + 1, dtype=torch.int32,
                             device=feats.device).index_add_(
            0, row, ok.to(torch.int32))
        o = attention(_heads(self.q(sets), self.num_heads),
                      _heads(self.k(sets), self.num_heads),
                      _heads(self.v(sets), self.num_heads),
                      kv_len=counts.clamp_min(1))
        o = self.proj(_merge(o)).reshape(-1, c)
        # each voxel's slot back (JAX's where(ok, o[row, col], 0)); the
        # invalid and dropped ones read a zero row and take no gradient,
        # where a plain index would sum all their gradients into one slot
        slot = torch.where(ok, row * set_size + colj, o.shape[0])
        y = feats + gather_rows(o, slot)
        y = self.ln1(y)
        h = self.fc2(torch.relu(self.fc1(y)))
        return self.ln2(y + h)


class DSVTBlock(nn.Module):
    """Two rotated-set layers in one window phase: layer 0 over the
    y-sorted sets, layer 1 over the x-sorted ones."""

    def __init__(self, c: int, num_heads: int, window: Tuple[int, int, int],
                 set_size: int, max_sets: int, shift: bool = False, *,
                 device):
        super().__init__()
        kw = dict(device=device)
        self.window, self.set_size = tuple(window), set_size
        self.max_sets, self.shift = max_sets, shift
        self.pos_embed = Dense(3, c, **kw)
        self.layer_0 = SetAttentionLayer(c, num_heads, **kw)
        self.layer_1 = SetAttentionLayer(c, num_heads, **kw)

    def forward(self, st: SparseTensor) -> SparseTensor:
        wid, inner = window_coords(st, self.window, self.shift)
        f = st.features
        win = torch.tensor(self.window, dtype=f.dtype, device=f.device)
        pos = self.pos_embed(inner.to(f.dtype) / win[None])
        for layer, axis in ((self.layer_0, "y"), (self.layer_1, "x")):
            row, col, ok = rotated_set_partition(
                wid, inner, st.valid, self.window, self.set_size,
                self.max_sets, axis)
            f = layer(f, pos, row, col, ok, self.max_sets, self.set_size)
        f = torch.where(st.valid[:, None], f, 0.0)
        return SparseTensor(st.ids, f, st.grid)


def group_max(pre: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """[G, S, C] -> [G, C]: the max over each group's filled slots, 0 for a
    group with none."""
    q = torch.where(filled[..., None], pre, NEG).amax(1)
    return torch.where(filled.any(1)[:, None], q, 0.0)


class ZPoolAttention(nn.Module):
    """Attention z-pooling by `stride`: voxels grouped by (z // stride, y,
    x), the group's masked max as the query, its slots plus a learned
    per-slot embedding as the keys (the slots alone as the values), one
    multi-head attention with empty slots masked, LayerNorm(attention +
    query). Emits the pooled tensor on the z-reduced grid at the input's
    capacity."""

    def __init__(self, c: int, stride: int, num_heads: int = 8, *, device):
        super().__init__()
        kw = dict(device=device)
        self.stride, self.num_heads = stride, num_heads
        self.pos_embedding = new_param((stride, c), ("normal", 0.01),
                                       dtype=PARAM_FP32, device=device)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Dense(c, c, **kw))
        self.norm = FlaxLayerNorm(c, **kw)

    def forward(self, st: SparseTensor) -> SparseTensor:
        v, c = st.features.shape
        nx, ny, nz = (int(g) for g in st.grid)
        coords = delinearize(st.ids, st.grid)               # (z, y, x)
        zp = torch.div(coords[:, 0], self.stride, rounding_mode="floor")
        slot = (coords[:, 0] % self.stride).long()
        pooled_ids = (zp * ny + coords[:, 1]) * nx + coords[:, 2]
        pooled_ids = torch.where(st.valid, pooled_ids,
                                 SENTINEL).to(torch.int32)
        # every output voxel has a source: v rows suffice, row v the dump
        uniq, inverse, _, _ = unique_with_inverse(pooled_ids, SENTINEL,
                                                  v + 1)
        ok = st.valid & (inverse < v)
        row = torch.where(ok, inverse, v).long()
        pre = st.features.new_zeros((v + 1, self.stride, c)).index_put(
            (row, slot), torch.where(ok[:, None], st.features, 0.0))
        filled = torch.zeros((v + 1, self.stride), dtype=torch.bool,
                             device=st.ids.device).index_put((row, slot), ok)
        q = group_max(pre, filled)[:, None]                 # [v + 1, 1, c]
        key = pre + self.pos_embedding[None].to(pre.dtype)
        h = self.num_heads
        bias = torch.where(filled[:, None, None, :], 0.0,
                           NEG).to(torch.float32)
        o = attention(_heads(self.q_proj(q), h), _heads(self.k_proj(key), h),
                      _heads(self.v_proj(pre), h), bias=bias)
        out = self.o_proj(_merge(o))[:, 0]
        out = self.norm(out + q[:, 0])
        uniq = uniq[:v]
        out = torch.where((uniq != SENTINEL)[:, None], out[:v], 0.0)
        return SparseTensor(uniq, out, (nx, ny, -(-nz // self.stride)))


class DSVTBackbone(nn.Module):
    """in_proj, then DSVT blocks with the window shift alternating: one
    stage of `num_blocks` (`stage_blocks` empty), or stages of
    `stage_blocks[s]` blocks at `stage_windows[s]` joined by ZPoolAttention
    with z-stride `downsample[s]`. `max_sets` 0 takes ceil(V / set_size) ·
    2."""

    def __init__(self, cin: int, capacity: int, channels: int = 64,
                 num_blocks: int = 4, num_heads: int = 4,
                 window: Tuple[int, int, int] = (4, 8, 8),
                 set_size: int = 32, max_sets: int = 0,
                 stage_blocks: Sequence[int] = (),
                 stage_windows: Sequence[Tuple[int, int, int]] = (),
                 downsample: Sequence[int] = (), *, device):
        super().__init__()
        kw = dict(device=device)
        self.in_proj = Dense(cin, channels, **kw)
        self.max_sets = max_sets or -(-capacity // set_size) * 2
        self.names: List[Tuple[str, bool]] = []       # (module, is a block)

        def block(name, win, i):
            setattr(self, name, DSVTBlock(channels, num_heads, win,
                                          set_size, self.max_sets,
                                          shift=bool(i % 2), **kw))
            self.names.append((name, True))
        if not stage_blocks:
            for i in range(num_blocks):
                block(f"block_{i}", tuple(window), i)
            return
        assert len(stage_windows) == len(stage_blocks)
        assert len(downsample) == len(stage_blocks) - 1
        for s, (nb, win) in enumerate(zip(stage_blocks, stage_windows)):
            for i in range(nb):
                block(f"stage_{s}_block_{i}", tuple(win), i)
            if s < len(downsample):
                name = f"stage_{s}_reduction"
                setattr(self, name, ZPoolAttention(
                    channels, int(downsample[s]), **kw))
                self.names.append((name, False))

    def forward(self, st: SparseTensor,
                trace: Optional[List] = None) -> SparseTensor:
        """st -> the trunk's sparse tensor; `trace`, when given, receives
        (name, SparseTensor) after every block and reduction."""
        f = torch.where(st.valid[:, None], self.in_proj(st.features), 0.0)
        st = SparseTensor(st.ids, f, st.grid)
        for name, _ in self.names:
            st = getattr(self, name)(st)
            if trace is not None:
                trace.append((name, st))
        return st


class DSVTDetector(DenseDetector):
    """points -> DynamicVoxelVFE (two layers; `dsvt_learned_vfe` False:
    voxelize_mean) -> DSVTBackbone -> the column sum onto the dense BEV
    (`bev_collapse`; a no-op fold where the stages already reach nz 1) ->
    BaseBEVResBackbone -> DenseCenterHead; decoded at stride 1."""

    def __init__(self, det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig, *,
                 device=None, seed: int = 0):
        super().__init__(det_cfg, vox_cfg, device)
        cfg = det_cfg
        kw = dict(device=self._device)
        cin = vox_cfg.num_point_features
        if cfg.dsvt_learned_vfe:
            self.vfe = DynamicVoxelVFE(cin, cfg.dsvt_channels, num_layers=2,
                                       **kw)
            cin = cfg.dsvt_channels
        self.backbone3d = DSVTBackbone(
            cin, vox_cfg.max_voxels, channels=cfg.dsvt_channels,
            num_blocks=cfg.dsvt_blocks, num_heads=cfg.dsvt_heads,
            window=tuple(cfg.dsvt_window), set_size=cfg.dsvt_set_size,
            max_sets=cfg.dsvt_max_sets,
            stage_blocks=tuple(cfg.dsvt_stage_blocks),
            stage_windows=tuple(tuple(w) for w in cfg.dsvt_stage_windows),
            downsample=tuple(cfg.dsvt_downsample), **kw)
        self.backbone2d = BaseBEVResBackbone(
            cfg.dsvt_channels, layer_channels=tuple(cfg.dsvt_bev_channels),
            layer_strides=tuple(cfg.dsvt_bev_strides),
            layer_nums=tuple(cfg.dsvt_bev_nums),
            upsample_channels=tuple(cfg.dsvt_bev_upsample), **kw)
        self.head = DenseCenterHead(self.backbone2d.out_channels,
                                    cfg.num_classes, **kw)
        self._finish(seed)

    def stages(self, trace=None):
        grid = self.voxel_grid()
        cap = self.vox_cfg.max_voxels

        def voxels(points, n):
            if self.det_cfg.dsvt_learned_vfe:
                vox = self.vfe(points, n, grid, cap)
            else:
                vox = voxelize_mean(points, n, grid, max_voxels=cap)
            return from_voxels(vox.coords, vox.features, grid.grid_size)

        def trunk(st):
            return self.backbone3d(st, trace)

        def bev(st):
            return self.backbone2d(to_dense(bev_collapse(st))[:, 0])
        return (("voxelize", voxels), ("trunk3d", trunk), ("trunk2d", bev),
                ("head", self.head_out))

    def head_out(self, bev):
        return {"bev_dense": bev, "preds": self.head(bev)}

    def decode(self, out) -> Detections:
        return decode_dense(out["preds"], self.det_cfg, self.vox_cfg,
                            stride=1)
