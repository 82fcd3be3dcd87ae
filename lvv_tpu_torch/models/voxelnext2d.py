"""VoxelNeXt2D, the pillar (sparse 2D) form of VoxelNeXt's trunk
(counterpart of lvv_tpu/models/voxelnext2d.py).

Sparse 2D residual stages to stride 16 (or 32 with five widths); the
stride-16 and stride-32 stages are re-indexed onto the stride-8 grid, each
through a 1x1 conv to the stride-8 width, added in (`merge_add` at the
stride-8 capacity), and a 3x3 submanifold conv gives the output. JAX's
zoo tests pin it; no JAX detector builds it.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ..ops.sparse import (SparseTensor, build_subm_rulebook, merge_add,
                          reindex_upscale)
from .pillarnet import stage_capacities
from .voxelnext import SparseBasicBlock, SparseConvLayer


class VoxelNeXt2DBackbone(nn.Module):
    """[pillars] -> the stride-8 sparse 2D tensor with the stride-16 (and
    stride-32) features folded in."""

    def __init__(self, cin: int, capacity: int,
                 channels: Sequence[int] = (32, 64, 128, 256, 256), *,
                 device):
        super().__init__()
        chs = tuple(channels)
        kw = dict(ndim2d=True, device=device)
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        self.res1 = SparseBasicBlock(chs[0], **kw)
        self.capacities = stage_capacities(capacity, len(chs) - 1)
        for i, (ch, cap) in enumerate(zip(chs[1:], self.capacities),
                                      start=1):
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap,
                **kw))
            setattr(self, f"res{i + 1}a", SparseBasicBlock(ch, **kw))
            setattr(self, f"res{i + 1}b", SparseBasicBlock(ch, **kw))
        self.align16 = SparseConvLayer(chs[4], chs[3], kernel=1, **kw)
        if len(chs) > 5:
            self.align32 = SparseConvLayer(chs[5], chs[3], kernel=1, **kw)
        self.conv_out = SparseConvLayer(chs[3], chs[3], **kw)

    def forward(self, st: SparseTensor) -> SparseTensor:
        rb = build_subm_rulebook(st, ndim2d=True)
        st = self.res1(self.conv_input(st, rb), rb)
        stages = []
        for i in range(1, len(self.capacities) + 1):
            st = getattr(self, f"down{i}")(st)
            rb = build_subm_rulebook(st, ndim2d=True)
            st = getattr(self, f"res{i + 1}b")(
                getattr(self, f"res{i + 1}a")(st, rb), rb)
            stages.append(st)
        # stages at strides 2, 4, 8, 16 (, 32): the last ones onto stride 8
        s8 = stages[2]
        cap = s8.ids.shape[0]
        up16 = self.align16(reindex_upscale(stages[3], 2, s8.grid))
        merged = merge_add(s8, up16, capacity=cap)
        if len(stages) > 4:
            up32 = self.align32(reindex_upscale(stages[4], 4, s8.grid))
            merged = merge_add(merged, up32, capacity=cap)
        return self.conv_out(merged)
