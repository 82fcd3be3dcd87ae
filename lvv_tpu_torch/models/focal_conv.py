"""Focal sparse convolution: a submanifold conv whose active set grows
where a learned importance says so (counterpart of
lvv_tpu/models/focal_conv.py).

`FocalSparseConv`: each voxel predicts a sigmoid importance for every
site of its 3³ neighbourhood (Dense `importance`); each empty neighbour
scores centre importance x its own, and the `spawn` best of all V·26
candidates (`ops.nms.top_k`: ties to the lower index, as lax.top_k) join
the active set where they score above 0.5. The union is deduplicated by
two stable sorts: the spawned sites enter as zero rows after the real
voxels, so a real voxel keeps its row, duplicates become SENTINEL and
sort last. The real voxels' features are gated by their centre
importance (the gradient into the importance head), then the subm conv
(`kernel_w`, `bias`) over the grown set, flax's LayerNorm (`ln`) and a
ReLU. With `use_img`, the image features gathered at each voxel's
projection are concatenated into the importance's input and added to
the conv's output (at the grown set's sites).

`FocalMultiScaleBackbone3D`: conv_input, the multimodal focal conv (with
an image), res1 and `focal1`, then three strided stages with a residual
block each and a focal conv after the first two (capacities from
`capacity_schedule`, else 3/4 of the previous, at least 1024) -> (the
four stages, aux: (centre importance, voxel centres, valid) of every
focal conv for `focal_aux_loss`). The centres keep a reference trait:
`delinearize`'s (z, y, x) times the voxel size and plus the range's
origin in (x, y, z) order, as JAX computes them.

The neighbour lookups use the occupancy table under
`_DENSE_LOOKUP_MAX_CELLS` (KITTI's 1408 x 1600 x 40 grid takes it) and
binary search above it, as `build_subm_rulebook` does. No hand-written
kernel: flax's LayerNorm is not the JAX package's Pallas norm.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.nms import top_k
from ..ops.pool import points_in_rotated_boxes
from ..ops.sparse import (SENTINEL, SparseTensor, _find, _fits, _offsets,
                          _occupancy_table, build_subm_rulebook,
                          delinearize, linearize, submanifold_conv)
from .layers import PARAM_FP32, new_param
from .pointpillars import Dense, FlaxLayerNorm
from .semseg import gather_image_features, project_voxels_to_image
from .voxelnext import SparseBasicBlock, SparseConvLayer


class FocalSparseConv(nn.Module):
    """subm conv with learned dilation -> (out SparseTensor, centre
    importance [V]). `img_ch`: the image features' width with `use_img`
    (it must equal out_ch, for the sum after the conv)."""

    def __init__(self, cin: int, out_ch: int, kernel: int = 3,
                 spawn: int = 256, use_img: bool = False, *, device):
        super().__init__()
        k = kernel ** 3
        self.kernel_size, self.spawn, self.use_img = kernel, spawn, use_img
        self.importance = Dense(cin + (out_ch if use_img else 0), k,
                                device=device)
        kw = dict(dtype=PARAM_FP32, device=device)
        self.kernel_w = new_param((k, cin, out_ch), ("he", k * cin), **kw)
        self.bias = new_param((out_ch,), "zeros", **kw)
        self.ln = FlaxLayerNorm(out_ch, device=device)

    def forward(self, st: SparseTensor, image_feat=None, proj=None,
                voxel_size=None, pc_range=None, stride: int = 1,
                spawned: Optional[List] = None):
        """`spawned`, where given, receives the grown set's spawned ids
        (SENTINEL where a slot spawned nothing)."""
        v = st.ids.shape[0]
        offs = _offsets(self.kernel_size, ndim2d=False)
        k = offs.shape[0]
        centre = k // 2
        imp_in = st.features
        if self.use_img:
            if image_feat is None or proj is None:
                raise ValueError("use_img=True needs image_feat and proj")

            def img_at(ids, valid):
                uv, infront = project_voxels_to_image(
                    delinearize(ids, st.grid), voxel_size, pc_range, proj,
                    stride)
                return gather_image_features(image_feat, uv, infront & valid)
            imp_in = torch.cat([img_at(st.ids, st.valid).to(imp_in.dtype),
                                imp_in], -1)
        imp = torch.sigmoid(self.importance(imp_in).float())
        imp_center = imp[:, centre]

        # each empty neighbour site, offset-major (JAX's concatenation
        # order), scored centre importance x its own
        others = [i for i in range(k) if i != centre]
        dev = st.ids.device
        offs_t = torch.as_tensor(offs[others], device=dev)
        coords = delinearize(st.ids, st.grid)
        nid = linearize(coords[None] + offs_t[:, None], st.grid)
        nid = torch.where(st.valid[None], nid, SENTINEL)
        table = _occupancy_table(st) if _fits(st.grid) else None
        _, hit = _find(st, table, nid)
        score = imp_center[None] * imp[:, others].t()
        cand_ids = torch.where(hit, SENTINEL, nid).reshape(-1)
        cand_scores = torch.where(hit | ~st.valid[None], -1.0,
                                  score).reshape(-1)
        top_scores, top_idx = top_k(cand_scores, self.spawn)
        new_ids = torch.where(top_scores > 0.5, cand_ids[top_idx], SENTINEL)
        if spawned is not None:
            spawned.append(new_ids)

        # the union: real voxels (gated) first, spawned zero rows after;
        # a repeated id keeps its first row, the rest become SENTINEL
        all_ids = torch.cat([st.ids, new_ids])
        all_feats = torch.cat([
            st.features * imp_center[:, None].to(st.features.dtype),
            st.features.new_zeros((self.spawn, st.features.shape[1]))])
        order = torch.argsort(all_ids, stable=True)
        s_ids, s_feats = all_ids[order], all_feats[order]
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         s_ids[1:] == s_ids[:-1]])
        s_ids = torch.where(dup, SENTINEL, s_ids)
        s_feats = torch.where(dup[:, None], 0.0, s_feats)
        order2 = torch.argsort(s_ids, stable=True)
        expanded = SparseTensor(s_ids[order2][:v + self.spawn],
                                s_feats[order2][:v + self.spawn], st.grid)
        out = submanifold_conv(expanded, self.kernel_w, self.bias,
                               kernel=self.kernel_size)
        feats = out.features
        if self.use_img:
            feats = feats + img_at(out.ids, out.valid).to(feats.dtype)
        f = torch.relu(self.ln(feats))
        f = torch.where(out.valid[:, None], f, 0.0).to(out.features.dtype)
        return SparseTensor(out.ids, f, out.grid), imp_center


def focal_importance_loss(imp_center: torch.Tensor, centers: torch.Tensor,
                          valid: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_mask: torch.Tensor, alpha: float = 0.25,
                          gamma: float = 2.0) -> torch.Tensor:
    """Focal BCE of the centre importance against "the voxel centre lies
    in a gt box", over the valid voxels."""
    inside = points_in_rotated_boxes(centers, gt_boxes[:, :7].float())
    tgt = (inside & gt_mask.bool()[None, :]).any(1).float()
    p = imp_center.clamp(1e-6, 1 - 1e-6)
    ce = -(tgt * torch.log(p) + (1 - tgt) * torch.log(1 - p))
    p_t = p * tgt + (1 - p) * (1 - tgt)
    a_t = alpha * tgt + (1 - alpha) * (1 - tgt)
    focal = a_t * (1 - p_t) ** gamma * ce
    n = valid.sum().clamp_min(1)
    return (focal * valid).sum() / n


def focal_aux_loss(aux, gt_boxes, gt_labels, gt_mask,
                   weight: float = 1.0) -> torch.Tensor:
    """The sum of every focal conv's importance loss."""
    total = 0.0
    for imp, centers, valid in aux:
        total = total + focal_importance_loss(imp, centers, valid, gt_boxes,
                                              gt_mask)
    return weight * total


class FocalMultiScaleBackbone3D(nn.Module):
    """The focal trunk to stride 8 -> (stages [strides 1, 2, 4, 8], aux).
    `use_img` builds the multimodal focal conv, which runs where the call
    passes image features."""

    def __init__(self, cfg, cin: int, capacity: int, use_img: bool = False,
                 spawn: int = 256, *, device):
        super().__init__()
        chs = tuple(cfg.channels[:4])
        kw = dict(device=device)
        self.channels = chs
        self.conv_input = SparseConvLayer(cin, chs[0], **kw)
        if use_img:
            self.focal_multimodal = FocalSparseConv(chs[0], chs[0],
                                                    spawn=spawn,
                                                    use_img=True, **kw)
        self.res1 = SparseBasicBlock(chs[0], **kw)
        self.focal1 = FocalSparseConv(chs[0], chs[0], spawn=spawn, **kw)
        sched = getattr(cfg, "capacity_schedule", None)
        cap = capacity
        for i, ch in enumerate(chs[1:], start=1):
            cap = (sched[i - 1] if sched and i - 1 < len(sched)
                   else max(cap * 3 // 4, 1024))
            setattr(self, f"down{i}", SparseConvLayer(
                chs[i - 1], ch, subm=False, stride=2, out_capacity=cap,
                **kw))
            setattr(self, f"res{i + 1}", SparseBasicBlock(ch, **kw))
            if i < 3:
                setattr(self, f"focal{i + 1}", FocalSparseConv(
                    ch, ch, spawn=spawn, **kw))

    def forward(self, st: SparseTensor, image_feat=None, proj=None,
                voxel_size=None, pc_range=None, trace: Optional[List] = None,
                spawned: Optional[List] = None):
        def centers_of(s, stride):
            dev = s.ids.device
            vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                                 device=dev) * stride
            lo = torch.as_tensor(pc_range[:3], dtype=torch.float32,
                                 device=dev)
            return delinearize(s.ids, s.grid).float() * vs + lo

        aux = []
        st = self.conv_input(st, build_subm_rulebook(st))
        if image_feat is not None:
            pre = st
            st, imp = self.focal_multimodal(pre, image_feat, proj,
                                            voxel_size, pc_range, 1,
                                            spawned=spawned)
            aux.append((imp, centers_of(pre, 1), pre.valid))
        st = self.res1(st, build_subm_rulebook(st))
        pre = st
        st, imp = self.focal1(pre, spawned=spawned)
        aux.append((imp, centers_of(pre, 1), pre.valid))
        stages = [st]
        for i in range(1, len(self.channels)):
            st = getattr(self, f"down{i}")(st)
            st = getattr(self, f"res{i + 1}")(st, build_subm_rulebook(st))
            if i < 3:
                pre = st
                st, imp = getattr(self, f"focal{i + 1}")(pre,
                                                         spawned=spawned)
                aux.append((imp, centers_of(pre, 2 ** i), pre.valid))
            stages.append(st)
        if trace is not None:
            trace.extend((f"stage{i + 1}", t) for i, t in enumerate(stages))
        return stages, aux
