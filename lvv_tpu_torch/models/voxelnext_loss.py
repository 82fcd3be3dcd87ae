"""VoxelNeXt's training targets and losses, fixed-shape (counterpart of
lvv_tpu/models/voxelnext_loss.py).

- Heatmap targets live only on active sparse sites: for every gt box a
  gaussian bump at each active site, max-combined per class channel, and
  the gt's nearest active site (its centre site, within its gaussian
  radius) pinned to 1 in its class.
- Regression targets attach to each gt's centre site: [dx offset, dy
  offset, z, log-dims, sin, cos] (8 values; L1, weight 2).
- The CenterNet gaussian focal loss over active sites (weight 1).

Gts are padded to a fixed count with a mask. Targets carry no gradient
(they come from ids and gt boxes). Where two gts write one site's
regression row, the last gt in order wins, as XLA's scatter on the CPU
keeps the last writer; `_scatter_last` picks that writer by a max over
gt indices, so the choice is the same on the CPU and on the card (a
duplicate-index `index_put_` is not deterministic on CUDA). Every gt
without a centre site writes a zero row to the last site, as JAX's does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config.schema import VoxelizeConfig, VoxelNeXtConfig
from ..ops.sparse import SparseTensor, delinearize


def gaussian_radius(dx: torch.Tensor, dy: torch.Tensor,
                    min_overlap: float = 0.5) -> torch.Tensor:
    """CenterNet's radius heuristic, the stable r1 root, at least 1."""
    b1 = dy + dx
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt((b1 ** 2 - 4 * c1).clamp_min(0.0))
    return ((b1 + sq1) / 2).clamp_min(1.0)


def _scatter_last(n_rows: int, index: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """zeros [n_rows, ...] with row index[g] = values[g] for every g, the
    highest g winning where indices repeat (JAX's `.at[index].set(values)`
    on the CPU)."""
    g = torch.arange(index.shape[0], device=index.device)
    writer = torch.full((n_rows,), -1, dtype=torch.long, device=index.device)
    writer = writer.scatter_reduce(0, index.long(), g, "amax")
    got = values[writer.clamp_min(0)]
    hit = (writer >= 0).view(-1, *(1,) * (values.dim() - 1))
    return torch.where(hit, got, torch.zeros_like(got))


def assign_targets(bev: SparseTensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                   det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                   stride: int) -> Dict[str, torch.Tensor]:
    """gt_boxes [G, 9] (x, y, z, dx, dy, dz, heading, vx, vy), gt_labels
    [G] int, gt_mask [G] bool -> {"hm" [V, C] gaussian heatmap, "reg"
    [V, 8] regression targets, "reg_mask" [V] bool (some gt's centre
    site)}."""
    vx, vy = vox_cfg.voxel_size[0], vox_cfg.voxel_size[1]
    x0, y0 = vox_cfg.point_range[0], vox_cfg.point_range[1]
    v = bev.ids.shape[0]
    coords = delinearize(bev.ids, bev.grid)                  # (0, y, x)
    site_y = coords[:, 1].float()
    site_x = coords[:, 2].float()
    valid_site = bev.valid
    gt_boxes = gt_boxes.float()
    gt_mask = gt_mask.bool()

    # gt centres and sizes in stride-grid units
    gx = (gt_boxes[:, 0] - x0) / (vx * stride)
    gy = (gt_boxes[:, 1] - y0) / (vy * stride)
    radius = gaussian_radius(gt_boxes[:, 3] / (vx * stride),
                             gt_boxes[:, 4] / (vy * stride))
    sigma2 = (2 * radius / 6.0) ** 2 * 2.0

    # squared distance of every site to every gt centre: [V, G]
    d2 = ((site_x[:, None] - gx[None, :]) ** 2
          + (site_y[:, None] - gy[None, :]) ** 2)
    bump = torch.exp(-d2 / sigma2[None, :].clamp_min(1e-6))
    bump = torch.where(gt_mask[None, :] & valid_site[:, None], bump, 0.0)

    c = det_cfg.num_classes
    onehot = F.one_hot(gt_labels.long().clamp(0, c - 1), c).float()
    hm_tgt = (bump[:, :, None] * (onehot * gt_mask[:, None])[None]
              ).amax(1)                                       # [V, C]

    # nearest active site per gt (first on ties) = its centre site
    d2_masked = torch.where(valid_site[:, None], d2, 1e12)
    centre = torch.argmin(d2_masked, 0)                       # [G]
    near = d2_masked.gather(0, centre[None])[0] < radius ** 2 + 1.0
    assign = gt_mask & near
    safe_site = torch.where(assign, centre, v - 1)

    # the centre site is an exact positive (the reference pins the peak)
    peak = onehot * assign[:, None]
    hm_tgt = hm_tgt.scatter_reduce(
        0, safe_site[:, None].expand(-1, c), peak, "amax")
    hm_tgt = hm_tgt * valid_site[:, None]

    rows = torch.stack([
        gx - site_x[centre], gy - site_y[centre], gt_boxes[:, 2],
        torch.log(gt_boxes[:, 3].clamp_min(1e-3)),
        torch.log(gt_boxes[:, 4].clamp_min(1e-3)),
        torch.log(gt_boxes[:, 5].clamp_min(1e-3)),
        torch.sin(gt_boxes[:, 6]), torch.cos(gt_boxes[:, 6])], 1)  # [G, 8]
    reg_tgt = _scatter_last(v, safe_site,
                            torch.where(assign[:, None], rows, 0.0))
    reg_mask = _scatter_last(v, safe_site, assign) & valid_site
    return {"hm": hm_tgt, "reg": reg_tgt, "reg_mask": reg_mask}


def gaussian_focal_loss(pred_logits: torch.Tensor, target: torch.Tensor,
                        valid: torch.Tensor, alpha: float = 2.0,
                        beta: float = 4.0) -> torch.Tensor:
    """CenterNet focal loss over the valid rows, over the number of
    positives (targets above 0.999; at least 1)."""
    p = torch.sigmoid(pred_logits.float()).clamp(1e-6, 1 - 1e-6)
    pos = (target > 0.999).float()
    neg_weight = (1 - target) ** beta
    pos_loss = -torch.log(p) * (1 - p) ** alpha * pos
    neg_loss = -torch.log(1 - p) * p ** alpha * neg_weight * (1 - pos)
    m = valid[:, None].float()
    num_pos = (pos * m).sum().clamp_min(1.0)
    return ((pos_loss + neg_loss) * m).sum() / num_pos


def _l1(pred_vec: torch.Tensor, targets: Dict,
        code_weights=None) -> torch.Tensor:
    diff = (pred_vec.float() - targets["reg"]).abs()
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)[None, :]
    m = targets["reg_mask"][:, None].float()
    return (diff * m).sum() / m.sum().clamp_min(1.0)


def reg_l1_loss(preds: Dict[str, SparseTensor], targets: Dict,
                code_weights=None) -> torch.Tensor:
    """L1 over the assigned sites, channels [center (2), center_z (1), dim
    (3), rot (2)]."""
    pred_vec = torch.cat([preds[k].features for k in
                          ("center", "center_z", "dim", "rot")], 1)
    return _l1(pred_vec, targets, code_weights)


def voxelnext_loss(preds: Dict[str, SparseTensor], bev: SparseTensor,
                   gt_boxes, gt_labels, gt_mask,
                   det_cfg: VoxelNeXtConfig, vox_cfg: VoxelizeConfig,
                   stride: int, hm_weight: float = 1.0,
                   reg_weight: float = 2.0) -> Tuple[torch.Tensor, Dict]:
    """-> (hm_weight·focal + reg_weight·L1, {"hm_loss", "reg_loss",
    "loss"})."""
    targets = assign_targets(bev, gt_boxes, gt_labels, gt_mask, det_cfg,
                             vox_cfg, stride)
    hm_loss = gaussian_focal_loss(preds["hm"].features, targets["hm"],
                                  bev.valid)
    reg_loss = reg_l1_loss(preds, targets)
    total = hm_weight * hm_loss + reg_weight * reg_loss
    return total, {"hm_loss": hm_loss, "reg_loss": reg_loss, "loss": total}


def dense_center_loss(preds: Dict[str, torch.Tensor], gt_boxes, gt_labels,
                      gt_mask, det_cfg: VoxelNeXtConfig,
                      vox_cfg: VoxelizeConfig, stride: int | None = None,
                      hm_weight: float = 1.0,
                      reg_weight: float = 2.0) -> Tuple[torch.Tensor, Dict]:
    """The centre-head loss on dense BEV maps, through the sparse target
    assigner on an all-active map. preds: {"hm" [C, H, W], "center" [2,
    H, W], "center_z" [1, H, W], "dim" [3, H, W], "rot" [2, H, W]};
    `stride` defaults to grid_ny // H."""
    c, h, w = preds["hm"].shape
    grid_ny = int(round((vox_cfg.point_range[4] - vox_cfg.point_range[1])
                        / vox_cfg.voxel_size[1]))
    if stride is None:
        stride = max(grid_ny // h, 1)
    dev = preds["hm"].device
    bev = SparseTensor(torch.arange(h * w, dtype=torch.int32, device=dev),
                       torch.zeros((h * w, 1), device=dev), (w, h, 1))
    targets = assign_targets(bev, gt_boxes, gt_labels, gt_mask, det_cfg,
                             vox_cfg, stride)

    def flat(m):
        return m.reshape(m.shape[0], -1).t()                 # [HW, ch]

    hm_loss = gaussian_focal_loss(flat(preds["hm"]), targets["hm"],
                                  bev.valid)
    reg_loss = _l1(torch.cat([flat(preds[k]) for k in
                              ("center", "center_z", "dim", "rot")], 1),
                   targets)
    total = hm_weight * hm_loss + reg_weight * reg_loss
    return total, {"hm_loss": hm_loss, "reg_loss": reg_loss, "loss": total}
