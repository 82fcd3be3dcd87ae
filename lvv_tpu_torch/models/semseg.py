"""The image branch of the multimodal focal sparse conv (counterpart of
lvv_tpu/models/semseg.py): a ResNet-50 stem and bottleneck stages
(`ResNetFeatures`, as deep as the deepest layer asked for; the focal
preset takes layer1, stride 4, 256 channels), a per-layer channel reduce
(`PyramidFeat2D`), and the voxel -> pixel projection and gather that
feed the focal conv.

Layouts: images and feature maps NCHW (convolution kernels OIHW, the
converter's transpose of flax's HWIO); `gather_image_features` takes one
map as [H, W, C], as JAX's does.

Norms, as the JAX package has them:
- "gn": flax's nn.GroupNorm, min(32, C) groups, eps 1e-6, the one-pass
  variance max(E[x²] - E[x]², 0) (`flax_group_norm`; torch's GroupNorm
  has eps 1e-5 and a two-pass variance); the stem's stride-2 conv and
  its 3 x 3 max pool pad "SAME" (an odd total pads one more after,
  `pointpillars.same_pads`; the pool pads with -inf);
- "frozen_bn": a pretrained torchvision trunk's eval BatchNorm as a
  per-channel affine (`FrozenBN`: scale, bias, folded at conversion,
  `convert.deeplabv3_torch`), the convs padded k // 2 on every side and
  the pool by 1, as torchvision pads.
The reduce heads are "gn" whatever the trunk.

`project_voxels_to_image` keeps a reference trait: the focal conv hands it
`delinearize`'s (z, y, x) coordinates, which it scales by the voxel size
and adds to the range's origin in (x, y, z) order, as JAX does.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import PARAM_FP32, new_param
from .pointpillars import FLAX_LN_EPS, Conv2d, same_pads


def flax_group_norm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, groups: int,
                    eps: float = FLAX_LN_EPS) -> torch.Tensor:
    """flax nn.GroupNorm over NCHW x: each group's mean and E[x²] over its
    channels and the spatial axes in one pass, var = max(E[x²] - E[x]²,
    0), y = (x - mean)·(rsqrt(var + eps)·scale) + bias."""
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps)                       # [N, G, 1]

    def per_channel(t):
        return t.expand(n, groups, c // groups).reshape(n, c, 1, 1)
    shape = (1, c, 1, 1)
    return ((x - per_channel(mean))
            * (per_channel(mul) * scale.view(shape)) + bias.view(shape))


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups=min(32, C)): "scale", "bias"."""

    def __init__(self, ch: int, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.groups = min(32, ch)
        self.scale = new_param((ch,), "ones", **kw)
        self.bias = new_param((ch,), "zeros", **kw)

    def forward(self, x):
        return flax_group_norm(x, self.scale, self.bias, self.groups)


class FrozenBN(nn.Module):
    """Eval-mode BatchNorm as y = x·scale + bias per channel."""

    def __init__(self, ch: int, *, device):
        super().__init__()
        kw = dict(dtype=PARAM_FP32, device=device)
        self.scale = new_param((ch,), "ones", **kw)
        self.bias = new_param((ch,), "zeros", **kw)

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return x * self.scale.view(shape) + self.bias.view(shape)


def _norm(norm: str, ch: int, device) -> nn.Module:
    return FrozenBN(ch, device=device) if norm == "frozen_bn" else \
        GroupNorm(ch, device=device)


def _conv(cin, cout, k, stride, norm, device, bias=False) -> Conv2d:
    """flax's nn.Conv: "SAME" for "gn", k // 2 on every side for
    "frozen_bn" (torchvision's padding)."""
    return Conv2d(cin, cout, k, stride, bias=bias,
                  padding=k // 2 if norm == "frozen_bn" else None,
                  device=device)


class BasicBlock2D(nn.Module):
    """conv + norm + ReLU."""

    def __init__(self, cin: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, use_bias: bool = False, norm: str = "gn",
                 *, device):
        super().__init__()
        self.conv = _conv(cin, out_ch, kernel, stride, norm, device,
                          bias=use_bias)
        self.norm = _norm(norm, out_ch, device)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(x)))


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck: 1x1 -> 3x3 (stride) -> 1x1 at 4x width, a
    projected shortcut where the width or stride changes."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 norm: str = "gn", *, device):
        super().__init__()
        out_ch = width * 4
        kw = dict(device=device)
        self.has_proj = cin != out_ch or stride != 1
        if self.has_proj:
            # 1x1 "SAME" pads nothing at any stride
            self.proj = Conv2d(cin, out_ch, 1, stride, bias=False, **kw)
            self.proj_norm = _norm(norm, out_ch, device)
        self.a = BasicBlock2D(cin, width, kernel=1, norm=norm, **kw)
        self.b = BasicBlock2D(width, width, kernel=3, stride=stride,
                              norm=norm, **kw)
        self.c = Conv2d(width, out_ch, 1, bias=False, **kw)
        self.c_norm = _norm(norm, out_ch, device)

    def forward(self, x):
        shortcut = self.proj_norm(self.proj(x)) if self.has_proj else x
        y = self.c_norm(self.c(self.b(self.a(x))))
        return torch.relu(y + shortcut)


LAYER_SPECS = {"layer1": (64, 3, 1), "layer2": (128, 4, 2),
               "layer3": (256, 6, 2), "layer4": (512, 3, 2)}


class ResNetFeatures(nn.Module):
    """Stem and layer1..layerN (N the deepest of `layers_out`) ->
    {layer: [B, C, H/s, W/s]} for the layers asked for; images [B, 3, H,
    W] in [0, 1]."""

    def __init__(self, layers_out: Sequence[str] = ("layer1",),
                 norm: str = "gn", *, device):
        super().__init__()
        self.want, self.norm = tuple(layers_out), norm
        self.deepest = max(int(name[-1]) for name in self.want)
        self.stem_conv = _conv(3, 64, 7, 2, norm, device)
        self.stem_norm = _norm(norm, 64, device)
        self.out_channels = {}
        cin = 64
        for li in range(1, self.deepest + 1):
            name = f"layer{li}"
            width, depth, stride = LAYER_SPECS[name]
            for bi in range(depth):
                setattr(self, f"{name}_b{bi}", Bottleneck(
                    cin, width, stride if bi == 0 else 1, norm,
                    device=device))
                cin = width * 4
            self.out_channels[name] = cin

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.stem_norm(self.stem_conv(images)))
        if self.norm == "frozen_bn":
            pads = (1, 1, 1, 1)
        else:
            ph = same_pads(x.shape[2], 3, 2)
            pw = same_pads(x.shape[3], 3, 2)
            pads = (*pw, *ph)
        x = F.max_pool2d(F.pad(x, pads, value=-torch.inf), 3, 2)
        out = {}
        for li in range(1, self.deepest + 1):
            name = f"layer{li}"
            for bi in range(LAYER_SPECS[name][1]):
                x = getattr(self, f"{name}_b{bi}")(x)
            if name in self.want:
                out[name] = x
        return out


class PyramidFeat2D(nn.Module):
    """`ResNetFeatures` (`ifn`) and a BasicBlock2D channel reduce a layer
    (`reduce{i}`, "gn") -> {layer + "_feat2d": [B, C_i, h, w]}."""

    def __init__(self, feat_layers: Sequence[str] = ("layer1",),
                 reduce_out: Sequence[int] = (32,),
                 reduce_kernel: Sequence[int] = (1,),
                 trunk_norm: str = "gn", *, device):
        super().__init__()
        self.feat_layers = tuple(feat_layers)
        self.ifn = ResNetFeatures(self.feat_layers, trunk_norm,
                                  device=device)
        for i, layer in enumerate(self.feat_layers):
            setattr(self, f"reduce{i}", BasicBlock2D(
                self.ifn.out_channels[layer], reduce_out[i],
                kernel=reduce_kernel[i], device=device))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.ifn(images)
        return {layer + "_feat2d": getattr(self, f"reduce{i}")(feats[layer])
                for i, layer in enumerate(self.feat_layers)}


def project_voxels_to_image(coords: torch.Tensor, voxel_size, pc_range,
                            proj: torch.Tensor, stride: int = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [V, 3] ints -> (uv [V, 2] int32 pixels, rounded half to
    even; valid [V]: depth above 0.1). Centres = coords · voxel_size ·
    stride + pc_range[:3] (no half-voxel offset), through proj [3, 4]."""
    dev = coords.device
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    lo = torch.as_tensor(pc_range[:3], dtype=torch.float32, device=dev)
    centers = coords.float() * vs + lo
    ones = torch.ones((centers.shape[0], 1), dtype=torch.float32, device=dev)
    uvw = torch.cat([centers, ones], 1) @ proj.float().t()
    depth = uvw[:, 2]
    uv = uvw[:, :2] / depth.clamp_min(1e-4)[:, None]
    return torch.round(uv).to(torch.int32), depth > 0.1


def gather_image_features(image_feat: torch.Tensor, uv: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """[H, W, C] features at uv [V, 2] (u, v) pixels -> [V, C]; rows
    outside the image or not valid are zero."""
    h, w = image_feat.shape[:2]
    u, v = uv[:, 0].long(), uv[:, 1].long()
    ok = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    g = image_feat[v.clamp(0, h - 1), u.clamp(0, w - 1)]
    return torch.where(ok[:, None], g, 0.0).to(image_feat.dtype)


def image_feature_map(semseg: PyramidFeat2D, image: torch.Tensor,
                      layer: str = "layer1") -> torch.Tensor:
    """One image [H, W, 3] -> its reduced `layer` features [h, w, C]."""
    x = image.float().permute(2, 0, 1)[None]
    return semseg(x)[layer + "_feat2d"][0].permute(1, 2, 0)


def scale_pixels(proj: torch.Tensor, factor: float) -> torch.Tensor:
    """proj [3, 4] with its two pixel rows scaled by `factor` (the image
    features' stride as a fraction), the depth row kept."""
    f = torch.tensor([[factor], [factor], [1.0]], dtype=proj.dtype,
                     device=proj.device)
    return proj * f

