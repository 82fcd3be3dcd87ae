"""Camera-frame preprocessing on the device (counterpart of
lvv_tpu/ops/image.py): uint8 frames in, normalised and letterboxed float32
views out, so only raw uint8 frames cross from the host.

The order is the JAX package's: normalise to [-1, 1], then resize, then
pad. The pad value 0.0 is mid-grey after normalising, and the image sits at
the top left. The resize is `jax.image.resize(..., "bilinear")`: half-pixel
centres and a triangle filter that widens by the scale factor when it
downsamples (antialiasing, as PIL does), which is `F.interpolate(...,
mode="bilinear", antialias=True)`; without `antialias` it is another
function once a frame shrinks (nuScenes' 1600x900 frames go to 1024x576).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import resolve_device


def _resize_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] float bilinear resize (half-pixel centres, antialiased when
    it downsamples)."""
    return _resize_nchw(img.permute(2, 0, 1)[None], out_h, out_w)[0].permute(
        1, 2, 0)


def _letterbox(h: int, w: int, size: int):
    """The resized (h, w) whose long side is `size`, as JAX rounds it."""
    if h >= w:
        return size, max(1, int(round(w * size / h)))
    return max(1, int(round(h * size / w))), size


def resize_and_pad_to_square(img: torch.Tensor, size: int,
                             pad_value: float = 0.0) -> torch.Tensor:
    """[H, W, C] -> [size, size, C]: aspect-preserving resize so the long
    side is `size`, then pad bottom / right with `pad_value` (the image at
    the top left)."""
    h, w, c = img.shape
    nh, nw = _letterbox(h, w, size)
    out = torch.full((size, size, c), pad_value, dtype=img.dtype,
                     device=img.device)
    out[:nh, :nw] = resize_bilinear(img, nh, nw)
    return out


def normalize_pm1(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [.., C] -> float32 in [-1, 1]: x / 127.5 - 1."""
    return img_u8.to(torch.float32) / 127.5 - 1.0


def _on_device(imgs, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to `device`, by
    default the card."""
    if isinstance(imgs, torch.Tensor):
        return imgs
    return torch.as_tensor(imgs, device=resolve_device(device))


def preprocess_views(imgs_u8, size: int, device=None) -> torch.Tensor:
    """[V, H, W, 3] uint8 -> [V, 3, size, size] float32 in [-1, 1]:
    normalise, resize the long side to `size`, pad to a square (0.0, top
    left). All views in one pass, on the frames' device (a tensor stays
    where it is; an array goes to `device`, by default the card)."""
    x = normalize_pm1(_on_device(imgs_u8, device)).permute(0, 3, 1, 2)
    v, c, h, w = x.shape
    nh, nw = _letterbox(h, w, size)
    out = torch.zeros(v, c, size, size, dtype=x.dtype, device=x.device)
    out[:, :, :nh, :nw] = _resize_nchw(x, nh, nw)
    return out


def preprocess_camera_frame(img_u8, size: int, device=None) -> torch.Tensor:
    """uint8 [H, W, 3] -> float32 [3, size, size] in [-1, 1]
    (`preprocess_views` of one view)."""
    return preprocess_views(_on_device(img_u8, device)[None], size)[0]
