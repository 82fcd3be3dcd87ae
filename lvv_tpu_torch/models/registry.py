"""Detector registry and `build_detector` (counterpart of
lvv_tpu/models/registry.py).

The JAX package registers 17 detector families. The port builds 15:
VoxelNeXt, PointPillars, CenterPoint, SECOND, TransFusion, PillarNet and
DSVT (LiDAR, one stage); PVRCNN, PVRCNNPlusPlus, PartA2, VoxelRCNN (its LiDAR trunk; a
config with `focal` raises), SECONDNetIoU and PointRCNN (LiDAR, two
stages); and BEVFusion and CaDDN (camera input: their `forward` and
`detect` take views and calibration, and they do not train, since the
JAX package has no train step that takes camera tensors). Every other
registered name (MPPNet, MPPNetE2E) raises
NotImplementedError until its family is ported (ROADMAP.md, queue 1,
item 2: the detector zoo), and an unknown name raises KeyError, as JAX's
`build_detector` does.
"""
from __future__ import annotations

import importlib

DETECTORS = ("VoxelNeXt", "PointPillars", "CenterPoint", "SECOND", "PVRCNN",
             "PointRCNN", "DSVT", "BEVFusion", "PartA2", "SECONDNetIoU",
             "PillarNet", "PVRCNNPlusPlus", "CaDDN", "VoxelRCNN",
             "TransFusion", "MPPNet", "MPPNetE2E")
# name -> (module of this package, class)
PORTED = {"VoxelNeXt": ("voxelnext", "VoxelNeXtDetector"),
          "PointPillars": ("pointpillars", "PointPillarsDetector"),
          "CenterPoint": ("centerpoint", "CenterPointDetector"),
          "SECOND": ("second", "SECONDDetector"),
          "TransFusion": ("transfusion", "TransFusionDetector"),
          "PVRCNN": ("pv_rcnn", "PVRCNNDetector"),
          "PVRCNNPlusPlus": ("pv_rcnn_pp", "PVRCNNPlusPlusDetector"),
          "PartA2": ("part_a2", "PartA2Detector"),
          "VoxelRCNN": ("voxel_rcnn", "VoxelRCNNDetector"),
          "SECONDNetIoU": ("second_iou", "SECONDNetIoUDetector"),
          "PointRCNN": ("point_rcnn", "PointRCNNDetector"),
          "BEVFusion": ("bevfusion", "BEVFusionDetector"),
          "CaDDN": ("caddn", "CaDDNDetector"),
          "PillarNet": ("pillarnet", "PillarNetDetector"),
          "DSVT": ("dsvt", "DSVTDetector")}


def build_detector(name: str, det_cfg, vox_cfg, *, device=None,
                   seed: int = 0, **options):
    """The detector `name` on `device` (the card unless told otherwise),
    its weights random from `seed`, in eval mode; `options` go to the
    family's class (e.g. BEVFusion's `image_hw`, TransFusion's
    `num_queries`)."""
    if name not in DETECTORS:
        raise KeyError(f"unknown detector {name!r}; "
                       f"registered: {sorted(DETECTORS)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"detector {name!r} is not ported yet: it waits for ROADMAP.md "
            "queue 1, item 2 (the detector zoo); the port builds "
            f"{', '.join(PORTED)}")
    module, cls = PORTED[name]
    mod = importlib.import_module(f"{__package__}.{module}")
    return getattr(mod, cls)(det_cfg, vox_cfg, device=device, seed=seed,
                             **options)
