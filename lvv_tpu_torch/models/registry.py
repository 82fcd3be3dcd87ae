"""Detector registry and `build_detector` (counterpart of
lvv_tpu/models/registry.py).

The port builds every family the JAX package registers, 17:
VoxelNeXt, PointPillars, CenterPoint, SECOND, TransFusion, PillarNet and
DSVT (LiDAR, one stage); PVRCNN, PVRCNNPlusPlus, PartA2, VoxelRCNN (with
its focal / multimodal trunk where the config sets `focal`), SECONDNetIoU
and PointRCNN (LiDAR, two stages); MPPNet and MPPNetE2E (multi-frame
refinement of given proposals: their `forward` takes frame stacks and
proposals, and they train through `train.detector.make_mppnet_train_step`;
both run 4 frames whatever the preset, as JAX's registry builds them with
its default); and BEVFusion and CaDDN (camera input: their `forward` and
`detect` take views and calibration, and they do not train, since the
JAX package has no train step that takes camera tensors). An unknown name
raises KeyError, as JAX's `build_detector` does.
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
          "DSVT": ("dsvt", "DSVTDetector"),
          "MPPNet": ("mppnet", "MPPNetDetector"),
          "MPPNetE2E": ("mppnet", "MPPNetE2E")}


def build_detector(name: str, det_cfg, vox_cfg, *, device=None,
                   seed: int = 0, **options):
    """The detector `name` on `device` (the card unless told otherwise),
    its weights random from `seed`, in eval mode; `options` go to the
    family's class (e.g. BEVFusion's `image_hw`, TransFusion's
    `num_queries`, MPPNet's `point_features`)."""
    if name not in DETECTORS:
        raise KeyError(f"unknown detector {name!r}; "
                       f"registered: {sorted(DETECTORS)}")
    module, cls = PORTED[name]
    mod = importlib.import_module(f"{__package__}.{module}")
    return getattr(mod, cls)(det_cfg, vox_cfg, device=device, seed=seed,
                             **options)
