"""BEV feature precompute of the port, the LiDAR half of the VQA inputs
(counterpart of tools/precompute_bev.py).

    python -m lvv_tpu_torch.tools.precompute_bev --dataroot ROOT \\
        --out DIR [--version v1.0-trainval] [--split train] \\
        [--checkpoint detector.pt] [--batch 8] [--limit N] [--device cpu] \
        [--config config.json]

Reads each sample's LIDAR_TOP `.pcd.bin` through the nuScenes JSON tables
under ROOT/VERSION (`TableNuScenes`) with the native loader
(`lvv_tpu_torch.native`, built at first use; its path is printed), runs the VoxelNeXt detector's
backbone (`default_config()`: 0.075 m voxels over +-54 m, 160,000 voxels;
or the `voxelize` and `model.voxelnext` sections of a config file) and
writes one float16 [C, H, W] `.npy` per sample token to
DIR/SPLIT/TOKEN.npy ([128, 180, 180] at the default). A token whose file exists is
skipped, so a run that stopped can be run again. `--checkpoint` is a
state_dict of the port's VoxelNeXtDetector (`torch.save` of one, e.g. from
`convert.from_jax_detector_params`); without it the weights are random
from a seed, as the JAX tool's are. Prints the count of samples to process
and the ms of each batch. Runs on the card unless `--device` says
otherwise; the detector runs in fp32 with TF32 off, one sample after
another within a batch.
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--checkpoint", default=None,
                   help="detector state_dict (random init if absent)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--config", default=None,
                   help="config file (default: default_config())")
    args = p.parse_args(argv)

    import torch

    from lvv_tpu_torch.config import VQAConfig, default_config, load
    from lvv_tpu_torch.data.nuscenes_tables import TableNuScenes
    from lvv_tpu_torch import native
    from lvv_tpu_torch.data.points import load_points
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector

    cfg = load(VQAConfig, args.config) if args.config else default_config()
    nusc = TableNuScenes(version=args.version, dataroot=args.dataroot)
    out_dir = pathlib.Path(args.out) / args.split
    out_dir.mkdir(parents=True, exist_ok=True)
    items = []
    for sample in nusc.sample:
        token = sample["token"]
        if (out_dir / f"{token}.npy").exists():
            continue
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        items.append((str(pathlib.Path(args.dataroot) / sd["filename"]),
                      token))
        if args.limit and len(items) >= args.limit:
            break
    print(f"{len(items)} samples to process", flush=True)
    if not items:
        return
    print(f"point loader: {native.build()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                            device=args.device)
    if args.checkpoint:
        det.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                       weights_only=True))

    max_pts = cfg.voxelize.max_points
    for i in range(0, len(items), args.batch):
        chunk = items[i:i + args.batch]
        clouds = [load_points(path, max_pts) for path, _ in chunk]
        t0 = time.perf_counter()
        with torch.no_grad():
            bevs = [det(torch.from_numpy(pts), n)["bev_dense"].to(
                        torch.float16).cpu() for pts, n in clouds]
        dt = (time.perf_counter() - t0) * 1000
        for bev, (_, token) in zip(bevs, chunk):
            np.save(out_dir / f"{token}.npy", bev.numpy())
        print(f"[{i + len(chunk)}/{len(items)}] {dt:.1f} ms/batch",
              flush=True)


if __name__ == "__main__":
    main()
