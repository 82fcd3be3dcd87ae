"""Where a VoxelNeXt train step's gradients part between the card and the
CPU, and between float32 and float64.

One train step of chip_smoke.py's `detector-train` phase (default_config(),
batch 1, its seeded weights, surface cloud and vehicle boxes, the CLI's
optimizer chain), run in float32 and in float64, on the CPU and on the card,
each from a voxelization made on either device and handed to the detector
as it is; some runs with every ReLU's gate pinned to another run's (a ReLU
whose input lies within rounding of 0 takes its gate from the rounding).
For each pair of runs it prints the loss, each parameter group's gradient
rel L2 (chip_smoke.py's groups, the "bn"-cancelled conv biases left out as
there) and, for every conv layer in forward order: the largest difference
of the normalised values that enter its ReLU (over the valid rows,
relative to their largest magnitude), the count of entries whose gate
differs, the gradient at the ReLU's input (rel L2), and the share of that
gradient's norm that sits on the entries whose gate differs. It also
compares the two devices' voxelizations.

    python3 detector_grad_audit.py [--norms bn,ln] [--out FILE]

Needs one card. `--out` writes the whole report as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

# (device, dtype, voxelization, run whose gates to replay or None)
RUNS = {
    "card64/vox-card": ("cuda", "float64", "card", None),
    "card64/vox-cpu": ("cuda", "float64", "cpu", None),
    "cpu64/vox-cpu": ("cpu", "float64", "cpu", None),
    "cpu64/vox-card": ("cpu", "float64", "card", None),
    "card32/vox-card": ("cuda", "float32", "card", None),
    "cpu32/vox-cpu": ("cpu", "float32", "cpu", None),
    "card32/vox-card/pinned": ("cuda", "float32", "card", "card64/vox-card"),
    "cpu32/vox-cpu/pinned": ("cpu", "float32", "cpu", "card64/vox-card"),
}
PAIRS = (
    ("card64/vox-cpu", "cpu64/vox-cpu"),      # the same input, each device
    ("cpu64/vox-card", "cpu64/vox-cpu"),      # the voxelizations' difference
    ("card64/vox-card", "cpu64/vox-cpu"),
    ("card32/vox-card", "cpu32/vox-cpu"),     # chip_smoke's card vs CPU
    ("cpu32/vox-cpu", "cpu64/vox-cpu"),       # float32 on the CPU alone
    ("card32/vox-card", "card64/vox-card"),   # float32 on the card alone
    ("card32/vox-card/pinned", "cpu32/vox-cpu/pinned"),
    ("card32/vox-card/pinned", "card64/vox-card"),
    ("cpu32/vox-cpu/pinned", "card64/vox-card"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--norms", default="bn,ln")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("detector_grad_audit: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from lvv_tpu_torch.models import voxelnext as V
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
    from lvv_tpu_torch.ops.sparse import from_voxels
    from lvv_tpu_torch.ops.voxelize import voxelize_mean

    report = {}
    for norm in args.norms.split(","):
        cfg = cs.detector_config(norm)
        batch = cs.detector_batch(cfg, (0,))
        pts = torch.as_tensor(batch["points"][0])
        n = int(batch["num_points"][0])
        # chip_smoke's weights: drawn on the card
        seed_det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                                     device="cuda", seed=0)
        start = {k: v.cpu().clone() for k, v in seed_det.state_dict().items()}
        grid = seed_det.voxel_grid()
        groups = cs.detector_groups(seed_det)
        skip = cs.cancelled_biases(seed_det)
        del seed_det

        vox = {}
        for src, dev in (("cpu", "cpu"), ("card", "cuda"), ("card2", "cuda")):
            v = voxelize_mean(pts.to(dev), n, grid,
                              max_voxels=cfg.voxelize.max_voxels)
            vox[src] = (v.coords.cpu(), v.features.cpu())
        a, b = vox["cpu"][1], vox["card"][1]
        vox_rep = dict(
            coords_equal=bool(torch.equal(vox["cpu"][0], vox["card"][0])),
            features_differing=int((a != b).sum()),
            features_max_abs=float((a - b).abs().max()),
            card_repeat_differing=int((vox["card2"][1] != b).sum()),
            entries=int(a.numel()))
        print(f"[{norm}] voxels card vs cpu: {vox_rep}", flush=True)
        runs = {}

        def run(dev, dtype, src, pin):
            """One step -> loss, {name: grad}, [[layer, pre-ReLU, valid,
            gradient at the ReLU's input]] in call order."""
            dtype = getattr(torch, dtype)
            det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                                    device=dev)
            if dtype == torch.float64:
                det = det.double()
            det.load_state_dict({k: t.to(dev) for k, t in start.items()})
            coords, feats = vox[src]
            st = from_voxels(coords.to(dev), feats.to(dev, dtype),
                             grid.grid_size)
            det.voxelize = lambda points, num_points: st
            by_id = {id(m): name for name, m in det.named_modules()
                     if isinstance(m, V.SparseConvLayer)}
            gates = None if pin is None else [
                (e[1] > 0) for e in runs[pin]["pre"]]
            seen, current = [], []
            relu = torch.relu

            def rec(x):
                if not current:
                    return relu(x)
                entry = [current[-1], x.detach().double().cpu(), None, None]
                i = len(seen)
                seen.append(entry)
                if x.requires_grad:
                    x.register_hook(lambda g, e=entry: e.__setitem__(
                        3, g.double().cpu()))
                if gates is None:
                    return relu(x)
                return x * gates[i].to(x.device, x.dtype)

            def pre(mod, _):
                current.append(by_id[id(mod)])

            def post(mod, _, out):
                current.pop()
                seen[-1][2] = out.valid.cpu()
            hooks = []
            for m in det.modules():
                if isinstance(m, V.SparseConvLayer):
                    hooks.append(m.register_forward_pre_hook(pre))
                    hooks.append(m.register_forward_hook(post))
            torch.relu = rec
            try:
                t0 = time.perf_counter()
                metrics, grads = cs.detector_step(torch, det, batch)
                secs = time.perf_counter() - t0
            finally:
                torch.relu = relu
                for h in hooks:
                    h.remove()
            del det
            return dict(loss=metrics[0]["loss"], grads=grads, pre=seen,
                        s=secs)

        for tag, spec in RUNS.items():
            runs[tag] = run(*spec)
            print(f"[{norm}] {tag}: loss {runs[tag]['loss']!r} "
                  f"({runs[tag]['s']:.1f} s)", flush=True)

        def compare(x, y):
            rx, ry = runs[x], runs[y]
            rel = cs.group_rel_l2(torch, groups, rx["grads"], ry["grads"],
                                  skip)
            layers = []
            for (lx, fx, vx, gx), (ly, fy, vy, gy) in zip(rx["pre"],
                                                          ry["pre"]):
                assert lx == ly
                if not torch.equal(vx, vy):
                    layers.append(dict(layer=lx, valid_sets_differ=True))
                    continue
                fx, fy = fx[vx], fy[vy]
                scale = float(fy.abs().max()) or 1.0
                flip = (fx > 0) != (fy > 0)
                d = dict(layer=lx, rows=int(vx.sum()),
                         max_rel=float((fx - fy).abs().max()) / scale,
                         gates_differ=int(flip.sum()),
                         flipped_max_abs_rel=float(
                             fy[flip].abs().max()) / scale if flip.any()
                         else 0.0,
                         grad_rel_l2=None, flip_share=None)
                if gx is not None and gy is not None:
                    gx, gy = gx[vx], gy[vy]
                    den = float(gy.norm()) or 1.0
                    d["grad_rel_l2"] = float((gx - gy).norm()) / den
                    d["flip_share"] = float(torch.maximum(
                        gx[flip].abs(), gy[flip].abs()).norm()) / den
                layers.append(d)
            return dict(loss_rel=abs(rx["loss"] - ry["loss"]) / abs(
                ry["loss"]), group_rel_l2=rel, layers=layers)

        pairs = {}
        for x, y in PAIRS:
            c = compare(x, y)
            pairs[f"{x} vs {y}"] = c
            print(f"[{norm}] {x} vs {y}: loss {c['loss_rel']:.2e}; groups "
                  + " ".join(f"{g} {v:.2e}" for g, v in
                             c["group_rel_l2"].items() if v is not None),
                  flush=True)
            for d in c["layers"]:
                if "rows" not in d:
                    print(f"[{norm}]   {d['layer']}: valid sets differ")
                    continue
                grad = ("-" if d["grad_rel_l2"] is None else
                        f"{d['grad_rel_l2']:.1e}, on the differing gates "
                        f"{d['flip_share']:.1e}")
                print(f"[{norm}]   {d['layer']}: rows {d['rows']} pre-ReLU "
                      f"max rel {d['max_rel']:.1e}; gates differ "
                      f"{d['gates_differ']} (|x| <= "
                      f"{d['flipped_max_abs_rel']:.1e} of max); gradient "
                      f"{grad}", flush=True)
        report[norm] = dict(voxels=vox_rep, pairs=pairs,
                            losses={k: r["loss"] for k, r in runs.items()},
                            seconds={k: r["s"] for k, r in runs.items()})
        del runs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
