"""Command-line entry points of the port (`python -m
lvv_tpu_torch.tools.infer_vqa`, `.serve_vqa`, `.train_vqa`,
`.precompute_bev`, `.train_detector`)."""
