"""Command-line entry points of the port (`python -m
lvv_tpu_torch.tools.infer_vqa`, `python -m lvv_tpu_torch.tools.serve_vqa`)."""
