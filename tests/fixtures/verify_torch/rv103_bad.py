"""Fixture: import-time environment mutation (RV103 x3)."""
import os

os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

if os.environ.get("CI"):
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")


class Config:
    os.environ["TORCH_SHOW_CPP_STACKTRACES"] = "1"
