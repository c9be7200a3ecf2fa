"""Fixture: environment mutation confined to runtime calls (clean)."""
import os


def expandable_segments():
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")


READ_ONLY = os.environ.get("CUDA_VISIBLE_DEVICES", "")   # reads are fine
