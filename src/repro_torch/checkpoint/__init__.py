from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    FORMAT_VERSION,
    all_steps,
    latest_step,
    read_manifest,
    restore,
    save,
)
