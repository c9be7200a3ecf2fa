#!/usr/bin/env python3
"""The flash kernel at query offset 0 against an earlier build of it, on
the card.

    PYTHONPATH=src python scripts/flash_offset_zero_check.py --baseline DIR

DIR is a checkout of an earlier tree whose ``flash_attention_forward``
takes no ``q_offset`` (its library is built from DIR's sources beside
this tree's).  For every case of ``chip_smoke.ATTN_GRID`` in float32
(the CUDA-core route) and bfloat16 (the tensor-core route where hd % 8 ==
0), the same q, k and v go through this tree's ``flash.flash_attention``
(offset 0) and through the baseline library's C entry; the outputs must
be equal bit for bit.  Prints one JSON line a case and a summary; exits
1 on any difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))


def baseline_library(root: Path):
    from repro_torch.kernels import _build
    source = (root / "src" / "repro_torch" / "kernels" / "attention"
              / "csrc" / "flash_attention.cu")
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, i32, ptr]
    lib.flash_attention_forward.restype = i32
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    from repro_torch.kernels.attention import flash
    if not torch.cuda.is_available():
        print("flash_offset_zero_check: CUDA is not available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = baseline_library(args.baseline.resolve())
    stream = torch.cuda.current_stream().cuda_stream
    cases = 0
    unequal = []
    for case in chip_smoke.ATTN_GRID:
        B, Tq, Tk, H, KV, hd, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = chip_smoke.attn_inputs(case, dtype, dev, seed=5)
            new = flash.flash_attention(q, k, v, causal=causal,
                                        sliding_window=window, q_offset=0)
            route = flash.route(dtype, hd)
            out = torch.empty_like(q)
            rc = old.flash_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                flash._DTYPES[dtype], B, Tq, Tk, H, KV, hd, int(causal),
                int(window or 0), hd ** -0.5, flash.ROUTES[route], stream)
            torch.cuda.synchronize()
            equal = rc == 0 and bool(torch.equal(new, out))
            cases += 1
            if not equal:
                unequal.append([list(case), str(dtype)])
            print(json.dumps({"case": list(case), "dtype": str(dtype),
                              "route": route, "rc": rc, "equal": equal}),
                  flush=True)
            del q, k, v, new, out
            torch.cuda.empty_cache()
    print(json.dumps({"cases": cases, "unequal": unequal,
                      "card": torch.cuda.get_device_name(0),
                      "baseline": os.fspath(args.baseline)}))
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
