"""The paged decode kernel of this tree against another tree's, bit for bit.

``csrc/paged_attention.cu`` shares its split route's row loads, online
softmax, warps' merge and partitions' merge with the dense decode
attention through
``csrc/flash_decode.cuh``, so a change there can move the paged kernel's
bits.  This builds the other tree's ``paged_attention.cu`` alone (with
the flags ``kernels/_build.py`` uses), runs both kernels through
``paged_attention_cuda`` on the same seeded inputs (80 cases: ten
(Hq, Hkv) groups, head dims 128, 80, 64 and 100, bf16 and fp32, so
both routes and every head chunk of the split route), and prints one
JSON line with the cases whose outputs are the same bits.  Exit 1 if
any differ.

Run from the root of a tree, on a machine with one card:

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/ref
    python3 benchmarks/paged_bits_ab.py build/ref/src/repro_torch/kernels/csrc
"""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

#: (Hq, Hkv): G = 1, 4, 5, 12 (two chunks of 6), 7, 8, 2, 3, 3, 1
GROUPS = ((32, 32), (32, 8), (40, 8), (48, 4), (56, 8), (64, 8), (16, 8),
          (24, 8), (12, 4), (8, 8))
HEAD_DIMS = (128, 80, 64, 100)


def other_kernel(csrc: str):
    """The other tree's ``paged_attention_launch``, built alone under
    ``build/paged_bits_ab``."""
    out = os.path.join(os.getcwd(), "build", "paged_bits_ab")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "paged_other.so")
    r = subprocess.run([_build.default_nvcc(), *_build.ARCH_FLAGS,
                        *_build.CFLAGS, "-shared",
                        os.path.join(csrc, "paged_attention.cu"), "-o", lib],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout[-2000:]}"
                           f"{r.stderr[-2000:]}")
    fn = ctypes.CDLL(lib).paged_attention_launch
    fn.argtypes = _build.SIGNATURES["paged_attention_launch"]
    fn.restype = ctypes.c_int
    return type("Other", (), {"paged_attention_launch": fn})


def run(lib, *args):
    """``paged_attention_cuda`` with ``lib`` as the built library."""
    load = _build.load
    _build.load = lambda: lib
    try:
        return pa.paged_attention_cuda(*args)
    finally:
        _build.load = load


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    mine, other = _build.load(), other_kernel(argv[0])
    g = torch.Generator(device="cuda").manual_seed(0)
    B, page, maxp = 8, 16, 40
    n_pages = B * maxp + 1
    lens = torch.tensor([0, 1, 17, 128, 129, 333, 640, 500],
                        dtype=torch.int32, device="cuda")
    same, differ = 0, []
    for Hq, Hkv in GROUPS:
        for D in HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                def randn(*shape):
                    return torch.randn(shape, generator=g,
                                       device="cuda").to(dtype)
                q = randn(B, Hq, D)
                kp, vp = randn(n_pages, page, Hkv, D), randn(n_pages, page,
                                                             Hkv, D)
                table = (torch.randperm(n_pages - 1, generator=g,
                                        device="cuda")[:B * maxp]
                         .reshape(B, maxp).int() + 1)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                a = run(mine, q, kp, vp, table, lens)
                b = run(other, q, kp, vp, table, lens)
                if torch.equal(a.view(bits), b.view(bits)):
                    same += 1
                else:
                    differ.append({
                        "Hq": Hq, "Hkv": Hkv, "D": D, "dtype": str(dtype),
                        "max_abs_diff": float((a.float() - b.float())
                                              .abs().max())})
    print(json.dumps({"cases": same + len(differ), "same_bits": same,
                      "differ": differ, "launches_of_both": pa.LAUNCHES,
                      "scalar_launches_of_both": pa.LAUNCHES_SCALAR}),
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
