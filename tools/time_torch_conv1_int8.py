"""Time B6, the int8 conv1 kernel (``i2vsgg_tpu_torch/csrc/conv1_int8.cu``),
by device time beside other builds of a source with the same C interface,
in turns on one card: for example the kernel of an earlier commit.

    git show REV:i2vsgg_tpu_torch/csrc/conv1_int8.cu > /some/dir/b6_rev.cu
    python3 tools/time_torch_conv1_int8.py /some/dir/b6_rev.cu [more.cu ...]

The inputs are those of ``chip_smoke.py`` phase 11b in kind: four 600x960
frames of integer pixels minus the pixel means, a seeded conv1 weight and
BN affine. Every build is first held bit-equal (``torch.equal``) to the
plain version; then each is timed with ``chip_smoke.kernel_ms`` (device
time, ``torch.profiler``) in the order committed, others, others reversed,
committed. Prints one JSON line: the card, the bound and the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from i2vsgg_tpu_torch.ops import conv1_int8 as c8  # noqa: E402
from i2vsgg_tpu_torch.utils import cuda_build  # noqa: E402


def build(source: Path) -> ctypes.CDLL:
    """``source`` built with the port's nvcc flags into the build directory."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / f"timed_{source.stem}.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def launcher(lib: ctypes.CDLL, x, params):
    """A call of ``lib``'s ``i2vsgg_conv1_int8_forward`` on ``x``, the
    parameters of ``conv1_int8_params``, into one output tensor."""
    fn = lib.i2vsgg_conv1_int8_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 2)
    w_q, s, b, shift, pad = params
    bsz, h, w, _ = x.shape
    out = torch.empty((bsz, (h - 1) // 2 + 1, (w - 1) // 2 + 1, 64),
                      dtype=torch.bfloat16, device=x.device)

    def run():
        err = fn(x.data_ptr(), w_q.data_ptr(), s.data_ptr(), b.data_ptr(),
                 bsz, h, w, *shift.tolist(), *pad.tolist(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_conv1_int8: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    means = torch.tensor(c8.DEFAULT_PIXEL_MEANS, device=dev)
    x = (torch.randint(0, 256, (4, 600, 960, 3), generator=g, device=dev)
         .float() - means).contiguous()
    weight = torch.randn(64, 3, 7, 7, generator=g, device=dev) * 0.1
    mul = torch.rand(64, generator=g, device=dev) + 0.5
    add = torch.randn(64, generator=g, device=dev)
    params = c8.conv1_int8_params(weight, mul, add)
    want = c8.conv1_bn_relu_int8_plain(x, *params)

    runs = {"committed": lambda: c8.conv1_int8_apply(x, *params)}
    for src in args.sources:
        runs[str(src)] = launcher(build(src), x, params)
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain")
    others = [n for n in runs if n != "committed"]
    order = ["committed", *others, *others[::-1], "committed"]
    times = {n: [] for n in runs}
    for n in order:
        times[n].append(chip_smoke.kernel_ms(runs[n], "conv1_int8", reps=30))
    nbytes, ops = chip_smoke.conv1_int8_work(x, want)
    bound, by = chip_smoke.bound_of(nbytes, ops,
                                    chip_smoke.H100_INT8_OPS_PER_S)
    print(json.dumps({"card": chip_smoke.smi_name_power()
                      or torch.cuda.get_device_name(0),
                      "shape": list(x.shape), "bound_ms": bound,
                      "bound_by": by, "device_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
