#!/usr/bin/env python3
"""Time variants of one hand-written kernel source on one GPU, in turns.

    python3 scripts/kernel_variants.py int8 [DEFINES ...]
    python3 scripts/kernel_variants.py block [DEFINES ...]

Each DEFINES argument is one variant: comma-separated -D definitions (for
example `NAME=1,OTHER=0`), with which devit_tpu_torch/kernels/csrc/
quant_matmul.cu (int8) or block_attention.cu (block) is compiled alone into
its own library under build/ (one nvcc process a variant, all started
together); with no argument, the source as it stands. Each variant's C entry
point is called through ctypes, as the wrappers call it:

- int8: fused_int8_matmul's two launches, bf16 in and out, at M 50688 (bs256
  x 198 tokens) at every distinct (K, N) of the deployed divisions' weight
  products (random weights), timed by CUDA events over 10 calls in turns
  (variants in order, then reversed) and summed over one int8 forward's 192
  calls; each output checked bit for bit against dynamic_int8_matmul; the
  profiler's device time of each launch summed over the forward; and the
  wrapper's host-and-device time a call at M 1.
- block: fused_block_attention at bf16 and f32, B 256, N 198, C 384, kh 1-6
  (random weights), timed in turns and summed over one forward's 48 layers
  at the deployed kh mix, and its chunked route at B 16, N 578, kh 6 in both
  dtypes; each within 2e-2 (bf16) or 1e-4 (f32) of
  reference_block_attention; the profiler's device time of each launch
  (block_attention.cu is linked with attention.cu, whose forward the chunked
  route launches).

Prints the card's name and power limit first. An empty DEFINES argument is
the source as it stands. A variant's -D names must be ones the source reads;
the kept sources read none, so a variant is tried by adding its #if to the
source first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from devit_tpu_torch.kernels import _build  # noqa: E402
from devit_tpu_torch.kernels.attention import reference_block_attention  # noqa: E402
from devit_tpu_torch.kernels.quant import (  # noqa: E402
    dynamic_int8_matmul, fused_int8_matmul, quantize_weight,
)

N = 198
# (K, N) of the deployed divisions' weight products -> calls a bs256 int8 forward
INT8_SHAPES = {(64, 384): 9, (128, 384): 4, (192, 384): 6, (256, 384): 12, (320, 384): 17,
               (384, 192): 9, (384, 384): 10, (384, 512): 6, (384, 576): 6, (384, 640): 4,
               (384, 768): 15, (384, 896): 5, (384, 960): 17, (384, 1024): 7, (384, 1152): 2,
               (384, 1280): 8, (384, 1408): 7, (384, 1536): 3, (512, 384): 6, (640, 384): 4,
               (768, 384): 3, (896, 384): 5, (1024, 384): 7, (1152, 384): 2, (1280, 384): 8,
               (1408, 384): 7, (1536, 384): 3}
KH_MIX = {1: 9, 2: 4, 3: 6, 4: 12, 5: 17}  # the deployed layers' kept heads


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, mark: str, reps: int = 3) -> dict:
    """Device time of one call, by kernel, for kernels whose name has `mark`."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"\w*" + mark + r"\w*", e.key).group(0) if mark else _short(e.key):
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and mark in e.key}


def _short(kernel: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameter list."""
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", kernel)


def _ptxas(log: str, mark: str) -> list:
    """ptxas's spill and register lines of the kernels whose name holds mark."""
    out, name = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[-1].strip(" '")
        elif ("Used" in line or "spill" in line) and mark in name:
            out.append(f"{name[-60:]}: {line.split(':', 1)[-1].strip()}")
    return out


def build(source: str, variants: list) -> list:
    """One library a variant: the C entry point named by `source`'s kernel."""
    src = _build.CSRC / source
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_build.BUILD_DIR / f"variant{i}-{src.stem}.so" for i in range(len(variants))]
    # the block half's chunked route launches the forward's kernels: linked in
    extra = [str(_build.CSRC / "attention.cu")] if source == "block_attention.cu" else []
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               *[f"-D{d}" for d in v], "-o", str(o), str(src), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, o in zip(variants, outs)]
    entry = {"quant_matmul.cu": "devit_quant_matmul",
             "block_attention.cu": "devit_block_attention"}[source]
    fns = []
    for v, p, o in zip(variants, procs, outs):
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {v}:\n{log}")
        print(v, _ptxas(log, "block_" if source == "block_attention.cu" else ""))
        fn = getattr(ctypes.CDLL(str(o)), entry)
        fn.argtypes, fn.restype = _build.SIGNATURES[entry]
        fns.append(fn)
    return fns


def int8(fns: list, variants: list) -> None:
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, x, q):
        M, K = x.shape
        Kp, Nn = q.w_nk.shape[1], q.w_q.shape[1]
        out = torch.empty((M, Nn), dtype=torch.bfloat16, device="cuda")
        scratch = torch.empty((M * (Kp + 4),), dtype=torch.int8, device="cuda")
        err = fn(x.data_ptr(), q.w_nk.data_ptr(), q.w_scale.data_ptr(), q.bias.data_ptr(),
                 scratch.data_ptr(), scratch.data_ptr() + M * Kp, out.data_ptr(), M, K, Kp, Nn,
                 1, 1, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    total = [[0.0, 0.0] for _ in fns]
    device = [{} for _ in fns]
    for (K, Nn), calls in INT8_SHAPES.items():
        q = quantize_weight(torch.randn((K, Nn), generator=gen, device="cuda"),
                            torch.randn((Nn,), generator=gen, device="cuda"))
        x = torch.randn((256 * N, K), generator=gen, device="cuda").bfloat16()
        want = dynamic_int8_matmul(x, q)
        times = {}
        for turn, order in enumerate((range(len(fns)), reversed(range(len(fns))))):
            for i in order:
                ms = _time_ms(lambda: call(fns[i], x, q))
                total[i][turn] += calls * ms
                times.setdefault(i, []).append(round(ms, 4))
        for i, fn in enumerate(fns):
            for k, ms in _device_ms(lambda: call(fn, x, q), "quant_").items():
                device[i][k] = device[i].get(k, 0.0) + calls * ms
        same = [torch.equal(call(fn, x, q), want) for fn in fns]
        print(f"K{K} N{Nn} x{calls}: ms by variant {times}, bit-equal {same}", flush=True)
    for v, t, d in zip(variants, total, device):
        print(f"per int8 forward {v}: {[round(a, 3) for a in t]} ms (turns); device "
              f"{ {k: round(ms, 3) for k, ms in d.items()} }")
    q = quantize_weight(torch.randn((384, 384), device="cuda"), torch.randn((384,), device="cuda"))
    x = torch.randn((1, 384), device="cuda").bfloat16()
    for _ in range(20):
        fused_int8_matmul(x, q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fused_int8_matmul(x, q)
    torch.cuda.synchronize()
    print(f"fused_int8_matmul host and device time a call at M 1: "
          f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us")


# block cases: (dtype, B, N, kh) at C 384, dh 64: the deployed layers' kh at
# B 256, N 198 (summed at KH_MIX), and the chunked route at B 16, N 578
BLOCK_CASES = ([(dt, 256, N, kh) for dt in (torch.bfloat16, torch.float32) for kh in range(1, 7)]
               + [(dt, 16, 578, 6) for dt in (torch.bfloat16, torch.float32)])


def block(fns: list, variants: list) -> None:
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, args, kh):
        t, ns, nb, qw, qb, pw, pb = args
        B, n, C = t.shape
        out = torch.empty_like(t)
        scratch = torch.empty((B, n, 4 * kh * 64), dtype=t.dtype, device="cuda")  # either route
        err = fn(t.data_ptr(), ns.data_ptr(), nb.data_ptr(), qw.data_ptr(), qb.data_ptr(),
                 pw.data_ptr(), pb.data_ptr(), scratch.data_ptr(), None, out.data_ptr(), B, n, C,
                 kh, 64, 1e-6, 0 if t.dtype == torch.float32 else 1, 0.125, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    total = {dt: [0.0 for _ in fns] for dt in (torch.bfloat16, torch.float32)}
    for dt, B, n, kh in BLOCK_CASES:
        C, K = 384, kh * 64
        r = lambda *s: torch.randn(s, generator=gen, device="cuda")
        args = (r(B, n, C).to(dt), 1 + 0.1 * r(C), 0.1 * r(C), (0.05 * r(C, 3 * K)).to(dt),
                0.1 * r(3 * K), (0.05 * r(K, C)).to(dt), 0.1 * r(C))
        want = reference_block_attention(*args, num_heads=kh).float()
        times = {}
        for order in (range(len(fns)), reversed(range(len(fns)))):
            for i in order:
                ms = _time_ms(lambda: call(fns[i], args, kh))
                times.setdefault(i, []).append(round(ms, 4))
                if n == N:
                    total[dt][i] += KH_MIX.get(kh, 0) * ms / 2
        rel = [float((call(fn, args, kh).float() - want).abs().max() / want.abs().max())
               for fn in fns]
        split = [{k: round(ms, 4) for k, ms in _device_ms(lambda: call(fn, args, kh), "").items()}
                 for fn in fns]
        if max(rel) > (1e-4 if dt == torch.float32 else 2e-2):
            raise SystemExit(f"{dt} N{n} kh {kh}: a variant is off the plain version: {rel}")
        print(f"{str(dt)[6:]} B{B} N{n} kh{kh}: ms by variant {times}, rel err "
              f"{[f'{e:.2e}' for e in rel]}, device {split}", flush=True)
    for dt, tot in total.items():
        for v, t in zip(variants, tot):
            print(f"{str(dt)[6:]} per forward's 48 layers (B 256) {v}: {t:.3f} ms")


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("int8", "block"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    variants = [[d for d in a.split(",") if d] for a in sys.argv[2:]] or [[]]
    source = {"int8": "quant_matmul.cu", "block": "block_attention.cu"}[sys.argv[1]]
    fns = build(source, variants)
    (int8 if sys.argv[1] == "int8" else block)(fns, variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
