"""The kernel library builds once when ranks start together
(devit_tpu_torch/kernels/_build.py's lock): two processes call build() at
once against a stand-in nvcc (a script that writes its -o file, slowly, and
logs each call); one compiles every source and links, the other waits and
finds the library; one library and no object or temporary file is left."""

import importlib.util
import os
import re
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

from devit_tpu_torch.kernels import _build

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    argv = sys.argv[1:]
    out = argv[argv.index("-o") + 1]
    with open({log!r}, "a") as f:
        f.write(("link" if "-shared" in argv else "compile") + "\\n")
    time.sleep(0.3)
    with open(out, "w") as f:
        f.write("stand-in")
""")

PROBE = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from devit_tpu_torch.kernels import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    seconds, _ = _build.build()
    print("built" if seconds > 0 else "found")
""")


def test_concurrent_builds_compile_once(tmp_path):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out_dir = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    root = Path(_build.__file__).resolve().parents[2]
    procs = [subprocess.Popen([sys.executable, "-c", PROBE, str(out_dir)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].strip().splitlines()[-1])
        finally:
            p.kill()
    assert sorted(outs) == ["built", "found"], outs
    calls = log.read_text().split()
    assert calls.count("compile") == len(_build.SOURCES) and calls.count("link") == 1
    left = sorted(p.name for p in out_dir.iterdir())
    libs = [n for n in left if n.endswith(".so")]
    assert len(libs) == 1 and libs[0] == _build._lib_path().name
    assert not [n for n in left if n.endswith((".o", ".tmp"))], left


# ---- every kernel is classified for chip_smoke.py's SASS check

# The __global__ kernels of csrc/ that run on the CUDA cores: the int8
# path's row quantisation, the GELU forward and backward, and the MoE
# dispatch and combine, which have no matrix product (per-row absmax, scale,
# round to int8 codes; an elementwise pass; row gathers and weighted sums);
# every product of every other kernel, the block half's in both dtypes
# included, runs on the tensor cores, so each other kernel must have an entry
# in chip_smoke.py's MMA_KERNELS. A new kernel is classified here or there by
# hand.
CUDA_CORE_KERNELS = {"quant_rows_kernel", "gelu_as_fwd", "gelu_as_bwd", "moe_gather_rows",
                     "moe_combine_rows"}


def test_every_bf16_mma_kernel_is_in_the_sass_check():
    """chip_smoke.py's [build] step requires an mma opcode (HMMA, or IMMA
    for int8) in each kernel of MMA_KERNELS. Every __global__ function of
    csrc/ is either there or in CUDA_CORE_KERNELS, not both, so that no
    tensor-core kernel can fall off the tensor cores unseen."""
    root = Path(_build.__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    patterns = [mark for mark, _ in smoke.MMA_KERNELS.values()]

    csrc = Path(_build.__file__).resolve().parent / "csrc"
    name = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    kernels = {k for f in csrc.glob("*.cu*") for k in name.findall(f.read_text())}
    assert {"attn_kernel_mma", "attn_bwd_kernel_mma", "attn_long_mma", "attn_bwd_long_rows_mma",
            "attn_bwd_long_keys_mma", "attn_long_tf32", "attn_bwd_long_rows_tf32",
            "attn_bwd_long_keys_tf32", "attn_wide_mma", "attn_bwd_wide_rows_mma",
            "attn_bwd_wide_keys_mma", "block_qkv_attn_kernel", "block_proj_kernel",
            "block_ln_qkv_mma", "block_gemm_tf32", "quant_mma_kernel"} <= kernels, sorted(kernels)
    in_check = {k for k in kernels if any(re.match(rf"{k}(?![a-z0-9_])", p) for p in patterns)}
    unclassified = sorted(kernels - in_check - CUDA_CORE_KERNELS)
    assert not unclassified, f"kernels in neither MMA_KERNELS nor CUDA_CORE_KERNELS: {unclassified}"
    assert not in_check & CUDA_CORE_KERNELS, sorted(in_check & CUDA_CORE_KERNELS)
    assert CUDA_CORE_KERNELS <= kernels, sorted(CUDA_CORE_KERNELS - kernels)
