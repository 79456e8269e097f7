"""The kernel library builds once when ranks start together
(devit_tpu_torch/kernels/_build.py's lock): two processes call build() at
once against a stand-in nvcc (a script that writes its -o file, slowly, and
logs each call); one compiles every source and links, the other waits and
finds the library; one library and no object or temporary file is left."""

import os
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
