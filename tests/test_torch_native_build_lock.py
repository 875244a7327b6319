"""The root ``conftest.py``'s first-use build of the JAX package's native
library: two processes that call its hook at once both end with a library
that loads (the second waits on the Makefile's lock, then finds the
library up to date). Run on a copy of ``paddle_tpu/csrc`` without its
``.so`` (~30 s: one build), so the tree's library is not touched."""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_two_processes_build_the_native_library_once(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "paddle_tpu" / "csrc", csrc,
                    ignore=shutil.ignore_patterns("*.so", "*.o", ".buildflavor"))
    assert not (csrc / "libpaddle_tpu_native.so").exists()
    code = (
        "import ctypes, importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('root_conftest', {str(ROOT / 'conftest.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "ok = m.build_native(sys.argv[1])\n"
        "ctypes.CDLL(sys.argv[1] + '/libpaddle_tpu_native.so')\n"
        "print('BUILT' if ok else 'FAILED')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(csrc)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "BUILT", (out, err[-2000:])
    ctypes.CDLL(str(csrc / "libpaddle_tpu_native.so"))
