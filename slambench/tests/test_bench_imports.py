"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and without a CUDA card the benchmark refuses to run."""

import json
import subprocess
import sys

from slambench import cell as cells

ROOT = str(cells.ROOT)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_nothing_loaded_is_jax():
    code = (
        "import json, sys\n"
        "from slambench import run, readings, program, serve, checks, "
        "trace, scene, reference, roofline, stats, cell\n"
        "bench = cell.load_json(cell.BENCHMARK)\n"
        "for w in bench['workloads']:\n"
        "    cell.resolve(w['name'], bench)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_names_are_compared_whole():
    code = (
        "import sys, types, json\n"
        "from slambench import run\n"
        "for m in ('mvslam_tpu_torch.x', 'jaxtyping', 'flaxen', "
        "'mvslam_tpu.ops', 'jax.numpy'):\n"
        "    sys.modules[m] = types.ModuleType(m)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == ["jax.numpy", "mvslam_tpu.ops"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "tsukuba.track",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
