"""The benchmark loads neither JAX nor the reference package ``repro``; the
plain reference loads nothing of the port; a run refuses to start without a
CUDA card or with an unknown cell."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import guard

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded({"repro_torch.serving", "jaxtyping",
                                   "reproducible"}) == []
    assert guard.forbidden_loaded({"repro.core.gemm_sims", "jax.numpy",
                                   "jaxlib", "flax.linen"}) == [
        "flax", "jax", "jaxlib", "repro"]


def test_what_a_run_imports_holds_no_jax_or_repro():
    code = (
        "import sys, json; sys.argv = ['bench/run.py']\n"
        "import runpy; g = runpy.run_path('bench/run.py', run_name='bench_entry')\n"
        "from bench import serve, check, devtrace, manifest, guard\n"
        "bench = manifest.load(g['ROOT'])\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "import repro_torch.serving.engine, repro_torch.serving.scheduler\n"
        "import repro_torch.models.common, repro_torch.backends\n"
        "import repro_torch.kernels.unary_gemm\n"
        "import repro_torch.kernels.paged_attention_fused\n"
        "print(json.dumps(guard.forbidden_loaded()))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_port():
    out = _python("import sys; sys.path.insert(0, '.')\n"
                  "import bench.reference, bench.check\n"
                  "print(sorted(m for m in sys.modules\n"
                  "             if m.partition('.')[0] in ('repro_torch', 'repro', 'jax')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("workload,code", [("phi3-mini-3.8b.docqa", 3),
                                           ("no-such.cell", 2)])
def test_run_refuses_without_a_card_or_a_known_cell(workload, code):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == code, out.stderr
    assert out.stdout == ""
