"""The port stands alone: nothing under ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the ``repro`` package, and every
module imports on a host without CUDA and without ``triton``."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "triton"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("name", list(_modules()))
def test_every_module_imports(name):
    importlib.import_module(name)


def test_package_imports_without_jax_cuda_or_triton():
    # a fresh interpreter in which jax, repro and triton cannot be imported
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib, torch\n"
        f"names = {list(_modules())!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not torch.cuda.is_initialized()\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIB is None\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_stochastic_slice_runs_without_jax():
    # the stochastic package and the unary encodings import and compute in
    # an interpreter where jax and the reference cannot be imported
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import repro_torch.stochastic as st\n"
        "from repro_torch.core import gemm_sims, unary\n"
        "a = torch.tensor([[3, -7, 0]], dtype=torch.int8)\n"
        "b = torch.tensor([[1], [2], [-7]], dtype=torch.int8)\n"
        "assert unary.decode_temporal(*unary.encode_temporal(a, 4)).tolist()"
        " == [[3, -7, 0]]\n"
        "print('ok', st.stochastic_gemm(a, b, 4, stream_len=16).tolist(),\n"
        "      gemm_sims.ugemm_exact(a, b, bits=4).tolist())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_csrc_holds_the_three_kernels():
    srcs = {p.name: p.read_text() for p in (PKG / "csrc").glob("*.cu")}
    # nine kernels: tub/tu GEMM (one int8 tensor-core template), fused
    # decode (split KV walk), flash forward, dQ and dK/dV, quant_gemm and
    # packed_gemm (one int8 tensor-core template in int_gemm.cuh, two weight
    # formats), block_stats
    assert set(srcs) == {"unary_gemm.cu", "fused_paged_decode.cu",
                         "flash_attention.cu", "quant_gemm.cu",
                         "packed_gemm.cu", "bitsparsity.cu"}
    header = (PKG / "csrc" / "int_gemm.cuh").read_text()
    assert "__dp4a" not in header and "int_gemm_kernel" not in header
    assert "__int2float_rn" in header
    assert "int_mma_kernel" in header and "mma_16832" in header
    for name, launcher in (("quant_gemm.cu", "quant_gemm_launch"),
                           ("packed_gemm.cu", "packed_gemm_launch"),
                           ("bitsparsity.cu", "block_stats_launch")):
        assert f'extern "C" int {launcher}' in srcs[name]
    # block_stats: byte-SIMD |q| (non-saturating) and zero tests, one
    # warp's shuffles a tile, the two sums as integer atomics
    stats = srcs["bitsparsity.cu"]
    for op in ("__vabs4(", "__vmaxu4(", "__vcmpeq4(", "atomicAdd(state"):
        assert op in stats
    assert "__syncthreads" not in stats and "__shared__" not in stats
    assert '#include "int_gemm.cuh"' in srcs["quant_gemm.cu"]
    assert '#include "int_gemm.cuh"' in srcs["packed_gemm.cu"]
    unary = srcs["unary_gemm.cu"]
    assert "__dp4a" not in unary and "n_slots" in unary and "mma_16832" in unary
    assert "struct TuPulses" in unary and "struct TubPulses" in unary
    assert 'extern "C" int unary_gemm_launch' in srcs["unary_gemm.cu"]
    decode = srcs["fused_paged_decode.cu"]
    assert 'extern "C" int fused_paged_decode_launch' in decode
    assert 'extern "C" int fused_paged_decode_resident_blocks' in decode
    assert "__global__ void __launch_bounds__(NT)\nfused_decode_split_kernel" in decode
    assert "atomicAdd(counters" in decode and "fused_paged_decode_kernel" not in decode
    flash = srcs["flash_attention.cu"]
    for launcher in ("flash_fwd_launch", "flash_bwd_dq_launch",
                     "flash_bwd_dkv_launch"):
        assert f'extern "C" int {launcher}' in flash
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel"):
        assert f"__global__ void __launch_bounds__(NT)\n{kernel}" in flash
    assert "__nv_bfloat16" in flash and "atomicAdd" not in flash
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == set(srcs)
    assert _build.HEADERS == ("int_gemm.cuh", "mma_bf16.cuh", "mma_int8.cuh")
    mma = (PKG / "csrc" / "mma_bf16.cuh").read_text()
    for ptx in ("cp.async.cg.shared.global", "ldmatrix.sync.aligned.m8n8.x4.trans",
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"):
        assert ptx in mma
    assert '#include "mma_bf16.cuh"' in flash
    for kernel in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                   "flash_bwd_dkv_mma_kernel"):
        assert f"__global__ void __launch_bounds__(MMA_NT * SPLIT)\n{kernel}" in flash
    # tuGEMM's and tubGEMM's slot loop and quant_gemm on the int8 tensor
    # cores, through the shared int8 header (which takes mma_bf16's cp.async)
    int8 = (PKG / "csrc" / "mma_int8.cuh").read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in int8
    assert '#include "mma_bf16.cuh"' in int8
    unary = srcs["unary_gemm.cu"]
    assert '#include "mma_int8.cuh"' in unary and '#include "mma_int8.cuh"' in header
    assert "__global__ void __launch_bounds__(MMA_NT)\nunary_mma_kernel" in unary
    assert "unary_gemm_kernel" not in unary
    assert "launch_rows<TuPulses>" in unary and "launch_rows<TubPulses>" in unary
    assert "__global__ void __launch_bounds__(MMA_NT)\nint_mma_kernel" in header
    # both weight formats on one template: the word store reaches it too
    assert "template <bool WORDS, int BITS, int WN, int WM, int WARPS_N, int WARPS_M>" in header
    assert "int_gemm::launch<true>" in srcs["packed_gemm.cu"]
    assert "int_mma_kernel" in srcs["packed_gemm.cu"]
    assert "int_gemm::launch<false>" in srcs["quant_gemm.cu"]
    assert 'extern "C" int packed_gemm_resident_blocks' in srcs["packed_gemm.cu"]
    for text in srcs.values():
        assert "__dp4a" not in text
    for text in [*srcs.values(), header, mma, int8]:
        assert "torch/extension.h" not in text and "cudaMalloc" not in text
        assert "cudaDeviceSynchronize" not in text


def test_chip_smoke_refuses_a_host_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", ["repro_torch.backends.plan",
                                  "repro_torch.eval.planner",
                                  "repro_torch.eval.sweetspot",
                                  "repro_torch.analysis.plan_lint"])
def test_plan_slice_modules_are_checked(name):
    # the parametrised checks above walk the package: the plan slice's
    # modules must be among what they check
    assert name in list(_modules())
    path = PKG.parent.joinpath(*name.split(".")).with_suffix(".py")
    assert path in FILES
