"""The port's analysis gate (``repro_torch.analysis``): the source lint's
rules aimed at the port's tree, the model-graph scan against the
reference's jaxpr scan on all ten architectures, and the CLI's fixtures."""

import json
import pathlib
import textwrap

import pytest

from repro import configs as ref_configs
from repro.analysis import jaxpr_scan as ref_scan
from repro.analysis import source_lint as ref_lint
from repro_torch import configs
from repro_torch.analysis import jaxpr_scan, source_lint
from repro_torch.eval.planner import _walk
from repro_torch.analysis.__main__ import main
from repro_torch.backends.plan import BackendPlan, SiteAssignment

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rules(found):
    return [f.rule for f in found]


def lint(src, rel="src/repro_torch/foo.py"):
    return source_lint.lint_source(textwrap.dedent(src), rel=rel)


# ---------------------------------------------------------------------------
# source lint
# ---------------------------------------------------------------------------

EXECUTE = "src/repro_torch/backends/foo.py"
PACKED = "src/repro_torch/kernels/packed_gemm.py"

# case -> (rule, rel, a source on which the rule fires once)
FIRES = {
    "registry-mutation-call": (
        "registry-mutation", "src/repro_torch/foo.py",
        """\
        from repro_torch.core.gemm_sims import register_design
        register_design(spec)
        """),
    "registry-mutation-store": (
        "registry-mutation", "src/repro_torch/foo.py",
        """\
        from repro_torch.core import gemm_sims
        gemm_sims._REGISTRY["x"] = spec
        """),
    "registry-restore": (
        "registry-mutation", "src/repro_torch/foo.py",
        """\
        from repro_torch.core import gemm_sims as gs
        gs.registry_restore(snapshot)
        """),
    "deprecated-shim": (
        "deprecated-shim", "src/repro_torch/foo.py",
        """\
        from repro_torch.core import gemm_sims
        out = gemm_sims.gemm("tubgemm", a, b)
        """),
    "deprecated-kernel-backends": (
        "deprecated-shim", "src/repro_torch/foo.py",
        """\
        from repro_torch.kernels.backends import register_kernel_backends
        register_kernel_backends()
        """),
    "global-rng-function": (
        "global-rng", EXECUTE,
        """\
        import torch
        def sample(shape):
            return torch.randn(shape)
        """),
    "global-rng-method": (
        "global-rng", "src/repro_torch/serving/foo.py",
        """\
        def fill(x):
            return x.uniform_(-1, 1)
        """),
    "float-accumulation-call": (
        "float-accumulation", "src/repro_torch/kernels/foo.py",
        """\
        import torch
        def tugemm_kernel(a, b):
            return torch.matmul(a.float(), b.float())
        """),
    "float-accumulation-method": (
        "float-accumulation", "src/repro_torch/kernels/foo.py",
        """\
        def quant_gemm_body(a, b):
            return a.float().mm(b.float())
        """),
    "float-accumulation-operator": (
        "float-accumulation", "src/repro_torch/core/foo.py",
        """\
        def bgemm_tile(a, b):
            return a.float() @ b.float()
        """),
    "packed-materialize": (
        "packed-materialize", PACKED,
        """\
        from repro_torch.core.quantization import dequantize
        def packed_path(q):
            return dequantize(q)
        """),
}


@pytest.mark.parametrize("case", sorted(FIRES))
def test_rule_fires_and_its_pragma_silences_it(case):
    rule, rel, src = FIRES[case]
    found = lint(src, rel)
    assert rules(found) == [rule]
    # the pragma on the flagged line
    lines = textwrap.dedent(src).splitlines()
    lines[int(found[0].where.rpartition(":")[2]) - 1] += (
        f"  # analysis: allow-{rule} (fixture)")
    assert lint("\n".join(lines) + "\n", rel) == []


def test_pragma_on_the_enclosing_def_line_silences():
    src = """\
    import torch
    def tubgemm_exact(a, b):  # analysis: allow-float-accumulation (int codes, fp32 chunks < 2^24)
        return torch.matmul(a.float(), b.float())
    """
    assert lint(src, "src/repro_torch/core/foo.py") == []


@pytest.mark.parametrize("src,rel", [
    # inside a scope
    ("""\
     from repro_torch.core.gemm_sims import register_design, scoped_registry
     with scoped_registry():
         register_design(spec)
     """, "src/repro_torch/foo.py"),
    # the registry's own module
    ("""\
     from repro_torch.core.gemm_sims import register_design
     register_design(spec)
     """, "src/repro_torch/core/gemm_sims.py"),
    # the reference's registry is not the port's
    ("""\
     from repro.core.gemm_sims import register_design
     register_design(spec)
     """, "src/repro_torch/foo.py"),
    # an explicit generator
    ("""\
     import torch
     def sample(shape, gen):
         return torch.randn(shape, generator=gen)
     """, EXECUTE),
    # a sampler off the execute path
    ("""\
     import torch
     def sample(shape):
         return torch.rand(shape)
     """, "src/repro_torch/eval/foo.py"),
    # int32 accumulation
    ("""\
     import torch
     def tub_gemm_tile(a, b):
         return torch._int_mm(a, b)
     """, "src/repro_torch/kernels/foo.py"),
    # a float matmul outside an exact-design function
    ("""\
     import torch
     def attention(q, k):
         return torch.matmul(q, k) @ k
     """, "src/repro_torch/kernels/foo.py"),
    # dequantize outside the packed kernel module
    ("""\
     from repro_torch.core.quantization import dequantize
     def f(q):
         return dequantize(q)
     """, "src/repro_torch/kernels/quant_gemm.py"),
], ids=["scoped", "defining-module", "reference-registry", "generator",
        "off-execute-path", "int-mm", "not-exact", "not-packed"])
def test_clean_sources(src, rel):
    assert lint(src, rel) == []


def test_syntax_error_is_a_finding():
    assert rules(lint("def broken(:")) == ["syntax-error"]


def test_rule_ids_are_the_references_with_global_rng_for_unjitted_rng():
    assert source_lint.RULES == tuple("global-rng" if r == "unjitted-rng" else r
                                      for r in ref_lint.RULES)


def test_tests_are_exempt(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "tests").mkdir(parents=True)
    bad = textwrap.dedent(FIRES["registry-mutation-call"][2])
    (pkg / "tests" / "test_x.py").write_text(bad)
    (pkg / "test_y.py").write_text(bad)
    assert source_lint.lint_repo(tmp_path) == []
    (pkg / "real.py").write_text(bad)
    (tmp_path / "chip_smoke.py").write_text(bad)
    assert sorted(f.where for f in source_lint.lint_repo(tmp_path)) == [
        "chip_smoke.py:2", "src/repro_torch/real.py:2"]


def test_repo_is_clean():
    found = source_lint.lint_repo(ROOT)
    assert found == [], "\n".join(f.render() for f in found)


# ---------------------------------------------------------------------------
# model-graph scan against the reference's jaxpr scan
# ---------------------------------------------------------------------------

def _cut(arch):
    """Published widths, depth 2; zamba2 keeps one shared-block
    application (its first group of 6 Mamba2 layers) and one tail layer."""
    layers = 7 if arch == "zamba2-1.2b" else 2
    return (configs.get_config(arch).replace(num_layers=layers),
            ref_configs.get_config(arch).replace(num_layers=layers))


def _key(f):
    return (f.pass_name, f.rule, f.severity, f.where, f.message)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_check_model_equals_reference(arch):
    cfg, ref_cfg = _cut(arch)
    found, stats = jaxpr_scan.check_model(cfg, arch=arch)
    ref_found, ref_stats = ref_scan.check_model(ref_cfg, arch=arch)
    assert sorted(map(_key, found)) == sorted(map(_key, ref_found))
    assert stats["sites"] == ref_stats["sites"]
    assert stats["points_checked"] == ref_stats["points_checked"]
    # every layer (and expert) dispatches its products: at least the
    # reference's once-per-scan-body count
    assert stats["dot_generals"] >= ref_stats["dot_generals"]


def test_weight_products_carry_the_references_paths_and_shapes():
    # rwkv6: LoRA products, the decay's, and (in the reference only) the
    # bonus u as a rank-0 dot_general, which the port computes elementwise
    # and cross_check skips as degenerate
    cfg, ref_cfg = _cut("rwkv6-3b")

    def weights(dots):
        return {(d.param_path, d.k, d.n_out) for d in dots
                if d.weight_like and (d.k, d.n_out) != (1, 1)}

    got = weights(jaxpr_scan.collect_dot_generals(cfg))
    assert got == weights(ref_scan.collect_dot_generals(ref_cfg))
    assert ("layers/tm/wa", 2560, 64) in got


def test_abstract_params_are_meta_and_shaped_like_the_reference():
    import jax

    cfg, ref_cfg = _cut("deepseek-v3-671b")
    leaves = dict(_walk(jaxpr_scan.abstract_params(cfg)))
    ref = ref_scan.abstract_params(ref_cfg)
    ref_leaves = {"/".join(str(p.key) for p in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(leaves) == sorted(ref_leaves)
    for path, leaf in leaves.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref_leaves[path].shape), path


def test_planner_sees_an_invisible_gemm_of_a_tied_head():
    cfg, _ = _cut("gemma-7b")
    found, _ = jaxpr_scan.check_model(cfg, arch="gemma-7b")
    assert [(f.rule, f.where) for f in found] == [
        ("planner-invisible-gemm", "gemma-7b/embed")]


def test_cross_check_flags_a_site_no_product_runs():
    from repro_torch.eval.planner import GemmSite

    site = GemmSite(name="layers/attn/wq", m=1, k=3, n_out=5, count=1, leaf=None)
    found = jaxpr_scan.cross_check([site], [], arch="x")
    assert rules(found) == ["site-not-in-jaxpr"]


# ---------------------------------------------------------------------------
# the CLI (the fixtures of tests/test_analysis_cli.py, aimed at the port)
# ---------------------------------------------------------------------------

def write_plan(tmp_path, entries, name="fixture.json"):
    p = tmp_path / name
    p.write_text(BackendPlan(sites=tuple(entries)).to_json())
    return p


@pytest.fixture
def bare_root(tmp_path):
    """A --root with no example plans and no lintable source."""
    (tmp_path / "examples" / "plans").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    return tmp_path


def test_cli_overflow_hazardous_plan_exits_nonzero(tmp_path, bare_root, capsys):
    plan = write_plan(tmp_path, [SiteAssignment("big", "ugemm", 8, k=2**20)])
    rc = main(["--skip-ranges", "--root", str(bare_root), "--plan", str(plan)])
    assert rc != 0
    out = capsys.readouterr().out
    assert "acc-overflow" in out and "error" in out


def test_cli_shadowed_pattern_plan_exits_nonzero(tmp_path, bare_root, capsys):
    plan = write_plan(tmp_path, [SiteAssignment("layers/*", "bgemm", 8),
                                 SiteAssignment("layers/*", "tubgemm", 4)])
    rc = main(["--skip-ranges", "--root", str(bare_root), "--plan", str(plan)])
    assert rc != 0
    assert "shadowed-pattern" in capsys.readouterr().out


def test_cli_registry_mutation_source_exits_nonzero(bare_root, capsys):
    (bare_root / "src" / "repro_torch" / "sneaky.py").write_text(
        textwrap.dedent(FIRES["registry-mutation-call"][2]))
    rc = main(["--skip-ranges", "--skip-plans", "--root", str(bare_root)])
    assert rc != 0
    assert "registry-mutation" in capsys.readouterr().out


def test_cli_clean_fixture_root_exits_zero(bare_root, capsys):
    rc = main(["--skip-ranges", "--root", str(bare_root)])
    assert rc == 0
    assert "analysis: OK" in capsys.readouterr().out


def test_cli_unknown_arch_rejected(bare_root):
    with pytest.raises(SystemExit):
        main(["--arch", "not-a-model", "--root", str(bare_root)])


def test_cli_plans_and_source_pass_on_clean_repo(capsys):
    rc = main(["--skip-ranges", "--root", str(ROOT)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "plan-lint" in out and "source-lint" in out


def test_cli_full_gate_on_musicgen_has_only_warnings(tmp_path, capsys):
    report = tmp_path / "findings.json"
    rc = main(["--arch", "musicgen-medium", "--root", str(ROOT),
               "--json", str(report)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ranges: musicgen-medium" in out
    assert "envelope points" in out
    doc = json.loads(report.read_text())
    assert doc["verdict"].startswith("analysis:")
    assert all(f["severity"] == "warning" for f in doc["findings"])
    stats = doc["ranges"]["musicgen-medium"]
    assert stats["sites"] == 7 and stats["points_checked"] == 252
    assert stats["seconds"] > 0


def test_cli_grid_flag_and_narration_match_the_reference(capsys):
    from repro.analysis.__main__ import main as ref_main

    args = ["--arch", "llama3-8b", "--grid", "2x2", "--skip-plans",
            "--skip-source"]
    assert main(args) == 0
    ours = capsys.readouterr().out.splitlines()
    assert ref_main(args) == 0
    theirs = capsys.readouterr().out.splitlines()
    # the same lines but the products count, which is the port's own
    strip = lambda s: s.split(" sites, ")[0] + s.split(" dot_generals, ")[-1]
    assert [strip(x) for x in ours] == [strip(x) for x in theirs]
